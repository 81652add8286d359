"""The benchmark's data: the cells of ``BENCHMARK.json`` and the files each
names.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its loop (``loops/<loop>.py``),
the cell its limits (``limits/<cell>.json``), and each per-layer metric of
``BENCHMARK.json`` has a reader ``metrics/<metric>.py``, or, for a metric
split by loop (``mfu.score``, ``mfu.train``), one reader of its base name
``metrics/<base>.py`` for every split.  A later cell,
configuration, mix or metric is a new file and a new entry: nothing here
or in a loop needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def cell(name: str) -> dict:
    """{"cell": the workloads entry, "config", "traffic", "limits",
    "end_to_end": [the cell's end-to-end metrics], "per_layer": [its
    per-layer metrics]}."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in
                                  e2e_names else [])]
    return {"cell": entry,
            "config": _json(HERE, "configs", entry["config"] + ".json"),
            "traffic": _json(HERE, "traffic", entry["traffic"] + ".json"),
            "limits": _json(HERE, "limits", name + ".json"),
            "end_to_end": e2e, "per_layer": per_layer}


def loop(name: str):
    """The module ``h100_bench.loops.<name>``."""
    return importlib.import_module(f"h100_bench.loops.{name}")


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``, else of
    ``metrics/<base>.py`` for the metric ``<base>.<split>``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
