"""Run one cell of the port's benchmark once.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Looks the cell up in ``BENCHMARK.json``, runs its traffic mix's loop
(``loops/<loop>.py``) on the configuration of its cell, and prints one JSON
line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read by ``metrics/<metric>.py`` from
the benchmark's spans and one profiler window), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared to
decide ``correct``, beside its limit (also the last lines of standard
error).

It measures the card and nothing else: without a CUDA device, or with
fewer than the cell asks for, it exits with status 2 and prints no result.
It exits with status 3 and prints no result when ``jax``, ``jaxlib``,
``flax`` or ``hello_tpu`` (the JAX package, not the port
``hello_tpu_torch``) is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

#: top-level module names that must not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "hello_tpu")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _parser():
    p = argparse.ArgumentParser(prog="python -m h100_bench.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def run_cell(workload, seed, seconds, trace, device, spec=None):
    """One run of a cell on ``device`` (a torch.device): the result line as
    a dict (without the JAX check, which ``main`` makes).  ``spec``
    replaces the cell's files (the CPU tests' tiny sizes)."""
    import torch

    from . import cells, check, peaks
    from .trace import Spans, summarize

    spec = cells.cell(workload) if spec is None else spec
    loop = cells.loop(spec["traffic"]["loop"])
    spans = Spans()
    scratch = tempfile.mkdtemp(prefix="h100_bench.")
    try:
        out = loop.run(spec, seed, seconds, bool(trace), device, spans,
                       scratch)
        ctx = dict(out["ctx"], cell=workload, device=device)
        ctx["trace"] = (summarize(ctx["trace_path"], spans)
                        if ctx.get("trace_path") else {})
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx["trace"]:
            dev.update(busy_s=ctx["trace"]["busy_s"],
                       window_s=ctx["trace"]["window_s"])
    else:
        measured = dict(out["metrics"],
                        setup_s=(out["t_start"] - T0, "s"))
        for m in spec["end_to_end"]:
            value, unit = measured[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    checks = check.judge(out["readings"], spec["limits"])
    line = {"correct": check.passed(checks) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace and ctx["trace"]:
        line["breakdown"] = {k: ctx["trace"][k]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = checks
    if ctx.get("host"):
        sys.stderr.write(f"host: {json.dumps(ctx['host'])}\n")
    if on_card:
        sys.stderr.write(f"card: {peaks.power_limit()}\n")
    return line


def main(argv=None):
    args = _parser().parse_args(argv)
    import torch

    from . import cells, check

    chips = cells.cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(
            f"no result: the cell needs {chips} CUDA device(s), this machine "
            f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; the benchmark measures the card and does not fall back\n")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, args.trace,
                    torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        sys.stderr.write(f"no result: loaded in this process: {bad}\n")
        return 3
    check.report(line["checks"])
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
