"""The port's throughput benchmark, hello_tpu_torch/bench.py, against
``bench.py`` at the repo's root, on the CPU.

``build_workload`` draws ``bench.py``'s arrays from the same
``RandomState`` at C = 6 and 7; the training leg's coded-wire batch is
hello_tpu's byte for byte; ``main --device cpu`` at a tiny size prints one
line whose keys are exactly those of ``bench.py``'s line (read from its
source), every leg not skipped non-null and every skipped one null; the
training breakdown has ``bench.py``'s keys; the baseline restores the
thread count and the precision, and takes the reference's model when given
its directory, with no fallback; ``main`` raises without a card, and a leg
that raises makes ``main`` raise instead of printing null.  The forwards,
the first training step and the pipeline's sites are held to hello_tpu in
tests/test_torch_bench_legs.py.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hello_tpu.pipeline import compact as jax_compact
from hello_tpu_torch import bench
from hello_tpu_torch.nn import layers
from hello_tpu_torch.ops.bench_read_conv import FLOPS_PER_READ

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--sites", "4", "--reads0", "3", "--reads1", "2",
        "--iters", "1", "--baseline_sites", "2"]


def _root_bench():
    """``bench.py`` at the repo's root, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dict_keys(function, target=None):
    """The string keys of the dict literal in ``bench.py``'s ``function``:
    the one assigned to ``target``, else the one passed to ``json.dumps``."""
    with open(os.path.join(ROOT, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == function]
    for node in ast.walk(fn):
        if target is not None and isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == target:
            found = node.value
        elif target is None and isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "dumps":
            found = node.args[0]
        else:
            continue
        return {k.value for k in found.keys}
    raise AssertionError(f"no dict literal in {function}")


@pytest.fixture(autouse=True)
def no_sleep_highest(monkeypatch):
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    layers.set_precision("highest")
    yield
    layers.set_precision("highest")


@pytest.fixture
def small(monkeypatch):
    """A 10 kb genome for the pipeline leg and one-iteration training
    windows, so ``main`` runs every leg in seconds."""
    monkeypatch.setattr(bench, "PIPELINE_BP", 10_000)
    monkeypatch.setattr(bench, "PIPELINE_VARIANTS", 30)
    train = bench.bench_train
    monkeypatch.setattr(bench, "bench_train",
                        lambda *a, **kw: train(*a, iters=1, **kw))


def _assert_sites_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("C", [6, 7])
def test_build_workload_equals_bench_py(seed, C):
    got = bench.build_workload(np.random.RandomState(seed), 5, 3, 4, 2, C=C)
    want = _root_bench().build_workload(np.random.RandomState(seed), 5, 3, 4,
                                        2, C=C)
    _assert_sites_equal(got, want)


def test_train_wire_batch_equals_bench_py():
    sites = bench.build_workload(np.random.RandomState(2), 6, 2, 4, 3)
    bench.label_sites(sites)
    ref = _root_bench().build_workload(np.random.RandomState(2), 6, 2, 4, 3)
    for s in ref:                                   # bench.py:197-199
        s.labels = [i % 2 for i in range(len(s.alleles))]
        s.site_label = 0
    want = jax_compact.stack_wire_batches([jax_compact.training_wire_dict(
        jax_compact.pack_sites_wire(jax_compact.encode_chunk_sites(ref),
                                    hybrid=True))])
    got = bench.train_wire_batch(sites)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_main_prints_bench_py_line(small, capsys):
    bench.main(TINY + ["--pipeline_workers", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _dict_keys("main")
    assert all(v is not None for v in line.values()), line
    assert line["end_to_end_workers"] == 1
    assert line["value"] == max(line["device_dense_windows_per_s"],
                                line["device_wire_windows_per_s"])
    assert set(line["tunnel_before"]) == {"probe_mb", "up_mbps",
                                          "down_mbps", "rtt_ms"}


def test_skipped_legs_are_null(capsys):
    bench.main(TINY + ["--skip-train", "--skip-baseline", "--skip-pipeline"])
    line = json.loads(capsys.readouterr().out)
    skipped = {"vs_baseline", "end_to_end_windows_per_s",
               "end_to_end_workers", "device_illumina_windows_per_s",
               "end_to_end_pct_of_device", "tunnel_before", "tunnel_after",
               "train_windows_per_s", "train_sustained_windows_per_s",
               "train_bf16_windows_per_s",
               "train_bf16_sustained_windows_per_s", "baseline_windows_per_s"}
    assert {k for k, v in line.items() if v is None} == skipped


def test_run_counts_each_leg_and_keeps_its_outputs(small):
    result = bench.run(TINY + ["--pipeline_workers", "0", "--skip-train"])
    assert list(result["legs"]) == ["device_dense", "device_wire",
                                    "baseline", "pipeline",
                                    "device_illumina"]
    # the CPU runs the kernel's plain version: no launch anywhere
    assert all(sum(leg["launches_by_route"].values()) == 0
               for leg in result["legs"].values())
    assert all(leg["seconds"] > 0 for leg in result["legs"].values())
    dense = result["outputs"]["device_dense"]
    experts, meta = dense["output"]
    assert experts.shape[0] == dense["batches"][0]["allele_mask"].shape[0]
    assert meta is not None and np.isfinite(experts.numpy()).all()
    assert result["outputs"]["device_illumina"]["output"][1] is None
    assert result["breakdowns"] == {}
    assert result["outputs"]["pipeline"]["records"]
    assert layers.PRECISION == "bf16"          # --precision's default


def test_train_breakdown_has_bench_py_keys():
    sites = bench.build_workload(np.random.RandomState(0), 3, 2, 3, 2)
    rate, sustained, breakdown, losses = bench.bench_train(
        sites, iters=1, precision="highest", device="cpu")
    assert set(breakdown) == _dict_keys("bench_train", "breakdown")
    assert rate > 0 and sustained > 0
    # no card, no peak: the MFU is the card's only
    assert breakdown["train_mfu_lower_bound_pct"] is None
    reads = 3 * 2 * (3 + 2)
    assert breakdown["step_tflops_lower_bound"] == round(
        3 * reads * FLOPS_PER_READ / 1e12, 3)
    assert np.isfinite(losses["first_loss"]) and np.isfinite(
        losses["last_loss"])


def test_baseline_port_network_restores_threads(capsys):
    sites = bench.build_workload(np.random.RandomState(1), 2, 2, 3, 2)
    torch.set_num_threads(3)
    layers.set_precision("bf16")
    try:
        assert bench.bench_torch_baseline(sites, iters=1) > 0
        assert torch.get_num_threads() == 3
        assert layers.PRECISION == "bf16"
    finally:
        torch.set_num_threads(1)
    assert "the port's hybrid network" in capsys.readouterr().err


_FAKE_REFERENCE = '''
import torch

calls = []


class _Model(torch.nn.Module):
    def forward(self, reads, counts, nr, segs):
        calls.append((tuple(r.shape for r in reads), list(counts),
                      tuple(nr), tuple(segs.shape), reads[0].dtype))
        return reads[0].sum()


def create_moe_attention_model(config):
    assert config == {"hybrid": True}
    return _Model()
'''


def test_baseline_takes_the_reference_model(tmp_path, capsys):
    (tmp_path / "MixtureOfExpertsAdvanced.py").write_text(_FAKE_REFERENCE)
    (tmp_path / "moe_attention_config_full_hybrid_old_equivalent_weight_norm"
     ".py").write_text("configDict = {'hybrid': True}\n")
    sites = bench.build_workload(np.random.RandomState(1), 3, 2, 4, 2)
    path = list(sys.path)
    try:
        assert bench.bench_torch_baseline(
            sites, iters=2, reference_python=str(tmp_path)) > 0
        calls = sys.modules["MixtureOfExpertsAdvanced"].calls
    finally:
        for name in ("MixtureOfExpertsAdvanced",
                     "moe_attention_config_full_hybrid_old_equivalent_"
                     "weight_norm"):
            sys.modules.pop(name, None)
    assert sys.path == path
    # bench.py:329-338: [reads, C, L] float32 per platform, ragged counts
    assert len(calls) == 3 and calls[0] == (
        ((24, 6, 150), (12, 6, 150)), [2, 2, 2], ([4] * 6, [2] * 6),
        (3, 150, 5), torch.float32)
    assert "the reference's model" in capsys.readouterr().err


def test_baseline_without_the_reference_raises(tmp_path):
    sites = bench.build_workload(np.random.RandomState(1), 2, 2, 3, 2)
    with pytest.raises(ModuleNotFoundError):
        bench.bench_torch_baseline(sites, reference_python=str(tmp_path))
    assert torch.get_num_threads() == 1


def test_main_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--sites", "2"])
    assert capsys.readouterr().out == ""


def test_a_failing_leg_makes_main_raise(monkeypatch, capsys):
    def broken(*a, **kw):
        raise RuntimeError("baseline leg broke")

    monkeypatch.setattr(bench, "bench_torch_baseline", broken)
    with pytest.raises(RuntimeError, match="baseline leg broke"):
        bench.main(TINY + ["--skip-train", "--skip-pipeline"])
    assert capsys.readouterr().out == ""


def test_bench_imports_without_jax_or_hello_tpu():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['hello_tpu'] = None; import hello_tpu_torch.bench")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
