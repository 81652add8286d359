"""What the harness refuses: the JAX package or JAX in its process, a
machine without a card, a checkout without the port."""

import os
import shutil
import subprocess
import sys
import types

import torch

from h100_bench import run
from h100_bench.tests.conftest import ROOT

SCRIPT = """
import sys, torch
sys.path.insert(0, {root!r})
from h100_bench import run
from h100_bench.tests.conftest import tiny_spec
cell = {cell!r}
run.run_cell(cell, 5, 0.2, 0, torch.device("cpu"), spec=tiny_spec(cell))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    for cell in ("illumina.score.bf16", "hybrid.train.highest"):
        out = subprocess.run(
            [sys.executable, "-c", SCRIPT.format(root=ROOT, cell=cell)],
            capture_output=True, text=True, cwd=ROOT, timeout=600,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr[-3000:]
        tops, bad = out.stdout.strip().splitlines()[-2:]
        assert bad == "[]"
        assert "'hello_tpu_torch'" in tops and "'hello_tpu'" not in tops


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hello_tpu_torch_x", types.ModuleType(
        "hello_tpu_torch_x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hello_tpu.nn",
                        types.ModuleType("hello_tpu.nn"))
    assert run.forbidden_modules() == ["hello_tpu.nn"]


def test_without_a_card_a_run_fails_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hybrid.score.bf16", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "does not fall back" in out.err


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100_bench"),
                    tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload",
         "hybrid.score.bf16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
