"""The port's capacity soak (hello_tpu_torch/pipeline/soak.py) against
hello_tpu's (CPU).

  * its JAX-free half keeps hello_tpu's source: the streaming generator
    writes byte-equal ``ref.fa``, ``truth.vcf`` and ``illumina.bam``;
  * the ``/proc`` walk that stands in for ``psutil`` (the card machine has
    no ``psutil``) reads the process tree as ``psutil`` does;
  * the CLI keeps hello_tpu's flags, adds ``--device``, refuses the
    reference's reports as ``--out`` and, without ``--device``, raises on a
    machine without a card before it generates anything.

tests/test_torch_soak_parity.py runs both soaks end to end.
"""

import inspect
import os
import re
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from hello_tpu.pipeline import soak as jax_soak
from hello_tpu_torch.pipeline import soak

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FREE = ("_tree_rss_mb", "RssSampler", "generate_streaming",
            "measure_bai_latency")


@pytest.fixture(autouse=True)
def restore_precision():
    yield
    from hello_tpu_torch.nn import layers

    layers.set_precision("highest")


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Both packages' streaming generators on 40 kb: two chromosomes of 20 kb
    at 10x, seed 3."""
    out = {}
    for name, module in (("hello_tpu", jax_soak), ("port", soak)):
        d = str(tmp_path_factory.mktemp(name))
        out[name] = (d, module.generate_streaming(d, 40_000, 20_000, 10.0,
                                                  120, 3))
    return out


@pytest.mark.parametrize("name", JAX_FREE)
def test_jax_free_half_keeps_hello_tpus_source(name):
    assert inspect.getsource(getattr(soak, name)) == \
        inspect.getsource(getattr(jax_soak, name))


@pytest.mark.parametrize("fname", ["ref.fa", "truth.vcf", "illumina.bam"])
def test_generated_files_are_byte_equal(generated, fname):
    (dj, _), (dp, _) = generated["hello_tpu"], generated["port"]
    with open(os.path.join(dj, fname), "rb") as a, \
            open(os.path.join(dp, fname), "rb") as b:
        assert a.read() == b.read()


def test_generated_datasets_equal(generated):
    (dj, want), (dp, got) = generated["hello_tpu"], generated["port"]

    def norm(ds, d):
        return {k: (os.path.relpath(v, d) if k in ("fasta", "bam", "truth")
                    else v) for k, v in ds.items() if k != "generation_s"}

    assert norm(got, dp) == norm(want, dj)
    assert got["chromosomes"] == ["chrS1", "chrS2"]
    assert got["truth_variants"] > 0 and got["reads"] > 0


def test_bai_latency_returns_its_keys(generated):
    d, ds = generated["port"]
    got = soak.measure_bai_latency(ds["bam"], ds["lengths"], n=4,
                                   span=5_000)
    assert set(got) == {"n", "span", "p50_ms", "p95_ms"}
    assert got["n"] == 4 and got["span"] == 5_000
    assert 0 < got["p50_ms"] <= got["p95_ms"]


def test_proc_walk_reads_the_tree_as_psutil_does(monkeypatch):
    """With ``psutil`` hidden, ``_tree_rss_mb`` walks ``/proc``: it agrees
    with ``psutil``'s reading within 10% and counts a spawned child (which
    holds 200 MB)."""
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys, time; b = bytearray(200_000_000)"
         "; b[::4096] = b'x' * len(b[::4096]); print('up', flush=True); "
         "time.sleep(60)"], stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "up"
        time.sleep(0.2)
        with_psutil = soak._tree_rss_mb()
        monkeypatch.setitem(sys.modules, "psutil", None)
        with_proc = soak._tree_rss_mb()
        monkeypatch.undo()
        with open(f"/proc/{child.pid}/status") as fh:
            child_mb = int(re.search(r"VmRSS:\s+(\d+)", fh.read())
                           .group(1)) / 1e3
    finally:
        child.kill()
        child.wait()
    assert abs(with_proc - with_psutil) <= 0.1 * with_psutil
    assert child_mb > 190
    monkeypatch.setitem(sys.modules, "psutil", None)
    alone = soak._tree_rss_mb()
    assert with_proc - alone >= 0.9 * child_mb


def _flags(module):
    res = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(re.findall(r"(--[a-z_]+)", res.stdout))


def test_cli_keeps_hello_tpus_flags_and_adds_device():
    want = _flags("hello_tpu.pipeline.soak")
    assert {"--mb", "--chrom_mb", "--coverage", "--workers", "--dir",
            "--out", "--seed", "--keep", "--reuse", "--untrained",
            "--gate_checkpoint", "--train_mb", "--gen_only"} <= want
    assert _flags("hello_tpu_torch.pipeline.soak") == want | {"--device"}


@pytest.mark.parametrize("out", ["SOAK.md", "x/SOAK.json", "report.json"])
def test_reference_reports_are_refused(tmp_path, out):
    with pytest.raises(SystemExit) as exc:
        soak.main(["--out", str(tmp_path / out), "--dir",
                   str(tmp_path / "data"), "--device", "cpu"])
    assert exc.value.code == 2
    assert os.listdir(tmp_path) == []


def test_reuse_needs_a_dir(tmp_path):
    with pytest.raises(SystemExit) as exc:
        soak.main(["--reuse", "--out", str(tmp_path / "r.md"),
                   "--device", "cpu"])
    assert exc.value.code == 2
    assert os.listdir(tmp_path) == []


def test_default_dir_is_new_for_each_run(tmp_path, monkeypatch):
    """Two runs never share the default directory, and a run removes only
    a directory that it created."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    (a, made_a), (b, made_b) = soak._data_dir(None), soak._data_dir(None)
    assert made_a and made_b and a != b
    assert os.path.dirname(a) == str(tmp_path) and os.path.isdir(a)
    assert soak._data_dir(a) == (a, False)
    new = str(tmp_path / "new")
    assert soak._data_dir(new) == (new, True)


def test_no_card_raises_before_generating(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--dir", str(tmp_path / "data"), "--mb", "1",
                   "--out", str(tmp_path / "out" / "r.md")])
    assert os.listdir(tmp_path) == []
