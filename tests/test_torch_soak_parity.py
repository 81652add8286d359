"""The port's soak against hello_tpu's, end to end on the CPU.

One 40 kb dataset (two chromosomes of 20 kb at 30x, the port's streaming
generator) and one gate checkpoint in hello_tpu's format (hello_tpu's seeded
``illumina`` init; both packages load it).  Each package's soak runs with
``--reuse --gate_checkpoint <ckpt> --workers 2`` from a directory of its own
whose ``soak_meta.json`` points at the shared files, both at ``highest``
(``HELLO_TPU_PRECISION``), the port with ``--device cpu``.  Their
``calls.vcf`` must agree in chrom, pos, ref, alt and GT with qual within
rtol / atol 1e-3 (tests/test_torch_call_parallel.py's bar), and their
scorable sites and accuracy against the planted truth must be equal.

The soaks start worker pools, which need an importable ``__main__``, so
each runs as a script in a subprocess; hello_tpu's on the CPU with the
tests' JAX cache (tests/test_torch_call_parallel.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from hello_tpu.io.vcf import read_vcf
from hello_tpu.nn import moe as jax_moe
from hello_tpu.train.checkpoint import save_checkpoint
from hello_tpu_torch.pipeline.soak import generate_streaming

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAUNCHER = """
import sys
sys.path.insert(0, {root!r})
{head}
from {package}.pipeline import soak

if __name__ == "__main__":
    soak.main(sys.argv[1:])
"""
JAX_HEAD = """import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")"""
PORT_HEAD = """import torch
torch.set_num_threads(1)"""


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """Each package's soak directory after its run."""
    base = tmp_path_factory.mktemp("soak")
    data = str(base / "data")
    ds = generate_streaming(data, 40_000, 20_000, 30.0, 120, 5)
    params, state = jax_moe.create_model("illumina").init(
        jax.random.PRNGKey(0))
    ckpt = str(base / "gate.ckpt")
    save_checkpoint(ckpt, params, state)
    env = dict(os.environ, HELLO_TPU_PRECISION="highest",
               JAX_PLATFORMS="cpu",
               HELLO_TPU_COMPILE_CACHE="/tmp/jax_test_cache")
    dirs = {}
    for package, head, extra in (
            ("hello_tpu", JAX_HEAD, []),
            ("hello_tpu_torch", PORT_HEAD, ["--device", "cpu"])):
        d = base / package
        d.mkdir()
        with open(d / "soak_meta.json", "w") as fh:
            json.dump(ds, fh)
        launcher = d / "launch.py"
        launcher.write_text(LAUNCHER.format(root=ROOT, head=head,
                                            package=package))
        res = subprocess.run(
            [sys.executable, str(launcher), "--reuse", "--dir", str(d),
             "--gate_checkpoint", ckpt, "--workers", "2",
             "--out", str(d / "report.md")] + extra,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        dirs[package] = d
    return dirs


def _report(d):
    with open(d / "report.json") as fh:
        return json.load(fh)


def test_soak_writes_hello_tpus_records(soaks):
    want = read_vcf(str(soaks["hello_tpu"] / "calls.vcf"))
    got = read_vcf(str(soaks["hello_tpu_torch"] / "calls.vcf"))
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        assert (a.chromosome, a.position, a.ref, tuple(a.alt), tuple(a.gt)) \
            == (b.chromosome, b.position, b.ref, tuple(b.alt), tuple(b.gt))
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)
    assert {r.chromosome for r in got} == {"chrS1", "chrS2"}


def test_soak_counts_and_accuracy_equal_hello_tpus(soaks):
    want, got = _report(soaks["hello_tpu"]), _report(soaks["hello_tpu_torch"])
    assert got["scorable_sites"] == want["scorable_sites"] > 0
    assert got["accuracy"] == want["accuracy"]
    assert got["card"] == "cpu" and got["precision"] == "highest"
    assert got["gate_checkpoint"] == want["gate_checkpoint"]
    for key in want:
        assert key in got, key
