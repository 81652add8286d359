"""The port's worker-pool caller against hello_tpu's (CPU).

hello_tpu's ``call_parallel`` and the port's call the same simulated genome
with the same weights (a hello_tpu checkpoint), both at ``highest`` and both
on the coded wire with the packed-row convolution: records must agree in
chrom, pos, ref, alt and GT, with qual within 1e-3 (rtol and atol, as
tests/test_torch_call.py).  The port's ``call_parallel`` must also write
what its own ``call_genome`` writes, with a reused pool, with record spill
and after a chunk that fails once; the CLI's ``--num_workers`` at the
default precision (bf16) is held to hello_tpu's CLI at the same flags.

``call_parallel`` spawns worker processes, which need an importable
``__main__``, so each run is a script in a subprocess (as
tests/test_parallel_and_eval.py runs hello_tpu's).
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hello_tpu.io.vcf import read_vcf
from hello_tpu.parallel import mesh as jax_mesh
from hello_tpu.pipeline import parallel_call as jax_parallel
from hello_tpu.pipeline.precision_sweep import compare
from hello_tpu_torch.parallel import mesh
from hello_tpu_torch.pipeline import parallel_call

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_HEAD = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
"""

PORT_HEAD = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(1)
"""


def run_script(path, body, timeout=600):
    """Write ``body`` to ``path`` and run it; it must print RUN_OK."""
    path.write_text(body)
    res = subprocess.run([sys.executable, str(path)], capture_output=True,
                         text=True, timeout=timeout)
    assert "RUN_OK" in res.stdout, res.stderr[-3000:]


def key(r):
    return (r.chromosome, r.position, r.ref, tuple(r.alt), tuple(r.gt))


def assert_same_records(got, want, at_least=20):
    assert len(got) == len(want) >= at_least
    for a, b in zip(got, want):
        assert key(a) == key(b)
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# One Illumina genome: hello_tpu's call_parallel, then the port's runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def illumina_runs(tmp_path_factory):
    """Directory holding hello_tpu's ``jax.vcf`` and the port's VCFs of one
    30 kb genome at 30x (2 workers, 8 kb chunks)."""
    d = tmp_path_factory.mktemp("parallel")
    run_script(d / "jax_run.py", JAX_HEAD + f"""
from hello_tpu import sim
from hello_tpu.nn import layers
from hello_tpu.pipeline.call import load_scorer
from hello_tpu.pipeline.parallel_call import call_parallel
from hello_tpu.train.checkpoint import save_checkpoint

if __name__ == "__main__":
    d = {str(d)!r}
    ds = sim.make_dataset(d + "/data", ref_length=30000, num_variants=25,
                          coverage=30, read_length=120, seed=31)
    layers.set_precision("highest")
    os.environ["HELLO_TPU_PACKED_CONV"] = "1"
    scorer = load_scorer("illumina")
    assert scorer.packed_conv
    save_checkpoint(d + "/illumina.ckpt", scorer.params, scorer.state)
    call_parallel([ds.bams["illumina"]], ds.fasta, scorer, d + "/jax.vcf",
                  num_workers=2, chunk_size=8000)
    with open(d + "/dataset.txt", "w") as fh:
        fh.write(ds.bams["illumina"] + "\\n" + ds.fasta + "\\n")
    print("RUN_OK")
""")
    run_script(d / "port_run.py", PORT_HEAD + f"""
from hello_tpu_torch.nn import layers
from hello_tpu_torch.pipeline.call import Scorer, call_genome, load_scorer
from hello_tpu_torch.pipeline.parallel_call import HostWorkerPool, call_parallel

if __name__ == "__main__":
    d = {str(d)!r}
    bam, fasta = open(d + "/dataset.txt").read().split()
    layers.set_precision("highest")
    loaded = load_scorer("illumina", d + "/illumina.ckpt", device="cpu")
    scorer = Scorer(loaded.model, device="cpu", packed_conv=True)
    call_genome([bam], fasta, scorer, d + "/inline.vcf")
    call_parallel([bam], fasta, scorer, d + "/parallel.vcf", num_workers=2,
                  chunk_size=8000)
    call_parallel([bam], fasta, scorer, d + "/spilled.vcf", num_workers=2,
                  chunk_size=8000, spill_records=5)
    call_parallel([bam], fasta, scorer, d + "/retried.vcf", num_workers=2,
                  chunk_size=8000, fail_once_marker=d + "/fault.marker")
    with HostWorkerPool(2) as pool:
        pool.wait_ready()
        for name in ("pooled1.vcf", "pooled2.vcf"):
            call_parallel([bam], fasta, scorer, d + "/" + name, pool=pool,
                          chunk_size=8000)
    print("RUN_OK")
""")
    return d


def test_call_parallel_matches_jax_call_parallel(illumina_runs):
    assert_same_records(read_vcf(str(illumina_runs / "parallel.vcf")),
                        read_vcf(str(illumina_runs / "jax.vcf")))


def test_call_parallel_matches_call_genome(illumina_runs):
    assert_same_records(read_vcf(str(illumina_runs / "parallel.vcf")),
                        read_vcf(str(illumina_runs / "inline.vcf")))


def test_reused_pool_writes_the_same_calls(illumina_runs):
    want = (illumina_runs / "parallel.vcf").read_text()
    for name in ("pooled1.vcf", "pooled2.vcf"):
        assert (illumina_runs / name).read_text() == want


def test_spill_matches_in_memory(illumina_runs):
    """A tiny spill threshold (many spill shards and a streamed merge) writes
    a byte-identical VCF and removes its shards."""
    assert (illumina_runs / "spilled.vcf").read_text() == \
        (illumina_runs / "parallel.vcf").read_text()
    assert not glob.glob(str(illumina_runs / "*.tmp.vcf"))


def test_chunk_failing_once_is_retried(illumina_runs):
    assert (illumina_runs / "fault.marker").exists()  # the fault fired
    assert sorted(map(key, read_vcf(str(illumina_runs / "retried.vcf")))) == \
        sorted(map(key, read_vcf(str(illumina_runs / "parallel.vcf"))))


# ---------------------------------------------------------------------------
# Hybrid, two chromosomes
# ---------------------------------------------------------------------------

def test_call_parallel_hybrid_multichrom(tmp_path):
    """Illumina + PacBio over two chromosomes, sub-chromosome chunks: the
    worker pool writes what the port's in-process caller writes."""
    run_script(tmp_path / "run.py", PORT_HEAD + f"""
from hello_tpu_torch import sim
from hello_tpu_torch.io.fasta import FastaFile
from hello_tpu_torch.nn import layers
from hello_tpu_torch.pipeline.call import call_genome, load_scorer
from hello_tpu_torch.pipeline.parallel_call import call_parallel

if __name__ == "__main__":
    d = {str(tmp_path)!r}
    ds = sim.make_dataset(d, ref_length=40000, num_variants=60, coverage=28,
                          read_length=120, seed=91,
                          platforms=("illumina", "pacbio"),
                          pacbio_read_length=1200, num_chromosomes=2)
    ref = FastaFile(ds.fasta)
    regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]
    bams = [ds.bams["illumina"], ds.bams["pacbio"]]
    layers.set_precision("highest")
    scorer = load_scorer("hybrid", seed=3, device="cpu")
    call_genome(bams, ds.fasta, scorer, d + "/inline.vcf", regions=regions)
    call_parallel(bams, ds.fasta, scorer, d + "/parallel.vcf", num_workers=2,
                  chunk_size=9000, regions=regions)
    print("RUN_OK")
""", timeout=900)
    inline = read_vcf(str(tmp_path / "inline.vcf"))
    assert len({r.chromosome for r in inline}) == 2
    assert_same_records(read_vcf(str(tmp_path / "parallel.vcf")), inline,
                        at_least=40)


# ---------------------------------------------------------------------------
# The CLI: --num_workers at the default precision
# ---------------------------------------------------------------------------

def test_cli_num_workers_default_precision_matches_jax(tmp_path):
    """``--num_workers 2`` with no ``--precision`` (bf16 in both CLIs) and
    the same hello_tpu checkpoint.  bf16 records: no site flips, genotype
    flips at most 0.2% of the records (at least one allowed), |dQ| <= 0.05."""
    run_script(tmp_path / "jax_cli.py", JAX_HEAD + f"""
from hello_tpu import sim
from hello_tpu.pipeline import call
from hello_tpu.train.checkpoint import save_checkpoint

if __name__ == "__main__":
    d = {str(tmp_path)!r}
    ds = sim.make_dataset(d + "/data", ref_length=24000, num_variants=40,
                          coverage=30, read_length=120, seed=57)
    scorer = call.load_scorer("illumina")
    save_checkpoint(d + "/illumina.ckpt", scorer.params, scorer.state)
    call.main(["--bam", ds.bams["illumina"], "--ref", ds.fasta, "--out",
               d + "/jax.vcf", "--checkpoint", d + "/illumina.ckpt",
               "--num_workers", "2", "--chunk_size", "8000"])
    with open(d + "/dataset.txt", "w") as fh:
        fh.write(ds.bams["illumina"] + "\\n" + ds.fasta + "\\n")
    print("RUN_OK")
""")
    run_script(tmp_path / "port_cli.py", PORT_HEAD + f"""
from hello_tpu_torch.nn import layers
from hello_tpu_torch.pipeline import call

if __name__ == "__main__":
    d = {str(tmp_path)!r}
    bam, fasta = open(d + "/dataset.txt").read().split()
    call.main(["--bam", bam, "--ref", fasta, "--out", d + "/port.vcf",
               "--checkpoint", d + "/illumina.ckpt", "--device", "cpu",
               "--num_workers", "2", "--chunk_size", "8000"])
    assert layers.PRECISION == "bf16"
    print("RUN_OK")
""")
    want = read_vcf(str(tmp_path / "jax.vcf"))
    got = read_vcf(str(tmp_path / "port.vcf"))
    assert len(want) >= 20
    site_flips, gt_flips, dq = compare(want, got)
    assert site_flips == 0
    assert gt_flips <= max(1, 0.002 * len(want))
    assert dq.max() <= 0.05


# ---------------------------------------------------------------------------
# Region sharding and chunking
# ---------------------------------------------------------------------------

def _regions(rng):
    return [(f"chr{rng.randint(1, 6)}", int(s), int(s + rng.randint(1, 9e6)))
            for s in rng.randint(0, 5e7, rng.randint(1, 12))]


@pytest.mark.parametrize("seed", range(4))
def test_shard_and_split_regions_match_jax(seed):
    rng = np.random.RandomState(seed)
    regions = _regions(rng)
    for size in (1, 997, 4_000_000):
        assert list(mesh.split_regions(regions, size)) == \
            list(jax_mesh.split_regions(regions, size))
    for count in (1, 2, 3, 8):
        for granularity in (0, 4_000_000):
            shares = [mesh.shard_regions(regions, i, count, granularity)
                      for i in range(count)]
            assert shares == [jax_mesh.shard_regions(regions, i, count,
                                                     granularity)
                              for i in range(count)]
            # every piece goes to exactly one host
            pieces = (list(mesh.split_regions(regions, granularity))
                      if granularity else regions)
            assert sorted(r for s in shares for r in s) == sorted(pieces)


def test_make_chunks_matches_jax():
    regions = [("chr1", 0, 450_000), ("chr2", 100, 200), ("chr3", 5, 5)]
    assert list(parallel_call.make_chunks(regions, 200_000)) == \
        list(jax_parallel.make_chunks(regions, 200_000))


def test_shard_regions_refuses_a_bad_index():
    with pytest.raises(ValueError, match="process_index"):
        mesh.shard_regions([("chr1", 0, 10)], 2, 2)
    with pytest.raises(ValueError, match="size"):
        list(mesh.split_regions([("chr1", 0, 10)], 0))


def test_spawned_workers_cannot_see_the_card(monkeypatch):
    """Processes started inside ``_spawn_env`` inherit an empty
    CUDA_VISIBLE_DEVICES; the parent's value comes back afterwards."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with parallel_call._spawn_env():
        out = subprocess.run(
            [sys.executable, "-c",
             "import os; print(repr(os.environ['CUDA_VISIBLE_DEVICES']))"],
            capture_output=True, text=True, check=True).stdout
    assert out.strip() == "''"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"


def test_cli_hosts_share_the_genome(tmp_path):
    """``--process_index i --process_count 2``: each host calls its share
    of the chromosomes, and the two shares together are the one-host
    calls."""
    from hello_tpu_torch import sim
    from hello_tpu_torch.nn import layers
    from hello_tpu_torch.pipeline import call

    ds = sim.make_dataset(str(tmp_path), ref_length=12000, num_variants=24,
                          coverage=20, read_length=120, seed=17,
                          num_chromosomes=2)
    base = ["--bam", ds.bams["illumina"], "--ref", ds.fasta, "--device",
            "cpu", "--precision", "highest"]
    try:
        call.main(base + ["--out", str(tmp_path / "all.vcf")])
        for i in range(2):
            call.main(base + ["--out", str(tmp_path / f"host{i}.vcf"),
                              "--process_index", str(i),
                              "--process_count", "2"])
    finally:
        layers.set_precision("highest")
    whole = read_vcf(str(tmp_path / "all.vcf"))
    shares = [read_vcf(str(tmp_path / f"host{i}.vcf")) for i in range(2)]
    assert all(shares) and len({r.chromosome for r in whole}) == 2
    assert sorted(map(key, shares[0] + shares[1])) == sorted(map(key, whole))
    assert not {r.chromosome for r in shares[0]} & \
        {r.chromosome for r in shares[1]}
