"""The calling worker's module imports no torch (CPU).

``HostWorkerPool`` spawns ``pipeline/host_worker._worker``: a fresh
interpreter that imports that module has no ``torch`` in ``sys.modules``, a
pool worker reports none after its start and maps no torch library after
a job, and a pool starts from a script read from stdin.  The host stages it
runs, ``host_sites_for_chunk`` (from ``host_worker`` and as
``parallel_call`` re-exports it), give hello_tpu's sites for one chunk.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hello_tpu.pipeline import parallel_call as jax_parallel
from hello_tpu_torch.pipeline import host_worker, parallel_call

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from hello_tpu_torch import sim

    out = tmp_path_factory.mktemp("host_worker")
    return sim.make_dataset(str(out), ref_length=20_000, num_variants=40,
                            coverage=20, read_length=120, seed=11)


def _torch_mapped(pid):
    with open(f"/proc/{pid}/maps") as fh:
        return any("libtorch" in line for line in fh)


def test_worker_module_imports_no_torch():
    code = ("import sys; import hello_tpu_torch.pipeline.host_worker; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    assert out.strip() == "False"


def test_pool_worker_holds_no_torch(dataset):
    """The parent holds torch; its worker reports none when ready and maps
    no torch library after a job, whose sites equal the in-process
    stages'."""
    assert "torch" in sys.modules
    region = (dataset.chromosome, 0, 20_000)
    with parallel_call.HostWorkerPool(1) as pool:
        pool.wait_ready(timeout=120)
        assert [r["torch"] for r in pool.ready] == [False]
        pid = pool.ready[0]["pid"]
        assert not _torch_mapped(pid)
        pool.new_run()
        pool.submit([dataset.bams["illumina"]], dataset.fasta, {}, region)
        (status, got_region, sites), = pool.results(1, timeout=120)
        assert status == "ok" and got_region == region
        assert not _torch_mapped(pid)
    want = host_worker.host_sites_for_chunk(
        [dataset.bams["illumina"]], dataset.fasta, *region, {})
    assert len(sites) == len(want) > 0
    for a, b in zip(sites, want):
        _assert_same_site(a, b)


def test_pool_starts_from_stdin():
    """spawn would run a script read from stdin again in each child; the
    pool's workers import nothing of ``__main__``."""
    script = ("import sys; sys.path.insert(0, %r)\n"
              "from hello_tpu_torch.pipeline.parallel_call import "
              "HostWorkerPool\n"
              "with HostWorkerPool(1) as pool:\n"
              "    pool.wait_ready(timeout=120)\n"
              "    print(pool.ready[0]['torch'])\n" % ROOT)
    out = subprocess.run([sys.executable, "-"], input=script, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=180).stdout
    assert out.strip().splitlines()[-1] == "False"


def _assert_same_site(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=f.name)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("where", ["host_worker", "parallel_call"])
def test_host_sites_for_chunk_matches_jax(dataset, where):
    fn = {"host_worker": host_worker.host_sites_for_chunk,
          "parallel_call": parallel_call.host_sites_for_chunk}[where]
    args = ([dataset.bams["illumina"]], dataset.fasta, dataset.chromosome,
            0, 20_000, {})
    got = fn(*args)
    want = jax_parallel.host_sites_for_chunk(*args)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        _assert_same_site(a, b)
