"""Tests of the port's benchmark.  The CPU tests run the harness at tiny
sizes with the kernel's plain version; the tests marked ``card`` need an
NVIDIA GPU (they skip without one, deciding inside the ``card`` fixture)
and are run on the card with ``python -m pytest h100_bench/tests -m card``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """The card as a torch.device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's card-only checks")
    return torch.device("cuda", 0)


TINY_READS = {"illumina": [2, 4], "pacbio": [1, 3]}


def tiny_spec(cell: str) -> dict:
    """The cell's files with sizes a CPU test can hold."""
    from h100_bench import cells

    spec = cells.cell(cell)
    t = dict(spec["traffic"], reads_per_allele=TINY_READS, trace_wait=1,
             trace_active=2)
    if t["loop"] == "score":
        t.update(sites_per_batch=8, pool_batches=3)
    else:
        t.update(sites_per_batch=4, batch_alleles=8, pool_batches=5)
    spec["traffic"] = t
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
