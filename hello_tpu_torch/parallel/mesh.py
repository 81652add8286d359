"""Region sharding for genome-scale calling across hosts and workers.

Inference needs no collectives: each host takes a deterministic share of
the genome's regions (``shard_regions``), its worker pool calls them in
chunks (``split_regions``), and the per-host VCFs are merged at the end.
The data-parallel training mesh waits for the port's DDP trainer.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

Region = Tuple[str, int, int]


def split_regions(regions: Sequence[Region], size: int) -> Iterator[Region]:
    """Cut each ``(chrom, start, stop)`` into consecutive pieces of at most
    ``size`` bases, in order.  Worker chunking and granular host sharding
    both cut here, so a piece boundary behaves like a chunk boundary."""
    if size < 1:
        raise ValueError(f"piece size must be >= 1, got {size}")
    for chrom, start, stop in regions:
        for lo in range(start, stop, size):
            yield chrom, lo, min(lo + size, stop)


def shard_regions(regions: Sequence[Region], process_index: int,
                  process_count: int, granularity: int = 0) -> List[Region]:
    """This host's share of ``regions``: every ``process_count``-th region of
    their sorted order, starting at ``process_index``.  Every host computes
    the same order, so the shares need no coordination.

    ``granularity > 0`` first cuts the regions into pieces of that many
    bases, so hosts get near-equal base counts even when chromosome sizes
    differ widely."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} is not in "
                         f"[0, {process_count})")
    if granularity > 0:
        regions = list(split_regions(regions, granularity))
    return sorted(regions)[process_index::process_count]
