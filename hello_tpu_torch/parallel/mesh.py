"""The process group for data-parallel training, and region sharding for
genome-scale calling across hosts and workers.

Training runs one process per card, PyTorch's idiom and the launch of the
reference's own DDP trainer: ``torchrun --nproc_per_node N -m
hello_tpu_torch.train.cli --distributed`` starts N processes, and
``init_distributed`` joins them through torchrun's env:// contract
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``):
NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.  The trainer sums each step's
loss and gradients over the group; ``all_ranks_have`` is its per-batch
barrier, a host-side all-reduce on a gloo group that never waits on a card.

Inference needs no collectives: each host takes a deterministic share of
the genome's regions (``shard_regions``), its worker pool calls them in
chunks (``split_regions``), and the per-host VCFs are merged at the end.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

Region = Tuple[str, int, int]

#: torchrun's env:// contract, which ``init_distributed`` reads
ENV_CONTRACT = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK")

# the gloo group of the per-batch barrier (the default group itself when
# that is gloo); set by init_distributed, cleared by destroy_distributed
_host_group = None


def init_distributed(device=None, backend: Optional[str] = None
                     ) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this process's device.

    ``device`` defaults to ``cuda:LOCAL_RANK`` (``cpu`` trains on the CPU);
    ``backend`` defaults to ``nccl`` for a card and ``gloo`` for the CPU.
    Raises, before any rendezvous, when a variable of the contract is
    missing, when the card is not visible, or when NCCL is asked for off a
    card."""
    global _host_group
    missing = [k for k in ENV_CONTRACT if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment: {', '.join(missing)} "
            "not set (launch with torchrun --nproc_per_node N -m "
            "hello_tpu_torch.train.cli --distributed ...)")
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if not 0 <= rank_ < world:
        raise ValueError(f"RANK {rank_} is not in [0, WORLD_SIZE={world})")
    if device is None or str(device) == "cuda":
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device.index is None or device.index >= visible:
            raise RuntimeError(
                f"rank {rank_} wants {device} but {visible} card(s) are "
                "visible (one process per card: LOCAL_RANK < the visible "
                "cards)")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a card; the CPU uses gloo")
    timeout = datetime.timedelta(seconds=600)
    dist.init_process_group(backend, init_method="env://", rank=rank_,
                            world_size=world, timeout=timeout)
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))
    logger.info("torch.distributed: process %d/%d, backend %s, device %s",
                rank_, world, dist.get_backend(), device)
    return device


def destroy_distributed():
    """Leave the process group (a no-op outside one)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def all_ranks_have(flag: bool) -> bool:
    """True iff every process reports ``flag``: the per-batch barrier that
    keeps all ranks entering the step's all-reduce the same number of times
    (a rank that runs out of data stops everyone).  A MIN all-reduce of a
    host int on the gloo group, so it never waits on a card."""
    if not is_distributed():
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=_host_group)
    return int(t.item()) == 1


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
