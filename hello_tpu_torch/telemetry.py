"""Stage timing, device traces and the host-device link probe.

The port of hello_tpu's telemetry.py: one registry of accumulated wall time
per pipeline stage; ``device_trace``, a torch.profiler trace of a block
(host activity and the card's kernels) written as Chrome / Perfetto JSON,
which ``trace_summary`` reads back as the card's busy share and its
kernels by time; and ``tunnel_health``, the host-device link's rates and
round trip (PCIe on the card).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import statistics
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall time for a named pipeline stage."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        with _lock:
            _totals[name] += elapsed
            _counts[name] += 1


def add(name: str, seconds: float, calls: int = 1):
    """Accumulate externally-measured time into a stage (e.g. timings that
    accrued in a worker/drainer thread's own dict)."""
    with _lock:
        _totals[name] += seconds
        _counts[name] += calls


def report() -> Dict[str, dict]:
    with _lock:
        return {name: {"seconds": round(_totals[name], 4),
                       "calls": _counts[name]}
                for name in sorted(_totals)}


def reset():
    with _lock:
        _totals.clear()
        _counts.clear()


def log_report(level=logging.INFO):
    for name, info in report().items():
        logger.log(level, "stage %-24s %8.3fs over %d calls",
                   name, info["seconds"], info["calls"])


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None):
    """Trace the block with torch.profiler: host activity, plus the card's
    kernels and copies when ``cuda`` (default: when a card is visible).
    Yields the trace file's path, ``<log_dir>/trace.<host>.<pid>.json``,
    written when the block ends (Chrome / Perfetto JSON; open it in
    ui.perfetto.dev)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{socket.gethostname()}.{os.getpid()}.json")
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()     # the block's kernels end inside
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def trace_summary(path: str) -> Dict[str, Any]:
    """Read a ``device_trace`` file: the traced span (the profiler's record
    window, or the first event to the last), the time the card ran at least
    one kernel (the union of the kernels' intervals), their ratio (the
    card's busy share), the copies' time, and the five kernels that take
    the most time as (name, ms, launches)."""
    with open(path) as fh:
        raw = json.load(fh)["traceEvents"]
    events = [e for e in raw if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path} holds no timed events")
    marks = {e.get("name"): e["ts"] for e in raw if e.get("ph") == "i"}
    start = marks.get("Iteration Start: PyTorch Profiler",
                      min(e["ts"] for e in events))
    span_us = marks.get("Record Window End",
                        max(e["ts"] + e["dur"] for e in events)) - start
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    busy_us, end = 0.0, float("-inf")
    by_name: Dict[str, list] = {}
    for e in kernels:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        entry = by_name.setdefault(e["name"], [0.0, 0])
        entry[0] += e["dur"]
        entry[1] += 1
    copy_us = sum(e["dur"] for e in events
                  if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"span_s": span_us / 1e6, "kernel_busy_s": busy_us / 1e6,
            "busy_share": busy_us / span_us if span_us else 0.0,
            "kernels": len(kernels), "copy_s": copy_us / 1e6,
            "top_kernels": [(name[:80], us / 1e3, n)
                            for name, (us, n) in ranked]}


def tunnel_health(size_mb: float = 8.0, seed: int = 0,
                  device=None) -> Dict[str, float]:
    """Probe of the host-device link, PCIe on the card: host->device and
    device->host MB/s of a ``size_mb`` copy through pinned host buffers, and
    the median round trip of an 8-byte copy there and back, each timed to
    its synchronisation after a warm-up copy each way.  ``device`` defaults
    to the current card; ``cpu`` measures host memory copies."""
    import numpy as np

    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to probe host "
                           "memory copies")

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    n = int(size_mb * 1e6)
    host = torch.from_numpy(
        np.random.RandomState(seed).randint(0, 256, size=n, dtype=np.uint8))
    back = torch.empty_like(host)
    if on_card:
        host, back = host.pin_memory(), back.pin_memory()
    remote = torch.empty(n, dtype=torch.uint8, device=dev)
    remote.copy_(host, non_blocking=True)
    back.copy_(remote, non_blocking=True)
    sync()
    rtts = []
    for i in range(3):                     # 8 B round trips: pure latency
        t0 = time.perf_counter()
        small = torch.full((8,), i, dtype=torch.uint8).to(dev)
        int(small.cpu()[0])
        rtts.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    remote.copy_(host, non_blocking=True)
    sync()
    up_s = time.perf_counter() - t0
    back.zero_()
    t0 = time.perf_counter()
    back.copy_(remote, non_blocking=True)
    sync()
    down_s = time.perf_counter() - t0
    if not torch.equal(back, host):
        raise AssertionError("the probe's copy came back changed")
    return {"probe_mb": size_mb, "up_mbps": size_mb / up_s,
            "down_mbps": size_mb / down_s,
            "rtt_ms": 1e3 * statistics.median(rtts)}
