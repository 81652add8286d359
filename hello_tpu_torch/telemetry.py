"""Stage timing: one registry of accumulated wall time per pipeline stage.

The port of hello_tpu's telemetry.py.  Its ``device_trace`` and
``tunnel_health`` wait for a later slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import defaultdict
from typing import Dict

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
