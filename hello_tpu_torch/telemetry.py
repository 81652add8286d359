"""Stage timing, span records, device traces and the host-device link probe.

The port of hello_tpu's telemetry.py: one registry of accumulated wall time
per pipeline stage; beside it, a bounded ring of span records (each
``stage`` call's name, start and end on the system clock, the enclosing
stage, a batch or step key and the thread; and numbers measured elsewhere,
such as the card's wait for the host, added by ``record``), read by
``spans`` and ``mean_ms`` over a window of that clock; ``device_trace``, a
torch.profiler trace of a block (host activity and the card's kernels)
written as Chrome / Perfetto JSON with the block's span records on a track
of their own (``hello_tpu_torch spans``) on the trace's clock, which
``trace_summary`` reads back as the card's busy share and its kernels by
time; and ``tunnel_health``, the host-device link's rates and round trip
(PCIe on the card).
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
from collections import Counter, defaultdict, deque
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import torch

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
#: the launch ledger (``count``)
_ledger: Counter = Counter()

#: span records the ring holds; the oldest go first
RING_LEN = 65_536
#: the system clock (the profiler trace's ``baseTimeNanoseconds + ts``) less
#: ``perf_counter_ns``, taken once: records are stamped on the monotonic clock
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


class Span(NamedTuple):
    """One span record: ns on the system clock, the enclosing stage's name
    on the same thread (None at the top; ``record``'s caller's), the caller's
    key (a batch's or step's number) and the thread's native id."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    key: Any
    thread: int


# the records as plain tuples in Span's order (``spans`` names them)
_ring: deque = deque(maxlen=RING_LEN)
# the latest start of a record the ring has dropped
_dropped_ns = -1
# per thread: the names of the open stages, and the thread's native id
_local = threading.local()


def now_ns() -> int:
    """The span records' clock: the system clock, in ns."""
    return time.perf_counter_ns() + _EPOCH_NS


def _thread():
    """This thread's open stages and its native id."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


def _append(record: tuple):
    """Append under ``_lock`` (held by the caller)."""
    global _dropped_ns
    if len(_ring) == RING_LEN:
        _dropped_ns = max(_dropped_ns, _ring[0][1])
    _ring.append(record)


class stage:
    """``with stage(name, key=None) as start:`` accumulates wall time for a
    named pipeline stage and adds a span record of the block to the ring;
    ``start`` is the block's start (``now_ns``).  A class, not a generator
    context manager: it runs on every batch and step, where a generator's
    set-up costs more than the record."""

    __slots__ = ("name", "key", "parent", "start")

    def __init__(self, name: str, key=None):
        self.name = name
        self.key = key

    def __enter__(self) -> int:
        stack, _ = _thread()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.perf_counter_ns()
        return self.start + _EPOCH_NS

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack, tid = _thread()
        stack.pop()
        with _lock:
            _totals[self.name] += (end - self.start) / 1e9
            _counts[self.name] += 1
            _append((self.name, self.start + _EPOCH_NS, end + _EPOCH_NS,
                     self.parent, self.key, tid))


def record(name: str, start_ns: int, dur_ns: int, key=None,
           parent: Optional[str] = None):
    """Add a span record measured elsewhere (such as between two CUDA
    events): ``start_ns`` on the ``now_ns`` clock, ``parent`` the span it
    lies in, if any."""
    tid = _thread()[1]
    with _lock:
        _append((name, start_ns, start_ns + dur_ns, parent, key, tid))


def timed_event(free: list) -> torch.cuda.Event:
    """A timed CUDA event from ``free`` (first events whose work has been
    waited for), else a new one: creating an event costs more host time
    than recording one."""
    try:
        return free.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def record_card_wait(name: str, wait: tuple):
    """Record, under ``name``, how long the card's stream sat idle between
    the end event of the work before and the first event of this work
    (both complete), stamped with the host's start of this work; then put
    the first event back in its free list.  ``wait`` is (that end event or
    None, the first event, the start in ns, key, the free list)."""
    before, started, t0, key, free = wait
    if before is not None:
        record(name, t0, int(before.elapsed_time(started) * 1e6), key)
    free.append(started)


def stamped_ns(stamps) -> Optional[int]:
    """The card's time between each pair of stamps of its clock
    (``ops.card_stamp``): ``stamps`` is [pairs, 2] of ns (start, end), a
    pair left 0 where nothing was stamped; the sum over the stamped pairs,
    or None when none was."""
    pairs = [(int(a), int(b)) for a, b in stamps.tolist() if a and b]
    return sum(b - a for a, b in pairs) if pairs else None


def record_stamps(name: str, stamps, start_ns: int, key=None):
    """Record, under ``name``, the card's time between ``stamps``' pairs
    (``stamped_ns``), stamped with the host's ``start_ns`` of the work they
    lie in and its ``key``; nothing when no pair was stamped."""
    dur = stamped_ns(stamps)
    if dur is not None:
        record(name, start_ns, dur, key)


def add(name: str, seconds: float, calls: int = 1):
    """Accumulate externally-measured time into a stage (e.g. timings that
    accrued in a worker/drainer thread's own dict)."""
    with _lock:
        _totals[name] += seconds
        _counts[name] += calls


def count(key: tuple, n: int = 1):
    """Add ``n`` to the launch ledger's ``key``, a tuple whose first item
    names the launcher:

    * ``("read_conv_reduce", route, width)``: a launch of the read
      convolver kernel (``ops.read_conv.read_conv_reduce`` on CUDA tensors;
      its plain version on the CPU counts nothing);
    * ``("card_stamp",)``: a launch of ``ops.card_stamp``;
    * ``("conv_bf16",)``: a launch of the eval bf16 conv kernel
      (``ops.conv_bf16``, every eval-mode conv layer on the card at
      ``bf16``);
    * ``("read_conv", net, route)``: an eval-mode reduction of read
      convolver ``net`` (``nn.moe``), on the CPU too; ``route`` is its
      fold's kernel route, or ``"layers"`` for the layer route;
    * ``("layer_rows", net)``: the read rows a layer-route reduction
      computed, padding rows included (packed rows, or the dense ``A*R``
      grid).

    These count what the Python code launches: eager forwards, and the
    forward a capture records into a CUDA graph (which that batch's first
    replay runs).  A later replay runs the graph's launches again without
    that code, so the Scorer adds what the ledger gained over the capture
    once more at each replay, each key under ``("replayed",) + key``
    (``count_replay``).  A reader takes the ledger's change over what it
    measures, ``counts() - before``; nothing resets it."""
    with _lock:
        _ledger[key] += n


def count_replay(captured: Mapping[tuple, int]):
    """Count a replay of a captured graph: ``captured``, what the ledger
    gained over its capture, again under the ``"replayed"`` prefix."""
    with _lock:
        for key, n in captured.items():
            _ledger[("replayed",) + key] += n


def counts() -> Counter:
    """A copy of the launch ledger (``count``)."""
    with _lock:
        return Counter(_ledger)


def report() -> Dict[str, dict]:
    with _lock:
        return {name: {"seconds": round(_totals[name], 4),
                       "calls": _counts[name]}
                for name in sorted(_totals)}


def reset():
    """Clear the stage totals (the span ring keeps its records)."""
    with _lock:
        _totals.clear()
        _counts.clear()


def log_report(level=logging.INFO):
    for name, info in report().items():
        logger.log(level, "stage %-24s %8.3fs over %d calls",
                   name, info["seconds"], info["calls"])


def spans(since_ns: int, until_ns: int) -> List[Span]:
    """The ring's records that start in [since_ns, until_ns]."""
    with _lock:
        return [Span(*r) for r in _ring if since_ns <= r[1] <= until_ns]


def mean_ms(name: str, since_ns: int, until_ns: int,
            exclusive: bool = False) -> Optional[float]:
    """Mean ms of the records named ``name`` that start in [since_ns,
    until_ns]; ``exclusive``: each less its child stages (same key and
    thread, inside it).  None when there are none, or when the ring has
    dropped records from the window."""
    with _lock:
        if _dropped_ns >= since_ns:
            return None
        ring = [Span(*r) for r in _ring]
    mine = [s for s in ring
            if s.name == name and since_ns <= s.start_ns <= until_ns]
    if not mine:
        return None
    total = sum(s.end_ns - s.start_ns for s in mine)
    if exclusive:
        children = defaultdict(list)
        for s in ring:
            if s.parent == name:
                children[s.key, s.thread].append(s)
        for p in mine:
            total -= sum(c.end_ns - c.start_ns
                         for c in children.get((p.key, p.thread), ())
                         if p.start_ns <= c.start_ns <= p.end_ns)
    return total / len(mine) / 1e6


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None):
    """Trace the block with torch.profiler: host activity, plus the card's
    kernels and copies when ``cuda`` (default: when a card is visible).
    Yields the trace file's path, ``<log_dir>/trace.<host>.<pid>.json``,
    written when the block ends (Chrome / Perfetto JSON; open it in
    ui.perfetto.dev), with the span records that started in the block on a
    track of their own, ``hello_tpu_torch spans``."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace.{socket.gethostname()}.{os.getpid()}.json")
    since = now_ns()
    with profile(activities=activities) as prof:
        yield path
        if cuda:
            torch.cuda.synchronize()     # the block's kernels end inside
    prof.export_chrome_trace(path)
    _add_spans(path, spans(since, now_ns()))
    logger.info("profiler trace written to %s", path)


def _add_spans(path: str, records: List[Span]):
    """Write span records into a Chrome trace as complete events of a
    process of their own, one thread per recording thread, on the trace's
    clock (``baseTimeNanoseconds`` + ts in us)."""
    with open(path) as fh:
        data = json.load(fh)
    events = data.setdefault("traceEvents", [])
    base = data.get("baseTimeNanoseconds", 0)
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": "hello_tpu_torch spans"}})
    for tid in sorted({r.thread for r in records}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"thread {tid}"}})
    for r in records:
        events.append({"ph": "X", "cat": "hello_tpu_torch", "name": r.name,
                       "pid": pid, "tid": r.thread,
                       "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"key": r.key, "parent": r.parent}})
    with open(path, "w") as fh:
        json.dump(data, fh, default=str)


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
