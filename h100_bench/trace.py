"""The traced run: the benchmark's host spans and one ``torch.profiler``
window, reduced to per-layer numbers.

``Spans`` records the benchmark's own spans around each call into a layer
(host clock), with their start and end on the system clock, so an idle gap
of the card in the profiler's trace can be put down to what the host was
doing.  ``summarize`` reads the profiler's Chrome trace: the card's busy
time is the arithmetic of ``trace_summary`` in
``hello_tpu_torch/telemetry.py`` (commit 9a24431), the union of the
kernels' intervals; the traced window runs from the first kernel's start
to the last one's end (``trace_summary`` takes the profiler's marks, which
add the time CUPTI takes to start and stop recording).
"""

from __future__ import annotations

import collections
import contextlib
import json
import time


class Spans:
    """Host spans by name: each one's duration in seconds and its start and
    end on the system clock (ns), the clock of the profiler's trace."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)
        self.marks = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        self.seconds[name].append(time.perf_counter() - t0)
        self.marks.append((w0, time.time_ns(), name))

    def clear(self):
        self.seconds.clear()
        self.marks.clear()

    def mean_ms(self, name: str):
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None


def _host_sample():
    return (time.perf_counter(), time.time(), time.thread_time(),
            time.process_time())


class HostProbe:
    """What the host gave the process over the measured window, read at
    its start and its end only: the calling thread's and the process's CPU
    seconds, and the window's start and end on the system clock, to line
    it up with a sampler of the card's clocks.  Printed on standard error;
    no metric reads it."""

    def __init__(self):
        self.start = _host_sample()

    def end(self) -> dict:
        a, b = self.start, _host_sample()
        return {"window_s": b[0] - a[0], "wall_start": a[1],
                "wall_end": b[1], "thread_cpu_s": b[2] - a[2],
                "process_cpu_s": b[3] - a[3]}


def _union(intervals):
    """Total length of the union of (lo, hi) intervals sorted by lo, and
    the gaps between them as (lo, hi)."""
    busy, end, gaps = 0.0, None, []
    for lo, hi in intervals:
        if end is not None and lo > end:
            gaps.append((end, lo))
        busy += max(0.0, hi - (lo if end is None else max(lo, end)))
        end = hi if end is None else max(end, hi)
    return busy, gaps


def summarize(path: str, spans=None,
              kernel_match: str = "read_conv_reduce") -> dict:
    """{"window_s": from the first kernel's start to the last one's end,
    "busy_s": the union of the kernels' intervals, "device_ops": [[name,
    s]] (the 10 kernels that took most time), "idle_gaps": [[host span, s]]
    (the 10 longest gaps between kernels, each named by the benchmark span
    the host was in when it began, from ``spans``' marks on the trace's
    clock, or "outside any span"), "kernels": [(ts_us, dur_us, grid)] of
    the kernels whose name holds ``kernel_match``}; {} when the trace holds
    no kernel."""
    with open(path) as fh:
        data = json.load(fh)
    base_ns = data.get("baseTimeNanoseconds")
    kernels = sorted((e for e in data["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e
                      and e.get("cat") == "kernel"), key=lambda e: e["ts"])
    if not kernels:
        return {}
    start = kernels[0]["ts"]
    stop = max(e["ts"] + e["dur"] for e in kernels)
    busy_us, gaps = _union([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"]] += e["dur"]
    marks = sorted(spans.marks) if spans is not None and base_ns else []

    def host_at(ts_us):
        now = base_ns + ts_us * 1e3
        inside = [name for lo, hi, name in marks if lo <= now <= hi]
        return inside[-1] if inside else "outside any span"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (stop - start) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[name[:120], us / 1e6]
                       for name, us in by_name.most_common(10)],
        "idle_gaps": [[host_at(lo), (hi - lo) / 1e6] for lo, hi in longest],
        "kernels": [(e["ts"], e["dur"], tuple((e.get("args") or {})
                                              .get("grid", ())))
                    for e in kernels if kernel_match in e["name"]],
    }


class Profiler:
    """One ``torch.profiler`` window of ``active`` steps after ``wait``
    untraced steps (call ``step()`` once per batch or training step),
    tracing the card's activity alone (kernels and copies: CUPTI adds about
    a microsecond to a launch, where tracing the host's operators would add
    tens).  Entering it first runs a throwaway session over one small copy,
    so that CUPTI's set-up (seconds on its first use in a process) falls
    before the measured window.  ``export()`` writes the Chrome trace to
    ``path`` once the window has closed."""

    def __init__(self, path: str, wait: int, active: int, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.path = path
        self.done = False
        self.acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]

        def ready(_):
            self.done = True

        self.prof = profile(activities=self.acts,
                            schedule=schedule(wait=wait, warmup=1,
                                              active=active, repeat=1),
                            on_trace_ready=ready)

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = ProfilerActivity.CUDA in self.acts
        with profile(activities=self.acts):
            torch.ones(1).to("cuda" if cuda else "cpu").sum()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def step(self):
        self.prof.step()

    def export(self):
        """The trace's path, or None when the window did not close."""
        if not self.done:
            return None
        self.prof.export_chrome_trace(self.path)
        return self.path
