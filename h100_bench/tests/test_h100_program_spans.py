"""The nine readers of the port's own spans (``program_spans.py``), on a
synthetic context and records planted through ``telemetry.record``: each
returns the mean over the measured window, ignores records outside it, and
returns None with no records, on the CPU, or from a port that keeps no
span records."""

import itertools

import pytest
import torch

from h100_bench import cells
from hello_tpu_torch import telemetry

#: metric -> (loop, span read, its children where the reader takes its self
#: time)
READERS = {
    "upload_ms.score": ("score", "scorer.upload", ()),
    "launch_ms.score": ("score", "scorer.launch", ()),
    "dispatch_self_ms.score": ("score", "scorer.dispatch",
                               ("scorer.upload", "scorer.launch")),
    "card_wait_ms.score": ("score", "scorer.card_wait", ()),
    "forward_ms.train": ("train", "trainer.forward", ()),
    "backward_ms.train": ("train", "trainer.backward", ()),
    "update_ms.train": ("train", "trainer.update", ()),
    "step_self_ms.train": ("train", "trainer.step",
                           ("trainer.forward", "trainer.backward",
                            "trainer.update")),
    "card_wait_ms.train": ("train", "trainer.card_wait", ()),
}
MS = 1_000_000
_windows = itertools.count(1)


def _ctx(loop, lo_ns, hi_ns, device=torch.device("cuda", 0)):
    return {"loop": loop, "device": device,
            "host": {"wall_start": lo_ns / 1e9, "wall_end": hi_ns / 1e9}}


def _plant(name, children, start, ms, key):
    """A span of ``ms`` ms; where it has children, each takes 1 ms of it,
    so its self time is ``ms - len(children)``."""
    telemetry.record(name, start, ms * MS, key=key)
    for i, child in enumerate(children):
        telemetry.record(child, start + (1 + 2 * i) * MS // 2, MS, key=key,
                         parent=name)


def _base():
    """A window of its own, far after every real record: neither the ring's
    own records nor another test's fall in it."""
    return telemetry.now_ns() + next(_windows) * 10**15


def test_every_span_metric_has_a_reader_and_an_entry():
    names = {m["name"] for m in cells.benchmark()["per_layer"]
             if m["source"] == "program_span"}
    assert set(READERS) <= names


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_returns_the_windows_mean(metric):
    loop, name, children = READERS[metric]
    t = _base()
    _plant(name, children, t + 10 * MS, 6, key=1)
    _plant(name, children, t + 30 * MS, 10, key=2)
    got = cells.reader(metric)(_ctx(loop, t, t + 100 * MS))
    assert got == pytest.approx(8.0 - len(children))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_ignores_records_outside_the_window(metric):
    loop, name, children = READERS[metric]
    t = _base()
    _plant(name, children, t - 50 * MS, 40, key=1)      # before
    _plant(name, children, t + 10 * MS, 5, key=2)
    _plant(name, children, t + 200 * MS, 90, key=3)     # after
    got = cells.reader(metric)(_ctx(loop, t, t + 100 * MS))
    assert got == pytest.approx(5.0 - len(children))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_returns_none_without_records(metric, monkeypatch):
    loop, name, children = READERS[metric]
    t = _base()
    read = cells.reader(metric)
    assert read(_ctx(loop, t, t + 100 * MS)) is None
    _plant(name, children, t + 10 * MS, 5, key=1)
    # on the CPU, and from a port without the span ring, nothing is read
    assert read(_ctx(loop, t, t + 100 * MS, torch.device("cpu"))) is None
    monkeypatch.delattr(telemetry, "mean_ms")
    assert read(_ctx(loop, t, t + 100 * MS)) is None
