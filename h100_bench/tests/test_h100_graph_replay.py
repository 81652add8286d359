"""The reader of ``graph_replay_pct.score`` on synthetic span records
planted through ``telemetry.record``: 0 with launches and no replays, 100
with a replay in every launch, the share between, a replay counted only
under a launch of the window (same key and thread), and None on the CPU,
with no launch in the window, or from a port that keeps no span
records."""

import itertools

import pytest
import torch

from h100_bench import cells
from hello_tpu_torch import telemetry

METRIC = "graph_replay_pct.score"
MS = 1_000_000
_windows = itertools.count(1)


def _ctx(lo_ns, hi_ns, device=torch.device("cuda", 0)):
    return {"loop": "score", "device": device,
            "host": {"wall_start": lo_ns / 1e9, "wall_end": hi_ns / 1e9}}


def _base():
    """A window of its own, far after every real record and every other
    test's windows (``test_h100_program_spans.py`` counts up from 10**15)."""
    return telemetry.now_ns() + 10**18 + next(_windows) * 10**15


def _batch(start, key, replay):
    """One batch's ``scorer.launch`` of 2 ms, with a ``scorer.replay`` of
    1 ms inside it when ``replay``."""
    telemetry.record("scorer.launch", start, 2 * MS, key=key,
                     parent="scorer.dispatch")
    if replay:
        telemetry.record("scorer.replay", start + MS // 2, MS, key=key,
                         parent="scorer.launch")


def _read(ctx):
    return cells.reader(METRIC)(ctx)


def test_the_metric_has_an_entry_in_both_score_cells():
    entry, = [m for m in cells.benchmark()["per_layer"]
              if m["name"] == METRIC]
    assert entry["source"] == "program_span"
    assert entry["moves"] == "score_sites_per_s"
    assert entry["workloads"] == ["hybrid.score.bf16", "illumina.score.bf16"]


@pytest.mark.parametrize("replays, want", [(0, 0.0), (1, 25.0), (4, 100.0)])
def test_reads_the_share_of_launches_that_replayed(replays, want):
    t = _base()
    for k in range(4):
        # 1 ms in: the window's ends pass through float seconds (0.5 us)
        _batch(t + (10 * k + 1) * MS, key=k, replay=k < replays)
    assert _read(_ctx(t, t + 100 * MS)) == pytest.approx(want)


def test_counts_only_launches_in_the_window_and_their_replays():
    t = _base()
    _batch(t - 50 * MS, key=1, replay=False)           # before: not counted
    _batch(t + 10 * MS, key=2, replay=True)
    _batch(t + 99 * MS, key=3, replay=True)            # replay past the end
    _batch(t + 300 * MS, key=4, replay=False)          # after: not counted
    # a replay whose launch is not in the window counts for nothing
    telemetry.record("scorer.replay", t + 50 * MS, MS, key=9,
                     parent="scorer.launch")
    assert _read(_ctx(t, t + 100 * MS)) == pytest.approx(100.0)


def test_none_on_the_cpu_and_with_no_launch():
    t = _base()
    _batch(t + 10 * MS, key=1, replay=True)
    assert _read(_ctx(t, t + 100 * MS, torch.device("cpu"))) is None
    assert _read(_ctx(t + 200 * MS, t + 300 * MS)) is None
    assert _read({"device": torch.device("cuda", 0), "host": None}) is None


def test_none_from_a_port_without_span_records(monkeypatch):
    t = _base()
    _batch(t + 10 * MS, key=1, replay=True)
    monkeypatch.delattr(telemetry, "spans")
    assert _read(_ctx(t, t + 100 * MS)) is None
