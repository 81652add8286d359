"""The port's device trace and link probe (CPU).

hello_tpu's ``telemetry.device_trace`` captures a profiler trace and both
of its CLIs take ``--profile_dir``; ``tunnel_health`` measures the
host-device link.  On the CPU the port's trace holds host activity only and
the probe measures host memory copies:

  * ``device_trace`` writes a Chrome / Perfetto trace that ``trace_summary``
    reads back (no kernels on the CPU, so a busy share of 0);
  * ``--profile_dir`` on the calling CLI (a simulated 8 kb genome) and on
    the training CLI (a few dumped sites) writes a trace beside their
    outputs;
  * ``tunnel_health`` returns hello_tpu's four keys;
  * the span ring: a ``stage`` record lies on the trace's clock
    (``baseTimeNanoseconds + ts``) to within 1 ms, nested stages record
    their parent and key, the ring keeps its fixed length and ``mean_ms``
    reads nothing once records of its window were dropped, ``mean_ms``
    counts only its window (and a span less its children with
    ``exclusive``), and ``device_trace`` writes the block's spans on a
    track of their own.
"""

import glob
import json
import os
import sys
import time
from collections import deque

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_two_process import _make_shards  # noqa: E402

from hello_tpu_torch import telemetry  # noqa: E402
from hello_tpu_torch.nn import layers  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def highest():
    yield
    layers.set_precision("highest")


def _one_trace(directory):
    paths = glob.glob(os.path.join(directory, "trace.*.json"))
    assert len(paths) == 1, os.listdir(directory)
    with open(paths[0]) as fh:
        assert json.load(fh)["traceEvents"]
    return paths[0]


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with telemetry.device_trace(str(tmp_path / "trace"), cuda=False) as path:
        x = torch.randn(64, 64)
        (x @ x).relu().sum()
    assert path == _one_trace(str(tmp_path / "trace"))
    summary = telemetry.trace_summary(path)
    assert summary["span_s"] > 0
    assert summary["kernels"] == 0 and summary["busy_share"] == 0.0
    assert summary["top_kernels"] == []


def test_call_cli_profile_dir_writes_a_trace(tmp_path):
    from hello_tpu_torch import sim
    from hello_tpu_torch.io.vcf import read_vcf
    from hello_tpu_torch.pipeline.call import main

    ds = sim.make_dataset(str(tmp_path / "sim"), ref_length=8_000,
                          num_variants=16, coverage=20, read_length=120,
                          seed=3)
    out = str(tmp_path / "calls.vcf")
    main(["--bam", ds.bams["illumina"], "--ref", ds.fasta, "--out", out,
          "--device", "cpu", "--precision", "highest",
          "--profile_dir", str(tmp_path / "prof")])
    assert read_vcf(out)
    summary = telemetry.trace_summary(_one_trace(str(tmp_path / "prof")))
    assert summary["span_s"] > 0


def test_train_cli_profile_dir_writes_a_trace(tmp_path):
    from hello_tpu_torch.train.cli import main

    files = _make_shards(tmp_path, n_files=2, sites_per_file=4)
    prefix = str(tmp_path / "run")
    main(["--data", os.path.join(os.path.dirname(files[0]), "*.index"),
          "--model", "illumina", "--out_prefix", prefix, "--num_epochs", "1",
          "--batch_alleles", "8", "--read_bucket", "16", "--device", "cpu",
          "--profile_dir", str(tmp_path / "prof")])
    assert os.path.exists(prefix + ".final.ckpt")
    _one_trace(str(tmp_path / "prof"))


def test_tunnel_health_on_the_cpu():
    probe = telemetry.tunnel_health(size_mb=1.0, device="cpu")
    assert sorted(probe) == ["down_mbps", "probe_mb", "rtt_ms", "up_mbps"]
    assert probe["probe_mb"] == 1.0
    assert all(np.isfinite(v) and v > 0 for v in probe.values())


def test_tunnel_health_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry.tunnel_health()


def _trace_events(path):
    with open(path) as fh:
        data = json.load(fh)
    return data.get("baseTimeNanoseconds", 0), data["traceEvents"]


def test_stage_records_lie_on_the_trace_clock(tmp_path):
    with torch.profiler.record_function("warm"):   # the first call's cost
        pass
    with telemetry.device_trace(str(tmp_path), cuda=False) as path:
        with telemetry.stage("test.align") as t0:
            with torch.profiler.record_function("test.align.inner"):
                time.sleep(0.02)
    rec = [s for s in telemetry.spans(t0, t0) if s.name == "test.align"]
    assert len(rec) == 1 and rec[0].start_ns == t0
    base, events = _trace_events(path)
    inner = [e for e in events if e.get("name") == "test.align.inner"]
    assert len(inner) == 1
    lo = base + inner[0]["ts"] * 1e3
    hi = lo + inner[0]["dur"] * 1e3
    # the profiler's range opens inside the stage and closes inside it
    assert rec[0].start_ns - 1e6 <= lo and hi <= rec[0].end_ns + 1e6
    assert abs(lo - rec[0].start_ns) < 1e6


def test_nested_stages_record_parent_and_key():
    since = telemetry.now_ns()
    with telemetry.stage("test.outer", key=7):
        with telemetry.stage("test.inner", key=7):
            pass
        with telemetry.stage("test.inner", key=8):
            with telemetry.stage("test.innermost"):
                pass
    got = {(s.name, s.key): s for s in telemetry.spans(since,
                                                       telemetry.now_ns())}
    assert got["test.outer", 7].parent is None
    assert got["test.inner", 7].parent == "test.outer"
    assert got["test.inner", 8].parent == "test.outer"
    assert got["test.innermost", None].parent == "test.inner"
    outer = got["test.outer", 7]
    for s in got.values():
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
        assert s.thread == outer.thread
    assert telemetry.report()["test.inner"]["calls"] >= 2


def test_ring_keeps_its_length_and_mean_ms_refuses_a_dropped_window(
        monkeypatch):
    monkeypatch.setattr(telemetry, "_ring", deque(maxlen=telemetry.RING_LEN))
    monkeypatch.setattr(telemetry, "_dropped_ns", -1)
    assert telemetry.RING_LEN == 65_536
    t = 10**18
    for i in range(telemetry.RING_LEN):
        telemetry.record("test.ring", t + 1000 * i, 500)
    assert telemetry.mean_ms("test.ring", t, t + 10**12) == 5e-4
    for i in range(3):
        telemetry.record("test.ring", t + 10**9 + i, 2000)
    assert len(telemetry._ring) == telemetry.RING_LEN
    # the three oldest records of the window are gone: no number
    assert telemetry.mean_ms("test.ring", t, t + 10**12) is None
    # a window that starts after every dropped record still reads
    assert telemetry.mean_ms("test.ring", t + 10**9, t + 10**12) == 2e-3
    assert telemetry.mean_ms("test.ring", t + 3000, t + 10**12) is not None


def test_mean_ms_counts_only_its_window():
    t = telemetry.now_ns() + 10**12          # after every real record
    telemetry.record("test.window", t - 10, 9_000_000)          # before
    telemetry.record("test.window", t, 1_000_000, key=1)
    telemetry.record("test.window", t + 500, 3_000_000, key=2)
    telemetry.record("test.window", t + 10**6 + 1, 50_000_000)   # after
    assert telemetry.mean_ms("test.window", t, t + 10**6) == 2.0
    assert telemetry.mean_ms("test.missing", t, t + 10**6) is None
    # exclusive: a span less its children of the same key and thread
    since = telemetry.now_ns()
    with telemetry.stage("test.parent", key=3):
        with telemetry.stage("test.child", key=3):
            time.sleep(0.01)
        time.sleep(0.005)
    until = telemetry.now_ns()
    whole = telemetry.mean_ms("test.parent", since, until)
    child = telemetry.mean_ms("test.child", since, until)
    own = telemetry.mean_ms("test.parent", since, until, exclusive=True)
    assert child >= 10 and own >= 5
    assert abs(whole - child - own) < 1e-9


def test_device_trace_writes_the_spans_on_their_own_track(tmp_path):
    with telemetry.device_trace(str(tmp_path), cuda=False) as path:
        with telemetry.stage("test.track", key=5):
            with telemetry.stage("test.track.child", key=5):
                x = torch.randn(32, 32)
                (x @ x).sum()
    _, events = _trace_events(path)
    names = [e for e in events if e.get("ph") == "M"
             and e.get("name") == "process_name"
             and e["args"]["name"] == "hello_tpu_torch spans"]
    assert len(names) == 1
    pid = names[0]["pid"]
    ours = {e["name"]: e for e in events if e.get("pid") == pid
            and e.get("ph") == "X"}
    assert set(ours) == {"test.track", "test.track.child"}
    assert ours["test.track"]["args"] == {"key": 5, "parent": None}
    assert ours["test.track.child"]["args"]["parent"] == "test.track"
    assert not [e for e in events if e.get("pid") == pid
                and e.get("cat") not in (None, "hello_tpu_torch")]
    child, parent = ours["test.track.child"], ours["test.track"]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    assert telemetry.trace_summary(path)["kernels"] == 0
