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
  * ``tunnel_health`` returns hello_tpu's four keys.
"""

import glob
import json
import os
import sys

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
