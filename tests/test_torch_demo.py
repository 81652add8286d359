"""The port's demo (simulate -> dump -> train -> call -> evaluate) at a tiny
size on the CPU: it prints hello_tpu's JSON summary with precision and
recall, and without ``--device cpu`` on a machine without a card it
raises instead of running on the CPU."""

import json

import pytest
import torch

from hello_tpu_torch import demo

torch.set_num_threads(1)

TINY = ["--train_ref_length", "8000", "--train_variants", "20",
        "--test_ref_length", "5000", "--test_variants", "10", "--epochs", "1"]


def test_demo_on_the_cpu(tmp_path, capsys):
    assert demo.main(["--outdir", str(tmp_path), "--device", "cpu"]
                     + TINY) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert sorted(summary) == ["calls_vcf", "metrics", "seconds", "truth_vcf"]
    metrics = summary["metrics"]
    for key in ("precision", "recall", "f1", "tp", "fp", "fn"):
        assert key in metrics
    assert metrics["tp"] > 0
    assert (tmp_path / "model.final.ckpt").exists()


def test_demo_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--outdir", str(tmp_path)] + TINY)
