"""The harness prints the contract's one line, at a tiny size on the CPU
with the kernel's plain version."""

import io
import json

import pytest
import torch

from h100_bench import cells, check, run

CELLS = ["hybrid.score.bf16", "illumina.score.bf16", "hybrid.train.highest"]
SEED = 2**31 + 12345


@pytest.mark.parametrize("cell", CELLS)
def test_line_at_tiny_size(cell, tiny):
    spec = tiny(cell)
    line = run.run_cell(cell, SEED, 0.5, 0, torch.device("cpu"), spec=spec)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in spec["end_to_end"]}
    assert set(line["metrics"]) == want and "setup_s" in want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == set(spec["limits"])
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)


def test_traced_line_reads_the_span_metrics(tiny):
    cell = "illumina.score.bf16"
    line = run.run_cell(cell, SEED, 0.5, 1, torch.device("cpu"),
                        spec=tiny(cell))
    per_layer = {m["name"] for m in cells.cell(cell)["per_layer"]}
    assert set(line["metrics"]) <= per_layer
    # the CPU has no device trace: only the host clock's metrics are read
    assert set(line["metrics"]) == {"score_batch_p95_ms", "pack_ms.score",
                                    "dispatch_ms.score",
                                    "finalize_wait_ms.score"}
    assert list(line)[-1] == "checks"


def test_checks_are_reported_beside_their_limits():
    checks = check.judge({"a": 0.5, "b": 3.0},
                         {"a": {"limit": 1.0}, "b": {"limit": 2.0},
                          "c": {"limit": 0}})
    assert not check.passed(checks)
    assert check.passed(check.judge({"a": 0.5}, {"a": {"limit": 1.0}}))
    out = io.StringIO()
    check.report(checks, out)
    assert out.getvalue().splitlines() == [
        "check a 0.5 limit 1.0", "check b 3.0 limit 2.0",
        "check c None limit 0"]
