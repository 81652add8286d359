"""The controls: the plain reference in the program's place, computed in
the nearest precision below the one the configuration states, comes out
not correct.  Scoring (bf16 stated; fp8 e4m3 control) at a size the CPU
holds; training (highest stated; TF32 control) only on the card, where
TF32 exists, at the cell's own size."""

import pytest
import torch

from h100_bench import calibrate, cells, check


@pytest.mark.parametrize("cell", ["hybrid.score.bf16", "illumina.score.bf16"])
def test_score_control_fails(cell, tiny):
    spec = tiny(cell)
    spec["traffic"] = dict(spec["traffic"], sites_per_batch=48,
                           reads_per_allele={"illumina": [4, 8],
                                             "pacbio": [2, 4]})
    readings = calibrate.control_score(spec, 11, torch.device("cpu"))
    assert not check.passed(check.judge(readings, spec["limits"]))


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_training_control_fails_on_the_card(card, seed):
    spec = cells.cell("hybrid.train.highest")
    readings, _, _ = calibrate.control_train(spec, seed, card)
    assert not check.passed(check.judge(readings, spec["limits"]))


@pytest.mark.card
def test_score_control_fails_on_the_card(card):
    spec = cells.cell("hybrid.score.bf16")
    readings = calibrate.control_score(spec, 2**31 + 4, card)
    assert not check.passed(check.judge(readings, spec["limits"]))
