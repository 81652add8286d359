"""A run with the timed path broken underneath comes out not correct: one
test for each fault a cell can have (its look for a card skipped: the runs
are on the CPU at tiny sizes).  The exchange between chips has no fault
here: every cell runs on one chip."""

import pytest
import torch

from h100_bench import run

SEED = 2**31 + 4242
SCORE_CELLS = ["hybrid.score.bf16", "illumina.score.bf16"]


def _line(cell, tiny):
    return run.run_cell(cell, SEED, 0.3, 0, torch.device("cpu"),
                        spec=tiny(cell))


@pytest.mark.parametrize("cell", SCORE_CELLS)
def test_sound_run_is_correct(cell, tiny):
    assert _line(cell, tiny)["correct"] is True


def _patch_decode(monkeypatch, change):
    from hello_tpu_torch.nn import genotype

    real = genotype.decode_pairs_device

    def broken(*a, **kw):
        return change(real(*a, **kw))

    monkeypatch.setattr(genotype, "decode_pairs_device", broken)


@pytest.mark.parametrize("cell", SCORE_CELLS)
def test_an_answer_altered_where_it_is_produced(cell, tiny, monkeypatch):
    def alter(out):
        out["best_p"] = out["best_p"] * 0.8
        return out

    _patch_decode(monkeypatch, alter)
    line = _line(cell, tiny)
    assert line["correct"] is False
    assert line["checks"]["p_err_ratio"]["value"] > \
        line["checks"]["p_err_ratio"]["limit"]


def _pair_prob(experts, meta, site_ids, allele_mask, num_sites, i, j):
    """The port's decode probability of slot pairs (i, j), one per site."""
    sid = site_ids.long()
    sig = torch.sigmoid(experts.float())
    l1, l0 = torch.log(sig + 1e-10), torch.log(1.0 - sig + 1e-10)
    site_l0 = torch.zeros((num_sites, experts.shape[1]),
                          device=experts.device)
    site_l0.index_add_(0, sid, l0 * allele_mask.float()[:, None])
    d = l1 - l0
    p = torch.exp(site_l0 + d[i] + torch.where((i != j)[:, None], d[j], 0.0))
    return p[:, 0] if meta is None else (p * meta.float()[:, :3]).sum(1)


@pytest.mark.parametrize("cell", SCORE_CELLS)
def test_a_valid_pair_that_is_not_the_best(cell, tiny, monkeypatch):
    """The decode answers, with its own probability, the pair that the
    logits' opposites make best: a valid pair of the site, mostly not its
    best, so only the pair gap can tell."""
    from hello_tpu_torch.nn import genotype

    real = genotype.decode_pairs_device

    def other(experts, meta, site_ids, allele_mask, num_sites):
        out = real(-experts, meta, site_ids, allele_mask, num_sites)
        i, j = out["best_i"].long(), out["best_j"].long()
        out["best_p"] = _pair_prob(experts, meta, site_ids, allele_mask,
                                   num_sites, i, j)
        return out

    monkeypatch.setattr(genotype, "decode_pairs_device", other)
    line = _line(cell, tiny)
    assert line["correct"] is False
    assert line["checks"]["bad_answers"]["value"] == 0
    assert line["checks"]["p_err_ratio"]["value"] <= \
        line["checks"]["p_err_ratio"]["limit"]
    assert line["checks"]["pair_gap_ratio"]["value"] > \
        line["checks"]["pair_gap_ratio"]["limit"]


@pytest.mark.parametrize("cell", SCORE_CELLS)
def test_half_of_the_batch_left_out(cell, tiny, monkeypatch):
    def half(out):
        keep = torch.arange(out["valid"].shape[0]) % 2 == 0
        out["valid"] = out["valid"] & keep.to(out["valid"].device)
        return out

    _patch_decode(monkeypatch, half)
    line = _line(cell, tiny)
    assert line["correct"] is False
    assert line["checks"]["bad_answers"]["value"] > 0


def test_training_sound_run_is_correct(tiny):
    assert _line("hybrid.train.highest", tiny)["correct"] is True


def test_a_step_that_returns_its_state_unchanged(tiny, monkeypatch):
    from hello_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "update",
                        lambda self, grads: None)
    line = _line("hybrid.train.highest", tiny)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > \
        line["checks"]["change_gap"]["limit"]


def test_a_step_on_half_of_the_batch(tiny, monkeypatch):
    from hello_tpu_torch.train import trainer

    real = trainer._batch_loss

    def half(model, config, batch, reg):
        batch = dict(batch)
        mask = batch["allele_mask"].clone()
        mask[1::2] = 0
        batch["allele_mask"] = mask
        total, per_expert = real(model, config, batch, reg)
        return 2 * total, per_expert

    monkeypatch.setattr(trainer, "_batch_loss", half)
    line = _line("hybrid.train.highest", tiny)
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > \
        line["checks"]["loss_gap"]["limit"]
