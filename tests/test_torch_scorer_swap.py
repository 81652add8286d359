"""Weights swapped into a used Scorer reach the read-conv kernel's fold
(the port's counterpart of tests/test_train.py's
test_scorer_params_hot_swap_invalidate).

A Scorer folds its read convolvers for ``read_conv_reduce`` when it is
built; it folds again at the next dispatch whenever a read-convolver
parameter was replaced or changed in place, and never otherwise.  On the CPU
the swapped scorer's logits equal the new weights' exactly.
"""

import numpy as np
import pytest
import torch

from hello_tpu_torch.nn import layers
from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites
from hello_tpu_torch.pipeline.call import load_scorer

torch.set_num_threads(1)


def _batch(hybrid):
    rng = np.random.RandomState(0)
    reads = lambda n: [rng.randint(0, 255, (n, 150, 6)).astype(np.uint8)
                       for _ in range(2)]
    sites = [SiteWork("c", 10 * i, 10 * i + 1, ["A", "C"], reads(3 + i),
                      reads(2 + i) if hybrid else None,
                      np.eye(5, dtype=np.float32)[rng.randint(0, 5, 150)])
             for i in range(3)]
    return pack_sites(sites, hybrid=hybrid)


@pytest.fixture(autouse=True)
def highest():
    layers.set_precision("highest")


def _logits(scorer, batch):
    experts, meta = scorer(batch)
    return np.asarray(experts), None if meta is None else np.asarray(meta)


@pytest.mark.parametrize("name", ["illumina", "hybrid"])
def test_swapped_weights_give_the_new_logits(name):
    batch = _batch(name == "hybrid")
    s0 = load_scorer(name, seed=0, device="cpu")
    e0, _ = _logits(s0, batch)
    s1 = load_scorer(name, seed=1, device="cpu")
    e1, m1 = _logits(s1, batch)
    assert not np.array_equal(e0, e1)

    s0.model.load_state_dict(s1.model.state_dict())
    e_swapped, m_swapped = _logits(s0, batch)
    np.testing.assert_array_equal(e_swapped, e1)
    if m1 is not None:
        np.testing.assert_array_equal(m_swapped, m1)


def test_in_place_change_and_replaced_module_refold():
    batch = _batch(False)
    scorer = load_scorer("illumina", seed=0, device="cpu")
    folds = []
    fold = scorer.model.fold_read_convs
    scorer.model.fold_read_convs = lambda: folds.append(1) or fold()
    e0, _ = _logits(scorer, batch)
    e0_again, _ = _logits(scorer, batch)
    np.testing.assert_array_equal(e0_again, e0)
    assert folds == []                      # unchanged weights: no refold

    # an in-place update (what an optimiser step does) of one conv weight
    with torch.no_grad():
        scorer.model.read_convolver0.network[0].conv1d.weight_g.mul_(1.5)
    e_changed, _ = _logits(scorer, batch)
    assert folds == [1] and not np.array_equal(e_changed, e0)
    fresh = load_scorer("illumina", seed=0, device="cpu")
    fresh.model.load_state_dict(scorer.model.state_dict())
    np.testing.assert_array_equal(e_changed, _logits(fresh, batch)[0])

    # a replaced read convolver (new parameter objects)
    other = load_scorer("illumina", seed=1, device="cpu")
    scorer.model.read_convolver0 = other.model.read_convolver0
    _logits(scorer, batch)
    assert folds == [1, 1]
