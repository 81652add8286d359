"""Training a model with batch norm (``illumina_layer_norm``) in the port
against hello_tpu (CPU, ``highest``).

``illumina_layer_norm`` is the named config with state: its xattn terminus
keeps a BatchNorm1d over the allele axis.  From the same initial parameters
and statistics (hello_tpu's seeded init carried over with
``state_dict_from_jax``), on batches with padded allele slots and reads:

  * train-mode batch-norm statistics ignore padding: the same sites packed
    at two bucket sizes give the same real-slot logits and running
    statistics (hello_tpu's tests/test_moe_parity.py:303, on the port);
  * the first three SGD steps against hello_tpu's Trainer: each loss
    within rtol 1e-4, the running statistics within rtol 1e-4 / atol 1e-5;
  * a k=2 step's statistics equal hello_tpu's 2-device ``pmean`` and the
    mean of the two one-sub-batch steps; ``remat`` updates them once;
    ``compute_grads`` and ``unsharded_step_reference`` leave them alone;
  * ``Trainer.evaluate`` normalises with the running statistics, as
    hello_tpu's does; checkpoints carry them both ways;
  * a Scorer's replicas take a primary's changed statistics.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
import __graft_entry__ as ge  # noqa: E402

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn import moe as jax_moe  # noqa: E402
from hello_tpu.parallel.mesh import data_mesh  # noqa: E402
from hello_tpu.pipeline.batching import stack_device_batches  # noqa: E402
from hello_tpu.train import trainer as jax_trainer  # noqa: E402
from hello_tpu_torch.nn import moe  # noqa: E402
from hello_tpu_torch.nn.convert import (jax_params_from_state_dict,  # noqa: E402
                                        state_dict_from_jax)
from hello_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.set_num_threads(1)

NAME = "illumina_layer_norm"


@pytest.fixture(scope="module", autouse=True)
def highest():
    jax_layers.set_precision("highest")


def _batch(rng, A=8, R=3, S=4, pad=2):
    """A labelled dense batch whose last ``pad`` allele slots are padding
    (no reads, a site of their own) and whose reads are partly masked."""
    b = ge._example_batch(rng, hybrid=False, A=A, R=R, S=S, labels=True)
    b["allele_mask"][A - pad:] = 0.0
    b["read_mask0"][A - pad:] = 0.0
    b["site_ids"][A - pad:] = S - 1
    return b


def _stack(seed, k):
    rng = np.random.RandomState(seed)
    return stack_device_batches([_batch(rng) for _ in range(k)])


def _pair(k=1, **cfg):
    """hello_tpu's trainer on a k-device mesh and the port's at k, from the
    same initial parameters and statistics."""
    cfg = dict(binary=True, **cfg)
    jt = jax_trainer.Trainer(jax_moe.create_model(NAME),
                             jax_trainer.TrainConfig(**cfg),
                             mesh=data_mesh(k), seed=3)
    tm = moe.create_model(NAME)
    sd = state_dict_from_jax(tm, *_np((jt.params, jt.state)))
    return jt, Trainer(tm, TrainConfig(**cfg), device="cpu", num_devices=k,
                       params=sd)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(tt):
    """The port's statistics as hello_tpu's state tree."""
    return jax_params_from_state_dict(tt.model)[1]


def _assert_state_close(got, want, rtol=1e-4, atol=1e-5):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_mode_batchnorm_padding_invariance():
    """The same 6 alleles over 3 sites at buckets (8, 8, 4) and (16, 16,
    8): equal real-slot logits and running statistics in train mode."""
    jm = jax_moe.create_model(NAME)
    params, state = _np(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(3)
    real = rng.randint(0, 255, size=(6, 5, 150, 6)).astype(np.uint8)
    segs = np.eye(5, dtype=np.float32)[rng.randint(0, 5, size=(3, 150))]
    outs, stats = [], []
    for A, R, S in [(8, 8, 4), (16, 16, 8)]:
        b = {"reads0": np.zeros((A, R, 150, 6), np.uint8),
             "read_mask0": np.zeros((A, R), np.float32),
             "site_ids": np.zeros((A,), np.int32),
             "allele_mask": np.zeros((A,), np.float32),
             "ref_segments": np.zeros((S, 150, 5), np.float32)}
        b["reads0"][:6, :5] = real
        b["read_mask0"][:6, :5] = 1.0
        b["site_ids"][:6] = np.repeat(np.arange(3, dtype=np.int32), 2)
        b["allele_mask"][:6] = 1.0
        b["ref_segments"][:3] = segs
        tm = moe.create_model(NAME)
        tm.load_state_dict(state_dict_from_jax(tm, params, state))
        with torch.no_grad():
            out = tm.train()({k: torch.from_numpy(v) for k, v in b.items()})
        outs.append(out["experts"].numpy()[:6])
        stats.append(jax_params_from_state_dict(tm)[1])
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-5, atol=2e-5)
    _assert_state_close(stats[1], stats[0], rtol=2e-5, atol=2e-5)
    # and the statistics moved: the mask did not switch the update off
    moved = jax.tree_util.tree_leaves(stats[0])[0]
    assert np.abs(moved - jax.tree_util.tree_leaves(state)[0]).max() > 1e-3


def test_first_steps_match_hello_tpu():
    """Three SGD steps: losses within rtol 1e-4, running statistics within
    rtol 1e-4 / atol 1e-5 after each.  (SGD, not Adam: Adam divides each
    gradient by its running RMS, so entries whose gradient is fp32 noise
    move the parameters, and with them the next steps' statistics, by far
    more than the frameworks' summation orders do: measured 1e-2 relative
    on one statistic after three Adam steps, 2.5e-7 after three SGD
    steps.)"""
    jt, tt = _pair(optimizer="SGD")
    for step in range(3):
        stacked = _stack(20 + step, 1)
        want = jt.train_batch(stacked)["loss"]
        got = tt.train_batch(stacked)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-4)
        _assert_state_close(_stats(tt), _np(jt.state))
    assert tt.step == jt.step == 3


def test_two_sub_batch_state_is_the_pmean():
    """A k=2 step: the loss as hello_tpu's 2-device step, the statistics as
    its pmean, and as the mean of two k=1 steps from the same start."""
    stacked = _stack(31, 2)
    jt, tt = _pair(k=2)
    want = jt.train_batch(stacked)["loss"]
    got = tt.train_batch(stacked)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_state_close(_stats(tt), _np(jt.state))
    singles = []
    for i in range(2):
        _, one = _pair(k=1)
        one.train_batch({k: v[i:i + 1] for k, v in stacked.items()})
        singles.append(_stats(one))
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *singles)
    _assert_state_close(_stats(tt), mean, rtol=1e-6, atol=1e-7)


def test_remat_and_gradient_calls_update_the_statistics_once():
    """remat's recomputed forward does not move the statistics a second
    time; compute_grads and unsharded_step_reference leave them as they
    were."""
    stacked = _stack(41, 2)
    _, plain = _pair(k=2)
    _, remat = _pair(k=2, remat=True)
    before = _stats(plain)
    plain.compute_grads(stacked)
    plain.unsharded_step_reference(stacked)
    _assert_state_close(_stats(plain), before, rtol=0, atol=0)
    la = plain.train_batch(stacked)["loss"]
    lb = remat.train_batch(stacked)["loss"]
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    _assert_state_close(_stats(remat), _stats(plain), rtol=1e-6, atol=1e-7)


def test_evaluate_uses_running_statistics(tmp_path):
    """After a step, evaluate() equals hello_tpu's (eval forward with the
    running statistics), and the port's checkpoint carries the statistics
    to hello_tpu and back."""
    from hello_tpu.train.checkpoint import load_checkpoint

    jt, tt = _pair()
    stacked = _stack(51, 1)
    jt.train_batch(stacked)
    tt.train_batch(stacked)
    val = [_batch(np.random.RandomState(s)) for s in (52, 53)]
    np.testing.assert_allclose(tt.evaluate(val), jt.evaluate(val), rtol=1e-4)
    path = str(tmp_path / "bn.ckpt")
    tt.save(path)
    params, state = load_checkpoint(path)
    _assert_state_close(state, _np(jt.state))
    back = Trainer(moe.create_model(NAME), TrainConfig(binary=True),
                   device="cpu").restore(path)
    _assert_state_close(_stats(back), _stats(tt), rtol=0, atol=0)


def test_scorer_replicas_take_changed_statistics():
    """Scorer(devices=[cpu, cpu]): after the primary's running statistics
    change in place, the second position scores with them too."""
    from hello_tpu_torch.pipeline.call import Scorer
    from hello_tpu_torch.pipeline.batching import SiteWork

    jm = jax_moe.create_model(NAME)
    tm = moe.create_model(NAME)
    tm.load_state_dict(state_dict_from_jax(
        tm, *_np(jm.init(jax.random.PRNGKey(1)))))
    scorer = Scorer(tm, devices=["cpu", "cpu"])
    assert scorer.read_conv_routes() == {"read_conv0": "layers"}
    rng = np.random.RandomState(2)
    sites = [SiteWork("chr1", 100 + 10 * i, 101 + 10 * i, ["A", "C"],
                      [rng.randint(0, 255, (3, 150, 6)).astype(np.uint8),
                       rng.randint(0, 255, (2, 150, 6)).astype(np.uint8)],
                      None, np.eye(5, dtype=np.float32)[
                          rng.randint(0, 5, 150)]) for i in range(3)]
    from hello_tpu_torch.pipeline.batching import pack_sites
    batch = pack_sites(sites, hybrid=False)
    first = [scorer(batch)[0] for _ in range(2)]
    np.testing.assert_array_equal(first[0], first[1])
    bn = tm.xattn0.network[-2]
    with torch.no_grad():
        bn.running_mean.add_(0.5)
        bn.running_var.mul_(2.0)
    after = [scorer(batch)[0] for _ in range(2)]
    assert scorer.dispatch_counts == {0: 2, 1: 2}
    assert np.abs(after[0] - first[0]).max() > 1e-3
    np.testing.assert_array_equal(after[0], after[1])
