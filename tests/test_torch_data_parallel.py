"""The port's data-parallel step (k sub-batches on one device, summed)
against hello_tpu's k-device mesh step (CPU, ``highest``).

hello_tpu runs a stacked batch's k sub-batches on a k-device ``data`` mesh
and ``psum``s the loss and gradients; the port runs them in order on one
device and sums them.  The same initial parameters (hello_tpu's seeded init
carried over with ``state_dict_from_jax``) on the same stacked batches:

  * one k=2 step's loss within rtol 1e-6 and every leaf's gradient within
    rtol 1e-4 plus an atol of 1e-5 of the leaf's largest entry
    (tests/test_torch_trainer.py's one-step bars), for ``illumina`` at the
    shapes of tests/test_two_process.py (batch_alleles 16, buckets 64/64/32)
    and ``hybrid`` on example batches;
  * three Adam steps at k=2: each step's loss within rtol 1e-5, and all but
    0.5% of each leaf's entries within the three-step bar of
    tests/test_torch_trainer.py (rtol 1e-4 plus a tenth of the leaf's
    largest move; the rest are entries whose summed gradient cancels into
    float noise, which Adam's normalised update turns into either sign);
  * ``unsharded_step_reference`` equal to the summed step and to hello_tpu's
    reference, scales included;
  * a stacked axis other than k raises;
  * ``train_from_shards(num_devices=2)`` ends at hello_tpu's parameters.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)
import __graft_entry__ as ge  # noqa: E402
from test_two_process import BATCH_ALLELES, _make_shards  # noqa: E402

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn import moe as jax_moe  # noqa: E402
from hello_tpu.parallel.mesh import data_mesh  # noqa: E402
from hello_tpu.pipeline.batching import stack_device_batches  # noqa: E402
from hello_tpu.train import trainer as jax_trainer  # noqa: E402
from hello_tpu.train.loader import SiteDataset, device_batches  # noqa: E402
from hello_tpu_torch.nn import moe  # noqa: E402
from hello_tpu_torch.nn.convert import state_dict_from_jax  # noqa: E402
from hello_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.set_num_threads(1)

FIXED = {"read_bucket": 64, "allele_bucket": 64, "site_bucket": 32}


@pytest.fixture(scope="module", autouse=True)
def highest():
    jax_layers.set_precision("highest")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return _make_shards(tmp_path_factory.mktemp("dp"))


def _example_stack(name, k=2, seed=5):
    rng = np.random.RandomState(seed)
    return stack_device_batches(
        [ge._example_batch(rng, hybrid=name == "hybrid", A=8, R=2, S=4,
                           labels=True) for _ in range(k)])


def _stacked(name, shards):
    """A k=2 stacked batch: illumina's at tests/test_two_process.py's
    shapes from its shards, hybrid's from example batches."""
    if name == "hybrid":
        return _example_stack(name)
    return next(iter(device_batches(
        SiteDataset(shards[1:], 1000, shuffle=True, seed=13), False, 2,
        BATCH_ALLELES, fixed_shape=FIXED)))


def _cfg(name):
    if name == "hybrid":
        return dict(entropy_regularizer=0.1)
    return dict(binary=True)


def _pair(name, k=2, **cfg):
    """hello_tpu's trainer on a k-device mesh and the port's at k, from the
    same initial parameters."""
    cfg = {**_cfg(name), **cfg}
    jt = jax_trainer.Trainer(jax_moe.create_model(name),
                             jax_trainer.TrainConfig(**cfg),
                             mesh=data_mesh(k), seed=3)
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    tm = moe.create_model(name)
    tt = Trainer(tm, TrainConfig(**cfg), device="cpu", num_devices=k,
                 params=state_dict_from_jax(tm, params, {}))
    return jt, tt, params


def _as_sd(model, tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, tree), {}).items()}


def _leaf_close(got, want, name):
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=max(1e-5 * float(np.abs(want).max()), 1e-30), err_msg=name)


@pytest.mark.parametrize("name", ["illumina", "hybrid"])
def test_two_sub_batch_step_matches_the_mesh(name, shards):
    stacked = _stacked(name, shards)
    assert len(stacked["labels"]) == 2
    jt, tt, _ = _pair(name)
    want_loss, want_grads = jt.compute_grads(stacked)
    loss, grads = tt.compute_grads(stacked)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    want = _as_sd(tt.model, want_grads)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        _leaf_close(g.numpy(), want[k], k)


def test_three_adam_steps_at_two_sub_batches_match_the_mesh():
    stacked = _example_stack("illumina")
    jt, tt, params = _pair("illumina", optimizer="Adam", lr=1e-3)
    for _ in range(3):
        want = jt.train_batch(stacked)["loss"]
        got = tt.train_batch(stacked)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tt.step == jt.step == 3
    start = _as_sd(tt.model, params)
    want = _as_sd(tt.model, jt.params)
    for k, v in tt.model.state_dict().items():
        # Adam divides each gradient by its running RMS: an entry whose
        # summed gradient cancels to within the frameworks' float noise
        # gets an update of either sign (measured: 9 of 12,288 entries of
        # one leaf).  Every other entry holds the three-step bar of
        # tests/test_torch_trainer.py.
        move = float(np.abs(want[k] - start[k]).max())
        off = ~np.isclose(v.numpy(), want[k], rtol=1e-4, atol=0.1 * move)
        assert off.sum() <= np.ceil(0.005 * off.size), (k, int(off.sum()))


@pytest.mark.parametrize("name", ["illumina", "hybrid"])
def test_unsharded_step_reference_matches_step_and_hello_tpu(name):
    stacked = _example_stack(name, seed=8)
    jt, tt, _ = _pair(name)
    before = [p.detach().clone() for p in tt.params]
    loss, grads, scales = tt.unsharded_step_reference(stacked)
    assert tt.step == 0 and tt.opt.count == 0
    for p, q in zip(tt.params, before):
        assert torch.equal(p, q)
    got_loss, got_grads = tt.compute_grads(stacked)
    np.testing.assert_allclose(got_loss, loss, rtol=1e-6)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), grads[k].numpy(), rtol=1e-6,
                                   atol=1e-6 * scales[k] + 1e-30, err_msg=k)
    want_loss, want_grads, want_scales = jt.unsharded_step_reference(stacked)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    want = _as_sd(tt.model, want_grads)
    # each scale spread over its leaf's shape, so the layout change of
    # state_dict_from_jax carries it to the port's name
    want_s = _as_sd(tt.model, jax.tree_util.tree_map(
        lambda g, s: np.full(np.shape(g), float(s), np.float32),
        want_grads, want_scales))
    for k, g in grads.items():
        _leaf_close(g.numpy(), want[k], k)
        np.testing.assert_allclose(scales[k], want_s[k].max(), rtol=1e-4,
                                   err_msg=k)


def test_stacked_axis_other_than_k_raises():
    tt = Trainer(moe.create_model("illumina"), TrainConfig(binary=True),
                 device="cpu", num_devices=2)
    one = _example_stack("illumina", k=1)
    three = _example_stack("illumina", k=3)
    for stacked in (one, three):
        with pytest.raises(ValueError, match="num_devices=2"):
            tt.compute_grads(stacked)
        with pytest.raises(ValueError, match="num_devices=2"):
            tt.train_batch(stacked)
    assert tt.step == 0
    with pytest.raises(ValueError, match="num_devices"):
        Trainer(moe.create_model("illumina"), TrainConfig(binary=True),
                device="cpu", num_devices=0)


def test_train_from_shards_two_sub_batches_matches_hello_tpu(shards, tmp_path):
    """One epoch of both CLIs' train_from_shards at num_devices=2, from the
    same seeded start (the port's seed-13 init is not hello_tpu's, so the
    port resumes from a checkpoint of hello_tpu's initial parameters)."""
    from hello_tpu.train import cli as jax_cli
    from hello_tpu.train.checkpoint import save_checkpoint
    from hello_tpu_torch.train import cli

    kw = dict(num_epochs=1, batch_alleles=BATCH_ALLELES, num_devices=2,
              read_bucket=FIXED["read_bucket"])
    want = jax_cli.train_from_shards(shards, "illumina",
                                     str(tmp_path / "jax"), **kw)
    start = jax_trainer.Trainer(jax_moe.create_model("illumina"),
                                jax_trainer.TrainConfig(), seed=13,
                                mesh=data_mesh(2))
    init = str(tmp_path / "init.ckpt")
    save_checkpoint(init, start.params, {}, None, step=0)
    got = cli.train_from_shards(shards, "illumina", str(tmp_path / "port"),
                                device="cpu", resume=init, **kw)
    assert got.step == want.step > 0
    assert got.num_devices == 2
    start_sd = _as_sd(got.model, start.params)
    want_sd = _as_sd(got.model, want.params)
    for k, v in got.model.state_dict().items():
        move = float(np.abs(want_sd[k] - start_sd[k]).max())
        np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=1e-4,
                                   atol=0.1 * move + 1e-30, err_msg=k)
    for prefix in ("jax", "port"):
        assert (tmp_path / f"{prefix}.final.ckpt").exists()
