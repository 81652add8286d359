"""The port's training losses and schedules against hello_tpu's (CPU).

Every loss function of train/loss.py takes the same seeded numpy inputs on
both sides, with padded allele slots, label smoothing, the auxiliary
per-expert loss, class weights and saturated logits; values and gradients
(by jax.grad and torch.autograd) agree within rtol 1e-5, with an absolute
tolerance of 1e-6 of the largest gradient entry for entries that cancel to
near zero.  The schedules agree step by step for 200 steps (hello_tpu
evaluates them in float32: rtol 1e-5 and atol 1e-6 of the base rate).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.train import loss as jax_loss
from hello_tpu.train import schedule as jax_schedule
from hello_tpu_torch.train import loss, schedule

torch.set_num_threads(1)


def _inputs(rng, saturate):
    """10 allele slots over 4 sites, the last two slots padding on a site
    that also holds real alleles."""
    A, S, E = 10, 4, 3
    logits = (rng.randn(A, E) * 3).astype(np.float32)
    if saturate:
        # sigmoid is exactly 1 or below 1e-7 in fp32: the clip's flat sides
        logits[0] = [40.0, -40.0, 17.0]
        logits[4] = [-17.0, 30.0, 0.0]
    meta = np.exp(rng.randn(S, E)).astype(np.float32)
    meta /= meta.sum(axis=1, keepdims=True)
    labels = (rng.rand(A) < 0.5).astype(np.float32)
    site_ids = np.array([0, 0, 1, 1, 1, 2, 3, 3, 3, 3], np.int32)
    allele_mask = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    return logits, meta, labels, site_ids, allele_mask


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-6 * max(scale, 1e-30))


MOE_CASES = {
    "eval": dict(train=False),
    "train_entropy": dict(train=True, regularizer=0.1),
    "smoothing": dict(train=True, regularizer=0.05, smoothing=0.1),
    "aux": dict(train=True, aux_weight=0.3),
    "class_weights": dict(train=True, regularizer=0.1,
                          class_weights=(0.7, 2.5)),
}


@pytest.mark.parametrize("saturate", [False, True], ids=["plain", "saturated"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_loss_value_and_grads(rng, case, saturate):
    logits, meta, labels, site_ids, mask = _inputs(rng, saturate)
    kw = MOE_CASES[case]

    def jax_total(lg, mt):
        return jax_loss.moe_loss(lg, mt, labels, site_ids, mask, **kw)[0]

    j_total, j_per, j_post = jax_loss.moe_loss(logits, meta, labels,
                                               site_ids, mask, **kw)
    j_glog, j_gmeta = jax.grad(jax_total, argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(meta))

    tl = torch.tensor(logits, requires_grad=True)
    tm = torch.tensor(meta, requires_grad=True)
    total, per, post = loss.moe_loss(
        tl, tm, torch.from_numpy(labels), torch.from_numpy(site_ids),
        torch.from_numpy(mask), **kw)
    total.backward()
    _close(total.item(), float(j_total))
    _close(per.detach().numpy(), j_per)
    _close(post.numpy(), j_post)
    assert np.isfinite(tl.grad.numpy()).all() and np.isfinite(tm.grad.numpy()).all()
    _close(tl.grad.numpy(), j_glog)
    _close(tm.grad.numpy(), j_gmeta)


@pytest.mark.parametrize("saturate", [False, True], ids=["plain", "saturated"])
def test_binary_loss_value_and_grads(rng, saturate):
    logits, _, labels, _, mask = _inputs(rng, saturate)
    logits = logits[:, :1].copy()
    logits[2, 0] = 0.0          # max(x, 0) at its tie: half the gradient

    j_total, j_grad = jax.value_and_grad(
        lambda lg: jax_loss.binary_loss(lg, labels, mask))(jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    total = loss.binary_loss(tl, torch.from_numpy(labels),
                             torch.from_numpy(mask))
    total.backward()
    _close(total.item(), float(j_total))
    _close(tl.grad.numpy(), j_grad)


def test_clip_gradient_at_the_bounds():
    """jnp.clip's gradient on values at, inside and beyond its bounds, and
    the port's max-then-min clip's, are the same (a tie splits it)."""
    lo, hi = np.float32(1e-7), np.float32(1.0 - 1e-7)
    x = np.array([0.0, lo, 0.5, hi, 1.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 1e-7, 1.0 - 1e-7)
                                      * jnp.arange(1.0, 6.0)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (loss._clip(t, 1e-7, 1.0 - 1e-7) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn", ["prediction_loss", "accuracy"])
def test_validation_metrics(rng, fn):
    logits, meta, labels, site_ids, mask = _inputs(rng, saturate=True)
    want = getattr(jax_loss, fn)(logits, meta, labels, site_ids, mask)
    got = getattr(loss, fn)(*(torch.from_numpy(a) for a in
                              (logits, meta, labels, site_ids, mask)))
    _close(got.item(), float(want))


def test_capped_log_grad_is_finite_at_zero_and_one():
    x = torch.tensor([0.0, 1e-12, 0.5, 1.0], requires_grad=True)
    loss.capped_log(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_loss.capped_log(v)))(
        jnp.asarray(x.detach().numpy()))
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)


def test_moe_loss_padding_invariance(rng):
    """Padded allele slots change neither the loss nor the real slots'
    gradients, and get no gradient themselves."""
    A, S, E = 6, 3, 3
    logits = rng.randn(A, E).astype(np.float32)
    meta = np.full((S, E), 1 / 3, np.float32)
    labels = (rng.rand(A) < 0.5).astype(np.float32)
    site_ids = np.array([0, 0, 1, 1, 2, 2], np.int32)
    mask = np.ones(A, np.float32)
    pad = 4
    padded = (np.concatenate([logits, rng.randn(pad, E).astype(np.float32)]),
              np.concatenate([labels, np.ones(pad, np.float32)]),
              np.concatenate([site_ids, np.full(pad, S - 1, np.int32)]),
              np.concatenate([mask, np.zeros(pad, np.float32)]))
    out = []
    for lg, lb, sid, mk in ((logits, labels, site_ids, mask), padded):
        t = torch.tensor(lg, requires_grad=True)
        total, _, _ = loss.moe_loss(t, torch.from_numpy(meta),
                                    torch.from_numpy(lb),
                                    torch.from_numpy(sid),
                                    torch.from_numpy(mk), regularizer=0.1)
        total.backward()
        out.append((total.item(), t.grad.numpy()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[1][1][:A], out[0][1], rtol=1e-6)
    assert not out[1][1][A:].any()


SCHEDULES = {
    "sgdr_tmult2": ("cosine_warm_restarts", (1e-2, 10, 2, 1e-4, 1)),
    "sgdr_tmult2_fractional": ("cosine_warm_restarts", (3e-3, 2, 2, 0.0, 7)),
    "sgdr_tmult1": ("cosine_warm_restarts", (1e-2, 5, 1, 1e-3, 3)),
    "warmup_tmult2": ("sine_warmup_restarts", (1e-2, 3, 2, 1e-4, 4)),
    "warmup_tmult1": ("sine_warmup_restarts", (5e-3, 4, 1, 0.0, 1)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_step_by_step(name):
    fn, args = SCHEDULES[name]
    want = getattr(jax_schedule, fn)(*args)
    got = getattr(schedule, fn)(*args)
    steps = np.arange(200)
    w = np.array([float(want(int(s))) for s in steps])
    g = np.array([got(int(s)) for s in steps])
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * args[0])


def test_entropy_decay():
    want = jax_schedule.entropy_decay(0.1, 0.5)
    got = schedule.entropy_decay(0.1, 0.5)
    for step in range(200):
        assert got(step) == want(step)


OPTIMIZERS = {
    "adam": dict(optimizer="Adam", grad_clip_norm=10.0, scale=1.0),
    "adam_clipped": dict(optimizer="Adam", grad_clip_norm=1.0, scale=5.0),
    "sgd": dict(optimizer="SGD", grad_clip_norm=10.0, scale=1.0),
    "sgdr_clipped": dict(optimizer="SGDR", grad_clip_norm=0.5, scale=3.0),
    "warmup_no_clip": dict(optimizer="SGD", warmup=True, grad_clip_norm=0.0,
                           scale=2.0),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """The port's update rules against hello_tpu's optax chain over five
    updates of three leaves: clip_by_global_norm first (with no epsilon),
    adamw / sgd with decayed weights and momentum, the schedule at the count
    before its increment."""
    from hello_tpu.train import trainer as jax_trainer
    from hello_tpu_torch.train.trainer import Optimizer, TrainConfig

    kw = dict(OPTIMIZERS[name])
    scale = kw.pop("scale")
    kw.update(lr=1e-2, steps_per_epoch=2, t0=1)
    rng = np.random.RandomState(len(name))
    shapes = [(3, 4), (5,), (2, 3, 4)]
    start = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * scale).astype(np.float32) for s in shapes]
             for _ in range(5)]
    tx = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**kw))
    want = [jnp.asarray(x) for x in start]
    state = tx.init(want)
    params = [torch.tensor(x) for x in start]
    opt = Optimizer(TrainConfig(**kw), params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, want)
        want = [w + u for w, u in zip(want, updates)]
        opt.update([torch.tensor(x) for x in g])
    assert opt.count == 5
    for got, w in zip(params, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
