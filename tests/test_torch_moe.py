"""The port's MoEAttention forward against hello_tpu's (CPU).

Dense batches and packed-row batches go through hello_tpu's
``MoEAttention.apply`` and the port's module with the same weights; the port
reduces both layouts through ``read_conv_reduce`` (its plain version on the
CPU).  fp32 on both sides: rtol 1e-4 / atol 1e-4 on the expert logits and
on the meta-expert's softmax.  The hybrid configs run with alleles that
have rows in one platform only, and with batches where platform 1 ships no
rows at all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn import moe as jax_moe
from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import archs, moe
from hello_tpu_torch.nn.convert import state_dict_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jax_layers.set_precision("highest")
    jm = jax_moe.create_model("illumina")
    params, state = jm.init(jax.random.PRNGKey(7))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = moe.create_model("illumina")
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    return jm, params, state, tm.eval()


def _site_layout(A, S):
    """Three real sites with 2/3/1 alleles, padding slots on the last site."""
    site_ids = np.full(A, S - 1, np.int32)
    site_ids[:6] = [0, 0, 1, 1, 1, 2]
    allele_mask = np.zeros(A, np.float32)
    allele_mask[:6] = 1.0
    ref_segments = np.zeros((S, 150, 5), np.float32)
    return site_ids, allele_mask, ref_segments


def _dense_batch(rng):
    A, R, S = 8, 8, 4
    site_ids, allele_mask, ref_segments = _site_layout(A, S)
    mask = (rng.rand(A, R) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    mask[3] = 0.0                    # a real allele with no reads
    mask[6:] = 0.0                   # padding slots
    return {
        "reads0": rng.randint(0, 255, (A, R, 150, 6)).astype(np.uint8),
        "read_mask0": mask,
        "site_ids": site_ids,
        "allele_mask": allele_mask,
        "ref_segments": ref_segments,
    }


def _packed_batch(rng):
    A, R, S = 8, 8, 4
    site_ids, allele_mask, ref_segments = _site_layout(A, S)
    counts = [3, 5, 2, 0, 4, 1]
    row_allele = np.concatenate([np.full(c, a, np.int32)
                                 for a, c in enumerate(counts)]
                                + [np.full(5, A, np.int32)])
    return {
        "rows0": rng.randint(0, 255, (len(row_allele), 150, 6)).astype(np.uint8),
        "row_allele0": row_allele,
        "row_valid0": (row_allele < A).astype(np.float32),
        "read_mask0": np.zeros((A, R), np.uint8),   # only its shape is read
        "site_ids": site_ids,
        "allele_mask": allele_mask,
        "ref_segments": ref_segments,
    }


@pytest.mark.parametrize("make_batch", [_dense_batch, _packed_batch],
                         ids=["dense", "packed"])
def test_experts_match_jax(models, rng, make_batch):
    jm, params, state, tm = models
    batch = make_batch(rng)
    want, _ = jm.apply(params, state,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["meta"] is None and want["meta"] is None
    np.testing.assert_allclose(got["experts"].numpy(),
                               np.asarray(want["experts"]),
                               rtol=1e-4, atol=1e-4)


def _reduction_cases(rng):
    frames = (rng.randn(7, 36, 64) * 5).astype(np.float32)
    row_allele = np.array([0, 0, 1, 2, 2, 3, 3], np.int32)
    row_valid = np.array([1, 1, 1, 0, 1, 0, 0], np.float32)
    grid = (rng.randn(3, 4, 36, 64) * 5).astype(np.float32)
    grid_mask = (rng.rand(3, 4) < 0.5).astype(np.float32)
    allele = (rng.randn(5, 18, 128)).astype(np.float32)
    site_ids = np.array([0, 0, 1, 2, 2], np.int32)
    allele_mask = np.array([1, 1, 1, 1, 0], np.float32)
    onehot = np.array(jax_moe.make_site_onehot(
        jnp.asarray(site_ids), jnp.asarray(allele_mask), 3))
    return {
        "packed_read_reduce": ((frames, row_allele, row_valid), 3),
        "masked_read_sum": ((grid, grid_mask), None),
        "site_segment_sum": ((allele, onehot), None),
        "make_site_onehot": ((site_ids, allele_mask), 3),
    }


@pytest.mark.parametrize("fn", ["packed_read_reduce", "masked_read_sum",
                                "site_segment_sum", "make_site_onehot"])
def test_reductions_match_jax(rng, fn):
    args, extra = _reduction_cases(rng)[fn]
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if extra is not None:
        jargs.append(extra)
        targs.append(extra)
    want = np.asarray(getattr(jax_moe, fn)(*jargs))
    got = getattr(moe, fn)(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _hybrid_config(name):
    """A named hybrid config, or "compressor2": both platforms' experts plus
    expert 2 on compressor2 over the summed read frames, and the meta-expert
    on its site features (the route no named config takes)."""
    if name != "compressor2":
        return archs.NAMED_CONFIGS[name]()
    config = archs.config_hybrid_full()
    del config["combiner0"], config["combiner1"]
    config["compressor2"] = archs.compressor_conv(True)
    return config


HYBRID_CONFIGS = ["hybrid", "hybrid_no_ensemble", "hybrid_ensemble2",
                  "compressor2"]


@pytest.fixture(scope="module", params=HYBRID_CONFIGS)
def hybrid_models(request):
    jax_layers.set_precision("highest")
    jm = jax_moe.create_model(_hybrid_config(request.param))
    params, state = jm.init(jax.random.PRNGKey(11))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = moe.create_model(_hybrid_config(request.param))
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    assert tm.hybrid and jm.hybrid
    return request.param, jm, params, state, tm.eval()


def _hybrid_batch(rng, layout, case):
    """Two platforms over the _site_layout slots.  "mixed": allele 1 has rows
    in platform 0 only, allele 2 in platform 1 only, allele 3 in neither;
    "p1_empty": platform 1 ships no rows (an all-zero mask; no packed rows
    at all)."""
    A, R, S = 8, 6, 4
    site_ids, allele_mask, _ = _site_layout(A, S)
    ref_segments = np.eye(5, dtype=np.float32)[rng.randint(0, 5, (S, 150))]
    counts0 = [3, 2, 0, 0, 4, 1]
    counts1 = [2, 0, 3, 0, 1, 2] if case == "mixed" else [0] * 6
    batch = {"site_ids": site_ids, "allele_mask": allele_mask,
             "ref_segments": ref_segments}
    for k, counts in ((0, counts0), (1, counts1)):
        if layout == "dense":
            mask = np.zeros((A, R), np.float32)
            for a, c in enumerate(counts):
                mask[a, :c] = 1.0
            batch[f"reads{k}"] = rng.randint(
                0, 255, (A, R, 150, 6)).astype(np.uint8)
            batch[f"read_mask{k}"] = mask
            continue
        n_pad = 3 if sum(counts) else 0
        row_allele = np.concatenate([np.full(c, a, np.int32)
                                     for a, c in enumerate(counts)]
                                    + [np.full(n_pad, A, np.int32)])
        batch[f"rows{k}"] = rng.randint(
            0, 255, (len(row_allele), 150, 6)).astype(np.uint8)
        batch[f"row_allele{k}"] = row_allele
        batch[f"row_valid{k}"] = (row_allele < A).astype(np.float32)
        batch[f"read_mask{k}"] = np.zeros((A, R), np.uint8)
    return batch


@pytest.mark.parametrize("case", ["mixed", "p1_empty"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_hybrid_experts_and_meta_match_jax(hybrid_models, rng, layout, case):
    name, jm, params, state, tm = hybrid_models
    batch = _hybrid_batch(rng, layout, case)
    want, _ = jm.apply(params, state,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    experts = {"hybrid_no_ensemble": 1}.get(name, 3)
    assert tuple(got["experts"].shape) == (8, experts)
    np.testing.assert_allclose(got["experts"].numpy(),
                               np.asarray(want["experts"]),
                               rtol=1e-4, atol=1e-4)
    if name == "hybrid_no_ensemble":
        assert got["meta"] is None and want["meta"] is None
        return
    assert tuple(got["meta"].shape) == (4, 3)
    np.testing.assert_allclose(got["meta"].numpy(), np.asarray(want["meta"]),
                               rtol=1e-4, atol=1e-4)
    if name == "hybrid_ensemble2":
        assert not got["experts"][:, 2].any()


def test_fold_read_convs_covers_both_platforms():
    tm = moe.create_model("hybrid")
    before = telemetry.counts()
    folded = tm.fold_read_convs()
    assert sorted(folded) == ["read_conv0", "read_conv1"]
    assert folded["read_conv0"] is not folded["read_conv1"]
    assert telemetry.counts() == before         # folding launches nothing


@pytest.mark.parametrize("name", ["illumina_wide", "illumina_addendum",
                                  "hybrid_no_ensemble_wide",
                                  "hybrid_no_ensemble_addendum",
                                  "illumina_layer_norm"])
def test_unported_configs_raise(rng, name):
    """The configs whose read convolver the kernel does not implement (they
    raised here before the layer route existed) now build, fold every read
    convolver to the layer route, and give hello_tpu's eval forward, dense
    and packed, within rtol 1e-4 / atol 1e-4; the kernel's plain version is
    never called for them."""
    jax_layers.set_precision("highest")
    jm = jax_moe.create_model(name)
    params, state = jm.init(jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    tm = moe.create_model(name)
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    tm.eval()
    folded = tm.fold_read_convs()
    assert all(isinstance(f, moe.LayerRoute) for f in folded.values())
    assert len(folded) == (2 if tm.hybrid else 1)
    for layout in ("dense", "packed"):
        batch = (_hybrid_batch(rng, layout, "mixed") if tm.hybrid else
                 (_dense_batch if layout == "dense" else _packed_batch)(rng))
        want, _ = jm.apply(params, state,
                           {k: jnp.asarray(v) for k, v in batch.items()})
        before = telemetry.counts()
        with torch.no_grad():
            got = tm({k: torch.from_numpy(v) for k, v in batch.items()},
                     folded=folded)
        calls = {k: n for k, n in (telemetry.counts() - before).items()
                 if k[0] == "read_conv"}
        assert calls == {("read_conv", f"read_conv{k}", "layers"): 1
                         for k in range(1 + tm.hybrid)}
        np.testing.assert_allclose(got["experts"].numpy(),
                                   np.asarray(want["experts"]),
                                   rtol=1e-4, atol=1e-4)
