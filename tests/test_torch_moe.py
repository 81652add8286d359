"""The port's MoEAttention forward against hello_tpu's (CPU).

Dense batches and packed-row batches go through hello_tpu's
``MoEAttention.apply`` and the port's module with the same weights; the port
reduces both layouts through ``read_conv_reduce`` (its plain version on the
CPU).  fp32 on both sides: rtol 1e-4 / atol 1e-4 on the expert logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn import moe as jax_moe
from hello_tpu_torch.nn import moe
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


@pytest.mark.parametrize("name", ["hybrid", "hybrid_no_ensemble",
                                  "illumina_layer_norm"])
def test_unported_configs_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.create_model(name)
