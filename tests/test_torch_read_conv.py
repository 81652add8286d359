"""The read-convolver kernel module of the port against hello_tpu (CPU).

On the CPU ``read_conv_reduce`` takes its plain PyTorch version
(``read_conv_reduce_reference``), which is what ``chip_smoke.py`` holds the
CUDA kernel against on the card.  Here the plain version is held against
hello_tpu's fused Pallas kernel (interpret mode, as tests/test_pallas_ops.py
runs it) and against hello_tpu's layers path + ``packed_read_reduce``, at
the tolerance hello_tpu holds its own kernel to: rtol 1e-4, atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn.moe import create_model as jax_create_model
from hello_tpu.nn.moe import packed_read_reduce as jax_packed_read_reduce
from hello_tpu.ops import read_conv as jax_rc
from hello_tpu_torch.nn.convert import state_dict_from_jax
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc

torch.set_num_threads(1)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        jax_rc.pl, "pallas_call",
        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


def _pair(name, seed):
    """(JAX model, params, port model) with the same weights."""
    jax_layers.set_precision("highest")
    jm = jax_create_model(name)
    params, state = jm.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = create_model(name)
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    return jm, params, tm


def _packed_rows(rng, A, counts, C, n_pad):
    """Packed rows as expand_compact_packed lays them out: real rows grouped
    by allele (counts[a] rows for allele a), then n_pad padding rows
    (row_allele == A, row_valid == 0)."""
    row_allele = np.concatenate([np.full(c, a, np.int32)
                                 for a, c in enumerate(counts)]
                                + [np.full(n_pad, A, np.int32)])
    nb = len(row_allele)
    rows = rng.randint(0, 255, (nb, 150, C)).astype(np.uint8)
    row_valid = (row_allele < A).astype(np.float32)
    return rows, row_allele, row_valid


def test_folded_weights_equal_extract():
    jm, params, tm = _pair("illumina", 0)
    want = jax_rc.extract_read_conv_weights(jm.nets["read_conv0"],
                                            params["read_conv0"])
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    got = [t for pair in folded.convs for t in pair]
    assert len(got) == len(want) == 36
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert folded.flat.numel() == rc.num_weight_floats(6)
    assert folded.in_channels == 6


def test_plain_matches_fused_pallas_kernel(interpret_pallas, rng):
    """Dense [A, R] grid flattened to rows, as the port's dense path passes
    it, against hello_tpu's fused Pallas kernel (interpret mode, lanes=8)."""
    jm, params, tm = _pair("illumina", 0)
    A, R = 4, 8
    reads = rng.randint(0, 255, (A, R, 150, 6)).astype(np.uint8)
    mask = (rng.rand(A, R) < 0.8).astype(np.float32)
    weights = jax_rc.extract_read_conv_weights(jm.nets["read_conv0"],
                                               params["read_conv0"])
    want = jax_rc.fused_read_convolver(jnp.asarray(reads), jnp.asarray(mask),
                                       weights, lanes=8)
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    got = rc.read_conv_reduce(
        torch.from_numpy(reads.reshape(A * R, 150, 6)),
        torch.arange(A * R, dtype=torch.int32) // R,
        torch.from_numpy(mask.reshape(-1)), folded, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name,C", [("illumina", 6), ("pacbio_hp", 7)])
def test_plain_matches_layers_packed_reduce(rng, name, C):
    """Packed rows with padding rows, against hello_tpu's read_conv0.apply +
    packed_read_reduce (C = 7 is the pacbio_hp read convolver)."""
    jm, params, tm = _pair(name, 1)
    A = 5
    rows, row_allele, row_valid = _packed_rows(rng, A, [3, 1, 4, 2, 2], C,
                                               n_pad=4)
    frames, _ = jm.nets["read_conv0"].apply(params["read_conv0"], {},
                                            jnp.asarray(rows, jnp.float32))
    want = jax_packed_read_reduce(frames, jnp.asarray(row_allele),
                                  jnp.asarray(row_valid), A)
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    assert folded.in_channels == C
    got = rc.read_conv_reduce(torch.from_numpy(rows),
                              torch.from_numpy(row_allele),
                              torch.from_numpy(row_valid), folded, A)
    assert got.shape == (A, 36, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def test_fully_masked_alleles_are_exactly_zero(rng):
    """An allele whose rows are all masked, and one with no rows at all,
    reduce to exactly 0 (an odd A, with padding rows)."""
    _, _, tm = _pair("illumina", 2)
    A = 3
    rows, row_allele, row_valid = _packed_rows(rng, A, [2, 3, 0], 6, n_pad=3)
    row_valid[row_allele == 1] = 0.0
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    got = rc.read_conv_reduce(torch.from_numpy(rows),
                              torch.from_numpy(row_allele),
                              torch.from_numpy(row_valid), folded, A)
    assert torch.count_nonzero(got[1]) == 0
    assert torch.count_nonzero(got[2]) == 0
    assert torch.count_nonzero(got[0]) > 0


def _padded_stem_config():
    """illumina with the first conv padded: the same weight shapes, other
    math."""
    from hello_tpu_torch.nn import archs

    config = archs.config_single_tech()
    config["read_conv0"][0]["kwargs"]["padding"] = 1
    return config


@pytest.mark.parametrize("name", ["illumina_wide", "illumina_addendum",
                                  "padded_stem"])
def test_topology_gate_raises(name):
    """A read convolver the kernel does not implement is refused, not
    routed around the kernel."""
    tm = create_model(_padded_stem_config() if name == "padded_stem" else name)
    with pytest.raises(ValueError):
        rc.fold_read_conv_weights(tm.read_convolver0)
    with pytest.raises(ValueError):
        tm.fold_read_convs()


def test_cpu_tensors_take_the_plain_version(rng):
    """CPU tensors go to the plain version: no launch is counted."""
    _, _, tm = _pair("illumina", 3)
    rows, row_allele, row_valid = _packed_rows(rng, 2, [1, 1], 6, n_pad=1)
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    before = rc.read_conv_reduce.launches
    got = rc.read_conv_reduce(torch.from_numpy(rows),
                              torch.from_numpy(row_allele),
                              torch.from_numpy(row_valid), folded, 2)
    want = rc.read_conv_reduce_reference(torch.from_numpy(rows),
                                         torch.from_numpy(row_allele),
                                         torch.from_numpy(row_valid),
                                         folded, 2)
    assert rc.read_conv_reduce.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rows_dtype", "channels", "allele_dtype",
                                 "valid_shape", "noncontiguous",
                                 "weights_channels", "no_alleles"])
def test_kernel_argument_checks_raise(rng, bad):
    """What the CUDA kernel does not take is refused before a launch (the
    checks are device-independent, so they run here on CPU tensors)."""
    _, _, tm = _pair("illumina", 4)
    folded = rc.fold_read_conv_weights(tm.read_convolver0)
    rows, row_allele, row_valid = (torch.from_numpy(a) for a in
                                   _packed_rows(rng, 2, [2, 2], 6, n_pad=0))
    args = dict(rows=rows, row_allele=row_allele, row_valid=row_valid,
                folded=folded, num_alleles=2)
    rc._check_cuda_args(**args)                  # the good case passes
    if bad == "rows_dtype":
        args["rows"] = rows.float()
    elif bad == "channels":
        args["rows"] = rows[..., :5].contiguous()
    elif bad == "allele_dtype":
        args["row_allele"] = row_allele.long()
    elif bad == "valid_shape":
        args["row_valid"] = row_valid[:-1]
    elif bad == "noncontiguous":
        args["rows"] = rows.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "weights_channels":
        _, _, hp = _pair("pacbio_hp", 4)
        args["folded"] = rc.fold_read_conv_weights(hp.read_convolver0)
    else:
        args["num_alleles"] = 0
    with pytest.raises((TypeError, ValueError)):
        rc._check_cuda_args(**args)
