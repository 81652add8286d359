"""The layers only hello_tpu built before, each against hello_tpu's (CPU).

Every layer type that only hello_tpu built before (the norms, the other
activations, Dropout, the pools, AdditiveLayer, DotProduct, Inception,
MultiheadAttention, HelloEncoder and positional_encoding) runs in hello_tpu
(``Layer.apply``) and in the port (its module, loaded through the weight
bridge) on the same numpy inputs made from a seed, with hello_tpu's params
(redrawn where its init is constant, so the bridge's mapping shows):

  * fp32: rtol 1e-5, plus an atol of 1e-5 of the output's largest value
    (summation order);
  * bf16 activations: the output's dtype as hello_tpu's, and every value
    within two bf16 ulps of hello_tpu's (the existing layer tests' budget);
  * train-mode BatchNorm with and without a row mask: the output and the
    new running statistics;
  * Dropout given hello_tpu's keep mask, read off its output on an
    all-nonzero input;
  * the whole illumina_layer_norm and illumina_wide networks at bf16 layer
    by layer, each layer fed hello_tpu's own input (as
    tests/test_torch_precision.py checks the standard configs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.nn import layers as jl
from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn.convert import (_export_sequential, _import_sequential,
                                        init_params)

import test_torch_moe as moe_cases
from test_torch_precision import _leaves, _to_torch, jax_at, pair

torch.set_num_threads(1)

BF16_ULPS = 2.0 ** -6         # two bf16 ulps, relative


@pytest.fixture(autouse=True)
def restore_precision():
    yield
    layers.set_precision("highest")
    jl.set_precision("highest")
    jl.set_bn_batch_mask(None)


def _redraw(tree, rng):
    """Every leaf redrawn from N(0, 1) (variances from U(0.5, 1.5))."""
    def leaf(path, x):
        x = np.asarray(x)
        if path and getattr(path[-1], "key", None) == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.randn(*x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _build(spec, in_shape, rng):
    """(hello_tpu layer, params, state, port Sequential of the one layer)
    with the same random params and state."""
    jlayer = jl.build_layer(spec)
    params, state, _ = jlayer.init(jax.random.PRNGKey(0), in_shape)
    params, state = _redraw(params, rng), _redraw(state, rng)
    seq = layers.build_network([spec])
    sd = {}
    _export_sequential(seq, {"0": params} if params else {},
                       {"0": state} if state else {}, "network.", sd)
    seq.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return jlayer, params, state, seq


def _x(rng, shape, dtype=np.float32):
    return (rng.randn(*shape) * 2).astype(dtype)


def _close32(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _close_bf16(got, want, what=""):
    """Same dtype as hello_tpu's, every value within two bf16 ulps."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.detach().float().numpy()
    want_bf16 = jnp.asarray(want).dtype == jnp.bfloat16
    assert (got.dtype == torch.bfloat16) == want_bf16, what
    assert g.shape == w.shape, what
    assert (np.abs(g - w) <= BF16_ULPS * np.abs(w) + 1e-30).all(), (
        what, float(np.abs(g - w).max()))


SPECS = {
    "ELU": ({"type": "ELU", "kwargs": {"alpha": 0.7}}, (9, 16)),
    "SELU": ({"type": "SELU", "kwargs": {}}, (9, 16)),
    "Sigmoid": ({"type": "Sigmoid", "kwargs": {}}, (9, 16)),
    "Softplus": ({"type": "Softplus", "kwargs": {}}, (9, 16)),
    "Softplus_beta": ({"type": "Softplus",
                       "kwargs": {"beta": 2.0, "threshold": 3.0}}, (9, 16)),
    "Tanh": ({"type": "Tanh", "kwargs": {}}, (9, 16)),
    "Softmax": ({"type": "Softmax", "kwargs": {"dim": -1}}, (9, 16)),
    "Softmax_dim1": ({"type": "Softmax", "kwargs": {"dim": 1}}, (9, 16)),
    "AvgPool1d": ({"type": "AvgPool1d",
                   "kwargs": {"kernel_size": 3, "stride": 2, "padding": 1}},
                  (9, 16)),
    "GlobalPool": ({"type": "GlobalPool", "kwargs": {}}, (9, 16)),
    "LayerNormModule": ({"type": "LayerNormModule",
                         "kwargs": {"num_features": 16}}, (9, 16)),
    "BatchNorm1d": ({"type": "BatchNorm1d", "kwargs": {"num_features": 16}},
                    (9, 16)),
    "BatchNorm1d_2d": ({"type": "BatchNorm1d",
                        "kwargs": {"num_features": 16}}, (16,)),
    "Inception": ({"type": "Inception", "kwargs": {"branches": [
        [{"type": "Conv1d", "kwargs": {"in_channels": 16, "out_channels": 4,
                                       "kernel_size": 3, "padding": 1}},
         {"type": "ReLU", "kwargs": {}}],
        [{"type": "Conv1d", "kwargs": {"in_channels": 16, "out_channels": 3,
                                       "kernel_size": 1}}],
        [{"type": "BatchNorm1d", "kwargs": {"num_features": 16}}]]}},
        (9, 16)),
    "MultiheadAttention": ({"type": "MultiheadAttention", "kwargs": {
        "head_dim": 4, "n_heads": 4, "embedding_dim": 16,
        "add_positional": True}}, (9, 16)),
    "MultiheadAttention_nopos": ({"type": "MultiheadAttention", "kwargs": {
        "head_dim": 8, "n_heads": 2, "embedding_dim": 16}}, (9, 16)),
    "HelloEncoder": ({"type": "HelloEncoder", "kwargs": {
        "n_layers": 2, "n_heads": 4, "input_dim": 6, "embedding_dim": 16}},
        (20, 6)),
}
PAIRED = {"AdditiveLayer": ({"type": "AdditiveLayer", "kwargs": {}}, (9, 16)),
          "DotProduct": ({"type": "DotProduct", "kwargs": {}}, (16,))}


def _inputs(name, shape, rng, dtype=np.float32):
    if name in PAIRED:
        return (_x(rng, (4,) + shape, dtype), _x(rng, (4,) + shape, dtype))
    x = _x(rng, (4,) + shape, dtype)
    if name.startswith("Softplus"):
        x[0, 0, :4] = [25.0, 21.0, 2.9, 3.1]      # around both thresholds
    return x


@pytest.mark.parametrize("name", sorted(SPECS) + sorted(PAIRED))
def test_layer_matches_hello_tpu_fp32(rng, name):
    spec, shape = {**SPECS, **PAIRED}[name]
    in_shape = (shape, shape) if name in PAIRED else shape
    jlayer, params, state, seq = _build(spec, in_shape, rng)
    x = _inputs(name, shape, rng)
    want, _ = jlayer.apply(params, state, x)
    with torch.no_grad():
        got = seq.eval()(_to_torch(x))
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    _close32(got, want)


@pytest.mark.parametrize("name", [
    "ELU", "SELU", "Sigmoid", "Softplus", "Softplus_beta", "Tanh",
    "Softmax", "AvgPool1d", "GlobalPool", "LayerNormModule", "BatchNorm1d",
    "BatchNorm1d_2d", "AdditiveLayer", "DotProduct"])
def test_layer_matches_hello_tpu_bf16(rng, name):
    """bf16 activations in, hello_tpu's dtype out, within two bf16 ulps."""
    spec, shape = {**SPECS, **PAIRED}[name]
    in_shape = (shape, shape) if name in PAIRED else shape
    jlayer, params, state, seq = _build(spec, in_shape, rng)
    x = _inputs(name, shape, rng)
    xb = (tuple(jnp.asarray(t, jnp.bfloat16) for t in x)
          if isinstance(x, tuple) else jnp.asarray(x, jnp.bfloat16))
    want = jax_at("bf16", lambda: jlayer.apply(params, state, xb)[0])
    layers.set_precision("bf16")
    with torch.no_grad():
        got = seq.eval()(_to_torch(xb))
    _close_bf16(got, want, name)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["BatchNorm1d", "BatchNorm1d_2d"])
def test_batchnorm_train_mode_matches_hello_tpu(rng, name, masked):
    """Train-mode BatchNorm: the output from the (masked) batch statistics
    and the new running mean and variance (the unbiased variance, momentum
    0.1); padded rows carry large values, which only the mask keeps out."""
    spec, shape = SPECS[name]
    jlayer, params, state, seq = _build(spec, shape, rng)
    x = _inputs(name, shape, rng)
    mask = None
    if masked:
        mask = np.array([1, 0, 1, 1], np.float32)
        x[1] = 1e3
    jl.set_bn_batch_mask(None if mask is None else jnp.asarray(mask))
    want, new_state = jlayer.apply(params, state, x, train=True)
    jl.set_bn_batch_mask(None)
    with layers.bn_batch_mask(None if mask is None
                              else torch.from_numpy(mask)):
        got = seq.train()(torch.from_numpy(x))
    _close32(got, want)
    bn = seq.network[0]
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(new_state[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert int(bn.num_batches_tracked) == 1
    if masked:
        # the padded row moved nothing: the same batch without it agrees
        keep = mask.astype(bool)
        bn2 = _build(spec, shape, np.random.RandomState(0))[3]
        bn2.load_state_dict(seq.state_dict())
        with torch.no_grad():
            bn2.network[0].running_mean.copy_(torch.from_numpy(
                np.asarray(state["mean"])))
            bn2.network[0].running_var.copy_(torch.from_numpy(
                np.asarray(state["var"])))
        got2 = bn2.train()(torch.from_numpy(x[keep]))
        np.testing.assert_allclose(got2.detach().numpy(),
                                   got.detach().numpy()[keep], rtol=1e-5,
                                   atol=1e-5)


def test_bn_batch_mask_is_scoped():
    """The mask holds inside its block only, and nested blocks restore the
    outer mask."""
    bn = layers.BatchNorm1d(3).train()
    x = torch.randn(4, 3)
    outer, inner = torch.tensor([1., 1., 0., 0.]), torch.tensor([1., 0., 1., 0.])
    with layers.bn_batch_mask(outer):
        with layers.bn_batch_mask(inner):
            assert layers._BN_MASK.mask is inner
        assert layers._BN_MASK.mask is outer
        a = bn._batch_stats(x)[0]
    assert layers._BN_MASK.mask is None
    torch.testing.assert_close(a, x[:2].mean(0))
    torch.testing.assert_close(bn._batch_stats(x)[0], x.mean(0))


def test_dropout_with_hello_tpu_keep_mask(rng):
    """hello_tpu's train-mode Dropout on an all-nonzero input: its keep mask
    is where the output is nonzero, and the port applies that mask to the
    same values exactly; eval mode is the identity; the port's own mask
    comes from its generator, reproducibly, at the expected rate."""
    x = (np.abs(rng.randn(8, 30, 16)) + 0.5).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dtype)
        want, _ = jl.Dropout(0.3).apply({}, {}, xj, train=True,
                                        rng=jax.random.PRNGKey(4))
        keep = np.asarray(want != 0)
        assert 0.6 < keep.mean() < 0.8
        got = layers.dropout_with_mask(_to_torch(xj), torch.from_numpy(keep),
                                       0.3)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    drops = [layers.Dropout(0.3, generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    t = torch.from_numpy(x)
    a, b = (d.train()(t) for d in drops)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.6 < (a != 0).float().mean() < 0.8
    torch.testing.assert_close(a[a != 0], t[a != 0] / 0.7)
    assert drops[0].eval()(t) is t


def test_positional_encoding_matches_hello_tpu():
    np.testing.assert_allclose(layers.positional_encoding(20, 32).numpy(),
                               np.asarray(jl.positional_encoding(20, 32)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["MultiheadAttention", "HelloEncoder",
                                  "Inception", "BatchNorm1d",
                                  "LayerNormModule"])
def test_bridge_round_trip(rng, name):
    """The port's keys carry hello_tpu's params and state both ways:
    state dict -> (params, state) gives back the trees it came from."""
    spec, shape = SPECS[name]
    _, params, state, seq = _build(spec, shape, rng)
    got_p, got_s = _import_sequential(seq, seq.state_dict(), "network.")
    want_p = {"0": params}
    want_s = {"0": state} if state else {}
    assert (jax.tree_util.tree_structure(got_p)
            == jax.tree_util.tree_structure(want_p))
    assert (jax.tree_util.tree_structure(got_s)
            == jax.tree_util.tree_structure(want_s))
    for a, b in zip(jax.tree_util.tree_leaves(got_p),
                    jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_init_params_initialises_every_new_layer():
    """Norms at gamma 1 / beta 0, batch-norm statistics at 0 / 1 with no
    update, attention matrices within hello_tpu's kaiming bound, and the
    same draw for the same seed."""
    def build():
        return layers.build_network([
            SPECS["HelloEncoder"][0],
            {"type": "BatchNorm1d", "kwargs": {"num_features": 16}},
            {"type": "LayerNormModule", "kwargs": {"num_features": 16}}])
    a = init_params(build(), torch.Generator().manual_seed(3))
    b = init_params(build(), torch.Generator().manual_seed(3))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    enc, bn, ln = a.network
    bound = 1.0 / np.sqrt(16)
    for block in enc.attention:
        for w in (block.W_q, block.W_k, block.W_v, block.W_o):
            assert 0 < w.abs().max() <= bound
        assert (block.layer_norm_attn.weight == 1).all()
    assert enc.embedding.weight.abs().max() <= 1.0 / np.sqrt(6)
    assert (bn.weight == 1).all() and (bn.bias == 0).all()
    assert (bn.running_mean == 0).all() and (bn.running_var == 1).all()
    assert int(bn.num_batches_tracked) == 0
    assert (ln.normer.weight == 1).all() and (ln.normer.bias == 0).all()


def _record_inputs(jm, params, state, batch):
    """hello_tpu's input to each network in a whole bf16 forward."""
    inputs = {}
    apply_net = jm._apply_net

    def record(name, p, s, x, *args, **kwargs):
        inputs.setdefault(name, x)
        return apply_net(name, p, s, x, *args, **kwargs)

    jm._apply_net = record
    try:
        jax_at("bf16", lambda: jm.apply(params, state, batch))
    finally:
        del jm._apply_net
    return inputs


@pytest.mark.parametrize("config", ["illumina_layer_norm", "illumina_wide"])
def test_bf16_networks_layer_by_layer(config):
    """Each layer of each network of the config, fed hello_tpu's own bf16
    input to it, gives hello_tpu's output: bf16 where hello_tpu's is bf16,
    equal but for at most 0.2% of the values, each within two bf16 ulps of
    the layer's largest value; fp32 outputs within rtol / atol 1e-4
    (tests/test_torch_precision.py's bar for the standard configs)."""
    jm, params, state, tm = pair(config, 7)
    batch = {k: jnp.asarray(v) for k, v in
             moe_cases._packed_batch(np.random.RandomState(8)).items()}
    inputs = _record_inputs(jm, params, state, batch)
    assert set(inputs) == {"read_conv0", "compressor0", "xattn0"}
    jl.set_precision("bf16")
    layers.set_precision("bf16")
    for name, x in inputs.items():
        p, s = params.get(name, {}), state.get(name, {})
        for i, (jax_layer, port_layer) in enumerate(
                zip(jm.nets[name].layers, tm.net(name).network, strict=True)):
            y, _ = jax_layer.apply(p.get(str(i), {}), s.get(str(i), {}), x)
            with torch.no_grad():
                t = port_layer(_to_torch(x))
            what = f"{config} {name} layer {i} ({type(jax_layer).__name__})"
            for want, got in zip(_leaves(y), _leaves(t), strict=True):
                w = np.asarray(want, np.float32)
                g = got.float().numpy()
                assert g.shape == w.shape, what
                if want.dtype != jnp.bfloat16:
                    assert got.dtype == torch.float32, what
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                               err_msg=what)
                    continue
                assert got.dtype == torch.bfloat16, what
                # XLA on the CPU flushes subnormal results to zero (Softplus
                # far below 0 gives ~1e-40), torch keeps them
                g = np.where(np.abs(g) < np.finfo(np.float32).tiny, 0.0, g)
                differ = g != w
                assert differ.sum() <= 0.002 * w.size, (what, differ.sum())
                assert np.abs(g - w).max() <= BF16_ULPS * np.abs(w).max(), what
            x = y
