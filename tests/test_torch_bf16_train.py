"""bf16 training in the port against hello_tpu's (CPU).

The soak trains its gate checkpoint at ``bf16``, the calling CLI's
precision.  hello_tpu's training step is one jitted function, so its bf16
semantics are XLA's on the CPU:

  * a training conv rounds its fp32 sum to bf16, then adds the bias rounded
    to bf16 in bf16 (its output is bf16; the eval conv adds the fp32 bias
    first and rounds once);
  * the transpose of each cast of an fp32 value to bf16 (a conv's weight,
    an fp32 input) would round the gradient to bf16 and back; XLA drops
    that round trip, so those gradients stay fp32 sums;
  * a bf16 gradient (a bf16 activation's) is rounded once from its fp32
    sum, and Softplus's derivative is JAX's ``exp(x - softplus(x))``, each
    step rounded to bf16;
  * a bias gradient is the sum of a bf16 cotangent, a bf16 reduction,
    which XLA on the CPU accumulates in bf16 (each partial sum rounded): it
    lands 2% to 4% of the largest entry away from the once-rounded fp32
    sum.  The port sums in fp32 and rounds once, on the CPU and the card.

Per layer (each layer type the ``illumina``, ``hybrid`` and
``illumina_layer_norm`` configs build, at its shape in the config, a
seeded input and a seeded cotangent): ``jax.vjp`` of hello_tpu's
``apply(train=True)`` under ``jax.jit`` against the port layer's autograd
in train mode.  Every gradient must equal hello_tpu's but for at most 0.2%
of the values (bf16 values exactly, fp32 values within fp32 summation
noise), each within two bf16 ulps of the gradient's largest entry (the
forward's per-layer bar, tests/test_torch_precision.py).  A conv's bias
gradient is held at that bar to the once-rounded fp32 sum of hello_tpu's
own cotangent at the conv's output, and hello_tpu's bias gradient to that
sum within its bf16 accumulation.

The whole step (tests/test_torch_trainer.py's ``reference`` batch,
full-width ``illumina``, hello_tpu's seed-3 init): the loss within 2x
hello_tpu's own bf16-against-highest loss distance, and the median over
leaves of max |diff| / leaf max within 0.75x hello_tpu's own.  A port that
computed the step at highest would read 1x on both: the loss bar passes it
(one scalar carries the whole chaos of the sums), the median-leaf bar does
not, so that bar and the per-layer cases hold the bf16 rounding.  Measured
on the CPU: loss 5.0e-5 relative against hello_tpu's 1.5e-4 (the tree
before the port's bf16 training rounded as above: 2.3e-4), median leaf
distance 0.040 against 0.090, 0.44x (before: 0.097, 1.08x).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.nn import layers as jl
from hello_tpu.nn import moe as jax_moe
from hello_tpu.parallel.mesh import data_mesh
from hello_tpu.train import trainer as jax_trainer
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import _export_sequential, state_dict_from_jax
from hello_tpu_torch.train.trainer import TrainConfig, Trainer

from test_torch_precision import _leaves, _to_torch, batch_for, pair
from test_torch_trainer import reference  # noqa: F401  (fixture)

torch.set_num_threads(1)

BF16_ULPS = 2.0 ** -6         # two bf16 ulps, relative
N = 16                        # batch rows of a layer case


@pytest.fixture(autouse=True)
def restore_precision():
    yield
    layers.set_precision("highest")
    jl.set_precision("highest")
    jl.set_bn_batch_mask(None)


# (config, network, layer index): every layer type of the three configs,
# at its place in the network
CASES = [
    ("illumina", "read_conv0", 0),        # WeightNormedConv1d, fp32 input
    ("illumina", "read_conv0", 1),        # ReLU
    ("illumina", "read_conv0", 4),        # WeightNormedConv1d 16 -> 32
    ("illumina", "read_conv0", 6),        # MaxPool1d
    ("illumina", "read_conv0", 7),        # ResidualBlock, identity shortcut
    ("illumina", "read_conv0", 10),       # ResidualBlock, stride 2, 1x1 conv
    ("illumina", "compressor0", 0),       # WeightNormedConv1d, fp32 input
    ("illumina", "compressor0", 2),       # ResidualBlock
    ("illumina", "xattn0", 0),            # Fork
    ("illumina", "xattn0", 1),            # LinearCombination
    ("illumina", "xattn0", 4),            # ResidualBlock 128 -> 256
    ("illumina", "xattn0", 7),            # AdaptiveAvgPool1d
    ("illumina", "xattn0", 8),            # Flatten
    ("illumina", "xattn0", 9),            # Noop
    ("illumina", "xattn0", 10),           # WeightNormedLinear
    ("hybrid", "combiner0", 0),           # ConcatenateChannels
    ("hybrid", "meta", 0),                # SelectArgument
    ("illumina_layer_norm", "read_conv0", 0),   # Conv1d, fp32 input
    ("illumina_layer_norm", "read_conv0", 2),   # Softplus
    ("illumina_layer_norm", "read_conv0", 10),  # ResidualBlock (Conv1d)
    ("illumina_layer_norm", "xattn0", 11),      # Linear
]


def _layer_inputs(config, name):
    """hello_tpu's model and its input to each layer of network ``name`` in
    a whole bf16 train-mode forward (the structure, shapes and dtypes the
    seeded inputs take)."""
    jm, params, state, _ = pair(config, 7)
    batch = {k: jnp.asarray(v) for k, v in batch_for(
        config, "packed", np.random.RandomState(8)).items()}
    seen = {}
    apply_net = jm._apply_net

    def record(net, p, s, x, *args, **kwargs):
        seen.setdefault(net, x)
        return apply_net(net, p, s, x, *args, **kwargs)

    jm._apply_net = record
    jl.set_precision("bf16")
    try:
        jm.apply(params, state, batch, train=True,
                 rng=jax.random.PRNGKey(0))
        p, s, x = params.get(name, {}), state.get(name, {}), seen[name]
        inputs = []
        for i, layer in enumerate(jm.nets[name].layers):
            inputs.append(x)
            x, _ = layer.apply(p.get(str(i), {}), s.get(str(i), {}), x,
                               train=True, rng=jax.random.PRNGKey(i))
    finally:
        del jm._apply_net
        jl.set_precision("highest")
    return jm, params, state, inputs


def _seeded_like(x, rng):
    """A seeded N(0, 1) input of ``x``'s structure, shapes and dtypes, its
    batch axis cut to ``N`` rows."""
    if isinstance(x, (tuple, list)):
        return type(x)(_seeded_like(v, rng) for v in x)
    if x is None:
        return None
    shape = (min(N, x.shape[0]),) + tuple(x.shape[1:])
    return jnp.asarray(rng.randn(*shape).astype(np.float32), x.dtype)


def _unreduced_biases(layer, params, rows, shape):
    """``params`` with every conv bias broadcast to the conv's output shape
    ``[rows, L, C]``: the gradient of such a bias is hello_tpu's own
    cotangent at the conv's output, before the reduction over rows and
    positions.  ``shape`` is the layer's per-row input shape."""
    key = jax.random.PRNGKey(0)
    if isinstance(layer, jl.Sequential):
        out = {}
        for i, sub in enumerate(layer.layers):
            if str(i) in params:
                out[str(i)] = _unreduced_biases(sub, params[str(i)], rows,
                                                shape)
            shape = sub.init(key, shape)[2]
        return out
    if isinstance(layer, jl.ResidualBlock):
        return {"ff": _unreduced_biases(layer.ff, params["ff"], rows, shape),
                "sh": _unreduced_biases(layer.sh, params["sh"], rows, shape)}
    if isinstance(layer, jl.Conv1d) and "b" in params:
        out_shape = tuple(layer.init(key, shape)[2])
        return {**params, "b": jnp.broadcast_to(params["b"],
                                                (rows,) + out_shape)}
    return params


def _held(got, want, what):
    """Equal but for at most 0.2% of the values (bf16 values exactly, fp32
    values within fp32 summation noise), each within two bf16 ulps of the
    largest entry."""
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    g = got.detach().float().numpy().astype(np.float64)
    assert g.shape == w.shape, what
    scale = np.abs(w).max()
    if jnp.asarray(want).dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16, what
        differ = g != w
    else:
        assert got.dtype == torch.float32, what
        differ = np.abs(g - w) > 1e-4 * np.abs(w) + 1e-5 * scale
    assert differ.sum() <= 0.002 * w.size, (what, int(differ.sum()), w.size)
    assert np.abs(g - w).max() <= BF16_ULPS * scale, (
        what, float(np.abs(g - w).max() / max(scale, 1e-30)))


def _bf16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def _port_layer(config, name, index, params, state):
    """The port's layer ``index`` of network ``name`` as a one-layer
    Sequential holding hello_tpu's parameters and state."""
    seq = layers.Sequential([moe.create_model(config).net(name)
                             .network[index]])
    sd = {}
    _export_sequential(seq, {"0": params} if params else {},
                       {"0": state} if state else {}, "network.", sd)
    seq.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return seq.train()


@pytest.mark.parametrize("config,name,index", CASES,
                         ids=[f"{c}-{n}-{i}" for c, n, i in CASES])
def test_layer_backward_rounds_where_hello_tpu_rounds(config, name, index):
    jm, params, state, inputs = _layer_inputs(config, name)
    jlayer = jm.nets[name].layers[index]
    p = params.get(name, {}).get(str(index), {})
    s = state.get(name, {}).get(str(index), {})
    rng = np.random.RandomState(index)
    x = _seeded_like(inputs[index], rng)
    first = _leaves(x)[0]

    def f(pp, xx):
        return jlayer.apply(pp, s, xx, train=True,
                            rng=jax.random.PRNGKey(0))[0]

    jl.set_precision("bf16")
    try:
        y = jax.jit(f)(p, x)
        cts = [rng.randn(*o.shape).astype(np.float32) for o in _leaves(y)]
        ct = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(y),
            [jnp.asarray(c, o.dtype) for c, o in zip(cts, _leaves(y))])
        step = jax.jit(lambda pp, xx, c: jax.vjp(f, pp, xx)[1](c))
        gp, gx = step(p, x, ct)
        gp_rows, _ = step(_unreduced_biases(jlayer, p, first.shape[0],
                                            first.shape[1:]), x, ct)
    finally:
        jl.set_precision("highest")

    seq = _port_layer(config, name, index, p, s)
    cots = {}      # the port's cotangent at each conv's output

    def keep(module_name):
        def hook(module, args, out):
            out.register_hook(lambda g: cots.__setitem__(module_name, g))
        return hook

    for module_name, module in seq.named_modules():
        if isinstance(module, layers._ConvBase):
            module.register_forward_hook(keep(module_name))
    layers.set_precision("bf16")
    xt = _to_torch(x)
    for leaf in _leaves(xt):
        leaf.requires_grad_(True)
    yt = seq(xt)
    torch.autograd.backward(_leaves(yt), [
        torch.from_numpy(c).to(o.dtype) for c, o in zip(cts, _leaves(yt))])

    what = f"{config} {name} layer {index} ({type(jlayer).__name__})"
    for want, got in zip(_leaves(y), _leaves(yt), strict=True):
        _held(got, want, f"{what} output")
    for i, (want, leaf) in enumerate(zip(_leaves(gx), _leaves(xt),
                                         strict=True)):
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        _held(grad, want, f"{what} input {i} gradient")
    want_sd, rows_sd = {}, {}
    _export_sequential(seq, {"0": gp} if gp else {}, {}, "network.", want_sd)
    _export_sequential(seq, {"0": gp_rows} if gp else {}, {}, "network.",
                       rows_sd)
    for key, param in seq.named_parameters():
        conv = _conv_of_bias(seq, key)
        if conv is None:
            _held(param.grad, want_sd[key], f"{what} {key}")
            continue
        # the reduction's input: the port's cotangent at the conv's output
        # against hello_tpu's, at the bar
        rows = np.asarray(rows_sd[key], np.float32)
        _held(cots[conv], _bf16(rows), f"{what} {key} cotangent")
        # the port's bias gradient: that cotangent's fp32 sum, rounded once
        mine = cots[conv].double().sum((0, 1))
        assert torch.equal(param.grad, mine.to(torch.bfloat16).float()), key
        # hello_tpu's: its cotangent's sum accumulated in bf16
        own = np.asarray(want_sd[key], np.float32)
        once = np.asarray(_bf16(rows.astype(np.float64).sum((0, 1))),
                          np.float32)
        assert (own == np.asarray(_bf16(own), np.float32)).all(), key
        spread = np.abs(own - once).max()
        assert spread <= 2.0 ** -4 * np.abs(once).max(), (key, spread)


def _conv_of_bias(seq, key):
    """The name of the conv module whose bias ``key`` is, or None."""
    if not key.endswith(".bias"):
        return None
    owner = key[:-len(".bias")]
    if isinstance(seq.get_submodule(owner), layers._WeightNorm):
        owner = owner[:-len(".conv1d")]
    return owner if isinstance(seq.get_submodule(owner),
                               layers._ConvBase) else None


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_bf16_train_forward(masked):
    """The xattn terminus of ``illumina_layer_norm`` in train mode at bf16:
    the output equals hello_tpu's jitted one (a bf16 batch variance plus
    eps rounds to bf16 and its rsqrt stays fp32, where torch's bf16 rsqrt
    rounds twice on the CPU)."""
    jm, params, state, inputs = _layer_inputs("illumina_layer_norm", "xattn0")
    jlayer = jm.nets["xattn0"].layers[10]
    assert isinstance(jlayer, jl.BatchNorm1d)
    p, s = params["xattn0"]["10"], state["xattn0"]["10"]
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(64, 256).astype(np.float32) * 3 + 1,
                    jnp.bfloat16)
    mask = (rng.rand(64) < 0.7).astype(np.float32) if masked else None
    jl.set_precision("bf16")
    jl.set_bn_batch_mask(None if mask is None else jnp.asarray(mask))
    try:
        want = jax.jit(lambda xx: jlayer.apply(p, s, xx, train=True)[0])(x)
    finally:
        jl.set_bn_batch_mask(None)
        jl.set_precision("highest")
    seq = _port_layer("illumina_layer_norm", "xattn0", 10, p, s)
    layers.set_precision("bf16")
    with layers.bn_batch_mask(None if mask is None
                              else torch.from_numpy(mask)):
        got = seq(_to_torch(x))
    _held(got, want, "BatchNorm1d train bf16")


def _step(params, state, stacked, precision):
    jl.set_precision(precision)
    try:
        jt = jax_trainer.Trainer(jax_moe.create_model("illumina"),
                                 jax_trainer.TrainConfig(binary=True),
                                 mesh=data_mesh(1), params=params,
                                 state=state)
        return jt.compute_grads(stacked)
    finally:
        jl.set_precision("highest")


def test_bf16_step_matches_hello_tpu(reference):  # noqa: F811
    stacked, _, params = reference
    tm = moe.create_model("illumina")

    def as_sd(tree):
        return {k: v.numpy() for k, v in state_dict_from_jax(
            tm, jax.tree_util.tree_map(np.asarray, tree), {}).items()}

    loss_hi, grads_hi = _step(params, {}, stacked, "highest")
    loss_bf, grads_bf = _step(params, {}, stacked, "bf16")
    layers.set_precision("bf16")
    tt = Trainer(tm, TrainConfig(binary=True), device="cpu",
                 params=state_dict_from_jax(tm, params, {}))
    loss, grads = tt.compute_grads(stacked)
    assert abs(loss - loss_bf) <= max(2 * abs(loss_bf - loss_hi),
                                      1e-4 * abs(loss_bf)), (loss, loss_bf,
                                                             loss_hi)
    want_bf, want_hi = as_sd(grads_bf), as_sd(grads_hi)
    assert sorted(grads) == sorted(want_bf)

    def dist(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    port = np.median([dist(grads[k].numpy(), want_bf[k]) for k in want_bf])
    own = np.median([dist(want_bf[k], want_hi[k]) for k in want_bf])
    assert port <= 0.75 * own, (port, own)
