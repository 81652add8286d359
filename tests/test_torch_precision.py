"""The port's precisions against hello_tpu's (CPU).

``bf16``: the port's plain read-convolver reduction and its illumina and
hybrid forwards against hello_tpu's at bf16 (layers path + packed_read_reduce,
the fused Pallas kernel with a bf16 ``compute_dtype`` in interpret mode, and
``MoEAttention.apply``).  The bar: |port - hello_tpu| is at most a quarter
of |hello_tpu bf16 - hello_tpu highest| on the same inputs, which holds only
if the port rounds to bf16 where hello_tpu does (a port that stayed fp32
would sit a whole bf16 distance away): the largest difference for the
read-convolver reductions, the median logit for whole forwards.  A whole
bf16 forward is chaotic in the fp32 reduction order of its convs: one sum
that two orders round to neighbouring bf16 values moves the later layers of
that allele's stack, and its logits by up to the whole bf16 distance, so the
largest logit difference of two correct bf16 implementations is not small
(hello_tpu's own layer path and fused kernel differ by a third of it).  The
cast points are therefore also checked layer by layer, each layer fed
hello_tpu's own input, where no such cascade can form.

The bf16 comparisons use weight-norm directions ``v`` on a 1/64 grid (the
gains ``g`` and biases stay as hello_tpu initialises them).  On that grid
the norm's sum of squares is exact in fp32 in any order, so both frameworks
fold bit-equal effective weights.  With arbitrary ``v`` the two norms differ
in the last fp32 bit, some weights round to another bf16 value, and
hello_tpu's own bf16 logits move by more than its whole bf16-against-fp32
distance under such a change (``test_bf16_logits_move_with_one_ulp_of_g``):
the bar would then measure reduction order, not cast points.

``default`` and ``high`` are fp32 on the CPU in both frameworks: rtol 1e-4 /
atol 1e-4.  The bf16 and 1xTF32 weight buffers of the kernel are unpacked
and checked as tests/test_torch_read_conv_tc.py checks the 3xTF32 one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn import moe as jax_moe
from hello_tpu.ops import read_conv as jax_rc
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import init_params, state_dict_from_jax
from hello_tpu_torch.ops import read_conv as rc
from hello_tpu_torch.pipeline import call

import test_torch_moe as moe_cases

torch.set_num_threads(1)

BAR = 0.25


@pytest.fixture(autouse=True)
def restore_precision():
    """Every test leaves both frameworks at highest, whatever it set."""
    yield
    layers.set_precision("highest")
    jax_layers.set_precision("highest")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        jax_rc.pl, "pallas_call",
        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


def on_grid(params, seed):
    """``params`` with every weight-norm direction ``v`` redrawn on a 1/64
    grid in [-1, 1] (order-free fp32 norms); ``g`` and biases kept."""
    rng = np.random.RandomState(seed)

    def walk(p):
        if isinstance(p, dict):
            return {k: (np.round(rng.uniform(-1, 1, v.shape) * 64) / 64)
                    .astype(np.float32) if k == "v" else walk(v)
                    for k, v in p.items()}
        return p
    return walk(params)


def pair(config, seed, grid=True):
    """(JAX model, params, state, port model) with the same weights."""
    jax_layers.set_precision("highest")
    jm = jax_moe.create_model(config)
    params, state = jm.init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    if grid:
        params = on_grid(params, seed)
    tm = moe.create_model(config)
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    return jm, params, state, tm.eval()


def jax_at(precision, fn):
    jax_layers.set_precision(precision)
    try:
        return fn()
    finally:
        jax_layers.set_precision("highest")


def assert_within_bar(got, want_bf16, want_hi, what, stat=np.max):
    port = stat(np.abs(got - want_bf16))
    ref = stat(np.abs(want_bf16 - want_hi))
    assert ref > 0, what
    assert port <= BAR * ref, (f"{what}: |port - hello_tpu bf16| {port} > "
                               f"{BAR} x |hello_tpu bf16 - highest| {ref}")


# ---------------------------------------------------------------------------
# Precision modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,act,tf32,route", [
    ("highest", None, False, "tf32x3"), ("high", None, False, "tf32x3"),
    ("default", None, True, "tf32"), ("bf16", torch.bfloat16, True, "bf16"),
])
def test_set_precision_modes(precision, act, tf32, route):
    """``tf32``: TF32 allowed in cuBLAS; cuDNN's follows it except at bf16,
    where every conv takes bf16-valued operands and cuDNN's TF32 algorithms
    would not keep their products exact."""
    layers.set_precision(precision)
    assert layers.PRECISION == precision and layers.ACT_DTYPE == act
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert torch.backends.cudnn.allow_tf32 == (tf32 and precision != "bf16")
    assert rc.route_for_precision(precision) == route
    _, _, _, tm = pair("illumina", 0, grid=False)
    assert tm.fold_read_convs()["read_conv0"].route == route


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        layers.set_precision("fp8")
    with pytest.raises(ValueError, match="route"):
        rc.route_for_precision("fp8")
    assert layers.PRECISION == "highest"


def test_scorer_takes_the_precision_in_force():
    """The Scorer folds for the precision set before it (no override), and a
    forward after another set_precision refuses the stale fold."""
    layers.set_precision("bf16")
    scorer = call.Scorer(moe.create_model("illumina"), device="cpu")
    assert scorer.precision == "bf16"
    assert scorer.folded["read_conv0"].route == "bf16"
    assert layers.PRECISION == "bf16"
    layers.set_precision("default")
    batch = {k: torch.from_numpy(v) for k, v in
             moe_cases._packed_batch(np.random.RandomState(0)).items()}
    with pytest.raises(ValueError, match="fold again"):
        scorer.model(batch, folded=scorer.folded)


# ---------------------------------------------------------------------------
# The read-convolver reduction at bf16
# ---------------------------------------------------------------------------

def packed_rows(rng, A, counts, C, n_pad):
    row_allele = np.concatenate([np.full(c, a, np.int32)
                                 for a, c in enumerate(counts)]
                                + [np.full(n_pad, A, np.int32)])
    rows = rng.randint(0, 256, (len(row_allele), 150, C)).astype(np.uint8)
    return rows, row_allele, (row_allele < A).astype(np.float32)


def port_reduce(tm, rows, row_allele, row_valid, A, route):
    folded = rc.fold_read_conv_weights(tm.read_convolver0, route)
    return rc.read_conv_reduce(torch.from_numpy(rows),
                               torch.from_numpy(row_allele),
                               torch.from_numpy(row_valid), folded, A).numpy()


@pytest.mark.parametrize("name,C", [("illumina", 6), ("pacbio_hp", 7)])
def test_plain_bf16_matches_layers_path(name, C):
    """Packed rows with padding rows, against hello_tpu's read_conv0.apply at
    bf16 + packed_read_reduce (fp32 sums of the bf16 frames)."""
    jm, params, _, tm = pair(name, 1)
    rng = np.random.RandomState(2)
    A = 5
    rows, row_allele, row_valid = packed_rows(rng, A, [3, 1, 4, 0, 2], C, 3)

    def reference():
        x = jnp.asarray(rows, jax_layers.ACT_DTYPE or jnp.float32)
        frames, _ = jm.nets["read_conv0"].apply(params["read_conv0"], {}, x)
        return np.asarray(jax_moe.packed_read_reduce(
            frames, jnp.asarray(row_allele), jnp.asarray(row_valid), A))

    want_bf16 = jax_at("bf16", reference)
    want_hi = jax_at("highest", reference)
    got = port_reduce(tm, rows, row_allele, row_valid, A, "bf16")
    assert got.dtype == np.float32 and not got[3].any()
    assert_within_bar(got, want_bf16, want_hi, f"{name} read-conv reduction")


def test_plain_bf16_matches_fused_pallas_bf16(interpret_pallas):
    """The dense [A, R] grid flattened to rows, against hello_tpu's fused
    kernel with compute_dtype=bfloat16 (interpret mode, lanes=8).  Its
    products are im2col dots, summed in another order than the layers'
    convs, so hello_tpu's two bf16 routes differ from each other (here by a
    third of the kernel's own bf16-against-fp32 distance): the port must sit
    no further from the fused kernel than hello_tpu's layer path does."""
    jm, params, _, tm = pair("illumina", 3)
    rng = np.random.RandomState(4)
    A, R = 4, 8
    reads = rng.randint(0, 256, (A, R, 150, 6)).astype(np.uint8)
    mask = (rng.rand(A, R) < 0.8).astype(np.float32)
    rows = reads.reshape(A * R, 150, 6)
    row_allele = (np.arange(A * R) // R).astype(np.int32)
    weights = jax_rc.extract_read_conv_weights(jm.nets["read_conv0"],
                                               params["read_conv0"])
    fused = lambda dt: np.asarray(jax_rc.fused_read_convolver(
        jnp.asarray(reads), jnp.asarray(mask), weights, compute_dtype=dt,
        lanes=8))
    fused_bf16 = fused(jnp.bfloat16)

    def layer_path():
        frames, _ = jm.nets["read_conv0"].apply(
            params["read_conv0"], {}, jnp.asarray(rows, jnp.bfloat16))
        return np.asarray(jax_moe.packed_read_reduce(
            frames, jnp.asarray(row_allele), jnp.asarray(mask.reshape(-1)),
            A))

    layers_bf16 = jax_at("bf16", layer_path)
    got = port_reduce(tm, rows, row_allele, mask.reshape(-1), A, "bf16")
    assert np.abs(fused_bf16 - fused(jnp.float32)).max() > 0
    assert np.abs(got - fused_bf16).max() <= \
        np.abs(layers_bf16 - fused_bf16).max()


@pytest.mark.parametrize("route", ["tf32", "tf32x3"])
def test_tf32_routes_are_fp32_on_the_cpu(route):
    """The TF32 routes' plain version is the fp32 one (the CPU has no TF32;
    on the card the 1xTF32 route's plain version is cuDNN in TF32)."""
    _, _, _, tm = pair("illumina", 5, grid=False)
    rng = np.random.RandomState(6)
    args = packed_rows(rng, 3, [2, 0, 3], 6, 2) + (3,)
    np.testing.assert_array_equal(port_reduce(tm, *args, route),
                                  port_reduce(tm, *args, "tf32x3"))


# ---------------------------------------------------------------------------
# Whole forwards
# ---------------------------------------------------------------------------

def batch_for(config, layout, rng):
    if config == "illumina":
        make = (moe_cases._dense_batch if layout == "dense"
                else moe_cases._packed_batch)
        return make(rng)
    return moe_cases._hybrid_batch(rng, layout, "mixed")


def forward_pair(jm, params, state, tm, batch, precision):
    """(port output, hello_tpu output) at one precision, as numpy."""
    want = jax_at(precision, lambda: jm.apply(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    layers.set_precision(precision)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()},
                 folded=tm.fold_read_convs())
    layers.set_precision("highest")
    as_np = lambda out: {k: None if v is None else np.asarray(v)
                         for k, v in out.items()}
    return as_np(got), as_np(want)


@pytest.fixture(scope="module", params=["illumina", "hybrid"])
def grid_models(request):
    return (request.param,) + pair(request.param, 7)


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_forward_bf16_matches_jax(grid_models, layout):
    """Expert logits (and the meta-expert's softmax for hybrid) at bf16; the
    logits and meta stay fp32 on both sides.  The bar is on the median
    logit: one conv sum that the two frameworks' fp32 reduction orders round
    to neighbouring bf16 values spreads through the later convs of that
    allele's stack and can move its logits by the whole bf16 distance (the
    hybrid packed batch here has one such sum in compressor1, which
    ``test_bf16_layers_round_where_hello_tpu_rounds`` isolates), while the
    other logits stay bit-close; a port that stayed fp32 would sit a whole
    bf16 distance away at the median too."""
    config, jm, params, state, tm = grid_models
    batch = batch_for(config, layout, np.random.RandomState(8))
    got, want = forward_pair(jm, params, state, tm, batch, "bf16")
    _, want_hi = forward_pair(jm, params, state, tm, batch, "highest")
    for key in ("experts", "meta"):
        if want[key] is None:
            assert got[key] is None and config == "illumina"
            continue
        assert got[key].dtype == want[key].dtype == np.float32
        assert_within_bar(got[key], want[key], want_hi[key],
                          f"{config} {layout} {key}", stat=np.median)


def _to_torch(x):
    """A hello_tpu activation (array or nested tuple) as torch, bf16 kept."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to_torch(v) for v in x)
    if x is None:
        return None
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [] if x is None else [x]


@pytest.mark.parametrize("config", ["illumina", "hybrid"])
def test_bf16_layers_round_where_hello_tpu_rounds(config):
    """Every layer of every network, fed hello_tpu's own bf16 input to that
    layer (recorded from a whole bf16 forward), returns hello_tpu's output:
    bf16 where hello_tpu's is bf16, and equal to it except for at most 0.2%
    of the values, each within two bf16 ulps of the layer's largest value (a
    conv sum that the two fp32 reduction orders round to neighbouring bf16
    values, and what it moves inside the layer).  fp32 outputs (the
    Linear logits, the meta softmax's inputs) within rtol / atol 1e-4."""
    jm, params, state, tm = pair(config, 7)
    batch = {k: jnp.asarray(v) for k, v in
             batch_for(config, "packed", np.random.RandomState(8)).items()}
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
    assert {"read_conv0", "compressor0", "xattn0"} <= set(inputs)
    jax_layers.set_precision("bf16")
    layers.set_precision("bf16")
    for name, x in inputs.items():
        p, s = params.get(name, {}), state.get(name, {})
        port_net = tm.net(name).network
        for i, (jax_layer, port_layer) in enumerate(
                zip(jm.nets[name].layers, port_net, strict=True)):
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
                differ = g != w
                assert differ.sum() <= 0.002 * w.size, (what, differ.sum())
                assert np.abs(g - w).max() <= 2 ** -6 * np.abs(w).max(), what
            x = y


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("config", ["illumina", "hybrid"])
def test_forward_default_and_high_match_jax(config, precision):
    """fp32 on the CPU in both frameworks: rtol 1e-4 / atol 1e-4."""
    jm, params, state, tm = pair(config, 9, grid=False)
    batch = batch_for(config, "packed", np.random.RandomState(10))
    got, want = forward_pair(jm, params, state, tm, batch, precision)
    for key in ("experts", "meta"):
        if want[key] is not None:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-4)


def test_bf16_logits_move_with_one_ulp_of_g():
    """Why the bf16 bar runs on grid weights: hello_tpu's own bf16 logits
    move by more than the bar when half of the weight-norm gains move by one
    fp32 ulp, a change as small as two frameworks' norm sums make."""
    jm, params, state, _ = pair("illumina", 7, grid=False)
    rng = np.random.RandomState(11)

    def nudge(p):
        if isinstance(p, dict):
            return {k: np.where(rng.rand(*v.shape) < 0.5,
                                np.nextafter(v, np.float32(np.inf)), v)
                    .astype(np.float32) if k == "g" else nudge(v)
                    for k, v in p.items()}
        return p

    batch = {k: jnp.asarray(v) for k, v in
             moe_cases._packed_batch(np.random.RandomState(8)).items()}
    run = lambda p, prec: np.asarray(jax_at(
        prec, lambda: jm.apply(p, state, batch)[0]["experts"]))
    base = run(params, "bf16")
    moved = np.abs(run(nudge(params), "bf16") - base).max()
    assert moved > BAR * np.abs(base - run(params, "highest")).max()


# ---------------------------------------------------------------------------
# The kernel's bf16 and 1xTF32 weight buffers
# ---------------------------------------------------------------------------

def tf32_rna(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bf16_rne(x):
    """fp32 -> bf16 (to nearest, ties to even) on the bits, kept as fp32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def unpack_tf32(frag, co, kp):
    """[K/8][Co/16][lane = 4 g + t][a0..a3] -> W [Co, Kp]: a0..a3 at (row,
    col) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    frag = frag.reshape(kp // 8, co // 16, 32, 4)
    m = np.zeros((co, kp), np.float32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for a, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            m[g + dr::16, t + dc::8] = frag[:, :, lane, a].T
    return m


def unpack_bf16(words, co, kp):
    """The wgmma B image [K/8][Co][8] bf16 -> W [Co, Kp]: element [k8][n][e]
    is W[n, 8 k8 + e], K in the fold's bf16 order (``bf16_k_order``)."""
    halves = words.view(np.uint16).reshape(kp // 8, co, 8)
    vals = (halves.astype(np.uint32) << 16).view(np.float32)
    return vals.transpose(1, 0, 2).reshape(co, kp)


@pytest.mark.parametrize("route", ["tf32", "bf16"])
@pytest.mark.parametrize("name,C", [("illumina", 6), ("pacbio_hp", 7)])
def test_fold_round_trip_routes(name, C, route):
    """The route's buffer unpacks to its weights: TF32 parts of W rounded
    as cvt.rna rounds (tf32), or W rounded to bf16 to nearest even (bf16),
    K zero-padded to a whole k-step (stem conv 1: 3C -> 24; for bf16 4 taps
    of 8 channels, 32, each tap's C columns at tap * 8), then the fp32
    bias."""
    model = init_params(moe.create_model(name),
                        torch.Generator().manual_seed(3))
    exact = rc.fold_read_conv_weights(model.read_convolver0, "tf32x3")
    f = rc.fold_read_conv_weights(model.read_convolver0, route)
    assert f.route == route and f.in_channels == C
    flat = f.flat.numpy()
    assert flat.size == rc.num_weight_floats(C, route)
    off = 0
    for (w, b), (wr, br) in zip(exact.convs, f.convs):
        w = w.numpy()
        co, kc = w.shape
        kp = rc.padded_k(kc, route)
        assert kp == (kc if kc % 16 == 0 else (24 if route == "tf32" else 32))
        n = rc.fragment_floats(co, kc, route)
        frag = flat[off:off + n]
        if route == "tf32":
            m = unpack_tf32(frag, co, kp)
            order = np.arange(kc)
        else:
            m = unpack_bf16(frag, co, kp)
            order = rc.bf16_k_order(kc).numpy()
            assert kc % 16 or (order == np.arange(kc)).all()
        assert not np.delete(m, order, axis=1).any()
        m = m[:, order]
        want = tf32_rna(w) if route == "tf32" else bf16_rne(w)
        np.testing.assert_array_equal(m, want)
        # the plain version's weights: fp32 for tf32, the bf16 values
        np.testing.assert_array_equal(wr.numpy(),
                                      w if route == "tf32" else want)
        np.testing.assert_array_equal(flat[off + n:off + n + co], b.numpy())
        np.testing.assert_array_equal(br.numpy(), b.numpy())
        off += n + co
    assert off == flat.size


def test_bf16_fold_order_is_a_consistent_permutation():
    """The fold's K order for stem conv 1 (tap * 8 + channel) and the
    kernel's reading of its [position][8] input agree: per k-step s, A read
    through the kernel's descriptor (taps 2s and 2s + 1, one position apart)
    times B read through the image's descriptor, summed over the k-steps,
    is the valid k = 3 conv W * x in float64, on one 64-position tile; and
    every K column of a conv lands in exactly one place of the image."""
    from hello_tpu_torch.ops import read_conv_layout as lay

    rng = np.random.RandomState(12)
    for c in (6, 7):
        w = bf16_rne(rng.randn(16, 3 * c).astype(np.float32))
        x = rng.randint(0, 256, (c, 80)).astype(np.float32)
        image = rc.pack_conv(torch.from_numpy(w), "bf16").numpy().view(np.uint8)
        buf = lay.lay_out(x, lay.P_IN)
        out = sum(lay.read_tile(buf, lay.a_offset(lay.STEM1, 8, 16, s), 16, 64)
                  @ lay.b_tile(image, 16, s) for s in range(2))
        want = sum(x[:, t:t + 64].T.astype(np.float64)
                   @ w[:, t * c:(t + 1) * c].T.astype(np.float64)
                   for t in range(3))
        np.testing.assert_array_equal(out, want)
        order = rc.bf16_k_order(3 * c).numpy()
        assert len(set(order)) == 3 * c and order.max() < 32
    for kc in (48, 96, 192, 32):
        assert (rc.bf16_k_order(kc).numpy() == np.arange(kc)).all()


def test_build_compiles_one_library_for_all_routes(monkeypatch, tmp_path):
    """All routes are template instances in one source: the build key hashes
    the source, so nvcc runs once, not once per route."""
    import subprocess

    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(rc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(rc, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(rc.subprocess, "run", fake_run)
    paths = {rc.build()[0] for _ in rc.ROUTE_IDS}
    assert len(paths) == 1 and len(calls) == 1


@pytest.mark.parametrize("route", ["tf32", "bf16"])
def test_kernel_argument_checks_follow_the_route(route):
    """The wrapper's checks take each route's buffer and refuse a buffer
    packed for another route."""
    _, _, _, tm = pair("illumina", 0, grid=False)
    f = rc.fold_read_conv_weights(tm.read_convolver0, route)
    rows, row_allele, row_valid = (torch.from_numpy(a) for a in
                                   packed_rows(np.random.RandomState(1), 2,
                                               [2, 2], 6, 0))
    rc._check_cuda_args(rows, row_allele, row_valid, f, 2)
    f.route = "tf32x3"
    with pytest.raises(ValueError, match="layout"):
        rc._check_cuda_args(rows, row_allele, row_valid, f, 2)


# ---------------------------------------------------------------------------
# The precision sweep
# ---------------------------------------------------------------------------

def test_sweep_compare_matches_jax():
    from hello_tpu.io.vcf import VcfRecord
    from hello_tpu.pipeline import precision_sweep as jax_sweep
    from hello_tpu_torch.pipeline import precision_sweep

    rng = np.random.RandomState(13)
    make = lambda flip: [
        VcfRecord("chr1", int(p), "A", ["T"] if p % 7 else ["G"],
                  (0, 1) if (p % 5 or not flip) else (1, 1),
                  qual=float(q))
        for p, q in zip(range(100, 4000, 37), rng.uniform(0, 50, 106))
        if not (flip and p % 11 == 0)]
    hi, lo = make(False), make(True)
    got = precision_sweep.compare(hi, lo)
    want = jax_sweep.compare(hi, lo)
    assert got[:2] == want[:2] and got[0] > 0 and got[1] > 0
    np.testing.assert_array_equal(np.sort(got[2]), np.sort(want[2]))


@pytest.mark.parametrize("out", ["PRECISION_SWEEP.md", "x/PRECISION_SWEEP.md",
                                 "sweep.txt"])
def test_sweep_never_writes_the_reference_report(out, capsys):
    from hello_tpu_torch.pipeline import precision_sweep

    with pytest.raises(SystemExit):
        precision_sweep.main(["--out", out])
    assert "PRECISION_SWEEP.md" in capsys.readouterr().err
