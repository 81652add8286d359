"""The TF32 routes' shared-memory addressing and arithmetic, run on the CPU.

The TF32 routes of ``read_conv_reduce`` (``csrc/read_conv_wgmma_tf32.cuh``)
run only on the card.  Their addressing is stated once more in numpy
(``hello_tpu_torch.ops.read_conv_layout_tf32``): fp32 activations in
position-major buffers swizzled by the position's parity, each warp's A
fragments loaded from them lane by lane and placed where the m64nNk8 tf32
register fragment puts them, the weights as the fold's units read through
B descriptors, the stride-2 block read at 2 p + tap, and the buffers
sharing two regions of shared memory in the kernel's order.  Here that
model runs the kernel's whole schedule on a block of 2 read rows (the other
3 rows padding), its regions first filled with stale values, with the
kernel's arithmetic: each activation split in fp32 into big = tf32(x) and
small = tf32(x - big), rounded to nearest with ties away (cvt.rna), and
small*B_big + big*B_small + big*B_big accumulated in fp32, small terms
first (tf32x3), or big*B_big alone (tf32).

Each of the 18 convs must give what the same products give on its logical
input, summed in float64 (the model sums in fp32 per k-step: rtol 1e-5);
the max-pool exactly.  The frames and the per-allele sum: tf32x3 within
rtol 1e-4 / atol 1e-3 of ``read_conv_reduce_reference`` (fp32), the
kernel's tolerance; tf32 no further from it than one RNA pass of the
emulation in ``test_torch_read_conv_tc.py``, within the slack that another
fp32 summation order takes (a quarter).
"""

import numpy as np
import pytest
import torch

from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc
from hello_tpu_torch.ops import read_conv_layout_tf32 as lay

from test_torch_read_conv_tc import conv_tf32

torch.set_num_threads(1)

NB = 2                      # read rows in the modelled block
PASSES = {"tf32x3": 3, "tf32": 1}


class Block:
    """The kernel's shared memory for one block: regions A and B (filled
    with stale fp32 values first) and the buffers laid out in them."""

    def __init__(self, rng):
        self.region = {"a": (rng.randn(lay.REG_A) * 50).astype(np.float32),
                       "b": (rng.randn(lay.REG_B) * 50).astype(np.float32)}

    def buf(self, name):
        region, off, positions, ch = lay.BUFFERS[name]
        return self.region[region][off:off + positions * ch]

    def _at(self, name, pos, ch):
        return lay.at(lay.BUFFERS[name][3], np.asarray(pos)[:, None],
                      np.arange(ch)[None, :])

    def write(self, name, pos, vals):
        """vals [len(pos), channels] at positions ``pos``."""
        self.buf(name)[self._at(name, pos, vals.shape[1])] = vals

    def read(self, name, pos, channels):
        return self.buf(name)[self._at(name, pos, channels)]

    def zero(self, name, pos, channels):
        self.write(name, np.asarray(pos), np.zeros((len(pos), channels),
                                                   np.float32))


def stored(pq, lo, rows=lay.ROWS):
    """Positions q = r * pq + l (r < rows, l < lo) of a conv's outputs."""
    return (np.arange(rows)[:, None] * pq + np.arange(lo)[None, :]).reshape(-1)


def logical(block, name, channels, nb=NB):
    """A buffer's real activations, [nb, channels, L]."""
    if name in ("in", "s1", "s2", "s3"):
        lo = {"in": 150, "s1": 148, "s2": 146, "s3": 144}[name]
        pos = stored(lay.L_IN, lo, nb)
    elif name in ("x32", "y32"):
        pos = stored(lay.P32, lay.L_POOL, nb) + 1
    else:
        pos = stored(lay.P64, lay.L_OUT, nb) + 1
    vals = block.read(name, pos, channels)
    return vals.reshape(nb, -1, channels).transpose(0, 2, 1)


def split(x):
    big = lay.tf32_rna(x)
    return big, lay.tf32_rna(x - big)


def run_step(block, step, flat, passes):
    """One conv of the kernel as its lanes load A and its descriptors read
    B: per tile, unit and k-step, the products in the kernel's order, each
    summed into fp32 accumulators that start at the bias; the epilogue's
    stores."""
    i, kind, src, dst, (pq, lo, oo), epi = step
    co, units = lay.CONV_CO[i], lay.CONV_UNITS[i]
    ci = lay.BUFFERS[src][3]
    buf = block.buf(src)
    images, bias = lay.unit_images(flat, i, passes)
    n = lay.tiles(pq, lo)
    acc = np.tile(bias, (n, lay.TILE, 1)).astype(np.float32)
    for t in range(n):
        for u, (big_img, small_img) in enumerate(images):
            for s in range(lay.CONV_K[i] // units // 8):
                a = lay.fragments_to_tile(lay.load_a(
                    buf, kind, ci, t, 0 if kind == lay.STEM1 else u, s))
                big, small = split(a)
                bb = lay.b_tile(big_img, co, s).astype(np.float64)
                terms = [big.astype(np.float64) @ bb]
                if passes == 3:
                    bs = lay.b_tile(small_img, co, s).astype(np.float64)
                    terms = [small.astype(np.float64) @ bb,
                             big.astype(np.float64) @ bs] + terms
                for term in terms:
                    acc[t] = (acc[t] + term).astype(np.float32)
    v = acc.reshape(-1, co)
    q = np.arange(n * lay.TILE)
    keep = (q // pq < lay.ROWS) & (q % pq < lo)
    q, v = q[keep], v[keep]
    if epi == "linear":
        out = v
    elif epi == "relu":
        out = np.maximum(v, 0)
    else:
        out = block.read(dst, q + oo, co) + np.maximum(v, 0)
    block.write(dst, q + oo, out.astype(np.float32))


def emulated_conv(x, w, b, kind, pq, passes):
    """One conv of read_convolver_reference with the kernel's products in
    float64: x [nb, Ci, L], W [Co, taps * Ci]; each operand split as the
    kernel splits it."""
    co, kc = w.shape
    nb, ci, length = x.shape
    taps = kc // ci
    stride = 2 if kind in (lay.DOWN, lay.SHORT) else 1
    pad = 0 if kind in (lay.STEM1, lay.SHORT) or pq == lay.L_IN else 1
    xb, xs = (np.pad(p.astype(np.float64), ((0, 0), (0, 0), (pad, pad)))
              for p in split(x))
    wb, ws = (p.astype(np.float64).reshape(co, taps, ci) for p in split(w))
    lo = (length + 2 * pad - taps) // stride + 1
    out = np.zeros((nb, co, lo)) + b.astype(np.float64)[None, :, None]
    cut = lambda m, t: m[:, :, t:t + stride * (lo - 1) + 1:stride]
    for t in range(taps):
        prods = [(wb, xb)] + ([(wb, xs), (ws, xb)] if passes == 3 else [])
        for wp, xp in prods:
            out += np.einsum("oc,ncl->nol", wp[:, t], cut(xp, t))
    return out


def model_block(rows, folded, passes, rng):
    """Run the kernel's schedule on one block; returns (the checks of every
    conv and of the pool: (what, got, want, exact) tuples, the frames [nb,
    36, 64])."""
    nb, _, c = rows.shape
    block = Block(rng)
    flat = folded.flat.numpy()
    x = np.zeros((lay.P_IN, 8), np.float32)
    x[:nb * lay.L_IN, :c] = rows.reshape(-1, c)
    block.write("in", np.arange(lay.P_IN), x)
    checks = []
    for step in lay.STEPS:
        i, kind, src, dst, (pq, lo, oo), epi = step
        w, b = (t.numpy() for t in folded.convs[i])
        ci = w.shape[1] // (1 if kind == lay.SHORT else 3)
        inp = logical(block, src, ci)
        before = logical(block, dst, w.shape[0]) if "add" in epi else None
        run_step(block, step, flat, passes)
        y = emulated_conv(inp, w, b, kind, pq, passes)
        want = (y if epi == "linear" else np.maximum(y, 0) if epi == "relu"
                else before + np.maximum(y, 0))
        checks.append((f"conv {i}", logical(block, dst, w.shape[0]), want,
                       False))
        if i == 2:
            # the max-pool (zeros at the halo and spare columns), then the
            # halo and spare columns of y32
            s3 = block.read("s3", np.arange(lay.P_S), 32)
            pos = np.arange(lay.P32B)
            r, col = pos // lay.P32, pos % lay.P32
            live = (r < lay.ROWS) & (col >= 1) & (col <= lay.L_POOL)
            at = np.where(live, r * lay.L_IN + 2 * (col - 1), 0)
            pooled = np.maximum(np.maximum(s3[at], s3[at + 1]), s3[at + 2])
            block.write("x32", pos, np.where(live[:, None], pooled, 0))
            want = torch.nn.functional.max_pool1d(
                torch.from_numpy(logical(block, "s3", 32)), 3, 2).numpy()
            checks.append(("max-pool", logical(block, "x32", 32), want, True))
            r = np.arange(lay.ROWS)[:, None]
            block.zero("y32", (r * lay.P32 + np.array([0, 72, 73, 74, 75])
                               ).reshape(-1), 32)
        if i == 8:
            halo = (np.arange(lay.ROWS)[:, None] * lay.P64
                    + np.array([0, lay.P64 - 1])).reshape(-1)
            block.zero("y64", halo, 64)
            block.zero("x64", halo, 64)
    frames = logical(block, "x64", 64).transpose(0, 2, 1)
    return checks, frames


@pytest.fixture(scope="module", params=[
    ("illumina", 6, "tf32x3"), ("pacbio_hp", 7, "tf32x3"),
    ("illumina", 6, "tf32"), ("pacbio_hp", 7, "tf32")],
    ids=["C6-tf32x3", "C7-tf32x3", "C6-tf32", "C7-tf32"])
def modelled(request):
    name, c, route = request.param
    model = init_params(create_model(name), torch.Generator().manual_seed(4))
    folded = rc.fold_read_conv_weights(model.read_convolver0, route)
    rng = np.random.RandomState(c)
    rows = rng.randint(0, 256, (NB, lay.L_IN, c)).astype(np.uint8)
    checks, frames = model_block(rows, folded, PASSES[route], rng)
    return model, rows, folded, checks, frames


def test_every_conv_of_the_schedule_is_its_products(modelled):
    """Each of the 18 convs, read through the kernel's lane loads and
    descriptors from buffers that share regions with stale values, equals
    the same split products on its logical input in float64 (rtol 1e-5:
    the model, like the card, sums in fp32); the max-pool exactly."""
    _, _, _, checks, _ = modelled
    assert [c[0] for c in checks if c[0].startswith("conv")] == [
        f"conv {s[0]}" for s in lay.STEPS]
    for what, got, want, exact in checks:
        assert got.shape == want.shape, what
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=what)


def test_modelled_frames_and_sum_match_the_plain_version(modelled,
                                                         monkeypatch):
    """The modelled block's frames and per-allele sum (rows of one allele,
    row_valid weights, as the kernel's atomics take them; other alleles
    exactly 0) against the fp32 plain version: tf32x3 within rtol 1e-4 /
    atol 1e-3; tf32 no further than 1.25 x one RNA pass of the emulation."""
    model, rows, folded, _, frames = modelled
    t = torch.from_numpy(rows)
    fp32 = rc.fold_read_conv_weights(model.read_convolver0, "tf32x3")
    assert np.isfinite(frames).all() and frames.shape == (NB, lay.L_OUT, 64)
    valid = np.array([0.5, 2.0], np.float32)
    allele = torch.tensor([1, 1], dtype=torch.int32)
    got = np.zeros((3, lay.L_OUT, 64), np.float32)
    for r in range(NB):
        got[allele[r]] += valid[r] * frames[r]
    args = (t, allele, torch.from_numpy(valid))
    with torch.no_grad():
        want = rc.read_conv_reduce_reference(*args, fp32, 3).numpy()
    assert not got[[0, 2]].any() and not want[[0, 2]].any()
    if folded.route == "tf32x3":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        return
    monkeypatch.setattr(rc, "_conv", conv_tf32(1))
    with torch.no_grad():
        emulated = rc.read_conv_reduce_reference(*args, fp32, 3).numpy()
    err = np.abs(got - want).max()
    assert 0 < err <= 1.25 * np.abs(emulated - want).max()


def test_buffers_fit_their_regions_and_live_ones_do_not_overlap():
    """Every buffer fits its region; x64 and y64 (both live through the
    64-channel blocks), x32 and y32, and each stem conv's input and output
    sit apart; the whole block fits one SM's 227 KB."""
    size = {"a": lay.REG_A, "b": lay.REG_B}
    span = {}
    for name, (region, off, positions, ch) in lay.BUFFERS.items():
        span[name] = (region, off, off + positions * ch)
        assert span[name][2] <= size[region], name
    apart = lambda a, b: (span[a][0] != span[b][0] or span[a][2] <= span[b][1]
                          or span[b][2] <= span[a][1])
    for a, b in (("x64", "y64"), ("x32", "y32"), ("x32", "x64"),
                 ("x32", "y64"), ("in", "s1"), ("s1", "s2"), ("s2", "s3"),
                 ("x32", "s3")):
        assert apart(a, b), (a, b)
    assert lay.SMEM_BYTES <= 232448


def test_fold_units_are_the_layout_models():
    """The fold's flat buffer is the header's: each conv at conv_off, its
    units of one tap (big, then small for tf32x3), then its bias; the
    largest unit fills a stage."""
    model = init_params(create_model("illumina"),
                        torch.Generator().manual_seed(5))
    for route, passes in PASSES.items():
        f = rc.fold_read_conv_weights(model.read_convolver0, route)
        flat = f.flat.numpy()
        assert flat.size == lay.conv_off(18, passes)
        biggest = 0
        for i, (w, b) in enumerate(f.convs):
            units, bias = lay.unit_images(flat, i, passes)
            np.testing.assert_array_equal(bias, b.numpy())
            assert len(units) == rc.tf32_units(w.shape[1])
            biggest = max(biggest, sum(p.size for p in units[0]
                                       if p is not None))
            assert all(p.size == units[0][0].size for u in units for p in u
                       if p is not None)
        assert biggest * 4 == lay.STAGE * lay.parts(passes) // 2
