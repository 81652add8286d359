"""The bf16 route's shared-memory addressing, run on the CPU.

The bf16 route of ``read_conv_reduce`` (``csrc/read_conv_wgmma.cuh``) runs
only on the card.  Its addressing is stated once more in numpy
(``hello_tpu_torch.ops.read_conv_layout``): activations as bf16 in buffers
[channel group][position][8], each conv's A tile read through a no-swizzle
K-major wgmma descriptor (start, LBO, SBO) at tap shifts, the stride-2
block on even / odd planes, stem conv 1 on a [position][8] input, the
weights as the fold's image read through B descriptors, and the buffers
sharing two regions of shared memory in the kernel's order.  Here that
model runs the kernel's whole schedule on a block of 2 read rows (the other
3 rows of the block padding), its regions first filled with stale values,
and every one of the 18 convs must give, exactly, what the conv of
``read_convolver_reference`` at bf16 gives on the same input: bf16
products are exact, so both sum in float64 and round as the reference
rounds (fp32, then bf16).  The max-pool, the frames and the per-allele sum
are held the same way.
"""

import numpy as np
import pytest
import torch

from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc
from hello_tpu_torch.ops import read_conv_layout as lay

NB = 2                      # read rows in the modelled block


def bf16(x):
    """float -> fp32 -> bf16 (to nearest even), kept as float32."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def conv_images(folded):
    """Each fold conv's image bytes and fp32 bias, from the flat buffer."""
    raw = folded.flat.numpy().view(np.uint8)
    out, off = [], 0
    for w, _ in folded.convs:
        co, kc = w.shape
        n = rc.padded_k(kc, "bf16") * co * 2
        out.append((raw[off:off + n], raw[off + n:off + n + 4 * co].view(
            np.float32)))
        off += n + 4 * co
    assert off == raw.size
    return out


class Block:
    """The kernel's shared memory for one block: regions A and B (filled
    with stale bf16 values first) and the buffers laid out in them."""

    def __init__(self, rng):
        junk = lambda n: lay.to_bf16_bits(bf16(rng.randn(n // 2) * 50)).view(
            np.uint8)
        self.region = {"a": junk(lay.REG_A), "b": junk(lay.REG_B)}

    def _at(self, name, pos, ch):
        region, off, positions = lay.BUFFERS[name]
        group = ch // 8 if name != "in" else 0
        return region, (off + group * positions * 16 + pos * 16
                        + (ch % 8) * 2) // 2

    def write(self, name, pos, vals):
        """vals [len(pos), channels] (bf16 values) at positions ``pos``."""
        ch = np.arange(vals.shape[1])
        region, at = self._at(name, pos[:, None], ch[None, :])
        self.region[region].view(np.uint16)[at] = lay.to_bf16_bits(vals)

    def read(self, name, pos, channels):
        region, at = self._at(name, np.asarray(pos)[:, None],
                              np.arange(channels)[None, :])
        return lay.from_bf16_bits(self.region[region].view(np.uint16)[at])

    def zero(self, name, pos, channels):
        self.write(name, np.asarray(pos), np.zeros((len(pos), channels),
                                                   np.float32))


def stored(pq, lo, rows=lay.ROWS):
    """Positions q = r * pq + l (r < rows, l < lo) of a conv's outputs."""
    return (np.arange(rows)[:, None] * pq + np.arange(lo)[None, :]).reshape(-1)


def plane_pos(q):
    """Where the last 32-channel add stores output q = r * 76 + l: column c
    = l + 1 of the padded row, even -> r * 38 + c / 2, odd -> ODD + ..."""
    r, c = q // lay.P32, q % lay.P32 + 1
    return np.where(c % 2, lay.ODD, 0) + r * lay.P64 + c // 2


def logical(block, name, channels, nb=NB):
    """A buffer's real activations, [nb, channels, L]."""
    if name in ("in", "s1", "s2", "s3"):
        lo = {"in": 150, "s1": 148, "s2": 146, "s3": 144}[name]
        pos = stored(lay.L_IN, lo, nb)
    elif name in ("x32", "y32"):
        pos = stored(lay.P32, lay.L_POOL, nb) + 1
    elif name == "planes":
        pos = plane_pos(stored(lay.P32, lay.L_POOL, nb))
    else:
        pos = stored(lay.P64, lay.L_OUT, nb) + 1
    vals = block.read(name, pos, channels)
    return vals.reshape(nb, -1, channels).transpose(0, 2, 1)


def run_step(block, step, image, bias):
    """One conv of the kernel as its descriptors read it: per tile and
    k-step A (read_tile of the input buffer) times B (b_tile of the image),
    summed in float64 from the bias; the epilogue's rounding and stores."""
    i, kind, src, dst, (pq, lo, oo), epi = step
    co = bias.size
    k = image.size // (2 * co)
    ci = 8 if kind == lay.STEM1 else k if kind == lay.SHORT else k // 3
    region, off, positions = lay.BUFFERS[src]
    lbo = lay.a_lbo(kind, positions)
    n = lay.tiles(pq, lo)
    acc = np.tile(bias.astype(np.float64), (n * lay.TILE, 1))
    for t in range(n):
        for s in range(k // 16):
            a = lay.read_tile(block.region[region], off + t * lay.TILE * 16
                              + lay.a_offset(kind, ci, lbo, s), lbo, lay.TILE)
            acc[t * lay.TILE:(t + 1) * lay.TILE] += a @ lay.b_tile(image, co, s)
    v = bf16(acc.astype(np.float32))
    q = np.arange(n * lay.TILE)
    keep = (q // pq < lay.ROWS) & (q % pq < lo)
    q, v = q[keep], v[keep]
    if epi == "linear":
        out, pos = v, q + oo
    elif epi == "relu":
        out, pos = np.maximum(v, 0), q + oo
    else:
        old = block.read("x32" if epi == "relu_add_planes" else dst,
                         q + 1, co)
        out = bf16(old + np.maximum(v, 0))
        pos = plane_pos(q) if epi == "relu_add_planes" else q + oo
    block.write(dst, pos, out)


def reference_conv(x, w, b, kind, pq):
    """One conv of read_convolver_reference at bf16 in float64: x [nb, Ci,
    L] bf16 values, W [Co, taps * Ci]; the fp32 sum rounded to bf16."""
    co, kc = w.shape
    nb, ci, length = x.shape
    taps = kc // ci
    stride = 2 if kind in (lay.DOWN, lay.SHORT) else 1
    pad = 0 if kind in (lay.STEM1, lay.SHORT) or pq == lay.L_IN else 1
    xp = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (pad, pad)))
    lo = (length + 2 * pad - taps) // stride + 1
    wt = w.astype(np.float64).reshape(co, taps, ci)
    out = np.zeros((nb, co, lo)) + b.astype(np.float64)[None, :, None]
    for t in range(taps):
        out += np.einsum("oc,ncl->nol", wt[:, t],
                         xp[:, :, t:t + stride * (lo - 1) + 1:stride])
    return bf16(out.astype(np.float32))


def model_block(rows, folded, rng):
    """Run the kernel's schedule on one block; returns (the checks of every
    conv and of the pool: (what, got, want) triples, the frames [nb, 36,
    64])."""
    nb, _, c = rows.shape
    block = Block(rng)
    images = conv_images(folded)
    # the input: uint8 -> bf16 [pos][8], C channels then zeros, every
    # position past the block's rows zero
    x = np.zeros((lay.P_IN, 8), np.float32)
    x[:nb * lay.L_IN, :c] = rows.reshape(-1, c)
    block.write("in", np.arange(lay.P_IN), x)
    checks = []
    for step in lay.STEPS:
        i, kind, src, dst, (pq, lo, oo), epi = step
        w, b = (t.numpy() for t in folded.convs[i])
        ci = w.shape[1] // (1 if kind == lay.SHORT else 3)
        inp = logical(block, src, ci)
        before = logical(block, "x32" if epi == "relu_add_planes" else dst,
                         w.shape[0]) if "add" in epi else None
        run_step(block, step, *images[i])
        y = reference_conv(inp, w, b, kind, pq)
        want = (y if epi == "linear" else np.maximum(y, 0) if epi == "relu"
                else bf16(before + np.maximum(y, 0)))
        checks.append((f"conv {i}", logical(block, dst, w.shape[0]), want))
        if i == 2:
            # the max-pool (zeros at the halo and spare columns), then the
            # halo columns of y32 and of the planes
            s3 = block.read("s3", np.arange(lay.P_S), 32)
            pos = np.arange(lay.P32B)
            r, col = pos // lay.P32, pos % lay.P32
            live = (r < lay.ROWS) & (col >= 1) & (col <= lay.L_POOL)
            at = np.where(live, r * lay.L_IN + 2 * (col - 1), 0)
            pooled = np.maximum(np.maximum(s3[at], s3[at + 1]), s3[at + 2])
            block.write("x32", pos, np.where(live[:, None], pooled, 0))
            want = torch.nn.functional.max_pool1d(
                torch.from_numpy(logical(block, "s3", 32)), 3, 2).numpy()
            checks.append(("max-pool", logical(block, "x32", 32), want))
            r = np.arange(lay.ROWS)[:, None]
            block.zero("y32", (r * lay.P32 + np.array([0, 72, 73, 74, 75])
                               ).reshape(-1), 32)
            block.zero("planes", (r * lay.P64 + np.array(
                [0, 36, 37, lay.ODD + 36, lay.ODD + 37])).reshape(-1), 32)
        if i == 8:
            halo = (np.arange(lay.ROWS)[:, None] * lay.P64
                    + np.array([0, lay.P64 - 1])).reshape(-1)
            block.zero("y64", halo, 64)
            block.zero("x64", halo, 64)
    frames = logical(block, "x64", 64).transpose(0, 2, 1)
    return checks, frames


@pytest.fixture(scope="module", params=[("illumina", 6), ("pacbio_hp", 7)],
                ids=["C6", "C7"])
def modelled(request):
    name, c = request.param
    model = init_params(create_model(name), torch.Generator().manual_seed(4))
    folded = rc.fold_read_conv_weights(model.read_convolver0, "bf16")
    rng = np.random.RandomState(c)
    rows = rng.randint(0, 256, (NB, lay.L_IN, c)).astype(np.uint8)
    checks, frames = model_block(rows, folded, rng)
    return model, rows, folded, checks, frames


def test_every_conv_of_the_schedule_is_the_reference_conv(modelled):
    """Each of the 18 convs (and the max-pool), read through the kernel's
    descriptors from buffers that share regions with stale values, equals
    read_convolver_reference's conv on the same input, bit for bit."""
    _, _, _, checks, _ = modelled
    assert [c[0] for c in checks if c[0].startswith("conv")] == [
        f"conv {s[0]}" for s in lay.STEPS]
    for what, got, want in checks:
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def test_modelled_frames_and_sum_match_the_plain_version(modelled):
    """The modelled block's frames against read_convolver_reference, which
    sums in fp32 in another order: a sum that the two orders round to
    neighbouring bf16 values moves the later convs (bf16's chaos, PERF.md),
    so the frames are held within two bf16 ulps of their largest value
    (2^-6 of it), and well inside the plain bf16 version's distance from
    fp32; then the per-allele sum as the kernel's atomics take it (rows of
    one allele, row_valid weights; other alleles exactly 0)."""
    model, rows, folded, _, frames = modelled
    t = torch.from_numpy(rows)
    want = rc.read_convolver_reference(t, folded).numpy()
    fp32 = rc.read_convolver_reference(t, rc.fold_read_conv_weights(
        model.read_convolver0, "tf32x3")).numpy()
    bar = 2.0 ** -6 * np.abs(want).max()
    assert np.isfinite(frames).all() and frames.shape == (NB, lay.L_OUT, 64)
    assert np.abs(frames - want).max() <= min(bar, np.abs(want - fp32).max())
    valid = np.array([0.5, 2.0], np.float32)
    allele = torch.tensor([1, 1], dtype=torch.int32)
    got = np.zeros((3, lay.L_OUT, 64), np.float32)
    for r in range(NB):
        got[allele[r]] += valid[r] * frames[r]
    ref = rc.read_conv_reduce_reference(t, allele, torch.from_numpy(valid),
                                        folded, 3).numpy()
    assert not got[[0, 2]].any() and not ref[[0, 2]].any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5 * bar)


def test_buffers_fit_their_regions_and_live_ones_do_not_overlap():
    """Every buffer fits its region; the planes and x64 (read and written
    by the shortcut, both live in the stride-2 block) and y32 and the
    planes (the last 32-channel add reads one and writes the other) sit
    apart; the whole block fits one SM's 227 KB."""
    size = {"a": lay.REG_A, "b": lay.REG_B}
    ch = {"in": 8, "s1": 16, "s2": 16, "s3": 32, "x32": 32, "y32": 32,
          "planes": 32, "y64": 64, "x64": 64}
    span = {}
    for name, (region, off, positions) in lay.BUFFERS.items():
        span[name] = (region, off, off + ch[name] // 8 * positions * 16)
        assert span[name][2] <= size[region], name
    apart = lambda a, b: (span[a][0] != span[b][0] or span[a][2] <= span[b][1]
                          or span[b][2] <= span[a][1])
    for a, b in (("planes", "x64"), ("planes", "y32"), ("x32", "y32"),
                 ("x64", "y64"), ("s1", "s2"), ("s2", "s3"), ("x32", "s3")):
        assert apart(a, b), (a, b)
    assert lay.SMEM_BYTES <= 232448


@pytest.mark.parametrize("name", sorted(
    __import__("hello_tpu_torch.ops.read_conv_variants",
               fromlist=["VARIANTS"]).VARIANTS))
def test_variant_substitutions_apply_to_the_sources(name):
    """read_conv_variants' source edits still find their text in the
    route's sources (each variant changes them; ``base`` leaves them)."""
    from hello_tpu_torch.ops import read_conv_variants as rv

    texts = rv.variant_sources(name)
    base = rv.variant_sources("base")
    assert set(texts) == {"read_conv.cu", "read_conv_wgmma.cuh"}
    assert (texts != base) == bool(rv.VARIANTS[name][1])
