"""The tensor-core read-conv kernel's fold and arithmetic, on the CPU.

The CUDA kernel's TF32 routes (hello_tpu_torch/ops/csrc/read_conv_wgmma_tf32.cuh)
compute every conv as 3xTF32 wgmma products from a weight buffer that the
fold packs as the B operand's shared-memory image, one tap at a time.
Neither runs here, so these tests hold the two things the kernel's
accuracy rests on:

* the fold: the flat buffer unpacks back to the folded ``W [Co, K*Ci]`` and
  ``b`` of all 18 convs, its ``big`` and ``small`` images are TF32 values
  (low 13 mantissa bits zero) rounded as ``cvt.rna.tf32.f32`` rounds, and
  ``big + small`` is ``W`` to within 2^-21 relative;
* the arithmetic: every conv of the plain version run as the kernel runs it
  (each operand split into TF32 big and small parts, small*big + big*small +
  big*big accumulated in fp32) stays within the kernel's tolerance of the
  fp32 plain version, rtol 1e-4 / atol 1e-3.

TF32 rounding is emulated here with integer arithmetic on the fp32 bits,
independently of the package.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-3
CONFIGS = [("illumina", 6), ("pacbio_hp", 7)]


def tf32_rna(x):
    """fp32 -> TF32, round to nearest with ties away from zero (PTX
    ``cvt.rna.tf32.f32``) on the bits: add half of the dropped range to the
    magnitude, clear the 13 low mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def folded(name, seed):
    model = init_params(create_model(name), torch.Generator().manual_seed(seed))
    return rc.fold_read_conv_weights(model.read_convolver0)


def image_to_w(image, co, kc, kp):
    """A TF32 B image [K/4][Co][4] (K in the kernel's order) -> W [Co, Kp]
    in the conv's own K order: column j of W is K position ``order[j]`` of
    the image, where the kernel gives lane t of a k-step the columns t and
    t + 4 from one load (within 16 channels of a tap, k-step 2 j + h,
    column t (t + 4) holds channel 16 j + 4 t + 2 h (+ 1); stem conv 1 at
    tap s, column t (t + 4) channel 2 t (+ 1) of its 8); the K positions
    that hold no channel (stem conv 1 past C) come last."""
    m = image.reshape(kp // 4, co, 4).transpose(1, 0, 2).reshape(co, kp)
    if kc % 16:
        c = kc // 3
        k = np.arange(8)
        ch = 2 * (k % 4) + k // 4
        src = np.where(ch < c, np.arange(3)[:, None] * c + ch, -1).reshape(-1)
    else:
        j = np.arange(kc)
        src = 16 * (j // 16) + 4 * (j % 4) + 2 * ((j % 16) // 8) + (j % 8) // 4
    order = np.concatenate([np.argsort(np.where(src >= 0, src, kp))[:kc],
                            np.flatnonzero(src < 0)])
    assert sorted(src[order[:kc]]) == list(range(kc))
    return m[:, order]


def unpack(flat, convs):
    """The kernel's buffer -> [(big [Co, Kp], small [Co, Kp], b [Co])]: per
    conv, its units of one tap (stem conv 1 and the 1x1 shortcut: one),
    each the big image then the small image [K/4][Co][4] of its K rows,
    then the bias."""
    out, off = [], 0
    for w, _ in convs:
        co, kc = w.shape
        kp = -(-kc // 8) * 8
        units = 1 if kc % 16 or kc == 32 else 3
        n = 2 * co * kp
        parts = flat[off:off + n].reshape(units, 2, -1)
        halves = [image_to_w(parts[:, h].reshape(-1), co, kc, kp)
                  for h in range(2)]
        out.append((halves[0], halves[1], flat[off + n:off + n + co]))
        off += n + co
    assert off == len(flat)
    return out


@pytest.mark.parametrize("name,C", CONFIGS)
def test_fold_round_trip(name, C):
    f = folded(name, 0)
    flat = f.flat.numpy()
    assert flat.size == rc.num_weight_floats(C) and f.in_channels == C
    parts = unpack(flat, f.convs)
    assert len(parts) == rc.NUM_CONVS == 18
    for (w, b), (big, small, bias) in zip(f.convs, parts):
        w = w.numpy()
        co, kc = w.shape
        assert big.shape == (co, -(-kc // 8) * 8)
        # K is zero-padded to a multiple of 8 (stem conv 1: 3C -> 24)
        assert not big[:, kc:].any() and not small[:, kc:].any()
        big, small = big[:, :kc], small[:, :kc]
        np.testing.assert_array_equal(bias, b.numpy())
        for half in (big, small):
            assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()
        # the fold rounds as cvt.rna does: big = tf32(W), small = tf32(W - big)
        want_big, want_small = split(w)
        np.testing.assert_array_equal(big, want_big)
        np.testing.assert_array_equal(small, want_small)
        err = np.abs(w.astype(np.float64) - big.astype(np.float64) - small)
        assert (err <= 2.0 ** -21 * np.abs(w)).all()


def test_tf32_round_matches_rna_on_ties_and_signs():
    """The package's fold-time rounding is cvt.rna's, ties away from zero
    included, for both signs."""
    rng = np.random.RandomState(7)
    bits = rng.randint(0x00800000, 0x7F000000, 4096).astype(np.uint32)
    bits[:1024] = (bits[:1024] & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    x = bits.view(np.float32) * np.where(np.arange(4096) % 2, 1, -1).astype(
        np.float32)
    got = rc.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, tf32_rna(x))
    ties = np.abs(x[:1024].astype(np.float64))
    assert (np.abs(got[:1024].astype(np.float64)) > ties).all()


def conv_tf32(passes):
    """The plain version's conv with each product as the kernel computes it:
    3 passes (small*big + big*small + big*big, fp32 accumulation) or a single
    TF32 pass."""
    def conv(x, w, b, stride=1, padding=0):
        co, kc = w.shape
        ci = x.shape[1]
        wt = w.reshape(co, kc // ci, ci).permute(0, 2, 1)
        xb, xs = (torch.from_numpy(t) for t in split(x.numpy()))
        wb, ws = (torch.from_numpy(t) for t in split(wt.contiguous().numpy()))
        c = lambda xx, ww: F.conv1d(xx, ww, None, stride=stride, padding=padding)
        y = c(xb, wb) if passes == 1 else (c(xs, wb) + c(xb, ws)) + c(xb, wb)
        return y + b[None, :, None]
    return conv


def packed_rows(C, seed):
    """Packed rows with padding rows: alleles with 3, 1, 0 and 4 rows."""
    rng = np.random.RandomState(seed)
    counts = [3, 1, 0, 4]
    A = len(counts)
    row_allele = np.concatenate([np.full(c, a, np.int32)
                                 for a, c in enumerate(counts)]
                                + [np.full(2, A, np.int32)])
    rows = rng.randint(0, 256, (len(row_allele), 150, C)).astype(np.uint8)
    row_valid = (row_allele < A).astype(np.float32)
    return (torch.from_numpy(rows), torch.from_numpy(row_allele),
            torch.from_numpy(row_valid), A)


def reduced(f, rows, row_allele, row_valid, A, monkeypatch, passes=None):
    with monkeypatch.context() as m:
        if passes is not None:
            m.setattr(rc, "_conv", conv_tf32(passes))
        with torch.no_grad():
            return rc.read_conv_reduce_reference(rows, row_allele, row_valid,
                                                 f, A).numpy()


@pytest.mark.parametrize("name,C", CONFIGS)
def test_3xtf32_reduced_frames_within_tolerance(name, C, monkeypatch):
    """All 18 convs in 3xTF32 keep the reduced frames of the illumina (C = 6)
    and pacbio_hp (C = 7) convolvers within rtol 1e-4 / atol 1e-3 of fp32."""
    f = folded(name, 1)
    args = packed_rows(C, 2)
    want = reduced(f, *args, monkeypatch)
    got = reduced(f, *args, monkeypatch, passes=3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[2].any()                 # the allele with no rows


def test_single_tf32_pass_is_far_less_accurate(monkeypatch):
    """Why three passes: one TF32 pass errs by orders of magnitude more than
    three on the same inputs (the emulation rounds where the card does)."""
    f = folded("illumina", 1)
    args = packed_rows(6, 2)
    want = reduced(f, *args, monkeypatch)
    err3 = np.abs(reduced(f, *args, monkeypatch, passes=3) - want).max()
    err1 = np.abs(reduced(f, *args, monkeypatch, passes=1) - want).max()
    assert err1 > 30 * err3
