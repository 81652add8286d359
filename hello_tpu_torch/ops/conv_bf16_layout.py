"""The addressing of ``csrc/conv_bf16.cu``, stated once more in numpy.

The kernel runs only on the card.  This module mirrors what each of its
threads does with addresses, so the CPU tests can run the kernel's whole
schedule (``tests/test_torch_conv_bf16_layout.py``): which A row and which
8-value chunks of K a thread copies into a stage (its output position's
image ``n`` and first input position, each chunk's tap and channel, the
zero fill past the input's ends, past M and past K), the gather used where
Ci is not a multiple of 8, where each chunk lands in the stage ([rows][64]
bf16 in the 128-byte swizzle), what the swizzled K-major wgmma descriptors
of each warpgroup and k-step read back, and where the epilogue puts each
accumulator of the m64nNk16 fragment and copies the tile out.  The constants mirror the kernel's;
the weight's layout is ``conv_bf16.pack_weight`` itself.
"""

from __future__ import annotations

import numpy as np
import torch

from . import conv_bf16 as cb
from .conv_bf16 import BK, STAGES

AHEAD = STAGES - 1         # K blocks loaded ahead of the products


def bits(t) -> np.ndarray:
    """bf16 torch tensor -> its bits, uint16 numpy."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def values(b: np.ndarray) -> np.ndarray:
    """bf16 bits -> float32 values."""
    return (b.astype(np.uint32) << 16).view(np.float32)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, to nearest even (``__floats2bfloat162_rn``)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


class Conv:
    """The kernel's ``Conv`` arguments for x [n, lin, ci] and a weight of
    ``k`` taps and ``co`` output channels."""

    def __init__(self, n, lin, ci, co, k, stride, pad, dil, lout):
        self.n, self.lin, self.ci, self.co, self.k = n, lin, ci, co, k
        self.stride, self.pad, self.dil, self.lout = stride, pad, dil, lout
        self.m = n * lout
        self.kc = k * ci
        self.vec = ci % 8 == 0


def a_rows(bm: int, m0: int, conv: Conv):
    """Per thread and copy i < 4: its A row tid / 8 + i bm / 4 (the threads
    copy bm / 4 rows at once, 8 threads a row), whether that position is an
    output, its image's first element in x and its first tap's input
    position (the kernel's ARows).  [threads, 4] each."""
    tid = np.arange(2 * bm)[:, None]
    row = tid // 8 + np.arange(4)[None, :] * (bm // 4)
    m = m0 + row
    mok = m < conv.m
    img = np.where(mok, m // conv.lout, 0)
    pos0 = np.where(mok, m - img * conv.lout, 0) * conv.stride - conv.pad
    return row, mok, img * conv.lin * conv.ci, pos0


def swizzled(r, c):
    """Byte offset of 16-byte chunk ``c`` of row ``r`` in a stage's A or B
    image: 128-byte rows, chunk c at c ^ (r % 8) (the 128-byte swizzle)."""
    return r * 128 + ((c ^ (r % 8)) << 4)


def a_chunk(xb, conv: Conv, k, xrow, pos0, mok):
    """The 8 values (bits) that a thread copies for one A row at K column
    ``k`` (its chunk's first): one 16-byte copy of 8 channels of one tap
    where Ci % 8 == 0 (zero filled where the tap's position lies outside
    the input, past M or past K), the kernel's ``a_value`` gather
    otherwise.  [threads, 8]."""
    if conv.vec:
        t = k // conv.ci
        pos = pos0 + t * conv.dil
        ok = mok & (k < conv.kc) & (pos >= 0) & (pos < conv.lin)
        src = np.where(ok, xrow + pos * conv.ci + (k - t * conv.ci), 0)
        got = xb[src[:, None] + np.arange(8)[None, :]]
        return np.where(ok[:, None], got, 0)
    ks = k[:, None] + np.arange(8)[None, :]
    t = ks // conv.ci
    pos = pos0[:, None] + t * conv.dil
    ok = mok[:, None] & (ks < conv.kc) & (pos >= 0) & (pos < conv.lin)
    src = np.where(ok, xrow[:, None] + pos * conv.ci + (ks - t * conv.ci), 0)
    return np.where(ok, xb[src], 0)


def b_chunk(wb, conv: Conv, k, n0, n):
    """The 8 values (bits) of B row ``n`` at K column ``k``: w's row n0 + n
    from column k, zero past Co and past K.  [len(n), 8]."""
    ks = k[:, None] + np.arange(8)[None, :]
    ok = (n0 + n < conv.co)[:, None] & (ks < conv.kc)
    src = np.where(ok, (n0 + n)[:, None] * conv.kc + ks, 0)
    return np.where(ok, wb[src], 0)


def load_block(stage, xb, wb, conv: Conv, bm, bn, m0, n0, kb):
    """The kernel's ``load_block``: thread tid copies chunk c = tid % 8 (K
    columns kb * 64 + 8 c ..) of its 4 A rows and of B rows tid / 8 + j
    bm / 4 (those below bn), each 16 bytes at ``swizzled(row, c)`` of the
    A or the B image of ``stage`` (uint16, A then B)."""
    rows, mok, xrow, pos0 = a_rows(bm, m0, conv)
    tid = np.arange(2 * bm)
    c = tid % 8
    k = kb * BK + 8 * c
    eight = np.arange(8)[None, :]
    for i in range(4):
        at = swizzled(rows[:, i], c) // 2
        stage[at[:, None] + eight] = a_chunk(xb, conv, k, xrow[:, i],
                                             pos0[:, i], mok[:, i])
    for j in range(-(-bn // (bm // 4))):
        n = tid // 8 + j * (bm // 4)
        own = n < bn
        at = (bm * BK * 2 + swizzled(n[own], c[own])) // 2
        stage[at[:, None] + eight] = b_chunk(wb, conv, k[own], n0, n[own])


def read_tile(stage, start: int, rows: int) -> np.ndarray:
    """What a K-major descriptor in the 128-byte swizzle (start, SBO = 1024
    bytes, on a 1024-byte aligned image) reads as a [rows][16] bf16
    operand: element (r, k) at byte a = start + (r // 8) SBO + (r % 8) 128 +
    (k // 8) 16 + (k % 8) 2, with bits 4-6 of a exchanged for their XOR
    with bits 7-9."""
    r = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    at = start + (r // 8) * 1024 + (r % 8) * 128 + (k // 8) * 16 + (k % 8) * 2
    at = at ^ (((at >> 7) & 7) << 4)
    return stage[at // 2]


def fragment(tid, i):
    """(row, column) of the 64 x N product that accumulator ``i`` of thread
    ``tid`` of a warpgroup holds after wgmma m64nNk16 with an f32 D (the PTX
    ISA's layout): row 16 warp + 8 (i % 4 // 2) + lane / 4, column 8 (i /
    4) + 2 (lane % 4) + i % 2."""
    warp, lane = tid // 32, tid % 32
    return (16 * warp + 8 * (i % 4 // 2) + lane // 4,
            8 * (i // 4) + 2 * (lane % 4) + i % 2)


def epilogue(tid, j, h, e, wg, bn):
    """Where the kernel's epilogue puts accumulator 4 j + 2 h + e of thread
    ``tid`` of warpgroup ``wg``, rounded: the byte of the [BM][BN] bf16
    tile (rows BN * 2 + 16 bytes apart) at row 64 wg + 16 warp + lane / 4
    + 8 h, channel 8 j + 2 (lane % 4) + e."""
    warp, lane = tid // 32, tid % 32
    r = wg * 64 + warp * 16 + lane // 4 + 8 * h
    return r * (bn * 2 + 16) + (8 * j + 2 * (lane % 4) + e) * 2


def copy_out(i, bn):
    """Tile row and first channel of the epilogue's 16-byte chunk ``i``
    (thread i % threads copies it): row i / (BN / 8), channel 8 (i %
    (BN / 8)), from byte row * (BN * 2 + 16) + 2 channel of the tile."""
    r, c = i // (bn // 8), 8 * (i % (bn // 8))
    return r, c, r * (bn * 2 + 16) + 2 * c


def run(x, w, b, stride=1, padding=0, dilation=1, tile=None):
    """The kernel's whole schedule on x bf16 [N, L, Ci], w [Co, Ci, K] and
    b fp32 [Co] or None: every block of the grid, its ring of stages filled
    with stale values first, each K block loaded AHEAD blocks before its
    products into stage kb % STAGES, each warpgroup's products of a
    k-step read through its descriptors and summed (float64: bf16 products
    are exact), each k-step's sum added to the fp32 sum in k order, the
    fp32 sum plus the fp32 bias rounded to bf16 once into the
    epilogue's tile where the fragment's thread puts it, and the tile
    copied out in 16-byte row chunks.  Returns bf16 [N, Lout, Co]."""
    n, lin, ci = x.shape
    co, _, k = w.shape
    lout = cb.out_length(lin, k, stride, padding, dilation)
    conv = Conv(n, lin, ci, co, k, stride, padding, dilation, lout)
    bm, bn = cb.tile_for(conv.m, co) if tile is None else tile
    xb = bits(x).reshape(-1)
    wb = bits(cb.pack_weight(w)).reshape(-1)
    bias = (np.zeros(co, np.float32) if b is None
            else b.detach().numpy().astype(np.float32))
    y = np.full(conv.m * co, 0xFFFF, np.uint16)       # never a bf16 answer
    nkb = -(-conv.kc // BK)
    stage_halves = (bm + bn) * BK
    rng = np.random.default_rng(0)
    tid = np.arange(128)[:, None, None, None]
    j = np.arange(bn // 8)[None, :, None, None]
    h = np.arange(2)[None, None, :, None]
    e = np.arange(2)[None, None, None, :]
    frow, fcol = fragment(tid, 4 * j + 2 * h + e)
    for m0 in range(0, conv.m, bm):
        for n0 in range(0, co, bn):
            ring = rng.integers(0, 2 ** 16, (STAGES, stage_halves),
                                dtype=np.uint16)
            for s in range(min(AHEAD, nkb)):
                load_block(ring[s], xb, wb, conv, bm, bn, m0, n0, s)
            acc = np.zeros((bm // 64, 64, bn), np.float32)
            for kb in range(nkb):
                if kb + AHEAD < nkb:
                    load_block(ring[(kb + AHEAD) % STAGES], xb, wb, conv, bm,
                               bn, m0, n0, kb + AHEAD)
                stage = ring[kb % STAGES]
                for wg in range(bm // 64):
                    for s in range(BK // 16):
                        a = read_tile(stage, wg * 64 * 128 + 32 * s, 64)
                        bt = read_tile(stage, bm * BK * 2 + 32 * s, bn)
                        acc[wg] += (values(a).astype(np.float64) @ values(
                            bt).astype(np.float64).T).astype(np.float32)
            tile = np.zeros(bm * (bn * 2 + 16) // 2, np.uint16)
            for wg in range(bm // 64):
                col = n0 + fcol
                v = acc[wg][frow, fcol].astype(np.float32) + np.where(
                    col < co, bias[np.minimum(col, co - 1)], 0)
                at = epilogue(tid, j, h, e, wg, bn) // 2
                tile[at] = to_bf16(v)
            r, c, at = copy_out(np.arange(bm * bn // 8), bn)
            ok = (m0 + r < conv.m) & (n0 + c < co)
            dst = ((m0 + r) * co + n0 + c)[ok]
            y[dst[:, None] + np.arange(8)[None, :]] = \
                tile[at[ok][:, None] // 2 + np.arange(8)[None, :]]
    return torch.from_numpy(y.view(np.int16).copy()).view(
        torch.bfloat16).reshape(n, lout, co)
