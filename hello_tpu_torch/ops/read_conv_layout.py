"""The bf16 route's shared-memory layout and wgmma descriptors, in numpy.

``csrc/read_conv_wgmma.cuh`` keeps its activations as bf16 in buffers laid
out [channel group of 8][position][8 channels], and reads each conv's A
operand through no-swizzle K-major wgmma descriptors.  This module states
that layout once more for the host: the buffers' sizes, the byte offset of
each k-step's A tile, the even / odd planes of the stride-2 block, the
stem's [position][8] input, and what a descriptor reads.  The CPU tests
run the whole kernel on it (``tests/test_torch_read_conv_wgmma_layout.py``);
``chip_smoke.py``'s probe lays out buffers with it and holds one wgmma tile
on the card to the product it says.  The constants mirror the header's.
"""

from __future__ import annotations

import numpy as np

ROWS = 5                  # read rows per block
TILE = 64                 # positions per wgmma tile (M)
L_IN, L_POOL, L_OUT = 150, 71, 36
P32, P64 = 76, 38         # row strides of the 32- and 64-channel buffers
ODD = 192                 # the odd plane's first position
SBO = 128                 # bytes between 8-row core-matrix groups


def tiles(pq: int, lo: int) -> int:
    """wgmma tiles of a conv whose outputs are q = r * pq + l, l < lo."""
    return -(-((ROWS - 1) * pq + lo) // TILE)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


P_IN = _round8(tiles(L_IN, 148) * TILE + 3)     # stem input, [pos][8]
P_S = _round8(tiles(L_IN, 146) * TILE + 2)      # stem outputs
P32B = _round8(tiles(P32, L_POOL) * TILE + 2)   # x32, y32
P_PL = ODD + tiles(P64, L_OUT) * TILE           # even | odd planes
P64B = _round8(tiles(P64, L_OUT) * TILE + 2)    # x64, y64

UNIT, STEM1, DOWN, SHORT = "unit", "stem1", "down", "short"


def a_lbo(kind: str, positions: int) -> int:
    """LBO of a conv's A descriptor: the buffer's channel-group stride, or
    one position for stem conv 1 (its two core matrices are two taps)."""
    return 16 if kind == STEM1 else positions * 16


def a_offset(kind: str, ci: int, lbo: int, s: int) -> int:
    """Byte offset of k-step ``s``'s A tile from the tile's first position:
    tap t of a stride-1 conv t positions on, channel pair j two groups on;
    stem conv 1 taps 2s and 2s + 1; the stride-2 conv's taps on the even
    plane, the odd plane and the even plane one on; the shortcut's on the
    odd plane."""
    if kind == STEM1:
        return 2 * s * 16
    if kind == SHORT:
        return ODD * 16 + 2 * s * lbo
    if kind == DOWN:
        tap, j = divmod(s, 2)
        return (0, ODD, 1)[tap] * 16 + 2 * j * lbo
    tap, j = divmod(s, ci // 16)
    return tap * 16 + 2 * j * lbo


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """bf16-valued float32 -> their 16 bits (the value must be bf16)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    if (bits & 0xFFFF).any():
        raise ValueError("values are not bf16")
    return (bits >> 16).astype(np.uint16)


def from_bf16_bits(h: np.ndarray) -> np.ndarray:
    return (h.astype(np.uint32) << 16).view(np.float32)


def lay_out(x: np.ndarray, positions: int) -> np.ndarray:
    """Channels x positions (bf16 values, ``x.shape[1] <= positions``) ->
    the buffer's bytes, [channel group][position][8]; channels pad to a
    multiple of 8 and positions to ``positions`` with zeros."""
    c, n = x.shape
    buf = np.zeros((-(-c // 8) * 8, positions), np.float32)
    buf[:c, :n] = x
    groups = buf.reshape(-1, 8, positions).transpose(0, 2, 1)
    return to_bf16_bits(groups).reshape(-1).view(np.uint8)


def read_tile(buf: np.ndarray, start: int, lbo: int, rows: int) -> np.ndarray:
    """What a no-swizzle K-major descriptor (start, LBO, SBO = 128) reads:
    ``rows`` x 16 values, element (m, k) at byte start + (m // 8) SBO +
    (m % 8) 16 + (k // 8) LBO + (k % 8) 2.  Rows are A's positions or B's
    output channels."""
    m = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    at = start + (m // 8) * SBO + (m % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    h = buf.view(np.uint16)[at // 2]
    return from_bf16_bits(h).astype(np.float64)


def b_tile(image: np.ndarray, co: int, s: int) -> np.ndarray:
    """B [16][Co] of k-step ``s`` from a conv's image (``pack_conv``'s bf16
    bytes): LBO Co x 16 bytes, the k-step 2 Co x 16 bytes on."""
    return read_tile(image, s * 2 * co * 16, co * 16, co).T


def to_planes(x: np.ndarray) -> np.ndarray:
    """x [C][ROWS * P32] (padded rows: halo, 71, halo, 3 spare) -> the even
    and odd planes [C][P_PL]: even[r * 38 + i] = x[r * 76 + 2 i], odd at ODD
    + r * 38 + i = x[r * 76 + 2 i + 1]."""
    c = x.shape[0]
    rows = x.reshape(c, ROWS, P32)
    out = np.zeros((c, P_PL), np.float32)
    out[:, :ROWS * P64] = rows[:, :, 0::2].reshape(c, -1)
    out[:, ODD:ODD + ROWS * P64] = rows[:, :, 1::2].reshape(c, -1)
    return out


def _buf_bytes(channels: int, positions: int) -> int:
    return channels // 8 * positions * 16


# Shared memory: region A (the input, stem conv 2's output, x32, y64),
# region B (stem conv 1's and 3's outputs, then the planes | y32, then x64
# past the planes), the ring of weight stages (each holds the largest conv:
# 192 x 64 bf16 and its bias) and an mbarrier for each
REG_A = max(_buf_bytes(8, P_IN), _buf_bytes(16, P_S), _buf_bytes(32, P32B),
            _buf_bytes(64, P64B))
PLANES_OFF = 0
Y32_OFF = X64_OFF = _buf_bytes(32, P_PL)
REG_B = max(_buf_bytes(32, P_S), Y32_OFF + _buf_bytes(32, P32B),
            X64_OFF + _buf_bytes(64, P64B))
STAGE = 192 * 64 * 2 + 64 * 4
STAGES = 2
SMEM_BYTES = REG_A + REG_B + STAGES * (STAGE + 8)

#: each buffer's (region, byte offset, positions per channel group)
BUFFERS = {"in": ("a", 0, P_IN), "s1": ("b", 0, P_S), "s2": ("a", 0, P_S),
           "s3": ("b", 0, P_S), "x32": ("a", 0, P32B),
           "y32": ("b", Y32_OFF, P32B), "planes": ("b", PLANES_OFF, P_PL),
           "y64": ("a", 0, P64B), "x64": ("b", X64_OFF, P64B)}

_RB32 = (P32, L_POOL, 1)
_RB64 = (P64, L_OUT, 1)
#: the kernel's 18 convs in the order it runs them: (fold index, A kind,
#: input, output, (PQ, LO, OUT_OFF), epilogue); outputs q = r * PQ + l,
#: l < LO, stored at q + OUT_OFF
STEPS = (
    (0, STEM1, "in", "s1", (L_IN, 148, 0), "relu"),
    (1, UNIT, "s1", "s2", (L_IN, 146, 0), "relu"),
    (2, UNIT, "s2", "s3", (L_IN, 144, 0), "relu"),
    (3, UNIT, "x32", "y32", _RB32, "relu"),
    (4, UNIT, "y32", "x32", _RB32, "relu_add"),
    (5, UNIT, "x32", "y32", _RB32, "relu"),
    (6, UNIT, "y32", "x32", _RB32, "relu_add"),
    (7, UNIT, "x32", "y32", _RB32, "relu"),
    (8, UNIT, "y32", "planes", _RB32, "relu_add_planes"),
    (9, DOWN, "planes", "y64", _RB64, "relu"),
    (11, SHORT, "planes", "x64", _RB64, "linear"),
    (10, UNIT, "y64", "x64", _RB64, "relu_add"),
    (12, UNIT, "x64", "y64", _RB64, "relu"),
    (13, UNIT, "y64", "x64", _RB64, "relu_add"),
    (14, UNIT, "x64", "y64", _RB64, "relu"),
    (15, UNIT, "y64", "x64", _RB64, "relu_add"),
    (16, UNIT, "x64", "y64", _RB64, "relu"),
    (17, UNIT, "y64", "x64", _RB64, "relu_add"),
)
