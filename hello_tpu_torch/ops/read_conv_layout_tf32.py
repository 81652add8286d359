"""The TF32 routes' shared-memory layout, A fragments and B descriptors, in
numpy.

``csrc/read_conv_wgmma_tf32.cuh`` keeps its activations as fp32 in
position-major buffers [position][channels] whose 16-byte chunks of 4
channels are XOR-swizzled by the position's parity (``at``), loads each
warp's A fragments of a wgmma m64nNk8 tf32 product from them with plain
shared loads (``load_a``, ``fragments_to_tile``), and reads B, the weights,
through no-swizzle K-major descriptors from the fold's image of one unit
(a tap) in a stage (``b_tile``).  This module states that layout once more
for the host: the buffers and regions, the swizzle, each lane's loads and
what the register fragment means, the weight units of the flat buffer, and
the schedule.  The CPU tests run the whole kernel on it
(``tests/test_torch_read_conv_wgmma_tf32_layout.py``); ``chip_smoke.py``'s
probe lays out buffers with it and holds wgmma tiles on the card to the
products it says.  The constants mirror the header's.
"""

from __future__ import annotations

import numpy as np

ROWS = 5                  # read rows per block
TILE = 64                 # positions per wgmma tile (M)
WARPGROUPS = 3            # consumer warpgroups
THREADS = 128 * WARPGROUPS + 128  # and a producer warpgroup
L_IN, L_POOL, L_OUT = 150, 71, 36
P32, P64 = 76, 38         # row strides of the 32- and 64-channel buffers
SBO = 128                 # bytes between 8-row core-matrix groups


def tiles(pq: int, lo: int) -> int:
    """wgmma tiles of a conv whose outputs are q = r * pq + l, l < lo."""
    return -(-((ROWS - 1) * pq + lo) // TILE)


P_IN = tiles(L_IN, 148) * TILE + 2      # stem input, [pos][8]
P_S = tiles(L_IN, 146) * TILE + 2       # stem outputs
P32B = tiles(P32, L_POOL) * TILE + 2    # x32, y32
P64B = tiles(P64, L_OUT) * TILE + 2     # x64, y64

UNIT, STEM1, DOWN, SHORT = "unit", "stem1", "down", "short"

# Regions in floats: A (the input, stem conv 2's output, x32), B (stem conv
# 1's and 3's outputs, y32, then y64 and x64 after it); then the two weight
# stages (one tap of a 64-channel conv, big and small) and their full and
# empty mbarriers
REG_A = max(P_IN * 8, P_S * 16, P32B * 32)
REG_B = max(P_S * 32, P32B * 32, 2 * P64B * 64)
X64_OFF = P64B * 64
STAGE = 64 * 64 * 4 * 2
STAGES = 2
SMEM_BYTES = (REG_A + REG_B) * 4 + STAGES * STAGE + 2 * STAGES * 8

#: each buffer's (region, float offset, positions, channels)
BUFFERS = {"in": ("a", 0, P_IN, 8), "s1": ("b", 0, P_S, 16),
           "s2": ("a", 0, P_S, 16), "s3": ("b", 0, P_S, 32),
           "x32": ("a", 0, P32B, 32), "y32": ("b", 0, P32B, 32),
           "y64": ("b", 0, P64B, 64), "x64": ("b", X64_OFF, P64B, 64)}


def at(ci: int, pos, ch):
    """Float index of (position, channel) in a [position][ci] buffer: the
    16-byte chunk ch // 4 XOR 4 x the position's parity when ci >= 32."""
    pos, ch = np.asarray(pos), np.asarray(ch)
    swz = (pos & 1) << 2 if ci >= 32 else 0
    return pos * ci + (((ch >> 2) ^ swz) << 2) + (ch & 3)


def lay_out(x: np.ndarray, positions: int) -> np.ndarray:
    """Channels x positions (``x.shape[1] <= positions``) -> a buffer's
    floats: [position][8] for up to 8 channels (the stem's input, zeros
    past its channels), else [position][channels] swizzled by ``at``."""
    c, n = x.shape
    ci = 8 if c <= 8 else c
    buf = np.zeros(positions * ci, np.float32)
    pos, ch = np.meshgrid(np.arange(n), np.arange(c))
    buf[at(ci, pos, ch)] = x
    return buf


def in_pos(kind: str, p, tap: int):
    """The input position that output position p reads at tap ``tap``."""
    p = np.asarray(p)
    return 2 * p + tap if kind == DOWN else 2 * p + 1 if kind == SHORT else p + tap


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """fp32 -> TF32, to nearest with ties away from zero (``cvt.rna``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def load_a(buf: np.ndarray, kind: str, ci: int, tile: int, tap: int, s: int):
    """What each lane of the warpgroup loads for k-step ``s`` (within the
    unit) of tile ``tile``: [warp 4][lane 32][a0..a3], fp32 (the kernel
    rounds after loading).  Lane 4 g + t of warp w holds rows p = tile * 64
    + 16 w + g and p + 8: one 16-byte load per row, channels 16 j + 4 t ..
    + 3 at in_pos(p, tap) (j = s // 2), k-step 2 j + h taking a0, a2 =
    the row's channels 2 h, 2 h + 1 of those four and a1, a3 the next
    row's; stem conv 1 one 8-byte load per row, channels 2 t and 2 t + 1
    at position p + s."""
    w = np.arange(4)[:, None]
    lane = np.arange(32)[None, :]
    g, t = lane // 4, lane % 4
    p = tile * TILE + 16 * w + g
    if kind == STEM1:
        lo = buf[(p + s)[..., None] * 8 + 2 * t[..., None] + np.arange(2)]
        hi = buf[(p + 8 + s)[..., None] * 8 + 2 * t[..., None] + np.arange(2)]
        return np.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]], -1)
    ch = 8 * (s - s % 2) + 4 * t
    lo = buf[at(ci, in_pos(kind, p, tap)[..., None], ch[..., None] + np.arange(4))]
    hi = buf[at(ci, in_pos(kind, p + 8, tap)[..., None], ch[..., None] + np.arange(4))]
    h = s % 2
    return np.stack([lo[..., 2 * h], hi[..., 2 * h], lo[..., 2 * h + 1],
                     hi[..., 2 * h + 1]], -1)


def fragments_to_tile(frag: np.ndarray) -> np.ndarray:
    """[warp][lane][a0..a3] -> A [64][8] as the m64nNk8 tf32 register
    fragment means it: lane 4 g + t of warp w holds (row, col) = (16 w + g,
    t), (16 w + g + 8, t), (16 w + g, t + 4), (16 w + g + 8, t + 4)."""
    w, lane, e = np.meshgrid(np.arange(4), np.arange(32), np.arange(4),
                             indexing="ij")
    a = np.zeros((TILE, 8), frag.dtype)
    a[16 * w + lane // 4 + 8 * (e % 2), lane % 4 + 4 * (e // 2)] = frag
    return a


def b_tile(image: np.ndarray, co: int, s: int) -> np.ndarray:
    """B [8][Co] of k-step ``s`` read through the unit image's descriptor
    (start s x 2 Co x 16 bytes, LBO Co x 16 bytes, SBO 128): element (k, n)
    at byte start + (n // 8) SBO + (n % 8) 16 + (k // 4) LBO + (k % 4) 4."""
    k = np.arange(8)[:, None]
    n = np.arange(co)[None, :]
    at_byte = (s * 2 * co * 16 + (n // 8) * SBO + (n % 8) * 16
               + (k // 4) * co * 16 + (k % 4) * 4)
    return image.view(np.float32)[at_byte // 4]


# The fold's 18 convs: K as the products take it, Co, units (taps) they
# are streamed in; the flat buffer holds per conv its units (K / units x Co
# floats of image, big then, for 3 passes, small), then Co floats of bias
CONV_K = (24, 48, 48) + (96,) * 7 + (192, 32) + (192,) * 6
CONV_CO = (16, 16) + (32,) * 7 + (64,) * 9
CONV_UNITS = tuple(1 if i in (0, 11) else 3 for i in range(18))


def parts(passes: int) -> int:
    """Images of B per unit: big and small (3 passes), or big."""
    return 2 if passes == 3 else 1


def conv_off(i: int, passes: int) -> int:
    """Float offset of conv i in the flat buffer."""
    return sum(CONV_K[j] * CONV_CO[j] * parts(passes) + CONV_CO[j]
               for j in range(i))


def unit_images(flat: np.ndarray, i: int, passes: int):
    """Conv i's units as [(big image, small image or None)] (float32
    arrays, as a stage holds them), and its bias."""
    co, units = CONV_CO[i], CONV_UNITS[i]
    n = CONV_K[i] // units * co
    m = n * parts(passes)
    off = conv_off(i, passes)
    out = []
    for u in range(units):
        unit = flat[off + u * m:off + (u + 1) * m]
        out.append((unit[:n], unit[n:] if passes == 3 else None))
    bias = flat[off + units * m:off + units * m + co]
    return out, bias


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
    (8, UNIT, "y32", "x32", _RB32, "relu_add"),
    (9, DOWN, "x32", "y64", _RB64, "relu"),
    (11, SHORT, "x32", "x64", _RB64, "linear"),
    (10, UNIT, "y64", "x64", _RB64, "relu_add"),
    (12, UNIT, "x64", "y64", _RB64, "relu"),
    (13, UNIT, "y64", "x64", _RB64, "relu_add"),
    (14, UNIT, "x64", "y64", _RB64, "relu"),
    (15, UNIT, "y64", "x64", _RB64, "relu_add"),
    (16, UNIT, "x64", "y64", _RB64, "relu"),
    (17, UNIT, "y64", "x64", _RB64, "relu_add"),
)
