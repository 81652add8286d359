"""Fused read convolver + per-allele reduction: a hand-written CUDA kernel.

The read convolver is the hot op of scoring: every read row ``[150, C]``
(C = 6, or 7 with the haplotag channel) runs through 18 weight-normed convs
(~10.1 MFLOP per row) and the per-row ``[36, 64]`` frames are then summed per
allele slot.  ``read_conv_reduce`` computes

    out[a] = sum over rows r with row_allele[r] == a of
             row_valid[r] * read_convolver(rows[r])          -> [A, 36, 64]

in one launch of ``csrc/read_conv.cu`` (CUDA C++ for sm_90a: ``wgmma``
tensor-core convs over 5 read rows per block, ``csrc/read_conv_wgmma_tf32.cuh``
for the TF32 routes and ``csrc/read_conv_wgmma.cuh`` for bf16, built with
``nvcc`` into ``ops/build/`` at first use and loaded with ctypes).  It
replaces the two Pallas TPU kernels of hello_tpu's ops/read_conv.py
(``_stem_kernel`` and ``_tail_kernel``) and the reduction after them, and
serves both read layouts
of the model: the packed rows of the coded wire and the dense ``[A, R]``
grid flattened to rows.

The kernel has three routes, one per precision class (``ROUTES``), chosen
when the weights are folded:

  * ``tf32x3`` (``highest``, ``high``): fp32-class products, 3xTF32;
  * ``tf32`` (``default``): one TF32 pass per product, XLA's DEFAULT on a
    GPU;
  * ``bf16`` (``bf16``): bf16 products accumulated in fp32, with the
    activations rounded to bf16 where the Pallas kernel's bf16
    ``compute_dtype`` rounds them: each conv's biased fp32 sum once, and
    each residual add's sum again.

The wide read convolver (HELLO's ``read_convolver_wide``: the same
topology with every channel count doubled, out ``[A, 36, 128]``) has a
kernel of its own at ``bf16`` (``csrc/read_conv_wgmma_wide.cuh``, the same
fold and weight layout at twice the width, and a per-allele sum in a fixed
order); at the other precisions it has no route, and the model runs it
through its layers.  ``FoldedReadConv.width`` says which kernel a fold
is for.

``read_conv_reduce_reference`` is the plain PyTorch version of the same
function and route (``F.conv1d`` / ``F.max_pool1d`` chain + ``index_add_``,
with the bf16 route's rounding points).  The wrapper takes it only for
tensors that lie on the CPU; a CUDA tensor goes to the kernel of its
route or raises.

Weights are folded once per parameter set and route
(``fold_read_conv_weights``): the weight norm is applied and each conv
becomes ``W[Co, K*Ci]`` (k-major, as hello_tpu's
``extract_read_conv_weights``; rounded to bf16 for the bf16 route) plus
``b[Co]``.  The kernel reads one flat buffer holding, per conv, ``W`` in the
route's layout (``pack_conv``: the wgmma B operand's shared-memory image,
in units of one tap for the TF32 routes), then ``b``.  The topology
gate (``check_read_convolver``) raises for a read convolver no kernel
implements in the route; ``supports_read_convolver`` asks the same question
without raising, as hello_tpu's ``supports_network``, and the model runs
such a read convolver through its layers (nn/moe.py, the layer route).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import telemetry
from ..nn import layers as L

# architecture constants (read_convolver for feature_length=150)
L_IN = 150
L_OUT = 36     # after the stride-2 residual block
C_OUT = 64     # at width 1; the wide read convolver's is 128
NUM_CONVS = 18

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "read_conv.cu")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

#: ROADMAP item of the kernel variants still missing (the addendum and
#: layer_norm read convolvers, and the wide one's TF32 routes, take the
#: layer route until then)
ROADMAP_VARIANTS = ("ROADMAP.md item 14: kernel variants of read_conv_reduce "
                    "for the addendum and layer_norm read convolvers, and "
                    "TF32 routes for the wide one")

#: kernel route of each precision (nn/layers.PRECISIONS), and the route's
#: number in the kernel's C interface
ROUTES = {"highest": "tf32x3", "high": "tf32x3", "default": "tf32",
          "bf16": "bf16"}
ROUTE_IDS = {"tf32x3": 0, "tf32": 1, "bf16": 2}
#: the widths of read convolver a kernel implements, and each one's routes
WIDTH_ROUTES = {1: tuple(ROUTE_IDS), 2: ("bf16",)}


def route_for_precision(precision: str) -> str:
    """The kernel route of a precision (raises for an unknown one)."""
    if precision not in ROUTES:
        raise ValueError(f"no read-conv kernel route for precision "
                         f"{precision!r}")
    return ROUTES[precision]


# expected (C_out, K*C_in) of every conv after the first, whose K*C_in
# depends on the 6/7 input channels (hello_tpu ops/read_conv.py:427-432)
_EXPECTED_TAIL_SHAPES = [
    (16, 48), (32, 48),                       # stem convs 2-3
    (32, 96), (32, 96), (32, 96), (32, 96), (32, 96), (32, 96),  # 3x RB32
    (64, 96), (64, 192), (64, 32),            # RBConv + shortcut
    (64, 192), (64, 192), (64, 192), (64, 192), (64, 192), (64, 192),  # 3x RB64
]
# (stride, padding, dilation, groups) of the 18 convs, in the same order
_EXPECTED_GEOMETRY = ([(1, 0, 1, 1)] * 3 + [(1, 1, 1, 1)] * 6
                      + [(2, 1, 1, 1), (1, 1, 1, 1), (2, 0, 1, 1)]
                      + [(1, 1, 1, 1)] * 6)


def conv_shapes(in_channels: int, width: int = 1) -> List[Tuple[int, int]]:
    """(C_out, K*C_in) of the 18 convs of a read convolver of ``width``
    (every channel count times ``width``; the first conv's K*C_in is 3 C)."""
    return [(16 * width, 3 * in_channels)] + [
        (co * width, kc * width) for co, kc in _EXPECTED_TAIL_SHAPES]


# ---------------------------------------------------------------------------
# Weight folding and the topology gate
# ---------------------------------------------------------------------------

def _effective_conv(layer) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W [Co, K*Ci] k-major, b [Co]) of one conv, weight norm applied."""
    if isinstance(layer, L.WeightNormedConv1d):
        w, b = layer.conv1d.weight(), layer.conv1d.bias
    else:
        w, b = layer.weight, layer.bias
    co, ci, k = w.shape
    return w.permute(0, 2, 1).reshape(co, k * ci), b


def _conv_layers(seq: L.Sequential):
    """The read convolver's conv layers in kernel order: stem conv1..3;
    3x RB_FT(32) (2 convs each); RB_Conv (conv1, conv2, shortcut);
    3x RB_FT(64)."""
    for layer in seq.network:
        if isinstance(layer, (L.Conv1d, L.WeightNormedConv1d)):
            yield layer
        elif isinstance(layer, L.ResidualBlock):
            for sub in list(layer.ffNetwork.network) + list(layer.shNetwork.network):
                if isinstance(sub, (L.Conv1d, L.WeightNormedConv1d)):
                    yield sub


def extract_read_conv_weights(seq: L.Sequential) -> List[torch.Tensor]:
    """The read convolver's effective conv weights in kernel order
    (``_conv_layers``).  Returns [w1, b1, w2, b2, ...]."""
    out: List[torch.Tensor] = []
    for layer in _conv_layers(seq):
        out.extend(_effective_conv(layer))
    return out


def _topology_matches(seq) -> bool:
    """The kernel hardcodes conv->ReLU with no norm layers: accept ONLY the
    weight-normed read_convolver's layer classes (a variant with other
    activations or norms can have identical conv shapes but other math)."""
    def ok_layers(layers):
        for layer in layers:
            if isinstance(layer, L.ResidualBlock):
                if not (ok_layers(layer.ffNetwork.network)
                        and ok_layers(layer.shNetwork.network)):
                    return False
            elif type(layer) not in (L.WeightNormedConv1d, L.ReLU,
                                     L.MaxPool1d, L.Noop):
                return False
        return True
    return ok_layers(seq.network)


def _width(shapes) -> Optional[int]:
    """The width (1 or 2) whose conv shapes ``shapes`` are, or None."""
    for width in WIDTH_ROUTES:
        if any(shapes == conv_shapes(c, width) for c in (6, 7)):
            return width
    return None


def read_convolver_width(seq: L.Sequential) -> Optional[int]:
    """The width (1 or 2) whose conv shapes ``seq``'s convs have, or None."""
    return _width([tuple(w.shape)
                   for w in extract_read_conv_weights(seq)[0::2]])


def check_read_convolver(seq: L.Sequential, route: Optional[str] = None):
    """Raise ValueError unless a kernel implements ``seq`` in ``route``
    (default: the route of the precision in force): the standard
    weight-normed read_convolver in every route, its wide variant (every
    channel count doubled) in ``bf16``.  The addendum, layer-norm and
    batch-norm variants, and the wide one in a TF32 route, are refused,
    never routed around the kernel."""
    route = route_for_precision(L.PRECISION) if route is None else route
    if not _topology_matches(seq):
        raise ValueError("read convolver has layers the CUDA kernel does not "
                         "implement (only WeightNormedConv1d/ReLU/MaxPool1d; "
                         f"{ROADMAP_VARIANTS})")
    ws = extract_read_conv_weights(seq)
    shapes = [tuple(w.shape) for w in ws[0::2]]
    width = _width(shapes)
    if width is None:
        raise ValueError(f"read convolver conv shapes {shapes} are neither "
                         "the width-1 nor the width-2 topology the CUDA "
                         f"kernels implement ({ROADMAP_VARIANTS})")
    if route not in WIDTH_ROUTES[width]:
        raise ValueError(f"the width-{width} read convolver has no kernel "
                         f"route {route!r} (it has {WIDTH_ROUTES[width]}; "
                         f"{ROADMAP_VARIANTS})")
    bias_free = [i for i, b in enumerate(ws[1::2]) if b is None]
    if bias_free:
        raise ValueError(f"convs {bias_free} have no bias; the kernel needs one")
    geometry = [(c.stride, c.padding, c.dilation, c.groups)
                for c in _conv_layers(seq)]
    pools = [(p.kernel_size, p.stride, p.padding) for p in seq.network
             if isinstance(p, L.MaxPool1d)]
    if geometry != _EXPECTED_GEOMETRY or pools != [(3, 2, 0)]:
        raise ValueError(f"read convolver strides/paddings {geometry}, pools "
                         f"{pools} are not what the CUDA kernel implements "
                         f"({ROADMAP_VARIANTS})")


def supports_read_convolver(seq: L.Sequential,
                            route: Optional[str] = None) -> bool:
    """Whether a kernel implements ``seq`` in ``route`` (default: the route
    of the precision in force): ``check_read_convolver`` without raising
    (hello_tpu's ``supports_network``).  Decided by the topology and the
    route alone."""
    try:
        check_read_convolver(seq, route)
    except ValueError:
        return False
    return True


@dataclasses.dataclass(eq=False)
class FoldedReadConv:
    """Folded read-convolver weights for one kernel route: ``convs`` holds
    the 18 ``(W [Co, K*Ci], b [Co])`` pairs (``W`` bf16-valued for the bf16
    route); ``flat`` is the kernel's buffer (per conv the ``pack_conv``
    images, then ``b``, concatenated).  ``width`` is the read convolver's
    (1, or 2 for the wide one and its kernel)."""
    convs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    flat: torch.Tensor
    in_channels: int
    route: str = "tf32x3"
    width: int = 1


def k_step(route: str) -> int:
    """K of one product: wgmma m64nNk8 for the TF32 routes, m64nNk16 for
    bf16."""
    return 16 if route == "bf16" else 8


def padded_k(kc: int, route: str = "tf32x3") -> int:
    """K of a conv as the route's products take it: a multiple of
    ``k_step`` (stem conv 1's 3*C = 18 or 21 becomes 3 taps x 8 channels
    = 24, ``tf32_k_source``; for bf16 it becomes 4 taps x 8 channels =
    32, ``bf16_k_order``; the others already are)."""
    step = k_step(route)
    return -(-kc // step) * step


def bf16_k_order(kc: int) -> torch.Tensor:
    """Where each of a conv's ``kc`` K columns sits in the bf16 route's
    padded K: the identity, but for stem conv 1 (kc = 3C, C = 6 or 7),
    whose column tap * C + ci goes to tap * 8 + ci (the kernel reads its
    input as [position][8 channels], and a k-step's two core matrices as
    taps one position apart)."""
    if kc % 16 == 0:
        return torch.arange(kc)
    c = kc // 3
    return (torch.arange(3)[:, None] * 8 + torch.arange(c)[None, :]).reshape(-1)


def tf32_k_source(kc: int) -> torch.Tensor:
    """The W column that each K position of the TF32 routes' B image holds
    (-1: a zero).  The kernel gives lane 4 g + t of a warp the columns t and
    t + 4 of a k-step from one load, so the K order within each 16 channels
    of a tap is permuted: k-step 2 j + h, column t (t + 4) holds channel
    16 j + 4 t + 2 h (+ 1).  Stem conv 1 (kc = 3C, C = 6 or 7) reads its
    input as [position][8 channels], one tap per k-step: column t (t + 4)
    of tap k-step s holds channel 2 t (+ 1) of tap s, zero past C."""
    k = torch.arange(8)
    if kc % 16:
        c = kc // 3
        ch = 2 * (k % 4) + k // 4
        src = torch.arange(3)[:, None] * c + ch[None, :]
        return torch.where(ch[None, :] < c, src, -1).reshape(-1)
    j = torch.arange(kc)
    return 16 * (j // 16) + 4 * (j % 4) + 2 * ((j % 16) // 8) + (j % 8) // 4


def tf32_units(kc: int) -> int:
    """The units (taps) a conv's TF32 weights are streamed in: stem conv 1
    (its K padded to 24) and the 1x1 shortcut (K = 32) are one, the k = 3
    convs three."""
    return 1 if kc % 16 or kc == 32 else 3


def fragment_floats(co: int, kc: int, route: str = "tf32x3") -> int:
    """32-bit words of one conv's weights: big and small TF32 images
    (tf32x3), the TF32 image (tf32) or two bf16 values per word (bf16)."""
    kp = padded_k(kc, route)
    return {"tf32x3": 2 * co * kp, "tf32": co * kp, "bf16": co * kp // 2}[route]


def num_weight_floats(in_channels: int, route: str = "tf32x3",
                      width: int = 1) -> int:
    """32-bit words of the kernel's buffer for a route and width: per conv,
    the weights' images and the bias."""
    return sum(fragment_floats(co, kc, route) + co
               for co, kc in conv_shapes(in_channels, width))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero (PTX
    ``cvt.rna.tf32.f32``): the low 13 mantissa bits become 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest bf16 value (ties to even, as ``astype`` and
    ``cvt.rn.bf16.f32`` round), kept in fp32."""
    return x.to(torch.bfloat16).float()


def pack_conv(w: torch.Tensor, route: str = "tf32x3") -> torch.Tensor:
    """``W [Co, K*Ci]`` -> the kernel's weights for a route, flat float32
    words: the shared-memory image of the wgmma B operand of
    ``out[positions][Co] = im2col(x) @ W^T``, K-major (K zero-padded to
    ``padded_k``).

    tf32x3 and tf32 (m64nNk8): K in ``tf32_k_source``'s order, ``big =
    tf32(W)`` and, for tf32x3, ``small = tf32(W - big)`` (rounded as
    ``cvt.rna``); the image of each is [K/4][Co][4] fp32, element [k4][n][e]
    = W[n, 4 k4 + e], so 8 output channels x 4 K values are one 128-byte
    K-major core matrix, the next 8 channels 128 bytes on (SBO) and the
    next 4 K values Co x 16 bytes on (LBO).  The kernel streams a conv in
    ``tf32_units`` units of one tap; each unit is its rows of the big image,
    then (tf32x3) its rows of the small image.

    bf16 (wgmma m64nNk16): W is bf16-valued (the fold rounds it), its
    image [K/8][Co][8] bf16, element [k8][n][e] = W[n, 8 k8 + e] (K in
    ``bf16_k_order``), so 8 output channels x 8 K values are one 128-byte
    K-major core matrix, the next 8 channels 128 bytes on (SBO) and the
    next 8 K values Co x 16 bytes on (LBO)."""
    co, kc = w.shape
    kp = padded_k(kc, route)
    if route == "bf16":
        img = w.new_zeros(co, kp, dtype=torch.float32)
        img[:, bf16_k_order(kc)] = w.float()
        return img.reshape(co, kp // 8, 8).transpose(0, 1).to(
            torch.bfloat16).contiguous().reshape(-1).view(torch.float32)
    src = tf32_k_source(kc)
    wk = w.new_zeros(co, kp, dtype=torch.float32)
    wk[:, src >= 0] = w.float()[:, src[src >= 0]]
    big = tf32_round(wk)
    units = tf32_units(kc)
    image = lambda m: m.reshape(co, kp // 4, 4).transpose(0, 1).reshape(
        units, -1)
    if route == "tf32":
        return image(big).reshape(-1)
    return torch.stack([image(big), image(tf32_round(wk - big))],
                       dim=1).reshape(-1)


@torch.no_grad()
def fold_read_conv_weights(seq: L.Sequential,
                           route: Optional[str] = None) -> FoldedReadConv:
    """Gate the topology, then fold the weight norm for a kernel route
    (default: the route of the precision in force, ``nn.layers.PRECISION``).
    Once per parameter set: the Scorer calls this at construction, not per
    batch."""
    route = route_for_precision(L.PRECISION) if route is None else route
    if route not in ROUTE_IDS:
        raise ValueError(f"unknown read-conv kernel route {route!r}")
    check_read_convolver(seq, route)
    ws = [t.detach().float() for t in extract_read_conv_weights(seq)]
    convs = tuple(zip(ws[0::2], ws[1::2]))
    if route == "bf16":
        convs = tuple((bf16_round(w), b) for w, b in convs)
    flat = torch.cat([t for w, b in convs
                      for t in (pack_conv(w, route), b)]).contiguous()
    return FoldedReadConv(convs, flat, in_channels=convs[0][0].shape[1] // 3,
                          route=route, width=read_convolver_width(seq))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _conv(x, w, b, stride=1, padding=0, conv=F.conv1d):
    co, kc = w.shape
    ci = x.shape[1]
    wt = w.reshape(co, kc // ci, ci).permute(0, 2, 1)
    return conv(x, wt, b, stride=stride, padding=padding)


def read_convolver_reference(rows: torch.Tensor,
                             folded: FoldedReadConv) -> torch.Tensor:
    """[nb, 150, C] -> per-row frames [nb, 36, 64 * width] (NWC) with the
    folded weights, as F.conv1d / F.max_pool1d calls.  The bf16 route
    rounds where the Pallas kernel's bf16 ``compute_dtype`` does: each
    conv's biased fp32 sum once (on bf16-valued input and weights, so every
    product is exact), each residual add's sum again; ReLU and max-pool act
    on bf16 values and the frames come out bf16-valued, in fp32."""
    convs = iter(folded.convs)
    if folded.route == "bf16":
        r = bf16_round
        conv = lambda x, **kw: r(_conv(x, *next(convs), conv=L.conv1d_bf16,
                                       **kw))
    else:
        r = lambda t: t
        conv = lambda x, **kw: _conv(x, *next(convs), **kw)
    x = rows.float().transpose(1, 2)                      # [nb, C, 150]
    for _ in range(3):                                    # stem -> 32 x 144
        x = F.relu(conv(x))
    x = F.max_pool1d(x, 3, 2)                             # 32 x 71
    for _ in range(3):
        y = F.relu(conv(x, padding=1))
        x = r(x + F.relu(conv(y, padding=1)))
    y = F.relu(conv(x, stride=2, padding=1))              # 64 x 36
    y = F.relu(conv(y, padding=1))
    x = r(y + conv(x, stride=2))                          # 1x1 shortcut
    for _ in range(3):
        y = F.relu(conv(x, padding=1))
        x = r(x + F.relu(conv(y, padding=1)))
    return x.transpose(1, 2)


def read_conv_reduce_reference(rows, row_allele, row_valid,
                               folded: FoldedReadConv, num_alleles: int):
    """Plain version of ``read_conv_reduce``: the conv stack over every row,
    then the per-allele segment sum (rows with ``row_allele == A`` fold into
    a dropped dummy segment; their frames are nonzero — biases reach them —
    so ``row_valid`` zeroes them first)."""
    from ..nn.moe import packed_read_reduce

    frames = read_convolver_reference(rows, folded)
    return packed_read_reduce(frames, row_allele, row_valid, num_alleles)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_build_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the read-conv kernel is built "
                           "from csrc/read_conv.cu on a machine with the CUDA "
                           "toolkit")
    return path


def source_files(source: str) -> List[str]:
    """``source`` and the local headers it includes (``#include "x"``, in
    its directory, recursively): every file the library is built from."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as fh:
            for line in fh:
                m = re.match(r'\s*#\s*include\s+"([^"]+)"', line)
                if m:
                    todo.append(os.path.join(os.path.dirname(path), m.group(1)))
    return seen


def build(source: str = SOURCE) -> Tuple[str, str]:
    """Compile a CUDA source (default ``csrc/read_conv.cu``) for sm_90a into
    ``ops/build/`` (once per content of the source and the headers it
    includes).  Returns (library path, the compiler's report — ptxas
    registers, shared memory and spills — or "" when already built)."""
    digest = hashlib.sha256()
    for path in source_files(source):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    tag = digest.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def _library():
    global _lib
    with _build_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            lib.read_conv_reduce_run.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.read_conv_reduce_run.restype = ctypes.c_int
            lib.read_conv_reduce_info.argtypes = [
                ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
            lib.read_conv_reduce_info.restype = ctypes.c_int
            lib.read_conv_reduce_wide_run.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            lib.read_conv_reduce_wide_run.restype = ctypes.c_int
            lib.read_conv_reduce_wide_info.argtypes = [
                ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
            lib.read_conv_reduce_wide_info.restype = ctypes.c_int
            _lib = lib
        return _lib


def kernel_info(channels: int, route: str = "tf32x3", width: int = 1) -> dict:
    """A route's launch shape on the current card: read rows per block (of
    the wide kernel: per group of rows computed at once), dynamic shared
    memory and threads per block, resident blocks per SM."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    if width == 2 and route in WIDTH_ROUTES[2]:
        err = _library().read_conv_reduce_wide_info(
            channels, *(ctypes.byref(v) for v in vals))
    elif width == 1:
        err = _library().read_conv_reduce_info(
            channels, ROUTE_IDS[route], *(ctypes.byref(v) for v in vals))
    else:
        raise ValueError(f"no width-{width} kernel in route {route!r}")
    if err != 0:
        raise RuntimeError(f"read_conv_reduce_info failed: cudaError {err}")
    keys = ("rows_per_block", "smem_bytes", "threads", "blocks_per_sm")
    return dict(zip(keys, (v.value for v in vals)))


def _check_cuda_args(rows, row_allele, row_valid, folded, num_alleles):
    dev = rows.device
    nb = rows.shape[0] if rows.dim() == 3 else -1
    if rows.dim() != 3 or rows.shape[1] != L_IN or rows.shape[2] not in (6, 7):
        raise ValueError(f"rows must be [nb, {L_IN}, 6|7], got "
                         f"{tuple(rows.shape)}")
    if rows.dtype != torch.uint8:
        raise TypeError(f"rows must be uint8, got {rows.dtype}")
    if row_allele.dtype != torch.int32 or tuple(row_allele.shape) != (nb,):
        raise TypeError(f"row_allele must be int32 [{nb}], got "
                        f"{row_allele.dtype} {tuple(row_allele.shape)}")
    if row_valid.dtype != torch.float32 or tuple(row_valid.shape) != (nb,):
        raise TypeError(f"row_valid must be float32 [{nb}], got "
                        f"{row_valid.dtype} {tuple(row_valid.shape)}")
    flat = folded.flat
    if folded.route not in WIDTH_ROUTES.get(folded.width, ()):
        raise ValueError(f"no width-{folded.width} read-conv kernel in route "
                         f"{folded.route!r}")
    if folded.in_channels != rows.shape[2] or flat.dtype != torch.float32 \
            or flat.dim() != 1 \
            or flat.numel() != num_weight_floats(rows.shape[2], folded.route,
                                                 folded.width):
        raise ValueError("folded weights do not match the rows' channel "
                         "count or their route's layout")
    if flat.data_ptr() % 16:
        raise ValueError("folded weights must be 16-byte aligned")
    for name, t in (("row_allele", row_allele), ("row_valid", row_valid),
                    ("weights", flat)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rows on {dev}")
    for name, t in (("rows", rows), ("row_allele", row_allele),
                    ("row_valid", row_valid), ("weights", flat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if num_alleles < 1:
        raise ValueError(f"num_alleles must be >= 1, got {num_alleles}")


def read_conv_reduce(rows: torch.Tensor, row_allele: torch.Tensor,
                     row_valid: torch.Tensor, folded: FoldedReadConv,
                     num_alleles: int) -> torch.Tensor:
    """Fused read convolver + per-allele sum -> [A, 36, 64 * width] float32
    (NWC), in the route and width the weights were folded for
    (``folded.route``, ``folded.width``).

    rows: uint8 [nb, 150, C]; row_allele: int32 [nb] (``A`` marks a padding
    row, dropped); row_valid: float32 [nb].  CUDA tensors launch the route's
    kernel of the fold's width on the current stream (counted in
    ``telemetry.count``'s ledger); CPU tensors take
    ``read_conv_reduce_reference``.  The wide
    kernel sums each allele's rows in row order, one addition into each
    output value where the allele's rows are consecutive: the same bits on
    every run."""
    if rows.device.type == "cpu":
        return read_conv_reduce_reference(rows, row_allele, row_valid,
                                          folded, num_alleles)
    if rows.device.type != "cuda":
        raise ValueError(f"read_conv_reduce runs on cuda or cpu, not "
                         f"{rows.device}")
    _check_cuda_args(rows, row_allele, row_valid, folded, num_alleles)
    out = torch.zeros((num_alleles, L_OUT, C_OUT * folded.width),
                      dtype=torch.float32, device=rows.device)
    nb = rows.shape[0]
    if nb == 0:
        return out
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        if folded.width == 2:
            err = lib.read_conv_reduce_wide_run(
                rows.data_ptr(), nb, rows.shape[2], row_allele.data_ptr(),
                row_valid.data_ptr(), folded.flat.data_ptr(), num_alleles,
                out.data_ptr(), stream)
        else:
            err = lib.read_conv_reduce_run(
                rows.data_ptr(), nb, rows.shape[2], ROUTE_IDS[folded.route],
                row_allele.data_ptr(), row_valid.data_ptr(),
                folded.flat.data_ptr(), num_alleles, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"read_conv_reduce launch failed: cudaError {err}")
    telemetry.count(("read_conv_reduce", folded.route, folded.width))
    return out


def route_launches(before) -> dict:
    """{route: the kernel's launches} that the launch ledger
    (``telemetry.count``) has gained since ``before``, one of its
    ``counts()``; replays not included."""
    got = dict.fromkeys(ROUTE_IDS, 0)
    for key, n in (telemetry.counts() - before).items():
        if key[0] == "read_conv_reduce":
            got[key[1]] += n
    return got
