"""Fused read convolver + per-allele reduction: a hand-written CUDA kernel.

The read convolver is the hot op of scoring: every read row ``[150, C]``
(C = 6, or 7 with the haplotag channel) runs through 18 weight-normed convs
(~10.1 MFLOP per row) and the per-row ``[36, 64]`` frames are then summed per
allele slot.  ``read_conv_reduce`` computes

    out[a] = sum over rows r with row_allele[r] == a of
             row_valid[r] * read_convolver(rows[r])          -> [A, 36, 64]

in one launch of ``csrc/read_conv.cu`` (CUDA C++ for sm_90a: tensor-core
convs over 5 read rows per block, ``mma.sync`` for the TF32 routes and
``wgmma`` for bf16 (``csrc/read_conv_wgmma.cuh``), built with ``nvcc`` into
``ops/build/`` at first use and loaded with ctypes).  It replaces the two
Pallas TPU kernels of hello_tpu's ops/read_conv.py (``_stem_kernel`` and
``_tail_kernel``) and the reduction after them, and serves both read layouts
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
route's layout (``pack_conv``: mma.sync A fragments for the TF32 routes,
the wgmma B operand's shared-memory image for bf16), then ``b``.  The topology
gate (``check_read_convolver``) raises for a read convolver the kernel does
not implement; ``supports_read_convolver`` asks the same question without
raising, as hello_tpu's ``supports_network``, and the model runs such a
read convolver through its layers (nn/moe.py, the layer route).
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

from ..nn import layers as L

# architecture constants (read_convolver for feature_length=150)
L_IN = 150
L_OUT = 36     # after the stride-2 residual block
C_OUT = 64
NUM_CONVS = 18

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "read_conv.cu")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

#: ROADMAP item of the kernel variants for the read convolvers the kernel
#: does not implement (the wide, addendum and layer_norm configs take the
#: layer route until then)
ROADMAP_VARIANTS = ("ROADMAP.md Queue 1 item 14: kernel variants of "
                    "read_conv_reduce for the wide, addendum and layer_norm "
                    "configs")

#: kernel route of each precision (nn/layers.PRECISIONS), and the route's
#: number in the kernel's C interface
ROUTES = {"highest": "tf32x3", "high": "tf32x3", "default": "tf32",
          "bf16": "bf16"}
ROUTE_IDS = {"tf32x3": 0, "tf32": 1, "bf16": 2}


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


def check_read_convolver(seq: L.Sequential):
    """Raise ValueError unless ``seq`` is the standard width-1 weight-normed
    read_convolver the kernel implements (wide, addendum, layer-norm and
    batch-norm variants are refused, never routed around the kernel)."""
    if not _topology_matches(seq):
        raise ValueError("read convolver has layers the CUDA kernel does not "
                         "implement (only WeightNormedConv1d/ReLU/MaxPool1d; "
                         f"{ROADMAP_VARIANTS})")
    ws = extract_read_conv_weights(seq)
    shapes = [tuple(m.shape) for m in ws[0::2]]
    if (len(shapes) != NUM_CONVS or shapes[0] not in ((16, 18), (16, 21))
            or shapes[1:] != _EXPECTED_TAIL_SHAPES):
        raise ValueError(f"read convolver conv shapes {shapes} are not the "
                         "width-1 topology the CUDA kernel implements "
                         f"({ROADMAP_VARIANTS})")
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


def supports_read_convolver(seq: L.Sequential) -> bool:
    """Whether ``seq`` is the read convolver the kernel implements:
    ``check_read_convolver`` without raising (hello_tpu's
    ``supports_network``).  Decided by topology alone."""
    try:
        check_read_convolver(seq)
    except ValueError:
        return False
    return True


@dataclasses.dataclass(eq=False)
class FoldedReadConv:
    """Folded read-convolver weights for one kernel route: ``convs`` holds
    the 18 ``(W [Co, K*Ci], b [Co])`` pairs (``W`` bf16-valued for the bf16
    route); ``flat`` is the kernel's buffer (per conv the ``pack_conv``
    fragments, then ``b``, concatenated).  ``launches`` counts the kernel's
    launches with these weights (one read convolver's share of
    ``read_conv_reduce.launches``)."""
    convs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    flat: torch.Tensor
    in_channels: int
    route: str = "tf32x3"
    launches: int = 0


def k_step(route: str) -> int:
    """K of one product: mma.sync m16n8k8 for the TF32 routes, wgmma
    m64nNk16 for bf16."""
    return 16 if route == "bf16" else 8


def padded_k(kc: int, route: str = "tf32x3") -> int:
    """K of a conv as the route's products take it: a multiple of
    ``k_step`` (stem conv 1's 3*C = 18 or 21 becomes 24; for bf16 it
    becomes 4 taps x 8 channels = 32, ``bf16_k_order``; the others
    already are)."""
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


def fragment_floats(co: int, kc: int, route: str = "tf32x3") -> int:
    """32-bit words of one conv's weights: big and small TF32 A fragments
    (tf32x3), the TF32 part (tf32) or two bf16 values per word (bf16)."""
    kp = padded_k(kc, route)
    return {"tf32x3": 2 * co * kp, "tf32": co * kp, "bf16": co * kp // 2}[route]


def num_weight_floats(in_channels: int, route: str = "tf32x3") -> int:
    """32-bit words of the kernel's buffer for a route: per conv, the A
    fragments and the bias."""
    shapes = [(16, 3 * in_channels)] + _EXPECTED_TAIL_SHAPES
    return sum(fragment_floats(co, kc, route) + co for co, kc in shapes)


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
    words.

    The TF32 routes compute each conv as ``W @ im2col(x)`` with W as the
    row-major mma.sync A operand; K is zero-padded to ``padded_k``.

    tf32x3 and tf32 (m16n8k8): ``big = tf32(W)`` and, for tf32x3, ``small =
    tf32(W - big)``; the layout is [K/8][Co/16][big, small][lane 32][4]
    (tf32: [K/8][Co/16][lane 32][4]): for lane = 4 g + t, a0..a3 =
    W[16m + g, 8k + t], W[16m + g + 8, 8k + t], W[16m + g, 8k + t + 4],
    W[16m + g + 8, 8k + t + 4] (one 16-byte load per lane and part, the
    warp's 32 lanes on 512 contiguous bytes).

    bf16 (wgmma, ``out[positions][Co] = im2col(x) @ W^T``): W is
    bf16-valued (the fold rounds it) and is the B operand, copied whole
    into shared memory: its image is [K/8][Co][8] bf16, element [k8][n][e]
    = W[n, 8 k8 + e] (K in ``bf16_k_order``), so 8 output channels x 8 K
    values are one 128-byte K-major core matrix, the next 8 channels 128
    bytes on (SBO) and the next 8 K values Co x 16 bytes on (LBO)."""
    co, kc = w.shape
    kp = padded_k(kc, route)
    if route == "bf16":
        img = w.new_zeros(co, kp, dtype=torch.float32)
        img[:, bf16_k_order(kc)] = w.float()
        return img.reshape(co, kp // 8, 8).transpose(0, 1).to(
            torch.bfloat16).contiguous().reshape(-1).view(torch.float32)
    w = F.pad(w.float(), (0, kp - kc))
    big = tf32_round(w)
    # [m, hr, g, k, hc, t] -> [k, m, g, t, hc, hr]: Co index 16m + 8hr + g,
    # K index 8k + 4hc + t, so a0..a3 = (hc, hr) = (0,0), (0,1), (1,0), (1,1)
    frag = lambda m: m.reshape(co // 16, 2, 8, kp // 8, 2, 4).permute(
        3, 0, 2, 5, 4, 1)
    if route == "tf32":
        return frag(big).reshape(-1)
    small = tf32_round(w - big)
    return torch.stack([frag(big), frag(small)], dim=2).reshape(-1)


@torch.no_grad()
def fold_read_conv_weights(seq: L.Sequential,
                           route: Optional[str] = None) -> FoldedReadConv:
    """Gate the topology, then fold the weight norm for a kernel route
    (default: the route of the precision in force, ``nn.layers.PRECISION``).
    Once per parameter set: the Scorer calls this at construction, not per
    batch."""
    check_read_convolver(seq)
    route = route_for_precision(L.PRECISION) if route is None else route
    if route not in ROUTE_IDS:
        raise ValueError(f"unknown read-conv kernel route {route!r}")
    ws = [t.detach().float() for t in extract_read_conv_weights(seq)]
    convs = tuple(zip(ws[0::2], ws[1::2]))
    if route == "bf16":
        convs = tuple((bf16_round(w), b) for w, b in convs)
    flat = torch.cat([t for w, b in convs
                      for t in (pack_conv(w, route), b)]).contiguous()
    return FoldedReadConv(convs, flat, in_channels=convs[0][0].shape[1] // 3,
                          route=route)


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
    """[nb, 150, C] -> per-row frames [nb, 36, 64] (NWC) with the folded
    weights, as F.conv1d / F.max_pool1d calls.  The bf16 route rounds where
    the Pallas kernel's bf16 ``compute_dtype`` does: each conv's biased fp32
    sum once (on bf16-valued input and weights, so every product is exact),
    each residual add's sum again; ReLU and max-pool act on bf16 values and
    the frames come out bf16-valued, in fp32."""
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
            _lib = lib
        return _lib


def kernel_info(channels: int, route: str = "tf32x3") -> dict:
    """A route's launch shape on the current card: read rows per block,
    dynamic shared memory and threads per block, resident blocks per SM."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = _library().read_conv_reduce_info(
        channels, ROUTE_IDS[route], *(ctypes.byref(v) for v in vals))
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
    if folded.route not in ROUTE_IDS:
        raise ValueError(f"unknown read-conv kernel route {folded.route!r}")
    if folded.in_channels != rows.shape[2] or flat.dtype != torch.float32 \
            or flat.dim() != 1 \
            or flat.numel() != num_weight_floats(rows.shape[2], folded.route):
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
    """Fused read convolver + per-allele sum -> [A, 36, 64] float32 (NWC),
    in the route the weights were folded for (``folded.route``).

    rows: uint8 [nb, 150, C]; row_allele: int32 [nb] (``A`` marks a padding
    row, dropped); row_valid: float32 [nb].  CUDA tensors launch the route's
    kernel on the current stream (``read_conv_reduce.launches``, the
    per-route ``read_conv_reduce.launches_by_route`` and ``folded.launches``
    count launches); CPU tensors take ``read_conv_reduce_reference``."""
    if rows.device.type == "cpu":
        return read_conv_reduce_reference(rows, row_allele, row_valid,
                                          folded, num_alleles)
    if rows.device.type != "cuda":
        raise ValueError(f"read_conv_reduce runs on cuda or cpu, not "
                         f"{rows.device}")
    _check_cuda_args(rows, row_allele, row_valid, folded, num_alleles)
    out = torch.zeros((num_alleles, L_OUT, C_OUT), dtype=torch.float32,
                      device=rows.device)
    nb = rows.shape[0]
    if nb == 0:
        return out
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.read_conv_reduce_run(
            rows.data_ptr(), nb, rows.shape[2], ROUTE_IDS[folded.route],
            row_allele.data_ptr(), row_valid.data_ptr(),
            folded.flat.data_ptr(), num_alleles, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"read_conv_reduce launch failed: cudaError {err}")
    read_conv_reduce.launches += 1
    read_conv_reduce.launches_by_route[folded.route] += 1
    folded.launches += 1
    return out


def reset_launches():
    """Set every launch count of ``read_conv_reduce`` to 0."""
    read_conv_reduce.launches = 0
    read_conv_reduce.launches_by_route = dict.fromkeys(ROUTE_IDS, 0)


reset_launches()
