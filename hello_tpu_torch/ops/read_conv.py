"""Fused read convolver + per-allele reduction: a hand-written CUDA kernel.

The read convolver is the hot op of scoring: every read row ``[150, C]``
(C = 6, or 7 with the haplotag channel) runs through 18 weight-normed convs
(~10.1 MFLOP per row) and the per-row ``[36, 64]`` frames are then summed per
allele slot.  ``read_conv_reduce`` computes

    out[a] = sum over rows r with row_allele[r] == a of
             row_valid[r] * read_convolver(rows[r])          -> [A, 36, 64]

in one launch of ``csrc/read_conv.cu`` (CUDA C++ for sm_90a, built with
``nvcc`` into ``ops/build/`` at first use and loaded with ctypes).  It
replaces the two Pallas TPU kernels of hello_tpu's ops/read_conv.py
(``_stem_kernel`` and ``_tail_kernel``) and the reduction after them, and
serves both read layouts of the model: the packed rows of the coded wire and
the dense ``[A, R]`` grid flattened to rows.

``read_conv_reduce_reference`` is the plain PyTorch version of the same
function (``F.conv1d`` / ``F.max_pool1d`` chain + ``index_add_``).  The
wrapper takes it only for tensors that lie on the CPU; a CUDA tensor goes to
the kernel or raises.

Weights are folded once per parameter set (``fold_read_conv_weights``): the
weight norm is applied and each conv becomes ``W[Co, K*Ci]`` (k-major, as
hello_tpu's ``extract_read_conv_weights``) plus ``b[Co]``; the kernel reads
one flat buffer of ``W^T [K*Ci, Co]`` and ``b`` per conv.  The topology gate
raises for a read convolver the kernel does not implement.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Tuple

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
                         "implement (only WeightNormedConv1d/ReLU/MaxPool1d)")
    ws = extract_read_conv_weights(seq)
    shapes = [tuple(m.shape) for m in ws[0::2]]
    if (len(shapes) != NUM_CONVS or shapes[0] not in ((16, 18), (16, 21))
            or shapes[1:] != _EXPECTED_TAIL_SHAPES):
        raise ValueError(f"read convolver conv shapes {shapes} are not the "
                         "width-1 topology the CUDA kernel implements")
    bias_free = [i for i, b in enumerate(ws[1::2]) if b is None]
    if bias_free:
        raise ValueError(f"convs {bias_free} have no bias; the kernel needs one")
    geometry = [(c.stride, c.padding, c.dilation, c.groups)
                for c in _conv_layers(seq)]
    pools = [(p.kernel_size, p.stride, p.padding) for p in seq.network
             if isinstance(p, L.MaxPool1d)]
    if geometry != _EXPECTED_GEOMETRY or pools != [(3, 2, 0)]:
        raise ValueError(f"read convolver strides/paddings {geometry}, pools "
                         f"{pools} are not what the CUDA kernel implements")


@dataclasses.dataclass(frozen=True)
class FoldedReadConv:
    """Folded read-convolver weights: ``convs`` holds the 18 ``(W [Co, K*Ci],
    b [Co])`` pairs; ``flat`` is the kernel's buffer (per conv ``W^T`` then
    ``b``, concatenated)."""
    convs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    flat: torch.Tensor
    in_channels: int


def num_weight_floats(in_channels: int) -> int:
    shapes = [(16, 3 * in_channels)] + _EXPECTED_TAIL_SHAPES
    return sum(co * kc + co for co, kc in shapes)


@torch.no_grad()
def fold_read_conv_weights(seq: L.Sequential) -> FoldedReadConv:
    """Gate the topology, then fold the weight norm (once per parameter
    set: the Scorer calls this at construction, not per batch)."""
    check_read_convolver(seq)
    ws = [t.detach().float() for t in extract_read_conv_weights(seq)]
    convs = tuple(zip(ws[0::2], ws[1::2]))
    flat = torch.cat([t for w, b in convs
                      for t in (w.t().reshape(-1), b)]).contiguous()
    return FoldedReadConv(convs, flat, in_channels=convs[0][0].shape[1] // 3)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _conv(x, w, b, stride=1, padding=0):
    co, kc = w.shape
    ci = x.shape[1]
    wt = w.reshape(co, kc // ci, ci).permute(0, 2, 1)
    return F.conv1d(x, wt, b, stride=stride, padding=padding)


def read_convolver_reference(rows: torch.Tensor,
                             folded: FoldedReadConv) -> torch.Tensor:
    """[nb, 150, C] -> per-row frames [nb, 36, 64] (NWC) with the folded
    weights, as F.conv1d / F.max_pool1d calls."""
    convs = iter(folded.convs)
    x = rows.float().transpose(1, 2)                      # [nb, C, 150]
    for _ in range(3):                                    # stem -> 32 x 144
        x = F.relu(_conv(x, *next(convs)))
    x = F.max_pool1d(x, 3, 2)                             # 32 x 71
    for _ in range(3):
        y = F.relu(_conv(x, *next(convs), padding=1))
        x = x + F.relu(_conv(y, *next(convs), padding=1))
    y = F.relu(_conv(x, *next(convs), stride=2, padding=1))   # 64 x 36
    y = F.relu(_conv(y, *next(convs), padding=1))
    x = y + _conv(x, *next(convs), stride=2)              # 1x1 shortcut
    for _ in range(3):
        y = F.relu(_conv(x, *next(convs), padding=1))
        x = x + F.relu(_conv(y, *next(convs), padding=1))
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


def build() -> Tuple[str, str]:
    """Compile ``csrc/read_conv.cu`` for sm_90a into ``ops/build/`` (once per
    source content).  Returns (library path, the compiler's report — ptxas
    registers, shared memory and spills — or "" when already built)."""
    with open(SOURCE, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libread_conv_{tag}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
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
            lib.read_conv_reduce_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.read_conv_reduce_f32.restype = ctypes.c_int
            _lib = lib
        return _lib


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
    if flat.dtype != torch.float32 or flat.dim() != 1 \
            or flat.numel() != num_weight_floats(rows.shape[2]):
        raise ValueError("folded weights do not match the rows' channel count")
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
    """Fused read convolver + per-allele sum -> [A, 36, 64] float32 (NWC).

    rows: uint8 [nb, 150, C]; row_allele: int32 [nb] (``A`` marks a padding
    row, dropped); row_valid: float32 [nb].  CUDA tensors launch the kernel
    on the current stream (``read_conv_reduce.launches`` counts launches);
    CPU tensors take ``read_conv_reduce_reference``."""
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
        err = lib.read_conv_reduce_f32(
            rows.data_ptr(), nb, rows.shape[2], row_allele.data_ptr(),
            row_valid.data_ptr(), folded.flat.data_ptr(), num_alleles,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"read_conv_reduce launch failed: cudaError {err}")
    read_conv_reduce.launches += 1
    return out


read_conv_reduce.launches = 0
