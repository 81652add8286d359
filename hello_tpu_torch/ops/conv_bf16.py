"""The eval-mode ``bf16`` conv of the port's layers: a hand-written CUDA kernel.

At ``bf16`` every conv layer outside the read-conv kernels (the
compressors, the expert heads, the combiners, the meta-experts and the
layer-route read convolvers) computes, in eval mode, what hello_tpu's conv
computes with a bf16 input and an fp32 preferred type:

    y[n, l, co] = bf16(sum over t, ci of x[n, l * stride - pad + t * dil, ci]
                                       * bf16(w[co, ci, t])  +  b[co])

every product exact, the sum in fp32, the fp32 bias added to the whole sum
and one rounding to bf16.  ``conv1d_bf16_nwc`` launches ``csrc/conv_bf16.cu``
for CUDA tensors (an implicit-GEMM conv on ``wgmma``, built with ``nvcc``
into ``ops/build/`` at first use and loaded with ctypes, as
``read_conv.py`` builds its kernel), reading bf16 NWC activations as they
lie and writing bf16 NWC, and counts each launch in the launch ledger
(``telemetry.count(("conv_bf16",))``).  It takes CUDA tensors only: the
CPU's convs keep ``nn/layers.conv1d_bf16``, the fp32 conv of the same bf16
values, which is also this kernel's plain version in the tests.

The weight is re-laid out in every call (``pack_weight``: ``[Co, Ci, K]`` ->
bf16 ``[Co, K * Ci]``, tap-major, one copy), the tile by ``tile_for`` from
the output positions and Co.  A shape the kernel does not take raises
(``check_shape``); nothing falls back to another conv on the card.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import torch

from .. import telemetry

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "conv_bf16.cu")

#: K of one shared-memory stage (four wgmma k-steps of 16), and the stages
BK = 64
STAGES = 4
#: the tiles' output positions (64 per consumer warpgroup) and channels
TILE_M = (64, 128)
TILE_N = (16, 32, 64, 128)
#: the H100's SMs: a tile whose blocks fill fewer than this many SMs halves M
SMS = 132

_lock = threading.Lock()
_lib = None


def out_length(lin: int, k: int, stride: int = 1, padding: int = 0,
               dilation: int = 1) -> int:
    """Output positions of a conv over ``lin`` input positions."""
    return (lin + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def tile_for(m: int, co: int) -> Tuple[int, int]:
    """(BM, BN) of a conv with ``m`` output positions (N * Lout) and ``co``
    output channels: BN the smallest tile width that holds Co, up to 128
    (a thread holds two fragments of BN / 2 fp32 values: the sum and one K
    block's partial sum); BM 128 (two warpgroups) unless
    the 128-row tiles would leave SMs idle, then 64."""
    bn = next((n for n in TILE_N if n >= co), TILE_N[-1])
    blocks = -(-m // TILE_M[-1]) * -(-co // bn)
    return (TILE_M[-1] if blocks >= SMS else TILE_M[0]), bn


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of a tile's block: the ring of stages, and
    1,024 bytes to start it on the swizzle's boundary."""
    return STAGES * (bm + bn) * BK * 2 + 1024


def check_shape(ci: int, co: int, k: int, stride: int, padding: int,
                dilation: int, groups: int):
    """Raise ValueError for a conv the kernel does not take: groups other
    than 1, Co not a multiple of 8, or a non-positive size."""
    if groups != 1:
        raise ValueError(f"conv_bf16 takes groups == 1, not {groups}")
    if co % 8 or co <= 0:
        raise ValueError(f"conv_bf16 takes Co a multiple of 8, not {co}")
    if min(ci, k, stride, dilation) < 1 or padding < 0:
        raise ValueError(f"conv_bf16 takes no Ci {ci}, K {k}, stride "
                         f"{stride}, padding {padding}, dilation {dilation}")


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``[Co, Ci, K]`` (fp32) -> the kernel's B operand: bf16 ``[Co, K *
    Ci]``, column ``t * Ci + ci`` holding ``w[co, ci, t]`` rounded to bf16
    (one copy with the cast)."""
    co, ci, k = w.shape
    out = torch.empty((co, k, ci), dtype=torch.bfloat16, device=w.device)
    out.copy_(w.detach().permute(0, 2, 1))
    return out.view(co, k * ci)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from .read_conv import build

            path, _ = build(SOURCE)
            lib = ctypes.CDLL(path)
            lib.conv1d_bf16_run.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.conv1d_bf16_run.restype = ctypes.c_int
            _lib = lib
        return _lib


def conv1d_bf16_nwc(x: torch.Tensor, w: torch.Tensor, b, stride: int = 1,
                    padding: int = 0, dilation: int = 1,
                    groups: int = 1) -> torch.Tensor:
    """The eval ``bf16`` conv, NWC: x bf16 ``[N, L, Ci]``, w ``[Co, Ci, K]``
    (fp32, rounded to bf16 here), b fp32 ``[Co]`` or None -> bf16 ``[N,
    Lout, Co]``, launched on the current stream in ``tile_for``'s tile
    (``launch``).  Raises for a tensor that is not on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_bf16_nwc runs on a CUDA device, not "
                         f"{x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise TypeError(f"x must be bf16 [N, L, Ci], got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, lin, ci = x.shape
    co, wci, k = w.shape
    check_shape(ci, co, k, stride, padding, dilation, groups)
    if wci != ci:
        raise ValueError(f"weight {tuple(w.shape)} does not take {ci} "
                         "input channels")
    if b is not None and (b.dtype != torch.float32 or b.shape != (co,)):
        raise TypeError(f"bias must be fp32 [{co}], got {b.dtype} "
                        f"{tuple(b.shape)}")
    for name, t in (("weight", w), ("bias", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    lout = out_length(lin, k, stride, padding, dilation)
    y = torch.empty((n, max(lout, 0), co), dtype=torch.bfloat16,
                    device=x.device)
    if n == 0 or lout <= 0:
        return y
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    launch(x, pack_weight(w), None if b is None else b.detach().contiguous(),
           y, k, stride, padding, dilation)
    return y


def launch(x, wp, bias, y, k, stride=1, padding=0, dilation=1, tile=None):
    """The kernel alone on prepared operands: x bf16 ``[N, L, Ci]``
    (contiguous, 16-byte aligned), ``wp`` = ``pack_weight(w)`` of a ``k``
    tap weight, ``bias`` fp32 ``[Co]`` (contiguous) or None, into ``y`` bf16
    ``[N, Lout, Co]``; in ``tile_for``'s tile, or in ``tile`` (BM, BN),
    which the card tests use to hold every tile to the same bits.  Counted
    in the launch ledger."""
    n, lin, ci = x.shape
    _, lout, co = y.shape
    bm, bn = tile_for(n * lout, co) if tile is None else tile
    shape = (ctypes.c_int * 9)(n, lin, ci, lout, co, k, stride, padding,
                               dilation)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1d_bf16_run(x.data_ptr(), wp.data_ptr(),
                                  None if bias is None else bias.data_ptr(),
                                  y.data_ptr(), shape, bm, bn, stream)
    if err != 0:
        raise RuntimeError(f"conv1d_bf16 launch failed: cudaError {err}")
    telemetry.count(("conv_bf16",))
