"""The card's clock, stamped by the card into a tensor: ``card_stamp``.

A CUDA event recorded inside a captured CUDA graph is the same event at
every replay, so it cannot time a batch while later replays of its graph
are queued.  ``card_stamp(out)`` instead enqueues a one-thread kernel
(``csrc/card_stamp.cu``, built with ``nvcc`` into ``ops/build/`` at first
use and loaded with ctypes, as ``read_conv.py`` builds its kernel) that
writes the card's global timer in ns into ``out`` once the work enqueued
before it on the current stream has finished.  Captured into a graph, the
kernel writes into the graph's static output at every replay, and each
batch copies its stamps to the host with its answers.  Two stamps bracket
the kernels between them; the difference is their time on the card.

There is no plain version: the CPU has no such clock, and the model writes
no stamps there (``nn/moe.py``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .. import telemetry
from .read_conv import build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "card_stamp.cu")

_lock = threading.Lock()
_lib = None


def _library():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build(SOURCE)
            lib = ctypes.CDLL(path)
            lib.card_stamp_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.card_stamp_run.restype = ctypes.c_int
            _lib = lib
        return _lib


def card_stamp(out: torch.Tensor):
    """Enqueue, on the current stream, the write of the card's global timer
    (ns) into ``out``: one int64 element of a CUDA tensor (a view is fine),
    counted in ``telemetry.count``'s ledger."""
    if out.device.type != "cuda":
        raise ValueError(f"card_stamp writes a CUDA tensor, not {out.device}")
    if out.dtype != torch.int64 or out.numel() != 1:
        raise TypeError(f"card_stamp writes one int64, got {out.dtype} "
                        f"{tuple(out.shape)}")
    lib = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.card_stamp_run(out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"card_stamp launch failed: cudaError {err}")
    telemetry.count(("card_stamp",))
