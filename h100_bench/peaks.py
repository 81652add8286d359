"""Published peaks of one NVIDIA H100 and the peak each share divides by.

The numbers are NVIDIA's data sheet for the H100 SXM5 part, dense rates
without sparsity, at its full 700 W: 989 TFLOP/s of bf16 on the tensor
cores, 495 TFLOP/s of TF32, 67 TFLOP/s of fp32 outside them, 3,350 GB/s of
HBM3.  (``hello_tpu_torch/ops/bench_read_conv.py``'s ``CARD_PEAKS`` holds the
same values, commit 9a24431.)

Every roofline and MFU share in this benchmark divides the work the inputs
need (``flops.py``) by the peak of the precision the configuration
*states*, never by the peak of the math the current code happens to run:

  * ``bf16`` (the calling CLI's default): 989 TFLOP/s;
  * ``highest`` (fp32-class products, the training default): 165 TFLOP/s,
    the fastest rate at which the card computes products of fp32 accuracy,
    three TF32 passes (big x big, big x small, small x big) at a third of
    495, as the port's ``tf32x3`` kernel route does.  The 67 TFLOP/s of
    plain fp32 is slower, so a step that runs cuDNN's fp32 math shows as a
    low share, and one moved to 3xTF32 tensor-core math can rise to 100%
    and no further.

So a later change that replaces a kernel, or moves the fp32 convs to
another route, changes the time and not the yardstick, and no share can
pass 100%.  The card's power limit (``nvidia-smi``) is printed beside the
shares: a card set below 700 W runs slower under load.
"""

from __future__ import annotations

import subprocess

#: TFLOP/s of each stated precision on one H100 SXM (see above)
TFLOPS = {"bf16": 989.0, "highest": 495.0 / 3}
HBM_GBS = 3350.0


def flops_peak(precision: str) -> float:
    """FLOP/s of the precision a configuration states."""
    return TFLOPS[precision] * 1e12


def roofline_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations over
    the precision's peak and the bytes over HBM's."""
    return max(flops / flops_peak(precision), nbytes / (HBM_GBS * 1e9))


def power_limit() -> str:
    """``name, power.limit`` of the card from nvidia-smi, or "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"
