"""The loop's share of the card's peak: the model FLOPs of the window's work
(scoring: the forward of every batch whose answers came back; training:
forward and backward of every step; real reads, alleles and sites,
``flops.py``) over the window's seconds times the peak of the
configuration's stated precision (``peaks.py``).  Read as
``mfu.<split>`` in every cell whose split it is."""

from h100_bench import peaks


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    return 100.0 * ctx["flops_done"] / ctx["window_s"] / peaks.flops_peak(
        ctx["precision"])
