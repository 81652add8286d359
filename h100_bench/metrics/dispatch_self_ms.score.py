"""Mean ms per batch of the port's ``scorer.dispatch`` span less its
``scorer.upload`` and ``scorer.launch`` (the replica check, the pinned output
buffers and their copies, the accounting) over the measured window of the
traced run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "scorer.dispatch", exclusive=True)
