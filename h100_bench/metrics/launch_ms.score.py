"""Mean ms of the port's ``scorer.launch`` span per batch (``Scorer._forward``:
the wire's expansion, the forward and the decode, all enqueued) over the
measured window of the traced run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "scorer.launch")
