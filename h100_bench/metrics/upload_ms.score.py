"""Mean ms of the port's ``scorer.upload`` span per batch (``Scorer._upload``:
a pinned copy of each wire array and its host-to-device enqueue) over the
measured window of the traced run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "scorer.upload")
