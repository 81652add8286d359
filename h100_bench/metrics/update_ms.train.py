"""Mean ms of the port's ``trainer.update`` span per step
(``Optimizer.update``, enqueued) over the measured window of the traced
run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "trainer.update")
