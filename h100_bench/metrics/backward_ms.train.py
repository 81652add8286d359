"""Mean ms of the port's ``trainer.backward`` span per step
(``torch.autograd.grad``, enqueued) over the measured window of the traced
run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "trainer.backward")
