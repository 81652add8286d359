"""Mean ms of the port's ``trainer.forward`` span per step (the train-mode
forward and the loss, enqueued) over the measured window of the traced
run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "trainer.forward")
