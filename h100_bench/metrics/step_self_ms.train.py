"""Mean ms per step of the port's ``trainer.step`` span less its
``trainer.forward``, ``trainer.backward`` and ``trainer.update`` (the
sub-batches, the statistics' clones and copies, the loss's copy) over the
measured window of the traced run."""

from h100_bench.program_spans import window_mean


def read(ctx):
    return window_mean(ctx, "trainer.step", exclusive=True)
