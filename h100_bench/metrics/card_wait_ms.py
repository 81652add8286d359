"""Mean ms per batch or step that the card's stream sat idle before the
host enqueued it: the port's ``scorer.card_wait`` or ``trainer.card_wait``
records (between two timed CUDA events: the end of the work before and
the start of this one), stamped with the batch's or step's start, over the
measured window of the traced run.  Read as
``card_wait_ms.<split>`` in every cell whose split it is."""

from h100_bench.program_spans import window_mean

SPAN = {"score": "scorer.card_wait", "train": "trainer.card_wait"}


def read(ctx):
    return window_mean(ctx, SPAN[ctx["loop"]])
