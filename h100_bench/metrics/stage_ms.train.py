"""Mean ms of ``Trainer.stage_batches`` per batch (on the prefetch thread)
over the measured window of the traced run."""


def read(ctx):
    return ctx["span_ms"].get("stage")
