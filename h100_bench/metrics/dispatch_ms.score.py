"""Mean ms of ``Scorer.score_async(decode=True)`` per batch (pinned upload
and the forward's launches) over the measured window of the traced run."""


def read(ctx):
    return ctx["span_ms"].get("dispatch")
