"""Mean ms of each ``Scorer.finalize_many`` call (the wait on the card and
the 13-byte-per-site fetch) over the measured window of the traced run."""


def read(ctx):
    return ctx["span_ms"].get("finalize")
