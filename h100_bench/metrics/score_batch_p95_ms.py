"""95th percentile over all batches of the measured window of the time
from the start of a batch's ``pack_sites_wire`` to the return of the
``Scorer.finalize_many`` that holds it."""


def read(ctx):
    return ctx.get("batch_p95_ms")
