"""Mean ms of ``pipeline/compact.pack_sites_wire`` per batch over the
measured window of the traced run (the benchmark's own span around the
call)."""


def read(ctx):
    return ctx["span_ms"].get("pack")
