"""The port's own span records (``hello_tpu_torch/telemetry.py``: its
``stage`` spans and the records it adds from the card's events) over the
measured window of a traced run, ``ctx["host"]``'s ``wall_start`` to
``wall_end`` on the system clock, the clock of the records.

Read on the card only (on the CPU the spans time CPU kernels, as ``mfu``
reads nothing there), and nothing from a port that keeps no such records.
"""


def window_mean(ctx, name: str, exclusive: bool = False):
    """Mean ms of the records named ``name`` in the window (``exclusive``:
    each less its child spans), or None."""
    host = ctx.get("host")
    if ctx["device"].type != "cuda" or not host:
        return None
    from hello_tpu_torch import telemetry

    mean_ms = getattr(telemetry, "mean_ms", None)
    if mean_ms is None:
        return None
    return mean_ms(name, int(host["wall_start"] * 1e9),
                   int(host["wall_end"] * 1e9), exclusive=exclusive)
