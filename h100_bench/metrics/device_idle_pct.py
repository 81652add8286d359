"""Share of the profiler's window (the batches or steps after the measured
window) in which no kernel ran on the card: 100 x (1 - busy_s / window_s).
Read as ``device_idle_pct.<split>`` in every cell whose split it is."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
