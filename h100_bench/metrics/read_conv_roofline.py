"""The read convolver kernel's share of its roofline in the profiler's
window: the least time of each ``read_conv_reduce`` launch (its real
reads' FLOPs at the stated precision's peak, or its bytes at HBM's, the
larger; ``flops.read_conv_work``) summed, over the launches' summed
device time.

Every pool batch holds the same reads per platform (``generator.
read_counts``), so each platform's launches all have one work; a launch is
put down to its platform by its grid, which grows with the rows the wire
ships (the platform that ships more rows launches more blocks).  Where the
grids do not tell the platforms apart the metric is not read."""

from h100_bench import peaks


def read(ctx):
    t = ctx["trace"]
    if not t or not t.get("kernels"):
        return None
    work = ctx["read_conv_launches"]
    grids = sorted({k[2] for k in t["kernels"]})
    if len(grids) != len(work):
        return None
    # the platform with more real reads ships more rows
    order = sorted(range(len(work)), key=lambda p: work[p][0])
    least = {g: peaks.roofline_seconds(*work[p], ctx["precision"])
             for g, p in zip(grids, order)}
    spent = sum(dur for _, dur, _ in t["kernels"]) / 1e6
    return 100.0 * sum(least[g] for _, _, g in t["kernels"]) / spent
