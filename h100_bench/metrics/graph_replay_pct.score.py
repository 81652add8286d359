"""Share of the batches in the measured window whose forward the port ran
by replaying a captured CUDA graph: its ``scorer.replay`` records over its
``scorer.launch`` records (one a batch) that start in the window of the
traced run, x 100.  A replay counts under the launch it lies in (same batch
key and thread), so a launch at the window's end still finds its replay.

0 from a port that launches every batch eagerly; None on the CPU (which
never replays), from a port that keeps no span records, or with no launch
in the window.
"""

#: how far past the window a replay of a launch inside it may start, in ns
SLACK_NS = 10**9


def read(ctx):
    host = ctx.get("host")
    if ctx["device"].type != "cuda" or not host:
        return None
    from hello_tpu_torch import telemetry

    spans = getattr(telemetry, "spans", None)
    if spans is None:
        return None
    lo, hi = int(host["wall_start"] * 1e9), int(host["wall_end"] * 1e9)
    got = spans(lo, hi + SLACK_NS)
    launches = {(s.key, s.thread) for s in got
                if s.name == "scorer.launch" and s.start_ns <= hi}
    if not launches:
        return None
    replays = sum(1 for s in got if s.name == "scorer.replay"
                  and (s.key, s.thread) in launches)
    return 100.0 * replays / len(launches)
