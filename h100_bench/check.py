"""Deciding ``correct``: each number compared against its limit.

A cell's limits live in ``limits/<cell>.json`` as ``{number: {"limit": x,
"lower": the largest reading of sound runs, "upper": the smallest reading
of the control or of a planted fault, "from": where both came from}}``; a
number passes when it is at most its limit.  A number that is not finite
fails.
"""

from __future__ import annotations

import math
import sys

import numpy as np


def judge(readings: dict, limits: dict) -> dict:
    """{number: {"value": reading, "limit": limit}} for every number the
    cell's limits name; a number the run did not read counts as failed."""
    out = {}
    for name, lim in limits.items():
        value = readings.get(name)
        out[name] = {"value": (None if value is None else float(value)),
                     "limit": lim["limit"]}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def report(checks: dict, stream=sys.stderr):
    """Each number beside its limit, as the run's last lines on stderr."""
    for name, c in checks.items():
        stream.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    stream.flush()


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf of |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref)); ``prog`` and ``ref`` map leaf names to norms,
    ``keep`` the leaves that count (default every one)."""
    names = sorted(ref if keep is None else keep)
    if not names:
        return float("nan")
    med = float(np.median([ref[n] for n in ref]))
    worst = 0.0
    for n in names:
        if n not in prog:
            return float("inf")
        worst = max(worst, abs(prog[n] - ref[n]) / max(ref[n], med))
    return worst
