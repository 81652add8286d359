"""BED file access: high-confidence region checks for training labeling."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

GUARD_BAND = 3  # reference trainDataTools.py:46


class BedRegions:
    """Per-chromosome sorted interval lists with overlap/containment queries.

    Intervals are expanded by GUARD_BAND on read, matching the reference's
    bedReader (trainDataTools.py:115)."""

    def __init__(self, intervals: Dict[str, List[Tuple[int, int]]]):
        self.intervals = {
            c: sorted(v) for c, v in intervals.items()}
        self._starts = {c: [a for a, _b in v] for c, v in self.intervals.items()}

    @classmethod
    def from_file(cls, path: str, guard_band: int = GUARD_BAND) -> "BedRegions":
        table: Dict[str, List[Tuple[int, int]]] = {}
        with open(path) as fh:
            for line in fh:
                if not line.strip() or line.startswith(("#", "track", "browser")):
                    continue
                fields = line.split()
                chrom, start, stop = fields[0], int(fields[1]), int(fields[2])
                table.setdefault(chrom, []).append(
                    (start - guard_band, stop + guard_band))
        return cls(table)

    def overlapping(self, chromosome: str, start: int, stop: int):
        out = []
        iv = self.intervals.get(chromosome, [])
        starts = self._starts.get(chromosome, [])
        # half-open intervals: an interval starting exactly at
        # `stop` does NOT overlap [start, stop)
        i = bisect.bisect_left(starts, stop)
        for a, b in iv[:i]:
            if b > start:
                out.append((a, b))
        return out

    def intersects(self, chromosome: str, start: int, stop: int,
                   strict: bool = False) -> bool:
        """Any overlap (default) or full containment (strict) — reference
        trainDataTools.checkIntersection:71-91."""
        for a, b in self.overlapping(chromosome, start, stop):
            if strict:
                if a <= start < stop <= b:
                    return True
            else:
                return True
        return False
