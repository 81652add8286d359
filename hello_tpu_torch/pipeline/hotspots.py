"""Hotspot detection over genomic regions.

Mirrors the reference driver flow (reference python/HotspotDetectorDVFiltered.py
+ python/PileupDataTools.py): chunk a region (400bp Illumina / 10kbp PacBio),
run the window engine per chunk with non-strict region clustering, emit sorted
hotspot positions; then cluster positions into active regions and re-run the
engine per active region to get precise candidate intervals.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..constants import (
    CHUNK_SIZE_ILLUMINA, CHUNK_SIZE_PACBIO, FLANKING_BASES,
    MAX_NUM_READS_ILLUMINA, MAX_NUM_READS_PACBIO, MIN_DISTANCE,
    READ_RATE_ILLUMINA, READ_RATE_PACBIO,
)
from ..io.bam import BamReader
from ..io.fasta import ChromView, FastaFile
from ..reads import ReadWindow
from ..window import LocationOutOfBounds, Window


class ReadSource:
    """Region read fetcher with caps/prorating
    (reference PileupDataTools.ReadSampler:129-158)."""

    def __init__(self, bam: BamReader, read_rate, pacbio: bool,
                 prorate: bool = True, rng: Optional[random.Random] = None):
        self.bam = bam
        self.read_rate = read_rate
        self.pacbio = pacbio
        self.prorate = prorate
        self.rng = rng or random.Random(13)

    def _max_reads(self, start: int, stop: int) -> int:
        if self.prorate:
            cap, per = self.read_rate
            if stop - start > per:
                return int(cap / per * (stop - start))
            return cap
        return self.read_rate if isinstance(self.read_rate, int) \
            else self.read_rate[0]

    @property
    def supports_native_select(self) -> bool:
        return hasattr(self.bam, "select")

    def select(self, chromosome: str, start: int, stop: int):
        """Fast path: C++-side read selection (NativeBam only)."""
        return self.bam.select(chromosome, start, stop,
                               max_reads=self._max_reads(start, stop),
                               seed=self.rng.randrange(2 ** 62))

    def __call__(self, chromosome: str, start: int, stop: int) -> ReadWindow:
        max_reads = self._max_reads(start, stop)
        reads = list(self.bam.fetch(chromosome, start, stop))
        for r in reads:
            r.pacbio = self.pacbio
        return ReadWindow(reads, chromosome, start, stop - start,
                          max_reads=max_reads, rng=self.rng)


def build_window(read_sources, ref_view, chromosome: str,
                 fetch_start: int, fetch_stop: int,
                 start: int, stop: int, **window_kwargs):
    """Construct a Window for [start, stop) with reads fetched over
    [fetch_start, fetch_stop), using the all-native fast path when available.

    Returns None when no reads overlap the fetch region."""
    if all(getattr(src, "supports_native_select", False)
           for src in read_sources):
        selections = [src.select(chromosome, fetch_start, fetch_stop)
                      for src in read_sources]
        if sum(len(sel) for sel in selections) == 0:
            return None
        return Window.from_native_selections(
            [sel for sel in selections], start, stop, ref_view, chromosome,
            **window_kwargs)
    windows = [src(chromosome, fetch_start, fetch_stop)
               for src in read_sources]
    reads = [r for w in windows for r in w.reads]
    if not reads:
        return None
    return Window(reads, start, stop, ref_view, chromosome, **window_kwargs)


_BAM_CACHE = {}          # insertion-ordered; oldest evicted beyond the cap
_BAM_CACHE_MAX = 8

# candidate windows reach past active-region edges by FLANKING_BASES plus
# clustering margins; region opens over-fetch by this much so every in-region
# window query is satisfied by the region handle
REGION_OPEN_FLANK = 2000


def _open_bam(path: str, pacbio: bool, region=None):
    """Prefer the native BAM loader when built; fall back to the Python codec.

    With ``region=(chromosome, start, stop)`` the native open decodes only
    the records overlapping the region (BAI seek) — O(region), so no
    whole-file cache is needed.  Handles are cached per (path, region) with
    a small LRU; the Python fallback reader is itself index-seeking, so it
    is cached per file regardless of region."""
    native_mod = None
    try:
        from .. import native as native_mod
        if not native_mod.available():
            native_mod = None
    except Exception:
        native_mod = None

    key = (path, pacbio, region if native_mod is not None else None)
    if key in _BAM_CACHE:
        _BAM_CACHE[key] = _BAM_CACHE.pop(key)     # LRU refresh
        return _BAM_CACHE[key]
    if native_mod is not None:
        bam = native_mod.NativeBam(path, pacbio=pacbio, region=region)
    else:
        bam = BamReader(path, pacbio=pacbio)
    _BAM_CACHE[key] = bam
    while len(_BAM_CACHE) > _BAM_CACHE_MAX:
        # drop the oldest handle; its memory is freed when the last live
        # selection/window referencing it is garbage-collected
        del _BAM_CACHE[next(iter(_BAM_CACHE))]
    return bam


def make_read_sources(bam_paths: Sequence[str], pacbio: bool,
                      for_hotspots: bool = False,
                      rng: Optional[random.Random] = None,
                      region=None) -> List[ReadSource]:
    """Open BAMs as read sources; hybrid mode = [illumina, pacbio].

    ``region=(chromosome, start, stop)`` scopes the open to the region
    (+/- REGION_OPEN_FLANK) for O(region) BAM access."""
    if region is not None:
        chrom, start, stop = region
        region = (chrom, max(int(start) - REGION_OPEN_FLANK, 0),
                  int(stop) + REGION_OPEN_FLANK)
    sources = []
    hybrid = len(bam_paths) > 1
    for i, path in enumerate(bam_paths):
        is_pb = (i > 0) if hybrid else pacbio
        reader = _open_bam(path, is_pb, region=region)
        if for_hotspots:
            rate = MAX_NUM_READS_PACBIO if is_pb else MAX_NUM_READS_ILLUMINA
            sources.append(ReadSource(reader, rate, is_pb, prorate=False, rng=rng))
        else:
            rate = READ_RATE_PACBIO if is_pb else READ_RATE_ILLUMINA
            sources.append(ReadSource(reader, rate, is_pb, prorate=True, rng=rng))
    return sources


def detect_hotspots(read_sources: Sequence[ReadSource], ref: FastaFile,
                    chromosome: str, start: int, stop: int,
                    pacbio: bool = False, hybrid_hotspot: bool = False,
                    q_threshold: int = 10, min_mapq: int = 10) -> List[int]:
    """Hotspot positions in [start, stop) (reference HotspotDetectorDVFiltered
    doOneChunk/hotspotGenerator*)."""
    hybrid = len(read_sources) > 1
    chunk_size = CHUNK_SIZE_PACBIO if (pacbio or hybrid) else CHUNK_SIZE_ILLUMINA
    ref_view = ChromView(ref, chromosome)
    positions: Dict[int, None] = {}
    pos = start
    while pos < stop:
        end = min(pos + chunk_size, stop)
        try:
            window = build_window(
                read_sources, ref_view, chromosome, pos, end, pos, end,
                hybrid=hybrid, pacbio=pacbio, hybrid_hotspot=hybrid_hotspot,
                q_threshold=q_threshold, min_mapq=min_mapq)
            if window is not None:
                for left, right in window.differing_regions(strict=False):
                    for j in range(left, right):
                        positions[j] = None
        except LocationOutOfBounds:
            pass
        pos = end
    return sorted(positions)


def cluster_hotspots(positions: Sequence[int], distance: int = MIN_DISTANCE
                     ) -> List[Tuple[int, int]]:
    """Group hotspot positions into active regions
    [first - d//2, last + d//2) (reference PileupDataTools.hotspotsReader)."""
    regions = []
    cluster: List[int] = []
    for p in positions:
        if cluster and p - cluster[-1] > distance:
            regions.append((cluster[0] - distance // 2, cluster[-1] + distance // 2))
            cluster = []
        cluster.append(p)
    if cluster:
        regions.append((cluster[0] - distance // 2, cluster[-1] + distance // 2))
    return regions


def merge_intervals(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge overlapping [start, stop) intervals."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def candidate_intervals(read_sources: Sequence[ReadSource], ref: FastaFile,
                        chromosome: str, active_regions: Sequence[Tuple[int, int]],
                        pacbio: bool = False, hybrid_hotspot: bool = False,
                        q_threshold: int = 10, min_mapq: int = 10,
                        include_hp: bool = False,
                        reassembly_size: int = 10,
                        provide_windows: bool = False):
    """Precise candidate intervals per active region
    (reference PileupDataTools.candidateReader:302-385).

    Returns (intervals, windows) where windows maps an active region to its
    constructed Window for reuse during tensor generation.
    """
    hybrid = len(read_sources) > 1
    ref_view = ChromView(ref, chromosome)
    intervals: List[Tuple[int, int]] = []
    windows = {}
    for start, stop in active_regions:
        try:
            window = build_window(
                read_sources, ref_view, chromosome,
                max(0, start - FLANKING_BASES), stop + FLANKING_BASES,
                start, stop,
                hybrid=hybrid, pacbio=pacbio, hybrid_hotspot=hybrid_hotspot,
                q_threshold=q_threshold, min_mapq=min_mapq,
                include_hp=include_hp, reassembly_size=reassembly_size)
            if window is None:
                continue
        except LocationOutOfBounds:
            continue
        regions = window.differing_regions(strict=True)
        intervals.extend(regions)
        if provide_windows:
            windows[(start, stop)] = window
    return merge_intervals(intervals), windows
