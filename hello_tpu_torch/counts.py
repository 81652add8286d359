"""Per-position allele counting and candidate (hotspot) detection.

Reproduces the counting semantics of the reference native engine
(reference c++/src/AlleleSearcherLiteFiltered.cpp:121-317 ``updateAlleleCounts``,
:19-101 ``AlleleCounts::resolvePartials``, :550-646 / :834-889 differing-region
detection), including its conventions:

  * indels are "impinged" on the reference position left of the indel cigar;
  * Illumina indel observations count 2x (PacBio 1x);
  * insertions at read boundaries are recorded as left/right *partial* alleles
    and resolved against full alleles afterwards;
  * deletions/insertions use the quality of the flanking read base(s), and a
    deletion at read start skips the quality check;
  * the hybrid hotspot mode replicates the reference's behaviour of only
    iterating Illumina allele keys (c++ :559-565 iterates count_i twice — a
    reference quirk kept for output parity) and of marking indel positions
    without the +1 flanking base used by the single-platform path.

This pure-Python engine is the semantic reference; the C++ native engine in
``native/`` implements the same contract for production throughput (validated
against this module by fuzz tests).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from .constants import (
    BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CINS, BAM_CMATCH, BAM_CREF_SKIP,
    BAM_CSOFT_CLIP, INDEL_THRESHOLD, MAX_ALLELE_SIZE, MIN_COUNT, MIN_MAPQ,
    Q_THRESHOLD, SNV_THRESHOLD,
)
from .reads import AlignedRead

AlleleKey = Tuple[str, str]  # (ref allele, read allele)


@dataclasses.dataclass
class AlleleCounts:
    pos: int
    ref_count: int = 0
    total: int = 0
    alt: Dict[AlleleKey, int] = dataclasses.field(default_factory=dict)
    left_partial: Dict[AlleleKey, int] = dataclasses.field(default_factory=dict)
    right_partial: Dict[AlleleKey, int] = dataclasses.field(default_factory=dict)

    def resolve_partials(self):
        """Fold partial insertion observations into matching full alleles.

        A left-partial allele (left half unknown) matches full alleles whose
        *suffix* equals it; right-partials match by prefix.  Exactly one match
        -> counts merge into the match; zero matches -> the partial becomes its
        own allele; multiple matches -> dropped. (c++ :19-101)
        """
        for partials, from_left in ((self.left_partial, True), (self.right_partial, False)):
            matches: Dict[AlleleKey, Set[AlleleKey]] = {}
            for key in partials:
                alt_allele = key[1]
                matched: Set[AlleleKey] = set()
                for full_key in self.alt:
                    full_alt = full_key[1]
                    if len(full_alt) < len(alt_allele):
                        continue
                    if from_left:
                        piece = full_alt[len(full_alt) - len(alt_allele):]
                    else:
                        piece = full_alt[:len(alt_allele)]
                    if piece == alt_allele:
                        matched.add(full_key)
                matches[key] = matched
            for key, matched in matches.items():
                if len(matched) == 1:
                    target = next(iter(matched))
                    self.alt[target] = self.alt.get(target, 0) + partials[key]
                elif len(matched) == 0:
                    self.alt[key] = partials[key]
            partials.clear()


def _add_count(count: AlleleCounts, ref_allele: str, read_allele: str,
               quality: Sequence[int], rdcounter: int, rdlength: int,
               threshold: int, partial=False, left_partial=False, increment=1):
    if "N" in ref_allele or "N" in read_allele:
        return
    if rdcounter >= 0:
        if min(quality[rdcounter:rdcounter + rdlength]) < threshold:
            return
    table = (count.left_partial if left_partial else count.right_partial) if partial \
        else count.alt
    key = (ref_allele, read_allele)
    table[key] = table.get(key, 0) + increment


class CountsEngine:
    """Allele counts over one reference window for one batch of reads."""

    def __init__(self, reference: str, window_start: int,
                 min_mapq: int = MIN_MAPQ, q_threshold: int = Q_THRESHOLD,
                 snv_threshold: float = SNV_THRESHOLD,
                 indel_threshold: float = INDEL_THRESHOLD,
                 min_count: int = MIN_COUNT,
                 max_allele_size: int = MAX_ALLELE_SIZE):
        self.reference = reference
        self.window_start = window_start
        self.min_mapq = min_mapq
        self.q_threshold = q_threshold
        self.snv_threshold = snv_threshold
        self.indel_threshold = indel_threshold
        self.min_count = min_count
        self.max_allele_size = max_allele_size
        self.counts_i = [AlleleCounts(pos=i + window_start) for i in range(len(reference))]
        self.counts_p = [AlleleCounts(pos=i + window_start) for i in range(len(reference))]

    def add_reads(self, reads: Sequence[AlignedRead]):
        for read in reads:
            self._add_read(read)
        for c in self.counts_i:
            c.resolve_partials()
        for c in self.counts_p:
            c.resolve_partials()

    def _add_read(self, read: AlignedRead):
        if read.mapq < self.min_mapq:
            return
        counts = self.counts_p if read.pacbio else self.counts_i
        ref = self.reference
        seq = read.sequence
        qual = read.qualities
        rf = read.reference_start - self.window_start
        rd = 0
        if rf <= 0:
            # indels anchor on the position left of the read start; a read at
            # the window edge cannot be counted safely (reference asserts here)
            return
        inc = 1 if read.pacbio else 2
        cigars = read.cigartuples
        for ci, (op, length) in enumerate(cigars):
            if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
                for j in range(length):
                    count = counts[rf + j]
                    if seq[rd + j] != ref[rf + j]:
                        _add_count(count, ref[rf + j], seq[rd + j], qual, rd + j, 1,
                                   self.q_threshold)
                    else:
                        count.ref_count += 1
                    count.total += 1
                rd += length
                rf += length
            elif op == BAM_CDEL:
                count = counts[rf - 1]
                ref_allele = ref[rf - 1: rf + length]
                read_allele = seq[rd - 1] if rd > 0 else ref[rf - 1]
                _add_count(count, ref_allele, read_allele, qual, rd - 1, 1,
                           self.q_threshold, increment=inc)
                rf += length
            elif op == BAM_CREF_SKIP:
                rf += length
            elif op == BAM_CINS:
                count = counts[rf - 1]
                ref_allele = ref[rf - 1]
                if ci == 0:
                    # insertion opens the alignment: left-partial observation
                    _add_count(count, ref_allele, seq[rd:rd + length], qual, rd, length,
                               self.q_threshold, partial=True, left_partial=True,
                               increment=inc)
                    count.total += 1
                elif ci == len(cigars) - 1 and rd > 0:
                    # insertion closes the alignment: right-partial observation
                    _add_count(count, ref_allele, seq[rd - 1:rd + length], qual,
                               rd - 1, length + 1, self.q_threshold, partial=True,
                               left_partial=False, increment=inc)
                else:
                    if rd > 0:
                        _add_count(count, ref_allele, seq[rd - 1:rd + length], qual,
                                   rd - 1, length + 1, self.q_threshold, increment=inc)
                    else:
                        _add_count(count, ref_allele, ref_allele + seq[rd:rd + length],
                                   qual, rd, length, self.q_threshold, increment=inc)
                rd += length
            elif op == BAM_CSOFT_CLIP:
                rd += length
            # hard clip / pad: no pointer movement

    # -- hotspot detection --------------------------------------------------

    def _differing_locations(self, counts: List[AlleleCounts],
                             min_count_snv: int, min_count_indel: int) -> Set[int]:
        locations: Set[int] = set()
        for item in counts:
            if item.total == 0:
                continue
            for (ref_base, alt_base), value in item.alt.items():
                if len(ref_base) == 1 and len(alt_base) == 1:
                    if value / item.total >= self.snv_threshold and value >= min_count_snv:
                        locations.add(item.pos)
                else:
                    if max(len(ref_base), len(alt_base)) > self.max_allele_size:
                        continue
                    if value / item.total >= self.indel_threshold and value >= min_count_indel:
                        # indel marks left-flank..right-flank inclusive
                        for i in range(item.pos, item.pos + len(ref_base) + 1):
                            locations.add(i)
        return locations

    def _differing_locations_hybrid(self) -> Set[int]:
        locations: Set[int] = set()
        for ci, cp in zip(self.counts_i, self.counts_p):
            # reference quirk: only Illumina allele keys are iterated
            # (c++ :559-565), so PacBio-only alleles are invisible here
            alt_keys = set(ci.alt.keys())
            total = ci.total + cp.total
            if total == 0:
                continue
            for key in alt_keys:
                ref_base, alt_base = key
                vi = ci.alt.get(key, 0)
                vp = cp.alt.get(key, 0)
                if len(ref_base) == 1 and len(alt_base) == 1:
                    if (vi + vp) / total >= self.snv_threshold and (vi + vp) >= self.min_count:
                        locations.add(ci.pos)
                else:
                    alt_count = vi / 2 + vp
                    if (vi + vp) / total >= self.indel_threshold and alt_count >= self.min_count:
                        # note: no +1 beyond the ref allele here (c++ :602)
                        for i in range(ci.pos, ci.pos + len(ref_base)):
                            locations.add(i)
        return locations

    def differing_regions(self, region_start: int, region_stop: int,
                          strict: bool = True,
                          hybrid_hotspot: bool = False) -> List[Tuple[int, int]]:
        """Cluster differing locations into [start, stop) regions.

        strict drops any region not fully inside [region_start, region_stop)
        (c++ pushRegions :495-517).
        """
        if hybrid_hotspot:
            locations = self._differing_locations_hybrid()
        else:
            loc_i = self._differing_locations(self.counts_i, self.min_count, 2 * self.min_count)
            loc_p = self._differing_locations(self.counts_p, self.min_count, self.min_count)
            locations = loc_i | loc_p
        return cluster_locations(sorted(locations), region_start, region_stop, strict)


def cluster_locations(locations: Sequence[int], region_start: int,
                      region_stop: int, strict: bool) -> List[Tuple[int, int]]:
    """Group consecutive positions into half-open regions."""
    regions: List[Tuple[int, int]] = []
    cluster: List[int] = []

    def push():
        if not cluster:
            return
        region = (cluster[0], cluster[-1] + 1)
        cluster.clear()
        if strict and (region[0] < region_start or region[1] > region_stop):
            return
        regions.append(region)

    for loc in locations:
        if cluster and cluster[-1] != loc - 1:
            push()
        cluster.append(loc)
    push()
    return regions
