"""Allele assembly from reads: aligned-pairs extraction, per-region allele
extraction with partial-overlap semantics, haplotype enumeration, and support
maps.

Reproduces the reference Read model (reference c++/src/Read.cpp:4-229) and the
assembly stage of the native engine (c++/src/AlleleSearcherLiteFiltered.cpp:648-832):

  * per-reference-position base strings (insertions append to the position to
    the left; deletions map to empty strings with quality 60);
  * ``get_aligned_bases`` classifies a region extraction as Success /
    LeftPartial / RightPartial / Fail, with partial insertions at read
    boundaries tracked via ``partial_start`` / ``partial_stop``;
  * recursive haplotype enumeration over site records;
  * PacBio re-interpretation against Illumina-derived haplotypes when the
    region is small and Illumina coverage is sufficient;
  * region support maps (read ids per allele per region) including the
    single-match resolution of partial observations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .constants import (
    BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CINS, BAM_CMATCH, BAM_CREF_SKIP,
    BAM_CSOFT_CLIP,
)
from .reads import AlignedRead

SUCCESS = 0
LEFT_PARTIAL = 1
RIGHT_PARTIAL = 2
FAIL = 3


@dataclasses.dataclass
class AllelicRecord:
    allele: str
    start: int
    stop: int
    min_q: int


@dataclasses.dataclass
class SiteRecord:
    alleles: List[str]
    start: int
    stop: int


class ReadAlignment:
    """A read expanded into per-reference-position aligned bases."""

    def __init__(self, read: AlignedRead, read_id: int):
        self.read = read
        self.read_id = read_id
        self.name = read.name
        self.mapq = read.mapq
        self.pacbio = read.pacbio
        self.reference_start = read.reference_start
        self.aligned_pairs: Dict[int, str] = {}
        self.aligned_quals: Dict[int, int] = {}
        self.last_position = -1
        self.partial_start = False
        self.partial_stop = False
        self.alleles: List[AllelicRecord] = []
        self.left_partial: Optional[AllelicRecord] = None
        self.right_partial: Optional[AllelicRecord] = None
        self._extracted = False
        self._expand()

    def _expand(self):
        seq = self.read.sequence
        qual = self.read.qualities
        ref_ptr = self.read.reference_start
        rd_ptr = 0
        cigars = self.read.cigartuples
        for ci, (op, length) in enumerate(cigars):
            if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
                for i in range(length):
                    self.aligned_pairs[ref_ptr + i] = seq[rd_ptr + i]
                    self.aligned_quals[ref_ptr + i] = qual[rd_ptr + i]
                    self.last_position = ref_ptr + i
                rd_ptr += length
                ref_ptr += length
            elif op == BAM_CDEL:
                for i in range(length):
                    self.aligned_pairs[ref_ptr + i] = ""
                    self.aligned_quals[ref_ptr + i] = 60
                    self.last_position = ref_ptr + i
                ref_ptr += length
            elif op == BAM_CREF_SKIP:
                ref_ptr += length
            elif op == BAM_CINS:
                ins = seq[rd_ptr:rd_ptr + length]
                anchor = ref_ptr - 1
                if anchor not in self.aligned_pairs:
                    self.aligned_pairs[anchor] = ins
                    self.partial_start = True
                else:
                    self.aligned_pairs[anchor] += ins
                    if ci == len(cigars) - 1:
                        self.partial_stop = True
                min_q = min(qual[rd_ptr:rd_ptr + length])
                if anchor in self.aligned_quals:
                    self.aligned_quals[anchor] = min(self.aligned_quals[anchor], min_q)
                else:
                    self.aligned_quals[anchor] = min_q
                rd_ptr += length
            elif op == BAM_CSOFT_CLIP:
                rd_ptr += length

    def get_aligned_bases(self, start: int, stop: int) -> Tuple[str, int, int]:
        """Extract bases covering [start, stop); returns (bases, status, min_q)."""
        ap = self.aligned_pairs
        if not (start <= self.last_position and self.reference_start < stop) \
                or self.last_position == -1:
            return "", FAIL, 10000

        if start not in ap:
            status = LEFT_PARTIAL
        elif (start - 1) not in ap:
            status = LEFT_PARTIAL if self.partial_start else SUCCESS
        elif (stop - 1) not in ap:
            status = RIGHT_PARTIAL
        elif stop not in ap:
            status = RIGHT_PARTIAL if self.partial_stop else SUCCESS
        else:
            status = SUCCESS

        # deletion spanning the region edge: no usable allele
        if ap.get(start) == "" or ap.get(stop - 1) == "":
            status = FAIL

        bases = []
        min_q = 10000
        for i in range(start, stop):
            if i in ap:
                bases.append(ap[i])
            if i in self.aligned_quals:
                min_q = min(min_q, self.aligned_quals[i])
        return "".join(bases), status, min_q

    def extract_alleles(self, locations: Sequence[Tuple[int, int]]):
        if self._extracted:
            return
        for start, stop in locations:
            bases, status, min_q = self.get_aligned_bases(start, stop)
            record = AllelicRecord(bases, start, stop, min_q)
            if status == SUCCESS:
                self.alleles.append(record)
            elif status == LEFT_PARTIAL:
                self.left_partial = record
            elif status == RIGHT_PARTIAL:
                self.right_partial = record
        self._extracted = True

    def haplotype_string(self, ref_fetch, start: int, stop: int) -> str:
        """Reconstruct the read's haplotype over [start, stop) from its alleles
        plus reference filler (reference Read.cpp:174-203 incl. its quirk of
        dropping the first allele when it begins at or before ``start``)."""
        if not self.alleles:
            return ref_fetch(start, stop)
        hap = []
        first = self.alleles[0]
        if first.start > start:
            hap.append(ref_fetch(start, first.start))
            hap.append(first.allele)
        for i in range(1, len(self.alleles)):
            prev, cur = self.alleles[i - 1], self.alleles[i]
            hap.append(ref_fetch(prev.stop, cur.start))
            hap.append(cur.allele)
        if self.alleles[-1].stop < stop:
            hap.append(ref_fetch(self.alleles[-1].stop, stop))
        return "".join(hap)

    def update_allelic_records(self, ref_fetch, haplotypes, start: int, stop: int):
        """If the read spans [start, stop) and its haplotype matches an
        enumerated haplotype, adopt that haplotype's allele decomposition
        (reference Read.cpp:205-229)."""
        if start > self.reference_start:
            return
        if self.last_position < stop:
            return
        hap = self.haplotype_string(ref_fetch, start, stop)
        if hap in haplotypes:
            records = [r for r in haplotypes[hap] if r.start != -1]
            self.alleles = list(records)


def enumerate_all_haplotypes(site_records: List[SiteRecord], ref_fetch,
                             start: int, stop: int) -> Dict[str, List[AllelicRecord]]:
    """All combinations of one allele per site stitched with reference filler,
    mapped to their allele decompositions (reference Read.cpp:239-323)."""

    def recurse(sites: List[SiteRecord], level: int) -> Dict[str, List[AllelicRecord]]:
        if not sites:
            return {"": [AllelicRecord("", -1, start, 60)]}
        last = sites[-1]
        result = recurse(sites[:-1], level + 1)
        new_result: Dict[str, List[AllelicRecord]] = {}
        for allele in last.alleles:
            record = AllelicRecord(allele, last.start, last.stop, 60)
            for hap, records in result.items():
                previous = records[-1].stop if records else start
                new_hap = hap + ref_fetch(previous, record.start) + record.allele
                if level == 0:
                    new_hap = new_hap + ref_fetch(record.stop, stop)
                new_result[new_hap] = records + [record]
        return new_result

    return recurse(list(site_records), 0)


class AssemblyEngine:
    """Region allele assembly + support maps over one window's reads."""

    def __init__(self, reads: Sequence[AlignedRead], reference: str,
                 window_start: int, min_mapq: int, q_threshold: int,
                 max_reassembly_region_size: int = 10, band_margin: int = 6):
        self.reads = [ReadAlignment(r, i) for i, r in enumerate(reads)]
        self.reference = reference
        self.window_start = window_start
        self.min_mapq = min_mapq
        self.q_threshold = q_threshold
        self.max_reassembly_region_size = max_reassembly_region_size
        self.band_margin = band_margin
        self.alleles_in_regions: Dict[Tuple[int, int], Set[str]] = {}
        self.supports_in_region: Dict[Tuple[int, int], Dict[str, Set[int]]] = {}

    def _ref_fetch(self, start: int, stop: int) -> str:
        return self.reference[start - self.window_start: stop - self.window_start]

    def _collect_alleles(self, read_alignments) -> Dict[Tuple[int, int], Set[str]]:
        alleles: Dict[Tuple[int, int], Set[str]] = {}
        for ra in read_alignments:
            for record in ra.alleles:
                if (record.min_q >= self.q_threshold and ra.mapq >= self.min_mapq
                        and "N" not in record.allele):
                    alleles.setdefault((record.start, record.stop), set()).add(record.allele)
        return alleles

    def assemble_alleles_from_reads(self, differing_regions: Sequence[Tuple[int, int]],
                                    reassemble: bool):
        if not differing_regions:
            return
        start = differing_regions[0][0] - self.band_margin
        stop = differing_regions[-1][1] + self.band_margin

        for ra in self.reads:
            ra.extract_alleles(differing_regions)

        if reassemble and len(differing_regions) < self.max_reassembly_region_size:
            illumina = [ra for ra in self.reads if not ra.pacbio]
            i_alleles = self._collect_alleles(illumina)
            sites = [SiteRecord(sorted(v), k[0], k[1]) for k, v in sorted(i_alleles.items())]
            haplotypes = enumerate_all_haplotypes(sites, self._ref_fetch, start, stop)
            for ra in self.reads:
                if ra.pacbio:
                    ra.update_allelic_records(self._ref_fetch, haplotypes, start, stop)

        self.alleles_in_regions = self._collect_alleles(self.reads)

        self.supports_in_region = {}
        for ra in self.reads:
            for record in ra.alleles:
                if ra.mapq >= self.min_mapq and record.min_q >= self.q_threshold:
                    self.supports_in_region.setdefault(
                        (record.start, record.stop), {}).setdefault(
                        record.allele, set()).add(ra.read_id)

        # resolve partial observations: a partial matching exactly one full
        # allele contributes support to that allele (c++ :777-831)
        for ra in self.reads:
            if ra.left_partial is not None:
                self._resolve_partial_support(ra, ra.left_partial, from_left=True)
            elif ra.right_partial is not None:
                self._resolve_partial_support(ra, ra.right_partial, from_left=False)

    def _resolve_partial_support(self, ra, record, from_left: bool):
        key = (record.start, record.stop)
        partial = record.allele
        if key not in self.supports_in_region:
            return
        matches = []
        for full in self.supports_in_region[key]:
            if len(full) < len(partial):
                continue
            piece = full[len(full) - len(partial):] if from_left else full[:len(partial)]
            if piece == partial:
                matches.append(full)
        if len(matches) == 1:
            self.supports_in_region[key][matches[0]].add(ra.read_id)

    def supports_at(self, start: int, stop: int) -> Dict[str, List[int]]:
        """Allele -> sorted supporting read ids at a region (c++ assemble :920-949;
        read-id order is sorted here where the reference's is container order —
        row order is irrelevant downstream because the model sums over reads)."""
        table = self.supports_in_region.get((start, stop), {})
        return {allele: sorted(ids) for allele, ids in table.items()}

    def alleles_at(self, start: int, stop: int) -> List[str]:
        return sorted(self.alleles_in_regions.get((start, stop), set()))
