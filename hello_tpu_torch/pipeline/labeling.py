"""Training-mode labeling glue: attach ground-truth genotypes to candidate
records during site generation.

Mirrors the truth path of the reference site generator
(reference python/trainDataTools.py:557-721 ``get_labeled_candidates``):
candidate spots are filtered to high-confidence regions, truthing records are
rebuilt from *assembled supports* (optionally restricted to Illumina-supported
alleles in hybrid mode), the Labeler matches them against enumerated truth
haplotypes, and genotype indices are written back onto the records.
"""

from __future__ import annotations

import bisect
import logging
from typing import Dict, List, Optional, Sequence

from ..io.bed import BedRegions
from ..io.vcf import VcfRecord, read_vcf
from ..labels import Labeler, RegionTooLongException, find_allele_index
from .candidates import CandidateRecord, make_candidate_record

logger = logging.getLogger(__name__)


class TruthSet:
    """Per-chromosome position-sorted truth records."""

    def __init__(self, records: Sequence[VcfRecord]):
        self.by_chrom: Dict[str, List[VcfRecord]] = {}
        for r in records:
            self.by_chrom.setdefault(r.chromosome, []).append(r)
        for v in self.by_chrom.values():
            v.sort(key=lambda r: r.position)
        self._positions = {c: [r.position for r in v]
                           for c, v in self.by_chrom.items()}

    @classmethod
    def from_file(cls, path: str) -> "TruthSet":
        return cls(read_vcf(path))

    def in_range(self, chromosome: str, start: int, stop: int) -> List[VcfRecord]:
        recs = self.by_chrom.get(chromosome, [])
        pos = self._positions.get(chromosome, [])
        i = bisect.bisect_left(pos, start)
        j = bisect.bisect_left(pos, stop)
        return recs[i:j]


class TruthLabeler:
    """Labeler callable for generate_sites (training mode)."""

    def __init__(self, truth: TruthSet, highconf: BedRegions,
                 hybrid_truth_eval: bool = False,
                 strict_intersection: bool = False):
        self.truth = truth
        self.highconf = highconf
        self.hybrid_truth_eval = hybrid_truth_eval
        self.strict_intersection = strict_intersection

    def __call__(self, chromosome, window, cluster, segment, seg_start,
                 records: List[CandidateRecord]) -> Optional[List[CandidateRecord]]:
        stop = seg_start + len(segment)

        # keep only candidates inside high-confidence regions
        records = [r for r in records if self.highconf.intersects(
            chromosome, r.position, r.stop, self.strict_intersection)]
        if not records:
            return []

        # truthing records use assembled supports only
        truthing_records = []
        for spot in cluster:
            if not self.highconf.intersects(chromosome, spot[0], spot[1],
                                            self.strict_intersection):
                continue
            window.assemble(spot[0], spot[1])
            alleles = []
            for allele in window.alleles_at_site:
                if window.hybrid and not self.hybrid_truth_eval:
                    if window.num_reads_supporting_allele(allele, False) == 0:
                        continue
                alleles.append(allele)
            ref_allele = segment[spot[0] - seg_start: spot[1] - seg_start]
            truthing_records.append(make_candidate_record(
                chromosome, spot[0], ref_allele, sorted(set(alleles))))

        ground_truth = [
            r for r in self.truth.in_range(chromosome, seg_start, stop)
            if self.highconf.intersects(chromosome, r.position,
                                        r.position + len(r.ref),
                                        self.strict_intersection)]

        try:
            labeler = Labeler(ground_truth, segment, seg_start)
            flag, truth_alleles = labeler(truthing_records)
        except RegionTooLongException:
            logger.info("region %s:%d-%d too long to label",
                        chromosome, seg_start, stop)
            return None

        if not flag:
            return [CandidateRecord(r.chromosome, r.position, r.ref, r.alt,
                                    [-1, -1]) for r in records]

        # align by position, not list order: the candidate list can have
        # dropped a spot (e.g. an unfetchable ref slice at a chromosome edge)
        # that the truthing side kept — a positional zip would shift every
        # subsequent label
        truth_by_pos = {tr.position: t for tr, t in
                        zip(truthing_records, truth_alleles)}
        labeled = []
        for r in records:
            t = truth_by_pos.get(r.position)
            if t is None:
                labeled.append(CandidateRecord(r.chromosome, r.position,
                                               r.ref, list(r.alt), [-1, -1]))
                continue
            gt = [find_allele_index(r, a) for a in t]
            assert len(gt) >= 1, "at least one truth allele expected"
            gt = gt * 2 if len(gt) == 1 else gt
            labeled.append(CandidateRecord(r.chromosome, r.position, r.ref,
                                           list(r.alt), gt))
        return labeled


def make_truth_labeler(truth_vcf: str, highconf_bed: str,
                       hybrid_truth_eval: bool = False,
                       strict_intersection: bool = False) -> TruthLabeler:
    return TruthLabeler(TruthSet.from_file(truth_vcf),
                        BedRegions.from_file(highconf_bed),
                        hybrid_truth_eval=hybrid_truth_eval,
                        strict_intersection=strict_intersection)
