"""Call-set evaluation: precision / recall / genotype concordance vs a truth
set, with representation-invariant variant matching.

Fills the role of the reference's evaluation tooling (reference
python/evaluator.py stream comparison and determineMaxQLoss.py): compares a
called VCF against a truth VCF (optionally restricted to high-confidence BED
regions), stratified by variant type, using canonical left-aligned variant
keys so equivalent indel representations match.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
from typing import Dict, Optional

from ..io.bed import BedRegions
from ..io.fasta import FastaFile
from ..io.vcf import left_align_normalize, read_vcf

logger = logging.getLogger(__name__)


def variant_type(ref: str, alt: str) -> str:
    if len(ref) == 1 and len(alt) == 1:
        return "snv"
    if len(alt) > len(ref):
        return "ins"
    return "del"


def canonical_variants(records, ref: FastaFile,
                       highconf: Optional[BedRegions] = None):
    """Map canonical (chrom, pos, ref, alt) -> (genotype multiset, qual)."""
    lookup = lambda chrom, pos: ref.fetch(chrom, pos, pos + 1)
    out = {}
    for r in records:
        if highconf is not None and not highconf.intersects(
                r.chromosome, r.position, r.position + len(r.ref)):
            continue
        for ai, alt in enumerate(r.alt):
            if alt == r.ref:
                continue
            # genotype restricted to this alt: count of alt alleles called
            count = sum(1 for g in r.gt if g == ai + 1)
            if count == 0:
                continue
            pos, ra, aa = left_align_normalize(r.chromosome, r.position,
                                               r.ref, alt, lookup)
            out[(r.chromosome, pos, ra, aa)] = (count, r.qual)
    return out


@dataclasses.dataclass
class Metrics:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    gt_mismatch: int = 0

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp) if (self.tp + self.fp) else 0.0

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def to_dict(self):
        return {"tp": self.tp, "fp": self.fp, "fn": self.fn,
                "gt_mismatch": self.gt_mismatch,
                "precision": round(self.precision, 6),
                "recall": round(self.recall, 6),
                "f1": round(self.f1, 6)}


def evaluate(called_vcf: str, truth_vcf: str, ref_path: str,
             highconf_bed: Optional[str] = None) -> Dict[str, dict]:
    ref = FastaFile(ref_path)
    highconf = BedRegions.from_file(highconf_bed) if highconf_bed else None
    called = canonical_variants(read_vcf(called_vcf), ref, highconf)
    truth = canonical_variants(read_vcf(truth_vcf), ref, highconf)

    by_type: Dict[str, Metrics] = {"snv": Metrics(), "ins": Metrics(),
                                   "del": Metrics(), "all": Metrics()}

    for key, (t_count, _q) in truth.items():
        vt = variant_type(key[2], key[3])
        if key in called:
            for k in (vt, "all"):
                by_type[k].tp += 1
            if called[key][0] != t_count:
                for k in (vt, "all"):
                    by_type[k].gt_mismatch += 1
        else:
            for k in (vt, "all"):
                by_type[k].fn += 1
    for key in called:
        if key not in truth:
            vt = variant_type(key[2], key[3])
            for k in (vt, "all"):
                by_type[k].fp += 1

    return {k: m.to_dict() for k, m in by_type.items()}


def determine_max_q_loss(shard_index_paths) -> float:
    """Theoretical minimum site-level log-loss of a labeled dataset
    (reference determineMaxQLoss.py:44-70 semantics, over dumped shards
    instead of hdf5): a site with ``site_label == 0`` (at most one true
    allele, ``trainDataTools.py:955``) is perfectly predictable and
    contributes 0; a site with ``site_label == 1`` contributes
    ``-ln(0.5)``; the result is the mean over sites."""
    from ..train.store import ShardReader

    total_q, total_sites = 0.0, 0
    for path in shard_index_paths:
        for site in ShardReader(path):
            if site.site_label == 0:
                pass                      # predictable at 100% accuracy
            elif site.site_label == 1:
                total_q += -math.log(0.5)
            else:
                raise ValueError(
                    f"unknown site_label {site.site_label!r} in {path}")
            total_sites += 1
    if total_sites == 0:
        return 0.0
    return total_q / total_sites


def main(argv=None):
    parser = argparse.ArgumentParser(description="hello_tpu call-set evaluation")
    parser.add_argument("--calls")
    parser.add_argument("--truth")
    parser.add_argument("--ref")
    parser.add_argument("--highconf", default=None)
    parser.add_argument("--max_q_shards", default=None,
                        help="shard .lst/glob: print the dataset's theoretical "
                             "minimum log-loss instead (determineMaxQLoss CLI)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.max_q_shards:
        import glob

        if args.max_q_shards.endswith(".lst"):
            with open(args.max_q_shards) as fh:
                shards = [l.strip() for l in fh if l.strip()]
        else:
            shards = sorted(glob.glob(args.max_q_shards))
        value = determine_max_q_loss(shards)
        print(json.dumps({"max_q_loss": value, "shards": len(shards)}))
        return
    if not (args.calls and args.truth and args.ref):
        parser.error("--calls/--truth/--ref required (or use --max_q_shards)")
    result = evaluate(args.calls, args.truth, args.ref, args.highconf)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
