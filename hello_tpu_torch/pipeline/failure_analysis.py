"""Failure-analysis evaluator: join FP/FN/genotype-error calls with the
per-site feature records persisted by the caller.

Fills the role of the reference's ``Stepper``/``Analyzer`` stream machinery
(reference python/evaluator.py:224-482), which walks a hap.py failure report
alongside the per-shard ``.features`` pickles and prints the model's internal
state for each failed site.  Here the failure set is computed directly from
calls-vs-truth (representation-invariant canonical keys, the same matching
:mod:`.evaluate` uses), and the join is against the ``*.features.pkl`` file
written by ``call_genome(..., provide_experts=True)``:
per-failure output includes each overlapping site's candidate alleles,
meta-expert weights, every expert's top allele pair and probability, and
whether the experts disagree.
"""

from __future__ import annotations

import argparse
import bisect
import json
import logging
import pickle
from typing import Dict, List, Optional

from ..io.bed import BedRegions
from ..io.fasta import FastaFile
from ..io.vcf import read_vcf
from .evaluate import canonical_variants

logger = logging.getLogger(__name__)


def load_features(path: str) -> List[dict]:
    with open(path, "rb") as fh:
        return pickle.load(fh)


class FeatureIndex:
    """Per-chromosome sorted interval index over persisted site records."""

    def __init__(self, features: List[dict]):
        self._by_chrom: Dict[str, List[tuple]] = {}
        self._max_len = 1
        for feat in features:
            self._max_len = max(self._max_len, int(feat["length"]))
            self._by_chrom.setdefault(feat["chromosome"], []).append(
                (int(feat["position"]),
                 int(feat["position"]) + int(feat["length"]), feat))
        for intervals in self._by_chrom.values():
            intervals.sort(key=lambda iv: (iv[0], iv[1]))

    def overlapping(self, chrom: str, start: int, stop: int,
                    flank: int = 0) -> List[dict]:
        intervals = self._by_chrom.get(chrom, [])
        lo, hi = start - flank, stop + flank
        # scan from the first interval whose start could still overlap, given
        # the longest record actually indexed (no magic site-width assumption)
        idx = bisect.bisect_left(intervals, (lo - self._max_len, -1, None))
        out = []
        for s, e, feat in intervals[idx:]:
            if s >= hi:
                break
            if e > lo:
                out.append(feat)
        return out


def _expert_views(feat: dict) -> List[dict]:
    """Per-expert top pair + probability and the cross-expert disagreement."""
    views = []
    for k, probs in enumerate(feat["expertPredictions"]):
        if not probs:
            continue
        pair, p = max(probs.items(), key=lambda kv: float(kv[1]))
        views.append({"expert": k, "top_pair": list(pair),
                      "probability": round(float(p), 6)})
    return views


def site_report(feat: dict) -> dict:
    views = _expert_views(feat)
    top_pairs = {tuple(v["top_pair"]) for v in views}
    return {
        "position": int(feat["position"]),
        "length": int(feat["length"]),
        "alleles": list(feat.get("alleles", [])),
        "meta": [round(float(m), 6) for m in list(feat["meta"])[:3]],
        "experts": views,
        "experts_disagree": len(top_pairs) > 1,
        "called_pair": list(feat.get("bestPair", [])),
        "quality": round(float(feat.get("quality", 0.0)), 3),
    }


def classify_failures(calls_vcf: str, truth_vcf: str, ref: FastaFile,
                      highconf: Optional[BedRegions] = None) -> List[dict]:
    """FP / FN / genotype-mismatch variants on canonical keys."""
    called = canonical_variants(read_vcf(calls_vcf), ref, highconf)
    truth = canonical_variants(read_vcf(truth_vcf), ref, highconf)
    failures = []
    for key, (t_count, _q) in sorted(truth.items()):
        chrom, pos, ra, aa = key
        if key not in called:
            failures.append({"kind": "FN", "chromosome": chrom,
                             "position": pos, "ref": ra, "alt": aa,
                             "truth_gt_count": t_count})
        elif called[key][0] != t_count:
            failures.append({"kind": "GT", "chromosome": chrom,
                             "position": pos, "ref": ra, "alt": aa,
                             "truth_gt_count": t_count,
                             "called_gt_count": called[key][0],
                             "qual": called[key][1]})
    for key, (c_count, qual) in sorted(called.items()):
        if key not in truth:
            chrom, pos, ra, aa = key
            failures.append({"kind": "FP", "chromosome": chrom,
                             "position": pos, "ref": ra, "alt": aa,
                             "called_gt_count": c_count, "qual": qual})
    return failures


def analyze(calls_vcf: str, truth_vcf: str, ref_path: str,
            features_path: str, highconf_bed: Optional[str] = None,
            flank: int = 10) -> List[dict]:
    """Return one record per failed variant with the overlapping persisted
    site features attached (the reference Analyzer's per-failure dump)."""
    ref = FastaFile(ref_path)
    highconf = BedRegions.from_file(highconf_bed) if highconf_bed else None
    index = FeatureIndex(load_features(features_path))
    failures = classify_failures(calls_vcf, truth_vcf, ref, highconf)
    for failure in failures:
        span = len(failure["ref"])
        feats = index.overlapping(failure["chromosome"], failure["position"],
                                  failure["position"] + span, flank=flank)
        failure["sites"] = [site_report(f) for f in feats]
        failure["num_candidate_sites"] = len(feats)
    return failures


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu failure analysis: join FP/FN calls with "
                    "persisted per-site expert features")
    parser.add_argument("--calls", required=True, help="called VCF")
    parser.add_argument("--truth", required=True, help="truth VCF")
    parser.add_argument("--ref", required=True, help="reference FASTA")
    parser.add_argument("--features", required=True,
                        help="features pickle from --provide_features")
    parser.add_argument("--highconf", default=None)
    parser.add_argument("--out", default=None,
                        help="write JSONL here instead of stdout")
    parser.add_argument("--flank", type=int, default=10)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    failures = analyze(args.calls, args.truth, args.ref, args.features,
                       args.highconf, flank=args.flank)
    lines = [json.dumps(f) for f in failures]
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + ("\n" if lines else ""))
        logger.info("%d failures written to %s", len(failures), args.out)
    else:
        for line in lines:
            print(line)
    return failures


if __name__ == "__main__":
    main()
