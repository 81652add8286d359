"""Reconstruct a VCF from labeled training shards.

Label-correctness validation: writing a VCF from the labels themselves lets
the label set be compared (e.g. with the evaluator) against the truth VCF —
the reference's ``--test_labeling`` / vcf_from_training_data path
(reference caller_calling.py:152-215, python/vcf_from_training_data.py).
"""

from __future__ import annotations

import argparse
import glob
import logging
from typing import List

from ..io.fasta import FastaFile
from ..io.vcf import VcfRecord, make_record, write_vcf
from ..train.store import ShardReader

logger = logging.getLogger(__name__)


def records_from_shards(index_paths, ref: FastaFile) -> List[VcfRecord]:
    ref_lookup = lambda chrom, pos: ref.fetch(chrom, pos, pos + 1)
    records = []
    for path in index_paths:
        for site in ShardReader(path):
            if site.labels is None:
                continue
            ref_allele = ref.fetch(site.chromosome, site.start, site.stop)
            positives = [a for a, l in zip(site.alleles, site.labels) if l > 0]
            if not positives:
                continue
            alt_alleles = [a for a in positives if a != ref_allele]
            if not alt_alleles:
                continue  # hom-ref site: nothing to emit
            numbering = {a: i + 1 for i, a in enumerate(alt_alleles)}
            numbering[ref_allele] = 0
            genotypes = [numbering[a] for a in positives]
            if len(genotypes) == 1:
                genotypes = genotypes * 2
            rec = make_record(site.chromosome, site.start, ref_allele,
                              alt_alleles, genotypes[:2], ref_lookup,
                              qual=50.0, info="LabeledFromGroundTruth")
            if rec is not None:
                records.append(rec)
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu: VCF from labeled training shards")
    parser.add_argument("--data", required=True,
                        help=".lst of shard indices, or a glob")
    parser.add_argument("--ref", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.data.endswith(".lst"):
        with open(args.data) as fh:
            paths = [l.strip() for l in fh if l.strip()]
    else:
        paths = sorted(glob.glob(args.data))
    ref = FastaFile(args.ref)
    records = records_from_shards(paths, ref)
    contigs = {c: ref.length(c) for c in ref.chromosomes()}
    write_vcf(args.out, records, contigs=contigs)
    logger.info("wrote %d label-derived records to %s", len(records), args.out)
    logger.info("Completed running the script")


if __name__ == "__main__":
    main()
