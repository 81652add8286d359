"""Merge per-host/per-shard VCFs into one sorted call set.

The multi-host story: each host calls its deterministic region shard
(``--process_index/--process_count``) into its own VCF; this tool merges them
(the reference's cat + vcf-sort step, reference prepareVcf.py:185-260).
"""

from __future__ import annotations

import argparse
import glob
import logging

from ..io.fasta import FastaFile
from ..io.vcf import merge_vcfs

logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(description="hello_tpu VCF merge")
    parser.add_argument("--inputs", required=True, nargs="+",
                        help="VCF paths or globs to merge")
    parser.add_argument("--out", required=True)
    parser.add_argument("--ref", default=None,
                        help="reference FASTA (for contig headers)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    paths = []
    for spec in args.inputs:
        expanded = sorted(glob.glob(spec))
        paths.extend(expanded if expanded else [spec])

    contigs = None
    if args.ref:
        ref = FastaFile(args.ref)
        contigs = {c: ref.length(c) for c in ref.chromosomes()}
    merge_vcfs(paths, args.out, contigs=contigs)
    logger.info("merged %d files into %s", len(paths), args.out)
    logger.info("Completed running the script")


if __name__ == "__main__":
    main()
