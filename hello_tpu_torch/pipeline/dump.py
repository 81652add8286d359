"""Training-data dump driver: labeled site tensors -> memmap shards.

Equivalent of the reference training-data pipeline (reference python/dump.py +
caller.py in truth mode): hotspot detection, candidate generation, truth
labeling against a VCF + high-confidence BED, and tensor dumping to the
memmap store.
"""

from __future__ import annotations

import argparse
import logging
import random
from typing import List, Optional, Sequence

from ..constants import MAX_ITEMS_PER_GROUP_TRAIN
from ..io.fasta import FastaFile
from ..train.store import write_shards
from .candidates import generate_sites
from .hotspots import (candidate_intervals, cluster_hotspots, detect_hotspots,
                       make_read_sources)
from .labeling import make_truth_labeler

logger = logging.getLogger(__name__)


def dump_region(bam_paths: Sequence[str], ref: FastaFile, chromosome: str,
                start: int, stop: int, truth_vcf: str, highconf_bed: str,
                out_prefix: str,
                pacbio: bool = False, include_hp: bool = False,
                hybrid_hotspot: bool = False,
                q_threshold: int = 10, min_mapq: int = 10,
                reassembly_size: int = 10,
                sites_per_shard: int = 1000,
                seed: int = 13,
                stats: Optional[dict] = None) -> List[str]:
    """Dump labeled training shards for one region; returns index paths."""
    rng = random.Random(seed)
    hotspot_sources = make_read_sources(bam_paths, pacbio, for_hotspots=True, rng=rng,
                                        region=(chromosome, start, stop))
    positions = detect_hotspots(
        hotspot_sources, ref, chromosome, start, stop, pacbio=pacbio,
        hybrid_hotspot=hybrid_hotspot, q_threshold=q_threshold,
        min_mapq=min_mapq)
    if not positions:
        return []
    active = cluster_hotspots(positions)
    sources = make_read_sources(bam_paths, pacbio, rng=rng,
                                region=(chromosome, start, stop))
    intervals, windows = candidate_intervals(
        sources, ref, chromosome, active, pacbio=pacbio,
        hybrid_hotspot=hybrid_hotspot, q_threshold=q_threshold,
        min_mapq=min_mapq, include_hp=include_hp,
        reassembly_size=reassembly_size, provide_windows=True)

    labeler = make_truth_labeler(truth_vcf, highconf_bed)
    site_iter = generate_sites(
        sources, ref, chromosome, intervals, windows=windows, pacbio=pacbio,
        include_hp=include_hp, hybrid_hotspot=hybrid_hotspot,
        q_threshold=q_threshold, min_mapq=min_mapq,
        reassembly_size=reassembly_size, labeler=labeler,
        max_items_per_group=MAX_ITEMS_PER_GROUP_TRAIN, stats=stats)
    return write_shards(site_iter, out_prefix, sites_per_shard)


def main(argv=None):
    parser = argparse.ArgumentParser(description="hello_tpu training-data dump")
    parser.add_argument("--bam", required=True)
    parser.add_argument("--ref", required=True)
    parser.add_argument("--truth", required=True, help="truth VCF")
    parser.add_argument("--highconf", required=True, help="high-confidence BED")
    parser.add_argument("--out_prefix", required=True)
    parser.add_argument("--region", default=None, help="chrom[,start,stop]")
    parser.add_argument("--pacbio", action="store_true")
    parser.add_argument("--include_hp", action="store_true")
    parser.add_argument("--hybrid_hotspot", action="store_true")
    parser.add_argument("--q_threshold", type=int, default=10)
    parser.add_argument("--mapq_threshold", type=int, default=10)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    ref = FastaFile(args.ref)
    if args.region:
        parts = args.region.split(",")
        regions = [(parts[0], int(parts[1]), int(parts[2]))] if len(parts) == 3 \
            else [(parts[0], 0, ref.length(parts[0]))]
    else:
        regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]

    stats = {}
    all_paths = []
    for i, (chrom, start, stop) in enumerate(regions):
        paths = dump_region(
            args.bam.split(","), ref, chrom, start, stop, args.truth,
            args.highconf, f"{args.out_prefix}_{i:03d}",
            pacbio=args.pacbio, include_hp=args.include_hp,
            hybrid_hotspot=args.hybrid_hotspot,
            q_threshold=args.q_threshold, min_mapq=args.mapq_threshold,
            stats=stats)
        all_paths.extend(paths)

    with open(args.out_prefix + ".lst", "w") as fh:
        for p in all_paths:
            fh.write(p + "\n")
    logger.info("wrote %d shards (%s); stats: %s",
                len(all_paths), args.out_prefix + ".lst", stats)
    logger.info("Completed running the script")


if __name__ == "__main__":
    main()
