"""Generate dump commands pairing each base-platform BAM with a random BAM of
the other platform, one command per chromosome.

Equivalent of the reference's training-data pipeline wrapper
(reference python/gen_random_dump_combinations.py): hybrid models are trained
on random Illumina x PacBio coverage pairings, so the dump jobs mix files
across platforms.  Commands target this framework's dump CLI
(``python -m hello_tpu.pipeline.dump``).
"""

from __future__ import annotations

import argparse
import os
import random

from ..io.fasta import FastaFile


def generate_commands(ibams, pbams, ref_path, truth, highconf, workdir,
                      iteration_base="i", chromosomes=None, seed=13,
                      q_threshold=10, mapq_threshold=10):
    ref = FastaFile(ref_path)
    if chromosomes is None:
        chromosomes = ref.chromosomes()
    rng = random.Random(seed)
    base, select = (ibams, pbams) if iteration_base == "i" else (pbams, ibams)
    commands = []
    for bi, bam in enumerate(base):
        for chrom in chromosomes:
            other = rng.choice(select)
            pair = (bam, other) if iteration_base == "i" else (other, bam)
            out_prefix = os.path.join(
                workdir, f"dump_{bi:02d}_{os.path.basename(bam)}_{chrom}")
            commands.append(
                "python -m hello_tpu.pipeline.dump"
                f" --bam {pair[0]},{pair[1]}"
                f" --ref {ref_path}"
                f" --truth {truth}"
                f" --highconf {highconf}"
                f" --region {chrom}"
                f" --out_prefix {out_prefix}"
                f" --q_threshold {q_threshold}"
                f" --mapq_threshold {mapq_threshold}")
    return commands


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="random hybrid BAM pairings for training-data dumps")
    parser.add_argument("--ibams", required=True,
                        help="file listing Illumina BAMs (one per line)")
    parser.add_argument("--pbams", required=True,
                        help="file listing PacBio BAMs (one per line)")
    parser.add_argument("--ref", required=True)
    parser.add_argument("--truth", required=True)
    parser.add_argument("--highconf", required=True)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--iteration_base", choices=["i", "p"], default="i",
                        help="which platform's file list drives the pairing")
    parser.add_argument("--seed", type=int, default=13)
    parser.add_argument("--q_threshold", type=int, default=10)
    parser.add_argument("--mapq_threshold", type=int, default=10)
    args = parser.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    with open(args.ibams) as fh:
        ibams = [l.strip() for l in fh if l.strip()]
    with open(args.pbams) as fh:
        pbams = [l.strip() for l in fh if l.strip()]
    commands = generate_commands(
        ibams, pbams, args.ref, args.truth, args.highconf, args.workdir,
        iteration_base=args.iteration_base, seed=args.seed,
        q_threshold=args.q_threshold, mapq_threshold=args.mapq_threshold)
    out = os.path.join(args.workdir, "commands.sh")
    with open(out, "w") as fh:
        fh.write("\n".join(commands) + "\n")
    print(out)
    return commands


if __name__ == "__main__":
    main()
