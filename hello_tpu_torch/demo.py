"""One-command end-to-end demo: simulate -> dump -> train -> call -> evaluate.

``python -m hello_tpu_torch.demo --outdir DIR`` runs the port on a simulated
diploid genome with sequencing noise, as hello_tpu's demo.py does with the
same flags: it dumps labeled training shards, trains a model from scratch,
calls a DISJOINT simulated genome with it, and prints precision and recall
against the known truth as one JSON summary.  It trains and calls on the
card unless ``--device cpu`` is given.  A smoke test of an installation
(the native engine, the CUDA kernel) and a worked example of the library
surface.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu_torch end-to-end demo on simulated data")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--train_ref_length", type=int, default=40_000)
    parser.add_argument("--train_variants", type=int, default=100)
    parser.add_argument("--test_ref_length", type=int, default=20_000)
    parser.add_argument("--test_variants", type=int, default=50)
    parser.add_argument("--coverage", type=float, default=35.0)
    parser.add_argument("--epochs", type=int, default=6)
    parser.add_argument("--sub_error_rate", type=float, default=0.01)
    parser.add_argument("--indel_error_rate", type=float, default=0.001)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--hybrid", action="store_true",
                        help="Illumina + PacBio input through the full "
                             "3-expert hybrid model")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    from . import sim
    from .io.fasta import FastaFile
    from .io.vcf import write_vcf
    from .pipeline.call import call_region, load_scorer, resolve_device
    from .pipeline.dump import dump_region
    from .pipeline.evaluate import evaluate
    from .train.cli import train_from_shards

    device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    platforms = ("illumina", "pacbio") if args.hybrid else ("illumina",)
    model_name = "hybrid" if args.hybrid else "illumina"
    noise = dict(sub_error_rate=args.sub_error_rate,
                 indel_error_rate=args.indel_error_rate)
    t0 = time.time()

    logger.info("simulating training genome (%d bp, %d variants, %.0fx)...",
                args.train_ref_length, args.train_variants, args.coverage)
    tr = sim.make_dataset(os.path.join(args.outdir, "train"),
                          ref_length=args.train_ref_length,
                          num_variants=args.train_variants,
                          coverage=args.coverage, read_length=120,
                          seed=args.seed, platforms=platforms, **noise)
    te = sim.make_dataset(os.path.join(args.outdir, "test"),
                          ref_length=args.test_ref_length,
                          num_variants=args.test_variants,
                          coverage=args.coverage, read_length=120,
                          seed=args.seed + 54, platforms=platforms, **noise)

    bed = os.path.join(args.outdir, "train", "conf.bed")
    with open(bed, "w") as fh:
        fh.write(f"{tr.chromosome}\t0\t{args.train_ref_length}\n")

    logger.info("dumping labeled training shards...")
    tr_bams = [tr.bams[p] for p in platforms]
    te_bams = [te.bams[p] for p in platforms]
    shards = dump_region(tr_bams, FastaFile(tr.fasta),
                         tr.chromosome, 0, args.train_ref_length,
                         tr.truth_vcf, bed,
                         os.path.join(args.outdir, "shards"))
    logger.info("training %s (%d epochs) on %s...", model_name, args.epochs,
                device)
    model_prefix = os.path.join(args.outdir, "model")
    train_from_shards(shards, model_name, model_prefix,
                      num_epochs=args.epochs, lr=1e-3, num_devices=1,
                      batch_alleles=32, read_bucket=64,
                      max_reads_per_site=48, val_fraction=0.0, device=device)

    logger.info("calling the held-out genome...")
    scorer = load_scorer(model_name, model_prefix + ".final.ckpt",
                         device=device)
    records = call_region(te_bams, FastaFile(te.fasta), te.chromosome, 0,
                          args.test_ref_length, scorer)
    calls_vcf = os.path.join(args.outdir, "calls.vcf")
    write_vcf(calls_vcf, records,
              contigs={te.chromosome: args.test_ref_length}, sort=True)

    report = evaluate(calls_vcf, te.truth_vcf, te.fasta)
    summary = {
        "calls_vcf": calls_vcf,
        "truth_vcf": te.truth_vcf,
        "seconds": round(time.time() - t0, 1),
        "metrics": report["all"],
    }
    print(json.dumps(summary, indent=2))
    logger.info("Completed running the script")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
