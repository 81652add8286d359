"""The reduced precisions against fp32 on the card: ``bf16`` and ``default``
each against ``highest`` across the four platform configs, on simulated
genomes of ``--variants`` variants each, counting site flips, genotype flips
and the quality-delta distribution (hello_tpu's precision_sweep, run on the
port).

Every precision runs its own read-conv kernel route on the card (3xTF32 for
``highest``, 1xTF32 for ``default``, bf16 for ``bf16``) and its own cuDNN /
cuBLAS mode for the other layers; the report counts each route's launches.
Same weights (seeded), same sites, the production decode path.

Usage: python -m hello_tpu_torch.pipeline.precision_sweep [--variants 5200]
           [--out precision_sweep_out/precision_sweep.md] [--device cuda]

It writes ``--out`` (markdown) and the same path with ``.json``; the default
lies in the git-ignored ``precision_sweep_out/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

CONFIGS = [
    # name, platforms, model, call kwargs
    ("illumina", ("illumina",), "illumina", {}),
    ("pacbio", ("pacbio",), "pacbio", {"pacbio": True}),
    ("pacbio_hp", ("pacbio",), "pacbio_hp",
     {"pacbio": True, "include_hp": True}),
    ("hybrid", ("illumina", "pacbio"), "hybrid", {}),
]

#: the reference's report files, which this tool must never overwrite
REFERENCE_REPORTS = ("PRECISION_SWEEP.md", "PRECISION_SWEEP.json")


def _call(ds, platforms, model_name, precision, kwargs, device):
    """Records of one whole-genome call at a precision, the sites scored,
    the seconds taken and the read-conv kernel's launches per route."""
    import torch

    from .. import telemetry
    from ..io.fasta import FastaFile
    from ..nn import layers
    from ..ops import read_conv as rc
    from .call import call_region, load_scorer

    layers.set_precision(precision)
    scorer = load_scorer(model_name, seed=0, device=device)
    ref = FastaFile(ds.fasta)
    bams = [ds.bams[p] for p in platforms]
    stats = {}
    before = telemetry.counts()
    t0 = time.perf_counter()
    records = call_region(bams, ref, ds.chromosome, 0,
                          ref.length(ds.chromosome), scorer,
                          stats=stats, **kwargs)
    if scorer.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (records, stats.get("sites", 0), wall,
            rc.route_launches(before))


def compare(rec_hi, rec_lo):
    """(site_flips, genotype_flips, qual_deltas) between two record lists."""
    hi = {(r.chromosome, r.position, r.ref, tuple(r.alt)): r for r in rec_hi}
    lo = {(r.chromosome, r.position, r.ref, tuple(r.alt)): r for r in rec_lo}
    site_flips = len(set(hi) ^ set(lo))
    gt_flips = 0
    deltas = []
    for key in set(hi) & set(lo):
        if hi[key].gt != lo[key].gt:
            gt_flips += 1
        deltas.append(abs(hi[key].qual - lo[key].qual))
    return site_flips, gt_flips, np.asarray(deltas)


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device when it is not a card."""
    if device != "cuda":
        return device
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", type=int, default=5200)
    parser.add_argument("--coverage", type=float, default=32.0)
    parser.add_argument("--out", default=os.path.join(
        "precision_sweep_out", "precision_sweep.md"))
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if os.path.basename(args.out) in REFERENCE_REPORTS or \
            not args.out.endswith(".md"):
        parser.error(f"--out {args.out}: give a .md path other than the "
                     f"reference's {REFERENCE_REPORTS[0]}")

    from .. import sim
    from ..nn import layers

    ref_length = int(args.variants * 310)
    rows = []
    try:
        for name, platforms, model_name, kwargs in CONFIGS:
            with tempfile.TemporaryDirectory(prefix=f"psweep_{name}_") as d:
                ds = sim.make_dataset(
                    d, ref_length=ref_length, num_variants=args.variants,
                    coverage=args.coverage, read_length=120, seed=args.seed,
                    platforms=platforms,
                    hp_tags=kwargs.get("include_hp", False))
                rec_hi, sites, wall_hi, _ = _call(
                    ds, platforms, model_name, "highest", kwargs, args.device)
                for precision in ("bf16", "default"):
                    rec_p, _, wall, launches = _call(
                        ds, platforms, model_name, precision, kwargs,
                        args.device)
                    site_flips, gt_flips, deltas = compare(rec_hi, rec_p)
                    hist_edges = [0.0, 0.001, 0.01, 0.05, 0.1, 0.5, 1e9]
                    hist = np.histogram(deltas, bins=hist_edges)[0].tolist() \
                        if len(deltas) else []
                    rows.append({
                        "config": name, "precision": precision,
                        "sites": sites, "records": len(rec_hi),
                        "site_flips": site_flips, "genotype_flips": gt_flips,
                        "qual_delta_max": float(deltas.max())
                        if len(deltas) else 0.0,
                        "qual_delta_p99": float(np.percentile(deltas, 99))
                        if len(deltas) else 0.0,
                        "qual_delta_hist": hist,
                        "seconds_highest": wall_hi, "seconds": wall,
                        "launches_by_route": launches,
                    })
                    print(json.dumps(rows[-1]), flush=True)
    finally:
        layers.set_precision("highest")

    def clean(precision):
        return all(r["site_flips"] == 0 and r["genotype_flips"] == 0
                   for r in rows if r["precision"] == precision)

    verdicts = {p: clean(p) for p in ("bf16", "default")}
    write_report(args.out, args.variants, rows, verdicts, _card(args.device))
    print(json.dumps({"clean": verdicts}), flush=True)


def write_report(out_path, variants, rows, verdicts, card):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path[:-3] + ".json", "w") as fh:
        json.dump({"card": card, "variants": variants, "rows": rows,
                   "clean": verdicts}, fh, indent=1)
    with open(out_path, "w") as fh:
        fh.write(f"# Precision sweep of hello_tpu_torch ({variants} variants "
                 f"per config) on {card}\n\n"
                 "Each precision against `--precision highest` (fp32, the "
                 "3xTF32 read-conv route, TF32 off), same weights, same "
                 "sites, production decode path.  `bf16` = bf16 conv "
                 "activations, the bf16 read-conv route, TF32 allowed "
                 "in cuBLAS (not cuDNN); "
                 "`default` = fp32 activations, the 1xTF32 route, TF32 "
                 "allowed.  Seconds are host wall time of one "
                 "`call_region` each, set-up included.\n\n"
                 "| config | precision | records | site flips | GT flips | "
                 "max dQ | p99 dQ | hist dQ in [0,.001,.01,.05,.1,.5,inf) "
                 "| s (highest) | s | launches by route |\n"
                 "|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            fh.write(f"| {r['config']} | {r['precision']} | {r['records']} "
                     f"| {r['site_flips']} | {r['genotype_flips']} | "
                     f"{r['qual_delta_max']} | {r['qual_delta_p99']} | "
                     f"{r['qual_delta_hist']} | {r['seconds_highest']} | "
                     f"{r['seconds']} | {r['launches_by_route']} |\n")
        fh.write(f"\nClean (zero site AND genotype flips): {verdicts}\n")


if __name__ == "__main__":
    main()
