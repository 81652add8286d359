"""Chromosome-scale capacity soak of the port: generate a many-chromosome
genome streaming to disk (one chromosome at a time, bounded memory), train
a gate checkpoint on a slice of its first chromosome, call the whole genome
with the worker-pool caller, and record peak RSS, sustained windows/s, BAI
region-open latency, the PCIe probe before and after the call, and the
calls' accuracy against the planted truth.

Memory must stay bounded by the chunked decomposition (region-indexed BAI
fetches, one genome chunk per worker at a time), never by file size.  The
accuracy against the planted truth makes the run a correctness gate: a
spill/merge or wire fault that drops records shows as lost recall.  The
gate checkpoint is trained, and the genome called, at the precision of
``HELLO_TPU_PRECISION`` (``bf16`` unless set, the calling CLI's default).

Usage: python -m hello_tpu_torch.pipeline.soak [--mb 100] [--coverage 30]
           [--workers N] [--device cuda:N|cpu]
           [--out soak_out/soak_report.md]

It writes ``--out`` (markdown) and the same path with ``.json``; the
default lies in the git-ignored ``soak_out/``.  The data lives under
``--dir``, by default a new directory under the temporary directory; a
directory that the run created is removed at its end unless ``--keep``,
``--reuse`` or ``--gen_only`` is given.  Without ``--device`` it scores on
every visible card and trains and probes on the current one; it raises at
once on a machine without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import resource
import statistics
import threading
import time

import numpy as np


def _tree_rss_mb() -> float:
    """Total resident set of this process and every descendant, in MB."""
    try:
        import psutil
        p = psutil.Process()
        procs = [p] + p.children(recursive=True)
        total = 0
        for q in procs:
            try:
                total += q.memory_info().rss
            except Exception:
                pass
        return total / 1e6
    except ImportError:
        pass
    # /proc fallback: walk pids, sum VmRSS of self + descendants
    me = os.getpid()
    ppids, rss = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/status") as fh:
                fields = dict(line.split(":", 1) for line in fh
                              if ":" in line)
            ppids[int(pid)] = int(fields.get("PPid", "0").strip() or 0)
            rss[int(pid)] = int(fields.get("VmRSS", "0 kB").split()[0])
        except Exception:
            continue
    mine = {me}
    changed = True
    while changed:
        changed = False
        for pid, pp in ppids.items():
            if pp in mine and pid not in mine:
                mine.add(pid)
                changed = True
    return sum(rss.get(pid, 0) for pid in mine) / 1e3


class RssSampler(threading.Thread):
    def __init__(self, interval: float = 1.0):
        super().__init__(daemon=True)
        self.interval = interval
        self.peak_mb = 0.0
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            self.peak_mb = max(self.peak_mb, _tree_rss_mb())
            self._halt.wait(self.interval)

    def stop(self):
        self._halt.set()
        self.join(timeout=5)
        return self.peak_mb


def generate_streaming(outdir: str, total_bases: int, chrom_bases: int,
                       coverage: float, read_length: int, seed: int,
                       variants_per_mb: int = 3200):
    """Build ref.fa + truth.vcf + one sorted+indexed illumina BAM spanning
    ``total_bases`` across ``total_bases // chrom_bases`` chromosomes,
    generating and writing one chromosome at a time so memory stays bounded
    by a single chromosome's reads, not the whole file."""
    from .. import sim
    from ..io.bam import BamStreamWriter
    from ..io.vcf import VcfRecord, write_vcf

    os.makedirs(outdir, exist_ok=True)
    rng = random.Random(seed)
    n_chroms = max(1, total_bases // chrom_bases)
    names = [f"chrS{i + 1}" for i in range(n_chroms)]
    lengths = {}

    # pass 1: reference (chromosome sequences are regenerated per pass from
    # per-chromosome seeds so only one sequence is alive at a time)
    chrom_seeds = [rng.randrange(2 ** 60) for _ in names]

    def chrom_seq(i):
        return sim.random_reference(chrom_bases, random.Random(chrom_seeds[i]))

    fasta_path = os.path.join(outdir, "ref.fa")
    with open(fasta_path, "w") as fh:
        for i, name in enumerate(names):
            seq = chrom_seq(i)
            lengths[name] = len(seq)
            fh.write(f">{name}\n")
            for j in range(0, len(seq), 80):
                fh.write(seq[j:j + 80] + "\n")
    # .fai sidecar via the fasta writer's convention
    from ..io.fasta import FastaFile
    FastaFile(fasta_path)          # builds/validates the index

    n_var = max(1, int(variants_per_mb * chrom_bases / 1e6))
    bam_path = os.path.join(outdir, "illumina.bam")
    truth_records = []
    writer = BamStreamWriter(bam_path, [(n, lengths[n]) for n in names])
    t0 = time.time()
    total_reads = 0
    for i, name in enumerate(names):
        crng = random.Random(chrom_seeds[i] ^ 0xBEEF)
        seq = chrom_seq(i)
        variants = sim.plant_variants(seq, n_var, crng)
        # varied per-base qualities: real BAM quality strings are
        # high-entropy (most of a real file's compressed bytes), so the
        # soak's file size is honest only with non-constant quals
        reads = sim.simulate_reads(seq, variants, name, coverage,
                                   read_length, crng, qual=(20, 40),
                                   name_prefix=f"il_{name}_")
        writer.add_reads(reads)
        total_reads += len(reads)
        for v in variants:
            truth_records.append(VcfRecord(name, v.position, v.ref, [v.alt],
                                           (v.genotype[0], v.genotype[1]),
                                           qual=50.0))
        del reads, seq, variants
    writer.close()
    truth_path = os.path.join(outdir, "truth.vcf")
    write_vcf(truth_path, truth_records, contigs=lengths)
    gen_s = time.time() - t0
    return {
        "fasta": fasta_path, "bam": bam_path, "truth": truth_path,
        "chromosomes": names, "lengths": lengths, "reads": total_reads,
        "bam_bytes": os.path.getsize(bam_path),
        "truth_variants": len(truth_records), "generation_s": round(gen_s, 1),
    }


def measure_bai_latency(bam_path: str, lengths: dict, n: int = 20,
                        span: int = 200_000, seed: int = 7):
    """Open-time of indexed region fetches at random loci (the O(region)
    guarantee the BAI work exists for)."""
    from .. import native

    rng = random.Random(seed)
    names = list(lengths)
    times = []
    for _ in range(n):
        name = rng.choice(names)
        start = rng.randrange(0, max(1, lengths[name] - span))
        t0 = time.perf_counter()
        bam = native.NativeBam(bam_path, region=(name, start, start + span))
        _ = bam.ref_starts.shape[0]   # region records are decoded at open
        del bam
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "n": n, "span": span,
        "p50_ms": round(1e3 * statistics.median(times), 2),
        "p95_ms": round(1e3 * times[int(0.95 * (n - 1))], 2),
    }


def _data_dir(path):
    """The dataset's directory and whether this run creates it: a new one
    under the temporary directory by default, so that no two runs share
    one.  Only a directory that the run created is removed at its end."""
    if path is None:
        import tempfile
        return tempfile.mkdtemp(prefix="hello_tpu_torch_soak_"), True
    return path, not os.path.exists(path)


#: the reference's report files, which this tool must never overwrite
REFERENCE_REPORTS = ("SOAK.md", "SOAK.json")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mb", type=int, default=100)
    parser.add_argument("--chrom_mb", type=int, default=10)
    parser.add_argument("--coverage", type=float, default=30.0)
    # cpus + 2, capped at 8: workers block on BAM IO and IPC enough that
    # modest oversubscription keeps the cores busy
    parser.add_argument("--workers", type=int,
                        default=min(8, (os.cpu_count() or 2) + 2))
    parser.add_argument("--dir", default=None,
                        help="the dataset's directory (default: a new one "
                             "under the temporary directory)")
    parser.add_argument("--out", default=os.path.join("soak_out",
                                                      "soak_report.md"))
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--keep", action="store_true",
                        help="keep the generated dataset")
    parser.add_argument("--reuse", action="store_true",
                        help="reuse an existing dataset in --dir (from a "
                             "previous --keep run); implies --keep")
    parser.add_argument("--untrained", action="store_true",
                        help="skip the gate-checkpoint training step and "
                             "call with random weights (capacity-only soak)")
    parser.add_argument("--gate_checkpoint", default=None,
                        help="reuse an existing gate checkpoint instead of "
                             "retraining (call-phase reruns)")
    parser.add_argument("--train_mb", type=int, default=2,
                        help="Mb of the first chromosome to dump+train the "
                             "accuracy-gate checkpoint on")
    parser.add_argument("--gen_only", action="store_true",
                        help="generate the dataset and stop (pair with "
                             "--reuse later); implies --keep")
    parser.add_argument("--device", default=None,
                        help="cuda:N (one card) or cpu; default: scoring on "
                             "every visible card, training and the PCIe "
                             "probe on the current one")
    args = parser.parse_args(argv)
    if os.path.basename(args.out) in REFERENCE_REPORTS or \
            not args.out.endswith(".md"):
        parser.error(f"--out {args.out}: give a .md path other than the "
                     f"reference's {REFERENCE_REPORTS[0]}")
    if args.reuse and args.dir is None:
        parser.error("--reuse needs the --dir of a kept dataset")

    import torch

    from .call import load_scorer, resolve_device, visible_devices
    from .precision_sweep import _card

    # the device first: a run without a card fails before generating data
    if args.device is None:
        visible_devices()
    else:
        resolve_device(args.device)
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    card = _card("cuda" if on_card else "cpu")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    args.dir, created = _data_dir(args.dir)

    sampler = RssSampler()
    sampler.start()

    meta_path = os.path.join(args.dir, "soak_meta.json")
    if args.reuse and os.path.exists(meta_path):
        with open(meta_path) as fh:
            ds = json.load(fh)
        print(f"reusing dataset under {args.dir}", flush=True)
    else:
        print(f"generating {args.mb} Mb dataset under {args.dir} ...",
              flush=True)
        ds = generate_streaming(args.dir, args.mb * 1_000_000,
                                args.chrom_mb * 1_000_000, args.coverage, 120,
                                args.seed)
        with open(meta_path, "w") as fh:
            json.dump(ds, fh)
    if args.gen_only:
        sampler.stop()
        print(json.dumps({"generated": ds["bam_bytes"],
                          "generation_s": ds["generation_s"]}), flush=True)
        return
    gen_peak_mb = sampler.peak_mb
    print(f"dataset: {ds['bam_bytes'] / 1e9:.2f} GB BAM, {ds['reads']} reads, "
          f"{ds['truth_variants']} variants in {ds['generation_s']}s "
          f"(gen peak RSS {gen_peak_mb:.0f} MB)", flush=True)

    bai = measure_bai_latency(ds["bam"], ds["lengths"])
    print(f"BAI region open: p50 {bai['p50_ms']} ms, p95 {bai['p95_ms']} ms",
          flush=True)

    # the calling CLI's default precision, set before training as well: the
    # gate checkpoint is trained at it and the Scorer folds for its route
    from ..nn import layers
    precision = os.environ.get("HELLO_TPU_PRECISION", "bf16")
    layers.set_precision(precision)
    from .parallel_call import HostWorkerPool, call_parallel

    # Train a real checkpoint on a slice of the first chromosome first
    # (unless --untrained): the calling accuracy is then a genotype-level
    # correctness gate at planted-truth scale, not a random-weight smoke.
    checkpoint = None
    train_s = None
    if args.gate_checkpoint:
        checkpoint = args.gate_checkpoint
        print(f"reusing gate checkpoint {checkpoint}", flush=True)
    elif not args.untrained:
        from ..io.fasta import FastaFile
        from ..train.cli import train_from_shards
        from .dump import dump_region

        t0 = time.perf_counter()
        slice_stop = min(args.train_mb * 1_000_000,
                         ds["lengths"][ds["chromosomes"][0]])
        chrom0 = ds["chromosomes"][0]
        bed = os.path.join(args.dir, "train_slice.bed")
        with open(bed, "w") as fh:
            fh.write(f"{chrom0}\t0\t{slice_stop}\n")
        ref = FastaFile(ds["fasta"])
        shards = dump_region([ds["bam"]], ref, chrom0, 0, slice_stop,
                             ds["truth"], bed,
                             os.path.join(args.dir, "train_dump"))
        train_from_shards(shards, "illumina",
                          os.path.join(args.dir, "soak_model"),
                          num_epochs=4, lr=1e-3, num_devices=1,
                          batch_alleles=32, read_bucket=64,
                          max_reads_per_site=48, val_fraction=0.0,
                          device=args.device)
        checkpoint = os.path.join(args.dir, "soak_model.final.ckpt")
        train_s = time.perf_counter() - t0
        print(f"trained gate checkpoint on {chrom0}:0-{slice_stop} "
              f"in {train_s:.0f}s", flush=True)
    train_peak_mb = sampler.peak_mb

    scorer = load_scorer("illumina", checkpoint, device=args.device)
    pool = HostWorkerPool(args.workers)
    pool.wait_ready()
    # the tree's RSS with the workers up and idle, and the call's own peak
    # above it: what the workers hold before any data, apart from what the
    # call adds (sampled every 0.1 s: a short call lasts a few seconds)
    ready_mb = _tree_rss_mb()
    call_sampler = RssSampler(interval=0.1)
    call_sampler.start()
    # PCIe probes bracketing the call phase, so that a slow call phase
    # shows whether the host-card link was slow with it
    from ..telemetry import tunnel_health
    tunnel_before = tunnel_health(seed=41, device=args.device)
    print(f"PCIe probe before call: {tunnel_before}", flush=True)
    stats = {}
    t0 = time.perf_counter()
    try:
        call_parallel([ds["bam"]], ds["fasta"], scorer,
                      os.path.join(args.dir, "calls.vcf"), pool=pool,
                      stats=stats)
    finally:
        call_peak_mb = call_sampler.stop()
        pool.shutdown()
    wall = time.perf_counter() - t0
    tunnel_after = tunnel_health(seed=42, device=args.device)
    print(f"PCIe probe after call: {tunnel_after}", flush=True)
    peak_mb = sampler.stop()
    # the running peaks at the end of each phase, and this process's own
    # peak (the workers' are the rest of the tree's)
    peaks = {"generation": gen_peak_mb, "gate_training": train_peak_mb,
             "call": peak_mb,
             "main_process": resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 1e3}
    print(f"peak RSS by phase (MB): {peaks}; at pool ready {ready_mb:.0f}, "
          f"call peak {call_peak_mb:.0f}", flush=True)
    sites = stats.get("sites", 0)
    rate = sites / wall if wall else 0.0

    # Calling accuracy against the planted truth.  With the trained gate
    # checkpoint these numbers gate genotypes; under --untrained (random
    # weights) only the candidate-level numbers mean anything: recall of
    # the planted sites and no representation-level corruption.
    from .evaluate import evaluate
    t0 = time.perf_counter()
    accuracy = evaluate(os.path.join(args.dir, "calls.vcf"), ds["truth"],
                        ds["fasta"])
    eval_s = time.perf_counter() - t0
    print(f"accuracy vs planted truth ({eval_s:.0f}s): "
          f"{accuracy['all']}", flush=True)

    # the dataset's own size: with --reuse, --mb need not describe it
    mb = sum(ds["lengths"].values()) / 1e6
    link = ("PCIe probe, host to card" if on_card
            else "host memory copy probe (--device cpu)")
    result = {
        "card": card, "precision": precision,
        "total_mb": mb, "coverage": args.coverage,
        "workers": args.workers,
        "bam_gb": round(ds["bam_bytes"] / 1e9, 3),
        "reads": ds["reads"], "truth_variants": ds["truth_variants"],
        "generation_s": ds["generation_s"],
        "bai_open_p50_ms": bai["p50_ms"], "bai_open_p95_ms": bai["p95_ms"],
        "call_wall_s": round(wall, 1), "scorable_sites": sites,
        "sustained_windows_per_s": round(rate, 1),
        "tunnel_before": tunnel_before, "tunnel_after": tunnel_after,
        "peak_rss_mb": round(peak_mb, 0),
        "peak_rss_by_phase_mb": {k: round(v, 0) for k, v in peaks.items()},
        "peak_rss_vs_bam": round(peak_mb * 1e6 / ds["bam_bytes"], 3),
        "rss_pool_ready_mb": round(ready_mb, 0),
        "call_peak_rss_mb": round(call_peak_mb, 0),
        "call_rss_growth_mb": round(call_peak_mb - ready_mb, 0),
        "stages": {k: round(v, 2) for k, v in stats.items()
                   if k.endswith("_s")},
        "gate_checkpoint": checkpoint, "gate_train_s": (
            round(train_s, 1) if train_s is not None else None),
        "accuracy": accuracy,
    }
    with open(args.out[:-len(".md")] + ".json", "w") as fh:
        json.dump(result, fh, indent=1)
    gate = ("untrained (capacity-only run)" if checkpoint is None
            else (f"trained on {args.train_mb} Mb in {train_s:.0f}s"
                  if train_s is not None else f"reused {checkpoint}"))
    with open(args.out, "w") as fh:
        fh.write(f"""# Capacity soak of hello_tpu_torch — {mb:g} Mb, {args.coverage:.0f}x

Device: {card}; precision {precision}.

Simulated {mb:g} Mb over {len(ds['chromosomes'])} chromosomes at
{args.coverage:.0f}x ({ds['bam_bytes'] / 1e9:.2f} GB sorted+indexed BAM,
{ds['reads']:,} reads, {ds['truth_variants']:,} planted variants;
generated streaming in {ds['generation_s']}s), then ran the worker-pool
caller (`pipeline/parallel_call.py`, {args.workers} workers) end-to-end.

| metric | value |
|---|---|
| BAM size | {ds['bam_bytes'] / 1e9:.2f} GB |
| BAI region open (200 kb) | p50 {bai['p50_ms']} ms / p95 {bai['p95_ms']} ms |
| calling wall time | {wall:.1f} s |
| scorable sites | {sites:,} |
| sustained throughput | {rate:,.0f} windows/s |
| {link} (up MB/s before/after) | {tunnel_before['up_mbps']:.0f} / {tunnel_after['up_mbps']:.0f} (rtt {tunnel_before['rtt_ms']:.3f} / {tunnel_after['rtt_ms']:.3f} ms) |
| peak tree RSS (whole run incl. generation) | {peak_mb:.0f} MB |
| running peak at the end of generation / gate training / call; this process's own | {peaks['generation']:.0f} / {peaks['gate_training']:.0f} / {peaks['call']:.0f}; {peaks['main_process']:.0f} MB |
| peak RSS / BAM size | {result['peak_rss_vs_bam']:.2f} |
| tree RSS with the {args.workers} workers ready, before the call; the call's peak above it | {ready_mb:.0f} MB; {call_peak_mb - ready_mb:.0f} MB |
| main-loop stages (s) | {result['stages']} |
| accuracy vs planted truth (all) | {accuracy['all']} |
| accuracy: snv / ins / del | {accuracy['snv']} / {accuracy['ins']} / {accuracy['del']} |
| gate checkpoint | {gate} |

Memory stays bounded by the chunked decomposition (region-indexed BAI
fetches, one genome chunk per worker at a time), not by file size.  The
accuracy row makes the soak a correctness gate at planted-truth scale: a
spill/merge or wire fault dropping records would surface as recall loss.
""")
    print(json.dumps(result), flush=True)
    if created and not (args.keep or args.reuse or args.gen_only):
        import shutil
        shutil.rmtree(args.dir, ignore_errors=True)


if __name__ == "__main__":
    main()
