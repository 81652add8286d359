"""Throughput benchmark of the port on the card: pileup windows per second.

The counterpart of ``bench.py`` at the repo's root (the JAX package's
benchmark, whose one JSON line is the "pileup windows/sec/chip" of
``BASELINE.md``), measured on an NVIDIA GPU.  Its legs, each the
counterpart of the one of the same name there:

  device     ``bench_device`` (``bench_tpu`` there): the flagship hybrid MoE
             eval forward over padded batches, on the dense ``PaddedBatch``
             and on the coded wire expanded to packed rows on the device;
             the illumina forward on the wire beside the end-to-end leg;
  training   ``bench_train``: the hybrid's training step on the coded wire,
             step-only and sustained (a fresh batch staged every step), at
             ``default`` and ``bf16``;
  baseline   ``bench_torch_baseline``: a one-thread torch CPU forward of the
             hybrid, the reference's execution model;
  end to end ``bench_pipeline``: the worker-pool caller on a simulated
             1.44 Mb genome (BAM fetch, hotspots, candidates, featurization,
             scoring, decode), bracketed by PCIe probes (``tunnel_health``).

It prints one JSON line with exactly the keys of ``bench.py``'s line.  The
device and pipeline legs launch ``read_conv_reduce`` on the route of
``--precision``; the training legs run the read convolvers' layers (the
trainer's path) and launch no kernel.

Where it departs from ``bench.py``:

  * a leg that fails raises, and the command exits non-zero; a value is
    null only when its ``--skip-*`` flag is given;
  * the baseline is the reference's model when ``--reference_python`` names
    the reference's ``python/`` directory, else the port's own hybrid
    network (seeded weights) on the CPU at one thread and ``highest``;
  * ``train_mfu_lower_bound_pct`` divides by the card's published peak of
    the math the training step's convs run at the leg's precision
    (``ops/bench_read_conv.CARD_PEAKS`` and ``MATH``), null on the CPU;
  * ``--precision`` defaults to ``bf16`` (no environment variable), and
    ``--device`` picks the device: ``cuda`` (the default; raises without a
    card) or ``cpu``, whose rates say nothing of the card's.

Usage: python -m hello_tpu_torch.bench [--sites 1024] [--iters 20]
           [--precision bf16] [--pipeline_workers N] [--skip-train]
           [--skip-baseline] [--skip-pipeline] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

import numpy as np

#: the end-to-end leg's genome (``bench.py``'s ``bench_pipeline`` defaults)
PIPELINE_BP = 1_440_000
PIPELINE_VARIANTS = 4800


def build_workload(rng, num_sites, alleles_per_site, reads0, reads1, L=150, C=6):
    """Ragged per-site workload, used for both the device and baseline paths.

    Cell values are drawn from the featurizer's actual color palettes
    (5 base colors, 41 quality levels, 70/240 strand and marker colors,
    per-read constants for mapq) with contiguous read spans — the statistics
    the compact wire format and the model see in production, and a
    requirement for the coded-wire training leg (random bytes would not
    code)."""
    from .pipeline.batching import SiteWork
    from .pipeline.compact import BASE_PALETTE, QUAL_PALETTE

    def read_block(num_reads, ref_colors, marker_row):
        t = np.zeros((num_reads, L, C), np.uint8)
        starts = rng.randint(0, L // 2, size=num_reads)
        stops = np.minimum(L, starts + rng.randint(L // 3, L, size=num_reads))
        for r in range(num_reads):
            s, e = starts[r], stops[r]
            t[r, s:e, 0] = BASE_PALETTE[rng.randint(0, 5, size=e - s)]
            t[r, s:e, 1] = ref_colors[s:e]
            t[r, s:e, 2] = QUAL_PALETTE[rng.randint(20, 41, size=e - s)]
            t[r, s:e, 3] = rng.randint(100, 160)        # mapq color (per read)
            t[r, s:e, 4] = 70 if rng.rand() < 0.5 else 240   # strand
            t[r, s:e, 5] = marker_row[s:e]
            if C == 7:
                t[r, s:e, 6] = (0, 120, 240)[rng.randint(0, 3)]
        return t

    sites = []
    for si in range(num_sites):
        n = alleles_per_site
        alleles = [f"a{si}_{i}" for i in range(n)]
        seg_codes = rng.randint(0, 5, size=L)
        seg = np.eye(5, dtype=np.float32)[seg_codes]
        ref_colors = np.array([250, 30, 180, 100, 0], np.uint8)[seg_codes]
        start, stop = 1000 + si, 1001 + si
        mid = (start + stop) // 2
        rel0 = start - (mid - L // 2)
        marker = np.full(L, 70, np.uint8)
        marker[rel0:rel0 + (stop - start)] = 240
        t0 = [read_block(reads0, ref_colors, marker) for _ in range(n)]
        t1 = [read_block(reads1, ref_colors, marker) for _ in range(n)]
        sites.append(SiteWork("chr20", start, stop, alleles, t0, t1, seg))
    return sites


def tunnel_health(size_mb: float = 8.0, seed: int = 0, device=None):
    """Transfer probe of the host-device link (``telemetry.tunnel_health``:
    PCIe on the card)."""
    from .telemetry import tunnel_health as probe

    return probe(size_mb, seed, device)


def _model(model_name, device, params=None):
    """``create_model(model_name)`` at full width on ``device``: the
    weights of ``params`` (a state dict), else the seeded init of seed 0."""
    import torch

    from .nn.convert import init_params
    from .nn.moe import create_model

    model = create_model(model_name)
    if params is None:
        init_params(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params, strict=True)
    return model.to(device)


def bench_device(sites, iters, precision, device, num_rotations=2,
                 model_name="hybrid", wire=False, params=None):
    """Windows/s of the eval forward, the counterpart of ``bench_tpu`` in
    ``bench.py``: the best median of three windows of ``iters`` iterations,
    spaced 2 s apart, each iteration reading the experts' logits back to
    the host, over ``num_rotations`` distinct batches resident on the
    device (the second and later drawn from ``RandomState(99)``), after one
    warm-up forward of each.

    The read convolvers are folded at ``precision``, as the Scorer folds
    them, so ``read_conv_reduce`` runs that precision's route.  ``wire``
    times the production input format on a card: the 1-byte coded wire
    expanded on the device to packed rows (``expand_compact_packed``), the
    kernel over only the shipped rows; otherwise the dense batch.

    Returns (windows/s, {"model", "folded", "batches" (on the device),
    "output": the warm forward's (experts, meta) of batch 0, on the
    host})."""
    from .nn.layers import set_precision
    from .ops.bench_packed import forward, timed, to_device
    from .pipeline.batching import pack_sites
    from .pipeline.compact import encode_chunk_sites, pack_sites_wire

    set_precision(precision)
    model = _model(model_name, device, params).eval()
    folded = model.fold_read_convs()
    rng2 = np.random.RandomState(99)
    batches = []
    for k in range(num_rotations):
        rotated = sites if k == 0 else build_workload(
            rng2, len(sites), len(sites[0].alleles),
            sites[0].tensors0[0].shape[0], sites[0].tensors1[0].shape[0])
        if wire:
            coded = encode_chunk_sites(rotated)
            if coded is None:
                raise ValueError("the bench workload must take the coded wire")
            arrays = pack_sites_wire(coded, hybrid=model.hybrid).wire
        else:
            arrays = pack_sites(rotated, hybrid=model.hybrid).device_dict()
        batches.append(to_device(arrays, device))
    path = "packed" if wire else "dense_batch"
    rate, output = timed(lambda b: forward(model, folded, path, b), batches,
                         iters, len(sites))
    return rate, {"model": model, "folded": folded, "batches": batches,
                  "output": output}


def label_sites(sites):
    """``bench.py``'s training labels: alleles alternate 0 and 1, every site
    label 0."""
    for s in sites:
        s.labels = [i % 2 for i in range(len(s.alleles))]
        s.site_label = 0


def train_wire_batch(sites) -> dict:
    """The training leg's stacked batch on the coded wire (labelled sites):
    featurizer output encoded to 1-byte codes, as the native orchestrator
    emits them in a real run."""
    from .pipeline.compact import (encode_chunk_sites, pack_sites_wire,
                                   stack_wire_batches, training_wire_dict)

    return stack_wire_batches([training_wire_dict(
        pack_sites_wire(encode_chunk_sites(sites), hybrid=True))])


def _finite(loss, what):
    if not math.isfinite(loss):
        raise FloatingPointError(f"{what}: non-finite training loss {loss}")
    return loss


def bench_train(sites, iters=10, precision="default", device="cuda",
                sustained=True, params=None):
    """Training-step throughput of the hybrid, ``bench_train`` of
    ``bench.py``: windows/s through forward, the MoE loss with its entropy
    regulariser, backward and the optimizer update (``Trainer.train_batch``),
    with a per-stage breakdown (host pack, host-to-device staging, the
    step), a FLOP lower bound and a SUSTAINED rate that stages a fresh
    batch every step.

    Batches ship on the coded wire (``train_wire_batch``, staged with
    ``Trainer.stage_batches``) and are expanded in the step; the dense
    pack and upload are timed beside it for the record.  Step-only: the
    best median of three spaced windows of ``iters`` synced steps.
    Sustained: a one-thread executor stages rotation i+1 while step i runs
    unsynced; each window ends by reading its last step's loss
    (``Trainer.read_metrics``) and joins the look-ahead stage.

    Training runs the read convolvers' layers, so no ``read_conv_reduce``
    may launch here (raises).  ``params`` gives the initial weights as a
    state dict (default: the trainer's seeded init).  Returns (windows/s,
    sustained windows/s or None, breakdown, {"first_loss", "last_loss"})."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from . import telemetry
    from .nn.layers import set_precision
    from .nn.moe import create_model
    from .ops import bench_read_conv as brc
    from .ops.read_conv import route_launches
    from .pipeline.batching import (pack_sites, stack_device_batches,
                                    training_dict)
    from .train.trainer import TrainConfig, Trainer

    set_precision(precision)
    label_sites(sites)
    trainer = Trainer(create_model("hybrid"),
                      TrainConfig(entropy_regularizer=0.1), device=device,
                      params=params)
    before = telemetry.counts()
    t0 = time.perf_counter()
    batch = pack_sites(sites, hybrid=True)
    dense = stack_device_batches([training_dict(batch)])
    dense_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.stage_batches(dense)
    dense_h2d_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    wire = train_wire_batch(sites)
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = trainer.stage_batches(wire)
    h2d_s = time.perf_counter() - t0

    first_loss = _finite(trainer.train_batch(db)["loss"], "first step")
    # best median of three spaced windows, the scheme of the device leg and
    # of the sustained loop below, so sustained cannot read faster than
    # step-only because its windows landed in a quieter phase
    step_s = last_loss = None
    for rep in range(3):
        if rep:
            time.sleep(2.0)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            metrics = trainer.train_batch(db)     # host floats => synced
            times.append(time.perf_counter() - t0)
            last_loss = _finite(metrics["loss"], "step-only window")
        med = statistics.median(times)
        step_s = med if step_s is None else min(step_s, med)

    # sustained: two rotations, so no transfer layer can reuse a copy;
    # double-buffered staging overlaps the upload of batch i+1 with step i
    sustained_s = None
    if sustained:
        rot = [wire, {k: v.copy() for k, v in wire.items()}]
        _finite(trainer.train_batch(trainer.stage_batches(rot[1]))["loss"],
                "second rotation")
        with ThreadPoolExecutor(1) as ex:
            for rep in range(3):
                if rep:
                    time.sleep(2.0)
                t0 = time.perf_counter()
                fut = ex.submit(trainer.stage_batches, rot[0])
                last = None
                for i in range(iters):
                    db_i = fut.result()
                    fut = ex.submit(trainer.stage_batches, rot[(i + 1) % 2])
                    last = trainer.train_batch(db_i, sync=False)
                last_loss = _finite(Trainer.read_metrics(last)[0],
                                    "sustained window")
                fut.result()              # join the discarded look-ahead
                window = (time.perf_counter() - t0) / iters
                sustained_s = window if sustained_s is None \
                    else min(sustained_s, window)
    launched = route_launches(before)
    if sum(launched.values()):
        raise AssertionError(f"the training leg launched read_conv_reduce "
                             f"{launched}: training runs the layer path")

    # FLOP lower bound: the two read-conv stacks dominate
    # (bench_read_conv.FLOPS_PER_READ per read row); backward ~ 2x forward
    reads = int(batch.read_mask0.sum() + batch.read_mask1.sum())
    step_tflops = 3 * reads * brc.FLOPS_PER_READ / 1e12
    mfu = None
    if trainer.device.type == "cuda":
        peaks = brc.card_peaks(torch.cuda.get_device_name(trainer.device))
        mfu = round(100 * step_tflops / step_s
                    / peaks[brc.MATH[("layers", precision)]], 2)
    wire_mb = sum(v.nbytes for v in wire.values()) / 1e6
    dense_mb = sum(v.nbytes for v in dense.values()) / 1e6
    breakdown = {
        "precision": precision,
        "pack_s": round(pack_s, 3),
        "host_to_device_s": round(h2d_s, 3),
        "wire_mb": round(wire_mb, 1),
        "dense_pack_s": round(dense_pack_s, 3),
        "dense_host_to_device_s": round(dense_h2d_s, 3),
        "dense_mb": round(dense_mb, 1),
        "step_s": round(step_s, 3),
        "sustained_step_s": (round(sustained_s, 3)
                             if sustained_s is not None else None),
        "step_tflops_lower_bound": round(step_tflops, 3),
        "train_mfu_lower_bound_pct": mfu,
    }
    sustained_rate = (len(sites) / sustained_s
                      if sustained_s is not None else None)
    return (len(sites) / step_s, sustained_rate, breakdown,
            {"first_loss": first_loss, "last_loss": last_loss})


def _reference_model(python_dir):
    """The reference's hybrid model, built from its config module with the
    classes under ``python_dir`` (the reference's ``python/``)."""
    import importlib

    sys.path.insert(0, python_dir)
    try:
        ref = importlib.import_module("MixtureOfExpertsAdvanced")
        cfg = importlib.import_module(
            "moe_attention_config_full_hybrid_old_equivalent_weight_norm")
        model = ref.create_moe_attention_model(cfg.configDict)
    finally:
        sys.path.remove(python_dir)
    return model.eval()


def bench_torch_baseline(sites, iters=5, reference_python=None):
    """Reference execution model: torch on the CPU at one thread (the
    reference pins torch to one thread per worker), windows/s over
    ``iters`` forwards after a warm-up.

    With ``reference_python`` the reference's own model on its ragged
    inputs; otherwise the port's own hybrid network, seeded weights, at
    ``highest``, on the workload packed with ``pack_sites`` (the
    "structurally identical torch model built from our config dicts" of
    ``bench.py``).  Which one ran goes to stderr.  The thread count and the
    precision are restored afterwards."""
    import torch

    from .nn import layers

    threads, precision = torch.get_num_threads(), layers.PRECISION
    torch.set_num_threads(1)
    try:
        if reference_python is not None:
            model = _reference_model(reference_python)
            counts = [len(s.alleles) for s in sites]
            nr = tuple([t.shape[0] for s in sites for t in getattr(s, k)]
                       for k in ("tensors0", "tensors1"))
            reads = tuple(torch.from_numpy(np.concatenate(
                [t for s in sites for t in getattr(s, k)]).transpose(
                    0, 2, 1).astype(np.float32))
                for k in ("tensors0", "tensors1"))
            segs = torch.from_numpy(np.stack([s.ref_segment for s in sites]))

            def forward():
                return model(reads, counts, nr, segs)
            source = f"the reference's model from {reference_python}"
        else:
            from .pipeline.batching import pack_sites

            layers.set_precision("highest")
            model = _model("hybrid", "cpu").eval()
            folded = model.fold_read_convs()
            batch = {k: torch.from_numpy(v) for k, v in
                     pack_sites(sites, hybrid=True).device_dict().items()}

            def forward():
                return model(batch, folded=folded)
            source = ("the port's hybrid network (seeded weights) at "
                      "highest")
        sys.stderr.write(f"baseline: {source}, one CPU thread\n")
        with torch.inference_mode():
            forward()                                  # warm-up
            start = time.perf_counter()
            for _ in range(iters):
                forward()
            elapsed = time.perf_counter() - start
    finally:
        torch.set_num_threads(threads)
        layers.set_precision(precision)
    return len(sites) * iters / elapsed


def bench_pipeline(workers=0, ref_length=PIPELINE_BP,
                   num_variants=PIPELINE_VARIANTS, device="cuda",
                   workdir=None):
    """End-to-end windows/s (indexed BAM fetch -> hotspots -> candidates ->
    featurization -> scoring on ``device`` -> genotype decode) on a
    simulated region (``sim.make_dataset``: 35x, 120 bp reads, seed 1),
    with the illumina model's seeded weights.

    ``workers > 0`` runs the production decomposition: host stages in a
    warmed ``HostWorkerPool`` streaming SiteWork to this process, which
    owns the device (``call_parallel``, about 12 chunks per worker);
    ``workers == 0`` calls the region in-process (``call_region``).  One
    warm-up pass over the whole region, then the best of three passes
    spaced 2 s apart; the first timed pass's stage breakdown goes to
    stderr.  The dataset is written to ``workdir`` (kept), else to a
    temporary directory removed on return.

    Returns (windows/s, {"records" and "stats" of the last pass,
    "dataset", "scorer"})."""
    import tempfile

    from . import sim
    from .io.fasta import FastaFile
    from .io.vcf import read_vcf
    from .pipeline.call import call_region, load_scorer
    from .pipeline.parallel_call import HostWorkerPool, call_parallel

    with contextlib.ExitStack() as stack:
        d = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        ds = sim.make_dataset(d, ref_length=ref_length,
                              num_variants=num_variants, coverage=35,
                              read_length=120, seed=1)
        ref = FastaFile(ds.fasta)
        scorer = load_scorer("illumina", device=device)
        bams = [ds.bams["illumina"]]
        region = (ds.chromosome, 0, ref_length)
        # a genome run pays the workers' spawn and imports once across
        # thousands of chunks: charging it to a seconds-long region would
        # measure process start, not throughput
        pool = None
        if workers > 0:
            pool = stack.enter_context(HostWorkerPool(workers))
            pool.wait_ready()
        vcf = os.path.join(d, "bench.vcf")

        def run_once(report=False):
            stats = {}
            start = time.perf_counter()
            if pool is not None:
                # ~12 chunks per worker: the first scoring batch forms early
                # and stragglers balance, while per-chunk costs stay small
                call_parallel(bams, ds.fasta, scorer, vcf, pool=pool,
                              chunk_size=max(ref_length // (12 * workers),
                                             20_000),
                              regions=[region], stats=stats)
                records = read_vcf(vcf)
            else:
                records = call_region(bams, ref, *region, scorer,
                                      stats=stats)
            elapsed = time.perf_counter() - start
            if report:
                # wait = blocked on host workers, drain = blocked on device
                stages = {k: round(v, 3) for k, v in stats.items()
                          if k.endswith("_s")}
                sys.stderr.write(f"pipeline leg: {elapsed:.2f}s wall, "
                                 f"stages {stages}\n")
            return stats["sites"] / elapsed, records, stats

        # warm-up over the whole region, then the best of three spaced
        # passes: a pass that meets a transient stall does not set the rate
        run_once()
        best = None
        for i in range(3):
            if i:
                time.sleep(2.0)
            rate, records, stats = run_once(report=(i == 0))
            best = rate if best is None else max(best, rate)
    return best, {"records": records, "stats": stats, "dataset": ds,
                  "scorer": scorer}


def _parser():
    parser = argparse.ArgumentParser(
        prog="python -m hello_tpu_torch.bench",
        description="Pileup windows/s of the port: device, training, "
        "baseline and end-to-end legs, one JSON line.")
    parser.add_argument("--sites", type=int, default=1024,
                        help="sites per device batch (1024 x 2 alleles = "
                        "the production 2048-allele batch budget)")
    parser.add_argument("--alleles", type=int, default=2)
    parser.add_argument("--reads0", type=int, default=50)
    parser.add_argument("--reads1", type=int, default=30)
    parser.add_argument("--baseline_sites", type=int, default=32,
                        help="baseline torch workload size (scaled per-site)")
    parser.add_argument("--iters", type=int, default=20)
    # cpus + 2: host stages block on BAM IO and IPC enough that modest
    # oversubscription keeps cores busy; capped at 8, where the region's
    # ~96 chunks leave more workers idle behind stragglers
    parser.add_argument("--pipeline_workers", type=int,
                        default=min(8, (os.cpu_count() or 2) + 2),
                        help="host worker processes for the end-to-end leg "
                        "(0: call the region in-process)")
    parser.add_argument("--precision", default="bf16",
                        help="highest, high, default or bf16 (the calling "
                        "CLI's default) for the device and pipeline legs")
    parser.add_argument("--reference_python", default=None,
                        help="the reference's python/ directory: its model "
                        "is the baseline (default: the port's own network)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    parser.add_argument("--skip-baseline", action="store_true")
    parser.add_argument("--skip-pipeline", action="store_true",
                        help="skip the end-to-end host+device pipeline leg")
    parser.add_argument("--skip-train", action="store_true",
                        help="skip the training-step throughput leg")
    return parser


def run(argv=None, workdir=None) -> dict:
    """``main``'s work without its printing: {"line": the JSON line's dict,
    "breakdowns": {training precision: breakdown}, "tunnel": the probes,
    "legs": {leg: {"seconds", "launches_by_route"}} (the kernel's launches
    by route during that leg alone), "outputs": {leg: what it returned
    beside its rate}}.  The device legs are "device_dense", "device_wire"
    and "device_illumina", the training legs "train_default" and
    "train_bf16", then "baseline" and "pipeline" (its genome written to
    ``workdir`` when given)."""
    args = _parser().parse_args(argv)

    from . import telemetry
    from .nn.layers import set_precision
    from .ops.read_conv import route_launches
    from .pipeline.call import resolve_device

    device = resolve_device(args.device)
    set_precision(args.precision)          # raises for an unknown one
    legs, outputs = {}, {}

    def leg(name, fn, *a, **kw):
        before = telemetry.counts()
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        legs[name] = {"seconds": time.perf_counter() - t0,
                      "launches_by_route": route_launches(before)}
        return result

    rng = np.random.RandomState(0)
    sites = build_workload(rng, args.sites, args.alleles, args.reads0,
                           args.reads1)
    dense_rate, outputs["device_dense"] = leg(
        "device_dense", bench_device, sites, args.iters, args.precision,
        device)
    # the production device path on a card (coded wire + packed-row read
    # conv, the Scorer's default there): the rate the pipeline sees
    wire_rate, outputs["device_wire"] = leg(
        "device_wire", bench_device, sites, args.iters, args.precision,
        device, wire=True)

    rates = dict.fromkeys(("train", "train_sustained", "train_bf16",
                           "train_bf16_sustained"))
    breakdowns = {}
    if not args.skip_train:
        # a 512-site step, the production per-device training batch; f32
        # activations are the training policy, bf16 the measured headroom
        for precision, key in (("default", "train"), ("bf16", "train_bf16")):
            name = f"train_{precision}"
            (rates[key], rates[f"{key}_sustained"], breakdowns[precision],
             outputs[name]) = leg(name, bench_train, sites[:512],
                                  precision=precision, device=device)
            sys.stderr.write(f"train leg ({precision}): "
                             f"{breakdowns[precision]}\n")
        # the pipeline leg must measure the requested precision again
        set_precision(args.precision)

    baseline_rate = None
    if not args.skip_baseline:
        # the CPU path is orders of magnitude slower: a smaller workload,
        # compared per site
        small = build_workload(np.random.RandomState(1), args.baseline_sites,
                               args.alleles, args.reads0, args.reads1)
        baseline_rate = leg("baseline", bench_torch_baseline, small,
                            reference_python=args.reference_python)

    # the end-to-end leg, bracketed by link probes and followed by the
    # same model's (illumina) device rate on the same path (the wire), which
    # the end-to-end share divides by: the hybrid's headline rate does
    # about twice the single-platform forward's work
    e2e_rate = device_illumina_rate = None
    tunnel = {"before": None, "after": None}
    if not args.skip_pipeline:
        tunnel["before"] = tunnel_health(seed=1, device=device)
        sys.stderr.write(f"tunnel before pipeline: {tunnel['before']}\n")
        e2e_rate, outputs["pipeline"] = leg(
            "pipeline", bench_pipeline, args.pipeline_workers, PIPELINE_BP,
            PIPELINE_VARIANTS, device, workdir)
        # probed at once: the illumina leg below outlasts a link phase
        tunnel["after"] = tunnel_health(seed=2, device=device)
        sys.stderr.write(f"tunnel after pipeline: {tunnel['after']}\n")
        device_illumina_rate, outputs["device_illumina"] = leg(
            "device_illumina", bench_device, sites, args.iters,
            args.precision, device, model_name="illumina", wire=True)

    line = _line(dense_rate, wire_rate, e2e_rate, args.pipeline_workers,
                 device_illumina_rate, tunnel, rates, baseline_rate)
    return {"line": line, "breakdowns": breakdowns, "tunnel": tunnel,
            "legs": legs, "outputs": outputs}


def _line(dense_rate, wire_rate, e2e_rate, workers, device_illumina_rate,
          tunnel, rates, baseline_rate) -> dict:
    """``bench.py``'s JSON line, key for key, with its rounding."""
    def r(x, digits=2):
        return round(x, digits) if x is not None else None

    e2e_pct = (100 * e2e_rate / device_illumina_rate
               if e2e_rate and device_illumina_rate else None)
    # headline: the production scoring path per card (the coded wire where
    # it wins; the dense rate is published beside it)
    headline = max(dense_rate, wire_rate)
    vs_baseline = headline / baseline_rate if baseline_rate else None
    return {
        "metric": "pileup windows/sec/chip (hybrid MoE scoring)",
        "value": round(headline, 2),
        "unit": "windows/s",
        "vs_baseline": r(vs_baseline),
        "device_dense_windows_per_s": round(dense_rate, 2),
        "device_wire_windows_per_s": round(wire_rate, 2),
        "end_to_end_windows_per_s": r(e2e_rate),
        "end_to_end_workers": workers if e2e_rate is not None else None,
        "device_illumina_windows_per_s": r(device_illumina_rate),
        "end_to_end_pct_of_device": r(e2e_pct, 1),
        "tunnel_before": tunnel["before"],
        "tunnel_after": tunnel["after"],
        "train_windows_per_s": r(rates["train"]),
        "train_sustained_windows_per_s": r(rates["train_sustained"]),
        "train_bf16_windows_per_s": r(rates["train_bf16"]),
        "train_bf16_sustained_windows_per_s":
            r(rates["train_bf16_sustained"]),
        "baseline_windows_per_s": r(baseline_rate, 3),
    }


def main(argv=None):
    print(json.dumps(run(argv)["line"]))


if __name__ == "__main__":
    main()
