#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (hello_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi);
  build      nvcc builds every kernel of the main path from the checkout's
             sources (ops/csrc/read_conv.cu) and reports ptxas' resources;
  kernel     read_conv_reduce (CUDA) against its plain PyTorch version on the
             card, fp32 with TF32 off, for C = 6 and C = 7, at ~40k packed
             rows (2049 alleles, an odd A, at 32-read buckets and ~60%
             occupancy, with padding rows and fully masked alleles); error,
             kernel and plain medians, and the bound from this run's inputs;
  main_path  call_genome of the port with the illumina config at full width
             (seeded init_params, highest precision, no worker processes) on
             a simulated 300 kb genome at 30x; the kernel's launch count of
             that run, then the same weights on the CPU: records must agree
             in chrom, pos, ref, alt and GT, with qual within 1e-3 relative
             (plus 1e-3 absolute).

Then a ``kernels`` line (every kernel with its launches on the main path,
error, times and bound), the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script exits
non-zero and prints no result.  Without a card, or outside a checkout, it
exits non-zero at once.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks (NVIDIA data sheets, dense): fp32 outside the tensor
# cores, TF32 on the tensor cores (the bound of a later tensor-core kernel),
# and memory bandwidth, by card
PEAKS = {"SXM": {"fp32": 67e12, "tf32": 495e12, "bytes": 3.35e12},
         "PCIe": {"fp32": 51e12, "tf32": 378e12, "bytes": 2.0e12}}

GENOME_BP = 300_000
COVERAGE = 30
KERNEL_ALLELES = 2049
KERNEL_READS = 32
KERNEL_OCCUPANCY = 0.6


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    return PEAKS["PCIe" if "PCIe" in name else "SXM"]


def macs_per_row(channels):
    """fp32 multiply-adds of the read convolver for one read row."""
    from hello_tpu_torch.ops.read_conv import _EXPECTED_TAIL_SHAPES

    shapes = [(16, 3 * channels)] + _EXPECTED_TAIL_SHAPES
    lengths = [148, 146, 144] + [71] * 6 + [36] * 3 + [36] * 6
    return sum(co * kc * lo for (co, kc), lo in zip(shapes, lengths))


def time_ms(fn, reps):
    """Median device time of one call, by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return name, smi


def build_phase():
    from hello_tpu_torch.ops import read_conv as rc

    t0 = time.perf_counter()
    path, report = rc.build()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in report.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds,
          "library": os.path.relpath(path, ROOT), "ptxas": ptxas})


def kernel_inputs(rng, channels, device):
    """Packed rows as the coded wire ships them: real rows grouped by allele,
    then padding rows (row_allele == A, row_valid == 0)."""
    import numpy as np
    import torch

    A, R = KERNEL_ALLELES, KERNEL_READS
    counts = rng.binomial(R, KERNEL_OCCUPANCY, size=A)
    counts[::97] = 0                          # alleles with no shipped rows
    row_allele = np.repeat(np.arange(A, dtype=np.int32), counts)
    row_valid = np.ones(len(row_allele), np.float32)
    row_valid[np.isin(row_allele, np.arange(1, A, 89))] = 0.0  # masked rows
    n_pad = (-len(row_allele)) % 1024 + 512
    row_allele = np.concatenate([row_allele, np.full(n_pad, A, np.int32)])
    row_valid = np.concatenate([row_valid, np.zeros(n_pad, np.float32)])
    rows = rng.randint(0, 256, (len(row_allele), 150, channels), dtype=np.uint8)
    zero_alleles = np.union1d(np.flatnonzero(counts == 0),
                              np.arange(1, A, 89))
    to = lambda a: torch.from_numpy(a).to(device)
    return to(rows), to(row_allele), to(row_valid), A, zero_alleles


def kernel_phase(name, channels, seed):
    """Kernel against the plain version; returns the kernel line's numbers."""
    import numpy as np
    import torch

    from hello_tpu_torch.nn.convert import init_params
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.ops import read_conv as rc

    model = init_params(create_model(name),
                        torch.Generator().manual_seed(seed)).cuda()
    folded = model.fold_read_convs()["read_conv0"]
    rows, row_allele, row_valid, A, zero_alleles = kernel_inputs(
        np.random.RandomState(seed), channels, "cuda")
    run = lambda: rc.read_conv_reduce(rows, row_allele, row_valid, folded, A)
    plain = lambda: rc.read_conv_reduce_reference(rows, row_allele, row_valid,
                                                  folded, A)
    got = run()
    torch.cuda.synchronize()
    with torch.no_grad():
        want = plain()
    torch.cuda.synchronize()
    err = (got - want).abs()
    big = want.abs() >= 1e-3
    max_rel = (err[big] / want.abs()[big]).max().item() if big.any() else 0.0
    ok = torch.allclose(got, want, rtol=1e-4, atol=1e-3)
    zeros_exact = bool((got[torch.from_numpy(zero_alleles).cuda()] == 0).all())
    if not (ok and zeros_exact and torch.isfinite(got).all()):
        raise AssertionError(f"kernel disagrees with the plain version (C={channels}): "
                             f"max abs {err.max().item()}, max rel {max_rel}, "
                             f"masked alleles zero: {zeros_exact}")
    ms = time_ms(run, 20)
    with torch.no_grad():
        plain_ms = time_ms(plain, 5)
    computed = int(((row_valid != 0) & (row_allele < A)).sum().item())
    flop = 2.0 * macs_per_row(channels) * computed
    nbytes = (rows.numel() + row_allele.numel() * 4 + row_valid.numel() * 4
              + folded.flat.numel() * 4 + got.numel() * 4)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    flop_ms = 1e3 * flop / peaks["fp32"]
    byte_ms = 1e3 * nbytes / peaks["bytes"]
    line = {"phase": "kernel", "kernel": "read_conv_reduce", "C": channels,
            "nb": rows.shape[0], "A": A, "rows_computed": computed,
            "max_abs_err": err.max().item(), "max_rel_err": max_rel,
            "rtol": 1e-4, "atol": 1e-3, "masked_alleles_zero": zeros_exact,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "tf32_bound_ms": max(1e3 * flop / peaks["tf32"], byte_ms),
            "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
            "tflop_per_s": flop / ms / 1e9}
    emit(line)
    return line


def main_path_phase(workdir):
    import torch

    from hello_tpu_torch import native, sim, telemetry
    from hello_tpu_torch.io.vcf import read_vcf
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.ops import read_conv as rc
    from hello_tpu_torch.pipeline.call import Scorer, call_genome, load_scorer

    t0 = time.perf_counter()
    ds = sim.make_dataset(workdir, ref_length=GENOME_BP,
                          num_variants=GENOME_BP // 1000, coverage=COVERAGE,
                          read_length=150, seed=5)
    sim_s = time.perf_counter() - t0
    bam = [ds.bams["illumina"]]
    # set-up: a fresh checkout compiles the C++ host engine at first use
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host engine did not build")
    native_s = time.perf_counter() - t0

    scorer = load_scorer("illumina", seed=0)         # cuda, highest
    assert scorer.device.type == "cuda" and scorer.packed_conv
    out_card = os.path.join(workdir, "card.vcf")
    stats = {}
    telemetry.reset()
    rc.read_conv_reduce.launches = 0
    t0 = time.perf_counter()
    call_genome(bam, ds.fasta, scorer, out_card, stats=stats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = rc.read_conv_reduce.launches
    stages = telemetry.report()
    card = read_vcf(out_card)
    if launches <= 0:
        raise AssertionError("the main path never launched read_conv_reduce")
    if not card:
        raise AssertionError("the card's VCF is empty")

    cpu_model = create_model("illumina")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               scorer.model.state_dict().items()})
    cpu_scorer = Scorer(cpu_model, device="cpu", packed_conv=True)
    out_cpu = os.path.join(workdir, "cpu.vcf")
    t0 = time.perf_counter()
    call_genome(bam, ds.fasta, cpu_scorer, out_cpu)
    cpu_s = time.perf_counter() - t0
    cpu = read_vcf(out_cpu)
    if len(cpu) != len(card):
        raise AssertionError(f"{len(card)} records on the card, {len(cpu)} "
                             "on the CPU")
    worst = (0.0, 0.0)                       # (|qual diff|, qual there)
    for a, b in zip(card, cpu):
        if (a.chromosome, a.position, a.ref, a.alt, a.gt) != \
                (b.chromosome, b.position, b.ref, b.alt, b.gt):
            raise AssertionError(f"record differs: card {a} cpu {b}")
        # qual = -10 log10(1 - p): one fp32 ulp of p moves a Q40 call by
        # ~0.003, so qual is held to 1e-3 relative (+1e-3 absolute), as
        # hello_tpu's tests hold two scoring routes to each other
        if abs(a.qual - b.qual) > 1e-3 + 1e-3 * abs(b.qual):
            raise AssertionError(f"qual differs: card {a} cpu {b}")
        worst = max(worst, (abs(a.qual - b.qual), b.qual))
    emit({"phase": "main_path", "model": "illumina",
          "genome_bp": GENOME_BP, "coverage": COVERAGE, "sim_seconds": sim_s,
          "native_build_seconds": native_s,
          "sites": stats["sites"], "records": len(card),
          "seconds": card_s, "windows_per_s": stats["sites"] / card_s,
          "read_conv_reduce_launches": launches, "stages": stages,
          "cpu_seconds": cpu_s, "compared_region": f"{ds.chromosome} whole",
          "records_equal": True, "max_qual_diff": worst[0],
          "qual_at_max_diff": worst[1]})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "hello_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(hello_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, smi = device_phase()
    build_phase()
    lines = [kernel_phase("illumina", 6, seed=0),
             kernel_phase("pacbio_hp", 7, seed=1)]
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as workdir:
        launches = main_path_phase(workdir)
    k6 = lines[0]
    emit({"kernels": [{
        "name": "read_conv_reduce", "route": "cuda",
        "source": "hello_tpu_torch/ops/csrc/read_conv.cu",
        "replaces": "hello_tpu/ops/read_conv.py:252",
        "also_replaces": "hello_tpu/ops/read_conv.py:263",
        "launches": launches,
        "max_abs_err": max(line["max_abs_err"] for line in lines),
        "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
