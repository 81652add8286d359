#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (hello_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line:

  device     the card's name and power limit (nvidia-smi);
  build      nvcc builds every kernel of the main path from the checkout's
             sources (ops/csrc/read_conv.cu), and the mma probe
             (ops/csrc/mma_probe.cu), in parallel; reports ptxas' resources,
             the read rows, dynamic shared memory and threads per block and
             the resident blocks per SM;
  probe      the card's rate of mma.sync m16n8k8 TF32, the read-conv
             kernel's product instruction, at the kernel's 8 warps per SM:
             the ceiling of its tensor-core work short of wgmma;
  kernel     read_conv_reduce (CUDA) against its plain PyTorch version on the
             card, fp32 with TF32 off, for C = 6 and C = 7, at ~40k packed
             rows (2049 alleles, an odd A, at 32-read buckets and ~60%
             occupancy, with padding rows and fully masked alleles); error,
             kernel and plain medians, and the bounds from this run's inputs:
             fp32 FMA, 3xTF32 on the tensor cores (the kernel's route, and
             its bound_ms), 3xTF32 at the probe's mma.sync rate, and a single
             TF32 pass;
  main_path  call_genome of the port with the illumina config at full width
             (seeded init_params, highest precision, no worker processes) on
             a simulated 300 kb genome at 30x; the kernel's launch count of
             that run, then the same weights on the CPU: records must agree
             in chrom, pos, ref, alt and GT, with qual within 1e-3 relative
             (plus 1e-3 absolute);
  hybrid_path  the same for two-BAM calling with the hybrid config (two read
             convolvers, three experts, combiners, meta-expert) on a
             simulated 150 kb Illumina + PacBio genome at 30x each (PacBio
             reads 1500 bp): the kernel's launches for each read convolver
             (both must be > 0), then the CPU comparison.

Then a ``kernels`` line (every kernel with its launches on both paths,
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
PROBE = os.path.join(ROOT, "hello_tpu_torch", "ops", "csrc", "mma_probe.cu")

# published peaks (NVIDIA data sheets, dense): fp32 outside the tensor
# cores, TF32 on the tensor cores, and memory bandwidth, by card
PEAKS = {"SXM": {"fp32": 67e12, "tf32": 495e12, "bytes": 3.35e12},
         "PCIe": {"fp32": 51e12, "tf32": 378e12, "bytes": 2.0e12}}

GENOME_BP = 300_000
HYBRID_GENOME_BP = 150_000
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
    """Build the kernel and the probe, one nvcc each, started together;
    returns the probe's library."""
    from concurrent.futures import ThreadPoolExecutor

    from hello_tpu_torch.ops import read_conv as rc

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        (path, report), (probe, _) = pool.map(rc.build, (rc.SOURCE, PROBE))
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in report.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": seconds,
          "library": os.path.relpath(path, ROOT), "ptxas": ptxas,
          "launch": {c: rc.kernel_info(c) for c in (6, 7)}})
    return probe


def probe_phase(probe):
    """mma.sync TF32 rate (FLOP/s) at one 256-thread block per SM."""
    import ctypes

    import torch

    lib = ctypes.CDLL(probe)
    lib.mma_tf32_probe.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.mma_tf32_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    out = torch.empty(sms * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = ctypes.c_float()
    times = []
    for _ in range(5):
        err = lib.mma_tf32_probe(sms, threads, iters, out.data_ptr(), stream,
                                 ctypes.byref(ms))
        if err != 0:
            raise RuntimeError(f"mma probe failed: cudaError {err}")
        times.append(ms.value)
    # each m16n8k8 is 16 * 8 * 8 multiply-adds; 12 per warp per iteration
    flop = 2 * 16 * 8 * 8 * 12 * iters * sms * threads // 32
    rate = flop / statistics.median(times) * 1e3
    peak = card_peaks(torch.cuda.get_device_name(0))["tf32"]
    emit({"phase": "probe", "instruction": "mma.sync.m16n8k8.tf32",
          "warps_per_sm": threads // 32, "ms": statistics.median(times),
          "tflop_per_s": rate / 1e12, "share_of_tf32_peak": rate / peak})
    return rate


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


def kernel_phase(name, channels, seed, mma_rate):
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
    byte_ms = 1e3 * nbytes / peaks["bytes"]
    fp32_ms = max(1e3 * flop / peaks["fp32"], byte_ms)
    # the kernel computes every product as three TF32 mma passes (3xTF32)
    tf32x3_ms = 1e3 * 3 * flop / peaks["tf32"]
    line = {"phase": "kernel", "kernel": "read_conv_reduce", "C": channels,
            "nb": rows.shape[0], "A": A, "rows_computed": computed,
            "max_abs_err": err.max().item(), "max_rel_err": max_rel,
            "rtol": 1e-4, "atol": 1e-3, "masked_alleles_zero": zeros_exact,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(tf32x3_ms, byte_ms),
            "bound_by": "operations" if tf32x3_ms >= byte_ms else "bytes",
            "fp32_bound_ms": fp32_ms, "tf32x3_bound_ms": tf32x3_ms,
            "mma_sync_bound_ms": 1e3 * 3 * flop / mma_rate,
            "tf32_bound_ms": max(1e3 * flop / peaks["tf32"], byte_ms),
            "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
            "tflop_per_s": flop / ms / 1e9}
    emit(line)
    return line


def call_on_cpu(model_name, scorer, bams, fasta, out_cpu):
    """The card's weights on the CPU (plain read-convolver version over
    packed rows): returns (records, seconds)."""
    from hello_tpu_torch.io.vcf import read_vcf
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.call import Scorer, call_genome

    cpu_model = create_model(model_name)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               scorer.model.state_dict().items()})
    cpu_scorer = Scorer(cpu_model, device="cpu", packed_conv=True)
    t0 = time.perf_counter()
    call_genome(bams, fasta, cpu_scorer, out_cpu)
    return read_vcf(out_cpu), time.perf_counter() - t0


def compare_records(card, cpu):
    """Raise unless the card's records equal the CPU's; returns (largest
    |qual difference|, qual there)."""
    if not card:
        raise AssertionError("the card's VCF is empty")
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
    return worst


def main_path_phase(workdir):
    import torch

    from hello_tpu_torch import native, sim, telemetry
    from hello_tpu_torch.io.vcf import read_vcf
    from hello_tpu_torch.ops import read_conv as rc
    from hello_tpu_torch.pipeline.call import call_genome, load_scorer

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
    if launches <= 0:
        raise AssertionError("the main path never launched read_conv_reduce")
    card = read_vcf(out_card)
    cpu, cpu_s = call_on_cpu("illumina", scorer, bam, ds.fasta,
                             os.path.join(workdir, "cpu.vcf"))
    worst = compare_records(card, cpu)
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


def hybrid_path_phase(workdir):
    """Two-BAM calling with the hybrid config on the card, each read
    convolver's kernel launches counted, then the CPU comparison."""
    import torch

    from hello_tpu_torch import sim, telemetry
    from hello_tpu_torch.io.vcf import read_vcf
    from hello_tpu_torch.ops import read_conv as rc
    from hello_tpu_torch.pipeline.call import call_genome, load_scorer

    t0 = time.perf_counter()
    ds = sim.make_dataset(workdir, ref_length=HYBRID_GENOME_BP,
                          num_variants=HYBRID_GENOME_BP // 1000,
                          coverage=COVERAGE, read_length=150, seed=7,
                          platforms=("illumina", "pacbio"),
                          pacbio_read_length=1500)
    sim_s = time.perf_counter() - t0
    bams = [ds.bams["illumina"], ds.bams["pacbio"]]

    scorer = load_scorer("hybrid", seed=0)           # cuda, highest
    assert scorer.device.type == "cuda" and scorer.packed_conv
    assert sorted(scorer.folded) == ["read_conv0", "read_conv1"]
    out_card = os.path.join(workdir, "card.vcf")
    stats = {}
    telemetry.reset()
    rc.read_conv_reduce.launches = 0
    for folded in scorer.folded.values():
        folded.launches = 0
    t0 = time.perf_counter()
    call_genome(bams, ds.fasta, scorer, out_card, stats=stats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {name: f.launches for name, f in scorer.folded.items()}
    total = rc.read_conv_reduce.launches
    stages = telemetry.report()
    if min(launches.values()) <= 0 or total != sum(launches.values()):
        raise AssertionError(f"the hybrid path's read_conv_reduce launches "
                             f"{launches} (total {total}): each read "
                             "convolver must launch the kernel")
    card = read_vcf(out_card)
    cpu, cpu_s = call_on_cpu("hybrid", scorer, bams, ds.fasta,
                             os.path.join(workdir, "cpu.vcf"))
    worst = compare_records(card, cpu)
    emit({"phase": "hybrid_path", "model": "hybrid",
          "genome_bp": HYBRID_GENOME_BP, "coverage": COVERAGE,
          "pacbio_read_length": 1500, "sim_seconds": sim_s,
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
    mma_rate = probe_phase(build_phase())
    lines = [kernel_phase("illumina", 6, seed=0, mma_rate=mma_rate),
             kernel_phase("pacbio_hp", 7, seed=1, mma_rate=mma_rate)]
    with tempfile.TemporaryDirectory(prefix=".smoke_", dir=ROOT) as workdir:
        launches = main_path_phase(os.path.join(workdir, "illumina"))
        hybrid = hybrid_path_phase(os.path.join(workdir, "hybrid"))
    k6 = lines[0]
    emit({"kernels": [{
        "name": "read_conv_reduce", "route": "cuda",
        "source": "hello_tpu_torch/ops/csrc/read_conv.cu",
        "replaces": "hello_tpu/ops/read_conv.py:252",
        "also_replaces": "hello_tpu/ops/read_conv.py:263",
        "launches": launches + sum(hybrid.values()),
        "launches_by_path": {"main_path": launches, "hybrid_path": hybrid},
        "max_abs_err": max(line["max_abs_err"] for line in lines),
        "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "fp32_bound_ms": k6["fp32_bound_ms"],
        "mma_sync_bound_ms": k6["mma_sync_bound_ms"],
        "ms_C7": lines[1]["ms"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
