"""Time source variants of read_conv_reduce's bf16 route on the card.

A variant is the route's source (``csrc/read_conv.cu`` with
``csrc/read_conv_wgmma.cuh``) with text substitutions: another number of
read rows per block or of weight stages, one atomic per row instead of one
per allele, or one part of the block's work taken out (the products, the
weight copies after the first stages, the epilogue's stores, the atomics)
to show what that part costs.  Every variant is built with
nvcc into a temporary directory, all at once, and timed by CUDA events at
chip_smoke.py's kernel-phase shape (2049 alleles, 32-read buckets about 60%
occupied, C = 6), in turns: the variants forward, then backward, so that
drift of the card's clock cancels.  Variants that keep the arithmetic are
held to the plain version as chip_smoke.py holds the kernel (max abs error
at most a quarter of the plain bf16 version's distance from fp32); the
others are only timed.

Usage, on a machine with the card:
    python -m hello_tpu_torch.ops.read_conv_variants [--variants base,rows10]
        [--reps 20] [--seed 0]
It prints one JSON line per variant and round, then one line of medians.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

#: name -> (keeps the arithmetic, ((old text, new text), ...)): edits of
#: csrc/read_conv_wgmma.cuh, the route's own header; every old text must
#: occur in it
_STAGES = "constexpr int kStages = 2;"
_CHUNK = "constexpr int kChunk = 4;"
_NO_PRODUCTS = ("wgmma<CO>(acc[t], ad, bd);", "(void)ad;")
# the stage's barrier completes its phase at once: every conv after the
# first kStages computes with stale weights, and no weight byte moves
_NO_WEIGHTS = (
    "load_stage<STEP + kStages < kNumConvs ? STEP + kStages : 0>(stages, bars, weights);",
    'asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" :: '
    '"r"(smem_addr(bars + STEP % kStages)) : "memory");')
VARIANTS = {
    "base": (True, ()),
    "stages3": (True, ((_STAGES, "constexpr int kStages = 3;"),)),
    "stages4": (True, ((_STAGES, "constexpr int kStages = 4;"),)),
    "rows10": (True, (("constexpr int kRows = 5;",
                       "constexpr int kRows = 10;"),)),
    "stages1": (True, ((_STAGES, "constexpr int kStages = 1;"),)),
    "chunk2": (True, ((_CHUNK, "constexpr int kChunk = 2;"),)),
    # two blocks per SM: one weight stage (100,616 bytes of shared memory
    # each), at most 2 tiles held per warpgroup, registers capped to fit
    "two_blocks": (True, ((_STAGES, "constexpr int kStages = 1;"),
                          (_CHUNK, "constexpr int kChunk = 2;"),
                          ("__launch_bounds__(kThreads, 1)",
                           "__launch_bounds__(kThreads, 2)"))),
    "per_row_atomics": (True, (
        ("if (r + 1 == kRows || allele[r + 1] != allele[r]) {",
         "if (true) {"),)),
    "no_atomics": (False, (("atomicAdd(out + ",
                            "if (sum == -1.0f) atomicAdd(out + "),)),
    "no_products": (False, (_NO_PRODUCTS,)),
    "no_weight_traffic": (False, (_NO_WEIGHTS,)),
    "no_products_no_weight_traffic": (False, (_NO_PRODUCTS, _NO_WEIGHTS)),
    "no_products_no_epilogue": (False, (
        _NO_PRODUCTS, ("if (r >= kRows || l >= LO) continue;", "continue;"))),
    "no_products_no_proxy_fence": (False, (
        _NO_PRODUCTS, ("fence_proxy_async();\n  __syncthreads();\n  if (STEP",
                       "__syncthreads();\n  if (STEP"))),
    "no_products_no_input": (False, (
        _NO_PRODUCTS, ("for (int p = tid; p < kPIn;", "for (int p = kPIn; p < kPIn;"))),
    "no_products_no_pool": (False, (
        _NO_PRODUCTS, ("for (int i = tid; i < 4 * kP32B;",
                       "for (int i = 4 * kP32B; i < 4 * kP32B;"))),
    "no_products_stages4": (False, (
        _NO_PRODUCTS, (_STAGES, "constexpr int kStages = 4;"))),
    "no_stores": (False, (("*o = bf16x2(", "if (v0 == -1.0f) *o = bf16x2("),)),
}

HEADER = "read_conv_wgmma.cuh"
ALLELES, READS, OCCUPANCY = 2049, 32, 0.6


def variant_sources(name: str) -> dict:
    """{file name: text} of the route's sources with the variant's
    substitutions in its header (raises if one does not apply)."""
    from . import read_conv as rc

    texts = {os.path.basename(p): open(p).read()
             for p in rc.source_files(rc.SOURCE)}
    for old, new in VARIANTS[name][1]:
        if old not in texts[HEADER]:
            raise ValueError(f"variant {name}: {old!r} is not in {HEADER}")
        texts[HEADER] = texts[HEADER].replace(old, new)
    return texts


def build_variant(name: str, workdir: str):
    """nvcc the variant into ``workdir``/name; returns (library, ptxas'
    lines of the bf16 kernel)."""
    from . import read_conv as rc

    d = os.path.join(workdir, name)
    os.makedirs(d)
    for f, text in variant_sources(name).items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, "lib.so")
    proc = subprocess.run([rc._nvcc(), *rc.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, os.path.basename(rc.SOURCE))],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    report = (proc.stdout + proc.stderr).splitlines()
    return lib, [line.strip() for i, line in enumerate(report)
                 if "Used" in line and "rcw" in " ".join(report[i - 2:i])]


def inputs(seed: int):
    """Packed rows as the coded wire ships them (chip_smoke.py's kernel
    phase): each allele's rows together, then padding rows."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    counts = rng.binomial(READS, OCCUPANCY, size=ALLELES)
    allele = np.repeat(np.arange(ALLELES, dtype=np.int32), counts)
    n_pad = (-len(allele)) % 1024 + 512
    allele = np.concatenate([allele, np.full(n_pad, ALLELES, np.int32)])
    valid = (allele < ALLELES).astype(np.float32)
    rows = rng.randint(0, 256, (len(allele), 150, 6), dtype=np.uint8)
    return [torch.from_numpy(a).cuda() for a in (rows, allele, valid)]


def main(argv=None):
    import ctypes

    import torch

    from ..nn.convert import init_params
    from ..nn.moe import create_model
    from . import read_conv as rc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    for n in names:
        if n not in VARIANTS:
            raise SystemExit(f"unknown variant {n!r} (of {list(VARIANTS)})")
    if not torch.cuda.is_available():
        raise SystemExit("read_conv_variants times the kernel on a card; "
                         "none is visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    model = init_params(create_model("illumina"),
                        torch.Generator().manual_seed(args.seed))
    folded = rc.fold_read_conv_weights(model.read_convolver0, "bf16")
    flat = folded.flat.cuda()
    rows, allele, valid = inputs(args.seed)
    with torch.no_grad():
        cuda = lambda f: rc.FoldedReadConv(
            tuple((w.cuda(), b.cuda()) for w, b in f.convs), f.flat.cuda(),
            f.in_channels, f.route)
        want = rc.read_conv_reduce_reference(rows, allele, valid,
                                             cuda(folded), ALLELES)
        torch.backends.cudnn.allow_tf32 = False
        exact = rc.read_conv_reduce_reference(
            rows, allele, valid,
            cuda(rc.fold_read_conv_weights(model.read_convolver0, "tf32x3")),
            ALLELES)
    bar = 0.25 * float((want - exact).abs().max())
    workdir = tempfile.mkdtemp(prefix="read_conv_variants_")
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            built = dict(zip(names, pool.map(
                lambda n: build_variant(n, workdir), names)))
        libs = {}
        for n, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            lib.read_conv_reduce_run.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            libs[n] = lib

        def run(n):
            out = torch.zeros((ALLELES, rc.L_OUT, rc.C_OUT), device="cuda")
            err = libs[n].read_conv_reduce_run(
                rows.data_ptr(), rows.shape[0], 6, rc.ROUTE_IDS["bf16"],
                allele.data_ptr(), valid.data_ptr(), flat.data_ptr(),
                ALLELES, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant {n}: cudaError {err}")
            return out

        times = {n: [] for n in names}
        for rnd, order in enumerate((names, names[::-1])):
            for n in order:
                got = run(n)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if VARIANTS[n][0] and not err <= bar:
                    raise AssertionError(f"variant {n}: max abs error {err} "
                                         f"above the bar {bar}")
                run(n)
                reps = []
                for _ in range(args.reps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run(n)
                    end.record()
                    end.synchronize()
                    reps.append(start.elapsed_time(end))
                ms = statistics.median(reps)
                times[n].append(ms)
                print(json.dumps({"variant": n, "round": rnd, "ms": ms,
                                  "keeps_arithmetic": VARIANTS[n][0],
                                  "max_abs_err": err, "bar": bar,
                                  "ptxas": built[n][1], "card": card}),
                      flush=True)
        print(json.dumps({"median_ms": {n: statistics.median(t)
                                        for n, t in times.items()},
                          "rows": rows.shape[0], "card": card}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
