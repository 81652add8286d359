"""Time source variants of a route of read_conv_reduce on the card.

A variant is the kernel's sources with text substitutions in the route's
own file (``--route bf16``: ``csrc/read_conv_wgmma.cuh``; ``tf32x3`` and
``tf32``: ``TF32_SOURCE``, one file for both; ``wide``: ``WIDE_SOURCE``, the
wide read convolver's bf16 kernel, with ``illumina_wide``'s weights):
another number of read rows
per block or of weight stages, one atomic per row instead of one per
allele, or one part of the block's work taken out (the products, the
weight copies, the epilogue's stores, the atomics) to show what that part
costs.  Every variant is built with
nvcc into a temporary directory, all at once, and timed by CUDA events at
chip_smoke.py's kernel-phase shape (2049 alleles, 32-read buckets about 60%
occupied, C = 6), in turns: the variants forward, then backward, so that
drift of the card's clock cancels.  Variants that keep the arithmetic are
held to the plain version as chip_smoke.py holds the kernel (max abs error
at most a quarter of the plain bf16 version's distance from fp32); the
others are only timed.  ``--mix cell`` times the benchmark cell's reads
instead: 2048 alleles of 20 to 60 rows.

Usage, on a machine with the card:
    python -m hello_tpu_torch.ops.read_conv_variants [--variants base,rows10]
        [--route bf16|tf32x3|tf32|wide] [--mix kernel|cell] [--reps 20]
        [--seed 0]
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

#: the TF32 routes' header: edits of it for both TF32 routes, in the same
#: form as VARIANTS
TF32_SOURCE = "read_conv_wgmma_tf32.cuh"
# the tf32 wgmma instructions become PTX comments: their operands are still
# computed (the A loads and the split) and the accumulators kept
_TF32_NO_PRODUCTS = ('"wgmma.mma_async.sync.aligned.m64n',
                     '"// wgmma.mma_async.sync.aligned.m64n')
TF32_VARIANTS = {
    "base": (True, ()),
    "no_products": (False, (_TF32_NO_PRODUCTS,)),
    "no_products_no_epilogue": (False, (
        _TF32_NO_PRODUCTS,
        ("if (r >= kRows || l >= LO) continue;", "continue;"))),
    # each unit's full barrier completes on the producer's arrival alone:
    # no weight byte moves, and the products read stale stages
    "no_weight_traffic": (False, ((
        "bulk_load(stages + s * kStage, weights + conv_off<P>(i) + t * n, "
        "n * 4, full + s);", "mbar_arrive(full + s, true);"),)),
    "no_atomics": (False, (("atomicAdd(out + ",
                            "if (sum == -1.0f) atomicAdd(out + "),)),
    # the activations' small parts are not computed (the products stay)
    "no_split": (False, ((
        "small[h][e] = tf32_rna(x[h][e] - __uint_as_float(big[h][e]));",
        "small[h][e] = big[h][e];"),)),
    # the producer one warp, and no setmaxnreg: 128 registers a thread
    "producer_warp": (True, (("constexpr int kProducerWarps = 4;",
                              "constexpr int kProducerWarps = 1;"),)),
    # A loads (pairs of k-steps) of a tile per commit group: both routes
    # at 1, at 2, or at 4
    "loads1": (True, (("constexpr int kLoads1 = 2;", "constexpr int kLoads1 = 1;"),)),
    "loads2": (True, (("constexpr int kLoads3 = 1;", "constexpr int kLoads3 = 2;"),)),
    "loads4": (True, (("constexpr int kLoads3 = 1;", "constexpr int kLoads3 = 4;"),
                      ("constexpr int kLoads1 = 2;", "constexpr int kLoads1 = 4;"))),
}

#: the wide read convolver's header: its edits, in the same form
WIDE_SOURCE = "read_conv_wgmma_wide.cuh"
_SPAN = "constexpr int kSpan = 40;"
_WIDE_NO_PRODUCTS = ("          wgmma<CO>(acc[t],",
                     "          if (kRows < 0) wgmma<CO>(acc[t],")
WIDE_VARIANTS = {
    "base": (True, ()),
    "span20": (True, ((_SPAN, "constexpr int kSpan = 20;"),)),
    "span80": (True, ((_SPAN, "constexpr int kSpan = 80;"),)),
    "no_products": (False, (_WIDE_NO_PRODUCTS,)),
    # each slice's barrier completes on one arrival: no weight byte moves,
    # and the products read stale stages
    "no_weight_traffic": (False, ((
        "bulk_load(stages + (J % kStages) * kStage, weights + OFF, "
        "unit_bytes(I), bars + J % kStages);",
        "mbar_arrive(bars + J % kStages, true);"),)),
    "no_atomics": (False, (("atomicAdd(out + ",
                            "if (sum == -1.0f) atomicAdd(out + "),)),
    "no_products_no_epilogue": (False, (
        _WIDE_NO_PRODUCTS,
        ("if (r >= kRows || l >= LO) continue;", "continue;"))),
}

#: route -> (the file its edits apply to, its variants, the start of its
#: kernels' mangled names in ptxas' report: their namespace)
ROUTE_VARIANTS = {
    "bf16": (HEADER, VARIANTS, "_ZN3rcw"),
    "tf32x3": (TF32_SOURCE, TF32_VARIANTS, "_ZN3rct"),
    "tf32": (TF32_SOURCE, TF32_VARIANTS, "_ZN3rct"),
    "wide": (WIDE_SOURCE, WIDE_VARIANTS, "_ZN4rcw2"),
}
ALLELES, READS, OCCUPANCY = 2049, 32, 0.6
#: the benchmark cell's mix (``--mix cell``): reads per allele
CELL_ALLELES, CELL_READS = 2048, (20, 60)


def variant_sources(name: str, route: str = "bf16") -> dict:
    """{file name: text} of the kernel's sources with the route's variant
    ``name`` substituted in the route's file (raises if an edit does not
    apply)."""
    from . import read_conv as rc

    target, variants, _ = ROUTE_VARIANTS[route]
    texts = {os.path.basename(p): open(p).read()
             for p in rc.source_files(rc.SOURCE)}
    for old, new in variants[name][1]:
        if old not in texts[target]:
            raise ValueError(f"variant {name}: {old!r} is not in {target}")
        texts[target] = texts[target].replace(old, new)
    return texts


AGAINST = "against"


def build_variant(name: str, workdir: str, route: str = "bf16",
                  against: str = None):
    """nvcc the variant into ``workdir``/name; returns (library, ptxas'
    lines of the route's kernels).  The variant ``AGAINST`` is the kernel's
    sources in the directory ``against`` (another checkout's
    hello_tpu_torch/ops/csrc), unedited."""
    from . import read_conv as rc

    marker = ROUTE_VARIANTS[route][2]
    d = os.path.join(workdir, name)
    os.makedirs(d)
    if name == AGAINST:
        texts = {os.path.basename(p): open(p).read() for p in rc.source_files(
            os.path.join(against, os.path.basename(rc.SOURCE)))}
    else:
        texts = variant_sources(name, route)
    for f, text in texts.items():
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
                 if "Used" in line and marker in " ".join(report[i - 2:i])]


def inputs(seed: int, mix: str = "kernel"):
    """Packed rows as the coded wire ships them: each allele's rows
    together, then padding rows; chip_smoke.py's kernel phase (``kernel``)
    or the benchmark cell's reads (``cell``).  Returns the rows, their
    alleles and validities on the card, and the number of alleles."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    if mix == "cell":
        lo, hi = CELL_READS
        A = CELL_ALLELES
        counts = rng.permutation(lo + (np.arange(A) * (hi - lo + 1)) // A)
    else:
        A = ALLELES
        counts = rng.binomial(READS, OCCUPANCY, size=A)
    allele = np.repeat(np.arange(A, dtype=np.int32), counts)
    n_pad = (-len(allele)) % 1024 + 512
    allele = np.concatenate([allele, np.full(n_pad, A, np.int32)])
    valid = (allele < A).astype(np.float32)
    rows = rng.randint(0, 256, (len(allele), 150, 6), dtype=np.uint8)
    return [torch.from_numpy(a).cuda() for a in (rows, allele, valid)] + [A]


def main(argv=None):
    import ctypes

    import torch

    from ..nn.convert import init_params
    from ..nn.moe import create_model
    from . import read_conv as rc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", default="bf16",
                    help="bf16, tf32x3, tf32 or wide; or tf32x3,tf32: the "
                         "TF32 routes share their source and variants, which "
                         "are then built once and timed for both")
    ap.add_argument("--mix", default="kernel", choices=("kernel", "cell"),
                    help="chip_smoke.py's kernel-phase reads, or the "
                         "benchmark cell's (2048 alleles of 20 to 60)")
    ap.add_argument("--variants", default=None,
                    help="comma-separated (default: all of the route's)")
    ap.add_argument("--against", default=None,
                    help="a directory of another checkout's kernel sources "
                         "(hello_tpu_torch/ops/csrc), timed as the variant "
                         f"{AGAINST!r} (it must take this fold's weights)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    routes = args.route.split(",")
    if (any(r not in ROUTE_VARIANTS for r in routes)
            or len({ROUTE_VARIANTS[r][0] for r in routes}) != 1):
        raise SystemExit(f"--route {args.route}: one of {list(ROUTE_VARIANTS)}"
                         ", or routes that share their source")
    variants = ROUTE_VARIANTS[routes[0]][1]
    names = (args.variants or ",".join(variants)).split(",")
    for n in names:
        if n not in variants:
            raise SystemExit(f"unknown variant {n!r} of route {routes[0]} "
                             f"(of {list(variants)})")
    if args.against:
        names.append(AGAINST)
        variants = {**variants, AGAINST: (True, ())}
    if not torch.cuda.is_available():
        raise SystemExit("read_conv_variants times the kernel on a card; "
                         "none is visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    wide = routes == ["wide"]
    model = init_params(create_model("illumina_wide" if wide else "illumina"),
                        torch.Generator().manual_seed(args.seed))
    net = model.read_convolver0
    rows, allele, valid, A = inputs(args.seed, args.mix)
    cuda = lambda f: rc.FoldedReadConv(
        tuple((w.cuda(), b.cuda()) for w, b in f.convs), f.flat.cuda(),
        f.in_channels, f.route, width=f.width)
    if wide:
        # the wide kernel's bf16 fold; its fp32 weights for the yardstick
        # (the plain version reads only the convs and the route)
        ws = [t.detach().float() for t in rc.extract_read_conv_weights(net)]
        wide_fold = rc.fold_read_conv_weights(net, "bf16")
        folds = {"wide": wide_fold, "tf32x3": rc.FoldedReadConv(
            tuple(zip(ws[0::2], ws[1::2])), torch.zeros(0),
            wide_fold.in_channels, "tf32x3", width=2)}
    else:
        folds = {r: rc.fold_read_conv_weights(net, r)
                 for r in {*routes, "tf32x3"}}
    folded = {r: cuda(f) for r, f in folds.items()}
    with torch.no_grad():
        # the plain version in fp32 math, and with cuDNN's TF32 as each
        # route's precision sets it (on at default only)
        torch.backends.cudnn.allow_tf32 = False
        exact = rc.read_conv_reduce_reference(rows, allele, valid,
                                              folded["tf32x3"], A)
        want = {}
        for r in routes:
            torch.backends.cudnn.allow_tf32 = r == "tf32"
            want[r] = rc.read_conv_reduce_reference(rows, allele, valid,
                                                    folded[r], A)
        torch.backends.cudnn.allow_tf32 = False

    def holds(route, got):
        """(max abs error against the route's yardstick, its bar, held)"""
        if route == "tf32x3":
            err = float((got - exact).abs().max())
            return err, "rtol 1e-4 / atol 1e-3", bool(
                torch.allclose(got, exact, rtol=1e-4, atol=1e-3))
        if route == "tf32":
            err = float((got - exact).abs().max())
            bar = 2 * float((want[route] - exact).abs().max())
        else:
            err = float((got - want[route]).abs().max())
            bar = 0.25 * float((want[route] - exact).abs().max())
        return err, bar, err <= bar

    workdir = tempfile.mkdtemp(prefix="read_conv_variants_")
    try:
        with ThreadPoolExecutor(len(names)) as pool:
            built = dict(zip(names, pool.map(
                lambda n: build_variant(n, workdir, routes[0], args.against),
                names)))
        libs = {}
        for n, (path, _) in built.items():
            lib = ctypes.CDLL(path)
            lib.read_conv_reduce_run.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            if wide:
                lib.read_conv_reduce_wide_run.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            libs[n] = lib

        def run(n, route):
            f = folded[route]
            out = torch.zeros((A, rc.L_OUT, rc.C_OUT * f.width),
                              device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            if wide:
                err = libs[n].read_conv_reduce_wide_run(
                    rows.data_ptr(), rows.shape[0], 6, allele.data_ptr(),
                    valid.data_ptr(), f.flat.data_ptr(), A, out.data_ptr(),
                    stream)
            else:
                err = libs[n].read_conv_reduce_run(
                    rows.data_ptr(), rows.shape[0], 6, rc.ROUTE_IDS[route],
                    allele.data_ptr(), valid.data_ptr(), f.flat.data_ptr(),
                    A, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"variant {n} of route {route}: "
                                   f"cudaError {err}")
            return out

        times = {(r, n): [] for r in routes for n in names}
        for rnd, order in enumerate((names, names[::-1])):
            for n in order:
                for route in routes:
                    got = run(n, route)
                    torch.cuda.synchronize()
                    err, bar, ok = holds(route, got)
                    if variants[n][0] and not ok:
                        raise AssertionError(f"variant {n} of route {route}: "
                                             f"max abs error {err}, bar {bar}")
                    run(n, route)
                    reps = []
                    for _ in range(args.reps):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        run(n, route)
                        end.record()
                        end.synchronize()
                        reps.append(start.elapsed_time(end))
                    ms = statistics.median(reps)
                    times[route, n].append(ms)
                    print(json.dumps({"route": route, "variant": n,
                                      "round": rnd, "ms": ms,
                                      "keeps_arithmetic": variants[n][0],
                                      "max_abs_err": err, "bar": bar,
                                      "ptxas": built[n][1], "card": card}),
                          flush=True)
        for route in routes:
            print(json.dumps({"route": route,
                              "median_ms": {n: statistics.median(times[route, n])
                                            for n in names},
                              "rows": rows.shape[0], "card": card}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
