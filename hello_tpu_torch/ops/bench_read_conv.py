"""Time the fused read-convolver kernel against the layer route on the card,
each against the card's own roofline (rotated device-resident inputs, and
each timed call reads a scalar back to the host, so the result's copy is
not what is timed).

Two routes compute the same [A, 36, 64] per-allele sums of the standard
read convolver over a dense [A, R] grid of reads:

  * the layer route: the read convolver's layer modules on the grid
    flattened to rows, then the masked per-allele sum, as
    ``nn/moe.MoEAttention._read_reduce_layers`` runs them (cuDNN convs), at
    ``--precision``;
  * the kernel: ``read_conv_reduce`` over the grid flattened to rows
    (``row_valid`` = the read mask), as the dense path of ``nn/moe.py``
    launches it, on the route of ``--precision`` and on the ``bf16`` route,
    each folded under its own precision.

The roofline takes the card's published peaks (``CARD_PEAKS``, by
``torch.cuda.get_device_name``) unless ``--hbm_peak`` and
``--flops_peak`` are given, and for each path the FLOP peak of the math it
runs (``MATH``): fp32 for the layer route at ``highest`` and at ``bf16``
(cuDNN's TF32 stays off there), TF32 at ``default`` and for the kernel's
``tf32x3`` and ``tf32`` routes, bf16 for its ``bf16`` route.  The layer
route's bytes are the modeled activation traffic (``hbm_bytes_per_read``:
every intermediate written once and read once); the kernel's are its
inputs read once and its output written once.

Usage: python -m hello_tpu_torch.ops.bench_read_conv [--A 512] [--R 128]
           [--iters 8] [--precision default] [--device cuda]

``--device cpu`` times the same functions on the CPU (the kernel's plain
version) and prints no roofline unless both peaks are given.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import numpy as np


# Modeled HBM traffic of the layer route, per read row.  Assumption: every
# intermediate activation tensor is written once and read once (elementwise
# and residual adds fused into the convs, conv->conv not fused), plus the
# uint8 input row read once.  Element counts are the read convolver's
# intermediates for L=150.
_ACT_ELEMS_PER_READ = (
    16 * 148 + 16 * 146 + 32 * 144 + 32 * 71   # stem convs + maxpool out
    + 6 * (32 * 71)                            # 3x RB32 (2 convs each)
    + 3 * (64 * 36)                            # RBConv (conv1, conv2, shortcut)
    + 6 * (64 * 36)                            # 3x RB64
)
FLOPS_PER_READ = 2 * (
    3 * 6 * 16 * 148 + 3 * 16 * 16 * 146 + 3 * 16 * 32 * 144
    + 6 * (3 * 32 * 32 * 71)
    + 3 * 32 * 64 * 36 + 3 * 64 * 64 * 36 + 1 * 32 * 64 * 36
    + 6 * (3 * 64 * 64 * 36)
)   # ~10.2 MFLOP


def hbm_bytes_per_read(act_bytes: int) -> int:
    return 2 * _ACT_ELEMS_PER_READ * act_bytes + 150 * 6


#: published peaks of the cards the kernel is built for (NVIDIA H100 data
#: sheets, dense rates): memory GB/s, and TFLOP/s of fp32 outside the
#: tensor cores and of TF32 and bf16 on them
CARD_PEAKS = {
    "H100 SXM": {"hbm_gbs": 3350.0, "fp32": 67.0, "tf32": 495.0,
                 "bf16": 989.0},
    "H100 PCIe": {"hbm_gbs": 2000.0, "fp32": 51.0, "tf32": 378.0,
                  "bf16": 756.0},
}

#: the math each path runs: the layer route by precision (cuDNN's TF32 is
#: allowed at default only), the kernel by route
MATH = {("layers", "highest"): "fp32", ("layers", "high"): "fp32",
        ("layers", "default"): "tf32", ("layers", "bf16"): "fp32",
        ("kernel", "tf32x3"): "tf32", ("kernel", "tf32"): "tf32",
        ("kernel", "bf16"): "bf16"}


def card_peaks(name, hbm_peak=None, flops_peak=None) -> dict:
    """{"hbm_gbs", "fp32", "tf32", "bf16"} for the card ``name``: the
    table's, with ``hbm_peak`` (GB/s) and ``flops_peak`` (TFLOP/s, then
    taken for every math) in place of its values.  A card the table does
    not know raises unless both are given."""
    key = None
    if "H100" in name:
        key = "H100 PCIe" if "PCIe" in name else (
            "H100 SXM" if ("SXM" in name or "HBM3" in name) else None)
    if key is None and (hbm_peak is None or flops_peak is None):
        raise ValueError(f"no published peaks for {name!r}: pass --hbm_peak "
                         "(GB/s) and --flops_peak (TFLOP/s)")
    peaks = dict(CARD_PEAKS[key]) if key else {}
    if hbm_peak is not None:
        peaks["hbm_gbs"] = float(hbm_peak)
    if flops_peak is not None:
        peaks.update(fp32=float(flops_peak), tf32=float(flops_peak),
                     bf16=float(flops_peak))
    return peaks


def make_batches(A, R, device, count=2):
    """``count`` batches of random uint8 reads [A, R, 150, 6] and read masks
    (rand < 0.8) from ``RandomState(0)``, on ``device``."""
    import torch

    rng = np.random.RandomState(0)
    batches = []
    for _ in range(count):
        reads = rng.randint(0, 255, size=(A, R, 150, 6)).astype(np.uint8)
        mask = (rng.rand(A, R) < 0.8).astype(np.float32)
        batches.append((torch.from_numpy(reads).to(device),
                        torch.from_numpy(mask).to(device)))
    return batches


@contextlib.contextmanager
def precision(name):
    """``set_precision(name)`` inside, the precision in force restored
    after."""
    from ..nn import layers as L

    saved = L.PRECISION
    L.set_precision(name)
    try:
        yield
    finally:
        L.set_precision(saved)


def layer_route(model, reads, mask):
    """The read convolver's layers on the flattened grid and the masked
    per-allele sum -> [A, 36, 64]."""
    import torch

    with torch.inference_mode():
        return model._read_reduce_layers(
            {"reads0": reads, "read_mask0": mask}, 0)


def kernel_inputs(reads, mask):
    """The dense grid as the kernel's rows: (rows [A*R, 150, C], row_allele
    [A*R] int32, row_valid [A*R] float32, A)."""
    import torch

    A, R = reads.shape[:2]
    rows = reads.reshape((A * R,) + tuple(reads.shape[2:]))
    row_allele = torch.div(
        torch.arange(A * R, dtype=torch.int32, device=reads.device), R,
        rounding_mode="floor")
    return rows, row_allele, mask.reshape(-1).float(), A


def kernel_route(folded, reads, mask):
    """``read_conv_reduce`` over the grid flattened to rows -> [A, 36, 64]."""
    from .read_conv import read_conv_reduce

    rows, row_allele, row_valid, A = kernel_inputs(reads, mask)
    return read_conv_reduce(rows, row_allele, row_valid, folded, A)


def computed_rows(valid, rows_per_block) -> int:
    """Rows the kernel runs through its convs, given which of its rows are
    valid (nonzero ``valid``, any shape flattened to the kernel's rows):
    every row of a block of ``rows_per_block`` that holds a valid row (a
    block of padding and masked rows returns at once)."""
    import torch

    ok = valid.reshape(-1) != 0
    pad = (-ok.numel()) % rows_per_block
    blocks = torch.nn.functional.pad(ok, (0, pad)).reshape(
        -1, rows_per_block).any(dim=1)
    return int(blocks.repeat_interleave(rows_per_block)[:ok.numel()].sum())


def timed(fn, batches, iters):
    """Median seconds of one call, the sum of the [A, 36, 64] it returns
    read back to the host each time, after one warm call per batch ->
    (seconds, the warm call's output on ``batches[0]``)."""
    first = None
    for b in batches:
        out = fn(*b)
        float(out.sum())
        first = out if first is None else first
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        float(fn(*batches[i % len(batches)]).sum())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), first


def paths(precision_name):
    """(tag, kind, route or precision, precision to fold and run under) of
    each timed path: the layer route at the precision, the kernel on the
    precision's route and on the bf16 route."""
    from .read_conv import route_for_precision

    route = route_for_precision(precision_name)
    out = [(f"layers ({precision_name})", "layers", precision_name,
            precision_name),
           (f"kernel {route}", "kernel", route, precision_name)]
    if route != "bf16":
        out.append(("kernel bf16", "kernel", "bf16", "bf16"))
    return out


def measure(model, batches, precision_name, iters, peaks=None,
            rows_per_block=5):
    """Each path of ``paths(precision_name)`` timed on ``batches`` ->
    (one dict per path with its ms, reads/s over all A*R rows and over the
    rows it computes, its TFLOP/s and GB/s, and with ``peaks`` its shares of
    the peaks of its math and of memory; {tag: the path's [A, 36, 64] on
    ``batches[0]``}, from its warm call)."""
    A, R = batches[0][0].shape[:2]
    act_bytes = 2 if precision_name == "bf16" else 4
    net = model.net("read_conv0")
    out, outputs = [], {}
    for tag, kind, route, run_under in paths(precision_name):
        with precision(run_under):
            if kind == "layers":
                fn = lambda reads, mask: layer_route(model, reads, mask)
                rows = A * R
                nbytes = A * R * hbm_bytes_per_read(act_bytes)
            else:
                from .read_conv import fold_read_conv_weights

                folded = fold_read_conv_weights(net, route)
                fn = lambda reads, mask: kernel_route(folded, reads, mask)
                rows = computed_rows(batches[0][1], rows_per_block)
                nbytes = (A * R * (150 * 6 + 4) + A * 36 * 64 * 4
                          + folded.flat.numel() * folded.flat.element_size())
            seconds, outputs[tag] = timed(fn, batches, iters)
        line = {"tag": tag, "kind": kind, "route": route,
                "math": MATH[(kind, route)], "ms": seconds * 1e3,
                "reads_per_s": A * R / seconds, "computed_rows": rows,
                "computed_reads_per_s": rows / seconds,
                "tflop_per_s": rows * FLOPS_PER_READ / seconds / 1e12,
                "gb_per_s": nbytes / seconds / 1e9,
                "bytes": "modeled activations" if kind == "layers"
                         else "inputs and output once"}
        if peaks is not None:
            line.update(
                flop_peak_tflops=peaks[line["math"]],
                flop_share=line["tflop_per_s"] / peaks[line["math"]],
                hbm_peak_gbs=peaks["hbm_gbs"],
                hbm_share=line["gb_per_s"] / peaks["hbm_gbs"])
        out.append(line)
    base = out[0]["ms"]
    for line in out[1:]:
        line["speedup_vs_layers"] = base / line["ms"]
    return out, outputs


def run(argv=None) -> dict:
    """``main``'s work without its printing: the report {"device", "A",
    "R", "precision", "lanes", "iters", "peaks", "paths"} (``measure``'s
    lines; ``peaks`` None without a roofline), and beside it the objects it
    was measured on: "inputs" {"model", "batches"} and "outputs" ({tag:
    [A, 36, 64] on batches[0]})."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--A", type=int, default=512)
    parser.add_argument("--R", type=int, default=128)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--precision", default="default")
    parser.add_argument("--lanes", type=int, default=128,
                        help="the TPU kernel's lane-block width; the CUDA "
                        "kernel has none: accepted and reported only")
    parser.add_argument("--hbm_peak", type=float, default=None,
                        help="memory peak GB/s (default: the card's, "
                        "CARD_PEAKS)")
    parser.add_argument("--flops_peak", type=float, default=None,
                        help="FLOP peak TFLOP/s for every path (default: "
                        "the card's peak of each path's math)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    args = parser.parse_args(argv)

    import torch

    from ..nn.convert import init_params
    from ..nn.moe import create_model
    from ..pipeline.call import resolve_device
    from .read_conv_layout import ROWS

    device = resolve_device(args.device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        peaks = card_peaks(name, args.hbm_peak, args.flops_peak)
    else:
        name = "cpu"
        peaks = (card_peaks(name, args.hbm_peak, args.flops_peak)
                 if args.hbm_peak is not None or args.flops_peak is not None
                 else None)
    model = init_params(create_model("illumina"),
                        torch.Generator().manual_seed(0)).to(device).eval()
    batches = make_batches(args.A, args.R, device)
    lines, outputs = measure(model, batches, args.precision, args.iters,
                             peaks, ROWS)
    return {"device": name, "A": args.A, "R": args.R,
            "precision": args.precision, "lanes": args.lanes,
            "iters": args.iters, "peaks": peaks, "paths": lines,
            "inputs": {"model": model, "batches": batches},
            "outputs": outputs}


def report(result):
    """Print ``run``'s report: a line per path, its ratio to the layer
    route and, with peaks, its roofline shares."""
    print(f"{result['device']}: A={result['A']} R={result['R']} "
          f"precision={result['precision']} lanes={result['lanes']} (not "
          "used by the CUDA kernel)")
    for line in result["paths"]:
        print(f"{line['tag']:30s} {line['ms']:8.2f} ms  "
              f"({line['reads_per_s'] / 1e6:.2f} Mreads/s; "
              f"{line['computed_reads_per_s'] / 1e6:.2f} M of the "
              f"{line['computed_rows']} rows computed/s)")
        if "speedup_vs_layers" in line:
            print(f"  -> {line['speedup_vs_layers']:.2f}x vs layers")
        if result["peaks"] is None:
            continue
        print(f"  {line['kind']}: {line['tflop_per_s']:5.2f} TFLOP/s "
              f"({100 * line['flop_share']:4.1f}% of "
              f"{line['flop_peak_tflops']:.0f} {line['math']} peak) | "
              f"{line['bytes']} {line['gb_per_s']:7.1f} GB/s "
              f"({100 * line['hbm_share']:5.1f}% of "
              f"{line['hbm_peak_gbs']:.0f} peak)")


def main(argv=None):
    report(run(argv))


if __name__ == "__main__":
    main()
