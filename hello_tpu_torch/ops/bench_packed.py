"""Device-rate A/B for the packed-row read convolution on the coded wire.

Measures the scoring forward at production shapes on the card, three ways
over the SAME coded-wire batch (the production input format off-CPU):

  dense-expand : expand_compact -> the kernel over the full [A, R] grid
                 flattened to rows (``row_valid`` = the read mask)
  packed       : expand_compact_packed -> the kernel over only the shipped
                 rows (the Scorer's ``packed_conv``, its default on a card)
  dense-batch  : the dense PaddedBatch uploaded as it is

All three run ``read_conv_reduce`` (nn/moe.py flattens the dense grid to
rows).  The kernel returns at once from a block whose rows are all padding
or masked, so on the dense grid it computes the blocks of rows that hold a
read, not the whole grid: ``computed_rows`` counts what each path makes
the kernel compute.

Occupancy is the lever: the packed path's gain grows with the padding
fraction of the dense read grid, so reads per allele are drawn ragged
(``--reads_lo/--reads_hi``) to reproduce production bucket occupancy
instead of a constant-depth grid.

Timing rules: two batches (seeds 0 and 1) resident on the device, rotated;
each iteration reads the experts' logits back to the host; the best median
of three windows spaced 2 s apart.

Usage: python -m hello_tpu_torch.ops.bench_packed [--sites 1024]
           [--precision bf16] [--model hybrid] [--fine_rows] [--device cuda]

It runs on the card; ``--device cpu`` runs the same forwards on the CPU
(the kernel's plain version), which says nothing of the card's rates.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

#: the three forwards over one coded-wire batch
PATHS = ("packed", "dense_expand", "dense_batch")


def build_palette_sites(rng, num_sites, alleles, reads_lo, reads_hi,
                        L=150, C=6):
    """Palette-valid ragged SiteWork (encode_site_work must accept them)."""
    from ..pipeline.batching import SiteWork
    from ..pipeline.compact import (BASE_PALETTE, QUAL_PALETTE,
                                    REF_COLOR_PALETTE)

    sites = []
    for si in range(num_sites):
        start = 1000 + 3 * si
        stop = start + 1
        mid = (start + stop) // 2
        fstart = mid - L // 2
        seg_idx = rng.randint(0, 5, size=L)
        seg = np.eye(5, dtype=np.float32)[seg_idx]
        ref_colors = np.asarray(REF_COLOR_PALETTE, np.uint8)[seg_idx]
        pos = np.arange(L) + fstart
        pos_colors = np.where((pos >= start) & (pos < stop), 240,
                              70).astype(np.uint8)

        def block(num_reads):
            t = np.zeros((num_reads, L, C), np.uint8)
            for r in range(num_reads):
                a = rng.randint(0, L // 2)
                b = rng.randint(a + 10, L)
                t[r, a:b, 0] = BASE_PALETTE[rng.randint(0, 5, size=b - a)]
                t[r, a:b, 1] = ref_colors[a:b]
                t[r, a:b, 2] = QUAL_PALETTE[rng.randint(20, 41, size=b - a)]
                t[r, a:b, 3] = rng.randint(100, 160)
                t[r, a:b, 4] = 70 if rng.rand() < 0.5 else 240
                t[r, a:b, 5] = pos_colors[a:b]
            return t

        t0 = [block(rng.randint(reads_lo, reads_hi + 1))
              for _ in range(alleles)]
        t1 = [block(rng.randint(max(1, reads_lo // 2), reads_hi // 2 + 1))
              for _ in range(alleles)]
        sites.append(SiteWork("chrB", start, stop,
                              [f"a{si}_{i}" for i in range(alleles)],
                              t0, t1, seg))
    return sites


def build(seed, sites, alleles, reads_lo, reads_hi, hybrid,
          fine_rows=False):
    """One workload batch from ``RandomState(seed)``: (the coded-wire
    ``WireBatch``, the dense ``PaddedBatch``) of the same sites."""
    from ..pipeline.batching import pack_sites
    from ..pipeline.compact import encode_chunk_sites, pack_sites_wire

    rng = np.random.RandomState(seed)
    work = build_palette_sites(rng, sites, alleles, reads_lo, reads_hi)
    coded = encode_chunk_sites(work)
    if coded is None:
        raise ValueError("sites failed to code")
    row_buckets = list(range(4096, 300_000, 4096)) if fine_rows else None
    wb = pack_sites_wire(coded, hybrid=hybrid, row_buckets=row_buckets)
    return wb, pack_sites(work, hybrid=hybrid)


def workload(wb, dense) -> dict:
    """Shipped rows (the wire's row axis, its bucket's padding included),
    the dense grid's rows and the occupancy, rows over grid."""
    rows = int(wb.wire["codes0"].shape[0]
               + wb.wire.get("codes1", np.empty((0, 1))).shape[0])
    grid = int(np.prod(dense.read_mask0.shape)
               + (np.prod(dense.read_mask1.shape)
                  if dense.read_mask1 is not None else 0))
    return {"shipped_rows": rows, "dense_grid": grid,
            "occupancy": rows / grid}


def to_device(arrays, device) -> dict:
    """A host dict of numpy arrays as tensors on ``device``."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def expand(path, batch):
    """The model's input for ``path``: the wire expanded to packed rows or
    to the dense grid, or the dense batch as it is."""
    from ..pipeline.compact import expand_compact, expand_compact_packed

    if path == "packed":
        return expand_compact_packed(batch)
    if path == "dense_expand":
        return expand_compact(batch)
    if path == "dense_batch":
        return batch
    raise ValueError(f"unknown path {path!r}")


def forward(model, folded, path, batch):
    """One eval forward of ``path`` -> (experts, meta)."""
    import torch

    with torch.inference_mode():
        out = model(expand(path, batch), folded=folded)
    return out["experts"], out["meta"]


def path_batches(path, device_batches):
    """The device-resident inputs ``path`` takes: the wire dicts, or the
    dense dicts for ``dense_batch``."""
    return [b["dense" if path == "dense_batch" else "wire"]
            for b in device_batches]


def computed_rows(model, path, batch, rows_per_block) -> dict:
    """Rows the kernel runs through its convs on ``path``
    (``bench_read_conv.computed_rows``) and the valid rows, summed over the
    platforms."""
    import torch

    from .bench_read_conv import computed_rows as kernel_rows

    with torch.inference_mode():
        x = expand(path, batch)
        computed = valid = 0
        for k in (0, 1) if model.hybrid else (0,):
            A = x[f"read_mask{k}"].shape[0]
            if f"rows{k}" in x:
                ok = (x[f"row_valid{k}"] != 0) & (x[f"row_allele{k}"] < A)
            else:
                ok = x[f"read_mask{k}"] != 0
            computed += kernel_rows(ok, rows_per_block)
            valid += int(ok.sum())
    return {"computed_rows": computed, "valid_rows": valid}


def timed(fn, batches, iters, n_sites):
    """Windows (sites) per second: the best median of three windows spaced
    2 s apart, each iteration reading the experts back to the host ->
    (windows/s, the warm call's (experts, meta) on ``batches[0]``, on the
    host)."""
    first = None
    for b in batches:                          # warm
        out = tuple(t if t is None else t.cpu() for t in fn(b))
        first = out if first is None else first
    best = None
    for rep in range(3):
        if rep:
            time.sleep(2.0)
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            out = fn(batches[i % len(batches)])
            out[0].cpu()
            times.append(time.perf_counter() - t0)
        rate = n_sites / statistics.median(times)
        best = rate if best is None else max(best, rate)
    return best, first


def measure(model, folded, device_batches, iters, n_sites,
            rows_per_block):
    """Each path timed on the rotated batches -> ({path: windows/s, the
    kernel's launches by route during its timing, its computed rows on
    batch 0}, {path: (experts, meta) on batch 0, from its warm call})."""
    from .. import telemetry
    from .read_conv import route_launches

    out, outputs = {}, {}
    for path in PATHS:
        batches = path_batches(path, device_batches)
        before = telemetry.counts()
        rate, outputs[path] = timed(
            lambda b: forward(model, folded, path, b), batches, iters,
            n_sites)
        out[path] = {"windows_per_s": rate,
                     "launches_by_route": route_launches(before),
                     **computed_rows(model, path, batches[0],
                                     rows_per_block)}
    return out, outputs


def run(argv=None) -> dict:
    """``main``'s work without its printing: the report {"device",
    "precision", "model", "sites", "alleles", the ``workload``, "paths"
    (``measure``'s), "packed_vs_dense_expand", "packed_vs_dense_batch"},
    and beside it the objects it was measured on: "inputs" {"model",
    "folded", "batches"} (the device-resident batches of seeds 0 and 1)
    and "outputs" ({path: (experts, meta) on batch 0})."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--sites", type=int, default=1024)
    parser.add_argument("--alleles", type=int, default=2)
    parser.add_argument("--reads_lo", type=int, default=20)
    parser.add_argument("--reads_hi", type=int, default=60)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--precision", default="bf16")
    parser.add_argument("--model", default="hybrid")
    parser.add_argument("--fine_rows", action="store_true",
                        help="bucket the packed row axis finely (4096 steps) "
                        "so shipped rows ~= real rows — the ceiling a "
                        "row-budget batcher would reach (NOT a production "
                        "setting: a shape per batch)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                        "cpu")
    args = parser.parse_args(argv)

    import torch

    from ..nn.convert import init_params
    from ..nn.layers import set_precision
    from ..nn.moe import create_model
    from ..pipeline.call import resolve_device
    from .read_conv_layout import ROWS

    device = resolve_device(args.device)
    set_precision(args.precision)
    model = init_params(create_model(args.model),
                        torch.Generator().manual_seed(0)).to(device).eval()
    folded = model.fold_read_convs()

    device_batches, shape = [], None
    for seed in range(2):
        wb, dense = build(seed, args.sites, args.alleles, args.reads_lo,
                          args.reads_hi, model.hybrid, args.fine_rows)
        if seed == 0:
            shape = workload(wb, dense)
        device_batches.append({"wire": to_device(wb.wire, device),
                               "dense": to_device(dense.device_dict(),
                                                  device)})
    paths, outputs = measure(model, folded, device_batches, args.iters,
                             args.sites, ROWS)
    packed = paths["packed"]["windows_per_s"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"device": name, "precision": args.precision,
            "model": args.model, "sites": args.sites,
            "alleles": args.alleles, **shape, "paths": paths,
            "packed_vs_dense_expand":
                packed / paths["dense_expand"]["windows_per_s"],
            "packed_vs_dense_batch":
                packed / paths["dense_batch"]["windows_per_s"],
            "inputs": {"model": model, "folded": folded,
                       "batches": device_batches},
            "outputs": outputs}


def report(result):
    """Print ``run``'s report: the workload (to stderr), each path's
    windows/s with the packed ratios, and the report as one JSON line."""
    print(f"workload: {result['sites']} sites x {result['alleles']} "
          f"alleles, shipped rows {result['shipped_rows']} / dense grid "
          f"{result['dense_grid']} (occupancy "
          f"{100 * result['occupancy']:.0f}%)", file=sys.stderr)
    rates = {p: result["paths"][p]["windows_per_s"] for p in PATHS}
    print(f"packed-row wire : {rates['packed']:8.0f} windows/s")
    print(f"dense-expand wire: {rates['dense_expand']:8.0f} windows/s  "
          f"(packed = {result['packed_vs_dense_expand']:.2f}x)")
    print(f"dense batch      : {rates['dense_batch']:8.0f} windows/s  "
          f"(packed = {result['packed_vs_dense_batch']:.2f}x)")
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("inputs", "outputs")}))


def main(argv=None):
    report(run(argv))


if __name__ == "__main__":
    main()
