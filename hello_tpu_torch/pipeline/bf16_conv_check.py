"""Whether the ``bf16`` precision's convs on the card multiply exactly and
sum in fp32, and whether cuDNN's TF32 moves the values of those that run
through cuDNN, with the switch off and on in one process.

At ``bf16`` every conv of the port multiplies bf16 operands exactly and
sums in fp32, as hello_tpu's bf16 convs do.  On the card the eval-mode
convs run ``ops/conv_bf16``'s kernel (bf16 NWC in, fp32 sums, the fp32
bias, one rounding to bf16 out), which no cuDNN switch reaches; the others
(train mode, and the CPU's) run cuDNN's fp32 convs on bf16-valued operands
(``nn/layers.conv1d_bf16``), for which ``set_precision("bf16")`` keeps
cuDNN's TF32 off.  For each model and weight seed this reports:

* ``convs``: every ``conv1d_bf16`` call of one card forward of featurized
  sites, against the same operands convolved in float64 on the card: the
  largest error over the output's largest magnitude.  Exact products with
  fp32 sums stay within a few 2^-24; operands rounded to TF32 would show
  errors near 2^-11.  (A card forward in eval mode makes none.)
* ``kernel_convs``: every launch of the conv kernel in the same forward
  (``ops.conv_bf16.conv1d_bf16_nwc``), against the float64 conv of its
  bf16 operands plus the fp32 bias, rounded once to bf16
  (``bf16_round_once``): the share of its bf16 outputs that differ
  (``differ_share``; an fp32 sum lands on the other side of a bf16 tie
  for a few values in 10^3, a sum rounded before the bias or a truncation
  for far more) and the largest error over the largest magnitude.
* ``layers``: every layer of every network fed the CPU's own bf16 input to
  it: the share of bf16 outputs that differ from the CPU's, and the largest
  difference over the layer's largest value (one bf16 ulp is 2^-8 to 2^-7
  of a value; 2^-6 is the bar of chip_smoke.py's per-layer check).
* ``calls``: for each genome seed, the card's bf16 records against the
  CPU's bf16 records of the same weights, as ratios of the CPU's own
  bf16-against-highest quality deltas (chip_smoke.py's bf16 bar: worst at
  most 2x, median at most 0.5x; no site flips).

Usage: python -m hello_tpu_torch.pipeline.bf16_conv_check
           [--models illumina_wide,illumina_layer_norm] [--weight_seeds 0,1]
           [--genome_seeds 9,10] [--genome_bp 600000]
           [--out precision_sweep_out/bf16_conv_check.json]

It runs on the card (``--device cpu`` only rehearses it: the CPU has no
TF32), prints one JSON line per reading and writes them all to ``--out``
(by default in the git-ignored ``precision_sweep_out/``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import tempfile
import time

import numpy as np
import torch

#: sites featurized for the per-conv and per-layer readings
LAYER_SITES = 64


def featurized_batch(ds, n_sites=LAYER_SITES, hybrid=False):
    """A packed batch (CPU tensors) of the first ``n_sites`` candidate sites
    with alleles in the first 100 kb of ``ds``: single-tech from its
    Illumina BAM, or with ``hybrid`` two-platform from its Illumina and
    PacBio BAMs, as the hybrid caller featurizes and packs them."""
    from ..io.fasta import FastaFile
    from .batching import pack_sites
    from .candidates import native_chunk_site_work

    options = dict(pacbio=False, include_hp=False, hybrid_hotspot=False,
                   q_threshold=10, min_mapq=10, reassembly_size=10,
                   feature_length=150, wire="dense")
    bams = [ds.bams["illumina"]] + ([ds.bams["pacbio"]] if hybrid else [])
    ref = FastaFile(ds.fasta)
    sites = native_chunk_site_work(
        bams, ref, ds.chromosome, 0,
        min(ref.length(ds.chromosome), 100_000), options, random.Random(13))
    sites = [s for s in sites if s.alleles][:n_sites]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             pack_sites(sites, hybrid=hybrid).device_dict().items()}
    return batch, len(sites)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [] if x is None else [x]


def _to(x, device):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return None if x is None else x.to(device)


def layers_against_cpu(cpu_model, card_model, batch):
    """Every layer of every network of ``card_model``, fed the input that
    layer gets in a CPU forward of ``cpu_model`` (the same weights) on
    ``batch``, against the CPU layer's output: one dict per layer and call
    with the output dtypes, and for bf16 outputs ``differ_share`` and
    ``max_diff_over_layer_max``, for fp32 outputs ``fp32_max_rel``.

    The CPU forward takes the layer route for every read convolver, so the
    read convolvers' layers are held too (the kernel exposes none).  Every
    call of a network is held (``call`` counts them: a compressor runs its
    allele pass, then its site pass), with its whole input, tuples and all
    (the xattns, combiners and meta-expert take tuples)."""
    from ..nn.moe import LayerRoute

    inputs, handles = {}, []

    def record(net_name):
        def hook(module, args):
            inputs.setdefault(net_name, []).append(args[0])
        return hook

    for net_name, net in cpu_model.networks().items():
        handles.append(net.register_forward_pre_hook(record(net_name)))
    layer_routes = {name: LayerRoute() for name in ("read_conv0", "read_conv1")
                    if cpu_model.net(name) is not None}
    try:
        with torch.inference_mode():
            cpu_model(batch, folded=layer_routes)
    finally:
        for h in handles:
            h.remove()
    device = next(card_model.parameters()).device
    out = []
    with torch.inference_mode():
        for net_name, calls in inputs.items():
            for call, x in enumerate(calls):
                out += _layers_of_call(cpu_model, card_model, net_name, call,
                                       x, device)
    return out


def _layers_of_call(cpu_model, card_model, net_name, call, x, device):
    out = []
    for i, (cpu_layer, card_layer) in enumerate(zip(
            cpu_model.net(net_name).network,
            card_model.net(net_name).network, strict=True)):
        y = cpu_layer(x)
        t = card_layer(_to(x, device))
        for want, got in zip(_leaves(y), _leaves(t), strict=True):
            w = want.float().numpy()
            g = got.float().cpu().numpy()
            scale = float(np.abs(w).max()) or 1.0
            line = {"net": net_name, "call": call, "layer": i,
                    "type": type(cpu_layer).__name__,
                    "cpu_dtype": str(want.dtype),
                    "card_dtype": str(got.dtype)}
            if want.dtype == torch.bfloat16:
                line.update(
                    differ_share=float((g != w).mean()),
                    max_diff_over_layer_max=float(
                        np.abs(g - w).max()) / scale)
            else:
                line["fp32_max_rel"] = float(np.abs(g - w).max()) / scale
            out.append(line)
        x = y
    return out


def bf16_round_once(y64: torch.Tensor) -> torch.Tensor:
    """float64 -> bf16, rounded once to the nearest (ties to even): through
    fp32, moved one fp32 ulp toward the exact value where the fp32 value
    fell on a bf16 tie that the exact value does not."""
    y32 = y64.float()
    tie = (y32.view(torch.int32) & 0xFFFF) == 0x8000
    off = y32.double() != y64
    toward = torch.nextafter(y32, torch.where(
        y64 > y32.double(), torch.inf, -torch.inf).float())
    return torch.where(tie & off, toward, y32).to(torch.bfloat16)


def kernel_reading(y, x, w, b, **kwargs):
    """One launch of the conv kernel against float64: ``y`` (bf16 NWC) and
    the float64 conv of its bf16 operands ``x`` (NWC) and ``w`` rounded to
    bf16, plus ``b``, rounded once: ``differ_share``, the share of ``y``'s
    values that differ, and ``max_err_over_max``."""
    y64 = torch.nn.functional.conv1d(
        x.double().transpose(1, 2), w.to(torch.bfloat16).double(), None,
        **kwargs)
    if b is not None:
        y64 = y64 + b.double()[None, :, None]
    y64 = y64.transpose(1, 2)
    want = bf16_round_once(y64)
    scale = float(y64.abs().max()) or 1.0
    return {"differ_share": float((y != want).float().mean()),
            "max_err_over_max": float((y.double() - y64).abs().max())
            / scale}


@contextlib.contextmanager
def conv_errors_against_float64(errors, kernel=None):
    """While active, every ``nn.layers.conv1d_bf16`` call also convolves its
    operands in float64 on their device and appends the largest error of
    its fp32 result over the float64 result's largest magnitude (bias
    included) to ``errors``; with a list ``kernel``, every call of the conv
    kernel's wrapper (``ops.conv_bf16.conv1d_bf16_nwc``, the card's
    eval-mode bf16 convs) appends its ``kernel_reading`` there."""
    from ..nn import layers
    from ..ops import conv_bf16

    plain = layers.conv1d_bf16
    launch = conv_bf16.conv1d_bf16_nwc

    def checked(x, w, b, **kwargs):
        y = plain(x, w, b, **kwargs)
        y64 = plain(x.double(), w.double(),
                    None if b is None else b.double(), **kwargs)
        scale = float(y64.abs().max()) or 1.0
        errors.append(float((y.double() - y64).abs().max()) / scale)
        return y

    def read(x, w, b, **kwargs):
        y = launch(x, w, b, **kwargs)
        kernel.append(kernel_reading(y, x, w, b, **kwargs))
        return y

    layers.conv1d_bf16 = checked
    if kernel is not None:
        conv_bf16.conv1d_bf16_nwc = read
    try:
        yield errors
    finally:
        layers.conv1d_bf16 = plain
        conv_bf16.conv1d_bf16_nwc = launch


def _worst(lines, key):
    values = [line[key] for line in lines if key in line]
    return max(values) if values else None


def forward_readings(name, seed, batch, device):
    """The per-conv and per-layer readings of one model at bf16, with
    cuDNN's TF32 off and on."""
    from ..nn.convert import init_params
    from ..nn.layers import set_precision
    from ..nn.moe import create_model

    set_precision("bf16")
    cpu_model = init_params(create_model(name),
                            torch.Generator().manual_seed(seed)).eval()
    card_model = create_model(name)
    card_model.load_state_dict(cpu_model.state_dict())
    card_model = card_model.to(device).eval()
    card_batch = {k: v.to(device) for k, v in batch.items()}
    out = {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            errors, kernel = [], []
            with conv_errors_against_float64(errors, kernel), \
                    torch.inference_mode():
                card_model(card_batch)
            layers = layers_against_cpu(cpu_model, card_model, batch)
            out["cudnn_tf32_on" if tf32 else "cudnn_tf32_off"] = {
                "convs": len(errors),
                "conv_max_err_over_max": max(errors, default=None),
                "conv_median_err_over_max":
                    float(np.median(errors)) if errors else None,
                "kernel_convs": len(kernel),
                "kernel_max_differ_share": _worst(kernel, "differ_share"),
                "kernel_max_err_over_max": _worst(kernel,
                                                  "max_err_over_max"),
                "layers_bf16": sum("differ_share" in x for x in layers),
                "layer_max_differ_share": _worst(layers, "differ_share"),
                "layer_max_diff_over_layer_max": _worst(
                    layers, "max_diff_over_layer_max"),
                "layer_fp32_max_rel": _worst(layers, "fp32_max_rel"),
                "layers": layers}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        set_precision("highest")
    return out


def _records(scorer, ds, out_vcf):
    from ..io.vcf import read_vcf
    from .call import call_genome

    call_genome([ds.bams["illumina"]], ds.fasta, scorer, out_vcf)
    return read_vcf(out_vcf)


def call_readings(name, seed, ds, device, workdir):
    """The card's bf16 records with cuDNN's TF32 off and on, each against
    the CPU's bf16 records of the same weights, as ratios of the CPU's own
    bf16-against-highest quality deltas."""
    from ..nn.layers import set_precision
    from .call import Scorer, load_scorer
    from .precision_sweep import compare

    cpu = {}
    for precision in ("highest", "bf16"):
        set_precision(precision)
        scorer = Scorer(load_scorer(name, seed=seed, device="cpu").model,
                        device="cpu", packed_conv=True)
        cpu[precision] = _records(
            scorer, ds, os.path.join(workdir, f"{name}_{precision}_cpu.vcf"))
    _, _, dq_cpu = compare(cpu["highest"], cpu["bf16"])
    set_precision("bf16")
    card = load_scorer(name, seed=seed, device=device)
    out = {"records": len(cpu["bf16"]),
           "cpu_bf16_vs_highest_dq_max": float(dq_cpu.max()),
           "cpu_bf16_vs_highest_dq_median": float(np.median(dq_cpu))}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            records = _records(card, ds, os.path.join(
                workdir, f"{name}_bf16_card_tf32{int(tf32)}.vcf"))
            site_flips, gt_flips, dq = compare(records, cpu["bf16"])
            out["cudnn_tf32_on" if tf32 else "cudnn_tf32_off"] = {
                "site_flips": site_flips, "genotype_flips": gt_flips,
                "dq_max_ratio": float(dq.max() / dq_cpu.max()),
                "dq_median_ratio": float(np.median(dq)
                                         / np.median(dq_cpu))}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        set_precision("highest")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="illumina_wide,illumina_layer_norm")
    parser.add_argument("--weight_seeds", default="0,1")
    parser.add_argument("--genome_seeds", default="9,10")
    parser.add_argument("--genome_bp", type=int, default=600_000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=os.path.join(
        "precision_sweep_out", "bf16_conv_check.json"))
    args = parser.parse_args(argv)

    from .. import sim
    from .precision_sweep import _card

    models = args.models.split(",")
    weight_seeds = [int(s) for s in args.weight_seeds.split(",")]
    genome_seeds = [int(s) for s in args.genome_seeds.split(",")]
    report = {"card": _card(args.device), "genome_bp": args.genome_bp,
              "forward": [], "calls": []}

    def emit(kind, line):
        brief = {k: ({kk: vv for kk, vv in v.items() if kk != "layers"}
                     if isinstance(v, dict) else v) for k, v in line.items()}
        print(json.dumps({kind: brief}), flush=True)
        report[kind].append(line)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bf16_conv_check_") as d:
        genomes = {g: sim.make_dataset(
            os.path.join(d, f"genome{g}"), ref_length=args.genome_bp,
            num_variants=args.genome_bp // 1000, coverage=30,
            read_length=150, seed=g) for g in genome_seeds}
        batch, sites = featurized_batch(genomes[genome_seeds[0]])
        for name in models:
            for seed in weight_seeds:
                emit("forward", dict(model=name, weight_seed=seed,
                                     sites=sites, **forward_readings(
                                         name, seed, batch, args.device)))
                for g, ds in genomes.items():
                    emit("calls", dict(model=name, weight_seed=seed,
                                       genome_seed=g, **call_readings(
                                           name, seed, ds, args.device, d)))
    report["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"seconds": report["seconds"], "out": args.out}),
          flush=True)


if __name__ == "__main__":
    main()
