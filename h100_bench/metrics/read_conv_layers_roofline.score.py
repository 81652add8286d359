"""The layer-route read convolvers' share of their roofline: the least time
of a batch's real reads over their mean card time a batch
(``read_conv_layers_ms.score``), x 100.

The least time is the larger of the reads' FLOPs at the stated precision's
peak and their bytes at HBM's (``peaks.roofline_seconds``).  FLOPs: each
platform's read convolver at 150 positions (``flops.network_flops`` of the
configuration's ``read_conv<k>``) times the reads a batch holds, the same
in every batch of the mix (``generator.read_counts``).  Bytes: each read's
uint8 input, its allele index and validity read once, and each real
allele's summed frames written once in fp32.  Every platform of the cell
is counted: the metric is read only in cells whose read convolvers all
take the layer route."""

import numpy as np

from h100_bench import cells, flops, generator, peaks
from h100_bench.program_spans import window_mean
from h100_bench.reference import model as ref


def _out_channels(specs):
    """Channels of a network's output: its last conv's."""
    out = None
    for spec in specs:
        kw = spec.get("kwargs") or {}
        if spec["type"] in ("Conv1d", "WeightNormedConv1d"):
            out = kw["out_channels"]
        elif spec["type"] == "ResidualBlock":
            out = _out_channels(kw["feedforward"])
    return out


def batch_work(cell: str):
    """(FLOPs, bytes) of one batch's real reads through the read
    convolvers, from the cell's configuration and mix."""
    spec = cells.cell(cell)
    cfg, traffic = spec["config"], spec["traffic"]
    net = ref.config(cfg["model"])
    alleles = traffic["sites_per_batch"] * traffic["alleles_per_site"]
    rng = np.random.default_rng(0)      # the counts' sum is the seed's none
    total_flops = total_bytes = 0
    for k, (lo, hi) in enumerate(generator.read_ranges(cfg, traffic)):
        reads = int(generator.read_counts(rng, alleles, lo, hi).sum())
        specs = net[f"read_conv{k}"]
        per_read, length = flops.network_flops(specs, generator.L)
        total_flops += reads * per_read
        total_bytes += (reads * (flops.READ_BYTES + 4 + 4)
                        + alleles * length * _out_channels(specs) * 4)
    return total_flops, total_bytes


def read(ctx):
    ms = window_mean(ctx, "scorer.read_conv_layers")
    if not ms:
        return None
    least = peaks.roofline_seconds(*batch_work(ctx["cell"]), ctx["precision"])
    return 100.0 * least / (ms / 1e3)
