"""Operations and bytes the inputs need, from shapes.

The read convolver's count per read is a copy of ``FLOPS_PER_READ`` in
``hello_tpu_torch/ops/bench_read_conv.py`` (commit 9a24431): 2 x the
multiply-adds of its 18 convs over a 150-position read, about 10.2 MFLOP.
The rest of the network is counted the same way by walking the layer specs
of the frozen ``reference/archs.py``: a conv's ``2 * K * Ci/g * Co *
L_out``, a linear's ``2 * in * out``; pooling, activations, sums, the
per-site and per-allele reductions and the genotype decode are left out
(elementwise work, under 1% of the convs').

Work is counted for real inputs only: each platform's real reads, the real
alleles and the real sites of a batch.  Padding rows, padded slots and the
rows a route computes beyond them are not work the inputs need.
"""

from __future__ import annotations

FLOPS_PER_READ = 2 * (
    3 * 6 * 16 * 148 + 3 * 16 * 16 * 146 + 3 * 16 * 32 * 144
    + 6 * (3 * 32 * 32 * 71)
    + 3 * 32 * 64 * 36 + 3 * 64 * 64 * 36 + 1 * 32 * 64 * 36
    + 6 * (3 * 64 * 64 * 36)
)   # ~10.2 MFLOP

#: the read convolver's input: 150 positions x 6 uint8 channels
READ_BYTES = 150 * 6
#: the read convolver's output per allele: [36, 64] float32
ALLELE_OUT_BYTES = 36 * 64 * 4


def _out_len(n, k, padding, dilation, stride):
    return (n + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def network_flops(specs, length: int):
    """(FLOPs per input row, output length) of a network on rows of
    ``length`` positions."""
    total = 0
    for spec in specs:
        t, kw = spec["type"], spec.get("kwargs") or {}
        if t in ("Conv1d", "WeightNormedConv1d"):
            out = _out_len(length, kw["kernel_size"], kw.get("padding", 0),
                           kw.get("dilation", 1), kw.get("stride", 1))
            total += (2 * kw["kernel_size"] * kw["in_channels"]
                      // kw.get("groups", 1) * kw["out_channels"] * out)
            length = out
        elif t in ("Linear", "WeightNormedLinear"):
            total += 2 * kw["in_features"] * kw["out_features"]
        elif t == "MaxPool1d":
            length = _out_len(length, kw["kernel_size"], kw.get("padding", 0),
                              1, kw.get("stride") or kw["kernel_size"])
        elif t == "AdaptiveAvgPool1d":
            length = 1
        elif t == "ResidualBlock":
            ff, out = network_flops(kw["feedforward"], length)
            sh, _ = network_flops(kw["shortcut"], length)
            total += ff + sh
            length = out
        elif t == "Fork":
            # the expert heads' fork only selects among its inputs
            total += sum(network_flops(n, length)[0] for n in kw["net_args"])
    return total, length


def forward_flops(cfg, reads, alleles: int, sites: int) -> int:
    """FLOPs of one forward over ``reads`` (real reads per platform, in
    platform order), ``alleles`` real alleles and ``sites`` real sites,
    following the model's data flow (nn/moe.py): each platform's read
    convolver per read; its compressor per allele and per site (the site
    route compresses the per-site sum); its expert head per allele; the
    hybrid's combiner0 and xattn2 per allele, combiner1 and the meta-expert
    per site."""
    total = 0
    for k, n in enumerate(reads):
        rc, _ = network_flops(cfg[f"read_conv{k}"], 150)
        total += n * rc
        comp, _ = network_flops(cfg[f"compressor{k}"], 36)
        head, _ = network_flops(cfg[f"xattn{k}"], 18)
        total += (alleles + sites) * comp + alleles * head
    if len(reads) > 1:
        total += alleles * (network_flops(cfg["combiner0"], 18)[0]
                            + network_flops(cfg["xattn2"], 18)[0])
        total += sites * (network_flops(cfg["combiner1"], 18)[0]
                          + network_flops(cfg["meta"], 18)[0])
    return total


def train_flops(cfg, reads, alleles: int, sites: int) -> int:
    """One training step: the forward and a backward of twice its FLOPs
    (the gradients of the inputs and of the weights)."""
    return 3 * forward_flops(cfg, reads, alleles, sites)


def read_conv_work(reads: int, alleles: int):
    """(FLOPs, bytes) of one ``read_conv_reduce`` launch over ``reads``
    real reads into ``alleles`` real alleles: every input byte read once
    (the uint8 rows, a row's allele index and validity) and the per-allele
    sums written once.  The folded weights (under 0.2 MB) are left out."""
    return (reads * FLOPS_PER_READ,
            reads * (READ_BYTES + 4 + 4) + alleles * ALLELE_OUT_BYTES)
