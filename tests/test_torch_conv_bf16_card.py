"""The eval bf16 conv kernel (``csrc/conv_bf16.cu``) on the card, at the
benchmark cells' shapes: one batch of 1,024 sites x 2 alleles, 20 to 60
Illumina reads per allele (and 10 to 30 PacBio reads for ``hybrid``), as
``h100_bench``'s generator makes it and the coded wire ships it, through
the Scorer's eager forward.

* Every conv the forward runs outside the read-conv kernels launches the
  kernel (the launch ledger's ``("conv_bf16",)`` count equals the convs'
  calls), and each launch's bf16 output differs from the float64 conv of
  its bf16 operands plus the fp32 bias, rounded once, in at most 0.2% of
  its values (``pipeline/bf16_conv_check.py``'s layer bar).
* Planted faults fail that bar: the sum rounded to bf16 before the bias,
  and the float64 result truncated to bf16.
* Two launches give the same bits, and every tile the same bits.
* The gather of Ci 5 to 7 and K blocks part zeros hold the bar too.

Marked ``card``: each test skips without a card.  Imports no JAX: run with
``python -m pytest --noconftest tests/test_torch_conv_bf16_card.py``.
"""

import numpy as np
import pytest
import torch

from h100_bench import generator
from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import conv_bf16 as cb
from hello_tpu_torch.pipeline.bf16_conv_check import (bf16_round_once,
                                                      kernel_reading)
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                              pack_sites_wire)

SEED = 2**31 + 25
SITES, ALLELES = 1024, 2
READS = {"illumina_wide": [[20, 60]], "hybrid": [[20, 60], [10, 30]]}
#: bf16_conv_check's layer bar: the share of bf16 values that may differ
DIFFER_SHARE = 0.002


@pytest.fixture(autouse=True)
def bf16():
    layers.set_precision("bf16")
    yield
    layers.set_precision("highest")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the conv kernel")
    return torch.device("cuda", 0)


def _forward(name, card):
    """One eager forward of the cell's batch: [(conv module, its bf16
    input, its output)] for every conv call outside the read convolvers,
    and the launch ledger's change."""
    model = init_params(create_model(name),
                        torch.Generator().manual_seed(0)).eval()
    scorer = Scorer(model, device=card)
    batch = generator.make_batch(SEED, 0, SITES, ALLELES, READS[name])
    wire = pack_sites_wire(encode_chunk_sites(generator.port_sites(batch)),
                           hybrid=model.hybrid).wire
    calls = []
    hooks = [m.register_forward_hook(
        lambda m, args, out: calls.append((m, args[0], out)))
        for net, mod in model.networks().items()
        if not net.startswith("read_conv")
        for m in mod.modules() if isinstance(m, layers._ConvBase)]
    before = telemetry.counts()
    try:
        with torch.inference_mode():
            scorer._forward(scorer._refresh(0), scorer._upload(wire, card),
                            True)
        torch.cuda.synchronize(card)
    finally:
        for h in hooks:
            h.remove()
    return calls, telemetry.counts() - before


def _operands(m, x):
    w = (m.conv1d.weight() if isinstance(m, layers.WeightNormedConv1d)
         else m.weight)
    b = m.conv1d.bias if isinstance(m, layers.WeightNormedConv1d) else m.bias
    geo = dict(stride=m.stride, padding=m.padding, dilation=m.dilation,
               groups=m.groups)
    return x.to(torch.bfloat16), w, b, geo


@pytest.mark.card
@pytest.mark.parametrize("name", ["illumina_wide", "hybrid"])
def test_every_eval_conv_launches_the_kernel_within_the_bar(card, name):
    calls, counted = _forward(name, card)
    assert calls and counted[("conv_bf16",)] == len(calls)
    worst = []
    with torch.inference_mode():
        for m, x, y in calls:
            x, w, b, geo = _operands(m, x)
            assert y.dtype == torch.bfloat16 and y.is_contiguous()
            read = kernel_reading(y, x, w, b, **geo)
            worst.append((read["differ_share"], tuple(x.shape),
                          tuple(w.shape)))
    assert max(worst)[0] <= DIFFER_SHARE, max(worst)


@pytest.mark.card
@pytest.mark.parametrize("name", ["illumina_wide", "hybrid"])
def test_planted_faults_fail_the_bar(card, name):
    calls, _ = _forward(name, card)
    early, truncated = [], []
    with torch.inference_mode():
        for m, x, _ in calls:
            x, w, b, geo = _operands(m, x)
            # the sum rounded to bf16 before the fp32 bias is added
            y = (cb.conv1d_bf16_nwc(x, w, None, **geo).float() + b).to(
                torch.bfloat16)
            early.append(kernel_reading(y, x, w, b, **geo)["differ_share"])
            # the exact result truncated to bf16, not rounded
            y64 = torch.nn.functional.conv1d(
                x.double().transpose(1, 2), w.to(torch.bfloat16).double(),
                b.double(), **geo).transpose(1, 2)
            bits = y64.float().view(torch.int32) & -0x10000
            cut = bits.view(torch.float32).to(torch.bfloat16)
            truncated.append(float((cut != bf16_round_once(y64)).float()
                                   .mean()))
    assert min(truncated) > DIFFER_SHARE, truncated
    # the bias moves most of the early roundings in every layer
    assert np.median(early) > DIFFER_SHARE, early


@pytest.mark.card
@pytest.mark.parametrize("name", ["illumina_wide", "hybrid"])
def test_two_launches_give_the_same_bits(card, name):
    calls, _ = _forward(name, card)
    with torch.inference_mode():
        for m, x, y in calls:
            x, w, b, geo = _operands(m, x)
            assert torch.equal(cb.conv1d_bf16_nwc(x, w, b, **geo), y)


@pytest.mark.card
def test_every_tile_gives_the_same_bits(card):
    """A conv of the wide head in each tile (sums taken in the same order
    by every tile: the same bits)."""
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((300, 18, 256), generator=g, device=card).to(
        torch.bfloat16)
    w = torch.randn((512, 256, 3), generator=g, device=card) / 30
    b = torch.randn((512,), generator=g, device=card)
    want = cb.conv1d_bf16_nwc(x, w, b, stride=2, padding=1)
    for bm in cb.TILE_M:
        for bn in cb.TILE_N:
            got = torch.empty_like(want)
            cb.launch(x, cb.pack_weight(w), b, got, 3, stride=2, padding=1,
                      tile=(bm, bn))
            assert torch.equal(got, want), (bm, bn)


@pytest.mark.card
@pytest.mark.parametrize("ci,co,k,padding,lin", [
    (5, 16, 1, 0, 150), (6, 16, 3, 0, 150), (7, 16, 3, 0, 150),
    (16, 32, 3, 1, 71), (32, 64, 3, 1, 71), (1024, 256, 1, 0, 18)])
def test_gathered_and_short_k_convs_are_within_the_bar(card, ci, co, k,
                                                       padding, lin):
    """The shapes outside the cells' forwards: the gather of Ci 5 to 7
    (the reference-segment meta-expert, the layer-route read convolvers'
    first conv), a K of 48 and 96 (one K block part zeros), the wide
    combiner's Ci of 1,024."""
    g = torch.Generator(device=card).manual_seed(ci)
    x = (8 * torch.rand((4096, lin, ci), generator=g, device=card)).to(
        torch.bfloat16)
    w = torch.randn((co, ci, k), generator=g, device=card) / (ci * k) ** 0.5
    b = torch.randn((co,), generator=g, device=card)
    y = cb.conv1d_bf16_nwc(x, w, b, padding=padding)
    read = kernel_reading(y, x, w, b, padding=padding)
    assert read["differ_share"] <= DIFFER_SHARE, read


@pytest.mark.card
def test_grad_mode_refuses_the_kernel(card):
    conv = layers.WeightNormedConv1d(16, 16, 3, padding=1).to(card).eval()
    for p in conv.parameters():
        torch.nn.init.uniform_(p, 0.5, 1.0)
    x = torch.randn((2, 9, 16), device=card)
    with pytest.raises(RuntimeError, match="no backward"):
        conv(x)
    with torch.no_grad():
        assert conv(x).dtype == torch.bfloat16
