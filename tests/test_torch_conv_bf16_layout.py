"""The eval bf16 conv kernel's addressing and route, run on the CPU.

``csrc/conv_bf16.cu`` runs only on the card.  Its addressing is stated once
more in numpy (``hello_tpu_torch.ops.conv_bf16_layout``): each thread's A
row and K chunks (tap, channel, zero fill at the input's ends, past M and
past K; the gather where Ci is not a multiple of 8), the weight as
``conv_bf16.pack_weight`` lays it out, the stages' [K / 8][rows][8] bf16
images read back through the wgmma descriptors, and the fragment's stores.
Here that model runs the kernel's whole schedule, in the tile
``conv_bf16.tile_for`` picks, for every distinct conv shape (Ci, Co, K,
stride, padding and input length) that the eleven named configs build, and
must give what ``nn/layers.conv1d_bf16`` gives at bf16, bit for bit.  The
operands are multiples of 1/8 and 1/16 of at most 1, so every fp32 sum is
exact in any order and the one rounding to bf16 is the only one.

The route: eval-mode convs at bf16 on CUDA tensors take the kernel; train
mode, the fp32 precisions and the CPU never do.
"""

import numpy as np
import pytest
import torch

from hello_tpu_torch.nn import archs
from hello_tpu_torch.nn import layers as L
from hello_tpu_torch.ops import conv_bf16 as cb
from hello_tpu_torch.ops import conv_bf16_layout as lay

#: each network's input length (the meta-expert's: its site frames, or the
#: reference segment that a 5-channel first conv reads)
NET_LENGTH = {"read_conv0": 150, "read_conv1": 150, "compressor0": 36,
              "compressor1": 36, "compressor2": 36, "xattn0": 18,
              "xattn1": 18, "xattn2": 18, "combiner0": 18, "combiner1": 18,
              "meta": 18}


def _walk(specs, length, out):
    """Append (Ci, Co, K, stride, padding, input length) of each conv of
    ``specs`` to ``out``; return the length after them."""
    for spec in specs:
        kind, kw = spec["type"], spec.get("kwargs") or {}
        if kind in ("Conv1d", "WeightNormedConv1d"):
            k, s, p = kw["kernel_size"], kw.get("stride", 1), kw.get(
                "padding", 0)
            out.add((kw["in_channels"], kw["out_channels"], k, s, p, length))
            length = cb.out_length(length, k, s, p, kw.get("dilation", 1))
        elif kind == "MaxPool1d":
            length = cb.out_length(length, kw["kernel_size"], kw["stride"],
                                   kw.get("padding", 0))
        elif kind == "ResidualBlock":
            _walk(kw["shortcut"], length, out)
            length = _walk(kw["feedforward"], length, out)
    return length


def conv_shapes():
    shapes = set()
    for make in archs.NAMED_CONFIGS.values():
        for net, specs in make().items():
            first = next(s for s in specs if "Conv" in s["type"])
            length = (150 if first["kwargs"]["in_channels"] == 5
                      else NET_LENGTH[net])
            _walk(specs, length, shapes)
    return sorted(shapes)


SHAPES = conv_shapes()


def test_the_configs_build_the_shapes_the_kernel_takes():
    assert len(SHAPES) > 30
    for ci, co, k, s, p, lin in SHAPES:
        cb.check_shape(ci, co, k, s, p, 1, 1)
    assert {ci for ci, *_ in SHAPES} >= {5, 6, 7, 16, 1024}
    assert {(k, s, p) for _, _, k, s, p, _ in SHAPES} >= {
        (1, 1, 0), (1, 2, 0), (3, 1, 0), (3, 1, 1), (3, 2, 1)}


def _exact_operands(ci, co, k, lin, n, seed):
    """x (bf16, multiples of 1/8 in [-1, 1]), w (multiples of 1/16 in
    [-1/2, 1/2]) and b (multiples of 1/128 in [-4, 4]): products are
    multiples of 1/128 and every fp32 sum of them is exact."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randint(-8, 9, (n, lin, ci), generator=g) / 8.0).to(
        torch.bfloat16)
    w = torch.randint(-8, 9, (co, ci, k), generator=g) / 16.0
    b = torch.randint(-512, 513, (co,), generator=g) / 128.0
    return x, w, b


@pytest.mark.parametrize(
    "ci,co,k,stride,padding,lin", SHAPES,
    ids=[f"ci{c}_co{o}_k{k}_s{s}_p{p}_L{n}" for c, o, k, s, p, n in SHAPES])
def test_the_kernel_schedule_is_conv1d_bf16(ci, co, k, stride, padding, lin):
    n = 3
    x, w, b = _exact_operands(ci, co, k, lin, n, seed=ci * 7 + co + k + lin)
    got = lay.run(x, w, b, stride, padding)
    want = L.conv1d_bf16(x.float().transpose(1, 2),
                         w.to(torch.bfloat16).float(), b, stride=stride,
                         padding=padding).to(torch.bfloat16).transpose(1, 2)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.contiguous().view(
        torch.int16))


@pytest.mark.parametrize("tile", [(64, 16), (64, 128), (128, 32),
                                  (128, 128)])
def test_every_tile_gives_the_same_bits(tile):
    """One shape in tiles wider and narrower than its Co (rows and columns
    past M and Co masked), a ragged last K block and the gather (Ci 6)."""
    for ci, co, k, stride, padding in ((64, 128, 3, 2, 1), (6, 32, 3, 1, 0)):
        x, w, b = _exact_operands(ci, co, k, 29, 5, seed=tile[1])
        want = lay.run(x, w, b, stride, padding)
        got = lay.run(x, w, b, stride, padding, tile=tile)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_the_sum_is_rounded_once_after_the_bias():
    """Rounding the sum to bf16 before adding the bias (what a bf16 conv
    with a bias epilogue does) gives other bits on these operands."""
    x, w, b = _exact_operands(64, 64, 3, 36, 4, seed=3)
    want = lay.run(x, w, b, 1, 1)
    twice = (L.conv1d_bf16(x.float().transpose(1, 2),
                           w.to(torch.bfloat16).float(), None, padding=1)
             .to(torch.bfloat16).float() + b[None, :, None]).to(
                 torch.bfloat16).transpose(1, 2)
    assert not torch.equal(want.view(torch.int16),
                           twice.contiguous().view(torch.int16))


def test_pack_weight_is_tap_major_bf16():
    w = torch.randn(16, 5, 3)
    packed = cb.pack_weight(w)
    assert packed.dtype == torch.bfloat16 and packed.shape == (16, 15)
    for t in range(3):
        assert torch.equal(packed[:, t * 5:(t + 1) * 5],
                           w[:, :, t].to(torch.bfloat16))


def test_the_tile_follows_co_and_the_positions():
    assert cb.tile_for(36_864, 512) == (128, 128)
    assert cb.tile_for(36_864, 64) == (128, 64)
    assert cb.tile_for(300, 16) == (64, 16)
    assert cb.tile_for(1_000, 1024) == (64, 128)
    for bm, bn in {cb.tile_for(n * cb.out_length(lin, k, s, p), co)
                   for _, co, k, s, p, lin in SHAPES for n in (1, 2048)}:
        assert bm in cb.TILE_M and bn in cb.TILE_N
        assert cb.smem_bytes(bm, bn) <= 232_448


@pytest.mark.parametrize("bad", [dict(groups=2), dict(co=12), dict(k=0)])
def test_shapes_the_kernel_does_not_take_raise(bad):
    args = dict(ci=16, co=16, k=3, stride=1, padding=1, dilation=1, groups=1)
    args.update(bad)
    with pytest.raises(ValueError):
        cb.check_shape(**args)


def test_the_wrapper_refuses_a_cpu_tensor():
    """The CPU keeps conv1d_bf16: the kernel's wrapper has no CPU version."""
    x, w, b = _exact_operands(16, 16, 3, 9, 2, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv1d_bf16_nwc(x, w, b, padding=1)


@pytest.mark.parametrize("precision", L.PRECISIONS)
@pytest.mark.parametrize("training", [False, True])
def test_only_eval_bf16_on_the_card_takes_the_kernel(precision, training):
    L.set_precision(precision)
    try:
        dtype = L.ACT_DTYPE or torch.float32
        for device in ("cpu", "cuda", "meta"):
            want = (not training and precision == "bf16"
                    and device == "cuda")
            assert L.takes_conv_kernel(training, dtype, device) == want
    finally:
        L.set_precision("highest")


@pytest.mark.parametrize("precision", L.PRECISIONS)
@pytest.mark.parametrize("training", [False, True])
def test_cpu_convs_never_launch_the_kernel(precision, training, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(cb, "conv1d_bf16_nwc", refuse)
    conv = L.WeightNormedConv1d(16, 32, 3, padding=1)
    torch.nn.init.normal_(conv.conv1d.weight_v)
    torch.nn.init.ones_(conv.conv1d.weight_g)
    torch.nn.init.zeros_(conv.conv1d.bias)
    conv.train(training)
    L.set_precision(precision)
    try:
        y = conv(torch.randn(2, 10, 16))
    finally:
        L.set_precision("highest")
    assert y.shape == (2, 10, 32)
    assert y.dtype == (torch.bfloat16 if precision == "bf16"
                       else torch.float32)
