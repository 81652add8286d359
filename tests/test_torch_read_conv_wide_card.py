"""The wide read convolver's kernel (``csrc/read_conv_wgmma_wide.cuh``) on
the card, at the benchmark cell's production shape: 1,024 sites x 2
alleles, 20 to 60 reads per allele (``h100_bench/generator``'s batches),
packed as the coded wire ships them, and the dense grid.

* The kernel against the layer route of the same weights at ``bf16``,
  within ``pipeline/bf16_conv_check.py``'s layer bar: at most 0.2% of the
  values differ by more than 2^-6 of the largest; and against its plain
  version within a quarter of the plain version's own distance from fp32
  (chip_smoke.py's bar for the bf16 route).
* Two eager runs give identical bits; a replayed batch of the Scorer is
  bit-equal to its eager ``_forward``; the ``scorer.read_conv_layers``
  records of replays agree with eager ones; each eager batch and each
  replay launches the width-2 kernel once (the launch ledger's
  ``read_conv_reduce`` key and its ``"replayed"`` twin) between one pair of
  card stamps.

Marked ``card``: each test skips without a card.  Imports no JAX: run with
``python -m pytest --noconftest tests/test_torch_read_conv_wide_card.py``.
"""

import numpy as np
import pytest
import torch

from h100_bench import generator
from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc
from hello_tpu_torch.pipeline import graphs
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                              pack_sites_wire)

SEED = 2**31 + 23
SITES, ALLELES, READS = 1024, 2, (20, 60)
#: bf16_conv_check's layer bar: the share of values that may differ by
#: more than 2^-6 of the largest
DIFFER_SHARE, DIFFER_BY = 0.002, 2.0 ** -6


@pytest.fixture(autouse=True)
def bf16():
    layers.set_precision("bf16")
    yield
    layers.set_precision("highest")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wide read convolver's kernel")
    return torch.device("cuda", 0)


@pytest.fixture
def no_tf32():
    """cuDNN's TF32 off (the plain version's fp32 convs), restored after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


def _model(name="illumina_wide", seed=0):
    return init_params(create_model(name),
                       torch.Generator().manual_seed(seed)).eval()


def _counts(rng, alleles):
    return generator.read_counts(rng, alleles, *READS)


def _packed(card, seed=SEED, channels=6):
    """The cell's reads as the wire ships them: each allele's rows
    together, then padding rows up to the row bucket."""
    rng = np.random.default_rng(seed)
    A = SITES * ALLELES
    counts = _counts(rng, A)
    allele = np.repeat(np.arange(A, dtype=np.int32), counts)
    n_pad = (-len(allele)) % 4096
    allele = np.concatenate([allele, np.full(n_pad, A, np.int32)])
    valid = (allele < A).astype(np.float32)
    rows = rng.integers(0, 256, (len(allele), 150, channels), dtype=np.uint8)
    return [torch.from_numpy(a).to(card) for a in (rows, allele, valid)], A


def _dense(card, seed=SEED):
    """The dense [A, R] grid flattened to rows: R = 60, each allele's reads
    first, the rest masked."""
    rng = np.random.default_rng(seed)
    A, R = SITES * ALLELES, READS[1]
    counts = _counts(rng, A)
    mask = (np.arange(R)[None, :] < counts[:, None]).astype(np.float32)
    rows = rng.integers(0, 256, (A * R, 150, 6), dtype=np.uint8)
    allele = (np.arange(A * R) // R).astype(np.int32)
    return [torch.from_numpy(a).to(card)
            for a in (rows, allele, mask.reshape(-1))], A


def _layer_route(net, rows, allele, valid, A, precision="bf16"):
    layers.set_precision(precision)
    try:
        with torch.no_grad():
            frames = torch.cat([net(rows[i:i + 8192].float())
                                for i in range(0, rows.shape[0], 8192)])
        return moe.ordered_read_reduce(frames, allele, valid, A, READS[1])
    finally:
        layers.set_precision("bf16")


@pytest.mark.card
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_the_wide_kernel_matches_the_layer_route(card, layout, no_tf32):
    net = _model().net("read_conv0").to(card)
    folded = rc.fold_read_conv_weights(net)
    assert (folded.route, folded.width) == ("bf16", 2)
    (rows, allele, valid), A = (_packed if layout == "packed"
                                else _dense)(card)
    got = rc.read_conv_reduce(rows, allele, valid, folded, A)
    torch.cuda.synchronize(card)
    want = _layer_route(net, rows, allele, valid, A)
    scale = float(want.abs().max())
    diff = (got - want).abs()
    assert float((diff > DIFFER_BY * scale).float().mean()) <= DIFFER_SHARE
    # the plain version with the same fold, and fp32
    with torch.no_grad():
        plain = rc.read_conv_reduce_reference(rows, allele, valid, folded, A)
    exact = _layer_route(net, rows, allele, valid, A, "highest")
    assert float((got - plain).abs().max()) <= \
        0.25 * float((plain - exact).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_two_eager_runs_give_identical_bits(card, layout):
    folded = rc.fold_read_conv_weights(_model().net("read_conv0").to(card))
    (rows, allele, valid), A = (_packed if layout == "packed"
                                else _dense)(card, SEED + 1)
    runs = [rc.read_conv_reduce(rows, allele, valid, folded, A)
            for _ in range(3)]
    torch.cuda.synchronize(card)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    assert bool((runs[0] != 0).any())


def _wire(seed, sites=SITES):
    """One of the cell's batches, coded and packed as a host worker and the
    caller's main loop make it."""
    batch = generator.make_batch(seed, 0, sites, ALLELES, [list(READS)])
    return pack_sites_wire(encode_chunk_sites(generator.port_sites(batch)),
                           hybrid=False)


def _host(out):
    if isinstance(out, dict):
        return {k: np.array(v) for k, v in out.items()}
    return tuple(None if v is None else np.array(v) for v in out)


def _eager(scorer, wire, card):
    with torch.inference_mode():
        out = scorer._forward(scorer._refresh(0),
                              scorer._upload(wire.wire, card), True)
    torch.cuda.synchronize(card)
    out = {k: v.cpu() for k, v in out.items() if k != "read_conv_stamps"}
    return _host(Scorer._host_form(out))


@pytest.mark.card
def test_a_replayed_batch_is_bit_equal_to_eager(card):
    scorer = Scorer(_model(), device=card)
    assert scorer.folded["read_conv0"].width == 2
    wires = [_wire(SEED + k) for k in (1, 2, 3, 1)]
    want = [_eager(scorer, w, card) for w in wires]
    got = [_host(scorer.finalize(scorer.score_async(w, decode=True)))
           for w in wires]
    assert scorer.graph_counts == {"eager": 1, "captured": 1, "replayed": 2}
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


#: card cycles of the spin queued ahead of each batch whose stamps are read
#: (some 50 ms at the H100's clock)
HOLD_CYCLES = 100_000_000


def _layer_records(scorer, wires):
    """Each batch's ``scorer.read_conv_layers`` record in ms, in order; the
    card spins ahead of each batch while the host enqueues it, so the
    stamps bracket the card's work alone."""
    t0 = telemetry.now_ns()
    first = scorer._next
    for w in wires:
        torch.cuda._sleep(HOLD_CYCLES)
        scorer.finalize(scorer.score_async(w, decode=True))
    got = {s.key: (s.end_ns - s.start_ns) / 1e6
           for s in telemetry.spans(t0, telemetry.now_ns())
           if s.name == "scorer.read_conv_layers"}
    return [got[first + k] for k in range(len(wires))]


@pytest.mark.card
def test_replayed_read_conv_layers_records_agree_with_eager_ones(
        card, monkeypatch):
    wires = [_wire(SEED + k, 256) for k in range(7)]
    replaying = Scorer(_model(), device=card)
    got = _layer_records(replaying, wires)
    assert replaying.graph_counts == {"eager": 1, "captured": 1,
                                      "replayed": 5}
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 0)      # every batch eager
    eager_scorer = Scorer(_model(), device=card)
    eager = _layer_records(eager_scorer, wires)[1:]
    assert all(ms > 0 for ms in got + eager)
    lo, hi = min(eager), max(eager)
    pad = max(hi - lo, 0.1 * float(np.median(eager)))
    assert lo - pad <= float(np.median(got[2:])) <= hi + pad, (eager, got)


@pytest.mark.card
def test_each_batch_and_replay_launches_the_wide_kernel_once(card):
    from torch.profiler import ProfilerActivity, profile

    scorer = Scorer(_model(), device=card)
    wire = _wire(SEED + 4, 64)
    # the eval convs outside the read convolver run the conv kernel: the
    # compressor's twice (its allele and site passes), the head's once
    convs = {net: sum(isinstance(m, layers._ConvBase)
                      for m in scorer.model.net(net).modules())
             for net in ("compressor0", "xattn0")}
    once = {("read_conv_reduce", "bf16", 2): 1, ("card_stamp",): 2,
            ("read_conv", "read_conv0", "bf16"): 1,
            ("conv_bf16",): 2 * convs["compressor0"] + convs["xattn0"]}
    before = telemetry.counts()
    scorer.finalize(scorer.score_async(wire, decode=True))      # eager
    assert telemetry.counts() - before == once
    before = telemetry.counts()
    scorer.finalize(scorer.score_async(wire, decode=True))      # capture
    assert telemetry.counts() - before == once
    before = telemetry.counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            scorer.finalize(scorer.score_async(wire, decode=True))
        torch.cuda.synchronize(card)
    assert scorer.graph_counts == {"eager": 1, "captured": 1, "replayed": 2}
    # the wrappers count nothing for a replay; the layer route never runs
    assert telemetry.counts() - before == {
        ("replayed",) + k: 2 * n for k, n in once.items()}
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("read_conv_reduce_wide" in n for n in kernels) == 2, kernels
    assert sum("card_stamp_kernel" in n for n in kernels) == 4, kernels
