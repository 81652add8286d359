"""The wide read convolver's kernel route (``csrc/read_conv_wgmma_wide.cuh``)
on the CPU.

* The fold: at ``bf16`` the wide read convolvers (``illumina_wide``'s and
  both of ``hybrid_no_ensemble_wide``'s) fold to the width-2 kernel, in the
  width-1 fold's layout at twice the width; at ``highest``, ``high`` and
  ``default`` they take the layer route, and folding them for a TF32 route
  raises.  The addendum and layer_norm read convolvers take the layer route
  at every precision; the width-1 folds keep their route and their buffer.
* The plain version with the width-2 fold (``read_conv_reduce_reference``,
  the bf16 route's rounding points) against the layer route's eval forward
  of the same weights at bf16, packed and dense, at C = 6 and 7: the mean
  distance within a quarter of the layer route's own mean bf16-against-fp32
  distance (tests/test_torch_precision.py's bar, on the mean); a plain
  version with fp32 activations, or with bf16 rounding that truncates,
  fails that bar.  Its per-allele sum is ``ordered_read_reduce``'s; every
  conv it runs is read by the F3 tool.
* The launch ledger keeps the widths apart; the stamp rule: every read
  convolver the width-1 kernel does not implement is stamped, the wide
  kernel's too, and CPU batches carry no stamps.

Imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import archs, layers, moe
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import read_conv as rc
from hello_tpu_torch.pipeline import bf16_conv_check as check
from hello_tpu_torch.pipeline import graphs
from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                              pack_sites_wire)

WIDE = ("illumina_wide", "hybrid_no_ensemble_wide")
OTHER = ("illumina_addendum", "illumina_layer_norm")
#: the read convolvers' bf16 plain version against the layer route at bf16:
#: at most this share of the layer route's own bf16-against-fp32 distance
#: (tests/test_torch_precision.py's BAR), both as means over the output
BAR = 0.25


@pytest.fixture(autouse=True)
def highest():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    layers.set_precision("highest")
    yield
    layers.set_precision("highest")
    torch.set_num_threads(threads)


def _model(name, seed=0):
    return init_params(create_model(name),
                       torch.Generator().manual_seed(seed)).eval()


def _wide_c7(seed=1):
    """A wide read convolver over 7 input channels (the haplotag
    channel): no named config has one, but the kernel takes it."""
    net = layers.build_network(archs.read_convolver(
        weight_norm=True, in_channels=7, width=2))
    return init_params(net, torch.Generator().manual_seed(seed)).eval()


# ---------------------------------------------------------------- the fold


@pytest.mark.parametrize("name", WIDE)
def test_bf16_folds_the_wide_read_convolvers_to_the_width2_kernel(name):
    layers.set_precision("bf16")
    model = _model(name)
    folded = model.fold_read_convs()
    assert len(folded) == (2 if model.hybrid else 1)
    for k, f in folded.items():
        assert isinstance(f, rc.FoldedReadConv), k
        assert (f.route, f.width, f.in_channels) == ("bf16", 2, 6)
        assert f.flat.numel() == rc.num_weight_floats(6, "bf16", 2)
        # the width-1 fold's layout at twice the width: per conv the bf16
        # image, then the bias
        want = torch.cat([t for w, b in f.convs
                          for t in (rc.pack_conv(w, "bf16"), b)])
        assert torch.equal(f.flat, want)
        assert [tuple(w.shape) for w, _ in f.convs] == rc.conv_shapes(6, 2)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("name", WIDE)
def test_wide_read_convolvers_take_the_layer_route_outside_bf16(name,
                                                                 precision):
    layers.set_precision(precision)
    model = create_model(name)
    assert all(isinstance(f, moe.LayerRoute)
               for f in model.fold_read_convs().values())
    net = model.net("read_conv0")
    assert rc.read_convolver_width(net) == 2
    assert not rc.supports_read_convolver(net)
    assert rc.supports_read_convolver(net, "bf16")
    with pytest.raises(ValueError, match="no kernel route"):
        rc.fold_read_conv_weights(net)


@pytest.mark.parametrize("precision", ["highest", "default", "bf16"])
@pytest.mark.parametrize("name", OTHER)
def test_addendum_and_layer_norm_take_the_layer_route(name, precision):
    layers.set_precision(precision)
    model = create_model(name)
    assert isinstance(model.fold_read_convs()["read_conv0"], moe.LayerRoute)
    with pytest.raises(ValueError, match="item 14"):
        rc.check_read_convolver(model.net("read_conv0"), "bf16")


@pytest.mark.parametrize("precision", ["highest", "high", "default", "bf16"])
@pytest.mark.parametrize("name", ["illumina", "hybrid", "pacbio_hp"])
def test_width1_folds_keep_their_route_and_buffer(name, precision):
    layers.set_precision(precision)
    model = _model(name)
    route = rc.route_for_precision(precision)
    for k, f in model.fold_read_convs().items():
        net = model.net(k)
        assert (f.route, f.width) == (route, 1)
        assert f.flat.numel() == rc.num_weight_floats(f.in_channels, route)
        assert torch.equal(f.flat, rc.fold_read_conv_weights(net, route).flat)


def test_the_gate_names_what_is_still_missing():
    assert "addendum and layer_norm" in rc.ROADMAP_VARIANTS
    assert "TF32" in rc.ROADMAP_VARIANTS
    with pytest.raises(ValueError, match="width-2 read convolver has no "
                                         "kernel route 'tf32'"):
        rc.check_read_convolver(create_model("illumina_wide").net(
            "read_conv0"), "tf32")


def test_kernel_argument_checks_hold_the_width():
    layers.set_precision("bf16")
    f = create_model("illumina_wide").fold_read_convs()["read_conv0"]
    rows = torch.zeros((3, 150, 6), dtype=torch.uint8)
    args = dict(rows=rows, row_allele=torch.zeros(3, dtype=torch.int32),
                row_valid=torch.ones(3), folded=f, num_alleles=1)
    rc._check_cuda_args(**args)
    narrow = create_model("illumina").fold_read_convs()["read_conv0"]
    for bad in (rc.FoldedReadConv(f.convs, narrow.flat, 6, "bf16", width=2),
                rc.FoldedReadConv(f.convs, f.flat, 6, "tf32x3", width=2)):
        with pytest.raises(ValueError):
            rc._check_cuda_args(**dict(args, folded=bad))


# ---------------------------------------------------------- the plain version


def _packed(rng, counts, channels, n_pad):
    A = len(counts)
    allele = np.repeat(np.arange(A, dtype=np.int32), counts)
    valid = np.ones(len(allele), np.float32)
    valid[1] = 0.0                                 # a masked row
    allele = np.concatenate([allele, np.full(n_pad, A, np.int32)])
    valid = np.concatenate([valid, np.zeros(n_pad, np.float32)])
    rows = rng.randint(0, 256, (len(allele), 150, channels), dtype=np.uint8)
    return [torch.from_numpy(a) for a in (rows, allele, valid)], A


def _dense(rng, A, R, channels):
    rows = rng.randint(0, 256, (A * R, 150, channels), dtype=np.uint8)
    allele = (np.arange(A * R) // R).astype(np.int32)
    valid = (rng.rand(A * R) < 0.7).astype(np.float32)
    return [torch.from_numpy(a) for a in (rows, allele, valid)], A


def _layer_route(net, rows, allele, valid, A, precision):
    layers.set_precision(precision)
    try:
        with torch.no_grad():
            frames = net(rows.float())
        R = int(torch.bincount(allele.long(), minlength=A + 1)[:A].max())
        return moe.ordered_read_reduce(frames, allele, valid, A, R)
    finally:
        layers.set_precision("highest")


def _plain_against_layer_route(case):
    """(the plain version's answer, the layer route's at bf16 and at
    highest, the rows' alleles and validities) for ``case``."""
    rng = np.random.RandomState(3)
    net = (_wide_c7() if case.endswith("c7")
           else _model("illumina_wide").net("read_conv0"))
    channels = 7 if case.endswith("c7") else 6
    (rows, allele, valid), A = (
        _dense(rng, 3, 4, channels) if case.startswith("dense")
        else _packed(rng, [3, 1, 4, 0, 2], channels, 2))
    f = rc.fold_read_conv_weights(net, "bf16")
    assert (f.width, f.in_channels) == (2, channels)
    got = rc.read_conv_reduce(rows, allele, valid, f, A)
    assert got.shape == (A, rc.L_OUT, 128) and got.dtype == torch.float32
    want_bf16 = _layer_route(net, rows, allele, valid, A, "bf16")
    want_hi = _layer_route(net, rows, allele, valid, A, "highest")
    return got, want_bf16, want_hi, allele, valid


def _distances(got, want_bf16, want_hi):
    """(mean |got - bf16|, mean |bf16 - highest|)."""
    return (float((got - want_bf16).abs().mean()),
            float((want_bf16 - want_hi).abs().mean()))


CASES = ["packed_c6", "dense_c6", "packed_c7"]


@pytest.mark.parametrize("case", CASES)
def test_wide_plain_version_matches_the_layer_route_at_bf16(case):
    """The bar is on the mean: the plain version and the layer route take
    their fp32 sums in different orders on the CPU (the plain version's
    weight is a permuted view, the layer's own is contiguous), so about 1%
    of the outputs come from a sum that the two round to neighbouring bf16
    values, and that one-ulp step moves the later convs of its row.  The
    largest such difference is a third to a half of bf16's largest distance
    from fp32 here, at width 1 too (up to 0.4 over four seeds of on-grid
    weights), while the mean is about a hundredth of bf16's."""
    got, want_bf16, want_hi, allele, valid = _plain_against_layer_route(case)
    port, ref = _distances(got, want_bf16, want_hi)
    assert ref > 0
    assert port <= BAR * ref, (port, ref)
    # alleles with no computed row are exactly zero
    empty = [a for a in range(got.shape[0]) if not bool(
        ((allele == a) & (valid > 0)).any())]
    assert all(not got[a].any() for a in empty)


def _truncated(t):
    """bf16 rounding toward zero: the fp32 value with its low 16 bits
    cleared."""
    return (t.float().contiguous().view(torch.int32) & -65536).view(
        torch.float32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fault", ["fp32_activations", "truncated_rounding"])
def test_a_plain_version_that_rounds_elsewhere_fails_the_bar(
        case, fault, monkeypatch):
    """The bar above tells rounding points apart: a plain version that
    skips every rounding point (reads 0.66 to 0.72 of bf16's distance) or
    rounds toward zero (6.5 to 7.5) fails it."""
    monkeypatch.setattr(rc, "bf16_round", (lambda t: t)
                        if fault == "fp32_activations" else _truncated)
    port, ref = _distances(*_plain_against_layer_route(case)[:3])
    assert port > 2 * BAR * ref, (port, ref)


def test_wide_plain_sum_is_the_ordered_read_reduce():
    rng = np.random.RandomState(4)
    (rows, allele, valid), A = _packed(rng, [2, 5, 1, 3], 6, 3)
    layers.set_precision("bf16")
    f = _model("illumina_wide").fold_read_convs()["read_conv0"]
    frames = rc.read_convolver_reference(rows, f)
    assert frames.shape == (rows.shape[0], rc.L_OUT, 128)
    got = rc.read_conv_reduce_reference(rows, allele, valid, f, A)
    want = moe.ordered_read_reduce(frames, allele, valid, A, 5)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_every_conv_of_the_wide_plain_version_is_read_against_float64():
    """The F3 tool's per-conv reading sees the 18 convs of the kernel's plain
    version besides every conv layer the forward runs."""
    layers.set_precision("bf16")
    model = _model("illumina_wide")
    assert model.fold_read_convs()["read_conv0"].width == 2
    convs = []
    handles = [m.register_forward_hook(lambda *a: convs.append(1))
               for m in model.modules() if isinstance(m, layers._ConvBase)]
    rng = np.random.RandomState(0)
    sites = [SiteWork("chr1", 50 * i, 50 * i + 1, ["A", "T"],
                      [rng.randint(0, 255, (4, 150, 6)).astype(np.uint8),
                       rng.randint(0, 255, (2, 150, 6)).astype(np.uint8)],
                      None, np.eye(5, dtype=np.float32)[
                          rng.randint(0, 5, 150)]) for i in range(3)]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             pack_sites(sites, hybrid=False).device_dict().items()}
    errors = []
    with check.conv_errors_against_float64(errors), torch.inference_mode():
        model(batch)
    for h in handles:
        h.remove()
    # the read convolver's conv modules do not run; its 18 folded convs do
    assert len(errors) == len(convs) + rc.NUM_CONVS
    assert 0 < max(errors) < 2.0 ** -20


# --------------------------------------------------------- ledger and stamps


def test_the_counters_keep_the_widths_apart():
    before = telemetry.counts()
    telemetry.count(("read_conv_reduce", "bf16", 1), 5)
    telemetry.count(("read_conv_reduce", "bf16", 2), 7)
    assert rc.route_launches(before) == {"tf32x3": 0, "tf32": 0, "bf16": 12}
    assert telemetry.counts() - before == {
        ("read_conv_reduce", "bf16", 1): 5, ("read_conv_reduce", "bf16", 2): 7}
    # a replay adds what its capture launched, width by width
    layers.set_precision("bf16")
    scorer = Scorer(_model("illumina_wide"), device="cpu")

    class _Replay:
        def replay(self):
            pass

    graph = graphs.Graph("k")
    graph.graph, graph.outputs = _Replay(), {"experts": torch.zeros(1)}
    graph.counts = {("read_conv_reduce", "bf16", 2): 1}
    before = telemetry.counts()
    for seq in range(3):
        scorer._launch(0, None, None, True, graph, seq)
    assert telemetry.counts() - before == {
        ("replayed", "read_conv_reduce", "bf16", 2): 3}
    assert rc.route_launches(before) == {"tf32x3": 0, "tf32": 0, "bf16": 0}


def _stamp_calls(model, folded, monkeypatch):
    """The stamps ``forward`` would write on the card, on the CPU: the rows
    of ``stamps`` each call would stamp."""
    calls = []
    monkeypatch.setattr(moe, "card_stamp", lambda t: calls.append(t))
    rng = np.random.RandomState(1)
    sites = [SiteWork("chr1", 50 * i, 50 * i + 1, ["A", "T"],
                      [rng.randint(0, 255, (3, 150, 6)).astype(np.uint8)
                       for _ in range(2)],
                      [rng.randint(0, 255, (2, 150, 6)).astype(np.uint8)
                       for _ in range(2)] if model.hybrid else None,
                      np.eye(5, dtype=np.float32)[rng.randint(0, 5, 150)])
             for i in range(2)]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             pack_sites(sites, hybrid=model.hybrid).device_dict().items()}
    stamps = torch.zeros((len(folded), 2), dtype=torch.int64)
    with torch.no_grad():
        model(batch, folded=folded, stamps=stamps)
    return len(calls)


@pytest.mark.parametrize("name, stamps", [
    ("illumina_wide", 2), ("hybrid_no_ensemble_wide", 4), ("illumina", 0),
    ("hybrid", 0), ("illumina_layer_norm", 2)])
def test_each_read_convolver_outside_the_width1_kernel_is_stamped(
        name, stamps, monkeypatch):
    layers.set_precision("bf16")
    model = _model(name)
    folded = model.fold_read_convs()
    assert all(moe.stamped(f) == (not isinstance(f, rc.FoldedReadConv)
                                  or f.width == 2) for f in folded.values())
    assert _stamp_calls(model, folded, monkeypatch) == stamps


def test_cpu_batches_of_the_wide_kernel_carry_no_stamps():
    layers.set_precision("bf16")
    scorer = Scorer(_model("illumina_wide"), device="cpu", packed_conv=True)
    assert scorer.read_conv_routes() == {"read_conv0": "bf16"}
    assert scorer.folded["read_conv0"].width == 2
    from hello_tpu_torch.bench import build_workload
    sites = build_workload(np.random.RandomState(2), 3, 2, 3, 0)
    sites = [s.__class__(**{**s.__dict__, "tensors1": None}) for s in sites]
    wire = pack_sites_wire(encode_chunk_sites(sites), hybrid=False)
    t0 = telemetry.now_ns()
    before = telemetry.counts()
    got = scorer.score_async(wire, decode=True)
    assert "read_conv_stamps" not in got.out
    scorer.finalize(got)
    # the plain version of the wide kernel's route: no launch, no stamp
    assert telemetry.counts() - before == {
        ("read_conv", "read_conv0", "bf16"): 1}
    names = {s.name for s in telemetry.spans(t0, telemetry.now_ns())}
    assert "scorer.launch" in names
    assert "scorer.read_conv_layers" not in names


@pytest.mark.parametrize("name", sorted(
    __import__("hello_tpu_torch.ops.read_conv_variants",
               fromlist=["WIDE_VARIANTS"]).WIDE_VARIANTS))
def test_wide_variant_substitutions_apply_to_the_wide_header(name):
    """read_conv_variants' edits of the wide kernel find their text in its
    header and change nothing else (``base`` nothing at all)."""
    from hello_tpu_torch.ops import read_conv_variants as rv

    texts = rv.variant_sources(name, "wide")
    base = rv.variant_sources("base", "wide")
    changed = {f for f in texts if texts[f] != base[f]}
    assert changed == ({rv.WIDE_SOURCE} if rv.WIDE_VARIANTS[name][1]
                       else set())
    assert set(texts) == {os.path.basename(p)
                          for p in rc.source_files(rc.SOURCE)}
