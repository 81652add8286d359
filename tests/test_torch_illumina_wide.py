"""``illumina_wide`` through the Scorer on the CPU: the single-tech model at
2x width, whose read convolver takes the layer route.

* The Scorer's decoded answers at ``highest``, on packed rows of the coded
  wire and on the dense batch, against the benchmark's plain fp32
  reference (``h100_bench/reference/model.py``: its forward and
  ``best_pairs``) on the benchmark's seeded weights and sites.
* The launch ledger counts the rows each eager batch computed, padding
  included; the CPU never replays, so no ``"replayed"`` key moves (the card
  tests hold the replays).
* The layer route's per-allele sum over packed rows is the same function
  as ``packed_read_reduce`` and gives the same bits whatever the order of
  the rows of different alleles.
* CPU batches carry no stamps of the card's clock and record no
  ``scorer.read_conv_layers``; ``telemetry.stamped_ns`` and
  ``record_stamps`` turn a batch's stamps into its record.

Imports no JAX.
"""

import numpy as np
import pytest
import torch

from h100_bench import generator, weights
from h100_bench.loops import score as bench_score
from h100_bench.reference import model as ref
from hello_tpu_torch import telemetry
from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn.moe import (create_model, ordered_read_reduce,
                                    packed_read_reduce)
from hello_tpu_torch.pipeline.batching import pack_sites
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                              pack_sites_wire)

SEED = 2**31 + 2024
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def highest():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    layers.set_precision("highest")
    yield
    layers.set_precision("highest")
    torch.set_num_threads(threads)


def _setup(seed=SEED):
    """The reference's config and weights, the port's Scorer-ready model on
    them, and one batch of 8 sites x 2 alleles, 2 to 5 reads per allele."""
    net = ref.config("illumina_wide")
    params = weights.make_state_dict(ref.param_shapes(net), seed, CPU)
    model = create_model("illumina_wide")
    model.load_state_dict(params, strict=True)
    batch = generator.make_batch(seed, 0, 8, 2, [[2, 5]])
    return net, params, model, batch


def _inputs(batch, wire):
    sites = generator.port_sites(batch)
    if wire == "packed":
        return pack_sites_wire(encode_chunk_sites(sites), hybrid=False)
    return pack_sites(sites, hybrid=False)


@pytest.mark.parametrize("wire", ["packed", "dense"])
def test_decoded_answers_match_the_plain_reference(wire):
    net, params, model, batch = _setup()
    scorer = Scorer(model, device="cpu", packed_conv=wire == "packed")
    assert scorer.read_conv_routes() == {"read_conv0": "layers"}
    answer = scorer.finalize(scorer.score_async(_inputs(batch, wire),
                                                decode=True))
    terms = bench_score.reference_answers(net, params, batch, CPU)
    gap, dist = bench_score.gaps(answer, *terms, batch["num_sites"])
    assert np.asarray(answer["valid"])[:batch["num_sites"]].all()
    # both sides compute in fp32 with the sums in other orders (the port's
    # fixed-order per-allele sum, the reference's float64 one), so a
    # probability moves by float32 rounding through 6.1 M parameters: at
    # most 1.1e-7 over four seeds and both wires, and 1e-6 leaves nine
    # times that (bf16 arithmetic moves it by about 1e-3).  A site's pair
    # differs from the reference's best only where two pairs lie within
    # that rounding, and then loses no more than it: the gap is held to
    # the same 1e-6.
    assert float(dist.max()) <= 1e-6
    assert float(gap.max()) <= 1e-6


@pytest.mark.parametrize("wire", ["packed", "dense"])
def test_layer_route_rows_count_the_eager_rows(wire):
    _, _, model, batch = _setup()
    scorer = Scorer(model, device="cpu", packed_conv=wire == "packed")
    inputs = _inputs(batch, wire)
    before = telemetry.counts()
    for _ in range(3):
        scorer.finalize(scorer.score_async(inputs, decode=True))
    if wire == "packed":
        rows = inputs.wire["codes0"].shape[0]      # the row bucket's rows
        assert rows > sum(batch["platforms"][0]["counts"])     # padding
    else:
        A, R = inputs.device_dict()["read_mask0"].shape
        rows = A * R                               # the dense A*R grid
    assert telemetry.counts() - before == {
        ("read_conv", "read_conv0", "layers"): 3,
        ("layer_rows", "read_conv0"): 3 * rows}
    assert scorer.graph_counts == {"eager": 3, "captured": 0, "replayed": 0}


def test_ordered_sum_is_the_segment_sum_in_a_fixed_order():
    g = torch.Generator().manual_seed(5)
    A, R = 9, 6
    counts = torch.randint(0, R + 1, (A,), generator=g)
    allele = torch.repeat_interleave(torch.arange(A), counts)
    allele = torch.cat([allele, torch.full((5,), A)]).int()   # padding rows
    valid = (allele < A).float()
    frames = torch.randn(allele.shape[0], 4, 3, generator=g)
    want = packed_read_reduce(frames, allele, valid, A)
    got = ordered_read_reduce(frames, allele, valid, A, R)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # rows of different alleles in another order, each allele's own rows
    # in theirs: the same bits
    shuffled = torch.randperm(A + 1, generator=g)
    order = torch.argsort(shuffled[allele.long()] * len(allele)
                          + torch.arange(len(allele)))
    assert not torch.equal(allele[order], allele)
    again = ordered_read_reduce(frames[order], allele[order], valid[order],
                                A, R)
    assert torch.equal(again, got)
    # a row marked invalid adds nothing, whatever its allele
    valid2 = valid.clone()
    valid2[0] = 0.0
    dropped = ordered_read_reduce(frames, allele, valid2, A, R)
    torch.testing.assert_close(
        dropped, packed_read_reduce(frames, allele, valid2, A), rtol=1e-6,
        atol=1e-6)


def test_cpu_batches_carry_no_stamps():
    _, _, model, batch = _setup()
    scorer = Scorer(model, device="cpu", packed_conv=True)
    t0 = telemetry.now_ns()
    got = scorer.score_async(_inputs(batch, "packed"), decode=True)
    assert "read_conv_stamps" not in got.out
    scorer.finalize(got)
    names = {s.name for s in telemetry.spans(t0, telemetry.now_ns())}
    assert "scorer.launch" in names
    assert "scorer.read_conv_layers" not in names


def test_stamps_become_one_record_of_the_stamped_pairs():
    # two read convolvers' (start, end) of the card's clock, in ns
    stamps = np.array([[1_000, 151_000], [200_000, 230_000]], np.int64)
    assert telemetry.stamped_ns(stamps) == 180_000
    # a row left 0 (a read convolver on the kernel route) is not stamped
    assert telemetry.stamped_ns(np.array([[0, 0], [5, 25]])) == 20
    assert telemetry.stamped_ns(torch.zeros((2, 2), dtype=torch.int64)) \
        is None
    start = 10**18 + 7 * 10**15          # a window of this test's own
    telemetry.record_stamps("scorer.read_conv_layers", stamps, start, key=41)
    telemetry.record_stamps("scorer.read_conv_layers",
                            np.zeros((1, 2), np.int64), start + 1, key=42)
    got = [s for s in telemetry.spans(start, start + 10**9)
           if s.name == "scorer.read_conv_layers"]
    assert len(got) == 1
    assert (got[0].start_ns, got[0].end_ns, got[0].key) == (
        start, start + 180_000, 41)
    assert telemetry.mean_ms("scorer.read_conv_layers", start,
                             start + 10**9) == pytest.approx(0.18)
