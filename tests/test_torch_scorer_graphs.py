"""The Scorer's captured CUDA graphs (``pipeline/graphs.py``).

On the CPU: the Scorer never captures and counts every batch ``eager``;
``graph_key`` separates every property a captured forward depends on;
``GraphCache`` runs a key eagerly, then captures, then replays, drops its
graphs with a new generation, and once it holds ``MAX_GRAPHS`` runs new
keys eagerly, evicting none and keeping no sighting; a replay adds what its
capture launched to the Scorer's replayed counts and leaves the wrappers'
counters alone.

On the card (marked ``card``; each skips without one): for ``hybrid``,
``illumina``, ``illumina_wide`` (pinned to the layer route, whose per-allele
sum runs in a fixed order) and ``illumina_wide_kernel`` (its own fold: the
width-2 kernel at ``bf16``, whose sum runs in a fixed order too) at
``bf16`` and ``highest``, over two wire shapes,
decoded and not, the answers of captured and replayed batches are
bit-equal to eager ``Scorer._forward`` of the same batch (at most 5 reads
per allele, so that the read convolver kernel's per-allele atomics add at
most two terms into each output and the eager answer itself is the same
on every run); a
``load_state_dict`` between batches drops the graphs and the answers
follow the new weights; the wrappers' launch counters count the eager and
captured batches and the Scorer's replayed counts the replays, together what
eager runs of the same batches count, on the kernel route (by route and by
width) and the layer route; a thread that finalizes earlier batches while a capture runs, as
``call_parallel``'s drainer does, neither breaks the capture nor changes an
answer; a capture returns while the card is still busy with earlier
work; the card's stamps around ``illumina_wide``'s layer-route read
convolver (pinned; tests/test_torch_read_conv_wide_card.py holds the wide
kernel's) give replayed batches ``scorer.read_conv_layers`` records that
agree with eager ones of the same shape; and one replay under the
profiler runs one pair of stamp kernels for the read convolver while the
Scorer's replayed ``layer_route_rows`` grow by what an eager batch of the
same shape computes; the kernel route (``hybrid``, ``illumina``) ships no
stamps and records no ``scorer.read_conv_layers``.

Imports no JAX: on the card, run it alone with ``python -m pytest
--noconftest tests/test_torch_scorer_graphs.py``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from hello_tpu_torch import telemetry
from hello_tpu_torch.bench import build_workload
from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn import moe
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.ops import card_stamp, read_conv
from hello_tpu_torch.pipeline import graphs
from hello_tpu_torch.pipeline.batching import pack_sites
from hello_tpu_torch.pipeline.call import Scorer
from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                              pack_sites_wire)

#: (sites, alleles per site, Illumina reads, PacBio reads) of the two wire
#: shapes; at most 5 reads per allele (see the module's docstring)
SHAPES = ((4, 2, 4, 3), (12, 2, 5, 2))


@pytest.fixture(autouse=True)
def highest():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    layers.set_precision("highest")
    yield
    layers.set_precision("highest")
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs")
    return torch.device("cuda", 0)


@pytest.fixture
def counters():
    """Leave the process's launch counters as the test found them."""
    rc = read_conv.read_conv_reduce
    by_route = rc.launches_by_route
    saved = (rc.launches, dict(by_route), dict(moe.layer_route_calls),
             dict(moe.layer_route_rows))
    yield
    rc.launches, rc.launches_by_route = saved[0], by_route
    by_route.clear()
    by_route.update(saved[1])
    moe.layer_route_calls.clear()
    moe.layer_route_calls.update(saved[2])
    moe.layer_route_rows.clear()
    moe.layer_route_rows.update(saved[3])


def _model(name, seed=0):
    """The named config's model, seeded; ``illumina_wide`` pinned to the
    layer route at every precision (at bf16 its own fold takes the width-2
    kernel: ``illumina_wide_kernel``)."""
    kernel = name.endswith("_kernel")
    model = init_params(create_model(name[:-len("_kernel")] if kernel
                                     else name),
                        torch.Generator().manual_seed(seed))
    if name == "illumina_wide":
        model.fold_read_convs = lambda: {"read_conv0": moe.LayerRoute()}
    return model


def _wire(hybrid, shape, seed):
    sites_n, alleles, reads0, reads1 = shape
    sites = build_workload(np.random.RandomState(seed), sites_n, alleles,
                           reads0, reads1)
    if not hybrid:
        sites = [dataclasses.replace(s, tensors1=None) for s in sites]
    return pack_sites_wire(encode_chunk_sites(sites), hybrid=hybrid)


def _dense(n=3, seed=0):
    sites = build_workload(np.random.RandomState(seed), n, 2, 3, 2)
    return pack_sites([dataclasses.replace(s, tensors1=None) for s in sites],
                      hybrid=False)


# ---------------------------------------------------------------- the CPU


def test_cpu_scorer_never_captures():
    scorer = Scorer(_model("illumina"), device="cpu")
    t0 = telemetry.now_ns()
    for seed in (0, 1, 2, 0):
        scorer.finalize(scorer.score_async(_dense(seed=seed), decode=True))
    wire = _wire(False, SHAPES[0], 0)
    for _ in range(2):
        scorer.finalize(scorer.score_async(wire, decode=True))
    assert scorer.graph_counts == {"eager": 6, "captured": 0, "replayed": 0}
    assert not scorer._graphs[0].graphs
    names = {s.name for s in telemetry.spans(t0, telemetry.now_ns())}
    assert "scorer.launch" in names
    assert not names & {"scorer.capture", "scorer.replay"}


BASE = dict(generation=3, precision="bf16", decode=True, packed_conv=True)


def _arrays(**change):
    a = {"codes0": np.zeros((64, 150), np.uint8),
         "site_ids": np.zeros(16, np.int32)}
    a.update(change)
    return a


@pytest.mark.parametrize("arrays, kw", [
    (_arrays(codes0=np.zeros((128, 150), np.uint8)), {}),
    (_arrays(site_ids=np.zeros(16, np.int64)), {}),
    (_arrays(read_mask1=np.zeros((16, 8), np.float32)), {}),
    (_arrays(), {"decode": False}),
    (_arrays(), {"precision": "highest"}),
    (_arrays(), {"generation": 4}),
    (_arrays(), {"packed_conv": False}),
], ids=["shape", "dtype", "name", "decode", "precision", "generation",
        "packed_conv"])
def test_key_separates(arrays, kw):
    base = graphs.graph_key(_arrays(), **BASE)
    assert graphs.graph_key(arrays, **dict(BASE, **kw)) != base


def test_key_is_the_same_for_the_same_shapes_in_any_order():
    a = _arrays()
    b = {k: np.ones_like(a[k]) for k in reversed(list(a))}
    assert graphs.graph_key(a, **BASE) == graphs.graph_key(b, **BASE)


def _capture(cache, key, generation=0):
    """Take ``key`` through the cache until it holds a graph for it."""
    while True:
        g = cache.lookup(key, generation)
        if g is not None and g.graph is not None:
            return g
        if g is not None:
            g.graph = object()          # what GraphCache.capture sets
            cache.graphs[key] = g


def test_cache_runs_eager_then_captures_then_replays():
    cache = graphs.GraphCache()
    assert cache.lookup("k", 0) is None              # eager
    g = cache.lookup("k", 0)
    assert g is not None and g.graph is None and g.key == "k"
    g.graph = object()
    cache.graphs["k"] = g
    assert cache.lookup("k", 0) is g                 # replay
    assert cache.lookup("k", 0) is g


def test_cache_drops_its_graphs_with_a_new_generation():
    cache = graphs.GraphCache()
    _capture(cache, "k", 0)
    cache.pool = "pool of generation 0"
    assert cache.lookup("k", 1) is None              # eager again
    assert not cache.graphs and cache.pool is None
    assert cache.lookup("k", 1).graph is None        # then captured


def test_past_the_cap_new_keys_run_eagerly(monkeypatch):
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    cache = graphs.GraphCache()
    a = _capture(cache, "a")
    assert cache.lookup("c", 0) is None              # c seen once
    b = _capture(cache, "b")                         # the cache is full
    for _ in range(3):
        assert cache.lookup("c", 0) is None          # eager, never captured
        assert cache.lookup("d", 0) is None
    assert not cache._seen
    assert cache.graphs == {"a": a, "b": b}          # none evicted
    assert cache.lookup("a", 0) is a and cache.lookup("b", 0) is b


class _Replay:
    """What a captured graph's ``replay`` is to the Scorer, on the CPU."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_counts_apart_from_the_wrappers(counters):
    rc = read_conv.read_conv_reduce
    scorer = Scorer(_model("illumina"), device="cpu")
    graph = graphs.Graph("k")
    graph.graph, graph.outputs = _Replay(), {"experts": torch.zeros(1)}
    graph.launches = {"bf16": 2}
    graph.layer_route_calls = {"read_conv1": 1}
    wrappers = graphs.launch_counts()
    for seq in range(3):
        assert scorer._launch(0, None, None, True, graph, seq) is \
            graph.outputs
    assert graph.graph.replays == 3
    assert scorer.graph_counts == {"eager": 0, "captured": 0, "replayed": 3}
    assert scorer.replayed_launches_by_route == {"tf32x3": 0, "tf32": 0,
                                                 "bf16": 6}
    assert scorer.replayed_layer_route_calls == {"read_conv0": 0,
                                                 "read_conv1": 3}
    assert graphs.launch_counts() == wrappers


def test_launch_counts_read_both_counters(counters):
    before = graphs.launch_counts()
    read_conv.read_conv_reduce.launches_by_route["bf16"] += 2
    moe.layer_route_calls["read_conv0"] += 1
    after = graphs.launch_counts()
    assert graphs._added(after[0], before[0]) == {"bf16": 2}
    assert graphs._added(after[1], before[1]) == {"read_conv0": 1}


# ---------------------------------------------------------------- the card


def _host(out):
    if isinstance(out, dict):
        return {k: np.array(v) for k, v in out.items()}
    return tuple(None if v is None else np.array(v) for v in out)


def _eager(scorer, batch, decode, device):
    """Eager ``Scorer._forward`` of ``batch`` (no graph), as the host gets
    it."""
    with torch.inference_mode():
        out = scorer._forward(scorer._refresh(0),
                              scorer._upload(batch.wire, device), decode)
    torch.cuda.synchronize(device)
    return _host(Scorer._host_form({k: None if v is None else v.cpu()
                                    for k, v in out.items()}))


def _equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.card
@pytest.mark.parametrize("precision", ["bf16", "highest"])
@pytest.mark.parametrize("name", ["hybrid", "illumina", "illumina_wide",
                                  "illumina_wide_kernel"])
def test_replayed_answers_are_bit_equal_to_eager(card, name, precision):
    layers.set_precision(precision)
    scorer = Scorer(_model(name), device=card)
    hybrid = scorer.model.hybrid
    for decode in (True, False):
        for shape in SHAPES:
            # eager, captured, replayed, replayed: four batches of one shape
            batches = [_wire(hybrid, shape, seed) for seed in (1, 2, 3, 1)]
            want = [_eager(scorer, b, decode, card) for b in batches]
            got = [_host(scorer.finalize(scorer.score_async(b, decode=decode)))
                   for b in batches]
            for g, w in zip(got, want):
                _equal(g, w)
    assert scorer.graph_counts == {"eager": 4, "captured": 4, "replayed": 8}
    assert len(scorer._graphs[0].graphs) == 4


@pytest.mark.card
def test_load_state_dict_drops_the_graphs(card):
    layers.set_precision("bf16")
    model = _model("hybrid")
    scorer = Scorer(model, device=card)
    batch = _wire(True, SHAPES[0], 1)
    for _ in range(3):                               # eager, capture, replay
        old = _host(scorer.finalize(scorer.score_async(batch, decode=False)))
    assert scorer.graph_counts["replayed"] == 1
    model.load_state_dict(_model("hybrid", seed=7).state_dict())
    new = [_host(scorer.finalize(scorer.score_async(batch, decode=False)))]
    assert scorer.graph_counts["eager"] == 2          # the graph was dropped
    assert len(scorer._graphs[0].graphs) == 0
    new += [_host(scorer.finalize(scorer.score_async(batch, decode=False)))
            for _ in range(2)]                        # capture, replay
    assert scorer.graph_counts == {"eager": 2, "captured": 2, "replayed": 2}
    want = _eager(scorer, batch, False, card)
    assert not np.array_equal(want[0], old[0])
    for got in new:
        _equal(got, want)


def _counts(scorer):
    """The wrappers' counters and the Scorer's replayed counts; by width
    last."""
    rc = read_conv.read_conv_reduce
    return (rc.launches, dict(rc.launches_by_route),
            dict(moe.layer_route_calls),
            {k: getattr(f, "launches", None) for k, f in scorer.folded.items()},
            dict(scorer.replayed_launches_by_route),
            dict(scorer.replayed_layer_route_calls),
            dict(rc.launches_by_width),
            dict(scorer.replayed_launches_by_width))


def _diff(after, before):
    return tuple(a - b if isinstance(a, int) else
                 {k: None if n is None else n - b[k] for k, n in a.items()}
                 for a, b in zip(after, before))


@pytest.mark.card
@pytest.mark.parametrize("name", ["hybrid", "illumina_wide",
                                  "illumina_wide_kernel"])
def test_launch_counters_count_eager_and_replayed_launches_apart(
        card, counters, name):
    layers.set_precision("bf16")
    scorer = Scorer(_model(name), device=card)
    hybrid = scorer.model.hybrid
    batches = [_wire(hybrid, shape, seed) for shape in SHAPES
               for seed in (1, 2, 3, 4)]
    before = _counts(scorer)
    for b in batches[:2] + batches[4:6]:     # what the wrappers launch
        _eager(scorer, b, True, card)
    launched = _diff(_counts(scorer), before)
    for b in batches[2:4] + batches[6:]:     # what the replays run again
        _eager(scorer, b, True, card)
    eager = _diff(_counts(scorer), before)
    before = _counts(scorer)
    for b in batches:
        scorer.finalize(scorer.score_async(b, decode=True))
    # per shape: eager, captured, replayed, replayed
    assert scorer.graph_counts == {"eager": 2, "captured": 2, "replayed": 4}
    got = _diff(_counts(scorer), before)
    assert got[:4] == launched[:4]
    assert got[4] == {r: n - launched[1][r] for r, n in eager[1].items()}
    assert got[5] == {k: n - launched[2][k] for k, n in eager[2].items()}
    assert got[6] == launched[6]
    assert got[7] == {w: n - launched[6][w] for w, n in eager[6].items()}
    assert eager[0] + sum(eager[2].values()) == len(batches) * (
        2 if hybrid else 1)
    assert sum(eager[6].values()) == eager[0]


@pytest.mark.card
def test_a_capture_waits_for_no_work_in_flight(card):
    layers.set_precision("bf16")
    scorer = Scorer(_model("illumina"), device=card)
    batch = _wire(False, SHAPES[0], 1)
    want = _eager(scorer, batch, True, card)
    scorer.finalize(scorer.score_async(batch, decode=True))       # eager
    with torch.cuda.device(card):
        torch.cuda._sleep(4_000_000_000)        # about 2 s of the card's
        busy = torch.cuda.Event()
        busy.record()
    got = scorer.score_async(batch, decode=True)                 # capture
    assert scorer.graph_counts["captured"] == 1
    assert not busy.query()
    _equal(_host(scorer.finalize(got)), want)


@pytest.mark.card
def test_a_thread_finalizing_during_a_capture(card):
    layers.set_precision("bf16")
    scorer = Scorer(_model("hybrid"), device=card)
    batch = _wire(True, SHAPES[0], 1)
    want = _eager(scorer, batch, True, card)
    earlier = [scorer.score_async(_wire(True, SHAPES[1], 5), decode=True)]
    scorer.finalize(scorer.score_async(batch, decode=True))      # eager
    stop, calls, errors = threading.Event(), [], []

    def drainer():
        # finalize_many's waits and queries, as parallel_call._AsyncDrainer
        # makes them, over and over until the capture is done
        try:
            while not stop.is_set():
                for r in earlier:
                    r.event.query()
                scorer.finalize_many(earlier)
                calls.append(telemetry.now_ns())
        except Exception as e:         # noqa: BLE001 - reported below
            errors.append(e)

    thread = threading.Thread(target=drainer)
    t0 = telemetry.now_ns()
    thread.start()
    try:
        time.sleep(0.05)
        got = [_host(scorer.finalize(scorer.score_async(batch, decode=True)))
               for _ in range(3)]                     # capture, replay x2
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors
    assert scorer.graph_counts == {"eager": 2, "captured": 1, "replayed": 2}
    cap, = [s for s in telemetry.spans(t0, telemetry.now_ns())
            if s.name == "scorer.capture"]
    assert any(cap.start_ns <= c <= cap.end_ns for c in calls)
    for g in got:
        _equal(g, want)


#: card cycles of the spin queued ahead of each batch whose stamps are read
#: (some 50 ms at the H100's clock)
HOLD_CYCLES = 100_000_000


def _layer_records(scorer, batches):
    """Score ``batches`` one at a time: each batch's
    ``scorer.read_conv_layers`` record in ms, in order.  The card spins
    ahead of each batch while the host enqueues it, so an eager batch's
    stamps bracket the card's work and not the host's enqueue of it (the
    layer route's hundreds of launches can fall behind 10 ms of the
    card's)."""
    t0 = telemetry.now_ns()
    first = scorer._next
    for b in batches:
        torch.cuda._sleep(HOLD_CYCLES)
        scorer.finalize(scorer.score_async(b, decode=True))
    got = {s.key: (s.end_ns - s.start_ns) / 1e6
           for s in telemetry.spans(t0, telemetry.now_ns())
           if s.name == "scorer.read_conv_layers"}
    return [got[first + k] for k in range(len(batches))]


@pytest.mark.card
def test_replayed_stamps_agree_with_eager_ones(card, monkeypatch):
    layers.set_precision("bf16")
    # 64 sites x 2 alleles x 20 reads: some 10 ms of the card's a batch
    # (_layer_records holds the card while the host enqueues each batch)
    shape = (64, 2, 20, 0)
    batches = [_wire(False, shape, seed) for seed in range(7)]
    replaying = Scorer(_model("illumina_wide"), device=card)
    got = _layer_records(replaying, batches)
    # eager, captured, then five replays
    assert replaying.graph_counts == {"eager": 1, "captured": 1,
                                      "replayed": 5}
    replayed = got[2:]
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 0)      # every batch eager
    eager_scorer = Scorer(_model("illumina_wide"), device=card)
    eager = _layer_records(eager_scorer, batches)[1:]  # the first warms up
    assert eager_scorer.graph_counts["replayed"] == 0
    assert all(ms > 0 for ms in got + eager)
    lo, hi = min(eager), max(eager)
    pad = max(hi - lo, 0.1 * float(np.median(eager)))
    assert lo - pad <= float(np.median(replayed)) <= hi + pad, (eager,
                                                               replayed)


@pytest.mark.card
def test_a_replay_stamps_its_layer_route_read_convolver_once(card, counters):
    from torch.profiler import ProfilerActivity, profile

    layers.set_precision("bf16")
    scorer = Scorer(_model("illumina_wide"), device=card)
    batch = _wire(False, SHAPES[1], 1)
    before = dict(moe.layer_route_rows)
    scorer.finalize(scorer.score_async(batch, decode=True))      # eager
    eager_rows = {k: n - before[k] for k, n in moe.layer_route_rows.items()}
    assert eager_rows == {"read_conv0": batch.wire["codes0"].shape[0],
                          "read_conv1": 0}
    scorer.finalize(scorer.score_async(batch, decode=True))      # capture
    wrapper = (dict(moe.layer_route_rows), card_stamp.card_stamp.launches)
    replayed = dict(scorer.replayed_layer_route_rows)
    t0 = telemetry.now_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scorer.finalize(scorer.score_async(batch, decode=True))  # replay
        torch.cuda.synchronize(card)
    assert scorer.graph_counts == {"eager": 1, "captured": 1, "replayed": 1}
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("card_stamp_kernel" in n for n in kernels) == 2, kernels
    assert {k: n - replayed[k] for k, n in
            scorer.replayed_layer_route_rows.items()} == eager_rows
    # the wrappers count nothing for a replay
    assert (dict(moe.layer_route_rows),
            card_stamp.card_stamp.launches) == wrapper
    rec, = [s for s in telemetry.spans(t0, telemetry.now_ns())
            if s.name == "scorer.read_conv_layers"]
    assert rec.key == scorer._next - 1 and rec.end_ns > rec.start_ns


@pytest.mark.card
@pytest.mark.parametrize("name", ["hybrid", "illumina"])
def test_the_kernel_route_ships_no_stamps(card, name):
    layers.set_precision("bf16")
    scorer = Scorer(_model(name), device=card)
    batch = _wire(scorer.model.hybrid, SHAPES[0], 1)
    t0 = telemetry.now_ns()
    for _ in range(3):                       # eager, captured, replayed
        got = scorer.score_async(batch, decode=True)
        assert "read_conv_stamps" not in got.out
        scorer.finalize(got)
    assert scorer.graph_counts == {"eager": 1, "captured": 1, "replayed": 1}
    names = {s.name for s in telemetry.spans(t0, telemetry.now_ns())}
    assert "scorer.card_wait" in names
    assert "scorer.read_conv_layers" not in names
