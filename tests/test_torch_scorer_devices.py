"""The Scorer's round robin over several devices, and the port's entry
points (CPU).

hello_tpu's Scorer round-robins batches over every local device, keeping a
weight copy per device and counting dispatches and the devices holding work
at once.  The port keys its accounting by position in ``devices``, so the
CPU can stand for two cards here:

  * two positions take batches in turn; under pipelined dispatch both hold
    work at once; every position's logits equal a one-device Scorer's
    exactly and hello_tpu's within rtol 1e-4 / atol 1e-4;
  * calling a genome through two positions writes the one-device records;
  * F1 on every replica: weights swapped into the primary, or changed in
    place, reach each position's copy and fold before its next dispatch;
  * a card that is not visible raises; so does LOCAL_RANK past the cards;
  * ``entry()`` equals ``__graft_entry__.entry()`` within rtol 1e-4 on
    hello_tpu's weights; ``dryrun_multichip(2)`` passes.
"""

import os
import sys
from collections import deque

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ge  # noqa: E402

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu_torch.nn import layers  # noqa: E402
from hello_tpu_torch.nn.convert import init_params, state_dict_from_jax  # noqa: E402
from hello_tpu_torch.nn.moe import create_model  # noqa: E402
from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites  # noqa: E402
from hello_tpu_torch.pipeline.call import Scorer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def highest():
    layers.set_precision("highest")
    jax_layers.set_precision("highest")


def _batch(hybrid=False, seed=0):
    rng = np.random.RandomState(seed)
    reads = lambda n: [rng.randint(0, 255, (n, 150, 6)).astype(np.uint8)
                       for _ in range(2)]
    sites = [SiteWork("c", 10 * i, 10 * i + 1, ["A", "C"], reads(3 + i),
                      reads(2 + i) if hybrid else None,
                      np.eye(5, dtype=np.float32)[rng.randint(0, 5, 150)])
             for i in range(3)]
    return pack_sites(sites, hybrid=hybrid)


def _seeded(name, seed):
    return init_params(create_model(name), torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", ["illumina", "hybrid"])
def test_round_robin_over_two_positions(name):
    from hello_tpu.nn.moe import create_model as jax_create
    from hello_tpu.pipeline.call import Scorer as JaxScorer

    jmodel = jax_create(name)
    params, state = jmodel.init(jax.random.PRNGKey(4))
    sd = state_dict_from_jax(create_model(name),
                             jax.tree_util.tree_map(np.asarray, params), {})
    batch = _batch(hybrid=name == "hybrid")
    want, want_meta = JaxScorer(jmodel, params, state, compact=False)(batch)

    one = create_model(name)
    one.load_state_dict(sd)
    single, single_meta = Scorer(one, device="cpu")(batch)
    two = create_model(name)
    two.load_state_dict(sd)
    scorer = Scorer(two, devices=["cpu", "cpu"])
    assert scorer.max_in_flight == 6
    assert [str(d) for d in scorer.devices] == ["cpu", "cpu"]
    for _ in range(2):
        got, meta = scorer(batch)
        np.testing.assert_array_equal(got, single)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
        if name == "hybrid":
            np.testing.assert_array_equal(meta, single_meta)
            np.testing.assert_allclose(meta, np.asarray(want_meta),
                                       rtol=1e-4, atol=1e-4)
    assert scorer.dispatch_counts == {0: 1, 1: 1}
    assert all(f is not None for f in scorer.replica_folds())
    assert scorer.replica_folds()[1] is not scorer.folded

    # pipelined dispatch, as the callers run it: both positions hold work
    scorer.dispatch_counts.clear()
    scorer.peak_concurrent_devices = 0
    in_flight = deque()
    for _ in range(6):
        in_flight.append(scorer.score_async(batch))
        while len(in_flight) >= scorer.max_in_flight:
            scorer.finalize(in_flight.popleft())
    assert scorer.peak_concurrent_devices == 2
    got = scorer.finalize_many(list(in_flight))
    assert scorer.dispatch_counts == {0: 3, 1: 3}
    assert all(v == 0 for v in scorer._outstanding.values())
    for experts, _ in got:
        np.testing.assert_array_equal(experts, single)


def test_one_position_scorer_is_unchanged():
    scorer = Scorer(create_model("illumina"), device="cpu")
    assert scorer.max_in_flight == 4 and len(scorer.devices) == 1
    scorer(_batch())
    assert scorer.dispatch_counts == {0: 1}
    with pytest.raises(ValueError, match="not both"):
        Scorer(create_model("illumina"), device="cpu", devices=["cpu"])


def test_calling_through_two_positions_writes_the_one_device_records(
        tmp_path):
    from hello_tpu_torch import sim
    from hello_tpu_torch.io.fasta import FastaFile
    from hello_tpu_torch.pipeline.call import call_region

    ds = sim.make_dataset(str(tmp_path), ref_length=8_000, num_variants=16,
                          coverage=20, read_length=120, seed=3)
    model = _seeded("illumina", 0)
    out = {}
    for key, devices in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        scorer = Scorer(model, devices=devices, packed_conv=True)
        out[key] = call_region([ds.bams["illumina"]], FastaFile(ds.fasta),
                               ds.chromosome, 0, 8_000, scorer,
                               max_alleles_per_batch=8)
        if key == "two":
            assert min(scorer.dispatch_counts.values()) >= 1
            assert len(scorer.dispatch_counts) == 2
    assert len(out["one"]) >= 5
    assert [(r.position, r.alt, r.gt, r.qual) for r in out["two"]] == \
        [(r.position, r.alt, r.gt, r.qual) for r in out["one"]]


@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_weights_changed_on_the_primary_reach_every_replica(change):
    batch = _batch(hybrid=True)
    new = _seeded("hybrid", 1)
    want, want_meta = Scorer(new, device="cpu")(batch)
    scorer = Scorer(_seeded("hybrid", 0), devices=["cpu", "cpu"])
    before = [scorer(batch)[0] for _ in range(2)]       # both replicas used
    assert not np.allclose(before[0], want)
    if change == "load_state_dict":
        scorer.model.load_state_dict(new.state_dict())
    else:
        # an optimiser-style in-place step on every parameter, read
        # convolver and later networks alike
        with torch.no_grad():
            for p, q in zip(scorer.model.parameters(), new.parameters()):
                p.copy_(q)
    for _ in range(2):
        got, meta = scorer(batch)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(meta, want_meta)


def test_a_card_that_is_not_visible_raises(monkeypatch):
    from hello_tpu_torch.parallel import mesh
    from hello_tpu_torch.pipeline.call import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="not visible"):
        resolve_device("cuda:1")
    with pytest.raises(RuntimeError, match="not visible"):
        Scorer(create_model("illumina"), devices=["cuda:3"])
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"),
                 ("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="visible"):
        mesh.init_distributed()
    with pytest.raises(ValueError, match="gloo"):
        mesh.init_distributed("cpu", backend="nccl")
    assert not mesh.is_distributed()


def test_entry_matches_graft_entry():
    from hello_tpu_torch.entry import entry

    jfn, (params, state, jbatch) = ge.entry()
    want_e, want_m = jfn(params, state, jbatch)
    fn, (model, batch) = entry(device="cpu")
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), v)
    model.load_state_dict(state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, params), {}), strict=True)
    experts, meta = fn(model, batch)
    np.testing.assert_allclose(experts.numpy(), np.asarray(want_e),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(meta.numpy(), np.asarray(want_m),
                               rtol=1e-4, atol=1e-4)


def test_dryrun_multichip_two_on_the_cpu():
    from hello_tpu_torch.entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out["dispatch_counts"] == {0: 2, 1: 2}
    assert out["peak_concurrent_devices"] == 2
    assert out["scorer_devices"] == ["cpu", "cpu"]
    assert out["coded_vs_dense_max_abs"] == 0.0
    assert np.isfinite(out["step_losses"]).all()
