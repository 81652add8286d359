"""The packed-row A/B bench, hello_tpu_torch/ops/bench_packed.py, against
hello_tpu's on the CPU.

``build_palette_sites`` draws hello_tpu's arrays from the same
``RandomState``; the workload's shipped rows, dense grid and occupancy are
hello_tpu's; at ``highest`` the port's three forwards (packed rows, the
wire expanded to the dense grid, the dense batch) give hello_tpu's
``model.apply`` on ``expand_compact_packed``, ``expand_compact`` and the
dense batch with the same weights (carried over with
``state_dict_from_jax``), rtol 1e-4 / atol 1e-4; the hybrid's three
forwards agree with each other at the same tolerance.  ``main`` runs with
``--device cpu`` and raises without a card otherwise; ``run`` returns each
path's forward of batch 0 beside its report.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn import moe as jax_moe
from hello_tpu.ops import bench_packed as jax_bench
from hello_tpu.pipeline import batching as jax_batching
from hello_tpu.pipeline import compact as jax_compact
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import init_params, state_dict_from_jax
from hello_tpu_torch.ops import bench_packed as bench

torch.set_num_threads(1)

SITES, ALLELES, LO, HI = 6, 2, 3, 8


@pytest.fixture(autouse=True)
def highest():
    layers.set_precision("highest")
    jax_layers.set_precision("highest")
    yield
    layers.set_precision("highest")


def _assert_sites_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
                assert len(x) == len(y)
                for u, v in zip(x, y):
                    assert u.dtype == v.dtype
                    np.testing.assert_array_equal(u, v)
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("seed", [0, 1])
def test_palette_sites_equal_jax(seed):
    got = bench.build_palette_sites(np.random.RandomState(seed), 5, 3, 2, 9)
    want = jax_bench.build_palette_sites(np.random.RandomState(seed), 5, 3,
                                         2, 9)
    _assert_sites_equal(got, want)


def _jax_build(seed, hybrid):
    """hello_tpu's ``main``'s ``build`` for the same arguments."""
    rng = np.random.RandomState(seed)
    sites = jax_bench.build_palette_sites(rng, SITES, ALLELES, LO, HI)
    coded = jax_compact.encode_chunk_sites(sites)
    wb = jax_compact.pack_sites_wire(coded, hybrid=hybrid)
    return wb, jax_batching.pack_sites(sites, hybrid=hybrid)


@pytest.mark.parametrize("seed", [0, 1])
def test_workload_equals_jax(seed):
    wb, dense = bench.build(seed, SITES, ALLELES, LO, HI, hybrid=True)
    jwb, jdense = _jax_build(seed, hybrid=True)
    # hello_tpu's main counts them so
    rows = int(jwb.wire["codes0"].shape[0]
               + jwb.wire.get("codes1", np.empty((0, 1))).shape[0])
    grid = int(np.prod(jdense.read_mask0.shape)
               + np.prod(jdense.read_mask1.shape))
    assert bench.workload(wb, dense) == {
        "shipped_rows": rows, "dense_grid": grid, "occupancy": rows / grid}
    assert sorted(wb.wire) == sorted(jwb.wire)
    for k, v in jwb.wire.items():
        np.testing.assert_array_equal(wb.wire[k], v, err_msg=k)
    for k, v in jdense.device_dict().items():
        np.testing.assert_array_equal(dense.device_dict()[k], v, err_msg=k)


def test_three_paths_equal_jax():
    jm = jax_moe.create_model("illumina")
    params, state = jm.init(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = moe.create_model("illumina")
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    tm.eval()
    folded = tm.fold_read_convs()
    wb, dense = bench.build(0, SITES, ALLELES, LO, HI, hybrid=False)
    batches = {"wire": bench.to_device(wb.wire, "cpu"),
               "dense": bench.to_device(dense.device_dict(), "cpu")}
    jax_expand = {"packed": jax_compact.expand_compact_packed,
                  "dense_expand": jax_compact.expand_compact,
                  "dense_batch": lambda b: b}
    for path in bench.PATHS:
        (batch,) = bench.path_batches(path, [batches])
        experts, meta = bench.forward(tm, folded, path, batch)
        assert meta is None
        jb = {k: jnp.asarray(v) for k, v in
              (dense.device_dict() if path == "dense_batch"
               else wb.wire).items()}
        out, _ = jm.apply(params, state, jax_expand[path](jb), train=False)
        np.testing.assert_allclose(experts.numpy(),
                                   np.asarray(out["experts"]),
                                   rtol=1e-4, atol=1e-4, err_msg=path)


def test_hybrid_paths_agree_and_count_rows():
    model = init_params(moe.create_model("hybrid"),
                        torch.Generator().manual_seed(0)).eval()
    folded = model.fold_read_convs()
    wb, dense = bench.build(1, SITES, ALLELES, LO, HI, hybrid=True)
    batches = [{"wire": bench.to_device(wb.wire, "cpu"),
                "dense": bench.to_device(dense.device_dict(), "cpu")}]
    outs, rows = {}, {}
    for path in bench.PATHS:
        (batch,) = bench.path_batches(path, batches)
        outs[path] = bench.forward(model, folded, path, batch)
        rows[path] = bench.computed_rows(model, path, batch, 5)
    for path in bench.PATHS[1:]:
        for got, want in zip(outs[path], outs["packed"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=path)
    valid = int(dense.read_mask0.sum() + dense.read_mask1.sum())
    assert {r["valid_rows"] for r in rows.values()} == {valid}
    # the dense grid's computed blocks hold every valid row, and padding
    # rows beside them
    assert valid <= rows["packed"]["computed_rows"] <= \
        rows["dense_expand"]["computed_rows"] == \
        rows["dense_batch"]["computed_rows"] <= \
        bench.workload(wb, dense)["dense_grid"]


def test_main_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    bench.main(["--device", "cpu", "--sites", "3", "--reads_lo", "2",
                "--reads_hi", "4", "--iters", "1", "--precision", "highest",
                "--model", "illumina"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("packed-row wire :")
    assert "packed = " in lines[1] and "packed = " in lines[2]
    report = json.loads(lines[3])
    assert report["device"] == "cpu" and set(report["paths"]) == set(
        bench.PATHS)
    # the CPU takes the plain version: no launch
    assert all(sum(p["launches_by_route"].values()) == 0
               for p in report["paths"].values())


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--sites", "2"])


def test_run_returns_the_outputs_it_timed(monkeypatch):
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    result = bench.run(["--device", "cpu", "--sites", "3", "--reads_lo",
                        "2", "--reads_hi", "4", "--iters", "1",
                        "--precision", "highest"])
    inputs = result["inputs"]
    assert set(result["outputs"]) == set(bench.PATHS)
    for path in bench.PATHS:
        (batch,) = bench.path_batches(path, inputs["batches"][:1])
        experts, meta = bench.forward(inputs["model"], inputs["folded"],
                                      path, batch)
        got = result["outputs"][path]
        np.testing.assert_array_equal(got[0].numpy(), experts.numpy())
        np.testing.assert_array_equal(got[1].numpy(), meta.numpy())
    assert result["packed_vs_dense_expand"] == \
        result["paths"]["packed"]["windows_per_s"] / \
        result["paths"]["dense_expand"]["windows_per_s"]
