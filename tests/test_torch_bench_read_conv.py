"""The kernel-against-layers bench, hello_tpu_torch/ops/bench_read_conv.py,
against hello_tpu's on the CPU.

Its copied roofline constants equal hello_tpu's; at A = 4, R = 8 and
``highest`` its layer route and its kernel route (the plain version on the
CPU) give hello_tpu's ``net.apply`` + ``masked_read_sum`` and its
``fused_read_convolver`` (Pallas in interpret mode, as
tests/test_pallas_ops.py runs it) with the same weights, rtol 1e-4 / atol
1e-3; the peak lookup knows the H100s and raises for another card unless
both peaks are given; ``main`` runs with ``--device cpu``, and ``run``
returns each path's output on batch 0 beside its report.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn.moe import create_model as jax_create_model
from hello_tpu.nn.moe import masked_read_sum as jax_masked_read_sum
from hello_tpu.ops import bench_read_conv as jax_bench
from hello_tpu.ops import read_conv as jax_rc
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import state_dict_from_jax
from hello_tpu_torch.ops import bench_read_conv as bench
from hello_tpu_torch.ops.read_conv import fold_read_conv_weights

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def highest():
    layers.set_precision("highest")
    jax_layers.set_precision("highest")
    yield
    layers.set_precision("highest")


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        jax_rc.pl, "pallas_call",
        lambda *a, **k: orig(*a, **dict(k, interpret=True)))


def test_roofline_constants_equal_jax():
    assert bench._ACT_ELEMS_PER_READ == jax_bench._ACT_ELEMS_PER_READ
    assert bench.FLOPS_PER_READ == jax_bench.FLOPS_PER_READ
    for act_bytes in (2, 4):
        assert bench.hbm_bytes_per_read(act_bytes) == \
            jax_bench.hbm_bytes_per_read(act_bytes)


def test_routes_equal_jax(interpret_pallas):
    jm = jax_create_model("illumina")
    params, state = jm.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = moe.create_model("illumina")
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    tm.eval()
    (reads, mask), = bench.make_batches(4, 8, "cpu", count=1)

    # hello_tpu's xla_path and its Pallas kernel, on the same inputs
    net = jm.nets["read_conv0"]
    flat = jnp.asarray(reads.numpy().reshape(32, 150, 6), jnp.float32)
    frames, _ = net.apply(params["read_conv0"], {}, flat)
    want = np.asarray(jax_masked_read_sum(
        jnp.reshape(frames, (4, 8, 36, 64)), jnp.asarray(mask.numpy())))
    weights = jax_rc.extract_read_conv_weights(net, params["read_conv0"])
    pallas = np.asarray(jax_rc.fused_read_convolver(
        jnp.asarray(reads.numpy()), jnp.asarray(mask.numpy()), weights,
        lanes=8))

    got_layers = bench.layer_route(tm, reads, mask).numpy()
    folded = fold_read_conv_weights(tm.net("read_conv0"))
    got_kernel = bench.kernel_route(folded, reads, mask).numpy()
    for got in (got_layers, got_kernel):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-3)


def test_card_peaks():
    sxm = bench.card_peaks("NVIDIA H100 80GB HBM3")
    assert sxm == bench.CARD_PEAKS["H100 SXM"]
    assert bench.card_peaks("NVIDIA H100 PCIe") == bench.CARD_PEAKS["H100 PCIe"]
    for name in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "cpu"):
        with pytest.raises(ValueError, match="no published peaks"):
            bench.card_peaks(name)
        with pytest.raises(ValueError, match="no published peaks"):
            bench.card_peaks(name, hbm_peak=1000.0)
    given = bench.card_peaks("NVIDIA A100-SXM4-80GB", 2039.0, 312.0)
    assert given == {"hbm_gbs": 2039.0, "fp32": 312.0, "tf32": 312.0,
                     "bf16": 312.0}
    # no TPU number is a default
    assert all(v not in (819.0, 394.0) for p in bench.CARD_PEAKS.values()
               for v in p.values())


def test_paths_and_their_math():
    assert [p[1:] for p in bench.paths("default")] == [
        ("layers", "default", "default"), ("kernel", "tf32", "default"),
        ("kernel", "bf16", "bf16")]
    assert [p[1:] for p in bench.paths("highest")][1] == \
        ("kernel", "tf32x3", "highest")
    assert [p[1:] for p in bench.paths("bf16")] == [
        ("layers", "bf16", "bf16"), ("kernel", "bf16", "bf16")]
    assert bench.MATH[("layers", "bf16")] == "fp32"


def test_computed_rows_skip_empty_blocks():
    valid = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1.0])
    # blocks of 5: rows 0-4 (a valid row), 5-9 (none), 10-11 (a valid row)
    assert bench.computed_rows(valid, 5) == 7


def test_main_on_the_cpu(capsys):
    bench.main(["--device", "cpu", "--A", "2", "--R", "8", "--iters", "1",
                "--precision", "highest"])
    out = capsys.readouterr().out
    assert "layers (highest)" in out and "kernel tf32x3" in out
    assert "kernel bf16" in out and "vs layers" in out
    assert "peak" not in out                  # no roofline on the CPU
    assert layers.PRECISION == "highest"


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--A", "2", "--R", "8"])


def test_run_returns_the_outputs_it_timed():
    result = bench.run(["--device", "cpu", "--A", "2", "--R", "8",
                        "--iters", "1", "--precision", "highest"])
    model = result["inputs"]["model"]
    reads, mask = result["inputs"]["batches"][0]
    assert [line["tag"] for line in result["paths"]] == list(
        result["outputs"])
    want = {"layers (highest)": bench.layer_route(model, reads, mask)}
    net = model.net("read_conv0")
    for route in ("tf32x3", "bf16"):
        with bench.precision("bf16" if route == "bf16" else "highest"):
            want[f"kernel {route}"] = bench.kernel_route(
                fold_read_conv_weights(net, route), reads, mask)
    for tag, got in result["outputs"].items():
        assert got.shape == (2, 36, 64)
        torch.testing.assert_close(got, want[tag], rtol=0, atol=0, msg=tag)
    assert result["peaks"] is None and result["device"] == "cpu"
