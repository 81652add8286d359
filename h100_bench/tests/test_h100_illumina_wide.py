"""The ``illumina_wide`` configuration and its cell's two new readers, on the
CPU: the plain reference against the port's CPU forward; the wide read
convolver's FLOP count against a hand count; ``read_conv_layers_ms.score``
and ``read_conv_layers_roofline.score`` on a synthetic context with
records planted through ``telemetry.record``."""

import itertools

import numpy as np
import pytest
import torch

from h100_bench import cells, flops, generator, weights
from h100_bench.reference import model as ref
from hello_tpu_torch import telemetry

SEED = 2**31 + 91
CELL = "illumina_wide.score.bf16"
SPAN = "scorer.read_conv_layers"

# one read through the wide read convolver (every channel doubled), by hand
WIDE_READ_CONV = 2 * (3 * 6 * 32 * 148 + 3 * 32 * 32 * 146 + 3 * 32 * 64 * 144
                      + 6 * 3 * 64 * 64 * 71 + 3 * 64 * 128 * 36
                      + 3 * 128 * 128 * 36 + 64 * 128 * 36
                      + 6 * 3 * 128 * 128 * 36)


def test_forward_matches_the_port():
    from hello_tpu_torch.nn.layers import set_precision
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.batching import pack_sites

    cpu = torch.device("cpu")
    net = ref.config("illumina_wide")
    params = weights.make_state_dict(ref.param_shapes(net), SEED, cpu)
    batch = generator.make_batch(SEED, 0, 6, 2, [[2, 5]])
    set_precision("highest")
    model = create_model("illumina_wide")
    model.load_state_dict(params, strict=True)
    model.eval()
    dense = pack_sites(generator.port_sites(batch), hybrid=False)
    with torch.no_grad():
        port = model({k: torch.from_numpy(v)
                      for k, v in dense.device_dict().items()})
        mine = ref.forward(net, params, generator.reference_inputs(batch, cpu))
    A = len(batch["allele_site"])
    # fp32 on both sides, sums in other orders: the same tolerance as the
    # width-1 models' test
    np.testing.assert_allclose(mine["experts"].numpy(),
                               port["experts"][:A].numpy(), rtol=1e-4,
                               atol=1e-4)
    assert port["meta"] is None and mine["meta"] is None


def test_wide_read_convolver_flops_by_hand():
    net = ref.config("illumina_wide")
    assert flops.network_flops(net["read_conv0"], 150) == (WIDE_READ_CONV, 36)
    assert WIDE_READ_CONV == 40_438_272      # about 4x the width-1 10.15 M


def test_cell_is_the_score_loop_on_the_wide_configuration():
    spec = cells.cell(CELL)
    assert spec["config"]["model"] == "illumina_wide"
    assert spec["config"]["platforms"] == ["illumina"]
    assert spec["config"]["reduced"] == []
    assert spec["traffic"]["loop"] == "score"
    names = {m["name"] for m in spec["per_layer"]}
    assert {"read_conv_layers_ms.score", "read_conv_layers_roofline.score",
            "graph_replay_pct.score", "mfu.score"} <= names
    assert "read_conv_roofline" not in names     # the kernel never runs here


_windows = itertools.count(1)
MS = 1_000_000


def _ctx(device=torch.device("cuda", 0)):
    """A context whose window holds records of this test alone: a window
    of the records' clock far from the process's own."""
    lo = 10**18 + next(_windows) * 10**15
    return {"loop": "score", "device": device, "cell": CELL,
            "precision": "bf16",
            "host": {"wall_start": lo / 1e9, "wall_end": (lo + 10**12) / 1e9}}


def _reader(name):
    return cells.reader(name)


def test_layers_ms_is_the_mean_in_the_window():
    ctx = _ctx()
    lo = int(ctx["host"]["wall_start"] * 1e9)
    for k, ms in enumerate((150.0, 170.0, 190.0)):
        telemetry.record(SPAN, lo + k * 300 * MS, int(ms * MS), key=k)
    telemetry.record(SPAN, lo - 1000 * MS, 900 * MS, key=-1)   # before it
    assert _reader("read_conv_layers_ms.score")(ctx) == pytest.approx(170.0)


def test_layers_roofline_is_the_least_time_over_the_card_time():
    ctx = _ctx()
    lo = int(ctx["host"]["wall_start"] * 1e9)
    telemetry.record(SPAN, lo + MS, 200 * MS, key=0)
    # 81,900 reads a batch (the mix's 20 to 60 per allele over 2,048
    # alleles), compute bound at bf16
    reads = int(generator.read_counts(np.random.default_rng(1), 2048, 20,
                                      60).sum())
    assert reads == 81_900
    least = reads * WIDE_READ_CONV / 989e12
    got = _reader("read_conv_layers_roofline.score")(ctx)
    assert got == pytest.approx(100.0 * least / 0.2, rel=1e-12)
    assert 1.0 < got < 2.0


@pytest.mark.parametrize("name", ["read_conv_layers_ms.score",
                                  "read_conv_layers_roofline.score"])
def test_readers_read_nothing_without_records_or_on_the_cpu(name):
    assert _reader(name)(_ctx()) is None
    ctx = _ctx(device=torch.device("cpu"))
    telemetry.record(SPAN, int(ctx["host"]["wall_start"] * 1e9) + MS,
                     100 * MS, key=0)
    assert _reader(name)(ctx) is None


def test_line_at_tiny_size(tiny):
    from h100_bench import run

    spec = tiny(CELL)
    line = run.run_cell(CELL, SEED, 0.5, 1, torch.device("cpu"), spec=spec)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    # the CPU stamps nothing: the two new metrics are not read there
    assert not {"read_conv_layers_ms.score",
                "read_conv_layers_roofline.score"} & set(line["metrics"])
    assert set(line["checks"]) == set(spec["limits"])
