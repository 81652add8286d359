"""The F3 reading tool, hello_tpu_torch/pipeline/bf16_conv_check.py, on the
CPU (where it has no TF32 to switch): its per-conv reading sees every bf16
conv of a forward at fp32 rounding against float64, and its per-layer
reading finds a model equal to its own copy."""

import numpy as np
import pytest
import torch

from hello_tpu_torch.nn import layers
from hello_tpu_torch.nn.convert import init_params
from hello_tpu_torch.nn.moe import LayerRoute, create_model
from hello_tpu_torch.pipeline import bf16_conv_check as check
from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites

torch.set_num_threads(1)


def _batch(seed=0, n=3):
    rng = np.random.RandomState(seed)
    sites = [SiteWork("chr1", 50 * i, 50 * i + 1, ["A", "T"],
                      [rng.randint(0, 255, (4, 150, 6)).astype(np.uint8),
                       rng.randint(0, 255, (2, 150, 6)).astype(np.uint8)],
                      None, np.eye(5, dtype=np.float32)[
                          rng.randint(0, 5, 150)]) for i in range(n)]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            pack_sites(sites, hybrid=False).device_dict().items()}


@pytest.fixture
def bf16():
    layers.set_precision("bf16")
    yield
    layers.set_precision("highest")


@pytest.mark.parametrize("name", ["illumina_layer_norm", "illumina_wide"])
def test_every_bf16_conv_is_read_against_float64(name, bf16):
    """Every conv layer of a forward whose read convolver takes the layer
    route (pinned: at bf16 the wide one folds to its kernel, whose plain
    version tests/test_torch_read_conv_wide.py reads)."""
    model = init_params(create_model(name),
                        torch.Generator().manual_seed(0)).eval()
    convs = []
    handles = [m.register_forward_hook(lambda *a: convs.append(1))
               for m in model.modules() if isinstance(m, layers._ConvBase)]
    errors = []
    plain = layers.conv1d_bf16
    with check.conv_errors_against_float64(errors), torch.inference_mode():
        model(_batch(), folded={"read_conv0": LayerRoute()})
    for h in handles:
        h.remove()
    assert layers.conv1d_bf16 is plain
    assert len(errors) == len(convs) > 0
    # exact products of bf16 values, fp32 sums of at most a few hundred terms
    assert 0 < max(errors) < 2.0 ** -20


def test_layers_against_cpu_of_a_copy_is_exact(bf16):
    name = "illumina_layer_norm"
    model = init_params(create_model(name),
                        torch.Generator().manual_seed(1)).eval()
    copy = create_model(name)
    copy.load_state_dict(model.state_dict())
    lines = check.layers_against_cpu(model, copy.eval(), _batch(1))
    bf16_lines = [x for x in lines if "differ_share" in x]
    assert bf16_lines and all(x["card_dtype"] == "torch.bfloat16"
                              for x in bf16_lines)
    assert all(x.get("differ_share", 0) == 0
               and x.get("max_diff_over_layer_max", 0) == 0
               and x.get("fp32_max_rel", 0) == 0 for x in lines)
    assert {x["net"] for x in lines} >= {"read_conv0", "compressor0"}


def test_hybrid_layers_against_cpu_visit_every_network(bf16, tmp_path):
    """The two-platform batch through ``hybrid``: every network is held
    (the read convolvers through the layer route, both calls of each
    compressor, the tuple inputs of the xattns, combiners and meta-expert),
    and a copy of the model differs nowhere."""
    from hello_tpu_torch import sim

    ds = sim.make_dataset(str(tmp_path), ref_length=20_000,
                          num_variants=20, coverage=20, read_length=150,
                          seed=7, platforms=("illumina", "pacbio"),
                          pacbio_read_length=1500)
    batch, sites = check.featurized_batch(ds, 3, hybrid=True)
    assert sites == 3 and "reads1" in batch and "read_mask1" in batch
    model = init_params(create_model("hybrid"),
                        torch.Generator().manual_seed(2)).eval()
    copy = create_model("hybrid")
    copy.load_state_dict(model.state_dict())
    lines = check.layers_against_cpu(model, copy.eval(), batch)
    assert {x["net"] for x in lines} == set(model.networks())
    calls = {(x["net"], x["call"]) for x in lines}
    for k in range(2):
        assert {(f"compressor{k}", 0), (f"compressor{k}", 1)} <= calls
    assert ("read_conv1", 0) in calls and ("meta", 0) in calls
    assert any("differ_share" in x for x in lines)
    assert all(x.get("differ_share", 0) == 0
               and x.get("max_diff_over_layer_max", 0) == 0
               and x.get("fp32_max_rel", 0) == 0 for x in lines)
