"""The reference's torch files in the port: ``.wrapper.dnn`` whole-module
pickles and ``.pt`` state dicts, against hello_tpu's loader (CPU).

A whole-module pickle of a wrapper class defined here (the reference ships
``MoEMergedWrapperAdvanced`` modules with the model under ``moeMerged``)
and state-dict files with the ``moeMerged.`` / ``module.`` prefixes load
through the port's ``load_torch_checkpoint`` and through hello_tpu's, to
the same weights and batch-norm statistics; the files of the port's and
hello_tpu's ``save_torch_checkpoint`` load into each other; a network the
file lacks keeps its init, as hello_tpu skips it (through ``load_scorer``:
the seeded init of its seed), and anything else loads strictly;
``load_scorer`` on a ``.wrapper.dnn`` scores as a scorer built from the
same weights directly, and its ``reference_python`` reaches the unpickle.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax

from hello_tpu.nn import convert as jax_convert
from hello_tpu.nn import export as jax_export
from hello_tpu.nn import moe as jax_moe
from hello_tpu_torch.nn import moe
from hello_tpu_torch.nn.convert import (convert_state_dict, detect_prefix,
                                        init_params, load_torch_checkpoint,
                                        state_dict_from_jax)
from hello_tpu_torch.nn.export import export_state_dict, save_torch_checkpoint

torch.set_num_threads(1)

CONFIGS = ["illumina", "illumina_layer_norm", "hybrid_no_ensemble_addendum"]


class MoEMergedWrapper(nn.Module):
    """Stands for the reference's inference wrapper: the model under
    ``moeMerged`` and a parameter of its own beside it, which both loaders
    ignore (it is outside the model's prefix)."""

    def __init__(self, model):
        super().__init__()
        self.moeMerged = model
        self.temperature = nn.Parameter(torch.ones(1))


def _seeded(name, seed=4):
    """A port model with random weights and, for batch norm, moved
    statistics (so a loader that dropped them would show)."""
    tm = init_params(moe.create_model(name), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name_, buf in tm.named_buffers():
            if buf.is_floating_point():
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
            else:
                buf.fill_(7)
    return tm


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(torch.as_tensor(np.asarray(a[k])),
                                   torch.as_tensor(np.asarray(b[k])),
                                   rtol=0, atol=0, msg=k)


def _via_hello_tpu(name, path, model):
    """hello_tpu's load_torch_checkpoint of ``path``, as a state dict of the
    port's ``model`` (num_batches_tracked, which hello_tpu does not keep,
    taken from ``model``)."""
    params, state = jax_convert.load_torch_checkpoint(
        path, jax_moe.create_model(name))
    sd = state_dict_from_jax(model, params, state)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
    return sd


@pytest.mark.parametrize("name", CONFIGS)
def test_wrapper_dnn_loads_as_hello_tpu_loads_it(name, tmp_path):
    tm = _seeded(name)
    path = str(tmp_path / "model.wrapper.dnn")
    torch.save(MoEMergedWrapper(tm), path)
    fresh = moe.create_model(name)
    got = load_torch_checkpoint(path, fresh)
    _assert_same(got, tm.state_dict())
    _assert_same(got, _via_hello_tpu(name, path, tm))


@pytest.mark.parametrize("prefix", ["", "module.", "moeMerged.module."])
def test_prefixed_state_dicts_load(prefix, tmp_path):
    name = "illumina_layer_norm"
    tm = _seeded(name, 6)
    path = str(tmp_path / "model.pt")
    torch.save({prefix + k: v for k, v in tm.state_dict().items()}, path)
    sd = torch.load(path)
    assert detect_prefix(sd) == prefix == jax_convert.detect_prefix(sd)
    _assert_same(load_torch_checkpoint(path, moe.create_model(name)),
                 tm.state_dict())
    _assert_same(load_torch_checkpoint(path, moe.create_model(name)),
                 _via_hello_tpu(name, path, tm))


@pytest.mark.parametrize("name", ["illumina_layer_norm", "hybrid"])
def test_save_torch_checkpoint_files_interchange(name, tmp_path):
    """The port's file loads into hello_tpu's loader; hello_tpu's file loads
    into the port's; both hold the same keys, hello_tpu's export's."""
    tm = _seeded(name, 8)
    ours = str(tmp_path / "port.pt")
    save_torch_checkpoint(ours, tm)
    _assert_same(_via_hello_tpu(name, ours, tm), tm.state_dict())

    jm = jax_moe.create_model(name)
    params, state = jm.init(jax.random.PRNGKey(3))
    theirs = str(tmp_path / "hello_tpu.pt")
    jax_export.save_torch_checkpoint(theirs, jm, params, state)
    want = jax_export.export_state_dict(jm, params, state)
    assert sorted(torch.load(ours)) == sorted(want)
    assert sorted(export_state_dict(tm)) == sorted(want)
    got = load_torch_checkpoint(theirs, moe.create_model(name))
    _assert_same(got, {k: torch.from_numpy(np.asarray(v))
                       for k, v in want.items()})


def test_absent_network_keeps_init_and_the_rest_is_strict(tmp_path):
    """A network missing from the file keeps the model's weights (as
    hello_tpu skips it); a missing key of a present network, a key of no
    network of the model and a shape that differs raise."""
    tm = _seeded("illumina", 10)
    sd = {k: v for k, v in tm.state_dict().items()
          if not k.startswith("xattn0.")}
    target = _seeded("illumina", 11)
    got = convert_state_dict(sd, target)
    for k, v in got.items():
        want = (target if k.startswith("xattn0.") else tm).state_dict()[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    jm = jax_moe.create_model("illumina")
    params, _ = jax_convert.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jm)
    assert "xattn0" not in params

    missing = dict(sd)
    missing.pop("compressor0.network.0.conv1d.weight_v")
    with pytest.raises(KeyError, match="missing"):
        convert_state_dict(missing, target)
    extra = dict(sd, **{"meta.network.0.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="meta.network.0.weight"):
        convert_state_dict(extra, target)
    wrong = dict(sd)
    wrong["compressor0.network.0.conv1d.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape"):
        convert_state_dict(wrong, target)


@pytest.mark.parametrize("name", ["illumina", "illumina_layer_norm"])
def test_load_scorer_on_wrapper_dnn(name, tmp_path):
    """load_scorer("<config>", "<file>.wrapper.dnn") scores as a Scorer of
    the same weights built directly, through the route of the config (the
    kernel's for illumina, the layer route for illumina_layer_norm)."""
    from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites
    from hello_tpu_torch.pipeline.call import Scorer, load_scorer

    tm = _seeded(name, 12)
    path = str(tmp_path / "model.wrapper.dnn")
    torch.save(MoEMergedWrapper(tm), path)
    loaded = load_scorer(name, path, device="cpu")
    direct = Scorer(tm, device="cpu")
    route = "layers" if name == "illumina_layer_norm" else "tf32x3"
    assert loaded.read_conv_routes() == {"read_conv0": route}
    rng = np.random.RandomState(3)
    sites = [SiteWork("chr1", 50 * i, 50 * i + 1, ["A", "T"],
                      [rng.randint(0, 255, (4, 150, 6)).astype(np.uint8),
                       rng.randint(0, 255, (3, 150, 6)).astype(np.uint8)],
                      None, np.eye(5, dtype=np.float32)[
                          rng.randint(0, 5, 150)]) for i in range(4)]
    batch = pack_sites(sites, hybrid=False)
    np.testing.assert_array_equal(loaded(batch)[0], direct(batch)[0])


@pytest.mark.parametrize("suffix", [".pt", ".wrapper.dnn"])
def test_load_scorer_file_missing_a_network(suffix, tmp_path):
    """load_scorer on a file without xattn0: that network holds the seeded
    init of load_scorer's seed (hello_tpu's loader skips it; the model's
    own tensors are uninitialised memory until init), every other tensor
    the file's, and the scores are finite."""
    from hello_tpu_torch.pipeline.call import load_scorer

    name = "illumina"
    tm = _seeded(name, 14)
    path = str(tmp_path / f"model{suffix}")
    if suffix == ".pt":
        torch.save({k: v for k, v in tm.state_dict().items()
                    if not k.startswith("xattn0.")}, path)
    else:
        del tm.xattn0
        torch.save(MoEMergedWrapper(tm), path)
    got = load_scorer(name, path, seed=5, device="cpu")
    init = load_scorer(name, seed=5, device="cpu").model.state_dict()
    file_sd = tm.state_dict()
    for k, v in got.model.state_dict().items():
        want = init[k] if k.startswith("xattn0.") else file_sd[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    from hello_tpu_torch.pipeline.batching import SiteWork, pack_sites
    rng = np.random.RandomState(5)
    sites = [SiteWork("chr1", 50 * i, 50 * i + 1, ["A", "T"],
                      [rng.randint(0, 255, (3, 150, 6)).astype(np.uint8)] * 2,
                      None, np.eye(5, dtype=np.float32)[
                          rng.randint(0, 5, 150)]) for i in range(2)]
    assert np.isfinite(got(pack_sites(sites, hybrid=False))[0]).all()


def test_reference_python_reaches_the_unpickle(tmp_path):
    """A whole-module pickle whose wrapper class lives in a directory off
    sys.path (as the reference's python/ does) raises naming PYTHONPATH and
    reference_python, and loads through load_scorer's reference_python,
    which leaves sys.path as it was."""
    import importlib
    import sys

    from hello_tpu_torch.pipeline.call import load_scorer

    module = "reference_wrapper_for_test"
    (tmp_path / f"{module}.py").write_text(
        "from torch import nn\n\n\n"
        "class MoEMergedWrapperAdvanced(nn.Module):\n"
        "    def __init__(self, model):\n"
        "        super().__init__()\n"
        "        self.moeMerged = model\n")
    name = "illumina"
    tm = _seeded(name, 16)
    path = str(tmp_path / "model.wrapper.dnn")
    sys.path.insert(0, str(tmp_path))
    try:
        wrapper = importlib.import_module(module)
        torch.save(wrapper.MoEMergedWrapperAdvanced(tm), path)
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop(module, None)
    before = list(sys.path)
    with pytest.raises(ModuleNotFoundError,
                       match="PYTHONPATH.*reference_python"):
        load_scorer(name, path, device="cpu")
    try:
        got = load_scorer(name, path, device="cpu",
                          reference_python=str(tmp_path))
    finally:
        sys.modules.pop(module, None)
    assert sys.path == before
    _assert_same(got.model.state_dict(), tm.state_dict())
