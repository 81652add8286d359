"""The legs of the port's throughput benchmark, hello_tpu_torch/bench.py,
against hello_tpu on the CPU at ``highest``.

  * device legs: ``bench_device``'s forward of a 6-site workload (hybrid
    and illumina, the dense batch and the coded wire expanded to packed
    rows) against hello_tpu's ``model.apply`` on ``pack_sites`` and on
    ``expand_compact_packed`` of ``bench.py``'s sites, with the same weights
    (carried over with ``state_dict_from_jax``), rtol 1e-4 / atol 1e-4, as
    tests/test_torch_bench_packed.py holds the packed-row bench;
  * training leg: the first step's loss of ``bench_train`` on 8 sites
    against hello_tpu's ``Trainer`` on ``bench.py``'s wire batch, from the
    same initial weights, rtol 1e-4;
  * pipeline leg: ``bench_pipeline`` on a 20 kb genome with no workers
    scores as many sites as hello_tpu's ``call_region`` on the same files.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hello_tpu.io.fasta import FastaFile as JaxFastaFile
from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn import moe as jax_moe
from hello_tpu.parallel.mesh import data_mesh
from hello_tpu.pipeline import batching as jax_batching
from hello_tpu.pipeline import call as jax_call
from hello_tpu.pipeline import compact as jax_compact
from hello_tpu.train import trainer as jax_trainer
from hello_tpu_torch import bench
from hello_tpu_torch.nn import layers, moe
from hello_tpu_torch.nn.convert import state_dict_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_bench():
    """``bench.py`` at the repo's root, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def highest(monkeypatch):
    monkeypatch.setattr(bench.time, "sleep", lambda s: None)
    layers.set_precision("highest")
    jax_layers.set_precision("highest")
    yield
    layers.set_precision("highest")


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("model_name", ["illumina", "hybrid"])
def test_device_forward_equals_hello_tpu(model_name, wire):
    jm = jax_moe.create_model(model_name)
    params, state = jm.init(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = moe.create_model(model_name)
    weights = state_dict_from_jax(tm, params, state)

    sites = bench.build_workload(np.random.RandomState(0), 6, 2, 4, 3)
    rate, out = bench.bench_device(sites, 1, "highest", "cpu",
                                   model_name=model_name, wire=wire,
                                   params=weights)
    assert rate > 0 and len(out["batches"]) == 2

    ref = _root_bench().build_workload(np.random.RandomState(0), 6, 2, 4, 3)
    if wire:
        batch = jax_compact.expand_compact_packed(
            {k: jnp.asarray(v) for k, v in jax_compact.pack_sites_wire(
                jax_compact.encode_chunk_sites(ref),
                hybrid=jm.hybrid).wire.items()})
    else:
        batch = {k: jnp.asarray(v) for k, v in jax_batching.pack_sites(
            ref, hybrid=jm.hybrid).device_dict().items()}
    want, _ = jm.apply(params, state, batch, train=False)
    experts, meta = out["output"]
    np.testing.assert_allclose(experts.numpy(), np.asarray(want["experts"]),
                               rtol=1e-4, atol=1e-4)
    if want["meta"] is None:
        assert meta is None
    else:
        np.testing.assert_allclose(meta.numpy(), np.asarray(want["meta"]),
                                   rtol=1e-4, atol=1e-4)


def test_first_train_step_equals_hello_tpu():
    ref = _root_bench().build_workload(np.random.RandomState(4), 8, 2, 3, 2)
    for s in ref:                                   # bench.py:197-199
        s.labels = [i % 2 for i in range(len(s.alleles))]
        s.site_label = 0
    wire = jax_compact.stack_wire_batches([jax_compact.training_wire_dict(
        jax_compact.pack_sites_wire(jax_compact.encode_chunk_sites(ref),
                                    hybrid=True))])
    jt = jax_trainer.Trainer(jax_moe.create_model("hybrid"),
                             jax_trainer.TrainConfig(entropy_regularizer=0.1),
                             mesh=data_mesh(1))
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    want = jt.train_batch(jax.device_put(wire))["loss"]

    sites = bench.build_workload(np.random.RandomState(4), 8, 2, 3, 2)
    weights = state_dict_from_jax(moe.create_model("hybrid"), params, {})
    rate, sustained, breakdown, losses = bench.bench_train(
        sites, iters=1, precision="highest", device="cpu", sustained=False,
        params=weights)
    np.testing.assert_allclose(losses["first_loss"], want, rtol=1e-4)
    assert rate > 0 and sustained is None
    assert breakdown["sustained_step_s"] is None


def test_pipeline_sites_equal_hello_tpu(tmp_path):
    rate, out = bench.bench_pipeline(workers=0, ref_length=20_000,
                                     num_variants=66, device="cpu",
                                     workdir=str(tmp_path))
    ds = out["dataset"]
    assert rate > 0 and out["records"]
    assert out["scorer"].device.type == "cpu"
    stats = {}
    jax_call.call_region([ds.bams["illumina"]], JaxFastaFile(ds.fasta),
                         ds.chromosome, 0, 20_000,
                         jax_call.load_scorer("illumina"), stats=stats)
    assert out["stats"]["sites"] == stats["sites"] > 0
