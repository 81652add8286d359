"""One training step of the full ``hybrid`` model (two read convolvers,
three experts, combiners, meta-expert: the MoE loss with its entropy
regulariser) against hello_tpu's (CPU, ``highest``).

Same initial parameters, same batch (8 allele slots, 2 read slots per
platform): the loss within rtol 1e-6, each leaf's gradient within rtol 1e-4
with an atol of 1e-5 of the leaf's largest entry, the per-expert losses
within rtol 1e-5, and the loss after one Adam step within rtol 1e-5.
"""

import os
import sys

import numpy as np
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ge  # noqa: E402

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn import moe as jax_moe  # noqa: E402
from hello_tpu.parallel.mesh import data_mesh  # noqa: E402
from hello_tpu.pipeline.batching import stack_device_batches  # noqa: E402
from hello_tpu.train import trainer as jax_trainer  # noqa: E402
from hello_tpu_torch.nn import moe  # noqa: E402
from hello_tpu_torch.nn.convert import state_dict_from_jax  # noqa: E402
from hello_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.set_num_threads(1)


def test_hybrid_step_matches_hello_tpu():
    jax_layers.set_precision("highest")
    batch = ge._example_batch(np.random.RandomState(5), hybrid=True,
                              A=8, R=2, S=4, labels=True)
    stacked = stack_device_batches([batch])
    cfg = dict(entropy_regularizer=0.1, smoothing=0.05, aux_weight=0.2)
    jt = jax_trainer.Trainer(jax_moe.create_model("hybrid"),
                             jax_trainer.TrainConfig(**cfg),
                             mesh=data_mesh(1), seed=3)
    params = jax.tree_util.tree_map(np.asarray, jt.params)
    tm = moe.create_model("hybrid")
    tt = Trainer(tm, TrainConfig(**cfg), device="cpu",
                 params=state_dict_from_jax(tm, params, {}))
    assert tm.has_meta and not cfg.get("binary")

    want_loss, want_grads = jt.compute_grads(stacked)
    loss, grads = tt.compute_grads(stacked)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    want = state_dict_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, want_grads), {})
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-30,
                                   err_msg=k)

    m_want = jt.train_batch(stacked)
    m_got = tt.train_batch(stacked)
    np.testing.assert_allclose(m_got["loss"], m_want["loss"], rtol=1e-6)
    np.testing.assert_allclose(m_got["per_expert"], m_want["per_expert"],
                               rtol=1e-5)
    np.testing.assert_allclose(tt.train_batch(stacked)["loss"],
                               jt.train_batch(stacked)["loss"], rtol=1e-5)
