"""The plain reference against the port's CPU forward and training step at
a tiny size (fp32, ``highest``), on the benchmark's weights and sites."""

import numpy as np
import pytest
import torch

from h100_bench import generator, weights
from h100_bench.reference import model as ref

SEED = 2**31 + 77


def _port_model(name, params):
    from hello_tpu_torch.nn.layers import set_precision
    from hello_tpu_torch.nn.moe import create_model

    set_precision("highest")
    model = create_model(name)
    model.load_state_dict(params, strict=True)
    return model.eval()


@pytest.mark.parametrize("name,ranges", [
    ("illumina", [[2, 5]]), ("hybrid", [[2, 5], [1, 3]])])
def test_forward_matches_the_port(name, ranges):
    from hello_tpu_torch.pipeline.batching import pack_sites

    cpu = torch.device("cpu")
    net = ref.config(name)
    params = weights.make_state_dict(ref.param_shapes(net), SEED, cpu)
    batch = generator.make_batch(SEED, 0, 6, 2, ranges)
    model = _port_model(name, params)
    dense = pack_sites(generator.port_sites(batch), hybrid=len(ranges) > 1)
    with torch.no_grad():
        port = model({k: torch.from_numpy(v)
                      for k, v in dense.device_dict().items()})
        mine = ref.forward(net, params, generator.reference_inputs(batch, cpu))
    A = len(batch["allele_site"])
    np.testing.assert_allclose(mine["experts"].numpy(),
                               port["experts"][:A].numpy(), rtol=1e-4,
                               atol=1e-4)
    if name == "hybrid":
        np.testing.assert_allclose(mine["meta"].numpy(),
                                   port["meta"][:batch["num_sites"]].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_first_training_step_matches_the_port():
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.batching import (pack_sites,
                                                   stack_device_batches,
                                                   training_dict)
    from hello_tpu_torch.train.trainer import TrainConfig, Trainer

    cpu = torch.device("cpu")
    net = ref.config("hybrid")
    params = weights.make_state_dict(ref.param_shapes(net), SEED, cpu)
    batch = generator.make_batch(SEED, 0, 4, 2, [[2, 4], [1, 3]], labels=True)
    train = {"lr": 1e-3, "weight_decay": 1e-4, "grad_clip_norm": 10.0,
             "entropy_regularizer": 0.1, "entropy_decay": 0.5}
    mine = ref.train_steps(net, params, [generator.reference_inputs(batch,
                                                                     cpu)],
                           train)
    _port_model("hybrid", params)            # precision highest
    trainer = Trainer(create_model("hybrid"), TrainConfig(), device="cpu",
                      params=params)
    stacked = stack_device_batches([training_dict(
        pack_sites(generator.port_sites(batch), hybrid=True))])
    loss = trainer.train_batch(trainer.stage_batches(stacked))["loss"]
    assert loss == pytest.approx(mine["losses"][0], rel=1e-5)
    # the gradient as the port's optimizer got it (Adam's first moment
    # over 1 - beta1) against the reference's clipped gradient; the
    # parameters are not compared element by element: Adam moves a
    # rounding-small gradient's element by the learning rate either way
    norms = {n: float(g.norm()) for n, g in mine["grads"].items()}
    median = float(np.median(list(norms.values())))
    for name, mu in zip(trainer.param_names, trainer.opt.slots["mu"]):
        diff = float((mu / (1 - trainer.opt.B1) - mine["grads"][name]).norm())
        assert diff <= 1e-4 * max(norms[name], median), name
