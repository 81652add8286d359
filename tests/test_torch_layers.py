"""The port's torch layers and weight bridge against hello_tpu (CPU).

Each network of the illumina config runs in hello_tpu (JAX ``Sequential.apply``)
and in the port (torch modules loaded through ``state_dict_from_jax``) on the
same numpy inputs; fp32 on both sides, so the only differences are summation
orders: rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax

from hello_tpu.nn import layers as jax_layers
from hello_tpu.nn.export import export_state_dict
from hello_tpu.nn.moe import create_model as jax_create_model
from hello_tpu_torch.nn.convert import (init_params, load_jax_checkpoint,
                                        state_dict_from_jax)
from hello_tpu_torch.nn.moe import create_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jax_layers.set_precision("highest")
    jm = jax_create_model("illumina")
    params, state = jm.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    tm = create_model("illumina")
    tm.load_state_dict(state_dict_from_jax(tm, params, state), strict=True)
    return jm, params, state, tm.eval()


def _inputs(name, rng, B=3):
    if name == "read_conv0":
        return rng.randint(0, 255, (B, 150, 6)).astype(np.float32)
    if name == "compressor0":
        return (rng.randn(B, 36, 64) * 10).astype(np.float32)
    frames = [(rng.randn(B, 18, 128) * 3).astype(np.float32) for _ in range(3)]
    return frames[0], (frames[1], frames[2])


def _to_torch(x):
    if isinstance(x, tuple):
        return tuple(_to_torch(t) for t in x)
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", ["read_conv0", "compressor0", "xattn0"])
def test_network_matches_jax(models, rng, name):
    jm, params, state, tm = models
    x = _inputs(name, rng)
    want, _ = jm.nets[name].apply(params[name], state.get(name, {}), x)
    with torch.no_grad():
        got = tm.net(name)(_to_torch(x))
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_state_dict_equals_export(models):
    """state_dict_from_jax == hello_tpu's export_state_dict key for key and
    value for value, and the port's module tree has exactly those keys."""
    jm, params, state, tm = models
    want = export_state_dict(jm, params, state)
    got = state_dict_from_jax(tm, params, state)
    assert sorted(got) == sorted(want)
    assert sorted(tm.state_dict()) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_jax_checkpoint_loads_without_jax_classes(models, tmp_path):
    """A hello_tpu pytree checkpoint (with optimizer state beside the
    params) loads into the port and reproduces the bridged weights."""
    import optax

    from hello_tpu.train.checkpoint import save_checkpoint

    jm, params, state, tm = models
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, params, state, opt_state=opt_state, step=3)
    fresh = create_model("illumina")
    fresh.load_state_dict(load_jax_checkpoint(path, fresh), strict=True)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_init_params_is_seeded_kaiming(models):
    a = init_params(create_model("illumina"), torch.Generator().manual_seed(5))
    b = init_params(create_model("illumina"), torch.Generator().manual_seed(5))
    c = init_params(create_model("illumina"), torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    conv = a.read_convolver0.network[0].conv1d     # 6 -> 16, k3
    bound = 1.0 / np.sqrt(6 * 3)
    assert conv.weight_v.abs().max() <= bound
    assert conv.bias.abs().max() <= bound
    norm = torch.sqrt((conv.weight_v ** 2).sum(dim=(1, 2), keepdim=True))
    torch.testing.assert_close(conv.weight_g, norm)


def test_model_forward_on_seeded_init_is_finite(rng):
    tm = init_params(create_model("illumina"), torch.Generator().manual_seed(0))
    batch = {
        "reads0": torch.from_numpy(rng.randint(0, 255, (4, 8, 150, 6)).astype(np.uint8)),
        "read_mask0": torch.ones(4, 8),
        "site_ids": torch.tensor([0, 0, 1, 1], dtype=torch.int32),
        "allele_mask": torch.ones(4),
        "ref_segments": torch.zeros(2, 150, 5),
    }
    with torch.no_grad():
        out = tm(batch)
    assert out["experts"].shape == (4, 1) and out["meta"] is None
    assert torch.isfinite(out["experts"]).all()
