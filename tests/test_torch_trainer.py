"""The port's one-device Trainer against hello_tpu's (CPU, ``highest``).

Full-width ``illumina`` (binary loss, no meta-expert), a small batch (8
allele slots, 2 read slots, as tests/test_train.py:151), the same initial
parameters on both sides (hello_tpu's seeded init carried over with
``state_dict_from_jax``):

  * one step's loss within rtol 1e-6 and every leaf's gradient within
    rtol 1e-4, with an atol of 1e-5 of the leaf's largest entry (entries
    that cancel to near zero);
  * the parameters after 3 steps of Adam, SGD and SGDR within rtol 1e-4
    plus an atol of a tenth of the leaf's largest 3-step move (Adam divides
    each gradient by its running RMS, so an entry whose gradient sits near
    its eps, 1e-8, turns fp32 noise into a sizeable part of an update:
    measured 6% of the leaf's largest move for Adam, 1.5% for SGD);
  * a coded-wire step equal to the dense step it encodes, padding
    invariance, checkpoints read both ways, build_on_top, the NaN crash
    dump, remat, and the train-mode forward against the eval forward.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__ as ge  # noqa: E402

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn import moe as jax_moe  # noqa: E402
from hello_tpu.parallel.mesh import data_mesh  # noqa: E402
from hello_tpu.pipeline.batching import stack_device_batches  # noqa: E402
from hello_tpu.train import trainer as jax_trainer  # noqa: E402
from hello_tpu_torch.nn import archs, moe  # noqa: E402
from hello_tpu_torch.nn.convert import (init_params,  # noqa: E402
                                        jax_params_from_state_dict,
                                        state_dict_from_jax)
from hello_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    """A labelled batch, stacked for one device, and hello_tpu's trainer
    (seed 3) with its initial parameters as numpy."""
    jax_layers.set_precision("highest")
    batch = ge._example_batch(np.random.RandomState(5), hybrid=False,
                              A=8, R=2, S=4, labels=True)
    stacked = stack_device_batches([batch])
    jt = jax_trainer.Trainer(jax_moe.create_model("illumina"),
                             jax_trainer.TrainConfig(binary=True),
                             mesh=data_mesh(1), seed=3)
    return stacked, jt, jax.tree_util.tree_map(np.asarray, jt.params)


def _port(params, name="illumina", **cfg):
    tm = moe.create_model(name)
    return Trainer(tm, TrainConfig(**cfg), device="cpu",
                   params=state_dict_from_jax(tm, params, {}))


def _as_sd(model, tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        model, jax.tree_util.tree_map(np.asarray, tree), {}).items()}


def _leaf_close(got, want, rtol=1e-4, scale=1e-5):
    atol = scale * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, 1e-30))


def test_step_loss_and_grads_match_hello_tpu(reference):
    stacked, jt, params = reference
    want_loss, want_grads = jt.compute_grads(stacked)
    tt = _port(params, binary=True)
    loss, grads = tt.compute_grads(stacked)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    want = _as_sd(tt.model, want_grads)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        _leaf_close(g.numpy(), want[k])


@pytest.mark.parametrize("optimizer", ["Adam", "SGD", "SGDR"])
def test_three_steps_match_hello_tpu(reference, optimizer):
    stacked, _, params = reference
    cfg = dict(binary=True, optimizer=optimizer, steps_per_epoch=2, t0=1,
               lr=1e-3 if optimizer == "Adam" else 1e-2)
    jt = jax_trainer.Trainer(jax_moe.create_model("illumina"),
                             jax_trainer.TrainConfig(**cfg),
                             mesh=data_mesh(1), params=params, state={})
    tt = _port(params, **cfg)
    for _ in range(3):
        want = jt.train_batch(stacked)["loss"]
        got = tt.train_batch(stacked)["loss"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tt.step == jt.step == 3 and tt.opt.count == 3
    start = _as_sd(tt.model, params)
    want = _as_sd(tt.model, jt.params)
    for k, v in tt.model.state_dict().items():
        move = float(np.abs(want[k] - start[k]).max())
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4,
                                   atol=0.1 * move + 1e-30, err_msg=k)


@pytest.fixture(scope="module")
def labeled_sites(tmp_path_factory):
    """24 real sites of a simulated genome (the port's host engine), with
    alternating labels, as tests/test_train_wire.py builds them."""
    from hello_tpu_torch import sim
    from hello_tpu_torch.pipeline.parallel_call import host_sites_for_chunk

    out = tmp_path_factory.mktemp("wire")
    ds = sim.make_dataset(str(out), ref_length=30_000, num_variants=60,
                          coverage=30, read_length=120, seed=9)
    sites = host_sites_for_chunk([ds.bams["illumina"]], ds.fasta,
                                 ds.chromosome, 0, 30_000, {})[:24]
    assert len(sites) == 24
    for i, s in enumerate(sites):
        s.labels = [(i + j) % 2 for j in range(len(s.alleles))]
        s.site_label = 0
    return sites


def test_wire_step_matches_dense(labeled_sites):
    from hello_tpu_torch.pipeline.batching import (pack_sites,
                                                   stack_device_batches as stack,
                                                   training_dict)
    from hello_tpu_torch.pipeline.compact import (encode_chunk_sites,
                                                  pack_sites_wire,
                                                  stack_wire_batches,
                                                  training_wire_dict)

    dense_d = training_dict(pack_sites(labeled_sites, hybrid=False))
    wire_d = training_wire_dict(pack_sites_wire(
        encode_chunk_sites(labeled_sites), hybrid=False))
    cfg = dict(binary=True, entropy_regularizer=0.1)
    trainers = []
    for stacked in (stack([dense_d]), stack_wire_batches([wire_d])):
        tm = moe.create_model("illumina")
        trainers.append(Trainer(tm, TrainConfig(**cfg), device="cpu", seed=7))
        trainers[-1].metrics = trainers[-1].train_batch(stacked)
    t_dense, t_wire = trainers
    np.testing.assert_allclose(t_wire.metrics["loss"], t_dense.metrics["loss"],
                               rtol=1e-6)
    for a, b in zip(t_dense.params, t_wire.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=2e-5, atol=1e-7)
    # evaluate() takes wire batches too
    np.testing.assert_allclose(t_dense.evaluate([wire_d]),
                               t_dense.evaluate([dense_d]), rtol=1e-6)


def test_padding_invariance(labeled_sites):
    """The same sites packed into wider allele, read and site buckets give
    the same loss and gradients: padded alleles and padding rows contribute
    nothing."""
    from hello_tpu_torch.pipeline.batching import (pack_sites,
                                                   stack_device_batches as stack,
                                                   training_dict)

    sites = labeled_sites[:6]
    tight = pack_sites(sites, hybrid=False)
    wide = pack_sites(sites, hybrid=False,
                      read_buckets=(2 * tight.reads0.shape[1],),
                      allele_buckets=(tight.reads0.shape[0] + 16,),
                      site_buckets=(tight.ref_segments.shape[0] + 8,))
    assert wide.reads0.shape[0] > tight.reads0.shape[0]
    out = []
    for batch in (tight, wide):
        tt = Trainer(moe.create_model("illumina"),
                     TrainConfig(binary=True), device="cpu", seed=4)
        out.append(tt.compute_grads(stack([training_dict(batch)])))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for k, g in out[0][1].items():
        _leaf_close(out[1][1][k].numpy(), g.numpy(), rtol=1e-5, scale=1e-6)


def test_checkpoint_written_by_the_port_loads_in_hello_tpu(reference,
                                                           tmp_path):
    """hello_tpu's load_scorer on the port's checkpoint gives the port
    scorer's logits (within 1e-4), and its params pytree has the structure
    of hello_tpu's own init."""
    from hello_tpu.pipeline import call as jax_call
    from hello_tpu.pipeline.batching import SiteWork, pack_sites
    from hello_tpu.train.checkpoint import load_checkpoint
    from hello_tpu_torch.pipeline.call import load_scorer

    stacked, _, params = reference
    tt = _port(params, binary=True)
    tt.train_batch(stacked)
    path = str(tmp_path / "port.ckpt")
    tt.save(path, extra={"epoch": 1})
    jp, js = load_checkpoint(path)
    assert js == {}
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(params))

    rng = np.random.RandomState(0)
    sites = [SiteWork("c", 10 * i, 10 * i + 1, ["A", "C"],
                      [rng.randint(0, 255, (3 + i, 150, 6)).astype(np.uint8)
                       for _ in range(2)],
                      None, np.eye(5, dtype=np.float32)[rng.randint(0, 5, 150)])
             for i in range(3)]
    batch = pack_sites(sites, hybrid=False)
    want, _ = jax_call.load_scorer("illumina", path)(batch)
    got, _ = load_scorer("illumina", path, device="cpu")(batch)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_checkpoint_written_by_hello_tpu_loads_in_the_port(reference,
                                                           tmp_path):
    """hello_tpu's params round-trip exactly through the port's state dict;
    its optax moments are refused by the port's full-state restore."""
    from hello_tpu.train.checkpoint import save_checkpoint
    from hello_tpu_torch.train.checkpoint import load_checkpoint

    stacked, jt, params = reference
    path = str(tmp_path / "jax.ckpt")
    save_checkpoint(path, params, {}, jt.opt_state, step=5)
    p, s = load_checkpoint(path)
    tm = moe.create_model("illumina")
    tm.load_state_dict(state_dict_from_jax(tm, p, s), strict=True)
    back, state = jax_params_from_state_dict(tm)
    assert state == {}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    tt = Trainer(moe.create_model("illumina"), TrainConfig(binary=True),
                 device="cpu")
    with pytest.raises(ValueError, match="optimizer state"):
        tt.restore(path)


def test_build_on_top_matches_hello_tpu():
    from hello_tpu.nn import archs as jax_archs
    from hello_tpu.train.transfer import build_on_top as jax_build
    from hello_tpu_torch.train.transfer import build_on_top

    base = jax_moe.MoEAttention(jax_archs.config_single_tech())
    bp, bs = base.init(jax.random.PRNGKey(7))
    ext = jax_moe.MoEAttention(jax_archs.config_single_tech(addendum=True))
    ep, es = ext.init(jax.random.PRNGKey(8))
    gp, gs = jax_build(base, bp, bs, ext, ep, es)

    tb = moe.create_model(archs.config_single_tech())
    te = moe.create_model(archs.config_single_tech(addendum=True))
    sd = build_on_top(tb, state_dict_from_jax(tb, jax.tree_util.tree_map(
        np.asarray, bp), {}), te, state_dict_from_jax(
        te, jax.tree_util.tree_map(np.asarray, ep), {}))
    want = state_dict_from_jax(te, jax.tree_util.tree_map(np.asarray, gp), {})
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy())


def test_nan_crash_dump(reference, tmp_path):
    stacked, _, _ = reference
    tt = Trainer(moe.create_model("illumina"), TrainConfig(binary=True),
                 device="cpu")
    with torch.no_grad():
        for p in tt.params:
            p.fill_(float("nan"))
    prefix = str(tmp_path / "crash")
    with pytest.raises(FloatingPointError):
        tt.train_batch(stacked, crash_dump_prefix=prefix)
    assert glob.glob(prefix + "*.err.ckpt")
    assert glob.glob(prefix + "*.payload.pkl")


def test_remat_matches_plain_step(reference):
    stacked, _, params = reference
    outs = {}
    for remat in (False, True):
        tt = _port(params, binary=True, remat=remat)
        loss = tt.train_batch(stacked)["loss"]
        outs[remat] = (loss, [p.detach().numpy().copy() for p in tt.params])
    np.testing.assert_allclose(outs[True][0], outs[False][0], rtol=1e-6)
    for a, b in zip(outs[False][1], outs[True][1]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def _packed(rng, A, R):
    counts = rng.randint(0, R + 1, size=A)
    row_allele = np.concatenate([np.full(c, a, np.int32)
                                 for a, c in enumerate(counts)]
                                + [np.full(3, A, np.int32)])
    return {"rows": rng.randint(0, 255, (len(row_allele), 150, 6)).astype(np.uint8),
            "row_allele": row_allele,
            "row_valid": (row_allele < A).astype(np.float32),
            "read_mask": np.zeros((A, R), np.uint8)}


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("name", ["illumina", "hybrid", "illumina_layer_norm"])
def test_train_forward_equals_eval_forward(name, layout):
    """A config with no BatchNorm and no Dropout: the train-mode forward
    (layers under autograd) equals the eval forward (the read-conv kernel's
    plain version on the CPU) within the kernel's tolerance.
    ``illumina_layer_norm``'s xattn terminus holds a BatchNorm: its train
    forward (masked batch statistics) and eval forward (running ones)
    differ, and each equals hello_tpu's forward in the same mode."""
    rng = np.random.RandomState(3)
    batch = ge._example_batch(rng, hybrid=name == "hybrid", A=6, R=3, S=3)
    if layout == "packed":
        for k in (0, 1) if name == "hybrid" else (0,):
            del batch[f"reads{k}"], batch[f"read_mask{k}"]
            batch.update({f"{key}{k}": v for key, v in
                          _packed(rng, 6, 3).items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if name == "illumina_layer_norm":
        jax_layers.set_precision("highest")
        jm = jax_moe.create_model(name)
        params, state = jm.init(jax.random.PRNGKey(2))
        tm = moe.create_model(name)
        tm.load_state_dict(state_dict_from_jax(
            tm, jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state)), strict=True)
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        outs = {}
        for train in (False, True):
            want, _ = jm.apply(params, state, jb, train=train)
            with torch.no_grad():
                got = tm.train(train)(tb)
            np.testing.assert_allclose(got["experts"].numpy(),
                                       np.asarray(want["experts"]),
                                       rtol=1e-4, atol=1e-4)
            outs[train] = got["experts"].numpy()
        assert np.abs(outs[True] - outs[False]).max() > 1e-2
        return
    tm = init_params(moe.create_model(name), torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = tm.eval()(tb)
        got = tm.train()(tb)
    np.testing.assert_allclose(got["experts"].numpy(),
                               want["experts"].numpy(), rtol=1e-4, atol=1e-4)
    if name == "hybrid":
        np.testing.assert_allclose(got["meta"].numpy(), want["meta"].numpy(),
                                   rtol=1e-4, atol=1e-4)
