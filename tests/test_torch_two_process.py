"""Two real processes training through the port's CLI over gloo (CPU).

The port's counterpart of tests/test_two_process.py: two OS processes run
``python -m hello_tpu_torch.train.cli --distributed --device cpu`` under
torchrun's env:// contract (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE,
LOCAL_RANK), so the rendezvous, the per-rank shard files, the per-batch
``all_ranks_have`` barrier, the flat all-reduce across process boundaries
and rank-0 checkpointing all run.  The final parameters must equal, bit
for bit, the port's serial emulation of the same two rank streams (one
process, k=2).  Against hello_tpu on its 2-device mesh, the first step's
checkpoint holds tests/test_two_process.py's bar (rtol 5e-3 / atol 1e-4)
on every entry; after four Adam steps, against its _emulate_serial, every
leaf stays within one lr a step, and the bar holds for all but a few
entries that Adam drives apart across frameworks (the test's comment gives
the numbers).  Then a two-rank
``compute_grads`` against one process at k=2, and ``--distributed``
without the environment raising at once.

This file stands alone so that pytest-xdist's ``--dist loadfile`` runs it
beside the rest.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, REPO)
sys.path.insert(0, TESTS)
import __graft_entry__ as ge  # noqa: E402
from test_two_process import (BATCH_ALLELES, EPOCHS, _emulate_serial,  # noqa: E402
                              _make_shards)

from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu_torch.parallel.mesh import ENV_CONTRACT  # noqa: E402

torch.set_num_threads(1)

TIMEOUT = 600
LR = 1e-3                  # _emulate_serial's and the CLI's learning rate
# the sites hold 3 to 11 reads: 16-read buckets train on the same rows as
# tests/test_two_process.py's 64 at a quarter of the dense grid (only the
# order of float sums over padding zeros differs)
READ_BUCKET = 16


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argvs, out_dir, tag):
    """Run one process per argv as ranks of a gloo group on a free port;
    returns (return codes, logs)."""
    port = _free_port()
    procs, logs = [], []
    try:
        for rank, argv in enumerate(argvs):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(rank),
                       WORLD_SIZE=str(len(argvs)), LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="1")
            log = open(os.path.join(out_dir, f"{tag}{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable] + argv, env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO))
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return rcs, outs


def _port_serial(files, start_sd):
    """The port's in-process emulation of the two-rank run: the same
    per-rank shard files, loader streams and seeds, the same barrier, the
    ranks' sub-batches stacked into one k=2 step (the port's loader is a
    byte-for-byte copy of hello_tpu's)."""
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.train.loader import (SiteDataset, device_batches,
                                              shard_files_for_ranks)
    from hello_tpu_torch.train.trainer import TrainConfig, Trainer

    per_rank, _ = shard_files_for_ranks(files, 2)
    rank_train = [rf[max(1, int(len(rf) * 0.1)):] for rf in per_rank]
    trainer = Trainer(create_model("illumina"), TrainConfig(binary=True),
                      device="cpu", num_devices=2, params=start_sd)
    fixed = {"read_bucket": READ_BUCKET, "allele_bucket": 64,
             "site_bucket": 32}
    for epoch in range(EPOCHS):
        iters = [iter(device_batches(
            SiteDataset(rt, 1000, shuffle=True, seed=13 + epoch), False, 1,
            BATCH_ALLELES, fixed_shape=fixed)) for rt in rank_train]
        while True:
            stacked = [next(it, None) for it in iters]
            if any(s is None for s in stacked):     # all_ranks_have barrier
                break
            trainer.train_batch({k: np.concatenate([stacked[0][k],
                                                    stacked[1][k]])
                                 for k in stacked[0]})
    return trainer


def _first_stacked(files):
    """The two ranks' first sub-batches of epoch 0, stacked, as
    tests/test_two_process.py's _emulate_serial makes them."""
    from hello_tpu.train.cli import model_input_channels
    from hello_tpu.nn.moe import create_model
    from hello_tpu.train.loader import (SiteDataset, device_batches,
                                        shard_files_for_ranks)

    per_rank, _ = shard_files_for_ranks(files, 2)
    fixed = {"read_bucket": 64, "allele_bucket": 64, "site_bucket": 32}
    channels = model_input_channels(create_model("illumina"))
    firsts = [next(iter(device_batches(
        SiteDataset(rf[max(1, int(len(rf) * 0.1)):], 1000, shuffle=True,
                    seed=13), False, 1, BATCH_ALLELES, channels=channels,
        fixed_shape=fixed))) for rf in per_rank]
    return {k: np.concatenate([np.asarray(firsts[0][k]),
                               np.asarray(firsts[1][k])]) for k in firsts[0]}


def test_two_process_cli_matches_serial_emulations(tmp_path):
    """The ranks start from hello_tpu's seed-13 initial parameters (the
    emulation's; the port's own seed-13 init differs), through --resume of
    a step-0 checkpoint without optimizer state."""
    from hello_tpu.nn.moe import create_model
    from hello_tpu.parallel.mesh import data_mesh
    from hello_tpu.train.checkpoint import load_full_checkpoint, save_checkpoint
    from hello_tpu.train.trainer import TrainConfig, Trainer
    from hello_tpu_torch.nn import moe
    from hello_tpu_torch.nn.convert import state_dict_from_jax

    jax_layers.set_precision("highest")
    files = _make_shards(tmp_path)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    init = str(tmp_path / "init.ckpt")
    # _emulate_serial's trainer: its seed-13 parameters start the ranks,
    # and its first step on the ranks' first sub-batches is the reference
    # for the CLI's first step
    start = Trainer(create_model("illumina"),
                    TrainConfig(lr=LR, optimizer="Adam", steps_per_epoch=1,
                                binary=True), seed=13, mesh=data_mesh(2))
    init_params = start.params
    save_checkpoint(init, init_params, {}, None, step=0)
    data_glob = os.path.join(os.path.dirname(files[0]), "*.index")
    # a prefix per rank shows which rank wrote what
    argvs = [["-m", "hello_tpu_torch.train.cli", "--data", data_glob,
              "--model", "illumina", "--out_prefix", str(out_dir / f"r{r}"),
              "--num_epochs", str(EPOCHS), "--batch_alleles",
              str(BATCH_ALLELES), "--read_bucket", str(READ_BUCKET),
              "--checkpoint_every", "1", "--resume", init, "--distributed",
              "--device", "cpu"]
             for r in range(2)]
    rcs, outs = _launch(argvs, str(out_dir), "rank")
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    assert "process 0/2" in outs[0], outs[0][-2000:]
    assert "process 1/2" in outs[1], outs[1][-2000:]
    assert "backend gloo" in outs[0]

    written = sorted(os.listdir(out_dir))
    assert not [f for f in written if f.startswith("r1.")], written
    for f in ["r0.final.ckpt", "r0.metrics.jsonl", "r0.step1.ckpt"] + [
            f"r0.epoch{e}.ckpt" for e in range(EPOCHS)]:
        assert f in written, written
    with open(out_dir / "r0.metrics.jsonl") as fh:
        assert len(fh.readlines()) == EPOCHS

    # the port's own serial emulation: the rendezvous, the barrier and the
    # flat all-reduce change nothing, bit for bit
    got = load_full_checkpoint(str(out_dir / "r0.final.ckpt"))
    tm = moe.create_model("illumina")
    to_sd = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, tree), {}).items()}
    got_sd = to_sd(got["params"])
    port = _port_serial(files, state_dict_from_jax(
        tm, jax.tree_util.tree_map(np.asarray, start.params), {}))
    assert got["step"] == port.step > 0
    for k, v in port.model.state_dict().items():
        np.testing.assert_array_equal(got_sd[k], v.numpy(), err_msg=k)

    # hello_tpu's first step on its 2-device mesh: every entry within
    # tests/test_two_process.py's bar (rtol 5e-3 / atol 1e-4)
    start.train_batch(_first_stacked(files))
    first_sd = to_sd(load_full_checkpoint(str(out_dir / "r0.step1.ckpt"))
                     ["params"])
    for k, w in to_sd(start.params).items():
        np.testing.assert_allclose(first_sd[k], w, rtol=5e-3, atol=1e-4,
                                   err_msg=k)

    # hello_tpu's emulation of the whole run.  Over four Adam steps (loss
    # 1.8 -> 17 -> 5.6 -> 1.8) the two frameworks' float noise in the summed
    # gradients (about 5e-6 of a leaf's largest entry) turns entries whose
    # moments cancel into updates of either sign.  Adam moves an entry by
    # about lr a step, so such an entry ends at most a few lr away, and
    # every leaf must stay within one lr a step of hello_tpu's (measured
    # 2.4e-3 at most).  Besides: every leaf has at least 90% of its entries
    # within the bar (measured 94.5% in the worst, a 128-entry bias), all
    # leaves together 99.5% (measured 99.8%), and the logits of a fixed
    # batch agree within a tenth of the training's own move of them
    # (measured 0.0186 against a move of 1.19).
    ref = _emulate_serial(files)
    assert got["step"] == ref.step
    off_total = 0
    for k, w in to_sd(ref.params).items():
        worst = float(np.abs(got_sd[k] - w).max())
        assert worst <= LR * ref.step, (k, worst)
        off = int((~np.isclose(got_sd[k], w, rtol=5e-3, atol=1e-4)).sum())
        assert off <= 0.1 * w.size, (k, off, w.size)
        off_total += off
    total = sum(v.size for v in got_sd.values())
    print(f"entries beyond rtol 5e-3 / atol 1e-4: {off_total} of {total}")
    assert off_total <= 0.005 * total
    model = create_model("illumina")
    batch = ge._example_batch(np.random.RandomState(3), hybrid=False)
    logits = {}
    for name, params in (("got", got["params"]), ("ref", ref.params),
                         ("start", init_params)):
        out, _ = model.apply(params, {}, batch)
        logits[name] = np.asarray(out["experts"])
    moved = float(np.abs(logits["ref"] - logits["start"]).max())
    diff = float(np.abs(logits["got"] - logits["ref"]).max())
    print(f"logits: port vs hello_tpu {diff}, training's move {moved}")
    assert diff <= 0.1 * moved


_GRADS_RANK = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.parallel import mesh
from hello_tpu_torch.train.trainer import TrainConfig, Trainer
batch_path, out_path = sys.argv[1:3]
device = mesh.init_distributed("cpu")
stacked = dict(np.load(batch_path))
r = mesh.rank()
trainer = Trainer(create_model("illumina"), TrainConfig(binary=True),
                  device=device, seed=100 + r)
loss, grads = trainer.compute_grads({k: v[r:r + 1] for k, v in stacked.items()})
if r == 0:
    np.savez(out_path, loss=loss, **{k: g.numpy() for k, g in grads.items()})
mesh.destroy_distributed()
"""


def test_two_rank_compute_grads_equals_one_process_at_two(tmp_path):
    """Each rank takes one sub-batch (and a different seed: the trainer
    starts every rank from rank 0's parameters); the summed loss and
    gradients equal one process's k=2 step on both."""
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.batching import stack_device_batches
    from hello_tpu_torch.train.trainer import TrainConfig, Trainer

    rng = np.random.RandomState(5)
    stacked = stack_device_batches(
        [ge._example_batch(rng, hybrid=False, A=8, R=2, S=4, labels=True)
         for _ in range(2)])
    batch_path = str(tmp_path / "batch.npz")
    np.savez(batch_path, **stacked)
    out_path = str(tmp_path / "grads.npz")
    rcs, outs = _launch([["-c", _GRADS_RANK, batch_path, out_path]] * 2,
                        str(tmp_path), "grads")
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in outs)
    got = dict(np.load(out_path))

    one = Trainer(create_model("illumina"), TrainConfig(binary=True),
                  device="cpu", seed=100, num_devices=2)
    loss, grads = one.compute_grads(stacked)
    np.testing.assert_allclose(float(got.pop("loss")), loss, rtol=1e-6)
    assert sorted(got) == sorted(grads)
    for k, g in grads.items():
        want = g.numpy()
        np.testing.assert_allclose(
            got[k], want, rtol=1e-4,
            atol=max(1e-5 * float(np.abs(want).max()), 1e-30), err_msg=k)


@pytest.mark.parametrize("unset", ENV_CONTRACT)
def test_distributed_without_the_environment_raises(tmp_path, monkeypatch,
                                                    unset):
    from hello_tpu_torch.train.cli import main

    for k in ENV_CONTRACT:
        monkeypatch.setenv(k, "0" if k != "WORLD_SIZE" else "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.delenv(unset)
    index = tmp_path / "x.index"
    index.write_bytes(b"")
    with pytest.raises(RuntimeError, match=unset):
        main(["--data", str(index), "--out_prefix", str(tmp_path / "m"),
              "--model", "illumina", "--device", "cpu", "--distributed"])
