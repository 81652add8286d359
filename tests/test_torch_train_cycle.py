"""The port's own data -> training -> calling cycle, at one device on the
CPU (tests/test_train_call_cycle.py:20 and tests/test_train.py:309 run on
the port).

Simulate a genome, dump labelled shards with the port's ``dump_region``,
train full-width ``illumina`` with the port's ``train_from_shards``
(``device="cpu"``), load ``.final.ckpt`` with the port's ``load_scorer`` and
call: the calls recover the planted truth exactly.  Resuming from a
checkpoint (at an epoch boundary or mid-epoch) replays the uninterrupted
run bit for bit, and the overlapped loop (staging on the prefetch thread,
losses read one step late) equals the plain one.
"""

import glob

import numpy as np
import pytest
import torch

from hello_tpu_torch import sim
from hello_tpu_torch.io.fasta import FastaFile
from hello_tpu_torch.io.vcf import left_align_normalize, read_vcf
from hello_tpu_torch.pipeline.dump import dump_region
from hello_tpu_torch.train.checkpoint import load_full_checkpoint
from hello_tpu_torch.train.cli import train_from_shards

torch.set_num_threads(1)


def _canonical(records, ref):
    lookup = lambda c, p: ref.fetch(c, p, p + 1)
    out = {}
    for r in records:
        for alt in r.alt:
            pos, ra, aa = left_align_normalize(
                r.chromosome, r.position, r.ref, alt, lookup)
            out[(pos, ra, aa)] = tuple(sorted(r.gt))
    return out


def _dump(tmp_path, length, variants, coverage, seed):
    ds = sim.make_dataset(str(tmp_path), ref_length=length,
                          num_variants=variants, coverage=coverage,
                          read_length=120, seed=seed)
    bed = str(tmp_path / "conf.bed")
    with open(bed, "w") as fh:
        fh.write(f"{ds.chromosome}\t0\t{length}\n")
    ref = FastaFile(ds.fasta)
    shards = dump_region([ds.bams["illumina"]], ref, ds.chromosome, 0, length,
                         ds.truth_vcf, bed, str(tmp_path / "dump"))
    assert shards
    return ds, ref, shards


def test_train_then_call_recovers_truth(tmp_path):
    from hello_tpu_torch.pipeline.call import call_region, load_scorer

    ds, ref, shards = _dump(tmp_path, 8000, 16, 30, seed=9)
    train_from_shards(shards, "illumina", str(tmp_path / "model"),
                      num_epochs=4, lr=1e-3, batch_alleles=16,
                      read_bucket=32, max_reads_per_site=32,
                      val_fraction=0.0, device="cpu")
    scorer = load_scorer("illumina", str(tmp_path / "model.final.ckpt"),
                         device="cpu")
    records = call_region([ds.bams["illumina"]], ref, ds.chromosome, 0, 8000,
                          scorer)
    called = _canonical(records, ref)
    truth = _canonical(read_vcf(ds.truth_vcf), ref)
    assert not set(truth) - set(called), "missed"
    assert not set(called) - set(truth), "spurious"
    assert all(called[k] == truth[k] for k in truth), "wrong genotypes"


@pytest.fixture(scope="module")
def resume_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    return _dump(tmp, 6000, 10, 25, seed=17)[2]


KW = dict(lr=1e-3, batch_alleles=16, read_bucket=32, max_reads_per_site=32,
          val_fraction=0.0, device="cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _params_equal(a_path, b_path):
    a = load_full_checkpoint(a_path)
    b = load_full_checkpoint(b_path)
    assert a["step"] == b["step"] > 0
    la, lb = list(_leaves(a["params"])), list(_leaves(b["params"]))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    for slot in ("mu", "nu"):
        for k, v in a["opt_state"][slot].items():
            np.testing.assert_array_equal(v, b["opt_state"][slot][k])


def test_full_state_resume_replays_identical_run(resume_shards, tmp_path):
    train_from_shards(resume_shards, "illumina", str(tmp_path / "full"),
                      num_epochs=3, **KW)
    train_from_shards(resume_shards, "illumina", str(tmp_path / "part"),
                      num_epochs=2, **KW)
    train_from_shards(resume_shards, "illumina", str(tmp_path / "part"),
                      num_epochs=3, resume=str(tmp_path / "part.epoch1.ckpt"),
                      **KW)
    _params_equal(str(tmp_path / "full.final.ckpt"),
                  str(tmp_path / "part.final.ckpt"))


def test_mid_epoch_resume_replays_identical_run(resume_shards, tmp_path):
    train_from_shards(resume_shards, "illumina", str(tmp_path / "full"),
                      num_epochs=2, **KW)
    train_from_shards(resume_shards, "illumina", str(tmp_path / "part"),
                      num_epochs=2, checkpoint_every=1, **KW)
    mid = next(p for p in sorted(glob.glob(str(tmp_path / "part.step*.ckpt")))
               if load_full_checkpoint(p)["extra"]["batches_done"] > 0)
    train_from_shards(resume_shards, "illumina", str(tmp_path / "resumed"),
                      num_epochs=2, resume=mid, **KW)
    _params_equal(str(tmp_path / "full.final.ckpt"),
                  str(tmp_path / "resumed.final.ckpt"))


def test_overlapped_loop_equals_plain_loop(resume_shards, tmp_path):
    for overlap, name in ((False, "plain"), (True, "olap")):
        train_from_shards(resume_shards, "illumina", str(tmp_path / name),
                          num_epochs=1, overlap=overlap, **KW)
    _params_equal(str(tmp_path / "plain.final.ckpt"),
                  str(tmp_path / "olap.final.ckpt"))
