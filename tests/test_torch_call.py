"""End to end: the port's caller writes the records hello_tpu's writes (CPU).

hello_tpu's ``call_region`` (coded wire, packed-row convolution) and the
port's (``device="cpu"``, packed-row convolution forced on, so the packed
path and its plain read-convolver version run) call the same simulated
genome with the same weights.  Records must agree in chrom, pos, ref, alt and
GT, with qual within 1e-3 (rtol and atol, as tests/test_coded_wire.py holds
two scoring routes to each other: qual = -10 log10(1 - p) turns one fp32 ulp
of p into ~0.003 at Q40).  Coded wire is compared with coded wire only.
"""

import numpy as np
import pytest
import torch

import jax

from hello_tpu import sim
from hello_tpu.io.fasta import FastaFile
from hello_tpu.io.vcf import read_vcf
from hello_tpu.nn import layers as jax_layers
from hello_tpu.pipeline import call as jax_call
from hello_tpu_torch.nn.convert import state_dict_from_jax
from hello_tpu_torch.nn.moe import create_model
from hello_tpu_torch.pipeline import call

torch.set_num_threads(1)

REF_LENGTH = 20_000


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Simulated dataset, hello_tpu's records and its (params, state)."""
    jax_layers.set_precision("highest")
    out = tmp_path_factory.mktemp("e2e")
    ds = sim.make_dataset(str(out), ref_length=REF_LENGTH, num_variants=40,
                          coverage=20, read_length=120, seed=21)
    mp = pytest.MonkeyPatch()
    mp.setenv("HELLO_TPU_PACKED_CONV", "1")
    try:
        scorer = jax_call.load_scorer("illumina")
    finally:
        mp.undo()
    assert scorer.packed_conv
    records = jax_call.call_region([ds.bams["illumina"]], FastaFile(ds.fasta),
                                   ds.chromosome, 0, REF_LENGTH, scorer)
    params = jax.tree_util.tree_map(np.asarray, scorer.params)
    state = jax.tree_util.tree_map(np.asarray, scorer.state)
    return ds, records, params, state


def _assert_same_records(got, want):
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        assert (a.chromosome, a.position, a.ref, a.alt, a.gt) == \
               (b.chromosome, b.position, b.ref, b.alt, b.gt)
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)


def test_call_region_matches_jax(reference):
    ds, want, params, state = reference
    model = create_model("illumina")
    model.load_state_dict(state_dict_from_jax(model, params, state),
                          strict=True)
    scorer = call.Scorer(model, device="cpu", packed_conv=True)
    assert scorer.packed_conv and scorer.device_decode
    stats = {}
    got = call.call_region([ds.bams["illumina"]], FastaFile(ds.fasta),
                           ds.chromosome, 0, REF_LENGTH, scorer, stats=stats)
    assert stats["sites"] >= stats["records"] == len(got)
    _assert_same_records(got, want)


def test_cli_with_jax_checkpoint_matches_jax(reference, tmp_path):
    """``main --device cpu`` with a hello_tpu pytree checkpoint writes the
    same calls (CPU default: the coded wire expanded to the dense grid)."""
    from hello_tpu.train.checkpoint import save_checkpoint

    ds, want, params, state = reference
    ckpt = str(tmp_path / "illumina.ckpt")
    save_checkpoint(ckpt, params, state)
    out = str(tmp_path / "port.vcf")
    call.main(["--bam", ds.bams["illumina"], "--ref", ds.fasta, "--out", out,
               "--model", "illumina", "--checkpoint", ckpt, "--device", "cpu",
               "--precision", "highest"])
    _assert_same_records(read_vcf(out), want)
