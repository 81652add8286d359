"""Hybrid (Illumina + PacBio) calling: the port writes what hello_tpu writes
(CPU).

A simulated two-platform genome (12 kb, as tests/test_platforms_e2e.py's
hybrid test) is called by hello_tpu's ``call_region`` (coded wire,
packed-row convolution) and by the port's (``device="cpu"``, packed-row
convolution forced on, so both read convolvers run their plain version over
packed rows) with the same ``hybrid`` weights: three experts and the
meta-expert.  Records agree in chrom, pos, ref, alt and GT, with qual within
1e-3 (rtol and atol, as tests/test_torch_call.py).  The CLI takes the two
BAMs comma-separated with a hello_tpu checkpoint.  ``provide_experts``
(``--provide_features``) writes the same per-expert, best and mean VCFs,
choices.bed and features pickle.  Coded wire is compared with coded wire
only.
"""

import pickle

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

REF_LENGTH = 12_000


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Simulated two-platform dataset, hello_tpu's packed-conv scorer and its
    (params, state) as numpy."""
    jax_layers.set_precision("highest")
    out = tmp_path_factory.mktemp("hybrid")
    ds = sim.make_dataset(str(out), ref_length=REF_LENGTH, num_variants=10,
                          coverage=25, read_length=120, seed=13,
                          platforms=("illumina", "pacbio"),
                          pacbio_read_length=1500)
    mp = pytest.MonkeyPatch()
    mp.setenv("HELLO_TPU_PACKED_CONV", "1")
    try:
        scorer = jax_call.load_scorer("hybrid")
    finally:
        mp.undo()
    assert scorer.packed_conv
    params = jax.tree_util.tree_map(np.asarray, scorer.params)
    state = jax.tree_util.tree_map(np.asarray, scorer.state)
    return ds, scorer, params, state


def _bams(ds):
    return [ds.bams["illumina"], ds.bams["pacbio"]]


def _port_scorer(params, state):
    model = create_model("hybrid")
    model.load_state_dict(state_dict_from_jax(model, params, state),
                          strict=True)
    return call.Scorer(model, device="cpu", packed_conv=True)


def _assert_same_records(got, want, at_least=5):
    assert len(got) == len(want) >= at_least
    for a, b in zip(got, want):
        assert (a.chromosome, a.position, a.ref, a.alt, a.gt) == \
               (b.chromosome, b.position, b.ref, b.alt, b.gt)
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("hybrid_hotspot", [False, True],
                         ids=["joint", "hybrid_hotspot"])
def test_call_region_matches_jax(reference, hybrid_hotspot):
    ds, jax_scorer, params, state = reference
    ref = FastaFile(ds.fasta)
    want = jax_call.call_region(_bams(ds), ref, ds.chromosome, 0, REF_LENGTH,
                                jax_scorer, hybrid_hotspot=hybrid_hotspot)
    scorer = _port_scorer(params, state)
    assert scorer.model.hybrid and scorer.packed_conv
    stats = {}
    got = call.call_region(_bams(ds), ref, ds.chromosome, 0, REF_LENGTH,
                           scorer, hybrid_hotspot=hybrid_hotspot, stats=stats)
    assert stats["sites"] >= stats["records"] == len(got)
    _assert_same_records(got, want)


def test_cli_two_bams_matches_jax(reference, tmp_path):
    """``main --bam illumina.bam,pacbio.bam --model hybrid --device cpu``
    with a hello_tpu pytree checkpoint writes hello_tpu's calls (CPU
    default: the coded wire expanded to the dense grid)."""
    from hello_tpu.train.checkpoint import save_checkpoint

    ds, jax_scorer, params, state = reference
    want = jax_call.call_region(_bams(ds), FastaFile(ds.fasta),
                                ds.chromosome, 0, REF_LENGTH, jax_scorer)
    ckpt = str(tmp_path / "hybrid.ckpt")
    save_checkpoint(ckpt, params, state)
    out = str(tmp_path / "port.vcf")
    call.main(["--bam", ",".join(_bams(ds)), "--ref", ds.fasta, "--out", out,
               "--model", "hybrid", "--checkpoint", ckpt, "--device", "cpu",
               "--precision", "highest"])
    _assert_same_records(read_vcf(out), want)


def _assert_same_features(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("chromosome", "position", "length", "alleles",
                    "bestPair"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["quality"], w["quality"], rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_allclose(g["meta"], w["meta"], rtol=1e-4,
                                   atol=1e-4)
        assert len(g["expertPredictions"]) == len(w["expertPredictions"]) == 3
        for ge, we in zip(g["expertPredictions"], w["expertPredictions"]):
            assert list(ge) == list(we)
            np.testing.assert_allclose([float(v) for v in ge.values()],
                                       [float(v) for v in we.values()],
                                       rtol=1e-4, atol=1e-4)


def test_provide_features_streams_match_jax(reference, tmp_path):
    """Every stream ``provide_experts`` writes: the main, expert 0/1/2, best
    and mean VCFs record for record, choices.bed line for line, and the
    features pickle (meta and per-expert pair probabilities within 1e-4)."""
    ds, jax_scorer, params, state = reference
    regions = [(ds.chromosome, 0, REF_LENGTH)]
    want_vcf = str(tmp_path / "jax.vcf")
    jax_call.call_genome(_bams(ds), ds.fasta, jax_scorer, want_vcf,
                         regions=regions, provide_experts=True)
    got_vcf = str(tmp_path / "port.vcf")
    call.call_genome(_bams(ds), ds.fasta, _port_scorer(params, state),
                     got_vcf, regions=regions, provide_experts=True)
    for suffix in ("", ".expert0", ".expert1", ".expert2", ".best", ".mean"):
        _assert_same_records(read_vcf(str(tmp_path / f"port{suffix}.vcf")),
                             read_vcf(str(tmp_path / f"jax{suffix}.vcf")),
                             at_least=1)
    got = (tmp_path / "port.choices.bed").read_text().splitlines()
    want = (tmp_path / "jax.choices.bed").read_text().splitlines()
    assert got == want and len(want) > 0
    with open(tmp_path / "port.features.pkl", "rb") as fh:
        got = pickle.load(fh)
    with open(tmp_path / "jax.features.pkl", "rb") as fh:
        want = pickle.load(fh)
    _assert_same_features(got, want)
