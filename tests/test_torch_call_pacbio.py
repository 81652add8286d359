"""PacBio calling: the port writes what hello_tpu writes (CPU).

The single-tech ``pacbio`` (``--pacbio``, 6 channels) and ``pacbio_hp``
(``--pacbio --include_hp``, 7 channels with the haplotag) configs call
simulated PacBio genomes (as tests/test_platforms_e2e.py's) through
hello_tpu's ``call_region`` (coded wire, packed-row convolution) and the
port's (``device="cpu"``, packed-row convolution forced on) with the same
weights.  Records agree in chrom, pos, ref, alt and GT, with qual within
1e-3 (rtol and atol, as tests/test_torch_call.py).
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

# config -> (genome length, coverage, haplotags, seed)
DATASETS = {"pacbio": (20_000, 25, False, 11),
            "pacbio_hp": (15_000, 45, True, 29)}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def reference(request, tmp_path_factory):
    """(config name, dataset, hello_tpu's records, params, state)."""
    name = request.param
    length, coverage, hp, seed = DATASETS[name]
    jax_layers.set_precision("highest")
    ds = sim.make_dataset(str(tmp_path_factory.mktemp(name)),
                          ref_length=length, num_variants=10,
                          coverage=coverage, read_length=120, seed=seed,
                          platforms=("pacbio",), pacbio_read_length=2000,
                          hp_tags=hp)
    mp = pytest.MonkeyPatch()
    mp.setenv("HELLO_TPU_PACKED_CONV", "1")
    try:
        scorer = jax_call.load_scorer(name)
    finally:
        mp.undo()
    assert scorer.packed_conv
    records = jax_call.call_region([ds.bams["pacbio"]], FastaFile(ds.fasta),
                                   ds.chromosome, 0, length, scorer,
                                   pacbio=True, include_hp=hp)
    params = jax.tree_util.tree_map(np.asarray, scorer.params)
    state = jax.tree_util.tree_map(np.asarray, scorer.state)
    return name, ds, records, params, state


def _assert_same_records(got, want):
    assert len(got) == len(want) >= 5
    for a, b in zip(got, want):
        assert (a.chromosome, a.position, a.ref, a.alt, a.gt) == \
               (b.chromosome, b.position, b.ref, b.alt, b.gt)
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)


def test_call_region_matches_jax(reference):
    name, ds, want, params, state = reference
    model = create_model(name)
    model.load_state_dict(state_dict_from_jax(model, params, state),
                          strict=True)
    scorer = call.Scorer(model, device="cpu", packed_conv=True)
    hp = DATASETS[name][2]
    assert scorer.folded["read_conv0"].in_channels == (7 if hp else 6)
    got = call.call_region([ds.bams["pacbio"]], FastaFile(ds.fasta),
                           ds.chromosome, 0, DATASETS[name][0], scorer,
                           pacbio=True, include_hp=hp)
    _assert_same_records(got, want)


def test_cli_matches_jax(reference, tmp_path):
    """``main --pacbio [--include_hp] --device cpu`` with a hello_tpu
    checkpoint writes the same calls."""
    from hello_tpu.train.checkpoint import save_checkpoint

    name, ds, want, params, state = reference
    ckpt = str(tmp_path / f"{name}.ckpt")
    save_checkpoint(ckpt, params, state)
    out = str(tmp_path / "port.vcf")
    flags = ["--include_hp"] if DATASETS[name][2] else []
    call.main(["--bam", ds.bams["pacbio"], "--ref", ds.fasta, "--out", out,
               "--model", name, "--checkpoint", ckpt, "--device", "cpu",
               "--pacbio", "--precision", "highest"] + flags)
    _assert_same_records(read_vcf(out), want)
