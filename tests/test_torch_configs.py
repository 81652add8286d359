"""Every named config in the port (CPU): the eleven build, score, train and
evaluate, each read convolver on the route its topology gives it; and the
layer-route configs call a simulated genome as hello_tpu calls it.

  * every config: a Trainer step and ``evaluate`` on a labelled batch with
    padding (finite loss, batch-norm statistics moved only where the config
    has batch norm), and a Scorer's logits, with each read convolver's
    route: the kernel's for the six standard configs, ``layers`` for the
    wide, addendum and layer_norm variants (hello_tpu's ``supports_network``
    says the same);
  * ``illumina_layer_norm`` and ``illumina_wide`` end to end: hello_tpu's
    ``call_region`` with its seeded weights, and the port's calling CLI with
    those weights in the file hello_tpu's ``save_torch_checkpoint`` writes;
    records equal in chrom, pos, ref, alt and GT, qual within 1e-3 (rtol
    and atol, tests/test_torch_call.py's bar).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
import __graft_entry__ as ge  # noqa: E402

from hello_tpu import sim  # noqa: E402
from hello_tpu.io.fasta import FastaFile  # noqa: E402
from hello_tpu.io.vcf import read_vcf  # noqa: E402
from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn import moe as jax_moe  # noqa: E402
from hello_tpu.nn.export import save_torch_checkpoint  # noqa: E402
from hello_tpu.ops.read_conv import supports_network  # noqa: E402
from hello_tpu.pipeline import call as jax_call  # noqa: E402
from hello_tpu_torch import telemetry  # noqa: E402
from hello_tpu_torch.nn import archs, moe  # noqa: E402
from hello_tpu_torch.nn.convert import init_params  # noqa: E402
from hello_tpu_torch.pipeline import call  # noqa: E402
from hello_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.set_num_threads(1)

REF_LENGTH = 20_000
VARIANTS = ("illumina_wide", "illumina_addendum", "hybrid_no_ensemble_wide",
            "hybrid_no_ensemble_addendum", "illumina_layer_norm")


def test_eleven_named_configs():
    assert len(archs.NAMED_CONFIGS) == 11
    assert set(VARIANTS) < set(archs.NAMED_CONFIGS)


@pytest.mark.parametrize("name", sorted(archs.NAMED_CONFIGS))
def test_config_scores_trains_and_evaluates(name):
    tm = init_params(moe.create_model(name), torch.Generator().manual_seed(1))
    jm = jax_moe.create_model(name)
    params, _ = jm.init(jax.random.PRNGKey(0))
    routes = {k: f.route for k, f in tm.fold_read_convs().items()}
    want = {k: "tf32x3" if supports_network(jm, params, k) else "layers"
            for k in routes}
    assert routes == want
    assert (set(routes.values()) == {"layers"}) == (name in VARIANTS)

    rng = np.random.RandomState(2)
    C = 7 if name == "pacbio_hp" else 6
    batch = ge._example_batch(rng, hybrid=tm.hybrid, A=6, R=2, S=3, C=C,
                              labels=True)
    batch["allele_mask"][-1] = 0.0
    scorer = call.Scorer(tm, device="cpu")
    assert scorer.read_conv_routes() == routes
    with torch.no_grad():
        logits = scorer.model({k: torch.from_numpy(v) for k, v in
                               batch.items() if k != "labels"},
                              folded=scorer.folded)["experts"]
    assert torch.isfinite(logits).all()

    trainer = Trainer(tm, TrainConfig(binary=not tm.has_meta), device="cpu")
    before = [b.clone() for b in trainer.stats]
    from hello_tpu.pipeline.batching import stack_device_batches
    loss = trainer.train_batch(stack_device_batches([batch]))["loss"]
    assert np.isfinite(loss)
    assert len(before) == (2 if name == "illumina_layer_norm" else 0)
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer.stats))
    assert np.isfinite(trainer.evaluate([batch]))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("variants")
    return sim.make_dataset(str(out), ref_length=REF_LENGTH, num_variants=40,
                            coverage=20, read_length=120, seed=23)


@pytest.mark.parametrize("name", ["illumina_layer_norm", "illumina_wide"])
def test_cli_calls_as_hello_tpu_calls(dataset, name, tmp_path):
    jax_layers.set_precision("highest")
    mp = pytest.MonkeyPatch()
    mp.setenv("HELLO_TPU_PACKED_CONV", "1")
    try:
        scorer = jax_call.load_scorer(name)
    finally:
        mp.undo()
    assert not getattr(scorer.model, "pallas_read_convs", ())
    want = jax_call.call_region([dataset.bams["illumina"]],
                                FastaFile(dataset.fasta), dataset.chromosome,
                                0, REF_LENGTH, scorer)
    path = str(tmp_path / f"{name}.pt")
    save_torch_checkpoint(path, scorer.model, scorer.params, scorer.state)
    out = str(tmp_path / "port.vcf")
    before = telemetry.counts()
    call.main(["--bam", dataset.bams["illumina"], "--ref", dataset.fasta,
               "--out", out, "--model", name, "--checkpoint", path,
               "--device", "cpu", "--precision", "highest"])
    assert (telemetry.counts() - before)[
        ("read_conv", "read_conv0", "layers")] > 0
    got = read_vcf(out)
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        assert (a.chromosome, a.position, a.ref, a.alt, a.gt) == \
               (b.chromosome, b.position, b.ref, b.alt, b.gt)
        np.testing.assert_allclose(a.qual, b.qual, rtol=1e-3, atol=1e-3)
