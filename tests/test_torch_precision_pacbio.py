"""The port's bf16 against hello_tpu's on the ``pacbio`` config (CPU).

The card's precision sweep saw its largest bf16 quality delta on
``pacbio``.  Here the port and hello_tpu call the sweep's kind of genome
(PacBio reads, 32x, seed 11) with the same seeded weights at ``highest``
and at ``bf16``: at ``highest`` they agree to the qual's 1e-3; at ``bf16``
the port sits from hello_tpu no farther than bf16 sits from fp32 (p99 and
median dQ within twice hello_tpu's own bf16-against-highest dQ, no site
flips).  The largest dQ is left out: above Q57 it measures the device
decode's rounding (tests/test_torch_decode_quantization.py).

Run as a script for the sweep's size (``python
tests/test_torch_precision_pacbio.py --variants 5200``): it prints the four
comparisons and the logits of the port's worst site.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU)

from hello_tpu.io.fasta import FastaFile as JaxFasta  # noqa: E402
from hello_tpu.nn import layers as jax_layers  # noqa: E402
from hello_tpu.nn.moe import create_model as jax_create_model  # noqa: E402
from hello_tpu.pipeline import call as jax_call  # noqa: E402
from hello_tpu_torch import sim  # noqa: E402
from hello_tpu_torch.io.fasta import FastaFile  # noqa: E402
from hello_tpu_torch.nn import layers  # noqa: E402
from hello_tpu_torch.nn.convert import jax_params_from_state_dict  # noqa: E402
from hello_tpu_torch.pipeline.call import call_region, load_scorer  # noqa: E402
from hello_tpu_torch.pipeline.precision_sweep import compare  # noqa: E402

torch.set_num_threads(1)


def call_both(d, variants, seed=11):
    """{(package, precision): records} for a pacbio genome of ``variants``
    variants, the port's seed-0 weights on both sides."""
    ds = sim.make_dataset(d, ref_length=variants * 310, num_variants=variants,
                          coverage=32.0, read_length=120, seed=seed,
                          platforms=("pacbio",))
    bam = [ds.bams["pacbio"]]
    layers.set_precision("highest")
    params, state = jax_params_from_state_dict(
        load_scorer("pacbio", seed=0, device="cpu").model)
    out = {}
    try:
        for precision in ("highest", "bf16"):
            layers.set_precision(precision)
            ref = FastaFile(ds.fasta)
            out["port", precision] = call_region(
                bam, ref, ds.chromosome, 0, ref.length(ds.chromosome),
                load_scorer("pacbio", seed=0, device="cpu"), pacbio=True)
            jax_layers.set_precision(precision)
            jref = JaxFasta(ds.fasta)
            out["jax", precision] = jax_call.call_region(
                bam, jref, ds.chromosome, 0, jref.length(ds.chromosome),
                jax_call.Scorer(jax_create_model("pacbio"), params, state),
                pacbio=True)
    finally:
        layers.set_precision("highest")
        jax_layers.set_precision("highest")
    return ds, out


def summaries(out):
    rows = {}
    for name, a, b in (
            ("port bf16 vs port highest", ("port", "highest"), ("port", "bf16")),
            ("jax bf16 vs jax highest", ("jax", "highest"), ("jax", "bf16")),
            ("port highest vs jax highest", ("jax", "highest"),
             ("port", "highest")),
            ("port bf16 vs jax bf16", ("jax", "bf16"), ("port", "bf16"))):
        site_flips, gt_flips, dq = compare(out[a], out[b])
        rows[name] = {"records": len(out[b]), "site_flips": site_flips,
                      "gt_flips": gt_flips, "dq_max": float(dq.max()),
                      "dq_p99": float(np.percentile(dq, 99)),
                      "dq_median": float(np.median(dq)),
                      "dq_over_0.5": int((dq > 0.5).sum())}
    return rows


def test_port_bf16_moves_quals_as_hello_tpu_bf16_does(tmp_path):
    _, out = call_both(str(tmp_path), variants=300)
    rows = summaries(out)
    assert all(r["site_flips"] == 0 for r in rows.values()), rows
    same = rows["port highest vs jax highest"]
    assert same["gt_flips"] == 0 and same["dq_max"] <= 1e-2, rows
    own, cross = rows["jax bf16 vs jax highest"], rows["port bf16 vs jax bf16"]
    assert own["dq_p99"] > 0, rows
    assert cross["dq_p99"] <= 2 * own["dq_p99"], rows
    assert cross["dq_median"] <= 2 * own["dq_median"], rows


def _worst_site_logits(ds, out):
    """The port's worst bf16 site: its single-expert logits under each
    package and precision (scored alone, host decode)."""
    from hello_tpu_torch.pipeline.batching import pack_sites
    from hello_tpu_torch.pipeline.call import Scorer
    from hello_tpu_torch.pipeline.parallel_call import host_sites_for_chunk
    from hello_tpu_torch.nn.moe import create_model

    hi = {r.position: r for r in out["port", "highest"]}
    pos = max((abs(hi[r.position].qual - r.qual), r.position)
              for r in out["port", "bf16"] if r.position in hi)[1]
    site = next(s for s in host_sites_for_chunk(
        [ds.bams["pacbio"]], ds.fasta, ds.chromosome, max(0, pos - 1500),
        pos + 1500, {"pacbio": True}) if s.start == pos)
    batch = pack_sites([site], hybrid=False)
    base = load_scorer("pacbio", seed=0, device="cpu").model
    params, state = jax_params_from_state_dict(base)
    logits = {}
    try:
        for precision in ("highest", "bf16"):
            layers.set_precision(precision)
            jax_layers.set_precision(precision)
            model = create_model("pacbio")
            model.load_state_dict(base.state_dict())
            logits["port", precision] = Scorer(model, device="cpu")(batch)[0]
            logits["jax", precision] = jax_call.Scorer(
                jax_create_model("pacbio"), params, state)(batch)[0]
    finally:
        layers.set_precision("highest")
        jax_layers.set_precision("highest")
    return pos, site.alleles, {f"{k[0]} {k[1]}": np.asarray(v)[:len(
        site.alleles), 0].tolist() for k, v in logits.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", type=int, default=5200)
    args = parser.parse_args(argv)
    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        ds, out = call_both(d, args.variants)
        for name, row in summaries(out).items():
            print(json.dumps({"comparison": name, **row}), flush=True)
        pos, alleles, logits = _worst_site_logits(ds, out)
        print(json.dumps({"worst_port_site": pos, "alleles": alleles,
                          "logits": logits}), flush=True)


if __name__ == "__main__":
    main()
