"""The port's training-data dump and evaluation (byte-for-byte copies of
hello_tpu's host modules) against hello_tpu, on simulated genomes (CPU).

  * ``dump_region`` writes shards equal to hello_tpu's, array by array;
  * ``labels_to_vcf`` rebuilds the planted truth from the port's shards;
  * ``evaluate``, ``determine_max_q_loss`` and ``merge`` on a VCF the port
    called give hello_tpu's results;
  * a dump in the reference's MemmapperCompound format reads back through
    the port's ``ReferenceShardReader`` and ``open_shard`` as written.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from hello_tpu_torch import sim
from hello_tpu_torch.io.fasta import FastaFile
from hello_tpu_torch.io.vcf import left_align_normalize, read_vcf, write_vcf
from hello_tpu_torch.pipeline.dump import dump_region
from hello_tpu_torch.train.store import ShardReader

torch.set_num_threads(1)


def _bed(tmp_path, ds, length):
    bed = str(tmp_path / "conf.bed")
    with open(bed, "w") as fh:
        fh.write(f"{ds.chromosome}\t0\t{length}\n")
    return bed


def _canonical(records, ref):
    lookup = lambda c, p: ref.fetch(c, p, p + 1)
    out = {}
    for r in records:
        for alt in r.alt:
            pos, ra, aa = left_align_normalize(r.chromosome, r.position,
                                               r.ref, alt, lookup)
            out[(pos, ra, aa)] = tuple(sorted(r.gt))
    return out


def _assert_sites_equal(got, want):
    assert (got.chromosome, got.start, got.stop) == \
        (want.chromosome, want.start, want.stop)
    assert got.alleles == want.alleles
    assert got.labels == want.labels and got.site_label == want.site_label
    np.testing.assert_array_equal(got.ref_segment, want.ref_segment)
    assert len(got.tensors0) == len(want.tensors0)
    for a, b in zip(got.tensors0, want.tensors0):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.tensors1 is None) == (want.tensors1 is None)
    for a, b in zip(got.tensors1 or [], want.tensors1 or []):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [5, 51])
def test_dump_region_matches_hello_tpu(tmp_path, seed):
    from hello_tpu.io.fasta import FastaFile as JaxFasta
    from hello_tpu.pipeline.dump import dump_region as jax_dump_region
    from hello_tpu.train.store import ShardReader as JaxShardReader

    ds = sim.make_dataset(str(tmp_path), ref_length=6000, num_variants=12,
                          coverage=30, read_length=120, seed=seed)
    bed = _bed(tmp_path, ds, 6000)
    stats, jax_stats = {}, {}
    shards = dump_region([ds.bams["illumina"]], FastaFile(ds.fasta),
                         ds.chromosome, 0, 6000, ds.truth_vcf, bed,
                         str(tmp_path / "port"), sites_per_shard=7,
                         stats=stats)
    want = jax_dump_region([ds.bams["illumina"]], JaxFasta(ds.fasta),
                           ds.chromosome, 0, 6000, ds.truth_vcf, bed,
                           str(tmp_path / "jax"), sites_per_shard=7,
                           stats=jax_stats)
    assert len(shards) == len(want) > 1 and stats == jax_stats
    n = 0
    for path, jax_path in zip(shards, want):
        got_sites, want_sites = list(ShardReader(path)), list(
            JaxShardReader(jax_path))
        assert len(got_sites) == len(want_sites)
        for g, w in zip(got_sites, want_sites):
            _assert_sites_equal(g, w)
            n += 1
    assert n >= 10
    # every labelled site has one (hom) or two (het) true alleles
    for path in shards:
        for site in ShardReader(path):
            assert 1 <= sum(site.labels) <= 2


def test_labels_to_vcf_rebuilds_truth(tmp_path):
    from hello_tpu_torch.pipeline.labels_to_vcf import main as l2v_main

    ds = sim.make_dataset(str(tmp_path), ref_length=6000, num_variants=10,
                          coverage=30, read_length=120, seed=51)
    ref = FastaFile(ds.fasta)
    shards = dump_region([ds.bams["illumina"]], ref, ds.chromosome, 0, 6000,
                         ds.truth_vcf, _bed(tmp_path, ds, 6000),
                         str(tmp_path / "d"))
    lst = str(tmp_path / "d.lst")
    with open(lst, "w") as fh:
        fh.write("\n".join(shards) + "\n")
    out = str(tmp_path / "labels.vcf")
    l2v_main(["--data", lst, "--ref", ds.fasta, "--out", out])
    called = _canonical(read_vcf(out), ref)
    truth = _canonical(read_vcf(ds.truth_vcf), ref)
    assert called == truth


def test_evaluate_and_merge_match_hello_tpu(tmp_path):
    """A VCF the port called (seeded random weights: a call set with errors)
    and the truth: the port's evaluate, determine_max_q_loss and merge give
    hello_tpu's metrics and bytes."""
    from hello_tpu.pipeline import evaluate as jax_evaluate
    from hello_tpu.pipeline import merge as jax_merge
    from hello_tpu_torch.nn import layers
    from hello_tpu_torch.pipeline import evaluate, merge
    from hello_tpu_torch.pipeline.call import call_region, load_scorer

    length = 8000
    ds = sim.make_dataset(str(tmp_path), ref_length=length, num_variants=14,
                          coverage=30, read_length=120, seed=23)
    ref = FastaFile(ds.fasta)
    bed = _bed(tmp_path, ds, length)
    layers.set_precision("highest")
    records = call_region([ds.bams["illumina"]], ref, ds.chromosome, 0,
                          length, load_scorer("illumina", seed=0,
                                              device="cpu"))
    assert records
    contigs = {ds.chromosome: length}
    halves = [str(tmp_path / f"part{i}.vcf") for i in range(2)]
    mid = records[len(records) // 2].position
    write_vcf(halves[0], [r for r in records if r.position < mid], contigs)
    write_vcf(halves[1], [r for r in records if r.position >= mid], contigs)

    merged, jax_merged = str(tmp_path / "m.vcf"), str(tmp_path / "jm.vcf")
    merge.main(["--inputs", str(tmp_path / "part*.vcf"), "--out", merged,
                "--ref", ds.fasta])
    jax_merge.main(["--inputs", str(tmp_path / "part*.vcf"), "--out",
                    jax_merged, "--ref", ds.fasta])
    with open(merged) as a, open(jax_merged) as b:
        assert a.read() == b.read()
    assert [(r.position, r.gt) for r in read_vcf(merged)] == \
        [(r.position, r.gt) for r in records]

    for highconf in (None, bed):
        got = evaluate.evaluate(merged, ds.truth_vcf, ds.fasta, highconf)
        assert got == jax_evaluate.evaluate(merged, ds.truth_vcf, ds.fasta,
                                            highconf)
        truth = evaluate.evaluate(ds.truth_vcf, ds.truth_vcf, ds.fasta,
                                  highconf)
        assert truth["all"]["precision"] == truth["all"]["recall"] == 1.0
    shards = dump_region([ds.bams["illumina"]], ref, ds.chromosome, 0, length,
                         ds.truth_vcf, bed, str(tmp_path / "d"))
    q = evaluate.determine_max_q_loss(shards)
    assert q == jax_evaluate.determine_max_q_loss(shards) and q > 0


class MemmapperSingle:
    """Stand-in for the reference's MemmapDataLite class of that name."""


class MemmapperCompound:
    """Stand-in for the reference's MemmapDataLite class of that name."""


def _reference_format_dump(sites, prefix, hybrid):
    """Write sites as the reference's MemmapperCompound does: one raw
    memmap per tensor key, rows grouped by location then allele, and a
    pickled compound object as the index (MemmapDataLite's layout, as
    train/interop.py reads it)."""
    module = types.ModuleType("MemmapDataLite")
    module.MemmapperSingle, module.MemmapperCompound = (MemmapperSingle,
                                                        MemmapperCompound)
    MemmapperSingle.__module__ = MemmapperCompound.__module__ = \
        "MemmapDataLite"
    MemmapperSingle.__qualname__ = "MemmapperSingle"
    MemmapperCompound.__qualname__ = "MemmapperCompound"
    locations = ["_".join([s.chromosome, str(s.start), str(s.stop)])
                 for s in sites]
    blocks = {"feature": lambda s: s.tensors0,
              "feature2": lambda s: s.tensors1,
              "label": lambda s: [np.array([l], np.float32)
                                  for l in s.labels],
              "segment": lambda s: [s.ref_segment.astype(np.uint8)
                                    for _ in s.alleles]}
    keys = ["feature", "feature2", "label", "segment"] if hybrid else \
        ["feature", "label", "segment"]
    compound = MemmapperCompound()
    compound.keys, compound.hybrid, compound.datasets = keys, hybrid, {}
    compound.sundry = {loc: {} for loc in locations}
    for key in keys:
        single = MemmapperSingle()
        single.accessKey, single.locations = key, list(locations)
        single.alleles, single.indicesOfLocation = {}, {}
        single.numItemsPerAllele = {}
        rows, offset = [], 0
        for loc, s in zip(locations, sites):
            per_allele = [np.asarray(b) for b in blocks[key](s)]
            single.alleles[loc] = list(s.alleles)
            single.indicesOfLocation[loc] = offset
            single.numItemsPerAllele[loc] = [len(b) for b in per_allele]
            rows.extend(per_allele)
            offset += sum(len(b) for b in per_allele)
        data = np.concatenate(rows)
        single.storageName = f"/elsewhere/{os.path.basename(prefix)}.{key}.memmap"
        single.storageShape, single.dtype = data.shape, str(data.dtype)
        data.tofile(f"{prefix}.{key}.memmap")
        compound.datasets[key] = single
    sys.modules["MemmapDataLite"] = module
    try:
        with open(prefix + ".index", "wb") as fh:
            pickle.dump(compound, fh)
    finally:
        del sys.modules["MemmapDataLite"]
    return prefix + ".index"


@pytest.mark.parametrize("hybrid", [False, True])
def test_reference_format_dump_roundtrips(tmp_path, hybrid):
    from hello_tpu.train.interop import ReferenceShardReader as JaxReader
    from hello_tpu_torch.pipeline.batching import SiteWork
    from hello_tpu_torch.train.interop import ReferenceShardReader
    from hello_tpu_torch.train.store import open_shard

    rng = np.random.RandomState(5 + hybrid)
    sites = []
    for i in range(6):
        alleles = [f"A{i}", f"C{i}"]
        n_reads = [int(rng.randint(6, 13)) for _ in alleles]
        t0 = [rng.randint(0, 255, (r, 150, 6)).astype(np.uint8)
              for r in n_reads]
        t1 = ([rng.randint(0, 255, (max(1, r - 3), 150, 6)).astype(np.uint8)
               for r in n_reads] if hybrid else None)
        seg = np.eye(5, dtype=np.float32)[rng.randint(0, 5, size=150)]
        sites.append(SiteWork(chromosome="chr1_KI270706v1_random",
                              start=1000 + 7 * i, stop=1001 + 7 * i,
                              alleles=alleles, tensors0=t0, tensors1=t1,
                              ref_segment=seg, labels=[1.0, 0.0],
                              site_label=None))
    index = _reference_format_dump(sites, str(tmp_path / "refdump"), hybrid)
    for reader in (ReferenceShardReader(index), open_shard(index)):
        assert isinstance(reader, ReferenceShardReader)
        got = list(reader)
        assert len(got) == len(sites)
        for g, want, jax_site in zip(got, sites, JaxReader(index)):
            _assert_sites_equal(g, want)
            _assert_sites_equal(g, jax_site)
