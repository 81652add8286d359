"""Wire packing, on-device expansion and genotype decode of the port
against hello_tpu (CPU).

  * the port's copied host packers give the same wire as hello_tpu's;
  * ``expand_compact`` / ``expand_compact_packed`` rebuild byte-identical
    tensors from the same wire dicts (modelled on tests/test_coded_wire.py);
  * ``decode_pairs_device`` picks the same winners as hello_tpu's, with
    saturated logits and exact ties included.
"""

import numpy as np
import pytest
import torch

import jax

from hello_tpu import sim
from hello_tpu.nn.genotype import decode_pairs_device as jax_decode
from hello_tpu.pipeline import compact as jax_compact
from hello_tpu.pipeline.batching import pack_sites
from hello_tpu.pipeline.parallel_call import host_sites_for_chunk
from hello_tpu_torch.nn.genotype import decode_pairs_device
from hello_tpu_torch.pipeline import compact

torch.set_num_threads(1)

CASES = [(("illumina",), False), (("pacbio",), True)]


@pytest.fixture(scope="module", params=CASES, ids=["illumina", "pacbio_hp"])
def sites(request, tmp_path_factory):
    platforms, hp = request.param
    out = tmp_path_factory.mktemp("wire")
    ds = sim.make_dataset(str(out), ref_length=20_000, num_variants=40,
                          coverage=20, read_length=120, seed=9,
                          platforms=platforms, hp_tags=hp)
    options = {"include_hp": hp}
    if platforms == ("pacbio",):
        options["pacbio"] = True
    got = host_sites_for_chunk([ds.bams[platforms[0]]], ds.fasta,
                               ds.chromosome, 0, 20_000, options)
    assert len(got) >= 10
    return got, hp


def _torch_dict(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_port_packers_equal_jax_packers(sites):
    sites, _ = sites
    want = jax_compact.pack_sites_wire(jax_compact.encode_chunk_sites(sites),
                                       hybrid=False)
    got = compact.pack_sites_wire(compact.encode_chunk_sites(sites),
                                  hybrid=False)
    assert got.allele_site_index == want.allele_site_index
    assert got.num_sites == want.num_sites
    assert sorted(got.wire) == sorted(want.wire)
    for k, v in want.wire.items():
        np.testing.assert_array_equal(got.wire[k], v, err_msg=k)


def _wire(sites, hp, kind):
    if kind == "coded":
        return jax_compact.pack_sites_wire(
            jax_compact.encode_chunk_sites(sites), hybrid=False).wire
    dense = pack_sites(sites, hybrid=False, channels0=7 if hp else 6)
    return jax_compact.compact_batch(dense)


@pytest.mark.parametrize("wire", ["coded", "compact_batch"])
def test_expand_compact_byte_exact(sites, wire):
    sites, hp = sites
    d = _wire(sites, hp, wire)
    want = jax_compact.expand_compact({k: np.asarray(v) for k, v in d.items()})
    got = compact.expand_compact(_torch_dict(d))
    _assert_same(got, want)
    assert got["reads0"].shape[-1] == (7 if hp else 6)


def test_expand_compact_packed_byte_exact(sites):
    sites, hp = sites
    d = _wire(sites, hp, "coded")
    want = jax_compact.expand_compact_packed(
        {k: np.asarray(v) for k, v in d.items()})
    got = compact.expand_compact_packed(_torch_dict(d))
    _assert_same(got, want)


def _layout(rng, counts, A, S, e_dim):
    site_ids = np.full(A, S - 1, np.int32)
    allele_mask = np.zeros(A, np.float32)
    slot = 0
    for si, n in enumerate(counts):
        site_ids[slot:slot + n] = si
        allele_mask[slot:slot + n] = 1.0
        slot += n
    experts = (rng.randn(A, e_dim) * 3).astype(np.float32)
    meta = None
    if e_dim != 1:
        meta = rng.rand(S, 3).astype(np.float32)
        meta /= meta.sum(axis=1, keepdims=True)
    return experts, meta, site_ids, allele_mask


@pytest.mark.parametrize("e_dim", [1, 3])
@pytest.mark.parametrize("logits", ["random", "saturated+", "saturated-",
                                    "ties"])
def test_decode_pairs_device_matches_jax(rng, e_dim, logits):
    counts = (1, 2, 3, 5, 8, 2, 2, 1)
    experts, meta, site_ids, allele_mask = _layout(rng, counts, 32, 16, e_dim)
    if logits == "saturated+":
        experts[:] = 40.0          # sigmoid == 1.0 exactly in f32
    elif logits == "saturated-":
        experts[:] = -40.0
    elif logits == "ties":
        experts[:] = 0.0           # every het pair ties exactly
    fn = jax.jit(jax_decode, static_argnums=(4,))
    want = {k: np.asarray(v)
            for k, v in fn(experts, meta, site_ids, allele_mask, 16).items()}
    got = decode_pairs_device(
        torch.from_numpy(experts),
        None if meta is None else torch.from_numpy(meta),
        torch.from_numpy(site_ids), torch.from_numpy(allele_mask), 16)
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    for k in ("best_i", "best_j", "valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype
    assert not want["valid"][len(counts):].any()
    np.testing.assert_allclose(got["best_p"], want["best_p"], rtol=1e-5,
                               atol=1e-12)
