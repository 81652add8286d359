"""The benchmark's sites, made from the seed with vectorized NumPy.

A copy of ``build_workload`` in ``hello_tpu_torch/bench.py`` (commit
9a24431), rewritten to draw every batch in a few array calls: ragged reads
whose cells take the featurizer's palettes (5 base colours, the quality
ladder from 20 to 40, a mapping-quality colour and a strand colour per
read, contiguous read spans), the site's reference colours in channel 1 and
the allele-region marker in channel 5, as the featurizer writes them; so
the sites take the coded wire as a host worker's do.

One change from the copy: the number of reads of each allele is drawn
uniformly over the mix's range, but as a permutation of one fixed multiset
(the range laid out evenly over the batch's alleles), so every batch of
every seed holds the same reads per platform and the seed changes which
allele has how many, not the work.

A batch is a dict of "primitives" (per read: allele, span, mapping-quality
and strand colours, per cell: base and quality indices; per site: the
reference window's base codes).  ``dense_reads`` turns a platform's
primitives into the ``[N, L, C]`` uint8 reads the featurizer would emit:
the port receives them as ``SiteWork`` (``port_sites``), the plain
reference as floats, each from the primitives and never from the other.
"""

from __future__ import annotations

import numpy as np

L = 150
C = 6
#: the featurizer's palettes (hello_tpu_torch/pipeline/compact.py)
BASE_PALETTE = np.array([0, 30, 100, 180, 250], np.uint8)
QUAL_PALETTE = np.array([int(254 * q / 40) for q in range(41)], np.uint8)
REF_COLORS = np.array([250, 30, 180, 100, 0], np.uint8)


def read_ranges(cfg: dict, traffic: dict):
    """[lo, hi] reads per allele of each of the configuration's platforms,
    in its order, from the traffic mix."""
    return [traffic["reads_per_allele"][p] for p in cfg["platforms"]]


def rng_for(seed: int, batch: int, stream: int = 0) -> np.random.Generator:
    """The generator of one batch of one seed (any whole seed >= 0)."""
    return np.random.Generator(np.random.PCG64([stream, batch, int(seed)]))


def read_counts(rng, num_alleles: int, lo: int, hi: int) -> np.ndarray:
    """Reads per allele, uniform over [lo, hi]: a permutation of the range
    laid out evenly over the alleles."""
    even = lo + (np.arange(num_alleles) * (hi - lo + 1)) // num_alleles
    return rng.permutation(even).astype(np.int64)


def make_batch(seed: int, batch: int, num_sites: int, alleles_per_site: int,
               ranges, labels: bool = False) -> dict:
    """One batch's primitives.  ``ranges``: [lo, hi] per platform, in
    platform order (Illumina, then PacBio)."""
    rng = rng_for(seed, batch)
    A = num_sites * alleles_per_site
    out = {
        "num_sites": num_sites,
        "allele_site": np.repeat(np.arange(num_sites), alleles_per_site),
        "ref_codes": rng.integers(0, 5, size=(num_sites, L), dtype=np.uint8),
        "platforms": [],
    }
    for lo, hi in ranges:
        counts = read_counts(rng, A, lo, hi)
        n = int(counts.sum())
        starts = rng.integers(0, L // 2, size=n)
        out["platforms"].append({
            "counts": counts,
            "read_allele": np.repeat(np.arange(A), counts),
            "start": starts,
            "stop": np.minimum(L, starts + rng.integers(L // 3, L, size=n)),
            "mapq": rng.integers(100, 160, size=n).astype(np.uint8),
            "strand": np.where(rng.random(n) < 0.5, 70, 240).astype(np.uint8),
            "base": rng.integers(0, 5, size=(n, L), dtype=np.uint8),
            "qual": rng.integers(20, 41, size=(n, L), dtype=np.uint8),
        })
    if labels:
        out["labels"] = rng.integers(0, 2, size=A).astype(np.int64)
    return out


def marker_row() -> np.ndarray:
    """Channel 5 of a site at [1000 + i, 1001 + i): 240 inside the allele
    region (window position 75), 70 elsewhere."""
    row = np.full(L, 70, np.uint8)
    row[L // 2] = 240
    return row


def dense_reads(batch: dict, k: int) -> np.ndarray:
    """Platform k's reads as the featurizer emits them: [N, L, C] uint8,
    zero outside each read's span."""
    p = batch["platforms"][k]
    pos = np.arange(L, dtype=np.int64)
    present = ((pos >= p["start"][:, None])
               & (pos < p["stop"][:, None])).view(np.uint8)
    site = batch["allele_site"][p["read_allele"]]
    t = np.stack([BASE_PALETTE[p["base"]] * present,
                  REF_COLORS[batch["ref_codes"]][site] * present,
                  QUAL_PALETTE[p["qual"]] * present,
                  p["mapq"][:, None] * present,
                  p["strand"][:, None] * present,
                  marker_row()[None, :] * present], axis=-1)
    return t


def ref_segments(batch: dict) -> np.ndarray:
    """[S, L, 5] one-hot reference windows."""
    return np.eye(5, dtype=np.float32)[batch["ref_codes"]]


def port_sites(batch: dict):
    """The batch as the port's ``SiteWork`` list (what the featurizer hands
    a worker), with labels when the batch has them."""
    from hello_tpu_torch.pipeline.batching import SiteWork

    per_platform = []
    for k, p in enumerate(batch["platforms"]):
        reads = dense_reads(batch, k)
        per_platform.append(np.split(reads, np.cumsum(p["counts"])[:-1]))
    segs = ref_segments(batch)
    per_site = np.bincount(batch["allele_site"], minlength=batch["num_sites"])
    labels = batch.get("labels")
    sites = []
    a = 0
    for si in range(batch["num_sites"]):
        n = int(per_site[si])
        alleles = [f"a{si}_{i}" for i in range(n)]
        sw = SiteWork("chr20", 1000 + si, 1001 + si, alleles,
                      per_platform[0][a:a + n],
                      per_platform[1][a:a + n] if len(per_platform) > 1
                      else None, segs[si])
        if labels is not None:
            sw.labels = [int(x) for x in labels[a:a + n]]
            sw.site_label = 0
        sites.append(sw)
        a += n
    return sites


def reference_inputs(batch: dict, device):
    """The plain reference's inputs on ``device``: reads as float32."""
    import torch

    out = {"allele_site": torch.as_tensor(batch["allele_site"],
                                          device=device).long(),
           "ref_segments": torch.as_tensor(ref_segments(batch),
                                           device=device)}
    for k, p in enumerate(batch["platforms"]):
        out[f"reads{k}"] = torch.as_tensor(dense_reads(batch, k),
                                           device=device).float()
        out[f"read_allele{k}"] = torch.as_tensor(p["read_allele"],
                                                 device=device).long()
    if "labels" in batch:
        out["labels"] = torch.as_tensor(batch["labels"], device=device)
    return out
