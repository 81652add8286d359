"""Streaming training-data loader: shard-at-a-time iteration with shuffling,
read subsampling, and padded-batch collation.

Mirrors the reference loader semantics (reference python/MemmapDatasetLoader.py:102-203
``IterableMemmapDataset``): shards are processed one at a time, sites within a
shard are shuffled in memory, reads are subsampled per site to a cap, and
batches are emitted for the device.  Rank sharding equalises per-rank epoch
length to the minimum across ranks (reference
MixtureOfExpertsDNNFastDistributed.py:403-480 ``dataLoader``).
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence

from ..pipeline.batching import (SiteWork, group_sites_for_batching, pack_sites,
                                 stack_device_batches, training_dict)
from .store import open_shard


def subsample_reads(site: SiteWork, max_reads: int, rng: random.Random) -> SiteWork:
    """Cap reads per allele tensor (reference MemmapDatasetLoader.subsample:20-36)."""
    def cap(tensors):
        out = []
        for t in tensors:
            if t.shape[0] > max_reads:
                idx = sorted(rng.sample(range(t.shape[0]), max_reads))
                out.append(t[idx])
            else:
                out.append(t)
        return out

    return SiteWork(
        chromosome=site.chromosome, start=site.start, stop=site.stop,
        alleles=site.alleles, tensors0=cap(site.tensors0),
        tensors1=cap(site.tensors1) if site.tensors1 is not None else None,
        ref_segment=site.ref_segment, labels=site.labels,
        site_label=site.site_label)


def simulate_coverage(site: SiteWork, frac: float,
                      rng: random.Random) -> SiteWork:
    """Thin every allele's read set to ``frac`` of its reads (min 1), as
    lower-coverage augmentation (reference AlleleSearcherDNN.py:663-757
    ``Subsampler`` coverage simulation)."""
    def thin(tensors):
        out = []
        for t in tensors:
            keep = max(1, int(round(t.shape[0] * frac)))
            if keep < t.shape[0]:
                idx = sorted(rng.sample(range(t.shape[0]), keep))
                out.append(t[idx])
            else:
                out.append(t)
        return out

    return SiteWork(
        chromosome=site.chromosome, start=site.start, stop=site.stop,
        alleles=site.alleles, tensors0=thin(site.tensors0),
        tensors1=thin(site.tensors1) if site.tensors1 is not None else None,
        ref_segment=site.ref_segment, labels=site.labels,
        site_label=site.site_label)


def shard_files_for_ranks(files: Sequence[str], world_size: int,
                          seed: int = 13) -> List[List[str]]:
    """Deterministically shuffle and split shard files across ranks with
    equalised epoch lengths (min across ranks)."""
    files = list(files)
    random.Random(seed).shuffle(files)
    per_rank = [files[r::world_size] for r in range(world_size)]
    lengths = []
    for chunk in per_rank:
        lengths.append(sum(len(open_shard(p)) for p in chunk))
    min_len = min(lengths) if lengths else 0
    return per_rank, min_len


class SiteDataset:
    """Iterate SiteWork items across shards with per-shard shuffling."""

    def __init__(self, index_paths: Sequence[str], max_reads_per_site: int = 1000,
                 shuffle: bool = True, seed: int = 13,
                 max_sites: Optional[int] = None,
                 coverage_range: Optional[tuple] = None):
        self.index_paths = list(index_paths)
        self.max_reads = max_reads_per_site
        self.shuffle = shuffle
        self.seed = seed
        self.max_sites = max_sites
        # (lo, hi): per-site uniform coverage fraction for augmentation
        self.coverage_range = coverage_range

    def __iter__(self) -> Iterator[SiteWork]:
        rng = random.Random(self.seed)
        paths = list(self.index_paths)
        if self.shuffle:
            rng.shuffle(paths)
        emitted = 0
        for path in paths:
            reader = open_shard(path)
            sites = list(reader)
            if self.shuffle:
                rng.shuffle(sites)
            for site in sites:
                if self.coverage_range is not None:
                    frac = rng.uniform(*self.coverage_range)
                    site = simulate_coverage(site, frac, rng)
                yield subsample_reads(site, self.max_reads, rng)
                emitted += 1
                if self.max_sites is not None and emitted >= self.max_sites:
                    return


def _pack_group(group, hybrid, feature_length, channels, wire, **kw):
    """Pack one site group as a training dict: coded wire when requested and
    every site codes (the trainer expands it on device), dense otherwise."""
    if wire:
        from ..pipeline.compact import (encode_chunk_sites, pack_sites_wire,
                                        training_wire_dict)
        coded = encode_chunk_sites(group)
        if coded is not None:
            wkw = dict(kw)
            if "read_buckets" in kw:
                # fixed dense buckets => pin the row axis at its cap too, so
                # wire batches keep the single-compilation guarantee
                wkw["row_buckets"] = (0,)
            wb = pack_sites_wire(coded, hybrid=hybrid,
                                 feature_length=feature_length, **wkw)
            if wb.labels is None:
                return None
            return training_wire_dict(wb)
    batch = pack_sites(group, hybrid=hybrid, feature_length=feature_length,
                       channels0=channels, channels1=channels, **kw)
    if batch.labels is None:
        return None
    return training_dict(batch)


def batches(dataset: SiteDataset, hybrid: bool, max_alleles_per_batch: int = 64,
            channels: int = 6, feature_length: int = 150,
            wire: bool = False) -> Iterator[dict]:
    """Single-device training batches (device dict + labels).

    ``wire=True`` emits 1-byte coded-wire dicts (pipeline/compact.py) that the
    trainer expands inside the jitted step — ~6x less host->device traffic."""
    for group in group_sites_for_batching(iter(dataset), max_alleles_per_batch):
        d = _pack_group(group, hybrid, feature_length, channels, wire)
        if d is not None:
            yield d


def device_batches(dataset: SiteDataset, hybrid: bool, num_devices: int,
                   max_alleles_per_batch: int = 64, channels: int = 6,
                   feature_length: int = 150,
                   fixed_shape: Optional[dict] = None,
                   wire: bool = False) -> Iterator[dict]:
    """Stacked per-device batches for the sharded trainer.

    ``fixed_shape``: optional dict(read_bucket=, allele_bucket=, site_bucket=)
    forcing every batch to identical padded shapes (single compilation).

    ``wire=True``: coded-wire batches (see :func:`batches`); per-device dicts
    are row-padded to a common bucket before stacking.
    """
    kw = {}
    if fixed_shape:
        kw = {
            "read_buckets": (fixed_shape["read_bucket"],),
            "allele_buckets": (fixed_shape["allele_bucket"],),
            "site_buckets": (fixed_shape["site_bucket"],),
        }
    max_sites = fixed_shape["site_bucket"] if fixed_shape else None
    # one queue per format: a dense fallback (out-of-palette colors — never
    # featurizer output, defensive only) cannot stack with wire dicts
    pending = {True: [], False: []}
    for group in group_sites_for_batching(iter(dataset), max_alleles_per_batch,
                                          max_sites_per_batch=max_sites):
        d = _pack_group(group, hybrid, feature_length, channels, wire, **kw)
        if d is None:
            continue
        q = pending["codes0" in d]
        q.append(d)
        if len(q) == num_devices:
            if "codes0" in q[0]:
                from ..pipeline.compact import stack_wire_batches
                yield stack_wire_batches(q)
            else:
                yield stack_device_batches(q)
            q.clear()
