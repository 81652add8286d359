"""Training-data store: memmap payload files with pickled indices.

Equivalent of the reference's dict->memmap store (reference
python/MemmapDataLite.py:30-272 ``MemmapperSingle``/``MemmapperCompound``):
each shard is a raw payload file holding every array back-to-back plus a
pickled index mapping site keys -> per-array (offset, shape, dtype).  Shards
are self-describing and loadable with numpy memmap — no framework needed.
"""

from __future__ import annotations

import pickle
from typing import Iterator, List, Tuple

import numpy as np

from ..pipeline.batching import SiteWork

INDEX_SUFFIX = ".index"
DATA_SUFFIX = ".memmap"


class ShardWriter:
    """Write SiteWork items into one shard (payload + index)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._data = open(prefix + DATA_SUFFIX, "wb")
        self._offset = 0
        self._index: List[dict] = []

    def _put(self, arr: np.ndarray) -> Tuple[int, tuple, str]:
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        entry = (self._offset, arr.shape, arr.dtype.str)
        self._data.write(raw)
        self._offset += len(raw)
        return entry

    def add_site(self, site: SiteWork):
        entry = {
            "chromosome": site.chromosome,
            "start": site.start,
            "stop": site.stop,
            "alleles": list(site.alleles),
            "site_label": site.site_label,
            "labels": list(site.labels) if site.labels is not None else None,
            "tensors0": [self._put(t) for t in site.tensors0],
            "tensors1": [self._put(t) for t in site.tensors1]
            if site.tensors1 is not None else None,
            "ref_segment": self._put(site.ref_segment)
            if site.ref_segment is not None else None,
        }
        self._index.append(entry)

    def close(self) -> str:
        self._data.close()
        with open(self.prefix + INDEX_SUFFIX, "wb") as fh:
            pickle.dump({"version": 1, "sites": self._index}, fh)
        return self.prefix + INDEX_SUFFIX

    def __len__(self):
        return len(self._index)


class ShardReader:
    """Read one shard lazily through a numpy memmap."""

    def __init__(self, index_path: str):
        assert index_path.endswith(INDEX_SUFFIX), index_path
        self.prefix = index_path[:-len(INDEX_SUFFIX)]
        with open(index_path, "rb") as fh:
            payload = pickle.load(fh)
        self.sites = payload["sites"]
        self._mm = np.memmap(self.prefix + DATA_SUFFIX, dtype=np.uint8, mode="r")

    def _get(self, entry) -> np.ndarray:
        offset, shape, dtype = entry
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) * dt.itemsize
        return np.frombuffer(self._mm[offset:offset + count], dtype=dt).reshape(shape)

    def __len__(self):
        return len(self.sites)

    def __getitem__(self, i: int) -> SiteWork:
        e = self.sites[i]
        return SiteWork(
            chromosome=e["chromosome"], start=e["start"], stop=e["stop"],
            alleles=list(e["alleles"]),
            tensors0=[np.array(self._get(t)) for t in e["tensors0"]],
            tensors1=[np.array(self._get(t)) for t in e["tensors1"]]
            if e["tensors1"] is not None else None,
            ref_segment=np.array(self._get(e["ref_segment"]))
            if e["ref_segment"] is not None else None,
            labels=e["labels"], site_label=e["site_label"])

    def __iter__(self) -> Iterator[SiteWork]:
        for i in range(len(self)):
            yield self[i]


def open_shard(index_path: str):
    """Open a shard index of either format: native ShardReader indexes, or
    reference MemmapperCompound dumps (train/interop.py) — sniffed per file,
    so a training file list can mix both."""
    from .interop import ReferenceShardReader, is_reference_index
    if is_reference_index(index_path):
        return ReferenceShardReader(index_path)
    return ShardReader(index_path)


def write_shards(sites: Iterator[SiteWork], out_prefix: str,
                 sites_per_shard: int = 1000) -> List[str]:
    """Write a site stream into numbered shards; returns index paths."""
    paths = []
    writer = None
    shard_id = 0
    for site in sites:
        if site is None or not site.alleles:
            continue
        if writer is None:
            writer = ShardWriter(f"{out_prefix}_{shard_id:05d}")
        writer.add_site(site)
        if len(writer) >= sites_per_shard:
            paths.append(writer.close())
            writer = None
            shard_id += 1
    if writer is not None and len(writer) > 0:
        paths.append(writer.close())
    return paths
