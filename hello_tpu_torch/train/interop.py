"""Reference training-data interchange: read HELLO ``MemmapperCompound``
dumps (``.index`` + per-key ``.memmap`` shards) as SiteWork streams.

The reference's training pipeline stores labeled sites as a pickled
``MemmapperCompound`` index plus one raw memmap file per tensor key
(reference python/MemmapDataLite.py:30-272; produced from the caller's hdf5
dumps by ``postProcessHdf5``, reference python/caller_calling.py:292-332).
Model checkpoints already convert both ways (nn/convert.py / nn/export.py);
this module closes the *data* interchange gap: anyone holding
reference-produced training dumps can train this framework on them directly
(``train/cli.py --data ref_dump.index`` or a ``.lst`` mixing formats —
``open_shard`` sniffs the format per file).

The ``.index`` file is a pickle of the ``MemmapperCompound`` object itself,
referencing classes from the reference's ``MemmapDataLite`` module.  Loading
uses a restricted Unpickler that maps those class names onto local attribute
holders — no reference code (or torch) is imported, and no class from the
pickle is executed.  Memmap payload paths inside the index are absolute paths
from the dump machine; like the reference's ``fixMemmapPaths.py`` (but at
read time, no rewrite step), they are resolved against the ``.index`` file's
own directory when the recorded path does not exist.

Layout recap (what the reader consumes):

* compound attrs: ``datasets`` ({key -> MemmapperSingle}), ``keys``,
  ``hybrid``, ``sundry`` ({location -> {allele -> small attrs}});
* single attrs: ``accessKey``, ``locations`` (site order), ``alleles``
  ({location -> allele list}), ``indicesOfLocation`` (row offset per
  location), ``numItemsPerAllele`` ({location -> per-allele row counts}),
  ``storageName``, ``storageShape``, ``dtype``;
* tensor keys: ``feature`` [R,150,C] uint8, ``feature2`` (hybrid only),
  ``label`` [1] float32 per allele, ``segment`` [150,5] uint8
  (keys/dtypes fixed by postProcessHdf5, caller_calling.py:309-320);
* locations are ``'_'.join([chromosome, start, stop])``
  (caller_calling.py ``addToDict``) — chromosome names may themselves
  contain underscores, so parsing is rsplit-based;
* ``siteLabel`` is NOT in the index (MemmapDataLite skips it everywhere),
  and the reference's own training never reads it back
  (MemmapDatasetLoader.tensorify) — sites load with ``site_label=None``.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..pipeline.batching import SiteWork


class _Holder:
    """Attribute bag standing in for a pickled reference class instance."""


_REF_CLASSES = ("MemmapperSingle", "MemmapperCompound")

# globals a MemmapperCompound pickle legitimately references (numpy scalar
# types for the per-key dtype attributes, builtins for containers).  Every
# entry is an EXPLICIT (module, name) pair: a module-level wildcard would
# admit e.g. numpy.load — whose allow_pickle path runs an unrestricted
# pickle — and defeat the whole restricted-unpickler design.
_NUMPY_NAMES = ("dtype", "ndarray", "generic", "bool_",
                "int8", "int16", "int32", "int64", "intc", "int_",
                "uint8", "uint16", "uint32", "uint64",
                "float16", "float32", "float64")
_MULTIARRAY_NAMES = ("_reconstruct", "scalar")
_SAFE_GLOBALS = (
    {("numpy", n) for n in _NUMPY_NAMES}
    | {(m, n) for n in _MULTIARRAY_NAMES
       for m in ("numpy.core.multiarray", "numpy._core.multiarray")}
    | {
        ("collections", "defaultdict"),
        ("collections", "OrderedDict"),
        ("builtins", "set"),
        ("builtins", "frozenset"),
        ("builtins", "bytearray"),
        ("builtins", "complex"),
    }
)


class _RefIndexUnpickler(pickle.Unpickler):
    """Unpickler for reference ``.index`` files: reference classes become
    plain attribute holders; everything else is allowlisted (an index holds
    only containers, strings, numbers and numpy dtypes — any other global
    means the file is not a MemmapperCompound index)."""

    def find_class(self, module, name):
        if name in _REF_CLASSES:
            cls = type(name, (_Holder,), {})
            return cls
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"unexpected global {module}.{name} in reference index "
            "(not a MemmapperCompound dump?)")


def parse_location(location: str) -> Tuple[str, int, int]:
    """``'_'.join([chrom, start, stop])`` -> (chrom, start, stop); rsplit
    because chromosome names can contain underscores (chr1_KI270706v1...)."""
    chrom, start, stop = location.rsplit("_", 2)
    return chrom, int(start), int(stop)


def is_reference_index(index_path: str) -> bool:
    """Cheap format sniff: our ShardWriter indexes are pickled dicts with a
    ``version`` key; reference indexes pickle a MemmapperCompound instance
    (the class name appears in the first bytes of the stream)."""
    with open(index_path, "rb") as fh:
        head = fh.read(4096)
    return b"MemmapperCompound" in head


class ReferenceShardReader:
    """Read one reference MemmapperCompound dump as SiteWork items.

    Mirrors ``store.ShardReader``'s interface (len / getitem / iter) so the
    training loader consumes both formats interchangeably."""

    def __init__(self, index_path: str):
        self.index_path = index_path
        with open(index_path, "rb") as fh:
            compound = _RefIndexUnpickler(fh).load()
        self._hybrid = bool(getattr(compound, "hybrid", False))
        self._singles = dict(compound.datasets)
        for want in ("feature", "label", "segment"):
            if want not in self._singles:
                raise ValueError(
                    f"{index_path}: reference index lacks key {want!r} "
                    f"(has {sorted(self._singles)})")
        if self._hybrid and "feature2" not in self._singles:
            raise ValueError(f"{index_path}: hybrid index lacks 'feature2'")
        self.locations: List[str] = list(self._singles["feature"].locations)
        self._maps = {}

    def _storage(self, key: str) -> np.ndarray:
        """Lazily-opened memmap for one tensor key, path-resolved against
        the index's directory when the recorded absolute path moved."""
        if key not in self._maps:
            s = self._singles[key]
            path = s.storageName
            if not os.path.exists(path):
                local = os.path.join(os.path.dirname(self.index_path) or ".",
                                     os.path.basename(path))
                if not os.path.exists(local):
                    raise FileNotFoundError(
                        f"memmap payload for {key!r} not found at "
                        f"{path!r} nor {local!r}")
                path = local
            dtype = np.dtype(s.dtype)
            expect = int(np.prod(s.storageShape)) * dtype.itemsize
            actual = os.path.getsize(path)
            if actual < expect:
                raise ValueError(
                    f"{path}: payload truncated ({actual} bytes, index "
                    f"records shape {tuple(s.storageShape)} {dtype} = "
                    f"{expect})")
            self._maps[key] = np.memmap(path, dtype=dtype, mode="r",
                                        shape=tuple(s.storageShape))
        return self._maps[key]

    def _rows(self, key: str, location: str) -> List[np.ndarray]:
        """Per-allele row blocks of one tensor key at one location."""
        s = self._singles[key]
        storage = self._storage(key)
        base = s.indicesOfLocation[location]
        out, off = [], 0
        for n in s.numItemsPerAllele[location]:
            out.append(np.array(storage[base + off:base + off + n]))
            off += n
        return out

    def __len__(self) -> int:
        return len(self.locations)

    def __getitem__(self, i: int) -> SiteWork:
        location = self.locations[i]
        chrom, start, stop = parse_location(location)
        alleles = list(self._singles["feature"].alleles[location])
        tensors0 = self._rows("feature", location)
        # label rows are [1] float32 per allele; 1.0 = allele in the truth
        # genotype (trainDataTools get_labeled_candidates)
        labels = [float(rows[0]) for rows in self._rows("label", location)]
        # segment is duplicated per allele (caller_calling addToDict);
        # stored uint8, the model consumes float32 one-hot
        seg_rows = self._rows("segment", location)
        ref_segment = np.ascontiguousarray(seg_rows[0], np.float32)
        tensors1 = None
        if self._hybrid:
            tensors1 = self._rows("feature2", location)
        return SiteWork(chromosome=chrom, start=start, stop=stop,
                        alleles=alleles, tensors0=tensors0, tensors1=tensors1,
                        ref_segment=ref_segment, labels=labels,
                        site_label=None)

    def __iter__(self) -> Iterator[SiteWork]:
        for i in range(len(self)):
            yield self[i]
