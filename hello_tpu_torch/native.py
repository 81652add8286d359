"""ctypes bindings for the native (C++) host engine.

Loads ``native/libhello_native.so`` (building it on demand when a toolchain is
available) and exposes:

  * :class:`NativeBam` — whole-file BAM decode into numpy arrays;
  * :class:`NativeWindow` — the C++ window engine with the same interface as
    the pure-Python :class:`hello_tpu.window.Window`.

The Python engine remains the semantic reference; fuzz tests assert
equivalence (tests/test_native.py).  Set ``HELLO_TPU_NATIVE=0`` to disable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .reads import AlignedRead

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libhello_native.so")

_lib = None


class _Params(ctypes.Structure):
    _fields_ = [
        ("snv_threshold", ctypes.c_double),
        ("indel_threshold", ctypes.c_double),
        ("min_count", ctypes.c_int),
        ("min_mapq", ctypes.c_int),
        ("q_threshold", ctypes.c_int),
        ("max_allele_size", ctypes.c_int),
        ("band_margin", ctypes.c_int),
        ("max_reassembly_region_size", ctypes.c_int),
    ]


# chunk-orchestrator callbacks: caller RNG draw per read selection, and
# clamped reference-slice fetch (see native/src/chunk.cpp)
SEED_FN = ctypes.CFUNCTYPE(ctypes.c_uint64)
REF_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                          ctypes.POINTER(ctypes.c_char), ctypes.c_int64)


def _try_build() -> bool:
    makefile = os.path.join(_NATIVE_DIR, "Makefile")
    if not os.path.exists(makefile):
        return False
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=300)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _stale() -> bool:
    """True when any native source is newer than the built library — loading
    a stale .so would miss newer C API symbols (ctypes setup would crash)."""
    try:
        so_mtime = os.path.getmtime(_LIB_PATH)
    except OSError:
        return True
    for sub in ("src", "include"):
        d = os.path.join(_NATIVE_DIR, sub)
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for f in names:
            if f.startswith("profile_"):     # gprof harness, not in the .so
                continue
            if f.endswith((".cpp", ".h")):
                if os.path.getmtime(os.path.join(d, f)) > so_mtime:
                    return True
    return False


def load_library():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("HELLO_TPU_NATIVE", "1") == "0":
        return None
    if (not os.path.exists(_LIB_PATH) or _stale()) and not _try_build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    # final guard: an .so still missing the newest C API symbol (e.g. make
    # unavailable on this host) must degrade to the pure-Python engine, not
    # crash the ctypes setup below
    if not hasattr(lib, "htpu_chunk_sites_coded"):     # newest C API symbol
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.htpu_default_params.argtypes = [ctypes.POINTER(_Params)]
    lib.htpu_window_create.restype = ctypes.c_void_p
    lib.htpu_window_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32,
        ctypes.c_char_p, i64p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32), i64p,
        i64p, i32p,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(_Params),
    ]
    lib.htpu_window_destroy.argtypes = [ctypes.c_void_p]
    lib.htpu_differing_regions.restype = ctypes.c_int32
    lib.htpu_differing_regions.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, i64p, ctypes.c_int32]
    lib.htpu_assemble_region.argtypes = [
        ctypes.c_void_p, i64p, ctypes.c_int32, ctypes.c_int]
    lib.htpu_alleles_at.restype = ctypes.c_int32
    lib.htpu_alleles_at.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64]
    lib.htpu_supports_at.restype = ctypes.c_int32
    lib.htpu_supports_at.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, i32p, ctypes.c_int32, i32p, ctypes.c_int64]
    lib.htpu_num_supports.restype = ctypes.c_int32
    lib.htpu_num_supports.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int]
    lib.htpu_features.restype = ctypes.c_int32
    lib.htpu_features.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    lib.htpu_site_query.restype = ctypes.c_int32
    lib.htpu_site_query.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
        i32p, i32p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, i64p]
    lib.htpu_compact_rows.restype = None
    lib.htpu_compact_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.htpu_compact_rows_coded.restype = ctypes.c_int32
    lib.htpu_compact_rows_coded.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]

    lib.htpu_bam_open.restype = ctypes.c_void_p
    lib.htpu_bam_open.argtypes = [ctypes.c_char_p]
    lib.htpu_bam_open_region.restype = ctypes.c_void_p
    lib.htpu_bam_open_region.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.htpu_bam_open_region_bai.restype = ctypes.c_void_p
    lib.htpu_bam_open_region_bai.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64]
    lib.htpu_bam_select.restype = ctypes.c_int32
    lib.htpu_bam_select.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_uint64, i32p, ctypes.c_int32]
    lib.htpu_bam_selection_bounds.restype = ctypes.c_int32
    lib.htpu_bam_selection_bounds.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int32, i64p, i64p]
    lib.htpu_window_create_from_bam.restype = ctypes.c_void_p
    lib.htpu_window_create_from_bam.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, i32p, i32p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(_Params)]
    lib.htpu_chunk_sites.restype = ctypes.c_void_p
    lib.htpu_chunk_sites.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint8),
        i32p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p,
        ctypes.POINTER(_Params), SEED_FN, REF_FN]
    lib.htpu_chunk_sites_coded.restype = ctypes.c_void_p
    lib.htpu_chunk_sites_coded.argtypes = lib.htpu_chunk_sites.argtypes
    lib.htpu_chunk_destroy.argtypes = [ctypes.c_void_p]
    for name, restype in [
        ("htpu_chunk_coded", ctypes.c_int32),
        ("htpu_chunk_codes", ctypes.POINTER(ctypes.c_uint8)),
        ("htpu_chunk_codes_len", ctypes.c_int64),
        ("htpu_chunk_scalars", ctypes.POINTER(ctypes.c_uint8)),
        ("htpu_chunk_scalars_len", ctypes.c_int64),
        ("htpu_chunk_num_sites", ctypes.c_int64),
        ("htpu_chunk_positions", i64p),
        ("htpu_chunk_stops", i64p),
        ("htpu_chunk_nalleles", i32p),
        ("htpu_chunk_site_labels", ctypes.POINTER(ctypes.c_int8)),
        ("htpu_chunk_alleles", ctypes.POINTER(ctypes.c_char)),
        ("htpu_chunk_alleles_len", ctypes.c_int64),
        ("htpu_chunk_rows0", i32p),
        ("htpu_chunk_rows1", i32p),
        ("htpu_chunk_labels", ctypes.POINTER(ctypes.c_int8)),
        ("htpu_chunk_features", ctypes.POINTER(ctypes.c_uint8)),
        ("htpu_chunk_features_len", ctypes.c_int64),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]

    lib.htpu_bam_close.argtypes = [ctypes.c_void_p]
    lib.htpu_bam_num_refs.restype = ctypes.c_int32
    lib.htpu_bam_num_refs.argtypes = [ctypes.c_void_p]
    lib.htpu_bam_ref_name.restype = ctypes.c_char_p
    lib.htpu_bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.htpu_bam_ref_len.restype = ctypes.c_int64
    lib.htpu_bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.htpu_bam_num_reads.restype = ctypes.c_int64
    lib.htpu_bam_num_reads.argtypes = [ctypes.c_void_p]
    for name, restype in [
        ("htpu_bam_seqs", ctypes.POINTER(ctypes.c_char)),
        ("htpu_bam_seq_offsets", i64p),
        ("htpu_bam_quals", ctypes.POINTER(ctypes.c_uint8)),
        ("htpu_bam_cigars", ctypes.POINTER(ctypes.c_uint32)),
        ("htpu_bam_cigar_offsets", i64p),
        ("htpu_bam_ref_starts", i64p),
        ("htpu_bam_ref_ends", i64p),
        ("htpu_bam_ref_ids", i32p),
        ("htpu_bam_mapqs", i32p),
        ("htpu_bam_flags", ctypes.POINTER(ctypes.c_uint16)),
        ("htpu_bam_hps", ctypes.POINTER(ctypes.c_int8)),
        ("htpu_bam_names", ctypes.POINTER(ctypes.c_char)),
        ("htpu_bam_name_offsets", i64p),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def compact_rows(reads: np.ndarray, rows: np.ndarray,
                 packed: np.ndarray, scalars: np.ndarray) -> bool:
    """Native channel split for the compact wire format: gather `rows` of the
    dense [AR, L, C] uint8 tensor into packed [n, L, 3] (ch0, ch2, ch4 != 0)
    + per-row scalar maxima (pipeline/compact.py).  The byte-strided channel
    extraction is ~10x slower in numpy.  Returns False when the library is
    unavailable (caller falls back to numpy)."""
    lib = load_library()
    if lib is None:
        return False
    assert reads.dtype == np.uint8 and reads.flags.c_contiguous
    rows = np.ascontiguousarray(rows, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.htpu_compact_rows(
        reads.ctypes.data_as(u8p), rows.ctypes.data_as(i32p),
        np.int32(len(rows)), np.int32(reads.shape[1]),
        np.int32(reads.shape[2]),
        packed.ctypes.data_as(u8p), scalars.ctypes.data_as(u8p))
    return True


def compact_rows_coded(reads: np.ndarray, rows: np.ndarray,
                       codes: np.ndarray, scalars: np.ndarray):
    """Coded compact packing: one byte per cell (base_idx*41 + qual_idx,
    absent = 255) instead of three (pipeline/compact.py).  Returns True on
    success, False when the library is unavailable, and None when a present
    cell's color falls outside the palettes (caller falls back to the
    3-byte format)."""
    lib = load_library()
    if lib is None or not hasattr(lib, "htpu_compact_rows_coded"):
        return False
    assert reads.dtype == np.uint8 and reads.flags.c_contiguous
    rows = np.ascontiguousarray(rows, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ok = lib.htpu_compact_rows_coded(
        reads.ctypes.data_as(u8p), rows.ctypes.data_as(i32p),
        np.int32(len(rows)), np.int32(reads.shape[1]),
        np.int32(reads.shape[2]),
        codes.ctypes.data_as(u8p), scalars.ctypes.data_as(u8p))
    return True if ok else None


def _as_array(ptr, count, dtype):
    if count == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=False)


class NativeBam:
    """BAM decode into numpy arrays (zero copies beyond decode).

    With ``region=(chromosome, start, stop)`` the open is O(region): the C++
    side seeks through the ``.bai`` linear index and decodes only records
    overlapping the region (building the index first via the Python codec if
    the BAM is sorted but unindexed).  Without a region the whole file is
    decoded."""

    def __init__(self, path: str, pacbio: bool = False, region=None):
        lib = load_library()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self.pacbio = pacbio
        self.region = region
        if region is not None:
            from .io.bam import UnsortedBamError, _bai_path_for, build_index
            if _bai_path_for(path) is None:
                try:
                    # one pass; persisted next to the BAM, or in the per-user
                    # cache when the BAM's directory is read-only
                    build_index(path)
                except (UnsortedBamError, ValueError):
                    pass                    # C++ side falls back to whole-file
            chrom, start, stop = region
            bai = _bai_path_for(path)
            if bai is not None:
                self._h = lib.htpu_bam_open_region_bai(
                    path.encode(), bai.encode(), chrom.encode(),
                    max(int(start), 0), int(stop))
            else:
                self._h = lib.htpu_bam_open_region(
                    path.encode(), chrom.encode(), max(int(start), 0),
                    int(stop))
        else:
            self._h = lib.htpu_bam_open(path.encode())
        if not self._h:
            raise IOError(f"failed to open BAM: {path}")
        n_refs = lib.htpu_bam_num_refs(self._h)
        self.references = [
            (lib.htpu_bam_ref_name(self._h, i).decode(),
             lib.htpu_bam_ref_len(self._h, i)) for i in range(n_refs)]
        n = lib.htpu_bam_num_reads(self._h)
        self.num_reads = n
        self.seq_offsets = _as_array(lib.htpu_bam_seq_offsets(self._h), n + 1, np.int64)
        self.cigar_offsets = _as_array(lib.htpu_bam_cigar_offsets(self._h), n + 1, np.int64)
        self.name_offsets = _as_array(lib.htpu_bam_name_offsets(self._h), n + 1, np.int64)
        self.ref_starts = _as_array(lib.htpu_bam_ref_starts(self._h), n, np.int64)
        self.ref_ends = _as_array(lib.htpu_bam_ref_ends(self._h), n, np.int64)
        self.ref_ids = _as_array(lib.htpu_bam_ref_ids(self._h), n, np.int32)
        self.mapqs = _as_array(lib.htpu_bam_mapqs(self._h), n, np.int32)
        self.flags = _as_array(lib.htpu_bam_flags(self._h), n, np.uint16)
        self.hps = _as_array(lib.htpu_bam_hps(self._h), n, np.int8)
        total_seq = int(self.seq_offsets[-1]) if n else 0
        total_cig = int(self.cigar_offsets[-1]) if n else 0
        total_nam = int(self.name_offsets[-1]) if n else 0
        self.seqs = ctypes.string_at(lib.htpu_bam_seqs(self._h), total_seq)
        self.quals = _as_array(lib.htpu_bam_quals(self._h), total_seq, np.uint8)
        self.cigars = _as_array(lib.htpu_bam_cigars(self._h), total_cig, np.uint32)
        self.names = ctypes.string_at(lib.htpu_bam_names(self._h), total_nam)

    def close(self):
        if self._h:
            self._lib.htpu_bam_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def read(self, i: int) -> AlignedRead:
        """Materialise one read as an AlignedRead (for compatibility paths)."""
        s0, s1 = int(self.seq_offsets[i]), int(self.seq_offsets[i + 1])
        c0, c1 = int(self.cigar_offsets[i]), int(self.cigar_offsets[i + 1])
        n0, n1 = int(self.name_offsets[i]), int(self.name_offsets[i + 1])
        cig = self.cigars[c0:c1]
        return AlignedRead(
            name=self.names[n0:n1 - 1].decode(),
            flag=int(self.flags[i]),
            chromosome=self.references[int(self.ref_ids[i])][0]
            if 0 <= int(self.ref_ids[i]) < len(self.references) else "*",
            reference_start=int(self.ref_starts[i]),
            mapq=int(self.mapqs[i]),
            cigartuples=[(int(v) & 0xF, int(v) >> 4) for v in cig],
            sequence=self.seqs[s0:s1].decode(),
            qualities=self.quals[s0:s1].tolist(),
            hp=int(self.hps[i]),
            pacbio=self.pacbio,
        )

    def ref_id(self, chromosome: str):
        for i, (name, _l) in enumerate(self.references):
            if name == chromosome:
                return i
        return None

    def select(self, chromosome: str, start: int, stop: int,
               max_reads: int = 10000, seed: int = 13) -> "NativeSelection":
        """Fast-path read selection entirely in C++ (usability filter,
        (name, strand) dedup, reservoir subsampling)."""
        rid = self.ref_id(chromosome)
        if rid is None:
            return NativeSelection(self, np.zeros(0, np.int32))
        buf = np.zeros(max(max_reads, 1), np.int32)
        n = self._lib.htpu_bam_select(
            self._h, rid, start, stop, max_reads, seed,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), buf.size)
        return NativeSelection(self, buf[:min(n, buf.size)].copy())

    def fetch(self, chromosome: str, start: int, stop: int):
        """Iterate AlignedReads overlapping a region."""
        rid = None
        for i, (name, _l) in enumerate(self.references):
            if name == chromosome:
                rid = i
                break
        if rid is None:
            return
        sel = np.nonzero((self.ref_ids == rid) & (self.ref_starts < stop)
                         & (self.ref_ends > start))[0]
        for i in sel:
            yield self.read(int(i))


class NativeSelection:
    """A set of selected read indices within a loaded NativeBam."""

    def __init__(self, bam: NativeBam, indices: np.ndarray):
        self.bam = bam
        self.indices = indices.astype(np.int32)
        self.pacbio = bam.pacbio

    def __len__(self):
        return len(self.indices)

    @property
    def ref_starts(self):
        return self.bam.ref_starts[self.indices]

    @property
    def ref_ends(self):
        return self.bam.ref_ends[self.indices]

    @property
    def mapqs(self):
        return self.bam.mapqs[self.indices]


class NativeWindow:
    """C++ window engine with the hello_tpu.window.Window query interface."""

    def __init__(self, reads: Sequence[AlignedRead], start: int, stop: int,
                 reference: str, window_start: int,
                 min_mapq: int = 10, q_threshold: int = 10,
                 snv_threshold: Optional[float] = None,
                 indel_threshold: Optional[float] = None,
                 min_count: Optional[int] = None,
                 reassembly_size: int = 10):
        lib = load_library()
        assert lib is not None, "native library unavailable"
        self._lib = lib
        self.reads = list(reads)
        n = len(self.reads)

        seqs = "".join(r.sequence for r in self.reads).encode()
        seq_offsets = np.zeros(n + 1, np.int64)
        quals = np.zeros(len(seqs), np.uint8)
        cigar_list = []
        cigar_offsets = np.zeros(n + 1, np.int64)
        pos = 0
        for i, r in enumerate(self.reads):
            L = len(r.sequence)
            quals[pos:pos + L] = r.qualities
            pos += L
            seq_offsets[i + 1] = pos
            for op, length in r.cigartuples:
                cigar_list.append((length << 4) | op)
            cigar_offsets[i + 1] = len(cigar_list)
        cigars = np.asarray(cigar_list, np.uint32)
        ref_starts = np.asarray([r.reference_start for r in self.reads], np.int64)
        mapqs = np.asarray([r.mapq for r in self.reads], np.int32)
        orientation = np.asarray([r.orientation for r in self.reads], np.int8)
        pacbio = np.asarray([1 if r.pacbio else 0 for r in self.reads], np.uint8)
        hp = np.asarray([r.hp for r in self.reads], np.int8)

        params = _Params()
        lib.htpu_default_params(ctypes.byref(params))
        params.min_mapq = min_mapq
        params.q_threshold = q_threshold
        if snv_threshold is not None:
            params.snv_threshold = snv_threshold
        if indel_threshold is not None:
            params.indel_threshold = indel_threshold
        if min_count is not None:
            params.min_count = min_count
        params.max_reassembly_region_size = reassembly_size

        def ptr(arr, typ):
            if arr.size == 0:
                return ctypes.cast(None, ctypes.POINTER(typ))
            return arr.ctypes.data_as(ctypes.POINTER(typ))

        self._h = lib.htpu_window_create(
            reference.encode(), len(reference), window_start, start, stop, n,
            seqs, ptr(seq_offsets, ctypes.c_int64),
            ptr(quals, ctypes.c_uint8),
            ptr(cigars, ctypes.c_uint32), ptr(cigar_offsets, ctypes.c_int64),
            ptr(ref_starts, ctypes.c_int64), ptr(mapqs, ctypes.c_int32),
            ptr(orientation, ctypes.c_int8), ptr(pacbio, ctypes.c_uint8),
            ptr(hp, ctypes.c_int8), ctypes.byref(params))
        assert self._h, "native window creation failed"

    @classmethod
    def from_selections(cls, selections, reference: str, window_start: int,
                        min_mapq: int = 10, q_threshold: int = 10,
                        snv_threshold=None, indel_threshold=None,
                        min_count=None, reassembly_size: int = 10):
        """Build the window directly from NativeBam selections — the read
        data never crosses into Python."""
        lib = load_library()
        self = cls.__new__(cls)
        self._lib = lib
        self._h = None
        self.reads = []  # no Python-side read objects on this path
        self._num_reads = int(sum(len(s) for s in selections))

        params = _Params()
        lib.htpu_default_params(ctypes.byref(params))
        params.min_mapq = min_mapq
        params.q_threshold = q_threshold
        if snv_threshold is not None:
            params.snv_threshold = snv_threshold
        if indel_threshold is not None:
            params.indel_threshold = indel_threshold
        if min_count is not None:
            params.min_count = min_count
        params.max_reassembly_region_size = reassembly_size

        n_bams = len(selections)
        bam_handles = (ctypes.c_void_p * n_bams)(
            *[s.bam._h for s in selections])
        pacbio_flags = np.asarray([1 if s.pacbio else 0 for s in selections],
                                  np.uint8)
        idx = np.concatenate([s.indices for s in selections])             if selections else np.zeros(0, np.int32)
        idx = np.ascontiguousarray(idx, np.int32)
        counts = np.asarray([len(s) for s in selections], np.int32)

        def ptr(arr, typ):
            if arr.size == 0:
                return ctypes.cast(None, ctypes.POINTER(typ))
            return arr.ctypes.data_as(ctypes.POINTER(typ))

        self._h = lib.htpu_window_create_from_bam(
            bam_handles, ptr(pacbio_flags, ctypes.c_uint8), n_bams,
            ptr(idx, ctypes.c_int32), ptr(counts, ctypes.c_int32),
            reference.encode(), len(reference), window_start, 0, 0,
            ctypes.byref(params))
        assert self._h, "native window creation failed"
        return self

    def __del__(self):
        try:
            if self._h:
                self._lib.htpu_window_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def differing_regions(self, strict: bool = True,
                          hybrid_hotspot: bool = False) -> List[Tuple[int, int]]:
        buf = np.zeros(2 * 4096, np.int64)
        n = self._lib.htpu_differing_regions(
            self._h, int(strict), int(hybrid_hotspot),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 4096)
        if n > 4096:
            buf = np.zeros(2 * n, np.int64)
            n = self._lib.htpu_differing_regions(
                self._h, int(strict), int(hybrid_hotspot),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        return [(int(buf[2 * i]), int(buf[2 * i + 1])) for i in range(n)]

    def assemble_region(self, regions: Sequence[Tuple[int, int]],
                        reassemble: bool):
        flat = np.asarray([x for r in regions for x in r], np.int64)
        self._lib.htpu_assemble_region(
            self._h,
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(regions), int(reassemble))

    def alleles_at(self, start: int, stop: int) -> List[str]:
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.htpu_alleles_at(self._h, start, stop, buf, len(buf))
        return _split_strings(buf.raw, n)

    # reusable query scratch (windows are queried single-threaded per
    # process; allocating/zeroing MB-scale temporaries per call showed up
    # in host-stage profiles)
    _supports_scratch = None

    def supports_at(self, start: int, stop: int):
        cls = NativeWindow
        if cls._supports_scratch is None:
            cls._supports_scratch = (
                ctypes.create_string_buffer(1 << 20),
                np.empty(4096, np.int32),
                np.empty(1 << 20, np.int32),
            )
        buf, counts, ids = cls._supports_scratch
        n = self._lib.htpu_supports_at(
            self._h, start, stop, buf, len(buf),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 4096,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ids.size)
        alleles = _split_strings(buf.raw, n)
        out = {}
        pos = 0
        for i, a in enumerate(alleles):
            out[a] = ids[pos:pos + counts[i]].tolist()
            pos += counts[i]
        return out

    def num_supports(self, start: int, stop: int, allele: str,
                     pacbio: bool) -> int:
        return self._lib.htpu_num_supports(self._h, start, stop,
                                           allele.encode(), int(pacbio))

    # site_query scratch: alleles, rows0, rows1, features (32 MB covers the
    # 10k-read selection cap x 2 platforms at 150x7 bytes/row)
    _site_scratch = None

    def site_query(self, start: int, stop: int, feature_length: int,
                   hybrid: bool, primary_pacbio: bool, include_hp: bool,
                   max_allele_len: int):
        """All supported alleles at the site with their feature tensors, in
        one native call; returns {allele: (tensor0, tensor1|None)} or None
        when the scratch buffers are too small (caller falls back to the
        per-allele path)."""
        cls = NativeWindow
        if cls._site_scratch is None:
            cls._site_scratch = (
                ctypes.create_string_buffer(1 << 20),
                np.empty(4096, np.int32),
                np.empty(4096, np.int32),
                np.empty(32 << 20, np.uint8),
            )
        names, rows0, rows1, feat = cls._site_scratch
        used = ctypes.c_int64(0)
        n = self._lib.htpu_site_query(
            self._h, start, stop, feature_length, int(include_hp),
            int(hybrid), int(primary_pacbio), max_allele_len,
            names, len(names),
            rows0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rows1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rows0.size,
            feat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), feat.size,
            ctypes.byref(used))
        if n < 0:
            return None
        channels = 7 if include_hp else 6
        alleles = _split_strings(names.raw, n)
        out = {}
        view = feat[:used.value].reshape(-1, feature_length, channels)
        row = 0
        for i, allele in enumerate(alleles):
            t0 = view[row:row + rows0[i]].copy()
            row += int(rows0[i])
            t1 = None
            if hybrid:
                t1 = view[row:row + rows1[i]].copy()
                row += int(rows1[i])
            out[allele] = (t0, t1)
        return out

    def features(self, start: int, stop: int, allele: str,
                 feature_length: int, pacbio: bool,
                 include_hp: bool, max_rows: Optional[int] = None) -> np.ndarray:
        channels = 7 if include_hp else 6
        if max_rows is None:
            # exact row count: one row per supporting read of this platform
            max_rows = self.num_supports(start, stop, allele, pacbio) + 1
        out = np.zeros((max_rows, feature_length, channels), np.uint8)
        n = self._lib.htpu_features(
            self._h, start, stop, allele.encode(), feature_length,
            int(pacbio), int(include_hp),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_rows)
        if n >= max_rows:
            return out
        return out[:max(n, 1)]


class ChunkSites:
    """Raw output of the native chunk orchestrator (one call per genome
    chunk; see native/src/chunk.cpp and htpu_chunk_sites in hello_native.h).

    Arrays are copies — the native handle is freed before returning — and the
    per-allele feature tensors are views into one contiguous buffer."""

    def __init__(self, positions, stops, nalleles, site_labels, alleles,
                 rows0, rows1, labels, features, codes=None, scalars=None):
        self.positions = positions
        self.stops = stops
        self.nalleles = nalleles
        self.site_labels = site_labels
        self.alleles = alleles          # flat list, \0-split, emission order
        self.rows0 = rows0
        self.rows1 = rows1
        self.labels = labels
        self.features = features        # flat uint8, all rows concatenated
        # coded emission: 1-byte cell codes [n_rows, L] + per-row scalars
        # [n_rows, nscal] instead of dense features (htpu_chunk_sites_coded)
        self.codes = codes
        self.scalars = scalars


def chunk_sites(bams: Sequence["NativeBam"], chromosome: str,
                chunk_start: int, chunk_stop: int, chrom_len: int,
                ref_fetch, rng, *,
                subchunk_size: int, hybrid: bool, pacbio: bool,
                hybrid_hotspot: bool, include_hp: bool,
                feature_length: int, max_allele_len: int,
                hs_max_reads: Sequence[int],
                cand_cap: Sequence[int], cand_per: Sequence[int],
                q_threshold: int = 10, min_mapq: int = 10,
                reassembly_size: int = 10,
                min_distance: int = 30, flanking: int = 75,
                max_items_per_group: int = 1024,
                coded: bool = False) -> Optional[ChunkSites]:
    """Run the whole per-chunk candidate pipeline natively.

    ``ref_fetch(start, stop) -> str`` must implement FastaFile.fetch clamping;
    ``rng`` supplies the selection seeds (one ``randrange(2**62)`` per BAM per
    selection, identical to the Python driver's draw order).

    ``coded=True`` emits the 1-byte coded wire representation (codes +
    per-row scalars) straight from the featurizer — no dense tensor is ever
    materialised.  Returns None in that mode if any row was not codable
    (never true of featurizer output): the caller re-runs the chunk dense."""
    lib = load_library()
    assert lib is not None, "native library unavailable"
    n_bams = len(bams)

    params = _Params()
    lib.htpu_default_params(ctypes.byref(params))
    params.min_mapq = min_mapq
    params.q_threshold = q_threshold
    params.max_reassembly_region_size = reassembly_size

    handles = (ctypes.c_void_p * n_bams)(*[b._h for b in bams])
    pb_flags = np.asarray([1 if b.pacbio else 0 for b in bams], np.uint8)
    rids = np.asarray([(-1 if b.ref_id(chromosome) is None
                        else b.ref_id(chromosome)) for b in bams], np.int32)
    hs_arr = np.asarray(hs_max_reads, np.int32)
    cap_arr = np.asarray(cand_cap, np.int32)
    per_arr = np.asarray(cand_per, np.int32)

    # ctypes swallows callback exceptions (returning 0), which would corrupt
    # results silently — record and re-raise after the native call instead
    callback_errors: List[BaseException] = []

    @SEED_FN
    def _seed():
        try:
            return rng.randrange(2 ** 62)
        except BaseException as exc:  # noqa: BLE001
            callback_errors.append(exc)
            return 0

    @REF_FN
    def _ref(start, stop, out, cap):
        try:
            data = ref_fetch(start, stop).encode()
        except BaseException as exc:  # noqa: BLE001
            callback_errors.append(exc)
            return 0
        n = min(len(data), cap)
        ctypes.memmove(out, data, n)
        return n

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    entry = lib.htpu_chunk_sites_coded if coded else lib.htpu_chunk_sites
    h = entry(
        handles, ptr(pb_flags, ctypes.c_uint8), ptr(rids, ctypes.c_int32),
        n_bams, chunk_start, chunk_stop, chrom_len,
        subchunk_size, min_distance, flanking, max_items_per_group,
        int(hybrid), int(pacbio), int(hybrid_hotspot), int(include_hp),
        feature_length, max_allele_len,
        ptr(hs_arr, ctypes.c_int32), ptr(cap_arr, ctypes.c_int32),
        ptr(per_arr, ctypes.c_int32),
        ctypes.byref(params), _seed, _ref)
    if callback_errors:
        if h:
            lib.htpu_chunk_destroy(h)
        raise callback_errors[0]
    assert h, "native chunk orchestration failed"
    try:
        n = lib.htpu_chunk_num_sites(h)
        positions = _as_array(lib.htpu_chunk_positions(h), n, np.int64).copy()
        stops = _as_array(lib.htpu_chunk_stops(h), n, np.int64).copy()
        nalleles = _as_array(lib.htpu_chunk_nalleles(h), n, np.int32).copy()
        site_labels = _as_array(lib.htpu_chunk_site_labels(h), n,
                                np.int8).copy()
        total = int(nalleles.sum()) if n else 0
        rows0 = _as_array(lib.htpu_chunk_rows0(h), total, np.int32).copy()
        rows1 = _as_array(lib.htpu_chunk_rows1(h), total, np.int32).copy()
        labels = _as_array(lib.htpu_chunk_labels(h), total, np.int8).copy()
        a_len = lib.htpu_chunk_alleles_len(h)
        raw = ctypes.string_at(lib.htpu_chunk_alleles(h), a_len) if a_len else b""
        alleles = raw.decode().split("\0")[:-1] if a_len else []
        features = codes = scalars = None
        if coded:
            if lib.htpu_chunk_coded(h) != 1:      # a row was not codable
                return None
            c_len = lib.htpu_chunk_codes_len(h)
            codes = _as_array(lib.htpu_chunk_codes(h), c_len,
                              np.uint8).copy().reshape(-1, feature_length)
            nscal = 3 if include_hp else 2
            s_len = lib.htpu_chunk_scalars_len(h)
            scalars = _as_array(lib.htpu_chunk_scalars(h), s_len,
                                np.uint8).copy().reshape(-1, nscal)
        else:
            f_len = lib.htpu_chunk_features_len(h)
            features = _as_array(lib.htpu_chunk_features(h), f_len,
                                 np.uint8).copy()
    finally:
        lib.htpu_chunk_destroy(h)
    return ChunkSites(positions, stops, nalleles, site_labels, alleles,
                      rows0, rows1, labels, features, codes, scalars)


def _split_strings(raw: bytes, n: int) -> List[str]:
    out = []
    pos = 0
    for _ in range(max(n, 0)):
        end = raw.index(b"\x00", pos)
        out.append(raw[pos:end].decode())
        pos = end + 1
    return out
