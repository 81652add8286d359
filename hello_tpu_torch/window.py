"""Window engine: per-active-region candidate search over a batch of reads.

The host-side equivalent of the reference's AlleleSearcherLite (python wrapper
reference python/AlleleSearcherLite.py:27-338 + the C++ engine behind it):
counting, hotspot detection, assembly, support queries, and feature tensors
for one genomic window.

Two interchangeable backends implement the heavy lifting:
  * the native C++ engine (native/libhello_native.so) — production path;
  * the pure-Python engine (counts.py / assembly.py / featurize.py) — the
    semantic reference, also used when the library isn't built.
Fuzz tests assert their equivalence; select explicitly with
``HELLO_TPU_NATIVE=0/1`` or the ``backend`` argument.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .assembly import AssemblyEngine
from .constants import FEATURE_LENGTH, MIN_MAPQ, Q_THRESHOLD
from .counts import CountsEngine
from .featurize import compute_features
from .reads import AlignedRead


class LocationOutOfBounds(Exception):
    pass


class _PythonBackend:
    """Reference backend over the pure-Python engines."""

    def __init__(self, reads, reference, window_start, min_mapq, q_threshold,
                 snv_threshold, indel_threshold, min_count, reassembly_size):
        self.reads = reads
        self.reference = reference
        self.window_start = window_start
        extra = {}
        if snv_threshold is not None:
            extra["snv_threshold"] = snv_threshold
        if indel_threshold is not None:
            extra["indel_threshold"] = indel_threshold
        if min_count is not None:
            extra["min_count"] = min_count
        self.counts = CountsEngine(reference, window_start, min_mapq=min_mapq,
                                   q_threshold=q_threshold, **extra)
        self.counts.add_reads(reads)
        self.assembler = AssemblyEngine(
            reads, reference, window_start, min_mapq=min_mapq,
            q_threshold=q_threshold,
            max_reassembly_region_size=reassembly_size)

    def differing_regions(self, region_start, region_stop, strict, hybrid_hotspot):
        return self.counts.differing_regions(
            region_start, region_stop, strict=strict,
            hybrid_hotspot=hybrid_hotspot)

    def assemble_region(self, regions, reassemble):
        self.assembler.assemble_alleles_from_reads(regions, reassemble)

    def alleles_at(self, start, stop):
        return self.assembler.alleles_at(start, stop)

    def supports_at(self, start, stop):
        return self.assembler.supports_at(start, stop)

    def num_supports(self, start, stop, allele, pacbio):
        ids = self.assembler.supports_at(start, stop).get(allele, [])
        return sum(1 for rid in ids if self.reads[rid].pacbio == pacbio)

    def features(self, start, stop, allele, feature_length, pacbio, include_hp):
        ids = self.assembler.supports_at(start, stop).get(allele, [])
        return compute_features(self.reads, ids, self.reference,
                                self.window_start, start, stop, pacbio,
                                feature_length, include_hp)


class _NativeBackend:
    """C++ backend (see hello_tpu.native)."""

    def __init__(self, reads, reference, window_start, min_mapq, q_threshold,
                 snv_threshold, indel_threshold, min_count, reassembly_size):
        from .native import NativeWindow
        self._w = None  # placate __del__ on constructor failure
        self._w = NativeWindow(
            reads, 0, 0, reference, window_start,
            min_mapq=min_mapq, q_threshold=q_threshold,
            snv_threshold=snv_threshold, indel_threshold=indel_threshold,
            min_count=min_count, reassembly_size=reassembly_size)

    @classmethod
    def from_native_window(cls, native_window):
        self = cls.__new__(cls)
        self._w = native_window
        return self

    def differing_regions(self, region_start, region_stop, strict, hybrid_hotspot):
        # native clusters globally; apply the strict window filter here so the
        # region bounds need not cross the ctypes boundary
        regions = self._w.differing_regions(strict=False,
                                            hybrid_hotspot=hybrid_hotspot)
        if strict:
            regions = [r for r in regions
                       if region_start <= r[0] and r[1] <= region_stop]
        return regions

    def assemble_region(self, regions, reassemble):
        self._w.assemble_region(regions, reassemble)

    def alleles_at(self, start, stop):
        return self._w.alleles_at(start, stop)

    def supports_at(self, start, stop):
        return self._w.supports_at(start, stop)

    def num_supports(self, start, stop, allele, pacbio):
        return self._w.num_supports(start, stop, allele, pacbio)

    def features(self, start, stop, allele, feature_length, pacbio, include_hp):
        return self._w.features(start, stop, allele, feature_length, pacbio,
                                include_hp)

    def site_query(self, start, stop, feature_length, hybrid, primary_pacbio,
                   include_hp, max_allele_len):
        return self._w.site_query(start, stop, feature_length, hybrid,
                                  primary_pacbio, include_hp, max_allele_len)


def _native_available() -> bool:
    if os.environ.get("HELLO_TPU_NATIVE", "1") == "0":
        return False
    try:
        from . import native
        return native.available()
    except Exception:
        return False


class Window:
    """Candidate-variant engine over one window of reads.

    reads: all reads of the window (hybrid mode: Illumina first, then PacBio,
    with their ``pacbio`` flags set). ``start``/``stop`` bound the region of
    interest; the internal window extends +/-10bp beyond the reads
    (reference AlleleSearcherLite.py:135-152).
    """

    def __init__(self, reads: Sequence[AlignedRead], start: int, stop: int,
                 ref_view, chromosome: str,
                 hybrid: bool = False,
                 pacbio: bool = False,
                 feature_length: int = FEATURE_LENGTH,
                 min_mapq: int = MIN_MAPQ, q_threshold: int = Q_THRESHOLD,
                 hybrid_hotspot: bool = False,
                 reassembly_size: int = 10,
                 include_hp: bool = False,
                 snv_threshold: float = None,
                 indel_threshold: float = None,
                 min_count: int = None,
                 left_align: bool = False,
                 backend: Optional[str] = None):
        self.reads = list(reads)
        if left_align:
            # optional internal cigar left-alignment (the reference's
            # useInternalLeftAlignment / leftAlignCigars path, gated off in
            # its shipping config); applies before counting and assembly
            from .cigar import left_align_cigars
            for r in self.reads:
                new_start, new_cigars = left_align_cigars(
                    r.sequence, r.reference_start, r.cigartuples,
                    ref_view[max(0, r.reference_start - 1):r.reference_end + 1],
                    ref_offset=max(0, r.reference_start - 1),
                    indel_realigned=True)
                r.reference_start = new_start
                r.cigartuples = new_cigars
        self.start = start
        self.stop = stop
        self.chromosome = chromosome
        self.hybrid = hybrid
        self.pacbio = pacbio and not hybrid
        self.feature_length = feature_length
        self.min_mapq = min_mapq
        self.q_threshold = q_threshold
        self.hybrid_hotspot = hybrid_hotspot
        self.reassembly_size = reassembly_size
        self.include_hp = include_hp
        self.assembly_start: Optional[int] = None
        self.assembly_stop: Optional[int] = None
        self._regions: Optional[List[Tuple[int, int]]] = None

        ref_starts = [r.reference_start for r in self.reads]
        # clamp at the chromosome start: the reference engine raises here and
        # silently drops whole chunks whose reads reach position 0
        # (AlleleSearcherLite.py:142-143); clamping keeps those chunks callable
        window_start = max(0, min(ref_starts + [start]) - 10)
        if self.reads:
            window_end = max(r.reference_end for r in self.reads)
        else:
            window_end = stop
        chrom_len = len(ref_view)
        if window_end > chrom_len or window_end < 0:
            raise LocationOutOfBounds(f"window end {window_end} out of range")
        window_end += 10
        self.window_start = window_start
        self.reference = ref_view[window_start:window_end]

        if backend is None:
            backend = "native" if _native_available() else "python"
        cls = _NativeBackend if backend == "native" else _PythonBackend
        self.backend_name = backend
        self._backend = cls(self.reads, self.reference, window_start,
                            min_mapq, q_threshold, snv_threshold,
                            indel_threshold, min_count, reassembly_size)

    @classmethod
    def from_native_selections(cls, selections, start: int, stop: int,
                               ref_view, chromosome: str,
                               hybrid: bool = False, pacbio: bool = False,
                               feature_length: int = FEATURE_LENGTH,
                               min_mapq: int = MIN_MAPQ,
                               q_threshold: int = Q_THRESHOLD,
                               hybrid_hotspot: bool = False,
                               reassembly_size: int = 10,
                               include_hp: bool = False,
                               snv_threshold: float = None,
                               indel_threshold: float = None,
                               min_count: int = None) -> "Window":
        """Fast path: build the window directly from native BAM selections —
        read data never crosses the Python boundary."""
        from .native import NativeWindow

        self = cls.__new__(cls)
        self.reads = []
        self._selections = [sel for sel in selections if len(sel)]
        self.start = start
        self.stop = stop
        self.chromosome = chromosome
        self.hybrid = hybrid
        self.pacbio = pacbio and not hybrid
        self.feature_length = feature_length
        self.min_mapq = min_mapq
        self.q_threshold = q_threshold
        self.hybrid_hotspot = hybrid_hotspot
        self.reassembly_size = reassembly_size
        self.include_hp = include_hp
        self.assembly_start = None
        self.assembly_stop = None
        self._regions = None

        starts = [int(sel.ref_starts.min()) for sel in self._selections]
        ends = [int(sel.ref_ends.max()) for sel in self._selections]
        window_start = max(0, min(starts + [start]) - 10)
        window_end = max(ends) if ends else stop
        chrom_len = len(ref_view)
        if window_end > chrom_len or window_end < 0:
            raise LocationOutOfBounds(f"window end {window_end} out of range")
        window_end += 10
        self.window_start = window_start
        self.reference = ref_view[window_start:window_end]

        self.backend_name = "native"
        nw = NativeWindow.from_selections(
            self._selections, self.reference, window_start,
            min_mapq=min_mapq, q_threshold=q_threshold,
            snv_threshold=snv_threshold, indel_threshold=indel_threshold,
            min_count=min_count, reassembly_size=reassembly_size)
        self._backend = _NativeBackend.from_native_window(nw)
        return self

    # -- hotspot detection --------------------------------------------------

    def differing_regions(self, strict: bool = True) -> List[Tuple[int, int]]:
        """Candidate regions clipped to [start, stop]
        (reference AlleleSearcherLite.py:191-206)."""
        if self._regions is None:
            raw = self._backend.differing_regions(
                self.start, self.stop, strict, self.hybrid_hotspot)
            self._regions = [
                (max(self.start, a), min(self.stop, b)) for a, b in raw]
        return self._regions

    @property
    def cluster(self):
        return self.differing_regions()

    # -- assembly -----------------------------------------------------------

    def assemble_region(self, reassemble: Optional[bool] = None):
        """Assemble alleles from reads across all differing regions.

        ``reassemble`` defaults to the reference policy: hybrid mode with
        average Illumina coverage > 14 (reference AlleleSearcherLite.py:258-268).
        """
        if reassemble is None:
            reassemble = self.hybrid and self._illumina_coverage() > 14
        self._backend.assemble_region(self.differing_regions(), reassemble)

    def _illumina_coverage(self) -> float:
        if self.stop <= self.start:
            return 0.0
        span = self.stop - self.start
        covered = 0
        if getattr(self, "_selections", None):
            for sel in self._selections:
                if sel.pacbio:
                    continue
                starts = np.maximum(sel.ref_starts, self.start)
                ends = np.minimum(sel.ref_ends, self.stop)
                usable = sel.mapqs >= 10
                covered += int(np.sum(np.maximum(ends - starts, 0) * usable))
            return covered / span
        for r in self.reads:
            if r.pacbio or r.mapq < 10:
                continue
            covered += max(0, min(r.reference_end, self.stop) - max(r.reference_start, self.start))
        return covered / span

    def assemble(self, start: Optional[int] = None, stop: Optional[int] = None):
        """Select the assembly site for subsequent support/feature queries."""
        self.assembly_start = self.start if start is None else start
        self.assembly_stop = self.stop if stop is None else stop
        self._supports = self._backend.supports_at(self.assembly_start,
                                                   self.assembly_stop)

    @property
    def alleles_at_site(self) -> List[str]:
        return list(self._supports.keys())

    def determine_alleles_in_region(self, start: int, stop: int) -> List[str]:
        return self._backend.alleles_at(start, stop)

    def num_reads_supporting_allele(self, allele: str, pacbio: bool) -> int:
        return self._backend.num_supports(self.assembly_start,
                                          self.assembly_stop, allele, pacbio)

    # -- featurization ------------------------------------------------------

    def compute_features(self, allele: str, index: int = 0) -> np.ndarray:
        """Feature tensor for one allele: index 0 = Illumina (or the single
        platform), 1 = PacBio in hybrid mode."""
        pacbio = (index == 1) if self.hybrid else self.pacbio
        return self._backend.features(
            self.assembly_start, self.assembly_stop, allele,
            self.feature_length, pacbio, self.include_hp)

    def query_site(self, start: int, stop: int,
                   max_allele_length: int) -> dict:
        """All supported alleles at [start, stop) with their feature tensors
        in one batched query: {allele: (tensor0, tensor1|None)}.

        Emits every assembled allele no longer than ``max_allele_length``
        with at least one supporting read (either platform in hybrid mode);
        a platform with zero supports gets a single zero feature row, as in
        :meth:`compute_features`.  The native backend answers this with a
        single engine call; the generic path below (also the semantic
        reference for it) composes the per-allele primitives."""
        primary = self.pacbio
        fast = getattr(self._backend, "site_query", None)
        if fast is not None:
            out = fast(start, stop, self.feature_length, self.hybrid,
                       primary, self.include_hp, max_allele_length)
            if out is not None:
                return out
        out = {}
        for allele in sorted(self._backend.supports_at(start, stop)):
            if len(allele) > max_allele_length:
                continue
            supports = self._backend.num_supports(start, stop, allele, primary)
            if self.hybrid:
                supports += self._backend.num_supports(start, stop, allele,
                                                       True)
            if supports == 0:
                continue
            t0 = self._backend.features(start, stop, allele,
                                        self.feature_length, primary,
                                        self.include_hp)
            t1 = None
            if self.hybrid:
                t1 = self._backend.features(start, stop, allele,
                                            self.feature_length, True,
                                            self.include_hp)
            out[allele] = (t0, t1)
        return out
