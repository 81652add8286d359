"""Candidate-site generation: cluster candidate intervals, assemble, and emit
per-site scoring work (tensors + alleles).

Mirrors the reference site generator (reference python/trainDataTools.py:980-1103
``data`` with ``clusterLocations``/``split_clusters``/``createTensors``) minus
the torch glue: output is :class:`hello_tpu.pipeline.batching.SiteWork` units
ready for padded-batch packing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import (
    FEATURE_LENGTH, FLANKING_BASES, MAX_ALLELE_LENGTH, MIN_DISTANCE,
)
from ..io.fasta import ChromView, FastaFile
from ..window import LocationOutOfBounds, Window
from .batching import SiteWork, padded_ref_segment
from .hotspots import ReadSource, build_window


@dataclasses.dataclass
class CodedChunkBlock:
    """A whole chunk's coded sites as a handful of contiguous arrays — the
    worker->main IPC payload of the production caller.

    The native orchestrator already emits one contiguous codes/scalars block
    per chunk; shipping per-site :class:`CodedSiteWork` views re-pickles
    thousands of small arrays per chunk (~90 ms serialise + ~60 ms
    deserialise per bench pass, the latter serial in the device-owning
    process).  This container pickles as ~10 arrays; the main process
    expands it back to the identical CodedSiteWork views with
    :meth:`to_sites` (asserted in tests/test_coded_wire.py)."""
    chromosome: str
    hybrid: bool
    positions: "np.ndarray"
    stops: "np.ndarray"
    nalleles: "np.ndarray"
    rows0: "np.ndarray"
    rows1: Optional["np.ndarray"]
    labels: "np.ndarray"
    site_labels: "np.ndarray"
    alleles: List[str]            # flat, emission order
    codes: "np.ndarray"           # [n_rows, L] uint8
    scalars: "np.ndarray"         # [n_rows, nscal] uint8
    ref_codes: "np.ndarray"       # [num_sites, L] uint8

    def __len__(self) -> int:
        return len(self.positions)

    def to_sites(self) -> List["CodedSiteWork"]:
        from .batching import CodedSiteWork

        sites: List[CodedSiteWork] = []
        a_off = 0
        f_off = 0
        for si in range(len(self.positions)):
            na = int(self.nalleles[si])
            c0, s0, c1, s1 = [], [], [], []
            labels = []
            for k in range(na):
                r0 = int(self.rows0[a_off + k])
                c0.append(self.codes[f_off:f_off + r0])
                s0.append(self.scalars[f_off:f_off + r0])
                f_off += r0
                if self.hybrid:
                    r1 = int(self.rows1[a_off + k])
                    c1.append(self.codes[f_off:f_off + r1])
                    s1.append(self.scalars[f_off:f_off + r1])
                    f_off += r1
                labels.append(int(self.labels[a_off + k]))
            sites.append(CodedSiteWork(
                chromosome=self.chromosome, start=int(self.positions[si]),
                stop=int(self.stops[si]),
                alleles=self.alleles[a_off:a_off + na],
                codes0=c0, scal0=s0,
                codes1=c1 if self.hybrid else None,
                scal1=s1 if self.hybrid else None,
                ref_codes=self.ref_codes[si],
                labels=labels, site_label=int(self.site_labels[si])))
            a_off += na
        return sites


@dataclasses.dataclass
class CandidateRecord:
    """A candidate site: ref allele + supported alleles
    (reference trainDataTools.createRecord:402-439)."""
    chromosome: str
    position: int
    ref: str
    alt: List[str]          # non-ref alleles
    gt: List[int]           # indices into [ref] + alt; -1 -> labeling failed

    @property
    def stop(self) -> int:
        return self.position + len(self.ref)

    def alleles(self) -> List[str]:
        return [self.ref] + self.alt


def make_candidate_record(chromosome, position, ref_allele, alleles_at_site):
    alleles_no_ref = [a for a in alleles_at_site if a != ref_allele]
    if ref_allele in alleles_at_site:
        gts = list(range(len(alleles_at_site)))
    else:
        gts = [i + 1 for i in range(len(alleles_at_site))]
    return CandidateRecord(chromosome, position, ref_allele, alleles_no_ref, gts)


def cluster_intervals(intervals: Sequence[Tuple[int, int]],
                      distance: int = MIN_DISTANCE,
                      max_allele_length: int = MAX_ALLELE_LENGTH,
                      max_items: int = 1024) -> Iterator[List[Tuple[int, int]]]:
    """Cluster candidate intervals (reference trainDataTools.clusterLocations:477-514)."""
    cluster: List[Tuple[int, int]] = []
    for loc in intervals:
        if loc[1] - loc[0] > max_allele_length:
            if cluster:
                yield cluster
                cluster = []
                continue
        if not cluster:
            cluster.append(loc)
        elif loc[0] - cluster[-1][1] < distance and len(cluster) < max_items:
            cluster.append(loc)
        else:
            yield cluster
            cluster = [loc]
    if cluster:
        yield cluster


def split_clusters(cluster: List[Tuple[int, int]], ref_view,
                   max_items: int = 1024):
    """Split oversized clusters; yields (sub_cluster, segment, segment_start)
    (reference trainDataTools.split_clusters:517-554)."""
    if len(cluster) <= max_items:
        # clamp at the chromosome start: ref_view slicing clamps the FETCH to
        # position 0, so an unclamped (negative) segment_start would shift
        # every index into the returned segment (the reference never reaches
        # this case — it drops chunks touching position 0)
        start = max(0, cluster[0][0] - MIN_DISTANCE // 2)
        stop = cluster[-1][1] + MIN_DISTANCE // 2
        yield cluster, ref_view[start:stop], start
        return
    indices = list(range(0, len(cluster), max_items))
    last_chunk = None
    for i, index in enumerate(indices):
        chunk = cluster[index:index + max_items]
        next_chunk = cluster[indices[i + 1]:indices[i + 1] + max_items] \
            if i + 1 < len(indices) else None
        start = max(0, chunk[0][0] - MIN_DISTANCE // 2)
        if last_chunk:
            start = max(start, last_chunk[-1][1])
        stop = chunk[-1][1] + MIN_DISTANCE // 2
        if next_chunk:
            stop = min(stop, next_chunk[0][0])
        yield chunk, ref_view[start:stop], start
        last_chunk = chunk


def generate_sites(read_sources: Sequence[ReadSource], ref: FastaFile,
                   chromosome: str, intervals: Sequence[Tuple[int, int]],
                   windows: Optional[Dict] = None,
                   pacbio: bool = False,
                   include_hp: bool = False,
                   hybrid_hotspot: bool = False,
                   feature_length: int = FEATURE_LENGTH,
                   max_allele_length: int = MAX_ALLELE_LENGTH,
                   max_items_per_group: int = 1024,
                   q_threshold: int = 10, min_mapq: int = 10,
                   reassembly_size: int = 10,
                   labeler=None, stats: Optional[Dict[str, int]] = None
                   ) -> Iterator[SiteWork]:
    """Yield SiteWork per candidate site.

    ``windows``: optional reuse of Window objects built during candidate
    detection, keyed by active region (matching the reference's
    ``reuseSearchers`` path).  ``labeler``: optional callable
    (chromosome, window, cluster, segment, start) -> list[CandidateRecord]
    used in training mode to attach ground-truth genotypes.
    """
    hybrid = len(read_sources) > 1
    ref_view = ChromView(ref, chromosome)
    channels = 7 if include_hp else 6

    for cluster in cluster_intervals(sorted(intervals),
                                     max_items=max_items_per_group):
        start = cluster[0][0] - MIN_DISTANCE // 2
        stop = cluster[-1][1] + MIN_DISTANCE // 2 - 1

        window = None
        if windows:
            for (a, b), w in windows.items():
                if a <= start < stop <= b:
                    window = w
                    break
        if window is None:
            try:
                window = build_window(
                    read_sources, ref_view, chromosome,
                    max(0, start - FLANKING_BASES), stop + FLANKING_BASES,
                    start, stop,
                    hybrid=hybrid, pacbio=pacbio,
                    hybrid_hotspot=hybrid_hotspot, include_hp=include_hp,
                    q_threshold=q_threshold, min_mapq=min_mapq,
                    reassembly_size=reassembly_size)
                if window is None:
                    continue
            except LocationOutOfBounds:
                continue

        window.assemble_region()
        site_cluster = window.cluster
        if not site_cluster:
            continue

        for sub_cluster, segment, seg_start in split_clusters(
                site_cluster, ref_view, max_items_per_group):
            records: List[CandidateRecord] = []
            for spot in sub_cluster:
                ref_allele = segment[spot[0] - seg_start: spot[1] - seg_start]
                if not ref_allele:
                    continue
                alleles = sorted(set(window.determine_alleles_in_region(*spot)))
                records.append(make_candidate_record(
                    chromosome, spot[0], ref_allele, alleles))
            if not records:
                continue
            records.sort(key=lambda r: r.position)

            if labeler is not None:
                records = labeler(chromosome, window, sub_cluster, segment,
                                  seg_start, records)
                if records is None:
                    # labeling region too long (reference yields TOO_LONG)
                    if stats is not None:
                        stats["too_long"] = stats.get("too_long", 0) + 1
                    continue
                if records and -1 in records[0].gt:
                    # truth haplotypes unmatched (reference yields MISSED)
                    if stats is not None:
                        stats["missed"] = stats.get("missed", 0) + 1
                    continue
                if not records:
                    continue

            for record in records:
                yield _site_tensors(window, record, hybrid, include_hp,
                                    feature_length, max_allele_length,
                                    ref_view, channels)


def native_chunk_site_work(bam_paths: Sequence[str], ref: FastaFile,
                           chromosome: str, start: int, stop: int,
                           options: Dict, rng) -> Optional[List[SiteWork]]:
    """All host stages for one genome chunk in a single native call
    (native/src/chunk.cpp), returning the same SiteWork list as the staged
    Python pipeline (hotspots -> candidate intervals -> generate_sites) —
    tests/test_native_chunk.py asserts exact equivalence.

    Returns None when the native fast path is unavailable (library not built,
    a non-native BAM reader, or ``HELLO_TPU_NATIVE_CHUNK=0``), in which case
    the caller runs the staged pipeline."""
    import os as _os
    if _os.environ.get("HELLO_TPU_NATIVE_CHUNK", "1") == "0":
        return None
    try:
        from .. import native
        if not native.available():
            return None
    except Exception:
        return None
    from ..constants import (
        CHUNK_SIZE_ILLUMINA, CHUNK_SIZE_PACBIO, MAX_ITEMS_PER_GROUP_CALL,
        MAX_NUM_READS_ILLUMINA, MAX_NUM_READS_PACBIO, READ_RATE_ILLUMINA,
        READ_RATE_PACBIO,
    )
    from .hotspots import REGION_OPEN_FLANK, _open_bam

    pacbio = options.get("pacbio", False)
    hybrid = len(bam_paths) > 1
    region = (chromosome, max(int(start) - REGION_OPEN_FLANK, 0),
              int(stop) + REGION_OPEN_FLANK)
    bams, hs_max, cap, per = [], [], [], []
    for i, path in enumerate(bam_paths):
        is_pb = (i > 0) if hybrid else pacbio
        bam = _open_bam(path, is_pb, region=region)
        if not isinstance(bam, native.NativeBam):
            return None
        bams.append(bam)
        hs_max.append(MAX_NUM_READS_PACBIO if is_pb else MAX_NUM_READS_ILLUMINA)
        rate = READ_RATE_PACBIO if is_pb else READ_RATE_ILLUMINA
        cap.append(rate[0])
        per.append(rate[1])

    feature_length = options.get("feature_length", FEATURE_LENGTH)
    include_hp = options.get("include_hp", False)
    channels = 7 if include_hp else 6
    row_bytes = feature_length * channels

    # coded emission (wire == "coded"): the featurizer's rows come back as
    # 1-byte cell codes + per-row scalars and pack straight into
    # CodedSiteWork — the dense [R, L, C] tensors are never materialised
    wire_coded = options.get("wire") == "coded"

    def _run(coded):
        return native.chunk_sites(
            bams, chromosome, start, stop, ref.length(chromosome),
            lambda a, b: ref.fetch(chromosome, a, b), rng,
            subchunk_size=(CHUNK_SIZE_PACBIO if (pacbio or hybrid)
                           else CHUNK_SIZE_ILLUMINA),
            hybrid=hybrid, pacbio=pacbio,
            hybrid_hotspot=options.get("hybrid_hotspot", False),
            include_hp=include_hp,
            feature_length=feature_length, max_allele_len=MAX_ALLELE_LENGTH,
            hs_max_reads=hs_max, cand_cap=cap, cand_per=per,
            q_threshold=options.get("q_threshold", 10),
            min_mapq=options.get("min_mapq", 10),
            reassembly_size=options.get("reassembly_size", 10),
            min_distance=MIN_DISTANCE, flanking=FLANKING_BASES,
            max_items_per_group=MAX_ITEMS_PER_GROUP_CALL, coded=coded)

    out = _run(wire_coded)
    if out is None:      # a row was not codable: identical seeds, dense run
        return None      # (caller falls back to the staged Python pipeline)

    coded_out = out.codes is not None
    L = feature_length
    if coded_out and options.get("chunk_block"):
        # consolidated IPC payload: ship the orchestrator's contiguous
        # arrays as-is; the main process expands to CodedSiteWork views
        from .batching import ref_segment_codes
        S = len(out.positions)
        refc = np.empty((S, L), np.uint8)
        for si in range(S):
            pos, st = int(out.positions[si]), int(out.stops[si])
            left = (pos + st) // 2 - L // 2
            refc[si] = ref_segment_codes(
                ref.fetch(chromosome, left, left + L), left, L)
        return CodedChunkBlock(
            chromosome=chromosome, hybrid=hybrid,
            positions=out.positions, stops=out.stops, nalleles=out.nalleles,
            rows0=out.rows0, rows1=out.rows1 if hybrid else None,
            labels=out.labels, site_labels=out.site_labels,
            alleles=out.alleles, codes=out.codes, scalars=out.scalars,
            ref_codes=refc)
    sites: list = []
    a_off = 0
    f_off = 0            # dense: bytes; coded: rows
    for si in range(len(out.positions)):
        na = int(out.nalleles[si])
        alleles = out.alleles[a_off:a_off + na]
        tensors0, tensors1 = [], []
        labels = []
        for k in range(na):
            r0 = int(out.rows0[a_off + k])
            r1 = int(out.rows1[a_off + k]) if hybrid else 0
            if coded_out:
                tensors0.append((out.codes[f_off:f_off + r0],
                                 out.scalars[f_off:f_off + r0]))
                f_off += r0
                if hybrid:
                    tensors1.append((out.codes[f_off:f_off + r1],
                                     out.scalars[f_off:f_off + r1]))
                    f_off += r1
            else:
                tensors0.append(out.features[f_off:f_off + r0 * row_bytes]
                                .reshape(r0, L, channels))
                f_off += r0 * row_bytes
                if hybrid:
                    tensors1.append(
                        out.features[f_off:f_off + r1 * row_bytes]
                        .reshape(r1, L, channels))
                    f_off += r1 * row_bytes
            labels.append(int(out.labels[a_off + k]))
        pos = int(out.positions[si])
        site_stop = int(out.stops[si])
        mid = (pos + site_stop) // 2
        left = mid - L // 2
        if coded_out:
            from .batching import CodedSiteWork, ref_segment_codes
            sites.append(CodedSiteWork(
                chromosome=chromosome, start=pos, stop=site_stop,
                alleles=alleles,
                codes0=[t[0] for t in tensors0],
                scal0=[t[1] for t in tensors0],
                codes1=[t[0] for t in tensors1] if hybrid else None,
                scal1=[t[1] for t in tensors1] if hybrid else None,
                ref_codes=ref_segment_codes(
                    ref.fetch(chromosome, left, left + L), left, L),
                labels=labels, site_label=int(out.site_labels[si])))
        else:
            seg = padded_ref_segment(ref.fetch(chromosome, left, left + L),
                                     left, L)
            sites.append(SiteWork(
                chromosome=chromosome, start=pos, stop=site_stop,
                alleles=alleles, tensors0=tensors0,
                tensors1=tensors1 if hybrid else None,
                ref_segment=seg, labels=labels,
                site_label=int(out.site_labels[si])))
        a_off += na
    return sites


def _site_tensors(window: Window, record: CandidateRecord, hybrid: bool,
                  include_hp: bool, feature_length: int,
                  max_allele_length: int, ref_view, channels: int
                  ) -> Optional[SiteWork]:
    """Tensors for one candidate record (reference trainDataTools.createTensors:880-977)."""
    start, stop = record.position, record.stop
    # one batched backend query answers supports + features for every allele
    # at the site (platform of "index 0" = the single platform's flag outside
    # hybrid mode, reference AlleleSearcherLite.py:311 index mapping)
    site = window.query_site(start, stop, max_allele_length)

    truth_alleles = set(record.alleles()[g] for g in record.gt if g >= 0)

    alleles, tensors0, tensors1, labels = [], [], [], []
    for allele in record.alleles():
        hit = site.get(allele)
        if hit is None:         # zero supports, or allele too long
            continue
        alleles.append(allele)
        labels.append(1 if allele in truth_alleles else 0)
        tensors0.append(hit[0])
        if hybrid:
            tensors1.append(hit[1])

    if not alleles:
        return None

    mid = (start + stop) // 2
    left = mid - feature_length // 2
    seg = padded_ref_segment(ref_view[left:left + feature_length],
                             left, feature_length)

    site_label = 0 if sum(labels) <= 1 else 1
    return SiteWork(
        chromosome=record.chromosome, start=start, stop=stop,
        alleles=alleles, tensors0=tensors0,
        tensors1=tensors1 if hybrid else None,
        ref_segment=seg, labels=labels, site_label=site_label)
