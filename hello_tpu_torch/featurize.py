"""DeepVariant-style colored pileup feature tensors.

Renders, for each read supporting a candidate allele, a ``[feature_length, C]``
uint8 row image with channels read-base / ref-base / base-quality / mapq /
strand / position-marker (and optionally HP tag), centered on the candidate
region.  Byte-compatible with the reference featurizer
(reference c++/src/AlleleSearcherLiteFiltered.cpp:1031-1180
``computeFeaturesColoredSimple`` and the color functions :971-1027), including
its corner cases:

  * deletions paint the reference track across the whole deleted span but the
    read-base gap color only at the left-flanking position, quality 0 when the
    deletion opens the read;
  * insertions paint the gap color at the left-flanking position with the
    minimum quality across the insertion (including the flanking base when
    present);
  * both deletion and insertion cases advance pointers exactly as the
    reference's intentional switch fallthroughs do.

The output feature batch is the fixed-shape, mask-carrying tensor stack the
TPU model consumes directly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .constants import (
    BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CINS, BAM_CMATCH, BAM_CREF_SKIP,
    BAM_CSOFT_CLIP, FEATURE_LENGTH, HP_TRACK, POSITION_MARKER_TRACK,
    READ_BASE_TRACK, READ_MAPQ_TRACK, READ_ORIENTATION_TRACK, READ_QUAL_TRACK,
    REF_BASE_TRACK, ALLELE_POSITION_COLOR, BACKGROUND_POSITION_COLOR,
    base_color, base_quality_color, hp_color, mapping_quality_color,
    strand_color,
)
from .reads import AlignedRead

GAP_COLOR = base_color("*")  # 0


def render_read_row(read: AlignedRead, reference: str, window_start: int,
                    assembly_start: int, assembly_stop: int,
                    feature_length: int = FEATURE_LENGTH,
                    include_hp: bool = False,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """Render one read's feature row ``[feature_length, C]`` uint8.

    The map is centered on ``(assembly_start + assembly_stop) // 2``; the
    position-marker channel highlights [assembly_start, assembly_stop).
    """
    channels = 7 if include_hp else 6
    if out is None:
        out = np.zeros((feature_length, channels), np.uint8)

    mid = (assembly_start + assembly_stop) // 2
    fstart = mid - feature_length // 2
    fend = fstart + feature_length

    mapq_color = mapping_quality_color(read.mapq)
    sd_color = strand_color(read.orientation)
    hpc = hp_color(read.hp)

    seq = read.sequence
    qual = read.qualities
    rf = read.reference_start
    rd = 0

    def pos_color(ref_pos):
        if assembly_start <= ref_pos < assembly_stop:
            return ALLELE_POSITION_COLOR
        return BACKGROUND_POSITION_COLOR

    for op, length in read.cigartuples:
        if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            for j in range(length):
                p = rf + j
                if fstart <= p < fend:
                    fi = p - fstart
                    out[fi, READ_BASE_TRACK] = base_color(seq[rd + j])
                    out[fi, REF_BASE_TRACK] = base_color(reference[p - window_start])
                    out[fi, READ_QUAL_TRACK] = base_quality_color(qual[rd + j])
                    out[fi, READ_MAPQ_TRACK] = mapq_color
                    out[fi, READ_ORIENTATION_TRACK] = sd_color
                    out[fi, POSITION_MARKER_TRACK] = pos_color(p)
                    if include_hp:
                        out[fi, HP_TRACK] = hpc
            rf += length
            rd += length
        elif op == BAM_CDEL:
            if fstart <= rf - 1 < fend and rf - 1 >= window_start:
                for p in range(rf - 1, rf + length):
                    if not (fstart <= p < fend):
                        continue
                    fi = p - fstart
                    out[fi, REF_BASE_TRACK] = base_color(reference[p - window_start])
                    out[fi, READ_MAPQ_TRACK] = mapq_color
                    out[fi, READ_ORIENTATION_TRACK] = sd_color
                    out[fi, POSITION_MARKER_TRACK] = pos_color(p)
                    if include_hp:
                        out[fi, HP_TRACK] = hpc
                fi = rf - 1 - fstart
                out[fi, READ_BASE_TRACK] = GAP_COLOR
                out[fi, READ_QUAL_TRACK] = \
                    base_quality_color(qual[rd - 1]) if rd > 0 else 0
            rf += length
        elif op == BAM_CREF_SKIP:
            rf += length
        elif op == BAM_CINS:
            if fstart <= rf - 1 < fend and rf - 1 >= window_start:
                fi = rf - 1 - fstart
                lo = rd - 1 if rd > 0 else rd
                qual_color = base_quality_color(min(qual[lo:rd + length]))
                out[fi, READ_BASE_TRACK] = GAP_COLOR
                out[fi, REF_BASE_TRACK] = base_color(reference[rf - 1 - window_start])
                out[fi, READ_QUAL_TRACK] = qual_color
                out[fi, READ_MAPQ_TRACK] = mapq_color
                out[fi, READ_ORIENTATION_TRACK] = sd_color
                out[fi, POSITION_MARKER_TRACK] = pos_color(rf - 1)
                if include_hp:
                    out[fi, HP_TRACK] = hpc
            rd += length
        elif op == BAM_CSOFT_CLIP:
            rd += length
    return out


def compute_features(reads: Sequence[AlignedRead], read_ids: Sequence[int],
                     reference: str, window_start: int,
                     assembly_start: int, assembly_stop: int,
                     pacbio: bool, feature_length: int = FEATURE_LENGTH,
                     include_hp: bool = False) -> np.ndarray:
    """Feature tensor ``[num_supports, feature_length, C]`` uint8 for the reads
    of one platform supporting one allele.  Returns a single zero row when no
    read matches (the reference's no-support dummy, c++ :1037-1043)."""
    channels = 7 if include_hp else 6
    rows = []
    for rid in read_ids:
        read = reads[rid]
        if read.pacbio != pacbio:
            continue
        rows.append(render_read_row(read, reference, window_start,
                                    assembly_start, assembly_stop,
                                    feature_length, include_hp))
    if not rows:
        return np.zeros((1, feature_length, channels), np.uint8)
    return np.stack(rows, axis=0)
