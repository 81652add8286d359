"""Read model and read-level filters.

``AlignedRead`` is the framework's in-memory representation of one aligned
read — the host-side analogue of a pysam AlignedSegment restricted to the
fields the pipeline uses.  ``is_usable_read`` reproduces the DeepVariant-style
filter of the reference (reference python/PileupContainer.py:19-51).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from .constants import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CINS, BAM_CMATCH,
                        BAM_CREF_SKIP, BAM_CSOFT_CLIP)

# SAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800


@dataclasses.dataclass
class AlignedRead:
    name: str
    flag: int
    chromosome: str
    reference_start: int                 # 0-based
    mapq: int
    cigartuples: List[Tuple[int, int]]   # [(op, length)]
    sequence: str
    qualities: List[int]
    hp: int = 0                          # haplotag (HP aux tag; 0 = untagged)
    pacbio: bool = False

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def orientation(self) -> int:
        return -1 if self.is_reverse else 1

    @property
    def reference_end(self) -> int:
        """End of the alignment on the reference (0-based, exclusive)."""
        span = 0
        for op, length in self.cigartuples:
            if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF, BAM_CDEL, BAM_CREF_SKIP):
                span += length
        return self.reference_start + span

    @property
    def query_length(self) -> int:
        return len(self.sequence)


_READ_OPS = (BAM_CMATCH, BAM_CINS, BAM_CSOFT_CLIP, BAM_CEQUAL, BAM_CDIFF)
_ALN_OPS = (BAM_CMATCH, BAM_CINS, BAM_CEQUAL, BAM_CDIFF)
_REF_OPS = (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF, BAM_CDEL, BAM_CREF_SKIP)


def strict_clip_fn(cigars, limit_length: int, left: bool):
    """Limit a cigar-tuple run to ``limit_length + 1`` read bases, counted
    from the region boundary outward (reference
    PileupContainerLite.strictClipFn:255-366, including its off-by-one-style
    ``limit - counter + 1`` keep size and leading/trailing INS→SOFT_CLIP
    conversion).

    Returns (kept cigars, #query bases pruned, #aligned-query bases pruned,
    #reference bases pruned)."""
    tuples = list(reversed(cigars)) if left else list(cigars)
    read_counter = 0
    keep, discard = [], []
    for i, (op, length) in enumerate(tuples):
        read_after = read_counter + (length if op in _READ_OPS else 0)
        if read_counter <= limit_length < read_after:
            head = (op, limit_length - read_counter + 1)
            tail = (op, length - head[1])
            if head[1] > 0:
                keep.append(head)
            if tail[1] > 0:
                discard.append(tail)
            discard.extend(tuples[i + 1:])
            break
        keep.append((op, length))
        read_counter = read_after
    if left:
        keep = list(reversed(keep))

    ins_to_soft = 0
    if keep:
        edge = 0 if left else -1
        if keep[edge][0] == BAM_CINS:
            ins_to_soft = keep[edge][1]
            keep[edge] = (BAM_CSOFT_CLIP, keep[edge][1])

    pruned_query = sum(l for op, l in discard if op in _READ_OPS)
    pruned_aln = sum(l for op, l in discard if op in _ALN_OPS) + ins_to_soft
    pruned_ref = sum(l for op, l in discard if op in _REF_OPS)
    return keep, pruned_query, pruned_aln, pruned_ref


def strict_clip_read(read: AlignedRead, position: int, left: bool,
                     flank_length: int = 150) -> AlignedRead:
    """Strictly clip one flank of a read so at most ``flank_length + 1`` read
    bases extend beyond ``position`` (reference
    PileupContainerLite.strictClipRead:367-468 semantics on
    :class:`AlignedRead`; returns a new read, no-op when ``position`` is not
    covered by the alignment)."""
    if not (read.reference_start <= position < read.reference_end):
        return read

    # split the cigar run at the reference position (the op covering
    # `position` goes to the left part up to and including it)
    ref_counter = read.reference_start
    left_cigars, right_cigars = [], []
    for i, (op, length) in enumerate(read.cigartuples):
        ref_after = ref_counter + (length if op in _REF_OPS else 0)
        if ref_counter <= position < ref_after:
            head = (op, position - ref_counter + 1)
            tail = (op, length - head[1])
            if head[1] > 0:
                left_cigars.append(head)
            if tail[1] > 0:
                right_cigars.append(tail)
            right_cigars.extend(read.cigartuples[i + 1:])
            break
        left_cigars.append((op, length))
        ref_counter = ref_after

    new_start = read.reference_start
    sequence = read.sequence
    qualities = list(read.qualities)
    if left and left_cigars:
        keep_left, pruned_q, _pa, pruned_ref = strict_clip_fn(
            left_cigars, flank_length, left=True)
        new_start += pruned_ref
        sequence = sequence[pruned_q:]
        qualities = qualities[pruned_q:]
        keep_right = right_cigars
    elif not left and right_cigars:
        keep_right, pruned_q, _pa, _pr = strict_clip_fn(
            right_cigars, flank_length, left=False)
        if pruned_q > 0:
            sequence = sequence[:-pruned_q]
            qualities = qualities[:-pruned_q]
        keep_left = left_cigars
    else:
        return read

    # merge the two runs at the split point
    if keep_left and keep_right:
        (op0, l0), (op1, l1) = keep_left[-1], keep_right[0]
        center = [(op0, l0 + l1)] if op0 == op1 else [keep_left[-1], keep_right[0]]
    else:
        center = keep_left[-1:] + keep_right[:1]
    cigartuples = keep_left[:-1] + center + keep_right[1:]

    return dataclasses.replace(
        read, reference_start=new_start, cigartuples=cigartuples,
        sequence=sequence, qualities=qualities)


def strict_clip(read: AlignedRead, start: int, stop: int,
                flank_length: int = 200) -> AlignedRead:
    """Clip both flanks of a long read to ``flank_length`` read bases around
    [start, stop) — what the reference applies to PacBio reads at fetch time
    (PileupDataTools.py:153-155, clipFlank=200; strictClipRead calls at
    PileupContainerLite.py:571-573)."""
    read = strict_clip_read(read, start, left=True, flank_length=flank_length)
    read = strict_clip_read(read, stop, left=False, flank_length=flank_length)
    return read


def is_usable_read(read: AlignedRead) -> bool:
    """DeepVariant-style usability filter (reference PileupContainer.py:19-51):
    drop unmapped / secondary / supplementary / duplicate reads, improperly
    paired reads, and zero mapping quality."""
    f = read.flag
    if f & FLAG_UNMAPPED:
        return False
    if f & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
        return False
    if f & FLAG_DUP:
        return False
    if (f & FLAG_PAIRED) and not (f & FLAG_PROPER_PAIR):
        return False
    if read.mapq <= 0:
        return False
    return True


class ReadWindow:
    """Reads overlapping one genomic window, deduplicated and subsampled.

    Mirrors PileupContainerLite (reference python/PileupContainerLite.py:471-581):
    fetch, usability filter, (name, strand) dedup, reservoir sampling to
    ``max_reads``.  The PacBio strict-clipping path of the reference trims long
    reads to +/- flank around the window purely as a host-memory optimisation;
    here reads are kept whole (window extraction happens at featurization).
    """

    def __init__(self, reads: Sequence[AlignedRead], chromosome: str,
                 start: int, span: int, max_reads: int = 10000,
                 rng: Optional[random.Random] = None):
        self.chromosome = chromosome
        self.position = start
        self.span = span
        rng = rng or random
        seen = set()
        kept: List[AlignedRead] = []
        encountered = 0
        for read in reads:
            if read.name is None:
                raise ValueError("read without a name — incompatible input")
            if not is_usable_read(read):
                continue
            key = (read.name, read.is_reverse)
            if key in seen:
                continue
            seen.add(key)
            p_keep = max_reads / (encountered + 1)
            if rng.uniform(0, 1) < p_keep:
                if len(kept) < max_reads:
                    kept.append(read)
                else:
                    kept[rng.sample(range(len(kept)), 1)[0]] = read
            encountered += 1
        self.reads = kept

    @property
    def reference_end(self) -> int:
        return max(r.reference_end for r in self.reads)

    @property
    def reference_start(self) -> int:
        return min(r.reference_start for r in self.reads)

    def __len__(self):
        return len(self.reads)
