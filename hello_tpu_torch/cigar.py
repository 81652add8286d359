"""CIGAR left-alignment and simplification.

Port of the reference's indel left-shifting machinery (reference
c++/src/leftAlignCigars.cpp): repeatedly shift each indel one base left while
the total mismatch count is preserved, merge adjacent identical operations,
collapse equal-length adjacent I/D pairs that spell out matches, drop leading
deletions, and (outside indel-realignment mode) convert a leading insertion to
a soft clip.

The reference keeps this gated off in its shipping configuration
(``leftAlign=false``, AlleleSearcherLiteFiltered.cpp:399); it is provided here
for parity and is equally optional (``Window(..., left_align=True)``).
"""

from __future__ import annotations

from typing import List, Tuple

from .constants import (BAM_CDEL, BAM_CDIFF, BAM_CEQUAL, BAM_CINS, BAM_CMATCH,
                        BAM_CREF_SKIP, BAM_CSOFT_CLIP)

Cigar = List[Tuple[int, int]]

_READ_OPS = (BAM_CINS, BAM_CSOFT_CLIP)
_MATCH_OPS = (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF)
_REF_OPS = (BAM_CDEL, BAM_CREF_SKIP)


def has_indel(cigars: Cigar) -> bool:
    return any(op in (BAM_CINS, BAM_CDEL) for op, _l in cigars)


def count_mismatches(read: str, reference_start: int, cigars: Cigar,
                     ref: str, ref_offset: int = 0) -> int:
    """Mismatching M bases of an alignment (ref indexed at ref_offset)."""
    mismatches = 0
    rd, rf = 0, reference_start
    for op, length in cigars:
        if op in _READ_OPS:
            rd += length
        elif op in _MATCH_OPS:
            for i in range(length):
                if ref[rf - ref_offset] != read[rd]:
                    mismatches += 1
                rd += 1
                rf += 1
        elif op in _REF_OPS:
            rf += length
    return mismatches


def _ref_read_position(cigars: Cigar, reference_start: int):
    rd, rf = 0, reference_start
    for op, length in cigars:
        if op in _MATCH_OPS:
            rd += length
            rf += length
        elif op in _READ_OPS:
            rd += length
        elif op in _REF_OPS:
            rf += length
    return rf, rd


def _left_shift_once(read, cigar_index, orig_mismatches, reference_start,
                     cigars, ref, ref_offset):
    """One left-shift attempt of the indel at cigar_index
    (reference leftShiftCigar:114-223).  Returns (success, new_cigars,
    new_index)."""
    if cigars[cigar_index][0] not in (BAM_CDEL, BAM_CINS):
        return False, cigars, cigar_index
    if cigar_index == 0:
        return False, cigars, cigar_index
    left_op = cigars[cigar_index - 1][0]
    if left_op not in (BAM_CMATCH, BAM_CEQUAL):
        return False, cigars, cigar_index

    if left_op == BAM_CMATCH:
        rf, rd = _ref_read_position(cigars[:cigar_index], reference_start)
        rf -= 1
        rd -= 1
        if rf < 0 or rd < 0:
            return False, cigars, cigar_index
        if ref[rf - ref_offset] != read[rd]:
            return False, cigars, cigar_index

    shifted: Cigar = list(cigars[:cigar_index - 1])
    left = (cigars[cigar_index - 1][0], cigars[cigar_index - 1][1] - 1)
    consumed_left = left[1] == 0
    if not consumed_left:
        shifted.append(left)
    shifted.append(cigars[cigar_index])
    if cigar_index < len(cigars) - 1:
        orig_left = cigars[cigar_index - 1]
        orig_right = cigars[cigar_index + 1]
        if orig_left[0] == orig_right[0]:
            shifted.append((orig_right[0], orig_right[1] + 1))
        else:
            shifted.append((orig_left[0], 1))
            shifted.append(orig_right)
    shifted.extend(cigars[cigar_index + 2:])

    new_mismatches = count_mismatches(read, reference_start, shifted, ref,
                                      ref_offset)
    if new_mismatches != orig_mismatches:
        return False, cigars, cigar_index
    return True, shifted, cigar_index - 1 if consumed_left else cigar_index


def simplify_cigars(cigars: Cigar, read: str, reference_start: int,
                    ref: str, ref_offset: int = 0) -> Cigar:
    """Merge adjacent identical ops; collapse equal-length adjacent I/D pairs
    that read as pure matches (reference simplifyCigartuples:225-347)."""
    current = list(cigars)
    while True:
        simplified: Cigar = []
        completed = True
        rd, rf = 0, reference_start
        for op, length in current:
            if not simplified:
                simplified.append((op, length))
            else:
                last_op, last_len = simplified[-1]
                if last_op == op:
                    simplified[-1] = (op, last_len + length)
                    completed = False
                elif {last_op, op} == {BAM_CINS, BAM_CDEL}:
                    # deviations from the reference here (both on its dead
                    # code path): (1) the merged M must pair the I's read
                    # bases with the D's ref bases — the reference compares
                    # positions after advancing past the first op
                    # (simplifyCigartuples:282); (2) non-collapsible pairs
                    # must be kept — the reference drops them (no push).
                    collapsed = False
                    if last_len == length:
                        if last_op == BAM_CINS:   # I then D
                            r0, f0 = rd - last_len, rf
                        else:                      # D then I
                            r0, f0 = rd, rf - last_len
                        all_match = all(
                            read[r0 + i] == ref[f0 + i - ref_offset]
                            for i in range(length))
                        if all_match:
                            simplified[-1] = (BAM_CMATCH, last_len)
                            completed = False
                            collapsed = True
                    if not collapsed:
                        simplified.append((op, length))
                else:
                    simplified.append((op, length))
            if op in _READ_OPS:
                rd += length
            elif op in _MATCH_OPS:
                rd += length
                rf += length
            elif op in _REF_OPS:
                rf += length
        current = simplified
        if completed:
            return current


def left_align_cigars(read: str, reference_start: int, cigars: Cigar,
                      ref: str, ref_offset: int = 0,
                      indel_realigned: bool = False):
    """Left-align indels preserving the mismatch count
    (reference leftAlignCigars:368-426).

    Returns (new_reference_start, new_cigars).
    """
    cigars = list(cigars)
    if not has_indel(cigars):
        return reference_start, cigars

    orig_mismatches = count_mismatches(read, reference_start, cigars, ref,
                                       ref_offset)
    index = 0
    while index < len(cigars):
        while True:
            ok, cigars, index = _left_shift_once(
                read, index, orig_mismatches, reference_start, cigars, ref,
                ref_offset)
            if not ok:
                break
        index += 1

    cigars = simplify_cigars(cigars, read, reference_start, ref, ref_offset)

    # remove leading deletions
    lead = 0
    for op, _l in cigars:
        if op != BAM_CDEL:
            break
        lead += 1
    if lead:
        for op, length in cigars[:lead]:
            reference_start += length
        cigars = cigars[lead:]

    if not indel_realigned and cigars and cigars[0][0] == BAM_CINS:
        cigars[0] = (BAM_CSOFT_CLIP, cigars[0][1])
    return reference_start, cigars
