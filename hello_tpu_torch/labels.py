"""Ground-truth labeling: haplotype enumeration + candidate-path matching.

Training labels are produced by enumerating all haplotype pairs consistent
with the truth VCF's genotypes (including partial/missed-allele combinations)
and finding the candidate-allele assignment whose stitched haplotypes match a
truth pair with the fewest (missed, extra) errors.

Reproduces the reference labeler (reference python/labeler.py:93-250) and its
C++ path matcher (reference c++/src/Trie.cpp:16-121 ``VariantTrie``):

  * ``enumerate_truth_haplotypes``: recursive enumeration over truth records
    with per-site genotype relaxations {(0,0), (g,0), (0,g), gt} and
    (missed, extra) error counts, deduplicated keeping first occurrence;
  * ``match_paths``: DFS through candidate site records matching a target
    haplotype string (the trie search, with first-match-wins allele choice);
  * ``Labeler``: best (missed, extra) pair wins, later equal-error pairs
    overwrite earlier ones (matching the reference's ``>`` skip);
  * regions with more than MAX_SEGMENT_SIZE truths or candidates raise
    RegionTooLongException.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .constants import MAX_SEGMENT_SIZE_LABELING

MAX_NUM_ERRORS = 10000


class RegionTooLongException(Exception):
    pass


def gen_ground_truth_genotypes(gt: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Genotype relaxations for one truth site (reference labeler.py:81-90)."""
    gt = tuple(gt)
    items = {(0, 0), (gt[0], 0), (0, gt[0]), (gt[1], 0), (0, gt[1]), gt}
    return list(items)


def enumerate_truth_haplotypes(truths, segment: str, start: int):
    """All (h0, h1) haplotype pairs with (num_missed, num_extra) error counts.

    ``truths``: sorted records with .position, .ref, .alt, .gt.
    """
    def seg(a, b):
        return segment[a - start: b - start]

    def recurse(variant_set, anchor, call_level):
        if not variant_set:
            tail = seg(anchor, start + len(segment))
            return [((tail, tail), 0, 0)]
        first = variant_set[0]
        prefix = seg(anchor, first.position) if call_level == 0 else ""
        rest = recurse(variant_set[1:], first.position + len(first.ref),
                       call_level + 1)
        all_alleles = [first.ref] + list(first.alt)
        true_alleles = [all_alleles[i] for i in first.gt]
        if len(variant_set) > 1:
            addendum = seg(first.position + len(first.ref),
                           variant_set[1].position)
        else:
            addendum = ""
        results = []
        for gt in gen_ground_truth_genotypes(tuple(first.gt)):
            selected = [all_alleles[i] for i in gt]
            if len(selected) == 1:
                selected = [selected[0], selected[0]]
            for (h0, h1), missed, extra in rest:
                new_h0 = prefix + selected[0] + addendum + h0
                new_h1 = prefix + selected[1] + addendum + h1
                n_missed = missed + len(set(true_alleles) - set(selected))
                n_extra = extra + len(set(selected) - set(true_alleles))
                results.append(((new_h0, new_h1), n_missed, n_extra))
        return results

    return recurse(list(truths), start, 0)


def deduplicate_pairs(results):
    """Keep the first occurrence of each unordered haplotype pair
    (reference labeler.py:60-78)."""
    seen = set()
    out = []
    for pair, n1, n2 in results:
        if pair not in seen and (pair[1], pair[0]) not in seen:
            out.append((pair, n1, n2))
        seen.add(pair)
    return out


def match_path(path: str, site_records, segment: str, start: int
               ) -> Optional[List[str]]:
    """Find a per-site allele assignment whose stitched haplotype equals
    ``path`` (reference Trie.cpp search_path:16-89).  Returns the allele list
    or None."""
    stop = start + len(segment)

    def ref_at(pos):
        return segment[pos - start]

    if not site_records:
        return [] if segment == path else None

    def dfs(ref_ptr, record_idx, path_ptr, chosen):
        if ref_ptr == stop and path_ptr == len(path):
            return chosen
        if ref_ptr >= stop or path_ptr >= len(path):
            return None
        if record_idx >= len(site_records):
            while path_ptr < len(path):
                if ref_ptr >= stop:
                    return None
                if path[path_ptr] != ref_at(ref_ptr):
                    return None
                path_ptr += 1
                ref_ptr += 1
            if ref_ptr != stop:
                return None
            return chosen
        site = site_records[record_idx]
        while ref_ptr < site.start:
            if path_ptr >= len(path):
                return None
            if path[path_ptr] != ref_at(ref_ptr):
                return None
            path_ptr += 1
            ref_ptr += 1
        for allele in site.alleles:
            if path[path_ptr:path_ptr + len(allele)] == allele:
                result = dfs(site.stop, record_idx + 1,
                             path_ptr + len(allele), chosen + [allele])
                if result is not None:
                    return result
        return None

    return dfs(start, 0, 0, [])


@dataclasses.dataclass
class _Site:
    alleles: List[str]
    start: int
    stop: int


class Labeler:
    """Label candidate records against a truth set
    (reference labeler.Labeler:191-250)."""

    def __init__(self, truths, segment: str, start: int):
        self.truths = list(truths)
        self.segment = segment
        self.start = start
        if len(self.truths) > MAX_SEGMENT_SIZE_LABELING:
            raise RegionTooLongException("too many truth variants")
        for t in self.truths:
            if t.position + len(t.ref) > start + len(segment):
                raise RegionTooLongException("truth variant outside segment")
        self.gt_candidates = deduplicate_pairs(
            enumerate_truth_haplotypes(self.truths, segment, start))

    def __call__(self, candidate_records) -> Tuple[bool, List[Tuple[str, str]]]:
        if len(candidate_records) > MAX_SEGMENT_SIZE_LABELING:
            raise RegionTooLongException("too many candidates")
        if candidate_records and (
                candidate_records[-1].position + len(candidate_records[-1].ref)
                > self.start + len(self.segment)):
            raise RegionTooLongException("candidate outside segment")

        sites = [_Site([r.ref] + list(r.alt), r.position,
                       r.position + len(r.ref)) for r in candidate_records]

        best_errors = (MAX_NUM_ERRORS, MAX_NUM_ERRORS)
        best: Optional[Tuple[List[str], List[str]]] = None
        for (h0, h1), n1, n2 in self.gt_candidates:
            if (n1, n2) > best_errors:
                continue
            m0 = match_path(h0, sites, self.segment, self.start)
            if m0 is None:
                continue
            m1 = match_path(h1, sites, self.segment, self.start)
            if m1 is None:
                continue
            best_errors = (n1, n2)
            best = (m0, m1)

        if best is None:
            return False, []
        total_errors = best_errors[0] + best_errors[1]
        if len(candidate_records) == 1 and total_errors > 0:
            return False, []
        return True, list(zip(best[0], best[1]))


def find_allele_index(record, allele: str) -> int:
    alleles = [record.ref] + list(record.alt)
    return alleles.index(allele) if allele in alleles else -1
