"""Pack ragged per-site variant-calling work into fixed-shape device batches.

The host pipeline produces, per site: a list of candidate alleles, and per
allele a ``[num_reads, L, C]`` uint8 feature tensor per platform (ragged in
both the allele and read dimensions).  TPU execution wants static shapes, so
sites are packed into batches with

  * the allele axis padded to a bucket size ``A``;
  * the read axis padded to a bucket size ``R`` (per platform);
  * masks marking real reads / alleles;
  * ``site_ids`` grouping allele slots into ``S`` padded sites.

Bucket sizes are drawn from geometric ladders so only a few distinct shapes are
ever compiled (jit caches per shape).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_READ_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)
DEFAULT_ALLELE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_SITE_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


@dataclasses.dataclass
class SiteWork:
    """One site's worth of scoring work (host-side, ragged)."""
    chromosome: str
    start: int
    stop: int
    alleles: List[str]
    # per-allele feature tensors, uint8 [R_i, L, C]
    tensors0: List[np.ndarray]
    tensors1: Optional[List[np.ndarray]] = None
    ref_segment: Optional[np.ndarray] = None  # [L, 5] one-hot
    labels: Optional[List[int]] = None
    site_label: Optional[int] = None


@dataclasses.dataclass
class CodedSiteWork:
    """One site's scoring work in the 1-byte coded wire representation
    (pipeline/compact.py): per allele, ``[R, L]`` uint8 cell codes and
    ``[R, nscal]`` per-row scalars instead of dense ``[R, L, C]`` feature
    tensors (6-7x smaller — decisive for worker->main IPC and host->device
    transfer).  The reference window ships as ``[L]`` uint8 base codes
    (0-4 = A,C,G,T,other; 5 = off-chromosome padding) instead of a ``[L, 5]``
    float32 one-hot.  Produced by compact.encode_site_work from featurizer
    output; packs straight into a device wire dict (compact.pack_sites_wire)
    with no dense intermediate."""
    chromosome: str
    start: int
    stop: int
    alleles: List[str]
    codes0: List[np.ndarray]          # per-allele [R, L] uint8
    scal0: List[np.ndarray]           # per-allele [R, 2|3] uint8
    codes1: Optional[List[np.ndarray]] = None
    scal1: Optional[List[np.ndarray]] = None
    ref_codes: Optional[np.ndarray] = None   # [L] uint8, 0..5
    labels: Optional[List[int]] = None
    site_label: Optional[int] = None

    @property
    def read_counts0(self):
        return [c.shape[0] for c in self.codes0]

    @property
    def read_counts1(self):
        return None if self.codes1 is None else [c.shape[0] for c in self.codes1]


@dataclasses.dataclass
class PaddedBatch:
    """Fixed-shape batch for the device; `sites` maps rows back to SiteWork."""
    reads0: np.ndarray        # [A, R0, L, C0] uint8
    read_mask0: np.ndarray    # [A, R0] float32
    reads1: Optional[np.ndarray]
    read_mask1: Optional[np.ndarray]
    site_ids: np.ndarray      # [A] int32
    allele_mask: np.ndarray   # [A] float32
    ref_segments: np.ndarray  # [S, L, 5] float32
    num_sites: int
    sites: List[SiteWork]
    allele_site_index: List[tuple]   # (site_idx, allele_idx) per real allele slot
    labels: Optional[np.ndarray] = None      # [A] float32 (allele labels)

    def device_dict(self):
        d = {
            "reads0": self.reads0,
            "read_mask0": self.read_mask0,
            "site_ids": self.site_ids,
            "allele_mask": self.allele_mask,
            "ref_segments": self.ref_segments,
        }
        if self.reads1 is not None:
            d["reads1"] = self.reads1
            d["read_mask1"] = self.read_mask1
        return d


_ONE_HOT_LUT = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ONE_HOT_LUT[_b] = _i


def one_hot_ref_segment(bases: str) -> np.ndarray:
    """One-hot encode a reference window [L, 5] — A,C,G,T,other
    (reference caller_calling.py:53-67)."""
    codes = _ONE_HOT_LUT[np.frombuffer(bases.encode(), np.uint8)]
    return np.eye(5, dtype=np.float32)[codes]


def ref_segment_codes(bases: str, left: int, length: int) -> np.ndarray:
    """[L] uint8 base codes for a reference window: 0-4 = A,C,G,T,other,
    5 = off-chromosome padding (the code-space twin of padded_ref_segment —
    one-hot row 5 expands to all-zeros, see compact.REF_ONEHOT6)."""
    codes = _ONE_HOT_LUT[np.frombuffer(bases.encode(), np.uint8)]
    if codes.shape[0] == length:
        return codes
    out = np.full(length, 5, np.uint8)
    front = max(0, -left)
    out[front:front + codes.shape[0]] = codes[:max(0, length - front)]
    return out


def padded_ref_segment(bases: str, left: int, length: int) -> np.ndarray:
    """One-hot ref segment, zero-padded to ``length`` when the fetch was
    clamped at a chromosome edge.

    The reference pipeline never sees this case (it DROPS whole chunks
    touching position 0, a quirk this framework deliberately fixes by
    clamping windows instead); all-zero rows are the faithful encoding of
    "no reference base here" — the featurizer paints no channels at
    positions no read covers, and the meta expert sees zeros, not a fake
    'other' base."""
    seg = one_hot_ref_segment(bases)
    if seg.shape[0] == length:
        return seg
    out = np.zeros((length, 5), np.float32)
    front = max(0, -left)
    out[front:front + seg.shape[0]] = seg[:max(0, length - front)]
    return out


def pack_sites(
    sites: Sequence[SiteWork],
    hybrid: bool,
    feature_length: int = 150,
    channels0: int = 6,
    channels1: int = 6,
    read_buckets: Sequence[int] = DEFAULT_READ_BUCKETS,
    allele_buckets: Sequence[int] = DEFAULT_ALLELE_BUCKETS,
    site_buckets: Sequence[int] = DEFAULT_SITE_BUCKETS,
) -> PaddedBatch:
    """Pack a group of sites into one PaddedBatch.

    Reads beyond the largest read bucket are truncated (the reference pipeline
    subsamples reads upstream, so this is a backstop, not a policy).
    """
    num_alleles = sum(len(s.alleles) for s in sites)
    A = _bucket(max(num_alleles, 1), allele_buckets)
    S = _bucket(max(len(sites), 1), site_buckets)
    if len(sites) > S or num_alleles > A:
        raise ValueError(
            f"group of {len(sites)} sites / {num_alleles} alleles exceeds "
            f"buckets (S={S}, A={A}); lower the grouping budgets")

    max_r0 = 1
    max_r1 = 1
    for s in sites:
        for t in s.tensors0:
            max_r0 = max(max_r0, t.shape[0])
        if hybrid and s.tensors1 is not None:
            for t in s.tensors1:
                max_r1 = max(max_r1, t.shape[0])
    R0 = _bucket(max_r0, read_buckets)
    R1 = _bucket(max_r1, read_buckets) if hybrid else None

    L = feature_length
    reads0 = np.zeros((A, R0, L, channels0), np.uint8)
    mask0 = np.zeros((A, R0), np.float32)
    if hybrid:
        reads1 = np.zeros((A, R1, L, channels1), np.uint8)
        mask1 = np.zeros((A, R1), np.float32)
    else:
        reads1, mask1 = None, None
    site_ids = np.full((A,), S - 1, np.int32)  # padding slots point at the last (padded) site
    allele_mask = np.zeros((A,), np.float32)
    ref_segments = np.zeros((S, L, 5), np.float32)
    labels = np.zeros((A,), np.float32)
    has_labels = all(s.labels is not None for s in sites)

    slot = 0
    index = []
    for si, site in enumerate(sites):
        if site.ref_segment is not None:
            ref_segments[si] = site.ref_segment
        for ai, allele in enumerate(site.alleles):
            t0 = site.tensors0[ai]
            r0 = min(t0.shape[0], R0)
            reads0[slot, :r0] = t0[:r0]
            mask0[slot, :r0] = 1.0
            if hybrid:
                t1 = site.tensors1[ai]
                r1 = min(t1.shape[0], R1)
                reads1[slot, :r1] = t1[:r1]
                mask1[slot, :r1] = 1.0
            site_ids[slot] = si
            allele_mask[slot] = 1.0
            if has_labels:
                labels[slot] = site.labels[ai]
            index.append((si, ai))
            slot += 1

    return PaddedBatch(
        reads0=reads0, read_mask0=mask0, reads1=reads1, read_mask1=mask1,
        site_ids=site_ids, allele_mask=allele_mask, ref_segments=ref_segments,
        num_sites=S, sites=list(sites), allele_site_index=index,
        labels=labels if has_labels else None,
    )


def stack_device_batches(batches: Sequence[dict]) -> dict:
    """Stack per-device batch dicts (identical shapes) along a new leading
    device axis for sharded training steps."""
    keys = batches[0].keys()
    return {k: np.stack([b[k] for b in batches], axis=0) for k in keys}


def training_dict(batch: PaddedBatch) -> dict:
    """Device dict + labels for training."""
    d = batch.device_dict()
    assert batch.labels is not None, "training batches need labels"
    d["labels"] = batch.labels
    return d


def site_read_bucket(site, read_buckets: Sequence[int] = DEFAULT_READ_BUCKETS):
    """The read-bucket class a site forces on any batch containing it:
    per-platform bucket of its deepest allele (SiteWork or CodedSiteWork)."""
    t0 = site.codes0 if isinstance(site, CodedSiteWork) else site.tensors0
    t1 = site.codes1 if isinstance(site, CodedSiteWork) else site.tensors1
    b0 = _bucket(max((t.shape[0] for t in t0), default=1), read_buckets)
    if t1 is None:
        return (b0,)
    b1 = _bucket(max((t.shape[0] for t in t1), default=1), read_buckets)
    return (b0, b1)


def site_row_counts(site) -> tuple:
    """Real read rows this site contributes per platform (the packed-row
    axis cost of including it in a coded-wire batch)."""
    t0 = site.codes0 if isinstance(site, CodedSiteWork) else site.tensors0
    t1 = site.codes1 if isinstance(site, CodedSiteWork) else site.tensors1
    r0 = sum(t.shape[0] for t in t0)
    if t1 is None:
        return (r0,)
    return (r0, sum(t.shape[0] for t in t1))


def row_budgets_for_class(read_buckets: Sequence[int],
                          max_alleles_per_batch: int,
                          frac: float = 0.5) -> tuple:
    """Per-platform packed-row budgets for a read-bucket class.

    The packed-row bucket ladder is {cap/4, cap/2, cap} (compact._bucket) —
    a hard compile-shape cap.  Production per-allele occupancy is typically
    ~0.5-0.7 of the class read bucket (minor alleles carry far fewer reads
    than the bucketed maximum), which the ladder rounds UP to cap: the
    packed-row convolution then processes as many rows as the dense grid
    and its FLOP savings vanish (measured 0.92x on a v5e at 62% occupancy
    vs 1.24x with tightly packed rows).  Budgeting each batch's ROWS to
    frac * cap makes every coded batch land in the cap/2 ladder step with
    high occupancy — the conv runs over ~half the dense grid's rows — while
    shapes stay a deterministic function of the workload and the ladder
    keeps its three steps."""
    return tuple(int(frac * max_alleles_per_batch * b) for b in read_buckets)


def group_sites_for_batching(sites: Sequence[SiteWork], max_alleles_per_batch: int = 128,
                             max_sites_per_batch: Optional[int] = None,
                             by_read_bucket: bool = False,
                             row_budget_frac: Optional[float] = None,
                             _row_budgets: Optional[tuple] = None):
    """Greedily group sites so each batch stays under allele/site budgets.

    ``max_sites_per_batch`` defaults to the packer's largest site bucket — a
    group can never hold more sites than ``pack_sites`` can represent (an
    allele budget over 1024 would otherwise admit groups of single-allele
    sites that overflow the site axis).

    ``by_read_bucket`` partitions sites by their read-bucket class first, so
    a batch's padded read width is its own sites' depth, not the deepest site
    anywhere in the stream (a 64-read site in a mostly-32-read batch would
    otherwise double every site's conv rows).  Inference callers use this —
    the read convolver's cost scales with the padded read axis, and the VCF
    is position-sorted at the end anyway; the training loader keeps stream
    order (its shuffle owns data order).

    ``row_budget_frac`` (coded-wire classes only) additionally bounds each
    batch's REAL read rows per platform to ``frac * allele_budget * bucket``
    so the packed-row convolution gets tightly packed batches — see
    :func:`row_budgets_for_class`."""
    if max_sites_per_batch is None:
        max_sites_per_batch = DEFAULT_SITE_BUCKETS[-1]
    if by_read_bucket:
        classes: dict = {}
        for s in sites:
            classes.setdefault(site_read_bucket(s), []).append(s)
        for key in sorted(classes):
            cls = classes[key]
            budgets = None
            if row_budget_frac and isinstance(cls[0], CodedSiteWork):
                budgets = row_budgets_for_class(key, max_alleles_per_batch,
                                                row_budget_frac)
            yield from group_sites_for_batching(
                cls, max_alleles_per_batch, max_sites_per_batch,
                _row_budgets=budgets)
        return
    group: List[SiteWork] = []
    count = 0
    rows = None
    for s in sites:
        n = len(s.alleles)
        if _row_budgets is not None:
            r = site_row_counts(s)
            if rows is None:
                rows = [0] * len(r)
            over_rows = any(rows[i] + r[i] > _row_budgets[i]
                            for i in range(len(r)))
        else:
            r, over_rows = None, False
        if group and (count + n > max_alleles_per_batch or over_rows or
                      (max_sites_per_batch and len(group) >= max_sites_per_batch)):
            yield group
            group, count = [], 0
            rows = [0] * len(r) if r is not None else None
        group.append(s)
        count += n
        if r is not None:
            for i in range(len(r)):
                rows[i] += r[i]
    if group:
        yield group
