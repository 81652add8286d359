"""Genotype decoding: allele-pair probabilities from expert outputs.

Reproduces the semantics of the reference inference wrapper
(MoEMergedWrapperAdvanced.forward, reference python/MixtureOfExpertsAdvanced.py:520-589):

  * per-expert allele sigmoids ``e[a]``;
  * for an unordered allele pair (i, j) the expert's pair probability is
    ``prod_a (e_a if a in {i,j} else 1 - e_a)`` (with the reference's 1e-10
    cushion inside the log);
  * the site-level pair probability mixes experts with the meta weights
    ``sum_k meta[k] * pair_prob_k``;
  * single-platform models use meta = [1, 0, 0] and zeros for experts 1/2.

The caller picks the argmax pair; its quality is ``-10*log10(1 - p)`` with p
capped at ``1 - 1e-8`` (Q80), reference caller_calling.py:702-705.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def expert_pair_probabilities(probs: np.ndarray, alleles: Sequence[str]):
    """Pair probabilities for one expert at one site.

    probs: [A] sigmoid outputs (float32). Returns dict {(allele_i, allele_j): p}
    with unordered pairs deduplicated in reference order (itertools.product,
    first occurrence kept).
    """
    probs = np.asarray(probs, dtype=np.float32)
    out: Dict[Tuple[str, str], np.float32] = {}
    n = len(alleles)
    for i, j in itertools.product(range(n), range(n)):
        pair = (alleles[i], alleles[j])
        if pair in out or (pair[1], pair[0]) in out:
            continue
        target = np.zeros(n, dtype=np.float32)
        target[i] = 1.0
        target[j] = 1.0
        p = np.exp(np.sum(np.log(probs * target + (1.0 - probs) * (1.0 - target)
                                 + np.float32(1e-10)), dtype=np.float32))
        out[pair] = np.float32(p)
    return out


def _pair_index(n: int):
    """Unordered pair indices in reference enumeration order
    (itertools.product row-major, first occurrence kept): (0,0), (0,1), ...,
    (1,1), (1,2), ... — i.e. all i <= j."""
    return [(i, j) for i in range(n) for j in range(i, n)]


def expert_pair_probabilities_vectorized(probs: np.ndarray, n: int):
    """[E, A] sigmoids -> [E, P] pair probabilities for all unordered pairs.

    Same math as expert_pair_probabilities, batched: pair log-prob =
    T @ log(e + eps) + (1 - T) @ log(1 - e + eps)."""
    pairs = _pair_index(n)
    T = np.zeros((len(pairs), n), np.float32)
    for k, (i, j) in enumerate(pairs):
        T[k, i] = 1.0
        T[k, j] = 1.0
    l1 = np.log(probs + np.float32(1e-10))             # [E, A]
    l0 = np.log(1.0 - probs + np.float32(1e-10))
    logp = l1 @ T.T + l0 @ (1.0 - T).T                 # [E, P]
    return np.exp(logp), pairs


def decode_site(expert_logits: np.ndarray, meta: np.ndarray | None,
                alleles: Sequence[str]):
    """Decode one site.

    expert_logits: [A, E] raw logits (E=1 or 3); meta: [3] softmax weights or
    None.  Returns (pair_probabilities, per_expert_pair_probs, meta_used).
    """
    expert_logits = np.asarray(expert_logits, dtype=np.float32)
    A, E = expert_logits.shape
    sig = 1.0 / (1.0 + np.exp(-expert_logits))

    if E == 1:
        experts = [sig[:, 0], np.zeros(A, np.float32), np.zeros(A, np.float32)]
        meta_used = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        experts = [sig[:, k] for k in range(E)]
        assert meta is not None, "multi-expert decode requires meta weights"
        meta_used = np.asarray(meta, dtype=np.float32)

    # vectorised pair probabilities (math identical to the per-pair loop;
    # see expert_pair_probabilities for the reference-shaped scalar version)
    probs_mat = np.stack(experts, axis=0).astype(np.float32)   # [3, A]
    pair_probs, pairs = expert_pair_probabilities_vectorized(probs_mat, A)
    per_expert = []
    for k in range(3):
        per_expert.append({(alleles[i], alleles[j]): np.float32(pair_probs[k, p])
                           for p, (i, j) in enumerate(pairs)})
    mixed = meta_used[:3] @ pair_probs                          # [P]
    combined = {(alleles[i], alleles[j]): float(mixed[p])
                for p, (i, j) in enumerate(pairs)}
    return combined, per_expert, meta_used


def best_genotype(pair_probs: Dict[Tuple[str, str], float]):
    """Pick the top-probability allele pair; ties broken by reverse-sorted pair
    (matching the reference's ``sorted(..., reverse=True)[0]`` over
    (probability, pair) tuples)."""
    top = sorted(((v, k) for k, v in pair_probs.items()), reverse=True)[0]
    return top[1], top[0]


def phred_quality(p: float) -> float:
    """Quality of a call: -10*log10(1-p), capped at Q80."""
    p = min(float(p), 1.0 - 1e-8)
    return -10.0 * math.log10(1.0 - p)


def _decode_site_fast(expert_logits: np.ndarray, meta: np.ndarray | None,
                      alleles: Sequence[str]):
    """Best pair + probability only — the same arithmetic as ``decode_site``
    (identical intermediate arrays and accumulation order, so results are
    bit-identical) without materialising the per-expert/combined pair dicts
    the plain calling path never reads."""
    expert_logits = np.asarray(expert_logits, dtype=np.float32)
    A, E = expert_logits.shape
    sig = 1.0 / (1.0 + np.exp(-expert_logits))
    if E == 1:
        probs_mat = np.zeros((3, A), np.float32)
        probs_mat[0] = sig[:, 0]
        meta_used = np.array([1.0, 0.0, 0.0], np.float32)
    else:
        probs_mat = np.ascontiguousarray(sig.T, dtype=np.float32)
        assert meta is not None, "multi-expert decode requires meta weights"
        meta_used = np.asarray(meta, dtype=np.float32)
    pair_probs, pairs = expert_pair_probabilities_vectorized(probs_mat, A)
    mixed = meta_used[:3] @ pair_probs
    # best_genotype semantics without the dict: max over (probability, pair)
    # with the pair's allele strings breaking exact ties
    best = max(range(len(pairs)),
               key=lambda p: (mixed[p], (alleles[pairs[p][0]],
                                         alleles[pairs[p][1]])))
    i, j = pairs[best]
    return (alleles[i], alleles[j]), float(mixed[best])


def decode_pairs_device(experts, meta, site_ids, allele_mask, num_sites: int):
    """Genotype decode ON THE DEVICE: per-site best allele pair + probability.

    Runs the same math as ``_decode_site_fast`` on the tensors' device so the
    caller fetches 13 bytes per site (two int32 slot indices, one float32
    probability, one validity byte) instead of the [A, E] expert logits and
    [S, 3] meta tensors (reference decode semantics:
    caller_calling.py:612-654, MixtureOfExpertsAdvanced.py:520-589).

    experts: [A, E] raw logits; meta: [S, 3] softmax weights or None;
    site_ids: [A] int; allele_mask: [A]; num_sites: S.

    Returns dict of [S]-shaped tensors: ``best_i``/``best_j`` (allele SLOT
    indices of the winning unordered pair, i <= j), ``best_p`` (mixed
    probability), ``valid`` (site has at least one real allele slot).

    Tie-breaking: exact-probability ties resolve to the smallest (i, j) slot
    pair, where the host paths resolve by allele-string order (reference
    ``sorted(..., reverse=True)``).  Exact float32 ties only occur between
    degenerate pairs (probabilities underflowing to an identical value, i.e.
    junk calls near quality 0), where either pick is equally (un)supported.
    """
    import torch

    A, E = experts.shape
    S = num_sites
    dev = experts.device
    sid = site_ids.long()
    sig = torch.sigmoid(experts.float())               # [A, E]
    eps = 1e-10
    l1 = torch.log(sig + eps)
    # evaluation order (1 - sig) + eps, as the host reference computes it:
    # reassociated to (1 + eps) - sig it cancels to 0 for saturated sigmoids
    # and sends log to -inf (eager torch keeps the written order)
    one_minus = 1.0 - sig
    l0 = torch.log(one_minus + eps)
    amask = allele_mask.float()
    # per-site sum of log(1-e) over real alleles, per expert: [S, E]
    site_l0 = torch.zeros((S, E), dtype=torch.float32, device=dev)
    site_l0.index_add_(0, sid, l0 * amask[:, None])
    # pair log-prob over slot pairs (i, j):
    #   i != j: site_l0[site] + (l1-l0)[i] + (l1-l0)[j]
    #   i == j: site_l0[site] + (l1-l0)[i]            (homozygous pair)
    d = l1 - l0                                        # [A, E]
    same = torch.eye(A, dtype=torch.bool, device=dev)
    pair_logp = (site_l0[sid][:, None, :] + d[:, None, :]
                 + torch.where(same[:, :, None], 0.0, d[None, :, :]))
    pair_p = torch.exp(pair_logp)                      # [A, A, E]
    if E == 1:
        mixed = pair_p[..., 0]
    else:
        assert meta is not None, "multi-expert decode requires meta weights"
        w = meta.float()[:, :3][sid]                   # [A, 3]
        mixed = torch.einsum("ije,ie->ij", pair_p, w)
    iota = torch.arange(A, dtype=torch.int32, device=dev)
    valid_pair = ((sid[:, None] == sid[None, :])
                  & (amask[:, None] > 0) & (amask[None, :] > 0)
                  & (iota[:, None] <= iota[None, :]))
    v = torch.where(valid_pair, mixed, -1.0)           # [A, A]
    row_best = torch.amax(v, dim=1)                    # [A]
    row_arg = torch.argmax(v, dim=1).to(torch.int32)   # first max in the row
    site_best = torch.full((S,), float("-inf"), dtype=torch.float32,
                           device=dev)
    site_best.scatter_reduce_(0, sid, row_best, reduce="amax")
    # smallest row index attaining the site max (probabilities are >= 0 for
    # any real pair, so padding rows at -1 never win on non-empty sites)
    cand = torch.where(row_best >= site_best[sid], iota, A)
    best_i = torch.full((S,), torch.iinfo(torch.int32).max,
                        dtype=torch.int32, device=dev)
    best_i.scatter_reduce_(0, sid, cand.to(torch.int32), reduce="amin")
    valid = (site_best >= 0) & (best_i < A)
    best_i = torch.clamp(best_i, 0, A - 1)
    return {
        "best_i": best_i,
        "best_j": row_arg[best_i.long()],
        "best_p": site_best,
        "valid": valid,
    }


def calls_from_device_decode(decoded: dict, allele_site_index, sites
                             ) -> List[dict]:
    """Host-side assembly of per-site calls from fetched device-decode arrays
    (the fast-path counterpart of ``decode_batch(full=False)``).

    ``allele_site_index`` maps allele SLOT -> (site_idx, allele_idx); real
    slots are a contiguous prefix (pack_sites assigns them in order)."""
    best_i = np.asarray(decoded["best_i"])
    best_j = np.asarray(decoded["best_j"])
    best_p = np.asarray(decoded["best_p"])
    valid = np.asarray(decoded["valid"])
    results: List[dict] = []
    for si, site in enumerate(sites):
        if si >= len(valid) or not valid[si]:
            results.append(None)
            continue
        ii, jj = int(best_i[si]), int(best_j[si])
        si_i, ai = allele_site_index[ii]
        si_j, aj = allele_site_index[jj]
        assert si_i == si and si_j == si, "decode pair crossed sites"
        p = float(best_p[si])
        results.append({
            "site": site,
            "best_pair": (site.alleles[ai], site.alleles[aj]),
            "probability": p,
            "quality": phred_quality(p),
        })
    return results


def decode_batch(experts: np.ndarray, meta: np.ndarray | None,
                 allele_site_index: List[Tuple[int, int]],
                 sites, full: bool = True) -> List[dict]:
    """Decode a whole padded batch back into per-site calls.

    experts: [A_padded, E]; meta: [S_padded, 3] or None; ``sites`` is the list
    of SiteWork the batch was packed from.  Returns one dict per site with
    keys: site, alleles, pair_probs, best_pair, quality, meta, expert_probs.

    ``full=False`` is the plain-calling fast path: identical best_pair /
    probability / quality (same float ops in the same order), but the
    pair-probability dictionaries are not materialised and the returned
    dicts carry only the keys ``vcf_record_from_call`` needs.
    """
    per_site_rows: Dict[int, List[int]] = {}
    for slot, (si, ai) in enumerate(allele_site_index):
        per_site_rows.setdefault(si, []).append(slot)

    results = []
    for si, site in enumerate(sites):
        rows = per_site_rows.get(si, [])
        if not rows:
            results.append(None)
            continue
        site_logits = experts[rows]            # [A_s, E]
        site_meta = None if meta is None else meta[si]
        if not full:
            best_pair, best_p = _decode_site_fast(site_logits, site_meta,
                                                  site.alleles)
            results.append({
                "site": site,
                "best_pair": best_pair,
                "probability": best_p,
                "quality": phred_quality(best_p),
            })
            continue
        pair_probs, per_expert, meta_used = decode_site(
            site_logits, site_meta, site.alleles)
        best_pair, best_p = best_genotype(pair_probs)
        results.append({
            "site": site,
            "alleles": list(site.alleles),
            "pair_probs": pair_probs,
            "expert_pair_probs": per_expert,
            "meta": meta_used,
            "best_pair": best_pair,
            "probability": float(best_p),
            "quality": phred_quality(best_p),
        })
    return results
