"""The scoring loop: the main process of a genome call, closed.

What ``call_parallel`` runs for every batch a host worker hands it
(``hello_tpu_torch/pipeline/parallel_call.py``): ``pack_sites_wire`` of the
worker's coded sites, ``Scorer.score_async(decode=True)`` (pinned upload,
the wire expanded on the card, the forward with ``read_conv_reduce``, the
genotype decode on the card), and ``Scorer.finalize_many`` (the wait and
the 13-byte-per-site fetch).  ``Scorer.max_in_flight`` batches are kept in
flight: when the queue is full the oldest batch is finalized, with every
later one already done, behind one wait.

Set-up makes the weights on the card from the seed, a pool of distinct
batches (``generator.py``) encoded by ``encode_chunk_sites`` as a host
worker encodes them, and scores each pool batch once (every shape the
window meets, warm).  The window cycles through the pool.

The rate counts the sites whose genotypes came back, over the whole
window, the drain of the last batches included.  Each batch is also timed
from the start of its packing to the return of the ``finalize_many`` that
holds it (the 95th percentile is a per-layer metric: in a loop that keeps
its queue full a batch's time is the queue's depth times the service
time, the rate's own reciprocal with a tail).

``correct``: once the window has closed and the port's state is freed, the
plain reference (``reference/model.py``, fp32, TF32 off) scores a sample of
the pool drawn from the seed, from the generator's sites, and every answer
the window returned for those batches is judged, site by site: the pair
gap, by which the reference's probability of the port's pair lies below
the reference's best pair (the call), and the distance between the
port's probability and the reference's of the same pair.  A site the port
left invalid, or whose pair is not two alleles of that site, reads 1 in
both.  Their means are compared in units of the same distances of the
plain reference rounded to bf16 (``readings_of``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import os
import time

import numpy as np

from .. import flops, generator, weights
from ..reference import model as ref
from ..trace import HostProbe

#: pool batches the reference checks per run
CHECK_BATCHES = 6


def make_pool(cfg, traffic, seed):
    """(coded site lists, batch primitives) of the pool, made in a few
    threads (NumPy and the native encoder release the interpreter lock)."""
    from hello_tpu_torch import native
    from hello_tpu_torch.pipeline.compact import encode_chunk_sites

    # the native encoder is built at its first use in a fresh checkout, and
    # its loader takes no lock: build and load it here, before the threads
    native.load_library()
    ranges = generator.read_ranges(cfg, traffic)

    def one(k):
        batch = generator.make_batch(seed, k, traffic["sites_per_batch"],
                                     traffic["alleles_per_site"], ranges)
        coded = encode_chunk_sites(generator.port_sites(batch))
        if coded is None:
            raise ValueError("the generator's sites do not take the wire")
        return coded, batch

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        made = list(ex.map(one, range(traffic["pool_batches"])))
    return [m[0] for m in made], [m[1] for m in made]


def build_scorer(cfg, seed, device, precision):
    from hello_tpu_torch.nn.layers import set_precision
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.pipeline.call import Scorer

    set_precision(precision)
    model = create_model(cfg["model"])
    sd = weights.make_state_dict(ref.param_shapes(ref.config(cfg["model"])),
                                 seed, device)
    model.load_state_dict(sd, strict=True)
    del sd
    return Scorer(model, device=device)


def run(spec, seed, seconds, trace, device, spans, scratch):
    """Set-up, the window, then the check.  Returns the loop's outcome
    (see ``h100_bench/run.py``)."""
    import torch

    from hello_tpu_torch.pipeline.compact import pack_sites_wire

    cfg, traffic = spec["config"], spec["traffic"]
    precision = cfg["precision"]["score"]
    hybrid = len(cfg["platforms"]) > 1
    scorer = build_scorer(cfg, seed, device, precision)
    pool, prims = make_pool(cfg, traffic, seed)
    n_sites = [len(c) for c in pool]
    for coded in pool:                       # every shape of the window
        scorer.finalize(scorer.score_async(
            pack_sites_wire(coded, hybrid=hybrid), decode=True))
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)

    depth = scorer.max_in_flight
    inflight = collections.deque()
    results, latencies = [], []
    dispatched = 0

    def finalize(items):
        with spans("finalize"):
            outs = scorer.finalize_many([d for _, d, _ in items])
        now = time.perf_counter()
        for (t0, _, k), out in zip(items, outs):
            latencies.append(now - t0)
            # copied out of the Scorer's pinned buffers, as a caller that
            # turns answers into records lets them go back to its cache
            results.append((k, {n: np.array(a) for n, a in out.items()}))

    def one():
        """Pack, dispatch and, with the queue full, finalize: one batch."""
        nonlocal dispatched
        k = dispatched % len(pool)
        t0 = time.perf_counter()
        with spans("pack"):
            batch = pack_sites_wire(pool[k], hybrid=hybrid)
        with spans("dispatch"):
            inflight.append((t0, scorer.score_async(batch, decode=True), k))
        dispatched += 1
        if len(inflight) >= depth:
            take = [inflight.popleft()]
            while inflight and (inflight[0][1].event is None
                                or inflight[0][1].event.query()):
                take.append(inflight.popleft())
            finalize(take)

    def drain():
        if inflight:
            finalize(list(inflight))
            inflight.clear()

    probe = HostProbe()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end:
        one()
    drain()
    window = time.perf_counter() - t_start
    host = probe.end()
    attempted, done = dispatched, len(results)
    metrics = {
        "score_sites_per_s": (sum(n_sites[k] for k, _ in results) / window,
                              "sites/s"),
    }
    span_ms = {n: spans.mean_ms(n) for n in ("pack", "dispatch", "finalize")}
    trace_path = None
    if trace:
        # the profiler's window follows the measured one, so its cost
        # touches no number of the window
        from ..trace import Profiler
        with Profiler(os.path.join(scratch, "score_trace.json"),
                      wait=traffic["trace_wait"],
                      active=traffic["trace_active"], cuda=on_card) as prof:
            for _ in range(traffic["trace_wait"] + 1
                           + traffic["trace_active"]):
                one()
                prof.step()
            drain()
        trace_path = prof.export()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    model_flops = ref_cfg_flops(cfg, prims)
    ctx = {
        "loop": "score", "span_ms": span_ms, "window_s": window,
        "batch_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
        "precision": precision,
        "flops_done": sum(model_flops[k] for k, _ in results[:done]),
        "read_conv_launches": read_conv_launches(prims),
        "trace_path": trace_path, "host": host,
    }
    del scorer, pool, inflight
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    readings = judge_answers(cfg, prims, results, seed, device)
    return {"metrics": metrics, "attempted": attempted,
            "failed": attempted - done, "memory_peak_bytes": peak,
            "readings": readings, "ctx": ctx, "t_start": t_start}


def ref_cfg_flops(cfg, prims):
    """Forward FLOPs of each pool batch (its real reads, alleles, sites)."""
    net = ref.config(cfg["model"])
    return [flops.forward_flops(net, [int(p["counts"].sum())
                                      for p in b["platforms"]],
                                len(b["allele_site"]), b["num_sites"])
            for b in prims]


def read_conv_launches(prims):
    """Per platform: (FLOPs, bytes) of each launch of the read convolver
    kernel (the same in every pool batch: ``generator.read_counts``), and
    the rows the wire ships for it."""
    b = prims[0]
    return [flops.read_conv_work(int(p["counts"].sum()), len(b["allele_site"]))
            for p in b["platforms"]]


def reference_answers(net, params, batch, device, quant=None):
    """(best probability per site, the pair-probability terms, meta, each
    allele's site) of one pool batch from the plain reference; ``quant``
    rounds as the control's lower precision does."""
    import torch

    kw = {} if quant is None else {"quant": quant}
    with torch.no_grad(), ref.tf32(False):
        out = ref.forward(net, params,
                          generator.reference_inputs(batch, device), **kw)
        site = torch.as_tensor(batch["allele_site"], device=device).long()
        best, (site_l0, d) = ref.best_pairs(out["experts"], out["meta"], site,
                                            batch["num_sites"])
    return best, site_l0, d, out["meta"], site


def gaps(answer, best, site_l0, d, meta, site, num_sites):
    """Per site of one batch: (the gap of the reference's probability of the
    answered pair below its best pair, the distance between the answer's
    probability and the reference's of the same pair), as float64
    tensors; a site left invalid, or answered with a pair that is not two
    alleles of that site, reads 1 in both."""
    import torch

    dev = best.device
    S = num_sites
    i = torch.as_tensor(np.asarray(answer["best_i"])[:S], device=dev).long()
    j = torch.as_tensor(np.asarray(answer["best_j"])[:S], device=dev).long()
    p = torch.as_tensor(np.asarray(answer["best_p"])[:S], device=dev).double()
    valid = torch.as_tensor(np.asarray(answer["valid"])[:S], device=dev)
    s = torch.arange(S, device=dev)
    A = site.shape[0]
    inside = (i >= 0) & (i < A) & (j >= 0) & (j < A)
    ic, jc = i.clamp(0, A - 1), j.clamp(0, A - 1)
    sound = valid & inside & (site[ic] == s) & (site[jc] == s) & (ic <= jc)
    pr = ref.pair_prob(site_l0, d, meta, s, ic, jc)
    return (torch.where(sound, best - pr, 1.0),
            torch.where(sound, (p - pr).abs(), 1.0))


def bf16(x):
    """x rounded to bfloat16, as float32: the precision the scoring
    configurations state, applied where the port rounds."""
    import torch
    return x.to(torch.bfloat16).float()


def readings_of(per_site, per_site_bf16):
    """The numbers compared, from per-site (pair gap, probability
    distance) of the answers judged and of the plain reference rounded to
    bf16 on the same batches: ``p_err_ratio``, the answers' mean
    probability distance over the bf16 reference's (how far the answers
    lie from fp32 in units of what bf16 arithmetic itself moves on these
    weights; a seed's weights move both alike); ``pair_gap_ratio``, the
    answers' mean pair gap (what the pairs they chose lose against fp32's
    best) in the same unit: a pair chosen within bf16's noise of the best
    loses less than that noise, a wrong pair loses far more (the bf16
    reference's own mean pair gap is no unit: where no pair flips it is
    0); and ``bad_answers``, the sites answered invalid or with a pair not
    of the site.  Also, not compared: ``p_err`` and ``pair_gap`` (the
    widest), the means."""
    def mean(sites, col):
        return (sum(float(s[col].sum()) for s in sites)
                / sum(s[col].numel() for s in sites))

    p_err, p_err_bf16 = mean(per_site, 1), mean(per_site_bf16, 1)
    gap, gap_bf16 = mean(per_site, 0), mean(per_site_bf16, 0)
    return {"p_err_ratio": (p_err + 1e-9) / (p_err_bf16 + 1e-9),
            "pair_gap_ratio": (gap + 1e-9) / (p_err_bf16 + 1e-9),
            "bad_answers": sum(int((b >= 1.0).sum()) for _, b in per_site),
            "p_err": max(float(b.max()) for _, b in per_site),
            "pair_gap": max(float(a.max()) for a, _ in per_site),
            "p_err_mean": p_err, "p_err_mean_bf16": p_err_bf16,
            "pair_gap_mean": gap, "pair_gap_mean_bf16": gap_bf16}


def judge_answers(cfg, prims, results, seed, device):
    """``readings_of`` every window answer of a sample of ``CHECK_BATCHES``
    pool batches drawn from the seed."""
    import torch

    net = ref.config(cfg["model"])
    params = weights.make_state_dict(ref.param_shapes(net), seed, device)
    rng = generator.rng_for(seed, 0, stream=7)
    sample = set(rng.choice(len(prims), size=min(CHECK_BATCHES, len(prims)),
                            replace=False).tolist())
    by_batch = collections.defaultdict(list)
    for k, out in results:
        if k in sample:
            by_batch[k].append(out)
    if not by_batch:
        return {}
    per_site, per_site_bf16 = [], []
    for k in sorted(by_batch):
        best, site_l0, d, meta, site = reference_answers(net, params, prims[k],
                                                         device)
        per_site += [gaps(out, best, site_l0, d, meta, site,
                          prims[k]["num_sites"]) for out in by_batch[k]]
        per_site_bf16.append(gaps(
            bf16_answers(net, params, prims[k], device), best, site_l0, d,
            meta, site, prims[k]["num_sites"]))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return readings_of(per_site, per_site_bf16)


def bf16_answers(net, params, batch, device, quant=bf16):
    """The plain reference's decoded answers with every conv's input,
    weight and output rounded by ``quant`` (bf16: the yardstick of
    ``p_err_ratio``; the control's lower precision in ``calibrate.py``)."""
    _, site_l0, d, meta, site = reference_answers(net, params, batch, device,
                                                  quant=quant)
    return best_answers(site_l0, d, meta, site, batch["num_sites"])


def best_answers(site_l0, d, meta, site, num_sites, skip=None):
    """Decoded answers from pair-probability terms, in the Scorer's form
    (best_i, best_j, best_p, valid per site): the highest pair, the
    smallest slots on a tie, with its probability.  ``skip`` (answers in
    this form) takes each site's pair out of the choice: the fault of a
    decode that answers a valid pair that is not the best."""
    import torch

    A = site.shape[0]
    idx = torch.arange(A, device=site.device)
    ii, jj = torch.meshgrid(idx, idx, indexing="ij")
    keep = (site[ii] == site[jj]) & (ii <= jj)
    i, j = ii[keep], jj[keep]
    s = site[i]
    p = ref.pair_prob(site_l0, d, meta, s, i, j)
    if skip is not None:
        si, sj = (torch.as_tensor(skip[k], device=site.device).long()
                  for k in ("best_i", "best_j"))
        p = torch.where((i == si[s]) & (j == sj[s]), -1.0, p)
    top = torch.full((num_sites,), -1.0, dtype=torch.float64,
                     device=site.device).scatter_reduce(0, s, p, "amax")
    key = torch.where(p >= top[s], i * A + j, A * A)
    first = torch.full((num_sites,), A * A, dtype=torch.long,
                       device=site.device).scatter_reduce(0, s, key, "amin")
    valid = first < A * A
    bi, bj = (first // A).clamp(max=A - 1), (first % A)
    best_p = ref.pair_prob(site_l0, d, meta,
                           torch.arange(num_sites, device=site.device), bi, bj)
    return {"best_i": bi.cpu().numpy(), "best_j": bj.cpu().numpy(),
            "best_p": best_p.cpu().numpy(), "valid": valid.cpu().numpy()}
