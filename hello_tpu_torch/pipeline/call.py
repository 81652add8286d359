"""End-to-end variant calling on the GPU.

The port of hello_tpu's pipeline/call.py: hotspot detection -> active
regions -> candidate intervals -> site tensors (the native host engine,
shared with hello_tpu) -> batched scoring on the card (wire expansion, the
MoE forward with the CUDA read-convolver kernel, genotype decode) -> sorted
VCF.  ``call_region`` / ``call_genome`` are the library surface; ``main``
is the CLI (``python -m hello_tpu_torch.pipeline.call``), which runs at
``--precision bf16`` unless told otherwise and hands whole genomes to the
worker-pool caller (pipeline/parallel_call.call_parallel) with
``--num_workers N``, as hello_tpu's CLI does.  Two BAMs
(Illumina, PacBio) call with a hybrid model; ``provide_experts``
(``--provide_features``) adds the per-expert, best and mean VCF streams, the
meta-expert's choices and the per-site features.

Everything runs on the cards unless the caller passes ``device="cpu"``
(``--device cpu``): the Scorer round-robins batches over every visible card
(``--device cuda:N`` pins one), and without a card the default raises
instead of carrying on on the CPU.  ``--profile_dir`` traces the run
(telemetry.device_trace), the Scorer's spans (``scorer.dispatch`` and its
``scorer.upload`` and ``scorer.launch``, inside which ``scorer.capture`` or
``scorer.replay`` where a captured CUDA graph runs the forward) on a track
of their own, and the card's time in the read convolvers the width-1
kernel does not implement, on the layer route or the wide kernel
(``scorer.read_conv_layers``).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import logging
import os
import pickle
import random
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..constants import FEATURE_LENGTH
from ..io.fasta import FastaFile
from ..io.vcf import VcfRecord, make_record, write_vcf
from ..nn.genotype import decode_batch
from ..nn import layers as nn_layers
from ..nn.archs import NAMED_CONFIGS
from ..nn.moe import MoEAttention, create_model, layer_route_calls, stamped
from ..ops.read_conv import ROUTE_IDS, WIDTH_ROUTES
from . import graphs
from .batching import PaddedBatch, SiteWork, group_sites_for_batching, pack_sites
from .candidates import generate_sites
from .hotspots import (candidate_intervals, cluster_hotspots, detect_hotspots,
                       make_read_sources)

logger = logging.getLogger(__name__)

def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) on a machine without a card, or for a card
    that is not visible."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is not None \
            and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} is not visible: "
                           f"{torch.cuda.device_count()} card(s)")
    return device


def visible_devices() -> List[torch.device]:
    """Every visible card, ``cuda:0`` up; raises without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _on(device: torch.device):
    """The device's context (current card and its current stream) for the
    uploads and launches of a dispatch."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass
class Dispatched:
    """A dispatched batch: its results in host memory (filled by
    device-to-host copies still in flight until ``event`` completes), and
    the position in ``Scorer.devices`` it ran on.  On the card, ``wait``
    holds what ``finalize_many`` records as ``scorer.card_wait``
    (``telemetry.record_card_wait``), and as ``scorer.read_conv_layers``
    where ``out`` holds ``read_conv_stamps``, until it has recorded it."""
    out: Dict[str, Optional[torch.Tensor]]
    event: Optional[torch.cuda.Event] = None
    position: int = 0
    outstanding: bool = True
    wait: Optional[tuple] = None


@dataclasses.dataclass
class _Replica:
    """One position's model, its folded read convolvers, the primary's
    generation they were made from, and the (parameter, in-place version)
    pairs of the read convolvers that were folded."""
    model: MoEAttention
    folded: Optional[dict] = None
    folded_from: Optional[list] = None
    generation: int = -1


def _versions(tensors):
    return [(t, t._version) for t in tensors]


def _unchanged(record, tensors) -> bool:
    return (record is not None and len(record) == len(tensors)
            and all(t is u and v == u._version
                    for (t, v), u in zip(record, tensors)))


def _slots(model):
    """Every submodule, parameter and buffer of ``model`` as (the dict that
    holds it, its key, it, its in-place version or None)."""
    return [(d, k, v, getattr(v, "_version", None)) for m in model.modules()
            for d in (m._modules, m._parameters, m._buffers)
            for k, v in d.items() if v is not None]


class Scorer:
    """Batched model forward, round-robin over ``devices``.

    ``devices`` defaults to every visible card (one process drives them all:
    the pipelined callers keep several batches in flight, so N cards run N
    batches at once); ``device=`` is the one-device spelling, and ``cpu``
    the CPU.  The model given is the primary, on ``devices[0]``; every other
    position gets its own replica and fold, copied from the primary before
    its next dispatch whenever a primary parameter was replaced or changed
    in place (``load_state_dict``, an optimiser step), and every position
    folds its read convolvers again when theirs changed, so a swap of
    weights never runs stale ones.  The accounting is keyed by position, so
    one device may appear twice: ``dispatch_counts``, batches dispatched
    and not yet finalized per position, and ``peak_concurrent_devices``, the
    most positions holding work at once.

    ``compact`` (ship the coded wire for dense batches), ``packed_conv``
    (run the read convolver over the wire's packed rows instead of the dense
    ``A*R`` grid) and ``device_decode`` (decode genotypes on the device and
    fetch 13 bytes per site) default to on for CUDA, as hello_tpu defaults
    them on for accelerators; ``compact`` and ``packed_conv`` default to off
    on the CPU.

    On the card each position replays the forward of a batch shape it has
    met before as a captured CUDA graph (``pipeline/graphs.py``: a shape's
    first batch runs eagerly, its second is captured); ``graph_counts``
    counts the batches run ``eager``, ``captured`` and ``replayed``.  The
    kernel's and the layer route's counters count only what their Python
    code launches (eager forwards and captures); the launches that later
    replays run again are ``replayed_launches_by_route``,
    ``replayed_launches_by_width``, ``replayed_layer_route_calls`` and
    ``replayed_layer_route_rows``.  The CPU runs every batch eagerly.

    On the card a forward with a read convolver that the width-1 kernel
    does not implement (``nn.moe.stamped``: the layer route, or the wide
    kernel) also returns ``read_conv_stamps`` (int64 [read convolvers, 2]:
    the card's clock before and after each, ``MoEAttention.forward``),
    copied to the host with the answers; ``finalize_many`` records their
    time as ``scorer.read_conv_layers``, so eager, captured and replayed
    batches each carry their own.  Width-1 folds ship no stamps."""

    # consumes pre-coded WireBatch inputs (pack_sites_wire) directly
    accepts_wire = True

    def __init__(self, model: MoEAttention, device=None,
                 compact: Optional[bool] = None,
                 packed_conv: Optional[bool] = None,
                 device_decode: bool = True,
                 devices: Optional[Sequence] = None):
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        if devices is None:
            devices = visible_devices() if device is None else [device]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a Scorer needs at least one device")
        self.device = self.devices[0]
        self.precision = nn_layers.PRECISION
        # cuBLAS's and cuDNN's TF32 switches as the precision in force wants
        # them (torch's own default lets cuDNN take TF32 even at highest)
        nn_layers.set_precision(self.precision)
        self.model = model.to(self.device).eval()
        on_card = self.device.type == "cuda"
        self.compact = on_card if compact is None else compact
        self.packed_conv = on_card if packed_conv is None else packed_conv
        self.device_decode = device_decode
        self._replicas: List[Optional[_Replica]] = [None] * len(self.devices)
        self._replicas[0] = _Replica(self.model)
        self._next = 0
        # the primary's slots as last seen, and a generation bumped whenever
        # one of them was replaced or changed in place
        self._slots = _slots(self.model)
        self._generation = 0
        # dispatch (the caller's or a stager thread) and finalize (a drainer
        # thread, parallel_call._AsyncDrainer) share the accounting
        self._account_lock = threading.Lock()
        self.dispatch_counts: Dict[int, int] = {}
        self._outstanding: Dict[int, int] = {}
        # each position's newest end event (the card's idle before a batch),
        # and its first events that are free again
        self._last_end: Dict[int, torch.cuda.Event] = {}
        self._free_events: Dict[int, list] = {}
        self.peak_concurrent_devices = 0
        # each position's captured forwards, by batch shape
        self._graphs = [graphs.GraphCache() for _ in self.devices]
        self.graph_counts = {"eager": 0, "captured": 0, "replayed": 0}
        self.replayed_launches_by_route = dict.fromkeys(ROUTE_IDS, 0)
        self.replayed_launches_by_width = dict.fromkeys(WIDTH_ROUTES, 0)
        self.replayed_layer_route_calls = dict.fromkeys(layer_route_calls, 0)
        self.replayed_layer_route_rows = dict.fromkeys(layer_route_calls, 0)
        self._refresh(0)

    @property
    def max_in_flight(self) -> int:
        """Dispatch depth: the devices hold the next batches while the host
        decodes earlier ones (inputs of in-flight batches stay on their
        device), two per device so each has the next queued."""
        return max(4, 2 * len(self.devices) + 2)

    @property
    def folded(self) -> dict:
        """The primary's folded read convolvers (``FoldedReadConv`` for a
        kernel, ``nn.moe.LayerRoute`` for the layer route)."""
        return self._replicas[0].folded

    def read_conv_routes(self) -> Dict[str, str]:
        """Each read convolver's route: the kernel route of the precision
        (``tf32x3``, ``tf32`` or ``bf16``) or ``layers``."""
        return {name: f.route for name, f in self.folded.items()}

    def replica_folds(self) -> List[dict]:
        """Each position's folded read convolvers (None before its first
        dispatch)."""
        return [None if r is None else r.folded for r in self._replicas]

    @staticmethod
    def _read_conv_params(model):
        return [p for name in ("read_conv0", "read_conv1")
                if model.net(name) is not None
                for p in model.net(name).parameters()]

    def _primary_generation(self) -> int:
        """Bump the generation when a submodule, parameter or buffer of the
        primary is not the one (same object, same in-place version) seen at
        the last dispatch: one pass over the cached slots per dispatch, a
        walk of the model only after a change."""
        if not all(d.get(k) is v and (n is None or v._version == n)
                   for d, k, v, n in self._slots):
            self._slots = _slots(self.model)
            self._generation += 1
        return self._generation

    @torch.no_grad()
    def _refresh(self, pos: int) -> _Replica:
        """Position ``pos``'s replica, copied from the primary (parameters
        and buffers: batch-norm statistics) when the primary changed since
        the last copy, and folded again when its read convolvers are not
        those of the last fold."""
        generation = self._primary_generation()
        rep = self._replicas[pos]
        if rep is None:
            rep = _Replica(copy.deepcopy(self.model).to(self.devices[pos]))
            self._replicas[pos] = rep
        elif rep.generation == generation:
            return rep
        elif pos:
            rep.model.load_state_dict(self.model.state_dict())
        rep.generation = generation
        params = self._read_conv_params(rep.model)
        if not _unchanged(rep.folded_from, params):
            rep.folded = rep.model.fold_read_convs()
            rep.folded_from = _versions(params)
        return rep

    def _upload(self, arrays: Dict[str, np.ndarray], device: torch.device,
                static: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """numpy wire/dense dict -> tensors on ``device``, through pinned
        host buffers and asynchronous copies; on the card into ``static``'s
        buffers (a captured graph's inputs, made at its first upload) when
        given."""
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
                if static is None:
                    t = t.to(device, non_blocking=True)
                else:
                    buf = static.get(k)
                    if buf is None:
                        buf = static[k] = torch.empty(t.shape, dtype=t.dtype,
                                                      device=device)
                    t = buf.copy_(t, non_blocking=True)
            out[k] = t
        return out

    def _forward(self, rep: _Replica, d, decode):
        if (self.packed_conv and "codes0" in d
                and ("codes1" in d or "read_mask1" not in d)):
            from .compact import expand_compact_packed
            batch = expand_compact_packed(d)   # conv over shipped rows only
        else:
            from .compact import expand_compact
            batch = expand_compact(d)          # no-op for dense batches
        stamps = None
        if batch["site_ids"].is_cuda and any(
                stamped(f) for f in rep.folded.values()):
            stamps = torch.zeros((len(rep.folded), 2), dtype=torch.int64,
                                 device=batch["site_ids"].device)
        out = rep.model(batch, folded=rep.folded, stamps=stamps)
        if decode:
            from ..nn.genotype import decode_pairs_device
            out = decode_pairs_device(
                out["experts"], out["meta"], batch["site_ids"],
                batch["allele_mask"], batch["ref_segments"].shape[0])
        if stamps is not None:
            out = dict(out, read_conv_stamps=stamps)
        return out

    def _launch(self, pos: int, rep: _Replica, d, decode,
                graph: Optional[graphs.Graph], seq: int):
        """Enqueue the forward: eagerly without ``graph``, else by replaying
        it, captured first if it is empty."""
        if graph is None:
            self.graph_counts["eager"] += 1
            return self._forward(rep, d, decode)
        if graph.graph is None:
            with telemetry.stage("scorer.capture", key=seq):
                self._graphs[pos].capture(
                    graph, lambda: self._forward(rep, d, decode),
                    self.devices[pos])
            self.graph_counts["captured"] += 1
        else:
            with telemetry.stage("scorer.replay", key=seq):
                graph.graph.replay()
            self.graph_counts["replayed"] += 1
            for route, n in graph.launches.items():
                self.replayed_launches_by_route[route] += n
            for width, n in graph.launches_by_width.items():
                self.replayed_launches_by_width[width] += n
            for name, n in graph.layer_route_calls.items():
                self.replayed_layer_route_calls[name] += n
            for name, n in graph.layer_route_rows.items():
                self.replayed_layer_route_rows[name] += n
        return graph.outputs

    def score_async(self, batch: PaddedBatch, decode: bool = False) -> Dispatched:
        """Dispatch the forward to the next device of the round robin
        without waiting for it; the results' device-to-host copies start at
        once and an event marks their end.

        ``decode=True`` (honoured only when ``device_decode`` is on) runs the
        genotype decode on the device and returns the per-site winners
        instead of the logit tensors.

        Spans (``telemetry.stage``, keyed by the batch's number):
        ``scorer.dispatch`` over the call, ``scorer.upload`` over the
        uploads, ``scorer.launch`` over the expansion, the forward and the
        decode, all enqueued, and inside it ``scorer.capture`` or
        ``scorer.replay`` where a graph runs them.  On the card two timed
        events bracket the batch's work, from which ``finalize_many``
        records the card's idle before it (``scorer.card_wait``), and the
        batch's stamps, where it has any, give ``scorer.read_conv_layers``
        there."""
        seq = self._next
        self._next += 1
        with telemetry.stage("scorer.dispatch", key=seq) as t0:
            decode = decode and self.device_decode
            if hasattr(batch, "wire"):    # WireBatch: pre-coded by the host
                d = batch.wire
            elif self.compact:
                from .compact import compact_batch
                d = compact_batch(batch)
            else:
                d = batch.device_dict()
            pos = seq % len(self.devices)
            device = self.devices[pos]
            rep = self._refresh(pos)
            on_card = device.type == "cuda"
            graph = None
            if on_card:
                graph = self._graphs[pos].lookup(
                    graphs.graph_key(d, rep.generation, nn_layers.PRECISION,
                                     decode, self.packed_conv),
                    rep.generation)
            with torch.inference_mode(), _on(device):
                if on_card:
                    free = self._free_events.setdefault(pos, [])
                    started = telemetry.timed_event(free)
                    started.record()
                with telemetry.stage("scorer.upload", key=seq):
                    d = self._upload(d, device,
                                     None if graph is None else graph.inputs)
                with telemetry.stage("scorer.launch", key=seq):
                    out = self._launch(pos, rep, d, decode, graph, seq)
                if not on_card:
                    return self._account(Dispatched(out, position=pos))
                host = {}
                for k, t in out.items():
                    if t is None:
                        host[k] = None
                        continue
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    host[k] = h
                event = torch.cuda.Event(enable_timing=True)
                event.record()
            wait = (self._last_end.get(pos), started, t0, seq, free)
            self._last_end[pos] = event
            return self._account(Dispatched(host, event, pos, wait=wait))

    def _account(self, result: Dispatched) -> Dispatched:
        """Count a dispatch and the positions holding work."""
        pos = result.position
        with self._account_lock:
            self.dispatch_counts[pos] = self.dispatch_counts.get(pos, 0) + 1
            self._outstanding[pos] = self._outstanding.get(pos, 0) + 1
            busy = sum(1 for v in self._outstanding.values() if v > 0)
            self.peak_concurrent_devices = max(self.peak_concurrent_devices,
                                               busy)
        return result

    @staticmethod
    def _host_form(out):
        if "best_i" in out:                # device-decoded winners
            return {k: out[k].numpy()
                    for k in ("best_i", "best_j", "best_p", "valid")}
        meta = out["meta"]
        return out["experts"].numpy(), (None if meta is None else meta.numpy())

    def finalize(self, result: Dispatched):
        """Wait for a ``score_async`` result and return it as numpy."""
        return self.finalize_many([result])[0]

    def finalize_many(self, results: Sequence[Dispatched]):
        """Finalize several ``score_async`` results behind one wait per
        device: batches run in dispatch order on each device's stream, so
        once a device's newest event is done so is every older one there."""
        if not results:
            return []
        newest = {}
        for r in results:
            if r.event is not None:
                newest[r.position] = r.event
        for event in newest.values():
            event.synchronize()
        with self._account_lock:
            for r in results:
                if r.outstanding:
                    r.outstanding = False
                    self._outstanding[r.position] -= 1
                # its first event, and its stamps' copy, are complete once
                # its end event is
                if r.wait is not None and (r.event is newest[r.position]
                                           or r.event.query()):
                    telemetry.record_card_wait("scorer.card_wait", r.wait)
                    stamps = r.out.get("read_conv_stamps")
                    if stamps is not None:     # (start ns, key) as card_wait
                        telemetry.record_stamps("scorer.read_conv_layers",
                                                stamps, *r.wait[2:4])
                r.wait = None
        return [self._host_form(r.out) for r in results]

    def __call__(self, batch: PaddedBatch):
        return self.finalize(self.score_async(batch))


def row_budget_frac(scorer) -> Optional[float]:
    """Packed-row batch budget fraction for this scorer, or None: active only
    when the scorer consumes the coded wire AND runs the packed-row
    convolution, where tightly packed rows skip the padding rows' FLOPs."""
    if not (getattr(scorer, "packed_conv", False)
            and getattr(scorer, "accepts_wire", False)):
        return None
    return 0.5


def _record_from_genotype(site: "SiteWork", top_alleles, quality, ref_lookup,
                          info) -> Optional[VcfRecord]:
    """Shared alt/genotype assembly for all call streams
    (reference caller_calling.vcfRecords:699-742 / prepareVcf.callAlleles)."""
    ref_allele = "".join(ref_lookup(site.chromosome, p)
                         for p in range(site.start, site.stop))
    # sorted: set iteration order is hash-randomised per process, which
    # would make ALT column order (and GT indices) differ run to run
    alt_alleles = sorted(set(top_alleles).difference({ref_allele}))
    if len(alt_alleles) == 0:
        genotypes = [0, 0]
        alt_alleles = sorted(set(site.alleles).difference({ref_allele}))
        if len(alt_alleles) == 0:
            return None
    else:
        genotypes = [0 if a == ref_allele else alt_alleles.index(a) + 1
                     for a in top_alleles]
    return make_record(site.chromosome, site.start, ref_allele, alt_alleles,
                       genotypes, ref_lookup, qual=quality, info=info)


def record_from_pair_probs(site: "SiteWork", pair_probs, ref_lookup,
                           info="MixtureOfExpertPrediction") -> Optional[VcfRecord]:
    """VCF record from an allele-pair probability table
    (reference caller_calling.vcfRecords:657-754 / prepareVcf.callAlleles)."""
    from ..nn.genotype import best_genotype, phred_quality

    top_alleles, best_p = best_genotype(pair_probs)
    return _record_from_genotype(site, top_alleles, phred_quality(best_p),
                                 ref_lookup, info)


def vcf_record_from_call(call: dict, ref_lookup) -> Optional[VcfRecord]:
    """Build a VCF record from one decoded site call
    (reference caller_calling.vcfRecords:657-754 semantics)."""
    if call is None:
        return None
    return _record_from_genotype(call["site"], call["best_pair"],
                                 call["quality"], ref_lookup,
                                 "MixtureOfExpertPrediction")


#: the streams ``provide_experts`` adds: expert 0/1/2, best and mean records,
#: the meta-expert's choice per site, and per-site feature dicts
EXPERT_STREAMS = (0, 1, 2, "best", "mean", "choices", "features")


def _add_expert_streams(call: dict, ref_lookup, streams: dict):
    """Per-expert / best / mean records, the choice and the feature record
    of one fully decoded site call (reference prepareVcf.py:112-182 and
    caller_calling.py:744-754)."""
    site = call["site"]
    meta_w = np.asarray(call["meta"], dtype=np.float64)
    per_expert = call["expert_pair_probs"]
    recs = [record_from_pair_probs(site, pp, ref_lookup,
                                   info=f"HELLO_expert{k}")
            for k, pp in enumerate(per_expert)]
    for k, rec in enumerate(recs):
        if rec is not None:
            streams[k].append(rec)
    choice = int(np.argmax(meta_w[:3]))
    if recs[choice] is not None:
        streams["best"].append(recs[choice])
    # meta-weighted mean of the experts' pair probabilities
    mean_probs = {pair: float(sum(meta_w[i] * float(per_expert[i][pair])
                                  for i in range(len(per_expert))))
                  for pair in per_expert[0]}
    mean_rec = record_from_pair_probs(site, mean_probs, ref_lookup,
                                      info="HELLO_mean")
    if mean_rec is not None:
        streams["mean"].append(mean_rec)
    streams["choices"].append((site.chromosome, site.start, site.stop,
                               choice))
    streams["features"].append({
        "chromosome": site.chromosome,
        "position": site.start,
        "length": site.stop - site.start,
        "alleles": list(site.alleles),
        "meta": np.asarray(call["meta"]),
        "expertPredictions": tuple(per_expert),
        "bestPair": call["best_pair"],
        "quality": call["quality"],
    })


def call_region(bam_paths: Sequence[str], ref: FastaFile, chromosome: str,
                start: int, stop: int, scorer: Scorer,
                pacbio: bool = False, include_hp: bool = False,
                hybrid_hotspot: bool = False,
                q_threshold: int = 10, min_mapq: int = 10,
                reassembly_size: int = 10,
                feature_length: int = FEATURE_LENGTH,
                max_alleles_per_batch: int = 2048,
                seed: int = 13,
                provide_experts: bool = False,
                stats: Optional[dict] = None):
    """Call variants in one region; returns normalised VCF records, or
    ``(records, streams)`` with ``provide_experts`` (``streams`` keyed by
    ``EXPERT_STREAMS``; those sites are scored to full logits and decoded on
    the host).

    ``stats`` (optional dict) accumulates ``sites``/``records`` counts for
    throughput accounting."""
    rng = random.Random(seed)

    # fast path: the whole host pipeline in one native call per region;
    # scorers that take the coded wire get CodedSiteWork straight from the
    # native featurizer (no dense tensors materialise)
    from .candidates import native_chunk_site_work
    with telemetry.stage("host_sites_native"):
        sites = native_chunk_site_work(
            [str(p) for p in bam_paths], ref, chromosome, start, stop,
            dict(pacbio=pacbio, include_hp=include_hp,
                 hybrid_hotspot=hybrid_hotspot, q_threshold=q_threshold,
                 min_mapq=min_mapq, reassembly_size=reassembly_size,
                 feature_length=feature_length,
                 wire="coded" if scorer.accepts_wire else "dense"), rng)

    if sites is None:
        with telemetry.stage("hotspot_detection"):
            hotspot_sources = make_read_sources(bam_paths, pacbio, for_hotspots=True, rng=rng,
                                                region=(chromosome, start, stop))
            positions = detect_hotspots(
                hotspot_sources, ref, chromosome, start, stop, pacbio=pacbio,
                hybrid_hotspot=hybrid_hotspot, q_threshold=q_threshold, min_mapq=min_mapq)
        logger.info("%s:%d-%d: %d hotspot positions", chromosome, start, stop, len(positions))
        if not positions:
            return (([], {k: [] for k in EXPERT_STREAMS}) if provide_experts
                    else [])

        with telemetry.stage("candidate_intervals"):
            active = cluster_hotspots(positions)
            sources = make_read_sources(bam_paths, pacbio, rng=rng,
                                        region=(chromosome, start, stop))
            intervals, windows = candidate_intervals(
                sources, ref, chromosome, active, pacbio=pacbio,
                hybrid_hotspot=hybrid_hotspot, q_threshold=q_threshold,
                min_mapq=min_mapq, include_hp=include_hp,
                reassembly_size=reassembly_size, provide_windows=True)
        logger.info("%s: %d candidate intervals", chromosome, len(intervals))

        with telemetry.stage("site_generation"):
            sites = [s for s in generate_sites(
                sources, ref, chromosome, intervals, windows=windows, pacbio=pacbio,
                include_hp=include_hp, hybrid_hotspot=hybrid_hotspot,
                feature_length=feature_length, q_threshold=q_threshold,
                min_mapq=min_mapq, reassembly_size=reassembly_size)
                if s is not None and s.alleles]
    logger.info("%s: %d scorable sites", chromosome, len(sites))
    if stats is not None:
        stats["sites"] = stats.get("sites", 0) + len(sites)

    ref_lookup = lambda chrom, pos: ref.fetch(chrom, pos, pos + 1)
    records: List[VcfRecord] = []
    streams = ({k: [] for k in EXPERT_STREAMS} if provide_experts
               else None)
    hybrid_model = scorer.model.hybrid

    def _decode_entry(group, batch, fin):
        with telemetry.stage("genotype_decode"):
            if isinstance(fin, dict) and "best_i" in fin:
                from ..nn.genotype import calls_from_device_decode
                calls = calls_from_device_decode(
                    fin, batch.allele_site_index, group)
            else:
                experts, meta = fin
                calls = decode_batch(experts, meta, batch.allele_site_index,
                                     group, full=provide_experts)
            for call in calls:
                rec = vcf_record_from_call(call, ref_lookup)
                if rec is not None:
                    records.append(rec)
                if streams is not None and call is not None:
                    _add_expert_streams(call, ref_lookup, streams)

    # Pipelined scoring: dispatch runs ahead of the device; a drainer thread
    # (parallel_call._AsyncDrainer) waits for results and decodes behind.
    # Batches are classed by read depth so one deep site cannot inflate the
    # padded read axis of every other site's batch; outputs are re-sorted
    # below, so cross-class scoring order is free.
    from .batching import CodedSiteWork
    from .parallel_call import _AsyncDrainer
    drainer_acc = {"backpressure_s": 0.0, "drain_s": 0.0,
                   "fetch_s": 0.0, "decode_s": 0.0}
    drainer = _AsyncDrainer(scorer, _decode_entry, drainer_acc,
                            scorer.max_in_flight)
    # coded batches heading for the packed-row convolution are additionally
    # budgeted by real read ROWS so they pack tightly
    row_frac = row_budget_frac(scorer)
    body_ok = False
    try:
        for group in group_sites_for_batching(sites, max_alleles_per_batch,
                                              by_read_bucket=True,
                                              row_budget_frac=row_frac):
            with telemetry.stage("batch_packing"):
                if isinstance(group[0], CodedSiteWork):
                    from .compact import pack_sites_wire
                    batch = pack_sites_wire(group, hybrid=hybrid_model,
                                            feature_length=feature_length)
                else:
                    batch = pack_sites(group, hybrid=hybrid_model,
                                       feature_length=feature_length,
                                       channels0=7 if include_hp else 6,
                                       channels1=7 if include_hp else 6)
            with telemetry.stage("device_scoring"):
                # decode on the device when the scorer's device_decode is on;
                # the expert streams need the full logits on the host
                out = scorer.score_async(batch, decode=not provide_experts)
            drainer.put(group, batch, out)
        body_ok = True
    finally:
        # join the drainer before reading `records`; a close() failure must
        # not mask an exception already propagating from the loop above
        if body_ok:
            drainer.close()
        else:
            try:
                drainer.close()
            except BaseException:
                logger.exception("drainer failed during abort")
        telemetry.add("device_wait", drainer_acc["fetch_s"])
        telemetry.add("dispatch_backpressure", drainer_acc["backpressure_s"])

    records.sort(key=lambda r: r.key())
    if stats is not None:
        stats["records"] = stats.get("records", 0) + len(records)
    if streams is None:
        return records
    for k, lst in streams.items():
        if k == "features":
            lst.sort(key=lambda f: (f["chromosome"], f["position"]))
        elif k == "choices":
            lst.sort(key=lambda c: (c[0], c[1]))
        else:
            lst.sort(key=lambda r: r.key())
    return records, streams


def call_genome(bam_paths: Sequence[str], ref_path: str, scorer: Scorer,
                out_vcf: str, regions: Optional[Sequence[Tuple[str, int, int]]] = None,
                provide_experts: bool = False, **kwargs) -> str:
    """Call variants across regions (default: every chromosome) into a VCF.

    With ``provide_experts``, also writes beside ``out_vcf`` (``<base>`` is
    its path without ``.vcf``): ``<base>.expert{0,1,2}.vcf``,
    ``<base>.best.vcf`` (the meta-expert's pick per site), ``<base>.mean.vcf``
    (meta-weighted mean), ``<base>.choices.bed`` and ``<base>.features.pkl``
    (reference prepareVcf.py:112-182, caller_calling.py:744-754)."""
    ref = FastaFile(ref_path)      # also persists the .fai when missing
    if regions is None:
        regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]
    records: List[VcfRecord] = []
    streams = {k: [] for k in EXPERT_STREAMS}
    for chrom, start, stop in regions:
        result = call_region(bam_paths, ref, chrom, start, stop, scorer,
                             provide_experts=provide_experts, **kwargs)
        if provide_experts:
            result, region_streams = result
            for k in EXPERT_STREAMS:
                streams[k].extend(region_streams[k])
        records.extend(result)
    contigs = {c: ref.length(c) for c in ref.chromosomes()}
    write_vcf(out_vcf, records, contigs=contigs, sort=True)
    if provide_experts:
        base = out_vcf[:-4] if out_vcf.endswith(".vcf") else out_vcf
        for k in (0, 1, 2):
            write_vcf(f"{base}.expert{k}.vcf", streams[k], contigs=contigs,
                      sort=True)
        for name in ("best", "mean"):
            write_vcf(f"{base}.{name}.vcf", streams[name], contigs=contigs,
                      sort=True)
        with open(f"{base}.choices.bed", "w") as fh:
            for chrom, start, stop, choice in sorted(streams["choices"]):
                fh.write(f"{chrom}\t{start}\t{stop}\t{choice}\n")
        with open(f"{base}.features.pkl", "wb") as fh:
            pickle.dump(streams["features"], fh)
    return out_vcf


def load_scorer(model_name: str, checkpoint: Optional[str] = None,
                seed: int = 0, device=None,
                reference_python: Optional[str] = None) -> Scorer:
    """Build a Scorer from a named config: seeded random init, a reference
    torch file (``.wrapper.dnn`` whole-module pickle, or a ``.pt`` /
    ``.pth`` state dict, with or without the ``moeMerged.`` / ``module.``
    prefix: nn/convert.load_torch_checkpoint, which imports a pickle's
    classes from ``reference_python`` or ``PYTHONPATH``), or a hello_tpu
    pytree checkpoint (numpy pickle).  A network the model configures and a
    torch file lacks keeps the seeded init of ``seed`` (hello_tpu's loader
    skips it) and is logged.  It scores on ``device``, or round-robin over
    every visible card when none is named."""
    from ..nn.convert import init_params

    devices = visible_devices() if device is None else [resolve_device(device)]
    # a checkpoint overwrites this init, but for a network a torch file lacks
    model = init_params(create_model(model_name),
                        torch.Generator().manual_seed(seed))
    if checkpoint is None:
        pass
    elif checkpoint.endswith((".dnn", ".pt", ".pth")):
        from ..nn.convert import load_torch_checkpoint
        model.load_state_dict(load_torch_checkpoint(
            checkpoint, model, reference_python=reference_python),
            strict=True)
    else:
        from ..nn.convert import load_jax_checkpoint
        model.load_state_dict(load_jax_checkpoint(checkpoint, model),
                              strict=True)
    return Scorer(model, devices=devices)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu_torch variant caller (PyTorch / CUDA)")
    parser.add_argument("--bam", required=True,
                        help="comma-separated BAMs (illumina[,pacbio])")
    parser.add_argument("--ref", required=True, help="reference FASTA")
    parser.add_argument("--out", required=True, help="output VCF path")
    parser.add_argument("--model", default="illumina",
                        choices=sorted(NAMED_CONFIGS),
                        help="model config (the reference's named configs)")
    parser.add_argument("--checkpoint", default=None,
                        help="reference torch file (.wrapper.dnn, .pt, .pth) "
                             "or hello_tpu pytree checkpoint; default: "
                             "seeded random weights")
    parser.add_argument("--reference_python", default=None,
                        help="the reference's python/ directory, from which "
                             "a .wrapper.dnn pickle's classes import "
                             "(default: PYTHONPATH)")
    parser.add_argument("--seed", type=int, default=0,
                        help="init seed when no checkpoint is given (and of "
                             "a network a torch file lacks)")
    parser.add_argument("--region", default=None,
                        help="chrom[,start,stop]; default: whole genome")
    parser.add_argument("--pacbio", action="store_true")
    parser.add_argument("--include_hp", action="store_true")
    parser.add_argument("--hybrid_hotspot", action="store_true")
    parser.add_argument("--q_threshold", type=int, default=10)
    parser.add_argument("--mapq_threshold", type=int, default=10)
    parser.add_argument("--reconcilement_size", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="cuda:N (one card) or cpu; default: every "
                             "visible card, round-robin")
    # hello_tpu's default: bf16 conv activations on the card's bf16 route
    parser.add_argument("--precision", default=os.environ.get(
        "HELLO_TPU_PRECISION", "bf16"),
                        help="bf16 (default; bf16 conv activations) | "
                             "default (TF32 products, fp32 activations) | "
                             "high | highest (fp32)")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="host worker processes (0 = in-process)")
    parser.add_argument("--chunk_size", type=int, default=200_000)
    parser.add_argument("--spill_records", type=int, default=400_000,
                        help="worker-pool caller: spill sorted record runs "
                        "to disk beyond this many in-memory records and "
                        "stream-merge at the end (bounds RSS on "
                        "whole-genome runs)")
    parser.add_argument("--process_index", type=int, default=0,
                        help="this host's index for multi-host region sharding")
    parser.add_argument("--process_count", type=int, default=1,
                        help="total hosts sharing the work")
    parser.add_argument("--provide_features", action="store_true",
                        help="also write per-expert, best and mean VCFs, the "
                             "meta-expert's choices and per-site features "
                             "(in-process calling only)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the run "
                             "here, with the program's spans (scorer.*) on "
                             "a track of their own")
    parser.add_argument("--log", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, filename=args.log,
                        format="%(asctime)s %(levelname)s %(message)s")

    if args.precision not in nn_layers.PRECISIONS:
        parser.error(f"--precision {args.precision} is not one of "
                     f"{', '.join(nn_layers.PRECISIONS)}")
    bams = args.bam.split(",")
    for bam in bams:
        if not os.path.exists(bam):
            parser.error(f"BAM not found: {bam}")
    if not os.path.exists(args.ref):
        parser.error(f"reference FASTA not found: {args.ref}")

    regions = None
    if args.region:
        parts = args.region.split(",")
        ref = FastaFile(args.ref)
        if parts[0] not in ref.index:
            parser.error(
                f"chromosome {parts[0]!r} not in reference "
                f"(available: {', '.join(ref.chromosomes()[:8])})")
        if len(parts) == 1:
            regions = [(parts[0], 0, ref.length(parts[0]))]
        else:
            regions = [(parts[0], int(parts[1]), int(parts[2]))]

    nn_layers.set_precision(args.precision)
    # the trace covers the run from load_scorer to the end, as hello_tpu's
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    trace = (telemetry.device_trace(args.profile_dir, cuda=on_card)
             if args.profile_dir else contextlib.nullcontext())
    with trace:
        _call(parser, args, bams, regions)
    logger.info("Completed running the script")


def _call(parser, args, bams, regions):
    scorer = load_scorer(args.model, args.checkpoint, seed=args.seed,
                         device=args.device,
                         reference_python=args.reference_python)
    want = 2 if scorer.model.hybrid else 1
    if len(bams) != want:
        parser.error(f"--model {args.model} takes {want} BAM(s) "
                     f"(illumina[,pacbio]), got {len(bams)}")

    if args.process_count > 1:
        from ..parallel.mesh import shard_regions
        ref = FastaFile(args.ref)
        if regions is None:
            regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]
        # 4 Mb granules: hosts get near-equal base counts regardless of
        # chromosome size skew (see shard_regions)
        regions = shard_regions(regions, args.process_index,
                                args.process_count, granularity=4_000_000)
        logger.info("host %d/%d handles %d region pieces", args.process_index,
                    args.process_count, len(regions))

    options = dict(pacbio=args.pacbio, include_hp=args.include_hp,
                   hybrid_hotspot=args.hybrid_hotspot,
                   q_threshold=args.q_threshold, min_mapq=args.mapq_threshold,
                   reassembly_size=args.reconcilement_size)
    if args.num_workers > 0:
        from .parallel_call import call_parallel
        if args.provide_features:
            logger.warning("--provide_features is written by in-process "
                           "calling only; --num_workers %d ignores it",
                           args.num_workers)
        call_parallel(bams, args.ref, scorer, args.out, regions=regions,
                      num_workers=args.num_workers,
                      chunk_size=args.chunk_size,
                      spill_records=args.spill_records, **options)
    else:
        call_genome(bams, args.ref, scorer, args.out, regions=regions,
                    provide_experts=args.provide_features, **options)
    telemetry.log_report()


if __name__ == "__main__":
    main()
