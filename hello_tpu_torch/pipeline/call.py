"""End-to-end variant calling on the GPU.

The port of hello_tpu's pipeline/call.py: hotspot detection -> active
regions -> candidate intervals -> site tensors (the native host engine,
shared with hello_tpu) -> batched scoring on the card (wire expansion, the
MoE forward with the CUDA read-convolver kernel, genotype decode) -> sorted
VCF.  ``call_region`` / ``call_genome`` are the library surface; ``main``
is the CLI (``python -m hello_tpu_torch.pipeline.call``).

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu``); without a card the default raises instead of carrying
on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..constants import FEATURE_LENGTH
from ..io.fasta import FastaFile
from ..io.vcf import VcfRecord, make_record, write_vcf
from ..nn.genotype import decode_batch
from ..nn.layers import ROADMAP_PRECISION, set_precision
from ..nn.moe import MoEAttention, create_model
from .batching import PaddedBatch, SiteWork, group_sites_for_batching, pack_sites
from .candidates import generate_sites
from .hotspots import (candidate_intervals, cluster_hotspots, detect_hotspots,
                       make_read_sources)

logger = logging.getLogger(__name__)

ROADMAP_WAITS = "ROADMAP.md Queue 1"


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) on a machine without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class Dispatched:
    """A dispatched batch: its results in host memory (filled by
    device-to-host copies still in flight until ``event`` completes)."""
    out: Dict[str, Optional[torch.Tensor]]
    event: Optional[torch.cuda.Event] = None


class Scorer:
    """Batched model forward on one device.

    ``compact`` (ship the coded wire for dense batches), ``packed_conv``
    (run the read convolver over the wire's packed rows instead of the dense
    ``A*R`` grid) and ``device_decode`` (decode genotypes on the device and
    fetch 13 bytes per site) default to on for CUDA, as hello_tpu defaults
    them on for accelerators; ``compact`` and ``packed_conv`` default to off
    on the CPU.  The read-convolver weights are folded once here."""

    # consumes pre-coded WireBatch inputs (pack_sites_wire) directly
    accepts_wire = True
    # dispatch depth: the device holds the next batches while the host
    # decodes earlier ones; inputs of in-flight batches stay on the device
    max_in_flight = 4

    def __init__(self, model: MoEAttention, device=None,
                 compact: Optional[bool] = None,
                 packed_conv: Optional[bool] = None,
                 device_decode: bool = True):
        self.device = resolve_device(device)
        set_precision("highest")           # the only precision ported yet
        self.model = model.to(self.device).eval()
        on_card = self.device.type == "cuda"
        self.compact = on_card if compact is None else compact
        self.packed_conv = on_card if packed_conv is None else packed_conv
        self.device_decode = device_decode
        with torch.no_grad():
            self.folded = self.model.fold_read_convs()

    def _upload(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """numpy wire/dense dict -> tensors on the device, through pinned
        host buffers and asynchronous copies."""
        out = {}
        for k, v in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _forward(self, d, decode):
        if (self.packed_conv and "codes0" in d
                and ("codes1" in d or "read_mask1" not in d)):
            from .compact import expand_compact_packed
            batch = expand_compact_packed(d)   # conv over shipped rows only
        else:
            from .compact import expand_compact
            batch = expand_compact(d)          # no-op for dense batches
        out = self.model(batch, folded=self.folded)
        if decode:
            from ..nn.genotype import decode_pairs_device
            return decode_pairs_device(
                out["experts"], out["meta"], batch["site_ids"],
                batch["allele_mask"], batch["ref_segments"].shape[0])
        return out

    def score_async(self, batch: PaddedBatch, decode: bool = False) -> Dispatched:
        """Dispatch the forward without waiting for the device; the results'
        device-to-host copies start at once and an event marks their end.

        ``decode=True`` (honoured only when ``device_decode`` is on) runs the
        genotype decode on the device and returns the per-site winners
        instead of the logit tensors."""
        decode = decode and self.device_decode
        if hasattr(batch, "wire"):        # WireBatch: pre-coded by the host
            d = batch.wire
        elif self.compact:
            from .compact import compact_batch
            d = compact_batch(batch)
        else:
            d = batch.device_dict()
        with torch.inference_mode():
            out = self._forward(self._upload(d), decode)
            if self.device.type != "cuda":
                return Dispatched(out)
            host = {}
            for k, t in out.items():
                if t is None:
                    host[k] = None
                    continue
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host[k] = h
            event = torch.cuda.Event()
            event.record()
        return Dispatched(host, event)

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
        """Finalize several ``score_async`` results behind one wait: batches
        run in dispatch order on one stream, so once the newest event is
        done every older one is too."""
        if not results:
            return []
        events = [r.event for r in results if r.event is not None]
        if events:
            events[-1].synchronize()
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


def vcf_record_from_call(call: dict, ref_lookup) -> Optional[VcfRecord]:
    """Build a VCF record from one decoded site call
    (reference caller_calling.vcfRecords:657-754 semantics)."""
    if call is None:
        return None
    return _record_from_genotype(call["site"], call["best_pair"],
                                 call["quality"], ref_lookup,
                                 "MixtureOfExpertPrediction")


def call_region(bam_paths: Sequence[str], ref: FastaFile, chromosome: str,
                start: int, stop: int, scorer: Scorer,
                pacbio: bool = False, include_hp: bool = False,
                hybrid_hotspot: bool = False,
                q_threshold: int = 10, min_mapq: int = 10,
                reassembly_size: int = 10,
                feature_length: int = FEATURE_LENGTH,
                max_alleles_per_batch: int = 2048,
                seed: int = 13,
                stats: Optional[dict] = None) -> List[VcfRecord]:
    """Call variants in one region; returns normalised VCF records.

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
            return []

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
                                     group, full=False)
            for call in calls:
                rec = vcf_record_from_call(call, ref_lookup)
                if rec is not None:
                    records.append(rec)

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
                # decode on the device when the scorer's device_decode is on
                out = scorer.score_async(batch, decode=True)
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
    return records


def call_genome(bam_paths: Sequence[str], ref_path: str, scorer: Scorer,
                out_vcf: str, regions: Optional[Sequence[Tuple[str, int, int]]] = None,
                **kwargs) -> str:
    """Call variants across regions (default: every chromosome) into a VCF."""
    ref = FastaFile(ref_path)      # also persists the .fai when missing
    if regions is None:
        regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]
    records: List[VcfRecord] = []
    for chrom, start, stop in regions:
        records.extend(call_region(bam_paths, ref, chrom, start, stop, scorer,
                                   **kwargs))
    contigs = {c: ref.length(c) for c in ref.chromosomes()}
    write_vcf(out_vcf, records, contigs=contigs, sort=True)
    return out_vcf


def load_scorer(model_name: str, checkpoint: Optional[str] = None,
                seed: int = 0, device=None) -> Scorer:
    """Build a Scorer from a named config: seeded random init, a torch state
    dict (``.pt`` / ``.pth``), or a hello_tpu pytree checkpoint (numpy
    pickle).  Reference ``.wrapper.dnn`` files wait for a later slice."""
    device = resolve_device(device)
    model = create_model(model_name)
    if checkpoint is None:
        from ..nn.convert import init_params
        init_params(model, torch.Generator().manual_seed(seed))
    elif checkpoint.endswith(".dnn"):
        raise NotImplementedError(
            f".wrapper.dnn checkpoints are not ported yet ({ROADMAP_WAITS})")
    elif checkpoint.endswith((".pt", ".pth")):
        model.load_state_dict(torch.load(checkpoint, map_location="cpu"),
                              strict=True)
    else:
        from ..nn.convert import load_jax_checkpoint
        model.load_state_dict(load_jax_checkpoint(checkpoint, model),
                              strict=True)
    return Scorer(model, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu_torch variant caller (PyTorch / CUDA)")
    parser.add_argument("--bam", required=True, help="illumina BAM")
    parser.add_argument("--ref", required=True, help="reference FASTA")
    parser.add_argument("--out", required=True, help="output VCF path")
    parser.add_argument("--model", default="illumina",
                        help="model config: illumina|pacbio|pacbio_hp")
    parser.add_argument("--checkpoint", default=None,
                        help="torch state dict (.pt) or hello_tpu pytree "
                             "checkpoint; default: seeded random weights")
    parser.add_argument("--seed", type=int, default=0,
                        help="init seed when no checkpoint is given")
    parser.add_argument("--region", default=None,
                        help="chrom[,start,stop]; default: whole genome")
    parser.add_argument("--pacbio", action="store_true")
    parser.add_argument("--include_hp", action="store_true")
    parser.add_argument("--hybrid_hotspot", action="store_true")
    parser.add_argument("--q_threshold", type=int, default=10)
    parser.add_argument("--mapq_threshold", type=int, default=10)
    parser.add_argument("--reconcilement_size", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    # fp32 everywhere with TF32 off; hello_tpu's CLI defaults to bf16
    parser.add_argument("--precision", default="highest",
                        help="highest (fp32); default and bf16 are not "
                             "ported yet")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="host worker processes; only 0 is ported")
    parser.add_argument("--provide_features", action="store_true",
                        help="per-expert VCF streams (not ported yet)")
    parser.add_argument("--profile_dir", default=None,
                        help="device trace directory (not ported yet)")
    parser.add_argument("--log", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, filename=args.log,
                        format="%(asctime)s %(levelname)s %(message)s")

    if args.precision != "highest":
        parser.error(f"--precision {args.precision} is not ported yet; only "
                     f"highest is ({ROADMAP_PRECISION})")
    if args.num_workers != 0:
        parser.error(f"--num_workers > 0 (call_parallel) is not ported yet "
                     f"({ROADMAP_WAITS})")
    if args.provide_features:
        parser.error(f"--provide_features is not ported yet ({ROADMAP_WAITS})")
    if args.profile_dir:
        parser.error(f"--profile_dir is not ported yet ({ROADMAP_WAITS})")
    bams = args.bam.split(",")
    if len(bams) != 1:
        parser.error(f"hybrid (two-BAM) calling is not ported yet "
                     f"({ROADMAP_WAITS})")
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

    scorer = load_scorer(args.model, args.checkpoint, seed=args.seed,
                         device=args.device)
    call_genome(bams, args.ref, scorer, args.out, regions=regions,
                pacbio=args.pacbio, include_hp=args.include_hp,
                hybrid_hotspot=args.hybrid_hotspot,
                q_threshold=args.q_threshold, min_mapq=args.mapq_threshold,
                reassembly_size=args.reconcilement_size)
    telemetry.log_report()
    logger.info("Completed running the script")


if __name__ == "__main__":
    main()
