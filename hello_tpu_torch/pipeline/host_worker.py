"""The calling worker's process: host stages of one genome chunk, no torch.

``parallel_call.HostWorkerPool`` spawns ``_worker`` from this module.  With
``spawn`` a child imports the module that defines its target, and that
import is all the worker holds before its first job: the BAM fetch,
hotspots, candidates and featurization (the native engine), and the coded
wire's encoding (``compact.encode_chunk_sites``, whose torch functions
import torch only when called).  So nothing imported here, and nothing on a
job's path, imports torch: a worker never maps the CUDA build's libraries,
whose pages a host would otherwise pay once per worker.
"""

from __future__ import annotations

import os
import sys
from typing import List

from ..constants import FEATURE_LENGTH
from ..io.fasta import FastaFile
from .batching import CodedSiteWork
from .candidates import generate_sites
from .hotspots import (candidate_intervals, cluster_hotspots, detect_hotspots,
                       make_read_sources)

_SENTINEL = "__done__"

# per-process FastaFile cache: a worker serves thousands of chunk jobs for
# the same reference; reopening per job would re-read the .fai (or, absent
# one, re-scan the whole FASTA) every time
_FASTA_CACHE: dict = {}


def _cached_fasta(path: str) -> FastaFile:
    key = (path, os.path.getmtime(path))
    if key not in _FASTA_CACHE:
        _FASTA_CACHE.clear()        # one reference per run; drop stale entries
        _FASTA_CACHE[key] = FastaFile(path)
    return _FASTA_CACHE[key]


def host_sites_for_chunk(bam_paths, ref_path, chromosome, start, stop,
                         options) -> List:
    """Host-side stages for one genome chunk; returns SiteWork list."""
    import random

    # fault injection for recovery tests: the first chunk to observe a
    # missing marker file creates it and fails (a transient, once-only fault)
    marker = options.get("fail_once_marker")
    if marker and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("injected transient fault")

    ref = _cached_fasta(ref_path)
    rng = random.Random(options.get("seed", 13))

    # fast path: the entire chunk pipeline in one native call (identical
    # output to the staged pipeline below — see tests/test_native_chunk.py)
    from .candidates import native_chunk_site_work
    fast = native_chunk_site_work([str(p) for p in bam_paths], ref,
                                  chromosome, start, stop, options, rng)
    if fast is not None:
        return _maybe_encode(fast, options)

    pacbio = options.get("pacbio", False)
    kwargs = dict(
        pacbio=pacbio,
        hybrid_hotspot=options.get("hybrid_hotspot", False),
        q_threshold=options.get("q_threshold", 10),
        min_mapq=options.get("min_mapq", 10),
    )
    hotspot_sources = make_read_sources(bam_paths, pacbio, for_hotspots=True,
                                        rng=rng, region=(chromosome, start, stop))
    positions = detect_hotspots(hotspot_sources, ref, chromosome, start, stop,
                                **kwargs)
    if not positions:
        return []
    active = cluster_hotspots(positions)
    sources = make_read_sources(bam_paths, pacbio, rng=rng,
                                region=(chromosome, start, stop))
    intervals, windows = candidate_intervals(
        sources, ref, chromosome, active,
        include_hp=options.get("include_hp", False),
        reassembly_size=options.get("reassembly_size", 10),
        provide_windows=True, **kwargs)
    sites = [s for s in generate_sites(
        sources, ref, chromosome, intervals, windows=windows,
        include_hp=options.get("include_hp", False),
        feature_length=options.get("feature_length", FEATURE_LENGTH),
        reassembly_size=options.get("reassembly_size", 10),
        pacbio=pacbio,
        hybrid_hotspot=options.get("hybrid_hotspot", False),
        q_threshold=options.get("q_threshold", 10),
        min_mapq=options.get("min_mapq", 10))
        if s is not None and s.alleles]
    return _maybe_encode(sites, options)


def _maybe_encode(sites, options):
    """Re-encode a chunk's sites into the 1-byte coded wire representation
    (CodedSiteWork) when the run requested it: ~6x less worker->main IPC and
    no dense batch assembly in the device-owning process.  The native chunk
    orchestrator usually emits CodedSiteWork directly (code-on-copy, no
    dense tensors at all) — this pass covers the staged Python pipeline and
    falls back to the dense list if any site cannot be coded (never true of
    featurizer output)."""
    if hasattr(sites, "to_sites"):      # CodedChunkBlock: already coded
        return sites
    if options.get("wire") == "coded" and sites \
            and not isinstance(sites[0], CodedSiteWork):
        from .compact import encode_chunk_sites
        coded = encode_chunk_sites(sites)
        if coded is not None:
            return coded
    return sites


def _worker(job_queue, result_queue):
    """Worker loop: consume (run_id, bam_paths, ref_path, options, chrom,
    start, stop) jobs, emit (status, run_id, region, payload) messages.
    Workers are generic (the job carries the data sources) so one pool serves
    a whole run; per-process BAM/index caches are keyed by path and persist
    across jobs.  The ready message's payload is the worker's pid and
    whether torch is imported in it."""
    # eager imports: charge the native engine's load to pool startup, not
    # to the first job
    from .. import native as _n
    _n.load_library()
    result_queue.put(("ready", None, None,
                      {"pid": os.getpid(), "torch": "torch" in sys.modules}))
    while True:
        job = job_queue.get()
        if job == _SENTINEL:
            return
        run_id, bam_paths, ref_path, options, chromosome, start, stop = job
        region = (chromosome, start, stop)
        try:
            sites = host_sites_for_chunk(bam_paths, ref_path, chromosome,
                                         start, stop, options)
            result_queue.put(("ok", run_id, region, sites))
        except Exception as exc:  # report and continue: recovery = rerun shard
            result_queue.put(("error", run_id, region, repr(exc)))
