"""Process-parallel calling: host stages in a worker pool feeding scoring
on the card in the main process.

The port of hello_tpu's pipeline/parallel_call.py.  Worker processes run
the host stages (BAM fetch -> hotspots -> candidates -> featurization, the
native engine shared with hello_tpu) for genome chunks and ship each
chunk's sites back on the coded wire as one ``CodedChunkBlock``; the main
process owns the card: it packs batches, dispatches them through
``Scorer.score_async(decode=True)`` (pinned uploads, an event after the
results' copies) and decodes behind the device.  Workers never touch the
card: it is hidden from them before they start (``_spawn_env``), and
their loop lives in ``host_worker``, which imports no torch.
Multi-host scale-out hands each host a share of the regions
(``parallel.mesh.shard_regions``); the per-host VCFs merge at the end.

``call_region`` (pipeline/call.py) shares ``_out_ready`` and
``_AsyncDrainer``.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import multiprocessing as mp
import os
import sys
import threading
import time
import types
from typing import List, Optional, Sequence, Tuple

from ..constants import FEATURE_LENGTH
from ..io.fasta import FastaFile
from ..io.vcf import VcfRecord, write_vcf
from ..nn.genotype import decode_batch
from .batching import CodedSiteWork, group_sites_for_batching, pack_sites
from .call import Scorer, vcf_record_from_call
# the worker's loop and host stages live in a module that imports no torch
from .host_worker import _SENTINEL, _worker, host_sites_for_chunk  # noqa: F401

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _without_main():
    """Start processes that do not run the parent's ``__main__`` again.
    ``spawn`` re-imports the parent's main module in each child, to find
    targets defined there; the calling CLI's (``python -m
    hello_tpu_torch.pipeline.call``) imports torch.  The pool's target lives
    in ``host_worker``, so while its workers start ``__main__`` is a bare
    module and they import nothing of the parent's script (a script read
    from stdin starts a pool too)."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


@contextlib.contextmanager
def _spawn_env():
    """Hide the card from processes started inside: CUDA_VISIBLE_DEVICES is
    empty while they start, so a spawned worker inherits it before it
    imports torch and can never create a CUDA context.  The parent
    initialises CUDA first (``torch.cuda.is_available``), so the parent
    keeps its card whatever another thread does meanwhile."""
    import torch

    torch.cuda.is_available()
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


class HostWorkerPool:
    """Persistent pool of host-stage worker processes.

    Worker startup (process spawn, the host modules and the native engine;
    no torch) is paid per worker; a production genome run pays it once and amortises it over thousands of chunks.  Create the pool
    once, pass it to any number of :func:`call_parallel` invocations, and
    ``shutdown()`` when done.  ``ready`` holds each worker's ready message
    (its pid and whether torch is imported in it).

    Single-consumer: one ``call_parallel`` drives the pool at a time.
    """

    def __init__(self, num_workers: int = 4):
        ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self._job_queue = ctx.Queue()
        self._result_queue = ctx.Queue()
        self._ready = 0
        self.ready: List[dict] = []
        # run token: results carry the submitting run's id so a consumer can
        # discard leftovers from an aborted previous call_parallel (reusing
        # the pool after an error must not mix runs' sites)
        self._run_id = 0
        self._workers = [
            ctx.Process(target=_worker,
                        args=(self._job_queue, self._result_queue),
                        daemon=True)
            for _ in range(num_workers)]
        with _spawn_env(), _without_main():
            for w in self._workers:
                w.start()

    def _check_alive(self):
        # ANY dead worker while results are awaited is abnormal (workers only
        # exit on the shutdown sentinel) — including a clean exit code 0,
        # which would otherwise leave the consumer polling to the timeout
        dead = [w for w in self._workers if not w.is_alive()]
        if dead:
            raise RuntimeError(
                f"{len(dead)} pool worker(s) died "
                f"(exitcodes {[w.exitcode for w in dead]}); see worker stderr")

    def _get(self, timeout: float):
        """Queue get that notices dead workers instead of blocking forever."""
        import queue as _q
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._result_queue.get(timeout=5.0)
            except _q.Empty:
                self._check_alive()
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no worker result within {timeout:.0f}s")

    def wait_ready(self, timeout: float = 300.0):
        """Block until every worker has finished its imports."""
        while self._ready < self.num_workers:
            msg = self._get(timeout)
            assert msg[0] == "ready", msg
            self._ready += 1
            self.ready.append(msg[3])

    def new_run(self) -> int:
        """Start a new logical run: later ``results`` calls discard messages
        from earlier runs (leftovers of an aborted consumer must not leak
        into the next run's call set)."""
        self._run_id += 1
        return self._run_id

    def submit(self, bam_paths, ref_path, options, chunk):
        chromosome, start, stop = chunk
        self._job_queue.put((self._run_id, list(bam_paths), ref_path,
                             dict(options), chromosome, start, stop))

    def results(self, n: int, timeout: float = 3600.0):
        """Yield n ('ok'|'error', region, payload) messages of the CURRENT
        run as they arrive; stale runs' messages are dropped."""
        got = 0
        while got < n:
            msg = self._get(timeout)
            if msg[0] == "ready":          # late startup acks interleave
                self._ready += 1
                self.ready.append(msg[3])
                continue
            status, run_id, region, payload = msg
            if run_id != self._run_id:     # aborted previous run's leftovers
                continue
            got += 1
            yield (status, region, payload)

    def shutdown(self):
        for _ in self._workers:
            self._job_queue.put(_SENTINEL)
        for w in self._workers:
            w.join(timeout=30)
        self._workers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def _out_ready(out) -> bool:
    """Whether a dispatched batch's results are done, without blocking: the
    CUDA event recorded after its device-to-host copies has completed.
    Results without an event (CPU scoring, duck-typed scorers returning host
    arrays) are always ready."""
    event = getattr(out, "event", None)
    return event is None or event.query()


class _AsyncDrainer:
    """Background consumer of dispatched scoring batches.

    Waiting for a batch's device results on the dispatching thread would
    serialise host packing behind the device.  TWO pipelined threads own the
    in-flight queue's downstream half: a FETCH thread blocks on the oldest
    dispatched batch and fetches the finished prefix in ONE
    ``finalize_many`` call; a DECODE thread runs genotype decode + record
    assembly behind it.  Both overlap the dispatching thread; the in-flight
    window releases at fetch time (results are on the host, device memory
    is free) so the dispatcher refills while decode runs behind.

    ``put`` enforces the in-flight window (bounds live batch inputs on the
    device);
    ``close`` joins both threads and re-raises any consumer-side failure.
    Only the decode thread touches the result callback — strictly in fetch
    order — so record lists need no locking; the caller reads them after
    ``close`` returns.
    """

    def __init__(self, scorer, on_result, t_acc, max_in_flight: int,
                 max_decode_backlog: int = 16):
        self._on_result = on_result
        self._t_acc = t_acc
        self._max = max_in_flight
        self._finalize_many = getattr(scorer, "finalize_many", None)
        self._finalize = getattr(scorer, "finalize", lambda out: out)
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._done = False
        self._exc: Optional[BaseException] = None
        self._in_flight = 0
        # fetched-but-undecoded batches hand off to a separate DECODE thread
        # (bounded backlog): genotype decode + record assembly is pure host
        # Python and previously serialised behind the next blocking fetch on
        # this thread — at 100 Mb scale each cost ~27 s of the same wall.
        self._dq: collections.deque = collections.deque()
        self._decode_done = False
        self._max_decode = max_decode_backlog
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hello-tpu-drain")
        self._decode_thread = threading.Thread(target=self._run_decode,
                                               daemon=True,
                                               name="hello-tpu-decode")
        self._thread.start()
        self._decode_thread.start()

    def put(self, group, batch, out):
        """Queue a dispatched batch; blocks while the in-flight window is
        full (the wait is the back-pressure that used to be the main loop's
        blocking drain)."""
        t0 = time.perf_counter()
        with self._cv:
            while self._in_flight >= self._max and self._exc is None:
                self._cv.wait()
            if self._exc is not None:
                raise self._exc
            self._q.append((group, batch, out))
            self._in_flight += 1
            self._cv.notify_all()
        self._t_acc["backpressure_s"] += time.perf_counter() - t0

    def close(self):
        """Signal end of input, wait for both queues to drain, re-raise any
        consumer failure."""
        with self._cv:
            self._done = True
            self._cv.notify_all()
        self._thread.join()
        with self._cv:
            self._decode_done = True
            self._cv.notify_all()
        self._decode_thread.join()
        if self._exc is not None:
            raise self._exc

    def _run(self):
        try:
            while True:
                with self._cv:
                    while not self._q and not self._done:
                        self._cv.wait()
                    if not self._q and self._done:
                        return
                    # oldest entry (blocking) + the already-finished prefix
                    # behind it: ONE bulk fetch per round trip
                    take = [self._q.popleft()]
                    while self._q and _out_ready(self._q[0][2]):
                        take.append(self._q.popleft())
                t0 = time.perf_counter()
                if self._finalize_many is not None:
                    fins = self._finalize_many([e[2] for e in take])
                else:
                    fins = [self._finalize(e[2]) for e in take]
                t1 = time.perf_counter()
                self._t_acc["fetch_s"] += t1 - t0
                self._t_acc["drain_s"] += t1 - t0
                with self._cv:
                    # hand off to the decode thread; results are on host, so
                    # device memory is free — release the in-flight window NOW (the
                    # dispatcher can refill while decode runs behind)
                    while (len(self._dq) >= self._max_decode
                           and self._exc is None):
                        self._cv.wait()
                    if self._exc is not None:
                        raise self._exc
                    for entry, fin in zip(take, fins):
                        self._dq.append((entry, fin))
                    self._in_flight -= len(take)
                    self._cv.notify_all()
        except BaseException as exc:   # surfaced by put()/close()
            with self._cv:
                self._exc = exc
                self._cv.notify_all()

    def _run_decode(self):
        try:
            while True:
                with self._cv:
                    while not self._dq and not self._decode_done \
                            and self._exc is None:
                        self._cv.wait()
                    if self._exc is not None:
                        return
                    if not self._dq and self._decode_done:
                        return
                    (group, batch, _out), fin = self._dq.popleft()
                    self._cv.notify_all()
                t0 = time.perf_counter()
                self._on_result(group, batch, fin)
                self._t_acc["decode_s"] += time.perf_counter() - t0
        except BaseException as exc:   # surfaced by put()/close()
            with self._cv:
                self._exc = exc
                self._cv.notify_all()


class _AsyncStager:
    """Background pack + host->device dispatch stage.

    The upstream mirror of :class:`_AsyncDrainer`: batch packing and the
    upload + dispatch of each batch run on their own threads.  The main
    loop only appends site groups to a bounded queue and returns to
    consuming worker results.  Backpressure chains naturally: the drainer's
    in-flight window fills -> ``drainer.put`` blocks the stager -> the stager
    queue fills -> the main loop blocks in ``put`` (accounted as
    ``stage_backpressure_s``).

    ``close`` drains the queues, joins the threads, and re-raises any
    staging failure.  Groups dispatch strictly in arrival order (the
    drainer bulk fetch assumes the oldest dispatched batch finishes first).

    With ``dispatch_fn`` the stager runs TWO pipelined threads: a PACK
    thread runs ``stage_fn(group) -> item`` (batch assembly, host numpy)
    and a DISPATCH thread runs ``dispatch_fn(item)`` (the pinned upload and
    the forward's launches).  Without it the single thread runs
    ``stage_fn`` alone (packing and dispatching inside)."""

    def __init__(self, stage_fn, t_acc, max_groups: int = 8,
                 dispatch_fn=None, max_packed: int = 4):
        self._stage = stage_fn
        self._dispatch = dispatch_fn
        self._t_acc = t_acc
        self._max = max_groups
        self._max_packed = max_packed
        self._q: collections.deque = collections.deque()
        self._q2: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._done = False
        self._pack_done = False
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hello-tpu-pack")
        self._thread.start()
        self._dispatch_thread = None
        if dispatch_fn is not None:
            self._dispatch_thread = threading.Thread(
                target=self._run_dispatch, daemon=True,
                name="hello-tpu-dispatch")
            self._dispatch_thread.start()

    def put(self, group):
        t0 = time.perf_counter()
        with self._cv:
            while len(self._q) >= self._max and self._exc is None:
                self._cv.wait()
            if self._exc is not None:
                raise self._exc
            self._q.append(group)
            self._cv.notify_all()
        self._t_acc["stage_backpressure_s"] += time.perf_counter() - t0

    def close(self, abort: bool = False):
        """Drain the queues and join; ``abort=True`` discards queued groups
        instead (an aborting caller must not dispatch more device work)."""
        with self._cv:
            if abort:
                self._q.clear()
                self._q2.clear()
            self._done = True
            self._cv.notify_all()
        self._thread.join()
        with self._cv:
            if abort:
                self._q2.clear()
            self._pack_done = True
            self._cv.notify_all()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join()
        if self._exc is not None:
            raise self._exc

    def _run(self):
        try:
            while True:
                with self._cv:
                    while not self._q and not self._done \
                            and self._exc is None:
                        self._cv.wait()
                    if self._exc is not None:
                        return
                    if not self._q and self._done:
                        return
                    group = self._q.popleft()
                    self._cv.notify_all()
                item = self._stage(group)
                if self._dispatch is None:
                    continue
                with self._cv:
                    while (len(self._q2) >= self._max_packed
                           and self._exc is None):
                        self._cv.wait()
                    if self._exc is not None:
                        return
                    self._q2.append(item)
                    self._cv.notify_all()
        except BaseException as exc:   # surfaced by put()/close()
            with self._cv:
                self._exc = exc
                self._cv.notify_all()

    def _run_dispatch(self):
        try:
            while True:
                with self._cv:
                    while not self._q2 and not self._pack_done \
                            and self._exc is None:
                        self._cv.wait()
                    if self._exc is not None:
                        return
                    if not self._q2 and self._pack_done:
                        return
                    item = self._q2.popleft()
                    self._cv.notify_all()
                self._dispatch(item)
        except BaseException as exc:   # surfaced by put()/close()
            with self._cv:
                self._exc = exc
                self._cv.notify_all()


class _RecordSpiller:
    """Bounds the caller's in-memory VCF record set.

    Records accumulate in memory until ``threshold``; then the current set
    is sorted and spilled to a temp shard next to the output, and
    ``finish`` streams a k-way merge of the spills plus the in-memory tail
    (io.vcf.merge_vcfs) — whole-genome runs hold O(threshold) records
    instead of every record of the genome.  Below the threshold the
    behavior is byte-identical to the old sort-everything-and-write path.

    add() is called only from the drainer thread; finish() only after the
    drainer is joined — no locking needed."""

    def __init__(self, out_vcf: str, contigs, threshold: int):
        from ..io.vcf import record_sort_key
        self.out_vcf = out_vcf
        self.contigs = contigs
        # a non-positive threshold means "never spill" (a user passing 0 to
        # disable spilling must not get one spill file per record)
        self.threshold = threshold if threshold >= 1 else float("inf")
        self.key = record_sort_key(contigs)
        self.records: List[VcfRecord] = []
        self.paths: List[str] = []
        self.count = 0

    def add(self, rec: VcfRecord):
        self.records.append(rec)
        self.count += 1
        if len(self.records) >= self.threshold:
            self._spill()

    def _spill(self):
        self.records.sort(key=self.key)
        path = f"{self.out_vcf}.spill{len(self.paths)}.tmp.vcf"
        write_vcf(path, self.records, sort=False)
        self.paths.append(path)
        self.records = []

    def finish(self) -> int:
        from ..io.vcf import merge_vcfs
        if not self.paths:
            write_vcf(self.out_vcf, self.records, contigs=self.contigs,
                      sort=True)
            return self.count
        if self.records:
            self._spill()
        try:
            merge_vcfs(self.paths, self.out_vcf, contigs=self.contigs)
        finally:
            self.cleanup()
        return self.count

    def cleanup(self):
        for p in self.paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.paths = []


def make_chunks(regions: Sequence[Tuple[str, int, int]],
                chunk_size: int = 200_000):
    """Split regions into worker-sized genome chunks."""
    from ..parallel.mesh import split_regions
    return split_regions(regions, chunk_size)


def call_parallel(bam_paths: Sequence[str], ref_path: str, scorer: Scorer,
                  out_vcf: str,
                  regions: Optional[Sequence[Tuple[str, int, int]]] = None,
                  num_workers: int = 4,
                  chunk_size: int = 200_000,
                  # hello_tpu's budgets: the first batch of each read-bucket
                  # class forms at max_alleles_per_batch, so scoring starts
                  # early and overlaps host production; once a class has
                  # flushed, its budget ramps to saturation_alleles.  Both
                  # ramp steps are a deterministic function of the per-class
                  # flush count, never of arrival timing, so batch shapes
                  # stay a function of the workload (buffer_sites's NOTE).
                  # Set them equal to disable the ramp.  Not yet tuned on the
                  # H100 (ROADMAP Queue 1 item 13).
                  max_alleles_per_batch: int = 1024,
                  saturation_alleles: int = 2048,
                  include_hp: bool = False,
                  stats: Optional[dict] = None,
                  pool: Optional[HostWorkerPool] = None,
                  class_by_read_bucket: bool = True,
                  # in-memory record bound: beyond this, sorted runs spill
                  # to disk and the final output is a streamed k-way merge
                  # (whole-genome RSS stays O(spill_records), not O(genome))
                  spill_records: int = 400_000,
                  **options) -> str:
    """Parallel genome calling into a sorted VCF.

    Worker processes produce SiteWork; the main process scores batches on the
    device as results stream in (device compute overlaps host production).

    ``pool``: a :class:`HostWorkerPool` to reuse (caller owns shutdown);
    without one, a transient pool of ``num_workers`` is created for the call.
    """
    ref = FastaFile(ref_path)
    if regions is None:
        regions = [(c, 0, ref.length(c)) for c in ref.chromosomes()]
    options = dict(options)
    options.setdefault("include_hp", include_hp)
    # Real Scorers take the coded wire end-to-end: workers ship CodedSiteWork
    # (1 byte/cell + row scalars), the main process packs wire dicts with no
    # dense intermediate, and the card rebuilds the tensors.
    # Duck-typed scorers (tests, oracles) get dense SiteWork + PaddedBatch.
    if getattr(scorer, "accepts_wire", False):
        options.setdefault("wire", "coded")
        # one consolidated IPC payload per chunk (CodedChunkBlock) instead
        # of thousands of per-site array pickles; expanded to the identical
        # CodedSiteWork views in the result loop below
        options.setdefault("chunk_block", True)

    jobs = list(make_chunks(regions, chunk_size))
    own_pool = pool is None
    if own_pool:
        pool = HostWorkerPool(num_workers)
    pool.new_run()     # discard any aborted previous run's leftovers
    for job in jobs:
        pool.submit(bam_paths, ref_path, options, job)

    ref_lookup = lambda chrom, pos: ref.fetch(chrom, pos, pos + 1)
    hybrid_model = scorer.model.hybrid
    contigs = {c: ref.length(c) for c in ref.chromosomes()}
    spiller = _RecordSpiller(out_vcf, contigs, threshold=spill_records)
    failures = []
    completed = 0

    # Pipelined scoring: the stager's threads pack and dispatch (the card
    # runs asynchronously), a background drainer (_AsyncDrainer) waits for
    # device results and runs genotype decode + record assembly — so the
    # card's latency overlaps host production AND dispatch instead of
    # serialising the loop.
    MAX_IN_FLIGHT = getattr(scorer, "max_in_flight", 3)
    _score_async = getattr(scorer, "score_async", None)
    if _score_async is not None and getattr(scorer, "device_decode", False):
        # genotype decode on the card after the forward: fetch winner
        # indices + probability (13 bytes/site) instead of logit tensors
        _dispatch = lambda b: _score_async(b, decode=True)
    elif _score_async is not None:
        _dispatch = _score_async
    else:
        _dispatch = scorer
    # stage accounting (seconds), reported through ``stats``.  MAIN-THREAD
    # stages (these bound the loop): wait = blocked on worker results
    # (host-stage bound), stage_backpressure = blocked on the full stager
    # queue (device/upload bound).  STAGER-THREAD stages (overlap the main
    # loop): pack = batch assembly, dispatch = pinned upload + the
    # forward's launches, backpressure = stager blocked on the drainer's
    # full in-flight window.  DRAINER-THREAD stages (overlap both):
    # drain/fetch/decode.  Off-main-thread stages only bound the wall clock
    # when the device or the upload is the true bottleneck.
    t_acc = {"wait_s": 0.0, "pack_s": 0.0, "dispatch_s": 0.0,
             "stage_backpressure_s": 0.0,
             "backpressure_s": 0.0, "drain_s": 0.0, "fetch_s": 0.0,
             "decode_s": 0.0}

    def _on_result(group, batch, fin):
        if isinstance(fin, dict) and "best_i" in fin:
            from ..nn.genotype import calls_from_device_decode
            calls = calls_from_device_decode(fin, batch.allele_site_index,
                                             group)
        else:
            experts, meta = fin
            calls = decode_batch(experts, meta, batch.allele_site_index,
                                 group, full=False)
        for call in calls:
            rec = vcf_record_from_call(call, ref_lookup)
            if rec is not None:
                spiller.add(rec)

    drainer = _AsyncDrainer(scorer, _on_result, t_acc, MAX_IN_FLIGHT)

    def pack_group(group):
        t0 = time.perf_counter()
        if isinstance(group[0], CodedSiteWork):
            from .compact import pack_sites_wire
            batch = pack_sites_wire(
                group, hybrid=hybrid_model,
                feature_length=options.get("feature_length", FEATURE_LENGTH))
        else:
            batch = pack_sites(group, hybrid=hybrid_model,
                               feature_length=options.get("feature_length",
                                                          FEATURE_LENGTH),
                               channels0=7 if include_hp else 6,
                               channels1=7 if include_hp else 6)
        t_acc["pack_s"] += time.perf_counter() - t0
        return (group, batch)

    def dispatch_group(item):
        group, batch = item
        t0 = time.perf_counter()
        out = _dispatch(batch)
        t_acc["dispatch_s"] += time.perf_counter() - t0
        drainer.put(group, batch, out)

    # batch packing and upload + dispatch run on their own pipelined
    # threads; the main loop only queues site groups
    stager = _AsyncStager(pack_group, t_acc, dispatch_fn=dispatch_group)

    # Sites are buffered ACROSS chunk results so the device sees full
    # max_alleles_per_batch batches: per-chunk site counts are small, and
    # dispatch latency (not FLOPs) dominates under-filled batches.
    # Buffers are keyed by read-bucket
    # class so a batch's padded read width matches its own sites' depth (one
    # deep site would otherwise inflate every site's conv rows); the VCF is
    # position-sorted at the end, so cross-class emission order is free.
    from .batching import site_read_bucket, site_row_counts
    pending: dict = {}            # read-bucket class -> [SiteWork]
    pending_alleles: dict = {}    # read-bucket class -> allele count
    pending_rows: dict = {}       # read-bucket class -> per-platform rows
    # per-class allele budget: first flush at max_alleles_per_batch (early
    # device overlap), then ramped to the saturation point (see the
    # saturation_alleles parameter note)
    saturation = max(saturation_alleles, max_alleles_per_batch)
    budgets: dict = {}
    # coded classes bound for the packed-row convolution also budget their
    # real read rows (batching.row_budgets_for_class); key[0] is the class's
    # coded-ness, key[1:] its per-platform read buckets
    from .call import row_budget_frac
    row_frac = row_budget_frac(scorer)

    def class_budget(key) -> int:
        return budgets.get(key, max_alleles_per_batch)

    def class_row_budgets(key):
        if not (row_frac and key[0] and len(key) > 1):
            return None
        from .batching import row_budgets_for_class
        return row_budgets_for_class(key[1:], class_budget(key), row_frac)

    def flush_class(key, keep_tail=True):
        groups = list(group_sites_for_batching(
            pending[key], class_budget(key),
            _row_budgets=class_row_budgets(key)))
        tail = groups.pop() if (keep_tail and groups) else None
        for group in groups:
            stager.put(group)
            budgets[key] = saturation
        if tail is not None and keep_tail:
            pending[key] = list(tail)
            pending_alleles[key] = sum(len(t.alleles) for t in tail)
            pending_rows[key] = [sum(r) for r in zip(
                *(site_row_counts(t) for t in tail))]
        else:
            pending[key] = []
            pending_alleles[key] = 0
            pending_rows[key] = None

    def buffer_sites(sites):
        """Accumulate sites per class; flush any class at its batch budget
        (allele count, or real read rows for packed-row coded classes).
        Coded and dense sites never share a batch (a chunk that fell back to
        dense must not poison a coded batch's packer)."""
        for s in sites:
            key = (isinstance(s, CodedSiteWork),) + (
                site_read_bucket(s) if class_by_read_bucket else (0,))
            pending.setdefault(key, []).append(s)
            pending_alleles[key] = pending_alleles.get(key, 0) + len(s.alleles)
            full = pending_alleles[key] >= class_budget(key)
            rb = class_row_budgets(key)
            if rb is not None:
                r = site_row_counts(s)
                acc = pending_rows.get(key)
                if acc is None:
                    acc = [0] * len(r)
                for i in range(len(r)):
                    acc[i] += r[i]
                pending_rows[key] = acc
                full = full or any(acc[i] >= rb[i] for i in range(len(r)))
            if full:
                flush_class(key)
        # NOTE: no opportunistic partial flushing here.  Flushing "when the
        # device looks idle" makes batch shapes a function of ARRIVAL
        # TIMING, and the records of a run would then depend on it (batch
        # composition changes accumulation order); hello_tpu, where each
        # new shape also compiles, found the same trap.  Shapes stay a
        # deterministic function of the workload; overlap comes from the
        # allele budget (smaller budget = more, earlier batches).

    body_ok = False
    try:
        _results = pool.results(len(jobs))
        while True:
            t0 = time.perf_counter()
            msg = next(_results, None)
            t_acc["wait_s"] += time.perf_counter() - t0
            if msg is None:
                break
            status, job, payload = msg
            if status == "error":
                failures.append((job, payload))
                logger.error("chunk %s failed: %s", job, payload)
                continue
            completed += 1
            if hasattr(payload, "to_sites"):   # CodedChunkBlock -> site views
                payload = payload.to_sites()
            if stats is not None:
                stats["sites"] = stats.get("sites", 0) + len(payload)
            buffer_sites(payload)
            if completed % 20 == 0:
                logger.info("completed %d/%d chunks (%d records)",
                            completed, len(jobs), spiller.count)
        # recovery = rerun failed shard (the reference's model): failed chunks
        # get one retry — a transient worker fault (OOM kill, IO hiccup)
        # should not abort a genome-scale run; a deterministic fault raises
        if failures:
            retry = [job for job, _ in failures]
            logger.warning("retrying %d failed chunk(s)", len(retry))
            failures = []
            for job in retry:
                pool.submit(bam_paths, ref_path, options, job)
            for status, job, payload in pool.results(len(retry)):
                if status == "error":
                    failures.append((job, payload))
                    continue
                if hasattr(payload, "to_sites"):
                    payload = payload.to_sites()
                if stats is not None:
                    stats["sites"] = stats.get("sites", 0) + len(payload)
                buffer_sites(payload)

        for key in sorted(pending):
            for group in group_sites_for_batching(pending[key],
                                                  class_budget(key)):
                stager.put(group)
        body_ok = True
    finally:
        # join stager first (it feeds the drainer), then the drainer
        # (records are only complete — and only safely readable — after it
        # returns); re-raises staging/consumer failures, except while an
        # earlier exception is already propagating (the root cause must not
        # be masked by a secondary failure)
        try:
            if body_ok:
                stage_exc = None
                try:
                    stager.close()
                except BaseException as exc:
                    stage_exc = exc       # still join the drainer below
                drainer.close()
                if stage_exc is not None:
                    raise stage_exc
            else:
                try:
                    stager.close(abort=True)
                except BaseException:
                    logger.exception("stager failed during abort")
                try:
                    drainer.close()
                except BaseException:
                    logger.exception("drainer failed during abort")
        except BaseException:
            # consumer failure surfaced by the success-path close: still
            # drop temp shards and the pool before propagating
            spiller.cleanup()
            if own_pool:
                pool.shutdown()
            raise
        if not body_ok:
            spiller.cleanup()          # drop temp spill shards on abort
            if own_pool:               # don't leak worker processes either
                pool.shutdown()
    if stats is not None:
        stats.update(t_acc)

    if own_pool:
        pool.shutdown()

    if failures:
        spiller.cleanup()
        raise RuntimeError(f"{len(failures)} chunks failed twice: "
                           f"{failures[:3]}")

    n_written = spiller.finish()
    logger.info("wrote %d records to %s", n_written, out_vcf)
    return out_vcf
