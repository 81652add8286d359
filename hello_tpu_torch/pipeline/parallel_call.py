"""Asynchronous result draining for the calling loop.

This slice ports only what ``call_region`` needs from hello_tpu's
pipeline/parallel_call.py: ``_out_ready`` and ``_AsyncDrainer``.  The
worker-pool caller ``call_parallel`` waits for a later slice (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


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
