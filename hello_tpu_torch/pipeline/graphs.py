"""Captured CUDA graphs of the Scorer's forward, one per wire shape.

On the card, ``Scorer._forward`` (the wire's expansion, the MoE forward with
the read convolver kernel, the genotype decode) is some 600 to 1,500 small
kernels a batch, and enqueuing them one by one from Python takes longer than
the card takes to run them.  A batch's arrays come in few shapes
(``pack_sites_wire`` buckets every axis), so the forward of each shape is
captured once as a CUDA graph over static input buffers and replayed: each
later batch copies its upload into those buffers, and one launch runs the
same kernels on the same operands in the same order.

The policy, per position of the Scorer (``GraphCache.lookup``):

* a key's first batch runs eagerly: it warms cuDNN and cuBLAS for the shape,
  and a shape seen once (a tail batch) never pays for a capture;
* its second batch is captured (``GraphCache.capture``) and replayed;
* later batches replay;
* a new generation of the weights (``load_state_dict``, an optimiser step, a
  fold of new read convolvers) drops every graph of the position;
* at most ``MAX_GRAPHS`` graphs per position: once it holds that many, a
  shape without a graph runs eagerly, and no sighting is kept.  None is
  evicted, so a caller with more recurring shapes than the cap never
  captures one shape twice: past the cap a batch costs what the eager path
  costs.  The sightings, kept only while there is room, are of bucketed
  shapes, so few.

The key (``graph_key``) is the generation, the precision in force, whether
the forward decodes, whether the read convolver runs over packed rows, and
each array's name, shape and dtype.

A position's graphs share one memory pool: they replay on one stream, one at
a time, and each batch's outputs are copied to the host before the next
replay is enqueued, so one graph's scratch may reuse another's.

A capture keeps what the launch ledger (``telemetry.count``) gained over
it, ``Graph.counts``, which the Scorer counts again at each later replay.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from .. import telemetry

#: graphs each position holds; past them, new shapes run eagerly
MAX_GRAPHS = 16


def graph_key(arrays: Mapping, generation: int, precision: str,
              decode: bool, packed_conv: bool) -> tuple:
    """The cache key of one batch: what its captured forward depends on
    besides the values of its arrays."""
    return (generation, precision, bool(decode), bool(packed_conv),
            tuple(sorted((name, tuple(a.shape), str(a.dtype))
                         for name, a in arrays.items())))


class Graph:
    """One key's captured forward: its static input buffers (each batch's
    upload lands in them), the graph, its static outputs, and what the
    launch ledger gained over its capture.  Empty until
    ``GraphCache.capture``."""

    __slots__ = ("key", "inputs", "graph", "outputs", "counts")

    def __init__(self, key: tuple):
        self.key = key
        self.inputs: Dict[str, object] = {}
        self.graph = None
        self.outputs = None
        self.counts: Mapping[tuple, int] = {}


class GraphCache:
    """One position's graphs by key, the keys seen once, and its capture
    stream and memory pool."""

    def __init__(self):
        self.generation = None
        self.graphs: Dict[tuple, Graph] = {}
        self._seen: set = set()
        self.stream = None
        self.pool = None

    def lookup(self, key: tuple, generation: int) -> Optional[Graph]:
        """``key``'s captured graph, to replay; a new empty ``Graph`` at the
        key's second sighting, to capture (``capture`` keeps it); None at its
        first, or once ``MAX_GRAPHS`` are held, to run eagerly.  A new
        ``generation`` first drops every graph and sighting."""
        if generation != self.generation:
            self.graphs.clear()
            self._seen.clear()
            # a new pool: the old one goes with the graphs that held it
            self.pool = None
            self.generation = generation
        graph = self.graphs.get(key)
        if graph is not None:
            return graph
        if len(self.graphs) >= MAX_GRAPHS:
            self._seen.clear()
            return None
        if key in self._seen:
            self._seen.discard(key)
            return Graph(key)
        self._seen.add(key)
        return None

    def capture(self, graph: Graph, forward, device):
        """Capture ``forward()``, which reads ``graph.inputs`` (already
        filled with this batch's upload), on the position's capture stream
        into its pool, keep it, and replay it once on the current stream
        for this batch.

        The capture is begun and ended directly, not through
        ``torch.cuda.graph``, whose entry synchronizes the device and empties
        the caching allocators (each card's, with frees that wait for that
        card, and the pinned host cache): here a capture waits for no
        batch in flight on any card.  It records without running, so the
        capture stream needs no order against the current one, where the
        inputs' copies and the replays run.  Only ``thread_local`` mode lets
        another thread wait for earlier batches meanwhile."""
        import torch

        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = telemetry.counts()
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            cuda_graph.capture_begin(pool=self.pool,
                                     capture_error_mode="thread_local")
            try:
                outputs = forward()
            finally:
                cuda_graph.capture_end()
        graph.counts = telemetry.counts() - before
        graph.graph, graph.outputs = cuda_graph, outputs
        self.graphs[graph.key] = graph
        cuda_graph.replay()
