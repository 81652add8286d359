"""The training loop: ``train/cli.py``'s inner loop at its defaults.

What the training CLI runs on the card (``train_from_shards`` with its
defaults): batches of 64 alleles in 64-read buckets on the coded wire
(``train/loader.device_batches`` with the CLI's fixed shapes), staged on
the prefetch thread (``train/cli.prefetch_iter`` over
``Trainer.stage_batches``), ``Trainer.train_batch(sync=False)`` each step
and the previous step's loss read one step behind (``Trainer.
read_metrics``).  The window ends by reading its last step's loss.

Set-up makes the weights on the card from the seed, a pool of distinct
labelled batches (``generator.py``), builds one ``Trainer`` and drives it
through its first steps, the warm-up, on the pool's first batches through
the same feed and call as the window; the window takes that same trainer
and the pool's next batches.

``correct``: after the window, with the trainer freed, the plain reference
(``reference/model.py``: fp32, TF32 off, its own loss and AdamW) takes the
first ``CHECKED_STEPS`` steps from the same weights on the same batches,
derived from the generator's sites.  Compared: ``loss_gap``, the relative
gap of the first step's loss; ``grad_gap``, the worst leaf of the
first step's gradient as the optimizer got it (the port's Adam first
moment after one step, over 1 - beta1); ``change_gap``, the worst leaf of
the parameters' change over the checked steps.  Each leaf's gap of norms
is taken against the reference's norm of that leaf or of the median leaf,
whichever is larger; leaves whose reference gradient is under a thousandth
of the median leaf's move by rounding alone and are left out of the
change.
"""

from __future__ import annotations

import gc
import itertools
import os
import time

import numpy as np

from .. import check, flops, generator, weights
from ..reference import model as ref
from ..trace import HostProbe

CHECKED_STEPS = 3
#: the steps whose losses are compared (see ``gaps``)
LOSS_STEPS = 1


def make_pool(cfg, traffic, seed):
    """(stacked wire batches, batch primitives): each generator batch is
    one step's group of sites, packed as the CLI's loader packs it."""
    from hello_tpu_torch.train.loader import device_batches

    ranges = generator.read_ranges(cfg, traffic)
    prims = [generator.make_batch(seed, k, traffic["sites_per_batch"],
                                  traffic["alleles_per_site"], ranges,
                                  labels=True)
             for k in range(traffic["pool_batches"])]
    sites = [s for b in prims for s in generator.port_sites(b)]
    fixed = {"read_bucket": traffic["read_bucket"],
             "allele_bucket": traffic["batch_alleles"],
             "site_bucket": traffic["batch_alleles"] // 2}
    pool = list(device_batches(sites, len(ranges) > 1, 1,
                               traffic["batch_alleles"], fixed_shape=fixed,
                               wire=True))
    if len(pool) != len(prims) or any("codes0" not in b for b in pool):
        raise ValueError("the pool's batches did not pack one group each on "
                         "the wire")
    return pool, prims


def _norms(tensors):
    import torch
    return [float(x) for x in torch.stack([t.double().norm() for t in tensors])
            .cpu()]


def run(spec, seed, seconds, trace, device, spans, scratch):
    import torch

    from hello_tpu_torch.nn.layers import set_precision
    from hello_tpu_torch.nn.moe import create_model
    from hello_tpu_torch.train.cli import prefetch_iter
    from hello_tpu_torch.train.trainer import Trainer, TrainConfig

    cfg, traffic = spec["config"], spec["traffic"]
    t = traffic["train"]
    precision = cfg["precision"]["train"]
    set_precision(precision)
    net = ref.config(cfg["model"])
    init = weights.make_state_dict(ref.param_shapes(net), seed, device)
    trainer = Trainer(create_model(cfg["model"]),
                      TrainConfig(lr=t["lr"], optimizer=t["optimizer"],
                                  weight_decay=t["weight_decay"],
                                  entropy_regularizer=t["entropy_regularizer"],
                                  entropy_decay=t["entropy_decay"],
                                  grad_clip_norm=t["grad_clip_norm"],
                                  binary=net.get("meta") is None),
                      device=device, params=init)
    pool, prims = make_pool(cfg, traffic, seed)

    def stage(b):
        with spans("stage"):
            return trainer.stage_batches(b)

    feed = prefetch_iter(map(stage, itertools.cycle(pool)))
    on_card = device.type == "cuda"
    names = trainer.param_names
    # the warm-up: the checked steps, through the window's feed and call
    losses = []
    for step in range(CHECKED_STEPS):
        m = trainer.train_batch(next(feed), sync=False)
        losses.append(Trainer.read_metrics(m)[0])
        if step == 0:
            first_grad = dict(zip(names, _norms(
                [mu / (1 - trainer.opt.B1) for mu in trainer.opt.slots["mu"]])))
    change = dict(zip(names, _norms(
        [p.detach() - init[n] for n, p in zip(names, trainer.params)])))
    del init
    if on_card:
        torch.cuda.synchronize(device)

    spans.clear()
    steps, pending, finite = 0, None, True

    def one():
        """One step, and the previous step's loss read behind it."""
        nonlocal steps, pending, finite
        with spans("step"):
            m = trainer.train_batch(next(feed), sync=False)
        if pending is not None:
            finite &= bool(np.isfinite(Trainer.read_metrics(pending)[0]))
        pending = m
        steps += 1

    probe = HostProbe()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    try:
        while time.perf_counter() < t_end:
            one()
        finite &= bool(np.isfinite(Trainer.read_metrics(pending)[0]))
        window = time.perf_counter() - t_start
        host = probe.end()
        attempted = steps
        span_ms = {"stage": spans.mean_ms("stage")}
        trace_path = None
        if trace:
            # the profiler's window follows the measured one, so its cost
            # touches no number of the window
            from ..trace import Profiler
            with Profiler(os.path.join(scratch, "train_trace.json"),
                          wait=traffic["trace_wait"],
                          active=traffic["trace_active"],
                          cuda=on_card) as prof:
                for _ in range(traffic["trace_wait"] + 1
                               + traffic["trace_active"]):
                    one()
                    prof.step()
                finite &= bool(np.isfinite(Trainer.read_metrics(pending)[0]))
            trace_path = prof.export()
    finally:
        feed.close()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    b = prims[0]
    step_flops = flops.train_flops(
        net, [int(p["counts"].sum()) for p in b["platforms"]],
        len(b["allele_site"]), b["num_sites"])
    ctx = {"loop": "train", "span_ms": span_ms, "window_s": window,
           "precision": precision, "flops_done": attempted * step_flops,
           "trace_path": trace_path, "host": host}
    metrics = {"train_sites_per_s": (attempted * b["num_sites"] / window,
                                     "sites/s")}
    del trainer, feed, pool, m
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    prog = {"losses": losses, "grads": first_grad, "change": change}
    refr = reference_steps(cfg, traffic, prims, seed, device)
    return {"metrics": metrics, "attempted": attempted,
            "failed": 0 if finite else attempted, "memory_peak_bytes": peak,
            "readings": gaps(prog, refr), "ctx": ctx, "t_start": t_start,
            "sides": (prog, refr)}


def reference_steps(cfg, traffic, prims, seed, device, tf32=False,
                    half=False):
    """The plain reference's first ``CHECKED_STEPS`` steps: {"losses",
    "grads": {leaf: norm of the first step's clipped gradient}, "change":
    {leaf: norm of the parameters' change}}.  ``tf32`` computes them with
    TF32 on (the control); ``half`` plants the fault of a step that leaves
    half of each batch out."""
    import torch

    net = ref.config(cfg["model"])
    init = weights.make_state_dict(ref.param_shapes(net), seed, device)
    batches = [generator.reference_inputs(b, device)
               for b in prims[:CHECKED_STEPS]]
    with ref.tf32(tf32):
        out = ref.train_steps(net, init, batches, traffic["train"], half=half)
    names = sorted(init)
    result = {"losses": out["losses"],
              "grads": dict(zip(names, _norms([out["grads"][n]
                                               for n in names]))),
              "change": dict(zip(names, _norms([out["params"][n] - init[n]
                                                for n in names])))}
    del out, init, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return result


def gaps(prog, refr):
    """The numbers compared of one side against the reference:
    ``loss_gap``, the widest relative gap of the first ``LOSS_STEPS``
    steps' losses; ``grad_gap``; ``change_gap``.  Also, not compared:
    ``loss_gap_later``, the later checked steps' (Adam's first steps move
    every parameter by about the learning rate whatever its gradient's
    size, so where a gradient is rounding-small its sign is noise, and the
    losses of the steps after such updates move with it)."""
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                               refr["losses"])]
    med = float(np.median(list(refr["grads"].values())))
    moved = [n for n, g in refr["grads"].items() if g >= 1e-3 * med]
    return {"loss_gap": max(rel[:LOSS_STEPS]),
            "grad_gap": check.leaf_gap(prog["grads"], refr["grads"]),
            "change_gap": check.leaf_gap(prog["change"], refr["change"],
                                         keep=moved),
            "loss_gap_later": max(rel[LOSS_STEPS:])}
