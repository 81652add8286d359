"""Data-parallel trainer: the train-mode forward under autograd, the losses
of train/loss.py and optax's update rules, written out.

The port of hello_tpu's train/trainer.py.  hello_tpu runs one jitted step
over a ``data`` mesh: each device takes one sub-batch of the stacked batch's
leading axis, and ``psum`` sums the loss, the per-expert losses and the
gradients before the optimizer sees them.  Here a stacked batch's leading
axis holds ``num_devices`` sub-batches that run on this process's device in
order (the model's train-mode forward, cuDNN on the card, then
``torch.autograd.grad``), their losses and gradients summed in fp32; across
processes (one per card, ``parallel/mesh.init_distributed``) one
``all_reduce(SUM)`` of a single flat fp32 buffer adds the other ranks' sums,
and ``Optimizer.update`` follows.  The sum, not the mean: optax's clip and
Adam's eps are not scale-free, so ``DistributedDataParallel``'s mean would
train another model (and its hooks need ``.backward()``, which the trainer
does not call).  Nothing waits on the host unless the caller asks for the
loss.  Batches are dense or coded-wire (expanded on the device, labels
carried through).

Batch-norm statistics (the model's floating buffers) follow hello_tpu's
``pmean``: every sub-batch's forward starts from the step's old statistics,
and the step's new statistics are the mean of the sub-batches' (over the
ranks too, through the same all-reduce), so neither the order of the
sub-batches nor ``remat``'s second forward moves them.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import pickle
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from .. import telemetry
from ..nn import layers as L
from ..nn.convert import init_params, jax_params_from_state_dict, state_dict_from_jax
from ..nn.moe import MoEAttention
from ..parallel import mesh
from ..pipeline.call import resolve_device
from . import loss as losses
from .checkpoint import load_full_checkpoint, save_checkpoint
from .schedule import cosine_warm_restarts, entropy_decay, sine_warmup_restarts

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-3
    min_lr: float = 0.0
    optimizer: str = "Adam"          # Adam | SGD | SGDR (SGD + cosine restarts)
    momentum: float = 0.9
    weight_decay: float = 1e-4
    t0: int = 10
    t_mult: int = 2
    warmup: bool = False
    steps_per_epoch: int = 1
    entropy_regularizer: float = 0.1
    entropy_decay: float = 0.5
    smoothing: float = 0.0
    aux_weight: float = 0.0
    class_weights: Tuple[float, float] = (1.0, 1.0)
    binary: bool = False             # BCE loss for no-ensemble models
    grad_clip_norm: float = 10.0     # 0 disables global-norm clipping
    # recompute the forward in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint at the whole-loss boundary)
    remat: bool = False


def make_schedule(config: TrainConfig):
    """The learning rate as a function of the update count (SGDR, sine
    warmup, or constant)."""
    if config.optimizer == "SGDR":
        return cosine_warm_restarts(config.lr, config.t0, config.t_mult,
                                    config.min_lr, config.steps_per_epoch)
    if config.warmup:
        return sine_warmup_restarts(config.lr, config.t0, config.t_mult,
                                    config.min_lr, config.steps_per_epoch)
    return lambda count: config.lr


def _f32(x: float) -> float:
    """x rounded to float32, as jnp computes optax's scalars."""
    return float(np.float32(x))


class Optimizer:
    """optax's ``make_optimizer`` chain over a list of parameters.

    * ``clip_by_global_norm(max_norm)`` first: ``g`` when ``||g|| <
      max_norm``, else ``g / ||g|| * max_norm`` (no epsilon);
    * ``Adam``: ``adamw`` — ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2
      + b2 nu``, bias-corrected at the incremented count, ``mu_hat /
      (sqrt(nu_hat) + eps)`` with eps outside the root, plus ``wd * p`` on
      every parameter (biases included), times ``-lr``;
    * ``SGD`` / ``SGDR``: ``g + wd * p``, then the momentum trace ``t = g +
      m t`` (starting at zero), times ``-lr``;
    * the learning rate is the schedule at the update count before its
      increment, so the first update uses ``schedule(0)``.

    Every update is foreach arithmetic on the parameters' device, with no
    host wait."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, config: TrainConfig, params: List[torch.Tensor]):
        self.config = config
        self.params = params
        self.kind = "adamw" if config.optimizer == "Adam" else "sgd"
        self.schedule = make_schedule(config)
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in params]
        self.slots = ({"mu": zeros(), "nu": zeros()} if self.kind == "adamw"
                      else {"trace": zeros()})

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]):
        cfg, params = self.config, self.params
        g = list(grads)
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            keep = norm < cfg.grad_clip_norm
            # (g / denom) * mult is g itself below the norm, else optax's
            # (g / norm) * max_norm
            g = torch._foreach_div(g, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(g, torch.where(keep, 1.0, float(cfg.grad_clip_norm)))
        lr = _f32(self.schedule(self.count))
        if self.kind == "adamw":
            mu, nu = self.slots["mu"], self.slots["nu"]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.B1))
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1 - self.B2)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_add_(nu, sq)
            count = self.count + 1
            bc1 = _f32(1 - np.float32(self.B1) ** np.float32(count))
            bc2 = _f32(1 - np.float32(self.B2) ** np.float32(count))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.EPS)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(params, cfg.weight_decay))
        else:
            g = torch._foreach_add(g, torch._foreach_mul(params, cfg.weight_decay))
            upd = self.slots["trace"]
            torch._foreach_mul_(upd, cfg.momentum)
            torch._foreach_add_(upd, g)
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
        self.count += 1

    def state_dict(self, names: List[str]) -> dict:
        """Plain dict of numpy arrays keyed by parameter name (no torch
        object, so the checkpoint pickle stays framework-neutral)."""
        out = {"kind": self.kind, "count": self.count}
        for slot, ts in self.slots.items():
            out[slot] = {n: t.detach().cpu().numpy() for n, t in zip(names, ts)}
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict, names: List[str]):
        if not (isinstance(state, dict) and state.get("kind") == self.kind):
            raise ValueError(
                "the checkpoint's optimizer state was not written by this "
                f"package's {self.kind!r} optimizer (a hello_tpu checkpoint "
                "carries optax state): load its params with load_scorer, or "
                "train from them without resuming")
        for slot, ts in self.slots.items():
            for n, t in zip(names, ts):
                t.copy_(torch.from_numpy(np.asarray(state[slot][n])))
        self.count = int(state["count"])


def _ensure_dense(batch):
    """Expand coded-wire training batches (pipeline/compact.py) on the
    device, carrying the labels through; a no-op for dense batches."""
    if "codes0" not in batch and "packed0" not in batch:
        return batch
    from ..pipeline.compact import expand_compact
    dense = dict(expand_compact({k: v for k, v in batch.items()
                                 if k != "labels"}))
    if "labels" in batch:
        dense["labels"] = batch["labels"]
    return dense


def _batch_loss(model: MoEAttention, config: TrainConfig, batch, reg_coeff):
    """(total loss, per-expert loss) of one batch: the binary loss for a
    model with no meta-expert (or ``binary``), the MoE loss otherwise."""
    batch = _ensure_dense(batch)
    out = model(batch)
    experts = out["experts"]
    if out["meta"] is None or config.binary:
        total = losses.binary_loss(experts, batch["labels"],
                                   batch["allele_mask"])
        return total, torch.zeros((1,), dtype=torch.float32,
                                  device=experts.device)
    total, per_expert, _post = losses.moe_loss(
        experts, out["meta"], batch["labels"], batch["site_ids"],
        batch["allele_mask"], regularizer=reg_coeff,
        smoothing=config.smoothing, aux_weight=config.aux_weight,
        class_weights=config.class_weights, train=True)
    return total, per_expert


def _to_numpy(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in tree.items()}


class Trainer:
    """Data-parallel trainer with hello_tpu's interface.

    ``device_batches`` are dicts with a leading axis of ``num_devices``
    sub-batches (numpy, or tensors staged by ``stage_batches``): hello_tpu's
    step on a ``num_devices``-device mesh, run on this process's device.
    Inside a process group (``parallel/mesh.init_distributed``) every rank's
    parameters start as rank 0's and each step's sums are summed over the
    ranks.  ``params`` optionally gives the initial weights as a state dict;
    otherwise they are the seeded init of nn/convert.init_params.  Training
    runs at the precision in force (nn/layers.PRECISION; hello_tpu trains at
    ``highest``), whose cuBLAS and cuDNN TF32 switches are applied here."""

    def __init__(self, model: MoEAttention, config: TrainConfig, device=None,
                 params=None, seed: int = 13, num_devices: int = 1):
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        self.device = resolve_device(device)
        L.set_precision(L.PRECISION)
        if params is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).train()
        self.num_devices = num_devices
        self.config = config
        named = list(self.model.named_parameters())
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        # the running batch-norm statistics (num_batches_tracked, an update
        # count no step's math reads, is left to the forward)
        self.stats = [b for b in self.model.buffers() if b.is_floating_point()]
        self._broadcast_params()
        self.opt = Optimizer(config, self.params)
        self.step = 0
        self.resume_extra = {}
        self._reg = entropy_decay(config.entropy_regularizer,
                                  config.entropy_decay)
        self._stage_stream = None
        # the newest sync=False step's end event (the card's idle before
        # the next step), and first events that are free again
        self._last_end = None
        self._free_events = []

    # -- batches ------------------------------------------------------------

    def stage_batches(self, device_batches):
        """Blocking host-to-device staging of a stacked batch: pinned host
        buffers and copies on a side stream, waited for here.  Called from
        the prefetch thread (train/cli.prefetch_iter), so the upload of the
        next batch overlaps the step in flight."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in device_batches.items()}
        if self._stage_stream is None:
            self._stage_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stage_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in device_batches.items()}
        self._stage_stream.synchronize()
        return out

    def _sub_batches(self, device_batches, expect=None) -> List[dict]:
        """The stacked batch's sub-batches (its leading axis), on the
        device; raises when ``expect`` is given and the axis differs."""
        sizes = {len(v) for v in device_batches.values()}
        if len(sizes) != 1:
            raise ValueError(f"stacked batch's leading axes differ: {sizes}")
        n = sizes.pop()
        if expect is not None and n != expect:
            raise ValueError(
                f"stacked batch holds {n} sub-batches on its leading axis; "
                f"this trainer takes num_devices={expect}")
        out = [{} for _ in range(n)]
        for k, v in device_batches.items():
            if isinstance(v, torch.Tensor):
                if v.device.type == "cuda":
                    # staged on the side stream: keep its memory from being
                    # reused before this step's kernels have read it
                    v.record_stream(torch.cuda.current_stream(v.device))
                for i in range(n):
                    out[i][k] = v[i]
                continue
            for i in range(n):
                t = torch.from_numpy(np.ascontiguousarray(v[i]))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[i][k] = t
        return out

    # -- steps ----------------------------------------------------------------

    def _one_loss_and_grads(self, batch, reg):
        """(loss, per-expert loss, gradients, the batch-norm statistics the
        forward left) of one sub-batch; the statistics are read before the
        backward, which recomputes the forward under ``remat``."""
        with telemetry.stage("trainer.forward", key=self.step):
            if self.config.remat:
                total, per_expert = torch.utils.checkpoint.checkpoint(
                    _batch_loss, self.model, self.config, batch, reg,
                    use_reentrant=False)
            else:
                total, per_expert = _batch_loss(self.model, self.config,
                                                batch, reg)
        stats = [b.clone() for b in self.stats]
        with telemetry.stage("trainer.backward", key=self.step):
            grads = torch.autograd.grad(total, self.params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        return total.detach(), per_expert.detach(), grads, stats

    @torch.no_grad()
    def _set_stats(self, values):
        for b, v in zip(self.stats, values):
            b.copy_(v)

    def _loss_and_grads(self, device_batches, reg):
        """hello_tpu's psum'd step: the loss, per-expert losses and
        gradients of each sub-batch summed in order, then over the ranks;
        and its pmean'd state: the batch-norm statistics of each sub-batch,
        every one from the step's old statistics, averaged over the
        sub-batches and the ranks.  Leaves the model's statistics as they
        were; returns (loss, per-expert loss, gradients, new statistics)."""
        old = [b.clone() for b in self.stats]
        total = per_expert = grads = stats = None
        n = 0
        for batch in self._sub_batches(device_batches, self.num_devices):
            self._set_stats(old)
            t, pe, g, st = self._one_loss_and_grads(batch, reg)
            n += 1
            if grads is None:
                total, per_expert, grads, stats = t, pe, g, st
            else:
                total, per_expert = total + t, per_expert + pe
                torch._foreach_add_(grads, g)
                stats = [a + b for a, b in zip(stats, st)]
        self._set_stats(old)
        if mesh.is_distributed():
            with telemetry.stage("trainer.allreduce", key=self.step):
                summed = self._all_reduce([total.reshape(1), per_expert]
                                          + grads + stats)
            total, per_expert = summed[0][0], summed[1]
            grads = summed[2:2 + len(grads)]
            stats = summed[2 + len(grads):]
            n *= mesh.world_size()
        return total, per_expert, grads, [t / n for t in stats]

    @staticmethod
    def _all_reduce(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the process group, through ONE
        ``all_reduce`` of a flat fp32 buffer (views into it come back)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        return [part.view_as(t) for part, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)]

    @torch.no_grad()
    def _broadcast_params(self):
        """Inside a process group, every rank takes rank 0's parameters and
        batch-norm statistics."""
        if not mesh.is_distributed():
            return
        tensors = self.params + self.stats
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))

    def all_ranks_have(self, flag: bool) -> bool:
        """True iff every rank reports ``flag`` (parallel/mesh.all_ranks_have):
        the per-batch barrier of a multi-process epoch."""
        return mesh.all_ranks_have(flag)

    def compute_grads(self, device_batches):
        """Summed loss and gradients ({state-dict name: tensor}) without an
        optimizer update: the sub-batches', then the ranks'."""
        total, _, grads, _ = self._loss_and_grads(device_batches,
                                                  self._reg(self.step))
        return float(total), dict(zip(self.param_names, grads))

    def unsharded_step_reference(self, device_batches):
        """The semantics the summed step must reproduce, serially: each
        sub-batch's loss and gradients in a loop, summed, on this process
        alone.  Leaves the trainer as it was.

        Returns ``(total loss, grads, leaf scales)`` keyed by state-dict
        name; a leaf's scale is its largest per-sub-batch |gradient|, the
        right normaliser for comparing sums that may cancel to near zero
        while each term is O(scale)."""
        reg = self._reg(self.step)
        total, grads, scales = 0.0, None, None
        old = [b.clone() for b in self.stats]
        for batch in self._sub_batches(device_batches):
            self._set_stats(old)
            t, _, g, _ = self._one_loss_and_grads(batch, reg)
            total += float(t)
            gmax = [x.abs().max() for x in g]
            if grads is None:
                grads, scales = g, gmax
            else:
                grads = [a + b for a, b in zip(grads, g)]
                scales = [torch.maximum(a, b) for a, b in zip(scales, gmax)]
        self._set_stats(old)
        return (total, dict(zip(self.param_names, grads)),
                {n: float(s) for n, s in zip(self.param_names, scales)})

    def train_batch(self, device_batches, crash_dump_prefix: str = None,
                    sync: bool = True) -> Dict[str, float]:
        """One optimisation step.

        With ``sync`` the loss is read before the update; a non-finite loss
        dumps the parameters and optimizer state before the step and the
        batch (``<prefix>.step<n>.err.ckpt`` / ``.payload.pkl``) and raises.
        ``sync=False`` waits for nothing: it returns the loss on the device,
        and on the card pinned host copies of it with the event that marks
        them written (read them with ``read_metrics``); the caller owns the
        finite check.

        Spans (``telemetry.stage``, keyed by the step): ``trainer.step``
        over the call, ``trainer.forward``, ``trainer.backward``,
        ``trainer.update`` and, in a process group, ``trainer.allreduce``.
        With ``sync=False`` on the card a timed event marks the step's
        start, from which ``read_metrics`` records the card's idle before
        the step (``trainer.card_wait``)."""
        key = self.step
        with telemetry.stage("trainer.step", key=key) as t0:
            return self._train_batch(device_batches, crash_dump_prefix, sync,
                                     key, t0)

    def _train_batch(self, device_batches, crash_dump_prefix, sync, key, t0):
        before, self._last_end = self._last_end, None
        started = None
        if not sync and self.device.type == "cuda":
            started = telemetry.timed_event(self._free_events)
            started.record(torch.cuda.current_stream(self.device))
        total, per_expert, grads, stats = self._loss_and_grads(
            device_batches, self._reg(self.step))
        if sync:
            loss = float(total)
            if not math.isfinite(loss):
                self.step += 1
                prefix = crash_dump_prefix or "hello_tpu_torch_crash"
                self.save(f"{prefix}.step{self.step}.err.ckpt")
                with open(f"{prefix}.step{self.step}.payload.pkl", "wb") as fh:
                    pickle.dump(_to_numpy(device_batches), fh)
                raise FloatingPointError(
                    f"non-finite training loss at step {self.step}; params "
                    f"and payload dumped to {prefix}.step{self.step}.*")
        with telemetry.stage("trainer.update", key=key):
            self.opt.update(grads)
        self._set_stats(stats)
        self.step += 1
        if sync:
            return {"loss": loss, "per_expert": per_expert.cpu().tolist()}
        out = {"loss_device": total, "per_expert_device": per_expert}
        if started is not None:
            host = torch.empty(1 + per_expert.numel(), pin_memory=True)
            host.copy_(torch.cat([total.reshape(1), per_expert]),
                       non_blocking=True)
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            out.update(host=host, event=event,
                       card_wait=(before, started, t0, key,
                                  self._free_events))
            self._last_end = event
        return out

    @staticmethod
    def read_metrics(m) -> Tuple[float, list]:
        """(loss, per-expert loss) of a ``train_batch(sync=False)`` result,
        waiting only for that step."""
        if "event" in m:
            m["event"].synchronize()
            wait = m.pop("card_wait", None)
            if wait is not None:
                telemetry.record_card_wait("trainer.card_wait", wait)
            vals = m["host"].tolist()
            return vals[0], vals[1:]
        return float(m["loss_device"]), m["per_expert_device"].cpu().tolist()

    def evaluate(self, batches: Iterable[dict]) -> float:
        """Mean validation loss over single-device batches (numpy dicts),
        through the eval forward: the read convolvers in
        ``read_conv_reduce`` with this step's folded weights (or the layer
        route), batch norm with the running statistics."""
        total, count = 0.0, 0
        self.model.eval()
        try:
            with torch.no_grad():
                folded = self.model.fold_read_convs()
                for batch in batches:
                    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                             .to(self.device) for k, v in batch.items()}
                    batch = _ensure_dense(batch)
                    out = self.model(batch, folded=folded)
                    if out["meta"] is None:
                        val = losses.binary_loss(out["experts"], batch["labels"],
                                                 batch["allele_mask"])
                    else:
                        val, _, _ = losses.moe_loss(
                            out["experts"], out["meta"], batch["labels"],
                            batch["site_ids"], batch["allele_mask"], train=False)
                    total += float(val)
                    count += 1
        finally:
            self.model.train()
        return total / max(count, 1)

    # -- checkpoints --------------------------------------------------------

    def save(self, path: str, extra=None):
        params, state = jax_params_from_state_dict(self.model)
        save_checkpoint(path, params, state,
                        self.opt.state_dict(self.param_names), self.step,
                        extra)

    def restore(self, path: str):
        """Resume the full training state (params, batch-norm statistics,
        optimizer moments, step counter) from a checkpoint; its ``extra``
        dict (the data-order position: epoch, batches_done, seed) is kept
        on ``self.resume_extra`` for the training loop.  Every rank reads
        the checkpoint; the parameters are then rank 0's."""
        payload = load_full_checkpoint(path)
        sd = state_dict_from_jax(self.model, payload["params"],
                                 payload["state"] or {})
        with torch.no_grad():
            self.model.load_state_dict(sd, strict=True)
        self._broadcast_params()
        if payload.get("opt_state") is not None:
            self.opt.load_state_dict(payload["opt_state"], self.param_names)
        self.step = int(payload.get("step", 0))
        self.resume_extra = dict(payload.get("extra") or {})
        return self
