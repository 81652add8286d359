"""Entry points of the port's smoke checks: a flagship forward step, and the
multi-device dry run.

The counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``.  ``entry()`` returns a forward step of the flagship
(full hybrid MoE) model with example padded-batch arguments.
``dryrun_multichip(n)`` runs hello_tpu's n-device data-parallel step as n
sub-batches on one device and holds it to its serial reference, then drives
the Scorer's round robin over the visible cards (on the CPU, the CPU n
times) and the coded-wire paths against the dense one.
"""

from __future__ import annotations

import logging
from collections import deque

import numpy as np
import torch

from .nn.convert import init_params
from .nn.moe import create_model
from .pipeline.call import Scorer, resolve_device, visible_devices

logger = logging.getLogger(__name__)


def _example_batch(rng, hybrid=True, A=8, R=4, S=4, L=150, C=6, labels=False):
    batch = {
        "reads0": rng.randint(0, 255, size=(A, R, L, C)).astype(np.uint8),
        "read_mask0": (rng.rand(A, R) < 0.7).astype(np.float32),
        "site_ids": np.minimum(np.arange(A, dtype=np.int32) // 2, S - 1),
        "allele_mask": np.ones((A,), np.float32),
        "ref_segments": np.eye(5, dtype=np.float32)[
            rng.randint(0, 5, size=(S, L))],
    }
    # guarantee at least one real read per allele slot
    batch["read_mask0"][:, 0] = 1.0
    if hybrid:
        batch["reads1"] = rng.randint(0, 255, size=(A, R, L, C)).astype(np.uint8)
        batch["read_mask1"] = (rng.rand(A, R) < 0.7).astype(np.float32)
        batch["read_mask1"][:, 0] = 1.0
    if labels:
        batch["labels"] = (rng.rand(A) < 0.5).astype(np.float32)
    return batch


def _palette_site_work(rng, idx, alleles=2, reads=6, L=150, C=6):
    """A SiteWork whose tensors satisfy every featurizer invariant the compact
    wire format relies on (palette colors, per-row constants, presence via
    the strand channel, region-marker/ref channels consistent with the site
    bounds and segment) — so compact(pack(sites)) reconstructs byte-exactly
    and a compact Scorer must match a dense one bit-for-bit."""
    from .pipeline.batching import SiteWork
    from .pipeline.compact import (BASE_PALETTE, QUAL_PALETTE,
                                   REF_COLOR_PALETTE)

    start = 1000 + 60 * idx
    stop = start + 3
    mid = (start + stop) // 2
    fstart = mid - L // 2
    seg_idx = rng.randint(0, 5, size=L)
    seg = np.eye(5, dtype=np.float32)[seg_idx]
    ref_colors = np.asarray(REF_COLOR_PALETTE, np.uint8)[seg_idx]   # [L]
    pos = np.arange(L) + fstart
    pos_colors = np.where((pos >= start) & (pos < stop), 240, 70).astype(np.uint8)

    def _platform_tensors():
        out = []
        for _ in range(alleles):
            t = np.zeros((reads, L, C), np.uint8)
            for r in range(reads):
                a = rng.randint(0, L // 2)
                b = rng.randint(a + 10, L)
                t[r, a:b, 0] = BASE_PALETTE[rng.randint(0, 5, size=b - a)]
                t[r, a:b, 1] = ref_colors[a:b]
                t[r, a:b, 2] = QUAL_PALETTE[rng.randint(0, 41, size=b - a)]
                t[r, a:b, 3] = rng.randint(1, 255)          # mapq color
                t[r, a:b, 4] = 70 if rng.rand() < 0.5 else 240
                t[r, a:b, 5] = pos_colors[a:b]
            out.append(t)
        return out

    return SiteWork("chrD", start, stop, [f"a{idx}_{i}" for i in range(alleles)],
                    _platform_tensors(), _platform_tensors(), seg)


def entry(device=None):
    """(fn, example_args) for a forward step of the flagship model: ``fn(
    model, batch)`` gives (expert logits, meta) of the eval forward, the
    read convolvers in ``read_conv_reduce``; ``model`` is the full hybrid
    MoE with seed-0 weights on ``device`` (default the card) and ``batch``
    a seeded example padded batch there."""
    device = resolve_device(device)
    model = init_params(create_model("hybrid"),
                        torch.Generator().manual_seed(0)).to(device).eval()
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             _example_batch(np.random.RandomState(0), hybrid=True).items()}

    def forward(model, batch):
        with torch.no_grad():
            out = model(batch, folded=model.fold_read_convs())
        return out["experts"], out["meta"]

    return forward, (model, batch)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """hello_tpu's n-device dry run on this process's device (default the
    card): returns its readings, raises when a check fails.

    * the n-sub-batch step's loss within rtol 1e-5 of the serial
      reference's, each gradient leaf within 5e-3 x n x its scale (the
      largest per-sub-batch |gradient|: the sum may cancel to near zero
      while each term is O(scale)), then two finite Adam steps;
    * the Scorer round-robins over the visible cards (on the CPU, the CPU n
      times): equal logits on every position, every position's replica
      built, and under pipelined dispatch every position holding work at
      once with at least two dispatches each;
    * the coded wire scored as the dense batch it encodes (equal on the
      CPU; on the card within rtol 1e-5 / atol 1e-6, the order of the
      kernel's atomic per-allele sums: 4.8e-7 measured on an H100), the
      packed-row path within rtol 1e-4 / atol 1e-5;
    * coded-wire training batches give the dense batches' loss, rtol 1e-5."""
    from .pipeline.batching import (PaddedBatch, pack_sites,
                                    stack_device_batches, training_dict)
    from .pipeline.compact import (compact_batch, encode_chunk_sites,
                                   pack_sites_wire, stack_wire_batches,
                                   training_wire_dict)
    from .train.trainer import TrainConfig, Trainer

    device = resolve_device(device)
    trainer = Trainer(create_model("hybrid"),
                      TrainConfig(lr=1e-3, optimizer="Adam",
                                  entropy_regularizer=0.1),
                      device=device, num_devices=n_devices)
    rng = np.random.RandomState(0)
    stacked = stack_device_batches(
        [_example_batch(rng, hybrid=True, A=8, R=2, S=4, labels=True)
         for _ in range(n_devices)])
    ref_loss, ref_grads, ref_scales = trainer.unsharded_step_reference(stacked)
    got_loss, got_grads = trainer.compute_grads(stacked)
    if not np.isclose(got_loss, ref_loss, rtol=1e-5, atol=0):
        raise AssertionError(f"summed loss {got_loss} != serial {ref_loss}")
    worst = 0.0
    for name, g in got_grads.items():
        scale = max(ref_scales[name] * n_devices, 1e-6)
        diff = float((g - ref_grads[name]).abs().max())
        if diff > 5e-3 * scale:
            raise AssertionError(f"gradient mismatch at {name}: max|diff| "
                                 f"{diff:.3e} vs leaf scale {scale:.3e}")
        worst = max(worst, diff / scale)
    steps = [trainer.train_batch(stacked)["loss"] for _ in range(2)]
    if not all(np.isfinite(steps)):
        raise AssertionError(f"non-finite losses {steps}")

    # scoring: a copy of the trained weights (a Scorer puts its model in
    # eval mode, the trainer's must stay in train mode)
    model = create_model("hybrid")
    model.load_state_dict(trainer.model.state_dict())
    devices = ([device] * n_devices if device.type == "cpu"
               else visible_devices())
    scorer = Scorer(model, devices=devices, compact=False)
    b = _example_batch(np.random.RandomState(7), hybrid=True)
    pb = PaddedBatch(
        reads0=b["reads0"], read_mask0=b["read_mask0"],
        reads1=b["reads1"], read_mask1=b["read_mask1"],
        site_ids=b["site_ids"], allele_mask=b["allele_mask"],
        ref_segments=b["ref_segments"], num_sites=4, sites=[],
        allele_site_index=[])
    outs = [scorer(pb)[0] for _ in devices]
    if any(f is None for f in scorer.replica_folds()):
        raise AssertionError("round robin incomplete")
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5,
                                   err_msg="per-device scoring differs")
    # the pipelined dispatch of the callers (score_async ahead, finalize
    # behind) must put work on every position at once
    scorer.dispatch_counts.clear()
    scorer.peak_concurrent_devices = 0
    in_flight = deque()
    for _ in range(2 * len(devices)):
        in_flight.append(scorer.score_async(pb))
        while len(in_flight) >= scorer.max_in_flight:
            scorer.finalize(in_flight.popleft())
    while in_flight:
        scorer.finalize(in_flight.popleft())
    counts = dict(sorted(scorer.dispatch_counts.items()))
    if len(counts) != len(devices) or min(counts.values()) < 2:
        raise AssertionError(f"unbalanced round robin: {counts}")
    if scorer.peak_concurrent_devices != len(devices):
        raise AssertionError(
            f"devices held work serially: peak concurrent "
            f"{scorer.peak_concurrent_devices}/{len(devices)}")
    logger.info("multichip scorer accounting: peak_concurrent_devices=%d/%d "
                "dispatches_per_device=%s", scorer.peak_concurrent_devices,
                len(devices), list(counts.values()))

    # the coded wire against the dense batch it encodes
    rng2 = np.random.RandomState(11)
    pbatch = pack_sites([_palette_site_work(rng2, i) for i in range(4)],
                        hybrid=True)
    wire = compact_batch(pbatch)
    if "codes0" not in wire or "codes1" not in wire:
        raise AssertionError("palette batch did not take the coded wire path")
    e_dense, m_dense = scorer(pbatch)
    rtol, atol = (0.0, 0.0) if device.type == "cpu" else (1e-5, 1e-6)
    coded = Scorer(model, devices=devices, compact=True, packed_conv=False)
    packed = Scorer(model, devices=devices, compact=True, packed_conv=True)
    coded_err = packed_err = 0.0
    for _ in devices:
        e_c, m_c = coded(pbatch)
        np.testing.assert_allclose(e_c, e_dense, rtol=rtol, atol=atol,
                                   err_msg="compact scoring differs from dense")
        np.testing.assert_allclose(m_c, m_dense, rtol=rtol, atol=atol)
        e_p, m_p = packed(pbatch)
        np.testing.assert_allclose(e_p, e_dense, rtol=1e-4, atol=1e-5,
                                   err_msg="packed-row scoring differs from "
                                           "dense")
        np.testing.assert_allclose(m_p, m_dense, rtol=1e-4, atol=1e-5)
        coded_err = max(coded_err, float(np.abs(e_c - e_dense).max()))
        packed_err = max(packed_err, float(np.abs(e_p - e_dense).max()))

    # coded-wire training batches against the dense batches they encode
    rng3 = np.random.RandomState(23)
    per_dev_sites = []
    for d in range(n_devices):
        sites = [_palette_site_work(rng3, 10 * d + i) for i in range(4)]
        for i, s in enumerate(sites):
            s.labels = [(i + j) % 2 for j in range(len(s.alleles))]
        per_dev_sites.append(sites)
    dense_stack = stack_device_batches(
        [training_dict(pack_sites(s, hybrid=True)) for s in per_dev_sites])
    codes = [encode_chunk_sites(s) for s in per_dev_sites]
    if any(c is None for c in codes):
        raise AssertionError("palette sites must code")
    wire_stack = stack_wire_batches(
        [training_wire_dict(pack_sites_wire(c, hybrid=True)) for c in codes])
    loss_dense, _ = trainer.compute_grads(dense_stack)
    loss_wire, _ = trainer.compute_grads(wire_stack)
    if not np.isclose(loss_wire, loss_dense, rtol=1e-5, atol=0):
        raise AssertionError(f"coded-wire loss {loss_wire} != dense "
                             f"{loss_dense}")
    return {"n_devices": n_devices, "device": str(device),
            "loss": got_loss, "serial_loss": ref_loss,
            "max_grad_diff_over_scale": worst, "step_losses": steps,
            "scorer_devices": [str(d) for d in devices],
            "dispatch_counts": counts,
            "peak_concurrent_devices": scorer.peak_concurrent_devices,
            "coded_vs_dense_max_abs": coded_err,
            "packed_vs_dense_max_abs": packed_err,
            "wire_loss": loss_wire, "dense_loss": loss_dense}
