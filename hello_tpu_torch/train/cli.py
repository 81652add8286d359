"""Training CLI: train the MoE model from dumped shards, on one card or on
several, one process each.

The port of hello_tpu's train/cli.py (``python -m hello_tpu_torch.train.cli
--data 'dump*.index' --model illumina --out_prefix run``; ``--device cpu``
without a card).  Every argument of hello_tpu's ``train_from_shards`` is
kept, and ``device`` is added.  ``--num_devices k`` makes each step hello_tpu's
k-device step: k sub-batches on this process's device, their losses and
gradients summed.  N cards train as N processes, ``torchrun --nproc_per_node
N -m hello_tpu_torch.train.cli --distributed ...``: each rank trains on its
share of the shard files, every step's sums are summed over the ranks
(NCCL; gloo with ``--device cpu``), an epoch ends when any rank runs out of
batches, and rank 0 alone writes checkpoints and metrics.  On the card the
defaults ship coded-wire batches (expanded on the device) and overlap: a
prefetch thread packs the next batch and uploads it through pinned buffers
while the step in flight runs, and each step's loss is read one step late.
``--profile_dir`` traces the run (telemetry.device_trace), the trainer's
spans (``trainer.step`` and its children) on a track of their own.  Outputs:
``<out_prefix>.metrics.jsonl``, ``.epoch<n>.ckpt``, ``.best.ckpt`` (with a
validation split) and ``.final.ckpt``, in hello_tpu's checkpoint format.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import math
import pickle
import time

from .. import telemetry
from ..nn.archs import NAMED_CONFIGS
from ..nn.moe import create_model
from ..parallel import mesh
from ..pipeline.call import resolve_device
from .loader import SiteDataset, batches, device_batches, shard_files_for_ranks
from .trainer import TrainConfig, Trainer, _to_numpy

logger = logging.getLogger(__name__)


def prefetch_iter(it, depth: int = 2):
    """Background-thread batch prefetch: the host-side packing (and, with
    overlap, the upload) of the next ``depth`` batches runs while the step
    in flight does.  Exceptions from the producer re-raise at the consuming
    ``next()``.  Closing the generator (or its garbage collection) sets a
    stop flag the producer polls between puts, so an abandoned epoch
    releases the thread and its buffered batches."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    END, ERR = object(), object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not _put(item):
                    return
                if stop.is_set():   # don't pack one extra discarded batch
                    return
        except BaseException as exc:   # surfaced to the consumer
            _put((ERR, exc))
            return
        _put(END)

    threading.Thread(target=run, daemon=True,
                     name="hello-tpu-torch-train-prefetch").start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is END:
                    return
                if (isinstance(item, tuple) and len(item) == 2
                        and item[0] is ERR):
                    raise item[1]
                yield item
        finally:
            stop.set()

    return gen()


def read_file_list(spec: str):
    if spec.endswith(".lst"):
        with open(spec) as fh:
            return [line.strip() for line in fh if line.strip()]
    return sorted(glob.glob(spec))


def model_input_channels(model) -> int:
    """Input channel count of the model's read convolver (6, or 7 with the
    haplotag channel): the data must be packed to match."""
    for layer in model.net("read_conv0").network:
        if hasattr(layer, "in_channels"):
            return int(layer.in_channels)
    return 6


def train_from_shards(
    files, model_name: str, out_prefix: str,
    num_epochs: int = 10, lr: float = 1e-3, optimizer: str = "Adam",
    batch_alleles: int = 64, num_devices=None,
    val_fraction: float = 0.1, max_reads_per_site: int = 1000,
    read_bucket: int = 64, allele_bucket: int = 64, site_bucket: int = 32,
    t0: int = 10, t_mult: int = 2, min_lr: float = 0.0, warmup: bool = False,
    entropy_regularizer: float = 0.1, entropy_decay: float = 0.5,
    smoothing: float = 0.0, aux_weight: float = 0.0, weight_decay: float = 1e-4,
    seed: int = 13, channels: int = None, resume: str = None,
    coverage_range=None, checkpoint_every: int = 0,
    steps_per_epoch: int = 0, wire: bool = None, remat: bool = False,
    overlap: bool = None, device=None,
):
    """Train ``model_name`` on the shard indexes ``files`` on ``device``
    (``cuda`` unless it names another), ``num_devices`` sub-batches per
    step; inside a process group (parallel/mesh.init_distributed) the ranks'
    steps are summed and rank 0 writes the outputs.  Returns the Trainer."""
    n_dev = 1 if num_devices is None else int(num_devices)
    device = resolve_device(device)
    on_card = device.type == "cuda"
    # coded-wire batches (expanded on the device): ~6x less host-to-device
    # staging per step on the card, pure overhead on the CPU
    if wire is None:
        wire = on_card
    # overlapped staging and a lag-1 loss read on the card; the plain
    # synchronous loop on the CPU.  Same batches, order and step math.
    if overlap is None:
        overlap = on_card

    model = create_model(model_name)
    binary = not model.has_meta
    if channels is None:
        channels = model_input_channels(model)
    elif channels != model_input_channels(model):
        raise ValueError(
            f"data packed with {channels} channels but model "
            f"{model_name!r} expects {model_input_channels(model)} — "
            "channel count is a property of the model config")
    if steps_per_epoch <= 0 and (optimizer == "SGDR" or warmup):
        # the SGDR/warmup schedules step fractionally per batch; estimate
        # the batches per epoch from the shard indexes (~2 alleles per site
        # is the typical calling-mode density)
        from .store import open_shard
        total_sites = sum(len(open_shard(p)) for p in files)
        per_batch = min(site_bucket, max(1, batch_alleles // 2))
        steps_per_epoch = max(1, -(-total_sites // per_batch))
        logger.info("estimated steps_per_epoch=%d for the LR schedule",
                    steps_per_epoch)
    config = TrainConfig(
        lr=lr, min_lr=min_lr, optimizer=optimizer, weight_decay=weight_decay,
        t0=t0, t_mult=t_mult, warmup=warmup,
        steps_per_epoch=max(steps_per_epoch, 1),
        entropy_regularizer=entropy_regularizer, entropy_decay=entropy_decay,
        smoothing=smoothing, aux_weight=aux_weight, binary=binary,
        remat=remat)
    trainer = Trainer(model, config, device=device, seed=seed,
                      num_devices=n_dev)
    start_epoch, skip_batches = 0, 0
    best_val = float("inf")
    if resume:
        trainer.restore(resume)
        # full-state resume: the per-epoch data order is a pure function of
        # (seed, epoch), so replaying the recorded position restores the
        # exact batch sequence the interrupted run would have seen
        extra = trainer.resume_extra
        start_epoch = int(extra.get("epoch", 0))
        skip_batches = int(extra.get("batches_done", 0))
        best_val = float(extra.get("best_val", float("inf")))
        ckpt_seed = extra.get("seed")
        if ckpt_seed is not None and ckpt_seed != seed:
            logger.warning(
                "resume seed mismatch: checkpoint trained with seed %s, "
                "current run uses %s — data order will differ", ckpt_seed, seed)
        logger.info("resumed from %s at step %d (epoch %d, %d batches done)",
                    resume, trainer.step, start_epoch, skip_batches)

    # val_fraction <= 0 means no holdout; the max(1, ...) floor applies only
    # when a validation split was asked for
    n_val = (max(1, int(len(files) * val_fraction))
             if len(files) > 1 and val_fraction > 0 else 0)
    val_files = files[:n_val]
    train_files = files[n_val:] or files

    # a grouping budget above the fixed allele bucket can never pack; widen
    # the bucket (and the site bucket proportionally) instead of crashing
    if batch_alleles > allele_bucket:
        logger.info("raising allele_bucket %d -> %d to fit batch_alleles",
                    allele_bucket, batch_alleles)
        site_bucket = max(site_bucket,
                          site_bucket * batch_alleles // allele_bucket)
        allele_bucket = batch_alleles
    fixed = {"read_bucket": read_bucket, "allele_bucket": allele_bucket,
             "site_bucket": site_bucket}
    # checkpoints and the metrics stream are rank 0's: every rank writing
    # the same paths would race the atomic-replace save
    multiprocess = mesh.world_size() > 1
    rank0 = mesh.rank() == 0
    # crash dumps must not collide across ranks
    dump_prefix = (f"{out_prefix}.rank{mesh.rank()}" if multiprocess
                   else out_prefix)
    metrics_fh = open(f"{out_prefix}.metrics.jsonl", "a") if rank0 else None
    try:
        for epoch in range(start_epoch, num_epochs):
            dataset = SiteDataset(train_files, max_reads_per_site,
                                  shuffle=True, seed=seed + epoch,
                                  coverage_range=coverage_range)
            epoch_loss, n_batches, n_trained = 0.0, 0, 0
            start_t = time.time()
            batch_src = device_batches(dataset, model.hybrid, n_dev,
                                       batch_alleles, channels=channels,
                                       fixed_shape=fixed, wire=wire)
            if overlap:
                # the upload runs in the prefetch producer thread, so it
                # overlaps the step in flight
                batch_src = map(trainer.stage_batches, batch_src)
            batch_iter = prefetch_iter(batch_src)

            pending = None      # overlap: the step in flight's metrics
            metrics = {}

            def _sync_pending():
                """Read the previous step's loss (one step behind the
                dispatch, so the read overlaps the next step).  The
                non-finite dump here is one step late: the parameters have
                advanced one extra step past the offending update; the
                payload is exact."""
                nonlocal pending, epoch_loss, n_trained, metrics
                if pending is None:
                    return
                m, payload, step_no = pending
                pending = None
                loss, per_expert = trainer.read_metrics(m)
                if not math.isfinite(loss):
                    prefix = f"{dump_prefix}.step{step_no}.err"
                    trainer.save(f"{prefix}.ckpt")
                    with open(f"{prefix}.payload.pkl", "wb") as fh:
                        pickle.dump(_to_numpy(payload), fh)
                    raise FloatingPointError(
                        f"non-finite training loss at step {step_no}; "
                        f"post-step params and payload dumped to {prefix}.*")
                epoch_loss += loss
                n_trained += 1
                metrics = {"loss": loss, "per_expert": per_expert}

            try:
                while True:
                    stacked = next(batch_iter, None)
                    if multiprocess:
                        # every rank enters the step's all-reduce the same
                        # number of times: stop as soon as ANY rank runs dry
                        # (ranks' shard files never split sites alike)
                        if not trainer.all_ranks_have(stacked is not None):
                            break
                    elif stacked is None:
                        break
                    n_batches += 1        # absolute position within the epoch
                    if skip_batches > 0:
                        # deterministic sampler fast-forward on mid-epoch resume
                        skip_batches -= 1
                        continue
                    if overlap:
                        m = trainer.train_batch(stacked, sync=False)
                        _sync_pending()          # previous step, while this runs
                        pending = (m, stacked, trainer.step)
                    else:
                        metrics = trainer.train_batch(
                            stacked, crash_dump_prefix=dump_prefix)
                        epoch_loss += metrics["loss"]
                        n_trained += 1
                    if rank0 and checkpoint_every \
                            and trainer.step % checkpoint_every == 0:
                        trainer.save(
                            f"{out_prefix}.step{trainer.step}.ckpt",
                            extra={"epoch": epoch, "batches_done": n_batches,
                                   "seed": seed, "best_val": best_val})
                _sync_pending()                  # drain the last step in flight
            finally:
                batch_iter.close()
            elapsed = time.time() - start_t

            val_loss = None
            if val_files:
                val_ds = SiteDataset(val_files, max_reads_per_site,
                                     shuffle=False)
                val_loss = trainer.evaluate(
                    batches(val_ds, model.hybrid, batch_alleles,
                            channels=channels, wire=wire))
            logger.info(
                "epoch %d: train_loss=%.4f (%d batches, %.1fs) val_loss=%s",
                epoch, epoch_loss / max(n_trained, 1), n_trained, elapsed,
                f"{val_loss:.4f}" if val_loss is not None else "n/a")
            if val_loss is not None and val_loss < best_val:
                best_val = val_loss
            if not rank0:
                continue
            metrics_fh.write(json.dumps({
                "epoch": epoch, "step": trainer.step,
                "train_loss": epoch_loss / max(n_trained, 1),
                "val_loss": val_loss, "batches": n_trained,
                "seconds": round(elapsed, 2),
                "per_expert": metrics.get("per_expert") if n_trained else None,
            }) + "\n")
            metrics_fh.flush()
            epoch_extra = {"epoch": epoch + 1, "batches_done": 0,
                           "seed": seed, "best_val": best_val}
            if val_loss is not None and val_loss == best_val:
                trainer.save(f"{out_prefix}.best.ckpt", extra=epoch_extra)
            trainer.save(f"{out_prefix}.epoch{epoch}.ckpt", extra=epoch_extra)
        if rank0:
            trainer.save(f"{out_prefix}.final.ckpt",
                         extra={"epoch": num_epochs, "batches_done": 0,
                                "seed": seed})
    finally:
        if metrics_fh is not None:
            metrics_fh.close()
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="hello_tpu_torch MoE trainer")
    parser.add_argument("--data", required=True,
                        help=".lst file of shard indices, or a glob")
    parser.add_argument("--model", default="hybrid",
                        choices=sorted(NAMED_CONFIGS),
                        help="model config (the reference's named configs)")
    parser.add_argument("--out_prefix", required=True)
    parser.add_argument("--num_epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--optimizer", default="Adam",
                        help="Adam | SGD | SGDR")
    parser.add_argument("--batch_alleles", type=int, default=64)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="sub-batches per step on this process's device "
                             "(hello_tpu's step on that many devices); "
                             "default 1")
    parser.add_argument("--val_fraction", type=float, default=0.1)
    parser.add_argument("--max_reads_per_site", type=int, default=1000)
    parser.add_argument("--read_bucket", type=int, default=64)
    parser.add_argument("--entropy_regularizer", type=float, default=0.1)
    parser.add_argument("--entropy_decay", type=float, default=0.5)
    parser.add_argument("--smoothing", type=float, default=0.0)
    parser.add_argument("--aux_loss", type=float, default=0.0)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--warmup", action="store_true")
    parser.add_argument("--T0", type=int, default=10)
    parser.add_argument("--Tmult", type=int, default=2)
    parser.add_argument("--minLr", type=float, default=0.0)
    parser.add_argument("--include_hp", action="store_true",
                        help="assert 7-channel (haplotagged) data; the "
                             "channel count itself derives from --model")
    parser.add_argument("--seed", type=int, default=13)
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward in the backward "
                             "(torch.utils.checkpoint) for activation-memory "
                             "headroom")
    parser.add_argument("--subsample_coverage", default=None,
                        help="LO,HI coverage-fraction range for per-site "
                             "read-thinning augmentation (e.g. 0.3,1.0)")
    parser.add_argument("--resume", default=None,
                        help="checkpoint to resume full training state from")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="also checkpoint every N optimisation steps "
                             "(mid-epoch, resumable at the exact batch)")
    parser.add_argument("--distributed", action="store_true",
                        help="one process per card under torchrun (reads "
                             "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, "
                             "LOCAL_RANK): NCCL on cuda:LOCAL_RANK, gloo "
                             "with --device cpu")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of the run "
                             "here, with the program's spans (trainer.*) on "
                             "a track of their own")
    parser.add_argument("--wire", choices=["auto", "0", "1"], default="auto",
                        help="coded-wire training batches (1-byte cells "
                             "expanded on the device): auto = on for the "
                             "card, off on the CPU")
    parser.add_argument("--overlap", choices=["auto", "0", "1"],
                        default="auto",
                        help="upload batches on the prefetch thread and read "
                             "each step's loss one step late: auto = on for "
                             "the card")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:LOCAL_RANK with "
                             "--distributed) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    device = args.device
    if args.distributed:
        device = mesh.init_distributed(device)
    try:
        _run(parser, args, device)
    finally:
        mesh.destroy_distributed()
    logger.info("Completed running the script")


def _run(parser, args, device):
    files = read_file_list(args.data)
    if not files:
        parser.error(f"no shard files found for {args.data}")
    coverage_range = None
    if args.subsample_coverage:
        try:
            lo, hi = (float(x) for x in args.subsample_coverage.split(","))
        except ValueError:
            parser.error("--subsample_coverage expects LO,HI (e.g. 0.3,1.0), "
                         f"got {args.subsample_coverage!r}")
        if not (0 < lo <= hi <= 1):
            parser.error("--subsample_coverage needs 0 < LO <= HI <= 1, "
                         f"got {args.subsample_coverage!r}")
        coverage_range = (lo, hi)
    if mesh.world_size() > 1:
        # shard files balanced across ranks; the per-batch barrier
        # (Trainer.all_ranks_have) equalises the steps per epoch
        per_rank, _ = shard_files_for_ranks(files, mesh.world_size())
        files = per_rank[mesh.rank()]
        logger.info("rank %d takes %d shard files", mesh.rank(), len(files))
    trace = (telemetry.device_trace(
        args.profile_dir, cuda=resolve_device(device).type == "cuda")
        if args.profile_dir else contextlib.nullcontext())
    with trace:
        train_from_shards(
            files, args.model, args.out_prefix,
            num_epochs=args.num_epochs, lr=args.lr, optimizer=args.optimizer,
            batch_alleles=args.batch_alleles, num_devices=args.num_devices,
            val_fraction=args.val_fraction,
            max_reads_per_site=args.max_reads_per_site,
            read_bucket=args.read_bucket, t0=args.T0, t_mult=args.Tmult,
            min_lr=args.minLr, warmup=args.warmup,
            entropy_regularizer=args.entropy_regularizer,
            entropy_decay=args.entropy_decay, smoothing=args.smoothing,
            aux_weight=args.aux_loss, weight_decay=args.weight_decay,
            seed=args.seed, channels=7 if args.include_hp else None,
            resume=args.resume, coverage_range=coverage_range,
            checkpoint_every=args.checkpoint_every,
            wire=None if args.wire == "auto" else args.wire == "1",
            remat=args.remat,
            overlap=None if args.overlap == "auto" else args.overlap == "1",
            device=device)


if __name__ == "__main__":
    main()
