"""Mixture-of-Experts variant-scoring model in torch.

The port of hello_tpu's nn/moe.py over the same fixed-shape padded batches:

  * dense:  ``reads0`` ``[A, R, L, C]`` uint8 + ``read_mask0`` ``[A, R]``;
  * packed: ``rows0`` ``[nb, L, C]`` uint8 + ``row_allele0`` / ``row_valid0``
    (the coded wire expanded by pipeline/compact.expand_compact_packed);
  * ``site_ids`` ``[A]``, ``allele_mask`` ``[A]``, ``ref_segments``
    ``[S, L, 5]`` (S = number of padded sites).

In eval mode both read layouts reduce per allele through ONE op,
``ops.read_conv.read_conv_reduce``: the hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors, in the kernel route of
the precision in force (nn/layers.set_precision).  At ``bf16`` dtypes flow
as in hello_tpu: the read-convolver frames are bf16 values summed per
allele in fp32, the compressors' first convs round those sums to bf16, the
conv stacks carry bf16 activations, and the expert logits and the meta
softmax stay fp32.  The dense grid is
passed as rows ``reads.reshape(A*R, L, C)`` with ``row_allele = r // R`` and
``row_valid = read_mask``.

Model variants, selected by which networks the config holds:

  * single-tech (illumina, pacbio, pacbio_hp): read_conv0 + compressor0 +
    xattn0 -> one logit per allele;
  * hybrid no-ensemble: both platforms' read convolvers and compressors,
    combiners and xattn2 -> one logit per allele;
  * hybrid (three experts) and hybrid_ensemble2 (two experts): per-platform
    experts, plus xattn2 on the combiners where present, and the meta-expert's
    softmax over the three experts per site.

Hybrid batches add ``reads1`` / ``read_mask1`` (dense) or ``rows1`` /
``row_allele1`` / ``row_valid1`` (packed); read_conv1 reduces them through
the same kernel with its own folded weights.

The wide read convolver (the wide configs) has a kernel of its own at
``bf16`` (``FoldedReadConv.width == 2``).  A read convolver no kernel
implements in the route of the precision in force (the addendum and
layer_norm configs, and the wide ones at ``highest``, ``high`` and
``default``: ``ops.read_conv.supports_read_convolver`` is false) takes
the *layer route* in eval mode: its layer modules under ``torch.no_grad()``,
then the per-allele sum, as hello_tpu sends the networks its Pallas kernel
does not implement to its XLA layers.  The route is decided once per fold,
by the topology and the precision (``fold_read_convs``), never because a
kernel failed.  Over packed rows its sum runs in a fixed order
(``ordered_read_reduce``), so two runs of one batch give the same bits on
the card, where ``index_add_``'s atomics would not.  Each eval-mode
reduction is counted in the launch ledger (``telemetry.count``); given a
``stamps`` tensor on the card, ``forward`` brackets each read convolver
that the width-1 kernel does not implement (``stamped``), on either route,
with two stamps of the card's clock (``ops.card_stamp``).

In train mode (``model.train()``) the read convolvers run through their
layer modules under autograd instead, as hello_tpu's train-mode forward
takes its layers and never its Pallas kernel; the kernel has no backward.
Every network call sets the row mask of its batch axis for train-mode batch
norm (``layers.bn_batch_mask``), at hello_tpu's call sites: ``row_valid`` or
the read mask for the read convolvers, ``allele_mask`` for the allele
passes, the xattns and combiner0, and the mask of sites holding a real
allele for the site passes, combiner1 and the meta-expert.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .. import telemetry
from . import archs
from . import layers as L
from .convert import _TORCH_ATTR
from .layers import build_network
from ..ops.card_stamp import card_stamp
from ..ops.read_conv import (fold_read_conv_weights, read_conv_reduce,
                             route_for_precision, supports_read_convolver)

class LayerRoute:
    """``fold_read_convs``' marker for a read convolver no kernel
    implements in the precision's route: its layer modules run under
    ``torch.no_grad()`` in eval mode."""
    route = "layers"


def stamped(route) -> bool:
    """Whether a read convolver of this fold (``FoldedReadConv`` or
    ``LayerRoute``) gets the card's stamps: every one the width-1 kernel
    does not implement, whichever route runs it (the layer route, or the
    wide kernel)."""
    return isinstance(route, LayerRoute) or route.width != 1


def packed_read_reduce(frames, row_allele, row_valid, num_alleles):
    """Per-allele sum of packed read-row frames: frames [nb, L, C],
    row_allele [nb] (``num_alleles`` marks a padding row), row_valid [nb]
    -> [A, L, C] float32.  Padding rows' frames are nonzero (biases reach
    them), so ``row_valid`` zeroes them before the segment sum."""
    frames = frames.float() * row_valid.float()[:, None, None]
    out = frames.new_zeros((num_alleles + 1,) + tuple(frames.shape[1:]))
    out.index_add_(0, row_allele.long(), frames)
    return out[:num_alleles]


def ordered_read_reduce(frames, row_allele, row_valid, num_alleles,
                        reads_per_allele):
    """``packed_read_reduce`` with the sum in a fixed order: each real row's
    frame goes to its place (allele, rank among that allele's rows in row
    order) of a dense ``[A, R]`` grid, ``R = reads_per_allele`` (the wire's
    read bucket, at least any allele's rows), and the grid is summed over
    ``R``.  The same bits on every run, where ``index_add_`` on the card
    adds with atomics in the order the rows happen to land; no host sync,
    so it runs inside a captured graph.  Rows with ``row_valid == 0`` or
    ``row_allele == A`` go to a dropped place."""
    A, R = num_alleles, reads_per_allele
    allele = torch.where(row_valid > 0, row_allele.long(), A)
    ordered, order = torch.sort(allele, stable=True)
    first = torch.searchsorted(ordered, ordered)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device) - first
    place = torch.where(allele < A, allele * R + rank, A * R)
    tail = tuple(frames.shape[1:])
    grid = frames.new_zeros((A * R + 1,) + tail, dtype=torch.float32)
    grid.index_copy_(0, place, frames.float())
    return grid[:A * R].view((A, R) + tail).sum(dim=1)


def masked_read_sum(read_frames, read_mask):
    """[A, R, L, C] x [A, R] -> [A, L, C] float32: masked sum over each
    allele's reads (the dense twin of packed_read_reduce); bf16 frames are
    summed in fp32, as hello_tpu's einsum with an fp32 preferred type."""
    return torch.einsum("ar,arlc->alc", read_mask.float(),
                        read_frames.float())


def site_segment_sum(allele_feats, site_onehot):
    """Sum allele-level features per site: [A, L, C] x [A, S] -> [S, L, C]
    float32.  The one-hot contraction runs in float64 and is rounded once:
    the fp32 sum, exact and the same on every device, where a TF32 matmul
    (allowed at default and bf16) would round the features first and move
    the bf16 rounding of the compressor input that follows."""
    return torch.einsum("as,alc->slc", site_onehot.double(),
                        allele_feats.double()).float()


def make_site_onehot(site_ids, allele_mask, num_sites):
    """[A] int, [A] float -> [A, S] float one-hot with padded slots zeroed."""
    ids = torch.arange(num_sites, device=site_ids.device)
    onehot = (site_ids[:, None] == ids[None, :]).float()
    return onehot * allele_mask.float()[:, None]


class MoEAttention(nn.Module):
    """MoE model; networks live under the reference's attribute
    names (``read_convolver0``, ``compressor0``, ``xattn0``, ...)."""

    NETWORK_NAMES = (
        "read_conv0", "read_conv1",
        "compressor0", "compressor1", "compressor2",
        "xattn0", "xattn1", "xattn2",
        "combiner0", "combiner1", "meta",
    )

    def __init__(self, config: Dict[str, list]):
        super().__init__()
        if config.get("read_conv0") is None:
            raise ValueError("read_conv0 is required")
        self.config = config
        self.hybrid = config.get("read_conv1") is not None
        for name in self.NETWORK_NAMES:
            if config.get(name) is not None:
                self.add_module(_TORCH_ATTR[name], build_network(config[name]))

    def networks(self) -> Dict[str, nn.Module]:
        """hello_tpu network name -> module, for the networks present."""
        return {name: getattr(self, _TORCH_ATTR[name])
                for name in self.NETWORK_NAMES
                if hasattr(self, _TORCH_ATTR[name])}

    def net(self, name):
        return getattr(self, _TORCH_ATTR[name], None)

    def fold_read_convs(self):
        """Each read convolver's route for the precision in force, decided
        by its topology and that precision's kernel route: the kernel's
        folded weights (``FoldedReadConv``, width 1 or 2) for a read
        convolver a kernel implements there, a ``LayerRoute`` for any
        other.  Compute once per parameter set and
        precision and pass to ``forward``."""
        return {name: (fold_read_conv_weights(net)
                       if supports_read_convolver(net) else LayerRoute())
                for name in ("read_conv0", "read_conv1")
                if (net := self.net(name)) is not None}

    def _run(self, name, x, mask):
        """Network ``name`` on ``x``, its train-mode batch norm weighted by
        ``mask`` (the rows of ``x``'s batch axis that are real)."""
        with L.bn_batch_mask(mask if self.training else None):
            return self.net(name)(x)

    def _compress_and_predict(self, idx, reduced_allele, site_onehot,
                              site_ids, allele_mask, site_mask):
        """reduced_allele [A, 36, 64] -> (expert logits [A, 1] or None,
        (site0 [S, 18, 128], site1 [S, 18, 128]), compressed [A, 18, 128]).
        The compressor's allele pass updates its batch-norm statistics
        before its site pass reads them, as hello_tpu threads them."""
        cname = f"compressor{idx}"
        ca = self._run(cname, reduced_allele, allele_mask)
        # site features route 1: compress the per-site sum of read frames
        cs0 = self._run(cname, site_segment_sum(reduced_allele, site_onehot),
                        site_mask)
        expand0 = cs0[site_ids]
        # site features route 2: per-site sum of compressed allele features
        cs1 = site_segment_sum(ca, site_onehot)
        expand1 = cs1[site_ids]
        xname = f"xattn{idx}"
        logits = (None if self.net(xname) is None else
                  self._run(xname, (ca, (expand0, expand1)), allele_mask))
        return logits, (cs0, cs1), ca

    @property
    def has_meta(self) -> bool:
        return self.net("meta") is not None

    def _read_reduce_layers(self, batch, k):
        """Platform k's reads through the read convolver's layer modules
        (cuDNN on the card), then the masked per-allele sum, as hello_tpu's
        layer path does; packed rows or the dense ``A*R`` grid.  Under
        autograd in train mode; the layer route in eval mode, whose packed
        rows sum in a fixed order (``ordered_read_reduce``)."""
        name = f"read_conv{k}"
        if f"rows{k}" in batch:
            A, R = batch[f"read_mask{k}"].shape
            row_valid = batch[f"row_valid{k}"].float()
            frames = self._run(name, batch[f"rows{k}"].float(), row_valid)
            if self.training:
                return packed_read_reduce(frames, batch[f"row_allele{k}"],
                                          row_valid, A)
            return ordered_read_reduce(frames, batch[f"row_allele{k}"],
                                       row_valid, A, R)
        reads = batch[f"reads{k}"]
        A, R = reads.shape[:2]
        mask = batch[f"read_mask{k}"].float()
        frames = self._run(
            name, reads.reshape((A * R,) + tuple(reads.shape[2:])).float(),
            mask.reshape(-1))
        frames = frames.reshape((A, R) + tuple(frames.shape[1:]))
        return masked_read_sum(frames, mask)

    def _read_reduce(self, batch, k, folded, stamps=None):
        """Platform k's reads -> per-allele sum of read-convolver frames
        [A, 36, 64 * width], packed rows or the dense grid flattened to
        rows.  For a read convolver the width-1 kernel does not implement
        (``stamped``), ``stamps`` (int64 [read convolvers, 2] on the card,
        or None) gets the card's clock before and after in row k."""
        if self.training:
            return self._read_reduce_layers(batch, k)
        route = folded[f"read_conv{k}"]
        stamp = stamps is not None and stamped(route)
        if stamp:
            card_stamp(stamps[k, 0])
        out = self._read_reduce_route(batch, k, route)
        if stamp:
            card_stamp(stamps[k, 1])
        return out

    def _read_reduce_route(self, batch, k, route):
        """``_read_reduce`` in eval mode on the fold's route: the layer
        route, or ``read_conv_reduce`` with the folded weights."""
        name = f"read_conv{k}"
        telemetry.count(("read_conv", name, route.route))
        if isinstance(route, LayerRoute):
            rows = batch.get(f"rows{k}")
            telemetry.count(("layer_rows", name),
                            batch[f"reads{k}"].shape[:2].numel()
                            if rows is None else rows.shape[0])
            with torch.no_grad():
                return self._read_reduce_layers(batch, k)
        if f"rows{k}" in batch:
            A = batch[f"read_mask{k}"].shape[0]
            rows = batch[f"rows{k}"]
            row_allele = batch[f"row_allele{k}"]
            row_valid = batch[f"row_valid{k}"]
        else:
            reads = batch[f"reads{k}"]
            A, R = reads.shape[:2]
            rows = reads.reshape((A * R,) + tuple(reads.shape[2:]))
            row_allele = torch.div(
                torch.arange(A * R, dtype=torch.int32, device=reads.device),
                R, rounding_mode="floor")
            row_valid = batch[f"read_mask{k}"].reshape(-1).float()
        return read_conv_reduce(rows, row_allele, row_valid, route, A)

    def forward(self, batch, folded=None, stamps=None):
        """Forward -> {"experts": [A, E] raw logits, "meta": [S, 3] softmax
        weights or None}; E is 1 (single-tech, hybrid no-ensemble) or 3
        (experts 0, 1, 2; zeros for expert 2 when the config has none).
        ``stamps`` (eval mode on the card: int64 [read convolvers, 2]) gets,
        in row k, the card's clock before and after read convolver k where
        the width-1 kernel does not implement it (``stamped``); its other
        rows are left as they are.

        Eval mode reduces the reads through ``read_conv_reduce`` with the
        folded weights, or through the layer route (``folded``:
        ``fold_read_convs()`` output, computed here when None); train mode
        runs the read convolvers' layers under autograd and ignores
        ``folded``.  A config without BatchNorm and Dropout computes the
        same function in both modes; with them, train mode normalises by
        the masked batch statistics and updates the running ones."""
        if not self.training:
            if folded is None:
                folded = self.fold_read_convs()
            route = route_for_precision(L.PRECISION)
            stale = {n: f.route for n, f in folded.items()
                     if f.route not in (route, LayerRoute.route)}
            if stale:
                raise ValueError(f"read convolvers folded for routes {stale}, "
                                 f"but the precision {L.PRECISION!r} runs "
                                 f"route {route!r}: fold again after "
                                 "set_precision")
        S = batch["ref_segments"].shape[0]
        site_ids = batch["site_ids"].long()
        site_onehot = make_site_onehot(site_ids, batch["allele_mask"], S)
        # the rows of the allele and site axes that are real, for batch norm
        masks = dict(allele_mask=batch["allele_mask"].float(),
                     site_mask=(site_onehot.sum(dim=0) > 0).float())
        reduced0 = self._read_reduce(batch, 0, folded, stamps)
        e0, f0, ca0 = self._compress_and_predict(0, reduced0, site_onehot,
                                                 site_ids, **masks)
        if not self.hybrid:
            return {"experts": e0, "meta": None}

        reduced1 = self._read_reduce(batch, 1, folded, stamps)
        e1, f1, ca1 = self._compress_and_predict(1, reduced1, site_onehot,
                                                 site_ids, **masks)
        if self.net("compressor2") is not None:
            # hybrid features straight from the summed read frames
            e2, f2, _ = self._compress_and_predict(
                2, reduced0 + reduced1, site_onehot, site_ids, **masks)
            meta_site_frames = f2[0]
        elif self.net("xattn2") is not None:
            # combiner route: merge both platforms' compressed features
            ca2 = self._run("combiner0", (ca0, ca1), masks["allele_mask"])
            cs2 = self._run("combiner1", (f0[1], f1[1]), masks["site_mask"])
            e2 = self._run("xattn2", (ca2, (None, cs2[site_ids])),
                           masks["allele_mask"])
            meta_site_frames = cs2
        else:
            e2 = None
            meta_site_frames = site_segment_sum(reduced0 + reduced1,
                                                site_onehot)

        meta = None
        if self.net("meta") is not None:
            meta = torch.softmax(self._run(
                "meta", (meta_site_frames, batch["ref_segments"].float()),
                masks["site_mask"]), dim=-1)
        if e0 is None and e1 is None:
            # hybrid no-ensemble: expert 2's logit alone
            return {"experts": e2, "meta": None}
        if e2 is None:
            # two experts under the meta softmax; expert 2 is zeros
            e2 = torch.zeros_like(e0)
        return {"experts": torch.cat([e0, e1, e2], dim=-1), "meta": meta}


def create_model(name_or_config) -> MoEAttention:
    """Create a model from a named config (any of ``archs.NAMED_CONFIGS``:
    illumina, pacbio, pacbio_hp, hybrid, hybrid_no_ensemble,
    hybrid_ensemble2 and the wide, addendum and layer_norm variants) or an
    explicit config dict."""
    if isinstance(name_or_config, str):
        config = archs.NAMED_CONFIGS[name_or_config]()
    else:
        config = name_or_config
    return MoEAttention(config)
