"""Mixture-of-Experts variant-scoring model in torch (eval mode).

The port of hello_tpu's nn/moe.py over the same fixed-shape padded batches:

  * dense:  ``reads0`` ``[A, R, L, C]`` uint8 + ``read_mask0`` ``[A, R]``;
  * packed: ``rows0`` ``[nb, L, C]`` uint8 + ``row_allele0`` / ``row_valid0``
    (the coded wire expanded by pipeline/compact.expand_compact_packed);
  * ``site_ids`` ``[A]``, ``allele_mask`` ``[A]``, ``ref_segments``
    ``[S, L, 5]`` (S = number of padded sites).

Both read layouts reduce per allele through ONE op,
``ops.read_conv.read_conv_reduce``: the hand-written CUDA kernel for CUDA
tensors, its plain PyTorch version for CPU tensors.  The dense grid is
passed as rows ``reads.reshape(A*R, L, C)`` with ``row_allele = r // R`` and
``row_valid = read_mask``.

This slice ports the single-tech configs (read_conv0 + compressor0 +
xattn0: illumina, pacbio, pacbio_hp); hybrid configs raise.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import archs
from .convert import _TORCH_ATTR
from .layers import build_network
from ..ops.read_conv import fold_read_conv_weights, read_conv_reduce

ROADMAP_HYBRID = ("ROADMAP.md Queue 1 (the hybrid, hybrid_no_ensemble, "
                  "pacbio and pacbio_hp configs)")


def packed_read_reduce(frames, row_allele, row_valid, num_alleles):
    """Per-allele sum of packed read-row frames: frames [nb, L, C],
    row_allele [nb] (``num_alleles`` marks a padding row), row_valid [nb]
    -> [A, L, C] float32.  Padding rows' frames are nonzero (biases reach
    them), so ``row_valid`` zeroes them before the segment sum."""
    frames = frames.float() * row_valid.float()[:, None, None]
    out = frames.new_zeros((num_alleles + 1,) + tuple(frames.shape[1:]))
    out.index_add_(0, row_allele.long(), frames)
    return out[:num_alleles]


def masked_read_sum(read_frames, read_mask):
    """[A, R, L, C] x [A, R] -> [A, L, C]: masked sum over each allele's
    reads (the dense twin of packed_read_reduce)."""
    return torch.einsum("ar,arlc->alc", read_mask.to(read_frames.dtype),
                        read_frames)


def site_segment_sum(allele_feats, site_onehot):
    """Sum allele-level features per site: [A, L, C] x [A, S] -> [S, L, C]."""
    return torch.einsum("as,alc->slc", site_onehot, allele_feats)


def make_site_onehot(site_ids, allele_mask, num_sites):
    """[A] int, [A] float -> [A, S] float one-hot with padded slots zeroed."""
    ids = torch.arange(num_sites, device=site_ids.device)
    onehot = (site_ids[:, None] == ids[None, :]).float()
    return onehot * allele_mask.float()[:, None]


class MoEAttention(nn.Module):
    """Single-tech MoE model; networks live under the reference's attribute
    names (``read_convolver0``, ``compressor0``, ``xattn0``)."""

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
        if config.get("read_conv1") is not None:
            raise NotImplementedError(
                f"hybrid model configs are not ported yet ({ROADMAP_HYBRID})")
        self.config = config
        self.hybrid = False
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
        """Folded read-convolver weights for the kernel (raises for a read
        convolver it does not implement).  Compute once per parameter set
        and pass to ``forward``."""
        return {"read_conv0": fold_read_conv_weights(self.read_convolver0)}

    def _compress_and_predict(self, idx, reduced_allele, site_onehot,
                              site_ids):
        """reduced_allele [A, 36, 64] -> (expert logits [A, 1] or None,
        (site0 [S, 18, 128], site1 [S, 18, 128]), compressed [A, 18, 128])."""
        compressor = self.net(f"compressor{idx}")
        ca = compressor(reduced_allele)
        # site features route 1: compress the per-site sum of read frames
        cs0 = compressor(site_segment_sum(reduced_allele, site_onehot))
        expand0 = cs0[site_ids]
        # site features route 2: per-site sum of compressed allele features
        cs1 = site_segment_sum(ca, site_onehot)
        expand1 = cs1[site_ids]
        xattn = self.net(f"xattn{idx}")
        logits = None if xattn is None else xattn((ca, (expand0, expand1)))
        return logits, (cs0, cs1), ca

    def forward(self, batch, folded=None):
        """Eval-mode forward -> {"experts": [A, 1] raw logits, "meta": None}.

        ``folded``: ``fold_read_convs()`` output (computed here when None)."""
        if folded is None:
            folded = self.fold_read_convs()
        packed = "rows0" in batch
        if packed:
            A = batch["read_mask0"].shape[0]
            rows = batch["rows0"]
            row_allele = batch["row_allele0"]
            row_valid = batch["row_valid0"]
        else:
            reads = batch["reads0"]
            A, R = reads.shape[:2]
            rows = reads.reshape((A * R,) + tuple(reads.shape[2:]))
            row_allele = torch.div(
                torch.arange(A * R, dtype=torch.int32, device=reads.device),
                R, rounding_mode="floor")
            row_valid = batch["read_mask0"].reshape(-1).float()
        S = batch["ref_segments"].shape[0]
        site_ids = batch["site_ids"].long()
        site_onehot = make_site_onehot(site_ids, batch["allele_mask"], S)
        reduced0 = read_conv_reduce(rows, row_allele, row_valid,
                                    folded["read_conv0"], A)
        e0, _, _ = self._compress_and_predict(0, reduced0, site_onehot,
                                              site_ids)
        return {"experts": e0, "meta": None}


def create_model(name_or_config) -> MoEAttention:
    """Create a model from a named config (illumina, pacbio, pacbio_hp) or an
    explicit config dict; hybrid configs raise until their slice lands."""
    if isinstance(name_or_config, str):
        config = archs.NAMED_CONFIGS[name_or_config]()
    else:
        config = name_or_config
    return MoEAttention(config)
