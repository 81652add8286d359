"""Transfer learning: build-on-top parameter grafting over state dicts.

A model built with addendum blocks reuses a trained base model's parameters
for the shared prefix of every network; the appended addendum layers keep
their fresh initialisation and are the (primary) training target.  The port
of hello_tpu's train/transfer.py: the same grafting, keyed by the state
dicts' ``<network>.network.<i>.`` prefixes instead of pytree indices.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..nn.convert import _TORCH_ATTR
from ..nn.moe import MoEAttention


def build_on_top(base_model: MoEAttention, base_sd: Dict[str, torch.Tensor],
                 extended_model: MoEAttention,
                 extended_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copy base parameters onto the shared layer prefix of an extended
    model.

    Layer alignment is by Sequential index: the extended network's first
    ``len(base)`` layers must match the base network layer for layer.
    Returns the grafted state dict for the extended model."""
    out = dict(extended_sd)
    ext_nets = extended_model.networks()
    for name, base_net in base_model.networks().items():
        ext_net = ext_nets.get(name)
        if ext_net is None:
            raise ValueError(f"extended model missing network {name}")
        if len(ext_net.network) < len(base_net.network):
            raise ValueError(f"{name}: the extended network has fewer layers "
                             "than the base")
        for i in range(len(base_net.network)):
            prefix = f"{_TORCH_ATTR[name]}.network.{i}."
            for k, v in base_sd.items():
                if k.startswith(prefix):
                    if k not in out or out[k].shape != v.shape:
                        raise ValueError(f"{k}: the extended model's layer "
                                         "does not match the base's")
                    out[k] = v
    return out
