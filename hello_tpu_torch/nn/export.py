"""Export the port's weights as a reference-compatible torch state dict.

The port of hello_tpu's nn/export.py.  The port's module tree already uses
the reference's keys and layouts (nn/layers.py), so its state dict is the
export: ``weight_v`` / ``weight_g`` for weight norm, ``running_mean`` /
``running_var`` / ``num_batches_tracked`` for batch norm, ``normer.`` for
LayerNorm.  A file ``save_torch_checkpoint`` writes loads into hello_tpu's
``load_torch_checkpoint``, and hello_tpu's file loads into the port's
(nn/convert.load_torch_checkpoint).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def export_state_dict(model) -> Dict[str, np.ndarray]:
    """The model's weights and batch-norm buffers as numpy arrays under the
    reference's keys (float32; ``num_batches_tracked`` int64)."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def save_torch_checkpoint(path: str, model) -> str:
    """Save the model's state dict as a torch file (CPU tensors)."""
    torch.save({k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}, path)
    return path
