"""Checkpoints: hello_tpu's payload, written and read without JAX.

A checkpoint is a pickle of ``{"params", "state", "opt_state", "step",
"extra"}`` written atomically, as hello_tpu's train/checkpoint.py writes it.
``params`` and ``state`` are hello_tpu's pytrees of float32 numpy arrays
(nn/convert.jax_params_from_state_dict), so hello_tpu's ``load_checkpoint``
and ``load_scorer`` read the port's checkpoints, and the port reads
hello_tpu's (nn/convert.load_jax_checkpoint).  No torch tensor and no torch
class goes into the pickle: the port's optimiser moments are a plain dict of
numpy arrays keyed by state-dict name (train/trainer.Optimizer.state_dict),
which only the port loads; hello_tpu's ``opt_state`` pickles optax classes,
which the port reads as opaque stand-ins.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

from ..nn.convert import _CheckpointUnpickler


def save_checkpoint(path: str, params, state, opt_state=None, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None):
    """Save a training/inference checkpoint atomically (``params`` and
    ``state``: hello_tpu pytrees of numpy arrays)."""
    payload = {
        "params": params,
        "state": state,
        "opt_state": opt_state,
        "step": int(step),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_full_checkpoint(path: str) -> Dict[str, Any]:
    """The whole payload; classes other than numpy's and the builtins (an
    optax ``opt_state``) load as opaque stand-ins."""
    with open(path, "rb") as fh:
        return _CheckpointUnpickler(fh).load()


def load_checkpoint(path: str) -> Tuple[Any, Any]:
    """Load (params, state) from a checkpoint file."""
    payload = load_full_checkpoint(path)
    return payload["params"], payload["state"]
