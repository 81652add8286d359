"""Weight bridge: hello_tpu parameter pytrees -> the port's torch modules.

hello_tpu keeps parameters as nested dicts of arrays (HIO conv weights
``[K, Ci, Co]``, linear weights ``[in, out]``, weight norm kept decomposed as
``v`` / ``g``).  ``state_dict_from_jax`` lays them out as the reference torch
model tree does — the same keys and layouts hello_tpu's nn/export.py
``export_state_dict`` writes — and the port's module tree uses exactly those
keys, so ``model.load_state_dict(sd, strict=True)`` is the bridge.

``jax_params_from_state_dict`` is the inverse, so checkpoints written by
either package load in the other.  Also here: the seeded init
(``init_params``) and loading of hello_tpu pytree checkpoints, which are
plain numpy pickles with ``{"params", "state"}`` keys (hello_tpu
train/checkpoint.py), read without JAX.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from . import layers as L

# network name -> torch attribute name on MoEAttention (reference model tree)
_TORCH_ATTR = {
    "read_conv0": "read_convolver0",
    "read_conv1": "read_convolver1",
    "compressor0": "compressor0",
    "compressor1": "compressor1",
    "compressor2": "compressor2",
    "xattn0": "xattn0",
    "xattn1": "xattn1",
    "xattn2": "xattn2",
    "combiner0": "combiner0",
    "combiner1": "combiner1",
    "meta": "meta",
}


def _np32(x):
    return np.asarray(x, dtype=np.float32)


def _export_layer(layer, params, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(layer, L.WeightNormedConv1d):
        out[prefix + "conv1d.weight_v"] = _np32(params["v"]).transpose(2, 1, 0)
        out[prefix + "conv1d.weight_g"] = _np32(params["g"]).reshape(-1, 1, 1)
        if "b" in params:
            out[prefix + "conv1d.bias"] = _np32(params["b"])
    elif isinstance(layer, L.Conv1d):
        out[prefix + "weight"] = _np32(params["w"]).transpose(2, 1, 0)
        if "b" in params:
            out[prefix + "bias"] = _np32(params["b"])
    elif isinstance(layer, L.WeightNormedLinear):
        out[prefix + "linear.weight_v"] = _np32(params["v"]).transpose(1, 0)
        out[prefix + "linear.weight_g"] = _np32(params["g"]).reshape(-1, 1)
        if "b" in params:
            out[prefix + "linear.bias"] = _np32(params["b"])
    elif isinstance(layer, L.Linear):
        out[prefix + "weight"] = _np32(params["w"]).transpose(1, 0)
        if "b" in params:
            out[prefix + "bias"] = _np32(params["b"])
    elif isinstance(layer, L.ResidualBlock):
        _export_sequential(layer.ffNetwork, params.get("ff", {}),
                           prefix + "ffNetwork.network.", out)
        _export_sequential(layer.shNetwork, params.get("sh", {}),
                           prefix + "shNetwork.network.", out)
    elif isinstance(layer, L.Fork):
        for i in range(layer.num_nets):
            _export_sequential(getattr(layer, f"net{i}"),
                               params.get(f"net{i}", {}),
                               prefix + f"net{i}.network.", out)
    elif params:
        raise NotImplementedError(
            f"no weight bridge for layer type {type(layer).__name__} at "
            f"{prefix!r} (it owns parameters)")


def _export_sequential(seq: L.Sequential, params, prefix, out):
    for i, layer in enumerate(seq.network):
        _export_layer(layer, params.get(str(i), {}), f"{prefix}{i}.", out)


def state_dict_from_jax(model, params, state) -> Dict[str, torch.Tensor]:
    """hello_tpu (params, state) as numpy arrays -> a state dict for ``model``
    (keys and layouts equal to hello_tpu's ``export_state_dict``).

    ``state`` holds batch-norm statistics in hello_tpu; the layers this slice
    ports have none, so a non-empty state raises."""
    if any(state.get(name) for name in model.networks()):
        raise NotImplementedError(
            f"batch-norm state is not ported yet ({L.ROADMAP_LAYERS})")
    out: Dict[str, np.ndarray] = {}
    for name, net in model.networks().items():
        if name in params:
            _export_sequential(net, params[name],
                               f"{_TORCH_ATTR[name]}.network.", out)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _np_of(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _import_layer(layer, sd, prefix: str):
    """The hello_tpu params of one layer from the state dict ``sd`` (the
    inverse of ``_export_layer``)."""
    if isinstance(layer, (L.WeightNormedConv1d, L.WeightNormedLinear)):
        conv = isinstance(layer, L.WeightNormedConv1d)
        p = prefix + ("conv1d." if conv else "linear.")
        v = _np_of(sd[p + "weight_v"])
        out = {"v": v.transpose(2, 1, 0) if conv else v.transpose(1, 0),
               "g": _np_of(sd[p + "weight_g"]).reshape(-1)}
        if p + "bias" in sd:
            out["b"] = _np_of(sd[p + "bias"])
        return out
    if isinstance(layer, (L.Conv1d, L.Linear)):
        w = _np_of(sd[prefix + "weight"])
        out = {"w": w.transpose(2, 1, 0) if w.ndim == 3 else w.transpose(1, 0)}
        if prefix + "bias" in sd:
            out["b"] = _np_of(sd[prefix + "bias"])
        return out
    if isinstance(layer, L.ResidualBlock):
        return {"ff": _import_sequential(layer.ffNetwork, sd,
                                         prefix + "ffNetwork.network."),
                "sh": _import_sequential(layer.shNetwork, sd,
                                         prefix + "shNetwork.network.")}
    if isinstance(layer, L.Fork):
        out = {}
        for i in range(layer.num_nets):
            p = _import_sequential(getattr(layer, f"net{i}"), sd,
                                   prefix + f"net{i}.network.")
            if p:
                out[f"net{i}"] = p
        return out
    if any(True for _ in layer.parameters()):
        raise NotImplementedError(
            f"no weight bridge for layer type {type(layer).__name__} at "
            f"{prefix!r} (it owns parameters)")
    return {}


def _import_sequential(seq: L.Sequential, sd, prefix):
    out = {}
    for i, layer in enumerate(seq.network):
        p = _import_layer(layer, sd, f"{prefix}{i}.")
        if p:                       # hello_tpu keeps only non-empty entries
            out[str(i)] = p
    return out


def jax_params_from_state_dict(model, sd=None):
    """The inverse of ``state_dict_from_jax``: the model's state dict
    (default: its own) -> hello_tpu's ``(params, state)`` pytrees of float32
    numpy arrays, with the keys, nesting and layouts its ``model.init``
    gives (HIO conv weights, ``[in, out]`` linear weights, weight-norm ``g``
    per output channel).  ``state`` is empty: the ported layers keep no
    batch-norm statistics."""
    sd = model.state_dict() if sd is None else sd
    params = {name: _import_sequential(net, sd,
                                       f"{_TORCH_ATTR[name]}.network.")
              for name, net in model.networks().items()}
    return params, {}


@torch.no_grad()
def init_params(model: torch.nn.Module, generator: torch.Generator):
    """Seeded torch-default init: every weight and bias ~ U(-b, b) with
    b = 1/sqrt(fan_in); weight-norm ``g`` starts at ``||v||``."""
    def uniform(t, fan_in):
        b = L.kaiming_bound(fan_in)
        t.uniform_(-b, b, generator=generator)

    for m in model.modules():
        if isinstance(m, L.WeightNormedConv1d):
            p, fan_in = m.conv1d, m.fan_in
        elif isinstance(m, L.WeightNormedLinear):
            p, fan_in = m.linear, m.in_features
        elif isinstance(m, L.Conv1d):
            uniform(m.weight, m.fan_in)
            if m.bias is not None:
                uniform(m.bias, m.fan_in)
            continue
        elif isinstance(m, L.Linear):
            uniform(m.weight, m.in_features)
            if m.bias is not None:
                uniform(m.bias, m.in_features)
            continue
        else:
            continue
        uniform(p.weight_v, fan_in)
        dims = tuple(range(1, p.weight_v.dim()))
        p.weight_g.copy_(torch.sqrt(torch.sum(p.weight_v * p.weight_v,
                                              dim=dims, keepdim=True)))
        if p.bias is not None:
            uniform(p.bias, fan_in)
    return model


class _Opaque:
    """Stand-in for classes a checkpoint pickles beside the parameters
    (optimizer state); only ``params`` and ``state`` are read."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    _ALLOWED = ("numpy", "builtins", "collections", "copyreg")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return _Opaque


def load_jax_checkpoint(path: str, model) -> Mapping[str, torch.Tensor]:
    """Read a hello_tpu pytree checkpoint (numpy pickle written by its
    train/checkpoint.save_checkpoint) and return the state dict for
    ``model``."""
    with open(path, "rb") as fh:
        payload = _CheckpointUnpickler(fh).load()
    return state_dict_from_jax(model, payload["params"], payload["state"])
