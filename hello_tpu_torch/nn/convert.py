"""Weight bridge: hello_tpu parameter pytrees -> the port's torch modules.

hello_tpu keeps parameters as nested dicts of arrays (HIO conv weights
``[K, Ci, Co]``, linear weights ``[in, out]``, weight norm kept decomposed as
``v`` / ``g``).  ``state_dict_from_jax`` lays them out as the reference torch
model tree does — the same keys and layouts hello_tpu's nn/export.py
``export_state_dict`` writes — and the port's module tree uses exactly those
keys, so ``model.load_state_dict(sd, strict=True)`` is the bridge.

``jax_params_from_state_dict`` is the inverse, so checkpoints written by
either package load in the other; batch-norm statistics travel in
``state`` both ways.  Also here: the seeded init (``init_params``), loading
of hello_tpu pytree checkpoints, which are plain numpy pickles with
``{"params", "state"}`` keys (hello_tpu train/checkpoint.py), read without
JAX, and loading of the reference's torch files (``load_torch_checkpoint``:
``.wrapper.dnn`` whole-module pickles and state dicts), the port of
hello_tpu's nn/convert.py loader.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import layers as L

logger = logging.getLogger(__name__)

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


def _export_attention(params, prefix: str, out: Dict[str, np.ndarray]):
    """One MultiheadAttention block's params under the port's keys."""
    for name in ("q", "k", "v", "o"):
        out[f"{prefix}W_{name}"] = _np32(params[f"w_{name}"])
    for ln, key in (("layer_norm_attn", "ln_attn"),
                    ("layer_norm_linear", "ln_lin")):
        out[f"{prefix}{ln}.weight"] = _np32(params[key]["gamma"])
        out[f"{prefix}{ln}.bias"] = _np32(params[key]["beta"])
    out[prefix + "linear.0.weight"] = _np32(params["lin_w"]).transpose(1, 0)
    out[prefix + "linear.0.bias"] = _np32(params["lin_b"])


def _export_layer(layer, params, state, prefix: str,
                  out: Dict[str, np.ndarray]):
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
    elif isinstance(layer, L.LayerNormModule):
        out[prefix + "normer.weight"] = _np32(params["gamma"])
        out[prefix + "normer.bias"] = _np32(params["beta"])
    elif isinstance(layer, L.BatchNorm1d):
        out[prefix + "weight"] = _np32(params["gamma"])
        out[prefix + "bias"] = _np32(params["beta"])
        n = layer.num_features
        out[prefix + "running_mean"] = _np32(state.get("mean", np.zeros(n)))
        out[prefix + "running_var"] = _np32(state.get("var", np.ones(n)))
        # hello_tpu keeps no update count; its export writes 0
        out[prefix + "num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    elif isinstance(layer, L.MultiheadAttention):
        _export_attention(params, prefix, out)
    elif isinstance(layer, L.HelloEncoder):
        out[prefix + "embedding.weight"] = _np32(
            params["embed_w"]).transpose(1, 0)
        out[prefix + "embedding.bias"] = _np32(params["embed_b"])
        for i in range(len(layer.attention)):
            _export_attention(params[f"attn{i}"], f"{prefix}attention.{i}.",
                              out)
    elif isinstance(layer, L.ResidualBlock):
        for key, net in (("ff", layer.ffNetwork), ("sh", layer.shNetwork)):
            _export_sequential(net, params.get(key, {}), state.get(key, {}),
                               f"{prefix}{key}Network.network.", out)
    elif isinstance(layer, (L.Fork, L.Inception)):
        for key, net in _children(layer):
            _export_sequential(net, params.get(key, {}), state.get(key, {}),
                               f"{prefix}{key}.network.", out)
    elif params:
        raise NotImplementedError(
            f"no weight bridge for layer type {type(layer).__name__} at "
            f"{prefix!r} (it owns parameters)")


def _children(layer):
    """(key, Sequential) of a Fork's nets or an Inception's branches."""
    if isinstance(layer, L.Fork):
        return [(f"net{i}", getattr(layer, f"net{i}"))
                for i in range(layer.num_nets)]
    return [(f"branch{i}", getattr(layer, f"branch{i}"))
            for i in range(layer.num_branches)]


def _export_sequential(seq: L.Sequential, params, state, prefix, out):
    for i, layer in enumerate(seq.network):
        _export_layer(layer, params.get(str(i), {}), state.get(str(i), {}),
                      f"{prefix}{i}.", out)


def state_dict_from_jax(model, params, state) -> Dict[str, torch.Tensor]:
    """hello_tpu (params, state) as numpy arrays -> a state dict for
    ``model`` (keys, layouts and dtypes equal to hello_tpu's
    ``export_state_dict``; ``state`` holds the batch-norm statistics, and
    ``num_batches_tracked``, which hello_tpu does not keep, is 0).

    hello_tpu's export raises for the attention layers; their keys here are
    the port's own (nn/layers.MultiheadAttention and HelloEncoder):
    ``W_q`` / ``W_k`` / ``W_v`` / ``W_o`` as hello_tpu's ``w_q`` ... (both
    applied as ``x @ W``), ``layer_norm_attn`` / ``layer_norm_linear`` from
    ``ln_attn`` / ``ln_lin``, ``linear.0`` from ``lin_w`` (transposed) and
    ``lin_b``; ``embedding`` from ``embed_w`` (transposed) and ``embed_b``,
    and ``attention.<i>`` from ``attn<i>``."""
    out: Dict[str, np.ndarray] = {}
    for name, net in model.networks().items():
        if name in params:
            _export_sequential(net, params[name], (state or {}).get(name, {}),
                               f"{_TORCH_ATTR[name]}.network.", out)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _np_of(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _import_attention(sd, prefix: str):
    out = {f"w_{name}": _np_of(sd[f"{prefix}W_{name}"])
           for name in ("q", "k", "v", "o")}
    for ln, key in (("layer_norm_attn", "ln_attn"),
                    ("layer_norm_linear", "ln_lin")):
        out[key] = {"gamma": _np_of(sd[f"{prefix}{ln}.weight"]),
                    "beta": _np_of(sd[f"{prefix}{ln}.bias"])}
    out["lin_w"] = _np_of(sd[prefix + "linear.0.weight"]).transpose(1, 0)
    out["lin_b"] = _np_of(sd[prefix + "linear.0.bias"])
    return out


def _import_layer(layer, sd, prefix: str):
    """The hello_tpu (params, state) of one layer from the state dict ``sd``
    (the inverse of ``_export_layer``)."""
    if isinstance(layer, (L.WeightNormedConv1d, L.WeightNormedLinear)):
        conv = isinstance(layer, L.WeightNormedConv1d)
        p = prefix + ("conv1d." if conv else "linear.")
        v = _np_of(sd[p + "weight_v"])
        out = {"v": v.transpose(2, 1, 0) if conv else v.transpose(1, 0),
               "g": _np_of(sd[p + "weight_g"]).reshape(-1)}
        if p + "bias" in sd:
            out["b"] = _np_of(sd[p + "bias"])
        return out, {}
    if isinstance(layer, (L.Conv1d, L.Linear)):
        w = _np_of(sd[prefix + "weight"])
        out = {"w": w.transpose(2, 1, 0) if w.ndim == 3 else w.transpose(1, 0)}
        if prefix + "bias" in sd:
            out["b"] = _np_of(sd[prefix + "bias"])
        return out, {}
    if isinstance(layer, L.LayerNormModule):
        return {"gamma": _np_of(sd[prefix + "normer.weight"]),
                "beta": _np_of(sd[prefix + "normer.bias"])}, {}
    if isinstance(layer, L.BatchNorm1d):
        return ({"gamma": _np_of(sd[prefix + "weight"]),
                 "beta": _np_of(sd[prefix + "bias"])},
                {"mean": _np_of(sd[prefix + "running_mean"]),
                 "var": _np_of(sd[prefix + "running_var"])})
    if isinstance(layer, L.MultiheadAttention):
        return _import_attention(sd, prefix), {}
    if isinstance(layer, L.HelloEncoder):
        out = {"embed_w": _np_of(sd[prefix + "embedding.weight"]).transpose(1, 0),
               "embed_b": _np_of(sd[prefix + "embedding.bias"])}
        for i in range(len(layer.attention)):
            out[f"attn{i}"] = _import_attention(sd, f"{prefix}attention.{i}.")
        return out, {}
    if isinstance(layer, L.ResidualBlock):
        params, state = {}, {}
        for key, net in (("ff", layer.ffNetwork), ("sh", layer.shNetwork)):
            params[key], s = _import_sequential(
                net, sd, f"{prefix}{key}Network.network.")
            if s:
                state[key] = s
        return params, state
    if isinstance(layer, (L.Fork, L.Inception)):
        params, state = {}, {}
        for key, net in _children(layer):
            p, s = _import_sequential(net, sd, f"{prefix}{key}.network.")
            if p:
                params[key] = p
            if s:
                state[key] = s
        return params, state
    if any(True for _ in layer.parameters()):
        raise NotImplementedError(
            f"no weight bridge for layer type {type(layer).__name__} at "
            f"{prefix!r} (it owns parameters)")
    return {}, {}


def _import_sequential(seq: L.Sequential, sd, prefix):
    params, state = {}, {}
    for i, layer in enumerate(seq.network):
        p, s = _import_layer(layer, sd, f"{prefix}{i}.")
        if p:                       # hello_tpu keeps only non-empty entries
            params[str(i)] = p
        if s:
            state[str(i)] = s
    return params, state


def jax_params_from_state_dict(model, sd=None):
    """The inverse of ``state_dict_from_jax``: the model's state dict
    (default: its own) -> hello_tpu's ``(params, state)`` pytrees of float32
    numpy arrays, with the keys, nesting and layouts its ``model.init``
    gives (HIO conv weights, ``[in, out]`` linear weights, weight-norm ``g``
    per output channel, batch-norm ``mean`` / ``var`` in ``state``)."""
    sd = model.state_dict() if sd is None else sd
    params, state = {}, {}
    for name, net in model.networks().items():
        params[name], s = _import_sequential(net, sd,
                                             f"{_TORCH_ATTR[name]}.network.")
        if s:
            state[name] = s
    return params, state


@torch.no_grad()
def init_params(model: torch.nn.Module, generator: torch.Generator):
    """Seeded init, as hello_tpu's ``init`` draws it: every conv and linear
    weight and bias ~ U(-b, b) with b = 1/sqrt(fan_in), weight-norm ``g`` at
    ``||v||``; the attention layers' matrices with b = 1/sqrt(E) (the
    embedding's with its input width); norms at gamma 1 and beta 0, and
    batch-norm statistics at mean 0, var 1 and no update."""
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
        elif isinstance(m, (L.Linear, torch.nn.Linear)):
            uniform(m.weight, m.in_features)
            if m.bias is not None:
                uniform(m.bias, m.in_features)
            continue
        elif isinstance(m, L.MultiheadAttention):
            for name in ("W_q", "W_k", "W_v", "W_o"):
                uniform(getattr(m, name), m.embedding_dim)
            continue
        elif isinstance(m, (L.BatchNorm1d, torch.nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, L.BatchNorm1d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
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


# ---------------------------------------------------------------------------
# The reference's torch files (.wrapper.dnn, state-dict .pt / .pth)
# ---------------------------------------------------------------------------

def detect_prefix(sd: Mapping[str, object]) -> str:
    """The state-dict prefix of the model's networks: '' for a bare
    MoEAttention, 'moeMerged.' for the reference's inference wrapper
    (MoEMergedWrapperAdvanced), 'module.' for a DDP dump, and the two
    nestings of those (hello_tpu nn/convert.detect_prefix)."""
    for key in sd:
        for cand in ("moeMerged.module.", "module.moeMerged.", "moeMerged.",
                     "module.", ""):
            if key.startswith(cand + "read_convolver0."):
                return cand
    return ""


def convert_state_dict(sd: Mapping[str, object], model,
                       prefix: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A torch state dict of the reference's model tree (``prefix``
    stripped; default: ``detect_prefix``) -> the state dict for ``model``.

    A network the model configures and the file lacks entirely keeps the
    model's current weights, as hello_tpu's ``convert_state_dict`` skips it
    (a reference model with a deleted xattn), and is logged; so initialise
    the model first (``load_scorer`` does, from its seed).  Every other key
    loads strictly: a network that is in the file must have all its keys,
    with the model's shapes, and a key under ``prefix`` that belongs to no
    network of the model raises."""
    if prefix is None:
        prefix = detect_prefix(sd)
    own = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out, kept = {}, []
    for name, current in model.state_dict().items():
        net = name.split(".", 1)[0] + ".network."
        if not any(k.startswith(net) for k in own):
            out[name] = current
            if net not in kept:
                kept.append(net)
            continue
        if name not in own:
            raise KeyError(f"{prefix}{name} is missing from the file")
        value = own[name]
        value = (value.detach().cpu() if torch.is_tensor(value)
                 else torch.from_numpy(np.asarray(value)))
        if value.numel() == current.numel() == 1:
            # hello_tpu's save_torch_checkpoint writes the scalar
            # num_batches_tracked as a one-element vector
            value = value.reshape(current.shape)
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(value.shape)} "
                             f"in the file, {tuple(current.shape)} in the "
                             "model")
        out[name] = value.to(current.dtype)
    unknown = sorted(set(own) - set(out))
    if unknown:
        raise KeyError(f"the file holds keys the model does not: "
                       f"{[prefix + k for k in unknown[:5]]}"
                       f"{' ...' if len(unknown) > 5 else ''}")
    for net in kept:
        logger.warning("%s%s* is not in the file: the network keeps the "
                       "model's weights", prefix, net)
    return out


def load_torch_checkpoint(path: str, model,
                          reference_python: Optional[str] = None
                          ) -> Dict[str, torch.Tensor]:
    """Load a ``.wrapper.dnn`` / ``.pt`` / ``.pth`` torch file and return
    the state dict for ``model`` (``convert_state_dict``).

    The file is a whole-module pickle (the reference ships its models as
    ``torch.save``'d MoEMergedWrapperAdvanced modules, whose networks sit
    under ``moeMerged.``) or a bare state dict (the port's and hello_tpu's
    ``save_torch_checkpoint``).  Unpickling a whole module imports its
    classes and can run code, so load only files you trust.  The
    reference's classes import from its ``python/`` directory: put it on
    ``PYTHONPATH`` or pass it as ``reference_python``, which is on
    ``sys.path`` while the file loads (``load_scorer`` and the calling
    CLI's ``--reference_python`` pass it on); a class that does not import
    raises naming both."""
    injected = False
    if (reference_python and os.path.isdir(reference_python)
            and reference_python not in sys.path):
        sys.path.insert(0, reference_python)
        injected = True
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"{path} is a whole-module pickle whose classes do not import "
            f"({e}): put the reference's python/ directory on PYTHONPATH or "
            "pass it as reference_python (the calling CLI's "
            "--reference_python)", name=e.name) from e
    finally:
        if injected:
            sys.path.remove(reference_python)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return convert_state_dict(sd, model)
