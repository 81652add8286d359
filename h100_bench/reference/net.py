"""Plain PyTorch interpreter of the layer specs in ``archs.py``.

Each network is a list of ``{"type", "kwargs"}`` specs; its parameters are
read from a flat state dict under the port's key names (``<prefix>.network.
<i>.conv1d.weight_v`` and so on), which the benchmark makes from the seed
and hands to both sides.  Activations are NWC ``[batch, length, channels]``
float32.  Written from the layer equations of the reference architecture
(weight norm ``w = g v / ||v||`` per output row, NCW convs, residual sums,
global average pool, linear head), not from the port's modules.

``quant`` is the control's hook: a function applied to every conv's input,
weight and output (the places where the ``bf16`` precision rounds); the
identity for the fp32 reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x):
    return x


def _weight_norm(params, prefix):
    v = params[prefix + ".weight_v"]
    g = params[prefix + ".weight_g"]
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v.double() ** 2, dim=dims, keepdim=True))
    return g * v / norm.float(), params.get(prefix + ".bias")


def _conv(spec, params, prefix, x, quant):
    kw = spec["kwargs"]
    if spec["type"] == "WeightNormedConv1d":
        w, b = _weight_norm(params, prefix + ".conv1d")
    else:
        w, b = params[prefix + ".weight"], params.get(prefix + ".bias")
    y = F.conv1d(quant(x).transpose(1, 2), quant(w), b,
                 stride=kw.get("stride", 1), padding=kw.get("padding", 0),
                 dilation=kw.get("dilation", 1), groups=kw.get("groups", 1))
    return quant(y.transpose(1, 2))


def _linear(spec, params, prefix, x):
    if spec["type"] == "WeightNormedLinear":
        w, b = _weight_norm(params, prefix + ".linear")
    else:
        w, b = params[prefix + ".weight"], params.get(prefix + ".bias")
    return F.linear(x, w, b)


def run_layer(spec, params, prefix, x, quant=identity):
    t = spec["type"]
    kw = spec.get("kwargs") or {}
    if t in ("Conv1d", "WeightNormedConv1d"):
        return _conv(spec, params, prefix, x, quant)
    if t in ("Linear", "WeightNormedLinear"):
        return _linear(spec, params, prefix, x)
    if t in ("Noop", "Transposer"):
        return x
    if t == "ReLU":
        return torch.relu(x)
    if t == "MaxPool1d":
        return F.max_pool1d(x.transpose(1, 2), kw["kernel_size"],
                            kw.get("stride") or kw["kernel_size"],
                            kw.get("padding", 0)).transpose(1, 2)
    if t == "AdaptiveAvgPool1d":
        return x.mean(dim=1, keepdim=True)
    if t == "Flatten":
        return x.reshape(x.shape[0], -1)
    if t == "SelectArgument":
        return x[kw["select"]]
    if t == "LinearCombination":
        out = 0.0
        for c, term in zip(kw["coefficients"], x):
            if c != 0 and term is not None:
                out = out + c * term
        return out
    if t == "ConcatenateChannels":
        return torch.cat([term for term in x if term is not None], dim=-1)
    if t == "Fork":
        return [run_network(net, params, f"{prefix}.net{i}", x[i], quant)
                for i, net in enumerate(kw["net_args"])]
    if t == "ResidualBlock":
        return (run_network(kw["feedforward"], params,
                            prefix + ".ffNetwork", x, quant)
                + run_network(kw["shortcut"], params, prefix + ".shNetwork",
                              x, quant))
    raise ValueError(f"the plain reference has no layer {t!r}: add its "
                     "equations here with the configuration that needs it")


def run_network(specs, params, prefix, x, quant=identity):
    """Network ``specs`` on ``x`` with the parameters under ``prefix``."""
    for i, spec in enumerate(specs):
        x = run_layer(spec, params, f"{prefix}.network.{i}", x, quant)
    return x


def param_shapes(specs, prefix, out=None) -> dict:
    """{state-dict key: shape} of the parameters of network ``specs``."""
    out = {} if out is None else out
    for i, spec in enumerate(specs):
        p, t = f"{prefix}.network.{i}", spec["type"]
        kw = spec.get("kwargs") or {}
        if t in ("Conv1d", "WeightNormedConv1d"):
            w = (kw["out_channels"], kw["in_channels"] // kw.get("groups", 1),
                 kw["kernel_size"])
            base = p + ".conv1d" if t == "WeightNormedConv1d" else p
        elif t in ("Linear", "WeightNormedLinear"):
            w = (kw["out_features"], kw["in_features"])
            base = p + ".linear" if t == "WeightNormedLinear" else p
        elif t == "ResidualBlock":
            param_shapes(kw["feedforward"], p + ".ffNetwork", out)
            param_shapes(kw["shortcut"], p + ".shNetwork", out)
            continue
        elif t == "Fork":
            for j, net in enumerate(kw["net_args"]):
                param_shapes(net, f"{p}.net{j}", out)
            continue
        else:
            continue
        if t.startswith("WeightNormed"):
            out[base + ".weight_v"] = w
            out[base + ".weight_g"] = (w[0],) + (1,) * (len(w) - 1)
        else:
            out[base + ".weight"] = w
        if kw.get("bias", True):
            out[base + ".bias"] = (w[0],)
    return out
