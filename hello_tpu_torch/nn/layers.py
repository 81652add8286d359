"""Config-driven torch networks (the port of hello_tpu's nn/layers.py).

Networks are declared as lists of ``{"type": ..., "kwargs": ...}`` dicts
(nn/archs.py, shared byte for byte with hello_tpu) and interpreted onto
``torch.nn.Module`` trees whose parameter names follow the reference torch
model tree — the same keys hello_tpu's ``export_state_dict`` (nn/export.py)
writes:

  * a network is ``Sequential.network.<i>``;
  * ``WeightNormedConv1d`` / ``WeightNormedLinear`` keep ``conv1d.`` /
    ``linear.`` prefixes with ``weight_v``, ``weight_g`` and ``bias``;
  * ``ResidualBlock`` holds ``ffNetwork`` and ``shNetwork``; ``Fork`` holds
    ``net<i>``.

So ``model.load_state_dict(sd, strict=True)`` is the weight bridge.

Public activations stay NWC ``[batch, length, channels]`` as in the JAX
package; the conv modules transpose to torch's NCW internally.  This slice
ports the layers the single-tech configs use; ``build_network`` raises
``NotImplementedError`` for the others.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: ROADMAP items named by the errors for what this slice does not port.
ROADMAP_LAYERS = "ROADMAP.md Queue 1 item 1 (layers not yet ported)"
ROADMAP_PRECISION = "ROADMAP.md Queue 1 (the default and bf16 precisions)"


def set_precision(precision: str):
    """Set fp32 math for every matmul and convolution ("highest": TF32 off
    in both cuBLAS and cuDNN), mirroring hello_tpu's set_precision.  The
    "default" and "bf16" modes are not ported yet and raise."""
    if precision != "highest":
        raise ValueError(
            f"precision {precision!r} is not ported yet; only 'highest' is "
            f"({ROADMAP_PRECISION})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kaiming_bound(fan_in: int) -> float:
    """torch's default conv/linear init bound, U(-b, b) with
    b = 1/sqrt(fan_in) (hello_tpu nn/layers.kaiming_uniform)."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


class Noop(nn.Module):
    """Identity placeholder; accepts and ignores arguments like the
    reference's Noop (configured with num_features in place of a norm)."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _WeightNorm(nn.Module):
    """``weight_v`` / ``weight_g`` / ``bias`` under the reference's names;
    ``weight()`` is ``g * v / ||v||`` with the norm per output row."""

    def __init__(self, v_shape, g_shape, bias: bool):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(v_shape))
        self.weight_g = nn.Parameter(torch.empty(g_shape))
        self.bias = nn.Parameter(torch.empty(v_shape[0])) if bias else None

    def weight(self):
        v = self.weight_v
        dims = tuple(range(1, v.dim()))
        norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
        return self.weight_g * v / norm


class _ConvBase(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, padding=0,
                 dilation=1, stride=1, groups=1, bias=True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.padding = padding
        self.dilation = dilation
        self.stride = stride
        self.groups = groups
        self.use_bias = bias

    @property
    def fan_in(self):
        return self.in_channels // self.groups * self.kernel_size

    def _conv(self, x, w, b):
        y = F.conv1d(x.transpose(1, 2), w, b, stride=self.stride,
                     padding=self.padding, dilation=self.dilation,
                     groups=self.groups)
        return y.transpose(1, 2)


class Conv1d(_ConvBase):
    """1-D convolution over NWC activations; ``weight`` is ``[Co, Ci/g, K]``."""

    def __init__(self, in_channels, out_channels, kernel_size, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, **kwargs)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // self.groups, kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels))
                     if self.use_bias else None)

    def forward(self, x):
        return self._conv(x, self.weight, self.bias)


class WeightNormedConv1d(_ConvBase):
    """Weight-normalised Conv1d, ``w = g * v / ||v||`` with the norm per
    output channel over (in-channel, kernel)."""

    def __init__(self, in_channels, out_channels, kernel_size, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, **kwargs)
        self.conv1d = _WeightNorm(
            (out_channels, in_channels // self.groups, kernel_size),
            (out_channels, 1, 1), self.use_bias)

    def forward(self, x):
        return self._conv(x, self.conv1d.weight(), self.conv1d.bias)


class Linear(nn.Module):
    """Dense layer; ``weight`` is ``[out, in]``."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class WeightNormedLinear(nn.Module):
    """Weight-normalised Linear; norm per output feature over the input."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.linear = _WeightNorm((out_features, in_features),
                                  (out_features, 1), bias)

    def forward(self, x):
        return F.linear(x, self.linear.weight(), self.linear.bias)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class MaxPool1d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        y = F.max_pool1d(x.transpose(1, 2), self.kernel_size, self.stride,
                         self.padding)
        return y.transpose(1, 2)


class AdaptiveAvgPool1d(nn.Module):
    """Only output_size=1 is used by the reference architectures."""

    def __init__(self, output_size=1):
        super().__init__()
        if output_size != 1:
            raise ValueError("only output_size=1 supported")

    def forward(self, x):
        return torch.mean(x, dim=1, keepdim=True)


class Flatten(nn.Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class SelectArgument(nn.Module):
    def __init__(self, select):
        super().__init__()
        self.select = select

    def forward(self, x):
        return x[self.select]


class LinearCombination(nn.Module):
    def __init__(self, coefficients):
        super().__init__()
        self.coefficients = coefficients

    def forward(self, x):
        result = 0.0
        for c, t in zip(self.coefficients, x):
            if c != 0 and t is not None:
                result = result + c * t
        return result


class Sequential(nn.Module):
    """Layers applied in order, held as ``network.<i>`` (the reference's
    Network container)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.network = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.network:
            x = layer(x)
        return x


class ResidualBlock(nn.Module):
    """feedforward(x) + shortcut(x) (reference NNTools.ResidualBlock)."""

    def __init__(self, feedforward: Sequential, shortcut: Sequential):
        super().__init__()
        self.ffNetwork = feedforward
        self.shNetwork = shortcut

    def forward(self, x):
        return self.ffNetwork(x) + self.shNetwork(x)


class Fork(nn.Module):
    """Apply net_i to args[i] and return the list of results."""

    def __init__(self, nets: Sequence[Sequential]):
        super().__init__()
        self.num_nets = len(nets)
        for i, net in enumerate(nets):
            self.add_module(f"net{i}", net)

    def forward(self, x):
        return [getattr(self, f"net{i}")(x[i]) for i in range(self.num_nets)]


# ---------------------------------------------------------------------------
# Config interpretation
# ---------------------------------------------------------------------------

_SIMPLE = {
    "Noop": Noop,
    "ReLU": ReLU,
    "Flatten": Flatten,
    "SelectArgument": SelectArgument,
    "LinearCombination": LinearCombination,
    "AdaptiveAvgPool1d": AdaptiveAvgPool1d,
}

# layer types hello_tpu builds that this slice does not port yet
_NOT_PORTED = {
    "BatchNorm1d", "LayerNormModule", "ELU", "SELU", "Sigmoid", "Softplus",
    "Tanh", "Softmax", "Dropout", "AvgPool1d", "GlobalPool", "Transposer",
    "ConcatenateChannels", "AdditiveLayer", "DotProduct", "Inception",
    "MultiheadAttention", "HelloEncoder",
}

_KW_DROP = {"inplace"}


def build_layer(spec: dict) -> nn.Module:
    """Build one layer from a ``{"type": ..., "kwargs": ...}`` spec."""
    ltype = spec["type"]
    kwargs = {k: v for k, v in (spec.get("kwargs") or {}).items()
              if k not in _KW_DROP}
    if ltype in ("Conv1d", "WeightNormedConv1d"):
        cls = Conv1d if ltype == "Conv1d" else WeightNormedConv1d
        return cls(kwargs["in_channels"], kwargs["out_channels"],
                   kwargs["kernel_size"], padding=kwargs.get("padding", 0),
                   dilation=kwargs.get("dilation", 1),
                   stride=kwargs.get("stride", 1),
                   groups=kwargs.get("groups", 1),
                   bias=kwargs.get("bias", True))
    if ltype in ("Linear", "WeightNormedLinear"):
        cls = Linear if ltype == "Linear" else WeightNormedLinear
        return cls(kwargs["in_features"], kwargs["out_features"],
                   bias=kwargs.get("bias", True))
    if ltype == "MaxPool1d":
        return MaxPool1d(kwargs["kernel_size"], stride=kwargs.get("stride"),
                         padding=kwargs.get("padding", 0))
    if ltype == "ResidualBlock":
        return ResidualBlock(build_network(kwargs["feedforward"]),
                             build_network(kwargs["shortcut"]))
    if ltype == "Fork":
        return Fork([build_network(a) for a in kwargs["net_args"]])
    if ltype in _SIMPLE:
        return _SIMPLE[ltype](**kwargs)
    if ltype in _NOT_PORTED:
        raise NotImplementedError(
            f"layer {ltype!r} is not ported to torch yet ({ROADMAP_LAYERS})")
    raise ValueError(f"Unknown layer type: {ltype}")


def build_network(config: Sequence[dict]) -> Sequential:
    """Build a Sequential from a list of layer specs."""
    return Sequential([build_layer(spec) for spec in config])
