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
    ``net<i>``; ``Inception`` holds ``branch<i>``;
  * ``BatchNorm1d`` keeps ``weight`` / ``bias`` and the buffers
    ``running_mean`` / ``running_var`` / ``num_batches_tracked``;
    ``LayerNormModule`` keeps ``normer.weight`` / ``normer.bias``.

So ``model.load_state_dict(sd, strict=True)`` is the weight bridge.

Public activations stay NWC ``[batch, length, channels]`` as in the JAX
package; the conv modules transpose to torch's NCW internally.  Every layer
type hello_tpu builds is ported; ``build_network`` raises ``ValueError``
for an unknown one.  Train-mode batch-norm statistics are weighted by the
row mask of ``bn_batch_mask`` (hello_tpu's ``set_bn_batch_mask``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_bf16

#: the precisions of hello_tpu's set_precision
PRECISIONS = ("highest", "high", "default", "bf16")

#: Matmul/conv precision, one of PRECISIONS.  "highest" and "high" are fp32
#: math (TF32 off in cuBLAS and cuDNN; the read-conv kernel's 3xTF32 route);
#: "default" allows single-pass TF32, what XLA's DEFAULT means on a GPU (the
#: kernel's 1xTF32 route); "bf16" carries conv activations in bfloat16 (the
#: kernel's bf16 route): a conv rounds its fp32 input and its weight to
#: bf16, multiplies them exactly, accumulates in fp32, adds the fp32 bias
#: and rounds the result to bf16 once (in train mode it rounds the sum,
#: then adds the bf16 bias, as hello_tpu's training conv).  Its Linear
#: layers may take TF32 (cuBLAS), as at "default".  On the card its
#: eval-mode convs run ops/conv_bf16's wgmma kernel (bf16 products, fp32
#: sums); its other convs (train mode, and the CPU's) run with cuDNN's
#: TF32 off: cuDNN's TF32 kernels keep those products exact but sum them
#: less accurately than its fp32 kernels, and round more outputs to the
#: other bf16 neighbour (python -m hello_tpu_torch.pipeline.bf16_conv_check).
#: Linear outputs (the expert logits) stay fp32.  Switch with
#: set_precision().
PRECISION = "highest"

#: Conv activation dtype; None keeps float32 activations.
ACT_DTYPE = None


def set_precision(precision: str):
    """Set the global matmul/conv precision, as hello_tpu's set_precision:
    'highest' / 'high' (fp32 math, TF32 off), 'default' (TF32 allowed in
    cuBLAS and cuDNN) or 'bf16' (bf16 conv activations; TF32 allowed in
    cuBLAS, not in cuDNN, whose fp32 kernels sum the exact products of the
    convs' bf16-valued operands more accurately than its TF32 kernels; on
    the card every eval-mode conv runs ops/conv_bf16's kernel instead,
    ``takes_conv_kernel``)."""
    global PRECISION, ACT_DTYPE
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{', '.join(PRECISIONS)}")
    ACT_DTYPE = torch.bfloat16 if precision == "bf16" else None
    PRECISION = precision
    torch.backends.cuda.matmul.allow_tf32 = precision in ("default", "bf16")
    torch.backends.cudnn.allow_tf32 = precision == "default"


def conv1d_bf16(x, w, b, stride=1, padding=0, dilation=1, groups=1):
    """[N, Ci, L] x [Co, Ci/g, K] conv of bf16-valued fp32 tensors: every
    product is exact, the sum is taken in fp32 (``set_precision("bf16")``
    keeps cuDNN's TF32 off, whose sums are less accurate), the fp32 bias
    is added after and the result is left unrounded (fp32).  The bf16
    activation route of the layers' convs on the CPU and in train mode
    (on the card an eval-mode conv runs ``ops.conv_bf16``'s kernel), and
    of the read-conv kernel's plain version."""
    y = F.conv1d(x, w, None, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y if b is None else y + b[None, :, None]


def takes_conv_kernel(training: bool, dtype, device) -> bool:
    """Whether a conv runs ``ops.conv_bf16``'s kernel: in eval mode, at
    bf16 activations, on a CUDA tensor.  Train mode (which rounds the sum
    before a bf16 bias and needs gradients), the fp32 precisions and the
    CPU keep ``F.conv1d`` / ``conv1d_bf16``."""
    return (not training and dtype == torch.bfloat16
            and torch.device(device).type == "cuda")


class _RoundTo(torch.autograd.Function):
    """An fp32 tensor rounded to ``dtype`` and returned as fp32, whose
    gradient passes unrounded.  hello_tpu's jitted training step casts the
    weights and an fp32 input to bf16 before a conv, and the transpose of
    each cast would round the fp32 gradient to bf16 and back; XLA drops
    that round trip (its excess precision), so the weight's and the fp32
    input's gradients are fp32 sums."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


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
        """The effective weight.  The norm's sum of squares is taken in
        float64 and its root rounded once to fp32, so the weight is the
        same on every device whatever its reduction order (and, wherever
        the fp32 sum is exact, bit-equal to hello_tpu's); at bf16 a weight
        that differed in its last fp32 bit could round to another bf16
        value."""
        v = self.weight_v
        dims = tuple(range(1, v.dim()))
        norm = torch.sqrt(torch.sum(v.double() ** 2, dim=dims,
                                    keepdim=True)).float()
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
        """NWC conv.  With bf16 activations the conv multiplies the bf16
        input by the bf16-rounded weight exactly and sums in fp32: in eval
        mode on the card in ``ops.conv_bf16``'s kernel, which reads and
        writes bf16 NWC and has no backward (``takes_conv_kernel``; so it
        runs with gradients off), elsewhere as an fp32 conv of the
        bf16-valued operands (``conv1d_bf16``; cuDNN's TF32 is off at
        bf16).  In eval mode the fp32 bias is added and the sum is rounded
        to bf16 once, where hello_tpu's conv accumulates in fp32 and rounds
        after its bias (hello_tpu nn/layers.py Conv1d.apply).  In train
        mode the sum is rounded to bf16 first and the bias, rounded to
        bf16, is added in bf16, as hello_tpu's training conv (its output in
        bf16) does.  The gradients follow hello_tpu's jitted step: a bf16
        input's is rounded to bf16 once from its fp32 sum, the weight's and
        an fp32 input's stay fp32 (``_RoundTo``), and the bias's is the fp32
        sum of the bf16 cotangent rounded to bf16 once (XLA on the CPU
        accumulates that sum in bf16 and lands a few bf16 ulps away)."""
        dtype = ACT_DTYPE if x.dtype == torch.float32 else x.dtype
        if dtype in (None, torch.float32):
            y = F.conv1d(x.transpose(1, 2), w, b, stride=self.stride,
                         padding=self.padding, dilation=self.dilation,
                         groups=self.groups)
            return y.transpose(1, 2)
        train = self.training
        if takes_conv_kernel(train, dtype, x.device):
            if torch.is_grad_enabled() and (x.requires_grad
                                            or w.requires_grad):
                raise RuntimeError(
                    "an eval-mode bf16 conv on the card runs ops/conv_bf16's "
                    "kernel, which has no backward: call it under "
                    "torch.no_grad() or torch.inference_mode(), or train")
            return conv_bf16.conv1d_bf16_nwc(
                x.to(dtype), w, b, stride=self.stride, padding=self.padding,
                dilation=self.dilation, groups=self.groups)
        xf = _RoundTo.apply(x, dtype) if x.dtype == torch.float32 \
            else x.float()
        y = conv1d_bf16(xf.transpose(1, 2), _RoundTo.apply(w, dtype),
                        None if train else b, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups).to(dtype)
        if train and b is not None:
            y = y + b.to(dtype)[None, :, None]
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
        # a bf16 activation is promoted to fp32 (exact), as jnp.dot does
        return F.linear(x.float(), self.weight, self.bias)


class WeightNormedLinear(nn.Module):
    """Weight-normalised Linear; norm per output feature over the input."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.linear = _WeightNorm((out_features, in_features),
                                  (out_features, 1), bias)

    def forward(self, x):
        return F.linear(x.float(), self.linear.weight(), self.linear.bias)


_EPS_BN = 1e-5

# the row mask of train-mode batch-norm statistics (bn_batch_mask), per thread
_BN_MASK = threading.local()


@contextlib.contextmanager
def bn_batch_mask(mask):
    """Weight train-mode batch-norm statistics by ``mask`` ([B] in {0, 1},
    the batch axis of the network applied inside the block): padded rows
    must not move the batch mean and variance.  ``None`` gives plain
    statistics.  The counterpart of hello_tpu's ``set_bn_batch_mask``, set
    around each network apply; the previous mask is restored on exit."""
    saved = getattr(_BN_MASK, "mask", None)
    _BN_MASK.mask = mask
    try:
        yield
    finally:
        _BN_MASK.mask = saved


class BatchNorm1d(nn.Module):
    """BatchNorm over the channel axis (last in NWC), on 2-D ``[B, C]`` or
    3-D ``[B, L, C]`` input: biased batch statistics for the output, the
    unbiased variance for the running update (momentum 0.1), eps 1e-5.  In
    train mode the statistics are weighted by ``bn_batch_mask`` when its
    length is the batch's, as hello_tpu computes them, and the running
    buffers are updated in place (``num_batches_tracked`` counts the
    updates); eval mode uses the running buffers.  A bf16 input is
    normalised by one fp32 scale and shift applied in bf16."""

    def __init__(self, num_features, momentum=0.1, eps=_EPS_BN):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def _batch_stats(self, x):
        """(mean, biased var, unbiased var) over every axis but the last."""
        dims = tuple(range(x.dim() - 1))
        mask = getattr(_BN_MASK, "mask", None)
        if mask is not None and mask.shape[0] == x.shape[0]:
            m = mask.float()
            mb = m.reshape((-1,) + (1,) * (x.dim() - 1))
            per_row = math.prod(x.shape[1:-1])
            count = torch.clamp(m.sum() * per_row, min=1.0)
            xf = x.float()
            mean = torch.sum(xf * mb, dim=dims) / count
            var = torch.sum((xf - mean) ** 2 * mb, dim=dims) / count
            return mean, var, var * (count / torch.clamp(count - 1.0, min=1.0))
        # jnp.mean / jnp.var keep the input's dtype
        mean = torch.mean(x.float(), dim=dims).to(x.dtype)
        var = torch.var(x.float(), dim=dims, unbiased=False).to(x.dtype)
        n = math.prod(x.shape[:-1])
        return mean, var, var * (n / max(n - 1, 1))

    def forward(self, x):
        if self.training:
            mean, var, unbiased = self._batch_stats(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.float())
                self.running_var.mul_(1 - m).add_(m * unbiased.float())
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        if x.dtype != torch.float32:
            # a bf16 batch variance plus eps rounds to bf16, its rsqrt is
            # taken in fp32 and left unrounded, as in hello_tpu's jitted
            # step (torch's bf16 rsqrt rounds twice on the CPU)
            rs = torch.rsqrt((var + self.eps).float()) * self.weight
            return x * rs.to(x.dtype) + (self.bias - mean * rs).to(x.dtype)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _layer_norm(x, weight, bias, eps=1e-5):
    """LayerNorm over the last axis with hello_tpu's cast points: the
    statistics in the input's dtype, then the fp32 affine (so a bf16 input
    comes out fp32, as ``x * gamma`` promotes in jnp)."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNormModule(nn.Module):
    """LayerNorm over channels (last axis); ``normer.weight`` /
    ``normer.bias`` as the reference's LayerNormModule."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.num_features = num_features
        self.normer = nn.LayerNorm(num_features, eps=eps)

    def forward(self, x):
        return _layer_norm(x, self.normer.weight, self.normer.bias,
                           self.normer.eps)


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


class ELU(nn.Module):
    def __init__(self, alpha=1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(nn.Module):
    def forward(self, x):
        return F.selu(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return torch.sigmoid(x)


class _LogAddExp0(torch.autograd.Function):
    """``logaddexp(x, 0)`` as jnp computes it, ``max(x, 0) +
    log1p(exp(-|x|))``, with the derivative of its JAX rule, ``exp(x -
    logaddexp(x, 0))``: each step rounded to the input's dtype, so a bf16
    gradient rounds where hello_tpu's does (autograd through the forward's
    steps rounds otherwise in half of the bf16 values)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        return grad * torch.exp(x - y)


class Softplus(nn.Module):
    """torch.nn.Softplus: ``log(1 + exp(beta x)) / beta``, and ``x`` itself
    where ``beta x`` exceeds the threshold (the layer_norm config's
    activation).  Computed as hello_tpu's ``jax.nn.softplus`` (jnp's
    ``logaddexp(beta x, 0)``, ``_LogAddExp0``), each step rounded to the
    input's dtype, so bf16 activations round where hello_tpu's do (one
    fused rounding differs in ~15% of bf16 values)."""

    def __init__(self, beta=1.0, threshold=20.0):
        super().__init__()
        self.beta = beta
        self.threshold = threshold

    def forward(self, x):
        bx = self.beta * x
        soft = _LogAddExp0.apply(bx)
        return torch.where(bx > self.threshold, x, soft / self.beta)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class Softmax(nn.Module):
    """Softmax as ``jax.nn.softmax`` computes it: ``exp(x - max)`` over its
    sum, each step rounded to the input's dtype (at bf16 a fused softmax
    rounds once, some values an ulp or more away)."""

    def __init__(self, dim=-1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        e = torch.exp(x - torch.amax(x, dim=self.dim, keepdim=True))
        return e / torch.sum(e, dim=self.dim, keepdim=True)


def dropout_with_mask(x, keep, p):
    """Dropout with a given keep mask: kept entries divided by ``1 - p``
    (rounded to the input's dtype first, as jnp rounds the weak-typed
    scalar), the others 0 (hello_tpu's ``jnp.where(keep, x / (1 - p),
    0)``)."""
    scale = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


class Dropout(nn.Module):
    """Dropout in train mode, the identity in eval mode.  The keep mask is
    drawn from ``generator`` (a ``torch.Generator``; the default generator
    of the input's device when None), so it cannot match hello_tpu's
    ``jax.random`` draw; ``dropout_with_mask`` applies a given mask."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        g = self.generator
        u = torch.rand(x.shape, generator=g,
                       device=x.device if g is None else g.device)
        return dropout_with_mask(x, u.to(x.device) >= self.p, self.p)


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


class AvgPool1d(nn.Module):
    """torch AvgPool1d with count_include_pad=True (divisor = kernel)."""

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size
        self.padding = padding

    def forward(self, x):
        y = F.avg_pool1d(x.transpose(1, 2), self.kernel_size, self.stride,
                         self.padding, count_include_pad=True)
        return y.transpose(1, 2)


class GlobalPool(nn.Module):
    """Sum over the length axis (the reference's GlobalPool)."""

    def forward(self, x):
        return torch.sum(x, dim=1)


class AdditiveLayer(nn.Module):
    def forward(self, x):
        return x[0] + x[1]


class DotProduct(nn.Module):
    """Scaled dot product of two vector batches -> [B, 1]."""

    def forward(self, x):
        a, b = x
        return torch.sum(a * b, dim=-1, keepdim=True) / math.sqrt(a.shape[-1])


def positional_encoding(length, feature_size, dtype=torch.float32,
                        device=None):
    """Sinusoidal positional encoding [length, feature_size]: the sines of
    every position times ``10000^(-2i/feature_size)``, then the cosines
    (concatenated, not interleaved, as the reference's PositionalEncoding)."""
    stepper = 1.0 / (10000 ** (torch.arange(0, feature_size, 2, dtype=dtype,
                                            device=device) / feature_size))
    args = torch.arange(length, dtype=dtype, device=device)[:, None] \
        * stepper[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


class MultiheadAttention(nn.Module):
    """Bidirectional multi-head attention block over ``[B, L, E]``, with the
    reference's quirk of applying no softmax to the scaled ``q k^T`` scores,
    a residual LayerNorm, and a Linear+ReLU feed-forward with its own
    residual LayerNorm.  Parameters under the reference's names: ``W_q``,
    ``W_k``, ``W_v``, ``W_o`` (``[E, E]``, applied as ``x @ W``),
    ``layer_norm_attn``, ``linear.0`` (a torch Linear) and
    ``layer_norm_linear``.  The products are plain matmuls under the
    precision's TF32 switches, hello_tpu's ``jnp.dot``; a bf16 input is
    promoted to fp32, as ``jnp.dot`` with fp32 weights promotes it."""

    def __init__(self, head_dim, n_heads, embedding_dim, add_positional=False):
        super().__init__()
        if n_heads * head_dim != embedding_dim:
            raise ValueError(f"{n_heads} heads of {head_dim} do not make "
                             f"embedding_dim {embedding_dim}")
        self.head_dim = head_dim
        self.n_heads = n_heads
        self.embedding_dim = embedding_dim
        self.add_positional = add_positional
        e = embedding_dim
        for name in ("W_q", "W_k", "W_v", "W_o"):
            setattr(self, name, nn.Parameter(torch.empty(e, e)))
        self.layer_norm_attn = nn.LayerNorm(e)
        self.linear = nn.Sequential(nn.Linear(e, e), nn.ReLU())
        self.layer_norm_linear = nn.LayerNorm(e)

    def forward(self, x):
        x = x.float()
        B, L_, E = x.shape
        if self.add_positional:
            x = x + positional_encoding(L_, E, device=x.device)[None]

        def heads(t):
            return t.reshape(B, L_, self.n_heads, self.head_dim).transpose(1, 2)

        q, k, v = (heads(x @ w) for w in (self.W_q, self.W_k, self.W_v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / (self.head_dim ** 0.5)
        ctx = torch.matmul(scores, v).transpose(1, 2).reshape(B, L_, E)
        ln = self.layer_norm_attn
        attended = _layer_norm(x + ctx @ self.W_o, ln.weight, ln.bias, ln.eps)
        ln = self.layer_norm_linear
        return _layer_norm(self.linear(attended) + attended, ln.weight,
                           ln.bias, ln.eps)


class HelloEncoder(nn.Module):
    """A Linear embedding, then ``n_layers`` attention blocks (the first
    adds the positional encoding) over NWC sequences (the reference's
    HelloEncoder).  Its keys are the port's own: ``embedding`` (a torch
    Linear, ``[embedding_dim, input_dim]``) and ``attention.<i>``."""

    def __init__(self, n_layers, n_heads, input_dim, embedding_dim):
        super().__init__()
        self.input_dim = input_dim
        self.embedding_dim = embedding_dim
        self.embedding = nn.Linear(input_dim, embedding_dim)
        self.attention = nn.ModuleList(
            MultiheadAttention(embedding_dim // n_heads, n_heads,
                               embedding_dim, add_positional=(i == 0))
            for i in range(n_layers))

    def forward(self, x):
        y = self.embedding(x.float())
        for block in self.attention:
            y = block(y)
        return y


class AdaptiveAvgPool1d(nn.Module):
    """Only output_size=1 is used by the reference architectures."""

    def __init__(self, output_size=1):
        super().__init__()
        if output_size != 1:
            raise ValueError("only output_size=1 supported")

    def forward(self, x):
        # bf16 is averaged in fp32 and rounded once, as jnp.mean does
        return torch.mean(x.float(), dim=1, keepdim=True).to(x.dtype)


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


class ConcatenateChannels(nn.Module):
    """Concatenate a tuple of NWC tensors along channels (``None`` entries
    are skipped)."""

    def forward(self, x):
        return torch.cat([t for t in x if t is not None], dim=-1)


class Transposer(nn.Module):
    """Length<->channel transpose marker of the reference, which converts
    ``[B, L, C]`` to torch's conv layout; the port's activations stay NWC
    and its conv modules transpose internally, so this is the identity."""

    def __init__(self, dim0=1, dim1=2):
        super().__init__()

    def forward(self, x):
        return x


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


class Inception(nn.Module):
    """Parallel branches on one input, concatenated along channels."""

    def __init__(self, branches: Sequence[Sequential]):
        super().__init__()
        self.num_branches = len(branches)
        for i, branch in enumerate(branches):
            self.add_module(f"branch{i}", branch)

    def forward(self, x):
        return torch.cat([getattr(self, f"branch{i}")(x)
                          for i in range(self.num_branches)], dim=-1)


# ---------------------------------------------------------------------------
# Config interpretation
# ---------------------------------------------------------------------------

_SIMPLE = {
    "Noop": Noop,
    "ReLU": ReLU,
    "ELU": ELU,
    "SELU": SELU,
    "Sigmoid": Sigmoid,
    "Softplus": Softplus,
    "Tanh": Tanh,
    "Softmax": Softmax,
    "Flatten": Flatten,
    "GlobalPool": GlobalPool,
    "SelectArgument": SelectArgument,
    "AdditiveLayer": AdditiveLayer,
    "LinearCombination": LinearCombination,
    "DotProduct": DotProduct,
    "Dropout": Dropout,
    "AdaptiveAvgPool1d": AdaptiveAvgPool1d,
    "ConcatenateChannels": ConcatenateChannels,
    "Transposer": Transposer,
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
    if ltype == "BatchNorm1d":
        return BatchNorm1d(kwargs["num_features"],
                           momentum=kwargs.get("momentum", 0.1),
                           eps=kwargs.get("eps", _EPS_BN))
    if ltype == "LayerNormModule":
        return LayerNormModule(kwargs["num_features"])
    if ltype in ("MaxPool1d", "AvgPool1d"):
        cls = MaxPool1d if ltype == "MaxPool1d" else AvgPool1d
        return cls(kwargs["kernel_size"], stride=kwargs.get("stride"),
                   padding=kwargs.get("padding", 0))
    if ltype == "ResidualBlock":
        return ResidualBlock(build_network(kwargs["feedforward"]),
                             build_network(kwargs["shortcut"]))
    if ltype == "Fork":
        return Fork([build_network(a) for a in kwargs["net_args"]])
    if ltype == "Inception":
        return Inception([build_network(b) for b in kwargs["branches"]])
    if ltype == "MultiheadAttention":
        return MultiheadAttention(
            kwargs["head_dim"], kwargs["n_heads"], kwargs["embedding_dim"],
            add_positional=kwargs.get("add_positional", False))
    if ltype == "HelloEncoder":
        return HelloEncoder(kwargs["n_layers"], kwargs["n_heads"],
                            kwargs["input_dim"], kwargs["embedding_dim"])
    if ltype in _SIMPLE:
        return _SIMPLE[ltype](**kwargs)
    raise ValueError(f"Unknown layer type: {ltype}")


def build_network(config: Sequence[dict]) -> Sequential:
    """Build a Sequential from a list of layer specs."""
    return Sequential([build_layer(spec) for spec in config])
