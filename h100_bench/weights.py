"""Weights made on the card from the seed, handed alike to the port and to
the plain reference.

The draw follows the seeded init of the port (``nn/convert.init_params``,
commit 9a24431) and of torch's defaults: every conv and linear weight and
bias uniform in +-1/sqrt(fan_in), a weight norm's ``g`` at ``||v||`` per
output row (so the effective weight is ``v``).  All leaves come from one
``torch.rand`` call of a generator on the device, in a fixed order of the
state dict's keys.
"""

from __future__ import annotations

import math

import torch


def _prefix(key: str) -> str:
    return key.rsplit(".", 1)[0]


def make_state_dict(shapes: dict, seed: int, device) -> dict:
    """``shapes``: {state-dict key: shape} of the model; returns {key: fp32
    tensor on ``device``} drawn from ``seed``.  Knows the leaves of weight
    normed and plain convs and linears (the configurations of this
    benchmark hold no other); raises on any other leaf."""
    keys = sorted(shapes)
    drawn, bounds = [], []
    for key in keys:
        pre, leaf = _prefix(key), key.rsplit(".", 1)[1]
        if leaf in ("weight_v", "weight") and len(shapes[key]) >= 2:
            fan_in = math.prod(shapes[key][1:])
        elif leaf == "bias":
            w = shapes.get(pre + ".weight_v", shapes.get(pre + ".weight"))
            if w is None or len(w) < 2:
                raise ValueError(f"no weight beside bias {key}")
            fan_in = math.prod(w[1:])
        elif leaf == "weight_g":
            continue
        else:
            raise ValueError(f"the benchmark's weights know no leaf {key}")
        drawn.append(key)
        bounds.append(1.0 / math.sqrt(fan_in))
    sizes = [math.prod(shapes[k]) for k in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for key, part, b in zip(drawn, flat.split(sizes), bounds):
        out[key] = (part * (2 * b) - b).reshape(shapes[key])
    for key in keys:
        if key.endswith(".weight_g"):
            v = out[_prefix(key) + ".weight_v"]
            dims = tuple(range(1, v.dim()))
            out[key] = torch.sqrt(torch.sum(v * v, dim=dims,
                                            keepdim=True)).reshape(shapes[key])
    return out

