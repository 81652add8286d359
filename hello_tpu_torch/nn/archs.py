"""Concrete network architectures for the HELLO MoE variant-calling model.

These reproduce the layer topologies of the reference architecture modules
(reference python/architectures/*.py — read_convolver, compressor_conv_small,
xattn_subtract, conv_combiner, meta_convolver, meta_convolver_ref, plus the
_wide and _with_hp_channel variants) as config dicts for
:func:`hello_tpu.nn.layers.build_network`.  The topology must match exactly so
that reference-trained checkpoints convert into working parameter pytrees.

Shapes (NWC): read tensors enter as ``[B, 150, 6|7]`` and leave the read
convolver as ``[B, 36, 64]``; the compressor maps to ``[B, 18, 128]``; the
xattn head maps allele/site features to one logit per allele.
"""

from __future__ import annotations


def single_conv_layer(cin, cout, kernel, padding, dilation, stride, groups=1,
                      weight_norm=False, norm_type="BatchNorm1d", activation="ReLU"):
    """Conv + (norm) + activation (reference NNTools.SingleConvLayer:72-115)."""
    block = [{
        "type": "WeightNormedConv1d" if weight_norm else "Conv1d",
        "kwargs": {
            "in_channels": cin, "out_channels": cout, "kernel_size": kernel,
            "padding": padding, "dilation": dilation, "stride": stride, "groups": groups,
        },
    }]
    if not weight_norm:
        block.append({"type": norm_type, "kwargs": {"num_features": cout}})
    block.append({"type": activation, "kwargs": {}})
    return block


def _conv_norm_act(cin, cout, kernel, padding, dilation, stride, groups,
                   weight_norm, norm_type, activation):
    layers = [{
        "type": "WeightNormedConv1d" if weight_norm else "Conv1d",
        "kwargs": {
            "in_channels": cin, "out_channels": cout, "kernel_size": kernel,
            "padding": padding, "dilation": dilation, "stride": stride, "groups": groups,
        },
    }]
    # the reference keeps a Noop placeholder in place of the norm layer under
    # weight-norm so that torch Sequential indices stay aligned — replicate that
    if weight_norm:
        layers.append({"type": "Noop", "kwargs": {}})
    else:
        layers.append({"type": norm_type, "kwargs": {"num_features": cout}})
    layers.append({"type": activation, "kwargs": {}})
    return layers


def residual_ft(cin, cout, kernels, paddings, dilations, strides, groups=(1, 1),
                weight_norm=False, norm_type="BatchNorm1d", activation="ReLU"):
    """Residual block with identity shortcut (NNTools.ResidualBlockFTShortcut:210-294)."""
    ff = _conv_norm_act(cin, cout, kernels[0], paddings[0], dilations[0], strides[0],
                        groups[0], weight_norm, norm_type, activation)
    ff += _conv_norm_act(cout, cout, kernels[1], paddings[1], dilations[1], strides[1],
                         groups[1], weight_norm, norm_type, activation)
    return {"type": "ResidualBlock", "kwargs": {
        "feedforward": ff,
        "shortcut": [{"type": "Noop", "kwargs": {}}],
    }}


def residual_conv(cin, cout, kernels, paddings, dilations, strides, groups=(1, 1, 1),
                  weight_norm=False, norm_type="BatchNorm1d", activation="ReLU"):
    """Residual block with 1x1-conv shortcut (NNTools.ResidualBlockConvShortcut:118-207)."""
    ff = _conv_norm_act(cin, cout, kernels[0], paddings[0], dilations[0], strides[0],
                        groups[0], weight_norm, norm_type, activation)
    ff += _conv_norm_act(cout, cout, kernels[1], paddings[1], dilations[1], strides[1],
                         groups[1], weight_norm, norm_type, activation)
    return {"type": "ResidualBlock", "kwargs": {
        "feedforward": ff,
        "shortcut": [{
            "type": "WeightNormedConv1d" if weight_norm else "Conv1d",
            "kwargs": {
                "in_channels": cin, "out_channels": cout, "kernel_size": 1,
                "stride": strides[2], "groups": groups[2],
            },
        }],
    }}


def terminus(cin, cout, dropout=0, weight_norm=False, norm_type="BatchNorm1d"):
    """Global-average-pool classification head (NNTools.terminus:517-566)."""
    config = [
        {"type": "AdaptiveAvgPool1d", "kwargs": {"output_size": 1}},
        {"type": "Flatten", "kwargs": {}},
    ]
    if dropout == 0 and not weight_norm:
        config.append({"type": norm_type, "kwargs": {"num_features": cin}})
    elif dropout > 0:
        config.append({"type": "Dropout", "kwargs": {"p": dropout}})
    else:
        config.append({"type": "Noop", "kwargs": {}})
    config.append({
        "type": "WeightNormedLinear" if weight_norm else "Linear",
        "kwargs": {"in_features": cin, "out_features": cout},
    })
    return config


def read_convolver(weight_norm=False, norm_type="BatchNorm1d", activation="ReLU",
                   in_channels=6, width=1):
    """ResNet over read feature maps: [B,150,Cin] -> [B,36,64*width].

    Mirrors architectures/read_convolver.py (and the _with_hp_channel /
    _wide variants via ``in_channels``/``width``).
    """
    w = width
    kw = dict(weight_norm=weight_norm, norm_type=norm_type, activation=activation)
    config = []
    config += single_conv_layer(in_channels, 16 * w, 3, 0, 1, 1, **kw)   # 148
    config += single_conv_layer(16 * w, 16 * w, 3, 0, 1, 1, **kw)        # 146
    config += single_conv_layer(16 * w, 32 * w, 3, 0, 1, 1, **kw)        # 144
    config.append({"type": "MaxPool1d", "kwargs": {"kernel_size": 3, "stride": 2, "padding": 0}})  # 71
    for _ in range(3):
        config.append(residual_ft(32 * w, 32 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    config.append(residual_conv(32 * w, 64 * w, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))  # 36
    for _ in range(3):
        config.append(residual_ft(64 * w, 64 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    return config


def compressor_conv(weight_norm=False, norm_type="BatchNorm1d", width=1):
    """Allele-frame compressor: [B,36,64w] -> [B,18,128w]
    (architectures/compressor_conv_small.py)."""
    w = width
    kw = dict(weight_norm=weight_norm, norm_type=norm_type)
    config = single_conv_layer(64 * w, 64 * w, 1, 0, 1, 1, **kw)
    config.append(residual_conv(64 * w, 128 * w, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_ft(128 * w, 128 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    config.append(residual_ft(128 * w, 128 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    return config


def xattn_subtract(weight_norm=False, norm_type="BatchNorm1d", activation="ReLU", width=1):
    """Expert head computing 2*allele_features - site_features then a conv stack
    to one logit per allele (architectures/xattn_subtract.py:14-95).

    Input: tuple (allele_features, (site_features_0, site_features_1)); the head
    uses the *second* site-feature variant.
    """
    w = width
    kw = dict(weight_norm=weight_norm, norm_type=norm_type, activation=activation)
    config = [
        {"type": "Fork", "kwargs": {"net_args": [
            [{"type": "Noop", "kwargs": {}}],
            [{"type": "SelectArgument", "kwargs": {"select": 1}}],
        ]}},
        {"type": "LinearCombination", "kwargs": {"coefficients": [2, -1]}},
    ]
    config += single_conv_layer(128 * w, 128 * w, 1, 0, 1, 1, **kw)
    config.append(residual_conv(128 * w, 256 * w, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_ft(256 * w, 256 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    config.append(residual_ft(256 * w, 256 * w, [3, 3], [1, 1], [1, 1], [1, 1], **kw))
    config += terminus(256 * w, 1, weight_norm=weight_norm)
    return config


def conv_combiner(weight_norm=False, norm_type="BatchNorm1d", activation="ReLU", width=1):
    """Merge two platforms' feature maps: concat channels -> 512 -> 128
    (architectures/conv_combiner.py)."""
    w = width
    kw = dict(weight_norm=weight_norm, norm_type=norm_type, activation=activation)
    config = [{"type": "ConcatenateChannels", "kwargs": {}}]
    config += single_conv_layer(128 * 2 * w, 128 * 4 * w, 3, 1, 1, 1, **kw)
    config += single_conv_layer(128 * 4 * w, 128 * 1 * w, 1, 0, 1, 1, **kw)
    return config


def meta_convolver(weight_norm=False, norm_type="BatchNorm1d", activation="ReLU"):
    """Meta-expert over compressed site frames -> 3 logits
    (architectures/meta_convolver.py)."""
    kw = dict(weight_norm=weight_norm, norm_type=norm_type, activation=activation)
    config = [{"type": "SelectArgument", "kwargs": {"select": 0}}]
    config += single_conv_layer(128, 128, 1, 0, 1, 1, **kw)
    config.append(residual_conv(128, 256, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_ft(256, 256, [3, 3], [1, 1], [1, 1, 1], [1, 1], **kw))
    config.append(residual_ft(256, 256, [3, 3], [1, 1], [1, 1, 1], [1, 1], **kw))
    config += terminus(256, 3, weight_norm=weight_norm, norm_type=norm_type)
    return config


def meta_convolver_ref(weight_norm=False, norm_type="BatchNorm1d", activation="ReLU"):
    """Meta-expert over the one-hot reference segment [B,150,5] -> 3 logits
    (architectures/meta_convolver_ref.py)."""
    kw = dict(weight_norm=weight_norm, norm_type=norm_type, activation=activation)
    config = [
        {"type": "SelectArgument", "kwargs": {"select": 1}},
        # identity under NWC; converts to conv layout in the torch reference
        {"type": "Transposer", "kwargs": {"dim0": 1, "dim1": 2}},
    ]
    config += single_conv_layer(5, 16, 1, 0, 1, 1, **kw)
    config.append(residual_conv(16, 32, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_conv(32, 64, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_conv(64, 128, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config.append(residual_conv(128, 256, [3, 3], [1, 1], [1, 1, 1], [2, 1, 2], **kw))
    config += terminus(256, 3, weight_norm=weight_norm, norm_type=norm_type)
    return config


# ---------------------------------------------------------------------------
# Model-level configuration dicts (mirror the moe_attention_config_* modules)
# ---------------------------------------------------------------------------

def read_convolver_addendum(weight_norm=False, width=1, num_blocks=2):
    """Extra residual blocks appended for transfer learning
    (architectures/read_convolver_addendum.py)."""
    kw = dict(weight_norm=weight_norm)
    return [residual_ft(64 * width, 64 * width, [3, 3], [1, 1], [1, 1], [1, 1], **kw)
            for _ in range(num_blocks)]


def config_single_tech(weight_norm=True, include_hp_channel=False, width=1,
                       addendum=False):
    """Single-platform model: read_conv0 + compressor0 + xattn0
    (moe_attention_config_single_tech_old_equivalent_weight_norm[_with_hp_channel].py)."""
    wn = weight_norm
    rc = read_convolver(wn, in_channels=7 if include_hp_channel else 6, width=width)
    if addendum:
        rc = rc + read_convolver_addendum(wn, width)
    return {
        "read_conv0": rc,
        "compressor0": compressor_conv(wn, width=width),
        "xattn0": xattn_subtract(wn, width=width),
    }


def config_hybrid_full(weight_norm=True):
    """Full hybrid 3-expert + meta model
    (moe_attention_config_full_hybrid_old_equivalent_weight_norm.py)."""
    wn = weight_norm
    return {
        "read_conv0": read_convolver(wn),
        "read_conv1": read_convolver(wn),
        "compressor0": compressor_conv(wn),
        "compressor1": compressor_conv(wn),
        "xattn0": xattn_subtract(wn),
        "xattn1": xattn_subtract(wn),
        "xattn2": xattn_subtract(wn),
        "combiner0": conv_combiner(wn),
        "combiner1": conv_combiner(wn),
        "meta": meta_convolver(wn),
    }


def config_single_tech_layer_norm():
    """Single-platform "layer_norm" model
    (moe_attention_config_single_tech_old_equivalent_layer_norm.py:12-22).

    Despite the name, the shipping reference module sets norm_type="Noop"
    (its LayerNormModule line is commented out) and activation="Softplus" on
    the read convolver and xattn head; the compressor has no activation knob
    so it keeps ReLU; weight_norm stays False; the xattn terminus keeps
    BatchNorm1d (terminus is called without norm_type,
    architectures/xattn_subtract.py:95).
    """
    return {
        "read_conv0": read_convolver(False, norm_type="Noop", activation="Softplus"),
        "compressor0": compressor_conv(False, norm_type="Noop"),
        "xattn0": xattn_subtract(False, norm_type="Noop", activation="Softplus"),
    }


def config_hybrid_ensemble2(weight_norm=True):
    """Two platform experts + reference-segment meta-expert; no xattn2, no
    combiners (moe_attention_config_full_hybrid_old_equivalent_weight_norm_
    ensemble2.py:14-22).  Forward takes the reference's "case 2" path:
    expert2 logits substituted with zeros under the meta softmax."""
    wn = weight_norm
    return {
        "read_conv0": read_convolver(wn),
        "read_conv1": read_convolver(wn),
        "compressor0": compressor_conv(wn),
        "compressor1": compressor_conv(wn),
        "xattn0": xattn_subtract(wn),
        "xattn1": xattn_subtract(wn),
        "meta": meta_convolver_ref(wn),
    }


def config_hybrid_no_ensemble(weight_norm=True, width=1, addendum=False):
    """Hybrid binary-classifier model: combiners + xattn2 only, no meta
    (moe_attention_config_full_hybrid_old_equivalent_weight_norm_no_ensemble
    [_wide/_addendum].py)."""
    wn = weight_norm
    rc = read_convolver(wn, width=width)
    if addendum:
        rc = rc + read_convolver_addendum(wn, width)
    return {
        "read_conv0": rc,
        "read_conv1": list(rc),
        "compressor0": compressor_conv(wn, width=width),
        "compressor1": compressor_conv(wn, width=width),
        "combiner0": conv_combiner(wn, width=width),
        "combiner1": conv_combiner(wn, width=width),
        "xattn2": xattn_subtract(wn, width=width),
    }


NAMED_CONFIGS = {
    "illumina": lambda: config_single_tech(),
    "pacbio": lambda: config_single_tech(),
    "pacbio_hp": lambda: config_single_tech(include_hp_channel=True),
    "hybrid": lambda: config_hybrid_full(),
    "hybrid_no_ensemble": lambda: config_hybrid_no_ensemble(),
    "hybrid_no_ensemble_wide": lambda: config_hybrid_no_ensemble(width=2),
    "hybrid_no_ensemble_addendum":
        lambda: config_hybrid_no_ensemble(addendum=True),
    "illumina_wide": lambda: config_single_tech(width=2),
    "illumina_addendum": lambda: config_single_tech(addendum=True),
    "illumina_layer_norm": lambda: config_single_tech_layer_norm(),
    "hybrid_ensemble2": lambda: config_hybrid_ensemble2(),
}
