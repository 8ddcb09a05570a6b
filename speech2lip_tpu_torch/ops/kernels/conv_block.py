"""Eval BatchNorm folding (counterpart of
``speech2lip_tpu/ops/pallas/conv_block.py:fold_bn``)."""

from __future__ import annotations

import torch


def fold_bn(bn_params, bn_state, eps: float = 1e-5):
    """(scale, bias) with conv(x) * scale + bias == BN(conv(x))."""
    inv = torch.rsqrt(bn_state["var"] + eps)
    scale = bn_params["scale"] * inv
    bias = bn_params["bias"] - bn_state["mean"] * scale
    return scale, bias
