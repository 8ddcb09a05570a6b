"""K6: conv3x3 + per-channel scale/bias [+ ReLU], NHWC, and the eval
BatchNorm fold (counterpart of ``speech2lip_tpu/ops/pallas/conv_block.py``).

``conv3x3_infer`` replaces the Pallas kernel ``conv3x3_infer``
(``conv_block.py:63``) and ``double_conv_infer`` chains two of them, as the
JAX module does; ``unet_light.apply_infer_pallas`` runs ten per U-Net.  On
the card the launch is the K3 conv kernel with no upsample source and no
pool (``csrc/fused_block.cu``, ``fused_block.conv3x3_affine``), an implicit
GEMM on the tensor cores (in bf16 4-row x 128- or 80-pixel x 64-channel
tiles, wgmma fed by a TMA ring; see ``fused_block``).  The TPU kernel's three row-shifted
input views are not carried over.  The TPU kernel takes any Cout; the card's instances are
Cout 64, 128 and 256, and another Cout raises.  The plain version, shared
with K4, is ``fused_block.conv3x3_affine_plain``.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops.kernels import fused_block as kfb

launches = 0  # conv3x3_infer calls that launched the kernel


def fold_bn(bn_params, bn_state, eps: float = 1e-5):
    """(scale, bias) with conv(x) * scale + bias == BN(conv(x))."""
    inv = torch.rsqrt(bn_state["var"] + eps)
    scale = bn_params["scale"] * inv
    bias = bn_params["bias"] - bn_state["mean"] * scale
    return scale, bias


def conv3x3_infer(x, w, scale, bias, relu: bool = True):
    """relu?(conv3x3(x, w, pad 1) * scale + bias).

    x [B, H, W, Cin]; w [3, 3, Cin, Cout] HWIO in x's dtype; scale/bias
    float32 [Cout].  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return kfb.conv3x3_affine_plain(x, w, scale, bias, relu)
    global launches
    out = kfb.conv3x3_affine(x, w, scale, bias, relu)
    launches += 1
    return out


def double_conv_infer(x, w1, scale1, bias1, w2, scale2, bias2):
    """DoubleConv (conv3x3 -> BN -> ReLU, twice) as two ``conv3x3_infer``
    launches; the mid activation goes through device memory in x's
    dtype."""
    mid = conv3x3_infer(x, w1, scale1, bias1)
    return conv3x3_infer(mid, w2, scale2, bias2)
