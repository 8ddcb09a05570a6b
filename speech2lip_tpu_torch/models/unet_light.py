"""Light post-fusion U-Net, inference (counterpart of
``speech2lip_tpu/models/unet_light.py``).

2-down/2-up U-Net, 64 -> 128 -> 128 channels, align-corners bilinear
upsampling, DoubleConv = (conv3x3 no-bias -> BN -> ReLU) x 2, 1x1 output
conv.  NHWC, HWIO kernels, the JAX package's parameter tree.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn
from speech2lip_tpu_torch.ops.kernels.fused_block import fused_block


def _double_conv(params, state, x):
    x = tnn.conv2d(params["conv1"], x, padding=1)
    x = tnn.relu(tnn.batchnorm(params["bn1"], state["bn1"], x))
    x = tnn.conv2d(params["conv2"], x, padding=1)
    return tnn.relu(tnn.batchnorm(params["bn2"], state["bn2"], x))


def apply(params, state, x):
    """Plain eval forward: x [B, H, W, C] -> logits [B, H, W, n_classes]
    (``apply(train=False)`` of the JAX package)."""
    x1 = _double_conv(params["inc"], state["inc"], x)
    x2 = _double_conv(params["down1"], state["down1"], tnn.maxpool2d(x1))
    x3 = _double_conv(params["down2"], state["down2"], tnn.maxpool2d(x2))
    u = tnn.upsample_bilinear(x3, x2.shape[1], x2.shape[2])
    u = _double_conv(params["up1"], state["up1"], torch.cat([x2, u], dim=-1))
    u = tnn.upsample_bilinear(u, x1.shape[1], x1.shape[2])
    u = _double_conv(params["up2"], state["up2"], torch.cat([x1, u], dim=-1))
    return tnn.conv2d(params["outc"], u, padding=0)


def apply_infer_fused(params, state, x):
    """Kernel forward: five K3 blocks (``fused_block``) with the 2x2 pools
    and the upsample + skip concats folded in, then the 1x1 ``outc`` conv
    as a plain matmul.  x [B, H, W, C] with H, W multiples of 4 ->
    [B, H, W, n_classes]."""
    b, h, w, _ = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"apply_infer_fused: H, W must be multiples of 4, "
                         f"got {h}x{w}")

    def blk(name, src, up=None, pool=False):
        p, s = params[name], state[name]
        s1, b1 = fold_bn(p["bn1"], s["bn1"])
        s2, b2 = fold_bn(p["bn2"], s["bn2"])
        return fused_block(src, p["conv1"]["w"].contiguous(), s1.float(),
                           b1.float(), p["conv2"]["w"].contiguous(),
                           s2.float(), b2.float(), up=up, pool=pool)

    x1, x1p = blk("inc", x.contiguous(), pool=True)
    x2, x2p = blk("down1", x1p, pool=True)
    x3 = blk("down2", x2p)
    u = blk("up1", x2, up=x3)
    u = blk("up2", x1, up=u)
    wo = params["outc"]["w"][0, 0]  # [64, n_classes]
    return u @ wo + params["outc"]["b"]
