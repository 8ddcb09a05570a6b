"""Light post-fusion U-Net (counterpart of
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


def _bn(params, state, x, train: bool):
    if train:
        return tnn.batchnorm_train(params, state, x)
    return tnn.batchnorm(params, state, x), state


def _double_conv(params, state, x, train: bool = False):
    x = tnn.conv2d(params["conv1"], x, padding=1)
    x, s1 = _bn(params["bn1"], state["bn1"], x, train)
    x = tnn.conv2d(params["conv2"], tnn.relu(x), padding=1)
    x, s2 = _bn(params["bn2"], state["bn2"], x, train)
    return tnn.relu(x), {"bn1": s1, "bn2": s2}


def apply(params, state, x, train: bool = False):
    """Plain forward: x [B, H, W, C] -> (logits [B, H, W, n_classes],
    new BN state).  ``train`` normalises with batch statistics and returns
    the updated running statistics; otherwise the state comes back as it
    went in."""
    new = {}
    x1, new["inc"] = _double_conv(params["inc"], state["inc"], x, train)
    x2, new["down1"] = _double_conv(params["down1"], state["down1"],
                                    tnn.maxpool2d(x1), train)
    x3, new["down2"] = _double_conv(params["down2"], state["down2"],
                                    tnn.maxpool2d(x2), train)
    u = tnn.upsample_bilinear(x3, x2.shape[1], x2.shape[2])
    u, new["up1"] = _double_conv(params["up1"], state["up1"],
                                 torch.cat([x2, u], dim=-1), train)
    u = tnn.upsample_bilinear(u, x1.shape[1], x1.shape[2])
    u, new["up2"] = _double_conv(params["up2"], state["up2"],
                                 torch.cat([x1, u], dim=-1), train)
    return tnn.conv2d(params["outc"], u, padding=0), new


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
