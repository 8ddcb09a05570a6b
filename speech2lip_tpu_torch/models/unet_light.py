"""Light post-fusion U-Net (counterpart of
``speech2lip_tpu/models/unet_light.py``).

2-down/2-up U-Net, 64 -> 128 -> 128 channels, align-corners bilinear
upsampling, DoubleConv = (conv3x3 no-bias -> BN -> ReLU) x 2, 1x1 output
conv.  NHWC, HWIO kernels, the JAX package's parameter tree.

``apply`` is the plain forward and the oracle of the four inference entry
points, each of which computes the same function through kernels:
``apply_infer_fused`` (five K3 blocks), ``apply_infer_hcw`` (ten K4
convs), ``apply_infer_pallas`` (ten K6 convs) and ``apply_infer_dconv``
(five K5 DoubleConvs).  ``apply_infer`` is the serving U-Net: the one
place that chooses between K3 and the plain forward.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels.conv_block import (double_conv_infer,
                                                         fold_bn)
from speech2lip_tpu_torch.ops.kernels.conv_hcw import (conv3x3_hcw,
                                                       double_conv_hcw)
from speech2lip_tpu_torch.ops.kernels.fused_block import fused_block


def _bn(params, state, x, train: bool, band=None):
    if train:
        return tnn.batchnorm_train(params, state, x, band=band)
    return tnn.batchnorm(params, state, x), state


def _double_conv(params, state, x, train: bool = False, band=None):
    x = tnn.conv2d(params["conv1"], x, padding=1, band=band)
    x, s1 = _bn(params["bn1"], state["bn1"], x, train, band)
    x = tnn.conv2d(params["conv2"], tnn.relu(x), padding=1, band=band)
    x, s2 = _bn(params["bn2"], state["bn2"], x, train, band)
    return tnn.relu(x), {"bn1": s1, "bn2": s2}


def _up2x(x, out_h: int, out_w: int):
    """Exact-2x bilinear upsample: out[2i] = in[i], out[2i+1] = (in[i] +
    in[i+1]) / 2, edge-clamped, cropped to out_h x out_w.  Unlike
    align_corners at a ratio that is not an integer, it is translation-
    equivariant: a crop of the input aligned to 2 upsamples to the matching
    crop of the output (the static-scene serving path needs that)."""
    b, h, w, c = x.shape
    xn = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    rows = torch.stack([x, 0.5 * (x + xn)], dim=2).reshape(b, 2 * h, w, c)
    cn = torch.cat([rows[:, :, 1:], rows[:, :, -1:]], dim=2)
    cols = torch.stack([rows, 0.5 * (rows + cn)], dim=3).reshape(
        b, 2 * h, 2 * w, c)
    return cols[:, :out_h, :out_w]


def apply(params, state, x, train: bool = False, exact2x: bool = False,
          band=None):
    """Plain forward: x [B, H, W, C] -> (logits [B, H, W, n_classes],
    new BN state).  ``train`` normalises with batch statistics and returns
    the updated running statistics; otherwise the state comes back as it
    went in.  ``exact2x`` upsamples with ``_up2x`` instead of align-corners
    bilinear.

    ``band`` (``parallel.mesh.Band``, from ``frame_band``): x is this
    rank's band of the frames' rows and so is the output.  The 3x3 convs
    and the upsamples read one halo row of each neighbouring band, the
    train-mode statistics are the whole mesh's, and the pools, skips,
    concats and the 1x1 ``outc`` keep to the band's rows, whose edges lie
    on whole pool cells."""
    if band is not None and exact2x:
        raise ValueError("a band upsamples align-corners; exact2x is the "
                         "static scene's whole-frame path")
    b1 = band
    b2 = None if band is None else band.half()
    b3 = None if band is None else b2.half()

    def up(v, like, b):
        if exact2x:
            return _up2x(v, like.shape[1], like.shape[2])
        out_h = like.shape[1] if b is None else 2 * b.height
        return tnn.upsample_bilinear(v, out_h, like.shape[2], band=b)

    new = {}
    x1, new["inc"] = _double_conv(params["inc"], state["inc"], x, train, b1)
    x2, new["down1"] = _double_conv(params["down1"], state["down1"],
                                    tnn.maxpool2d(x1), train, b2)
    x3, new["down2"] = _double_conv(params["down2"], state["down2"],
                                    tnn.maxpool2d(x2), train, b3)
    u = up(x3, x2, b3)
    u, new["up1"] = _double_conv(params["up1"], state["up1"],
                                 torch.cat([x2, u], dim=-1), train, b2)
    u = up(u, x1, b2)
    u, new["up2"] = _double_conv(params["up2"], state["up2"],
                                 torch.cat([x1, u], dim=-1), train, b1)
    return tnn.conv2d(params["outc"], u, padding=0), new


def _infer(params, state, x, double_conv):
    """Inference forward with each DoubleConv run by ``double_conv(x, w1,
    scale1, bias1, w2, scale2, bias2)`` on the folded eval BatchNorm; the
    pools, align-corners upsamples, skip concats and the 1x1 ``outc`` conv
    are plain ops, as in ``apply``."""
    def dc(name, v):
        p, s = params[name], state[name]
        s1, b1 = fold_bn(p["bn1"], s["bn1"])
        s2, b2 = fold_bn(p["bn2"], s["bn2"])
        return double_conv(v.contiguous(), p["conv1"]["w"].contiguous(),
                           s1.float(), b1.float(),
                           p["conv2"]["w"].contiguous(), s2.float(),
                           b2.float())

    x1 = dc("inc", x)
    x2 = dc("down1", tnn.maxpool2d(x1))
    x3 = dc("down2", tnn.maxpool2d(x2))
    u = tnn.upsample_bilinear(x3, x2.shape[1], x2.shape[2])
    u = dc("up1", torch.cat([x2, u], dim=-1))
    u = tnn.upsample_bilinear(u, x1.shape[1], x1.shape[2])
    u = dc("up2", torch.cat([x1, u], dim=-1))
    return tnn.conv2d(params["outc"], u, padding=0)


def apply_infer_hcw(params, state, x):
    """Inference forward with every DoubleConv as two K4 launches
    (``conv3x3_hcw``), ten per call.  x [B, H, W, C] with H a multiple of
    4 (the JAX package's exact-2x upsample asserts it) -> [B, H, W,
    n_classes]; computes ``apply(train=False)``.

    The JAX version pools its haloed buffer into a 128-lane pad; where W/2
    is odd, the pooled pad lane right of the last column holds the max of
    the dropped last column and a zero pad lane instead of 0, and down2's
    conv1 reads it as its right border (a small gap to ``apply`` in the
    last bottleneck column).  The port keeps ``apply``'s zero border."""
    h = x.shape[1]
    if h % 4:
        raise ValueError(f"apply_infer_hcw: H must be a multiple of 4, "
                         f"got {h}")

    def pair(v, w1, s1, b1, w2, s2, b2):
        return conv3x3_hcw(conv3x3_hcw(v, w1, s1, b1), w2, s2, b2)

    return _infer(params, state, x, pair)


def apply_infer_pallas(params, state, x):
    """Inference forward with every DoubleConv as two K6 launches
    (``double_conv_infer``), ten per call; any size.  Computes
    ``apply(train=False)``."""
    return _infer(params, state, x, double_conv_infer)


def apply_infer_dconv(params, state, x):
    """Inference forward with every DoubleConv as one K5 launch
    (``double_conv_hcw``: the conv1 output stays in shared memory), five
    per call; any size.  Computes ``apply(train=False)``.  The JAX package
    has no such entry point: its one caller of ``double_conv_hcw`` is a
    hardware test."""
    return _infer(params, state, x, double_conv_hcw)


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


def k3_runs(shape, kernels: bool) -> bool:
    """Whether ``apply_infer`` runs K3 on an input of ``shape`` [B, H, W,
    C]: with ``kernels`` and H, W multiples of 4, the JAX renderer's shape
    rule (both pools and the upsamples need even sizes at every level)."""
    return bool(kernels) and shape[1] % 4 == 0 and shape[2] % 4 == 0


def apply_infer(params, state, x, kernels: bool, exact2x: bool = False):
    """The serving U-Net, x [B, H, W, C] -> [B, H, W, n_classes]: K3
    (``apply_infer_fused``) where ``k3_runs``, the plain eval forward
    ``apply(exact2x=exact2x)`` elsewhere.  The choice follows the
    reference's shape rule; it is not a fallback for a kernel that fails
    (one that fails raises)."""
    if k3_runs(x.shape, kernels):
        return apply_infer_fused(params, state, x)
    return apply(params, state, x, exact2x=exact2x)[0]
