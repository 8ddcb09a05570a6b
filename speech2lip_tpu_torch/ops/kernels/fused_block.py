"""K3: one fused post-fusion U-Net block (``csrc/fused_block.cu``).

Replaces ``speech2lip_tpu/ops/pallas/conv_hcw.py:fused_block_hcw``:
[align-corners upsample of a half-res source +] channel concat + DoubleConv
(conv3x3 + folded BN + ReLU, twice) [+ 2x2 max-pool output], NHWC.  A block
is two launches of one conv kernel: the first loads the concatenated,
upsampled input tile on the fly (neither tensor is written to device
memory), the second reads the mid activation back from device memory and
emits the pooled output from its epilogue.  On the H100 each launch is an
implicit GEMM on the tensor cores over 8x16-pixel tiles, bound by its
un-pipelined input and weight loads (16 bytes a thread) and tensor-core
issue at that tile size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels import _build

launches = 0  # fused_block calls that launched their kernels


def _conv_bn_relu(x, w, scale, bias):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) * scale + bias)


def fused_block_plain(x, w1, scale1, bias1, w2, scale2, bias2, up=None,
                      pool: bool = False):
    """The block as PyTorch ops: float32 convs, the upsampled input and the
    mid activation rounded to x's dtype, as the kernel stores them."""
    dt = x.dtype
    h, w = x.shape[1:3]
    xin = x.float()
    if up is not None:
        u = tnn.upsample_bilinear(up.float(), h, w).to(dt).float()
        xin = torch.cat([xin, u], dim=-1)
    mid = _conv_bn_relu(xin, w1, scale1, bias1).to(dt)
    out = _conv_bn_relu(mid.float(), w2, scale2, bias2).to(dt)
    if pool:
        return out, tnn.maxpool2d(out)
    return out


def _check(t, dt, device, name):
    if t.dtype != dt or t.device != device or not t.is_contiguous():
        raise ValueError(f"fused_block: {name} must be contiguous {dt} on "
                         f"{device}, got {t.dtype} on {t.device}")


def _launch(fn, x, lo, w, scale, bias, out, pool_out):
    b, h, wd, c0 = x.shape
    c1, hl, wl = (lo.shape[3], lo.shape[1], lo.shape[2]) if lo is not None \
        else (0, 0, 0)
    err = fn(x.data_ptr(), c0, lo.data_ptr() if lo is not None else None,
             c1, hl, wl, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(),
             pool_out.data_ptr() if pool_out is not None else None,
             b, h, wd, w.shape[3], _build.stream_ptr(x))
    _build.check(err, "fused_block")


def fused_block(x, w1, scale1, bias1, w2, scale2, bias2, up=None,
                pool: bool = False):
    """One U-Net block, NHWC.

    x [B, H, W, C0]; up [B, Hl, Wl, C1] (upsampled align-corners to H x W
    and concatenated after x) or None; w1 [3, 3, C0 + C1, Cmid] and w2
    [3, 3, Cmid, Cout] HWIO in x's dtype; scale/bias float32 folded BN.
    Returns out [B, H, W, Cout], plus the 2x2 max pool [B, H//2, W//2,
    Cout] when ``pool``.
    """
    args = (x, w1, scale1, bias1, w2, scale2, bias2)
    if x.device.type == "cpu":
        return fused_block_plain(*args, up=up, pool=pool)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    dt = x.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_block: dtype {dt}")
    b, h, wd, c0 = x.shape
    c1 = 0
    for t, name in ((x, "x"), (w1, "w1"), (w2, "w2")):
        _check(t, dt, x.device, name)
    for t, name in ((scale1, "scale1"), (bias1, "bias1"),
                    (scale2, "scale2"), (bias2, "bias2")):
        _check(t, torch.float32, x.device, name)
    if up is not None:
        _check(up, dt, x.device, "up")
        if up.shape[0] != b or up.shape[1] < 2 or up.shape[2] < 2:
            raise ValueError(f"fused_block: up {tuple(up.shape)}")
        c1 = up.shape[3]
    cmid, cout = w1.shape[3], w2.shape[3]
    if any(t.data_ptr() % 16 for t in (x, w1, w2) + ((up,) if c1 else ())):
        raise ValueError("fused_block: tensors must start 16-byte aligned")
    if (w1.shape[:3] != (3, 3, c0 + c1) or w2.shape[:3] != (3, 3, cmid)
            or cmid not in (64, 128) or cout not in (64, 128)
            or scale1.shape != (cmid,) or bias1.shape != (cmid,)
            or scale2.shape != (cout,) or bias2.shape != (cout,)
            or h < 2 or wd < 2):
        raise ValueError(f"fused_block: unsupported shapes x {tuple(x.shape)} "
                         f"w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    lib = _build.library()
    fn = (lib.conv3x3_bn_relu_bf16 if dt == torch.bfloat16
          else lib.conv3x3_bn_relu_f32)
    mid = torch.empty((b, h, wd, cmid), dtype=dt, device=x.device)
    out = torch.empty((b, h, wd, cout), dtype=dt, device=x.device)
    pooled = (torch.empty((b, h // 2, wd // 2, cout), dtype=dt,
                          device=x.device) if pool else None)
    _launch(fn, x, up, w1, scale1, bias1, mid, None)
    _launch(fn, mid, None, w2, scale2, bias2, out, pooled)
    launches += 1
    return (out, pooled) if pool else out
