"""K3: one fused post-fusion U-Net block (``csrc/fused_block.cu``).

Replaces ``speech2lip_tpu/ops/pallas/conv_hcw.py:fused_block_hcw``:
[align-corners upsample of a half-res source +] channel concat + DoubleConv
(conv3x3 + folded BN + ReLU, twice) [+ 2x2 max-pool output], NHWC.  A block
is two launches of one conv kernel: the first loads the concatenated,
upsampled input tile on the fly (neither tensor is written to device
memory), the second reads the mid activation back from device memory and
emits the pooled output from its epilogue.

On the H100 the kernel is an implicit GEMM on the tensor cores.  In bf16
(the serving type) a block computes output tiles of 4 rows x 128 pixels
(80 where that leaves fewer columns idle) x 64 channels, one block per SM
walking the tiles: a producer warpgroup keeps a ring of 16-channel stages
full (the weights and the input patch by TMA, zero-filled past the image;
the upsampled channels computed by its threads), two consumer warpgroups
run ``wgmma`` with the weights as A and the patch, shifted per tap by a
descriptor offset, as B; BN, ReLU and the pool in registers, the output
stored through ``stmatrix`` staging as 16-byte pieces of pixel rows.  In
float32 it is the first design, 3xTF32 WMMA over 8x16-pixel tiles with
un-pipelined loads.  ``conv3x3_attrs`` reports an instance's registers,
local memory and shared memory.

``conv3x3_affine`` launches the same kernel as a plain conv3x3 + per-channel
scale/bias [+ ReLU] (no upsample source, no pool): the kernel behind K4
(``conv_hcw.conv3x3_hcw``) and K6 (``conv_block.conv3x3_infer``), whose
wrappers count their own launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.kernels import _build

launches = 0  # fused_block calls that launched their kernels


def _conv_bn_relu(x, w, scale, bias, relu: bool = True):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    y = y.permute(0, 2, 3, 1) * scale.float() + bias.float()
    return torch.relu(y) if relu else y


def conv3x3_affine_plain(x, w, scale, bias, relu: bool = True):
    """relu?(conv3x3(x, w, pad 1) * scale + bias) as PyTorch ops: a float32
    conv, rounded to x's dtype as the kernel stores it.  Any shape."""
    return _conv_bn_relu(x.float(), w, scale, bias, relu).to(x.dtype)


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


def _check(t, dt, device, name, what="fused_block"):
    if t.dtype != dt or t.device != device or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous {dt} on "
                         f"{device}, got {t.dtype} on {t.device}")


def check_inputs(what, x, weights, affine):
    """Raise unless x and the conv weights are contiguous bf16 or float32
    tensors of one dtype on x's CUDA device, 16-byte aligned, and the
    scale/bias vectors contiguous float32 there."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {x.dtype}")
    for i, t in enumerate((x,) + tuple(weights)):
        _check(t, x.dtype, x.device, "x" if i == 0 else f"w{i}", what)
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must start 16-byte aligned")
    for i, t in enumerate(affine):
        _check(t, torch.float32, x.device, f"scale/bias {i}", what)


def conv3x3_affine(x, w, scale, bias, relu: bool = True):
    """Launch the conv kernel as relu?(conv3x3(x, w, pad 1) * scale + bias)
    on CUDA tensors: x [B, H, W, Cin], w [3, 3, Cin, Cout] HWIO in x's
    dtype, Cout in {64, 128, 256}; scale/bias float32 [Cout].  Validates
    and raises on what the kernel does not take; counts nothing."""
    check_inputs("conv3x3_affine", x, (w,), (scale, bias))
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    if (w.shape[:3] != (3, 3, cin) or cout not in (64, 128, 256)
            or scale.shape != (cout,) or bias.shape != (cout,)):
        raise ValueError(f"conv3x3_affine: unsupported shapes x "
                         f"{tuple(x.shape)} w {tuple(w.shape)}")
    lib = _build.library()
    fn = (lib.conv3x3_affine_bf16 if x.dtype == torch.bfloat16
          else lib.conv3x3_affine_f32)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    _build.check(fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), b, h, wd, cin, cout,
                    int(relu), _build.stream_ptr(x)), "conv3x3_affine")
    return out


def conv3x3_attrs(dtype, cout: int) -> dict:
    """Registers per thread, local-memory bytes per thread and shared-memory
    bytes per block of the conv kernel instance for (dtype, cout), from
    ``cudaFuncGetAttributes`` (builds the kernels; needs the CUDA
    runtime)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_attrs: dtype {dtype}")
    return _build.func_attrs("conv3x3_attrs", int(dtype == torch.bfloat16),
                             cout)


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
    check_inputs("fused_block", x, (w1, w2) + ((up,) if up is not None
                                                else ()),
                 (scale1, bias1, scale2, bias2))
    dt = x.dtype
    b, h, wd, c0 = x.shape
    c1 = 0
    if up is not None:
        if up.shape[0] != b or up.shape[1] < 2 or up.shape[2] < 2:
            raise ValueError(f"fused_block: up {tuple(up.shape)}")
        c1 = up.shape[3]
    cmid, cout = w1.shape[3], w2.shape[3]
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
