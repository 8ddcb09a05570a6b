"""K4 and K5: the U-Net's conv3x3 and DoubleConv kernels (counterpart of
``speech2lip_tpu/ops/pallas/conv_hcw.py:conv3x3_hcw`` and
``double_conv_hcw``).

The TPU kernels work on a haloed [B, H, C, W] layout with 128-lane and
16-channel padding, packed weights and manual output DMA; all of that
suits the TPU's (8, 128) tiling and is not carried over.  The port's
arguments are NHWC with no halo.

- ``conv3x3_hcw`` (K4): relu?(conv3x3(x, w, pad 1) * scale + bias).  On the
  card it launches the K3 conv kernel with no upsample source and no pool
  (``fused_block.conv3x3_affine``; in bf16 the TMA-ring / wgmma design),
  Cout in {64, 128, 256} as the TPU kernel;
  ``unet_light.apply_infer_hcw`` runs ten per U-Net.
- ``double_conv_hcw`` (K5): DoubleConv in one launch of
  ``csrc/double_conv.cu``, the conv1 output kept in shared memory (never
  in device memory) and recomputed on a one-pixel halo per tile, rounded
  to the working dtype before conv2 as the TPU kernel's mid scratch is;
  Cmid and Cout in {64, 128}.  The kernel body is chosen by dtype: bf16
  runs the cp.async-ring / ldmatrix / mma.sync design, float32 the 3xTF32
  WMMA one.  ``unet_light.apply_infer_dconv`` runs five per U-Net;
  ``double_conv_attrs`` reports an instance's registers, local memory and
  shared memory.

Each has its own launch count.  Their plain versions are float32 convs,
outputs rounded to x's dtype: ``fused_block.conv3x3_affine_plain`` for K4
(shared with K6) and ``double_conv_hcw_plain`` for K5.
"""

from __future__ import annotations

import torch

from speech2lip_tpu_torch.ops.kernels import _build
from speech2lip_tpu_torch.ops.kernels import fused_block as kfb

conv3x3_launches = 0      # conv3x3_hcw calls that launched the kernel (K4)
double_conv_launches = 0  # double_conv_hcw calls that launched it (K5)


def conv3x3_hcw(x, w, scale, bias, relu: bool = True):
    """relu?(conv3x3(x, w, pad 1) * scale + bias), NHWC.

    x [B, H, W, Cin]; w [3, 3, Cin, Cout] HWIO in x's dtype; scale/bias
    float32 [Cout].  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return kfb.conv3x3_affine_plain(x, w, scale, bias, relu)
    global conv3x3_launches
    out = kfb.conv3x3_affine(x, w, scale, bias, relu)
    conv3x3_launches += 1
    return out


def double_conv_hcw_plain(x, w1, scale1, bias1, w2, scale2, bias2):
    """DoubleConv as PyTorch ops: float32 convs, the mid activation and the
    output rounded to x's dtype."""
    return kfb.fused_block_plain(x, w1, scale1, bias1, w2, scale2, bias2)


def double_conv_hcw(x, w1, scale1, bias1, w2, scale2, bias2):
    """relu(conv3x3(relu(conv3x3(x, w1) * scale1 + bias1), w2) * scale2 +
    bias2), NHWC, pad 1 for both convs.

    x [B, H, W, Cin]; w1 [3, 3, Cin, Cmid], w2 [3, 3, Cmid, Cout] HWIO in
    x's dtype; scale/bias float32.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    args = (x, w1, scale1, bias1, w2, scale2, bias2)
    if x.device.type == "cpu":
        return double_conv_hcw_plain(*args)
    global double_conv_launches
    kfb.check_inputs("double_conv_hcw", x, (w1, w2),
                     (scale1, bias1, scale2, bias2))
    b, h, wd, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    if (w1.shape[:3] != (3, 3, cin) or w2.shape[:3] != (3, 3, cmid)
            or cmid not in (64, 128) or cout not in (64, 128)
            or scale1.shape != (cmid,) or bias1.shape != (cmid,)
            or scale2.shape != (cout,) or bias2.shape != (cout,)):
        raise ValueError(f"double_conv_hcw: unsupported shapes x "
                         f"{tuple(x.shape)} w1 {tuple(w1.shape)} w2 "
                         f"{tuple(w2.shape)}")
    lib = _build.library()
    fn = (lib.double_conv_bf16 if x.dtype == torch.bfloat16
          else lib.double_conv_f32)
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    _build.check(fn(*(t.data_ptr() for t in args), out.data_ptr(), b, h, wd,
                    cin, cmid, cout, _build.stream_ptr(x)), "double_conv_hcw")
    double_conv_launches += 1
    return out


def double_conv_attrs(dtype, cmid: int, cout: int) -> dict:
    """Registers per thread, local-memory bytes per thread and shared-memory
    bytes per block of the K5 instance for (dtype, cmid, cout), from
    ``cudaFuncGetAttributes`` (builds the kernels; needs the CUDA
    runtime)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"double_conv_attrs: dtype {dtype}")
    return _build.func_attrs("double_conv_attrs",
                             int(dtype == torch.bfloat16), cmid, cout)
