"""The plain reference's layers: plain PyTorch in float32, written from the
model's equations (the May model of Speech2Lip: an audio encoder, an MLP v2
lip renderer over Fourier features of the lip crop's uv grid, a paste and
backward-warp composite, a light U-Net).  It imports nothing of the
program and takes none of its derived values: it recomputes the grids, the
masks, the embeddings and the folded BatchNorm itself.

``Precision`` sets what every matmul and convolution rounds its inputs
(activations and weights; in training also the gradients flowing back into
them) to: ``f32`` rounds nothing and runs with TF32 off; ``tf32`` and
``fp8`` are the controls one step below float32 and bfloat16 (TF32 keeps 10
mantissa bits, e4m3 three, with a per-tensor scale).  The layers compute in
their weights' dtype, so the same code with bfloat16 weights and inputs is
the model in the bfloat16 a configuration states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8 e4m3 with a per-tensor scale (amax -> 448)."""
    x = x.float()
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


_ROUND = {"tf32": round_tf32, "fp8": round_fp8}


class _RoundBoth(torch.autograd.Function):
    """Rounds the value and the gradient that flows back through it."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _ROUND[mode](x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.mode](g), None


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        return _RoundBoth.apply(x, self.mode)


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32 inside the block."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [f32_tree(v) for v in tree]
    return tree.float()


# -- layers ------------------------------------------------------------------

def linear(q: Precision, p, x):
    return q(x.to(p["w"].dtype)) @ q(p["w"]) + p["b"]


def conv2d(q: Precision, p, x, stride=1, padding=1):
    """x NHWC, kernel HWIO."""
    x = x.to(p["w"].dtype)
    y = F.conv2d(q(x).permute(0, 3, 1, 2), q(p["w"]).permute(3, 2, 0, 1),
                 p.get("b"), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv1d(q: Precision, p, x, stride=2, padding=1):
    """x [B, L, C], kernel LIO."""
    x = x.to(p["w"].dtype)
    y = F.conv1d(q(x).permute(0, 2, 1), q(p["w"]).permute(2, 1, 0), p["b"],
                 stride=stride, padding=padding)
    return y.permute(0, 2, 1)


def leaky(x, slope=0.02):
    return torch.where(x >= 0, x, slope * x)


def maxpool(x, k=2, s=2):
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def upsample_ac(x, h, w):
    """Bilinear resize with align_corners=True, NHWC."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=True).permute(0, 2, 3, 1)


# -- lip renderer ------------------------------------------------------------

def encode_audio(q, p, audio):
    """DeepSpeech window [B, 16, 29] -> audio code [B, 64]: four stride-2
    conv1d + leaky ReLU (16 -> 1 steps), then two linears."""
    x = audio
    for c in p["audio_enc"]["conv"]:
        x = leaky(conv1d(q, c, x))
    x = leaky(linear(q, p["audio_enc"]["fc"][0], x[:, 0, :]))
    return linear(q, p["audio_enc"]["fc"][1], x)


def time_embed(t, dims=20):
    """Sinusoidal embedding of frame indices, sin/cos interleaved."""
    div = torch.exp(torch.arange(0, dims, 2, dtype=torch.float32,
                                 device=t.device)
                    * (-(math.log(10000.0) / dims)))
    arg = t.float()[..., None] * div
    return torch.stack([torch.sin(arg), torch.cos(arg)], -1).reshape(
        *t.shape, dims)


def fourier(x, n=10):
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(...)]."""
    parts = [x]
    for i in range(n):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, -1)


def uv_grid(w: int, h: int, device, dtype=torch.float32) -> torch.Tensor:
    """[h*w, 2] (u, v) in [0, 1], u fastest: step i / (n - 1), the last
    point exactly 1, each value rounded to ``dtype`` (the model builds the
    grid in its compute dtype), returned in float32."""
    def lin(n):
        return torch.cat([torch.arange(n - 1, dtype=torch.float32,
                                       device=device) / (n - 1),
                          torch.ones(1, device=device)])
    v, u = torch.meshgrid(lin(h), lin(w), indexing="ij")
    return torch.stack([u, v], -1).reshape(-1, 2).to(dtype).float()


def frame_features(q, p, codes, t):
    te = time_embed(t)
    base = linear(q, p["fc_audio"], codes) + linear(q, p["fc_time"], te)
    skip = (linear(q, p["fc_audio_skip"], codes)
            + linear(q, p["fc_time_skip"], te))
    return base, skip


def mlp(q, p, uv_emb, base, skip, skip_layer=4):
    """MLP v2: h = fc_uv(uv) + base; eight ReLU layers; after layer 4 the
    skip branch fc_uv_skip(uv) + skip is concatenated in front."""
    h = linear(q, p["fc_uv"], uv_emb) + base
    for i, layer in enumerate(p["trunk"]):
        h = torch.relu(linear(q, layer, h))
        if i == skip_layer:
            hs = linear(q, p["fc_uv_skip"], uv_emb) + skip
            hs, h = torch.broadcast_tensors(hs, h)
            h = torch.cat([hs, h], -1)
    return linear(q, p["output"], h)


def render_lip(q, p, audio, t, lip_h, lip_w, grid_dtype=torch.float32):
    """The eval lip crop of each frame [B, lip_h, lip_w, 3]."""
    codes = encode_audio(q, p, audio)
    base, skip = frame_features(q, p, codes, t)
    uv = fourier(uv_grid(lip_w, lip_h, audio.device, grid_dtype))
    out = mlp(q, p, uv[None], base[:, None], skip[:, None])
    return out.reshape(audio.shape[0], lip_h, lip_w, 3)


# -- composite ---------------------------------------------------------------

def grid_sample(img, grid, padding="zeros"):
    """img [B, H, W, C] at grid [B, Hg, Wg, 2] (x, y in [-1, 1]),
    bilinear, align_corners=False; the coordinates and the weights in
    float32, the result in img's dtype."""
    out = F.grid_sample(img.float().permute(0, 3, 1, 2), grid.float(),
                        mode="bilinear", padding_mode=padding,
                        align_corners=False).permute(0, 2, 3, 1)
    return out.to(img.dtype)


def lip_box(lip_x, lip_y, lip_h, lip_w, divisor=5):
    """(x0, x1, y0, y1) half-open: the lip rectangle widened by
    p = lip_w // divisor each side, and by 2p below."""
    p = lip_w // divisor
    return (lip_x - p, lip_x + lip_w + p, lip_y - p, lip_y + lip_h + 2 * p)


def box_coverage(grid, box, h, w):
    """[..., 1]: 1 where a bilinear sample at ``grid`` reads any pixel of
    the box (a neighbour with non-zero weight inside it), else 0."""
    x0b, x1b, y0b, y1b = box
    xl, xh = max(x0b, 0), min(x1b, w) - 1
    yl, yh = max(y0b, 0), min(y1b, h) - 1
    ix = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    fx, fy = torch.floor(ix), torch.floor(iy)
    wx, wy = ix - fx, iy - fy

    def cov(f, wt, lo, hi):
        a = ((f >= lo) & (f <= hi)).float()
        b = ((f + 1 >= lo) & (f + 1 <= hi)).float()
        return a * (1.0 - wt) + b * wt

    return ((cov(fx, wx, xl, xh) * cov(fy, wy, yl, yh)) != 0).float()[..., None]


def paste(lip, face, mask, lip_x, lip_y):
    """The lip crop pasted into the canonical face, blended by the mask."""
    _, lh, lw, _ = lip.shape
    canvas = torch.zeros_like(face)
    canvas[:, lip_y:lip_y + lh, lip_x:lip_x + lw] = lip.to(face.dtype)
    return mask * canvas + (1.0 - mask) * face


def composite(lip, face_zero, face_ori, mask, coord, lip_x, lip_y,
              divisor=5):
    """The U-Net's input: the pasted canonical face warped to the observed
    pose over the whole frame, blended into the observed face where the
    warp reads the widened lip box."""
    h, w = face_zero.shape[1:3]
    merged = paste(lip, face_zero, mask, lip_x, lip_y)
    warped = grid_sample(merged, coord)
    m = box_coverage(coord, lip_box(lip_x, lip_y, lip.shape[1], lip.shape[2],
                                    divisor), h, w).to(warped.dtype)
    return m * warped + (1.0 - m) * face_ori


# -- U-Net -------------------------------------------------------------------

BLOCKS = ("inc", "down1", "down2", "up1", "up2")


def bn_eval(p, s, x, eps=1e-5):
    return (x - s["mean"]) / torch.sqrt(s["var"] + eps) * p["scale"] \
        + p["bias"]


def bn_train(p, x, eps=1e-5):
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x - mean) ** 2).mean(dims)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def double_conv(q, p, s, x, train):
    for c, b in (("conv1", "bn1"), ("conv2", "bn2")):
        x = conv2d(q, p[c], x)
        x = bn_train(p[b], x) if train else bn_eval(p[b], s[b], x)
        x = torch.relu(x)
    return x


def unet(q, up, us, x, train=False):
    """2-down / 2-up U-Net: DoubleConvs (conv3x3 -> BN -> ReLU, twice),
    2x2 max pools, align-corners bilinear upsamples, skip concat [skip,
    up], then a 1x1 conv.  ``train`` normalises by batch statistics."""
    st = us if us is not None else {k: None for k in BLOCKS}
    x1 = double_conv(q, up["inc"], st["inc"], x, train)
    x2 = double_conv(q, up["down1"], st["down1"], maxpool(x1), train)
    x3 = double_conv(q, up["down2"], st["down2"], maxpool(x2), train)
    u = upsample_ac(x3, x2.shape[1], x2.shape[2])
    u = double_conv(q, up["up1"], st["up1"], torch.cat([x2, u], -1), train)
    u = upsample_ac(u, x1.shape[1], x1.shape[2])
    u = double_conv(q, up["up2"], st["up2"], torch.cat([x1, u], -1), train)
    return conv2d(q, up["outc"], u, padding=0)


def crop_rule(window: Tuple[int, int, int, int], h: int, w: int,
              margin: int = 32, halo: int = 32) -> Dict[str, Any]:
    """The static scene's crop: the warp window widened by ``margin``
    (the pasted interior) and by ``halo`` more (the receptive field),
    every edge on the 4-pixel grid of the two pools, clamped to the
    frame.  None where the crop would cover 90% of the frame or more."""
    wy0, wx0, wh, ww = window
    down = lambda v: (v // 4) * 4
    up = lambda v: -(-v // 4) * 4
    iy0, ix0 = max(0, down(wy0 - margin)), max(0, down(wx0 - margin))
    iy1, ix1 = min(h, up(wy0 + wh + margin)), min(w, up(wx0 + ww + margin))
    cy0, cx0 = max(0, iy0 - halo), max(0, ix0 - halo)
    cy1, cx1 = min(h, iy1 + halo), min(w, ix1 + halo)
    if (cy1 - cy0) * (cx1 - cx0) >= 0.9 * h * w:
        return None
    return {"cy0": cy0, "cx0": cx0, "ch": cy1 - cy0, "cw": cx1 - cx0,
            "iy0": iy0, "ix0": ix0, "ih": iy1 - iy0, "iw": ix1 - ix0}
