"""Operations, bytes and peaks: the yardstick of the roofline and mfu
metrics.  Counted from shapes alone; nothing here reads the program.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), at the card's
full 700 W limit: 989 TFLOP/s bf16 tensor cores, 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM3.  A multiply-add counts 2.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# U-Net (models/unet_light): (block, level, cin, cmid, cout); level l runs
# at the input's size halved l times (floor, as the 2x2 pools take it)
UNET_BLOCKS = [("inc", 0, 3, 64, 64), ("down1", 1, 64, 128, 128),
               ("down2", 2, 128, 128, 128), ("up1", 1, 256, 128, 64),
               ("up2", 0, 128, 64, 64)]
UNET_OUT = (64, 3)  # the 1x1 outc conv

# lip MLP v2 (models/talking_face): widths of the May model
MLP_WIDTH, MLP_DEPTH, MLP_SKIP, UV_DIM, OUT_CH = 256, 8, 4, 42, 3

# LPIPS AlexNet v0.1 features: (cout, kernel, stride, pad); a 3x3 stride-2
# max pool follows the first two
ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
        (256, 3, 1, 1)]

# SyncNet (models/syncnet): (cout, (kh, kw), (sh, sw), pad) of each conv;
# the face encoder reads [48, 96, 15] (the lower half of five stacked 96 x
# 96 crops), the audio encoder a mel window [80, 16, 1]
SYNC_FACE = [(32, (7, 7), (1, 1), 3), (64, (5, 5), (1, 2), 1),
             (64, (3, 3), (1, 1), 1), (64, (3, 3), (1, 1), 1),
             (128, (3, 3), (2, 2), 1), (128, (3, 3), (1, 1), 1),
             (128, (3, 3), (1, 1), 1), (128, (3, 3), (1, 1), 1),
             (256, (3, 3), (2, 2), 1), (256, (3, 3), (1, 1), 1),
             (256, (3, 3), (1, 1), 1), (512, (3, 3), (2, 2), 1),
             (512, (3, 3), (1, 1), 1), (512, (3, 3), (1, 1), 1),
             (512, (3, 3), (2, 2), 1), (512, (3, 3), (1, 1), 0),
             (512, (1, 1), (1, 1), 0)]
SYNC_AUDIO = [(32, (3, 3), (1, 1), 1), (32, (3, 3), (1, 1), 1),
              (32, (3, 3), (1, 1), 1), (64, (3, 3), (3, 1), 1),
              (64, (3, 3), (1, 1), 1), (64, (3, 3), (1, 1), 1),
              (128, (3, 3), (3, 3), 1), (128, (3, 3), (1, 1), 1),
              (128, (3, 3), (1, 1), 1), (256, (3, 3), (3, 2), 1),
              (256, (3, 3), (1, 1), 1), (256, (3, 3), (1, 1), 1),
              (512, (3, 3), (1, 1), 0), (512, (1, 1), (1, 1), 0)]
SYNC_FACE_IN, SYNC_AUDIO_IN = (48, 96, 15), (80, 16, 1)
SYNC_T = 5  # the window's frames


def bound_s(ops: float, moved: float, peak: str) -> Tuple[float, str]:
    """(least seconds, what bounds it) of ``ops`` operations at the
    ``peak`` rate moving ``moved`` bytes through device memory."""
    t_ops, t_bytes = ops / PEAK[peak], moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("ops" if t_ops >= t_bytes else "bytes")


def conv3x3_ops(h: int, w: int, cin: int, cout: int, frames: int = 1) -> float:
    """A 3x3 conv with padding 1 over ``frames`` images of h x w."""
    return 2.0 * frames * h * w * 9 * cin * cout


def unet_levels(h: int, w: int) -> List[Tuple[int, int]]:
    return [(h, w), (h // 2, w // 2), (h // 4, w // 4)]


def unet_conv_ops(h: int, w: int, frames: int = 1) -> float:
    """The U-Net's ten 3x3 convs over ``frames`` inputs of h x w (157.5
    GFLOP a 500 x 500 frame)."""
    lv = unet_levels(h, w)
    return sum(conv3x3_ops(*lv[l], cin, cmid, frames)
               + conv3x3_ops(*lv[l], cmid, cout, frames)
               for _, l, cin, cmid, cout in UNET_BLOCKS)


def unet_ops(h: int, w: int, frames: int = 1) -> float:
    """The ten convs and the 1x1 ``outc``."""
    return unet_conv_ops(h, w, frames) + 2.0 * frames * h * w * UNET_OUT[0] \
        * UNET_OUT[1]


def fused_block_bytes(h: int, w: int, frames: int, elem: int = 2) -> float:
    """Bytes the five K3 blocks must move at least: each block's input
    (and upsample source) read once, its output (and pooled output) written
    once, its weights read once; activations of ``elem`` bytes."""
    lv = unet_levels(h, w)
    px = [a * b for a, b in lv]
    total = 0.0
    for name, l, cin, cmid, cout in UNET_BLOCKS:
        total += elem * 9 * (cin * cmid + cmid * cout)
        total += elem * frames * px[l] * cout            # output
        if name in ("inc", "down1"):
            total += elem * frames * px[l + 1] * cout    # pooled output
        if name in ("up1", "up2"):
            skip = cin - (128 if name == "up1" else 64)
            total += elem * frames * px[l] * skip        # skip input
            total += elem * frames * px[l + 1] * (cin - skip)  # half-res
        else:
            total += elem * frames * px[l] * cin
    return total


def fused_block_bound_s(h: int, w: int, frames: int) -> float:
    """K3's least time for one U-Net call (its five blocks) in bf16."""
    return bound_s(unet_conv_ops(h, w, frames),
                   fused_block_bytes(h, w, frames), "bf16")[0]


def mlp_row_ops() -> float:
    """Operations of the trunk and the head for one row (pixel) of one
    frame."""
    trunk = sum((2 * MLP_WIDTH if i - 1 == MLP_SKIP else MLP_WIDTH)
                * MLP_WIDTH for i in range(MLP_DEPTH))
    return 2.0 * (trunk + MLP_WIDTH * OUT_CH)


def fused_mlp_ops(rows: int, frames: int) -> float:
    """K1's operations for ``frames`` frames over ``rows`` shared uv rows:
    the entry and skip projections of the shared rows once, the trunk and
    the head per frame (``tools/bench_fused_mlp.ops``'s count; about 11.4
    GFLOP a frame of the 120 x 80 lip)."""
    return 2.0 * rows * 2 * UV_DIM * MLP_WIDTH + frames * rows * mlp_row_ops()


def fused_mlp_bytes(rows: int, frames: int, elem: int = 2) -> float:
    """K1's least bytes: the uv rows, the weights and the per-frame biases
    read once, the float32 rgb written once."""
    weights = elem * (2 * UV_DIM * MLP_WIDTH + sum(
        (2 * MLP_WIDTH if i - 1 == MLP_SKIP else MLP_WIDTH) * MLP_WIDTH
        for i in range(MLP_DEPTH)) + MLP_WIDTH * OUT_CH)
    return (elem * rows * UV_DIM + weights + 4 * frames * 2 * MLP_WIDTH
            + 4 * frames * rows * OUT_CH)


def fused_mlp_bound_s(rows: int, frames: int) -> float:
    return bound_s(fused_mlp_ops(rows, frames), fused_mlp_bytes(rows, frames),
                   "bf16")[0]


def serve_frame_ops(lip_h: int, lip_w: int, unet_h: int, unet_w: int,
                    frames: int) -> float:
    """Model operations of ``frames`` served frames: K1's MLP over the lip
    crop and the U-Net at the size the cell's path runs it."""
    return (fused_mlp_ops(lip_h * lip_w, frames)
            + unet_ops(unet_h, unet_w, frames))


def alexnet_ops(h: int, w: int) -> float:
    """LPIPS's five AlexNet convs on one h x w image."""
    total, c = 0.0, 3
    for i, (cout, k, s, p) in enumerate(ALEX):
        h = (h + 2 * p - k) // s + 1
        w = (w + 2 * p - k) // s + 1
        total += 2.0 * h * w * k * k * c * cout
        c = cout
        if i < 2:
            h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    return total


def depth_warp_ops(h: int, w: int) -> float:
    """The canonical-depth loss's warp of one frame: per pixel a 3x3
    back-projection (18), the depth scale (3), a 3x4 projection (24), the
    perspective divide and normalisation (6), a bilinear sample of 3
    channels (24)."""
    return 75.0 * h * w


def ensemble_render_ops(lip_h: int, lip_w: int, ensemble: int = 4) -> float:
    """The lip MLP's forward over the ensemble's shifted rows of one
    frame's crop (entry projections, trunk and head a row)."""
    rows = ensemble * lip_h * lip_w
    return rows * (2.0 * 2 * UV_DIM * MLP_WIDTH + mlp_row_ops())


def train_iter_ops(lip_h: int, lip_w: int, face_h: int, face_w: int,
                   frames: int, ensemble: int = 4) -> float:
    """Model operations of one stage-1 training iteration of ``frames``
    frames: 3x the forward of the trained nets (the lip MLP over the
    ensemble's rows, the U-Net, the canonical depth's warp), plus the
    frozen LPIPS forward on both images of each of its two terms (lip and
    face) and its backward to the rendered input (one forward's worth)."""
    mlp = ensemble_render_ops(lip_h, lip_w, ensemble)
    trained = frames * (mlp + unet_ops(face_h, face_w)
                        + depth_warp_ops(face_h, face_w))
    lpips = 3.0 * frames * (alexnet_ops(lip_h, lip_w)
                            + alexnet_ops(face_h, face_w))
    return 3.0 * trained + lpips


def conv_stack_ops(spec, size) -> float:
    """The convs of ``spec`` over one input of ``size`` (h, w, c)."""
    h, w, c = size
    total = 0.0
    for cout, (kh, kw), (sh, sw), p in spec:
        h, w = (h + 2 * p - kh) // sh + 1, (w + 2 * p - kw) // sw + 1
        total += 2.0 * h * w * kh * kw * c * cout
        c = cout
    return total


def syncnet_face_ops() -> float:
    return conv_stack_ops(SYNC_FACE, SYNC_FACE_IN)


def syncnet_audio_ops() -> float:
    return conv_stack_ops(SYNC_AUDIO, SYNC_AUDIO_IN)


def sync_iter_ops(lip_h: int, lip_w: int, face_h: int, face_w: int,
                  frames: int, ensemble: int = 4, window: int = SYNC_T
                  ) -> float:
    """Model operations of one sync-stage iteration of ``frames`` frames
    (sync loss on, U-Net frozen): stage 1's, with the U-Net frozen on the
    gradient path (2x its forward: the forward and the backward to its
    input, not 3x), plus the sync loss's ``window`` frames a frame, each an
    ensemble lip render (3x) and a frozen U-Net pass (2x), and SyncNet
    frozen: the face encoder on the rendered window with its backward to
    the input (2x) and on the negative window (1x), the audio encoder on
    the mel window twice (1x each)."""
    unet = unet_ops(face_h, face_w)
    stage1 = train_iter_ops(lip_h, lip_w, face_h, face_w, frames, ensemble)
    renders = frames * window * (
        3.0 * ensemble_render_ops(lip_h, lip_w, ensemble) + 2.0 * unet)
    sync = frames * (3.0 * syncnet_face_ops() + 2.0 * syncnet_audio_ops())
    return stage1 - frames * unet + renders + sync


def summary() -> Dict[str, float]:
    """The frozen counts at May geometry (tests hold them)."""
    return {"unet_conv_gflop_500": unet_conv_ops(500, 500) / 1e9,
            "fused_mlp_gflop_frame": fused_mlp_ops(9600, 1) / 1e9,
            "serve_gflop_frame": serve_frame_ops(80, 120, 500, 500, 1) / 1e9,
            "train_gflop_iter": train_iter_ops(80, 120, 500, 500, 1) / 1e9,
            "sync_gflop_iter": sync_iter_ops(80, 120, 500, 500, 1) / 1e9}
