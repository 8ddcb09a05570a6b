"""The training step (counterpart of ``speech2lip_tpu/train/train_step.py``):
stage 1 and the sync stage, with Adam.

The step renders the lip crop with the 4-offset local ensemble, composites
it into the observed face with the black-hole augmentation, runs the
post-fusion U-Net in train mode, and adds the photometric, LPIPS,
canonical-depth and (in the sync stage) SyncNet losses.  With
``StepStatics.pallas_gather`` the step's two gathers go through the K7
sampler ``hat_sample`` (K2 forward, CUDA backward kernels): the blackaug
window gather of the composite, which needs d/dsrc, and the canonical-depth
sample, which needs d/dgrid.

Randomness enters as explicit tensors (``draw_noise``), since the JAX
package's PRNG streams cannot be reproduced in PyTorch.  Mixed precision
follows the JAX step: float32 master weights cast to bfloat16 inside the
forward (autograd casts the gradients back), pose and coordinate inputs
kept float32, the BatchNorm state returned in float32.  The step is
functional: it returns new parameter and optimizer tensors and leaves the
old ones as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from speech2lip_tpu_torch.infer.renderer import batched_frame_feature
from speech2lip_tpu_torch.models import syncnet as syncnet_mod
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.models import unet_light
from speech2lip_tpu_torch.ops import nn as tnn
from speech2lip_tpu_torch.ops.coords import ensemble_coords, get_coords
from speech2lip_tpu_torch.ops.embedders import fourier_embed
from speech2lip_tpu_torch.ops.geometry import (backproject_depth, intrinsics,
                                               inverse_warp, project_3d,
                                               rel_pose_obs2can,
                                               warp_grid_crop,
                                               warp_grid_points)
from speech2lip_tpu_torch.ops.grid_sample import grid_sample_onehot_border
from speech2lip_tpu_torch.ops.kernels.hat_sample import hat_sample
from speech2lip_tpu_torch.train import losses

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# batch entries that stay float32 under mixed precision (geometry)
_FP32_KEYS = ("coord", "coord_window", "euler", "trans", "canonical_euler",
              "canonical_trans")


class TrainState(NamedTuple):
    params: Any          # talking_face params (incl. canonical_depth)
    unet_params: Any
    unet_state: Any      # BN running stats
    opt_state: Any
    it: int


@dataclass(frozen=True)
class StepStatics:
    """Static geometry and staging flags of the step."""
    lip_h: int
    lip_w: int
    lip_x: int
    lip_y: int
    face_h: int
    face_w: int
    focal: float
    expand_divisor: int = 5
    w_photometric: float = 1.0
    w_perceptual: float = 0.01
    w_post_fusion: float = 1.0
    w_sync: float = 0.01
    use_perceptual: bool = True
    use_canonical_depth_loss: bool = True
    use_blackaug: bool = True
    sync_on: bool = False          # it > sync_start_iter
    postnet_frozen: bool = False   # it > postnet_freeze_iter
    sync_T: int = 5
    face_bbox: Tuple[int, int, int, int] = (0, 0, 96, 96)  # x, y, x2, y2
    ensemble: bool = True
    window: Optional[Tuple[int, int, int, int]] = None  # validated warp win
    # static bbox (x0, x1, y0, y1) of the canonical-depth loss mask's
    # support (trainer.depth_loss_box): warp and sample only that crop
    depth_loss_box: Optional[Tuple[int, int, int, int]] = None
    add_noise_uv: bool = False
    add_noise_audio: bool = False
    compute_dtype: str = "float32"
    # the step's two gathers through the K7 sampler hat_sample
    pallas_gather: bool = False
    # with pallas_gather: K2/K7 launch their CUDA kernels on CUDA tensors;
    # False runs their plain versions on any device (the plain path)
    use_kernels: bool = True


# -- parameter trees (nested dicts / lists of tensors) -----------------------

def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure filled with ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# -- randomness --------------------------------------------------------------

def draw_noise(st: StepStatics, batch_size: int, device=None,
               generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The step's random draws, all float32:
    ``lip`` (and ``sync_lip`` for the B*T sync frames): ``eps_u``
    uniform [n] for the ensemble shift, ``uv`` normal [lip_h*lip_w, 2] and
    ``audio`` normal [n, 64] when those noises are on; ``hole1``/``hole2``
    normal [B, face_h, face_w, 1] and ``apply_u`` a uniform scalar for the
    black-hole augmentation."""
    kw = dict(device=device, generator=generator)

    def lip(n):
        d = {"eps_u": torch.rand(n, **kw)}
        if st.add_noise_uv:
            d["uv"] = torch.randn(st.lip_h * st.lip_w, 2, **kw)
        if st.add_noise_audio:
            d["audio"] = torch.randn(n, tf.AUDIO_CODE_DIM, **kw)
        return d

    draws = {"lip": lip(batch_size)}
    if st.use_blackaug:
        shape = (batch_size, st.face_h, st.face_w, 1)
        draws["hole1"] = torch.randn(shape, **kw)
        draws["hole2"] = torch.randn(shape, **kw)
        draws["apply_u"] = torch.rand((), **kw)
    if st.sync_on:
        draws["sync_lip"] = lip(batch_size * st.sync_T)
    return draws


# -- the step ----------------------------------------------------------------

def render_lip_ensemble(params, audio, t_indices, draws, st: StepStatics):
    """Train-time lip render with the 4-offset local ensemble.  audio
    [B, 16, 29]; t_indices [B]; draws: one ``lip`` entry of ``draw_noise``.
    Returns [B, lip_h, lip_w, 3]."""
    b = audio.shape[0]
    codes = tf.encode_audio(params, audio)
    if st.add_noise_audio:
        codes = codes + 0.01 * draws["audio"]
    base, skip = batched_frame_feature(params, codes, t_indices)
    coords = get_coords(st.lip_w, st.lip_h, device=audio.device)
    if st.add_noise_uv:
        coords = coords + (0.5 / st.lip_w) * draws["uv"]
    if not st.ensemble:
        out = tf.mlp_trunk(params, fourier_embed(coords, 10)[None],
                           base[:, None, :], skip[:, None, :])
        return out.reshape(b, st.lip_h, st.lip_w, 3)
    eps = (0.5 / st.lip_h) * draws["eps_u"] / 2.0
    shifted, weights = ensemble_coords(coords, st.lip_w, st.lip_h, eps)
    out = tf.mlp_trunk(params, fourier_embed(shifted, 10),
                       base[:, None, None, :], skip[:, None, None, :])
    rgb = (out * weights[..., None]).sum(1)                  # [B, N, 3]
    return rgb.reshape(b, st.lip_h, st.lip_w, 3)


def _gather_kw(st: StepStatics):
    return dict(pallas_gather=st.pallas_gather,
                use_kernels=st.pallas_gather and st.use_kernels)


def _unet_dtype(unet_params):
    return unet_params["inc"]["conv1"]["w"].dtype


def _fuse_frame(params, unet_params, unet_state, rgb_lip, batch, coord,
                draws, st: StepStatics, blackaug: bool):
    """Post-fusion composite + U-Net for a batch of frames.  Returns (face,
    new U-Net BN state)."""
    noise = None
    static_warp = None
    if blackaug:
        noise = (losses.black_hole_noise(draws["hole1"]),
                 losses.black_hole_noise(draws["hole2"]),
                 draws["apply_u"] > 0.5)  # on half of the steps
        if st.window is not None and "warped_base" in batch:
            static_warp = (batch["warped_base"], batch["blackaug_face_mask"])
    unet_in, _, _ = tf.post_fusion_composite(
        rgb_lip, batch["rgb_face_zero"], batch["rgb_face_ori"],
        batch["mask_lip_canonical"], coord, st.lip_x, st.lip_y,
        expand_divisor=st.expand_divisor, blackaug_noise=noise,
        window=st.window, static_warp=static_warp, **_gather_kw(st))
    # the float32 noise, grid and box mask promote the blend: realign it
    unet_in = unet_in.to(_unet_dtype(unet_params))
    return unet_light.apply(unet_params, unet_state, unet_in,
                            train=not st.postnet_frozen)


def _depth_loss(params, frozen, batch, st: StepStatics):
    """The canonical-depth photometric loss: warp the observed face into
    the canonical view through the learned depth and compare it with the
    canonical face on the mask head * (1 - face)."""
    dev = params["canonical_depth"].device
    b = batch["euler"].shape[0]
    k = torch.from_numpy(intrinsics(st.focal, st.face_h, st.face_w)).to(dev)
    inv_k = torch.linalg.inv(k)
    depth = params["canonical_depth"]
    rel = rel_pose_obs2can(batch["canonical_euler"], batch["canonical_trans"],
                           batch["euler"], batch["trans"])     # [B, 4, 4]
    src = batch["rgb_face_ori"]
    mask_fn = lambda sl: (batch["mask_head_canonical"][sl]
                          * (1.0 - batch["mask_face_canonical"][sl]))
    full = (slice(None),)
    if st.depth_loss_box is not None:
        # the mask's support lies in the box: the masked MSE over the crop
        # equals the full-frame one
        x0, x1, y0, y1 = st.depth_loss_box
        grid = warp_grid_crop(depth, rel, k, inv_k, st.depth_loss_box,
                              st.face_h, st.face_w).reshape(b, -1, 2)
        if st.pallas_gather:
            pred = hat_sample(src, grid, border=True,
                              kernels=st.use_kernels)
        else:
            pred = grid_sample_onehot_border(src, grid)
        sl = (slice(None), slice(y0, y1), slice(x0, x1))
        return losses.photometric_loss(
            pred.reshape(b, y1 - y0, x1 - x0, -1), batch["rgb_face_zero"][sl],
            mask=mask_fn(sl))
    if st.pallas_gather and "depth_pts" in frozen:
        # points path: mask, target and warp targets are per-identity
        # constants, so only the mask's S support points are warped,
        # sampled and compared
        dp = frozen["depth_pts"]
        depth_pts = depth.reshape(-1)[dp["ys"] * st.face_w + dp["xs"]]
        grids = warp_grid_points(depth_pts, dp["xs"], dp["ys"], rel, k,
                                 inv_k, st.face_h, st.face_w)  # [B, S, 2]
        pred = hat_sample(src, grids, border=True, kernels=st.use_kernels)
        tgt = dp["rgb_zero_pts"].to(pred.dtype)
        return losses.photometric_loss(
            pred, tgt[None].expand_as(pred),
            mask=dp["w"][None].to(pred.dtype).expand_as(pred))
    if st.pallas_gather:
        grids, _ = project_3d(backproject_depth(depth, inv_k), k, rel,
                              st.face_h, st.face_w)
        pred = hat_sample(src, grids.reshape(b, -1, 2), border=True,
                          kernels=st.use_kernels)
        pred = pred.reshape(b, st.face_h, st.face_w, -1)
    else:
        pred, _ = inverse_warp(src, depth, rel, k, inv_k)
    return losses.photometric_loss(pred, batch["rgb_face_zero"],
                                   mask=mask_fn(full))


def _sync_loss(params, unet_params, unet_state, frozen, batch, draws,
               st: StepStatics):
    """The SyncNet contrastive loss on the rendered T-frame window: its T
    re-renders fold into one render + composite + U-Net at batch B*T."""
    sync_p, sync_s = frozen["syncnet"]
    b = batch["audio"].shape[0]
    T = st.sync_T
    dev = batch["audio"].device
    offs = torch.arange(T, dtype=torch.float32, device=dev)
    cur_t = torch.minimum(batch["index"].float()[:, None] + offs[None, :],
                          batch["total_frame"].float()[:, None] - 1.0)
    aw = batch["audio_window"][:, :T]
    lip_bt = render_lip_ensemble(params, aw.reshape(b * T, *aw.shape[2:]),
                                 cur_t.reshape(-1), draws["sync_lip"], st)

    def tile(x):  # [B, ...] -> [B*T, ...], b-major
        return x[:, None].expand(b, T, *x.shape[1:]).reshape(
            b * T, *x.shape[1:])

    cw = batch["coord_window"][:, :T]
    unet_in, _, _ = tf.post_fusion_composite(
        lip_bt, tile(batch["rgb_face_zero"]), tile(batch["rgb_face_ori"]),
        tile(batch["mask_lip_canonical"]), cw.reshape(b * T, *cw.shape[2:]),
        st.lip_x, st.lip_y, expand_divisor=st.expand_divisor,
        window=st.window, **_gather_kw(st))
    fused, _ = unet_light.apply(unet_params, unet_state,
                                unet_in.to(_unet_dtype(unet_params)),
                                train=False)
    x0, y0, x1, y1 = st.face_bbox
    crop = tnn.resize_linear(fused[:, y0:y1, x0:x1], 96, 96)
    rgb_window = crop.reshape(b, T, 96, 96, 3)
    mel = batch["mel"].float().permute(0, 2, 3, 1)            # [B, 80, 16, 1]
    ones = torch.ones(b, device=dev)
    a_pos, v_pos = syncnet_mod.apply(
        sync_p, sync_s, mel,
        losses.sync_window_to_syncnet_input(rgb_window.float()))
    # the negative window comes in the reference layout [B, 3, T, 96, 96]
    neg = batch["rgb_window_neg"].float().permute(0, 2, 3, 4, 1)
    a_neg, v_neg = syncnet_mod.apply(
        sync_p, sync_s, mel, losses.sync_window_to_syncnet_input(neg))
    return st.w_sync * (losses.cosine_bce_loss(a_pos, v_pos, ones)
                        + losses.cosine_bce_loss(a_neg, v_neg, 0.0 * ones))


def compute_losses(params, unet_params, unet_state, frozen, batch, draws,
                   st: StepStatics):
    """Every loss term of one batch.

    frozen: {'lpips': tree, 'syncnet': (params, state)?, 'depth_pts':
    trainer.depth_loss_points(...)?}; batch: the JAX package's sample dict
    of tensors on one device; draws: ``draw_noise(st, B)``.
    Returns (total_loss, (metrics, new_unet_state)).
    """
    metrics: Dict[str, torch.Tensor] = {}
    t_idx = batch["index"].float()

    if st.compute_dtype != "float32":
        cd = _DTYPES[st.compute_dtype]
        cast = lambda t: tree_map(
            lambda x: x.to(cd) if x.dtype == torch.float32 else x, t)
        params = cast(params)
        # geometry runs in float32; as in the JAX step the depth goes
        # through the working dtype first, so its values (and gradient)
        # carry bfloat16 rounding
        params["canonical_depth"] = params["canonical_depth"].float()
        unet_params = cast(unet_params)
        unet_state = cast(unet_state)
        batch = {k: (v.to(cd) if v.dtype == torch.float32
                     and k not in _FP32_KEYS else v)
                 for k, v in batch.items()}
    if st.postnet_frozen:
        unet_params = tree_map(torch.Tensor.detach, unet_params)

    # 1. lip render + photometric + perceptual
    rgb_lip = render_lip_ensemble(params, batch["audio"], t_idx,
                                  draws["lip"], st)
    loss_rgb_lip = losses.photometric_loss(rgb_lip, batch["rgb"],
                                           weight=st.w_photometric)
    total = loss_rgb_lip
    loss_rgb_metric = loss_rgb_lip
    # AlexNet LPIPS needs inputs of at least ~32 px
    if st.use_perceptual and min(st.lip_h, st.lip_w) >= 32:
        lp = losses.perceptual_loss(frozen["lpips"], rgb_lip.float(),
                                    batch["rgb"].float(),
                                    weight=st.w_perceptual)
        total = total + lp
        metrics["loss_perceptual_lip"] = lp

    # 2. post-fusion face + losses
    face, new_unet_state = _fuse_frame(
        params, unet_params, unet_state, rgb_lip, batch, batch["coord"],
        draws, st, blackaug=st.use_blackaug)
    loss_rgb_face = losses.photometric_loss(
        face, batch["rgb_face_ori"],
        weight=st.w_photometric * st.w_post_fusion)
    total = total + loss_rgb_face
    loss_rgb_metric = loss_rgb_metric + loss_rgb_face
    if st.use_perceptual:
        lpf = losses.perceptual_loss(frozen["lpips"], face.float(),
                                     batch["rgb_face_ori"].float(),
                                     weight=st.w_perceptual * st.w_post_fusion)
        total = total + lpf
        metrics["loss_perceptual_face"] = lpf

    # 3. canonical-depth photometric loss
    if st.use_canonical_depth_loss:
        ld = _depth_loss(params, frozen, batch, st)
        total = total + ld
        metrics["loss_canonical_depth_photo"] = ld

    # 4. SyncNet contrastive loss
    if st.sync_on and "syncnet" in frozen:
        ls = _sync_loss(params, unet_params, unet_state, frozen, batch,
                        draws, st)
        total = total + ls
        metrics["loss_sync"] = ls

    metrics["loss_rgb"] = loss_rgb_metric
    metrics["loss"] = total
    metrics["psnr"] = losses.psnr_from_mse(loss_rgb_metric)
    if st.compute_dtype != "float32":
        new_unet_state = tree_map(lambda x: x.float(), new_unet_state)
    return total, (metrics, new_unet_state)


# -- optimizer and step ------------------------------------------------------

class Adam:
    """Adam over flat lists of float32 tensors, as the JAX package's Adam
    computes it, with a piecewise-constant learning rate whose milestones
    count iterations, as in the JAX package's schedule: the rate is scaled
    by ``gamma`` once the step count reaches each milestone."""

    def __init__(self, learning_rate: float, milestones=(), gamma: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        self.b1, self.b2, self.eps = b1, b2, eps

    def lr(self, count: int) -> float:
        v = self.learning_rate
        for m in self.milestones:
            if count >= m:
                v *= self.gamma
        return v

    def init(self, leaves) -> Dict[str, Any]:
        return {"count": 0,
                "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    def update(self, grads, state):
        """(updates, new_state) for gradients ``grads``; the updates are
        added to the parameters."""
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        # the bias corrections in float32, as the JAX package rounds them
        f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))
        mu_hat = torch._foreach_div(mu, f32(1 - f32(f32(b1) ** count)))
        nu_hat = torch._foreach_div(nu, f32(1 - f32(f32(b2) ** count)))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                     -self.lr(state["count"]))
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(cfg) -> Adam:
    """Adam with the configured rate, decayed by ``scheduler_gamma`` at
    each of ``scheduler_milestones`` (in iterations)."""
    tr = cfg["training"]
    return Adam(tr["learning_rate"], tr["scheduler_milestones"],
                tr["scheduler_gamma"])


def init_train_state(params, unet_params, unet_state,
                     optimizer: Adam) -> TrainState:
    leaves = tree_leaves({"model": params, "unet": unet_params})
    return TrainState(params, unet_params, unet_state,
                      optimizer.init(leaves), 0)


def loss_and_grads(params, unet_params, unet_state, frozen, batch, draws,
                   st: StepStatics):
    """``compute_losses`` and its gradients with respect to every leaf of
    {"model": params, "unet": unet_params}, in ``tree_leaves`` order (zeros
    for the U-Net when ``postnet_frozen``).  Returns (grads, metrics with
    ``grad_norm``, new U-Net BN state, the trainable tree)."""
    trainable = {
        "model": tree_map(lambda t: t.detach().requires_grad_(True), params),
        "unet": tree_map(lambda t: t.detach().requires_grad_(
            not st.postnet_frozen), unet_params)}
    total, (metrics, new_unet_state) = compute_losses(
        trainable["model"], trainable["unet"], unet_state, frozen, batch,
        draws, st)
    leaves = tree_leaves(trainable)
    need = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(total, need, allow_unused=True))
    grads = [next(got) if t.requires_grad else None for t in leaves]
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
    return grads, metrics, new_unet_state, trainable


def make_train_step(optimizer: Adam, st: StepStatics, frozen):
    """The train step ``step(state, batch, draws) -> (new_state, metrics)``.

    Metrics are 0-d tensors and include ``grad_norm``, the global L2 norm
    of the gradients.  With ``postnet_frozen`` the U-Net's gradients are
    zero and its Adam updates are masked, not only its gradients: its
    parameters stay bit-identical (Adam's moments would otherwise keep
    moving them for ~1/(1-b1) steps)."""

    def step(state: TrainState, batch, draws):
        grads, metrics, new_unet_state, trainable = loss_and_grads(
            state.params, state.unet_params, state.unet_state, frozen, batch,
            draws, st)
        leaves = tree_leaves(trainable)
        updates, new_opt = optimizer.update(grads, state.opt_state)
        n_model = len(tree_leaves(trainable["model"]))
        new_leaves = [
            t.detach() if st.postnet_frozen and i >= n_model
            else (t + u).detach()
            for i, (t, u) in enumerate(zip(leaves, updates))]
        new = tree_unflatten(trainable, new_leaves)
        new_state = TrainState(new["model"], new["unet"], new_unet_state,
                               new_opt, state.it + 1)
        return new_state, metrics

    return step
