"""The plain reference of the stage-1 training step of the May model, and
of Adam over its first steps.

The loss of a batch (Speech2Lip's stage 1 with the published May
settings): the lip crop rendered with the 4-offset local ensemble, its
photometric (MSE) and LPIPS terms; the composite with the black-hole
augmentation (on the steps whose draw asks for it) through the U-Net in
train mode (batch statistics), its photometric and LPIPS terms; the
canonical-depth photometric term (the observed face warped into the
canonical view through the learned depth and the tracked poses, compared on
the head-minus-face mask).  Gradients by autograd, Adam (b1 0.9, b2 0.999,
eps 1e-8, bias corrections rounded in float32).  The random draws of a step
(the ensemble's shift, the two hole fields and the augmentation's coin) are
inputs, as are the batch and the weights.

A training configuration names its reference module (its ``reference``
key); the training driver calls two functions of it:

- ``read_batches(root, cfg, indices)``: the checked steps' batches read
  from the identity's files at ``root``, one dict of numpy fields a step
  (``indices``: each step's frame positions);
- ``steps(cfg, weights, frozen, batches, draws, precision)``: the steps
  followed from ``weights`` = (params, U-Net params, U-Net state) with the
  frozen nets ``frozen`` ({"lpips": tree}, and "syncnet": (params, state)
  when the stage has the sync loss), as ``steps`` below returns them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from portbench.reference import batch as refbatch
from portbench.reference import common as C
from portbench.traffic.weights import tree_leaves, tree_paths

ALEX_POOL_AFTER = (0, 1)
ALEX_SPEC = ((4, 2), (1, 2), (1, 1), (1, 1), (1, 1))  # (stride, pad)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def lpips(q, lp, x, y):
    """LPIPS (AlexNet v0.1) distance [B] of NHWC images in [-1, 1]."""
    shift = torch.tensor(SHIFT, device=x.device)
    scale = torch.tensor(SCALE, device=x.device)

    def feats(v):
        out, h = [], (v - shift) / scale
        for i, ((s, pd), conv) in enumerate(zip(ALEX_SPEC, lp["convs"])):
            h = torch.relu(C.conv2d(q, conv, h, stride=s, padding=pd))
            out.append(h)
            if i in ALEX_POOL_AFTER:
                h = C.maxpool(h, 3, 2)
        return out

    total = 0.0
    for f1, f2, lin in zip(feats(x), feats(y), lp["lins"]):
        n1 = f1 / (torch.sqrt((f1 * f1).sum(-1, keepdim=True)) + 1e-10)
        n2 = f2 / (torch.sqrt((f2 * f2).sum(-1, keepdim=True)) + 1e-10)
        d = (n1 - n2) ** 2
        total = total + C.conv2d(q, lin, d, padding=0).mean(dim=(1, 2, 3))
    return total


def perceptual(q, lp, pred, target, weight):
    return weight * lpips(q, lp, pred * 2.0 - 1.0, target * 2.0 - 1.0).mean()


def ensemble_lip(q, p, audio, t, eps_u, lip_h, lip_w):
    """The lip crop [B, lip_h, lip_w, 3] as the LIIF local ensemble of four
    renders at the uv grid shifted by (+-0.5/w, +-0.5/h) plus a per-frame
    shift eps, clamped to [0, 1], each weighted by the area of the opposite
    corner's rectangle."""
    b = audio.shape[0]
    codes = C.encode_audio(q, p, audio)
    base, skip = C.frame_features(q, p, codes, t)
    uv = C.uv_grid(lip_w, lip_h, audio.device)                  # [N, 2]
    rx, ry = 0.5 / lip_w, 0.5 / lip_h
    off = torch.tensor([[-rx, -ry], [-rx, ry], [rx, -ry], [rx, ry]],
                       device=uv.device)
    eps = ((0.5 / lip_h) * eps_u / 2.0)[:, None, None, None]
    sh = torch.clamp(uv[None, None] + off[None, :, None] + eps, 0.0, 1.0)
    area = ((sh[..., 0] - uv[:, 0]) * (sh[..., 1] - uv[:, 1])).abs() + 1e-9
    wts = area.flip(1) / area.sum(1, keepdim=True)              # [B, 4, N]
    out = C.mlp(q, p, C.fourier(sh), base[:, None, None], skip[:, None, None])
    return (out * wts[..., None]).sum(1).reshape(b, lip_h, lip_w, 3)


def pose(euler, trans):
    """[B, 4, 4] camera transforms: Rx @ Ry @ Rz of the euler angles and
    the translation, components 1 and 2 of both negated."""
    flip = torch.tensor([1.0, -1.0, -1.0], device=euler.device)
    e, t = euler * flip, trans * flip
    th, ph, ps = e[:, 0], e[:, 1], e[:, 2]
    one, zero = torch.ones_like(th), torch.zeros_like(th)

    def cols(*vs):
        return torch.stack([torch.stack(v, -1) for v in vs], -1)

    rx = cols((one, zero, zero), (zero, th.cos(), th.sin()),
              (zero, -th.sin(), th.cos()))
    ry = cols((ph.cos(), zero, -ph.sin()), (zero, one, zero),
              (ph.sin(), zero, ph.cos()))
    rz = cols((ps.cos(), -ps.sin(), zero), (ps.sin(), ps.cos(), zero),
              (zero, zero, one))
    top = torch.cat([rx @ ry @ rz, t[..., None]], -1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                          device=euler.device).expand(euler.shape[0], 1, 4)
    return torch.cat([top, bottom], 1)


def depth_loss(depth, batch, focal):
    """Masked MSE between the canonical face and the observed face warped
    into the canonical view: back-project each canonical pixel by the
    depth, move it by inv(T_obs inv(T_can)), project it (pixels over
    size - 1 to [-1, 1]), sample with border padding."""
    b, h, w, _ = batch["rgb_face_ori"].shape
    dev = depth.device
    k = torch.tensor([[focal, 0.0, w / 2.0, 0.0], [0.0, focal, h / 2.0, 0.0],
                      [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                     device=dev)
    t_can = pose(batch["canonical_euler"], batch["canonical_trans"])
    t_obs = pose(batch["euler"], batch["trans"])
    rel = torch.linalg.inv(t_obs @ torch.linalg.inv(t_can))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1),
                       torch.ones(h * w, device=dev)])
    cam = depth.reshape(1, -1) * (torch.linalg.inv(k)[:3, :3] @ pix)
    pts = torch.cat([cam, torch.ones_like(cam[:1])])
    cam2 = (k @ rel)[:, :3, :] @ pts                             # [B, 3, N]
    z = cam2[:, 2]
    gx = cam2[:, 0] / (z + 1e-7) / (w - 1)
    gy = cam2[:, 1] / (z + 1e-7) / (h - 1)
    grid = torch.stack([(gx - 0.5) * 2.0, (gy - 0.5) * 2.0], -1)
    pred = C.grid_sample(batch["rgb_face_ori"], grid.reshape(b, h, w, 2),
                         padding="border")
    mask = batch["mask_head_canonical"] * (1.0 - batch["mask_face_canonical"])
    mask = mask.expand_as(pred)
    return ((pred - batch["rgb_face_zero"]) ** 2 * mask).sum() / (
        mask.sum() + 1e-6)


def loss(q, p, up, lp, batch, draws, cfg) -> torch.Tensor:
    """The stage-1 loss of one batch (tensors on one device)."""
    m, tr, d = cfg["model"], cfg["training"], cfg["data"]
    lh, lw = batch["rgb"].shape[1:3]
    lip_x = int(batch["lip_lefttop_x"][0])
    lip_y = int(batch["lip_lefttop_y"][0])
    w_rgb = float(m.get("lambda_rgb", 1.0))
    w_pf = float(tr["w_post_fusion"])
    w_perc = float(tr["w_perceptual_loss"])
    lip = ensemble_lip(q, p, batch["audio"], batch["index"].float(),
                       draws["lip"]["eps_u"], lh, lw)
    total = w_rgb * ((lip - batch["rgb"]) ** 2).mean()
    # AlexNet's features of an image under ~32 px are empty: the lip term
    # needs both sides of the crop at 32 or more
    if tr["use_perceptual_loss"] and min(lh, lw) >= 32:
        total = total + perceptual(q, lp, lip, batch["rgb"], w_perc)

    fz, gt = batch["rgb_face_zero"], batch["rgb_face_ori"]
    h, w = fz.shape[1:3]
    merged = C.paste(lip, fz, batch["mask_lip_canonical"], lip_x, lip_y)
    warped = C.grid_sample(merged, batch["coord"])
    cover = C.box_coverage(batch["coord"], C.lip_box(
        lip_x, lip_y, lh, lw, int(d.get("expand_mask_divisor", 5))), h, w)
    if m["use_post_fusion_blackaug"]:
        face_obs = batch["blackaug_face_mask"]
        n1 = torch.where(face_obs > 0, (draws["hole1"] >= 1e-6).float(), 1.0)
        n2 = torch.where(face_obs > 0, (draws["hole2"] >= 1e-6).float(), 1.0)
        if bool(draws["apply_u"] > 0.5):
            warped, gt = (n1 * warped + (1 - n1) * gt,
                          n2 * gt + (1 - n2) * warped)
    x = cover * warped + (1.0 - cover) * gt
    face = C.unet(q, up, None, x, train=True)
    total = total + w_rgb * w_pf * ((face - batch["rgb_face_ori"]) ** 2).mean()
    if tr["use_perceptual_loss"]:
        total = total + perceptual(q, lp, face, batch["rgb_face_ori"],
                                   w_perc * w_pf)
    if tr["use_canonical_depth_loss_photo_v2"]:
        total = total + depth_loss(p["canonical_depth"], batch,
                                   float(d["face_img_focal"]))
    return total


class Adam:
    def __init__(self, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def step(self, leaves, grads, mu, nu, count):
        f32 = lambda v: float(np.float32(v))
        count += 1
        c1 = f32(1 - f32(f32(self.b1) ** count))
        c2 = f32(1 - f32(f32(self.b2) ** count))
        new, mu2, nu2 = [], [], []
        for x, g, m, v in zip(leaves, grads, mu, nu):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * g * g + self.b2 * v
            new.append(x - self.lr * (m / c1) / (torch.sqrt(v / c2)
                                                 + self.eps))
            mu2.append(m)
            nu2.append(v)
        return new, mu2, nu2, count


def read_batches(root: str, cfg, indices) -> List[Dict[str, np.ndarray]]:
    """Each step's frames read by ``reference/batch.py``, stacked."""
    ident = refbatch.Identity(root, cfg["data"])
    out = []
    for idx in indices:
        frames = [ident.frame(int(i)) for i in idx]
        out.append({k: np.stack([f[k] for f in frames]) for k in frames[0]})
    return out


def steps(cfg, weights, frozen, batches: List[Dict[str, torch.Tensor]],
          draws: List[Dict[str, Any]], precision: str = "f32"
          ) -> Dict[str, Any]:
    """Follow ``len(batches)`` stage-1 steps from ``weights`` = (params,
    unet params, unet state; the U-Net trains on batch statistics): each
    step's loss and the global gradient norm, the first step's gradient by
    leaf and the parameters after the last step, keyed by path under
    ``model/`` and ``unet/``."""
    q = C.Precision(precision)
    tree = {"model": weights[0], "unet": weights[1]}
    paths = tree_paths(tree)
    leaves = [t.detach().float().clone() for t in tree_leaves(tree)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    count = 0
    opt = Adam(float(cfg["training"]["learning_rate"]))
    lp = C.f32_tree(frozen["lpips"])
    out: Dict[str, Any] = {"loss": [], "grad_norm": []}
    n_model = len(tree_leaves(weights[0]))
    with C.no_tf32():
        for k, (batch, dr) in enumerate(zip(batches, draws)):
            xs = [t.detach().requires_grad_(True) for t in leaves]
            p = _unflatten(weights[0], xs[:n_model])
            up = _unflatten(weights[1], xs[n_model:])
            total = loss(q, p, up, lp, batch, dr, cfg)
            grads = torch.autograd.grad(total, xs, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, xs)]
            out["loss"].append(float(total.detach()))
            out["grad_norm"].append(float(torch.sqrt(sum(
                (g.double() ** 2).sum() for g in grads))))
            if k == 0:
                out["grad"] = dict(zip(paths, [g.detach() for g in grads]))
            leaves, mu, nu, count = opt.step(
                [x.detach() for x in xs], [g.detach() for g in grads], mu,
                nu, count)
    out["params"] = dict(zip(paths, leaves))
    return out


def _unflatten(tree, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [go(v) for v in t]
        return next(it)

    return go(tree)


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's | ||got|| - ||ref|| | over the larger of its ||ref|| and
    the median leaf's ||ref||; ``keep`` limits the leaves.  A leaf missing
    from ``got`` reads inf."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    out = {}
    for k in names:
        if k not in got:
            out[k] = math.inf
            continue
        v = abs(float(got[k].double().norm()) - rn[k]) / max(rn[k], med,
                                                             1e-30)
        out[k] = v if math.isfinite(v) else math.inf
    return out


def moved(grad: Dict[str, torch.Tensor], frac: float = 1e-3):
    """Leaves whose reference gradient norm is at least ``frac`` of the
    median leaf's: the others move under Adam by round-off alone."""
    n = {k: float(v.double().norm()) for k, v in grad.items()}
    med = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= frac * med}
