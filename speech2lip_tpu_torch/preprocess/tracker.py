"""3DMM face tracker, the 4-phase per-video fit (counterpart of
``speech2lip_tpu/preprocess/tracker.py``):

  find_focal  grid search of the focal length, a landmark fit per
              candidate;
  phase a     pose-only landmark fit, all frames jointly;
  phase b     + identity / expression with L2 regularizers;
  phase c     + photometric fit on ``batch_size`` key frames through the
              rasterizer and fixed-visibility shading;
  phase d     sliding-window refinement with a temporal Laplacian on rigid
              vertices.

Each phase is a loop of eager Adam steps (``train_step.Adam``, the JAX
package's optax Adam and piecewise-constant rates), one Adam per parameter
as there, restarted at step 0 by every loop.  A step's work stays on the
device: the loop reads nothing back.  The photometric term is a mean of
per-frame terms, computed ``photo_chunk`` frames at a time under
activation checkpointing; under a ``parallel.mesh`` mesh its frames split
over the data axis.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from speech2lip_tpu_torch.ops.rasterize import (gather_rows, rasterize,
                                                recompute_barycentrics)
from speech2lip_tpu_torch.parallel import mesh as mesh_mod
from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
from speech2lip_tpu_torch.train.train_step import Adam


def cal_lan_loss(proj_lan, gt_lan):
    """Mean-squared landmark error."""
    return torch.mean((proj_lan - gt_lan) ** 2)


def cal_col_loss(pred_img, gt_img, mask):
    """Masked per-pixel colour distance: the mean over frames of
    sum(|pred - gt|_2 * mask) / 255 / sum(mask)."""
    # + eps: d sqrt / dx at exactly matching pixels would be NaN
    dist = (torch.sqrt(torch.sum((pred_img - gt_img) ** 2, dim=3) + 1e-12)
            * mask / 255.0)
    return torch.mean(dist.sum((1, 2))
                      / torch.clamp_min(mask.sum((1, 2)), 1e-6))


def cal_lap_loss(x):
    """Temporal Laplacian smoothness, [-0.5, 1, -0.5] over the last axis,
    mean square.  x: [..., T]."""
    lap = x[..., 1:-1] - 0.5 * x[..., :-2] - 0.5 * x[..., 2:]
    return torch.mean(lap ** 2)


def schedule(rate: float, boundaries: Optional[Dict[int, float]] = None):
    """An Adam whose rate starts at ``rate`` and is scaled at each step
    count of ``boundaries`` ({count: scale}, one scale for all), as the
    JAX package's ``piecewise_constant_schedule``."""
    boundaries = boundaries or {}
    scales = set(boundaries.values())
    if len(scales) > 1:
        raise ValueError("one scale for all boundaries")
    return Adam(rate, sorted(boundaries), scales.pop() if scales else 1.0)


def adam_loop(loss_fn: Callable, params: Dict[str, torch.Tensor],
              opts: Dict[str, Adam], n_iters: int,
              mesh=None) -> Dict[str, torch.Tensor]:
    """``n_iters`` Adam steps on ``loss_fn(params)`` from a fresh optimizer
    state (step 0).  ``opts`` maps each key to its Adam; keys whose Adams
    are the same object are updated together.  Under a ``mesh`` the loss
    splits its frames over the ranks (``FaceTracker.col_loss``) and each
    step's gradients are averaged over them, so every rank takes the same
    steps."""
    keys = list(params)
    p = {k: params[k].detach().clone() for k in keys}
    groups: Dict[int, list] = {}
    for k in keys:
        groups.setdefault(id(opts[k]), []).append(k)
    states = {g: opts[ks[0]].init([p[k] for k in ks])
              for g, ks in groups.items()}
    for _ in range(n_iters):
        q = {k: p[k].requires_grad_(True) for k in keys}
        loss = loss_fn(q)
        got = torch.autograd.grad(loss, [q[k] for k in keys],
                                  allow_unused=True)
        if mesh is not None:
            got = mesh_mod.mean_tensors(
                [torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(keys, got)], mesh, mesh_mod.DATA)
        grads = dict(zip(keys, got))
        with torch.no_grad():
            for g, ks in groups.items():
                gs = [grads[k] if grads[k] is not None
                      else torch.zeros_like(p[k]) for k in ks]
                upd, states[g] = opts[ks[0]].update(gs, states[g])
                for k, u in zip(ks, upd):
                    p[k] = p[k].detach() + u
    return {k: v.detach() for k, v in p.items()}


@dataclass
class TrackerConfig:
    id_dim: int = 100
    exp_dim: int = 79
    tex_dim: int = 100
    img_h: int = 500
    img_w: int = 500
    batch_size: int = 50
    # iteration budgets (the reference's values; lower for tests)
    iters_focal_pose: int = 2000
    iters_focal_idexp: int = 2500
    iters_pose: int = 1500
    iters_idexp: int = 2000
    iters_photo: int = 71
    iters_window: int = 50
    # frames shaded at once inside the photometric losses (phases c/d),
    # each chunk under activation checkpointing: peak memory O(photo_chunk)
    # frames, the loss a mean of per-frame terms either way
    photo_chunk: int = 4
    # the JAX package's bound on Adam iterations per device dispatch; an
    # eager loop has no dispatch to bound, so these have no effect here
    photo_segment: int = 8
    lms_segment: int = 500
    raster_kwargs: Dict[str, Any] = field(default_factory=dict)


class FaceTracker:
    def __init__(self, assets: bfm.BFMAssets, lms: np.ndarray,
                 cfg: TrackerConfig, mesh=None, device=None):
        """lms: [N, 68, 2] detected 2-D landmarks.  The work runs on
        ``device`` (the assets' device unless named).

        ``mesh``: a ``parallel.mesh`` mesh whose data axis splits the
        photometric phases' frames over its data indices, as the JAX
        tracker's ``shard_map`` over ``data`` shards them (phases c and d;
        the pixel ranks of a data index take the same frames, and the
        landmark phases are cheap and run whole on every rank); None, or
        a data axis of one, runs on one device."""
        dev = torch.device(device) if device is not None else \
            assets.tris.device
        self.mesh = mesh if mesh_mod.data_size(mesh) > 1 else None
        self.assets = bfm.assets_to(assets, dev)
        self.device = dev
        self.lms = torch.tensor(np.asarray(lms, np.float32), device=dev)
        # the parameter dims are the assets' bases', whatever the config
        self.cfg = dataclasses.replace(
            cfg, id_dim=assets.base_id.shape[0],
            exp_dim=assets.base_exp.shape[0],
            tex_dim=assets.base_tex.shape[0])
        self.cxy = (self.cfg.img_w / 2.0, self.cfg.img_h / 2.0)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _start(self, n: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        trans = self._zeros(n, 3)
        trans[:, 2] = -7.0
        return {"id": self._zeros(1, c.id_dim),
                "exp": self._zeros(n, c.exp_dim),
                "euler": self._zeros(n, 3), "trans": trans}

    # -- losses -------------------------------------------------------------
    def landmark_loss(self, p, lms, focal: float):
        """Landmark loss of parameters {id [1, id], exp, euler, trans}."""
        n = p["exp"].shape[0]
        idb = p["id"].expand(n, -1)
        geo = bfm.get_3dlandmarks(self.assets, idb, p["exp"], p["euler"],
                                  p["trans"], focal, self.cxy)
        proj = bfm.forward_transform(geo, p["euler"], p["trans"], focal,
                                     self.cxy)
        return cal_lan_loss(proj[:, :, :2], lms)

    def _frame_terms(self, pix, colors, imgs, pix_to_face):
        """Per-frame photometric terms of a chunk of frames at the fixed
        pixel-to-face map: shade, clip, masked colour distance."""
        tris = self.assets.tris
        bary = recompute_barycentrics(pix_to_face, pix, tris)
        face = torch.clamp(pix_to_face, min=0)
        vals = torch.sum(bary[..., None] * gather_rows(colors, tris[face]),
                         dim=-2)
        hit = (pix_to_face >= 0)[..., None]
        img = torch.where(hit, torch.clamp(vals, 0, 255),
                          torch.zeros_like(vals))
        m = hit[..., 0].float()
        dist = (torch.sqrt(torch.sum((img - imgs) ** 2, dim=-1) + 1e-12)
                * m / 255.0)
        return dist.sum((1, 2)) / torch.clamp_min(m.sum((1, 2)), 1e-6)

    def _chunked_terms(self, pix, colors, imgs):
        c = self.cfg
        frag = rasterize(pix.detach(), self.assets.tris, c.img_h, c.img_w,
                         **c.raster_kwargs)
        step = min(c.photo_chunk, pix.shape[0])
        return torch.cat([checkpoint(self._frame_terms, pix[s:s + step],
                                     colors[s:s + step], imgs[s:s + step],
                                     frag.pix_to_face[s:s + step],
                                     use_reentrant=False)
                          for s in range(0, pix.shape[0], step)])

    def col_loss(self, pix, colors, imgs):
        """Photometric term == ``cal_col_loss(render, imgs, hit)``: the
        visibility of the detached pixels, then the shading and distance
        ``photo_chunk`` frames at a time under checkpointing (the backward
        re-shades a chunk instead of keeping its intermediates).

        Under a mesh each rank rasterizes and shades its block of the
        frames, padded as the JAX tracker pads them to a multiple of the
        axis (repeats of weight 0), and the weighted sum is summed over
        the ranks (JAX's ``psum``): every rank returns the whole term, and
        the gradients, averaged over the ranks (``adam_loop``), are the
        term's."""
        if self.mesh is None:
            return self._chunked_terms(pix, colors, imgs).mean()
        b = pix.shape[0]
        idx, weight = self.frame_block(b, pix.device)
        terms = self._chunked_terms(pix[idx], colors[idx], imgs[idx])
        return mesh_mod.all_sum((terms * weight).sum(), self.mesh,
                                mesh_mod.DATA) / b

    def frame_block(self, b: int, device=None):
        """(indices, weights) of this rank's frames of ``b`` under the
        mesh: its data index's block of the frames padded to a multiple of
        the data axis, the padding repeats of weight 0; the pixel ranks of
        a data index take the same block."""
        w, d = self.mesh.data, self.mesh.data_index
        per = -(-b // w)
        idx = torch.arange(d * per, (d + 1) * per, device=device)
        weight = (idx < b).float()
        return torch.where(idx < b, idx, (idx - b) % b), weight

    def _pix_colors(self, id_para, texv, exp, euler, trans, light,
                    focal: float):
        b = exp.shape[0]
        geo = bfm.forward_geo(self.assets, id_para.expand(b, -1), exp)
        rott = bfm.rot_trans_pts(geo, bfm.euler2rot(euler), trans)
        normals = bfm.vertex_normals(rott, self.assets.tris,
                                     self.assets.vert_tris)
        colors = bfm.sh_illumination(texv.expand(b, -1, -1), normals, light)
        pix = bfm.camera_pixels(rott, focal, self.cfg.img_h, self.cfg.img_w)
        return pix, colors

    def photo_loss(self, q, imgs, lms, weights, focal: float):
        """Phase c's loss of {id, exp_sel, euler_sel, trans_sel, tex,
        light} on the key frames ``imgs`` / ``lms``; weights (w_lan, w_id,
        w_exp)."""
        w_lan, w_id, w_exp = weights
        b = q["exp_sel"].shape[0]
        geo = bfm.get_3dlandmarks(self.assets, q["id"].expand(b, -1),
                                  q["exp_sel"], q["euler_sel"],
                                  q["trans_sel"], focal, self.cxy)
        proj = bfm.forward_transform(geo, q["euler_sel"], q["trans_sel"],
                                     focal, self.cxy)
        loss_lan = cal_lan_loss(proj[:, :, :2], lms)
        pix, colors = self._pix_colors(
            q["id"], bfm.forward_tex(self.assets, q["tex"]), q["exp_sel"],
            q["euler_sel"], q["trans_sel"], q["light"], focal)
        loss_col = self.col_loss(pix, colors, imgs)
        return (loss_col + loss_lan * w_lan
                + w_id * torch.mean(q["id"] ** 2)
                + w_exp * torch.mean(q["exp_sel"] ** 2))

    def window_loss(self, q, imgs, lms, id_para, texv, pre, w_lan: float,
                    focal: float):
        """Phase d's loss of {exp, euler, trans, light} on one window;
        ``pre`` = (exp, euler, trans) of the frames before it (length 0 for
        the first window)."""
        b = q["exp"].shape[0]
        idb = id_para.expand(b, -1)
        geo_l = bfm.get_3dlandmarks(self.assets, idb, q["exp"], q["euler"],
                                    q["trans"], focal, self.cxy)
        proj = bfm.forward_transform(geo_l, q["euler"], q["trans"], focal,
                                     self.cxy)
        loss_lan = cal_lan_loss(proj[:, :, :2], lms)
        loss_regexp = torch.mean(q["exp"] ** 2)
        pix, colors = self._pix_colors(id_para, texv, q["exp"], q["euler"],
                                       q["trans"], q["light"], focal)
        loss_col = self.col_loss(pix, colors, imgs)
        all_exp = torch.cat([pre[0], q["exp"]])
        all_euler = torch.cat([pre[1], q["euler"]])
        all_trans = torch.cat([pre[2], q["trans"]])
        nb = all_exp.shape[0]
        # the temporal Laplacian's vertices: the landmark vertices, the JAX
        # package's proxy for the reference's rigid ids
        geo_r = bfm.forward_geo_sub(self.assets, id_para.expand(nb, -1),
                                    all_exp, self.assets.keyinds)
        rott_r = bfm.rot_trans_pts(geo_r, bfm.euler2rot(all_euler),
                                   all_trans)
        loss_lap = cal_lap_loss(rott_r.reshape(nb, -1).T)   # [3V', T]
        return (0.5 * loss_col + w_lan * loss_lan + 1e5 * loss_lap
                + loss_regexp)

    # -- phases --------------------------------------------------------------
    def find_focal(self, step: int = 100, lo: int = 600, hi: int = 1500,
                   frame_stride: int = 40) -> float:
        """Grid search of the focal length: the candidate whose two-stage
        landmark fit ends at the least landmark loss."""
        c = self.cfg
        sel = torch.arange(0, self.lms.shape[0], frame_stride,
                           device=self.device)
        lms = self.lms[sel]
        n = len(sel)
        best_focal, best_loss = hi, np.inf
        for focal in range(lo, hi, step):
            f = float(focal)
            p = self._start(n)
            pose_opt = schedule(0.1)
            pose = adam_loop(
                lambda q: self.landmark_loss(dict(p, **q), lms, f),
                {"euler": p["euler"], "trans": p["trans"]},
                {"euler": pose_opt, "trans": pose_opt}, c.iters_focal_pose)
            p.update(pose)
            all_opt = schedule(0.1, {1500: 0.2})
            p = adam_loop(
                lambda q: (self.landmark_loss(q, lms, f)
                           + 0.5 * torch.mean(q["id"] ** 2)
                           + 0.4 * torch.mean(q["exp"] ** 2)),
                p, {k: all_opt for k in p}, c.iters_focal_idexp)
            with torch.no_grad():
                final = float(self.landmark_loss(p, lms, f))
            if final < best_loss:
                best_loss, best_focal = final, focal
        # rank 0's pick on every rank (the ranks fit alike, but need not
        # round alike on other cards)
        best = torch.tensor(float(best_focal), device=self.device)
        return float(mesh_mod.replicate(best, self.mesh))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, focal: float, images: Optional[np.ndarray] = None,
            progress: bool = False,
            timings: Optional[Dict[str, float]] = None
            ) -> Dict[str, np.ndarray]:
        """Phases a-d.  ``images``: [N, H, W, 3] uint8 / float RGB frames
        for the photometric phases (None: the landmark phases only).
        ``timings``: filled with each phase's wall seconds, the device
        synchronised at each phase's end."""

        def mark(name, t0):
            if timings is not None:
                self._sync()
                timings[name] = time.perf_counter() - t0
                print(f"# {name}: {timings[name]:.1f}s", file=sys.stderr,
                      flush=True)
            return time.perf_counter()

        t0 = time.perf_counter()
        c = self.cfg
        n = self.lms.shape[0]
        focal = float(focal)
        p = self._start(n)
        tex = self._zeros(1, c.tex_dim)
        light = self._zeros(n, 27)

        # phase a: pose only, lr 1 -> 0.1 at step 1000
        opt_a = schedule(1.0, {1000: 0.1})
        pose = adam_loop(
            lambda q: self.landmark_loss(dict(p, **q), self.lms, focal),
            {"euler": p["euler"], "trans": p["trans"]},
            {"euler": opt_a, "trans": opt_a}, c.iters_pose)
        p.update(pose)
        t0 = mark("phase_a_pose", t0)

        # phase b: + id / exp and their regularizers, lr 0.1 x 0.2 at 1000
        opt_b = schedule(0.1, {1000: 0.2})
        p = adam_loop(
            lambda q: (self.landmark_loss(q, self.lms, focal)
                       + 0.5 * torch.mean(q["id"] ** 2)
                       + 0.4 * torch.mean(q["exp"] ** 2)),
            p, {k: opt_b for k in p}, c.iters_idexp)
        # the landmark phases ran whole on every rank: rank 0's result
        # starts the photometric phases everywhere
        p = mesh_mod.replicate(p, self.mesh)
        t0 = mark("phase_b_idexp", t0)

        if images is None:
            return self._pack(p, tex, light, focal)

        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=self.device)

        # phase c: photometric fit on the key frames
        bs = min(c.batch_size, n)
        sel = torch.as_tensor(np.arange(0, n, max(1, n // bs))[:bs],
                              device=self.device)
        sel_imgs, sel_lms = images[sel], self.lms[sel]
        photo = {"id": p["id"], "exp_sel": p["exp"][sel],
                 "euler_sel": p["euler"][sel], "trans_sel": p["trans"][sel],
                 "tex": tex, "light": self._zeros(bs, 27)}
        # two weight regimes (steps <= / > 50), lr x 0.2 at 5 and 55
        lr_tl = schedule(0.1, {5: 0.2, 55: 0.2})
        lr_if = schedule(0.01, {5: 0.2, 55: 0.2})
        opts = {"tex": lr_tl, "light": lr_tl, "id": lr_if, "exp_sel": lr_if,
                "euler_sel": lr_if, "trans_sel": lr_if}
        photo = adam_loop(
            lambda q: self.photo_loss(q, sel_imgs, sel_lms, (3.0, 2.0, 1.0),
                                      focal),
            photo, opts, min(51, c.iters_photo), self.mesh)
        if c.iters_photo > 51:
            photo = adam_loop(
                lambda q: self.photo_loss(q, sel_imgs, sel_lms,
                                          (0.05, 1.0, 0.8), focal),
                photo, opts, c.iters_photo - 51, self.mesh)
        t0 = mark("phase_c_photometric", t0)
        p["id"] = photo["id"]
        tex = photo["tex"]
        for k in ("exp", "euler", "trans"):
            p[k] = p[k].clone()
            p[k][sel] = photo[k + "_sel"]
        light = photo["light"].mean(0).expand(n, 27).clone()

        # phase d: sliding windows with the temporal Laplacian
        p, light = self._phase_d(p, tex, light, images, focal)
        mark("phase_d_window", t0)
        return self._pack(p, tex, light, focal)

    def _phase_d(self, p, tex, light, images, focal: float):
        c = self.cfg
        n = self.lms.shape[0]
        bs = min(c.batch_size, n)
        pre = 5
        exp, euler, trans = p["exp"], p["euler"], p["trans"]
        id_para = p["id"]
        texv = bfm.forward_tex(self.assets, tex)
        opt = schedule(0.005)
        keys = ("exp", "euler", "trans", "light")
        for i in range(int((n - 1) / bs + 1)):
            start = n - bs if (i + 1) * bs > n else i * bs
            sel = torch.arange(start, start + bs, device=self.device)
            pre_ids = torch.arange(max(0, start - pre),
                                   start if i > 0 else 0, device=self.device)
            sel_imgs, sel_lms = images[sel], self.lms[sel]
            before = (exp[pre_ids], euler[pre_ids], trans[pre_ids])
            q = {"exp": exp[sel], "euler": euler[sel], "trans": trans[sel],
                 "light": light[sel]}
            q = adam_loop(
                lambda q_: self.window_loss(q_, sel_imgs, sel_lms, id_para,
                                            texv, before, 8.0, focal),
                q, {k: opt for k in keys}, min(31, c.iters_window),
                self.mesh)
            if c.iters_window > 31:
                q = adam_loop(
                    lambda q_: self.window_loss(q_, sel_imgs, sel_lms,
                                                id_para, texv, before, 1.5,
                                                focal),
                    q, {k: opt for k in keys}, c.iters_window - 31,
                    self.mesh)
            exp, euler, trans, light = (t.clone() for t in
                                        (exp, euler, trans, light))
            exp[sel], euler[sel] = q["exp"], q["euler"]
            trans[sel], light[sel] = q["trans"], q["light"]
        return dict(p, exp=exp, euler=euler, trans=trans), light

    @staticmethod
    def _pack(p, tex, light, focal) -> Dict[str, np.ndarray]:
        """The track_params.pt schema (+ texture and lighting)."""
        host = lambda t: t.detach().cpu().numpy()
        return {"id": host(p["id"]), "exp": host(p["exp"]),
                "euler": host(p["euler"]), "trans": host(p["trans"]),
                "focal": np.float32(focal), "tex": host(tex),
                "light": host(light)}
