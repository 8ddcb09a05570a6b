"""Train the tiny 68-point landmark regressor (models/tiny_landmarks.py) on
synthetic 3DMM renders (counterpart of ``tools/train_tiny_landmarks.py``).

Renders (face, 68-point projection) pairs at 96^2 with the port's
``render_mesh`` on the device (random identity / expression / pose /
texture / lighting, then a gain / bias / noise augmentation), trains the
regressor with Adam on a cosine-decayed rate, keeps the best validation
weights and writes them to ``--out`` in the JAX package's checkpoint
layout (``conv0/w`` ... ``fc2/b``), which ``tiny_landmarks.load`` reads.

    python -m speech2lip_tpu_torch.tools.train_tiny_landmarks --out DIR/t.ckpt
        [--steps 4000 --batch 64 --n-train 4096 --n-val 512]
        [--device cuda|cpu]

The repository's committed ``models/tiny_landmarks.ckpt`` is never
written: ``--out`` must name another file.  The parameter draws are the
JAX tool's (numpy, same seed and order), so the clean renders and the
landmarks are its; the augmentation and the initial weights draw from
torch's and numpy's generators, not from JAX's PRNG.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from speech2lip_tpu_torch.models import tiny_landmarks as tl
from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
from speech2lip_tpu_torch.train.train_step import Adam

SIZE = tl.SIZE
FOCAL = 120.0
RK = dict(tile=16, max_faces_per_tile=256)
DIMS = dict(n_verts=600, id_dim=12, exp_dim=8, tex_dim=10, seed=7)


def draw_params(rng: np.random.Generator, b: int) -> dict:
    """One chunk's random identity / expression / pose / texture / light,
    in the JAX tool's order."""
    idp = 0.6 * rng.standard_normal((b, 12)).astype(np.float32)
    exp = 0.25 * rng.standard_normal((b, 8)).astype(np.float32)
    euler = 0.25 * rng.standard_normal((b, 3)).astype(np.float32)
    trans = np.tile(np.array([[0, 0, -7.0]], np.float32), (b, 1))
    trans[:, :2] += 0.4 * rng.standard_normal((b, 2))
    trans[:, 2] += 0.8 * rng.standard_normal((b,))
    tex = 0.5 * rng.standard_normal((b, 10)).astype(np.float32)
    light = 0.3 * rng.standard_normal((b, 27)).astype(np.float32)
    return {"id": idp, "exp": exp, "euler": euler, "trans": trans,
            "tex": tex, "light": light}


def render(assets, p: dict):
    """Clean renders [b, 96, 96, 3] in [0, 1] and landmarks [b, 68, 2]."""
    dev = assets.tris.device
    t = {k: torch.as_tensor(v, device=dev) for k, v in p.items()}
    cxy = (SIZE / 2.0, SIZE / 2.0)
    with torch.no_grad():
        geo = bfm.forward_geo(assets, t["id"], t["exp"])
        rott = bfm.rot_trans_pts(geo, bfm.euler2rot(t["euler"]), t["trans"])
        imgs, _ = bfm.render_mesh(assets, rott, bfm.forward_tex(assets,
                                                                t["tex"]),
                                  t["light"], FOCAL, SIZE, SIZE, **RK)
        geo_l = bfm.get_3dlandmarks(assets, t["id"], t["exp"], t["euler"],
                                    t["trans"], FOCAL, cxy)
        proj = bfm.forward_transform(geo_l, t["euler"], t["trans"], FOCAL,
                                     cxy)
    return imgs / 255.0, proj[:, :, :2]


def make_dataset(n: int, seed: int, chunk: int = 64, device="cpu",
                 augment: bool = True):
    """[n, 96, 96, 3] in [0, 1] and [n, 68, 2] pixel landmarks, on
    ``device``; ``augment``: gain U(0.7, 1.3), bias U(-0.08, 0.08) and
    N(0, 0.02) noise, clipped to [0, 1]."""
    assets = bfm.synthetic_assets(**DIMS, device=device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1000)
    imgs_all, lms_all = [], []
    for s in range(0, n, chunk):
        b = min(chunk, n - s)
        imgs, lms = render(assets, draw_params(rng, b))
        if augment:
            u = lambda lo, hi: lo + (hi - lo) * torch.rand(
                (b, 1, 1, 1), generator=gen, device=device)
            noise = 0.02 * torch.randn(imgs.shape, generator=gen,
                                       device=device)
            imgs = torch.clamp(imgs * u(0.7, 1.3) + u(-0.08, 0.08) + noise,
                               0.0, 1.0)
        imgs_all.append(imgs)
        lms_all.append(lms)
    imgs = torch.cat(imgs_all)
    if float(imgs.max()) < 0.1:
        raise RuntimeError("the rendered dataset is (near) black: the "
                           "rendering convention is broken")
    return imgs, torch.cat(lms_all)


def init_params(seed: int, device="cpu") -> dict:
    """He-normal convs, zero biases, FC layers at 1/sqrt(fan_in) and the
    last bias 0.5 (the centre of the frame), as the JAX ``init``."""
    rng = np.random.default_rng(seed)
    shapes = tl._shapes()
    params = {}
    for key, shape in shapes.items():
        layer, leaf = key.split("/")
        if leaf == "b":
            v = np.full(shape, 0.5 if layer == "fc2" else 0.0, np.float32)
        elif layer.startswith("conv"):
            v = (2.0 / (9 * shape[2])) ** 0.5 * rng.standard_normal(shape)
        else:
            v = (1.0 / shape[0]) ** 0.5 * rng.standard_normal(shape)
        params.setdefault(layer, {})[leaf] = torch.as_tensor(
            np.asarray(v, np.float32), device=device)
    return params


class CosineAdam(Adam):
    """Adam on a cosine decay from ``learning_rate`` to 0 over ``steps``."""

    def __init__(self, learning_rate: float, steps: int):
        super().__init__(learning_rate)
        self.steps = steps

    def lr(self, count: int) -> float:
        frac = min(count, self.steps) / self.steps
        return self.learning_rate * 0.5 * (1 + math.cos(math.pi * frac))


def _leaves(params):
    return [params[layer][leaf] for layer in sorted(params)
            for leaf in ("w", "b")]


def train(xtr, ytr, xva, yva, steps: int, batch: int, lr: float,
          seed: int, log=print):
    """Train from ``init_params(seed)``; returns (best params, history of
    (step, loss, val px err))."""
    dev = xtr.device
    params = init_params(seed, dev)
    opt = CosineAdam(lr, steps)
    leaves = _leaves(params)
    state = opt.init(leaves)
    gen = torch.Generator(device=dev).manual_seed(seed + 2000)

    def px_err(x, y):
        with torch.no_grad():
            return float(torch.linalg.norm(tl.apply(params, x) - y,
                                           dim=-1).mean())

    best, history = (float("inf"), params), []
    for it in range(1, steps + 1):
        sel = torch.randint(0, xtr.shape[0], (batch,), generator=gen,
                            device=dev)
        for t in leaves:
            t.requires_grad_(True)
        loss = torch.mean((tl.apply(params, xtr[sel]) - ytr[sel]) ** 2) / (
            SIZE ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            upd, state = opt.update(list(grads), state)
            for t, u in zip(leaves, upd):
                t.requires_grad_(False)
                t.add_(u)
        if it % max(1, steps // 20) == 0 or it == steps:
            ev = px_err(xva[:256], yva[:256])
            history.append((it, float(loss), ev))
            if ev < best[0]:
                best = (ev, {k: {n: v.clone() for n, v in d.items()}
                             for k, d in params.items()})
            log(f"it {it}: loss {float(loss):.5f} val-px-err {ev:.2f}")
    return best[1], history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--n-val", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="checkpoint to write (not the committed one)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from speech2lip_tpu_torch.core import checkpoint as ckpt_io
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.ops.nn import full_float32

    if os.path.realpath(args.out) == os.path.realpath(tl.CKPT):
        raise SystemExit(f"--out {args.out} is the repository's committed "
                         "checkpoint; name another file")
    dev = resolve_device(args.device)
    with full_float32():
        t0 = time.time()
        xtr, ytr = make_dataset(args.n_train, args.seed, device=dev)
        xva, yva = make_dataset(args.n_val, args.seed + 1, device=dev)
        gen_s = time.time() - t0
        t0 = time.time()
        params, history = train(xtr, ytr, xva, yva, args.steps, args.batch,
                                args.lr, args.seed)
        train_s = time.time() - t0
        err = lambda x, y: float(torch.linalg.norm(
            tl.apply(params, x) - y, dim=-1).mean())
        with torch.no_grad():
            err_tr, err_va = err(xtr[:256], ytr[:256]), err(xva, yva)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ckpt_io.save(args.out, params)
    report = {"steps": args.steps, "n_train": args.n_train,
              "train_px_err": err_tr, "val_px_err": err_va,
              "gen_seconds": gen_s, "train_seconds": train_s,
              "first_loss": history[0][1] if history else None,
              "last_loss": history[-1][1] if history else None,
              "out": args.out}
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
