"""Rank processes for the port's multi-process CPU tests.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes with
``torch.multiprocessing``, joins them into a gloo group that meets through
a file under ``tmp_path`` (so parallel test workers never share a port),
runs ``fn(*args)`` on each and returns the ranks' results in rank order.
The rank functions live here, a module that imports torch and the port
only, so the spawned processes never import JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, init_file, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.barrier()
        dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args):
    out_dir = str(tmp_path)
    init_file = os.path.join(out_dir, f"rendezvous-{fn.__name__}")
    if os.path.exists(init_file):
        os.remove(init_file)
    mp.spawn(_entry, args=(world, init_file, out_dir, fn, args),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# -- the train step ------------------------------------------------------------

def train_step(statics, params, unet, state, frozen, batch, draws, lr,
               mesh_on=True, mesh_shape=None):
    """One ``make_train_step`` step on this rank's rows of the global
    ``batch`` and ``draws`` (numpy), on a ``mesh_shape`` mesh (default
    ``(world, 1)``); returns the new state and the metrics as numpy."""
    from speech2lip_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from speech2lip_tpu_torch.train import train_step as ts

    mesh = make_mesh(mesh_shape) if mesh_on else None
    st = ts.StepStatics(**statics)
    opt = ts.Adam(lr)
    p, up, us = _to_torch(params), _to_torch(unet), _to_torch(state)
    step = ts.make_train_step(opt, st, _to_torch(frozen), mesh)
    new, metrics = step(ts.init_train_state(p, up, us, opt),
                        shard_batch(_to_torch(batch), mesh),
                        ts.shard_draws(_to_torch(draws), mesh))
    return {"params": _numpy(new.params), "unet": _numpy(new.unet_params),
            "state": _numpy(new.unet_state),
            "metrics": {k: float(v) for k, v in metrics.items()}}


# -- the U-Net on a band of rows a rank ------------------------------------------

def unet_bands(mesh_shape, params, state, x, cot):
    """The train-mode U-Net on this rank's band of ``x``'s rows, gathered
    into whole frames, and the gradients of sum(face * cot) with respect
    to ``x`` and every parameter, averaged over the mesh (numpy)."""
    from speech2lip_tpu_torch.models import unet_light
    from speech2lip_tpu_torch.parallel import mesh as mesh_mod
    from speech2lip_tpu_torch.train import train_step as ts

    mesh = mesh_mod.make_mesh(mesh_shape)
    p = ts.tree_map(lambda t: t.requires_grad_(True), _to_torch(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    band = mesh_mod.frame_band(mesh, x.shape[1])
    out, new = unet_light.apply(p, _to_torch(state),
                                xt[:, band.start:band.stop], train=True,
                                band=band)
    face = mesh_mod.gather_bands(out, band)
    leaves = [xt] + ts.tree_leaves(p)
    grads = torch.autograd.grad((face * torch.from_numpy(cot)).sum(), leaves)
    grads = mesh_mod.mean_tensors(grads, mesh, mesh_mod.ALL)
    return {"rows": band.rows, "face": _numpy(face), "state": _numpy(new),
            "grad_x": _numpy(grads[0]), "grads": _numpy(grads[1:])}


# -- fit -------------------------------------------------------------------------

def fit(cfg, max_iters):
    from speech2lip_tpu_torch.train import trainer
    state = trainer.fit(cfg, max_iters=max_iters, device="cpu")
    return {"it": state.it, "params": _numpy(state.params),
            "unet_state": _numpy(state.unet_state)}


# -- sharded checkpoints -------------------------------------------------------

def save_sharded(path, tree, scalars):
    from speech2lip_tpu_torch.core.checkpoint_sharded import save_sharded
    save_sharded(path, _to_torch(tree), scalars)
    return sorted(os.listdir(path))


def restore_sharded(path, like):
    from speech2lip_tpu_torch.core.checkpoint_sharded import restore_sharded
    tree, scalars = restore_sharded(path, _to_torch(like))
    return _numpy(tree), scalars


# -- serving ---------------------------------------------------------------------

def serve(cfg, param_sets, positions, batches):
    """``MultiSpeakerServer(mesh=...)`` over the ranks, float32 plain
    path on the CPU; returns every identity's faces (numpy) and the
    identities this rank rendered."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.infer.pipeline import MultiSpeakerServer
    from speech2lip_tpu_torch.parallel.mesh import make_mesh

    sets = [weights.from_jax(*s) for s in param_sets]
    srv = MultiSpeakerServer(cfg, sets, positions, device="cpu",
                             mesh=make_mesh())
    outs = srv.render_all([_to_torch(b) for b in batches])
    return {"faces": [o["face"].numpy() for o in outs],
            "served": list(srv.served)}


# -- the tracker's photometric term ----------------------------------------------

def tracker_cfg_kw(cfg_kw, dims):
    return dict(cfg_kw, id_dim=dims["id_dim"], exp_dim=dims["exp_dim"],
                tex_dim=dims["tex_dim"])


def tracker_cfg(cfg_kw, dims):
    from speech2lip_tpu_torch.preprocess.tracker import TrackerConfig
    return TrackerConfig(**tracker_cfg_kw(cfg_kw, dims))


def tracker_col_loss(dims, lms, cfg_kw, pix, colors, imgs):
    """The photometric term and its gradients with respect to the pixels
    and colours, the frames split over the ranks."""
    from speech2lip_tpu_torch.parallel.mesh import make_mesh, mean_tensors
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess.tracker import FaceTracker

    mesh = make_mesh()
    tr = FaceTracker(bfm.synthetic_assets(**dims), lms,
                     tracker_cfg(cfg_kw, dims), mesh=mesh, device="cpu")
    pix, colors = (torch.from_numpy(x).requires_grad_(True)
                   for x in (pix, colors))
    loss = tr.col_loss(pix, colors, torch.from_numpy(imgs))
    grads = mean_tensors(torch.autograd.grad(loss, [pix, colors]), mesh)
    return float(loss), [g.numpy() for g in grads]
