"""The training loop (counterpart of ``speech2lip_tpu/train/trainer.py``):
the outer loop around the train step, with its static helpers.

``fit`` keeps the JAX loop's behaviours: resume by default, rolling,
step-tagged and best checkpoints, periodic validation and visualisation,
non-finite loss and weight checks, the staging boundary (sync loss on and
U-Net frozen) as a rebuild of the step, per-ray-chunk stepping when
``batch_rays`` < H*W, ``max_iters`` and a time-limited exit with code 3.
It trains on the card unless the caller names another device; the step's
random draws come from a ``torch.Generator`` seeded from
``training.seed``, and each batch goes to the device once per iteration.
Started as N ranks (``python -m torch.distributed.run --nproc_per_node
N``), it trains on the ``parallel.mesh`` ``(data, pixel)`` mesh as the
JAX loop trains on its mesh: each data index reads its slice of every
epoch, its pixel ranks split the U-Net's rows, and the step is the JAX
mesh step's on the global batch.
The depth-loss helpers compute the canonical-depth loss's support with
numpy from the identity's canonical masks.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from speech2lip_tpu_torch import weights
from speech2lip_tpu_torch.core.checkpoint import (CheckpointManager,
                                                  check_weights)
from speech2lip_tpu_torch.core import checkpoint as ckpt
from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.core.device import resolve_device
from speech2lip_tpu_torch.core.metrics import MetricsWriter, setup_logger
from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
from speech2lip_tpu_torch.data.windows import cached_warp_window
from speech2lip_tpu_torch.infer.renderer import render_lip_batch
from speech2lip_tpu_torch.models import talking_face as tf
from speech2lip_tpu_torch.ops.flowviz import extract_flow, flow_to_image
from speech2lip_tpu_torch.parallel import distributed
from speech2lip_tpu_torch.parallel import mesh as mesh_mod
from speech2lip_tpu_torch.train import train_step as ts

# batch entries only the sync stage reads
_SYNC_KEYS = ("mel", "audio_window", "coord_window", "rgb_window_neg")


def resolve_pallas_gather(tr: Dict[str, Any], device) -> bool:
    """``pallas_gather``: true | false | 'auto' (default).  'auto' turns the
    K7 gathers on for bfloat16 training on a CUDA device at a per-host
    batch of 4 or more (the JAX package's gate reads "not the CPU" where
    this one reads "CUDA")."""
    pg = tr.get("pallas_gather", "auto")
    if isinstance(pg, str):
        if pg != "auto":
            raise ValueError(f"pallas_gather must be a bool or 'auto', "
                             f"got {pg!r}")
        return (torch.device(device).type == "cuda"
                and str(tr.get("compute_dtype", "float32")) == "bfloat16"
                and int(tr.get("batch_size", 1)) >= 4)
    return bool(pg)


def _support(mask_head, mask_face):
    """The loss mask head * (1 - face), [H, W, C], and its support."""
    m = np.asarray(mask_head, np.float32) * (
        1.0 - np.asarray(mask_face, np.float32))
    ys, xs = np.nonzero(m.max(axis=-1) > 0)
    return m, ys, xs


def depth_loss_box(mask_head, mask_face, max_pixels: int = 16384
                   ) -> Optional[Tuple[int, int, int, int]]:
    """Static bbox (x0, x1, y0, y1) of the loss mask's support, from the
    canonical head [H, W, 1|3] and face [H, W, 3] masks; None when the
    mask is empty or the box holds more than ``max_pixels`` pixels (then
    the points or full-frame path serves)."""
    _, ys, xs = _support(mask_head, mask_face)
    if ys.size == 0:
        return None
    box = (int(xs.min()), int(xs.max()) + 1, int(ys.min()), int(ys.max()) + 1)
    if (box[1] - box[0]) * (box[3] - box[2]) > max_pixels:
        return None
    return box


def depth_loss_points(mask_head, mask_face, rgb_face_zero, device="cpu"
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """``frozen['depth_pts']`` of the canonical-depth points path: the S
    support pixels of the loss mask (xs, ys [S] int64), its values there
    (w [S, 3]) and the canonical face there (rgb_zero_pts [S, 3]), float32
    tensors on ``device``; None when the mask is empty."""
    tgt = np.asarray(rgb_face_zero, np.float32)
    m, ys, xs = _support(mask_head, mask_face)
    if ys.size == 0:
        return None
    m = np.broadcast_to(m, tgt.shape)
    put = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                        device=device)
    return {"xs": put(xs, torch.int64), "ys": put(ys, torch.int64),
            "w": put(m[ys, xs], torch.float32),
            "rgb_zero_pts": put(tgt[ys, xs], torch.float32)}


# -- statics -----------------------------------------------------------------

def _stage_flags(tr: Dict[str, Any], it: int) -> Tuple[bool, bool]:
    """(sync loss on, U-Net frozen) at iteration ``it``."""
    return (bool(tr["use_syncloss"] and it > tr["sync_start_iter"]),
            bool(tr["fix_post_net"] or it > tr["postnet_freeze_iter"]))


def _has_masks(ds) -> bool:
    return (hasattr(ds, "mask_head_canonical")
            and hasattr(ds, "mask_face_canonical"))


def warp_window(cfg: Dict[str, Any], ds: LipDataset):
    """The composite's static warp window: the config's value, or the
    dataset's, computed once from its coord grids (cached on disk)."""
    d = cfg["data"]
    win = d.get("warp_window")
    if (win is None and d.get("compute_warp_window", True)
            and os.path.isdir(ds.coords_dir) and len(ds) > 0):
        box = tf.expanded_lip_box(ds.lip_h, ds.lip_w, ds.lefttop_x,
                                  ds.lefttop_y,
                                  d.get("expand_mask_divisor", 5))
        win = cached_warp_window(ds.root, box, ds.face_h, ds.face_w,
                                 ds.iter_coords, margin=8)
    return tuple(win) if win is not None else None


def build_statics(cfg: Dict[str, Any], ds: LipDataset, it: int,
                  device="cpu") -> ts.StepStatics:
    """The step's statics at iteration ``it`` for training on ``device``.
    As in the JAX trainer, ``compute_dtype`` and ``pallas_gather`` are read
    from the ``training`` section."""
    tr = cfg["training"]
    d = cfg["data"]
    sync_on, frozen = _stage_flags(tr, it)
    bbox = (0, 0, ds.face_w, ds.face_h)
    if getattr(ds, "face_bbox_dict", None):
        key = "{:05d}.jpg".format(ds.canonical_idx + 1)
        if key in ds.face_bbox_dict:
            x, y, x2, y2 = [int(v) for v in ds.face_bbox_dict[key][:4]]
            bbox = (x, y, x2, y2)
    box = None
    if tr.get("depth_loss_crop", True) and _has_masks(ds):
        box = depth_loss_box(ds.mask_head_canonical, ds.mask_face_canonical)
    return ts.StepStatics(
        lip_h=int(d["height"]), lip_w=int(d["width"]),
        lip_x=ds.lefttop_x, lip_y=ds.lefttop_y,
        face_h=ds.face_h, face_w=ds.face_w,
        focal=float(d["face_img_focal"]),
        expand_divisor=int(d.get("expand_mask_divisor", 5)),
        w_photometric=float(cfg["model"].get("lambda_rgb", 1.0)),
        w_perceptual=float(tr["w_perceptual_loss"]),
        w_post_fusion=float(tr["w_post_fusion"]),
        w_sync=float(tr["w_syncloss"]),
        use_perceptual=bool(tr["use_perceptual_loss"]),
        use_canonical_depth_loss=bool(tr["use_canonical_depth_loss_photo_v2"]),
        use_blackaug=bool(cfg["model"]["use_post_fusion_blackaug"]),
        sync_on=sync_on, postnet_frozen=frozen,
        face_bbox=bbox,
        ensemble=bool(tr["use_local_ensemble"]),
        window=warp_window(cfg, ds),
        depth_loss_box=box,
        add_noise_uv=bool(tr.get("add_noise_uv", False)),
        add_noise_audio=bool(tr.get("add_noise_audio", False)),
        compute_dtype=str(tr.get("compute_dtype", "float32")),
        pallas_gather=resolve_pallas_gather(tr, device),
    )


# -- models ------------------------------------------------------------------

def _identity_bn(state_like, params_like):
    """The U-Net's BatchNorm at the JAX init's values: scale 1, bias 0,
    running mean 0, variance 1."""
    for name, blk in params_like.items():
        for bn in ("bn1", "bn2"):
            if bn in blk:
                blk[bn]["scale"].fill_(1.0)
                blk[bn]["bias"].zero_()
                state_like[name][bn]["mean"].zero_()
                state_like[name][bn]["var"].fill_(1.0)


def init_params(cfg: Dict[str, Any], ds: LipDataset, seed: int = 0,
                device="cpu"):
    """(params, unet params, unet state) made from ``seed``: the JAX
    package's trees (leaf names and shapes), the port's own draws.  The
    canonical depth starts from the dataset's hole-filled depth."""
    depth_init = None
    if cfg["model"]["use_canonical_depth"] and hasattr(ds, "depth_canonical"):
        depth_init = tf.prepare_canonical_depth_init(
            ds.depth_canonical, ds.mask_head_canonical[..., 0])
    params, unet_p, unet_s = weights.random_params(
        seed, device=device, cfg=cfg, canonical_depth_init=depth_init)
    _identity_bn(unet_s, unet_p)
    return params, unet_p, unet_s


def init_models(cfg: Dict[str, Any], ds: LipDataset, seed: int = 0,
                device="cpu"):
    """``init_params`` and the frozen nets of the losses (LPIPS, and
    SyncNet with the sync loss), made from ``seed``."""
    params, unet_p, unet_s = init_params(cfg, ds, seed, device)
    frozen = {"lpips": weights.random_lpips(seed + 1, device=device)}
    if cfg["training"]["use_syncloss"]:
        frozen["syncnet"] = weights.random_syncnet(seed + 2, device=device)
    return params, unet_p, unet_s, frozen


def load_frozen_weights(cfg: Dict[str, Any], frozen: Dict[str, Any]):
    """Converted pretrained LPIPS / SyncNet weights, where the files exist
    (``training.{lpips,syncnet}_weights``, by default
    ``models/<name>_weights.ckpt``)."""
    for name in ("lpips", "syncnet"):
        path = cfg["training"].get(f"{name}_weights",
                                   f"models/{name}_weights.ckpt")
        if path and os.path.exists(path) and name in frozen:
            frozen[name], _ = ckpt.load(path, frozen[name])
    return frozen


# -- data --------------------------------------------------------------------

def prefetch_backend(ds: LipDataset, use_native: bool = True
                     ) -> Optional[str]:
    """The prefetcher backend ``batch_iterator`` reads ``ds`` with
    (``data.native_loader.pick_backend``), or None for the Python reader:
    without ``use_native``, and for the sync stage's training split, whose
    extras (multi-frame windows) the Python reader builds, as in the JAX
    trainer."""
    if not use_native or (ds.use_syncloss and ds.mode == "train"):
        return None
    from speech2lip_tpu_torch.data.native_loader import pick_backend
    return pick_backend()


def _prefetcher(ds: LipDataset, backend: str):
    """A ``SamplePrefetcher`` over each frame's lip JPEG, face JPEG and
    coord grid."""
    from speech2lip_tpu_torch.data.native_loader import SamplePrefetcher
    files = []
    for pos in range(len(ds)):
        idx = ds._index_map[pos]
        files.append([os.path.join(ds.images_dir, ds.files[idx]),
                      os.path.join(ds.faces_dir, ds.files[idx]),
                      os.path.join(ds.coords_dir, ds.coord_files[idx])])
    specs = [("jpeg", (ds.lip_h, ds.lip_w)), ("jpeg", (ds.face_h, ds.face_w)),
             ("npy", (ds.face_h, ds.face_w, 2))]
    return SamplePrefetcher(files, specs, backend=backend)


def batch_iterator(ds: LipDataset, batch_size: int, shuffle: bool,
                   seed: int, n_proc: int = 1, proc_id: int = 0,
                   use_native: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of this rank's host batches (numpy): the order of
    ``np.random.default_rng(seed)``'s shuffle, as the JAX trainer's, and of
    it the frames ``proc_id::n_proc``.  Every rank yields as many batches,
    those of the smallest slice, so the ranks step together.

    The heavy per-frame files (lip and face JPEGs, the coord grid) stream
    through a ``SamplePrefetcher`` (``prefetch_backend``) while the cheap
    in-memory fields come from the Python reader; ``use_native=False``
    reads everything in Python."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(ds))
    if shuffle:
        rng.shuffle(order)
    order = order[proc_id::n_proc]
    n_batches = (len(ds) // n_proc) // batch_size
    if n_batches < 1:
        raise ValueError(
            f"per-host batch_size={batch_size} exceeds this host's dataset "
            f"slice ({len(order)} frames): reduce training.batch_size")
    order = order[:n_batches * batch_size]
    backend = prefetch_backend(ds, use_native)
    if backend is None:
        for i in range(0, len(order), batch_size):
            with spans.span("build"):
                samples = [ds.load_frame(int(j))
                           for j in order[i:i + batch_size]]
                with spans.span("build.stack"):
                    batch = stack_batch(samples)
            yield batch
        return
    prefetcher = _prefetcher(ds, backend)
    try:
        prefetcher.start_epoch([int(i) for i in order])
        for i in range(0, len(order), batch_size):
            with spans.span("build"):
                samples = []
                for j in order[i:i + batch_size]:
                    with spans.span("build.read"):
                        idx, (rgb, face_ori, coord) = prefetcher.pop()
                    assert idx == int(j), (idx, j)
                    s = ds.load_frame_light(idx)
                    s.update({"rgb": rgb, "rgb_face_ori": face_ori,
                              "coord": coord})
                    with spans.span("build.warp"):
                        s.update(ds.blackaug_statics(coord))
                    samples.append(s)
                with spans.span("build.stack"):
                    batch = stack_batch(samples)
            yield batch
    finally:
        prefetcher.close()


def to_device(host_batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    with spans.span("build.copy"):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in host_batch.items()}


# -- validation --------------------------------------------------------------

def _render_val_frame(params, cfg, s, device):
    d = cfg["data"]
    audio = torch.from_numpy(s["audio"])[None].to(device)
    t = torch.tensor([float(s["index"])], device=device)
    with torch.no_grad():
        return render_lip_batch(params, audio, t, int(d["height"]),
                                int(d["width"]), use_kernels=True)[0]


def evaluate_psnr(params, cfg, ds: LipDataset, max_frames: int = 64,
                  device="cpu") -> float:
    """Val PSNR of the lip render over the first ``max_frames`` frames,
    one frame a call (K1 on the card)."""
    mses = []
    for i in range(min(len(ds), max_frames)):
        s = ds.load_frame(i)
        rgb = _render_val_frame(params, cfg, s, device)
        mses.append(float(((rgb - torch.from_numpy(s["rgb"]).to(device))
                           ** 2).mean()))
    mse = float(np.mean(mses))
    return -10.0 * np.log(mse) / np.log(10.0)


def visualize(params, cfg, ds: LipDataset, metrics_w: MetricsWriter, it: int,
              device="cpu"):
    """Render val frame 0: its loss and PSNR as ``val_mini/`` scalars, the
    prediction, the ground truth and the coord grid's flow as images."""
    s = ds.load_frame(0)
    rgb = _render_val_frame(params, cfg, s, device).cpu().numpy()
    mse = float(np.mean((rgb - s["rgb"]) ** 2))
    metrics_w.scalars(it, {"loss": mse,
                           "psnr": -10.0 * np.log(mse) / np.log(10.0)},
                      prefix="val_mini/")
    metrics_w.image(it, "rgb_prediction", rgb)
    metrics_w.image(it, "rgb_gt", s["rgb"])
    if "coord" in s:
        flow = extract_flow(np.asarray(s["coord"])[None])[0]
        metrics_w.image(it, "flow", flow_to_image(flow) / 255.0)


# -- the loop ----------------------------------------------------------------

def _n_chunks(cfg: Dict[str, Any], ds: LipDataset) -> int:
    """Chunks of the per-ray-chunk regime, 1 for whole-frame steps.  That
    regime carries only the lip photometric loss: the other loss flags are
    refused (the original code crashes on them)."""
    tr = cfg["training"]
    n_rays = ds.lip_h * ds.lip_w
    batch_rays = int(tr.get("batch_rays", n_rays))
    if not 0 < batch_rays < n_rays:
        return 1
    if n_rays % batch_rays != 0:
        raise ValueError(f"batch_rays={batch_rays} must divide "
                         f"H*W={n_rays}")
    bad = ([f for f in ("use_post_fusion",) if cfg["model"].get(f)]
           + [f for f in ("use_perceptual_loss", "use_syncloss",
                          "use_canonical_depth_loss_photo_v2") if tr.get(f)])
    if bad:
        raise ValueError(
            f"batch_rays={batch_rays} < H*W={n_rays} (per-chunk stepping) "
            f"supports only the lip photometric loss; disable {bad}")
    return n_rays // batch_rays


def _rank_logger(out_dir: str, logfile: str) -> logging.Logger:
    """Rank 0's file and console logger; other ranks log warnings only."""
    if distributed.is_main_process():
        return setup_logger(out_dir, logfile)
    logger = logging.getLogger(
        f"speech2lip_tpu_torch.rank{distributed.process_index()}")
    logger.setLevel(logging.WARNING)
    return logger


def fit(cfg: Dict[str, Any], max_iters: Optional[int] = None,
        exit_after: Optional[float] = None, device=None) -> ts.TrainState:
    """Train until ``max_iters`` or ``exit_after`` seconds (then a
    checkpoint and ``SystemExit(3)``).  Returns the state.

    Each printed iteration's ``train/`` scalars add ``batch_ms`` (the host
    batch and its copy to the device) and ``step_ms`` (the step, up to the
    loss read that waits for the device).

    Under a process group of N ranks (``parallel.distributed``) the mesh
    is ``parallel.mesh_shape`` ``[D, P]`` (default ``[N, 1]``; D * P =
    N): each data index trains on ``training.batch_size`` frames of a
    global batch of ``batch_size * D``, its P pixel ranks share them and
    split the U-Net's rows, and every rank ends each step with the same
    state.  Rank 0
    writes the log, ``metrics.jsonl``, the images and the dense
    checkpoints; with ``training.sharded_ckpt`` every rank takes part in
    each save.  Validation runs on every rank, so that the best-metric
    decision agrees across ranks."""
    device = distributed.rank_device(resolve_device(device))
    tr = cfg["training"]
    mesh = mesh_mod.make_mesh(cfg["parallel"].get("mesh_shape"), device)
    main = distributed.is_main_process()
    out_dir = tr["out_dir"]
    logger = _rank_logger(out_dir, tr.get("logfile", "train.log"))
    metrics_w = MetricsWriter(out_dir) if main else None
    ckpt_mgr = CheckpointManager(out_dir,
                                 sharded=bool(tr.get("sharded_ckpt", False)))
    ckpt_here = main or ckpt_mgr.sharded

    ds = LipDataset(cfg["data"]["path"], "train", cfg)
    val_ds = LipDataset(cfg["data"]["path"], "val", cfg)

    params, unet_p, unet_s, frozen = init_models(cfg, ds, tr.get("seed", 0),
                                                 device)
    frozen = load_frozen_weights(cfg, frozen)
    opt = ts.make_optimizer(cfg)
    n_chunks = _n_chunks(cfg, ds)
    chunked = n_chunks > 1
    trainable = params if chunked else {"model": params, "unet": unet_p}
    state = ts.TrainState(params, unet_p, unet_s,
                          opt.init(ts.tree_leaves(trainable)), 0)

    # resume by default; ``it`` counts completed optimizer steps
    tree, scalars = ckpt_mgr.restore(ts.state_to_tree(state, chunked))
    state = mesh_mod.replicate(ts.state_from_tree(tree), mesh)
    it = int(scalars.get("it", 0))
    epoch_it = int(scalars.get("epoch_it", -1))
    metric_best = float(scalars.get("loss_val_best", -np.inf))
    logger.info("resume at it=%d epoch=%d best=%.4f", it, epoch_it,
                metric_best)

    statics = build_statics(cfg, ds, max(it, 0), device)
    if (statics.pallas_gather and statics.use_canonical_depth_loss
            and statics.depth_loss_box is None and _has_masks(ds)):
        pts = depth_loss_points(ds.mask_head_canonical,
                                ds.mask_face_canonical, ds.rgb_face_zero,
                                device)
        if pts is not None:
            frozen["depth_pts"] = pts
    if chunked:
        step_fn = ts.make_chunked_train_step(opt, statics, n_chunks, mesh)
    else:
        step_fn = ts.make_train_step(opt, statics, frozen, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(tr.get("seed", 0)))

    t0 = time.time()
    t0b = time.time()
    # the data axis splits the epoch; the pixel ranks of an index share it
    n_proc, proc_id = mesh.data, mesh.data_index
    batch_size = int(tr["batch_size"])
    # the smallest rank's slice: every rank takes as many frames a step
    host_frames = len(ds) // n_proc
    if host_frames < 1:
        raise ValueError(
            f"the {len(ds)}-frame train split gives a rank no frame over "
            f"{n_proc} ranks: data sharding needs >= 1 frame a rank; use a "
            f"longer clip or fewer ranks")
    if batch_size > host_frames:
        logger.warning("batch %d a rank exceeds the %d-frame slice of a "
                       "rank; clamping to %d", batch_size, host_frames,
                       host_frames)
        batch_size = host_frames
    logger.info("mesh data=%d rank=%d pixel=%d data_index=%d "
                "pixel_index=%d device=%s; global batch %d; loader %s",
                mesh.data, mesh.rank, mesh.pixel, mesh.data_index,
                mesh.pixel_index, device, batch_size * n_proc,
                prefetch_backend(ds) or "python")

    def save_tree():
        return ts.state_to_tree(state, chunked)

    def time_is_up() -> bool:
        """The time limit, decided alike on every rank (rank 0's clock)."""
        up = time.time() - t0 >= exit_after
        if mesh.world == 1:
            return up
        flag = torch.tensor(float(main and up), device=device)
        return bool(mesh_mod.sum_no_grad(flag, mesh, mesh_mod.ALL) > 0)

    while True:
        epoch_it += 1
        t_it = time.perf_counter()
        for host_batch in batch_iterator(ds, batch_size, shuffle=True,
                                         seed=epoch_it, n_proc=n_proc,
                                         proc_id=proc_id):
            it += 1

            # staging boundary: rebuild the step once
            sync_on, frozen_net = _stage_flags(tr, it)
            if (not chunked and (sync_on, frozen_net)
                    != (statics.sync_on, statics.postnet_frozen)):
                logger.info("staging change at it=%d: sync_on=%s frozen=%s",
                            it, sync_on, frozen_net)
                statics = dataclasses.replace(statics, sync_on=sync_on,
                                              postnet_frozen=frozen_net)
                step_fn = ts.make_train_step(opt, statics, frozen, mesh)

            if not statics.sync_on:
                host_batch = {k: v for k, v in host_batch.items()
                              if k not in _SYNC_KEYS}
            batch = to_device(host_batch, device)
            b = int(batch["audio"].shape[0])
            draws = (ts.draw_chunk_noise(n_chunks, b, device, gen, mesh)
                     if chunked
                     else ts.draw_noise(statics, b, device, gen, mesh))
            t_batch = time.perf_counter()
            state, m = step_fn(state, batch, draws)

            if tr["print_every"] > 0 and it % tr["print_every"] == 0:
                loss = float(m["loss"])
                t_step = time.perf_counter()
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at it={it}")
                logger.info("[Epoch %02d] it=%d loss=%.4f psnr=%.2f t=%.2fs",
                            epoch_it, it, loss, float(m["psnr"]),
                            time.time() - t0b)
                if main:
                    metrics_w.scalars(it, dict(
                        m, batch_ms=1e3 * (t_batch - t_it),
                        step_ms=1e3 * (t_step - t_batch)), prefix="train/")
                t0b = time.time()

            if (tr["checkpoint_every"] > 0 and it % tr["checkpoint_every"] == 0
                    and ckpt_here):
                bad = check_weights(state.params)
                if bad:
                    raise FloatingPointError(
                        f"non-finite weights at it={it}: {bad[:5]}")
                ckpt_mgr.save_latest(save_tree(), async_=True,
                                     epoch_it=epoch_it, it=it,
                                     loss_val_best=metric_best)
            if (tr["backup_every"] > 0 and it % tr["backup_every"] == 0
                    and ckpt_here):
                ckpt_mgr.save_step(save_tree(), it, async_=True,
                                   epoch_it=epoch_it,
                                   loss_val_best=metric_best)

            if (tr.get("visualize_every", 0) > 0
                    and it % tr["visualize_every"] == 0 and main):
                visualize(state.params, cfg, val_ds, metrics_w, it, device)

            if (tr["validate_every"] > 0 and it % tr["validate_every"] == 0
                    and it != 0):
                psnr = evaluate_psnr(state.params, cfg, val_ds,
                                     device=device)
                if main:
                    metrics_w.scalars(it, {"psnr": psnr}, prefix="val/")
                logger.info("validation psnr=%.4f", psnr)
                if psnr > metric_best:
                    metric_best = psnr
                    if ckpt_here:
                        ckpt_mgr.save_best(save_tree(), epoch_it=epoch_it,
                                           it=it, loss_val_best=metric_best)

            done = max_iters is not None and it >= max_iters
            if done or (exit_after is not None and time_is_up()):
                if not done:
                    logger.info("time limit reached; checkpoint + exit(3)")
                if ckpt_here:
                    ckpt_mgr.save_latest(save_tree(), epoch_it=epoch_it,
                                         it=it, loss_val_best=metric_best)
                ckpt_mgr.wait()
                if main:
                    metrics_w.close()
                mesh_mod.barrier()
                if done:
                    return state
                raise SystemExit(3)
            t_it = time.perf_counter()
