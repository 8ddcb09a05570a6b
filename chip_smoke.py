"""Smoke run of the PyTorch/CUDA port (speech2lip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, at first use), checks each
against its plain PyTorch version at May shapes (500x500 face, 120x80 lip)
in float32 and bfloat16, then drives the port's paths on random parameters
made from a seed:

- serving: three batches of 8 frames through the Renderer in bfloat16
  (K1 fused_mlp, K2 window_sample, K3 fused_block), one batch against the
  plain path;
- the U-Net's inference entry points at 500x500, batch 8, bfloat16:
  apply_infer_hcw (10 K4 conv3x3_hcw launches), apply_infer_pallas (10 K6
  conv3x3_infer launches) and apply_infer_dconv (5 K5 double_conv_hcw
  launches), each against the plain forward;
- static-scene serving: three batches of 8 through the
  StaticSceneRenderer in bfloat16 (K1, K2 and K3 on the lip-window crop);
- training: three bfloat16 stage-1 steps at batch 8 with the K7 gathers on
  (K2 forward, K7 hat_sample_dsrc / hat_sample_dgrid backward), one step
  against the plain path, a float32 step on a small input, and one
  sync-stage step (SyncNet loss, frozen U-Net) at batch 2;
- the user's loop on a learnable identity written at May geometry (48
  frames, val 8): cli/train in bfloat16 at batch 8 to iteration 6 across
  the sync staging boundary (iteration 3), resumed to 8 (K2 and K7 per
  step, K1 in validation), a bit-exact restore of its checkpoint, then
  cli/infer rendering the val split from it (K1, K2 and K3 a batch), one
  batch against the plain path; fit's ms per iteration (batch build and
  step) and cli/infer's frames/s;
- serving new audio on that identity: DeepSpeech at its published widths
  (seeded weights, a seeded 4 s clip) on the card against the CPU, and
  with TF32 allowed, whose error must exceed the bound;
  cli/serve --once over it and a second learnable identity (.npy
  requests, a .wav through --deepspeech, a bad request), plain and
  --static (K1, K2 and K3 a batch), one batch on the server or static
  renderer that served it against the plain path; tools/bench_serving at
  its defaults (8 identities at 512^2, batch 16, 8 waves), plain and
  --static, identity 0's last wave against the plain path; cli/infer
  --change_pose --export_video (K1 and K3 a batch, the AVI's frames), a
  batch on its pose renderer against the plain path, the splat on the
  card against the CPU;
- evaluation and the sync teacher on that identity: cli/train_syncnet
  (60 steps, batch 8, lr 3e-4; the loss must fall below 0.55 and by 0.1,
  and the teacher must score the ground-truth windows at offset 0 with a
  confidence above 0.05), cli/evaluate --lms-from-fan --sync of the
  rendered val frames on the card against the CPU, and
  tools/convergence_run at May width (teacher, fit across the sync
  boundary, three cli/infer renders and their scores; K1, K2, K3 and K7
  launches by part, a finite report);
- preprocessing at full width: a Basel-sized synthetic 3DMM (34,650
  vertices) rendered at 500^2 in 50 frames with their true landmarks, an
  AVI, seeded FAN (4 modules), DSFD (ResNet-152), S3FD, BiSeNet and
  DeepSpeech; every cli/preprocess step on the card (extract, landmarks
  with DSFD and with S3FD, track, warp, uv_mapping, masks, crop_lip,
  audio_features) with the tracker's budgets cut by --track_scale, the
  artifact contract, the landmark loss falling, find_focal on a
  3-candidate grid, and the rasterizer, the four nets and a landmark phase
  on the card against the CPU (float32, TF32 off); no port kernel runs
  there;
- the user's tools: the reference's weight files at published widths
  (model_may.pt at May geometry, SyncNet, AlexNet + the LPIPS heads, FAN
  with 4 modules, DSFD on ResNet-152, S3FD, BiSeNet, a DeepSpeech .npz),
  made from seeds in their names and blob layouts, through
  tools/convert_weights --all (and the .npz by its positional form), each
  converted net on the card against the CPU, DSFD on i.i.d. noise against
  a float64 forward, and a Renderer batch of the converted talking face
  against the plain path; tools/full_pipeline_run at May width (24 frames
  of a raw AVI of a 34,650-vertex 3DMM through every cli/preprocess step,
  fit in bfloat16 at batch 8 until model_best.ckpt is selected, cli/infer,
  cli/evaluate) with K1, K2, K3 and K7 launches by step and the first
  batch of cli/infer's own renderer against the plain path;
  tools/bench_train in its default mode (K2 / K7 launches a step) and
  tools/bench_components at batch 32 (each stage against its plain path);
- the dot probe's tool (speech2lip_tpu_torch.tools.bench_int8_dot) at its
  full shape and its own count of calls: one warm-up and ITERS timed K8
  dot_probe calls in bf16 and in int8, its outputs against the plain
  version;
- training across processes: fit (float32, K2/K7 gathers, K1 validation)
  with torch's default TF32 flags on the card against the CPU, every
  float32 card conv without TF32; then, in children that run this script
  again (``--rank-job SPEC``, through torch.distributed.run), fit at May
  geometry with no group and under a one-rank NCCL group, equal bit for
  bit (plain gathers, deterministic torch ops), with the gradients' flat
  NCCL all-reduce timed; two gloo ranks sharing the card against one
  rank on the global batch (fit with K1/K2/K7 launches a rank, its first
  iteration's two sides each against a float64 fit, and one train
  step), the gradient all-reduce over gloo timed; sharded
  checkpoint round trips into NaN templates at one and two ranks; and
  MultiSpeakerServer(mesh=) at one rank against the server with no mesh
  (K1/K2/K3 launches);
- the pixel axis: four gloo ranks sharing the card (one
  torch.distributed.run of ``--rank-job SPEC``), the train step at May
  geometry under a (2, 2) and a (1, 4) mesh (the U-Net on a band of rows
  a rank, 252/248 and 128/124/124/124, with halo exchanges), float32 and
  bf16, against the one-process step on the global batch (with the
  mesh steps' conv algorithms, cuDNN's heuristic pick), every rank
  ending alike, its K2/K7 launches a rank and the halos' bytes and ms;
  MultiSpeakerServer and the tracker's photometric term under (2, 2);

checks that the kernels carried each path (launch counts, set to 0 just
before a path and read just after) and that the composite hands K2, and
hat_sample K2 and K7, the frame's crop and the coord grid's window as
views, with no copy op; and times the kernels, a PyTorch library call
computing the same function where there is one, and the paths with CUDA
events.  K2 and K7 get two times each, in turns with their library call:
the call time (the row's ms, the host's dispatch included) and the device
time (a CUDA graph of 100 calls replayed, device_ms); both K7 rows, on
the train step's own inputs, also count their device launches a call (the
nodes of a CUDA graph of one call) and carry the kernel's local bytes.
Needs one CUDA device; without one it exits non-zero before printing any
result.

The last line is {"ok": true, "device": {...}}; the line before it lists
each kernel's launches on its path, error, times and bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import torch

FACE, LIP_H, LIP_W, MARGIN = 500, 80, 120, 16
SEED = 0
# kernel vs plain bounds on max|diff|, times max(1, max|plain|): float32 sums
# in another order (3xTF32 products in K1/K3), bfloat16 rounds at other
# places (a few bf16 ulps of the outputs at most)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
K2_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # one rounding apart
SLICE_BF16_BOUND = 1e-2  # kernel path vs plain path, face and lip
# K7 vs plain: dsrc's float32 atomics add in another order (bf16 then
# rounds once, one ulp apart at most); dgrid sums the same inputs in float32
K7_BOUND = {"dsrc": {torch.float32: 1e-5, torch.bfloat16: 1e-2},
            "dgrid": {torch.float32: 1e-5, torch.bfloat16: 1e-5}}
# train step, kernel path vs plain path, relative to the largest plain
# magnitude: float32 sums in another order; in bfloat16 a K2/dsrc output
# one ulp (2^-8) apart flips roundings that the bf16 U-Net carries on
TRAIN_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# a U-Net entry point in bf16 against the plain forward in bf16: the plain
# forward rounds after every op, the kernels once per conv (the serving
# slice's bound)
UNET_BF16_BOUND = 1e-2
# K8 bf16 vs plain: float32 sums of exact bf16 products in another order
# than the plain version's float64 (int8 must be exact)
K8_BF16_BOUND = 1e-4
# static scene, kernel path: the crop's interior against the full frame.
# Align-corners upsampling samples the crop's coarse levels at other
# points than the full frame's (up to half a coarse pixel apart), and bf16
# rounds on top; a wrong column mask or swapped upsample ratios in K3 on
# the non-square crop moves it by the activations' own size
STATIC_GAP_BOUND = 1e-2
TRAIN_B, SYNC_B = 8, 2
# NVIDIA H100 SXM data sheet: dense bf16 and int8 tensor-core and float32
# (no tensor core) peaks, HBM3 rate; a bound is the larger of ops / peak
# and bytes / rate, each input read once and each output written once
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# (block.conv, H=W, cin) of the U-Net's ten convs at 500x500, and (block,
# H=W, cin) of its five DoubleConvs; the weights give cmid and cout
UNET_CONVS = [("inc.1", 500, 3), ("inc.2", 500, 64), ("down1.1", 250, 64),
              ("down1.2", 250, 128), ("down2.1", 125, 128),
              ("down2.2", 125, 128), ("up1.1", 250, 256), ("up1.2", 250, 128),
              ("up2.1", 500, 128), ("up2.2", 500, 64)]
UNET_DCONVS = [("inc", 500, 3), ("down1", 250, 64), ("down2", 125, 128),
               ("up1", 250, 256), ("up2", 500, 128)]


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def check(name: str, pairs, bound: float) -> float:
    """Max |kernel - plain| over (kernel, plain) output pairs; fails when it
    exceeds bound * max(1, max|plain|).  Returns the absolute error."""
    worst = 0.0
    for got, ref in pairs:
        got, ref = got.float(), ref.float()
        require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                f"{name}: output {tuple(got.shape)} vs {tuple(ref.shape)} "
                "or non-finite")
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        log(f"# check {name}: max|diff| {err:.3g}, bound {bound} x {scale:.3g}")
        require(err <= bound * scale, f"{name} disagrees with its plain "
                "version")
        worst = max(worst, err)
    return worst


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops: float, moved: float, peak: str):
    """(least ms, what bounds it) of work of ``ops`` operations at the
    ``peak`` rate moving ``moved`` bytes through device memory."""
    t_ops, t_bytes = ops / PEAK[peak], moved / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_ops(x, cin: int, cout: int) -> float:
    """Operations of a 3x3 conv over x's pixels (a multiply-add is 2)."""
    return 2.0 * x.numel() / x.shape[-1] * 9 * cin * cout


def library_conv(x, w, scale, bias):
    """One cuDNN call for conv3x3(x) * scale + bias (ReLU not included):
    channels-last F.conv2d on x's NHWC memory, the scale folded into the
    weights outside the call.  A yardstick; the port never calls it."""
    import torch.nn.functional as F
    wf = (w.float() * scale).to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bf = bias.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    return lambda: F.conv2d(xc, wf, bf, padding=1)


def k5_weight_bytes(shape, cmid: int, cout: int, tiling: str) -> int:
    """Weight bytes one K5 launch on x of ``shape`` [B, H, W, Cin] streams
    from L2: every block reads conv1's weights once per conv1 M pass and
    conv2's once per conv2 M pass.  ``tiling`` "bf16" is the bf16 body of
    csrc/double_conv.cu (14x30 output tiles from a 16x32 mid tile at Cmid
    128, 30x30 from 32x32 in two M passes at Cmid 64, 512 output pixels a
    conv2 pass); "14x14" the bf16 body before it (as the float32 body
    still tiles): one pass per conv, 14x14 tiles.  bf16 weights."""
    b, h, w, cin = shape
    if tiling == "bf16":
        th, tw = (14, 30) if cmid == 128 else (30, 30)
        m1, m2 = (th + 2) // 16, -(-th * tw // 512)
    else:
        th = tw = 14
        m1 = m2 = 1
    blocks = -(-h // th) * -(-w // tw) * b
    return blocks * 9 * 2 * (m1 * cin * cmid + m2 * cmid * cout)


def named_leaves(tree, prefix=""):
    """[(dotted name, tensor)] in ``train_step.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


# kernel-name fragments of a profiled step's device time, by layer: the
# port's kernels, cuDNN convolutions, matmuls (lip MLP, 1x1 convs, LPIPS
# heads) and everything else (BatchNorm, activations, losses, Adam, glue)
PROFILE_GROUPS = (
    ("port kernels (K1-K7)", ("hat_dsrc", "hat_dgrid", "window_sample",
                              "fused_mlp_kernel", "conv3x3_kernel",
                              "double_conv_kernel")),
    ("convolutions", ("conv", "implicit", "fprop", "dgrad", "wgrad",
                      "cudnn", "winograd")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "cublas")),
)


def profile_steps(run, what: str, steps: int = 2):
    """Device time of ``steps`` calls of ``run`` by kernel group and the
    busiest kernels (torch.profiler).  Returns (device ms, kernel launches)
    per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    per_kernel, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        per_kernel[e.key] = t / 1000.0 / steps        # ms per step
        launches += e.count
    total = sum(per_kernel.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other (elementwise, reductions, glue)"] = 0.0
    for key, ms in per_kernel.items():
        low = key.lower()
        for name, frags in PROFILE_GROUPS:
            if any(f in low for f in frags):
                groups[name] += ms
                break
        else:
            groups["other (elementwise, reductions, glue)"] += ms
    log(f"# profile {what}: device time {total:.2f} ms per step over "
        f"{launches // steps} kernel launches")
    if total == 0:
        # the profiler can drop a short run's activity records; this log
        # is no count (graph_launches counts a call's launches exactly)
        log(f"# profile {what}: no device activity recorded")
        return total, 0
    for name, ms in groups.items():
        log(f"# profile   {name}: {ms:.2f} ms ({100 * ms / total:.1f}%)")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"# profile   top {ms:.3f} ms {key[:110]}")
    return total, launches // steps


# CUgraphNodeType values of work a call enqueues on the device
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_launches(run) -> dict:
    """The device work one call of ``run`` enqueues: the nodes of a CUDA
    graph captured from that call, counted by kind (kernel, memcpy,
    memset).  Exact, where a profile's count of the same call loses any
    activity record that the profiler drops."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        run()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
            "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    require(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
            "cuGraphGetNodes failed")
    kinds = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        require(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType failed")
        name = GRAPH_NODE_KINDS.get(kind.value, f"type {kind.value}")
        kinds[name] = kinds.get(name, 0) + 1
    del graph
    return kinds


def train_inputs(dev, b, face, lip_h, lip_w, with_sync=False):
    """A synthetic training batch on ``dev`` as the trainer hands it to the
    step (``tools.bench_train.train_inputs``, seeded by SEED): returns
    (batch, geo, window, params, frozen)."""
    from speech2lip_tpu_torch.tools import bench_train
    return bench_train.train_inputs(dev, b, face, lip_h, lip_w,
                                    with_sync=with_sync, seed=SEED)


# the user's loop: a learnable identity at May geometry, trained through
# cli/train (resumed once, across the sync staging boundary), then
# rendered through cli/infer from its checkpoint
LOOP_FRAMES, LOOP_ITERS = 48, (6, 8)
LOOP_TRAINING = {"compute_dtype": "bfloat16", "batch_size": TRAIN_B,
                 "pallas_gather": "auto", "use_syncloss": True,
                 "sync_start_iter": 3, "print_every": 1,
                 "checkpoint_every": 2, "backup_every": 4,
                 "validate_every": 4, "visualize_every": 4}


def loop_launches(tr: dict, its, val_frames: int) -> dict:
    """Launches ``fit`` makes over iterations ``its``: K2 / dsrc / dgrid
    per step (stage 1: the window gather and the depth-loss points; the
    sync stage adds the T-frame window gather), K1 once per frame that
    validation and visualisation render, no K3."""
    n = {"window_sample": 0, "hat_sample_dsrc": 0, "hat_sample_dgrid": 0,
         "fused_mlp": 0, "fused_block": 0}
    for it in its:
        sync = it > tr["sync_start_iter"]
        n["window_sample"] += 3 if sync else 2
        n["hat_sample_dsrc"] += 2 if sync else 1
        n["hat_sample_dgrid"] += 1
        if it % tr["validate_every"] == 0:
            n["fused_mlp"] += val_frames
        if tr["visualize_every"] > 0 and it % tr["visualize_every"] == 0:
            n["fused_mlp"] += 1
    return n


def user_loop(dev, card: str, tmp: str) -> dict:
    """cli/train twice (to LOOP_ITERS[0], then resumed to LOOP_ITERS[1])
    and cli/infer on a ``make_learnable_tree`` at May geometry, in the
    directory ``tmp``.  Checks the launches of each run, finite losses,
    the files, a bit-exact restore and the rendered frames; returns the
    launches by path, the timings and the identity (its config's path)."""
    import copy
    import os
    import statistics

    import numpy as np
    import yaml

    from speech2lip_tpu_torch.cli import infer as cli_infer
    from speech2lip_tpu_torch.cli import train as cli_train
    from speech2lip_tpu_torch.config import load_config, save_config
    from speech2lip_tpu_torch.core.checkpoint import (CheckpointManager,
                                                      flatten_paths, load)
    from speech2lip_tpu_torch.data import image_io
    from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
    from speech2lip_tpu_torch.data.synthetic import (make_learnable_tree,
                                                     synthetic_config)
    from speech2lip_tpu_torch.infer.renderer import (Renderer,
                                                     render_face_batch,
                                                     render_lip_batch)
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.train import train_step as ts
    from speech2lip_tpu_torch.train.trainer import (init_params, to_device,
                                                    warp_window)

    def reset():
        kmlp.launches = kws.launches = kfb.launches = 0
        khs.dsrc_launches = khs.dgrid_launches = 0

    def counts():
        return {"window_sample": kws.launches,
                "hat_sample_dsrc": khs.dsrc_launches,
                "hat_sample_dgrid": khs.dgrid_launches,
                "fused_mlp": kmlp.launches, "fused_block": kfb.launches}

    out = {"fit": {}, "cli_infer": {}}
    cwd = os.getcwd()
    t0 = time.perf_counter()
    root = os.path.join(tmp, "identity")
    geo = make_learnable_tree(root, n_frames=LOOP_FRAMES, face=FACE,
                              lip_h=LIP_H, lip_w=LIP_W, seed=SEED)
    cfg = synthetic_config(root, geo)
    cfg["training"].update(LOOP_TRAINING,
                           out_dir=os.path.join(tmp, "run"))
    path = os.path.join(tmp, "identity.yaml")
    save_config(path, cfg)
    text = open(path).read()
    require(load_config(path) == cfg, "the written config reads back "
            "as another")
    require("  skips:\n  - " in text, "the written config holds no block "
            "sequence")
    # a config in the forms a user writes by hand, inheriting the loop's
    child = os.path.join(tmp, "child.yaml")
    with open(child, "w") as f:
        f.write("inherit_from: identity.yaml\ndata:\n"
                "  path: \"data/a quoted path\"\n"
                "test:\n  model_file: 'model_7.ckpt'\n"
                "training:\n  scheduler_milestones: [7,\n    9]\n")
    want = copy.deepcopy(cfg)
    want["data"]["path"] = "data/a quoted path"
    want["test"]["model_file"] = "model_7.ckpt"
    want["training"]["scheduler_milestones"] = [7, 9]
    require(load_config(child) == want, "a hand-written config "
            "inheriting the loop's reads as another")
    log(f"# user loop: learnable tree {LOOP_FRAMES} frames at face "
        f"{FACE}, lip {LIP_H}x{LIP_W} written in "
        f"{time.perf_counter() - t0:.1f} s; config: {path} "
        f"({len(text.splitlines())} lines by yaml {yaml.__version__} "
        f"safe_dump), read back with {os.path.basename(child)}")
    tr = cfg["training"]
    val_frames = cfg["data"]["val_split_frames"]
    run_dir = tr["out_dir"]
    first = 0
    runs = []   # the train records of each run
    metrics = os.path.join(run_dir, "metrics.jsonl")
    for n in LOOP_ITERS:
        if first:
            resume = CheckpointManager(run_dir).latest_step_file()
            first = load(resume)[1]["it"]
            log(f"# user loop: cli/train resumes from "
                f"{os.path.basename(resume)} at it={first} (the highest "
                f"model_<it>.ckpt, as the JAX trainer picks)")
        reset()
        t1 = time.perf_counter()
        state = cli_train.main([path, "--max-iters", str(n)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got, want = counts(), loop_launches(tr, range(first + 1, n + 1),
                                            val_frames)
        log(f"# user loop: cli/train it {first + 1}..{n} in {wall:.1f} "
            f"s; launches {got} (expected {want})")
        recs = [json.loads(line) for line in open(metrics)]
        runs.append([r for r in recs if "train/loss" in r][
            sum(len(r) for r in runs):])
        require(state.it == n and [r["it"] for r in runs[-1]]
                == list(range(first + 1, n + 1)),
                f"cli/train stopped at it={state.it}, printed its "
                f"{[r['it'] for r in runs[-1]]}")
        require(got == want, f"cli/train launches {got}, expected {want}")
        for k, v in got.items():
            out["fit"][k] = out["fit"].get(k, 0) + v
        first = n
    train = runs[0] + runs[1]
    require(all(np.isfinite(r["train/loss"]) for r in train)
            and any("train/loss_sync" in r for r in train)
            and any("val/psnr" in r for r in recs),
            "train metrics: non-finite, or no sync loss or validation")
    files = set(os.listdir(run_dir))
    want_files = {"model.ckpt", "model_4.ckpt", "model_8.ckpt",
                  "model_best.ckpt", "metrics.jsonl", "train.log",
                  "tensorboard", "images"}
    require(want_files <= files, f"run files {sorted(files)}")
    # the final state restores bit-exactly from model.ckpt: the file
    # holds every key of the state and no other, and a template of NaN
    # (-1 for integers) takes every leaf from it, since the tolerant
    # load keeps a template leaf whose key is missing
    live = ts.state_to_tree(state)
    keys = set(load(os.path.join(run_dir, "model.ckpt"))[0])
    want_keys = {k for k, _ in flatten_paths(live)}
    require(keys == want_keys, f"model.ckpt keys: missing "
            f"{sorted(want_keys - keys)[:5]}, extra "
            f"{sorted(keys - want_keys)[:5]}")
    blank = ts.tree_map(
        lambda x: (torch.full_like(x, float("nan"))
                   if x.is_floating_point() else torch.full_like(x, -1))
        if isinstance(x, torch.Tensor) else -1, live)
    tree, sc = CheckpointManager(run_dir).restore(blank, "model.ckpt")
    pairs = list(zip(ts.tree_leaves(live), ts.tree_leaves(tree)))
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor)
               else a == b for a, b in pairs)
    require(same and sc["it"] == state.it and len(pairs) == len(keys),
            "model.ckpt does not restore the final state bit-exactly")
    log(f"# user loop: model.ckpt holds the state's {len(keys)} keys "
        f"and restores all {len(pairs)} leaves bit-exactly")

    # validation's K1 call, one frame at May geometry in float32 (as
    # evaluate_psnr and visualize render it), against the plain MLP
    vds = LipDataset(root, "val", cfg)
    s = vds.load_frame(0)
    audio = torch.from_numpy(s["audio"])[None].to(dev)
    t = torch.tensor([float(s["index"])], device=dev)
    with torch.no_grad():
        lip = {use: render_lip_batch(state.params, audio, t, LIP_H, LIP_W,
                                     use_kernels=use) for use in (True,
                                                                 False)}
    out["val_frame_err"] = check("fit validation frame, K1 f32 one "
                                 "frame", [(lip[True], lip[False])],
                                 BOUND[torch.float32])
    # steady iterations: stage 1 after the first run's first step, the
    # sync stage after the resumed run's first step
    stages = {"stage 1": [r for r in runs[0][1:]
                          if r["it"] <= tr["sync_start_iter"]],
              "sync": runs[1][1:]}
    for name, rs in stages.items():
        b = statistics.median(r["train/batch_ms"] for r in rs)
        st_ms = statistics.median(r["train/step_ms"] for r in rs)
        out[f"fit_{name}"] = {"batch_ms": b, "step_ms": st_ms,
                              "iters": [r["it"] for r in rs]}
        log(f"# user loop: fit {name} bf16 batch {TRAIN_B}, median of "
            f"its {[r['it'] for r in rs]}: {b + st_ms:.1f} ms/iteration "
            f"= batch build {b:.1f} ms + step {st_ms:.1f} ms on {card} "
            "(checkpoints, validation and visualisation excluded)")
    # each run's wall time an iteration, everything between two printed
    # iterations included: the gaps of the records' clocks
    for i, rs in enumerate(runs):
        gaps = [1e3 * (b["t"] - a["t"]) for a, b in zip(rs, rs[1:])]
        out[f"fit_run{i}_wall_ms"] = gaps
        log(f"# user loop: fit run {i} wall ms an iteration, its "
            f"{[r['it'] for r in rs[1:]]}: "
            f"{', '.join(f'{g:.1f}' for g in gaps)} (mean "
            f"{statistics.mean(gaps):.1f}) on {card}")

    # cli/infer renders the val split from the checkpoint, twice (the
    # second call is timed), in bf16 on the card
    os.chdir(tmp)
    try:
        for i in range(2):
            reset()
            res = cli_infer.main([path, "--output_dir", "smoke",
                                  "--batch", str(TRAIN_B)])
            got = counts()
            log(f"# user loop: cli/infer call {i}: {res['frames']} "
                f"frames from it={res['it']} in {res['seconds']:.3f} s "
                f"= {res['frames'] / res['seconds']:.1f} frames/s "
                f"(render {res['frames'] / res['render_seconds']:.1f} "
                f"frames/s); launches {got} on {card}")
            n_batches = -(-val_frames // TRAIN_B)
            want = {"window_sample": n_batches, "hat_sample_dsrc": 0,
                    "hat_sample_dgrid": 0, "fused_mlp": n_batches,
                    "fused_block": 5 * n_batches}
            require(got == want, f"cli/infer launches {got}, "
                    f"expected {want}")
        frames = sorted(os.listdir(res["out_dir"]))
        require(len(frames) == val_frames == res["frames"]
                and res["compute_dtype"] == "bfloat16",
                f"cli/infer wrote {len(frames)} frames, "
                f"{res['compute_dtype']}")
        img = image_io.imread_float(os.path.join(res["out_dir"],
                                                 frames[0]))
        require(img.shape == (FACE, FACE, 3), f"frame {img.shape}")
    finally:
        os.chdir(cwd)
    out["cli_infer"] = got
    out["cli_infer_fps"] = res["frames"] / res["seconds"]
    out["cli_infer_render_fps"] = res["frames"] / res["render_seconds"]

    # one batch of the served checkpoint against the plain path
    scfg = load_config(path)
    scfg["model"]["compute_dtype"] = "bfloat16"
    ds = LipDataset(root, "val", scfg)
    p, up, us = init_params(scfg, ds, device=dev)
    st, _ = CheckpointManager(run_dir).restore(
        {"params": p, "unet_params": up, "unet_state": us})
    win = warp_window(scfg, ds)
    rnd = Renderer(scfg, st["params"], st["unet_params"],
                   st["unet_state"], device=dev, window=win)
    host = stack_batch([ds.load_frame(i) for i in range(TRAIN_B)])
    batch = to_device(host, dev)
    got = rnd(batch, ds.lefttop_x, ds.lefttop_y)["face"]
    ref = render_face_batch(
        *rnd.params, batch, lip_x=ds.lefttop_x, lip_y=ds.lefttop_y,
        lip_h=LIP_H, lip_w=LIP_W, use_kernels=False,
        compute_dtype=torch.bfloat16, window=win)["face"]
    e = float((got - ref).abs().max())
    log(f"# user loop: served checkpoint, one batch of 8, kernels vs "
        f"plain path face max|diff| {e:.3g} (bound {SLICE_BF16_BOUND})")
    require(e <= SLICE_BF16_BOUND and bool(torch.isfinite(got).all()),
            "the served checkpoint's face disagrees with the plain path")
    out["cli_infer_err"] = e
    out["identity"] = path
    out["rendered"] = os.path.join(tmp, res["out_dir"])
    return out



# serving new audio: DeepSpeech at its published widths on a seeded clip,
# cli/serve over two identities (phase 6's trained one and a second
# learnable tree with seeded weights), the serving tool at its defaults,
# and cli/infer's pose edit with its video export on phase 6's checkpoint
NA_SECONDS, NA_RATE, SERVE_B, DS_CALLS = 4.0, 16000, 32, 3
# DeepSpeech windows, card vs CPU, both float32 with TF32 off: the same
# products summed in another order, carried through 2 x 4096 LSTM steps.
# On an H100 this reads 3.9e-8 and a run with TF32 allowed 1.5e-5; the
# smoke runs both and requires the TF32 run's error to exceed the bound
DS_BOUND = 1e-6
# a whole pose warp, card vs CPU: the share of pixels whose float32 target
# may round to the other neighbour (the splat itself must be exact)
POSE_WARP_SHARE = 0.01
NEW_AUDIO_PATHS = ("serve", "serve_static", "bench_serving",
                   "bench_serving_static", "cli_infer_pose")


def avi_video_frames(path: str) -> int:
    """The video chunks ('00dc') of an AVI, walked through its lists."""
    import struct

    buf = open(path, "rb").read()
    require(buf[:4] == b"RIFF" and buf[8:12] == b"AVI ", f"{path}: no AVI")

    def walk(pos, end):
        n = 0
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            if fourcc == b"LIST":
                n += walk(pos + 12, pos + 8 + size)
            n += fourcc == b"00dc"
            pos += 8 + size + size % 2
        return n
    return walk(12, len(buf))


def unet_k3(h: int, w: int) -> int:
    """K3 launches of one static-scene U-Net call at h x w: five where the
    renderer's shape rule takes K3, none on its plain exact-2x path."""
    from speech2lip_tpu_torch.infer.static_scene import K3_MAX
    from speech2lip_tpu_torch.models.unet_light import k3_runs
    return 5 if k3_runs((1, h, w), max(h, w) <= K3_MAX) else 0


def new_audio(dev, card: str, tmp: str, identity: str) -> dict:
    """Phase 7 in the directory ``tmp`` with phase 6's identity (its
    config's path): DeepSpeech card vs CPU, cli/serve --once plain and
    --static, tools/bench_serving plain and --static, cli/infer
    --change_pose --export_video.  Checks files, counts, launches and the
    kernel path against the plain path; returns the launches by path and
    the timings."""
    import os
    import statistics

    import numpy as np
    from scipy.io import wavfile

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.cli import infer as cli_infer
    from speech2lip_tpu_torch.cli import serve as cli_serve
    from speech2lip_tpu_torch.config import load_config, save_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.data import image_io
    from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
    from speech2lip_tpu_torch.data.synthetic import (make_learnable_tree,
                                                     synthetic_config)
    from speech2lip_tpu_torch.infer import pose_edit
    from speech2lip_tpu_torch.infer.pipeline import frame_batch
    from speech2lip_tpu_torch.ops import splat
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.ops.mfcc import deepspeech_input_vector
    from speech2lip_tpu_torch.preprocess import audio_features as af
    from speech2lip_tpu_torch.preprocess.video_io import demux_avi_pcm
    from speech2lip_tpu_torch.tools import bench_serving
    from speech2lip_tpu_torch.train.trainer import to_device

    def reset():
        kmlp.launches = kws.launches = kfb.launches = 0

    def counts():
        return {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
                "fused_block": kfb.launches}

    def per_batch(n, k3=5):
        return {"fused_mlp": n, "window_sample": n, "fused_block": k3 * n}

    out = {}
    rng = np.random.default_rng(SEED)

    # -- DeepSpeech at its published widths, the card against the CPU ----
    t0 = time.perf_counter()
    ds_cpu = weights.random_deepspeech(SEED)
    ds_card = {k: {kk: v.to(dev) for kk, v in d.items()}
               for k, d in ds_cpu.items()}
    n = int(NA_SECONDS * NA_RATE)
    t = np.arange(n) / NA_RATE
    wav = (3000 * np.sin(2 * np.pi * 180 * t) * (1 + np.sin(2 * np.pi * 3 * t))
           + 800 * rng.standard_normal(n)).astype(np.int16)
    n_par = sum(v.numel() for d in ds_cpu.values() for v in d.values())
    log(f"# new audio: DeepSpeech {n_par / 1e6:.1f} M float32 weights "
        f"(hidden {ds_cpu['fc1']['w'].shape[1]}, LSTM kernels "
        f"{tuple(ds_cpu['lstm_fw']['kernel'].shape)}) "
        f"made in {time.perf_counter() - t0:.1f} s; clip {NA_SECONDS} s at "
        f"{NA_RATE} Hz")
    # a request end to end (the first call also initialises cuBLAS), then
    # its parts: the host's MFCC input vectors and the RNN with its copies
    # (T padded to 4096, both directions); medians of DS_CALLS calls
    req_s, mfcc_s, rnn_s = [], [], []
    for _ in range(1 + DS_CALLS):
        t1 = time.perf_counter()
        got = af.wav_to_deepspeech_windows(wav, NA_RATE, ds_card, device=dev)
        req_s.append(time.perf_counter() - t1)
    for _ in range(DS_CALLS):
        t1 = time.perf_counter()
        x = deepspeech_input_vector(wav)
        mfcc_s.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        af.deepspeech_logits(x, ds_card, device=dev)
        rnn_s.append(time.perf_counter() - t1)
    t1 = time.perf_counter()
    ref = af.wav_to_deepspeech_windows(wav, NA_RATE, ds_cpu, device="cpu")
    cpu_s = time.perf_counter() - t1
    out["ds_err"] = check("DeepSpeech windows, card vs CPU, float32",
                          [(torch.from_numpy(got), torch.from_numpy(ref))],
                          DS_BOUND)
    # the same request with TF32 allowed, which the port rules out: the
    # model's own precision switch is made to ask for TF32, so this is the
    # port's code with that one fault; the bound must sit below its error
    real_precision = torch.set_float32_matmul_precision
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision = lambda _: real_precision("high")
    try:
        tf32 = af.wav_to_deepspeech_windows(wav, NA_RATE, ds_card,
                                            device=dev)
    finally:
        torch.set_float32_matmul_precision = real_precision
        real_precision(prev)
    out["ds_tf32_err"] = float(np.abs(tf32 - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    log(f"# new audio: DeepSpeech windows with TF32 allowed, card vs CPU: "
        f"max|diff| {out['ds_tf32_err']:.3g} (bound {DS_BOUND} x "
        f"{scale:.3g}, sound run {out['ds_err']:.3g})")
    require(out["ds_tf32_err"] > DS_BOUND * scale, "the DeepSpeech bound "
            "would pass a TF32 run")
    med = statistics.median
    out["ds_ms"], out["ds_rnn_ms"] = 1e3 * med(req_s[1:]), 1e3 * med(rnn_s)
    out["ds_mfcc_ms"] = 1e3 * med(mfcc_s)
    log(f"# new audio: DeepSpeech a {NA_SECONDS} s request, "
        f"{got.shape[0]} windows, median of {DS_CALLS}: {out['ds_ms']:.1f} "
        f"ms on the card (calls {', '.join(f'{1e3 * v:.1f}' for v in req_s)}"
        f"; the first initialises cuBLAS); the MFCC {out['ds_mfcc_ms']:.1f} "
        f"ms on the host; the RNN ({x.shape[0]} steps padded to 4096, 2 "
        f"directions, with its copies) {out['ds_rnn_ms']:.1f} ms = "
        f"{out['ds_rnn_ms'] / out['ds_ms']:.1%} (calls "
        f"{', '.join(f'{1e3 * v:.1f}' for v in rnn_s)}); the CPU "
        f"{1e3 * cpu_s:.1f} ms; on {card}")

    # -- cli/serve --once, plain and --static -----------------------------
    root2 = os.path.join(tmp, "identity2")
    cfg2 = synthetic_config(root2, make_learnable_tree(
        root2, n_frames=12, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
        seed=SEED + 1))
    cfg2["training"]["out_dir"] = os.path.join(tmp, "run2")
    p2, up2, us2 = weights.random_params(SEED + 1, cfg=cfg2)
    ckpt.CheckpointManager(cfg2["training"]["out_dir"]).save_latest(
        {"params": p2, "unet_params": up2, "unet_state": us2, "it": 0}, it=0)
    identity2 = os.path.join(tmp, "identity2.yaml")
    save_config(identity2, cfg2)
    ds_path = os.path.join(tmp, "deepspeech.ckpt")
    ckpt.save(ds_path, ds_cpu)
    win_a = rng.standard_normal((40, 16, 29)).astype(np.float32)
    win_b = rng.standard_normal((24, 16, 29)).astype(np.float32)
    want_done = {"reqA": 40, "reqB": 24, "reqW": got.shape[0]}
    for static in (False, True):
        tag = "serve_static" if static else "serve"
        q, o = os.path.join(tmp, f"q_{tag}"), os.path.join(tmp, f"o_{tag}")
        os.makedirs(q)
        np.save(os.path.join(q, "0__reqA.npy"), win_a)
        np.save(os.path.join(q, "1__reqB.npy"), win_b)
        np.save(os.path.join(q, "5__reqBad.npy"), win_b[:2])
        wavfile.write(os.path.join(q, "1__reqW.wav"), NA_RATE, wav)
        reset()
        res = cli_serve.main([identity, identity2, "--queue", q, "--out", o,
                              "--once", "--batch", str(SERVE_B),
                              "--deepspeech", ds_path]
                             + (["--static"] if static else []))
        torch.cuda.synchronize()
        got_l = counts()
        n_b = sum(-(-v // SERVE_B) for v in want_done.values())
        want = per_batch(n_b)
        want["fused_block"] += unet_k3(FACE, FACE) * res["static_renderers"]
        log(f"# new audio: cli/serve{' --static' if static else ''} "
            f"{res['frames']} frames of {sorted(res['done'])} (errors "
            f"{res['err']}) in {res['seconds']:.3f} s = "
            f"{res['frames'] / res['seconds']:.1f} frames/s end to end, "
            f"render {res['frames'] / res['render_seconds']:.1f} frames/s, "
            f"{res['compute_dtype']}, {res['static_renderers']} static "
            f"renderers; launches {got_l} (expected {want}) on {card}")
        require(got_l == want, f"{tag} launches {got_l}, expected {want}")
        require(sorted(res["done"]) == sorted(want_done)
                and res["err"] == ["reqBad"] and not os.listdir(q)
                and res["compute_dtype"] == "bfloat16"
                and res["static_renderers"] == (2 if static else 0),
                f"{tag}: done {res['done']}, err {res['err']}, queue "
                f"{os.listdir(q)}")
        require(os.path.exists(os.path.join(o, "reqBad.err")),
                f"{tag}: no reqBad.err")
        for req, n_f in want_done.items():
            frames = sorted(os.listdir(os.path.join(o, req)))
            require(open(os.path.join(o, req + ".done")).read() == str(n_f)
                    and frames == [f"{i:05d}.jpg" for i in range(n_f)],
                    f"{tag} {req}: {len(frames)} frames, expected {n_f}")
        img = image_io.imread_float(os.path.join(o, "reqW", "00000.jpg"))
        require(img.shape == (FACE, FACE, 3), f"{tag} frame {img.shape}")
        # one batch of the trained identity, on the server or the static
        # renderer that served it, against the plain path on its parameters
        if static:
            r = res["renderers"][0]
            t_idx = torch.arange(SERVE_B, dtype=torch.float32, device=dev)
            pair = (r(win_a[:SERVE_B], t_idx),
                    r.render_plain(win_a[:SERVE_B], t_idx))
            what = (f"crop {r.geo['ch']}x{r.geo['cw']}" if r.geo
                    else "full frame")
        else:
            srv = res["server"]
            b = frame_batch(res["bases"][0], win_a, 0, SERVE_B, dev)
            pair = (srv.render(0, b)["face"],
                    srv.render_plain(0, b)["face"])
            what = f"window {srv.window}"
        out[f"{tag}_err"] = check(
            f"{tag}: a served batch of {SERVE_B} ({what}), kernels vs plain "
            "path, bf16", [pair], SLICE_BF16_BOUND)
        out[tag] = got_l
        out[f"{tag}_fps"] = res["frames"] / res["seconds"]
        out[f"{tag}_render_fps"] = res["frames"] / res["render_seconds"]
        del res, pair
    # -- tools/bench_serving at its defaults, plain and --static ----------
    for static in (False, True):
        tag = "bench_serving_static" if static else "bench_serving"
        args = bench_serving.parse(["--static"] if static else [])
        reset()
        bench = bench_serving.build(args)
        rec = bench_serving.run(args, bench)
        torch.cuda.synchronize()
        got_l = counts()
        waves = args.identities * (args.rounds + 1)   # + the warm-up wave
        if static:
            crop = rec["static_crop"]
            ch, cw = (map(int, crop.split("x")) if crop
                      else (args.face, args.face))
            want = per_batch(waves, unet_k3(ch, cw))
            want["fused_block"] += args.identities * unet_k3(args.face,
                                                             args.face)
        else:
            want = per_batch(waves)
        log(f"# new audio: bench_serving{' --static' if static else ''} "
            f"{json.dumps(rec)}; launches {got_l} (expected {want}) on "
            f"{card}")
        require(got_l == want and rec["finite"]
                and rec["device"] == torch.cuda.get_device_name(0),
                f"{tag}: launches {got_l}, expected {want}")
        # identity 0's faces of the last timed wave against the plain path
        if static:
            r = bench.renderers[0]
            ref = r.render_plain(bench.audio[0], bench.t_idx)
            what = f"crop {rec['static_crop']}"
        else:
            ref = bench.server.render_plain(0, bench.batches[0])["face"]
            what = f"{args.face}x{args.face} frame"
        out[f"{tag}_err"] = check(
            f"{tag}: identity 0's wave of {args.batch} ({what}), kernels vs "
            "plain path, bf16", [(bench.outs[0], ref)], SLICE_BF16_BOUND)
        del bench, ref
        out[tag] = got_l
        out[f"{tag}_rec"] = rec

    # -- cli/infer --change_pose --export_video on phase 6's checkpoint ---
    cfg = load_config(identity)
    val_frames = cfg["data"]["val_split_frames"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for i in range(2):   # the second call is the timed one
            reset()
            res = cli_infer.main([identity, "--output_dir", "pose",
                                  "--batch", str(TRAIN_B), "--change_pose",
                                  "0.1", "--pose_edit", "euler",
                                  "--pose_axis", "1", "--export_video"])
            got_l = counts()
            n_b = -(-res["frames"] // TRAIN_B)
            want = {"fused_mlp": n_b, "window_sample": 0,
                    "fused_block": 5 * n_b}
            log(f"# new audio: cli/infer --change_pose call {i}: "
                f"{res['frames']} frames in {res['seconds']:.3f} s = "
                f"{res['frames'] / res['seconds']:.1f} frames/s (render "
                f"{res['frames'] / res['render_seconds']:.1f} frames/s), "
                f"{res['compute_dtype']}; launches {got_l} on {card}")
            require(got_l == want, f"cli/infer pose launches {got_l}, "
                    f"expected {want}")
        frames = sorted(os.listdir(res["out_dir"]))
        n_video = avi_video_frames(res["video"])
        sr, pcm = demux_avi_pcm(res["video"])
        log(f"# new audio: {res['video']} holds {n_video} frames and "
            f"{len(pcm)} samples at {sr} Hz")
        require(len(frames) == res["frames"] == val_frames == n_video
                and sr == 16000 and len(pcm) > 0
                and res["compute_dtype"] == "bfloat16",
                f"cli/infer pose: {len(frames)} frames, {n_video} in the "
                f"video, {len(pcm)} samples")
    finally:
        os.chdir(cwd)
    out["cli_infer_pose"] = got_l
    out["pose_fps"] = res["frames"] / res["seconds"]
    out["pose_render_fps"] = res["frames"] / res["render_seconds"]
    # the pose-edited batch on the renderer that was timed against the
    # plain path on its parameters, and the warp's splat on the card
    # against the CPU
    pe = res["renderer"]
    ds = LipDataset(cfg["data"]["path"], "val", cfg)
    host = stack_batch([ds.load_frame(i)
                        for i in range(min(TRAIN_B, len(ds)))])
    batch = to_device({k: host[k] for k in cli_infer._POSE_KEYS}, dev)
    out["pose_err"] = check(
        "pose-edited batch, kernels vs plain path, bf16",
        [(pe(batch, ds.lefttop_x, ds.lefttop_y)["face"],
          pe.render_plain(batch, ds.lefttop_x, ds.lefttop_y)["face"])],
        SLICE_BF16_BOUND)
    focal = pe.options["focal"]
    rel = pose_edit.edited_rel_pose(batch["canonical_euler"],
                                    batch["canonical_trans"], "euler", 1, 0.1)
    depth = pe.params[0]["canonical_depth"]
    img = batch["rgb_face_zero"].float() * (depth > 0)[..., None]
    flow, z = pose_edit.pose_flow(depth, rel, focal)
    s_card = splat.forward_splat_nearest(img, flow, z).cpu()
    s_cpu = splat.forward_splat_nearest(img.cpu(), flow.cpu(), z.cpu())
    require(torch.equal(s_card, s_cpu), "the splat on the card differs "
            "from the CPU's on the same flow and z")
    w_card = pose_edit.forward_warp_to_pose(batch["rgb_face_zero"], depth,
                                            rel, focal).cpu()
    w_cpu = pose_edit.forward_warp_to_pose(batch["rgb_face_zero"].cpu(),
                                           depth.cpu(), rel.cpu(), focal)
    share = float((w_card != w_cpu).any(-1).float().mean())
    out["pose_warp_share"] = share
    log(f"# new audio: splat on the card equals the CPU's on the same flow "
        f"and z ({tuple(flow.shape)}); the whole warp, card vs CPU, differs "
        f"at {share:.3%} of pixels (cap {POSE_WARP_SHARE:.0%})")
    require(share <= POSE_WARP_SHARE, "the pose warp on the card differs "
            "from the CPU's at too many pixels")
    return out


# the evaluation slice on phase 6's identity: the SyncNet teacher trained
# through cli/train_syncnet (the JAX package's heavy test's settings and
# bars), cli/evaluate of phase 6's rendered frames on the card against the
# CPU, and tools/convergence_run at May width
TEACHER_ARGS = ["--steps", "60", "--batch", "8", "--lr", "3e-4"]
# cli/evaluate, card vs CPU: (relative, absolute) bound per metric; the
# other keys must be equal
EVAL_BOUNDS = {"psnr": (1e-9, 0), "ssim": (1e-9, 0), "cpbd": (1e-9, 0),
               "lmd": (0, 1e-3), "sync_conf": (0, 1e-4)}
CONV_ARGS = ["--face", str(FACE), "--lip-h", str(LIP_H), "--lip-w",
             str(LIP_W), "--frames", "48", "--val-frames", "8", "--iters",
             "8", "--validate-every", "4", "--sync-start-iter", "4",
             "--pretrain-teacher", "60", "--batch", str(TRAIN_B), "--dtype",
             "bfloat16"]
EVAL_PATHS = ("convergence_fit", "convergence_infer")
# the JAX tool's report keys, in its order (tests/test_torch_convergence.py
# reads them from tools/convergence_run.py)
CONVERGENCE_KEYS = [
    "geometry", "iters", "batch", "compute_dtype", "train_seconds",
    "val_psnr_trajectory", "best_checkpoint_selected",
    "rendered_val_metrics", "backend", "sync_start_iter",
    "teacher_pretrain_steps", "teacher_bce_history", "presync_val_metrics",
    "postsync_val_metrics", "loss_sync_trajectory", "postsync_psnr_drop_db",
    "sync_conf_delta"]


def finite(x) -> bool:
    """Every number in a JSON-like tree is finite."""
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, list):
        return all(finite(v) for v in x)
    if isinstance(x, float):
        return x == x and abs(x) != float("inf")
    return True


def evaluation(dev, card: str, tmp: str, loop: dict) -> dict:
    """Phase 8 in the directory ``tmp`` on phase 6's identity and frames:
    8a cli/train_syncnet (the learning bars, the teacher's sync confidence
    on the ground-truth windows, unit-norm embeddings), 8b cli/evaluate
    --lms-from-fan --sync on the card and on the CPU, 8c
    tools/convergence_run with its launches by part.  Returns the launches
    by path and the timings."""
    import contextlib
    import os

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.cli import evaluate as cli_evaluate
    from speech2lip_tpu_torch.cli import train_syncnet as cli_train_syncnet
    from speech2lip_tpu_torch.config import load_config, save_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.models import syncnet
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.tools import convergence_run
    from speech2lip_tpu_torch.train import metrics_eval as me
    from speech2lip_tpu_torch.train.syncnet_pretrain import build_sync_arrays

    def reset():
        kmlp.launches = kws.launches = kfb.launches = 0
        khs.dsrc_launches = khs.dgrid_launches = 0

    def counts():
        return {"window_sample": kws.launches,
                "hat_sample_dsrc": khs.dsrc_launches,
                "hat_sample_dgrid": khs.dgrid_launches,
                "fused_mlp": kmlp.launches, "fused_block": kfb.launches}

    out = {}
    cfg = load_config(loop["identity"])

    # -- 8a: the teacher ------------------------------------------------------
    teacher = os.path.join(tmp, "syncnet_teacher.ckpt")
    windows, mels = build_sync_arrays(cfg)
    t0 = time.perf_counter()      # the build again, warm, as the CLI runs it
    build_sync_arrays(cfg)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = cli_train_syncnet.main([loop["identity"], "--out", teacher,
                                   *TEACHER_ARGS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = int(TEACHER_ARGS[1])
    out["teacher_ms_per_step"] = 1e3 * (wall - build_s) / steps
    out["teacher_wall_s"] = wall
    log(f"# evaluation: cli/train_syncnet {' '.join(TEACHER_ARGS)} on "
        f"{len(windows)} windows in {wall:.2f} s (the arrays' build "
        f"{build_s:.2f} s of it): {out['teacher_ms_per_step']:.1f} ms a "
        f"step, the first included; bce {[round(h, 4) for h in hist]} on "
        f"{card}")
    require(hist[-1] < hist[0] - 0.1 and hist[-1] < 0.55,
            f"the teacher did not learn: bce {hist}")
    tree = ckpt.load(teacher, like=weights.init_syncnet(0, dev))[0]
    with torch.no_grad():
        conf, offset = me.sync_confidence(*tree, torch.from_numpy(mels),
                                          torch.from_numpy(windows))
        a, v = syncnet.apply(*tree, torch.from_numpy(mels[:2]).to(dev)[
            ..., None], torch.from_numpy(windows[:2]).to(dev))
        ae, ve = me.embed(*tree, torch.from_numpy(mels),
                          torch.from_numpy(windows))
    near = [round(float((ve[max(0, -o):len(ve) - max(0, o)]
                         * ae[max(0, o):len(ae) - max(0, -o)]).sum(1).mean()),
                  4) for o in range(-3, 4)]
    norms = torch.cat([a.norm(dim=1), v.norm(dim=1)])
    log(f"# evaluation: teacher on the ground-truth windows: sync conf "
        f"{conf:.4f} at offset {offset} (mean cosine at offsets -3..3: "
        f"{near}); embedding norms {float(norms.min()):.6f}.."
        f"{float(norms.max()):.6f}")
    require(conf > 0.05 and offset == 0, f"the teacher does not separate "
            f"matched audio: conf {conf}, offset {offset}")
    require(bool(((norms - 1).abs() <= 1e-4).all()),
            "the teacher's embeddings are not unit-norm")
    out["teacher_bce"] = hist
    out["teacher_conf"] = conf

    # -- 8b: cli/evaluate of phase 6's frames, card vs CPU -------------------
    ecfg = dict(cfg, training=dict(cfg["training"], syncnet_weights=teacher))
    epath = os.path.join(tmp, "evaluate.yaml")
    save_config(epath, ecfg)
    n_train = len(os.listdir(os.path.join(cfg["data"]["path"],
                                          "ori_images_face"))) \
        - cfg["data"]["val_split_frames"]
    argv = ["--pred", loop["rendered"], "--gt",
            os.path.join(cfg["data"]["path"], "ori_images_face"),
            "--offset", str(n_train), "--lms-from-fan", "--sync",
            "--config", epath]
    res = {}
    for tag, extra in (("card", []), ("card", []), ("cpu",
                                                     ["--device", "cpu"])):
        t0 = time.perf_counter()
        res[tag] = cli_evaluate.main(argv + extra)
        dt = time.perf_counter() - t0
        out[f"evaluate_{tag}_fps"] = res[tag]["n_frames"] / dt
    for tag in ("card", "cpu"):
        log(f"# evaluation: cli/evaluate --lms-from-fan --sync on "
            f"{tag}: {res[tag]['n_frames']} frames at {FACE}^2, "
            f"{out[f'evaluate_{tag}_fps']:.2f} frames/s"
            f"{' (second call)' if tag == 'card' else ''}; "
            f"{json.dumps(res[tag])} on {card}")
    got, want = res["card"], res["cpu"]
    require(set(got) == set(want) and got["lmd_detector"] == "tiny"
            and got["n_frames"] == cfg["data"]["val_split_frames"],
            f"cli/evaluate keys {sorted(got)} vs {sorted(want)}")
    for k, w in want.items():
        g = got[k]
        if k in EVAL_BOUNDS:
            rel, ab = EVAL_BOUNDS[k]
            ok = abs(g - w) <= max(rel * abs(w), ab)
        else:
            ok = g == w
        require(ok, f"cli/evaluate {k}: card {g} vs cpu {w}")
    out["evaluate"] = got
    out["evaluate_err"] = {k: abs(got[k] - want[k]) for k in EVAL_BOUNDS}
    log(f"# evaluation: card vs CPU |diff| {out['evaluate_err']} (bounds "
        f"{EVAL_BOUNDS}, relative / absolute)")

    # -- 8c: tools/convergence_run at May width ------------------------------
    parts = {}

    @contextlib.contextmanager
    def part(name):
        torch.cuda.synchronize()
        reset()
        slot = {}
        t0 = time.perf_counter()
        yield slot
        torch.cuda.synchronize()
        parts[name] = {"s": time.perf_counter() - t0, "launches": counts(),
                       "result": slot.get("result")}

    conv_dir = os.path.join(tmp, "convergence")
    t0 = time.perf_counter()
    report = convergence_run.main(["--out", conv_dir, *CONV_ARGS],
                                  part=part)
    out["convergence_s"] = time.perf_counter() - t0
    for name, p in parts.items():
        log(f"# evaluation: convergence_run {name}: {p['s']:.2f} s, "
            f"launches {p['launches']} on {card}")
    conv_cfg = load_config(os.path.join(conv_dir, "config.yaml"))
    tr, val = conv_cfg["training"], conv_cfg["data"]["val_split_frames"]
    want = {"teacher": loop_launches(tr, [], val),
            "fit": loop_launches(tr, range(1, report["iters"] + 1), val)}
    n_batches = -(-val // TRAIN_B)
    for r in ("convergence", "conv_presync", "conv_postsync"):
        want[f"infer:{r}"] = {"window_sample": n_batches,
                              "hat_sample_dsrc": 0, "hat_sample_dgrid": 0,
                              "fused_mlp": n_batches,
                              "fused_block": 5 * n_batches}
        want[f"evaluate:{r}"] = loop_launches(tr, [], val)
    got = {k: p["launches"] for k, p in parts.items()}
    require(got == want, f"convergence_run launches {got}, expected {want}")
    require(finite(report) and report["best_checkpoint_selected"]
            and list(report) == CONVERGENCE_KEYS,
            f"convergence report: {json.dumps(report)[:2000]}")
    log(f"# evaluation: convergence_run report {json.dumps(report)}")
    out["convergence_fit"] = got["fit"]
    out["convergence_infer"] = {
        k: sum(got[f"infer:{r}"][k] for r in ("convergence", "conv_presync",
                                                "conv_postsync"))
        for k in got["fit"]}
    out["convergence_parts"] = {k: p["s"] for k, p in parts.items()}
    out["convergence_report"] = report
    return out


# preprocessing at full width: a Basel-sized synthetic 3DMM (34,650
# vertices, id 100 / exp 79 / tex 100) rendered at 500^2 at known poses,
# N frames (the reference's key-frame batch), seeded FAN (4 modules), DSFD
# (ResNet-152 depths), S3FD, BiSeNet and DeepSpeech at their published
# widths, every step through cli/preprocess on the card.  Cut in depth
# only: the tracker's budgets by PRE_TRACK_SCALE, find_focal to a
# 3-candidate grid at that scale
PRE_N, PRE_SIZE, PRE_FOCAL = 50, 500, 1000.0
PRE_TRACK_SCALE = 0.1
PRE_FOCAL_GRID = dict(lo=900, hi=1200, step=100)      # 900, 1000, 1100
# card vs CPU, float32 with TF32 off: the nets within 1e-4 of max|CPU|,
# the rasterizer's ids on >= 99.9% of pixels and bary / zbuf within 1e-5
# where they agree; the landmark phases' step-0 gradients within 1e-6
# relative, the parameters after 1 step of phase a and 20 of phase b within
# 1e-4 (phase a's lr-1 steps amplify rounding ~20x a step: logged)
PRE_NET_BOUND, PRE_RASTER_SHARE, PRE_RASTER_BOUND = 1e-4, 0.999, 1e-5
PRE_LMS_STEPS, PRE_LMS_BOUND, PRE_GRAD_BOUND = 20, 1e-4, 1e-6
PRE_PACK = {"id": (1, 100), "exp": (PRE_N, 79), "euler": (PRE_N, 3),
            "trans": (PRE_N, 3), "focal": (), "tex": (1, 100),
            "light": (PRE_N, 27)}


def kernel_launches() -> dict:
    """Every launch counter of the port's kernels."""
    from speech2lip_tpu_torch.ops.kernels import conv_block as kcb
    from speech2lip_tpu_torch.ops.kernels import conv_hcw as kch
    from speech2lip_tpu_torch.ops.kernels import dot_probe as kdp
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    return {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
            "fused_block": kfb.launches, "hat_sample_dsrc": khs.dsrc_launches,
            "hat_sample_dgrid": khs.dgrid_launches,
            "conv3x3_hcw": kch.conv3x3_launches,
            "double_conv_hcw": kch.double_conv_launches,
            "conv3x3_infer": kcb.launches, "dot_probe": kdp.launches}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def landmark_phases(assets, lms, device) -> dict:
    """The landmark phases' numbers one device gives, as numpy: the step-0
    gradients of phase a (pose from the tracker's start) and of phase b
    (all four from the start with id and exp at 0.01), the parameters
    after 1 and PRE_LMS_STEPS steps of phase a and after PRE_LMS_STEPS of
    phase b."""
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.preprocess import tracker as tt

    size, n = PRE_SIZE, lms.shape[0]
    tr = tt.FaceTracker(assets, lms, tt.TrackerConfig(img_h=size,
                                                      img_w=size),
                        device=device)
    p = tr._start(n)
    pb = dict(p, id=p["id"] + 0.01, exp=p["exp"] + 0.01)
    loss_a = lambda q: tr.landmark_loss(dict(p, **q), tr.lms, PRE_FOCAL)
    loss_b = lambda q: (tr.landmark_loss(q, tr.lms, PRE_FOCAL)
                        + 0.5 * torch.mean(q["id"] ** 2)
                        + 0.4 * torch.mean(q["exp"] ** 2))
    host = lambda ts: [t.detach().cpu().numpy() for t in ts]
    out = {}
    with tnn.full_float32():
        for tag, fn, start in (("a", loss_a, {k: p[k] for k in
                                               ("euler", "trans")}),
                               ("b", loss_b, pb)):
            q = {k: v.clone().requires_grad_(True) for k, v in start.items()}
            out[f"grad_{tag}"] = host(torch.autograd.grad(fn(q),
                                                          list(q.values())))
        opt_a, opt_b = tt.schedule(1.0, {1000: 0.1}), tt.schedule(
            0.1, {1000: 0.2})
        for tag, k in (("a1", 1), ("a20", PRE_LMS_STEPS)):
            got = tt.adam_loop(loss_a, {k_: p[k_] for k_ in ("euler",
                                                             "trans")},
                               {"euler": opt_a, "trans": opt_a}, k)
            out[tag] = {k_: v.cpu().numpy() for k_, v in got.items()}
        got = tt.adam_loop(loss_b, pb, {k_: opt_b for k_ in pb},
                           PRE_LMS_STEPS)
        out["b20"] = {k_: v.cpu().numpy() for k_, v in got.items()}
    return out


def preprocessing(dev, card: str, tmp: str) -> dict:
    """Phase 9 in the directory ``tmp``: 9a the world, 9b every step of
    cli/preprocess on the card, 9c the artifact contract, 9d the nets, the
    rasterizer and a landmark phase on the card against the CPU.  Returns
    the timings."""
    import os

    import cv2
    import numpy as np

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.cli import preprocess as cli_pre
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.models import bisenet, dsfd, fan, s3fd
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.ops.rasterize import rasterize
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess import synthetic_world as sw
    from speech2lip_tpu_torch.preprocess.landmarks import _crop_resize
    from speech2lip_tpu_torch.preprocess.tracker import (FaceTracker,
                                                         TrackerConfig)
    from speech2lip_tpu_torch.preprocess.video_io import write_avi

    out = {}
    cpu = torch.device("cpu")
    n, size = PRE_N, PRE_SIZE
    log(f"# preprocessing: cuts in depth only: {n} frames, tracker budgets "
        f"x{PRE_TRACK_SCALE} (--track_scale), find_focal on "
        f"{PRE_FOCAL_GRID}; widths, {size}^2 frames and the nets' depths as "
        "published")

    # -- 9a: the world ------------------------------------------------------
    t0 = time.perf_counter()
    assets = bfm.synthetic_assets(n_verts=34650, id_dim=100, exp_dim=79,
                                  tex_dim=100, seed=SEED, device=dev)
    assets_dir = os.path.join(tmp, "assets")
    bfm.save_reference_schema(assets, assets_dir)
    root = os.path.join(tmp, "identity")
    world = sw.make_raw_identity(root, assets, n, size, PRE_FOCAL)
    from scipy.io import wavfile
    sr, wav = wavfile.read(os.path.join(root, "audio", "audio.wav"))
    video = os.path.join(tmp, "clip.avi")
    write_avi(video, list(world["frames"]), fps=25.0, audio=wav,
              sample_rate=sr)
    wdir, wdir_s3fd = os.path.join(tmp, "w"), os.path.join(tmp, "w_s3fd")
    nets = {"fan": weights.random_fan(SEED, n_modules=4, device=dev),
            "dsfd": weights.random_dsfd(SEED + 1, device=dev),
            "s3fd": weights.random_s3fd(SEED + 2, device=dev),
            "bisenet": weights.random_bisenet(SEED + 3, device=dev)}
    for d, names in ((wdir, ("fan", "dsfd", "bisenet")),
                     (wdir_s3fd, ("fan", "s3fd"))):
        for name in names:
            tree = nets[name]
            ckpt.save(os.path.join(d, name + ".ckpt"), tree if name ==
                      "s3fd" else {"params": tree[0], "state": tree[1]})
    out["world_s"] = time.perf_counter() - t0
    log(f"# preprocessing: world ({assets.tris.shape[0]} faces, {n} frames "
        f"at {size}^2, focal {PRE_FOCAL}, max pixel "
        f"{int(world['frames'].max())}), the AVI and the weights in "
        f"{out['world_s']:.1f} s")

    # -- 9b: every step through cli/preprocess on the card -------------------
    base = ["--root", root, "--assets", assets_dir, "--crop_size", str(size),
            "--focal", str(PRE_FOCAL), "--track_scale", str(PRE_TRACK_SCALE)]
    summaries = {}
    before = kernel_launches()

    def run(tag, step, wd, *extra):
        t0 = time.perf_counter()
        s = cli_pre.main([step, "--weights_dir", wd, *base, *extra])
        torch.cuda.synchronize()
        s["wall_s"] = time.perf_counter() - t0
        summaries[tag] = s
        log(f"# preprocessing: cli/preprocess {step}"
            f"{' (' + tag + ')' if tag != step else ''}: "
            f"{s['wall_s']:.2f} s wall, {s['frames'][step]} frames, "
            f"{json.dumps({k: v for k, v in s.items() if k not in ('steps', 'frames')})} "
            f"on {card}")
        return s

    run("extract", "extract", wdir, "--video", video)
    require(len(os.listdir(os.path.join(root, "ori_images"))) == n,
            "extract: frame count")
    run("landmarks_dsfd", "landmarks", wdir)
    run("landmarks_s3fd", "landmarks", wdir_s3fd)
    sw.write_lms(root, world["lms"])   # random nets give arbitrary points
    for step in ("track", "warp", "uv_mapping", "masks", "crop_lip",
                 "audio_features"):
        run(step, step, wdir)
    require(kernel_launches() == before,
            "a port kernel launched on the preprocessing path")

    # -- 9c: the artifact contract -------------------------------------------
    def files(d, ext):
        return sorted(f for f in os.listdir(os.path.join(root, d))
                      if f.endswith(ext))
    require(len(files("warp_images", ".jpg")) == n, "warp_images count")
    coords = files("coords", ".npy")
    require(len(coords) == n, "coords count")
    for f in coords:
        c = np.load(os.path.join(root, "coords", f))
        require(c.shape == (size, size, 2) and np.isfinite(c).all()
                and np.abs(c).max() <= 1.0, f"coords {f}")
    depth = np.load(os.path.join(root, "depth_face_canonical.npy"))
    require(depth.shape == (size, size) and np.isfinite(depth).all()
            and (depth > 0).any(), "depth_face_canonical")
    for name in ("canonical_face_mask.jpg", "canonical_head_mask.jpg",
                 "canonical_lip_mask.jpg", "canonical_face_parsing.jpg"):
        img = cv2.imread(os.path.join(root, name))
        require(img is not None and img.shape[:2] == (size, size), name)
    lips = files("images", ".jpg")
    require(len(lips) == n and all(cv2.imread(os.path.join(
        root, "images", f)).shape == (LIP_H, LIP_W, 3) for f in lips),
        "lip crops")
    track = dict(np.load(os.path.join(root, "track_params.pt.npz")))
    require(set(track) == set(PRE_PACK) and all(
        track[k].shape == s and np.isfinite(track[k]).all()
        for k, s in PRE_PACK.items()), f"track_params keys / shapes "
        f"{ {k: v.shape for k, v in track.items()} }")
    aud = np.load(os.path.join(root, "audio", "audio.npy"))
    require(aud.ndim == 3 and aud.shape[1:] == (16, 29)
            and np.isfinite(aud).all(), f"audio.npy {aud.shape}")
    bbox = np.load(os.path.join(root, "face_bbox_dict.npy"),
                   allow_pickle=True).item()
    require(len(bbox) == n and all(v.shape == (5,) for v in bbox.values()),
            "face_bbox_dict rows")
    lms_files = files("landmarks", ".lms")
    require(len(lms_files) == n, "landmarks count")
    log(f"# preprocessing: artifacts at {size}^2: {n} warp_images, coords "
        f"[{size}, {size}, 2] |c| <= 1, depth + 3 masks + parsing, {n} lip "
        f"crops {LIP_W}x{LIP_H}, track_params "
        f"{ {k: v.shape for k, v in track.items()} }, audio.npy "
        f"{aud.shape}, face_bbox_dict rows of 5 (S3FD run: e.g. "
        f"{bbox['00001.jpg'].tolist()})")

    # the landmark phases at the CLI's budgets: the loss must fall
    ts = PRE_TRACK_SCALE
    cfg = TrackerConfig(img_h=size, img_w=size,
                        iters_pose=max(1, int(1500 * ts)),
                        iters_idexp=max(1, int(2000 * ts)))
    tr = FaceTracker(assets, world["lms"], cfg, device=dev)
    with tnn.full_float32():
        lms_fit = tr.fit(PRE_FOCAL)
        start = {k: v.to(dev) for k, v in tr._start(n).items()}
        fitted = {k: torch.as_tensor(lms_fit[k], device=dev)
                  for k in start}
        loss0 = float(tr.landmark_loss(start, tr.lms, PRE_FOCAL))
        loss1 = float(tr.landmark_loss(fitted, tr.lms, PRE_FOCAL))
    log(f"# preprocessing: landmark loss {loss0:.4f} at the start, "
        f"{loss1:.4f} after phases a/b ({cfg.iters_pose} + "
        f"{cfg.iters_idexp} steps)")
    require(loss1 < loss0, "the landmark phases did not lower the loss")
    t0 = time.perf_counter()
    with tnn.full_float32():
        focal = FaceTracker(assets, world["lms"], TrackerConfig(
            img_h=size, img_w=size,
            iters_focal_pose=max(1, int(2000 * ts)),
            iters_focal_idexp=max(1, int(2500 * ts))),
            device=dev).find_focal(**PRE_FOCAL_GRID)
    torch.cuda.synchronize()
    out["find_focal_s"] = time.perf_counter() - t0
    log(f"# preprocessing: find_focal on {PRE_FOCAL_GRID}: {focal} (true "
        f"{PRE_FOCAL}) in {out['find_focal_s']:.2f} s on {card}")
    require(focal in (900.0, 1000.0, 1100.0), f"find_focal gave {focal}")

    # -- 9d: card against the CPU, float32 with TF32 off ---------------------
    truth = {k: torch.as_tensor(v, device=dev)
             for k, v in world["truth"].items()}
    with torch.no_grad():
        geo = bfm.forward_geo(assets, truth["id"], truth["exp"][:1])
        rott = bfm.rot_trans_pts(geo, bfm.euler2rot(truth["euler"][:1]),
                                 truth["trans"][:1])
        pix = bfm.camera_pixels(rott, PRE_FOCAL, size, size)[0]
    frags = {}
    for d in (dev, cpu):
        t0 = time.perf_counter()
        frags[d.type] = rasterize(pix.to(d), assets.tris.to(d), size, size)
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[f"raster_{d.type}_ms"] = 1e3 * (time.perf_counter() - t0)
    fc, fp = frags["cuda"], frags["cpu"]
    same = (fc.pix_to_face.cpu() == fp.pix_to_face)
    hit = same & torch.isfinite(fp.zbuf)
    bary_err = float((fc.bary.cpu() - fp.bary)[same].abs().max())
    z_err = float((fc.zbuf.cpu() - fp.zbuf)[hit].abs().max())
    out["overflow"] = int(fc.overflow)
    log(f"# preprocessing: rasterize one {size}^2 frame "
        f"({assets.tris.shape[0]} faces, tile 16, K 128): card "
        f"{out['raster_cuda_ms']:.1f} ms, CPU {out['raster_cpu_ms']:.1f} "
        f"ms; ids equal on {float(same.float().mean()):.6f} of pixels, "
        f"bary {bary_err:.3g}, zbuf {z_err:.3g} where equal; overflow card "
        f"{int(fc.overflow)} CPU {int(fp.overflow)} (dropped (tile, face) "
        f"pairs at the tracker's default raster settings)")
    require(float(same.float().mean()) >= PRE_RASTER_SHARE
            and bary_err <= PRE_RASTER_BOUND and z_err <= PRE_RASTER_BOUND
            and int(fc.overflow) == int(fp.overflow),
            "rasterize: card vs CPU")

    frame = torch.as_tensor(world["frames"][0].astype(np.float32),
                            device=dev)
    crop = torch.as_tensor(_crop_resize(world["frames"][0].astype(
        np.float32) / 255.0, (0, 0, size, size))[0], device=dev)
    cases = {
        "fan": (lambda p, x: fan.apply(*p, x), nets["fan"], crop[None]),
        "s3fd": (lambda p, x: [t for pair in s3fd.apply(p, x) for t in pair],
                 nets["s3fd"], frame[None]),
        "dsfd": (lambda p, x: [t for pair in dsfd.apply(*p, x)
                               for t in pair], nets["dsfd"], frame[None]),
        "bisenet": (lambda p, x: [bisenet.apply(*p, x)], nets["bisenet"],
                    tnn.resize_linear(frame[None] / 255.0, 512, 512))}
    out["nets"] = {}
    for name, (fn, params, x) in cases.items():
        with torch.no_grad(), tnn.full_float32():
            got = fn(params, x)
            ms = cuda_ms(lambda: fn(params, x), iters=3, warmup=1)
            pc, xc = tree_to(params, cpu), x.cpu()
            t0 = time.perf_counter()
            want = fn(pc, xc)
            cpu_ms = 1e3 * (time.perf_counter() - t0)
        # each output against its own largest magnitude
        ratio = max(float((g.cpu() - w).abs().max())
                    / max(float(w.abs().max()), 1e-30)
                    for g, w in zip(got, want))
        out["nets"][name] = {"ms": ms, "cpu_ms": cpu_ms, "rel_err": ratio}
        log(f"# preprocessing: {name} forward on {tuple(x.shape)}: card "
            f"{ms:.2f} ms, CPU {cpu_ms:.1f} ms; max|card - CPU| / max|CPU| "
            f"{ratio:.3g} over its {len(want)} outputs (bound "
            f"{PRE_NET_BOUND}) on {card}")
        require(ratio <= PRE_NET_BOUND, f"{name}: card vs CPU")

    lm = {d.type: landmark_phases(bfm.assets_to(assets, d), world["lms"],
                                  d) for d in (dev, cpu)}
    c, h = lm["cuda"], lm["cpu"]
    rel = lambda a, b: max(float(np.abs(x - y).max() / np.abs(y).max())
                           for x, y in zip(a, b))
    diff = lambda a, b: max(float(np.abs(a[k] - b[k]).max()) for k in b)
    out["lms_grad0"] = max(rel(c["grad_a"], h["grad_a"]),
                           rel(c["grad_b"], h["grad_b"]))
    out["lms_a1"], out["lms_b20"] = diff(c["a1"], h["a1"]), diff(c["b20"],
                                                                 h["b20"])
    out["lms_a20"] = diff(c["a20"], h["a20"])
    log(f"# preprocessing: landmark phases at full width ({n} frames), card "
        f"vs CPU: step-0 gradients of phases a and b {out['lms_grad0']:.3g} "
        f"relative (bound {PRE_GRAD_BOUND}); parameters after 1 step of "
        f"phase a {out['lms_a1']:.3g}, after {PRE_LMS_STEPS} steps of "
        f"phase b {out['lms_b20']:.3g} (bound {PRE_LMS_BOUND}); after "
        f"{PRE_LMS_STEPS} steps of phase a {out['lms_a20']:.3g}, logged: its "
        "lr-1 Adam steps of ~1 rad amplify float32 rounding ~20x a step")
    require(out["lms_grad0"] <= PRE_GRAD_BOUND
            and out["lms_a1"] <= PRE_LMS_BOUND
            and out["lms_b20"] <= PRE_LMS_BOUND,
            "landmark phases: card vs CPU")

    # -- 9e: rates ------------------------------------------------------------
    tt = summaries["track"]["track_timings"]
    out["summaries"] = summaries
    out["lms_step_ms"] = 1e3 * tt["phase_a_pose"] / max(1, int(1500 * ts))
    out["photo_iter_ms"] = 1e3 * tt["phase_c_photometric"] / max(
        1, int(71 * ts))
    out["landmarks_fps"] = n / summaries["landmarks_dsfd"]["seconds"][
        "landmarks"]
    out["landmarks_s3fd_fps"] = n / summaries["landmarks_s3fd"]["seconds"][
        "landmarks"]
    out["warp_fps"] = n / summaries["warp"]["seconds"]["warp"]
    return out


# the user's tools: the reference's weight files at published widths
# (synthesized from seeds, in their names and blob layouts) through
# tools/convert_weights, the raw-video-to-score pipeline at May width, and
# the training and per-stage benches.  Cut in depth only: the pipeline's
# frames, iterations and tracker budgets; its world's 3DMM has the Basel
# model's 34,650 vertices (phase 9's), with the tool's 8 identity and 6
# expression components
PIPE_ARGS = ["--crop", str(FACE), "--lip-w", str(LIP_W), "--lip-h",
             str(LIP_H), "--verts", "34650", "--dtype", "bfloat16",
             "--batch", str(TRAIN_B), "--track-scale", "0.05", "--frames",
             "24", "--val-frames", "8", "--iters", "4", "--validate-every",
             "2"]
# the JAX tool's report keys, in its order (as the committed PIPELINE.json)
PIPELINE_KEYS = [
    "pipeline", "geometry", "iters", "compute_dtype", "phase_seconds",
    "total_seconds", "focal_true", "focal_found", "val_psnr_trajectory",
    "best_checkpoint_selected", "rendered_val_metrics", "backend"]
# i.i.d. noise through the converted DSFD (ResNet-152) against a float64
# forward on the CPU: the card's float32 may be no farther from float64
# than this many times the CPU's float32 is, were a card-vs-CPU gap there
# float32 rounding and not a fault of the card path
DSFD_F64_FACTOR = 4.0
TOOLS_PATHS = ("pipeline_fit", "pipeline_infer", "bench_train",
               "bench_components")
# K2 / dsrc / dgrid launches a train step: stage 1 and the sync stage
STEP_LAUNCHES = {False: (2, 1, 1), True: (3, 2, 1)}


def tree_f64(tree):
    """The tree with its floating tensors in float64."""
    if isinstance(tree, dict):
        return {k: tree_f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_f64(v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def tree_equal(a, b) -> bool:
    """Two checkpoint trees hold the same leaves bit for bit."""
    import numpy as np

    from speech2lip_tpu_torch.core.checkpoint import flatten
    fa, fb = flatten(a), flatten(b)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k])
        for k in fa)


def user_tools(dev, card: str, tmp: str) -> dict:
    """Phase 10 in the directory ``tmp``: 10a the reference's weight files
    through tools/convert_weights, each converted net on the card against
    the CPU and a Renderer batch of the converted talking face against the
    plain path; 10b tools/full_pipeline_run at May width with its launches
    by part and a cli/infer batch of the trained identity against the plain
    path; 10c tools/bench_train and tools/bench_components.  Returns the
    launches by path and the timings."""
    import contextlib
    import math
    import os

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config, load_config
    from speech2lip_tpu_torch.core import checkpoint as ckpt
    from speech2lip_tpu_torch.data.dataset import LipDataset, stack_batch
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.pipeline import RENDER_KEYS
    from speech2lip_tpu_torch.infer.renderer import (Renderer,
                                                     render_face_batch)
    from speech2lip_tpu_torch.models import (bisenet, deepspeech, dsfd, fan,
                                             lpips, s3fd, syncnet)
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.tools import bench_components, bench_train
    from speech2lip_tpu_torch.tools import convert_weights as cw
    from speech2lip_tpu_torch.tools import full_pipeline_run
    from speech2lip_tpu_torch.tools import reference_weights as rw
    from speech2lip_tpu_torch.train.trainer import to_device

    cpu = torch.device("cpu")
    out = {}
    names = ("window_sample", "hat_sample_dsrc", "hat_sample_dgrid",
             "fused_mlp", "fused_block")

    def counts():
        k = kernel_launches()
        return {n: k[n] for n in names}

    def reset():
        from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
        from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
        from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
        from speech2lip_tpu_torch.ops.kernels import window_sample as kws
        kmlp.launches = kws.launches = kfb.launches = 0
        khs.dsrc_launches = khs.dgrid_launches = 0

    # -- 10a: the reference's files through tools/convert_weights ------------
    t0 = time.perf_counter()
    trees = rw.reference_trees(SEED)
    src, conv = os.path.join(tmp, "reference"), os.path.join(tmp, "models")
    files = rw.write_reference_files(src, trees)
    out["weights_synth_s"] = time.perf_counter() - t0
    sizes = {k: os.path.getsize(v) / 2**20 for k, v in files.items()}
    log(f"# user tools: the reference's files at published widths in "
        f"{out['weights_synth_s']:.1f} s, MiB: "
        + ", ".join(f"{os.path.basename(v)} {sizes[k]:.1f}"
                    for k, v in files.items()))
    t0 = time.perf_counter()
    found = cw.main(["--all", src, conv])
    ds_out = os.path.join(conv, "deepspeech.ckpt")
    cw.main(["deepspeech", files["deepspeech"], ds_out])
    out["convert_s"] = time.perf_counter() - t0
    want_files = {k: os.path.join(conv, v[0] if k != "talking_face"
                                  else "talking_face.ckpt")
                  for k, v in cw.ALL_ARTIFACTS.items() if k != "deepspeech"}
    require(found == want_files, f"convert --all found {found}")
    log(f"# user tools: convert_weights --all ({len(found)} kinds; the "
        f".npz DeepSpeech by its positional form, --all globs .pb only) in "
        f"{out['convert_s']:.1f} s")
    conv_trees = {k: ckpt.load_nested(p)[0] for k, p in found.items()}
    conv_trees["deepspeech"] = ckpt.load_nested(ds_out)[0]
    unet = ckpt.load_nested(os.path.join(conv, "unet.ckpt"))[0]
    expect = dict(trees, talking_face=trees["talking_face"][0])
    for kind in ("bisenet", "fan", "dsfd"):
        expect[kind] = {"params": trees[kind][0], "state": trees[kind][1]}
    for kind, tree in conv_trees.items():
        require(tree_equal(tree, expect[kind]),
                f"convert_weights {kind}: the file differs from the tree")
    require(tree_equal(unet, {"params": trees["talking_face"][1],
                              "state": trees["talking_face"][2]}),
            "convert_weights: unet.ckpt differs from the tree")
    log("# user tools: every converted file equals its synthesized tree "
        "bit for bit")

    gen = torch.Generator().manual_seed(SEED)
    rand = lambda *s, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(
        *s, generator=gen)

    def image(size, hi):
        """A smooth image in [0, hi] (a lit ellipse on a shaded ground),
        the kind of input the detectors see, as phase 9's frames (i.i.d.
        noise is held against float64 below)"""
        yy, xx = torch.meshgrid(torch.linspace(-1, 1, size),
                                torch.linspace(-1, 1, size), indexing="ij")
        ph = 6.28 * torch.rand(3, generator=gen)
        ground = 0.3 + 0.1 * torch.sin(3 * xx[..., None] + ph) * torch.cos(
            2 * yy[..., None])
        face = ((xx / 0.45) ** 2 + (yy / 0.6) ** 2 < 1).float()[..., None]
        shade = 0.55 + 0.3 * torch.cos(2.5 * xx + 1.0)[..., None] \
            * torch.tensor([1.0, 0.8, 0.7])
        return (hi * (ground * (1 - face) + shade * face)).clamp(0, hi)[None]
    nets = {
        "fan": (lambda d: weights.fan_from_jax(
            conv_trees["fan"]["params"], conv_trees["fan"]["state"], d),
            lambda p, x: fan.apply(*p, x), image(256, 1.0)),
        "s3fd": (lambda d: weights.s3fd_from_jax(conv_trees["s3fd"], d),
                 lambda p, x: [t for pair in s3fd.apply(p, x) for t in pair],
                 image(FACE, 255.0)),
        "dsfd": (lambda d: weights.dsfd_from_jax(
            conv_trees["dsfd"]["params"], conv_trees["dsfd"]["state"], d),
            lambda p, x: [t for pair in dsfd.apply(*p, x) for t in pair],
            image(FACE, 255.0)),
        "bisenet": (lambda d: weights.bisenet_from_jax(
            conv_trees["bisenet"]["params"], conv_trees["bisenet"]["state"],
            d), lambda p, x: [bisenet.apply(*p, x)], image(512, 1.0)),
        "syncnet": (lambda d: weights.syncnet_from_jax(
            *conv_trees["syncnet"], d),
            lambda p, x: list(syncnet.apply(*p, x[0], x[1])),
            (rand(2, 80, 16, 1, lo=-4.0), rand(2, 48, 96, 15))),
        "lpips": (lambda d: weights.lpips_from_jax(conv_trees["lpips"], d),
                  lambda p, x: [lpips.lpips_distance(p, x[0], x[1])],
                  (rand(2, 64, 64, 3, lo=-1.0), rand(2, 64, 64, 3, lo=-1.0))),
        "deepspeech": (lambda d: weights.deepspeech_from_jax(
            conv_trees["deepspeech"], d),
            lambda p, x: [deepspeech.apply(p, x)], rand(32, 494, lo=-1.0)),
    }
    to = lambda x, d: (tuple(t.to(d) for t in x) if isinstance(x, tuple)
                       else x.to(d))
    out["nets"] = {}
    for name, (load, fn, x) in nets.items():
        with torch.no_grad(), tnn.full_float32():
            got = fn(load(dev), to(x, dev))
            want = fn(load(cpu), x)
        ratio = max(float((g.cpu() - w).abs().max())
                    / max(float(w.abs().max()), 1e-30)
                    for g, w in zip(got, want))
        out["nets"][name] = ratio
        log(f"# user tools: converted {name} forward, card vs CPU: "
            f"max|diff| / max|CPU| {ratio:.3g} over its {len(want)} outputs "
            f"(bound {PRE_NET_BOUND})")
        require(ratio <= PRE_NET_BOUND and all(
            bool(torch.isfinite(g).all()) for g in got),
            f"converted {name}: card vs CPU")

    # i.i.d. noise in [0, 255] through the converted DSFD (the input that
    # gave 3.58e-4 card vs CPU in one run, against 2.6e-5 on phase 9's
    # rendered frame): the card's and the CPU's float32 against a float64
    # forward on the CPU
    load, fn, _ = nets["dsfd"]
    noise = rand(1, FACE, FACE, 3, hi=255.0)
    with torch.no_grad(), tnn.full_float32():
        card32 = fn(load(dev), noise.to(dev))
        cpu32 = fn(load(cpu), noise)
        ref64 = fn(tree_f64(load(cpu)), noise.double())

    def rel(got, want):
        return max(float((g.cpu().double() - w.double()).abs().max())
                   / max(float(w.abs().max()), 1e-300)
                   for g, w in zip(got, want))
    w64 = out["dsfd_noise_f64"] = {
        "card_vs_cpu": rel(card32, cpu32), "card_vs_f64": rel(card32, ref64),
        "cpu_vs_f64": rel(cpu32, ref64)}
    log(f"# user tools: converted dsfd on i.i.d. noise {tuple(noise.shape)}"
        f", max|diff| / max|ref| over its {len(ref64)} outputs: card vs "
        f"CPU {w64['card_vs_cpu']:.3g}; against float64 on the CPU: card "
        f"float32 {w64['card_vs_f64']:.3g}, CPU float32 "
        f"{w64['cpu_vs_f64']:.3g} (the card within {DSFD_F64_FACTOR}x the "
        f"CPU's) on {card}")
    require(all(bool(torch.isfinite(g).all()) for g in card32)
            and w64["card_vs_f64"] <= DSFD_F64_FACTOR * w64["cpu_vs_f64"],
            "converted dsfd on noise: the card is farther from float64 "
            "than float32 rounding on the CPU")
    del card32, cpu32, ref64

    # the converted talking face + U-Net: one Renderer batch vs plain
    tcfg = default_config()
    tcfg["data"].update(height=LIP_H, width=LIP_W)
    tcfg["model"].update(compute_dtype="bfloat16",
                         canonical_depth_height=FACE,
                         canonical_depth_width=FACE)
    p, up, us = weights.from_jax(conv_trees["talking_face"],
                                 unet["params"], unet["state"], device=dev)
    raw, geo = synthetic_batch(TRAIN_B, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               seed=SEED + 5)
    box = tf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    win = compute_warp_window([raw["coord"][i] for i in range(TRAIN_B)],
                              box, FACE, FACE, margin=MARGIN)
    rnd = Renderer(tcfg, p, up, us, device=dev, window=win)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    reset()
    got = rnd(batch, geo["lip_x"], geo["lip_y"])
    torch.cuda.synchronize()
    n = counts()
    ref = render_face_batch(*rnd.params, batch, lip_x=geo["lip_x"],
                            lip_y=geo["lip_y"], lip_h=LIP_H, lip_w=LIP_W,
                            use_kernels=False, compute_dtype=torch.bfloat16,
                            window=win)
    out["converted_render_err"] = check(
        "converted talking face, Renderer batch of 8",
        [(got["face"], ref["face"]), (got["lip"], ref["lip"])],
        SLICE_BF16_BOUND)
    require((n["fused_mlp"], n["window_sample"], n["fused_block"])
            == (1, 1, 5), f"converted Renderer launches {n}")
    del trees, conv_trees, nets, rnd, batch, got, ref

    # -- 10b: tools/full_pipeline_run at May width ----------------------------
    parts = {}

    @contextlib.contextmanager
    def part(name):
        torch.cuda.synchronize()
        reset()
        slot = {}
        t0 = time.perf_counter()
        yield slot
        torch.cuda.synchronize()
        parts[name] = {"s": time.perf_counter() - t0, "launches": counts(),
                       "result": slot.get("result")}

    pipe = os.path.join(tmp, "pipeline")
    t0 = time.perf_counter()
    report = full_pipeline_run.main(["--out", pipe, *PIPE_ARGS], part=part)
    out["pipeline_s"] = time.perf_counter() - t0
    for name, pt in parts.items():
        log(f"# user tools: full_pipeline_run {name}: {pt['s']:.2f} s, "
            f"launches {pt['launches']} on {card}")
    pcfg = load_config(os.path.join(pipe, "config.yaml"))
    tr, val = pcfg["training"], pcfg["data"]["val_split_frames"]
    zero = loop_launches(tr, [], val)
    n_batches = -(-val // TRAIN_B)
    want = {name: zero for name in parts}
    want["train"] = loop_launches(tr, range(1, report["iters"] + 1), val)
    want["infer"] = {"window_sample": n_batches, "hat_sample_dsrc": 0,
                     "hat_sample_dgrid": 0, "fused_mlp": n_batches,
                     "fused_block": 5 * n_batches}
    got = {k: pt["launches"] for k, pt in parts.items()}
    steps = ["synthesize_world", "extract", "crop_face", "landmarks",
             "track", "warp", "uv_mapping", "masks", "crop_lip",
             "audio_features", "train", "infer", "evaluate"]
    require(list(parts) == steps, f"pipeline parts {list(parts)}")
    require(got == want, f"full_pipeline_run launches {got}, expected "
            f"{want}")
    metrics = report["rendered_val_metrics"]
    require(list(report) == PIPELINE_KEYS and finite(report)
            and report["best_checkpoint_selected"]
            and len(report["pipeline"]) == 13
            and set(report["phase_seconds"]) == set(steps[:-1])
            and metrics["n_frames"] == val == len(os.listdir(os.path.join(
                pipe, "rendering_result", "pipeline", "postfusion")))
            and all(math.isfinite(v) for v in metrics.values()),
            f"pipeline report: {json.dumps(report)[:2000]}")
    log(f"# user tools: pipeline report {json.dumps(report)}")
    log(f"# user tools: focal found {report['focal_found']} against the "
        f"true {report['focal_true']} (grid 600..1500, --track-scale "
        f"{PIPE_ARGS[PIPE_ARGS.index('--track-scale') + 1]})")
    out["pipeline_fit"], out["pipeline_infer"] = got["train"], got["infer"]
    out["pipeline_parts"] = {k: pt["s"] for k, pt in parts.items()}
    out["pipeline_report"] = report
    with open(os.path.join(pcfg["training"]["out_dir"],
                           "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    split = [(r["train/batch_ms"], r["train/step_ms"]) for r in recs
             if "train/step_ms" in r]
    out["pipeline_fit_ms"] = [b + st for b, st in split]
    log(f"# user tools: pipeline fit ms an iteration = batch build + step "
        f"(metrics.jsonl): " + ", ".join(
            f"{b + st:.1f} = {b:.1f} + {st:.1f}" for b, st in split)
        + f" on {card}")

    # cli/infer's first batch on the renderer that rendered and was timed
    # (model_best.ckpt) against the plain path on its parameters
    rnd = parts["infer"]["result"]["renderer"]
    require(rnd.compute_dtype == torch.bfloat16,
            f"pipeline cli/infer renderer {rnd.compute_dtype}")
    ds = LipDataset(pcfg["data"]["path"], "val", pcfg)
    host = stack_batch([ds.load_frame(i) for i in range(min(TRAIN_B,
                                                            len(ds)))])
    batch = to_device({k: host[k] for k in RENDER_KEYS}, dev)
    got = rnd(batch, ds.lefttop_x, ds.lefttop_y)
    ref = render_face_batch(*rnd.params, batch, lip_x=ds.lefttop_x,
                            lip_y=ds.lefttop_y, lip_h=rnd.lip_h,
                            lip_w=rnd.lip_w,
                            expand_divisor=rnd.expand_divisor,
                            use_kernels=False,
                            compute_dtype=rnd.compute_dtype,
                            window=rnd.window)
    out["pipeline_infer_err"] = check(
        "pipeline cli/infer's renderer (model_best.ckpt), its first batch",
        [(got["face"], ref["face"]), (got["lip"], ref["lip"])],
        SLICE_BF16_BOUND)
    del rnd, batch, got, ref, parts

    # -- 10c: the benches ------------------------------------------------------
    reset()
    t0 = time.perf_counter()
    rows = bench_train.main([])
    out["bench_train_s"] = time.perf_counter() - t0
    out["bench_train"] = rows
    for r in rows:
        if r.get("error"):
            log(f"# user tools: bench_train {r['case']} {r['dtype']}: "
                f"{r['error']} on {card}")
            continue
        n = r["launches"]
        require(math.isfinite(r["ms_per_step"]) and math.isfinite(r["loss"])
                and (n["window_sample"], n["hat_sample_dsrc"],
                     n["hat_sample_dgrid"])
                == STEP_LAUNCHES[r["case"].startswith("sync")],
                f"bench_train row {r}")
    require(len(rows) == 6 and all(not r.get("error") for r in rows
                                   if r["dtype"] == "bfloat16"),
            f"bench_train rows {rows}")
    out["bench_train_launches"] = counts()
    t0 = time.perf_counter()
    bench = bench_components.build(dev)
    comp = bench_components.run(bench)
    out["bench_components_s"] = time.perf_counter() - t0
    out["bench_components"] = comp
    want = {"full render": (1, 1, 5), "lip MLP": (1, 0, 0),
            "composite": (0, 1, 0), "U-Net": (0, 0, 5),
            "U-Net plain": (0, 0, 0)}
    totals = dict.fromkeys(names, 0)
    for name, (kern, plain) in bench.stages.items():
        n = comp[name]["launches"]
        require((n["fused_mlp"], n["window_sample"], n["fused_block"])
                == want[name], f"bench_components {name} launches {n}")
        for k, v in n.items():
            totals[k] += v
        if plain is None:       # the plain U-Net: a timing row only
            continue
        with torch.no_grad():
            g, w = kern(), plain()
        comp[name]["err"] = check(f"bench_components {name}", [(g, w)],
                                  UNET_BF16_BOUND)
    out["bench_components_launches"] = totals
    del bench
    return out


# training across processes (phase 11): fit with torch's default TF32
# flags against the CPU; fit under a one-rank NCCL group (a
# torch.distributed.run child) against fit with no group, bit for bit; two
# gloo ranks sharing the card against one rank on the global batch;
# sharded checkpoints; MultiSpeakerServer(mesh=) at one rank.  Each child
# is this script again (``--rank-job SPEC``), on a learnable identity at
# May geometry; the card-vs-CPU fit runs on a small one
PAR_FRAMES, PAR_ITERS, PAR_B = 20, 3, 2
PAR_TRAINING = {"batch_size": PAR_B, "print_every": 1,
                "checkpoint_every": 1, "backup_every": 0,
                "validate_every": PAR_ITERS, "visualize_every": 0,
                "use_syncloss": False, "use_local_ensemble": False,
                "add_noise_uv": False, "add_noise_audio": False}
# two ranks against one rank on the global batch: float32 sums in another
# order (the CPU tests' bounds, tests/test_torch_parallel.py): a step, and
# fit's first iteration, within 1e-5; later iterations within 1e-3, as
# Adam's first step moves a noise-level gradient element by a whole lr
# whatever its last bits, and the next gradients carry that.  On the card
# each side of fit's first iteration is held to a float64 fit of the same
# batch (``Float64``), not to the other: the train step lets cuDNN time
# its conv algorithms, so the two sides' convs may round otherwise, and
# grad_norm lies up to 8.0e-6 from float64 on one side and 2.5e-6 on the
# other, 1.05e-5 apart (H100)
PAR_BOUND, PAR_LATER_BOUND = 1e-5, 1e-3
# the values of metrics.jsonl that the bit-for-bit comparison reads: every
# one but the wall clock and the host timings
PAR_TIMING_KEYS = ("t", "train/batch_ms", "train/step_ms")


class Float64(torch.overrides.TorchFunctionMode):
    """Float32 code run in float64: every float32 tensor or dtype that a
    torch function takes or returns is made float64 (a tensor changed in
    place keeps its dtype).  The witness that phase 11c holds each float32
    side of a comparison to.  The port's kernels take no float64: run it
    on the plain path."""

    @staticmethod
    def _up(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.double()
        if x is torch.float32:
            return torch.float64
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(Float64._up(v) for v in x)
        if isinstance(x, dict):
            return {k: Float64._up(v) for k, v in x.items()}
        return x

    def __torch_function__(self, func, types, args=(), kwargs=None):
        up = self._up
        if func is torch.Tensor.float:
            return args[0].double()
        name = getattr(func, "__name__", "")
        inplace = (name.endswith("_") and not name.endswith("__")) or (
            name in ("__setitem__", "__iadd__", "__isub__", "__imul__",
                     "__itruediv__"))
        args = (args[:1] if inplace else up(args[:1])) + up(args[1:])
        out = func(*args, **up(kwargs or {}))
        return out if inplace or not isinstance(
            out, (torch.Tensor, list, tuple)) else up(out)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall_ms(fn, dev, iters: int = 20) -> float:
    """Mean wall ms of ``fn()`` over ``iters`` calls after one, the device
    synchronised around them."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return 1e3 * (time.perf_counter() - t0) / iters


def _rank_fit(cfg, iters, dev, counters):
    """fit on ``dev`` with the launch counters zeroed before and read
    after; returns (state, launches, the step's gradient all-reduce ms,
    one a step)."""
    from speech2lip_tpu_torch.parallel import mesh as mesh_mod
    from speech2lip_tpu_torch.train import trainer

    reset, counts = counters
    spent = []
    mean_tensors = mesh_mod.mean_tensors

    def timed(tensors, mesh, axis=mesh_mod.DATA):
        if mesh_mod.data_size(mesh) <= 1 or len(tensors) < 20:
            return mean_tensors(tensors, mesh, axis)   # metrics, not grads
        _sync(dev)
        t0 = time.perf_counter()
        out = mean_tensors(tensors, mesh, axis)
        _sync(dev)
        spent.append(1e3 * (time.perf_counter() - t0))
        return out

    mesh_mod.mean_tensors = timed
    try:
        reset()
        state = trainer.fit(cfg, max_iters=iters, device=dev)
        _sync(dev)
        return state, counts(), spent
    finally:
        mesh_mod.mean_tensors = mean_tensors


def _launch_counters():
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws

    def reset():
        kmlp.launches = kws.launches = kfb.launches = 0
        khs.dsrc_launches = khs.dgrid_launches = 0

    def counts():
        return {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
                "fused_block": kfb.launches,
                "hat_sample_dsrc": khs.dsrc_launches,
                "hat_sample_dgrid": khs.dgrid_launches}
    return reset, counts


def _sharded_roundtrip(tree, path) -> bool:
    """save_sharded on every rank, then restore into a NaN template: every
    leaf back bit for bit."""
    from speech2lip_tpu_torch.core.checkpoint import flatten_paths
    from speech2lip_tpu_torch.core.checkpoint_sharded import (
        restore_sharded, save_sharded)
    from speech2lip_tpu_torch.train import train_step as ts

    save_sharded(path, tree, {"it": 1})
    nan = ts.tree_map(lambda t: torch.full_like(t, float("nan"))
                      if torch.is_tensor(t) and t.is_floating_point()
                      else t, tree)
    got, scalars = restore_sharded(path, nan)
    pairs = list(zip(flatten_paths(got), flatten_paths(tree)))
    return scalars == {"it": 1} and all(
        ka == kb and (torch.equal(a, b) if torch.is_tensor(b) else a == b)
        for (ka, a), (kb, b) in pairs)


def _server_job(dev, counters, face, lip_h, lip_w, shape=None) -> dict:
    """MultiSpeakerServer(mesh=) on this group's mesh (``shape``, default
    ``(world, 1)``) against the server with no mesh: two identities at one
    offset, a batch of 8 each through the kernels."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.pipeline import (RENDER_KEYS,
                                                     MultiSpeakerServer)
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.parallel.mesh import make_mesh

    reset, counts = counters
    cfg = default_config()
    cfg["data"]["height"], cfg["data"]["width"] = lip_h, lip_w
    cfg["model"]["canonical_depth_height"] = face
    cfg["model"]["canonical_depth_width"] = face
    raw, geo = synthetic_batch(8, face=face, lip_h=lip_h, lip_w=lip_w,
                               seed=SEED)
    box = tf.expanded_lip_box(lip_h, lip_w, geo["lip_x"], geo["lip_y"])
    window = tuple(compute_warp_window([raw["coord"][i] for i in range(8)],
                                       box, face, face, margin=MARGIN))
    sets = [weights.random_params(s, cfg=cfg) for s in range(2)]
    pos = [(geo["lip_x"], geo["lip_y"])] * 2
    batches = []
    for s in range(2):
        b = {k: torch.from_numpy(raw[k]).to(dev) for k in RENDER_KEYS}
        b["audio"] = b["audio"] + 0.1 * s
        batches.append(b)
    out = {}
    for name, mesh in (("plain", None), ("mesh", make_mesh(shape,
                                                           device=dev))):
        srv = MultiSpeakerServer(cfg, sets, pos, window=window, device=dev,
                                 mesh=mesh)
        reset()
        faces = [o["face"] for o in srv.render_all(batches)]
        _sync(dev)
        out[name] = (faces, counts(), list(srv.served))
    (fp, cp, _), (fm, cm, served) = out["plain"], out["mesh"]
    return {"equal": all(torch.equal(a, b) for a, b in zip(fm, fp)),
            "launches": cm, "launches_plain": cp, "served": served}


def rank_job(spec_path: str) -> int:
    """One process of phase 11 or 12 (``chip_smoke.py --rank-job SPEC``,
    started through ``torch.distributed.run``).  ``pixel``: phase 12
    (``_pixel_rank_job``).  ``nccl``: the spec's ungrouped
    fits run first, with no process group; then the process joins the
    launcher's group as ``cli/train`` joins it (NCCL, one rank) and runs
    the rest.  ``gloo``: every rank joins a gloo group on card 0 first.
    Then the gradients' flat all-reduce, one train step on this rank's
    rows of a global batch and, with ``server``, the server at one rank;
    rank 0 writes the results where the spec says."""
    import os

    import torch.distributed as dist

    from speech2lip_tpu_torch.config import load_config
    from speech2lip_tpu_torch.parallel import distributed
    from speech2lip_tpu_torch.parallel import mesh as mesh_mod
    from speech2lip_tpu_torch.tools import bench_train
    from speech2lip_tpu_torch.train import train_step as ts

    spec = json.load(open(spec_path))
    if spec["backend"] == "pixel":
        return _pixel_rank_job(spec)
    dev = distributed.rank_device(spec["device"])
    if spec["backend"] == "gloo":
        dev = torch.device(spec["device"], 0 if dev.type == "cuda" else None)
        dist.init_process_group("gloo", init_method="env://")
    # the plain versions' float32 work as the other phases run it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = _launch_counters()
    face, lip_h, lip_w = spec["geometry"]
    res = {"fits": {}}
    trainable = None
    for run in spec["fits"]:
        if run["grouped"] and not dist.is_initialized():
            require(distributed.initialize_if_needed(spec["device"]),
                    "no launcher variables for the NCCL job")
        cfg = load_config(run["config"])
        torch.backends.cudnn.deterministic = run["deterministic"]
        torch.use_deterministic_algorithms(run["deterministic"])
        t0 = time.perf_counter()
        with Float64() if run.get("float64") else contextlib.nullcontext():
            state, launches, ar = _rank_fit(cfg, run["iters"], dev,
                                            counters)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        rec = {"s": time.perf_counter() - t0, "launches": launches,
               "allreduce_ms": ar, "world": distributed.process_count()}
        if run.get("roundtrip"):
            rec["roundtrip"] = _sharded_roundtrip(
                ts.state_to_tree(state), os.path.join(
                    cfg["training"]["out_dir"], "roundtrip"))
        res["fits"][run["name"]] = rec
        trainable = {"model": state.params, "unet": state.unet_params}
    res["world"] = distributed.process_count()
    # the gradients' one flat all-reduce, at the size of fit's trainables
    n = sum(t.numel() for t in ts.tree_leaves(trainable))
    flat = torch.zeros(n, device=dev)
    res["grad_bytes"] = 4 * n
    res["grad_allreduce_ms"] = _wall_ms(lambda: dist.all_reduce(flat), dev)
    # one train step on this rank's rows of a global batch
    b = spec["step_batch"]
    batch, geo, win, params, frozen = bench_train.train_inputs(
        dev, b, face, lip_h, lip_w, seed=SEED)
    st = ts.StepStatics(lip_h=lip_h, lip_w=lip_w, lip_x=geo["lip_x"],
                        lip_y=geo["lip_y"], face_h=face, face_w=face,
                        focal=geo["focal"], window=win,
                        face_bbox=(0, 0, face, face), pallas_gather=True)
    mesh = mesh_mod.make_mesh(device=dev)
    draws = ts.draw_noise(st, b, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    opt = ts.Adam(1e-4)
    new, m = ts.make_train_step(opt, st, frozen, mesh)(
        ts.init_train_state(*params, opt), mesh_mod.shard_batch(batch, mesh),
        ts.shard_draws(draws, mesh))
    res["step"] = {"metrics": {k: float(v) for k, v in m.items()},
                   "bn": [t.double().cpu().tolist() for t in
                          ts.tree_leaves(new.unet_state)]}
    if spec["server"]:
        res["server"] = _server_job(dev, counters, face, lip_h, lip_w)
    rank = distributed.process_index()
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(spec["out"], "w") as f:
            json.dump(res, f)
    return 0


def _records(out_dir: str):
    import os
    return [json.loads(line) for line in open(os.path.join(
        out_dir, "metrics.jsonl"))]


def training_across_processes(dev, card: str, tmp: str) -> dict:
    """Phase 11 in the directory ``tmp``.  Returns its numbers."""
    import os

    import numpy as np

    import torch.nn.functional as F

    from speech2lip_tpu_torch.config import save_config
    from speech2lip_tpu_torch.core.checkpoint import load
    from speech2lip_tpu_torch.data.synthetic import (make_learnable_tree,
                                                     make_synthetic_tree,
                                                     synthetic_config)
    from speech2lip_tpu_torch.parallel.distributed import launch
    from speech2lip_tpu_torch.train import trainer

    out = {}
    # -- 11a: fit with torch's default flags, card against the CPU ---------
    root = os.path.join(tmp, "small")
    cfg = synthetic_config(root, make_synthetic_tree(
        root, n_frames=12, face=64, lip_h=16, lip_w=24))
    cfg["model"]["use_post_fusion_blackaug"] = False
    cfg["training"].update(batch_size=2, print_every=1, checkpoint_every=0,
                           backup_every=0, validate_every=2,
                           visualize_every=0, use_local_ensemble=False,
                           use_syncloss=False, pallas_gather=True)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    seen, conv = [], F.conv2d

    def spy(x, *args, **kw):
        if x.is_cuda and x.dtype == torch.float32:
            seen.append(torch.backends.cudnn.allow_tf32
                        or torch.backends.cuda.matmul.allow_tf32)
        return conv(x, *args, **kw)

    recs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        c = dict(cfg, training=dict(cfg["training"],
                                    out_dir=os.path.join(tmp, "a_" + name)))
        torch.backends.cudnn.allow_tf32 = True         # torch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        F.conv2d = spy
        try:
            trainer.fit(c, max_iters=2, device=d)
        finally:
            F.conv2d = conv
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        recs[name] = _records(c["training"]["out_dir"])
    require(seen and not any(seen), f"fit ran {sum(seen)} of {len(seen)} "
            "float32 card convs with TF32 on")
    # the first iteration within 1e-4; the later records within
    # PAR_LATER_BOUND, as in 11c: after Adam's first step the CPU's own
    # float32 grad_norm lies 1.77e-4 from a float64 fit of this case, the
    # card's 4.4e-5 or 1.06e-4 by the algorithms its timing picked (H100)
    worst = [0.0, 0.0]
    for got, ref in zip(recs["card"], recs["cpu"]):
        for k in ref:
            if k.startswith(("train/loss", "train/psnr", "train/grad",
                             "val/")):
                e = abs(got[k] - ref[k]) / max(1.0, abs(ref[k]))
                later = ref["it"] > 1
                worst[later] = max(worst[later], e)
    log(f"# phase 11a: fit float32 with torch's default TF32 flags, card vs "
        f"CPU worst rel {worst[0]:.3g} at it 1 (bound 1e-4), {worst[1]:.3g} "
        f"after (bound {PAR_LATER_BOUND}) over {len(recs['cpu'])} records; "
        f"{len(seen)} float32 card convs, none with TF32")
    require(worst[0] <= 1e-4 and worst[1] <= PAR_LATER_BOUND,
            f"phase 11a: fit on the card vs the CPU {worst}")
    out["c1_err"] = worst

    # -- the identity and the children's configs ---------------------------
    root = os.path.join(tmp, "identity")
    geo = make_learnable_tree(root, n_frames=PAR_FRAMES, face=FACE,
                              lip_h=LIP_H, lip_w=LIP_W, seed=SEED)
    base = synthetic_config(root, geo)
    base["model"]["use_post_fusion_blackaug"] = False
    base["training"].update(PAR_TRAINING)
    val_frames = base["data"]["val_split_frames"]

    def config(name, **tr):
        c = dict(base, training=dict(base["training"], **tr,
                                     out_dir=os.path.join(tmp, name)))
        path = os.path.join(tmp, name + ".yaml")
        save_config(path, c)
        return path

    # nccl: the bit-for-bit pair (plain gathers: K7's float atomics add
    # in another order from run to run; deterministic torch ops), no group
    # then one NCCL rank, the float64 witness of the first iteration
    # (plain gathers) and the one-rank reference of the gloo ranks (the
    # kernel gathers, 2 PAR_B frames); gloo: two ranks of PAR_B
    exact = dict(iters=PAR_ITERS, deterministic=True, roundtrip=True)
    kernels = dict(iters=PAR_ITERS, deterministic=False, grouped=True)
    specs = {
        "nccl": {"fits": [
            dict(exact, name="exact_none", grouped=False,
                 config=config("exact_none", pallas_gather=False)),
            dict(exact, name="exact_nccl", grouped=True,
                 config=config("exact_nccl", pallas_gather=False)),
            dict(name="float64", iters=1, deterministic=False, grouped=True,
                 float64=True,
                 config=config("float64", pallas_gather=False,
                               batch_size=2 * PAR_B)),
            dict(kernels, name="kernels_one",
                 config=config("kernels_one", pallas_gather=True,
                               batch_size=2 * PAR_B))],
            "server": True},
        "gloo": {"fits": [
            dict(kernels, name="kernels_two", roundtrip=True,
                 config=config("kernels_two", pallas_gather=True,
                               sharded_ckpt=True))],
            "server": False}}
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    res = {}
    for job, spec in specs.items():
        spec.update(backend=job, device=dev.type, step_batch=2 * PAR_B,
                    geometry=[FACE, LIP_H, LIP_W],
                    out=os.path.join(tmp, f"{job}.json"))
        path = os.path.join(tmp, f"{job}.spec.json")
        json.dump(spec, open(path, "w"))
        t0 = time.perf_counter()
        # nccl: one rank on card 0; gloo: two ranks, both on card 0
        launch(1 if job == "nccl" else 2, "chip_smoke",
               ["--rank-job", path], env=env,
               cwd=os.path.dirname(os.path.abspath(__file__)))
        res[job] = json.load(open(spec["out"]))
        res[job]["wall_s"] = time.perf_counter() - t0
        log(f"# phase 11 {job} job: {res[job]['wall_s']:.1f} s, world "
            f"{res[job]['world']}, fits " + ", ".join(
                f"{k} {v['s']:.1f} s (world {v['world']}) launches "
                f"{v['launches']}" for k, v in res[job]["fits"].items()))

    # -- 11b: one NCCL rank against no group, bit for bit ------------------
    n, g = res["nccl"], res["gloo"]
    nf = n["fits"]
    a, b = (_records(os.path.join(tmp, name)) for name in ("exact_none",
                                                           "exact_nccl"))
    strip = lambda rs: [{k: v for k, v in r.items()
                         if k not in PAR_TIMING_KEYS} for r in rs]
    require(len(a) == PAR_ITERS + 1 and strip(a) == strip(b),
            "phase 11b: metrics.jsonl of the one-rank NCCL fit differs from "
            "the fit with no group")
    ca, _ = load(os.path.join(tmp, "exact_none", "model.ckpt"))
    cb, _ = load(os.path.join(tmp, "exact_nccl", "model.ckpt"))
    require(set(ca) == set(cb) and all(np.array_equal(ca[k], cb[k])
                                       for k in ca),
            "phase 11b: the final checkpoints differ")
    require((nf["exact_none"]["world"], nf["exact_nccl"]["world"]) == (1, 1)
            and nf["exact_none"]["roundtrip"] and nf["exact_nccl"]["roundtrip"],
            "phase 11b/d: world size or the sharded round trip")
    want_k1 = val_frames * (PAR_ITERS // base["training"]["validate_every"])
    for name in ("exact_none", "exact_nccl"):
        got = nf[name]["launches"]
        require(got["fused_mlp"] == want_k1 and got["window_sample"] == 0,
                f"phase 11b {name}: launches {got}, K1 {want_k1} expected")
    its = lambda rs, k: sorted(r[k] for r in rs if r.get("it", 0) > 1
                               and k in r)
    log(f"# phase 11b: fit under a one-rank NCCL group == fit with no group, "
        f"bit for bit ({len(a)} records, {len(ca)} checkpoint leaves; fit "
        f"{nf['exact_none']['s']:.2f} s (the process's first) against "
        f"{nf['exact_nccl']['s']:.2f} s; iterations 2.. batch build ms "
        f"{its(a, 'train/batch_ms')} / {its(b, 'train/batch_ms')}, step ms "
        f"{its(a, 'train/step_ms')} / {its(b, 'train/step_ms')}); the "
        f"gradients' flat all-reduce "
        f"({n['grad_bytes']} bytes) takes {n['grad_allreduce_ms']:.4f} ms on "
        f"NCCL at one rank on {card}")
    out.update(grad_bytes=n["grad_bytes"],
               nccl1_allreduce_ms=n["grad_allreduce_ms"],
               fit_s={k: nf[k]["s"] for k in ("exact_none", "exact_nccl")})

    # -- 11c: two gloo ranks on the one card against one rank --------------
    require(g["world"] == 2 and nf["kernels_one"]["world"] == 1,
            "phase 11c: world sizes")
    ra = _records(os.path.join(tmp, "kernels_one"))
    rb = _records(os.path.join(tmp, "kernels_two"))
    (r64,) = _records(os.path.join(tmp, "float64"))
    # the first iteration: each side against the float64 fit; the later
    # records: the two sides against each other; worst[0] of the first
    # iteration's two sides against each other, logged
    worst, sides = [0.0, 0.0], [0.0, 0.0]
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))
    for x, y in zip(ra, rb):
        for k in x:
            if k.startswith(("train/loss", "train/psnr", "train/grad",
                             "val/")):
                later = x["it"] > 1
                worst[later] = max(worst[later], rel(y[k], x[k]))
                if not later:
                    sides = [max(sides[0], rel(x[k], r64[k])),
                             max(sides[1], rel(y[k], r64[k]))]
    require(len(ra) == len(rb) == PAR_ITERS + 1 and r64["it"] == 1
            and max(sides) <= PAR_BOUND and worst[1] <= PAR_LATER_BOUND,
            f"phase 11c: fit's first iteration vs float64, one rank / two "
            f"ranks {sides}; two-rank fit vs one rank rel {worst}")
    sw = 0.0
    for k, v in n["step"]["metrics"].items():
        sw = max(sw, abs(g["step"]["metrics"][k] - v) / max(1.0, abs(v)))
    for x, y in zip(g["step"]["bn"], n["step"]["bn"]):
        x, y = np.asarray(x), np.asarray(y)
        sw = max(sw, float(np.abs(x - y).max() / max(1e-6, np.abs(y).max())))
    require(sw <= PAR_BOUND, f"phase 11c: two-rank step vs one rank {sw:.3g}")
    kl = g["fits"]["kernels_two"]
    require(kl["roundtrip"] and kl["launches"]["window_sample"] > 0
            and kl["launches"]["hat_sample_dsrc"] > 0
            and kl["launches"]["hat_sample_dgrid"] > 0
            and kl["launches"]["fused_mlp"] == want_k1,
            f"phase 11c: launches {kl['launches']} / sharded round trip")
    ar = kl["allreduce_ms"]
    log(f"# phase 11c: two gloo ranks on one card, fit's first iteration "
        f"vs a float64 fit: one rank {sides[0]:.3g}, two ranks "
        f"{sides[1]:.3g} (bound {PAR_BOUND}; {worst[0]:.3g} apart); fit vs "
        f"one rank on the global batch {worst[1]:.3g} after it 1 (bound "
        f"{PAR_LATER_BOUND}), a step {sw:.3g} "
        f"(bound {PAR_BOUND}); rank 0 launches {kl['launches']} (one rank "
        f"on the global batch {nf['kernels_one']['launches']}); the step's "
        f"gradient all-reduce over gloo {ar} ms, a flat "
        f"{g['grad_bytes']}-byte all-reduce {g['grad_allreduce_ms']:.3f} ms "
        f"on {card}")
    out.update(gloo_fit_err=worst, gloo_fit_f64_err=sides, gloo_step_err=sw,
               gloo_allreduce_ms=ar, gloo_flat_ms=g["grad_allreduce_ms"],
               fit_ranks=kl["launches"], fit_launches_its=PAR_ITERS,
               job_s={k: v["wall_s"] for k, v in res.items()})

    # -- 11e: the server at one rank ---------------------------------------
    sv = n["server"]
    require(sv["equal"] and sv["served"] == [0, 1]
            and sv["launches"] == sv["launches_plain"]
            and (sv["launches"]["fused_mlp"], sv["launches"]["window_sample"],
                 sv["launches"]["fused_block"]) == (2, 2, 10),
            f"phase 11e: server with a mesh {sv}")
    log(f"# phase 11e: MultiSpeakerServer(mesh) at one NCCL rank == the "
        f"server with no mesh (2 identities x 8 frames); launches "
        f"{sv['launches']}")
    out["mesh_server"] = sv["launches"]
    return out


# the pixel axis (phase 12): one torch.distributed.run launch of four gloo
# ranks sharing card 0 (``--rank-job SPEC``), at May geometry with the
# default base-64 U-Net in train-mode BatchNorm, the black-hole
# augmentation and the K2/K7 gathers on.  The step under each mesh, in
# float32 and bf16, against the one-process step on the global batch on
# the same card (rank 0), on the metrics (grad_norm among them), the
# U-Net's BatchNorm state and two gradients; the halo exchanges' bytes and
# ms; each rank's K2/K7 launches; MultiSpeakerServer and the tracker's
# photometric term under (2, 2)
PIX_B = 2                                     # the global batch
PIX_MESHES = ((2, 2), (1, 4))                 # (1, 4): 128/124/124/124 rows
PIX_DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
# the gradients held to the bound: the U-Net's 1x1 outc, weight and bias
# (sums over every band's rows, through the bands' gather and its
# reduce-scatter); the lip MLP's first layer (through the whole banded
# U-Net's backward) is held to the training path's own bound
# (TRAIN_BOUND, phase 5's).  Logged only: the first 3x3 conv's weight,
# whose float32 gradient is 1.7e-3 off its float64 value even in one
# process on the CPU (BatchNorm's backward cancels its sums), and the
# canonical depth's, the derivative of a bilinear sample with respect to
# its grid, which jumps where a point crosses a pixel edge: the warp's
# batched product rounds otherwise at a rank's batch of 1 than at 2
PIX_GRADS = ("unet.outc.w", "unet.outc.b")
PIX_TRAIN_GRADS = ("model.trunk.0.w",)
PIX_LOGGED_GRADS = ("unet.inc.conv1.w", "model.canonical_depth")
PIX_ITERS = 3


def _pixel_tracker(dev, shape) -> float:
    """The tracker's photometric term and its gradients on a (data,
    pixel) mesh against the term with no mesh, on this rank: worst
    relative error.  5 frames of a rendered 48-px world (the CPU test's)
    padded to 6 over the data axis."""
    from speech2lip_tpu_torch.parallel import mesh as mesh_mod
    from speech2lip_tpu_torch.preprocess import face_3dmm as bfm
    from speech2lip_tpu_torch.preprocess import synthetic_world as sw
    from speech2lip_tpu_torch.preprocess.tracker import (FaceTracker,
                                                         TrackerConfig)

    n, size, focal = 5, 48, 60.0
    assets = bfm.assets_to(bfm.synthetic_assets(
        n_verts=150, id_dim=6, exp_dim=4, tex_dim=6, seed=1), dev)
    truth = sw.true_params(assets, n)
    imgs, lms = sw.render_world(assets, truth, size, focal)
    cfg = TrackerConfig(img_h=size, img_w=size, photo_chunk=2, id_dim=6,
                        exp_dim=4, tex_dim=6)
    plain = FaceTracker(assets, lms, cfg, device=dev)
    t = lambda k: torch.as_tensor(truth[k], device=dev)
    with torch.no_grad():
        pix, colors = plain._pix_colors(
            t("id"), bfm.forward_tex(assets, torch.zeros(1, 6, device=dev)),
            t("exp"), t("euler"), t("trans"),
            torch.zeros(n, 27, device=dev), focal)
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    mesh = mesh_mod.make_mesh(shape, device=dev)
    out = []
    for tr in (plain, FaceTracker(assets, lms, cfg, mesh=mesh, device=dev)):
        p, c = (v.clone().requires_grad_(True) for v in (pix, colors))
        loss = tr.col_loss(p, c, imgs)
        grads = torch.autograd.grad(loss, [p, c])
        if tr.mesh is not None:
            grads = mesh_mod.mean_tensors(grads, mesh, mesh_mod.DATA)
        out.append([loss.detach(), *grads])
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))
               for a, b in zip(*out))


@contextlib.contextmanager
def _heuristic_convs():
    """The train step with no mesh, as on a mesh with a pixel axis: its
    convs take cuDNN's heuristic pick, untimed."""
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.train import train_step as ts
    tuned, ts.tuned_float32 = ts.tuned_float32, tnn.full_float32
    try:
        yield
    finally:
        ts.tuned_float32 = tuned


def _pixel_rank_job(spec) -> int:
    """One of phase 12's gloo ranks, on card 0: for each of the spec's
    dtypes, the one-process step on the global batch (rank 0), then each
    mesh's step on this rank's rows: the metrics, BatchNorm state,
    gradients and launches of one step, the halo exchanges of a second,
    the ms of ``iters`` more; then the server and the tracker under the
    first mesh.  Each rank saves its results where the spec says."""
    import torch.distributed as dist

    from speech2lip_tpu_torch.parallel import distributed
    from speech2lip_tpu_torch.parallel import mesh as mesh_mod
    from speech2lip_tpu_torch.tools import bench_train
    from speech2lip_tpu_torch.train import train_step as ts

    dev = torch.device(spec["device"], 0 if spec["device"] == "cuda"
                       else None)
    dist.init_process_group("gloo", init_method="env://")
    rank = distributed.process_index()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset, counts = _launch_counters()
    face, lip_h, lip_w = spec["geometry"]
    meshes = [tuple(m) for m in spec["meshes"]]
    batch, geo, win, params, frozen = bench_train.train_inputs(
        dev, spec["batch"], face, lip_h, lip_w, seed=SEED)
    swap, halo = mesh_mod._swap_edges, {}

    def timed_swap(top, bottom, band):
        """The halo exchange, its bytes (the two edge rows this rank
        sends) and ms counted."""
        _sync(dev)
        t0 = time.perf_counter()
        out = swap(top, bottom, band)
        _sync(dev)
        halo["ms"] += 1e3 * (time.perf_counter() - t0)
        halo["bytes"] += nbytes(top, bottom)
        halo["calls"] += 1
        return out

    def run(mesh, st, draws):
        b, d = mesh_mod.shard_batch(batch, mesh), ts.shard_draws(draws, mesh)
        reset()
        grads, m, bn, trainable = ts.loss_and_grads(*params, frozen, b, d,
                                                    st, mesh)
        _sync(dev)
        names = [k for k, _ in named_leaves(trainable)]
        rec = {"launches": counts(),
               "metrics": {k: float(v) for k, v in m.items()},
               "bn": [t.double().cpu() for t in ts.tree_leaves(bn)],
               "grads": {k: grads[names.index(k)].double().cpu()
                         for k in PIX_GRADS + PIX_TRAIN_GRADS
                         + PIX_LOGGED_GRADS}}
        halo.update(bytes=0, ms=0.0, calls=0)
        mesh_mod._swap_edges = timed_swap
        try:
            ts.loss_and_grads(*params, frozen, b, d, st, mesh)
            _sync(dev)
        finally:
            mesh_mod._swap_edges = swap
        rec["halo"] = dict(halo)
        opt = ts.Adam(1e-4)
        step = ts.make_train_step(opt, st, frozen, mesh)
        state = ts.init_train_state(*params, opt)
        rec["ms"] = _wall_ms(lambda: step(state, b, d), dev, spec["iters"])
        return rec

    res = {"rank": rank, "world": distributed.process_count(), "steps": {}}
    t0 = time.perf_counter()
    for name in spec["dtypes"]:
        st = bench_train.statics(geo, win, face, name)
        draws = ts.draw_noise(st, spec["batch"], device=dev,
                              generator=torch.Generator(dev).manual_seed(1))
        if rank == 0:
            # with the mesh steps' conv algorithms, cuDNN's heuristic pick
            # (train_step.step_scope on a pixel axis): with no mesh the
            # step would time its own
            with _heuristic_convs():
                res["steps"][f"one/{name}"] = run(None, st, draws)
                # the same step again: what the card's own float atomics
                # (cuDNN's, K7 dsrc's) move from run to run
                res["steps"][f"again/{name}"] = run(None, st, draws)
        for shape in meshes:
            mesh = mesh_mod.make_mesh(shape, device=dev)
            rec = run(mesh, st, draws)
            rec["rows"] = mesh_mod.frame_band(mesh, face).rows
            res["steps"][f"{shape[0]}x{shape[1]}/{name}"] = rec
    res["steps_s"] = time.perf_counter() - t0
    res["server"] = _server_job(dev, _launch_counters(), face, lip_h, lip_w,
                                shape=meshes[0])
    res["tracker_err"] = _pixel_tracker(dev, meshes[0])
    dist.barrier()
    dist.destroy_process_group()
    torch.save(res, f"{spec['out']}.{rank}.pt")
    return 0


def _rel_err(got, ref) -> float:
    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6))


def _step_gaps(got, ref) -> dict:
    """Phase 12's gaps of a step record to a reference: each metric
    relative to max(1, |value|), the BatchNorm state and each gradient
    relative to its largest magnitude."""
    gaps = {k: abs(got["metrics"][k] - v) / max(1.0, abs(v))
            for k, v in ref["metrics"].items()}
    gaps["bn"] = max(_rel_err(x, y) for x, y in zip(got["bn"], ref["bn"]))
    gaps.update({k: _rel_err(got["grads"][k], ref["grads"][k])
                 for k in ref["grads"]})
    return {k: float(f"{v:.3g}") for k, v in gaps.items()}


def pixel_axis(dev, card: str, tmp: str) -> dict:
    """Phase 12 in the directory ``tmp``: four gloo ranks on card 0.
    Returns its numbers."""
    import os

    from speech2lip_tpu_torch.parallel.distributed import launch

    spec = {"backend": "pixel", "device": dev.type,
            "geometry": [FACE, LIP_H, LIP_W], "batch": PIX_B,
            "meshes": PIX_MESHES, "dtypes": [n for n, _ in PIX_DTYPES],
            "iters": PIX_ITERS, "out": os.path.join(tmp, "pixel")}
    path = os.path.join(tmp, "pixel.spec.json")
    json.dump(spec, open(path, "w"))
    world = PIX_MESHES[0][0] * PIX_MESHES[0][1]
    t0 = time.perf_counter()
    launch(world, "chip_smoke", ["--rank-job", path],
           cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{spec['out']}.{r}.pt", weights_only=False)
             for r in range(world)]
    require([r["world"] for r in ranks] == [world] * world,
            "phase 12: world sizes")
    out = {"wall_s": wall, "world": world,
           "steps_s": max(r["steps_s"] for r in ranks), "steps": {}}
    for name, dtype in PIX_DTYPES:
        bound = PAR_BOUND if dtype == torch.float32 else TRAIN_BOUND[dtype]
        ref = ranks[0]["steps"][f"one/{name}"]
        floor = _step_gaps(ranks[0]["steps"][f"again/{name}"], ref)
        out["steps"][f"one/{name}"] = {"ms": ref["ms"], "floor": floor}
        log(f"# phase 12 one process {name}: the step against itself "
            f"(run to run on the card) {floor}")
        for shape in PIX_MESHES:
            key = f"{shape[0]}x{shape[1]}/{name}"
            recs = [r["steps"][key] for r in ranks]
            a = recs[0]
            require(all(r["metrics"] == a["metrics"] and all(
                torch.equal(x, y) for x, y in zip(r["bn"], a["bn"]))
                and all(torch.equal(r["grads"][k], a["grads"][k])
                        for k in a["grads"]) for r in recs),
                f"phase 12 {key}: the ranks end the step apart")
            gaps = _step_gaps(a, ref)
            err = max(v for k, v in gaps.items()
                      if k not in PIX_TRAIN_GRADS + PIX_LOGGED_GRADS)
            train_err = max(gaps[k] for k in PIX_TRAIN_GRADS)
            launches = [(r["launches"]["window_sample"],
                         r["launches"]["hat_sample_dsrc"],
                         r["launches"]["hat_sample_dgrid"]) for r in recs]
            require(err <= bound, f"phase 12 {key}: the mesh step vs the "
                    f"one-process step {err:.3g} > {bound}: {gaps}")
            require(train_err <= TRAIN_BOUND[dtype],
                    f"phase 12 {key}: the {PIX_TRAIN_GRADS} gradients vs "
                    f"the one-process step {train_err:.3g} > "
                    f"{TRAIN_BOUND[dtype]}")
            require(all(x == STEP_LAUNCHES[False] for x in launches),
                    f"phase 12 {key}: K2/K7 launches a rank {launches}, "
                    f"{STEP_LAUNCHES[False]} expected")
            out["steps"][key] = {
                "err": err, "gaps": gaps, "bound": bound,
                "rows": a["rows"], "ms": [r["ms"] for r in recs],
                "launches": launches,
                "halo_bytes": [r["halo"]["bytes"] for r in recs],
                "halo_ms": [r["halo"]["ms"] for r in recs],
                "halo_calls": a["halo"]["calls"]}
            log(f"# phase 12 {key}: bands {a['rows']}; vs the one-process "
                f"step on the global batch: metrics, BatchNorm state and "
                f"the {PIX_GRADS} gradients {err:.3g} (bound {bound}), "
                f"{PIX_TRAIN_GRADS} {train_err:.3g} (bound "
                f"{TRAIN_BOUND[dtype]}); by part {gaps}"
                + f"; ms a step by rank {[round(r['ms'], 2) for r in recs]} "
                f"(one process {ref['ms']:.2f}); halo {a['halo']['calls']} "
                f"exchanges a step, bytes a rank sends "
                f"{out['steps'][key]['halo_bytes']}, ms "
                f"{[round(r['halo']['ms'], 2) for r in recs]}; K2/dsrc/dgrid "
                f"launches a rank {launches}; {world} gloo ranks sharing "
                f"{card}")
    sv = [r["server"] for r in ranks]
    require(all(s["equal"] and s["served"] == [r // PIX_MESHES[0][1]]
                and (s["launches"]["fused_mlp"],
                     s["launches"]["window_sample"],
                     s["launches"]["fused_block"]) == (1, 1, 5)
                for r, s in enumerate(sv)),
            f"phase 12: the server on a {PIX_MESHES[0]} mesh {sv}")
    tr = max(r["tracker_err"] for r in ranks)
    require(tr <= 1e-5, f"phase 12: the tracker's photometric term on a "
            f"{PIX_MESHES[0]} mesh vs no mesh {tr:.3g}")
    out.update(server=[s["launches"] for s in sv], tracker_err=tr)
    log(f"# phase 12: server on {PIX_MESHES[0]} == no mesh, identity by data "
        f"index, launches a rank {out['server']}; tracker photometric term "
        f"and gradients vs no mesh {tr:.3g} (bound 1e-5); the job "
        f"{wall:.1f} s (its steps {out['steps_s']:.1f} s) on {card}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke runs "
                         "only on a GPU")
    import torch.nn.functional as F

    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.config import default_config
    from speech2lip_tpu_torch.data.synthetic import synthetic_batch
    from speech2lip_tpu_torch.data.windows import compute_warp_window
    from speech2lip_tpu_torch.infer.renderer import Renderer, render_face_batch
    from speech2lip_tpu_torch.infer.static_scene import (StaticSceneRenderer,
                                                         crop_geometry)
    from speech2lip_tpu_torch.models import talking_face as tf
    from speech2lip_tpu_torch.models import unet_light
    from speech2lip_tpu_torch.ops import nn as tnn
    from speech2lip_tpu_torch.ops.coords import get_coords
    from speech2lip_tpu_torch.ops.embedders import fourier_embed
    from speech2lip_tpu_torch.ops.kernels import _build
    from speech2lip_tpu_torch.ops.kernels import conv_block as kcb
    from speech2lip_tpu_torch.ops.kernels import conv_hcw as kch
    from speech2lip_tpu_torch.ops.kernels import dot_probe as kdp
    from speech2lip_tpu_torch.ops.kernels import fused_block as kfb
    from speech2lip_tpu_torch.ops.kernels import fused_mlp as kmlp
    from speech2lip_tpu_torch.ops.kernels import hat_sample as khs
    from speech2lip_tpu_torch.ops.kernels import window_sample as kws
    from speech2lip_tpu_torch.ops.kernels.conv_block import fold_bn
    from speech2lip_tpu_torch.tools import bench_int8_dot as k8tool
    from speech2lip_tpu_torch.tools import bench_hat_sample as k7tool
    from speech2lip_tpu_torch.tools import bench_window_sample as k2tool
    from speech2lip_tpu_torch.train import train_step as ts
    from speech2lip_tpu_torch.train import trainer

    dev = torch.device("cuda")
    # plain versions in full float32 (no TF32 in cuBLAS or cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"# card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"# build: {time.perf_counter() - t0:.1f} s (kernels in "
        f"{_build.BUILD_DIR})")

    # -- May-geometry inputs ----------------------------------------------
    raw, geo = synthetic_batch(8, face=FACE, lip_h=LIP_H, lip_w=LIP_W,
                               seed=SEED)
    box = tf.expanded_lip_box(LIP_H, LIP_W, geo["lip_x"], geo["lip_y"])
    window = compute_warp_window([raw["coord"][i] for i in range(8)], box,
                                 FACE, FACE, margin=MARGIN)
    crop = crop_geometry(window, FACE, FACE)
    require(crop is not None, f"window {window} gives no static-scene crop")
    log(f"# geometry: face {FACE}, lip {LIP_H}x{LIP_W} at "
        f"({geo['lip_y']}, {geo['lip_x']}), box {box}, window {window}, "
        f"static-scene crop {crop['ch']}x{crop['cw']}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def k1_args(dtype, frames=8):
        tp, _, _ = weights.random_params(SEED, device=dev, dtype=dtype)
        uv = fourier_embed(get_coords(LIP_W, LIP_H, dtype=dtype, device=dev),
                           10).contiguous()
        base = torch.randn(frames, 256, device=dev, generator=gen)
        skip = torch.randn(frames, 256, device=dev, generator=gen)
        trunk = tp["trunk"]
        return (uv, (tp["fc_uv"]["b"].float() + base).contiguous(),
                (tp["fc_uv_skip"]["b"].float() + skip).contiguous(),
                tp["fc_uv"]["w"], tp["fc_uv_skip"]["w"],
                [l["w"] for l in trunk], [l["b"].float() for l in trunk],
                tp["output"]["w"], tp["output"]["b"].float())

    x0b, x1b, y0b, y1b = box
    wy0, wx0, wh, ww = window

    def k2_args(dtype):
        """K2 as the composite calls it: the lip box's crop of a frame and
        the warp window of the coord grid, both views read in place."""
        frame = torch.rand(8, FACE, FACE, 3, device=dev,
                           generator=gen).to(dtype)
        src = frame[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1]
        grid = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww]
        require(not (src.is_contiguous() or grid.is_contiguous()),
                "K2's inputs must be strided views")
        return (src, grid, y0b - 1, x0b - 1, FACE, FACE)

    def k3_cases(dtype, h=FACE, w=FACE, b=8):
        """(name, args, kwargs) of the U-Net's five K3 blocks on an h x w
        input: each block at 1/d of it, an up block's low-resolution
        source at half its own."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        cases = []
        for name, d, cx, cl, pool in (("inc", 1, 3, 0, True),
                                      ("down1", 2, 64, 0, True),
                                      ("down2", 4, 128, 0, False),
                                      ("up1", 2, 128, 128, False),
                                      ("up2", 1, 64, 64, False)):
            p, s = up[name], us[name]
            s1, b1 = fold_bn(p["bn1"], s["bn1"])
            s2, b2 = fold_bn(p["bn2"], s["bn2"])
            hd, wd = h // d, w // d
            x = torch.rand(b, hd, wd, cx, device=dev, generator=gen).to(dtype)
            lo = (torch.rand(b, hd // 2, wd // 2, cl, device=dev,
                             generator=gen).to(dtype) if cl else None)
            cases.append((name, (x, p["conv1"]["w"], s1.float(), b1.float(),
                                 p["conv2"]["w"], s2.float(), b2.float()),
                          dict(up=lo, pool=pool)))
        return cases

    def k7_cases(dtype):
        """(name, src, grid, cotangent, (y_off, x_off, H, W)) of K7 at the
        main path's shapes, from ``bench_hat_sample.cases``: the blackaug
        window gather as the train step hands it over (the coord grid's
        window view, the cotangent zero off the warped lip box) and as a
        dense contiguous copy, the depth-loss points (border-clamped) and
        a grid exactly on pixel centres."""
        return [(f"{name} {tuple(c[1].shape)}", *c)
                for name, c in k7tool.cases(dev, dtype).items()]

    def conv_cases(dtype, b=8):
        """(name, (x, w, scale, bias)) of the U-Net's ten convs at May
        shapes, the eval BatchNorm folded (K4 and K6)."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        out = []
        for name, hw, cin in UNET_CONVS:
            blk, k = name.split(".")
            p, s = up[blk], us[blk]
            sc, bi = fold_bn(p[f"bn{k}"], s[f"bn{k}"])
            x = torch.rand(b, hw, hw, cin, device=dev, generator=gen).to(dtype)
            out.append((name, (x, p[f"conv{k}"]["w"].contiguous(), sc.float(),
                               bi.float())))
        return out

    def dconv_cases(dtype, b=8):
        """(name, (x, w1, scale1, bias1, w2, scale2, bias2)) of the U-Net's
        five DoubleConvs at May shapes (K5)."""
        _, up, us = weights.random_params(SEED, device=dev, dtype=dtype)
        out = []
        for name, hw, cin in UNET_DCONVS:
            p, s = up[name], us[name]
            s1, b1 = fold_bn(p["bn1"], s["bn1"])
            s2, b2 = fold_bn(p["bn2"], s["bn2"])
            x = torch.rand(b, hw, hw, cin, device=dev, generator=gen).to(dtype)
            out.append((name, (x, p["conv1"]["w"], s1.float(), b1.float(),
                               p["conv2"]["w"], s2.float(), b2.float())))
        return out

    # -- phase 2: each kernel against its plain version --------------------
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        a = k1_args(dtype)
        errs[("fused_mlp", dtype)] = check(
            f"K1 fused_mlp {dn} B=8 N={LIP_H * LIP_W}",
            [(kmlp.fused_mlp(*a), kmlp.fused_mlp_plain(*a))], BOUND[dtype])

        a = k2_args(dtype)
        got = kws.window_sample(*a)
        errs[("window_sample", dtype)] = check(
            f"K2 window_sample {dn} crop view {tuple(a[0].shape[1:3])} of "
            f"{FACE}x{FACE}, window view {tuple(a[1].shape[1:3])}",
            [(got, kws.window_sample_plain(*a))], K2_BOUND[dtype])
        require(torch.equal(got, kws.window_sample(
            a[0].contiguous(), a[1].reshape(8, -1, 2).contiguous(), *a[2:])),
            "K2 on the views differs from K2 on contiguous copies")

        # K3 on the full frame (the Renderer) and on the static scene's
        # crop, which is not square and no tile multiple at any level
        worst = 0.0
        for name, args, kw in (k3_cases(dtype)
                               + k3_cases(dtype, crop["ch"], crop["cw"])):
            got = kfb.fused_block(*args, **kw)
            ref = kfb.fused_block_plain(*args, **kw)
            pairs = zip(got, ref) if kw["pool"] else [(got, ref)]
            lo = "" if kw["up"] is None else f" up {tuple(kw['up'].shape)}"
            worst = max(worst, check(
                f"K3 fused_block {dn} {name} {tuple(args[0].shape)}{lo}",
                pairs, BOUND[dtype]))
        errs[("fused_block", dtype)] = worst

        # K1b: one frame (render_pixels), the 4-offset ensemble in the rows
        a = k1_args(dtype, frames=1)
        a = (fourier_embed(torch.rand(4 * LIP_H * LIP_W, 2, device=dev,
                                      generator=gen), 10).to(dtype),) + a[1:]
        errs[("fused_mlp_one_frame", dtype)] = check(
            f"K1b fused_mlp {dn} one frame N={4 * LIP_H * LIP_W}",
            [(kmlp.fused_mlp(*a), kmlp.fused_mlp_plain(*a))], BOUND[dtype])

        for kern in ("dsrc", "dgrid"):
            errs[(f"hat_sample_{kern}", dtype)] = 0.0
        for name, src, grid, cot, g_geo in k7_cases(dtype):
            hs, ws = src.shape[1:3]
            e = check(f"K7 hat_sample_dsrc {dn} {name}",
                      [(khs.hat_sample_dsrc(grid, cot, hs, ws, *g_geo),
                        khs.hat_sample_dsrc_plain(grid, cot, hs, ws, *g_geo))],
                      K7_BOUND["dsrc"][dtype])
            errs[("hat_sample_dsrc", dtype)] = max(
                errs[("hat_sample_dsrc", dtype)], e)
            dg = khs.hat_sample_dgrid(src, grid, cot, *g_geo)
            e = check(f"K7 hat_sample_dgrid {dn} {name}",
                      [(dg, khs.hat_sample_dgrid_plain(src, grid, cot,
                                                       *g_geo))],
                      K7_BOUND["dgrid"][dtype])
            errs[("hat_sample_dgrid", dtype)] = max(
                errs[("hat_sample_dgrid", dtype)], e)
            if name.startswith("integer"):
                require(bool((dg == 0).all()), "K7 dgrid on pixel centres "
                        "must be 0 (hat'(u) = -sign(u) on |u| < 1)")

        # K4 and K6 launch one kernel; each wrapper is held against the
        # plain version on the ten convs, K5 on the five DoubleConvs
        worst = {"conv3x3_hcw": 0.0, "conv3x3_infer": 0.0,
                 "double_conv_hcw": 0.0}
        for name, args in conv_cases(dtype):
            ref = kfb.conv3x3_affine_plain(*args)
            shape = f"{tuple(args[0].shape)}->{args[1].shape[3]}"
            for kname, fn in (("conv3x3_hcw", kch.conv3x3_hcw),
                              ("conv3x3_infer", kcb.conv3x3_infer)):
                worst[kname] = max(worst[kname], check(
                    f"{kname} {dn} {name} {shape}", [(fn(*args), ref)],
                    BOUND[dtype]))
        for name, args in dconv_cases(dtype):
            worst["double_conv_hcw"] = max(worst["double_conv_hcw"], check(
                f"double_conv_hcw {dn} {name} {tuple(args[0].shape)}",
                [(kch.double_conv_hcw(*args),
                  kch.double_conv_hcw_plain(*args))], BOUND[dtype]))
        for kname, e in worst.items():
            errs[(kname, dtype)] = e
        torch.cuda.empty_cache()

    # registers, local memory (spills land there) and shared memory of K1's
    # two instances, K5's eight and the six of the conv kernel behind
    # K3/K4/K6; the bf16 bodies must keep everything on chip
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        insts = [(f"K1 fused_mlp_attrs {dn}", kmlp.fused_mlp_attrs(dtype))]
        insts += [(f"K5 attrs {dn} cmid {cmid} cout {cout}",
                   kch.double_conv_attrs(dtype, cmid, cout))
                  for cmid in (64, 128) for cout in (64, 128)]
        insts += [(f"K3/K4/K6 conv3x3_attrs {dn} cout {cout}",
                   kfb.conv3x3_attrs(dtype, cout)) for cout in (64, 128, 256)]
        for what, at in insts:
            log(f"# {what}: {at['regs']} registers, {at['local_bytes']} "
                f"local bytes, {at['smem_bytes']} shared bytes")
            require(dtype != torch.bfloat16 or at["local_bytes"] == 0,
                    f"{what} uses local memory")

    # -- phase 2b: K8, the dot probe, at its full shape, both types ------
    k8_in = k8tool.make_inputs(device=dev)
    k8_shape = (f"lhs {tuple(k8_in['bf16'][0].shape)} rhs "
                f"{tuple(k8_in['bf16'][1].shape)} T={k8tool.T}")
    k8_err = {}
    for dn, (lhs, rhs) in k8_in.items():
        got = kdp.dot_probe(lhs, rhs, k8tool.T)
        ref = kdp.dot_probe_plain(lhs, rhs, k8tool.T)
        if dn == "int8":
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"K8 int8 output {got.dtype} {tuple(got.shape)}")
            k8_err[dn] = float((got.long() - ref.long()).abs().max())
            log(f"# check K8 dot_probe int8 {k8_shape}: max|diff| "
                f"{k8_err[dn]:.3g}, bound 0 (int32 sums of integers)")
            require(k8_err[dn] == 0, "K8 int8 differs from its plain version")
        else:
            k8_err[dn] = check(f"K8 dot_probe bf16 {k8_shape}", [(got, ref)],
                               K8_BF16_BOUND)
        at = kdp.dot_probe_attrs(lhs.dtype)
        log(f"# K8 attrs {dn}: {at['regs']} registers, {at['local_bytes']} "
            f"local bytes, {at['smem_bytes']} shared bytes")
        require(at["local_bytes"] == 0, f"K8 {dn} uses local memory")
    del got, ref

    # -- phase 3: the main path, three batches through the Renderer --------
    bf = torch.bfloat16
    cfg = default_config()
    cfg["model"]["compute_dtype"] = "bfloat16"
    params = weights.random_params(SEED)
    renderer = Renderer(cfg, *params, device=dev, window=window)
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    outs = []
    for i in range(3):
        out = renderer(batch, geo["lip_x"], geo["lip_y"])
        torch.cuda.synchronize()
        outs.append(out)
        counts = (kmlp.launches, kws.launches, kfb.launches)
        log(f"# render batch {i}: face {tuple(out['face'].shape)} lip "
            f"{tuple(out['lip'].shape)}; launches K1/K2/K3 so far {counts}")
        require(counts == (i + 1, i + 1, 5 * (i + 1)),
                f"kernel launches K1/K2/K3 {counts} after {i + 1} batches")
    launches = {"fused_mlp": kmlp.launches, "window_sample": kws.launches,
                "fused_block": kfb.launches}
    for out in outs:
        for key, shape in (("face", (8, FACE, FACE, 3)),
                           ("lip", (8, LIP_H, LIP_W, 3))):
            require(out[key].shape == shape
                    and bool(torch.isfinite(out[key]).all()),
                    f"{key} {tuple(out[key].shape)} not finite {shape}")
    plain = render_face_batch(
        *renderer.params, batch, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
        lip_h=LIP_H, lip_w=LIP_W, use_kernels=False,
        compute_dtype=torch.bfloat16, window=window)
    for key in ("face", "lip"):
        e = float((outs[0][key] - plain[key]).abs().max())
        log(f"# slice bf16 kernels vs plain path: {key} max|diff| {e:.3g} "
            f"(bound {SLICE_BF16_BOUND})")
        require(e <= SLICE_BF16_BOUND,
                f"slice {key} disagrees with the plain path")

    # the composite's window sample reads the frame's crop and the coord
    # grid's window in place: no copy op between the slices and K2
    from torch.utils._python_dispatch import TorchDispatchMode

    from torch.utils._pytree import tree_leaves

    class OpLog(TorchDispatchMode):
        """The names of the ops dispatched; with ``watch``, only of those
        that read a tensor sharing storage with a watched one."""

        def __init__(self, watch=()):
            super().__init__()
            self.ops = []
            self.storages = {t.untyped_storage().data_ptr() for t in watch}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.storages or any(
                    isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() in self.storages
                    for t in tree_leaves((args, kwargs))):
                self.ops.append(func.__name__)
            return func(*args, **(kwargs or {}))

    frame = torch.rand(8, FACE, FACE, 3, device=dev, generator=gen).to(bf)
    with OpLog() as oplog:
        tf._sample_box_region(frame, batch["coord"][:, wy0:wy0 + wh,
                                                    wx0:wx0 + ww],
                              box, FACE, FACE, use_kernels=True)
    copies = [op for op in oplog.ops
              if op.split(".")[0] in ("clone", "copy_", "_to_copy",
                                      "contiguous")]
    log(f"# composite window sample (kernels): ops {oplog.ops}; copies "
        f"{copies or 'none'}")
    require(not copies, f"the composite copies K2's inputs: {copies}")

    # the training composite's window gather (hat_sample: K2 forward, K7
    # dsrc backward) takes the same views: no copy op reads the crop, the
    # window or the cotangent in either pass; and dsrc on the window view
    # (the coord grid holds the batch innermost) against its plain version
    crop_leaf = frame[:, y0b - 1:y1b + 1, x0b - 1:x1b + 1].detach()
    crop_leaf.requires_grad_(True)
    grid_w = batch["coord"][:, wy0:wy0 + wh, wx0:wx0 + ww]
    k7_geo = (y0b - 1, x0b - 1, FACE, FACE)
    with OpLog(watch=(crop_leaf, grid_w)) as fwd_log:
        out = khs.hat_sample(crop_leaf, grid_w, *k7_geo)
    cot = torch.randn(out.shape, device=dev, generator=gen).to(bf)
    with OpLog(watch=(crop_leaf, grid_w, cot)) as bwd_log:
        (dsrc,) = torch.autograd.grad(out, [crop_leaf], cot)
    copies = [op for op in fwd_log.ops + bwd_log.ops
              if op.split(".")[0] in ("clone", "copy_", "_to_copy",
                                      "contiguous")]
    log(f"# hat_sample on the crop and window views: forward ops "
        f"{fwd_log.ops}, backward ops {bwd_log.ops}; copies "
        f"{copies or 'none'}")
    require(not copies and bwd_log.ops,
            f"hat_sample copies K2's or K7's inputs: {copies}")
    ref = khs.hat_sample_dsrc_plain(grid_w, cot, *crop_leaf.shape[1:3],
                                    *k7_geo)
    check("K7 hat_sample_dsrc bfloat16 window view "
          f"{tuple(grid_w.shape)} strides {grid_w.stride()}", [(dsrc, ref)],
          K7_BOUND["dsrc"][bf])
    del frame, crop_leaf, out, cot, dsrc, ref

    # the slice in float32 on a small input, kernels vs plain path
    small, sgeo = synthetic_batch(2, face=64, lip_h=16, lip_w=24, seed=SEED)
    small = {k: torch.from_numpy(v).to(dev) for k, v in small.items()}
    p32 = weights.random_params(SEED, device=dev)
    kw = dict(lip_x=sgeo["lip_x"], lip_y=sgeo["lip_y"], lip_h=16, lip_w=24)
    got = render_face_batch(*p32, small, use_kernels=True, **kw)
    ref = render_face_batch(*p32, small, use_kernels=False, **kw)
    e = max(float((got[k] - ref[k]).abs().max()) for k in ("face", "lip"))
    log(f"# slice f32 face 64 kernels vs plain path: max|diff| {e:.3g} "
        f"(bound 1e-4)")
    require(e <= 1e-4, "float32 slice disagrees with the plain path")

    # -- phase 3b: K1b's own path, one frame's pixels ----------------------
    tp_bf = weights.random_params(SEED, device=dev, dtype=torch.bfloat16)[0]
    ens = torch.rand(4, LIP_H * LIP_W, 2, device=dev, generator=gen)
    code = torch.randn(1, 64, device=dev, generator=gen).to(torch.bfloat16)
    kmlp.launches = 0
    px = tf.render_pixels(tp_bf, ens, code, 7.0, use_kernels=True)
    torch.cuda.synchronize()
    launches["fused_mlp_one_frame"] = kmlp.launches
    require(kmlp.launches == 1 and px.shape == (4, LIP_H * LIP_W, 3)
            and bool(torch.isfinite(px).all()),
            f"render_pixels: K1 launches {kmlp.launches}, {tuple(px.shape)}")
    log(f"# render_pixels bf16 4x{LIP_H * LIP_W} pixels: K1 launches 1")

    # -- phase 3c: the U-Net's inference entry points, 500x500, batch 8 ----
    _, up_bf, us_bf = weights.random_params(SEED, device=dev, dtype=bf)
    ux = torch.rand(8, FACE, FACE, 3, device=dev, generator=gen).to(bf)
    uref, _ = unet_light.apply(up_bf, us_bf, ux)
    unet_counts = lambda: (kch.conv3x3_launches, kcb.launches,
                           kch.double_conv_launches)
    for fn, kname, want in (
            (unet_light.apply_infer_hcw, "conv3x3_hcw", (10, 0, 0)),
            (unet_light.apply_infer_pallas, "conv3x3_infer", (0, 10, 0)),
            (unet_light.apply_infer_dconv, "double_conv_hcw", (0, 0, 5))):
        kch.conv3x3_launches = kch.double_conv_launches = kcb.launches = 0
        out = fn(up_bf, us_bf, ux)
        torch.cuda.synchronize()
        got = unet_counts()
        log(f"# {fn.__name__} bf16 B=8 {FACE}x{FACE}: launches K4/K6/K5 "
            f"{got}")
        require(got == want, f"{fn.__name__} launches K4/K6/K5 {got}, "
                f"expected {want}")
        launches[kname] = sum(got)
        check(f"{fn.__name__} bf16 vs apply (bf16 cuDNN)", [(out, uref)],
              UNET_BF16_BOUND)
    del out, uref

    # -- phase 3d: static-scene serving, three batches of 8 ----------------
    base = {k: raw[k][0] for k in ("rgb_face_zero", "rgb_face_ori",
                                   "mask_lip_canonical", "coord")}
    static = StaticSceneRenderer(cfg, *params, base, window, geo["lip_x"],
                                 geo["lip_y"], device=dev)
    g = static.geo
    require(static.use_kernels and static.compute_dtype == bf
            and g is not None, "static scene: kernels, bf16 and a crop")
    log(f"# static scene: window {window}, crop {g['ch']}x{g['cw']} at "
        f"({g['cy0']}, {g['cx0']}) = {g['ch'] * g['cw'] / FACE ** 2:.3f} "
        f"of the frame, interior {g['ih']}x{g['iw']} at ({g['iy0']}, "
        f"{g['ix0']})")
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    for i in range(3):
        sout = static(batch["audio"], batch["index"])
        torch.cuda.synchronize()
        counts = (kmlp.launches, kws.launches, kfb.launches)
        log(f"# static batch {i}: face {tuple(sout.shape)}; launches "
            f"K1/K2/K3 so far {counts}")
        require(counts == (i + 1, i + 1, 5 * (i + 1)),
                f"static scene launches K1/K2/K3 {counts} after {i + 1} "
                "batches")
        require(sout.shape == (8, FACE, FACE, 3)
                and bool(torch.isfinite(sout).all()),
                f"static face {tuple(sout.shape)} not finite")
    sfull = static.render_full(batch["audio"], batch["index"])
    inner = (slice(None), slice(g["iy0"], g["iy0"] + g["ih"]),
             slice(g["ix0"], g["ix0"] + g["iw"]))
    gap = float((sout[inner] - sfull[inner]).abs().max())
    gap_scale = max(1.0, float(sfull[inner].abs().max()))
    outside = sout.clone()
    outside[inner] = 0
    require(torch.equal(outside[0], outside[-1]),
            "static scene: the exterior differs between frames")
    log(f"# static scene bf16: crop interior vs render_full max|diff| "
        f"{gap:.3g}, bound {STATIC_GAP_BOUND} x {gap_scale:.3g} "
        "(align-corners upsampling on the crop is not "
        "translation-equivariant)")
    require(gap <= STATIC_GAP_BOUND * gap_scale,
            "static scene: the crop's interior strays from render_full")
    del sout, sfull, outside

    # -- phase 5: the training path ----------------------------------------
    tbatch, tgeo, twin, tparams, tfrozen = train_inputs(
        dev, TRAIN_B, FACE, LIP_H, LIP_W)
    tcfg = dict(default_config()["training"], compute_dtype="bfloat16",
                batch_size=TRAIN_B)
    st = ts.StepStatics(
        lip_h=LIP_H, lip_w=LIP_W, lip_x=tgeo["lip_x"], lip_y=tgeo["lip_y"],
        face_h=FACE, face_w=FACE, focal=tgeo["focal"], window=twin,
        face_bbox=(0, 0, FACE, FACE), compute_dtype="bfloat16",
        depth_loss_box=trainer.depth_loss_box(
            tbatch["mask_head_canonical"][0].cpu().numpy(),
            tbatch["mask_face_canonical"][0].cpu().numpy()),
        pallas_gather=trainer.resolve_pallas_gather(tcfg, dev))
    require(st.pallas_gather and st.depth_loss_box is None
            and twin is not None,
            "the bf16 batch-8 step must take the K7 gathers, the points "
            "path and the warp window")
    opt = ts.make_optimizer(default_config())
    step = ts.make_train_step(opt, st, tfrozen)
    state = ts.init_train_state(*tparams, opt)
    tgen = torch.Generator(device=dev).manual_seed(SEED)
    count = lambda: (kws.launches, khs.dsrc_launches, khs.dgrid_launches,
                     kmlp.launches, kfb.launches)
    # per stage-1 step: K2 twice (the window gather and the depth-loss
    # points, forward), dsrc once (the window gather's source is rendered,
    # its grid is data; a call is khs.DSRC_DEVICE_LAUNCHES[bf] device
    # launches), dgrid once (the points' grid follows the learned depth,
    # their source is data); K1 and K3 serve inference only
    for mod in (kmlp, kws, kfb):
        mod.launches = 0
    khs.dsrc_launches = khs.dgrid_launches = 0
    for i in range(3):
        draws = ts.draw_noise(st, TRAIN_B, device=dev, generator=tgen)
        state, metrics = step(state, tbatch, draws)
        torch.cuda.synchronize()
        got = count()
        log(f"# train step {i} bf16 B={TRAIN_B}: " + ", ".join(
            f"{k} {float(v):.5g}" for k, v in sorted(metrics.items()))
            + f"; launches K2/dsrc/dgrid/K1/K3 so far {got}")
        require(got == (2 * (i + 1), i + 1, i + 1, 0, 0),
                f"train launches K2/dsrc/dgrid/K1/K3 {got} after {i + 1} "
                "steps")
        require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                "non-finite train metrics")
    launches["hat_sample_dsrc"] = khs.dsrc_launches
    launches["hat_sample_dgrid"] = khs.dgrid_launches
    for _, t in named_leaves({"p": state.params, "u": state.unet_params,
                              "s": state.unet_state}):
        require(bool(torch.isfinite(t).all()), "non-finite train state")

    def compare_paths(st_k, params, frozen, batch, bound, what):
        """One step's losses, grad_norm and the canonical-depth and trunk
        gradients, kernel path against plain path."""
        draws = ts.draw_noise(st_k, batch["audio"].shape[0], device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(SEED + 3))
        out = {}
        for use in (True, False):
            g, m, _, tr = ts.loss_and_grads(
                *params, frozen, batch, draws,
                dataclasses.replace(st_k, use_kernels=use))
            names = [n for n, _ in named_leaves(tr)]
            out[use] = (m, dict(zip(names, g)))
        (mk, gk), (mp, gp) = out[True], out[False]
        require(set(mk) == set(mp), "kernel and plain metrics differ")
        worst = 0.0
        for k in sorted(mp):
            e = abs(float(mk[k]) - float(mp[k])) / max(abs(float(mp[k])),
                                                       1e-6)
            log(f"# {what} {k}: kernel {float(mk[k]):.6g} plain "
                f"{float(mp[k]):.6g} rel {e:.3g} (bound {bound})")
            require(e <= bound, f"{what} {k} disagrees with the plain path")
            worst = max(worst, e)
        for n in gp:
            if n == "model.canonical_depth" or n.startswith("model.trunk."):
                a, r = gk[n].float(), gp[n].float()
                e = float((a - r).abs().max()) / max(
                    float(r.abs().max()), 1e-12)
                require(e <= bound and bool(torch.isfinite(a).all()),
                        f"{what} grad {n} rel {e:.3g} > {bound}")
                worst = max(worst, e)
        log(f"# {what}: kernel vs plain path worst rel {worst:.3g} over "
            f"{len(mp)} metrics, canonical_depth and trunk grads")
        return worst

    train_err = compare_paths(st, tparams, tfrozen, tbatch,
                              TRAIN_BOUND[torch.bfloat16],
                              f"train bf16 B={TRAIN_B}")
    # float32 on a small input (the points path forced on)
    sb, sgeo2, swin, sparams, sfrozen = train_inputs(dev, 2, 64, 16, 24)
    st32 = ts.StepStatics(
        lip_h=16, lip_w=24, lip_x=sgeo2["lip_x"], lip_y=sgeo2["lip_y"],
        face_h=64, face_w=64, focal=sgeo2["focal"], window=swin,
        face_bbox=(8, 8, 56, 56), pallas_gather=True)
    compare_paths(st32, sparams, sfrozen, sb, TRAIN_BOUND[torch.float32],
                  "train f32 face 64")

    # the sync stage: SyncNet loss on, U-Net frozen, B*T = 10 frames (the
    # K7 gathers stay on; the trainer's auto gate would leave batch 2 on
    # the plain gathers)
    yb, ygeo, ywin, yparams, yfrozen = train_inputs(
        dev, SYNC_B, FACE, LIP_H, LIP_W, with_sync=True)
    sst = dataclasses.replace(
        st, lip_x=ygeo["lip_x"], lip_y=ygeo["lip_y"], window=ywin,
        sync_on=True, postnet_frozen=True)
    ystep = ts.make_train_step(opt, sst, yfrozen)
    ystate = ts.init_train_state(*yparams, opt)
    before = count()
    ynew, ym = ystep(ystate, yb, ts.draw_noise(sst, SYNC_B, device=dev,
                                               generator=tgen))
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(count(), before))
    log("# sync step bf16 B=2 (10 frames): " + ", ".join(
        f"{k} {float(v):.5g}" for k, v in sorted(ym.items()))
        + f"; launches K2/dsrc/dgrid/K1/K3 {got}")
    # the stage-1 gathers plus the sync window gather (K2 + dsrc)
    require(got == (3, 2, 1, 0, 0), f"sync launches {got}")
    require("loss_sync" in ym and all(bool(torch.isfinite(v))
                                      for v in ym.values()),
            "sync step metrics")
    require(all(torch.equal(a, r) for a, r in zip(
        ts.tree_leaves(ynew.unet_params), ts.tree_leaves(ystate.unet_params))),
        "the frozen U-Net moved")

    # the sync stage as fit runs it at batch 8: the U-Net training, the
    # B*T-frame window gather on K2 and dsrc, against the plain path
    zb, zgeo, zwin, zparams, zfrozen = train_inputs(
        dev, TRAIN_B, FACE, LIP_H, LIP_W, with_sync=True)
    zst = dataclasses.replace(
        st, lip_x=zgeo["lip_x"], lip_y=zgeo["lip_y"], window=zwin,
        sync_on=True, postnet_frozen=False)
    sync_err = compare_paths(zst, zparams, zfrozen, zb,
                             TRAIN_BOUND[torch.bfloat16],
                             f"sync bf16 B={TRAIN_B} "
                             f"({TRAIN_B * zb['audio_window'].shape[1]} "
                             "frames), U-Net training")
    del zb, zparams, zfrozen

    # -- phase 6: the user's loop, cli/train then cli/infer ----------------
    # -- phase 7: serving new audio on phase 6's identity ------------------
    with tempfile.TemporaryDirectory() as tmp:
        loop = user_loop(dev, card, tmp)
        na = new_audio(dev, card, tmp, loop["identity"])
        # -- phase 8: evaluation and the sync teacher on phase 6's identity
        ev = evaluation(dev, card, tmp, loop)
    # -- phase 9: preprocessing at full width through cli/preprocess -------
    with tempfile.TemporaryDirectory() as tmp:
        pre = preprocessing(dev, card, tmp)
    # -- phase 10: the user's tools: converter, pipeline, benches -----------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tools = user_tools(dev, card, tmp)
        tools["s"] = time.perf_counter() - t0

    # -- phase 11: training across processes -------------------------------
    # its children share the card: hand back what the caching allocator
    # keeps of the earlier phases
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        par = training_across_processes(dev, card, tmp)
        par["s"] = time.perf_counter() - t0
    # -- phase 12: the pixel axis, four gloo ranks on the card -------------
    with tempfile.TemporaryDirectory() as tmp:
        pix = pixel_axis(dev, card, tmp)

    # -- phase 3e: the dot probe's tool at its full shape -----------------
    # kdp.launches counts dot_probe calls that reached the card; an int8
    # call launches two kernels, the re-layout of rhs and then the dot
    kdp.launches = 0
    k8_run = k8tool.run(device=dev)
    torch.cuda.synchronize()
    k8_launches = {dn: r["launches"] for dn, r in k8_run.items()}
    log(f"# bench_int8_dot path: K8 launches {k8_launches}, total "
        f"{kdp.launches}")
    require(kdp.launches == 2 * (1 + k8tool.ITERS)
            and all(v == 1 + k8tool.ITERS for v in k8_launches.values()),
            f"bench_int8_dot: K8 calls {k8_launches}, expected "
            f"{1 + k8tool.ITERS} per type")
    for dn, r in k8_run.items():
        ref = kdp.dot_probe_plain(r["lhs"], r["rhs"], k8tool.T)
        if dn == "int8":
            require(torch.equal(r["out"], ref),
                    "bench_int8_dot: int8 output differs from plain")
        else:
            check("bench_int8_dot bf16 output", [(r["out"], ref)],
                  K8_BF16_BOUND)
    del k8_run, ref

    # -- phase 4: timing (bf16, the serving dtype) -------------------------
    # each kernel's ms, its plain version's, one PyTorch library call's
    # computing the same function (None, with a note, where there is none)
    # and the bound from this run's shapes
    rows = {}

    def row(name, ms, plain_ms, library_ms, ops, moved, peak, note=None,
            extra=None):
        b_ms, by = bound(ops, moved, peak)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms,
                      "bound_by": by, **(extra or {})}
        if note:
            rows[name]["library_note"] = note
        lib = f"{library_ms:.4f} ms" if library_ms is not None else note
        log(f"# time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib}; bound {b_ms:.4f} ms by {by} "
            f"({ops / 1e9:.2f} Gop at the {peak} peak, {moved / 1e6:.2f} MB)")

    def timed_turns(name, kernel, library):
        """Call time (eager calls between two events, the host's dispatch
        included) and device time (one CUDA graph of 100 calls, replayed)
        of a kernel and its library call, in turns kernel, library,
        library, kernel; and each one's kernel time in a profile.  Returns
        (kernel call ms, library call ms, the row's extra keys)."""
        t = k2tool.in_turns({"kernel": kernel, "library": library})
        k, lib = t["kernel"], t["library"]
        log(f"# time {name} in turns: call {k['call_ms_turns']} ms, device "
            f"{k['device_ms_turns']} ms, profiled {k['profiled_ms']}; "
            f"library call {lib['call_ms_turns']} ms, device "
            f"{lib['device_ms_turns']} ms, profiled {lib['profiled_ms']}")
        return k["call_ms"], lib["call_ms"], {
            "device_ms": k["device_ms"], "profiled_ms": k["profiled_ms"],
            "library_device_ms": lib["device_ms"],
            "library_profiled_ms": lib["profiled_ms"]}

    def mlp_row(name, a):
        """K1 / K1b: uv [N, 42] through the input and skip projections
        once, the trunk and head per frame."""
        out = kmlp.fused_mlp(*a)
        trunk = list(a[5]) + [a[7]]
        ops = 2.0 * a[0].shape[0] * (a[3].numel() + a[4].numel()
                                     + a[1].shape[0] * sum(w.numel()
                                                           for w in trunk))
        row(name, cuda_ms(lambda: kmlp.fused_mlp(*a)),
            cuda_ms(lambda: kmlp.fused_mlp_plain(*a)), None, ops,
            nbytes(a[0], a[1], a[2], a[3], a[4], *a[5], *a[6], a[7], a[8],
                   out), "bf16",
            note="none: no single PyTorch call runs the 9-layer MLP with "
                 "per-frame biases")

    mlp_row("fused_mlp", k1_args(bf))
    a = k1_args(bf, frames=1)
    mlp_row("fused_mlp_one_frame",
            (fourier_embed(ens.reshape(-1, 2), 10).to(bf),) + a[1:])

    # K2 on the composite's views; grid_sample takes one dtype for source
    # and grid: float32 copies of the crop and the window, made outside
    # the timed call
    a = k2_args(bf)
    src, grid = a[0], a[1]
    out = kws.window_sample(*a)
    src32 = src.float().permute(0, 3, 1, 2).contiguous()
    g4 = k2tool.crop_grid(grid.reshape(8, -1, 2), *a[2:], *src.shape[1:3])
    lib = lambda: F.grid_sample(src32, g4, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
    log(f"# K2 vs F.grid_sample on the crop: max|diff| "
        f"{float((lib()[:, :, 0].transpose(1, 2) - out.float()).abs().max()):.3g}")
    k_ms, l_ms, extra = timed_turns(
        "K2 window_sample", lambda: kws.window_sample(*a), lib)
    row("window_sample", k_ms, cuda_ms(lambda: kws.window_sample_plain(*a)),
        l_ms, 8.0 * src.shape[3] * out.shape[0] * out.shape[1],
        nbytes(src, grid, out), "f32", extra=extra)

    # K3's plain version (float32 convs) is its correctness oracle; the
    # plain path serves each block as bf16 cuDNN convs (unet_light.apply's
    # upsample, concat, DoubleConv and pool), timed beside it
    def plain_path_block(name, x, lo, pool):
        if lo is not None:
            x = torch.cat([x, tnn.upsample_bilinear(lo, *x.shape[1:3])], -1)
        y, _ = unet_light._double_conv(up_bf[name], us_bf[name], x)
        return (y, tnn.maxpool2d(y)) if pool else y

    # the mid activation's round trip through device memory (written by
    # the first launch, read by the second), timed at the HBM rate: what
    # one launch per block (ROADMAP B1) could save at most
    t_k3, ops, moved, mid_bytes = [0.0, 0.0, 0.0], 0.0, 0, 0
    for name, args, kw in k3_cases(bf):
        x, w1, w2 = args[0], args[1], args[4]
        outs = kfb.fused_block(*args, **kw)
        ops += conv_ops(x, w1.shape[2], w1.shape[3]) + conv_ops(
            x, w2.shape[2], w2.shape[3])
        moved += nbytes(*args, kw["up"], *(outs if kw["pool"] else (outs,)))
        mb = 2 * x.numel() // x.shape[3] * w1.shape[3] * x.element_size()
        mid_bytes += mb
        tk = cuda_ms(lambda: kfb.fused_block(*args, **kw), iters=5)
        tp = cuda_ms(lambda: kfb.fused_block_plain(*args, **kw), iters=5)
        tc = cuda_ms(lambda: plain_path_block(name, args[0], kw["up"],
                                              kw["pool"]), iters=5)
        log(f"# time K3 {name} bf16 B=8: kernel {tk:.3f} ms, plain "
            f"(float32 convs) {tp:.3f} ms, plain path (bf16 cuDNN) "
            f"{tc:.3f} ms; mid round trip {mb / 1e6:.1f} MB = "
            f"{1e3 * mb / HBM_BYTES_PER_S:.3f} ms at the HBM rate")
        t_k3 = [t_k3[0] + tk, t_k3[1] + tp, t_k3[2] + tc]
    log(f"# time K3 bf16 B=8 five blocks: kernel {t_k3[0]:.3f} ms, plain "
        f"path (bf16 cuDNN) {t_k3[2]:.3f} ms; mid round trips "
        f"{mid_bytes / 1e6:.1f} MB = "
        f"{1e3 * mid_bytes / HBM_BYTES_PER_S:.3f} ms at the HBM rate")
    row("fused_block", t_k3[0], t_k3[1], None, ops, moved, "bf16",
        note="none: no single PyTorch call fuses the upsample, concat, two "
             "convs, BatchNorm, ReLU and pool")

    # K4 and K6 (one kernel behind two wrappers) over the ten convs, K5
    # over the five DoubleConvs; library: cuDNN channels-last convs with
    # the scale folded into the weights (ReLU not included)
    t4 = t6 = tp = tl = ops = 0.0
    moved = 0
    t_pair = []
    for name, (x, w, sc, bi) in conv_cases(bf):
        k4 = cuda_ms(lambda: kch.conv3x3_hcw(x, w, sc, bi), iters=5)
        t4 += k4
        t6 += cuda_ms(lambda: kcb.conv3x3_infer(x, w, sc, bi), iters=5)
        tp += cuda_ms(lambda: kfb.conv3x3_affine_plain(x, w, sc, bi),
                      iters=5)
        lib_ms = cuda_ms(library_conv(x, w, sc, bi), iters=5)
        tl += lib_ms
        ops += conv_ops(x, w.shape[2], w.shape[3])
        moved += nbytes(x, w, sc, bi) + x.numel() // x.shape[3] * \
            w.shape[3] * x.element_size()
        t_pair.append(k4)
        log(f"# time conv {name} {tuple(x.shape)}->{w.shape[3]} bf16: K4 "
            f"{k4:.3f} ms, cuDNN {lib_ms:.3f} ms ({k4 / lib_ms:.2f}x), "
            f"{conv_ops(x, w.shape[2], w.shape[3]) / k4 / 1e9:.1f} TFLOP/s")
    log(f"# time K4 bf16 ten convs: {t4:.3f} ms against ten cuDNN convs "
        f"{tl:.3f} ms ({t4 / tl:.3f}x), {ops / t4 / 1e9:.1f} TFLOP/s")
    row("conv3x3_hcw", t4, tp, tl, ops, moved, "bf16")
    row("conv3x3_infer", t6, tp, tl, ops, moved, "bf16")
    t5 = tp = tl = ops = 0.0
    moved = 0
    traffic = [0.0, 0.0]
    for i, (name, args) in enumerate(dconv_cases(bf)):
        x, w1, s1, b1, w2, s2, b2 = args
        k5 = cuda_ms(lambda: kch.double_conv_hcw(*args), iters=5)
        t5 += k5
        tp += cuda_ms(lambda: kch.double_conv_hcw_plain(*args), iters=5)
        c1 = library_conv(x, w1, s1, b1)
        mid = c1().permute(0, 2, 3, 1)
        c2 = library_conv(mid, w2, s2, b2)
        lib_ms = cuda_ms(lambda: (c1(), c2()), iters=5)
        tl += lib_ms
        d_ops = conv_ops(x, w1.shape[2], w1.shape[3]) + conv_ops(
            mid, w2.shape[2], w2.shape[3])
        d_moved = nbytes(*args) + mid.numel() // mid.shape[3] * \
            w2.shape[3] * x.element_size()
        ops += d_ops
        moved += d_moved
        d_bound, d_by = bound(d_ops, d_moved, "bf16")
        wt = [k5_weight_bytes(x.shape, w1.shape[3], w2.shape[3], t)
              for t in ("bf16", "14x14")]
        traffic = [traffic[0] + wt[0], traffic[1] + wt[1]]
        log(f"# time DoubleConv {name} {tuple(x.shape)} bf16: K5 {k5:.3f} "
            f"ms, two K4 launches {t_pair[2 * i] + t_pair[2 * i + 1]:.3f} "
            f"ms, two cuDNN convs {lib_ms:.3f} ms, bound {d_bound:.3f} ms "
            f"by {d_by}; weights from L2 {wt[0] / 1e9:.3f} GB (14x14 "
            f"tiles: {wt[1] / 1e9:.3f} GB)")
    log(f"# time K5 bf16 five DoubleConvs: {t5:.3f} ms against ten K4 "
        f"launches {sum(t_pair):.3f} ms and two cuDNN convs each {tl:.3f} "
        f"ms; weights from L2 {traffic[0] / 1e9:.3f} GB (14x14 tiles: "
        f"{traffic[1] / 1e9:.3f} GB)")
    row("double_conv_hcw", t5, tp, tl, ops, moved, "bf16")
    del mid
    # float32 K5 (the 3xTF32 WMMA body): a log line only
    t5_f32 = 0.0
    for name, args in dconv_cases(torch.float32):
        k5 = cuda_ms(lambda: kch.double_conv_hcw(*args), iters=3)
        t5_f32 += k5
        log(f"# time DoubleConv {name} {tuple(args[0].shape)} float32: K5 "
            f"{k5:.3f} ms")
    log(f"# time K5 float32 five DoubleConvs: {t5_f32:.3f} ms")
    del args
    torch.cuda.empty_cache()

    # K7 at the main path's shapes: dsrc on the window gather as the train
    # step hands it over (the window view, the cotangent zero off the lip
    # box), dgrid on the depth-loss points; library:
    # aten.grid_sampler_2d_backward on float32 copies (one dtype for
    # source and grid)
    cases = k7tool.cases(dev, bf)
    backward = torch.ops.aten.grid_sampler_2d_backward
    k7_local = {}
    for which in ("dsrc", "dgrid"):
        for dtype in (bf, torch.float32):
            at = khs.attrs(which, dtype == bf)
            log(f"# K7 attrs {which} {str(dtype).split('.')[1]}: "
                f"{at['regs']} registers, {at['local_bytes']} local bytes, "
                f"{at['smem_bytes']} static shared bytes")
            require(dtype != bf or at["local_bytes"] == 0,
                    f"K7 {which} bf16 uses local memory")
            if dtype == bf:
                k7_local[which] = at["local_bytes"]
    for kern, case, mask, per_call_expected in (
            ("dsrc", "train", [True, False], khs.DSRC_DEVICE_LAUNCHES[bf]),
            ("dgrid", "points", [False, True], 1)):
        src, grid, cot, g_geo = cases[case]
        if kern == "dsrc":
            kernel = lambda: khs.hat_sample_dsrc(grid, cot, FACE, FACE,
                                                 *g_geo)
            plain = lambda: khs.hat_sample_dsrc_plain(grid, cot, FACE, FACE,
                                                      *g_geo)
        else:
            kernel = lambda: khs.hat_sample_dgrid(src, grid, cot, *g_geo)
            plain = lambda: khs.hat_sample_dgrid_plain(src, grid, cot,
                                                       *g_geo)
        out = kernel()
        src32 = src.float().permute(0, 3, 1, 2).contiguous()
        g4 = k2tool.crop_grid(grid.reshape(8, -1, 2), *g_geo, FACE, FACE)
        cot32 = cot.float().transpose(1, 2)[:, :, None].contiguous()
        k_ms, l_ms, extra = timed_turns(
            f"K7 hat_sample_{kern} {case}", kernel,
            lambda: backward(cot32, src32, g4, 0, 0, False, mask))
        # a call's device launches (dsrc: zero-fill, scatter, cast): the
        # nodes of a graph of one call; a profile of a few calls logs the
        # kernels' device time
        profile_steps(kernel, f"K7 hat_sample_{kern} calls", steps=5)
        kinds = graph_launches(kernel)
        per_call = sum(kinds.values())
        log(f"# K7 hat_sample_{kern} call as a CUDA graph: {kinds}")
        require(set(kinds) <= set(GRAPH_NODE_KINDS.values())
                and per_call == per_call_expected, f"a {kern} call issues "
                f"{kinds} on the device, expected {per_call_expected} "
                "launches")
        extra.update(device_launches_per_call=per_call,
                     local_bytes=k7_local[kern])
        # the work of the points whose cotangent is nonzero; dgrid reads 4
        # taps of each point, not the whole source
        live = int((cot != 0).any(-1).sum())
        if kern == "dsrc":
            ops, moved = 8.0 * live * cot.shape[-1], nbytes(grid, cot, out)
        else:
            ops = 16.0 * live * cot.shape[-1]
            moved = min(nbytes(src), 4 * nbytes(cot)) + nbytes(grid, cot,
                                                                 out)
        log(f"# K7 {kern} {case}: grid {tuple(grid.shape)} strides "
            f"{grid.stride()}, {live} of {cot.shape[0] * cot.shape[1]} "
            f"points with a nonzero cotangent")
        row(f"hat_sample_{kern}", k_ms, cuda_ms(plain), l_ms, ops, moved,
            "f32", extra=extra)
    del cases, src, src32, out

    # K8 at the probe's shape.  Library: one cuBLAS call doing the same
    # 2*M*K*N*G*T operations, lhs tiled to [T*M, G*K] (materialised) times
    # rhs as [G*K, N]: torch.matmul in bf16 (bf16 output, half K8's output
    # bytes), torch._int_mm in int8 (rhs given column-major, the layout
    # cuBLASLt's int8 kernels take, made outside the timed call).  The
    # plain version computes one [M, N] tile and repeats it (1/T of the
    # operations).  An int8 call also moves the re-laid rhs [G, N, K]: its
    # re-layout launch writes it once and the dot reads it once
    m8, k8, n8, g8, t8 = (k8tool.M, k8tool.K, k8tool.N, k8tool.G, k8tool.T)
    ops8 = 2.0 * m8 * k8 * n8 * g8 * t8
    k8_rate = {}
    for dn, (lhs, rhs) in k8_in.items():
        out = kdp.dot_probe(lhs, rhs, t8)
        a_t = lhs.repeat(t8, g8)
        b_f = rhs.reshape(g8 * k8, n8)
        if dn == "int8":
            b_f = b_f.t().contiguous().t()
            lib = lambda: torch._int_mm(a_t, b_f)
            note = ("torch._int_mm (cuBLASLt s8 x s8 -> s32), lhs tiled to "
                    "[T*M, G*K], rhs column-major [G*K, N]")
        else:
            lib = lambda: torch.matmul(a_t, b_f)
            note = ("torch.matmul (cuBLAS), lhs tiled to [T*M, G*K], rhs "
                    "[G*K, N]; bf16 output, half K8's output bytes")
        lref = lib()
        log(f"# K8 {dn} vs the library call, program 0: max|diff| "
            f"{float((lref[:m8].double() - out[0].double()).abs().max()):.3g}")
        del lref
        km = cuda_ms(lambda: kdp.dot_probe(lhs, rhs, t8))
        pm = cuda_ms(lambda: kdp.dot_probe_plain(lhs, rhs, t8))
        lm = cuda_ms(lib)
        moved = nbytes(lhs, rhs, out) + (2 * rhs.numel() if dn == "int8"
                                         else 0)
        row(f"dot_probe_{dn}", km, pm, lm, ops8, moved, dn, note=note)
        unit = "TOP/s" if dn == "int8" else "TFLOP/s"
        k8_rate[dn] = ops8 / km / 1e9
        log(f"# time K8 {dn}: {k8_rate[dn]:.1f} {unit} ({ops8 / lm / 1e9:.1f} "
            f"library); kernel / library time {km / lm:.3f}x; "
            f"{100 * k8_rate[dn] * 1e12 / PEAK[dn]:.1f}% of the peak")
    log(f"# time K8 int8 / bf16 rate: {k8_rate['int8'] / k8_rate['bf16']:.3f}x "
        f"on {card}")
    del a_t, b_f, out

    # the U-Net entry points at 500x500, batch 8
    for name, fn in (("apply_infer_hcw (10 K4)", unet_light.apply_infer_hcw),
                     ("apply_infer_pallas (10 K6)",
                      unet_light.apply_infer_pallas),
                     ("apply_infer_dconv (5 K5)", unet_light.apply_infer_dconv),
                     ("apply_infer_fused (5 K3)", unet_light.apply_infer_fused),
                     ("apply (bf16 cuDNN)",
                      lambda p, s, x: unet_light.apply(p, s, x)[0])):
        ms = cuda_ms(lambda: fn(up_bf, us_bf, ux), iters=5, warmup=1)
        log(f"# time U-Net {name} bf16 B=8 {FACE}x{FACE}: {ms:.3f} ms = "
            f"{8000 / ms:.1f} frames/s")
    del ux

    # the train step at batch 8, bf16, kernel path and plain path in turns
    draws = ts.draw_noise(st, TRAIN_B, device=dev, generator=tgen)
    plain_step = ts.make_train_step(
        opt, dataclasses.replace(st, use_kernels=False), tfrozen)
    t_train = {True: [], False: []}
    for use in (False, True, True, False):
        fn = step if use else plain_step
        t_train[use].append(cuda_ms(lambda: fn(state, tbatch, draws),
                                    iters=3, warmup=1))
    t_train = {k: sum(v) / len(v) for k, v in t_train.items()}
    log(f"# train step bf16 batch {TRAIN_B}: {t_train[True]:.2f} ms/step = "
        f"{TRAIN_B * 1000 / t_train[True]:.1f} frames/s (plain path "
        f"{t_train[False]:.2f} ms = {TRAIN_B * 1000 / t_train[False]:.1f} "
        f"frames/s) on {card}")

    # the plain path's profile measures what the plain K2/K7 versions
    # cost inside the step, where dsrc's cotangent is zero off the lip box
    dev_k, _ = profile_steps(lambda: step(state, tbatch, draws),
                             f"train step bf16 B={TRAIN_B}")
    dev_p, _ = profile_steps(lambda: plain_step(state, tbatch, draws),
                             f"plain-path train step bf16 B={TRAIN_B}")
    log(f"# profile device time per step, plain path minus kernel path: "
        f"{dev_p - dev_k:.3f} ms")

    # serving throughput: the Renderer (full-frame U-Net) and the
    # StaticSceneRenderer (U-Net on the crop) at the same batches
    for bsz in (8, 32, 64):
        bb = batch if bsz == 8 else {
            k: v.repeat(bsz // 8, *([1] * (v.dim() - 1)))
            for k, v in batch.items()}
        iters = 5 if bsz == 8 else 3
        ms = cuda_ms(lambda: renderer(bb, geo["lip_x"], geo["lip_y"]),
                     iters=iters, warmup=1)
        pms = cuda_ms(lambda: render_face_batch(
            *renderer.params, bb, lip_x=geo["lip_x"], lip_y=geo["lip_y"],
            lip_h=LIP_H, lip_w=LIP_W, use_kernels=False,
            compute_dtype=torch.bfloat16, window=window),
            iters=iters, warmup=1)
        log(f"# slice bf16 batch {bsz}: {ms:.2f} ms/batch = "
            f"{bsz * 1000 / ms:.1f} frames/s (plain path {pms:.2f} ms = "
            f"{bsz * 1000 / pms:.1f} frames/s) on {card}")
        if bsz <= 32:
            sms = cuda_ms(lambda: static(bb["audio"], bb["index"]),
                          iters=iters, warmup=1)
            log(f"# static scene bf16 batch {bsz}: {sms:.2f} ms/batch = "
                f"{bsz * 1000 / sms:.1f} frames/s ({ms / sms:.2f}x the "
                f"Renderer) on {card}")
        if bsz == 8:
            dev_ms, n_launch = profile_steps(
                lambda: renderer(bb, geo["lip_x"], geo["lip_y"]),
                "Renderer bf16 batch 8", steps=3)
            log(f"# Renderer bf16 batch 8: {n_launch} kernel launches and "
                f"{dev_ms:.2f} ms of device time a batch")
            profile_steps(lambda: static(bb["audio"], bb["index"]),
                          "static scene bf16 batch 8", steps=3)
        del bb

    pallas = "speech2lip_tpu/ops/pallas/"
    tool_launches = {"pipeline_fit": tools["pipeline_fit"],
                     "pipeline_infer": tools["pipeline_infer"],
                     "bench_train": tools["bench_train_launches"],
                     "bench_components": tools["bench_components_launches"]}
    kernels = []
    for name, source, replaces, path in (
            ("fused_mlp", "fused_mlp.cu", "fused_mlp.py:80", "render"),
            ("window_sample", "window_sample.cu", "window_sample.py:114",
             "render"),
            ("fused_block", "fused_block.cu", "conv_hcw.py:867", "render"),
            ("fused_mlp_one_frame", "fused_mlp.cu", "fused_mlp.py:153",
             "render_pixels"),
            ("hat_sample_dsrc", "hat_sample.cu", "hat_sample.py:143", "train"),
            ("hat_sample_dgrid", "hat_sample.cu", "hat_sample.py:174",
             "train"),
            ("conv3x3_hcw", "fused_block.cu", "conv_hcw.py:207",
             "apply_infer_hcw"),
            ("double_conv_hcw", "double_conv.cu", "conv_hcw.py:403",
             "apply_infer_dconv"),
            ("conv3x3_infer", "fused_block.cu", "conv_block.py:63",
             "apply_infer_pallas")):
        by_path = {p: loop[p][name] for p in ("fit", "cli_infer")
                   if loop[p].get(name)}
        by_path.update({p: na[p][name] for p in NEW_AUDIO_PATHS
                        if na[p].get(name)})
        by_path.update({p: ev[p][name] for p in EVAL_PATHS
                        if ev[p].get(name)})
        by_path.update({p: tool_launches[p][name] for p in TOOLS_PATHS
                        if tool_launches[p].get(name)})
        by_path.update({p: par[p][name] for p in ("fit_ranks", "mesh_server")
                        if par[p].get(name)})
        kernels.append({"name": name, "route": "cuda",
                        "source": f"speech2lip_tpu_torch/csrc/{source}",
                        "replaces": pallas + replaces, "path": path,
                        "launches": launches[name],
                        "launches_by_path": dict({path: launches[name]},
                                                 **by_path),
                        "max_abs_err": errs[(name, bf)], **rows[name]})
    for dn in ("bf16", "int8"):
        kernels.append({"name": f"dot_probe_{dn}", "route": "cuda",
                        "source": "speech2lip_tpu_torch/csrc/dot_probe.cu",
                        "replaces": "tools/bench_int8_dot.py:44",
                        "path": "bench_int8_dot",
                        "launches": k8_launches[dn],
                        "max_abs_err": k8_err[dn], **rows[f"dot_probe_{dn}"]})
    require(len(kernels) == 11 and all(k["launches"] > 0 for k in kernels),
            "a kernel was not launched on its path")
    log(f"# train bf16 kernel vs plain path worst rel {train_err:.3g}; "
        f"sync stage (U-Net training) {sync_err:.3g}; fit's validation "
        f"frame (K1 f32) max|diff| {loop['val_frame_err']:.3g}")
    for name in ("stage 1", "sync"):
        f = loop[f"fit_{name}"]
        log(f"# fit {name} bf16 batch {TRAIN_B} at May geometry: "
            f"{f['batch_ms'] + f['step_ms']:.1f} ms/iteration = batch build "
            f"{f['batch_ms']:.1f} ms + step {f['step_ms']:.1f} ms "
            f"(median of its {f['iters']}; checkpoints and validation "
            f"excluded) on {card}")
    for i in range(len(LOOP_ITERS)):
        g = loop[f"fit_run{i}_wall_ms"]
        log(f"# fit run {i} wall ms/iteration, all included: mean "
            f"{sum(g) / len(g):.1f} over {len(g)} gaps, max {max(g):.1f} "
            f"on {card}")
    log(f"# cli/infer bf16 batch {TRAIN_B}: {loop['cli_infer_fps']:.1f} "
        f"frames/s end to end, render {loop['cli_infer_render_fps']:.1f} "
        f"frames/s on {card}")
    log(f"# DeepSpeech a {NA_SECONDS} s request: {na['ds_ms']:.1f} ms, the "
        f"MFCC {na['ds_mfcc_ms']:.1f} ms, the RNN {na['ds_rnn_ms']:.1f} ms; "
        f"card vs CPU max|diff| {na['ds_err']:.3g} (with TF32 allowed "
        f"{na['ds_tf32_err']:.3g}) on {card}")
    for tag in ("serve", "serve_static"):
        log(f"# cli/{tag.replace('_', ' --')} bf16 batch {SERVE_B}: "
            f"{na[tag + '_fps']:.1f} frames/s end to end, render "
            f"{na[tag + '_render_fps']:.1f} frames/s; a served batch "
            f"kernels vs plain {na[tag + '_err']:.3g} on {card}")
    for tag in ("bench_serving", "bench_serving_static"):
        r = na[tag + "_rec"]
        log(f"# {tag}: {r['identities']} identities x batch "
            f"{r['batch_per_identity']} at {r['face']}^2: {r['value']:.1f} "
            f"frames/s aggregate, wave latency p50 "
            f"{r['wave_latency_ms_p50']:.1f} ms, max "
            f"{r['wave_latency_ms_max']:.1f} ms; identity 0's wave kernels "
            f"vs plain {na[tag + '_err']:.3g} on {card}")
    log(f"# cli/infer --change_pose bf16 batch {TRAIN_B}: "
        f"{na['pose_fps']:.1f} frames/s end to end, render "
        f"{na['pose_render_fps']:.1f} frames/s; kernels vs plain "
        f"{na['pose_err']:.3g} on {card}")
    log(f"# SyncNet teacher, cli/train_syncnet {' '.join(TEACHER_ARGS)}: "
        f"{ev['teacher_ms_per_step']:.1f} ms a step, bce "
        f"{ev['teacher_bce'][0]:.4f} -> {ev['teacher_bce'][-1]:.4f}, sync "
        f"conf {ev['teacher_conf']:.4f} on {card}")
    log(f"# cli/evaluate --lms-from-fan --sync at {FACE}^2: "
        f"{ev['evaluate_card_fps']:.2f} frames/s on the card, "
        f"{ev['evaluate_cpu_fps']:.2f} on the CPU; card vs CPU "
        f"{ev['evaluate_err']} on {card}")
    by_part = ", ".join(f"{k} {v:.2f}"
                        for k, v in ev["convergence_parts"].items())
    log(f"# convergence_run at May width: {ev['convergence_s']:.1f} s, by "
        f"part (s): {by_part}; launches fit {ev['convergence_fit']}, infer "
        f"{ev['convergence_infer']} on {card}")
    steps = pre["summaries"]
    log("# preprocessing wall s by cli/preprocess step: " + ", ".join(
        f"{k} {v['wall_s']:.2f}" for k, v in steps.items())
        + f"; tracker phases (s) {steps['track']['track_timings']}; "
        f"{pre['lms_step_ms']:.2f} ms a landmark Adam step, "
        f"{pre['photo_iter_ms']:.1f} ms a photometric iteration ({PRE_N} "
        f"frames at {PRE_SIZE}^2); landmarks (DSFD + FAN) "
        f"{pre['landmarks_fps']:.2f} frames/s, (S3FD + FAN) "
        f"{pre['landmarks_s3fd_fps']:.2f}, warp {pre['warp_fps']:.1f} "
        f"frames/s; find_focal (3 candidates) {pre['find_focal_s']:.2f} s; "
        f"rasterizer overflow {pre['overflow']} on {card}")
    rep = tools["pipeline_report"]
    log(f"# user tools (phase 10) {tools['s']:.1f} s: weights synthesized "
        f"{tools['weights_synth_s']:.1f} s, converted "
        f"{tools['convert_s']:.1f} s (nets card vs CPU "
        f"{ {k: float(f'{v:.3g}') for k, v in tools['nets'].items()} }, "
        f"converted Renderer {tools['converted_render_err']:.3g}; DSFD on "
        f"noise vs float64 {tools['dsfd_noise_f64']}); pipeline "
        f"{tools['pipeline_s']:.1f} s, wall s by step "
        + ", ".join(f"{k} {v:.2f}" for k, v in tools["pipeline_parts"].items())
        + f"; focal {rep['focal_found']} (true {rep['focal_true']}); val "
        f"PSNR {[round(t['psnr'], 3) for t in rep['val_psnr_trajectory']]}; "
        f"rendered {rep['rendered_val_metrics']}; fit ms an iteration "
        f"{[round(g, 1) for g in tools['pipeline_fit_ms']]}; bench_train "
        f"{tools['bench_train_s']:.1f} s, bench_components "
        f"{tools['bench_components_s']:.1f} s on {card}")
    for r in tools["bench_train"]:
        log(f"# bench_train {r['case']} {r['dtype']}: " + (
            r["error"] if r.get("error") else
            f"{r['ms_per_step']:.2f} ms/step, {r['ms_per_frame']:.2f} "
            f"ms/frame") + f" on {card}")
    log("# bench_components batch 32 bf16 ms: " + ", ".join(
        f"{k} {v['ms']:.3f}" + (f" (kernels vs plain {v['err']:.3g})"
                                 if "err" in v else "")
        for k, v in tools["bench_components"].items()) + f" on {card}")
    log(f"# training across processes (phase 11) {par['s']:.1f} s: C1 fit "
        f"card vs CPU {par['c1_err']}; fit s no group / one NCCL rank "
        f"{par['fit_s']}; gradients {par['grad_bytes']} bytes, flat "
        f"all-reduce NCCL one rank {par['nccl1_allreduce_ms']:.4f} ms, gloo "
        f"two ranks {par['gloo_flat_ms']:.3f} ms; two-rank fit "
        f"{par['gloo_fit_err']} (vs float64 {par['gloo_fit_f64_err']}) / "
        f"step {par['gloo_step_err']:.3g} vs one "
        f"rank; distributed fit launches a rank over {par['fit_launches_its']}"
        f" iterations {par['fit_ranks']}; sharded server launches "
        f"{par['mesh_server']} on {card}")
    log(f"# the pixel axis (phase 12) {pix['wall_s']:.1f} s, {pix['world']} "
        f"gloo ranks sharing the card: " + "; ".join(
            f"{k} err {v['err']:.3g} ms {[round(x, 1) for x in v['ms']]}"
            if "err" in v else f"{k} ms {v['ms']:.1f}"
            for k, v in pix["steps"].items()) + f" on {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job(sys.argv[2]))
    sys.exit(main())
