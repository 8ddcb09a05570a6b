"""Train a SyncNet lip-sync expert on one identity's ground-truth frames
(counterpart of ``speech2lip_tpu/train/syncnet_pretrain.py``).

The sync stage's teacher and ``cli/evaluate --sync``'s scorer is a
Wav2Lip ``SyncNet_color`` (``models/syncnet.py``).  This module trains one
on the identity itself with the sync stage's own cosine-BCE objective:
positives pair a mel window with the 5-frame face window it voices,
negatives pair the same faces with a mel window at least 3 frames away
(mod the window count, in both directions).

Face windows are built as the student's positive branch builds them: the
canonical ``face_bbox`` crop of ``ori_images_face``, resized to 96² by
cv2, BGR, the lower half, 5 frames stacked along channels.  Only the train
split is used, so a val-split sync score against this teacher measures
generalisation.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_sync_arrays", "pretrain_teacher"]


def build_sync_arrays(cfg: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(windows [W, 48, 96, 15], mels [W, 80, 16]) float32 from the train
    split: window w covers frames w..w+4 and the mel window centred at
    frame w+2 (the dataset's sync-extras geometry)."""
    import cv2

    from speech2lip_tpu_torch.ops import audio_dsp

    d = cfg["data"]
    root = d["path"]
    faces_dir = os.path.join(root, "ori_images_face")
    files = sorted(f for f in os.listdir(faces_dir)
                   if f.endswith(d.get("extension", ".jpg")))
    n_val = int(d.get("val_split_frames", 0))
    files = files[: len(files) - n_val] if n_val else files

    bbox = None
    bbox_path = os.path.join(root, "face_bbox_dict.npy")
    if os.path.exists(bbox_path):
        bd = np.load(bbox_path, allow_pickle=True).item()
        key = "{:05d}.jpg".format(int(d.get("canonical_idx", 0)) + 1)
        if key in bd:
            bbox = [int(v) for v in bd[key][:4]]

    frames = []
    for f in files:
        img = cv2.imread(os.path.join(faces_dir, f))  # BGR uint8
        if bbox is not None:
            x, y, x2, y2 = bbox
            img = img[y:y2, x:x2]
        frames.append(cv2.resize(img, (96, 96)).astype(np.float32) / 255.0)
    frames = np.stack(frames)  # [N, 96, 96, 3] BGR

    wav = audio_dsp.load_wav(os.path.join(root, "audio", "audio.wav"))
    mel = audio_dsp.melspectrogram(wav, fmin=d.get("mel_fmin", 55.0)).T

    windows, mels = [], []
    for i in range(len(frames) - 4):
        win = frames[i:i + 5, 48:, :, :]  # the lower half, already BGR
        windows.append(win.transpose(1, 2, 0, 3).reshape(48, 96, 15))
        mels.append(audio_dsp.crop_audio_window(mel, i + 2).T)  # [80, 16]
    return (np.stack(windows).astype(np.float32),
            np.stack(mels).astype(np.float32))


def pretrain_teacher(cfg: Dict, steps: int = 400, batch: int = 16,
                     lr: float = 1e-4, seed: int = 0, log_every: int = 50,
                     log=print, device=None, init=None,
                     draws: Optional[Sequence] = None):
    """Train the expert; returns ((params, state), loss history).

    A step takes ``batch`` positives and ``batch`` negatives, BatchNorm in
    train mode, and one Adam update.  ``init`` is a (params, state) to
    start from (default ``weights.init_syncnet(seed)``); ``draws`` gives
    each step's (pos, shift) index vectors (default: drawn from a
    ``torch.Generator`` seeded with ``seed``, pos in [0, n), shift in
    [3, n-4]).  The loss is logged at every ``log_every``-th step and the
    last.  ``core/checkpoint.save(path, (params, state))`` writes what the
    sync stage and ``cli/evaluate --sync`` of either package load.

    On the card the steps run in float32 without TF32 and on deterministic
    cuDNN algorithms (the previous settings are restored after), so one
    seed gives one teacher there, as it does on the CPU.  The teacher
    never sees offsets of 1-2 frames as negatives, so where it peaks among
    them is decided by float32 noise: an atomics-ordered run can move the
    peak (ROADMAP C)."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.models import syncnet
    from speech2lip_tpu_torch.train import losses
    from speech2lip_tpu_torch.train import train_step as ts

    device = resolve_device(device)
    windows_np, mels_np = build_sync_arrays(cfg)
    n = len(windows_np)
    if n < 7:
        # a negative must stay >= 3 windows from its positive after the
        # mod-n wrap on both sides: shift in [3, n-4] needs n >= 7
        raise ValueError(
            f"need >= 7 sync windows for >=3-frame negative sampling, got "
            f"{n}; provide a longer clip or lower the sync window stride")
    windows = torch.from_numpy(windows_np).to(device)
    mels = torch.from_numpy(mels_np).to(device)[..., None]

    params, state = init if init is not None else weights.init_syncnet(
        seed, device)
    leaves = [p.detach().to(device).requires_grad_()
              for p in ts.tree_leaves(params)]
    state = ts.tree_map(lambda t: t.to(device), state)
    opt = ts.Adam(lr)
    opt_state = opt.init(leaves)
    gen = torch.Generator().manual_seed(seed)
    y = torch.cat([torch.ones(batch), torch.zeros(batch)]).to(device)

    def step(pos, shift, leaves, state, opt_state):
        face_idx = torch.cat([pos, pos])
        mel_idx = torch.cat([pos, torch.remainder(pos + shift, n)])
        p = ts.tree_unflatten(params, leaves)
        a, v, state = syncnet.apply_train(p, state, mels[mel_idx],
                                          windows[face_idx])
        loss = losses.cosine_bce_loss(a, v, y)
        grads = torch.autograd.grad(loss, leaves)
        updates, opt_state = opt.update(list(grads), opt_state)
        with torch.no_grad():
            leaves = [(w + u).requires_grad_()
                      for w, u in zip(leaves, updates)]
        return leaves, state, opt_state, loss

    history: List[float] = []
    with _reproducible():
        for it in range(steps):
            if draws is not None:
                pos, shift = (torch.tensor(np.asarray(v), dtype=torch.long)
                              for v in draws[it])
            else:
                pos = torch.randint(0, n, (batch,), generator=gen)
                shift = torch.randint(3, n - 3, (batch,), generator=gen)
            leaves, state, opt_state, loss = step(
                pos.to(device), shift.to(device), leaves, state, opt_state)
            if it % log_every == 0 or it == steps - 1:
                lv = float(loss.detach())
                history.append(lv)
                log(f"[syncnet-pretrain] step {it}/{steps} bce={lv:.4f}")
    params = ts.tree_unflatten(params, [w.detach() for w in leaves])
    return (params, state), history


@contextlib.contextmanager
def _reproducible():
    """Float32 without TF32 and deterministic cuDNN algorithms inside the
    block; the previous settings are restored after it."""
    from speech2lip_tpu_torch.ops.nn import full_float32
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_float32():
            yield
    finally:
        torch.backends.cudnn.deterministic = prev
