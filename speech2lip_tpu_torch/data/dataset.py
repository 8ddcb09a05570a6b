"""Reader of the preprocessed talking-head artifact tree (counterpart of
``speech2lip_tpu/data/dataset.py``):

    <root>/
      audio/audio.{wav,npy}  audio_test/audio.npy  images/%05d.jpg
      warp_images/%05d.jpg   ori_images_face/%05d.jpg  coords/%05d.npy
      landmarks/%05d.lms     canonical_{lip,head,face}_mask.jpg
      depth_face_canonical.npy  track_params.pt  face_bbox_dict.npy

Identity constants (canonical index, mel fmin, val-split length,
mouth-centre ratio) are config fields.  Samples are dicts of numpy arrays,
stacked into a batch by ``stack_batch``; the trainer moves a batch to the
device once per iteration.  JPEGs decode through ``data.image_io``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from speech2lip_tpu_torch.core import spans
from speech2lip_tpu_torch.data.image_io import imread_float as _imread_float
from speech2lip_tpu_torch.ops import audio_dsp
from speech2lip_tpu_torch.ops.grid_sample import grid_sample_np


def _load_track_params(path: str) -> Dict[str, np.ndarray]:
    """Load {euler, trans, ...} from track_params.pt (torch) or .npz."""
    if path.endswith(".npz") or os.path.exists(path + ".npz"):
        p = path if path.endswith(".npz") else path + ".npz"
        d = np.load(p)
        return {k: d[k] for k in d.files}
    import torch
    d = torch.load(path, map_location="cpu", weights_only=False)
    return {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in d.items()}


def compute_mouth_bbox(lms: np.ndarray, dst_w: int, dst_h: int,
                       center_y_ratio: float = 1.02) -> tuple:
    """Fixed-size mouth bbox from canonical landmarks (points 48+),
    reference someones_lip_dataset.py:173-193."""
    pts = lms[48:, :2].astype(np.float32)
    x, y = pts.min(axis=0)
    x2, y2 = pts.max(axis=0)
    # cv2.boundingRect on float pts floors mins and ceils spans
    x, y = int(np.floor(x)), int(np.floor(y))
    w, h = int(np.ceil(x2)) - x + 1, int(np.ceil(y2)) - y + 1
    cx = x + w / 2.0
    cy = (y + h / 2.0) * center_y_ratio
    x0 = int(cx - dst_w / 2.0)
    y0 = int(cy - dst_h / 2.0)
    return x0, y0, dst_w, dst_h


class LipDataset:
    """Per-identity artifact-tree reader (train/val/test splits).

    Split semantics match the reference: train = first 90% of frames
    (:122-138), val = last ``val_split_frames`` (:139-155), test = audio-only
    from audio_test/ (:156-162).
    """

    def __init__(self, root: str, mode: str, cfg: Dict[str, Any]):
        self.root = root
        self.mode = mode
        self.cfg = cfg
        data_cfg = cfg["data"]
        self.canonical_idx = int(data_cfg.get("canonical_idx", 0))
        self.use_syncloss = bool(cfg["training"]["use_syncloss"])
        self.use_canonical_depth = bool(cfg["model"]["use_canonical_depth"])
        self.use_blackaug = bool(cfg["model"].get("use_post_fusion_blackaug",
                                                  False))

        self.images_dir = os.path.join(root, "images")
        self.coords_dir = os.path.join(root, "coords")
        self.faces_dir = os.path.join(root, "ori_images_face")
        ext = data_cfg.get("extension", ".jpg")
        self.files = sorted(f for f in os.listdir(self.images_dir)
                            if f.endswith(ext))
        self.coord_files = (sorted(f for f in os.listdir(self.coords_dir)
                                   if f.endswith(".npy"))
                            if os.path.isdir(self.coords_dir) else [])

        can_name = "{:05d}.jpg".format(self.canonical_idx + 1)
        self.rgb_face_zero = _imread_float(os.path.join(self.faces_dir, can_name))
        self.face_h, self.face_w = self.rgb_face_zero.shape[:2]
        self.rgb_zero = _imread_float(os.path.join(self.images_dir, can_name))
        self.lip_h, self.lip_w = self.rgb_zero.shape[:2]

        self.mask_lip_canonical = _imread_float(
            os.path.join(root, "canonical_lip_mask.jpg"))

        lms = np.loadtxt(os.path.join(root, "landmarks",
                                      "{:05d}.lms".format(self.canonical_idx + 1)),
                         dtype=np.float32)
        x, y, _, _ = compute_mouth_bbox(
            lms, self.lip_w, self.lip_h,
            data_cfg.get("mouth_center_y_ratio", 1.02))
        self.lefttop_x = int(x)
        self.lefttop_y = int(y)

        aud_dir = "audio_test" if mode == "test" else "audio"
        if cfg["model"].get("use_audio_mel"):
            # mel-input mode (reference use_audio_mel, tf_nerf.py:37-39,
            # training.py:372): the audio feature stream is 16-frame mel
            # windows [16, 80] instead of DeepSpeech logits [16, 29].
            # The reference leaves producing such an audio.npy to the
            # user; here the windows come straight from the wav so the
            # mode is end-to-end without an extra preprocessing artifact.
            wav = audio_dsp.load_wav(os.path.join(root, aud_dir,
                                                  "audio.wav"))
            mel = audio_dsp.melspectrogram(
                wav, fmin=data_cfg.get("mel_fmin", 55.0)).T  # [T, 80]
            n_mel = max(0, int((mel.shape[0] - 16) / 80.0 * 25.0) + 1)
            self.aud = np.stack([
                audio_dsp.crop_audio_window(mel, i + 2)
                for i in range(n_mel)]).astype(np.float32)  # [N, 16, 80]
        else:
            self.aud = np.load(os.path.join(root, aud_dir, "audio.npy"))

        if self.use_canonical_depth:
            tp = _load_track_params(os.path.join(root, "track_params.pt"))
            self.euler = np.asarray(tp["euler"], np.float32)
            self.trans = np.asarray(tp["trans"], np.float32)
            self.canonical_euler = self.euler[self.canonical_idx]
            self.canonical_trans = self.trans[self.canonical_idx]
            self.mask_head_canonical = _imread_float(
                os.path.join(root, "canonical_head_mask.jpg"))[:, :, :1]
            self.mask_face_canonical = _imread_float(
                os.path.join(root, "canonical_face_mask.jpg"))
            self.depth_canonical = np.load(
                os.path.join(root, "depth_face_canonical.npy")).astype(np.float32)

        self.orig_mel = None
        self.face_bbox_dict = None
        if self.use_syncloss and mode == "train":
            wav = audio_dsp.load_wav(os.path.join(root, "audio", "audio.wav"))
            self.orig_mel = audio_dsp.melspectrogram(
                wav, fmin=data_cfg.get("mel_fmin", 55.0)).T  # [T, 80]
            bb = os.path.join(root, "face_bbox_dict.npy")
            if os.path.exists(bb):
                self.face_bbox_dict = np.load(bb, allow_pickle=True).item()

        # frames available = min(audio windows, image files): the reference
        # slices the file list by the audio-derived length and then sizes
        # the dataset by the (possibly shorter) file list (:127-130)
        n = min(self.aud.shape[0], len(self.files)) if mode != "test" \
            else self.aud.shape[0]
        if mode == "train":
            length = min(int(self.aud.shape[0] * 0.9), n)
            self._index_map = list(range(length))
        elif mode == "val":
            v = int(data_cfg.get("val_split_frames", max(1, n - int(n * 0.9))))
            v = min(v, n)
            self._index_map = list(range(n - v, n))
        elif mode == "test":
            self._index_map = list(range(n))
        else:
            raise ValueError(mode)

    def __len__(self):
        return len(self._index_map)

    @property
    def total_frames(self) -> int:
        return len(self._index_map)

    def _coord(self, pos: int) -> np.ndarray:
        return np.load(os.path.join(
            self.coords_dir, self.coord_files[self._index_map[pos]])
        ).astype(np.float32)

    def iter_coords(self):
        """Every canonical→observed coord grid on disk, in file order.

        The warp-window scan (data/windows.compute_warp_window) is a
        geometry property of the coord grids, NOT of the split: indexing
        it through ``_coord(range(len(self)))`` overruns in test mode,
        where the dataset is sized by the audio windows (reference
        dataset.py:127-130) which can outnumber the tracked frames."""
        for f in self.coord_files:
            yield np.load(os.path.join(self.coords_dir, f)
                          ).astype(np.float32)

    def load_frame_light(self, pos: int) -> Dict[str, Any]:
        """The cheap in-memory fields of a sample (everything except the
        per-frame lip/face JPEGs and the coord grid): the complement of the
        file set of the JAX package's native prefetcher, which the port
        does not have yet."""
        idx = self._index_map[pos]
        s: Dict[str, Any] = {
            "audio": self.aud[idx].astype(np.float32),
            "index": np.int32(pos),
            "total_frame": np.int32(len(self._index_map)),
            "rgb_face_zero": self.rgb_face_zero,
            "mask_lip_canonical": self.mask_lip_canonical,
            "lip_lefttop_x": np.int32(self.lefttop_x),
            "lip_lefttop_y": np.int32(self.lefttop_y),
            "rgb_zero": self.rgb_zero,
            "height": np.int32(self.lip_h),
            "width": np.int32(self.lip_w),
        }
        if self.use_canonical_depth:
            s["canonical_euler"] = self.canonical_euler
            s["canonical_trans"] = self.canonical_trans
            s["euler"] = self.euler[idx]
            s["trans"] = self.trans[idx]
            s["mask_head_canonical"] = self.mask_head_canonical
            s["mask_face_canonical"] = self.mask_face_canonical
        return s

    def load_frame(self, pos: int) -> Dict[str, Any]:
        """Assemble the per-frame sample dict (reference load_one_frame,
        someones_lip_dataset.py:242-399).  ``pos`` indexes within the split."""
        idx = self._index_map[pos]
        s: Dict[str, Any] = {
            "audio": self.aud[idx].astype(np.float32),       # [16, 29]
            "index": np.int32(pos),
            "total_frame": np.int32(len(self._index_map)),
            "rgb_face_zero": self.rgb_face_zero,
            "mask_lip_canonical": self.mask_lip_canonical,
            "lip_lefttop_x": np.int32(self.lefttop_x),
            "lip_lefttop_y": np.int32(self.lefttop_y),
            "rgb_zero": self.rgb_zero,
        }
        if self.mode != "test":
            fname = self.files[idx]
            with spans.span("build.read"):
                s["rgb"] = _imread_float(os.path.join(self.images_dir,
                                                      fname))
                s["rgb_face_ori"] = _imread_float(os.path.join(
                    self.faces_dir, fname))
                s["coord"] = self._coord(pos)
            s["height"] = np.int32(self.lip_h)
            s["width"] = np.int32(self.lip_w)
        else:
            # test reuses the canonical frame's artifacts (:299-314)
            can_name = "{:05d}.jpg".format(self.canonical_idx + 1)
            s["rgb_face_ori"] = self.rgb_face_zero
            coord_path = os.path.join(self.coords_dir, can_name.replace(".jpg", ".npy"))
            if os.path.exists(coord_path):
                s["coord"] = np.load(coord_path).astype(np.float32)

        if self.use_canonical_depth:
            s["canonical_euler"] = self.canonical_euler
            s["canonical_trans"] = self.canonical_trans
            if self.mode != "test":
                s["euler"] = self.euler[idx]
                s["trans"] = self.trans[idx]
            else:
                s["euler"] = self.canonical_euler
                s["trans"] = self.canonical_trans
            s["mask_head_canonical"] = self.mask_head_canonical
            s["mask_face_canonical"] = self.mask_face_canonical

        if self.use_syncloss and self.mode == "train" and self.orig_mel is not None:
            with spans.span("build.sync_extras"):
                s.update(self._sync_extras(pos))
        if self.mode == "train" and "coord" in s:
            with spans.span("build.warp"):
                s.update(self.blackaug_statics(s["coord"]))
        return s

    def blackaug_statics(self, coord: np.ndarray) -> Dict[str, Any]:
        """Host-precomputed static warps for the blackaug branch: the
        canonical face and its >0 mask warped by this frame's ``coord``
        (both are dataset constants).  Computing them here removes the
        step's two full-frame 500² gathers with bit-identical float32
        results (``grid_sample_np`` mirrors the device op op for op)."""
        if not self.use_blackaug:
            return {}
        warped = grid_sample_np(self.rgb_face_zero[None], coord[None])[0]
        m = grid_sample_np(
            (self.rgb_face_zero > 0).astype(np.float32)[None],
            coord[None])[0]
        return {"warped_base": warped,
                "blackaug_face_mask": (m == 1.0).astype(np.float32)}

    # ------------------------------------------------------------------
    # sync-loss extras (reference someones_lip_dataset.py:328-385)
    # ------------------------------------------------------------------

    def _sync_extras(self, pos: int) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        mel = audio_dsp.crop_audio_window(self.orig_mel, pos + 2)
        out["mel"] = mel.T[None].astype(np.float32)  # [1, 80, 16]

        n = len(self._index_map)
        coord_window, audio_window = [], []
        for k in range(5):
            cur = min(pos + k, n - 1)
            coord_window.append(self._coord(cur))
            audio_window.append(self.aud[self._index_map[cur]])
        out["coord_window"] = np.stack(coord_window).astype(np.float32)
        out["audio_window"] = np.stack(audio_window).astype(np.float32)

        if self.face_bbox_dict is not None:
            key = "{:05d}.jpg".format(self.canonical_idx + 1)
            out["canonical_face_bbox"] = np.asarray(
                self.face_bbox_dict[key], np.float32)

        # negative window for the contrastive sync loss (:365-385)
        start = pos + 5 if pos + 10 < n else pos - 10
        rgb_window = []
        for k in range(5):
            cur = int(np.clip(start + k, 0, n - 1))
            fname = self.files[self._index_map[cur]]
            rgb_window.append(_imread_float(
                os.path.join(self.faces_dir, fname), resize_hw=(96, 96)))
        # [5, 96, 96, 3] -> [3, 5, 96, 96] reference layout
        out["rgb_window_neg"] = np.stack(rgb_window).transpose(3, 0, 1, 2)
        return out


def stack_batch(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Collate sample dicts into a leading batch axis (the reference's
    default_collate, someones_lip_dataset.py:422-431)."""
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}
