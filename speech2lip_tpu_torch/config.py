"""Hierarchical configuration with ``inherit_from`` semantics (counterpart
of ``speech2lip_tpu/core/config.py``).

``DEFAULT_CONFIG`` is a copy of the JAX package's default tree, and
``load_config`` reads each file with ``yaml.safe_load`` and follows
``inherit_from`` chains as it does: a relative parent path is taken from
the child's directory, parents load first, the child deep-merges on top,
and a chain deeper than 8 raises.  ``save_config`` writes a tree with
``yaml.safe_dump``, as the JAX package's tools do, so either package
reads the other's configs.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

DEFAULT_CONFIG: Dict[str, Any] = {
    "method": "face_simple",
    "data": {
        "dataset": "lip_someone",
        "path": "dataset/may_face_crop_lip",
        "extension": ".jpg",
        "width": 120,           # lip-crop width
        "height": 80,           # lip-crop height
        "face_img_focal": 1200.0,
        "canonical_idx": 0,
        "mel_fmin": 95.0,       # 95 female / 55 male
        "val_split_frames": 598,
        "mouth_center_y_ratio": 1.02,
        "lip_pad_fudge": 1,
        "expand_mask_divisor": 5,
    },
    "model": {
        "audio_embed": 6,
        "uv_embed": 10,
        "time_multires": 10,
        "net_depth": 8,
        "net_width": 256,
        "skips": [4],
        "output_ch": 3,
        "audio_net": True,
        "audio_not_embed": True,
        "audio_dims": 29,       # DeepSpeech logits per step
        "audio_window": 16,     # DeepSpeech window length
        "use_audio": True,
        "use_audio_mel": False,
        "use_head_pose": False,
        "use_head_pose_net": False,
        "head_pose_multires": 10,
        "MLP_version": "v2",
        "use_time": True,
        "use_lms": False,
        "use_text": False,
        "use_post_fusion": True,
        "use_post_fusion_blackaug": True,
        "post_fusion_warping": "backward",
        "expand_lip_mask": True,
        "use_light_unet": True,
        "post_fusion_channel": 3,
        "use_canonical_depth": True,
        "canonical_depth_height": 500,
        "canonical_depth_width": 500,
        "canonical_depth_init_path": None,
        "param_dtype": "float32",
        "compute_dtype": "float32",
        # K7 train gathers: true | false | 'auto' (train/trainer.py)
        "pallas_gather": "auto",
    },
    "training": {
        "out_dir": "log/face_simple/run",
        "batch_size": 1,
        "batch_size_val": 1,
        "batch_rays": 9600,
        "print_every": 10,
        "checkpoint_every": 5000,
        # per-process shards (core/checkpoint_sharded)
        "sharded_ckpt": False,
        "visualize_every": 10000,
        "validate_every": -1,
        "backup_every": 20000,
        "learning_rate": 1.0e-4,
        "scheduler_milestones": [200000, 400000],
        "scheduler_gamma": 0.5,
        "model_selection_metric": "psnr",
        "model_selection_mode": "maximize",
        "n_workers": 0,
        "logfile": "train.log",
        "use_lip_photo_loss": "v1",
        "use_lip_perc_loss": "v1",
        "use_face_photo_loss": True,
        "use_face_perc_loss": True,
        "use_perceptual_loss": True,
        "w_perceptual_loss": 0.01,
        "w_post_fusion": 1.0,
        "lambda_rgb": 1.0,
        "use_syncloss": True,
        "use_sync_contrastive_loss": True,
        "w_syncloss": 0.01,
        "sync_start_iter": 100000,
        "postnet_freeze_iter": 100000,
        "use_fusion_face": True,
        "fusion_lip_only": True,
        "use_local_ensemble": True,
        "use_canonical_depth_loss_photo_v2": True,
        "add_noise_uv": False,
        "add_noise_audio": False,
        "use_coords_mapping": False,
        "fix_post_net": False,
        "stage": "stage1",
        "seed": 0,
    },
    "parallel": {
        "data_axis": "data",
        "pixel_axis": "pixel",
        "mesh_shape": None,       # None -> (n_devices, 1)
    },
    "test": {
        "model_file": "model_best.pt",
    },
}


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge ``dict2`` into ``dict1``."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: str, default: Optional[Dict[str, Any]] = None,
                _depth: int = 0) -> Dict[str, Any]:
    """Load a config file, following ``inherit_from`` chains; the chain
    bottoms out at ``DEFAULT_CONFIG`` (or ``default``)."""
    if _depth > 8:
        raise RecursionError(f"inherit_from chain too deep at {path}")
    with open(path, "r") as f:
        cfg_special = yaml.safe_load(f) or {}
    if not isinstance(cfg_special, dict):
        raise ValueError(f"{path}: the top level is not a mapping")

    inherit_from = cfg_special.pop("inherit_from", None)
    if inherit_from is not None:
        if not os.path.isabs(inherit_from):
            inherit_from = os.path.normpath(
                os.path.join(os.path.dirname(path), inherit_from))
        cfg = load_config(inherit_from, default, _depth + 1)
    else:
        cfg = copy.deepcopy(default if default is not None else DEFAULT_CONFIG)

    update_recursive(cfg, cfg_special)
    return cfg


def default_config() -> Dict[str, Any]:
    return copy.deepcopy(DEFAULT_CONFIG)


def save_config(path: str, cfg: Dict[str, Any]):
    """Write the whole of ``cfg`` to ``path`` as ``yaml.safe_dump`` writes
    it, the bytes the JAX package's tools write for the same tree."""
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
