"""Hierarchical configuration with ``inherit_from`` semantics (counterpart
of ``speech2lip_tpu/core/config.py``), without yaml.

``DEFAULT_CONFIG`` is a copy of the JAX package's default tree, and
``load_config`` follows ``inherit_from`` chains as it does: a relative
parent path is taken from the child's directory, parents load first, the
child deep-merges on top, and a chain deeper than 8 raises.

The port reads the YAML subset that the configs use, and nothing else
(``parse_yaml``): block mappings nested by spaces, plain scalars (int,
float, bool, null, string, resolved as ``yaml.safe_load`` resolves them),
one-line flow sequences of plain scalars (``mesh_shape: [2, 2]``,
``skips: [4]``) and ``#`` comments.  Anything outside the subset (block
sequences, nested or multi-line flow collections, flow mappings, quotes,
anchors, aliases, tags, block scalars, documents) raises with its line
number.  ``dump_yaml`` writes a config in the same subset.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Tuple

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
        cfg_special = parse_yaml(f.read(), path) or {}

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


# -- the YAML subset ----------------------------------------------------------

# yaml.safe_load's implicit resolvers (YAML 1.1) for the forms the subset
# reads, and the ones it refuses rather than misread
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
# ints in base 2, 8 or 16, sexagesimal numbers and timestamps
_OTHER = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
# a plain scalar may not start with these indicators
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"


class YamlSubsetError(ValueError):
    """A config file uses YAML outside the subset the port reads."""


def _fail(where: str, lineno: int, why: str):
    raise YamlSubsetError(f"{where}:{lineno}: {why} (outside the YAML "
                          f"subset of block mappings, plain scalars and "
                          f"flow sequences of them)")


def _scalar(text: str, where: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _OTHER.fullmatch(text):
        _fail(where, lineno, f"number or date form {text!r}")
    if text[0] in _INDICATORS or text == "=":
        _fail(where, lineno, f"scalar {text!r} starts with an indicator")
    if ": " in text or text.endswith(":") or " #" in text or "\t" in text:
        _fail(where, lineno, f"scalar {text!r}")
    return text


def _flow_sequence(text: str, where: str, lineno: int) -> List[Any]:
    """``[a, b, ...]`` on one line: its items, each a plain scalar."""
    if not text.endswith("]"):
        _fail(where, lineno, f"flow sequence {text!r} does not close on "
                             f"its line")
    body = text[1:-1].strip()
    if not body:
        return []
    items = []
    for item in body.split(","):
        item = item.strip()
        if not item or any(c in item for c in "[]{}"):
            _fail(where, lineno, f"flow sequence item {item!r}")
        items.append(_scalar(item, where, lineno))
    return items


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment (a ``#`` at the start or after a
    space opens one)."""
    for i, ch in enumerate(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str, where: str = "<config>") -> Optional[Dict[str, Any]]:
    """Parse the YAML subset into nested dicts; None for an empty file."""
    lines: List[Tuple[int, int, str]] = []   # (lineno, indent, content)
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped[0] == "\t" or "\t" in body[:len(body) - len(stripped)]:
            _fail(where, lineno, "tab in indentation")
        if stripped.startswith(("---", "...", "%")):
            _fail(where, lineno, "document marker or directive")
        lines.append((lineno, len(body) - len(stripped), stripped))
    if not lines:
        return None

    pos = 0

    def block(indent: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            lineno, ind, content = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                _fail(where, lineno, "unexpected indentation")
            key, sep, rest = content.partition(":")
            if not sep or (rest and rest[0] != " "):
                _fail(where, lineno, f"{content!r} is not a 'key: value' "
                                     f"line")
            if not _KEY.fullmatch(key) or not isinstance(
                    _scalar(key, where, lineno), str):
                _fail(where, lineno, f"key {key!r}")
            if key in out:
                _fail(where, lineno, f"duplicate key {key!r}")
            value = rest.strip()
            pos += 1
            if value.startswith("["):
                out[key] = _flow_sequence(value, where, lineno)
            elif value:
                out[key] = _scalar(value, where, lineno)
            elif pos < len(lines) and lines[pos][1] > indent:
                out[key] = block(lines[pos][1])
            else:
                out[key] = None
        return out

    if lines[0][1] != 0:
        _fail(where, lines[0][0], "the top level must start at column 0")
    return block(0)


def _dump_scalar(value: Any, key: str) -> str:
    """One plain scalar that ``parse_yaml`` reads back as ``value``."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    text = value if isinstance(value, str) else None
    if isinstance(value, float):
        text = repr(value)
        if "e" in text and "." not in text:
            text = text.replace("e", ".0e")   # '1e-05' reads as a string
    try:
        back = _scalar(text, key, 0) if text is not None else None
    except YamlSubsetError:
        back = None
    if back != value or type(back) is not type(value):
        raise YamlSubsetError(f"{key}: {value!r} cannot be written in the "
                              f"YAML subset")
    return text


def _dump_value(value: Any, key: str) -> str:
    """A plain scalar, or a list of them as a flow sequence, that
    ``parse_yaml`` reads back as ``value``."""
    if not isinstance(value, (list, tuple)):
        return _dump_scalar(value, key)
    items = [_dump_scalar(v, key) for v in value]
    if any(c in t for t in items for c in ",[]{}"):
        raise YamlSubsetError(f"{key}: {value!r} cannot be written as a "
                              f"flow sequence of plain scalars")
    return "[" + ", ".join(items) + "]"


def dump_yaml(cfg: Dict[str, Any], base: Optional[Dict[str, Any]] = None,
              indent: int = 0) -> str:
    """``cfg`` as text in the YAML subset.  With ``base`` (for example
    ``DEFAULT_CONFIG``) only the entries that differ from it are written,
    so ``load_config`` of the text gives ``cfg`` back; a list is written
    as a flow sequence of plain scalars, and a tuple reads back as a
    list."""
    out = []
    for key, value in cfg.items():
        ref = base.get(key) if isinstance(base, dict) else None
        if base is not None and key in base and value == ref:
            continue
        if isinstance(value, dict):
            body = dump_yaml(value, ref if isinstance(ref, dict) else None,
                             indent + 2)
            if not value:
                raise YamlSubsetError(f"{key}: an empty mapping cannot be "
                                      f"written in the YAML subset")
            if body:
                out.append(" " * indent + f"{key}:\n{body.rstrip()}")
            continue
        out.append(" " * indent + f"{key}: {_dump_value(value, key)}")
    return "".join(line + "\n" for line in out)


def save_config(path: str, cfg: Dict[str, Any]):
    """Write ``cfg`` to ``path`` in the YAML subset, as its differences
    from ``DEFAULT_CONFIG`` (``load_config`` of the file gives ``cfg``)."""
    with open(path, "w") as f:
        f.write(dump_yaml(cfg, DEFAULT_CONFIG))
