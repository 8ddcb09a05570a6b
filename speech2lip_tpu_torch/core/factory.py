"""Method registry and factories (counterpart of
``speech2lip_tpu/core/factory.py``).

The config-driven dispatch of the reference (``method_dict`` with
get_model / get_trainer / get_dataset): a method name selects the model
builder and the trainer, ``data.dataset`` the dataset builder.  New
methods and dataset types register themselves under their own names.

The built-in ``face_simple`` model draws its trees with numpy from
``training.seed`` (``weights.random_params``): the JAX package's leaf names
and shapes, the port's own draws, on the card unless the caller names
another device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_MODEL_BUILDERS: Dict[str, Callable] = {}
_DATASET_BUILDERS: Dict[str, Callable] = {}
_TRAINER_BUILDERS: Dict[str, Callable] = {}


def register_method(name: str, *, model: Callable = None,
                    trainer: Callable = None):
    if model:
        _MODEL_BUILDERS[name] = model
    if trainer:
        _TRAINER_BUILDERS[name] = trainer


def register_dataset(name: str, builder: Callable):
    _DATASET_BUILDERS[name] = builder


def get_model(cfg: Dict[str, Any], **kw):
    """Build the method's model trees (reference src/config.py:67-78)."""
    return _MODEL_BUILDERS[cfg["method"]](cfg, **kw)


def get_trainer(cfg: Dict[str, Any], **kw):
    return _TRAINER_BUILDERS[cfg["method"]](cfg, **kw)


def get_dataset(mode: str, cfg: Dict[str, Any], **kw):
    """Build a dataset by cfg['data']['dataset'] type
    (reference src/config.py:112-149)."""
    return _DATASET_BUILDERS[cfg["data"]["dataset"]](
        cfg["data"]["path"], mode, cfg, **kw)


# ---------------------------------------------------------------------------
# built-in registrations
# ---------------------------------------------------------------------------

def _build_face_simple_model(cfg, device=None, canonical_depth_init=None):
    """(talking_face params, unet params, unet state) on ``device`` (the
    card by default), the U-Net's BatchNorm at the JAX init's identity."""
    from speech2lip_tpu_torch import weights
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.train.trainer import _identity_bn
    params, unet_p, unet_s = weights.random_params(
        cfg["training"].get("seed", 0), device=resolve_device(device),
        cfg=cfg, canonical_depth_init=canonical_depth_init)
    _identity_bn(unet_s, unet_p)
    return params, unet_p, unet_s


def _build_face_simple_trainer(cfg, **kw):
    from speech2lip_tpu_torch.train import trainer
    return trainer


def _build_lip_dataset(path, mode, cfg, **kw):
    from speech2lip_tpu_torch.data.dataset import LipDataset
    return LipDataset(path, mode, cfg)


register_method("face_simple", model=_build_face_simple_model,
                trainer=_build_face_simple_trainer)
register_dataset("lip_someone", _build_lip_dataset)
