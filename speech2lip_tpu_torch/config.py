"""Default ``model``/``data``/``training`` config fields the port reads.

A yaml-free copy of the matching fields of
``speech2lip_tpu.core.config.DEFAULT_CONFIG`` (that module imports yaml at
module top, which the GPU machine does not have).  tests/test_torch_ops.py
holds these fields equal to the JAX package's ``default_config()``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

DEFAULT_CONFIG: Dict[str, Any] = {
    "data": {
        "width": 120,           # lip-crop width
        "height": 80,           # lip-crop height
        "expand_mask_divisor": 5,
    },
    "model": {
        "net_depth": 8,
        "net_width": 256,
        "skips": [4],
        "output_ch": 3,
        "compute_dtype": "float32",
        "canonical_depth_height": 500,
        "canonical_depth_width": 500,
    },
    "training": {
        "batch_size": 1,
        "learning_rate": 1.0e-4,
        "scheduler_milestones": [200000, 400000],
        "scheduler_gamma": 0.5,
    },
}


def default_config() -> Dict[str, Any]:
    return copy.deepcopy(DEFAULT_CONFIG)
