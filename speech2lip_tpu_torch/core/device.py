"""Where the port runs and in what dtype: the one device rule
(``resolve_device``), the config's compute dtypes (``DTYPES``) and the cast
of a parameter tree (``cast_tree``)."""

from __future__ import annotations

import torch

# ``model.compute_dtype`` / ``training.compute_dtype`` -> torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: the card unless the caller names
    another (``device="cpu"``); raises when the card is asked for and
    there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


def cast_tree(tree, device, dtype):
    """The tree's tensors on ``device``, float32 leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, device, dtype) for v in tree]
    t = torch.as_tensor(tree).to(device)
    return t.to(dtype) if t.dtype == torch.float32 else t
