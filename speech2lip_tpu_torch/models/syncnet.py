"""SyncNet lip-sync expert, frozen, eval mode (counterpart of
``speech2lip_tpu/models/syncnet.py``).

Conv2d + BatchNorm + ReLU blocks, some residual.  Face input: the lower
half of five stacked BGR 96x96 mouth crops, [B, 48, 96, 15]; audio input:
a mel window, [B, 80, 16, 1]; both NHWC.  Parameters are the JAX
package's tree: ({"face": [{conv, bn}], "audio": [...]}, {"face":
[{bn: {mean, var}}], "audio": [...]}).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from speech2lip_tpu_torch.ops import nn as tnn

# (out_ch, kernel, stride, padding, residual)
FACE_SPEC: List[Tuple[int, Tuple[int, int], Tuple[int, int], int, bool]] = [
    (32, (7, 7), (1, 1), 3, False),
    (64, (5, 5), (1, 2), 1, False),
    (64, (3, 3), (1, 1), 1, True),
    (64, (3, 3), (1, 1), 1, True),
    (128, (3, 3), (2, 2), 1, False),
    (128, (3, 3), (1, 1), 1, True),
    (128, (3, 3), (1, 1), 1, True),
    (128, (3, 3), (1, 1), 1, True),
    (256, (3, 3), (2, 2), 1, False),
    (256, (3, 3), (1, 1), 1, True),
    (256, (3, 3), (1, 1), 1, True),
    (512, (3, 3), (2, 2), 1, False),
    (512, (3, 3), (1, 1), 1, True),
    (512, (3, 3), (1, 1), 1, True),
    (512, (3, 3), (2, 2), 1, False),
    (512, (3, 3), (1, 1), 0, False),
    (512, (1, 1), (1, 1), 0, False),
]
AUDIO_SPEC: List[Tuple[int, Tuple[int, int], Tuple[int, int], int, bool]] = [
    (32, (3, 3), (1, 1), 1, False),
    (32, (3, 3), (1, 1), 1, True),
    (32, (3, 3), (1, 1), 1, True),
    (64, (3, 3), (3, 1), 1, False),
    (64, (3, 3), (1, 1), 1, True),
    (64, (3, 3), (1, 1), 1, True),
    (128, (3, 3), (3, 3), 1, False),
    (128, (3, 3), (1, 1), 1, True),
    (128, (3, 3), (1, 1), 1, True),
    (256, (3, 3), (3, 2), 1, False),
    (256, (3, 3), (1, 1), 1, True),
    (256, (3, 3), (1, 1), 1, True),
    (512, (3, 3), (1, 1), 0, False),
    (512, (1, 1), (1, 1), 0, False),
]


def _encoder(params, state, x, spec):
    for p, s, (_, _, stride, pad, residual) in zip(params, state, spec):
        y = tnn.batchnorm(p["bn"], s["bn"],
                          tnn.conv2d(p["conv"], x, stride=stride,
                                     padding=pad))
        x = tnn.relu(y + x if residual else y)
    return x


def apply(params, state, mel, faces):
    """mel [B, 80, 16, 1]; faces [B, 48, 96, 15].  Returns (audio_emb
    [B, 512], face_emb [B, 512]), each L2-normalised."""
    v = _encoder(params["face"], state["face"], faces, FACE_SPEC)
    a = _encoder(params["audio"], state["audio"], mel, AUDIO_SPEC)
    a = a.reshape(a.shape[0], -1)
    v = v.reshape(v.shape[0], -1)
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=1, keepdim=True),
                            1e-12)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                            1e-12)
    return a, v
