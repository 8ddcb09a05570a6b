"""SyncNet lip-sync expert (counterpart of
``speech2lip_tpu/models/syncnet.py``): ``apply`` runs it frozen in eval
mode, ``apply_train`` with batch statistics for pretraining a teacher.

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


def _encoder(params, state, x, spec, train: bool = False):
    new_state = []
    for p, s, (_, _, stride, pad, residual) in zip(params, state, spec):
        y = tnn.conv2d(p["conv"], x, stride=stride, padding=pad)
        if train:
            y, bn_s = tnn.batchnorm_train(p["bn"], s["bn"], y)
            new_state.append({"bn": bn_s})
        else:
            y = tnn.batchnorm(p["bn"], s["bn"], y)
        x = tnn.relu(y + x if residual else y)
    return x, new_state


def _normalise(a, v):
    a = a.reshape(a.shape[0], -1)
    v = v.reshape(v.shape[0], -1)
    a = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=1, keepdim=True),
                            1e-12)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True),
                            1e-12)
    return a, v


def apply(params, state, mel, faces):
    """mel [B, 80, 16, 1]; faces [B, 48, 96, 15].  Returns (audio_emb
    [B, 512], face_emb [B, 512]), each L2-normalised."""
    v, _ = _encoder(params["face"], state["face"], faces, FACE_SPEC)
    a, _ = _encoder(params["audio"], state["audio"], mel, AUDIO_SPEC)
    return _normalise(a, v)


def apply_train(params, state, mel, faces):
    """``apply`` with BatchNorm in train mode, as the JAX package's
    ``apply(..., train=True)``: each block normalises with the batch's
    statistics.  Returns (audio_emb, face_emb, new_state), the new state
    holding the updated running statistics."""
    v, fs = _encoder(params["face"], state["face"], faces, FACE_SPEC, True)
    a, as_ = _encoder(params["audio"], state["audio"], mel, AUDIO_SPEC,
                      True)
    a, v = _normalise(a, v)
    return a, v, {"face": fs, "audio": as_}
