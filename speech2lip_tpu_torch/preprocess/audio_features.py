"""wav -> DeepSpeech feature windows, the audio.npy producer (counterpart
of ``speech2lip_tpu/preprocess/audio_features.py``).

Resample to 16 kHz -> MFCC-26 with +-9 frames of context at stride 2
(``ops/mfcc.py``, host numpy) -> DeepSpeech-0.1.0 logits at 50 fps
(``models/deepspeech.py``, on the card unless ``device`` says otherwise)
-> video-fps interpolation -> zero-padded sliding 16-step windows.

Two windowing variants, as in the JAX module:
- ``num_frames=None``: features kept at 50 fps, window 16 / stride 2, one
  window per 25 fps video frame;
- ``num_frames`` given: interpolate to the video fps, window 16 / stride 1.

Before the RNN, T is zero-padded up to a multiple of ``batch_t``, as the
JAX module pads it for stable jit shapes.  The padded rows are not inert
(``fc1`` of zeros is its bias), so the backward LSTM walks ``t_pad - t``
padded steps before it reaches speech and the windows depend on
``batch_t``: a behaviour of the reference, matched here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from speech2lip_tpu_torch.ops.mfcc import deepspeech_input_vector


def interpolate_features(features: np.ndarray, input_rate: float,
                         output_rate: float,
                         output_len: int) -> np.ndarray:
    """Per-feature linear time interpolation."""
    input_len, n = features.shape
    in_t = np.arange(input_len) / float(input_rate)
    out_t = np.arange(output_len) / float(output_rate)
    out = np.zeros((output_len, n))
    for j in range(n):
        out[:, j] = np.interp(out_t, in_t, features[:, j])
    return out


def make_windows(features: np.ndarray, win_size: int = 16,
                 stride: int = 1) -> np.ndarray:
    """Zero-pad win/2 each side and slide; the range stops at
    len(padded) - win_size, exclusive."""
    pad = np.zeros((win_size // 2, features.shape[1]), features.dtype)
    padded = np.concatenate([pad, features, pad], axis=0)
    return np.stack([padded[i:i + win_size]
                     for i in range(0, padded.shape[0] - win_size, stride)])


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device)


def deepspeech_logits(x: np.ndarray, ds_params, batch_t: int = 4096,
                      device=None) -> np.ndarray:
    """[T, 494] input vectors -> [T, 29] logits: T zero-padded up to a
    multiple of ``batch_t``, the RNN run on ``device`` (the card unless
    named), the padding cropped."""
    from speech2lip_tpu_torch.core.device import resolve_device
    from speech2lip_tpu_torch.models import deepspeech

    device = resolve_device(device)
    t = x.shape[0]
    t_pad = -(-t // batch_t) * batch_t
    xp = torch.from_numpy(np.pad(x, ((0, t_pad - t), (0, 0)))).to(device)
    return deepspeech.apply(_on(ds_params, device), xp)[:t].cpu().numpy()


def wav_to_deepspeech_windows(audio: np.ndarray, sample_rate: int,
                              ds_params, num_frames: Optional[int] = None,
                              batch_t: int = 4096,
                              device=None) -> np.ndarray:
    """Raw audio -> [N, 16, 29] windows (the audio.npy contract).

    audio: int16 or float waveform at ``sample_rate`` (a float one is
    scaled to 0.95 of int16's full scale by its peak; either is resampled
    to 16 kHz where the rate differs); ds_params: the port's DeepSpeech
    tree (``weights.deepspeech_from_jax`` / ``random_deepspeech``), moved
    to ``device`` where it lies elsewhere; num_frames: the target video
    frame count (None: 25 fps windows from the 50 fps features at stride
    2).  The JAX function's unused ``fps`` argument is left out."""
    if audio.dtype != np.int16:
        peak = np.abs(audio).max() or 1.0
        audio = (audio / peak * 32767 * 0.95).astype(np.int16)
    if sample_rate != 16000:
        from math import gcd
        from scipy.signal import resample_poly
        g = gcd(int(sample_rate), 16000)
        audio = resample_poly(audio.astype(np.float64), 16000 // g,
                              sample_rate // g).astype(np.int16)
    logits = deepspeech_logits(deepspeech_input_vector(audio), ds_params,
                               batch_t, device)
    if num_frames is None:
        return make_windows(logits, win_size=16, stride=2)
    video_fps = num_frames / (len(audio) / 16000)
    feats = interpolate_features(logits, 50.0, video_fps, num_frames)
    return make_windows(feats.astype(np.float32), win_size=16, stride=1)
