"""Audio DSP: the Wav2Lip-style mel spectrogram (counterpart of
``speech2lip_tpu/ops/audio_dsp.py``), in numpy.

preemphasis -> STFT (n_fft 800, hop 200, win 800, periodic Hann,
center/reflect) -> 80 mel bands (Slaney scale and norm, as
``librosa.filters.mel(htk=False, norm='slaney')``) -> dB -> symmetric
[-4, 4] normalisation.  It runs once per dataset on the host, in float64,
and returns float32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class MelParams:
    """Frozen Wav2Lip hyperparameters."""
    sample_rate: int = 16000
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    num_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    max_abs_value: float = 4.0


_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalised triangular filterbank."""
    fftfreqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def preemphasis(wav: np.ndarray, k: float = 0.97) -> np.ndarray:
    """y[t] = x[t] - k*x[t-1], y[0] = x[0]."""
    return np.concatenate([wav[:1], wav[1:] - k * wav[:-1]])


def stft_magnitude(wav: np.ndarray, n_fft: int, hop: int,
                   win: int) -> np.ndarray:
    """|STFT| with librosa's conventions (center, reflect padding, periodic
    Hann window).  Returns [n_fft//2+1, n_frames]."""
    pad = n_fft // 2
    y = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (y.shape[0] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = np.hanning(win + 1)[:-1]
    return np.abs(np.fft.rfft(y[idx] * window, n=n_fft, axis=-1)).T


def melspectrogram(wav, fmin: float = 55.0,
                   params: MelParams = MelParams()) -> np.ndarray:
    """wav [T] -> mel [80, n_frames] float32 in [-4, 4]."""
    p = replace(params, fmin=float(fmin))
    basis = mel_filterbank(p.sample_rate, p.n_fft, p.num_mels, p.fmin,
                           p.fmax).astype(np.float64)
    wav = np.asarray(wav, np.float32).astype(np.float64)
    d = stft_magnitude(preemphasis(wav, p.preemphasis), p.n_fft,
                       p.hop_size, p.win_size)
    min_level = np.exp(p.min_level_db / 20.0 * np.log(10.0))
    s = 20.0 * np.log10(np.maximum(min_level, basis @ d)) - p.ref_level_db
    s = np.clip((2 * p.max_abs_value) * ((s - p.min_level_db)
                                         / (-p.min_level_db))
                - p.max_abs_value, -p.max_abs_value, p.max_abs_value)
    return s.astype(np.float32)


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """A wav file as float32 [-1, 1] mono at rate ``sr``."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly
    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if rate != sr:
        from math import gcd
        g = gcd(rate, sr)
        data = resample_poly(data, sr // g, rate // g).astype(np.float32)
    return data


def crop_audio_window(spec: np.ndarray, start_frame: int, fps: int = 25,
                      mel_step_size: int = 16) -> np.ndarray:
    """The 16-mel-frame window aligned to a video frame.  spec [T, 80]."""
    start_idx = int(80.0 * (start_frame / float(fps)))
    end_idx = start_idx + mel_step_size
    if end_idx > spec.shape[0]:
        start_idx = spec.shape[0] - mel_step_size
        end_idx = spec.shape[0]
    return spec[start_idx:end_idx, :]
