"""MFCC features compatible with python_speech_features defaults
(counterpart of ``speech2lip_tpu/ops/mfcc.py``, the same numbers).

The DeepSpeech-0.1.0 input pipeline computes 26-cepstrum MFCCs with
python_speech_features' exact conventions: HTK mel scale, integer-bin
triangular filters, DCT-II ortho, ceplifter 22, first coefficient replaced
by log frame energy, rectangular window.

Host-side numpy (runs once per clip); the DeepSpeech RNN that consumes
these runs on the card (``models/deepspeech.py``).
"""

from __future__ import annotations

import numpy as np


def _hz2mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel2hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def _framesig(sig: np.ndarray, frame_len: int, frame_step: int) -> np.ndarray:
    slen = len(sig)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(np.ceil((slen - frame_len) / frame_step))
    padlen = (numframes - 1) * frame_step + frame_len
    padded = np.concatenate([sig, np.zeros(padlen - slen)])
    idx = (np.arange(frame_len)[None, :]
           + np.arange(numframes)[:, None] * frame_step)
    return padded[idx]


def filterbank_htk(nfilt: int, nfft: int, samplerate: int,
                   lowfreq: float = 0.0,
                   highfreq: float | None = None) -> np.ndarray:
    """[nfilt, nfft//2+1] integer-bin triangular filterbank (HTK mel)."""
    highfreq = highfreq or samplerate / 2
    mel_pts = np.linspace(_hz2mel_htk(lowfreq), _hz2mel_htk(highfreq),
                          nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz_htk(mel_pts) / samplerate).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fb


def _dct2_ortho(x: np.ndarray) -> np.ndarray:
    from scipy.fftpack import dct
    return dct(x, type=2, axis=1, norm="ortho")


def mfcc(signal: np.ndarray, samplerate: int = 16000, winlen: float = 0.025,
         winstep: float = 0.01, numcep: int = 26, nfilt: int = 26,
         nfft: int = 512, preemph: float = 0.97, ceplifter: int = 22,
         append_energy: bool = True) -> np.ndarray:
    """[T, numcep] MFCCs; bit-matches python_speech_features.mfcc defaults."""
    signal = np.asarray(signal, np.float64)
    sig = np.append(signal[0], signal[1:] - preemph * signal[:-1])
    frames = _framesig(sig, int(round(winlen * samplerate)),
                       int(round(winstep * samplerate)))
    mag = np.abs(np.fft.rfft(frames, nfft, axis=1))
    pspec = (1.0 / nfft) * mag ** 2
    energy = pspec.sum(axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)

    fb = filterbank_htk(nfilt, nfft, samplerate)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = _dct2_ortho(np.log(feat))[:, :numcep]

    if ceplifter > 0:
        n = np.arange(numcep)
        lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)
        feat = feat * lift
    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat


def deepspeech_input_vector(audio_int16: np.ndarray, sample_rate: int = 16000,
                            num_cepstrum: int = 26,
                            num_context: int = 9) -> np.ndarray:
    """MFCC → strided context windows → globally standardized [T, 494]
    (reference deepspeech_features.py:186-242)."""
    feats = mfcc(audio_int16, samplerate=sample_rate, numcep=num_cepstrum)
    feats = feats[::2]  # BiRNN stride 2
    n = len(feats)
    empty = np.zeros((num_context, num_cepstrum), feats.dtype)
    feats = np.concatenate([empty, feats, empty])
    win = 2 * num_context + 1
    out = np.stack([feats[i:i + win].reshape(-1) for i in range(n)])
    return ((out - out.mean()) / out.std()).astype(np.float32)
