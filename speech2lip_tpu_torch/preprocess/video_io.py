"""Video ingestion and export (counterpart of
``speech2lip_tpu/preprocess/video_io.py``; the same bytes).

Preprocessing starts from a raw video: its frames and its wav track.  This
module does both without assuming ffmpeg exists on the host:

- ``extract_frames``: ffmpeg if present, else cv2.VideoCapture;
- ``extract_wav``: ffmpeg if present, else a built-in RIFF/AVI demuxer for
  PCM audio streams (the container ``write_avi`` produces);
- ``write_avi``: a dependency-free MJPG+PCM AVI muxer, used to export
  rendered results as a watchable video and to make small fixtures in
  tests.

All host-side I/O: nothing here touches the device.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
from typing import List, Optional, Tuple

import numpy as np


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


# ---------------------------------------------------------------------------
# AVI muxer (MJPG video + optional 16-bit mono PCM audio)
# ---------------------------------------------------------------------------

def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_avi(path: str, frames, fps: float = 25.0,
              audio: Optional[np.ndarray] = None,
              sample_rate: int = 16000, jpeg_quality: int = 95) -> None:
    """Write an MJPG AVI with an optional 16-bit mono PCM audio track.

    frames: iterable of [H, W, 3] uint8 RGB images (all the same size).
    audio: optional int16 (or float in [-1,1]) mono samples.
    """
    import cv2

    frames = list(frames)
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    jpegs: List[bytes] = []
    for f in frames:
        ok, buf = cv2.imencode(".jpg", f[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        if not ok:
            raise RuntimeError("jpeg encode failed")
        jpegs.append(buf.tobytes())

    has_audio = audio is not None
    if has_audio:
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = np.clip(np.asarray(a, np.float64), -1, 1)
            a = (a * 32767.0).astype(np.int16)
        pcm = a.tobytes()

    n = len(jpegs)
    usec_per_frame = int(round(1e6 / fps))
    max_bytes = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<10I", usec_per_frame, max_bytes * int(fps), 0,
        0x10,                       # AVIF_HASINDEX
        n, 0, 2 if has_audio else 1, max_bytes, w, h) + b"\x00" * 16

    strh_v = (b"vids" + b"MJPG" + struct.pack("<IHHI", 0, 0, 0, 0)
              + struct.pack("<5I", 1, int(round(fps)), 0, n, max_bytes)
              + struct.pack("<iI", -1, 0)
              + struct.pack("<4H", 0, 0, w, h))
    strf_v = struct.pack("<IiiHH", 40, w, h, 1, 24) + b"MJPG" \
        + struct.pack("<IiiII", w * h * 3, 0, 0, 0, 0)
    strl_v = _list(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))

    strls = strl_v
    if has_audio:
        n_samples = len(a)
        strh_a = (b"auds" + b"\x00" * 4 + struct.pack("<IHHI", 0, 0, 0, 0)
                  + struct.pack("<5I", 1, sample_rate, 0, n_samples, 0)
                  + struct.pack("<iI", -1, 2)
                  + struct.pack("<4H", 0, 0, 0, 0))
        strf_a = struct.pack("<HHIIHH", 1, 1, sample_rate, sample_rate * 2,
                             2, 16)
        strls += _list(b"strl", _chunk(b"strh", strh_a)
                       + _chunk(b"strf", strf_a))

    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strls)

    movi_payload = b""
    index_entries = []
    offset = 4  # after the 'movi' fourcc
    if has_audio:
        # one audio chunk up front (players resync fine; simplest layout)
        ck = _chunk(b"01wb", pcm)
        index_entries.append((b"01wb", 0x10, offset, len(pcm)))
        movi_payload += ck
        offset += len(ck)
    for j in jpegs:
        ck = _chunk(b"00dc", j)
        index_entries.append((b"00dc", 0x10, offset, len(j)))
        movi_payload += ck
        offset += len(ck)
    movi = _list(b"movi", movi_payload)

    idx1 = b"".join(fcc + struct.pack("<3I", flags, off, ln)
                    for fcc, flags, off, ln in index_entries)
    riff_payload = b"AVI " + hdrl + movi + _chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


# ---------------------------------------------------------------------------
# AVI PCM demuxer (the ffmpeg-free audio-extraction fallback)
# ---------------------------------------------------------------------------

def _iter_chunks(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        yield fourcc, pos + 8, size
        pos += 8 + size + (size % 2)


def demux_avi_pcm(path: str) -> Tuple[int, np.ndarray]:
    """Extract the first PCM audio stream of an AVI → (sample_rate, int16).

    Supports 16-bit PCM ('auds' streams with wFormatTag=1) — the format our
    own muxer writes and the common raw-capture case.  Raises ValueError on
    anything else (install ffmpeg for compressed audio).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    sample_rate = None
    channels = 1
    bits = 16
    audio_stream_idx = None
    pcm_parts: List[bytes] = []

    def walk(start, end, stream_counter):
        nonlocal sample_rate, channels, bits, audio_stream_idx
        for fourcc, data_off, size in _iter_chunks(buf, start, end):
            data_end = data_off + size
            if fourcc == b"LIST":
                ltype = buf[data_off:data_off + 4]
                if ltype == b"strl":
                    idx = stream_counter[0]
                    stream_counter[0] += 1
                    is_audio = False
                    for cc, off2, sz2 in _iter_chunks(buf, data_off + 4,
                                                      data_end):
                        if cc == b"strh" and buf[off2:off2 + 4] == b"auds":
                            is_audio = True
                        if cc == b"strf" and is_audio \
                                and audio_stream_idx is None:
                            fmt, ch, sr = struct.unpack(
                                "<HHI", buf[off2:off2 + 8])
                            if fmt != 1:
                                raise ValueError(
                                    f"{path}: audio stream is not raw PCM "
                                    f"(wFormatTag={fmt}); use ffmpeg")
                            bps = struct.unpack(
                                "<H", buf[off2 + 14:off2 + 16])[0]
                            sample_rate, channels, bits = sr, ch, bps
                            audio_stream_idx = idx
                else:
                    walk(data_off + 4, data_end, stream_counter)
            elif audio_stream_idx is not None and fourcc == (
                    b"%02dwb" % audio_stream_idx):
                pcm_parts.append(buf[data_off:data_end])

    walk(12, len(buf), [0])
    if audio_stream_idx is None or sample_rate is None:
        raise ValueError(f"{path}: no PCM audio stream found")
    if bits != 16:
        raise ValueError(f"{path}: {bits}-bit PCM unsupported; use ffmpeg")
    samples = np.frombuffer(b"".join(pcm_parts), dtype="<i2")
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1).astype(np.int16)
    return sample_rate, samples


# ---------------------------------------------------------------------------
# Extraction entry points (ffmpeg first, built-in fallback)
# ---------------------------------------------------------------------------

def extract_frames(video_path: str, out_dir: str,
                   ext: str = ".jpg") -> Tuple[int, float]:
    """video → out_dir/%05d.jpg.  Returns (n_frames, fps)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    ff = _ffmpeg()
    if ff is not None:
        subprocess.run(
            [ff, "-y", "-loglevel", "error", "-i", video_path,
             "-qscale:v", "2", os.path.join(out_dir, "%05d" + ext)],
            check=True)
        n = len([f for f in os.listdir(out_dir) if f.endswith(ext)])
        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        cap.release()
        return n, fps
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n += 1
        cv2.imwrite(os.path.join(out_dir, f"{n:05d}{ext}"), frame)
    cap.release()
    return n, fps


def extract_wav(video_path: str, out_wav: str,
                sample_rate: int = 16000) -> None:
    """video → 16 kHz mono 16-bit wav (reference extract_wav.py semantics)."""
    ff = _ffmpeg()
    if ff is not None:
        subprocess.run(
            [ff, "-y", "-loglevel", "error", "-i", video_path,
             "-f", "wav", "-ar", str(sample_rate), "-ac", "1", out_wav],
            check=True)
        return
    sr, samples = demux_avi_pcm(video_path)
    if sr != sample_rate:
        # linear resample (the DSP-exact path lives in ops/audio_dsp; this
        # is ingestion, matching ffmpeg's default soxr within tolerance)
        t_out = np.arange(int(round(len(samples) * sample_rate / sr)))
        samples = np.interp(t_out * (sr / sample_rate),
                            np.arange(len(samples)),
                            samples.astype(np.float64)).astype(np.int16)
    from scipy.io import wavfile
    wavfile.write(out_wav, sample_rate, samples)
