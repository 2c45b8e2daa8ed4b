"""WAV reading and resampling on the host (port of the reading half of
tpu_audio.core.audio_io): PCM 8/16/24/32-bit and IEEE-float WAV, mixed to
mono, resampled with scipy's polyphase filter."""

from __future__ import annotations

import math
import os
import struct

import numpy as np

__all__ = ["load_audio", "resample_audio"]


def _pcm24_to_float(raw: bytes) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
    vals = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    vals = np.where(vals & 0x800000, vals - (1 << 24), vals)
    return (vals / float(1 << 23)).astype(np.float32)


def _read_wav_any(path: str) -> tuple[np.ndarray, int]:
    """Read PCM (8/16/24/32-bit) or IEEE-float WAV. Returns ([T, C], sr)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    frames = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            frames = body
        pos += 8 + size + (size & 1)
    if fmt is None or frames is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits != 32 else 3
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(frames, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(frames, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            x = _pcm24_to_float(frames)
        elif bits == 8:
            x = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(frames, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")
    return x.reshape(-1, n_channels), sample_rate


def resample_audio(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    return resample_poly(np.asarray(audio, np.float64), up, down, axis=0).astype(
        np.float32
    )


def load_audio(path: str, sample_rate: int | None = None,
               mono: bool = True) -> tuple[np.ndarray, int]:
    """Load a WAV file to float32, optionally mixing to mono and
    resampling. Returns ``(audio, sr)``, ``audio`` shaped ``[T]`` if mono
    else ``[T, C]``."""
    x, sr = _read_wav_any(os.fspath(path))
    if mono:
        x = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
    if sample_rate is not None and sr != sample_rate:
        x = resample_audio(x, sr, sample_rate)
        sr = sample_rate
    return np.ascontiguousarray(x, np.float32), sr
