"""WAV reading, writing and resampling on the host (port of
tpu_audio.core.audio_io's WAV half): PCM 8/16/24/32-bit and IEEE-float WAV
in, mixed to mono, resampled with scipy's polyphase filter; 16-bit PCM WAV
out, whole or streamed."""

from __future__ import annotations

import io
import math
import os
import struct
import wave
from dataclasses import dataclass

import numpy as np

__all__ = ["load_audio", "resample_audio", "float_to_pcm16", "save_wav",
           "StreamingWAVWriter"]


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


def float_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> little-endian int16 (clipped, rounded)."""
    return np.round(np.clip(np.asarray(audio), -1.0, 1.0) * 32767.0).astype("<i2")


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio ([-1, 1], shape [T] or [T, C]) as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = float_to_pcm16(audio)
    with wave.open(os.fspath(path), "wb") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


@dataclass
class StreamingWAVWriter:
    """Incremental 16-bit PCM WAV writer: chunks go to disk as they come,
    and ``close()`` finalises the RIFF header."""

    path: str
    sample_rate: int
    n_channels: int = 1

    def __post_init__(self):
        self._f = open(self.path, "wb")
        self._bytes_written = 0
        self._write_header(0)

    def _write_header(self, data_bytes: int) -> None:
        hdr = io.BytesIO()
        hdr.write(b"RIFF")
        hdr.write(struct.pack("<I", 36 + data_bytes))
        hdr.write(b"WAVEfmt ")
        hdr.write(struct.pack("<IHHIIHH", 16, 1, self.n_channels, self.sample_rate,
                              self.sample_rate * self.n_channels * 2,
                              self.n_channels * 2, 16))
        hdr.write(b"data")
        hdr.write(struct.pack("<I", data_bytes))
        self._f.seek(0)
        self._f.write(hdr.getvalue())

    def append(self, audio: np.ndarray) -> None:
        """Append a float32 chunk (shape [T] or [T, C])."""
        audio = np.asarray(audio)
        if audio.ndim == 1:
            audio = audio[:, None]
        pcm = float_to_pcm16(audio).tobytes()
        self._f.seek(0, os.SEEK_END)
        self._f.write(pcm)
        self._bytes_written += len(pcm)

    def close(self) -> None:
        self._write_header(self._bytes_written)
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
