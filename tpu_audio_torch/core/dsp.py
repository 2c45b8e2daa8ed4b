"""Windows, mel filterbanks, the STFT and its inverse, power to dB and
Whisper's log-mel frontend (port of the window, STFT, ISTFT, dB and log-mel
parts of tpu_audio.core.dsp).

Window and filterbank construction is host-side NumPy, identical to the
JAX package's; the STFT runs through ``torch.stft`` after reflect or
constant centre padding, and the ISTFT is an overlap-add of the windowed
``irfft`` frames normalised by the window's sum of squares. The mel
projection and log10 of Whisper's frontend and of the generic
``mel_spectrogram`` (symmetric Hann, HTK filters) run through
``ops.mel.fused_log_mel`` (the CUDA kernel for CUDA tensors). The global
``max - 8`` clamp and ``(x + 4) / 4`` normalisation follow as in the JAX
package.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpu_audio_torch.ops.mel import fused_log_mel

__all__ = ["hanning_window", "hamming_window", "mel_filters", "stft", "irfft",
           "istft", "power_to_db", "log_mel_spectrogram", "mel_spectrogram"]


@functools.lru_cache(maxsize=32)
def hanning_window(size: int, periodic: bool = False) -> np.ndarray:
    """Hann window; ``periodic=True`` is torch's ``hann_window`` default
    (denominator ``size``), which Whisper's frontend uses."""
    if size <= 0:
        return np.zeros((0,), np.float32)
    if size == 1:
        return np.ones((1,), np.float32)
    n = np.arange(size, dtype=np.float64)
    denom = float(size if periodic else size - 1)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=32)
def hamming_window(size: int, periodic: bool = True) -> np.ndarray:
    """Hamming window, periodic by default (``periodic=False``: the
    symmetric window)."""
    if size <= 0:
        return np.zeros((0,), np.float32)
    if size == 1:
        return np.ones((1,), np.float32)
    eff = size + 1 if periodic else size
    n = np.arange(eff, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (eff - 1))
    return w[:size].astype(np.float32)


def _hz_to_mel(freq, mel_scale: str, f_min: float = 0.0):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    log_step = math.log(6.4) / 27.0
    lin = (freq - f_min) / f_sp
    log = min_log_mel + np.log(np.maximum(freq, 1e-12) / min_log_hz) / log_step
    return np.where(freq < min_log_hz, lin, log)


def _mel_to_hz(mel, mel_scale: str, f_min: float = 0.0):
    mel = np.asarray(mel, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (np.power(10.0, mel / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    log_step = math.log(6.4) / 27.0
    lin = f_min + f_sp * mel
    log = min_log_hz * np.exp(log_step * (mel - min_log_mel))
    return np.where(mel < min_log_mel, lin, log)


@functools.lru_cache(maxsize=64)
def mel_filters(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                f_max: float | None = None, norm: str | None = "slaney",
                mel_scale: str = "htk") -> np.ndarray:
    """Triangular mel filterbank ``[n_freqs, n_mels]``: half-open rising
    edge, closed falling edge, optional slaney area normalisation."""
    if mel_scale not in ("htk", "slaney"):
        raise ValueError(f"unknown mel_scale {mel_scale!r}")
    f_max_val = f_max if f_max is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    m_min = float(_hz_to_mel(f_min, mel_scale, f_min))
    m_max = float(_hz_to_mel(f_max_val, mel_scale, f_min))
    m_pts = m_min + np.arange(n_mels + 2, dtype=np.float64) * (m_max - m_min) / (
        n_mels + 1)
    f_pts = _mel_to_hz(m_pts, mel_scale, f_min)
    low = f_pts[:-2][None, :]
    center = f_pts[1:-1][None, :]
    high = f_pts[2:][None, :]
    f = all_freqs[:, None]
    rising = (f - low) / np.maximum(center - low, 1e-12)
    falling = (high - f) / np.maximum(high - center, 1e-12)
    fb = np.where((f >= low) & (f < center), rising, 0.0)
    fb = np.where((f >= center) & (f <= high), falling, fb)
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb.astype(np.float32)


def _reflect_pad_1d(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad without edge duplication, zero-filling where the signal
    is too short to reflect."""
    n = audio.shape[0]
    if n <= 1:
        return torch.nn.functional.pad(audio, (pad, pad))
    cnt = min(pad, n - 1)
    left = audio[1 : cnt + 1].flip(0)
    right = audio[n - 1 - cnt : n - 1].flip(0)
    zeros = audio.new_zeros((pad - cnt,))
    return torch.cat([zeros, left, audio, right, zeros])


def stft(audio: torch.Tensor, window: np.ndarray, n_fft: int, hop_length: int,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """STFT of a 1D signal -> complex ``[n_frames, n_fft//2 + 1]``: centre
    padding by ``n_fft//2`` (``pad_mode`` "reflect", or "constant" zeros),
    frames every ``hop_length``, window, rfft."""
    if pad_mode not in ("reflect", "constant"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    x = audio.reshape(-1).to(torch.float32)
    if center and pad_mode == "reflect":
        x = _reflect_pad_1d(x, n_fft // 2)
    elif center:
        x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2))
    w = torch.from_numpy(np.asarray(window, np.float32)).to(x.device)
    spec = torch.stft(x, n_fft, hop_length=hop_length, win_length=n_fft,
                      window=w, center=False, return_complex=True)
    return spec.transpose(0, 1)


def irfft(spec: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Inverse real FFT of length ``n`` along ``axis``."""
    return torch.fft.irfft(spec, n=n, dim=axis)


def istft(spec: torch.Tensor, window: np.ndarray, n_fft: int, hop_length: int,
          length: int | None = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT of complex ``[n_frames, n_fft//2 + 1]``: each frame's
    ``irfft`` times the window, overlap-added every ``hop_length`` and
    divided by the overlap-added squared window, clamped to at least 1e-11
    (so a window whose edge squares to less, as the vorbis window's does,
    needs no NOLA check); ``center`` drops ``n_fft//2`` samples at each end,
    and ``length`` cuts or zero-pads the result."""
    w = torch.from_numpy(np.asarray(window, np.float32)).to(spec.device)
    frames = irfft(spec, n=n_fft) * w  # [n_frames, n_fft]
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        # [n_frames, n_fft] -> [out_len]: the column of frame i lands at i * hop
        return torch.nn.functional.fold(cols.t()[None], (1, out_len), (1, n_fft),
                                         stride=(1, hop_length)).reshape(out_len)

    sig = overlap_add(frames)
    wsq = overlap_add((w * w).expand(n_frames, n_fft))
    sig = sig / torch.clamp(wsq, min=1e-11)
    if center:
        pad = n_fft // 2
        sig = sig[pad: out_len - pad]
    if length is not None:
        sig = sig[:length]
        if sig.shape[0] < length:
            sig = torch.nn.functional.pad(sig, (0, length - sig.shape[0]))
    return sig


def power_to_db(spectrogram: torch.Tensor, amin: float = 1e-10,
                top_db: float | None = None) -> torch.Tensor:
    """Power to dB, ``10 log10(max(x, amin))``, with the optional
    dynamic-range clamp to ``max - top_db`` over the whole input."""
    db = 10.0 * torch.log10(torch.clamp(spectrogram, min=amin))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def log_mel_spectrogram(audio, n_mels: int = 80, sample_rate: int = 16000,
                        n_fft: int = 400, hop_length: int = 160,
                        device=None) -> torch.Tensor:
    """Whisper log-mel ``[n_mels, n_frames]``: periodic Hann, slaney mel
    scale and norm, the last STFT frame dropped (torch.stft parity),
    log10 clamped to ``max - 8`` and normalised as ``(x + 4) / 4``.
    ``audio`` is a 1D array or tensor; ``device`` (default: the tensor's,
    or the CPU for arrays) is where it is computed."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
    audio = audio.reshape(-1).to(device or audio.device)
    padded_len = audio.shape[0] + 2 * (n_fft // 2)
    n_frames = 1 + (padded_len - n_fft) // hop_length if padded_len >= n_fft else 0
    if n_frames - 1 <= 0:
        return torch.zeros((n_mels, 0), dtype=torch.float32, device=audio.device)
    freqs = stft(audio, hanning_window(n_fft, periodic=True), n_fft, hop_length)
    freqs = freqs[:-1]
    filters = torch.from_numpy(mel_filters(
        sample_rate, n_fft, n_mels, f_min=0.0, f_max=sample_rate / 2.0,
        norm="slaney", mel_scale="slaney")).to(audio.device)
    log_spec = fused_log_mel(freqs.real.contiguous(), freqs.imag.contiguous(),
                             filters)
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.t()


def mel_spectrogram(audio, sample_rate: int, n_fft: int, hop_length: int, n_mels: int,
                    device=None) -> torch.Tensor:
    """The generic normalised log-mel ``[n_frames, n_mels]`` (Qwen3-ASR's
    frontend): symmetric Hann window, reflect-padded STFT with every frame
    kept, HTK-scale filters with slaney norm, log10 clamped to ``max - 8``
    and normalised as ``(x + 4) / 4``. A 2-D input is returned as it is (an
    existing spectrogram); below one frame the result is empty
    ``[0, n_mels]``. ``device`` as in :func:`log_mel_spectrogram`."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
    audio = audio.to(device or audio.device)
    if audio.ndim != 1:
        return audio
    if audio.shape[0] + 2 * (n_fft // 2) < n_fft:
        return torch.zeros((0, n_mels), dtype=torch.float32, device=audio.device)
    freqs = stft(audio, hanning_window(n_fft, periodic=False), n_fft, hop_length)
    filters = torch.from_numpy(mel_filters(sample_rate, n_fft, n_mels, norm="slaney",
                                           mel_scale="htk")).to(audio.device)
    log_spec = fused_log_mel(freqs.real.contiguous(), freqs.imag.contiguous(), filters)
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0
