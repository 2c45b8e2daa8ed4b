"""Silero VAD on the PyTorch port: STFT-conv + LSTM speech probabilities.

Port of tpu_audio.models.vad.silero: two branches (16 kHz: 512-sample
chunks with 64 samples of context; 8 kHz: 256 with 32), offline
``predict_proba`` for one row or B rows, ``get_speech_timestamps``, and the
streaming ``feed`` over one chunk at a time.

Design for the card. The JAX package runs its convolutional frontend once a
chunk inside a ``lax.scan``. Each window (context + chunk, reflect-padded on
the right) reduces to ONE LSTM frame (the STFT conv gives 4 frames, the two
stride-2 convs 2 and then 1). So the frontend, the LSTM's input projection
and, after the recurrence, the final conv and sigmoid each run once over
all N x B windows; only the LSTM's hidden recurrence runs N steps
(``core.nn.lstm``). It is the same function as the scan. Convolutions run
in full f32 (``nn.f32_convolutions``), as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import hub, loading, nn

__all__ = ["SileroVAD", "SileroVADConfig", "SileroBranchConfig", "SileroTimestamp",
           "sanitize", "init_random_params", "probs_to_timestamps"]

HIDDEN = 128


@dataclass
class SileroBranchConfig:
    sample_rate: int = 16000
    filter_length: int = 256
    hop_length: int = 128
    pad: int = 64
    cutoff: int = 129
    context_size: int = 64
    chunk_size: int = 512


def _branch_8k() -> SileroBranchConfig:
    return SileroBranchConfig(sample_rate=8000, filter_length=128, hop_length=64, pad=32,
                              cutoff=65, context_size=32, chunk_size=256)


@dataclass
class SileroVADConfig:
    threshold: float = 0.5
    min_speech_duration_ms: int = 250
    min_silence_duration_ms: int = 100
    speech_pad_ms: int = 30
    branch16k: SileroBranchConfig = field(default_factory=SileroBranchConfig)
    branch8k: SileroBranchConfig = field(default_factory=_branch_8k)

    @classmethod
    def from_dict(cls, d: dict) -> "SileroVADConfig":
        cfg = cls()
        for k in ("threshold", "min_speech_duration_ms", "min_silence_duration_ms",
                  "speech_pad_ms"):
            if k in d:
                setattr(cfg, k, d[k])
        return cfg


@dataclass
class SileroTimestamp:
    start: int
    end: int


_BRANCH_CFGS = {16000: SileroBranchConfig(), 8000: _branch_8k()}
_BRANCH_KEYS = {16000: "branch16k", 8000: "branch8k"}


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``vad_16k``/``vad_8k`` prefixes -> ``branch16k``/``branch8k``; MLX conv
    layout ``[O, K, I]`` -> ``[O, I, K]``; MLX LSTM ``Wx``/``Wh``/``bias`` ->
    ``weight_ih``/``weight_hh``/``bias_ih``; ``val_*`` entries dropped."""
    out = {}
    for k, v in weights.items():
        if k.startswith("val_"):
            continue
        k = k.replace("vad_16k.", "branch16k.").replace("vad_8k.", "branch8k.")
        if k.endswith(".weight") and v.ndim == 3 and "conv" in k:
            v = v.permute(0, 2, 1).contiguous()
        k = k.replace("lstm.Wx", "lstm.weight_ih").replace(
            "lstm.Wh", "lstm.weight_hh").replace("lstm.bias", "lstm.bias_ih")
        out[k] = v
    return out


def _frontend(p, windows: torch.Tensor, cfg: SileroBranchConfig) -> torch.Tensor:
    """Windows ``[M, ctx + chunk]`` -> LSTM inputs ``[M, 128]``: reflect pad
    on the right (``window[n-2 : n-pad-2 : -1]``, which skips the last
    sample), the STFT conv's magnitude, conv1-4 with ReLU; one frame a
    window."""
    n = windows.shape[-1]
    reflected = windows[:, n - cfg.pad - 1 : n - 1].flip(-1)
    x = torch.cat([windows, reflected], dim=-1)[..., None]  # [M, T, 1]
    x = nn.conv1d(p["stft_conv"], x, stride=cfg.hop_length)  # [M, F, 2 * cutoff]
    real, imag = x[..., : cfg.cutoff], x[..., cfg.cutoff : 2 * cfg.cutoff]
    x = torch.sqrt(real * real + imag * imag)
    x = torch.relu(nn.conv1d(p["conv1"], x, padding=1))
    x = torch.relu(nn.conv1d(p["conv2"], x, stride=2, padding=1))
    x = torch.relu(nn.conv1d(p["conv3"], x, stride=2, padding=1))
    x = torch.relu(nn.conv1d(p["conv4"], x, padding=1))
    if x.shape[1] != 1:
        raise ValueError(f"Silero frontend gave {x.shape[1]} frames a window (expected 1)")
    return x[:, 0]


def _head(p, hs: torch.Tensor) -> torch.Tensor:
    """LSTM outputs ``[..., T, 128]`` -> probabilities ``[..., T]``."""
    return torch.sigmoid(nn.conv1d(p["final_conv"], torch.relu(hs)))[..., 0]


def init_random_params(seed: int = 0, device=None) -> dict:
    """Random f32 params at the published widths of both branches (the
    checkpoint's shapes: STFT conv ``2 cutoff x filter_length``, convs
    128/64/64/128, LSTM 128, final conv 1), drawn on ``device`` from a
    ``torch.Generator``. The STFT conv holds the Hann-windowed real DFT
    basis, as Silero's fixed STFT buffer does; the other weights are
    N(0, 1/fan_in) and the biases N(0, 0.1)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, std=None):
        s = std if std is not None else int(np.prod(shape[1:])) ** -0.5
        return torch.randn(shape, generator=gen, device=device) * s

    def conv(o, i, k):
        return {"weight": rand(o, i, k), "bias": rand(o, std=0.1)}

    params = {}
    for sr, key in _BRANCH_KEYS.items():
        cfg = _BRANCH_CFGS[sr]
        n = np.arange(cfg.filter_length)
        f = np.arange(cfg.cutoff)[:, None]
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / cfg.filter_length)
        ang = 2 * np.pi * f * n[None] / cfg.filter_length
        basis = np.concatenate([np.cos(ang), -np.sin(ang)]) * window
        params[key] = {
            "stft_conv": {"weight": torch.from_numpy(basis[:, None].astype(np.float32)
                                                     ).to(device)},
            "conv1": conv(128, cfg.cutoff, 3), "conv2": conv(64, 128, 3),
            "conv3": conv(64, 64, 3), "conv4": conv(128, 64, 3),
            "lstm": {"weight_ih": rand(4 * HIDDEN, HIDDEN), "weight_hh": rand(4 * HIDDEN, HIDDEN),
                     "bias_ih": rand(4 * HIDDEN, std=0.1)},
            "final_conv": conv(1, HIDDEN, 1),
        }
    return params


class SileroVAD:
    """Silero VAD with offline ``predict_proba`` / ``get_speech_timestamps``
    and streaming ``feed``; it computes in f32 on its params' device."""

    def __init__(self, config: SileroVADConfig, params):
        self.config = config
        self.params = params
        self.device = params["branch16k"]["conv1"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, device="cuda") -> "SileroVAD":
        """Load a local checkpoint directory (MLX layout) onto ``device``."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = SileroVADConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=torch.float32)
        return cls(config, loading.to_device(params, device))

    def _branch(self, sample_rate: int):
        if sample_rate not in _BRANCH_KEYS:
            raise ValueError(f"Silero VAD supports 8000/16000 Hz (got {sample_rate})")
        return self.params[_BRANCH_KEYS[sample_rate]], _BRANCH_CFGS[sample_rate]

    # -- offline ---------------------------------------------------------------

    @torch.inference_mode()
    def predict_proba(self, audio: np.ndarray, sample_rate: int = 16000) -> np.ndarray:
        """Per-chunk speech probabilities ``[N]`` (``[B, N]`` for batched
        input), one a 512 / 256 samples, the last chunk zero-padded."""
        p, cfg = self._branch(sample_rate)
        a = np.asarray(audio, np.float32)
        squeeze = a.ndim == 1
        if squeeze:
            a = a[None]
        if a.shape[-1] == 0:
            return np.zeros((0,) if squeeze else (a.shape[0], 0), np.float32)
        cs, ctx = cfg.chunk_size, cfg.context_size
        pad = (cs - a.shape[-1] % cs) % cs
        x = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        x = torch.nn.functional.pad(x, (ctx, pad))
        windows = x.unfold(-1, ctx + cs, cs)  # [B, N, ctx + cs]
        b, n_chunks = windows.shape[:2]
        with nn.f32_convolutions():
            feats = _frontend(p, windows.reshape(b * n_chunks, -1), cfg)
            hs, _ = nn.lstm(p["lstm"], feats.reshape(b, n_chunks, HIDDEN))
            probs = _head(p, hs).cpu().numpy()
        return probs[0] if squeeze else probs

    def get_speech_timestamps(
        self, audio: np.ndarray, sample_rate: int = 16000,
        threshold: float | None = None,
        min_speech_duration_ms: int | None = None,
        min_silence_duration_ms: int | None = None,
        speech_pad_ms: int | None = None,
    ) -> list[SileroTimestamp]:
        probs = self.predict_proba(audio, sample_rate)
        audio_len = np.asarray(audio).shape[-1]
        return probs_to_timestamps(
            probs, audio_len, sample_rate,
            threshold if threshold is not None else self.config.threshold,
            min_speech_duration_ms or self.config.min_speech_duration_ms,
            min_silence_duration_ms or self.config.min_silence_duration_ms,
            speech_pad_ms if speech_pad_ms is not None else self.config.speech_pad_ms,
        )

    # -- streaming -------------------------------------------------------------

    def initial_state(self, batch: int = 1, sample_rate: int = 16000) -> dict:
        _, cfg = self._branch(sample_rate)

        def zeros(n):
            return torch.zeros((batch, n), dtype=torch.float32, device=self.device)

        return {"h": zeros(HIDDEN), "c": zeros(HIDDEN), "context": zeros(cfg.context_size),
                "sample_rate": sample_rate}

    @torch.inference_mode()
    def feed(self, chunk: np.ndarray, state: dict | None = None, sample_rate: int = 16000):
        """One 512 / 256-sample chunk (``[n]`` or ``[B, n]``) -> (probabilities
        ``[B]``, new state); the state's ``h``, ``c`` and ``context`` stay on
        the model's device."""
        p, cfg = self._branch(sample_rate)
        c = np.asarray(chunk, np.float32)
        if c.ndim == 1:
            c = c[None]
        if c.shape[-1] != cfg.chunk_size:
            raise ValueError(f"expected {cfg.chunk_size} samples per chunk, got {c.shape[-1]}")
        if state is None:
            state = self.initial_state(c.shape[0], sample_rate)
        if state["sample_rate"] != sample_rate:
            raise ValueError("streaming state sample-rate mismatch")
        x = torch.from_numpy(np.ascontiguousarray(c)).to(self.device)
        window = torch.cat([state["context"], x], dim=-1)
        with nn.f32_convolutions():
            feats = _frontend(p, window, cfg)
            hs, (h, c_) = nn.lstm(p["lstm"], feats[:, None], state["h"], state["c"])
            prob = _head(p, hs)[:, 0].cpu().numpy()
        return prob, {"h": h, "c": c_, "context": x[:, -cfg.context_size:],
                      "sample_rate": sample_rate}


def probs_to_timestamps(probs, audio_len: int, sample_rate: int,
                        threshold: float, min_speech_duration_ms: int,
                        min_silence_duration_ms: int, speech_pad_ms: int
                        ) -> list[SileroTimestamp]:
    """Hysteresis thresholding of chunk probabilities into speech runs
    (host NumPy, as in the JAX package)."""
    probs = np.asarray(probs)
    if probs.ndim == 2:
        probs = probs[0]
    chunk = 512 if sample_rate == 16000 else 256
    min_speech = sample_rate * min_speech_duration_ms / 1000
    min_silence = sample_rate * min_silence_duration_ms / 1000
    pad = int(sample_rate * speech_pad_ms / 1000)
    neg_threshold = max(threshold - 0.15, 0.01)

    speeches: list[list[int]] = []
    triggered = False
    current_start = temp_end = 0
    for i, p in enumerate(probs):
        start = i * chunk
        if p >= threshold and not triggered:
            triggered, current_start, temp_end = True, start, 0
            continue
        if triggered and p >= threshold:
            temp_end = 0
            continue
        if triggered and p < neg_threshold:
            if temp_end == 0:
                temp_end = start
            if start - temp_end >= min_silence:
                if temp_end - current_start >= min_speech:
                    speeches.append([current_start, temp_end])
                triggered, temp_end = False, 0
    if triggered:
        end = min(audio_len, len(probs) * chunk)
        if end - current_start >= min_speech:
            speeches.append([current_start, end])

    padded: list[list[int]] = []
    for s, e in speeches:
        s, e = max(0, s - pad), min(audio_len, e + pad)
        if padded and s <= padded[-1][1]:
            padded[-1][1] = max(padded[-1][1], e)
        else:
            padded.append([s, e])
    return [SileroTimestamp(s, e) for s, e in padded]
