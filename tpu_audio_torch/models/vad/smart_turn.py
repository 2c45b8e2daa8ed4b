"""SmartTurn end-of-turn detection on the PyTorch port.

Port of tpu_audio.models.vad.smart_turn: a small Whisper-style pre-LN
transformer encoder over 8 s of Whisper log-mel features, tanh attention
pooling and an MLP classifier (Linear-LN-GELU-Linear-GELU-Linear) with a
sigmoid "turn is complete" probability.

Preprocessing: resample to 16 kHz, keep the LAST ``max_audio_seconds``
seconds (left-pad with zeros when shorter), mean/std normalise (host
NumPy), then ``core.dsp.log_mel_spectrogram`` on the model's device (on
CUDA its projection and log run through kernel 1, ``ops.mel.fused_log_mel``,
once a clip: 800 frames x 201 bins x 80 mels at 8 s) and a pad or trim on
the left to exactly ``max_audio_seconds * sr / hop`` frames. The encoder
runs in plain PyTorch ops, its convolutions in full f32
(``nn.f32_convolutions``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, loading, nn
from tpu_audio_torch.core.audio_io import resample_audio

__all__ = ["SmartTurn", "SmartTurnConfig", "SmartTurnEndpointOutput", "forward", "sanitize",
           "init_random_params"]


@dataclass
class SmartTurnConfig:
    """The encoder's and the processor's settings, flattened."""

    num_mel_bins: int = 80
    max_source_positions: int = 400
    d_model: int = 384
    encoder_attention_heads: int = 6
    encoder_layers: int = 4
    encoder_ffn_dim: int = 1536
    k_proj_bias: bool = False
    sampling_rate: int = 16000
    max_audio_seconds: int = 8
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 80
    normalize_audio: bool = True
    threshold: float = 0.5

    @classmethod
    def from_dict(cls, d: dict) -> "SmartTurnConfig":
        merged = dict(d.get("encoder_config", {}))
        merged.update(d.get("processor_config", {}))
        for k in ("sample_rate", "max_audio_seconds", "threshold"):
            if k in d:
                merged["sampling_rate" if k == "sample_rate" else k] = d[k]
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in merged.items() if k in keys})


@dataclass
class SmartTurnEndpointOutput:
    prediction: int
    probability: float


def _encoder_layer(p, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Pre-LN Whisper encoder layer, erf GELU, unmasked attention."""
    h = nn.layer_norm(p["self_attn_layer_norm"], x)
    a = p["self_attn"]
    b, t, d = x.shape
    hd = d // n_heads

    def heads(name):
        return nn.linear(a[name], h).reshape(b, t, n_heads, hd).transpose(1, 2)

    o = nn.sdpa(heads("q_proj"), heads("k_proj"), heads("v_proj"))
    x = x + nn.linear(a["out_proj"], o.transpose(1, 2).reshape(b, t, d))
    h = nn.layer_norm(p["final_layer_norm"], x)
    return x + nn.linear(p["fc2"], nn.gelu(nn.linear(p["fc1"], h)))


def forward(params, features: torch.Tensor, cfg: SmartTurnConfig) -> torch.Tensor:
    """features ``[B, n_mels, T]`` (HF layout) -> probability ``[B, 1]``."""
    e = params["encoder"]
    x = features.transpose(1, 2)
    x = nn.gelu(nn.conv1d(e["conv1"], x, padding=1))
    x = nn.gelu(nn.conv1d(e["conv2"], x, stride=2, padding=1))
    x = x + e["embed_positions"]["weight"][None, : x.shape[1]].to(x.dtype)
    for i in range(cfg.encoder_layers):
        x = _encoder_layer(e["layers"][str(i)], x, cfg.encoder_attention_heads)
    hidden = nn.layer_norm(e["layer_norm"], x)
    # tanh attention pooling over time
    attn = nn.linear(params["pool_attention_2"],
                     torch.tanh(nn.linear(params["pool_attention_0"], hidden)))
    attn = torch.softmax(attn.to(torch.float32), dim=1)
    pooled = (hidden.to(torch.float32) * attn).sum(dim=1)
    h = nn.layer_norm(params["classifier_1"], nn.linear(params["classifier_0"], pooled))
    h = nn.gelu(nn.linear(params["classifier_4"], nn.gelu(h)))
    return torch.sigmoid(nn.linear(params["classifier_6"], h))


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``inner.`` stripped, the dotted submodule names of the pooling and
    classifier to underscores, conv and linear layouts fixed by shape,
    ``val_*`` entries dropped."""
    out = {}
    for k, v in weights.items():
        if k.startswith("val_"):
            continue
        if k.startswith("inner."):
            k = k[len("inner."):]
        for a, b in (("pool_attention.0.", "pool_attention_0."),
                     ("pool_attention.2.", "pool_attention_2."),
                     ("classifier.0.", "classifier_0."), ("classifier.1.", "classifier_1."),
                     ("classifier.4.", "classifier_4."), ("classifier.6.", "classifier_6.")):
            if k.startswith(a):
                k = b + k[len(a):]
        if k in ("encoder.conv1.weight", "encoder.conv2.weight") and v.ndim == 3:
            if v.shape[1] == 3:  # MLX [O, K, I] -> [O, I, K]
                v = v.permute(0, 2, 1).contiguous()
        if k.endswith("fc1.weight") and v.ndim == 2 and v.shape[0] < v.shape[1]:
            v = v.t().contiguous()
        if k.endswith("fc2.weight") and v.ndim == 2 and v.shape[0] > v.shape[1]:
            v = v.t().contiguous()
        if k == "pool_attention_0.weight" and v.ndim == 2 and v.shape[0] != 256:
            v = v.t().contiguous()
        if k == "pool_attention_2.weight" and v.ndim == 2 and v.shape[0] != 1:
            v = v.t().contiguous()
        out[k] = v
    return out


def init_random_params(cfg: SmartTurnConfig, seed: int = 0, device=None) -> dict:
    """Random f32 params in the sanitized checkpoint's layout at ``cfg``'s
    widths (pooling 256, classifier 256 -> 64 -> 1 as in the checkpoint),
    drawn on ``device`` from a ``torch.Generator``: weights N(0, 1/fan_in),
    biases N(0, 0.02), LayerNorm weights 1 + N(0, 0.1) and biases
    N(0, 0.1), positions N(0, 0.02); ``k_proj`` has no bias."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def lin(o, i, bias=True):
        p = {"weight": randn(o, i, std=i ** -0.5)}
        if bias:
            p["bias"] = randn(o, std=0.02)
        return p

    def ln(d):
        return {"weight": 1.0 + randn(d, std=0.1), "bias": randn(d, std=0.1)}

    d, f, m = cfg.d_model, cfg.encoder_ffn_dim, cfg.num_mel_bins
    layers = {str(i): {"self_attn": {"q_proj": lin(d, d), "k_proj": lin(d, d, cfg.k_proj_bias),
                                     "v_proj": lin(d, d), "out_proj": lin(d, d)},
                       "self_attn_layer_norm": ln(d), "fc1": lin(f, d), "fc2": lin(d, f),
                       "final_layer_norm": ln(d)}
              for i in range(cfg.encoder_layers)}
    return {"encoder": {"conv1": {"weight": randn(d, m, 3, std=(3 * m) ** -0.5),
                                  "bias": randn(d, std=0.02)},
                        "conv2": {"weight": randn(d, d, 3, std=(3 * d) ** -0.5),
                                  "bias": randn(d, std=0.02)},
                        "embed_positions": {"weight": randn(cfg.max_source_positions, d,
                                                            std=0.02)},
                        "layers": layers, "layer_norm": ln(d)},
            "pool_attention_0": lin(256, d), "pool_attention_2": lin(1, 256),
            "classifier_0": lin(256, d), "classifier_1": ln(256), "classifier_4": lin(64, 256),
            "classifier_6": lin(1, 64)}


class SmartTurn:
    """SmartTurn on its params' device: ``prepare_audio`` (host),
    ``prepare_input_features`` (the device's log-mel), ``__call__`` on
    features and ``predict_endpoint`` on audio."""

    def __init__(self, config: SmartTurnConfig, params, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.sample_rate = config.sampling_rate
        self.device = params["encoder"]["conv1"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "SmartTurn":
        """Load a local checkpoint directory onto ``device``."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = SmartTurnConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        return cls(config, loading.to_device(params, device), dtype)

    # -- preprocessing ----------------------------------------------------------

    def prepare_audio(self, audio, sample_rate: int | None = None) -> np.ndarray:
        """Resample, keep the last ``max_audio_seconds`` (left zero pad when
        shorter), mean/std normalise."""
        cfg = self.config
        audio = np.asarray(audio, np.float32).reshape(-1)
        src = sample_rate or cfg.sampling_rate
        if src != cfg.sampling_rate:
            audio = resample_audio(audio, src, cfg.sampling_rate)
        max_samples = cfg.max_audio_seconds * cfg.sampling_rate
        if len(audio) > max_samples:
            audio = audio[-max_samples:]
        elif len(audio) < max_samples:
            audio = np.concatenate([np.zeros(max_samples - len(audio), np.float32), audio])
        if cfg.normalize_audio and len(audio):
            std = max(float(audio.std()), 1e-7)
            audio = (audio - audio.mean()) / std
        return audio

    @torch.inference_mode()
    def prepare_input_features(self, audio, sample_rate: int | None = None) -> torch.Tensor:
        """audio -> Whisper log-mel ``[n_mels, target_frames]`` f32 on the
        model's device (kernel 1 on CUDA), padded or trimmed on the left."""
        cfg = self.config
        prepared = self.prepare_audio(audio, sample_rate)
        mel = dsp.log_mel_spectrogram(prepared, n_mels=cfg.n_mels, n_fft=cfg.n_fft,
                                      hop_length=cfg.hop_length, sample_rate=cfg.sampling_rate,
                                      device=self.device)
        target = cfg.max_audio_seconds * cfg.sampling_rate // cfg.hop_length
        if mel.shape[1] > target:
            mel = mel[:, -target:]
        elif mel.shape[1] < target:
            mel = torch.nn.functional.pad(mel, (target - mel.shape[1], 0))
        return mel.contiguous()

    # -- inference --------------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, features) -> torch.Tensor:
        """Features ``[n_mels, T]`` or ``[B, n_mels, T]`` (array or tensor)
        -> probabilities ``[B, 1]`` f32 on the device."""
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.ascontiguousarray(features, np.float32))
        features = features.to(self.device, self.dtype)
        if features.ndim == 2:
            features = features[None]
        with nn.f32_convolutions():
            return forward(self.params, features, self.config).to(torch.float32)

    def predict_endpoint(self, audio, sample_rate: int | None = None,
                         threshold: float | None = None) -> SmartTurnEndpointOutput:
        """audio -> the end-of-turn decision; the mel stays on the device and
        one probability is read back."""
        prob = float(self(self.prepare_input_features(audio, sample_rate))[0, 0])
        thr = threshold if threshold is not None else self.config.threshold
        return SmartTurnEndpointOutput(prediction=int(prob > thr), probability=prob)
