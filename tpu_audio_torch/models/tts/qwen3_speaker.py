"""The Qwen3-TTS speaker encoder: an ECAPA-TDNN-style network that turns a
reference clip into the speaker embedding of voice cloning on "base"
checkpoints (port of tpu_audio.models.tts.qwen3_speaker).

TDNN blocks with reflect padding and no batch norm, SE-Res2Net blocks
(hierarchical splits, squeeze-excitation), multi-layer feature
aggregation over the SE blocks' outputs, attentive statistics pooling with
global context and a 1x1 projection. Its frontend is the Whisper-style
log-mel at n_fft 1024, hop 256 and ``mel_dim`` mels at the encoder's
sample rate (``core.dsp.log_mel_spectrogram``: kernel 1 on the card).
Weights keep the torch conv layout ``[O, I, K]``; activations are
channels-last ``[B, T, C]``; everything runs in f32.

This is not ``models.lid.ecapa_lid``: that network pads, normalises and
pools otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.core import dsp, nn

__all__ = ["SpeakerEncoderConfig", "speaker_encoder_forward", "speaker_mel",
           "sanitize_speaker_encoder", "Qwen3SpeakerEncoder", "init_random_params",
           "SPEAKER_ENCODER_MARKER"]

SPEAKER_ENCODER_MARKER = "speaker_encoder"
N_FFT, HOP = 1024, 256


@dataclass
class SpeakerEncoderConfig:
    """config.json's ``speaker_encoder_config``."""

    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: tuple = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: tuple = (5, 3, 3, 3, 1)
    enc_dilations: tuple = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000

    @classmethod
    def from_dict(cls, d: dict) -> "SpeakerEncoderConfig":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        for k in ("enc_channels", "enc_kernel_sizes", "enc_dilations"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


def _reflect_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad ``[B, T, C]`` along time, the pad clamped to ``T - 1``."""
    t = x.shape[1]
    if pad <= 0 or t <= 1:
        return x
    pad = min(pad, t - 1)
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def _tdnn(p: dict, x: torch.Tensor, kernel: int, dilation: int = 1) -> torch.Tensor:
    """TimeDelayNetBlock: reflect pad, conv, ReLU (no norm)."""
    x = _reflect_pad_time(x, (kernel - 1) * dilation // 2)
    return torch.relu(nn.conv1d(p["conv"], x, dilation=dilation))


def _res2net(p: dict, x: torch.Tensor, scale: int, kernel: int, dilation: int) -> torch.Tensor:
    """Res2Net splits: chunk 0 passes through, chunk 1 goes through block 0,
    chunk i >= 2 adds the previous block's output before its own block."""
    chunks = x.chunk(scale, dim=-1)
    outs, prev = [chunks[0]], None
    for i in range(1, scale):
        prev = _tdnn(p["blocks"][str(i - 1)], chunks[i] if i == 1 else chunks[i] + prev,
                     kernel, dilation)
        outs.append(prev)
    return torch.cat(outs, dim=-1)


def _se_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = x.mean(dim=1, keepdim=True)
    s = torch.relu(nn.conv1d(p["conv1"], s))
    return x * torch.sigmoid(nn.conv1d(p["conv2"], s))


def _se_res2net(p: dict, x: torch.Tensor, cfg: SpeakerEncoderConfig, kernel: int,
                dilation: int) -> torch.Tensor:
    out = _tdnn(p["tdnn1"], x, 1)
    out = _res2net(p["res2net_block"], out, cfg.enc_res2net_scale, kernel, dilation)
    out = _tdnn(p["tdnn2"], out, 1)
    return _se_block(p["se_block"], out) + x


def speaker_encoder_forward(p: dict, mel: torch.Tensor, cfg: SpeakerEncoderConfig
                            ) -> torch.Tensor:
    """mel ``[B, T, mel_dim]`` -> speaker embedding ``[B, enc_dim]``."""
    with nn.f32_convolutions():
        h = _tdnn(p["blocks"]["0"], mel, cfg.enc_kernel_sizes[0], cfg.enc_dilations[0])
        hiddens = []
        for i in range(1, len(cfg.enc_channels) - 1):
            h = _se_res2net(p["blocks"][str(i)], h, cfg, cfg.enc_kernel_sizes[i],
                            cfg.enc_dilations[i])
            hiddens.append(h)
        h = torch.cat(hiddens, dim=-1) if len(hiddens) >= 2 else h
        h = _tdnn(p["mfa"], h, cfg.enc_kernel_sizes[-1], cfg.enc_dilations[-1])

        # attentive statistics pooling with global context
        eps = 1e-12
        mean = h.mean(dim=1, keepdim=True)
        std = torch.sqrt(((h - mean) ** 2).mean(dim=1, keepdim=True) + eps)
        attn_in = torch.cat([h, mean.expand_as(h), std.expand_as(h)], dim=-1)
        a = torch.tanh(_tdnn(p["asp"]["tdnn"], attn_in, 1))
        a = torch.softmax(nn.conv1d(p["asp"]["conv"], a), dim=1)
        w_mean = (a * h).sum(dim=1, keepdim=True)
        w_std = torch.sqrt(torch.clamp((a * (h - w_mean) ** 2).sum(dim=1, keepdim=True),
                                       min=eps))
        pooled = torch.cat([w_mean, w_std], dim=-1)  # [B, 1, 2C]
        return nn.conv1d(p["fc"], pooled)[:, 0]


def speaker_mel(audio, cfg: SpeakerEncoderConfig, device=None) -> torch.Tensor:
    """The Whisper-style normalised log-mel at n_fft 1024, hop 256 and
    ``mel_dim`` mels -> ``[1, T, mel_dim]`` on ``device`` (kernel 1 there
    on the card)."""
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32).reshape(-1))
    mel = dsp.log_mel_spectrogram(audio.reshape(-1), n_mels=cfg.mel_dim,
                                  sample_rate=cfg.sample_rate, n_fft=N_FFT, hop_length=HOP,
                                  device=device)
    return mel.t()[None]


def sanitize_speaker_encoder(flat: dict) -> dict:
    """The ``...speaker_encoder.*`` keys of a talker checkpoint, their prefix
    stripped (weights stay ``[O, I, K]``)."""
    out = {}
    for key, v in flat.items():
        parts = key.split(".")
        if SPEAKER_ENCODER_MARKER not in parts:
            continue
        suffix = ".".join(parts[parts.index(SPEAKER_ENCODER_MARKER) + 1:])
        if suffix:
            out[suffix] = v
    return out


def init_random_params(cfg: SpeakerEncoderConfig, seed: int = 0, dtype=torch.float32,
                       device=None) -> dict:
    """Random params in the sanitized tree's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed + 53``: conv weights
    N(0, 1/sqrt(fan-in)), biases N(0, 0.05)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed + 53)

    def conv(o, i, k):
        return {"weight": torch.randn((o, i, k), generator=gen, device=device,
                                      dtype=dtype) / (i * k) ** 0.5,
                "bias": 0.05 * torch.randn((o,), generator=gen, device=device, dtype=dtype)}

    ch, ks, s = cfg.enc_channels, cfg.enc_kernel_sizes, cfg.enc_res2net_scale
    blocks = {"0": {"conv": conv(ch[0], cfg.mel_dim, ks[0])}}
    for i in range(1, len(ch) - 1):
        c, w = ch[i], ch[i] // s
        blocks[str(i)] = {
            "tdnn1": {"conv": conv(c, ch[i - 1], 1)},
            "res2net_block": {"blocks": {str(j): {"conv": conv(w, w, ks[i])}
                                         for j in range(s - 1)}},
            "tdnn2": {"conv": conv(c, c, 1)},
            "se_block": {"conv1": conv(cfg.enc_se_channels, c, 1),
                         "conv2": conv(c, cfg.enc_se_channels, 1)}}
    agg = sum(ch[1:-1])
    return {"blocks": blocks, "mfa": {"conv": conv(ch[-1], agg, ks[-1])},
            "asp": {"tdnn": {"conv": conv(cfg.enc_attention_channels, 3 * ch[-1], 1)},
                    "conv": conv(ch[-1], cfg.enc_attention_channels, 1)},
            "fc": conv(cfg.enc_dim, 2 * ch[-1], 1)}


class Qwen3SpeakerEncoder:
    """Waveform -> speaker embedding ``[1, enc_dim]`` (f32, on the params'
    device)."""

    def __init__(self, config: SpeakerEncoderConfig, params: dict, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.params["fc"]["weight"].device

    @torch.inference_mode()
    def __call__(self, audio) -> torch.Tensor:
        mel = speaker_mel(audio, self.config, device=self.device).to(self.dtype)
        return speaker_encoder_forward(self.params, mel, self.config)
