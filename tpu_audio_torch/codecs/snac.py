"""SNAC: multi-scale neural audio codec (port of tpu_audio.codecs.snac).

A SEANet-style conv encoder (snake activations, weight-normed convs,
optional depthwise convs and windowed local attention) -> residual VQ with
per-quantizer time strides -> a mirror decoder with transposed convs and
optional noise blocks. Orpheus decodes its 24 kHz speech with it.
Activations are channels-last ``[B, T, C]``; weight normalization is
folded into dense weights at load time.

The noise blocks draw ``N(0, 1)`` from a ``torch.Generator`` seeded by
``decode(seed=...)``; the JAX package draws from threefry, so the two
agree only with the noise weights at zero.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.codecs import AudioCodecModel
from tpu_audio_torch.core import hub, loading, nn

__all__ = ["SNAC", "SNACConfig", "sanitize", "encoder_forward", "decoder_forward",
           "vq_encode", "vq_from_codes"]


@dataclass
class SNACConfig:
    sampling_rate: int = 24000
    encoder_dim: int = 64
    encoder_rates: tuple = (2, 4, 8, 8)
    latent_dim: int | None = None
    decoder_dim: int = 1024
    decoder_rates: tuple = (8, 8, 4, 2)
    attn_window_size: int | None = None
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: tuple = (4, 2, 1)
    noise: bool = True
    depthwise: bool = True

    @property
    def computed_latent_dim(self) -> int:
        return self.latent_dim or self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))

    @classmethod
    def from_dict(cls, d: dict) -> "SNACConfig":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        for k in ("encoder_rates", "decoder_rates", "vq_strides"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


def _fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``w = g * v / ||v||`` with the norm over every dim but the first."""
    v64 = v.to(torch.float64)
    norm = torch.sqrt((v64 ** 2).sum(dim=tuple(range(1, v.ndim)), keepdim=True))
    return (g.to(torch.float64) * v64 / (norm + 1e-12)).to(torch.float32)


def sanitize(weights: dict) -> dict:
    """Normalize checkpoint keys and fold weight norm, for torch-saved
    checkpoints (conv ``[O, I, K]``, convT ``[I, O, K]``) and MLX-converted
    ones (``.layers.N.`` wrappers, conv ``[O, K, I]``, convT ``[I, K, O]``)."""
    flat = {}
    for k, v in weights.items():
        k = k.replace(".layers.", ".")
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        flat[k] = v
    probe = next((v for k, v in flat.items()
                  if k.endswith("encoder.block.0.weight_v") and v.ndim == 3), None)
    is_mlx = probe is not None and probe.shape[2] == 1 and probe.shape[1] != 1
    out = {}
    for k, v in flat.items():
        if k.endswith(".weight_v"):
            g = flat.get(k[: -len(".weight_v")] + ".weight_g")
            if g is None:
                continue
            w = _fold_weight_norm(g, v)
            if is_mlx and w.ndim == 3:
                w = w.permute(0, 2, 1).contiguous()
            out[k[: -len(".weight_v")] + ".weight"] = w
        elif k.endswith(".weight_g"):
            continue
        elif k.endswith(".alpha"):
            out[k] = v.reshape(-1)  # [1, C, 1] -> [C]
        else:
            out[k] = v
    return out


def _residual_unit(p, x, dilation: int, groups: int, kernel: int = 7):
    """snake -> dilated conv -> snake -> 1x1 conv, residual add with a
    centre crop."""
    y = nn.snake(x, p["block"]["0"]["alpha"])
    pad = ((kernel - 1) * dilation) // 2
    y = nn.conv1d(p["block"]["1"], y, padding=pad, dilation=dilation, groups=groups)
    y = nn.snake(y, p["block"]["2"]["alpha"])
    y = nn.conv1d(p["block"]["3"], y)
    crop = (x.shape[1] - y.shape[1]) // 2
    if crop > 0:
        x = x[:, crop:-crop]
    return x + y


def _local_mha(p, x, window_size: int, dim_head: int = 64):
    """Windowed multi-head attention with rotary embeddings within each
    window; ``x [B, T, C]``, T a multiple of ``window_size``."""
    b, t, c = x.shape
    heads = c // dim_head
    residual = x
    qkv = nn.linear(p["to_qkv"], nn.layer_norm(p["norm"], x))
    q, k, v = qkv.chunk(3, dim=-1)
    w = t // window_size

    def arrange(z):
        return z.reshape(b, w, window_size, heads, dim_head).permute(0, 3, 1, 2, 4)

    q, k, v = arrange(q), arrange(k), arrange(v)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2) / dim_head))
    freqs = np.concatenate([np.arange(window_size)[:, None] * inv_freq[None, :]] * 2,
                           axis=-1)
    cos = torch.from_numpy(np.cos(freqs)).to(x.dtype).to(x.device)
    sin = torch.from_numpy(np.sin(freqs)).to(x.dtype).to(x.device)

    def rotate_half(z):
        z1, z2 = z[..., : dim_head // 2], z[..., dim_head // 2:]
        return torch.cat([-z2, z1], dim=-1)

    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dim_head))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = (probs @ v).permute(0, 2, 3, 1, 4).reshape(b, t, c)
    return nn.linear(p["to_out"], o) + residual


def _noise_block(p, x, generator):
    """``x + N(0, 1) * conv1x1(x)``, one noise value per frame."""
    b, t, _ = x.shape
    noise = torch.randn((b, t, 1), generator=generator, device=x.device,
                        dtype=x.dtype)
    return x + noise * nn.conv1d(p["linear"], x)


def encoder_forward(params, x, cfg: SNACConfig):
    """``x [B, T, 1]`` -> ``z [B, T / hop, latent]``."""
    p = params["encoder"]["block"]
    x = nn.conv1d(p["0"], x, padding=3)
    idx = 1
    d = cfg.encoder_dim
    for stride in cfg.encoder_rates:
        d *= 2
        groups = d // 2 if cfg.depthwise else 1
        bp = p[str(idx)]["block"]
        for j, dil in enumerate((1, 3, 9)):
            x = _residual_unit({"block": bp[str(j)]["block"]}, x, dil, groups)
        x = nn.snake(x, bp["3"]["alpha"])
        x = nn.conv1d(bp["4"], x, stride=stride, padding=math.ceil(stride / 2))
        idx += 1
    if cfg.attn_window_size:
        x = _local_mha(p[str(idx)], x, cfg.attn_window_size)
        idx += 1
    return nn.conv1d(p[str(idx)], x, padding=3, groups=d if cfg.depthwise else 1)


def decoder_forward(params, z, cfg: SNACConfig, generator: torch.Generator | None = None):
    """``z [B, T, latent]`` -> waveform ``[B, T * hop, 1]``; the noise
    blocks draw from ``generator`` (seed 0 when None)."""
    p = params["decoder"]["model"]
    if generator is None:
        generator = torch.Generator(device=z.device).manual_seed(0)
    idx = 0
    if cfg.depthwise:
        z = nn.conv1d(p["0"], z, padding=3, groups=cfg.computed_latent_dim)
        z = nn.conv1d(p["1"], z)
        idx = 2
    else:
        z = nn.conv1d(p["0"], z, padding=3)
        idx = 1
    if cfg.attn_window_size:
        z = _local_mha(p[str(idx)], z, cfg.attn_window_size)
        idx += 1
    x = z
    for i, stride in enumerate(cfg.decoder_rates):
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        groups = out_dim if cfg.depthwise else 1
        bp = p[str(idx)]["block"]
        x = nn.snake(x, bp["0"]["alpha"])
        x = nn.conv_transpose1d(bp["1"], x, stride=stride, padding=math.ceil(stride / 2),
                                output_padding=stride % 2)
        j = 2
        if cfg.noise:
            x = _noise_block(bp["2"], x, generator)
            j = 3
        for dil in (1, 3, 9):
            x = _residual_unit({"block": bp[str(j)]["block"]}, x, dil, groups)
            j += 1
        idx += 1
    x = nn.snake(x, p[str(idx)]["alpha"])
    x = nn.conv1d(p[str(idx + 1)], x, padding=3)
    return torch.tanh(x)


def _l2norm(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the JAX package's gather rule for any index: a
    negative index counts from the end once, then every index is clamped
    to ``[0, rows)``. (Random LM weights emit such codes; an out-of-range
    index must never reach a CUDA gather, where it is a device-side
    assert.)"""
    n = table.shape[0]
    idx = idx.to(torch.long)
    return table[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def vq_encode(params, z, cfg: SNACConfig) -> list[torch.Tensor]:
    """``z [B, T, latent]`` -> codes ``[B, T / stride]`` per quantizer
    (residual, average-pooled by each stride)."""
    residual = z
    codes = []
    for i, stride in enumerate(cfg.vq_strides):
        qp = params["quantizer"]["quantizers"][str(i)]
        r = residual
        if stride > 1:
            b, t, c = r.shape
            r = r.reshape(b, t // stride, stride, c).mean(dim=2)
        enc = _l2norm(nn.conv1d(qp["in_proj"], r))
        cb = _l2norm(qp["codebook"]["weight"].to(enc.dtype))
        dist = ((enc ** 2).sum(-1, keepdim=True) - 2 * enc @ cb.t()
                + (cb ** 2).sum(-1)[None, None])
        idx = torch.argmin(dist, dim=-1)
        codes.append(idx)
        z_q = nn.conv1d(qp["out_proj"], qp["codebook"]["weight"][idx].to(enc.dtype))
        if stride > 1:
            z_q = z_q.repeat_interleave(stride, dim=1)
        residual = residual - z_q
    return codes


def vq_from_codes(params, codes, cfg: SNACConfig) -> torch.Tensor:
    """Codes per quantizer -> ``z_q [B, T, latent]``."""
    z_q = None
    for i, stride in enumerate(cfg.vq_strides):
        qp = params["quantizer"]["quantizers"][str(i)]
        emb = _rows(qp["codebook"]["weight"], codes[i])
        z = nn.conv1d(qp["out_proj"], emb.to(qp["out_proj"]["weight"].dtype))
        if stride > 1:
            z = z.repeat_interleave(stride, dim=1)
        z_q = z if z_q is None else z_q + z
    return z_q


class SNAC(AudioCodecModel):
    def __init__(self, config: SNACConfig, params: dict, dtype=torch.float32,
                 device=None):
        self.config = config
        self.params = loading.to_device(params, device) if device is not None else params
        self.sample_rate = config.sampling_rate
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.params["quantizer"]["quantizers"]["0"]["codebook"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "SNAC":
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = SNACConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        return cls(config, params, dtype, device)

    def _pad_to(self) -> int:
        lcm = functools.reduce(math.lcm, self.config.vq_strides)
        if self.config.attn_window_size:
            lcm = math.lcm(lcm, self.config.attn_window_size)
        return self.config.hop_length * lcm

    def preprocess(self, audio) -> np.ndarray:
        """``[T]`` or ``[B, T]`` -> ``[B, T']`` right-padded with zeros to a
        whole number of the coarsest code frames."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        length = audio.shape[-1]
        pad_to = self._pad_to()
        return np.pad(audio, ((0, 0), (0, math.ceil(length / pad_to) * pad_to - length)))

    @torch.inference_mode()
    def encode(self, audio) -> list[torch.Tensor]:
        """Waveform -> codes, one ``[B, T / hop / stride]`` int64 tensor per
        quantizer (on the codec's device)."""
        x = torch.from_numpy(self.preprocess(audio)[..., None]).to(self.device, self.dtype)
        return vq_encode(self.params, encoder_forward(self.params, x, self.config),
                         self.config)

    @torch.inference_mode()
    def decode(self, codes, seed: int = 0) -> torch.Tensor:
        """Codes (arrays or tensors ``[B, T_i]``) -> waveform ``[B, T]``."""
        dev = self.device
        codes = [torch.as_tensor(np.asarray(c) if not isinstance(c, torch.Tensor) else c,
                                 device=dev) for c in codes]
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        z = vq_from_codes(self.params, codes, self.config)
        return decoder_forward(self.params, z, self.config, gen)[..., 0]

    def reconstruct(self, audio) -> np.ndarray:
        length = np.asarray(audio).shape[-1]
        wav = self.decode(self.encode(audio))
        return wav.float().cpu().numpy()[..., :length]
