"""Sortformer on the PyTorch port: 4-speaker streaming diarization.

Port of tpu_audio.models.vad.sortformer, with the same semantics:

- NeMo log-mel features (pre-emphasis, constant-pad STFT with a symmetric
  Hann window zero-padded to ``n_fft``, slaney mel, natural log + 2^-24,
  per-feature normalisation with a ``T - 1`` denominator), padded to a
  multiple of 16 frames offline.
- FastConformer encoder: three stride-2 conv2d stages (depthwise groups in
  the second and third), conformer layers with half-step FFNs, Transformer-XL
  relative-position attention (``(ac + bd) * scale`` on f32 scores; the
  relative shift and the sinusoid table are Parakeet's,
  ``models.stt.parakeet``), the GLU conv module with BatchNorm. It takes no
  mask, so the zero frames of a streaming bucket enter its attention and
  depthwise convs, as in the JAX package: the bucket is part of the function.
- Transformer encoder (post-LN, learned positions, an additive ``-1e4``
  padding mask through ``core.nn.sdpa``), per-frame speaker sigmoids.
- Offline ``generate`` (silence trim, peak normalisation, one forward) and
  streaming ``feed`` / ``generate_stream``: the spkcache/FIFO state machine
  with AOSC speaker-cache compression. The state and the compression are
  host NumPy, copied from the JAX package (an ``argpartition`` top-k on
  scores of at most a few hundred frames); each step uploads the
  concatenated embeddings padded to a multiple of 32 frames and reads back
  the chunk's embeddings and the speaker probabilities.

Convolutions run in full f32 (``nn.f32_convolutions``) on the card, as the
reference does.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, loading, nn
from tpu_audio_torch.models.stt.parakeet import (_conformer_conv, _ff, _make_window,
                                                 _rel_pos_encoding, _rel_shift)

__all__ = ["Sortformer", "SortformerConfig", "FCEncoderConfig", "TFEncoderConfig",
           "ModulesConfig", "ProcessorConfig", "DiarizationSegment", "segments_to_rttm",
           "extract_mel_features", "preds_to_segments", "sanitize", "init_random_params"]

LOG_GUARD = 2.0**-24


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class FCEncoderConfig:
    hidden_size: int = 512
    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    num_mel_bins: int = 80
    conv_kernel_size: int = 9
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256
    subsampling_conv_kernel_size: int = 3
    subsampling_conv_stride: int = 2
    attention_bias: bool = True
    scale_input: bool = True


@dataclass
class TFEncoderConfig:
    d_model: int = 192
    encoder_layers: int = 18
    encoder_attention_heads: int = 8
    encoder_ffn_dim: int = 768
    layer_norm_eps: float = 1e-5
    max_source_positions: int = 1500
    k_proj_bias: bool = False


@dataclass
class ModulesConfig:
    num_speakers: int = 4
    fc_d_model: int = 512
    tf_d_model: int = 192
    subsampling_factor: int = 8
    chunk_len: int = 188
    fifo_len: int = 188
    spkcache_len: int = 188
    spkcache_update_period: int = 144
    chunk_left_context: int = 1
    chunk_right_context: int = 1
    spkcache_sil_frames_per_spk: int = 3
    pred_score_threshold: float = 0.25
    max_index: int = 99999
    scores_boost_latest: float = 0.0
    sil_threshold: float = 0.2
    strong_boost_rate: float = 0.75
    weak_boost_rate: float = 1.5
    min_pos_scores_rate: float = 0.5
    use_aosc: bool = True


@dataclass
class ProcessorConfig:
    sampling_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    feature_size: int = 80
    preemphasis: float = 0.97


@dataclass
class SortformerConfig:
    fc_encoder: FCEncoderConfig = field(default_factory=FCEncoderConfig)
    tf_encoder: TFEncoderConfig = field(default_factory=TFEncoderConfig)
    modules: ModulesConfig = field(default_factory=ModulesConfig)
    processor: ProcessorConfig = field(default_factory=ProcessorConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "SortformerConfig":
        def sub(cfg_cls, key):
            src = d.get(key) or {}
            keys = set(cfg_cls.__dataclass_fields__)
            return cfg_cls(**{k: v for k, v in src.items() if k in keys})

        return cls(
            fc_encoder=sub(FCEncoderConfig, "fc_encoder_config"),
            tf_encoder=sub(TFEncoderConfig, "tf_encoder_config"),
            modules=sub(ModulesConfig, "modules_config"),
            processor=sub(ProcessorConfig, "processor_config"),
        )


@dataclass
class DiarizationSegment:
    start: float
    end: float
    speaker: int


def segments_to_rttm(segments: list[DiarizationSegment], uri: str = "audio") -> str:
    """Diarization segments as RTTM text: one ``SPEAKER <uri> 1 <start> <dur>
    <NA> <NA> speaker_<n> <NA> <NA>`` line a segment."""
    return "\n".join(
        f"SPEAKER {uri} 1 {seg.start:.3f} {seg.end - seg.start:.3f} "
        f"<NA> <NA> speaker_{seg.speaker} <NA> <NA>"
        for seg in segments
    )


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def extract_mel_features(wav, proc: ProcessorConfig, normalize: str | None = "per_feature",
                         pad_to: int = 16, device=None) -> torch.Tensor:
    """1D audio -> f32 log-mel ``[1, T, n_mels]`` (channels-last) on
    ``device`` (default: the CPU), ``T`` padded with zero rows to a multiple
    of ``pad_to`` (none for 0)."""
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1)))
    x = x.to(device or "cpu")
    x = torch.cat([x[:1], x[1:] - float(proc.preemphasis) * x[:-1]])
    window = _make_window("hann", proc.win_length, proc.n_fft)
    spec = dsp.stft(x, window, proc.n_fft, proc.hop_length, pad_mode="constant")
    power = spec.abs() ** 2
    fb = torch.from_numpy(dsp.mel_filters(proc.sampling_rate, proc.n_fft, proc.feature_size,
                                          norm="slaney", mel_scale="slaney")).to(x.device)
    mel = torch.log(power @ fb + LOG_GUARD)  # [T, n_mels]
    if normalize == "per_feature":
        mean = mel.mean(0, keepdim=True)
        denom = max(mel.shape[0] - 1, 1)
        var = ((mel - mean) ** 2).sum(0, keepdim=True) / denom
        mel = (mel - mean) / (torch.sqrt(var) + 1e-5)
    if pad_to > 0 and mel.shape[0] % pad_to:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, pad_to - mel.shape[0] % pad_to))
    return mel[None]


# ---------------------------------------------------------------------------
# FastConformer encoder
# ---------------------------------------------------------------------------


def subsampled_length(n_frames: int, n_stages: int = 3) -> int:
    """Encoder frames of ``n_frames`` mel frames: ``floor((l - 1) / 2) + 1``
    a stage."""
    for _ in range(n_stages):
        n_frames = (n_frames - 1) // 2 + 1
    return n_frames


def pre_encode(params, mel, lengths, cfg: FCEncoderConfig):
    """mel ``[B, T, F]`` -> (embeddings ``[B, T/8, H]``, lengths)."""
    p = params["fc_encoder"]["subsampling"]
    ch = cfg.subsampling_conv_channels
    y = mel[..., None]  # [B, T, F, 1]
    y = torch.relu(nn.conv2d(p["layers_0"], y, stride=(2, 2), padding=(1, 1)))
    y = nn.conv2d(p["layers_2"], y, stride=(2, 2), padding=(1, 1), groups=ch)
    y = torch.relu(nn.conv2d(p["layers_3"], y))
    y = nn.conv2d(p["layers_5"], y, stride=(2, 2), padding=(1, 1), groups=ch)
    y = torch.relu(nn.conv2d(p["layers_6"], y))
    b, t, f, c = y.shape
    y = y.permute(0, 1, 3, 2).reshape(b, t, c * f)
    out_len = lengths.to(torch.float32)
    for _ in range(3):
        out_len = torch.floor((out_len - 1) / 2) + 1
    return nn.linear(p["linear"], y), out_len.to(torch.int32)


def _fc_attention(p, x, pos_emb, n_heads: int, mask=None):
    """Relative-position attention; ``mask`` (True where masked) sets those
    scores to -1e4 before the softmax and their weights to 0 after it."""
    b, t, d = x.shape
    hd = d // n_heads
    scale = 1.0 / math.sqrt(hd)
    q = nn.linear(p["q_proj"], x).reshape(b, t, n_heads, hd)
    k = nn.linear(p["k_proj"], x).reshape(b, -1, n_heads, hd).transpose(1, 2)
    v = nn.linear(p["v_proj"], x).reshape(b, -1, n_heads, hd).transpose(1, 2)
    pp = nn.linear(p["relative_k_proj"], pos_emb.to(x.dtype))
    ph = pp.reshape(1, -1, n_heads, hd).transpose(1, 2)
    q_u = (q + p["bias_u"].to(x.dtype)).transpose(1, 2)
    q_v = (q + p["bias_v"].to(x.dtype)).transpose(1, 2)
    ac = q_u.float() @ k.float().transpose(-1, -2)
    bd = _rel_shift(q_v.float() @ ph.float().transpose(-1, -2))[..., :t]
    scores = (ac + bd) * scale
    if mask is not None:
        scores = scores.masked_fill(mask, -1e4)
    attn = torch.softmax(scores, dim=-1)
    if mask is not None:
        attn = attn.masked_fill(mask, 0.0)
    o = (attn.to(x.dtype) @ v).transpose(1, 2).reshape(b, t, d)
    return nn.linear(p["o_proj"], o)


def _fc_layer(p, x, pos_emb, cfg: FCEncoderConfig, mask=None):
    x = x + 0.5 * _ff(p["feed_forward1"], nn.layer_norm(p["norm_feed_forward1"], x))
    x = x + _fc_attention(p["self_attn"], nn.layer_norm(p["norm_self_att"], x), pos_emb,
                          cfg.num_attention_heads, mask)
    x = x + _conformer_conv(p["conv"], nn.layer_norm(p["norm_conv"], x),
                            cfg.conv_kernel_size, norm="norm")
    x = x + 0.5 * _ff(p["feed_forward2"], nn.layer_norm(p["norm_feed_forward2"], x))
    return nn.layer_norm(p["norm_out"], x)


def fc_encode(params, embs, cfg: FCEncoderConfig):
    """Conformer layers over pre-encoded embeddings ``[B, T, H]`` (no mask)."""
    x = embs * math.sqrt(cfg.hidden_size) if cfg.scale_input else embs
    pos_emb = torch.from_numpy(_rel_pos_encoding(x.shape[1], cfg.hidden_size)).to(x.device)
    for i in range(cfg.num_hidden_layers):
        x = _fc_layer(params["fc_encoder"]["layers"][str(i)], x, pos_emb, cfg)
    return x


def tf_encode(params, x, valid_len, cfg: TFEncoderConfig):
    """Post-LN transformer with learned positions over ``[B, T, D]``; frames
    at or past ``valid_len`` (an int or a 0-d tensor) are masked by adding
    -1e4 to their scores."""
    p = params["tf_encoder"]
    b, t, d = x.shape
    x = x + p["embed_positions"]["weight"][:t].to(x.dtype)
    invalid = (torch.arange(t, device=x.device) >= valid_len)[None, None, None, :]
    mask = invalid.to(torch.float32) * -1e4
    n_heads = cfg.encoder_attention_heads
    hd = d // n_heads
    for i in range(cfg.encoder_layers):
        lp = p["layers"][str(i)]
        ap = lp["self_attn"]
        q, k, v = (nn.linear(ap[n], x).reshape(b, t, n_heads, hd).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        o = nn.sdpa(q, k, v, mask=mask).transpose(1, 2).reshape(b, t, d)
        x = nn.layer_norm(lp["self_attn_layer_norm"], x + nn.linear(ap["out_proj"], o),
                          cfg.layer_norm_eps)
        h = nn.linear(lp["fc2"], torch.relu(nn.linear(lp["fc1"], x)))
        x = nn.layer_norm(lp["final_layer_norm"], x + h, cfg.layer_norm_eps)
    return x


def _speaker_probs(params, x, valid):
    m = params["sortformer_modules"]
    h = torch.relu(nn.linear(m["first_hidden_to_hidden"], torch.relu(x)))
    preds = torch.sigmoid(nn.linear(m["single_hidden_to_spks"], h))
    return preds * valid[..., None]


def forward(params, mel, lengths, cfg: SortformerConfig):
    """mel ``[B, T, F]`` -> speaker probabilities ``[B, T/8, n_spk]`` (the
    transformer masks past row 0's length, as in the JAX package)."""
    embs, emb_len = pre_encode(params, mel, lengths, cfg.fc_encoder)
    x = fc_encode(params, embs, cfg.fc_encoder)
    x = nn.linear(params["sortformer_modules"]["encoder_proj"], x)
    x = tf_encode(params, x, emb_len[0], cfg.tf_encoder)
    frames = torch.arange(x.shape[1], device=x.device)[None]
    return _speaker_probs(params, x, frames < emb_len[:, None])


def encode_sequence(params, embs, valid_len, cfg: SortformerConfig):
    """Conformer + transformer + sigmoids over pre-encoded embeddings (the
    streaming pass), frames past ``valid_len`` zeroed."""
    x = fc_encode(params, embs, cfg.fc_encoder)
    x = nn.linear(params["sortformer_modules"]["encoder_proj"], x)
    x = tf_encode(params, x, valid_len, cfg.tf_encoder)
    frames = torch.arange(x.shape[1], device=x.device)[None]
    return _speaker_probs(params, x, frames < valid_len)


# ---------------------------------------------------------------------------
# Sanitize and random weights
# ---------------------------------------------------------------------------


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Torch or MLX-converted checkpoint -> the tree the model reads:
    ``subsampling.layers.N`` -> ``layers_N``, ``num_batches_tracked``
    dropped, MLX conv2d ``[O, H, W, I]`` -> ``[O, I, H, W]`` and conv1d
    ``[O, K, I]`` -> ``[O, I, K]`` (torch layouts are kept)."""
    out = {}
    for k, v in weights.items():
        if "num_batches_tracked" in k:
            continue
        k = k.replace("subsampling.layers.", "subsampling.layers_")
        if "subsampling" in k and k.endswith("weight") and v.ndim == 4:
            if v.shape[1] == v.shape[2] and v.shape[3] in (1, v.shape[0]):
                v = v.permute(0, 3, 1, 2).contiguous()
        if "pointwise_conv" in k and k.endswith("weight") and v.ndim == 3:
            if v.shape[1] == 1 and v.shape[2] > 1:  # MLX [O, 1, I]
                v = v.permute(0, 2, 1).contiguous()
        if "depthwise_conv" in k and k.endswith("weight") and v.ndim == 3:
            if v.shape[2] == 1 and v.shape[1] > 1:  # MLX [O, K, 1]
                v = v.permute(0, 2, 1).contiguous()
        out[k] = v
    return out


def init_random_params(cfg: SortformerConfig, seed: int = 0, dtype=torch.float32,
                       device=None) -> dict:
    """Random params in the sanitized tree's layout at any width, drawn on
    ``device`` from a ``torch.Generator``: N(0, 1/fan_in) weights, the
    output projection of each residual branch (conformer FFN ``linear2``,
    ``o_proj``, ``pointwise_conv2``; transformer ``out_proj``, ``fc2``)
    scaled by ``1/sqrt(2 L)`` of its stack (unscaled, a deep random
    conformer averages its frames into one), N(0, 0.02) biases and position
    biases, N(0, 0.1) learned positions, LayerNorm and BatchNorm weights 1 +
    N(0, 0.1) and biases N(0, 0.1), running means N(0, 0.1) and variances
    1 + |N(0, 0.2)|."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    fc, tf, n_spk = cfg.fc_encoder, cfg.tf_encoder, cfg.modules.num_speakers

    def randn(*shape, std, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen, device=device)

    def rand(*shape):
        return randn(*shape, std=int(np.prod(shape[1:])) ** -0.5)

    def lin(o, i, bias=True, gain=1.0):
        p = {"weight": randn(o, i, std=gain * i ** -0.5)}
        if bias:
            p["bias"] = randn(o, std=0.02)
        return p

    def norm(n):
        return {"weight": randn(n, std=0.1, mean=1.0), "bias": randn(n, std=0.1)}

    h, ch, heads = fc.hidden_size, fc.subsampling_conv_channels, fc.num_attention_heads
    f_out = subsampled_length(fc.num_mel_bins)
    sub = {"layers_0": {"weight": rand(ch, 1, 3, 3), "bias": randn(ch, std=0.02)},
           "layers_2": {"weight": rand(ch, 1, 3, 3), "bias": randn(ch, std=0.02)},
           "layers_3": {"weight": rand(ch, ch, 1, 1), "bias": randn(ch, std=0.02)},
           "layers_5": {"weight": rand(ch, 1, 3, 3), "bias": randn(ch, std=0.02)},
           "layers_6": {"weight": rand(ch, ch, 1, 1), "bias": randn(ch, std=0.02)},
           "linear": lin(h, ch * f_out)}
    branch = (2 * fc.num_hidden_layers) ** -0.5
    ffn = fc.intermediate_size
    fc_layers = {}
    for i in range(fc.num_hidden_layers):
        fc_layers[str(i)] = {
            **{n: norm(h) for n in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                                    "norm_feed_forward2", "norm_out")},
            "feed_forward1": {"linear1": lin(ffn, h), "linear2": lin(h, ffn, gain=branch)},
            "feed_forward2": {"linear1": lin(ffn, h), "linear2": lin(h, ffn, gain=branch)},
            "self_attn": {**{n: lin(h, h, fc.attention_bias) for n in ("q_proj", "k_proj",
                                                                         "v_proj")},
                          "o_proj": lin(h, h, fc.attention_bias, gain=branch),
                          "relative_k_proj": lin(h, h, bias=False),
                          "bias_u": randn(heads, h // heads, std=0.02),
                          "bias_v": randn(heads, h // heads, std=0.02)},
            "conv": {"pointwise_conv1": {"weight": rand(2 * h, h, 1),
                                         "bias": randn(2 * h, std=0.02)},
                     "depthwise_conv": {"weight": rand(h, 1, fc.conv_kernel_size),
                                        "bias": randn(h, std=0.02)},
                     "pointwise_conv2": {"weight": randn(h, h, 1, std=branch * h ** -0.5),
                                         "bias": randn(h, std=0.02)},
                     "norm": {**norm(h), "running_mean": randn(h, std=0.1),
                              "running_var": 1.0 + randn(h, std=0.2).abs()}},
        }
    d, tf_branch = tf.d_model, (2 * tf.encoder_layers) ** -0.5
    tf_layers = {}
    for i in range(tf.encoder_layers):
        tf_layers[str(i)] = {
            "self_attn": {"q_proj": lin(d, d), "k_proj": lin(d, d, tf.k_proj_bias),
                          "v_proj": lin(d, d), "out_proj": lin(d, d, gain=tf_branch)},
            "self_attn_layer_norm": norm(d),
            "fc1": lin(tf.encoder_ffn_dim, d), "fc2": lin(d, tf.encoder_ffn_dim, gain=tf_branch),
            "final_layer_norm": norm(d),
        }
    params = {
        "fc_encoder": {"subsampling": sub, "layers": fc_layers},
        "tf_encoder": {"embed_positions": {"weight": randn(tf.max_source_positions, d,
                                                           std=0.1)},
                       "layers": tf_layers},
        "sortformer_modules": {"encoder_proj": lin(d, h), "first_hidden_to_hidden": lin(d, d),
                               "single_hidden_to_spks": lin(n_spk, d),
                               "hidden_to_spks": lin(n_spk, 2 * d)},
    }
    return loading.cast_floats(params, dtype)


# ---------------------------------------------------------------------------
# AOSC compression (host NumPy, copied from the JAX package)
# ---------------------------------------------------------------------------


def _get_silence_profile(mean_sil, n_sil, embs, preds, sil_threshold):
    is_sil = preds.sum(axis=2) < sil_threshold  # [1, T]
    sil_count = is_sil.sum(axis=1).astype(np.float32)
    sil_sum = (embs * is_sil[..., None]).sum(axis=1)
    upd_n = n_sil + sil_count
    total = mean_sil * n_sil[:, None] + sil_sum
    return total / np.maximum(upd_n[:, None], 1), upd_n


def _log_pred_scores(preds, threshold):
    logp = np.log(np.clip(preds, threshold, None))
    log1p = np.log(np.clip(1.0 - preds, threshold, None))
    return logp - log1p + log1p.sum(axis=2, keepdims=True) - math.log(0.5)


def aosc_scores(preds, mc: ModulesConfig) -> np.ndarray:
    """The boosted per-frame, per-speaker scores ``[1, T + sil, n_spk]`` the
    compression ranks (``-inf``: not kept; ``+inf``: the silence pads)."""
    n_spk = mc.num_speakers
    sil_per_spk = mc.spkcache_sil_frames_per_spk
    per_spk = mc.spkcache_len // n_spk - sil_per_spk
    strong = int(per_spk * mc.strong_boost_rate)
    weak = int(per_spk * mc.weak_boost_rate)
    min_pos = int(per_spk * mc.min_pos_scores_rate)

    scores = _log_pred_scores(preds, mc.pred_score_threshold)
    # disable low scores
    is_speech = preds > 0.5
    scores = np.where(is_speech, scores, -np.inf)
    pos_count = (scores > 0).sum(axis=1, keepdims=True)
    replace = (~(scores > 0)) & is_speech & (pos_count >= min_pos)
    scores = np.where(replace, -np.inf, scores)
    if mc.scores_boost_latest > 0 and scores.shape[1] > mc.spkcache_len:
        scores[:, mc.spkcache_len:] += mc.scores_boost_latest

    def boost(scores, k, scale):
        if k <= 0:
            return scores
        k = min(k, scores.shape[1])
        boost_val = -scale * math.log(0.5)
        out = scores.copy()
        for spk in range(scores.shape[2]):
            flat = scores[0, :, spk]
            topk = np.argpartition(-flat, k - 1)[:k]
            finite = np.isfinite(flat[topk])
            out[0, topk[finite], spk] += boost_val
        return out

    scores = boost(scores, strong, 2.0)
    scores = boost(scores, weak, 1.0)
    if sil_per_spk > 0:
        pad = np.full((1, sil_per_spk, n_spk), np.inf, np.float32)
        scores = np.concatenate([scores, pad], axis=1)
    return scores


def aosc_picks(preds, mc: ModulesConfig) -> tuple[np.ndarray, np.ndarray]:
    """The compressed cache's ``spkcache_len`` frames, in order, and which
    of them are disabled (filled with the mean silence embedding)."""
    scores = aosc_scores(preds, mc)
    n_frames = scores.shape[1]
    n_no_sil = n_frames - mc.spkcache_sil_frames_per_spk
    flat = scores[0].T.reshape(-1)  # [n_spk * n_frames]
    k = min(mc.spkcache_len, flat.shape[0])
    top = np.argpartition(-flat, k - 1)[:k]
    vals = flat[top]
    top = np.where(np.isfinite(vals) & (vals > -np.inf), top, mc.max_index)
    top = np.where(vals > -np.inf, top, mc.max_index)
    top = np.sort(top)
    disabled = top == mc.max_index
    top = top % n_frames
    disabled = disabled | (top >= n_no_sil)
    return np.where(disabled, 0, top), disabled


def _compress_aosc(embs, preds, mean_sil, mc: ModulesConfig):
    top, disabled = aosc_picks(preds, mc)
    gathered = embs[0, top]  # [sl, D]
    gathered = np.where(disabled[:, None], mean_sil[0][None], gathered)
    gpreds = preds[0, top]
    gpreds = np.where(disabled[:, None], 0.0, gpreds)
    return gathered[None], gpreds[None]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def preds_to_segments(preds: np.ndarray, frame_duration: float,
                      threshold: float = 0.5, min_duration: float = 0.0,
                      merge_gap: float = 0.0) -> list[DiarizationSegment]:
    """``[T, n_spk]`` probabilities -> per-speaker segments in start order."""
    preds = np.asarray(preds)
    segments = []
    for spk in range(preds.shape[1]):
        active = preds[:, spk] > threshold
        spk_segs = []
        start = -1
        for f, a in enumerate(active):
            if a and start < 0:
                start = f
            elif not a and start >= 0:
                s, e = start * frame_duration, f * frame_duration
                if e - s >= min_duration:
                    spk_segs.append(DiarizationSegment(s, e, spk))
                start = -1
        if start >= 0:
            s, e = start * frame_duration, len(active) * frame_duration
            if e - s >= min_duration:
                spk_segs.append(DiarizationSegment(s, e, spk))
        if merge_gap > 0 and len(spk_segs) > 1:
            merged = [spk_segs[0]]
            for seg in spk_segs[1:]:
                if seg.start - merged[-1].end <= merge_gap:
                    merged[-1] = DiarizationSegment(merged[-1].start, seg.end, spk)
                else:
                    merged.append(seg)
            spk_segs = merged
        segments += spk_segs
    segments.sort(key=lambda s: s.start)
    return segments


class Sortformer:
    """Sortformer with offline ``generate`` and streaming ``feed`` /
    ``generate_stream``; it computes on its params' device in ``dtype``."""

    def __init__(self, config: SortformerConfig, params, dtype=torch.float32):
        self.config = config
        self.params = params
        self.dtype = dtype
        self.device = params["fc_encoder"]["subsampling"]["linear"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32,
                        device="cuda") -> "Sortformer":
        """Load a local checkpoint directory onto ``device`` in ``dtype``."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = SortformerConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype,
                                     expected_prefixes=("fc_encoder", "tf_encoder"))
        return cls(config, loading.to_device(params, device), dtype)

    @property
    def frame_duration(self) -> float:
        proc = self.config.processor
        return proc.hop_length * self.config.fc_encoder.subsampling_factor / proc.sampling_rate

    # -- offline ---------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, audio: np.ndarray, threshold: float = 0.5,
                 min_duration: float = 0.0, merge_gap: float = 0.0) -> dict:
        """Trim leading silence, peak-normalise, one forward over the whole
        recording -> segments, ``speaker_probs [T, n_spk]`` (host f32),
        ``num_speakers`` and ``total_time``."""
        t0 = time.perf_counter()
        proc = self.config.processor
        wav = np.asarray(audio, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        energy = np.abs(wav)
        nz = np.where(energy > 0.01 * max(energy.max(), 1e-9))[0]
        trim_offset = int(nz[0]) if len(nz) else 0
        wav = wav[trim_offset:]
        wav = wav / (np.abs(wav).max() + 1e-3)
        feats = extract_mel_features(wav, proc, device=self.device)
        lengths = torch.tensor([feats.shape[1]], dtype=torch.int32, device=self.device)
        with nn.f32_convolutions():
            preds = forward(self.params, feats.to(self.dtype), lengths, self.config)
        preds = preds[0].float().cpu().numpy()
        offset = trim_offset / proc.sampling_rate
        segments = [
            DiarizationSegment(s.start + offset, s.end + offset, s.speaker)
            for s in preds_to_segments(preds, self.frame_duration, threshold,
                                       min_duration, merge_gap)
        ]
        return {
            "segments": segments,
            "speaker_probs": preds,
            "num_speakers": len({s.speaker for s in segments}),
            "total_time": time.perf_counter() - t0,
        }

    # -- streaming -------------------------------------------------------------

    def init_streaming_state(self) -> dict:
        d = self.config.fc_encoder.hidden_size
        n_spk = self.config.modules.num_speakers
        return {
            "spkcache": np.zeros((1, 0, d), np.float32),
            "spkcache_preds": np.zeros((1, 0, n_spk), np.float32),
            "fifo": np.zeros((1, 0, d), np.float32),
            "fifo_preds": np.zeros((1, 0, n_spk), np.float32),
            "frames_processed": 0,
            "mean_sil_emb": np.zeros((1, d), np.float32),
            "n_sil_frames": np.zeros((1,), np.float32),
        }

    @torch.inference_mode()
    def streaming_step(self, chunk_features, state: dict,
                       right_context_embs: np.ndarray | None = None):
        """One chunk of mel features ``[1, T, F]`` -> (the chunk's speaker
        probabilities ``[T/8, n_spk]``, new state). The step runs over
        spkcache + FIFO + left context + chunk, zero-padded to a multiple of
        32 frames (at least 32)."""
        mc = self.config.modules
        lc = mc.chunk_left_context if mc.use_aosc else 0
        feats = torch.as_tensor(chunk_features, device=self.device)
        lengths = torch.tensor([feats.shape[1]], dtype=torch.int32, device=self.device)
        chunk_len = subsampled_length(feats.shape[1])
        with nn.f32_convolutions():
            embs, _ = pre_encode(self.params, feats.to(self.dtype), lengths,
                                 self.config.fc_encoder)
        chunk_embs = embs[:, :chunk_len].float().cpu().numpy()

        left = None
        left_len = 0
        fifo_len = state["fifo"].shape[1]
        if lc > 0 and fifo_len > 0:
            left_len = min(lc, fifo_len)
            left = state["fifo"][:, fifo_len - left_len:]

        parts = [p for p in (state["spkcache"], state["fifo"], left,
                             chunk_embs, right_context_embs)
                 if p is not None and p.shape[1] > 0]
        all_embs = np.concatenate(parts, axis=1)
        total = all_embs.shape[1]
        bucket = max(32, ((total + 31) // 32) * 32)
        padded = np.zeros((1, bucket, all_embs.shape[2]), np.float32)
        padded[:, :total] = all_embs
        x = torch.from_numpy(padded).to(self.device, self.dtype)
        with nn.f32_convolutions():
            all_preds = encode_sequence(self.params, x, total, self.config)
        all_preds = all_preds.float().cpu().numpy()

        sp_len = state["spkcache"].shape[1]
        start = sp_len + fifo_len + left_len
        chunk_preds = all_preds[:, start : start + chunk_len]
        new_state = dict(state)
        if sp_len > 0:
            new_state["spkcache_preds"] = all_preds[:, :sp_len]
        if fifo_len > 0:
            new_state["fifo_preds"] = all_preds[:, sp_len : sp_len + fifo_len]
        new_state["fifo"] = np.concatenate([new_state["fifo"], chunk_embs], axis=1)
        new_state["fifo_preds"] = np.concatenate([new_state["fifo_preds"], chunk_preds], axis=1)
        new_state["frames_processed"] = state["frames_processed"] + chunk_preds.shape[1]
        return chunk_preds[0], new_state

    def maybe_compress_state(self, state: dict, spkcache_max: int = 188,
                             fifo_max: int = 188) -> dict:
        """Move the FIFO's oldest frames (at most ``spkcache_update_period``
        with AOSC) past ``fifo_max`` into the speaker cache, and compress a
        cache past ``spkcache_max`` to ``spkcache_len`` frames."""
        mc = self.config.modules
        fifo_len = state["fifo"].shape[1]
        if fifo_len <= fifo_max:
            return state
        pop = fifo_len - fifo_max
        if mc.use_aosc:
            pop = min(pop, mc.spkcache_update_period)
        popped = state["fifo"][:, :pop]
        popped_preds = state["fifo_preds"][:, :pop]
        mean_sil, n_sil = state["mean_sil_emb"], state["n_sil_frames"]
        if mc.use_aosc:
            mean_sil, n_sil = _get_silence_profile(
                mean_sil, n_sil, popped, popped_preds, mc.sil_threshold)
        cache = np.concatenate([state["spkcache"], popped], axis=1)
        cache_preds = np.concatenate([state["spkcache_preds"], popped_preds], axis=1)
        if cache.shape[1] > spkcache_max:
            if mc.use_aosc:
                cache, cache_preds = _compress_aosc(cache, cache_preds, mean_sil, mc)
            else:
                scores = np.log(np.clip(cache_preds[0], 1e-7, 1.0)).sum(-1)
                top = np.sort(np.argsort(-scores)[:spkcache_max])
                cache, cache_preds = cache[:, top], cache_preds[:, top]
        out = dict(state)
        out.update(spkcache=cache, spkcache_preds=cache_preds,
                   fifo=state["fifo"][:, pop:],
                   fifo_preds=state["fifo_preds"][:, pop:],
                   mean_sil_emb=mean_sil, n_sil_frames=n_sil)
        return out

    def feed(self, chunk: np.ndarray, state: dict, threshold: float = 0.5,
             spkcache_max: int = 188, fifo_max: int = 188):
        """Feed one audio chunk -> (output dict, new state)."""
        proc = self.config.processor
        wav = np.asarray(chunk, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        offset = state["frames_processed"] * self.frame_duration
        use_v2 = self.config.modules.use_aosc
        if not use_v2:
            wav = wav / (np.abs(wav).max() + 1e-3)
        feats = extract_mel_features(wav, proc, normalize=None if use_v2 else "per_feature",
                                     pad_to=0, device=self.device)
        preds, state = self.streaming_step(feats, state)
        segments = [
            DiarizationSegment(s.start + offset, s.end + offset, s.speaker)
            for s in preds_to_segments(preds, self.frame_duration, threshold)
        ]
        state = self.maybe_compress_state(state, spkcache_max, fifo_max)
        return {
            "segments": segments,
            "speaker_probs": preds,
            "num_speakers": len({s.speaker for s in segments}),
        }, state

    def generate_stream(self, audio: np.ndarray, chunk_duration: float = 5.0,
                        threshold: float = 0.5, spkcache_max: int = 188,
                        fifo_max: int = 188):
        """Chunked streaming over a whole recording, yielding each chunk's
        output."""
        proc = self.config.processor
        wav = np.asarray(audio, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=-1)
        state = self.init_streaming_state()
        sf = self.config.fc_encoder.subsampling_factor
        chunk_samples = max(
            int(round(chunk_duration * proc.sampling_rate / proc.hop_length / sf))
            * sf * proc.hop_length, sf * proc.hop_length)
        for start in range(0, len(wav), chunk_samples):
            piece = wav[start : start + chunk_samples]
            if len(piece) < proc.win_length:
                break
            out, state = self.feed(piece, state, threshold, spkcache_max, fifo_max)
            yield out
