"""Whisper STT on PyTorch: conv stem + encoder-decoder transformer with a
KV-cached decode loop (port of tpu_audio.models.stt.whisper).

The JAX package runs a decode as one ``lax.while_loop``; here it is a
Python loop over tokens on the device, over one row per 30 s window, with
one host read per token (whether every row has emitted EOT). Greedy argmax
and the suppress/begin masks are the JAX package's. Audio longer than one
window decodes its windows in groups of up to ``_WINDOW_BATCH_MAX``, a
group in one encoder call and one decode loop (``batch_windows``, the
default), or one window at a time. Three decode routes, chosen as the JAX
package chooses them for every published whisper size:

- dense: ``decoder_step`` with a dense self cache and dense cross K/V;
- kv8d (``kv_bits=8``, ``quantized_kv_start >= max_total``): dense self
  cache, int8 cross K/V read by ``ops.kv_attention.decode_attention_int8``,
  one call a layer over the heads of every window;
- w8 kv8d (kv8d with int8 decoder weights from ``quant.quantize_tree``):
  the whole layer stack per token in ``ops.fused_decoder.fused_stack`` for
  one window, or in ``ops.fused_decoder.fused_stack_lanes`` with one lane
  a window for a group of them.

An int8 encoder (``w8e``: ``quant.quantize_tree`` of ``model.encoder``,
which keeps the convs and the position table dense) runs its products
through ``quant.int8_matmul`` on every route.

An MLX 4/8-bit checkpoint (``quantization`` in its config) decodes on the
first two routes: each linear of a decode step runs the grouped-affine
GEMV kernel (``ops.qmm``), and the encoder's 1,500-row products
dequantize and multiply.

Every other ``kv_bits`` combination takes the self cache of
``kv_cache.make_cache_for`` (int8 for ``quantized_kv_start <= 0``, int4 at
``kv_bits=4``, hybrid for a start inside the decode length), written and
read through ``kv_cache.make_layer_updater`` as in the JAX package: a
layer's new row is quantized, then its whole capacity is dequantized and
attended. Beside such a cache, 8-bit cross K/V stay on the int8 attention
kernel; 4-bit cross K/V (``"quant"``) are dequantized and attended.
"""

from __future__ import annotations

import json
import math
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch import nn as tnn

from tpu_audio_torch.core import dsp, hub, kv_cache, loading, nn, quant
from tpu_audio_torch.core.generation import (
    STTGenerateParameters,
    STTOutput,
    STTSegment,
)
from tpu_audio_torch.ops import fused_decoder as F
from tpu_audio_torch.ops import kv_attention as K

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_SECONDS = 30
CHUNK_LENGTH_SAMPLES = CHUNK_LENGTH_SECONDS * SAMPLE_RATE
FRAMES_PER_CHUNK = 3000
# long audio: the most 30 s windows one encoder call and one decode loop take
_WINDOW_BATCH_MAX = 8


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class WhisperConfig:
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    decoder_layers: int = 4
    decoder_attention_heads: int = 6
    decoder_ffn_dim: int = 1536
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    quantization: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "WhisperConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass
class WhisperGenerationConfig:
    suppress_tokens: list[int] = field(default_factory=list)
    begin_suppress_tokens: list[int] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "WhisperGenerationConfig":
        return cls(
            suppress_tokens=d.get("suppress_tokens") or [],
            begin_suppress_tokens=d.get("begin_suppress_tokens") or [],
        )


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

WHISPER_LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]


class WhisperTokenizer:
    """Special-token ids and prompt construction over any object with
    ``token_to_id`` and ``decode(ids, skip_special_tokens=...)`` (such as a
    ``tokenizers.Tokenizer``)."""

    def __init__(self, tok, vocab_size: int):
        self._tok = tok
        self.is_multilingual = vocab_size >= 51865
        self.sot = tok.token_to_id("<|startoftranscript|>")
        self.eot = tok.token_to_id("<|endoftext|>")
        self.transcribe = tok.token_to_id("<|transcribe|>")
        self.translate = tok.token_to_id("<|translate|>")
        self.no_timestamps = tok.token_to_id("<|notimestamps|>")
        self.no_speech = tok.token_to_id("<|nospeech|>")
        if self.no_speech is None:
            self.no_speech = tok.token_to_id("<|nocaptions|>")
        self.timestamp_begin = tok.token_to_id("<|0.00|>")
        if self.timestamp_begin is None and self.no_timestamps is not None:
            self.timestamp_begin = self.no_timestamps + 1
        self.language_to_id = {}
        if self.is_multilingual:
            for code in WHISPER_LANGUAGES:
                tid = tok.token_to_id(f"<|{code}|>")
                if tid is not None:
                    self.language_to_id[code] = tid
        self.id_to_language = {v: k for k, v in self.language_to_id.items()}

    @classmethod
    def from_dir(cls, model_dir: str | Path, vocab_size: int) -> "WhisperTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(str(Path(model_dir) / "tokenizer.json")),
                   vocab_size)

    def build_prompt_tokens(self, language: str | None,
                            task: str = "transcribe") -> list[int]:
        if not self.is_multilingual:
            return [self.sot, self.no_timestamps]
        lang_id = self.language_to_id.get(language or "en")
        if lang_id is None:
            lang_id = self.language_to_id.get("en")
        task_id = self.translate if task == "translate" else self.transcribe
        return [self.sot, lang_id, task_id, self.no_timestamps]

    def decode(self, tokens: list[int]) -> str:
        tokens = [t for t in tokens if t < self.sot]
        return self._tok.decode(tokens, skip_special_tokens=True)


# ---------------------------------------------------------------------------
# Model graph: functions over the param tree (HF key names, stacked layers)
# ---------------------------------------------------------------------------


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``[L, ...]`` layer tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if isinstance(stacked, quant.Int8Tensor):
        return quant.Int8Tensor(stacked.weight[i], stacked.scale[i])
    if isinstance(stacked, quant.QuantizedTensor):
        return stacked.map(lambda t: t[i])
    return stacked[i]


def _split_layers(stacked: dict) -> list[dict]:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    n = (leaf.weight if isinstance(leaf, (quant.Int8Tensor, quant.QuantizedTensor))
         else leaf).shape[0]
    return [layer_params(stacked, i) for i in range(n)]


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = o.shape
    return o.transpose(1, 2).reshape(b, t, h * hd)


def _attention(p, x, kv_x=None, mask=None, n_heads=8):
    """MHA; ``kv_x`` given -> cross attention. q/v/out have bias, k not."""
    src = x if kv_x is None else kv_x
    q = _heads(nn.linear(p["q_proj"], x), n_heads)
    k = _heads(nn.linear(p["k_proj"], src), n_heads)
    v = _heads(nn.linear(p["v_proj"], src), n_heads)
    return nn.linear(p["out_proj"], _merge(nn.sdpa(q, k, v, mask=mask)))


def _encode(p: dict, mel: torch.Tensor, cfg: WhisperConfig,
            layers: list[dict] | None = None) -> torch.Tensor:
    x = nn.gelu(nn.conv1d(p["conv1"], mel, stride=1, padding=1))
    x = nn.gelu(nn.conv1d(p["conv2"], x, stride=2, padding=1))
    x = x + p["embed_positions"]["weight"][: x.shape[1]].to(x.dtype)
    for lp in layers or _split_layers(p["layers"]):
        h = nn.layer_norm(lp["self_attn_layer_norm"], x)
        x = x + _attention(lp["self_attn"], h, n_heads=cfg.encoder_attention_heads)
        h = nn.layer_norm(lp["final_layer_norm"], x)
        x = x + nn.linear(lp["fc2"], nn.gelu(nn.linear(lp["fc1"], h)))
    return nn.layer_norm(p["layer_norm"], x)


def encoder_forward(params: dict, mel: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """mel ``[B, T=3000, n_mels]`` -> hidden ``[B, 1500, D]``."""
    return _encode(params["model"]["encoder"], mel, cfg)


def _cross_kv(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig,
              layers: list[dict] | None = None):
    """Per-layer cross-attention K/V, each ``[L, B, H, S_src, Dh]``."""
    if layers is None:
        layers = _split_layers(params["model"]["decoder"]["layers"])
    n_heads = cfg.decoder_attention_heads
    ks, vs = [], []
    for lp in layers:
        ap = lp["encoder_attn"]
        ks.append(_heads(nn.linear(ap["k_proj"], enc_out), n_heads))
        vs.append(_heads(nn.linear(ap["v_proj"], enc_out), n_heads))
    return torch.stack(ks), torch.stack(vs)


def decoder_step(params: dict, tokens: torch.Tensor, pos: int, cache, cross: tuple,
                 cfg: WhisperConfig, cross_mode: str = "dense",
                 layers: list[dict] | None = None):
    """One decode step: tokens ``[B, T]`` at positions ``pos..pos+T``.
    Returns ``(logits [B, T, V], cache)``; the cache (dense, quantized or
    hybrid, ``kv_cache.make_layer_updater``) is updated in place and
    returned with its offset advanced.

    ``cross_mode``: ``"dense"`` (``cross = (k, v)``, each
    ``[L, B, H, S, Dh]``), ``"int8"`` (``cross`` = the six 8-bit
    ``_quantize`` planes ``(kc, ks, kb, vc, vs, vb)``, each
    ``[L, B*H, S, .]`` with row b's heads at ``b*H .. b*H + H``, read by
    one int8 attention call a layer over all B*H heads; requires T = 1) or
    ``"quant"`` (the six ``_quantize`` planes at any width, each
    ``[L, B, H, S, .]``, dequantized and attended)."""
    p = params["model"]["decoder"]
    if layers is None:
        layers = _split_layers(p["layers"])
    n_heads = cfg.decoder_attention_heads
    b, t = tokens.shape
    if cross_mode == "int8" and t != 1:
        raise ValueError("int8 cross attention decodes one token a row")
    x = nn.embedding(p["embed_tokens"], tokens)
    x = x + p["embed_positions"]["weight"][pos : pos + t].to(x.dtype)
    d = x.shape[-1]
    hd = d // n_heads
    mask = kv_cache.attention_mask(cache, t)
    off = cache.offset
    cache_xs, cache_update, _ = kv_cache.make_layer_updater(cache)
    for li, lp in enumerate(layers):
        h = nn.layer_norm(lp["self_attn_layer_norm"], x)
        ap = lp["self_attn"]
        q = _heads(nn.linear(ap["q_proj"], h), n_heads)
        _, k_full, v_full = cache_update(
            cache_xs[li], off, _heads(nn.linear(ap["k_proj"], h), n_heads),
            _heads(nn.linear(ap["v_proj"], h), n_heads), x.dtype)
        o = nn.sdpa(q, k_full, v_full, mask=mask)
        x = x + nn.linear(ap["out_proj"], _merge(o))

        h = nn.layer_norm(lp["encoder_attn_layer_norm"], x)
        cp = lp["encoder_attn"]
        q = _heads(nn.linear(cp["q_proj"], h), n_heads)
        if cross_mode == "int8":
            o = K.decode_attention_int8(
                q.reshape(b * n_heads, 1, hd), *(c[li] for c in cross), cross[0].shape[2],
                sm_scale=1.0 / math.sqrt(hd)).reshape(b, n_heads, 1, hd).to(x.dtype)
        elif cross_mode == "quant":
            o = nn.sdpa(q, kv_cache._dequantize(*(c[li] for c in cross[:3]), x.dtype),
                        kv_cache._dequantize(*(c[li] for c in cross[3:]), x.dtype))
        else:
            o = nn.sdpa(q, cross[0][li], cross[1][li])
        x = x + nn.linear(cp["out_proj"], _merge(o))

        h = nn.layer_norm(lp["final_layer_norm"], x)
        x = x + nn.linear(lp["fc2"], nn.gelu(nn.linear(lp["fc1"], h)))
    x = nn.layer_norm(p["layer_norm"], x)
    logits = nn.embedding_as_linear(p["embed_tokens"], x)
    return logits, cache._replace(offset=off + t)


def decoder_forward(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                    cfg: WhisperConfig) -> torch.Tensor:
    """Full-sequence causal decoder (no cache): tokens ``[B, T]`` ->
    logits ``[B, T, V]``."""
    p = params["model"]["decoder"]
    n_heads = cfg.decoder_attention_heads
    t = tokens.shape[1]
    x = nn.embedding(p["embed_tokens"], tokens)
    x = x + p["embed_positions"]["weight"][:t].to(x.dtype)
    for lp in _split_layers(p["layers"]):
        h = nn.layer_norm(lp["self_attn_layer_norm"], x)
        ap = lp["self_attn"]
        q, k, v = (_heads(nn.linear(ap[n], h), n_heads)
                   for n in ("q_proj", "k_proj", "v_proj"))
        x = x + nn.linear(ap["out_proj"], _merge(nn.sdpa(q, k, v, is_causal=True)))
        h = nn.layer_norm(lp["encoder_attn_layer_norm"], x)
        x = x + _attention(lp["encoder_attn"], h, kv_x=enc_out, n_heads=n_heads)
        h = nn.layer_norm(lp["final_layer_norm"], x)
        x = x + nn.linear(lp["fc2"], nn.gelu(nn.linear(lp["fc1"], h)))
    x = nn.layer_norm(p["layer_norm"], x)
    return nn.embedding_as_linear(p["embed_tokens"], x)


def init_params(cfg: WhisperConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random parameter tree in the canonical (HF, stacked) layout, drawn
    from ``numpy.random.default_rng(seed)`` in the JAX package's order, so
    both packages build the same weights from the same seed. Each leaf is
    cast and moved to ``device`` as it is drawn."""
    rng = np.random.default_rng(seed)
    d, ffn, v = cfg.d_model, cfg.decoder_ffn_dim, cfg.vocab_size
    el, dl, effn = cfg.encoder_layers, cfg.decoder_layers, cfg.encoder_ffn_dim

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def rand(*shape):
        return put(rng.standard_normal(shape, dtype=np.float32) * 0.02)

    def ones(*shape):
        return put(np.ones(shape, np.float32))

    def zeros(*shape):
        return put(np.zeros(shape, np.float32))

    def attn(n):
        return {
            "q_proj": {"weight": rand(n, d, d), "bias": zeros(n, d)},
            "k_proj": {"weight": rand(n, d, d)},
            "v_proj": {"weight": rand(n, d, d), "bias": zeros(n, d)},
            "out_proj": {"weight": rand(n, d, d), "bias": zeros(n, d)},
        }

    def ln(n):
        return {"weight": ones(n, d), "bias": zeros(n, d)}

    enc_layers = {
        "self_attn": attn(el),
        "self_attn_layer_norm": ln(el),
        "fc1": {"weight": rand(el, effn, d), "bias": zeros(el, effn)},
        "fc2": {"weight": rand(el, d, effn), "bias": zeros(el, d)},
        "final_layer_norm": ln(el),
    }
    dec_layers = {
        "self_attn": attn(dl),
        "self_attn_layer_norm": ln(dl),
        "encoder_attn": attn(dl),
        "encoder_attn_layer_norm": ln(dl),
        "fc1": {"weight": rand(dl, ffn, d), "bias": zeros(dl, ffn)},
        "fc2": {"weight": rand(dl, d, ffn), "bias": zeros(dl, d)},
        "final_layer_norm": ln(dl),
    }
    return {
        "model": {
            "encoder": {
                "conv1": {"weight": rand(d, cfg.num_mel_bins, 3), "bias": zeros(d)},
                "conv2": {"weight": rand(d, d, 3), "bias": zeros(d)},
                "embed_positions": {"weight": put(whisper_sinusoids(
                    cfg.max_source_positions, d))},
                "layers": enc_layers,
                "layer_norm": {"weight": ones(d), "bias": zeros(d)},
            },
            "decoder": {
                "embed_tokens": {"weight": rand(v, d)},
                "embed_positions": {"weight": rand(cfg.max_target_positions, d)},
                "layers": dec_layers,
                "layer_norm": {"weight": ones(d), "bias": zeros(d)},
            },
        }
    }


# ---------------------------------------------------------------------------
# Checkpoint sanitizer (HF transformers and OpenAI/mlx-whisper layouts)
# ---------------------------------------------------------------------------


def whisper_sinusoids(length: int, channels: int) -> np.ndarray:
    half = channels // 2
    log_inc = math.log(10000.0) / max(half - 1, 1)
    scaled = np.arange(length)[:, None] * np.exp(-log_inc * np.arange(half))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


_MLX_ATTN_MAP = {"query": "q_proj", "key": "k_proj", "value": "v_proj", "out": "out_proj"}
_MLX_SUFFIX_MAP = {
    "attn_ln": "self_attn_layer_norm",
    "cross_attn_ln": "encoder_attn_layer_norm",
    "mlp_ln": "final_layer_norm",
    "mlp1": "fc1",
    "mlp2": "fc2",
}


def _remap_mlx_key(key: str) -> str | None:
    if key == "encoder.positional_embedding":
        return "model.encoder.embed_positions.weight"
    if key == "decoder.positional_embedding":
        return "model.decoder.embed_positions.weight"
    if key.startswith("decoder.token_embedding."):
        return "model.decoder.embed_tokens." + key[len("decoder.token_embedding."):]
    for conv in ("encoder.conv1.", "encoder.conv2."):
        if key.startswith(conv):
            return "model." + key
    if key.startswith("encoder.ln_post."):
        return "model.encoder.layer_norm." + key[len("encoder.ln_post."):]
    if key.startswith("decoder.ln."):
        return "model.decoder.layer_norm." + key[len("decoder.ln."):]
    for stem in ("encoder", "decoder"):
        prefix = f"{stem}.blocks."
        if not key.startswith(prefix):
            continue
        layer, _, suffix = key[len(prefix):].partition(".")
        head, _, tail = suffix.partition(".")
        if head in _MLX_SUFFIX_MAP:
            mapped = f"{_MLX_SUFFIX_MAP[head]}.{tail}"
        elif head in ("attn", "cross_attn"):
            container = "self_attn" if head == "attn" else "encoder_attn"
            proj, _, t2 = tail.partition(".")
            if proj not in _MLX_ATTN_MAP:
                return None
            mapped = f"{container}.{_MLX_ATTN_MAP[proj]}.{t2}"
        else:
            return None
        return f"model.{stem}.layers.{layer}.{mapped}"
    return None


def sanitize(weights: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Map a flat checkpoint to the canonical HF key layout."""
    if not any(".blocks." in k for k in weights):
        out = {}
        for key, value in weights.items():
            if key in ("proj_out.weight", "model.proj_out.weight"):
                continue  # tied to embed_tokens
            if not key.startswith("model.") and key.startswith(("encoder.", "decoder.")):
                key = "model." + key
            out[key] = value
        return out
    out = {}
    for key, value in weights.items():
        mapped = None if key == "alignment_heads" else _remap_mlx_key(key)
        if mapped is None:
            continue
        # mlx Conv1d layout [O, K, I] -> torch [O, I, K]
        if mapped.endswith(("conv1.weight", "conv2.weight")) and value.ndim == 3:
            value = value.permute(0, 2, 1).contiguous()
        out[mapped] = value
    if "model.encoder.embed_positions.weight" not in out:
        conv2 = out.get("model.encoder.conv2.weight")
        if conv2 is not None:
            out["model.encoder.embed_positions.weight"] = torch.from_numpy(
                whisper_sinusoids(1500, conv2.shape[0]))
    return out


# ---------------------------------------------------------------------------
# Decode loops
# ---------------------------------------------------------------------------


def _sample_loop(step, prompt: list[int], rows: int, max_total: int, eot: int,
                 suppress: torch.Tensor, begin: torch.Tensor,
                 temperature: float, generator: torch.Generator) -> list[list[int]]:
    """Teacher-force ``prompt`` on each of ``rows`` rows through
    ``step(tokens [rows], position) -> logits [rows, V] f32``, then decode
    every row with the suppress mask (plus ``begin`` on the first generated
    token), greedy or sampled. A row that has emitted EOT goes on emitting
    it; the loop stops once every row has, or at ``max_total`` tokens. One
    host read a generated token (whether every row has finished). Returns
    each row's sequence, prompt included, up to the last step (the port of
    the JAX package's ``_decode_loop`` at one row and of its
    ``_decode_loop_batched``)."""
    dev = suppress.device
    n_prompt = len(prompt)
    tokens = torch.empty((rows, max(max_total, n_prompt)), dtype=torch.long, device=dev)
    tokens[:, :n_prompt] = torch.tensor(prompt, dtype=torch.long, device=dev)
    finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
    count = n_prompt
    for i in range(max_total - 1):
        logits = step(tokens[:, i], i)
        if i < n_prompt - 1:
            continue
        lg = logits + suppress
        if i == n_prompt - 1:
            lg = lg + begin
        if temperature <= 0.0:
            nxt = torch.argmax(lg, dim=-1)
        else:
            probs = torch.softmax(lg / max(temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        nxt = torch.where(finished, eot, nxt)
        tokens[:, i + 1] = nxt
        finished |= nxt == eot
        count = i + 2
        if bool(finished.all()):
            break
    return tokens[:, :count].tolist()


def decode_step_fn(params, enc_out, *, max_total: int, cfg: WhisperConfig,
                   kv_bits: int | None = None, kv_group_size: int = 64,
                   quantized_kv_start: int = 0, layers=None):
    """``step(tokens [B], position) -> logits [B, V] f32`` over
    :func:`decoder_step` for the B windows of ``enc_out [B, S, D]``, one row
    each (the step of the JAX package's ``_decode_loop`` and
    ``_decode_loop_batched``). The self cache is
    ``kv_cache.make_cache_for``'s for the knobs. ``kv_bits=8`` stores the
    cross K/V as int8 (``kv_cache._quantize``), read by one int8 attention
    call a layer over the heads of all B windows; ``kv_bits=4`` stores them
    as packed int4, dequantized and attended (``"quant"``)."""
    b = enc_out.shape[0]
    n_heads = cfg.decoder_attention_heads
    head_dim = cfg.d_model // n_heads
    if layers is None:
        layers = _split_layers(params["model"]["decoder"]["layers"])
    cross_k, cross_v = _cross_kv(params, enc_out, cfg, layers)
    cache = kv_cache.make_cache_for(
        cfg.decoder_layers, b, n_heads, head_dim, max_total, enc_out.dtype,
        kv_bits=kv_bits, kv_group_size=kv_group_size,
        quantized_kv_start=quantized_kv_start, device=enc_out.device)
    if kv_bits:
        n_groups = head_dim // min(kv_group_size, head_dim)
        cross = (kv_cache._quantize(cross_k, n_groups, kv_bits)
                 + kv_cache._quantize(cross_v, n_groups, kv_bits))
        mode = "quant"
        if kv_bits == 8:
            # [L, B, H, S, .] -> [L, B*H, S, .]: the windows' heads side by side
            cross, mode = tuple(t.flatten(1, 2) for t in cross), "int8"
    else:
        cross, mode = (cross_k, cross_v), "dense"
    state = {"cache": cache}

    def step(tokens: torch.Tensor, i: int) -> torch.Tensor:
        logits, state["cache"] = decoder_step(
            params, tokens[:, None], i, state["cache"], cross, cfg, cross_mode=mode,
            layers=layers)
        return logits[:, -1].to(torch.float32)

    return step


def _fused_head(p: dict, y: torch.Tensor, dtype) -> torch.Tensor:
    """The fused routes' final LayerNorm and tied head on one row ``y [d]``
    f32: logits ``[1, V]`` f32."""
    h = nn.layer_norm(p["layer_norm"], y[None])
    return nn.embedding_as_linear(p["embed_tokens"], h.to(dtype)).to(torch.float32)


def fused_decode_step_fn(params, pack: F.FusedPack, enc_out, *, max_total: int,
                         cfg: WhisperConfig, layers=None):
    """``step(tokens [1], position) -> logits [1, V] f32`` over
    :func:`ops.fused_decoder.fused_stack` for one window (the step of the
    JAX package's ``_decode_loop_fused``, the w8 kv8d configuration): int8
    decoder weights with dynamic int8 activations, int8 cross K/V with
    per-position scales, dense bf16 self cache, tanh-GELU."""
    d, L = cfg.d_model, cfg.decoder_layers
    dev = enc_out.device
    cross_k, cross_v = _cross_kv(params, enc_out, cfg, layers)
    ck, ks, cv, vs = F.quantize_cross_kv(cross_k, cross_v)
    s_src = enc_out.shape[1]
    kc = torch.zeros((L, max_total, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros((L, max_total, d), dtype=torch.bfloat16, device=dev)
    p = params["model"]["decoder"]

    def step(tokens: torch.Tensor, i: int) -> torch.Tensor:
        x = nn.embedding(p["embed_tokens"], tokens)[0]
        x = x.to(torch.float32) + p["embed_positions"]["weight"][i].to(torch.float32)
        y, _, _ = F.fused_stack(pack, ck, ks, cv, vs, kc, vc, x, i, cfg=cfg,
                                s_src=s_src)
        return _fused_head(p, y, enc_out.dtype)

    return step


def fused_lanes_decode_step_fn(params, pack: F.FusedPack, enc_out, *, max_total: int,
                               cfg: WhisperConfig, layers=None):
    """``step(tokens [B], position) -> logits [B, V] f32`` over
    :func:`ops.fused_decoder.fused_stack_lanes` for the B windows of
    ``enc_out``, one lane a window: one call a step for all of them, with
    the w8 kv8d arithmetic of :func:`fused_decode_step_fn`. Each window's
    cross K/V is quantized on its own (``quantize_cross_kv``), and the
    final LayerNorm and head run one window's row at a time (a product's
    rounding may follow its row count), so a window's logits are those of
    :func:`fused_decode_step_fn` on that window alone: the lanes kernel is
    bit-equal to the one-token kernel lane by lane."""
    d, L = cfg.d_model, cfg.decoder_layers
    b, s_src = enc_out.shape[0], enc_out.shape[1]
    dev = enc_out.device
    cross_k, cross_v = _cross_kv(params, enc_out, cfg, layers)
    ctx = [torch.stack(t) for t in zip(*(
        F.quantize_cross_kv(cross_k[:, w:w + 1], cross_v[:, w:w + 1]) for w in range(b)))]
    del cross_k, cross_v
    kc = torch.zeros((b, L, max_total, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    lanes = torch.arange(b, dtype=torch.int32, device=dev)
    p = params["model"]["decoder"]

    def step(tokens: torch.Tensor, i: int) -> torch.Tensor:
        x = nn.embedding(p["embed_tokens"], tokens).to(torch.float32)
        x = x + p["embed_positions"]["weight"][i].to(torch.float32)
        offsets = torch.full((b,), i, dtype=torch.int32, device=dev)
        y, _, _ = F.fused_stack_lanes(pack, *ctx, kc, vc, x, offsets, lanes, cfg=cfg,
                                      s_src=s_src)
        return torch.cat([_fused_head(p, y[w], enc_out.dtype) for w in range(b)])

    return step


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class _StackModule(loading.TreeModule):
    """A parameter sub-tree with stacked ``layers`` as module buffers, and
    its per-layer views (kept until the buffers move)."""

    def __init__(self, tree: dict, cfg: WhisperConfig):
        super().__init__(tree)
        self.cfg = cfg
        self._split = None

    def _apply(self, fn, *args, **kwargs):
        self._split = None
        return super()._apply(fn, *args, **kwargs)

    def split_layers(self) -> list[dict]:
        if self._split is None:
            self._split = _split_layers(self.tree()["layers"])
        return self._split


class WhisperEncoder(_StackModule):
    """The encoder (``model.encoder``): mel ``[B, 3000, n_mels]`` ->
    hidden ``[B, 1500, D]``."""

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return _encode(self.tree(), mel, self.cfg, self.split_layers())


class WhisperDecoder(_StackModule):
    """The decoder (``model.decoder``): full-sequence causal forward."""

    def forward(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        return decoder_forward({"model": {"decoder": self.tree()}}, tokens,
                               enc_out, self.cfg)


class Whisper(tnn.Module):
    """Whisper STT with ``from_pretrained`` / ``generate`` /
    ``generate_stream`` / ``detect_language``."""

    def __init__(self, config: WhisperConfig, params: dict, tokenizer=None,
                 generation_config: WhisperGenerationConfig | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if config.quantization:
            # an MLX 4/8-bit checkpoint: its {weight, scales, biases} triples
            # become QuantizedTensor leaves (the encoder's products then
            # dequantize and multiply, the decoder step's run the GEMV kernel)
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        self.config = config
        self.tokenizer = tokenizer
        self.generation_config = generation_config or WhisperGenerationConfig()
        self.dtype = dtype
        self.encoder = WhisperEncoder(params["model"]["encoder"], config)
        self.decoder = WhisperDecoder(params["model"]["decoder"], config)
        self._pack = None
        if device is not None:
            self.to(device)

    def _apply(self, fn, *args, **kwargs):
        self._pack = None  # packed from the buffers being moved
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.decoder.embed_positions.weight.device

    @property
    def params(self) -> dict:
        return {"model": {"encoder": self.encoder.tree(),
                          "decoder": self.decoder.tree()}}

    def fused_decoder_pack(self) -> F.FusedPack:
        """Load-time weight pack for the fused decoder (built once)."""
        if self._pack is None:
            self._pack = F.pack_decoder_weights(self.params, self.config)
        return self._pack

    # -- loading ------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16,
                        device="cuda", quantize: str | None = None) -> "Whisper":
        """Load a local checkpoint directory. ``quantize="w8a8"`` stores the
        decoder's linear weights as per-channel int8
        (``quant.quantize_tree``); with ``kv_bits=8`` and
        ``quantized_kv_start`` >= the decode length that selects the fused
        w8 kv8d decoder."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir)
        config = WhisperConfig.from_dict(cfg_dict)
        config.quantization = cfg_dict.get("quantization")
        gen_cfg = None
        gc_path = model_dir / "generation_config.json"
        if gc_path.exists():
            gen_cfg = WhisperGenerationConfig.from_dict(json.loads(gc_path.read_text()))
        elif "suppress_tokens" in cfg_dict or "begin_suppress_tokens" in cfg_dict:
            gen_cfg = WhisperGenerationConfig.from_dict(cfg_dict)
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype,
                                     expected_prefixes=("model",))
        params = loading.stack_layer_params(params)
        if quantize is not None:
            params["model"]["decoder"] = quant.quantize_tree(
                params["model"]["decoder"], scheme=quantize)
        tokenizer = None
        if (model_dir / "tokenizer.json").exists():
            tokenizer = WhisperTokenizer.from_dir(model_dir, config.vocab_size)
        else:
            warnings.warn(
                f"whisper checkpoint at {model_dir} has no tokenizer.json "
                "(tpu_audio_torch does not fetch one); generate() will raise "
                "until a tokenizer is provided")
        return cls(config, params, tokenizer, gen_cfg, dtype, device)

    # -- features -----------------------------------------------------------

    def encoder_features(self, audio: np.ndarray) -> torch.Tensor:
        """Pad/trim to 30 s and compute ``[1, 3000, n_mels]`` features."""
        audio = np.asarray(audio, np.float32)
        if audio.shape[0] > CHUNK_LENGTH_SAMPLES:
            audio = audio[:CHUNK_LENGTH_SAMPLES]
        elif audio.shape[0] < CHUNK_LENGTH_SAMPLES:
            audio = np.pad(audio, (0, CHUNK_LENGTH_SAMPLES - audio.shape[0]))
        mel = dsp.log_mel_spectrogram(audio, n_mels=self.config.num_mel_bins,
                                      device=self.device)
        return mel.t()[None].to(self.dtype)

    def _suppress_masks(self, tokenizer) -> tuple[torch.Tensor, torch.Tensor]:
        v = self.config.vocab_size
        suppress = np.zeros((v,), np.float32)
        for tid in self.generation_config.suppress_tokens:
            if 0 <= tid < v:
                suppress[tid] = -1e9
        if tokenizer is not None and tokenizer.timestamp_begin is not None:
            suppress[tokenizer.timestamp_begin :] = -1e9
        begin = np.zeros((v,), np.float32)
        begin_ids = self.generation_config.begin_suppress_tokens or (
            [tokenizer.eot] if tokenizer is not None else [])
        for tid in begin_ids:
            if 0 <= tid < v:
                begin[tid] = -1e9
        dev = self.device
        return torch.from_numpy(suppress).to(dev), torch.from_numpy(begin).to(dev)

    # -- generation -----------------------------------------------------------

    def generate(self, audio: np.ndarray,
                 generation_parameters: STTGenerateParameters | None = None
                 ) -> STTOutput:
        """Transcribe ``audio`` (16 kHz) in 30 s windows. With
        ``batch_windows`` (the default) the windows go in groups of up to
        ``_WINDOW_BATCH_MAX``, each group in one encoder call over its rows
        and one decode loop with a row a window; otherwise one window at a
        time. Greedy tokens are the same either way where every product
        is an exact integer sum (an int8 encoder and the w8 kv8d route); a
        floating-point product over more rows may round otherwise, which can
        move a near-tie. A group's decode route:

        - dense (``kv_bits`` None): :func:`decoder_step` at B rows over
          dense cross K/V ``[L, B, H, S, D]``;
        - kv8d (``kv_bits=8``, dense self cache): :func:`decoder_step` at B
          rows, its cross attention one int8 attention call a layer over
          the B*H heads of the group;
        - a quantized or hybrid self cache (``kv_bits`` 8 or 4 with
          ``quantized_kv_start`` below the decode length):
          :func:`decoder_step` at B rows through ``make_layer_updater``,
          its cross attention on the int8 kernel at 8 bits and dequantized
          at 4;
        - w8 kv8d on a decoder shape the fused kernels take: the windows
          are the lanes of ``ops.fused_decoder.fused_stack_lanes``, one
          call a step for the group (a lone window takes ``fused_stack``).
          The lanes kernel is bit-equal to the one-token kernel lane by
          lane, so each window gets the tokens of its per-window decode.

        A group is never padded to a bucket of window counts: its rows are
        independent, and the JAX package's buckets only spared XLA
        recompiles."""
        params = generation_parameters or STTGenerateParameters()
        tokenizer = self.tokenizer
        if tokenizer is None:
            raise RuntimeError("tokenizer not loaded; use from_pretrained")
        t_start = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        chunks = [(audio[s : s + CHUNK_LENGTH_SAMPLES], s / SAMPLE_RATE)
                  for s in range(0, max(len(audio), 1), CHUNK_LENGTH_SAMPLES)]
        suppress, begin = self._suppress_masks(tokenizer)
        prompt = tokenizer.build_prompt_tokens(params.language, params.task)
        group = _WINDOW_BATCH_MAX if params.batch_windows else 1
        token_lists = [tokens for g in range(0, len(chunks), group)
                       for tokens in self._transcribe_windows(
                           [c for c, _ in chunks[g : g + group]], prompt, suppress,
                           begin, params)]
        all_text, segments = [], []
        for (chunk, offset), tokens in zip(chunks, token_lists):
            text = tokenizer.decode(tokens).strip()
            if text:
                all_text.append(text)
                segments.append(STTSegment(text=text, start=offset,
                                           end=offset + len(chunk) / SAMPLE_RATE,
                                           tokens=tokens))
        elapsed = time.perf_counter() - t_start
        lang = params.language
        if lang is None and tokenizer.is_multilingual and len(prompt) > 1:
            lang = tokenizer.id_to_language.get(prompt[1])
        return STTOutput(
            text=" ".join(all_text), segments=segments, language=lang,
            prompt_token_count=len(prompt) * len(chunks),
            generation_token_count=sum(len(t) for t in token_lists),
            prompt_time=elapsed, generation_time=elapsed, total_time=elapsed)

    def generate_stream(self, audio: np.ndarray,
                        generation_parameters: STTGenerateParameters | None = None):
        """Yield ``{"type": "token", "text": ...}`` per 30 s window, then
        ``{"type": "result", "output": STTOutput}``. The windows decode one
        at a time, as in the JAX package."""
        params = generation_parameters or STTGenerateParameters()
        tokenizer = self.tokenizer
        if tokenizer is None:
            raise RuntimeError("tokenizer not loaded; use from_pretrained")
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        suppress, begin = self._suppress_masks(tokenizer)
        prompt = tokenizer.build_prompt_tokens(params.language, params.task)
        t_start = time.perf_counter()
        all_text, segments = [], []
        total_gen = 0
        for s in range(0, max(len(audio), 1), CHUNK_LENGTH_SAMPLES):
            chunk = audio[s : s + CHUNK_LENGTH_SAMPLES]
            tokens = self._transcribe_chunk(chunk, prompt, suppress, begin, params)
            total_gen += len(tokens)
            text = tokenizer.decode(tokens).strip()
            if text:
                yield {"type": "token", "text": text}
                all_text.append(text)
                segments.append(STTSegment(text=text, start=s / SAMPLE_RATE,
                                           end=(s + len(chunk)) / SAMPLE_RATE,
                                           tokens=tokens))
        elapsed = time.perf_counter() - t_start
        yield {"type": "result", "output": STTOutput(
            text=" ".join(all_text), segments=segments,
            prompt_token_count=len(prompt) * max(1, len(segments)),
            generation_token_count=total_gen,
            total_time=elapsed, generation_time=elapsed)}

    def _fused_supported(self) -> bool:
        """int8 (w8a8) decoder weights and a shape the fused kernels take."""
        fc1 = self.params["model"]["decoder"]["layers"]["fc1"]["weight"]
        return isinstance(fc1, quant.Int8Tensor) and F.supported(self.config)

    def _transcribe_chunk(self, chunk, prompt, suppress, begin,
                          params: STTGenerateParameters) -> list[int]:
        return self._transcribe_windows([chunk], prompt, suppress, begin, params)[0]

    @torch.inference_mode()
    def _transcribe_windows(self, chunks, prompt, suppress, begin,
                            params: STTGenerateParameters) -> list[list[int]]:
        """Transcribe the 30 s windows ``chunks`` (at most
        ``_WINDOW_BATCH_MAX``) in one encoder call and one decode loop, a row
        a window, on the route :meth:`generate` names. Returns each window's
        generated tokens up to its first EOT."""
        enc_out = self.encoder(torch.cat([self.encoder_features(c) for c in chunks]))
        max_total = min(self.config.max_target_positions,
                        len(prompt) + max(1, params.max_tokens))
        generator = torch.Generator(device=self.device).manual_seed(0)
        eot = self.tokenizer.eot
        kw = dict(max_total=max_total, cfg=self.config, layers=self.decoder.split_layers())
        kv8d = params.kv_bits == 8 and params.quantized_kv_start >= max_total
        if kv8d and self._fused_supported():
            fn = fused_decode_step_fn if len(chunks) == 1 else fused_lanes_decode_step_fn
            step = fn(self.params, self.fused_decoder_pack(), enc_out, **kw)
        else:
            step = decode_step_fn(
                self.params, enc_out, kv_bits=params.kv_bits,
                kv_group_size=params.kv_group_size,
                quantized_kv_start=params.quantized_kv_start, **kw)
        rows = _sample_loop(step, prompt, len(chunks), max_total, eot, suppress, begin,
                            params.temperature, generator)
        gens = [row[len(prompt):] for row in rows]
        return [gen[: gen.index(eot)] if eot in gen else gen for gen in gens]

    @torch.inference_mode()
    def detect_language(self, audio: np.ndarray) -> tuple[str, float]:
        """One decoder step from SOT; argmax over the language tokens."""
        tokenizer = self.tokenizer
        cfg = self.config
        enc_out = self.encoder(self.encoder_features(np.asarray(audio, np.float32)))
        layers = self.decoder.split_layers()
        cross = _cross_kv(self.params, enc_out, cfg, layers)
        cache = kv_cache.init_cache(
            cfg.decoder_layers, 1, cfg.decoder_attention_heads,
            cfg.d_model // cfg.decoder_attention_heads,
            cfg.max_target_positions, self.dtype, device=self.device)
        logits, _ = decoder_step(
            self.params, torch.tensor([[tokenizer.sot]], device=self.device), 0,
            cache, cross, cfg, layers=layers)
        probs = torch.softmax(logits[0, -1].to(torch.float32), -1).cpu().numpy()
        lang_ids = np.asarray(sorted(tokenizer.language_to_id.values()))
        lang_probs = probs[lang_ids]
        best = int(np.argmax(lang_probs))
        return tokenizer.id_to_language[int(lang_ids[best])], float(lang_probs[best])
