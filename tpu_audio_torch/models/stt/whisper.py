"""Whisper STT on PyTorch: conv stem + encoder-decoder transformer with a
KV-cached decode loop (port of tpu_audio.models.stt.whisper).

The JAX package runs each 30 s window's decode as one ``lax.while_loop``;
here it is a Python loop over tokens on the device with one host read per
token (the EOT check). Greedy argmax and the suppress/begin masks are the
JAX package's. Three decode routes, chosen as the JAX package chooses
them for every published whisper size:

- dense: ``decoder_step`` with a dense self cache and dense cross K/V;
- kv8d (``kv_bits=8``, ``quantized_kv_start >= max_total``): dense self
  cache, int8 cross K/V read by ``ops.kv_attention.decode_attention_int8``;
- w8 kv8d (kv8d with int8 decoder weights from ``quant.quantize_tree``):
  the whole layer stack per token in ``ops.fused_decoder.fused_stack``.

An MLX 4/8-bit checkpoint (``quantization`` in its config) decodes on the
first two routes: each linear of a decode step runs the grouped-affine
GEMV kernel (``ops.qmm``), and the encoder's 1,500-row products
dequantize and multiply.

Not ported yet (each raises ``NotImplementedError``): batched long-form
windows, ``kv_bits=4``, int8/hybrid self caches.
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


def decoder_step(params: dict, tokens: torch.Tensor, pos: int,
                 cache: kv_cache.KVCache, cross: tuple, cfg: WhisperConfig,
                 cross_mode: str = "dense", layers: list[dict] | None = None):
    """One decode step: tokens ``[B, T]`` at positions ``pos..pos+T``.
    Returns ``(logits [B, T, V], cache)``; the cache is updated in place and
    returned with its offset advanced.

    ``cross_mode``: ``"dense"`` (``cross = (k, v)``, each
    ``[L, B, H, S, Dh]``) or ``"int8"`` (``cross`` = the six
    ``_quantize`` planes ``(kc, ks, kb, vc, vs, vb)``, each ``[L, H, S, .]``,
    read by the int8 attention kernel; requires B = T = 1)."""
    p = params["model"]["decoder"]
    if layers is None:
        layers = _split_layers(p["layers"])
    n_heads = cfg.decoder_attention_heads
    b, t = tokens.shape
    if cross_mode == "int8" and (b, t) != (1, 1):
        raise ValueError("int8 cross attention decodes one token of one row")
    x = nn.embedding(p["embed_tokens"], tokens)
    x = x + p["embed_positions"]["weight"][pos : pos + t].to(x.dtype)
    d = x.shape[-1]
    hd = d // n_heads
    mask = kv_cache.attention_mask(cache, t)
    off = cache.offset
    for li, lp in enumerate(layers):
        h = nn.layer_norm(lp["self_attn_layer_norm"], x)
        ap = lp["self_attn"]
        q = _heads(nn.linear(ap["q_proj"], h), n_heads)
        cache.k[li, :, :, off : off + t] = _heads(nn.linear(ap["k_proj"], h),
                                                  n_heads).to(cache.k.dtype)
        cache.v[li, :, :, off : off + t] = _heads(nn.linear(ap["v_proj"], h),
                                                  n_heads).to(cache.v.dtype)
        o = nn.sdpa(q, cache.k[li].to(x.dtype), cache.v[li].to(x.dtype), mask=mask)
        x = x + nn.linear(ap["out_proj"], _merge(o))

        h = nn.layer_norm(lp["encoder_attn_layer_norm"], x)
        cp = lp["encoder_attn"]
        q = _heads(nn.linear(cp["q_proj"], h), n_heads)
        if cross_mode == "int8":
            o = K.decode_attention_int8(
                q[0], *(c[li] for c in cross), cross[0].shape[2],
                sm_scale=1.0 / math.sqrt(hd))[None].to(x.dtype)
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


def _sample_loop(step, prompt: list[int], max_total: int, eot: int,
                 suppress: torch.Tensor, begin: torch.Tensor,
                 temperature: float, generator: torch.Generator) -> list[int]:
    """Teacher-force ``prompt`` through ``step(token, position) -> logits
    [V] f32``, then decode with the suppress mask (plus ``begin`` on the
    first generated token) until EOT or ``max_total`` tokens. Returns the
    whole sequence, prompt included."""
    tokens = list(prompt)
    n_prompt = len(prompt)
    for i in range(max_total - 1):
        logits = step(tokens[i], i)
        if i < n_prompt - 1:
            continue
        lg = logits + suppress
        if i == n_prompt - 1:
            lg = lg + begin
        if temperature <= 0.0:
            nxt = int(torch.argmax(lg))
        else:
            probs = torch.softmax(lg / max(temperature, 1e-6), dim=-1)
            nxt = int(torch.multinomial(probs, 1, generator=generator))
        tokens.append(nxt)
        if nxt == eot:
            break
    return tokens


def decode_step_fn(params, enc_out, *, max_total: int, cfg: WhisperConfig,
                   kv_bits: int | None = None, kv_group_size: int = 64,
                   quantized_kv_start: int = 0, layers=None):
    """``step(token, position) -> logits [V] f32`` over :func:`decoder_step`
    for one window (the step of the JAX package's ``_decode_loop``).
    ``kv_bits=8`` stores the cross K/V as int8 (``kv_cache._quantize``),
    read by the int8 attention kernel beside a dense self cache."""
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
        if b != 1:
            raise NotImplementedError("int8 cross K/V decodes one window (B=1)")
        n_groups = head_dim // min(kv_group_size, head_dim)
        cross = (kv_cache._quantize(cross_k[:, 0], n_groups, kv_bits)
                 + kv_cache._quantize(cross_v[:, 0], n_groups, kv_bits))
        mode = "int8"
    else:
        cross, mode = (cross_k, cross_v), "dense"
    dev = enc_out.device
    state = {"cache": cache}

    def step(tok: int, i: int) -> torch.Tensor:
        logits, state["cache"] = decoder_step(
            params, torch.tensor([[tok]], device=dev), i, state["cache"], cross,
            cfg, cross_mode=mode, layers=layers)
        return logits[0, -1].to(torch.float32)

    return step


def fused_decode_step_fn(params, pack: F.FusedPack, enc_out, *, max_total: int,
                         cfg: WhisperConfig, layers=None):
    """``step(token, position) -> logits [V] f32`` over
    :func:`ops.fused_decoder.fused_stack` (the step of the JAX package's
    ``_decode_loop_fused``, the w8 kv8d configuration): int8 decoder
    weights with dynamic int8 activations, int8 cross K/V with
    per-position scales, dense bf16 self cache, tanh-GELU."""
    d, L = cfg.d_model, cfg.decoder_layers
    dev = enc_out.device
    cross_k, cross_v = _cross_kv(params, enc_out, cfg, layers)
    ck, ks, cv, vs = F.quantize_cross_kv(cross_k, cross_v)
    s_src = enc_out.shape[1]
    kc = torch.zeros((L, max_total, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros((L, max_total, d), dtype=torch.bfloat16, device=dev)
    p = params["model"]["decoder"]

    def step(tok: int, i: int) -> torch.Tensor:
        x = nn.embedding(p["embed_tokens"], torch.tensor([tok], device=dev))[0]
        x = x.to(torch.float32) + p["embed_positions"]["weight"][i].to(torch.float32)
        y, _, _ = F.fused_stack(pack, ck, ks, cv, vs, kc, vc, x, i, cfg=cfg,
                                s_src=s_src)
        h = nn.layer_norm(p["layer_norm"], y[None])
        return nn.embedding_as_linear(p["embed_tokens"], h.to(enc_out.dtype)
                                      )[0].to(torch.float32)

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

    def _check_params(self, params: STTGenerateParameters) -> None:
        if params.kv_bits == 4:
            raise NotImplementedError(
                "kv_bits=4 (packed int4 KV) is not ported yet; use 8 or None")

    def generate(self, audio: np.ndarray,
                 generation_parameters: STTGenerateParameters | None = None
                 ) -> STTOutput:
        params = generation_parameters or STTGenerateParameters()
        self._check_params(params)
        tokenizer = self.tokenizer
        if tokenizer is None:
            raise RuntimeError("tokenizer not loaded; use from_pretrained")
        t_start = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        chunks = [(audio[s : s + CHUNK_LENGTH_SAMPLES], s / SAMPLE_RATE)
                  for s in range(0, max(len(audio), 1), CHUNK_LENGTH_SAMPLES)]
        if params.batch_windows and len(chunks) > 1:
            raise NotImplementedError(
                "batched decoding of audio longer than 30 s is not ported yet; "
                "pass batch_windows=False to decode the windows one by one")
        suppress, begin = self._suppress_masks(tokenizer)
        prompt = tokenizer.build_prompt_tokens(params.language, params.task)
        all_text, segments = [], []
        total_gen = 0
        for chunk, offset in chunks:
            tokens = self._transcribe_chunk(chunk, prompt, suppress, begin, params)
            total_gen += len(tokens)
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
            generation_token_count=total_gen,
            prompt_time=elapsed, generation_time=elapsed, total_time=elapsed)

    def generate_stream(self, audio: np.ndarray,
                        generation_parameters: STTGenerateParameters | None = None):
        """Yield ``{"type": "token", "text": ...}`` per 30 s window, then
        ``{"type": "result", "output": STTOutput}``."""
        params = generation_parameters or STTGenerateParameters()
        self._check_params(params)
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

    @torch.inference_mode()
    def _transcribe_chunk(self, chunk, prompt, suppress, begin,
                          params: STTGenerateParameters) -> list[int]:
        enc_out = self.encoder(self.encoder_features(chunk))
        max_total = min(self.config.max_target_positions,
                        len(prompt) + max(1, params.max_tokens))
        generator = torch.Generator(device=self.device).manual_seed(0)
        eot = self.tokenizer.eot
        kv8d = params.kv_bits == 8 and params.quantized_kv_start >= max_total
        if kv8d and self._fused_supported():
            step = fused_decode_step_fn(
                self.params, self.fused_decoder_pack(), enc_out,
                max_total=max_total, cfg=self.config,
                layers=self.decoder.split_layers())
        else:
            step = decode_step_fn(
                self.params, enc_out, max_total=max_total, cfg=self.config,
                kv_bits=params.kv_bits, kv_group_size=params.kv_group_size,
                quantized_kv_start=params.quantized_kv_start,
                layers=self.decoder.split_layers())
        tokens = _sample_loop(step, prompt, max_total, eot, suppress, begin,
                              params.temperature, generator)
        gen = tokens[len(prompt):]
        if eot in gen:
            gen = gen[: gen.index(eot)]
        return gen

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
