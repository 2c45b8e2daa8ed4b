"""Llama-family decoder backbone (HF layout) with KV-cached steps (port of
tpu_audio.models.llama).

GQA, Llama-3 NTK rope scaling, optional per-head q/k RMSNorm (Qwen3),
attention bias, tied embeddings, per-channel int8 (w8a8) and MLX
grouped-affine 4/8-bit weights. The
parameter tree is a nested dict with the decoder layers stacked
(``[L, ...]`` leaves) or kept per layer (``{"0": ..., "1": ...}``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.core import kv_cache, nn, quant

__all__ = ["LlamaConfig", "forward", "layer_forward", "init_random_params",
           "maybe_stack", "fuse_projections", "make_cache", "sanitize"]


@dataclass
class LlamaConfig:
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int | None = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 128256
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    qk_norm: bool = False  # Qwen3-style per-head q/k RMSNorm
    rope_interleaved: bool = False  # "traditional"/NeoX pairing (GLM)
    max_position_embeddings: int = 8192
    # Granite-style scale knobs; the defaults are exact no-ops
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float | None = None  # sdpa scale override
    logits_scaling: float = 1.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def llama3_scaling(self) -> dict | None:
        """``rope_scaling`` when it is the Llama-3 NTK kind, else None."""
        rs = self.rope_scaling
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            return rs
        return None

    @classmethod
    def from_dict(cls, d: dict) -> "LlamaConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


def _is_per_layer_dict(layers) -> bool:
    # a contiguous "0".."N-1" key set; anything else stays as it is
    return (isinstance(layers, dict) and "0" in layers
            and all(str(i) in layers for i in range(len(layers))))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, quant.Int8Tensor):
        return [tree.weight, tree.scale]
    if isinstance(tree, quant.QuantizedTensor):
        return [tree.weight, tree.scales, tree.biases]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, quant.QuantizedTensor):
        return ("QuantizedTensor", tree.group_size, tree.bits)
    return type(tree).__name__


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *[t[k] for t in trees]) for k in first}
    if isinstance(first, quant.Int8Tensor):
        return quant.Int8Tensor(fn(*[t.weight for t in trees]),
                                fn(*[t.scale for t in trees]))
    if isinstance(first, quant.QuantizedTensor):
        return quant.QuantizedTensor(*(fn(*[getattr(t, f) for t in trees])
                                       for f in ("weight", "scales", "biases")),
                                     first.group_size, first.bits)
    return fn(*trees)


def maybe_stack(params: dict) -> dict:
    """Stack a per-layer ``layers`` dict into ``[L, ...]`` leaves when all
    layers share one structure and shapes; heterogeneous layers (e.g.
    per-layer quantization) stay per layer."""
    p = params["model"] if "model" in params else params
    layers = p.get("layers")
    if not _is_per_layer_dict(layers):
        return params
    per = [layers[str(i)] for i in range(len(layers))]
    if (len({_structure(t) for t in per}) > 1
            or len({tuple(tuple(x.shape) for x in _leaves(t)) for t in per}) > 1):
        return params
    p["layers"] = _map(lambda *xs: torch.stack(xs), *per)
    return params


def _concat_weights(parts, axis):
    """Concatenate linear weights along the output axis (dense tensors,
    :class:`quant.Int8Tensor` or :class:`quant.QuantizedTensor`, whose
    words, scales and biases all share the output axis); None when the
    parts are of mixed kinds or MLX parts differ in group size or bits."""
    if len({type(p) for p in parts}) > 1:
        return None
    if isinstance(parts[0], quant.Int8Tensor):
        return quant.Int8Tensor(torch.cat([p.weight for p in parts], dim=axis),
                                torch.cat([p.scale for p in parts], dim=-1))
    if isinstance(parts[0], quant.QuantizedTensor):
        if len({(p.group_size, p.bits) for p in parts}) > 1:
            return None
        return _map(lambda *ts: torch.cat(ts, dim=axis), *parts)
    return torch.cat(parts, dim=axis)


def fuse_projections(params: dict) -> dict:
    """Fuse q/k/v -> ``qkv_proj`` and gate/up -> ``gate_up_proj`` along the
    output-features axis (one product instead of three / two); biases are
    fused too when every part has one. Raw (untagged) MLX triples stay
    apart: fusing their words would drop the scales and biases
    (``quant.tag_quantized`` first)."""
    p = params["model"] if "model" in params else params
    layers = p.get("layers")

    def fuse_group(container, names, fused_name, axis):
        if not all(n in container for n in names):
            return container
        if any("scales" in container[n] for n in names):
            return container
        with_bias = ["bias" in container[n] for n in names]
        if any(with_bias) and not all(with_bias):
            return container
        w = _concat_weights([container[n]["weight"] for n in names], axis)
        if w is None:
            return container
        fused = {"weight": w}
        if all(with_bias):
            fused["bias"] = torch.cat([container[n]["bias"] for n in names], dim=-1)
        out = {k: v for k, v in container.items() if k not in names}
        out[fused_name] = fused
        return out

    def fuse_layer(lp, axis):
        out = dict(lp)
        out["self_attn"] = fuse_group(lp["self_attn"], ("q_proj", "k_proj", "v_proj"),
                                      "qkv_proj", axis)
        out["mlp"] = fuse_group(lp["mlp"], ("gate_proj", "up_proj"), "gate_up_proj",
                                axis)
        return out

    if _is_per_layer_dict(layers):
        p["layers"] = {k: fuse_layer(v, 0) for k, v in layers.items()}
    else:
        p["layers"] = fuse_layer(layers, 1)  # stacked [L, O, I]
    return params


def _rope_tables(cfg: LlamaConfig, positions: torch.Tensor):
    inv_freq = nn.rope_freqs(cfg.resolved_head_dim, cfg.rope_theta,
                             cfg.llama3_scaling, device=positions.device)
    ang = positions[:, None].to(torch.float32) * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def layer_forward(x, lp, cfg: LlamaConfig, cos, sin, *, mask=None,
                  attn_mask=None, causal: bool = True, kv_update=None):
    """One decoder layer on ``x [B, T, D]``; ``kv_update(k, v)`` (optional)
    writes the cache and returns the full-capacity K/V views to attend."""
    b, t = x.shape[:2]
    n_heads, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.resolved_head_dim)
    h = nn.rms_norm(lp["input_layernorm"], x, cfg.rms_norm_eps)
    ap = lp["self_attn"]
    if "qkv_proj" in ap:
        qkv = nn.linear(ap["qkv_proj"], h)
        nq, nk = n_heads * hd, n_kv * hd
        q = qkv[..., :nq].reshape(b, t, n_heads, hd)
        k = qkv[..., nq:nq + nk].reshape(b, t, n_kv, hd)
        v = qkv[..., nq + nk:].reshape(b, t, n_kv, hd)
    else:
        q = nn.linear(ap["q_proj"], h).reshape(b, t, n_heads, hd)
        k = nn.linear(ap["k_proj"], h).reshape(b, t, n_kv, hd)
        v = nn.linear(ap["v_proj"], h).reshape(b, t, n_kv, hd)
    if cfg.qk_norm:
        q = nn.rms_norm(ap["q_norm"], q, cfg.rms_norm_eps)
        k = nn.rms_norm(ap["k_norm"], k, cfg.rms_norm_eps)
    q = nn.apply_rope(q.transpose(1, 2), cos, sin, interleaved=cfg.rope_interleaved)
    k = nn.apply_rope(k.transpose(1, 2), cos, sin, interleaved=cfg.rope_interleaved)
    v = v.transpose(1, 2)
    if kv_update is not None:
        k_full, v_full = kv_update(k, v)
        o = nn.sdpa(q, k_full, v_full, mask=mask, scale=cfg.attention_multiplier)
    else:
        o = nn.sdpa(q, k, v, mask=attn_mask, is_causal=causal and attn_mask is None,
                    scale=cfg.attention_multiplier)
    o = o.transpose(1, 2).reshape(b, t, n_heads * hd)
    x = x + nn.linear(ap["o_proj"], o) * cfg.residual_multiplier

    h = nn.rms_norm(lp["post_attention_layernorm"], x, cfg.rms_norm_eps)
    mp = lp["mlp"]
    if "gate_up_proj" in mp:
        gu = nn.linear(mp["gate_up_proj"], h)
        ffn = gu.shape[-1] // 2
        act = nn.silu(gu[..., :ffn]) * gu[..., ffn:]
    else:
        act = nn.silu(nn.linear(mp["gate_proj"], h)) * nn.linear(mp["up_proj"], h)
    return x + nn.linear(mp["down_proj"], act) * cfg.residual_multiplier


def layer_list(layers) -> list[dict]:
    """The decoder layers one by one, from a stacked or per-layer tree."""
    if _is_per_layer_dict(layers):
        return [layers[str(i)] for i in range(len(layers))]
    n = _leaves(layers)[0].shape[0]
    return [_map(lambda a, i=i: a[i], layers) for i in range(n)]


def forward(params, tokens, cache, cfg: LlamaConfig,
            inputs_embeds=None, return_hidden: bool = False,
            attn_mask=None, causal: bool = True):
    """Decoder forward over ``tokens [B, T]`` (or ``inputs_embeds
    [B, T, D]``) appending to ``cache`` (a dense, quantized or hybrid
    ``kv_cache`` cache, written in place).

    Returns ``(logits [B, T, V], cache)``, or the final-normed hidden
    states with ``return_hidden``. Left padding from prompt bucketing is
    masked through ``cache.valid_from``. Without a cache, ``causal=False``
    attends bidirectionally and ``attn_mask`` ([..., q, k] bool) can
    exclude positions."""
    p = params["model"] if "model" in params else params
    if inputs_embeds is not None:
        x = inputs_embeds
    else:
        x = nn.embedding(p["embed_tokens"], tokens)
    t = x.shape[1]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    offset = cache.offset if cache is not None else 0
    positions = offset + torch.arange(t, device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    mask = kv_cache.attention_mask(cache, t) if cache is not None else None
    cache_xs, cache_update, cache_fold = kv_cache.make_layer_updater(cache)

    written = []
    for i, lp in enumerate(layer_list(p["layers"])):
        kv_update = None
        if cache is not None:
            def kv_update(k, v, _i=i, _x=x):
                new_l, k_full, v_full = cache_update(cache_xs[_i], offset, k, v, _x.dtype)
                written.append(new_l)
                return k_full, v_full
        x = layer_forward(x, lp, cfg, cos, sin, mask=mask, attn_mask=attn_mask,
                          causal=causal, kv_update=kv_update)

    x = nn.rms_norm(p["norm"], x, cfg.rms_norm_eps)
    if cache is not None:
        cache = cache_fold(cache, written)._replace(offset=offset + t)
    if return_hidden:
        return x, cache
    if "lm_head" in params and not cfg.tie_word_embeddings:
        logits = nn.linear(params["lm_head"], x)
    else:
        logits = nn.embedding_as_linear(p["embed_tokens"], x)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits, cache


def make_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               valid_from: int = 0, kv_bits: int | None = None,
               kv_group_size: int = 64, quantized_kv_start: int = 0,
               device=None):
    """The decode cache for the ``kv_bits`` knobs (``kv_cache.make_cache_for``:
    dense, int8, int4 or hybrid). With a multi-token prefill and
    ``quantized_kv_start > 0``, pass ``quantized_kv_start=max(start,
    prefill_len)`` so the prefill lies in the dense prefix."""
    return kv_cache.make_cache_for(
        cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
        cfg.resolved_head_dim, max_len, dtype, kv_bits=kv_bits,
        kv_group_size=kv_group_size, quantized_kv_start=quantized_kv_start,
        device=device, valid_from=valid_from)


def sanitize(weights: dict, cfg: LlamaConfig) -> dict:
    """Drop rotary ``inv_freq`` buffers, and ``lm_head`` when the
    embeddings are tied."""
    return {k: v for k, v in weights.items()
            if "self_attn.rotary_emb.inv_freq" not in k
            and not (cfg.tie_word_embeddings and k == "lm_head.weight")}


def init_random_params(cfg: LlamaConfig, seed: int = 0, dtype=torch.bfloat16,
                       device=None, on_device: bool = False) -> dict:
    """Random params in HF layout (stacked layers), N(0, 0.02) weights and
    unit norms.

    ``on_device=False`` draws on the host with numpy's
    ``default_rng(seed)`` in the JAX package's order, so both packages get
    the same weights; ``on_device=True`` draws from a ``torch.Generator``
    on ``device`` (a 3B tree in seconds, never staged on the host)."""
    d, ffn, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = cfg.resolved_head_dim
    n = cfg.num_hidden_layers
    device = torch.device(device) if device is not None else torch.device("cpu")
    if on_device:
        gen = torch.Generator(device=device).manual_seed(seed)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=device, dtype=dtype) * 0.02
    else:
        rng = np.random.default_rng(seed)

        def rand(*shape):
            a = rng.standard_normal(shape, dtype=np.float32) * 0.02
            return torch.from_numpy(a).to(dtype).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    attn = {
        "q_proj": {"weight": rand(n, cfg.num_attention_heads * hd, d)},
        "k_proj": {"weight": rand(n, cfg.num_key_value_heads * hd, d)},
        "v_proj": {"weight": rand(n, cfg.num_key_value_heads * hd, d)},
        "o_proj": {"weight": rand(n, d, cfg.num_attention_heads * hd)},
    }
    if cfg.qk_norm:
        attn["q_norm"] = {"weight": ones(n, hd)}
        attn["k_norm"] = {"weight": ones(n, hd)}
    layers = {
        "input_layernorm": {"weight": ones(n, d)},
        "self_attn": attn,
        "post_attention_layernorm": {"weight": ones(n, d)},
        "mlp": {
            "gate_proj": {"weight": rand(n, ffn, d)},
            "up_proj": {"weight": rand(n, ffn, d)},
            "down_proj": {"weight": rand(n, d, ffn)},
        },
    }
    params = {"model": {"embed_tokens": {"weight": rand(v, d)}, "layers": layers,
                        "norm": {"weight": ones(d)}}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": rand(v, d)}
    return params
