"""Preallocated KV caches for the token-by-token decode loops (port of the
dense and int8 parts of tpu_audio.core.kv_cache).

Caches are fixed-capacity ``[L, B, H, S_max, D]`` buffers updated in
place at an explicit ``offset`` (the JAX package returns updated copies;
writing in place saves a cache-sized copy a step). The int8 code scheme of
:func:`_quantize` (symmetric, per-position head-dim groups) is the one
the int8 cross-attention kernel (``ops.kv_attention``) reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_audio_torch.core.generation import validate_kv_bits

__all__ = ["KVCache", "FusedLaneRow", "init_cache", "make_cache_for",
           "attention_mask", "make_layer_updater", "update_cache",
           "_quantize", "_dequantize"]


class KVCache(NamedTuple):
    """Stacked-layer dense KV cache. ``k``/``v``: [L, B, H, S_max, D];
    ``offset``: number of written positions; ``valid_from``: first
    attendable position (the positions below it are left padding from
    prompt bucketing and stay masked)."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int
    valid_from: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


class FusedLaneRow(NamedTuple):
    """A serving lane's self-attention cache in the fused decoder's layout
    (port of tpu_audio.core.kv_cache.FusedLaneRow): ``k``/``v``
    ``[L, S_max, d]`` bf16 position-major, ``offset`` (rows written, the
    next write position) and ``valid_from`` (first valid row; whisper
    prompts are never left-padded, so 0). A serving engine holds its lanes
    stacked on a leading slot axis: ``k``/``v`` ``[slots, L, S_max, d]``,
    ``offset`` and ``valid_from`` ``[slots]`` int64 tensors on the device.
    The plain llama serving tick stacks head-major ``KVCache`` rows in the
    same tuple (``parallel.continuous.llama_lanes``)."""

    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    valid_from: torch.Tensor


def init_cache(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
               max_len: int, dtype=torch.bfloat16, device=None,
               valid_from: int = 0) -> KVCache:
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0,
                   int(valid_from))


def _quantize(x: torch.Tensor, n_groups: int, bits: int = 8):
    """[..., T, D] -> (codes int8 [..., T, D], scales f32 [..., T, G],
    biases f32 [..., T, G]): symmetric int8 per group of D/G features,
    ``scale = max(max|x|, 1e-8) / 127``, codes rounded half to even
    from a true division; biases are zero."""
    if bits != 8:
        raise NotImplementedError(
            f"kv_bits={bits}: packed int4 KV is not ported yet")
    d = x.shape[-1]
    lead = x.shape[:-1]
    grouped = x.to(torch.float32).reshape(*lead, n_groups, d // n_groups)
    scale = torch.clamp(grouped.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(grouped / scale[..., None]), -127, 127)
    return q.reshape(*lead, d).to(torch.int8), scale, torch.zeros_like(scale)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dtype) -> torch.Tensor:
    """Inverse of :func:`_quantize`."""
    lead = q.shape[:-1]
    g = scale.shape[-1]
    d = q.shape[-1]
    grouped = q.to(torch.float32).reshape(*lead, g, d // g)
    out = grouped * scale[..., None].float() + bias[..., None].float()
    return out.reshape(*lead, d).to(dtype)


def make_cache_for(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
                   max_len: int, dtype=torch.bfloat16,
                   kv_bits: int | None = None, kv_group_size: int = 64,
                   quantized_kv_start: int = 0, device=None,
                   valid_from: int = 0) -> KVCache:
    """Self-attention cache for the ``kv_bits``/``quantized_kv_start``
    knobs. Ported: dense (``kv_bits=None``) and a dense self cache beside
    int8 cross K/V (``kv_bits=8``, ``quantized_kv_start >= max_len``)."""
    validate_kv_bits(kv_bits)
    if kv_bits is not None and int(quantized_kv_start) < max_len:
        raise NotImplementedError(
            f"kv_bits={kv_bits} with quantized_kv_start={quantized_kv_start} "
            f"< {max_len}: int8/int4/hybrid self-attention caches are not "
            "ported yet; pass quantized_kv_start >= the decode length for a "
            "dense self cache with int8 cross K/V")
    return init_cache(n_layers, batch, n_kv_heads, head_dim, max_len, dtype,
                      device, valid_from)


def attention_mask(cache: KVCache, q_len: int) -> torch.Tensor:
    """Boolean mask ``[1, 1, q_len, S_max]``: causal over the new
    positions, allowing the cached positions from ``valid_from`` on."""
    device = cache.k.device
    key_pos = torch.arange(cache.max_len, device=device)
    query_pos = cache.offset + torch.arange(q_len, device=device)
    causal = key_pos[None, :] <= query_pos[:, None]
    return (causal & (key_pos[None, :] >= cache.valid_from))[None, None]


def make_layer_updater(cache: KVCache | None):
    """Per-layer cache plumbing for a stacked-layer forward (the dense
    part of the JAX package's helper). Returns ``(xs, update, fold)``:
    ``xs`` the per-layer ``(k, v)`` views, ``update(cache_l, offset, k_new,
    v_new, dtype) -> (cache_l, k_full, v_full)`` writing ``k_new/v_new
    [B, H, T, D]`` at ``offset`` in place and returning the full-capacity
    views for attention, ``fold(cache, ys) -> cache``. All None without a
    cache."""
    if cache is None:
        return None, None, None
    if not isinstance(cache, KVCache):
        raise NotImplementedError(
            f"{type(cache).__name__}: only the dense KV cache is ported")
    xs = list(zip(cache.k, cache.v))

    def update(cache_l, offset, k_new, v_new, dtype):
        k_c, v_c = cache_l
        t = k_new.shape[2]
        k_c[:, :, offset:offset + t] = k_new.to(k_c.dtype)
        v_c[:, :, offset:offset + t] = v_new.to(v_c.dtype)
        return cache_l, k_c.to(dtype), v_c.to(dtype)

    def fold(cache, ys):
        return cache

    return xs, update, fold


def update_cache(cache: KVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor):
    """Write ``k_new/v_new [B, H, T, D]`` at the current offset of
    ``layer`` (in place). Returns the cache and the layer's full-capacity
    K/V views; the caller advances the offset once per step."""
    _, update, _ = make_layer_updater(cache)
    _, k, v = update((cache.k[layer], cache.v[layer]), cache.offset, k_new,
                     v_new, k_new.dtype)
    return cache, k, v
