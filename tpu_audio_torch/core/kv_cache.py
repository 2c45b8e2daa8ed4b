"""Preallocated KV caches for the token-by-token decode loops (port of the
dense and int8 parts of tpu_audio.core.kv_cache).

Caches are fixed-capacity ``[L, B, H, S_max, D]`` buffers updated in
place at an explicit ``offset``. The int8 code scheme of
:func:`_quantize` (symmetric, per-position head-dim groups) is the one
the int8 cross-attention kernel (``ops.kv_attention``) reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_audio_torch.core.generation import validate_kv_bits

__all__ = ["KVCache", "FusedLaneRow", "init_cache", "make_cache_for",
           "attention_mask", "_quantize", "_dequantize"]


class KVCache(NamedTuple):
    """Stacked-layer dense KV cache. ``k``/``v``: [L, B, H, S_max, D];
    ``offset``: number of written positions."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int

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
    ``offset`` and ``valid_from`` ``[slots]`` int64 tensors on the device."""

    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    valid_from: torch.Tensor


def init_cache(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
               max_len: int, dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


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
                   quantized_kv_start: int = 0, device=None) -> KVCache:
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
                      device)


def attention_mask(cache: KVCache, q_len: int) -> torch.Tensor:
    """Boolean mask ``[1, 1, q_len, S_max]``: causal over the new
    positions, allowing every cached position."""
    device = cache.k.device
    key_pos = torch.arange(cache.max_len, device=device)
    query_pos = cache.offset + torch.arange(q_len, device=device)
    return (key_pos[None, :] <= query_pos[:, None])[None, None]
