"""Preallocated KV caches for the token-by-token decode loops (port of
tpu_audio.core.kv_cache).

Caches are fixed-capacity ``[L, B, H, S_max, D]`` buffers updated in
place at an explicit ``offset`` (the JAX package returns updated copies;
writing in place saves a cache-sized copy a step). The
``kv_bits``/``kv_group_size``/``quantized_kv_start`` knobs choose the
storage, as in the JAX package:

- ``kv_bits=8``: symmetric int8 codes and a scale a group of head-dim
  features (:class:`QuantKVCache`); the int8 cross-attention kernel
  (``ops.kv_attention``) reads the same codes;
- ``kv_bits=4``: affine codes in [0, 15] with a scale and a bias a group,
  two codes a ``uint8`` along the head dim;
- ``0 < quantized_kv_start < S_max``: :class:`HybridKVCache`, positions
  below the split dense, the rest quantized.

A layer's step writes its new rows, then dequantizes the layer's whole
capacity and attends to it, in the JAX package's order: a prefill into a
quantized cache attends to its own quantized rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_audio_torch.core.generation import validate_kv_bits

__all__ = ["KVCache", "QuantKVCache", "HybridKVCache", "FusedLaneRow", "init_cache",
           "init_quant_cache", "init_hybrid_cache", "make_cache_for", "attention_mask",
           "make_layer_updater", "update_cache", "_quantize", "_dequantize"]


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


class QuantKVCache(NamedTuple):
    """Quantized KV cache. 8-bit: ``k_q``/``v_q`` int8 [L, B, H, S_max, D]
    symmetric codes (biases zero). 4-bit: ``k_q``/``v_q`` uint8
    [L, B, H, S_max, D/2], two affine codes a byte. ``k_scale``/``k_bias``
    etc.: [L, B, H, S_max, D/g]. The code dtype carries the width."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    k_bias: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor
    v_bias: torch.Tensor
    offset: int
    valid_from: int = 0

    @property
    def max_len(self) -> int:
        return self.k_q.shape[3]

    @property
    def bits(self) -> int:
        return 4 if self.k_q.dtype == torch.uint8 else 8

    @property
    def head_dim(self) -> int:
        return self.k_q.shape[-1] * (2 if self.bits == 4 else 1)

    @property
    def group_size(self) -> int:
        return self.head_dim // self.k_scale.shape[-1]

    @property
    def n_groups(self) -> int:
        return self.k_scale.shape[-1]


class HybridKVCache(NamedTuple):
    """Dense prefix and quantized tail: ``k``/``v`` [L, B, H, split, D]
    hold positions [0, split) as they are, the quantized planes (as in
    :class:`QuantKVCache`) positions [split, S_max). A multi-token write
    must lie wholly in the dense prefix; one-token writes go on either
    side."""

    k: torch.Tensor
    v: torch.Tensor
    k_q: torch.Tensor
    k_scale: torch.Tensor
    k_bias: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor
    v_bias: torch.Tensor
    offset: int
    valid_from: int = 0

    @property
    def split(self) -> int:
        return self.k.shape[3]

    @property
    def max_len(self) -> int:
        return self.k.shape[3] + self.k_q.shape[3]

    @property
    def bits(self) -> int:
        return 4 if self.k_q.dtype == torch.uint8 else 8

    @property
    def head_dim(self) -> int:
        return self.k.shape[-1]

    @property
    def n_groups(self) -> int:
        return self.k_scale.shape[-1]


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


def init_quant_cache(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
                     max_len: int, group_size: int = 64, scale_dtype=torch.float32,
                     valid_from: int = 0, bits: int = 8, device=None) -> QuantKVCache:
    """Quantized variant of :func:`init_cache`."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    group_size = min(group_size, head_dim)
    if bits == 4 and head_dim % 2:
        raise ValueError("4-bit KV packing requires an even head dim")
    code_dim = head_dim // 2 if bits == 4 else head_dim
    code_dtype = torch.uint8 if bits == 4 else torch.int8
    shape = (n_layers, batch, n_kv_heads, max_len, code_dim)
    s_shape = shape[:-1] + (head_dim // group_size,)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return QuantKVCache(zeros(shape, code_dtype), zeros(s_shape, scale_dtype),
                        zeros(s_shape, scale_dtype), zeros(shape, code_dtype),
                        zeros(s_shape, scale_dtype), zeros(s_shape, scale_dtype), 0,
                        int(valid_from))


def init_hybrid_cache(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
                      max_len: int, split: int, group_size: int = 64,
                      dtype=torch.bfloat16, scale_dtype=torch.float32,
                      valid_from: int = 0, bits: int = 8, device=None) -> HybridKVCache:
    """Dense-until-``split`` cache; ``0 < split < max_len`` (the ends are
    :func:`init_quant_cache` and :func:`init_cache`)."""
    if not 0 < split < max_len:
        raise ValueError(f"split={split} must be in (0, {max_len})")
    dense = init_cache(n_layers, batch, n_kv_heads, head_dim, split, dtype, device)
    quant = init_quant_cache(n_layers, batch, n_kv_heads, head_dim, max_len - split,
                             group_size, scale_dtype, bits=bits, device=device)
    return HybridKVCache(dense.k, dense.v, *quant[:6], 0, int(valid_from))


def _divisor(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor on ``x``'s device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, by a device
    tensor it divides, as the CPU and eager JAX do; so the codes are the
    same on every device."""
    return x.new_full((), value)


def _quantize(x: torch.Tensor, n_groups: int, bits: int = 8):
    """[..., T, D] -> (codes, scales f32 [..., T, G], biases f32 [..., T, G])
    over groups of D/G features, codes rounded half to even from true
    divisions on every device. 8-bit: symmetric int8 codes, ``scale = max(max|x|, 1e-8) /
    127``, biases zero. 4-bit: affine ``x = scale * q + bias`` with q in
    [0, 15], ``scale = max(max - min, 1e-8) / 15``, ``bias = min``, two
    codes a uint8 (even index in the low nibble)."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    grouped = x.to(torch.float32).reshape(*lead, n_groups, d // n_groups)
    if bits == 8:
        scale = torch.clamp(grouped.abs().amax(-1), min=1e-8) / _divisor(grouped, 127.0)
        q = torch.clamp(torch.round(grouped / scale[..., None]), -127, 127)
        return q.reshape(*lead, d).to(torch.int8), scale, torch.zeros_like(scale)
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    mn = grouped.amin(-1)
    mx = grouped.amax(-1)
    scale = torch.clamp(mx - mn, min=1e-8) / _divisor(grouped, 15.0)
    q = torch.clamp(torch.round((grouped - mn[..., None]) / scale[..., None]),
                    0, 15).to(torch.uint8).reshape(*lead, d)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale, mn


def _dequantize(q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dtype) -> torch.Tensor:
    """Inverse of :func:`_quantize`; dispatches on the code dtype."""
    lead = q.shape[:-1]
    if q.dtype == torch.uint8:  # packed 4-bit
        x = torch.stack([(q & 0xF).to(torch.float32), (q >> 4).to(torch.float32)],
                        dim=-1).reshape(*lead, 2 * q.shape[-1])
    else:
        x = q.to(torch.float32)
    g = scale.shape[-1]
    d = x.shape[-1]
    grouped = x.reshape(*lead, g, d // g)
    out = grouped * scale[..., None].float() + bias[..., None].float()
    return out.reshape(*lead, d).to(dtype)


def make_cache_for(n_layers: int, batch: int, n_kv_heads: int, head_dim: int,
                   max_len: int, dtype=torch.bfloat16,
                   kv_bits: int | None = None, kv_group_size: int = 64,
                   quantized_kv_start: int = 0, device=None, valid_from: int = 0):
    """The cache for the ``kv_bits``/``kv_group_size``/``quantized_kv_start``
    knobs: dense without ``kv_bits``; else quantized for a start <= 0,
    dense for a start >= ``max_len``, hybrid (split at the start) between."""
    validate_kv_bits(kv_bits)
    start = int(quantized_kv_start)
    if kv_bits is None or start >= max_len:
        return init_cache(n_layers, batch, n_kv_heads, head_dim, max_len, dtype, device,
                          valid_from)
    if start <= 0:
        return init_quant_cache(n_layers, batch, n_kv_heads, head_dim, max_len,
                                kv_group_size, valid_from=valid_from, bits=kv_bits,
                                device=device)
    return init_hybrid_cache(n_layers, batch, n_kv_heads, head_dim, max_len, start,
                             kv_group_size, dtype, valid_from=valid_from, bits=kv_bits,
                             device=device)


def attention_mask(cache, q_len: int) -> torch.Tensor:
    """Boolean mask ``[1, 1, q_len, S_max]``: causal over the new
    positions, allowing the cached positions from ``valid_from`` on."""
    device = cache[0].device  # k of a dense or hybrid cache, k_q of a quantized one
    key_pos = torch.arange(cache.max_len, device=device)
    query_pos = cache.offset + torch.arange(q_len, device=device)
    causal = key_pos[None, :] <= query_pos[:, None]
    return (causal & (key_pos[None, :] >= cache.valid_from))[None, None]


def _write_dense(k_c, v_c, offset, k_new, v_new) -> None:
    t = k_new.shape[2]
    k_c[:, :, offset:offset + t] = k_new.to(k_c.dtype)
    v_c[:, :, offset:offset + t] = v_new.to(v_c.dtype)


def _write_quant_layer(cache_l, offset, k_new, v_new, n_groups: int, bits: int) -> None:
    """Quantize K/V ``[B, H, T, D]`` and write them at ``offset`` into one
    layer's ``(k_q, k_s, k_b, v_q, v_s, v_b)``, in place."""
    t = k_new.shape[2]
    for planes, new in ((cache_l[:3], k_new), (cache_l[3:], v_new)):
        for plane, part in zip(planes, _quantize(new, n_groups, bits)):
            plane[:, :, offset:offset + t] = part.to(plane.dtype)


def _dequantize_layer(planes, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    return _dequantize(*planes[:3], dtype), _dequantize(*planes[3:], dtype)


def make_layer_updater(cache):
    """Per-layer cache plumbing for a stacked-layer forward, for every
    cache type. Returns ``(xs, update, fold)``: ``xs`` the per-layer views
    of the cache's planes, ``update(cache_l, offset, k_new, v_new, dtype)
    -> (cache_l, k_full, v_full)`` writing ``k_new/v_new [B, H, T, D]`` at
    ``offset`` in place and returning the layer's full-capacity K/V in
    ``dtype`` for attention (a quantized part dequantized), ``fold(cache,
    ys) -> cache``. All None without a cache."""
    if cache is None:
        return None, None, None

    def fold(cache, ys):
        return cache

    if isinstance(cache, KVCache):
        def update(cache_l, offset, k_new, v_new, dtype):
            _write_dense(*cache_l, offset, k_new, v_new)
            return cache_l, cache_l[0].to(dtype), cache_l[1].to(dtype)

        return list(zip(cache.k, cache.v)), update, fold

    if isinstance(cache, QuantKVCache):
        bits, n_groups = cache.bits, cache.n_groups

        def update(cache_l, offset, k_new, v_new, dtype):
            _write_quant_layer(cache_l, offset, k_new, v_new, n_groups, bits)
            return (cache_l, *_dequantize_layer(cache_l, dtype))

        return list(zip(*cache[:6])), update, fold

    if isinstance(cache, HybridKVCache):
        bits, n_groups, split = cache.bits, cache.n_groups, cache.split

        def update(cache_l, offset, k_new, v_new, dtype):
            t = k_new.shape[2]
            if t > 1:
                # a multi-token write (a prefill) goes to the dense prefix
                if t > split:
                    raise ValueError(
                        f"hybrid KV prefill of {t} tokens exceeds the dense "
                        f"prefix ({split}); pass quantized_kv_start >= the "
                        "prefill length")
                if offset + t > split:
                    # the JAX package clamps this write into the prefix
                    raise ValueError(
                        f"hybrid KV write of {t} tokens at offset {offset} crosses the "
                        f"split ({split}): a multi-token write must lie in the dense prefix")
                _write_dense(*cache_l[:2], offset, k_new, v_new)
            elif offset < split:
                _write_dense(*cache_l[:2], offset, k_new, v_new)
            else:
                _write_quant_layer(cache_l[2:], offset - split, k_new, v_new, n_groups, bits)
            kq, vq = _dequantize_layer(cache_l[2:], dtype)
            return (cache_l, torch.cat([cache_l[0].to(dtype), kq], dim=2),
                    torch.cat([cache_l[1].to(dtype), vq], dim=2))

        return list(zip(*cache[:8])), update, fold

    raise TypeError(f"unknown cache type {type(cache).__name__}")


def update_cache(cache, layer: int, k_new: torch.Tensor, v_new: torch.Tensor):
    """Write ``k_new/v_new [B, H, T, D]`` at the current offset of
    ``layer`` (in place), for every cache type. Returns the cache and the
    layer's full-capacity K/V views in ``k_new``'s dtype; the caller
    advances the offset once per step."""
    xs, update, _ = make_layer_updater(cache)
    _, k, v = update(xs[layer], cache.offset, k_new, v_new, k_new.dtype)
    return cache, k, v
