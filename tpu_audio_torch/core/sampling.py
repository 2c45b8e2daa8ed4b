"""Token sampling on the device: temperature / top-k / top-p / min-p /
repetition penalty (port of the parts of tpu_audio.core.sampling that the
serving engines call), plus :func:`gumbel_noise`, the port's
counter-based random numbers, and :func:`sample_keyed`, the engines'
draw from them.

Everything here is tensor code over ``[rows, V]`` logits: nothing reads a
device value on the host. The JAX package draws with threefry keys; the
port hashes (engine seed, request seed, sample index, vocab id) into a
uniform and samples by Gumbel-max. Both make a sampled token a function
of the request alone, but their bits differ: only greedy tokens can equal
the JAX package's, sampled ones are held to their distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SamplingParams", "apply_repetition_penalty", "gumbel_noise", "sample_keyed"]


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    repetition_context_size: int = 64


def apply_repetition_penalty(logits: torch.Tensor, token_history: torch.Tensor,
                             history_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Divide positive / multiply negative logits of recently generated
    tokens (CTRL-style; mirrors mlx_lm's repetition processor).

    ``logits``: [B, V]; ``token_history``: [B, C] int ring of recent
    tokens; ``history_mask``: [B, C] bool of valid entries.
    """
    if penalty == 1.0:
        return logits
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, token_history.long(), history_mask.to(torch.int32))
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(hits > 0, penalized, logits)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, -torch.inf)


# Nucleus filtering only needs the head of the distribution: take the top
# TOP_P_PREFILTER logits and sort only those (the JAX package's default).
TOP_P_PREFILTER = 512


def _mask_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering. Keeps the smallest set of tokens whose cumulative
    probability exceeds ``top_p`` (always keeps the argmax)."""
    k = min(TOP_P_PREFILTER, logits.shape[-1])
    top_vals = torch.topk(logits, k, dim=-1, sorted=True).values  # descending
    probs = torch.softmax(top_vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # mask tokens whose *preceding* cumulative mass already exceeds top_p
    exceeded = (cum - probs) > top_p
    cutoff = torch.where(exceeded, torch.inf, top_vals).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < cutoff, -torch.inf)


def _mask_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    top = probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < min_p * top, -torch.inf)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) (an int64 tensor or a
    Python int) and ``c < 2**32``, in 16-bit halves so that no int64
    product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer hash (lowbias32) of int64 tensors or Python ints."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: int, request_seeds: torch.Tensor,
                 sample_index: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``[n, vocab]`` f32: entry ``[r, v]`` hashes
    (``seed``, ``request_seeds[r]``, ``sample_index[r]``, ``v``) into a
    uniform in (0, 1) with 24 bits, then ``-log(-log(u))``.
    ``argmax(logits / T + noise)`` draws from ``softmax(logits / T)``, and
    the draw depends on the request's seed and sample index only: not on
    its lane or on the other requests."""
    dev = request_seeds.device
    h = _mix32(request_seeds.long() & _M32 ^ _mix32(seed & _M32))  # int seed: host
    h = _mix32(h ^ _mix32((sample_index.long() + 0x9E3779B9) & _M32))
    vid = _mix32(torch.arange(vocab, device=dev) + 0x632BE5AB)
    h = _mix32(h[:, None] ^ vid[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_keyed(logits: torch.Tensor, seed: int, request_seeds: torch.Tensor,
                 sample_index: torch.Tensor, s: SamplingParams) -> torch.Tensor:
    """Sample one token from each row of ``logits [n, V]`` (each row on its
    own; the JAX package vmaps this over rows). Greedy is the argmax;
    otherwise top-k, top-p and min-p masks, then Gumbel-max at the
    temperature with the request's own noise (:func:`gumbel_noise`). The
    repetition penalty is applied by the caller."""
    if s.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    masked = logits
    if s.top_k and s.top_k > 0:
        masked = _mask_top_k(masked, s.top_k)
    if s.top_p < 1.0:
        masked = _mask_top_p(masked, s.top_p)
    if s.min_p > 0.0:
        masked = _mask_min_p(masked, s.min_p)
    noise = gumbel_noise(seed, request_seeds, sample_index, logits.shape[-1])
    return torch.argmax(masked / s.temperature + noise, dim=-1)
