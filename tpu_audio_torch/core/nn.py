"""Functional layers over parameter dicts (port of tpu_audio.core.nn).

Weights keep the checkpoint (torch) layout: Linear ``weight [out, in]``,
Conv1d ``weight [out, in, k]``. Activations are channels-last
``[batch, length, channels]``, as in the JAX package, so the two compare
like with like.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tpu_audio_torch.core import quant

__all__ = ["linear", "embedding", "embedding_as_linear", "layer_norm",
           "conv1d", "gelu", "sdpa"]


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b``; an :class:`quant.Int8Tensor` weight runs the
    w8a8 product."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        y = quant.int8_matmul(x, w)
    else:
        y = x @ w.to(x.dtype).t()
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def embedding(p: dict, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Token embedding lookup; int8 tables dequantize only the gathered
    rows (to ``dtype``)."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        flat = ids.reshape(-1)
        d = w.weight[flat].to(dtype) * w.scale[flat][:, None].to(dtype)
        return d.reshape(*ids.shape, d.shape[-1])
    return w[ids]


def embedding_as_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head: ``x @ E.T``."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        return quant.int8_matmul(x, w)
    return x @ w.to(x.dtype).t()


def layer_norm(p: dict | None, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32, returned in ``x.dtype``."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None:
        if "weight" in p:
            y = y * p["weight"].to(torch.float32)
        if "bias" in p:
            y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """1D conv on channels-last ``[B, L, C_in]`` with ``weight [O, I, K]``."""
    y = F.conv1d(x.transpose(1, 2), p["weight"].to(x.dtype), stride=stride,
                 padding=padding).transpose(1, 2)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """Exact (erf) GELU, or the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None, is_causal: bool = False) -> torch.Tensor:
    """Attention over ``[B, H, S, D]``: f32 scores and softmax, masked
    positions set to -1e9 (finite, so fully masked rows stay finite),
    probabilities cast back to ``q.dtype`` before the value product."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if is_causal:
        s_q, s_k = q.shape[2], k.shape[2]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~causal, -1e9)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return probs @ v.to(q.dtype)
