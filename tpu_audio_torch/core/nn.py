"""Functional layers over parameter dicts (port of tpu_audio.core.nn).

Weights keep the checkpoint (torch) layout: Linear ``weight [out, in]``,
Conv1d ``weight [out, in, k]``, Conv2d ``weight [out, in, kh, kw]``.
Activations are channels-last (``[batch, length, channels]``, ``[batch,
height, width, channels]``), as in the JAX package, so the two compare
like with like.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from tpu_audio_torch.core import quant

__all__ = ["linear", "embedding", "embedding_as_linear", "layer_norm",
           "rms_norm", "group_norm", "batch_norm", "lstm_cell", "lstm", "gru", "conv1d", "conv2d",
           "conv_transpose1d", "gelu", "silu", "snake", "rope_freqs",
           "apply_rope", "sdpa", "f32_convolutions"]


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b``; an :class:`quant.Int8Tensor` weight runs the
    w8a8 product, a :class:`quant.QuantizedTensor` the MLX grouped-affine
    one."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        y = quant.int8_matmul(x, w)
    elif isinstance(w, quant.QuantizedTensor):
        y = quant.quantized_matmul_qt(x, w).to(x.dtype)
    else:
        y = x @ w.to(x.dtype).t()
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def embedding(p: dict, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Token embedding lookup; int8 and MLX-packed tables dequantize only
    the gathered rows, to ``dtype`` (f32 by default, as in the JAX package:
    a model whose embedding is packed then runs its residual stream in
    f32)."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        flat = ids.reshape(-1)
        d = w.weight[flat].to(dtype) * w.scale[flat][:, None].to(dtype)
        return d.reshape(*ids.shape, d.shape[-1])
    if isinstance(w, quant.QuantizedTensor):
        flat = ids.reshape(-1)
        d = w.map(lambda t: t[flat]).dequantize(dtype)
        return d.reshape(*ids.shape, d.shape[-1])
    return w[ids]


def embedding_as_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding output head: ``x @ E.T``."""
    w = p["weight"]
    if isinstance(w, quant.Int8Tensor):
        return quant.int8_matmul(x, w)
    if isinstance(w, quant.QuantizedTensor):
        return quant.quantized_matmul_qt(x, w).to(x.dtype)
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


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, returned in ``x.dtype``."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["weight"].to(torch.float32)).to(x.dtype)


def group_norm(p: dict | None, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over channels-last ``[B, ..., C]`` (statistics over the
    positions and the channels of each group), computed in f32, returned
    in ``x.dtype``."""
    *lead, c = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, c // num_groups)
    axes = tuple(range(1, len(lead))) + (len(lead) + 1,)
    mean = xf.mean(dim=axes, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(*lead, c)
    if p is not None:
        if "weight" in p:
            y = y * p["weight"].to(torch.float32)
        if "bias" in p:
            y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def batch_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over channels-last ``[..., C]`` (running
    statistics), computed in f32, returned in ``x.dtype``."""
    mean = p["running_mean"].to(torch.float32)
    var = p["running_var"].to(torch.float32)
    y = (x.to(torch.float32) - mean) * torch.rsqrt(var + eps)
    if "weight" in p:
        y = y * p["weight"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM step in torch gate order (i, f, g, o): ``x [B, I]``, ``h``
    and ``c [B, H]`` -> ``(h, c)``. Reads ``weight_ih``/``weight_hh``/
    ``bias_ih``/``bias_hh`` or their ``_l0`` forms; the products run in
    ``x.dtype`` (``h`` is cast to it) and the two biases are summed in their
    own dtype first."""
    w_ih = p["weight_ih_l0"] if "weight_ih_l0" in p else p["weight_ih"]
    w_hh = p["weight_hh_l0"] if "weight_hh_l0" in p else p["weight_hh"]
    gates = x @ w_ih.t().to(x.dtype) + h.to(x.dtype) @ w_hh.t().to(x.dtype)
    b_ih = p.get("bias_ih_l0", p.get("bias_ih"))
    b_hh = p.get("bias_hh_l0", p.get("bias_hh"))
    if b_ih is not None:
        gates = gates + (b_ih if b_hh is None else b_ih + b_hh).to(x.dtype)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None,
         c0: torch.Tensor | None = None):
    """Single-layer LSTM over ``[B, T, I]`` in torch gate order, the names
    :func:`lstm_cell` reads -> ``(outputs [B, T, H], (h, c))``. The input
    projection of every step is one product hoisted out of the recurrence
    (as in the JAX package, whose bias is summed into it); an MLX LSTM's
    single ``bias_ih`` is the sum of the two. ``h0`` and ``c0`` default to
    zeros."""
    w_ih = p["weight_ih_l0"] if "weight_ih_l0" in p else p["weight_ih"]
    w_hh = p["weight_hh_l0"] if "weight_hh_l0" in p else p["weight_hh"]
    b_ih = p.get("bias_ih_l0", p.get("bias_ih"))
    b_hh = p.get("bias_hh_l0", p.get("bias_hh"))
    x_proj = x @ w_ih.t().to(x.dtype)  # [B, T, 4H]
    if b_ih is not None:
        x_proj = x_proj + (b_ih if b_hh is None else b_ih + b_hh).to(x.dtype)
    bsz, hidden = x.shape[0], w_hh.shape[1]
    h = h0 if h0 is not None else x.new_zeros((bsz, hidden))
    c = c0 if c0 is not None else x.new_zeros((bsz, hidden))
    w_hh_t = w_hh.t().to(x.dtype)
    ys = []
    for t in range(x.shape[1]):
        gates = torch.addmm(x_proj[:, t], h, w_hh_t)
        s = torch.sigmoid(gates)
        i, f, o = s[:, :hidden], s[:, hidden:2 * hidden], s[:, 3 * hidden:]
        c = torch.addcmul(f * c, i, torch.tanh(gates[:, 2 * hidden:3 * hidden]))
        h = o * torch.tanh(c)
        ys.append(h)
    out = torch.stack(ys, 1) if ys else x_proj.new_zeros((bsz, 0, hidden))
    return out, (h, c)


def gru(p: dict, x: torch.Tensor, h0: torch.Tensor | None = None):
    """Single-layer GRU over ``[B, T, I]`` in torch gate order (r, z, n),
    with ``b_hh`` inside the reset gate's product, ``n = tanh(W_in x + b_in
    + r * (W_hn h + b_hn))``; reads ``weight_ih``/``weight_hh``/``bias_ih``/
    ``bias_hh`` or their ``_l0`` forms -> ``(outputs [B, T, H], h)``. As in
    :func:`lstm`, the input projection of every step is one product hoisted
    out of the recurrence, then one ``addmm`` a step. ``h0`` defaults to
    zeros."""
    w_ih = p["weight_ih_l0"] if "weight_ih_l0" in p else p["weight_ih"]
    w_hh = p["weight_hh_l0"] if "weight_hh_l0" in p else p["weight_hh"]
    b_ih = p.get("bias_ih_l0", p.get("bias_ih"))
    b_hh = p.get("bias_hh_l0", p.get("bias_hh"))
    x_proj = x @ w_ih.t().to(x.dtype)  # [B, T, 3H]
    if b_ih is not None:
        x_proj = x_proj + b_ih.to(x.dtype)
    bsz, hidden = x.shape[0], w_hh.shape[1]
    h = h0.to(x.dtype) if h0 is not None else x.new_zeros((bsz, hidden))
    w_hh_t = w_hh.t().to(x.dtype)
    b_hh = b_hh.to(x.dtype) if b_hh is not None else x.new_zeros((3 * hidden,))
    ys = []
    for t in range(x.shape[1]):
        xt = x_proj[:, t]
        hp = torch.addmm(b_hh, h, w_hh_t)
        rz = torch.sigmoid(xt[:, :2 * hidden] + hp[:, :2 * hidden])
        r, z = rz[:, :hidden], rz[:, hidden:]
        n = torch.tanh(torch.addcmul(xt[:, 2 * hidden:], r, hp[:, 2 * hidden:]))
        h = torch.lerp(n, h, z)  # (1 - z) * n + z * h
        ys.append(h)
    if len(ys) == 1:  # one step (a streaming hop): a view, no copy
        return h[:, None], h
    out = torch.stack(ys, 1) if ys else x_proj.new_zeros((bsz, 0, hidden))
    return out, h


@contextlib.contextmanager
def f32_convolutions():
    """cuDNN convolutions in full f32 inside the block (PyTorch runs them
    in TF32 by default, ~1e-3 from the f32 reference); the other cuDNN flags
    stay as they are, and all are restored on exit."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def conv1d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1D conv on channels-last ``[B, L, C_in]`` with ``weight [O, I/g, K]``."""
    y = F.conv1d(x.transpose(1, 2), p["weight"].to(x.dtype), stride=stride,
                 padding=padding, dilation=dilation, groups=groups).transpose(1, 2)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def conv2d(p: dict, x: torch.Tensor, stride=(1, 1), padding=(0, 0),
           dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """2D conv on channels-last ``[B, H, W, C_in]`` with ``weight [O, I/g,
    Kh, Kw]``; ``stride``, ``padding`` and ``dilation`` are ints or pairs."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["weight"].to(x.dtype), stride=stride,
                 padding=padding, dilation=dilation, groups=groups).permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def conv_transpose1d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 0,
                     output_padding: int = 0, groups: int = 1) -> torch.Tensor:
    """1D transposed conv on channels-last ``[B, L, C_in]`` with
    ``weight [I, O/g, K]`` (output length ``(L-1)*stride - 2*padding + K +
    output_padding``)."""
    y = F.conv_transpose1d(x.transpose(1, 2), p["weight"].to(x.dtype),
                           stride=stride, padding=padding,
                           output_padding=output_padding, groups=groups)
    y = y.transpose(1, 2)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """Exact (erf) GELU, or the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def snake(x: torch.Tensor, alpha: torch.Tensor, logscale: bool = False) -> torch.Tensor:
    """Snake activation ``x + sin(a x)^2 / (a + 1e-9)``."""
    a = torch.exp(alpha) if logscale else alpha
    a = a.to(x.dtype)
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def rope_freqs(head_dim: int, base: float = 10000.0,
               llama3_scaling: dict | None = None, device=None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim/2]`` f32, with optional Llama-3 NTK
    scaling (``factor``, ``low_freq_factor``, ``high_freq_factor``,
    ``original_max_position_embeddings``)."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    if llama3_scaling:
        factor = llama3_scaling.get("factor", 8.0)
        low_factor = llama3_scaling.get("low_freq_factor", 1.0)
        high_factor = llama3_scaling.get("high_freq_factor", 4.0)
        old_len = llama3_scaling.get("original_max_position_embeddings", 8192)
        low_wl = old_len / low_factor
        high_wl = old_len / high_factor
        wl = 2 * math.pi / inv
        smooth = (old_len / wl - low_factor) / (high_factor - low_factor)
        return torch.where(
            wl < high_wl, inv,
            torch.where(wl > low_wl, inv / factor,
                        (1 - smooth) * inv / factor + smooth * inv))
    return inv


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Rotate ``x [B, H, S, D]`` by cos/sin ``[S, D/2]`` (f32 math, result
    in ``x.dtype``). ``interleaved=False`` is the HF/Llama half split,
    ``True`` the GPT-NeoX pairing."""
    xf = x.to(torch.float32)
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None, is_causal: bool = False,
         scale: float | None = None) -> torch.Tensor:
    """Attention over ``[B, H, S, D]`` (K/V may have fewer heads: grouped
    query attention, query head ``h`` reading K/V head ``h // (H / H_kv)``):
    f32 scores and softmax, probabilities cast back to ``q.dtype`` before
    the value product. A boolean ``mask`` keeps the positions where it is
    True and sets the others to -1e9 (finite, so fully masked rows stay
    finite); a float ``mask`` is added to the scores."""
    b, n_heads, s_q, d = q.shape
    n_kv = k.shape[1]
    if n_kv != n_heads:
        rep = n_heads // n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    if is_causal:
        s_q, s_k = q.shape[2], k.shape[2]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~causal, -1e9)
    if mask is not None and mask.dtype == torch.bool:
        scores = scores.masked_fill(~mask, -1e9)
    elif mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return probs @ v.to(q.dtype)
