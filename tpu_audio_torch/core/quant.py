"""Quantized weights: per-channel int8 with dynamic int8 activations
(w8a8), and MLX grouped-affine 4/8-bit (port of tpu_audio.core.quant).

**w8a8** (``Int8Tensor``, ``quantize_int8``, ``int8_matmul``): the JAX
package leaves the product to XLA; here the CUDA product goes to
``torch._int_mm`` (s8 x s8 -> s32) and the CPU product to a float64
matmul, which is exact for int8 dots of any width this port meets
(|sum| < 2**53).

**MLX grouped affine** (``QuantizedTensor``), the layout of the
reference's 4/8-bit checkpoints: for a weight ``[O, I]`` with group size
``g`` and ``bits`` b,

- ``weight``: ``[O, I * b / 32]`` words, ``32 / b`` consecutive input
  elements a word, least significant bits first;
- ``scales``, ``biases``: ``[O, I / g]``;

and ``w[o, i] = scales[o, i // g] * q[o, i] + biases[o, i // g]``. The
words are uint32 in the checkpoint and in the JAX package; the port keeps
their bits in **int32** tensors (torch on the CPU has no shifts for
uint32), and unpacks with an arithmetic shift and a mask, which gives the
same codes. A product of at most 64 rows goes to ``ops.qmm.quantized_matvec``
(the CUDA kernel for CUDA tensors, its plain version on the CPU); a larger
one dequantizes the weight to the activations' dtype and multiplies, as
the JAX package does outside its Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Int8Tensor", "quantize_int8", "quantize_act_int8",
           "int8_matmul", "quantize_tree", "slice_rows",
           "QuantizedTensor", "quantize", "quantize_mlx", "dequantize",
           "dequantize_tree", "tag_quantized", "is_quantized",
           "quantized_matmul", "quantized_matmul_qt"]


class QuantizedTensor:
    """MLX grouped-affine weight: packed words (int32 bits of the uint32
    words) ``[..., O, I * bits / 32]``, ``scales`` and ``biases``
    ``[..., O, I / group_size]``, and the static ``group_size`` and
    ``bits``."""

    __slots__ = ("weight", "scales", "biases", "group_size", "bits")

    def __init__(self, weight: torch.Tensor, scales: torch.Tensor,
                 biases: torch.Tensor, group_size: int = 64, bits: int = 4):
        self.weight = weight
        self.scales = scales
        self.biases = biases
        self.group_size = int(group_size)
        self.bits = int(bits)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self.weight, self.scales, self.biases,
                          self.group_size, self.bits, dtype)

    def map(self, fn) -> "QuantizedTensor":
        """The same weight with ``fn`` applied to each of its tensors."""
        return QuantizedTensor(fn(self.weight), fn(self.scales), fn(self.biases),
                               self.group_size, self.bits)


class Int8Tensor:
    """Per-output-channel symmetric int8 weight: ``weight`` int8
    ``[..., O, I]``, ``scale`` f32 ``[..., O]``."""

    __slots__ = ("weight", "scale", "_mm_weight")

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        self.weight = weight
        self.scale = scale
        self._mm_weight = None

    def mm_weight(self) -> torch.Tensor:
        """The weight with its rows padded to a multiple of 8, as
        ``torch._int_mm`` requires on CUDA (cached: a vocab-sized head
        would otherwise be copied on every call)."""
        o = self.weight.shape[0]
        if o % 8 == 0:
            return self.weight
        if self._mm_weight is None:
            pad = torch.zeros((8 - o % 8, self.weight.shape[1]),
                              dtype=torch.int8, device=self.weight.device)
            self._mm_weight = torch.cat([self.weight, pad])
        return self._mm_weight


def quantize_int8(w: torch.Tensor) -> Int8Tensor:
    """Per-output-channel symmetric int8 quantization of ``w [..., O, I]``
    (``scale = max|w| / 127``; an all-zero row gets scale 1e-8)."""
    wf = w.to(torch.float32)
    scale = wf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127)
    return Int8Tensor(q.to(torch.int8), scale)


def quantize_act_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 quantization of ``x [R, I]``: codes int8 and
    scales f32 ``[R, 1]`` (``max(max|x|/127, 1e-12)``, round half to
    even)."""
    xf = x.to(torch.float32)
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _int_dot(xq: torch.Tensor, t: Int8Tensor) -> torch.Tensor:
    """Exact ``xq @ t.weight.T`` of int8 operands, as f32."""
    if xq.device.type == "cuda":
        rows = xq.shape[0]
        m = max(32, -(-rows // 8) * 8)  # _int_mm on CUDA: M > 16, M % 8 == 0
        if m != rows:
            xq = torch.cat([xq, xq.new_zeros((m - rows, xq.shape[1]))])
        acc = torch._int_mm(xq, t.mm_weight().t())
        return acc[:rows, : t.weight.shape[0]].to(torch.float32)
    return (xq.double() @ t.weight.double().t()).to(torch.float32)


def int8_matmul(x: torch.Tensor, t: Int8Tensor) -> torch.Tensor:
    """``x @ W.T`` with dynamic per-row int8 activation quantization and
    an int8 x int8 -> int32 product. Output dtype follows ``x``."""
    lead = x.shape[:-1]
    xq, xs = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    acc = _int_dot(xq, t)
    y = acc * (xs * t.scale[None, :])
    return y.reshape(*lead, t.weight.shape[0]).to(x.dtype)


def slice_rows(p: dict, rows) -> dict:
    """The output rows ``rows`` of a linear or head param dict
    (``{"weight": ...}``, dense, :class:`Int8Tensor` or
    :class:`QuantizedTensor`, optional ``bias``), keeping the packed
    layout: every per-output plane shares the leading O axis."""
    w = p["weight"]
    rows = torch.as_tensor(rows, dtype=torch.long, device=w.weight.device
                           if isinstance(w, (Int8Tensor, QuantizedTensor)) else w.device)
    if isinstance(w, Int8Tensor):
        out = {"weight": Int8Tensor(w.weight[rows], w.scale[rows])}
    elif isinstance(w, QuantizedTensor):
        out = {"weight": w.map(lambda t: t[rows])}
    else:
        out = {"weight": w[rows]}
    if "bias" in p:
        out["bias"] = p["bias"][rows]
    return out


def quantize_tree(params: dict, group_size: int = 64, bits: int = 4,
                  min_in_features: int = 256, scheme: str = "w8a8") -> dict:
    """Quantize every eligible 2-D (or stacked ``[L, O, I]`` under a
    ``layers`` container) float ``weight`` leaf of a param tree: to an
    :class:`Int8Tensor` (``scheme="w8a8"``; ``bits`` is ignored) or to an
    MLX grouped-affine :class:`QuantizedTensor` of ``bits`` and
    ``group_size`` (``scheme="mlx"``, the reference's post-load
    ``quantize(model:filter:)``). Norms, positions, convs, biases and small
    or ragged weights stay dense — the same eligibility rule as the JAX
    package, so both packages quantize the same leaves. Stacked leaves
    quantize a layer at a time, which bounds the f32 workspace."""
    if scheme not in ("w8a8", "mlx"):
        raise ValueError(f"quantize_tree: unknown scheme {scheme!r} (w8a8 or mlx)")

    def one(w):
        if scheme == "w8a8":
            return quantize_int8(w)
        return QuantizedTensor(*quantize_mlx(w, group_size, bits), group_size, bits)

    def walk(node, name="", in_layers=False):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            low = name.lower()
            if (k == "weight" and isinstance(v, torch.Tensor)
                    and "norm" not in low and not low.startswith("ln")
                    and "position" not in low and "pos_emb" not in low
                    and "conv" not in low
                    and v.is_floating_point()
                    and (v.ndim == 2 or (v.ndim == 3 and in_layers))
                    and v.shape[-1] % group_size == 0
                    and v.shape[-1] >= min_in_features):
                if v.ndim == 3:
                    parts = [one(v[i]) for i in range(v.shape[0])]
                    if scheme == "w8a8":
                        out[k] = Int8Tensor(torch.stack([p.weight for p in parts]),
                                            torch.stack([p.scale for p in parts]))
                    else:
                        out[k] = QuantizedTensor(
                            *(torch.stack([getattr(p, f) for p in parts])
                              for f in ("weight", "scales", "biases")), group_size, bits)
                else:
                    out[k] = one(v)
            else:
                out[k] = walk(v, k, in_layers or k == "layers")
        return out

    return walk(params)


# -- MLX grouped affine ---------------------------------------------------------


def _check_layout(in_features: int, group_size: int, bits: int) -> None:
    if bits not in (2, 4, 8):
        raise ValueError(f"MLX quantization: bits {bits} (2, 4 or 8)")
    if in_features % group_size or group_size % (32 // bits):
        raise ValueError(f"MLX quantization: {in_features} input features in groups "
                         f"of {group_size} at {bits} bits")


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """Words held as int64 in ``[0, 2**32)`` -> the int32 of the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def quantize_mlx(w: torch.Tensor, group_size: int = 64, bits: int = 4):
    """MLX-compatible grouped-affine quantizer on tensors (port of
    ``quantize_jax``): per group ``scale = (max - min) / (2**bits - 1)``
    (1e-8 where 0), ``bias = min``, codes ``round((w - min) / scale)``
    clipped to the levels (round half to even), computed in f32. Takes
    ``[O, I]`` or stacked ``[L, O, I]``; returns ``(words, scales,
    biases)``: int32 words of the same leading dims and f32 planes."""
    w = w.to(torch.float32)
    *lead, o, i = w.shape
    _check_layout(i, group_size, bits)
    n_levels = (1 << bits) - 1
    per_word = 32 // bits
    g = w.reshape(*lead, o, i // group_size, group_size)
    w_min = g.amin(-1)
    w_max = g.amax(-1)
    scales = (w_max - w_min) / n_levels
    scales = torch.where(scales == 0, torch.full_like(scales, 1e-8), scales)
    q = torch.clamp(torch.round((g - w_min[..., None]) / scales[..., None]), 0, n_levels)
    q = q.to(torch.int64).reshape(*lead, o, i // per_word, per_word)
    shifts = torch.arange(per_word, device=w.device, dtype=torch.int64) * bits
    # the codes occupy disjoint bits, so the sum is their bitwise or
    words = (q << shifts).sum(-1)
    return _to_int32_bits(words), scales, w_min


def quantize(w: np.ndarray, group_size: int = 64, bits: int = 4
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side MLX-compatible quantizer (port of the JAX package's numpy
    ``quantize``, for fixtures and tests): the scheme of
    :func:`quantize_mlx` on a 2-D numpy array; returns uint32 words, as a
    checkpoint stores them, and f32 scales and biases."""
    w = np.asarray(w, np.float32)
    out_features, in_features = w.shape
    _check_layout(in_features, group_size, bits)
    n_groups = in_features // group_size
    g = w.reshape(out_features, n_groups, group_size)
    w_min = g.min(axis=-1)
    w_max = g.max(axis=-1)
    n_levels = (1 << bits) - 1
    scales = (w_max - w_min) / n_levels
    scales = np.where(scales == 0, 1e-8, scales)
    q = np.clip(np.round((g - w_min[..., None]) / scales[..., None]), 0, n_levels)
    per_word = 32 // bits
    q = q.astype(np.uint32).reshape(out_features, in_features // per_word, per_word)
    shifts = (np.arange(per_word, dtype=np.uint32) * bits)[None, None, :]
    packed = np.bitwise_or.reduce(q << shifts, axis=-1).astype(np.uint32)
    return packed, scales.astype(np.float32), w_min.astype(np.float32)


def _unpack(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Words ``[..., O, W]`` -> unsigned codes ``[..., O, W * 32 / bits]``
    (int32; least significant bits first)."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=words.device, dtype=torch.int32) * bits
    codes = (words[..., None].to(torch.int32) >> shifts) & ((1 << bits) - 1)
    return codes.reshape(*words.shape[:-1], words.shape[-1] * per_word)


def dequantize(words: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
               group_size: int = 64, bits: int = 4, dtype=torch.float32) -> torch.Tensor:
    """Packed words + scales/biases -> the dense ``[..., O, I]`` weight in
    ``dtype`` (codes, scales and biases cast to ``dtype`` first, as the JAX
    package does; leading dims pass through)."""
    *lead, o, n_words = words.shape
    i = n_words * (32 // bits)
    q = _unpack(words, bits).to(dtype).reshape(*lead, o, i // group_size, group_size)
    w = q * scales[..., None].to(dtype) + biases[..., None].to(dtype)
    return w.reshape(*lead, o, i)


def tag_quantized(params: dict, group_size: int = 64, bits: int = 4) -> dict:
    """Fold every ``{weight (packed words), scales, biases}`` triple of a
    loaded checkpoint tree into a :class:`QuantizedTensor` under
    ``weight`` (a sibling linear ``bias`` stays)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        if is_quantized(node):
            new = {"weight": QuantizedTensor(node["weight"], node["scales"],
                                             node["biases"], group_size, bits)}
            if "bias" in node:
                new["bias"] = node["bias"]
            return new
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def is_quantized(p: dict) -> bool:
    """A tagged :class:`QuantizedTensor` linear, or a raw checkpoint triple
    (int32 words beside ``scales`` and ``biases``)."""
    w = p.get("weight")
    if isinstance(w, QuantizedTensor):
        return True
    return ("scales" in p and "biases" in p and isinstance(w, torch.Tensor)
            and w.dtype == torch.int32)


def dequantize_tree(params: dict, dtype=torch.bfloat16) -> dict:
    """Every :class:`QuantizedTensor` leaf expanded to a dense weight."""
    if isinstance(params, QuantizedTensor):
        return params.dequantize(dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    return params


def quantized_matmul(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                     biases: torch.Tensor, group_size: int = 64, bits: int = 4
                     ) -> torch.Tensor:
    """``x @ W.T`` with W packed. Up to ``ops.qmm.MAX_ROWS`` (64) rows of
    ``x`` go to ``ops.qmm.quantized_matvec`` (the GEMV kernel on CUDA, its
    plain version on the CPU), as in the JAX package
    (tpu_audio/core/quant.py:296); more rows dequantize W to ``x``'s dtype
    and multiply."""
    from tpu_audio_torch.ops import qmm

    lead = x.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    if rows <= qmm.MAX_ROWS:
        y = qmm.quantized_matvec(x.reshape(rows, x.shape[-1]).contiguous(), words,
                                 scales, biases, group_size, bits)
        return y.reshape(*lead, words.shape[0])
    return x @ dequantize(words, scales, biases, group_size, bits, dtype=x.dtype).t()


def quantized_matmul_qt(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """:func:`quantized_matmul` over a :class:`QuantizedTensor`."""
    return quantized_matmul(x, qt.weight, qt.scales, qt.biases, qt.group_size, qt.bits)
