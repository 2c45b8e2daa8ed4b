"""Per-channel int8 weights with dynamic int8 activations (w8a8).

Port of ``Int8Tensor``, ``quantize_int8_jax``, ``int8_matmul`` and
``quantize_tree(scheme="w8a8")`` from tpu_audio.core.quant. The JAX
package leaves these to XLA; here the CUDA product goes to
``torch._int_mm`` (s8 x s8 -> s32) and the CPU product to a float64
matmul, which is exact for int8 dots of any width this port meets
(|sum| < 2**53).
"""

from __future__ import annotations

import torch

__all__ = ["Int8Tensor", "quantize_int8", "quantize_act_int8",
           "int8_matmul", "quantize_tree", "slice_rows"]


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
    (``{"weight": ...}``, dense or :class:`Int8Tensor`, optional
    ``bias``)."""
    w = p["weight"]
    rows = torch.as_tensor(rows, dtype=torch.long, device=w.weight.device
                           if isinstance(w, Int8Tensor) else w.device)
    if isinstance(w, Int8Tensor):
        out = {"weight": Int8Tensor(w.weight[rows], w.scale[rows])}
    else:
        out = {"weight": w[rows]}
    if "bias" in p:
        out["bias"] = p["bias"][rows]
    return out


def quantize_tree(params: dict, group_size: int = 64,
                  min_in_features: int = 256, scheme: str = "w8a8") -> dict:
    """Quantize every eligible 2-D (or stacked ``[L, O, I]`` under a
    ``layers`` container) float ``weight`` leaf of a param tree to an
    :class:`Int8Tensor`. Norms, positions, convs, biases and small or
    ragged weights stay dense — the same eligibility rule as the JAX
    package, so both packages quantize the same leaves."""
    if scheme != "w8a8":
        raise NotImplementedError(
            f"quantize_tree(scheme={scheme!r}): MLX grouped-affine "
            "quantization is not ported yet; use scheme='w8a8'")

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
                if v.ndim == 3:  # per layer: bounds the f32 workspace
                    parts = [quantize_int8(v[i]) for i in range(v.shape[0])]
                    out[k] = Int8Tensor(torch.stack([p.weight for p in parts]),
                                        torch.stack([p.scale for p in parts]))
                else:
                    out[k] = quantize_int8(v)
            else:
                out[k] = walk(v, k, in_layers or k == "layers")
        return out

    return walk(params)
