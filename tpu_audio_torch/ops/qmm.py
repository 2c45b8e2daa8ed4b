"""MLX grouped-affine GEMV: ``x [B, I] @ W.T -> [B, O]`` with W in MLX's
packed 4/8-bit layout (see ``core.quant``).

Port of tpu_audio/ops/pallas_qmm.py:quantized_matvec; the CUDA kernel is
``csrc/qmm.cu``. :func:`quantized_matvec_ref` is the plain PyTorch
version. The TPU kernel's word-scale planes (``scales_w``) are left out:
the kernel reads scales and biases per group in their stored dtype.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.ops import _lib

__all__ = ["quantized_matvec", "quantized_matvec_ref", "BITS", "GROUP_SIZES",
           "MAX_ROWS"]

BITS = (2, 4, 8)
GROUP_SIZES = (32, 64, 128)
MAX_ROWS = 64  # the rows of x the kernel takes: core.quant sends it no more
SMEM_BYTES = 232448  # shared memory a block may have on the H100
# dtype codes of csrc/qmm.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantized_matvec_ref(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                         biases: torch.Tensor, group_size: int = 64, bits: int = 4
                         ) -> torch.Tensor:
    """Plain version: dequantize W to f32, ``x @ W.T`` in f32, the result in
    ``x``'s dtype."""
    from tpu_audio_torch.core.quant import dequantize

    w = dequantize(words, scales, biases, group_size, bits, dtype=torch.float32)
    return (x.to(torch.float32) @ w.t()).to(x.dtype)


def rows_a_pass(b: int, i: int, group_size: int, bits: int) -> int:
    """The rows of x the kernel stages a pass (1, 2, 4 or 8): the fewest
    that cover ``b``, at most as many as the shared memory holds (a row's
    f32 planes, each padded by 4 floats, and its group sums: ``(i + 4 * 32
    / bits + i / group_size) * 4`` bytes); 0 when not one row fits."""
    per_row = (i + 4 * (32 // bits) + i // group_size) * 4
    fit = [r for r in (1, 2, 4, 8) if r * per_row <= SMEM_BYTES]
    return next((r for r in fit if r >= b), fit[-1]) if fit else 0


def quantized_matvec(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                     biases: torch.Tensor, group_size: int = 64, bits: int = 4
                     ) -> torch.Tensor:
    """``x @ dequant(W).T`` for ``x [B, I]`` (B <= 64), words ``[O, I * bits
    / 32]`` (int32 bits), scales and biases ``[O, I / group_size]``: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors, in ``x``'s
    dtype. The kernel takes bits 2, 4 and 8, groups of 32, 64 and 128, f32,
    bf16 or f16 ``x`` and scales, any O; it raises on anything else."""
    if x.device.type == "cpu":
        return quantized_matvec_ref(x, words, scales, biases, group_size, bits)
    dev = x.device
    b, i = x.shape
    o, n_words = words.shape
    if bits not in BITS or group_size not in GROUP_SIZES:
        raise ValueError(f"quantized_matvec: bits {bits}, group size {group_size} "
                         f"(the kernel takes bits {BITS} and groups {GROUP_SIZES})")
    if i % group_size or n_words * (32 // bits) != i:
        raise ValueError(f"quantized_matvec: {i} input features, {n_words} words at "
                         f"{bits} bits in groups of {group_size}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"quantized_matvec: {b} rows (the kernel takes 1 to {MAX_ROWS})")
    if x.dtype not in _DTYPES or scales.dtype not in _DTYPES:
        raise ValueError(f"quantized_matvec: dtypes x {x.dtype}, scales {scales.dtype} "
                         "(the kernel takes f32, bf16 or f16)")
    rb = rows_a_pass(b, i, group_size, bits)
    if rb == 0:
        raise ValueError(f"quantized_matvec: {i} input features exceed the kernel's "
                         "shared memory")
    _lib.require(x, "x", x.dtype, (b, i), dev)
    _lib.require(words, "words", torch.int32, (o, n_words), dev)
    for name, t in (("scales", scales), ("biases", biases)):
        _lib.require(t, name, scales.dtype, (o, i // group_size), dev)
    vec = int(n_words % 4 == 0 and words.data_ptr() % 16 == 0)
    out = torch.empty((b, o), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_quantized_matvec(
            x.data_ptr(), _DTYPES[x.dtype], words.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), _DTYPES[scales.dtype], out.data_ptr(), b, o, i,
            group_size, bits, rb, vec, _lib.stream(x))
    _lib.check(err, "quantized_matvec")
    _lib.launches["quantized_matvec"] += 1
    return out
