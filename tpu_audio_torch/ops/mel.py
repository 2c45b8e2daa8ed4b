"""Fused log-mel projection: ``log10(max((re^2 + im^2) @ filters, 1e-10))``.

Port of tpu_audio/ops/pallas_mel.py:fused_log_mel; the CUDA kernel is
``csrc/mel.cu``. :func:`fused_log_mel_ref` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.ops import _lib

__all__ = ["fused_log_mel", "fused_log_mel_ref", "supported"]

MEL_GROUP = 16  # mels a block of the kernel (csrc/mel.cu)
MAX_MELS = MEL_GROUP * 65535  # the grid's second dimension


def supported(f: int, m: int) -> bool:
    """Whether the CUDA kernel takes ``f`` frequency bins and ``m`` mels:
    any F (a block walks its mel group's band in pieces of 32 bins, so F
    meets no shared-memory limit; the first version took F <= 768) and M up
    to 16 x 65,535."""
    return f >= 0 and 1 <= m <= MAX_MELS


def fused_log_mel_ref(spec_re: torch.Tensor, spec_im: torch.Tensor,
                      filters: torch.Tensor) -> torch.Tensor:
    """Plain version: re, im ``[T, F]`` f32, filters ``[F, M]`` f32 ->
    ``[T, M]`` f32."""
    power = spec_re * spec_re + spec_im * spec_im
    return torch.log10(torch.clamp(power @ filters, min=1e-10))


def fused_log_mel(spec_re: torch.Tensor, spec_im: torch.Tensor,
                  filters: torch.Tensor) -> torch.Tensor:
    """``log10(max(|S|^2 @ filters, 1e-10))``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if spec_re.device.type == "cpu":
        return fused_log_mel_ref(spec_re, spec_im, filters)
    t, f = spec_re.shape
    m = filters.shape[1]
    dev = spec_re.device
    for name, x, shape in (("spec_re", spec_re, (t, f)), ("spec_im", spec_im, (t, f)),
                           ("filters", filters, (f, m))):
        _lib.require(x, name, torch.float32, shape, dev)
    out = torch.empty((t, m), dtype=torch.float32, device=dev)
    if t == 0 or m == 0:
        return out
    if not supported(f, m):
        raise ValueError(f"fused_log_mel: {f} frequency bins and {m} mels are not supported")
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_fused_log_mel(
            spec_re.data_ptr(), spec_im.data_ptr(), filters.data_ptr(),
            out.data_ptr(), t, f, m, _lib.stream(spec_re))
    _lib.check(err, "fused_log_mel")
    _lib.launches["fused_log_mel"] += 1
    return out
