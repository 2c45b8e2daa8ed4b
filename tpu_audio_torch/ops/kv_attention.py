"""Single-query attention over int8 K/V codes with per-position group
scales and biases (the codes of ``core.kv_cache._quantize(bits=8)``).

Port of tpu_audio/ops/pallas_kv_attention.py:decode_attention_int8 in the
position-major ``[H, S, D]`` layout that ``_quantize`` produces (the TPU
kernel's transposed ``[H, D, S]`` layout was a lane-width artifact). The
CUDA kernel is ``csrc/kv_attention.cu``; :func:`decode_attention_int8_ref`
is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.ops import _lib

__all__ = ["decode_attention_int8", "decode_attention_int8_ref"]


def decode_attention_int8_ref(q, kc, ks, kb, vc, vs, vb, valid: int, *,
                              sm_scale: float) -> torch.Tensor:
    """Plain version. q ``[H, 1, D]`` (any float dtype); kc/vc ``[H, S, D]``
    int8; ks/kb/vs/vb ``[H, S, G]`` f32; positions ``>= valid`` are masked.
    Returns ``[H, 1, D]`` f32."""
    h, s, d = kc.shape
    g = ks.shape[-1]

    def deq(codes, sc, b):
        x = codes.to(torch.float32).reshape(h, s, g, d // g)
        return (x * sc[..., None] + b[..., None]).reshape(h, s, d)

    k = deq(kc, ks, kb)
    v = deq(vc, vs, vb)
    scores = (q.to(torch.float32) @ k.transpose(1, 2)) * sm_scale  # [H, 1, S]
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos < valid, scores, torch.full_like(scores, -1e9))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    return (p @ v) / p.sum(-1, keepdim=True)


def decode_attention_int8(q, kc, ks, kb, vc, vs, vb, valid: int, *,
                          sm_scale: float) -> torch.Tensor:
    """Fused dequantize + attention for one query token: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, kc, ks, kb, vc, vs, vb, valid,
                                         sm_scale=sm_scale)
    h, s, d = kc.shape
    g = ks.shape[-1]
    dev = q.device
    if d != 64 or d % g:  # the kernel's head dim: every whisper size
        raise ValueError(f"decode_attention_int8: head dim {d} with {g} groups "
                         "is not supported")
    if s == 0:
        raise ValueError("decode_attention_int8: no positions")
    qf = q.to(torch.float32).contiguous()
    _lib.require(qf, "q", torch.float32, (h, 1, d), dev)
    for name, x in (("kc", kc), ("vc", vc)):
        _lib.require(x, name, torch.int8, (h, s, d), dev)
    for name, x in (("ks", ks), ("kb", kb), ("vs", vs), ("vb", vb)):
        _lib.require(x, name, torch.float32, (h, s, g), dev)
    out = torch.empty((h, 1, d), dtype=torch.float32, device=dev)
    nc = -(-s // _lib.ATTN_CHUNK)
    part = torch.empty((h * nc * (d + 2),), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_decode_attention_int8(
            qf.data_ptr(), kc.data_ptr(), ks.data_ptr(), kb.data_ptr(),
            vc.data_ptr(), vs.data_ptr(), vb.data_ptr(), out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * h * nc * d,
            h, s, d, g, int(valid), float(sm_scale), _lib.stream(q))
    _lib.check(err, "decode_attention_int8")
    _lib.launches["decode_attention_int8"] += 1
    return out
