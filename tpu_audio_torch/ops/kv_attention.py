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

__all__ = ["decode_attention_int8", "decode_attention_int8_ref", "scratch_layout",
           "supported"]

HEAD_DIM = 64  # the kernel's head dim (every whisper size)

# the kernel's scratch, one buffer per (device, stream): (buffer, the
# counter region (start, length) it holds at zero)
_scratch: dict[tuple, tuple[torch.Tensor, tuple[int, int]]] = {}


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


def scratch_layout(h: int, s: int, d: int = HEAD_DIM) -> dict:
    """The kernel's scratch as ``csrc/kv_attention.cu`` lays it out: region
    name -> (start, length) in 4-byte words, and ``"total"``. The split-S
    partials part_o [H, nc, D] and part_ml [H, nc, 2] f32 (nc = ceil(S /
    64)), then the int32 arrival counters [H] of the folded combine, where
    the C entry finds them (part_ml + 2 H nc). Each call leaves its counters
    zero."""
    nc = -(-s // _lib.ATTN_CHUNK)
    out, at = {}, 0
    for name, n in (("part_o", h * nc * d), ("part_ml", h * nc * 2), ("counts", h)):
        out[name] = (at, n)
        at += n
    out["total"] = at
    return out


def scratch(device: torch.device, stream: int, h: int, s: int,
            d: int = HEAD_DIM) -> torch.Tensor:
    """The f32 scratch buffer of calls on ``stream`` of ``device`` (one a
    (device, stream): two streams never share arrival counters), with the
    counters of a call of shape (h, s, d) at zero. It is made zeroed, grown (a new
    zeroed buffer) when a call needs more words, and otherwise reused: each
    call leaves its counters zero, so only a call of another shape, whose
    counters may lie where earlier calls wrote partials, zeroes its counters
    first."""
    layout = scratch_layout(h, s, d)
    counts = layout["counts"]
    buf, zeroed = _scratch.get((device, stream), (None, None))
    if buf is None or buf.numel() < layout["total"]:
        buf = torch.zeros((layout["total"],), dtype=torch.float32, device=device)
    elif zeroed != counts:
        buf[counts[0]:counts[0] + counts[1]].zero_()
    _scratch[(device, stream)] = (buf, counts)
    return buf


def supported(kc: torch.Tensor, vc: torch.Tensor, ks: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes these planes: head dim 64, G groups
    dividing it, at least one position, and the code planes kc and vc
    16-byte aligned (the kernel stages their rows with 16-byte copies; the
    route's planes are slices of contiguous [L, H, S, D] tensors, so they
    are)."""
    d, g = kc.shape[-1], ks.shape[-1]
    return (d == HEAD_DIM and g >= 1 and d % g == 0 and kc.shape[1] >= 1
            and kc.data_ptr() % 16 == 0 and vc.data_ptr() % 16 == 0)


def decode_attention_int8(q, kc, ks, kb, vc, vs, vb, valid: int, *,
                          sm_scale: float) -> torch.Tensor:
    """Fused dequantize + attention for one query token: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (one launch, besides
    the conversion of q to f32)."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, kc, ks, kb, vc, vs, vb, valid,
                                         sm_scale=sm_scale)
    h, s, d = kc.shape
    g = ks.shape[-1]
    dev = q.device
    if not supported(kc, vc, ks):
        raise ValueError(f"decode_attention_int8: head dim {d} with {g} groups over {s} "
                         "positions, or code planes not 16-byte aligned, is not supported")
    qf = q.to(torch.float32).contiguous()
    _lib.require(qf, "q", torch.float32, (h, 1, d), dev)
    for name, x in (("kc", kc), ("vc", vc)):
        _lib.require(x, name, torch.int8, (h, s, d), dev)
    for name, x in (("ks", ks), ("kb", kb), ("vs", vs), ("vb", vb)):
        _lib.require(x, name, torch.float32, (h, s, g), dev)
    out = torch.empty((h, 1, d), dtype=torch.float32, device=dev)
    stream = _lib.stream(q)
    part = scratch(dev, stream, h, s, d)
    ml = scratch_layout(h, s, d)["part_ml"][0]
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_decode_attention_int8(
            qf.data_ptr(), kc.data_ptr(), ks.data_ptr(), kb.data_ptr(),
            vc.data_ptr(), vs.data_ptr(), vb.data_ptr(), out.data_ptr(),
            part.data_ptr(), part.data_ptr() + 4 * ml,
            h, s, d, g, int(valid), float(sm_scale), stream)
    _lib.check(err, "decode_attention_int8")
    _lib.launches["decode_attention_int8"] += 1
    return out
