"""Whisper decoder stack for one token with int8 weights and dynamic int8
activations (the w8 kv8d configuration).

Port of tpu_audio/ops/pallas_fused_decoder.py: ``pack_decoder_weights``,
``quantize_cross_kv``, ``fused_stack`` (one token) and
``fused_stack_lanes`` (one token for each of n serving lanes). The CUDA
implementations are ``csrc/fused_decoder.cu`` and
``csrc/fused_decoder_lanes.cu`` (8 and 14 launches a layer, driven from C);
:func:`fused_stack_ref` and
:func:`fused_stack_lanes_ref` are the plain PyTorch versions.

All versions write the token's new k/v rows into the bf16 self-attention
caches in place at the write offset (the JAX kernels returned them for the
caller to scatter) and also return them in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tpu_audio_torch.core import quant
from tpu_audio_torch.ops import _lib

__all__ = ["FusedPack", "supported", "supported_lanes", "pack_decoder_weights",
           "quantize_cross_kv", "scratch_layout", "lanes_scratch_layout", "fused_stack",
           "fused_stack_ref",
           "fused_stack_lanes", "fused_stack_lanes_ref", "MAX_LANES"]

MAX_LANES = 32  # int32 accumulators a GEMV thread keeps (csrc/fused_decoder_lanes.cu)
SMEM_OPT_IN = 227 * 1024  # shared memory a block may opt in to (H100)
LANE_GEMV_STATIC = 128  # a lanes GEMV block's static shared memory: the n scales


class FusedPack(NamedTuple):
    """Load-time packed decoder weights. Output rows of ``w_in`` in order:
    q, k, v, out, cross-q, cross-out (``d`` rows each), fc1 (``ffn``);
    ``scales``/``biases`` follow the same rows with fc2's ``d`` rows last
    (k's bias is zero); ``ln`` holds the self, cross and final LayerNorm
    (weight, bias) pairs."""

    w_in: torch.Tensor    # [L, 6d + ffn, d] int8
    w_fc2: torch.Tensor   # [L, d, ffn] int8, output-major
    scales: torch.Tensor  # [L, 7d + ffn] f32 per-output-channel
    biases: torch.Tensor  # [L, 7d + ffn] f32
    ln: torch.Tensor      # [L, 6, d] f32


def supported(cfg) -> bool:
    """The shapes the CUDA kernels take: head dim 64 (every published
    whisper size), GEMV inputs in whole 16-byte int8 vectors, and within
    48 KB of shared memory a GEMV block's int8 + f32 copy of its input (5
    bytes an element) plus its reduction scratch, and, for the LayerNorm
    GEMVs of the one-token kernel, the staged f32 input, LayerNorm weight
    and bias beside them (17 bytes an element of d). The attention blocks'
    staging (18 KB) fits at any whisper size; their combine's copy of a
    head's partials (264 bytes a 64-position chunk) is checked per call."""
    d, ffn = cfg.d_model, cfg.decoder_ffn_dim
    return (d == 64 * cfg.decoder_attention_heads and ffn % 16 == 0
            and max(5 * max(d, ffn), 17 * d) + 128 <= 48 * 1024)


def supported_lanes(cfg, n: int) -> bool:
    """The lanes kernel takes ``n`` lanes: the shapes of :func:`supported`,
    ``1 <= n <= MAX_LANES``, and the n staged int8 rows of the widest GEMV
    input (``n * max(d, ffn)`` bytes) beside a GEMV block's static shared
    memory, within what a block may opt in to. At whisper-large-v3 (ffn
    5120) that is every n up to 32. (A quantise block stages 16 bytes an
    element of its row, within the opt-in at every :func:`supported`
    shape.)"""
    return (supported(cfg) and 1 <= n <= MAX_LANES
            and n * max(cfg.d_model, cfg.decoder_ffn_dim) + LANE_GEMV_STATIC <= SMEM_OPT_IN)


def _as_int8(w) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(w, quant.Int8Tensor):
        return w.weight, w.scale.to(torch.float32)
    t = quant.quantize_int8(w)
    return t.weight, t.scale


def pack_decoder_weights(params: dict, cfg) -> FusedPack:
    """Pack the stacked decoder layers (``model.decoder.layers``, leaves
    ``[L, ...]``; w8 or dense, dense weights are quantized here)."""
    lp = params["model"]["decoder"]["layers"]
    sa, ca = lp["self_attn"], lp["encoder_attn"]
    L, d = cfg.decoder_layers, cfg.d_model
    segs, scls, bias = [], [], []
    for proj in (sa["q_proj"], sa["k_proj"], sa["v_proj"], sa["out_proj"],
                 ca["q_proj"], ca["out_proj"], lp["fc1"]):
        w8, s = _as_int8(proj["weight"])
        segs.append(w8)
        scls.append(s)
        b = proj.get("bias")
        bias.append(b.to(torch.float32) if b is not None
                    else torch.zeros_like(s))
    fc2_w8, fc2_s = _as_int8(lp["fc2"]["weight"])
    scls.append(fc2_s)
    bias.append(lp["fc2"]["bias"].to(torch.float32))
    ln = torch.stack([lp[n][k].to(torch.float32)
                      for n in ("self_attn_layer_norm", "encoder_attn_layer_norm",
                                "final_layer_norm")
                      for k in ("weight", "bias")], dim=1)
    assert ln.shape == (L, 6, d)
    return FusedPack(torch.cat(segs, dim=1).contiguous(), fc2_w8.contiguous(),
                     torch.cat(scls, dim=1).contiguous(),
                     torch.cat(bias, dim=1).contiguous(), ln.contiguous())


def quantize_cross_kv(cross_k: torch.Tensor, cross_v: torch.Tensor):
    """Dense cross K/V ``[L, 1, H, S, hd]`` -> position-major int8
    ``[L, S, d]`` with one f32 scale per position ``[L, S]``
    (``max(max|row|/127, 1e-12)``): ``(ck, ks, cv, vs)``."""
    def pack(t):
        L, b, H, S, hd = t.shape
        if b != 1:
            raise ValueError("fused decoder cross K/V is B=1")
        xf = t[:, 0].permute(0, 2, 1, 3).reshape(L, S, H * hd).to(torch.float32)
        scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
        return q.to(torch.int8).contiguous(), scale.contiguous()

    ck, ks = pack(cross_k)
    cv, vs = pack(cross_v)
    return ck, ks, cv, vs


def _ln(x, w, b):
    mean = x.mean()
    z = x - mean
    return z * torch.rsqrt((z * z).mean() + 1e-5) * w + b


def _gemv(x, w8, scale, bias, tap=None, forced=None):
    """int8(x) @ w8.T with one act scale, exact int products (float64).
    ``tap = (codes, scale, pre)`` receives the int8 codes, the scale and
    the unrounded ``x / scale`` (``pre`` may be None); ``forced = (codes,
    scale)`` are used for the product in place of them."""
    xs = torch.clamp(x.abs().amax() / 127.0, min=1e-12)
    pre = x / xs
    xq = torch.clamp(torch.round(pre), -127, 127)
    if tap is not None:
        tap[0][:x.numel()] = xq.to(torch.int8)
        tap[1].fill_(xs)
        if tap[2] is not None:
            tap[2][:x.numel()] = pre
    if forced is not None:
        xq, xs = forced[0][:x.numel()].to(x.dtype), forced[1]
    acc = (w8.double() @ xq.double()).to(torch.float32)
    return acc * (scale * xs) + bias


def scratch_layout(d: int, ffn: int, L: int, H: int, s_max: int,
                   s_src: int) -> dict:
    """The one-token kernel's f32 scratch, as ``csrc/fused_decoder.cu``
    lays it out (its ``Scratch``; :func:`fused_stack` holds the two to each
    other through ``tpa_fused_stack_scratch``): region name -> (start,
    length) in 4-byte words, and ``"total"``. attn, q2 and ca [d] each, h
    [ffn], the split-S attention partials [H, nc, hd] and [H, nc, 2] with nc
    = ceil(max(s_max, s_src) / 64), then the int32 arrival counters [L, 2
    (self, cross), H] of the folded combines, which the wrapper zeroes once
    a call."""
    nc = -(-max(s_max, s_src) // _lib.ATTN_CHUNK)
    sizes = (("attn", d), ("q2", d), ("ca", d), ("h", ffn),
             ("part_o", H * nc * (d // H)), ("part_ml", H * nc * 2), ("counts", L * 2 * H))
    out, at = {}, 0
    for name, n in sizes:
        out[name] = (at, n)
        at += n
    out["total"] = at
    return out


@functools.lru_cache(maxsize=None)
def _kernel_scratch_layout(d: int, ffn: int, L: int, H: int, s_max: int,
                           s_src: int) -> dict:
    """:func:`scratch_layout`, held to the kernel's own (raises if the two
    differ: the wrapper would zero the wrong words)."""
    layout = scratch_layout(d, ffn, L, H, s_max, s_src)
    starts = (ctypes.c_longlong * 8)()
    _lib.check(_lib.lib().tpa_fused_stack_scratch(d, ffn, L, H, s_max, s_src, starts),
               "fused_stack scratch")
    mine = [start for start, _ in list(layout.values())[:-1]] + [layout["total"]]
    if list(starts) != mine:
        raise RuntimeError(f"fused_stack: scratch layout {mine} differs from the "
                           f"kernel's {list(starts)}")
    return layout


def lanes_scratch_layout(n: int, d: int, ffn: int, L: int, H: int, s_max: int,
                         s_src: int) -> dict:
    """The lanes kernel's f32 scratch, as ``csrc/fused_decoder_lanes.cu``
    lays it out (its ``Scratch``; :func:`fused_stack_lanes` holds the two to
    each other through ``tpa_fused_stack_lanes_scratch``): region name ->
    (start, length) in 4-byte words, and ``"total"``. attn, q2 and ca [n, d]
    each, h [n, ffn], the scales xs [n] of a GEMV input (padded to a
    multiple of 4), the split-S attention partials [n, H, nc, hd] and [n,
    H, nc, 2] with nc = ceil(max(s_max, s_src) / 64), then the int32 arrival
    counters [L, 2 (self, cross), H, n] of the folded combines (one for each
    layer, stage, head and lane), which the wrapper zeroes once a call."""
    nc = -(-max(s_max, s_src) // _lib.ATTN_CHUNK)
    sizes = (("attn", n * d), ("q2", n * d), ("ca", n * d), ("h", n * ffn),
             ("xs", -(-n // 4) * 4), ("part_o", n * H * nc * (d // H)), ("part_ml", n * H * nc * 2),
             ("counts", L * 2 * H * n))
    out, at = {}, 0
    for name, size in sizes:
        out[name] = (at, size)
        at += size
    out["total"] = at
    return out


@functools.lru_cache(maxsize=None)
def _kernel_lanes_scratch_layout(n: int, d: int, ffn: int, L: int, H: int, s_max: int,
                                 s_src: int) -> dict:
    """:func:`lanes_scratch_layout`, held to the kernel's own (raises if the
    two differ: the wrapper would zero the wrong words)."""
    layout = lanes_scratch_layout(n, d, ffn, L, H, s_max, s_src)
    starts = (ctypes.c_longlong * 9)()
    _lib.check(_lib.lib().tpa_fused_stack_lanes_scratch(n, d, ffn, L, H, s_max, s_src,
                                                        starts),
               "fused_stack_lanes scratch")
    mine = [start for start, _ in list(layout.values())[:-1]] + [layout["total"]]
    if list(starts) != mine:
        raise RuntimeError(f"fused_stack_lanes: scratch layout {mine} differs from the "
                           f"kernel's {list(starts)}")
    return layout


def fused_stack_ref(pack: FusedPack, ck, ks, cv, vs, kcache, vcache,
                    x: torch.Tensor, offset: int, *, cfg, s_src: int, tap=None,
                    codes=None):
    """Plain version of :func:`fused_stack` (same signature and effects).
    ``tap = (codes [L, 6, max(d, ffn)] int8, scales [L, 6] f32, pre)``
    receives each layer's six GEMV inputs as int8 codes and scales (and,
    if ``pre`` of the codes' shape in f32 is given, unrounded), in the
    order q/k/v, out, cross-q, cross-out, fc1, fc2. ``codes``, a tap of the
    same layout (codes, scales), supplies the codes and scales the GEMVs
    multiply in place of their own rounding (to hold a kernel to this
    version on the kernel's own codes)."""
    d, ffn, L = cfg.d_model, cfg.decoder_ffn_dim, cfg.decoder_layers
    H = cfg.decoder_attention_heads
    hd = d // H
    sm = 1.0 / math.sqrt(hd)
    n = offset + 1
    resid = x.to(torch.float32).clone()
    newk, newv = [], []
    for li in range(L):
        w, sc, bi, ln = pack.w_in[li], pack.scales[li], pack.biases[li], pack.ln[li]

        def tapped(gemv):
            return (None if tap is None else (
                tap[0][li, gemv], tap[1][li, gemv],
                None if tap[2] is None else tap[2][li, gemv]),
                None if codes is None else (codes[0][li, gemv], codes[1][li, gemv]))

        def rows(a, b, gemv):
            return w[a:b], sc[a:b], bi[a:b], *tapped(gemv)

        qkv = _gemv(_ln(resid, ln[0], ln[1]), *rows(0, 3 * d, 0))
        q, k, v = qkv[:d], qkv[d:2 * d], qkv[2 * d:]
        K = kcache[li, :n].to(torch.float32)
        V = vcache[li, :n].to(torch.float32)
        K[offset], V[offset] = k, v
        s = (K * (q * sm)).reshape(n, H, hd).sum(-1)
        p = torch.exp(s - s.amax(0))
        p = p / p.sum(0)
        att = (p[:, :, None] * V.reshape(n, H, hd)).sum(0).reshape(d)
        kcache[li, offset] = k.to(kcache.dtype)
        vcache[li, offset] = v.to(vcache.dtype)
        newk.append(k)
        newv.append(v)
        resid = resid + _gemv(att, *rows(3 * d, 4 * d, 1))

        q2 = _gemv(_ln(resid, ln[2], ln[3]), *rows(4 * d, 5 * d, 2))
        s = (ck[li, :s_src].to(torch.float32) * (q2 * sm)).reshape(s_src, H, hd).sum(-1)
        s = s * ks[li, :s_src, None]
        p = torch.exp(s - s.amax(0))
        p = p / p.sum(0) * vs[li, :s_src, None]
        att = (p[:, :, None] * cv[li, :s_src].to(torch.float32).reshape(s_src, H, hd)
               ).sum(0).reshape(d)
        resid = resid + _gemv(att, *rows(5 * d, 6 * d, 3))

        h = torch.nn.functional.gelu(
            _gemv(_ln(resid, ln[4], ln[5]), *rows(6 * d, 6 * d + ffn, 4)),
            approximate="tanh")
        resid = resid + _gemv(h, pack.w_fc2[li], sc[6 * d + ffn:], bi[6 * d + ffn:],
                              *tapped(5))
    return resid, torch.stack(newk), torch.stack(newv)


def fused_stack(pack: FusedPack, ck, ks, cv, vs, kcache, vcache,
                x: torch.Tensor, offset: int, *, cfg, s_src: int):
    """Run the decoder layer stack for ONE token.

    x: ``[d]`` f32 (embedded token + position); kcache/vcache:
    ``[L, S_max, d]`` bf16 position-major, rows ``< offset`` valid; ck/cv
    ``[L, S, d]`` int8 and ks/vs ``[L, S]`` f32 from
    :func:`quantize_cross_kv` (the first ``s_src`` rows are attended).
    Writes the new k/v rows into the caches at ``offset`` and returns
    ``(y [d] f32, newk [L, d] f32, newv [L, d] f32)``. The plain version
    runs for CPU tensors, the CUDA kernels for CUDA tensors: 8 launches a
    layer, each after the first a programmatic dependent launch, after the
    copy of ``x`` and the zeroing of the combines' arrival counters."""
    if x.device.type == "cpu":
        return fused_stack_ref(pack, ck, ks, cv, vs, kcache, vcache, x, offset,
                               cfg=cfg, s_src=s_src)
    d, ffn, L = cfg.d_model, cfg.decoder_ffn_dim, cfg.decoder_layers
    H = cfg.decoder_attention_heads
    s_max = kcache.shape[1]
    s_ck = ck.shape[1]
    dev = x.device
    if not supported(cfg):
        raise ValueError("fused_stack: unsupported decoder shape")
    if not 0 <= offset < s_max:
        raise ValueError(f"fused_stack: offset {offset} outside the cache ({s_max})")
    if not 0 < s_src <= s_ck:
        raise ValueError(f"fused_stack: s_src={s_src} outside 1..{s_ck}")
    req = _lib.require
    req(x, "x", torch.float32, (d,), dev)
    req(pack.w_in, "w_in", torch.int8, (L, 6 * d + ffn, d), dev)
    req(pack.w_fc2, "w_fc2", torch.int8, (L, d, ffn), dev)
    req(pack.scales, "scales", torch.float32, (L, 7 * d + ffn), dev)
    req(pack.biases, "biases", torch.float32, (L, 7 * d + ffn), dev)
    req(pack.ln, "ln", torch.float32, (L, 6, d), dev)
    for name, t in (("ck", ck), ("cv", cv)):
        req(t, name, torch.int8, (L, s_ck, d), dev)
    for name, t in (("ks", ks), ("vs", vs)):
        req(t, name, torch.float32, (L, s_ck), dev)
    for name, t in (("kcache", kcache), ("vcache", vcache)):
        req(t, name, torch.bfloat16, (L, s_max, d), dev)
    for name, t in (("x", x), *zip(pack._fields, pack), ("ck", ck), ("ks", ks),
                    ("cv", cv), ("vs", vs), ("kcache", kcache), ("vcache", vcache)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_stack: {name} is not 16-byte aligned")
    y = x.clone()
    qkv = torch.empty((L, 3 * d), dtype=torch.float32, device=dev)
    layout = _kernel_scratch_layout(d, ffn, L, H, s_max, s_src)
    scratch = torch.empty((layout["total"],), dtype=torch.float32, device=dev)
    counts = layout["counts"]
    scratch[counts[0]:counts[0] + counts[1]].zero_()  # int32 zeros: the same bits
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_fused_stack(
            y.data_ptr(), pack.w_in.data_ptr(), pack.w_fc2.data_ptr(),
            pack.scales.data_ptr(), pack.biases.data_ptr(), pack.ln.data_ptr(),
            ck.data_ptr(), ks.data_ptr(), cv.data_ptr(), vs.data_ptr(),
            kcache.data_ptr(), vcache.data_ptr(), qkv.data_ptr(),
            scratch.data_ptr(), L, d, ffn, H, s_src, s_ck, s_max, int(offset),
            _lib.stream(x))
    _lib.check(err, "fused_stack")
    _lib.launches["fused_stack"] += 1
    return y, qkv[:, d:2 * d], qkv[:, 2 * d:]


def fused_stack_lanes_ref(pack: FusedPack, ck, ks, cv, vs, kcache, vcache,
                          x: torch.Tensor, offsets: torch.Tensor,
                          lanes: torch.Tensor, *, cfg, s_src: int, tap=None):
    """Plain version of :func:`fused_stack_lanes` (same signature and
    effects): each lane through :func:`fused_stack_ref` on its own slot.
    The lanes are independent by construction, so running them one after
    another computes the same function as the kernel's shared sweep.
    ``tap``: as :func:`fused_stack_lanes`', with an optional third f32
    tensor of the codes' shape for the unrounded values."""
    s_max = kcache.shape[2]
    ys, nks, nvs = [], [], []
    for m, (off, slot) in enumerate(zip(offsets.tolist(), lanes.tolist())):
        t = None if tap is None else (
            tap[0][:, :, m], tap[1][:, :, m],
            None if len(tap) < 3 or tap[2] is None else tap[2][:, :, m])
        y, nk, nv = fused_stack_ref(
            pack, ck[slot], ks[slot], cv[slot], vs[slot], kcache[slot],
            vcache[slot], x[m], min(max(off, 0), s_max - 1), cfg=cfg, s_src=s_src,
            tap=t)
        ys.append(y)
        nks.append(nk)
        nvs.append(nv)
    return torch.stack(ys), torch.stack(nks, dim=1), torch.stack(nvs, dim=1)


def fused_stack_lanes(pack: FusedPack, ck, ks, cv, vs, kcache, vcache,
                      x: torch.Tensor, offsets: torch.Tensor, lanes: torch.Tensor,
                      *, cfg, s_src: int, tap=None):
    """Run the decoder layer stack for ONE token on EACH of n lanes, with
    one sweep of the weights shared by all of them.

    x: ``[n, d]`` f32 (each lane's embedded token + position); offsets and
    lanes: ``[n]`` int32 on x's device, lane m's write position and its
    slot in the stacked state (distinct slots); kcache/vcache
    ``[slots, L, S_max, d]`` bf16 position-major, rows ``< offsets[m]`` of
    slot ``lanes[m]`` valid; ck/cv ``[slots, L, S, d]`` int8 and ks/vs
    ``[slots, L, S]`` f32 per-request cross K/V from
    :func:`quantize_cross_kv` (the first ``s_src`` rows are attended). Each
    activation row gets its own int8 scale, so a lane's outputs are those
    of :func:`fused_stack` on its own inputs. An offset outside
    ``[0, S_max)`` is clamped to it. Writes each lane's new k/v rows into
    its slot at its offset and returns ``(y [n, d] f32, newk [L, n, d] f32,
    newv [L, n, d] f32)``; other slots and rows stay untouched. Nothing
    here reads a device value on the host. ``tap = (codes, scales)``,
    int8 ``[L, 6, n, max(d, ffn)]`` and f32 ``[L, 6, n]``, receives every
    GEMV input's int8 codes and scale (q/k/v, out, cross-q, cross-out,
    fc1, fc2 of each layer), for checking the rounding against the plain
    version. The plain version runs for CPU tensors, the CUDA kernels for
    CUDA tensors: 14 launches a layer (a quantise launch before each of the
    six GEMVs, and the self- and cross-attention with their combines folded
    in), each after the first a programmatic dependent launch, after the
    copy of ``x`` and the zeroing of the combines' arrival counters."""
    if x.device.type == "cpu":
        return fused_stack_lanes_ref(pack, ck, ks, cv, vs, kcache, vcache, x,
                                     offsets, lanes, cfg=cfg, s_src=s_src, tap=tap)
    d, ffn, L = cfg.d_model, cfg.decoder_ffn_dim, cfg.decoder_layers
    H = cfg.decoder_attention_heads
    n = x.shape[0]
    slots, s_max = kcache.shape[0], kcache.shape[2]
    s_ck = ck.shape[2]
    dev = x.device
    if not supported_lanes(cfg, n):
        raise ValueError(f"fused_stack_lanes: unsupported decoder shape or n={n}")
    if not 0 < s_src <= s_ck:
        raise ValueError(f"fused_stack_lanes: s_src={s_src} outside 1..{s_ck}")
    if n > slots:
        raise ValueError(f"fused_stack_lanes: {n} lanes over {slots} slots")
    req = _lib.require
    req(x, "x", torch.float32, (n, d), dev)
    req(offsets, "offsets", torch.int32, (n,), dev)
    req(lanes, "lanes", torch.int32, (n,), dev)
    req(pack.w_in, "w_in", torch.int8, (L, 6 * d + ffn, d), dev)
    req(pack.w_fc2, "w_fc2", torch.int8, (L, d, ffn), dev)
    req(pack.scales, "scales", torch.float32, (L, 7 * d + ffn), dev)
    req(pack.biases, "biases", torch.float32, (L, 7 * d + ffn), dev)
    req(pack.ln, "ln", torch.float32, (L, 6, d), dev)
    for name, t in (("ck", ck), ("cv", cv)):
        req(t, name, torch.int8, (slots, L, s_ck, d), dev)
    for name, t in (("ks", ks), ("vs", vs)):
        req(t, name, torch.float32, (slots, L, s_ck), dev)
    for name, t in (("kcache", kcache), ("vcache", vcache)):
        req(t, name, torch.bfloat16, (slots, L, s_max, d), dev)
    tap_q = tap_s = 0
    if tap is not None:
        req(tap[0], "tap codes", torch.int8, (L, 6, n, max(d, ffn)), dev)
        req(tap[1], "tap scales", torch.float32, (L, 6, n), dev)
        tap_q, tap_s = tap[0].data_ptr(), tap[1].data_ptr()
    for name, t in (("x", x), *zip(pack._fields, pack), ("ck", ck), ("ks", ks),
                    ("cv", cv), ("vs", vs), ("kcache", kcache), ("vcache", vcache)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_stack_lanes: {name} is not 16-byte aligned")
    y = x.clone()
    qkv = torch.empty((L, n, 3 * d), dtype=torch.float32, device=dev)
    layout = _kernel_lanes_scratch_layout(n, d, ffn, L, H, s_max, s_src)
    scratch = torch.empty((layout["total"],), dtype=torch.float32, device=dev)
    counts = layout["counts"]
    scratch[counts[0]:counts[0] + counts[1]].zero_()  # int32 zeros: the same bits
    xq = torch.empty((n * max(d, ffn),), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_fused_stack_lanes(
            y.data_ptr(), offsets.data_ptr(), lanes.data_ptr(),
            pack.w_in.data_ptr(), pack.w_fc2.data_ptr(), pack.scales.data_ptr(),
            pack.biases.data_ptr(), pack.ln.data_ptr(), ck.data_ptr(),
            ks.data_ptr(), cv.data_ptr(), vs.data_ptr(), kcache.data_ptr(),
            vcache.data_ptr(), qkv.data_ptr(), scratch.data_ptr(), xq.data_ptr(),
            tap_q, tap_s, n, L, d, ffn, H, s_src, s_ck, s_max, _lib.stream(x))
    _lib.check(err, "fused_stack_lanes")
    _lib.launches["fused_stack_lanes"] += 1
    return y, qkv[:, :, d:2 * d], qkv[:, :, 2 * d:]
