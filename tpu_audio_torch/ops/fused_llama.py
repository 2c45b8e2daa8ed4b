"""Llama-family decoder stack for one token with int8 weights and dynamic
int8 activations (the w8a8 decode of Orpheus / Llama-3 TTS backbones).

Port of tpu_audio/ops/pallas_fused_llama.py: ``supported``,
``pack_llama_weights``, ``fused_llama_stack`` (one token) and
``fused_llama_stack_lanes`` (one token for each of n serving lanes). The
CUDA implementations are ``csrc/fused_llama.cu`` and
``csrc/fused_llama_lanes.cu`` (a short chain of small kernels a layer,
driven from C as programmatic dependent launches);
:func:`fused_llama_stack_ref` and :func:`fused_llama_stack_lanes_ref` are
the plain PyTorch versions.

The pack keeps the checkpoint's head order: the TPU kernel's pack-time GQA
permutation of the q rows and o columns (a lane-layout device) is left
out, and query head ``h`` reads K/V head ``h // (heads / kv_heads)``
directly. The down projection is stored output-major, so it is one more
row-per-output GEMV whose per-channel scale applies after the int32 sum,
as in the TPU kernel. Both versions write the token's new k/v rows (K after
RoPE) into the position-major bf16 caches in place at the write offset
(the JAX kernel returned them for the caller to scatter) and also return
them in f32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tpu_audio_torch.core import nn, quant
from tpu_audio_torch.ops import _lib
from tpu_audio_torch.ops.fused_decoder import MAX_LANES, SMEM_OPT_IN

__all__ = ["LlamaFusedPack", "supported", "supported_lanes", "pack_llama_weights",
           "fused_llama_stack", "fused_llama_stack_ref", "fused_llama_stack_lanes",
           "fused_llama_stack_lanes_ref", "scratch_layout", "lanes_scratch_layout",
           "LANES_S_MAX", "GEMVS"]

HEAD_DIM = 128
# shared memory of the one-block quantise of a GEMV input: the H100 lets a
# block opt into 227 KB; 1 KB is left for its static reduction scratch
QUANT_SMEM = 226 * 1024
GEMVS = ("q/k/v", "o", "gate/up", "down")  # a layer's GEMV inputs, in order
# the longest cache (S_max) the lanes kernel takes: its folded combine keeps
# one query head's partials over the whole cache, ceil(S_max / 64) x (128 +
# 2) f32, in the shared memory a block may opt into, 2 KB left for the
# attention kernel's static scratch. 28,352 positions on the H100.
LANES_S_MAX = (SMEM_OPT_IN - 2048) // ((HEAD_DIM + 2) * 4) * _lib.ATTN_CHUNK


class LlamaFusedPack(NamedTuple):
    """Load-time packed layer weights. Output rows of ``w_in`` in order: q
    (``d``), k, v (``dkv`` each), o (``d``), gate, up (``ffn`` each);
    ``scales`` follows the same rows with down's ``d`` rows last; ``norms``
    rows are the input and post-attention RMSNorm weights and, with
    ``qk_norm``, the per-head q and k norm weights broadcast over the
    heads (k's in the first ``dkv`` columns); ``inv_freq`` is the RoPE
    table (Llama-3 NTK scaling included)."""

    w_in: torch.Tensor      # [L, 2d + 2dkv + 2ffn, d] int8
    w_down: torch.Tensor    # [L, d, ffn] int8, output-major
    scales: torch.Tensor    # [L, 3d + 2dkv + 2ffn] f32 per output channel
    norms: torch.Tensor     # [L, 4, d] f32
    inv_freq: torch.Tensor  # [HEAD_DIM / 2] f32


def supported(cfg) -> bool:
    """The shapes the CUDA kernel takes: head dim 128 with ``heads * 128 ==
    hidden``, whole GQA groups, no attention bias, half-split RoPE, no
    Granite scale knobs, an ffn width of whole 16-byte int8 vectors, and
    each quantise launch within the shared memory a block may opt into
    (QUANT_SMEM): a hidden-wide input's f32 row, RMSNorm weight and normed
    row (12 x hidden bytes, so hidden up to 19,285) and the down
    projection's f32 SwiGLU row and its copy (8 x ffn bytes, ffn up to
    28,928). That is the TPU kernel's predicate without its weight-chunk
    divisibility, for every published Llama up to 70B (Llama-3.1-405B's ffn
    of 53,248 is not taken). The cache length is not bounded."""
    d, ffn = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.resolved_head_dim
    return (hd == HEAD_DIM and cfg.num_attention_heads * hd == d
            and cfg.num_attention_heads % cfg.num_key_value_heads == 0
            and not cfg.attention_bias and not cfg.rope_interleaved
            and cfg.residual_multiplier == 1.0 and cfg.attention_multiplier is None
            and ffn % 16 == 0 and 12 * d <= QUANT_SMEM and 8 * ffn <= QUANT_SMEM)


def supported_lanes(cfg, n: int) -> bool:
    """The lanes kernel takes ``n`` lanes: the shapes of :func:`supported`,
    ``1 <= n <= MAX_LANES``, the n staged int8 rows of the widest GEMV input
    (``n * max(d, ffn)`` bytes) within the shared memory a block may opt
    into, and its quantise's three f32 rows of the widest input within
    QUANT_SMEM: ``12 * max(d, ffn)`` bytes (the row, 2K floats for SwiGLU,
    the RMSNorm weight and the row ``llama_quantize_row`` stages), so
    ``max(d, ffn) <= 19,285``. At Orpheus-3B (ffn 8192) that is n <= 28; at
    Llama-3.1-8B (ffn 14,336) n <= 16; Llama-3.1-70B and 405B (ffn 28,672
    and 53,248) are not taken. Its cache is at most LANES_S_MAX rows."""
    kmax = max(cfg.hidden_size, cfg.intermediate_size)
    return (supported(cfg) and 1 <= n <= MAX_LANES and n * kmax <= SMEM_OPT_IN
            and 12 * kmax <= QUANT_SMEM)


def _as_int8(w) -> tuple[torch.Tensor, torch.Tensor]:
    if isinstance(w, quant.Int8Tensor):
        return w.weight, w.scale.to(torch.float32)
    t = quant.quantize_int8(w)
    return t.weight, t.scale


def pack_llama_weights(params: dict, cfg) -> LlamaFusedPack:
    """Pack the stacked layers (``params["model"]["layers"]`` or the layers
    tree itself, leaves ``[L, ...]``, unfused q/k/v and gate/up; w8a8 or
    dense, dense weights are quantized here)."""
    lp = params
    for key in ("model", "layers"):
        if isinstance(lp, dict) and key in lp:
            lp = lp[key]
    if "qkv_proj" in lp["self_attn"] or "gate_up_proj" in lp["mlp"]:
        raise ValueError("pack from the unfused projection tree "
                         "(before llama.fuse_projections)")
    L, d, hd = cfg.num_hidden_layers, cfg.hidden_size, cfg.resolved_head_dim
    ap, mp = lp["self_attn"], lp["mlp"]
    segs, scls = [], []
    for proj in (ap["q_proj"], ap["k_proj"], ap["v_proj"], ap["o_proj"],
                 mp["gate_proj"], mp["up_proj"]):
        w8, s = _as_int8(proj["weight"])
        segs.append(w8)
        scls.append(s)
    down_w8, down_s = _as_int8(mp["down_proj"]["weight"])
    scls.append(down_s)
    dev = down_w8.device
    norms = torch.zeros((L, 4, d), dtype=torch.float32, device=dev)
    norms[:, 0] = lp["input_layernorm"]["weight"].to(torch.float32)
    norms[:, 1] = lp["post_attention_layernorm"]["weight"].to(torch.float32)
    if cfg.qk_norm:
        n_heads, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
        qw = ap["q_norm"]["weight"].to(torch.float32).reshape(L, -1, hd)
        kw = ap["k_norm"]["weight"].to(torch.float32).reshape(L, -1, hd)
        norms[:, 2] = qw.expand(L, n_heads, hd).reshape(L, n_heads * hd)
        norms[:, 3, :n_kv * hd] = kw.expand(L, n_kv, hd).reshape(L, n_kv * hd)
    inv = nn.rope_freqs(hd, cfg.rope_theta, cfg.llama3_scaling, device=dev)
    return LlamaFusedPack(torch.cat(segs, dim=1).contiguous(), down_w8.contiguous(),
                          torch.cat(scls, dim=1).contiguous(), norms.contiguous(),
                          inv.contiguous())


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _gemv(x, w8, scale, tap=None, forced=None):
    """int8(x) @ w8.T with one act scale ``max(max|x|/127, 1e-12)`` (round
    half to even on a true division), exact int products (float64), the
    weight scale times the act scale after the sum. ``tap = (codes,
    scale, pre)`` receives the codes, the scale and (``pre`` may be None)
    the unrounded ``x / scale``; ``forced = (codes, scale)`` are used for
    the product in place of them."""
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
    return acc * (scale * xs)


def _rope(x, ang_cos, ang_sin):
    """Half-split RoPE of ``x [heads, 128]``: ``x cos + roll(x, 64) * sign
    * sin`` with sign -1 on the first half (the TPU kernel's form)."""
    rot = torch.roll(x, 64, dims=-1)
    sign = torch.ones(HEAD_DIM, device=x.device)
    sign[:64] = -1.0
    return x * ang_cos + rot * (sign * ang_sin)


def fused_llama_stack_ref(pack: LlamaFusedPack, kcache, vcache, x: torch.Tensor,
                          offset: int, *, cfg, valid_from: int = 0, tap=None,
                          codes=None):
    """Plain version of :func:`fused_llama_stack` (same signature and
    effects; the caches may be any float dtype). ``tap = (codes [L, 4,
    max(d, ffn)] int8, scales [L, 4] f32[, pre])`` receives each layer's
    four GEMV inputs (q/k/v, o, gate/up, down) as int8 codes and scales
    (and, if ``pre`` of the codes' shape in f32 is given, unrounded).
    ``codes``, a tap of the same layout, supplies the codes and scales the
    GEMVs use in place of this version's own rounding (the tap still
    records its own): a kernel's arithmetic checked past a point where
    the two round an activation differently."""
    d, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dkv, rep, eps = n_kv * HEAD_DIM, H // n_kv, cfg.rms_norm_eps
    sm = 1.0 / math.sqrt(HEAD_DIM)
    ang = float(offset) * torch.cat([pack.inv_freq, pack.inv_freq])
    cos, sin = torch.cos(ang), torch.sin(ang)
    n = offset + 1 - valid_from
    resid = x.to(torch.float32).clone()
    newk, newv = [], []
    o_q, o_o, o_g = d + 2 * dkv, 2 * d + 2 * dkv, 2 * d + 2 * dkv + 2 * ffn
    for li in range(L):
        w, sc, nr = pack.w_in[li], pack.scales[li], pack.norms[li]

        def tapped(g):
            return None if tap is None else (
                tap[0][li, g], tap[1][li, g],
                None if len(tap) < 3 or tap[2] is None else tap[2][li, g])

        def gemv(v, w8, scale, g):
            return _gemv(v, w8, scale, tapped(g),
                         None if codes is None else (codes[0][li, g], codes[1][li, g]))

        qkv = gemv(_rms(resid, nr[0], eps), w[:o_q], sc[:o_q], 0)
        q = qkv[:d].reshape(H, HEAD_DIM)
        k = qkv[d:d + dkv].reshape(n_kv, HEAD_DIM)
        v = qkv[d + dkv:]
        if cfg.qk_norm:
            q = _rms(q, nr[2].reshape(H, HEAD_DIM), eps)
            k = _rms(k, nr[3, :dkv].reshape(n_kv, HEAD_DIM), eps)
        q = _rope(q, cos, sin) * sm
        k = _rope(k, cos, sin).reshape(dkv)
        K = kcache[li, valid_from:offset + 1].to(torch.float32)
        V = vcache[li, valid_from:offset + 1].to(torch.float32)
        K[n - 1], V[n - 1] = k, v
        # query head g * rep + r reads K/V head g
        s = (K.reshape(n, n_kv, 1, HEAD_DIM) * q.reshape(n_kv, rep, HEAD_DIM)).sum(-1)
        p = torch.exp(s - s.amax(0))
        p = p / p.sum(0)
        att = (p[..., None] * V.reshape(n, n_kv, 1, HEAD_DIM)).sum(0).reshape(d)
        kcache[li, offset] = k.to(kcache.dtype)
        vcache[li, offset] = v.to(vcache.dtype)
        newk.append(k)
        newv.append(v)
        resid = resid + gemv(att, w[o_q:o_o], sc[o_q:o_o], 1)

        gu = gemv(_rms(resid, nr[1], eps), w[o_o:o_g], sc[o_o:o_g], 2)
        g, u = gu[:ffn], gu[ffn:]
        h = g * torch.sigmoid(g) * u
        resid = resid + gemv(h, pack.w_down[li], sc[o_g:], 3)
    return resid, torch.stack(newk), torch.stack(newv)


def _require_pack(pack: LlamaFusedPack, cfg, dev) -> None:
    """Check the pack's devices, dtypes, shapes and contiguity for the CUDA
    kernels."""
    d, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    rows = 2 * d + 2 * cfg.num_key_value_heads * HEAD_DIM + 2 * ffn
    req = _lib.require
    req(pack.w_in, "w_in", torch.int8, (L, rows, d), dev)
    req(pack.w_down, "w_down", torch.int8, (L, d, ffn), dev)
    req(pack.scales, "scales", torch.float32, (L, rows + d), dev)
    req(pack.norms, "norms", torch.float32, (L, 4, d), dev)
    req(pack.inv_freq, "inv_freq", torch.float32, (HEAD_DIM // 2,), dev)


def scratch_layout(L: int, d: int, ffn: int, H: int, n_kv: int, s_max: int) -> dict:
    """The one-token kernel's f32 scratch, as ``csrc/fused_llama.cu`` lays it
    out (its ``Scratch``; :func:`fused_llama_stack` holds the two to each
    other through ``tpa_fused_llama_stack_scratch``): region name -> (start,
    length) in 4-byte words, and ``"total"``. attn [d], h [ffn] (the SwiGLU
    of the gate/up projection), the quantise launch's scale xs (padded to
    4), the split-S attention partials [H, nc, 128] and [H, nc, 2] with nc
    = ceil(s_max / 64) (a call lays out its own live chunks' in their first
    words), then the int32 arrival counters [L, n_kv] of the folded combines
    (one for each layer and KV head), which the wrapper zeroes once a
    call."""
    nc = -(-s_max // _lib.ATTN_CHUNK)
    sizes = (("attn", d), ("h", ffn), ("xs", 4), ("part_o", H * nc * HEAD_DIM),
             ("part_ml", H * nc * 2), ("counts", L * n_kv))
    out, at = {}, 0
    for name, size in sizes:
        out[name] = (at, size)
        at += size
    out["total"] = at
    return out


@functools.lru_cache(maxsize=None)
def _kernel_scratch_layout(L: int, d: int, ffn: int, H: int, n_kv: int, s_max: int) -> dict:
    """:func:`scratch_layout`, held to the kernel's own (raises if the two
    differ: the wrapper would zero the wrong words)."""
    layout = scratch_layout(L, d, ffn, H, n_kv, s_max)
    starts = (ctypes.c_longlong * 7)()
    _lib.check(_lib.lib().tpa_fused_llama_stack_scratch(L, d, ffn, H, n_kv, s_max, starts),
               "fused_llama_stack scratch")
    mine = [start for start, _ in list(layout.values())[:-1]] + [layout["total"]]
    if list(starts) != mine:
        raise RuntimeError(f"fused_llama_stack: scratch layout {mine} differs from the "
                           f"kernel's {list(starts)}")
    return layout


def fused_llama_stack(pack: LlamaFusedPack, kcache, vcache, x: torch.Tensor,
                      offset: int, *, cfg, valid_from: int = 0, tap=None):
    """Run the layer stack for ONE token.

    x: ``[d]`` f32 (the embedded token); kcache/vcache: ``[L, S_max, dkv]``
    bf16 position-major, K rows after RoPE, rows ``valid_from..offset-1``
    attended (the rows below ``valid_from`` are left padding). Writes the
    new k/v rows into the caches at ``offset`` and returns ``(y [d] f32
    before the final norm, newk [L, dkv] f32, newv [L, dkv] f32)``.
    ``tap = (codes, scales)``, int8 ``[L, 4, max(d, ffn)]`` and f32
    ``[L, 4]``, receives every GEMV input's int8 codes and scale, for
    checking the rounding against the plain version. The plain version
    runs for CPU tensors, the CUDA kernels for CUDA tensors: 9 launches a
    layer (the o projection quantises its own input, the gate/up projection
    writes the SwiGLU), each after the first a programmatic dependent
    launch, after the copy of ``x`` and the zeroing
    of the combines' arrival counters. The shapes are :func:`supported`'s;
    the cache may be of any length."""
    if x.device.type == "cpu":
        return fused_llama_stack_ref(pack, kcache, vcache, x, offset, cfg=cfg,
                                     valid_from=valid_from, tap=tap)
    d, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dkv = n_kv * HEAD_DIM
    s_max = kcache.shape[1]
    dev = x.device
    if not supported(cfg):
        raise ValueError("fused_llama_stack: unsupported decoder shape")
    if not 0 <= valid_from <= offset < s_max:
        raise ValueError(f"fused_llama_stack: need 0 <= valid_from ({valid_from}) "
                         f"<= offset ({offset}) < {s_max}")
    req = _lib.require
    req(x, "x", torch.float32, (d,), dev)
    _require_pack(pack, cfg, dev)
    for name, t in (("kcache", kcache), ("vcache", vcache)):
        req(t, name, torch.bfloat16, (L, s_max, dkv), dev)
    kmax = max(d, ffn)
    tap_q = tap_s = 0
    if tap is not None:
        req(tap[0], "tap codes", torch.int8, (L, 4, kmax), dev)
        req(tap[1], "tap scales", torch.float32, (L, 4), dev)
        tap_q, tap_s = tap[0].data_ptr(), tap[1].data_ptr()
    for name, t in (*zip(pack._fields, pack), ("kcache", kcache), ("vcache", vcache)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_llama_stack: {name} is not 16-byte aligned")
    y = x.clone()
    qkv = torch.empty((L, d + 2 * dkv), dtype=torch.float32, device=dev)
    layout = _kernel_scratch_layout(L, d, ffn, H, n_kv, s_max)
    scratch = torch.empty((layout["total"],), dtype=torch.float32, device=dev)
    counts = layout["counts"]
    scratch[counts[0]:counts[0] + counts[1]].zero_()  # int32 zeros: the same bits
    xq = torch.empty((kmax,), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_fused_llama_stack(
            y.data_ptr(), pack.w_in.data_ptr(), pack.w_down.data_ptr(),
            pack.scales.data_ptr(), pack.norms.data_ptr(), pack.inv_freq.data_ptr(),
            kcache.data_ptr(), vcache.data_ptr(), qkv.data_ptr(), scratch.data_ptr(),
            xq.data_ptr(), tap_q, tap_s, L, d, ffn, H, n_kv, s_max, int(offset),
            int(valid_from), int(bool(cfg.qk_norm)), float(cfg.rms_norm_eps),
            _lib.stream(x))
    _lib.check(err, "fused_llama_stack")
    _lib.launches["fused_llama_stack"] += 1
    return y, qkv[:, d:d + dkv], qkv[:, d + dkv:]


def lanes_scratch_layout(n: int, L: int, d: int, ffn: int, H: int, n_kv: int,
                         s_max: int) -> dict:
    """The lanes kernel's f32 scratch, as ``csrc/fused_llama_lanes.cu`` lays
    it out (its ``Scratch``; :func:`fused_llama_stack_lanes` holds the two to
    each other through ``tpa_fused_llama_stack_lanes_scratch``): region name
    -> (start, length) in 4-byte words, and ``"total"``. attn [n, d],
    gate/up [n, 2 ffn], xs [n] padded to a multiple of 4, the split-S
    attention partials [n, H, nc, 128] and [n, H, nc, 2] with nc =
    ceil(s_max / 64), then the int32 arrival counters [L, n_kv, n] of the
    folded combines (one for each layer, KV head and lane), which the
    wrapper zeroes once a call."""
    nc = -(-s_max // _lib.ATTN_CHUNK)
    sizes = (("attn", n * d), ("gu", n * 2 * ffn), ("xs", -(-n // 4) * 4),
             ("part_o", n * H * nc * HEAD_DIM), ("part_ml", n * H * nc * 2),
             ("counts", L * n_kv * n))
    out, at = {}, 0
    for name, size in sizes:
        out[name] = (at, size)
        at += size
    out["total"] = at
    return out


@functools.lru_cache(maxsize=None)
def _kernel_lanes_scratch_layout(n: int, L: int, d: int, ffn: int, H: int, n_kv: int,
                                 s_max: int) -> dict:
    """:func:`lanes_scratch_layout`, held to the kernel's own (raises if the
    two differ: the wrapper would zero the wrong words)."""
    layout = lanes_scratch_layout(n, L, d, ffn, H, n_kv, s_max)
    starts = (ctypes.c_longlong * 7)()
    _lib.check(_lib.lib().tpa_fused_llama_stack_lanes_scratch(n, L, d, ffn, H, n_kv, s_max,
                                                              starts),
               "fused_llama_stack_lanes scratch")
    mine = [start for start, _ in list(layout.values())[:-1]] + [layout["total"]]
    if list(starts) != mine:
        raise RuntimeError(f"fused_llama_stack_lanes: scratch layout {mine} differs from "
                           f"the kernel's {list(starts)}")
    return layout


def fused_llama_stack_lanes_ref(pack: LlamaFusedPack, kcache, vcache, lanes: torch.Tensor,
                                x: torch.Tensor, offsets: torch.Tensor,
                                valid_from: torch.Tensor, *, cfg, tap=None, codes=None):
    """Plain version of :func:`fused_llama_stack_lanes` (same signature and
    effects): each lane through :func:`fused_llama_stack_ref` on its own
    slot, one after another; the lanes are independent, so this computes
    the kernel's function. ``tap`` as the kernel's, with an optional third
    f32 tensor of the codes' shape for the unrounded values; ``codes``, a
    tap of the kernel's layout, supplies each lane's GEMV codes and scales
    (see :func:`fused_llama_stack_ref`)."""
    s_max = kcache.shape[2]
    ys, nks, nvs = [], [], []
    for m, (slot, off, vf) in enumerate(zip(lanes.tolist(), offsets.tolist(),
                                            valid_from.tolist())):
        off = min(max(off, 0), s_max - 1)
        lane_tap = None if tap is None else tuple(
            None if t is None else t[:, :, m] for t in tap)
        lane_codes = None if codes is None else (codes[0][:, :, m], codes[1][:, :, m])
        y, nk, nv = fused_llama_stack_ref(pack, kcache[slot], vcache[slot], x[m], off,
                                          cfg=cfg, valid_from=min(max(vf, 0), off),
                                          tap=lane_tap, codes=lane_codes)
        ys.append(y)
        nks.append(nk)
        nvs.append(nv)
    return torch.stack(ys), torch.stack(nks, dim=1), torch.stack(nvs, dim=1)


def fused_llama_stack_lanes(pack: LlamaFusedPack, kcache, vcache, lanes: torch.Tensor,
                            x: torch.Tensor, offsets: torch.Tensor,
                            valid_from: torch.Tensor, *, cfg, tap=None):
    """Run the layer stack for ONE token on EACH of n lanes, with one sweep
    of the weights shared by all of them.

    kcache/vcache: the engine's stacked ``[slots, L, S_max, dkv]`` bf16
    position-major caches (K after RoPE); lanes, offsets and valid_from:
    ``[n]`` int64 on x's device, lane m's slot (distinct slots), write
    position and first attended row (the rows below it are left padding);
    x: ``[n, d]`` f32 embedded tokens. Each activation row gets its own
    int8 scale, so lane m's outputs are those of :func:`fused_llama_stack`
    on its own inputs. An offset outside ``[0, S_max)`` is clamped to it.
    Writes each lane's new k/v rows into its slot at its offset (other
    slots and rows stay untouched) and returns ``(y [n, d] f32 before the
    final norm, newk [L, n, dkv] f32, newv [L, n, dkv] f32)``. Nothing
    here reads a device value on the host. ``tap = (codes, scales)``, int8
    ``[L, 4, n, max(d, ffn)]`` and f32 ``[L, 4, n]``, receives every GEMV
    input's int8 codes and scale. The plain version runs for CPU tensors,
    the CUDA kernels for CUDA tensors: 10 launches a layer, each after the
    first (and after a tap's copies) a programmatic dependent launch, after
    the copy of ``x`` and the zeroing of the combines' arrival counters.
    The shapes and lane counts are :func:`supported_lanes`'; the attention's
    combine keeps a head's partials over the whole cache in shared memory,
    so ``S_max`` is at most LANES_S_MAX."""
    if x.device.type == "cpu":
        return fused_llama_stack_lanes_ref(pack, kcache, vcache, lanes, x, offsets,
                                           valid_from, cfg=cfg, tap=tap)
    d, ffn, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    H, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dkv = n_kv * HEAD_DIM
    n = x.shape[0]
    slots, s_max = kcache.shape[0], kcache.shape[2]
    dev = x.device
    if not supported_lanes(cfg, n):
        raise ValueError(f"fused_llama_stack_lanes: unsupported decoder shape or n={n}")
    if n > slots:
        raise ValueError(f"fused_llama_stack_lanes: {n} lanes over {slots} slots")
    if s_max > LANES_S_MAX:
        raise ValueError(f"fused_llama_stack_lanes: a cache of {s_max} rows; the kernel "
                         f"takes at most {LANES_S_MAX}")
    req = _lib.require
    req(x, "x", torch.float32, (n, d), dev)
    for name, t in (("lanes", lanes), ("offsets", offsets), ("valid_from", valid_from)):
        req(t, name, torch.int64, (n,), dev)
    _require_pack(pack, cfg, dev)
    for name, t in (("kcache", kcache), ("vcache", vcache)):
        req(t, name, torch.bfloat16, (slots, L, s_max, dkv), dev)
    kmax = max(d, ffn)
    tap_q = tap_s = 0
    if tap is not None:
        req(tap[0], "tap codes", torch.int8, (L, 4, n, kmax), dev)
        req(tap[1], "tap scales", torch.float32, (L, 4, n), dev)
        tap_q, tap_s = tap[0].data_ptr(), tap[1].data_ptr()
    for name, t in (*zip(pack._fields, pack), ("kcache", kcache), ("vcache", vcache)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_llama_stack_lanes: {name} is not 16-byte aligned")
    y = x.clone()
    qkv = torch.empty((L, n, d + 2 * dkv), dtype=torch.float32, device=dev)
    layout = _kernel_lanes_scratch_layout(n, L, d, ffn, H, n_kv, s_max)
    scratch = torch.empty((layout["total"],), dtype=torch.float32, device=dev)
    counts = layout["counts"]
    scratch[counts[0]:counts[0] + counts[1]].zero_()  # int32 zeros: the same bits
    xq = torch.empty((n * kmax,), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lib().tpa_fused_llama_stack_lanes(
            y.data_ptr(), offsets.data_ptr(), valid_from.data_ptr(), lanes.data_ptr(),
            pack.w_in.data_ptr(), pack.w_down.data_ptr(), pack.scales.data_ptr(),
            pack.norms.data_ptr(), pack.inv_freq.data_ptr(), kcache.data_ptr(),
            vcache.data_ptr(), qkv.data_ptr(), scratch.data_ptr(), xq.data_ptr(), tap_q,
            tap_s, n, L, d, ffn, H, n_kv, s_max, int(bool(cfg.qk_norm)),
            float(cfg.rms_norm_eps), _lib.stream(x))
    _lib.check(err, "fused_llama_stack_lanes")
    _lib.launches["fused_llama_stack_lanes"] += 1
    return y, qkv[:, :, d:d + dkv], qkv[:, :, d + dkv:]
