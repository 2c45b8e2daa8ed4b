"""Mimi: SEANet conv encoder/decoder, a windowed-RoPE transformer and a
split residual VQ, offline and step by step (port of
tpu_audio.codecs.mimi).

24 kHz audio on a 12.5 Hz frame grid: SEANet ratios (8, 6, 5, 4) with
causal streamable convolutions, a projected transformer (pre-LN, layer
scales, interleaved RoPE, a 250-frame context) before the downsample to
the frame rate and after the depthwise upsample from it, and a split
residual VQ (one semantic codebook, then the acoustic rest) over EMA
codebooks (``embedding_sum / cluster_usage``).

Activations are channels-last ``[B, T, C]`` as in the JAX package. The
``*_step`` methods carry their state in dicts (the streamable convolutions'
unconsumed input, the transposed convolutions' overlap-add tails, the
residual adds' unaligned rest) and a KV cache of :data:`STREAM_CACHE_LEN`
positions for each transformer. Past that many positions a step raises:
the JAX package's cache write clamps there and its output goes wrong
without a word.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from tpu_audio_torch.codecs import AudioCodecModel
from tpu_audio_torch.core import hub, kv_cache, loading, nn

__all__ = ["Mimi", "MimiConfig", "MimiStreamingDecoder", "SeanetConfig", "TransformerConfig",
           "mimi_202407", "encode_forward", "transformer_forward", "quantizer_encode",
           "quantizer_decode", "sanitize", "init_random_params", "STREAM_CACHE_LEN"]

STREAM_CACHE_LEN = 2048  # positions of each transformer's KV cache when streaming


@dataclass
class SeanetConfig:
    dimension: int = 512
    channels: int = 1
    causal: bool = True
    nfilters: int = 64
    nresidual_layers: int = 1
    ratios: tuple = (8, 6, 5, 4)
    ksize: int = 7
    residual_ksize: int = 3
    last_ksize: int = 3
    dilation_base: int = 2
    compress: int = 2


@dataclass
class TransformerConfig:
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    layer_scale: float = 0.01
    context: int = 250
    max_period: float = 10000.0
    dim_feedforward: int = 2048

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass
class MimiConfig:
    channels: int = 1
    sample_rate: int = 24000
    frame_rate: float = 12.5
    seanet: SeanetConfig = field(default_factory=SeanetConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    quantizer_nq: int = 16
    quantizer_bins: int = 2048
    quantizer_dim: int = 256

    @property
    def downsample_stride(self) -> int:
        enc_fps = self.sample_rate / int(np.prod(self.seanet.ratios))
        return int(enc_fps / self.frame_rate)

    @classmethod
    def from_dict(cls, d: dict) -> "MimiConfig":
        cfg = mimi_202407(d.get("num_codebooks", d.get("num_quantizers", 16)))
        if "sampling_rate" in d:
            cfg.sample_rate = d["sampling_rate"]
        if "frame_rate" in d:
            cfg.frame_rate = d["frame_rate"]
        if "quantizer_dim" in d:
            cfg.quantizer_dim = d["quantizer_dim"]
        if "quantizer_bins" in d:
            cfg.quantizer_bins = d["quantizer_bins"]
        for sub, sub_cls in (("seanet", SeanetConfig), ("transformer", TransformerConfig)):
            if sub in d:
                keys = set(sub_cls.__dataclass_fields__)
                kw = {k: v for k, v in d[sub].items() if k in keys}
                if "ratios" in kw:
                    kw["ratios"] = tuple(kw["ratios"])
                setattr(cfg, sub, sub_cls(**kw))
        return cfg


def mimi_202407(num_codebooks: int = 16) -> MimiConfig:
    """The kyutai mimi-202407 architecture."""
    return MimiConfig(quantizer_nq=num_codebooks)


# -- streamable convolutions (channels-last) -----------------------------------------


def _extra_pad(length, k_eff, stride, pad_total):
    n_frames = max(length + pad_total - k_eff, 0) / stride + 1.0
    ideal = (math.ceil(n_frames) - 1) * stride + k_eff - pad_total
    return max(0, ideal - length)


def _pad_time(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad ``[B, T, C]`` along time with zeros, or with the edge rows
    (``mode == "edge"``)."""
    if mode != "edge":
        return F.pad(x, (0, 0, left, right))
    b, _, c = x.shape
    return torch.cat([x[:, :1].expand(b, left, c), x, x[:, -1:].expand(b, right, c)], dim=1)


def s_conv1d(p: dict, x: torch.Tensor, ksize: int, stride: int = 1, dilation: int = 1,
             groups: int = 1, pad_mode: str = "constant") -> torch.Tensor:
    """Causal streamable conv over the whole sequence: ``k_eff - stride``
    rows on the left, and on the right what completes the last frame."""
    k_eff = (ksize - 1) * dilation + 1
    pad_total = k_eff - stride
    extra = _extra_pad(x.shape[1], k_eff, stride, pad_total)
    x = _pad_time(x, pad_total, extra, pad_mode)
    return nn.conv1d(p["conv"]["conv"], x, stride=stride, dilation=dilation, groups=groups)


def s_conv1d_step(p: dict, x: torch.Tensor, state: dict, ksize: int, stride: int = 1,
                  dilation: int = 1, groups: int = 1, pad_mode: str = "constant"):
    """One streaming step; ``state`` holds ``prev`` (the input not yet
    consumed, ``[B, t, C]`` or None) and ``padded`` (the left pad done)."""
    b = x.shape[0]
    k_eff = (ksize - 1) * dilation + 1
    if not state.get("padded"):
        state["padded"] = True
        x = _pad_time(x, k_eff - stride, 0, pad_mode)
    if state.get("prev") is not None:
        x = torch.cat([state["prev"], x], dim=1)
    length = x.shape[1]
    n_frames = max(length + stride - k_eff, 0) // stride
    if n_frames == 0:
        state["prev"] = x
        out_c = p["conv"]["conv"]["weight"].shape[0]
        return x.new_zeros((b, 0, out_c)), state
    offset = n_frames * stride
    state["prev"] = x[:, offset:] if offset < length else None
    in_len = (n_frames - 1) * stride + k_eff
    y = nn.conv1d(p["conv"]["conv"], x[:, :in_len], stride=stride, dilation=dilation,
                  groups=groups)
    return y, state


def s_convtr1d(p: dict, x: torch.Tensor, ksize: int, stride: int,
               groups: int = 1) -> torch.Tensor:
    """Causal streamable transposed conv over the whole sequence: the
    ``ksize - stride`` rows past the end are cut."""
    y = nn.conv_transpose1d(p["convtr"]["convtr"], x, stride=stride, groups=groups)
    trim = max(ksize - stride, 0)
    return y[:, : y.shape[1] - trim] if trim else y


def s_convtr1d_step(p: dict, x: torch.Tensor, state: dict, ksize: int, stride: int,
                    groups: int = 1):
    """Streaming transposed conv: the tail past the valid rows is carried
    and overlap-added into the next step's output, without its bias."""
    pp = p["convtr"]["convtr"]
    y = nn.conv_transpose1d(pp, x, stride=stride, groups=groups)
    if state.get("prev") is not None:
        prev = state["prev"]
        if "bias" in pp:
            prev = prev - pp["bias"].to(prev.dtype)
        pt = prev.shape[1]
        y = torch.cat([y[:, :pt] + prev, y[:, pt:]], dim=1)
    invalid = ksize - stride
    ot = y.shape[1]
    valid = y[:, : max(ot - invalid, 0)]
    state["prev"] = y[:, max(ot - invalid, 0):] if invalid > 0 else None
    return valid, state


# -- SEANet ------------------------------------------------------------------------------


def _resnet_block(p: dict, x: torch.Tensor, cfg: SeanetConfig, dilation: int,
                  step_state: dict | None = None, prefix: str | None = None) -> torch.Tensor:
    h = x
    for i, (k, d) in enumerate(((cfg.residual_ksize, dilation), (1, 1))):
        h = F.elu(h)
        bp = p["block"][str(i)]
        if step_state is None:
            h = s_conv1d(bp, h, k, dilation=d)
        else:
            h, _ = s_conv1d_step(bp, h, step_state.setdefault(f"{prefix}.block.{i}", {}), k,
                                 dilation=d)
    if step_state is None:
        return x + h
    # the streaming residual add: rows of one side wait for the other's
    st = step_state.setdefault(f"{prefix}.add", {"l": None, "r": None})
    left, right = h, x
    if st["l"] is not None:
        left, st["l"] = torch.cat([st["l"], left], dim=1), None
    if st["r"] is not None:
        right, st["r"] = torch.cat([st["r"], right], dim=1), None
    n = min(left.shape[1], right.shape[1])
    if left.shape[1] > n:
        st["l"] = left[:, n:]
    if right.shape[1] > n:
        st["r"] = right[:, n:]
    return left[:, :n] + right[:, :n]


def seanet_encode(p: dict, x: torch.Tensor, cfg: SeanetConfig,
                  state: dict | None = None) -> torch.Tensor:
    """``[B, T, 1]`` -> ``[B, T / prod(ratios), dimension]``."""
    def conv(pp, h, k, stride=1, key=None, pad_mode="constant"):
        if state is None:
            return s_conv1d(pp, h, k, stride=stride, pad_mode=pad_mode)
        return s_conv1d_step(pp, h, state.setdefault(key, {}), k, stride=stride,
                             pad_mode=pad_mode)[0]

    h = conv(p["init_conv1d"], x, cfg.ksize, key="enc.init")
    for li, ratio in enumerate(reversed(cfg.ratios)):
        lp = p["layers"][str(li)]
        dilation = 1
        for ri in range(cfg.nresidual_layers):
            h = _resnet_block(lp["residuals"][str(ri)], h, cfg, dilation, step_state=state,
                              prefix=f"enc.{li}.{ri}")
            dilation *= cfg.dilation_base
        h = F.elu(h)
        h = conv(lp["downsample"], h, ratio * 2, stride=ratio, key=f"enc.{li}.down")
    h = F.elu(h)
    return conv(p["final_conv1d"], h, cfg.last_ksize, key="enc.final")


def seanet_decode(p: dict, z: torch.Tensor, cfg: SeanetConfig,
                  state: dict | None = None) -> torch.Tensor:
    """``[B, T, dimension]`` -> ``[B, T * prod(ratios), channels]``."""
    def conv(pp, h, k, stride=1, key=None):
        if state is None:
            return s_conv1d(pp, h, k, stride=stride)
        return s_conv1d_step(pp, h, state.setdefault(key, {}), k, stride=stride)[0]

    h = conv(p["init_conv1d"], z, cfg.ksize, key="dec.init")
    for li, ratio in enumerate(cfg.ratios):
        lp = p["layers"][str(li)]
        h = F.elu(h)
        if state is None:
            h = s_convtr1d(lp["upsample"], h, ratio * 2, ratio)
        else:
            h, _ = s_convtr1d_step(lp["upsample"], h, state.setdefault(f"dec.{li}.up", {}),
                                   ratio * 2, ratio)
        dilation = 1
        for ri in range(cfg.nresidual_layers):
            h = _resnet_block(lp["residuals"][str(ri)], h, cfg, dilation, step_state=state,
                              prefix=f"dec.{li}.{ri}")
            dilation *= cfg.dilation_base
    h = F.elu(h)
    return conv(p["final_conv1d"], h, cfg.last_ksize, key="dec.final")


# -- the transformer (pre-LN, layer scales, interleaved RoPE, a context window) ------------


def transformer_forward(p: dict, x: torch.Tensor, cfg: TransformerConfig,
                        cache: kv_cache.KVCache | None = None):
    """The projected transformer over ``[B, T, D]`` -> ``(h, cache)``. Each
    row attends causally to the ``context`` rows up to itself; with a
    ``cache`` the new rows follow its ``offset`` (written in place; the
    returned cache's offset is advanced). Raises where the rows would pass
    the cache's end."""
    h = nn.linear(p["input_proj"], x) if "input_proj" in p else x
    b, t, d = h.shape
    n_heads, hd = cfg.num_heads, cfg.head_dim
    offset = cache.offset if cache is not None else 0
    if cache is not None and offset + t > cache.max_len:
        raise ValueError(
            f"Mimi streaming: {offset + t} transformer positions pass the cache's "
            f"{cache.max_len}; call reset_state() to start a new stream")
    positions = offset + torch.arange(t, device=h.device)
    ang = positions[:, None].to(torch.float32) * nn.rope_freqs(
        hd, cfg.max_period, device=h.device)[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    # keys from the first any new row can see: rows before are masked for all
    lo = max(0, offset + 1 - cfg.context) if cache is not None else 0
    key_pos = torch.arange(lo, offset + t, device=h.device)
    mask = ((key_pos[None] <= positions[:, None])
            & (key_pos[None] > positions[:, None] - cfg.context))[None, None]
    for i in range(cfg.num_layers):
        lp = p["transformer"]["layers"][str(i)]
        hn = nn.layer_norm(lp["norm1"], h)
        q, k, v = nn.linear(lp["self_attn"]["in_proj"], hn).chunk(3, dim=-1)
        q, k, v = (z.reshape(b, t, n_heads, hd).transpose(1, 2) for z in (q, k, v))
        q = nn.apply_rope(q, cos, sin, interleaved=True)
        k = nn.apply_rope(k, cos, sin, interleaved=True)
        if cache is not None:
            cache, k, v = kv_cache.update_cache(cache, i, k, v)
            k, v = k[:, :, lo:offset + t], v[:, :, lo:offset + t]
        o = nn.sdpa(q, k, v, mask=mask)
        o = nn.linear(lp["self_attn"]["out_proj"], o.transpose(1, 2).reshape(b, t, d))
        h = h + lp["layer_scale_1"]["scale"].to(h.dtype) * o
        hn = nn.layer_norm(lp["norm2"], h)
        m = nn.linear(lp["gating"]["linear2"], nn.gelu(nn.linear(lp["gating"]["linear1"], hn)))
        h = h + lp["layer_scale_2"]["scale"].to(h.dtype) * m
    if "output_projs" in p and "0" in p["output_projs"]:
        h = nn.linear(p["output_projs"]["0"], h)
    if cache is not None:
        cache = cache._replace(offset=offset + t)
    return h, cache


# -- the quantizer (EMA Euclidean codebooks) ------------------------------------------------


def _codebook_embed(p: dict) -> torch.Tensor:
    if "embedding" in p:
        return p["embedding"]
    return p["embedding_sum"] / torch.clamp(p["cluster_usage"], min=1e-5)[:, None]


def _vq_encode(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The nearest codebook row of each ``x`` row, as
    ``argmin(|e|^2 / 2 - x . e)`` (the JAX package's formula, so that a
    near tie is decided by the same sums)."""
    emb = _codebook_embed(p["codebook"])
    if "project_in" in p:
        x = nn.linear(p["project_in"], x)
    c2 = (emb * emb).sum(-1) / 2
    return torch.argmin(c2 - x @ emb.t(), dim=-1)


def _vq_decode(p: dict, codes: torch.Tensor) -> torch.Tensor:
    emb = _codebook_embed(p["codebook"])
    x = emb[codes.clamp(0, emb.shape[0] - 1)]  # the JAX gather clamps
    if "project_out" in p:
        x = nn.linear(p["project_out"], x)
    return x


def _rvq_encode(p: dict, x: torch.Tensor, n_q: int) -> torch.Tensor:
    codes, residual = [], x
    for i in range(n_q):
        lp = p["vq"]["layers"][str(i)]
        idx = _vq_encode(lp, residual)
        residual = residual - _vq_decode(lp, idx)
        codes.append(idx)
    return torch.stack(codes, dim=1)  # [B, n_q, T]


def _rvq_decode(p: dict, codes: torch.Tensor) -> torch.Tensor:
    out = None
    for i in range(codes.shape[1]):
        q = _vq_decode(p["vq"]["layers"][str(i)], codes[:, i])
        out = q if out is None else out + q
    return out


def quantizer_encode(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x [B, T, D]`` -> codes ``[B, n_q, T]``: the semantic RVQ's codes,
    then the acoustic RVQ's, each over its own input projection of ``x``."""
    def proj(pp, h):
        return nn.conv1d(pp["input_proj"], h) if "input_proj" in pp else h

    first, rest = p["rvq_first"], p.get("rvq_rest")
    codes = [_rvq_encode(first, proj(first, x), len(first["vq"]["layers"]))]
    if rest is not None:
        codes.append(_rvq_encode(rest, proj(rest, x), len(rest["vq"]["layers"])))
    return torch.cat(codes, dim=1)


def quantizer_decode(p: dict, codes: torch.Tensor, nq_semantic: int = 1) -> torch.Tensor:
    """codes ``[B, n_q, T]`` -> ``[B, T, D]``."""
    def proj(pp, h):
        return nn.conv1d(pp["output_proj"], h) if "output_proj" in pp else h

    first = p["rvq_first"]
    out = proj(first, _rvq_decode(first, codes[:, :nq_semantic]))
    if codes.shape[1] > nq_semantic and "rvq_rest" in p:
        out = out + proj(p["rvq_rest"], _rvq_decode(p["rvq_rest"], codes[:, nq_semantic:]))
    return out


def encode_forward(params: dict, x: torch.Tensor, cfg: MimiConfig) -> torch.Tensor:
    """Offline encode, waveform ``[B, T, 1]`` -> codes ``[B, n_q, frames]``;
    shared with the Qwen3 speech tokenizer's encoder
    (``codecs.qwen3_codec.Qwen3CodecEncoder``), whose architecture is
    Mimi's."""
    with nn.f32_convolutions():
        h = seanet_encode(params["encoder"], x, cfg.seanet)
        h, _ = transformer_forward(params["encoder_transformer"], h, cfg.transformer)
        stride = cfg.downsample_stride
        if stride > 1:
            h = s_conv1d(params["downsample"], h, 2 * stride, stride=stride, pad_mode="edge")
        return quantizer_encode(params["quantizer"], h)


# -- the MLX checkpoint layout ------------------------------------------------------------


def sanitize(weights: dict) -> dict:
    """An MLX-converted Mimi checkpoint's keys and layouts to the tree the
    functions above read: the SEANet Sequential indices to named layers,
    conv ``[O, K, I]`` to ``[O, I, K]``, transposed ``[O, K, I]`` to ``[I,
    O, K]`` and the depthwise transposed ``[C, K, 1]`` to ``[C, 1, K]``."""
    enc_idx = {1: 0, 4: 1, 7: 2, 10: 3}
    out = {}
    for raw_k, v in weights.items():
        k = ".".join(seg[1:] if seg.startswith("_") else seg for seg in raw_k.split("."))
        k = k.replace("encoder.model.", "encoder.").replace("decoder.model.", "decoder.")
        k = k.replace(".in_proj_weight", ".in_proj.weight")
        for a, b in (("linear1", "gating.linear1"), ("linear2", "gating.linear2")):
            if f".{a}.weight" in k and "gating" not in k:
                k = k.replace(f".{a}.", f".{b}.")
        for li, dec in enumerate((2, 5, 8, 11)):
            k = k.replace(f"decoder.{dec}.", f"decoder.layers.{li}.upsample.")
            k = k.replace(f"decoder.{dec + 1}.", f"decoder.layers.{li}.residuals.0.")
        k = k.replace("decoder.0.", "decoder.init_conv1d.")
        k = k.replace("decoder.14.", "decoder.final_conv1d.")
        for src, li in enc_idx.items():
            k = k.replace(f"encoder.{src}.", f"encoder.layers.{li}.residuals.0.")
            k = k.replace(f"encoder.{src + 2}.", f"encoder.layers.{li}.downsample.")
        k = k.replace("encoder.0.", "encoder.init_conv1d.")
        k = k.replace("encoder.14.", "encoder.final_conv1d.")
        if k.endswith(".weight") and v.ndim == 3:
            if "convtr" in k or "upsample" in k:
                if v.shape[2] == 1 and v.shape[0] > 1:  # depthwise [C, K, 1]
                    v = v.permute(0, 2, 1)
                else:
                    v = v.permute(2, 0, 1)
            else:
                v = v.permute(0, 2, 1)
        out[k] = v.contiguous()
    return out


def init_random_params(cfg: MimiConfig, seed: int = 0, dtype=torch.float32,
                       device=None) -> dict:
    """Random Mimi params in the sanitized tree's layout, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed + 41``:
    convolutions N(0, 1/sqrt(fan-in)) with N(0, 0.01) biases, transformer
    weights N(0, 0.02), unit norms, layer scales ``layer_scale``, EMA
    codebooks whose ``embedding_sum`` rows are N(0, 1) times a
    ``cluster_usage`` drawn from [0.5, 4) (so the division counts)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed + 41)

    def rand(*shape, scale):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale

    def conv(o, i, k, bias=True, transpose=False):
        p = {"weight": rand(*((i, o, k) if transpose else (o, i, k)),
                            scale=1.0 / math.sqrt(i * k))}
        if bias:
            p["bias"] = rand(o, scale=0.01)
        return p

    sc, tc = cfg.seanet, cfg.transformer
    D = tc.d_model

    def res_block(dim):
        hidden = dim // sc.compress
        return {"block": {"0": {"conv": {"conv": conv(hidden, dim, sc.residual_ksize)}},
                          "1": {"conv": {"conv": conv(dim, hidden, 1)}}}}

    enc = {"init_conv1d": {"conv": {"conv": conv(sc.nfilters, sc.channels, sc.ksize)}},
           "layers": {}}
    mult = 1
    for li, ratio in enumerate(reversed(sc.ratios)):
        dim = mult * sc.nfilters
        enc["layers"][str(li)] = {
            "residuals": {str(r): res_block(dim) for r in range(sc.nresidual_layers)},
            "downsample": {"conv": {"conv": conv(2 * dim, dim, 2 * ratio)}}}
        mult *= 2
    enc["final_conv1d"] = {"conv": {"conv": conv(sc.dimension, mult * sc.nfilters,
                                                 sc.last_ksize)}}
    dec = {"init_conv1d": {"conv": {"conv": conv(mult * sc.nfilters, sc.dimension, sc.ksize)}},
           "layers": {}}
    for li, ratio in enumerate(sc.ratios):
        dim = mult * sc.nfilters
        dec["layers"][str(li)] = {
            "upsample": {"convtr": {"convtr": conv(dim // 2, dim, 2 * ratio, transpose=True)}},
            "residuals": {str(r): res_block(dim // 2) for r in range(sc.nresidual_layers)}}
        mult //= 2
    dec["final_conv1d"] = {"conv": {"conv": conv(sc.channels, sc.nfilters, sc.last_ksize)}}

    def transformer():
        def layer():
            return {"norm1": {"weight": torch.ones(D, dtype=dtype, device=device),
                              "bias": torch.zeros(D, dtype=dtype, device=device)},
                    "norm2": {"weight": torch.ones(D, dtype=dtype, device=device),
                              "bias": torch.zeros(D, dtype=dtype, device=device)},
                    "self_attn": {"in_proj": {"weight": rand(3 * D, D, scale=0.02)},
                                  "out_proj": {"weight": rand(D, D, scale=0.02)}},
                    "gating": {"linear1": {"weight": rand(tc.dim_feedforward, D, scale=0.02)},
                               "linear2": {"weight": rand(D, tc.dim_feedforward, scale=0.02)}},
                    "layer_scale_1": {"scale": torch.full((D,), tc.layer_scale, dtype=dtype,
                                                          device=device)},
                    "layer_scale_2": {"scale": torch.full((D,), tc.layer_scale, dtype=dtype,
                                                          device=device)}}

        return {"transformer": {"layers": {str(i): layer() for i in range(tc.num_layers)}}}

    def codebook():
        usage = 0.5 + 3.5 * torch.rand((cfg.quantizer_bins,), generator=gen, device=device,
                                       dtype=dtype)
        return {"codebook": {"embedding_sum": rand(cfg.quantizer_bins, cfg.quantizer_dim,
                                                   scale=1.0) * usage[:, None],
                             "cluster_usage": usage}}

    def rvq(n):
        return {"input_proj": {"weight": rand(cfg.quantizer_dim, D, 1, scale=1.0 / math.sqrt(D))},
                "output_proj": {"weight": rand(D, cfg.quantizer_dim, 1,
                                               scale=1.0 / math.sqrt(cfg.quantizer_dim))},
                "vq": {"layers": {str(i): codebook() for i in range(n)}}}

    stride = cfg.downsample_stride
    return {"encoder": enc, "decoder": dec,
            "encoder_transformer": transformer(), "decoder_transformer": transformer(),
            "downsample": {"conv": {"conv": conv(D, D, 2 * stride, bias=False)}},
            "upsample": {"convtr": {"convtr": {"weight": rand(D, 1, 2 * stride,
                                                              scale=1.0 / math.sqrt(2 * stride))}}},
            "quantizer": {"rvq_first": rvq(1), "rvq_rest": rvq(cfg.quantizer_nq - 1)}}


# -- the codec ----------------------------------------------------------------------------


class Mimi(AudioCodecModel):
    """Offline :meth:`encode` / :meth:`decode` and the streaming
    :meth:`encode_step` / :meth:`decode_step` (state reset by
    :meth:`reset_state`). Codes and waveforms come back as tensors on the
    codec's device; the convolutions run in full f32."""

    def __init__(self, config: MimiConfig, params: dict, dtype=torch.float32, device=None):
        self.config = config
        self.params = loading.to_device(params, device) if device is not None else params
        self.sample_rate = config.sample_rate
        self.dtype = dtype
        self._enc_state = None
        self._dec_state = None
        self._enc_cache = None
        self._dec_cache = None

    @property
    def device(self) -> torch.device:
        return self.params["encoder"]["init_conv1d"]["conv"]["conv"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, num_codebooks: int = 16,
                        dtype=torch.float32, device="cuda") -> "Mimi":
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir) if (model_dir / "config.json").exists() else {}
        cfg_dict.setdefault("num_codebooks", num_codebooks)
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        return cls(MimiConfig.from_dict(cfg_dict), params, dtype, device)

    def _audio(self, audio) -> torch.Tensor:
        """``[T]`` or ``[B, T]`` -> ``[B, T, 1]`` on the device."""
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        x = audio.to(self.device, self.dtype)
        return (x[None] if x.ndim == 1 else x)[..., None]

    def _codes(self, codes) -> torch.Tensor:
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.asarray(codes, np.int64))
        return codes.to(self.device, torch.int64)

    # -- offline -------------------------------------------------------------------------

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """Waveform ``[B, T]`` or ``[T]`` -> codes ``[B, n_q, frames]``."""
        return encode_forward(self.params, self._audio(audio), self.config)

    @torch.inference_mode()
    def decode(self, codes) -> torch.Tensor:
        """Codes ``[B, n_q, frames]`` -> waveform ``[B, T]``."""
        p = self.params
        with nn.f32_convolutions():
            h = quantizer_decode(p["quantizer"], self._codes(codes))
            stride = self.config.downsample_stride
            h = s_convtr1d(p["upsample"], h, 2 * stride, stride, groups=h.shape[-1])
            h, _ = transformer_forward(p["decoder_transformer"], h, self.config.transformer)
            return seanet_decode(p["decoder"], h, self.config.seanet)[..., 0]

    # -- streaming -----------------------------------------------------------------------

    def reset_state(self) -> None:
        self._enc_state, self._dec_state = {}, {}
        tc = self.config.transformer
        self._enc_cache, self._dec_cache = (
            kv_cache.init_cache(tc.num_layers, 1, tc.num_heads, tc.head_dim, STREAM_CACHE_LEN,
                                self.dtype, self.device) for _ in range(2))

    @torch.inference_mode()
    def decode_step(self, codes) -> torch.Tensor:
        """The waveform of new frames ``[B, n_q, t]``, as far as the
        transposed convolutions' tails allow."""
        if self._dec_state is None:
            self.reset_state()
        p = self.params
        codes = self._codes(codes)
        with nn.f32_convolutions():
            h = quantizer_decode(p["quantizer"], codes)
            stride = self.config.downsample_stride
            h, _ = s_convtr1d_step(p["upsample"], h, self._dec_state.setdefault("upsample", {}),
                                   2 * stride, stride, groups=h.shape[-1])
            if h.shape[1] == 0:
                return h.new_zeros((codes.shape[0], 0))
            h, self._dec_cache = transformer_forward(p["decoder_transformer"], h,
                                                     self.config.transformer, self._dec_cache)
            return seanet_decode(p["decoder"], h, self.config.seanet,
                                 state=self._dec_state)[..., 0]

    @torch.inference_mode()
    def encode_step(self, audio) -> torch.Tensor:
        """The codes ``[B, n_q, t]`` of the whole frames that new samples
        ``[B, t]`` complete."""
        if self._enc_state is None:
            self.reset_state()
        p = self.params
        x = self._audio(audio)
        empty = torch.zeros((x.shape[0], self.config.quantizer_nq, 0), dtype=torch.int64,
                            device=x.device)
        with nn.f32_convolutions():
            h = seanet_encode(p["encoder"], x, self.config.seanet, state=self._enc_state)
            if h.shape[1] == 0:
                return empty
            h, self._enc_cache = transformer_forward(p["encoder_transformer"], h,
                                                     self.config.transformer, self._enc_cache)
            stride = self.config.downsample_stride
            h, _ = s_conv1d_step(p["downsample"], h, self._enc_state.setdefault("downsample", {}),
                                 2 * stride, stride=stride, pad_mode="edge")
            if h.shape[1] == 0:
                return empty
            return quantizer_encode(p["quantizer"], h)


class MimiStreamingDecoder:
    """Frame-by-frame streaming decode over a :class:`Mimi`."""

    def __init__(self, mimi: Mimi):
        self.mimi = mimi
        self.reset()

    def reset(self) -> None:
        self.mimi.reset_state()

    def decode_frames(self, tokens) -> np.ndarray:
        """Codes ``[B, n_q, t]`` -> the new samples ``[B, t_samples]``."""
        return self.mimi.decode_step(tokens).to(torch.float32).cpu().numpy()
