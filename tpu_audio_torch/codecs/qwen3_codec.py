"""Qwen3-TTS speech tokenizer decoder: split RVQ -> causal conv /
transformer token-to-waveform stack with true streaming decode (port of
the decoder half of tpu_audio.codecs.qwen3_codec).

Split residual VQ decode, causal convolutions and transposed
convolutions with explicit stream state, SnakeBeta, ConvNeXt upsample
blocks, an 8-layer pre-transformer with layer scale and RoPE, and the
BigVGAN-style causal decoder stack. Public functions keep the JAX
package's channels-last ``[B, T, C]`` layout (``core.nn``'s convolutions
transpose for ``F.conv1d`` inside).

The streaming state is a dict of conv history buffers, transposed-conv
overlap tails (carried without the bias, so that chunked decode equals
the whole-sequence decode) and a KV cache for the pre-transformer, written
in place chunk by chunk. It is consumed in the order in which
:func:`init_streaming_state` builds it.

The encoder half (:class:`Qwen3CodecEncoder`, reference-audio cloning) is
Mimi's encoder (``codecs.mimi.encode_forward``): only its config keys and
the HF checkpoint's weight names are Qwen3's own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_audio_torch.core import hub, kv_cache, loading, nn

__all__ = ["Qwen3CodecDecoderConfig", "Qwen3CodecDecoder", "quantizer_decode",
           "causal_conv", "causal_conv_step", "causal_convt", "causal_convt_step",
           "snake_beta", "decoder_forward", "init_streaming_state", "init_random_params",
           "encoder_config_from_dict", "sanitize_encoder", "Qwen3CodecEncoder",
           "init_random_encoder_params"]

RESIDUAL_DILATIONS = (1, 3, 9)


@dataclass
class Qwen3CodecDecoderConfig:
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8000
    attention_bias: bool = False
    latent_dim: int = 1024
    codebook_dim: int = 512
    codebook_size: int = 2048
    decoder_dim: int = 1536
    num_quantizers: int = 16
    num_semantic_quantizers: int = 1
    upsample_rates: tuple = (8, 5, 4, 3)
    upsampling_ratios: tuple = (2, 2)
    layer_scale_initial_scale: float = 0.01
    sampling_rate: int = 24000

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates)) * int(np.prod(self.upsampling_ratios))

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3CodecDecoderConfig":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        for k in ("upsample_rates", "upsampling_ratios"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)


# -- RVQ decode -----------------------------------------------------------------


def _codebook_embed(p: dict) -> torch.Tensor:
    if "embed" in p:
        return p["embed"]
    if "embedding" in p:
        return p["embedding"]
    # EMA codebooks store sums and usage counts
    return p["embedding_sum"] / torch.clamp(p["cluster_usage"], min=1e-5)[:, None]


def _rvq_decode(p: dict, codes: torch.Tensor, n_q: int) -> torch.Tensor:
    """codes ``[B, n_q, T]`` -> latent ``[B, T, dim]`` for one residual VQ
    (1x1 conv output projection in torch layout). A code past the codebook
    reads its last row, as the JAX package's gather clamps it."""
    total = None
    for i in range(n_q):
        lp = p["vq"]["layers"][str(i)]
        table = _codebook_embed(lp["codebook"])
        emb = table[codes[:, i].clamp(0, table.shape[0] - 1)]  # [B, T, cb_dim]
        if "project_out" in lp:
            emb = nn.linear(lp["project_out"], emb)
        total = emb if total is None else total + emb
    if "output_proj" in p:
        total = nn.conv1d(p["output_proj"], total)
    return total


def quantizer_decode(p: dict, codes: torch.Tensor, cfg: Qwen3CodecDecoderConfig
                     ) -> torch.Tensor:
    """Split RVQ: the first ``num_semantic_quantizers`` and the rest,
    summed. codes ``[B, n_q, T]`` -> ``[B, T, codebook_dim]``."""
    ns = cfg.num_semantic_quantizers
    out = _rvq_decode(p["rvq_first"], codes[:, :ns], ns)
    if codes.shape[1] > ns:
        out = out + _rvq_decode(p["rvq_rest"], codes[:, ns:], codes.shape[1] - ns)
    return out


# -- causal conv primitives with explicit stream state ---------------------------


def causal_conv(p: dict, x: torch.Tensor, kernel: int, dilation: int = 1,
                groups: int = 1) -> torch.Tensor:
    """Whole-sequence causal conv on ``[B, T, C]`` (left pad ``(k-1)*d``)."""
    pad = (kernel - 1) * dilation
    x = torch.nn.functional.pad(x, (0, 0, pad, 0))
    return nn.conv1d(p, x, dilation=dilation, groups=groups)


def causal_conv_step(p: dict, x: torch.Tensor, buf: torch.Tensor, kernel: int,
                     dilation: int = 1, groups: int = 1):
    """Streaming causal conv: ``buf`` holds the last ``(k-1)*d`` inputs.
    Returns the output and the next buffer."""
    h = torch.cat([buf, x], dim=1)
    y = nn.conv1d(p, h, dilation=dilation, groups=groups)
    pad = (kernel - 1) * dilation
    return y, h[:, h.shape[1] - pad:]


def causal_conv_state(batch: int, channels: int, kernel: int, dilation: int = 1,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((batch, (kernel - 1) * dilation, channels), dtype=dtype,
                       device=device)


def causal_convt(p: dict, x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Causal transposed conv: the full transposed conv, then ``k - stride``
    samples cut from the right."""
    y = nn.conv_transpose1d(p, x, stride=stride)
    trim = kernel - stride
    return y[:, : y.shape[1] - trim] if trim > 0 else y


def causal_convt_step(p: dict, x: torch.Tensor, overflow: torch.Tensor, kernel: int,
                      stride: int):
    """Streaming transposed conv with an overlap-add tail. The carried tail
    excludes the bias, so the overlapped positions count it once, as the
    whole-sequence decode does."""
    y = nn.conv_transpose1d(p, x, stride=stride)  # [B, t * s + trim, C]
    trim = kernel - stride
    if trim == 0:
        return y, overflow
    n = overflow.shape[1]
    y = torch.cat([y[:, :n] + overflow, y[:, n:]], dim=1)
    emit, new_overflow = y[:, : y.shape[1] - trim], y[:, y.shape[1] - trim:]
    if "bias" in p:
        new_overflow = new_overflow - p["bias"].to(y.dtype)
    return emit, new_overflow


def snake_beta(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x + sin^2(x * e^alpha) / (e^beta + 1e-9)``, per channel."""
    a = torch.exp(p["alpha"]).to(x.dtype)
    b = torch.exp(p["beta"]).to(x.dtype)
    s = torch.sin(x * a)
    return x + (1.0 / (b + 1e-9)) * s * s


# -- ConvNeXt and residual units -------------------------------------------------


def _convnext(p: dict, x: torch.Tensor, state=None):
    res = x
    if state is None:
        h = causal_conv(p["dwconv"]["conv"], x, 7, groups=x.shape[-1])
    else:
        h, state = causal_conv_step(p["dwconv"]["conv"], x, state, 7, groups=x.shape[-1])
    h = nn.layer_norm(p["norm"], h, eps=1e-6)
    h = nn.gelu(nn.linear(p["pwconv1"], h))
    h = p["gamma"].to(h.dtype) * nn.linear(p["pwconv2"], h)
    return res + h, state


def _residual_unit(p: dict, x: torch.Tensor, dilation: int, state=None):
    h = snake_beta(p["act1"], x)
    if state is None:
        h = causal_conv(p["conv1"]["conv"], h, 7, dilation=dilation)
    else:
        h, state = causal_conv_step(p["conv1"]["conv"], h, state, 7, dilation=dilation)
    h = snake_beta(p["act2"], h)
    h = causal_conv(p["conv2"]["conv"], h, 1)  # kernel 1: no state
    return x + h, state


# -- pre-transformer ----------------------------------------------------------------


def _decoder_transformer(p: dict, x: torch.Tensor, cfg: Qwen3CodecDecoderConfig,
                         cache: kv_cache.KVCache | None = None):
    """Pre-transformer over ``[B, T, H]``: causal over the sequence, or
    over the cache's positions and the new ones (the cache is written in
    place and its offset advanced)."""
    h = nn.linear(p["input_proj"], x)
    b, t, _ = h.shape
    offset = cache.offset if cache is not None else 0
    positions = offset + torch.arange(t, device=h.device)
    ang = positions[:, None].to(torch.float32) * nn.rope_freqs(
        cfg.head_dim, cfg.rope_theta, device=h.device)[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    n_heads, n_kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    mask = kv_cache.attention_mask(cache, t) if cache is not None else None
    for i in range(cfg.num_hidden_layers):
        lp = p["layers"][str(i)]
        hn = nn.rms_norm(lp["input_layernorm"], h, cfg.rms_norm_eps)
        ap = lp["self_attn"]
        q = nn.linear(ap["q_proj"], hn).reshape(b, t, n_heads, hd).transpose(1, 2)
        k = nn.linear(ap["k_proj"], hn).reshape(b, t, n_kv, hd).transpose(1, 2)
        v = nn.linear(ap["v_proj"], hn).reshape(b, t, n_kv, hd).transpose(1, 2)
        q = nn.apply_rope(q, cos, sin)
        k = nn.apply_rope(k, cos, sin)
        if cache is not None:
            cache, k_full, v_full = kv_cache.update_cache(cache, i, k, v)
            o = nn.sdpa(q, k_full, v_full, mask=mask)
        else:
            o = nn.sdpa(q, k, v, is_causal=True)
        o = nn.linear(ap["o_proj"], o.transpose(1, 2).reshape(b, t, n_heads * hd))
        h = h + lp["self_attn_layer_scale"]["scale"].to(h.dtype) * o
        m = nn.rms_norm(lp["post_attention_layernorm"], h, cfg.rms_norm_eps)
        mp = lp["mlp"]
        m = nn.linear(mp["down_proj"],
                      nn.silu(nn.linear(mp["gate_proj"], m)) * nn.linear(mp["up_proj"], m))
        h = h + lp["mlp_layer_scale"]["scale"].to(h.dtype) * m
    h = nn.rms_norm(p["norm"], h, cfg.rms_norm_eps)
    out = nn.linear(p["output_proj"], h)
    if cache is not None:
        cache = cache._replace(offset=cache.offset + t)
    return out, cache


# -- the decoder ---------------------------------------------------------------------


def decoder_forward(params: dict, codes: torch.Tensor, cfg: Qwen3CodecDecoderConfig,
                    state: dict | None = None):
    """codes ``[B, n_q, T]`` -> waveform ``[B, T * total_upsample]`` in
    [-1, 1]. With ``state`` (from :func:`init_streaming_state`) this is one
    streaming step: every causal conv reads and rewrites its buffer in
    ``state``, and the result is ``(waveform, state)``."""
    p = params
    streaming = state is not None
    hidden = quantizer_decode(p["quantizer"], codes, cfg)  # [B, T, codebook_dim]
    si = 0

    def conv_full_or_step(pp, x, kernel, dilation=1, groups=1):
        nonlocal si
        if not streaming:
            return causal_conv(pp, x, kernel, dilation, groups)
        y, state["convs"][si] = causal_conv_step(pp, x, state["convs"][si], kernel,
                                                 dilation, groups)
        si += 1
        return y

    # the convs' buffers are consumed in the order init_streaming_state builds them
    hidden = conv_full_or_step(p["pre_conv"]["conv"], hidden, 3)
    if streaming:
        hidden, state["cache"] = _decoder_transformer(p["pre_transformer"], hidden, cfg,
                                                      state["cache"])
    else:
        hidden, _ = _decoder_transformer(p["pre_transformer"], hidden, cfg)

    for u, factor in enumerate(cfg.upsampling_ratios):
        up = p["upsample"][str(u)]
        hidden = causal_convt(up["conv_t"]["conv"], hidden, factor, factor)
        if streaming:
            hidden, state["convnext"][u] = _convnext(up["convnext"], hidden,
                                                     state["convnext"][u])
        else:
            hidden, _ = _convnext(up["convnext"], hidden)

    d = p["decoder"]
    wav = conv_full_or_step(d["0"]["conv"], hidden, 7)
    n_blocks = len(cfg.upsample_rates)
    for bidx, rate in enumerate(cfg.upsample_rates):
        bp = d[str(1 + bidx)]["block"]
        wav = snake_beta(bp["0"], wav)
        if streaming:
            wav, state["overflow"][bidx] = causal_convt_step(
                bp["1"]["conv"], wav, state["overflow"][bidx], 2 * rate, rate)
        else:
            wav = causal_convt(bp["1"]["conv"], wav, 2 * rate, rate)
        for j, dil in enumerate(RESIDUAL_DILATIONS):
            rp = bp[str(2 + j)]
            if streaming:
                wav, state["resunits"][(bidx, j)] = _residual_unit(
                    rp, wav, dil, state["resunits"][(bidx, j)])
            else:
                wav, _ = _residual_unit(rp, wav, dil)
    wav = snake_beta(d[str(1 + n_blocks)], wav)
    wav = conv_full_or_step(d[str(2 + n_blocks)]["conv"], wav, 7)
    wav = torch.clamp(wav, -1.0, 1.0)[..., 0]
    return (wav, state) if streaming else wav


def init_streaming_state(cfg: Qwen3CodecDecoderConfig, batch: int = 1,
                         max_frames: int = 4096, dtype=torch.float32,
                         device=None) -> dict:
    """Zero stream state: conv history buffers (pre-conv, first and last
    decoder convs), the ConvNeXt and residual-unit buffers, the transposed
    convs' overlap tails and the pre-transformer's KV cache of
    ``max_frames`` positions."""
    def state(channels, kernel, dilation=1):
        return causal_conv_state(batch, channels, kernel, dilation, dtype, device)

    convs = [state(cfg.codebook_dim, 3), state(cfg.latent_dim, 7),
             state(cfg.decoder_dim // (1 << len(cfg.upsample_rates)), 7)]
    convnext = [state(cfg.latent_dim, 7) for _ in cfg.upsampling_ratios]
    overflow = [torch.zeros((batch, rate, cfg.decoder_dim // (1 << (i + 1))), dtype=dtype,
                            device=device)
                for i, rate in enumerate(cfg.upsample_rates)]
    resunits = {(i, j): state(cfg.decoder_dim // (1 << (i + 1)), 7, dil)
                for i in range(len(cfg.upsample_rates))
                for j, dil in enumerate(RESIDUAL_DILATIONS)}
    cache = kv_cache.init_cache(cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                                cfg.head_dim, max_frames, dtype, device)
    return {"convs": convs, "convnext": convnext, "overflow": overflow,
            "resunits": resunits, "cache": cache}


def init_random_params(cfg: Qwen3CodecDecoderConfig, seed: int = 0, dtype=torch.float32,
                       device=None) -> dict:
    """Random decoder params in the loaded tree's layout (the key set of the
    speech tokenizer's checkpoint), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed + 31``: N(0, 0.05) weights,
    N(0, 0.01) biases, N(0, 0.5) codebooks, unit norms, zero snake
    parameters, layer scales of ``layer_scale_initial_scale``."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed + 31)

    def rand(*shape, scale=0.05):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    def lin(o, i, bias=True):
        p = {"weight": rand(o, i)}
        if bias:
            p["bias"] = rand(o, scale=0.01)
        return p

    def conv(o, i, k, bias=True, transpose=False):
        p = {"weight": rand(*((i, o, k) if transpose else (o, i, k)))}
        if bias:
            p["bias"] = rand(o, scale=0.01)
        return {"conv": p}

    H, L, CB, CV = cfg.hidden_size, cfg.latent_dim, cfg.codebook_dim, cfg.codebook_size
    vq_dim = CB // 2

    def rvq(n):
        return {"vq": {"layers": {str(i): {"codebook": {"embed": rand(CV, vq_dim, scale=0.5)}}
                                  for i in range(n)}},
                "output_proj": {"weight": rand(CB, vq_dim, 1)}}

    ns = cfg.num_semantic_quantizers
    quantizer = {"rvq_first": rvq(ns), "rvq_rest": rvq(cfg.num_quantizers - ns)}
    qd, kd = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim

    def tf_layer():
        return {
            "input_layernorm": {"weight": full(1.0, H)},
            "post_attention_layernorm": {"weight": full(1.0, H)},
            "self_attn": {"q_proj": lin(qd, H, bias=False), "k_proj": lin(kd, H, bias=False),
                          "v_proj": lin(kd, H, bias=False), "o_proj": lin(H, qd, bias=False)},
            "self_attn_layer_scale": {"scale": full(cfg.layer_scale_initial_scale, H)},
            "mlp_layer_scale": {"scale": full(cfg.layer_scale_initial_scale, H)},
            "mlp": {"gate_proj": lin(cfg.intermediate_size, H, bias=False),
                    "up_proj": lin(cfg.intermediate_size, H, bias=False),
                    "down_proj": lin(H, cfg.intermediate_size, bias=False)},
        }

    pre_transformer = {"input_proj": lin(H, H), "output_proj": lin(L, H),
                       "norm": {"weight": full(1.0, H)},
                       "layers": {str(i): tf_layer() for i in range(cfg.num_hidden_layers)}}

    def snake(c):
        return {"alpha": full(0.0, c), "beta": full(0.0, c)}

    upsample = {str(u): {"conv_t": conv(L, L, factor, transpose=True),
                         "convnext": {"dwconv": conv(L, 1, 7),  # depthwise
                                      "norm": {"weight": full(1.0, L), "bias": full(0.0, L)},
                                      "pwconv1": lin(4 * L, L), "pwconv2": lin(L, 4 * L),
                                      "gamma": full(1e-6, L)}}
                for u, factor in enumerate(cfg.upsampling_ratios)}
    decoder = {"0": conv(cfg.decoder_dim, L, 7)}
    ch = cfg.decoder_dim
    for b, rate in enumerate(cfg.upsample_rates):
        out = ch // 2
        block = {"0": snake(ch), "1": conv(out, ch, 2 * rate, transpose=True)}
        for j in range(len(RESIDUAL_DILATIONS)):
            block[str(2 + j)] = {"act1": snake(out), "conv1": conv(out, out, 7),
                                 "act2": snake(out), "conv2": conv(out, out, 1)}
        decoder[str(1 + b)] = {"block": block}
        ch = out
    n_blocks = len(cfg.upsample_rates)
    decoder[str(1 + n_blocks)] = snake(ch)
    decoder[str(2 + n_blocks)] = conv(1, ch, 7)
    return {"quantizer": quantizer, "pre_conv": conv(H, CB, 3),
            "pre_transformer": pre_transformer, "upsample": upsample, "decoder": decoder}


class Qwen3CodecDecoder:
    """The decoder with offline :meth:`decode` and chunked
    :meth:`streaming_step` (state reset by :meth:`reset_streaming_state`).
    Both take codes ``[B, n_q, T]`` (numpy or tensor) and return the
    waveform ``[B, T * total_upsample]`` as a tensor on the codec's
    device."""

    def __init__(self, config: Qwen3CodecDecoderConfig, params: dict,
                 dtype=torch.float32, device=None):
        self.config = config
        self.params = params if device is None else loading.to_device(params, device)
        self.dtype = dtype
        self.sample_rate = config.sampling_rate
        self._stream_state = None

    @property
    def device(self) -> torch.device:
        return self.params["pre_conv"]["conv"]["weight"].device

    @classmethod
    def from_pretrained(cls, repo_or_path: str, device="cuda") -> "Qwen3CodecDecoder":
        """The decoder of a ``speech_tokenizer`` directory (f32)."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_path = model_dir / "config.json"
        config = Qwen3CodecDecoderConfig.from_dict(
            hub.load_config(model_dir) if cfg_path.exists() else {})
        params = loading.load_params(model_dir, dtype=torch.float32)
        return cls(config, params, torch.float32, device)

    def _codes(self, codes) -> torch.Tensor:
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.asarray(codes, np.int64))
        return codes.to(self.device, torch.int64)

    @torch.inference_mode()
    def decode(self, codes) -> torch.Tensor:
        return decoder_forward(self.params, self._codes(codes), self.config)

    def reset_streaming_state(self, batch: int = 1, max_frames: int = 4096) -> None:
        self._stream_state = init_streaming_state(self.config, batch, max_frames, self.dtype,
                                                  self.device)

    @torch.inference_mode()
    def streaming_step(self, codes) -> torch.Tensor:
        codes = self._codes(codes)
        if self._stream_state is None:
            self.reset_streaming_state(batch=codes.shape[0])
        wav, self._stream_state = decoder_forward(self.params, codes, self.config,
                                                  self._stream_state)
        return wav


# -- the speech tokenizer's encoder (reference-audio cloning) --------------------------


def encoder_config_from_dict(d: dict):
    """A ``MimiConfig`` from the speech tokenizer config's
    ``encoder_config`` section (its keys and defaults)."""
    from tpu_audio_torch.codecs.mimi import MimiConfig, SeanetConfig, TransformerConfig

    e = d.get("encoder_config", {}) or {}
    seanet = SeanetConfig(
        dimension=e.get("hidden_size", 512), channels=e.get("audio_channels", 1),
        nfilters=e.get("num_filters", 64), nresidual_layers=e.get("num_residual_layers", 1),
        ratios=tuple(e.get("upsampling_ratios", (8, 6, 5, 4))), ksize=e.get("kernel_size", 7),
        residual_ksize=e.get("residual_kernel_size", 3),
        last_ksize=e.get("last_kernel_size", 3),
        dilation_base=e.get("dilation_growth_rate", 2), compress=e.get("compress", 2))
    transformer = TransformerConfig(
        d_model=e.get("hidden_size", 512), num_heads=e.get("num_attention_heads", 8),
        num_layers=e.get("num_hidden_layers", 8),
        layer_scale=e.get("layer_scale_initial_scale", 0.01),
        context=e.get("sliding_window", 250), max_period=e.get("rope_theta", 10000.0),
        dim_feedforward=e.get("intermediate_size", 2048))
    return MimiConfig(channels=e.get("audio_channels", 1),
                      sample_rate=e.get("sampling_rate", 24000),
                      frame_rate=e.get("frame_rate", 12.5), seanet=seanet,
                      transformer=transformer, quantizer_nq=e.get("num_quantizers", 32),
                      quantizer_bins=e.get("codebook_size", 2048),
                      quantizer_dim=e.get("codebook_dim", 256))


def sanitize_encoder(flat: dict) -> dict:
    """The HF speech tokenizer's ``encoder.*`` weights onto the Mimi tree
    (torch conv layouts ``[O, I, K]`` kept): the SEANet Sequential indices
    to named layers, the transformer's q/k/v (separate, or one fused
    ``qkv`` split in thirds) into one ``in_proj``, the EMA codebooks'
    ``embed_sum``/``cluster_usage``. Other keys are dropped."""
    conv_map = {0: "encoder.init_conv1d", 3: "encoder.layers.0.downsample",
                6: "encoder.layers.1.downsample", 9: "encoder.layers.2.downsample",
                12: "encoder.layers.3.downsample", 14: "encoder.final_conv1d"}
    residual_layer = {1: 0, 4: 1, 7: 2, 10: 3}
    residual_block = {1: 0, 3: 1}
    out: dict = {}
    qkv: dict[int, dict] = {}

    def strip(key: str) -> str:
        for pre in ("speech_tokenizer.", "encoder_model.", "decoder_model."):
            while key.startswith(pre):
                key = key[len(pre):]
        return key

    for raw, v in flat.items():
        k = strip(raw)
        if not k.startswith("encoder."):
            continue
        if "codebook.initialized" in k or k.endswith("codebook.embed"):
            continue
        if k.startswith("encoder.encoder.layers."):
            parts = k.split(".")
            n = int(parts[3])
            if ".block." in k and n in residual_layer:
                bi = residual_block.get(int(parts[5]))
                if bi is not None:  # the rest name the block's conv level already
                    out[f"encoder.layers.{residual_layer[n]}.residuals.0.block.{bi}.conv."
                        + ".".join(parts[6:])] = v
            elif n in conv_map:
                out[f"{conv_map[n]}.conv." + ".".join(parts[4:])] = v
            continue
        if (k.startswith("encoder.encoder_transformer.layers.")
                or k.startswith("encoder.encoder_transformer.transformer.layers.")):
            parts = k.split(".")
            off = 4 if parts[2] == "transformer" else 3
            li = int(parts[off])
            suffix = ".".join(parts[off + 1:])
            base = f"encoder_transformer.transformer.layers.{li}"
            if "self_attn.q_proj.weight" in suffix:
                qkv.setdefault(li, {})["q"] = v
            elif "self_attn.k_proj.weight" in suffix:
                qkv.setdefault(li, {})["k"] = v
            elif "self_attn.v_proj.weight" in suffix:
                qkv.setdefault(li, {})["v"] = v
            elif "self_attn.qkv.weight" in suffix:
                third = v.shape[0] // 3
                qkv.setdefault(li, {}).update(q=v[:third], k=v[third:2 * third],
                                              v=v[2 * third:])
            elif "self_attn.out_proj.weight" in suffix or "self_attn.o_proj.weight" in suffix:
                out[f"{base}.self_attn.out_proj.weight"] = v
            elif "mlp.fc1.weight" in suffix:
                out[f"{base}.gating.linear1.weight"] = v
            elif "mlp.fc2.weight" in suffix:
                out[f"{base}.gating.linear2.weight"] = v
            elif "input_layernorm." in suffix:
                out[f"{base}.norm1.{suffix.rsplit('.', 1)[1]}"] = v
            elif "post_attention_layernorm." in suffix:
                out[f"{base}.norm2.{suffix.rsplit('.', 1)[1]}"] = v
            elif "self_attn_layer_scale.scale" in suffix:
                out[f"{base}.layer_scale_1.scale"] = v
            elif "mlp_layer_scale.scale" in suffix:
                out[f"{base}.layer_scale_2.scale"] = v
            continue
        if k.startswith("encoder.downsample."):
            out["downsample.conv.conv." + k[len("encoder.downsample."):]] = v
            continue
        if k.startswith("encoder.quantizer."):
            rest = k[len("encoder.quantizer."):]
            part = ("rvq_first" if ("semantic_residual_vector_quantizer" in rest
                                    or rest.startswith("rvq_first.")) else "rvq_rest")
            if "input_proj.weight" in rest or "output_proj.weight" in rest:
                proj = "input_proj" if "input_proj" in rest else "output_proj"
                out[f"quantizer.{part}.{proj}.weight"] = v
                continue
            if ".layers." in rest and (".codebook." in rest or "._codebook." in rest):
                li = rest.split(".layers.")[1].split(".")[0]
                name = rest.rsplit(".", 1)[1]
                name = "embedding_sum" if name == "embed_sum" else name
                if name in ("embedding_sum", "cluster_usage"):
                    out[f"quantizer.{part}.vq.layers.{li}.codebook.{name}"] = v
    for li, d3 in qkv.items():
        if {"q", "k", "v"} <= set(d3):
            out[f"encoder_transformer.transformer.layers.{li}.self_attn.in_proj.weight"] = \
                torch.cat([d3["q"], d3["k"], d3["v"]], dim=0)
    return out


def init_random_encoder_params(mimi_config, seed: int = 0, dtype=torch.float32,
                               device=None) -> dict:
    """Random encoder params in :func:`sanitize_encoder`'s tree: Mimi's
    encoder half (``codecs.mimi.init_random_params``), without the decoder,
    the output projections or transformer input/output projections."""
    from tpu_audio_torch.codecs.mimi import init_random_params as mimi_random

    p = mimi_random(mimi_config, seed=seed, dtype=dtype, device=device)
    for part in p["quantizer"].values():
        part.pop("output_proj")
    return {k: p[k] for k in ("encoder", "encoder_transformer", "downsample", "quantizer")}


class Qwen3CodecEncoder:
    """The speech tokenizer's encoder: waveform -> codes ``[B,
    valid_num_quantizers, frames]`` (the first codebooks of the split RVQ),
    in f32 on the params' device."""

    def __init__(self, mimi_config, params: dict, valid_num_quantizers: int = 16,
                 dtype=torch.float32, device=None):
        self.config = mimi_config
        self.params = params if device is None else loading.to_device(params, device)
        self.valid_num_quantizers = valid_num_quantizers
        self.dtype = dtype

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def device(self) -> torch.device:
        return self.params["encoder"]["init_conv1d"]["conv"]["conv"]["weight"].device

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """Waveform ``[T]`` or ``[B, T]`` -> codes ``[B, n_valid_q, frames]``."""
        from tpu_audio_torch.codecs.mimi import encode_forward

        x = audio if isinstance(audio, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(audio, np.float32))
        x = x.to(self.device, self.dtype)
        if x.ndim == 1:
            x = x[None]
        return encode_forward(self.params, x[..., None], self.config)[
            :, : self.valid_num_quantizers]
