"""Cohere Transcribe: a NeMo-style conformer encoder and an attention
encoder-decoder transformer (port of tpu_audio.models.stt.cohere).

- Frontend (``cohere_features``): pre-emphasis 0.97 (``x[0]`` kept), a
  400-sample symmetric Hann zero-padded to 512, a zero-padded STFT at hop
  160, power through Slaney filters, ``log(. + 2**-24)``, then each mel bin
  normalised by its mean and its population std + 1e-5. Not kernel 1's
  function (``log10(max(., 1e-10))``): plain PyTorch, as the JAX package
  computes it outside its Pallas kernel.
- Encoder: three stride-2 convolution stages (the second and third
  depthwise-separable) with the valid-length mask between them, flattened
  channel-major and frequency-minor into ``out``; conformer layers
  (macaron feed-forwards, Transformer-XL relative-position attention with
  f32 scores, a depthwise convolution with inference BatchNorm, and a
  trailing ``norm_out``). The mel frames are padded to a bucket of
  ``_FRAME_BUCKET`` frames and the valid length masks every step, so the
  bucket changes no valid output row.
- Decoder: token embeddings plus fixed interleaved sin/cos positions / sqrt(d),
  LayerNorm, then pre-LN layers of self-attention over a dense KV cache,
  cross-attention over K/V computed once a chunk in the prefill, and a ReLU
  feed-forward; a final LayerNorm and ``lm_head``. A packed (MLX) embedding
  returns f32 rows, so a packed tree's residual stream is f32.
- Greedy decoding: a loop of one-token decoder passes whose token stays on
  the device; the stop condition (``<|endoftext|>`` once the forced prefix
  is done, or ``max_tokens``) is read every ``SYNC_EVERY`` steps, and the
  steps taken past it are not counted. On an MLX tree on CUDA every product
  of 64 rows or fewer runs kernel 7 (``ops.qmm``): a decode step's 8 a
  layer and the head on the 1-row decode kernel, the prompt's prefill and a
  short chunk's cross K/V on the tile; longer products dequantize.
"""

from __future__ import annotations

import functools
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, kv_cache, loading, nn, quant
from tpu_audio_torch.core.ar_loop import SYNC_EVERY
from tpu_audio_torch.core.generation import STTGenerateParameters, STTOutput, STTSegment
from tpu_audio_torch.models import llama
from tpu_audio_torch.models.stt.parakeet import _rel_pos_encoding, _rel_shift

__all__ = ["CohereTranscribe", "CohereConfig", "CohereEncoderConfig", "CohereDecoderConfig",
           "CohereTokenizer", "cohere_features", "encoder_forward", "sanitize",
           "init_random_params"]

_FRAME_BUCKET = 400  # mel frames (4 s) a step of the encoder's bucket


@dataclass
class CohereEncoderConfig:
    d_model: int = 1024
    ff_expansion_factor: int = 4
    n_heads: int = 8
    conv_kernel_size: int = 9
    n_layers: int = 24
    pos_emb_max_len: int = 5000
    subsampling_conv_channels: int = 256
    subsampling_factor: int = 8
    feat_in: int = 128

    @classmethod
    def from_dict(cls, d: dict) -> "CohereEncoderConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass
class CohereDecoderConfig:
    hidden_size: int = 1024
    inner_size: int = 4096
    num_attention_heads: int = 8
    num_layers: int = 6
    max_sequence_length: int = 512

    @classmethod
    def from_dict(cls, d: dict) -> "CohereDecoderConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass
class CohereConfig:
    encoder: CohereEncoderConfig = field(default_factory=CohereEncoderConfig)
    decoder: CohereDecoderConfig = field(default_factory=CohereDecoderConfig)
    vocab_size: int = 16384
    sample_rate: int = 16000
    max_audio_clip_s: int = 30
    quantization: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "CohereConfig":
        vocab = d.get("vocab_size")
        if vocab is None:
            vocab = (d.get("head") or {}).get("num_classes", 16384)
        dec = ((d.get("transf_decoder") or {}).get("config_dict")
               or d.get("transf_decoder") or {})
        return cls(encoder=CohereEncoderConfig.from_dict(d.get("encoder") or {}),
                   decoder=CohereDecoderConfig.from_dict(dec), vocab_size=vocab,
                   sample_rate=d.get("sample_rate", 16000),
                   max_audio_clip_s=d.get("max_audio_clip_s", 30),
                   quantization=d.get("quantization") or d.get("quantization_config"))


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _frontend_window() -> np.ndarray:
    n_fft, win = 512, 400
    window = np.zeros(n_fft, np.float32)
    left = (n_fft - win) // 2
    window[left:left + win] = dsp.hanning_window(win, periodic=False)
    return window


def cohere_features(audio: torch.Tensor, sr: int, n_mels: int) -> torch.Tensor:
    """Pre-emphasized power mel, log, per-bin mean/std normalized ->
    ``[T, n_mels]`` f32 on ``audio``'s device."""
    x = audio.reshape(-1).to(torch.float32)
    x = torch.cat([x[:1], x[1:] - 0.97 * x[:-1]])
    spec = dsp.stft(x, _frontend_window(), 512, 160, pad_mode="constant")
    power = spec.abs() ** 2
    filters = torch.from_numpy(dsp.mel_filters(sr, 512, n_mels, norm="slaney",
                                               mel_scale="slaney")).to(x.device)
    mel = torch.log(power @ filters + 2.0 ** -24)
    mean = mel.mean(dim=0, keepdim=True)
    std = torch.sqrt(((mel - mean) ** 2).mean(dim=0, keepdim=True)) + 1e-5
    return (mel - mean) / std


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv_len(n):
    return (n + 2 - 3) // 2 + 1  # kernel 3, stride 2, padding 1


def _time_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Boolean ``[B, T, 1, ...]`` validity mask of ``x``'s rank."""
    m = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
    return m.reshape(*m.shape, *([1] * (x.ndim - 2)))


def _subsample(p: dict, x: torch.Tensor, lengths: torch.Tensor):
    """Depthwise-separable 8x conv subsampling: ``[B, F, T]`` -> ``([B, T',
    d], lengths)``."""
    h = x.transpose(1, 2)[..., None]  # [B, T, F, 1] channels-last
    h = torch.where(_time_mask(h, lengths), h, 0)
    with nn.f32_convolutions():
        h = torch.relu(nn.conv2d(p["conv0"], h, stride=(2, 2), padding=(1, 1)))
        for dw, pw in (("conv2", "conv3"), ("conv5", "conv6")):
            lengths = _conv_len(lengths)
            h = torch.where(_time_mask(h, lengths), h, 0)
            h = nn.conv2d(p[dw], h, stride=(2, 2), padding=(1, 1), groups=h.shape[-1])
            h = torch.relu(nn.conv2d(p[pw], h))
    lengths = _conv_len(lengths)
    h = torch.where(_time_mask(h, lengths), h, 0)
    b, t, f, c = h.shape
    return nn.linear(p["out"], h.permute(0, 1, 3, 2).reshape(b, t, c * f)), lengths


def _rel_attention(p: dict, x: torch.Tensor, pos_emb: torch.Tensor, n_heads: int,
                   key_mask: torch.Tensor) -> torch.Tensor:
    """Relative-position attention with split q/k/v: AC + BD in f32, the
    scale on their sum, padded keys at -1e9, probabilities in ``x``'s
    dtype."""
    b, t, d = x.shape
    hd = d // n_heads
    q = nn.linear(p["q_proj"], x).reshape(b, t, n_heads, hd)
    k = nn.linear(p["k_proj"], x).reshape(b, t, n_heads, hd).transpose(1, 2)
    v = nn.linear(p["v_proj"], x).reshape(b, t, n_heads, hd).transpose(1, 2)
    pp = nn.linear(p["pos_proj"], pos_emb.to(x.dtype))
    ph = pp.reshape(1, -1, n_heads, hd).transpose(1, 2)
    q_u = (q + p["pos_bias_u"].to(x.dtype)).transpose(1, 2)
    q_v = (q + p["pos_bias_v"].to(x.dtype)).transpose(1, 2)
    ac = q_u.float() @ k.float().transpose(-1, -2)
    bd = _rel_shift(q_v.float() @ ph.float().transpose(-1, -2))[..., :t]
    scores = (ac + bd) * (hd ** -0.5)
    scores = scores.masked_fill(~key_mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = probs @ v
    return nn.linear(p["out_proj"], o.transpose(1, 2).reshape(b, t, d))


def _conformer_conv(p: dict, x: torch.Tensor, kernel_size: int,
                    valid: torch.Tensor) -> torch.Tensor:
    with nn.f32_convolutions():
        h = nn.conv1d(p["pointwise_conv1"], x)
        a, g = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(g)
        h = torch.where(valid[..., None], h, 0)  # padded frames zero before the depthwise conv
        h = nn.conv1d(p["depthwise_conv"], h, padding=(kernel_size - 1) // 2,
                      groups=h.shape[-1])
        h = nn.silu(nn.batch_norm(p["batch_norm"], h))
        return nn.conv1d(p["pointwise_conv2"], h)


def _ff(p: dict, x: torch.Tensor) -> torch.Tensor:
    return nn.linear(p["linear2"], nn.silu(nn.linear(p["linear1"], x)))


def _conformer_layer(p: dict, x: torch.Tensor, pos_emb: torch.Tensor,
                     cfg: CohereEncoderConfig, valid: torch.Tensor) -> torch.Tensor:
    """Macaron conformer layer with a trailing ``norm_out``."""
    x = x + 0.5 * _ff(p["feed_forward1"], nn.layer_norm(p["norm_feed_forward1"], x))
    x = x + _rel_attention(p["self_attn"], nn.layer_norm(p["norm_self_att"], x),
                           pos_emb, cfg.n_heads, valid)
    x = x + _conformer_conv(p["conv"], nn.layer_norm(p["norm_conv"], x),
                            cfg.conv_kernel_size, valid)
    x = x + 0.5 * _ff(p["feed_forward2"], nn.layer_norm(p["norm_feed_forward2"], x))
    return nn.layer_norm(p["norm_out"], x)


@torch.no_grad()
def encoder_forward(params: dict, features: torch.Tensor, lengths: torch.Tensor,
                    cfg: CohereEncoderConfig):
    """``features [B, F, T]`` and the valid frame ``lengths [B]`` -> ``([B,
    T', d], out_lengths)``."""
    p = params["encoder"]
    x, out_len = _subsample(p["subsampling"], features, lengths)
    t = x.shape[1]
    # lru_cached in parakeet: read, never written
    pos_emb = torch.from_numpy(_rel_pos_encoding(t, cfg.d_model)).to(x.device)
    valid = torch.arange(t, device=x.device)[None, :] < out_len[:, None]
    for i in range(cfg.n_layers):
        x = _conformer_layer(p["layers"][str(i)], x, pos_emb, cfg, valid)
    return x, out_len


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _position_table(d: int, max_len: int) -> np.ndarray:
    """Interleaved sin/cos positions / sqrt(d) ``[max_len, d]``."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(-math.log(10000.0) / d * np.arange(0, d, 2, np.float32))
    table = np.zeros((max_len, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table / math.sqrt(d)


def _cross_kv(params: dict, enc_out: torch.Tensor, cfg: CohereConfig):
    """Each layer's cross-attention K and V ``[L, B, H, S, hd]``."""
    nh = cfg.decoder.num_attention_heads
    hd = cfg.decoder.hidden_size // nh
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.decoder.num_layers):
        ap = params["decoder"]["core"]["layers"][str(i)]["second_sub_layer"]
        ks.append(nn.linear(ap["k_proj"], enc_out).reshape(b, s, nh, hd).transpose(1, 2))
        vs.append(nn.linear(ap["v_proj"], enc_out).reshape(b, s, nh, hd).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def _decoder_pass(params: dict, tokens: torch.Tensor, table: torch.Tensor, cache,
                  cross_k: torch.Tensor, cross_v: torch.Tensor, enc_mask: torch.Tensor,
                  cfg: CohereConfig):
    """The decoder over ``tokens [B, T]`` at positions from the cache's
    offset, ``table`` the position table on the device; writes the self K/V
    into ``cache`` in place. Returns (logits ``[B, T, V]``, cache)."""
    p = params["decoder"]
    nh = cfg.decoder.num_attention_heads
    d = cfg.decoder.hidden_size
    hd = d // nh
    b, t = tokens.shape
    offset = cache.offset
    x = nn.embedding(p["embedding"]["token_embedding"], tokens)
    x = nn.layer_norm(p["embedding"]["layer_norm"], x + table[offset:offset + t].to(x.dtype))
    mask = kv_cache.attention_mask(cache, t)

    def heads(proj, h):
        return nn.linear(proj, h).reshape(b, t, nh, hd).transpose(1, 2)

    for i in range(cfg.decoder.num_layers):
        lp = p["core"]["layers"][str(i)]
        h = nn.layer_norm(lp["layer_norm_1"], x)
        ap = lp["first_sub_layer"]
        q, k, v = heads(ap["q_proj"], h), heads(ap["k_proj"], h), heads(ap["v_proj"], h)
        cache, k_full, v_full = kv_cache.update_cache(cache, i, k, v)
        o = nn.sdpa(q, k_full, v_full, mask=mask)
        x = x + nn.linear(ap["out_proj"], o.transpose(1, 2).reshape(b, t, d))
        h = nn.layer_norm(lp["layer_norm_2"], x)
        ap = lp["second_sub_layer"]
        o = nn.sdpa(heads(ap["q_proj"], h), cross_k[i], cross_v[i], mask=enc_mask)
        x = x + nn.linear(ap["out_proj"], o.transpose(1, 2).reshape(b, t, d))
        h = nn.layer_norm(lp["layer_norm_3"], x)
        fp = lp["third_sub_layer"]
        x = x + nn.linear(fp["dense_out"], torch.relu(nn.linear(fp["dense_in"], h)))
    x = nn.layer_norm(p["core"]["final_layer_norm"], x)
    return nn.linear(params["lm_head"], x), cache._replace(offset=offset + t)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

_PREFIX_RENAMES = [
    ("encoder.pre_encode.", "encoder.subsampling."),
    ("encoder_decoder_proj.", "bridge_proj."),
    ("log_softmax.mlp.layer0.", "lm_head."),
    ("transf_decoder.embedding.", "decoder.embedding."),
    ("transf_decoder._embedding.", "decoder.embedding."),
    ("transf_decoder.decoder.", "decoder.core."),
    ("transf_decoder._decoder.", "decoder.core."),
]
_SUB_RENAMES = [
    ("encoder.subsampling.conv.0.", "encoder.subsampling.conv0."),
    ("encoder.subsampling.conv.2.", "encoder.subsampling.conv2."),
    ("encoder.subsampling.conv.3.", "encoder.subsampling.conv3."),
    ("encoder.subsampling.conv.5.", "encoder.subsampling.conv5."),
    ("encoder.subsampling.conv.6.", "encoder.subsampling.conv6."),
    ("self_attn.linear_q.", "self_attn.q_proj."),
    ("self_attn.linear_k.", "self_attn.k_proj."),
    ("self_attn.linear_v.", "self_attn.v_proj."),
    ("self_attn.linear_out.", "self_attn.out_proj."),
    ("self_attn.linear_pos.", "self_attn.pos_proj."),
    (".query_net.", ".q_proj."),
    (".key_net.", ".k_proj."),
    (".value_net.", ".v_proj."),
    (".out_projection.", ".out_proj."),
]
_SUBSAMPLING_KERNELS = {"conv0": 3, "conv2": 3, "conv3": 1, "conv5": 3, "conv6": 1}


def sanitize(weights: dict) -> dict:
    """NeMo and MLX keys -> the model's: renamed prefixes and submodules,
    BatchNorm counters, the preprocessor and the stored decoder positions
    dropped, a pre-fused ``qkv_proj`` (words, scales and biases alike)
    split in three along its rows, MLX convolution layouts (``[O, H, W,
    I]``, ``[C, K, 1]``, ``[O, 1, I]``) transposed to torch's."""
    out, fused = {}, {}
    for k, v in weights.items():
        if k.endswith(".num_batches_tracked") or k.startswith("preprocessor."):
            continue
        for src, dst in _PREFIX_RENAMES:
            if k.startswith(src):
                k = dst + k[len(src):]
                break
        for src, dst in _SUB_RENAMES:
            k = k.replace(src, dst)
        if "decoder.embedding.position_embedding" in k:
            continue  # computed, not stored
        if ".qkv_proj." in k:
            fused[k] = v
            continue
        if k.endswith(".weight") and v.ndim == 4:
            kern = _SUBSAMPLING_KERNELS.get(k.split(".")[-2])
            if (kern is not None and not (v.shape[2] == kern and v.shape[3] == kern)
                    and v.shape[1] == kern and v.shape[2] == kern):
                v = v.permute(0, 3, 1, 2).contiguous()  # MLX [O, H, W, I]
        elif k.endswith(".weight") and v.ndim == 3 and ".conv." in k:
            if "depthwise_conv" in k:
                if v.shape[2] == 1 and v.shape[1] > 1:  # MLX [C, K, 1]
                    v = v.permute(0, 2, 1).contiguous()
            elif v.shape[1] == 1 and v.shape[2] > 1:  # MLX [O, 1, I] pointwise
                v = v.permute(0, 2, 1).contiguous()
        out[k] = v
    for k, v in fused.items():
        for part, piece in zip(("q_proj", "k_proj", "v_proj"), v.chunk(3, dim=0)):
            out[k.replace("qkv_proj", part)] = piece.contiguous()
    return out


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_LANG_TOKENS = {
    "english": "<|en|>", "en": "<|en|>", "french": "<|fr|>", "fr": "<|fr|>",
    "german": "<|de|>", "de": "<|de|>", "spanish": "<|es|>", "es": "<|es|>",
    "italian": "<|it|>", "it": "<|it|>", "portuguese": "<|pt|>",
    "pt": "<|pt|>", "dutch": "<|nl|>", "nl": "<|nl|>", "polish": "<|pl|>",
    "pl": "<|pl|>", "greek": "<|el|>", "el": "<|el|>", "arabic": "<|ar|>",
    "ar": "<|ar|>", "japanese": "<|ja|>", "ja": "<|ja|>", "chinese": "<|zh|>",
    "zh": "<|zh|>", "vietnamese": "<|vi|>", "vi": "<|vi|>",
    "korean": "<|ko|>", "ko": "<|ko|>",
}


class CohereTokenizer:
    """SentencePiece (``tokenizer.model``, read by ``core.spm``) and the
    special-token table of ``tokenizer_config.json``."""

    def __init__(self, model_dir):
        from tpu_audio_torch.core.spm import SentencePieceTokenizer

        model_dir = Path(model_dir)
        self.sp = SentencePieceTokenizer.from_model_file(model_dir / "tokenizer.model")
        cfg = json.loads((model_dir / "tokenizer_config.json").read_text())
        self.special = {tok["content"]: int(tid)
                        for tid, tok in (cfg.get("added_tokens_decoder") or {}).items()}
        self.special_ids = set(self.special.values())

    def encode(self, text: str) -> list[int]:
        if text in self.special:
            return [self.special[text]]
        return self.sp.encode(text)

    def decode(self, ids) -> str:
        return self.sp.decode([i for i in ids if i not in self.special_ids])

    @property
    def eos_id(self) -> int:
        return self.special.get("<|endoftext|>", 0)

    def build_prompt(self, language: str = "en", use_punctuation: bool = True,
                     use_timestamps: bool = False) -> list[int]:
        lang = _LANG_TOKENS.get((language or "en").lower(), "<|en|>")
        names = ["<|startofcontext|>", "<|startoftranscript|>", "<|emo:undefined|>", lang, lang,
                 "<|pnc|>" if use_punctuation else "<|nopnc|>", "<|noitn|>",
                 "<|timestamp|>" if use_timestamps else "<|notimestamp|>", "<|nodiarize|>"]
        return [self.special[n] for n in names if n in self.special]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class CohereTranscribe:
    """Cohere Transcribe: ``generate`` (fixed chunks or VAD segments),
    ``generate_stream`` (a chunk at a time) and the streaming session's
    hooks (``streaming_decode_token_ids``, ``streaming_decode_text``)."""

    def __init__(self, config: CohereConfig, params: dict, tokenizer=None,
                 dtype=torch.bfloat16):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = llama._leaves(params)[0].device
        self._table = torch.from_numpy(_position_table(
            config.decoder.hidden_size, config.decoder.max_sequence_length)).to(self.device)

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16, device="cuda",
                        quantize=None) -> "CohereTranscribe":
        """Load a local checkpoint directory onto ``device`` (``sanitize``,
        then a ``quantization`` block's packed triples tagged as MLX
        leaves). ``quantize`` is accepted for ``load_model``'s callers: any
        value but None raises (load an MLX-quantized checkpoint instead)."""
        if quantize is not None:
            raise ValueError(f"quantize={quantize!r}: Cohere Transcribe has no load-time "
                             "quantization (load an MLX-quantized checkpoint instead)")
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = CohereConfig.from_dict(hub.load_config(model_dir))
        params = loading.to_device(loading.load_params(model_dir, sanitize=sanitize,
                                                       dtype=dtype), device)
        if config.quantization:
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        tokenizer = (CohereTokenizer(model_dir) if (model_dir / "tokenizer.model").exists()
                     else None)
        return cls(config, params, tokenizer, dtype)

    # -- encoder and prefill ---------------------------------------------------

    @torch.no_grad()
    def _encode_audio(self, audio) -> tuple[torch.Tensor, int]:
        """16 kHz audio -> (encoder output ``[1, T', d]`` f32 on the device,
        its valid length). The mel frames are zero-padded to a multiple of
        ``_FRAME_BUCKET``; ``bridge_proj`` applies when the tree has one."""
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        feats = cohere_features(audio.to(self.device), self.config.sample_rate,
                                self.config.encoder.feat_in)
        n = feats.shape[0]
        bucket = _FRAME_BUCKET * max(1, math.ceil(n / _FRAME_BUCKET))
        padded = torch.zeros((1, self.config.encoder.feat_in, bucket), dtype=torch.float32,
                             device=self.device)
        padded[0, :, :n] = feats.T
        lengths = torch.tensor([n], dtype=torch.int64, device=self.device)
        enc_out, out_len = encoder_forward(self.params, padded.to(self.dtype), lengths,
                                           self.config.encoder)
        enc_out = enc_out.float()
        if "bridge_proj" in self.params:
            enc_out = nn.linear(self.params["bridge_proj"], enc_out.to(self.dtype)).float()
        return enc_out, int(out_len[0])

    def _prefill(self, prompt: list[int], enc_out: torch.Tensor, enc_len: int,
                 capacity: int):
        """The prompt through the decoder with each layer's cross K/V ->
        (the last position's logits ``[1, V]``, the cache, cross K, cross V,
        the encoder mask)."""
        dcfg = self.config.decoder
        cache = kv_cache.init_cache(dcfg.num_layers, 1, dcfg.num_attention_heads,
                                    dcfg.hidden_size // dcfg.num_attention_heads, capacity,
                                    self.dtype, device=self.device)
        enc = enc_out.to(self.dtype)
        enc_mask = (torch.arange(enc.shape[1], device=self.device) < enc_len)[None, None, None]
        cross_k, cross_v = _cross_kv(self.params, enc, self.config)
        logits, cache = _decoder_pass(
            self.params, torch.tensor([prompt], dtype=torch.int64, device=self.device),
            self._table, cache, cross_k, cross_v, enc_mask, self.config)
        return logits[:, -1], cache, cross_k, cross_v, enc_mask

    def _decode(self, first_logits, cache, cross_k, cross_v, enc_mask, max_tokens: int,
                forced=()) -> tuple[list[int], int]:
        """Greedy decode on the device -> (the ids written, their count).
        Step ``i`` feeds ``forced[i]`` while ``i < len(forced)``, else the
        argmax of the previous logits (the prefill's at step 0); decoding
        stops before a step whose token is the tokenizer's eos, once the
        forced prefix is done, or at ``max_tokens``. The stop flag is read
        every ``SYNC_EVERY`` steps; steps past it are not counted."""
        dev = self.device
        eos = self.tokenizer.eos_id if self.tokenizer else 0
        n_forced = min(len(forced), max_tokens)
        forced_t = torch.tensor(list(forced[:n_forced]), dtype=torch.int64, device=dev)
        tok = torch.argmax(first_logits[0]).to(torch.int64)
        buf = torch.zeros((max_tokens,), dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        live = torch.ones((), dtype=torch.bool, device=dev)
        for i in range(max_tokens):
            if i < n_forced:
                tok = forced_t[i]
            else:
                live = live & (tok != eos)
                if (i - n_forced) % SYNC_EVERY == 0 and not bool(live):
                    break
            buf[i] = tok
            count += live
            logits, cache = _decoder_pass(self.params, tok.reshape(1, 1), self._table, cache,
                                          cross_k, cross_v, enc_mask, self.config)
            tok = torch.argmax(logits[0, -1])
        n = int(count)
        return buf[:n].tolist(), n

    # -- generation ------------------------------------------------------------

    @torch.no_grad()
    def _transcribe_chunk(self, audio, params: STTGenerateParameters):
        enc_out, enc_len = self._encode_audio(audio)
        prompt = self.tokenizer.build_prompt(language=params.language or "en")
        max_new = min(params.max_tokens,
                      self.config.decoder.max_sequence_length - len(prompt) - 1)
        state = self._prefill(prompt, enc_out, enc_len, len(prompt) + max_new + 1)
        ids, _ = self._decode(*state, max_new)
        eos = self.tokenizer.eos_id
        ids = [t for t in ids if t != eos]
        return self.tokenizer.decode(ids).strip(), len(prompt), len(ids)

    def _fixed_pieces(self, audio: np.ndarray, chunk_s: float):
        chunk = int(chunk_s * self.config.sample_rate)
        return [(audio[s:s + chunk], s / self.config.sample_rate)
                for s in range(0, max(len(audio), 1), chunk)]

    def generate(self, audio, generation_parameters: STTGenerateParameters | None = None,
                 vad=None) -> STTOutput:
        """Transcribe in fixed chunks of ``chunk_duration`` (default
        ``max_audio_clip_s``), or, with ``vad=(silero_model,
        SpeechSegmentConfig)``, in the speech segments of
        ``models.vad.segmenter.segment_speech`` (fixed chunks if the VAD
        fails). The ``max_tokens`` budget runs across the chunks, whose
        texts join with newlines."""
        params = generation_parameters or STTGenerateParameters(
            max_tokens=self.config.decoder.max_sequence_length)
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        t0 = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        chunk_s = params.chunk_duration or float(self.config.max_audio_clip_s)
        pieces = None
        if vad is not None:
            try:
                from tpu_audio_torch.models.vad.segmenter import segment_speech

                vad_model, vad_config = vad
                pieces = segment_speech(audio, self.config.sample_rate, vad_model, vad_config)
            except Exception:
                pieces = None  # fall back to fixed chunks
        if pieces is None:
            pieces = self._fixed_pieces(audio, chunk_s)
        texts, segments = [], []
        n_prompt = n_gen = 0
        remaining = params.max_tokens
        for piece, offset_s in pieces:
            if remaining <= 0:
                break
            text, p, g = self._transcribe_chunk(piece, STTGenerateParameters(
                max_tokens=remaining, language=params.language,
                temperature=params.temperature))
            n_prompt += p
            n_gen += g
            remaining -= g
            if text:
                texts.append(text)
                segments.append(STTSegment(text=text, start=offset_s,
                                           end=offset_s + len(piece) / self.config.sample_rate))
        elapsed = time.perf_counter() - t0
        return STTOutput(text="\n".join(texts), segments=segments, language=params.language,
                         prompt_token_count=n_prompt, generation_token_count=n_gen,
                         total_time=elapsed, generation_time=elapsed)

    def generate_stream(self, audio, generation_parameters: STTGenerateParameters | None = None):
        """A token event a fixed chunk's text, then the result event."""
        params = generation_parameters or STTGenerateParameters(
            max_tokens=self.config.decoder.max_sequence_length)
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        texts = []
        n_prompt = n_gen = 0
        t0 = time.perf_counter()
        for piece, _ in self._fixed_pieces(
                audio, params.chunk_duration or float(self.config.max_audio_clip_s)):
            text, p, g = self._transcribe_chunk(piece, params)
            n_prompt += p
            n_gen += g
            if text:
                texts.append(text)
                yield {"type": "token", "text": text}
        elapsed = time.perf_counter() - t0
        yield {"type": "result", "output": STTOutput(
            text="\n".join(texts), language=params.language, prompt_token_count=n_prompt,
            generation_token_count=n_gen, total_time=elapsed, generation_time=elapsed)}

    # -- the streaming session's hooks -----------------------------------------

    @torch.no_grad()
    def streaming_decode_token_ids(self, audio, config,
                                   confirmed_token_ids) -> tuple[list[int], float]:
        """A window's token ids with ``confirmed_token_ids`` forced as their
        prefix -> (every id but eos, the confirmed prefix included; decode
        seconds)."""
        t0 = time.perf_counter()
        enc_out, enc_len = self._encode_audio(np.asarray(audio, np.float32))
        prompt = self.tokenizer.build_prompt(language=getattr(config, "language", None) or "en")
        max_total = min(getattr(config, "max_tokens_per_pass", 512),
                        self.config.decoder.max_sequence_length - len(prompt) - 1)
        state = self._prefill(prompt, enc_out, enc_len, len(prompt) + max_total + 1)
        ids, _ = self._decode(*state, max_total, forced=[int(t) for t in confirmed_token_ids])
        eos = self.tokenizer.eos_id
        return [t for t in ids if t != eos], time.perf_counter() - t0

    def streaming_decode_text(self, tokens) -> str:
        if not tokens:
            return ""
        return self.tokenizer.decode([int(t) for t in tokens]).strip()


def init_random_params(cfg: CohereConfig, seed: int = 0, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random params at ``cfg``'s shapes in the sanitized tree's layout,
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``:
    linears and convolutions N(0, 1/fan-in), biases and the relative
    position biases N(0, 0.02), LayerNorm and BatchNorm weights 1 + N(0,
    0.1) and biases N(0, 0.02), BatchNorm running means N(0, 0.1) and
    variances 1 + |N(0, 0.1)|, the token embedding N(0, 1)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    e, dc = cfg.encoder, cfg.decoder

    def rand(shape, std):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    def lin(o, i, bias=True):
        p = {"weight": rand((o, i), i ** -0.5)}
        if bias:
            p["bias"] = rand((o,), 0.02)
        return p

    def conv(o, i, *k):
        fan = i * math.prod(k)
        return {"weight": rand((o, i, *k), fan ** -0.5), "bias": rand((o,), 0.02)}

    def norm(n):
        return {"weight": (1.0 + rand((n,), 0.1).float()).to(dtype), "bias": rand((n,), 0.02)}

    d, ch, ffn = e.d_model, e.subsampling_conv_channels, e.d_model * e.ff_expansion_factor
    f = e.feat_in
    for _ in range(3):
        f = _conv_len(f)
    sub = {"conv0": conv(ch, 1, 3, 3), "conv2": conv(ch, 1, 3, 3), "conv3": conv(ch, ch, 1, 1),
           "conv5": conv(ch, 1, 3, 3), "conv6": conv(ch, ch, 1, 1), "out": lin(d, ch * f)}
    hd = d // e.n_heads
    layers = {}
    for i in range(e.n_layers):
        bn = norm(d)
        bn.update(running_mean=rand((d,), 0.1),
                  running_var=(1.0 + rand((d,), 0.1).float().abs()).to(dtype))
        layers[str(i)] = {
            **{n: norm(d) for n in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                                    "norm_feed_forward2", "norm_out")},
            **{n: {"linear1": lin(ffn, d), "linear2": lin(d, ffn)}
               for n in ("feed_forward1", "feed_forward2")},
            "self_attn": {**{n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
                          "pos_proj": lin(d, d, bias=False),
                          "pos_bias_u": rand((e.n_heads, hd), 0.02),
                          "pos_bias_v": rand((e.n_heads, hd), 0.02)},
            "conv": {"pointwise_conv1": conv(2 * d, d, 1),
                     "depthwise_conv": conv(d, 1, e.conv_kernel_size),
                     "batch_norm": bn, "pointwise_conv2": conv(d, d, 1)}}
    h = dc.hidden_size
    dec_layers = {str(i): {
        "layer_norm_1": norm(h), "layer_norm_2": norm(h), "layer_norm_3": norm(h),
        "first_sub_layer": {n: lin(h, h) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "second_sub_layer": {n: lin(h, h) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "third_sub_layer": {"dense_in": lin(dc.inner_size, h),
                            "dense_out": lin(h, dc.inner_size)}}
        for i in range(dc.num_layers)}
    params = {"encoder": {"subsampling": sub, "layers": layers},
              "decoder": {"embedding": {"token_embedding": {"weight": rand((cfg.vocab_size, h),
                                                                           1.0)},
                                        "layer_norm": norm(h)},
                          "core": {"layers": dec_layers, "final_layer_norm": norm(h)}},
              "lm_head": lin(cfg.vocab_size, h)}
    if h != d:
        params["bridge_proj"] = lin(h, d)
    return params
