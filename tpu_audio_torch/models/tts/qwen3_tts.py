"""Qwen3-TTS: the talker (a Qwen3 transformer emitting codebook 0 of the
12.5 Hz codec), the code predictor (a small transformer emitting groups
1..G-1 of each frame) and the speech tokenizer's decoder, with
reference-audio voice cloning on "base" checkpoints (port of
tpu_audio.models.tts.qwen3_tts).

- The talker is ``models.llama.forward`` with per-head q/k RMSNorm over
  input embeddings. Its interleaved multimodal RoPE reduces to the
  standard rotary tables for pure TTS (all three position streams are the
  text position).
- A frame is one talker step and ``G - 1`` code-predictor passes over a
  fresh ``G + 2``-row cache: pass 0 reads ``[talker hidden, codebook-0
  embedding]`` (2 rows), pass g the embedding of group g's code (1 row),
  each through group g's own head and embedding. The next talker input is
  the frame's summed code embeddings plus the next text embedding (the
  trailing text, then ``tts_pad``).
- Sampling is ``_sample``: suppression of the special-token band and a
  repetition penalty over the codebook-0 history (talker only), then
  top-k, top-p and a draw from a ``torch.Generator``. Greedy codes equal
  the JAX package's; sampled ones follow the same distribution with other
  random bits.
- On an MLX 4/8-bit tree every product of at most 64 rows runs kernel 7
  (``ops.qmm``): the decode kernel for each talker step and code-predictor
  passes 1..G-2, the tile for pass 0, the prompt and the text projection.
  A w8a8 tree runs ``quant.int8_matmul``. A packed embedding dequantizes
  the rows it looks up to f32, so from the first frame on the talker's
  residual stream is f32, as in the JAX package.
- ``generate_stream`` decodes every ``streaming_interval`` seconds of
  frames through the codec's streaming step.
- ``_lane_frame`` is the serving engine's frame
  (``parallel.continuous_qwen3``): ``_frame`` over ``n`` lanes at once, the
  talker step through :func:`talker_lanes_forward` (each lane at its own
  offset, ``valid_from`` and rotary position in stacked lane caches) and the
  code predictor over all lanes in one fresh cache. On an MLX tree on CUDA
  its products run kernel 7's tile (``n >= 2`` rows).
- Voice cloning (``ref_audio`` with ``ref_text``) needs the speech
  tokenizer's encoder (``codecs.qwen3_codec.Qwen3CodecEncoder``, Mimi's)
  and, on "base" checkpoints, the speaker encoder
  (``models.tts.qwen3_speaker``; its log-mel runs kernel 1 on the card).
  The reference clip's codes and speaker embedding (cached for one clip)
  make an in-context prompt: the reference and target text over codec pad,
  then the reference frames' summed code embeddings over tts pad, after the
  codec prefix with the speaker row. ``generate`` decodes the reference
  codes in front of the new ones and cuts their share of the waveform;
  ``generate_stream`` decodes the new ones alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from tpu_audio_torch.codecs.qwen3_codec import (Qwen3CodecDecoder, Qwen3CodecEncoder,
                                                 encoder_config_from_dict, sanitize_encoder)
from tpu_audio_torch.core import hub, kv_cache, loading, nn, quant
from tpu_audio_torch.core.generation import (AudioGenerateParameters, AudioGeneration,
                                             AudioGenerationError, AudioGenerationInfo)
from tpu_audio_torch.core.sampling import _mask_top_k, _mask_top_p, apply_repetition_penalty
from tpu_audio_torch.models import llama
from tpu_audio_torch.models.tts import qwen3_speaker
from tpu_audio_torch.models.tts.llama_tts import _sync

__all__ = ["Qwen3TTS", "Qwen3TTSConfig", "TalkerConfig", "CodePredictorConfig",
           "talker_forward", "talker_lanes_forward", "code_predictor_forward",
           "init_random_params"]

CODEC_TOKEN_RATE_HZ = 12.5
SUPPRESSED_BAND = 1024  # the talker vocabulary's last ids: special tokens, never sampled


@dataclass
class TalkerConfig:
    vocab_size: int = 4096
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 20
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False
    num_code_groups: int = 16
    text_hidden_size: int = 2048
    text_vocab_size: int = 151936
    codec_eos_token_id: int = 4096
    codec_think_id: int = 4098
    codec_nothink_id: int = 4097
    codec_think_bos_id: int = 4099
    codec_think_eos_id: int = 4100
    codec_pad_id: int = 4196
    codec_bos_id: int = 4197
    codec_language_id: dict = field(default_factory=dict)
    spk_id: dict = field(default_factory=dict)
    mrope_section: tuple = (24, 20, 20)
    code_predictor_config: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "TalkerConfig":
        keys = set(cls.__dataclass_fields__)
        kw = {k: v for k, v in d.items() if k in keys}
        if "mrope_section" in kw:
            kw["mrope_section"] = tuple(kw["mrope_section"])
        return cls(**kw)


@dataclass
class CodePredictorConfig:
    vocab_size: int = 2048
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 4
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    num_code_groups: int = 16

    @classmethod
    def from_dict(cls, d: dict) -> "CodePredictorConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass
class Qwen3TTSConfig:
    talker: TalkerConfig = field(default_factory=TalkerConfig)
    code_predictor: CodePredictorConfig = field(default_factory=CodePredictorConfig)
    tts_model_type: str = "voice_design"  # voice_design | custom_voice | base
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    tts_pad_token_id: int = 151671
    sample_rate: int = 24000
    quantization: dict | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3TTSConfig":
        talker_d = d.get("talker_config") or {}
        cfg = cls(talker=TalkerConfig.from_dict(talker_d),
                  tts_model_type=d.get("tts_model_type", "voice_design"),
                  tts_bos_token_id=d.get("tts_bos_token_id", 151672),
                  tts_eos_token_id=d.get("tts_eos_token_id", 151673),
                  tts_pad_token_id=d.get("tts_pad_token_id", 151671))
        cp = dict(talker_d.get("code_predictor_config") or {})
        cp.setdefault("num_code_groups", cfg.talker.num_code_groups)
        cfg.code_predictor = CodePredictorConfig.from_dict(cp)
        cfg.quantization = d.get("quantization")
        return cfg


def _llama_cfg(cfg, **kw) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_hidden_layers,
        intermediate_size=cfg.intermediate_size, num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, qk_norm=True, **kw)


def _talker_llama_cfg(cfg: TalkerConfig) -> llama.LlamaConfig:
    return _llama_cfg(cfg, attention_bias=cfg.attention_bias,
                      max_position_embeddings=cfg.max_position_embeddings)


def talker_forward(params: dict, embeds: torch.Tensor, cache: kv_cache.KVCache | None,
                   cfg: TalkerConfig):
    """embeds ``[B, T, D]`` -> (codec logits ``[B, T, V]``, hidden ``[B, T,
    D]``, cache); the cache is written in place."""
    hidden, cache = llama.forward(params, None, cache, _talker_llama_cfg(cfg),
                                  inputs_embeds=embeds, return_hidden=True)
    return nn.linear(params["codec_head"], hidden), hidden, cache


def _cp_hidden(params: dict, embeds: torch.Tensor, cache, cfg: CodePredictorConfig):
    """The code predictor's final-normed hidden states (no group head)."""
    x = embeds
    if "small_to_mtp_projection" in params:
        x = nn.linear(params["small_to_mtp_projection"], x)
    return llama.forward(params, None, cache, _llama_cfg(cfg), inputs_embeds=x,
                         return_hidden=True)


def code_predictor_forward(params: dict, embeds: torch.Tensor, cache, group_idx: int,
                           cfg: CodePredictorConfig):
    """One code-predictor pass through group ``group_idx``'s head: (logits
    ``[B, T, V_cp]``, cache)."""
    hidden, cache = _cp_hidden(params, embeds, cache, cfg)
    return nn.linear(params["lm_head"][str(group_idx)], hidden), cache


def talker_lanes_forward(params: dict, embeds: torch.Tensor, cache: kv_cache.FusedLaneRow,
                         lanes: torch.Tensor, span: int, cfg: TalkerConfig):
    """One talker step of ``n`` serving lanes: ``embeds [n, 1, D]``, lane
    ``j`` in slot ``lanes[j]`` of ``cache`` (``k``/``v`` ``[slots, L, 1,
    n_kv, S, hd]``, ``offset`` and ``valid_from`` ``[slots]`` int64 on the
    device). Each lane writes its K/V row at its own offset (clamped into
    the cache: a frozen lane's garbage row), rotates at its own position and
    attends causally from its own ``valid_from``, over the first ``span``
    rows (the caller's bound on every lane's offset + 1); nothing is read
    back to the host. Returns (codec logits ``[n, 1, V]``, hidden ``[n, 1,
    D]``); the caller advances the offsets."""
    lcfg = _talker_llama_cfg(cfg)
    p = params["model"]
    offsets, valid_from = cache.offset[lanes], cache.valid_from[lanes]
    cos, sin = llama._rope_tables(lcfg, offsets)
    cos, sin = cos[:, None, None], sin[:, None, None]  # over heads and the one row
    key = torch.arange(span, device=embeds.device)[None, :]
    mask = ((key <= offsets[:, None]) & (key >= valid_from[:, None]))[:, None, None]
    write = offsets.clamp(max=cache.k.shape[-2] - 1)
    x = embeds
    for i, lp in enumerate(llama.layer_list(p["layers"])):
        def kv_update(k, v, _i=i, _dtype=x.dtype):
            kc, vc = cache.k[:, _i, 0], cache.v[:, _i, 0]  # [slots, n_kv, S, hd] views
            kc[lanes, :, write] = k[:, :, 0].to(kc.dtype)
            vc[lanes, :, write] = v[:, :, 0].to(vc.dtype)
            return kc[lanes, :, :span].to(_dtype), vc[lanes, :, :span].to(_dtype)

        x = llama.layer_forward(x, lp, lcfg, cos, sin, mask=mask, kv_update=kv_update)
    hidden = nn.rms_norm(p["norm"], x, lcfg.rms_norm_eps)
    return nn.linear(params["codec_head"], hidden), hidden


def _penalized(logits: torch.Tensor, suppress: torch.Tensor | None,
               history: torch.Tensor | None, valid: torch.Tensor | None,
               repetition_penalty: float) -> torch.Tensor:
    """``logits`` in f32 with the suppression added and the repetition
    penalty over the ``valid`` entries of ``history``: what is sampled
    from."""
    logits = logits.to(torch.float32)
    if suppress is not None:
        logits = logits + suppress
    if repetition_penalty != 1.0 and history is not None:
        logits = apply_repetition_penalty(logits, history, valid, repetition_penalty)
    return logits


def _sample(gen: torch.Generator | None, logits: torch.Tensor, temperature: float,
            top_k: int, top_p: float, suppress: torch.Tensor | None = None,
            history: torch.Tensor | None = None, hist_len: int = 0,
            repetition_penalty: float = 1.0) -> torch.Tensor:
    """``logits [B, V]`` -> ids ``[B]``: suppression, the repetition penalty
    over the first ``hist_len`` entries of ``history``, then greedy at
    temperature 0, else top-k, top-p and a draw from ``gen``."""
    valid = None
    if repetition_penalty != 1.0 and history is not None:
        valid = (torch.arange(history.shape[1], device=logits.device)[None, :]
                 < min(hist_len, history.shape[1])).expand_as(history)
    logits = _penalized(logits, suppress, history, valid, repetition_penalty)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if top_k and top_k > 0:
        logits = _mask_top_k(logits, top_k)
    if top_p < 1.0:
        logits = _mask_top_p(logits, top_p)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def init_random_params(config: Qwen3TTSConfig, seed: int = 0, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random talker and code-predictor params in the loaded tree's layout
    (stacked layers, unfused projections; the checkpoint's key set), drawn
    on ``device`` from ``torch.Generator``s: N(0, 0.02) weights and unit
    norms."""
    tcfg, ccfg = config.talker, config.code_predictor
    device = torch.device(device) if device is not None else torch.device("cpu")

    def backbone(lcfg, key_seed):
        lcfg.vocab_size = 8  # the transformer runs on input embeddings
        p = llama.init_random_params(lcfg, seed=key_seed, dtype=dtype, device=device,
                                     on_device=True)
        p["model"].pop("embed_tokens", None)
        p.pop("lm_head", None)
        return p

    gen = torch.Generator(device=device).manual_seed(seed + 7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * 0.02

    params = backbone(_talker_llama_cfg(tcfg), seed)
    V, H, TH = tcfg.vocab_size, tcfg.hidden_size, tcfg.text_hidden_size
    params["model"]["codec_embedding"] = {"weight": rand(V, H)}
    params["model"]["text_embedding"] = {"weight": rand(tcfg.text_vocab_size, TH)}
    params["text_projection"] = {"linear_fc1": {"weight": rand(TH, TH), "bias": rand(TH)},
                                 "linear_fc2": {"weight": rand(H, TH), "bias": rand(H)}}
    params["codec_head"] = {"weight": rand(V, H)}
    cp = backbone(_llama_cfg(ccfg), seed + 1)
    G, CV = tcfg.num_code_groups, ccfg.vocab_size
    cp["model"]["codec_embedding"] = {str(g): {"weight": rand(CV, H)} for g in range(G - 1)}
    cp["lm_head"] = {str(g): {"weight": rand(CV, ccfg.hidden_size)} for g in range(G - 1)}
    params["code_predictor"] = cp
    return params


class Qwen3TTS:
    """Qwen3-TTS with ``generate`` / ``generate_stream`` (``custom_voice``
    speakers and instructions, ``voice_design`` prompts, languages, and
    cloning from a reference clip and its text)."""

    def __init__(self, config: Qwen3TTSConfig, params: dict, tokenizer=None,
                 codec: Qwen3CodecDecoder | None = None, dtype=torch.bfloat16,
                 codec_encoder: Qwen3CodecEncoder | None = None,
                 speaker_encoder: qwen3_speaker.Qwen3SpeakerEncoder | None = None):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.codec = codec
        self.dtype = dtype
        self.codec_encoder = codec_encoder
        self.speaker_encoder = speaker_encoder
        self._ref_context_cache = None  # (SHA-1 of the clip, its context)
        cp = params.get("code_predictor") or {}
        n_heads = len(cp.get("lm_head") or {})
        if n_heads != config.talker.num_code_groups - 1:
            raise AudioGenerationError(
                f"checkpoint has {n_heads} code-predictor heads but config num_code_groups="
                f"{config.talker.num_code_groups} needs {config.talker.num_code_groups - 1}")

    @property
    def device(self) -> torch.device:
        w = self.params["model"]["codec_embedding"]["weight"]
        return (w.weight.device if isinstance(w, (quant.Int8Tensor, quant.QuantizedTensor))
                else w.device)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def default_generation_parameters(self) -> AudioGenerateParameters:
        return AudioGenerateParameters(max_tokens=2400, temperature=0.9, top_p=1.0, top_k=50,
                                       repetition_penalty=1.05, repetition_context_size=64,
                                       streaming_interval=2.0)

    # -- loading ------------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16,
                        quantize_bits: int | str | None = None, device="cuda") -> "Qwen3TTS":
        """Load a local checkpoint directory onto ``device``: the talker and
        the code predictor (``talker.*`` keys, layers stacked), the speaker
        encoder (its ``speaker_encoder`` keys, f32) on a "base" checkpoint,
        and from ``speech_tokenizer/`` (f32), when the directory is there,
        the speech tokenizer's decoder and, where it holds ``encoder.*``
        weights, its encoder. A ``quantization`` block in the config makes the
        packed triples MLX :class:`quant.QuantizedTensor` leaves (and
        ``quantize_bits`` is ignored); otherwise ``quantize_bits=4|8``
        quantizes every eligible weight to MLX grouped-affine (group size
        64) and ``"w8a8"`` to per-channel int8. q/k/v and gate/up are then
        fused into one product each."""
        if quantize_bits not in (None, "w8a8", 4, 8):
            raise ValueError(f"quantize_bits={quantize_bits!r}: 4, 8 or 'w8a8'")
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir)
        config = Qwen3TTSConfig.from_dict(cfg_dict)
        flat = loading.load_safetensors(model_dir)
        talker = {k[len("talker."):]: v for k, v in flat.items()
                  if k.startswith("talker.")
                  and qwen3_speaker.SPEAKER_ENCODER_MARKER not in k.split(".")}
        if not talker:
            raise KeyError(f"{model_dir}: no talker.* weights")
        params = loading.cast_floats(loading.unflatten(talker), dtype)
        params = llama.maybe_stack(params)
        if "code_predictor" in params:
            params["code_predictor"] = llama.maybe_stack(params["code_predictor"])
        params = loading.to_device(params, device)
        if config.quantization:
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        elif quantize_bits == "w8a8":
            params = quant.quantize_tree(params, scheme="w8a8")
        elif quantize_bits:
            params = quant.quantize_tree(params, bits=quantize_bits, scheme="mlx")
        params = llama.fuse_projections(params)
        if "code_predictor" in params:
            params["code_predictor"] = llama.fuse_projections(params["code_predictor"])
        tokenizer = None
        if (Path(model_dir) / "tokenizer.json").exists():
            from tokenizers import Tokenizer

            tokenizer = Tokenizer.from_file(str(Path(model_dir) / "tokenizer.json"))
        speaker_encoder = None
        if cfg_dict.get("tts_model_type", "base") == "base":
            spk = qwen3_speaker.sanitize_speaker_encoder(flat)
            if spk:
                speaker_encoder = qwen3_speaker.Qwen3SpeakerEncoder(
                    qwen3_speaker.SpeakerEncoderConfig.from_dict(
                        cfg_dict.get("speaker_encoder_config", {}) or {}),
                    loading.to_device(loading.cast_floats(loading.unflatten(spk), torch.float32),
                                      device))
        codec = codec_encoder = None
        st_dir = Path(model_dir) / "speech_tokenizer"
        if st_dir.is_dir():
            codec = Qwen3CodecDecoder.from_pretrained(str(st_dir), device=device)
            enc = sanitize_encoder(loading.load_safetensors(st_dir))
            if enc:
                st_cfg = hub.load_config(st_dir) if (st_dir / "config.json").exists() else {}
                codec_encoder = Qwen3CodecEncoder(
                    encoder_config_from_dict(st_cfg),
                    loading.cast_floats(loading.unflatten(enc), torch.float32),
                    valid_num_quantizers=st_cfg.get("encoder_valid_num_quantizers", 16),
                    device=device)
        return cls(config, params, tokenizer, codec, dtype, codec_encoder=codec_encoder,
                   speaker_encoder=speaker_encoder)

    # -- prompt building -------------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _text_embed(self, ids) -> torch.Tensor:
        emb = nn.embedding(self.params["model"]["text_embedding"], self._ids(ids))
        tp = self.params["text_projection"]
        return nn.linear(tp["linear_fc2"], nn.silu(nn.linear(tp["linear_fc1"], emb)))

    def _codec_embed(self, ids) -> torch.Tensor:
        if not isinstance(ids, torch.Tensor):
            ids = self._ids(ids)
        return nn.embedding(self.params["model"]["codec_embedding"], ids)

    @torch.inference_mode()
    def prepare_generation_inputs(self, text: str, language: str = "auto",
                                  instruct: str | None = None, speaker: str | None = None):
        """The talker's prompt: ``(input_embeds [1, P, D], trailing [1, N,
        D], tts_pad [1, 1, D])``. The prompt is the optional instruction,
        the ChatML role header, the codec prefix (think / language / speaker
        / pad / bos ids, their first rows over tts pads and bos) and the
        first text token over codec bos; ``trailing`` is the rest of the
        text and tts eos, fed one a frame."""
        tcfg = self.config.talker
        chat = f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"
        text_embed = self._text_embed([self.tokenizer.encode(chat).ids])  # [1, T, D]
        tts = self._text_embed([[self.config.tts_bos_token_id, self.config.tts_eos_token_id,
                                 self.config.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]

        spk_embed = None
        if speaker and tcfg.spk_id:
            spk = tcfg.spk_id.get(speaker.lower())
            if spk is not None:
                spk_embed = self._codec_embed([[int(spk)]])
        codec_embed = self._codec_prefix(language, spk_embed)

        pieces = []
        if instruct:
            pieces.append(self._text_embed(
                [self.tokenizer.encode(f"<|im_start|>user\n{instruct}<|im_end|>\n").ids]))
        pad_count = codec_embed.shape[1] - 2
        pads = tts_pad.expand(1, pad_count, tts_pad.shape[-1])
        combined = torch.cat([pads, tts_bos], dim=1) + codec_embed[:, :-1]
        pieces += [text_embed[:, :3], combined, text_embed[:, 3:4] + codec_embed[:, -1:]]
        input_embeds = torch.cat(pieces, dim=1)
        trailing = torch.cat([text_embed[:, 4:max(text_embed.shape[1] - 5, 4)], tts_eos], dim=1)
        return input_embeds, trailing, tts_pad

    # -- reference-audio cloning (in-context prompt) ---------------------------------------

    def _codec_prefix(self, language: str | None, speaker_row: torch.Tensor | None
                      ) -> torch.Tensor:
        """The codec prefix ``[1, n, D]``: think / language ids (or
        nothink), the speaker row when given, then codec pad and bos."""
        tcfg = self.config.talker
        language_id = None
        if language and language.lower() != "auto" and tcfg.codec_language_id:
            language_id = tcfg.codec_language_id.get(language.lower())
        if language_id is not None:
            prefill = [tcfg.codec_think_id, tcfg.codec_think_bos_id, language_id,
                       tcfg.codec_think_eos_id]
        else:
            prefill = [tcfg.codec_nothink_id, tcfg.codec_think_bos_id, tcfg.codec_think_eos_id]
        parts = [self._codec_embed([prefill])]
        if speaker_row is not None:
            parts.append(speaker_row.reshape(1, 1, -1).to(parts[0].dtype))
        parts.append(self._codec_embed([[tcfg.codec_pad_id, tcfg.codec_bos_id]]))
        return torch.cat(parts, dim=1)

    def extract_speaker_embedding(self, ref_audio) -> torch.Tensor | None:
        """Waveform -> ``[1, enc_dim]``, or None without a speaker encoder."""
        if self.speaker_encoder is None:
            return None
        return self.speaker_encoder(np.asarray(ref_audio, np.float32))

    def _reference_audio_context(self, ref_audio):
        """``(speaker embedding or None, ref_codes [1, nq, T] numpy,
        codec_embed_icl [1, T + 1, D])`` of a clip, with a one-entry cache
        keyed on the SHA-1 of its samples' bytes (a hash of the whole clip:
        clips of one length that start and end alike must not collide)."""
        import hashlib

        ref_audio = np.asarray(ref_audio, np.float32).reshape(-1)
        key = hashlib.sha1(ref_audio.tobytes()).hexdigest()
        if self._ref_context_cache is not None and self._ref_context_cache[0] == key:
            return self._ref_context_cache[1]
        spk = self.extract_speaker_embedding(ref_audio)
        codes = self.codec_encoder.encode(ref_audio)
        ctx = (spk, codes.cpu().numpy(), self._codec_embed_icl(codes))
        self._ref_context_cache = (key, ctx)
        return ctx

    def _codec_embed_icl(self, ref_codes) -> torch.Tensor:
        """``[codec bos, the sum of each codebook's embedding of the
        reference codes]``: codebook 0 through the talker's codec
        embedding, codebook g through the code predictor's ``g - 1``."""
        tcfg = self.config.talker
        ref_codes = torch.as_tensor(ref_codes, device=self.device).to(torch.int64)
        emb = self._codec_embed(ref_codes[:, 0])
        cp = self.params["code_predictor"]["model"]["codec_embedding"]
        for i in range(min(tcfg.num_code_groups - 1, ref_codes.shape[1] - 1)):
            emb = emb + nn.embedding(cp[str(i)], ref_codes[:, i + 1])
        return torch.cat([self._codec_embed([[tcfg.codec_bos_id]]), emb], dim=1)

    @torch.inference_mode()
    def prepare_icl_generation_inputs(self, text: str, ref_audio, ref_text: str,
                                      language: str = "auto"):
        """The cloning prompt: ``(input_embeds [1, P, D], trailing, tts_pad,
        ref_codes)``. The prompt is the target's role header, the codec
        prefix (with the speaker row) over tts pads and bos, the reference
        and target text (ChatML headers and tails cut) and tts eos over
        codec pad, then codec bos and the reference frames over tts pad.
        All the text is in the prompt, so ``trailing`` is ``tts_pad``."""
        if self.codec_encoder is None:
            raise AudioGenerationError(
                "ref_audio cloning requires a speech tokenizer encoder, but this checkpoint "
                "does not provide one")
        spk, ref_codes, codec_embed_icl = self._reference_audio_context(ref_audio)

        ref_ids = self.tokenizer.encode(f"<|im_start|>assistant\n{ref_text}<|im_end|>\n").ids
        n = len(ref_ids)
        ref_text_ids = ref_ids[min(3, n):max(min(3, n), n - 2)]
        target_ids = self.tokenizer.encode(f"<|im_start|>assistant\n{text}<|im_end|>\n"
                                           "<|im_start|>assistant\n").ids
        tn = len(target_ids)
        target_text_ids = target_ids[min(3, tn):max(min(3, tn), tn - 5)]

        tts = self._text_embed([[self.config.tts_bos_token_id, self.config.tts_eos_token_id,
                                 self.config.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
        text_embed = torch.cat([self._text_embed([ref_text_ids + target_text_ids]), tts_eos],
                               dim=1)
        codec_pad = self._codec_embed([[self.config.talker.codec_pad_id]])
        icl_input = torch.cat([text_embed + codec_pad.expand_as(text_embed),
                               codec_embed_icl + tts_pad.expand_as(codec_embed_icl)], dim=1)

        codec_prefix = self._codec_prefix(language, spk)
        pads = tts_pad.expand(1, codec_prefix.shape[1] - 2, tts_pad.shape[-1])
        combined = torch.cat([pads, tts_bos], dim=1) + codec_prefix[:, :-1]
        input_embeds = torch.cat([self._text_embed([target_ids[:3]]), combined, icl_input],
                                 dim=1)
        return input_embeds, tts_pad, tts_pad, ref_codes

    # -- the frame step -----------------------------------------------------------------

    def _prefill(self, embeds: torch.Tensor, cache: kv_cache.KVCache) -> kv_cache.KVCache:
        """The prompt through the talker into ``cache`` (its logits are
        not needed: the last prompt row is fed again by the first frame)."""
        _, cache = llama.forward(self.params, None, cache,
                                 _talker_llama_cfg(self.config.talker),
                                 inputs_embeds=embeds, return_hidden=True)
        return cache

    def _frame(self, embeds: torch.Tensor, cache: kv_cache.KVCache, gen, suppress,
               history: torch.Tensor, hist_len: int, gp: AudioGenerateParameters):
        """One talker step and the code predictor's ``G - 1`` passes.
        Returns the frame's codes ``[1, G]`` (on the device), the sum of
        its code embeddings ``[1, 1, D]`` and the talker's cache."""
        logits, hidden, cache = talker_forward(self.params, embeds, cache, self.config.talker)
        c0 = _sample(gen, logits[:, -1], gp.temperature, gp.top_k, gp.top_p,
                     suppress=suppress, history=history, hist_len=hist_len,
                     repetition_penalty=gp.repetition_penalty)
        codes, embed_sum = self._code_predictor_frame(
            hidden[:, -1:], c0, lambda lg, g: _sample(gen, lg, gp.temperature, gp.top_k,
                                                      gp.top_p))
        return codes, embed_sum, cache

    def _lane_frame(self, embeds: torch.Tensor, cache: kv_cache.FusedLaneRow,
                    lanes: torch.Tensor, span: int, sample):
        """One frame of ``n`` serving lanes at once (the serving engine's
        tick; ``_frame`` batched over lanes): a talker step over the ``[n,
        1, D]`` rows (:func:`talker_lanes_forward`), then the code predictor
        over all lanes, pass 0 on ``[n, 2, D]`` and passes 1..G-2 on ``[n,
        1, D]``. ``sample(logits [n, V], group) -> ids [n]`` draws group
        ``group``'s codes (0: the talker's). Returns the codes ``[n, G]``
        and the sums of their embeddings ``[n, 1, D]``; the caller advances
        the lanes' offsets."""
        logits, hidden = talker_lanes_forward(self.params, embeds, cache, lanes, span,
                                              self.config.talker)
        return self._code_predictor_frame(hidden, sample(logits[:, -1], 0), sample)

    def _code_predictor_frame(self, hidden: torch.Tensor, c0: torch.Tensor, sample):
        """Groups 1..G-1 of a frame of ``B`` rows from the talker's last
        hidden state ``[B, 1, D]`` and codebook 0's codes ``c0 [B]``: pass
        0 reads ``[hidden, codebook-0 embedding]``, pass g the embedding of
        group g's code, each through group g's head over one fresh ``G +
        2``-row cache; ``sample(logits, group)`` draws each group's codes.
        Returns the codes ``[B, G]`` and the sum of their embeddings ``[B,
        1, D]``."""
        ccfg = self.config.code_predictor
        G = self.config.talker.num_code_groups
        cp = self.params["code_predictor"]
        cp_cache = kv_cache.init_cache(ccfg.num_hidden_layers, hidden.shape[0],
                                       ccfg.num_key_value_heads, ccfg.head_dim, G + 2,
                                       hidden.dtype, hidden.device)
        c0_embed = self._codec_embed(c0[:, None])
        code_input = torch.cat([hidden, c0_embed], dim=1)  # promotes, as in JAX
        codes, embed_sum = [c0], c0_embed
        for g in range(G - 1):
            cp_logits, cp_cache = code_predictor_forward(cp, code_input, cp_cache, g, ccfg)
            cg = sample(cp_logits[:, -1], g + 1)
            codes.append(cg)
            code_input = nn.embedding(cp["model"]["codec_embedding"][str(g)], cg[:, None])
            embed_sum = embed_sum + code_input
        return torch.stack(codes, dim=1), embed_sum

    # -- generation ---------------------------------------------------------------------

    @torch.inference_mode()
    def _run_iter(self, text, language, instruct, speaker, gp: AudioGenerateParameters,
                  stream: bool = False, ref_audio=None, ref_text=None):
        """Yields ``("chunk", waveform)`` every ``streaming_interval`` of
        frames when ``stream``, then ``("done", (codes, prefill_s,
        generate_s, prompt_rows, ref_codes))`` (``ref_codes`` None unless
        cloning); one host read a frame (the EOS test)."""
        if self.tokenizer is None:
            raise AudioGenerationError("tokenizer not loaded")
        tcfg = self.config.talker
        dev = self.device
        ref_codes = None
        if ref_audio is not None or ref_text:
            if ref_audio is None or not ref_text:
                raise AudioGenerationError("voice cloning requires BOTH ref_audio and ref_text")
            input_embeds, trailing, tts_pad, ref_codes = self.prepare_icl_generation_inputs(
                text, ref_audio, ref_text, language or "auto")
        else:
            input_embeds, trailing, tts_pad = self.prepare_generation_inputs(
                text, language or "auto", instruct, speaker)
        input_embeds, trailing, tts_pad = (t.to(self.dtype)
                                           for t in (input_embeds, trailing, tts_pad))
        max_tokens = min(gp.max_tokens, max(75, 6 * len(self.tokenizer.encode(text).ids)))
        eos = tcfg.codec_eos_token_id
        suppress = torch.zeros((tcfg.vocab_size,), dtype=torch.float32, device=dev)
        suppress[tcfg.vocab_size - SUPPRESSED_BAND:] = -1e9
        suppress[eos] = 0.0

        prefix_len = input_embeds.shape[1]
        cache = kv_cache.init_cache(tcfg.num_hidden_layers, 1, tcfg.num_key_value_heads,
                                    tcfg.head_dim, prefix_len + max_tokens + 2, self.dtype, dev)
        t0 = time.perf_counter()
        cache = self._prefill(input_embeds[:, :-1], cache)
        _sync(dev)
        prefill_time = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(gp.seed if gp.seed is not None else 0)
        history = torch.zeros((1, max(gp.repetition_context_size, 1)), dtype=torch.int64,
                              device=dev)
        hist_pos = 0
        embeds = input_embeds[:, -1:]
        all_codes: list[np.ndarray] = []
        chunk_frames = max(1, int(gp.streaming_interval * CODEC_TOKEN_RATE_HZ))
        decoded = 0
        t1 = time.perf_counter()
        for step in range(max_tokens):
            codes, embed_sum, cache = self._frame(embeds, cache, gen, suppress, history,
                                                  hist_pos, gp)
            codes_np = codes.cpu().numpy()
            if int(codes_np[0, 0]) == eos:
                break
            all_codes.append(codes_np[0])
            history[0, hist_pos % history.shape[1]] = codes[0, 0]
            hist_pos += 1
            text_embed = trailing[:, step:step + 1] if step < trailing.shape[1] else tts_pad
            embeds = text_embed + embed_sum
            if stream and len(all_codes) - decoded >= chunk_frames:
                yield "chunk", self._stream_chunk(all_codes[decoded:])
                decoded = len(all_codes)
        gen_time = time.perf_counter() - t1
        if stream and len(all_codes) > decoded:
            yield "chunk", self._stream_chunk(all_codes[decoded:])
        yield "done", (all_codes, prefill_time, gen_time, prefix_len, ref_codes)

    def _stream_chunk(self, frames: list[np.ndarray]) -> np.ndarray:
        wav = self.codec.streaming_step(np.stack(frames, axis=1)[None])  # codes [1, G, t]
        return wav[0].to(torch.float32).cpu().numpy()

    def generate(self, text: str, voice: str | None = None, ref_audio=None,
                 ref_text: str | None = None, language: str | None = None,
                 generation_parameters: AudioGenerateParameters | None = None) -> np.ndarray:
        gp = generation_parameters or self.default_generation_parameters()
        speaker, instruct = self._parse_voice(voice)
        result = None
        for kind, payload in self._run_iter(text, language, instruct, speaker, gp,
                                            ref_audio=ref_audio, ref_text=ref_text):
            result = payload
        codes, ref_codes = result[0], result[4]
        if not codes:
            raise AudioGenerationError("no audio codes generated")
        if self.codec is None:
            raise AudioGenerationError("speech tokenizer decoder not loaded")
        stacked = np.stack(codes, axis=1)[None]  # codes [1, G, T]
        if ref_codes is None:
            return self.codec.decode(stacked)[0].to(torch.float32).cpu().numpy()
        # the reference codes decoded in front, then their share of the
        # waveform cut off
        full = np.concatenate([ref_codes[:, :stacked.shape[1]], stacked], axis=2)
        audio = self.codec.decode(full)[0].to(torch.float32).cpu().numpy()
        cut = int(ref_codes.shape[2] / max(full.shape[2], 1) * len(audio))
        return audio[cut:] if 0 < cut < len(audio) else audio

    def generate_stream(self, text: str, voice: str | None = None, ref_audio=None,
                        ref_text: str | None = None, language: str | None = None,
                        generation_parameters: AudioGenerateParameters | None = None):
        """Yields :class:`AudioGeneration` audio events, one a chunk of
        ``streaming_interval`` seconds of frames decoded by the codec's
        streaming step, then an info event."""
        gp = generation_parameters or self.default_generation_parameters()
        if self.codec is None:
            raise AudioGenerationError("speech tokenizer decoder not loaded")
        speaker, instruct = self._parse_voice(voice)
        self.codec.reset_streaming_state()
        total = 0
        stats = None
        for kind, payload in self._run_iter(text, language, instruct, speaker, gp,
                                            stream=True, ref_audio=ref_audio,
                                            ref_text=ref_text):
            if kind == "chunk":
                total += len(payload)
                yield AudioGeneration.from_audio(payload)
            else:
                stats = payload
        codes, prefill_time, gen_time, prefix_len, _ = stats
        yield AudioGeneration.from_info(AudioGenerationInfo(
            prompt_token_count=prefix_len, generation_token_count=len(codes),
            prompt_time=prefill_time, generate_time=gen_time,
            audio_duration=total / self.sample_rate))

    def _parse_voice(self, voice: str | None):
        """``custom_voice``: "speaker" or "speaker, instruction";
        ``voice_design``: the voice string is the instruction."""
        if not voice:
            return None, None
        if self.config.tts_model_type == "custom_voice":
            if "," in voice:
                speaker, _, instruct = voice.partition(",")
                return speaker.strip(), instruct.strip() or None
            return voice.strip(), None
        return None, voice
