"""Qwen3-ASR: a block-attention audio tower and a Qwen3 text decoder (port
of tpu_audio.models.stt.qwen3_asr).

- Frontend: the generic log-mel (``core.dsp.mel_spectrogram``: symmetric
  Hann, HTK filters with slaney norm), whose ``log10(max(|S|^2 @ F,
  1e-10))`` is ``ops.mel.fused_log_mel`` (kernel 1 on CUDA).
- Audio tower: a window of up to ``n_window_infer`` mel frames is cut into
  ``2 * n_window``-frame conv chunks and padded to the full window's chunk
  count (8 at the defaults); three stride-2 3x3 convolutions with GELU run
  channels-last on ``[N, n_mels, T, 1]``, their output flattens channel-major
  and frequency-minor (``[N, t, c * f]``) into ``conv_out``, sinusoidal
  positions restart in every chunk, and the chunks' tokens then attend to
  each other across the window (pre-LN layers, full attention inside the
  window only). The mask keeps ``n_chunks * tokens_per_chunk`` tokens, so a
  partial last chunk's padded tail is attended to; only afterwards are the
  valid tokens kept. Windows encode independently, which is what streaming
  uses (``encode_single_window``).
- Decoder: the audio features replace the prompt's ``<|audio_pad|>`` run in
  its token embeddings (rows of ``nn.embedding``: f32 on a packed MLX table),
  the merged embeddings are cast to the model dtype and prefilled through
  ``llama.forward(inputs_embeds=...)``, and ``core.ar_loop`` decodes through
  ``llama.forward`` (kernel 7 for every product of 64 rows or fewer on an
  MLX tree; a longer prefill dequantizes). The loop stops on ``<|im_end|>``
  (151645) alone; ``<|endoftext|>`` (151643) is filtered out afterwards.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, loading, nn, quant
from tpu_audio_torch.core.ar_loop import make_decode_chunk
from tpu_audio_torch.core.generation import STTGenerateParameters, STTOutput, STTSegment
from tpu_audio_torch.core.sampling import SamplingParams
from tpu_audio_torch.models import llama

__all__ = ["Qwen3ASR", "Qwen3ASRConfig", "AudioEncoderConfig", "split_audio_into_chunks",
           "feat_extract_output_lengths", "encode_window", "init_random_params"]

SAMPLE_RATE = 16000
EOS_IDS = (151645, 151643)  # <|im_end|> stops the loop; <|endoftext|> is filtered


def split_audio_into_chunks(audio: np.ndarray, sample_rate: int,
                            chunk_duration: float = 1200.0, min_chunk_duration: float = 1.0,
                            search_expand_sec: float = 5.0, min_window_ms: float = 100.0
                            ) -> list[tuple[np.ndarray, float]]:
    """Split long audio at low-energy points into pieces of at most
    ``chunk_duration`` seconds: around each nominal cut, a window of
    +-``search_expand_sec`` is scanned with a ``min_window_ms`` sliding mean
    energy and the cut lands at its quietest point (at least one second
    after the piece's start). Pieces shorter than ``min_chunk_duration``
    are zero-padded up to it; stereo is averaged. Returns ``[(piece,
    offset_seconds), ...]``."""
    wav = np.asarray(audio, np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    total = len(wav)
    min_samples = int(min_chunk_duration * sample_rate)

    def padded(chunk: np.ndarray) -> np.ndarray:
        if len(chunk) < min_samples:
            chunk = np.pad(chunk, (0, min_samples - len(chunk)))
        return chunk

    if total / sample_rate <= chunk_duration:
        return [(padded(wav), 0.0)]
    chunks: list[tuple[np.ndarray, float]] = []
    max_chunk = int(chunk_duration * sample_rate)
    search = int(search_expand_sec * sample_rate)
    win = int(min_window_ms * sample_rate / 1000.0)
    start = 0
    while start < total:
        end = min(start + max_chunk, total)
        if end >= total:
            chunks.append((padded(wav[start:]), start / sample_rate))
            break
        lo = max(start, end - search)
        hi = min(total, end + search)
        if hi - lo > win:
            csum = np.concatenate([[0.0], np.cumsum(wav[lo:hi].astype(np.float64) ** 2)])
            energy = (csum[win:] - csum[:-win]) / win
            cut = lo + int(np.argmin(energy)) + win // 2
        else:
            cut = end
        cut = max(cut, start + sample_rate)
        chunks.append((padded(wav[start:min(cut, total)]), start / sample_rate))
        start = cut
    return chunks


@dataclass
class AudioEncoderConfig:
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    downsample_hidden_size: int = 480
    num_mel_bins: int = 128
    output_dim: int = 2048
    n_window: int = 50
    n_window_infer: int = 800
    max_source_positions: int = 1500
    conv_chunksize: int = 500

    @classmethod
    def from_dict(cls, d: dict) -> "AudioEncoderConfig":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


@dataclass
class Qwen3ASRConfig:
    audio: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    text: llama.LlamaConfig = field(default_factory=llama.LlamaConfig)
    audio_token_id: int = 151646
    support_languages: list = field(default_factory=list)
    quantization: dict | None = None
    # the forced aligner's timestamp head (models.stt.qwen3_aligner; unused by Qwen3-ASR)
    classify_num: int = 5000
    timestamp_token_id: int = 151705
    timestamp_segment_time: float = 80.0

    @classmethod
    def from_dict(cls, d: dict) -> "Qwen3ASRConfig":
        text_cfg = llama.LlamaConfig.from_dict(d.get("text_config") or {})
        text_cfg.qk_norm = True  # Qwen3 attention
        return cls(audio=AudioEncoderConfig.from_dict(d.get("audio_config") or {}),
                   text=text_cfg, audio_token_id=d.get("audio_token_id", 151646),
                   support_languages=d.get("support_languages") or [],
                   quantization=d.get("quantization"),
                   classify_num=d.get("classify_num", 5000),
                   timestamp_token_id=d.get("timestamp_token_id", 151705),
                   timestamp_segment_time=d.get("timestamp_segment_time", 80.0))


def feat_extract_output_lengths(lengths):
    """Output lengths of the three stride-2 convolutions."""
    out = lengths
    for _ in range(3):
        out = (out + 1) // 2
    return out


def _sinusoid_pe(length: int, channels: int) -> np.ndarray:
    half = channels // 2
    log_inc = math.log(10000.0) / max(half - 1, 1)
    scaled = np.arange(length)[:, None] * np.exp(-log_inc * np.arange(half))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _encoder_layer(p: dict, x: torch.Tensor, cfg: AudioEncoderConfig, mask=None):
    """One pre-LN transformer layer of the audio tower."""
    h = nn.layer_norm(p["self_attn_layer_norm"], x)
    b, t, d = h.shape
    n_heads = cfg.encoder_attention_heads
    hd = d // n_heads
    ap = p["self_attn"]
    q, k, v = (nn.linear(ap[n], h).reshape(b, t, n_heads, hd).transpose(1, 2)
               for n in ("q_proj", "k_proj", "v_proj"))
    o = nn.sdpa(q, k, v, mask=mask)
    x = x + nn.linear(ap["out_proj"], o.transpose(1, 2).reshape(b, t, d))
    h = nn.layer_norm(p["final_layer_norm"], x)
    return x + nn.linear(p["fc2"], nn.gelu(nn.linear(p["fc1"], h)))


def encode_window(params: dict, mel_chunks: torch.Tensor, valid_tokens: int,
                  cfg: AudioEncoderConfig) -> torch.Tensor:
    """One window's conv chunks ``[n_chunks, 2 * n_window, n_mels]``
    (zero-padded) -> ``[n_chunks * tokens_per_chunk, output_dim]``; the
    first ``valid_tokens`` tokens attend to each other."""
    p = params["audio_tower"] if "audio_tower" in params else params
    x = mel_chunks.transpose(1, 2)[..., None]  # [N, n_mels, T, 1] channels-last
    with nn.f32_convolutions():
        for name in ("conv2d1", "conv2d2", "conv2d3"):
            x = nn.gelu(nn.conv2d(p[name], x, stride=(2, 2), padding=(1, 1)))
    n, f, t, c = x.shape
    x = nn.linear(p["conv_out"], x.permute(0, 2, 3, 1).reshape(n, t, c * f))
    x = x + torch.from_numpy(_sinusoid_pe(t, x.shape[-1])).to(x.device, x.dtype)[None]
    x = x.reshape(1, n * t, -1)
    keep = torch.arange(n * t, device=x.device) < valid_tokens
    mask = (keep[None, :] & keep[:, None])[None, None]
    for i in range(cfg.encoder_layers):
        x = _encoder_layer(p["layers"][str(i)], x, cfg, mask=mask)
    x = nn.layer_norm(p["ln_post"], x)
    x = nn.linear(p["proj2"], nn.gelu(nn.linear(p["proj1"], x)))
    return x[0]


def _first_device(params) -> torch.device:
    lead = next(t for t in llama._leaves(params) if t.is_floating_point())
    return lead.device


def _sanitize(weights: dict) -> dict:
    """Drop rotary ``inv_freq`` buffers and strip the ``thinker.`` prefix."""
    out = {}
    for k, v in weights.items():
        if "rotary_emb.inv_freq" in k:
            continue
        out[k[len("thinker."):] if k.startswith("thinker.") else k] = v
    return out


class Qwen3ASR:
    """Qwen3-ASR with ``generate`` / ``generate_stream`` and the streaming
    session's hooks (``encode_single_window``, ``decode_features_tokens``)."""

    def __init__(self, config: Qwen3ASRConfig, params: dict, tokenizer=None,
                 dtype=torch.bfloat16):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = _first_device(params)
        self._decoders = {}

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16, device="cuda",
                        quantize=None) -> "Qwen3ASR":
        """Load a local checkpoint directory onto ``device``: the
        ``thinker.`` prefix stripped, rotary buffers dropped, the text layers
        stacked, a ``quantization`` block's packed triples tagged as MLX
        leaves, then q/k/v and gate/up fused, in that order (fusing untagged
        words would drop their scales and biases). ``quantize`` is accepted
        for ``load_model``'s callers: any value but None raises (load an
        MLX-quantized checkpoint instead)."""
        if quantize is not None:
            raise ValueError(f"quantize={quantize!r}: Qwen3-ASR has no load-time "
                             "quantization (load an MLX-quantized checkpoint instead)")
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = Qwen3ASRConfig.from_dict(hub.load_config(model_dir))
        params = loading.load_params(model_dir, sanitize=_sanitize, dtype=dtype)
        params = loading.to_device(llama.maybe_stack(params), device)
        if config.quantization:
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        params = llama.fuse_projections(params)
        tokenizer = None
        if (model_dir / "tokenizer.json").exists():
            from tokenizers import Tokenizer

            tokenizer = Tokenizer.from_file(str(model_dir / "tokenizer.json"))
        return cls(config, params, tokenizer, dtype)

    # -- audio features -------------------------------------------------------

    def preprocess_audio(self, audio) -> tuple[torch.Tensor, int]:
        """-> (mel ``[T, n_mels]`` f32 on the model's device, the audio
        token count of the whole mel)."""
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.ascontiguousarray(audio, np.float32))
        mel = dsp.mel_spectrogram(audio.to(torch.float32), SAMPLE_RATE, 400, 160,
                                  self.config.audio.num_mel_bins, device=self.device)
        return mel, int(feat_extract_output_lengths(mel.shape[0]))

    @torch.no_grad()
    def encode_audio(self, mel: torch.Tensor) -> torch.Tensor:
        """Window by window: mel ``[T, n_mels]`` -> features ``[tokens,
        output_dim]`` (windows are independent)."""
        acfg = self.config.audio
        win = acfg.n_window_infer
        outs = [self.encode_single_window(mel[s:s + win]) for s in range(0, mel.shape[0], win)]
        if not outs:
            return torch.zeros((0, acfg.output_dim), dtype=self.dtype, device=self.device)
        return torch.cat(outs)

    @torch.no_grad()
    def encode_single_window(self, mel_window) -> torch.Tensor:
        """Up to ``n_window_infer`` mel frames -> ``[tokens, output_dim]`` in
        the model dtype. The window is padded to the full window's bucket of
        conv chunks; the attention keeps ``n_chunks * tokens_per_chunk``
        tokens, and each chunk's valid tokens are kept afterwards."""
        acfg = self.config.audio
        if not isinstance(mel_window, torch.Tensor):
            mel_window = torch.from_numpy(np.ascontiguousarray(mel_window, np.float32))
        mel_window = mel_window.to(self.device, torch.float32)
        chunk = acfg.n_window * 2
        n_frames = mel_window.shape[0]
        n_chunks = max(1, math.ceil(n_frames / chunk))
        bucket = max(1, math.ceil(acfg.n_window_infer / chunk), n_chunks)
        flat = torch.zeros((bucket * chunk, acfg.num_mel_bins), dtype=torch.float32,
                           device=self.device)
        flat[:n_frames] = mel_window
        per_chunk = int(feat_extract_output_lengths(chunk))
        last_valid = int(feat_extract_output_lengths(n_frames - (n_chunks - 1) * chunk))
        out = encode_window(self.params, flat.view(bucket, chunk, -1).to(self.dtype),
                            n_chunks * per_chunk, acfg)
        # every chunk before the last is whole: its tokens are all valid
        return out[:(n_chunks - 1) * per_chunk + last_valid]

    # -- prompt ---------------------------------------------------------------

    def build_prompt(self, num_audio_tokens: int, context: str = "",
                     language: str | None = None) -> list[int]:
        lang_prefix = f"language {language}<asr_text>" if language else ""
        text = (f"<|im_start|>system\n{context}<|im_end|>\n"
                "<|im_start|>user\n<|audio_start|>"
                + "<|audio_pad|>" * num_audio_tokens
                + "<|audio_end|><|im_end|>\n<|im_start|>assistant\n"
                + lang_prefix)
        return list(self.tokenizer.encode(text).ids)

    @torch.no_grad()
    def _merge_audio_features(self, ids: np.ndarray, audio_features: torch.Tensor
                              ) -> torch.Tensor:
        """The prompt's token embeddings ``[1, L, hidden]`` (f32 rows on a
        packed table, the table's dtype otherwise) with the audio features
        over the ``<|audio_pad|>`` run (as many as both have)."""
        ids = np.asarray(ids)
        embeds = nn.embedding(self.params["model"]["embed_tokens"],
                              torch.from_numpy(ids.astype(np.int64)).to(self.device)).clone()
        pos = np.where(ids[0] == self.config.audio_token_id)[0]
        if len(pos):
            n = min(len(pos), audio_features.shape[0])
            embeds[0, pos[0]:pos[0] + n] = audio_features[:n].to(embeds.dtype)
        return embeds

    # -- generation -----------------------------------------------------------

    def _step_fn(self, params, tok, cache):
        logits, cache = llama.forward(params, tok, cache, self.config.text)
        return logits[:, -1], cache

    def generate(self, audio, generation_parameters: STTGenerateParameters | None = None
                 ) -> STTOutput:
        params = generation_parameters or STTGenerateParameters(max_tokens=448)
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        t0 = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        if len(audio) == 0:
            audio = np.zeros(1, np.float32)
        total_duration = len(audio) / SAMPLE_RATE
        texts, segments = [], []
        total_prompt = total_gen = 0
        language = None
        for piece, offset in split_audio_into_chunks(
                audio, SAMPLE_RATE, chunk_duration=params.chunk_duration or 1200.0):
            text, lang, n_prompt, n_gen = self._generate_chunk(piece, params)
            total_prompt += n_prompt
            total_gen += n_gen
            if language is None:
                language = lang
            if text:
                texts.append(text)
                # a piece zero-padded up to the minimum length ends with the audio
                segments.append(STTSegment(
                    text=text, start=offset,
                    end=min(offset + len(piece) / SAMPLE_RATE, total_duration)))
        elapsed = time.perf_counter() - t0
        return STTOutput(text=" ".join(texts), segments=segments, language=language,
                         prompt_token_count=total_prompt, generation_token_count=total_gen,
                         total_time=elapsed, generation_time=elapsed)

    def _generate_chunk(self, audio, params: STTGenerateParameters):
        mel, _ = self.preprocess_audio(audio)
        return self.decode_features(self.encode_audio(mel), params)

    def decode_features(self, feats: torch.Tensor, params: STTGenerateParameters):
        """Encoder features -> (text, language, n_prompt, n_gen)."""
        gen, n_prompt = self.decode_features_tokens(feats, params)
        decoded = self.tokenizer.decode(gen, skip_special_tokens=True)
        lang, text = self._parse_output(decoded, params.language)
        return text, lang, n_prompt, len(gen)

    @torch.no_grad()
    def decode_features_tokens(self, feats: torch.Tensor, params: STTGenerateParameters,
                               forced_tokens=None) -> tuple[list[int], int]:
        """Encoder features -> (token ids with the forced prefix, n_prompt).
        ``forced_tokens`` are teacher-forced after the prompt, so that the
        pass extends them (the streaming session's confirmed tokens). A
        hybrid cache's dense prefix is rounded up to the prefill's length,
        so that the prefill's write lies in it."""
        forced = [int(t) for t in (forced_tokens or [])]
        ids = np.asarray([self.build_prompt(feats.shape[0], language=params.language)
                          + forced], np.int32)
        embeds = self._merge_audio_features(ids, feats)
        tcfg = self.config.text
        prefill_len = embeds.shape[1] - 1
        cache = llama.make_cache(
            tcfg, 1, ids.shape[1] + params.max_tokens + 1, self.dtype,
            kv_bits=params.kv_bits, kv_group_size=params.kv_group_size,
            quantized_kv_start=(max(params.quantized_kv_start, prefill_len)
                                if params.quantized_kv_start else 0), device=self.device)
        _, cache = llama.forward(self.params, None, cache, tcfg,
                                 inputs_embeds=embeds[:, :-1].to(self.dtype))
        key = params.temperature
        if key not in self._decoders:
            self._decoders[key] = make_decode_chunk(
                self._step_fn, SamplingParams(temperature=params.temperature,
                                              repetition_penalty=1.0), history_size=1)
        dev = self.device
        tokens, count, *_ = self._decoders[key](
            self.params, cache, torch.tensor(ids[0, -1:], dtype=torch.int64, device=dev),
            torch.zeros((params.max_tokens,), dtype=torch.int64, device=dev),
            torch.Generator(device=dev).manual_seed(0), EOS_IDS[0],
            torch.zeros((1, 1), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
        gen = [t for t in tokens[:count].tolist() if t not in EOS_IDS]
        return forced + gen, ids.shape[1] - len(forced)

    @staticmethod
    def _parse_output(decoded: str, forced_language: str | None):
        """``language X<asr_text>transcript`` -> (language, transcript)."""
        text = decoded.strip()
        if forced_language:
            marker = "<asr_text>"
            if marker in text:
                text = text.split(marker, 1)[1].strip()
            return forced_language, text
        if text.startswith("language ") and "<asr_text>" in text:
            head, _, rest = text.partition("<asr_text>")
            return head[len("language "):].strip() or None, rest.strip()
        return ("English", text) if text else (None, "")

    def generate_stream(self, audio, generation_parameters=None):
        out = self.generate(audio, generation_parameters)
        yield {"type": "token", "text": out.text}
        yield {"type": "result", "output": out}


def init_random_params(cfg: Qwen3ASRConfig, seed: int = 0, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Random params at ``cfg``'s shapes, in the loaded tree's layout (the
    audio tower per layer, the text decoder stacked and unfused), drawn on
    ``device``: the audio tower from a ``torch.Generator`` seeded with
    ``seed + 71`` (linears and convs N(0, 1/fan-in), biases N(0, 0.02),
    LayerNorm weights 1 + N(0, 0.1) and biases N(0, 0.02)), the text
    decoder by ``llama.init_random_params(on_device=True)``."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed + 71)
    a = cfg.audio

    def rand(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(
            std).to(dtype)

    def lin(o, i, bias=True):
        p = {"weight": rand((o, i), i ** -0.5)}
        if bias:
            p["bias"] = rand((o,), 0.02)
        return p

    def norm(n):
        return {"weight": (1.0 + rand((n,), 0.1).float()).to(dtype), "bias": rand((n,), 0.02)}

    ds, d = a.downsample_hidden_size, a.d_model
    f = a.num_mel_bins
    for _ in range(3):
        f = (f + 1) // 2
    tower = {f"conv2d{i}": {"weight": rand((ds, ic, 3, 3), (9 * ic) ** -0.5),
                            "bias": rand((ds,), 0.02)}
             for i, ic in ((1, 1), (2, ds), (3, ds))}
    tower["conv_out"] = lin(d, ds * f, bias=False)
    tower["layers"] = {str(i): {
        "self_attn_layer_norm": norm(d), "final_layer_norm": norm(d),
        "self_attn": {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "fc1": lin(a.encoder_ffn_dim, d), "fc2": lin(d, a.encoder_ffn_dim)}
        for i in range(a.encoder_layers)}
    tower.update(ln_post=norm(d), proj1=lin(d, d), proj2=lin(a.output_dim, d))
    params = llama.init_random_params(cfg.text, seed=seed, dtype=dtype, device=device,
                                      on_device=True)
    params["audio_tower"] = tower
    return params
