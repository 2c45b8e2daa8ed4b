"""MOSS-Transcribe-Diarize on PyTorch: timestamped transcription with
speaker labels (port of tpu_audio.models.stt.moss_diarize).

- Audio: every 30 s piece is zero-padded to 30 s and turned into the
  Whisper log-mel (``dsp.log_mel_spectrogram``, kernel 1 on CUDA: one
  launch a piece); all pieces go through one batched
  ``whisper.encoder_forward``; each piece's valid ``tokens x merge``
  frames are concatenated, merged 4 to 1 in time and mapped into the
  language model's space by the adaptor (Linear, SiLU, Linear,
  LayerNorm).
- Prompt: ChatML around an audio span of ``<|audio_pad|>`` rows (12.5 a
  second) with literal digit tokens as time markers every 5 s; the audio
  rows are scattered over the pad positions, which the markers make
  non-contiguous.
- Decoder: a Qwen3 ``llama.forward`` (kernel 7 for every product of a
  decode step on an MLX tree; a longer prefill dequantizes). The greedy
  loop stops when the next token is an EOS id or when the last 24 tokens
  hold 3 or fewer distinct ones; both tests run on the device, and the
  host reads the stop flag every ``SYNC_EVERY`` steps. The output reads
  ``[12.34][S01] text [15.60]`` and is parsed into segments.

A config whose ``audio_token_id`` lies past the text vocabulary raises at
construction (the JAX package clamps its embedding gather there), and so
does a prompt id past it. EOS ids past the vocabulary (the tiny test
checkpoints') cannot be emitted, so such a loop stops on the guard or at
``max_tokens``, as in the JAX package.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import dsp, hub, loading, nn, quant
from tpu_audio_torch.core.ar_loop import SYNC_EVERY, _categorical
from tpu_audio_torch.core.generation import STTGenerateParameters, STTOutput, STTSegment
from tpu_audio_torch.models import llama
from tpu_audio_torch.models.stt import whisper as whisper_mod
from tpu_audio_torch.models.stt.qwen3_asr import _first_device

__all__ = ["MossTranscribeDiarize", "MossTranscribeDiarizeConfig", "sanitize",
           "init_random_params"]

SAMPLE_RATE = 16000
HOP_LENGTH = 160
CHUNK_SAMPLES = 30 * SAMPLE_RATE
ENCODER_STRIDE = 2  # conv2 stride inside the whisper encoder
RING = 24  # the degenerate-tail guard's window
RING_MAX_UNIQUE = 3

AUDIO_PAD = "<|audio_pad|>"
AUDIO_START = "<|audio_start|>"
AUDIO_END = "<|audio_end|>"

DEFAULT_PROMPT = (
    "Transcribe the audio into text. Start each segment with the start "
    "timestamp and speaker label ([S01], [S02], [S03], ...), write the "
    "corresponding spoken content, and end each segment with the ending "
    "timestamp to clearly mark the segment range."
)

_TS_TAG = re.compile(r"\[(\d+(?:[.,]\d+)?)\]")
_SEGMENT = re.compile(r"\[(\d+(?:[.,]\d+)?)\]\[(S\d+)\](.*?)\[(\d+(?:[.,]\d+)?)\]", re.DOTALL)


@dataclass
class MossTranscribeDiarizeConfig:
    text: llama.LlamaConfig = field(default_factory=llama.LlamaConfig)
    audio: whisper_mod.WhisperConfig = field(default_factory=whisper_mod.WhisperConfig)
    audio_token_id: int = 151671
    audio_merge_size: int = 4
    sample_rate: int = 16000
    quantization: dict | None = None
    # processor_config.json
    audio_tokens_per_second: float = 12.5
    time_marker_every_seconds: int = 5
    enable_time_marker: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "MossTranscribeDiarizeConfig":
        text = llama.LlamaConfig.from_dict(d.get("text_config") or {})
        text.qk_norm = True  # Qwen3 attention
        text.tie_word_embeddings = d.get("tie_word_embeddings", True)
        audio = whisper_mod.WhisperConfig.from_dict(
            d.get("audio_config")
            or {"num_mel_bins": 80, "d_model": 1024, "encoder_layers": 24,
                "encoder_attention_heads": 16, "encoder_ffn_dim": 4096,
                "max_source_positions": 1500})
        return cls(text=text, audio=audio,
                   audio_token_id=d.get("audio_token_id", 151671),
                   audio_merge_size=d.get("audio_merge_size", 4),
                   sample_rate=d.get("sample_rate", 16000),
                   quantization=d.get("quantization") or d.get("quantization_config"))


_VQ_IDX = {"0": "fc1", "2": "fc2", "3": "norm"}


def sanitize(weights: dict) -> dict:
    """Checkpoint keys -> the tree's: the ``vq_adwaptor`` typo fixed, the
    adaptor's Sequential indices 0/2/3 named fc1/fc2/norm, the Whisper
    encoder re-rooted under ``whisper.model.encoder`` (MLX ``[O, K, I]``
    conv weights transposed to ``[O, I, K]``), the language model under
    ``language_model.model`` and ``lm_head`` under ``language_model``."""
    out = {}
    for k, v in weights.items():
        if k == "lm_head.weight":
            out["language_model.lm_head.weight"] = v
            continue
        k = k.replace("model.vq_adwaptor.", "model.vq_adaptor.")
        if k.startswith("model.vq_adaptor."):
            parts = [p for p in k[len("model.vq_adaptor."):].split(".") if p != "layers"]
            if parts and parts[0] in _VQ_IDX:
                out[f"vq_adaptor.{_VQ_IDX[parts[0]]}.{'.'.join(parts[1:])}"] = v
            continue
        if k.startswith("model.whisper_encoder."):
            k = "whisper.model.encoder." + k[len("model.whisper_encoder."):]
            if "conv" in k and k.endswith(".weight") and v.ndim == 3 and v.shape[1] < v.shape[2]:
                v = v.permute(0, 2, 1).contiguous()
            out[k] = v
            continue
        if k.startswith("model.language_model."):
            out["language_model.model." + k[len("model.language_model."):]] = v
            continue
        out[k] = v
    return out


def _adaptor_forward(params: dict, feats: torch.Tensor, merge: int) -> torch.Tensor:
    """Merge ``merge`` frames in time, then Linear, SiLU, Linear,
    LayerNorm: ``[T, D]`` -> ``[T // merge, lm_d]``."""
    t, d = feats.shape
    n = t // merge
    merged = feats[:n * merge].reshape(n, merge * d)
    p = params["vq_adaptor"]
    h = nn.linear(p["fc2"], nn.silu(nn.linear(p["fc1"], merged)))
    return nn.layer_norm(p["norm"], h)


class MossTranscribeDiarize:
    """MOSS-Transcribe-Diarize with ``generate`` / ``generate_stream`` and
    the streaming session's hook ``streaming_transcribe_window``."""

    eos_token_ids = (151643, 151645)

    def __init__(self, config: MossTranscribeDiarizeConfig, params: dict, tokenizer=None,
                 dtype=torch.bfloat16):
        vocab = config.text.vocab_size
        if config.audio_token_id >= vocab:
            raise ValueError(
                f"audio_token_id {config.audio_token_id} lies past the text vocabulary "
                f"({vocab} rows): give the config the checkpoint's text_config")
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.sample_rate = config.sample_rate
        self.device = _first_device(params)
        self._digit_ids: dict[str, int] = {}
        if tokenizer is not None:
            self._init_digit_ids()

    # -- loading --------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.bfloat16, device="cuda",
                        quantize=None) -> "MossTranscribeDiarize":
        """Load a local checkpoint directory onto ``device``: sanitized, the
        encoder's and the language model's layers stacked, the tied
        ``lm_head`` dropped, a ``quantization`` block's packed triples
        tagged as MLX leaves, then q/k/v and gate/up fused, in that order
        (fusing untagged words would drop their scales and biases).
        ``processor_config.json`` sets the time markers. ``quantize`` is
        accepted for ``load_model``'s callers: any value but None raises."""
        if quantize is not None:
            raise ValueError(f"quantize={quantize!r}: MOSS-Transcribe-Diarize has no "
                             "load-time quantization (load an MLX-quantized checkpoint)")
        model_dir = hub.resolve_model_dir(repo_or_path)
        config = MossTranscribeDiarizeConfig.from_dict(hub.load_config(model_dir))
        proc = model_dir / "processor_config.json"
        if proc.exists():
            pd = json.loads(proc.read_text())
            config.audio_tokens_per_second = pd.get("audio_tokens_per_second",
                                                    config.audio_tokens_per_second)
            config.time_marker_every_seconds = pd.get("time_marker_every_seconds",
                                                      config.time_marker_every_seconds)
            config.enable_time_marker = pd.get("enable_time_marker", config.enable_time_marker)
        params = loading.load_params(model_dir, sanitize=sanitize, dtype=dtype)
        if "whisper" in params:
            params["whisper"] = loading.stack_layer_params(params["whisper"])
        if "language_model" in params:
            params["language_model"] = llama.maybe_stack(params["language_model"])
        if config.text.tie_word_embeddings:
            params.get("language_model", {}).pop("lm_head", None)
        params = loading.to_device(params, device)
        if config.quantization:
            q = config.quantization
            params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
        if "language_model" in params:
            params["language_model"] = llama.fuse_projections(params["language_model"])
        tokenizer = None
        if (model_dir / "tokenizer.json").exists():
            from tokenizers import Tokenizer

            tokenizer = Tokenizer.from_file(str(model_dir / "tokenizer.json"))
        return cls(config, params, tokenizer, dtype)

    def _init_digit_ids(self):
        for digit in "0123456789":
            enc = self.tokenizer.encode(digit).ids
            if len(enc) == 1:
                self._digit_ids[digit] = enc[0]

    # -- audio frontend ---------------------------------------------------------

    def _audio_token_length(self, num_samples: int) -> int:
        """``(n - 1) // (hop * stride * merge) + 1`` audio rows."""
        stride = HOP_LENGTH * ENCODER_STRIDE * self.config.audio_merge_size
        return (max(1, num_samples) - 1) // stride + 1

    @torch.no_grad()
    def encode_audio(self, audio) -> torch.Tensor:
        """Waveform -> audio rows ``[tokens, lm_d]`` in the model dtype, on
        the model's device."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        mels, keep_frames = [], []
        for s in range(0, max(len(audio), 1), CHUNK_SAMPLES):
            piece = audio[s:s + CHUNK_SAMPLES]
            keep_frames.append(self._audio_token_length(len(piece))
                               * self.config.audio_merge_size)
            padded = np.pad(piece, (0, CHUNK_SAMPLES - len(piece)))
            mels.append(dsp.log_mel_spectrogram(padded, n_mels=self.config.audio.num_mel_bins,
                                                device=self.device).t())
        feats = whisper_mod.encoder_forward(self.params["whisper"],
                                            torch.stack(mels).to(self.dtype), self.config.audio)
        flat = torch.cat([feats[i, :n] for i, n in enumerate(keep_frames)])
        return _adaptor_forward(self.params, flat, self.config.audio_merge_size)

    # -- prompt -------------------------------------------------------------------

    def _audio_span_ids(self, n_tokens: int) -> list[int]:
        """``n_tokens`` audio pads with the digits of ``5``, ``10``, ...
        inserted after each ``time_marker_every_seconds`` of them."""
        cfg = self.config
        pad = cfg.audio_token_id
        if (not cfg.enable_time_marker or n_tokens <= 0
                or cfg.time_marker_every_seconds <= 0 or not self._digit_ids):
            return [pad] * max(n_tokens, 0)
        per_marker = int(cfg.audio_tokens_per_second * cfg.time_marker_every_seconds)
        if per_marker <= 0:
            return [pad] * n_tokens
        duration = n_tokens / cfg.audio_tokens_per_second
        out: list[int] = []
        consumed = 0
        seconds = cfg.time_marker_every_seconds
        while seconds <= int(duration):
            seg = (seconds // cfg.time_marker_every_seconds) * per_marker - consumed
            if seg > 0:
                out.extend([pad] * seg)
                consumed += seg
            for digit in str(seconds):
                if digit in self._digit_ids:
                    out.append(self._digit_ids[digit])
            seconds += cfg.time_marker_every_seconds
        if n_tokens > consumed:
            out.extend([pad] * (n_tokens - consumed))
        return out

    def build_prompt(self, n_audio_tokens: int, prompt: str | None = None) -> list[int]:
        """The ChatML prompt's ids with the audio span in place of its one
        ``<|audio_pad|>``."""
        resolved = (prompt or "").strip() or DEFAULT_PROMPT
        if AUDIO_PAD in resolved:
            rendered = resolved
        else:
            rendered = ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
                        f"<|im_start|>user\n{AUDIO_START}{AUDIO_PAD}{AUDIO_END}\n"
                        f"{resolved}<|im_end|>\n<|im_start|>assistant\n")
        parts = rendered.split(AUDIO_PAD)
        if len(parts) != 2:
            raise ValueError(f"expected exactly one {AUDIO_PAD} in prompt")
        return (self.tokenizer.encode(parts[0]).ids + self._audio_span_ids(n_audio_tokens)
                + self.tokenizer.encode(parts[1]).ids)

    @torch.no_grad()
    def _inject_audio(self, ids: np.ndarray, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The prompt's token embeddings ``[1, L, D]`` with the audio rows
        scattered over the ``<|audio_pad|>`` positions."""
        ids = np.asarray(ids)
        vocab = self.config.text.vocab_size
        if ids.size and int(ids.max()) >= vocab:
            raise ValueError(f"prompt id {int(ids.max())} lies past the text vocabulary "
                             f"({vocab} rows)")
        embeds = nn.embedding(self.params["language_model"]["model"]["embed_tokens"],
                              torch.from_numpy(ids.astype(np.int64)).to(self.device)).clone()
        pos = np.where(ids[0] == self.config.audio_token_id)[0]
        if len(pos) != audio_embeds.shape[0]:
            raise ValueError(f"audio tokens ({len(pos)}) != audio features "
                             f"({audio_embeds.shape[0]})")
        embeds[0, torch.from_numpy(pos).to(self.device)] = audio_embeds.to(self.device,
                                                                           embeds.dtype)
        return embeds

    # -- decode -------------------------------------------------------------------

    def _step(self, params: dict, tok: torch.Tensor, cache):
        logits, cache = llama.forward(params, tok, cache, self.config.text)
        return logits[:, -1].to(torch.float32), cache

    @torch.no_grad()
    def _decode(self, params: dict, embeds: torch.Tensor, cache, max_new: int,
                temperature: float = 0.0, generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, int]:
        """Prefill ``embeds`` and decode up to ``max_new`` tokens ->
        (tokens ``[max_new]`` on the device, count). Step ``i`` writes the
        token it feeds into ``tokens[i]`` and the 24-entry ring, then
        stops the loop when its next token is an EOS id, or when ``i >=
        23`` and the ring holds 3 or fewer distinct tokens; the count is
        ``i + 1`` then (0 when the prefill's token is an EOS id). Steps
        taken after the stop before the host reads the flag change neither
        the tokens nor the count."""
        dev = embeds.device
        eos = torch.tensor(self.eos_token_ids, dtype=torch.int64, device=dev)

        def pick(logits):
            if temperature > 0:
                return _categorical(logits / temperature, generator)
            return torch.argmax(logits, dim=-1)

        logits, cache = llama.forward(params, None, cache, self.config.text,
                                      inputs_embeds=embeds)
        last = pick(logits[:, -1].to(torch.float32))
        tokens = torch.zeros((max_new,), dtype=torch.int64, device=dev)
        ring = torch.full((RING,), -1, dtype=torch.int64, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        finished = torch.isin(last[0], eos)
        for i in range(max_new):
            if i % SYNC_EVERY == 0 and bool(finished):
                break
            live = ~finished
            tokens[i] = torch.where(live, last[0], tokens[i])
            ring[i % RING] = torch.where(live, last[0], ring[i % RING])
            logits, cache = self._step(params, last[:, None], cache)
            nxt = pick(logits)
            count = count + live
            stop = torch.isin(nxt[0], eos)
            if i >= RING - 1:
                s = torch.sort(ring).values
                stop = stop | (1 + (s[1:] != s[:-1]).sum() <= RING_MAX_UNIQUE)
            finished = finished | stop
            last = torch.where(live, nxt, last)
        return tokens, int(count)

    # -- generation -----------------------------------------------------------------

    def generate(self, audio, generation_parameters: STTGenerateParameters | None = None,
                 prompt: str | None = None) -> STTOutput:
        """Pieces of ``chunk_duration`` s (1800 by default), each decoded
        alone; their texts (timestamps shifted by the piece's offset)
        joined with newlines and their segments shifted."""
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        gp = generation_parameters or STTGenerateParameters(max_tokens=2048)
        t0 = time.perf_counter()
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        chunk = int((gp.chunk_duration or 1800.0) * self.sample_rate)
        texts: list[str] = []
        segments: list[STTSegment] = []
        total_prompt = total_gen = 0
        for s in range(0, max(len(audio), 1), chunk):
            piece = audio[s:s + chunk]
            offset = s / self.sample_rate
            text, n_prompt, n_gen = self._generate_chunk(piece, gp, prompt)
            total_prompt += n_prompt
            total_gen += n_gen
            shifted = self._offset_tags(text, offset)
            if shifted:
                texts.append(shifted)
            segments.extend(self._parse_segments(
                text, fallback_end=len(piece) / self.sample_rate, offset=offset))
        elapsed = time.perf_counter() - t0
        return STTOutput(text="\n".join(texts), segments=segments,
                         prompt_token_count=total_prompt, generation_token_count=total_gen,
                         generation_time=elapsed, total_time=elapsed)

    def _generate_chunk(self, audio, gp: STTGenerateParameters, prompt: str | None):
        feats = self.encode_audio(audio)
        ids = np.asarray([self.build_prompt(feats.shape[0], prompt)], np.int32)
        embeds = self._inject_audio(ids, feats)
        max_new = gp.max_tokens or 2048
        cache = llama.make_cache(self.config.text, 1, ids.shape[1] + max_new + 1, self.dtype,
                                 device=self.device)
        temperature = gp.temperature or 0.0
        gen = (torch.Generator(device=self.device).manual_seed(0) if temperature > 0 else None)
        tokens, count = self._decode(self.params["language_model"], embeds.to(self.dtype),
                                     cache, max_new, temperature, gen)
        out = [t for t in tokens[:count].tolist() if t not in self.eos_token_ids]
        text = self.tokenizer.decode(out, skip_special_tokens=True).strip()
        return text, ids.shape[1], len(out)

    def streaming_transcribe_window(self, samples, offset_seconds: float = 0.0,
                                    language: str | None = None,
                                    max_tokens: int | None = None) -> str:
        """One streaming window's text, timestamps shifted by the window's
        offset; ``max_tokens`` caps a partial pass (2048 otherwise)."""
        gp = STTGenerateParameters(max_tokens=max_tokens or 2048, language=language)
        text, _, _ = self._generate_chunk(np.asarray(samples, np.float32), gp, None)
        return self._offset_tags(text, offset_seconds)

    def generate_stream(self, audio, generation_parameters=None, **kw):
        out = self.generate(audio, generation_parameters, **kw)
        if out.text:
            yield {"type": "token", "text": out.text}
        yield {"type": "result", "output": out}

    # -- timestamps -------------------------------------------------------------------

    @staticmethod
    def _offset_tags(text: str, offset: float) -> str:
        """Shift every ``[12.34]`` tag by ``offset`` seconds."""
        if not offset:
            return text
        return _TS_TAG.sub(
            lambda m: "[%.2f]" % (float(m.group(1).replace(",", ".")) + offset), text)

    @staticmethod
    def _parse_segments(text: str, fallback_end: float, offset: float = 0.0
                        ) -> list[STTSegment]:
        """``[start][SXX] text [end]`` runs -> speaker segments; text with
        none is one segment up to ``fallback_end``."""
        segs = []
        for m in _SEGMENT.finditer(text):
            start = float(m.group(1).replace(",", "."))
            end = float(m.group(4).replace(",", "."))
            body = m.group(3).strip()
            if end < start or not body:
                continue
            segs.append(STTSegment(text=f"[{m.group(2)}] {body}", start=start + offset,
                                   end=end + offset, speaker=m.group(2)))
        if segs:
            return segs
        if not text:
            return []
        return [STTSegment(text=text, start=offset, end=offset + max(fallback_end, 0.0))]


def init_random_params(cfg: MossTranscribeDiarizeConfig, seed: int = 0,
                       dtype=torch.bfloat16, device=None) -> dict:
    """Random params at ``cfg``'s shapes in the loaded tree's layout (the
    encoder's layers stacked, the text decoder stacked and unfused), drawn
    on ``device``: the encoder and the adaptor from a ``torch.Generator``
    seeded with ``seed + 71`` (linears and convs N(0, 1/fan-in), biases
    N(0, 0.02), LayerNorm weights 1 + N(0, 0.1) and biases N(0, 0.02),
    positions N(0, 0.02)), the text decoder by
    ``llama.init_random_params(on_device=True)``."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed + 71)
    a = cfg.audio
    d, ffn, n = a.d_model, a.encoder_ffn_dim, a.encoder_layers

    def rand(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(
            std).to(dtype)

    def lin(o, i, bias=True, lead=()):
        p = {"weight": rand((*lead, o, i), i ** -0.5)}
        if bias:
            p["bias"] = rand((*lead, o), 0.02)
        return p

    def norm(m, lead=()):
        return {"weight": (1.0 + rand((*lead, m), 0.1).float()).to(dtype),
                "bias": rand((*lead, m), 0.02)}

    L = (n,)
    encoder = {
        "conv1": {"weight": rand((d, a.num_mel_bins, 3), (3 * a.num_mel_bins) ** -0.5),
                  "bias": rand((d,), 0.02)},
        "conv2": {"weight": rand((d, d, 3), (3 * d) ** -0.5), "bias": rand((d,), 0.02)},
        "embed_positions": {"weight": rand((a.max_source_positions, d), 0.02)},
        "layers": {
            "self_attn": {"q_proj": lin(d, d, lead=L), "k_proj": lin(d, d, False, L),
                          "v_proj": lin(d, d, lead=L), "out_proj": lin(d, d, lead=L)},
            "self_attn_layer_norm": norm(d, L), "final_layer_norm": norm(d, L),
            "fc1": lin(ffn, d, lead=L), "fc2": lin(d, ffn, lead=L)},
        "layer_norm": norm(d)}
    lm_d = cfg.text.hidden_size
    merge = cfg.audio_merge_size
    return {"whisper": {"model": {"encoder": encoder}},
            "vq_adaptor": {"fc1": lin(lm_d, d * merge), "fc2": lin(lm_d, lm_d),
                           "norm": norm(lm_d)},
            "language_model": llama.init_random_params(cfg.text, seed=seed, dtype=dtype,
                                                       device=device, on_device=True)}
