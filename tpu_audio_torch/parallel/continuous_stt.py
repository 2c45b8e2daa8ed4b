"""Continuous batching for transcription serving (port of
tpu_audio.parallel.continuous_stt: ``ContinuousSTT`` for Whisper,
``ContinuousQwen3ASR`` for Qwen3-ASR, and ``STTEngineWorker``).

Concurrent transcription requests share one decode tick through
:class:`ContinuousBatcher`'s per-request context: each lane carries its
own precomputed cross-attention K/V (whisper's conditioning,
``whisper._cross_kv``) stacked on the slot axis like its self caches,
while whisper's suppression rules ride the engine's ``logits_hook``
(begin-suppression fires where a lane's ``n_new == 0``).

- Whisper's learned decoder positions are not shift-invariant, so lanes
  are never left-padded: prompts from ``build_prompt_tokens`` have one
  length per model (4 multilingual, 2 English-only), which is the single
  prefill bucket. Each lane embeds the position row of its own offset.
- The encode (mel + encoder + cross K/V) runs per request at submit time;
  only the decode loop, which scales with the requested tokens, is
  batched.
- One language/task per request; one sampling configuration per engine.
- The fused tick (w8a8 decoder): ONE ``ops.fused_decoder.fused_stack_lanes``
  call per decode step for every live lane (one sweep of the int8 weights
  shared by all of them; one call per group past the kernel's lane limit),
  then the final LayerNorm and the tied head. The plain tick (a decoder
  that is not w8a8, or any decoder on the CPU) runs the live lanes one
  after another through the one-window ``whisper.decoder_step`` with dense
  cross K/V: the same tokens, without a kernel that shares the weight
  sweep.
- Qwen3-ASR (``ContinuousQwen3ASR``): a lane's context is its request's
  merged prompt embeddings, prefilled through
  ``llama.forward(inputs_embeds=...)``; the plain tick decodes lane by lane
  through ``llama.forward``, as solo ``generate`` does.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_audio_torch.core import kv_cache, nn, quant
from tpu_audio_torch.core.generation import STTOutput, STTSegment
from tpu_audio_torch.core.sampling import SamplingParams
from tpu_audio_torch.models import llama
from tpu_audio_torch.models.stt import whisper as W
from tpu_audio_torch.ops import fused_decoder as F
from tpu_audio_torch.parallel.continuous import (
    ContinuousBatcher,
    EngineWorkerBase,
    GenRequest,
    coerce_fused_flag,
    llama_lanes,
)

__all__ = ["ContinuousSTT", "ContinuousQwen3ASR", "STTEngineWorker"]

log = logging.getLogger(__name__)


class _LaneKV(NamedTuple):
    """The plain tick's stacked self caches: ``k``/``v``
    ``[slots, L, 1, H, S, hd]`` (one ``kv_cache.KVCache`` row per slot) and
    the engine's ``offset [slots]``."""

    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor


@dataclasses.dataclass
class _Meta:
    audio_seconds: float
    t_submit: float


class ContinuousSTT:
    """Slot-based continuous transcription over a loaded Whisper model.

    >>> srv = ContinuousSTT(model, slots=4)
    >>> r = srv.submit(audio, language="en")
    >>> srv.drain()
    >>> srv.result(r.request_id).text

    ``submit`` accepts one <=30 s chunk per request (shorter audio is
    padded like the offline path). ``fused="auto"`` takes the fused tick
    whenever the decoder is w8a8 and ``ops.fused_decoder`` takes its shape,
    at any ``slots`` (past the kernel's lane limit a step makes one call
    per group of lanes), and otherwise logs the reason and builds the plain
    tick; ``fused="off"`` builds the plain tick without a word. On a CUDA
    device a w8a8 decoder only serves through the kernel: where the kernel
    does not take its shape, or with ``fused="off"``, the engine raises.
    """

    def __init__(self, model: "W.Whisper", *, slots: int = 4,
                 max_tokens: int = 224, step_tokens: int = 8,
                 temperature: float = 0.0, seed: int = 0,
                 min_tick_tokens: int | None = None,
                 pipeline: bool = True, fused: str | bool = "auto"):
        if model.tokenizer is None:
            raise RuntimeError("tokenizer not loaded; use from_pretrained")
        self.model = model
        self.fused = self._fused_route(fused)
        cfg = model.config
        tok = model.tokenizer
        prompt_len = len(tok.build_prompt_tokens("en"))
        # whisper's decoder positions are a learned table: no lane decodes
        # past max_target_positions (the offline loop clamps the same way)
        max_tokens = min(max_tokens, cfg.max_target_positions - prompt_len)
        max_total = prompt_len + max_tokens

        suppress, begin = model._suppress_masks(tok)

        def logits_hook(logits, n_new):
            logits = logits + suppress
            return torch.where((n_new == 0)[:, None], logits + begin, logits)

        build = self._build_fused if self.fused else self._build_plain
        self.engine = ContinuousBatcher(
            model.params, slots=slots, max_len=max_total, stop_token=tok.eot,
            sampling=SamplingParams(temperature=temperature),
            prefill_buckets=(prompt_len,), seed=seed, device=model.device,
            step_tokens=step_tokens, logits_hook=logits_hook,
            **build(cfg, slots, max_total),
            # every tick decodes >= 8 ticks' worth of tokens across its live
            # lanes, so a lone stream amortizes the per-tick host work
            min_tick_tokens=(8 * step_tokens if min_tick_tokens is None
                             else min_tick_tokens),
            pipeline=pipeline)
        self.max_tokens = max_tokens
        self.window = W.CHUNK_LENGTH_SAMPLES  # serving cap per request
        self._meta: dict[int, _Meta] = {}

    def _fused_route(self, fused) -> bool:
        """Whether to build the fused tick. A w8a8 decoder on a CUDA device
        has no other: it takes the fused tick, or the engine refuses to
        build. Elsewhere "auto" logs why it does not, and "off" builds the
        plain tick quietly."""
        model, cfg = self.model, self.model.config
        fc1 = model.params["model"]["decoder"]["layers"]["fc1"]["weight"]
        w8 = isinstance(fc1, quant.Int8Tensor)
        on_card = model.device.type == "cuda"
        if not coerce_fused_flag(fused):
            if w8 and on_card:
                raise ValueError(
                    "ContinuousSTT(fused='off'): a w8a8 decoder on CUDA decodes "
                    "through the fused_stack_lanes kernel; the plain tick has "
                    "no kernel for it")
            return False
        if not w8:
            reason = "the decoder weights are not int8 (w8a8)"
        elif not F.supported_lanes(cfg, 1):
            reason = (f"the fused kernels do not take this decoder shape "
                      f"(d_model {cfg.d_model}, {cfg.decoder_attention_heads} "
                      f"heads, ffn {cfg.decoder_ffn_dim})")
            if on_card:
                raise ValueError(f"ContinuousSTT: {reason}")
        else:
            return True
        log.warning("ContinuousSTT: no fused serving tick: %s; the plain "
                    "per-lane tick serves instead", reason)
        return False

    def _build_fused(self, cfg, slots: int, max_total: int) -> dict:
        """Engine pieces for the fused tick. The lane caches are the
        kernel's position-major bf16 layout (``kv_cache.FusedLaneRow``,
        stacked), a lane's context is its request's int8 cross K/V
        (``fused_decoder.quantize_cross_kv``), the prefill teacher-forces
        the prompt through the lanes kernel at n=1 (the numerics of the
        one-token kernel), and each decode step is one
        ``fused_stack_lanes`` call for every live lane."""
        model = self.model
        d, L, src = cfg.d_model, cfg.decoder_layers, cfg.max_source_positions
        dev = model.device
        pack = model.fused_decoder_pack()
        p = model.params["model"]["decoder"]
        emb = p["embed_tokens"]
        pos_table = p["embed_positions"]["weight"]
        last_pos = pos_table.shape[0] - 1

        def embed(tokens: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
            x = nn.embedding(emb, tokens).to(torch.float32)
            # a frozen lane may sit at max_len: clamp its (unused) row
            return x + pos_table[torch.clamp(offsets, max=last_pos)].to(torch.float32)

        # the most lanes one kernel call takes; more live lanes than that
        # split into groups, one call each (a lane's outputs do not depend
        # on the other lanes of its call)
        group = max(g for g in range(1, F.MAX_LANES + 1) if F.supported_lanes(cfg, g))

        def step(params, cache, lanes, last, offsets, ctx):
            n = last.shape[0]
            x = embed(last, offsets)
            offsets, lanes = offsets.to(torch.int32), lanes.to(torch.int32)
            y = torch.cat([F.fused_stack_lanes(
                pack, *ctx, cache.k, cache.v, x[i:i + group], offsets[i:i + group],
                lanes[i:i + group], cfg=cfg, s_src=src)[0] for i in range(0, n, group)])
            # the head runs over `slots` rows whatever n is: a matmul's
            # rounding may follow its row count, and a lane's logits must
            # not depend on how many lanes are live
            rows = y.new_zeros((slots, d))
            rows[:n] = y
            h = nn.layer_norm(p["layer_norm"], rows)
            return nn.embedding_as_linear(emb, h.to(model.dtype))[:n]

        def prefill_fn(params, cache, slot, ids, valid_from, ctx):
            lane = torch.tensor([slot], dtype=torch.int32, device=dev)
            for i, t in enumerate(ids.tolist()):
                pos = torch.tensor([i], dtype=torch.int64, device=dev)
                F.fused_stack_lanes(
                    pack, *ctx, cache.k, cache.v,
                    embed(torch.tensor([t], device=dev), pos),
                    pos.to(torch.int32), lane, cfg=cfg, s_src=src)
            cache.valid_from[slot] = valid_from
            return len(ids)

        def cache_factory(slots):
            def zeros(dtype, *shape):
                return torch.zeros(shape, dtype=dtype, device=dev)

            return kv_cache.FusedLaneRow(
                k=zeros(torch.bfloat16, slots, L, max_total, d),
                v=zeros(torch.bfloat16, slots, L, max_total, d),
                offset=zeros(torch.int64, slots),
                valid_from=zeros(torch.int64, slots))

        def meta(dtype, *shape):
            return torch.empty(shape, dtype=dtype, device="meta")

        ctx_template = (meta(torch.int8, L, src, d),      # cross K int8
                        meta(torch.float32, L, src),      # per-position K scales
                        meta(torch.int8, L, src, d),      # cross V int8
                        meta(torch.float32, L, src))      # per-position V scales
        return dict(batch_step_fn=step, prefill_fn=prefill_fn,
                    cache_factory=cache_factory, context_template=ctx_template)

    def _build_plain(self, cfg, slots: int, max_total: int) -> dict:
        """Engine pieces for the plain tick: each live lane steps through
        ``whisper.decoder_step`` (B=1, dense self cache, dense cross K/V)
        on its own slot of the stacked caches and contexts."""
        model = self.model
        dev, dtype = model.device, model.dtype
        L, H = cfg.decoder_layers, cfg.decoder_attention_heads
        hd, src = cfg.d_model // H, cfg.max_source_positions
        layers = model.decoder.split_layers()

        def step_fn(params, cache, slot, tok, pos, ctx):
            ck, cv = ctx
            row = kv_cache.KVCache(cache.k[slot], cache.v[slot], pos)
            logits, _ = W.decoder_step(params, tok, pos, row,
                                       (ck[slot][:, None], cv[slot][:, None]),
                                       cfg, layers=layers)
            return logits[:, -1]

        def prefill_fn(params, cache, slot, ids, valid_from, ctx):
            for i, t in enumerate(ids.tolist()):
                step_fn(params, cache, slot, torch.tensor([[t]], device=dev), i, ctx)
            return len(ids)

        def cache_factory(slots):
            shape = (slots, L, 1, H, max_total, hd)
            return _LaneKV(torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros(shape, dtype=dtype, device=dev),
                           torch.zeros((slots,), dtype=torch.int64, device=dev))

        ctx_template = tuple(torch.empty((L, H, src, hd), dtype=dtype, device="meta")
                             for _ in range(2))
        return dict(step_fn=step_fn, prefill_fn=prefill_fn,
                    cache_factory=cache_factory, context_template=ctx_template)

    @torch.no_grad()
    def submit(self, audio, language: str | None = None,
               task: str = "transcribe", max_tokens: int | None = None,
               seed: int = 0) -> GenRequest:
        """Encode one <=30 s request and queue its decode. Longer audio
        is truncated to the 30 s window (the reported segment covers the
        transcribed span only)."""
        model = self.model
        audio = np.asarray(audio, np.float32).reshape(-1)[: self.window]
        enc = model.encoder(model.encoder_features(audio))
        ck, cv = W._cross_kv(model.params, enc, model.config,
                             model.decoder.split_layers())
        if self.fused:
            context = F.quantize_cross_kv(ck, cv)
        else:
            context = (ck[:, 0], cv[:, 0])
        prompt = model.tokenizer.build_prompt_tokens(language, task)
        req = self.engine.submit(
            np.asarray(prompt, np.int32),
            max_new=min(max_tokens or self.max_tokens, self.max_tokens),
            seed=seed, context=context)
        self._meta[req.request_id] = _Meta(
            audio_seconds=len(audio) / W.SAMPLE_RATE,
            t_submit=time.perf_counter())
        return req

    def step(self):
        """One engine tick -> ``(request_id, token)`` pairs."""
        return self.engine.step()

    def drain(self):
        """Run until every submitted request finishes."""
        for _ in self.engine.run():
            pass

    def cancel(self, request_id: int) -> bool:
        self._meta.pop(request_id, None)
        return self.engine.cancel(request_id)

    def result(self, request_id: int) -> STTOutput:
        """Decode a finished request's tokens into an STTOutput."""
        req = self.engine.requests[request_id]
        if not req.done:
            raise RuntimeError(f"request {request_id} still decoding")
        meta = self._meta.pop(request_id, None)
        text = self.model.tokenizer.decode(req.tokens).strip()
        wall = (time.perf_counter() - meta.t_submit) if meta else 0.0
        end = meta.audio_seconds if meta else 0.0
        return STTOutput(
            text=text,
            segments=[STTSegment(text=text, start=0.0, end=end,
                                 tokens=list(req.tokens))],
            generation_token_count=len(req.tokens),
            generation_time=wall, total_time=wall)


class ContinuousQwen3ASR:
    """Continuous batching for Qwen3-ASR: a lane's conditioning is its
    request's merged prompt embeddings (the text template with the audio
    tower's features over the audio placeholders), ``[L - 1, hidden]`` in
    the model's dtype, and the prefill runs ``llama.forward(inputs_embeds=
    ...)`` into the lane's slot.

    Every request is cut or zero-padded to one ``window_s``, so that the
    prompt length (its audio placeholder count, from the whole window's mel
    length) is one shape: the single prefill bucket, no left padding, the
    positions of a solo decode. Language forcing changes the prompt length
    in this model, so it is set per engine (None: detected from the
    output); the engine transcribes only.

    >>> srv = ContinuousQwen3ASR(model, slots=4)
    >>> r = srv.submit(audio)
    >>> srv.drain()
    >>> srv.result(r.request_id).text
    """

    EOS_IDS = (151645, 151643)  # <|im_end|>, <|endoftext|>

    def __init__(self, model, *, slots: int = 4, window_s: float = 20.0,
                 max_tokens: int = 96, step_tokens: int = 8, temperature: float = 0.0,
                 seed: int = 0, language: str | None = None,
                 min_tick_tokens: int | None = None, pipeline: bool = True):
        from tpu_audio_torch.models.stt.qwen3_asr import SAMPLE_RATE

        if model.tokenizer is None:
            raise RuntimeError("tokenizer not loaded; use from_pretrained")
        self.model = model
        self.language = language
        self.window = int(window_s * SAMPLE_RATE)
        self._sr = SAMPLE_RATE
        # one window length -> one mel length -> one prompt length
        _, self._n_audio = model.preprocess_audio(np.zeros((self.window,), np.float32))
        L = len(model.build_prompt(self._n_audio, language=language))
        tcfg = model.config.text
        max_total = L + max_tokens + 1

        def prefill(params, ids, cache, ctx):
            return llama.forward(params, None, cache, tcfg, inputs_embeds=ctx[0][None])

        self.engine = ContinuousBatcher(
            model.params, slots=slots, max_len=max_total, stop_token=self.EOS_IDS[0],
            sampling=SamplingParams(temperature=temperature, repetition_penalty=1.0),
            prefill_buckets=(L,), seed=seed,
            **llama_lanes(tcfg, max_total, model.params, model.dtype, step=model._step_fn,
                          prefill=prefill),
            step_tokens=step_tokens,
            context_template=(torch.empty((L - 1, tcfg.hidden_size), dtype=model.dtype,
                                          device="meta"),),
            min_tick_tokens=(4 * step_tokens if min_tick_tokens is None
                             else min_tick_tokens),
            pipeline=pipeline)
        self.max_tokens = max_tokens
        self._meta: dict[int, _Meta] = {}

    @torch.no_grad()
    def submit(self, audio, language: str | None = None, task: str = "transcribe",
               max_tokens: int | None = None, seed: int = 0) -> GenRequest:
        """Encode one window-sized request and queue its decode. Language
        forcing is per engine in this model (it changes the prompt length):
        a request's differing ``language`` raises, as does any task but
        transcription."""
        if language is not None and language != self.language:
            raise ValueError("Qwen3-ASR language forcing is per-engine; rebuild the "
                             f"engine with language={language!r}")
        if task != "transcribe":
            raise ValueError("Qwen3-ASR serves transcription only")
        model = self.model
        audio = np.asarray(audio, np.float32).reshape(-1)[: self.window]
        seconds = len(audio) / self._sr
        if len(audio) < self.window:
            audio = np.pad(audio, (0, self.window - len(audio)))
        mel, n_audio = model.preprocess_audio(audio)
        feats = model.encode_audio(mel)
        ids = np.asarray([model.build_prompt(n_audio, language=self.language)], np.int32)
        embeds = model._merge_audio_features(ids, feats)
        req = self.engine.submit(ids[0], max_new=max_tokens or self.max_tokens, seed=seed,
                                 context=(embeds[0, :-1].to(model.dtype),))
        self._meta[req.request_id] = _Meta(audio_seconds=seconds,
                                           t_submit=time.perf_counter())
        return req

    def step(self):
        """One engine tick -> ``(request_id, token)`` pairs."""
        return self.engine.step()

    def drain(self):
        """Run until every submitted request finishes."""
        for _ in self.engine.run():
            pass

    def cancel(self, request_id: int) -> bool:
        self._meta.pop(request_id, None)
        return self.engine.cancel(request_id)

    def result(self, request_id: int) -> STTOutput:
        """A finished request's tokens as an STTOutput."""
        req = self.engine.requests[request_id]
        if not req.done:
            raise RuntimeError(f"request {request_id} still decoding")
        meta = self._meta.pop(request_id, None)
        gen = [t for t in req.tokens if t not in self.EOS_IDS]
        decoded = self.model.tokenizer.decode(gen, skip_special_tokens=True)
        lang, text = self.model._parse_output(decoded, self.language)
        wall = (time.perf_counter() - meta.t_submit) if meta else 0.0
        end = meta.audio_seconds if meta else 0.0
        return STTOutput(text=text, language=lang,
                         segments=[STTSegment(text=text, start=0.0, end=end, tokens=gen)],
                         generation_token_count=len(gen), generation_time=wall,
                         total_time=wall)


class STTEngineWorker(EngineWorkerBase):
    """Thread multiplexing concurrent transcription callers onto one
    :class:`ContinuousSTT`:

    >>> worker = STTEngineWorker(model, slots=4)
    >>> out = worker.transcribe(audio, language="en")   # any thread

    Encodes happen on the engine thread as requests arrive; the decode
    loops of all in-flight requests share the continuously batched tick.
    ``engine_cls`` picks the engine for the model family
    (:class:`ContinuousSTT` for Whisper, the default, and
    :class:`ContinuousQwen3ASR` for Qwen3-ASR)."""

    _thread_name = "stt-engine"

    def __init__(self, model, *, slots: int = 4, engine_cls=None, **kw):
        self._srv = (engine_cls or ContinuousSTT)(model, slots=slots, **kw)
        super().__init__()

    def transcribe(self, audio, language: str | None = None,
                   task: str = "transcribe", max_tokens: int | None = None,
                   seed: int = 0) -> STTOutput:
        """Blocking: submit and wait for this request's transcription."""
        outq = self._queue_mod.Queue()
        self._enqueue((audio, language, task, max_tokens, seed, outq))
        out = outq.get()
        if isinstance(out, Exception):
            raise out
        return out

    @property
    def _idle(self) -> bool:
        return self._srv.engine.idle

    def _handle(self, item) -> None:
        audio, language, task, max_tokens, seed, outq = item
        self._admit(lambda: self._srv.submit(audio, language=language,
                                             task=task,
                                             max_tokens=max_tokens,
                                             seed=seed), outq)

    def _service(self) -> None:
        self._srv.step()
        for rid in [r for r in self._out
                    if self._srv.engine.requests[r].done]:
            self._out.pop(rid).put(self._srv.result(rid))
            self._srv.engine.release(rid)
