"""Continuous batching for Qwen3-TTS: slot-based serving of the talker, the
code predictor and the streaming codec (port of
tpu_audio.parallel.continuous_qwen3: ``Qwen3TTSRequest``,
``ContinuousQwen3TTS`` and ``Qwen3TTSEngineWorker``).

A Qwen3-TTS frame decodes *embeddings*: its input is the trailing text
embedding (or ``tts_pad`` past the text) plus the previous frame's summed
code embeddings, and it emits ``G`` codes (a talker step and the code
predictor's passes). The engine owns ``slots`` lanes, each holding one
request's talker cache row, next input, repetition history and text; a
lane admits a new request the moment its occupant finishes. What differs
from the JAX package, which vmaps its compiled solo frame over the lanes:

- A tick is ONE lane-batched frame (``Qwen3TTS._lane_frame``) over exactly
  the live lanes: every product runs once over ``n`` rows (``2n`` for
  code-predictor pass 0), not once a lane. On an MLX tree on CUDA each of
  them is kernel 7's tensor-core tile, whose sums do not depend on the row
  count; a lone lane runs as two rows, itself twice (the filler of the JAX
  package's bucket tick; both rows compute and write the same values), so
  that a request's arithmetic does not change with the lanes live. Pass
  0's ``2n`` rows must fit the kernel's 64 (``slots <= 32`` for an MLX
  tree on CUDA); ``slots >= 2``, as the server uses the engine only there.
- Nothing in a tick reads a device value on the host: the lanes' offsets,
  ``valid_from``, history, counters and active flags are tensors on the
  device, the caches are written in place at each lane's own offset, and a
  lane that does not emit keeps its offset (its garbage K/V row stays
  outside every mask). The tick ends with ONE packed ``[G + 2, n]`` int32
  readback (codes, emit and active flags), copied ``non_blocking`` into
  pinned memory behind a CUDA event; with ``pipeline=True`` (the default)
  that copy overlaps the next tick.
- Sampling: each draw's noise hashes (engine seed, request seed, sample
  index ``frame * G + group``) on the device
  (``core.sampling.sample_keyed``), so a request's codes are the same
  alone or packed with others. Solo ``generate`` draws from a
  ``torch.Generator``: only greedy codes can equal solo's.
- Each frame runs in solo ``generate``'s dtypes: a request's first frame
  takes the prompt's last row in the model's dtype, and its later frames
  the dtype the next input promotes to (f32 when the codec embedding is
  packed, as its lookups are f32). A tick that holds first and later
  frames of a bf16 model on a packed tree therefore runs two lane frames,
  one a dtype.

Prompts left-pad into prefill buckets with ``valid_from`` masking. Each
request streams its audio through its own codec state
(``qwen3_codec.init_streaming_state`` / ``decoder_forward``), every
``streaming_interval`` of frames and at its end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_audio_torch.codecs.qwen3_codec import decoder_forward, init_streaming_state
from tpu_audio_torch.core import kv_cache, quant
from tpu_audio_torch.core.generation import AudioGeneration, AudioGenerationError
from tpu_audio_torch.core.sampling import SamplingParams, sample_keyed
from tpu_audio_torch.models.tts.qwen3_tts import (CODEC_TOKEN_RATE_HZ, SUPPRESSED_BAND,
                                                  _penalized)
from tpu_audio_torch.ops import qmm
from tpu_audio_torch.parallel.continuous import (EngineWorkerBase, SlotEngine, readback,
                                                 to_device)

__all__ = ["ContinuousQwen3TTS", "Qwen3TTSEngineWorker", "Qwen3TTSRequest"]

_ENGINE_KEY = 0  # the keyed noise's engine seed: a request's own seed varies its draws


@dataclasses.dataclass(eq=False)
class Qwen3TTSRequest:
    """One submitted synthesis request and its accumulated frames."""

    request_id: int
    max_new: int
    seed: int = 0
    codes: list = dataclasses.field(default_factory=list)  # [G] rows
    done: bool = False
    inputs: tuple | None = None  # (prompt, trailing, tts_pad) until admitted


@dataclasses.dataclass
class _Lanes:
    """Per-slot state on the device, ``[slots, ...]``."""

    embeds: torch.Tensor        # [slots, 1, D] next frame's input
    seeds: torch.Tensor         # int64 request seeds
    history: torch.Tensor       # [slots, R] int64 codebook-0 ring
    hpos: torch.Tensor          # int64 frames emitted (== the solo loop's step)
    max_new: torch.Tensor       # int64
    active: torch.Tensor        # bool
    trailing: torch.Tensor      # [slots, max_trailing, D] text embeddings
    trailing_len: torch.Tensor  # int64
    tts_pad: torch.Tensor       # [slots, D]


def _packed_tree(params) -> bool:
    if isinstance(params, dict):
        return any(_packed_tree(v) for v in params.values())
    return isinstance(params, quant.QuantizedTensor)


class ContinuousQwen3TTS(SlotEngine):
    """Slot-based continuous batching for a loaded
    :class:`~tpu_audio_torch.models.tts.qwen3_tts.Qwen3TTS`.

    >>> srv = ContinuousQwen3TTS(model, slots=4)
    >>> r = srv.submit("Hello there.", voice="vivian")
    >>> for request_id, wav in srv.run():
    ...     ...  # np.float32 audio chunks per request as frames decode

    One sampling configuration per server; ``max_tokens`` and ``seed`` stay
    per request. The engine runs on the model's device (the CPU only where
    the caller loaded the model there) and its ticks never leave it.
    """

    def __init__(self, model, *, slots: int = 4, generation_parameters=None,
                 prefill_buckets: tuple[int, ...] = (64, 128, 256),
                 max_trailing: int = 256, max_new_cap: int = 1024,
                 pipeline: bool = True):
        if model.tokenizer is None:
            raise AudioGenerationError("tokenizer not loaded")
        if model.codec is None:
            raise AudioGenerationError("codec decoder not loaded")
        self.model = model
        self._init_slots(slots, pipeline)
        if self.slots < 2:
            raise ValueError(
                f"slots={slots}: the engine serves several streams at once, so it needs "
                "slots >= 2; serve one stream at a time through model.generate_stream")
        self.device = model.device
        max_lanes = qmm.MAX_ROWS // 2
        if self.device.type == "cuda" and self.slots > max_lanes and _packed_tree(model.params):
            raise ValueError(
                f"slots={slots}: code-predictor pass 0 runs 2 rows a lane, and kernel 7 "
                f"takes at most {qmm.MAX_ROWS} rows; an MLX tree on CUDA serves at most "
                f"{max_lanes} lanes")
        p = generation_parameters or model.default_generation_parameters()
        self.gen_params = p
        self.sampling = SamplingParams(temperature=p.temperature, top_p=p.top_p,
                                       top_k=p.top_k)
        self.buckets = tuple(sorted(prefill_buckets))
        self.max_trailing = int(max_trailing)
        self.max_new_cap = int(max_new_cap)
        tcfg = model.config.talker
        self._tcfg = tcfg
        self._groups = tcfg.num_code_groups
        self._eos = tcfg.codec_eos_token_id
        self._R = max(p.repetition_context_size, 1)
        self.max_len = self.buckets[-1] + self.max_new_cap + 2
        self.chunk_frames = max(1, int(p.streaming_interval * CODEC_TOKEN_RATE_HZ))
        # only the codec codes and EOS are sampleable (Qwen3TTS._run_iter)
        self._suppress = torch.zeros((tcfg.vocab_size,), dtype=torch.float32,
                                     device=self.device)
        self._suppress[tcfg.vocab_size - SUPPRESSED_BAND:] = -1e9
        self._suppress[self._eos] = 0.0
        with torch.no_grad():
            probe = model._codec_embed(torch.zeros((1, 1), dtype=torch.int64,
                                                   device=self.device))
        # the dtype of a later frame's input (solo: text + embed_sum)
        self._stream_dtype = torch.promote_types(model.dtype, probe.dtype)
        self._cache = self._init_cache()
        self._state = self._init_state()
        self._fresh = [False] * self.slots  # admitted, its first frame not yet run
        self._meta: dict[int, dict] = {}

    # -- state ----------------------------------------------------------------

    def _init_cache(self) -> kv_cache.FusedLaneRow:
        tcfg = self._tcfg

        def zeros(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        shape = (self.slots, tcfg.num_hidden_layers, 1, tcfg.num_key_value_heads,
                 self.max_len, tcfg.head_dim)
        return kv_cache.FusedLaneRow(zeros(self.model.dtype, *shape),
                                     zeros(self.model.dtype, *shape),
                                     zeros(torch.int64, self.slots),
                                     zeros(torch.int64, self.slots))

    def _init_state(self) -> _Lanes:
        def zeros(dtype, *shape):
            return torch.zeros((self.slots, *shape), dtype=dtype, device=self.device)

        D, dt = self._tcfg.hidden_size, self.model.dtype
        return _Lanes(embeds=zeros(self._stream_dtype, 1, D), seeds=zeros(torch.int64),
                      history=zeros(torch.int64, self._R), hpos=zeros(torch.int64),
                      max_new=zeros(torch.int64), active=zeros(torch.bool),
                      trailing=zeros(dt, self.max_trailing, D),
                      trailing_len=zeros(torch.int64), tts_pad=zeros(dt, D))

    # -- public API -------------------------------------------------------------

    @torch.no_grad()
    def submit(self, text: str, voice: str | None = None, language: str | None = None,
               instruct: str | None = None, max_tokens: int | None = None,
               seed: int = 0) -> Qwen3TTSRequest:
        """Queue a synthesis request (the CustomVoice path: a speaker and an
        optional instruction, as ``Qwen3TTS.prepare_generation_inputs``)."""
        m = self.model
        speaker, parsed_instr = m._parse_voice(voice)
        input_embeds, trailing, tts_pad = m.prepare_generation_inputs(
            text, language or "auto", instruct or parsed_instr, speaker)
        if trailing.shape[1] > self.max_trailing:
            raise ValueError(f"trailing text embeds ({trailing.shape[1]}) exceed "
                             f"max_trailing={self.max_trailing}")
        if self._bucket(input_embeds.shape[1]) >= self.max_len:
            raise ValueError(f"a {input_embeds.shape[1]}-row prompt pads past "
                             f"max_len={self.max_len}")
        target_tokens = len(m.tokenizer.encode(text).ids)
        p = self.gen_params
        max_new = min(max_tokens or p.max_tokens, max(75, target_tokens * 6),
                      self.max_new_cap)
        req = Qwen3TTSRequest(request_id=self._next_id, max_new=int(max_new),
                              seed=int(seed) % (2 ** 31), inputs=(
                                  input_embeds[0].to(m.dtype), trailing[0].to(m.dtype),
                                  tts_pad[0, 0].to(m.dtype)))
        self._next_id += 1
        self.requests[req.request_id] = req
        codec = m.codec
        self._meta[req.request_id] = {
            "codec_state": init_streaming_state(codec.config, 1, dtype=codec.dtype,
                                                device=codec.device),
            "decoded": 0}
        self._pending.append(req)
        return req

    def is_finished(self, request_id: int) -> bool:
        req = self.requests.get(request_id)
        return req is not None and req.done

    def _forget(self, request_id: int) -> None:
        self._meta.pop(request_id, None)

    def _admit(self) -> None:
        """Prefill pending requests into free lanes: the prompt left-padded
        to its bucket, minus its last row, which the lane's first frame
        feeds (as solo ``generate`` does)."""
        st, cache, m = self._state, self._cache, self.model
        for slot in range(self.slots):
            if self._lane[slot] is not None or not self._pending:
                continue
            req = self._pending.pop(0)
            (input_embeds, trailing, tts_pad), req.inputs = req.inputs, None
            t = input_embeds.shape[0]
            padded = self._bucket(t)
            pad = padded - t
            buf = torch.zeros((padded, input_embeds.shape[1]), dtype=m.dtype,
                              device=self.device)
            buf[pad:] = input_embeds
            row = kv_cache.KVCache(cache.k[slot], cache.v[slot], 0, pad)
            offset = m._prefill(buf[None, :-1], row).offset
            cache.offset[slot] = offset
            cache.valid_from[slot] = pad
            st.embeds[slot].copy_(input_embeds[-1:])
            st.seeds[slot] = req.seed
            st.history[slot] = 0
            st.hpos[slot] = 0
            st.max_new[slot] = req.max_new
            st.active[slot] = req.max_new > 0
            st.trailing[slot, : trailing.shape[0]].copy_(trailing)
            st.trailing_len[slot] = trailing.shape[0]
            st.tts_pad[slot].copy_(tts_pad)
            self._pos[slot] = offset
            self._fresh[slot] = True
            self._lane[slot] = req

    def _sampler(self, seeds, hpos, history):
        """``sample(logits [n, V], group) -> ids [n]`` for one tick: group 0
        (the talker) with the suppression and each lane's repetition penalty
        over its codebook-0 history; every draw keyed by the request's seed
        and its sample index ``frame * G + group``."""
        p, R = self.gen_params, self._R
        valid = (torch.arange(R, device=self.device)[None, :]
                 < torch.clamp(hpos, max=R)[:, None])

        def sample(logits, group):
            if group == 0:
                logits = _penalized(logits, self._suppress, history, valid,
                                    p.repetition_penalty)
            return sample_keyed(logits.to(torch.float32), _ENGINE_KEY, seeds,
                                hpos * self._groups + group, self.sampling)

        return sample

    def _launch(self):
        """Dispatch one tick: one lane-batched frame over the live lanes, or
        two where first and later frames run in different dtypes (nothing
        here waits for the device)."""
        live = [s for s, r in enumerate(self._lane) if r is not None]
        groups: dict = {}
        for s in live:
            dtype = self.model.dtype if self._fresh[s] else self._stream_dtype
            groups.setdefault(dtype, []).append(s)
            self._fresh[s] = False
        order = [s for slots in groups.values() for s in slots]
        packed = torch.cat([self._run_frame(slots, dtype)
                            for dtype, slots in groups.items()], dim=1)
        for s in live:
            self._pos[s] += 1
        return (*readback(packed), order, [self._lane[s] for s in order])

    def _run_frame(self, slots: list[int], dtype: torch.dtype) -> torch.Tensor:
        """One frame of the lanes in ``slots`` with their inputs in
        ``dtype``; it updates their state on the device and returns the
        packed ``[G + 2, len(slots)]`` int32 codes, emit and active flags."""
        n = len(slots)
        rows = slots * 2 if n == 1 else slots  # a lone lane runs as two rows
        span = min(self.max_len, max(self._pos[s] for s in slots) + 1)
        lanes = to_device(rows, self.device)
        st, cache = self._state, self._cache
        hpos, history, seeds = st.hpos[lanes], st.history[lanes], st.seeds[lanes]
        offsets, active = cache.offset[lanes], st.active[lanes]
        codes, embed_sum = self.model._lane_frame(
            st.embeds[lanes].to(dtype), cache, lanes, span,
            self._sampler(seeds, hpos, history))
        c0 = codes[:, 0]
        emit = active & (c0 != self._eos)
        # the history records emitted codebook-0 codes only (the solo order)
        ring = (hpos % self._R)[:, None]
        kept = history.gather(1, ring)[:, 0]
        history = history.scatter(1, ring, torch.where(emit, c0, kept)[:, None])
        # next input: trailing[step] (tts_pad past the text) + the frame's
        # summed code embeddings, solo's ``text_embed + embed_sum``
        te = st.trailing[lanes, hpos.clamp(max=self.max_trailing - 1)]
        text = torch.where((hpos < st.trailing_len[lanes])[:, None], te, st.tts_pad[lanes])
        embeds = torch.where(emit[:, None, None], (text[:, None] + embed_sum).to(
            st.embeds.dtype), st.embeds[lanes])
        hpos = hpos + emit
        # a lane that does not emit keeps its offset: its garbage row stays masked
        offset = torch.where(emit, offsets + 1, offsets)
        active = emit & (hpos < st.max_new[lanes]) & (offset < self.max_len)
        for full, part in ((st.embeds, embeds), (st.history, history), (st.hpos, hpos),
                           (st.active, active), (cache.offset, offset)):
            full.index_copy_(0, lanes, part)
        return torch.cat([codes.T, emit[None].long(), active[None].long()])[:, :n].to(
            torch.int32)

    def _harvest(self, tick) -> list[tuple[int, np.ndarray]]:
        """Fetch a launched tick's outputs (its one wait) and credit them to
        its requests; those done since the launch are skipped."""
        host, ready, live, reqs = tick
        if ready is not None:
            ready.synchronize()
        packed = host.numpy()                 # [G + 2, rows]
        codes, emit, active = packed[:-2].T, packed[-2].astype(bool), packed[-1].astype(bool)
        events = []
        for j, (slot, req) in enumerate(zip(live, reqs)):
            if req.done:                      # cancelled while in flight
                continue
            if emit[j]:
                req.codes.append(codes[j].copy())
            finished = not active[j]
            wav = self._audio_delta(req, flush=finished)
            if wav is not None and len(wav):
                events.append((req.request_id, wav))
            if finished:
                req.done = True
                if self._lane[slot] is req:
                    self._lane[slot] = None
                self._meta.pop(req.request_id, None)
        return events

    def _audio_delta(self, req: Qwen3TTSRequest, flush: bool = False):
        """The request's pending frames through its own codec stream state,
        once a chunk's worth is ready (or at its end)."""
        meta = self._meta.get(req.request_id)
        if meta is None:
            return None
        pending = len(req.codes) - meta["decoded"]
        if pending < 1 or (pending < self.chunk_frames and not flush):
            return None
        codec = self.model.codec
        chunk = torch.from_numpy(np.stack(req.codes[meta["decoded"]:], axis=1)[None])
        wav, meta["codec_state"] = decoder_forward(
            codec.params, chunk.to(codec.device, torch.int64), codec.config, meta["codec_state"])
        meta["decoded"] = len(req.codes)
        return wav[0].to(torch.float32).cpu().numpy()


class Qwen3TTSEngineWorker(EngineWorkerBase):
    """Thread multiplexing concurrent callers onto one
    :class:`ContinuousQwen3TTS` (the Qwen3 counterpart of
    ``continuous.TTSEngineWorker``: the same loop and ``synthesize``
    contract; its events are AudioGeneration audio chunks).

    >>> worker = Qwen3TTSEngineWorker(model, slots=4)
    >>> for event in worker.synthesize("hello", voice="vivian"):   # any thread
    ...     ...
    """

    _thread_name = "qwen3tts-engine"

    def __init__(self, model, *, slots: int = 4, generation_parameters=None, **kw):
        self._srv = ContinuousQwen3TTS(model, slots=slots,
                                       generation_parameters=generation_parameters, **kw)
        super().__init__()

    def synthesize(self, text: str, voice: str | None = None, ref_audio=None,
                   ref_text: str | None = None, max_tokens: int | None = None,
                   seed: int = 0):
        """Submit a request; yields AudioGeneration audio events as the shared
        engine streams them. Raises here if the engine rejected the request.
        Closing the generator early (a client hang-up) cancels the request
        and frees its lane. Reference-audio cloning is a solo-path feature
        (per-request ICL prefixes do not share the batched frame)."""
        if ref_audio is not None or ref_text:
            raise ValueError(
                "qwen3 continuous batching serves CustomVoice requests; "
                "use the solo endpoint for ref-audio cloning")
        outq = self._queue_mod.Queue()
        self._enqueue(("submit", (text, voice, max_tokens, seed), outq))
        finished = False
        try:
            while True:
                ev = outq.get()
                if ev is None:
                    finished = True
                    return
                if isinstance(ev, Exception):
                    finished = True
                    raise ev
                yield ev
        finally:
            if not finished:
                try:
                    self._enqueue(("cancel", None, outq))
                except RuntimeError:
                    pass  # the worker is closed or dead: nothing to cancel

    def _fail_item(self, item, failure: Exception) -> None:
        if item[0] == "submit":
            item[2].put(failure)

    @property
    def _idle(self) -> bool:
        return self._srv.idle

    def _handle(self, item) -> None:
        kind, payload, outq = item
        if kind == "cancel":
            # FIFO inbox: this queue's submit was handled before
            for rid, q in list(self._out.items()):
                if q is outq:
                    self._srv.cancel(rid)
                    self._srv.release(rid)
                    del self._out[rid]
            return
        text, voice, max_tokens, seed = payload
        self._admit(lambda: self._srv.submit(text, voice=voice, max_tokens=max_tokens,
                                             seed=seed), outq)

    def _service(self) -> None:
        for rid, wav in self._srv.step():
            if rid in self._out:
                self._out[rid].put(AudioGeneration.from_audio(wav))
        for rid in [r for r in self._out if self._srv.is_finished(r)]:
            self._out.pop(rid).put(None)
            self._srv.release(rid)
