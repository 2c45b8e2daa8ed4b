"""Continuous batching for autoregressive decode: slot-based serving (port
of tpu_audio.parallel.continuous: ``GenRequest``, ``coerce_fused_flag``,
``ContinuousBatcher``, ``ContinuousTTS``, ``EngineWorkerBase`` and
``TTSEngineWorker``; its ``_sample_one`` is ``core.sampling.sample_keyed``).

The engine owns ``slots`` decode lanes. Each holds one in-flight request's
caches, and a lane admits a new request the moment its occupant finishes.
What differs from the JAX package, which compiles each tick as one graph:

- A tick is a Python loop of ``k`` decode steps of device work, and
  nothing in it reads a device value on the host: the lanes' active flags,
  stop checks, offsets and counters stay tensors on the device. The tick
  ends with ONE packed ``[2k+1, n]`` int32 readback (tokens, per-step
  validity, final active flags), copied ``non_blocking`` into pinned host
  memory behind a CUDA event that :meth:`ContinuousBatcher._harvest` waits
  on; with ``pipeline=True`` that copy overlaps the next tick.
- A tick runs exactly the occupied lanes: there are no power-of-two lane
  buckets (they bounded the JAX package's set of compiled graphs). The
  lanes' small vectors (last token, offset, counters) are gathered by a
  device index of slots, and scattered back after the tick; the caches and
  per-request contexts stay stacked ``[slots, ...]``, and the step reads
  and writes them in place through that index. (One whisper-large-v3 lane
  holds 73 MB of self caches and 123 MB of int8 cross K/V: a gather would
  copy them every tick.)
- Sampling: each step's noise hashes (engine seed, request seed, sample
  index, vocab id) on the device (``core.sampling.gumbel_noise``), a
  function of the request alone, as the JAX package's
  ``fold_in(fold_in(base, request_seed), sample_index)`` key is. A
  request's tokens are the same alone or packed with others.

Built with a llama config and no step function, the engine decodes a
llama tree through ``llama.forward``, one lane after another (the JAX
package's default step); ``token_map`` maps a sampled logits-space index
to a model id (restricted heads; the repetition history stays in logits
space). ``ContinuousTTS`` and ``TTSEngineWorker`` serve Orpheus-family
speech over it: a w8a8 tree decodes every step of every live lane through
``ops.fused_llama.fused_llama_stack_lanes`` (``LlamaTTS._fused_lane_hooks``),
any other through the plain tick.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu_audio_torch.core import kv_cache
from tpu_audio_torch.core.generation import AudioGeneration, AudioGenerationError
from tpu_audio_torch.core.sampling import SamplingParams, apply_repetition_penalty, sample_keyed
from tpu_audio_torch.models import llama

__all__ = ["ContinuousBatcher", "ContinuousTTS", "EngineWorkerBase", "GenRequest",
           "SlotEngine", "TTSEngineWorker", "coerce_fused_flag", "llama_lanes", "readback",
           "to_device"]


@dataclasses.dataclass
class GenRequest:
    """One submitted generation request and its accumulated output."""

    request_id: int
    prompt: np.ndarray
    max_new: int
    seed: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    context: object = None   # per-request conditioning tensors (or None)


class _Tick(NamedTuple):
    """One launched decode tick, harvested later (pipelined engines fetch
    a tick's outputs only after the NEXT tick is already in flight)."""

    packed: torch.Tensor     # host [2K+1, n] int32 (pinned for a CUDA tick)
    ready: object            # CUDA event recorded after the copy, or None
    live: list               # slot index of each live lane at launch
    reqs: list               # the occupying GenRequest per live lane
    k: int                   # decode steps in the tick


@dataclasses.dataclass
class _Lanes:
    """Per-lane decode state on the device: ``[slots]`` for the engine,
    ``[n]`` for the lanes of one tick."""

    last: torch.Tensor       # int64, next input token
    active: torch.Tensor     # bool
    n_new: torch.Tensor      # int64, tokens sampled so far
    max_new: torch.Tensor    # int64, per-request budget
    seeds: torch.Tensor      # int64, request RNG seeds
    hist: torch.Tensor       # [., H] int64, logits-space ring buffer
    hpos: torch.Tensor       # int64, ring write position
    offset: torch.Tensor     # int64, cache write position

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def select(self, idx: torch.Tensor) -> "_Lanes":
        return _Lanes(*(t.index_select(0, idx) for t in self.tensors()))

    def put(self, idx: torch.Tensor, sub: "_Lanes") -> None:
        for full, part in zip(self.tensors(), sub.tensors()):
            full.index_copy_(0, idx, part)


def coerce_fused_flag(fused) -> bool:
    """Normalize the engines' ``fused: str | bool`` knob: "auto"/"1"/
    truthy enable, "0"/"off"/"false"/"no"/"disabled"/"none"/"" disable
    (bool(str) alone would ENABLE for any non-empty string)."""
    if isinstance(fused, str):
        return fused.lower() not in ("0", "off", "false", "no",
                                     "disabled", "none", "")
    return bool(fused)


def to_device(values: list[int], device: torch.device) -> torch.Tensor:
    """int64 tensor of ``values`` on ``device``; on a CUDA device from pinned
    host memory, without waiting for the copy."""
    host = torch.tensor(values, dtype=torch.int64)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def readback(packed: torch.Tensor) -> tuple[torch.Tensor, object]:
    """Start a tick's one copy of its packed outputs to the host: ``(host,
    ready)``, where on a CUDA device ``host`` is pinned memory filled
    ``non_blocking`` and ``ready`` the CUDA event to wait on before reading
    it (None on the CPU, where ``host`` is ``packed`` itself)."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(packed.device))
    return host, ready


def llama_lanes(cfg, max_len: int, params, dtype=None, step: Callable | None = None,
                prefill: Callable | None = None) -> dict:
    """``step_fn``, ``prefill_fn`` and ``cache_factory`` of the plain tick
    over a llama tree, each lane on its own ``KVCache`` row of stacked
    caches: ``step(params, tok [1, 1], cache) -> (logits [1, V], cache)``
    (default: ``llama.forward``'s last-position logits) and
    ``prefill(params, ids [1, T], cache) -> (_, cache)`` (default:
    ``llama.forward``); on an engine with a ``context_template``,
    ``prefill`` also takes the lane's context rows (a tuple, one row of each
    context tensor). The caches are a ``kv_cache.FusedLaneRow`` whose
    ``k``/``v`` are head-major ``[slots, L, 1, n_kv, S, hd]`` (one
    ``KVCache`` row per slot, not the fused kernels' position-major
    layout), with ``offset`` and ``valid_from`` ``[slots]`` int64. They
    take the device of the tree's first floating leaf, and its dtype unless
    ``dtype`` is given."""
    lead = next(t for t in llama._leaves(params) if t.is_floating_point())
    dtype = dtype or lead.dtype
    L, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
    if step is None:
        def step(params, tok, cache):
            logits, cache = llama.forward(params, tok, cache, cfg)
            return logits[:, -1], cache
    if prefill is None:
        def prefill(params, ids, cache):
            return llama.forward(params, ids, cache, cfg)

    def row(cache, slot, pos):
        return kv_cache.KVCache(cache.k[slot], cache.v[slot], pos, cache.valid_from[slot])

    def step_fn(params, cache, slot, tok, pos, ctx):
        return step(params, tok, row(cache, slot, pos))[0]

    def prefill_fn(params, cache, slot, ids, valid_from, ctx):
        cache.valid_from[slot] = int(valid_from)
        ids = torch.from_numpy(ids.astype(np.int64)).to(lead.device)[None]
        lane_ctx = () if ctx is None else (tuple(c[slot] for c in ctx),)
        return prefill(params, ids, row(cache, slot, 0), *lane_ctx)[1].offset

    def cache_factory(slots):
        def zeros(dt, *shape):
            return torch.zeros(shape, dtype=dt, device=lead.device)

        shape = (slots, L, 1, n_kv, max_len, hd)
        return kv_cache.FusedLaneRow(zeros(dtype, *shape), zeros(dtype, *shape),
                                     zeros(torch.int64, slots), zeros(torch.int64, slots))

    return dict(step_fn=step_fn, prefill_fn=prefill_fn, cache_factory=cache_factory)


class SlotEngine:
    """The slot lifecycle that the serving engines share: ``slots`` lanes,
    a queue of pending requests, prefill buckets, pipelined ticks, cancel
    and release.

    A subclass calls :meth:`_init_slots` and provides ``buckets``, a
    ``_state`` whose ``active`` is a ``[slots]`` bool tensor on the device,
    and ``_admit()`` (pending requests into free lanes), ``_launch()``
    (dispatch one tick over the live lanes, waiting for nothing) and
    ``_harvest(tick)`` (its one wait, then its events). A request is any
    object with ``request_id`` and ``done``; ``_forget(request_id)`` drops
    what the subclass keeps beside it.
    """

    def _init_slots(self, slots: int, pipeline: bool) -> None:
        self.slots = int(slots)
        # pipelined ticks: launch tick N+1 before fetching tick N's packed
        # outputs, so the copy rides the next tick; one tick of latency
        self.pipeline = bool(pipeline)
        self._inflight = None
        self._next_id = 0
        self._pending: list = []
        self._lane: list = [None] * self.slots
        self._pos = [0] * self.slots  # host bound of each lane's offset
        self.requests: dict = {}

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        big = self.buckets[-1]
        return ((n + big - 1) // big) * big

    def _forget(self, request_id: int) -> None:
        """Drop what the subclass keeps beside a done request."""

    @property
    def idle(self) -> bool:
        return (not self._pending and self._inflight is None
                and all(r is None for r in self._lane))

    def release(self, request_id: int) -> None:
        """Forget a finished or cancelled request (a long-running server
        must release consumed requests, or ``requests`` grows without
        bound)."""
        req = self.requests.get(request_id)
        if req is not None and req.done:
            del self.requests[request_id]
            self._forget(request_id)

    def cancel(self, request_id: int) -> bool:
        """Abort a request: a pending one is dequeued; a live one frees its
        lane at once (its device flag flips, so it emits nothing more).
        Returns False for unknown or finished ids. What it already emitted
        stays on the request."""
        req = self.requests.get(request_id)
        if req is None or req.done:
            return False
        if req in self._pending:
            self._pending.remove(req)
        for slot, occupant in enumerate(self._lane):
            if occupant is req:
                self._state.active[slot] = False
                self._lane[slot] = None
        req.done = True
        self._forget(request_id)
        if self._inflight is not None and all(r is None for r in self._lane):
            # the in-flight tick concerns only done requests: drop it
            # unharvested (the device state after it is current)
            self._inflight = None
        return True

    @torch.no_grad()
    def step(self) -> list:
        """Admit pending requests, then run ONE tick. Returns its events:
        this tick's with ``pipeline=False``, the PREVIOUS tick's with
        ``pipeline=True`` (the new tick is dispatched before the old tick's
        readback is waited on, so the copy rides the next tick)."""
        self._admit()
        prev, self._inflight = self._inflight, None
        if any(r is not None for r in self._lane):
            tick = self._launch()
            if self.pipeline:
                self._inflight = tick
            else:
                events = self._harvest(prev) if prev is not None else []
                return events + self._harvest(tick)
        return self._harvest(prev) if prev is not None else []

    def run(self):
        """Generator draining the engine: yields :meth:`step`'s events
        until every submitted request is done."""
        while not self.idle:
            yield from self.step()


class ContinuousBatcher(SlotEngine):
    """Slot-based continuous batching over a model's decode step.

    >>> eng = ContinuousBatcher(params, cfg, slots=4, max_len=512,
    ...                         stop_token=eos)
    >>> eng.submit(prompt_tokens, max_new=64)
    >>> for request_id, token in eng.run():
    ...     ...                         # tokens stream out as lanes step

    By default (a llama ``cfg`` and no step function) the engine decodes a
    stacked-layer llama tree with its full-vocab head through
    :func:`llama_lanes`. Other models plug in through:

    - ``cache_factory(slots)``: the lanes' stacked caches, any object with
      an ``offset`` attribute, an int64 ``[slots]`` tensor on ``device``
      that the engine owns (each lane's next write position);
    - ``prefill_fn(params, cache, slot, ids, valid_from, ctx) -> int``:
      teacher-forces the prompt ``ids`` (host int32, left-padded with
      ``pad_token`` up to ``valid_from``) into lane ``slot``'s caches and
      returns its offset;
    - ``batch_step_fn(params, cache, lanes, last, offsets, ctx) ->
      logits [n, V]``: one decode step of every live lane in one call;
      ``lanes`` (int64 slot indices), ``last`` (input tokens) and
      ``offsets`` (write positions) are ``[n]`` device tensors, and the
      step writes each lane's new rows into its slot of ``cache`` in place;
    - or ``step_fn(params, cache, slot, tok [1, 1], pos, ctx) ->
      logits [1, V]``: one lane's step at host position ``pos`` (exact for
      a live lane; a frozen lane's garbage step is clamped into the cache);
    - ``token_map(idx) -> ids``: a sampled logits-space index to the model
      id fed back and emitted (restricted heads); the repetition history
      keeps the logits-space index.

    Per-request conditioning (encoder-decoder serving): pass
    ``context_template``, a tuple of tensors whose shapes and dtypes (not
    values; ``meta`` tensors will do) are one request's conditioning, and
    supply a matching ``context=`` tuple to :meth:`submit`. The engine
    stacks the contexts on the slot axis (``ctx``, ``[slots, ...]``).
    ``logits_hook(logits [n, V], n_new [n]) -> logits`` applies model
    logit rules inside the tick (e.g. whisper suppression; ``n_new == 0``
    marks the first sampled position).

    ``sampling`` selects greedy/temperature/top-k/top-p/repetition
    penalty. ``prefill_buckets`` are the padded prompt lengths; prompts
    longer than the largest bucket pad up to the next multiple of it.

    ``step_tokens=K`` decodes K tokens per tick: the host's per-tick work
    amortizes K-fold. Sampled tokens are identical for any K: each
    request's noise depends only on (request seed, sample index), and
    lanes that hit their stop mid-tick freeze for the rest of it (their
    garbage k/v lands at their frozen offset, never attended). Admission
    happens at tick boundaries. ``min_tick_tokens=T`` makes every tick
    decode at least T live tokens (:meth:`_tick_k`). ``pipeline=True``
    launches tick N+1 before fetching tick N's tokens, so :meth:`step`
    returns the previous tick's tokens. Its events are ``(request_id,
    token)`` pairs in per-lane sample order.
    """

    def __init__(self, params, cfg=None, *, slots: int = 4, max_len: int = 1024,
                 stop_token: int = -1, sampling: SamplingParams | None = None,
                 prefill_buckets: tuple[int, ...] = (32, 64, 128, 256),
                 seed: int = 0, device=None,
                 step_fn: Callable | None = None,
                 batch_step_fn: Callable | None = None,
                 prefill_fn: Callable | None = None,
                 cache_factory: Callable | None = None,
                 token_map: Callable | None = None,
                 pad_token: int = 0, step_tokens: int = 1,
                 context_template=None,
                 logits_hook: Callable | None = None,
                 min_tick_tokens: int | None = None,
                 pipeline: bool = False):
        self.params = params
        self._init_slots(slots, pipeline)
        self.max_len = int(max_len)
        if (step_fn is None and batch_step_fn is None) or prefill_fn is None \
                or cache_factory is None:
            if cfg is None:
                raise ValueError("ContinuousBatcher: pass cfg for the default llama "
                                 "step, or step_fn / batch_step_fn with prefill_fn "
                                 "and cache_factory")
            plain = llama_lanes(cfg, self.max_len, params)
            if step_fn is None and batch_step_fn is None:
                step_fn = plain["step_fn"]
            prefill_fn = prefill_fn or plain["prefill_fn"]
            cache_factory = cache_factory or plain["cache_factory"]
        self.stop_token = int(stop_token)
        self.sampling = sampling or SamplingParams(temperature=0.0)
        self.step_tokens = int(step_tokens)
        if self.step_tokens < 1:
            raise ValueError(f"step_tokens must be >= 1, got {step_tokens}")
        self.min_tick_tokens = (None if min_tick_tokens is None
                                else int(min_tick_tokens))
        self.buckets = tuple(sorted(prefill_buckets))
        self.pad_token = int(pad_token)
        self._token_map = token_map
        self.history_size = max(1, self.sampling.repetition_context_size) \
            if self.sampling.repetition_penalty != 1.0 else 1
        self._cache = cache_factory(self.slots)
        # the lane state lives beside the caches unless the caller says
        self.device = (torch.device(device) if device is not None
                       else self._cache.offset.device)
        self.seed = int(seed)
        self._step_fn = step_fn
        self._batch_step_fn = batch_step_fn
        self._prefill = prefill_fn
        self._logits_hook = logits_hook
        self._ctx = (None if context_template is None else tuple(
            torch.zeros((self.slots,) + tuple(t.shape), dtype=t.dtype,
                        device=self.device) for t in context_template))
        self._state = self._init_state()

    # -- state ---------------------------------------------------------

    def _init_state(self) -> _Lanes:
        def zeros(*shape):
            return torch.zeros(shape or (self.slots,), dtype=torch.int64,
                               device=self.device)

        return _Lanes(last=zeros(), active=zeros().bool(), n_new=zeros(),
                      max_new=zeros(), seeds=zeros(),
                      hist=zeros(self.slots, self.history_size), hpos=zeros(),
                      offset=self._cache.offset)

    # -- public API ----------------------------------------------------

    def submit(self, prompt, max_new: int, seed: int = 0,
               context=None) -> GenRequest:
        """Queue a request; it is admitted at the next :meth:`step` with a
        free lane. Returns the live :class:`GenRequest` (its ``tokens``
        list fills in as the engine runs). ``context`` is the request's
        conditioning tuple, required iff the engine was built with a
        ``context_template``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        # canonicalize into int32 range here, on the caller's thread: an
        # out-of-range client value must fail or wrap here, not inside the
        # engine thread's tick (max_new is capped by the cache anyway)
        max_new = min(int(max_new), self.max_len)
        seed = int(seed) % (2 ** 31)
        if (context is None) != (self._ctx is None):
            raise ValueError(
                "context must be supplied exactly when the engine has a "
                "context_template")
        padded = self._bucket(prompt.size)
        if padded >= self.max_len:
            raise ValueError(
                f"prompt pads to {padded} >= max_len={self.max_len}")
        req = GenRequest(request_id=self._next_id, prompt=prompt,
                         max_new=max_new, seed=seed, context=context)
        self._next_id += 1
        self._pending.append(req)
        self.requests[req.request_id] = req
        return req

    def _tick_k(self, live: int) -> int:
        """Decode steps for a tick over ``live`` occupied lanes: enough
        that the tick decodes >= ``min_tick_tokens`` live tokens in all,
        rounded up to a ``step_tokens`` multiple (keeps emission
        granularity aligned for frame-structured consumers)."""
        if self.min_tick_tokens is None:
            return self.step_tokens
        steps = -(-self.min_tick_tokens // max(1, live))    # ceil div
        return max(self.step_tokens,
                   -(-steps // self.step_tokens) * self.step_tokens)

    def _admit(self) -> None:
        """Prefill pending requests into free lanes. The prefill covers
        the padded prompt *minus its last token*; the first decode step
        feeds that token, as the offline loop does."""
        st = self._state
        for slot in range(self.slots):
            if self._lane[slot] is not None or not self._pending:
                continue
            req = self._pending.pop(0)
            padded = self._bucket(req.prompt.size)
            pad = padded - req.prompt.size
            tokens = np.full((padded,), self.pad_token, np.int32)
            tokens[pad:] = req.prompt
            if self._ctx is not None:
                for full, row in zip(self._ctx, req.context):
                    full[slot].copy_(row)
            offset = self._prefill(self.params, self._cache, slot, tokens[:-1],
                                   pad, self._ctx)
            st.last[slot] = int(req.prompt[-1])
            st.offset[slot] = offset
            st.active[slot] = req.max_new > 0 and offset < self.max_len
            st.n_new[slot] = 0
            st.max_new[slot] = req.max_new
            st.seeds[slot] = req.seed
            st.hist[slot] = 0
            st.hpos[slot] = 0
            self._pos[slot] = offset
            req.context = None  # free host reference; rows live on device
            self._lane[slot] = req

    def _one_step(self, lanes: torch.Tensor, live: list[int], sub: _Lanes,
                  step: int) -> tuple[_Lanes, torch.Tensor, torch.Tensor]:
        """One decode step of the tick's lanes, all on the device."""
        if self._batch_step_fn is not None:
            logits = self._batch_step_fn(self.params, self._cache, lanes,
                                         sub.last, sub.offset, self._ctx)
        else:
            logits = torch.cat([self._step_fn(
                self.params, self._cache, slot, sub.last[j:j + 1].view(1, 1),
                min(self._pos[slot] + step, self.max_len - 1), self._ctx)
                for j, slot in enumerate(live)])
        logits = logits.to(torch.float32)
        if self._logits_hook is not None:
            logits = self._logits_hook(logits, sub.n_new)
        H = self.history_size
        penalty = self.sampling.repetition_penalty
        if penalty != 1.0:
            hvalid = (torch.arange(H, device=logits.device)[None, :]
                      < torch.clamp(sub.hpos, max=H)[:, None])
            logits = apply_repetition_penalty(logits, sub.hist, hvalid, penalty)
        idx = sample_keyed(logits, self.seed, sub.seeds, sub.n_new, self.sampling)
        active = sub.active
        ring = (sub.hpos % H)[:, None]
        kept = sub.hist.gather(1, ring)[:, 0]
        hist = sub.hist.scatter(1, ring, torch.where(active, idx, kept)[:, None])
        toks = idx if self._token_map is None else self._token_map(idx)
        toks = torch.where(active, toks, sub.last)
        # freeze idle lanes: their garbage k/v landed at the (unattended)
        # old offset; keep it unattended
        offset = torch.where(active, sub.offset + 1, sub.offset)
        n_new = sub.n_new + active
        hpos = sub.hpos + active
        new_active = (active & (toks != self.stop_token)
                      & (n_new < sub.max_new) & (offset < self.max_len))
        return (_Lanes(last=toks, active=new_active, n_new=n_new,
                       max_new=sub.max_new, seeds=sub.seeds, hist=hist,
                       hpos=hpos, offset=offset), toks, active)

    def _launch(self) -> _Tick:
        """Dispatch one decode tick (nothing in it waits for the device)."""
        live = [s for s, r in enumerate(self._lane) if r is not None]
        reqs = [self._lane[s] for s in live]
        k = self._tick_k(len(live))
        lanes = to_device(live, self.device)
        sub = self._state.select(lanes)
        toks, valid = [], []
        for step in range(k):
            sub, t, v = self._one_step(lanes, live, sub, step)
            toks.append(t)
            valid.append(v)
        self._state.put(lanes, sub)
        for s in live:
            self._pos[s] += k
        packed = torch.cat([torch.stack(toks), torch.stack(valid).long(),
                            sub.active[None].long()]).to(torch.int32)
        return _Tick(*readback(packed), live, reqs, k)

    def _harvest(self, tick: _Tick) -> list[tuple[int, int]]:
        """Fetch a launched tick's outputs and credit them to requests.
        Requests cancelled (``done``) between launch and harvest are
        skipped; a lane whose launch-time occupant already moved on (slot
        reused after cancel) is left untouched."""
        if tick.ready is not None:
            tick.ready.synchronize()          # ONE wait per tick
        packed = tick.packed.numpy()          # [2K+1, n]
        K = tick.k
        toks_host = packed[:K]
        valid_host = packed[K : 2 * K].astype(bool)
        active_host = packed[2 * K].astype(bool)
        emitted = []
        for k in range(K):
            for j, req in enumerate(tick.reqs):
                if req.done or not valid_host[k, j]:
                    continue
                tok = int(toks_host[k, j])
                if tok != self.stop_token:
                    req.tokens.append(tok)
                    emitted.append((req.request_id, tok))
        for j, (slot, req) in enumerate(zip(tick.live, tick.reqs)):
            if not active_host[j] and not req.done:
                req.done = True
                if self._lane[slot] is req:
                    self._lane[slot] = None
        return emitted

class EngineWorkerBase:
    """Owns a slot engine on a dedicated thread; callers on any thread
    hand work in through an inbox and block only on their own queue.

    The engine is single-threaded by design (one device, one stream).
    Subclasses provide the engine-specific pieces: ``_idle``,
    ``_handle(item)`` (admit one inbox item), ``_service()`` (one engine
    tick + result delivery) and ``_fail_item`` (route a drained item's
    failure to its caller).

    Thread-death safety: ``_enqueue`` atomically checks ``_closing``
    under ``_lock`` against the death handler's drain, so an item either
    lands before the drain (and gets the failure) or the caller raises:
    a dying engine can never strand a caller on an unserviced queue.
    """

    _thread_name = "engine"

    def __init__(self):
        self._queue_mod = queue
        self._inbox: queue.Queue = queue.Queue()
        self._out: dict[int, queue.Queue] = {}
        self._closing = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self._thread_name)
        self._thread.start()

    def _enqueue(self, item) -> None:
        with self._lock:
            if self._closing:
                raise RuntimeError("worker is closed")
            self._inbox.put(item)

    def close(self) -> None:
        """Drain in-flight requests, then stop the engine thread."""
        with self._lock:
            self._closing = True
            self._inbox.put(None)
        self._thread.join()

    def _loop(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:  # noqa: BLE001 — engine died: unblock
            # every waiting caller gets the failure instead of hanging
            # forever on its queue; subsequent submissions raise
            failure = RuntimeError(
                f"{self._thread_name} thread died: {e!r}")
            with self._lock:
                self._closing = True
                for q in self._out.values():
                    q.put(failure)
                self._out.clear()
                while not self._inbox.empty():
                    item = self._inbox.get_nowait()
                    if item is not None:
                        self._fail_item(item, failure)

    def _fail_item(self, item, failure: Exception) -> None:
        item[-1].put(failure)

    def _run_loop(self) -> None:
        stop = False
        while not (stop and self._idle and self._inbox.empty()):
            # drain submissions; block only when the engine has no work
            block = self._idle and not stop
            while True:
                try:
                    item = self._inbox.get(block=block, timeout=None)
                except queue.Empty:
                    break
                block = False
                if item is None:
                    stop = True
                    continue
                self._handle(item)
                if self._inbox.empty():
                    break
            self._service()

    # -- subclass hooks --------------------------------------------------

    @property
    def _idle(self) -> bool:
        raise NotImplementedError

    def _handle(self, item) -> None:
        raise NotImplementedError

    def _service(self) -> None:
        raise NotImplementedError

    def _admit(self, submit, outq) -> None:
        """Run one engine ``submit`` thunk, registering its out-queue;
        rejections flow to the caller, and even a thread-killing failure
        mid-submit still unblocks them before propagating."""
        try:
            req = submit()
            self._out[req.request_id] = outq
        except Exception as e:  # noqa: BLE001 — caller re-raises
            outq.put(e)
        except BaseException as e:
            outq.put(RuntimeError(
                f"{self._thread_name} thread died: {e!r}"))
            raise


class ContinuousTTS:
    """Continuous-batching front end for Orpheus-family TTS serving.

    Wraps a loaded :class:`~tpu_audio_torch.models.tts.llama_tts.LlamaTTS`:
    text requests share the model trunk through a :class:`ContinuousBatcher`
    (band head, repetition penalty and stop token as in the offline loop),
    while each request's SNAC frames decode to waveform on its own as they
    accumulate: the multi-request analog of ``generate_stream``.

    >>> srv = ContinuousTTS(model, slots=4)
    >>> r = srv.submit("Hello there.", voice="tara")
    >>> for request_id, event in srv.run():
    ...     ...  # AudioGeneration token/audio events per request

    One sampling configuration per server; ``max_tokens`` and ``seed`` stay
    per request. ``fused="auto"`` takes the fused tick (one
    ``fused_llama_stack_lanes`` call per decode step for every live lane)
    whenever the model's tree is w8a8 of a shape the kernel takes, at any
    ``slots``; any other tree serves through the plain tick (each live lane
    through ``model._step_fn`` in turn). On a CUDA device a w8a8 tree only
    serves through the kernel: ``fused="off"``, or a shape the kernel does
    not take, raises.
    """

    def __init__(self, model, *, slots: int = 4, generation_parameters=None,
                 seed: int = 0, max_len: int | None = None,
                 prefill_buckets: tuple[int, ...] = (64, 128, 256, 512),
                 step_tokens: int = 7, pipeline: bool = True,
                 fused: str | bool = "auto"):
        if model.tokenizer is None:
            raise AudioGenerationError("tokenizer not loaded")
        if model.codec is None:
            raise AudioGenerationError("SNAC codec not loaded")
        self.model = model
        p = generation_parameters or model.default_generation_parameters()
        self.gen_params = p
        if max_len is None:
            max_len = max(prefill_buckets) + p.max_tokens + 1
        sampling = SamplingParams(
            temperature=p.temperature, top_p=p.top_p, top_k=p.top_k,
            repetition_penalty=p.repetition_penalty,
            repetition_context_size=p.repetition_context_size)
        self.fused = self._fused_route(fused)
        if self.fused:
            engine_kw = model._fused_lane_hooks(max_len)
        else:
            engine_kw = dict(params=model.params, **llama_lanes(
                model.config, max_len, model.params, model.dtype, step=model._step_fn,
                prefill=model._prefill))
        self.engine = ContinuousBatcher(
            engine_kw.pop("params"), model.config, slots=slots, max_len=max_len,
            stop_token=model.tokens.end_of_speech, sampling=sampling,
            prefill_buckets=prefill_buckets, seed=seed, **engine_kw,
            token_map=model._token_map, pad_token=model.tokens.pad_token,
            # one SNAC code group a tick: frame-aligned emission (tokens do
            # not depend on it); pipelined ticks overlap the token readback
            # with the next tick's decode, at one tick of emission latency
            step_tokens=step_tokens, pipeline=pipeline)
        ccfg = getattr(model.codec, "config", None)
        self._spg = 4 * (ccfg.hop_length if ccfg else 512)  # samples a 7-token group
        self.chunk_tokens = 7 * max(
            1, int(p.streaming_interval * model.sample_rate / self._spg))
        # bounded SNAC decode window: a long request decodes only the last
        # ~decode_window_s of frames a flush (constant work a flush instead
        # of work growing with the request, which would hold every lane's
        # tick as any one request grows). The window start aligns to the
        # decoder's local-attention blocks (block-local attention is then
        # exact for the suffix) and ~7 s of overlap context absorbs the
        # convolutions' edge transients; below the threshold the decode
        # covers the whole prefix, as a solo generate_stream does.
        decode_window_s = 8.0
        strides = getattr(ccfg, "vq_strides", None) or [4, 2, 1]
        attn = getattr(ccfg, "attn_window_size", None)
        self._align_groups = max(1, (attn or 1) // strides[0])
        self.decode_window_groups = max(
            2 * (self.chunk_tokens // 7) + self._align_groups,
            int(decode_window_s * model.sample_rate / self._spg))
        self._meta: dict[int, dict] = {}

    def _fused_route(self, fused) -> bool:
        """Whether to build the fused tick; see the class docstring."""
        from tpu_audio_torch.models.tts.llama_tts import _fused_route

        model = self.model
        # raises on CUDA for a w8a8 tree the kernels do not take
        fused_tree = _fused_route(model.params, model.config, model.device)
        if coerce_fused_flag(fused):
            return fused_tree
        if fused_tree and model.device.type == "cuda":
            raise ValueError(
                "ContinuousTTS(fused='off'): a w8a8 tree on CUDA decodes through the "
                "fused_llama_stack_lanes kernel; the plain tick has no kernel for it")
        return False

    def submit(self, text: str, voice: str | None = None, ref_audio=None,
               ref_text: str | None = None, max_tokens: int | None = None,
               seed: int = 0) -> GenRequest:
        prompt = self.model.prepare_input_ids(text, voice, ref_audio, ref_text)
        req = self.engine.submit(np.asarray(prompt, np.int32),
                                 max_new=max_tokens or self.gen_params.max_tokens,
                                 seed=seed)
        self._meta[req.request_id] = {"prompt": list(prompt), "decoded_samples": 0,
                                      "last_decode": 0}
        return req

    def _audio_delta(self, req: GenRequest) -> np.ndarray | None:
        """Decode the request's pending frames (a bounded suffix window, see
        ``decode_window_groups``); return the new samples."""
        from tpu_audio_torch.models.tts.llama_tts import ungroup_codes

        meta = self._meta[req.request_id]
        code_list = self.model.parse_output(meta["prompt"] + req.tokens)
        n_groups = len(code_list) // 7
        if n_groups < 1:
            return None
        start = 0
        if n_groups > self.decode_window_groups:
            start = n_groups - self.decode_window_groups
            # the window must still cover everything not yet emitted
            start = min(start, meta["decoded_samples"] // self._spg)
            start -= start % self._align_groups
        l1, l2, l3 = ungroup_codes(code_list[start * 7: n_groups * 7],
                                   self.model.tokens.codebook_size)
        wav = self.model.codec.decode([np.asarray([l1], np.int32), np.asarray([l2], np.int32),
                                       np.asarray([l3], np.int32)])
        wav = wav[0].to(torch.float32).cpu().numpy()
        emitted_in_window = meta["decoded_samples"] - start * self._spg
        if wav.shape[0] <= emitted_in_window:
            return None
        meta["decoded_samples"] = start * self._spg + wav.shape[0]
        return wav[emitted_in_window:]

    def step(self) -> list[tuple[int, AudioGeneration]]:
        """One engine tick. Returns ``(request_id, AudioGeneration)`` events:
        a token event a sampled token, and an audio event for each request
        whose pending frames crossed the streaming interval or that
        finished."""
        events = [(rid, AudioGeneration.from_token(tok)) for rid, tok in self.engine.step()]
        for rid, meta in list(self._meta.items()):
            req = self.engine.requests[rid]
            if req.done or len(req.tokens) - meta["last_decode"] >= self.chunk_tokens:
                meta["last_decode"] = len(req.tokens)
                delta = self._audio_delta(req)
                if delta is not None:
                    events.append((rid, AudioGeneration.from_audio(delta)))
                if req.done:
                    del self._meta[rid]
        return events

    def is_finished(self, request_id: int) -> bool:
        """True once the request's tokens are done and its audio flushed
        (no further events will arrive for it)."""
        req = self.engine.requests.get(request_id)
        return req is not None and req.done and request_id not in self._meta

    def cancel(self, request_id: int) -> bool:
        """Abort a request (e.g. the client hung up): frees its decode lane
        and drops its unflushed audio."""
        out = self.engine.cancel(request_id)
        self._meta.pop(request_id, None)
        return out

    @property
    def idle(self) -> bool:
        return self.engine.idle and not self._meta

    def run(self):
        """Generator draining the server: yields ``(request_id, event)``
        until every submitted request has finished (audio flushed)."""
        while not self.idle:
            yield from self.step()


class TTSEngineWorker(EngineWorkerBase):
    """Thread multiplexing concurrent callers onto one :class:`ContinuousTTS`:

    >>> worker = TTSEngineWorker(model, slots=4)
    >>> for event in worker.synthesize("hello"):   # any thread
    ...     ...                     # AudioGeneration token/audio events

    Requests admit as lanes free up; callers block only on their own queue.
    ``close()`` stops the thread after in-flight work drains.
    """

    _thread_name = "tts-engine"

    def __init__(self, model, *, slots: int = 4, generation_parameters=None,
                 seed: int = 0, **kw):
        self._srv = ContinuousTTS(model, slots=slots,
                                  generation_parameters=generation_parameters, seed=seed,
                                  **kw)
        super().__init__()

    def synthesize(self, text: str, voice: str | None = None, ref_audio=None,
                   ref_text: str | None = None, max_tokens: int | None = None,
                   seed: int = 0):
        """Submit a request; yields its AudioGeneration events (token and
        audio) as the shared engine produces them. Raises here if the engine
        rejected the request (e.g. a prompt too long). Closing the generator
        early (a client hang-up) cancels the request and frees its lane."""
        outq = self._queue_mod.Queue()
        self._enqueue(("submit", (text, voice, ref_audio, ref_text, max_tokens, seed),
                       outq))
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
            # FIFO inbox: this queue's submit was handled before, so the
            # reverse lookup is exact
            for rid, q in list(self._out.items()):
                if q is outq:
                    self._srv.cancel(rid)
                    self._srv.engine.release(rid)
                    del self._out[rid]
            return
        text, voice, ref_audio, ref_text, max_tokens, seed = payload
        self._admit(lambda: self._srv.submit(text, voice, ref_audio, ref_text, max_tokens,
                                             seed), outq)

    def _service(self) -> None:
        for rid, ev in self._srv.step():
            if rid in self._out:
                self._out[rid].put(ev)
        for rid in [r for r in self._out if self._srv.is_finished(r)]:
            self._out.pop(rid).put(None)
            self._srv.engine.release(rid)
