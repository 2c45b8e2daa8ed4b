"""Streaming STT: incremental mel -> window encoder -> a session that
promotes provisional tokens to confirmed ones (port of
tpu_audio.models.stt.streaming with its Qwen3-ASR, Cohere and MOSS cores).

- :class:`IncrementalMelSpectrogram`: overlap-save mel over a rolling
  buffer, the first chunk reflect-prefixed; each ``process`` that yields
  frames runs ``ops.mel.fused_log_mel`` once (kernel 1 on CUDA) and
  normalises at the running maximum of the log mel (``max - 8`` clamp,
  ``(x + 4) / 4``), so its frames equal the one-shot mel before
  normalisation, and after it only where the maximum came early.
- :class:`StreamingEncoder`: accumulates mel frames into ``window_size``
  windows (800 frames, ~8 s, for Qwen3-ASR), encodes each full window once
  through the model's ``encode_single_window`` and re-encodes the pending
  partial window for early feedback; ``overlap_frames`` keeps a window's
  tail pending so that consecutive windows overlap.
- :class:`StreamingInferenceSession`: repeated decode passes over the
  pending window with the confirmed tokens teacher-forced; provisional
  tokens are confirmed after ``min_agreement_passes`` identical passes and
  ``delay_seconds`` of age; completed windows are finalized by a one-shot
  decode appended to the completed text. Passes run inline in
  ``feed_audio``, paced by an injectable ``clock``. A model with
  ``streaming_decode_token_ids`` (Cohere Transcribe) gets the raw-audio
  core instead: 8 s windows that overlap, partial passes over the pending
  audio with the confirmed tokens forced, the same promotion. A model with
  ``streaming_transcribe_window`` (MOSS-Transcribe-Diarize) gets the
  text-level core: 3-6 s windows finalized whole, partial passes over the
  pending tail between them, no token promotion.

Mel frames and encoder features stay on the model's device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from tpu_audio_torch.core import dsp
from tpu_audio_torch.core.generation import STTGenerateParameters
from tpu_audio_torch.ops.mel import fused_log_mel

__all__ = ["IncrementalMelSpectrogram", "StreamingEncoder", "StreamingInferenceSession",
           "StreamingConfig", "DelayPreset", "EventKind", "TranscriptionEvent",
           "append_text", "concat_text"]


# ---------------------------------------------------------------------------
# Incremental mel
# ---------------------------------------------------------------------------


class IncrementalMelSpectrogram:
    """Overlap-save incremental log-mel (symmetric Hann, slaney-normed HTK
    filters); ``process`` returns the new frames ``[n, n_mels]`` (or None),
    ``flush`` drains the tail. Frames are computed on ``device``."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 400, hop_length: int = 160,
                 n_mels: int = 128, device=None):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.overlap_size = n_fft - hop_length
        self._overlap = np.zeros((0,), np.float32)
        self._first = True
        self._running_log_max = -np.inf
        self.total_frames = 0
        self._window = torch.from_numpy(dsp.hanning_window(n_fft, periodic=False)).to(
            self.device)
        self._filters = torch.from_numpy(dsp.mel_filters(sample_rate, n_fft, n_mels,
                                                         norm="slaney")).to(self.device)

    def _mel_frames(self, signal: np.ndarray) -> torch.Tensor:
        """``log10(max(|rfft(frame * window)|^2 @ F, 1e-10))`` of every
        whole frame of ``signal``."""
        x = torch.from_numpy(np.ascontiguousarray(signal, np.float32)).to(self.device)
        spec = torch.fft.rfft(x.unfold(0, self.n_fft, self.hop_length) * self._window, dim=-1)
        return fused_log_mel(spec.real.contiguous(), spec.imag.contiguous(), self._filters)

    def _normalize(self, log_mel: torch.Tensor) -> torch.Tensor:
        self._running_log_max = max(self._running_log_max, float(log_mel.max()))
        log_mel = torch.clamp(log_mel, min=self._running_log_max - 8.0)
        return (log_mel + 4.0) / 4.0

    def process(self, samples) -> torch.Tensor | None:
        samples = np.asarray(samples, np.float32)
        if samples.size == 0:
            return None
        if self._first:
            pad = self.n_fft // 2
            if samples.shape[0] > 1:
                prefix = samples[1:min(pad + 1, samples.shape[0])][::-1]
                while prefix.shape[0] < pad:
                    prefix = np.concatenate([prefix, prefix[:pad - prefix.shape[0]]])
            else:
                prefix = np.full((pad,), samples[0], np.float32)
            signal = np.concatenate([prefix, samples])
            self._first = False
        else:
            signal = np.concatenate([self._overlap, samples])
        n_frames = max(0, (signal.shape[0] - self.n_fft) // self.hop_length + 1)
        if n_frames == 0:
            self._overlap = signal
            return None
        consumed = (n_frames - 1) * self.hop_length + self.n_fft
        if consumed < signal.shape[0]:
            self._overlap = signal[consumed - self.overlap_size:]
        else:
            self._overlap = signal[-self.overlap_size:]
        log_mel = self._mel_frames(signal)[:n_frames]
        self.total_frames += n_frames
        return self._normalize(log_mel)

    def flush(self) -> torch.Tensor | None:
        if self._overlap.size == 0 or self._first:
            return None
        signal = self._overlap
        if signal.shape[0] < self.n_fft:
            signal = np.pad(signal, (0, self.n_fft - signal.shape[0]))
        self._overlap = np.zeros((0,), np.float32)
        log_mel = self._mel_frames(signal)
        self.total_frames += log_mel.shape[0]
        return self._normalize(log_mel)


# ---------------------------------------------------------------------------
# Streaming encoder
# ---------------------------------------------------------------------------


def _empty() -> torch.Tensor:
    return torch.zeros((0, 0), dtype=torch.float32)


class StreamingEncoder:
    """Window accumulator over a model's ``encode_single_window``: full
    windows encode once and are cached (at most ``max_cached_windows``);
    the pending partial window re-encodes on demand."""

    def __init__(self, encode_single_window, window_size: int = 800,
                 max_cached_windows: int = 60, overlap_frames: int = 0):
        self._encode = encode_single_window
        self.window_size = window_size
        overlap = max(0, min(overlap_frames, window_size - 1))
        self.window_stride = max(1, window_size - overlap)
        self.max_cached_windows = max_cached_windows
        self.cached: list[torch.Tensor] = []
        self._new_windows: list[torch.Tensor] = []
        self.total_encoded_windows = 0
        self._pending = _empty()

    def feed(self, mel_frames: torch.Tensor) -> int:
        """Append frames and encode every window they complete; returns the
        number of newly completed windows."""
        if self._pending.numel() == 0:
            self._pending = mel_frames
        else:
            self._pending = torch.cat([self._pending, mel_frames])
        new = 0
        while self._pending.shape[0] >= self.window_size:
            window = self._pending[:self.window_size]
            self._pending = self._pending[self.window_stride:]
            feats = self._encode(window)
            self.cached.append(feats)
            self._new_windows.append(feats)
            if len(self.cached) > self.max_cached_windows:
                self.cached.pop(0)
            self.total_encoded_windows += 1
            new += 1
        return new

    @property
    def pending_frames(self) -> int:
        return self._pending.shape[0]

    @property
    def encoded_window_count(self) -> int:
        return self.total_encoded_windows

    def drain_new_windows(self) -> list[torch.Tensor]:
        """The completed windows' features since the last drain."""
        out, self._new_windows = self._new_windows, []
        return out

    def encode_pending(self) -> torch.Tensor | None:
        """The pending partial window's features, the window kept pending."""
        if self._pending.shape[0] == 0:
            return None
        return self._encode(self._pending)

    def encoded_features(self, include_pending: bool = True) -> torch.Tensor:
        """The cached windows' features and the pending window's."""
        parts = list(self.cached)
        if include_pending and self._pending.shape[0] > 0:
            parts.append(self._encode(self._pending))
        if not parts:
            return torch.zeros((0, 1), dtype=torch.float32)
        return torch.cat(parts)

    def flush_partial(self) -> None:
        if self._pending.shape[0] > 0:
            feats = self._encode(self._pending)
            self.cached.append(feats)
            self._new_windows.append(feats)
            self.total_encoded_windows += 1
            self._pending = _empty()


# ---------------------------------------------------------------------------
# Session: config, events, shared promotion state
# ---------------------------------------------------------------------------


class DelayPreset(Enum):
    """Confirmation delay presets, in seconds."""

    REALTIME = 0.2
    AGENT = 0.48
    SUBTITLE = 2.4


@dataclass
class StreamingConfig:
    """Session configuration; ``delay_seconds`` is the provisional ->
    confirmed promotion delay."""

    decode_interval_seconds: float = 1.0
    boundary_decode_interval_seconds: float = 0.2
    boundary_boost_seconds: float = 1.0
    encoder_window_overlap_seconds: float = 1.0
    max_cached_windows: int = 60
    delay_seconds: float = DelayPreset.AGENT.value
    language: str | None = None
    temperature: float = 0.0
    max_tokens_per_pass: int = 512
    min_agreement_passes: int = 2
    boundary_min_agreement_passes: int = 3
    max_decode_windows: int = 1
    finalize_completed_windows: bool = True


class EventKind(str, Enum):
    PROVISIONAL = "provisional"
    CONFIRMED = "confirmed"
    DISPLAY_UPDATE = "display_update"
    STATS = "stats"
    ENDED = "ended"


@dataclass
class TranscriptionEvent:
    kind: EventKind
    text: str = ""
    confirmed_text: str = ""
    stats: dict = field(default_factory=dict)


@dataclass
class _SharedState:
    """Token-level promotion bookkeeping."""

    completed_text: str = ""     # frozen text of finalized windows
    confirmed_text: str = ""     # promoted text inside the current window
    confirmed_ids: list = field(default_factory=list)
    provisional_ids: list = field(default_factory=list)
    first_seen: list = field(default_factory=list)
    agreement: list = field(default_factory=list)

    def reset_window(self):
        self.confirmed_ids = []
        self.provisional_ids = []
        self.first_seen = []
        self.agreement = []
        self.confirmed_text = ""


# -- text joining ----------------------------------------------------------------


def _normalized_word(word: str) -> str:
    return "".join(c for c in word.lower() if c.isalnum() or c in "'’")


def _normalized_words(text: str) -> list[str]:
    return [w for w in (_normalized_word(t) for t in text.split()) if w]


def _dedupe_leading_word_overlap(base: str, segment: str, max_words: int = 64) -> str:
    """Drop the longest prefix of ``segment`` that repeats the tail of
    ``base`` word for word."""
    base_words = base.split()
    seg_words = segment.split()
    if not base_words or not seg_words:
        return segment
    bn = [_normalized_word(w) for w in base_words]
    sn = [_normalized_word(w) for w in seg_words]

    def eq(i, j):
        if bn[i] and sn[j]:
            return bn[i] == sn[j]
        return base_words[i].lower() == seg_words[j].lower()

    for size in range(min(max_words, len(base_words), len(seg_words)), 0, -1):
        if all(eq(len(base_words) - size + k, k) for k in range(size)):
            return " ".join(seg_words[size:])
    return segment


def _should_skip_duplicate(base: str, segment: str) -> bool:
    """True when the whole segment already ends ``base``."""
    seg = _normalized_words(segment)
    if not seg:
        return True
    bw = _normalized_words(base)
    if not bw or len(bw) < len(seg):
        return False
    tail = bw[-min(len(bw), max(len(seg) * 2, 48)):]
    return len(tail) >= len(seg) and tail[-len(seg):] == seg


def _trim_contained_overlap(base: str, segment: str) -> str:
    """For a segment of 8 words or more, drop a leading run of it that is
    already in the tail of ``base``."""
    seg_raw = segment.split()
    if len(seg_raw) < 8:
        return segment
    bw = _normalized_words(base)
    if not bw:
        return segment
    sn = [_normalized_word(w) for w in seg_raw]
    tail = bw[-min(len(bw), max(len(sn) * 4, 160)):]
    min_overlap = min(12, len(sn))
    if min_overlap < 8:
        return segment
    for overlap in range(len(sn), min_overlap - 1, -1):
        prefix = sn[:overlap]
        if any(tail[s:s + overlap] == prefix for s in range(len(tail) - overlap + 1)):
            return " ".join(seg_raw[overlap:])
    return segment


def append_text(base: str, segment: str) -> str:
    """Join streamed text segments, dropping word overlap."""
    segment = segment.strip()
    if not segment:
        return base
    if not base:
        return segment
    segment = _dedupe_leading_word_overlap(base, segment)
    segment = _trim_contained_overlap(base, segment)
    if not segment:
        return base
    if _should_skip_duplicate(base, segment):
        return base
    if base.endswith(tuple(" \n\t")) or segment[:1].isspace():
        return base + segment
    return base + " " + segment


def concat_text(a: str, b: str) -> str:
    return append_text(a, b)


def _promote_tokens(state: _SharedState, all_ids: list[int], now: float,
                    delay_seconds: float, min_agreement: int, decode_text,
                    events: list) -> None:
    """Prefix-agreement promotion: the prefix that the new provisional
    tokens share with the last pass's accrues agreement; tokens are
    confirmed once they have ``min_agreement`` identical passes and
    ``delay_seconds`` of age, in order."""
    new_prov = list(all_ids[min(len(state.confirmed_ids), len(all_ids)):])
    match_len = 0
    for i in range(min(len(state.provisional_ids), len(new_prov))):
        if state.provisional_ids[i] != new_prov[i]:
            break
        match_len = i + 1
    first_seen, agreement = [], []
    for i in range(len(new_prov)):
        if i < match_len:
            first_seen.append(state.first_seen[i] if i < len(state.first_seen) else now)
            prev = state.agreement[i] if i < len(state.agreement) else 1
            agreement.append(max(1, prev + 1))
        else:
            first_seen.append(now)
            agreement.append(1)
    promote = 0
    for i in range(len(new_prov)):
        if now - first_seen[i] >= delay_seconds and agreement[i] >= min_agreement:
            promote = i + 1
        else:
            break
    if promote > 0:
        state.confirmed_ids.extend(new_prov[:promote])
        state.confirmed_text = decode_text(state.confirmed_ids)
        confirmed = concat_text(state.completed_text, state.confirmed_text)
        events.append(TranscriptionEvent(EventKind.CONFIRMED, text=confirmed,
                                         confirmed_text=confirmed))
    state.provisional_ids = new_prov[promote:]
    state.first_seen = first_seen[promote:]
    state.agreement = agreement[promote:]
    events.append(TranscriptionEvent(
        EventKind.DISPLAY_UPDATE, text=decode_text(state.provisional_ids),
        confirmed_text=concat_text(state.completed_text, state.confirmed_text)))


# ---------------------------------------------------------------------------
# The Qwen3-ASR core
# ---------------------------------------------------------------------------


class _QwenStreamingCore:
    """Qwen3-ASR core: incremental mel -> window encoder; partial decodes
    over the pending window with token promotion, paced by the clock with a
    boundary boost after each completed window; completed windows
    finalized by a one-shot decode appended to the completed text."""

    def __init__(self, model, config: StreamingConfig, clock=time.monotonic):
        self.model = model
        self.config = config
        self.clock = clock
        sr = 16000
        self.mel = IncrementalMelSpectrogram(sr, n_mels=model.config.audio.num_mel_bins,
                                             device=model.device)
        self.encoder = StreamingEncoder(
            model.encode_single_window, window_size=model.config.audio.n_window_infer,
            max_cached_windows=config.max_cached_windows,
            overlap_frames=max(0, round(config.encoder_window_overlap_seconds * sr / 160.0)))
        self.state = _SharedState()
        self.sample_rate = sr
        self._total_samples = 0
        self._wall_start = clock()
        self._last_decode: float | None = None
        self._boost_until: float | None = None
        self._has_new_content = False
        self._decode_time = 0.0
        self._passes = 0
        self._tokens = 0

    def _decode_ids(self, feats: torch.Tensor, confirmed: list[int]) -> list[int]:
        ids, _n_prompt = self.model.decode_features_tokens(
            feats, STTGenerateParameters(language=self.config.language,
                                         max_tokens=self.config.max_tokens_per_pass,
                                         temperature=self.config.temperature),
            forced_tokens=confirmed)
        return ids

    def _decode_text(self, ids: list[int]) -> str:
        if not ids:
            return ""
        decoded = self.model.tokenizer.decode([int(t) for t in ids], skip_special_tokens=True)
        return self.model._parse_output(decoded, self.config.language)[1]

    def feed_audio(self, samples) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        samples = np.asarray(samples, np.float32)
        self._total_samples += len(samples)
        frames = self.mel.process(samples)
        if frames is None:
            return events
        new_windows = self.encoder.feed(frames)
        if new_windows > 0 or self.encoder.pending_frames > 0:
            self._has_new_content = True
        now = self.clock()
        cfg = self.config
        if new_windows > 0 and cfg.boundary_boost_seconds > 0:
            self._boost_until = now + cfg.boundary_boost_seconds
        # a faster cadence for a while after a window boundary
        if self._boost_until is not None and now < self._boost_until:
            interval = min(max(0.05, cfg.boundary_decode_interval_seconds),
                           max(0.05, cfg.decode_interval_seconds))
        else:
            self._boost_until = None
            interval = max(0.05, cfg.decode_interval_seconds)
        if cfg.finalize_completed_windows and new_windows > 0:
            should = True
        elif self._last_decode is not None:
            should = now - self._last_decode >= interval
        else:
            should = self._has_new_content
        if should and self._has_new_content:
            self._has_new_content = False
            if not (cfg.finalize_completed_windows and new_windows > 0):
                self._last_decode = now
            events.extend(self._decode_pass_locked())
        return events

    def _decode_pass_locked(self) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        if self.config.finalize_completed_windows:
            new_windows = self.encoder.drain_new_windows()
            if new_windows:
                self._finalize_windows(new_windows, events)
                return events
        else:
            self._freeze_completed_windows()
        feats = self.encoder.encode_pending()
        if feats is None or feats.shape[0] == 0:
            return events
        now = self.clock()
        min_agreement = max(1, self.config.min_agreement_passes)
        if self._boost_until is not None and now < self._boost_until:
            min_agreement = max(min_agreement, self.config.boundary_min_agreement_passes)
        t0 = time.perf_counter()
        ids = self._decode_ids(feats, self.state.confirmed_ids)
        self._decode_time += time.perf_counter() - t0
        self._passes += 1
        self._tokens += max(0, len(ids) - len(self.state.confirmed_ids))
        _promote_tokens(self.state, ids, now, self.config.delay_seconds, min_agreement,
                        self._decode_text, events)
        events.append(self._stats_event())
        return events

    def _finalize_windows(self, windows: list[torch.Tensor], events: list):
        """A one-shot decode per completed window, appended to the completed
        text; the first window reuses the streamed tokens when there are
        any."""
        streamed = self.state.confirmed_ids + self.state.provisional_ids
        for idx, feats in enumerate(windows):
            if idx == 0 and streamed:
                text = self._decode_text(streamed)
            else:
                if feats.shape[0] == 0:
                    continue
                t0 = time.perf_counter()
                ids = self._decode_ids(feats, [])
                self._decode_time += time.perf_counter() - t0
                self._passes += 1
                self._tokens += len(ids)
                text = self._decode_text(ids)
            if text.strip():
                self.state.completed_text = append_text(self.state.completed_text, text)
            self.state.reset_window()
        events.append(TranscriptionEvent(EventKind.DISPLAY_UPDATE, text="",
                                         confirmed_text=self.state.completed_text))
        events.append(self._stats_event())

    def _freeze_completed_windows(self):
        """Without finalizing: freeze the streamed text at a window boundary
        without decoding again."""
        if not self.encoder.drain_new_windows():
            return
        all_ids = self.state.confirmed_ids + self.state.provisional_ids
        if all_ids:
            self.state.completed_text = append_text(self.state.completed_text,
                                                    self._decode_text(all_ids))
        self.state.reset_window()

    def _stats_event(self) -> TranscriptionEvent:
        audio_s = self._total_samples / self.sample_rate
        wall = self.clock() - self._wall_start
        return TranscriptionEvent(EventKind.STATS, stats={
            "encoded_window_count": self.encoder.encoded_window_count,
            "audio_seconds": audio_s,
            "wall_seconds": wall,
            "real_time_factor": (wall / audio_s) if audio_s else 0.0,
            "tokens_per_second": (self._tokens / self._decode_time
                                  if self._decode_time else 0.0),
            "decode_passes": self._passes,
            "decode_time": self._decode_time,
        })

    def stop(self) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        tail = self.mel.flush()
        if tail is not None:
            self.encoder.feed(tail)
        self.encoder.flush_partial()
        new_windows = self.encoder.drain_new_windows()
        if new_windows:
            self._finalize_windows(new_windows, events)
        final = concat_text(self.state.completed_text, self.state.confirmed_text)
        final = concat_text(final, self._decode_text(self.state.provisional_ids))
        events.append(self._stats_event())
        events.append(TranscriptionEvent(EventKind.ENDED, text=final, confirmed_text=final))
        return events


# ---------------------------------------------------------------------------
# The Cohere core
# ---------------------------------------------------------------------------


class _CohereStreamingCore:
    """Cohere Transcribe core: raw audio in 8 s windows that overlap by
    ``encoder_window_overlap_seconds``; partial passes re-decode the pending
    audio with the confirmed tokens forced (``streaming_decode_token_ids``)
    and promote tokens as the Qwen3-ASR core does; a completed window is
    finalized by a decode of its own appended to the completed text."""

    WINDOW_SECONDS = 8.0

    def __init__(self, model, config: StreamingConfig, clock=time.monotonic):
        self.model = model
        self.config = config
        self.clock = clock
        self.sample_rate = model.config.sample_rate
        self.window_samples = int(self.sample_rate * self.WINDOW_SECONDS)
        self.overlap_samples = max(0, min(
            round(config.encoder_window_overlap_seconds * self.sample_rate),
            self.window_samples - 1))
        self.state = _SharedState()
        self._pending = np.zeros((0,), np.float32)
        self._total_samples = 0
        self._finalized_windows = 0
        self._wall_start = clock()
        self._last_decode: float | None = None
        self._decode_time = 0.0
        self._passes = 0
        self._tokens = 0

    def _decode_text(self, ids: list[int]) -> str:
        return self.model.streaming_decode_text(ids)

    def feed_audio(self, samples) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        samples = np.asarray(samples, np.float32)
        self._pending = np.concatenate([self._pending, samples])
        self._total_samples += len(samples)
        now = self.clock()
        if len(self._pending) >= self.window_samples:
            window = self._pending[:self.window_samples]
            self._pending = self._pending[max(0, self.window_samples - self.overlap_samples):]
            self._finalized_windows += 1
            self._last_decode = now
            self._finalize_window(window, events)
            return events
        if len(self._pending) < self.sample_rate // 2:
            return events
        if (self._last_decode is not None and now - self._last_decode
                < max(0.2, self.config.decode_interval_seconds)):
            return events
        self._last_decode = now
        t0 = time.perf_counter()
        ids, _ = self.model.streaming_decode_token_ids(self._pending, self.config,
                                                       self.state.confirmed_ids)
        self._decode_time += time.perf_counter() - t0
        self._passes += 1
        self._tokens += max(0, len(ids) - len(self.state.confirmed_ids))
        _promote_tokens(self.state, ids, now, self.config.delay_seconds,
                        max(1, self.config.min_agreement_passes), self._decode_text, events)
        events.append(self._stats_event())
        return events

    def _finalize_window(self, window: np.ndarray, events: list):
        t0 = time.perf_counter()
        ids, _ = self.model.streaming_decode_token_ids(window, self.config, [])
        self._decode_time += time.perf_counter() - t0
        self._passes += 1
        self._tokens += len(ids)
        self.state.completed_text = concat_text(self.state.completed_text,
                                                self._decode_text(ids))
        self.state.reset_window()
        events.append(TranscriptionEvent(EventKind.DISPLAY_UPDATE, text="",
                                         confirmed_text=self.state.completed_text))
        events.append(self._stats_event())

    def _stats_event(self) -> TranscriptionEvent:
        audio_s = self._total_samples / self.sample_rate
        wall = self.clock() - self._wall_start
        return TranscriptionEvent(EventKind.STATS, stats={
            "encoded_window_count": max(self._finalized_windows,
                                        int(np.ceil(audio_s / self.WINDOW_SECONDS))),
            "audio_seconds": audio_s,
            "wall_seconds": wall,
            "real_time_factor": (wall / audio_s) if audio_s else 0.0,
            "tokens_per_second": (self._tokens / self._decode_time
                                  if self._decode_time else 0.0),
            "decode_passes": self._passes,
            "decode_time": self._decode_time,
        })

    def stop(self) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        if len(self._pending) > 0:
            self._finalized_windows += 1
            self._finalize_window(self._pending, events)
            self._pending = np.zeros((0,), np.float32)
        if self.state.provisional_ids:
            self.state.confirmed_ids.extend(self.state.provisional_ids)
            self.state.provisional_ids = []
        self.state.confirmed_text = self._decode_text(self.state.confirmed_ids)
        final = concat_text(self.state.completed_text, self.state.confirmed_text)
        events.append(self._stats_event())
        events.append(TranscriptionEvent(EventKind.ENDED, text=final, confirmed_text=final))
        return events


# ---------------------------------------------------------------------------
# The MOSS core
# ---------------------------------------------------------------------------


class _MossStreamingCore:
    """MOSS-Transcribe-Diarize core: text-level, with no token promotion.
    Windows of ``clamp(max_decode_windows * 4, 3, 6)`` s are consumed and
    finalized by a pass of their own (no token cap) whose text is appended
    with ``"\\n"``; between them a partial pass over the last 1.25-2.5 s of
    pending audio runs at most once per ``max(1, decode_interval_seconds)``,
    capped at ``min(max_tokens_per_pass, max(48, ceil(16 * seconds)))``
    tokens. Timestamps are shifted by each pass's offset in the stream."""

    def __init__(self, model, config: StreamingConfig, clock=time.monotonic):
        self.model = model
        self.config = config
        self.clock = clock
        self.sample_rate = model.sample_rate
        window_seconds = max(3.0, min(6.0, max(1, config.max_decode_windows) * 4.0))
        self.window_samples = max(self.sample_rate, round(window_seconds * self.sample_rate))
        self.min_partial_samples = max(self.sample_rate, round(1.25 * self.sample_rate))
        self.partial_samples = max(self.min_partial_samples,
                                   round(min(window_seconds, 2.5) * self.sample_rate))
        self.completed_text = ""
        self.provisional_text = ""
        self._pending = np.zeros((0,), np.float32)
        self._pending_start = 0
        self._total_samples = 0
        self._finalized_windows = 0
        self._wall_start = clock()
        self._last_decode: float | None = None
        self._decode_time = 0.0
        self._passes = 0

    def _display(self, events: list):
        confirmed = self.completed_text
        if confirmed and self.provisional_text and not self.provisional_text.startswith("\n"):
            confirmed = confirmed + "\n"
        events.append(TranscriptionEvent(EventKind.DISPLAY_UPDATE, text=self.provisional_text,
                                         confirmed_text=confirmed))

    def _window_pass(self, samples: np.ndarray, offset: float, final: bool, events: list):
        seconds = len(samples) / self.sample_rate
        max_tokens = None if final else min(self.config.max_tokens_per_pass,
                                            max(48, int(np.ceil(seconds * 16.0))))
        t0 = time.perf_counter()
        text = self.model.streaming_transcribe_window(
            samples, offset_seconds=offset, language=self.config.language,
            max_tokens=max_tokens)
        self._decode_time += time.perf_counter() - t0
        self._passes += 1
        text = text.strip()
        if final:
            if text:
                self.completed_text = (text if not self.completed_text
                                       else self.completed_text + "\n" + text)
            self.provisional_text = ""
        else:
            self.provisional_text = text
        self._display(events)
        events.append(self._stats_event(seconds))

    def feed_audio(self, samples) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        samples = np.asarray(samples, np.float32)
        self._pending = np.concatenate([self._pending, samples])
        self._total_samples += len(samples)
        now = self.clock()
        if len(self._pending) >= self.window_samples:
            window = self._pending[:self.window_samples]
            offset = self._pending_start / self.sample_rate
            self._pending = self._pending[self.window_samples:]
            self._pending_start += self.window_samples
            self._finalized_windows += 1
            self._last_decode = now
            self._window_pass(window, offset, final=True, events=events)
            return events
        if len(self._pending) < self.min_partial_samples:
            return events
        if (self._last_decode is not None and now - self._last_decode
                < max(1.0, self.config.decode_interval_seconds)):
            return events
        self._last_decode = now
        count = min(len(self._pending), self.partial_samples)
        start = len(self._pending) - count
        offset = (self._pending_start + start) / self.sample_rate
        self._window_pass(self._pending[start:], offset, final=False, events=events)
        return events

    def _stats_event(self, window_seconds: float) -> TranscriptionEvent:
        audio_s = self._total_samples / self.sample_rate
        wall = self.clock() - self._wall_start
        return TranscriptionEvent(EventKind.STATS, stats={
            "encoded_window_count": max(self._finalized_windows,
                                        int(np.ceil(audio_s / max(window_seconds, 1e-3)))),
            "audio_seconds": audio_s,
            "wall_seconds": wall,
            "real_time_factor": (wall / audio_s) if audio_s else 0.0,
            "decode_passes": self._passes,
            "decode_time": self._decode_time,
        })

    def stop(self) -> list[TranscriptionEvent]:
        events: list[TranscriptionEvent] = []
        if len(self._pending) > 0:
            offset = self._pending_start / self.sample_rate
            self._finalized_windows += 1
            self._window_pass(self._pending, offset, final=True, events=events)
            self._pending = np.zeros((0,), np.float32)
        final = self.completed_text or self.provisional_text
        events.append(TranscriptionEvent(EventKind.ENDED, text=final, confirmed_text=final))
        return events


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


class StreamingInferenceSession:
    """The streaming session over a model's core: Qwen3-ASR's, Cohere
    Transcribe's or MOSS-Transcribe-Diarize's.

    ``feed_audio(samples)`` / ``stop()`` return the events each call made
    (decode passes run inline, paced by ``clock``); ``stream()`` wraps the
    session as an async generator."""

    def __init__(self, model, config: StreamingConfig | None = None,
                 delay_preset: DelayPreset | float | None = None,
                 min_agreement_passes: int | None = None, language: str | None = None,
                 clock=time.monotonic, **legacy):
        config = config or StreamingConfig()
        if delay_preset is not None:
            config.delay_seconds = (delay_preset.value if isinstance(delay_preset, DelayPreset)
                                    else float(delay_preset))
        if min_agreement_passes is not None:
            config.min_agreement_passes = min_agreement_passes
        if language is not None:
            config.language = language
        if "max_tokens_per_pass" in legacy:
            config.max_tokens_per_pass = legacy["max_tokens_per_pass"]
        self.config = config
        self.core = self._select_core(model, config, clock)

    @staticmethod
    def _select_core(model, config, clock):
        if hasattr(model, "encode_single_window"):
            return _QwenStreamingCore(model, config, clock)
        if hasattr(model, "streaming_decode_token_ids"):
            return _CohereStreamingCore(model, config, clock)
        if hasattr(model, "streaming_transcribe_window"):
            return _MossStreamingCore(model, config, clock)
        raise TypeError(
            "StreamingInferenceSession requires a Qwen3ASR, CohereTranscribe,"
            f" or MossTranscribeDiarize model; got {type(model).__name__}")

    def feed_audio(self, samples) -> list[TranscriptionEvent]:
        return self.core.feed_audio(samples)

    def stop(self) -> list[TranscriptionEvent]:
        return self.core.stop()

    async def stream(self, chunks):
        """Events as they come over an (async or sync) iterable of sample
        chunks, ending with the stats and ended events."""
        import asyncio
        import inspect

        if inspect.isasyncgen(chunks) or hasattr(chunks, "__aiter__"):
            async for chunk in chunks:
                for ev in self.feed_audio(chunk):
                    yield ev
        else:
            for chunk in chunks:
                for ev in self.feed_audio(chunk):
                    yield ev
                await asyncio.sleep(0)
        for ev in self.stop():
            yield ev
