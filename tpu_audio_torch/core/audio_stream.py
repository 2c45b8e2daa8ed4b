"""Streaming audio plumbing (port of tpu_audio.core.audio_stream): an
incremental PCM format converter and a headless chunk-scheduling player.

* :class:`PCMStreamConverter`: input-format to model-format conversion
  with a push/finish streaming API. A stateful Hann-windowed-sinc
  polyphase resampler (torchaudio's kernel) carries its filter context
  across pushes, with int16/int32 to float32 and a channel downmix; a
  change of input rate mid-stream flushes the old state and restarts.
  The frames of each drain are gathered and multiplied by the polyphase
  kernel in NumPy.
* :class:`AudioPlayer`: the streaming half of a player without a device:
  chunks get a 10 ms fade-in on the first chunk and a 20 ms one on later
  chunk boundaries, go to a pluggable sink (a callable, e.g.
  ``StreamingWAVWriter.append``), with speaking-state callbacks and
  time/duration accounting.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["PCMStreamConverter", "AudioPlayer"]


class PCMStreamConverter:
    """Incremental sample-format + sample-rate converter.

    >>> conv = PCMStreamConverter(out_rate=16000)
    >>> out = conv.push(chunk_int16, in_rate=48000)
    >>> tail = conv.finish()
    """

    def __init__(self, out_rate: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99):
        self.out_rate = int(out_rate)
        self.lowpass_filter_width = lowpass_filter_width
        self.rolloff = rolloff
        self._in_rate: int | None = None
        self._reset_state()

    def _reset_state(self):
        self._buf = np.zeros(0, np.float32)
        self._buf_offset = 0  # absolute input index of _buf[0] (incl. pad)
        self._n_in = 0  # total input samples accepted
        self._m = 0  # polyphase frame groups emitted so far
        self._emitted = 0  # output samples emitted so far
        self._kernel = None
        self._width = 0
        self._orig_r = self._new_r = 1

    def _build_kernel(self, in_rate: int):
        g = math.gcd(in_rate, self.out_rate)
        orig_r, new_r = in_rate // g, self.out_rate // g
        base = min(orig_r, new_r) * self.rolloff
        width = int(np.ceil(self.lowpass_filter_width * orig_r / base))
        k_taps = 2 * width + orig_r
        idx = (np.arange(k_taps) - width) / orig_r
        phase = np.arange(new_r)[:, None] / new_r
        t = np.clip((-phase + idx[None]) * base,
                    -self.lowpass_filter_width, self.lowpass_filter_width)
        window = np.cos(t * np.pi / self.lowpass_filter_width / 2) ** 2
        t_pi = t * np.pi
        sinc = np.where(t_pi == 0, 1.0,
                        np.sin(t_pi) / np.where(t_pi == 0, 1.0, t_pi))
        self._kernel = (sinc * window * (base / orig_r)).astype(np.float32)
        self._width = width
        self._orig_r, self._new_r = orig_r, new_r
        # left filter context starts as zeros
        self._buf = np.zeros(width, np.float32)

    @staticmethod
    def _to_float_mono(samples) -> np.ndarray:
        x = np.asarray(samples)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        elif x.dtype == np.int32:
            x = x.astype(np.float32) / 2147483648.0
        else:
            x = x.astype(np.float32)
        if x.ndim == 2:  # [T, C] -> mono
            x = x.mean(axis=1)
        return x

    def _drain(self, final: bool = False) -> np.ndarray:
        """Emit every output sample whose kernel support is complete.
        Frame group ``m`` starts at absolute input index ``m * orig_r``
        and yields ``new_r`` output samples."""
        k_taps = self._kernel.shape[1]
        buf = self._buf
        if final:
            buf = np.concatenate(
                [buf, np.zeros(self._width + self._orig_r, np.float32)])
            total_out = int(np.ceil(self._n_in * self._new_r / self._orig_r))
            m_max = -(-total_out // self._new_r)
        else:
            m_max = None
        ms = []
        m = self._m
        while (m_max is None or m < m_max) \
                and m * self._orig_r - self._buf_offset + k_taps <= len(buf):
            ms.append(m)
            m += 1
        if not ms:
            return np.zeros(0, np.float32)
        starts = np.asarray(ms) * self._orig_r - self._buf_offset
        frames = buf[starts[:, None] + np.arange(k_taps)[None]]
        out = (frames @ self._kernel.T).reshape(-1)
        self._m = m
        if final:
            out = out[:max(0, total_out - self._emitted)]
        else:
            # discard fully-consumed input (next frame still needs its
            # left context, which starts at the next frame start)
            drop = m * self._orig_r - self._buf_offset
            if drop > 0:
                self._buf = self._buf[drop:]
                self._buf_offset += drop
        self._emitted += len(out)
        return np.asarray(out, np.float32)

    def push(self, samples, in_rate: int) -> np.ndarray:
        """Accept a chunk at ``in_rate``; returns converted samples ready
        so far. Changing ``in_rate`` mid-stream flushes and restarts."""
        x = self._to_float_mono(samples)
        flushed = np.zeros(0, np.float32)
        if self._in_rate is not None and in_rate != self._in_rate:
            flushed = self.finish()
        if self._in_rate is None or in_rate != self._in_rate:
            self._reset_state()
            self._in_rate = int(in_rate)
            if in_rate != self.out_rate:
                self._build_kernel(in_rate)
        if len(x) == 0:
            return flushed
        if self._in_rate == self.out_rate:
            return np.concatenate([flushed, x]) if len(flushed) else x
        self._buf = np.concatenate([self._buf, x])
        self._n_in += len(x)
        out = self._drain()
        return np.concatenate([flushed, out]) if len(flushed) else out

    def finish(self) -> np.ndarray:
        """Flush remaining samples (zero-padded kernel tail)."""
        if self._in_rate is None or self._in_rate == self.out_rate \
                or self._kernel is None:
            self._in_rate = None
            self._reset_state()
            return np.zeros(0, np.float32)
        out = self._drain(final=True)
        self._in_rate = None
        self._reset_state()
        return out


class AudioPlayer:
    """Headless streaming chunk scheduler. ``sink`` is a callable
    receiving float32 chunks (e.g. ``StreamingWAVWriter.append``)."""

    FIRST_FADE_S = 0.01
    CROSSFADE_S = 0.02

    def __init__(self, sample_rate: int, sink=None):
        self.sample_rate = int(sample_rate)
        self.sink = sink
        self.scheduled_frames = 0
        self.is_streaming = False
        self.is_speaking = False
        self.stream_finished = False
        self.on_speaking_state_changed = None
        self.on_did_finish_streaming = None

    @property
    def duration(self) -> float:
        return self.scheduled_frames / self.sample_rate

    current_time = duration  # headless: time tracks scheduled audio

    def _set_speaking(self, value: bool):
        if value != self.is_speaking:
            self.is_speaking = value
            if self.on_speaking_state_changed:
                self.on_speaking_state_changed(value)

    def start_streaming(self):
        self.is_streaming = True
        self.stream_finished = False
        self.scheduled_frames = 0

    def schedule_audio_chunk(self, samples, with_crossfade: bool = True
                             ) -> np.ndarray:
        """Fade-in the chunk head (10 ms first / 20 ms later chunks),
        deliver to the sink, and return the processed chunk."""
        if not self.is_streaming:
            self.start_streaming()
        x = np.array(samples, np.float32, copy=True).reshape(-1)
        if self.scheduled_frames == 0:
            n = min(int(self.sample_rate * self.FIRST_FADE_S), len(x))
            if n > 0:
                x[:n] *= np.arange(n, dtype=np.float32) / n
        elif with_crossfade:
            n = min(int(self.sample_rate * self.CROSSFADE_S), len(x))
            if n > 0:
                x[:n] *= np.arange(n, dtype=np.float32) / n
        self.scheduled_frames += len(x)
        self._set_speaking(True)
        if self.sink is not None:
            self.sink(x)
        return x

    def finish_streaming(self):
        """Mark the source complete."""
        self.stream_finished = True
        self._set_speaking(False)
        if self.on_did_finish_streaming:
            self.on_did_finish_streaming()

    def stop(self):
        self.is_streaming = False
        self.stream_finished = False
        self.scheduled_frames = 0
        self._set_speaking(False)
