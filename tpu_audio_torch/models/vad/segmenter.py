"""Model-agnostic VAD speech segmentation: chunk an audio buffer into speech
regions for downstream transcription.

The port's copy of tpu_audio.models.vad.segmenter (host NumPy): ~256 ms
decision blocks from a VAD model's chunk probabilities (noisy-OR pooling of
8 Silero chunks), pad/min-duration hysteresis, gap merging and max-chunk
splitting. ``vad_model`` is anything with ``predict_proba(audio,
sample_rate)``, such as the port's :class:`~tpu_audio_torch.models.vad.silero.SileroVAD`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["SpeechSegmentConfig", "segment_speech", "detect_speech_runs"]

BLOCKS_PER_256MS = 8


@dataclass
class SpeechSegmentConfig:
    threshold: float = 0.5
    min_speech_ms: int = 250
    min_silence_ms: int = 100
    speech_pad_ms: int = 30
    merge_gap_s: float = 1.0
    max_chunk_s: float = 30.0


def detect_speech_runs(audio: np.ndarray, sample_rate: int, vad_model,
                       config: SpeechSegmentConfig) -> list[tuple[int, int]]:
    """Raw (start, end) sample runs (SpeechSegmenter.swift:38-115)."""
    chunk = 512 if sample_rate == 16000 else 256
    block = chunk * BLOCKS_PER_256MS
    block_dur = block / sample_rate

    probs32 = np.asarray(vad_model.predict_proba(audio, sample_rate))
    n = (len(probs32) // BLOCKS_PER_256MS) * BLOCKS_PER_256MS
    if n == 0:
        return []
    # noisy-OR pooling into 256 ms blocks
    grouped = probs32[:n].reshape(-1, BLOCKS_PER_256MS)
    probs256 = 1.0 - np.prod(1.0 - grouped, axis=1)

    pad_blocks = max(0, int(config.speech_pad_ms / 1000 / block_dur))
    min_speech = max(1, math.ceil(config.min_speech_ms / 1000 / block_dur))
    min_silence = max(1, math.ceil(config.min_silence_ms / 1000 / block_dur))

    audio_len = np.asarray(audio).shape[-1]
    runs: list[tuple[int, int]] = []
    in_speech = False
    seg_start, last_speech, silent = 0, -1, 0
    for i, p in enumerate(probs256):
        if p >= config.threshold:
            if not in_speech:
                seg_start = max(0, i - pad_blocks)
                in_speech = True
            last_speech, silent = i, 0
        elif in_speech:
            silent += 1
            if silent >= min_silence:
                seg_end = min(last_speech + 1 + pad_blocks, len(probs256))
                if seg_end - seg_start >= min_speech:
                    s, e = seg_start * block, min(seg_end * block, audio_len)
                    if s < e:
                        runs.append((s, e))
                in_speech, silent, last_speech = False, 0, -1
    if in_speech:
        end_i = min(len(probs256), last_speech + 1 + pad_blocks)
        if end_i - seg_start >= min_speech:
            s, e = seg_start * block, min(end_i * block, audio_len)
            if s < e:
                runs.append((s, e))
    return runs


def _split_long(start: int, end: int, max_samples: int) -> list[tuple[int, int]]:
    out = []
    cur = start
    while cur < end:
        nxt = min(cur + max_samples, end)
        out.append((cur, nxt))
        cur = nxt
    return out


def _merge_runs(runs, sample_rate: int, merge_gap_s: float, max_chunk_s: float):
    if not runs:
        return runs
    max_samples = max(1, int(max_chunk_s * sample_rate))
    max_gap = int(merge_gap_s * sample_rate)
    merged = _split_long(runs[0][0], runs[0][1], max_samples)
    for s, e in runs[1:]:
        ps, pe = merged[-1]
        if s - pe <= max_gap and e - ps <= max_samples:
            merged[-1] = (ps, e)
        else:
            merged += _split_long(s, e, max_samples)
    return merged


def segment_speech(audio: np.ndarray, sample_rate: int, vad_model,
                   config: SpeechSegmentConfig | None = None
                   ) -> list[tuple[np.ndarray, float]]:
    """Split audio into (segment, offset_seconds) pairs; the whole buffer is
    returned as one segment when no speech is found
    (SpeechSegmenter.swift:162-183)."""
    config = config or SpeechSegmentConfig()
    audio = np.asarray(audio, np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=-1)
    raw = detect_speech_runs(audio, sample_rate, vad_model, config)
    runs = _merge_runs(raw, sample_rate, config.merge_gap_s, config.max_chunk_s)
    if not runs:
        return [(audio, 0.0)]
    return [(audio[s:e], s / sample_rate) for s, e in runs]
