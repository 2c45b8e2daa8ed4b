"""Generation event, parameter and result types (port of
tpu_audio.core.generation: the TTS events and parameters, ``samples_stream``,
``pcm_stream``, and the STT parameters and results)."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterator

import numpy as np

__all__ = ["AudioGenerateParameters", "AudioGeneration", "AudioGenerationError",
           "AudioGenerationInfo", "AudioGenerationKind", "STTGenerateParameters",
           "STTOutput", "STTSegment", "pcm_stream", "samples_stream", "validate_kv_bits"]


class AudioGenerationError(RuntimeError):
    pass


@dataclass
class AudioGenerationInfo:
    """Perf stats emitted with generation results."""

    prompt_token_count: int = 0
    generation_token_count: int = 0
    prompt_time: float = 0.0
    generate_time: float = 0.0
    audio_duration: float = 0.0
    peak_memory_bytes: int = 0

    @property
    def prompt_tokens_per_second(self) -> float:
        return self.prompt_token_count / self.prompt_time if self.prompt_time else 0.0

    @property
    def tokens_per_second(self) -> float:
        return (self.generation_token_count / self.generate_time
                if self.generate_time else 0.0)

    @property
    def real_time_factor(self) -> float:
        """generation wall time / audio duration (< 1 is faster than RT)."""
        total = self.prompt_time + self.generate_time
        return total / self.audio_duration if self.audio_duration else 0.0


class AudioGenerationKind(str, Enum):
    TOKEN = "token"
    INFO = "info"
    AUDIO = "audio"
    PROGRESS = "progress"


@dataclass
class AudioGeneration:
    """Streaming event: ``.token(int)``, ``.info(AudioGenerationInfo)``,
    ``.audio(np.ndarray)``, ``.progress(float)``."""

    kind: AudioGenerationKind
    token: int | None = None
    info: AudioGenerationInfo | None = None
    audio: np.ndarray | None = None
    progress: float | None = None

    @classmethod
    def from_token(cls, t: int) -> "AudioGeneration":
        return cls(AudioGenerationKind.TOKEN, token=t)

    @classmethod
    def from_info(cls, i: AudioGenerationInfo) -> "AudioGeneration":
        return cls(AudioGenerationKind.INFO, info=i)

    @classmethod
    def from_audio(cls, a: np.ndarray) -> "AudioGeneration":
        return cls(AudioGenerationKind.AUDIO, audio=a)

    @classmethod
    def from_progress(cls, p: float) -> "AudioGeneration":
        return cls(AudioGenerationKind.PROGRESS, progress=p)


def samples_stream(model, text: str, **kwargs) -> Iterator[np.ndarray]:
    """Yield the raw float32 sample chunks of ``model.generate_stream``:
    its audio events only, tokens and info dropped."""
    for event in model.generate_stream(text, **kwargs):
        if event.kind == AudioGenerationKind.AUDIO and event.audio is not None:
            yield np.asarray(event.audio, np.float32)


def pcm_stream(model, text: str, out_rate: int | None = None,
               dtype=np.int16, **kwargs) -> Iterator[np.ndarray]:
    """Yield playback-ready PCM chunks: the model's audio resampled to
    ``out_rate`` through a stateful
    :class:`~tpu_audio_torch.core.audio_stream.PCMStreamConverter` and
    quantized to ``dtype`` (int16 by default; ``np.float32`` skips the
    quantization)."""
    from tpu_audio_torch.core.audio_io import float_to_pcm16
    from tpu_audio_torch.core.audio_stream import PCMStreamConverter

    sr = int(getattr(model, "sample_rate", 24000))
    out_rate = int(out_rate or sr)
    conv = PCMStreamConverter(out_rate=out_rate) if out_rate != sr else None

    def emit(x: np.ndarray) -> np.ndarray | None:
        if x.size == 0:
            return None
        return float_to_pcm16(x) if dtype == np.int16 else x.astype(dtype)

    for chunk in samples_stream(model, text, **kwargs):
        out = conv.push(chunk, sr) if conv is not None else chunk
        pcm = emit(np.asarray(out, np.float32))
        if pcm is not None:
            yield pcm
    if conv is not None:
        pcm = emit(conv.finish())
        if pcm is not None:
            yield pcm


@dataclass
class AudioGenerateParameters:
    """TTS generation parameters."""

    max_tokens: int = 1200
    temperature: float = 0.6
    top_p: float = 0.8
    top_k: int = 0
    repetition_penalty: float = 1.3
    repetition_context_size: int = 64
    seed: int | None = None
    streaming_interval: float = 0.5  # seconds of audio per streamed chunk
    verbose: bool = False
    extra: dict[str, Any] = field(default_factory=dict)


def validate_kv_bits(kv_bits) -> None:
    """Raise on unsupported kv quantization widths instead of silently
    falling through to the dense path."""
    if kv_bits not in (None, 4, 8):
        raise ValueError(
            f"kv_bits={kv_bits!r} is not supported: use 8 (int8 symmetric), "
            "4 (packed affine int4), or None (dense)")


@dataclass
class STTGenerateParameters:
    """STT generation parameters, including the KV-cache quantization
    knobs: ``kv_bits`` 8 = int8 symmetric, 4 = packed affine int4;
    ``quantized_kv_start`` keeps self-cache positions below it full
    precision. ``batch_windows`` decodes the 30 s windows of a long file
    as one batch."""

    language: str | None = None
    task: str = "transcribe"
    max_tokens: int = 448
    temperature: float = 0.0
    chunk_duration: float | None = None
    kv_bits: int | None = None
    kv_group_size: int = 64
    quantized_kv_start: int = 0
    beam_size: int | None = None
    batch_windows: bool = True
    verbose: bool = False
    extra: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        validate_kv_bits(self.kv_bits)


@dataclass
class STTSegment:
    text: str
    start: float
    end: float
    tokens: list[int] = field(default_factory=list)
    speaker: str | None = None


@dataclass
class STTOutput:
    """Transcription result + perf info."""

    text: str
    segments: list[STTSegment] = field(default_factory=list)
    language: str | None = None
    prompt_token_count: int = 0
    generation_token_count: int = 0
    prompt_time: float = 0.0
    generation_time: float = 0.0
    total_time: float = 0.0
    peak_memory_bytes: int = 0

    @property
    def prompt_tps(self) -> float:
        return self.prompt_token_count / self.prompt_time if self.prompt_time else 0.0

    @property
    def generation_tps(self) -> float:
        return (
            self.generation_token_count / self.generation_time
            if self.generation_time
            else 0.0
        )
