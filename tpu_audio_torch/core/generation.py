"""STT parameter and result types (port of tpu_audio.core.generation's
``STTGenerateParameters``, ``STTSegment`` and ``STTOutput``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

__all__ = ["STTGenerateParameters", "STTOutput", "STTSegment",
           "validate_kv_bits"]


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
