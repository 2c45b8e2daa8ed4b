"""Language-ID results (port of the result types of
tpu_audio.models.lid.wav2vec2_lid). ``Wav2Vec2LID`` (MMS-LID) itself waits
for the wav2vec2 trunk, which the port lacks."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["LIDOutput", "LanguagePrediction"]


@dataclass
class LanguagePrediction:
    language: str
    confidence: float


@dataclass
class LIDOutput:
    language: str
    confidence: float
    top_languages: list[LanguagePrediction] = field(default_factory=list)
