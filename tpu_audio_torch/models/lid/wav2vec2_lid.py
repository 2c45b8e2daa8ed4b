"""MMS-LID on PyTorch (port of tpu_audio.models.lid.wav2vec2_lid): the
wav2vec2 trunk (``models.stt.wav2vec2``), a mean pool over time, then the
``projector`` and ``classifier`` linears; the softmax is taken in f32 and
the top-k read on the host. Also the language-ID result types that every
LID family returns."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import hub, loading, nn
from tpu_audio_torch.models.stt.wav2vec2 import (Wav2Vec2Config, _first_device, normalize,
                                                 sanitize, trunk_forward)

__all__ = ["Wav2Vec2LID", "LIDOutput", "LanguagePrediction"]


@dataclass
class LanguagePrediction:
    language: str
    confidence: float


@dataclass
class LIDOutput:
    language: str
    confidence: float
    top_languages: list[LanguagePrediction] = field(default_factory=list)


class Wav2Vec2LID:
    """MMS-LID: one utterance a call (``predict``; no ``predict_batch``,
    so the server answers it under a lock)."""

    def __init__(self, config: Wav2Vec2Config, params: dict, id2label: dict[int, str],
                 dtype=torch.float32):
        self.config = config
        self.params = params
        self.id2label = id2label
        self.dtype = dtype
        self.device = _first_device(params)

    @classmethod
    def from_pretrained(cls, repo_or_path: str, dtype=torch.float32, device="cuda"
                        ) -> "Wav2Vec2LID":
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir)
        config = Wav2Vec2Config.from_dict(cfg_dict)
        params = loading.to_device(
            loading.load_params(model_dir, sanitize=sanitize, dtype=dtype), device)
        id2label = {int(k): v for k, v in (cfg_dict.get("id2label") or {}).items()}
        return cls(config, params, id2label, dtype)

    @torch.no_grad()
    def logits(self, waveform) -> torch.Tensor:
        """Class logits ``[1, num_labels]`` of the normalized waveform."""
        x = torch.from_numpy(normalize(np.asarray(waveform, np.float32).reshape(-1)))
        h = trunk_forward(self.params, x.to(self.device, self.dtype), self.config).mean(dim=1)
        return nn.linear(self.params["classifier"], nn.linear(self.params["projector"], h))

    def predict(self, waveform, top_k: int = 5) -> LIDOutput:
        probs = torch.softmax(self.logits(waveform)[0].to(torch.float32), dim=-1).cpu().numpy()
        order = np.argsort(-probs)[:min(top_k, len(probs))]
        top = [LanguagePrediction(self.id2label.get(int(i), f"unknown_{i}"), float(probs[i]))
               for i in order]
        best = top[0] if top else LanguagePrediction("unknown", 0.0)
        return LIDOutput(best.language, best.confidence, top)
