"""VAD / diarization task module: model registry + factory (port of
tpu_audio.models.vad.load_model: Silero VAD, Sortformer, SmartTurn and FSMN
VAD)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

_REGISTRY: dict[str, str] = {
    "silero_vad": "tpu_audio_torch.models.vad.silero:SileroVAD",
    "silero": "tpu_audio_torch.models.vad.silero:SileroVAD",
    "sortformer": "tpu_audio_torch.models.vad.sortformer:Sortformer",
    "smart_turn": "tpu_audio_torch.models.vad.smart_turn:SmartTurn",
    "fsmn": "tpu_audio_torch.models.vad.fsmn_vad:FSMNVAD",
    "fsmn_vad": "tpu_audio_torch.models.vad.fsmn_vad:FSMNVAD",
    "smartturn": "tpu_audio_torch.models.vad.smart_turn:SmartTurn",
}


def load_model(repo_or_path: str, **kwargs):
    """Load a VAD, endpointing or diarization model from a local checkpoint
    directory; ``kwargs`` (``device``; Sortformer, SmartTurn and FSMN also
    ``dtype``) go to the family's ``from_pretrained``. An unknown family
    raises a ``ValueError`` naming the ported ones."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    model_type = hub.resolve_model_type(hub.load_config(model_dir))
    if model_type not in _REGISTRY:
        name = str(repo_or_path).lower().replace("-", "").replace("_", "")
        model_type = next((k for k in _REGISTRY if k.replace("_", "") in name), model_type)
    if model_type not in _REGISTRY:
        raise ValueError(f"unsupported VAD model_type {model_type!r} "
                         f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
