"""LID task module: model registry + factory (port of
tpu_audio.models.lid.load_model; the families ported are ECAPA-TDNN and
MMS-LID on the wav2vec2 trunk)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

_REGISTRY: dict[str, str] = {
    "ecapa": "tpu_audio_torch.models.lid.ecapa_lid:EcapaLID",
    "wav2vec2": "tpu_audio_torch.models.lid.wav2vec2_lid:Wav2Vec2LID",
    "mms-lid": "tpu_audio_torch.models.lid.wav2vec2_lid:Wav2Vec2LID",
}


def load_model(repo_or_path: str, **kwargs):
    """Load a language-ID model from a local checkpoint directory;
    ``kwargs`` (``device``, ``dtype``) go to the family's
    ``from_pretrained``. The family is the config's ``model_type``, else
    the first registry name found in the directory's name."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    model_type = hub.resolve_model_type(hub.load_config(model_dir))
    if model_type not in _REGISTRY:
        name = str(repo_or_path).lower().replace("-", "").replace("_", "")
        model_type = next((k for k in _REGISTRY if k.replace("-", "") in name), model_type)
    if model_type not in _REGISTRY:
        raise ValueError(f"unsupported LID model_type {model_type!r} "
                         f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
