"""LID task module: model registry + factory (port of
tpu_audio.models.lid.load_model; the family ported is ECAPA-TDNN)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

_REGISTRY: dict[str, str] = {
    "ecapa": "tpu_audio_torch.models.lid.ecapa_lid:EcapaLID",
}
# families of the JAX package that wait for a module the port lacks
_MISSING: dict[str, str] = {
    "wav2vec2": "MMS-LID runs on the wav2vec2 trunk (models/stt/wav2vec2), not ported yet",
    "mms-lid": "MMS-LID runs on the wav2vec2 trunk (models/stt/wav2vec2), not ported yet",
}


def load_model(repo_or_path: str, **kwargs):
    """Load a language-ID model from a local checkpoint directory;
    ``kwargs`` (``device``, ``dtype``) go to the family's
    ``from_pretrained``. ``wav2vec2`` / ``mms-lid`` raise a ``ValueError``
    naming the missing wav2vec2 trunk."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    model_type = hub.resolve_model_type(hub.load_config(model_dir))
    known = {**_REGISTRY, **_MISSING}
    if model_type not in known:
        name = str(repo_or_path).lower().replace("-", "").replace("_", "")
        model_type = next((k for k in known if k.replace("-", "") in name), model_type)
    if model_type in _MISSING:
        raise ValueError(f"LID model_type {model_type!r}: {_MISSING[model_type]} "
                         f"(ported: {sorted(_REGISTRY)})")
    if model_type not in _REGISTRY:
        raise ValueError(f"unsupported LID model_type {model_type!r} "
                         f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
