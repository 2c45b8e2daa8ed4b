"""STS task module (speech to speech: enhancement): model registry +
factory (port of tpu_audio.models.sts.load_model; the family ported is
DeepFilterNet v2/v3)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

_REGISTRY: dict[str, str] = {
    "deepfilternet": "tpu_audio_torch.models.sts.deepfilternet:DeepFilterNet",
    "deepfilternet2": "tpu_audio_torch.models.sts.deepfilternet:DeepFilterNet",
    "deepfilternet3": "tpu_audio_torch.models.sts.deepfilternet:DeepFilterNet",
}
# families of the JAX package that wait for a module the port lacks
_MOSSFORMER = "MossFormer2-SE (models/sts/mossformer2_se) is not ported yet"
_SAM = "SAM-Audio (models/sts/sam_audio) is not ported yet"
_LFM = "LFM2-Audio (models/sts/lfm_audio) is not ported yet"
_MISSING: dict[str, str] = {
    "mossformer2_se": _MOSSFORMER, "mossformer2se": _MOSSFORMER, "mossformer2": _MOSSFORMER,
    "sam_audio": _SAM, "samaudio": _SAM,
    "lfm_audio": _LFM, "lfm2_audio": _LFM, "lfm2audio": _LFM,
}


def load_model(repo_or_path: str, **kwargs):
    """Load an STS model from a local checkpoint directory; ``kwargs``
    (``device``, ``dtype``) go to the family's ``from_pretrained``. The
    family is the config's ``modelVersion``, then ``model_type`` (then
    ``architectures[0]``, ``model_version``), then a key found in the
    directory's name, as in the JAX package; MossFormer2-SE, SAM-Audio and
    LFM2-Audio raise a ``ValueError`` naming the module not ported yet."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    cfg = hub.load_config(model_dir)
    model_type = str(cfg.get("modelVersion") or cfg.get("model_type")
                     or hub.resolve_model_type(cfg) or "").lower()
    known = {**_REGISTRY, **_MISSING}
    if model_type not in known:
        name = str(repo_or_path).lower().replace("-", "").replace("_", "")
        model_type = next((k for k in known if k in name), model_type)
    if model_type in _MISSING:
        raise ValueError(f"STS model_type {model_type!r}: {_MISSING[model_type]} "
                         f"(ported: {sorted(_REGISTRY)})")
    if model_type not in _REGISTRY:
        raise ValueError(f"unsupported STS model_type {model_type!r} "
                         f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
