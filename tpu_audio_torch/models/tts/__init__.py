"""TTS task module: model registry + factory (port of
tpu_audio.models.tts.load_model; the families ported: Orpheus / Llama
TTS, VyvoTTS and Qwen3-TTS)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

# in the JAX registry's order, which the repo-name fallback follows
_REGISTRY: dict[str, str] = {
    "llama_tts": "tpu_audio_torch.models.tts.llama_tts:LlamaTTS",
    "qwen3": "tpu_audio_torch.models.tts.qwen3_vyvo:VyvoTTS",
    "qwen3_tts": "tpu_audio_torch.models.tts.qwen3_tts:Qwen3TTS",
    "orpheus": "tpu_audio_torch.models.tts.llama_tts:LlamaTTS",
    "vyvo": "tpu_audio_torch.models.tts.qwen3_vyvo:VyvoTTS",
}


def load_model(repo_or_path: str, **kwargs):
    """Load a TTS model from a local checkpoint directory; ``kwargs``
    (``dtype``, ``device``, ``quantize_bits``, ``audio_band_head``, ...)
    go to the family's ``from_pretrained``."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    model_type = hub.resolve_model_type(hub.load_config(model_dir))
    if model_type not in _REGISTRY:
        name = str(repo_or_path).lower().replace("-", "").replace("_", "")
        model_type = next((k for k in _REGISTRY if k.replace("_", "") in name),
                          model_type)
    if model_type not in _REGISTRY:
        raise NotImplementedError(f"TTS model_type {model_type!r} is not ported yet "
                                  f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
