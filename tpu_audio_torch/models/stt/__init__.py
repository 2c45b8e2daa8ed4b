"""STT task module: model registry + factory (port of
tpu_audio.models.stt.load_model; the families ported are Whisper, Parakeet,
Qwen3-ASR, the Qwen3 forced aligner, Cohere Transcribe, wav2vec2 CTC and
MOSS-Transcribe-Diarize)."""

from __future__ import annotations

import importlib

from tpu_audio_torch.core import hub

_REGISTRY: dict[str, str] = {
    "whisper": "tpu_audio_torch.models.stt.whisper:Whisper",
    "parakeet": "tpu_audio_torch.models.stt.parakeet:Parakeet",
    "qwen3_asr": "tpu_audio_torch.models.stt.qwen3_asr:Qwen3ASR",
    "qwen3_forced_aligner": "tpu_audio_torch.models.stt.qwen3_aligner:Qwen3ForcedAligner",
    "cohere_asr": "tpu_audio_torch.models.stt.cohere:CohereTranscribe",
    "cohere": "tpu_audio_torch.models.stt.cohere:CohereTranscribe",
    "wav2vec2": "tpu_audio_torch.models.stt.wav2vec2:Wav2Vec2CTC",
    "moss_transcribe_diarize": "tpu_audio_torch.models.stt.moss_diarize:MossTranscribeDiarize",
    "mosstranscribediarize": "tpu_audio_torch.models.stt.moss_diarize:MossTranscribeDiarize",
}


def _squash(name) -> str:
    return str(name).lower().replace("-", "").replace("_", "")


def load_model(repo_or_path: str, **kwargs):
    """Load an STT model from a local checkpoint directory; ``kwargs``
    (``dtype``, ``device``, ``quantize``) go to the family's
    ``from_pretrained``. A forced-aligner checkpoint shares Qwen3-ASR's
    config and is told apart by its name, as in the JAX package."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    if "forcedalign" in _squash(repo_or_path):
        model_type = "qwen3_forced_aligner"
    else:
        model_type = hub.resolve_model_type(hub.load_config(model_dir))
    if model_type not in _REGISTRY:
        name = _squash(repo_or_path)
        model_type = next((k for k in _REGISTRY if _squash(k) in name), model_type)
    if model_type not in _REGISTRY:
        raise ValueError(f"unsupported STT model_type {model_type!r} "
                         f"(ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[model_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
