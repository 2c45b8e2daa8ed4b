"""Neural audio codecs: the token <-> waveform layer (port of
tpu_audio.codecs). Every codec exposes ``encode`` / ``decode`` /
``reconstruct`` and ``from_pretrained``. Ported: SNAC, Mimi, and the Qwen3-TTS
speech tokenizer (``qwen3_codec``, decoder and encoder, which ``Qwen3TTS``
loads from its checkpoint and which, as in the JAX package, is not in the
registry)."""

from __future__ import annotations

import importlib
from abc import ABC, abstractmethod

from tpu_audio_torch.core import hub

__all__ = ["AudioCodecModel", "load_codec"]


class AudioCodecModel(ABC):
    """Codec protocol: waveform [B?, T] <-> discrete codes."""

    sample_rate: int

    @abstractmethod
    def encode(self, audio):
        """waveform -> codes (codec-specific structure)"""

    @abstractmethod
    def decode(self, codes):
        """codes -> waveform"""

    def reconstruct(self, audio):
        """encode then decode."""
        return self.decode(self.encode(audio))


_REGISTRY: dict[str, str] = {
    "snac": "tpu_audio_torch.codecs.snac:SNAC",
    "mimi": "tpu_audio_torch.codecs.mimi:Mimi",
}


def load_codec(repo_or_path: str, codec_type: str | None = None, **kwargs):
    """Load a codec from a local checkpoint directory; ``kwargs`` (e.g.
    ``dtype``, ``device``) go to its ``from_pretrained``."""
    model_dir = hub.resolve_model_dir(repo_or_path)
    if codec_type is None:
        codec_type = hub.load_config(model_dir).get("model_type")
        if codec_type is None:  # a registered name in the path
            name = str(repo_or_path).lower()
            codec_type = next((key for key in _REGISTRY if key in name), None)
    if codec_type not in _REGISTRY:
        raise NotImplementedError(
            f"codec {codec_type!r} is not ported yet (ported: {sorted(_REGISTRY)})")
    module_name, cls_name = _REGISTRY[codec_type].split(":")
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls.from_pretrained(str(model_dir), **kwargs)
