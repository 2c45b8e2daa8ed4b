"""Parameter trees from the JAX package to the port.

:func:`from_jax_params` takes a ``tpu_audio`` parameter tree whose leaves
are numpy arrays (an ``Int8Tensor`` leaf given as a ``(weight, scale)``
pair, a ``QuantizedTensor`` leaf as a :class:`MLXLeaf`) and returns the
same tree of torch tensors (``Int8Tensor`` and ``QuantizedTensor`` leaves
of :mod:`tpu_audio_torch.core.quant`), so that both packages compute from
the same weights. Nested dicts carry over key for key: Whisper, Llama /
Orpheus and SNAC trees, a Qwen3-TTS talker (stacked layers, the
``code_predictor`` subtree with its per-group heads and embeddings, the
text projection), a Qwen3 speech tokenizer's decoder, a sanitized
Parakeet tree (encoder, prediction network, joint; dense or with MLX
packed linears and embedding), the FSMN VAD, SmartTurn and ECAPA-TDNN
trees, Mimi's, the Qwen3 speech tokenizer's encoder and speaker
encoder, a Qwen3-ASR or forced-aligner tree (its ``lm_head`` timestamp
head too), a sanitized Cohere Transcribe tree (encoder, decoder,
head; dense or with MLX packed linears and embedding), a sanitized
MOSS-Transcribe-Diarize tree (the stacked Whisper encoder, ``vq_adaptor``
and the fused ``language_model``; dense or MLX-packed), and a wav2vec2
tree (CTC or LID heads, MMS adapter layers). bfloat16 arrays (numpy dtype ``bfloat16``) keep their
bits, and uint32 words become int32 of the same bits. The JAX package's
word-scale planes (``scales_w``) have no counterpart and are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_audio_torch.core.quant import Int8Tensor, QuantizedTensor

__all__ = ["from_jax_params", "to_tensor", "MLXLeaf"]


class MLXLeaf(NamedTuple):
    """A JAX ``QuantizedTensor`` as numpy: packed uint32 words, scales,
    biases, and its group size and bits."""

    weight: np.ndarray
    scales: np.ndarray
    biases: np.ndarray
    group_size: int
    bits: int


def to_tensor(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device=None):
    """Convert a JAX-package parameter tree (numpy leaves) to the port's."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, MLXLeaf):
        return QuantizedTensor(to_tensor(tree.weight, device), to_tensor(tree.scales, device),
                               to_tensor(tree.biases, device), tree.group_size, tree.bits)
    if isinstance(tree, tuple) and len(tree) == 2:
        return Int8Tensor(to_tensor(tree[0], device), to_tensor(tree[1], device))
    return to_tensor(tree, device)
