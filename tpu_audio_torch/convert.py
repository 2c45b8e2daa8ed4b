"""Parameter trees from the JAX package to the port.

:func:`from_jax_params` takes a ``tpu_audio`` parameter tree whose leaves
are numpy arrays (an ``Int8Tensor`` leaf given as a ``(weight, scale)``
pair) and returns the same tree of torch tensors (``Int8Tensor`` leaves of
:mod:`tpu_audio_torch.core.quant`), so that both packages compute from the
same weights. bfloat16 arrays (numpy dtype ``bfloat16``) keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_audio_torch.core.quant import Int8Tensor

__all__ = ["from_jax_params", "to_tensor"]


def to_tensor(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree, device=None):
    """Convert a JAX-package parameter tree (numpy leaves) to the port's."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2:
        return Int8Tensor(to_tensor(tree[0], device), to_tensor(tree[1], device))
    return to_tensor(tree, device)
