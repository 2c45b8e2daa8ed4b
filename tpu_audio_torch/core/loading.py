"""Checkpoint loading: safetensors -> nested parameter dicts of tensors.

Port of tpu_audio.core.loading with its own safetensors reader (the
format is an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}``, then the raw little-endian
buffers), so the port needs no ``safetensors`` package. bf16 buffers are
read as uint16 and viewed as ``torch.bfloat16``.

:class:`TreeModule` carries such a nested dict inside an ``nn.Module``
(every tensor a buffer), so ``.to(device)`` and ``state_dict()`` work on
models whose forward functions take plain dicts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from tpu_audio_torch.core.quant import Int8Tensor, QuantizedTensor

__all__ = ["load_safetensors", "load_safetensors_file", "unflatten", "flatten",
           "load_params", "cast_floats", "stack_layer_params", "to_device", "TreeModule"]

_ST_DTYPES = {
    "F64": (np.float64, None), "F32": (np.float32, None),
    "F16": (np.float16, None), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, None), "I32": (np.int32, None),
    "I16": (np.int16, None), "I8": (np.int8, None),
    "U8": (np.uint8, None), "BOOL": (np.bool_, None),
    "U32": (np.int32, None),  # packed words: the same bits as int32
}
def load_safetensors_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Read one ``.safetensors`` file into CPU tensors."""
    path = Path(path)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info['dtype']}")
        np_dtype, view = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        arr = np.frombuffer(data[start:end], dtype=np.dtype(np_dtype).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(np_dtype, copy=True)).reshape(info["shape"])
        out[name] = t.view(view) if view is not None else t
    return out


def load_safetensors(model_dir: str | Path) -> dict[str, torch.Tensor]:
    """Load and merge all safetensors shards of a directory (honours
    ``model.safetensors.index.json`` when present)."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        files = sorted({model_dir / v for v in weight_map.values()})
    else:
        files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors found in {model_dir}")
    out: dict[str, torch.Tensor] = {}
    for fp in files:
        out.update(load_safetensors_file(fp))
    return out


def unflatten(flat: dict) -> dict:
    """``{"a.b.0.w": x}`` -> ``{"a": {"b": {"0": {"w": x}}}}``."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"key conflict at {p!r} in {key!r}")
        node[parts[-1]] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def cast_floats(tree, dtype):
    """Cast float leaves to ``dtype`` (MLX scales and biases too, as the
    JAX package does); integer leaves stay as they are."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.to(dtype)
        return node

    return walk(tree)


def to_device(tree, device):
    """Move every tensor leaf of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, Int8Tensor):
        return Int8Tensor(tree.weight.to(device), tree.scale.to(device))
    if isinstance(tree, QuantizedTensor):
        return tree.map(lambda t: t.to(device))
    return tree.to(device)


def stack_layer_params(tree, container: str = "layers"):
    """Turn ``{"layers": {"0": sub, "1": sub, ...}}`` containers into one
    sub-tree whose leaves gain a leading layer dim ``[L, ...]``."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == container and isinstance(v, dict) and v
                and all(s.isdigit() for s in v)
                and all(str(i) in v for i in range(len(v)))):
            per = [stack_layer_params(v[str(i)], container) for i in range(len(v))]
            out[k] = _stack_trees(per)
        else:
            out[k] = stack_layer_params(v, container)
    return out


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def load_params(model_dir: str | Path,
                sanitize: Callable[[dict], dict] | None = None,
                dtype=None, expected_prefixes: tuple[str, ...] = ()) -> dict:
    """Shards -> sanitize -> unflatten -> (optional float cast)."""
    flat = load_safetensors(model_dir)
    if sanitize is not None:
        flat = sanitize(flat)
    if not flat:
        raise ValueError(f"{model_dir}: empty parameter set")
    for prefix in expected_prefixes:
        if not any(k.startswith(prefix) for k in flat):
            raise KeyError(f"missing expected parameter group {prefix!r}")
    params = unflatten(flat)
    return cast_floats(params, dtype) if dtype is not None else params


class TreeModule(nn.Module):
    """A nested parameter dict held as module buffers. :meth:`tree`
    rebuilds the dict from the current buffers (after ``.to(...)``);
    :class:`Int8Tensor` leaves round-trip as ``weight``/``scale`` pairs and
    :class:`QuantizedTensor` leaves as ``weight``/``scales``/``biases``
    triples with their group size and bits."""

    def __init__(self, tree: dict):
        super().__init__()
        self._leaf = None  # (class, static args) of a quantized leaf
        self._cached = None
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, TreeModule(v))
            elif isinstance(v, Int8Tensor):
                child = TreeModule({"weight": v.weight, "scale": v.scale})
                child._leaf = (Int8Tensor, ())
                self.add_module(k, child)
            elif isinstance(v, QuantizedTensor):
                child = TreeModule({"weight": v.weight, "scales": v.scales,
                                    "biases": v.biases})
                child._leaf = (QuantizedTensor, (v.group_size, v.bits))
                self.add_module(k, child)
            else:
                self.register_buffer(k, v)

    def _apply(self, fn, *args, **kwargs):
        self._cached = None  # buffers are replaced: rebuild the view
        return super()._apply(fn, *args, **kwargs)

    def tree(self):
        """The dict view, cached until the buffers move (an
        :class:`Int8Tensor` keeps its padded-weight cache across calls)."""
        if self._cached is None:
            if self._leaf is not None:
                cls, static = self._leaf
                self._cached = cls(*self._buffers.values(), *static)
            else:
                out = dict(self._buffers)
                out.update({k: m.tree() for k, m in self._modules.items()})
                self._cached = out
        return self._cached
