"""Model directory resolution and ``config.json`` reading.

Port of tpu_audio.core.hub for local directories only: the port never
downloads, so a reference that is not an existing directory raises.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

__all__ = ["load_config", "resolve_model_dir", "resolve_model_type"]


def resolve_model_dir(repo_or_path: str | Path) -> Path:
    """Return the local checkpoint directory ``repo_or_path`` names."""
    p = Path(os.path.expanduser(str(repo_or_path)))
    if not p.is_dir():
        raise FileNotFoundError(
            f"{repo_or_path!r} is not a local directory; tpu_audio_torch does "
            "not download checkpoints: pass a directory holding config.json "
            "and *.safetensors")
    return p


def load_config(model_dir: str | Path) -> dict:
    with open(Path(model_dir) / "config.json") as f:
        return json.load(f)


def resolve_model_type(config: dict) -> str | None:
    """Model family key: ``model_type``, then ``architectures[0]``, then
    ``model_version``."""
    mt = config.get("model_type")
    if isinstance(mt, str) and mt:
        return mt.lower()
    arch = config.get("architectures")
    if isinstance(arch, list) and arch:
        return str(arch[0]).lower()
    mv = config.get("model_version")
    if isinstance(mv, str) and mv:
        return mv.lower()
    return None
