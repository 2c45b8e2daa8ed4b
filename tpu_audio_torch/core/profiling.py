"""Opt-in tracing (port of tpu_audio.core.profiling).

Set ``TPU_AUDIO_PROFILE=/some/dir`` and wrap work in :func:`maybe_trace`:
a ``torch.profiler`` trace of the block (host operators, and the CUDA
kernels when the work runs on the card) is written under that directory
as a Chrome trace, ``<label>.<pid>.json``, viewable in Perfetto or
``chrome://tracing``. Without the variable the context does nothing.

The CLIs wrap their hot path in it, so any run can be traced without
code changes:

    TPU_AUDIO_PROFILE=/tmp/trace python -m tpu_audio_torch.cli.stt ...
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["maybe_trace"]


@contextlib.contextmanager
def maybe_trace(label: str = "tpu_audio", device=None):
    """Trace the enclosed block with ``torch.profiler`` inside
    ``record_function(label)`` when ``TPU_AUDIO_PROFILE`` names a
    directory; no-op otherwise. CUDA activity is recorded when ``device``
    is a CUDA device (or, with ``device=None``, when a card is present)."""
    target = os.environ.get("TPU_AUDIO_PROFILE")
    if not target:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(target, exist_ok=True)
    on_cuda = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
        if on_cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(target, f"{label}.{os.getpid()}.json"))
