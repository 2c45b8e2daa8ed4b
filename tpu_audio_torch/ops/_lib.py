"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all started
together, and one more links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds). It is
built at first use into ``tpu_audio_torch/_build/`` under a name that
hashes the sources, and loaded with ``ctypes``. Every C entry
point returns ``cudaGetLastError()`` after its launches; :func:`check`
raises on a non-zero code.

``launches`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["lib", "check", "require", "launches", "reset_launches", "stream"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

ATTN_CHUNK = 64  # positions per attention block (csrc/common.cuh)

launches: collections.Counter = collections.Counter()
build_seconds: float | None = None  # wall seconds of the build in this process
_lib = None

P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float

# C signature of every entry point (all return cudaError_t as int)
_SIGNATURES = {
    "tpa_fused_log_mel": [P, P, P, P, I, I, I, P],
    "tpa_decode_attention_int8": [P] * 10 + [I] * 5 + [Fl, P],
    "tpa_fused_stack": [P] * 14 + [I] * 8 + [P],
    "tpa_fused_stack_scratch": [I] * 6 + [P],
    "tpa_fused_stack_lanes": [P] * 19 + [I] * 8 + [P],
    "tpa_fused_llama_stack": [P] * 13 + [I] * 9 + [Fl, P],
    "tpa_fused_llama_stack_lanes": [P] * 16 + [I] * 8 + [Fl, P],
    "tpa_fused_llama_stack_lanes_scratch": [I] * 7 + [P],
    "tpa_quantized_matvec": [P, I, P, P, P, I, P] + [I] * 7 + [P],
    "tpa_quantized_matvec_decode": [P, I, P, P, P, I, P] + [I] * 7 + [P],
    "tpa_quantized_matvec_tile": [P, I, P, P, P, I, P, P, P, P] + [I] * 6 + [P],
}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_audio_torch "
                       "are built from csrc/ with the CUDA toolkit")


def _build() -> Path:
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha1()
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libtpa_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sources]
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True), src)
                 for src, obj in zip(sources, objs)]
        failed = []
        for proc, src in procs:
            out_text = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out_text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = Path(tmpdir) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)  # atomic against a concurrent build
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.tpa_error_string.argtypes = [I]
        so.tpa_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib().tpa_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Check a kernel argument's device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
