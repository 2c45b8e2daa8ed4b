"""PyTorch + CUDA port of tpu_audio for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (``core``, ``ops``, ``models``,
``parallel``, ``cli``).
Plain tensor code is PyTorch; every Pallas kernel on a ported path has a
hand-written CUDA kernel under ``csrc/`` (built with nvcc at first use)
and a plain PyTorch version beside its wrapper in ``ops/``. A wrapper
runs the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.

Ported so far: Whisper transcription (``models.stt.whisper``) for one
30 s window, in the dense, bf16-kv8d and w8-kv8d configurations, and its
continuous-batching server (``parallel.continuous_stt``, ``cli.serve``);
offline Orpheus speech synthesis (``models.tts.llama_tts`` over
``models.llama`` and ``codecs.snac``, ``cli.tts``), w8a8 decode through the
fused Llama kernel.
"""

__version__ = "0.1.0"
