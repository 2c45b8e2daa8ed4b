"""The PyTorch port must import without JAX and without the JAX package:
it runs on GPU machines where JAX need not be installed."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_BLOCKER = """
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_audio"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import importlib
for mod in {mods!r}:
    importlib.import_module(mod)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_audio")]
assert not leaked, leaked
print("ok")
"""


@pytest.mark.parametrize("mods", [
    ["tpu_audio_torch"],
    ["tpu_audio_torch.models.stt.whisper", "tpu_audio_torch.models.stt",
     "tpu_audio_torch.cli.stt", "tpu_audio_torch.convert",
     "tpu_audio_torch.core.audio_io", "tpu_audio_torch.core.hub"],
    ["tpu_audio_torch.parallel.continuous", "tpu_audio_torch.parallel.continuous_stt",
     "tpu_audio_torch.core.sampling", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.llama", "tpu_audio_torch.models.tts",
     "tpu_audio_torch.models.tts.llama_tts", "tpu_audio_torch.codecs.snac",
     "tpu_audio_torch.core.ar_loop", "tpu_audio_torch.ops.fused_llama",
     "tpu_audio_torch.cli.tts"],
    ["tpu_audio_torch.parallel.continuous", "tpu_audio_torch.ops.fused_llama",
     "tpu_audio_torch.models.tts.llama_tts", "tpu_audio_torch.core.generation",
     "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.ops.qmm", "tpu_audio_torch.core.quant", "tpu_audio_torch.core.nn",
     "tpu_audio_torch.core.loading", "tpu_audio_torch.convert"],
    ["tpu_audio_torch.models.tts.qwen3_tts", "tpu_audio_torch.codecs.qwen3_codec",
     "tpu_audio_torch.models.tts", "tpu_audio_torch.cli.tts", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.parallel.continuous_qwen3", "tpu_audio_torch.cli.serve",
     "tpu_audio_torch.core.sampling"],
    ["tpu_audio_torch.models.stt.parakeet", "tpu_audio_torch.models.stt.nemo_alignment",
     "tpu_audio_torch.models.stt", "tpu_audio_torch.cli.stt", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.vad", "tpu_audio_torch.models.vad.silero",
     "tpu_audio_torch.models.vad.sortformer", "tpu_audio_torch.models.vad.segmenter",
     "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.vad.fsmn_vad", "tpu_audio_torch.models.vad.smart_turn",
     "tpu_audio_torch.models.vad", "tpu_audio_torch.core.dsp"],
    ["tpu_audio_torch.models.lid", "tpu_audio_torch.models.lid.ecapa_lid",
     "tpu_audio_torch.models.lid.wav2vec2_lid", "tpu_audio_torch.cli.lid",
     "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.sts", "tpu_audio_torch.models.sts.deepfilternet",
     "tpu_audio_torch.cli.sts", "tpu_audio_torch.cli.serve", "tpu_audio_torch.core.dsp"],
    ["tpu_audio_torch.codecs.mimi", "tpu_audio_torch.codecs", "tpu_audio_torch.codecs.qwen3_codec",
     "tpu_audio_torch.models.tts.qwen3_speaker", "tpu_audio_torch.models.tts.qwen3_tts",
     "tpu_audio_torch.cli.tts", "tpu_audio_torch.convert"],
    ["tpu_audio_torch.models.tts.qwen3_vyvo", "tpu_audio_torch.models.tts",
     "tpu_audio_torch.core.kv_cache", "tpu_audio_torch.models.llama",
     "tpu_audio_torch.cli.tts", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.stt.qwen3_asr", "tpu_audio_torch.models.stt.streaming",
     "tpu_audio_torch.parallel.continuous_stt", "tpu_audio_torch.cli.stt",
     "tpu_audio_torch.models.stt", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.stt.qwen3_aligner", "tpu_audio_torch.models.stt.cohere",
     "tpu_audio_torch.core.spm", "tpu_audio_torch.models.stt.streaming",
     "tpu_audio_torch.cli.stt", "tpu_audio_torch.cli.tts", "tpu_audio_torch.cli.serve"],
    ["tpu_audio_torch.models.stt.moss_diarize", "tpu_audio_torch.models.stt.wav2vec2",
     "tpu_audio_torch.models.lid.wav2vec2_lid", "tpu_audio_torch.core.audio_stream",
     "tpu_audio_torch.core.profiling", "tpu_audio_torch.core.generation",
     "tpu_audio_torch.cli.stt", "tpu_audio_torch.cli.tts", "tpu_audio_torch.cli.lid",
     "tpu_audio_torch.cli.serve"],
])
def test_port_imports_without_jax(mods):
    res = subprocess.run([sys.executable, "-c", _BLOCKER.format(mods=mods)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py's imports (it exits before any work without a GPU)."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKER.format(mods=[]) .replace(
            'print("ok")', 'import runpy; runpy.run_path("chip_smoke.py", '
            'run_name="not_main"); print("ok")')],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
