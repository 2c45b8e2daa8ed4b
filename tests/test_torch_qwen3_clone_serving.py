"""Qwen3-TTS voice cloning through the entry points, on the CPU: the
port's ``cli/tts.py --ref-audio --ref-text`` against the JAX CLI, the solo
``serve --task tts`` route (``ref_audio_b64`` and ``ref_text``) against
the JAX route, and the serving engine's refusal of cloning.

Both CLIs load at bf16, so the comparisons run there on the "rand"
checkpoint of tests/test_torch_qwen3_clone.py, greedy: the port's PCM16
within one step of the JAX package's. Where the two packages' bf16 greedy
codes for a clip part, the near tie must show the witness
(``assert_greedy_or_witness``), and the port's output is then held to its
own model's ``generate`` (or ``generate_stream``) instead.
"""

import base64
import contextlib
import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest
import torch

import tpu_audio.models.tts as jtts
from tpu_audio.cli import serve as jserve
from tpu_audio.cli import tts as jcli
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.cli import tts as tcli
from tpu_audio_torch.core.audio_io import float_to_pcm16, load_audio
from tpu_audio_torch.core.generation import AudioGenerationKind

from test_torch_qwen3_clone import (REF_TEXT, TEXT, _clip, _run,  # noqa: F401 (fixtures)
                                    assert_greedy_or_witness, dirs, models)

torch.set_num_threads(1)

FRAMES = 6
HOP = 8  # the fixture codec's samples a frame


def _wav_bytes(audio, sr=24000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(float_to_pcm16(audio).tobytes())
    return buf.getvalue()


def _pcm(wav: bytes):
    with wave.open(io.BytesIO(wav)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _greedy(model, max_tokens=FRAMES):
    gp = model.default_generation_parameters()
    gp.max_tokens, gp.temperature = max_tokens, 0.0
    return gp


def _assert_as_jax(jm, tm, got, want, heard, stream):
    """``got`` (the port's PCM16) within one step of ``want`` (the JAX
    package's), or, where the two packages' greedy codes for ``heard``
    part at a witnessed near tie, of the port model's own output."""
    assert got.shape == want.shape == (FRAMES * HOP,)
    if assert_greedy_or_witness(jm, tm, _run(tm, _greedy(tm), heard)[0],
                                _run(jm, _greedy(jm), heard)[0], heard):
        kw = dict(ref_audio=heard, ref_text=REF_TEXT, generation_parameters=_greedy(tm))
        audio = (np.concatenate([e.audio for e in tm.generate_stream(TEXT, **kw)
                                 if e.kind == AudioGenerationKind.AUDIO]) if stream
                 else tm.generate(TEXT, **kw))
        want = float_to_pcm16(audio)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("stream", [False, True])
def test_cli_ref_audio_matches_jax_cli(models, dirs, tmp_path, monkeypatch, stream):
    """``--ref-audio``/``--ref-text``, ``--temperature 0``; ``--stream``
    decodes without the reference prefix, as the JAX CLI does. The JAX CLI
    gets the JAX model built from the same directory at bf16 (its graphs
    compiled once); the port's CLI loads its own."""
    jm, tm = models("rand", "bfloat16")
    monkeypatch.setattr(jtts, "load_model", lambda path, **kw: jm)
    ref = tmp_path / "ref.wav"
    ref.write_bytes(_wav_bytes(_clip(9)))
    outs = {}
    for name, cli, extra in (("torch", tcli, ["--device", "cpu"]), ("jax", jcli, [])):
        out = tmp_path / f"{name}.wav"
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main([TEXT, "--model", str(dirs["rand"]), "--ref-audio", str(ref),
                             "--ref-text", REF_TEXT, "--max-tokens", str(FRAMES),
                             "--temperature", "0", "-o", str(out),
                             *(["--stream"] if stream else []), *extra]) == 0
        outs[name] = _pcm(out.read_bytes())
    (sr, got), (jsr, want) = outs["torch"], outs["jax"]
    assert sr == jsr == 24000
    _assert_as_jax(jm, tm, got, want, load_audio(str(ref), sample_rate=24000)[0], stream)


def _post(srv, path, payload):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("path", ["/v1/audio/speech", "/v1/audio/speech/stream"])
def test_solo_server_route_clones_as_the_jax_route(models, monkeypatch, path):
    """Without slots, ``ref_audio_b64`` and ``ref_text`` reach ``generate``
    (``generate_stream`` on /stream); both models' default parameters made
    greedy."""
    jm, tm = models("rand", "bfloat16")
    for m in (tm, jm):
        gp = _greedy(m, 2400)
        monkeypatch.setattr(m, "default_generation_parameters", lambda gp=gp: gp)
    body = _wav_bytes(_clip(10))
    payload = {"input": TEXT, "max_tokens": FRAMES, "ref_text": REF_TEXT,
               "ref_audio_b64": base64.b64encode(body).decode()}
    got = _post(tserve.build_server(tm, "tts", "q3", port=0, slots=1), path, payload)
    want = _post(jserve.build_server(jm, "tts", "q3", port=0), path, payload)
    if path.endswith("speech"):
        (sr, got), (jsr, want) = _pcm(got), _pcm(want)
        assert sr == jsr == 24000
    else:
        got, want = np.frombuffer(got, np.int16), np.frombuffer(want, np.int16)
    heard = tserve._load_wav_body(body, 24000)[0]
    _assert_as_jax(jm, tm, got, want, heard, path.endswith("stream"))


def test_serving_engine_still_refuses_cloning(models):
    from tpu_audio_torch.parallel.continuous_qwen3 import Qwen3TTSEngineWorker

    tm = models("rand", jax=False)
    srv = tserve.build_server(tm, "tts", "q3", port=0, slots=2)
    try:
        assert isinstance(srv.tts_worker, Qwen3TTSEngineWorker)
        with pytest.raises(ValueError, match="use the solo endpoint for ref-audio cloning"):
            next(srv.tts_worker.synthesize(TEXT, ref_audio=_clip(11), ref_text=REF_TEXT))
    finally:
        srv.server_close()
