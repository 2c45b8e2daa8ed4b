"""Silero VAD, the speech segmenter, ``core.nn.lstm``, ``models.vad.load_model``
and the server's ``vad`` task on the PyTorch port against the JAX package,
on the CPU.

Silero runs at its published widths (``tests/fixtures.make_silero_fixture``'s
shapes). The fixture's periodic weights give nearly constant probabilities
(0.496-0.500), so the comparisons run on copies of its layout with seeded
normal weights (``_write``); both packages load the same checkpoint.
Tolerances: 1e-5 absolute on probabilities (the JAX test's bound for feed
against the offline scan), 1e-6 on ``nn.lstm``; timestamps, speech runs,
segments and server JSON equal.
"""

import io
import json
import threading
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import serve as jserve
from tpu_audio.core import loading as jloading
from tpu_audio.core import nn as jnn
from tpu_audio.models.vad import load_model as jload_model
from tpu_audio.models.vad import segmenter as jseg
from tpu_audio.models.vad import silero as JS
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.core import nn as tnn
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.vad import load_model as tload_model
from tpu_audio_torch.models.vad import segmenter as tseg
from tpu_audio_torch.models.vad import silero as TS

from fixtures import make_silero_fixture, make_sortformer_fixture

torch.set_num_threads(1)

ATOL = 1e-5
MEDIA = "tests/media"


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _write(path, seed):
    """The Silero fixture's MLX layout with seeded normal weights: weights
    N(0, 1/fan_in), the STFT conv's 8 and the final conv's 64 times larger
    (so that the probabilities move with the audio), biases N(0, 0.1)."""
    from safetensors.numpy import save_file

    path = make_silero_fixture(path)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(jloading.load_safetensors(path).items()):
        gain = 8.0 if "stft_conv" in name else 64.0 if "final_conv" in name else 1.0
        std = gain / np.sqrt(np.prod(v.shape[1:])) if v.ndim > 1 else 0.1
        out[name] = (std * rng.standard_normal(v.shape)).astype(np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def vads(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("silero") / "v", 3)
    return JS.SileroVAD.from_pretrained(str(path)), TS.SileroVAD.from_pretrained(
        str(path), device="cpu")


def _speech(name="speech_16k.wav"):
    return load_audio(f"{MEDIA}/{name}", sample_rate=16000)[0]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("bias", ["mlx", "two", "none"])
def test_lstm_matches_jax(with_state, bias):
    """``nn.lstm`` against the JAX ``nn.lstm``: the MLX single bias, the
    torch pair, no bias; zero or given initial state."""
    rng = np.random.default_rng(3)
    hid, inp = 16, 12
    p = {"weight_ih": rng.standard_normal((4 * hid, inp)) / 4,
         "weight_hh": rng.standard_normal((4 * hid, hid)) / 4}
    if bias != "none":
        p["bias_ih"] = rng.standard_normal(4 * hid) * 0.1
    if bias == "two":
        p["bias_hh"] = rng.standard_normal(4 * hid) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, 7, inp)).astype(np.float32)
    state = ([rng.standard_normal((3, hid)).astype(np.float32) for _ in range(2)]
             if with_state else [None, None])
    jy, (jh, jc) = jnn.lstm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                            *[None if s is None else jnp.asarray(s) for s in state])
    ty, (th, tc) = tnn.lstm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                            *[None if s is None else torch.from_numpy(s) for s in state])
    for got, want in ((ty, jy), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_lstm_empty_sequence():
    p = {"weight_ih": torch.zeros(8, 3), "weight_hh": torch.zeros(8, 2)}
    y, (h, c) = tnn.lstm(p, torch.zeros(4, 0, 3))
    assert y.shape == (4, 0, 2) and h.shape == c.shape == (4, 2)


def test_f32_convolutions_restores_flags():
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    with tnn.f32_convolutions():
        assert cudnn.allow_tf32 is False and cudnn.enabled == before[0]
    assert (cudnn.enabled, cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic) == before


@pytest.mark.parametrize("sr,n,rows", [(16000, 16000, 1), (16000, 16000 * 2 + 77, 3),
                                       (8000, 8000, 1), (8000, 8000 + 100, 3)])
def test_predict_proba_matches_jax(vads, sr, n, rows):
    """One row and 3 rows, whole and non-multiple lengths, both branches."""
    jv, tv = vads
    a = _audio(sr + n, n) if rows == 1 else np.stack([_audio(i, n) for i in range(rows)])
    want, got = jv.predict_proba(a, sr), tv.predict_proba(a, sr)
    chunk = 512 if sr == 16000 else 256
    assert got.shape == want.shape == ((rows,) if rows > 1 else ()) + (-(-n // chunk),)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_predict_proba_rows_equal_alone(vads):
    _, tv = vads
    a = np.stack([_audio(i, 9000) for i in range(3)])
    rows = tv.predict_proba(a)
    for i in range(3):
        np.testing.assert_allclose(rows[i], tv.predict_proba(a[i]), atol=1e-6, rtol=0)


def test_predict_proba_empty(vads):
    jv, tv = vads
    assert tv.predict_proba(np.zeros(0, np.float32)).shape == (0,)
    assert tv.predict_proba(np.zeros((2, 0), np.float32)).shape == (2, 0)
    assert jv.predict_proba(np.zeros((2, 0), np.float32)).shape == (2, 0)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_feed_matches_offline_of_both_packages(vads, sr):
    jv, tv = vads
    chunk = 512 if sr == 16000 else 256
    a = _audio(7, chunk * 9)
    state, got = None, []
    for i in range(9):
        p, state = tv.feed(a[i * chunk:(i + 1) * chunk], state, sample_rate=sr)
        got.append(p[0])
    assert state["h"].shape == (1, 128) and state["context"].shape == (1, chunk // 8)
    np.testing.assert_allclose(got, tv.predict_proba(a, sr), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, jv.predict_proba(a, sr), atol=ATOL, rtol=0)


def test_feed_batched_rows(vads):
    jv, tv = vads
    a = np.stack([_audio(i, 512 * 3) for i in range(2)])
    state, got = None, []
    for i in range(3):
        p, state = tv.feed(a[:, i * 512:(i + 1) * 512], state)
        got.append(p)
    np.testing.assert_allclose(np.stack(got, 1), jv.predict_proba(a), atol=ATOL, rtol=0)


def test_refusals_match_jax(vads):
    jv, tv = vads
    for m in (jv, tv):
        with pytest.raises(ValueError):
            m.predict_proba(np.zeros(1000, np.float32), sample_rate=44100)
        with pytest.raises(ValueError):
            m.feed(np.zeros(100, np.float32))
    _, state = tv.feed(np.zeros(512, np.float32))
    with pytest.raises(ValueError):
        tv.feed(np.zeros(256, np.float32), state, sample_rate=8000)


@pytest.mark.parametrize("name", ["speech_16k.wav", "two_speaker_16k.wav"])
def test_speech_timestamps_match_jax(vads, name):
    """On real speech, at the model's threshold and at the median of its
    probabilities (where the seeded model splits the clip into runs)."""
    jv, tv = vads
    audio = _speech(name)
    probs = tv.predict_proba(audio)
    for threshold in (None, float(np.median(probs))):
        got = tv.get_speech_timestamps(audio, threshold=threshold)
        want = jv.get_speech_timestamps(audio, threshold=threshold)
        assert [(t.start, t.end) for t in got] == [(t.start, t.end) for t in want]
    assert len(tv.get_speech_timestamps(audio, threshold=float(np.median(probs)))) > 1


def test_probs_to_timestamps_equal():
    rng = np.random.default_rng(4)
    for sr in (16000, 8000):
        probs = rng.uniform(0, 1, 200).astype(np.float32)
        probs[40:90] = 0.9
        for args in ((0.5, 250, 100, 30), (0.3, 100, 50, 0), (0.7, 50, 200, 60)):
            got = TS.probs_to_timestamps(probs, 200 * 512, sr, *args)
            want = JS.probs_to_timestamps(probs, 200 * 512, sr, *args)
            assert [(t.start, t.end) for t in got] == [(t.start, t.end) for t in want]


@pytest.mark.parametrize("name", ["speech_16k.wav", "two_speaker_16k.wav"])
def test_speech_runs_and_segments_match_jax(vads, name):
    jv, tv = vads
    audio = np.concatenate([_speech(name), np.zeros(8000, np.float32), _speech()])
    p256 = 1.0 - np.prod(1.0 - tv.predict_proba(audio)[: len(audio) // 4096 * 8].reshape(-1, 8),
                         axis=1)
    for cfg in (jseg.SpeechSegmentConfig(),
                jseg.SpeechSegmentConfig(threshold=float(np.median(p256)), merge_gap_s=0.2,
                                         max_chunk_s=1.5)):
        tcfg = tseg.SpeechSegmentConfig(**vars(cfg))
        assert (tseg.detect_speech_runs(audio, 16000, tv, tcfg)
                == jseg.detect_speech_runs(audio, 16000, jv, cfg))
        got, want = tseg.segment_speech(audio, 16000, tv, tcfg), jseg.segment_speech(
            audio, 16000, jv, cfg)
        assert [(len(s), o) for s, o in got] == [(len(s), o) for s, o in want]


def test_random_params_match_the_checkpoint_layout(vads):
    """``init_random_params`` gives the sanitized checkpoint's keys and
    shapes, and its STFT conv is the Hann-windowed DFT basis."""
    _, tv = vads
    p = TS.init_random_params(seed=0)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    assert shapes(p) == shapes(tv.params)
    x = np.cos(2 * np.pi * 5 * np.arange(256) / 256).astype(np.float32)
    mag = np.abs(np.fft.rfft(x * (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(256) / 256))))
    w = p["branch16k"]["stft_conv"]["weight"][:, 0].numpy()
    got = np.hypot(w[:129] @ x, w[129:] @ x)
    np.testing.assert_allclose(got, mag, atol=1e-3)
    probs = TS.SileroVAD(TS.SileroVADConfig(), p).predict_proba(_audio(0, 16000))
    assert probs.shape == (32,) and np.isfinite(probs).all()


def test_load_model_and_refusals(tmp_path, vads):
    m = tload_model(str(_write(tmp_path / "v", 2)), device="cpu")
    assert isinstance(m, TS.SileroVAD) and m.device.type == "cpu"
    s = tload_model(str(make_sortformer_fixture(tmp_path / "s")), device="cpu")
    assert type(s).__name__ == "Sortformer" and s.device.type == "cpu"
    assert isinstance(jload_model(str(tmp_path / "v")), JS.SileroVAD)
    # FSMN VAD and SmartTurn load since they were ported
    # (tests/test_torch_fsmn_vad.py, test_torch_smart_turn.py); a family
    # neither package has is refused, naming the ported ones
    for model_type in ("pyannote", "marblenet"):
        d = tmp_path / f"other_{model_type}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps({"model_type": model_type}))
        with pytest.raises(ValueError, match="ported: .*fsmn.*silero.*smart_turn"):
            tload_model(str(d), device="cpu")


def _wav_bytes(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _post_vad(srv, body: bytes) -> dict:
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/vad", data=body)
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


@pytest.fixture(scope="module")
def sortformers(tmp_path_factory):
    from test_torch_sortformer import _write as write_sortformer

    from tpu_audio.models.vad import sortformer as JSF
    from tpu_audio_torch.models.vad import sortformer as TSF

    path = write_sortformer(tmp_path_factory.mktemp("sortformer") / "s", 2)
    return JSF.Sortformer.from_pretrained(str(path)), TSF.Sortformer.from_pretrained(
        str(path), device="cpu")


@pytest.mark.parametrize("which", ["silero", "sortformer"])
def test_server_vad_matches_jax_route(vads, sortformers, which):
    """``POST /v1/audio/vad`` on the port's server gives the JSON of the JAX
    package's route on the same WAV: speech runs from Silero, speaker
    segments and their count from Sortformer."""
    jm, tm = vads if which == "silero" else sortformers
    body = _wav_bytes(np.concatenate([_speech("two_speaker_16k.wav"), _speech()]))
    got = _post_vad(tserve.build_server(tm, "vad", which, port=0), body)
    want = _post_vad(jserve.build_server(jm, "vad", which, port=0), body)
    assert got == want
    assert got["segments"] and set(got) == ({"segments"} if which == "silero"
                                            else {"segments", "num_speakers"})


@pytest.mark.parametrize("which", ["silero", "sortformer"])
def test_server_vad_with_slots_matches_jax_route(vads, sortformers, which):
    """``--slots`` builds engine workers for STT and TTS only: a VAD server
    with ``slots=2`` starts and answers under the lock, as the JAX one does."""
    jm, tm = vads if which == "silero" else sortformers
    body = _wav_bytes(np.concatenate([_speech("two_speaker_16k.wav"), _speech()]))
    got = _post_vad(tserve.build_server(tm, "vad", which, port=0, slots=2), body)
    want = _post_vad(jserve.build_server(jm, "vad", which, port=0, slots=2), body)
    assert got == want and got["segments"]


def test_serve_detects_the_vad_task(tmp_path):
    assert tserve.detect_task(str(_write(tmp_path / "v", 1))) == "vad"
    assert tserve.detect_task(str(make_sortformer_fixture(tmp_path / "s"))) == "vad"
