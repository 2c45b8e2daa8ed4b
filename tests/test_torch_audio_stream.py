"""``core.audio_stream``, ``core.generation.pcm_stream`` and
``core.profiling`` on the PyTorch port, on the CPU: the stateful resampler
and the headless player against the JAX package's classes on the same
inputs (ragged pushes, down- and upsampling, int16, stereo, a rate change
mid-stream, fades and callbacks, within 1e-6), ``pcm_stream`` over a fake
model against the JAX package's, and the CLIs' traces under
``TPU_AUDIO_PROFILE``."""

import json

import numpy as np
import pytest

from tpu_audio.core import audio_stream as JA
from tpu_audio.core import generation as JG
from tpu_audio_torch.core import audio_stream as TA
from tpu_audio_torch.core import generation as TG
from tpu_audio_torch.core import profiling

from fixtures import make_llama_tts_fixture, make_snac_fixture

TOL = 1e-6  # float32 resampler outputs, NumPy GEMM against the JAX package's


def _noise(seed, n, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _run(mod, pushes, out_rate):
    conv = mod.PCMStreamConverter(out_rate)
    outs = [conv.push(x, in_rate=r) for x, r in pushes]
    outs.append(conv.finish())
    return outs


def _same(pushes, out_rate):
    got, want = _run(TA, pushes, out_rate), _run(JA, pushes, out_rate)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    return np.concatenate(got)


@pytest.mark.parametrize("step", [1111, 480, 7, 24000])
def test_ragged_downsampling_matches_jax(step):
    x = _noise(0, 24000)
    y = _same([(x[i:i + step], 24000) for i in range(0, len(x), step)], 16000)
    assert len(y) == 16000


@pytest.mark.parametrize("in_rate,out_rate", [(16000, 48000), (22050, 16000), (8000, 24000)])
def test_resampling_rates_match_jax(in_rate, out_rate):
    x = np.sin(np.arange(in_rate // 5) / 5).astype(np.float32)
    y = _same([(x[:999], in_rate), (x[999:], in_rate)], out_rate)
    assert abs(len(y) - len(x) * out_rate / in_rate) <= 1


def test_int16_stereo_and_passthrough_match_jax():
    x16 = (np.sin(np.arange(800) / 7) * 20000).astype(np.int16)
    x32 = (np.sin(np.arange(600) / 3) * 1e9).astype(np.int32)
    stereo = np.stack([x16, x16 // 2], axis=1)
    for out_rate in (16000, 24000):
        y = _same([(x16, 16000), (stereo, 16000), (x32, 16000)], out_rate)
        assert np.abs(y).max() < 1.0


def test_rate_change_mid_stream_matches_jax():
    """A 32 kHz push flushes the 48 kHz converter's tail first; empty
    pushes return what was flushed only."""
    y = _same([(np.ones(480, np.float32), 48000), (np.ones(320, np.float32), 32000),
               (np.zeros(0, np.float32), 32000), (_noise(1, 1000), 16000)], 16000)
    assert len(y) == 160 + 160 + 1000


def test_player_fades_and_callbacks_match_jax():
    logs = {}
    for name, mod in (("t", TA), ("j", JA)):
        sink, events, done = [], [], []
        p = mod.AudioPlayer(16000, sink=sink.append)
        p.on_speaking_state_changed = events.append
        p.on_did_finish_streaming = lambda d=done: d.append(1)
        outs = [p.schedule_audio_chunk(np.ones(800, np.float32)),
                p.schedule_audio_chunk(_noise(2, 500)),
                p.schedule_audio_chunk(np.ones(100, np.float32), with_crossfade=False),
                p.schedule_audio_chunk(np.ones(5, np.float32))]
        dur = (p.duration, p.current_time)
        p.finish_streaming()
        fin = (p.stream_finished, p.is_speaking)
        p.stop()
        logs[name] = (outs, sink, events, done, dur, fin, p.scheduled_frames, p.is_streaming)
    t, j = logs["t"], logs["j"]
    for a, b in zip(t[0] + t[1], j[0] + j[1]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    assert t[2:] == j[2:] and t[2] == [True, False] and t[4][0] == 1405 / 16000
    assert t[0][0][0] == 0.0 and t[0][0][159] < 1.0 and t[0][0][160] == 1.0


class _Stub:
    """A TTS model whose ``generate_stream`` yields a token, two audio
    chunks and a progress event, as each package's events."""

    def __init__(self, gen, sample_rate=16000):
        self.gen, self.sample_rate = gen, sample_rate

    def generate_stream(self, text, **kw):
        g = self.gen.AudioGeneration
        yield g.from_token(3)
        yield g.from_audio(np.sin(np.arange(1600) * 0.05).astype(np.float32) * 0.5)
        yield g.from_audio(_noise(4, 801) * 3.0)  # clipped by the int16 conversion
        yield g.from_progress(1.0)


@pytest.mark.parametrize("out_rate,dtype", [(8000, np.int16), (None, np.int16),
                                            (24000, np.float32)])
def test_pcm_stream_matches_jax(out_rate, dtype):
    got = list(TG.pcm_stream(_Stub(TG), "hi", out_rate=out_rate, dtype=dtype))
    want = list(JG.pcm_stream(_Stub(JG), "hi", out_rate=out_rate, dtype=dtype))
    assert [g.dtype for g in got] == [w.dtype for w in want] == [np.dtype(dtype)] * len(got)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        tol = 1 if dtype == np.int16 else TOL  # one int16 step
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), atol=tol, rtol=0)
    assert [len(c) for c in TG.samples_stream(_Stub(TG), "hi")] == [1600, 801]


def test_maybe_trace_makes_nothing_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_AUDIO_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("x"):
        np.zeros(3).sum()
    assert list(tmp_path.iterdir()) == []


def _trace_names(d, label):
    files = list(d.glob(f"{label}.*.json"))
    assert len(files) == 1, files
    return {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}


def _wav2vec2_dir(d):
    """A 1-layer wav2vec2 CTC checkpoint of the port's random params."""
    from dataclasses import asdict

    from safetensors.numpy import save_file

    from tpu_audio_torch.core.loading import flatten
    from tpu_audio_torch.models.stt import wav2vec2 as W

    cfg = W.Wav2Vec2Config(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                           intermediate_size=64, conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3),
                           conv_stride=(5, 2, 2), num_conv_pos_embeddings=16,
                           num_conv_pos_embedding_groups=4, vocab_size=12)
    d.mkdir()
    save_file({k: v.numpy() for k, v in flatten(W.init_random_params(cfg)).items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({**asdict(cfg), "model_type": "wav2vec2"}))
    return d


def test_stt_cli_writes_a_trace(tmp_path, monkeypatch):
    from tpu_audio_torch.cli import stt
    from tpu_audio_torch.core.audio_io import save_wav

    d = _wav2vec2_dir(tmp_path / "w2v")
    wav = tmp_path / "in.wav"
    save_wav(wav, _noise(5, 8000, 0.1), 16000)
    monkeypatch.setenv("TPU_AUDIO_PROFILE", str(tmp_path / "trace"))
    assert stt.main([str(wav), "--model", str(d), "--device", "cpu"]) == 0
    names = _trace_names(tmp_path / "trace", "stt_generate")
    assert "stt_generate" in names and any(str(n).startswith("aten::") for n in names)


def test_tts_cli_writes_a_trace(tmp_path, monkeypatch):
    from tpu_audio_torch.cli import tts

    d = make_llama_tts_fixture(tmp_path / "orpheus")
    snac = make_snac_fixture(tmp_path / "snac", vq_strides=(4, 2, 1))
    monkeypatch.setenv("TPU_AUDIO_PROFILE", str(tmp_path / "trace"))
    assert tts.main(["hello", "--model", str(d), "--codec", str(snac), "--device", "cpu",
                     "--max-tokens", "14", "--seed", "1", "-o", str(tmp_path / "o.wav")]) == 0
    assert "tts_generate" in _trace_names(tmp_path / "trace", "tts_generate")
