"""The streaming STT session on the PyTorch port against the JAX package, on
the CPU with Qwen3-ASR at small sizes: ``IncrementalMelSpectrogram`` over
ragged and one-sample chunks (its log mel through kernel 1's plain
version), ``StreamingEncoder``'s window accounting, the text helpers and
``_promote_tokens`` on the JAX tests' cases and on random ones, whole
sessions' event sequences under one injected clock (kinds, texts,
confirmed texts and the stats the clock decides), the async ``stream`` API,
the core selection's refusal, and ``cli/stt.py --stream``.

The model is ``test_torch_qwen3_asr``'s seeded-normal copy of the fixture,
in f32 in both packages.
"""

import asyncio
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.stt import streaming as JS
from tpu_audio_torch.models.stt import streaming as TS

from fixtures import make_qwen3_asr_fixture
from test_torch_qwen3_asr import _models, _write

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("qwen3_stream")
    d = _write(shutil.copytree(make_qwen3_asr_fixture(root / "fixture"), root / "rand"), seed=3)
    return d, _models(d)


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


class FakeClock:
    """A wall clock the test moves."""

    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


# -- incremental mel -------------------------------------------------------------


@pytest.mark.parametrize("chunks", [[1600, 173, 27200, 1, 999, 7680],
                                    [500] + [1] * 20 + [1480], [1, 1, 399, 2], [7]])
@pytest.mark.parametrize("n_mels", [128, 32])
def test_incremental_mel_matches_jax(chunks, n_mels):
    """Each ``process`` and the ``flush`` give the JAX package's frames
    within 1e-4 (None where it gives None); streamed, the frames before
    normalisation equal the one-shot mel's."""
    audio = _audio(3, sum(chunks))
    t, j = TS.IncrementalMelSpectrogram(n_mels=n_mels), JS.IncrementalMelSpectrogram(n_mels=n_mels)
    pos = 0
    got, want = [], []
    for c in chunks + [None]:
        if c is None:
            a, b = t.flush(), j.flush()
        else:
            a, b = t.process(audio[pos:pos + c]), j.process(audio[pos:pos + c])
            pos += c
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
            got.append(a)
            want.append(b)
    assert t.total_frames == j.total_frames and t._running_log_max == pytest.approx(
        j._running_log_max, abs=1e-5)
    if chunks[0] > 200:
        raw = TS.IncrementalMelSpectrogram(n_mels=n_mels)
        raw._normalize = lambda x: x
        pos, frames = 0, []
        for c in chunks:
            out = raw.process(audio[pos:pos + c])
            pos += c
            frames += [] if out is None else [out]
        whole = raw._mel_frames(np.concatenate([audio[1:201][::-1], audio]))
        np.testing.assert_allclose(torch.cat(frames).numpy(), whole.numpy(), atol=1e-5, rtol=0)


def test_one_sample_chunks_count_frames():
    inc = TS.IncrementalMelSpectrogram(n_mels=16)
    audio = _audio(4, 2000)
    frames = [inc.process(audio[:500])]
    frames += [inc.process(audio[i:i + 1]) for i in range(500, 520)]
    frames.append(inc.process(audio[520:]))
    # a 200-sample reflect prefix on the first chunk
    assert sum(f.shape[0] for f in frames if f is not None) == (2000 + 200 - 400) // 160 + 1


# -- streaming encoder -----------------------------------------------------------


@pytest.mark.parametrize("overlap", [0, 5, 40])
def test_streaming_encoder_window_accounting_matches_jax(overlap):
    calls = {"t": [], "j": []}

    def fake(name):
        def encode(mel):
            calls[name].append(mel.shape[0])
            rows = np.asarray(mel)[::4].sum(-1, keepdims=True) * np.ones((1, 8))
            return torch.from_numpy(rows.astype(np.float32)) if name == "t" else rows
        return encode

    t = TS.StreamingEncoder(fake("t"), window_size=16, max_cached_windows=2,
                            overlap_frames=overlap)
    j = JS.StreamingEncoder(fake("j"), window_size=16, max_cached_windows=2,
                            overlap_frames=overlap)
    rng = np.random.default_rng(0)
    for n in (10, 10, 3, 30, 1, 17):
        mel = rng.standard_normal((n, 4)).astype(np.float32)
        assert t.feed(torch.from_numpy(mel)) == j.feed(mel)
        assert t.pending_frames == j.pending_frames
        assert t.encoded_window_count == j.encoded_window_count
        np.testing.assert_allclose(t.encoded_features().numpy(), j.encoded_features())
        drained = t.drain_new_windows()
        assert [d.shape for d in drained] == [d.shape for d in j.drain_new_windows()]
    t.flush_partial()
    j.flush_partial()
    assert t.encode_pending() is None and j.encode_pending() is None
    assert len(t.cached) == len(j.cached) and calls["t"] == calls["j"]
    assert TS.StreamingEncoder(fake("t")).encoded_features().shape == (0, 1)


# -- text helpers and promotion ----------------------------------------------------

TEXT_CASES = [("hello world", "world again"), ("", "  hi "), ("the cat sat", "the cat sat"),
              ("It's done,", "it's done, next"), ("a b c", ""), ("x", " y"),
              ("one two three four five six seven eight nine ten eleven twelve",
               "four five six seven eight nine ten eleven twelve thirteen"),
              ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu",
               "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu"),
              ("end.\n", "next"), ("Hi!", "hi! again"), ("a", "b c d e f g h i j k l m")]


@pytest.mark.parametrize("base,segment", TEXT_CASES)
def test_text_helpers_match_jax(base, segment):
    assert TS.append_text(base, segment) == JS.append_text(base, segment)
    assert TS.concat_text(base, segment) == JS.concat_text(base, segment)
    for name in ("_dedupe_leading_word_overlap", "_should_skip_duplicate",
                 "_trim_contained_overlap"):
        assert getattr(TS, name)(base, segment) == getattr(JS, name)(base, segment), name


def test_append_text_dedupes_overlap():
    assert TS.append_text("hello world", "world again") == "hello world again"
    assert TS.append_text("", "  hi ") == "hi"
    assert TS.append_text("the cat sat", "the cat sat") == "the cat sat"
    assert TS.append_text("It's done,", "it's done, next") == "It's done, next"


def _events(events):
    return [(e.kind.value, e.text, e.confirmed_text) for e in events]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_promote_tokens_matches_jax(seed):
    """The JAX test's three passes, then random passes with random clock
    steps, delays and agreement counts: the same state and events."""
    decode = lambda ids: " ".join(f"t{i}" for i in ids)  # noqa: E731
    states = TS._SharedState(), JS._SharedState()
    rng = np.random.default_rng(seed)
    passes = [([1, 2, 3], 0.0, 0.5, 2), ([1, 2, 4], 0.6, 0.5, 2), ([1, 2, 5], 0.7, 0.5, 2)]
    now, prev = 0.7, [1, 2, 5]
    for _ in range(12):
        now += float(rng.uniform(0, 0.6))
        keep = int(rng.integers(0, len(prev) + 1))
        prev = prev[:keep] + rng.integers(0, 6, int(rng.integers(0, 4))).tolist()
        passes.append((prev, now, float(rng.choice([0.0, 0.3, 0.5])), int(rng.integers(1, 4))))
    for ids, t, delay, agree in passes:
        ev = [], []
        for state, mod, out in zip(states, (TS, JS), ev):
            mod._promote_tokens(state, ids, t, delay, agree, decode, out)
        assert _events(ev[0]) == _events(ev[1])
        assert states[0].__dict__ == states[1].__dict__
    if seed == 0:
        assert states[0].confirmed_ids[:2] == [1, 2]


# -- sessions ----------------------------------------------------------------------

SESSIONS = {
    "promotion": (dict(delay_seconds=0.0, min_agreement_passes=2, max_tokens_per_pass=4,
                       decode_interval_seconds=1.0, finalize_completed_windows=False),
                  [(5, 4000, 1.5)] * 3),
    "interval": (dict(decode_interval_seconds=10.0, finalize_completed_windows=False,
                      max_tokens_per_pass=4),
                 [(3, 4000, 0.0), (4, 4000, 11.0), (5, 4000, 0.0)]),
    "boundary": (dict(decode_interval_seconds=5.0, boundary_decode_interval_seconds=0.1,
                      boundary_boost_seconds=2.0, max_tokens_per_pass=4,
                      finalize_completed_windows=True),
                 [(9, 16 * 160 + 400, 0.2), (3, 2000, 0.3), (4, 3000, 0.5)]),
    "long": (dict(delay_seconds=0.48, max_tokens_per_pass=6, encoder_window_overlap_seconds=0.05,
                  min_agreement_passes=2),
             [(10 + i, n, 0.4) for i, n in enumerate((1600, 800, 3200, 1, 2400, 1600, 4000,
                                                      1600, 800, 2400))]),
    # silence: the passes agree, and tokens are confirmed after the delay
    "confirm": (dict(delay_seconds=0.5, min_agreement_passes=2, max_tokens_per_pass=5,
                     decode_interval_seconds=1.0), [(None, 640, 0.6)] * 8),
    "freeze": (dict(delay_seconds=0.0, min_agreement_passes=1, max_tokens_per_pass=5,
                    finalize_completed_windows=False, language="English"),
               [(20 + i, 1600, 1.0) for i in range(6)]),
}
CLOCKED = ("encoded_window_count", "audio_seconds", "wall_seconds", "real_time_factor",
           "decode_passes")


def _run_session(mod, model, config, feeds):
    clock = FakeClock()
    session = mod.StreamingInferenceSession(model, config=mod.StreamingConfig(**config),
                                            clock=clock)
    events = []
    for seed, n, dt in feeds:
        events += session.feed_audio(np.zeros(n, np.float32) if seed is None
                                     else _audio(seed, n))
        clock.advance(dt)
    events += session.stop()
    return session, events


@pytest.mark.parametrize("name", list(SESSIONS))
def test_session_events_match_jax(models, name):
    """A whole session under one injected clock: the same event kinds,
    texts and confirmed texts, the same stats where the clock decides
    them, the same promotion state."""
    _, (jm, tm) = models
    config, feeds = SESSIONS[name]
    ts, tev = _run_session(TS, tm, config, feeds)
    js, jev = _run_session(JS, jm, config, feeds)
    assert _events(tev) == _events(jev)
    assert [{k: e.stats[k] for k in CLOCKED} for e in tev if e.kind == TS.EventKind.STATS] == \
        [{k: e.stats[k] for k in CLOCKED} for e in jev if e.kind == JS.EventKind.STATS]
    assert ts.core.state.__dict__ == js.core.state.__dict__
    assert ts.core._passes == js.core._passes >= 1
    assert tev[-1].kind == TS.EventKind.ENDED
    if name == "boundary":
        assert ts.core.encoder.encoded_window_count >= 1
    if name == "promotion":
        assert TS.EventKind.DISPLAY_UPDATE in [e.kind for e in tev]
    if name in ("confirm", "freeze"):
        assert TS.EventKind.CONFIRMED in [e.kind for e in tev]


def test_async_stream_api(models):
    _, (_, tm) = models
    clock = FakeClock()
    config = TS.StreamingConfig(delay_seconds=0.0, min_agreement_passes=1,
                                max_tokens_per_pass=4, finalize_completed_windows=False)
    session = TS.StreamingInferenceSession(tm, config=config, clock=clock)

    async def chunks():
        for i in range(2):
            yield _audio(5 + i, 4000)

    async def run(source):
        out = []
        async for ev in session.stream(source):
            out.append(ev)
            clock.advance(1.5)
        return out

    events = asyncio.run(run(chunks()))
    assert events and events[-1].kind == TS.EventKind.ENDED
    session = TS.StreamingInferenceSession(tm, config=config, clock=clock,
                                           delay_preset=TS.DelayPreset.SUBTITLE,
                                           min_agreement_passes=3, language="English",
                                           max_tokens_per_pass=3)
    assert (session.config.delay_seconds, session.config.min_agreement_passes,
            session.config.language, session.config.max_tokens_per_pass) == \
        (2.4, 3, "English", 3)
    events = asyncio.run(run(iter([_audio(7, 4000)])))
    assert events[-1].kind == TS.EventKind.ENDED


def test_session_rejects_unsupported_model():
    for mod in (TS, JS):
        with pytest.raises(TypeError, match="requires a Qwen3ASR"):
            mod.StreamingInferenceSession(object())


# -- the CLI -----------------------------------------------------------------------


def test_cli_stream_drives_the_session_as_jax(models, tmp_path, capsys, monkeypatch):
    """``--stream`` on a Qwen3-ASR runs the live session at 1 s feeds (each
    package's session on a clock that moves 0.7 s a reading, both models in
    f32, 4 tokens a pass): the same confirmed lines, display updates,
    passes and JSON as the JAX CLI."""
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio.models import stt as jstt_models
    from tpu_audio_torch.cli import stt as tstt
    from tpu_audio_torch.models import stt as tstt_models

    d, _ = models
    wav = tmp_path / "in.wav"
    save_wav(wav, _audio(30, 56000), 16000)
    for mod, models_mod, f32 in ((TS, tstt_models, torch.float32),
                                 (JS, jstt_models, jnp.float32)):
        load = models_mod.load_model
        monkeypatch.setattr(models_mod, "load_model",
                            lambda path, _l=load, _f=f32, **kw: _l(path, **{**kw, "dtype": _f}))
        session = mod.StreamingInferenceSession

        class Clocked(session):
            def __init__(self, model, **kw):
                clock = FakeClock()

                def tick():
                    clock.advance(0.7)
                    return clock.t

                super().__init__(model, clock=tick, max_tokens_per_pass=4, **kw)

        monkeypatch.setattr(mod, "StreamingInferenceSession", Clocked)
    outs = {}
    for name, main, extra in (("jax", jstt.main, []), ("torch", tstt.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        assert main([str(wav), "--model", str(d), "--stream", "--format", "json",
                     "--output", str(path), "--verbose"] + extra) == 0
        cap = capsys.readouterr()
        lines = cap.out.splitlines()
        outs[name] = (json.loads(path.read_text()),
                      lines[:next(i for i, x in enumerate(lines) if x.startswith("{"))],
                      [x for x in cap.err.splitlines() if x.startswith(("[stream]", "[display]"))])
    assert outs["torch"][0] == outs["jax"][0] and outs["torch"][0]["text"]
    assert outs["torch"][1] == outs["jax"][1]
    t_err, j_err = outs["torch"][2], outs["jax"][2]
    assert [x for x in t_err if x.startswith("[display]")] == \
        [x for x in j_err if x.startswith("[display]")]
    assert t_err[-1].split("(")[1] == j_err[-1].split("(")[1] and "passes)" in t_err[-1]
