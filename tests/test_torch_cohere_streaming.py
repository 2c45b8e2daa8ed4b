"""The streaming session's Cohere core on the PyTorch port against the JAX
package, on the CPU: whole sessions' event sequences under one injected
clock (kinds, texts, confirmed texts, the stats the clock decides and the
promotion state), window finalization with overlap, the JAX tests'
``test_cohere_streaming_core`` and ``test_cohere_confirmed_prefix_is_preserved``,
and ``cli/stt.py --stream`` on a Cohere model.

The model is ``test_torch_cohere``'s seeded-normal copy of the fixture with
eos made likely, in f32 in both packages.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from tpu_audio.models.stt import streaming as JS
from tpu_audio_torch.models.stt import streaming as TS

from fixtures import make_cohere_fixture
from test_torch_cohere import _cli_models, _models, _raise_eos, _write

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohere_stream")
    d = _raise_eos(_write(shutil.copytree(make_cohere_fixture(root / "fixture"), root / "eos"),
                          seed=7))
    return d, _models(d)


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _events(events):
    return [(e.kind.value, e.text, e.confirmed_text) for e in events]


SESSIONS = {
    # the JAX test's session: 1 s feeds, every pass promotes
    "promote": (dict(delay_seconds=0.0, min_agreement_passes=1, decode_interval_seconds=0.5,
                     max_tokens_per_pass=8), [(11, 16000, 1.0)] * 3),
    # agreement of two passes, passes held back by the interval
    "agree": (dict(delay_seconds=0.3, min_agreement_passes=2, decode_interval_seconds=1.0,
                   max_tokens_per_pass=6), [(4 + i, 6000, 0.4) for i in range(8)]),
    # past the 8 s window: a finalized window, then the overlap kept pending
    "window": (dict(delay_seconds=0.0, min_agreement_passes=1, decode_interval_seconds=1.0,
                    max_tokens_per_pass=6, encoder_window_overlap_seconds=0.5),
               [(20 + i, 32000, 0.6) for i in range(5)] + [(30, 56000, 0.6)]),
    # short feeds below half a second and silence
    "short": (dict(max_tokens_per_pass=5, decode_interval_seconds=0.1),
              [(None, 4000, 0.3), (30, 3000, 0.3), (31, 1000, 0.05), (None, 9000, 0.5)]),
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
def test_cohere_session_events_match_jax(models, name):
    """A whole session under one injected clock: the same event kinds,
    texts and confirmed texts, the same stats where the clock decides
    them, the same promotion state and pending audio."""
    _, (jm, tm) = models
    config, feeds = SESSIONS[name]
    ts, tev = _run_session(TS, tm, config, feeds)
    js, jev = _run_session(JS, jm, config, feeds)
    assert type(ts.core).__name__ == "_CohereStreamingCore"
    assert _events(tev) == _events(jev)
    assert [{k: e.stats[k] for k in CLOCKED} for e in tev if e.kind == TS.EventKind.STATS] == \
        [{k: e.stats[k] for k in CLOCKED} for e in jev if e.kind == JS.EventKind.STATS]
    assert ts.core.state.__dict__ == js.core.state.__dict__
    assert ts.core._passes == js.core._passes >= 1
    assert ts.core._finalized_windows == js.core._finalized_windows
    assert tev[-1].kind == TS.EventKind.ENDED and tev[-1].text == jev[-1].text
    if name == "window":
        assert ts.core._finalized_windows >= 2 and tev[-1].text
    if name == "promote":
        assert TS.EventKind.CONFIRMED in [e.kind for e in tev]


def test_cohere_streaming_core(models):
    """The JAX test's case: three 1 s feeds, then stop."""
    _, (_, tm) = models
    clock = FakeClock()
    config = TS.StreamingConfig(delay_seconds=0.0, min_agreement_passes=1,
                                decode_interval_seconds=0.5, max_tokens_per_pass=8)
    session = TS.StreamingInferenceSession(tm, config=config, clock=clock)
    sr = tm.config.sample_rate
    events = []
    for _ in range(3):
        events += session.feed_audio(_audio(11, sr))
        clock.advance(1.0)
    events += session.stop()
    kinds = [e.kind for e in events]
    assert kinds[-1] == TS.EventKind.ENDED and TS.EventKind.STATS in kinds
    assert isinstance(session.core.state.confirmed_ids, list)


def test_cohere_confirmed_prefix_is_preserved(models):
    """The JAX test's case: ``streaming_decode_token_ids`` returns ids
    that start with the forced confirmed prefix, as the JAX package's."""
    _, (jm, tm) = models
    audio = _audio(13, tm.config.sample_rate)
    cfg = TS.StreamingConfig(max_tokens_per_pass=8)
    ids, _ = tm.streaming_decode_token_ids(audio, cfg, [])
    assert ids == jm.streaming_decode_token_ids(audio, JS.StreamingConfig(max_tokens_per_pass=8),
                                                [])[0]
    assert len(ids) >= 2
    prefix = ids[:2]
    ids2, _ = tm.streaming_decode_token_ids(audio, cfg, prefix)
    assert ids2[:2] == prefix


def test_cli_stream_drives_the_cohere_session_as_jax(models, tmp_path, capsys, monkeypatch):
    """``--stream`` on a Cohere model runs the live session at 1 s feeds
    (each package's session on a clock that moves 0.7 s a reading, both
    models in f32, 4 tokens a pass; the JAX CLI gets the cached model): the same confirmed lines, display
    updates, passes and JSON as the JAX CLI."""
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio_torch.cli import stt as tstt

    d, _ = models
    wav = tmp_path / "in.wav"
    save_wav(wav, _audio(30, 4 * 16000), 16000)
    _cli_models(monkeypatch)
    for mod in (TS, JS):
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
