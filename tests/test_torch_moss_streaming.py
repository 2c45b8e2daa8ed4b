"""The streaming session's MOSS-Transcribe-Diarize core on the PyTorch port
against the JAX package, on the CPU: a whole session's events under one
injected clock (partial passes over the pending tail with their token
caps, finalized windows joined with newlines, ``stop``'s tail), the JAX
test ``test_moss_streaming_core``, and ``cli/stt.py --stream`` on the MOSS
fixture.

The model is the fixture checkpoint in f32 in both packages: its periodic
weights end every pass at the degenerate-tail guard, so the final passes,
which take no token cap, stay short.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.models.stt import moss_diarize as JM
from tpu_audio.models.stt import streaming as JS
from tpu_audio_torch.models.stt import moss_diarize as TM
from tpu_audio_torch.models.stt import streaming as TS

from fixtures import make_moss_diarize_fixture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = make_moss_diarize_fixture(tmp_path_factory.mktemp("moss_stream") / "m")
    return d, (JM.MossTranscribeDiarize.from_pretrained(str(d), dtype=jnp.float32),
               TM.MossTranscribeDiarize.from_pretrained(str(d), dtype=torch.float32,
                                                        device="cpu"))


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


CLOCKED = ("encoded_window_count", "audio_seconds", "wall_seconds", "real_time_factor",
           "decode_passes")
# 4 s windows and 2 s feeds: partial passes over 2 s (capped at 48 tokens)
# between two finalized windows, then stop's 2 s tail (no cap); three pass
# shapes in all, so each package compiles or traces three
FEEDS = [(5 + i, 32000, 2.0) for i in range(5)]
CONFIG = dict(decode_interval_seconds=1.0, max_decode_windows=1)


def _run_session(mod, model, config, feeds, passes):
    clock = FakeClock()
    session = mod.StreamingInferenceSession(model, config=mod.StreamingConfig(**config),
                                            clock=clock)
    window = model.streaming_transcribe_window

    def spy(samples, offset_seconds=0.0, language=None, max_tokens=None):
        passes.append((len(samples), offset_seconds, max_tokens))
        return window(samples, offset_seconds=offset_seconds, language=language,
                      max_tokens=max_tokens)

    session.core.model = type("Spy", (), {"streaming_transcribe_window": staticmethod(spy),
                                          "sample_rate": model.sample_rate})()
    events = []
    for seed, n, dt in feeds:
        events += session.feed_audio(_audio(seed, n))
        clock.advance(dt)
    events += session.stop()
    return session, events


def test_moss_session_events_match_jax(models):
    """A whole session under one clock: the same passes (lengths, offsets,
    token caps), event kinds, texts and confirmed texts, the same stats
    where the clock decides them and the same completed text: three
    partial passes, two finalized windows and the final pass at
    ``stop``."""
    _, (jm, tm) = models
    tp, jp = [], []
    ts, tev = _run_session(TS, tm, CONFIG, FEEDS, tp)
    js, jev = _run_session(JS, jm, CONFIG, FEEDS, jp)
    assert type(ts.core).__name__ == "_MossStreamingCore"
    assert tp == jp
    assert tp == [(32000, 0.0, 48), (64000, 0.0, None), (32000, 4.0, 48), (64000, 4.0, None),
                  (32000, 8.0, 48), (32000, 8.0, None)]
    assert [(e.kind.value, e.text, e.confirmed_text) for e in tev] == \
        [(e.kind.value, e.text, e.confirmed_text) for e in jev]
    assert [{k: e.stats[k] for k in CLOCKED} for e in tev if e.kind == TS.EventKind.STATS] == \
        [{k: e.stats[k] for k in CLOCKED} for e in jev if e.kind == JS.EventKind.STATS]
    assert (ts.core.completed_text, ts.core._passes, ts.core._finalized_windows) == \
        (js.core.completed_text, js.core._passes, js.core._finalized_windows)
    assert ts.core._finalized_windows == 3 and ts.core.completed_text.count("\n") == 2
    assert tev[-1].kind == TS.EventKind.ENDED and tev[-1].text == ts.core.completed_text


def test_moss_streaming_core(models):
    """The JAX test's case: three 1.5 s feeds, then stop."""
    _, (_, tm) = models
    clock = FakeClock()
    config = TS.StreamingConfig(decode_interval_seconds=1.0, max_decode_windows=1)
    session = TS.StreamingInferenceSession(tm, config=config, clock=clock)
    events = []
    for _ in range(3):
        events += session.feed_audio(_audio(17, int(tm.sample_rate * 1.5)))
        clock.advance(1.5)
    events += session.stop()
    assert events[-1].kind == TS.EventKind.ENDED
    assert session.core._passes >= 1


def test_cli_stream_runs_the_moss_session(models, tmp_path, capsys):
    """``--stream`` on the MOSS fixture runs the live session at 1 s feeds:
    the final text, the ``[stream]`` line with its passes, and the JSON."""
    from tpu_audio_torch.cli import stt
    from tpu_audio_torch.core.audio_io import save_wav

    d, _ = models
    wav = tmp_path / "in.wav"
    save_wav(wav, _audio(30, 5 * 16000), 16000)
    out = tmp_path / "o.json"
    assert stt.main([str(wav), "--model", str(d), "--stream", "--device", "cpu",
                     "--format", "json", "--output", str(out)]) == 0
    err = capsys.readouterr().err
    text = json.loads(out.read_text())["text"]
    assert text and "\n" in text
    line = next(x for x in err.splitlines() if x.startswith("[stream] RTF"))
    assert int(line.split("(")[1].split()[0]) >= 2
