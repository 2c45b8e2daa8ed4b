"""Qwen3-TTS serving on the PyTorch port against the JAX package, on the
CPU at small sizes in f32: ``ContinuousQwen3TTS`` (one lane-batched frame
a tick) against the JAX package's engine and the port's own solo
``generate_stream``, composition independence, lane reuse, cancel and
release, the refusals, ``Qwen3TTSEngineWorker`` and the server's speech
routes at several slots.

The checkpoints are ``test_torch_qwen3_tts``'s seeded-normal copies of the
fixture (its ``dirs`` and ``models`` fixtures): "rand" at the fixture's
widths and "q8", its MLX 8-bit copy (group size 8), whose products run
kernel 7's plain version here. Greedy codes are compared exactly; audio
within 1e-5 absolute (the codec's f32 sums in another order).
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.parallel.continuous_qwen3 import ContinuousQwen3TTS as JEngine
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationKind
from tpu_audio_torch.models.tts import qwen3_tts as TQ
from tpu_audio_torch.ops import qmm
from tpu_audio_torch.parallel.continuous_qwen3 import (ContinuousQwen3TTS,
                                                       Qwen3TTSEngineWorker)

from test_torch_qwen3_tts import TEXT, dirs, models, tload_model  # noqa: F401 (fixtures)

torch.set_num_threads(1)

ATOL = 1e-5
HOP = 8  # samples a frame of the fixture's codec
GREEDY = dict(temperature=0.0, max_tokens=12, streaming_interval=0.4,
              repetition_penalty=1.05)
SAMPLED = dict(GREEDY, temperature=0.9, top_k=50)
TEXTS = [TEXT, "a much longer different sentence here", "one"]
VOICE = "vivian"


def _serve(engine, model, params, texts=TEXTS, slots=2, seeds=None, **kw):
    """``texts`` through ``engine(model, slots=...)``: each request's codes
    ``[frames, G]`` and its streamed audio, concatenated."""
    srv = engine(model, slots=slots, generation_parameters=params, **kw)
    reqs = [srv.submit(t, voice=VOICE, seed=(seeds or [0] * len(texts))[i])
            for i, t in enumerate(texts)]
    audio = {r.request_id: [] for r in reqs}
    for rid, wav in srv.run():
        audio[rid].append(np.asarray(wav))
    assert srv.idle and all(r.done for r in reqs)
    return [(np.stack(r.codes), np.concatenate(audio[r.request_id])) for r in reqs]


def _solo(model, text):
    """Solo ``generate_stream``'s greedy codes and streamed audio."""
    gp = TParams(**GREEDY)
    speaker, instruct = model._parse_voice(VOICE)
    *_, (_, payload) = model._run_iter(text, None, instruct, speaker, gp)
    chunks = [e.audio for e in model.generate_stream(text, voice=VOICE, generation_parameters=gp)
              if e.kind == AudioGenerationKind.AUDIO]
    return np.stack(payload[0]), np.concatenate(chunks)


@pytest.fixture(scope="module")
def served(models):
    """``served(which)``: TEXTS through two slots of the JAX engine and of
    the port's, and the port's solo runs; each built once."""
    built = {}

    def get(which):
        if which not in built:
            jm, tm = models(which)
            built[which] = {"jax": _serve(JEngine, jm, JParams(**GREEDY)),
                            "port": _serve(ContinuousQwen3TTS, tm, TParams(**GREEDY)),
                            "solo": [_solo(tm, t) for t in TEXTS]}
        return built[which]

    return get


# -- against the JAX engine and solo generate_stream ---------------------------------------


@pytest.mark.parametrize("which", ["rand", "q8"])
def test_served_codes_match_the_jax_engine(served, which):
    """Greedy codes frame for frame and group for group, three requests
    through two slots (lanes reused, the lone last request with a
    filler)."""
    runs = served(which)
    for (got, _), (want, _) in zip(runs["port"], runs["jax"]):
        assert got.shape == (GREEDY["max_tokens"], 4)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["rand", "q8"])
def test_served_audio_matches_the_jax_engine(served, which):
    runs = served(which)
    for (_, got), (_, want) in zip(runs["port"], runs["jax"]):
        assert got.shape == want.shape == (GREEDY["max_tokens"] * HOP,)
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("which", ["rand", "q8"])
def test_served_requests_match_solo_generate_stream(served, which):
    """Each served request's codes equal its solo ``generate_stream``
    codes, and its chunks (one every 5 frames and a flush) the solo
    stream's."""
    runs = served(which)
    for (codes, audio), (want_codes, want_audio) in zip(runs["port"], runs["solo"]):
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_allclose(audio, want_audio, atol=ATOL)


# -- the engine on its own -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_codes_do_not_depend_on_the_other_lanes(models, kw):
    """A request's codes alone in a 4-slot engine (a filler beside it) and
    packed with three others, staggered, are the same; greedy and
    sampled (keyed noise)."""
    tm = models("rand", jax=False)
    gp = TParams(**kw)
    (alone, _), = _serve(ContinuousQwen3TTS, tm, gp, [TEXT], slots=4, seeds=[5])
    srv = ContinuousQwen3TTS(tm, slots=4, generation_parameters=gp)
    first = [srv.submit(t, voice=VOICE, seed=s) for t, s in ((TEXTS[1], 1), (TEXT, 5))]
    srv.step()
    srv.step()
    later = [srv.submit(t, voice=VOICE, seed=s) for t, s in ((TEXTS[2], 2), ("w3 w9", 3))]
    for _ in srv.run():
        pass
    np.testing.assert_array_equal(np.stack(first[1].codes), alone)
    assert all(len(r.codes) > 0 for r in first + later)
    if kw is SAMPLED:  # the draws follow the request's seed
        (other, _), = _serve(ContinuousQwen3TTS, tm, gp, [TEXT], slots=4, seeds=[6])
        assert not np.array_equal(other, alone)


def test_frames_run_in_solo_generates_dtypes(dirs, monkeypatch):
    """On a bf16 model of the MLX tree (its packed codec embedding looks up
    f32 rows) a request's first frame runs the talker on its bf16 prompt
    row and its later frames in f32, frame for frame as solo ``generate``
    does; a tick that holds a first and a later frame runs one lane frame
    a dtype, each of at least two rows. The served greedy codes then equal
    solo's."""
    tm = tload_model(str(dirs["q8"]), dtype=torch.bfloat16, device="cpu")
    solo, ticks = [], []
    forward, lanes_forward = TQ.talker_forward, TQ.talker_lanes_forward

    def solo_spy(params, embeds, *a):
        solo.append(embeds.dtype)
        return forward(params, embeds, *a)

    def lanes_spy(params, embeds, *a):
        ticks[-1].append((embeds.shape[0], embeds.dtype))
        return lanes_forward(params, embeds, *a)

    monkeypatch.setattr(TQ, "talker_forward", solo_spy)
    monkeypatch.setattr(TQ, "talker_lanes_forward", lanes_spy)
    def solo_codes(text, frames):
        *_, (_, payload) = tm._run_iter(text, None, None, None,
                                        TParams(**dict(GREEDY, max_tokens=frames)))
        return np.stack(payload[0])

    want = [solo_codes(TEXT, 3)]
    assert solo == [torch.bfloat16, torch.float32, torch.float32]
    srv = ContinuousQwen3TTS(tm, slots=3, generation_parameters=TParams(**GREEDY))
    reqs = [srv.submit(TEXT, max_tokens=3)]
    for _ in range(2):
        ticks.append([])
        srv.step()
    reqs.append(srv.submit(TEXTS[1], max_tokens=2))
    ticks.append([])
    srv.step()
    assert ticks == [[(2, torch.bfloat16)], [(2, torch.float32)],
                     [(2, torch.float32), (2, torch.bfloat16)]]
    for _ in srv.run():
        pass
    want.append(solo_codes(TEXTS[1], 2))
    for req, codes in zip(reqs, want):
        np.testing.assert_array_equal(np.stack(req.codes), codes)


def test_unpipelined_ticks_give_the_same_codes(models, served):
    tm = models("rand", jax=False)
    got = _serve(ContinuousQwen3TTS, tm, TParams(**GREEDY), pipeline=False)
    for (codes, audio), (want_codes, want_audio) in zip(got, served("rand")["port"]):
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(audio, want_audio)


def test_lanes_are_reused_and_the_engine_drains(models):
    """Three requests through two slots drain to ``idle``; every request
    ends with whole frames of audio, and release forgets it."""
    tm = models("rand", jax=False)
    srv = ContinuousQwen3TTS(tm, slots=2, generation_parameters=TParams(**GREEDY))
    reqs = [srv.submit(t, seed=i) for i, t in enumerate(["one", "two", "three"])]
    samples = {r.request_id: 0 for r in reqs}
    for rid, wav in srv.run():
        samples[rid] += len(wav)
    assert srv.idle and all(r.done for r in reqs)
    assert all(len(r.codes) > 0 and samples[r.request_id] == len(r.codes) * HOP
               for r in reqs)
    for r in reqs:
        srv.release(r.request_id)
    assert srv.requests == {} and srv._meta == {}


def test_cancel_and_release(models):
    tm = models("rand", jax=False)
    srv = ContinuousQwen3TTS(tm, slots=2, generation_parameters=TParams(**GREEDY))
    a, b, c = (srv.submit(t) for t in TEXTS)
    srv.step()
    srv.release(a.request_id)  # still running: kept
    assert a.request_id in srv.requests
    assert srv.cancel(a.request_id) and srv.cancel(c.request_id)  # live, pending
    assert a.done and c.done and not srv.cancel(a.request_id)
    n = len(a.codes)
    for _ in srv.run():
        pass
    assert srv.idle and b.done and len(b.codes) == GREEDY["max_tokens"]
    assert len(a.codes) == n and c.codes == []
    srv.release(a.request_id)
    assert a.request_id not in srv.requests and b.request_id in srv.requests
    assert not srv.cancel(12345)


def test_refusals(models, monkeypatch):
    """Fewer than two slots; trailing text past ``max_trailing``; a prompt
    that pads past the lanes' caches; and on CUDA an MLX tree at more lanes
    than code-predictor pass 0 can send to kernel 7 (refused before
    anything is put on the device)."""
    tm = models("rand", jax=False)
    with pytest.raises(ValueError, match="slots >= 2"):
        ContinuousQwen3TTS(tm, slots=1)
    srv = ContinuousQwen3TTS(tm, slots=2, max_trailing=2)
    with pytest.raises(ValueError, match="max_trailing=2"):
        srv.submit(TEXT)
    with pytest.raises(ValueError, match="pads past max_len"):  # an instruction's rows
        ContinuousQwen3TTS(tm, slots=2, prefill_buckets=(16,), max_new_cap=8).submit(
            "one", instruct=" ".join(["w3"] * 30))
    q8 = models("q8", jax=False)
    monkeypatch.setattr(TQ.Qwen3TTS, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(ValueError, match="at most 32 lanes"):
        ContinuousQwen3TTS(q8, slots=33)


def test_a_tick_runs_every_product_once_over_its_lanes(models, monkeypatch):
    """On the MLX tree every product of a tick is one kernel-7 call over
    the tick's rows: the talker step's (4 a layer and the codec head) and
    each code-predictor pass's (4 a layer and a group head) at n rows, pass
    0's at 2n, with n >= 2 (a lone request runs beside a filler): the
    tile's rows on CUDA."""
    tm = models("q8", jax=False)
    L = tm.config.talker.num_hidden_layers
    Lc = tm.config.code_predictor.num_hidden_layers
    G = tm.config.talker.num_code_groups
    srv = ContinuousQwen3TTS(tm, slots=3, generation_parameters=TParams(**GREEDY))
    rows, ref = [], qmm.quantized_matvec

    def spy(x, *a, **k):
        rows.append(x.shape[0])
        return ref(x, *a, **k)

    launch = srv._launch

    def counted():
        rows.clear()
        out = launch()
        ticks.append(list(rows))
        return out

    ticks = []
    monkeypatch.setattr(qmm, "quantized_matvec", spy)
    srv._launch = counted
    srv.submit(TEXT, max_tokens=3)
    srv.step()
    srv.submit(TEXTS[1])
    srv.submit(TEXTS[2])
    for _ in srv.run():
        pass

    def frame(n):
        return [n] * (4 * L + 1) + [2 * n] * (4 * Lc + 1) + [n] * (G - 2) * (4 * Lc + 1)

    assert ticks[0] == frame(2) and frame(3) in ticks and ticks[-1] == frame(2)
    assert all(t in (frame(2), frame(3)) for t in ticks)


# -- the worker and the server ---------------------------------------------------------------


def test_worker_concurrent_callers(models, served):
    """Threaded callers each get their request's audio (that of the
    engine's run, greedy); a rejected request raises in its own caller
    only; close() drains and releases every request."""
    tm = models("rand", jax=False)
    worker = Qwen3TTSEngineWorker(tm, slots=2, generation_parameters=TParams(**GREEDY),
                                  max_trailing=16)
    results = {}

    def call(i):
        events = list(worker.synthesize(TEXTS[i], voice=VOICE))
        assert all(e.kind == AudioGenerationKind.AUDIO for e in events)
        results[i] = np.concatenate([e.audio for e in events])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(TEXTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for i, (_, want) in enumerate(served("rand")["port"]):
        np.testing.assert_allclose(results[i], want, atol=ATOL)
    with pytest.raises(ValueError, match="max_trailing=16"):
        list(worker.synthesize(" ".join(["word"] * 20)))
    assert len(list(worker.synthesize("one"))) > 0
    worker.close()
    assert worker._srv.requests == {} and worker._srv.idle
    with pytest.raises(RuntimeError):
        next(worker.synthesize("after close"))


def test_worker_generator_close_cancels(models):
    """Abandoning a synthesize() generator (a client hang-up) cancels the
    request in the engine; the worker keeps serving."""
    tm = models("rand", jax=False)
    worker = Qwen3TTSEngineWorker(tm, slots=2, generation_parameters=TParams(
        **dict(GREEDY, max_tokens=40, streaming_interval=0.08)))
    gen = worker.synthesize("a sentence that will be abandoned")
    next(gen)
    gen.close()
    assert len(list(worker.synthesize("hello world"))) > 0
    worker.close()
    assert worker._srv.idle and worker._srv.requests == {}


def test_worker_refuses_reference_audio(models):
    tm = models("rand", jax=False)
    worker = Qwen3TTSEngineWorker(tm, slots=2, generation_parameters=TParams(**GREEDY))
    try:
        for kw in ({"ref_audio": np.zeros(800, np.float32), "ref_text": "hi"},
                   {"ref_text": "hi"}):
            with pytest.raises(ValueError, match="CustomVoice"):
                next(worker.synthesize("hello", **kw))
    finally:
        worker.close()


def test_worker_engine_death_unblocks_callers(models):
    """An engine thread that dies mid-step hands the failure to the waiting
    caller, and the worker refuses new work."""
    tm = models("rand", jax=False)
    worker = Qwen3TTSEngineWorker(tm, slots=2, generation_parameters=TParams(
        **dict(GREEDY, max_tokens=30, streaming_interval=0.08)))
    calls = {"n": 0}
    orig = worker._srv.step

    def dying_step():
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device failure")
        return orig()

    worker._srv.step = dying_step
    with pytest.raises(RuntimeError, match="engine thread died"):
        for _ in worker.synthesize("this request will see the crash"):
            pass
    with pytest.raises(RuntimeError):
        next(worker.synthesize("rejected after death"))
    worker._thread.join(timeout=60)
    assert not worker._thread.is_alive()


def test_server_speaks_through_the_engine_at_several_slots(models, served):
    """``build_server(..., slots=2)`` serves a Qwen3-TTS model through
    ``Qwen3TTSEngineWorker``: concurrent POSTs to /v1/audio/speech and
    /v1/audio/speech/stream return the audio of each request's greedy
    codes; a reference-audio request is refused (500)."""
    from tpu_audio_torch.cli.serve import _wav_bytes, build_server

    tm = models("rand", jax=False)
    srv = build_server(tm, "tts", "q3", port=0, slots=2,
                       generation_parameters=TParams(**GREEDY))
    assert isinstance(srv.tts_worker, Qwen3TTSEngineWorker)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    bodies = [("/v1/audio/speech", 0), ("/v1/audio/speech/stream", 1),
              ("/v1/audio/speech/stream", 0)]
    results = {}

    def post(i):
        route, t = bodies[i]
        req = urllib.request.Request(url + route, data=json.dumps(
            {"input": TEXTS[t], "voice": VOICE}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            results[i] = (r.status, r.headers["Content-Type"], r.read())

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        ref = _wav_bytes(np.zeros(800, np.float32), tm.sample_rate)
        clone = json.dumps({"input": "hi", "ref_text": "hi",
                            "ref_audio_b64": base64.b64encode(ref).decode()}).encode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(url + "/v1/audio/speech",
                                                          data=clone), timeout=60)
        assert err.value.code == 500 and b"CustomVoice" in err.value.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert not srv.tts_worker._thread.is_alive()
    for i, (route, t) in enumerate(bodies):
        status, ctype, data = results[i]
        want = served("rand")["port"][t][1]
        assert status == 200
        if route.endswith("/stream"):
            assert ctype == f"audio/L16; rate={tm.sample_rate}"
            pcm = np.frombuffer(data, np.int16)
        else:
            assert ctype == "audio/wav"
            with wave.open(io.BytesIO(data)) as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        assert pcm.shape == want.shape
        np.testing.assert_allclose(pcm / 32767.0, want, atol=2 / 32767)
