"""Orpheus continuous-batching serving on the PyTorch port against the JAX
package, on the CPU at small sizes: the engine's default llama step,
``ContinuousTTS`` on the plain tick (dense fixture, band head on and off)
and on the fused tick (a w8a8 tree of a kernel-supported shape, which runs
``fused_llama_stack_lanes``' plain version here), the bounded SNAC decode
window, ``TTSEngineWorker`` and the speech routes of ``cli.serve``.

Greedy tokens are held equal to the JAX package's engines; streamed sample
counts too (the waveforms differ: SNAC's noise blocks draw from another
generator). The JAX package's fused lanes kernel runs as its own tests run
it: in interpret mode, selected with ``TPU_AUDIO_FUSED_LLAMA=interpret``
(``0`` selects its XLA tick).
"""

import io
import json
import threading
import urllib.request
import wave
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.models import llama as JL
from tpu_audio.models.tts import llama_tts as JT
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio.parallel import continuous as JC
from tpu_audio_torch.codecs.snac import SNAC as TSNAC
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationKind
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.tts import llama_tts as TT
from tpu_audio_torch.models.tts import load_model as tload_model
from tpu_audio_torch.ops import fused_llama as TFL
from tpu_audio_torch.parallel import continuous as TC

from fixtures import make_llama_tts_fixture, make_snac_fixture
from test_torch_ops import jax_tree_to_numpy
from test_torch_tts import FUSED, SMALL_TOKENS, _tokenizer

torch.set_num_threads(1)

STOP = 7
# tests/test_continuous.py:16's tiny tree
TINY = dict(hidden_size=64, num_hidden_layers=2, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=96,
            rope_theta=10000.0, tie_word_embeddings=True)
# tests/test_continuous.py:463's generation parameters
GREEDY = dict(max_tokens=21, temperature=0.0, top_p=1.0, repetition_penalty=1.3,
              repetition_context_size=8, streaming_interval=0.02)
TEXTS = ["hello world", "a much longer second sentence to say"]


@pytest.fixture(scope="module")
def tts_dir(tmp_path_factory):
    """tests/test_continuous.py:435's fixture: the tiny Orpheus checkpoint
    with its SNAC codec beside it."""
    model_dir = make_llama_tts_fixture(tmp_path_factory.mktemp("orpheus") / "m")
    make_snac_fixture(model_dir / "snac", vq_strides=(4, 2, 1))
    cfg = json.loads((model_dir / "config.json").read_text())
    cfg["snac_repo"] = str(model_dir / "snac")
    (model_dir / "config.json").write_text(json.dumps(cfg))
    return model_dir


def _port(tts_dir, band=False):
    return tload_model(str(tts_dir), dtype=torch.float32, device="cpu", audio_band_head=band,
                       codec=TSNAC.from_pretrained(str(tts_dir / "snac"), device="cpu"))


def _drain(srv, texts, **submit_kw):
    """Submit one text, step, submit the rest, drain: each request's tokens
    and streamed sample count."""
    reqs = [srv.submit(texts[0], **submit_kw)]
    events = list(srv.step())
    reqs += [srv.submit(t, **submit_kw) for t in texts[1:]]
    events += list(srv.run())
    samples = {r.request_id: 0 for r in reqs}
    for rid, ev in events:
        if ev.kind == AudioGenerationKind.AUDIO:  # the JAX package's kind compares equal
            samples[rid] += len(np.asarray(ev.audio))
    return [list(r.tokens) for r in reqs], [samples[r.request_id] for r in reqs]


def test_default_llama_step_matches_jax_engine():
    """The engine built with a llama config and no step function (the JAX
    package's default step): three staggered greedy requests through two
    lanes give the JAX engine's tokens (mirrors tests/test_continuous.py:44)."""
    jp = JL.init_random_params(JL.LlamaConfig(**TINY), seed=0, dtype=jnp.float32)
    tp = from_jax_params(jax_tree_to_numpy(jp))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(8, 96, size=n).astype(np.int32) for n in (5, 11, 8)]

    def run(engine_cls, params, cfg):
        eng = engine_cls(params, cfg, slots=2, max_len=64, stop_token=STOP,
                         prefill_buckets=(8, 16))
        reqs = [eng.submit(prompts[0], max_new=10)]
        eng.step()
        eng.step()
        reqs.append(eng.submit(prompts[1], max_new=12))
        eng.step()
        reqs.append(eng.submit(prompts[2], max_new=8))
        for _ in eng.run():
            pass
        assert all(r.done for r in reqs)
        return [list(r.tokens) for r in reqs]

    got = run(TC.ContinuousBatcher, tp, TL.LlamaConfig(**TINY))
    assert got == run(JC.ContinuousBatcher, jp, JL.LlamaConfig(**TINY))
    assert [len(t) for t in got] == [10, 12, 8]


def test_engine_token_map_and_pad_token():
    """``token_map`` maps the sampled index to the emitted and fed-back id
    while the repetition ring keeps the index; prompts are left-padded
    with ``pad_token``."""
    seen = {}

    class Cache:
        def __init__(self, slots):
            self.offset = torch.zeros((slots,), dtype=torch.int64)

    def prefill(params, cache, slot, ids, valid_from, ctx):
        seen["ids"], seen["valid_from"] = ids.tolist(), valid_from
        return len(ids)

    def step(params, cache, lanes, last, offsets, ctx):
        seen.setdefault("fed", []).append(int(last[0]))
        logits = torch.zeros((lanes.shape[0], 5))
        logits[:, 3] = 1.0
        return logits

    eng = TC.ContinuousBatcher({}, slots=1, max_len=32, prefill_buckets=(6,), pad_token=9,
                               sampling=TC.SamplingParams(temperature=0.0,
                                                          repetition_penalty=1.5,
                                                          repetition_context_size=4),
                               batch_step_fn=step, prefill_fn=prefill, cache_factory=Cache,
                               token_map=lambda idx: idx + 100)
    req = eng.submit(np.asarray([1, 2, 3], np.int32), max_new=3)
    list(eng.run())
    assert seen["ids"] == [9, 9, 9, 1, 2] and seen["valid_from"] == 3
    # the penalty divides index 3's logit 1.0 by 1.5: still the argmax
    assert req.tokens == [103, 103, 103] and seen["fed"] == [3, 103, 103]
    assert eng._state.hist[0, :3].tolist() == [3, 3, 3]


@pytest.mark.parametrize("band", [False, True])
def test_continuous_tts_matches_jax(tts_dir, band):
    """Two staggered greedy requests through ContinuousTTS (the plain tick:
    a dense tree), band head off and on: the JAX package's ContinuousTTS
    tokens and streamed sample counts, which are also the port's solo
    generate_stream's (mirrors tests/test_continuous.py:450)."""
    model = _port(tts_dir, band)
    srv = TC.ContinuousTTS(model, slots=2, generation_parameters=TParams(**GREEDY))
    assert not srv.fused
    got = _drain(srv, TEXTS)
    jmodel = jload_model(str(tts_dir), dtype=jnp.float32, audio_band_head=band)
    want = _drain(JC.ContinuousTTS(jmodel, slots=2, generation_parameters=JParams(**GREEDY)),
                  TEXTS)
    assert got == want
    solo = []
    for text in TEXTS:
        events = list(model.generate_stream(text, generation_parameters=TParams(**GREEDY)))
        solo.append([e.token for e in events if e.kind == AudioGenerationKind.TOKEN])
    assert got[0] == solo
    if band:
        assert all(n > 0 for n in got[1])


def test_continuous_tts_windowed_decode_long_request(tts_dir):
    """A long request decodes a bounded suffix window a flush: the tokens
    stay, the streamed sample count equals the whole-prefix decode's, and
    the samples before the window engages are the same (mirrors
    tests/test_continuous.py:500)."""
    model = _port(tts_dir, band=True)
    params = TParams(**dict(GREEDY, max_tokens=70, streaming_interval=0.001))

    def collect(srv):
        req = srv.submit("a long windowed test")
        chunks = [np.asarray(ev.audio) for _, ev in srv.run()
                  if ev.kind == AudioGenerationKind.AUDIO]
        return list(req.tokens), np.concatenate(chunks)

    tok_full, wav_full = collect(TC.ContinuousTTS(model, slots=1, generation_parameters=params))
    win = TC.ContinuousTTS(model, slots=1, generation_parameters=params)
    win.decode_window_groups, win._align_groups = 4, 2  # 10 groups in all
    tok_win, wav_win = collect(win)
    assert tok_win == tok_full and len(tok_full) == 70
    assert wav_win.shape == wav_full.shape
    np.testing.assert_array_equal(wav_win[:2 * win._spg], wav_full[:2 * win._spg])
    assert np.isfinite(wav_win).all()


def test_continuous_tts_fused_tick_matches_both_jax_modes(monkeypatch):
    """A w8a8 tree of a kernel-supported shape takes the fused tick (the
    plain lanes version on the CPU, one call a decode step for every live
    lane) and gives the same greedy tokens for staggered requests as the
    JAX package's fused tick (its kernel interpreted) and its XLA tick
    (mirrors tests/test_continuous.py:672)."""
    cfg_kw = dict(FUSED, max_position_embeddings=256)
    jparams = jquant.quantize_tree(JL.init_random_params(JL.LlamaConfig(**cfg_kw), seed=13,
                                                         dtype=jnp.float32), scheme="w8a8")
    tparams = from_jax_params(jax_tree_to_numpy(jparams))
    codec = SimpleNamespace(config=None, decode=lambda codes: np.zeros(
        (1, 2048 * max(1, len(codes[0][0]))), np.float32))
    tcodec = SimpleNamespace(config=None, decode=lambda codes: torch.zeros(
        (1, 2048 * max(1, len(codes[0][0])))))
    kw = dict(slots=2, prefill_buckets=(16, 32), step_tokens=2, max_len=64)

    def run(srv):
        reqs = [srv.submit("hello there")]
        srv.step()
        reqs += [srv.submit("hi"), srv.submit("a third request queues")]
        while not srv.idle:
            srv.step()
        return [list(srv.engine.requests[r.request_id].tokens) for r in reqs]

    calls = []
    lanes_fn = TFL.fused_llama_stack_lanes

    def counted(*a, **k):
        calls.append(a[4].shape[0])
        return lanes_fn(*a, **k)

    monkeypatch.setattr(TFL, "fused_llama_stack_lanes", counted)
    model = TT.LlamaTTS(TT.LlamaTTSConfig(**cfg_kw), tparams, tokenizer=_tokenizer(),
                        codec=tcodec, tokens=TT.OrpheusTokens(**SMALL_TOKENS),
                        dtype=torch.float32)
    srv = TC.ContinuousTTS(model, generation_parameters=TParams(
        max_tokens=6, temperature=0.0, repetition_penalty=1.0), **kw)
    assert srv.fused
    got = run(srv)
    assert calls and max(calls) == 2 and 1 in calls
    want = []
    for mode in ("interpret", "0"):
        monkeypatch.setenv("TPU_AUDIO_FUSED_LLAMA", mode)
        jm = JT.LlamaTTS(JT.LlamaTTSConfig(**cfg_kw), jparams, tokenizer=_tokenizer(),
                         codec=codec, tokens=JT.OrpheusTokens(**SMALL_TOKENS),
                         dtype=jnp.float32)
        jsrv = JC.ContinuousTTS(jm, generation_parameters=JParams(
            max_tokens=6, temperature=0.0, repetition_penalty=1.0), **kw)
        assert jsrv.fused == (mode == "interpret")
        want.append(run(jsrv))
    assert got == want[0] == want[1]
    assert all(len(t) == 6 for t in got)


def test_fused_tick_runs_lane_groups_past_the_lane_limit(monkeypatch):
    """Past the kernel's lane limit the fused tick runs the live lanes in
    groups of the largest n it takes, one call a group. With the limit
    forced to 2 lanes, every step of 3 live lanes makes two calls (2 + 1
    lanes), and the greedy tokens equal the one-group run's and the JAX
    package's fused tick's (its kernel interpreted)."""
    jparams = jquant.quantize_tree(JL.init_random_params(JL.LlamaConfig(**FUSED), seed=13,
                                                         dtype=jnp.float32), scheme="w8a8")
    tparams = from_jax_params(jax_tree_to_numpy(jparams))
    codec = SimpleNamespace(config=None, decode=lambda codes: np.zeros(
        (1, 2048 * max(1, len(codes[0][0]))), np.float32))
    kw = dict(slots=3, prefill_buckets=(16, 32), step_tokens=2, max_len=64)
    texts = ["hello there", "hi", "a third request"]

    def run(srv):
        reqs = [srv.submit(t) for t in texts]
        while not srv.idle:
            srv.step()
        return [list(srv.engine.requests[r.request_id].tokens) for r in reqs]

    calls = []
    lanes_fn = TFL.fused_llama_stack_lanes

    def counted(*a, **k):
        calls.append(a[4].shape[0])
        return lanes_fn(*a, **k)

    monkeypatch.setattr(TFL, "fused_llama_stack_lanes", counted)

    def served(limit):
        if limit is not None:
            monkeypatch.setattr(TFL, "supported_lanes", lambda cfg, n: 1 <= n <= limit)
        model = TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), tparams, tokenizer=_tokenizer(),
                            codec=SimpleNamespace(config=None, decode=lambda codes: torch.zeros(
                                (1, 2048 * max(1, len(codes[0][0]))))),
                            tokens=TT.OrpheusTokens(**SMALL_TOKENS), dtype=torch.float32)
        srv = TC.ContinuousTTS(model, generation_parameters=TParams(
            max_tokens=6, temperature=0.0, repetition_penalty=1.0), **kw)
        assert srv.fused
        steps, inner = [], srv.engine._batch_step_fn

        def step(params, cache, lanes, last, offsets, ctx):
            before = len(calls)
            out = inner(params, cache, lanes, last, offsets, ctx)
            steps.append((last.shape[0], calls[before:]))
            return out

        srv.engine._batch_step_fn = step
        return run(srv), steps

    one, one_steps = served(None)
    got, steps = served(2)
    assert got == one and all(len(t) == 6 for t in got)
    assert all(ns == [live] for live, ns in one_steps)
    assert any(live == 3 for live, _ in steps)
    assert all(ns == {1: [1], 2: [2], 3: [2, 1]}[live] for live, ns in steps)
    monkeypatch.setenv("TPU_AUDIO_FUSED_LLAMA", "interpret")
    jm = JT.LlamaTTS(JT.LlamaTTSConfig(**FUSED), jparams, tokenizer=_tokenizer(), codec=codec,
                     tokens=JT.OrpheusTokens(**SMALL_TOKENS), dtype=jnp.float32)
    jsrv = JC.ContinuousTTS(jm, generation_parameters=JParams(
        max_tokens=6, temperature=0.0, repetition_penalty=1.0), **kw)
    assert jsrv.fused
    assert got == run(jsrv)


def test_fused_tick_equals_offline_fused_generation():
    """Each request served through the fused tick gives the tokens of the
    offline fused route (``LlamaTTS._run_generation``, kernel 5's plain
    version) alone, greedy with repetition penalty."""
    params = jquant.quantize_tree(JL.init_random_params(JL.LlamaConfig(**FUSED), seed=14,
                                                        dtype=jnp.float32), scheme="w8a8")
    model = TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), from_jax_params(jax_tree_to_numpy(params)),
                        tokenizer=_tokenizer(), codec=SimpleNamespace(config=None),
                        tokens=TT.OrpheusTokens(**SMALL_TOKENS), dtype=torch.float32)
    gen = TParams(max_tokens=8, temperature=0.0, repetition_penalty=1.3)
    srv = TC.ContinuousTTS(model, slots=3, generation_parameters=gen, step_tokens=3)
    assert srv.fused
    texts = ["hi there", "bye", "one more line"]
    reqs = [srv.submit(t) for t in texts]
    while not srv.engine.idle:
        srv.engine.step()
    for text, req in zip(texts, reqs):
        *_, (_, _, plen, toks) = list(model._run_generation(text, None, None, None, gen, 8))[-1]
        assert req.tokens == toks[plen:]


def test_w8a8_tts_serving_on_cuda_raises(monkeypatch):
    """On CUDA a w8a8 tree serves only through the lanes kernel: fused="off"
    raises, and so does a tree the kernel does not take; on the CPU both
    serve through the plain tick. The route is decided before anything is
    put on the device."""
    params = jquant.quantize_tree(JL.init_random_params(JL.LlamaConfig(**FUSED), seed=11,
                                                        dtype=jnp.float32), scheme="w8a8")
    tparams = from_jax_params(jax_tree_to_numpy(params))

    def model(tree):
        return TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), tree, tokenizer=_tokenizer(),
                           codec=SimpleNamespace(config=None),
                           tokens=TT.OrpheusTokens(**SMALL_TOKENS), dtype=torch.float32)

    fused_proj = TL.fuse_projections({"model": dict(tparams["model"])})
    gen = TParams(max_tokens=4)
    assert not TC.ContinuousTTS(model(tparams), fused="off", generation_parameters=gen).fused
    assert not TC.ContinuousTTS(model(fused_proj), generation_parameters=gen).fused
    monkeypatch.setattr(TT.LlamaTTS, "device", property(lambda self: torch.device("cuda")))
    with pytest.raises(ValueError, match="fused_llama_stack_lanes"):
        TC.ContinuousTTS(model(tparams), fused="off", generation_parameters=gen)
    with pytest.raises(NotImplementedError, match="fused_llama_stack kernels"):
        TC.ContinuousTTS(model(fused_proj), generation_parameters=gen)


def test_worker_concurrent_callers(tts_dir):
    """Threaded callers each get their solo greedy stream; a rejected
    request raises in its own caller only; close() drains and releases
    every request (mirrors tests/test_continuous.py:584)."""
    model = _port(tts_dir, band=True)
    params = TParams(**GREEDY)

    def solo(text):
        toks, samples = [], 0
        for ev in model.generate_stream(text, generation_parameters=params):
            if ev.kind == AudioGenerationKind.TOKEN:
                toks.append(ev.token)
            elif ev.kind == AudioGenerationKind.AUDIO:
                samples += len(ev.audio)
        return toks, samples

    expected = [solo(t) for t in TEXTS]
    worker = TC.TTSEngineWorker(model, slots=2, generation_parameters=params)
    results = {}

    def call(i):
        toks, samples = [], 0
        for ev in worker.synthesize(TEXTS[i]):
            if ev.kind == AudioGenerationKind.TOKEN:
                toks.append(ev.token)
            elif ev.kind == AudioGenerationKind.AUDIO:
                samples += len(ev.audio)
        results[i] = (toks, samples)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(TEXTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [results[0], results[1]] == expected and results[0][1] > 0
    with pytest.raises(ValueError):
        list(worker.synthesize(TEXTS[0], max_tokens=-1))
    for _ in worker.synthesize(TEXTS[0]):
        pass
    worker.close()
    assert worker._srv.engine.requests == {}
    with pytest.raises(RuntimeError):
        next(worker.synthesize("after close"))


def test_worker_generator_close_cancels(tts_dir):
    """Abandoning a synthesize() generator (a client hang-up) cancels the
    request in the engine; the worker keeps serving (mirrors
    tests/test_continuous.py:338)."""
    model = _port(tts_dir, band=True)
    worker = TC.TTSEngineWorker(model, slots=1, generation_parameters=TParams(
        **dict(GREEDY, max_tokens=35)))
    gen = worker.synthesize("a sentence that will be abandoned")
    next(gen)
    gen.close()
    toks = [ev.token for ev in worker.synthesize("hello world")
            if ev.kind == AudioGenerationKind.TOKEN]
    assert len(toks) > 0
    worker.close()
    assert worker._srv.idle
    assert all(r.done for r in worker._srv.engine.requests.values())


def test_worker_engine_death_unblocks_callers(tts_dir):
    """An engine thread that dies mid-step hands the failure to the waiting
    caller, and the worker refuses new work (mirrors
    tests/test_continuous.py:369)."""
    worker = TC.TTSEngineWorker(_port(tts_dir), slots=1, generation_parameters=TParams(
        max_tokens=30, temperature=0.0, top_p=1.0, repetition_penalty=1.0,
        streaming_interval=0.02))
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


@pytest.mark.parametrize("slots", [1, 2])
def test_serve_speech_routes(tts_dir, slots):
    """build_server(model, "tts"): two concurrent POSTs to /v1/audio/speech
    and one to /stream each return 200 with the audio of the request's
    greedy tokens alone (whole 7-token frames); slots=1 serves through the
    model under the lock, slots=2 through TTSEngineWorker."""
    from tpu_audio_torch.cli.serve import build_server

    model = _port(tts_dir, band=True)
    model.default_generation_parameters = lambda: TParams(**GREEDY)
    srv = build_server(model, "tts", "fixture", port=0, slots=slots,
                       generation_parameters=TParams(**GREEDY))
    assert (srv.tts_worker is not None) == (slots > 1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    bodies = [("/v1/audio/speech", TEXTS[0]), ("/v1/audio/speech", TEXTS[1]),
              ("/v1/audio/speech/stream", TEXTS[0])]
    results = {}
    try:
        def post(i):
            route, text = bodies[i]
            req = urllib.request.Request(url + route, data=json.dumps(
                {"input": text, "max_tokens": 21}).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, r.headers["Content-Type"], r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if slots > 1:
        assert not srv.tts_worker._thread.is_alive()
    spg = 4 * model.codec.config.hop_length  # samples of a 7-token frame
    for i, (route, text) in enumerate(bodies):
        status, ctype, data = results[i]
        assert status == 200
        want = model.generate(text, generation_parameters=TParams(**GREEDY))
        if route.endswith("/stream"):
            assert ctype == f"audio/L16; rate={model.sample_rate}"
            n = len(data) // 2
        else:
            assert ctype == "audio/wav"
            with wave.open(io.BytesIO(data)) as w:
                assert w.getframerate() == model.sample_rate
                n = w.getnframes()
        assert n == want.shape[0] and n > 0 and n % spg == 0
    assert health == {"ok": True, "task": "tts", "model": "fixture"}


def test_serve_cli_detects_the_task(tts_dir, tmp_path):
    """--task auto finds a checkpoint's task through the port's STT and TTS
    registries; a model type in neither stops with a message."""
    from fixtures import make_whisper_fixture
    from tpu_audio_torch.cli import serve

    assert serve.detect_task(str(tts_dir)) == "tts"
    assert serve.detect_task(str(make_whisper_fixture(tmp_path / "w"))) == "stt"
    (tmp_path / "x").mkdir()
    (tmp_path / "x" / "config.json").write_text(json.dumps({"model_type": "kokoro"}))
    assert serve.detect_task(str(tmp_path / "x")) is None
    with pytest.raises(SystemExit, match="cannot infer"):
        serve.main(["--model", str(tmp_path / "x")])
