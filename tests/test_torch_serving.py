"""Whisper continuous-batching serving on the PyTorch port against the JAX
package, on the CPU at small sizes: the engine (``ContinuousBatcher``),
the transcription front end (``ContinuousSTT``, fused and plain ticks), its
worker thread (``STTEngineWorker``) and the HTTP server (``cli.serve``).

Greedy tokens are held equal to the JAX package's ``ContinuousSTT`` and to
the port's own offline decode. Sampled tokens use the port's counter-based
noise (not JAX's threefry), so they are held to their contract instead: a
request's tokens depend on the request alone, and their frequencies follow
the softmax.
"""

import io
import json
import logging
import threading
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import quant as jquant
from tpu_audio.models.stt import whisper as JW
from tpu_audio.parallel.continuous_stt import ContinuousSTT as JContinuousSTT
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.core.sampling import SamplingParams, sample_keyed
from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.ops import fused_decoder as TF
from tpu_audio_torch.parallel import continuous as TC
from tpu_audio_torch.parallel.continuous_stt import ContinuousSTT, STTEngineWorker

from fixtures import FakeWhisperTokenizer, make_whisper_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

# the w8 fixture of tests/test_continuous_stt.py:140 (kernel-supported dims)
W8 = dict(num_mel_bins=80, d_model=256, encoder_layers=1,
          encoder_attention_heads=4, encoder_ffn_dim=1024, decoder_layers=2,
          decoder_attention_heads=4, decoder_ffn_dim=1024, vocab_size=128,
          max_source_positions=1500, max_target_positions=64)


def clip(seed: int, n: int = 8000) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.2


# prompts that make the rich model's tokens differ (its audio barely counts)
PROMPTS = [("en", "transcribe"), ("fr", "transcribe"), ("en", "translate"),
           ("fr", "translate")]


def offline_tokens(model, audio, language="en", task="transcribe", **kw) -> list[int]:
    """The port's offline decode of one window (``Whisper.generate``'s)."""
    tok = model.tokenizer
    suppress, begin = model._suppress_masks(tok)
    return model._transcribe_chunk(np.asarray(audio, np.float32),
                                   tok.build_prompt_tokens(language, task), suppress,
                                   begin, TParams(**kw))


def staggered(srv, clips, langs=None, tasks=None):
    """Submit one request, step, submit the rest, drain; the tokens of each
    request and the (request_id, token) stream the steps emitted."""
    langs = langs or ["en"] * len(clips)
    tasks = tasks or ["transcribe"] * len(clips)
    reqs = [srv.submit(clips[0], language=langs[0], task=tasks[0])]
    emitted = list(srv.step())
    reqs += [srv.submit(c, language=g, task=t)
             for c, g, t in zip(clips[1:], langs[1:], tasks[1:])]
    emitted += list(srv.engine.run())
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs], emitted


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """The dense checkpoint fixture, loaded by both packages in f32."""
    d = make_whisper_fixture(tmp_path_factory.mktemp("w") / "w")
    jm = JW.Whisper.from_pretrained(str(d), dtype=jnp.float32)
    jm.tokenizer = FakeWhisperTokenizer(vocab=jm.config.vocab_size)
    tm = TW.Whisper.from_pretrained(str(d), dtype=torch.float32, device="cpu")
    tm.tokenizer = FakeWhisperTokenizer(vocab=tm.config.vocab_size)
    return jm, tm


@pytest.fixture(scope="module")
def w8():
    """tests/test_continuous_stt.py's w8 model in both packages."""
    cfg = JW.WhisperConfig(**W8)
    params = JW.init_params(cfg, seed=5, dtype=jnp.float32)
    params["model"]["decoder"] = jquant.quantize_tree(
        params["model"]["decoder"], scheme="w8a8")
    jm = JW.Whisper(cfg, params, dtype=jnp.float32)
    jm.tokenizer = FakeWhisperTokenizer(vocab=cfg.vocab_size)
    tm = TW.Whisper(TW.WhisperConfig(**W8), from_jax_params(jax_tree_to_numpy(params)),
                    FakeWhisperTokenizer(vocab=cfg.vocab_size), dtype=torch.float32,
                    device="cpu")
    return jm, tm


def make_rich():
    """A port-only w8 model whose decoder weights are 5x init_params', so
    that its greedy tokens vary with the prompt (the w8 fixture's do not)."""
    cfg = TW.WhisperConfig(**W8)
    params = TW.init_params(cfg, seed=5, dtype=torch.float32)
    layers = params["model"]["decoder"]["layers"]

    def scale(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v)
            elif k == "weight" and v.ndim == 3:
                tree[k] = v * 5.0

    scale(layers)
    params["model"]["decoder"] = tquant.quantize_tree(params["model"]["decoder"])
    return TW.Whisper(cfg, params, FakeWhisperTokenizer(vocab=cfg.vocab_size),
                      dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def rich():
    return make_rich()


def test_continuous_stt_matches_jax_and_offline(dense):
    """Three staggered requests in two languages through two lanes (the
    dense model: the plain tick) give the JAX package's ContinuousSTT
    tokens and the port's own offline decode, token for token (mirrors
    tests/test_continuous_stt.py:48)."""
    jm, tm = dense
    clips = [clip(i, 12000) for i in range(3)]
    langs = ["en", "fr", "en"]
    srv = ContinuousSTT(tm, slots=2, max_tokens=12, step_tokens=3)
    assert not srv.fused
    got, _ = staggered(srv, clips, langs)
    jsrv = JContinuousSTT(jm, slots=2, max_tokens=12, step_tokens=3)
    jr = [jsrv.submit(clips[0], language=langs[0])]
    jsrv.step()
    jr += [jsrv.submit(c, language=g) for c, g in zip(clips[1:], langs[1:])]
    jsrv.drain()
    want = [jsrv.engine.requests[r.request_id].tokens for r in jr]
    assert got == want
    assert got == [offline_tokens(tm, c, g, max_tokens=12) for c, g in zip(clips, langs)]
    out = srv.result(0)
    assert out.generation_token_count == len(got[0]) and isinstance(out.text, str)
    with pytest.raises(KeyError):
        srv.result(999)


def test_w8_fused_and_plain_ticks_match_jax_xla_engine(w8, monkeypatch):
    """The port's fused tick, the port's plain tick and the JAX package's
    XLA w8 engine give the same greedy tokens (mirrors
    tests/test_continuous_stt.py:161)."""
    jm, tm = w8
    clips = [clip(10 + i) for i in range(3)]
    langs = ["en", "fr", "en"]
    kw = dict(slots=2, max_tokens=6, step_tokens=2, min_tick_tokens=2)
    monkeypatch.setenv("TPU_AUDIO_FUSED_DECODER", "0")
    jsrv = JContinuousSTT(jm, fused=False, **kw)
    jr = [jsrv.submit(clips[0], language="en")]
    jsrv.step()
    jr += [jsrv.submit(c, language=g) for c, g in zip(clips[1:], langs[1:])]
    jsrv.drain()
    want = [jsrv.engine.requests[r.request_id].tokens for r in jr]
    fused = ContinuousSTT(tm, **kw)
    plain = ContinuousSTT(tm, fused="off", **kw)
    assert fused.fused and not plain.fused
    assert staggered(fused, clips, langs)[0] == want
    assert staggered(plain, clips, langs)[0] == want


def test_fused_tick_matches_offline_fused_decode(rich):
    """On a model whose tokens vary: the fused tick equals the offline w8
    kv8d decode (the one-token kernel's numerics), the plain tick equals
    the offline w8 dense decode, request by request."""
    clips = [clip(20 + i) for i in range(3)]
    langs, tasks = zip(*PROMPTS[:3])
    for fused, kv in (("auto", dict(kv_bits=8, quantized_kv_start=448)), ("off", {})):
        srv = ContinuousSTT(rich, slots=2, max_tokens=10, step_tokens=3, fused=fused)
        got, _ = staggered(srv, clips, langs, tasks)
        assert got == [offline_tokens(rich, c, g, t, max_tokens=10, **kv)
                       for c, g, t in zip(clips, langs, tasks)]
        assert len(set(map(tuple, got))) == 3


def test_fused_cancel_midstream(rich):
    """Cancelling one request mid-stream under the fused tick frees its
    lane; the other request's tokens are those of a run without the cancel
    (mirrors tests/test_continuous_stt.py:271)."""
    a0, a1 = clip(30), clip(31)

    def run(cancel):
        srv = ContinuousSTT(rich, slots=2, max_tokens=8, step_tokens=2,
                            min_tick_tokens=2)
        assert srv.fused
        r0, r1 = srv.submit(a0), srv.submit(a1, *PROMPTS[3])
        srv.step()
        srv.step()
        if cancel:
            assert srv.cancel(r1.request_id)
            assert not srv.cancel(r1.request_id)
        srv.drain()
        assert srv.engine.idle
        return list(r0.tokens), list(r1.tokens)

    full, cut = run(False), run(True)
    assert cut[0] == full[0] and len(full[0]) == 8
    assert len(cut[1]) < len(full[1])
    assert cut[1] == full[1][:len(cut[1])]


@pytest.fixture(scope="module")
def sampled_base(rich):
    return _invariance_run(rich, step_tokens=1, pipeline=False, min_tick_tokens=None)


def _invariance_run(model, **kw):
    srv = ContinuousSTT(model, slots=2, max_tokens=9, temperature=0.8, seed=11, **kw)
    reqs = [srv.submit(clip(40 + i), *PROMPTS[i], seed=i) for i in range(3)]
    emitted = []
    while not srv.engine.idle:
        emitted += srv.step()
    return [list(r.tokens) for r in reqs], emitted


@pytest.mark.parametrize("step_tokens", [1, 3])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("min_tick_tokens", [None, 8])
def test_tick_shape_invariance(rich, sampled_base, step_tokens, pipeline,
                               min_tick_tokens):
    """Ticks of 1 or 3 steps, pipelined or not, with or without
    min_tick_tokens: sampled tokens (temperature 0.8) are identical, and
    the emitted stream carries exactly each request's tokens in order
    (mirrors tests/test_continuous.py:98, :133)."""
    base, _ = sampled_base
    toks, emitted = _invariance_run(rich, step_tokens=step_tokens, pipeline=pipeline,
                                    min_tick_tokens=min_tick_tokens)
    assert toks == base
    by_id = {i: [] for i in range(3)}
    for rid, tok in emitted:
        by_id[rid].append(tok)
    assert [by_id[i] for i in range(3)] == base
    assert all(len(t) > 0 for t in base)


def test_slot_reuse_more_requests_than_lanes(rich):
    """5 requests through 2 lanes: all complete within their budgets, and
    every request's tokens arrive through the shared stream (mirrors
    tests/test_continuous.py:193)."""
    srv = ContinuousSTT(rich, slots=2, max_tokens=5, step_tokens=2)
    reqs = [srv.submit(clip(50 + i), max_tokens=3 + i % 3) for i in range(5)]
    emitted = list(srv.engine.run())
    by_id = {r.request_id: [] for r in reqs}
    for rid, tok in emitted:
        by_id[rid].append(tok)
    for r in reqs:
        assert r.done and 0 < len(r.tokens) <= r.max_new
        assert by_id[r.request_id] == r.tokens
    assert srv.engine.idle


def test_submit_validation_and_out_of_int32_values(rich):
    """Bad submits raise on the caller's thread; seeds and budgets beyond
    int32 are canonicalised (mirrors tests/test_continuous.py:230, :242);
    the engine refuses context-less submits (tests/test_continuous_stt.py:76)."""
    srv = ContinuousSTT(rich, slots=1, max_tokens=6, temperature=0.8)
    eng = srv.engine
    ctx = tuple(torch.zeros(t.shape[1:], dtype=t.dtype) for t in eng._ctx)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32), max_new=4, context=ctx)
    with pytest.raises(ValueError):
        eng.submit(np.arange(4, dtype=np.int32), max_new=0, context=ctx)
    with pytest.raises(ValueError):
        eng.submit(np.arange(eng.max_len + 1, dtype=np.int32), max_new=2, context=ctx)
    with pytest.raises(ValueError, match="context"):
        eng.submit(np.asarray([1, 2, 3, 4], np.int32), max_new=2)
    big = srv.submit(clip(60), seed=2 ** 33 + 5, max_tokens=10 ** 12)
    small = srv.submit(clip(60), seed=5)
    srv.drain()
    assert big.seed == 5 and big.max_new == small.max_new == 6
    assert big.tokens == small.tokens and len(big.tokens) == 6


def test_engine_needs_a_step_function():
    """Without a step function the engine runs the default llama step,
    which needs the llama config."""
    with pytest.raises(ValueError, match="cfg for the default llama step"):
        TC.ContinuousBatcher({}, slots=1)


def test_coerce_fused_flag():
    assert all(TC.coerce_fused_flag(v) for v in ("auto", "1", "on", True))
    assert not any(TC.coerce_fused_flag(v)
                   for v in ("0", "off", "OFF", "false", "no", "none", "", False))


def test_fused_route_logs_why_not(dense, rich, caplog, monkeypatch):
    """A w8 model takes the fused tick at any slot count; otherwise "auto"
    logs one warning that names the reason, and "off" builds the plain tick
    quietly. On a CUDA device a w8 model never gets the plain tick: "off"
    and a shape the kernels do not take raise."""
    _, tm = dense
    with caplog.at_level(logging.WARNING, "tpu_audio_torch.parallel.continuous_stt"):
        caplog.clear()
        assert not ContinuousSTT(tm, slots=2, max_tokens=2).fused
        assert [r.message for r in caplog.records] == [
            "ContinuousSTT: no fused serving tick: the decoder weights are not "
            "int8 (w8a8); the plain per-lane tick serves instead"]
        caplog.clear()
        assert ContinuousSTT(rich, slots=TF.MAX_LANES + 1, max_tokens=2).fused
        assert not ContinuousSTT(rich, slots=2, max_tokens=2, fused="off").fused
        assert not ContinuousSTT(tm, slots=2, max_tokens=2, fused="off").fused
        assert caplog.records == []
        monkeypatch.setattr(TF, "supported", lambda cfg: False)
        assert not ContinuousSTT(rich, slots=2, max_tokens=2).fused
        assert len(caplog.records) == 1 and "decoder shape" in caplog.records[0].message
        # the route is decided before anything is put on the device
        monkeypatch.setattr(TW.Whisper, "device",
                            property(lambda self: torch.device("cuda")))
        with pytest.raises(ValueError, match="decoder shape"):
            ContinuousSTT(rich, slots=2, max_tokens=2)
        monkeypatch.undo()
        monkeypatch.setattr(TW.Whisper, "device",
                            property(lambda self: torch.device("cuda")))
        with pytest.raises(ValueError, match="fused_stack_lanes"):
            ContinuousSTT(rich, slots=2, max_tokens=2, fused="off")


def test_fused_tick_splits_lanes_past_the_kernel_limit(rich, monkeypatch):
    """With more live lanes than one kernel call takes (the limit cut to 2
    here), each step makes one call per group of at most that many lanes,
    and every request's tokens are still the offline fused decode's."""
    monkeypatch.setattr(TF, "MAX_LANES", 2)
    calls = []
    kernel = TF.fused_stack_lanes

    def counted(*a, **kw):
        calls.append(a[7].shape[0])
        return kernel(*a, **kw)

    monkeypatch.setattr(TF, "fused_stack_lanes", counted)
    clips = [clip(100 + i) for i in range(3)]
    langs, tasks = zip(*PROMPTS[:3])
    srv = ContinuousSTT(rich, slots=3, max_tokens=6, step_tokens=2, min_tick_tokens=2)
    assert srv.fused
    reqs = [srv.submit(c, language=g, task=t) for c, g, t in zip(clips, langs, tasks)]
    srv.drain()
    assert max(calls) == 2 and calls.count(2) >= 2 and 1 in calls
    monkeypatch.undo()
    assert [list(r.tokens) for r in reqs] == [
        offline_tokens(rich, c, g, t, max_tokens=6, kv_bits=8, quantized_kv_start=448)
        for c, g, t in zip(clips, langs, tasks)]


def test_sampled_tokens_are_composition_independent(rich):
    """A sampled request's tokens are the same alone, packed with another
    request, and in either admission order (mirrors
    tests/test_continuous.py:68)."""
    a, b = clip(70), clip(71)

    def run(order):
        srv = ContinuousSTT(rich, slots=2, max_tokens=10, temperature=0.8, seed=123)
        reqs = {}
        for name, audio, seed in order:
            reqs[name] = srv.submit(audio, *PROMPTS[name == "b"], seed=seed)
            srv.step()
        srv.drain()
        return {k: list(r.tokens) for k, r in reqs.items()}

    both = run([("a", a, 5), ("b", b, 9)])
    flipped = run([("b", b, 9), ("a", a, 5)])
    alone = run([("a", a, 5)])
    assert both["a"] == flipped["a"] == alone["a"]
    assert both["b"] == flipped["b"]
    assert both["a"] != run([("a", a, 6)])["a"]  # the seed matters


def test_first_token_frequencies_follow_the_softmax(rich):
    """The engine's first-step logits of one request, sampled at
    temperature 0.8 with 2000 request seeds: each token's frequency is
    within 0.035 of its softmax probability (3.5 standard deviations of a
    2000-draw frequency at p = 0.5); with top_k=3 only the 3 best tokens
    appear."""
    srv = ContinuousSTT(rich, slots=1, max_tokens=2, temperature=0.8)
    eng = srv.engine
    srv.submit(clip(80))
    eng._admit()
    lanes = torch.tensor([0])
    logits = eng._logits_hook(
        eng._batch_step_fn(eng.params, eng._cache, lanes, eng._state.last[:1],
                           eng._cache.offset[:1], eng._ctx).float(),
        torch.zeros(1, dtype=torch.int64))
    n = 2000
    rows = logits.expand(n, -1)
    seeds, idx = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    probs = torch.softmax(logits[0] / 0.8, -1)
    draws = sample_keyed(rows, 11, seeds, idx, SamplingParams(temperature=0.8))
    freq = torch.bincount(draws, minlength=probs.numel()).float() / n
    assert float((freq - probs).abs().max()) < 0.035
    assert float(probs.max()) < 0.9  # a spread distribution, not a near-argmax
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    k_draws = sample_keyed(rows, 11, seeds, idx, SamplingParams(temperature=0.8, top_k=3))
    assert set(k_draws.tolist()) == top3
    # the sample index moves the draw: most seeds draw another token next
    again = sample_keyed(rows, 11, seeds, idx + 1, SamplingParams(temperature=0.8))
    assert float((again != draws).float().mean()) > 1 - float((probs ** 2).sum()) - 0.05


@pytest.mark.parametrize("mask", ["top_k", "top_p", "min_p", "repetition"])
def test_sampling_masks_match_jax(mask):
    """The port's top-k / top-p / min-p masks and repetition penalty give
    the JAX package's logits on the same seeded rows (a vocab wider than
    the top-p prefilter's 512)."""
    import jax.numpy as jnp

    from tpu_audio.core import sampling as JS
    from tpu_audio_torch.core import sampling as TS

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 700)) * 2.0).astype(np.float32)
    hist = rng.integers(0, 700, (4, 6)).astype(np.int32)
    valid = rng.random((4, 6)) < 0.7
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    want, got = {
        "top_k": lambda: (JS._mask_top_k(jl, 17), TS._mask_top_k(tl, 17)),
        "top_p": lambda: (JS._mask_top_p(jl, 0.8), TS._mask_top_p(tl, 0.8)),
        "min_p": lambda: (JS._mask_min_p(jl, 0.05), TS._mask_min_p(tl, 0.05)),
        "repetition": lambda: (
            JS.apply_repetition_penalty(jl, jnp.asarray(hist), jnp.asarray(valid), 1.3),
            TS.apply_repetition_penalty(tl, torch.from_numpy(hist),
                                        torch.from_numpy(valid), 1.3)),
    }[mask]()
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    if mask != "repetition":
        assert 0 < np.isinf(want).mean() < 1


def test_engine_repetition_penalty_follows_its_window():
    """Greedy decoding with a repetition penalty over a 3-token window,
    through ticks of 3 steps: each lane's tokens are those of a plain
    host loop that penalizes its own last 3 tokens (the ring buffer is per
    lane and restarts at admission)."""
    V, C, penalty = 50, 3, 1.5
    base = np.linspace(-1.0, 1.0, V).astype(np.float32)
    base[[7, 3, 40, 21, 9]] = [3.0, 2.9, 2.8, 2.7, 2.6]

    class Cache:
        def __init__(self, slots):
            self.offset = torch.zeros((slots,), dtype=torch.int64)

    def step(params, cache, lanes, last, offsets, ctx):
        return torch.from_numpy(base).expand(lanes.shape[0], -1).clone()

    eng = TC.ContinuousBatcher(
        {}, slots=2, max_len=64, stop_token=-1, prefill_buckets=(4,),
        sampling=SamplingParams(temperature=0.0, repetition_penalty=penalty,
                                repetition_context_size=C),
        batch_step_fn=step, prefill_fn=lambda p, c, slot, ids, vf, ctx: len(ids),
        cache_factory=Cache, step_tokens=3)
    reqs = [eng.submit(np.arange(4, dtype=np.int32), max_new=m) for m in (7, 10, 5)]
    list(eng.run())

    def host_loop(n):
        out = []
        for _ in range(n):
            row = base.copy()
            for t in set(out[-C:]):
                row[t] = row[t] / penalty if row[t] > 0 else row[t] * penalty
            out.append(int(np.argmax(row)))
        return out

    assert [r.tokens for r in reqs] == [host_loop(m) for m in (7, 10, 5)]
    assert reqs[1].tokens[:5] == [7, 3, 40, 21, 7]


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_engine_without_device_keeps_its_state_beside_the_caches(where):
    """Built without ``device=``, the engine puts its lane state on the
    device of the caches ``cache_factory`` returns (it used to take the
    CPU whatever the caches' device)."""
    class Cache:
        def __init__(self, slots):
            self.offset = torch.zeros((slots,), dtype=torch.int64, device=where)

    eng = TC.ContinuousBatcher(
        {}, slots=3, batch_step_fn=lambda *a: None,
        prefill_fn=lambda p, c, slot, ids, vf, ctx: len(ids), cache_factory=Cache)
    assert eng.device == torch.device(where)
    assert all(t.device == torch.device(where) for t in eng._state.tensors())


def _wav(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_serve_stt_slots(dense):
    """build_server(slots=2): three concurrent POSTs each get the offline
    text of their PCM16-quantised clip; /healthz, /metrics and the stream
    route answer (mirrors tests/test_continuous_stt.py:86)."""
    from tpu_audio_torch.cli.serve import build_server

    _, tm = dense
    srv = build_server(tm, "stt", "fixture", port=0, slots=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    clips = [clip(90 + i, 12000) for i in range(3)]
    results = {}
    try:
        def post(i):
            req = urllib.request.Request(f"{url}/v1/audio/transcriptions",
                                         data=_wav(clips[i]),
                                         headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = json.loads(r.read())

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        req = urllib.request.Request(f"{url}/v1/audio/transcriptions/stream",
                                     data=_wav(clips[0]))
        with urllib.request.urlopen(req, timeout=300) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert not srv.stt_worker._thread.is_alive()
    for i in range(3):
        quant = (clips[i] * 32767).clip(-32768, 32767).astype(np.int16).astype(
            np.float32) / 32768.0
        text = tm.tokenizer.decode(offline_tokens(tm, quant, max_tokens=224)).strip()
        assert results[i]["text"] == text
    assert lines[-1]["type"] == "result" and lines[-1]["text"] == results[0]["text"]
    assert health == {"ok": True, "task": "stt", "model": "fixture"}
    assert 'tpu_audio_requests_total{route="/v1/audio/transcriptions"} 3' in metrics
    assert 'tpu_audio_requests_total{route="/v1/audio/transcriptions/stream"} 1' in metrics


def test_worker_engine_death_unblocks_callers(rich):
    """If the engine thread dies mid-step, the waiting caller gets the
    failure instead of hanging, and the worker refuses new work (mirrors
    tests/test_continuous.py:369)."""
    worker = STTEngineWorker(rich, slots=1, max_tokens=4)
    calls = {"n": 0}
    orig = worker._srv.step

    def dying_step():
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected device failure")
        return orig()

    worker._srv.step = dying_step
    with pytest.raises(RuntimeError, match="engine thread died"):
        worker.transcribe(clip(95))
    with pytest.raises(RuntimeError):
        worker.transcribe(clip(96))
    worker._thread.join(timeout=60)
    assert not worker._thread.is_alive()


def test_serve_cli_refuses_what_is_not_ported(tmp_path):
    from tpu_audio_torch.cli import serve

    for argv, what in ((["--task", "codec"], "not ported"),
                       (["--tp", "2"], "tensor-parallel"),
                       (["--warmup"], "warmup")):
        with pytest.raises(SystemExit, match=what):
            serve.main(["--model", str(tmp_path), *argv])
    with pytest.raises(NotImplementedError, match="codec"):
        serve.build_server(None, "codec", "x", port=0)
