"""Whisper's quantized self caches on the PyTorch port against the JAX
package, on the CPU: ``kv_bits=8`` (an int8 self cache), ``kv_bits=4``
(int4 self cache and cross K/V) and ``kv_bits=8, quantized_kv_start=6``
(a hybrid cache), on a dense and a w8a8 decoder, over one window and a
40 s file of two batched windows; ``generate_stream``; the CLI.

Greedy tokens equal the JAX package's, or part where the JAX package's two
best logits lie within the two packages' difference of those logits at
that step, with the tokens before it forced to the JAX package's in both
(a near tie that rounding decides: the JAX loop runs jitted, and at 8 bits
the port's cross attention is kernel 2's plain version where the JAX
package dequantizes).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import kv_cache as jkv
from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.stt import whisper as JW
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.stt import whisper as TW

from fixtures import FakeWhisperTokenizer, make_whisper_fixture, write_fixture_tokenizer

torch.set_num_threads(1)

ROUTES = {
    "int8": dict(kv_bits=8),
    "int4": dict(kv_bits=4),
    "hybrid8": dict(kv_bits=8, quantized_kv_start=6),
}
MAX_TOKENS = 8


def _seeded_normal(d, seed: int = 0) -> None:
    """Rewrite the fixture checkpoint's weights as seeded normal draws
    (linears and convs N(0, 1/in), the decoder's token table N(0, 0.01)
    and position table N(0, 1), norms
    1 + N(0, 0.1), biases N(0, 0.02)): its periodic weights give every
    window the same tokens."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(seed)
    w = load_file(str(d / "model.safetensors"))
    for k, a in sorted(w.items()):
        if k.startswith("model.encoder.embed_positions"):
            continue
        if "embed_tokens" in k:
            a = 0.1 * rng.standard_normal(a.shape)
        elif "embed_positions" in k:
            a = rng.standard_normal(a.shape)
        elif "layer_norm" in k and k.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif k.endswith("bias"):
            a = 0.02 * rng.standard_normal(a.shape)
        else:
            a = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[1:]))
        w[k] = np.asarray(a, np.float32)
    save_file(w, str(d / "model.safetensors"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The fixture checkpoint at a width ``quantize_tree`` packs (256),
    with seeded normal weights, in both packages, dense and with a w8a8
    decoder."""
    d = make_whisper_fixture(tmp_path_factory.mktemp("w") / "w", d_model=256, layers=2,
                             heads=4, ffn=1024, vocab=128, max_target_positions=32)
    _seeded_normal(d)
    jm = JW.Whisper.from_pretrained(str(d), dtype=jnp.float32)
    tok = FakeWhisperTokenizer(vocab=jm.config.vocab_size)
    jm.tokenizer = tok
    jw8 = JW.Whisper(jm.config, {"model": {**jm.params["model"], "decoder": jquant.quantize_tree(
        jm.params["model"]["decoder"], scheme="w8a8")}}, tok, dtype=jnp.float32)
    out = {}
    for w8, j in ((False, jm), (True, jw8)):
        t = TW.Whisper.from_pretrained(str(d), dtype=torch.float32, device="cpu",
                                       quantize="w8a8" if w8 else None)
        t.tokenizer = tok
        out[w8] = (j, t)
    rng = np.random.default_rng(3)
    audio = {1: (rng.standard_normal(16000) * 0.1).astype(np.float32),
             40: (rng.standard_normal(16000 * 40) * 0.1).astype(np.float32)}
    return out, audio


def _rows(tokens_per_window, prompt, max_total, eot):
    """Each window's sequence, prompt included, padded with EOT."""
    return np.asarray([(prompt + g + [eot] * max_total)[:max_total]
                       for g in tokens_per_window], np.int64)


def _forced_logits(jm, tm, chunks, rows, kw):
    """Teacher-forced step logits ``[B, steps, V]`` of both packages along
    ``rows``: the port's ``decode_step_fn`` and the JAX package's
    ``decoder_step`` over the caches and cross K/V its decode loops build
    on the CPU (``"quant"`` cross mode)."""
    cfg = jm.config
    H = cfg.decoder_attention_heads
    hd = cfg.d_model // H
    n_groups = hd // min(64, hd)
    max_total = rows.shape[1]
    enc = jm._encode(jm.params, jnp.concatenate([jm.encoder_features(c) for c in chunks]))
    ck, cv = JW._cross_kv(jm.params, enc, cfg)
    q = jax.vmap(functools.partial(jkv._quantize, n_groups=n_groups, bits=kw["kv_bits"]))
    ck, cv = q(ck), q(cv)
    cache = jkv.make_cache_for(cfg.decoder_layers, len(chunks), H, hd, max_total, enc.dtype,
                               kv_bits=kw["kv_bits"],
                               quantized_kv_start=kw.get("quantized_kv_start", 0))
    jl = []
    for i in range(max_total - 1):
        logits, cache = JW.decoder_step(jm.params, jnp.asarray(rows[:, i:i + 1], jnp.int32), i,
                                        cache, ck, cv, cfg, cross_mode="quant")
        jl.append(np.asarray(logits[:, -1], np.float32))
    with torch.inference_mode():
        tenc = tm.encoder(torch.cat([tm.encoder_features(c) for c in chunks]))
        step = TW.decode_step_fn(tm.params, tenc, max_total=max_total, cfg=tm.config,
                                 layers=tm.decoder.split_layers(), **kw)
        tl = [step(torch.from_numpy(rows[:, i]), i).numpy() for i in range(max_total - 1)]
    return np.stack(jl, 1), np.stack(tl, 1)


def assert_tokens_or_witness(jm, tm, chunks, got, want, kw):
    """Each window's greedy tokens equal, or at the first parted step the
    JAX package's two best logits (after the suppress masks) are the two
    tokens, and lie within the packages' difference of those logits."""
    if got == want:
        return
    tok = jm.tokenizer
    prompt = tok.build_prompt_tokens(None)
    max_total = min(jm.config.max_target_positions, len(prompt) + MAX_TOKENS)
    rows = _rows(want, prompt, max_total, tok.eot)
    jl, tl = _forced_logits(jm, tm, chunks, rows, kw)
    suppress, begin = (np.asarray(m) for m in jm._suppress_masks(tok))
    for w, (g, x) in enumerate(zip(got, want)):
        if g == x:
            continue
        s = next(i for i in range(min(len(g), len(x)) + 1)
                 if i >= min(len(g), len(x)) or g[i] != x[i])
        step = len(prompt) - 1 + s
        masked = jl[w, step] + suppress + (begin if s == 0 else 0)
        a = x[s] if s < len(x) else tok.eot
        b = g[s] if s < len(g) else tok.eot
        assert {a, b} == set(np.argsort(masked)[-2:].tolist()), (w, s, a, b)
        gap = abs(jl[w, step, a] - jl[w, step, b])
        assert gap <= np.abs(jl[w, step] - tl[w, step]).max(), (w, s, gap)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("w8", [False, True], ids=["dense", "w8"])
@pytest.mark.parametrize("seconds", [1, 40])
def test_generate_greedy_tokens_match_jax(models, route, w8, seconds):
    trees, audio = models
    jm, tm = trees[w8]
    kw = ROUTES[route]
    x = audio[seconds]
    want = jm.generate(x, JParams(max_tokens=MAX_TOKENS, **kw))
    got = tm.generate(x, TParams(max_tokens=MAX_TOKENS, **kw))
    assert not tm._fused_supported() or w8
    windows = [x[s:s + TW.CHUNK_LENGTH_SAMPLES] for s in range(0, len(x), TW.CHUNK_LENGTH_SAMPLES)]
    assert len(got.segments) == len(want.segments) == len(windows)
    assert_tokens_or_witness(jm, tm, windows, [s.tokens for s in got.segments],
                             [s.tokens for s in want.segments], kw)
    assert sum(len(s.tokens) for s in got.segments) > 0
    if seconds == 40:
        # generate_stream decodes the windows one at a time
        events = list(tm.generate_stream(x, TParams(max_tokens=MAX_TOKENS, **kw)))
        assert events[-1]["type"] == "result"
        solo = [tm.generate(w, TParams(max_tokens=MAX_TOKENS, **kw)).text for w in windows]
        assert [e["text"] for e in events[:-1]] == [t for t in solo if t]
        assert events[-1]["output"].text == " ".join(t for t in solo if t)


def test_routes_build_the_caches_and_cross_modes_they_name(models):
    """``decode_step_fn``'s self cache and cross mode for each route, and
    the dense kv8d route unchanged."""
    trees, audio = models
    _, tm = trees[False]
    enc = tm.encoder(tm.encoder_features(audio[1]))
    seen = []
    orig = TW.decoder_step

    def spy(params, tokens, pos, cache, cross, cfg, cross_mode="dense", layers=None):
        seen.append((type(cache).__name__, getattr(cache, "bits", None), cross_mode,
                     cross[0].dtype))
        return orig(params, tokens, pos, cache, cross, cfg, cross_mode, layers)

    TW.decoder_step = spy
    try:
        for kw in (dict(kv_bits=8), dict(kv_bits=4), dict(kv_bits=8, quantized_kv_start=6),
                   dict(kv_bits=4, quantized_kv_start=6), dict(kv_bits=8, quantized_kv_start=12)):
            TW.decode_step_fn(tm.params, enc, max_total=12, cfg=tm.config, **kw)(
                torch.tensor([1]), 0)
    finally:
        TW.decoder_step = orig
    assert seen == [("QuantKVCache", 8, "int8", torch.int8),
                    ("QuantKVCache", 4, "quant", torch.uint8),
                    ("HybridKVCache", 8, "int8", torch.int8),
                    ("HybridKVCache", 4, "quant", torch.uint8),
                    ("KVCache", None, "int8", torch.int8)]
    assert isinstance(tkv.make_cache_for(1, 1, 1, 64, 12, kv_bits=8, quantized_kv_start=6),
                      tkv.HybridKVCache)


@pytest.mark.parametrize("bits", ["8", "4"])
def test_cli_kv_bits_writes_the_same_text_as_jax_cli(tmp_path, capsys, bits):
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio_torch.cli import stt as tstt

    d = make_whisper_fixture(tmp_path / "w")
    write_fixture_tokenizer(d, 64)
    wav = tmp_path / "in.wav"
    save_wav(wav, np.random.default_rng(0).standard_normal(16000).astype(np.float32) * 0.1,
             16000)
    outs = {}
    for name, main, extra in (("jax", jstt.main, []),
                              ("torch", tstt.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.json"
        assert main([str(wav), "--model", str(d), "--max-tokens", "6", "--kv-bits", bits,
                     "--format", "json", "--output", str(path)] + extra) == 0
        outs[name] = json.loads(path.read_text())
    assert outs["torch"] == outs["jax"]
    assert "[stt]" in capsys.readouterr().err
