"""VyvoTTS (Qwen3 + SNAC) on the PyTorch port against the JAX package, on
the CPU at small sizes, in f32: loading through ``load_model`` (and the
registry's repo-name fallback), ``parse_output``, greedy tokens and the
waveform through ``generate`` and ``generate_stream`` on a dense and an
MLX 4-bit tree, a w8a8 tree on the port's kernel-5 route (its plain
version here) against both JAX routes, ``ContinuousTTS``, the CLI and the
server.

The fixture checkpoint (``make_llama_tts_fixture(qwen3=True)``) has
periodic weights; the parity tests run on a copy with seeded normal
weights (``_write``), whose SNAC codec has its noise weights at zero, so
that the two packages' waveforms compare (their noise generators differ).
"""

import io
import json
import shutil
import threading
import urllib.request
import wave
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import serve as jserve
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio.models.tts import qwen3_vyvo as JV
from tpu_audio.parallel import continuous as JC
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationKind
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.tts import load_model as tload_model
from tpu_audio_torch.models.tts import qwen3_vyvo as TV
from tpu_audio_torch.parallel import continuous as TC

from fixtures import make_llama_tts_fixture, make_qwen3_tts_fixture, make_snac_fixture
from test_torch_tts_q4 import _is_llama_linear, _quantize_checkpoint

torch.set_num_threads(1)

GREEDY = dict(max_tokens=21, temperature=0.0, top_p=1.0, repetition_penalty=1.3,
              repetition_context_size=8, streaming_interval=0.02)
TEXT = "hello world"
# Qwen3 at the head_dim-128 width of tests/test_fused_llama.py:90, which
# ops.fused_llama.supported takes, with a tiny vocabulary and its table
FUSED = dict(hidden_size=1024, num_hidden_layers=2, intermediate_size=2048,
             num_attention_heads=8, num_key_value_heads=4, head_dim=128, vocab_size=96,
             rope_theta=10000.0, tie_word_embeddings=True, max_position_embeddings=512,
             start_of_human=1, end_of_human=2, end_of_text=3, start_of_speech=4,
             end_of_speech=5, pad_token=0, audio_start=6, audio_end=7,
             audio_token_offset=10, codebook_size=4)
WIDE = dict(hidden_size=256, num_hidden_layers=2, intermediate_size=512,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64)


def _write(dst, seed, cfg=None):
    """Seeded normal weights for the checkpoint in ``dst`` at the geometry
    of its config (updated with ``cfg``): linears N(0, 1/in), embeddings
    N(0, 8/d) (a row's squared norm 8 at every width: larger ones make the
    tied head repeat its input token), norms (q/k norms included)
    1 + N(0, 0.01)."""
    from safetensors.numpy import save_file

    conf = json.loads((dst / "config.json").read_text())
    conf.update(cfg or {})
    (dst / "config.json").write_text(json.dumps(conf))
    d, ffn, L = conf["hidden_size"], conf["intermediate_size"], conf["num_hidden_layers"]
    hd = conf.get("head_dim") or d // conf["num_attention_heads"]
    nq, nkv = conf["num_attention_heads"] * hd, conf["num_key_value_heads"] * hd
    rng = np.random.default_rng(seed)

    def lin(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    w = {"model.embed_tokens.weight":
         (np.sqrt(8 / d) * rng.standard_normal((conf["vocab_size"], d))).astype(np.float32),
         "model.norm.weight": norm(d)}
    for i in range(L):
        b = f"model.layers.{i}"
        w.update({f"{b}.input_layernorm.weight": norm(d),
                  f"{b}.post_attention_layernorm.weight": norm(d),
                  f"{b}.self_attn.q_proj.weight": lin(nq, d),
                  f"{b}.self_attn.k_proj.weight": lin(nkv, d),
                  f"{b}.self_attn.v_proj.weight": lin(nkv, d),
                  f"{b}.self_attn.o_proj.weight": lin(d, nq),
                  f"{b}.self_attn.q_norm.weight": norm(hd),
                  f"{b}.self_attn.k_norm.weight": norm(hd),
                  f"{b}.mlp.gate_proj.weight": lin(ffn, d),
                  f"{b}.mlp.up_proj.weight": lin(ffn, d),
                  f"{b}.mlp.down_proj.weight": lin(d, ffn)})
    save_file(w, str(dst / "model.safetensors"))
    return dst


def _silence_snac(snac_dir):
    """Zero the SNAC noise blocks' weight norms: the noise term vanishes."""
    from safetensors.numpy import load_file, save_file

    w = load_file(str(snac_dir / "model.safetensors"))
    for k in w:
        if k.endswith("linear.weight_g"):
            w[k] = np.zeros_like(w[k])
    save_file(w, str(snac_dir / "model.safetensors"))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture as written with its SNAC beside it; a seeded-normal copy
    with a silent SNAC; that copy MLX-packed at 4 bits (group 16); a
    width-256 seeded-normal copy for ``--quantize``."""
    root = tmp_path_factory.mktemp("vyvo")
    src = make_llama_tts_fixture(root / "fixture", qwen3=True)
    make_snac_fixture(src / "snac", vq_strides=(4, 2, 1))
    cfg = json.loads((src / "config.json").read_text())
    cfg["snac_repo"] = str(src / "snac")
    (src / "config.json").write_text(json.dumps(cfg))
    rand = root / "rand"
    shutil.copytree(src, rand)
    _silence_snac(rand / "snac")
    _write(rand, seed=3, cfg={"snac_repo": str(rand / "snac")})
    q4 = _quantize_checkpoint(rand, root / "q4", 4, 16, _is_llama_linear)
    wide = root / "wide"
    shutil.copytree(rand, wide)
    _write(wide, seed=4, cfg=dict(WIDE, snac_repo=str(rand / "snac")))
    return {"fixture": src, "rand": rand, "q4": q4, "wide": wide}


def _models(path, **kw):
    jm = jload_model(str(path), dtype=jnp.float32, **{k: v for k, v in kw.items()
                                                      if k != "device"})
    tm = tload_model(str(path), dtype=torch.float32, device="cpu", **kw)
    return jm, tm


def _tokens(model, P, chunk=7, **kw):
    for *_, (_pt, _gt, _pl, toks) in model._run_generation(
            TEXT, None, None, None, P(**{**GREEDY, **kw}), chunk_tokens=chunk):
        pass
    return toks


# -- loading -----------------------------------------------------------------------


def test_load_model_builds_vyvo_as_jax(dirs, tmp_path):
    """``load_model`` on a ``qwen3`` checkpoint gives a VyvoTTS with q/k
    RMSNorm, the config's token table and fused q/k/v, as the JAX package's
    does; the Orpheus and Qwen3-TTS fixtures keep their own classes; a
    config without ``model_type`` falls back on the repo name in the JAX
    registry's order; a tiny vocabulary without its table raises."""
    jm, tm = _models(dirs["fixture"])
    assert type(tm).__name__ == type(jm).__name__ == "VyvoTTS"
    assert isinstance(tm, TV.VyvoTTS) and tm.config.qk_norm and jm.config.qk_norm
    assert tm.tokens.__dict__ == jm.tokens.__dict__
    assert tm.tokens.audio_token_offset == 100
    assert "qkv_proj" in tm.params["model"]["layers"]["self_attn"]
    assert "q_norm" in tm.params["model"]["layers"]["self_attn"]
    assert tm.codec is not None and tm.sample_rate == 24000
    assert TV.VYVO_TOKENS.__dict__ == JV.VYVO_TOKENS.__dict__
    orpheus = make_llama_tts_fixture(tmp_path / "orpheus")
    assert type(tload_model(str(orpheus), device="cpu")).__name__ == "LlamaTTS"
    q3 = make_qwen3_tts_fixture(tmp_path / "q3tts")
    assert type(tload_model(str(q3), device="cpu", dtype=torch.float32)).__name__ == "Qwen3TTS"
    for name in ("acme-qwen3-tts-demo", "my-vyvo-voice"):
        d = shutil.copytree(dirs["fixture"], tmp_path / name)
        cfg = json.loads((d / "config.json").read_text())
        del cfg["model_type"]
        (d / "config.json").write_text(json.dumps(cfg))
        assert type(tload_model(str(d), device="cpu")).__name__ == \
            type(jload_model(str(d))).__name__ == "VyvoTTS"
    d = shutil.copytree(dirs["fixture"], tmp_path / "no_table")
    cfg = json.loads((d / "config.json").read_text())
    del cfg["audio_token_offset"]
    (d / "config.json").write_text(json.dumps(cfg))
    for load in (lambda: tload_model(str(d), device="cpu"), lambda: jload_model(str(d))):
        with pytest.raises(ValueError, match="tiny vocab requires token table in config.json"):
            load()


def test_parse_output_matches_jax(dirs):
    """After START_OF_SPEECH; without one, from the first audio token after
    the last START_OF_AI; with neither, every audio token."""
    jm, tm = _models(dirs["fixture"])
    T = tm.tokens
    a = [T.audio_token_offset + i for i in range(17)]
    cases = [
        [5, T.start_of_speech, *a[:9], T.end_of_speech],
        [T.start_of_speech, *a[:3], T.start_of_speech, *a[3:17]],
        [T.audio_start, 7, *a[:4], T.audio_start, 8, 9, *a[4:16], T.audio_end],
        [T.audio_start, 1, 2, 3],
        [*a[:10], T.end_of_speech, *a[10:]],
        [1, 2, 3],
        [],
    ]
    for seq in cases:
        assert tm.parse_output(seq) == jm.parse_output(seq), seq
    assert tm.parse_output(cases[2]) == list(range(4, 11))  # the START_OF_AI fallback


# -- generation ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["rand", "q4"])
def test_generate_and_stream_match_jax(dirs, which):
    """Greedy tokens (repetition penalty 1.3), ``generate``'s waveform and
    ``generate_stream``'s tokens and audio, dense and MLX 4-bit."""
    jm, tm = _models(dirs[which])
    if which == "q4":
        qkv = tm.params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"]
        assert isinstance(qkv, tquant.QuantizedTensor) and qkv.bits == 4
    toks = _tokens(tm, TParams)
    assert toks == _tokens(jm, JParams)
    assert len(tm.parse_output(toks)) >= 14
    want = np.asarray(jm.generate(TEXT, generation_parameters=JParams(**GREEDY)))
    got = tm.generate(TEXT, generation_parameters=TParams(**GREEDY))
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, atol=1e-4)
    streams = []
    for m, P in ((jm, JParams), (tm, TParams)):
        events = list(m.generate_stream(TEXT, generation_parameters=P(**GREEDY)))
        streams.append(([e.token for e in events if e.kind == AudioGenerationKind.TOKEN],
                        np.concatenate([np.asarray(e.audio) for e in events
                                        if e.kind == AudioGenerationKind.AUDIO])))
    (jt, ja), (tt, ta) = streams
    assert tt == jt and len(tt) == GREEDY["max_tokens"]
    np.testing.assert_allclose(ta, ja, atol=1e-4)


def _fused_dir(root):
    d = root / "fused"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "qwen3"}))
    return _write(d, seed=12, cfg=FUSED)


def _tokenizer():
    return SimpleNamespace(encode=lambda s: SimpleNamespace(
        ids=[10 + (ord(c) % 30) for c in s]))


def _forced(m, toks, prompt_len, fused):
    """Step logits ``[steps, V]`` along ``toks`` (prompt then generated)
    through ``m``'s own decode route after its prefill: the port's
    kernel-5 route when ``fused``, else the model's ``_step_fn``."""
    import math

    prompt = toks[:prompt_len]
    bucket = max(64, 1 << math.ceil(math.log2(max(prompt_len, 2))))
    padded = np.full((1, bucket), m.tokens.pad_token, np.int64)
    padded[0, bucket - prompt_len:] = prompt
    max_total = bucket + len(toks) - prompt_len + 1
    out = []
    if isinstance(m, TV.VyvoTTS):
        with torch.inference_mode():
            if fused:
                cache, fc = m._fused_cache(max_total, bucket - prompt_len)
            else:
                cache = TL.make_cache(m.config, 1, max_total, torch.float32,
                                      valid_from=bucket - prompt_len)
            _, cache = m._prefill(m.params, torch.from_numpy(padded[:, :-1]), cache)
            params = m.params
            if fused:
                cache = fc._replace(offset=cache.offset)
                params = {**m.params, "fused_pack": m.fused_decoder_pack()}
            step = m._fused_step_fn if fused else m._step_fn
            for t in toks[prompt_len - 1:-1]:
                logits, cache = step(params, torch.tensor([[t]]), cache)
                out.append(logits[0].float().numpy())
        return np.stack(out)
    from tpu_audio.models import llama as JL

    cache = JL.make_cache(m.config, 1, max_total, jnp.float32)._replace(
        valid_from=jnp.asarray(bucket - prompt_len, jnp.int32))
    _, cache = m._prefill_fn(m.params, jnp.asarray(padded[:, :-1], jnp.int32), cache)
    for t in toks[prompt_len - 1:-1]:
        logits, cache = m._step_fn(m.params, jnp.asarray([[t]], jnp.int32), cache)
        out.append(np.asarray(logits[0], np.float32))
    return np.stack(out)


def test_w8a8_on_the_kernel5_route_matches_both_jax_routes(tmp_path, monkeypatch):
    """A w8a8 tree at a width ``ops.fused_llama.supported`` takes: the port
    leaves its projections apart and decodes on the kernel-5 route (the
    plain version here). The JAX package's kernel (interpreted) decodes
    only ``fuse=False``; there the tokens are equal. Its default loader
    fuses q/k/v, so its XLA loop decodes (activation codes a row): equal
    tokens, or parted where its two best logits lie within the packages'
    difference at that step, the tokens before forced in both. With
    ``fuse=False`` on CUDA the same tree raises where the kernel does not
    take it (``test_torch_tts.py``)."""
    d = _fused_dir(tmp_path)
    kw = dict(repetition_penalty=1.0, max_tokens=9)
    tm = TV.VyvoTTS.from_pretrained(str(d), dtype=torch.float32, quantize_bits="w8a8",
                                    device="cpu")
    tm.tokenizer = _tokenizer()
    assert tm._fused_supported() and "q_proj" in tm.params["model"]["layers"]["self_attn"]
    got = _tokens(tm, TParams, chunk=9, **kw)
    monkeypatch.setenv("TPU_AUDIO_FUSED_LLAMA", "interpret")
    jk = JV.VyvoTTS.from_pretrained(str(d), dtype=jnp.float32, quantize_bits="w8a8",
                                    fuse=False)
    jk.tokenizer = _tokenizer()
    assert jk._fused_supported()
    assert got == _tokens(jk, JParams, chunk=9, **kw)
    monkeypatch.delenv("TPU_AUDIO_FUSED_LLAMA")
    jd = JV.VyvoTTS.from_pretrained(str(d), dtype=jnp.float32, quantize_bits="w8a8")
    jd.tokenizer = _tokenizer()
    assert not jd._fused_supported()
    assert "qkv_proj" in jd.params["model"]["layers"]["self_attn"]
    want = _tokens(jd, JParams, chunk=9, **kw)
    if got != want:
        n = len(jd.prepare_input_ids(TEXT))
        s = next(i for i in range(n, len(want)) if got[i] != want[i])
        lj = _forced(jd, want[:s + 1], n, fused=False)[-1]
        lt = _forced(tm, want[:s + 1], n, fused=True)[-1]
        assert {got[s], want[s]} == set(np.argsort(lj)[-2:].tolist())
        assert lj[want[s]] - lj[got[s]] <= np.abs(lj - lt).max()
    unfused = TV.VyvoTTS.from_pretrained(str(d), dtype=torch.float32, quantize_bits="w8a8",
                                         device="cpu", fuse=False)
    assert unfused._fused_supported()


def test_fuse_false_keeps_projections_apart_and_the_tokens(dirs):
    """``fuse=False`` never fuses; the tokens are the same function."""
    tm = tload_model(str(dirs["rand"]), dtype=torch.float32, device="cpu")
    apart = TV.VyvoTTS.from_pretrained(str(dirs["rand"]), dtype=torch.float32, device="cpu",
                                       fuse=False)
    layers = apart.params["model"]["layers"]
    assert "q_proj" in layers["self_attn"] and "gate_proj" in layers["mlp"]
    assert _tokens(apart, TParams) == _tokens(tm, TParams)
    with pytest.raises(TypeError, match="audio_band_head"):
        TV.VyvoTTS.from_pretrained(str(dirs["rand"]), device="cpu", audio_band_head=True)


# -- serving, the CLI and the server ---------------------------------------------------


def test_continuous_tts_over_vyvo_matches_solo_and_jax(dirs):
    """tests/test_continuous.py:545 on both packages: two staggered greedy
    requests through ContinuousTTS (the plain tick), each request's tokens
    its solo ``generate_stream``'s and the JAX engine's."""
    jm, tm = _models(dirs["rand"])
    texts = [TEXT, "a second concurrent vyvo request"]

    def drain(srv):
        reqs = [srv.submit(texts[0])]
        events = list(srv.step())
        reqs.append(srv.submit(texts[1]))
        events += list(srv.run())
        return [list(r.tokens) for r in reqs], sum(
            ev.kind == AudioGenerationKind.AUDIO for _, ev in events)

    srv = TC.ContinuousTTS(tm, slots=2, generation_parameters=TParams(**GREEDY))
    assert not srv.fused
    got, n_audio = drain(srv)
    assert n_audio > 0
    solo = [[e.token for e in tm.generate_stream(t, generation_parameters=TParams(**GREEDY))
             if e.kind == AudioGenerationKind.TOKEN] for t in texts]
    assert got == solo
    want, _ = drain(JC.ContinuousTTS(jm, slots=2, generation_parameters=JParams(**GREEDY),
                                     step_tokens=7))
    assert got == want


def _pcm(wav: bytes):
    with wave.open(io.BytesIO(wav)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("quantize", [None, "4", "8", "w8a8"])
def test_cli_writes_the_jax_cli_wav(dirs, tmp_path, quantize):
    """``cli/tts.py`` on the width-256 VyvoTTS checkpoint, greedy, with and
    without ``--quantize``: the JAX CLI's audio, within one PCM step."""
    from tpu_audio.cli import tts as jcli
    from tpu_audio_torch.cli import tts as tcli

    outs = {}
    for name, cli, extra in (("torch", tcli, ["--device", "cpu"]), ("jax", jcli, [])):
        out = tmp_path / f"{name}.wav"
        assert cli.main([TEXT, "--model", str(dirs["wide"]), "--max-tokens", "21",
                         "--temperature", "0", "-o", str(out), *extra,
                         *(["--quantize", quantize] if quantize else [])]) == 0
        outs[name] = _pcm(out.read_bytes())
    (sr, got), (jsr, want) = outs["torch"], outs["jax"]
    assert sr == jsr == 24000 and got.shape == want.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_cli_band_head_is_refused_as_by_the_jax_cli(dirs):
    from tpu_audio.cli import tts as jcli
    from tpu_audio_torch.cli import tts as tcli

    for cli, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        with pytest.raises(SystemExit, match=r"--band-head .* Orpheus-family models"):
            cli.main([TEXT, "--model", str(dirs["fixture"]), "--band-head", *extra])


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
def test_solo_server_route_matches_the_jax_route(dirs, monkeypatch, path):
    """``serve --task tts`` without slots answers a POST with the JAX
    server's audio (both models' default parameters made greedy); at
    ``slots=2`` the TTSEngineWorker answers with the solo audio."""
    jm, tm = _models(dirs["rand"])
    for m, P in ((jm, JParams), (tm, TParams)):
        monkeypatch.setattr(m, "default_generation_parameters", lambda P=P: P(**GREEDY))
    payload = {"input": TEXT, "max_tokens": 21}
    got = _post(tserve.build_server(tm, "tts", "vyvo", port=0, slots=1), path, payload)
    want = _post(jserve.build_server(jm, "tts", "vyvo", port=0), path, payload)
    served = tserve.build_server(tm, "tts", "vyvo", port=0, slots=2,
                                 generation_parameters=TParams(**GREEDY))
    assert isinstance(served.tts_worker, TC.TTSEngineWorker)
    batched = _post(served, path, payload)
    if path.endswith("speech"):
        (got, want, batched) = (_pcm(b)[1] for b in (got, want, batched))
    else:
        got, want, batched = (np.frombuffer(b, np.int16) for b in (got, want, batched))
    assert got.shape == want.shape == batched.shape and got.size > 0
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert np.array_equal(batched, got)
