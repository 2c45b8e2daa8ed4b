"""Orpheus TTS on the PyTorch port against the JAX package, on the CPU at
small sizes: the Llama backbone (prefill and cached steps), the chunked
decode loop, greedy tokens through ``LlamaTTS._run_generation`` on the
dense and the fused w8a8 routes, the audio-band head, the SNAC codec,
``generate`` / ``generate_stream`` and the CLI.

The JAX package's fused Llama kernel runs as its own tests run it: in
interpret mode, selected with ``TPU_AUDIO_FUSED_LLAMA=interpret`` (``0``
selects its XLA loop).
"""

import wave
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.codecs.snac import SNAC as JSNAC
from tpu_audio.core import quant as jquant
from tpu_audio.core.ar_loop import make_decode_chunk as jmake_decode_chunk
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.core.sampling import SamplingParams as JSampling
from tpu_audio.models import llama as JL
from tpu_audio.models.tts import llama_tts as JT
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio_torch.codecs import load_codec
from tpu_audio_torch.codecs.snac import SNAC as TSNAC
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import ar_loop as tar
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationKind
from tpu_audio_torch.core.sampling import SamplingParams as TSampling
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.tts import llama_tts as TT
from tpu_audio_torch.models.tts import load_model as tload_model

from fixtures import make_llama_tts_fixture, make_snac_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

# the end-to-end config of tests/test_fused_llama.py:90
FUSED = dict(hidden_size=1024, num_hidden_layers=2, intermediate_size=2048,
             num_attention_heads=8, num_key_value_heads=4, head_dim=128,
             vocab_size=96, rope_theta=10000.0, tie_word_embeddings=True,
             max_position_embeddings=512)
SMALL_TOKENS = dict(start_of_human=1, end_of_human=2, end_of_text=3, start_of_speech=4,
                    end_of_speech=5, pad_token=0, audio_start=6, audio_end=7,
                    audio_token_offset=10, codebook_size=4)


def _tokenizer():
    return SimpleNamespace(encode=lambda s: SimpleNamespace(
        ids=[10 + (ord(c) % 30) for c in s]))


@pytest.fixture(scope="module")
def snac_dir(tmp_path_factory):
    return make_snac_fixture(tmp_path_factory.mktemp("snac4tts"), vq_strides=(4, 2, 1))


@pytest.fixture(scope="module")
def orpheus_dir(tmp_path_factory):
    return make_llama_tts_fixture(tmp_path_factory.mktemp("orpheus"))


def _tts(orpheus_dir, snac_dir, **kw):
    return tload_model(str(orpheus_dir), dtype=torch.float32, device="cpu",
                       codec=TSNAC.from_pretrained(str(snac_dir), device="cpu"), **kw)


# -- the backbone ---------------------------------------------------------------


def test_llama_forward_prefill_and_cached_steps_match_jax(orpheus_dir):
    """Left-padded prefill plus three cached steps, f32, both packages'
    own checkpoint loading (fused q/k/v and gate/up)."""
    jm = jload_model(str(orpheus_dir), dtype=jnp.float32)
    tm = tload_model(str(orpheus_dir), dtype=torch.float32, device="cpu")
    assert "qkv_proj" in tm.params["model"]["layers"]["self_attn"]
    cfg_j, cfg_t = jm.config, tm.config
    prompt = [90, 5, 17, 60, 61, 92, 91]
    pad = 9
    ids = np.asarray([[95] * pad + prompt], np.int32)
    jc = JL.make_cache(cfg_j, 1, 24, jnp.float32)._replace(
        valid_from=jnp.asarray(pad, jnp.int32))
    tc = TL.make_cache(cfg_t, 1, 24, torch.float32, valid_from=pad)
    jl, jc = JL.forward(jm.params, jnp.asarray(ids), jc, cfg_j)
    tl, tc = TL.forward(tm.params, torch.from_numpy(ids).long(), tc, cfg_t)
    got, want = [tl[0, pad:].numpy()], [np.asarray(jl)[0, pad:]]
    for tok in (101, 203, 17):
        jl, jc = JL.forward(jm.params, jnp.asarray([[tok]], jnp.int32), jc, cfg_j)
        tl, tc = TL.forward(tm.params, torch.tensor([[tok]]), tc, cfg_t)
        got.append(tl[0].numpy())
        want.append(np.asarray(jl)[0])
    assert tc.offset == int(jc.offset) == len(ids[0]) + 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def test_llama_init_random_params_matches_jax_numpy_path():
    cfg = dict(hidden_size=32, num_hidden_layers=2, intermediate_size=64,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=50,
               qk_norm=True)
    jp = jax_tree_to_numpy(JL.init_random_params(JL.LlamaConfig(**cfg), seed=3,
                                                 dtype=jnp.float32))
    tp = TL.init_random_params(TL.LlamaConfig(**cfg), seed=3, dtype=torch.float32)

    def check(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                check(a[k], b[k])
        else:
            np.testing.assert_array_equal(b.numpy(), a)

    check(jp, tp)


def test_maybe_stack_and_fuse_projections_match_jax():
    """Per-layer dicts stack, and q/k/v, gate/up fuse, as in the JAX
    package, for dense and int8 trees."""
    rng = np.random.default_rng(0)

    def layer():
        w = lambda o, i: rng.standard_normal((o, i)).astype(np.float32)
        return {"self_attn": {"q_proj": {"weight": w(64, 256)},
                              "k_proj": {"weight": w(32, 256)},
                              "v_proj": {"weight": w(32, 256)}},
                "mlp": {"gate_proj": {"weight": w(96, 256)},
                        "up_proj": {"weight": w(96, 256)}}}

    tree = {"model": {"layers": {"0": layer(), "1": layer()}}}
    for quantize in (False, True):
        j = jax.tree.map(jnp.asarray, tree)
        if quantize:
            j = jquant.quantize_tree(j, scheme="w8a8")
        t = from_jax_params(jax_tree_to_numpy(j))
        j = JL.fuse_projections(JL.maybe_stack(j))
        t = TL.fuse_projections(TL.maybe_stack(t))
        want = jax_tree_to_numpy(j)["model"]["layers"]
        got = t["model"]["layers"]
        for sub, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj")):
            w = got[sub][name]["weight"]
            if quantize:
                np.testing.assert_array_equal(w.weight.numpy(), want[sub][name]["weight"][0])
                np.testing.assert_array_equal(w.scale.numpy(), want[sub][name]["weight"][1])
            else:
                np.testing.assert_array_equal(w.numpy(), want[sub][name]["weight"])


# -- the decode loop --------------------------------------------------------------


def _table_step(table):
    """A step whose logits are row ``offset % rows`` of ``table``."""
    def step(params, tok, cache):
        row = table[cache.offset % table.shape[0]][None]
        return row, cache._replace(offset=cache.offset + 1)
    return step


@pytest.mark.parametrize("penalty,band", [(1.0, False), (1.3, False), (1.3, True)])
def test_decode_chunk_greedy_matches_jax(penalty, band):
    """Tokens, count, finished, cache offset and the repetition ring after
    two chunks (the second stops mid-chunk, past a host read of the flag),
    with and without a band token map."""
    rng = np.random.default_rng(4)
    V, stop = 12, 11
    table = rng.standard_normal((23, V)).astype(np.float32)
    table[4:14:3, 0] = 5.0  # repeated argmax: the penalty changes the picks
    table[19, :] = -9.0
    table[19, 9 if band else stop] = 9.0  # band index 9 maps to the stop token
    jmap = tmap = None
    if band:
        jmap = lambda i: jnp.where(i >= 9, jnp.int32(stop), i + 2)
        tmap = lambda i: torch.where(i >= 9, torch.full_like(i, stop), i + 2)
    jdec = jmake_decode_chunk(
        lambda p, t, c: (jnp.asarray(table)[c.offset % 23][None],
                         c._replace(offset=c.offset + 1)),
        JSampling(temperature=0.0, repetition_penalty=penalty), history_size=6,
        token_map=jmap)
    tdec = tar.make_decode_chunk(_table_step(torch.from_numpy(table)),
                                 TSampling(temperature=0.0, repetition_penalty=penalty),
                                 history_size=6, token_map=tmap)
    from tpu_audio.core import kv_cache as jkv
    from tpu_audio_torch.core import kv_cache as tkv

    jc = jkv.KVCache(jnp.zeros(1), jnp.zeros(1), jnp.int32(3), jnp.int32(0))
    tc = tkv.KVCache(torch.zeros(1), torch.zeros(1), 3)
    jstate = (jnp.asarray([1], jnp.int32), jax.random.PRNGKey(0),
              jnp.zeros((1, 6), jnp.int32), jnp.int32(0))
    tstate = (torch.tensor([1]), torch.Generator().manual_seed(0),
              torch.zeros((1, 6), dtype=torch.int64), torch.zeros((), dtype=torch.int64))
    for n in (7, 12):
        jt, jn, jc, jlast, jfin, jrng, jh, jhp = jdec(
            {}, jc, jstate[0], jnp.zeros((n,), jnp.int32), jstate[1], jnp.int32(stop),
            jstate[2], jstate[3])
        tt, tn, tc, tlast, tfin, tg, th, thp = tdec(
            {}, tc, tstate[0], torch.zeros((n,), dtype=torch.int64), tstate[1], stop,
            tstate[2], tstate[3])
        jstate, tstate = (jlast, jrng, jh, jhp), (tlast, tg, th, thp)
        assert tn == int(jn)
        assert tt[:tn].tolist() == np.asarray(jt)[:int(jn)].tolist()
        assert tfin == bool(jfin)
        assert tc.offset == int(jc.offset)
        assert th.tolist() == np.asarray(jh).tolist() and int(thp) == int(jhp)
        assert tlast.tolist() == np.asarray(jlast).tolist()
    assert tfin  # the second chunk reached the stop token


@pytest.mark.parametrize("kw,allowed", [
    (dict(temperature=0.7, top_k=3), 3),
    (dict(temperature=0.7, top_k=3, top_p=0.5), 2),
    (dict(temperature=0.7, top_p=0.4), 1),
    (dict(temperature=0.7, min_p=0.62), 2),
])
def test_decode_chunk_sampling_paths_stay_in_their_masks(kw, allowed):
    """Sampled tokens cannot equal threefry's; each path keeps to the
    tokens its masks leave, and a seed repeats its draws."""
    logits = torch.tensor([[4.0, 3.6, 3.5, 0.0, -1.0, -2.0]])
    step = lambda p, t, c: (logits, c._replace(offset=c.offset + 1))
    dec = tar.make_decode_chunk(step, TSampling(**kw), history_size=4)
    from tpu_audio_torch.core import kv_cache as tkv

    def run(seed):
        toks, n, *_ = dec({}, tkv.KVCache(torch.zeros(1), torch.zeros(1), 0),
                          torch.tensor([0]), torch.zeros((64,), dtype=torch.int64),
                          torch.Generator().manual_seed(seed), -1,
                          torch.zeros((1, 4), dtype=torch.int64),
                          torch.zeros((), dtype=torch.int64))
        return toks[:n].tolist()

    a = run(1)
    assert len(a) == 64 and set(a) <= set(range(allowed))
    assert run(1) == a


# -- LlamaTTS end to end --------------------------------------------------------


def _fused_models(seed):
    params = JL.init_random_params(JL.LlamaConfig(**FUSED), seed=seed, dtype=jnp.float32)
    params = jquant.quantize_tree(params, scheme="w8a8")
    tparams = from_jax_params(jax_tree_to_numpy(params))
    return params, tparams


def _jax_tokens(monkeypatch, params, mode, gen, chunk):
    monkeypatch.setenv("TPU_AUDIO_FUSED_LLAMA", mode)
    m = JT.LlamaTTS(JT.LlamaTTSConfig(**FUSED), params, tokenizer=_tokenizer(),
                    codec=None, tokens=JT.OrpheusTokens(**SMALL_TOKENS),
                    dtype=jnp.float32)
    out = None
    for *_, (_pt, _gt, _pl, all_tokens) in m._run_generation(
            "hi there", None, None, None, gen, chunk_tokens=chunk):
        out = all_tokens
    return out


def _port_tokens(tparams, gen, chunk, fused=True):
    m = TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), tparams, tokenizer=_tokenizer(),
                    codec=None, tokens=TT.OrpheusTokens(**SMALL_TOKENS),
                    dtype=torch.float32)
    assert m._fused_supported() == fused
    out = None
    for *_, (_pt, _gt, _pl, all_tokens) in m._run_generation(
            "hi there", None, None, None, gen, chunk_tokens=chunk):
        out = all_tokens
    return out


def test_fused_route_greedy_tokens_match_jax_both_modes(monkeypatch):
    """w8a8 through the fused route (the plain version on the CPU),
    greedy with repetition penalty 1.3: the JAX package's tokens through
    its interpreted kernel and through its XLA loop."""
    params, tparams = _fused_models(11)
    kw = dict(max_tokens=9, temperature=0.0, repetition_penalty=1.3)
    got = _port_tokens(tparams, TParams(**kw), 9)
    assert got == _jax_tokens(monkeypatch, params, "interpret", JParams(**kw), 9)
    assert got == _jax_tokens(monkeypatch, params, "0", JParams(**kw), 9)


def test_fused_route_long_generation_matches_jax_handoff(monkeypatch):
    """The JAX package (kernel cache capped at 128 rows) starts fused and
    hands off to its XLA loop mid-generation; the port stays on its fused
    route for all 80 tokens and gives the same tokens.

    Seed 14, not the JAX test's 13: with 13 the jitted JAX loop rounds one
    int8 activation code differently from its own eager run at step 20
    (XLA turns ``/ 127`` into a multiply; the port and eager JAX agree to
    2e-7), the logits move by 1e-2, and a greedy near-tie (margin 4e-3)
    flips at step 64. Seeds 11, 12 and 14-17 agree on all 80 tokens."""
    import tpu_audio.ops.pallas_fused_llama as JFL

    params, tparams = _fused_models(14)
    monkeypatch.setattr(JFL, "S_MAX_CAP", 128)
    kw = dict(max_tokens=80, temperature=0.0, repetition_penalty=1.0)
    got = _port_tokens(tparams, TParams(**kw), 8)
    assert len(got) > 64 + 8  # past the JAX kernel's cap
    assert got == _jax_tokens(monkeypatch, params, "interpret", JParams(**kw), 8)


def test_w8a8_tree_the_kernel_does_not_take_raises_on_cuda():
    """On CUDA a w8a8 tree decodes through ``fused_llama_stack`` only: one
    the kernel does not take (fused projections here) raises there, and
    decodes through ``llama.forward`` on the CPU; a dense tree takes
    ``llama.forward`` on both."""
    _, tparams = _fused_models(11)
    cfg = TT.LlamaTTSConfig(**FUSED)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TT._fused_route(tparams, cfg, cuda) and TT._fused_route(tparams, cfg, cpu)
    fused_proj = TL.fuse_projections({"model": dict(tparams["model"])})
    assert not TT._fused_route(fused_proj, cfg, cpu)
    with pytest.raises(NotImplementedError, match="fused_llama_stack"):
        TT._fused_route(fused_proj, cfg, cuda)
    dense = from_jax_params(jax_tree_to_numpy(JL.init_random_params(
        JL.LlamaConfig(**FUSED), seed=11, dtype=jnp.float32)))
    assert not TT._fused_route(dense, cfg, cuda)


def test_fused_cache_prefill_writes_the_kernel_layout():
    """The fused route's prefill writes the kernel's position-major
    buffers through their head-major views: the rows of a head-major cache
    prefilled alone, and no second cache."""
    _, tparams = _fused_models(11)
    m = TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), tparams, tokenizer=_tokenizer(),
                    codec=None, tokens=TT.OrpheusTokens(**SMALL_TOKENS),
                    dtype=torch.float32)
    ids = torch.arange(5, 17)[None]
    view, fused = m._fused_cache(20, 3)
    assert view.k.data_ptr() == fused.k.data_ptr() and view.valid_from == 3
    _, view = m._prefill(m.params, ids, view)
    ref = TL.make_cache(m.config, 1, 20, torch.float32, valid_from=3)
    _, ref = m._prefill(m.params, ids, ref)
    L, _, n_kv, S, hd = ref.k.shape
    for got, want in ((fused.k, ref.k), (fused.v, ref.v)):
        assert torch.equal(got, want[:, 0].permute(0, 2, 1, 3).reshape(L, S, n_kv * hd))
    assert view.offset == ref.offset == 12


def test_dense_route_greedy_tokens_match_jax(orpheus_dir):
    jm = jload_model(str(orpheus_dir), dtype=jnp.float32)
    tm = tload_model(str(orpheus_dir), dtype=torch.float32, device="cpu")
    assert not tm._fused_supported()
    kw = dict(max_tokens=20, temperature=0.0, repetition_penalty=1.3)
    outs = []
    for m, P in ((jm, JParams), (tm, TParams)):
        for *_, (_pt, _gt, _pl, toks) in m._run_generation(
                "hello world", "tara", None, None, P(**kw), chunk_tokens=6):
            pass
        outs.append(toks)
    assert outs[0] == outs[1]


def test_band_head_logits_match_full_slice(orpheus_dir):
    tm = tload_model(str(orpheus_dir), dtype=torch.float32, device="cpu")
    band = tload_model(str(orpheus_dir), dtype=torch.float32, device="cpu",
                       audio_band_head=True)
    T = tm.tokens
    rows = np.concatenate([T.audio_token_offset + np.arange(7 * T.codebook_size),
                           [T.end_of_speech]])
    ids = torch.tensor([[T.start_of_human, 5, T.end_of_human]])
    full, _ = tm._step_fn(tm.params, ids, TL.make_cache(tm.config, 1, 16, torch.float32))
    got, _ = band._step_fn(band.params, ids,
                           TL.make_cache(band.config, 1, 16, torch.float32))
    np.testing.assert_allclose(got.numpy(), full.numpy()[:, rows], atol=1e-6)
    idx = int(torch.argmax(got, -1)[0])
    assert int(band._token_map(torch.tensor([idx]))[0]) == int(
        rows[np.argmax(full.numpy()[0, rows])])


def test_band_head_generate_emits_only_band_tokens(orpheus_dir, snac_dir):
    model = _tts(orpheus_dir, snac_dir, audio_band_head=True)
    T = model.tokens
    params = model.default_generation_parameters()
    params.max_tokens = 16
    params.seed = 0
    toks = [e.token for e in model.generate_stream("hi", generation_parameters=params)
            if e.kind == AudioGenerationKind.TOKEN]
    assert toks
    assert all(T.audio_token_offset <= t < T.audio_token_offset + 7 * T.codebook_size
               or t == T.end_of_speech for t in toks)


def _scripted_step(tts, n_groups):
    """A deterministic step emitting valid audio frames, then EOS."""
    T = tts.tokens
    cb, vocab = T.codebook_size, tts.config.vocab_size
    holder = {}

    def step_fn(params, tok, cache):
        i = cache.offset - holder["plen"] + 1  # generated index
        tok_id = (T.end_of_speech if i >= 7 * n_groups
                  else T.audio_token_offset + (i % 7) * cb + (i * 3) % cb)
        logits = torch.zeros((1, vocab))
        logits[0, tok_id] = 100.0
        return logits, cache._replace(offset=cache.offset + 1)

    return step_fn, holder


def _script(tts, text, n_groups):
    step_fn, holder = _scripted_step(tts, n_groups)
    tts._step_fn = step_fn
    tts._decoders.clear()
    holder["plen"] = 1 << max(6, int(np.ceil(np.log2(len(tts.prepare_input_ids(text))))))


def test_generate_full_path_scripted(orpheus_dir, snac_dir):
    tts = _tts(orpheus_dir, snac_dir)
    _script(tts, "hello world", 3)
    audio = tts.generate("hello world", generation_parameters=TParams(
        max_tokens=40, temperature=0.0, repetition_penalty=1.0))
    # 3 frames -> 12 latent frames -> 12 hops (the fixture's hop is 4)
    assert audio.shape == (3 * 4 * tts.codec.config.hop_length,)
    assert np.isfinite(audio).all()


def test_generate_stream_events(orpheus_dir, snac_dir):
    tts = _tts(orpheus_dir, snac_dir)
    _script(tts, "hello", 2)
    events = list(tts.generate_stream("hello", generation_parameters=TParams(
        max_tokens=40, temperature=0.0, repetition_penalty=1.0,
        streaming_interval=0.01)))
    kinds = [e.kind for e in events]
    assert AudioGenerationKind.TOKEN in kinds and AudioGenerationKind.AUDIO in kinds
    assert kinds[-1] == AudioGenerationKind.INFO
    total = sum(len(e.audio) for e in events if e.kind == AudioGenerationKind.AUDIO)
    assert total == 2 * 4 * tts.codec.config.hop_length
    assert events[-1].info.generation_token_count == 14  # 2 frames, EOS stripped


def test_prepare_input_ids_and_ref_audio_match_jax(orpheus_dir, snac_dir):
    jm = jload_model(str(orpheus_dir), dtype=jnp.float32)
    jm.codec = JSNAC.from_pretrained(str(snac_dir))
    tm = _tts(orpheus_dir, snac_dir)
    ref = (np.random.default_rng(2).standard_normal(200) * 0.3).astype(np.float32)
    for args in (("hello world", "tara", None, None), ("hello", None, ref, "w3 w4")):
        assert tm.prepare_input_ids(*args) == jm.prepare_input_ids(*args)
    seq = [1, 2, 93, 100, 101, 102, 103, 104, 105, 106, 107, 94]
    assert tm.parse_output(seq) == jm.parse_output(seq) == [0, 1, 2, 3, 4, 5, 6]


def test_cli_tts_writes_a_wav(orpheus_dir, snac_dir, tmp_path):
    from tpu_audio_torch.cli import tts as cli

    out = tmp_path / "out.wav"
    for extra in ([], ["--stream", "--benchmark"], ["--quantize", "4"]):
        assert cli.main(["hello", "--model", str(orpheus_dir), "--codec", str(snac_dir),
                         "--device", "cpu", "--max-tokens", "21", "--seed", "1",
                         "--band-head", "-o", str(out)] + extra) == 0
        with wave.open(str(out)) as w:
            assert w.getframerate() == 24000 and w.getnframes() > 0
    # --timestamps names the default aligner checkpoint, which is no local
    # directory here: the port downloads nothing, so loading it raises
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        cli.main(["hello", "--model", str(orpheus_dir), "--codec", str(snac_dir),
                  "--device", "cpu", "--max-tokens", "21", "--seed", "1", "--band-head",
                  "-o", str(out), "--timestamps"])


# -- SNAC -------------------------------------------------------------------------


def _zero_noise(jp, tp, cfg):
    base = 2 + (1 if cfg.attn_window_size else 0)
    for i in range(len(cfg.decoder_rates)):
        jl = jp["decoder"]["model"][str(base + i)]["block"]["2"]["linear"]
        tl = tp["decoder"]["model"][str(base + i)]["block"]["2"]["linear"]
        jl["weight"] = jnp.zeros_like(jl["weight"])
        tl["weight"] = torch.zeros_like(tl["weight"])


@pytest.mark.parametrize("attn", [None, 4])
def test_snac_encode_and_decode_match_jax(tmp_path, attn):
    d = make_snac_fixture(tmp_path / "s", vq_strides=(4, 2, 1), attn_window_size=attn)
    js = JSNAC.from_pretrained(str(d))
    ts = load_codec(str(d), codec_type="snac", device="cpu")
    audio = (np.random.default_rng(0).standard_normal(300) * 0.3).astype(np.float32)
    jc, tc = js.encode(audio), ts.encode(audio)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the noise comes from different generators: compare with it off
    _zero_noise(js.params, ts.params, ts.config)
    want = np.asarray(js.decode([np.asarray(c) for c in jc]))
    got = ts.decode(tc).numpy()
    assert got.shape == want.shape == (1, 76 * ts.config.hop_length)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_snac_decode_out_of_range_codes_like_jax(snac_dir):
    """Random LM weights emit codes outside [0, codebook_size): the port
    gathers them as the JAX package does (a negative index counts from the
    end once, then every index is clamped)."""
    js = JSNAC.from_pretrained(str(snac_dir))
    ts = TSNAC.from_pretrained(str(snac_dir), device="cpu")
    _zero_noise(js.params, ts.params, ts.config)
    rng = np.random.default_rng(5)
    codes = [rng.integers(-80, 120, (1, n)).astype(np.int32) for n in (3, 6, 12)]
    assert min(c.min() for c in codes) < -32 and max(c.max() for c in codes) >= 32
    want = np.asarray(js.decode(codes))
    np.testing.assert_allclose(ts.decode(codes).numpy(), want, atol=1e-4)


def test_snac_decode_noise_follows_the_seed(snac_dir):
    ts = TSNAC.from_pretrained(str(snac_dir), device="cpu")
    codes = [np.zeros((1, n), np.int64) + 3 for n in (2, 4, 8)]
    a, b, c = (ts.decode(codes, seed=s).numpy() for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_from_jax_params_carries_llama_and_snac_trees(snac_dir):
    jp = jquant.quantize_tree(JL.init_random_params(
        JL.LlamaConfig(hidden_size=256, num_hidden_layers=2, intermediate_size=512,
                       num_attention_heads=2, num_key_value_heads=1, vocab_size=40),
        seed=1, dtype=jnp.bfloat16), scheme="w8a8")
    tp = from_jax_params(jax_tree_to_numpy(jp))
    q = tp["model"]["layers"]["self_attn"]["q_proj"]["weight"]
    assert isinstance(q, tquant.Int8Tensor) and q.weight.dtype == torch.int8
    np.testing.assert_array_equal(
        q.weight.numpy(), np.asarray(jp["model"]["layers"]["self_attn"]["q_proj"]["weight"].weight))
    norm = tp["model"]["norm"]["weight"]
    assert norm.dtype == torch.bfloat16
    js = JSNAC.from_pretrained(str(snac_dir))
    ts = from_jax_params(jax_tree_to_numpy(js.params))
    cb = ts["quantizer"]["quantizers"]["0"]["codebook"]["weight"]
    np.testing.assert_array_equal(
        cb.numpy(), np.asarray(js.params["quantizer"]["quantizers"]["0"]["codebook"]["weight"]))


def test_kv_cache_update_and_mask_match_jax():
    """``update_cache`` writes at the offset and returns the layer's full
    views; ``attention_mask`` is causal from the offset and masks the
    left padding below ``valid_from``."""
    from tpu_audio.core import kv_cache as jkv
    from tpu_audio_torch.core import kv_cache as tkv

    rng = np.random.default_rng(8)
    k = rng.standard_normal((1, 2, 3, 4)).astype(np.float32)
    v = rng.standard_normal((1, 2, 3, 4)).astype(np.float32)
    jc = jkv.init_cache(2, 1, 2, 4, 10, jnp.float32, valid_from=2)._replace(
        offset=jnp.int32(5))
    tc = tkv.init_cache(2, 1, 2, 4, 10, torch.float32, valid_from=2)._replace(offset=5)
    jc, jk, jv = jkv.update_cache(jc, 1, jnp.asarray(k), jnp.asarray(v))
    tc, tk, tv = tkv.update_cache(tc, 1, torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tkv.attention_mask(tc, 3).numpy(),
                                  np.asarray(jkv.attention_mask(jc, 3)))


def test_snac_reconstruct_keeps_the_length(snac_dir):
    ts = TSNAC.from_pretrained(str(snac_dir), device="cpu")
    audio = (np.random.default_rng(1).standard_normal(240) * 0.1).astype(np.float32)
    out = ts.reconstruct(audio)
    assert out.shape == (1, 240) and np.isfinite(out).all()
