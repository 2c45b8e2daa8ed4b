"""Qwen3-ASR on the PyTorch port against the JAX package, on the CPU at
small sizes: configs, ``feat_extract_output_lengths``,
``split_audio_into_chunks``, the generic ``mel_spectrogram`` (kernel 1's
plain version), the block-attention audio tower on whole and partial
windows, the prompt and its merged embeddings, greedy tokens through
``generate`` and ``decode_features_tokens`` (with and without forced
tokens) on a dense tree, an MLX 4-bit tree, ``kv_bits=8`` and a hybrid
cache whose split lies below the prefill, ``load_model`` and its refusals,
``convert.from_jax_params``, ``ContinuousQwen3ASR`` and the server.

The fixture checkpoint (``make_qwen3_asr_fixture``) has periodic weights
whose logits tie; the parity tests run on copies with seeded normal weights
(``_write``), one at the fixture's widths and one wider, whose widths the
MLX group size divides. In f32 tokens are held equal; in bf16 and on the
4-bit tree they are equal or part where the JAX package's two best logits
lie within the two packages' difference of those logits, with the tokens
before it forced to the JAX package's in both (a near tie that rounding
decides).
"""

import io
import json
import shutil
import threading
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import serve as jserve
from tpu_audio.core import dsp as jdsp
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models import llama as jllama
from tpu_audio.models.stt import load_model as jload_model
from tpu_audio.models.stt import qwen3_asr as JQ
from tpu_audio.parallel import continuous_stt as JCS
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models import llama as tllama
from tpu_audio_torch.models.stt import load_model as tload_model
from tpu_audio_torch.models.stt import qwen3_asr as TQ
from tpu_audio_torch.parallel import continuous_stt as TCS

from fixtures import make_qwen3_asr_fixture
from test_torch_ops import jax_tree_to_numpy
from test_torch_tts_q4 import _quantize_checkpoint

torch.set_num_threads(1)

MAX_TOKENS = 8
# widths the MLX group size (16) divides: the audio tower's and the text
# decoder's products, and the tied embedding
WIDE = dict(audio=dict(d_model=32, encoder_ffn_dim=64, output_dim=64),
            text=dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                      num_key_value_heads=2))


def _write(dst, seed, wide=False):
    """Seeded normal weights for the checkpoint in ``dst`` (updated to
    ``WIDE`` with ``wide``): the audio tower's linears and convs N(0,
    1/fan-in), the text decoder's linears N(0, 9/fan-in), biases N(0, 0.02),
    the embedding N(0, 8/d), LayerNorm and RMSNorm weights 1 + N(0, 0.1),
    the q/k norms' 2.5 times that, LayerNorm biases N(0, 0.02). The larger
    text weights and q/k norms make the tokens follow the audio and the
    earlier tokens (unit ones repeat one token whatever the audio)."""
    from safetensors.numpy import save_file

    conf = json.loads((dst / "config.json").read_text())
    if wide:
        conf["audio_config"].update(WIDE["audio"])
        conf["text_config"].update(WIDE["text"])
    (dst / "config.json").write_text(json.dumps(conf))
    a, t = conf["audio_config"], conf["text_config"]
    rng = np.random.default_rng(seed)

    def rand(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def lin(name, o, i, bias=True, gain=1.0):
        w[f"{name}.weight"] = rand((o, i), gain * i ** -0.5)
        if bias:
            w[f"{name}.bias"] = rand((o,), 0.02)

    def norm(name, n, bias=True, gain=1.0):
        w[f"{name}.weight"] = gain * (1.0 + rand((n,), 0.1))
        if bias:
            w[f"{name}.bias"] = rand((n,), 0.02)

    w = {}
    ds, d, ffn = a["downsample_hidden_size"], a["d_model"], a["encoder_ffn_dim"]
    for i, ic in ((1, 1), (2, ds), (3, ds)):
        w[f"audio_tower.conv2d{i}.weight"] = rand((ds, ic, 3, 3), (9 * ic) ** -0.5)
        w[f"audio_tower.conv2d{i}.bias"] = rand((ds,), 0.02)
    f = a["num_mel_bins"]
    for _ in range(3):
        f = (f + 1) // 2
    lin("audio_tower.conv_out", d, ds * f, bias=False)
    for i in range(a["encoder_layers"]):
        b = f"audio_tower.layers.{i}"
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{b}.self_attn.{p}", d, d)
        norm(f"{b}.self_attn_layer_norm", d)
        norm(f"{b}.final_layer_norm", d)
        lin(f"{b}.fc1", ffn, d)
        lin(f"{b}.fc2", d, ffn)
    norm("audio_tower.ln_post", d)
    lin("audio_tower.proj1", d, d)
    lin("audio_tower.proj2", a["output_dim"], d)
    h, tffn = t["hidden_size"], t["intermediate_size"]
    hd = h // t["num_attention_heads"]
    nq, nkv = t["num_attention_heads"] * hd, t["num_key_value_heads"] * hd
    w["model.embed_tokens.weight"] = rand((t["vocab_size"], h), np.sqrt(8 / h))
    norm("model.norm", h, bias=False)
    for i in range(t["num_hidden_layers"]):
        b = f"model.layers.{i}"
        norm(f"{b}.input_layernorm", h, bias=False)
        norm(f"{b}.post_attention_layernorm", h, bias=False)
        for p, o, i in (("self_attn.q_proj", nq, h), ("self_attn.k_proj", nkv, h),
                        ("self_attn.v_proj", nkv, h), ("self_attn.o_proj", h, nq),
                        ("mlp.gate_proj", tffn, h), ("mlp.up_proj", tffn, h),
                        ("mlp.down_proj", h, tffn)):
            lin(f"{b}.{p}", o, i, bias=False, gain=3.0)
        norm(f"{b}.self_attn.q_norm", hd, bias=False, gain=2.5)
        norm(f"{b}.self_attn.k_norm", hd, bias=False, gain=2.5)
    save_file(w, str(dst / "model.safetensors"))
    return dst


def _is_linear(k, v):
    return v.ndim == 2 and k.endswith(".weight") and not k.endswith("norm.weight")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture as written; a seeded-normal copy; a wider seeded-normal
    copy and that copy MLX-packed at 4 bits in groups of 16."""
    root = tmp_path_factory.mktemp("qwen3_asr")
    src = make_qwen3_asr_fixture(root / "fixture")
    rand = _write(shutil.copytree(src, root / "rand"), seed=3)
    wide = _write(shutil.copytree(src, root / "wide"), seed=4, wide=True)
    q4 = _quantize_checkpoint(wide, root / "q4", 4, 16, _is_linear)
    return {"fixture": src, "rand": rand, "wide": wide, "q4": q4}


_CACHE = {}


def _models(path, dtype="f32"):
    """Both packages' models of the checkpoint in ``path`` (cached)."""
    key = (str(path), dtype)
    if key not in _CACHE:
        jd, td = {"f32": (jnp.float32, torch.float32),
                  "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        jm = jload_model(str(path), dtype=jd)
        cfg = jm.config.text
        # the same prefill without donating its cache: on the CPU the planes
        # of a fresh quantized cache can share one buffer, which a donating
        # call refuses ("donate the same buffer twice")
        jm._prefill = jax.jit(lambda p, embeds, cache: jllama.forward(
            p, None, cache, cfg, inputs_embeds=embeds))
        _CACHE[key] = (jm, tload_model(str(path), dtype=td, device="cpu"))
    return _CACHE[key]


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


# -- small pieces ------------------------------------------------------------------


def test_configs_match_jax(dirs):
    """The config dataclasses' defaults and ``from_dict`` on the fixture
    config equal the JAX package's; the text config always has q/k norms."""
    assert TQ.AudioEncoderConfig().__dict__ == JQ.AudioEncoderConfig().__dict__
    t, j = TQ.Qwen3ASRConfig(), JQ.Qwen3ASRConfig()
    assert (t.audio_token_id, t.classify_num, t.timestamp_token_id,
            t.timestamp_segment_time) == (j.audio_token_id, j.classify_num,
                                          j.timestamp_token_id, j.timestamp_segment_time)
    conf = json.loads((dirs["fixture"] / "config.json").read_text())
    conf["quantization"] = {"group_size": 16, "bits": 4}
    tc, jc = TQ.Qwen3ASRConfig.from_dict(conf), JQ.Qwen3ASRConfig.from_dict(conf)
    assert tc.audio.__dict__ == jc.audio.__dict__
    assert tc.text.__dict__ == jc.text.__dict__ and tc.text.qk_norm
    assert (tc.audio_token_id, tc.support_languages, tc.quantization) == \
        (jc.audio_token_id, jc.support_languages, jc.quantization) == \
        (70, ["English", "Chinese"], {"group_size": 16, "bits": 4})


@pytest.mark.parametrize("n", [0, 1, 2, 7, 8, 99, 100, 101, 800, 2001])
def test_feat_extract_output_lengths(n):
    assert TQ.feat_extract_output_lengths(n) == int(JQ.feat_extract_output_lengths(
        np.asarray(n)))


@pytest.mark.parametrize("case", ["gaps", "short", "stereo", "one_piece", "long"])
def test_split_audio_into_chunks_matches_jax(case):
    """Energy cuts at silent gaps, padding of a short piece, stereo mixed
    down, a signal within one piece, and many cuts."""
    sr = 1000
    rng = np.random.default_rng(7)
    wav = (rng.standard_normal(10 * sr) * 0.5).astype(np.float32)
    kw = dict(chunk_duration=4.0, search_expand_sec=1.0)
    if case == "gaps":
        wav[3500:3700] = 0.0
        wav[7100:7200] = 0.0
    elif case == "short":
        wav, kw = wav[:300], dict(chunk_duration=4.0, min_chunk_duration=1.0)
    elif case == "stereo":
        wav = np.stack([wav, wav[::-1]], axis=1)
    elif case == "one_piece":
        kw = dict(chunk_duration=20.0)
    else:
        wav = np.tile(wav, 4)
        wav[::1700] = 0.0
        kw = dict(chunk_duration=3.0, search_expand_sec=0.5, min_window_ms=50.0)
    got = TQ.split_audio_into_chunks(wav, sr, **kw)
    want = JQ.split_audio_into_chunks(wav, sr, **kw)
    assert len(got) == len(want) and (case in ("short", "one_piece") or len(got) > 1)
    for (g, go), (w, wo) in zip(got, want):
        assert go == wo and g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("n", [0, 100, 399, 400, 401, 1600, 24000])
@pytest.mark.parametrize("n_mels", [128, 16])
def test_mel_spectrogram_matches_jax(n, n_mels):
    """The generic log-mel (its projection and log10 through kernel 1's
    plain version) within 1e-4 of the JAX package's, an empty ``[0,
    n_mels]`` below one frame; a 2-D input comes back as it is."""
    x = _audio(n + n_mels, n)
    got = tdsp.mel_spectrogram(x, 16000, 400, 160, n_mels)
    want = np.asarray(jdsp.mel_spectrogram(jnp.asarray(x), 16000, 400, 160, n_mels))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # an odd n_fft leaves an empty signal short of one frame
    assert tdsp.mel_spectrogram(x[:0], 16000, 401, 160, n_mels).shape == (0, n_mels) == \
        jdsp.mel_spectrogram(jnp.asarray(x[:0]), 16000, 401, 160, n_mels).shape
    spec = np.ones((3, n_mels), np.float32)
    assert np.array_equal(tdsp.mel_spectrogram(spec, 16000, 400, 160, n_mels).numpy(), spec)


# -- the audio tower -------------------------------------------------------------


@pytest.mark.parametrize("frames", [16, 8, 5, 3, 1, 0, 40])
@pytest.mark.parametrize("ckpt", ["rand", "wide"])
def test_encode_single_window_matches_jax(dirs, frames, ckpt):
    """Whole and partial windows (a partial last conv chunk attends to its
    padded tail; more frames than a window widen the bucket) within 1e-5,
    f32."""
    jm, tm = _models(dirs[ckpt])
    mel = np.random.default_rng(frames).standard_normal(
        (frames, tm.config.audio.num_mel_bins)).astype(np.float32)
    got = tm.encode_single_window(mel)
    want = jm.encode_single_window(mel)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_encode_audio_and_preprocess_match_jax(dirs):
    jm, tm = _models(dirs["rand"])
    x = _audio(1, 9000)
    mel, n = tm.preprocess_audio(x)
    jmel, jn = jm.preprocess_audio(x)
    assert n == jn and mel.shape == jmel.shape
    np.testing.assert_allclose(mel.numpy(), jmel, atol=1e-4, rtol=0)
    got, want = tm.encode_audio(mel), jm.encode_audio(jmel)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert tm.encode_audio(mel[:0]).shape == (0, tm.config.audio.output_dim)


# -- prompt ------------------------------------------------------------------------


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_prompt_and_merge_match_jax(dirs, ckpt):
    """``build_prompt`` equal; the merged embeddings (f32 rows of the packed
    table on the 4-bit tree) equal, with the features over the audio
    placeholder run, as many as both have."""
    jm, tm = _models(dirs[ckpt])
    for n, lang, ctx in ((3, None, ""), (5, "English", "a context"), (0, None, "")):
        assert tm.build_prompt(n, context=ctx, language=lang) == \
            jm.build_prompt(n, context=ctx, language=lang)
    ids = np.asarray([tm.build_prompt(4, language="English")], np.int32)
    feats = np.random.default_rng(2).standard_normal(
        (6, tm.config.audio.output_dim)).astype(np.float32)
    for f in (feats, feats[:2]):
        got = tm._merge_audio_features(ids, torch.from_numpy(f))
        want = jm._merge_audio_features(ids, f)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    pos = [i for i, t in enumerate(ids[0]) if t == 70]
    np.testing.assert_array_equal(got[0, pos[:2]].numpy(), feats[:2])


# -- greedy decode ---------------------------------------------------------------

ROUTES = {
    "dense": ("rand", "f32", {}),
    "q4": ("q4", "f32", {}),
    "kv8": ("rand", "f32", dict(kv_bits=8)),
    "hybrid8": ("rand", "f32", dict(kv_bits=8, quantized_kv_start=5)),
    "bf16": ("rand", "bf16", {}),
    "wide": ("wide", "f32", {}),
}
EXACT = ("dense", "kv8", "hybrid8", "wide")


def _forced_logits(jm, tm, jfeats, tfeats, language, row):
    """Both packages' step logits ``[steps, V]`` along ``row`` (the prompt's
    last token, then the tokens to force), after each package's prefill of
    its own features' prompt into a dense cache."""
    ids = np.asarray([jm.build_prompt(jfeats.shape[0], language=language)], np.int32)
    cap = ids.shape[1] + len(row) + 1
    emb = jm._merge_audio_features(ids, jfeats)
    cache = jllama.make_cache(jm.config.text, 1, cap, jm.dtype)
    _, cache = jm._prefill(jm.params, jnp.asarray(emb[:, :-1], jm.dtype), cache)
    jl = []
    for t in row:
        logits, cache = jm._step_fn(jm.params, jnp.asarray([[t]], jnp.int32), cache)
        jl.append(np.asarray(logits[0], np.float32))
    with torch.no_grad():
        emb = tm._merge_audio_features(ids, tfeats)
        cache = tllama.make_cache(tm.config.text, 1, cap, tm.dtype, device="cpu")
        _, cache = tllama.forward(tm.params, None, cache, tm.config.text,
                                  inputs_embeds=emb[:, :-1].to(tm.dtype))
        tl = []
        for t in row:
            logits, cache = tm._step_fn(tm.params, torch.tensor([[t]]), cache)
            tl.append(_f32(logits[0]))
    return np.stack(jl), np.stack(tl)


def assert_greedy_or_witness(jm, tm, jfeats, tfeats, language, got, want, forced=()):
    """``got`` equals ``want``, or at the first parted step the JAX
    package's two best logits are the two tokens and lie within the two
    packages' largest difference of the logits at that step."""
    if got == want:
        return
    n = len(forced)
    s = next(i for i in range(n, min(len(got), len(want)) + 1)
             if i >= min(len(got), len(want)) or got[i] != want[i])
    prompt_last = jm.build_prompt(jfeats.shape[0], language=language)[-1]
    jl, tl = _forced_logits(jm, tm, jfeats, tfeats, language, [prompt_last] + want[:s])
    a, b = want[s], got[s]
    assert {a, b} == set(np.argsort(jl[s])[-2:].tolist()), (s, a, b)
    assert abs(jl[s, a] - jl[s, b]) <= np.abs(jl[s] - tl[s]).max(), s


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("forced", [False, True], ids=["free", "forced"])
def test_greedy_tokens_match_jax(dirs, route, forced):
    """``decode_features_tokens`` (with the first tokens of a free pass
    forced, as the streaming session does) and ``generate`` on 1.5 s."""
    ckpt, dtype, kw = ROUTES[route]
    jm, tm = _models(dirs[ckpt], dtype)
    x = _audio(11, 24000)
    jfeats = jm.encode_audio(jm.preprocess_audio(x)[0])
    tfeats = tm.encode_audio(tm.preprocess_audio(x)[0])
    lang = "English" if forced else None
    want, jn = jm.decode_features_tokens(jfeats, JParams(max_tokens=MAX_TOKENS,
                                                         language=lang, **kw))
    got, tn = tm.decode_features_tokens(tfeats, TParams(max_tokens=MAX_TOKENS,
                                                        language=lang, **kw))
    assert tn == jn and len(got) == len(want) == MAX_TOKENS
    pre = want[:3] if forced else []
    if forced:
        want, _ = jm.decode_features_tokens(jfeats, JParams(max_tokens=MAX_TOKENS,
                                                            language=lang, **kw),
                                            forced_tokens=pre)
        got, tn = tm.decode_features_tokens(tfeats, TParams(max_tokens=MAX_TOKENS,
                                                            language=lang, **kw),
                                            forced_tokens=pre)
        assert got[:3] == want[:3] == pre and tn == jn
    if route in EXACT:
        assert got == want
    else:
        assert_greedy_or_witness(jm, tm, jfeats, tfeats, lang, got, want, pre)
    assert len(set(got)) > 1
    if not forced:
        jo = jm.generate(x, JParams(max_tokens=MAX_TOKENS, **kw))
        to = tm.generate(x, TParams(max_tokens=MAX_TOKENS, **kw))
        assert to.generation_token_count == jo.generation_token_count == MAX_TOKENS
        assert to.prompt_token_count == jo.prompt_token_count
        if got == want:
            assert (to.text, to.language) == (jo.text, jo.language) and to.text
            assert [(s.text, s.start, s.end) for s in to.segments] == \
                [(s.text, s.start, s.end) for s in jo.segments]


def test_hybrid_split_is_rounded_up_to_the_prefill(dirs, monkeypatch):
    """A ``quantized_kv_start`` below the prefill length builds the hybrid
    cache with its dense prefix at the prefill's length, as the JAX package
    does (the port's hybrid cache raises on a write across its split)."""
    jm, tm = _models(dirs["rand"])
    made = []
    make = tllama.make_cache
    monkeypatch.setattr(tllama, "make_cache", lambda *a, **k: made.append(k) or make(*a, **k))
    feats = tm.encode_audio(tm.preprocess_audio(_audio(2, 8000))[0])
    _, n_prompt = tm.decode_features_tokens(feats, TParams(max_tokens=4, kv_bits=8,
                                                           quantized_kv_start=5))
    assert made[-1]["quantized_kv_start"] == n_prompt - 1 > 5 and made[-1]["kv_bits"] == 8


def test_generate_long_audio_and_stream_match_jax(dirs):
    """``chunk_duration`` splits the audio at its quietest points; each
    piece decodes alone and the segments carry the offsets; the stream's
    token and result events."""
    jm, tm = _models(dirs["rand"])
    x = _audio(5, 40000)
    x[14000:16000] = 0.0
    jo = jm.generate(x, JParams(max_tokens=4, chunk_duration=1.2))
    to = tm.generate(x, TParams(max_tokens=4, chunk_duration=1.2))
    assert len(to.segments) == len(jo.segments) > 1
    assert to.text == jo.text
    assert [(s.start, s.end) for s in to.segments] == [(s.start, s.end) for s in jo.segments]
    events = list(tm.generate_stream(x, TParams(max_tokens=4, chunk_duration=1.2)))
    assert [e["type"] for e in events] == ["token", "result"]
    assert events[0]["text"] == events[1]["output"].text == jo.text
    assert tm.generate(np.zeros(0, np.float32), TParams(max_tokens=2)).text == \
        jm.generate(np.zeros(0, np.float32), JParams(max_tokens=2)).text


def test_parse_output_matches_jax():
    for s, lang in (("language English<asr_text>hi there", None), ("plain text", None),
                    ("", None), ("language X<asr_text>abc", "French"), ("abc", "German"),
                    ("language <asr_text> x", None)):
        assert TQ.Qwen3ASR._parse_output(s, lang) == JQ.Qwen3ASR._parse_output(s, lang)


# -- loading -----------------------------------------------------------------------


def test_load_model_and_refusals(dirs, tmp_path):
    """``load_model`` builds a Qwen3ASR with stacked, fused text layers and
    the packed leaves of a ``quantization`` block; a ``thinker.`` prefix
    is stripped; the registry's repo-name fallback finds ``qwen3_asr``; a
    forced-aligner directory name loads the aligner; ``quantize``
    raises."""
    _, tm = _models(dirs["q4"])
    assert isinstance(tm, TQ.Qwen3ASR) and tm.config.text.qk_norm
    layers = tm.params["model"]["layers"]
    assert "qkv_proj" in layers["self_attn"] and "gate_up_proj" in layers["mlp"]
    assert isinstance(layers["self_attn"]["qkv_proj"]["weight"], tquant.QuantizedTensor)
    assert isinstance(tm.params["model"]["embed_tokens"]["weight"], tquant.QuantizedTensor)
    assert isinstance(tm.params["audio_tower"]["layers"]["0"]["fc1"]["weight"],
                      tquant.QuantizedTensor)
    from safetensors.numpy import load_file, save_file

    thinker = shutil.copytree(dirs["rand"], tmp_path / "my-qwen3-asr-thinker")
    w = load_file(str(thinker / "model.safetensors"))
    w = {("thinker." + k if k.startswith(("model.", "audio_tower.")) else k): v
         for k, v in w.items()}
    w["thinker.model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4, np.float32)
    save_file(w, str(thinker / "model.safetensors"))
    cfg = json.loads((thinker / "config.json").read_text())
    del cfg["model_type"]
    (thinker / "config.json").write_text(json.dumps(cfg))
    tt = tload_model(str(thinker), dtype=torch.float32, device="cpu")
    _, tr = _models(dirs["rand"])
    x = _audio(3, 8000)
    assert tt.decode_features_tokens(tt.encode_audio(tt.preprocess_audio(x)[0]),
                                     TParams(max_tokens=4)) == \
        tr.decode_features_tokens(tr.encode_audio(tr.preprocess_audio(x)[0]),
                                  TParams(max_tokens=4))
    # a forced-aligner directory name loads the aligner (the registry's
    # qwen3_forced_aligner) on Qwen3-ASR's loader
    from tpu_audio_torch.models.stt.qwen3_aligner import Qwen3ForcedAligner

    aligner = shutil.copytree(dirs["fixture"], tmp_path / "qwen3-forced-aligner")
    loaded = tload_model(str(aligner), device="cpu")
    assert isinstance(loaded, Qwen3ForcedAligner) and isinstance(loaded, TQ.Qwen3ASR)
    with pytest.raises(ValueError, match="quantize"):
        tload_model(str(dirs["fixture"]), device="cpu", quantize="w8a8")


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_from_jax_params_carries_the_tree(dirs, ckpt):
    """The JAX package's loaded tree through ``convert.from_jax_params``
    (packed MLX leaves and fused projections included) equals the port's
    own, leaf for leaf, and decodes the same tokens."""
    jm, tm = _models(dirs[ckpt])
    conv = from_jax_params(jax_tree_to_numpy(jm.params))

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items()
                    for k2, v in leaves(sub, f"{prefix}{k}.").items()}
        if isinstance(tree, tquant.QuantizedTensor):
            return {prefix + f: getattr(tree, f) for f in ("weight", "scales", "biases")}
        return {prefix: tree}

    a, b = leaves(conv), leaves(tm.params)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    m = TQ.Qwen3ASR(tm.config, conv, tm.tokenizer, torch.float32)
    feats = m.encode_audio(m.preprocess_audio(_audio(4, 8000))[0])
    assert m.decode_features_tokens(feats, TParams(max_tokens=4)) == \
        tm.decode_features_tokens(feats, TParams(max_tokens=4))


def test_init_random_params_decodes(dirs):
    """Random params at a config's shapes, in the loaded tree's layout."""
    _, tm = _models(dirs["rand"])
    params = tllama.fuse_projections(TQ.init_random_params(tm.config, seed=1,
                                                           dtype=torch.float32))
    ref = tm.params

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(params)["audio_tower"] == shapes(ref)["audio_tower"]
    assert shapes(params)["model"]["layers"] == shapes(ref)["model"]["layers"]
    m = TQ.Qwen3ASR(tm.config, params, tm.tokenizer, torch.float32)
    out = m.generate(_audio(6, 16000), TParams(max_tokens=3))
    assert out.generation_token_count == 3


# -- serving -----------------------------------------------------------------------


def test_continuous_qwen3_asr_matches_solo_and_jax(dirs):
    """Staggered requests of different lengths (one queued for a lane, one
    longer than the window) through ``ContinuousQwen3ASR``: each request's
    tokens equal the port's solo decode of the same window and the JAX
    engine's."""
    jm, tm = _models(dirs["rand"])
    window_s, n = 1.0, 6
    clips = [_audio(20 + i, k) for i, k in enumerate((12000, 16000, 5000, 20000))]

    def solo(audio):
        audio = np.pad(audio[:16000], (0, max(0, 16000 - len(audio))))
        mel, n_audio = tm.preprocess_audio(audio)
        feats = tm.encode_audio(mel)[:n_audio]
        return tm.decode_features_tokens(feats, TParams(max_tokens=n))[0]

    def served(engine, model_cls):
        srv = model_cls(engine, slots=2, window_s=window_s, max_tokens=n, step_tokens=3)
        reqs = [srv.submit(a) for a in clips[:3]]
        srv.step()
        reqs.append(srv.submit(clips[3]))
        srv.drain()
        out = [[t for t in srv.engine.requests[r.request_id].tokens if t not in srv.EOS_IDS]
               for r in reqs]
        return out, srv.result(reqs[0].request_id)

    got, res = served(tm, TCS.ContinuousQwen3ASR)
    want, jres = served(jm, JCS.ContinuousQwen3ASR)
    assert got == want == [solo(a) for a in clips]
    assert (res.text, res.language, res.generation_token_count) == \
        (jres.text, jres.language, jres.generation_token_count)
    assert res.segments[0].end == 0.75 and res.segments[0].tokens == got[0]


def test_continuous_qwen3_asr_refusals_and_cancel(dirs):
    """A request's own language and any task but transcription raise as the
    JAX engine's do; a cancelled request frees its lane, the others keep
    their tokens; ``result`` of a live request raises."""
    jm, tm = _models(dirs["rand"])
    for cls, m in ((TCS.ContinuousQwen3ASR, tm), (JCS.ContinuousQwen3ASR, jm)):
        srv = cls(m, slots=2, window_s=0.5, max_tokens=4, language="English")
        with pytest.raises(ValueError, match="per-engine"):
            srv.submit(_audio(1, 4000), language="Chinese")
        with pytest.raises(ValueError, match="transcription only"):
            srv.submit(_audio(1, 4000), task="translate")
    srv = TCS.ContinuousQwen3ASR(tm, slots=2, window_s=0.5, max_tokens=6, step_tokens=2,
                                 min_tick_tokens=2)
    r0, r1 = srv.submit(_audio(1, 4000)), srv.submit(_audio(2, 6000))
    srv.step()
    with pytest.raises(RuntimeError, match="still decoding"):
        srv.result(r0.request_id)
    assert srv.cancel(r1.request_id)
    srv.drain()
    alone = TCS.ContinuousQwen3ASR(tm, slots=2, window_s=0.5, max_tokens=6)
    a0 = alone.submit(_audio(1, 4000))
    alone.drain()
    assert srv.engine.requests[r0.request_id].tokens == alone.engine.requests[a0.request_id].tokens


def _wav(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _post(server, path, body):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


@pytest.mark.parametrize("slots", [1, 2])
def test_server_answers_a_qwen3_asr_as_jax(dirs, slots):
    """``/v1/audio/transcriptions`` (at 2 slots through ``STTEngineWorker``
    on ``ContinuousQwen3ASR``, 20 s windows) and, at 1 slot, the stream
    route: the same text as the JAX server's."""
    jm, tm = _models(dirs["rand"])
    body = _wav(_audio(9, 16000) * 4)
    out = {}
    for name, mod, model in (("t", tserve, tm), ("j", jserve, jm)):
        srv = mod.build_server(model, "stt", "fixture", port=0, slots=slots, step_tokens=4)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            if slots > 1:
                assert name == "j" or srv.stt_worker is not None
            out[name] = json.loads(_post(srv, "/v1/audio/transcriptions", body))
            if slots == 1:
                lines = _post(srv, "/v1/audio/transcriptions/stream", body).splitlines()
                out[name + "s"] = [json.loads(x) for x in lines]
        finally:
            srv.shutdown()
            srv.server_close()
    assert out["t"]["text"] == out["j"]["text"] and out["t"]["text"]
    assert out["t"]["language"] == out["j"]["language"]
    if slots == 1:
        assert [e["type"] for e in out["ts"]] == ["token", "result"]
        assert out["ts"][-1]["text"] == out["js"][-1]["text"] == out["t"]["text"]
