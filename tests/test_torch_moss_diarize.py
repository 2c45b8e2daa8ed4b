"""MOSS-Transcribe-Diarize on the PyTorch port against the JAX package, on
the CPU at small sizes: the config and ``sanitize``, the prompt pieces
(audio token length, the span with its digit time markers, the ChatML
prompt, timestamp shifting and segment parsing, also over random spans
and tag strings), ``encode_audio`` over one and three 30 s windows,
``_inject_audio``, the prefill's logits, greedy tokens, counts, text,
segments and ``generate_stream`` events, the stops (EOS, the degenerate
tail, the budget), the vocabulary check the JAX package lacks, the golden
text, ``load_model``, ``convert.from_jax_params``, random params and the
server.

The fixture checkpoint (``make_moss_diarize_fixture``) has periodic
weights; the parity tests run on copies with seeded normal weights
(``_write``), one at the fixture's widths and one wider, which is also
MLX-packed at 4 bits in groups of 16. In f32 tokens are held equal; in
bf16 and on the 4-bit tree they are equal or part where the JAX package's
two best logits lie within the two packages' difference of those logits.
"""

import json
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_audio.cli import serve as jserve
from tpu_audio.core import nn as jnn
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models import llama as jllama
from tpu_audio.models.stt import load_model as jload_model
from tpu_audio.models.stt import moss_diarize as JM
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import loading as tloading
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models import llama as tllama
from tpu_audio_torch.models.stt import load_model as tload_model
from tpu_audio_torch.models.stt import moss_diarize as TM

from fixtures import make_moss_diarize_fixture
from test_torch_cohere import _post, _wav
from test_torch_ops import jax_tree_to_numpy
from test_torch_tts_q4 import _quantize_checkpoint

torch.set_num_threads(1)

MAX_NEW = 32  # one budget a test, so that each JAX loop compiles once
CLIP = 16000  # 1 s: 13 audio rows, 76 prompt rows
REL = 1e-5  # f32 features and logits, relative to the JAX package's max


def _write(dst, seed, wide=False):
    """Seeded normal weights under the fixture's keys for the checkpoint in
    ``dst`` (the text decoder 32 wide with ``wide``): linears and convs
    N(0, 1/fan-in), biases N(0, 0.02), the token embedding N(0, 1), the
    encoder's positions N(0, 0.1), LayerNorm and RMSNorm weights 1 + N(0,
    0.1) and LayerNorm biases N(0, 0.02). The head is untied, N(0,
    9/fan-in): a tied head repeats the fed token on these weights."""
    from safetensors.numpy import save_file

    conf = json.loads((dst / "config.json").read_text())
    conf["tie_word_embeddings"] = False
    if wide:
        conf["text_config"].update(hidden_size=32, intermediate_size=64)
    (dst / "config.json").write_text(json.dumps(conf))
    tc, ac = conf["text_config"], conf["audio_config"]
    TH, TFFN, V = tc["hidden_size"], tc["intermediate_size"], tc["vocab_size"]
    NH, NKV = tc["num_attention_heads"], tc["num_key_value_heads"]
    hd = TH // NH
    AD, MELS, AFFN = ac["d_model"], ac["num_mel_bins"], ac["encoder_ffn_dim"]
    rng = np.random.default_rng(seed)
    w = {}

    def rand(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def lin(name, o, i, bias=True, gain=1.0):
        w[f"{name}.weight"] = rand((o, i), gain * i ** -0.5)
        if bias:
            w[f"{name}.bias"] = rand((o,), 0.02)

    def norm(name, n, bias=True):
        w[f"{name}.weight"] = 1.0 + rand((n,), 0.1)
        if bias:
            w[f"{name}.bias"] = rand((n,), 0.02)

    enc = "model.whisper_encoder"
    for name, cin in (("conv1", MELS), ("conv2", AD)):
        w[f"{enc}.{name}.weight"] = rand((AD, cin, 3), (3 * cin) ** -0.5)
        w[f"{enc}.{name}.bias"] = rand((AD,), 0.02)
    w[f"{enc}.embed_positions.weight"] = rand((1500, AD), 0.1)
    norm(f"{enc}.layer_norm", AD)
    for layer in range(ac["encoder_layers"]):
        b = f"{enc}.layers.{layer}"
        for proj in ("q_proj", "v_proj", "out_proj"):
            lin(f"{b}.self_attn.{proj}", AD, AD)
        lin(f"{b}.self_attn.k_proj", AD, AD, bias=False)
        norm(f"{b}.self_attn_layer_norm", AD)
        norm(f"{b}.final_layer_norm", AD)
        lin(f"{b}.fc1", AFFN, AD)
        lin(f"{b}.fc2", AD, AFFN)
    lin("model.vq_adwaptor.layers.0", TH, AD * 4)
    lin("model.vq_adwaptor.layers.2", TH, TH)
    norm("model.vq_adwaptor.layers.3", TH)
    lm = "model.language_model"
    w[f"{lm}.embed_tokens.weight"] = rand((V, TH), 1.0)
    norm(f"{lm}.norm", TH, bias=False)
    for layer in range(tc["num_hidden_layers"]):
        b = f"{lm}.layers.{layer}"
        norm(f"{b}.input_layernorm", TH, bias=False)
        norm(f"{b}.post_attention_layernorm", TH, bias=False)
        lin(f"{b}.self_attn.q_proj", NH * hd, TH, bias=False)
        lin(f"{b}.self_attn.k_proj", NKV * hd, TH, bias=False)
        lin(f"{b}.self_attn.v_proj", NKV * hd, TH, bias=False)
        lin(f"{b}.self_attn.o_proj", TH, NH * hd, bias=False)
        norm(f"{b}.self_attn.q_norm", hd, bias=False)
        norm(f"{b}.self_attn.k_norm", hd, bias=False)
        lin(f"{b}.mlp.gate_proj", TFFN, TH, bias=False)
        lin(f"{b}.mlp.up_proj", TFFN, TH, bias=False)
        lin(f"{b}.mlp.down_proj", TH, TFFN, bias=False)
    lin("lm_head", V, TH, bias=False, gain=3.0)
    save_file(w, str(dst / "model.safetensors"))
    return dst


def _is_linear(k, v):
    # the head stays dense: ``sanitize`` moves only ``lm_head.weight`` (the
    # reference ties it), so a packed head's scales would lose their weight
    return v.ndim == 2 and k.endswith(".weight") and "norm" not in k \
        and "embed_positions" not in k and k != "lm_head.weight"


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture as written; a seeded-normal copy; a wider seeded-normal
    copy MLX-packed at 4 bits in groups of 16 (every linear, the token
    embedding, the encoder's and the adaptor's)."""
    root = tmp_path_factory.mktemp("moss")
    src = make_moss_diarize_fixture(root / "fixture")
    rand = _write(shutil.copytree(src, root / "rand"), seed=5)
    wide = _write(shutil.copytree(src, root / "wide"), seed=6, wide=True)
    q4 = _quantize_checkpoint(wide, root / "q4", 4, 16, _is_linear)
    return {"fixture": src, "rand": rand, "q4": q4}


_CACHE = {}


def _models(path, dtype="f32"):
    """Both packages' models of the checkpoint in ``path`` (cached)."""
    key = (str(path), dtype)
    if key not in _CACHE:
        jd, td = {"f32": (jnp.float32, torch.float32),
                  "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        _CACHE[key] = (jload_model(str(path), dtype=jd),
                       tload_model(str(path), dtype=td, device="cpu"))
    return _CACHE[key]


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- host pieces -------------------------------------------------------------------------


def test_config_and_sanitize_match_jax(dirs):
    """``from_dict`` on the fixture's config, an empty one and one with a
    ``quantization_config``; ``sanitize`` on the fixture's keys with an
    ``lm_head``, an MLX ``[O, K, I]`` conv and keys it passes or drops: the
    same keys and values."""
    from safetensors.numpy import load_file

    conf = json.loads((dirs["fixture"] / "config.json").read_text())
    for d in (conf, {}, {"quantization_config": {"bits": 4, "group_size": 32},
                         "tie_word_embeddings": False}):
        t, j = TM.MossTranscribeDiarizeConfig.from_dict(d), JM.MossTranscribeDiarizeConfig.from_dict(d)
        assert (t.text.__dict__, t.audio.__dict__) == (j.text.__dict__, j.audio.__dict__)
        assert (t.audio_token_id, t.audio_merge_size, t.sample_rate, t.quantization) == \
            (j.audio_token_id, j.audio_merge_size, j.sample_rate, j.quantization)
    w = dict(load_file(str(dirs["fixture"] / "model.safetensors")))
    rng = np.random.default_rng(0)
    w.update({"lm_head.weight": rng.standard_normal((100, 24)),
              "model.whisper_encoder.conv1.weight": rng.standard_normal((16, 3, 16)),
              "model.vq_adwaptor.layers.1.weight": np.ones(2),
              "model.extra.bias": np.ones(3)})
    w = {k: np.asarray(v, np.float32) for k, v in w.items()}
    want = JM.sanitize(dict(w))
    got = TM.sanitize({k: torch.from_numpy(v.copy()) for k, v in w.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and np.array_equal(got[k].numpy(), want[k]), k
    assert got["whisper.model.encoder.conv1.weight"].shape == (16, 16, 3)
    assert "vq_adaptor.norm.bias" in got and "language_model.lm_head.weight" in got


@pytest.mark.parametrize("n", [0, 1, 1279, 1280, 1281, 16000, 480000, 1040000])
def test_audio_token_length_matches_jax(dirs, n):
    jm, tm = _models(dirs["rand"])
    assert tm._audio_token_length(n) == jm._audio_token_length(n)


PROMPTS = [None, "", "  Say it.  ", "<|im_start|>user\n<|audio_pad|> w3 w4<|im_end|>"]


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("n", [0, 13, 75, 813])
def test_prompt_matches_jax(dirs, prompt, n):
    """``build_prompt`` (the default prompt, a custom one, one that holds
    its own ``<|audio_pad|>``) over spans with 0, 1 and 13 markers."""
    jm, tm = _models(dirs["rand"])
    got = tm.build_prompt(n, prompt)
    assert got == jm.build_prompt(n, prompt)
    assert got.count(94) == n
    with pytest.raises(ValueError, match="exactly one"):
        tm.build_prompt(n, "<|audio_pad|><|audio_pad|>")


def test_markers_at_65_seconds(dirs):
    """813 audio rows (65 s): 13 markers every 62 rows, "5" of one digit
    and "10" to "65" of two."""
    _, tm = _models(dirs["rand"])
    span = tm._audio_span_ids(813)
    assert span.count(94) == 813 and len(span) == 813 + 1 + 12 * 2
    assert span[62] == 85 and span[62 * 2 + 1:62 * 2 + 3] == [81, 80]
    assert span[62 * 13 + 23:62 * 13 + 25] == [86, 85] and span[-7:] == [94] * 7


@settings(max_examples=80, deadline=None)
@given(n=st.integers(0, 2000), per=st.sampled_from([2.5, 12.5, 25.0]),
       every=st.sampled_from([0, 1, 5, 7]), on=st.booleans())
def test_random_spans_match_jax(dirs, n, per, every, on):
    jm, tm = _models(dirs["rand"])
    for m in (jm, tm):
        m.config.audio_tokens_per_second, m.config.time_marker_every_seconds = per, every
        m.config.enable_time_marker = on
    try:
        assert tm._audio_span_ids(n) == jm._audio_span_ids(n)
    finally:
        for m in (jm, tm):
            m.config.audio_tokens_per_second, m.config.time_marker_every_seconds = 12.5, 5
            m.config.enable_time_marker = True


TAGS = ["[0.00][S01] hello there [2.50]\n[3.00][S02] bye [4.00]", "[1,5][S3] x [0.5]",
        "plain", "", "[0.00][S01]  [1.00]", "[2][S01] a\nb [3] tail [9.99]", "[bad] [1.25]"]


@pytest.mark.parametrize("text", TAGS)
@pytest.mark.parametrize("offset", [0.0, 30.0, 1799.5])
def test_tags_and_segments_match_jax(text, offset):
    assert TM.MossTranscribeDiarize._offset_tags(text, offset) == \
        JM.MossTranscribeDiarize._offset_tags(text, offset)
    got = TM.MossTranscribeDiarize._parse_segments(text, fallback_end=5.0, offset=offset)
    want = JM.MossTranscribeDiarize._parse_segments(text, fallback_end=5.0, offset=offset)
    assert [s.__dict__ for s in got] == [s.__dict__ for s in want]


@settings(max_examples=150, deadline=None)
@given(text=st.lists(st.sampled_from(["[", "]", "0", "1", "2.5", "3,75", "S01", "S2", " ",
                                      "a", "\n", "[12.34]", "[S01]", "."]), max_size=20)
       .map("".join),
       offset=st.sampled_from([0.0, 5.0, 12.5]), end=st.sampled_from([-1.0, 0.0, 7.0]))
def test_random_tag_strings_match_jax(text, offset, end):
    assert TM.MossTranscribeDiarize._offset_tags(text, offset) == \
        JM.MossTranscribeDiarize._offset_tags(text, offset)
    got = TM.MossTranscribeDiarize._parse_segments(text, fallback_end=end, offset=offset)
    want = JM.MossTranscribeDiarize._parse_segments(text, fallback_end=end, offset=offset)
    assert [s.__dict__ for s in got] == [s.__dict__ for s in want]


# -- audio and prefill ---------------------------------------------------------------------


@pytest.mark.parametrize("ckpt,n", [("rand", CLIP), ("rand", 65 * 16000)])
def test_encode_audio_matches_jax(dirs, ckpt, n):
    """The audio rows within 1e-5 of the JAX package's (relative to its
    max), over one 30 s window and over three (65 s: 813 rows)."""
    jm, tm = _models(dirs[ckpt])
    x = _audio(n, n)
    got, want = tm.encode_audio(x), jm.encode_audio(x)
    assert tuple(got.shape) == want.shape == (tm._audio_token_length(n), got.shape[1])
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) < REL


def test_inject_audio_matches_jax_and_checks_the_count(dirs):
    """The audio rows land on the ``<|audio_pad|>`` positions around the
    digit markers, bit for bit as in the JAX package; a count that does
    not match raises in both."""
    jm, tm = _models(dirs["rand"])
    ids = np.asarray([tm.build_prompt(75)], np.int32)
    feats = np.random.default_rng(1).standard_normal((75, 24)).astype(np.float32)
    got = tm._inject_audio(ids, torch.from_numpy(feats))
    want = jm._inject_audio(ids, feats)
    assert np.array_equal(got.numpy(), want)
    pos = np.where(ids[0] == 94)[0]
    assert np.array_equal(got[0, pos].numpy(), feats) and 85 in ids[0].tolist()
    for m, f in ((tm, torch.from_numpy(feats[:74])), (jm, feats[:74])):
        with pytest.raises(ValueError, match="audio tokens"):
            m._inject_audio(ids, f)


def _embeds(m, x, port):
    feats = m.encode_audio(x)
    ids = np.asarray([m.build_prompt(feats.shape[0])], np.int32)
    e = m._inject_audio(ids, feats)
    return ids, (e.to(m.dtype) if port else jnp.asarray(e, m.dtype))


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_prefill_logits_match_jax(dirs, ckpt):
    jm, tm = _models(dirs[ckpt])
    x = _audio(3, 9000)
    ids, je = _embeds(jm, x, False)
    _, te = _embeds(tm, x, True)
    jl, _ = jm._prefill(jm.params["language_model"], je,
                        jllama.make_cache(jm.config.text, 1, ids.shape[1] + 2, jm.dtype))
    with torch.no_grad():
        tl, _ = tllama.forward(tm.params["language_model"], None,
                               tllama.make_cache(tm.config.text, 1, ids.shape[1] + 2, tm.dtype),
                               tm.config.text, inputs_embeds=te)
    assert tl.shape == jl.shape and _rel(tl[0, -1].numpy(), np.asarray(jl)[0, -1]) < REL


# -- decode ----------------------------------------------------------------------------------


def _tokens(m, x, max_new, port, params=None, embeds=None):
    """A package's decode loop on ``x``: (tokens, count)."""
    ids, e = _embeds(m, x, port)
    if embeds is not None:
        e = embeds(e)
    params = params if params is not None else m.params["language_model"]
    if port:
        cache = tllama.make_cache(m.config.text, 1, ids.shape[1] + max_new + 1, m.dtype)
        toks, count = m._decode(params, e, cache, max_new)
        return toks[:count].tolist(), count
    cache = jllama.make_cache(m.config.text, 1, ids.shape[1] + max_new + 1, m.dtype)
    toks, count = m._get_loop(max_new, 0.0)(params, e, cache, jax.random.PRNGKey(0))
    return np.asarray(toks)[:int(count)].tolist(), int(count)


_JSTEP = {}


def _step_logits(jm, tm, x, row):
    """Both packages' logits ``[len(row) + 1, V]`` f32: the prefill's last,
    then after feeding each token of ``row``."""
    ids, je = _embeds(jm, x, False)
    _, te = _embeds(tm, x, True)
    cap = ids.shape[1] + len(row) + 2
    jl, jc = jm._prefill(jm.params["language_model"], je,
                         jllama.make_cache(jm.config.text, 1, cap, jm.dtype))
    tc = tllama.make_cache(tm.config.text, 1, cap, tm.dtype)
    step = _JSTEP.setdefault(id(jm), jax.jit(
        lambda p, t, c: jllama.forward(p, t, c, jm.config.text)))
    with torch.no_grad():
        tl, tc = tllama.forward(tm.params["language_model"], None, tc, tm.config.text,
                                inputs_embeds=te)
        jout, tout = [np.asarray(jl[0, -1], np.float32)], [tl[0, -1].float().numpy()]
        for t in row:
            jl, jc = step(jm.params["language_model"], jnp.asarray([[t]], jnp.int32), jc)
            tl, tc = tllama.forward(tm.params["language_model"], torch.tensor([[t]]), tc,
                                    tm.config.text)
            jout.append(np.asarray(jl[0, -1], np.float32))
            tout.append(tl[0, -1].float().numpy())
    return np.stack(jout), np.stack(tout)


def assert_greedy_or_witness(jm, tm, x, got, want):
    """``got`` equals ``want``, or at the first parted step the JAX
    package's two best logits are the two tokens and lie within the two
    packages' largest difference of the logits at that step."""
    if got == want:
        return
    s = next(i for i in range(min(len(got), len(want)) + 1)
             if i >= min(len(got), len(want)) or got[i] != want[i])
    jl, tl = _step_logits(jm, tm, x, want[:s])
    a, b = want[s], got[s]
    assert {a, b} == set(np.argsort(jl[s])[-2:].tolist()), (s, a, b)
    assert abs(jl[s, a] - jl[s, b]) <= np.abs(jl[s] - tl[s]).max(), s


def test_greedy_generate_and_stream_match_jax(dirs):
    """f32: the loop's tokens and count, then ``generate``'s text, segments
    and counts, and ``generate_stream``'s events, equal to the JAX
    package's; the budget is the count (no EOS in reach, no degenerate
    tail)."""
    jm, tm = _models(dirs["rand"])
    x = _audio(11, CLIP)
    got, want = _tokens(tm, x, MAX_NEW, True), _tokens(jm, x, MAX_NEW, False)
    assert got == want and got[1] == MAX_NEW and len(set(got[0])) > 3
    p = (JParams(max_tokens=MAX_NEW), TParams(max_tokens=MAX_NEW))
    jo, to = jm.generate(x, p[0]), tm.generate(x, p[1])
    assert to.text == jo.text and to.text
    assert [s.__dict__ for s in to.segments] == [s.__dict__ for s in jo.segments]
    assert (to.prompt_token_count, to.generation_token_count) == \
        (jo.prompt_token_count, jo.generation_token_count)
    assert to.generation_token_count == MAX_NEW
    jev, tev = list(jm.generate_stream(x, p[0])), list(tm.generate_stream(x, p[1]))
    assert [e["type"] for e in tev] == [e["type"] for e in jev] == ["token", "result"]
    assert tev[0]["text"] == jev[0]["text"] and tev[1]["output"].text == jev[1]["output"].text


@pytest.mark.parametrize("route", ["bf16", "q4"])
def test_bf16_and_q4_tokens_match_jax_or_part_at_a_near_tie(dirs, route):
    ckpt, dtype = {"bf16": ("rand", "bf16"), "q4": ("q4", "f32")}[route]
    jm, tm = _models(dirs[ckpt], dtype)
    x = _audio(11, CLIP)
    (got, gc), (want, wc) = _tokens(tm, x, MAX_NEW, True), _tokens(jm, x, MAX_NEW, False)
    assert gc == wc == MAX_NEW and len(set(got)) > 1
    assert_greedy_or_witness(jm, tm, x, got, want)


def test_chunks_shift_tags_and_segments_as_jax(dirs):
    """3 s in 1 s chunks (``chunk_duration``): the same joined text and
    shifted segments as the JAX package's."""
    jm, tm = _models(dirs["rand"])
    x = _audio(21, 3 * CLIP)
    jo = jm.generate(x, JParams(max_tokens=MAX_NEW, chunk_duration=1.0))
    to = tm.generate(x, TParams(max_tokens=MAX_NEW, chunk_duration=1.0))
    assert to.text == jo.text and to.text.count("\n") == 2
    assert [(s.text, s.start, s.end, s.speaker) for s in to.segments] == \
        [(s.text, s.start, s.end, s.speaker) for s in jo.segments]
    assert to.segments[-1].start == 2.0


def test_degenerate_tail_stop(dirs):
    """The JAX test's case: the language model zeroed, so that argmax is
    constant; the 3-in-24 guard stops both loops at the same count (24),
    not at the budget."""
    jm, tm = _models(dirs["rand"])
    x = _audio(2, CLIP)
    jzero = jax.tree.map(jnp.zeros_like, jm.params["language_model"])
    tzero = tllama._map(torch.zeros_like, tm.params["language_model"])
    got = _tokens(tm, x, MAX_NEW, True, params=tzero, embeds=torch.zeros_like)
    want = _tokens(jm, x, MAX_NEW, False, params=jzero, embeds=jnp.zeros_like)
    assert got == want and got[1] == 24


def test_eos_stops_the_loop_as_in_jax(dirs, monkeypatch):
    """With EOS ids inside the vocabulary: the prefill's own token as EOS
    gives count 0; a later token as EOS stops both loops at its first
    step, between host reads of the stop flag, with the same count."""
    jm, tm = _models(dirs["rand"])
    x = _audio(11, CLIP)
    free, _ = _tokens(tm, x, MAX_NEW, True)
    late = next(i for i, t in enumerate(free) if i >= 3 and t not in free[:i])
    for eos, count in (((free[0], 151645), 0), ((free[late], 151643), late)):
        monkeypatch.setattr(jm, "eos_token_ids", eos)
        monkeypatch.setattr(jm, "_loops", {})
        monkeypatch.setattr(tm, "eos_token_ids", eos)
        got, want = _tokens(tm, x, MAX_NEW, True), _tokens(jm, x, MAX_NEW, False)
        assert got == want and got[1] == count and got[0] == free[:count]
        jo, to = jm.generate(x, JParams(max_tokens=MAX_NEW)), tm.generate(x, TParams(
            max_tokens=MAX_NEW))
        assert (to.text, to.generation_token_count) == (jo.text, jo.generation_token_count)


def test_ids_past_the_vocabulary_raise_where_jax_clamps(dirs):
    """The reference's default config puts ``audio_token_id`` (151,671)
    past ``LlamaConfig()``'s 128,256 rows: the port refuses it at
    construction, and a prompt id past the table in ``_inject_audio``. The
    JAX package clamps the gather (the id reads the last row) and, with
    its EOS ids past the table, never stops on EOS: its loop runs to the
    budget."""
    with pytest.raises(ValueError, match="past the text vocabulary"):
        TM.MossTranscribeDiarize(TM.MossTranscribeDiarizeConfig(), {})
    assert TM.MossTranscribeDiarizeConfig().text.vocab_size == 128256
    jm, tm = _models(dirs["rand"])
    table = jm.params["language_model"]["model"]["embed_tokens"]
    clamped = np.asarray(jnn.embedding(table, jnp.asarray([151671])))
    assert np.array_equal(clamped[0], np.asarray(table["weight"])[-1])
    with pytest.raises(ValueError, match="past the text vocabulary"):
        tm._inject_audio(np.asarray([[3, 151671]]), torch.zeros((0, 24)))
    assert min(jm.eos_token_ids) >= jm.config.text.vocab_size
    assert _tokens(jm, _audio(11, CLIP), MAX_NEW, False)[1] == MAX_NEW


def test_golden_text_bytes(dirs):
    """``moss_diarize_text_bytes`` of ``tests/golden/zoo_goldens.json``: the
    fixture in bf16 on 1 s of seed-18 noise, 8 tokens."""
    golden = json.loads((Path(__file__).parent / "golden" / "zoo_goldens.json").read_text())
    want = golden["moss_diarize_text_bytes"]
    _, tm = _models(dirs["fixture"], "bf16")
    out = tm.generate((np.random.default_rng(18).standard_normal(16000) * 0.1).astype(
        np.float32), TParams(max_tokens=8))
    got = list(out.text.encode())
    assert len(got) == want["shape"] and got[:len(want["first"])] == want["first"]


# -- loading, conversion, random params, server ------------------------------------------


def test_load_model_by_both_names(dirs, tmp_path):
    """``moss_transcribe_diarize`` as ``model_type``, ``mosstranscribediarize``
    found in the directory's name, a tied ``lm_head`` dropped; the packed
    tree's leaves tagged, its projections fused and its untied head kept;
    ``quantize`` raises."""
    from safetensors.numpy import load_file, save_file

    for name, model_type in (("a", "moss_transcribe_diarize"),
                             ("MOSS-Transcribe-Diarize-tiny", "unknown")):
        d = shutil.copytree(dirs["fixture"], tmp_path / name)
        conf = json.loads((d / "config.json").read_text())
        conf["model_type"] = model_type
        (d / "config.json").write_text(json.dumps(conf))
        w = dict(load_file(str(d / "model.safetensors")))
        w["lm_head.weight"] = np.ones((100, 24), np.float32)
        save_file(w, str(d / "model.safetensors"))
        m = tload_model(str(d), device="cpu")
        assert isinstance(m, TM.MossTranscribeDiarize) and m.dtype == torch.bfloat16
        assert m._digit_ids["5"] == 85 and m.config.audio_tokens_per_second == 12.5
        assert "lm_head" not in m.params["language_model"]
    _, tq = _models(dirs["q4"])
    lm = tq.params["language_model"]["model"]["layers"]
    assert isinstance(lm["self_attn"]["qkv_proj"]["weight"], tquant.QuantizedTensor)
    assert isinstance(tq.params["vq_adaptor"]["fc1"]["weight"], tquant.QuantizedTensor)
    assert isinstance(tq.params["language_model"]["lm_head"]["weight"], torch.Tensor)
    with pytest.raises(ValueError, match="quantize"):
        TM.MossTranscribeDiarize.from_pretrained(str(dirs["fixture"]), device="cpu",
                                                 quantize="w8a8")


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_from_jax_params_carries_the_tree(dirs, ckpt):
    """The JAX package's sanitized tree (dense or MLX-packed) through
    ``convert.from_jax_params``: the port's loaded tree key for key, and
    the same tokens."""
    jm, tm = _models(dirs[ckpt])
    conv = from_jax_params(jax_tree_to_numpy(jm.params))
    flat_c, flat_t = tloading.flatten(conv), tloading.flatten(tm.params)
    assert flat_c.keys() == flat_t.keys()
    m = TM.MossTranscribeDiarize(tm.config, conv, tm.tokenizer, torch.float32)
    x = _audio(11, CLIP)
    assert _tokens(m, x, 4, True) == _tokens(tm, x, 4, True)


def test_init_random_params_has_the_loaded_layout(dirs):
    _, tm = _models(dirs["rand"])
    p = TM.init_random_params(tm.config, seed=0, dtype=torch.float32)
    p["language_model"] = tllama.fuse_projections(p["language_model"])
    got = {k: tuple(v.shape) for k, v in tloading.flatten(p).items()}
    want = {k: tuple(v.shape) for k, v in tloading.flatten(tm.params).items()}
    assert got == want
    m = TM.MossTranscribeDiarize(tm.config, p, tm.tokenizer, torch.float32)
    assert m.encode_audio(_audio(1, 8000)).shape == (7, 24)


def test_server_answers_moss_as_jax(dirs):
    """``serve --task stt --slots 2`` builds no engine for MOSS (as the JAX
    server) and answers ``/v1/audio/transcriptions`` and the stream route
    through the locked ``generate`` / ``generate_stream``: the JAX
    server's text, segments and events."""
    jm, tm = _models(dirs["fixture"], "bf16")
    body = _wav(_audio(9, 16000) * 4)
    out = {}
    for name, mod, model in (("t", tserve, tm), ("j", jserve, jm)):
        srv = mod.build_server(model, "stt", "fixture", port=0, slots=2)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            if name == "t":
                assert srv.stt_worker is None
            out[name] = json.loads(_post(srv, "/v1/audio/transcriptions", body))
            out[name + "s"] = [json.loads(x) for x in _post(
                srv, "/v1/audio/transcriptions/stream", body).splitlines()]
        finally:
            srv.shutdown()
            srv.server_close()
    assert out["t"]["text"] == out["j"]["text"] and out["t"]["text"]
    assert out["t"]["segments"] == out["j"]["segments"]
    assert [e["type"] for e in out["ts"]] == [e["type"] for e in out["js"]]
    assert out["ts"][-1]["text"] == out["js"][-1]["text"] == out["t"]["text"]
