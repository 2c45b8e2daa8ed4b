"""Qwen3-TTS on the PyTorch port against the JAX package, on the CPU at
small sizes in f32: the talker's logits and hidden states, each
code-predictor group's logits, the prompt embeddings, greedy codes through
``generate`` for the f32, w8a8 and MLX 8-bit and 4-bit trees, streaming
against offline synthesis, voice parsing, the missing-encoder error,
``load_model``, the CLI and the server.

The fixture checkpoint (tests/fixtures.make_qwen3_tts_fixture, a
``custom_voice`` model with its speech tokenizer's decoder) has periodic
weights, whose logits tie exactly; greedy codes on it then hang on the
last bit of each sum. So the comparisons run on checkpoints of the same
layout with seeded normal weights (``_write``): "rand" at the fixture's
widths, its MLX 8-bit and 4-bit copies (``quantization`` block, group
size 8), and "wide" at width 256, where ``quantize_bits`` quantizes every
projection and embedding to MLX 8 or 4 bits or to int8 (the quantizer
skips inputs narrower than 256).
Tolerances: 1e-4 of the largest value for logits, hidden states and
embeddings (f32 sums in another order); 1e-5 absolute on waveforms.
"""

import json
import shutil
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import kv_cache as jkv
from tpu_audio.core import loading as jloading
from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio.models.tts import qwen3_tts as JQ
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationError, AudioGenerationKind
from tpu_audio_torch.models.tts import load_model as tload_model
from tpu_audio_torch.models.tts import qwen3_tts as TQ
from tpu_audio_torch.ops import qmm

from fixtures import make_qwen3_tts_fixture

torch.set_num_threads(1)

RTOL = 1e-4
GREEDY = dict(max_tokens=6, temperature=0.0, repetition_penalty=1.05)
TEXT = "hello world w3 w9"
WIDE = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, text_hidden_size=256)
PACKED_GROUP = 8  # divides the fixture's widths 16, 24 and 32


def _write(src, dst, seed, widths=None, bits=None):
    """A copy of the fixture checkpoint ``src`` (its tokenizer and speech
    tokenizer) whose talker weights are N(0, 1/sqrt(in)) draws from
    ``seed`` (embeddings N(0, 0.5), norms 1 + N(0, 0.1)), at the talker and
    code-predictor ``widths`` given, MLX-packed at ``bits`` when given."""
    from safetensors.numpy import save_file

    shutil.copytree(src, dst)
    cfg = json.loads((dst / "config.json").read_text())
    tc = cfg["talker_config"]
    cp = tc["code_predictor_config"]
    if widths:
        tc.update(widths)
        cp.update({k: v for k, v in widths.items() if k != "text_hidden_size"})
    if bits:
        cfg["quantization"] = {"group_size": PACKED_GROUP, "bits": bits}
    (dst / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(seed)
    src_w = jloading.load_safetensors(src)
    out = {}

    def put(name, shape, kind):
        if kind == "norm":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif kind == "embed":
            a = 0.5 * rng.standard_normal(shape)
        elif kind == "bias":
            a = 0.05 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-1])
        a = a.astype(np.float32)
        if bits and a.ndim == 2:
            w, s, b = jquant.quantize(a, PACKED_GROUP, bits)
            out[name], out[name[:-6] + "scales"], out[name[:-6] + "biases"] = w, s, b
        else:
            out[name] = a

    H, TH, inter = tc["hidden_size"], tc["text_hidden_size"], tc["intermediate_size"]
    hd, nh, nkv = tc["head_dim"], tc["num_attention_heads"], tc["num_key_value_heads"]
    for name, v in sorted(src_w.items()):
        if not name.startswith("talker."):
            continue
        parts = name.split(".")
        shape = list(v.shape)
        kind = "weight"
        if name.endswith("norm.weight"):
            kind = "norm"
            shape = [hd if ("q_norm" in name or "k_norm" in name) else H]
        elif "embedding" in name:
            kind = "embed"
            shape = [shape[0], TH if "text_embedding" in name else H]
        elif name.endswith(".bias"):
            kind = "bias"
            shape = [TH if "linear_fc1" in name else H]
        elif "q_proj" in parts:
            shape = [nh * hd, H]
        elif "k_proj" in parts or "v_proj" in parts:
            shape = [nkv * hd, H]
        elif "o_proj" in parts:
            shape = [H, nh * hd]
        elif "gate_proj" in parts or "up_proj" in parts:
            shape = [inter, H]
        elif "down_proj" in parts:
            shape = [H, inter]
        elif "linear_fc1" in parts:
            shape = [TH, TH]
        elif "linear_fc2" in parts:
            shape = [H, TH]
        elif "codec_head" in parts or "lm_head" in parts:
            shape = [shape[0], H]
        put(name, tuple(shape), kind)
    save_file(out, str(dst / "model.safetensors"))
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("qwen3tts")
    fix = make_qwen3_tts_fixture(root / "fixture")
    return {"fixture": fix, "rand": _write(fix, root / "rand", 11),
            "q8": _write(fix, root / "q8", 11, bits=8),
            "q4": _write(fix, root / "q4", 11, bits=4),
            "wide": _write(fix, root / "wide", 12, widths=WIDE)}


@pytest.fixture(scope="module")
def models(dirs):
    """``models(which, bits)``: the JAX and the port model of checkpoint
    ``which`` (``quantize_bits=bits``); ``models(which, bits, jax=False)``
    the port's alone. Each model is built once."""
    built = {}

    def get(which, bits=None, jax=True):
        kw = {} if bits is None else {"quantize_bits": bits}
        if (which, bits) not in built:
            built[which, bits] = tload_model(str(dirs[which]), dtype=torch.float32,
                                             device="cpu", **kw)
        if not jax:
            return built[which, bits]
        if (which, bits, "jax") not in built:
            built[which, bits, "jax"] = jload_model(str(dirs[which]), dtype=jnp.float32, **kw)
        return built[which, bits, "jax"], built[which, bits]

    return get


def _codes(model, gp, text=TEXT, voice=None, language=None):
    speaker, instruct = model._parse_voice(voice)
    if isinstance(model, TQ.Qwen3TTS):
        *_, (kind, payload) = model._run_iter(text, language, instruct, speaker, gp)
    else:
        payload = model._run(text, language, instruct, speaker, gp)
    return np.stack(payload[0]) if payload[0] else np.zeros((0,))


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


# -- loading ------------------------------------------------------------------------


def test_load_model_builds_qwen3_tts_with_its_codec(dirs):
    m = tload_model(str(dirs["fixture"]), dtype=torch.float32, device="cpu")
    assert isinstance(m, TQ.Qwen3TTS) and m.codec is not None
    assert m.config.talker.num_code_groups == 4 and m.config.tts_model_type == "custom_voice"
    assert m.sample_rate == 24000 and m.codec.config.total_upsample == 8
    layers = m.params["model"]["layers"]
    assert "qkv_proj" in layers["self_attn"] and layers["self_attn"]["qkv_proj"]["weight"].ndim == 3
    assert "gate_up_proj" in m.params["code_predictor"]["model"]["layers"]["mlp"]


@pytest.mark.parametrize("which,bits", [("q8", None), ("q4", None), ("wide", 8), ("wide", 4),
                                        ("wide", "w8a8")])
def test_quantized_trees_pack_what_jax_packs(dirs, models, which, bits):
    """The same leaves quantized in both packages (projections,
    embeddings, heads and the text projection), and the same fused q/k/v
    words or codes: the JAX model's, or for ``quantize_bits=4|8`` the JAX
    package's quantizer on the checkpoint's weights."""
    tm = models(which, bits, jax=False)
    kind = tquant.Int8Tensor if bits == "w8a8" else tquant.QuantizedTensor
    leaves = [tm.params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"],
              tm.params["model"]["codec_embedding"]["weight"],
              tm.params["model"]["text_embedding"]["weight"],
              tm.params["text_projection"]["linear_fc1"]["weight"],
              tm.params["codec_head"]["weight"],
              tm.params["code_predictor"]["lm_head"]["2"]["weight"],
              tm.params["code_predictor"]["model"]["codec_embedding"]["0"]["weight"]]
    assert all(isinstance(w, kind) for w in leaves)
    got = leaves[0].weight.numpy()
    if bits in (4, 8):
        flat = jloading.load_safetensors(dirs[which])
        want = np.concatenate([jquant.quantize(flat[f"talker.model.layers.0.self_attn.{n}"
                                                    ".weight"], 64, bits)[0]
                               for n in ("q_proj", "k_proj", "v_proj")])
        got = got[0]
        assert leaves[0].group_size == 64 and leaves[0].bits == bits
    else:
        jm, _ = models(which, bits)
        want = np.asarray(jm.params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"].weight)
    np.testing.assert_array_equal(got, want.view(got.dtype))


# -- the talker, the code predictor and the prompt --------------------------------------


@pytest.mark.parametrize("which,bits", [("rand", None), ("q4", None)])
def test_talker_logits_and_hidden_match_jax(models, which, bits):
    """A 7-row prefill and a cached step on seeded embeddings."""
    jm, tm = models(which, bits)
    tc = tm.config.talker
    x = np.random.default_rng(3).standard_normal((1, 8, tc.hidden_size)).astype(np.float32)
    jc = jkv.init_cache(tc.num_hidden_layers, 1, tc.num_key_value_heads, tc.head_dim, 16,
                        jnp.float32)
    tcache = tkv.init_cache(tc.num_hidden_layers, 1, tc.num_key_value_heads, tc.head_dim, 16,
                            torch.float32)
    for s, e in ((0, 7), (7, 8)):
        jl, jh, jc = JQ.talker_forward(jm.params, jnp.asarray(x[:, s:e]), jc, jm.config.talker)
        tl, th, tcache = TQ.talker_forward(tm.params, torch.from_numpy(x[:, s:e]), tcache, tc)
        _close(tl, jl)
        _close(th, jh)
    assert tcache.offset == 8


def test_from_jax_params_carries_the_qwen3_tree(models):
    """The JAX package's random talker and code-predictor tree (numpy
    draws, stacked layers, per-group heads, the text projection) carried
    across with ``convert.from_jax_params``: the same prompt embeddings and
    talker logits."""
    from tpu_audio_torch.convert import from_jax_params

    from test_torch_ops import jax_tree_to_numpy

    jm, tm = models("rand")
    jp = JQ.init_random_params(jm.config, seed=5, dtype=jnp.float32)
    j = JQ.Qwen3TTS(jm.config, jp, jm.tokenizer)
    t = TQ.Qwen3TTS(tm.config, from_jax_params(jax_tree_to_numpy(jp)), tm.tokenizer)
    want = j.prepare_generation_inputs(TEXT, speaker="vivian")[0]
    got = t.prepare_generation_inputs(TEXT, speaker="vivian")[0]
    _close(got, want)
    jl, jh, _ = JQ.talker_forward(jp, want, None, jm.config.talker)
    tl, th, _ = TQ.talker_forward(t.params, got, None, tm.config.talker)
    _close(tl, jl)
    _close(th, jh)


@pytest.mark.parametrize("which,bits", [("rand", None), ("q8", None)])
def test_code_predictor_group_logits_match_jax(models, which, bits):
    """Pass 0 over two rows, then one row through each later group's head,
    in one fresh G + 2-row cache."""
    jm, tm = models(which, bits)
    cc = tm.config.code_predictor
    G = tm.config.talker.num_code_groups
    rng = np.random.default_rng(4)
    jc = jkv.init_cache(cc.num_hidden_layers, 1, cc.num_key_value_heads, cc.head_dim, G + 2,
                        jnp.float32)
    tcache = tkv.init_cache(cc.num_hidden_layers, 1, cc.num_key_value_heads, cc.head_dim,
                            G + 2, torch.float32)
    for g in range(G - 1):
        x = rng.standard_normal((1, 2 if g == 0 else 1, tm.config.talker.hidden_size))
        x = x.astype(np.float32)
        jl, jc = JQ.code_predictor_forward(jm.params["code_predictor"], jnp.asarray(x), jc, g,
                                           jm.config.code_predictor)
        tl, tcache = TQ.code_predictor_forward(tm.params["code_predictor"],
                                               torch.from_numpy(x), tcache, g, cc)
        assert tl.shape == (1, x.shape[1], cc.vocab_size)
        _close(tl, jl)


@pytest.mark.parametrize("kw", [{}, {"speaker": "vivian"}, {"language": "english"},
                                {"instruct": "speak slowly", "speaker": "vivian",
                                 "language": "english"}])
@pytest.mark.parametrize("which,bits", [("rand", None), ("q4", None)])
def test_prepare_generation_inputs_match_jax(models, which, bits, kw):
    jm, tm = models(which, bits)
    got = tm.prepare_generation_inputs(TEXT, **kw)
    want = jm.prepare_generation_inputs(TEXT, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    base = tm.prepare_generation_inputs(TEXT)[0].shape[1]
    extra = ("speaker" in kw) + ("language" in kw)
    assert got[0].shape[1] == base + extra + (9 if "instruct" in kw else 0)


# -- generation -------------------------------------------------------------------------


@pytest.mark.parametrize("which,bits", [("rand", None), ("q8", None), ("q4", None),
                                        ("wide", "w8a8")])
def test_greedy_codes_match_jax(models, which, bits):
    """Greedy ``generate`` codes (repetition penalty 1.05 on codebook 0)
    equal the JAX package's, frame for frame and group for group."""
    jm, tm = models(which, bits)
    got = _codes(tm, TParams(**GREEDY), voice="vivian")
    want = _codes(jm, JParams(**GREEDY), voice="vivian")
    assert got.shape == (GREEDY["max_tokens"], 4)
    np.testing.assert_array_equal(got, want)


def test_generate_waveform_matches_jax(models):
    jm, tm = models("rand")
    got = tm.generate(TEXT, language="english", generation_parameters=TParams(**GREEDY))
    want = np.asarray(jm.generate(TEXT, language="english",
                                  generation_parameters=JParams(**GREEDY)))
    assert got.shape == want.shape == (GREEDY["max_tokens"] * 8,)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("frames", [1, 2, 4])
def test_generate_stream_chunks_match_generate(models, frames):
    """``streaming_interval`` of ``frames`` frames: the chunks, concatenated,
    are ``generate``'s waveform; the info event counts the frames."""
    tm = models("rand", jax=False)
    gp = TParams(**GREEDY, streaming_interval=frames / 12.5)
    offline = tm.generate(TEXT, generation_parameters=gp)
    events = list(tm.generate_stream(TEXT, generation_parameters=gp))
    chunks = [e.audio for e in events if e.kind == AudioGenerationKind.AUDIO]
    assert len(chunks) == -(-GREEDY["max_tokens"] // frames)
    np.testing.assert_allclose(np.concatenate(chunks), offline, atol=1e-5)
    info = events[-1].info
    assert events[-1].kind == AudioGenerationKind.INFO
    assert info.generation_token_count == GREEDY["max_tokens"]
    assert info.audio_duration == pytest.approx(len(offline) / 24000)


def test_every_product_of_an_mlx_tree_runs_kernel_7(models, monkeypatch):
    """On an MLX tree every product goes to ``qmm.quantized_matvec`` (its
    plain version here): the text projection's 4 calls over the prompt's
    rows, the prefill's 4 a talker layer, and per frame the talker step's
    4 a layer and the codec head at 1 row, code-predictor pass 0 at 2 rows
    and passes 1..G-2 at 1 row (4 a layer and the group head each)."""
    tm = models("wide", 8, jax=False)
    L = tm.config.talker.num_hidden_layers
    Lc = tm.config.code_predictor.num_hidden_layers
    G = tm.config.talker.num_code_groups
    rows = []
    ref = qmm.quantized_matvec

    def spy(x, *a, **k):
        rows.append(x.shape[0])
        return ref(x, *a, **k)

    monkeypatch.setattr(qmm, "quantized_matvec", spy)
    chat = f"<|im_start|>assistant\n{TEXT}<|im_end|>\n<|im_start|>assistant\n"
    n_chat = len(tm.tokenizer.encode(chat).ids)
    prompt = tm.prepare_generation_inputs(TEXT)[0].shape[1]
    assert rows == [n_chat, n_chat, 3, 3] and prompt - 1 <= qmm.MAX_ROWS
    rows.clear()
    frames = len(_codes(tm, TParams(**GREEDY)))
    assert frames == GREEDY["max_tokens"]
    frame = [1] * (4 * L + 1) + [2] * (4 * Lc + 1) + [1] * (G - 2) * (4 * Lc + 1)
    assert rows == [n_chat, n_chat, 3, 3] + [prompt - 1] * 4 * L + frame * frames


def test_sampled_codes_follow_the_masked_distribution():
    """``_sample`` at temperature 0.7, top-k 3 and top-p 0.9 over fixed
    logits: only the JAX package's kept ids are drawn, at the frequencies
    of their softmax (the random bits differ between the packages)."""
    from tpu_audio.core import sampling as jsampling

    logits = np.array([[2.0, 1.5, 1.4, 0.2, -1.0, 1.45]], np.float32)
    masked = np.asarray(jsampling._mask_top_p(jsampling._mask_top_k(
        jnp.asarray(logits), 3), 0.9))[0]
    p = np.exp((masked - masked.max()) / 0.7)
    p /= p.sum()
    gen = torch.Generator().manual_seed(0)
    draws = TQ._sample(gen, torch.from_numpy(np.repeat(logits, 20000, 0)), 0.7, 3, 0.9)
    freq = np.bincount(draws.numpy(), minlength=6) / 20000
    assert set(np.flatnonzero(freq)) == set(np.flatnonzero(p))
    np.testing.assert_allclose(freq, p, atol=0.015)


def test_sampled_generate_repeats_for_a_seed(models):
    tm = models("rand", jax=False)
    gp = dict(max_tokens=5, temperature=0.9, top_k=50, seed=3)
    a = _codes(tm, TParams(**gp))
    assert np.array_equal(a, _codes(tm, TParams(**gp)))
    assert a.shape == (5, 4) and a.max() < tm.config.talker.vocab_size


@pytest.mark.parametrize("voice,want", [("vivian, speak slowly", ("vivian", "speak slowly")),
                                        ("vivian", ("vivian", None)), (None, (None, None)),
                                        ("vivian,", ("vivian", None))])
def test_parse_voice_matches_jax(models, voice, want):
    jm, tm = models("rand")
    assert tm._parse_voice(voice) == jm._parse_voice(voice) == want


@pytest.mark.parametrize("kw,match", [({"ref_audio": np.zeros(800, np.float32),
                                        "ref_text": "hello"}, "encoder"),
                                       ({"ref_audio": np.zeros(800, np.float32)}, "BOTH"),
                                       ({"ref_text": "hello"}, "BOTH")])
def test_reference_audio_raises(models, kw, match):
    tm = models("rand", jax=False)
    with pytest.raises(AudioGenerationError, match=match):
        tm.generate("hi", generation_parameters=TParams(**GREEDY), **kw)


def test_init_random_params_matches_the_loaded_tree(models):
    from tpu_audio_torch.models import llama

    tm = models("rand", jax=False)
    rand = TQ.init_random_params(tm.config, dtype=torch.float32)
    rand = llama.fuse_projections(rand)
    rand["code_predictor"] = llama.fuse_projections(rand["code_predictor"])

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(rand) == shapes(tm.params)


# -- the CLI and the server ------------------------------------------------------------------


def _wav_frames(path):
    with wave.open(str(path)) as w:
        return w.getnframes(), w.getframerate()


@pytest.mark.parametrize("extra", [[], ["--stream"], ["--quantize", "8"]])
def test_cli_tts_writes_a_wav(dirs, tmp_path, extra):
    from tpu_audio_torch.cli import tts as cli

    which = "wide" if "--quantize" in extra else "fixture"
    out = tmp_path / "out.wav"
    assert cli.main([TEXT, "--model", str(dirs[which]), "--device", "cpu", "--voice",
                     "vivian, calm", "--max-tokens", "5", "--temperature", "0", "-o",
                     str(out), *extra]) == 0
    n, sr = _wav_frames(out)
    assert sr == 24000 and n == 5 * 8


def test_cli_tts_refuses_orpheus_only_flags(dirs, tmp_path):
    from tpu_audio_torch.cli import tts as cli

    with pytest.raises(SystemExit, match="band-head"):
        cli.main(["hi", "--model", str(dirs["fixture"]), "--device", "cpu", "--band-head",
                  "-o", str(tmp_path / "o.wav")])


def test_server_refuses_qwen3_at_several_slots(models):
    """At ``slots > 1`` the server builds a ``Qwen3TTSEngineWorker`` for a
    Qwen3-TTS model (tests/test_torch_qwen3_serving.py serves through it);
    what it refuses there is reference-audio cloning, a solo-path
    feature."""
    from tpu_audio_torch.cli.serve import build_server
    from tpu_audio_torch.parallel.continuous_qwen3 import Qwen3TTSEngineWorker

    tm = models("rand", jax=False)
    srv = build_server(tm, "tts", "q3", port=0, slots=2)
    try:
        assert isinstance(srv.tts_worker, Qwen3TTSEngineWorker)
        assert srv.tts_worker._srv.slots == 2
        with pytest.raises(ValueError, match="CustomVoice"):
            next(srv.tts_worker.synthesize(TEXT, ref_audio=np.zeros(800, np.float32),
                                           ref_text="hello"))
    finally:
        srv.server_close()
    assert not srv.tts_worker._thread.is_alive()


@pytest.mark.parametrize("path", ["/v1/audio/speech", "/v1/audio/speech/stream"])
def test_server_speaks_through_generate_at_one_slot(models, path):
    import threading
    import urllib.request

    from tpu_audio_torch.cli.serve import build_server

    tm = models("rand", jax=False)
    srv = build_server(tm, "tts", "q3", port=0, slots=1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}{path}", method="POST",
            data=json.dumps({"input": TEXT, "voice": "vivian", "max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    n = 4 * 8  # 4 frames of 8 samples
    assert len(body) == (44 + 2 * n if path.endswith("speech") else 2 * n)
