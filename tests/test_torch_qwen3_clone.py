"""Qwen3-TTS voice cloning on the PyTorch port against the JAX package, on
the CPU: the speech tokenizer's encoder, the speaker encoder and its mel,
the in-context prompt, greedy cloned codes and the trimmed waveform
through ``generate`` and ``generate_stream``, the reference cache, the
refusals, loading (the CLI and the server: test_torch_qwen3_clone_serving).

Checkpoints: ``make_qwen3_tts_fixture(with_icl=True)`` as written (a "base"
model with a speaker encoder and a speech tokenizer encoder, periodic
weights), and "rand", a copy with seeded normal weights throughout (the
talker through ``test_torch_qwen3_tts._write``; the speaker encoder and
the encoder here, its EMA codebooks' usage not all ones); "q8" is "rand"
with its talker MLX-packed at 8 bits. Codes must be equal; RVQ codes that
part at a near tie must show the witness (``test_torch_mimi``).
Tolerances: the mel 1e-4, embeddings and prompts 1e-5 of their largest
value, waveforms 1e-4 (the talker's f32 sums in another order reach the
codec through the codes only, so equal codes leave the codec's own).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import dsp as jdsp
from tpu_audio.core import kv_cache as jkv
from tpu_audio.core import loading as jloading
from tpu_audio.core import nn as jnn
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.core.generation import AudioGenerationError as JError
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio.models.tts import qwen3_speaker as JS
from tpu_audio.models.tts import qwen3_tts as JQ
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationError, AudioGenerationKind
from tpu_audio_torch.models.tts import load_model as tload_model
from tpu_audio_torch.models.tts import qwen3_speaker as TS
from tpu_audio_torch.models.tts import qwen3_tts as TQ
from tpu_audio_torch.ops import qmm

from fixtures import make_qwen3_tts_fixture
from test_torch_mimi import _encode_witness, assert_codes_or_witness
from test_torch_qwen3_tts import _write

torch.set_num_threads(1)

RTOL = 1e-5
MEL_ATOL = 1e-4
WAV_ATOL = 1e-4
TEXT = "hello world w3 w9"
REF_TEXT = "hello w5 w7"
GREEDY = dict(max_tokens=6, temperature=0.0, repetition_penalty=1.05)
REF_SAMPLES = 2048  # 64 frames of the fixture's encoder (16 x 2 samples a frame)


def _clip(seed, n=REF_SAMPLES):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _write_clone(src, dst, seed, bits=None):
    """``_write``'s copy of ``src`` (talker weights seeded, MLX-packed at
    ``bits`` when given), with the speaker encoder's and the speech
    tokenizer encoder's weights drawn from ``seed`` too: N(0,
    1/sqrt(fan-in)) weights, N(0, 0.05) biases, unit norms kept, codebooks
    of ``cluster_usage`` in [0.5, 4) with N(0, 1) rows times their usage."""
    from safetensors.numpy import save_file

    _write(src, dst, seed, bits=bits)
    rng = np.random.default_rng(seed + 100)

    def draw(name, v, out):
        if name.endswith("cluster_usage"):
            return rng.uniform(0.5, 4.0, v.shape)
        if name.endswith("embed_sum"):
            return rng.standard_normal(v.shape) * out[name[:-9] + "cluster_usage"][:, None]
        if "norm" in name or name.endswith(".scale"):
            return v
        if name.endswith(".bias"):
            return 0.05 * rng.standard_normal(v.shape)
        return rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))

    talker = jloading.load_safetensors(dst)
    for name, v in sorted(jloading.load_safetensors(src).items()):
        if "speaker_encoder" in name.split("."):
            talker[name] = np.asarray(draw(name, v, talker), np.float32)
    save_file(talker, str(dst / "model.safetensors"))
    st = jloading.load_safetensors(dst / "speech_tokenizer")
    for name, v in sorted(st.items()):  # a codebook's cluster_usage before its embed_sum
        if name.startswith("encoder."):
            st[name] = np.asarray(draw(name, v, st), np.float32)
    save_file(st, str(dst / "speech_tokenizer" / "model.safetensors"))
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("qwen3clone")
    fix = make_qwen3_tts_fixture(root / "fixture", with_icl=True)
    return {"fixture": fix, "rand": _write_clone(fix, root / "rand", 11),
            "q8": _write_clone(fix, root / "q8", 11, bits=8),
            "custom": make_qwen3_tts_fixture(root / "custom")}


@pytest.fixture(scope="module")
def models(dirs):
    """``models(which, dtype)``: the JAX and the port model, built once."""
    built = {}

    def get(which, dtype="float32", jax=True):
        if (which, dtype) not in built:
            built[which, dtype] = tload_model(str(dirs[which]), dtype=getattr(torch, dtype),
                                              device="cpu")
        if not jax:
            return built[which, dtype]
        if (which, dtype, "jax") not in built:
            built[which, dtype, "jax"] = jload_model(str(dirs[which]),
                                                     dtype=getattr(jnp, dtype))
        return built[which, dtype, "jax"], built[which, dtype]

    return get


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rtol * np.abs(want).max())


def _run(model, gp, ref=None, ref_text=REF_TEXT, text=TEXT, stream=False):
    """``_run_iter``'s codes ``[frames, G]`` and its done payload."""
    kw = {} if ref is None else {"ref_audio": ref, "ref_text": ref_text}
    if isinstance(model, TQ.Qwen3TTS):
        *_, (_, payload) = model._run_iter(text, None, None, None, gp, stream=stream, **kw)
    else:
        payload = model._run(text, None, None, None, gp, **kw)
    return (np.stack(payload[0]) if payload[0] else np.zeros((0,))), payload


def _forced_logits_tq(tm, ref, codes, text=TEXT):
    """The port's raw logits at each (frame, group) of ``generate``'s own
    frame steps, each code forced to ``codes``."""
    it, seen = iter(codes.reshape(-1).tolist()), []
    sample = TQ._sample

    def read(gen, logits, *a, **k):
        seen.append(logits.float().numpy()[0])
        return torch.tensor([next(it)])

    TQ._sample = read
    try:
        _run(tm, TParams(max_tokens=len(codes), temperature=0.0), ref, text=text)
    finally:
        TQ._sample = sample
    return seen


_JITTED = {}  # id(JAX model) -> its jitted talker and code-predictor passes


def _forced_logits_jq(jm, ref, codes, text=TEXT):
    """The JAX package's raw logits at each (frame, group), its talker and
    code-predictor passes run step by step with each code forced to
    ``codes`` (its generate loop, each pass jitted alone, once a model)."""
    import functools

    import jax

    tcfg, ccfg = jm.config.talker, jm.config.code_predictor
    G = tcfg.num_code_groups
    if id(jm) not in _JITTED:
        _JITTED[id(jm)] = (jax.jit(functools.partial(JQ.talker_forward, cfg=tcfg)),
                           jax.jit(functools.partial(JQ.code_predictor_forward, cfg=ccfg),
                                   static_argnums=(3,)))
    talker, cp_pass = _JITTED[id(jm)]
    embeds, _, tts_pad, _ = jm.prepare_icl_generation_inputs(text, ref, REF_TEXT, "auto")
    embeds, tts_pad = embeds.astype(jm.dtype), tts_pad.astype(jm.dtype)
    cache = jkv.init_cache(tcfg.num_hidden_layers, 1, tcfg.num_key_value_heads, tcfg.head_dim,
                           embeds.shape[1] + len(codes) + 2, jm.dtype)
    _, _, cache = talker(jm.params, embeds[:, :-1], cache)
    x, cp, seen = embeds[:, -1:], jm.params["code_predictor"], []
    for frame in codes:
        logits, hidden, cache = talker(jm.params, x, cache)
        seen.append(np.asarray(logits[0, -1], np.float32))
        cp_cache = jkv.init_cache(ccfg.num_hidden_layers, 1, ccfg.num_key_value_heads,
                                  ccfg.head_dim, G + 2, x.dtype)
        e = jnn.embedding(jm.params["model"]["codec_embedding"], jnp.asarray([[frame[0]]]))
        code_input, embed_sum = jnp.concatenate([hidden[:, -1:], e], axis=1), e
        for g in range(G - 1):
            lg, cp_cache = cp_pass(cp, code_input, cp_cache, g)
            seen.append(np.asarray(lg[0, -1], np.float32))
            code_input = jnn.embedding(cp["model"]["codec_embedding"][str(g)],
                                       jnp.asarray([[frame[g + 1]]]))
            embed_sum = embed_sum + code_input
        x = tts_pad + embed_sum
    return seen


def assert_greedy_or_witness(jm, tm, got, want, ref, text=TEXT):
    """Greedy codes ``got`` (the port's) equal ``want`` (the JAX package's),
    or part at a near tie: at the first parted (frame, group), with the
    codes before it forced to ``want`` in both packages, both codes are the
    JAX package's two best logits (the talker's after its suppression and
    repetition penalty), which lie within the two packages' largest
    difference of those logits. Returns whether they parted."""
    if np.array_equal(got, want):
        return False
    assert got.shape == want.shape
    G = want.shape[1]
    f, g = np.argwhere(got != want)[0]
    lj = _forced_logits_jq(jm, ref, want[:f + 1], text)[f * G + g]
    lt = _forced_logits_tq(tm, ref, want[:f + 1], text)[f * G + g]
    if g == 0:  # the talker's: the band suppressed, then the repetition penalty
        V = tm.config.talker.vocab_size
        keep = np.ones(V, bool)
        keep[V - TQ.SUPPRESSED_BAND:] = False
        keep[tm.config.talker.codec_eos_token_id] = True
        seen = np.isin(np.arange(V), want[:f, 0])
        lj, lt = ([np.where(keep, np.where(seen, np.where(x > 0, x / 1.05, x * 1.05), x), -1e9)
                   for x in (lj, lt)])
    top = np.argsort(-lj)[:2]
    assert {int(got[f, g]), int(want[f, g])} <= set(top.tolist()), (f, g, top)
    assert lj[top[0]] - lj[top[1]] <= np.abs(lj - lt).max(), (f, g, lj[top], np.abs(lj - lt).max())
    return True


# -- loading ---------------------------------------------------------------------------------


def test_from_pretrained_loads_both_encoders_on_a_base_checkpoint(models):
    jm, tm = models("fixture")
    assert isinstance(tm.speaker_encoder, TS.Qwen3SpeakerEncoder)
    assert tm.codec_encoder is not None and tm.codec_encoder.valid_num_quantizers == 4
    assert vars(tm.speaker_encoder.config) == vars(jm.speaker_encoder.config)
    assert tm.codec_encoder.config.downsample_stride == 2
    assert tm.codec_encoder.sample_rate == jm.codec_encoder.sample_rate == 256
    assert set(tm.speaker_encoder.params) == {"blocks", "mfa", "asp", "fc"}
    assert "speaker_encoder" not in tm.params


def test_custom_voice_checkpoint_has_no_encoders(models):
    tm = models("custom", jax=False)
    assert tm.speaker_encoder is None and tm.codec_encoder is None


# -- the encoders and the prompt -------------------------------------------------------------------


@pytest.mark.parametrize("which", ["fixture", "rand"])
def test_codec_encoder_codes_match_jax(models, which):
    jm, tm = models(which)
    ref = _clip(3)
    got = tm.codec_encoder.encode(ref)
    assert got.shape == (1, 4, 64) and got.dtype == torch.int64
    assert_codes_or_witness(got.numpy(), np.asarray(jm.codec_encoder.encode(ref)),
                            lambda: _encode_witness(jm.codec_encoder, tm.codec_encoder, ref))


@pytest.mark.parametrize("which", ["fixture", "rand"])
@pytest.mark.parametrize("n", [REF_SAMPLES, 24000])
def test_speaker_mel_and_embedding_match_jax(models, which, n):
    jm, tm = models(which)
    ref = _clip(4, n)
    cfg = tm.speaker_encoder.config
    mel = TS.speaker_mel(ref, cfg)
    assert mel.shape == (1, n // TS.HOP, cfg.mel_dim)
    np.testing.assert_allclose(mel.numpy(), np.asarray(JS.speaker_mel(ref, cfg)), atol=MEL_ATOL)
    _close(tm.extract_speaker_embedding(ref), jm.extract_speaker_embedding(ref))


@pytest.mark.parametrize("language", ["auto", "english"])
@pytest.mark.parametrize("which", ["fixture", "rand"])
def test_prepare_icl_generation_inputs_match_jax(models, which, language):
    jm, tm = models(which)
    ref = _clip(5)
    got = tm.prepare_icl_generation_inputs(TEXT, ref, REF_TEXT, language)
    want = jm.prepare_icl_generation_inputs(TEXT, ref, REF_TEXT, language)
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))
    plain = tm.prepare_generation_inputs(TEXT, language)[0].shape[1]
    n = len(tm.tokenizer.encode(f"<|im_start|>assistant\n{REF_TEXT}<|im_end|>\n").ids)
    tn = len(tm.tokenizer.encode(f"<|im_start|>assistant\n{TEXT}<|im_end|>\n"
                                 "<|im_start|>assistant\n").ids)
    # the role header, the prefix and speaker row less one, the two texts cut
    # of their ChatML ends, tts eos, codec bos and the 64 reference frames
    assert got[0].shape[1] == 3 + (plain - 3) + (n - 5) + (tn - 8) + 1 + 65
    assert got[1].shape == (1, 1, 16)


# -- generation -----------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cloned_greedy_codes_match_jax(models, dtype):
    jm, tm = models("rand", dtype)
    ref = _clip(6)
    got, payload = _run(tm, TParams(**GREEDY), ref)
    want, jpayload = _run(jm, JParams(**GREEDY), ref)
    assert got.shape == (GREEDY["max_tokens"], 4)
    parted = assert_greedy_or_witness(jm, tm, got, want, ref)
    assert not parted or dtype == "bfloat16"  # f32 codes are equal
    np.testing.assert_array_equal(payload[4], np.asarray(jpayload[4]))
    assert payload[3] == jpayload[3]
    plain, _ = _run(tm, TParams(**GREEDY))
    assert not np.array_equal(plain, got)  # the reference reaches the talker


def test_cloned_generate_waveform_matches_jax(models):
    """The reference codes decoded in front and cut off at
    ``int(T_ref / T_all * len)``: the same samples and length."""
    jm, tm = models("rand")
    ref = _clip(6)
    kw = dict(ref_audio=ref, ref_text=REF_TEXT)
    got = tm.generate(TEXT, generation_parameters=TParams(**GREEDY), **kw)
    want = np.asarray(jm.generate(TEXT, generation_parameters=JParams(**GREEDY), **kw))
    assert got.shape == want.shape == (GREEDY["max_tokens"] * 8,)
    np.testing.assert_allclose(got, want, atol=WAV_ATOL)
    full = tm.codec.decode(np.concatenate([tm._reference_audio_context(ref)[1],
                                           _run(tm, TParams(**GREEDY), ref)[0].T[None]],
                                          axis=2))[0].numpy()
    np.testing.assert_array_equal(got, full[64 * 8:])


@pytest.mark.parametrize("frames", [2, 4])
def test_cloned_generate_stream_matches_generate_codes(models, frames):
    """``generate_stream`` clones with the same codes as ``generate``; its
    chunks are the codec's stream over those codes alone (no reference
    prefix, as in the JAX package)."""
    _, tm = models("rand")
    ref = _clip(6)
    gp = TParams(**GREEDY, streaming_interval=frames / 12.5)
    codes, _ = _run(tm, gp, ref)
    seen = {}
    run_iter = tm._run_iter

    def spy(*a, **k):
        for item in run_iter(*a, **k):
            seen["item"] = item
            yield item

    tm._run_iter = spy
    try:
        events = list(tm.generate_stream(TEXT, ref_audio=ref, ref_text=REF_TEXT,
                                         generation_parameters=gp))
    finally:
        del tm._run_iter
    np.testing.assert_array_equal(np.stack(seen["item"][1][0]), codes)
    chunks = [e.audio for e in events if e.kind == AudioGenerationKind.AUDIO]
    assert len(chunks) == -(-GREEDY["max_tokens"] // frames)
    np.testing.assert_allclose(np.concatenate(chunks), tm.codec.decode(codes.T[None])[0].numpy(),
                               atol=1e-5)
    info = events[-1].info
    assert info.generation_token_count == GREEDY["max_tokens"]
    assert info.prompt_token_count == seen["item"][1][3]


def test_reference_context_cache_hits_the_same_clip_and_misses_another(models):
    _, tm = models("rand")
    a = _clip(7)
    b = a.copy()
    b[REF_SAMPLES // 2] += 1e-3  # same length, same ends
    ctx = tm._reference_audio_context(a)
    assert tm._reference_audio_context(a.copy()) is ctx
    other = tm._reference_audio_context(b)
    assert other is not ctx and tm._ref_context_cache[1] is other
    assert tm._reference_audio_context(a) is not ctx  # one entry: a was evicted


@pytest.mark.parametrize("which,kw,match", [
    ("rand", {"ref_audio": np.zeros(800, np.float32)}, "BOTH"),
    ("rand", {"ref_text": "hello"}, "BOTH"),
    ("custom", {"ref_audio": np.zeros(800, np.float32), "ref_text": "hello"},
     "requires a speech tokenizer encoder, but this checkpoint does not provide one")])
def test_cloning_refusals_match_jax(models, which, kw, match):
    jm, tm = models(which)
    with pytest.raises(AudioGenerationError, match=match):
        tm.generate("hi", generation_parameters=TParams(**GREEDY), **kw)
    with pytest.raises(JError, match=match):
        jm.generate("hi", generation_parameters=JParams(**GREEDY), **kw)


def test_cloned_prefill_past_64_rows_dequantizes(models, monkeypatch):
    """On the MLX 8-bit tree the cloned prompt's rows (over 64) take the
    dequantize route: no call of kernel 7 above 64 rows, none for the
    prefill's products; every frame's products as in the uncloned path."""
    tm = models("q8", jax=False)
    rows = []
    ref = qmm.quantized_matvec

    def spy(x, *a, **k):
        rows.append(x.shape[0])
        return ref(x, *a, **k)

    monkeypatch.setattr(qmm, "quantized_matvec", spy)
    clip = _clip(8)
    prompt = tm.prepare_icl_generation_inputs(TEXT, clip, REF_TEXT)[0].shape[1]
    assert prompt - 1 > qmm.MAX_ROWS
    rows.clear()
    codes, _ = _run(tm, TParams(**GREEDY), clip)
    L = tm.config.talker.num_hidden_layers
    Lc = tm.config.code_predictor.num_hidden_layers
    G = tm.config.talker.num_code_groups
    frame = [1] * (4 * L + 1) + [2] * (4 * Lc + 1) + [1] * (G - 2) * (4 * Lc + 1)
    n_prompt = len(rows) - len(frame) * len(codes)
    # the text projection: tts ids, the two texts, the role header (2 products each)
    assert n_prompt == 6 and rows[:2] == rows[4:6] == [3, 3] and rows[2] == rows[3]
    assert max(rows) <= qmm.MAX_ROWS and prompt - 1 not in rows
    assert rows[n_prompt:] == frame * len(codes)


# -- parameters -----------------------------------------------------------------------------------


def test_from_jax_params_carries_the_encoder_trees(models):
    """The JAX model's speaker encoder and codec encoder trees, carried
    across with ``convert.from_jax_params``: the same embedding and codes."""
    from tpu_audio_torch.codecs.qwen3_codec import Qwen3CodecEncoder
    from tpu_audio_torch.convert import from_jax_params

    from test_torch_ops import jax_tree_to_numpy

    jm, tm = models("rand")
    ref = _clip(12)
    spk = TS.Qwen3SpeakerEncoder(tm.speaker_encoder.config,
                                 from_jax_params(jax_tree_to_numpy(jm.speaker_encoder.params)))
    np.testing.assert_array_equal(spk(ref).numpy(), tm.extract_speaker_embedding(ref).numpy())
    enc = Qwen3CodecEncoder(tm.codec_encoder.config,
                            from_jax_params(jax_tree_to_numpy(jm.codec_encoder.params)), 4)
    np.testing.assert_array_equal(enc.encode(ref).numpy(), tm.codec_encoder.encode(ref).numpy())


def test_init_random_params_match_the_loaded_trees(models):
    from tpu_audio_torch.codecs import qwen3_codec as QC

    _, tm = models("fixture")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(TS.init_random_params(tm.speaker_encoder.config)) == shapes(
        tm.speaker_encoder.params)
    rand = QC.init_random_encoder_params(tm.codec_encoder.config)
    assert shapes(rand) == shapes(tm.codec_encoder.params)
    usage = rand["quantizer"]["rvq_first"]["vq"]["layers"]["0"]["codebook"]["cluster_usage"]
    assert float(usage.std()) > 0.1
    mel_frames = jdsp.log_mel_spectrogram(_clip(13), n_mels=16, sample_rate=24000,
                                          n_fft=1024, hop_length=256).shape[1]
    assert mel_frames == REF_SAMPLES // TS.HOP
