"""Cohere Transcribe and the SentencePiece tokenizer on the PyTorch port
against the JAX package, on the CPU at small sizes: ``core.spm`` on
unigram and BPE models (byte fallback, random text), the configs, the
frontend, ``sanitize`` on NeMo keys, fused ``qkv_proj`` and MLX layouts,
the encoder and its frame bucket, the prefill's logits, greedy tokens,
text and segments through ``generate`` (fixed chunks, VAD chunks and the
VAD's failure), ``generate_stream``, ``streaming_decode_token_ids`` with a
forced prefix, ``load_model``, ``convert.from_jax_params``, the CLI and
the server.

The fixture checkpoint (``make_cohere_fixture``) has periodic weights; the
parity tests run on copies with seeded normal weights (``_write``), one at
the fixture's widths and one wider, which is also MLX-packed at 4 bits in
groups of 16. In f32 tokens are held equal; in bf16 and on the 4-bit tree
they are equal or part where the JAX package's two best logits lie within
the two packages' difference of those logits, with the earlier tokens
forced to the JAX package's in both.
"""

import io
import json
import shutil
import threading
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_audio.cli import serve as jserve
from tpu_audio.core import spm as jspm
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.stt import cohere as JC
from tpu_audio.models.stt import load_model as jload_model
from tpu_audio.models.vad.segmenter import SpeechSegmentConfig as JSeg
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core import spm as tspm
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.stt import cohere as TC
from tpu_audio_torch.models.stt import load_model as tload_model
from tpu_audio_torch.models.vad.segmenter import SpeechSegmentConfig as TSeg

from fixtures import make_cohere_fixture, serialize_sp_model
from test_torch_ops import jax_tree_to_numpy
from test_torch_tts_q4 import _quantize_checkpoint

torch.set_num_threads(1)

WIDE = dict(d_model=32, hidden_size=32, inner_size=64)


def _write(dst, seed, wide=False):
    """Seeded normal weights, under the NeMo keys of the fixture, for the
    checkpoint in ``dst`` (at ``WIDE`` with ``wide``): linears and
    convolutions N(0, 1/fan-in) (the head's N(0, 9/fan-in), so that the
    tokens follow the audio and the earlier tokens), biases N(0, 0.02),
    the token embedding N(0, 1), LayerNorm and BatchNorm weights 1 + N(0,
    0.1) and biases N(0, 0.02), the BatchNorm statistics N(0, 0.1) and 1 +
    |N(0, 0.1)|, the relative position biases N(0, 0.1)."""
    from safetensors.numpy import save_file

    conf = json.loads((dst / "config.json").read_text())
    e, dc = conf["encoder"], conf["transf_decoder"]["config_dict"]
    if wide:
        e["d_model"] = WIDE["d_model"]
        dc.update(hidden_size=WIDE["hidden_size"], inner_size=WIDE["inner_size"])
    (dst / "config.json").write_text(json.dumps(conf))
    D, CH, MELS, K = e["d_model"], e["subsampling_conv_channels"], e["feat_in"], \
        e["conv_kernel_size"]
    H, INNER, V = dc["hidden_size"], dc["inner_size"], conf["head"]["num_classes"]
    FF, NH = D * e["ff_expansion_factor"], e["n_heads"]
    rng = np.random.default_rng(seed)
    w = {}

    def rand(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def lin(name, o, i, bias=True, gain=1.0):
        w[f"{name}.weight"] = rand((o, i), gain * i ** -0.5)
        if bias:
            w[f"{name}.bias"] = rand((o,), 0.02)

    def conv(name, shape):
        w[f"{name}.weight"] = rand(shape, float(np.prod(shape[1:])) ** -0.5)
        w[f"{name}.bias"] = rand((shape[0],), 0.02)

    def norm(name, n):
        w[f"{name}.weight"] = 1.0 + rand((n,), 0.1)
        w[f"{name}.bias"] = rand((n,), 0.02)

    pre = "encoder.pre_encode"
    for i, shape in ((0, (CH, 1, 3, 3)), (2, (CH, 1, 3, 3)), (3, (CH, CH, 1, 1)),
                     (5, (CH, 1, 3, 3)), (6, (CH, CH, 1, 1))):
        conv(f"{pre}.conv.{i}", shape)
    lin(f"{pre}.out", D, CH * (MELS // 8))
    for layer in range(e["n_layers"]):
        b = f"encoder.layers.{layer}"
        for nm in ("norm_feed_forward1", "norm_self_att", "norm_conv", "norm_feed_forward2",
                   "norm_out"):
            norm(f"{b}.{nm}", D)
        for ff in ("feed_forward1", "feed_forward2"):
            lin(f"{b}.{ff}.linear1", FF, D)
            lin(f"{b}.{ff}.linear2", D, FF)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            lin(f"{b}.self_attn.{proj}", D, D)
        lin(f"{b}.self_attn.linear_pos", D, D, bias=False)
        w[f"{b}.self_attn.pos_bias_u"] = rand((NH, D // NH), 0.1)
        w[f"{b}.self_attn.pos_bias_v"] = rand((NH, D // NH), 0.1)
        conv(f"{b}.conv.pointwise_conv1", (2 * D, D, 1))
        conv(f"{b}.conv.depthwise_conv", (D, 1, K))
        norm(f"{b}.conv.batch_norm", D)
        w[f"{b}.conv.batch_norm.running_mean"] = rand((D,), 0.1)
        w[f"{b}.conv.batch_norm.running_var"] = 1.0 + np.abs(rand((D,), 0.1))
        w[f"{b}.conv.batch_norm.num_batches_tracked"] = np.zeros((), np.int64)
        conv(f"{b}.conv.pointwise_conv2", (D, D, 1))
    w["transf_decoder._embedding.token_embedding.weight"] = rand((V, H), 1.0)
    norm("transf_decoder._embedding.layer_norm", H)
    for layer in range(dc["num_layers"]):
        b = f"transf_decoder._decoder.layers.{layer}"
        for nm in ("layer_norm_1", "layer_norm_2", "layer_norm_3"):
            norm(f"{b}.{nm}", H)
        for sub in ("first_sub_layer", "second_sub_layer"):
            for proj in ("query_net", "key_net", "value_net", "out_projection"):
                lin(f"{b}.{sub}.{proj}", H, H)
        lin(f"{b}.third_sub_layer.dense_in", INNER, H)
        lin(f"{b}.third_sub_layer.dense_out", H, INNER)
    norm("transf_decoder._decoder.final_layer_norm", H)
    lin("log_softmax.mlp.layer0", V, H, gain=3.0)
    save_file(w, str(dst / "model.safetensors"))
    return dst


def _is_linear(k, v):
    return v.ndim == 2 and k.endswith(".weight") and "norm" not in k


def _raise_eos(dst, by=2.0):
    """The head's bias for ``<|endoftext|>`` (50) raised by ``by`` in the
    checkpoint in ``dst``: a chunk then ends after 3-7 tokens."""
    from safetensors.numpy import load_file, save_file

    w = dict(load_file(str(dst / "model.safetensors")))
    w["log_softmax.mlp.layer0.bias"][50] += by
    save_file(w, str(dst / "model.safetensors"))
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture as written; a seeded-normal copy, and that copy with eos
    made likely; a wider seeded-normal copy and that copy MLX-packed at 4
    bits in groups of 16."""
    root = tmp_path_factory.mktemp("cohere")
    src = make_cohere_fixture(root / "fixture")
    rand = _write(shutil.copytree(src, root / "rand"), seed=7)
    eos = _raise_eos(shutil.copytree(rand, root / "eos"))
    wide = _write(shutil.copytree(src, root / "wide"), seed=6, wide=True)
    q4 = _quantize_checkpoint(wide, root / "q4", 4, 16, _is_linear)
    return {"fixture": src, "rand": rand, "eos": eos, "wide": wide, "q4": q4}


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


# -- SentencePiece -------------------------------------------------------------------

UNIGRAM = [("<unk>", 0.0, 2), ("▁hello", -1.0, 1), ("▁world", -1.5, 1), ("▁", -10.0, 1),
           ("h", -20.0, 1), ("e", -20.0, 1), ("l", -20.0, 1), ("o", -20.0, 1),
           ("w", -20.0, 1), ("r", -20.0, 1), ("d", -20.0, 1), ("<s>", 0.0, 3),
           ("▁he", -4.0, 1), ("ll", -6.0, 1), ("<user>", 0.0, 4)] + \
    [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
BPE = [("<unk>", 0.0, 2), ("▁ab", -1.0, 1), ("▁a", -3.0, 1), ("b", -3.0, 1), ("▁", -5.0, 1),
       ("a", -5.0, 1), ("<sep>", 0.0, 4), ("c", -6.0, 1), ("ab", -2.0, 1), ("▁c", -2.5, 1)] + \
    [(f"<0x{b:02X}>", 0.0, 6) for b in range(200)]


@pytest.fixture(scope="module")
def sps(tmp_path_factory):
    """Both packages' tokenizers of the unigram and BPE models."""
    root = tmp_path_factory.mktemp("sp")
    out = {}
    for name, pieces, mt in (("unigram", UNIGRAM, 1), ("bpe", BPE, 2)):
        p = root / f"{name}.model"
        p.write_bytes(serialize_sp_model(pieces, model_type=mt))
        out[name] = (tspm.SentencePieceTokenizer.from_model_file(p),
                     jspm.SentencePieceTokenizer.from_model_file(p))
    return out


@pytest.mark.parametrize("name", ["unigram", "bpe"])
@pytest.mark.parametrize("text", ["hello world", "é", "hello  wörld ✓", "", "ab c<sep>ab",
                                  "<user>hello", "dlrow olleh"])
def test_spm_encode_decode_match_jax(sps, name, text):
    """Encode (byte fallback included) and decode equal the JAX package's;
    the parsed model too."""
    t, j = sps[name]
    assert (t.unk_id, t.model_type, t.vocab_size) == (j.unk_id, j.model_type, j.vocab_size)
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(ids + [10 ** 6, -1, 11]) == j.decode(ids + [10 ** 6, -1, 11])


@settings(max_examples=60, deadline=None)
@given(text=st.lists(st.sampled_from(list("abcdehlorw ✓é<>") + ["<user>", "<sep>"]),
                     max_size=16).map("".join),
       name=st.sampled_from(["unigram", "bpe"]))
def test_spm_random_text_matches_jax(sps, text, name):
    t, j = sps[name]
    ids = t.encode(text)
    assert ids == j.encode(text) and t.decode(ids) == j.decode(ids)


def test_spm_tokenizer_json_matches_jax(tmp_path):
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps({"model": {"type": "Unigram", "unk_id": 0, "vocab": [
        ["<unk>", 0.0], ["▁hi", -1.0], ["▁", -3.0], ["h", -5.0], ["i", -5.0]]}}))
    t, j = (m.SentencePieceTokenizer.from_tokenizer_json(p) for m in (tspm, jspm))
    assert t.encode("hi hih") == j.encode("hi hih") and t.id_for("▁hi") == j.id_for("▁hi") == 1


# -- small pieces ----------------------------------------------------------------------


def test_configs_match_jax(dirs):
    conf = json.loads((dirs["fixture"] / "config.json").read_text())
    for d in (conf, {}, {"vocab_size": 7, "transf_decoder": {"hidden_size": 8},
                         "quantization_config": {"bits": 4}}):
        t, j = TC.CohereConfig.from_dict(d), JC.CohereConfig.from_dict(d)
        assert (t.encoder.__dict__, t.decoder.__dict__, t.vocab_size, t.sample_rate,
                t.max_audio_clip_s, t.quantization) == \
            (j.encoder.__dict__, j.decoder.__dict__, j.vocab_size, j.sample_rate,
             j.max_audio_clip_s, j.quantization)


def _features_f64(x, n_mels):
    """``cohere_features``' function in float64 (numpy's FFT)."""
    from tpu_audio_torch.core import dsp

    x = x.astype(np.float64)
    x = np.concatenate([x[:1], x[1:] - 0.97 * x[:-1]])
    xp = np.pad(x, (256, 256))
    frames = np.stack([xp[i * 160:i * 160 + 512] for i in range(1 + (len(xp) - 512) // 160)])
    power = np.abs(np.fft.rfft(frames * TC._frontend_window(), axis=-1)) ** 2
    mel = np.log(power @ dsp.mel_filters(16000, 512, n_mels, norm="slaney", mel_scale="slaney")
                 + 2.0 ** -24)
    mean = mel.mean(0, keepdims=True)
    return (mel - mean) / (np.sqrt(((mel - mean) ** 2).mean(0, keepdims=True)) + 1e-5)


@pytest.mark.parametrize("n", [1, 399, 16000, 48017])
@pytest.mark.parametrize("n_mels", [128, 16])
def test_features_match_jax(n, n_mels):
    """Pre-emphasis, the 512-point zero-padded STFT, Slaney mel, log and
    per-bin normalisation: within 2e-4 of the JAX package's and 1e-4 of
    the same function in float64. The JAX package reads up to 1.1e-4 from
    float64 itself: the f32 log of the 128-mel bank's near-empty low bins
    on noise, then the per-bin normalisation, leave ~1e-4 in either."""
    x = _audio(n, n)
    got = TC.cohere_features(torch.from_numpy(x), 16000, n_mels)
    want = np.asarray(JC._cohere_features(jnp.asarray(x), sr=16000, n_mels=n_mels))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), _features_f64(x, n_mels), atol=1e-4, rtol=0)


def test_sanitize_matches_jax(dirs):
    """NeMo keys (the fixture), a pre-fused ``qkv_proj`` (dense and packed
    triples) and MLX layouts of the subsampling and conformer convolutions:
    the same keys and values."""
    from safetensors.numpy import load_file

    w = dict(load_file(str(dirs["fixture"] / "model.safetensors")))
    rng = np.random.default_rng(0)
    w.update({
        "decoder.core.layers.0.first_sub_layer.qkv_proj.weight": rng.standard_normal((12, 4)),
        "decoder.core.layers.0.first_sub_layer.qkv_proj.scales": rng.standard_normal((12, 2)),
        "decoder.core.layers.0.first_sub_layer.qkv_proj.biases": rng.standard_normal((12, 2)),
        "encoder.pre_encode.conv.5.weight": rng.standard_normal((4, 3, 3, 1)),   # MLX O,H,W,I
        "encoder.pre_encode.conv.6.weight": rng.standard_normal((4, 1, 1, 4)),
        "encoder.layers.0.conv.depthwise_conv.weight": rng.standard_normal((16, 5, 1)),
        "encoder.layers.0.conv.pointwise_conv2.weight": rng.standard_normal((16, 1, 16)),
        "preprocessor.featurizer.window": np.ones(4),
        "transf_decoder._embedding.position_embedding.pos_enc": np.ones((4, 4)),
        "encoder_decoder_proj.weight": rng.standard_normal((16, 16)),
    })
    w = {k: np.asarray(v, np.float32) if v.dtype != np.int64 else v for k, v in w.items()}
    want = JC.sanitize(dict(w))
    got = TC.sanitize({k: torch.from_numpy(v.copy()) for k, v in w.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and np.array_equal(got[k].numpy(), want[k]), k
    assert "bridge_proj.weight" in got and "lm_head.weight" in got
    assert got["decoder.core.layers.0.first_sub_layer.k_proj.scales"].shape == (4, 2)


# -- encoder and decoder -----------------------------------------------------------------


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_encoder_matches_jax_and_its_bucket(dirs, ckpt):
    """The encoder on 37 valid frames in buckets of 40 and 80 frames: each
    within 1e-5 of the JAX package's (relative to its max), the valid rows
    the same in both buckets; ``_encode_audio`` within 1e-5 too."""
    jm, tm = _models(dirs[ckpt])
    mels = tm.config.encoder.feat_in
    feats = np.random.default_rng(2).standard_normal((mels, 37)).astype(np.float32) * 0.3
    outs = []
    for bucket in (40, 80):
        x = np.zeros((1, mels, bucket), np.float32)
        x[0, :, :37] = feats
        got, gl = TC.encoder_forward(tm.params, torch.from_numpy(x), torch.tensor([37]),
                                     tm.config.encoder)
        want, wl = jm._encode(jm.params, jnp.asarray(x), jnp.asarray([37], jnp.int32))
        n = int(wl[0])
        assert int(gl[0]) == n
        assert _rel(got[0, :n], np.asarray(want)[0, :n]) < 1e-5
        outs.append(got[0, :n])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-5 * float(
        outs[1].abs().max()), rtol=0)
    x = _audio(4, 9000)
    (got, gl), (want, wl) = tm._encode_audio(x), jm._encode_audio(x)
    assert gl == wl and got.shape == want.shape and _rel(got, want) < 1e-5


def _prefill_both(jm, tm, x, capacity):
    jenc, jlen = jm._encode_audio(x)
    tenc, tlen = tm._encode_audio(x)
    prompt = tm.tokenizer.build_prompt()
    from tpu_audio.core import kv_cache as jkv

    dc = jm.config.decoder
    cache = jkv.init_cache(dc.num_layers, 1, dc.num_attention_heads,
                           dc.hidden_size // dc.num_attention_heads, capacity, jm.dtype)
    jmask = jnp.arange(jenc.shape[1])[None, None, None, :] < jlen
    jstate = jm._prefill(jm.params, jnp.asarray([prompt], jnp.int32), cache,
                         jnp.asarray(jenc, jm.dtype), jmask)
    return (jstate + (jmask,)), tm._prefill(prompt, tenc, tlen, capacity), prompt


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_prefill_logits_match_jax(dirs, ckpt):
    """The prompt's last logits after the cross K/V and the prefill, within
    1e-5 of the JAX package's (relative to their max)."""
    jm, tm = _models(dirs[ckpt])
    (jl, *_), (tl, *_), _ = _prefill_both(jm, tm, _audio(5, 12000), 24)
    assert tl.shape == jl.shape and _rel(tl, np.asarray(jl)) < 1e-5


def _step_logits(jm, tm, x, row):
    """Both packages' logits ``[len(row) + 1, V]`` f32: the prefill's last,
    then after feeding each token of ``row``."""
    (jl, jcache, jk, jv, jmask), (tl, tcache, tk, tv, tmask), prompt = _prefill_both(
        jm, tm, x, len(tm.tokenizer.build_prompt()) + len(row) + 2)
    jout, tout = [np.asarray(jl[0], np.float32)], [tl[0].float().numpy()]
    with torch.no_grad():
        for t in row:
            jlog, jcache = JC._decoder_pass(jm.params, jnp.asarray([[t]], jnp.int32),
                                            jnp.full((1, 1), jcache.offset), jcache, jk, jv,
                                            jmask, jm.config)
            tlog, tcache = TC._decoder_pass(tm.params, torch.tensor([[t]]), tm._table, tcache,
                                            tk, tv, tmask, tm.config)
            jout.append(np.asarray(jlog[0, -1], np.float32))
            tout.append(tlog[0, -1].float().numpy())
    return np.stack(jout), np.stack(tout)


def assert_greedy_or_witness(jm, tm, x, got, want, forced=()):
    """``got`` equals ``want``, or at the first parted step the JAX
    package's two best logits are the two tokens and lie within the two
    packages' largest difference of the logits at that step."""
    if got == want:
        return
    s = next(i for i in range(len(forced), min(len(got), len(want)) + 1)
             if i >= min(len(got), len(want)) or got[i] != want[i])
    jl, tl = _step_logits(jm, tm, x, want[:s])
    a, b = want[s], got[s]
    assert {a, b} == set(np.argsort(jl[s])[-2:].tolist()), (s, a, b)
    assert abs(jl[s, a] - jl[s, b]) <= np.abs(jl[s] - tl[s]).max(), s


ROUTES = {"dense": ("rand", "f32"), "q4": ("q4", "f32"), "bf16": ("rand", "bf16")}


@pytest.mark.parametrize("route,forced", [("dense", 0), ("dense", 3), ("q4", 0), ("q4", 3),
                                          ("bf16", 0)])
def test_greedy_tokens_match_jax(dirs, route, forced):
    """``streaming_decode_token_ids`` (with the first tokens of a free pass
    forced) and, free, ``generate``'s text; f32 trees equal, the others
    equal or parted at a witnessed near tie."""
    ckpt, dtype = ROUTES[route]
    jm, tm = _models(dirs[ckpt], dtype)
    x = _audio(11, 20000)
    from tpu_audio.models.stt.streaming import StreamingConfig as JSC
    from tpu_audio_torch.models.stt.streaming import StreamingConfig as TSC

    want, _ = jm.streaming_decode_token_ids(x, JSC(max_tokens_per_pass=8), [])
    pre = want[:forced]
    if forced:
        want, _ = jm.streaming_decode_token_ids(x, JSC(max_tokens_per_pass=8), pre)
    got, _ = tm.streaming_decode_token_ids(x, TSC(max_tokens_per_pass=8), pre)
    assert got[:forced] == want[:forced] == pre
    if dtype == "f32" and route != "q4":
        assert got == want
    else:
        assert_greedy_or_witness(jm, tm, x, got, want, pre)
    assert len(set(got)) > 1
    if not forced:
        jo, to = jm.generate(x, JParams(max_tokens=8)), tm.generate(x, TParams(max_tokens=8))
        assert to.prompt_token_count == jo.prompt_token_count == 9
        if got == want:
            assert (to.text, to.generation_token_count) == (jo.text, jo.generation_token_count)
            assert to.text


def test_forced_prefix_past_eos_and_budget(dirs, monkeypatch):
    """A forced prefix longer than the budget, and a forced eos inside the
    prefix (decoding goes on past it and eos is filtered): the same ids as
    the JAX package's."""
    jm, tm = _models(dirs["rand"])
    from tpu_audio.models.stt.streaming import StreamingConfig as JSC
    from tpu_audio_torch.models.stt.streaming import StreamingConfig as TSC

    x = _audio(12, 16000)
    eos = tm.tokenizer.eos_id
    for pre, n in (([3, 4, 5, 6, 7, 8, 9, 10], 6), ([eos, 9, eos], 6)):
        want, _ = jm.streaming_decode_token_ids(x, JSC(max_tokens_per_pass=n), pre)
        got, _ = tm.streaming_decode_token_ids(x, TSC(max_tokens_per_pass=n), pre)
        assert got == want and eos not in got


def test_eos_stops_the_loop_as_in_jax(dirs):
    """With eos made the argmax after a few tokens (the head's bias for eos
    raised), the loop stops where the JAX package's does, between host
    reads of the stop flag."""
    jm, tm = _models(dirs["rand"])
    from tpu_audio.models.stt.streaming import StreamingConfig as JSC
    from tpu_audio_torch.models.stt.streaming import StreamingConfig as TSC

    x = _audio(13, 16000)
    eos = tm.tokenizer.eos_id
    free, _ = tm.streaming_decode_token_ids(x, TSC(max_tokens_per_pass=24), [])
    bias = tm.params["lm_head"]["bias"].clone()
    tm2 = TC.CohereTranscribe(tm.config, {**tm.params, "lm_head": {
        "weight": tm.params["lm_head"]["weight"], "bias": bias}}, tm.tokenizer, torch.float32)
    jm2 = JC.CohereTranscribe(jm.config, dict(jm.params, lm_head=dict(jm.params["lm_head"])),
                              jm.tokenizer, jnp.float32)
    lengths = []
    for bump in (1.0, 2.0, 40.0):
        bias[eos] = tm.params["lm_head"]["bias"][eos] + bump
        jm2.params["lm_head"]["bias"] = jnp.asarray(bias.numpy())
        got, _ = tm2.streaming_decode_token_ids(x, TSC(max_tokens_per_pass=24), [])
        want, _ = jm2.streaming_decode_token_ids(x, JSC(max_tokens_per_pass=24), [])
        assert got == want
        lengths.append(len(got))
    assert len(free) == 24 and lengths[-1] == 0 and 0 < min(lengths[:2]) < 24


# -- generate ------------------------------------------------------------------------


def test_fixed_chunks_and_stream_match_jax(dirs):
    """1.5 s in 0.5 s chunks, each ending at eos, the token budget threaded
    through them (texts joined with newlines): the same text and segments
    as the JAX package's; ``generate_stream`` yields the same token and
    result events."""
    jm, tm = _models(dirs["eos"])
    x = _audio(3, 24000)
    jo = jm.generate(x, JParams(max_tokens=10, chunk_duration=0.5))
    to = tm.generate(x, TParams(max_tokens=10, chunk_duration=0.5))
    assert 1 < len(to.segments) == len(jo.segments) and to.text == jo.text
    assert [(s.text, s.start, s.end) for s in to.segments] == \
        [(s.text, s.start, s.end) for s in jo.segments]
    assert to.generation_token_count == jo.generation_token_count <= 10
    p = (JParams(max_tokens=10, chunk_duration=0.5), TParams(max_tokens=10, chunk_duration=0.5))
    jev, tev = list(jm.generate_stream(x, p[0])), list(tm.generate_stream(x, p[1]))
    assert [e["type"] for e in tev] == [e["type"] for e in jev]
    assert [e.get("text") for e in tev[:-1]] == [e.get("text") for e in jev[:-1]]
    assert tev[-1]["output"].text == jev[-1]["output"].text
    assert (tev[-1]["output"].prompt_token_count, tev[-1]["output"].generation_token_count) == \
        (jev[-1]["output"].prompt_token_count, jev[-1]["output"].generation_token_count)
    empty = np.zeros(0, np.float32)
    assert tm.generate(empty, TParams(max_tokens=3)).text == \
        jm.generate(empty, JParams(max_tokens=3)).text


class _FakeVAD:
    """``predict_proba`` stub: speech only inside [start, end) seconds."""

    def __init__(self, start_s, end_s, fail=False):
        self.span = (start_s, end_s)
        self.fail = fail

    def predict_proba(self, audio, sample_rate):
        if self.fail:
            raise RuntimeError("vad broke")
        chunk = 512 if sample_rate == 16000 else 256
        t = np.arange(len(audio) // chunk) * chunk / sample_rate
        return np.where((t >= self.span[0]) & (t < self.span[1]), 0.9, 0.0)


def test_vad_chunking_and_its_fallback_match_jax(dirs):
    """VAD segments (the silence trimmed) and a VAD that raises (fixed
    chunks instead): the same text and segments as the JAX package's."""
    jm, tm = _models(dirs["eos"])
    x = _audio(3, 3 * 16000)
    cases = ((_FakeVAD(1.0, 2.0), dict(speech_pad_ms=0, min_speech_ms=250)),
             (_FakeVAD(0.0, 1.0, fail=True), {}))
    for vad, kw in cases:
        jo = jm.generate(x, JParams(max_tokens=6), vad=(vad, JSeg(**kw)))
        to = tm.generate(x, TParams(max_tokens=6), vad=(vad, TSeg(**kw)))
        assert to.text == jo.text
        assert [(s.text, s.start, s.end) for s in to.segments] == \
            [(s.text, s.start, s.end) for s in jo.segments]
    seg = to.segments[0]
    assert seg.start == 0.0 and seg.end == 3.0
    to = tm.generate(x, TParams(max_tokens=6), vad=(cases[0][0], TSeg(**cases[0][1])))
    seg = to.segments[0]
    assert len(to.segments) == 1 and 0.7 <= seg.start <= 1.3 and 1.7 <= seg.end <= 2.3


# -- loading, conversion, random params ------------------------------------------------


def test_load_model_and_refusals(dirs, tmp_path):
    """``load_model`` by ``model_type`` and by the name fallback builds a
    CohereTranscribe with the NeMo keys renamed, the packed leaves of a
    ``quantization`` block and the tokenizer; ``quantize`` raises."""
    _, tm = _models(dirs["q4"])
    assert isinstance(tm, TC.CohereTranscribe) and tm.config.vocab_size == 64
    enc, dec = tm.params["encoder"], tm.params["decoder"]
    assert "conv0" in enc["subsampling"] and "q_proj" in enc["layers"]["0"]["self_attn"]
    assert isinstance(dec["core"]["layers"]["0"]["first_sub_layer"]["q_proj"]["weight"],
                      tquant.QuantizedTensor)
    assert isinstance(dec["embedding"]["token_embedding"]["weight"], tquant.QuantizedTensor)
    assert tm.tokenizer.build_prompt() == [40, 41, 42, 43, 43, 44, 46, 47, 49]
    assert tm.tokenizer.eos_id == 50
    named = shutil.copytree(dirs["rand"], tmp_path / "my-cohere-transcribe")
    cfg = json.loads((named / "config.json").read_text())
    del cfg["model_type"]
    (named / "config.json").write_text(json.dumps(cfg))
    assert isinstance(tload_model(str(named), dtype=torch.float32, device="cpu"),
                      TC.CohereTranscribe)
    with pytest.raises(ValueError, match="quantize"):
        tload_model(str(dirs["rand"]), device="cpu", quantize=4)


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_from_jax_params_carries_the_tree(dirs, ckpt):
    """The JAX package's sanitized tree through ``convert.from_jax_params``
    equals the port's own, leaf for leaf, and decodes the same ids."""
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
    m = TC.CohereTranscribe(tm.config, conv, tm.tokenizer, torch.float32)
    x = _audio(6, 8000)
    assert m.generate(x, TParams(max_tokens=4)).text == tm.generate(x, TParams(max_tokens=4)).text


def test_init_random_params_has_the_loaded_layout(dirs):
    _, tm = _models(dirs["rand"])

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    params = TC.init_random_params(tm.config, seed=1, dtype=torch.float32)
    assert shapes(params) == shapes(tm.params)
    m = TC.CohereTranscribe(tm.config, params, tm.tokenizer, torch.float32)
    out = m.generate(_audio(6, 16000), TParams(max_tokens=3))
    assert out.prompt_token_count == 9 and out.generation_token_count <= 3


# -- the CLI and the server ----------------------------------------------------------


def _cli_models(monkeypatch, models=None):
    """The CLIs' ``models.stt.load_model`` in f32: the port's loads the
    directory, the JAX package's returns the f32 model of it that
    ``models`` (this module's ``_models`` by default) caches, its compiled
    functions kept."""
    from tpu_audio.models import stt as jstt_models
    from tpu_audio_torch.models import stt as tstt_models

    models = models or _models
    load = tstt_models.load_model
    monkeypatch.setattr(tstt_models, "load_model",
                        lambda path, **kw: load(path, **{**kw, "dtype": torch.float32}))
    monkeypatch.setattr(jstt_models, "load_model", lambda path, **kw: models(path)[0])


def test_cli_json_matches_jax(dirs, tmp_path, capsys, monkeypatch):
    """``cli/stt.py --format json`` on the f32 model: the JAX CLI's JSON."""
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio_torch.cli import stt as tstt

    wav = tmp_path / "in.wav"
    save_wav(wav, _audio(30, 40000), 16000)
    _cli_models(monkeypatch)
    outs = []
    for main, extra in ((jstt.main, []), (tstt.main, ["--device", "cpu"])):
        path = tmp_path / "out.json"
        assert main([str(wav), "--model", str(dirs["eos"]), "--format", "json",
                     "--max-tokens", "24", "--chunk-duration", "1.5", "--output", str(path)]
                    + extra) == 0
        capsys.readouterr()
        outs.append(json.loads(path.read_text()))
    assert outs[0] == outs[1] and outs[1]["text"] and len(outs[1]["segments"]) == 2


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


def test_server_answers_cohere_as_jax(dirs):
    """``serve --task stt --slots 2`` builds no engine for Cohere (as in the
    JAX server) and answers ``/v1/audio/transcriptions`` and the stream
    route through the locked ``generate`` / ``generate_stream``: the JAX
    server's text and events."""
    jm, tm = _models(dirs["eos"])
    body = _wav(_audio(9, 24000) * 4)
    out = {}
    for name, mod, model in (("t", tserve, tm), ("j", jserve, jm)):
        srv = mod.build_server(model, "stt", "fixture", port=0, slots=2)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            if name == "t":
                assert srv.stt_worker is None
            out[name] = json.loads(_post(srv, "/v1/audio/transcriptions", body))
            lines = _post(srv, "/v1/audio/transcriptions/stream", body).splitlines()
            out[name + "s"] = [json.loads(x) for x in lines]
        finally:
            srv.shutdown()
            srv.server_close()
    assert out["t"]["text"] == out["j"]["text"] and out["t"]["text"]
    assert out["t"]["segments"] == out["j"]["segments"]
    assert [e["type"] for e in out["ts"]] == [e["type"] for e in out["js"]]
    assert out["ts"][-1]["text"] == out["js"][-1]["text"] == out["t"]["text"]
