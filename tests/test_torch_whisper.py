"""Whisper on the PyTorch port against the JAX package, on the CPU at
small sizes: the frontend, the encoder and one decoder step in f32 from the
same weights (``convert.from_jax_params``), checkpoint loading, greedy
tokens through ``generate`` for every ported decode route, and the CLI.

The JAX package's Pallas kernels run as its own tests run them: in
interpret mode, selected with ``TPU_AUDIO_PALLAS_KV=interpret`` and
``TPU_AUDIO_FUSED_DECODER=interpret``.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import dsp as jdsp
from tpu_audio.core import kv_cache as jkv
from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.stt import whisper as JW
from tpu_audio.ops import pallas_kv_attention as JK
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.stt import whisper as TW

from fixtures import (FakeWhisperTokenizer, make_whisper_fixture,
                      write_fixture_tokenizer)
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

SMALL = dict(num_mel_bins=80, d_model=64, encoder_layers=2,
             encoder_attention_heads=2, encoder_ffn_dim=128, decoder_layers=2,
             decoder_attention_heads=2, decoder_ffn_dim=128, vocab_size=128,
             max_source_positions=1500, max_target_positions=64)
# the end-to-end config of tests/test_fused_decoder.py:353
FUSED = dict(num_mel_bins=80, d_model=256, encoder_layers=1,
             encoder_attention_heads=4, encoder_ffn_dim=1024, decoder_layers=2,
             decoder_attention_heads=4, decoder_ffn_dim=1024, vocab_size=128,
             max_source_positions=1500, max_target_positions=64)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("seconds,n_mels", [(1.0, 80), (2.5, 128)])
def test_log_mel_spectrogram_matches_jax(seconds, n_mels):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)
    want = np.asarray(jdsp.log_mel_spectrogram(audio, n_mels=n_mels))
    got = tdsp.log_mel_spectrogram(audio, n_mels=n_mels).numpy()
    assert got.shape == want.shape
    # FFT rounding differs between pocketfft (XLA) and torch.stft; after
    # log10 and the /4 normalisation that stays below 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_log_mel_short_audio_is_empty_like_jax():
    audio = np.zeros(100, np.float32)
    assert tdsp.log_mel_spectrogram(audio, n_mels=80).shape == \
        tuple(jdsp.log_mel_spectrogram(audio, n_mels=80).shape)


def test_init_params_match_jax():
    cfg = JW.WhisperConfig(**SMALL)
    want = JW.init_params(cfg, seed=7, dtype=jnp.float32)
    got = TW.init_params(TW.WhisperConfig(**SMALL), seed=7, dtype=torch.float32)
    from tpu_audio_torch.core import loading

    flat_w = loading.flatten(jax_tree_to_numpy(want))
    flat_g = loading.flatten(got)
    assert flat_w.keys() == flat_g.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k].numpy(), flat_w[k], err_msg=k)


@pytest.fixture(scope="module")
def small():
    cfg = JW.WhisperConfig(**SMALL)
    params = JW.init_params(cfg, seed=1, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    mel = (rng.standard_normal((1, 3000, cfg.num_mel_bins)) * 0.5).astype(np.float32)
    tcfg = TW.WhisperConfig(**SMALL)
    tparams = from_jax_params(jax_tree_to_numpy(params))
    return cfg, params, mel, tcfg, tparams


def test_encoder_forward_matches_jax(small):
    cfg, params, mel, tcfg, tparams = small
    want = np.asarray(JW.encoder_forward(params, jnp.asarray(mel), cfg))
    got = TW.encoder_forward(tparams, torch.from_numpy(mel), tcfg).numpy()
    assert got.shape == (1, 1500, cfg.d_model)
    assert _rel(got, want) < 1e-4, _rel(got, want)  # f32, summation order


@pytest.mark.parametrize("cross_mode", ["dense", "int8"])
def test_decoder_step_logits_match_jax(small, cross_mode):
    cfg, params, mel, tcfg, tparams = small
    enc = JW.encoder_forward(params, jnp.asarray(mel), cfg)
    tenc = torch.from_numpy(np.asarray(enc))
    H = cfg.decoder_attention_heads
    hd = cfg.d_model // H
    L = cfg.decoder_layers
    jck, jcv = JW._cross_kv(params, enc, cfg)
    tck, tcv = TW._cross_kv(tparams, tenc, tcfg)
    assert _rel(tck.numpy(), np.asarray(jck)) < 1e-5
    if cross_mode == "int8":
        qt = [JK.quantize_kv_transposed(t, n_groups=1)
              for t in (jck[l, 0] for l in range(L))]
        qv = [JK.quantize_kv_transposed(t, n_groups=1)
              for t in (jcv[l, 0] for l in range(L))]
        jcross = tuple(jnp.stack([q[i] for q in qt]) for i in range(3)) + \
            tuple(jnp.stack([q[i] for q in qv]) for i in range(3))
        jkw = dict(cross_mode="pallas", pallas_interpret=True,
                   cross_valid=jnp.asarray([1500], jnp.int32))
        tcross = (tkv._quantize(tck[:, 0], 1) + tkv._quantize(tcv[:, 0], 1))
    else:
        jcross, jkw, tcross = (jck, jcv), {}, (tck, tcv)
    jcache = jkv.init_cache(L, 1, H, hd, 16, jnp.float32)
    tcache = tkv.init_cache(L, 1, H, hd, 16, torch.float32)
    for i, tok in enumerate([100, 5, 17]):
        jl, jcache = JW.decoder_step(params, jnp.asarray([[tok]], jnp.int32), i,
                                     jcache, *(jcross if cross_mode == "dense"
                                               else (jcross[:3], jcross[3:])),
                                     cfg, **jkw)
        tl, tcache = TW.decoder_step(tparams, torch.tensor([[tok]]), i, tcache,
                                     tcross, tcfg, cross_mode=cross_mode)
        assert tcache.offset == i + 1
        assert _rel(tl.numpy(), np.asarray(jl)) < 1e-4, (i, _rel(tl.numpy(), jl))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5)


def test_decoder_forward_matches_jax(small):
    cfg, params, mel, tcfg, tparams = small
    enc = JW.encoder_forward(params, jnp.asarray(mel), cfg)
    toks = np.asarray([[100, 5, 17, 9]], np.int32)
    want = np.asarray(JW.decoder_forward(params, jnp.asarray(toks), enc, cfg))
    got = TW.decoder_forward(tparams, torch.from_numpy(toks).long(),
                             torch.from_numpy(np.asarray(enc)), tcfg).numpy()
    assert _rel(got, want) < 1e-4


def test_from_pretrained_matches_jax(tmp_path):
    d = make_whisper_fixture(tmp_path / "w")
    write_fixture_tokenizer(d, 64)
    jm = JW.Whisper.from_pretrained(str(d), dtype=jnp.float32)
    tm = TW.Whisper.from_pretrained(str(d), dtype=torch.float32, device="cpu")
    from tpu_audio_torch.core import loading

    want = loading.flatten(jax_tree_to_numpy(jm.params))
    got = loading.flatten(tm.params)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tm.tokenizer.eot == jm.tokenizer.eot == 63
    assert tm.tokenizer.build_prompt_tokens(None) == jm.tokenizer.build_prompt_tokens(None)
    # the parameters are module buffers
    sd = tm.state_dict()
    assert "decoder.layers.fc1.weight" in sd


def test_load_model_quantize_w8a8_matches_jax_quantize_tree(tmp_path):
    """``load_model(dir, quantize="w8a8")`` holds the int8 decoder that
    the JAX package's ``quantize_tree`` makes of the same checkpoint, and
    takes the fused route."""
    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.stt import load_model

    d = make_whisper_fixture(tmp_path / "w", d_model=256, layers=1, heads=4,
                             ffn=1024)
    write_fixture_tokenizer(d, 64)
    jm = JW.Whisper.from_pretrained(str(d), dtype=jnp.float32)
    want = loading.flatten(jax_tree_to_numpy(
        jquant.quantize_tree(jm.params["model"]["decoder"], scheme="w8a8")))
    tm = load_model(str(d), dtype=torch.float32, device="cpu", quantize="w8a8")
    assert tm._fused_supported()
    got = loading.flatten(tm.params["model"]["decoder"])
    assert want.keys() == got.keys()
    n_int8 = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, tuple):
            assert isinstance(g, tquant.Int8Tensor), k
            g, n_int8 = (g.weight, g.scale), n_int8 + 1
        else:
            w, g = (w,), (g,)
        for gi, wi in zip(g, w):
            np.testing.assert_array_equal(gi.numpy(), wi, err_msg=k)
    assert n_int8 > 0


def test_safetensors_reader_matches_the_library(tmp_path):
    """The port's own reader against the safetensors package, every dtype
    a checkpoint brings (bf16 through its uint16 bits)."""
    from safetensors.torch import save_file

    from tpu_audio_torch.core import loading

    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "a.f16": torch.randn((7,), generator=g).to(torch.float16),
        "b.f32": torch.randn((2, 2, 3), generator=g),
        "b.i8": torch.randint(-128, 127, (4, 6), generator=g, dtype=torch.int8),
        "c.i64": torch.arange(5),
        "c.empty": torch.zeros((0, 4)),
    }
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    got = loading.load_safetensors(tmp_path)
    assert got.keys() == tensors.keys()
    for k, want in tensors.items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert torch.equal(got[k], want), k


ROUTES = {
    "dense": (False, dict()),
    "w8_dense": (True, dict()),
    "kv8d": (False, dict(kv_bits=8, quantized_kv_start=448)),
    "w8_kv8d": (True, dict(kv_bits=8, quantized_kv_start=448)),
}


@pytest.fixture(scope="module")
def fused_model():
    cfg = JW.WhisperConfig(**FUSED)
    params = JW.init_params(cfg, seed=5, dtype=jnp.float32)
    w8 = dict(params)
    w8["model"] = dict(params["model"])
    w8["model"]["decoder"] = jquant.quantize_tree(params["model"]["decoder"],
                                                 scheme="w8a8")
    audio = (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(np.float32)
    return cfg, {False: params, True: w8}, audio


@pytest.mark.parametrize("route", list(ROUTES))
def test_generate_greedy_tokens_match_jax(fused_model, monkeypatch, route):
    cfg, trees, audio = fused_model
    w8, kw = ROUTES[route]
    monkeypatch.setenv("TPU_AUDIO_PALLAS_KV", "interpret")
    monkeypatch.setenv("TPU_AUDIO_FUSED_DECODER", "interpret")
    jm = JW.Whisper(cfg, trees[w8], dtype=jnp.float32)
    jm.tokenizer = FakeWhisperTokenizer(vocab=cfg.vocab_size)
    want = jm.generate(audio, JParams(max_tokens=4, **kw))
    tm = TW.Whisper(TW.WhisperConfig(**FUSED),
                    from_jax_params(jax_tree_to_numpy(trees[w8])),
                    FakeWhisperTokenizer(vocab=cfg.vocab_size),
                    dtype=torch.float32, device="cpu")
    assert tm._fused_supported() == w8
    got = tm.generate(audio, TParams(max_tokens=4, **kw))
    assert [s.tokens for s in got.segments] == [s.tokens for s in want.segments]
    assert got.text == want.text
    assert len(got.segments[0].tokens) > 0
    if route == "dense":
        lang, prob = tm.detect_language(audio)
        jlang, jprob = jm.detect_language(audio)
        assert lang == jlang and prob == pytest.approx(jprob, rel=1e-4)
    if route == "w8_kv8d":
        events = list(tm.generate_stream(audio, TParams(max_tokens=4, **kw)))
        assert events[-1]["type"] == "result"
        assert events[-1]["output"].text == want.text


def test_unported_options_raise(fused_model):
    cfg, trees, audio = fused_model
    tm = TW.Whisper(TW.WhisperConfig(**FUSED),
                    from_jax_params(jax_tree_to_numpy(trees[False])),
                    FakeWhisperTokenizer(vocab=cfg.vocab_size),
                    dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="kv_bits=4"):
        tm.generate(audio, TParams(max_tokens=2, kv_bits=4))
    with pytest.raises(NotImplementedError, match="self-attention caches"):
        tm.generate(audio, TParams(max_tokens=2, kv_bits=8))
    with pytest.raises(ValueError, match="scheme"):
        tquant.quantize_tree({}, scheme="int3")
    with pytest.raises(FileNotFoundError):
        TW.Whisper.from_pretrained("openai/whisper-large-v3", device="cpu")


@pytest.mark.parametrize("seconds", [1, 40])
def test_cli_writes_the_same_text_as_jax_cli(tmp_path, capsys, seconds):
    """One window, and a 40 s file: two windows in one batch, the default."""
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio_torch.cli import stt as tstt

    d = make_whisper_fixture(tmp_path / "w")
    write_fixture_tokenizer(d, 64)
    wav = tmp_path / "in.wav"
    save_wav(wav, np.random.default_rng(0).standard_normal(16000 * seconds).astype(
        np.float32) * 0.1, 16000)
    outs = {}
    for name, main, extra in (("jax", jstt.main, []),
                              ("torch", tstt.main, ["--device", "cpu"])):
        for fmt in ("txt", "json"):
            path = tmp_path / f"{name}.{fmt}"
            assert main([str(wav), "--model", str(d), "--max-tokens", "4",
                         "--format", fmt, "--output", str(path)] + extra) == 0
            outs[name, fmt] = path.read_text()
    assert outs["torch", "txt"] == outs["jax", "txt"]
    assert json.loads(outs["torch", "json"]) == json.loads(outs["jax", "json"])
    assert "[stt]" in capsys.readouterr().err
