"""Sortformer on the PyTorch port against the JAX package, on the CPU at the
fixture's narrow widths (``tests/fixtures.make_sortformer_fixture``: 2 x 16
conformer, 2 x 8 transformer, 16 mels, 16-frame speaker cache and FIFO),
and ``core.nn.sdpa``'s masks.

The fixture's periodic weights put every speaker probability within 0.01 of
the 0.5 threshold, so the comparisons run on copies of its layout with
seeded normal weights (``_write``); both packages load the same checkpoint.
Tolerances, f32: 1e-4 absolute on log-mel features (f32 FFTs in another
order) and speaker probabilities; 1e-5 of the largest value on
``pre_encode``, a conformer layer and the transformer; segments, RTTM,
streaming state lengths and AOSC picks equal, ``mean_sil_emb`` within 1e-5;
``_compress_aosc`` and ``maybe_compress_state`` on identical inputs bit for
bit (the random models' frames are never silent, so the silence profile is
held there, on a state with silent frames). bf16: speaker
probabilities within ``BF16_ATOL`` of the JAX package's bf16 run.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import loading as jloading
from tpu_audio.core import nn as jnn
from tpu_audio.models.vad import sortformer as JS
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import nn as tnn
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.vad import sortformer as TS

from fixtures import make_sortformer_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-4
RTOL = 1e-5
BF16_ATOL = 2e-2


def _audio(seed, n, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _write(path, seed):
    """The fixture's layout with seeded normal weights: N(0, 1/fan_in)
    weights, N(0, 0.05) biases and position biases, N(0, 0.1) learned
    positions, norm weights 1 + N(0, 0.1), running means N(0, 0.1) and
    variances 1 + |N(0, 0.2)|."""
    from safetensors.numpy import save_file

    path = make_sortformer_fixture(path)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(jloading.load_safetensors(path).items()):
        shape = v.shape
        if "running_var" in name:
            a = 1.0 + np.abs(0.2 * rng.standard_normal(shape))
        elif "running_mean" in name:
            a = 0.1 * rng.standard_normal(shape)
        elif "norm" in name and name.endswith(".weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith(("bias", "bias_u", "bias_v")):
            a = 0.05 * rng.standard_normal(shape)
        elif "embed_positions" in name:
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("sortformer") / "s", 2)
    return (path, JS.Sortformer.from_pretrained(str(path)),
            TS.Sortformer.from_pretrained(str(path), device="cpu"))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- core.nn.sdpa's masks ---------------------------------------------------------


def _qkv(seed, b=2, h=3, s=9, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]


def test_sdpa_additive_mask_matches_jax():
    """A float mask is added to the f32 scores, as in the JAX ``nn.sdpa``:
    Sortformer's ``-1e4`` padding mask."""
    q, k, v = _qkv(0)
    mask = ((np.arange(9) >= 6)[None, None, None, :] * -1e4).astype(np.float32)
    want = jnn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    got = tnn.sdpa(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # the masked keys take no weight: the values past 6 do not matter
    v2 = v.copy()
    v2[:, :, 6:] = 100.0
    got2 = tnn.sdpa(*map(torch.from_numpy, (q, k, v2)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_boolean_mask_unchanged(causal):
    """A boolean mask gives the same output bit for bit as the formula it
    had before the float mask was added (``masked_fill(~mask, -1e9)``)."""
    q, k, v = map(torch.from_numpy, _qkv(1))
    mask = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 1, 9, 9)) > 0.3)
    scores = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / np.sqrt(8))
    if causal:
        scores = scores.masked_fill(~torch.ones((9, 9), dtype=torch.bool).tril(0), -1e9)
    scores = scores.masked_fill(~mask, -1e9)
    want = torch.softmax(scores, dim=-1).to(q.dtype) @ v
    got = tnn.sdpa(q, k, v, mask=mask, is_causal=causal)
    assert torch.equal(got, want)
    jwant = jnn.sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), mask=jnp.asarray(mask.numpy()),
                     is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-6, rtol=0)


# -- pieces ----------------------------------------------------------------------


@pytest.mark.parametrize("n,normalize,pad_to", [(16000, "per_feature", 16), (12345, None, 0),
                                                (400, "per_feature", 16)])
def test_mel_features_match_jax(models, n, normalize, pad_to):
    _, jm, _ = models
    proc = jm.config.processor
    wav = _audio(n, n)
    want = JS.extract_mel_features(wav, proc, normalize=normalize, pad_to=pad_to)
    got = TS.extract_mel_features(wav, TS.ProcessorConfig(**vars(proc)), normalize=normalize,
                                  pad_to=pad_to)
    assert got.shape == want.shape and (pad_to == 0 or got.shape[1] % pad_to == 0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _params(jm):
    return from_jax_params(jax_tree_to_numpy(jm.params))


def test_pre_encode_matches_jax(models):
    _, jm, tm = models
    mel = np.random.default_rng(5).standard_normal((2, 77, 16)).astype(np.float32)
    lengths = np.array([77, 50], np.int32)
    je, jl = JS.pre_encode(jm.params, jnp.asarray(mel), jnp.asarray(lengths), jm.config.fc_encoder)
    te, tl = TS.pre_encode(tm.params, torch.from_numpy(mel), torch.from_numpy(lengths),
                           tm.config.fc_encoder)
    assert te.shape == je.shape and tl.tolist() == np.asarray(jl).tolist()
    assert _rel(te, je) < RTOL
    assert [TS.subsampled_length(n) for n in (77, 50, 1, 8)] == [10, 7, 1, 1]


@pytest.mark.parametrize("masked", [False, True])
def test_conformer_layer_matches_jax(models, masked):
    _, jm, _ = models
    p = _params(jm)
    cfg = jm.config.fc_encoder
    x = np.random.default_rng(6).standard_normal((2, 13, cfg.hidden_size)).astype(np.float32)
    pos = JS._rel_pos_emb(13, cfg.hidden_size)
    mask = (np.arange(13) >= 9)[None, None, None, :] if masked else None
    want = JS._fc_layer(jm.params["fc_encoder"]["layers"]["0"], jnp.asarray(x), jnp.asarray(pos),
                        cfg, None if mask is None else jnp.asarray(mask))
    got = TS._fc_layer(p["fc_encoder"]["layers"]["0"], torch.from_numpy(x), torch.from_numpy(pos),
                       TS.FCEncoderConfig(**vars(cfg)),
                       None if mask is None else torch.from_numpy(mask))
    assert _rel(got, want) < RTOL
    np.testing.assert_allclose(TS._rel_pos_encoding(13, cfg.hidden_size), pos, atol=1e-7, rtol=0)


def test_encoders_match_jax(models):
    """``fc_encode`` and ``tf_encode`` with a padding mask (8 valid of 12)."""
    _, jm, tm = models
    x = np.random.default_rng(7).standard_normal((1, 12, 16)).astype(np.float32)
    want = JS.fc_encode(jm.params, jnp.asarray(x), jm.config.fc_encoder)
    got = TS.fc_encode(tm.params, torch.from_numpy(x), tm.config.fc_encoder)
    assert _rel(got, want) < RTOL
    y = np.random.default_rng(8).standard_normal((1, 12, 8)).astype(np.float32)
    want = JS.tf_encode(jm.params, jnp.asarray(y), 8, jm.config.tf_encoder)
    got = TS.tf_encode(tm.params, torch.from_numpy(y), 8, tm.config.tf_encoder)
    assert _rel(got, want) < RTOL
    got_t = TS.tf_encode(tm.params, torch.from_numpy(y), torch.tensor(8), tm.config.tf_encoder)
    assert torch.equal(got, got_t)


# -- offline ---------------------------------------------------------------------


def _segments(segs):
    return [(s.start, s.end, s.speaker) for s in segs]


@pytest.mark.parametrize("name", ["noise", "two_speaker_16k.wav"])
def test_generate_matches_jax(models, name):
    _, jm, tm = models
    audio = (_audio(9, 16000 * 3) if name == "noise"
             else load_audio(f"tests/media/{name}", sample_rate=16000)[0])
    audio = np.concatenate([np.zeros(1000, np.float32), audio])  # a trimmed lead
    want, got = jm.generate(audio), tm.generate(audio)
    assert got["speaker_probs"].shape == want["speaker_probs"].shape
    np.testing.assert_allclose(got["speaker_probs"], want["speaker_probs"], atol=ATOL, rtol=0)
    assert _segments(got["segments"]) == _segments(want["segments"])
    assert got["num_speakers"] == want["num_speakers"]
    assert TS.segments_to_rttm(got["segments"], "x") == JS.segments_to_rttm(want["segments"], "x")
    assert got["segments"] and got["segments"][0].start >= 1000 / 16000


def test_generate_bf16_matches_jax_bf16(models):
    path, _, _ = models
    jm = JS.Sortformer.from_pretrained(str(path), dtype=jnp.bfloat16)
    tm = TS.Sortformer.from_pretrained(str(path), dtype=torch.bfloat16, device="cpu")
    audio = _audio(10, 16000 * 2)
    want = np.asarray(jm.generate(audio)["speaker_probs"], np.float32)
    got = tm.generate(audio)["speaker_probs"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_preds_to_segments_and_rttm_equal():
    rng = np.random.default_rng(11)
    preds = rng.uniform(0, 1, (60, 4)).astype(np.float32)
    for args in ((0.08,), (0.08, 0.5, 0.2), (0.08, 0.4, 0.0, 0.3)):
        got, want = TS.preds_to_segments(preds, *args), JS.preds_to_segments(preds, *args)
        assert _segments(got) == _segments(want)
        assert TS.segments_to_rttm(got) == JS.segments_to_rttm(want)


# -- streaming -------------------------------------------------------------------


def test_compress_aosc_bit_for_bit():
    """On identical NumPy inputs the port's AOSC compression equals the JAX
    package's bit for bit: random probabilities, saturated ones (ties), few
    speech frames, and the fixture's and the default cache sizes."""
    rng = np.random.default_rng(12)
    for mc, frames in ((JS.ModulesConfig(spkcache_len=16, spkcache_sil_frames_per_spk=1), 29),
                       (JS.ModulesConfig(), 190), (JS.ModulesConfig(), 250)):
        tmc = TS.ModulesConfig(**vars(mc))
        for case in range(4):
            preds = rng.uniform(0, 1, (1, frames, 4)).astype(np.float32)
            if case == 1:
                preds[preds > 0.6] = 1.0
            elif case == 2:
                preds *= 0.55
            elif case == 3:
                preds = np.round(preds * 4) / 4
            embs = rng.standard_normal((1, frames, 6)).astype(np.float32)
            mean_sil = rng.standard_normal((1, 6)).astype(np.float32)
            je, jp = JS._compress_aosc(embs, preds, mean_sil, mc)
            te, tp = TS._compress_aosc(embs, preds, mean_sil, tmc)
            assert te.dtype == je.dtype and tp.dtype == jp.dtype
            np.testing.assert_array_equal(te, je)
            np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("use_aosc", [True, False])
def test_maybe_compress_state_bit_for_bit(models, use_aosc):
    """On an identical NumPy state whose FIFO holds silent frames (speaker
    probabilities summing below ``sil_threshold``), the FIFO pop, the
    silence profile (``mean_sil_emb``, ``n_sil_frames``) and the cache
    compression (AOSC, or the plain top-k without it) equal the JAX
    package's bit for bit."""
    import copy

    _, jm, tm = models
    jcfg, tcfg = copy.deepcopy(jm.config), copy.deepcopy(tm.config)
    jcfg.modules.use_aosc = tcfg.modules.use_aosc = use_aosc
    jmodel, tmodel = JS.Sortformer(jcfg, jm.params), TS.Sortformer(tcfg, tm.params)
    rng = np.random.default_rng(16)
    state = tmodel.init_streaming_state()
    state["spkcache"] = rng.standard_normal((1, 10, 16)).astype(np.float32)
    state["spkcache_preds"] = rng.uniform(0, 1, (1, 10, 4)).astype(np.float32)
    state["fifo"] = rng.standard_normal((1, 40, 16)).astype(np.float32)
    preds = rng.uniform(0, 1, (1, 40, 4)).astype(np.float32)
    preds[:, ::3] *= 0.04  # silent frames
    state["fifo_preds"] = preds
    state["mean_sil_emb"] = rng.standard_normal((1, 16)).astype(np.float32)
    state["n_sil_frames"] = np.array([3.0], np.float32)
    for _ in range(2):
        want = jmodel.maybe_compress_state(dict(state), spkcache_max=16, fifo_max=16)
        got = tmodel.maybe_compress_state(dict(state), spkcache_max=16, fifo_max=16)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["spkcache"].shape[1] == 16
        assert (got["n_sil_frames"][0] > 3) == use_aosc  # the profile is AOSC's
        state = dict(got, fifo=np.concatenate([got["fifo"], state["fifo"][:, :20]], 1),
                     fifo_preds=np.concatenate([got["fifo_preds"], preds[:, :20]], 1))


def _stream_states(m, mod, audio, calls):
    """Feed ``audio`` chunk by chunk as ``generate_stream`` does (1 s chunks,
    16-frame caches), recording each chunk's probabilities and state, and
    the ``preds`` of every AOSC compression in ``calls``."""
    compress = mod._compress_aosc

    def spy(embs, preds, mean_sil, mc):
        calls.append(np.array(preds))
        return compress(embs, preds, mean_sil, mc)

    mod._compress_aosc = spy
    try:
        state, out = m.init_streaming_state(), []
        for start in range(0, len(audio), 15360):
            res, state = m.feed(audio[start:start + 15360], state, spkcache_max=16, fifo_max=16)
            out.append((res, {k: (np.array(v) if k != "frames_processed" else v)
                              for k, v in state.items()}))
    finally:
        mod._compress_aosc = compress
    return out


def test_streaming_matches_jax(models):
    """Per-chunk probabilities, state lengths, ``mean_sil_emb`` and the AOSC
    picks of every compression (at least three) against the JAX package."""
    _, jm, tm = models
    audio = _audio(13, 15360 * 6)
    jcalls, tcalls = [], []
    want = _stream_states(jm, JS, audio, jcalls)
    got = _stream_states(tm, TS, audio, tcalls)
    assert len(got) == len(want) == 6 and len(tcalls) == len(jcalls) >= 3
    for (gres, gst), (wres, wst) in zip(got, want):
        np.testing.assert_allclose(gres["speaker_probs"], wres["speaker_probs"], atol=ATOL, rtol=0)
        assert _segments(gres["segments"]) == _segments(wres["segments"])
        for k in ("spkcache", "spkcache_preds", "fifo", "fifo_preds"):
            assert gst[k].shape == wst[k].shape, k
        assert gst["frames_processed"] == wst["frames_processed"]
        np.testing.assert_allclose(gst["mean_sil_emb"], wst["mean_sil_emb"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(gst["n_sil_frames"], wst["n_sil_frames"])
        np.testing.assert_allclose(gst["spkcache_preds"], wst["spkcache_preds"], atol=ATOL, rtol=0)
    mc = tm.config.modules
    for tp, jp in zip(tcalls, jcalls):
        np.testing.assert_allclose(tp, jp, atol=ATOL, rtol=0)
        for a, b in zip(TS.aosc_picks(tp, mc), TS.aosc_picks(jp, mc)):
            np.testing.assert_array_equal(a, b)
    assert got[-1][1]["spkcache"].shape[1] == mc.spkcache_len == 16


def test_generate_stream_matches_jax(models):
    _, jm, tm = models
    audio = _audio(14, 16000 * 4 + 3000)
    want = list(jm.generate_stream(audio, chunk_duration=1.0, spkcache_max=16, fifo_max=16))
    got = list(tm.generate_stream(audio, chunk_duration=1.0, spkcache_max=16, fifo_max=16))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["speaker_probs"], w["speaker_probs"], atol=ATOL, rtol=0)
        assert _segments(g["segments"]) == _segments(w["segments"])


def test_random_params_match_the_checkpoint_layout(models):
    """``init_random_params`` gives the sanitized checkpoint's keys and
    shapes at the fixture's widths, and its model keeps frames apart."""
    path, _, tm = models
    cfg = TS.SortformerConfig.from_dict(json.loads((path / "config.json").read_text()))
    p = TS.init_random_params(cfg, seed=0)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    assert shapes(p) == shapes(tm.params)
    probs = TS.Sortformer(cfg, p).generate(_audio(15, 16000 * 2))["speaker_probs"]
    assert np.isfinite(probs).all() and probs.std(axis=0).min() > 1e-3
