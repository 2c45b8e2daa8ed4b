"""DeepFilterNet, the ``sts`` registry, ``cli/sts.py`` and the server's
``/v1/audio/enhance`` on the PyTorch port against the JAX package, on the
CPU at the fixture's narrow widths (``tests/fixtures.make_deepfilternet_fixture``:
8 channels, 8 ERB bands, 12 deep-filter bins, hidden 16, fft 96 / hop 48,
order 3, lookahead 1).

The fixture's periodic weights and its BatchNorm at ones and zeros would
hide a wrong BatchNorm row or a wrong flatten order, so the comparisons run
on copies of its layout with seeded normal weights and nonzero BatchNorm
statistics (``_write``), also with two-layer decoder GRUs (``_l1`` keys) and
other lookaheads; both packages load the same checkpoint, and the port also
takes the JAX package's params through ``convert.from_jax_params``. The
golden ``dfn_enhanced`` runs on the fixture as written.

Tolerances, f32: the DSP pieces, the GRU and the features 1e-5; ``enhance``
1e-4 absolute; the streamer against offline and against the JAX streamer
5e-4 (``tests/test_deepfilternet.py``'s: the streamed EMA is a recurrence,
the offline one a scan); the golden 5e-4 (``tests/test_media.py``'s).
"""

import contextlib
import io
import json
import threading
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import serve as jserve
from tpu_audio.cli import sts as jcli
from tpu_audio.core import dsp as jdsp
from tpu_audio.core import loading as jloading
from tpu_audio.core import nn as jnn
from tpu_audio.models.sts import deepfilternet as JD
from tpu_audio.models.sts import load_model as jload_model
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.cli import sts as tcli
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core import nn as tnn
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.sts import deepfilternet as TD
from tpu_audio_torch.models.sts import load_model as tload_model

from fixtures import make_deepfilternet_fixture

torch.set_num_threads(1)

ATOL = 1e-5
ENHANCE_ATOL = 1e-4
BF16_ATOL = 2e-3  # bf16 inputs: 4.3e-4 read between the packages, 2.7e-3 from f32
# bf16 streamer against bf16 offline: the two f32 EMAs (recurrence, scan) may
# round a feature to neighbouring bf16 values, which moves the output as far
# as bf16 against f32 does (2.7e-3 read)
BF16_STREAM_ATOL = 5e-3
EMA_JAX_ATOL = 1e-4  # 100,000 frames: the JAX package's scan sits 3.3e-5 from float64
STREAM_ATOL = 5e-4  # tests/test_deepfilternet.py's streamer-against-offline limit
GOLDEN_ATOL = 5e-4  # tests/test_media.py's dfn_enhanced limit
MEDIA = "tests/media"
# checkpoint variants: GRU layers of the two decoders; conv and df lookahead
VARIANTS = {"one_layer": (1, None), "two_layer": (2, None), "lookahead_2_1": (1, (2, 1)),
            "lookahead_0_2": (2, (0, 2))}


def _audio(seed, n, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _write(path, seed, dec_layers=1, lookahead=None):
    """The fixture's layout with seeded normal weights: N(0, 1/fan_in)
    weights (a grouped linear's fan-in is its group's), GRU biases N(0,
    0.1), BatchNorm weights 1 + N(0, 0.1), biases and running means N(0,
    0.1), variances 1 + |N(0, 0.2)|, ``mask.erb_inv_fb`` |N(0, 0.5)|; with
    ``dec_layers`` 2 the decoders' GRUs get a second layer (``_l1``), and
    ``lookahead`` (conv, df) rewrites the config's."""
    from safetensors.numpy import save_file

    path = make_deepfilternet_fixture(path)
    if lookahead is not None:
        cfg = json.loads((path / "config.json").read_text())
        cfg["convLookahead"], cfg["dfLookahead"] = lookahead
        (path / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(seed)
    flat = dict(sorted(jloading.load_safetensors(path).items()))
    if dec_layers == 2:
        for pfx in ("erb_dec.emb_gru.gru", "df_dec.df_gru.gru"):
            hid = flat[f"{pfx}.weight_hh_l0"].shape[1]
            for k in ("weight_ih", "weight_hh"):
                flat[f"{pfx}.{k}_l1"] = np.zeros((3 * hid, hid), np.float32)
            for k in ("bias_ih", "bias_hh"):
                flat[f"{pfx}.{k}_l1"] = np.zeros((3 * hid,), np.float32)
    norms = {k[: -len(".running_mean")] for k in flat if k.endswith(".running_mean")}
    out = {}
    for name, v in flat.items():
        prefix = name.rsplit(".", 1)[0]
        if name.endswith("running_var"):
            a = 1.0 + np.abs(0.2 * rng.standard_normal(v.shape))
        elif prefix in norms and name.endswith(".weight"):
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif prefix in norms or ".bias" in name:
            a = 0.1 * rng.standard_normal(v.shape)
        elif name == "mask.erb_inv_fb":
            a = np.abs(0.5 * rng.standard_normal(v.shape))
        else:
            fan_in = v.shape[1] if v.ndim == 3 else int(np.prod(v.shape[1:]))
            a = rng.standard_normal(v.shape) / np.sqrt(fan_in)
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("dfn")
    return {name: _write(root / name, 11 + i, layers, la)
            for i, (name, (layers, la)) in enumerate(VARIANTS.items())}


@pytest.fixture(scope="module")
def models(ckpts):
    return {name: (JD.DeepFilterNet.from_pretrained(str(p)),
                   TD.DeepFilterNet.from_pretrained(str(p), device="cpu"))
            for name, p in ckpts.items()}


def _jax_numpy(model) -> dict:
    return {k: np.asarray(v) for k, v in model.params.items()}


# -- DSP and layers ----------------------------------------------------------------


@pytest.mark.parametrize("sr,fft,bands,min_freqs,hop", [
    (48000, 960, 32, 2, 480), (48000, 96, 8, 2, 48), (16000, 512, 24, 2, 256),
    (24000, 480, 16, 3, 120)])
def test_erb_widths_window_and_alpha_equal_jax(sr, fft, bands, min_freqs, hop):
    assert TD.erb_band_widths(sr, fft, bands, min_freqs) == JD.erb_band_widths(
        sr, fft, bands, min_freqs)
    np.testing.assert_array_equal(TD.vorbis_window(fft), JD.vorbis_window(fft))
    assert TD.compute_norm_alpha(hop, sr) == JD.compute_norm_alpha(hop, sr)


@pytest.mark.parametrize("center,length", [(False, None), (False, 1000), (False, 5000),
                                           (True, None), (True, 777)])
def test_istft_matches_jax(center, length):
    """The overlap-add ISTFT on the vorbis window (whose edge squares to
    1.8e-11: ``torch.istft``'s NOLA check would refuse it). A random
    spectrum's first and last samples divide by that square and reach ~200,
    where f32 rounds at ~2e-7 relative: 1e-5 absolute, 1e-6 relative."""
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((37, 49)) + 1j * rng.standard_normal((37, 49))).astype(
        np.complex64)
    win = JD.vorbis_window(96)
    want = np.asarray(jdsp.istft(jnp.asarray(spec), win, 96, 48, length=length, center=center))
    got = tdsp.istft(torch.from_numpy(spec), win, 96, 48, length=length, center=center).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    got_n = tdsp.irfft(torch.from_numpy(spec), 96).numpy()
    np.testing.assert_allclose(got_n, np.asarray(jdsp.irfft(jnp.asarray(spec), 96)), atol=ATOL)


@pytest.mark.parametrize("t,with_h0,with_bias", [(1, False, True), (1, True, True),
                                                 (9, False, True), (9, True, True),
                                                 (9, True, False)])
def test_gru_matches_jax(t, with_h0, with_bias):
    rng = np.random.default_rng(t)
    p = {"weight_ih": rng.standard_normal((3 * 12, 5)) * 0.4,
         "weight_hh": rng.standard_normal((3 * 12, 12)) * 0.4}
    if with_bias:
        p.update(bias_ih=rng.standard_normal(36) * 0.2, bias_hh=rng.standard_normal(36) * 0.2)
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 12)).astype(np.float32) if with_h0 else None
    want_y, want_h = jnn.gru({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = tnn.gru({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)


@pytest.mark.parametrize("shape,fstride,cin,lookahead", [
    ((8, 1, 3, 3), 1, 1, 0), ((8, 2, 3, 3), 1, 2, 0), ((8, 1, 1, 3), 2, 8, 0),
    ((8, 8, 1, 1), 1, 8, 0), ((6, 8, 1, 3), 1, 8, 0), ((8, 2, 3, 3), 1, 2, 1),
    ((8, 1, 3, 3), 2, 1, 3)])
def test_conv2d_matches_jax(shape, fstride, cin, lookahead):
    """Causal-time conv with and without lookahead (past ``k_t - 1`` it
    crops the first frames): channels-last in JAX, [B, C, T, F] in the
    port; without lookahead also streamed a frame at a time through the
    carried tail."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    x = rng.standard_normal((1, 7, 12, cin)).astype(np.float32)  # [B, T, F, C]
    want = np.asarray(JD._conv2d(jnp.asarray(w), jnp.asarray(x), fstride, lookahead))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = TD._conv2d(torch.from_numpy(w), xt, fstride, lookahead).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    if lookahead:
        return
    ts = TD._TailStore({})
    frames = [ts.conv({"c.weight": torch.from_numpy(w)}, "c", xt[:, :, i: i + 1], fstride)
              for i in range(xt.shape[2])]
    np.testing.assert_allclose(torch.cat(frames, 2).permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL)


@pytest.mark.parametrize("fstride", [2])
def test_convt2d_matches_jax(fstride):
    """One grouped ``conv_transpose2d`` against the JAX package's loop over
    the groups."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 1, 1, 3)).astype(np.float32)
    x = rng.standard_normal((1, 5, 6, 8)).astype(np.float32)
    want = np.asarray(JD._convt2d(jnp.asarray(w), jnp.asarray(x), fstride, groups=8))
    got = TD._convt2d(torch.from_numpy(w), torch.from_numpy(x).permute(0, 3, 1, 2), fstride,
                      groups=8).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 5, 12, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_grouped_linear_and_batch_norm_match_jax(models):
    jm, tm = models["one_layer"]
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 6, 5)).astype(np.float32)
    x = rng.standard_normal((2, 3, 24)).astype(np.float32)
    np.testing.assert_allclose(
        TD._grouped_linear(torch.from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(JD._grouped_linear(jnp.asarray(w), jnp.asarray(x))), atol=ATOL)
    y = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)  # [B, T, F, C]
    want = np.asarray(JD._batch_norm(jm.params, "enc.erb_conv1.2", jnp.asarray(y)))
    got = TD._batch_norm(tm._bn["enc.erb_conv1.2"], torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL)


# -- features ------------------------------------------------------------------------


def _jax_features(jm, padded):
    """The JAX package's features as ``_enhance_impl`` computes them."""
    cfg = jm.config

    @jax.jit
    def feats(x):
        spec = JD._stft(x, JD.vorbis_window(cfg.fft_size), cfg.fft_size, cfg.hop_size) * jm.wnorm
        re, im = spec.real, spec.imag
        erb_db = 10.0 * jnp.log10((re**2 + im**2) @ jnp.asarray(jm.erb_fb) + 1e-10)
        dfr, dfi = jm._band_unit_norm(re[:, : cfg.nb_df], im[:, : cfg.nb_df])
        return (jnp.stack([re, im], -1), jm._band_mean_norm(erb_db), jnp.stack([dfr, dfi], -1))

    return [np.asarray(v) for v in feats(jnp.asarray(padded))]


@pytest.mark.parametrize("n", [48 * 40 + 7, 5000, 31])
def test_features_match_jax(models, n):
    jm, tm = models["one_layer"]
    cfg = tm.config
    padded = np.pad(_audio(n, n), (cfg.hop_size, cfg.fft_size))
    want = _jax_features(jm, padded)
    got = tm.features(torch.from_numpy(padded))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_ema_100k_frames_matches_sequential_and_jax(models):
    """The log-depth scan stays finite past ~88 s of audio (where a closed
    form through a**t overflows) and holds to the sequential EMA in float64
    at 1e-5 (read: 4.9e-7). The JAX package's associative scan rounds
    further from it (3.3e-5 read), so the two packages are held at 1e-4."""
    jm, tm = models["one_layer"]
    a, t = tm.norm_alpha, 100_000
    x = np.random.default_rng(0).standard_normal((t, 4)).astype(np.float32) * 10 - 60.0
    got = tm._band_mean_norm(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    s = np.linspace(-60.0, -90.0, 4, dtype=np.float64) / a
    want = np.empty((t, 4))
    for i in range(t):
        s = a * s + (1 - a) * x[i].astype(np.float64)
        want[i] = (x[i] - s) / 40.0
    np.testing.assert_allclose(got, want, atol=ATOL)
    want_jax = jax.jit(jm._band_mean_norm)(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want_jax), atol=EMA_JAX_ATOL)


# -- enhance ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_enhance_matches_jax(models, variant):
    jm, tm = models[variant]
    hop = tm.config.hop_size
    for n in (hop * 40 + 7, hop * 3, 100):
        audio = _audio(n + 1, n)
        want = jm.enhance(audio)
        got = tm.enhance(audio)
        assert got.shape == want.shape == audio.shape
        np.testing.assert_allclose(got, want, atol=ENHANCE_ATOL)
    # the gains and coefficients move with the audio (the random model does
    # not sit at a constant mask)
    assert np.abs(got - audio).max() > 1e-3


def test_enhance_bf16_matches_jax(ckpts):
    """``dtype=bfloat16`` as the JAX package reads it: the network's inputs
    in bf16, the first convolutions in bf16, f32 from the first BatchNorm
    on (2.7e-3 from f32 in both packages; 4.3e-4 between them)."""
    path = str(ckpts["two_layer"])
    jm = JD.DeepFilterNet.from_pretrained(path, dtype=jnp.bfloat16)
    tm = TD.DeepFilterNet.from_pretrained(path, dtype=torch.bfloat16, device="cpu")
    audio = _audio(3, 48 * 40 + 7)
    got = tm.enhance(audio)
    np.testing.assert_allclose(got, jm.enhance(audio), atol=BF16_ATOL)
    np.testing.assert_allclose(_stream(TD.DeepFilterNetStreamer(tm), audio, [48, 173, 999]),
                               got, atol=BF16_STREAM_ATOL)


def test_enhance_through_converted_jax_params(models):
    jm, tm = models["two_layer"]
    conv = TD.DeepFilterNet(tm.config, from_jax_params(_jax_numpy(jm)))
    audio = _audio(5, 48 * 30)
    np.testing.assert_array_equal(conv.enhance(audio), tm.enhance(audio))


def test_init_random_params_runs_in_both_packages():
    """``init_random_params`` at a narrow geometry (embedding 16 wide beside
    hidden 24, DeepFilterNet3's GRU layer counts) writes every key both
    packages' networks read: the JAX package on the same weights agrees."""
    cfg = TD.DeepFilterNetConfig(fft_size=96, hop_size=48, nb_erb=8, nb_df=12, df_order=3,
                                 df_lookahead=1, conv_lookahead=1, conv_ch=8,
                                 emb_hidden_dim=24, df_hidden_dim=24)
    p = TD.init_random_params(cfg, seed=0, device="cpu")
    assert sum(k.endswith("_l0") for k in p if "weight_ih" in k) == 3
    assert sum("weight_ih" in k for k in p) == 1 + (cfg.emb_num_layers - 1) + cfg.df_num_layers
    tm = TD.DeepFilterNet(cfg, p)
    jm = JD.DeepFilterNet(JD.DeepFilterNetConfig(**vars(cfg)),
                          {k: jnp.asarray(v.numpy()) for k, v in p.items()})
    audio = _audio(6, 48 * 50)
    got = tm.enhance(audio)
    np.testing.assert_allclose(got, jm.enhance(audio), atol=ENHANCE_ATOL)
    assert np.isfinite(got).all() and np.abs(got - audio).max() > 1e-3


def test_golden_dfn_enhanced():
    """The fixture as written over the real noisy clip, against the golden
    the JAX package's media test pins."""
    import tempfile
    from pathlib import Path

    gold = json.loads(open("tests/golden/media_goldens.json").read())["dfn_enhanced"]
    with tempfile.TemporaryDirectory() as d:
        m = TD.DeepFilterNet.from_pretrained(str(make_deepfilternet_fixture(Path(d))),
                                             device="cpu")
    noisy, _ = load_audio(f"{MEDIA}/noisy_48k.wav")
    out = m.enhance(noisy[:24000]).astype(np.float64)
    assert out.size == gold["shape"]
    np.testing.assert_allclose(out[: len(gold["first"])], gold["first"], atol=GOLDEN_ATOL)
    np.testing.assert_allclose(out.mean(), gold["mean"], atol=GOLDEN_ATOL)


# -- streaming -------------------------------------------------------------------------


def _stream(streamer, audio, sizes):
    outs, pos = [], 0
    for size in sizes:
        if pos >= len(audio):
            break
        outs.append(streamer.process_chunk(audio[pos: pos + size]))
        pos += size
    if pos < len(audio):
        outs.append(streamer.process_chunk(audio[pos:]))
    outs.append(streamer.flush())
    return np.concatenate([o for o in outs if len(o)])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streamer_matches_offline_and_jax_streamer(models, variant):
    """The JAX test's awkward chunk sizes: the port's streamer against its
    own offline ``enhance`` and the JAX package's, and against the JAX
    streamer where that one keeps to offline (no conv lookahead). With a
    conv lookahead the JAX streamer departs from offline on these random
    weights (it runs the network on the frames offline's shift drops, and
    flushes zero features where offline has a frame of silence): the port's
    streamer follows offline there (ROADMAP.md §3 records the departure)."""
    jm, tm = models[variant]
    hop = tm.config.hop_size
    audio = _audio(0, hop * 23 + 37)
    sizes = [hop, 173, hop * 7, 1, 999, hop * 30]
    streamer = TD.DeepFilterNetStreamer(tm)
    got = _stream(streamer, audio, sizes)
    want_jax = _stream(JD.DeepFilterNetStreamer(jm), audio, sizes)
    assert got.shape == want_jax.shape == audio.shape
    np.testing.assert_allclose(got, tm.enhance(audio), atol=STREAM_ATOL)
    np.testing.assert_allclose(got, jm.enhance(audio), atol=STREAM_ATOL)
    if tm.config.conv_lookahead == 0:
        np.testing.assert_allclose(got, want_jax, atol=STREAM_ATOL)
    assert "ms/hop" in streamer.profiling_summary()
    # reset starts a new stream from the same state
    streamer.reset()
    np.testing.assert_array_equal(_stream(streamer, audio, sizes), got)


def test_streamer_matches_jax_streamer_on_the_fixture(tmp_path):
    """On the fixture as written (the JAX tests' weights), where the JAX
    streamer keeps within 5e-4 of offline, both streamers agree."""
    path = make_deepfilternet_fixture(tmp_path / "f")
    jm = JD.DeepFilterNet.from_pretrained(str(path))
    tm = TD.DeepFilterNet.from_pretrained(str(path), device="cpu")
    hop = tm.config.hop_size
    audio = _audio(0, hop * 23 + 37)
    sizes = [hop, 173, hop * 7, 1, 999, hop * 30]
    got = _stream(TD.DeepFilterNetStreamer(tm), audio, sizes)
    np.testing.assert_allclose(got, _stream(JD.DeepFilterNetStreamer(jm), audio, sizes),
                               atol=STREAM_ATOL)
    np.testing.assert_allclose(got, tm.enhance(audio), atol=STREAM_ATOL)


def test_streamer_on_the_noisy_clip(models):
    """tests/test_media.py's chunking over the real noisy clip."""
    jm, tm = models["two_layer"]
    hop = tm.config.hop_size
    noisy = load_audio(f"{MEDIA}/noisy_48k.wav")[0][: hop * 31]
    got = _stream(TD.DeepFilterNetStreamer(tm), noisy, [hop, 173, 999, hop * 13])
    np.testing.assert_allclose(got, tm.enhance(noisy), atol=STREAM_ATOL)


@pytest.mark.parametrize("n,chunk", [(3000, 960), (48 * 11, 48 * 3), (47, None), (10, 4)])
def test_enhance_streaming_lengths(models, n, chunk):
    jm, tm = models["one_layer"]
    audio = _audio(n, n)
    got = list(tm.enhance_streaming(audio, chunk_samples=chunk))
    want = list(jm.enhance_streaming(audio, chunk_samples=chunk))
    assert sum(len(c) for c in got) == sum(len(c) for c in want) == n
    np.testing.assert_allclose(np.concatenate(got), tm.enhance(audio), atol=STREAM_ATOL)


# -- registry, CLI, server ---------------------------------------------------------------


def _retyped(src, dst, **cfg_updates):
    import shutil

    shutil.copytree(src, dst)
    cfg = json.loads((dst / "config.json").read_text())
    for k, v in cfg_updates.items():
        if v is None:
            cfg.pop(k, None)
        else:
            cfg[k] = v
    (dst / "config.json").write_text(json.dumps(cfg))
    return dst


@pytest.mark.parametrize("model_version,model_type", [
    ("DeepFilterNet3", "deepfilternet3"), ("DeepFilterNet2", None), (None, "deepfilternet"),
    (None, None)])
def test_load_model_registry(ckpts, tmp_path, model_version, model_type):
    """``modelVersion``, then ``model_type``, then the directory's name, as the
    JAX package looks them up."""
    d = _retyped(ckpts["one_layer"], tmp_path / "deepfilternet3_ckpt",
                 modelVersion=model_version, model_type=model_type)
    tm = tload_model(str(d), device="cpu")
    assert isinstance(tm, TD.DeepFilterNet) and tm.sample_rate == 48000
    assert isinstance(jload_model(str(d)), JD.DeepFilterNet)


@pytest.mark.parametrize("model_type,missing", [
    ("mossformer2_se", "MossFormer2-SE"), ("mossformer2", "MossFormer2-SE"),
    ("sam_audio", "SAM-Audio"), ("lfm2_audio", "LFM2-Audio"), ("lfm2audio", "LFM2-Audio")])
def test_load_model_names_what_is_not_ported(ckpts, tmp_path, model_type, missing):
    d = _retyped(ckpts["one_layer"], tmp_path / "ckpt", modelVersion=None, model_type=model_type)
    with pytest.raises(ValueError, match=missing):
        tload_model(str(d), device="cpu")


def test_load_model_refuses_unknown_family(ckpts, tmp_path):
    d = _retyped(ckpts["one_layer"], tmp_path / "ckpt", modelVersion=None, model_type="whisper")
    with pytest.raises(ValueError, match="unsupported STS model_type 'whisper'"):
        tload_model(str(d), device="cpu")


def _wav_bytes(audio, sr=48000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _post(srv, path, body):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}{path}",
                                     data=body)
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def _pcm(wav: bytes):
    with wave.open(io.BytesIO(wav)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("sr", [48000, 16000])
def test_server_enhance_matches_jax_route(models, sr):
    """``/v1/audio/enhance``: a WAV in (resampled to 48 kHz where it is not),
    the enhanced WAV out; the port's samples are ``enhance``'s and within
    one PCM16 step of the JAX route's."""
    jm, tm = models["two_layer"]
    body = _wav_bytes(_audio(7, sr // 10), sr)
    got_sr, got = _pcm(_post(tserve.build_server(tm, "sts", "dfn", port=0),
                             "/v1/audio/enhance", body))
    want_sr, want = _pcm(_post(jserve.build_server(jm, "sts", "dfn", port=0),
                               "/v1/audio/enhance", body))
    assert got_sr == want_sr == 48000 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    heard = tserve._load_wav_body(body, 48000)[0]
    np.testing.assert_array_equal(got, np.round(np.clip(tm.enhance(heard), -1, 1) * 32767))


def test_serve_detects_sts_and_refuses_quantize(ckpts):
    assert "sts" in tserve.TASKS
    assert tserve.detect_task(str(ckpts["one_layer"])) == "sts"
    with pytest.raises(SystemExit, match="no load-time quantization"):
        tserve.main(["--model", str(ckpts["one_layer"]), "--task", "sts", "--quantize",
                     "w8a8", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["short", "long", "stream"])
def test_cli_sts_matches_jax(ckpts, tmp_path, mode):
    """``cli/sts.py`` writes what the JAX CLI writes, with the same stderr
    line: ``short`` and ``long`` within one PCM16 step; ``stream`` (the
    streamer) within 5e-4 of the JAX CLI's offline output, which the JAX
    streamer departs from under this checkpoint's conv lookahead (see
    ``test_streamer_matches_offline_and_jax_streamer``)."""
    from tpu_audio.core.audio_io import save_wav

    wav = tmp_path / "in.wav"
    save_wav(str(wav), _audio(9, 48 * 37), 48000)
    outs = {}
    for name, cli, m, extra in (("torch", tcli, mode, ["--device", "cpu"]),
                                ("jax", jcli, "short" if mode == "stream" else mode, [])):
        err = io.StringIO()
        out = tmp_path / f"{name}.wav"
        with contextlib.redirect_stderr(err):
            assert cli.main([str(wav), "--model", str(ckpts["two_layer"]), "--mode", m,
                             "-o", str(out), *extra]) == 0
        assert err.getvalue().startswith("[sts] 0.04s audio in ") and str(out) in err.getvalue()
        outs[name] = load_audio(str(out))[0]
    assert outs["torch"].shape == outs["jax"].shape == (48 * 37,)
    np.testing.assert_allclose(outs["torch"], outs["jax"], atol=STREAM_ATOL + 1 / 32768
                               if mode == "stream" else 1.5 / 32768)


@pytest.mark.parametrize("flags,names", [(["--prompt", "a dog"], "SAM-Audio"),
                                         (["--residual-output", "r.wav"], "SAM-Audio"),
                                         (["--chunk-seconds", "5"], "SAM-Audio"),
                                         (["--overlap-seconds", "1"], "SAM-Audio"),
                                         (["--ode-steps", "8"], "SAM-Audio"),
                                         (["--text", "hi"], "LFM2-Audio"),
                                         (["--system", "be brief"], "LFM2-Audio"),
                                         (["--max-new-tokens", "16"], "LFM2-Audio"),
                                         (["--temperature", "0.2"], "LFM2-Audio"),
                                         (["--top-k", "5"], "LFM2-Audio"),
                                         (["--audio-temperature", "0.5"], "LFM2-Audio"),
                                         (["--audio-top-k", "2"], "LFM2-Audio"),
                                         (["--output-text", "t.txt"], "LFM2-Audio"),
                                         (["--text-only"], "LFM2-Audio")])
def test_cli_sts_refuses_separation_and_chat(ckpts, flags, names):
    with pytest.raises(SystemExit, match=names):
        tcli.main(["in.wav", "--model", str(ckpts["one_layer"]), "--device", "cpu", *flags])
