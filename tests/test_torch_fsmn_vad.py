"""FSMN VAD on the PyTorch port against the JAX package, on the CPU at the
fixture's narrow widths (``tests/fixtures.make_fsmn_vad_fixture``: 8 mels x
LFR 5, 4 FSMN layers of 24 -> 12 with 4 memory taps, 4 states, an ``am.mvn``
CMVN).

The fixture's periodic weights give scores that do not move with the audio,
so the comparisons run on copies of its layout with seeded normal weights
(``_write``); both packages load the same checkpoint, and the port also
takes the JAX package's params through ``convert.from_jax_params``.
Tolerances, f32: 5e-4 absolute on the log-fbank and the features against
the JAX package (f32 FFTs at int16 scale, powers ~1e9, in another order: on
seeded noise the JAX package's own log-fbank lies 1.6e-4 from a float64
NumPy reference, the port's 6.8e-5), and 1e-4 for the port against that
float64 reference; 1e-5 on the scores;
filterbank, LFR, CMVN and segments equal, offline and fed in blocks; the
server's FSMN ``/v1/audio/vad`` JSON equal to the JAX route's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import serve as jserve
from tpu_audio.core import loading as jloading
from tpu_audio.models.vad import fsmn_vad as JF
from tpu_audio.models.vad import load_model as jload_model
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.vad import fsmn_vad as TF
from tpu_audio_torch.models.vad import load_model as tload_model

from fixtures import make_fsmn_vad_fixture
from test_torch_ops import jax_tree_to_numpy
from test_torch_vad import _post_vad, _wav_bytes

torch.set_num_threads(1)

ATOL = 1e-5
FBANK_ATOL = 5e-4
F64_ATOL = 1e-4
MEDIA = "tests/media"


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _speech(name="speech_16k.wav"):
    return load_audio(f"{MEDIA}/{name}", sample_rate=16000)[0]


def _write(path, seed):
    """The fixture's layout (and its ``am.mvn``) with seeded normal weights:
    N(0, 1/fan_in), memory taps N(0, 1/4), biases N(0, 0.1); the silence
    state's output bias is lowered by 3, so that the seeded model calls the
    frames of real speech speech (silence posterior ~0.1-0.25) and a second
    of zeros silence (~0.42, above the 0.2 that speech needs)."""
    from safetensors.numpy import save_file

    path = make_fsmn_vad_fixture(path)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(jloading.load_safetensors(path).items()):
        if name.endswith("bias"):
            a = 0.1 * rng.standard_normal(v.shape)
        else:
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))
        out[name] = np.asarray(a, np.float32)
    out["encoder.out_linear2.bias"][0] -= 3.0
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("fsmn") / "f", 3)
    jm = JF.FSMNVAD.from_pretrained(str(path))
    return jm, TF.FSMNVAD.from_pretrained(str(path), device="cpu")


@pytest.mark.parametrize("n_mels,n_fft,sr,low", [(8, 512, 16000, 20.0), (80, 512, 16000, 20.0),
                                                 (40, 256, 8000, 64.0)])
def test_kaldi_mel_filterbank_equal(n_mels, n_fft, sr, low):
    np.testing.assert_array_equal(TF.kaldi_mel_filterbank(n_mels, n_fft, sr, low),
                                  JF.kaldi_mel_filterbank(n_mels, n_fft, sr, low))


@pytest.mark.parametrize("n,n_mels", [(16000, 80), (4000 + 37, 8), (400, 80)])
def test_kaldi_fbank_matches_jax(n, n_mels):
    """The symmetric Hamming window, DC removal, pre-emphasis, the 512-point
    rfft at int16 scale and the log floor, against the JAX frontend."""
    wf = _audio(n, n) * 32768.0
    got = TF._kaldi_fbank(torch.from_numpy(wf), 400, 160, n_mels, 16000).numpy()
    want = np.asarray(JF._kaldi_fbank(jnp.asarray(wf), 400, 160, n_mels, 16000))
    assert got.shape == want.shape == (1 + (n - 400) // 160, n_mels)
    np.testing.assert_allclose(got, want, atol=FBANK_ATOL, rtol=0)


def test_kaldi_fbank_matches_a_float64_reference():
    """The port's f32 log-fbank against the same steps in float64 NumPy."""
    wf = _audio(16000, 16000) * 32768.0
    x = wf.astype(np.float64)
    frames = x[np.arange(98)[:, None] * 160 + np.arange(400)]
    frames = frames - frames.mean(axis=1, keepdims=True)
    frames = np.concatenate([frames[:, :1], frames[:, 1:] - 0.97 * frames[:, :-1]], axis=1)
    power = np.abs(np.fft.rfft(frames * np.hamming(400), n=512, axis=1)) ** 2
    ref = np.log(np.maximum(power @ JF.kaldi_mel_filterbank(80, 512, 16000).astype(np.float64),
                            1e-8))
    got = TF._kaldi_fbank(torch.from_numpy(wf), 400, 160, 80, 16000).numpy()
    np.testing.assert_allclose(got, ref, atol=F64_ATOL, rtol=0)


def test_kaldi_fbank_log_floor_on_silence():
    got = TF._kaldi_fbank(torch.zeros(800), 400, 160, 8, 16000).numpy()
    np.testing.assert_array_equal(got, np.full((3, 8), np.log(np.float32(1e-8))))


@pytest.mark.parametrize("t,d,m,n", [(4, 3, 5, 1), (17, 8, 5, 1), (9, 2, 7, 3), (1, 4, 5, 1),
                                     (0, 4, 5, 1)])
def test_apply_lfr_matches_jax(t, d, m, n):
    feats = np.random.default_rng(t).standard_normal((t, d)).astype(np.float32)
    got = TF.apply_lfr(torch.from_numpy(feats), m, n).numpy()
    np.testing.assert_array_equal(got, JF.apply_lfr(feats, m, n))


def test_parse_kaldi_cmvn_matches_jax(tmp_path):
    text = (make_fsmn_vad_fixture(tmp_path / "f") / "am.mvn").read_text()
    for got, want in zip(TF.parse_kaldi_cmvn(text), JF.parse_kaldi_cmvn(text)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TF.parse_kaldi_cmvn("<Nnet> </Nnet>")


@pytest.mark.parametrize("n", [16000, 8000 + 77, 100])
def test_extract_features_match_jax(models, n):
    """Fbank, LFR and the ``am.mvn`` CMVN; shorter than a frame: empty."""
    jm, tm = models
    wf = _audio(n, n)
    got, want = tm.extract_features(wf), jm.extract_features(wf)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FBANK_ATOL, rtol=0)


def test_cmvn_json(tmp_path):
    """``cmvn.json`` (``shift``, ``scale``) takes the place of ``am.mvn``."""
    path = _write(tmp_path / "f", 4)
    shift, scale = JF.parse_kaldi_cmvn((path / "am.mvn").read_text())
    (path / "am.mvn").unlink()
    (path / "cmvn.json").write_text(json.dumps({"shift": shift.tolist(),
                                                "scale": (scale * 0.5).tolist()}))
    jm, tm = JF.FSMNVAD.from_pretrained(str(path)), TF.FSMNVAD.from_pretrained(
        str(path), device="cpu")
    np.testing.assert_array_equal(tm.cmvn[1], scale * 0.5)
    wf = _audio(5, 8000)
    np.testing.assert_allclose(tm.extract_features(wf), jm.extract_features(wf),
                               atol=FBANK_ATOL, rtol=0)


@pytest.mark.parametrize("n,sr", [(16000, 16000), (24000 + 5, 16000), (12000, 8000),
                                  (300, 16000)])
def test_scores_match_jax(models, n, sr):
    jm, tm = models
    wf = _audio(n + sr, n)
    got, want = tm.scores(wf, sr), jm.scores(wf, sr)
    assert got.shape == want.shape and got.shape[1] == 4
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if got.shape[0]:
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_encoder_forward_from_converted_params(models):
    """The JAX package's params through ``convert.from_jax_params`` give the
    encoder the checkpoint's port gives, on batched features."""
    jm, tm = models
    x = np.random.default_rng(0).standard_normal((2, 30, 40)).astype(np.float32)
    conv = from_jax_params(jax_tree_to_numpy(jm.params))
    got = TF.encoder_forward(conv, torch.from_numpy(x), tm.config.encoder).numpy()
    np.testing.assert_allclose(got, TF.encoder_forward(tm.params, torch.from_numpy(x),
                                                       tm.config.encoder).numpy(), atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(JF.encoder_forward(
        jm.params, jnp.asarray(x), jm.config.encoder)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["speech_16k.wav", "two_speaker_16k.wav"])
def test_detect_matches_jax_on_speech(models, name):
    """Segments on real speech (and with a second of silence between two
    clips), equal to the JAX package's; the seeded model finds several."""
    jm, tm = models
    audio = np.concatenate([_speech(name), np.zeros(16000, np.float32), _speech()])
    got, want = tm.detect(audio), jm.detect(audio)
    assert got == want and len(got) > 1


def test_detect_at_8k_matches_jax(models):
    jm, tm = models
    audio = _speech()[::2].copy()
    assert tm.detect(audio, 8000) == jm.detect(audio, 8000)


def _burst(seed):
    t = 300
    scores = np.zeros((t, 2), np.float32)
    scores[:, 0] = 0.99
    scores[100:200, 0] = 0.01
    scores[:, 1] = 1.0 - scores[:, 0]
    wf = np.zeros(t * 160 + 240, np.float32)
    wf[100 * 160:200 * 160] = np.random.default_rng(seed).standard_normal(100 * 160) * 0.5
    return scores, wf


@pytest.mark.parametrize("step", [None, 50, 37])
def test_postprocess_matches_jax(step):
    """The endpoint machine on a synthetic burst, offline (``None``) and fed
    in blocks with ``is_final`` on the last only, against the JAX machine."""
    scores, wf = _burst(4)
    t = scores.shape[0]
    outs = []
    for cls in (TF.FSMNVADPostprocess, JF.FSMNVADPostprocess):
        pp = cls(TF.FSMNVADConfig())
        if step is None:
            outs.append(pp.process(scores, wf, is_final=True))
            continue
        out = []
        for i in range(0, t, step):
            last = i + step >= t
            out += pp.process(scores[i:i + step],
                              wf[i * 160:(i + step) * 160 + (240 if last else 0)], is_final=last)
        outs.append(out)
    assert outs[0] == outs[1] and len(outs[0]) == 1


def test_streaming_blocks_match_offline():
    """Feeding scores in blocks (``is_final`` only on the last) yields the
    segments of one shot (tests/test_fsmn_vad.py's check, on the port)."""
    scores, wf = _burst(4)
    cfg = TF.FSMNVADConfig()
    offline = TF.FSMNVADPostprocess(cfg).process(scores, wf, is_final=True)
    pp, out, t, step = TF.FSMNVADPostprocess(cfg), [], scores.shape[0], 50
    for i in range(0, t, step):
        out += pp.process(scores[i:i + step],
                          wf[i * 160:(i + step) * 160 + (240 if i + step >= t else 0)],
                          is_final=i + step >= t)
    assert out == offline


def test_postprocess_all_silence_matches_jax():
    scores = np.tile(np.array([[0.99, 0.01]], np.float32), (100, 1))
    wf = np.zeros(100 * 160 + 240, np.float32)
    cfg = TF.FSMNVADConfig()
    assert (TF.FSMNVADPostprocess(cfg).process(scores, wf)
            == JF.FSMNVADPostprocess(cfg).process(scores, wf))


def test_model_scores_streamed_in_blocks_match_jax(models):
    """The seeded model's scores on real speech fed to both machines in
    blocks of 0.5 s: the same segments, and the port's equal to its
    offline ``detect``."""
    jm, tm = models
    audio = _speech("two_speaker_16k.wav")
    scores = tm.scores(audio)
    outs = []
    for cls in (TF.FSMNVADPostprocess, JF.FSMNVADPostprocess):
        pp, out, step = cls(tm.config), [], 50
        for i in range(0, scores.shape[0], step):
            last = i + step >= scores.shape[0]
            out += pp.process(scores[i:i + step],
                              audio[i * 160:(i + step) * 160] if not last else audio[i * 160:],
                              is_final=last)
        outs.append(out)
    assert outs[0] == outs[1] == tm.detect(audio)


def test_random_params_match_the_checkpoint_layout(models):
    _, tm = models

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    assert shapes(TF.init_random_params(tm.config.encoder, seed=0)) == shapes(tm.params)
    full = TF.FSMNVADConfig()
    p = TF.init_random_params(full.encoder, seed=0)
    s = TF.FSMNVAD(full, p).scores(_audio(0, 16000))
    assert s.shape == (100, 248) and np.isfinite(s).all()


def test_sanitize_mlx_depthwise_layout():
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4, 1)
    got = TF.sanitize({"encoder.fsmn.0.fsmn_block.conv_left.weight": w})
    assert list(got) == ["fsmn.0.fsmn_block.conv_left.weight"]
    torch.testing.assert_close(got["fsmn.0.fsmn_block.conv_left.weight"], w.permute(0, 2, 1))


@pytest.mark.parametrize("model_type", ["fsmn", "fsmn_vad"])
def test_load_model(tmp_path, model_type):
    path = _write(tmp_path / "f", 2)
    cfg = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**cfg, "model_type": model_type}))
    m = tload_model(str(path), device="cpu")
    assert isinstance(m, TF.FSMNVAD) and m.device.type == "cpu" and m.cmvn is not None
    assert isinstance(jload_model(str(path)), JF.FSMNVAD)


@pytest.mark.parametrize("slots", [1, 2])
def test_server_fsmn_vad_matches_jax_route(models, slots):
    """``POST /v1/audio/vad`` with an FSMN model: ``detect``'s ms spans as
    seconds, the JAX route's JSON."""
    jm, tm = models
    body = _wav_bytes(np.concatenate([_speech("two_speaker_16k.wav"), _speech()]))
    got = _post_vad(tserve.build_server(tm, "vad", "fsmn", port=0, slots=slots), body)
    want = _post_vad(jserve.build_server(jm, "vad", "fsmn", port=0, slots=slots), body)
    assert got == want and got["segments"] and set(got) == {"segments"}


def test_serve_detects_the_vad_task(tmp_path):
    assert tserve.detect_task(str(_write(tmp_path / "f", 1))) == "vad"
