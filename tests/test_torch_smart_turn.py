"""SmartTurn on the PyTorch port against the JAX package, on the CPU at the
fixture's narrow widths (``tests/fixtures.make_smart_turn_fixture``: d 16, 2
heads, 2 layers, ffn 32, 8 mels, a 1 s window).

The fixture's periodic weights put every probability near 0.5, so the
comparisons run on copies of its layout with seeded normal weights
(``_write``); both packages load the same checkpoint, and the port also
takes the JAX package's params through ``convert.from_jax_params``. The
features go through ``core.dsp.log_mel_spectrogram``, whose projection and
log on the CPU are kernel 1's plain version (``ops.mel.fused_log_mel_ref``),
against the JAX package's Whisper log-mel. Tolerances, f32: prepared audio
equal; features 1e-4 absolute (kernel 1's tolerance: f32 sums in another
order); probabilities 1e-5; batched rows against each alone 1e-5 (the JAX
test's bound).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import loading as jloading
from tpu_audio.models.vad import load_model as jload_model
from tpu_audio.models.vad import smart_turn as JS
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.vad import load_model as tload_model
from tpu_audio_torch.models.vad import smart_turn as TS

from fixtures import make_smart_turn_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-5
MEL_ATOL = 1e-4


def _audio(seed, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _write(path, seed):
    """The fixture's layout with seeded normal weights: N(0, 1/fan_in)
    weights (the classifier's last layer x 4, so that the probability moves
    with the audio), N(0, 0.05) biases, LayerNorm weights 1 + N(0, 0.1),
    positions N(0, 0.1); the ``val_*`` entry stays."""
    from safetensors.numpy import save_file

    path = make_smart_turn_fixture(path)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(jloading.load_safetensors(path).items()):
        if name.startswith("val_"):
            a = v
        elif "layer_norm" in name or name.startswith("classifier.1."):
            a = (1.0 if name.endswith("weight") else 0.0) + 0.1 * rng.standard_normal(v.shape)
        elif name.endswith("bias"):
            a = 0.05 * rng.standard_normal(v.shape)
        elif "embed_positions" in name:
            a = 0.1 * rng.standard_normal(v.shape)
        else:
            gain = 4.0 if name.startswith("classifier.6.") else 1.0
            a = gain * rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = _write(tmp_path_factory.mktemp("smart_turn") / "s", 3)
    return JS.SmartTurn.from_pretrained(str(path)), TS.SmartTurn.from_pretrained(
        str(path), device="cpu")


def _clips():
    """(audio, sample rate): the JAX test's 0.75 s clip, 1 s, 1.25 s (the
    window keeps its last second), a constant clip left-padded with zeros,
    0.5 s at 8 kHz and the start of the speech clip."""
    speech = load_audio("tests/media/speech_16k.wav", sample_rate=16000)[0]
    return [(_audio(1, 12000), None), (_audio(0, 16000), 16000), (_audio(2, 20000), None),
            (np.ones(4000, np.float32), None), (_audio(3, 4000), 8000),
            (speech[16000:40000], None)]


@pytest.mark.parametrize("i", range(6))
def test_prepare_audio_equal(models, i):
    jm, tm = models
    audio, sr = _clips()[i]
    got, want = tm.prepare_audio(audio, sr), jm.prepare_audio(audio, sr)
    assert got.shape == want.shape == (16000,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(6))
def test_features_match_jax(models, i):
    """The log-mel through kernel 1's plain version, clamped to ``max - 8``
    over the clip (a mostly zero clip takes its floor from the clamp),
    padded to the window's 100 frames."""
    jm, tm = models
    audio, sr = _clips()[i]
    got = tm.prepare_input_features(audio, sr)
    want = np.asarray(jm.prepare_input_features(audio, sr))
    assert got.shape == want.shape == (8, 100) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_ATOL, rtol=0)


def test_features_call_kernel_1_once(models, monkeypatch):
    """``prepare_input_features`` reaches ``ops.mel.fused_log_mel`` (kernel 1
    on a CUDA tensor) once a clip, with the STFT's 201 bins and the
    model's mels."""
    _, tm = models
    calls = []
    real = tdsp.fused_log_mel

    def counting(re, im, fb):
        calls.append((tuple(re.shape), tuple(fb.shape)))
        return real(re, im, fb)

    monkeypatch.setattr(tdsp, "fused_log_mel", counting)
    tm.predict_endpoint(_audio(5, 30000))
    assert calls == [((100, 201), (201, 8))]


@pytest.mark.parametrize("i", range(6))
def test_predict_endpoint_matches_jax(models, i):
    jm, tm = models
    audio, sr = _clips()[i]
    got, want = tm.predict_endpoint(audio, sr), jm.predict_endpoint(audio, sr)
    assert abs(got.probability - want.probability) <= ATOL
    assert got.prediction == int(got.probability > tm.config.threshold)


def test_probabilities_move_with_the_audio(models):
    _, tm = models
    probs = [tm.predict_endpoint(a, sr).probability for a, sr in _clips()]
    assert max(probs) - min(probs) > 0.05, probs
    out = tm.predict_endpoint(_clips()[0][0], threshold=1.0)
    assert out.prediction == 0


def test_batch_matches_single_and_jax(models):
    jm, tm = models
    f1 = tm.prepare_input_features(_audio(2, 9000))
    f2 = tm.prepare_input_features(_audio(3, 16000))
    batched = tm(torch.stack([f1, f2])).numpy()
    assert batched.shape == (2, 1)
    for i, f in enumerate((f1, f2)):
        np.testing.assert_allclose(batched[i], tm(f).numpy()[0], atol=ATOL, rtol=0)
    want = np.asarray(jm(np.stack([f1.numpy(), f2.numpy()])))
    np.testing.assert_allclose(batched, want, atol=ATOL, rtol=0)
    # numpy features, as the JAX package takes them
    np.testing.assert_allclose(tm(f1.numpy()).numpy(), batched[:1], atol=ATOL, rtol=0)


def test_forward_from_converted_params(models):
    jm, tm = models
    conv = from_jax_params(jax_tree_to_numpy(jm.params))
    x = np.random.default_rng(4).standard_normal((3, 8, 100)).astype(np.float32)
    got = TS.forward(conv, torch.from_numpy(x), tm.config).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.forward(jm.params, jnp.asarray(x), jm.config)),
                               atol=ATOL, rtol=0)


def test_sanitize_matches_jax():
    """MLX conv layouts, transposed linears, ``inner.`` and the dotted
    names, against the JAX sanitizer."""
    rng = np.random.default_rng(0)
    w = {"inner.encoder.conv1.weight": rng.standard_normal((16, 3, 8)),
         "encoder.conv2.weight": rng.standard_normal((16, 16, 3)),
         "encoder.layers.0.fc1.weight": rng.standard_normal((16, 32)),
         "encoder.layers.0.fc2.weight": rng.standard_normal((32, 16)),
         "pool_attention.0.weight": rng.standard_normal((16, 256)),
         "pool_attention.2.weight": rng.standard_normal((256, 1)),
         "classifier.6.bias": rng.standard_normal(1), "val_loss": rng.standard_normal(1)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    got = TS.sanitize({k: torch.from_numpy(v) for k, v in w.items()})
    want = JS.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_random_params_match_the_checkpoint_layout(models):
    _, tm = models

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    assert shapes(TS.init_random_params(tm.config, seed=0)) == shapes(tm.params)
    full = TS.SmartTurnConfig()
    assert (full.d_model, full.encoder_layers, full.encoder_attention_heads,
            full.encoder_ffn_dim, full.num_mel_bins, full.max_audio_seconds) == (
                384, 4, 6, 1536, 80, 8)
    p = TS.init_random_params(tm.config, seed=1)
    out = TS.SmartTurn(tm.config, p).predict_endpoint(_audio(0, 16000))
    assert 0.0 < out.probability < 1.0


@pytest.mark.parametrize("model_type", ["smart_turn", "smartturn"])
def test_load_model(tmp_path, model_type):
    path = _write(tmp_path / "s", 2)
    cfg = json.loads((path / "config.json").read_text())
    (path / "config.json").write_text(json.dumps({**cfg, "model_type": model_type}))
    m = tload_model(str(path), device="cpu")
    assert isinstance(m, TS.SmartTurn) and m.device.type == "cpu"
    assert "val_accuracy" not in m.params
    assert "bias" not in m.params["encoder"]["layers"]["0"]["self_attn"]["k_proj"]
    assert isinstance(jload_model(str(path)), JS.SmartTurn)


def test_config_from_dict_merges_encoder_and_processor():
    d = {"encoder_config": {"d_model": 32, "encoder_layers": 3},
         "processor_config": {"n_mels": 40, "max_audio_seconds": 4},
         "sample_rate": 8000, "threshold": 0.7}
    got, want = TS.SmartTurnConfig.from_dict(d), JS.SmartTurnConfig.from_dict(d)
    assert vars(got) == vars(want)
    assert (got.d_model, got.n_mels, got.sampling_rate, got.threshold) == (32, 40, 8000, 0.7)
