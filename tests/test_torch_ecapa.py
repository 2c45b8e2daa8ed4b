"""ECAPA-TDNN language ID on the PyTorch port against the JAX package, on the
CPU at the fixture's narrow widths (``tests/fixtures.make_ecapa_fixture``:
16 channels, Res2Net scale 4, SE 8, embedding 8, classifier 12 -> 5
languages, 60 mels), with ``models.lid.load_model``, ``cli/lid.py`` and the
server's ``lid`` task.

The fixture's periodic weights give nearly the same probabilities for any
audio, so the comparisons run on copies of its layout with seeded normal
weights (``_write``); both packages load the same checkpoint, and the port
also takes the JAX package's params through ``convert.from_jax_params``.
Tolerances, f32: the dB mel 1e-4 absolute (f32 FFTs in another order);
probabilities 1e-5, solo and batched (each against the JAX package's own
route), with the top-k languages equal; a padded batched row against its
solo ``predict``: the JAX test's allowance (the same languages in the same
order, confidence within 0.05: the SE means and the convolutions' edges see
the padding), and 1e-4 where the clip fills its bucket.
"""

import contextlib
import io
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import lid as jcli
from tpu_audio.cli import serve as jserve
from tpu_audio.core import dsp as jdsp
from tpu_audio.core import loading as jloading
from tpu_audio.models.lid import ecapa_lid as JE
from tpu_audio.models.lid import load_model as jload_model
from tpu_audio_torch.cli import lid as tcli
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core.audio_io import load_audio
from tpu_audio_torch.models.lid import ecapa_lid as TE
from tpu_audio_torch.models.lid import load_model as tload_model

from fixtures import make_ecapa_fixture
from test_torch_ops import jax_tree_to_numpy
from test_torch_vad import _wav_bytes

torch.set_num_threads(1)

ATOL = 1e-5
MEL_ATOL = 1e-4
SOLO_CONFIDENCE = 0.05  # tests/test_ecapa.py's batched-against-solo allowance
FILLED_ATOL = 1e-4  # tests/test_ecapa.py: a clip that fills its bucket
MEDIA = "tests/media"


def _audio(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _speech(name="speech_16k.wav"):
    return load_audio(f"{MEDIA}/{name}", sample_rate=16000)[0]


def _write(path, seed):
    """The fixture's layout with seeded normal weights: N(0, 1/fan_in)
    weights (block 0's / 10, its input being tens of dB; the embedding's and
    the output layer's x 4, so that the languages' probabilities part and
    move with the audio), N(0, 0.05) biases, BatchNorm weights 1 + N(0, 0.1), running means N(0, 0.1) and
    variances 1 + |N(0, 0.2)|."""
    from safetensors.numpy import save_file

    path = make_ecapa_fixture(path)
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(jloading.load_safetensors(path).items()):
        if name.endswith("running_var"):
            a = 1.0 + np.abs(0.2 * rng.standard_normal(v.shape))
        elif name.endswith("running_mean"):
            a = 0.1 * rng.standard_normal(v.shape)
        elif ".norm" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif name.endswith("bias"):
            a = 0.05 * rng.standard_normal(v.shape)
        else:
            a = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[1:]))
            if "blocks.0.conv" in name:
                a = a / 10.0
            elif name.startswith(("embedding_model.fc.", "classifier.out.")):
                a = a * 4.0
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("ecapa") / "e", 3)


@pytest.fixture(scope="module")
def models(ckpt):
    return JE.EcapaLID.from_pretrained(str(ckpt)), TE.EcapaLID.from_pretrained(
        str(ckpt), device="cpu")


def _clips():
    """Seeded noise of 1 s (fills its bucket), 0.56 s of sine and 1.6 s of
    noise (tests/test_ecapa.py's batch), 3 s of speech, 2.5 s of the
    two-speaker clip."""
    return [_audio(0, 16000), np.sin(np.arange(9000) * 0.02).astype(np.float32) * 0.3,
            _audio(1, 26000, 0.2), _speech()[:48000], _speech("two_speaker_16k.wav")[:40000]]


@pytest.mark.parametrize("top_db", [None, 80.0, 10.0])
def test_power_to_db_matches_jax(top_db):
    x = np.abs(np.random.default_rng(0).standard_normal((50, 60))).astype(np.float32) ** 4
    x[3, :5] = 0.0
    got = tdsp.power_to_db(torch.from_numpy(x), top_db=top_db).numpy()
    want = np.asarray(jdsp.power_to_db(jnp.asarray(x), top_db=top_db))
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("n", [16000, 9000 + 13, 400, 100])
def test_ecapa_mel_matches_jax(n):
    a = _audio(n, n)
    got, want = TE.ecapa_mel(a).numpy(), np.asarray(JE.ecapa_mel(a))
    assert got.shape == want.shape == (1, 1 + n // 160, 60)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("i", range(5))
def test_predict_matches_jax(models, i):
    jm, tm = models
    a = _clips()[i]
    got = tm.predict_device(a)
    assert got.device.type == "cpu" and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.predict_device(a)), atol=ATOL, rtol=0)
    g, w = tm.predict(a, top_k=3), jm.predict(a, top_k=3)
    assert [p.language for p in g.top_languages] == [p.language for p in w.top_languages]
    assert g.language == w.language and g.language.startswith("lang")


def test_predictions_move_with_the_audio(models):
    _, tm = models
    probs = np.stack([tm.predict_device(a).numpy() for a in _clips()])
    assert probs.max() < 0.99 and np.ptp(probs, axis=0).max() > 0.05, probs
    assert tm.id2label[0] == "lang0"


def test_predict_batch_matches_jax_predict_batch(models):
    """Every row of the port's ``predict_batch`` against the JAX package's
    ``predict_batch`` on the same clips (three rows in the 2 s bucket, one
    each in the 1 s and 4 s buckets, one past 30 s through ``predict``)."""
    jm, tm = models
    clips = _clips() + [_audio(9, 16000 * 31)]
    got, want = tm.predict_batch(clips, top_k=5), jm.predict_batch(clips, top_k=5)
    for g, w in zip(got, want):
        assert [p.language for p in g.top_languages] == [p.language for p in w.top_languages]
        np.testing.assert_allclose([p.confidence for p in g.top_languages],
                                   [p.confidence for p in w.top_languages], atol=ATOL, rtol=0)


def test_predict_bucket_matches_jax_rows(models):
    """The masked batched graph itself, on padded rows of one bucket."""
    jm, tm = models
    audio = np.zeros((4, 32000), np.float32)
    n_frames = np.ones(4, np.int32)
    for row, c in enumerate(_clips()[1:4]):
        c = c[:32000]
        audio[row, : len(c)] = c
        n_frames[row] = 1 + len(c) // 160
    got = tm._predict_bucket(torch.from_numpy(audio), torch.from_numpy(n_frames)).numpy()
    want = np.asarray(jm._predict_batch_jit(jm.params, jnp.asarray(audio),
                                            jnp.asarray(n_frames)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_predict_batch_against_solo(models):
    """A padded row against its own ``predict`` (tests/test_ecapa.py's
    allowance); a clip filling its bucket within 1e-4."""
    _, tm = models
    clips = _clips()
    solo = [tm.predict(c, top_k=4) for c in clips]
    for s, b in zip(solo, tm.predict_batch(clips, top_k=4)):
        assert b.language == s.language
        assert abs(b.confidence - s.confidence) < SOLO_CONFIDENCE
        assert [p.language for p in b.top_languages] == [p.language for p in s.top_languages]
    filled = tm._predict_bucket(torch.from_numpy(clips[0][None]),
                                torch.tensor([1 + 16000 // 160]))[0]
    np.testing.assert_allclose(filled.numpy(), tm.predict_device(clips[0]).numpy(),
                               atol=FILLED_ATOL, rtol=0)


@pytest.mark.parametrize("global_context,reflect", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("masked", [False, True])
def test_backbone_variants_match_jax(global_context, reflect, masked):
    """The global-context statistics (masked and not) and reflect padding
    (IndexTTS's speaker encoder), on ``init_random_params``' tree given to
    the JAX backbone as NumPy."""
    cfg = TE.EcapaConfig(channels=16, embed_dim=8, res2net_scale=4, se_channels=8,
                         attention_channels=8, global_context=global_context,
                         reflect_padding=reflect, num_classes=5, classifier_hidden_dim=12)
    jcfg = JE.EcapaConfig(**{k: getattr(cfg, k) for k in vars(cfg)})
    p = TE.init_random_params(cfg, seed=2)["embedding_model"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 57, 60)).astype(np.float32) * 3
    mask = np.arange(57)[None] < np.array([[57], [40], [12]]) if masked else None
    got = TE.ecapa_backbone_forward(p, torch.from_numpy(x), cfg,
                                    None if mask is None else torch.from_numpy(mask)).numpy()
    want = np.asarray(JE.ecapa_backbone_forward(
        _jax_tree(p), jnp.asarray(x), jcfg, None if mask is None else jnp.asarray(mask)))
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()), rtol=0)


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


def test_converted_params_give_the_same_probabilities(models):
    jm, tm = models
    conv = TE.EcapaLID(tm.config, from_jax_params(jax_tree_to_numpy(jm.params)))
    a = _clips()[3]
    torch.testing.assert_close(conv.predict_device(a), tm.predict_device(a), atol=1e-7, rtol=0)


def test_random_params_match_the_checkpoint_layout(models):
    _, tm = models

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {prefix + k: tuple(v.shape)})
        return out

    assert shapes(TE.init_random_params(tm.config, seed=0)) == shapes(tm.params)
    probs = TE.EcapaLID(tm.config, TE.init_random_params(tm.config, seed=0)).predict_device(
        _clips()[3])
    assert torch.isfinite(probs).all() and 0.0 < float(probs.max()) < 0.999


def test_sanitize_matches_jax():
    """SpeechBrain names and the MLX conv layout, against the JAX sanitizer."""
    rng = np.random.default_rng(0)
    w = {"embedding_model.blocks.0.conv.conv.weight": rng.standard_normal((16, 5, 60)),
         "embedding_model.blocks.1.se_block.conv1.conv.weight": rng.standard_normal((8, 1, 16)),
         "embedding_model.blocks.1.norm.norm.num_batches_tracked": np.zeros(1),
         "embedding_model.asp_bn.norm.running_mean": rng.standard_normal(96),
         "embedding_model.fc.conv.weight": rng.standard_normal((8, 96, 1))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    got = TE.sanitize({k: torch.from_numpy(v) for k, v in w.items()})
    want = JE.sanitize(w)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_load_model_and_refusals(ckpt, tmp_path):
    m = tload_model(str(ckpt), device="cpu")
    assert isinstance(m, TE.EcapaLID) and m.device.type == "cpu"
    assert isinstance(jload_model(str(ckpt)), JE.EcapaLID)
    # MMS-LID is ported: its names reach Wav2Vec2LID, which needs weights
    for model_type in ("wav2vec2", "mms-lid"):
        d = tmp_path / model_type
        d.mkdir()
        (d / "config.json").write_text(json.dumps({"model_type": model_type}))
        with pytest.raises(FileNotFoundError, match="safetensors"):
            tload_model(str(d), device="cpu")
    d = tmp_path / "other"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "xvector"}))
    with pytest.raises(ValueError, match="ported: .*ecapa"):
        tload_model(str(d), device="cpu")


def test_cli_lid_matches_jax(ckpt, tmp_path):
    """``cli/lid.py`` prints the JAX CLI's lines on the same WAV."""
    wav = tmp_path / "in.wav"
    wav.write_bytes(_wav_bytes(_speech()[:48000]))
    outs = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(wav), "--model", str(ckpt), "--top-k", "3", *extra]) == 0
        outs.append(buf.getvalue().splitlines())
    assert outs[0] == outs[1] and len(outs[0]) == 4 and outs[0][0].startswith("language: lang")


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=60)


def _post_lid(srv, body: bytes, top_k=None) -> dict:
    q = "" if top_k is None else f"?top_k={top_k}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/lid{q}", data=body)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _same_answer(got: dict, want: dict, atol: float) -> None:
    assert got["language"] == want["language"]
    assert [p["language"] for p in got["top"]] == [p["language"] for p in want["top"]]
    np.testing.assert_allclose([got["confidence"]] + [p["confidence"] for p in got["top"]],
                               [want["confidence"]] + [p["confidence"] for p in want["top"]],
                               atol=atol, rtol=0)


@pytest.mark.parametrize("top_k", [None, 2])
def test_server_lid_matches_jax_route(models, top_k):
    """One request through each server's micro-batcher: the JAX route's
    JSON (confidences rounded to 6 places, within 1e-5)."""
    jm, tm = models
    body = _wav_bytes(_speech()[:48000])
    answers = []
    for mod, m in ((tserve, tm), (jserve, jm)):
        srv = mod.build_server(m, "lid", "ecapa", port=0)
        thread = _serve(srv)
        try:
            answers.append(_post_lid(srv, body, top_k))
        finally:
            _stop(srv, thread)
    _same_answer(*answers, atol=ATOL)
    assert len(answers[0]["top"]) == (top_k or 5) and set(answers[0]) == {
        "language", "confidence", "top"}


def test_server_lid_concurrent_requests_batch(models):
    """Six concurrent requests: the batcher groups them (fewer
    ``predict_batch`` calls than requests), and each answer equals the
    clip's ``predict_batch`` row alone (its bucket's masked route) and, by
    the JAX allowance, its solo ``predict``; a clip that fills its bucket
    within 1e-4 of ``predict``."""
    _, tm = models
    clips = [c for c in _clips() if len(c) <= 32000] + [_audio(7, 16000), _audio(8, 30000)]
    bodies = [_wav_bytes(c) for c in clips]
    # the clips as the server reads them back (PCM16)
    heard = [tserve._load_wav_body(b, 16000)[0] for b in bodies]
    calls = []
    real = tm.predict_batch

    def counting(waveforms, top_k=5):
        calls.append(len(waveforms))
        return real(waveforms, top_k=top_k)

    tm.predict_batch = counting
    srv = tserve.build_server(tm, "lid", "ecapa", port=0)
    thread = _serve(srv)
    got = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def post(i):
        start.wait()
        got[i] = _post_lid(srv, bodies[i], top_k=3)

    try:
        workers = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        _stop(srv, thread)
        del tm.predict_batch
    assert sum(calls) == len(bodies) and len(calls) < len(bodies), calls
    for g, a in zip(got, heard):
        alone = real([a], top_k=3)[0]
        _same_answer(g, {"language": alone.language, "confidence": alone.confidence,
                         "top": [{"language": p.language, "confidence": p.confidence}
                                 for p in alone.top_languages]}, atol=ATOL)
        solo = tm.predict(a, top_k=3)
        assert [p["language"] for p in g["top"]] == [p.language for p in solo.top_languages]
        tol = FILLED_ATOL if len(a) in TE.EcapaLID._LEN_BUCKETS else SOLO_CONFIDENCE
        assert abs(g["confidence"] - solo.confidence) < tol


def test_lid_batcher_unblocks_every_waiter_on_error(models):
    _, tm = models

    class Broken:
        def predict_batch(self, waveforms, top_k=5):
            raise RuntimeError("device lost")

    b = tserve._LIDBatcher(Broken())
    errs = []

    def ask():
        try:
            b.predict(np.zeros(1600, np.float32), 3)
        except RuntimeError as e:
            errs.append(str(e))

    workers = [threading.Thread(target=ask) for _ in range(3)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    b.close()
    assert errs == ["device lost"] * 3 and not b._thread.is_alive()


def test_serve_detects_the_lid_task(ckpt):
    assert tserve.detect_task(str(ckpt)) == "lid"
    assert "lid" in tserve.TASKS
