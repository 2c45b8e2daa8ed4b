"""wav2vec2 CTC and MMS-LID on the PyTorch port against the JAX package, on
the CPU, on checkpoints in the Hugging Face layout at the JAX tests' tiny
widths, written with numpy (importing ``transformers`` takes longer than
this whole file): a group-norm post-LN CTC model, a stable-LN layer-norm
CTC model with MMS adapter layers, a group-norm LID model. Checked:
``sanitize`` with both weight-norm spellings, CTC and LID logits, text,
top-k, MMS vocabularies and ``load_adapter``, ``load_model`` for both
tasks, ``cli/lid.py``, the LID server's locked route (a model with
``predict_batch`` keeps its batcher) and the transcription route,
``convert.from_jax_params`` and random params."""

import contextlib
import io
import json
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.cli import lid as jlid_cli
from tpu_audio.cli import serve as jserve
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.lid import wav2vec2_lid as JL
from tpu_audio.models.stt import wav2vec2 as JW
from tpu_audio_torch.cli import lid as tlid_cli
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import loading as tloading
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.lid import load_model as tload_lid
from tpu_audio_torch.models.lid import wav2vec2_lid as TL
from tpu_audio_torch.models.stt import load_model as tload_stt
from tpu_audio_torch.models.stt import wav2vec2 as TW

from test_torch_cohere import _post, _wav
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

REL = 1e-5  # f32 logits, relative to the JAX package's max
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "a": 5, "b": 6, "c": 7,
         "d": 8, "e": 9, "f": 10, "g": 11}


CFG = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           conv_dim=[16, 16, 16], conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2],
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, vocab_size=12,
           pad_token_id=0, do_stable_layer_norm=False, feat_extract_norm="group")


def _hf_checkpoint(dst, seed, num_labels=None, adapter_dim=None, **kw):
    """A Hugging Face layout wav2vec2 checkpoint of the JAX tests' tiny
    widths (``CFG``, updated by ``kw``) written with numpy: every weight
    N(0, 1/fan-in), biases N(0, 0.02), norm weights 1 + N(0, 0.1) (the
    port's ``init_random_params``), the positional conv as its weight-norm
    parametrization (``original0`` g ``[1, 1, K]``, ``original1`` v), MMS
    adapter layers of ``adapter_dim`` after every layer, or a LID head of
    ``num_labels``. Returns the directory and its flat weights."""
    from safetensors.numpy import save_file

    conf = {**CFG, **kw, "model_type": "wav2vec2", "adapter_attn_dim": adapter_dim}
    if num_labels:
        conf.update(num_labels=num_labels, classifier_proj_size=16,
                    id2label={str(i): f"lang{i}" for i in range(num_labels)})
    cfg = TW.Wav2Vec2Config.from_dict(conf)
    w = {k: v.numpy() for k, v in tloading.flatten(
        TW.init_random_params(cfg, seed=seed, num_labels=num_labels)).items()}
    if num_labels:
        w.pop("lm_head.weight"), w.pop("lm_head.bias")
    rng = np.random.default_rng(seed)
    pos = "wav2vec2.encoder.pos_conv_embed.conv."
    v = w.pop(pos + "weight")
    w[pos + "parametrizations.weight.original1"] = v
    w[pos + "parametrizations.weight.original0"] = (
        np.sqrt((v.astype(np.float64) ** 2).sum((0, 1), keepdims=True))
        * (1 + 0.1 * rng.standard_normal((1, 1, v.shape[2])))).astype(np.float32)
    d = cfg.hidden_size
    for i in range(cfg.num_hidden_layers if adapter_dim else 0):
        a = f"wav2vec2.encoder.layers.{i}.adapter_layer."
        w.update({a + "norm.weight": 1 + 0.1 * rng.standard_normal(d),
                  a + "norm.bias": 0.02 * rng.standard_normal(d),
                  a + "linear_1.weight": rng.standard_normal((adapter_dim, d)) * d ** -0.5,
                  a + "linear_1.bias": 0.02 * rng.standard_normal(adapter_dim),
                  a + "linear_2.weight": rng.standard_normal((d, adapter_dim)) * 0.5,
                  a + "linear_2.bias": 0.02 * rng.standard_normal(d)})
    w = {k: np.asarray(x, np.float32) for k, x in w.items()}
    dst.mkdir()
    save_file(w, str(dst / "model.safetensors"))
    (dst / "config.json").write_text(json.dumps(conf))
    return dst, w


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``ctc``: a group-norm post-LN CTC checkpoint; ``mms``: a stable-LN
    layer-norm CTC checkpoint with adapter layers, an MMS-nested
    vocabulary and an ``adapter.fra.safetensors``; ``lid``: a group-norm
    LID checkpoint with six labels."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("w2v")
    ctc, _ = _hf_checkpoint(root / "ctc", 1)
    (ctc / "vocab.json").write_text(json.dumps(VOCAB))
    mms, w = _hf_checkpoint(root / "mms", 2, adapter_dim=8, do_stable_layer_norm=True,
                            feat_extract_norm="layer")
    (mms / "vocab.json").write_text(json.dumps({
        "eng": VOCAB, "fra": {k: (v if v < 5 else 16 - v) for k, v in VOCAB.items()}}))
    rng = np.random.default_rng(3)
    save_file({k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
               for k, v in w.items() if "adapter_layer" in k or "lm_head" in k},
              str(mms / "adapter.fra.safetensors"))
    lid, _ = _hf_checkpoint(root / "lid", 4, num_labels=6)
    return {"ctc": ctc, "mms": mms, "lid": lid}


_CACHE = {}


def _models(dirs, name):
    if name not in _CACHE:
        if name == "lid":
            _CACHE[name] = (JL.Wav2Vec2LID.from_pretrained(str(dirs[name])),
                            tload_lid(str(dirs[name]), device="cpu"))
        else:
            _CACHE[name] = (JW.Wav2Vec2CTC.from_pretrained(str(dirs[name])),
                            tload_stt(str(dirs[name]), device="cpu"))
    return _CACHE[name]


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.2).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_ctc_logits(jm, x):
    x = np.asarray(x, np.float32)[None]
    x = (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-7)
    return np.asarray(jm._forward(jm.params, jnp.asarray(x)))


def test_sanitize_matches_jax_with_both_weight_norm_spellings(dirs):
    """The checkpoint's keys (``parametrizations`` names, or ``weight_g`` /
    ``weight_v``, or ``masked_spec_embed`` and keys outside the kept
    prefixes): the same keys and values as the JAX package's, the norm
    folded in float64."""
    from safetensors.numpy import load_file

    w = dict(load_file(str(dirs["mms"] / "model.safetensors")))
    w["wav2vec2.masked_spec_embed"] = np.ones(32, np.float32)
    w["quantizer.codevectors"] = np.ones((2, 2), np.float32)
    renamed = {k.replace("parametrizations.weight.original0", "weight_g")
               .replace("parametrizations.weight.original1", "weight_v"): v for k, v in w.items()}
    assert renamed.keys() != w.keys()
    for weights in (w, renamed):
        want = JW.sanitize(dict(weights))
        got = TW.sanitize({k: torch.from_numpy(v.copy()) for k, v in weights.items()})
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), want[k]), k
        assert "wav2vec2.encoder.pos_conv_embed.conv.weight" in got
        assert not any("masked_spec_embed" in k or k.startswith("quantizer") for k in got)


@pytest.mark.parametrize("name", ["ctc", "mms"])
def test_ctc_logits_text_and_stream_match_jax(dirs, name):
    """CTC logits within 1e-5 of the JAX package's; ``generate``'s text,
    counts and segment, and ``generate_stream``'s events, equal."""
    jm, tm = _models(dirs, name)
    x = _audio(1, 8000)
    got, want = tm.logits(x).numpy(), _jax_ctc_logits(jm, x)
    assert got.shape == want.shape and _rel(got, want) < REL
    for lang in (None, "eng"):
        jo, to = jm.generate(x, JParams(language=lang)), tm.generate(x, TParams(language=lang))
        assert (to.text, to.generation_token_count, to.language) == \
            (jo.text, jo.generation_token_count, jo.language)
        assert [s.__dict__ for s in to.segments] == [s.__dict__ for s in jo.segments]
    assert to.generation_token_count > 0
    jev, tev = list(jm.generate_stream(x)), list(tm.generate_stream(x))
    assert [e["type"] for e in tev] == [e["type"] for e in jev]
    assert tev[-1]["output"].text == jev[-1]["output"].text


def test_mms_vocabularies_and_adapter_match_jax(dirs):
    """The nested vocabulary by language, then ``load_adapter("fra")`` (the
    adapter layers and head replaced): the same logits and French text as
    the JAX package's; a language without a file returns False."""
    jm, tm = JW.Wav2Vec2CTC.from_pretrained(str(dirs["mms"])), tload_stt(str(dirs["mms"]),
                                                                         device="cpu")
    assert tm.vocabularies.keys() == jm.vocabularies.keys() == {"eng", "fra"}
    assert tm._vocab_for("FRA") == jm._vocab_for("FRA") and tm._vocab_for("x") == jm.vocab
    x = _audio(2, 8000)
    before = tm.logits(x)
    assert tm.load_adapter("fra") is jm.load_adapter("fra") is True
    assert tm.load_adapter("deu") is jm.load_adapter("deu") is False
    got, want = tm.logits(x).numpy(), _jax_ctc_logits(jm, x)
    assert _rel(got, want) < REL and _rel(got, before.numpy()) > 1e-2
    jo, to = jm.generate(x, JParams(language="fra")), tm.generate(x, TParams(language="fra"))
    assert to.text == jo.text and to.generation_token_count == jo.generation_token_count > 0


def test_lid_logits_and_top_k_match_jax(dirs):
    """LID logits within 1e-5 of the JAX package's; ``predict``'s top-k
    (labels and probabilities) equal, at k = 1, 3 and past the labels."""
    jm, tm = _models(dirs, "lid")
    assert isinstance(tm, TL.Wav2Vec2LID) and tm.id2label == jm.id2label
    x = _audio(3, 6000)
    xn = (x - x.mean()) / (x.std() + 1e-7)
    want = np.asarray(jm._forward(jm.params, jnp.asarray(xn[None])))
    assert _rel(tm.logits(x).numpy(), want) < REL
    for k in (1, 3, 9):
        got, exp = tm.predict(x, top_k=k), jm.predict(x, top_k=k)
        assert [p.language for p in got.top_languages] == [p.language for p in exp.top_languages]
        np.testing.assert_allclose([p.confidence for p in got.top_languages],
                                   [p.confidence for p in exp.top_languages], atol=1e-6)
        assert got.language == exp.language and len(got.top_languages) == min(k, 6)


def test_load_model_names_and_lid_cli(dirs, tmp_path):
    """``models.lid.load_model`` takes ``wav2vec2`` and ``mms-lid``, the STT
    factory ``wav2vec2``; ``cli/lid.py`` prints the JAX CLI's lines."""
    d = shutil.copytree(dirs["lid"], tmp_path / "mms-lid-126")
    conf = json.loads((d / "config.json").read_text())
    conf["model_type"] = "mms-lid"
    (d / "config.json").write_text(json.dumps(conf))
    assert isinstance(tload_lid(str(d), device="cpu"), TL.Wav2Vec2LID)
    assert isinstance(tload_stt(str(dirs["ctc"]), device="cpu"), TW.Wav2Vec2CTC)
    with pytest.raises(ValueError, match="quantize"):
        TW.Wav2Vec2CTC.from_pretrained(str(dirs["ctc"]), device="cpu", quantize="w8a8")
    wav = tmp_path / "in.wav"
    wav.write_bytes(_wav(_audio(4, 6000)))
    outs = []
    for main, extra in ((tlid_cli.main, ["--device", "cpu"]), (jlid_cli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(wav), "--model", str(dirs["lid"]), "--top-k", "3", *extra]) == 0
        outs.append(buf.getvalue().splitlines())
    assert outs[0] == outs[1] and len(outs[0]) == 4 and outs[0][0].startswith("language: lang")


@pytest.mark.parametrize("name", ["ctc", "lid"])
def test_from_jax_params_carries_the_tree(dirs, name):
    jm, tm = _models(dirs, name)
    conv = from_jax_params(jax_tree_to_numpy(jm.params))
    flat_c, flat_t = tloading.flatten(conv), tloading.flatten(tm.params)
    assert flat_c.keys() == flat_t.keys()
    assert all(torch.equal(flat_c[k], flat_t[k]) for k in flat_t)


def test_init_random_params_has_the_loaded_layout(dirs):
    for name in ("ctc", "mms", "lid"):
        _, tm = _models(dirs, name)
        n = len(tm.id2label) if name == "lid" else None
        p = TW.init_random_params(tm.config, num_labels=n)
        if name == "lid":
            p.pop("lm_head")
        got = {k: tuple(v.shape) for k, v in tloading.flatten(p).items()}
        want = {k: tuple(v.shape) for k, v in tloading.flatten(tm.params).items()
                if "adapter_layer" not in k}
        assert got == want, name


def _serve(mod, model, task):
    srv = mod.build_server(model, task, "w2v", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_servers_answer_lid_and_ctc_as_jax(dirs):
    """``serve --task lid`` on MMS-LID builds no batcher and answers through
    ``predict`` under the lock, as the JAX server; a model with
    ``predict_batch`` still gets the batcher. ``--task stt`` on the CTC
    model answers ``/v1/audio/transcriptions`` as the JAX server."""
    out = {}
    for task, name, path, n in (("lid", "lid", "/v1/audio/lid?top_k=3", 6000),
                                ("stt", "ctc", "/v1/audio/transcriptions", 8000)):
        jm, tm = _models(dirs, name)
        body = _wav(_audio(5, n))  # the lengths of the other tests: no new JAX compile
        for key, mod, model in (("t", tserve, tm), ("j", jserve, jm)):
            srv = _serve(mod, model, task)
            try:
                if task == "lid" and key == "t":
                    assert srv.lid_batcher is None
                out[task + key] = json.loads(_post(srv, path, body))
            finally:
                srv.shutdown()
                srv.server_close()
    assert out["lidt"] == out["lidj"] and len(out["lidt"]["top"]) == 3
    assert out["sttt"]["text"] == out["sttj"]["text"]
    assert out["sttt"]["segments"] == out["sttj"]["segments"]

    class Batched:
        def predict_batch(self, waveforms, top_k=5):
            return [TL.LIDOutput("x", 1.0, [TL.LanguagePrediction("x", 1.0)])] * len(waveforms)

    srv = _serve(tserve, Batched(), "lid")
    try:
        assert srv.lid_batcher is not None
        assert json.loads(_post(srv, "/v1/audio/lid", body))["language"] == "x"
    finally:
        srv.shutdown()
        srv.server_close()
