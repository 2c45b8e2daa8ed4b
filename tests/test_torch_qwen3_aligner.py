"""The Qwen3 forced aligner on the PyTorch port against the JAX package, on
the CPU at small sizes: ``ForceAlignProcessor`` (word splitting with CJK,
the prompt, the timestamp repair on the JAX tests' cases and on random
lists), ``_classify``'s classes and ``generate``'s items on a dense and an
MLX 4-bit tree, the 64-row bucket, the refusals, ``load_model`` by name,
``cli/stt.py --text``, ``cli/tts.py --timestamps`` and the server, which
builds no serving engine for an aligner.

The fixture checkpoint (``make_qwen3_aligner_fixture``) has periodic
weights whose classes tie; the parity tests run on copies with seeded
normal weights (``test_torch_qwen3_asr._write`` and a seeded head), one at
the fixture's widths and one wider, MLX-packed at 4 bits in groups of 16.
"""

import io
import json
import shutil
import threading
import urllib.error
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_audio.cli import serve as jserve
from tpu_audio.models.stt import load_model as jload_model
from tpu_audio.models.stt import qwen3_aligner as JA
from tpu_audio_torch.cli import serve as tserve
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.models.stt import load_model as tload_model
from tpu_audio_torch.models.stt import qwen3_aligner as TA

from fixtures import make_qwen3_aligner_fixture
from test_torch_cohere import _cli_models
from test_torch_ops import jax_tree_to_numpy
from test_torch_qwen3_asr import _is_linear, _write
from test_torch_tts_q4 import _quantize_checkpoint

torch.set_num_threads(1)


def _write_aligner(dst, seed, wide=False):
    """``test_torch_qwen3_asr._write``'s seeded normal weights and a head
    ``[classify_num, hidden]`` N(0, 9/hidden), so that the classes follow
    the audio and the words."""
    from safetensors.numpy import load_file, save_file

    _write(dst, seed, wide=wide)
    conf = json.loads((dst / "config.json").read_text())
    h = conf["text_config"]["hidden_size"]
    w = dict(load_file(str(dst / "model.safetensors")))
    w["lm_head.weight"] = (3.0 * h ** -0.5 * np.random.default_rng(seed + 50).standard_normal(
        (conf["classify_num"], h))).astype(np.float32)
    save_file(w, str(dst / "model.safetensors"))
    return dst


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture as written; a seeded-normal copy; a wider seeded-normal
    copy MLX-packed at 4 bits in groups of 16 (the head too). Every
    directory's name carries the forced-aligner marker."""
    root = tmp_path_factory.mktemp("aligner")
    src = make_qwen3_aligner_fixture(root / "qwen3-forced-aligner")
    rand = _write_aligner(shutil.copytree(src, root / "rand-forced-aligner"), seed=3)
    wide = _write_aligner(shutil.copytree(src, root / "wide-forced-aligner"), seed=4, wide=True)
    q4 = _quantize_checkpoint(wide, root / "q4-forced-aligner", 4, 16, _is_linear)
    return {"fixture": src, "rand": rand, "q4": q4}


_CACHE = {}


def _models(path, dtype="f32"):
    key = (str(path), dtype)
    if key not in _CACHE:
        jd, td = {"f32": (jnp.float32, torch.float32),
                  "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
        _CACHE[key] = (jload_model(str(path), dtype=jd),
                       tload_model(str(path), dtype=td, device="cpu"))
    return _CACHE[key]


def _audio(seed, n):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _items(res):
    return [(i.text, i.start_time, i.end_time) for i in res.items]


# -- the text processor ----------------------------------------------------------------

TEXTS = ["Hello, world! it's 42.", "你好ab 世c!", "mixed 中文 and latin", "  spaces   here ",
         "", "Ünïcødé ½ naïve", "a-b c'd e_f", "東京タワー tokyo"]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("language", ["English", "Chinese"])
def test_processor_matches_jax(text, language):
    """Word splitting (space languages with CJK split out, CJK-mixed), the
    prompt and ``parse_timestamp`` equal the JAX package's."""
    t, j = TA.ForceAlignProcessor(), JA.ForceAlignProcessor()
    assert t.tokenize_space_lang(text) == j.tokenize_space_lang(text)
    assert t.tokenize_chinese_mixed(text) == j.tokenize_chinese_mixed(text)
    words, prompt = t.encode_timestamp(text, language)
    assert (words, prompt) == j.encode_timestamp(text, language)
    stamps = [80.0 * k for k in np.random.default_rng(len(text)).integers(0, 9, 2 * len(words))]
    got, want = t.parse_timestamp(words, stamps), j.parse_timestamp(words, stamps)
    assert [(i.text, i.start_time, i.end_time) for i in got] == \
        [(i.text, i.start_time, i.end_time) for i in want]


def test_processor_jax_cases():
    """The JAX tests' cases on the port."""
    p = TA.ForceAlignProcessor()
    assert p.tokenize_space_lang("Hello, world! it's 42.") == ["Hello", "world", "it's", "42"]
    assert p.tokenize_chinese_mixed("你好ab 世c!") == ["你", "好", "ab", "世", "c"]
    assert p.encode_timestamp("a b", "English") == (
        ["a", "b"], "<|audio_start|><|audio_pad|><|audio_end|>"
                    "a<timestamp><timestamp>b<timestamp><timestamp>")
    assert p.fix_timestamp([0.0, 80.0, 160.0, 160.0]) == [0, 80, 160, 160]
    assert p.fix_timestamp([0.0, 80.0, 40.0, 160.0]) == [0, 80, 80, 160]
    out = p.fix_timestamp([0.0, 400.0, 300.0, 200.0, 800.0])
    assert out[0] == 0 and out[-1] == 800 and out == sorted(out)
    res = TA.ForcedAlignResult(items=[TA.ForcedAlignItem("a", 0.0, 0.1),
                                      TA.ForcedAlignItem("b", 0.1, 0.2)])
    assert res.text == "a b"


@settings(max_examples=150, deadline=None)
@given(st.lists(st.floats(min_value=0, max_value=4000, allow_nan=False), max_size=24))
def test_fix_timestamp_matches_jax(data):
    got = TA.ForceAlignProcessor().fix_timestamp(data)
    assert got == JA.ForceAlignProcessor().fix_timestamp(data)
    assert got == sorted(got)


# -- classification ----------------------------------------------------------------------


@pytest.mark.parametrize("ckpt", ["rand", "q4"])
def test_classify_and_generate_match_jax(dirs, ckpt):
    """``_classify``'s classes on random embeddings (f32) equal the JAX
    package's, also on a prompt longer than the 64-row bucket; ``generate``'s
    items and prompt length equal, and are non-decreasing."""
    jm, tm = _models(dirs[ckpt])
    h = tm.config.text.hidden_size
    emb = np.random.default_rng(1).standard_normal((1, 70, h)).astype(np.float32) * 0.1
    for rows in (10, 70):
        got = TA._classify(tm.params, torch.from_numpy(emb[:, :rows]), tm.config.text)
        want = np.asarray(jm._classify(jm.params, jnp.asarray(emb[:, :rows])))
        assert np.array_equal(got.numpy(), want)
    for seed, n, text in ((0, 16000, "w1 w2 w3 hello w5"), (2, 6000, "你好 w4"))[
            :2 if ckpt == "rand" else 1]:
        x = _audio(seed, n)
        want, got = jm.generate(x, text=text), tm.generate(x, text=text)
        assert _items(got) == _items(want) and got.prompt_tokens == want.prompt_tokens
        seq = [t for _, s, e in _items(got) for t in (s, e)]
        assert seq == sorted(seq) and len(got.items) == len(want.items) > 0
    assert len(set(seq)) > 1


def test_bucket_changes_no_class(dirs, monkeypatch):
    """Trailing zero rows change no class under the causal mask: 10 rows
    against the same rows padded to 64, and ``generate`` at buckets of 64
    and 128 rows."""
    _, tm = _models(dirs["rand"])
    emb = np.random.default_rng(1).standard_normal((1, 10, tm.config.text.hidden_size))
    emb = torch.from_numpy(emb.astype(np.float32) * 0.1)
    cfg = tm.config.text
    short = TA._classify(tm.params, emb, cfg)[0]
    long = TA._classify(tm.params, torch.nn.functional.pad(emb, (0, 0, 0, 54)), cfg)[0]
    assert torch.equal(short, long[:10])
    calls = []
    classify = TA._classify
    monkeypatch.setattr(TA, "_classify",
                        lambda p, e, c: calls.append(e.shape[1]) or classify(p, e, c))
    x = _audio(4, 12000)
    a = tm.generate(x, text="w1 w2")
    monkeypatch.setattr(TA, "_PAD_BUCKET", 128)
    b = tm.generate(x, text="w1 w2")
    assert calls == [64, 128] and _items(a) == _items(b)


def test_refusals(dirs):
    _, tm = _models(dirs["rand"])
    for text in (None, ""):
        with pytest.raises(ValueError, match="transcript"):
            tm.generate(np.zeros(1600, np.float32), text=text)
    with pytest.raises(NotImplementedError, match="forced aligner"):
        tm.generate_stream(np.zeros(1600, np.float32))
    tok, tm.tokenizer = tm.tokenizer, None
    try:
        with pytest.raises(RuntimeError, match="tokenizer"):
            tm.generate(np.zeros(1600, np.float32), text="a")
    finally:
        tm.tokenizer = tok


def test_load_model_by_name(dirs):
    """A directory named like a forced aligner loads as a
    ``Qwen3ForcedAligner`` with its head (packed on the 4-bit tree), the
    JAX package's tree carries across ``convert.from_jax_params`` head
    included, and the periodic fixture loads too."""
    jm, tm = _models(dirs["q4"])
    assert isinstance(tm, TA.Qwen3ForcedAligner)
    assert isinstance(tm.params["lm_head"]["weight"], tquant.QuantizedTensor)
    assert tm.config.classify_num == 40 and tm.config.timestamp_token_id == 72
    conv = from_jax_params(jax_tree_to_numpy(jm.params))
    for f in ("weight", "scales", "biases"):
        assert torch.equal(getattr(conv["lm_head"]["weight"], f),
                           getattr(tm.params["lm_head"]["weight"], f))
    fixture = tload_model(str(dirs["fixture"]), dtype=torch.float32, device="cpu")
    assert isinstance(fixture, TA.Qwen3ForcedAligner)
    assert fixture.generate(_audio(0, 16000), text="w1 w2").items


# -- the CLIs and the server ---------------------------------------------------------------


def test_cli_stt_text_matches_jax(dirs, tmp_path, capsys, monkeypatch):
    """``cli/stt.py --text`` (json and srt) prints the JAX CLI's output; a
    forced aligner without ``--text``, or with ``--stream``, is a usage
    error in both."""
    from tpu_audio.cli import stt as jstt
    from tpu_audio.core.audio_io import save_wav
    from tpu_audio_torch.cli import stt as tstt

    _cli_models(monkeypatch, _models)
    wav = tmp_path / "in.wav"
    save_wav(wav, _audio(7, 20000), 16000)
    for fmt in ("json", "srt"):
        outs = []
        for main, extra in ((jstt.main, []), (tstt.main, ["--device", "cpu"])):
            assert main([str(wav), "--model", str(dirs["rand"]), "--text", "w1 hello w3",
                         "--format", fmt] + extra) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "hello" in outs[1]
    for bad in ([], ["--text", "w1", "--stream"]):
        for main, extra in ((jstt.main, []), (tstt.main, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                main([str(wav), "--model", str(dirs["rand"])] + bad + extra)
            assert e.value.code == 2
        assert "forced aligner" in capsys.readouterr().err


def test_cli_tts_timestamps_match_jax(dirs, tmp_path, capsys, monkeypatch):
    """``cli/tts.py --timestamps`` with Orpheus on the fixtures: the
    ``Timestamps:`` block equals the JAX aligner's on the written wav
    (resampled to 16 kHz)."""
    from fixtures import make_llama_tts_fixture, make_snac_fixture
    from tpu_audio.core.audio_io import load_audio, resample_audio
    from tpu_audio_torch.cli import tts as ttts

    _cli_models(monkeypatch, _models)
    model = make_llama_tts_fixture(tmp_path / "orpheus")
    snac = make_snac_fixture(tmp_path / "snac", vq_strides=(4, 2, 1))
    out = tmp_path / "out.wav"
    text = "hello w2 w3"
    assert ttts.main([text, "--model", str(model), "--codec", str(snac), "--device", "cpu",
                      "--max-tokens", "21", "--seed", "1", "--band-head", "-o", str(out),
                      "--timestamps",
                      str(dirs["rand"])]) == 0
    printed = capsys.readouterr().out.splitlines()
    block = printed[printed.index("Timestamps:"):]
    jm, _ = _models(dirs["rand"])
    wav, sr = load_audio(str(out))
    aligned = jm.generate(resample_audio(wav, sr, 16000), text=text, language="English")
    assert block == ["Timestamps:"] + [f"  [{i.start_time:.3f}s - {i.end_time:.3f}s] {i.text}"
                                       for i in aligned.items]
    assert len(block) == 4


def _wav(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_server_builds_no_engine_for_an_aligner(dirs, monkeypatch):
    """``serve --task stt --slots 2``: the JAX server builds a
    ``ContinuousQwen3ASR`` engine for an aligner (a ``Qwen3ASR``
    subclass), which would decode through the timestamp head as if it were
    a vocabulary. The port builds none and answers as the locked route
    does: an error that names the missing transcript."""
    from tpu_audio.parallel import continuous_stt as JCS

    jm, tm = _models(dirs["rand"])
    built = []

    class Recorder:
        def __init__(self, model, **kw):
            built.append(kw.get("engine_cls"))
            self._srv = type("S", (), {"window": 0})()

        def close(self):
            pass

    monkeypatch.setattr(JCS, "STTEngineWorker", Recorder)
    srv = jserve.build_server(jm, "stt", "aligner", port=0, slots=2)
    srv.server_close()
    assert built == [JCS.ContinuousQwen3ASR]
    srv = tserve.build_server(tm, "stt", "aligner", port=0, slots=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert srv.stt_worker is None
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/transcriptions"
        req = urllib.request.Request(url, data=_wav(_audio(1, 8000)),
                                     headers={"Content-Type": "audio/wav"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=120)
        assert e.value.code == 500 and "transcript" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()
