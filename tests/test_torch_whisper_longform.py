"""Whisper's long-form batched windows and its int8 encoder (``w8e``) on the
PyTorch port against the JAX package, on the CPU at small sizes.

Audio longer than 30 s decodes its windows in groups of up to eight, one
encoder call and one decode loop a group, a row a window. Greedy tokens,
text, segment times and prompt counts are held to the JAX package's
``generate(batch_windows=True)`` and to the port's own window-by-window
decode, on every decode route: dense, kv8d (one int8 attention call a layer
over the heads of every window) and w8 kv8d (the windows as lanes of
``fused_stack_lanes``, held to the one-token route and to the JAX package's
fused route, its Pallas kernel in interpret mode). The decoders' weights are
five times ``init_params``' so that each window's tokens follow its audio.
"""

import io
import json
import threading
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.stt import whisper as JW
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.core import loading
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.ops import fused_decoder as TF

from fixtures import FakeWhisperTokenizer
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

SMALL = dict(num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=2,
             encoder_ffn_dim=128, decoder_layers=2, decoder_attention_heads=2,
             decoder_ffn_dim=128, vocab_size=128, max_source_positions=1500,
             max_target_positions=64)
# a shape the fused kernels take (tests/test_torch_whisper.py's FUSED)
FUSED = dict(SMALL, d_model=256, encoder_layers=1, encoder_attention_heads=4,
             encoder_ffn_dim=1024, decoder_attention_heads=4, decoder_ffn_dim=1024)
KV8D = dict(kv_bits=8, quantized_kv_start=448)


def rich_params(conf: dict, seed: int = 3) -> dict:
    """The JAX package's ``init_params`` with the decoder layers' weights
    scaled by 5, as numpy leaves (which the JAX package takes too)."""
    tree = jax_tree_to_numpy(JW.init_params(JW.WhisperConfig(**conf), seed=seed,
                                            dtype=jnp.float32))
    layers = tree["model"]["decoder"]["layers"]
    for block in layers.values():
        for leaf in (block, *[v for v in block.values() if isinstance(v, dict)]):
            if leaf.get("weight") is not None and np.ndim(leaf["weight"]) == 3:
                leaf["weight"] = leaf["weight"] * 5.0
    return tree


def long_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """``seconds`` of audio whose 30 s windows differ: noise of a rising
    level, a tone, gated noise, in turn."""
    rng = np.random.default_rng(seed)
    t = np.arange(TW.CHUNK_LENGTH_SAMPLES) / TW.SAMPLE_RATE
    parts = []
    for w in range(int(np.ceil(seconds / TW.CHUNK_LENGTH_SECONDS))):
        kind = w % 3
        if kind == 0:
            x = rng.standard_normal(t.size) * (0.02 + 0.3 * w)
        elif kind == 1:
            x = np.sin(2 * np.pi * (200 + 300 * w) * t) * 0.5
        else:
            x = np.sign(np.sin(2 * np.pi * (3 + w) * t)) * rng.standard_normal(t.size) * 0.5
        parts.append(x)
    return np.concatenate(parts)[: int(seconds * TW.SAMPLE_RATE)].astype(np.float32)


def both(conf: dict, tree: dict):
    """The JAX package's and the port's model over the same weights (a JAX
    package tree), f32."""
    jm = JW.Whisper(JW.WhisperConfig(**conf), tree, dtype=jnp.float32)
    jm.tokenizer = FakeWhisperTokenizer(vocab=conf["vocab_size"])
    tm = TW.Whisper(TW.WhisperConfig(**conf), from_jax_params(jax_tree_to_numpy(tree)),
                    FakeWhisperTokenizer(vocab=conf["vocab_size"]), dtype=torch.float32,
                    device="cpu")
    return jm, tm


def summary(out) -> tuple:
    return ([s.tokens for s in out.segments], out.text,
            [(s.start, s.end) for s in out.segments], out.prompt_token_count,
            out.generation_token_count)


@pytest.fixture(scope="module")
def small():
    return both(SMALL, rich_params(SMALL))


@pytest.fixture(scope="module")
def fused_trees():
    """The FUSED model's tree with a w8a8 decoder, with a dense and with a
    w8a8 encoder (the JAX bench's ``w8e``)."""
    tree = rich_params(FUSED)
    w8 = {"model": dict(tree["model"], decoder=jquant.quantize_tree(
        tree["model"]["decoder"], scheme="w8a8"))}
    w8e = {"model": dict(w8["model"], encoder=jquant.quantize_tree(
        tree["model"]["encoder"], scheme="w8a8"))}
    return {"dense": w8, "w8e": w8e}


def counting(monkeypatch, module, name: str) -> list:
    """Count the calls of ``module.name`` (which still runs)."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(a[0].shape if name == "int8_matmul" else None)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", ["dense", "kv8d"])
def test_batched_windows_match_jax_and_per_window(small, monkeypatch, route):
    """Three windows (75 s): greedy tokens, text, segment times and prompt
    count of the JAX package's batched decode, and of the port's own
    window-by-window decode (mirrors tests/test_whisper.py:366 and :385;
    the kv8d route pins ``TPU_AUDIO_PALLAS_KV=0`` as the JAX test does)."""
    jm, tm = small
    kw = KV8D if route == "kv8d" else {}
    monkeypatch.setenv("TPU_AUDIO_PALLAS_KV", "0")
    audio = long_audio(75)
    want = jm.generate(audio, JParams(max_tokens=6, batch_windows=True, **kw))
    got = tm.generate(audio, TParams(max_tokens=6, **kw))
    assert summary(got) == summary(want)
    assert len(got.segments) == 3 and got.segments[-1].end == 75.0
    assert len({tuple(s.tokens) for s in got.segments}) > 1  # the windows differ
    assert summary(tm.generate(audio, TParams(max_tokens=6, batch_windows=False, **kw))) \
        == summary(got)


@pytest.mark.parametrize("encoder", ["dense", "w8e"])
def test_w8_kv8d_windows_are_lanes_of_kernel_4(fused_trees, monkeypatch, encoder):
    """w8 kv8d over two windows: the batched route makes one
    ``fused_stack_lanes`` call a step for both windows (its plain version
    here) and no ``fused_stack`` call, and gives each window the tokens of
    the window-by-window route (``fused_stack``'s plain version) and of the
    JAX package's fused route (interpret mode); with the int8 encoder too.
    The int8 encoder starts from the JAX package's log-mel features: the two
    frontends' FFTs round apart (~2e-5), which moves an activation code
    across a rounding boundary here and there, and the random decoder's
    greedy tokens follow such flips at near-ties."""
    jm, tm = both(FUSED, fused_trees[encoder])
    assert tm._fused_supported()
    if encoder == "w8e":
        monkeypatch.setattr(tm, "encoder_features", lambda chunk: torch.from_numpy(
            np.asarray(jm.encoder_features(chunk))))
    audio = long_audio(50)
    lanes = counting(monkeypatch, TF, "fused_stack_lanes")
    one = counting(monkeypatch, TF, "fused_stack")
    got = tm.generate(audio, TParams(max_tokens=3, **KV8D))
    steps = len(tm.tokenizer.build_prompt_tokens()) + 3 - 1
    assert (len(lanes), len(one)) == (steps, 0)
    per_window = tm.generate(audio, TParams(max_tokens=3, batch_windows=False, **KV8D))
    assert (len(lanes), len(one)) == (steps, 2 * steps)
    assert summary(per_window) == summary(got)
    assert len({tuple(s.tokens) for s in got.segments}) == 2
    monkeypatch.setenv("TPU_AUDIO_FUSED_DECODER", "interpret")
    want = jm.generate(audio, JParams(max_tokens=3, batch_windows=False, **KV8D))
    assert summary(got) == summary(want)


def test_five_windows_are_one_group(small, monkeypatch):
    """125 s: five windows in one encoder call over five rows and one
    decode loop, five segments in order, the last ending at 125 s (mirrors
    tests/test_whisper.py:397; no window-count bucket pads the group)."""
    _, tm = small
    encodes = []
    forward = tm.encoder.forward
    monkeypatch.setattr(tm.encoder, "forward",
                        lambda mel: encodes.append(mel.shape[0]) or forward(mel))
    loops = []
    loop = TW._sample_loop
    monkeypatch.setattr(TW, "_sample_loop", lambda step, prompt, rows, *a:
                        loops.append(rows) or loop(step, prompt, rows, *a))
    out = tm.generate(long_audio(125), TParams(max_tokens=2))
    assert (encodes, loops) == ([5], [5])
    n_prompt = len(tm.tokenizer.build_prompt_tokens(None, "transcribe"))
    assert out.prompt_token_count == 5 * n_prompt
    assert [(s.start, s.end) for s in out.segments] == [
        (30.0 * w, min(30.0 * (w + 1), 125.0)) for w in range(5)]
    assert out.generation_token_count == 10


def test_decoder_step_int8_cross_rows_are_the_one_row_calls():
    """``decoder_step`` with int8 cross K/V at B = 2 (one attention call a
    layer over both rows' heads) gives each row, bit for bit, the logits and
    cache rows of its own B = 1 call. The decoder is w8a8, whose products
    are exact integer sums, so no product's rounding follows the row count."""
    cfg = TW.WhisperConfig(**SMALL)
    params = TW.init_params(cfg, seed=4, dtype=torch.float32)
    params["model"]["decoder"] = tquant.quantize_tree(params["model"]["decoder"],
                                                      min_in_features=16)
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn((2, 1500, cfg.d_model), generator=gen)
    L, H = cfg.decoder_layers, cfg.decoder_attention_heads
    hd = cfg.d_model // H
    ck, cv = TW._cross_kv(params, enc, cfg)

    def planes(rows):
        return tuple(t.flatten(1, 2) for t in tkv._quantize(ck[:, rows], 1)
                     + tkv._quantize(cv[:, rows], 1))

    caches = [tkv.init_cache(L, b, H, hd, 8, torch.float32) for b in (2, 1, 1)]
    for i, toks in enumerate([(100, 100), (5, 17), (9, 3)]):
        both_rows, caches[0] = TW.decoder_step(params, torch.tensor([toks]).t(), i,
                                               caches[0], planes(slice(0, 2)), cfg,
                                               cross_mode="int8")
        for r in range(2):
            row, caches[1 + r] = TW.decoder_step(
                params, torch.tensor([[toks[r]]]), i, caches[1 + r],
                planes(slice(r, r + 1)), cfg, cross_mode="int8")
            assert torch.equal(both_rows[r], row[0]), (i, r)
    for r in range(2):
        assert torch.equal(caches[0].k[:, r], caches[1 + r].k[:, 0])
    with pytest.raises(ValueError, match="one token a row"):
        TW.decoder_step(params, torch.tensor([[1, 2]]), 0, caches[1],
                        planes(slice(0, 1)), cfg, cross_mode="int8")


def test_sample_loop_rows_finish_apart():
    """Rows that emit EOT at different steps: a finished row goes on
    emitting EOT, the loop stops once every row has finished, and each
    row's sequence is the one-row loop's on that row alone."""
    eot, vocab, prompt = 9, 10, [7, 8]
    ends = [3, 6, 4]  # the step at which each row emits EOT

    def step_of(rows):
        def step(tokens, i):
            logits = torch.zeros((len(rows), vocab))
            for m, r in enumerate(rows):
                logits[m, eot if i == ends[r] else (r + i) % 5] = 1.0
            return logits
        return step

    zeros = torch.zeros(vocab)
    args = (20, eot, zeros, zeros, 0.0, None)
    rows = TW._sample_loop(step_of([0, 1, 2]), prompt, 3, *args)
    assert [len(r) for r in rows] == [max(ends) + 2] * 3
    for r, row in enumerate(rows):
        alone = TW._sample_loop(step_of([r]), prompt, 1, *args)[0]
        assert row[: len(alone)] == alone and alone[-1] == eot
        assert set(row[len(alone):]) <= {eot}


def test_w8e_encoder_matches_jax(fused_trees, monkeypatch):
    """The int8 encoder as the JAX bench builds it (``quantize_tree`` of
    ``model.encoder``, scheme w8a8): the port's ``quantize_tree`` makes the
    same leaves bit for bit and keeps the convs and the position table
    dense; ``from_jax_params`` carries the JAX package's across;
    ``encoder_forward`` runs every product through ``int8_matmul`` at
    [B * 1500, d] rows and stays within 3e-2 of the JAX package's."""
    cfg = JW.WhisperConfig(**FUSED)
    tree = fused_trees["w8e"]
    enc = tree["model"]["encoder"]
    assert isinstance(enc["layers"]["fc1"]["weight"], jquant.Int8Tensor)
    for dense in (enc["conv1"], enc["conv2"], enc["embed_positions"]):
        assert not isinstance(dense["weight"], jquant.Int8Tensor)
    mine = tquant.quantize_tree(from_jax_params(jax_tree_to_numpy(
        fused_trees["dense"]))["model"]["encoder"], scheme="w8a8")
    carried = from_jax_params(jax_tree_to_numpy(tree))["model"]["encoder"]
    flat_m, flat_c = loading.flatten(mine), loading.flatten(carried)
    assert flat_m.keys() == flat_c.keys()
    n_int8 = 0
    for k, c in flat_c.items():
        m = flat_m[k]
        assert type(m) is type(c), k
        if isinstance(c, tquant.Int8Tensor):
            n_int8 += 1
            assert torch.equal(m.weight, c.weight) and torch.equal(m.scale, c.scale), k
        else:
            assert torch.equal(m, c), k
    assert n_int8 == 6  # q, k, v, out, fc1, fc2 (stacked over the layers)
    mel = (np.random.default_rng(2).standard_normal((2, 3000, cfg.num_mel_bins)) * 0.5
           ).astype(np.float32)
    want = np.asarray(JW.encoder_forward(tree, jnp.asarray(mel), cfg))
    rows = counting(monkeypatch, tquant, "int8_matmul")
    got = TW.encoder_forward({"model": {"encoder": carried}}, torch.from_numpy(mel),
                             TW.WhisperConfig(**FUSED)).numpy()
    assert len(rows) == 6 * cfg.encoder_layers
    assert all(r[:2] == (2, 1500) for r in rows)
    assert np.abs(got - want).max() / np.abs(want).max() < 3e-2


def _wav(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_server_transcribes_a_40_s_upload_like_jax(small):
    """A 40 s WAV posted to the port's ``/v1/audio/transcriptions`` (a
    server with serving lanes, which long uploads bypass) gets the text of
    the JAX package's ``generate`` with default parameters."""
    from tpu_audio_torch.cli.serve import build_server

    jm, tm = small
    audio = long_audio(40, seed=1)
    srv = build_server(tm, "stt", "fixture", port=0, slots=2)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/audio/transcriptions",
            data=_wav(audio), headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    pcm = (audio * 32767).clip(-32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    want = jm.generate(pcm)
    assert got["text"] == want.text and want.text
    assert [(s["start"], s["end"]) for s in got["segments"]] == [(0.0, 30.0), (30.0, 40.0)]
