"""The Qwen3-TTS speech tokenizer's decoder on the PyTorch port against the
JAX package, on the CPU in f32: the split RVQ decode, the whole-sequence
decode and the streaming steps, on the fixture checkpoint
(tests/fixtures.make_qwen3_tts_fixture's ``speech_tokenizer/``) and on the
JAX package's random decoder params carried across with
``convert.from_jax_params``. Codes are drawn from numpy seeds. Tolerance:
1e-5 absolute on waveforms in [-1, 1] and 1e-5 relative to the largest
latent (f32 sums in another order)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.codecs import qwen3_codec as JQ
from tpu_audio.core import loading as jloading
from tpu_audio_torch.codecs import qwen3_codec as TQ
from tpu_audio_torch.convert import from_jax_params

from fixtures import make_qwen3_tts_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

ATOL = 1e-5
# chunk schedules of a 12-frame stream, in frames
SCHEDULES = [[(0, 3), (3, 4), (4, 9), (9, 12)], [(0, 1), (1, 7), (7, 12)]]


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """``(jax decoder, port decoder)`` over the fixture's speech tokenizer,
    and over the JAX package's random params (seed 3) at the fixture's
    config, keyed "fixture" and "random"."""
    st = make_qwen3_tts_fixture(tmp_path_factory.mktemp("q3codec")) / "speech_tokenizer"
    port = TQ.Qwen3CodecDecoder.from_pretrained(str(st), device="cpu")
    cfg = JQ.Qwen3CodecDecoderConfig.from_dict(json.loads((st / "config.json").read_text()))
    jfix = JQ.Qwen3CodecDecoder(cfg, jloading.load_params(st, dtype=jnp.float32))
    jrand_params = JQ.init_random_params(cfg, seed=3)
    jrand = JQ.Qwen3CodecDecoder(cfg, jrand_params)
    trand = TQ.Qwen3CodecDecoder(port.config, from_jax_params(jax_tree_to_numpy(jrand_params)))
    return {"fixture": (jfix, port), "random": (jrand, trand)}


def _codes(seed, t=12, high=32, groups=4):
    return np.random.default_rng(seed).integers(0, high, (1, groups, t)).astype(np.int32)


@pytest.mark.parametrize("which", ["fixture", "random"])
@pytest.mark.parametrize("high", [32, 40])
def test_quantizer_decode_matches_jax(codecs, which, high):
    """The split RVQ latents; codes past the codebook (high 40 > 32) read
    its last row in both packages."""
    jc, tc = codecs[which]
    codes = _codes(1, high=high)
    want = np.asarray(JQ.quantizer_decode(jc.params["quantizer"], jnp.asarray(codes),
                                          jc.config))
    got = TQ.quantizer_decode(tc.params["quantizer"], torch.from_numpy(codes).long(),
                              tc.config).numpy()
    assert got.shape == want.shape == (1, 12, tc.config.codebook_dim)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("which,t", [("fixture", 12), ("random", 12), ("random", 1)])
def test_decode_matches_jax(codecs, which, t):
    jc, tc = codecs[which]
    codes = _codes(2 + t, t=t)
    want = np.asarray(jc.decode(codes))
    got = tc.decode(codes)
    assert got.shape == want.shape == (1, t * tc.config.total_upsample)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("which,schedule,jax", [("fixture", 0, True), ("random", 1, True),
                                               ("random", 0, False), ("fixture", 1, False)])
def test_streaming_steps_match_jax_and_offline(codecs, which, schedule, jax):
    """Each streaming step's chunk against the JAX package's (where
    ``jax``), and the chunks concatenated against the port's
    whole-sequence decode."""
    jc, tc = codecs[which]
    codes = _codes(7)
    jc.reset_streaming_state()
    tc.reset_streaming_state()
    chunks = []
    for s, e in SCHEDULES[schedule]:
        got = tc.streaming_step(codes[:, :, s:e]).numpy()
        if jax:
            np.testing.assert_allclose(got, np.asarray(jc.streaming_step(codes[:, :, s:e])),
                                       atol=ATOL)
        chunks.append(got)
    streamed = np.concatenate(chunks, axis=-1)
    np.testing.assert_allclose(streamed, tc.decode(codes).numpy(), atol=ATOL)
    assert tc._stream_state["cache"].offset == 12


def test_causal_convt_step_carries_the_tail_without_its_bias():
    """A biased transposed conv streamed one frame at a time equals the
    whole-sequence one (the carried tail drops the bias), as in the JAX
    package."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 4, 6)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((1, 5, 6)).astype(np.float32)
    tp = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    full = TQ.causal_convt(tp, torch.from_numpy(x), 6, 3)
    tail = torch.zeros((1, 3, 4))
    parts = []
    for i in range(5):
        y, tail = TQ.causal_convt_step(tp, torch.from_numpy(x[:, i:i + 1]), tail, 6, 3)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), full.numpy(), atol=1e-5)
    want = np.asarray(JQ.causal_convt({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                      jnp.asarray(x), 6, 3))
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)


def test_init_random_params_matches_the_loaded_tree(codecs):
    """The port's random decoder params have the loaded checkpoint's keys
    and shapes (so the card runs the graphs a checkpoint runs)."""
    _, tc = codecs["fixture"]

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(TQ.init_random_params(tc.config)) == shapes(tc.params)
