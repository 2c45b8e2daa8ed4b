"""MLX grouped-affine 4/8-bit Orpheus (and Whisper) on the PyTorch port
against the JAX package, on the CPU at small sizes, in f32.

Two kinds of tree: fixture checkpoints that ship MLX-packed weights with a
``quantization`` block in their config (as tests/test_whisper.py:160-178
builds its q4 Whisper), and a wider full-precision checkpoint (width 256,
written here) quantized at load with ``quantize_bits=4|8``, because the
quantizer skips inputs narrower than 256. On both: greedy tokens through
``LlamaTTS._run_generation`` with the band head on and off, prefill and
step logits, ``ContinuousTTS`` on the plain tick, the routing of every
projection and the head through the GEMV (whose plain version runs here),
``load_model`` and the CLI; and the q4 Whisper fixture's greedy tokens.
"""

import json
import shutil
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import loading as jloading
from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import AudioGenerateParameters as JParams
from tpu_audio.core.generation import STTGenerateParameters as JSTTParams
from tpu_audio.models import llama as JL
from tpu_audio.models.stt import whisper as JW
from tpu_audio.models.tts import load_model as jload_model
from tpu_audio.parallel import continuous as JC
from tpu_audio_torch.codecs.snac import SNAC as TSNAC
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import AudioGenerateParameters as TParams
from tpu_audio_torch.core.generation import AudioGenerationKind
from tpu_audio_torch.core.generation import STTGenerateParameters as TSTTParams
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.models.tts import llama_tts as TT
from tpu_audio_torch.models.tts import load_model as tload_model
from tpu_audio_torch.ops import qmm as TQ
from tpu_audio_torch.parallel import continuous as TC

from fixtures import (FakeWhisperTokenizer, make_llama_tts_fixture, make_snac_fixture,
                      make_whisper_fixture)
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

GREEDY = dict(max_tokens=20, temperature=0.0, repetition_penalty=1.3)
# the checkpoints' (bits, group size): 4-bit in groups of 16 at the
# fixture's width 32, as the JAX Whisper test quantizes; 8-bit in groups of 32
SHIPPED = [(4, 16), (8, 32)]
WIDE = dict(hidden_size=256, num_hidden_layers=2, intermediate_size=512,
            num_attention_heads=4, num_key_value_heads=2)


def _quantize_checkpoint(src, dst, bits, group_size, linear):
    """``src``'s checkpoint with every weight ``linear(name, array)`` picks
    MLX-packed (words, scales, biases), a ``quantization`` block in its
    config, and the rest of the directory as it was."""
    from safetensors.numpy import save_file

    shutil.copytree(src, dst)
    q = {}
    for k, v in jloading.load_safetensors(src).items():
        if linear(k, v) and v.shape[1] % group_size == 0:
            q[k], q[k.replace(".weight", ".scales")], q[k.replace(".weight", ".biases")] = \
                jquant.quantize(v, group_size, bits)
        else:
            q[k] = v
    cfg = json.loads((dst / "config.json").read_text())
    cfg["quantization"] = {"group_size": group_size, "bits": bits}
    (dst / "config.json").write_text(json.dumps(cfg))
    save_file(q, str(dst / "model.safetensors"))
    return dst


def _is_llama_linear(k, v):
    return v.ndim == 2 and k.endswith(".weight") and ("proj" in k or "embed_tokens" in k)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The fixture checkpoint (SNAC beside it) packed at each of SHIPPED,
    and a width-256 full-precision checkpoint of random weights."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("orpheus_q")
    src = make_llama_tts_fixture(root / "src")
    make_snac_fixture(src / "snac", vq_strides=(4, 2, 1))
    cfg = json.loads((src / "config.json").read_text())
    cfg["snac_repo"] = str(src / "snac")
    (src / "config.json").write_text(json.dumps(cfg))
    out = {f"q{b}": _quantize_checkpoint(src, root / f"q{b}", b, g, _is_llama_linear)
           for b, g in SHIPPED}
    wide = root / "wide"
    shutil.copytree(src, wide)
    cfg.update(WIDE)
    (wide / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(21)
    d, ffn, hd = 256, 512, 64

    def w(*shape, std=0.06):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    ws = {"model.embed_tokens.weight": w(cfg["vocab_size"], d, std=0.5),
          "model.norm.weight": np.ones(d, np.float32)}
    for i in range(2):
        b = f"model.layers.{i}"
        ws.update({f"{b}.input_layernorm.weight": np.ones(d, np.float32),
                   f"{b}.post_attention_layernorm.weight": np.ones(d, np.float32),
                   f"{b}.self_attn.q_proj.weight": w(4 * hd, d),
                   f"{b}.self_attn.k_proj.weight": w(2 * hd, d),
                   f"{b}.self_attn.v_proj.weight": w(2 * hd, d),
                   f"{b}.self_attn.o_proj.weight": w(d, 4 * hd),
                   f"{b}.mlp.gate_proj.weight": w(ffn, d),
                   f"{b}.mlp.up_proj.weight": w(ffn, d),
                   f"{b}.mlp.down_proj.weight": w(d, ffn)})
    save_file(ws, str(wide / "model.safetensors"))
    out["wide"] = wide
    return out


def _models(path, band, bits=None):
    kw = {} if bits is None else {"quantize_bits": bits}
    jm = jload_model(str(path), dtype=jnp.float32, audio_band_head=band, **kw)
    tm = tload_model(str(path), dtype=torch.float32, device="cpu", audio_band_head=band,
                     codec=TSNAC.from_pretrained(str(path / "snac"), device="cpu"), **kw)
    return jm, tm


def _tokens(model, P, text="hello world", voice="tara", chunk=6):
    for *_, (_pt, _gt, _pl, toks) in model._run_generation(text, voice, None, None,
                                                           P(**GREEDY), chunk_tokens=chunk):
        pass
    return toks


def _qkv(model):
    return model.params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"]


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("bits", [b for b, _ in SHIPPED])
def test_shipped_checkpoint_greedy_tokens_match_jax(dirs, bits, band):
    """A checkpoint that ships MLX-packed weights: tagged, stacked, q/k/v
    and gate/up fused, and the JAX package's greedy tokens (repetition
    penalty 1.3), band head off and on."""
    jm, tm = _models(dirs[f"q{bits}"], band)
    qkv = _qkv(tm)
    assert isinstance(qkv, tquant.QuantizedTensor) and qkv.bits == bits
    assert qkv.weight.dtype == torch.int32 and qkv.weight.ndim == 3
    head = tm.params["band_head" if band else "model"]
    head = head["weight"] if band else head["embed_tokens"]["weight"]
    assert isinstance(head, tquant.QuantizedTensor)
    toks = _tokens(tm, TParams)
    assert toks == _tokens(jm, JParams)
    assert len(toks) > 20


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_post_load_quantize_greedy_tokens_match_jax(dirs, bits, band):
    """``quantize_bits=4|8`` on a full-precision width-256 checkpoint: the
    leaves the JAX package quantizes (every projection and the embedding,
    group size 64), and its greedy tokens."""
    jm, tm = _models(dirs["wide"], band, bits)
    assert isinstance(_qkv(tm), tquant.QuantizedTensor) and _qkv(tm).group_size == 64
    assert isinstance(tm.params["model"]["embed_tokens"]["weight"], tquant.QuantizedTensor)
    np.testing.assert_array_equal(
        _qkv(tm).weight.numpy(),
        np.asarray(jm.params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"].weight
                   ).view(np.int32))
    assert _tokens(tm, TParams) == _tokens(jm, JParams)


@pytest.mark.parametrize("which", ["q4", "wide"])
def test_prefill_and_step_logits_match_jax(dirs, which):
    """Left-padded prefill and three cached steps through ``llama.forward``
    from the same packed tree: logits within 1e-4 of the largest (f32 sums
    in another order), the residual stream f32 from the packed embedding
    on."""
    bits = 4 if which == "wide" else None
    jm, tm = _models(dirs[which], False, bits)
    prompt, pad = [90, 5, 17, 60, 61, 92, 91], 9
    ids = np.asarray([[95] * pad + prompt], np.int32)
    jc = JL.make_cache(jm.config, 1, 24, jnp.float32)._replace(
        valid_from=jnp.asarray(pad, jnp.int32))
    tc = TL.make_cache(tm.config, 1, 24, torch.float32, valid_from=pad)
    jl, jc = JL.forward(jm.params, jnp.asarray(ids), jc, jm.config)
    tl, tc = TL.forward(tm.params, torch.from_numpy(ids).long(), tc, tm.config)
    got, want = [tl[0, pad:].numpy()], [np.asarray(jl)[0, pad:]]
    for tok in (101, 203, 17):
        jl, jc = JL.forward(jm.params, jnp.asarray([[tok]], jnp.int32), jc, jm.config)
        tl, tc = TL.forward(tm.params, torch.tensor([[tok]]), tc, tm.config)
        assert tl.dtype == torch.float32
        got.append(tl[0].numpy())
        want.append(np.asarray(jl)[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def test_every_projection_and_the_head_run_the_gemv(dirs, monkeypatch):
    """On an MLX tree the 63-row prefill makes 4 GEMV calls a layer (q/k/v,
    o, gate/up, down) of 63 rows, and a band decode step 4 a layer and one
    for the head, of one row each: the 4 x 28 + 1 = 113 a step of
    Orpheus-3B. The tree takes no fused route, on CUDA either."""
    _, tm = _models(dirs["wide"], True, 4)
    L = tm.config.num_hidden_layers
    cuda = torch.device("cuda")
    assert not TT._fused_route(tm.params, tm.config, cuda) and tm.device.type == "cpu"
    rows = []
    ref = TQ.quantized_matvec

    def spy(x, *a, **k):
        rows.append(x.shape[0])
        return ref(x, *a, **k)

    monkeypatch.setattr(TQ, "quantized_matvec", spy)
    cache = TL.make_cache(tm.config, 1, 80, torch.float32, valid_from=3)
    _, cache = tm._prefill(tm.params, torch.arange(63)[None] % 90, cache)
    assert rows == [63] * 4 * L
    rows.clear()
    logits, _ = tm._step_fn(tm.params, torch.tensor([[5]]), cache)
    assert rows == [1] * (4 * L + 1) and logits.shape == (1, 7 * tm.tokens.codebook_size + 1)


@pytest.mark.parametrize("band", [False, True])
def test_continuous_tts_plain_tick_gives_generate_tokens(dirs, band):
    """Two staggered greedy requests through ContinuousTTS on a q4 tree (the
    plain tick: each lane's step runs the GEMV at one row): each request's
    tokens are its solo ``generate_stream``'s and the JAX package's
    ContinuousTTS's (with streamed audio from the band head)."""
    gp = dict(max_tokens=21, temperature=0.0, top_p=1.0, repetition_penalty=1.3,
              repetition_context_size=8, streaming_interval=0.02)
    texts = ["hello world", "a much longer second sentence to say"]
    jm, tm = _models(dirs["q4"], band)

    def drain(srv):
        reqs = [srv.submit(texts[0])]
        events = list(srv.step())
        reqs.append(srv.submit(texts[1]))
        events += list(srv.run())
        n_audio = sum(ev.kind == AudioGenerationKind.AUDIO for _, ev in events)
        return [list(r.tokens) for r in reqs], n_audio

    srv = TC.ContinuousTTS(tm, slots=2, generation_parameters=TParams(**gp))
    assert not srv.fused
    got, n_audio = drain(srv)
    assert n_audio > 0 or not band  # the full head may emit no audio codes
    solo = [[e.token for e in tm.generate_stream(t, generation_parameters=TParams(**gp))
             if e.kind == AudioGenerationKind.TOKEN] for t in texts]
    assert got == solo
    want, _ = drain(JC.ContinuousTTS(jm, slots=2, generation_parameters=JParams(**gp)))
    assert got == want


def test_load_model_and_cli_quantize(dirs, tmp_path):
    """``--quantize 4|8`` through the CLI writes a wav from the width-256
    checkpoint; ``quantize_bits`` outside 4, 8 and w8a8 raises."""
    from tpu_audio_torch.cli import tts as cli

    out = tmp_path / "out.wav"
    for bits in ("4", "8"):
        assert cli.main(["hello", "--model", str(dirs["wide"]), "--device", "cpu",
                         "--max-tokens", "14", "--band-head", "--quantize", bits,
                         "-o", str(out)]) == 0
        with wave.open(str(out)) as f:
            assert f.getnframes() > 0
    with pytest.raises(ValueError, match="quantize_bits"):
        tload_model(str(dirs["wide"]), dtype=torch.float32, device="cpu", quantize_bits=3)


def test_from_jax_params_carries_a_packed_llama_tree():
    """A JAX MLX tree (``quantize_tree`` of random params, fused) through
    ``from_jax_params``: the port's forward gives the JAX logits."""
    cfg = dict(WIDE, vocab_size=96, rope_theta=10000.0, tie_word_embeddings=True)
    jp = JL.fuse_projections(jquant.quantize_tree(
        JL.init_random_params(JL.LlamaConfig(**cfg), seed=2, dtype=jnp.float32),
        bits=8, group_size=128, word_scales=False))
    tp = from_jax_params(jax_tree_to_numpy(jp))
    assert isinstance(tp["model"]["layers"]["mlp"]["gate_up_proj"]["weight"],
                      tquant.QuantizedTensor)
    ids = np.asarray([[3, 17, 40, 2]], np.int32)
    want = np.asarray(JL.forward(jp, jnp.asarray(ids), None, JL.LlamaConfig(**cfg))[0])
    got = TL.forward(tp, torch.from_numpy(ids).long(), None, TL.LlamaConfig(**cfg))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kv", [{}, dict(kv_bits=8, quantized_kv_start=448)])
def test_whisper_q4_checkpoint_greedy_tokens_match_jax(tmp_path, kv):
    """tests/test_whisper.py:152's q4 Whisper (every linear and the tied
    embedding packed, groups of 16): the decoder's and encoder's packed
    leaves held as module buffers, and the JAX package's greedy tokens on
    the dense and the kv8d route."""
    src = make_whisper_fixture(tmp_path / "f32", d_model=32, vocab=64)
    qdir = _quantize_checkpoint(
        src, tmp_path / "q4", 4, 16,
        lambda k, v: v.ndim == 2 and k.endswith(".weight")
        and ("proj" in k or "fc" in k or k.endswith("embed_tokens.weight")))
    jm = JW.Whisper.from_pretrained(str(qdir), dtype=jnp.float32)
    jm.tokenizer = FakeWhisperTokenizer(vocab=jm.config.vocab_size)
    tm = TW.Whisper.from_pretrained(str(qdir), dtype=torch.float32, device="cpu")
    tm.tokenizer = FakeWhisperTokenizer(vocab=tm.config.vocab_size)
    emb = tm.params["model"]["decoder"]["embed_tokens"]["weight"]
    assert isinstance(emb, tquant.QuantizedTensor) and emb.weight.dtype == torch.int32
    assert "decoder.layers.fc1.weight.scales" in tm.state_dict()
    assert isinstance(tm.decoder.split_layers()[1]["fc1"]["weight"], tquant.QuantizedTensor)
    assert not tm._fused_supported()
    audio = (np.random.default_rng(4).standard_normal(16000) * 0.1).astype(np.float32)
    want = jm.generate(audio, JSTTParams(max_tokens=6, **kv))
    got = tm.generate(audio, TSTTParams(max_tokens=6, **kv))
    assert [s.tokens for s in got.segments] == [s.tokens for s in want.segments]
    assert got.generation_token_count > 0
