"""Parakeet (TDT / RNNT / CTC) on the PyTorch port against the JAX package,
on the CPU at small sizes: the NeMo frontend, ``conv2d``, ``batch_norm``
and ``lstm_cell``, the encoder at subsampling 4 and 8, the prediction step
and the joint, the batched decode loop's lattice (tokens, times, jumps,
counts) for TDT and RNNT, ``generate_batch``, chunked ``generate``, MLX
8-bit and 4-bit trees (kernel 7's calls a decode step counted by a spy on
``ops.qmm.quantized_matvec``), the CTC route, ``nemo_alignment``,
``load_model``, the CLI and the server.

The fixture checkpoint (tests/fixtures.make_parakeet_fixture) has periodic
weights, whose logits tie; so the comparisons run on copies of its layout
with seeded normal weights (``_write``). Both packages get the same
weights: the JAX package loads the checkpoint and
``convert.from_jax_params`` carries its tree across. Tolerances: 1e-4
absolute on the normalized log-mel (f32 FFTs in another order), 1e-6 on
the single layers, 1e-4 of the largest value on encoder features, 1e-5 on
the prediction step and joint logits; lattices and greedy tokens equal.
"""

import dataclasses
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

from tpu_audio.core import loading as jloading
from tpu_audio.core import nn as jnn
from tpu_audio.core import quant as jquant
from tpu_audio.core.generation import STTGenerateParameters as JParams
from tpu_audio.models.stt import nemo_alignment as jna
from tpu_audio.models.stt import parakeet as JP
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import dsp as tdsp
from tpu_audio_torch.core import nn as tnn
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.core.generation import STTGenerateParameters as TParams
from tpu_audio_torch.models.stt import load_model as tload_model
from tpu_audio_torch.models.stt import nemo_alignment as tna
from tpu_audio_torch.models.stt import parakeet as TP
from tpu_audio_torch.ops import qmm

from fixtures import make_parakeet_fixture
from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)

RTOL = 1e-4
WIDE = dict(d_model=256, n_heads=4, pred_hidden=256, joint_hidden=256)


def _audio(seed, n=16000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _write(path, seed, subsampling=4, variant="tdt", **widths):
    """A checkpoint in the fixture's MLX-community layout at ``widths``
    (``make_parakeet_fixture``'s arguments) whose weights are seeded
    normal draws: N(0, 1/fan_in) weights, N(0, 0.05) biases, norms and
    BatchNorm scales 1 + N(0, 0.1), running means N(0, 0.1) and variances
    1 + |N(0, 0.2)|. ``subsampling=8`` adds the second depthwise/pointwise
    pair (``pre_encode.conv.5``/``.6``)."""
    from safetensors.numpy import save_file

    path = make_parakeet_fixture(path, variant=variant, **widths)
    cfg = json.loads((path / "config.json").read_text())
    w = jloading.load_safetensors(path)
    if subsampling == 8:
        cfg["encoder"]["subsampling_factor"] = 8
        ch = cfg["encoder"]["subsampling_conv_channels"]
        w["encoder.pre_encode.conv.5.weight"] = w["encoder.pre_encode.conv.2.weight"]
        w["encoder.pre_encode.conv.5.bias"] = w["encoder.pre_encode.conv.2.bias"]
        w["encoder.pre_encode.conv.6.weight"] = w["encoder.pre_encode.conv.3.weight"]
        w["encoder.pre_encode.conv.6.bias"] = w["encoder.pre_encode.conv.3.bias"]
        f_out = cfg["encoder"]["feat_in"]
        for _ in range(3):
            f_out = (f_out + 2 - 3) // 2 + 1
        d = cfg["encoder"]["d_model"]
        w["encoder.pre_encode.out.weight"] = np.zeros((d, ch * f_out), np.float32)
    (path / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in sorted(w.items()):
        shape = v.shape
        if "running_var" in name:
            a = 1.0 + np.abs(0.2 * rng.standard_normal(shape))
        elif "running_mean" in name:
            a = 0.1 * rng.standard_normal(shape)
        elif ("norm" in name and name.endswith(".weight")) or "batch_norm.weight" in name:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias") or "pos_bias" in name:
            a = 0.05 * rng.standard_normal(shape)
        elif "embed" in name:
            a = 0.5 * rng.standard_normal(shape)
        else:
            # MLX layouts keep the input axis last (conv [O, H, W, I] / [O, K, I])
            fan_in = int(np.prod(shape[1:]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[name] = np.asarray(a, np.float32)
    save_file(out, str(path / "model.safetensors"))
    return path


def _pack(path, bits):
    """MLX-pack a checkpoint in place (group size 64) as the reference's
    quantized conversions store it: every 2-D weight the quantizer takes,
    with a ``quantization`` block in its config."""
    from safetensors.numpy import save_file

    cfg = json.loads((path / "config.json").read_text())
    cfg["quantization"] = {"group_size": 64, "bits": bits}
    (path / "config.json").write_text(json.dumps(cfg))
    w = jloading.load_safetensors(path)
    out = {}
    for name, a in w.items():
        if (name.endswith(".weight") and a.ndim == 2 and a.shape[1] % 64 == 0
                and a.shape[1] >= 256 and "norm" not in name):
            q, s, b = jquant.quantize(a, 64, bits)
            out[name], out[name[:-6] + "scales"], out[name[:-6] + "biases"] = q, s, b
        else:
            out[name] = a
    save_file(out, str(path / "model.safetensors"))
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parakeet")
    return {"rand": _write(root / "rand", 3),
            "rand8": _write(root / "rand8", 4, subsampling=8),
            "rnnt": _write(root / "rnnt", 5, variant="rnnt"),
            "wide": _write(root / "wide", 6, **WIDE)}


def _pair(path, dtype=jnp.float32):
    """The JAX model of a checkpoint and the port's on the same weights."""
    jm = JP.Parakeet.from_pretrained(str(path), dtype=dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return jm, _port(jm, tdt)


def _port(jm, tdt, params=None):
    tree = params if params is not None else jm.params
    return TP.Parakeet(jm.config, from_jax_params(jax_tree_to_numpy(tree)), tdt)


@pytest.fixture(scope="module")
def rand(dirs):
    return _pair(dirs["rand"])


def _tokens(outs):
    return [(o.text, [s.tokens for s in o.segments]) for o in outs]


# -- frontend and layers ----------------------------------------------------


@pytest.mark.parametrize("n,window", [(16000, "hann"), (23456, "hamming"), (4000, "hann")])
def test_frontend_matches_jax(n, window):
    cfg = dataclasses.replace(JP.PreprocessConfig(), features=80, window=window)
    tcfg = TP.PreprocessConfig(**dataclasses.asdict(cfg))
    a = _audio(n, n)
    want = np.asarray(JP.log_mel_spectrogram(a, cfg))
    got = TP.log_mel_spectrogram(a, tcfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("size,periodic", [(400, False), (400, True), (7, False)])
def test_hamming_window_and_constant_stft_match_jax(size, periodic):
    from tpu_audio.core import dsp as jdsp

    w = tdsp.hamming_window(size, periodic=periodic)
    np.testing.assert_array_equal(w, jdsp.hamming_window(size, periodic=periodic))
    a = _audio(size, 3000)
    win = np.pad(w, (0, 512 - size)) if size < 512 else w
    want = np.asarray(jdsp.stft(jnp.asarray(a), win, 512, 160, pad_mode="constant"))
    got = tdsp.stft(torch.from_numpy(a), win, 512, 160, pad_mode="constant").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError):
        tdsp.stft(torch.from_numpy(a), win, 512, 160, pad_mode="edge")


def _layer_case(name, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name.startswith("conv2d"):
        groups = 4 if name == "conv2d_groups" else 1
        p = {"weight": f(8, 4 // groups, 3, 3), "bias": f(8)}
        x = f(2, 9, 7, 4)
        return p, (x,), dict(stride=(2, 2), padding=(1, 1), groups=groups)
    if name == "batch_norm":
        p = {"weight": f(6), "bias": f(6), "running_mean": f(6),
             "running_var": np.abs(f(6)) + 0.5}
        return p, (f(2, 5, 6),), {}
    suffix = "_l0" if name == "lstm_cell_l0" else ""
    p = {f"weight_ih{suffix}": f(32, 5), f"weight_hh{suffix}": f(32, 8),
         f"bias_ih{suffix}": f(32), f"bias_hh{suffix}": f(32)}
    return p, (f(3, 5), f(3, 8), f(3, 8)), {}


@pytest.mark.parametrize("name", ["conv2d", "conv2d_groups", "batch_norm", "lstm_cell",
                                  "lstm_cell_l0"])
def test_nn_layers_match_jax(name):
    p, args, kw = _layer_case(name, np.random.default_rng(len(name)))
    fn = name.split("_groups")[0].replace("_l0", "")
    want = getattr(jnn, fn)({k: jnp.asarray(v) for k, v in p.items()},
                            *map(jnp.asarray, args), **kw)
    got = getattr(tnn, fn)({k: torch.from_numpy(v) for k, v in p.items()},
                           *map(torch.from_numpy, args), **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


# -- encoder, predictor, joint ----------------------------------------------


def _mel_batch(jm, audios):
    """The JAX package's padded mel batch for ``audios`` (its bucket)."""
    mels = [np.asarray(JP.log_mel_spectrogram(a, jm.config.preprocess)[0]) for a in audios]
    t_max = max(m.shape[0] for m in mels)
    bucket = max(64, 1 << int(np.ceil(np.log2(max(t_max, 2)))))
    batch = np.zeros((len(mels), bucket, jm.config.preprocess.features), np.float32)
    for i, m in enumerate(mels):
        batch[i, : m.shape[0]] = m
    return batch, np.asarray([m.shape[0] for m in mels], np.int32)


@pytest.mark.parametrize("which", ["rand", "rand8"])
def test_encoder_matches_jax(dirs, which):
    jm, tm = _pair(dirs[which])
    batch, lengths = _mel_batch(jm, [_audio(10), _audio(11, 9000)])
    want, want_len = jm._encode(jm.params, jnp.asarray(batch), jnp.asarray(lengths))
    got, got_len = tm._encode(tm.params, torch.from_numpy(batch), torch.from_numpy(lengths))
    want = np.asarray(want)
    sf = jm.config.encoder.subsampling_factor
    assert sf == (8 if which == "rand8" else 4)
    assert got.shape == want.shape and got.shape[1] == batch.shape[1] // sf
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
    # the port's own mel batch: the same frames in the same bucket
    tb, tl = tm.mel_batch([_audio(10), _audio(11, 9000)])
    np.testing.assert_array_equal(tl.numpy(), lengths)
    np.testing.assert_allclose(tb.numpy(), batch, atol=1e-4, rtol=0)


def test_predict_step_and_joint_match_jax(rand):
    jm, tm = rand
    cfg = jm.config
    rng = np.random.default_rng(2)
    toks = np.asarray([cfg.blank_token, 3, 7], np.int32)
    h = rng.standard_normal((1, 3, cfg.pred_hidden)).astype(np.float32)
    c = rng.standard_normal((1, 3, cfg.pred_hidden)).astype(np.float32)
    frame = rng.standard_normal((3, cfg.encoder.d_model)).astype(np.float32)
    jp, jh, jc = JP._predict_step(jm.params, jnp.asarray(toks), jnp.asarray(h),
                                  jnp.asarray(c), cfg)
    tp, th, tc = TP._predict_step(tm.params, torch.from_numpy(toks), torch.from_numpy(h),
                                  torch.from_numpy(c), cfg)
    for g, w in ((tp, jp), (th, jh), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    want = np.asarray(JP._joint(jm.params, jnp.asarray(frame), jp, cfg))
    got = TP._joint(tm.params, torch.from_numpy(frame), tp, cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


# -- the decode loop ----------------------------------------------------------


@pytest.mark.parametrize("which", ["rand", "rnnt"])
def test_decode_loop_lattice_equals_jax(dirs, which):
    """Tokens, times, jumps and counts of the batched loop equal
    ``make_tdt_decoder``'s on the same features, 3 rows of different
    lengths."""
    jm, tm = _pair(dirs[which])
    assert jm.config.variant == ("rnnt" if which == "rnnt" else "tdt")
    batch, lengths = _mel_batch(jm, [_audio(20), _audio(21, 7000), _audio(22, 12000)])
    feats, out_lens = jm._encode(jm.params, jnp.asarray(batch), jnp.asarray(lengths))
    assert len(set(np.asarray(out_lens).tolist())) == 3
    want = [np.asarray(a) for a in jm._get_decoder(256)(jm.params, feats, out_lens)]
    dec = tm._get_decoder(256)
    got = dec(tm.params, torch.from_numpy(np.array(feats)),
              torch.from_numpy(np.array(out_lens)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[3].min() > 0  # every row emitted
    assert dec.stats["steps"] % 8 == 0 and dec.stats["reads"] == dec.stats["steps"] // 8 + 2


def test_decode_loop_matches_serial_reference(rand):
    """The port's loop against the JAX package's serial host reference of
    tests/test_parakeet.py on the same features."""
    from test_parakeet import _serial_tdt_reference

    jm, tm = rand
    batch, lengths = _mel_batch(jm, [_audio(23)])
    feats, out_lens = jm._encode(jm.params, jnp.asarray(batch), jnp.asarray(lengths))
    want = _serial_tdt_reference(jm, feats, int(out_lens[0]))
    toks, times, jumps, counts = tm._get_decoder(256)(
        tm.params, torch.from_numpy(np.array(feats)), torch.from_numpy(np.array(out_lens)))
    n = int(counts[0])
    assert n == len(want) > 0
    assert list(zip(toks[0, :n].tolist(), times[0, :n].tolist(), jumps[0, :n].tolist())) == want


def test_generate_batch_equals_jax(rand):
    jm, tm = rand
    audios = [_audio(30), _audio(31, 9000), _audio(32, 20000)]
    want, jal = jm.generate_batch_aligned(audios)
    got, tal = tm.generate_batch_aligned(audios)
    assert _tokens(got) == _tokens(want)
    assert [o.generation_token_count for o in got] == [o.generation_token_count for o in want]
    assert [[(t.id, t.start, t.duration) for t in a] for a in tal] == \
        [[(t.id, t.start, t.duration) for t in a] for a in jal]
    assert any(o.text for o in got)


def test_batch_against_single(rand):
    _, tm = rand
    a, b = _audio(40), _audio(41, 12000)
    both = tm.generate_batch([a, b])
    assert _tokens(both) == _tokens(tm.generate_batch([a]) + tm.generate_batch([b]))


def test_chunked_generate_equals_jax(rand):
    jm, tm = rand
    a = _audio(8, 16000 * 3)
    want = jm.generate(a, JParams(chunk_duration=1.0))
    got = tm.generate(a, TParams(chunk_duration=1.0))
    assert (got.text, [s.tokens for s in got.segments]) == \
        (want.text, [s.tokens for s in want.segments])
    assert [(s.start, s.end) for s in got.segments] == [(s.start, s.end) for s in want.segments]
    assert got.generation_token_count == want.generation_token_count > 0
    # the stream yields the same text, then the result
    events = list(tm.generate_stream(a, TParams(chunk_duration=1.0)))
    assert [e["type"] for e in events] == ["token", "result"]
    assert events[0]["text"] == got.text == events[1]["output"].text


# -- MLX trees ------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide(dirs):
    """The width-256 checkpoint in the JAX package: its f32 model and the
    tree MLX-packed to 8 bits (group 64), and the same two in bf16."""
    jm = JP.Parakeet.from_pretrained(str(dirs["wide"]), dtype=jnp.float32)
    jb = JP.Parakeet.from_pretrained(str(dirs["wide"]), dtype=jnp.bfloat16)
    return {"f32": (jm, jquant.quantize_tree(jm.params, bits=8, group_size=64)),
            "bf16": (jb, jquant.quantize_tree(jb.params, bits=8, group_size=64))}


def _spy_decode(monkeypatch, tm, audios):
    """generate_batch with ``qmm.quantized_matvec`` counted inside the
    decode loop alone: (outputs, calls, rows of each call, decode steps)."""
    batch, lengths = tm.mel_batch(audios)
    feats, out_lens = tm._encode(tm.params, batch, lengths)
    calls = []
    real = qmm.quantized_matvec

    def spy(x, *a, **kw):
        calls.append(x.shape[0])
        return real(x, *a, **kw)

    monkeypatch.setattr(qmm, "quantized_matvec", spy)
    dec = tm._get_decoder(tm.max_emit(feats.shape[1], 8192))
    dec(tm.params, feats, out_lens)
    monkeypatch.setattr(qmm, "quantized_matvec", real)
    return calls, dec.stats["steps"]


def test_mlx8_f32_equals_jax_with_three_kernel7_calls_a_step(wide, monkeypatch):
    """Both packages pack the same leaves (the prediction embedding and the
    joint's three products among them); f32 tokens equal, and each decode
    step calls kernel 7's wrapper 3 times at B rows."""
    jm, jq = wide["f32"]
    tm = _port(jm, torch.float32, jq)
    tq = tquant.quantize_tree(_port(jm, torch.float32).params, bits=8, group_size=64,
                              scheme="mlx")
    flat_j = jloading.flatten(jax_tree_to_numpy(jq))
    flat_t = jloading.flatten(tq)
    packed = sorted(k for k, v in flat_t.items() if isinstance(v, tquant.QuantizedTensor))
    assert packed == sorted(k for k, v in flat_j.items() if hasattr(v, "bits"))
    assert {"decoder.prediction.embed.weight", "joint.enc.weight", "joint.pred.weight",
            "joint.joint_net.weight"} <= set(packed)
    for k in packed:
        np.testing.assert_array_equal(flat_t[k].weight.numpy(),
                                      flat_j[k].weight.view(np.int32))
    audios = [_audio(50), _audio(51, 11000), _audio(52, 6000)]
    jmq = JP.Parakeet(jm.config, jq, jnp.float32)
    assert _tokens(tm.generate_batch(audios)) == _tokens(jmq.generate_batch(audios))
    calls, steps = _spy_decode(monkeypatch, tm, audios)
    assert steps > 0 and calls == [3] * (3 * steps)


BF16_LOGITS_RTOL = 5e-2  # bf16 joint logits of the two packages, of the largest


def _first_parting(jlat, tlat, jcount, tcount):
    """The first emission index where a row's lattices part, or None."""
    n = min(jcount, tcount)
    for k in range(n):
        if tuple(jlat[k]) != tuple(tlat[k]):
            return k
    return None if jcount == tcount else n


def test_mlx8_bf16_dense_embedding_against_jax(wide):
    """bf16, the 8-bit tree with the prediction embedding dense, from the
    JAX package's encoder features: every row's lattice equals the JAX
    loop's, or parts at a witnessed near tie. The JAX package's jitted
    bf16 loop keeps f32 precision between its products on the CPU (its
    logits are not bf16 values), the port rounds each product to bf16; so
    where they part, the port's top two (token or duration) must lie within
    the two packages' joint logits at that step, taken from the same state
    (the JAX step jitted on the port's LSTM state, last token and frame),
    and those within BF16_LOGITS_RTOL."""
    jm, jq = wide["bf16"]
    jq = dict(jq, decoder={"prediction": dict(jq["decoder"]["prediction"],
                                              embed=jm.params["decoder"]["prediction"]["embed"])})
    jmq = JP.Parakeet(jm.config, jq, jnp.bfloat16)
    tm = _port(jm, torch.bfloat16, jq)
    assert TP.prediction_dtype(tm.params, torch.bfloat16) == torch.bfloat16
    cfg, blank = jm.config, jm.config.blank_token
    batch, lengths = _mel_batch(jm, [_audio(53), _audio(54, 10000), _audio(59, 13000)])
    feats, out_lens = jmq._encode(jmq.params, jnp.asarray(batch, jnp.bfloat16),
                                  jnp.asarray(lengths))
    want = [np.asarray(a) for a in jmq._get_decoder(256)(jmq.params, feats, out_lens)]
    tf = torch.from_numpy(np.array(feats.astype(jnp.float32))).bfloat16()
    tl = torch.from_numpy(np.array(out_lens))
    dec = tm._get_decoder(256)
    trace = []
    got = dec(tm.params, tf, tl, trace=trace)
    jlat, tlat = np.stack(want[:3], -1), np.stack(got[:3], -1)

    @jax.jit
    def jstep(params, last, h, c, frame):
        pred, _, _ = JP._predict_step(params, last, h, c, cfg)
        return JP._joint(params, frame, pred.astype(jnp.bfloat16), cfg).astype(jnp.float32)

    equal = 0
    for row in range(tf.shape[0]):
        k = _first_parting(jlat[row], tlat[row], want[3][row], got[3][row])
        if k is None:
            equal += 1
            continue
        # the step of the row's k-th emission (or of its last step)
        st, emitted = dec.init_state(tm.params, tf), 0
        for s, (_, act, tok, _, logits) in enumerate(trace):
            if bool(act[row]) and int(tok[row]) != blank:
                if emitted == k:
                    break
                emitted += 1
            dec.step(tm.params, tf, tl, st)
        frame = feats[np.arange(tf.shape[0]), np.clip(st["time"].numpy(), 0, tf.shape[1] - 1)]
        jlog = np.asarray(jstep(jmq.params, jnp.asarray(st["last_tok"].numpy()),
                                jnp.asarray(st["h"].float().numpy(), jnp.bfloat16),
                                jnp.asarray(st["c"].float().numpy(), jnp.bfloat16), frame))[row]
        tlog = trace[s][4][row].numpy()
        diff = float(np.abs(jlog - tlog).max())
        part = slice(0, blank + 1) if jlat[row, k, 0] != tlat[row, k, 0] else slice(blank + 1, None)
        top = np.sort(tlog[part])[::-1]
        assert top[0] - top[1] <= diff <= BF16_LOGITS_RTOL * np.abs(jlog).max(), (row, k, top, diff)
    assert equal >= 1


def test_mlx8_bf16_packed_embedding_runs_and_repeats(wide, monkeypatch):
    """The JAX package raises on this tree in bf16 (its loop carries the
    LSTM state in bf16 while a packed embedding gives f32); the port
    carries it in f32 from the first step, runs and repeats."""
    jm, jq = wide["bf16"]
    with pytest.raises(TypeError):
        JP.Parakeet(jm.config, jq, jnp.bfloat16).generate_batch([_audio(55)])
    tm = _port(jm, torch.bfloat16, jq)
    assert TP.prediction_dtype(tm.params, torch.bfloat16) == torch.float32
    st = tm._get_decoder(64).init_state(tm.params, torch.zeros((2, 4, 256), dtype=torch.bfloat16))
    assert st["h"].dtype == st["c"].dtype == torch.float32
    audios = [_audio(55), _audio(56, 7000)]
    first = tm.generate_batch(audios)
    assert _tokens(first) == _tokens(tm.generate_batch(audios))
    assert sum(o.generation_token_count for o in first) > 0
    calls, steps = _spy_decode(monkeypatch, tm, audios)
    assert calls == [2] * (3 * steps)


@pytest.mark.parametrize("bits", [4, 8])
def test_mlx_checkpoint_loads_and_equals_jax(dirs, tmp_path, bits):
    """A checkpoint stored MLX-packed with a ``quantization`` block: the
    port's ``from_pretrained`` tags the same leaves and decodes the JAX
    package's tokens (f32)."""
    import shutil

    path = _pack(shutil.copytree(dirs["wide"], tmp_path / f"q{bits}"), bits)
    jm = JP.Parakeet.from_pretrained(str(path), dtype=jnp.float32)
    tm = TP.Parakeet.from_pretrained(str(path), dtype=torch.float32, device="cpu")
    w = tm.params["joint"]["joint_net"]["weight"]
    assert isinstance(w, tquant.QuantizedTensor) and w.bits == bits and w.group_size == 64
    audios = [_audio(57), _audio(58, 9000)]
    assert _tokens(tm.generate_batch(audios)) == _tokens(jm.generate_batch(audios))


# -- CTC ------------------------------------------------------------------------


def _write_ctc(path, seed):
    """A CTC checkpoint: the fixture's encoder, a ``ctc_decoder`` conv head
    (``decoder_layers.0``, MLX layout), the vocabulary under ``decoder``
    and no joint."""
    from safetensors.numpy import save_file

    path = _write(path, seed)
    cfg = json.loads((path / "config.json").read_text())
    vocab = cfg["joint"]["vocabulary"]
    cfg["decoder"] = {"vocabulary": vocab}
    cfg.pop("joint")
    cfg.pop("decoding")
    (path / "config.json").write_text(json.dumps(cfg))
    w = {k: v for k, v in jloading.load_safetensors(path).items()
         if k.startswith("encoder.")}
    rng = np.random.default_rng(seed)
    d = cfg["encoder"]["d_model"]
    w["ctc_decoder.decoder_layers.0.weight"] = (
        rng.standard_normal((len(vocab) + 1, 1, d)) / np.sqrt(d)).astype(np.float32)
    w["ctc_decoder.decoder_layers.0.bias"] = (0.05 * rng.standard_normal(len(vocab) + 1)
                                              ).astype(np.float32)
    save_file(w, str(path / "model.safetensors"))
    return path


def test_ctc_route_equals_jax(tmp_path):
    jm, tm = _pair(_write_ctc(tmp_path / "ctc", 7))
    assert tm.config.variant == jm.config.variant == "ctc"
    audios = [_audio(60), _audio(61, 8000)]
    want, jal = jm.generate_batch_aligned(audios)
    got, tal = tm.generate_batch_aligned(audios)
    assert _tokens(got) == _tokens(want) and any(o.text for o in got)
    assert [[(t.id, t.start, t.duration) for t in a] for a in tal] == \
        [[(t.id, t.start, t.duration) for t in a] for a in jal]
    # the collapse against a plain argmax-collapse of the port's own logits
    batch, lengths = tm.mel_batch(audios[:1])
    feats, out_len = tm._encode(tm.params, batch, lengths)
    best = tm._ctc_logits(tm.params, feats).argmax(-1)[0, : int(out_len[0])].tolist()
    blank = tm.config.blank_token
    ids = [t for i, t in enumerate(best) if t != blank and (i == 0 or best[i - 1] != t)]
    assert [t.id for t in tal[0]] == ids


# -- nemo_alignment -------------------------------------------------------------


def _seq(na, words, t0=0.0, step=0.1, id0=0):
    return [na.AlignedToken(id=id0 + i, text=(" " if i else "") + w, start=t0 + i * step,
                            duration=0.08) for i, w in enumerate(words)]


def _dump(x):
    if isinstance(x, list):
        return [_dump(v) for v in x]
    if dataclasses.is_dataclass(x):
        return {k: _dump(v) for k, v in dataclasses.asdict(x).items()}
    return x


ALIGN_CASES = {
    "sentences": lambda na: na.sentences_to_result(na.tokens_to_sentences(
        [na.AlignedToken(1, "Hi", 0.0, 0.08), na.AlignedToken(2, ".", 0.1, 0.08),
         na.AlignedToken(3, " there", 0.2, 0.08), na.AlignedToken(4, "!", 0.3, 0.08),
         na.AlignedToken(5, " ok", 0.4, 0.08)])),
    "period_in_word": lambda na: na.tokens_to_sentences(
        [na.AlignedToken(1, "3", 0.0, 0.08), na.AlignedToken(2, ".", 0.1, 0.08),
         na.AlignedToken(3, "14", 0.2, 0.08), na.AlignedToken(4, " done", 0.3, 0.08)]),
    "disjoint": lambda na: na.merge_token_sequences(
        _seq(na, ["a", "b"]), _seq(na, ["c", "d"], t0=5.0, id0=10), 1.0),
    "contiguous": lambda na: na.merge_token_sequences(
        _seq(na, ["the", "cat", "sat", "on"]),
        _seq(na, ["sat", "on", "the", "mat"], t0=0.2, id0=2), 0.5),
    "repeated_phrase": lambda na: na.merge_token_sequences(
        _seq(na, ["go", "go", "go", "stop"]), _seq(na, ["go", "stop", "now"], t0=0.2), 0.4),
    "lcs": lambda na: na.merge_longest_common_subsequence(
        _seq(na, ["a", "b", "x", "c", "d"]), _seq(na, ["b", "y", "c", "e"], t0=0.1, id0=1),
        0.4),
    "contiguous_direct": lambda na: na.merge_longest_contiguous(
        _seq(na, ["a", "b", "c"]), _seq(na, ["b", "c", "d"], t0=0.1, id0=1), 0.4),
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_nemo_alignment_matches_jax(case):
    def run(na):
        try:
            return _dump(ALIGN_CASES[case](na))
        except Exception as e:  # noqa: BLE001 - the same error in both
            return type(e).__name__

    assert run(tna) == run(jna)


# -- load_model, CLI, server ------------------------------------------------------


def test_random_params_keep_frames_apart():
    """``init_random_params`` at 24 layers (the published depth, width 256):
    the encoder's frames stay apart (mean cosine between valid frames below
    0.9; unscaled residual branches average them into one) and the random
    joint's decisions vary in token and duration."""
    cfg = TP.ParakeetConfig(
        encoder=TP.ConformerConfig(feat_in=128, n_layers=24, d_model=256, n_heads=4,
                                   subsampling_conv_channels=32),
        preprocess=TP.PreprocessConfig(features=128),
        vocabulary=[chr(ord("a") + i % 26) for i in range(64)], pred_hidden=64,
        joint_hidden=64)
    m = TP.Parakeet(cfg, TP.init_random_params(cfg, seed=0, dtype=torch.float32), torch.float32)
    batch, lengths = m.mel_batch([_audio(90, 16000 * 5)])
    feats, out_len = m._encode(m.params, batch, lengths)
    x = feats[0, : int(out_len[0])]
    x = x / x.norm(dim=-1, keepdim=True)
    assert float((x @ x.T).mean()) < 0.9
    toks, _, jumps, counts = m._get_decoder(64)(m.params, feats, out_len)
    n = int(counts[0])
    assert len(set(toks[0, :n].tolist())) >= 5 and len(set(jumps[0, :n].tolist())) >= 2


def test_load_model_returns_port_parakeet(dirs):
    import inspect

    m = tload_model(str(dirs["rand"]), dtype=torch.float32, device="cpu")
    assert isinstance(m, TP.Parakeet) and m.config.variant == "tdt"
    assert m.device.type == "cpu" and m.config.blank_token == 16
    sig = inspect.signature(TP.Parakeet.from_pretrained)
    assert sig.parameters["device"].default == "cuda"
    with pytest.raises(ValueError, match="quantiz"):
        tload_model(str(dirs["rand"]), dtype=torch.float32, device="cpu", quantize="w8a8")


def test_from_jax_params_carries_the_parakeet_tree(dirs, rand):
    """The port's own loading and the JAX tree carried across give the same
    tree, leaf for leaf."""
    jm, tm = rand
    own = TP.Parakeet.from_pretrained(str(dirs["rand"]), dtype=torch.float32, device="cpu")
    a, b = jloading.flatten(own.params), jloading.flatten(tm.params)
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_cli_stt_on_parakeet(dirs, tmp_path, capsys):
    from tpu_audio_torch.cli import stt

    from tpu_audio_torch.core.audio_io import load_audio

    wav = tmp_path / "in.wav"
    wav.write_bytes(_wav_bytes(_audio(70, 24000)))
    assert stt.main([str(wav), "--model", str(dirs["rand"]), "--device", "cpu",
                     "--format", "json", "--language", "en", "--kv-bits", "8",
                     "--max-tokens", "8192", "--chunk-duration", "1.0"]) == 0
    out = json.loads(capsys.readouterr().out)
    # the CLI loads bf16 by default; compare with the port's own bf16 model
    bf = TP.Parakeet.from_pretrained(str(dirs["rand"]), dtype=torch.bfloat16, device="cpu")
    want = bf.generate(load_audio(str(wav), sample_rate=16000)[0],
                       TParams(max_tokens=8192, chunk_duration=1.0))
    assert out["text"] == want.text
    assert [s["start"] for s in out["segments"]] == [s.start for s in want.segments]


def _wav_bytes(audio):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("slots", [1, 2])
def test_server_on_parakeet(rand, slots):
    """A Parakeet server at any slot count builds no STT engine worker and
    answers transcriptions (and their stream) through ``generate`` with the
    JAX package's text."""
    from tpu_audio_torch.cli.serve import build_server

    jm, tm = rand
    srv = build_server(tm, "stt", "parakeet", port=0, slots=slots)
    assert srv.stt_worker is None
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    clip = _audio(80 + slots, 20000)
    try:
        req = urllib.request.Request(f"{url}/v1/audio/transcriptions",
                                     data=_wav_bytes(clip))
        with urllib.request.urlopen(req, timeout=120) as r:
            res = json.loads(r.read())
        req = urllib.request.Request(f"{url}/v1/audio/transcriptions/stream",
                                     data=_wav_bytes(clip))
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    pcm = (clip * 32767).clip(-32768, 32767).astype(np.int16).astype(np.float32) / 32768.0
    want = jm.generate(pcm)
    assert res["text"] == want.text
    assert [s["start"] for s in res["segments"]] == [s.start for s in want.segments]
    assert lines[-1]["type"] == "result" and lines[-1]["text"] == want.text
