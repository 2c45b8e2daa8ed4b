"""PyTorch port kernels' plain versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU), on the same numpy inputs.

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds
each of them against the plain versions tested here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import kv_cache as jkv
from tpu_audio.core import quant as jquant
from tpu_audio.models.stt import whisper as JW
from tpu_audio.ops import pallas_fused_decoder as JF
from tpu_audio.ops import pallas_kv_attention as JK
from tpu_audio_torch.convert import MLXLeaf, from_jax_params
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.ops import fused_decoder as TF
from tpu_audio_torch.ops import kv_attention as TK
from tpu_audio_torch.ops import mel as TM

torch.set_num_threads(1)

# the fused-decoder config of tests/test_fused_decoder.py
CFG = dict(num_mel_bins=80, d_model=256, encoder_layers=1,
           encoder_attention_heads=4, encoder_ffn_dim=1024,
           decoder_layers=2, decoder_attention_heads=4,
           decoder_ffn_dim=1024, vocab_size=128,
           max_source_positions=150, max_target_positions=64)


def jax_tree_to_numpy(tree):
    """JAX param tree -> numpy leaves, Int8Tensor leaves as (w, s) pairs and
    QuantizedTensor leaves as ``convert.MLXLeaf``."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jquant.Int8Tensor):
        return (np.asarray(tree.weight), np.asarray(tree.scale))
    if isinstance(tree, jquant.QuantizedTensor):
        return MLXLeaf(np.asarray(tree.weight), np.asarray(tree.scales),
                       np.asarray(tree.biases), tree.group_size, tree.bits)
    return np.asarray(tree)


@pytest.mark.parametrize("t,f,m", [(300, 201, 128), (37, 101, 80)])
def test_fused_log_mel_ref_matches_jax(monkeypatch, t, f, m):
    from jax.experimental import pallas as pl

    from tpu_audio.ops import pallas_mel as PM

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    rng = np.random.default_rng(0)
    re = rng.standard_normal((t, f)).astype(np.float32)
    im = rng.standard_normal((t, f)).astype(np.float32)
    fb = np.abs(rng.standard_normal((f, m)).astype(np.float32)) * 0.01
    want = np.asarray(PM.fused_log_mel(jnp.asarray(re), jnp.asarray(im),
                                       jnp.asarray(fb)))
    got = TM.fused_log_mel(torch.from_numpy(re), torch.from_numpy(im),
                           torch.from_numpy(fb)).numpy()
    assert got.shape == (t, m)
    np.testing.assert_allclose(got, want, atol=1e-5)  # the JAX test's bound


@pytest.mark.parametrize("g", [1, 2])
def test_kv_quantize_codes_match_jax_bit_for_bit(g):
    """Codes, scales and biases, and their dequantized values."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4, 300, 64)) * 0.7).astype(np.float32)
    jq, js, jb = jkv._quantize(jnp.asarray(x), n_groups=g, bits=8)
    tq, ts, tb = tkv._quantize(torch.from_numpy(x), n_groups=g, bits=8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        tkv._dequantize(tq, ts, tb, torch.float32).numpy(),
        np.asarray(jkv._dequantize(jq, js, jb, jnp.float32)))


@pytest.mark.parametrize("h,s,hd,g,valid", [(4, 300, 64, 1, 300),
                                            (2, 128, 64, 2, 128),
                                            (2, 256, 32, 1, 57)])
def test_decode_attention_int8_ref_matches_jax(h, s, hd, g, valid):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((h, s, hd)).astype(np.float32)
    v = rng.standard_normal((h, s, hd)).astype(np.float32)
    q = rng.standard_normal((h, 1, hd)).astype(np.float32) * 0.3
    sm = 1.0 / math.sqrt(hd)
    kt, ks, kb = JK.quantize_kv_transposed(jnp.asarray(k), n_groups=g)
    vt, vs, vb = JK.quantize_kv_transposed(jnp.asarray(v), n_groups=g)
    want = np.asarray(JK.decode_attention_int8(
        jnp.asarray(q), kt, ks, kb, vt, vs, vb,
        jnp.asarray([valid], jnp.int32), sm_scale=sm, interpret=True))
    kq = tkv._quantize(torch.from_numpy(k), n_groups=g)
    vq = tkv._quantize(torch.from_numpy(v), n_groups=g)
    got = TK.decode_attention_int8(torch.from_numpy(q), *kq, *vq, valid,
                                   sm_scale=sm).numpy()
    assert got.shape == (h, 1, hd) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def fused_setup():
    cfg = JW.WhisperConfig(**CFG)
    params = JW.init_params(cfg, seed=3, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    enc = jnp.asarray(rng.standard_normal(
        (1, cfg.max_source_positions, cfg.d_model)).astype(np.float32) * 0.3)
    cross_k, cross_v = JW._cross_kv(params, enc, cfg)
    # w8 decoder weights, as the deployment path packs them (quantized
    # eagerly; the JAX pack re-quantizes dense weights under jit, where XLA
    # turns the /127 into a multiply and moves scales by one ulp)
    params["model"]["decoder"] = jquant.quantize_tree(
        params["model"]["decoder"], scheme="w8a8")
    jpack = JF.pack_decoder_weights(params, cfg)
    jcross = JF.quantize_cross_kv(cross_k, cross_v, chunk=cfg.d_model // 2)
    tcfg = TW.WhisperConfig(**CFG)
    tparams = from_jax_params(jax_tree_to_numpy(params))
    tpack = TF.pack_decoder_weights(tparams, tcfg)
    tcross = TF.quantize_cross_kv(torch.tensor(np.asarray(cross_k)),
                                  torch.tensor(np.asarray(cross_v)))
    return cfg, tcfg, jpack, jcross, tpack, tcross


def test_fused_pack_and_cross_codes_match_jax(fused_setup):
    cfg, _, jpack, jcross, tpack, tcross = fused_setup
    d, ffn = cfg.d_model, cfg.decoder_ffn_dim
    n_in = 6 * d + ffn
    ws = np.asarray(jpack.wstream)
    np.testing.assert_array_equal(tpack.w_in.numpy(), ws[:, :n_in])
    # the port stores fc2 output-major; the JAX stream holds it input-major
    np.testing.assert_array_equal(tpack.w_fc2.numpy(),
                                  ws[:, n_in:].transpose(0, 2, 1))
    np.testing.assert_array_equal(tpack.scales[:, :n_in].numpy(),
                                  np.asarray(jpack.row_scales)[:, :n_in])
    bp = np.asarray(jpack.biaspack)
    np.testing.assert_array_equal(tpack.scales[:, n_in:].numpy(), bp[:, 12])
    np.testing.assert_array_equal(tpack.biases[:, n_in:].numpy(), bp[:, 11])
    np.testing.assert_array_equal(tpack.ln.numpy(), bp[:, [0, 1, 5, 6, 9, 10]])
    s = cfg.max_source_positions
    for t, j in zip(tcross, jcross):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:, :s])


@pytest.mark.parametrize("offset", [0, 5])
def test_fused_stack_ref_matches_jax(fused_setup, offset):
    cfg, tcfg, jpack, jcross, tpack, tcross = fused_setup
    d, L = cfg.d_model, cfg.decoder_layers
    rng = np.random.default_rng(1)
    s_max = 64
    kc = rng.standard_normal((L, s_max, d)).astype(np.float32) * 0.2
    vc = rng.standard_normal((L, s_max, d)).astype(np.float32) * 0.2
    kc[:, offset:] = 0
    vc[:, offset:] = 0
    x0 = (rng.standard_normal(d) * 0.5).astype(np.float32)
    x8 = jnp.zeros((8, d), jnp.float32).at[0].set(jnp.asarray(x0))
    jy, jk, jv = JF.fused_stack(
        jpack, *jcross, jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), x8, offset, cfg=cfg,
        s_src=cfg.max_source_positions, interpret=True)
    tkc = torch.from_numpy(kc).to(torch.bfloat16)
    tvc = torch.from_numpy(vc).to(torch.bfloat16)
    ty, tk, tv = TF.fused_stack(tpack, *tcross, tkc, tvc, torch.from_numpy(x0),
                                offset, cfg=tcfg, s_src=cfg.max_source_positions)
    # f32 sums in another order can move an int8 activation code by one
    # step; 1e-3 of the output's scale bounds a few such flips per layer
    for got, want in ((ty, np.asarray(jy)[0]), (tk, np.asarray(jk)[:, 0]),
                      (tv, np.asarray(jv)[:, 0])):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-3, err
    # the new rows were written into the caches in place, as bf16
    np.testing.assert_array_equal(tkc[:, offset].float().numpy(),
                                  tk.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(tvc[:, offset].float().numpy(),
                                  tv.to(torch.bfloat16).float().numpy())


def test_int8_matmul_matches_jax():
    from tpu_audio_torch.core import quant as tquant

    rng = np.random.default_rng(3)
    w = rng.standard_normal((48, 256)).astype(np.float32) * 0.1
    x = rng.standard_normal((5, 256)).astype(np.float32)
    jt = jquant.quantize_int8_jax(jnp.asarray(w))
    tt = tquant.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tt.weight.numpy(), np.asarray(jt.weight))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jt))
    got = tquant.int8_matmul(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quantize_tree_selects_the_same_leaves():
    from tpu_audio_torch.core import quant as tquant

    cfg = JW.WhisperConfig(**CFG)
    params = JW.init_params(cfg, seed=0, dtype=jnp.float32)
    jq = jquant.quantize_tree(params["model"]["decoder"], scheme="w8a8")
    tq = tquant.quantize_tree(from_jax_params(jax_tree_to_numpy(
        params["model"]["decoder"])))

    def kinds(tree):
        if isinstance(tree, dict):
            return {k: kinds(v) for k, v in tree.items()}
        return isinstance(tree, (jquant.Int8Tensor, tquant.Int8Tensor))

    assert kinds(jq) == kinds(tq)
    np.testing.assert_array_equal(
        tq["layers"]["fc1"]["weight"].weight.numpy(),
        np.asarray(jq["layers"]["fc1"]["weight"].weight))


def _lanes_inputs(cfg, jpack, n, rng):
    """Per-lane bf16 self caches and int8 cross K/V from distinct encoder
    outputs (the JAX package's quantisation, padded to its stream chunk)."""
    d, L = cfg.d_model, cfg.decoder_layers
    params = JW.init_params(cfg, seed=3, dtype=jnp.float32)
    kc = (rng.standard_normal((n, L, 64, d)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((n, L, 64, d)) * 0.2).astype(np.float32)
    cross = []
    for _ in range(n):
        e = jnp.asarray(rng.standard_normal(
            (1, cfg.max_source_positions, d)).astype(np.float32) * 0.3)
        cross.append(JF.quantize_cross_kv(*JW._cross_kv(params, e, cfg), chunk=d // 2))
    cross = [np.stack([np.asarray(c[i]) for c in cross]) for i in range(4)]
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    return kc, vc, cross, x


def _stacked(lanes, slots, per_lane, fill):
    """Scatter per-lane arrays into a stacked [slots, ...] torch state."""
    out = torch.full((slots,) + per_lane.shape[1:], fill, dtype=torch.float32)
    out[torch.as_tensor(lanes)] = torch.from_numpy(np.ascontiguousarray(per_lane)).float()
    return out


def test_fused_stack_lanes_ref_matches_jax(fused_setup):
    """Three lanes at slots [2, 0, 3] of a 4-slot state (offsets 5, 0, 33,
    as tests/test_fused_decoder.py:260) against the JAX lanes kernel in
    interpret mode; the new rows land at each lane's slot and offset, and
    nothing else in the caches moves."""
    cfg, tcfg, jpack, _, tpack, _ = fused_setup
    d, L, s = cfg.d_model, cfg.decoder_layers, cfg.max_source_positions
    n, slots, lanes, offs = 3, 4, [2, 0, 3], [5, 0, 33]
    kc, vc, cross, x = _lanes_inputs(cfg, jpack, n, np.random.default_rng(7))
    off8 = np.zeros((8,), np.int32)
    off8[:n] = offs
    x8 = np.zeros((8, d), np.float32)
    x8[:n] = x
    jy, jk, jv = JF.fused_stack_lanes(
        jpack, *(jnp.asarray(c) for c in cross), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(x8), off8, cfg=cfg, s_src=s,
        interpret=True)
    tkc = _stacked(lanes, slots, kc, 0.7).to(torch.bfloat16)
    tvc = _stacked(lanes, slots, vc, -0.7).to(torch.bfloat16)
    before_k, before_v = tkc.clone(), tvc.clone()
    ck, ks, cv, vs = (_stacked(lanes, slots, c[:, :, :s], 0) for c in cross)
    ck, cv = ck.to(torch.int8), cv.to(torch.int8)
    ty, tk, tv = TF.fused_stack_lanes(
        tpack, ck, ks, cv, vs, tkc, tvc, torch.from_numpy(x),
        torch.tensor(offs, dtype=torch.int32), torch.tensor(lanes, dtype=torch.int32),
        cfg=tcfg, s_src=s)
    assert ty.shape == (n, d) and tk.shape == (L, n, d)
    # the bound of test_fused_stack_ref_matches_jax: f32 sums in another
    # order can move an int8 activation code by one step
    for got, want in ((ty, np.asarray(jy)[:n]), (tk, np.asarray(jk)[:, :n]),
                      (tv, np.asarray(jv)[:, :n])):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-3, err
    want_k, want_v = before_k.clone(), before_v.clone()
    for m, (slot, off) in enumerate(zip(lanes, offs)):
        want_k[slot, :, off] = tk[:, m].to(torch.bfloat16)
        want_v[slot, :, off] = tv[:, m].to(torch.bfloat16)
    assert torch.equal(tkc, want_k) and torch.equal(tvc, want_v)


def test_fused_stack_lanes_ref_lanes_equal_b1(fused_setup):
    """Eight lanes (offsets of tests/test_fused_decoder.py:376, one at the
    cache's last row) in shuffled slots: each lane equals fused_stack_ref
    run alone on its inputs, and an offset past the cache clamps to its
    last row."""
    cfg, tcfg, jpack, _, tpack, _ = fused_setup
    d, s = cfg.d_model, cfg.max_source_positions
    n, lanes = 8, [5, 2, 7, 0, 3, 6, 1, 4]
    offs = [5, 0, 33, 12, 1, 63, 7, 20]
    kc, vc, cross, x = _lanes_inputs(cfg, jpack, n, np.random.default_rng(21))
    tkc = _stacked(lanes, n, kc, 0).to(torch.bfloat16)
    tvc = _stacked(lanes, n, vc, 0).to(torch.bfloat16)
    ck, ks, cv, vs = (_stacked(lanes, n, c[:, :, :s], 0) for c in cross)
    ck, cv = ck.to(torch.int8), cv.to(torch.int8)
    solo_k, solo_v = tkc.clone(), tvc.clone()
    over = offs[:5] + [64 + 9] + offs[6:]  # lane 5 past the 64-row cache
    y, nk, nv = TF.fused_stack_lanes(
        tpack, ck, ks, cv, vs, tkc, tvc, torch.from_numpy(x),
        torch.tensor(over, dtype=torch.int32), torch.tensor(lanes, dtype=torch.int32),
        cfg=tcfg, s_src=s)
    for m, (slot, off) in enumerate(zip(lanes, offs)):
        y1, k1, v1 = TF.fused_stack_ref(
            tpack, ck[slot], ks[slot], cv[slot], vs[slot], solo_k[slot], solo_v[slot],
            torch.from_numpy(x[m]), off, cfg=tcfg, s_src=s)
        for got, want in ((y[m], y1), (nk[:, m], k1), (nv[:, m], v1)):
            assert float((got - want).abs().max() / want.abs().max()) < 1e-5, m
    assert torch.equal(tkc, solo_k) and torch.equal(tvc, solo_v)


def test_fused_stack_lanes_ref_taps_every_gemv_input(fused_setup):
    """The plain version's tap holds each GEMV input's int8 codes, scale and
    unrounded values, lane by lane as fused_stack_ref's: the q/k/v codes
    reproduce the new k rows through the packed weights, and each code is
    its unrounded value rounded."""
    cfg, tcfg, jpack, _, tpack, _ = fused_setup
    d, ffn, L, s = cfg.d_model, cfg.decoder_ffn_dim, cfg.decoder_layers, \
        cfg.max_source_positions
    n, lanes, offs = 2, [1, 0], [3, 9]
    kc, vc, cross, x = _lanes_inputs(cfg, jpack, n, np.random.default_rng(5))
    tkc = _stacked(lanes, n, kc, 0).to(torch.bfloat16)
    tvc = _stacked(lanes, n, vc, 0).to(torch.bfloat16)
    ck, ks, cv, vs = (_stacked(lanes, n, c[:, :, :s], 0) for c in cross)
    ck, cv = ck.to(torch.int8), cv.to(torch.int8)
    kmax = max(d, ffn)
    tap = (torch.zeros((L, 6, n, kmax), dtype=torch.int8), torch.zeros((L, 6, n)),
           torch.zeros((L, 6, n, kmax)))
    _, nk, _ = TF.fused_stack_lanes(
        tpack, ck, ks, cv, vs, tkc.clone(), tvc.clone(), torch.from_numpy(x),
        torch.tensor(offs, dtype=torch.int32), torch.tensor(lanes, dtype=torch.int32),
        cfg=tcfg, s_src=s, tap=tap)
    for m, (slot, off) in enumerate(zip(lanes, offs)):
        solo = (torch.zeros((L, 6, kmax), dtype=torch.int8), torch.zeros((L, 6)), None)
        TF.fused_stack_ref(tpack, ck[slot], ks[slot], cv[slot], vs[slot], tkc[slot].clone(),
                           tvc[slot].clone(), torch.from_numpy(x[m]), off, cfg=tcfg,
                           s_src=s, tap=solo)
        assert torch.equal(tap[0][:, :, m], solo[0]) and torch.equal(tap[1][:, :, m], solo[1])
        for li in range(L):
            codes, xs = tap[0][li, 0, m, :d].double(), float(tap[1][li, 0, m])
            w, sc, bi = (tpack.w_in[li, d:2 * d], tpack.scales[li, d:2 * d],
                         tpack.biases[li, d:2 * d])
            k = (w.double() @ codes).float() * (sc * xs) + bi
            assert torch.equal(k, nk[li, m])
    widths = torch.tensor([d] * 5 + [ffn])
    used = torch.arange(kmax)[None, :] < widths[:, None]  # [6, kmax]
    for m in range(n):
        pre, codes = tap[2][:, :, m], tap[0][:, :, m].float()
        assert torch.equal(torch.where(used, torch.round(pre), 0.0), codes)
        assert bool((tap[1][:, :, m] > 0).all())


def test_supported_lanes_states_the_kernel_limit():
    large_v3 = TW.WhisperConfig(num_mel_bins=128, d_model=1280, decoder_layers=32,
                                decoder_attention_heads=20, decoder_ffn_dim=5120)
    assert all(TF.supported_lanes(large_v3, n) for n in range(1, TF.MAX_LANES + 1))
    assert not TF.supported_lanes(large_v3, 0)
    assert not TF.supported_lanes(large_v3, TF.MAX_LANES + 1)
    wide = TW.WhisperConfig(d_model=1280, decoder_attention_heads=20,
                            decoder_ffn_dim=9216)  # 32 x 9216 B > 227 KB
    assert TF.supported_lanes(wide, 8) and not TF.supported_lanes(wide, 32)


# -- kernel 5: the Llama decoder stack (fused_llama_stack) ----------------------

from tpu_audio.models import llama as JL  # noqa: E402
from tpu_audio.ops import pallas_fused_llama as JFL  # noqa: E402
from tpu_audio_torch.models import llama as TL  # noqa: E402
from tpu_audio_torch.ops import fused_llama as TFL  # noqa: E402

# the config of tests/test_fused_llama.py:17
LLAMA = dict(hidden_size=1024, num_hidden_layers=2, intermediate_size=2048,
             num_attention_heads=8, num_key_value_heads=4, head_dim=128,
             vocab_size=96, rope_theta=10000.0, tie_word_embeddings=True,
             max_position_embeddings=128)
LLAMA3 = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
_LLAMA_SETUPS = {}


def _llama_setup(variant):
    """JAX and port packs of one w8a8 tree, with non-unit norm weights
    (unit norms would hide a wrong norm row): ``base``, ``qk_norm`` or
    ``llama3`` (NTK-scaled RoPE)."""
    if variant not in _LLAMA_SETUPS:
        kw = dict(LLAMA, qk_norm=variant == "qk_norm",
                  rope_scaling=LLAMA3 if variant == "llama3" else None)
        jcfg, tcfg = JL.LlamaConfig(**kw), TL.LlamaConfig(**kw)
        params = JL.init_random_params(jcfg, seed=5, dtype=jnp.float32)
        rng = np.random.default_rng(7)
        lp = params["model"]["layers"]
        for name in ("input_layernorm", "post_attention_layernorm"):
            lp[name]["weight"] = jnp.asarray(1 + 0.2 * rng.standard_normal((2, 1024)),
                                             jnp.float32)
        if jcfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                lp["self_attn"][name]["weight"] = jnp.asarray(
                    1 + 0.3 * rng.standard_normal((2, 128)), jnp.float32)
        params = jquant.quantize_tree(params, scheme="w8a8")
        tparams = from_jax_params(jax_tree_to_numpy(params))
        _LLAMA_SETUPS[variant] = (jcfg, tcfg, JFL.pack_llama_weights(params, jcfg),
                                  TFL.pack_llama_weights(tparams, tcfg))
    return _LLAMA_SETUPS[variant]


@pytest.mark.parametrize("variant", ["base", "qk_norm"])
def test_fused_llama_pack_matches_jax(variant):
    """The same int8 rows and scales as the TPU pack, in the checkpoint's
    head order (the TPU pack permutes q rows and o columns)."""
    jcfg, _, jpack, tpack = _llama_setup(variant)
    d, ffn = jcfg.hidden_size, jcfg.intermediate_size
    dkv = jcfg.num_key_value_heads * 128
    perm = JFL._gqa_perm(jcfg.num_attention_heads, jcfg.num_key_value_heads, 128)
    ws, rs = np.asarray(jpack.wstream), np.asarray(jpack.row_scales)
    norm = np.asarray(jpack.normpack)
    w, sc = tpack.w_in.numpy(), tpack.scales.numpy()
    q, o = slice(0, d), slice(d + 2 * dkv, 2 * d + 2 * dkv)
    np.testing.assert_array_equal(w[:, q][:, perm], ws[:, q])
    np.testing.assert_array_equal(sc[:, q][:, perm], rs[:, q])
    np.testing.assert_array_equal(w[:, d:d + 2 * dkv], ws[:, d:d + 2 * dkv])
    np.testing.assert_array_equal(w[:, o][:, :, perm], ws[:, o])
    np.testing.assert_array_equal(w[:, o.stop:], ws[:, o.stop:o.stop + 2 * ffn])
    np.testing.assert_array_equal(sc[:, d:o.stop + 2 * ffn], rs[:, d:o.stop + 2 * ffn])
    np.testing.assert_array_equal(tpack.w_down.numpy(),
                                  ws[:, o.stop + 2 * ffn:].transpose(0, 2, 1))
    np.testing.assert_array_equal(sc[:, o.stop + 2 * ffn:], norm[:, 2])
    np.testing.assert_array_equal(tpack.norms[:, :2].numpy(), norm[:, :2])
    if jcfg.qk_norm:
        np.testing.assert_array_equal(tpack.norms[:, 2].numpy()[:, perm], norm[:, 3])
        np.testing.assert_array_equal(tpack.norms[:, 3, :dkv].numpy(), norm[:, 4, :dkv])
    # the JAX pack computes its table under jit, where XLA rewrites the
    # divisions and moves some entries by one ulp
    np.testing.assert_allclose(np.tile(tpack.inv_freq.numpy(), 2),
                               np.asarray(jpack.winv)[0], rtol=3e-7)


@pytest.mark.parametrize("variant,offset,valid_from", [
    ("base", 0, 0), ("base", 5, 0), ("base", 40, 0), ("base", 40, 7),
    ("qk_norm", 5, 0), ("qk_norm", 40, 7), ("llama3", 40, 7)])
def test_fused_llama_stack_ref_matches_jax(variant, offset, valid_from):
    """y, newk and newv against the TPU kernel in interpret mode, and the
    new rows written into the caches in place as bf16."""
    jcfg, tcfg, jpack, tpack = _llama_setup(variant)
    d, L = jcfg.hidden_size, jcfg.num_hidden_layers
    dkv = jcfg.num_key_value_heads * 128
    rng = np.random.default_rng(offset + 10 * valid_from)
    kc = jnp.asarray(rng.standard_normal((L, 64, dkv)) * 0.3, jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((L, 64, dkv)) * 0.3, jnp.bfloat16)
    x = (rng.standard_normal(d) * 0.5).astype(np.float32)
    jy, jk, jv = JFL.fused_llama_stack(
        jpack, kc, vc, jnp.zeros((8, d), jnp.float32).at[0].set(x), offset,
        cfg=jcfg, valid_from=valid_from, interpret=True)
    tkc = torch.tensor(np.asarray(kc.astype(jnp.float32))).to(torch.bfloat16)
    tvc = torch.tensor(np.asarray(vc.astype(jnp.float32))).to(torch.bfloat16)
    ty, tk, tv = TFL.fused_llama_stack(tpack, tkc, tvc, torch.from_numpy(x), offset,
                                       cfg=tcfg, valid_from=valid_from)
    # f32 sums in another order can move an int8 activation code by one
    # step; 1e-3 of the output's scale bounds a few such flips per layer
    for got, want in ((ty, np.asarray(jy)[0]), (tk, np.asarray(jk)[:, 0]),
                      (tv, np.asarray(jv)[:, 0])):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-3, err
    np.testing.assert_array_equal(tkc[:, offset].float().numpy(),
                                  tk.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(tvc[:, offset].float().numpy(),
                                  tv.to(torch.bfloat16).float().numpy())


def test_fused_llama_stack_ref_taps_every_gemv_input():
    """The tap holds each GEMV input's int8 codes, scale and unrounded
    values: the q/k/v codes reproduce the layer's v rows through the
    packed weights, and each code is its unrounded value rounded."""
    jcfg, tcfg, _, tpack = _llama_setup("base")
    d, ffn, L = jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_hidden_layers
    dkv = jcfg.num_key_value_heads * 128
    rng = np.random.default_rng(2)
    kc = torch.from_numpy(rng.standard_normal((L, 64, dkv)).astype(np.float32) * 0.3)
    kmax = max(d, ffn)
    tap = (torch.zeros((L, 4, kmax), dtype=torch.int8), torch.zeros((L, 4)),
           torch.zeros((L, 4, kmax)))
    _, _, nv = TFL.fused_llama_stack(tpack, kc.to(torch.bfloat16), kc.to(torch.bfloat16),
                                     torch.from_numpy(rng.standard_normal(d).astype(
                                         np.float32)), 9, cfg=tcfg, tap=tap)
    for li in range(L):
        rows = slice(d + dkv, d + 2 * dkv)
        v = ((tpack.w_in[li, rows].double() @ tap[0][li, 0, :d].double()).float()
             * (tpack.scales[li, rows] * tap[1][li, 0]))
        assert torch.equal(v, nv[li])
    used = torch.arange(kmax)[None, :] < torch.tensor([d, d, d, ffn])[:, None]
    assert torch.equal(torch.where(used, torch.round(tap[2]), 0.0), tap[0].float())
    assert bool((tap[1] > 0).all())


def test_fused_llama_supported_states_the_kernel_limits():
    """The shapes the TPU kernel takes (Orpheus-3B, Llama-3.1-8B's 14336-
    wide ffn, a 16384-wide one) up to a 57,856-wide f32 row in the
    quantise's shared memory; no head dim but 128, no ffn of partial
    16-byte vectors."""
    orpheus = dict(hidden_size=3072, num_hidden_layers=28, intermediate_size=8192,
                   num_attention_heads=24, num_key_value_heads=8, vocab_size=156940)
    llama8b = dict(hidden_size=4096, num_hidden_layers=32, intermediate_size=14336,
                   num_attention_heads=32, num_key_value_heads=8, vocab_size=128256)
    for kw in (orpheus, llama8b, dict(LLAMA, qk_norm=True),
               dict(LLAMA, intermediate_size=16384)):
        assert JFL.supported(JL.LlamaConfig(**kw))
        assert TFL.supported(TL.LlamaConfig(**kw))
    assert not TFL.supported(TL.LlamaConfig(hidden_size=2048, num_attention_heads=32))
    assert not TFL.supported(TL.LlamaConfig(**dict(LLAMA, intermediate_size=2056)))
    assert TFL.supported(TL.LlamaConfig(**dict(LLAMA, intermediate_size=57856)))
    assert not TFL.supported(TL.LlamaConfig(**dict(LLAMA, intermediate_size=57872)))
    assert not TFL.supported(TL.LlamaConfig(**LLAMA, attention_bias=True))
    assert not TFL.supported(TL.LlamaConfig(**LLAMA, rope_interleaved=True))


# -- kernel 6: the Llama serving lanes stack (fused_llama_stack_lanes) ---------


def _llama_lanes_inputs(jcfg, n, slots, seed):
    """Random bf16 caches in every row of every slot of a stacked state
    (rows below a lane's valid_from and above its offset included, so a
    masking or slot error shows), the lanes' shuffled slots and their
    embedded tokens."""
    L, d, dkv = jcfg.num_hidden_layers, jcfg.hidden_size, jcfg.num_key_value_heads * 128
    rng = np.random.default_rng(seed)
    kc, vc = (np.array(jnp.asarray(rng.standard_normal((slots, L, 64, dkv)) * 0.3,
                                     jnp.bfloat16).astype(jnp.float32)) for _ in range(2))
    lanes = rng.permutation(slots)[:n]
    x = (rng.standard_normal((n, d)) * 0.5).astype(np.float32)
    return kc, vc, lanes, x


@pytest.mark.parametrize("variant,offsets,starts", [
    ("base", [9, 0, 33], [2, 0, 0]),          # tests/test_fused_llama.py:300
    ("base", [3, 0, 40, 63], [0, 0, 8, 0]),   # tests/test_fused_llama.py:434
    ("qk_norm", [5, 17, 63], [0, 4, 5]),      # tests/test_fused_llama.py:349, with left pads
    ("llama3", [63, 0, 40], [5, 0, 7])])
def test_fused_llama_stack_lanes_ref_matches_jax(variant, offsets, starts):
    """Lanes at shuffled slots of a stacked state, against the TPU lanes
    kernel in interpret mode (which takes each lane's cache in lane order):
    y, newk and newv, the new rows at each lane's slot and offset, and no
    other row of any slot moved."""
    jcfg, tcfg, jpack, tpack = _llama_setup(variant)
    d, n = jcfg.hidden_size, len(offsets)
    kc, vc, lanes, x = _llama_lanes_inputs(jcfg, n, n + 2, sum(offsets) + n)
    pad8 = np.zeros((8,), np.int32)
    off8, st8 = pad8.copy(), pad8.copy()
    off8[:n], st8[:n] = offsets, starts
    jy, jk, jv = JFL.fused_llama_stack_lanes(
        jpack, jnp.asarray(kc[lanes], jnp.bfloat16), jnp.asarray(vc[lanes], jnp.bfloat16),
        jnp.zeros((8, d), jnp.float32).at[:n].set(x), off8, st8, cfg=jcfg, interpret=True)
    tkc, tvc = (torch.from_numpy(c).to(torch.bfloat16) for c in (kc, vc))
    before_k, before_v = tkc.clone(), tvc.clone()
    ty, tk, tv = TFL.fused_llama_stack_lanes(
        tpack, tkc, tvc, torch.from_numpy(lanes), torch.from_numpy(x),
        torch.tensor(offsets), torch.tensor(starts), cfg=tcfg)
    # the bound of test_fused_llama_stack_ref_matches_jax
    errs = []
    for got, want in ((ty, np.asarray(jy)[:n]), (tk, np.asarray(jk)[:, :n]),
                      (tv, np.asarray(jv)[:, :n])):
        errs.append(float(np.abs(got.numpy() - want).max() / np.abs(want).max()))
    print(f"lanes vs JAX interpret, {variant} offsets {offsets}: y/newk/newv rel "
          + "/".join(f"{e:.2e}" for e in errs))
    assert max(errs) < 1e-3, errs
    for m, (slot, off) in enumerate(zip(lanes, offsets)):
        before_k[slot, :, off] = tk[:, m].to(torch.bfloat16)
        before_v[slot, :, off] = tv[:, m].to(torch.bfloat16)
    assert torch.equal(tkc, before_k) and torch.equal(tvc, before_v)


def test_fused_llama_stack_lanes_ref_lanes_equal_b1():
    """Lanes in shuffled slots of a 6-slot state, one past the cache's end:
    each lane equals fused_llama_stack_ref alone on its inputs (the past-end
    offset clamped to the last row), taps included, lane by lane."""
    jcfg, tcfg, _, tpack = _llama_setup("qk_norm")
    L, kmax = jcfg.num_hidden_layers, max(jcfg.hidden_size, jcfg.intermediate_size)
    offsets, starts = [0, 63, 40, 64 + 9], [0, 5, 8, 3]
    n = len(offsets)
    kc, vc, lanes, x = _llama_lanes_inputs(jcfg, n, 6, 4)
    tkc, tvc = (torch.from_numpy(c).to(torch.bfloat16) for c in (kc, vc))
    solo_k, solo_v = tkc.clone(), tvc.clone()
    tap = (torch.zeros((L, 4, n, kmax), dtype=torch.int8), torch.zeros((L, 4, n)))
    y, nk, nv = TFL.fused_llama_stack_lanes(
        tpack, tkc, tvc, torch.from_numpy(lanes), torch.from_numpy(x), torch.tensor(offsets),
        torch.tensor(starts), cfg=tcfg, tap=tap)
    for m, (slot, off, vf) in enumerate(zip(lanes, offsets, starts)):
        solo = (torch.zeros((L, 4, kmax), dtype=torch.int8), torch.zeros((L, 4)))
        y1, k1, v1 = TFL.fused_llama_stack_ref(tpack, solo_k[slot], solo_v[slot],
                                               torch.from_numpy(x[m]), min(off, 63), cfg=tcfg,
                                               valid_from=vf, tap=solo)
        for got, want in ((y[m], y1), (nk[:, m], k1), (nv[:, m], v1)):
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-6, m
        assert torch.equal(tap[0][:, :, m], solo[0]) and torch.equal(tap[1][:, :, m], solo[1])
    assert torch.equal(tkc, solo_k) and torch.equal(tvc, solo_v)


def test_supported_lanes_llama_states_the_kernel_limit():
    """The lanes GEMV stages n int8 rows of the widest input in shared
    memory: at Orpheus-3B's ffn 8192, 28 lanes fit in the 227 KB a block may
    opt into and 29 do not. Its quantise stages three f32 rows of the widest
    input: Llama-3.1-8B (ffn 14,336) fits, with 16 lanes, and Llama-3.1-70B
    (ffn 28,672) does not, though the one-token kernel takes it."""
    orpheus = TL.LlamaConfig(hidden_size=3072, num_hidden_layers=28, intermediate_size=8192,
                             num_attention_heads=24, num_key_value_heads=8)
    assert all(TFL.supported_lanes(orpheus, n) for n in range(1, 29))
    assert not TFL.supported_lanes(orpheus, 29) and not TFL.supported_lanes(orpheus, 0)
    small = TL.LlamaConfig(**LLAMA)
    assert TFL.supported_lanes(small, TFL.MAX_LANES)
    assert not TFL.supported_lanes(small, TFL.MAX_LANES + 1)
    assert not TFL.supported_lanes(TL.LlamaConfig(hidden_size=2048, num_attention_heads=32), 1)
    llama8b = TL.LlamaConfig(hidden_size=4096, num_hidden_layers=32, intermediate_size=14336,
                             num_attention_heads=32, num_key_value_heads=8)
    assert TFL.supported_lanes(llama8b, 16) and not TFL.supported_lanes(llama8b, 17)
    llama70b = TL.LlamaConfig(hidden_size=8192, num_hidden_layers=80, intermediate_size=28672,
                              num_attention_heads=64, num_key_value_heads=8)
    assert TFL.supported(llama70b) and not TFL.supported_lanes(llama70b, 1)
