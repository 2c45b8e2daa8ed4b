"""The port's KV caches against tpu_audio.core.kv_cache on the CPU: the
int8 and packed-int4 codes bit for bit, the cache types and their
factory, in-place writes and full-capacity views of the dense, quantized
and hybrid caches, ``llama.forward`` over each of them, and the hybrid
prefill rules.

The JAX functions are called eagerly (not under ``jax.jit``), so XLA does
not turn a division into a multiply by a reciprocal and the codes are
comparable bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import kv_cache as jkv
from tpu_audio.models import llama as JL
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import kv_cache as tkv
from tpu_audio_torch.models import llama as TL

from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)


def _tie_rows(bits: int, d: int, n_groups: int) -> np.ndarray:
    """Rows whose codes land exactly on .5 before rounding: a group
    spanning [0, 15] (4 bits) or [-127, 127] (8 bits) has scale 1, so a
    value k + 0.5 rounds half to even."""
    g = d // n_groups
    halves = np.arange(g - 2) % 14 + 0.5
    if bits == 4:
        rows = [np.concatenate([[0.0, 15.0], halves])]
    else:
        rows = [np.concatenate([[127.0, -127.0], halves * sign]) for sign in (1, -9)]
    return np.asarray([np.tile(r, n_groups) for r in rows], np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("d,n_groups", [(64, 1), (64, 2), (48, 3)])
def test_quantize_and_dequantize_bit_equal_to_jax(bits, d, n_groups):
    """Random rows, rows of one value, and rows with exact .5 ties; an odd
    group count at 48 features."""
    rng = np.random.default_rng(bits * 100 + d + n_groups)
    x = (rng.standard_normal((2, 3, 5, d)) * 2.0).astype(np.float32)
    flat = np.concatenate([x.reshape(-1, d), _tie_rows(bits, d, n_groups),
                           np.full((1, d), 0.25, np.float32)])
    for arr in (x, flat):
        jq, js, jb = jkv._quantize(jnp.asarray(arr), n_groups, bits)
        tq, ts, tb = tkv._quantize(torch.from_numpy(arr), n_groups, bits)
        assert tq.dtype == (torch.uint8 if bits == 4 else torch.int8)
        assert tq.shape[-1] == (d // 2 if bits == 4 else d)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = tkv._dequantize(tq, ts, tb, dtype).float().numpy()
            want = np.asarray(jkv._dequantize(jq, js, jb, jdtype).astype(jnp.float32))
            np.testing.assert_array_equal(got, want)
    # the tie rows really tie: codes of k + 0.5 go to the even k
    tq, ts, _ = tkv._quantize(torch.from_numpy(_tie_rows(bits, d, n_groups)), n_groups, bits)
    assert float(ts.max()) == float(ts.min()) == 1.0


def test_int4_nibble_order():
    """Two codes a byte: the even feature in the low nibble."""
    x = torch.tensor([[0.0, 15.0, 3.0, 12.0, 1.0, 14.0, 7.0, 8.0]])
    q, s, b = tkv._quantize(x, 1, 4)
    assert q.dtype == torch.uint8
    assert q.tolist() == [[0 | 15 << 4, 3 | 12 << 4, 1 | 14 << 4, 7 | 8 << 4]]
    assert float(s) == 1.0 and float(b) == 0.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jkv._quantize(jnp.asarray(x.numpy()),
                                                                       1, 4)[0]))
    assert torch.equal(tkv._dequantize(q, s, b, torch.float32), x)


@pytest.mark.parametrize("bits", [4, 8])
def test_init_caches_match_jax_shapes_and_dtypes(bits):
    jc = jkv.init_quant_cache(2, 3, 4, 64, 16, group_size=32, bits=bits, valid_from=2)
    tc = tkv.init_quant_cache(2, 3, 4, 64, 16, group_size=32, bits=bits, valid_from=2)
    for f in ("k_q", "k_scale", "k_bias", "v_q", "v_scale", "v_bias"):
        assert tuple(getattr(tc, f).shape) == getattr(jc, f).shape, f
        assert str(getattr(tc, f).dtype).split(".")[-1] == str(getattr(jc, f).dtype), f
    for p in ("max_len", "bits", "head_dim", "group_size", "n_groups"):
        assert getattr(tc, p) == getattr(jc, p), p
    assert tc.offset == 0 and tc.valid_from == 2
    jh = jkv.init_hybrid_cache(2, 3, 4, 64, 16, split=5, group_size=64, bits=bits,
                               dtype=jnp.float32)
    th = tkv.init_hybrid_cache(2, 3, 4, 64, 16, split=5, group_size=64, bits=bits,
                               dtype=torch.float32)
    for f in jh._fields[:8]:
        assert tuple(getattr(th, f).shape) == getattr(jh, f).shape, f
        assert str(getattr(th, f).dtype).split(".")[-1] == str(getattr(jh, f).dtype), f
    for p in ("split", "max_len", "bits", "head_dim", "n_groups"):
        assert getattr(th, p) == getattr(jh, p), p
    # the group never exceeds the head dim
    assert tkv.init_quant_cache(1, 1, 1, 16, 4, group_size=64).group_size == 16


def test_init_caches_raise_as_jax():
    for mod in (jkv, tkv):
        with pytest.raises(ValueError, match="bits must be 4 or 8"):
            mod.init_quant_cache(1, 1, 1, 64, 8, bits=3)
        with pytest.raises(ValueError, match="even head dim"):
            mod.init_quant_cache(1, 1, 1, 7, 8, group_size=7, bits=4)
        for split in (0, 8):
            with pytest.raises(ValueError, match="split"):
                mod.init_hybrid_cache(1, 1, 1, 64, 8, split=split)


def test_make_cache_for_dispatch():
    """The cases of tests/test_kv_cache.py::test_make_cache_for_dispatch."""
    c = tkv.make_cache_for(1, 1, 2, 64, 16)
    assert isinstance(c, tkv.KVCache)
    c = tkv.make_cache_for(1, 1, 2, 64, 16, kv_bits=8)
    assert isinstance(c, tkv.QuantKVCache) and c.bits == 8
    c = tkv.make_cache_for(1, 1, 2, 64, 16, kv_bits=4, quantized_kv_start=4)
    assert isinstance(c, tkv.HybridKVCache) and c.bits == 4
    assert c.split == 4 and c.max_len == 16
    c = tkv.make_cache_for(1, 1, 2, 64, 16, kv_bits=8, quantized_kv_start=16)
    assert isinstance(c, tkv.KVCache)
    c = tkv.make_cache_for(1, 1, 2, 64, 16, kv_bits=4, quantized_kv_start=-3)
    assert isinstance(c, tkv.QuantKVCache) and c.bits == 4
    with pytest.raises(ValueError, match="kv_bits"):
        tkv.make_cache_for(1, 1, 2, 64, 16, kv_bits=3)
    for kw in (dict(), dict(kv_bits=8), dict(kv_bits=4, quantized_kv_start=4),
               dict(kv_bits=8, quantized_kv_start=16), dict(kv_bits=4, quantized_kv_start=-3)):
        assert (type(tkv.make_cache_for(1, 1, 2, 64, 16, **kw)).__name__
                == type(jkv.make_cache_for(1, 1, 2, 64, 16, **kw)).__name__), kw


CACHES = {
    "dense": dict(),
    "int8": dict(kv_bits=8),
    "int4": dict(kv_bits=4),
    "hybrid8": dict(kv_bits=8, quantized_kv_start=5),
    "hybrid4": dict(kv_bits=4, quantized_kv_start=5, kv_group_size=16),
}


@pytest.mark.parametrize("kind", list(CACHES))
def test_update_cache_matches_jax(kind):
    """A 4-row prefill then single rows past the split: the returned
    full-capacity views and every plane within 1e-6, the hybrid's dense
    prefix exact, masks equal."""
    L, B, H, D, S = 2, 2, 3, 32, 12
    rng = np.random.default_rng(7)
    jc = jkv.make_cache_for(L, B, H, D, S, jnp.float32, **CACHES[kind])
    tc = tkv.make_cache_for(L, B, H, D, S, torch.float32, **CACHES[kind])
    for t in (4, 1, 1, 1, 1):
        for layer in range(L):
            k, v = (rng.standard_normal((B, H, t, D)).astype(np.float32) for _ in range(2))
            jc, jk, jv = jkv.update_cache(jc, layer, jnp.asarray(k), jnp.asarray(v))
            tc, tk, tv = tkv.update_cache(tc, layer, torch.from_numpy(k), torch.from_numpy(v))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
        jc = jc._replace(offset=jc.offset + t)
        tc = tc._replace(offset=tc.offset + t)
        np.testing.assert_array_equal(tkv.attention_mask(tc, 1).numpy(),
                                      np.asarray(jkv.attention_mask(jc, 1)))
    assert tc.offset == int(jc.offset) == 8
    for f in jc._fields[:-2]:
        want = np.asarray(getattr(jc, f))
        got = getattr(tc, f).numpy()
        if f in ("k", "v") or got.dtype in (np.int8, np.uint8):
            np.testing.assert_array_equal(got, want, err_msg=f)  # dense rows, codes
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f)


LLAMA = dict(vocab_size=64, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=128, max_position_embeddings=64)


@pytest.mark.parametrize("kind", list(CACHES))
def test_llama_forward_over_each_cache_matches_jax(kind):
    """tests/test_kv_cache.py::test_llama_forward_quant_cache_bitwidths on
    both packages: a 4-token prefill and three steps, logits within 1e-5
    of the JAX package's and argmax equal."""
    jcfg = JL.LlamaConfig(**LLAMA)
    tcfg = TL.LlamaConfig(**LLAMA)
    params = JL.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    tparams = from_jax_params(jax_tree_to_numpy(params))
    kw = {k: v for k, v in CACHES[kind].items() if k != "kv_group_size"}

    def run(forward, cache, as_tokens, to_np):
        logits, cache = forward(as_tokens([[1, 2, 3, 4]]), cache)
        outs = [to_np(logits[:, -1])]
        for _ in range(3):
            logits, cache = forward(as_tokens([[5]]), cache)
            outs.append(to_np(logits[:, -1]))
        return np.stack(outs), cache

    want, jc = run(lambda t, c: JL.forward(params, t, c, jcfg),
                   JL.make_cache(jcfg, 1, 12, jnp.float32, **kw),
                   lambda t: jnp.asarray(t, jnp.int32), np.asarray)
    got, tc = run(lambda t, c: TL.forward(tparams, t, c, tcfg),
                  TL.make_cache(tcfg, 1, 12, torch.float32, **kw),
                  lambda t: torch.tensor(t), lambda a: a.numpy())
    assert type(tc).__name__ == type(jc).__name__
    assert tc.offset == int(jc.offset) == 7
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_hybrid_prefill_rules():
    """tests/test_kv_cache.py::test_hybrid_prefill_longer_than_quant_tail:
    a prefill as long as the dense prefix decodes on into a shorter
    quantized tail, and a prefill longer than the prefix raises."""
    cfg = TL.LlamaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=4, num_key_value_heads=4, intermediate_size=64,
                         max_position_embeddings=128)
    params = TL.init_random_params(cfg, seed=0, dtype=torch.float32)
    prefill_len, max_new = 20, 4
    cache = TL.make_cache(cfg, 1, prefill_len + max_new + 1, torch.float32, kv_bits=8,
                          quantized_kv_start=prefill_len)
    assert isinstance(cache, tkv.HybridKVCache) and cache.max_len - cache.split == max_new + 1
    toks = torch.arange(1, prefill_len + 1)[None]
    logits, cache = TL.forward(params, toks, cache, cfg)
    assert torch.isfinite(logits).all()
    last = toks[:, -1:]
    for _ in range(3):
        logits, cache = TL.forward(params, last, cache, cfg)
        last = logits[:, -1:].argmax(-1)
    assert cache.offset == prefill_len + 3 and torch.isfinite(logits).all()
    assert cache.k_q[0, 0, 0, :3].abs().sum() > 0 and cache.k_q[0, 0, 0, 3:].abs().sum() == 0
    bad = tkv.init_hybrid_cache(1, 1, 4, 8, 64, split=4)
    with pytest.raises(ValueError, match="dense prefix"):
        tkv.update_cache(bad, 0, torch.zeros((1, 4, 10, 8)), torch.zeros((1, 4, 10, 8)))


def test_hybrid_write_across_the_split_raises_where_jax_clamps():
    """Two rows at offset 3 of a split-4 cache: the JAX package's
    ``dynamic_update_slice`` clamps the write to rows 2-3 (overwriting row
    2, nothing at 4); the port raises, naming the split."""
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((1, 2, 2, 8)).astype(np.float32) for _ in range(2))
    jc = jkv.init_hybrid_cache(1, 1, 2, 8, 16, split=4, dtype=jnp.float32)
    jc = jc._replace(offset=jnp.int32(3))
    jc, jk, _ = jkv.update_cache(jc, 0, jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(jc.k)[0, :, :, 2:4], k)
    np.testing.assert_array_equal(np.asarray(jk)[:, :, 4], 0)
    tc = tkv.init_hybrid_cache(1, 1, 2, 8, 16, split=4, dtype=torch.float32)._replace(offset=3)
    with pytest.raises(ValueError, match=r"crosses the split \(4\)"):
        tkv.update_cache(tc, 0, torch.from_numpy(k), torch.from_numpy(v))
    # within the prefix, and one row on each side of the split, the port writes
    tc = tc._replace(offset=2)
    tkv.update_cache(tc, 0, torch.from_numpy(k), torch.from_numpy(v))
    assert torch.equal(tc.k[0, :, :, 2:4], torch.from_numpy(k))
    for off in (3, 4):
        _, tk, _ = tkv.update_cache(tc._replace(offset=off), 0, torch.from_numpy(k[:, :, :1]),
                                    torch.from_numpy(v[:, :, :1]))
        err = (tk[:, :, off] - torch.from_numpy(k[:, :, 0])).abs().max()
        assert (err == 0) if off < 4 else (0 < err < 0.02 * np.abs(k).max())
