"""MLX grouped-affine 4/8-bit weights on the PyTorch port against the JAX
package, on the CPU: the quantizers (bit for bit), unpacking and
dequantizing, the GEMV's plain version against the JAX Pallas kernel in
interpret mode, the dispatch of ``quant.quantized_matmul`` above and below
64 rows, tagging checkpoint triples, ``slice_rows``, the embedding and
linear layers, projection fusion, checkpoint loading and
``convert.from_jax_params``.

The CUDA kernels themselves (``csrc/qmm.cu``: the decode kernel, the
GEMV and the tensor-core tile) run only on a GPU; ``chip_smoke.py`` holds
them against the plain version tested here. What runs here of the decode
kernel and the tile is the routing rule, their launch shapes and
emulations of their arithmetic (the decode kernel's per-chunk sums in its
lanes' order; the tile's bf16 split of x, exact codes, f32 group sums),
held against the JAX kernel and the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.core import nn as jnn
from tpu_audio.core import quant as jquant
from tpu_audio.models import llama as JL
from tpu_audio.ops import pallas_qmm as JQ
from tpu_audio_torch.convert import from_jax_params
from tpu_audio_torch.core import loading
from tpu_audio_torch.core import nn as tnn
from tpu_audio_torch.core import quant as tquant
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.ops import qmm as TQ

from test_torch_ops import jax_tree_to_numpy

torch.set_num_threads(1)


def _words(packed: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(packed).view(np.int32).copy())


def _packed(o, i, group_size, bits, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, i)) * scale).astype(np.float32)
    return w, jquant.quantize(w, group_size, bits)


# -- the GEMV ---------------------------------------------------------------------


# tests/test_pallas_mel.py:63's shapes, then groups of 32 and 128, 8 bits,
# and row counts up to the kernel's 64
@pytest.mark.parametrize("bits,o,i,b,g", [
    (4, 96, 128, 1, 64), (8, 64, 256, 3, 64), (4, 300, 192, 2, 64),
    (4, 130, 256, 5, 32), (4, 72, 384, 9, 128), (8, 200, 256, 17, 32),
    (8, 64, 512, 33, 128), (4, 136, 256, 63, 64), (8, 40, 128, 64, 64)])
def test_quantized_matvec_ref_matches_jax_kernel(bits, o, i, b, g):
    """The plain version against the Pallas kernel in interpret mode, at the
    JAX test's tolerance (rtol 2e-5, atol 2e-4: f32 sums in another
    order)."""
    _, (packed, scales, biases) = _packed(o, i, g, bits)
    x = np.random.default_rng(1).standard_normal((b, i)).astype(np.float32)
    want = np.asarray(JQ.quantized_matvec(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(biases),
        g, bits, tile_o=128, interpret=True))
    got = TQ.quantized_matvec(torch.from_numpy(x), _words(packed), torch.from_numpy(scales),
                              torch.from_numpy(biases), g, bits)
    assert got.dtype == torch.float32 and got.shape == (b, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("lead", [(65,), (100,), (2, 40), (1,), (3, 7)])
def test_quantized_matmul_matches_jax_both_routes(lead):
    """``quant.quantized_matmul`` on both sides of the 64-row switch (the
    GEMV's plain version at most 64 rows, dequantize + matmul above)
    against the JAX package's (its dequantize + matmul on the CPU): f32,
    relative 1e-5 of the largest output."""
    _, (packed, scales, biases) = _packed(48, 256, 64, 4, seed=2)
    x = np.random.default_rng(3).standard_normal((*lead, 256)).astype(np.float32)
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jnp.asarray(packed),
                                              jnp.asarray(scales), jnp.asarray(biases), 64, 4))
    got = tquant.quantized_matmul(torch.from_numpy(x), _words(packed),
                                  torch.from_numpy(scales), torch.from_numpy(biases), 64, 4)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_quantized_matmul_sends_at_most_64_rows_to_the_gemv(monkeypatch):
    calls = []
    ref = TQ.quantized_matvec

    def spy(x, *a, **k):
        calls.append(x.shape[0])
        return ref(x, *a, **k)

    monkeypatch.setattr(TQ, "quantized_matvec", spy)
    _, (packed, scales, biases) = _packed(16, 64, 32, 8)
    qt = tquant.QuantizedTensor(_words(packed), torch.from_numpy(scales),
                                torch.from_numpy(biases), 32, 8)
    for rows in (1, 63, 64, 65, 300):
        tquant.quantized_matmul_qt(torch.ones((rows, 64)), qt)
    assert calls == [1, 63, 64]


def test_quantized_matvec_raises_on_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises: bits, group
    sizes, rows, dtypes and widths it does not take (``meta`` tensors stand
    in for CUDA ones; the checks come before any launch)."""
    meta = torch.device("meta")

    def call(b=1, i=256, bits=4, g=64, xdt=torch.float32, sdt=torch.float32):
        x = torch.empty((b, i), device=meta, dtype=xdt)
        w = torch.empty((8, i * bits // 32 if bits else i // 8), device=meta, dtype=torch.int32)
        s = torch.empty((8, i // g), device=meta, dtype=sdt)
        return TQ.quantized_matvec(x, w, s, s, g, bits)

    for kw, msg in ((dict(bits=3), "bits"), (dict(g=16), "group"), (dict(b=65), "rows"),
                    (dict(b=0), "rows"), (dict(i=224, g=64), "input features"),
                    (dict(xdt=torch.float64), "dtype"), (dict(sdt=torch.int32), "dtype"),
                    (dict(i=64 * 1024), "shared memory")):
        with pytest.raises(ValueError, match=msg):
            call(**kw)


def test_rows_a_pass_fits_the_shared_memory():
    assert [TQ.rows_a_pass(b, 3072, 64, 4) for b in (1, 2, 3, 5, 8, 63)] == [1, 2, 4, 8, 8, 8]
    # 8 rows of an 8192-wide x (267 KB) do not fit 227 KB; 4 do
    assert TQ.rows_a_pass(63, 8192, 64, 4) == 4 and TQ.rows_a_pass(1, 8192, 64, 4) == 1
    # one row of 57,600 fits at 8 bits (planes padded by 16 floats in all),
    # not at 2 (64)
    assert TQ.rows_a_pass(1, 57600, 128, 8) == 1 and TQ.rows_a_pass(1, 57600, 128, 2) == 0
    assert TQ.rows_a_pass(1, 64 * 1024, 64, 4) == 0


# -- routing, launch shapes and emulated arithmetic (the CUDA kernels run only
# on a GPU) -----------------------------------------------------------------------


def test_route_sends_rows_to_the_gemv_the_tile_or_dequantize():
    """1 aligned row to the decode kernel, unaligned rows to the GEMV,
    R_TILE..64 rows to the tile, more than 64 to dequantize + matmul
    (``core.quant.quantized_matmul``)."""
    assert TQ.route(1, 3072, 4, True) == "decode"
    assert all(TQ.route(1, i, bits, True) == "decode"
               for i in (1280, 3072, 5120, 8192) for bits in (2, 4, 8))
    assert [TQ.route(b, 3072, 4, True) for b in range(TQ.R_TILE, 65)] == \
        ["tile"] * (65 - TQ.R_TILE)
    assert all(TQ.route(b, 8192, bits, True) == "tile"
               for b in (TQ.R_TILE, 63) for bits in (2, 4, 8))
    # rows of 6 words (96 inputs at 2 bits) are not whole 16-byte chunks
    assert TQ.route(3, 96, 2, True) == "gemv" and TQ.route(3, 128, 2, True) == "tile"
    assert TQ.route(1, 96, 2, True) == "gemv" and TQ.route(1, 128, 2, True) == "decode"
    # a pointer off a 16-byte boundary
    assert TQ.route(63, 3072, 4, False) == "gemv" and TQ.route(1, 3072, 4, False) == "gemv"
    # x wider than the decode kernel's shared memory: the GEMV (which raises)
    assert TQ.route(1, 64 * 1024, 4, True) == "gemv"
    assert [TQ.route(b, 3072, 4, True) for b in (65, 100, 1500)] == ["dequantize"] * 3


def test_quantized_matvec_launches_the_kernel_its_route_names(monkeypatch):
    """Off the CPU the wrapper launches the route's kernel (``meta`` tensors
    stand in for CUDA ones; the launchers are spies)."""
    calls = []
    monkeypatch.setattr(TQ, "_decode", lambda *a: calls.append(("decode", a[-3])))
    monkeypatch.setattr(TQ, "_gemv", lambda *a: calls.append(("gemv", a[-3])))
    monkeypatch.setattr(TQ, "_tile", lambda *a: calls.append(("tile", a[-3])))
    meta = torch.device("meta")
    for b, i, bits in ((1, 256, 4), (2, 256, 4), (64, 256, 4), (3, 96, 2), (63, 96, 4),
                       (1, 96, 2), (1, 128, 2)):
        x = torch.empty((b, i), device=meta)
        w = torch.empty((8, i * bits // 32), device=meta, dtype=torch.int32)
        s = torch.empty((8, i // 32), device=meta)
        TQ.quantized_matvec(x, w, s, s, 32, bits)
    assert calls == [("decode", 1), ("tile", 2), ("tile", 64), ("gemv", 3), ("tile", 63),
                     ("gemv", 1), ("decode", 1)]


def test_decode_raises_off_its_one_case():
    """``qmm.decode`` takes 1 row of whole 16-byte chunks and raises on
    anything else (``meta`` tensors; the checks come before any launch)."""
    meta = torch.device("meta")

    def call(b, i, bits):
        x = torch.empty((b, i), device=meta)
        w = torch.empty((8, i * bits // 32), device=meta, dtype=torch.int32)
        s = torch.empty((8, i // 32), device=meta)
        return TQ.decode(x, w, s, s, 32, bits)

    for b, i, bits in ((2, 256, 4), (1, 96, 2), (1, 64 * 1024, 4)):
        with pytest.raises(ValueError, match="decode kernel"):
            call(b, i, bits)


def test_decode_shape_fills_the_card():
    """The decode kernel's launch at the path shapes (4 bits): Orpheus-3B's
    q/k/v, o, gate/up, down, band and full heads, then q4 Whisper's
    (d 1280, ffn 5120, vocab 51866): at least DECODE_BLOCKS blocks where the
    rows allow, 2 rows a warp only where that keeps them, a row's chunks
    split over warps where too few rows (whisper's fc2) leave the card
    idle."""
    got = [TQ.decode_shape(o, i, 4) for o, i in
           ((5120, 3072), (3072, 3072), (16384, 3072), (3072, 8192), (28673, 3072),
            (156940, 3072), (1280, 1280), (5120, 1280), (1280, 5120), (51866, 1280))]
    assert got == [(320, 2, 1, 3), (384, 1, 1, 3), (1024, 2, 1, 3), (384, 1, 1, 8),
                   (1793, 2, 1, 3), (9809, 2, 1, 3), (160, 1, 1, 2), (320, 2, 1, 2),
                   (320, 1, 2, 3), (3242, 2, 1, 2)]
    # 8 bits at 8,192 inputs: 16 chunks a lane, two passes of 8
    assert TQ.decode_shape(3072, 8192, 8) == (384, 1, 1, 8)
    # a narrow matrix of wide rows: 4 warps a row
    assert TQ.decode_shape(64, 8192, 4) == (32, 1, 4, 2)
    assert all(TQ.decode_fits(i, 2) for i in (1280, 8192, 57344))
    assert not TQ.decode_fits(58112, 4)


def _decode_emulation(x, words, scales, biases, g, bits):
    """Emulation of the decode kernel's arithmetic, not the kernel: each code
    as the exact float f = 1 + q / FRAC (128 at 4 bits, else 2^bits); for
    each 16-byte chunk (4 words) and each half of it (words 0-1, 2-3), the
    f32 sums of x * f and of x; the chunk's value ``scale_lo * FRAC *
    (dotf_lo - xsum_lo) + scale_hi * FRAC * (dotf_hi - xsum_hi) + (bias_lo *
    xsum_lo + bias_hi * xsum_hi)`` (the two halves share one group unless a
    chunk spans two: 2 bits, g 32); chunk ``(s * nct + k) * 32 + lane``
    added in f32 into its lane's sum in k order, the 32 lanes added by the
    kernel's xor butterfly, and the KS slices of a row in slice order, as
    ``decode_shape`` launches them."""
    o, nw = words.shape
    pw, cr = 32 // bits, nw // 4
    frac = 128.0 if bits == 4 else float(1 << bits)
    _, _, ks, _ = TQ.decode_shape(o, x.shape[1], bits)
    xf = x.float().reshape(cr, 2, 2 * pw)
    f = 1.0 + tquant._unpack(words, bits).float().reshape(o, cr, 2, 2 * pw) / frac
    dotf, xsum = (f * xf).sum(-1), xf.sum(-1)
    grp = (torch.arange(cr)[:, None] * 4 + torch.tensor([0, 2])) * pw // g  # [cr, 2]
    sc, bi = scales.float()[:, grp] * frac, biases.float()[:, grp]
    v = (sc[..., 0] * (dotf[..., 0] - xsum[:, 0]) + sc[..., 1] * (dotf[..., 1] - xsum[:, 1])
         + (bi[..., 0] * xsum[:, 0] + bi[..., 1] * xsum[:, 1]))
    nct = -(-cr // (32 * ks))
    v = torch.cat([v, v.new_zeros((o, ks * nct * 32 - cr))], 1).reshape(o, ks, nct, 32)
    acc = torch.zeros((o, ks, 32))
    for k in range(nct):
        acc = acc + v[:, :, k]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    y = acc[:, 0, 0]
    for s in range(1, ks):
        y = y + acc[:, s, 0]
    return y[None].to(x.dtype)


@pytest.mark.parametrize("bits,o,i,g", [
    (4, 96, 128, 64), (8, 64, 256, 64), (4, 300, 192, 64), (4, 130, 256, 32),
    (4, 72, 384, 128), (8, 200, 256, 32), (8, 64, 512, 128), (4, 136, 256, 64),
    (8, 40, 128, 64), (2, 48, 512, 32)])
def test_decode_emulation_matches_jax_kernel(bits, o, i, g):
    """The emulated decode kernel against the Pallas kernel in interpret
    mode at 1 row, at the shapes and tolerance of the plain version's test
    above, and 2 bits in groups of 32 (a chunk over two groups)."""
    _, (packed, scales, biases) = _packed(o, i, g, bits)
    x = np.random.default_rng(1).standard_normal((1, i)).astype(np.float32)
    want = np.asarray(JQ.quantized_matvec(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(biases),
        g, bits, tile_o=128, interpret=True))
    got = _decode_emulation(torch.from_numpy(x), _words(packed), torch.from_numpy(scales),
                            torch.from_numpy(biases), g, bits)
    assert got.shape == (1, o)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("o,i", [(64, 8192), (128, 3072)])
@pytest.mark.parametrize("outliers", [False, True])
def test_decode_emulation_meets_the_kernel_tolerance(bits, o, i, outliers):
    """The emulated decode kernel against the plain version at 1 row, within
    chip_smoke's QMM_RTOL (1e-4 of the largest output), also with a few
    columns of x at 100x; at [1, 8192] with 4 warps a row."""
    rng = np.random.default_rng(bits + i)
    _, (packed, scales, biases) = _packed(o, i, 32 if bits == 2 else 64, bits, seed=i,
                                          scale=0.02)
    x = rng.standard_normal((1, i)).astype(np.float32)
    if outliers:
        x[:, rng.choice(i, 6, replace=False)] *= 100.0
    args = (_words(packed), torch.from_numpy(scales), torch.from_numpy(biases),
            32 if bits == 2 else 64, bits)
    xt = torch.from_numpy(x)
    want = TQ.quantized_matvec_ref(xt, *args)
    got = _decode_emulation(xt, *args)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_tile_slices_fill_the_card():
    """The input-feature slices of the tile at the Orpheus-3B path shapes:
    at least TILE_BLOCKS blocks where the features allow, whole units."""
    got = [TQ.tile_slices(o, i, 64) for o, i in
           ((5120, 3072), (3072, 3072), (16384, 3072), (3072, 8192), (28673, 3072))]
    assert got == [7, 11, 3, 11, 2]
    assert TQ.tile_slices(156940, 3072, 64) == 1 and TQ.tile_slices(64, 128, 128) == 1
    assert TQ.tile_slices(64, 256, 32) == 4  # units of 64 features


def _tile_emulation(x, words, scales, biases, g, bits):
    """Emulation of the tile's arithmetic, not the kernel: x split into
    x_hi = bf16(x) and x_lo = bf16(x - x_hi) (bf16 x is its own one part),
    the codes signed (q - 2^(bits - 1)) and exact in bf16, each group's
    products summed in f32 into a fresh sum P, then ``scale * P + (bias +
    2^(bits - 1) * scale) * xg`` with xg the group's f32 sum of x, added over
    the groups in f32."""
    xf = x.float()
    hi = xf.to(torch.bfloat16)
    parts = [hi] if x.dtype == torch.bfloat16 else [hi, (xf - hi.float()).to(torch.bfloat16)]
    mid = float(1 << (bits - 1))
    codes = tquant._unpack(words, bits).float() - mid
    q = codes.to(torch.bfloat16)
    assert torch.equal(q.float(), codes)  # exact: integers -128..127
    b, i = x.shape
    o, n = words.shape[0], i // g
    qg = q.float().reshape(o, n, g)
    p = sum(torch.einsum("bnk,onk->bon", part.float().reshape(b, n, g), qg) for part in parts)
    xg = xf.reshape(b, n, g).sum(-1)
    s = scales.float()
    return (s * p + (biases.float() + mid * s) * xg[:, None, :]).sum(-1).to(x.dtype)


@pytest.mark.parametrize("bits,o,i,b,g", [
    (4, 96, 128, 2, 64), (8, 64, 256, 3, 64), (4, 300, 192, 2, 64),
    (4, 130, 256, 5, 32), (4, 72, 384, 9, 128), (8, 200, 256, 17, 32),
    (8, 64, 512, 33, 128), (4, 136, 256, 63, 64), (8, 40, 128, 64, 64)])
def test_tile_emulation_matches_jax_kernel(bits, o, i, b, g):
    """The emulated tile against the Pallas kernel in interpret mode, at the
    shapes and tolerance of the plain version's test above (rows >= 2)."""
    _, (packed, scales, biases) = _packed(o, i, g, bits)
    x = np.random.default_rng(1).standard_normal((b, i)).astype(np.float32)
    want = np.asarray(JQ.quantized_matvec(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(biases),
        g, bits, tile_o=128, interpret=True))
    got = _tile_emulation(torch.from_numpy(x), _words(packed), torch.from_numpy(scales),
                          torch.from_numpy(biases), g, bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("o,i", [(64, 8192), (128, 3072)])
@pytest.mark.parametrize("outliers", [False, True])
def test_tile_emulation_meets_the_kernel_tolerance(bits, o, i, outliers):
    """The emulated tile against the plain version at 63 rows, within
    chip_smoke's QMM_RTOL (1e-4 of the largest output) with f32 x, also with
    a few columns of x at 100x; bf16 alone (x_lo dropped) misses it."""
    rng = np.random.default_rng(bits + i)
    _, (packed, scales, biases) = _packed(o, i, 64, bits, seed=i, scale=0.02)
    x = rng.standard_normal((63, i)).astype(np.float32)
    if outliers:
        x[:, rng.choice(i, 6, replace=False)] *= 100.0
    args = (_words(packed), torch.from_numpy(scales), torch.from_numpy(biases), 64, bits)
    xt = torch.from_numpy(x)
    want = TQ.quantized_matvec_ref(xt, *args)
    err = float((_tile_emulation(xt, *args) - want).abs().max() / want.abs().max())
    assert err <= 1e-4
    hi_only = _tile_emulation(xt.to(torch.bfloat16).float(), *args)
    assert float((hi_only - want).abs().max() / want.abs().max()) > 1e-4


# -- quantizers, unpacking, dequantizing ------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_quantizers_match_jax_bit_for_bit(bits, g):
    """``quantize`` (numpy) against the JAX package's, and ``quantize_mlx``
    (tensors; 2-D and stacked) against ``quantize_jax``: words, scales and
    biases bit for bit, with one constant group (scale 1e-8)."""
    rng = np.random.default_rng(bits * 1000 + g)
    w = (rng.standard_normal((2, 24, 256)) * 0.02).astype(np.float32)
    w[0, 3, :g] = 0.5
    for a, b in zip(tquant.quantize(w[0], g, bits), jquant.quantize(w[0], g, bits)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for arr in (w[1], w):
        want = [np.asarray(t) for t in jquant.quantize_jax(jnp.asarray(arr), g, bits)]
        got = tquant.quantize_mlx(torch.from_numpy(arr), g, bits)
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), want[0].view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_unpack_and_dequantize_match_jax(bits):
    """Codes from int32 words (arithmetic shift, then the mask) equal the
    JAX package's uint32 unpacking; dequantize is bit-equal in f32 and
    bf16, stacked leading dims included."""
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((3, 16, 128)).astype(np.float32)
    packed, scales, biases = (np.array(t) for t in
                              jquant.quantize_jax(jnp.asarray(w), 32, bits))
    assert (packed >= 2 ** 31).any()  # words whose int32 is negative
    np.testing.assert_array_equal(tquant._unpack(_words(packed), bits).numpy(),
                                  np.asarray(jquant._unpack(jnp.asarray(packed), bits)))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize(jnp.asarray(packed), jnp.asarray(scales),
                                            jnp.asarray(biases), 32, bits, jdt)).astype(np.float32)
        got = tquant.dequantize(_words(packed), torch.from_numpy(scales),
                                torch.from_numpy(biases), 32, bits, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def _tree(rng):
    """A llama-like tree (stacked layers, embedding, norms) whose eligible
    leaves both packages quantize, and leaves they must leave dense."""
    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    return {"model": {
        "embed_tokens": {"weight": w(40, 256)},
        "layers": {"self_attn": {"q_proj": {"weight": w(2, 64, 256)},
                                 "o_proj": {"weight": w(2, 256, 64)}},  # I < 256
                   "mlp": {"down_proj": {"weight": w(2, 256, 512), "bias": w(2, 256)}},
                   "input_layernorm": {"weight": w(2, 256)}},
        "norm": {"weight": w(256, 256)},
        "conv": {"weight": w(8, 256, 3)},
        "odd": {"weight": w(8, 288)}}}  # 288 % 64 != 0


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_tree_mlx_matches_jax(bits):
    """``quantize_tree(scheme="mlx")`` quantizes the leaves the JAX
    package's does, to the same words, scales and biases."""
    tree = _tree(np.random.default_rng(bits))
    want = loading.flatten(jax_tree_to_numpy(jquant.quantize_tree(
        jax.tree.map(jnp.asarray, tree), bits=bits, word_scales=False)))
    got = loading.flatten(tquant.quantize_tree(
        jax.tree.map(torch.from_numpy, tree), bits=bits, scheme="mlx"))
    assert want.keys() == got.keys()
    n = 0
    for k, wv in want.items():
        gv = got[k]
        if isinstance(gv, tquant.QuantizedTensor):
            n += 1
            assert (gv.group_size, gv.bits) == (wv.group_size, wv.bits) == (64, bits), k
            np.testing.assert_array_equal(gv.weight.numpy(), wv.weight.view(np.int32))
            np.testing.assert_array_equal(gv.scales.numpy(), wv.scales)
            np.testing.assert_array_equal(gv.biases.numpy(), wv.biases)
        else:
            assert not hasattr(wv, "group_size"), k
            np.testing.assert_array_equal(gv.numpy(), wv)
    assert n == 3  # the embedding, q_proj and down_proj


def test_tag_quantized_and_dequantize_tree_match_jax():
    """Checkpoint triples (a linear bias beside one) fold into
    QuantizedTensor leaves as the JAX package folds them; dense leaves and
    ints stay; ``dequantize_tree`` gives the JAX dense weights."""
    rng = np.random.default_rng(5)
    flat = {}
    for name in ("a.q_proj", "a.fc1", "b.embed_tokens"):
        _, (p, s, b) = _packed(16, 64, 16, 4, seed=len(flat))
        flat.update({f"{name}.weight": p, f"{name}.scales": s, f"{name}.biases": b})
    flat["a.fc1.bias"] = rng.standard_normal(16).astype(np.float32)
    flat["a.norm.weight"] = np.ones(64, np.float32)
    jtree = jquant.tag_quantized(loading.unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
                                 16, 4, word_scales=False)
    ttree = tquant.tag_quantized(loading.unflatten(
        {k: _words(v) if v.dtype == np.uint32 else torch.from_numpy(v)
         for k, v in flat.items()}), 16, 4)
    assert isinstance(ttree["a"]["fc1"]["weight"], tquant.QuantizedTensor)
    assert sorted(ttree["a"]["fc1"]) == ["bias", "weight"]
    assert all(tquant.is_quantized(ttree["a"][k]) for k in ("q_proj", "fc1"))
    assert not tquant.is_quantized(ttree["a"]["norm"])
    want = loading.flatten(jax_tree_to_numpy(jquant.dequantize_tree(jtree, jnp.float32)))
    got = loading.flatten(tquant.dequantize_tree(ttree, torch.float32))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_slice_rows_keeps_the_packed_layout():
    """The band head of a packed table: the JAX package's rows, words,
    scales and biases."""
    _, (p, s, b) = _packed(50, 128, 32, 4)
    rows = np.asarray([3, 49, 0, 7, 7])
    jw = jquant.QuantizedTensor(jnp.asarray(p), jnp.asarray(s), jnp.asarray(b), None, 32, 4)
    want = jquant.slice_rows({"weight": jw}, rows)["weight"]
    got = tquant.slice_rows({"weight": from_jax_params(jax_tree_to_numpy(jw))}, rows)["weight"]
    assert (got.group_size, got.bits) == (32, 4)
    for g, w in ((got.weight, want.weight), (got.scales, want.scales), (got.biases, want.biases)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).view(g.numpy().dtype))


def test_layers_match_jax_on_packed_weights():
    """``embedding`` (gathered rows dequantized to f32, whatever the scales'
    dtype), ``embedding_as_linear`` and ``linear`` with a bias, against the
    JAX layers."""
    _, (p, s, b) = _packed(40, 256, 64, 4, scale=0.05)
    s16, b16 = s.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
    jw = jquant.QuantizedTensor(jnp.asarray(p), jnp.asarray(s16), jnp.asarray(b16), None, 64, 4)
    tw = from_jax_params(jax_tree_to_numpy(jw))
    ids = np.asarray([[3, 39, 0], [7, 7, 1]], np.int32)
    want = np.asarray(jnn.embedding({"weight": jw}, jnp.asarray(ids)))
    got = tnn.embedding({"weight": tw}, torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.default_rng(0).standard_normal((2, 3, 256)).astype(np.float32)
    bias = np.linspace(-1, 1, 40).astype(np.float32)
    for jfn, tfn, jp, tp in ((jnn.embedding_as_linear, tnn.embedding_as_linear,
                              {"weight": jw}, {"weight": tw}),
                             (jnn.linear, tnn.linear, {"weight": jw, "bias": jnp.asarray(bias)},
                              {"weight": tw, "bias": torch.from_numpy(bias)})):
        want = np.asarray(jfn(jp, jnp.asarray(x)))
        got = tfn(tp, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_fuse_projections_on_packed_layers_matches_jax():
    """q/k/v and gate/up fuse along the output axis, per-layer and stacked,
    as the JAX package fuses them; parts that differ in group size stay
    apart, and so do raw checkpoint triples."""
    rng = np.random.default_rng(0)

    def layer(gs=(64, 64, 64)):
        def q(o, g):
            return jquant.QuantizedTensor(*jquant.quantize_jax(
                jnp.asarray(rng.standard_normal((o, 256)).astype(np.float32)), g, 4),
                None, g, 4)
        return {"self_attn": {n: {"weight": q(o, g)} for n, o, g in
                              zip(("q_proj", "k_proj", "v_proj"), (64, 32, 32), gs)},
                "mlp": {"gate_proj": {"weight": q(96, 64)}, "up_proj": {"weight": q(96, 64)}}}

    for stacked in (False, True):
        j = {"model": {"layers": {"0": layer(), "1": layer()}}}
        t = from_jax_params(jax_tree_to_numpy(j))
        if stacked:
            j, t = JL.maybe_stack(j), TL.maybe_stack(t)
            assert isinstance(t["model"]["layers"]["mlp"]["up_proj"]["weight"],
                              tquant.QuantizedTensor)
        want = jax_tree_to_numpy(JL.fuse_projections(j))["model"]["layers"]
        got = TL.fuse_projections(t)["model"]["layers"]
        for lw, lg in ([(want, got)] if stacked else
                       [(want[k], got[k]) for k in ("0", "1")]):
            for sub, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj")):
                w, g = lw[sub][name]["weight"], lg[sub][name]["weight"]
                np.testing.assert_array_equal(g.weight.numpy(), w.weight.view(np.int32))
                np.testing.assert_array_equal(g.scales.numpy(), w.scales)
                np.testing.assert_array_equal(g.biases.numpy(), w.biases)
    mixed = from_jax_params(jax_tree_to_numpy({"model": {"layers": {"0": layer((64, 32, 64))}}}))
    assert "q_proj" in TL.fuse_projections(mixed)["model"]["layers"]["0"]["self_attn"]
    raw = {"model": {"layers": {"0": {"self_attn": {n: {
        "weight": torch.zeros((8, 32), dtype=torch.int32), "scales": torch.ones((8, 4)),
        "biases": torch.zeros((8, 4))} for n in ("q_proj", "k_proj", "v_proj")},
        "mlp": {}}}}}
    assert "q_proj" in TL.fuse_projections(raw)["model"]["layers"]["0"]["self_attn"]


def test_checkpoint_words_load_as_int32_bits(tmp_path):
    """A safetensors file's U32 words load as int32 of the same bits; the
    loader casts the scales and biases to the requested dtype, as the JAX
    loader does, and tagging folds the triple."""
    from safetensors.numpy import save_file

    _, (p, s, b) = _packed(24, 128, 32, 4)
    save_file({"l.weight": p, "l.scales": s, "l.biases": b}, str(tmp_path / "model.safetensors"))
    params = loading.load_params(tmp_path, dtype=torch.bfloat16)
    assert params["l"]["weight"].dtype == torch.int32
    np.testing.assert_array_equal(params["l"]["weight"].numpy().view(np.uint32), p)
    assert params["l"]["scales"].dtype == torch.bfloat16
    qt = tquant.tag_quantized(params, 32, 4)["l"]["weight"]
    assert isinstance(qt, tquant.QuantizedTensor) and qt.bits == 4


def test_tree_module_round_trips_packed_leaves():
    """A packed leaf held as module buffers comes back as a QuantizedTensor
    with its group size and bits, after ``.to(...)`` too."""
    _, (p, s, b) = _packed(8, 64, 32, 8)
    qt = tquant.QuantizedTensor(_words(p), torch.from_numpy(s), torch.from_numpy(b), 32, 8)
    mod = loading.TreeModule({"fc": {"weight": qt, "bias": torch.zeros(8)}})
    assert "fc.weight.scales" in mod.state_dict()
    mod.to(torch.float64)  # floats only: the words stay int32
    got = mod.tree()["fc"]["weight"]
    assert isinstance(got, tquant.QuantizedTensor) and (got.group_size, got.bits) == (32, 8)
    assert got.weight.dtype == torch.int32 and got.scales.dtype == torch.float64
    assert torch.equal(got.weight, qt.weight)
