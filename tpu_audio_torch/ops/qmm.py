"""MLX grouped-affine GEMV: ``x [B, I] @ W.T -> [B, O]`` with W in MLX's
packed 4/8-bit layout (see ``core.quant``).

Port of tpu_audio/ops/pallas_qmm.py:quantized_matvec; the CUDA kernels are
in ``csrc/qmm.cu``: the decode kernel for one row of whole 16-byte chunks,
a GEMV for rows that are not, and a bf16 tensor-core tile for ``R_TILE``
to 64 rows (:func:`route` picks one by shape).
:func:`quantized_matvec_ref` is the plain PyTorch version. The TPU
kernel's word-scale planes (``scales_w``) are left out: the kernels read
scales and biases per group in their stored dtype.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.ops import _lib

__all__ = ["quantized_matvec", "quantized_matvec_ref", "route", "decode", "gemv", "tile",
           "decode_shape", "BITS", "GROUP_SIZES", "MAX_ROWS", "R_TILE"]

BITS = (2, 4, 8)
GROUP_SIZES = (32, 64, 128)
MAX_ROWS = 64  # the rows of x the kernel takes: core.quant sends it no more
R_TILE = 2  # the fewest rows the tile takes: below, the GEMV (see PERF.md)
SMEM_BYTES = 232448  # shared memory a block may have on the H100
TILE_BM = 128  # output features a block of the tile (csrc/qmm.cu)
TILE_KC = 64  # input features a stage of the tile
TILE_BLOCKS = 264  # blocks the tile aims for: two on each of the H100's 132 SMs
DECODE_WARPS = 8  # warps a block of the decode kernel (csrc/qmm.cu)
DECODE_BLOCKS = 264  # blocks the decode kernel aims for: two on each SM
DECODE_NC = (1, 2, 3, 4, 5, 8)  # its chunks a lane a pass (template values)
# dtype codes of csrc/qmm.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantized_matvec_ref(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                         biases: torch.Tensor, group_size: int = 64, bits: int = 4
                         ) -> torch.Tensor:
    """Plain version: dequantize W to f32, ``x @ W.T`` in f32, the result in
    ``x``'s dtype."""
    from tpu_audio_torch.core.quant import dequantize

    w = dequantize(words, scales, biases, group_size, bits, dtype=torch.float32)
    return (x.to(torch.float32) @ w.t()).to(x.dtype)


def rows_a_pass(b: int, i: int, group_size: int, bits: int) -> int:
    """The rows of x the kernel stages a pass (1, 2, 4 or 8): the fewest
    that cover ``b``, at most as many as the shared memory holds (a row's
    f32 planes, each padded by 4 floats, and its group sums: ``(i + 4 * 32
    / bits + i / group_size) * 4`` bytes); 0 when not one row fits."""
    per_row = (i + 4 * (32 // bits) + i // group_size) * 4
    fit = [r for r in (1, 2, 4, 8) if r * per_row <= SMEM_BYTES]
    return next((r for r in fit if r >= b), fit[-1]) if fit else 0


def route(b: int, i: int, bits: int, aligned: bool) -> str:
    """Which code computes ``x [b, i] @ W.T`` for W packed at ``bits`` (in
    any group size the kernels take): ``"dequantize"`` (W to x's dtype and a matmul,
    in ``core.quant.quantized_matmul``) above MAX_ROWS rows; the GEMV
    (``"gemv"``) where the rows of W are not whole 16-byte chunks
    (``i * bits % 128 != 0``) or W or x does not start on a 16-byte boundary
    (``aligned`` false), since the decode kernel and the tile load 16 bytes
    at a time; else the decode kernel (``"decode"``) for 1 row whose x fits
    its shared memory (wider rows to the GEMV, which raises on them too), and
    the tile (``"tile"``) for R_TILE..MAX_ROWS rows. The rule reads shapes
    and pointers, never the outcome of a launch."""
    if b > MAX_ROWS:
        return "dequantize"
    if not (aligned and i * bits % 128 == 0):
        return "gemv"
    if b == 1:
        return "decode" if decode_fits(i, bits) else "gemv"
    return "tile" if b >= R_TILE else "gemv"


def decode_fits(i: int, bits: int) -> bool:
    """Whether the decode kernel's shared memory holds x's ``i`` f32 planes
    (each padded by 4 floats) and its warps' partial sums."""
    return (i + 4 * (32 // bits) + 2 * DECODE_WARPS) * 4 <= SMEM_BYTES


def decode_shape(o: int, i: int, bits: int) -> tuple[int, int, int, int]:
    """The decode kernel's launch for ``[1, i] @ W.T`` with ``o`` output
    rows: ``(blocks, rows a warp, warps a row, chunks a lane a pass)``.
    Two rows a warp where that still gives DECODE_BLOCKS blocks of
    DECODE_WARPS warps, else one; then a row's 16-byte chunks split over 2
    or 4 warps while the blocks fall short of DECODE_BLOCKS and each warp
    keeps 32 chunks or more; the chunks a lane a pass is the least of
    DECODE_NC that covers the lane's share (8, in passes, above 8)."""
    cr = i * bits // 128  # chunks a row
    rw = 2 if -(-o // (2 * DECODE_WARPS)) >= DECODE_BLOCKS else 1
    ks = 1
    while (ks < 4 and -(-o * ks // (DECODE_WARPS * rw)) < DECODE_BLOCKS
           and -(-cr // (2 * ks)) >= 32):
        ks *= 2
    nct = -(-cr // (32 * ks))
    nc = next((n for n in DECODE_NC if n >= nct), DECODE_NC[-1])
    return -(-o * ks // (DECODE_WARPS * rw)), rw, ks, nc


def tile_slices(o: int, i: int, group_size: int) -> int:
    """The slices of the input features the tile splits a call into: enough
    blocks (ceil(o / TILE_BM) a slice) for TILE_BLOCKS, each slice at least
    one unit of max(TILE_KC, group_size) features."""
    units = -(-i // max(TILE_KC, group_size))
    blocks = -(-o // TILE_BM)
    return max(1, min(units, -(-TILE_BLOCKS // blocks)))


def _aligned(x: torch.Tensor, words: torch.Tensor) -> bool:
    return words.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0


def _checked(x, words, scales, biases, group_size, bits):
    """Check what both kernels take; raise on anything else."""
    b, i = x.shape
    o, n_words = words.shape
    if bits not in BITS or group_size not in GROUP_SIZES:
        raise ValueError(f"quantized_matvec: bits {bits}, group size {group_size} "
                         f"(the kernel takes bits {BITS} and groups {GROUP_SIZES})")
    if i % group_size or n_words * (32 // bits) != i:
        raise ValueError(f"quantized_matvec: {i} input features, {n_words} words at "
                         f"{bits} bits in groups of {group_size}")
    if not 1 <= b <= MAX_ROWS:
        raise ValueError(f"quantized_matvec: {b} rows (the kernel takes 1 to {MAX_ROWS})")
    if x.dtype not in _DTYPES or scales.dtype not in _DTYPES:
        raise ValueError(f"quantized_matvec: dtypes x {x.dtype}, scales {scales.dtype} "
                         "(the kernel takes f32, bf16 or f16)")
    dev = x.device
    _lib.require(x, "x", x.dtype, (b, i), dev)
    _lib.require(words, "words", torch.int32, (o, n_words), dev)
    for name, t in (("scales", scales), ("biases", biases)):
        _lib.require(t, name, scales.dtype, (o, i // group_size), dev)
    return b, o, i


def decode(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
           group_size: int = 64, bits: int = 4) -> torch.Tensor:
    """The decode kernel on CUDA tensors: 1 row of x, the rows of x and W
    whole 16-byte chunks on 16-byte aligned pointers (see :func:`route`)."""
    b, o, i = _checked(x, words, scales, biases, group_size, bits)
    if route(b, i, bits, _aligned(x, words)) != "decode":
        raise ValueError("quantized_matvec: the decode kernel takes 1 row of x with 16-byte "
                         f"aligned rows of x and W that fit its shared memory; got {b} rows "
                         f"of {i} inputs at {bits} bits")
    return _decode(x, words, scales, biases, group_size, bits, b, o, i)


def _decode(x, words, scales, biases, group_size, bits, b, o, i):
    _, rw, ks, nc = decode_shape(o, i, bits)
    out = torch.empty((1, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib.lib().tpa_quantized_matvec_decode(
            x.data_ptr(), _DTYPES[x.dtype], words.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), _DTYPES[scales.dtype], out.data_ptr(), o, i, group_size, bits,
            nc, rw, ks, _lib.stream(x))
    _lib.check(err, "quantized_matvec_decode")
    _lib.launches["quantized_matvec"] += 1
    _lib.launches["quantized_matvec_decode"] += 1
    return out


def gemv(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
         group_size: int = 64, bits: int = 4) -> torch.Tensor:
    """The GEMV kernel on CUDA tensors, at any 1-64 rows (it stages up to 8
    rows of x a pass and reads the weights again for each pass)."""
    return _gemv(x, words, scales, biases, group_size, bits,
                 *_checked(x, words, scales, biases, group_size, bits))


def _gemv(x, words, scales, biases, group_size, bits, b, o, i):
    rb = rows_a_pass(b, i, group_size, bits)
    if rb == 0:
        raise ValueError(f"quantized_matvec: {i} input features exceed the kernel's "
                         "shared memory")
    vec = int(words.shape[1] % 4 == 0 and words.data_ptr() % 16 == 0)
    out = torch.empty((b, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib.lib().tpa_quantized_matvec(
            x.data_ptr(), _DTYPES[x.dtype], words.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), _DTYPES[scales.dtype], out.data_ptr(), b, o, i,
            group_size, bits, rb, vec, _lib.stream(x))
    _lib.check(err, "quantized_matvec")
    _lib.launches["quantized_matvec"] += 1
    return out


def tile(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
         group_size: int = 64, bits: int = 4) -> torch.Tensor:
    """The tensor-core tile on CUDA tensors, at any 1-64 rows of x whose rows
    and W's are 16-byte aligned (see :func:`route`): a first kernel splits x
    into bf16 parts and takes its group sums, the tile splits the input
    features into :func:`tile_slices` slices, and a third kernel adds their
    f32 partial sums in slice order."""
    b, o, i = _checked(x, words, scales, biases, group_size, bits)
    if not (_aligned(x, words) and i * bits % 128 == 0):
        raise ValueError("quantized_matvec: the tile needs 16-byte aligned rows of x and W "
                         f"(I * bits % 128 == 0); got I {i} at {bits} bits")
    return _tile(x, words, scales, biases, group_size, bits, b, o, i)


def _tile(x, words, scales, biases, group_size, bits, b, o, i):
    slices = tile_slices(o, i, group_size)
    out = torch.empty((b, o), dtype=x.dtype, device=x.device)
    # one scratch buffer: x split into bf16 parts (4 bytes an input; bf16 x,
    # its own one part, 2), x's f32 group sums at byte xg, and for slices > 1
    # the slices' f32 partial sums at byte part (16-byte aligned)
    xg = b * i * (2 if x.dtype == torch.bfloat16 else 4)
    part = xg + -(-b * (i // group_size) * 4 // 16) * 16
    size = part + (slices * b * o * 4 if slices > 1 else 0)
    scratch = torch.empty(size, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with torch.cuda.device(x.device):
        err = _lib.lib().tpa_quantized_matvec_tile(
            x.data_ptr(), _DTYPES[x.dtype], words.data_ptr(), scales.data_ptr(),
            biases.data_ptr(), _DTYPES[scales.dtype], out.data_ptr(), base, base + xg,
            base + part if slices > 1 else 0, b, o, i, group_size, bits, slices,
            _lib.stream(x))
    _lib.check(err, "quantized_matvec_tile")
    _lib.launches["quantized_matvec"] += 1
    _lib.launches["quantized_matvec_tile"] += 1
    return out


def quantized_matvec(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
                     biases: torch.Tensor, group_size: int = 64, bits: int = 4
                     ) -> torch.Tensor:
    """``x @ dequant(W).T`` for ``x [B, I]`` (B <= 64), words ``[O, I * bits
    / 32]`` (int32 bits), scales and biases ``[O, I / group_size]``: the plain
    version for CPU tensors; for CUDA tensors the decode kernel, the GEMV or
    the tile, as :func:`route` says, in ``x``'s dtype. The kernels take bits
    2, 4 and 8, groups of 32, 64 and 128, f32, bf16 or f16 ``x`` and scales,
    any O; they raise on anything else. ``_lib.launches["quantized_matvec"]``
    counts the calls of every kernel, ``["quantized_matvec_decode"]`` and
    ``["quantized_matvec_tile"]`` those of the decode kernel and the tile."""
    if x.device.type == "cpu":
        return quantized_matvec_ref(x, words, scales, biases, group_size, bits)
    b, o, i = _checked(x, words, scales, biases, group_size, bits)
    launch = {"decode": _decode, "tile": _tile}.get(route(b, i, bits, _aligned(x, words)),
                                                    _gemv)
    return launch(x, words, scales, biases, group_size, bits, b, o, i)
