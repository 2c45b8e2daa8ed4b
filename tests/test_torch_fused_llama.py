"""Host side of the one-token Llama decoder kernel
(``tpu_audio_torch/ops/fused_llama.py``, ``fused_llama_stack``): the
scratch regions the wrapper allocates, the arrival counters of the kernel's
folded attention combines, and the widths its quantise launches take. The kernel itself runs only on a CUDA card (``chip_smoke.py``)."""

from __future__ import annotations

import pytest
import torch

from tpu_audio_torch.core import quant
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.tts import llama_tts as TT
from tpu_audio_torch.ops import _lib
from tpu_audio_torch.ops import fused_llama as FL

from test_torch_tts import FUSED

ORPHEUS = (28, 3072, 8192, 24, 8)  # (L, d, ffn, H, n_kv) of Orpheus-3B
# (L, d, ffn, H, n_kv, s_max): Orpheus-3B over caches of 1 row, of 401 rows
# (chip_smoke's timed offset 400 at its last row), of kernel 6's longest
# cache and past it; the 2-layer qk_norm stack and Llama-3.1-8B's width over
# chip_smoke's 1280-row cache; tests/test_torch_tts.py's fixture width over
# a cache that is not a whole number of 64-position chunks
WIDTHS = [(*ORPHEUS, 1), (*ORPHEUS, 401), (*ORPHEUS, 28352), (*ORPHEUS, 40001),
          (2, 3072, 8192, 24, 8, 1280), (2, 4096, 14336, 32, 8, 1280),
          (2, 1024, 2048, 8, 4, 150)]


def chunks(s: int) -> int:
    return -(-s // _lib.ATTN_CHUNK)


@pytest.mark.parametrize("L, d, ffn, H, n_kv, s_max", WIDTHS)
def test_scratch_regions_are_disjoint_and_fill_the_buffer(L, d, ffn, H, n_kv, s_max):
    layout = FL.scratch_layout(L, d, ffn, H, n_kv, s_max)
    total = layout.pop("total")
    assert [name for name, _ in sorted(layout.items(), key=lambda kv: kv[1])] == [
        "attn", "h", "xs", "part_o", "part_ml", "counts"]
    at = 0
    for start, length in sorted(layout.values()):
        assert start == at and length > 0
        at = start + length
    assert at == total
    assert layout["attn"][1] == d and layout["h"][1] == ffn and layout["xs"][1] == 4
    # the quantise launches and the o GEMV copy attn and h with 16-byte
    # copies: both start on 4 words
    assert layout["attn"][0] % 4 == 0 and layout["h"][0] % 4 == 0


@pytest.mark.parametrize("L, d, ffn, H, n_kv, s_max", WIDTHS)
def test_each_layer_and_kv_head_has_its_own_counter(L, d, ffn, H, n_kv, s_max):
    # the combine of layer l and KV head g counts at word l * n_kv + g of
    # this region, which the wrapper zeroes; it is the buffer's last region,
    # so nothing else is zeroed
    layout = FL.scratch_layout(L, d, ffn, H, n_kv, s_max)
    start, length = layout["counts"]
    assert start + length == layout["total"]
    assert {l * n_kv + g for l in range(L) for g in range(n_kv)} == set(range(length))


@pytest.mark.parametrize("offset, valid_from", [(0, 0), (400, 0), (1025, 40), (28351, 0),
                                                (40000, 37)])
def test_every_call_finds_room_for_its_live_chunks(offset, valid_from):
    # a call at `offset` over a cache of offset + 1 rows lays out the
    # partials of its (offset - valid_from) / 64 + 1 live chunks, [H, nc,
    # 128] and [H, nc, 2], in the first words of the two regions
    L, d, ffn, H, n_kv = ORPHEUS
    layout = FL.scratch_layout(L, d, ffn, H, n_kv, offset + 1)
    nc = (offset - valid_from) // _lib.ATTN_CHUNK + 1
    assert nc == chunks(offset + 1 - valid_from)
    assert H * nc * FL.HEAD_DIM <= layout["part_o"][1]
    assert H * nc * 2 <= layout["part_ml"][1]


def _cfg(**kw):
    return TL.LlamaConfig(**{**FUSED, **kw})


def test_supported_states_the_quantise_launches_shared_memory():
    """A quantise launch stages its input row in shared memory: a
    hidden-wide RMSNorm input takes 12 bytes a column (its f32 row, the
    RMSNorm weight, the normed row), the down projection's SwiGLU row 8 (the
    row and its copy), within the 226 KB of QUANT_SMEM. Every width the
    repo checks fits, and Llama-3.1-70B's; the cache length does not
    enter."""
    orpheus = _cfg(hidden_size=3072, num_hidden_layers=28, intermediate_size=8192,
                   num_attention_heads=24, num_key_value_heads=8)
    llama8b = _cfg(hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
                   num_key_value_heads=8)
    llama70b = _cfg(hidden_size=8192, intermediate_size=28672, num_attention_heads=64,
                    num_key_value_heads=8)
    for cfg in (orpheus, llama8b, llama70b, _cfg(qk_norm=True), _cfg(intermediate_size=16384)):
        assert FL.supported(cfg)
    assert 12 * 19200 <= FL.QUANT_SMEM < 12 * 19328
    assert FL.supported(_cfg(hidden_size=19200, num_attention_heads=150,
                             num_key_value_heads=1))
    assert not FL.supported(_cfg(hidden_size=19328, num_attention_heads=151,
                                 num_key_value_heads=1))
    assert 8 * 28928 <= FL.QUANT_SMEM < 8 * 28944
    assert FL.supported(_cfg(intermediate_size=28928))
    assert not FL.supported(_cfg(intermediate_size=28944))
    assert not FL.supported(_cfg(hidden_size=16384, intermediate_size=53248,
                                 num_attention_heads=128, num_key_value_heads=8))


def test_fused_route_states_the_width_limit():
    """On CUDA a w8a8 tree whose ffn is past the kernel's limit raises when
    its route is chosen, and one at the limit takes the kernel (the route
    reads the config's widths, so the fixture's weights stand in)."""
    params = quant.quantize_tree(TL.init_random_params(TL.LlamaConfig(**FUSED), seed=3,
                                                       dtype=torch.float32), scheme="w8a8")
    cuda = torch.device("cuda")
    assert TT._fused_route(params, TT.LlamaTTSConfig(**dict(FUSED, intermediate_size=28928)),
                           cuda)
    with pytest.raises(NotImplementedError, match="fused_llama_stack"):
        TT._fused_route(params, TT.LlamaTTSConfig(**dict(FUSED, intermediate_size=28944)),
                        cuda)
