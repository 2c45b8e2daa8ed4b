"""Host side of the Llama serving lanes kernel
(``tpu_audio_torch/ops/fused_llama.py``, ``fused_llama_stack_lanes``): the
scratch regions the wrapper allocates, the arrival counters of the
kernel's folded attention combines, and the longest cache it takes. The
kernel itself runs only on a CUDA card (``chip_smoke.py``)."""

from __future__ import annotations

import pytest
import torch

from tpu_audio_torch.core import quant
from tpu_audio_torch.models import llama as TL
from tpu_audio_torch.models.tts import llama_tts as TT
from tpu_audio_torch.ops import _lib
from tpu_audio_torch.ops import fused_llama as FL

from test_torch_tts import FUSED, SMALL_TOKENS, _tokenizer

# (n, L, d, ffn, H, n_kv, s_max): Orpheus-3B at 1, 4 and its 28-lane limit
# over chip_smoke's 1280-row cache, the 2-layer qk_norm stack at Orpheus
# width, and tests/test_torch_tts.py's fixture width over a cache that is
# not a whole number of 64-position chunks
WIDTHS = [(1, 28, 3072, 8192, 24, 8, 1280), (4, 28, 3072, 8192, 24, 8, 1280),
          (28, 28, 3072, 8192, 24, 8, 1280), (4, 2, 3072, 8192, 24, 8, 1280),
          (2, 2, 1024, 2048, 8, 4, 150)]


def chunks(s: int) -> int:
    return -(-s // _lib.ATTN_CHUNK)


@pytest.mark.parametrize("n, L, d, ffn, H, n_kv, s_max", WIDTHS)
def test_scratch_regions_are_disjoint_and_fill_the_buffer(n, L, d, ffn, H, n_kv, s_max):
    layout = FL.lanes_scratch_layout(n, L, d, ffn, H, n_kv, s_max)
    total = layout.pop("total")
    assert [name for name, _ in sorted(layout.items(), key=lambda kv: kv[1])] == [
        "attn", "gu", "xs", "part_o", "part_ml", "counts"]
    at = 0
    for start, length in sorted(layout.values()):
        assert start == at and length > 0
        at = start + length
    assert at == total
    # every lane's attention, up to the cache's last row, finds room for the
    # partials of every query head
    nc = chunks(s_max)
    assert layout["part_o"] == (layout["part_o"][0], n * H * nc * FL.HEAD_DIM)
    assert layout["part_ml"][1] == n * H * nc * 2
    assert layout["attn"][1] == n * d and layout["gu"][1] == n * 2 * ffn
    # the partials are read by 16-byte loads: their region starts on 4 words
    assert layout["xs"][1] % 4 == 0 and layout["part_o"][0] % 4 == 0


@pytest.mark.parametrize("n, L, d, ffn, H, n_kv, s_max", WIDTHS)
def test_each_layer_kv_head_and_lane_has_its_own_counter(n, L, d, ffn, H, n_kv, s_max):
    # the combine of layer l, KV head g and lane m counts at word
    # (l * n_kv + g) * n + m of this region, which the wrapper zeroes; it
    # is the buffer's last region, so nothing else is zeroed
    layout = FL.lanes_scratch_layout(n, L, d, ffn, H, n_kv, s_max)
    start, length = layout["counts"]
    assert start + length == layout["total"]
    words = {(l * n_kv + g) * n + m for l in range(L) for g in range(n_kv) for m in range(n)}
    assert words == set(range(length))


def test_the_longest_cache_fits_one_heads_partials():
    # the folded combine stages one query head's [nc, 128 + 2] f32 partials
    # beside the attention kernel's static scratch (under 2 KB)
    def smem(s_max):
        return chunks(s_max) * (FL.HEAD_DIM + 2) * 4 + 2048

    assert FL.LANES_S_MAX == 28352 and FL.LANES_S_MAX % _lib.ATTN_CHUNK == 0
    assert smem(FL.LANES_S_MAX) <= FL.SMEM_OPT_IN < smem(FL.LANES_S_MAX + 1)


def test_lane_hooks_refuse_a_cache_the_kernel_does_not_take():
    """The serving tick's hooks raise when they are built, not at every
    tick, for a cache longer than LANES_S_MAX rows."""
    cfg = TL.LlamaConfig(**FUSED)
    params = quant.quantize_tree(TL.init_random_params(cfg, seed=3, dtype=torch.float32),
                                 scheme="w8a8")
    model = TT.LlamaTTS(TT.LlamaTTSConfig(**FUSED), params, tokenizer=_tokenizer(),
                        tokens=TT.OrpheusTokens(**SMALL_TOKENS), dtype=torch.float32)
    assert model._fused_lane_hooks(FL.LANES_S_MAX) is not None
    with pytest.raises(NotImplementedError, match="28352 rows"):
        model._fused_lane_hooks(FL.LANES_S_MAX + 1)
