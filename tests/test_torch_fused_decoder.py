"""Host-side layout of the one-token Whisper decoder kernel
(``tpu_audio_torch/ops/fused_decoder.py``): the scratch regions the wrapper
allocates and the arrival counters of the kernel's folded attention
combines. The kernel itself runs only on a CUDA card (``chip_smoke.py``)."""

from __future__ import annotations

import pytest
import torch

from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.ops import _lib
from tpu_audio_torch.ops import fused_decoder as TF

# (d, ffn, L, H, s_max, s_src): whisper-large-v3, the CPU tests' fixture
# (tests/test_torch_ops.py CFG), a source shorter than the cache, and a
# source that is not a whole number of 64-position chunks
WIDTHS = [(1280, 5120, 32, 20, 448, 1500), (256, 1024, 2, 4, 64, 150),
          (384, 1536, 4, 6, 448, 100), (1280, 5120, 32, 20, 448, 1499)]


def chunks(n: int) -> int:
    return -(-n // _lib.ATTN_CHUNK)


@pytest.mark.parametrize("d, ffn, L, H, s_max, s_src", WIDTHS)
def test_scratch_regions_are_disjoint_and_fill_the_buffer(d, ffn, L, H, s_max, s_src):
    layout = TF.scratch_layout(d, ffn, L, H, s_max, s_src)
    total = layout.pop("total")
    spans = sorted(layout.values())
    assert [name for name, _ in sorted(layout.items(), key=lambda kv: kv[1])] == [
        "attn", "q2", "ca", "h", "part_o", "part_ml", "counts"]
    at = 0
    for start, length in spans:
        assert start == at and length > 0
        at = start + length
    assert at == total
    # every self-attention (offset up to s_max - 1) and cross-attention
    # launch finds room for its partials
    nc = max(chunks(s_max), chunks(s_src))
    hd = d // H
    assert layout["part_o"][1] == H * nc * hd and layout["part_ml"][1] == H * nc * 2
    assert layout["h"][1] == ffn and layout["attn"][1] == layout["q2"][1] == d


@pytest.mark.parametrize("d, ffn, L, H, s_max, s_src", WIDTHS)
def test_counter_region_holds_one_counter_for_each_layer_stage_and_head(
        d, ffn, L, H, s_max, s_src):
    # the kernel's combine of layer l, stage (0 self, 1 cross) and head h
    # counts at word (2 l + stage) H + h of this region, which the wrapper
    # zeroes; it is the buffer's last region, so nothing else is zeroed
    layout = TF.scratch_layout(d, ffn, L, H, s_max, s_src)
    start, length = layout["counts"]
    assert length == L * 2 * H
    assert start + length == layout["total"]


def _tiny_stack(seed: int = 0):
    """A random 2-layer pack, cross K/V and caches at d 128 (2 heads)."""
    cfg = TW.WhisperConfig(d_model=128, decoder_attention_heads=2, decoder_ffn_dim=256,
                           decoder_layers=2)
    L, d, ffn, S, s_max = 2, 128, 256, 24, 16
    gen = torch.Generator().manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)

    n_sc = 7 * d + ffn
    ln = torch.stack([1 + 0.1 * torch.randn((L, d), generator=gen) if i % 2 == 0
                      else 0.02 * torch.randn((L, d), generator=gen) for i in range(6)], 1)
    pack = TF.FusedPack(codes(L, 6 * d + ffn, d), codes(L, d, ffn),
                        (0.5 + torch.rand((L, n_sc), generator=gen)) * 3e-4,
                        0.02 * torch.randn((L, n_sc), generator=gen), ln)
    cross = (codes(L, S, d), (0.5 + torch.rand((L, S), generator=gen)) / 127,
             codes(L, S, d), (0.5 + torch.rand((L, S), generator=gen)) / 127)
    caches = [(0.5 * torch.randn((L, s_max, d), generator=gen)).to(torch.bfloat16)
              for _ in range(2)]
    x = 0.5 * torch.randn((d,), generator=gen)
    return cfg, pack, cross, caches, x


def _run_ref(cfg, pack, cross, caches, x, **kw):
    kc, vc = (c.clone() for c in caches)
    return TF.fused_stack_ref(pack, *cross, kc, vc, x, 9, cfg=cfg, s_src=20, **kw)


def test_plain_version_fed_its_own_codes_is_unchanged():
    cfg, pack, cross, caches, x = _tiny_stack()
    tap = (torch.zeros((2, 6, 256), dtype=torch.int8), torch.zeros((2, 6)), None)
    free = _run_ref(cfg, pack, cross, caches, x, tap=tap)
    forced = _run_ref(cfg, pack, cross, caches, x, codes=tap[:2])
    assert all(torch.equal(a, b) for a, b in zip(free, forced))


def test_plain_version_multiplies_the_codes_it_is_fed():
    cfg, pack, cross, caches, x = _tiny_stack()
    tap = (torch.zeros((2, 6, 256), dtype=torch.int8), torch.zeros((2, 6)), None)
    free = _run_ref(cfg, pack, cross, caches, x, tap=tap)
    codes = tap[0].clone()
    codes[1, 0, 5] += 1 if codes[1, 0, 5] < 127 else -1  # layer 1's q/k/v input
    forced = _run_ref(cfg, pack, cross, caches, x, codes=(codes, tap[1]))
    # layer 0 is untouched, layer 1's new k row moves by one code's product
    assert torch.equal(forced[1][0], free[1][0])
    step = (pack.w_in[1, cfg.d_model:2 * cfg.d_model, 5].float()
            * pack.scales[1, cfg.d_model:2 * cfg.d_model] * tap[1][1, 0])
    torch.testing.assert_close((forced[1][1] - free[1][1]).abs(), step.abs(),
                               rtol=1e-4, atol=1e-6)


def test_supported_states_the_shared_memory_limit():
    def cfg(d, ffn, heads):
        return TW.WhisperConfig(d_model=d, decoder_attention_heads=heads,
                                decoder_ffn_dim=ffn)

    assert TF.supported(cfg(1280, 5120, 20))  # whisper-large-v3
    assert TF.supported(cfg(1280, 9216, 20))  # 5 x 9216 + 128 B of GEMV input
    assert not TF.supported(cfg(1280, 9856, 20))
    # the LayerNorm GEMVs stage 17 bytes an element of d: d 2880 fits, 2944 not
    assert TF.supported(cfg(2880, 16, 45))
    assert not TF.supported(cfg(2944, 16, 46))
    assert not TF.supported(cfg(1280, 5120, 16))  # head dim 80
