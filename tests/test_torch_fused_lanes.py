"""Host side of the Whisper serving lanes kernel
(``tpu_audio_torch/ops/fused_decoder.py``, ``fused_stack_lanes``): the
scratch regions the wrapper allocates, the arrival counters of the
kernel's folded attention combines, its lane limit and the serving tick's
lane groups. The kernel itself runs only on a CUDA card (``chip_smoke.py``)."""

from __future__ import annotations

import pytest

from tpu_audio_torch.models.stt import whisper as TW
from tpu_audio_torch.ops import _lib
from tpu_audio_torch.ops import fused_decoder as TF
from tpu_audio_torch.parallel.continuous_stt import ContinuousSTT

from test_torch_serving import PROMPTS, clip, make_rich

# (n, d, ffn, L, H, s_max, s_src): whisper-large-v3 at 1, 4 and its 32-lane
# limit, a source that is not a whole number of 64-position chunks, and
# tests/test_torch_whisper.py's FUSED fixture width
WIDTHS = [(1, 1280, 5120, 32, 20, 448, 1500), (4, 1280, 5120, 32, 20, 448, 1500),
          (32, 1280, 5120, 32, 20, 448, 1500), (8, 1280, 5120, 32, 20, 448, 1499),
          (2, 256, 1024, 2, 4, 64, 1500)]


def chunks(s: int) -> int:
    return -(-s // _lib.ATTN_CHUNK)


def whisper(d: int, ffn: int, heads: int):
    return TW.WhisperConfig(d_model=d, decoder_attention_heads=heads, decoder_ffn_dim=ffn)


@pytest.mark.parametrize("n, d, ffn, L, H, s_max, s_src", WIDTHS)
def test_scratch_regions_are_disjoint_and_fill_the_buffer(n, d, ffn, L, H, s_max, s_src):
    layout = TF.lanes_scratch_layout(n, d, ffn, L, H, s_max, s_src)
    total = layout.pop("total")
    assert [name for name, _ in sorted(layout.items(), key=lambda kv: kv[1])] == [
        "attn", "q2", "ca", "h", "xs", "part_o", "part_ml", "counts"]
    at = 0
    for start, length in sorted(layout.values()):
        assert start == at and length > 0
        at = start + length
    assert at == total
    # every lane's self-attention (up to the cache's last row) and cross
    # attention finds room for the partials of every head
    nc = max(chunks(s_max), chunks(s_src))
    assert layout["part_o"][1] == n * H * nc * (d // H) and layout["part_ml"][1] == n * H * nc * 2
    assert layout["attn"][1] == layout["q2"][1] == layout["ca"][1] == n * d
    assert layout["h"][1] == n * ffn and layout["xs"][1] >= n
    # the partials are read by 16-byte loads: their region starts on 4 words
    assert layout["xs"][1] % 4 == 0 and layout["part_o"][0] % 4 == 0


@pytest.mark.parametrize("n, d, ffn, L, H, s_max, s_src", WIDTHS)
def test_each_layer_stage_head_and_lane_has_its_own_counter(n, d, ffn, L, H, s_max, s_src):
    # the combine of layer l, stage st (0 self, 1 cross), head h and lane m
    # counts at word ((2 l + st) H + h) n + m of this region, which the
    # wrapper zeroes; it is the buffer's last region, so nothing else is zeroed
    layout = TF.lanes_scratch_layout(n, d, ffn, L, H, s_max, s_src)
    start, length = layout["counts"]
    assert start + length == layout["total"]
    words = {((2 * l + st) * H + h) * n + m
             for l in range(L) for st in range(2) for h in range(H) for m in range(n)}
    assert words == set(range(length))


@pytest.mark.parametrize("d, ffn, heads, limit", [
    (1280, 5120, 20, TF.MAX_LANES),  # whisper-large-v3: a GEMV lane's 32 accumulators
    (1280, 9216, 20, 25),            # the fc2 input's staged int8 rows: 9216 n bytes
    (1024, 8192, 16, 28),            # 8192 n bytes
])
def test_supported_lanes_states_the_kernel_limit(d, ffn, heads, limit):
    cfg = whisper(d, ffn, heads)
    assert TF.supported(cfg)
    assert [n for n in range(0, TF.MAX_LANES + 2) if TF.supported_lanes(cfg, n)] == list(
        range(1, limit + 1))


def test_stt_tick_lane_groups_follow_supported_lanes(monkeypatch):
    """The STT serving tick calls the kernel once for each group of at most
    as many lanes as supported_lanes takes (cut to 2 here)."""
    rich = make_rich()
    takes = TF.supported_lanes
    monkeypatch.setattr(TF, "supported_lanes", lambda cfg, n: takes(cfg, n) and n <= 2)
    calls = []
    kernel = TF.fused_stack_lanes

    def counted(*a, **kw):
        calls.append(a[7].shape[0])
        return kernel(*a, **kw)

    monkeypatch.setattr(TF, "fused_stack_lanes", counted)
    srv = ContinuousSTT(rich, slots=3, max_tokens=3, step_tokens=1)
    assert srv.fused
    for i in range(3):
        srv.submit(clip(200 + i), *PROMPTS[i % 2])
    srv.drain()
    assert max(calls) == 2 and 2 in calls
