"""The host side of kernels 2 (int8 single-query attention) and 1 (fused
log-mel) on the CPU: kernel 2's scratch layout and its per-(device,
stream) buffer, and both kernels' stated limits. The kernels themselves
run only on a GPU (``chip_smoke.py --kv-mel-timing``)."""

import numpy as np
import pytest
import torch

from tpu_audio_torch.ops import kv_attention as K
from tpu_audio_torch.ops import mel as M


@pytest.mark.parametrize("h,s", [(20, 1500), (20, 1), (20, 64), (20, 65), (6, 100)])
def test_scratch_layout_regions_are_disjoint_and_fill_the_buffer(h, s):
    layout = K.scratch_layout(h, s)
    nc = -(-s // 64)
    regions = [layout[name] for name in ("part_o", "part_ml", "counts")]
    assert regions == [(0, h * nc * 64), (h * nc * 64, h * nc * 2),
                       (h * nc * 66, h)]  # counters right after part_ml, one a head
    at = 0
    for start, n in regions:
        assert start == at and n > 0
        at += n
    assert layout["total"] == at == h * nc * 66 + h


def test_supported_states_head_dim_groups_and_alignment():
    def planes(d=64, g=1, s=4, offset=0):
        codes = torch.zeros(2 * s * d + offset, dtype=torch.int8)[offset:offset + 2 * s * d]
        kc = codes.view(2, s, d)
        return kc, kc.clone(), torch.zeros((2, s, g))

    assert K.supported(*planes())
    for g in (1, 2, 4, 8, 16, 32, 64):
        assert K.supported(*planes(g=g))
    assert not K.supported(*planes(g=3))    # G must divide the head dim
    assert not K.supported(*planes(d=128))  # the head dim is 64
    assert not K.supported(*planes(s=0))
    kc, vc, ks = planes(offset=1)
    assert kc.is_contiguous() and kc.data_ptr() % 16
    assert not K.supported(kc, vc, ks)      # code planes 16-byte aligned
    assert not K.supported(vc, kc, ks)
    # the route's planes: slices of a contiguous [L, H, S, D] tensor
    cross = torch.zeros((4, 20, 100, 64), dtype=torch.int8)
    assert all(K.supported(cross[i], cross[i], torch.zeros((20, 100, 1))) for i in range(4))


def test_scratch_is_reused_per_stream_and_grows_zeroed():
    dev = torch.device("cpu")
    K._scratch.clear()
    a = K.scratch(dev, 1, 20, 100)
    assert a.numel() == K.scratch_layout(20, 100)["total"] and not a.any()
    a.fill_(7.0)  # partials of a call; a call leaves its own counters zero
    start, n = K.scratch_layout(20, 100)["counts"]
    a[start:start + n] = 0
    assert K.scratch(dev, 1, 20, 100) is a and a[start:start + n].eq(0).all()
    assert a[0] == 7.0  # reused as it was: no zeroing a call
    other = K.scratch(dev, 2, 20, 100)  # another stream: its own counters
    assert other is not a
    # a shorter call reuses the buffer, its counters (among the old partials) zeroed
    short = K.scratch_layout(20, 1)["counts"]
    assert K.scratch(dev, 1, 20, 1) is a
    assert a[short[0]:short[0] + short[1]].eq(0).all() and a[0] == 7.0
    # a longer one grows it, zeroed
    b = K.scratch(dev, 1, 20, 1500)
    assert b is not a and b.numel() == K.scratch_layout(20, 1500)["total"] and not b.any()
    assert K.scratch(dev, 1, 20, 1500) is b
    K._scratch.clear()


def test_fused_log_mel_states_its_limits():
    assert M.supported(201, 128) and M.supported(201, 80)
    assert M.supported(769, 128) and M.supported(4096, 128)  # no F limit
    assert M.supported(0, 80)
    assert M.supported(201, M.MAX_MELS) and not M.supported(201, M.MAX_MELS + 1)
    assert not M.supported(201, 0)


def test_fused_log_mel_band_skipping_keeps_the_sums():
    """The kernel's arithmetic on the CPU: each group of 16 mels summed over
    its band only, in ascending bin order, equals the sum over every bin
    bit for bit (f32, one product at a time)."""
    from tpu_audio_torch.core import dsp

    fb = dsp.mel_filters(16000, 400, 80, f_max=8000.0, norm="slaney", mel_scale="slaney")
    rng = np.random.default_rng(0)
    p = (rng.standard_normal((3, 201)) ** 2).astype(np.float32)
    for m0 in range(0, 80, M.MEL_GROUP):
        cols = fb[:, m0:m0 + M.MEL_GROUP]
        nz = np.nonzero((cols != 0).any(1))[0]
        lo, hi = nz.min(), nz.max()
        for t in range(p.shape[0]):
            full = np.zeros(cols.shape[1], np.float32)
            band = np.zeros(cols.shape[1], np.float32)
            for f in range(201):
                full = (full + p[t, f] * cols[f]).astype(np.float32)
                if lo <= f <= hi:
                    band = (band + p[t, f] * cols[f]).astype(np.float32)
            assert np.array_equal(full, band)
