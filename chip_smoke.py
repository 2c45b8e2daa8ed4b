#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``tpu_audio_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpu_audio_torch/csrc`` (nvcc, sm_90a, one
process per source), builds whisper-large-v3 at full width from random
weights (seed 0; biases and LayerNorm parameters are seeded nonzero values,
so a kernel that reads the wrong bias or LayerNorm row disagrees), and:

1. holds every kernel of the transcription and serving paths against its
   plain PyTorch version on the card, at the shapes the paths give it, and
   times both: per call with CUDA events (median; host launch overhead
   included) and as device time from ``torch.profiler``. The serving
   kernel (``fused_stack_lanes``) is checked at 1, 4 and 8 lanes over a
   stacked state of 8 slots, against its plain version (with every GEMV
   input's int8 codes compared, so that each lane's first difference is
   shown to be one rounding flip) and against the one-token kernel on each
   lane's inputs, and its in-place cache writes against a snapshot;
2. transcribes ``tests/media/speech_16k.wav`` padded to one 30 s window
   through ``Whisper.generate`` in the w8 kv8d and bf16 kv8d configurations,
   twice each, with every launch counter reset just before and read just
   after, and fails unless each kernel of the path launched;
3. teacher-forces the generated tokens through the kernel path and the
   plain path and compares the logits of every step;
4. serves six staggered requests through ``ContinuousSTT`` (w8, 4 slots)
   with the counters reset just before and read just after, every tick
   under ``torch.cuda.set_sync_debug_mode("error")``; checks that each
   request alone gives the same tokens, that a cancel leaves the others'
   tokens unchanged, and the serving step's teacher-forced logits against
   the plain kernels;
5. measures serving throughput with the JAX package's ``bench_serving_stt``
   protocol at 4 and 8 slots, the device busy share of one tick, and the
   rate over a whole 440-token decode;
6. answers three concurrent HTTP requests through ``cli.serve.build_server``;
7. prints, per configuration, the frontend + encoder time and a
   ``torch.profiler`` breakdown of a 32-token window by device kernel.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Any failed check raises and ends the run with a non-zero code.
The last four lines of output are JSON: the generate runs, the serving
results, the kernels' records, then ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, it exits non-zero
before printing any of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AUDIO = ROOT / "tests" / "media" / "speech_16k.wav"
AUDIO2 = ROOT / "tests" / "media" / "two_speaker_16k.wav"
PROMPT = [50258, 50259, 50360, 50364]  # sot, en, transcribe, notimestamps
EOT = 50257
TEACHER_STEPS = 8
GENERATE_RUNS = 2
PROFILE_TOKENS = 32

# the serving kernel's phase: lanes at non-contiguous slots of an 8-slot
# state, with distinct offsets that include both ends of the cache
LANE_COUNTS = (1, 4, 8)
LANE_SLOTS = 8
LANE_ORDER = [6, 1, 3, 0, 7, 2, 5, 4]
LANE_OFFSETS = [447, 0, 100, 5, 63, 64, 300, 200]
# the serving phases (bench.py's bench_serving_stt protocol for throughput)
SERVE_SLOTS, SERVE_STEP_TOKENS, SERVE_MAX_TOKENS = 4, 8, 64
THROUGHPUT_SLOTS = (4, 8)
THROUGHPUT_MAX_TOKENS, WARM_TICKS, TIMED_TICKS = 440, 2, 3
HTTP_REQUESTS = 3

# tolerances, kernel vs plain version on the same inputs
MEL_ATOL = 1e-4      # log10 mel values: f32 sums in another order
KV_RTOL = 1e-3       # int8 attention output, relative to its max
# fused_stack and fused_stack_lanes. Their int8 dots are exact in both
# versions; they differ only by f32 rounding in LayerNorm and softmax
# (~1e-7 relative) until the two round some int8 activation code
# differently, which moves the later layers by ~1e-3 and grows through the
# stack. Before that, a wrong bias or LayerNorm row, or an erf- for a
# tanh-GELU, moves the next layer's k/v by 8e-3 or more on the card, so
# newk/newv of the first FUSED_EXACT_LAYERS layers are held tight.
FUSED_EXACT_LAYERS = 8
FUSED_LAYER_RTOL = 1e-5  # newk/newv of those layers, relative to each layer's max
FUSED_RTOL = 2e-2    # y/newk/newv of the whole stack, relative: code changes
                     # propagated through 32 layers (the bound
                     # tests/test_fused_decoder.py holds the TPU kernel to)
LOGITS_RTOL = 3e-2   # teacher-forced logits of the whole path, relative
# fused_stack_lanes against its plain version. On lanes with long random
# caches and encoder outputs the two versions round some int8 activation
# code differently in ~3% of layers (as early as layer 1). The kernel's tap
# of every GEMV input's codes shows where: up to the first code that
# differs, newk/newv are held at FUSED_LAYER_RTOL (all 32 layers where none
# does); at it exactly one code differs, by one step, and the plain
# version's unrounded value there lies within FLIP_DIST of the rounding
# boundary (the two versions' unrounded values differ by f32 rounding,
# ~1e-6 relative of at most 127; readings 4.8e-7 to 7.6e-6). A wrong bias
# or erf-GELU makes 14 to 35 codes differ at layer 0. The whole stack after
# the flips reached 2.46e-2 over 24 sound lanes and 3.16e-2 with those
# mutations (PERF.md), so LANES_RTOL lies between.
FLIP_DIST = 1e-3
LANES_RTOL = 2.8e-2
GEMVS = ("q/k/v", "out", "cross-q", "cross-out", "fc1", "fc2")  # a layer's, in order


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def by_kernel(prof) -> dict[str, list]:
    """Device activity (kernels, copies) a ``torch.profiler`` run recorded:
    name -> [count, summed microseconds]."""
    import torch

    out: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c = out.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    return out


def device_busy(prof) -> tuple[float, int]:
    """Summed microseconds and count of the device activity a
    ``torch.profiler`` run recorded."""
    kernels = by_kernel(prof).values()
    return sum(c[1] for c in kernels), sum(c[0] for c in kernels)


def print_kernels(kernels: dict, steps: int, top: int = 12) -> None:
    for kname, (c, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {c:6d} x {us / c:9.3f} us "
              f"({us / steps:9.3f} us a step)  {kname[:90]}")


def device_ms(fn, reps: int = 10) -> float | None:
    """Mean device time per call of ``fn``: the summed duration of the
    device activity that ``torch.profiler`` records over ``reps`` calls,
    without the host's launch overhead. None where the profiler records
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, _ = device_busy(prof)
    return us / reps / 1e3 if us > 0 else None


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def fmt_rate(tok_s):
    return "not measured" if tok_s is None else f"{tok_s:.1f} tok/s"


class LargeV3Tokenizer:
    """whisper-large-v3's special-token ids; decode() lists the ids."""

    is_multilingual = True
    eot = EOT
    sot = 50258
    transcribe = 50360
    translate = 50359
    no_timestamps = 50364
    no_speech = 50363
    timestamp_begin = 50365
    language_to_id = {"en": 50259}
    id_to_language = {50259: "en"}

    def build_prompt_tokens(self, language=None, task="transcribe"):
        return list(PROMPT)

    def decode(self, tokens):
        return " ".join(str(t) for t in tokens if t < self.sot)


def randomize_affine(tree: dict, gen) -> None:
    """Give every bias N(0, 0.02) values and every LayerNorm weight and bias
    1 + N(0, 0.1) and N(0, 0.1), in place (``init_params`` makes them 0 and
    1, which a kernel reading the wrong row of them would not show)."""
    import torch

    def randn(t, std, mean=0.0):
        return (mean + std * torch.randn(t.shape, generator=gen, device=t.device)
                ).to(t.dtype)

    for k, v in tree.items():
        if isinstance(v, dict) and "layer_norm" in k:
            v["weight"] = randn(v["weight"], 0.1, 1.0)
            v["bias"] = randn(v["bias"], 0.1)
        elif isinstance(v, dict):
            randomize_affine(v, gen)
        elif k == "bias":
            tree[k] = randn(v, 0.02)


def profile_window(name, model, audio, gp) -> None:
    """Print the frontend + encoder time, and where a PROFILE_TOKENS-token
    window's device time goes, by kernel (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: model.encoder(model.encoder_features(audio)),
                         reps=5, warmup=1)
    p = dataclasses.replace(gp, max_tokens=PROFILE_TOKENS)
    model.generate(audio, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(audio, p)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(audio, p)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    steps = len(PROMPT) + out.generation_token_count - 1
    kernels = by_kernel(prof)
    busy_ms = sum(c[1] for c in kernels.values()) / 1e3
    n_events = sum(c[0] for c in kernels.values())
    print(f"[profile {name}] frontend+encoder {enc_ms:.4f} ms (CUDA events, "
          f"median of 5); {out.generation_token_count} tokens, {steps} steps: "
          f"wall {wall_ms:.3f} ms, decode {(wall_ms - enc_ms) / steps:.4f} ms a step; "
          f"under the profiler wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / prof_ms:.4f}), {n_events / steps:.1f} device events a step")
    print_kernels(kernels, steps)


@contextlib.contextmanager
def plain_kernels():
    """Route the paths' kernel wrappers to their plain versions."""
    from tpu_audio_torch.ops import fused_decoder, kv_attention

    saved = (fused_decoder.fused_stack, fused_decoder.fused_stack_lanes,
             kv_attention.decode_attention_int8)
    fused_decoder.fused_stack = fused_decoder.fused_stack_ref
    fused_decoder.fused_stack_lanes = fused_decoder.fused_stack_lanes_ref
    kv_attention.decode_attention_int8 = kv_attention.decode_attention_int8_ref
    try:
        yield
    finally:
        (fused_decoder.fused_stack, fused_decoder.fused_stack_lanes,
         kv_attention.decode_attention_int8) = saved


@contextlib.contextmanager
def no_host_sync(engine):
    """Run every ``engine._launch`` (one decode tick) under
    ``torch.cuda.set_sync_debug_mode("error")``: a tick that waits for the
    device, or copies from it, raises."""
    import torch

    launch = engine._launch

    def strict():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return launch()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    engine._launch = strict
    try:
        yield
    finally:
        engine._launch = launch


def stack_errors(got, want, n_lanes: int):
    """Per lane: the whole-stack rel errors of (y, newk, newv) and the
    per-layer newk/newv rel errors, for lanes-kernel outputs ``got``
    (y [n, d], newk/newv [L, n, d]) against ``want`` of the same layout."""
    out = []
    for m in range(n_lanes):
        g = (got[0][m], got[1][:, m], got[2][:, m])
        w = (want[0][m], want[1][:, m], want[2][:, m])
        whole = [rel_err(a, b) for a, b in zip(g, w)]
        layers = [max(rel_err(g[1][i], w[1][i]), rel_err(g[2][i], w[2][i]))
                  for i in range(g[1].shape[0])]
        out.append((whole, layers))
    return out


def check_stack(name: str, errs) -> None:
    """FUSED_LAYER_RTOL on layers 0-7 and FUSED_RTOL on the whole stack."""
    for m, (whole, layers) in enumerate(errs):
        check(max(layers[:FUSED_EXACT_LAYERS]) <= FUSED_LAYER_RTOL,
              f"{name} lane {m}: k/v of the first {FUSED_EXACT_LAYERS} layers "
              f"disagree: {layers[:FUSED_EXACT_LAYERS]}")
        check(max(whole) <= FUSED_RTOL, f"{name} lane {m} disagrees: {whole}")


def code_flips(ktap, ptap, n: int) -> list:
    """Per lane, where the kernel's int8 GEMV input codes (``ktap``, the
    lanes kernel's tap) first differ from the plain version's (``ptap``,
    with its unrounded values): None where all L x 6 inputs agree, else
    the layer, the GEMV, how many codes differ and by how much at most,
    the plain version's unrounded value at the first of them and its
    distance from the rounding boundary, and the two scales' relative
    difference."""
    diff = ktap[0].int() - ptap[0].int()  # [L, 6, n, max(d, ffn)]
    out = []
    for m in range(n):
        per = (diff[:, :, m] != 0).sum(-1).flatten()
        hit = per.nonzero()
        if hit.numel() == 0:
            out.append(None)
            continue
        i = int(hit[0, 0])
        layer, g = divmod(i, len(GEMVS))
        row = diff[layer, g, m]
        v = float(ptap[2][layer, g, m, int(row.nonzero()[0, 0])])
        out.append(dict(
            layer=layer, gemv=GEMVS[g], codes=int(per[i]), step=int(row.abs().max()),
            unrounded=v, boundary_dist=abs(abs(v - math.trunc(v)) - 0.5),
            scale_rel=abs(float(ktap[1][layer, g, m]) / float(ptap[1][layer, g, m]) - 1)))
    return out


def exact_layers(flip, n_layers: int) -> int:
    """The layers whose k/v come before a lane's first code difference."""
    if flip is None:
        return n_layers
    return flip["layer"] + (flip["gemv"] != GEMVS[0])


def check_stack_vs_plain(name: str, errs, flips) -> None:
    """newk/newv within FUSED_LAYER_RTOL up to the lane's first int8 code
    difference, which must be one code by one step at the rounding
    boundary; the whole stack within LANES_RTOL."""
    for m, ((whole, layers), flip) in enumerate(zip(errs, flips)):
        until = exact_layers(flip, len(layers))
        check(max(layers[:until], default=0.0) <= FUSED_LAYER_RTOL,
              f"{name} lane {m}: k/v of layers 0-{until - 1}, before any int8 code "
              f"differs, disagree: {layers[:until]}")
        if flip is not None:
            check(flip["codes"] == 1 and flip["step"] == 1,
                  f"{name} lane {m}: at layer {flip['layer']} {flip['gemv']} "
                  f"{flip['codes']} int8 codes differ, by up to {flip['step']}: "
                  f"not one rounding flip")
            check(flip["boundary_dist"] <= FLIP_DIST,
                  f"{name} lane {m}: the flipped code's unrounded value "
                  f"{flip['unrounded']} is not at a rounding boundary")
        check(max(whole) <= LANES_RTOL, f"{name} lane {m} disagrees: {whole}")


def build_models(dev):
    """whisper-large-v3 widths, random weights from seed 0: the w8 kv8d and
    bf16 kv8d models (one encoder and one bf16 decoder between them)."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt import whisper as W

    cfg = W.WhisperConfig(num_mel_bins=128, d_model=1280, encoder_layers=32,
                          encoder_attention_heads=20, encoder_ffn_dim=5120,
                          decoder_layers=32, decoder_attention_heads=20,
                          decoder_ffn_dim=5120, vocab_size=51866,
                          max_source_positions=1500, max_target_positions=448)
    params = W.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    randomize_affine(params, torch.Generator(device=dev).manual_seed(1))
    w8_params = {"model": {"encoder": params["model"]["encoder"],
                           "decoder": quant.quantize_tree(params["model"]["decoder"])}}
    tok = LargeV3Tokenizer()
    models = {
        "w8_kv8d": W.Whisper(cfg, w8_params, tok, dtype=torch.bfloat16, device=dev),
        "bf16_kv8d": W.Whisper(cfg, params, tok, dtype=torch.bfloat16, device=dev),
    }
    check(models["w8_kv8d"]._fused_supported(), "w8 model does not take the fused route")
    check(not models["bf16_kv8d"]._fused_supported(), "bf16 model takes the fused route")
    return cfg, models


def serve_clips(speech, rng) -> list:
    """The serving phases' six clips: the speech clip, the two-speaker
    clip, then seeded noise of 2 to 14 s."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio

    return [speech, load_audio(str(AUDIO2), sample_rate=16000)[0]] + [
        (rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
        for s in (2.0, 5.5, 9.0, 14.0)]


def lane_encoders(w8, enc, clips, rng) -> list:
    """The lanes phase's LANE_SLOTS encoder outputs: ``enc`` (the padded
    speech window), the other clips', then seeded noise's."""
    import numpy as np
    import torch

    with torch.inference_mode():
        return [enc] + [w8.encoder(w8.encoder_features(c)) for c in clips[1:]] + [
            w8.encoder(w8.encoder_features(
                (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)))
            for _ in range(LANE_SLOTS - len(clips))]


def lanes_phase(w8, cfg, encs, dev) -> dict:
    """Kernel 4 at n in LANE_COUNTS over an 8-slot stacked state: against
    its plain version, against the one-token kernel on each lane's inputs,
    its cache writes against a snapshot; times at each n."""
    import torch

    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import fused_decoder as F

    L, d, s_max = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions
    kmax = max(d, cfg.decoder_ffn_dim)
    gen = torch.Generator(device=dev).manual_seed(2)
    layers = w8.decoder.split_layers()
    pack = w8.fused_decoder_pack()
    lanes_ctx = [F.quantize_cross_kv(*W._cross_kv(w8.params, e, cfg, layers))
                 for e in encs]
    ck, ks, cv, vs = (torch.stack([c[i] for c in lanes_ctx]) for i in range(4))
    del lanes_ctx
    kc = (torch.randn((LANE_SLOTS, L, s_max, d), generator=gen, device=dev) * 0.5
          ).to(torch.bfloat16)
    vc = (torch.randn((LANE_SLOTS, L, s_max, d), generator=gen, device=dev) * 0.5
          ).to(torch.bfloat16)
    snap_k, snap_v = kc.clone(), vc.clone()
    p = w8.params["model"]["decoder"]
    by_n = {}
    for n in LANE_COUNTS:
        slots, offs = LANE_ORDER[:n], LANE_OFFSETS[:n]
        lanes = torch.tensor(slots, dtype=torch.int32, device=dev)
        offsets = torch.tensor(offs, dtype=torch.int32, device=dev)
        tokens = torch.tensor([50258 + 7 * m for m in range(n)], device=dev)
        x = (W.nn.embedding(p["embed_tokens"], tokens).float()
             + p["embed_positions"]["weight"][offsets.long()].float())
        kc.copy_(snap_k)
        vc.copy_(snap_v)
        kr, vr = snap_k.clone(), snap_v.clone()
        # every GEMV input's int8 codes and scales; the plain version's also
        # unrounded
        ktap = (torch.zeros((L, 6, n, kmax), dtype=torch.int8, device=dev),
                torch.zeros((L, 6, n), device=dev))
        ptap = (torch.zeros_like(ktap[0]), torch.zeros_like(ktap[1]),
                torch.zeros((L, 6, n, kmax), device=dev))
        got = F.fused_stack_lanes(pack, ck, ks, cv, vs, kc, vc, x, offsets, lanes,
                                  cfg=cfg, s_src=1500, tap=ktap)
        want = F.fused_stack_lanes_ref(pack, ck, ks, cv, vs, kr, vr, x, offsets,
                                       lanes, cfg=cfg, s_src=1500, tap=ptap)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got), "fused_stack_lanes output")
        check(got[0].shape == (n, d) and got[1].shape == (L, n, d), "lanes shapes")
        errs = stack_errors(got, want, n)
        # each lane against the one-token kernel on that lane's inputs
        b1 = []
        for m, (slot, off) in enumerate(zip(slots, offs)):
            kb, vb = snap_k[slot].clone(), snap_v[slot].clone()
            b1.append(F.fused_stack(pack, ck[slot], ks[slot], cv[slot], vs[slot], kb, vb,
                                    x[m], off, cfg=cfg, s_src=1500))
        b1 = (torch.stack([r[0] for r in b1]), torch.stack([r[1] for r in b1], 1),
              torch.stack([r[2] for r in b1], 1))
        errs_b1 = stack_errors(got, b1, n)
        # the new rows at each lane's own slot and offset, nothing else moved
        want_k, want_v = snap_k.clone(), snap_v.clone()
        for m, (slot, off) in enumerate(zip(slots, offs)):
            want_k[slot, :, off] = got[1][:, m].to(torch.bfloat16)
            want_v[slot, :, off] = got[2][:, m].to(torch.bfloat16)
        writes_ok = torch.equal(kc, want_k) and torch.equal(vc, want_v)
        worst = max(max(w) for w, _ in errs)
        flips = code_flips(ktap, ptap, n)
        after = [exact_layers(f, L) for f in flips]
        bit_equal = [all(torch.equal(a, b) for a, b in zip(
            (got[0][m], got[1][:, m], got[2][:, m]), (b1[0][m], b1[1][:, m], b1[2][:, m])))
            for m in range(n)]
        print(f"[fused_stack_lanes n={n}] slots {slots} offsets {offs}: vs plain "
              f"y/newk/newv worst {worst:.3e} (rtol {LANES_RTOL}), first layer after "
              f"a code flip by lane {after} (its error "
              f"{[f'{ly[i]:.1e}' for (_, ly), i in zip(errs, after) if i < L]}); "
              f"vs one-token kernel worst "
              f"{max(max(w) for w, _ in errs_b1):.3e} (rtol {FUSED_RTOL}), layers 0-"
              f"{FUSED_EXACT_LAYERS - 1} {max(max(ly[:FUSED_EXACT_LAYERS]) for _, ly in errs_b1):.1e} "
              f"(rtol {FUSED_LAYER_RTOL}), bit-equal by lane {bit_equal}; cache writes "
              f"in place, others untouched: {writes_ok}")
        for m, f in enumerate(flips):
            print(f"  lane {m} newk/newv by layer vs plain: "
                  + " ".join(f"{e:.1e}" for e in errs[m][1]))
            print(f"  lane {m} int8 codes: " + (
                f"none of the {L} x 6 GEMV inputs differ" if f is None else
                f"first differ at layer {f['layer']} {f['gemv']}: {f['codes']} code(s), "
                f"by up to {f['step']}; plain unrounded {f['unrounded']:.7f} "
                f"({f['boundary_dist']:.2e} from the boundary); scales "
                f"{f['scale_rel']:.1e} apart"))
        check_stack_vs_plain(f"fused_stack_lanes n={n} vs plain", errs, flips)
        check_stack(f"fused_stack_lanes n={n} vs fused_stack", errs_b1)
        check(writes_ok, f"fused_stack_lanes n={n}: cache rows written wrong")

        def kern():
            return F.fused_stack_lanes(pack, ck, ks, cv, vs, kc, vc, x, offsets, lanes,
                                       cfg=cfg, s_src=1500)

        def plain():
            return F.fused_stack_lanes_ref(pack, ck, ks, cv, vs, kr, vr, x, offsets,
                                           lanes, cfg=cfg, s_src=1500)

        by_n[n] = dict(
            max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
            rel_err=worst, rel_err_vs_fused_stack=max(max(w) for w, _ in errs_b1),
            bit_equal_to_fused_stack=all(bit_equal), code_flips=flips,
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=3, warmup=1),
            dev_ms=device_ms(kern), plain_dev_ms=device_ms(plain, reps=1))
        print(f"[time] fused_stack_lanes n={n}: per call kernel {by_n[n]['ms']:.4f} ms, "
              f"plain {by_n[n]['plain_ms']:.4f} ms; device kernel "
              f"{fmt(by_n[n]['dev_ms'])}, plain {fmt(by_n[n]['plain_dev_ms'])}")
    top = by_n[max(LANE_COUNTS)]
    return dict(route="cuda", source="tpu_audio_torch/csrc/fused_decoder_lanes.cu",
                replaces="tpu_audio/ops/pallas_fused_decoder.py:912",
                **top, by_lanes={str(n): r for n, r in by_n.items()})


def kernel_phases(models, cfg, audio, dev) -> tuple[dict, object]:
    """Kernels 1-3 against their plain versions; returns their records and
    the speech clip's encoder output."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import fused_decoder as F
    from tpu_audio_torch.ops import kv_attention as K
    from tpu_audio_torch.ops import mel as M

    records = {}
    # -- kernel 1: fused log-mel at the frontend's shapes --------------------
    x = torch.from_numpy(audio).to(dev)
    spec = dsp.stft(x, dsp.hanning_window(W.N_FFT, periodic=True), W.N_FFT,
                    W.HOP_LENGTH)[:-1]
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(16000, W.N_FFT, 128, f_max=8000.0,
                                          norm="slaney", mel_scale="slaney")).to(dev)
    got = M.fused_log_mel(re, im, fb)
    want = M.fused_log_mel_ref(re, im, fb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[mel] [T,F]x[F,M] = [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},"
          f"{fb.shape[1]}]: max abs err {err:.3e} (atol {MEL_ATOL})")
    check(got.shape == (3000, 128) and bool(torch.isfinite(got).all()), "mel output")
    check(err <= MEL_ATOL, f"fused_log_mel disagrees with its plain version: {err}")
    records["fused_log_mel"] = dict(
        route="cuda", source="tpu_audio_torch/csrc/mel.cu",
        replaces="tpu_audio/ops/pallas_mel.py:50", max_abs_err=err,
        rel_err=rel_err(got, want), ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
        plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
        dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
        plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))

    # encoder output of the real audio feeds the attention kernels' phases
    bf16 = models["bf16_kv8d"]
    with torch.inference_mode():
        enc = bf16.encoder(bf16.encoder_features(audio))
        torch.cuda.synchronize()
        check(enc.shape == (1, 1500, 1280) and bool(torch.isfinite(enc).all()),
              "encoder output")
        layers = bf16.decoder.split_layers()
        cross_k, cross_v = W._cross_kv(bf16.params, enc, cfg, layers)

        # -- kernel 2: int8 cross attention, one layer ----------------------
        H, hd = 20, 64
        kq = W.kv_cache._quantize(cross_k[0, 0], 1)
        vq = W.kv_cache._quantize(cross_v[0, 0], 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((H, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
        sm = 1.0 / hd ** 0.5
        got = K.decode_attention_int8(q, *kq, *vq, 1500, sm_scale=sm)
        want = K.decode_attention_int8_ref(q, *kq, *vq, 1500, sm_scale=sm)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        print(f"[kv_attention] q [{H},1,{hd}] over int8 [{H},1500,{hd}]: "
              f"rel err {err:.3e} (rtol {KV_RTOL})")
        check(err <= KV_RTOL, f"decode_attention_int8 disagrees: {err}")
        records["decode_attention_int8"] = dict(
            route="cuda", source="tpu_audio_torch/csrc/kv_attention.cu",
            replaces="tpu_audio/ops/pallas_kv_attention.py:120",
            max_abs_err=float((got - want).abs().max()), rel_err=err,
            ms=cuda_ms(lambda: K.decode_attention_int8(q, *kq, *vq, 1500, sm_scale=sm)),
            plain_ms=cuda_ms(lambda: K.decode_attention_int8_ref(
                q, *kq, *vq, 1500, sm_scale=sm)),
            dev_ms=device_ms(lambda: K.decode_attention_int8(
                q, *kq, *vq, 1500, sm_scale=sm)),
            plain_dev_ms=device_ms(lambda: K.decode_attention_int8_ref(
                q, *kq, *vq, 1500, sm_scale=sm)))

        # -- kernel 3: the w8 decoder stack, one token at offset 100 --------
        w8 = models["w8_kv8d"]
        pack = w8.fused_decoder_pack()
        w8_layers = w8.decoder.split_layers()
        ck, ks, cv, vs = F.quantize_cross_kv(*W._cross_kv(w8.params, enc, cfg, w8_layers))
        off, s_max = 100, 448
        kc = torch.zeros((32, s_max, 1280), dtype=torch.bfloat16, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :off] = (torch.randn((32, off, 1280), generator=gen, device=dev) * 0.5
                       ).to(torch.bfloat16)
        vc[:, :off] = (torch.randn((32, off, 1280), generator=gen, device=dev) * 0.5
                       ).to(torch.bfloat16)
        p = w8.params["model"]["decoder"]
        xt = (W.nn.embedding(p["embed_tokens"], torch.tensor([50258], device=dev))[0]
              + p["embed_positions"]["weight"][off].float())
        kc2, vc2 = kc.clone(), vc.clone()
        got = F.fused_stack(pack, ck, ks, cv, vs, kc, vc, xt, off, cfg=cfg, s_src=1500)
        want = F.fused_stack_ref(pack, ck, ks, cv, vs, kc2, vc2, xt, off, cfg=cfg,
                                 s_src=1500)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        layer_errs = [max(rel_err(got[1][i], want[1][i]), rel_err(got[2][i], want[2][i]))
                      for i in range(32)]
        print(f"[fused_stack] d=1280 L=32 offset={off}: rel err y/newk/newv "
              + "/".join(f"{e:.3e}" for e in errs) + f" (rtol {FUSED_RTOL}); "
              f"newk/newv by layer (rtol {FUSED_LAYER_RTOL} for the first "
              f"{FUSED_EXACT_LAYERS}): " + " ".join(f"{e:.1e}" for e in layer_errs))
        check(all(torch.isfinite(g).all() for g in got), "fused_stack output")
        check(max(layer_errs[:FUSED_EXACT_LAYERS]) <= FUSED_LAYER_RTOL,
              f"fused_stack k/v of the first {FUSED_EXACT_LAYERS} layers disagree: "
              f"{layer_errs[:FUSED_EXACT_LAYERS]}")
        check(max(errs) <= FUSED_RTOL, f"fused_stack disagrees: {errs}")
        check(torch.equal(kc[:, off], got[1].to(torch.bfloat16)),
              "fused_stack did not write the new k rows into the cache")
        check(torch.equal(vc[:, off], got[2].to(torch.bfloat16)),
              "fused_stack did not write the new v rows into the cache")
        records["fused_stack"] = dict(
            route="cuda", source="tpu_audio_torch/csrc/fused_decoder.cu",
            replaces="tpu_audio/ops/pallas_fused_decoder.py:471",
            max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
            rel_err=max(errs), ms=cuda_ms(lambda: F.fused_stack(pack, ck, ks, cv, vs, kc, vc, xt, off,
                                             cfg=cfg, s_src=1500)),
            plain_ms=cuda_ms(lambda: F.fused_stack_ref(
                pack, ck, ks, cv, vs, kc2, vc2, xt, off, cfg=cfg, s_src=1500),
                reps=5, warmup=1),
            dev_ms=device_ms(lambda: F.fused_stack(pack, ck, ks, cv, vs, kc, vc, xt,
                                                   off, cfg=cfg, s_src=1500)),
            plain_dev_ms=device_ms(lambda: F.fused_stack_ref(
                pack, ck, ks, cv, vs, kc2, vc2, xt, off, cfg=cfg, s_src=1500), reps=2))
    return records, enc


def generate_path(models, audio, seconds, gp) -> tuple[dict, list, dict]:
    """Whisper.generate in both configurations, GENERATE_RUNS times each,
    with every launch counter reset just before and read just after."""
    import torch

    from tpu_audio_torch.ops import _lib

    outputs, runs = {}, []
    _lib.reset_launches()
    for cfg_name, model in models.items():
        for run in range(GENERATE_RUNS):
            before = dict(_lib.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(audio, gp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            grew = {k: v - before.get(k, 0) for k, v in _lib.launches.items()}
            n = out.generation_token_count
            check(n > 0 and len(out.segments) == 1, f"{cfg_name}: no tokens")
            check(cfg_name not in outputs
                  or out.segments[0].tokens == outputs[cfg_name].segments[0].tokens,
                  f"{cfg_name}: greedy tokens differ between runs")
            outputs[cfg_name] = out
            runs.append(dict(config=cfg_name, run=run, tokens=n, wall_s=wall,
                             tokens_per_s=n / wall, rtf=wall / seconds))
            print(f"[generate {cfg_name} run {run}] {n} tokens in {wall:.3f} s: "
                  f"{n / wall:.1f} tokens/s, RTF {wall / seconds:.4f} "
                  f"({seconds:.0f} s window); launches {grew}")
            need = ["fused_log_mel"] + (["fused_stack"] if cfg_name == "w8_kv8d"
                                        else ["decode_attention_int8"])
            for k in need:
                check(grew.get(k, 0) > 0, f"{cfg_name}: kernel {k} was not launched")
    launches = dict(_lib.launches)
    print("first tokens:", {k: o.segments[0].tokens[:12] for k, o in outputs.items()})
    return outputs, runs, launches


def teacher_forced(models, outputs, enc, cfg) -> None:
    """Teacher-forced logits of each configuration: kernel path vs plain."""
    import torch

    from tpu_audio_torch.models.stt import whisper as W

    with torch.inference_mode():
        for cfg_name, model in models.items():
            seq = PROMPT + outputs[cfg_name].segments[0].tokens[:TEACHER_STEPS]
            kwargs = dict(max_total=len(seq), cfg=cfg,
                          layers=model.decoder.split_layers())

            def make_step():
                if cfg_name == "w8_kv8d":
                    return W.fused_decode_step_fn(model.params,
                                                  model.fused_decoder_pack(),
                                                  enc, **kwargs)
                return W.decode_step_fn(model.params, enc, kv_bits=8,
                                        quantized_kv_start=448, **kwargs)

            kernel_step = make_step()
            with plain_kernels():
                plain_step = make_step()
            worst = 0.0
            for i, t in enumerate(seq):
                lk = kernel_step(t, i)
                with plain_kernels():
                    lp = plain_step(t, i)
                check(bool(torch.isfinite(lk).all()), f"{cfg_name}: non-finite logits")
                if i >= len(PROMPT) - 1:
                    worst = max(worst, rel_err(lk, lp))
            print(f"[teacher-forced {cfg_name}] {len(seq) - len(PROMPT) + 1} steps: "
                  f"max rel logit err {worst:.3e} (rtol {LOGITS_RTOL})")
            check(worst <= LOGITS_RTOL, f"{cfg_name}: kernel path logits disagree")


def serve_engine(w8, **kw):
    from tpu_audio_torch.parallel.continuous_stt import ContinuousSTT

    srv = ContinuousSTT(w8, **{**dict(slots=SERVE_SLOTS, step_tokens=SERVE_STEP_TOKENS,
                                      max_tokens=SERVE_MAX_TOKENS), **kw})
    check(srv.fused, "ContinuousSTT did not take the fused tick")
    return srv


def serve_staggered(w8, clips, cancel=None, **kw) -> list[list[int]]:
    """Submit two clips, step, submit the rest, drain (request i with seed
    i); with ``cancel=i``, cancel request i after two ticks. Every tick runs
    under the strict sync mode. Returns each request's tokens."""
    srv = serve_engine(w8, **kw)
    reqs = [srv.submit(c, seed=i) for i, c in enumerate(clips[:2])]
    with no_host_sync(srv.engine):
        srv.step()
        reqs += [srv.submit(c, seed=i) for i, c in enumerate(clips[2:], 2)]
        if cancel is not None:
            srv.step()
            check(srv.cancel(reqs[cancel].request_id), "cancel refused")
        srv.drain()
    check(all(r.done for r in reqs), "a served request did not finish")
    return [list(r.tokens) for r in reqs]


def serve_phase(w8, clips) -> tuple[dict, dict]:
    """The serving path on the card; returns its results and the launch
    counts of its main run."""
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.ops import _lib

    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve_staggered(w8, clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    n_tok = sum(len(t) for t in served)
    print(f"[serve] {len(clips)} requests, {SERVE_SLOTS} slots, step_tokens "
          f"{SERVE_STEP_TOKENS}, max_tokens {SERVE_MAX_TOKENS}: {n_tok} tokens in "
          f"{wall:.3f} s (encodes included), every tick without a host sync; "
          f"launches {launches}")
    check(all(len(t) > 0 for t in served), "a served request has no tokens")
    check(launches.get("fused_stack_lanes", 0) > 0, "fused_stack_lanes was not launched")
    check(launches.get("fused_log_mel", 0) > 0, "fused_log_mel was not launched")
    check(launches.get("fused_stack", 0) == 0, "the one-token kernel ran in the ticks")

    def alone_equal(served, **kw):
        same = []
        for i, (c, want) in enumerate(zip(clips, served)):
            srv = serve_engine(w8, **kw)
            r = srv.submit(c, seed=i)
            srv.drain()
            same.append(list(r.tokens) == want)
        return same

    alone = alone_equal(served)
    print(f"[serve] each request alone in a fresh engine gives the same tokens: {alone} "
          f"({len({t for toks in served for t in toks})} distinct tokens served)")
    check(all(alone), "served tokens depend on the other requests")
    # random weights repeat a few greedy tokens; sampled tokens carry each
    # request's own noise, so the same check at temperature 0.8 is sharper
    sampled = serve_staggered(w8, clips, temperature=0.8)
    alone_s = alone_equal(sampled, temperature=0.8)
    print(f"[serve temperature 0.8] each request alone gives the same tokens: {alone_s} "
          f"({len({t for toks in sampled for t in toks})} distinct tokens served)")
    check(all(alone_s), "sampled tokens depend on the other requests")

    cancelled = serve_staggered(w8, clips, cancel=1)
    kept = [i for i in range(len(clips)) if i != 1]
    same = all(cancelled[i] == served[i] for i in kept)
    print(f"[serve] request 1 cancelled after two ticks ({len(cancelled[1])} tokens "
          f"kept); the others' tokens unchanged: {same}")
    check(same, "a cancel changed another request's tokens")
    check(len(cancelled[1]) < len(served[1]), "the cancelled request ran to its end")

    # the served tokens of two requests, forced through the serving step
    engines = []
    for plain in (False, True):
        srv = serve_engine(w8)
        for c in clips[:2]:
            srv.submit(c)
        with plain_kernels() if plain else contextlib.nullcontext():
            srv.engine._admit()
        engines.append(srv.engine)
    dev = engines[0].device
    lanes = torch.tensor([0, 1], device=dev)
    worst = 0.0
    for t in range(TEACHER_STEPS):
        last = torch.tensor([PROMPT[-1] if t == 0 else served[m][t - 1]
                             for m in range(2)], device=dev)
        offsets = torch.full((2,), len(PROMPT) - 1 + t, device=dev)
        logits = []
        for eng, plain in zip(engines, (False, True)):
            with plain_kernels() if plain else contextlib.nullcontext():
                logits.append(eng._batch_step_fn(eng.params, eng._cache, lanes, last,
                                                 offsets, eng._ctx).float())
        check(bool(torch.isfinite(logits[0]).all()), "serving step: non-finite logits")
        worst = max(worst, rel_err(*logits))
    print(f"[serve teacher-forced] 2 lanes x {TEACHER_STEPS} steps: max rel logit err "
          f"{worst:.3e} (rtol {LOGITS_RTOL})")
    check(worst <= LOGITS_RTOL, "serving step logits disagree with the plain kernels")

    gp = STTGenerateParameters(kv_bits=8, quantized_kv_start=448,
                               max_tokens=SERVE_MAX_TOKENS)
    offline = []
    for c, want in zip(clips, served):
        out = w8.generate(c, gp)
        offline.append(bool(out.segments) and out.segments[0].tokens == want)
    print(f"[serve] served tokens equal Whisper.generate's w8 kv8d tokens "
          f"(printed, not checked): {offline}")
    return dict(requests=len(clips), tokens=n_tok, wall_s=wall, alone_equal=all(alone),
                sampled_alone_equal=all(alone_s), cancel_ok=same, teacher_forced_rel_err=worst,
                equal_to_generate=offline), launches


def throughput_phase(w8, audio) -> list[dict]:
    """bench.py's bench_serving_stt protocol: aggregate tok/s with `slots`
    live streams vs one stream in the same engine, and the device busy
    share of one profiled tick. Its timed ticks sit at early cache offsets
    (below ~90 of 448), so each count is also timed over a whole decode
    of THROUGHPUT_MAX_TOKENS tokens a stream, and over the ticks that end
    past offset 300."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def whole_decode(slots, n_live):
        srv = serve_engine(w8, slots=slots, max_tokens=THROUGHPUT_MAX_TOKENS)
        srv.engine.stop_token = -1
        for _ in range(n_live):
            srv.submit(audio)
        srv.step()  # admission and the first tick
        torch.cuda.synchronize()
        marks, t0, emitted = [], time.perf_counter(), 0
        while not srv.engine.idle:
            emitted += len(srv.step())
            marks.append((time.perf_counter() - t0, emitted))
        late = [(t, e) for t, e in marks if e >= n_live * (300 - len(PROMPT))]
        late_rate = ((late[-1][1] - late[0][1]) / (late[-1][0] - late[0][0])
                     if len(late) > 1 else None)
        return marks[-1][1] / marks[-1][0], late_rate

    rows = []
    for slots in THROUGHPUT_SLOTS:
        def measure(n_live):
            srv = serve_engine(w8, slots=slots, max_tokens=THROUGHPUT_MAX_TOKENS)
            srv.engine.stop_token = -1  # random weights: every lane stays live
            k_solo = srv.engine._tick_k(1)
            check((WARM_TICKS + TIMED_TICKS + 1) * k_solo <= srv.max_tokens,
                  "the measurement would outrun the token budget")
            for _ in range(n_live):
                srv.submit(audio)
            for _ in range(WARM_TICKS):
                srv.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            emitted = sum(len(srv.step()) for _ in range(TIMED_TICKS))
            dt = time.perf_counter() - t0
            return emitted / dt, dt / TIMED_TICKS, srv

        solo_tok_s, solo_tick, srv = measure(1)
        del srv
        tok_s, tick, srv = measure(slots)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy_us, n_ev = device_busy(prof)
        k = srv.engine._tick_k(slots)
        kernels = by_kernel(prof)
        del srv
        full, full_late = whole_decode(slots, slots)
        solo_full, solo_late = whole_decode(slots, 1)
        row = dict(slots=slots, step_tokens=SERVE_STEP_TOKENS, steps_per_tick=k,
                   aggregate_tok_s=tok_s, single_stream_tok_s=solo_tok_s,
                   ms_per_tick=tick * 1e3, ms_per_tick_solo=solo_tick * 1e3,
                   busy_share=busy_us / wall_us, device_events_per_step=n_ev / k,
                   whole_decode_tok_s=full, whole_decode_late_tok_s=full_late,
                   whole_decode_single_stream_tok_s=solo_full,
                   whole_decode_single_stream_late_tok_s=solo_late)
        print(f"[serve throughput slots={slots}] aggregate {tok_s:.1f} tok/s, single "
              f"stream {solo_tok_s:.1f} tok/s; {tick * 1e3:.3f} ms a tick of {k} steps "
              f"({solo_tick * 1e3:.3f} ms solo); one profiled tick: device busy "
              f"{busy_us / 1e3:.3f} of {wall_us / 1e3:.3f} ms (share "
              f"{busy_us / wall_us:.4f}), {n_ev / k:.1f} device events a step; "
              f"whole {THROUGHPUT_MAX_TOKENS}-token decode: aggregate {full:.1f} tok/s "
              f"({fmt_rate(full_late)} past offset 300), single stream {solo_full:.1f} "
              f"tok/s ({fmt_rate(solo_late)} past offset 300)")
        print_kernels(kernels, k, top=10)
        rows.append(row)
    return rows


def http_phase(w8, clips) -> dict:
    """HTTP_REQUESTS concurrent POSTs to the server on 127.0.0.1."""
    import numpy as np

    from tpu_audio_torch.cli.serve import build_server

    server = build_server(w8, "stt", "whisper-large-v3-random", port=0,
                          slots=SERVE_SLOTS)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results: dict = {}
    try:
        def post(i):
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((clips[i] * 32767).clip(-32768, 32767)
                              .astype("<i2").tobytes())
            req = urllib.request.Request(f"{url}/v1/audio/transcriptions",
                                         data=buf.getvalue(),
                                         headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, json.loads(r.read()))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(HTTP_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "an HTTP request did not return")
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(sorted(results) == list(range(HTTP_REQUESTS)), "missing HTTP responses")
    # the text the engine gives the same PCM16-quantised clip alone
    same = []
    for i in range(HTTP_REQUESTS):
        quant = (clips[i] * 32767).clip(-32768, 32767).astype(np.int16).astype(
            np.float32) / 32768.0
        srv = serve_engine(w8, step_tokens=7, max_tokens=224)  # the server's engine
        r = srv.submit(quant)
        srv.drain()
        same.append(results[i][0] == 200 and results[i][1]["text"]
                    == w8.tokenizer.decode(r.tokens).strip())
    counted = (f'tpu_audio_requests_total{{route="/v1/audio/transcriptions"}} '
               f'{HTTP_REQUESTS}') in metrics
    print(f"[http] {HTTP_REQUESTS} concurrent POSTs in {wall:.3f} s: status "
          f"{[results[i][0] for i in range(HTTP_REQUESTS)]}, text equal to the "
          f"engine's: {same}; /metrics counts them: {counted}; /healthz {health}")
    check(all(same), "an HTTP transcription differs from the engine's")
    check(counted, "/metrics does not count the requests")
    check(health.get("ok") is True, "/healthz")
    return dict(requests=HTTP_REQUESTS, wall_s=wall, text_equal=all(same))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "tpu_audio_torch" / "csrc").is_dir() or not AUDIO.exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_lib.build_seconds if _lib.build_seconds is not None else 0:.2f} s)")

    t0 = time.perf_counter()
    cfg, models = build_models(dev)
    torch.cuda.synchronize()
    print(f"whisper-large-v3 built on the card in {time.perf_counter() - t0:.1f} s")

    audio, sr = load_audio(str(AUDIO), sample_rate=16000)
    speech = audio
    audio = np.pad(audio, (0, W.CHUNK_LENGTH_SAMPLES - audio.shape[0]))
    seconds = audio.shape[0] / sr
    rng = np.random.default_rng(0)
    clips = serve_clips(speech, rng)

    records, enc = kernel_phases(models, cfg, audio, dev)
    w8 = models["w8_kv8d"]
    records["fused_stack_lanes"] = lanes_phase(w8, cfg, lane_encoders(w8, enc, clips, rng),
                                               dev)
    for k, r in records.items():
        print(f"[time] {k}: per call (CUDA events) kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; device time (profiler) kernel "
              f"{fmt(r['dev_ms'])}, plain {fmt(r['plain_dev_ms'])}")

    # -- the transcription path: Whisper.generate in both configurations ------
    gp = STTGenerateParameters(kv_bits=8, quantized_kv_start=448)
    outputs, runs, launches = generate_path(models, audio, seconds, gp)
    for k in ("fused_log_mel", "decode_attention_int8", "fused_stack"):
        check(launches.get(k, 0) > 0, f"kernel {k} not launched on the main path")
        records[k]["launches"] = launches[k]
    teacher_forced(models, outputs, enc, cfg)

    # -- the serving path: ContinuousSTT over the w8 model --------------------
    serve, serve_launches = serve_phase(w8, clips)
    records["fused_stack_lanes"]["launches"] = serve_launches["fused_stack_lanes"]
    throughput = throughput_phase(w8, (rng.standard_normal(W.CHUNK_LENGTH_SAMPLES)
                                       * 0.1).astype(np.float32))
    http = http_phase(w8, clips)

    for cfg_name, model in models.items():
        profile_window(cfg_name, model, audio, gp)

    kernels = [dict(name=k, **{f: r[f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "rel_err", "ms",
        "plain_ms", "dev_ms", "plain_dev_ms")}, **({"by_lanes": r["by_lanes"]}
                                                   if "by_lanes" in r else {}))
        for k, r in records.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"generate": runs, "smi": smi.splitlines()[0]}))
    print(json.dumps({"serve": serve, "throughput": throughput, "http": http}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
