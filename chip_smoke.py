#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``tpu_audio_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``tpu_audio_torch/csrc`` (nvcc, sm_90a),
builds whisper-large-v3 at full width from random weights (seed 0; biases
and LayerNorm parameters are seeded nonzero values, so a kernel that reads
the wrong bias or LayerNorm row disagrees), and:

1. holds every kernel of the transcription path against its plain PyTorch
   version on the card, at the shapes the path gives it, and times both:
   per call with CUDA events (median; host launch overhead included) and
   as device time from ``torch.profiler``;
2. transcribes ``tests/media/speech_16k.wav`` padded to one 30 s window
   through ``Whisper.generate`` in the w8 kv8d and bf16 kv8d configurations,
   twice each, with every launch counter reset just before and read just
   after, and fails unless each kernel of the path launched;
3. teacher-forces the generated tokens through the kernel path and the
   plain path and compares the logits of every step;
4. prints, per configuration, the frontend + encoder time and a
   ``torch.profiler`` breakdown of a 32-token window by device kernel.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Any failed check raises and ends the run with a non-zero code.
The last three lines of output are JSON: the generate runs, the kernels'
records, then ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside the repository, it exits non-zero before printing any of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AUDIO = ROOT / "tests" / "media" / "speech_16k.wav"
PROMPT = [50258, 50259, 50360, 50364]  # sot, en, transcribe, notimestamps
EOT = 50257
TEACHER_STEPS = 8
GENERATE_RUNS = 2
PROFILE_TOKENS = 32

# tolerances, kernel vs plain version on the same inputs
MEL_ATOL = 1e-4      # log10 mel values: f32 sums in another order
KV_RTOL = 1e-3       # int8 attention output, relative to its max
# fused_stack. Its int8 dots are exact in both versions; they differ only by
# f32 rounding in LayerNorm and softmax (~1e-7 relative) until the two round
# some int8 activation code differently, which moves the later layers by
# ~1e-3 and grows through the stack. Before that, a wrong bias or LayerNorm
# row, or an erf- for a tanh-GELU, moves the next layer's k/v by 8e-3 or
# more on the card, so newk/newv of the first FUSED_EXACT_LAYERS layers are
# held tight.
FUSED_EXACT_LAYERS = 8
FUSED_LAYER_RTOL = 1e-5  # newk/newv of those layers, relative to each layer's max
FUSED_RTOL = 2e-2    # y/newk/newv of the whole stack, relative: code changes
                     # propagated through 32 layers (the bound
                     # tests/test_fused_decoder.py holds the TPU kernel to)
LOGITS_RTOL = 3e-2   # teacher-forced logits of the whole path, relative


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


def device_ms(fn, reps: int = 10) -> float | None:
    """Mean device time per call of ``fn``: the summed duration of the
    device activity (kernels, copies) that ``torch.profiler`` records over
    ``reps`` calls, without the host's launch overhead. None where the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


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
    by_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c = by_kernel.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    busy_ms = sum(c[1] for c in by_kernel.values()) / 1e3
    n_events = sum(c[0] for c in by_kernel.values())
    print(f"[profile {name}] frontend+encoder {enc_ms:.4f} ms (CUDA events, "
          f"median of 5); {out.generation_token_count} tokens, {steps} steps: "
          f"wall {wall_ms:.3f} ms, decode {(wall_ms - enc_ms) / steps:.4f} ms a step; "
          f"under the profiler wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / prof_ms:.4f}), {n_events / steps:.1f} device events a step")
    for kname, (c, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {us / 1e3:9.3f} ms {c:6d} x {us / c:9.3f} us  {kname[:100]}")


@contextlib.contextmanager
def plain_kernels():
    """Route the path's kernel wrappers to their plain versions."""
    from tpu_audio_torch.ops import fused_decoder, kv_attention

    saved = (fused_decoder.fused_stack, kv_attention.decode_attention_int8)
    fused_decoder.fused_stack = fused_decoder.fused_stack_ref
    kv_attention.decode_attention_int8 = kv_attention.decode_attention_int8_ref
    try:
        yield
    finally:
        fused_decoder.fused_stack, kv_attention.decode_attention_int8 = saved


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

    from tpu_audio_torch.core import dsp, quant
    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_decoder as F
    from tpu_audio_torch.ops import kv_attention as K
    from tpu_audio_torch.ops import mel as M

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

    # -- the model: whisper-large-v3 widths, random weights from seed 0 -----
    cfg = W.WhisperConfig(num_mel_bins=128, d_model=1280, encoder_layers=32,
                          encoder_attention_heads=20, encoder_ffn_dim=5120,
                          decoder_layers=32, decoder_attention_heads=20,
                          decoder_ffn_dim=5120, vocab_size=51866,
                          max_source_positions=1500, max_target_positions=448)
    t0 = time.perf_counter()
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
    torch.cuda.synchronize()
    print(f"whisper-large-v3 built on the card in {time.perf_counter() - t0:.1f} s")

    audio, sr = load_audio(str(AUDIO), sample_rate=16000)
    audio = np.pad(audio, (0, W.CHUNK_LENGTH_SAMPLES - audio.shape[0]))
    seconds = audio.shape[0] / sr
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
    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    for k, r in records.items():
        print(f"[time] {k}: per call (CUDA events) kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; device time (profiler) kernel "
              f"{fmt(r['dev_ms'])}, plain {fmt(r['plain_dev_ms'])}")

    # -- the main path: Whisper.generate in both configurations --------------
    gp = STTGenerateParameters(kv_bits=8, quantized_kv_start=448)
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
    for k in records:
        check(launches.get(k, 0) > 0, f"kernel {k} not launched on the main path")
        records[k]["launches"] = launches[k]
    print("first tokens:", {k: o.segments[0].tokens[:12] for k, o in outputs.items()})

    # -- teacher-forced logits: kernel path vs plain path --------------------
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

    for cfg_name, model in models.items():
        profile_window(cfg_name, model, audio, gp)

    kernels = [dict(name=k, **{f: r[f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "rel_err", "ms",
        "plain_ms", "dev_ms", "plain_dev_ms")}) for k, r in records.items()]
    print(json.dumps({"generate": runs, "smi": smi.splitlines()[0]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
