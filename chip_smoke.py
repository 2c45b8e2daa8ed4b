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
   included) and as device time from ``torch.profiler`` (each run held to
   the events its calls make and to a CUDA-event span; "not measured" after
   three runs that fail). The fused log-mel (``fused_log_mel``) is also
   checked at 80 mels and under a dense random filterbank, the int8
   attention (``decode_attention_int8``) at valid 1 and 700, 2 groups, 100
   positions and with nonzero biases, each check three calls bit for bit
   alike; the attention must make one launch a call besides the conversion
   of its bf16 q. The one-token decoder kernel (``fused_stack``)
   is checked at write offsets 0, 63, 64, 100 and 447, also bit for bit
   against the serving kernel at one lane, and must launch 8 kernels a
   layer. The serving
   kernel (``fused_stack_lanes``) is checked at 1, 4 and 8 lanes over a
   stacked state of 8 slots, against its plain version (with every GEMV
   input's int8 codes compared, so that each lane's first difference is
   shown to be one rounding flip) and bit for bit against the one-token
   kernel on each lane's inputs, and its in-place cache writes against a
   snapshot; then on a random pack over a random 32-slot state at 1, 4, 8
   and 32 lanes (its lane limit; one lane past the cache's end) the same
   way, against its plain version fed its own codes, and one call at 1 and
   at 4 lanes must launch 14 kernels a layer;
2. transcribes ``tests/media/speech_16k.wav`` padded to one 30 s window
   through ``Whisper.generate`` in the w8 kv8d and bf16 kv8d configurations,
   twice each, with every launch counter reset just before and read just
   after, and fails unless each kernel of the path launched;
3. teacher-forces the generated tokens through the kernel path and the
   plain path and compares the logits of every step; then, in the
   ``[whisper longform]`` phase, transcribes a 240 s file of 8 windows
   (the speech clip, the two-speaker clip, seeded noise) with 224 tokens a
   window through the w8 w8e kv8d model (the int8 encoder quantized on the
   card) in batched windows, with every launch counter reset just before
   and read just after: kernel 1 once a window, one kernel 4 call a step
   for all 8 windows (14 launches a layer), no kernel 3 and no plain
   version; every window's tokens equal its per-window decode's (kernel
   3), batched and per-window timed in turns; the int8 encoder against the
   bf16 one; kernel 2 over all 8 windows' heads bit-equal to 8 calls of
   one window's; and the bf16 kv8d and dense routes on 4 windows with 32
   tokens, their teacher-forced logits against the per-window route's;
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

Then it frees whisper and builds Orpheus-3B (the Llama-3.2-3B backbone,
w8a8, audio-band head; random weights from seed 0 with seeded non-unit
RMSNorm weights) and a real-size SNAC 24 kHz decoder, and:

8. holds the Llama decoder stack kernel (``fused_llama_stack``) against
   its plain version at all 28 layers, at write offsets 0, 63, 64 and
   1025 (two of them behind left padding), with every GEMV input's int8
   codes compared, and 2-layer stacks with per-head q/k norms and at
   Llama-3.1-8B's width the same way, the first also at offset 40,000 of a
   40,001-row cache; holds its scratch layout in Python to the kernel's at
   the three widths, and one call at offsets 0 and 400 must launch 9
   kernels a layer;
9. synthesises 280 tokens through ``LlamaTTS.generate`` (greedy, twice)
   and ``generate_stream``, each run with the launch counters reset just
   before and read just after: one kernel launch a decode step and no
   call of the plain version; checks the waveform, and teacher-forces the
   first generated tokens through the kernel and the plain version;
10. measures time to first audio with the JAX package's
   ``bench_tts_ttfb(fused=True)`` protocol, ms a token, the device busy
   share and a per-kernel breakdown of a 32-token chunk, whose profile
   must hold every one of kernel 5's launches (9 a layer a token).

Then Orpheus serving, on the same model:

11. holds the serving kernel (``fused_llama_stack_lanes``) at 1, 4 and 8
   lanes over an 8-slot state in shuffled slot order, and at its lane limit
   (28 at this width) over a state of 28 slots, every cache row random,
   lanes at offsets 0, 63 behind 5 padded rows, 1025 behind 40, one past
   the cache's end, ...: each lane bit-equal to kernel 5 on that lane's
   inputs (outputs, cache rows written, int8 codes), against its plain
   version by kernel 5's rule, no other row changed; and a 2-layer qk_norm
   stack the same way. One call at 1 and at 4 lanes must launch 10 kernels
   a layer. Both versions are timed at each lane count;
12. serves six staggered greedy requests through ``ContinuousTTS`` (4
   slots, 210 tokens each) with the counters reset just before and read
   just after, every tick under ``torch.cuda.set_sync_debug_mode("error")``
   (the SNAC flushes, timed, may read back): one kernel 6 launch a decode
   step and lane group, no kernel 5 launch and no plain version; each
   request alone gives the same tokens, a cancel leaves the others'
   tokens unchanged, every request's audio is finite, nonzero and whole
   frames, and the serving step's teacher-forced band logits match the
   plain version fed the kernel's codes;
13. measures serving throughput with the JAX package's
   ``bench_serving_throughput(fused=True)`` protocol at 1, 4 and 8 slots,
   and the device busy share and per-kernel breakdown of one tick;
14. answers three concurrent speech requests (one of them streamed)
   through ``cli.serve.build_server(model, "tts", slots=4)``.

Then it frees the w8a8 model and runs MLX grouped-affine 4-bit. (Phase 15
runs first of all, right after the build: late in the process
``torch.profiler`` loses device events, and kernel 7's short calls then
read "not measured".)

15. holds kernel 7 (``quantized_matvec``: the decode kernel for 1 row of
   whole 16-byte chunks, the GEMV for rows that are not, the tensor-core
   tile for 2-64 rows) against its plain version at every GEMV shape of
   the Orpheus-3B 4-bit path (q/k/v, o, gate/up, down, the band head and
   the full tied head), at 1 and 63 rows, 4 and 8 bits, f32 and bf16
   scales, at every row count 2-64, then groups of 32 and 128, 2 bits, bf16
   x, odd row counts, the decode kernel at bits 2/4/8 x groups 32/64/128
   at the o and down shapes, with bf16 and f16 x and at the q4 Whisper
   step's shapes, the GEMV at 1 and 63 rows and rows that are not 16-byte
   aligned; and times the kernels, their plain version and
   ``torch._weight_int4pack_mm`` at each path shape with the weights
   outside the L2 (at 1 row the decode kernel beside the GEMV it took over
   from), the tile at 8 bits, and the tile against the GEMV at 2-63 rows
   (where the tile takes over);
16. builds Orpheus-3B quantized on the card to 4 bits in groups of 64 and
   synthesises 280 tokens through ``LlamaTTS.generate`` (greedy, twice) and
   ``generate_stream``, then 21 tokens with the full tied head: kernel 7's
   tile launched 4 x 28 times for the prefill and its decode kernel 4 x 28
   + 1 times a decode step, no GEMV, no other kernel of the port, no call
   of the plain version; teacher-forces
   the band logits against the plain route; measures TTFB with the
   ``bench_tts_ttfb(quantize_bits=4)`` protocol, ms a token and the
   per-kernel breakdown;
17. serves four staggered requests through ``ContinuousTTS`` (the plain
   tick) at 4 slots, each alone giving the same tokens, and transcribes one
   window through ``Whisper.generate`` on a whisper-large-v3-width q4 tree
   (quantized on the card from the first phases' weights): kernel 7's
   decode kernel launched 8 x 32 + 1 times a decoder step, and the tokens
   of the plain route.

Each kernel's record carries its bound on the H100 (``bound_ms``: the
larger of its bytes over 3.35 TB/s and its operations over the peak rate
of their type, from this run's shapes) and ``library_ms``, the time of a
single PyTorch call computing the same function where one exists: for
kernel 7 at 4 bits ``torch._weight_int4pack_mm`` (bf16), null for the
other six. Kernel 7 has two records: ``quantized_matvec``, the decode
kernel's, sums the GEMVs of one decode step at 1 row (with the GEMV's
times there as ``gemv_ms``/``gemv_dev_ms``), the tile's
(``quantized_matvec_tile``) those of one 63-row prefill, with each shape's
readings in ``by_shape``.

``python3 chip_smoke.py --qmm`` runs phase 15 alone with its timing and
prints kernel 7's two records (a minute's work a round on the kernel).

``python3 chip_smoke.py --fused-stack-timing [CHECKOUT ...]`` times kernel 3
alone on random whisper-large-v3-width inputs: the source as it stands and
the kernel 3 of each checkout given (for example a parent's, ``git archive
HEAD tpu_audio_torch/csrc`` unpacked into ``_chip/parent``, or a copy with
a variant of ``csrc/fused_decoder.cu``) in turns, with each version's stage
breakdown and the source's ptxas registers and spills.
``python3 chip_smoke.py --llama-lanes-timing [CHECKOUT ...]`` does the same
for kernel 6 (``csrc/fused_llama_lanes.cu``) at Orpheus-3B width on phase
11's random inputs at 1, 4, 8 and 28 lanes, ``--fused-llama-timing
[CHECKOUT ...]`` for kernel 5 (``csrc/fused_llama.cu``) at Orpheus-3B
width on random inputs at offsets 64, 400 and 1025, and ``--fused-lanes-timing
[CHECKOUT ...]`` for kernel 4 (``csrc/fused_decoder_lanes.cu``) at
whisper-large-v3 width on random inputs at 1, 4, 8 and 32 lanes.

``python3 chip_smoke.py --kv-mel-timing [CHECKOUT ...]`` builds kernels 2
(``csrc/kv_attention.cu``) and 1 (``csrc/mel.cu``) from the source and from
each checkout given, holds each version's calls bit for bit to each other
and to the first version's, and times them in turns: kernel 2 on random
whisper-large-v3 cross planes hot (one layer's, back to back) and cold (32
layers' in rotation, past the L2), kernel 1 at 128 and 80 mels.

``python3 chip_smoke.py --mutations [KERNEL ...]`` instead runs the standing
mutation check (of the kernels named, or of all): each kernel's check alone
on copies of the checkout with its source mutated (``MUTATIONS``; for
kernel 2, its checks on random planes with the folded combine dropping the
last chunk, a staged V row taking the next position's scale, the mask
admitting ``s == valid``, the arrival counter not set back to 0; for
kernel 1, on the speech clip's and random spectra with the band starting
one bin late or ending one bin early, the power squaring the real part
alone; for kernel 3, its checks on a random pack with
cross-q reading out-proj's bias, the folded combine reading the next head's
partials, a staged cross K/V row taking the next position's scale; for
kernel 4, its own checks with the folded self combine reading the next
lane's partials or dropping the lane's last live chunk, lane m's cross K/V
staged from the next lane's slot, the fc1 quantise reading the
cross-attention LayerNorm's row; for
kernel 5, phase 8 with the post-attention RMSNorm reading the input
norm's row, the staged K/V rows taken from the next KV head, the folded
combine dropping the last live chunk, the gate/up GEMV's SwiGLU taking the
gate and up rows swapped, the RoPE sign on the wrong half; for
kernel 6, phase 11 with lane m's RoPE angle from lane 0's offset, attention
from row 0 instead of the lane's valid_from, lane m reading the next lane's
slot, the folded combine reading the next lane's partials or dropping the
lane's last chunk, the staged K/V rows taken from the next KV head; for
kernel 7, phase 15 with the codes read most significant first,
the scale of the neighbouring group, the bias added without its group sum,
in the GEMV and in the tile, the decode kernel's scale of the neighbouring
group and bias without its chunk's sum of x, and the tile without x's low
bf16 part)
beside an unmutated copy, and prints each copy's readings: every
mutant must fail its check and every sound copy pass.

TF32 is off for matmuls and convolutions, so float32 references are full
float32. Any failed check raises and ends the run with a non-zero code.
The last eight lines of output are JSON: the generate runs, the long-form
results, the serving results, the TTS results, the TTS serving results, the
MLX 4-bit results, the kernels' records, then ``{"ok": true, "device":
{...}}``. Without a CUDA device, or outside
the repository, it exits non-zero before printing any of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# kernel 2 at whisper-large-v3's cross attention (heads, positions, head dim)
KV_HEADS, KV_POSITIONS, KV_HD = 20, 1500, 64
# its checks: (positions, groups, valid, seeded nonzero biases); the route's
# planes come from kv_cache._quantize, whose biases are zero
KV_CHECKS = ((1500, 1, 1500, False), (1500, 1, 1, False), (1500, 1, 700, False),
             (1500, 2, 1500, True), (100, 1, 100, True),
             (12100, 1, 11000, False))  # past 11,904 positions: the combine from L2
KV_CALLS = 3  # calls of a check on one scratch, bit for bit alike: a counter
#               that a call does not set back to 0 shows in the second
KV_COLD_LAYERS = 32  # a decode step's planes in rotation: 138 MB, past the 50 MB L2
KV_STAGES = {1: ("attention",), 2: ("partial", "combine")}  # kernel 2 and its parent
KV_KERNELS = ("decode_attention_int8", "attn_combine_kernel")
MEL_CALLS = 3

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
# kernel 3's write offsets: the first row, the chunk edges of its folded
# combine (63, 64), the timed offset, and the 448-row cache's last row
STACK_OFFSETS = (0, 63, 64, 100, 447)
STACK_TIME_OFFSET = 100
STACK_LAYER_LAUNCHES = 8  # kernel 3 a layer: 6 GEMVs and 2 attention launches
# sleep kernels that open and close each profiler window. torch.profiler
# drops a window's first device events, more of them late in a long process
# (on an H100 up to 21: every one of 16 leading markers, the wrapper's copy
# of x and zeroing, and three kernels of the call; a window of one short
# call can lose all). So a window opens with leading markers, and a launch
# count stands only where a leading and a trailing marker were both kept:
# the call's events then lie between kept ones. Each read again waits longer
# on the host and opens with more markers: (wait s, leading markers).
STACK_MARKERS = 16  # trailing markers
STACK_READS = ((0.01, 64), (0.1, 256), (0.5, 1024), (2.0, 4096))
# the kernels of csrc/fused_decoder.cu, and of the parent's (10 a layer)
STACK_KERNELS = ("fs_gemv", "fs_self_attn", "fs_cross_attn", "int8_gemv_kernel",
                 "self_attn_partial", "cross_attn_partial", "attn_combine_kernel")
STACK_STAGES = {8: ("q/k/v", "self-attn", "out", "cross-q", "cross-attn", "cross-out",
                    "fc1", "fc2"),
                10: ("q/k/v", "self-attn", "self combine", "out", "cross-q", "cross-attn",
                     "cross combine", "cross-out", "fc1", "fc2")}
STACK_SOURCE = "this checkout"  # --fused-stack-timing's name for the source as it stands
STACK_TIMING_REPS = 50
# kernel 4's own checks (fused_stack_lanes_only, also in the full run): a
# random whisper-large-v3 pack over a state of LANES_CHECK_SLOTS slots at these
# lane counts, the last its lane limit (lane_layout's slots and offsets)
LANES_CHECK_COUNTS = (1, 4, 8, 32)
LANES_CHECK_SLOTS = 32
# kernel 4 launches 14 kernels a layer: a quantise launch before each of its
# 6 GEMVs, and the self- and cross-attention with their combines folded in
# (csrc/fused_decoder_lanes.cu); its launch count is read at these lane counts
STACK_LANES_LAYER_LAUNCHES = 14
STACK_LANES_COUNTED = (1, 4)
# the kernels of csrc/fused_decoder_lanes.cu ("fd4_"), and of the 16-launch
# parent's; each version's stages of a layer in launch order
LANES_KERNELS = ("fd4_", "ln_quantize_rows_kernel", "int8_gemv_lanes_kernel",
                 "self_attn_partial_lanes", "cross_attn_partial_lanes", "attn_combine_lanes")
LANES_STAGES = {14: ("quantise q/k/v", "q/k/v", "self-attn", "quantise out", "out",
                     "quantise cross-q", "cross-q", "cross-attn", "quantise cross-out",
                     "cross-out", "quantise fc1", "fc1", "quantise fc2", "fc2"),
                16: ("quantise q/k/v", "q/k/v", "self-attn", "self combine", "quantise out",
                     "out", "quantise cross-q", "cross-q", "cross-attn", "cross combine",
                     "quantise cross-out", "cross-out", "quantise fc1", "fc1", "quantise fc2",
                     "fc2")}
LANES_TIMING_COUNTS = (1, 4, 8, 32)
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
# fused_llama_stack against its plain version. Free-running, the two round
# an int8 activation code differently somewhere in Orpheus' 28 layers at
# most offsets, and past it the random-weight stack diverges by up to
# ~9e-2 (the first chip call: a flip at layer 5 read 5.2e-2 whole-stack,
# above LANES_RTOL, on a sound kernel). The whole stack is therefore held
# against the plain version fed the kernel's own int8 codes and scales,
# which removes rounding from the comparison: only f32 sums in another
# order (softmax, RoPE's sincosf) remain, ~1e-7.
FORCED_RTOL = 1e-5
# the kernel's activation scales against the plain version's on the same
# inputs: max|x| / 127 of a row the two compute in f32 in another order. The
# attention output's row moves most: a score's absolute f32 error scales with
# its magnitude, and the softmax turns it into a relative error of the
# weights (readings up to 5.4e-7 over kernel 5's checks, 1.1e-6 on a kernel 6
# lane at offset 1225). The --mutations mutants that move a scale at all move
# it by 9.8e-2 to 2.9e-1 (kernel 5's wrong norm row 1.4e-1 and RoPE sign
# 2.9e-1; kernel 6's three 9.8e-2 to 2.1e-1).
SCALE_RTOL = FORCED_RTOL
GEMVS = ("q/k/v", "out", "cross-q", "cross-out", "fc1", "fc2")  # a layer's, in order

# Orpheus-3B: canopylabs/orpheus-3b-0.1-ft, the Llama-3.2-3B backbone at its
# published width (bench.py:315-319) with its rope_scaling
ORPHEUS = dict(vocab_size=156940, hidden_size=3072, num_hidden_layers=28,
               num_attention_heads=24, num_key_value_heads=8, intermediate_size=8192,
               rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=True,
               max_position_embeddings=131072,
               rope_scaling={"rope_type": "llama3", "factor": 32.0,
                             "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                             "original_max_position_embeddings": 8192})
# SNAC 24 kHz at bench.py:349-353's dims
SNAC_24K = dict(sampling_rate=24000, encoder_dim=64, encoder_rates=(2, 4, 8, 8),
                decoder_dim=1024, decoder_rates=(8, 8, 4, 2), vq_strides=(4, 2, 1),
                codebook_size=4096, codebook_dim=8, noise=True, depthwise=True)
LLAMA_S_MAX = 1280
LLAMA_CHECKS = [(0, 0), (63, 5), (64, 0), (1025, 40)]  # (offset, valid_from)
QK_NORM_CHECKS = [(64, 5), (1025, 0)]  # also the checks of LLAMA_WIDE
# Llama-3.1-8B's width at 2 layers: the quantise stages its 14336-wide f32
# gate/up row past 48 KB of shared memory (an opt-in the Orpheus width
# never needs)
LLAMA_WIDE = dict(num_hidden_layers=2, hidden_size=4096, num_attention_heads=32,
                  intermediate_size=14336)
LLAMA_TIME_OFFSET = 400  # position of the per-call timing and its bound
# kernel 5 launches 9 kernels a layer (csrc/fused_llama.cu): the q/k/v
# GEMV after its quantise launch, RoPE, the attention with its combine folded
# in, the o GEMV quantising its own input, the gate/up GEMV (writing the
# SwiGLU) after its quantise launch, the down GEMV after its; its launch
# count is read at these offsets
LLAMA_LAYER_LAUNCHES = 9
LLAMA_COUNTED_OFFSETS = (0, LLAMA_TIME_OFFSET)
# the kernels of csrc/fused_llama.cu, and nothing else a decode step runs:
# the decode profile's attribution to kernel 5
LLAMA_K5_KERNELS = ("fl5_",)
# the kernels of csrc/fused_llama.cu and of the 11-launch parent's; each
# version's stages of a layer in launch order
LLAMA_KERNELS = LLAMA_K5_KERNELS + ("rms_quantize_rows_kernel", "int8_gemv_lanes_kernel",
                                    "rope_qk_kernel", "gqa_attn_partial",
                                    "attn_combine_kernel")
LLAMA_STAGES = {9: ("quantise q/k/v", "q/k/v", "rope", "attention", "o", "quantise gate/up",
                    "gate/up", "quantise down", "down"),
                11: ("quantise q/k/v", "q/k/v", "rope", "attention", "combine", "quantise o",
                     "o", "quantise gate/up", "gate/up", "quantise down", "down")}
# --fused-llama-timing's (offset, valid_from) on llama_inputs' cache
LLAMA_TIMING_CHECKS = [(64, 0), (LLAMA_TIME_OFFSET, 0), (1025, 40)]
# a 2-layer qk_norm stack over a cache longer than kernel 6's folded combine
# can stage one head's partials for (LANES_S_MAX rows): kernel 5 combines
# them from L2 and takes any cache length; (offset, valid_from)
LLAMA_LONG_CACHE_CHECK = (40000, 37)
# kernel 6 launches 10 a layer: 4 quantise, 4 GEMV, RoPE, attention with its
# combine folded in (csrc/fused_llama_lanes.cu); its launch count is read at
# these lane counts
LLAMA_LANES_LAYER_LAUNCHES = 10
LLAMA_LANES_COUNTED = (1, 4)
# the kernels of csrc/fused_llama_lanes.cu ("fl6_"), and of the parent's (11
# a layer); each version's stages of a layer in launch order
LLAMA_LANES_KERNELS = ("fl6_", "rms_quantize_rows_kernel", "int8_gemv_lanes_kernel",
                       "rope_qk_lanes_kernel", "gqa_attn_partial_lanes", "attn_combine_lanes")
LLAMA_LANES_STAGES = {10: ("quantise q/k/v", "q/k/v", "rope", "attention", "quantise o", "o",
                           "quantise gate/up", "gate/up", "quantise down", "down"),
                      11: ("quantise q/k/v", "q/k/v", "rope", "attention", "combine",
                           "quantise o", "o", "quantise gate/up", "gate/up", "quantise down",
                           "down")}
LLAMA_LANES_TIMING_COUNTS = (1, 4, 8, 28)
# the [whisper longform] phase: a file of LONG_WINDOWS 30 s windows through
# the w8 w8e kv8d model, LONG_TOKENS decode tokens a window (bench.py's
# bench_whisper_longfile defaults, bench.py:210), then the bf16 kv8d and
# bf16 dense routes on its first LONG_BF16_WINDOWS windows with
# LONG_BF16_TOKENS tokens each (cut: their step is host-bound, ~40 ms)
LONG_WINDOWS, LONG_TOKENS = 8, 224
LONG_BF16_WINDOWS, LONG_BF16_TOKENS = 4, 32
# in turns: the counted batched and per-window runs, then two more
LONG_TIMED = ("batched", "per-window", "per-window", "batched")
LONG_STEP_OFFSET = 100  # the timed decode step's position
# the int8 encoder against the bf16 one, relative to its max: the JAX test's
# bound (tests/test_whisper.py:261) at that test's depth (2 layers and the
# final LayerNorm); through all 32 layers int8 activation noise accumulates
# (5.29e-2 on an NVIDIA H100 80GB HBM3 at 700 W), held to W8E_FULL_RTOL
W8E_RTOL, W8E_DEPTH, W8E_FULL_RTOL = 0.05, 2, 0.1
W8E_PRODUCTS = 6  # int8 products an encoder layer: q, k, v, out, fc1, fc2
# the least share of a timed run's device events the profiler must keep for
# device_ms to take the run (readings late in chip_smoke: 0.9919 and 0.9998
# of the events; once a run kept two thirds of the device time)
DEVICE_EVENTS_KEPT = 0.98
# the least share of the CUDA-event span that kernels 5 and 6, called back to
# back, fill with device work: the host enqueues their 9 and 10 launches a
# layer from C faster than the card runs them (a call took 2.25-3.85 ms of device
# time at n = 1-4 and 2.85-4.50 ms with its enqueue on an NVIDIA H100 80GB
# HBM3 at 700 W)
DEVICE_BUSY = 0.7
TTS_TEXT = "The quick brown fox jumps over the lazy dog, twice."
TTS_TOKENS = 280         # 40 frames of 7
TTS_TEACHER_STEPS = 8
TTFB_CHUNK, TTFB_BUCKET, TTFB_REPEATS = 28, 64, 3  # bench_tts_ttfb's protocol
TTS_PROFILE_TOKENS = 32
# Orpheus serving: kernel 6 at LLAMA_LANE_COUNTS lanes over a LANE_SLOTS-slot
# state (LANE_ORDER), and at its lane limit over a state of that many slots;
# each lane's (offset, valid_from): 0, 63 behind 5 padded rows, 1025 behind
# 40, ..., and one past the cache's end (clamped to its last row)
LLAMA_LANE_COUNTS = (1, 4, 8)
LLAMA_LANE_CHECKS = [(0, 0), (63, 5), (1025, 40), (400, 0), (64, 0), (700, 12), (200, 3),
                     (LLAMA_S_MAX + 10, 0)]
# two lanes over the longest cache kernel 6 takes (LANES_S_MAX rows): one at
# its last row from row 0, its combine over every chunk at once
LLAMA_LONG_CACHE_CHECKS = [(28351, 0), (20000, 37)]
TTS_SERVE_SLOTS, TTS_SERVE_MAX_TOKENS, TTS_HTTP_TOKENS = 4, 210, 70
TTS_SERVE_TEXTS = ["Hello there.", "The quick brown fox jumps over the lazy dog.",
                   "Serving six requests at once.", "A fourth, rather shorter one.",
                   "Number five waits for a free lane to open up.", "And the sixth."]
TTS_THROUGHPUT_SLOTS = (1, 4, 8)
# MLX grouped-affine 4-bit (kernel 7): every GEMV shape of the Orpheus-3B
# 4-bit path, (O, I): the fused q/k/v, o, fused gate/up and down
# projections, the band head and the full tied head
QMM_SHAPES = {"q/k/v": (5120, 3072), "o": (3072, 3072), "gate/up": (16384, 3072),
              "down": (3072, 8192), "band head": (28673, 3072), "full head": (156940, 3072)}
# the q4 Whisper decoder step's (whisper-large-v3: d 1280, ffn 5120, vocab
# 51866): q/k/v/out and the cross projections, fc1, fc2, the tied head
QMM_WHISPER_SHAPES = {"attn": (1280, 1280), "fc1": (5120, 1280), "fc2": (1280, 5120),
                      "head": (51866, 1280)}
# kernel 7 against its plain version, relative to the largest output: both
# sum the same f32 products in another order (readings ~1e-6 of max|y|);
# with bf16 x the result is bf16, and the two may round an output to
# neighbouring bf16 values: one unit of the largest output's last place;
# with f16 x likewise one f16 unit
QMM_RTOL = 1e-4
QMM_BF16_RTOL = 2.0 ** -7
QMM_F16_RTOL = 2.0 ** -10
# the tile against the GEMV at these rows of x (o and down shapes): R_TILE
QMM_CROSSOVER_ROWS = (2, 4, 8, 16, 32, 63)
# a timed call's weights are one of copies that hold this many bytes in
# all, twice the H100's 50 MB L2: each call finds its weights outside it
QMM_COLD_BYTES = 100e6
# teacher-forced band logits of the 4-bit path, kernel 7 against its plain
# version on its own cache: f32 activations throughout (no int8 rounding of
# activations), but the K/V rows are stored in bf16, and a row the two
# round to neighbouring bf16 values moves the later logits (reading 6.2e-5
# over 8 steps on an H100)
Q4_LOGITS_RTOL = 1e-3
Q4_FULL_TOKENS = 21  # the full-head run
Q4_SERVE_SLOTS, Q4_SERVE_MAX_TOKENS = 4, 70
Q4_SERVE_TEXTS = TTS_SERVE_TEXTS[:4]
Q4_WHISPER_TOKENS = 24
Q4_PROFILE_TOKENS = 8  # ~1,600 device events a token: a short profiled chunk
# the standing mutation check (--mutations): for each kernel, its source,
# the function here that runs its check alone, and its mutations (name,
# original text, mutated text); a kernel ported later adds its entry
MUTATIONS = {
    "fused_stack": ("tpu_audio_torch/csrc/fused_decoder.cu", "fused_stack_only", [
        ("cross-q reads out-proj's bias", "bl + 4 * d", "bl + 3 * d"),
        ("the folded combine reads the neighbouring head's partials",
         "const size_t base = (size_t)blockIdx.y * nc;",
         "const size_t base = (size_t)((blockIdx.y + 1) % gridDim.y) * nc;"),
        ("the staged cross K/V takes the neighbouring position's scale",
         "cp_async4(sks + i, ks + s0 + i);", "cp_async4(sks + i, ks + s0 + (i ^ 1));"),
    ]),
    "fused_stack_lanes": ("tpu_audio_torch/csrc/fused_decoder_lanes.cu",
                          "fused_stack_lanes_only", [
        ("the folded self combine reads the neighbouring lane's partials",
         "combine_last_lane(part_o + first * HD, part_ml + first * 2,",
         "combine_last_lane(part_o + (first + heads * gridDim.x) % (n * heads * gridDim.x) * HD, "
         "part_ml + (first + heads * gridDim.x) % (n * heads * gridDim.x) * 2,"),
        ("the self combine drops the lane's last live chunk",
         "counts + h * n + m, live, live,", "counts + h * n + m, live, live - 1,"),
        ("lane m's staged cross K/V come from slot lanes[(m + 1) % n]",
         "const size_t src = (size_t)lanes[m];",
         "const size_t src = (size_t)lanes[(m + 1) % gridDim.z];"),
        ("the fc1 quantise reads the cross-attention LayerNorm's row",
         "stage(resid, d, lnl + 4 * d, lnl + 5 * d,", "stage(resid, d, lnl + 2 * d, lnl + 3 * d,"),
    ]),
    "fused_llama_stack": ("tpu_audio_torch/csrc/fused_llama.cu", "fused_llama_only", [
        ("the post-attention RMSNorm reads the input norm's row",
         "quantize(chain, resid, nl + d, QUANT_RMS", "quantize(chain, resid, nl, QUANT_RMS"),
        ("the staged K/V rows come from KV head (g + 1) % kv_heads",
         "const size_t kv_at = (size_t)g * HD;",
         "const size_t kv_at = (size_t)((g + 1) % gridDim.y) * HD;"),
        ("the folded combine drops the last live chunk",
         "part_ml + h * nc * 2, nc,", "part_ml + h * nc * 2, nc - 1,"),
        ("the gate/up GEMV's SwiGLU takes the gate and up rows swapped",
         "a.out[o] = g * (1.0f / (1.0f + expf(-g))) * u;",
         "a.out[o] = u * (1.0f / (1.0f + expf(-u))) * g;"),
        # a device function kernels 5 and 6 share (a mutation's own source
        # last): kernel 5's check runs on it
        ("RoPE sign on the wrong half",
         "j < HD / 2 ? -1.0f : 1.0f", "j < HD / 2 ? 1.0f : -1.0f",
         "tpu_audio_torch/csrc/decoder_common.cuh"),
    ]),
    "fused_llama_stack_lanes": ("tpu_audio_torch/csrc/fused_llama_lanes.cu",
                                "fused_llama_lanes_only", [
        ("lane m's RoPE angle from lane 0's offset",
         ", eps, off, blockIdx.x);", ", eps, lane_offset(offsets, 0, s_max), blockIdx.x);"),
        ("attention from row 0, not the lane's valid_from",
         "const int vf = lane_start(valid_from, m, offset);", "const int vf = 0;"),
        ("lane m's attention reads slot lanes[(m + 1) % n]",
         "const size_t base = (size_t)lanes[m] * slot_stride;",
         "const size_t base = (size_t)lanes[(m + 1) % gridDim.z] * slot_stride;"),
        ("the folded combine reads the neighbouring lane's partials",
         "const size_t hb0 = ((size_t)m * heads + g * rep + r0) * nc_all;",
         "const size_t hb0 = ((size_t)((m + 1) % gridDim.z) * heads + g * rep + r0) * nc_all;"),
        ("the folded combine drops the lane's last chunk",
         "sml + grp * 2 * nc, nc, HD, t)", "sml + grp * 2 * nc, nc - 1, HD, t)"),
        ("the staged K/V rows come from KV head (g + 1) % kv_heads",
         "const size_t kv_at = base + (size_t)g * HD;",
         "const size_t kv_at = base + (size_t)((g + 1) % gridDim.y) * HD;"),
    ]),
    "decode_attention_int8": ("tpu_audio_torch/csrc/kv_attention.cu", "kv_attention_only", [
        ("the folded combine drops the last chunk",
         "combine_partials(sbuf, sml, nc, HD,", "combine_partials(sbuf, sml, nc - 1, HD,"),
        ("a staged V row takes the neighbouring position's scale",
         "vs[r * G + g]", "vs[(r ^ 1) * G + g]"),
        ("the mask admits s == valid", "s < valid ?", "s <= valid ?"),
        ("the arrival counter is not set back to 0",
         "if (threadIdx.x == 0) counts[h] = 0;", ""),
    ]),
    "fused_log_mel": ("tpu_audio_torch/csrc/mel.cu", "mel_only", [
        ("the band starts one bin late", "lo = band[0];", "lo = band[0] + 1;"),
        ("the band ends one bin early", "hi = band[1];", "hi = band[1] - 1;"),
        ("the power squares only the real part", "r[u] * r[u] + m[u] * m[u];",
         "r[u] * r[u] + 0.0f * m[u];"),
    ]),
    "quantized_matvec": ("tpu_audio_torch/csrc/qmm.cu", "qmm_only", [
        ("codes read most significant first",
         "const int shift = BITS * n;", "const int shift = BITS * (32 / BITS - 1 - n);"),
        ("the scale of the neighbouring group",
         "sc0[r] = load_f(scales, srow[r] + grp0, s_dt);",
         "sc0[r] = load_f(scales, srow[r] + (grp0 > 0 ? grp0 - 1 : 1), s_dt);"),
        ("the bias added without its group sum",
         "v += cur.bi0[r] * xg[b * G + grp0];", "v += cur.bi0[r];"),
        # the decode kernel (1 row)
        ("decode: the scale of the neighbouring group",
         "sc0[k][r] = load_f(scales, srow[r] + g0, s_dt);",
         "sc0[k][r] = load_f(scales, srow[r] + (g0 > 0 ? g0 - 1 : 1), s_dt);"),
        ("decode: the bias added without its chunk's sum of x",
         "(bi0[k][r] * xlo + bi1[k][r] * xhi);", "(bi0[k][r] + bi1[k][r]);"),
        # the tile (2-64 rows)
        ("tile: x_lo dropped (f32 x kept as bf16 alone)",
         "mma_bf16(p[j], a, q.z, q.w);  // x_lo", ""),
        ("tile: the scale of the neighbouring group",
         "sv[n] = load_f(scales, at, s_dt);",
         "sv[n] = load_f(scales, at % G ? at - 1 : at + 1, s_dt);"),
        ("tile: the bias added without its group sum",
         "y[j][c] += sc[c >> 1] * p[j][c] + bi[c >> 1] * xgs[c & 1];",
         "y[j][c] += sc[c >> 1] * p[j][c] + bi[c >> 1];"),
    ]),
}

# the card's peak rates (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# int8 and bf16 tensor-core ops/s, float32 (no tensor cores) ops/s
HBM_BYTES_S, INT8_OPS_S, BF16_OPS_S, F32_OPS_S = 3.35e12, 1.979e15, 989e12, 67e12


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0,
          bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the operations over their types' peak rates."""
    mem = nbytes / HBM_BYTES_S * 1e3
    ops = (int8_ops / INT8_OPS_S + f32_ops / F32_OPS_S + bf16_ops / BF16_OPS_S) * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def markers(k: int) -> None:
    """``k`` short sleep kernels and a synchronize: the uncounted events that
    open or close a profiler window (STACK_READS)."""
    import torch

    for _ in range(k):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_intervals(prof) -> list[tuple[float, float, str]]:
    """(start, end) microseconds and name of each device activity (kernels,
    copies) a ``torch.profiler`` run recorded, in order of start."""
    import torch

    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def device_busy(prof) -> tuple[float, int]:
    """Microseconds the device was busy in a ``torch.profiler`` run (the
    union of the recorded intervals, overlaps merged: a programmatic
    dependent launch's interval includes its wait on its predecessor, so
    kernel 3's intervals overlap; where none overlap this is their sum) and
    the count of the activities, leaving out the sleep kernels of markers()."""
    spans = [s for s in device_intervals(prof) if "spin_kernel" not in s[2]]
    return interval_union(spans), len(spans)


def interval_union(spans) -> float:
    """Microseconds covered by (start, end, name) intervals in order of
    start, overlaps merged."""
    busy, end = 0.0, -math.inf
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def print_kernels(kernels: dict, steps: int, top: int = 12) -> None:
    for kname, (c, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {c:6d} x {us / c:9.3f} us "
              f"({us / steps:9.3f} us a step)  {kname[:90]}")


def device_ms(fn, reps: int = 10, launches: int = 0, busy: float = 0.0) -> float | None:
    """Mean device time per call of ``fn``: the summed duration of the
    device activity that ``torch.profiler`` records over ``reps`` calls,
    without the host's launch overhead. Late in a long process the
    profiler's readings go wrong: on an H100, kernel 6 at n=1 once read
    1.50 ms and at n=4 1.95 ms where 2.25 and 3.85 were right, the first with events
    lost, the second with every event kept. So each timed run is checked:
    it keeps DEVICE_EVENTS_KEPT or more of ``reps`` times the events of one
    call (the count the profiler records for one call alone, and at least
    ``launches``; the window opens with uncounted markers, so that the
    events the profiler drops first are theirs), its device time lies within
    the span that CUDA events around the calls measure, and, for a function
    that keeps the device busy back to back, fills at least ``busy`` of
    that span. A run that
    fails a check is measured again; after three the reading is None (not
    measured), with a line saying why, as where the profiler records no
    device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            markers(STACK_READS[0][1])
            start.record()
            for _ in range(k):
                fn()
            end.record()
            torch.cuda.synchronize()
        us, count = device_busy(prof)
        return us, count, start.elapsed_time(end) * 1e3

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the events of one call, measured again where none were kept
        one = run(1)[1]
        if one:
            break
    if one == 0:
        print("[device_ms] the profiler recorded no device events for one call, three "
              "times: not measured")
        return None
    want = reps * max(one, launches)
    for _ in range(3):
        us, count, span_us = run(reps)
        why = (f"kept {count} of {want} device events" if count < DEVICE_EVENTS_KEPT * want
               else f"device {us:.0f} us outside the {span_us:.0f} us span"
               if not busy * span_us <= us <= span_us * 1.01 else None)
        if why is None:
            if count < want:
                print(f"[device_ms] the profiler kept {count} of {want} device events "
                      f"({count / want:.4f}): the time is theirs")
            return us / reps / 1e3
        print(f"[device_ms] the profiler {why}: measuring again")
    print(f"[device_ms] the profiler {why}, three times: not measured")
    return None


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
    busy_us, n_events = device_busy(prof)
    busy_ms = busy_us / 1e3
    print(f"[profile {name}] frontend+encoder {enc_ms:.4f} ms (CUDA events, "
          f"median of 5); {out.generation_token_count} tokens, {steps} steps: "
          f"wall {wall_ms:.3f} ms, decode {(wall_ms - enc_ms) / steps:.4f} ms a step; "
          f"under the profiler wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / prof_ms:.4f}), {n_events / steps:.1f} device events a step")
    print_kernels(kernels, steps)


@contextlib.contextmanager
def plain_kernels():
    """Route the paths' kernel wrappers to their plain versions."""
    from tpu_audio_torch.ops import fused_decoder, fused_llama, kv_attention, qmm

    saved = (fused_decoder.fused_stack, fused_decoder.fused_stack_lanes,
             kv_attention.decode_attention_int8, fused_llama.fused_llama_stack,
             fused_llama.fused_llama_stack_lanes, qmm.quantized_matvec)
    fused_decoder.fused_stack = fused_decoder.fused_stack_ref
    fused_decoder.fused_stack_lanes = fused_decoder.fused_stack_lanes_ref
    kv_attention.decode_attention_int8 = kv_attention.decode_attention_int8_ref
    fused_llama.fused_llama_stack = fused_llama.fused_llama_stack_ref
    fused_llama.fused_llama_stack_lanes = fused_llama.fused_llama_stack_lanes_ref
    qmm.quantized_matvec = qmm.quantized_matvec_ref
    try:
        yield
    finally:
        (fused_decoder.fused_stack, fused_decoder.fused_stack_lanes,
         kv_attention.decode_attention_int8, fused_llama.fused_llama_stack,
         fused_llama.fused_llama_stack_lanes, qmm.quantized_matvec) = saved


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


def code_flips(ktap, ptap, n: int, gemvs=GEMVS) -> list:
    """Per lane, where the kernel's int8 GEMV input codes (``ktap``, the
    lanes kernel's tap) first differ from the plain version's (``ptap``,
    with its unrounded values): None where all L x 6 inputs agree, else
    the layer, the GEMV, how many codes differ and by how much at most,
    the plain version's unrounded value at the first of them, the largest
    distance of their unrounded values from the rounding boundary, and the
    two scales' relative difference."""
    diff = ktap[0].int() - ptap[0].int()  # [L, 6, n, max(d, ffn)]
    out = []
    for m in range(n):
        per = (diff[:, :, m] != 0).sum(-1).flatten()
        hit = per.nonzero()
        if hit.numel() == 0:
            out.append(None)
            continue
        i = int(hit[0, 0])
        layer, g = divmod(i, len(gemvs))
        row = diff[layer, g, m]
        pre = ptap[2][layer, g, m, row.nonzero()[:, 0]]
        out.append(dict(
            layer=layer, gemv=gemvs[g], codes=int(per[i]), step=int(row.abs().max()),
            unrounded=float(pre[0]),
            boundary_dist=float((pre - pre.trunc()).abs().sub(0.5).abs().max()),
            scale_rel=abs(float(ktap[1][layer, g, m]) / float(ptap[1][layer, g, m]) - 1)))
    return out


def exact_layers(flip, n_layers: int, gemvs=GEMVS) -> int:
    """The layers whose k/v come before a lane's first code difference."""
    if flip is None:
        return n_layers
    return flip["layer"] + (flip["gemv"] != gemvs[0])


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

    cfg = stack_config()
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


def stack_config():
    """whisper-large-v3 at its published widths (bench.py:64-71)."""
    from tpu_audio_torch.models.stt import whisper as W

    return W.WhisperConfig(num_mel_bins=128, d_model=1280, encoder_layers=32,
                           encoder_attention_heads=20, encoder_ffn_dim=5120,
                           decoder_layers=32, decoder_attention_heads=20,
                           decoder_ffn_dim=5120, vocab_size=51866,
                           max_source_positions=1500, max_target_positions=448)


def random_stack_inputs(cfg, dev, seed: int = 0):
    """Kernel 3's inputs at ``cfg``'s widths from a seed, without the
    encoder: an int8 pack (uniform codes, per-row scales of N(0, 0.02)-sized
    weights, N(0, 0.02) biases with k's zero, LayerNorm weights 1 + N(0, 0.1)
    and biases N(0, 0.02)) and int8 cross K/V of max_source_positions rows
    with per-position scales of unit-sized values (0.5-1.5 / 127)."""
    import torch

    from tpu_audio_torch.ops import fused_decoder as F

    L, d, ffn, S = (cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim,
                    cfg.max_source_positions)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def uniform(*shape):
        return 0.5 + torch.rand(shape, generator=gen, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_sc = 7 * d + ffn
    biases = normal(L, n_sc) * 0.02
    biases[:, d:2 * d] = 0.0
    ln = torch.stack([1 + 0.1 * normal(L, d) if i % 2 == 0 else 0.02 * normal(L, d)
                      for i in range(6)], dim=1)
    pack = F.FusedPack(codes(L, 6 * d + ffn, d), codes(L, d, ffn),
                       uniform(L, n_sc) * (0.02 / 73.3), biases, ln.contiguous())
    cross = (codes(L, S, d), uniform(L, S) / 127.0, codes(L, S, d), uniform(L, S) / 127.0)
    return pack, cross


def stack_caches(cfg, off: int, gen, dev):
    """Self caches [L, max_target_positions, d] bf16: N(0, 0.25) rows below
    ``off``, zeros from it."""
    import torch

    L, d, s_max = cfg.decoder_layers, cfg.d_model, cfg.max_target_positions
    kc = torch.zeros((L, s_max, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :off] = (torch.randn((L, off, d), generator=gen, device=dev) * 0.5
                   ).to(torch.bfloat16)
    vc[:, :off] = (torch.randn((L, off, d), generator=gen, device=dev) * 0.5
                   ).to(torch.bfloat16)
    return kc, vc


def stack_launches(fn, n_layers: int, per_layer: int = STACK_LAYER_LAUNCHES,
                   kernels_of=STACK_KERNELS, label: str = "fused_stack") -> float:
    """A stack kernel's launches a layer in one call of ``fn`` (kernel 3's
    by default; kernel 6 gives its own count, kernel names and label),
    counted from the device activity ``torch.profiler`` records: it fails
    unless there are ``per_layer`` a layer and at most two other activities
    (the wrapper's copy of x and the zeroing of its counters). Each window
    brackets the call with sleep kernels before and after it, each set
    behind a synchronize and a wait on the host (STACK_READS); the markers
    are not counted. A window that kept no leading or no trailing marker may
    have lost events of the call, and is read again, with a longer wait and
    more leading markers; a count above the wanted one fails at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = per_layer * n_layers
    for lead, leading in STACK_READS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(lead)
            markers(leading)
            fn()
            torch.cuda.synchronize()
            markers(STACK_MARKERS)
            time.sleep(lead)
        names = [n for *_, n in device_intervals(prof)]
        call = [i for i, n in enumerate(names) if "spin_kernel" not in n]
        before = call[0] if call else 0
        after = len(names) - 1 - call[-1] if call else 0
        names = [names[i] for i in call]
        others = [n for n in names if not any(k in n for k in kernels_of)]
        kernels = len(names) - len(others)
        kept = (f"{before} of {leading} leading and {after} of {STACK_MARKERS} trailing "
                f"markers kept, {lead} s wait")
        if kernels > want or (before and after):
            break
        print(f"[{label} launches] the profile kept {kernels} of {want} kernels and "
              f"{kept}: reading again")
    print(f"[{label} launches] one call: {kernels} kernels ({kernels / n_layers:g} a "
          f"layer), {len(others)} other device activities {sorted(set(others))}; {kept}")
    check(kernels == want and len(others) <= 2 and before and after,
          f"{label} launched {kernels} kernels ({kernels / n_layers:g} a layer, "
          f"{per_layer} wanted) and {len(others)} other activities; {kept}")
    return kernels / n_layers


def stack_phase(pack, cross, cfg, dev, gen, x_at, timing: bool = True) -> dict:
    """Kernel 3 at each of STACK_OFFSETS: bit for bit against kernel 4 at
    one lane on the same inputs (outputs and caches), its cache rows
    written in place and no other row, and against its plain version, run
    free and fed kernel 3's own int8 GEMV input codes and scales (kernel
    4's tap of the same inputs shows them). Fed the codes, newk / newv of
    every layer are held at FUSED_LAYER_RTOL and y / newk / newv at
    FORCED_RTOL, and every code is the plain rounding of its input up to
    one-step flips at a boundary (check_witness). Run free: where no code
    differs from the plain rounding, layers 0-7 at FUSED_LAYER_RTOL and the
    whole stack at FUSED_RTOL; where one does, kernel 4's rule
    (check_stack_vs_plain). Then its launches a layer in one call and, with
    ``timing``, its times at STACK_TIME_OFFSET. ``x_at(offset)`` gives the
    embedded token."""
    import torch

    from tpu_audio_torch.ops import fused_decoder as F

    L, d, ffn = cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim
    kmax = max(d, ffn)
    ck, ks, cv, vs = cross
    s_src = ck.shape[1]
    bf16 = torch.bfloat16
    checks, worst_abs = {}, 0.0
    for off in STACK_OFFSETS:
        x = x_at(off)
        kc, vc = stack_caches(cfg, off, gen, dev)
        k0, v0 = kc.clone(), vc.clone()
        kc2, vc2, kc4, vc4 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        ktap = (torch.zeros((L, 6, 1, kmax), dtype=torch.int8, device=dev),
                torch.zeros((L, 6, 1), device=dev))
        ptap, ftap = ((torch.zeros((L, 6, kmax), dtype=torch.int8, device=dev),
                       torch.zeros((L, 6), device=dev), torch.zeros((L, 6, kmax), device=dev))
                      for _ in range(2))
        got = F.fused_stack(pack, ck, ks, cv, vs, kc, vc, x, off, cfg=cfg, s_src=s_src)
        want = F.fused_stack_ref(pack, ck, ks, cv, vs, kc2, vc2, x, off, cfg=cfg,
                                 s_src=s_src, tap=ptap)
        lane = torch.tensor([0], dtype=torch.int32, device=dev)
        one = F.fused_stack_lanes(pack, ck[None], ks[None], cv[None], vs[None], kc4[None],
                                  vc4[None], x[None], lane + off, lane, cfg=cfg, s_src=s_src,
                                  tap=ktap)
        kcodes = (ktap[0][:, :, 0], ktap[1][:, :, 0])
        forced = F.fused_stack_ref(pack, ck, ks, cv, vs, k0.clone(), v0.clone(), x, off,
                                   cfg=cfg, s_src=s_src, tap=ftap, codes=kcodes)
        torch.cuda.synchronize()
        flip = code_flips(ktap, tuple(t.unsqueeze(2) for t in ptap), 1)[0]

        def by_layer(want):
            return [max(rel_err(got[1][i], want[1][i]), rel_err(got[2][i], want[2][i]))
                    for i in range(L)]

        errs = [rel_err(g, w) for g, w in zip(got, want)]
        layer_errs = by_layer(want)
        forced_errs = [rel_err(g, w) for g, w in zip(got, forced)]
        forced_layer_errs = by_layer(forced)
        witness = codes_witness(cfg, kcodes, ftap, widths=[d] * 5 + [ffn])
        k0[:, off], v0[:, off] = got[1].to(bf16), got[2].to(bf16)
        writes = torch.equal(kc, k0) and torch.equal(vc, v0)
        bit_equal = all(torch.equal(a, b) for a, b in zip(
            (got[0], got[1], got[2], kc, vc), (one[0][0], one[1][:, 0], one[2][:, 0], kc4, vc4)))
        worst_abs = max(worst_abs, *(float((g - w).abs().max()) for g, w in zip(got, forced)))
        print(f"[fused_stack] d={d} L={L} offset={off}: rel err y/newk/newv "
              + "/".join(f"{e:.3e}" for e in errs) + f" (rtol {FUSED_RTOL}); newk/newv by "
              f"layer (rtol {FUSED_LAYER_RTOL} for the first {FUSED_EXACT_LAYERS}): "
              + " ".join(f"{e:.1e}" for e in layer_errs)
              + f"; cache rows written in place, others untouched: {writes}; bit-equal to "
              f"fused_stack_lanes at n=1: {bit_equal}")
        print("  int8 codes (fused_stack_lanes' tap at n=1): " + (
            f"none of the {L} x 6 GEMV inputs differ" if flip is None else
            f"first differ at layer {flip['layer']} {flip['gemv']}: {flip['codes']} code(s), "
            f"by up to {flip['step']}; plain unrounded {flip['unrounded']:.7f} "
            f"({flip['boundary_dist']:.2e} from the boundary); then kernel 4's rule, the "
            f"whole stack within {LANES_RTOL}"))
        print(f"  plain fed kernel 3's codes: y/newk/newv " + "/".join(
            f"{e:.3e}" for e in forced_errs) + f" (rtol {FORCED_RTOL}), newk/newv of every "
            f"layer within {max(forced_layer_errs):.1e} (rtol {FUSED_LAYER_RTOL}); "
            f"{witness[0]} code(s) differ from its own rounding, by up to {witness[1]}, at "
            f"most {witness[2]:.2e} from a boundary, scales {witness[3]:.1e} apart")
        check(all(bool(torch.isfinite(g).all()) for g in got), "fused_stack output")
        check(bit_equal, f"fused_stack offset {off}: not bit-equal to fused_stack_lanes "
                         f"at one lane")
        check(writes, f"fused_stack offset {off}: cache rows written wrong")
        check(max(forced_layer_errs) <= FUSED_LAYER_RTOL,
              f"fused_stack offset {off}: k/v by layer disagree with the plain version on "
              f"kernel 3's own codes: {forced_layer_errs}")
        check(max(forced_errs) <= FORCED_RTOL,
              f"fused_stack offset {off}: the stack disagrees with the plain version on "
              f"kernel 3's own codes: {forced_errs}")
        check_witness(f"fused_stack offset {off}", *witness)
        if flip is None:
            check_stack(f"fused_stack offset {off}", [(errs, layer_errs)])
        else:
            check_stack_vs_plain(f"fused_stack offset {off}", [(errs, layer_errs)], [flip])
        checks[str(off)] = dict(rel_err=max(forced_errs), layers_rel_err=max(forced_layer_errs),
                                free_rel_err=max(errs), free_layers_rel_err=max(
                                    layer_errs[:FUSED_EXACT_LAYERS]),
                                bit_equal_to_lanes=bit_equal, code_flip=flip,
                                code_flips=witness[0])

    off = STACK_TIME_OFFSET
    x = x_at(off)
    kc, vc = stack_caches(cfg, off, gen, dev)
    kc2, vc2 = kc.clone(), vc.clone()

    def kern():
        return F.fused_stack(pack, ck, ks, cv, vs, kc, vc, x, off, cfg=cfg, s_src=s_src)

    def plain():
        return F.fused_stack_ref(pack, ck, ks, cv, vs, kc2, vc2, x, off, cfg=cfg,
                                 s_src=s_src)

    rec = dict(route="cuda", source="tpu_audio_torch/csrc/fused_decoder.cu",
               replaces="tpu_audio/ops/pallas_fused_decoder.py:471", library_ms=None,
               max_abs_err=worst_abs, rel_err=max(c["rel_err"] for c in checks.values()),
               layer_launches=stack_launches(kern, L), offsets=checks)
    if not timing:
        return rec
    # weights, cross K/V, the cache rows attended (0..off), x in, y and the
    # new k/v rows out
    y = kern()
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(pack.w_in, pack.w_fc2, pack.scales, pack.biases, pack.ln,
               ck, ks, cv, vs, x, *y) + 2 * L * (off + 1) * d * 2,
        int8_ops=2 * L * (pack.w_in.shape[1] * d + d * ffn),
        f32_ops=4 * L * (off + 1 + s_src) * d)
    rec.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=5, warmup=1),
               dev_ms=device_ms(kern), plain_dev_ms=device_ms(plain, reps=2))
    return rec


def lanes_bound(pack, cfg, cross, x, out, offs, s_src: int) -> tuple[float, str]:
    """Kernel 4's bound on one call: the weights once; per lane its cross K/V
    and scales (one slot of ``cross``), the cache rows it attends (0..its
    offset), x in, y and the new k/v rows out; the int8 products and the
    attention's f32 operations."""
    L, d = cfg.decoder_layers, cfg.d_model
    n = x.shape[0]
    return bound(
        nbytes(pack.w_in, pack.w_fc2, pack.scales, pack.biases, pack.ln, x, *out)
        + n * nbytes(*(t[0] for t in cross)) + sum(2 * L * (o + 1) * d * 2 for o in offs),
        int8_ops=2 * n * L * (pack.w_in.shape[1] * d + d * cfg.decoder_ffn_dim),
        f32_ops=4 * L * d * sum(o + 1 + s_src for o in offs))


def random_lane_state(cfg, dev, slots: int, seed: int):
    """Kernel 4's stacked state at ``cfg``'s widths from a seed: int8 cross
    K/V [slots, L, max_source_positions, d] with per-position scales of
    unit-sized values (as random_stack_inputs' one slot), and self caches
    [slots, L, max_target_positions, d] bf16 with every row N(0, 0.25), rows
    at and past each lane's offset included, so that a masking or slot error
    shows. Made a slot at a time."""
    import torch

    L, d, S, s_max = (cfg.decoder_layers, cfg.d_model, cfg.max_source_positions,
                      cfg.max_target_positions)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ck, cv = (torch.empty((slots, L, S, d), dtype=torch.int8, device=dev) for _ in range(2))
    kc, vc = (torch.empty((slots, L, s_max, d), dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    for s in range(slots):
        for t in (ck, cv):
            t[s] = torch.randint(-127, 128, (L, S, d), generator=gen, device=dev,
                                 dtype=torch.int8)
        for t in (kc, vc):
            t[s] = (torch.randn((L, s_max, d), generator=gen, device=dev) * 0.5).to(t.dtype)
    ks, vs = ((0.5 + torch.rand((slots, L, S), generator=gen, device=dev)) / 127.0
              for _ in range(2))
    return ck, ks, cv, vs, kc, vc


def lane_layout(n: int, slots: int, s_max: int, seed: int) -> tuple[list, list]:
    """n lanes' slots of a ``slots``-slot state (LANE_ORDER for LANE_SLOTS
    slots, else a seeded permutation) and their offsets: LANE_OFFSETS, then
    one past the cache's end (clamped to its last row), then seeded ones."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = LANE_ORDER if slots == LANE_SLOTS else rng.permutation(slots).tolist()
    offs = LANE_OFFSETS[:n] + [s_max + 10][:max(0, n - len(LANE_OFFSETS))]
    offs += rng.integers(0, s_max, n - len(offs)).tolist()
    return order[:n], offs


def fused_lanes_check(name, pack, state, cfg, x, lanes, offs) -> dict:
    """Kernel 4 on n lanes of a stacked state (random_lane_state): each lane
    bit-equal to kernel 3 run alone on that lane's inputs (y, newk, newv and
    the cache rows written); against its plain version by kernel 4's flip
    rule: FUSED_LAYER_RTOL up to a lane's first differing int8 code, which
    must be one code, one step, at a rounding boundary, then FORCED_RTOL over
    the whole stack against the plain version fed the kernel's codes, every
    code the plain rounding up to boundary flips (as kernels 5 and 6 are
    held: after a flip a random-weight stack moves by up to ~3e-2); and no
    cache row but each lane's new one, in its own slot, changed."""
    import torch

    from tpu_audio_torch.ops import fused_decoder as F

    ck, ks, cv, vs, kc, vc = state
    L, d, ffn = cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim
    kmax, n, s_max, s_src = max(d, ffn), x.shape[0], kc.shape[2], ck.shape[2]
    dev = x.device
    clamped = [min(max(o, 0), s_max - 1) for o in offs]
    snap_k, snap_v = kc.clone(), vc.clone()
    lanes_t, offs_t = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (lanes, offs))
    ktap = (torch.zeros((L, 6, n, kmax), dtype=torch.int8, device=dev),
            torch.zeros((L, 6, n), device=dev))
    ptap = (torch.zeros_like(ktap[0]), torch.zeros_like(ktap[1]),
            torch.zeros((L, 6, n, kmax), device=dev))
    got = F.fused_stack_lanes(pack, ck, ks, cv, vs, kc, vc, x, offs_t, lanes_t, cfg=cfg,
                              s_src=s_src, tap=ktap)
    want = F.fused_stack_lanes_ref(pack, ck, ks, cv, vs, snap_k.clone(), snap_v.clone(), x,
                                   offs_t, lanes_t, cfg=cfg, s_src=s_src, tap=ptap)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name} n={n}: non-finite output")
    check(got[0].shape == (n, d) and got[1].shape == (L, n, d), f"{name} n={n}: shapes")
    bit_equal, forced_err, witness = [], [], []
    for m, (slot, off) in enumerate(zip(lanes, clamped)):
        kb, vb = snap_k[slot].clone(), snap_v[slot].clone()
        one = F.fused_stack(pack, ck[slot], ks[slot], cv[slot], vs[slot], kb, vb, x[m], off,
                            cfg=cfg, s_src=s_src)
        lane = (got[0][m], got[1][:, m], got[2][:, m])
        bit_equal.append(all(torch.equal(a, b) for a, b in zip(lane, one))
                         and torch.equal(kc[slot], kb) and torch.equal(vc[slot], vb))
        ftap = (torch.zeros((L, 6, kmax), dtype=torch.int8, device=dev),
                torch.zeros((L, 6), device=dev), torch.zeros((L, 6, kmax), device=dev))
        kcodes = (ktap[0][:, :, m], ktap[1][:, :, m])
        forced = F.fused_stack_ref(pack, ck[slot], ks[slot], cv[slot], vs[slot],
                                   snap_k[slot].clone(), snap_v[slot].clone(), x[m], off,
                                   cfg=cfg, s_src=s_src, tap=ftap, codes=kcodes)
        forced_err.append(max(rel_err(a, b) for a, b in zip(lane, forced)))
        witness.append(codes_witness(cfg, kcodes, ftap, widths=[d] * 5 + [ffn]))
    errs = stack_errors(got, want, n)
    flips = code_flips(ktap, ptap, n)
    want_k, want_v = snap_k, snap_v
    for m, (slot, off) in enumerate(zip(lanes, clamped)):
        want_k[slot, :, off] = got[1][:, m].to(torch.bfloat16)
        want_v[slot, :, off] = got[2][:, m].to(torch.bfloat16)
    writes_ok = torch.equal(kc, want_k) and torch.equal(vc, want_v)
    del want_k, want_v, snap_k, snap_v
    print(f"[{name} n={n}] slots {lanes} offsets {offs}: bit-equal to fused_stack by lane "
          f"{bit_equal}; vs plain free-running worst {max(max(w) for w, _ in errs):.3e}, "
          f"first layer after a code flip by lane {[exact_layers(f, L) for f in flips]}; "
          f"plain fed the kernel's codes worst {max(forced_err):.3e} (rtol {FORCED_RTOL}), "
          f"{sum(w[0] for w in witness)} code(s) differ from its own rounding, at most "
          f"{max(w[2] for w in witness):.2e} from a boundary, scales at most "
          f"{max(w[3] for w in witness):.1e} apart; cache rows written in place, others "
          f"untouched: {writes_ok}")
    for m, ((whole, layers), flip) in enumerate(zip(errs, flips)):
        until = exact_layers(flip, L)
        check(max(layers[:until], default=0.0) <= FUSED_LAYER_RTOL,
              f"{name} n={n} lane {m}: k/v of layers 0-{until - 1}, before any int8 code "
              f"differs, disagree: {layers[:until]}")
        if flip is not None:
            check(flip["codes"] == 1 and flip["step"] == 1
                  and flip["boundary_dist"] <= FLIP_DIST,
                  f"{name} n={n} lane {m}: the first code difference is not one rounding "
                  f"flip: {flip}")
        check(forced_err[m] <= FORCED_RTOL,
              f"{name} n={n} lane {m}: the stack disagrees with the plain version on the "
              f"kernel's own codes: {forced_err[m]}")
        check_witness(f"{name} n={n} lane {m}", *witness[m])
    check(all(bit_equal), f"{name} n={n}: lanes {bit_equal} not bit-equal to fused_stack "
                          f"on their inputs")
    check(writes_ok, f"{name} n={n}: cache rows written wrong")
    return dict(n=n, slots=lanes, offsets=offs, bit_equal_to_fused_stack=all(bit_equal),
                rel_err=max(forced_err), free_rel_err=max(max(w) for w, _ in errs),
                code_flips=sum(w[0] for w in witness),
                first_flips=[f for f in flips if f is not None])


def fused_lanes_phase(dev) -> dict:
    """Kernel 4's own checks (fused_lanes_check) on a random whisper-large-v3
    pack over a LANES_CHECK_SLOTS-slot random state at each n of
    LANES_CHECK_COUNTS, the last the lane limit supported_lanes states; and
    its launches a layer in one call at each n of STACK_LANES_COUNTED."""
    import torch

    from tpu_audio_torch.ops import fused_decoder as F

    cfg = stack_config()
    L, d = cfg.decoder_layers, cfg.d_model
    n_max = max(n for n in range(1, F.MAX_LANES + 1) if F.supported_lanes(cfg, n))
    check(n_max == LANES_CHECK_COUNTS[-1] and not F.supported_lanes(cfg, n_max + 1),
          f"supported_lanes at whisper-large-v3: the limit is {n_max}, not "
          f"{LANES_CHECK_COUNTS[-1]}")
    pack, _ = random_stack_inputs(cfg, dev, seed=3)
    state = random_lane_state(cfg, dev, LANES_CHECK_SLOTS, seed=4)
    gen = torch.Generator(device=dev).manual_seed(5)
    checks, counted = [], {}
    for n in LANES_CHECK_COUNTS:
        lanes, offs = lane_layout(n, LANES_CHECK_SLOTS, cfg.max_target_positions, seed=n)
        x = torch.randn((n, d), generator=gen, device=dev) * 0.5
        checks.append(fused_lanes_check("fused_stack_lanes", pack, state, cfg, x, lanes, offs))
        if n in STACK_LANES_COUNTED:
            lanes_t, offs_t = (torch.tensor(v, dtype=torch.int32, device=dev)
                               for v in (lanes, offs))

            def kern():
                return F.fused_stack_lanes(pack, *state, x, offs_t, lanes_t, cfg=cfg,
                                           s_src=state[0].shape[2])

            counted[str(n)] = stack_launches(kern, L, STACK_LANES_LAYER_LAUNCHES,
                                             LANES_KERNELS, f"fused_stack_lanes n={n}")
    del state
    torch.cuda.empty_cache()
    return dict(lane_limit=n_max, lane_checks=checks, layer_launches=counted)


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
        check(all(bit_equal), f"fused_stack_lanes n={n}: lanes {bit_equal} not bit-equal "
                              f"to fused_stack on their inputs")

        def kern():
            return F.fused_stack_lanes(pack, ck, ks, cv, vs, kc, vc, x, offsets, lanes,
                                       cfg=cfg, s_src=1500)

        def plain():
            return F.fused_stack_lanes_ref(pack, ck, ks, cv, vs, kr, vr, x, offsets,
                                           lanes, cfg=cfg, s_src=1500)

        b_ms, b_by = lanes_bound(pack, cfg, (ck, ks, cv, vs), x, got, offs, 1500)
        by_n[n] = dict(
            bound_ms=b_ms, bound_by=b_by,
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
                replaces="tpu_audio/ops/pallas_fused_decoder.py:912", library_ms=None,
                **top, by_lanes={str(n): r for n, r in by_n.items()})


def kv_planes(gen, dev, s: int = KV_POSITIONS, g: int = 1, biased: bool = False):
    """Kernel 2's K and V planes over ``s`` positions, each (codes, scales,
    biases) as kv_cache._quantize makes them from seeded randn [KV_HEADS, s,
    KV_HD] in ``g`` groups (the biases then replaced by seeded nonzero ones
    where ``biased``)."""
    import torch

    from tpu_audio_torch.core import kv_cache

    planes = []
    for _ in range(2):
        codes, sc, b = kv_cache._quantize(
            torch.randn((KV_HEADS, s, KV_HD), generator=gen, device=dev), g)
        if biased:
            b = torch.randn(b.shape, generator=gen, device=dev) * 0.05
        planes.append((codes, sc, b))
    return planes


def kv_bound(q, kq, vq, out) -> tuple[float, str]:
    """Kernel 2's bound on one call: q, the planes and the output once, and
    the scores' and P.V's f32 operations."""
    h, s, d = kq[0].shape
    return bound(nbytes(q, *kq, *vq, out), f32_ops=4 * h * s * d)


def same_calls(fn, n: int) -> list:
    """``n`` consecutive calls of ``fn`` (each keeping its output), then a
    synchronize; fails unless their outputs are bit for bit alike."""
    import torch

    outs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    check(all(torch.equal(o, outs[0]) for o in outs[1:]),
          f"{n} consecutive calls disagree: max diff "
          f"{max(float((o - outs[0]).abs().max()) for o in outs[1:])}")
    return outs


def kv_check(label: str, fn, q, kq, vq, valid: int) -> tuple:
    """KV_CALLS calls of ``fn`` (a call of kernel 2 on these inputs), bit
    for bit alike and within KV_RTOL of the plain version: (output, plain
    version's output, rel err)."""
    from tpu_audio_torch.ops import kv_attention as K

    want = K.decode_attention_int8_ref(q, *kq, *vq, valid, sm_scale=1.0 / KV_HD ** 0.5)
    got = same_calls(fn, KV_CALLS)[0]
    err = rel_err(got, want)
    print(f"[kv_attention] {label}: {KV_CALLS} calls bit-equal, rel err {err:.3e} "
          f"(rtol {KV_RTOL})")
    check(got.shape == want.shape and err <= KV_RTOL,
          f"decode_attention_int8 {label} disagrees with its plain version: {err}")
    return got, want, err


def kv_checks(dev) -> None:
    """Kernel 2 through its wrapper on random planes at each of KV_CHECKS
    (kv_check), and its launches in one call: one kernel, besides the
    conversion of the bf16 q."""
    import torch

    from tpu_audio_torch.ops import kv_attention as K

    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((KV_HEADS, 1, KV_HD), generator=gen, device=dev).to(torch.bfloat16)
    for s, g, valid, biased in KV_CHECKS:
        kq, vq = kv_planes(gen, dev, s, g, biased)
        kv_check(f"S {s} G {g} valid {valid}{' biased' if biased else ''}",
                 lambda: K.decode_attention_int8(q, *kq, *vq, valid, sm_scale=1.0 / KV_HD ** 0.5),
                 q, kq, vq, valid)
    kq, vq = kv_planes(gen, dev)
    stack_launches(lambda: K.decode_attention_int8(q, *kq, *vq, KV_POSITIONS,
                                                   sm_scale=1.0 / KV_HD ** 0.5),
                   1, per_layer=1, kernels_of=KV_KERNELS[:1], label="decode_attention_int8")


def mel_spectra(dev, audio) -> list:
    """Kernel 1's inputs, (label, re, im, filters): the STFT of ``audio``
    (one 30 s window) at 128 Slaney mels, as the frontend gives them; random
    spectra of its shape at 80; and random spectra under a dense random
    filterbank (no bin skipped)."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.models.stt import whisper as W

    x = torch.from_numpy(audio).to(dev)
    spec = dsp.stft(x, dsp.hanning_window(W.N_FFT, periodic=True), W.N_FFT,
                    W.HOP_LENGTH)[:-1]

    def slaney(n):
        return torch.from_numpy(dsp.mel_filters(16000, W.N_FFT, n, f_max=8000.0,
                                                norm="slaney", mel_scale="slaney")).to(dev)

    gen = torch.Generator(device=dev).manual_seed(3)
    shape = spec.shape

    def rand():
        return torch.randn(shape, generator=gen, device=dev)

    return [("speech, 128 mels", spec.real.contiguous(), spec.imag.contiguous(), slaney(128)),
            ("random, 80 mels", rand(), rand(), slaney(80)),
            ("random, dense 128", rand(), rand(),
             torch.rand((shape[1], 128), generator=gen, device=dev))]


def mel_bound(re, im, fb, out) -> tuple[float, str]:
    """Kernel 1's bound on one call: its inputs and output once, and the f32
    operations these inputs need: the power, a product for each nonzero
    weight of each frame (a banded filterbank needs no others), the log."""
    t, f = re.shape
    return bound(nbytes(re, im, fb, out),
                 f32_ops=3 * t * f + 2 * t * int((fb != 0).sum()) + out.numel())


def mel_check(label: str, fn, re, im, fb) -> tuple:
    """MEL_CALLS calls of ``fn`` (a call of kernel 1 on these inputs), bit
    for bit alike, finite and within MEL_ATOL of the plain version:
    (output, plain version's output, max abs err)."""
    import torch

    from tpu_audio_torch.ops import mel as M

    want = M.fused_log_mel_ref(re, im, fb)
    got = same_calls(fn, MEL_CALLS)[0]
    err = float((got - want).abs().max())
    print(f"[mel] {label}: [T,F]x[F,M] = [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},"
          f"{fb.shape[1]}], {MEL_CALLS} calls bit-equal, max abs err {err:.3e} "
          f"(atol {MEL_ATOL})")
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"mel output {label}")
    check(err <= MEL_ATOL, f"fused_log_mel {label} disagrees with its plain version: {err}")
    return got, want, err


def speech_window():
    """The speech clip padded to one 30 s window, f32 numpy."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.stt import whisper as W

    audio, _ = load_audio(str(AUDIO), sample_rate=16000)
    return np.pad(audio, (0, W.CHUNK_LENGTH_SAMPLES - audio.shape[0]))


def kv_attention_only() -> int:
    """Kernel 2's checks alone on random planes (kv_checks), no model: its
    check under --mutations."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    kv_checks(torch.device("cuda", 0))
    return 0


def mel_only() -> int:
    """Kernel 1's checks alone (mel_check on each of mel_spectra), no model:
    its check under --mutations."""
    import torch

    from tpu_audio_torch.ops import mel as M

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, re, im, fb in mel_spectra(torch.device("cuda", 0), speech_window()):
        mel_check(label, lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    return 0


def kernel_phases(models, cfg, audio, dev) -> tuple[dict, object]:
    """Kernels 1-3 against their plain versions; returns their records and
    the speech clip's encoder output."""
    import torch

    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import fused_decoder as F
    from tpu_audio_torch.ops import kv_attention as K
    from tpu_audio_torch.ops import mel as M

    records = {}
    # -- kernel 1: fused log-mel at the frontend's shapes, and at 80 mels ----
    spectra = mel_spectra(dev, audio)
    for label, re, im, fb in spectra[1:]:
        mel_check(label, lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    label, re, im, fb = spectra[0]
    got, want, err = mel_check(label, lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    check(got.shape == (3000, 128), "mel output shape")
    b_ms, b_by = mel_bound(re, im, fb, got)
    records["fused_log_mel"] = dict(
        route="cuda", source="tpu_audio_torch/csrc/mel.cu",
        replaces="tpu_audio/ops/pallas_mel.py:50", max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        rel_err=rel_err(got, want), ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
        plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
        dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
        plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    del spectra

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
        H, hd = KV_HEADS, KV_HD
        kq = W.kv_cache._quantize(cross_k[0, 0], 1)
        vq = W.kv_cache._quantize(cross_v[0, 0], 1)
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((H, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
        sm = 1.0 / hd ** 0.5
        kv_check("encoder planes, valid 700", lambda: K.decode_attention_int8(
            q, *kq, *vq, 700, sm_scale=sm), q, kq, vq, 700)
        got, want, err = kv_check("encoder planes", lambda: K.decode_attention_int8(
            q, *kq, *vq, 1500, sm_scale=sm), q, kq, vq, 1500)
        kv_checks(dev)
        b_ms, b_by = kv_bound(q, kq, vq, got)
        records["decode_attention_int8"] = dict(
            route="cuda", source="tpu_audio_torch/csrc/kv_attention.cu",
            replaces="tpu_audio/ops/pallas_kv_attention.py:120",
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            max_abs_err=float((got - want).abs().max()), rel_err=err,
            ms=cuda_ms(lambda: K.decode_attention_int8(q, *kq, *vq, 1500, sm_scale=sm)),
            plain_ms=cuda_ms(lambda: K.decode_attention_int8_ref(
                q, *kq, *vq, 1500, sm_scale=sm)),
            dev_ms=device_ms(lambda: K.decode_attention_int8(
                q, *kq, *vq, 1500, sm_scale=sm)),
            plain_dev_ms=device_ms(lambda: K.decode_attention_int8_ref(
                q, *kq, *vq, 1500, sm_scale=sm)))

        # -- kernel 3: the w8 decoder stack, one token at STACK_OFFSETS -----
        w8 = models["w8_kv8d"]
        w8_layers = w8.decoder.split_layers()
        cross = F.quantize_cross_kv(*W._cross_kv(w8.params, enc, cfg, w8_layers))
        p = w8.params["model"]["decoder"]

        def x_at(off):
            return (W.nn.embedding(p["embed_tokens"], torch.tensor([50258], device=dev))[0]
                    + p["embed_positions"]["weight"][off].float())

        records["fused_stack"] = stack_phase(w8.fused_decoder_pack(), cross, cfg, dev, gen,
                                             x_at)
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
                tok = torch.tensor([t], device=enc.device)
                lk = kernel_step(tok, i)[0]
                with plain_kernels():
                    lp = plain_step(tok, i)[0]
                check(bool(torch.isfinite(lk).all()), f"{cfg_name}: non-finite logits")
                if i >= len(PROMPT) - 1:
                    worst = max(worst, rel_err(lk, lp))
            print(f"[teacher-forced {cfg_name}] {len(seq) - len(PROMPT) + 1} steps: "
                  f"max rel logit err {worst:.3e} (rtol {LOGITS_RTOL})")
            check(worst <= LOGITS_RTOL, f"{cfg_name}: kernel path logits disagree")


def long_file(windows: int, rng):
    """``windows`` 30 s windows of audio, f32 numpy: the speech clip, the
    two-speaker clip (each padded to its window), then seeded noise."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.stt import whisper as W

    n = W.CHUNK_LENGTH_SAMPLES
    clips = [load_audio(str(a), sample_rate=16000)[0] for a in (AUDIO, AUDIO2)]
    parts = [np.pad(c[:n], (0, n - len(c[:n]))) for c in clips]
    parts.append((rng.standard_normal(n * (windows - len(parts))) * 0.1).astype(np.float32))
    return np.concatenate(parts)[: n * windows]


def build_w8e(models, cfg):
    """The w8 w8e kv8d model, as bench.py's _build_whisper builds the JAX
    bench's primary mode: the w8 model's int8 decoder and the bf16 encoder
    quantized on the card (``quantize_tree``, scheme w8a8), which keeps the
    convs and the position table dense."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt import whisper as W

    w8, bf16 = models["w8_kv8d"], models["bf16_kv8d"]
    enc = quant.quantize_tree(bf16.params["model"]["encoder"], scheme="w8a8")
    check(isinstance(enc["layers"]["fc1"]["weight"], quant.Int8Tensor)
          and not any(isinstance(enc[k]["weight"], quant.Int8Tensor)
                      for k in ("conv1", "conv2", "embed_positions")),
          "w8e: quantize_tree did not keep the convs and positions dense")
    model = W.Whisper(cfg, {"model": {"encoder": enc, "decoder": w8.params["model"]["decoder"]}},
                      w8.tokenizer, dtype=torch.bfloat16, device=bf16.device)
    check(model._fused_supported(), "the w8 w8e model does not take the fused route")
    return model


@contextlib.contextmanager
def counted_path(counts: dict):
    """While open: every launch counter reset, the calls of each kernel's
    plain version counted in ``counts["plain"]``, and the decode loops'
    steps in ``counts["steps"]``; on leaving, ``counts`` also holds the
    launch counters as they stand."""
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_decoder as F
    from tpu_audio_torch.ops import kv_attention as K
    from tpu_audio_torch.ops import mel as M

    plain, steps = [0], [0]
    loop = W._sample_loop

    def counting_loop(step, *a):
        def counted(*s):
            steps[0] += 1
            return step(*s)
        return loop(counted, *a)

    W._sample_loop = counting_loop
    _lib.reset_launches()
    try:
        with counting(F, "fused_stack_ref", plain), counting(F, "fused_stack_lanes_ref", plain), \
                counting(K, "decode_attention_int8_ref", plain), \
                counting(M, "fused_log_mel_ref", plain):
            yield counts
    finally:
        W._sample_loop = loop
        counts.update(_lib.launches, plain=plain[0], steps=steps[0])


def timed_generate(model, audio, gp):
    """``generate`` between two synchronizes: (output, wall s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(audio, gp)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def window_tokens(out, windows: int) -> list:
    """Each window's tokens (every window of these files has text)."""
    check(len(out.segments) == windows, f"{len(out.segments)} segments for {windows} windows")
    return [s.tokens for s in out.segments]


def w8e_encoder_check(w8e, bf16, feats, cfg) -> dict:
    """The int8 encoder against the bf16 one on ``feats`` (at W8E_DEPTH
    layers, then through all), its ``_int_mm`` products in its profile, and
    both encoders' device ms a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.models.stt import whisper as W

    n = feats.shape[0]
    with torch.inference_mode():
        short = [W._encode(m.encoder.tree(), feats, cfg, m.encoder.split_layers()[:W8E_DEPTH])
                 for m in (w8e, bf16)]
        full = [m.encoder(feats) for m in (w8e, bf16)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w8e.encoder(feats)
            torch.cuda.synchronize()
        int_mm = sum(1 for e in prof.events() if e.name == "aten::_int_mm")
        dev = {name: device_ms(lambda m=m: m.encoder(feats), reps=3)
               for name, m in (("w8e", w8e), ("bf16", bf16))}
    res = dict(rel_err_depth=rel_err(*short), rel_err=rel_err(*full), int_mm=int_mm,
               dev_ms_window={k: None if v is None else v / n for k, v in dev.items()})
    want_mm = W8E_PRODUCTS * cfg.encoder_layers
    print(f"[whisper longform w8e] encoder hidden states vs bf16 over {n} windows: rel err "
          f"{res['rel_err_depth']:.4e} at {W8E_DEPTH} layers (rtol {W8E_RTOL}), "
          f"{res['rel_err']:.4e} through {cfg.encoder_layers} (rtol {W8E_FULL_RTOL}); "
          f"{int_mm} aten::_int_mm calls in one encoder call ({want_mm} wanted); device ms "
          f"a window: w8e {fmt(res['dev_ms_window']['w8e'])}, bf16 "
          f"{fmt(res['dev_ms_window']['bf16'])}")
    print_kernels(by_kernel(prof), n, top=6)
    check(bool(torch.isfinite(full[0]).all()) and full[0].shape == full[1].shape,
          "w8e encoder output")
    check(res["rel_err_depth"] <= W8E_RTOL and res["rel_err"] <= W8E_FULL_RTOL,
          "the w8e encoder disagrees with the bf16 encoder")
    check(int_mm == want_mm, f"the w8e encoder made {int_mm} _int_mm calls")
    return res


def kv_heads_check(bf16, enc, cfg, dev) -> dict:
    """Kernel 2 over the cross planes of every window at once, [B*H, 1500,
    64] (the batched kv8d route's call, layer 0 of the bf16 decoder): three
    calls on one scratch bit for bit alike and within KV_RTOL of the plain
    version, bit-equal to the B calls of one window each on the same
    planes, and a fourth call after those (another shape on the scratch)
    bit-equal to the first; timed, with its bound."""
    import torch

    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import kv_attention as K

    b, H, hd = enc.shape[0], cfg.decoder_attention_heads, KV_HD
    with torch.inference_mode():
        lp = bf16.decoder.split_layers()[0]["encoder_attn"]
        kq, vq = (tuple(t.flatten(0, 1) for t in W.kv_cache._quantize(
            W._heads(W.nn.linear(lp[n], enc), H), 1)) for n in ("k_proj", "v_proj"))
        gen = torch.Generator(device=dev).manual_seed(4)
        q = torch.randn((b * H, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
        sm = 1.0 / hd ** 0.5

        def call():
            return K.decode_attention_int8(q, *kq, *vq, KV_POSITIONS, sm_scale=sm)

        got, want, err = kv_check(f"{b} windows' heads, [{b * H}, {KV_POSITIONS}, {hd}]",
                                  call, q, kq, vq, KV_POSITIONS)
        rows = [slice(w * H, (w + 1) * H) for w in range(b)]
        per = torch.cat([K.decode_attention_int8(q[r], *(t[r] for t in kq), *(t[r] for t in vq),
                                                 KV_POSITIONS, sm_scale=sm) for r in rows])
        again = call()
        torch.cuda.synchronize()
        per_equal, again_equal = torch.equal(got, per), torch.equal(got, again)
        b_ms, b_by = kv_bound(q, kq, vq, got)
        res = dict(heads=b * H, rel_err=err, max_abs_err=float((got - want).abs().max()),
                   bit_equal_to_windows=per_equal, bound_ms=b_ms, bound_by=b_by,
                   ms=cuda_ms(call), dev_ms=device_ms(call),
                   plain_ms=cuda_ms(lambda: K.decode_attention_int8_ref(
                       q, *kq, *vq, KV_POSITIONS, sm_scale=sm)))
    print(f"[whisper longform kv] kernel 2 over {b * H} heads: bit-equal to {b} calls of "
          f"{H} heads: {per_equal}; a call after them bit-equal to the first: {again_equal}; "
          f"per call {res['ms']:.4f} ms, device {fmt(res['dev_ms'])}, plain "
          f"{res['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    check(per_equal and again_equal, "kernel 2 over every window's heads is not the "
                                     "per-window calls bit for bit")
    return res


def lanes_step_timing(w8e, enc, cfg, max_total: int, dev) -> dict:
    """The w8 kv8d decode step of the batched route (kernel 4, one lane a
    window) against the per-window route's steps (kernel 3) summed over the
    windows, at LONG_STEP_OFFSET: ms a step with its enqueue (CUDA events)
    and on the device, the batched step's device busy share, and kernel 4's
    launches a layer in one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import fused_decoder as F

    b, L = enc.shape[0], cfg.decoder_layers
    kw = dict(max_total=max_total, cfg=cfg, layers=w8e.decoder.split_layers())
    pack = w8e.fused_decoder_pack()
    with torch.inference_mode():
        batched = W.fused_lanes_decode_step_fn(w8e.params, pack, enc, **kw)
        singles = [W.fused_decode_step_fn(w8e.params, pack, enc[w:w + 1], **kw)
                   for w in range(b)]
        toks = torch.full((b,), 50300, dtype=torch.long, device=dev)
        args = []
        lanes = F.fused_stack_lanes

        def capture(*a, **k):
            args.append((a, k))
            return lanes(*a, **k)

        F.fused_stack_lanes = capture
        try:
            batched(toks, LONG_STEP_OFFSET)
        finally:
            F.fused_stack_lanes = lanes
        a, k = args[0]
        per_layer = stack_launches(lambda: F.fused_stack_lanes(*a, **k), L,
                                   STACK_LANES_LAYER_LAUNCHES, LANES_KERNELS,
                                   label=f"fused_stack_lanes longform n={b}")

        def step_b():
            return batched(toks, LONG_STEP_OFFSET)

        def step_w():
            return [s(toks[:1], LONG_STEP_OFFSET) for s in singles]

        res = dict(windows=b, ms=cuda_ms(step_b), per_window_ms=cuda_ms(step_w),
                   dev_ms=device_ms(step_b), per_window_dev_ms=device_ms(step_w),
                   layer_launches=per_layer)
        step_b()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                step_b()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, events = device_busy(prof)
        res.update(busy_share=busy / wall_us, events_a_step=events / 8)
    print(f"[whisper longform step] w8 kv8d decode step at offset {LONG_STEP_OFFSET}: "
          f"batched ({b} lanes of kernel 4) {res['ms']:.4f} ms a step (device "
          f"{fmt(res['dev_ms'])}), per-window (kernel 3) summed over {b} windows "
          f"{res['per_window_ms']:.4f} ms (device {fmt(res['per_window_dev_ms'])}); "
          f"batched step's device busy share {res['busy_share']:.4f}, "
          f"{res['events_a_step']:.1f} device events a step")
    return res


def bf16_longform(model, audio, windows: int, kv: dict, cfg) -> dict:
    """A bf16 route (``kv``: kv8d or dense) on ``windows`` windows with
    LONG_BF16_TOKENS tokens: a counted batched run (kernel 1 once a window,
    on kv8d kernel 2 once a layer a step, no plain version), a second
    batched run with the same tokens, and each window's teacher-forced
    logits on the batched tokens, batched against the per-window route
    (``decode_step_fn`` over the window's own encoder call), within
    LOGITS_RTOL. The per-window route's greedy choice at each step of that
    prefix (its logits with generate's masks) gives, by window, the tokens
    equal before the first difference: the per-window decode's own tokens
    up to there."""
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W

    name = "bf16 kv8d" if kv else "bf16 dense"
    gp = STTGenerateParameters(max_tokens=LONG_BF16_TOKENS, **kv)
    counts: dict = {}
    with counted_path(counts):
        out, wall = timed_generate(model, audio, gp)
    toks = window_tokens(out, windows)
    again = window_tokens(timed_generate(model, audio, gp)[0], windows)
    want_kv = cfg.decoder_layers * counts["steps"] if kv else 0
    max_total = len(PROMPT) + LONG_BF16_TOKENS
    kw = dict(max_total=max_total, cfg=cfg, layers=model.decoder.split_layers(), **kv)
    worst = 0.0
    suppress, begin = model._suppress_masks(model.tokenizer)
    picks = []
    with torch.inference_mode():
        feats = torch.cat([model.encoder_features(audio[w * W.CHUNK_LENGTH_SAMPLES:
                                                        (w + 1) * W.CHUNK_LENGTH_SAMPLES])
                           for w in range(windows)])
        enc = model.encoder(feats)
        steps = [W.decode_step_fn(model.params, enc, **kw)] + [
            W.decode_step_fn(model.params, model.encoder(feats[w:w + 1]), **kw)
            for w in range(windows)]
        seqs = torch.tensor([PROMPT + t for t in toks], device=enc.device)
        for i in range(seqs.shape[1] - 1):
            lb = steps[0](seqs[:, i], i)
            lw = torch.cat([s(seqs[w:w + 1, i], i) for w, s in enumerate(steps[1:])])
            check(bool(torch.isfinite(lb).all()), f"{name}: non-finite logits")
            if i >= len(PROMPT) - 1:
                worst = max(worst, max(rel_err(lb[w], lw[w]) for w in range(windows)))
                masked = lw + suppress + (begin if i == len(PROMPT) - 1 else 0.0)
                picks.append(masked.argmax(-1).tolist())
    same = [next((i for i, t in enumerate(toks[w]) if picks[i][w] != t), len(toks[w]))
            for w in range(windows)]
    res = dict(route=name, windows=windows, tokens=LONG_BF16_TOKENS, wall_s=wall,
               launches={k: counts.get(k, 0) for k in ("fused_log_mel", "decode_attention_int8",
                                                       "fused_stack", "fused_stack_lanes")},
               steps=counts["steps"], plain_calls=counts["plain"], equal_before_diff=same,
               repeat=again == toks, teacher_forced_rel_err=worst)
    print(f"[whisper longform {name}] {windows} windows x {LONG_BF16_TOKENS} tokens batched "
          f"in {wall:.3f} s; launches {res['launches']} over {counts['steps']} steps, "
          f"plain calls {counts['plain']}; greedy tokens repeat: {again == toks}; tokens "
          f"equal to the per-window route's before the first difference, by window: {same}; "
          f"teacher-forced logits batched vs per window max rel err {worst:.3e} "
          f"(rtol {LOGITS_RTOL})")
    check(again == toks, f"{name}: greedy tokens differ between runs")
    got = res["launches"]
    check(got["fused_log_mel"] == windows and counts["plain"] == 0
          and got["decode_attention_int8"] == want_kv
          and got["fused_stack"] == got["fused_stack_lanes"] == 0,
          f"{name}: launches {got}, plain calls {counts['plain']}")
    check(worst <= LOGITS_RTOL, f"{name}: batched logits disagree with the per-window route")
    return res


def longform_phase(models, cfg, dev, smi: str) -> tuple[dict, dict]:
    """[whisper longform]: a LONG_WINDOWS-window file through the w8 w8e
    kv8d model's batched windows (kernel 4, one lane a window), held to its
    per-window decode (kernel 3) token for token, then the bf16 routes.
    Returns the phase's results and the launch counts of its main run."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W

    t_phase = time.perf_counter()
    bf16 = models["bf16_kv8d"]
    w8e = build_w8e(models, cfg)
    audio = long_file(LONG_WINDOWS, np.random.default_rng(5))
    seconds = len(audio) / W.SAMPLE_RATE
    gp = STTGenerateParameters(max_tokens=LONG_TOKENS, kv_bits=8, quantized_kv_start=448)
    max_total = len(PROMPT) + LONG_TOKENS
    print(f"[whisper longform] {smi}; whisper-large-v3 widths, random weights; cuts: "
          f"w8 w8e kv8d {LONG_WINDOWS} windows ({seconds:.0f} s: the speech clip, the "
          f"two-speaker clip, seeded noise) x {LONG_TOKENS} tokens (bench_whisper_longfile's "
          f"defaults), bf16 kv8d and bf16 dense {LONG_BF16_WINDOWS} windows x "
          f"{LONG_BF16_TOKENS} tokens; random weights never emit EOT")
    n = W.CHUNK_LENGTH_SAMPLES
    with torch.inference_mode():
        feats = torch.cat([w8e.encoder_features(audio[w * n:(w + 1) * n])
                           for w in range(LONG_WINDOWS)])
    w8e_res = w8e_encoder_check(w8e, bf16, feats, cfg)
    laps = {"w8e build and encoder check": time.perf_counter() - t_phase}

    # the main run: the batched windows, every counter reset just before
    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    with counted_path(counts):
        out, wall = timed_generate(w8e, audio, gp)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batched = window_tokens(out, LONG_WINDOWS)
    launches = {k: counts.get(k, 0) for k in ("fused_log_mel", "fused_stack_lanes",
                                              "fused_stack", "decode_attention_int8")}
    print(f"[whisper longform w8 w8e kv8d] batched: {LONG_WINDOWS} windows x "
          f"{[len(t) for t in batched]} tokens in {wall:.3f} s over {counts['steps']} steps; "
          f"launches {launches}, plain calls {counts['plain']}; peak device memory "
          f"{peak_gb:.2f} GB")
    check(all(len(t) == LONG_TOKENS for t in batched), "a window emitted EOT")
    check(launches["fused_log_mel"] == LONG_WINDOWS, "kernel 1: not one launch a window")
    check(launches["fused_stack_lanes"] == counts["steps"] == max_total - 1,
          "kernel 4: not one call a step")
    check(launches["fused_stack"] == launches["decode_attention_int8"] == 0
          and counts["plain"] == 0, "the batched w8 kv8d path ran another kernel or a "
                                    "plain version")
    per_counts: dict = {}
    with counted_path(per_counts):
        per_out, per_wall = timed_generate(w8e, audio, dataclasses.replace(
            gp, batch_windows=False))
    per = window_tokens(per_out, LONG_WINDOWS)
    equal = [a == b for a, b in zip(batched, per)]
    print(f"[whisper longform w8 w8e kv8d] per-window: in {per_wall:.3f} s, kernel 3 "
          f"launches {per_counts.get('fused_stack', 0)}, kernel 4 "
          f"{per_counts.get('fused_stack_lanes', 0)}; every window's tokens equal its "
          f"batched tokens: {equal}")
    check(all(equal), f"batched windows' tokens differ from the per-window route: {equal}")
    check(per_counts.get("fused_stack", 0) == per_counts["steps"]
          and per_counts.get("fused_stack_lanes", 0) == 0, "the per-window route's kernels")

    runs = [dict(route=r, wall_s=t, rtf=t / seconds)
            for r, t in zip(LONG_TIMED, (wall, per_wall))]
    for route in LONG_TIMED[2:]:
        o, t = timed_generate(w8e, audio, dataclasses.replace(
            gp, batch_windows=route == "batched"))
        check(window_tokens(o, LONG_WINDOWS) == batched,
              f"{route}: greedy tokens differ between runs")
        runs.append(dict(route=route, wall_s=t, rtf=t / seconds))
    for r in runs:
        print(f"[whisper longform time] {r['route']}: file {seconds:.0f} s in "
              f"{r['wall_s']:.3f} s, RTF {r['rtf']:.5f}")
    laps["w8 w8e kv8d runs"] = time.perf_counter() - t_phase
    with torch.inference_mode():
        enc = w8e.encoder(feats)
        step = lanes_step_timing(w8e, enc, cfg, max_total, dev)
        kv = kv_heads_check(bf16, bf16.encoder(feats), cfg, dev)
    laps["step timing, kernel 2 over every window's heads"] = time.perf_counter() - t_phase
    del enc, feats, w8e
    gc.collect()
    torch.cuda.empty_cache()
    bf16_runs = [bf16_longform(bf16, audio[:n * LONG_BF16_WINDOWS], LONG_BF16_WINDOWS, kv_,
                               cfg)
                 for kv_ in (dict(kv_bits=8, quantized_kv_start=448), {})]
    kv8 = bf16_runs[0]
    check(kv8["launches"]["decode_attention_int8"] == cfg.decoder_layers * kv8["steps"],
          "kernel 2: not one launch a layer a step on the bf16 kv8d route")
    laps["bf16 routes"] = time.perf_counter() - t_phase
    print(f"[whisper longform] phase took {laps['bf16 routes']:.1f} s; seconds from its "
          f"start at the end of each part: {json.dumps({k: round(v, 1) for k, v in laps.items()})}")
    res = dict(seconds=seconds, windows=LONG_WINDOWS, tokens=LONG_TOKENS, runs=runs,
               peak_gb=peak_gb, w8e=w8e_res, step=step, kv_heads=kv, bf16=bf16_runs,
               launches=launches, kv8d_launches=kv8["launches"], smi=smi)
    return res, dict(launches, decode_attention_int8=kv8["launches"]["decode_attention_int8"])


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


class ByteTokenizer:
    """Byte-level stub tokenizer (bench.py:548-554): one id per UTF-8 byte."""

    class _Ids:
        def __init__(self, ids):
            self.ids = ids

    def encode(self, text):
        return self._Ids([b % 1000 for b in text.encode()])


def randomize_norms(tree: dict, gen, names=("input_layernorm", "post_attention_layernorm",
                                             "norm", "q_norm", "k_norm")) -> None:
    """Give every RMSNorm weight 1 + N(0, 0.1), in place (init makes them 1,
    which a kernel reading the wrong norm row would not show)."""
    import torch

    for k, v in tree.items():
        if isinstance(v, dict) and k in names:
            w = v["weight"]
            v["weight"] = (1.0 + 0.1 * torch.randn(w.shape, generator=gen, device=w.device)
                           ).to(w.dtype)
        elif isinstance(v, dict):
            randomize_norms(v, gen, names)


def build_snac(dev, seed: int = 0):
    """The SNAC 24 kHz decoder and quantizers at SNAC_24K's dims with random
    weights (already weight-norm folded; the encoder is not built: nothing
    here encodes)."""
    import torch

    from tpu_audio_torch.codecs import snac as S

    cfg = S.SNACConfig(**SNAC_24K)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(o, i, k, bias=True):
        p = {"weight": torch.randn((o, i, k), generator=gen, device=dev)
             / math.sqrt(i * k)}
        if bias:
            p["bias"] = 0.01 * torch.randn((o,), generator=gen, device=dev)
        return p

    def snake(c):
        return {"alpha": torch.ones((c,), device=dev)}

    def res_unit(c):
        return {"block": {"0": snake(c), "1": conv(c, 1, 7), "2": snake(c),
                          "3": conv(c, c, 1)}}

    latent = cfg.computed_latent_dim
    model = {"0": conv(latent, 1, 7), "1": conv(cfg.decoder_dim, latent, 1)}
    idx = 2
    for i, stride in enumerate(cfg.decoder_rates):
        c_in, c_out = cfg.decoder_dim // 2 ** i, cfg.decoder_dim // 2 ** (i + 1)
        up = {"weight": torch.randn((c_in, c_out, 2 * stride), generator=gen, device=dev)
              / math.sqrt(c_in * stride), "bias": 0.01 * torch.randn((c_out,), generator=gen,
                                                                     device=dev)}
        model[str(idx)] = {"block": {"0": snake(c_in), "1": up,
                                     "2": {"linear": conv(c_out, c_out, 1, bias=False)},
                                     "3": res_unit(c_out), "4": res_unit(c_out),
                                     "5": res_unit(c_out)}}
        idx += 1
    final = cfg.decoder_dim // 2 ** len(cfg.decoder_rates)
    model[str(idx)] = snake(final)
    model[str(idx + 1)] = conv(1, final, 7)
    quantizers = {str(i): {"in_proj": conv(cfg.codebook_dim, latent, 1),
                           "out_proj": conv(latent, cfg.codebook_dim, 1),
                           "codebook": {"weight": torch.randn(
                               (cfg.codebook_size, cfg.codebook_dim), generator=gen,
                               device=dev)}}
                  for i in range(len(cfg.vq_strides))}
    return S.SNAC(cfg, {"decoder": {"model": model},
                        "quantizer": {"quantizers": quantizers}})


def build_orpheus(dev, **overrides):
    """Orpheus-3B w8a8 with the audio-band head and the SNAC 24 kHz codec,
    random weights from seed 0 (on the card), seeded non-unit norms."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.tts import llama_tts as TT

    cfg = TT.LlamaTTSConfig(**{**ORPHEUS, **overrides})
    params = llama.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                                      on_device=True)
    randomize_norms(params, torch.Generator(device=dev).manual_seed(3))
    params = quant.quantize_tree(params, scheme="w8a8")
    model = TT.LlamaTTS(cfg, params, tokenizer=ByteTokenizer(), codec=build_snac(dev),
                        dtype=torch.bfloat16, audio_band_head=True)
    check(model._fused_supported(), "Orpheus w8a8 does not take the fused route")
    return model


def llama_check(name, model, kc, vc, x, off, vf) -> dict:
    """Kernel 5 against its plain version on the same inputs, both tapping
    every GEMV input's int8 codes. Run free, newk/newv agree within
    FUSED_LAYER_RTOL up to the first code that differs, and that code is
    one step off at a rounding boundary; past it the two are different
    int8 evaluations, so the whole stack is then held against the plain
    version fed the kernel's own codes and scales: y/newk/newv within
    FORCED_RTOL over all layers, and every code the kernel chose within a
    step of the plain version's unrounded value, differing from the plain
    rounding only within FLIP_DIST of a boundary. The new rows are written
    in place."""
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg = model.config
    pack = model.fused_decoder_pack()
    L = cfg.num_hidden_layers
    dev = x.device
    snap_k, snap_v = kc.clone(), vc.clone()

    ktap, ptap, ftap = (llama_taps(cfg, dev, pre) for pre in (False, True, True))
    got = FL.fused_llama_stack(pack, kc, vc, x, off, cfg=cfg, valid_from=vf, tap=ktap)
    want = FL.fused_llama_stack_ref(pack, snap_k.clone(), snap_v.clone(), x, off, cfg=cfg,
                                    valid_from=vf, tap=ptap)
    forced = FL.fused_llama_stack_ref(pack, snap_k.clone(), snap_v.clone(), x, off,
                                      cfg=cfg, valid_from=vf, tap=ftap, codes=ktap)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output")

    def lane(t):
        return (t[0][None], t[1][:, None], t[2][:, None])

    (whole, layers), = stack_errors(lane(got), lane(want), 1)
    flip, = code_flips((ktap[0][:, :, None], ktap[1][:, :, None]),
                       tuple(t[:, :, None] for t in ptap), 1, gemvs=FL.GEMVS)
    forced_err = [rel_err(g, w) for g, w in zip(got, forced)]
    n_flips, max_step, worst_dist, scale_rel = codes_witness(cfg, ktap, ftap)
    snap_k[:, off] = got[1].to(torch.bfloat16)
    snap_v[:, off] = got[2].to(torch.bfloat16)
    writes_ok = torch.equal(kc, snap_k) and torch.equal(vc, snap_v)
    until = exact_layers(flip, L, FL.GEMVS)
    print(f"[{name}] offset {off} valid_from {vf}: free-running vs plain y/newk/newv "
          + "/".join(f"{e:.3e}" for e in whole) + "; newk/newv by layer "
          + " ".join(f"{e:.1e}" for e in layers) + "; int8 codes: " + (
              f"none of the {L} x 4 GEMV inputs differ" if flip is None else
              f"first differ at layer {flip['layer']} {flip['gemv']}: {flip['codes']} "
              f"code(s) by up to {flip['step']}, plain unrounded {flip['unrounded']:.7f} "
              f"({flip['boundary_dist']:.2e} from the boundary)")
          + f"; plain fed the kernel's codes: y/newk/newv " + "/".join(
              f"{e:.3e}" for e in forced_err) + f" (rtol {FORCED_RTOL}), {n_flips} "
          f"code(s) differ from its own rounding, by up to {max_step}, at most "
          f"{worst_dist:.2e} from a boundary, scales {scale_rel:.1e} apart; cache rows "
          f"written in place, others untouched: {writes_ok}")
    check(max(layers[:until], default=0.0) <= FUSED_LAYER_RTOL,
          f"{name} offset {off}: k/v of layers 0-{until - 1}, before any int8 code "
          f"differs, disagree: {layers[:until]}")
    if flip is not None:
        check(flip["codes"] == 1 and flip["step"] == 1
              and flip["boundary_dist"] <= FLIP_DIST,
              f"{name} offset {off}: the first code difference is not one rounding "
              f"flip: {flip}")
    check(max(forced_err) <= FORCED_RTOL,
          f"{name} offset {off}: the stack disagrees with the plain version on the "
          f"kernel's own codes: {forced_err}")
    check_witness(f"{name} offset {off}", n_flips, max_step, worst_dist, scale_rel)
    check(writes_ok, f"{name}: cache rows written wrong")
    return dict(offset=off, valid_from=vf, rel_err=max(forced_err),
                free_rel_err=max(whole), code_flips=n_flips, first_flip=flip,
                max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, forced)))


def llama_taps(cfg, dev, pre: bool, n: int | None = None):
    """Empty taps of every GEMV input's int8 codes and scales (and, with
    ``pre``, unrounded values) of kernel 5 or its plain version, or with
    ``n`` of kernel 6 or its plain version: [L, 4(, n), max(d, ffn)]."""
    import torch

    L, kmax = cfg.num_hidden_layers, max(cfg.hidden_size, cfg.intermediate_size)
    lanes = () if n is None else (n,)
    return (torch.zeros((L, 4, *lanes, kmax), dtype=torch.int8, device=dev),
            torch.zeros((L, 4, *lanes), device=dev)) + (
        (torch.zeros((L, 4, *lanes, kmax), device=dev),) if pre else ())


def codes_witness(cfg, ktap, ftap, widths=None) -> tuple[int, int, float, float]:
    """The kernel's codes (``ktap``) against the plain version's rounding of
    the same inputs (``ftap``, with unrounded values; the plain version fed
    the kernel's codes, so that both see the same upstream state): how
    many differ, by how much at most, how far from a rounding boundary
    the farthest of them lies, and how far apart the scales are.
    ``widths``: each GEMV input's width (default kernel 5's four)."""
    import torch

    kmax = ktap[0].shape[-1]
    widths = torch.tensor(widths or [cfg.hidden_size] * 3 + [cfg.intermediate_size],
                          device=ktap[0].device)
    used = torch.arange(kmax, device=widths.device)[None, None, :] < widths[None, :, None]
    diff = (ktap[0].int() - ftap[0].int()).masked_fill(~used, 0)
    pre = ftap[2]
    dist = (pre - pre.trunc()).abs().sub(0.5).abs()
    n = int((diff != 0).sum())
    return (n, int(diff.abs().max()), float(dist[diff != 0].max()) if n else 0.0,
            float((ktap[1] / ftap[1] - 1).abs().max()))


def check_witness(name, n_flips, max_step, worst_dist, scale_rel) -> None:
    check(max_step <= 1 and worst_dist <= FLIP_DIST and scale_rel <= SCALE_RTOL,
          f"{name}: the kernel's codes are not the plain rounding up to boundary "
          f"flips ({n_flips} differ, by up to {max_step}, {worst_dist:.2e} from a "
          f"boundary, scales {scale_rel:.1e} apart)")


def llama_inputs(model, dev, seed: int, s_max: int = LLAMA_S_MAX):
    """Random position-major caches (``s_max`` rows) and an embedded band
    token, as the decode step gives them to kernel 5."""
    import torch

    from tpu_audio_torch.core import nn

    cfg = model.config
    L, dkv = cfg.num_hidden_layers, cfg.num_key_value_heads * 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    kc = (torch.randn((L, s_max, dkv), generator=gen, device=dev) * 0.7
          ).to(torch.bfloat16)
    vc = (torch.randn((L, s_max, dkv), generator=gen, device=dev) * 0.7
          ).to(torch.bfloat16)
    tok = torch.tensor([model.tokens.audio_token_offset + 4097 + seed], device=dev)
    x = nn.embedding(model.params["model"]["embed_tokens"], tok)[0].float()
    return kc, vc, x


def llama_bound(pack, cfg, x, out, off: int, vf: int) -> tuple[float, str]:
    """Kernel 5's bound on one call at ``off`` from ``vf``: the weights,
    scales and norms, the cache rows attended (vf..off), x in, y and the new
    k/v rows out (written to the caches too); the int8 products and the
    attention's f32 operations."""
    L, d, dkv = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_key_value_heads * 128
    rows = off + 1 - vf
    return bound(nbytes(pack.w_in, pack.w_down, pack.scales, pack.norms, pack.inv_freq, x, *out)
                 + 2 * L * rows * dkv * 2,
                 int8_ops=2 * L * d * (pack.w_in.shape[1] + cfg.intermediate_size),
                 f32_ops=4 * L * rows * cfg.num_attention_heads * 128)


def llama_layouts(models) -> None:
    """Kernel 5's scratch layout in Python (ops.fused_llama.scratch_layout)
    held to the kernel's own (tpa_fused_llama_stack_scratch) at each model's
    width, over a cache of LLAMA_S_MAX rows and one of the long-cache check's
    length."""
    from tpu_audio_torch.ops import fused_llama as FL

    shapes = [(m.config.num_hidden_layers, m.config.hidden_size, m.config.intermediate_size,
               m.config.num_attention_heads, m.config.num_key_value_heads, s_max)
              for m in models for s_max in (LLAMA_S_MAX, LLAMA_LONG_CACHE_CHECK[0] + 1)]
    for shape in shapes:
        FL._kernel_scratch_layout(*shape)  # raises where the two differ
    print(f"[fused_llama scratch] the Python layout equals the kernel's at (L, d, ffn, "
          f"heads, kv_heads, s_max) {shapes}")


def fused_llama_phase(model, dev, timing: bool = True) -> dict:
    """Kernel 5 at Orpheus-3B width (28 layers) against its plain version at
    LLAMA_CHECKS, a 2-layer qk_norm stack and a 2-layer LLAMA_WIDE stack at
    QK_NORM_CHECKS, and the qk_norm stack at LLAMA_LONG_CACHE_CHECK on a
    cache of that length (llama_check); its scratch layout held to the
    kernel's at the three widths; its launches a layer counted at
    LLAMA_COUNTED_OFFSETS; with ``timing``, both versions timed at offset
    LLAMA_TIME_OFFSET."""
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg = model.config
    checks = []
    with torch.inference_mode():
        for i, (off, vf) in enumerate(LLAMA_CHECKS):
            kc, vc, x = llama_inputs(model, dev, i)
            checks.append(llama_check("fused_llama", model, kc, vc, x, off, vf))
        smalls = []
        for name, kw in (("qk_norm L=2", dict(num_hidden_layers=2, qk_norm=True)),
                         ("Llama-3.1-8B width L=2", LLAMA_WIDE)):
            small = build_orpheus(dev, **kw)
            for i, (off, vf) in enumerate(QK_NORM_CHECKS):
                kc, vc, x = llama_inputs(small, dev, 10 + i)
                checks.append(llama_check(f"fused_llama {name}", small, kc, vc, x, off, vf))
            smalls.append(small)
        # the long cache: its rows from seed 12, the embedded token of seed 10
        # (held at QK_NORM_CHECKS above). Two of seed 12's layer-0 q/k/v
        # inputs, one -3 times the other under the same norm weight, land on
        # rounding boundaries together (8.5 and -25.5), beyond llama_check's
        # one-flip rule; the parent kernel rounds them as this one does.
        off, vf = LLAMA_LONG_CACHE_CHECK
        kc, vc, _ = llama_inputs(smalls[0], dev, 12, s_max=off + 1)
        x = llama_inputs(smalls[0], dev, 10, s_max=1)[2]
        checks.append(llama_check(f"fused_llama qk_norm L=2 S_max={off + 1}", smalls[0], kc, vc,
                                  x, off, vf))
        del kc, vc
        llama_layouts([model, *smalls])
        del smalls, small
        pack = model.fused_decoder_pack()
        L = cfg.num_hidden_layers
        layer_launches = {}
        for off in LLAMA_COUNTED_OFFSETS:
            kc, vc, x = llama_inputs(model, dev, 5)

            def counted():
                return FL.fused_llama_stack(pack, kc, vc, x, off, cfg=cfg)

            layer_launches[off] = stack_launches(counted, L, LLAMA_LAYER_LAUNCHES,
                                                 LLAMA_K5_KERNELS,
                                                 f"fused_llama_stack offset {off}")
        rec = dict(route="cuda", source="tpu_audio_torch/csrc/fused_llama.cu",
                   replaces="tpu_audio/ops/pallas_fused_llama.py:413", library_ms=None,
                   max_abs_err=max(c["max_abs_err"] for c in checks),
                   rel_err=max(c["rel_err"] for c in checks), checks=checks,
                   layer_launches=layer_launches[LLAMA_TIME_OFFSET])
        if not timing:
            return rec
        kc, vc, x = llama_inputs(model, dev, 7)
        kr, vr = kc.clone(), vc.clone()
        off = LLAMA_TIME_OFFSET

        def kern():
            return FL.fused_llama_stack(pack, kc, vc, x, off, cfg=cfg)

        def plain():
            return FL.fused_llama_stack_ref(pack, kr, vr, x, off, cfg=cfg)

        b_ms, b_by = llama_bound(pack, cfg, x, kern(), off, 0)
        rec.update(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=3, warmup=1),
                   dev_ms=device_ms(kern, launches=LLAMA_LAYER_LAUNCHES * L,
                                    busy=DEVICE_BUSY),
                   plain_dev_ms=device_ms(plain, reps=2),
                   bound_ms=b_ms, bound_by=b_by, time_offset=off)
    print(f"[time] fused_llama_stack at offset {off}: per call kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms; device kernel {fmt(rec['dev_ms'])}, plain "
          f"{fmt(rec['plain_dev_ms'])}; bound {b_ms:.4f} ms ({b_by})")
    return rec


def tts_prefill(model, prompt, max_tokens: int, valid_from: int | None = None):
    """``_run_generation``'s prefill: the prompt left-padded to its bucket
    through ``llama.forward`` into the fused route's cache. Returns its
    decode state and the last prompt token, which the decode loop feeds
    first."""
    import numpy as np
    import torch

    dev = model.device
    bucket = max(64, 1 << math.ceil(math.log2(max(len(prompt), 2))))
    pad = bucket - len(prompt)
    padded = np.full((1, bucket), model.tokens.pad_token, np.int64)
    padded[0, pad:] = prompt
    cache, fused = model._fused_cache(bucket + max_tokens + 1,
                                      pad if valid_from is None else valid_from)
    _, cache = model._prefill(model.params, torch.from_numpy(padded[:, :-1]).to(dev), cache)
    return fused._replace(offset=cache.offset), torch.tensor([prompt[-1]], device=dev)


def tts_generate_phase(model) -> tuple[list, dict, list]:
    """LlamaTTS.generate twice (greedy; identical tokens) and
    generate_stream once, TTS_TOKENS tokens each, every launch counter
    reset just before and read just after each run: one kernel launch for
    each decode step the loop took (those past a stop token, up to the
    loop's next read of its finished flag, included) and no call of the
    plain version. Returns the runs, the last run's launches and the
    generated tokens."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.ar_loop import SYNC_EVERY
    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_llama as FL

    gp = AudioGenerateParameters(max_tokens=TTS_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    T = model.tokens
    hop = model.codec.config.hop_length
    plain_calls = [0]
    ref = FL.fused_llama_stack_ref

    def counted(*a, **k):
        plain_calls[0] += 1
        return ref(*a, **k)

    seen = {}
    run_generation = model._run_generation
    step_fn = model._fused_step_fn
    step_calls = [0]

    def counted_step(*a, **k):
        step_calls[0] += 1
        return step_fn(*a, **k)

    def spy(*a, **k):
        for item in run_generation(*a, **k):
            seen["item"] = item
            yield item

    runs, first, launches = [], None, {}
    FL.fused_llama_stack_ref = counted
    model._run_generation = spy
    model._fused_step_fn = counted_step  # the decoders built below call it
    model._decoders.clear()
    try:
        for run in range(3):
            stream = run == 2
            _lib.reset_launches()
            step_calls[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stream:
                events = list(model.generate_stream(TTS_TEXT, generation_parameters=gp))
                wav = np.concatenate([e.audio for e in events
                                      if e.kind == AudioGenerationKind.AUDIO])
                n_tok = sum(e.kind == AudioGenerationKind.TOKEN for e in events)
            else:
                wav = model.generate(TTS_TEXT, generation_parameters=gp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.launches)
            _, _, (pt, gt, plen, all_tokens) = seen["item"]
            toks = all_tokens[plen:]
            if stream:
                check(n_tok == len(toks), "generate_stream: token events != tokens")
            steps = len(toks) + (len(toks) < TTS_TOKENS)  # the stop token's step
            frames = len(model.parse_output(all_tokens)) // 7
            print(f"[tts {'generate_stream' if stream else 'generate'} run {run}] "
                  f"{len(toks)} tokens ({steps} decode steps kept, {step_calls[0]} taken) "
                  f"in {wall:.3f} s "
                  f"(prefill {pt * 1e3:.3f} ms, decode {gt * 1e3 / step_calls[0]:.4f} ms a "
                  f"step); "
                  f"{wav.shape[0]} samples ({frames} frames); launches {launches}, "
                  f"plain version calls {plain_calls[0]}")
            check(launches.get("fused_llama_stack", 0) == step_calls[0],
                  f"fused_llama_stack launched {launches.get('fused_llama_stack', 0)} "
                  f"times for {step_calls[0]} decode steps")
            check(step_calls[0] == steps if len(toks) == TTS_TOKENS
                  else steps <= step_calls[0] < steps + SYNC_EVERY,
                  f"{step_calls[0]} decode steps for {steps} kept")
            check(plain_calls[0] == 0, "the plain version ran on the main path")
            check(wav.shape == (frames * 4 * hop,) and frames > 0
                  and bool(np.isfinite(wav).all()), f"waveform {wav.shape}")
            check(len(toks) < TTS_TOKENS or frames == TTS_TOKENS // 7,
                  f"{TTS_TOKENS} tokens made {frames} frames")
            check(all(T.audio_token_offset <= t < T.audio_token_offset + 7 * T.codebook_size
                      for t in toks), "a token outside the audio band")
            if first is None:
                first = (toks, wav)
            check(toks == first[0], "greedy tokens differ between runs")
            check(np.array_equal(wav, first[1]) if not stream
                  else wav.shape == first[1].shape, "waveform differs between runs")
            runs.append(dict(api="generate_stream" if stream else "generate", run=run,
                             tokens=len(toks), steps=steps, wall_s=wall, prefill_s=pt,
                             steps_taken=step_calls[0],
                             decode_ms_per_step=gt * 1e3 / step_calls[0], samples=int(wav.shape[0]),
                             realtime_x=wav.shape[0] / model.sample_rate / wall))
    finally:
        FL.fused_llama_stack_ref = ref
        del model._run_generation, model._fused_step_fn
        model._decoders.clear()
    print(f"first tokens: {first[0][:14]}")
    return runs, launches, first[0]


def tts_teacher_forced(model, tokens) -> dict:
    """The first TTS_TEACHER_STEPS generated tokens forced through the
    decode step three ways from one prefill: with kernel 5 (its codes
    tapped), with the plain version fed the kernel's codes and scales
    (band logits within FORCED_RTOL; every kernel code the plain rounding
    of the same inputs up to boundary flips, as in llama_check), and with
    the plain version free-running (its band-logit distance is a reading:
    one rounding flip moves the random-weight stack by up to ~1e-1)."""
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg = model.config
    dev = model.device
    kernel, ref = FL.fused_llama_stack, FL.fused_llama_stack_ref
    taps = {}

    def tapped(*a, **k):
        taps["k"] = llama_taps(cfg, dev, False)
        return kernel(*a, **k, tap=taps["k"])

    def forced(*a, **k):
        taps["f"] = llama_taps(cfg, dev, True)
        return ref(*a, **k, tap=taps["f"], codes=taps["k"])

    prompt = model.prepare_input_ids(TTS_TEXT)
    worst = dict(forced=0.0, free=0.0, flips=0, step=0, dist=0.0, scale=0.0)
    try:
        with torch.inference_mode():
            fc, last = tts_prefill(model, prompt, TTS_TOKENS)
            caches = {m: fc._replace(k=fc.k.clone(), v=fc.v.clone())
                      for m in ("kernel", "forced", "free")}
            params = {**model.params, "fused_pack": model.fused_decoder_pack()}
            for t in ([int(last[0])] + list(tokens))[:TTS_TEACHER_STEPS]:
                tok = torch.tensor([[t]], device=dev)
                logits = {}
                for mode, fn in (("kernel", tapped), ("forced", forced), ("free", ref)):
                    FL.fused_llama_stack = fn
                    logits[mode], caches[mode] = model._fused_step_fn(params, tok,
                                                                      caches[mode])
                check(bool(torch.isfinite(logits["kernel"]).all()), "tts: non-finite logits")
                flips, step, dist, scale = codes_witness(cfg, taps["k"], taps["f"])
                check_witness(f"tts teacher-forced token {t}", flips, step, dist, scale)
                worst = dict(forced=max(worst["forced"], rel_err(logits["kernel"],
                                                                 logits["forced"])),
                             free=max(worst["free"], rel_err(logits["kernel"],
                                                             logits["free"])),
                             flips=worst["flips"] + flips, step=max(worst["step"], step),
                             dist=max(worst["dist"], dist), scale=max(worst["scale"], scale))
    finally:
        FL.fused_llama_stack = kernel
    print(f"[tts teacher-forced] {TTS_TEACHER_STEPS} steps: band logits vs the plain "
          f"version fed the kernel's codes {worst['forced']:.3e} (rtol {FORCED_RTOL}); "
          f"{worst['flips']} kernel code(s) differ from the plain rounding, by up to "
          f"{worst['step']}, at most {worst['dist']:.2e} from a boundary, scales "
          f"{worst['scale']:.1e} apart; vs the free-running plain version "
          f"{worst['free']:.3e}")
    check(worst["forced"] <= FORCED_RTOL,
          "tts: kernel path logits disagree with the plain version on its codes")
    return worst


def tts_ttfb_phase(model) -> dict:
    """bench.py's bench_tts_ttfb(fused=True) protocol: a 64-token prompt
    bucket, a TTFB_CHUNK-token chunk sampled at temperature 0.6 and top-p
    0.9 through kernel 5, then the SNAC decode of its 4 frames; the best of
    TTFB_REPEATS after a warm-up. Then ms a token (host clock, and device
    time from torch.profiler: the union of the device intervals, kernel 5's
    of its own), the busy share and a per-kernel breakdown of one
    TTS_PROFILE_TOKENS-token chunk, in which every one of kernel 5's
    launches must be recorded."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.ops import _lib

    gp = AudioGenerateParameters(temperature=0.6, top_p=0.9, repetition_penalty=1.0)
    prompt = [0] * (TTFB_BUCKET - 8) + list(range(100, 108))
    dec = model._get_decoder(gp, fused=True)
    params = {**model.params, "fused_pack": model.fused_decoder_pack()}
    dev = model.device

    def state():  # the repetition ring and its write count
        return (torch.zeros((1, gp.repetition_context_size), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    def chunk(n, seed, max_tokens):
        fc, last = tts_prefill(model, prompt, max_tokens, valid_from=0)
        return dec(params, fc, last, torch.zeros((n,), dtype=torch.int64, device=dev),
                   torch.Generator(device=dev).manual_seed(seed), -1, *state())

    def first_audio(seed):
        toks = chunk(TTFB_CHUNK, seed, TTFB_CHUNK + 1)[0]
        f = toks.reshape(TTFB_CHUNK // 7, 7) % 4096
        wav = model.codec.decode([f[:, :1].reshape(1, -1), f[:, 1:3].reshape(1, -1),
                                  f[:, 3:7].reshape(1, -1)], seed=seed)
        return wav.float().cpu().numpy()

    with torch.inference_mode():
        wav = first_audio(0)
        times = []
        for r in range(TTFB_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first_audio(r + 1)
            times.append(time.perf_counter() - t0)
        check(wav.shape == (1, TTFB_CHUNK // 7 * 4 * model.codec.config.hop_length)
              and bool(np.isfinite(wav).all()), f"ttfb waveform {wav.shape}")
        ttfb = min(times)
        audio_s = wav.size / model.sample_rate
        # ms a token: the decode chunk alone (its prefill outside the clock)
        n = TTS_PROFILE_TOKENS
        fc, last = tts_prefill(model, prompt, n + 1, valid_from=0)
        def args():
            return (params, fc._replace(k=fc.k.clone(), v=fc.v.clone()), last,
                    torch.zeros((n,), dtype=torch.int64, device=dev),
                    torch.Generator(device=dev).manual_seed(9), -1, *state())

        walls = []
        for _ in range(3):
            a = args()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec(*a)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # the profiled chunk, its window opened and closed by markers
        # (STACK_READS): every kernel 5 launch of the chunk must be in it, L x
        # LLAMA_LAYER_LAUNCHES a call
        L = model.config.num_hidden_layers
        for lead, leading in STACK_READS:
            a = args()
            _lib.reset_launches()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(lead)
                markers(leading)
                t0 = time.perf_counter()
                dec(*a)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) * 1e3
                markers(STACK_MARKERS)
                time.sleep(lead)
            calls = _lib.launches["fused_llama_stack"]
            spans = device_intervals(prof)
            call = [i for i, s in enumerate(spans) if "spin_kernel" not in s[2]]
            kept = (call[0] if call else 0, len(spans) - 1 - call[-1] if call else 0)
            spans = [spans[i] for i in call]
            k5 = [s for s in spans if any(k in s[2] for k in LLAMA_K5_KERNELS)]
            want = calls * L * LLAMA_LAYER_LAUNCHES
            if len(k5) == want and all(kept):
                break
            print(f"[tts decode] the profile kept {len(k5)} of kernel 5's {want} launches "
                  f"({kept[0]} of {leading} leading, {kept[1]} of {STACK_MARKERS} trailing "
                  f"markers, {lead} s wait): reading again")
    check(len(k5) == want and all(kept) and calls > 0,
          f"the decode profile holds {len(k5)} kernel 5 events of {calls} calls "
          f"({want} wanted), markers kept {kept}")
    kernels = {k: v for k, v in by_kernel(prof).items() if "spin_kernel" not in k}
    busy_ms = interval_union(spans) / 1e3
    n_events = len(spans)
    k5_ms = interval_union(k5) / 1e3
    out = dict(ttfb_ms=ttfb * 1e3, ttfb_all_ms=[t * 1e3 for t in times],
               first_audio_s=audio_s, realtime_x=audio_s / ttfb,
               ms_per_token=min(walls) * 1e3 / n, device_ms_per_token=busy_ms / n,
               kernel5_device_ms_per_token=k5_ms / n, busy_share=busy_ms / prof_ms,
               device_events_per_token=n_events / n)
    print(f"[tts ttfb] bucket {TTFB_BUCKET}, {TTFB_CHUNK}-token chunk (T 0.6, top-p 0.9) + "
          f"SNAC decode of {TTFB_CHUNK // 7} frames: TTFB {ttfb * 1e3:.3f} ms (best of "
          f"{[f'{t * 1e3:.3f}' for t in times]}), {audio_s:.4f} s of audio: realtime x "
          f"{audio_s / ttfb:.3f}")
    print(f"[tts decode] {n}-token chunk: {min(walls) * 1e3 / n:.4f} ms a token "
          f"(best of 3, host clock); under the profiler wall {prof_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (share {busy_ms / prof_ms:.4f}), {busy_ms / n:.4f} device ms a "
          f"token of which kernel 5 {k5_ms / n:.4f} ({len(k5)} launches over {calls} calls: "
          f"{L} x {LLAMA_LAYER_LAUNCHES} a call); {n_events / n:.1f} device events a token")
    print_kernels(kernels, n, top=14)
    return out


def llama_lane_inputs(model, dev, slots: int, n: int, seed: int, s_max: int = LLAMA_S_MAX,
                      lane_checks=LLAMA_LANE_CHECKS):
    """A stacked [slots, L, s_max, dkv] state with every row of every slot
    random (rows below a lane's valid_from and above its offset included,
    so a masking or slot error shows), the n lanes' slots in shuffled order
    (LANE_ORDER for 8 slots), their (offset, valid_from) (``lane_checks``,
    then seeded ones) and embedded band tokens."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import nn

    cfg = model.config
    L, dkv = cfg.num_hidden_layers, cfg.num_key_value_heads * 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    kc = (torch.randn((slots, L, s_max, dkv), generator=gen, device=dev) * 0.7
          ).to(torch.bfloat16)
    vc = (torch.randn((slots, L, s_max, dkv), generator=gen, device=dev) * 0.7
          ).to(torch.bfloat16)
    rng = np.random.default_rng(seed)
    order = LANE_ORDER if slots == LANE_SLOTS else rng.permutation(slots).tolist()
    checks = list(lane_checks)
    while len(checks) < n:
        off = int(rng.integers(0, s_max))
        checks.append((off, int(rng.integers(0, min(off, 64) + 1))))
    toks = torch.tensor([model.tokens.audio_token_offset + 4096 * (m % 7) + 11 * m + seed
                         for m in range(n)], device=dev)
    x = nn.embedding(model.params["model"]["embed_tokens"], toks).float()
    return kc, vc, order[:n], checks[:n], x


def llama_lanes_check(name, model, kc, vc, lanes, checks, x) -> dict:
    """Kernel 6 on n lanes: each lane bit-equal to kernel 5 run alone on
    that lane's inputs (y, newk, newv, the cache rows written, every GEMV
    input's int8 codes and scales); against its plain version by kernel 5's
    rule (llama_check): FUSED_LAYER_RTOL up to a lane's first differing
    codes, each a rounding flip (one step, its unrounded value within
    FLIP_DIST of the boundary; several can tie at once where an embedded
    row's int8 x bf16 products land on .5 exactly), then FORCED_RTOL over
    the whole stack against the plain version fed the kernel's codes, every
    code the plain rounding up to boundary flips; and no row but each
    lane's new one, in its own slot, changed."""
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg = model.config
    pack = model.fused_decoder_pack()
    L, n, s_max = cfg.num_hidden_layers, x.shape[0], kc.shape[2]
    dev = x.device
    offs = [min(o, s_max - 1) for o, _ in checks]
    vfs = [vf for _, vf in checks]
    snap_k, snap_v = kc.clone(), vc.clone()
    lanes_t, offs_t, vfs_t = (torch.tensor(v, dtype=torch.int64, device=dev)
                              for v in (lanes, [o for o, _ in checks], vfs))
    ktap, ptap, ftap = (llama_taps(cfg, dev, pre, n) for pre in (False, True, True))
    got = FL.fused_llama_stack_lanes(pack, kc, vc, lanes_t, x, offs_t, vfs_t, cfg=cfg,
                                     tap=ktap)
    want = FL.fused_llama_stack_lanes_ref(pack, snap_k.clone(), snap_v.clone(), lanes_t, x,
                                          offs_t, vfs_t, cfg=cfg, tap=ptap)
    forced = FL.fused_llama_stack_lanes_ref(pack, snap_k.clone(), snap_v.clone(), lanes_t, x,
                                            offs_t, vfs_t, cfg=cfg, tap=ftap, codes=ktap)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output")
    check(got[0].shape == x.shape and got[1].shape[:2] == (L, n), f"{name}: shapes")
    bit_equal = []
    for m, (slot, off, vf) in enumerate(zip(lanes, offs, vfs)):
        kb, vb = snap_k[slot].clone(), snap_v[slot].clone()
        t5 = llama_taps(cfg, dev, False)
        one = FL.fused_llama_stack(pack, kb, vb, x[m].contiguous(), off, cfg=cfg,
                                   valid_from=vf, tap=t5)
        bit_equal.append(
            all(torch.equal(a, b) for a, b in zip((got[0][m], got[1][:, m], got[2][:, m]), one))
            and torch.equal(kc[slot], kb) and torch.equal(vc[slot], vb)
            and torch.equal(ktap[0][:, :, m], t5[0]) and torch.equal(ktap[1][:, :, m], t5[1]))
    errs = stack_errors(got, want, n)
    flips = code_flips(ktap, ptap, n, gemvs=FL.GEMVS)
    forced_err = [max(rel_err(g, w) for g, w in zip(
        (got[0][m], got[1][:, m], got[2][:, m]), (forced[0][m], forced[1][:, m], forced[2][:, m])))
        for m in range(n)]
    witness = [codes_witness(cfg, tuple(t[:, :, m] for t in ktap),
                             tuple(t[:, :, m] for t in ftap)) for m in range(n)]
    scale_rel = (ktap[1] / ftap[1] - 1).abs()  # [L, 4, n]
    worst_scale = divmod(int(scale_rel.argmax()), 4 * n)
    worst_scale = (worst_scale[0], FL.GEMVS[worst_scale[1] // n], worst_scale[1] % n)
    want_k, want_v = snap_k.clone(), snap_v.clone()
    for m, (slot, off) in enumerate(zip(lanes, offs)):
        want_k[slot, :, off] = got[1][:, m].to(torch.bfloat16)
        want_v[slot, :, off] = got[2][:, m].to(torch.bfloat16)
    writes_ok = torch.equal(kc, want_k) and torch.equal(vc, want_v)
    print(f"[{name} n={n}] slots {lanes} (offset, valid_from) {checks}: bit-equal to "
          f"fused_llama_stack by lane {bit_equal}; vs plain free-running worst "
          f"{max(max(w) for w, _ in errs):.3e}, first layer after a code flip by lane "
          f"{[exact_layers(f, L, FL.GEMVS) for f in flips]}; plain fed the kernel's codes "
          f"worst {max(forced_err):.3e} (rtol {FORCED_RTOL}), "
          f"{sum(w[0] for w in witness)} code(s) differ from its own rounding, at most "
          f"{max(w[2] for w in witness):.2e} from a boundary, scales at most "
          f"{float(scale_rel.max()):.1e} apart (layer, input, lane {worst_scale}); cache "
          f"rows written in place, others untouched: {writes_ok}")
    for m, ((whole, layers), flip) in enumerate(zip(errs, flips)):
        until = exact_layers(flip, L, FL.GEMVS)
        check(max(layers[:until], default=0.0) <= FUSED_LAYER_RTOL,
              f"{name} n={n} lane {m}: k/v of layers 0-{until - 1}, before any int8 code "
              f"differs, disagree: {layers[:until]}")
        if flip is not None:
            check(flip["step"] == 1 and flip["boundary_dist"] <= FLIP_DIST,
                  f"{name} n={n} lane {m}: the first code differences are not rounding "
                  f"flips: {flip}")
        check(forced_err[m] <= FORCED_RTOL,
              f"{name} n={n} lane {m}: the stack disagrees with the plain version on the "
              f"kernel's own codes: {forced_err[m]}")
        check_witness(f"{name} n={n} lane {m}", *witness[m])
    check(all(bit_equal), f"{name} n={n}: a lane differs from fused_llama_stack")
    check(writes_ok, f"{name} n={n}: cache rows written wrong")
    return dict(n=n, checks=checks, bit_equal_to_fused_llama_stack=all(bit_equal),
                rel_err=max(forced_err), free_rel_err=max(max(w) for w, _ in errs),
                code_flips=sum(w[0] for w in witness),
                first_flips=[f for f in flips if f is not None],
                max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, forced)))


def llama_lanes_phase(model, dev, timing: bool = True) -> dict:
    """Kernel 6 at Orpheus-3B width at n in LLAMA_LANE_COUNTS over an 8-slot
    state and at the largest n supported_lanes takes over a state of that
    many slots, and a 2-layer qk_norm stack at n = 4 and over the longest
    cache the wrapper takes (LANES_S_MAX rows; one more is refused) at n =
    2 (llama_lanes_check); with ``timing``, kernel and plain version timed
    at each n."""
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg = model.config
    n_max = max(n for n in range(1, FL.MAX_LANES + 1) if FL.supported_lanes(cfg, n))
    check(not FL.supported_lanes(cfg, n_max + 1) and n_max == 28,
          f"supported_lanes at Orpheus width: the limit is {n_max}, not 28")
    by_n, checks = {}, []
    with torch.inference_mode():
        small = build_orpheus(dev, num_hidden_layers=2, qk_norm=True)
        kc, vc, lanes, offs, x = llama_lane_inputs(small, dev, LANE_SLOTS, 4, 20)
        checks.append(llama_lanes_check("fused_llama_lanes qk_norm L=2", small, kc, vc, lanes,
                                        offs, x))
        del kc, vc
        kc, vc, lanes, offs, x = llama_lane_inputs(small, dev, 2, 2, 21, FL.LANES_S_MAX,
                                                   LLAMA_LONG_CACHE_CHECKS)
        checks.append(llama_lanes_check(f"fused_llama_lanes qk_norm L=2 S_max={FL.LANES_S_MAX}",
                                        small, kc, vc, lanes, offs, x))
        over = torch.empty((1, 2, FL.LANES_S_MAX + 1, kc.shape[3]), dtype=kc.dtype, device=dev)
        zero = torch.zeros((1,), dtype=torch.int64, device=dev)
        try:
            FL.fused_llama_stack_lanes(small.fused_decoder_pack(), over, over, zero, x[:1], zero,
                                       zero, cfg=small.config)
            refused = False
        except ValueError as e:
            refused = "takes at most" in str(e)
        check(refused, f"fused_llama_stack_lanes took a cache of {FL.LANES_S_MAX + 1} rows")
        del small, kc, vc, over
        for n in LLAMA_LANE_COUNTS + (n_max,):
            slots = max(LANE_SLOTS, n)
            kc, vc, lanes, offs, x = llama_lane_inputs(model, dev, slots, n, n)
            rec = llama_lanes_check("fused_llama_lanes", model, kc, vc, lanes, offs, x)
            checks.append(rec)
            pack = model.fused_decoder_pack()
            args = [torch.tensor(v, dtype=torch.int64, device=dev) for v in
                    (lanes, [o for o, _ in offs], [vf for _, vf in offs])]

            def kern():
                return FL.fused_llama_stack_lanes(pack, kc, vc, args[0], x, args[1],
                                                  args[2], cfg=cfg)

            if n in LLAMA_LANES_COUNTED:
                rec["layer_launches"] = stack_launches(
                    kern, cfg.num_hidden_layers, LLAMA_LANES_LAYER_LAUNCHES,
                    LLAMA_LANES_KERNELS, f"fused_llama_stack_lanes n={n}")
            if timing:
                kr, vr = kc.clone(), vc.clone()

                def plain():
                    return FL.fused_llama_stack_lanes_ref(pack, kr, vr, args[0], x, args[1],
                                                          args[2], cfg=cfg)

                L = cfg.num_hidden_layers
                b_ms, b_by = llama_lanes_bound(pack, cfg, x, kern(), offs)
                rec.update(bound_ms=b_ms, bound_by=b_by, ms=cuda_ms(kern),
                           plain_ms=cuda_ms(plain, reps=3, warmup=1),
                           dev_ms=device_ms(kern, launches=LLAMA_LANES_LAYER_LAUNCHES * L,
                                            busy=DEVICE_BUSY),
                           plain_dev_ms=device_ms(plain, reps=1))
                print(f"[time] fused_llama_stack_lanes n={n}: per call kernel "
                      f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms; device kernel "
                      f"{fmt(rec['dev_ms'])}, plain {fmt(rec['plain_dev_ms'])}; bound "
                      f"{b_ms:.4f} ms ({b_by})")
            by_n[n] = rec
            del kc, vc
    def brief(r):
        return {k: v for k, v in r.items() if k not in ("checks", "first_flips")}

    return dict(route="cuda", source="tpu_audio_torch/csrc/fused_llama_lanes.cu",
                replaces="tpu_audio/ops/pallas_fused_llama.py:766", library_ms=None,
                **brief(by_n[max(LLAMA_LANE_COUNTS)]), lane_limit=n_max, checks=checks,
                by_lanes={str(n): brief(r) for n, r in by_n.items()})


def tts_server(model, **kw):
    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.parallel.continuous import ContinuousTTS

    gp = AudioGenerateParameters(max_tokens=TTS_SERVE_MAX_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    srv = ContinuousTTS(model, **{**dict(slots=TTS_SERVE_SLOTS, generation_parameters=gp,
                                         step_tokens=7), **kw})
    check(srv.fused, "ContinuousTTS did not take the fused tick")
    return srv


def tts_serve_staggered(model, cancel=None, flushes=None):
    """Submit two texts, step, submit the rest, drain (request i with seed
    i); with ``cancel=i``, cancel request i after two ticks. Every engine
    tick runs under the strict sync mode; the SNAC flushes (timed into
    ``flushes``) may read back. Returns each request's tokens and audio."""
    import time as _time

    import numpy as np

    srv = tts_server(model)
    if flushes is not None:
        delta = srv._audio_delta

        def timed(req):
            t0 = _time.perf_counter()
            out = delta(req)
            flushes.append(_time.perf_counter() - t0)
            return out

        srv._audio_delta = timed
    reqs = [srv.submit(t, seed=i) for i, t in enumerate(TTS_SERVE_TEXTS[:2])]
    audio = {}

    def take(events):
        for rid, ev in events:
            if ev.audio is not None:
                audio.setdefault(rid, []).append(np.asarray(ev.audio))

    with no_host_sync(srv.engine):
        take(srv.step())
        reqs += [srv.submit(t, seed=i) for i, t in enumerate(TTS_SERVE_TEXTS[2:], 2)]
        if cancel is not None:
            take(srv.step())
            check(srv.cancel(reqs[cancel].request_id), "cancel refused")
        take(srv.run())
    check(all(r.done for r in reqs), "a served request did not finish")
    return [list(r.tokens) for r in reqs], [
        np.concatenate(audio[r.request_id]) if r.request_id in audio else np.zeros(0)
        for r in reqs]


def tts_serve_phase(model) -> tuple[dict, dict]:
    """Orpheus serving through ContinuousTTS (fused tick) on the card;
    returns its results and the launch counts of its main run."""
    import numpy as np
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_llama as FL
    from tpu_audio_torch.parallel.continuous import ContinuousBatcher

    group = max(n for n in range(1, FL.MAX_LANES + 1) if FL.supported_lanes(model.config, n))
    spg = 4 * model.codec.config.hop_length  # samples of a 7-token frame
    plain_calls, steps = [0], [0, 0]  # steps, expected kernel-6 launches
    refs = (FL.fused_llama_stack_ref, FL.fused_llama_stack_lanes_ref)

    def counted(fn):
        def call(*a, **k):
            plain_calls[0] += 1
            return fn(*a, **k)
        return call

    one_step = ContinuousBatcher._one_step

    def counted_step(self, lanes, live, sub, step):
        steps[0] += 1
        steps[1] += -(-len(live) // group)
        return one_step(self, lanes, live, sub, step)

    flushes = []
    FL.fused_llama_stack_ref, FL.fused_llama_stack_lanes_ref = map(counted, refs)
    ContinuousBatcher._one_step = counted_step
    try:
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served, audio = tts_serve_staggered(model, flushes=flushes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
    finally:
        FL.fused_llama_stack_ref, FL.fused_llama_stack_lanes_ref = refs
        ContinuousBatcher._one_step = one_step
    n_tok = sum(len(t) for t in served)
    print(f"[tts serve] {len(served)} requests, {TTS_SERVE_SLOTS} slots, max_tokens "
          f"{TTS_SERVE_MAX_TOKENS}: {n_tok} tokens in {wall:.3f} s ({steps[0]} decode steps), "
          f"every tick without a host sync; launches {launches}, plain version calls "
          f"{plain_calls[0]}; SNAC flushes held the engine thread {sum(flushes):.3f} s "
          f"({len(flushes)} flushes, longest {max(flushes) * 1e3:.3f} ms); samples by "
          f"request {[a.shape[0] for a in audio]}")
    check(launches.get("fused_llama_stack_lanes", 0) == steps[1],
          f"fused_llama_stack_lanes launched {launches.get('fused_llama_stack_lanes', 0)} "
          f"times for {steps[0]} steps ({steps[1]} lane groups)")
    check(launches.get("fused_llama_stack", 0) == 0, "kernel 5 ran in the serving ticks")
    check(plain_calls[0] == 0, "a plain version ran on the serving path")
    T = model.tokens
    for toks, wav in zip(served, audio):
        frames = len(model.parse_output(toks)) // 7
        check(len(toks) > 0 and all(T.audio_token_offset <= t < T.audio_token_offset
                                    + 7 * T.codebook_size for t in toks),
              "a served request has no tokens or one outside the audio band")
        check(wav.shape == (frames * spg,) and frames > 0 and bool(np.isfinite(wav).all())
              and float(np.abs(wav).max()) > 0, f"served audio {wav.shape} for {frames} frames")

    def alone_equal():
        same = []
        for i, (text, want) in enumerate(zip(TTS_SERVE_TEXTS, served)):
            srv = tts_server(model)
            r = srv.submit(text, seed=i)
            for _ in srv.engine.run():
                pass
            same.append(list(r.tokens) == want)
        return same

    alone = alone_equal()
    print(f"[tts serve] each request alone in a fresh engine gives the same tokens: "
          f"{alone} ({len({t for toks in served for t in toks})} distinct tokens served)")
    check(all(alone), "served tokens depend on the other requests")
    cancelled, _ = tts_serve_staggered(model, cancel=1)
    kept = [i for i in range(len(served)) if i != 1]
    same = all(cancelled[i] == served[i] for i in kept)
    print(f"[tts serve] request 1 cancelled after two ticks ({len(cancelled[1])} tokens "
          f"kept); the others' tokens unchanged: {same}")
    check(same, "a cancel changed another request's tokens")
    check(len(cancelled[1]) < len(served[1]), "the cancelled request ran to its end")
    forced = tts_serve_teacher_forced(model, served)
    gp_kw = dict(max_tokens=TTS_SERVE_MAX_TOKENS, temperature=0.0, repetition_penalty=1.3,
                 repetition_context_size=20)
    from tpu_audio_torch.core.generation import AudioGenerateParameters

    offline = []
    for text, want in zip(TTS_SERVE_TEXTS[:2], served):
        run = list(model._run_generation(text, None, None, None,
                                         AudioGenerateParameters(**gp_kw),
                                         TTS_SERVE_MAX_TOKENS))[-1]
        _, _, (_, _, plen, toks) = run
        offline.append(toks[plen:] == want)
    print(f"[tts serve] served tokens equal LlamaTTS generate's (kernel 5) for the first two "
          f"requests (printed, not checked): {offline}")
    return dict(requests=len(served), tokens=n_tok, wall_s=wall, steps=steps[0],
                alone_equal=all(alone), cancel_ok=same, teacher_forced_rel_err=forced,
                snac_flush_s=sum(flushes), snac_flushes=len(flushes),
                snac_flush_max_ms=max(flushes) * 1e3, equal_to_generate=offline), launches


def tts_serve_teacher_forced(model, served) -> float:
    """The first TTS_TEACHER_STEPS served tokens of two requests forced
    through the serving step (``_fused_lane_hooks``' batch_step_fn) from one
    prefill, with kernel 6 (its codes tapped) and with its plain version fed
    the kernel's codes and scales: band logits within FORCED_RTOL, every
    kernel code the plain rounding of the same inputs up to boundary flips."""
    import numpy as np
    import torch

    from tpu_audio_torch.ops import fused_llama as FL

    cfg, dev = model.config, model.device
    hooks = model._fused_lane_hooks(TTS_SERVE_MAX_TOKENS + 65)
    kernel, taps = FL.fused_llama_stack_lanes, {}

    def tapped(*a, **k):
        taps["k"] = llama_taps(cfg, dev, False, a[4].shape[0])
        return kernel(*a, **k, tap=taps["k"])

    def forced(*a, **k):
        taps["f"] = llama_taps(cfg, dev, True, a[4].shape[0])
        return FL.fused_llama_stack_lanes_ref(*a, **k, tap=taps["f"], codes=taps["k"])

    cache = hooks["cache_factory"](2)
    prompts = [model.prepare_input_ids(t) for t in TTS_SERVE_TEXTS[:2]]
    offsets = []
    with torch.inference_mode():
        for slot, prompt in enumerate(prompts):
            pad = 64 - len(prompt)
            ids = np.full((64,), model.tokens.pad_token, np.int32)
            ids[pad:] = prompt
            offsets.append(hooks["prefill_fn"](hooks["params"], cache, slot, ids[:-1], pad, None))
        caches = {m: cache._replace(k=cache.k.clone(), v=cache.v.clone())
                  for m in ("kernel", "forced")}
        lanes = torch.tensor([0, 1], device=dev)
        worst = 0.0
        try:
            for t in range(TTS_TEACHER_STEPS):
                last = torch.tensor([prompts[m][-1] if t == 0 else served[m][t - 1]
                                     for m in range(2)], device=dev)
                offs = torch.tensor([o + t for o in offsets], device=dev)
                logits = {}
                for mode, fn in (("kernel", tapped), ("forced", forced)):
                    FL.fused_llama_stack_lanes = fn
                    logits[mode] = hooks["batch_step_fn"](hooks["params"], caches[mode], lanes,
                                                          last, offs, None)
                check(bool(torch.isfinite(logits["kernel"]).all()), "serving step logits")
                for m in range(2):
                    check_witness(f"tts serve teacher-forced step {t} lane {m}", *codes_witness(
                        cfg, tuple(x[:, :, m] for x in taps["k"]),
                        tuple(x[:, :, m] for x in taps["f"])))
                worst = max(worst, rel_err(logits["kernel"], logits["forced"]))
        finally:
            FL.fused_llama_stack_lanes = kernel
    print(f"[tts serve teacher-forced] 2 lanes x {TTS_TEACHER_STEPS} steps: band logits vs "
          f"the plain lanes version fed the kernel's codes {worst:.3e} (rtol {FORCED_RTOL})")
    check(worst <= FORCED_RTOL, "serving step logits disagree with the plain version")
    return worst


def tts_throughput_phase(model) -> list[dict]:
    """bench.py's bench_serving_throughput(fused=True) protocol on the band
    head model: prompts of 60 tokens in bucket 64, step_tokens 16, T 0.6,
    top-p 0.9, top-k 512, 2 warm ticks then 6 timed ones, every lane live;
    at each of TTS_THROUGHPUT_SLOTS, with slots=1 the single stream; then
    the device busy share and per-kernel breakdown of one profiled tick."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.sampling import SamplingParams
    from tpu_audio_torch.parallel.continuous import ContinuousBatcher

    step_tokens, ticks = 16, 6
    max_new = step_tokens * (ticks + 2)
    max_len = 64 + max_new + step_tokens + 2
    rng = np.random.default_rng(0)

    def engine(slots):
        hooks = model._fused_lane_hooks(max_len)
        eng = ContinuousBatcher(
            hooks.pop("params"), model.config, slots=slots, stop_token=-1,
            sampling=SamplingParams(temperature=0.6, top_p=0.9, top_k=512), max_len=max_len,
            prefill_buckets=(64,), seed=0, step_tokens=step_tokens, **hooks)
        for s in range(slots):
            eng.submit(rng.integers(100, 4000, size=60).astype(np.int32), max_new=max_new,
                       seed=s)
        eng.step()  # admits every lane
        eng.step()
        torch.cuda.synchronize()
        return eng

    rows, solo = [], None
    for slots in TTS_THROUGHPUT_SLOTS:
        eng = engine(slots)
        t0 = time.perf_counter()
        emitted = sum(len(eng.step()) for _ in range(ticks))
        tick = (time.perf_counter() - t0) / ticks
        check(emitted == slots * step_tokens * ticks, f"{emitted} tokens in the timed ticks")
        tok_s = slots * step_tokens / tick
        solo = tok_s if slots == 1 else solo
        # kernel 6 alone launches this many a tick; a profile that records
        # fewer dropped events (device_ms) and is taken again after a longer
        # wait on the host (STACK_READS)
        want = step_tokens * LLAMA_LANES_LAYER_LAUNCHES * model.config.num_hidden_layers
        for lead, _ in STACK_READS[:3]:
            eng = engine(slots)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(lead)
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy_us, n_ev = device_busy(prof)
            if n_ev >= want:
                break
            del eng
        else:
            fail(f"tts serve throughput slots={slots}: the profiled tick recorded {n_ev} "
                 f"device events, fewer than kernel 6's {want}, three times")
        kernels = by_kernel(prof)
        del eng
        row = dict(slots=slots, step_tokens=step_tokens, aggregate_tok_s=tok_s,
                   single_stream_tok_s=solo, ms_per_tick=tick * 1e3,
                   busy_share=busy_us / wall_us, device_ms_per_step=busy_us / 1e3 / step_tokens,
                   device_events_per_step=n_ev / step_tokens)
        print(f"[tts serve throughput slots={slots}] aggregate {tok_s:.1f} tok/s (single "
              f"stream {solo:.1f}); {tick * 1e3:.3f} ms a tick of {step_tokens} steps; one "
              f"profiled tick: device busy {busy_us / 1e3:.3f} of {wall_us / 1e3:.3f} ms "
              f"(share {busy_us / wall_us:.4f}), {n_ev / step_tokens:.1f} device events a step")
        print_kernels(kernels, step_tokens, top=10)
        rows.append(row)
    return rows


def tts_http_phase(model) -> dict:
    """HTTP_REQUESTS concurrent speech POSTs, one of them to /stream,
    through cli.serve.build_server(model, "tts", slots=TTS_SERVE_SLOTS):
    each returns 200 and audio of whole 7-token frames."""
    import numpy as np

    from tpu_audio_torch.cli.serve import build_server
    from tpu_audio_torch.core.generation import AudioGenerateParameters

    gp = AudioGenerateParameters(max_tokens=TTS_HTTP_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    server = build_server(model, "tts", "orpheus-3b-random", port=0, slots=TTS_SERVE_SLOTS,
                          generation_parameters=gp)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    routes = ["/v1/audio/speech"] * (HTTP_REQUESTS - 1) + ["/v1/audio/speech/stream"]
    results: dict = {}
    try:
        def post(i):
            req = urllib.request.Request(url + routes[i], data=json.dumps(
                {"input": TTS_SERVE_TEXTS[i], "seed": i}).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, r.headers["Content-Type"], r.read())

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(HTTP_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "an HTTP request did not return")
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(sorted(results) == list(range(HTTP_REQUESTS)), "missing HTTP responses")
    spg = 4 * model.codec.config.hop_length
    samples = []
    for i in range(HTTP_REQUESTS):
        status, ctype, data = results[i]
        if routes[i].endswith("/stream"):
            check(ctype == f"audio/L16; rate={model.sample_rate}", f"stream type {ctype}")
            pcm = np.frombuffer(data, "<i2")
        else:
            with wave.open(io.BytesIO(data)) as w:
                check(w.getframerate() == model.sample_rate, "WAV rate")
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        samples.append(int(pcm.shape[0]))
        check(status == 200 and pcm.shape[0] > 0 and pcm.shape[0] % spg == 0
              and int(np.abs(pcm).max()) > 0,
              f"speech response {i}: status {status}, {pcm.shape[0]} samples")
    print(f"[tts http] {HTTP_REQUESTS} concurrent speech POSTs ({routes.count(routes[-1])} "
          f"to /stream) in {wall:.3f} s: status {[results[i][0] for i in range(HTTP_REQUESTS)]}, "
          f"samples {samples} (whole {spg}-sample frames)")
    return dict(requests=HTTP_REQUESTS, wall_s=wall, samples=samples)


# -- MLX grouped-affine 4/8-bit: kernel 7 and Orpheus-3B 4-bit ----------------------


def qmm_bound(rows: int, o: int, i: int, bits: int, group_size: int,
              scale_bytes: int = 4, x_bytes: int = 4) -> tuple[float, str]:
    """Kernel 7's least time: the words, scales and biases, x and y once;
    and the operations of its route. One row (the GEMV): a multiply-add a
    weight in f32. More rows (the tile): bf16 tensor-core products, two a
    weight and row for f32 or f16 x (split into bf16 hi and lo parts), one
    for bf16 x."""
    nb = o * i * bits / 8 + 2 * o * (i // group_size) * scale_bytes + x_bytes * rows * (i + o)
    if rows == 1:
        return bound(nb, f32_ops=2 * o * i)
    return bound(nb, bf16_ops=(2 if x_bytes == 2 else 4) * rows * o * i)


def qmm_inputs(o: int, i: int, rows: int, bits: int, group_size: int, gen, dev,
               scale_dtype=None, x_dtype=None):
    """N(0, 0.02) weights quantized on the card (f32 scales and biases, or
    cast to ``scale_dtype``) and N(0, 1) rows of x."""
    import torch

    from tpu_audio_torch.core import quant

    words, s, b = quant.quantize_mlx(
        torch.randn((o, i), generator=gen, device=dev) * 0.02, group_size, bits)
    if scale_dtype is not None:
        s, b = s.to(scale_dtype), b.to(scale_dtype)
    x = torch.randn((rows, i), generator=gen, device=dev).to(x_dtype or torch.float32)
    return x, words, s, b


def qmm_check(name: str, x, words, s, b, group_size: int, bits: int,
              launch=None) -> tuple[float, bool, str]:
    """Kernel 7 (``quantized_matvec``, or ``launch``: ``qmm.gemv``,
    ``qmm.decode`` or ``qmm.tile``) against its plain version on the same
    inputs, relative to the largest output: QMM_RTOL in f32; for bf16 x (a
    bf16 result) one bf16 unit of the largest output, QMM_BF16_RTOL, and
    for f16 x one f16 unit, QMM_F16_RTOL. Returns the error, x's dtype and
    the kernel that ran ("decode", "tile" or "gemv", from the launch
    counters)."""
    import torch

    from tpu_audio_torch.ops import _lib, qmm

    before = dict(_lib.launches)
    got = (launch or qmm.quantized_matvec)(x, words, s, b, group_size, bits)
    ran = next((r for r in ("decode", "tile") if _lib.launches[f"quantized_matvec_{r}"]
                > before.get(f"quantized_matvec_{r}", 0)), "gemv")
    want = qmm.quantized_matvec_ref(x, words, s, b, group_size, bits)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    tol = {torch.bfloat16: QMM_BF16_RTOL, torch.float16: QMM_F16_RTOL}.get(x.dtype, QMM_RTOL)
    check(got.shape == want.shape and got.dtype == x.dtype and bool(torch.isfinite(got).all()),
          f"{name}: output {tuple(got.shape)} {got.dtype}")
    check(err <= tol, f"{name} ({ran}): kernel 7 disagrees with its plain version: {err:.3e} "
          f"(rtol {tol})")
    return err, x.dtype, ran


def int4pack_library(x, words, s, b, group_size: int):
    """``torch._weight_int4pack_mm`` on the same 4-bit weights (bf16 x; the
    codes repacked at load with ``_convert_weight_to_int4pack``, rows padded
    to a multiple of 8, zeros = biases + 8 * scales, since the library
    dequantizes (q - 8) * scale + zero): a function of the bf16 inputs
    returning ``[rows, O]`` bf16. None and the error where this torch does
    not run it."""
    import torch

    from tpu_audio_torch.core import quant

    try:
        o, i = words.shape[0], words.shape[1] * 8
        pad = -o % 8
        codes = quant._unpack(words, 4)
        codes = torch.cat([codes, codes.new_zeros((pad, i))])
        packed = torch._convert_weight_to_int4pack(
            (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([torch.cat([s, s.new_zeros((pad, s.shape[1]))]),
                          torch.cat([b + 8 * s, b.new_zeros((pad, b.shape[1]))])], -1)
        sz = sz.transpose(0, 1).contiguous().to(torch.bfloat16)
        xb = x.to(torch.bfloat16)

        def call():
            return torch._weight_int4pack_mm(xb, packed, group_size, sz)

        out = call()[:, :o]
        torch.cuda.synchronize()
        return call, out, None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def qmm_copies(words, s, b) -> list:
    """The packed weight and enough copies of it that calls cycling through
    them find each one's weights outside the L2 (QMM_COLD_BYTES in all), as
    the path's 28 layers do: at least one."""
    n = max(1, math.ceil(QMM_COLD_BYTES / nbytes(words, s, b)))
    return [(words, s, b)] + [(words.clone(), s.clone(), b.clone()) for _ in range(n - 1)]


def cycling(fns) -> callable:
    """A call of the next of ``fns`` each time (round robin)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def qmm_timed(x, copies, group_size: int, bits: int, launch) -> dict:
    """Per call (CUDA events) and device time (profiler) of ``launch`` on x
    and the weights ``copies``, each call on the next copy."""
    fn = cycling([functools.partial(launch, x, *c, group_size, bits) for c in copies])
    return dict(ms=cuda_ms(fn), dev_ms=device_ms(fn, launches=1))


def qmm_phase(dev, timing: bool = True) -> dict:
    """Phase 15: kernel 7 against its plain version at every GEMV shape of
    the Orpheus-3B 4-bit path (QMM_SHAPES), at 1 row (the decode kernel)
    and 63 (the tile), 4 and 8 bits, group size 64, f32 and bf16 scales;
    every row count 2-64 the tile takes, at the o projection's shape; then
    groups of 32 and 128, 2 bits, bf16 x and odd row counts at the o
    projection's shape; the decode kernel at bits 2/4/8 x groups
    32/64/128 at the o and down shapes, with bf16 and f16 x, and at the q4
    Whisper step's shapes (QMM_WHISPER_SHAPES); the GEMV at 1 and 63 rows,
    and rows that are not 16-byte aligned (the GEMV). With ``timing``, each
    call on weights outside the L2 (``qmm_copies``): kernel, plain and
    library times a call (CUDA events) and as device time, at 4 bits, g 64,
    f32 scales, the path's configuration, at 1 row (the decode kernel, and
    the GEMV beside it) and 63 rows; the tile and its plain version at 63
    rows and 8 bits; the tile and the GEMV at QMM_CROSSOVER_ROWS rows at
    the o and down shapes. Returns kernel 7's two records: the decode
    kernel's with a decode step's sum (the layers' GEMVs times 28 and the
    band head, at 1 row), and the tile's with a prefill's (the layers'
    GEMVs times 28, at 63 rows)."""
    import torch

    from tpu_audio_torch.ops import qmm

    gen = torch.Generator(device=dev).manual_seed(15)
    errs = []
    with torch.inference_mode():
        for name, (o, i) in QMM_SHAPES.items():
            for bits in (4, 8):
                for sdt in (torch.float32, torch.bfloat16):
                    for rows in (1, 63):
                        x, words, s, b = qmm_inputs(o, i, rows, bits, 64, gen, dev, sdt)
                        errs.append(qmm_check(f"qmm {name} [{rows},{i}]x[{o},{i}] bits "
                                              f"{bits} scales {sdt}", x, words, s, b, 64, bits))
                        del x, words, s, b
        o, i = QMM_SHAPES["o"]
        extra = [(rows, 4, 64, torch.float32, torch.float32) for rows in range(2, 65)]
        extra += [(rows, bits, g, xdt, sdt)
                  for rows, bits, g in ((1, 4, 32), (63, 4, 32), (1, 4, 128), (63, 4, 128),
                                        (5, 2, 32), (9, 2, 64), (17, 8, 128))
                  for xdt, sdt in ((torch.float32, torch.float16),)]
        extra += [(rows, 4, 64, torch.bfloat16, torch.bfloat16) for rows in (2, 3, 33, 64)]
        extra += [(rows, 8, 64, torch.float32, torch.float32) for rows in (7, 13, 40)]
        for rows, bits, g, xdt, sdt in extra:
            x, words, s, b = qmm_inputs(o, i, rows, bits, g, gen, dev, sdt, xdt)
            errs.append(qmm_check(f"qmm o [{rows},{i}] bits {bits} g {g} x {xdt} scales {sdt}",
                                  x, words, s, b, g, bits))
        # the decode kernel (1 row): every bits x group size at the o and
        # down shapes, bf16 and f16 x, and the q4 Whisper step's shapes
        ones = [(name, bits, g, torch.float32) for name in ("o", "down")
                for bits in (2, 4, 8) for g in (32, 64, 128)]
        ones += [(name, 4, 64, xdt) for name in ("o", "down")
                 for xdt in (torch.bfloat16, torch.float16)]
        for name, bits, g, xdt in ones:
            o, i = QMM_SHAPES[name]
            x, words, s, b = qmm_inputs(o, i, 1, bits, g, gen, dev, xdt, xdt)
            errs.append(qmm_check(f"qmm {name} [1,{i}]x[{o},{i}] bits {bits} g {g} x {xdt}",
                                  x, words, s, b, g, bits))
        for name, (o, i) in QMM_WHISPER_SHAPES.items():
            for xdt in (torch.float32, torch.bfloat16):
                x, words, s, b = qmm_inputs(o, i, 1, 4, 64, gen, dev, xdt, xdt)
                errs.append(qmm_check(f"qmm whisper {name} [1,{i}]x[{o},{i}] x {xdt}",
                                      x, words, s, b, 64, 4))
        # the GEMV at 1 row (which the route now sends to the decode kernel
        # where the rows are whole chunks) and its passes of 8 rows (and 4
        # at 8,192 features), which it sends only rows that are not
        for name in ("o", "down"):
            o, i = QMM_SHAPES[name]
            for rows in (1, 63):
                x, words, s, b = qmm_inputs(o, i, rows, 4, 64, gen, dev)
                errs.append(qmm_check(f"qmm {name} [{rows},{i}]x[{o},{i}] the GEMV", x, words,
                                      s, b, 64, 4, launch=qmm.gemv))
        # rows of 6 words are not 16-byte aligned: the GEMV, one word at a time
        x, words, s, b = qmm_inputs(333, 96, 3, 2, 32, gen, dev)
        errs.append(qmm_check("qmm [3,96]x[333,96] bits 2 g 32 (unaligned rows)",
                              x, words, s, b, 32, 2))
        recs, summary = {}, {}
        for ran in ("decode", "gemv", "tile"):
            by = {dt: [e for e, xdt, r in errs if r == ran and xdt == dt]
                  for dt in (torch.float32, torch.bfloat16, torch.float16)}
            f32, bf16, f16 = by.values()
            n = sum(r == ran for _, _, r in errs)
            check(bool(f32), f"phase 15 did not check kernel 7's {ran} with f32 x")
            print(f"[qmm] {ran}: {n} checks against the plain version: rel err up to "
                  f"{max(f32):.3e} with f32 x (rtol {QMM_RTOL}), "
                  + (f"{max(bf16):.3e} with bf16 x (rtol {QMM_BF16_RTOL})" if bf16
                     else "no bf16 x")
                  + (f", {max(f16):.3e} with f16 x (rtol {QMM_F16_RTOL})" if f16 else ""))
            summary[ran] = dict(checks=n, rel_err=max(f32),
                                rel_err_bf16_x=max(bf16) if bf16 else None,
                                **({"rel_err_f16_x": max(f16)} if f16 else {}))
        for kernel, ran, fn in (("quantized_matvec", "decode", "quantized_matvec_decode_kernel"),
                                ("quantized_matvec_tile", "tile", "quantized_matvec_tile_kernel")):
            recs[kernel] = dict(route="cuda", source="tpu_audio_torch/csrc/qmm.cu", kernel=fn,
                                replaces="tpu_audio/ops/pallas_qmm.py:100", **summary[ran])
        recs["quantized_matvec"].update({f"gemv_{k}": v for k, v in summary["gemv"].items()})
        if not timing:
            return recs
        shapes, eight, cross, lib_errs, lib_why = [], [], [], [], None
        for name, (o, i) in QMM_SHAPES.items():
            for rows in (1, 63):
                x, words, s, b = qmm_inputs(o, i, rows, 4, 64, gen, dev)
                want = qmm.quantized_matvec_ref(x, words, s, b, 64, 4)
                err = float((qmm.quantized_matvec(x, words, s, b, 64, 4) - want).abs().max())
                b_ms, b_by = qmm_bound(rows, o, i, 4, 64)
                copies = qmm_copies(words, s, b)
                k = qmm_timed(x, copies, 64, 4, qmm.quantized_matvec)
                p = cycling([functools.partial(qmm.quantized_matvec_ref, x, *c, 64, 4)
                             for c in copies])
                row = dict(shape=name, rows=rows, o=o, i=i, bits=4, copies=len(copies),
                           kernel=qmm.route(rows, i, 4, True), bound_ms=b_ms,
                           bound_by=b_by, max_abs_err=err, ms=k["ms"],
                           plain_ms=cuda_ms(p, reps=5, warmup=1), dev_ms=k["dev_ms"],
                           plain_dev_ms=device_ms(p, reps=3))
                if rows == 1:  # the GEMV the decode kernel took over from, in this call
                    g = qmm_timed(x, copies, 64, 4, qmm.gemv)
                    row.update(gemv_ms=g["ms"], gemv_dev_ms=g["dev_ms"])
                calls = [int4pack_library(x, *c, 64) for c in copies]
                call, lib_out, why = calls[0]
                if call is None:
                    lib_why = why
                    row.update(library_ms=None, library_dev_ms=None, library_rel_err=None)
                else:
                    lib = cycling([c[0] for c in calls])
                    lib_errs.append(rel_err(lib_out, want))
                    row.update(library_ms=cuda_ms(lib), library_dev_ms=device_ms(lib),
                               library_rel_err=lib_errs[-1])
                del calls
                shapes.append(row)
                print(f"[time] qmm {name} [{rows},{i}]x[{o},{i}] 4-bit g 64 ({row['kernel']}, "
                      f"{len(copies)} weight copies): per call kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, library {fmt(row['library_ms'])}; device "
                      f"kernel {fmt(row['dev_ms'])}, plain {fmt(row['plain_dev_ms'])}, library "
                      f"{fmt(row['library_dev_ms'])}; bound {b_ms:.4f} ms ({b_by})"
                      + (f"; the GEMV: device {fmt(row['gemv_dev_ms'])}, per call "
                         f"{row['gemv_ms']:.4f} ms" if rows == 1 else "")
                      + (f"; library rel err {row['library_rel_err']:.3e}"
                         if row["library_rel_err"] is not None else f"; library: {why}"))
                del x, words, s, b, want, copies
        for name, (o, i) in QMM_SHAPES.items():
            x, words, s, b = qmm_inputs(o, i, 63, 8, 64, gen, dev)
            b_ms, b_by = qmm_bound(63, o, i, 8, 64)
            copies = qmm_copies(words, s, b)
            k = qmm_timed(x, copies, 64, 8, qmm.quantized_matvec)
            p = cycling([functools.partial(qmm.quantized_matvec_ref, x, *c, 64, 8)
                         for c in copies])
            row = dict(shape=name, rows=63, o=o, i=i, bits=8, copies=len(copies),
                       bound_ms=b_ms, bound_by=b_by, ms=k["ms"], dev_ms=k["dev_ms"],
                       plain_ms=cuda_ms(p, reps=5, warmup=1),
                       plain_dev_ms=device_ms(p, reps=3), library_ms=None)
            eight.append(row)
            print(f"[time] qmm {name} [63,{i}]x[{o},{i}] 8-bit g 64 (tile, {len(copies)} weight "
                  f"copies): per call kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
                  f"device kernel {fmt(row['dev_ms'])}, plain {fmt(row['plain_dev_ms'])}; bound "
                  f"{b_ms:.4f} ms ({b_by}); library: none at 8 bits")
            del x, words, s, b, copies
        for name in ("o", "down"):
            o, i = QMM_SHAPES[name]
            for rows in QMM_CROSSOVER_ROWS:
                x, words, s, b = qmm_inputs(o, i, rows, 4, 64, gen, dev)
                copies = qmm_copies(words, s, b)
                t, g = (qmm_timed(x, copies, 64, 4, fn) for fn in (qmm.tile, qmm.gemv))
                cross.append(dict(shape=name, rows=rows, tile_ms=t["ms"], tile_dev_ms=t["dev_ms"],
                                  gemv_ms=g["ms"], gemv_dev_ms=g["dev_ms"],
                                  bound_ms=qmm_bound(rows, o, i, 4, 64)[0]))
                print(f"[time] qmm crossover {name} [{rows},{i}]x[{o},{i}] 4-bit g 64: device "
                      f"tile {fmt(t['dev_ms'])}, GEMV {fmt(g['dev_ms'])}; per call tile "
                      f"{t['ms']:.4f} ms, GEMV {g['ms']:.4f} ms")
                del x, words, s, b, copies
    L = ORPHEUS["num_hidden_layers"]
    layers = ("q/k/v", "o", "gate/up", "down")

    def total(rows, field, heads=()):  # 28 x the layers' four GEMVs, and heads once
        sel = [r for r in shapes if r["rows"] == rows and (r["shape"] in layers + heads)]
        if any(r[field] is None for r in sel):
            return None
        return sum(r[field] * (L if r["shape"] in layers else 1) for r in sel)

    for kernel, rows, heads, by in (("quantized_matvec", 1, ("band head",), "bytes"),
                                    ("quantized_matvec_tile", 63, (), "operations")):
        recs[kernel].update(
            {f: total(rows, f, heads) for f in ("ms", "plain_ms", "dev_ms", "plain_dev_ms",
                                                "bound_ms", "library_ms", "library_dev_ms")
             + (("gemv_ms", "gemv_dev_ms") if rows == 1 else ())},
            bound_by=by, library_rel_err=max(lib_errs) if lib_errs else None,
            library_error=lib_why,
            max_abs_err=max(r["max_abs_err"] for r in shapes if r["rows"] == rows),
            by_shape=[r for r in shapes if r["rows"] == rows])
    recs["quantized_matvec_tile"].update(by_shape_8bit=eight, crossover=cross)
    step, pre = recs["quantized_matvec"], recs["quantized_matvec_tile"]
    print(f"[time] quantized_matvec (the decode kernel), a decode step's {4 * L + 1} GEMVs "
          f"(4-bit, g 64, 1 row): per call kernel {step['ms']:.4f} ms, GEMV "
          f"{step['gemv_ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, library "
          f"{fmt(step['library_ms'])}; device kernel {fmt(step['dev_ms'])}, GEMV "
          f"{fmt(step['gemv_dev_ms'])}, plain {fmt(step['plain_dev_ms'])}, library "
          f"{fmt(step['library_dev_ms'])}; bound {step['bound_ms']:.4f} ms (bytes)")
    print(f"[time] quantized_matvec_tile, a prefill's {4 * L} GEMVs (4-bit, g 64, 63 rows): per "
          f"call kernel {pre['ms']:.4f} ms, plain {pre['plain_ms']:.4f} ms, library "
          f"{fmt(pre['library_ms'])}; device kernel {fmt(pre['dev_ms'])}, plain "
          f"{fmt(pre['plain_dev_ms'])}, library {fmt(pre['library_dev_ms'])}; bound "
          f"{pre['bound_ms']:.4f} ms (operations)")
    return recs


def build_orpheus_q4(dev):
    """Orpheus-3B with seed-0 random weights quantized on the card to MLX
    4-bit in groups of 64 (``quantize_tree(bits=4, group_size=64)``, every
    projection and the embedding), q/k/v and gate/up fused, seeded non-unit
    norms: the band-head model and a full-head model over the same
    tensors, both with the SNAC 24 kHz codec."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.tts import llama_tts as TT

    cfg = TT.LlamaTTSConfig(**ORPHEUS)
    params = llama.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                                      on_device=True)
    randomize_norms(params, torch.Generator(device=dev).manual_seed(3))
    params = llama.fuse_projections(quant.quantize_tree(params, bits=4, group_size=64,
                                                        scheme="mlx"))
    qkv = params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"]
    check(isinstance(qkv, quant.QuantizedTensor) and isinstance(
        params["model"]["embed_tokens"]["weight"], quant.QuantizedTensor),
        "Orpheus 4-bit: the projections or the embedding are not packed")
    codec = build_snac(dev)
    band = TT.LlamaTTS(cfg, params, tokenizer=ByteTokenizer(), codec=codec,
                       dtype=torch.bfloat16, audio_band_head=True)
    full = TT.LlamaTTS(cfg, params, tokenizer=ByteTokenizer(), codec=codec,
                       dtype=torch.bfloat16)
    check(not TT._fused_route(band.params, cfg, band.device), "a 4-bit tree took the fused route")
    return band, full


@contextlib.contextmanager
def counting(module, name: str, counter: list):
    """Count the calls of ``module.name`` (one slot of ``counter``)."""
    fn = getattr(module, name)

    def call(*a, **k):
        counter[0] += 1
        return fn(*a, **k)

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


def q4_generate_phase(model, full) -> tuple[list, dict, list]:
    """Phase 16's offline runs: ``generate`` twice (greedy, TTS_TOKENS
    tokens, identical tokens and waveforms) and ``generate_stream``, each
    with the launch counters reset just before and read just after: kernel
    7's tile launched 4 x 28 times for the prefill and its decode kernel 4 x
    28 + 1 times for each decode step the loop took, no launch of the GEMV
    or of kernels 5 or 6 and no call of the plain version; then a short run
    of the full-head model, whose head covers all 156,940 rows, on the same
    counts (and one more launch for the prefill's logits), through
    ``_run_generation``: its greedy tokens need not be audio codes."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind
    from tpu_audio_torch.ops import _lib, qmm

    L = model.config.num_hidden_layers
    T = model.tokens
    hop = model.codec.config.hop_length
    plain = [0]
    runs, first, launches = [], None, {}
    for run, (m, n, stream) in enumerate([(model, TTS_TOKENS, False), (model, TTS_TOKENS, False),
                                          (model, TTS_TOKENS, True), (full, Q4_FULL_TOKENS, False)]):
        gp = AudioGenerateParameters(max_tokens=n, temperature=0.0, repetition_penalty=1.3,
                                     repetition_context_size=20)
        steps, seen = [0], {}
        plain[0] = 0
        run_generation = m._run_generation

        def spy(*a, **k):
            for item in run_generation(*a, **k):
                seen["item"] = item
                yield item

        m._run_generation = spy
        m._decoders.clear()
        try:
            with counting(m, "_step_fn", steps), counting(qmm, "quantized_matvec_ref", plain):
                _lib.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if stream:
                    events = list(m.generate_stream(TTS_TEXT, generation_parameters=gp))
                    wav = np.concatenate([e.audio for e in events
                                          if e.kind == AudioGenerationKind.AUDIO])
                elif m is full:  # its greedy tokens need not be audio codes: no waveform
                    list(m._run_generation(TTS_TEXT, None, None, None, gp, n))
                    wav = np.zeros(0, np.float32)
                else:
                    wav = m.generate(TTS_TEXT, generation_parameters=gp)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(_lib.launches)
        finally:
            del m._run_generation
            m._decoders.clear()
        _, _, (pt, gt, plen, all_tokens) = seen["item"]
        toks = all_tokens[plen:]
        frames = len(m.parse_output(all_tokens)) // 7
        # the prefill's 63 rows through the tile (and the full head's logits
        # over them), each decode step's 1 row through the decode kernel
        want_tile = 4 * L + (m is full)
        want_decode = (4 * L + 1) * steps[0]
        n_tile = launches.get("quantized_matvec_tile", 0)
        n_decode = launches.get("quantized_matvec_decode", 0)
        n_gemv = launches.get("quantized_matvec", 0) - n_tile - n_decode
        label = "full head" if m is full else "generate_stream" if stream else "generate"
        print(f"[tts q4 {label} run {run}] {len(toks)} tokens ({steps[0]} decode steps taken) "
              f"in {wall:.3f} s (prefill {pt * 1e3:.3f} ms, decode "
              f"{gt * 1e3 / steps[0]:.4f} ms a step); {wav.shape[0]} samples ({frames} "
              f"frames); launches {launches}: tile {n_tile} ({want_tile} expected), decode "
              f"{n_decode} ({want_decode} expected), GEMV {n_gemv} (0 expected); plain "
              f"version calls {plain[0]}")
        check(n_tile == want_tile and n_decode == want_decode and n_gemv == 0,
              f"kernel 7 launched the tile {n_tile}, the decode kernel {n_decode} and the "
              f"GEMV {n_gemv} times, {want_tile}, {want_decode} and 0 expected for "
              f"{steps[0]} decode steps")
        check(not any(launches.get(k, 0) for k in ("fused_llama_stack",
                                                   "fused_llama_stack_lanes")),
              "a w8a8 kernel ran on the 4-bit path")
        check(plain[0] == 0, "the plain version ran on the 4-bit path")
        check(len(toks) == n or steps[0] >= len(toks), f"{len(toks)} tokens in {steps[0]} steps")
        if m is full:
            runs.append(dict(api="generate (full head)", run=run, tokens=len(toks),
                             wall_s=wall, prefill_s=pt, decode_ms_per_step=gt * 1e3 / steps[0]))
            continue
        check(bool(np.isfinite(wav).all()) and wav.shape == (frames * 4 * hop,),
              f"waveform {wav.shape} for {frames} frames")
        check(frames > 0 and all(T.audio_token_offset <= t < T.audio_token_offset
                                 + 7 * T.codebook_size for t in toks),
              "no frames, or a token outside the audio band")
        if first is None:
            first = (toks, wav, launches)
        check(toks == first[0], "greedy tokens differ between runs")
        check(np.array_equal(wav, first[1]) if not stream else wav.shape == first[1].shape,
              "waveform differs between runs")
        runs.append(dict(api="generate_stream" if stream else "generate", run=run,
                         tokens=len(toks), steps_taken=steps[0], wall_s=wall, prefill_s=pt,
                         decode_ms_per_step=gt * 1e3 / steps[0], samples=int(wav.shape[0]),
                         realtime_x=wav.shape[0] / model.sample_rate / wall))
    print(f"first tokens: {first[0][:14]}")
    return runs, first[2], first[0]


def q4_prefill(model, prompt, max_tokens: int, valid_from: int | None = None):
    """``_run_generation``'s prefill on the plain route: the prompt
    left-padded to its bucket through ``llama.forward`` into a dense cache.
    Returns the cache and the last prompt token."""
    import numpy as np
    import torch

    from tpu_audio_torch.models import llama

    dev = model.device
    bucket = max(64, 1 << math.ceil(math.log2(max(len(prompt), 2))))
    pad = bucket - len(prompt)
    padded = np.full((1, bucket), model.tokens.pad_token, np.int64)
    padded[0, pad:] = prompt
    cache = llama.make_cache(model.config, 1, bucket + max_tokens + 1, model.dtype,
                             valid_from=pad if valid_from is None else valid_from, device=dev)
    _, cache = model._prefill(model.params, torch.from_numpy(padded[:, :-1]).to(dev), cache)
    return cache, torch.tensor([prompt[-1]], device=dev)


def q4_teacher_forced(model, tokens) -> float:
    """The first TTS_TEACHER_STEPS generated tokens forced through the
    decode step from one prefill, with kernel 7 and with its plain version,
    each on its own copy of the cache: band logits within Q4_LOGITS_RTOL."""
    import torch

    from tpu_audio_torch.ops import qmm

    prompt = model.prepare_input_ids(TTS_TEXT)
    worst = 0.0
    with torch.inference_mode():
        cache, last = q4_prefill(model, prompt, TTS_TOKENS)
        caches = {m: cache._replace(k=cache.k.clone(), v=cache.v.clone())
                  for m in ("kernel", "plain")}
        kernel = qmm.quantized_matvec
        for t in ([int(last[0])] + list(tokens))[:TTS_TEACHER_STEPS]:
            tok = torch.tensor([[t]], device=model.device)
            lk, caches["kernel"] = model._step_fn(model.params, tok, caches["kernel"])
            qmm.quantized_matvec = qmm.quantized_matvec_ref
            try:
                lp, caches["plain"] = model._step_fn(model.params, tok, caches["plain"])
            finally:
                qmm.quantized_matvec = kernel
            check(bool(torch.isfinite(lk).all()), "tts q4: non-finite logits")
            worst = max(worst, rel_err(lk, lp))
    print(f"[tts q4 teacher-forced] {TTS_TEACHER_STEPS} steps: band logits, kernel 7 vs its "
          f"plain version, rel err up to {worst:.3e} (rtol {Q4_LOGITS_RTOL})")
    check(worst <= Q4_LOGITS_RTOL, "tts q4: kernel path logits disagree with the plain route")
    return worst


def q4_ttfb_phase(model) -> dict:
    """bench.py's bench_tts_ttfb(quantize_bits=4) protocol on the band-head
    model: a 64-token prompt bucket, a TTFB_CHUNK-token chunk sampled at T
    0.6 and top-p 0.9 through ``llama.forward`` (kernel 7 for every
    projection and the head), then the SNAC decode of its 4 frames; the
    best of TTFB_REPEATS after a warm-up. Then ms a token (host clock, and
    device time), the busy share and a per-kernel breakdown of one
    Q4_PROFILE_TOKENS-token chunk, and the prefill's time alone."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.generation import AudioGenerateParameters

    gp = AudioGenerateParameters(temperature=0.6, top_p=0.9, repetition_penalty=1.0)
    prompt = [0] * (TTFB_BUCKET - 8) + list(range(100, 108))
    dec = model._get_decoder(gp)
    dev = model.device

    def state():
        return (torch.zeros((1, gp.repetition_context_size), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    def chunk(n, seed, max_tokens):
        cache, last = q4_prefill(model, prompt, max_tokens, valid_from=0)
        return dec(model.params, cache, last, torch.zeros((n,), dtype=torch.int64, device=dev),
                   torch.Generator(device=dev).manual_seed(seed), -1, *state())

    def first_audio(seed):
        toks = chunk(TTFB_CHUNK, seed, TTFB_CHUNK + 1)[0]
        f = toks.reshape(TTFB_CHUNK // 7, 7) % 4096
        wav = model.codec.decode([f[:, :1].reshape(1, -1), f[:, 1:3].reshape(1, -1),
                                  f[:, 3:7].reshape(1, -1)], seed=seed)
        return wav.float().cpu().numpy()

    with torch.inference_mode():
        wav = first_audio(0)
        times = []
        for r in range(TTFB_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first_audio(r + 1)
            times.append(time.perf_counter() - t0)
        check(wav.shape == (1, TTFB_CHUNK // 7 * 4 * model.codec.config.hop_length)
              and bool(np.isfinite(wav).all()), f"q4 ttfb waveform {wav.shape}")
        ttfb = min(times)
        audio_s = wav.size / model.sample_rate
        prefills = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q4_prefill(model, prompt, TTFB_CHUNK + 1, valid_from=0)
            torch.cuda.synchronize()
            prefills.append(time.perf_counter() - t0)
        n = Q4_PROFILE_TOKENS
        cache, last = q4_prefill(model, prompt, n + 1, valid_from=0)

        def args():
            return (model.params, cache._replace(k=cache.k.clone(), v=cache.v.clone()), last,
                    torch.zeros((n,), dtype=torch.int64, device=dev),
                    torch.Generator(device=dev).manual_seed(9), -1, *state())

        walls = []
        for _ in range(3):
            a = args()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec(*a)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        a = args()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dec(*a)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = by_kernel(prof)
    busy_ms = sum(c[1] for c in kernels.values()) / 1e3
    n_events = sum(c[0] for c in kernels.values())
    k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]  # decode kernel, tile
    k7_ms, k7_n = sum(c[1] for c in k7) / 1e3, sum(c[0] for c in k7)
    out = dict(ttfb_ms=ttfb * 1e3, ttfb_all_ms=[t * 1e3 for t in times],
               prefill_ms=min(prefills) * 1e3, first_audio_s=audio_s,
               realtime_x=audio_s / ttfb, ms_per_token=min(walls) * 1e3 / n,
               device_ms_per_token=busy_ms / n, kernel7_device_ms_per_token=k7_ms / n,
               kernel7_launches_per_token=k7_n / n, busy_share=busy_ms / prof_ms,
               device_events_per_token=n_events / n)
    print(f"[tts q4 ttfb] bucket {TTFB_BUCKET}, {TTFB_CHUNK}-token chunk (T 0.6, top-p 0.9) + "
          f"SNAC decode of {TTFB_CHUNK // 7} frames: TTFB {ttfb * 1e3:.3f} ms (best of "
          f"{[f'{t * 1e3:.3f}' for t in times]}), {audio_s:.4f} s of audio: realtime x "
          f"{audio_s / ttfb:.3f}; the 63-row prefill alone {min(prefills) * 1e3:.3f} ms")
    print(f"[tts q4 decode] {n}-token chunk: {min(walls) * 1e3 / n:.4f} ms a token (best of 3, "
          f"host clock); under the profiler wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(share {busy_ms / prof_ms:.4f}), {busy_ms / n:.4f} device ms a token of which kernel "
          f"7 {k7_ms / n:.4f} ({k7_n / n:.1f} launches a token); {n_events / n:.1f} device "
          f"events a token")
    print_kernels(kernels, n, top=14)
    return out


def q4_serve_phase(model) -> dict:
    """Phase 17's serving: Q4_SERVE_TEXTS staggered greedy requests through
    ``ContinuousTTS`` (the plain tick: each live lane's step through
    ``llama.forward``) at Q4_SERVE_SLOTS slots, with the counters reset just
    before and read just after: kernel 7's tile launched 4 x 28 times a
    prefill and its decode kernel 4 x 28 + 1 times a lane step, no other
    kernel of the port, no plain call; each request alone in a fresh engine
    gives the same tokens, and every request's audio is finite whole
    frames."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.ops import _lib, qmm
    from tpu_audio_torch.parallel.continuous import ContinuousTTS

    L = model.config.num_hidden_layers
    gp = AudioGenerateParameters(max_tokens=Q4_SERVE_MAX_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    spg = 4 * model.codec.config.hop_length
    prefills, steps, plain = [0], [0], [0]

    def serve(texts):
        srv = ContinuousTTS(model, slots=Q4_SERVE_SLOTS, generation_parameters=gp)
        check(not srv.fused, "a 4-bit tree took the fused tick")
        reqs = [srv.submit(t, seed=i) for i, t in enumerate(texts[:2])]
        audio = {}
        events = list(srv.step())
        reqs += [srv.submit(t, seed=i) for i, t in enumerate(texts[2:], 2)]
        events += list(srv.run())
        for rid, ev in events:
            if ev.audio is not None:
                audio.setdefault(rid, []).append(np.asarray(ev.audio))
        check(all(r.done for r in reqs), "a served request did not finish")
        return [list(r.tokens) for r in reqs], [
            np.concatenate(audio[r.request_id]) if r.request_id in audio else np.zeros(0)
            for r in reqs]

    with counting(model, "_prefill", prefills), counting(model, "_step_fn", steps), \
            counting(qmm, "quantized_matvec_ref", plain):
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served, audio = serve(Q4_SERVE_TEXTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
    n_tok = sum(len(t) for t in served)
    want_tile, want_decode = 4 * L * prefills[0], (4 * L + 1) * steps[0]
    want = {"quantized_matvec": want_tile + want_decode, "quantized_matvec_tile": want_tile,
            "quantized_matvec_decode": want_decode}
    print(f"[tts q4 serve] {len(served)} requests, {Q4_SERVE_SLOTS} slots, max_tokens "
          f"{Q4_SERVE_MAX_TOKENS}: {n_tok} tokens in {wall:.3f} s ({steps[0]} lane steps, "
          f"{prefills[0]} prefills); launches {launches} ({want} expected: the prefills' "
          f"through the tile, the lane steps' through the decode kernel), plain version "
          f"calls {plain[0]}; samples by request "
          f"{[a.shape[0] for a in audio]}")
    check(launches == want,
          f"serving launches {launches}, {want} of kernel 7 and no other expected")
    check(plain[0] == 0, "the plain version ran on the 4-bit serving path")
    for toks, wav in zip(served, audio):
        frames = len(model.parse_output(toks)) // 7
        check(frames > 0 and wav.shape == (frames * spg,) and bool(np.isfinite(wav).all()),
              f"served audio {wav.shape} for {frames} frames")
    alone = []
    for i, (text, want_toks) in enumerate(zip(Q4_SERVE_TEXTS, served)):
        srv = ContinuousTTS(model, slots=Q4_SERVE_SLOTS, generation_parameters=gp)
        r = srv.submit(text, seed=i)
        for _ in srv.engine.run():
            pass
        alone.append(list(r.tokens) == want_toks)
    print(f"[tts q4 serve] each request alone in a fresh engine gives the same tokens: {alone}")
    check(all(alone), "served 4-bit tokens depend on the other requests")
    return dict(requests=len(served), tokens=n_tok, wall_s=wall, lane_steps=steps[0],
                alone_equal=all(alone), launches=launches)


def build_whisper_q4(params, cfg, dev):
    """whisper-large-v3 at full width from the bf16 phases' seed-0 weights,
    quantized on the card to MLX 4-bit in groups of 64 (every linear of the
    encoder and decoder and the tied embedding), as an mlx-community q4
    checkpoint ships them."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt import whisper as W

    q4 = quant.quantize_tree(params, bits=4, group_size=64, scheme="mlx")
    check(isinstance(q4["model"]["decoder"]["embed_tokens"]["weight"], quant.QuantizedTensor)
          and isinstance(q4["model"]["encoder"]["layers"]["fc1"]["weight"],
                         quant.QuantizedTensor), "whisper q4: linears not packed")
    model = W.Whisper(cfg, q4, LargeV3Tokenizer(), dtype=torch.bfloat16, device=dev)
    check(not model._fused_supported(), "whisper q4 takes the fused route")
    return model


def q4_whisper_phase(model, audio) -> dict:
    """Phase 17's transcription: one window through ``Whisper.generate``
    on the whisper-large-v3-width q4 tree (kv8d: int8 cross K/V), with the
    counters reset just before and read just after: kernel 7's decode
    kernel launched 8 x 32 + 1 times a decoder step (q, k, v, out, cross-q,
    cross-out, fc1, fc2 and the 51,866-row head) and no other of its
    kernels, no plain call; then the same window on the plain
    route (every kernel's plain version) gives the same tokens."""
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib, qmm

    gp = STTGenerateParameters(kv_bits=8, quantized_kv_start=448,
                               max_tokens=Q4_WHISPER_TOKENS)
    steps, plain = [0], [0]
    with counting(W, "decoder_step", steps), counting(qmm, "quantized_matvec_ref", plain):
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(audio, gp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
    with plain_kernels():
        ref = model.generate(audio, gp)
    toks, want = out.segments[0].tokens, ref.segments[0].tokens
    n_layers = model.config.decoder_layers
    print(f"[whisper q4] {len(toks)} tokens in {wall:.3f} s ({steps[0]} decoder steps, "
          f"{wall * 1e3 / steps[0]:.3f} ms a step, the encoder's products dequantized); "
          f"launches {launches}, plain version calls {plain[0]}; tokens equal the plain "
          f"route's: {toks == want}; first tokens {toks[:12]}")
    n_gemvs = (8 * n_layers + 1) * steps[0]
    check(launches.get("quantized_matvec", 0) == launches.get("quantized_matvec_decode", 0)
          == n_gemvs, f"quantized_matvec launched {launches.get('quantized_matvec', 0)} "
          f"times, its decode kernel {launches.get('quantized_matvec_decode', 0)}, {n_gemvs} "
          f"each expected for {steps[0]} decoder steps")
    check(launches.get("fused_log_mel", 0) > 0 and launches.get("decode_attention_int8", 0) > 0,
          "whisper q4: the frontend or the int8 cross attention kernel did not launch")
    check(plain[0] == 0, "the plain version ran on the whisper q4 path")
    check(len(toks) > 0 and toks == want, "whisper q4 tokens differ from the plain route's")
    return dict(tokens=len(toks), steps=steps[0], wall_s=wall, launches=launches,
                equal_to_plain=toks == want)


def mutations_main(kernels: list) -> int:
    """The standing mutation check: for each kernel of MUTATIONS (those named
    in ``kernels``, or all), its check alone (timing off) on copies of the
    checkout, one sound and one for each mutation of its source, each in its
    own process. Every mutant must fail and every sound copy pass."""
    unknown = sorted(set(kernels) - set(MUTATIONS))
    if unknown:
        print(f"chip_smoke: no mutations for {unknown}; kernels: {sorted(MUTATIONS)}",
              file=sys.stderr)
        return 2
    results = []
    with tempfile.TemporaryDirectory(prefix="mutants_") as tmp:
        for kernel, (source, phase, muts) in MUTATIONS.items():
            if kernels and kernel not in kernels:
                continue
            for name, old, new, *own in [("sound", None, None)] + muts:
                dst = Path(tmp) / f"copy{len(results)}"
                shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
                    ".git", "_build", "chiprun_out", "_chip", "__pycache__"))
                if old is not None:
                    path = dst / (own[0] if own else source)
                    text = path.read_text()
                    check(text.count(old) == 1, f"mutation {name!r}: no unique site")
                    path.write_text(text.replace(old, new))
                res = subprocess.run(
                    [sys.executable, "-c", f"import sys, chip_smoke; "
                     f"sys.exit(chip_smoke.{phase}())"],
                    cwd=dst, capture_output=True, text=True, timeout=900)
                lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[")]
                err = res.stderr.strip().splitlines()[-1:] if res.returncode else []
                print(f"[mutation] {kernel}: {name}: exit {res.returncode}")
                for ln in lines + err:
                    print("  " + ln)
                results.append(dict(kernel=kernel, name=name, exit=res.returncode))
    ok = all((r["exit"] == 0) == (r["name"] == "sound") for r in results)
    print(json.dumps({"mutations": results, "sound_passes_and_every_mutant_fails": ok}))
    return 0 if ok else 1


def fused_stack_only() -> int:
    """Kernel 3's checks alone, timing off, on a random whisper-large-v3
    pack and cross K/V (no encoder): its check under --mutations."""
    import torch

    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    cfg = stack_config()
    pack, cross = random_stack_inputs(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    stack_phase(pack, cross, cfg, dev, gen,
                lambda off: torch.randn((cfg.d_model,), generator=gen, device=dev) * 0.5,
                timing=False)
    return 0


def fused_stack_lanes_only() -> int:
    """Kernel 4's own checks alone (fused_lanes_phase): its check under
    --mutations."""
    import torch

    sys.path.insert(0, str(ROOT))
    fused_lanes_phase(torch.device("cuda", 0))
    return 0


def stack_libraries(others: list, tmp: Path, source: str = "fused_decoder.cu",
                    entry: str = "tpa_fused_stack") -> dict:
    """The C entry ``entry`` of csrc/``source`` (kernel 3's by default) as it
    stands (named STACK_SOURCE) and of each checkout in ``others`` (the
    roots of other checkouts, named by their directories), each built into
    a shared library of its own, one nvcc each, all started together. The
    source as it stands is built with ``-Xptxas -v`` and its registers and
    spills are printed. Returns name -> C function."""
    import ctypes

    from tpu_audio_torch.ops import _lib

    srcs = {STACK_SOURCE: ROOT / "tpu_audio_torch" / "csrc"}
    for other in others:
        srcs[other.name] = other / "tpu_audio_torch" / "csrc"
    jobs = {}
    for i, (name, csrc) in enumerate(srcs.items()):
        dst = tmp / f"lib{i}"
        shutil.copytree(csrc, dst)
        so = dst / "libstack.so"
        flags = [*_lib.NVCC_FLAGS, *(["-Xptxas", "-v"] if name == STACK_SOURCE else [])]
        jobs[name] = (so, subprocess.Popen(
            [_lib._nvcc(), *flags, "-shared", "-o", str(so), str(dst / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        out = proc.communicate(timeout=600)[0]
        check(proc.returncode == 0, f"nvcc {name}: {out}")
        if name == STACK_SOURCE:
            kernel = None
            for ln in out.splitlines():
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1]
                elif "Used" in ln and kernel is not None:
                    print(f"[ptxas] {kernel[:72]}: {ln.split(':', 1)[1].strip()}")
                elif "spill" in ln and kernel is not None and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill"):
                    print(f"[ptxas] {kernel[:72]}: {ln.strip()}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _lib._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def stack_stages(fn, n_layers: int, reps: int = 5, kernels_of=STACK_KERNELS,
                 stages=STACK_STAGES, label: str = "fused_stack") -> dict | None:
    """A stack kernel's time by stage of a layer over ``reps`` calls of
    ``fn``, from the device intervals of the kernels named in
    ``kernels_of``, in launch order; ``stages`` maps the launches a layer to
    their stage names (kernel 3's by default: 8 a layer, or the parent's
    10). Microseconds a layer of each stage's interval (with PDL it
    includes the wait on its predecessor) and of its increment of the
    chain's end (its end less the previous kernel's). None where the
    profile lost kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(a, b) for a, b, n in device_intervals(prof) if any(k in n for k in kernels_of)]
    per_layer = len(spans) // (reps * n_layers)
    if per_layer not in stages or len(spans) != per_layer * reps * n_layers:
        print(f"[{label} stages] the profile kept {len(spans)} kernels of {reps} calls: "
              f"not measured")
        return None
    names = stages[per_layer]
    out = {n: [0.0, 0.0] for n in names}
    for call in range(reps):
        prev = None
        for i, (a, b) in enumerate(spans[call * per_layer * n_layers:
                                         (call + 1) * per_layer * n_layers]):
            st = out[names[i % per_layer]]
            st[0] += b - a
            st[1] += b - (a if prev is None else prev)
            prev = b
    return {n: dict(interval_us=v[0] / (reps * n_layers), increment_us=v[1] / (reps * n_layers))
            for n, v in out.items()}


def fused_stack_timing_main(smi: str, others: list) -> int:
    """``--fused-stack-timing [CHECKOUT ...]``: kernel 3 at whisper-large-v3
    width on random inputs (random_stack_inputs, offset STACK_TIME_OFFSET),
    built from the source as it stands and from each other checkout given
    (a parent commit's, or a copy with a variant of the kernel, named by its
    directory): each version against the plain
    version and bit for bit against the first, then per call (CUDA events
    around STACK_TIMING_REPS back-to-back calls, each with its copy of x and
    zeroing of the counters) in turns (each version, then each again in
    reverse order), device time (profiler, the union of intervals) and the
    stage breakdown of a layer. Prints one JSON line (no "ok" line)."""
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_decoder as F

    dev = torch.device("cuda", 0)
    cfg = stack_config()
    L, d, ffn, H = (cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim,
                    cfg.decoder_attention_heads)
    s_max, off = cfg.max_target_positions, STACK_TIME_OFFSET
    pack, (ck, ks, cv, vs) = random_stack_inputs(cfg, dev)
    s_src = s_ck = ck.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    kc, vc = stack_caches(cfg, off, gen, dev)
    x = torch.randn((d,), generator=gen, device=dev) * 0.5
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stack_libs_") as tmp:
        fns = stack_libraries(others, Path(tmp))
    print(f"[fused_stack timing] {len(fns)} versions built in {time.perf_counter() - t0:.1f} s")
    layout = F.scratch_layout(d, ffn, L, H, s_max, s_src)
    y = torch.empty_like(x)
    qkv = torch.empty((L, 3 * d), device=dev)
    scratch = torch.empty((layout["total"],), device=dev)
    counts = scratch[layout["counts"][0]:layout["counts"][0] + layout["counts"][1]]
    ptrs = [t.data_ptr() for t in (y, *pack, ck, ks, cv, vs, kc, vc, qkv, scratch)]
    stream = _lib.stream(x)

    def caller(name, fn):
        def call():
            y.copy_(x)
            counts.zero_()
            err = fn(*ptrs, L, d, ffn, H, s_src, s_ck, s_max, off, stream)
            check(err == 0, f"tpa_fused_stack ({name}): CUDA error {err}")
        return call

    calls = {n: caller(n, fn) for n, fn in fns.items()}
    order = [o.name for o in others] + [STACK_SOURCE]
    want = F.fused_stack_ref(pack, ck, ks, cv, vs, kc.clone(), vc.clone(), x, off, cfg=cfg,
                             s_src=s_src)
    outs = {}
    for name in order:
        calls[name]()
        torch.cuda.synchronize()
        outs[name] = (y.clone(), qkv[:, d:2 * d].clone(), qkv[:, 2 * d:].clone())
    res = {}
    for name in order:
        err = max(rel_err(g, w) for g, w in zip(outs[name], want))
        same = all(torch.equal(a, b) for a, b in zip(outs[name], outs[order[0]]))
        print(f"[fused_stack timing] {name}: vs plain {err:.3e} (rtol {FUSED_RTOL}); "
              f"bit-equal to {order[0]}: {same}")
        check(err <= FUSED_RTOL, f"{name} disagrees with the plain version: {err}")
        res[name] = dict(rel_err=err, bit_equal_to_first=same, ms=[])

    time_in_turns("fused_stack", calls, order, res, L)
    print(json.dumps({"fused_stack_timing": res, "offset": off, "smi": smi}))
    return 0


def events_ms(call) -> float:
    """Milliseconds a call of ``call`` over STACK_TIMING_REPS back-to-back
    calls (CUDA events around them), after three warm-up calls."""
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(STACK_TIMING_REPS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / STACK_TIMING_REPS


def time_in_turns(label: str, calls: dict, order: list, res: dict, n_layers: int,
                  kernels_of=STACK_KERNELS, stages=STACK_STAGES) -> None:
    """Times each version's call in turns (each in ``order``, then each again
    in reverse order) into ``res[name]["ms"]``, then its device time
    (``dev_ms``) and stage breakdown (``stages``), and prints them."""
    for name in order + order[::-1]:
        res[name]["ms"].append(events_ms(calls[name]))
    for name in order:
        res[name]["dev_ms"] = device_ms(calls[name])
        res[name]["stages"] = stack_stages(calls[name], n_layers, kernels_of=kernels_of,
                                           stages=stages, label=label)
        r = res[name]
        print(f"[{label} timing] {name}: per call {' '.join(f'{m:.4f}' for m in r['ms'])} "
              f"ms, device {fmt(r['dev_ms'])}")
        for stage, v in (r["stages"] or {}).items():
            print(f"  {stage:16s} interval {v['interval_us']:8.3f} us, increment "
                  f"{v['increment_us']:8.3f} us a layer")


def fused_llama_timing_main(smi: str, others: list) -> int:
    """``--fused-llama-timing [CHECKOUT ...]``: kernel 5 at Orpheus-3B width
    on llama_inputs' random inputs at each (offset, valid_from) of
    LLAMA_TIMING_CHECKS, built from the source as it stands and from each
    other checkout given (a parent commit's, or a copy with a variant of the
    kernel, named by its directory): each version bit for bit against the
    first and against the plain version fed the first's int8 codes
    (FORCED_RTOL), then per call (CUDA events around STACK_TIMING_REPS
    back-to-back calls, each with its copy of x and zeroing of the
    counters) in turns, device time (profiler, the union of intervals), the
    stage breakdown of a layer by kernel (LLAMA_STAGES) and the bound as
    fused_llama_phase computes it. Every version gets a scratch buffer of
    the larger of the source's layout and the 11-launch kernel's size, with
    room for d + 2 ffn + 64 words more, zeroed from the source's counters to
    its end before each call (a variant that lays out its activations
    otherwise, keeping its counters last, finds its counters zeroed), and an
    int8 [max(d, ffn)] xq buffer. Prints one JSON line (no "ok" line)."""
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_llama as FL

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stack_libs_") as tmp:
        fns = stack_libraries(others, Path(tmp), "fused_llama.cu", "tpa_fused_llama_stack")
    print(f"[fused_llama timing] {len(fns)} versions built in {time.perf_counter() - t0:.1f} s")
    model = build_orpheus(dev)
    cfg = model.config
    pack = model.fused_decoder_pack()
    L, d, ffn = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dkv = n_kv * FL.HEAD_DIM
    order = [o.name for o in others] + [STACK_SOURCE]
    out = {}
    with torch.inference_mode():
        for i, (off, vf) in enumerate(LLAMA_TIMING_CHECKS):
            kc, vc, x = llama_inputs(model, dev, 20 + i)
            s_max = kc.shape[1]
            snap_k, snap_v = kc.clone(), vc.clone()
            layout = FL.scratch_layout(L, d, ffn, H, n_kv, s_max)
            nc = -(-(off + 1 - vf) // _lib.ATTN_CHUNK)
            parent_words = d + 2 * ffn + 4 + H * nc * (FL.HEAD_DIM + 2)
            y = torch.empty_like(x)
            qkv = torch.empty((L, d + 2 * dkv), device=dev)
            scratch = torch.empty((max(layout["total"], parent_words) + d + 2 * ffn + 64,),
                                  device=dev)
            counts = scratch[layout["counts"][0]:]
            xq = torch.empty((max(d, ffn),), dtype=torch.int8, device=dev)
            tap = llama_taps(cfg, dev, False)
            ptrs = [t.data_ptr() for t in (y, *pack, kc, vc, qkv, scratch, xq)]
            tail = (L, d, ffn, H, n_kv, s_max, off, vf, int(bool(cfg.qk_norm)),
                    float(cfg.rms_norm_eps), _lib.stream(x))

            def caller(name, fn, taps=(0, 0)):
                def call():
                    y.copy_(x)
                    counts.zero_()
                    err = fn(*ptrs, *taps, *tail)
                    check(err == 0, f"tpa_fused_llama_stack ({name}): CUDA error {err}")
                return call

            calls = {name: caller(name, fn) for name, fn in fns.items()}
            caller(order[0], fns[order[0]], (tap[0].data_ptr(), tap[1].data_ptr()))()
            forced = FL.fused_llama_stack_ref(pack, snap_k.clone(), snap_v.clone(), x, off,
                                              cfg=cfg, valid_from=vf, codes=tap)
            res, first = {}, None
            for name in order:
                calls[name]()
                torch.cuda.synchronize()
                got = (y.clone(), qkv[:, d:d + dkv].clone(), qkv[:, d + dkv:].clone())
                first = first or got
                err = max(rel_err(a, b) for a, b in zip(got, forced))
                same = all(torch.equal(a, b) for a, b in zip(got, first))
                print(f"[fused_llama timing] offset {off} valid_from {vf} {name}: vs plain fed "
                      f"{order[0]}'s codes {err:.3e} (rtol {FORCED_RTOL}); bit-equal to "
                      f"{order[0]}: {same}")
                check(err <= FORCED_RTOL,
                      f"{name} at offset {off} disagrees with the plain version: {err}")
                res[name] = dict(rel_err=err, bit_equal_to_first=same, ms=[])
            b_ms, b_by = llama_bound(pack, cfg, x, first, off, vf)
            print(f"[fused_llama timing] offset {off}: bound {b_ms:.4f} ms ({b_by})")
            time_in_turns(f"fused_llama offset {off}", calls, order, res, L,
                          kernels_of=LLAMA_KERNELS, stages=LLAMA_STAGES)
            out[str(off)] = dict(valid_from=vf, bound_ms=b_ms, bound_by=b_by, versions=res)
            del kc, vc, snap_k, snap_v, forced, scratch, counts
    print(json.dumps({"fused_llama_timing": out, "smi": smi}))
    return 0


def kv_mel_timing_main(smi: str, others: list) -> int:
    """``--kv-mel-timing [CHECKOUT ...]``: kernels 2 and 1 built from the
    source as it stands and from each other checkout given (a parent
    commit's, or a copy with a variant of either kernel, named by its
    directory), through stack_libraries. Kernel 2 on random whisper-large-v3
    cross planes (kv_planes; the bf16 q converted once, outside the timed
    call) at each of KV_CHECKS, kernel 1 on each of mel_spectra: each
    version's KV_CALLS / MEL_CALLS calls bit for bit alike, bit-equal to the
    first version's and within tolerance of the plain version. Then each is
    timed in turns (time_in_turns: per call over STACK_TIMING_REPS
    back-to-back calls, device time as the union of intervals, the stage
    breakdown by kernel): kernel 2 hot (one layer's planes, back to back) and
    cold (KV_COLD_LAYERS layers' planes in rotation, as a decode step reads
    them), kernel 1 at 128 and 80 mels. Every version of kernel 2 gets a
    scratch of twice the source's layout (room for a variant of smaller
    chunks), zeroed before its first call (the parent's entry ignores the
    counters). Prints the bounds and one JSON line (no "ok" line)."""
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import kv_attention as K

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kv_mel_libs_") as tmp:
        kv_fns = stack_libraries(others, Path(tmp) / "kv", "kv_attention.cu",
                                 "tpa_decode_attention_int8")
        mel_fns = stack_libraries(others, Path(tmp) / "mel", "mel.cu", "tpa_fused_log_mel")
    print(f"[kv_mel timing] {len(kv_fns)} versions built in {time.perf_counter() - t0:.1f} s")
    order = [o.name for o in others] + [STACK_SOURCE]
    stream = _lib.stream(torch.empty(1, device=dev))
    sm = 1.0 / KV_HD ** 0.5
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((KV_HEADS, 1, KV_HD), generator=gen, device=dev).to(torch.bfloat16)
    qf = q.float()

    def kv_call(name, planes, valid, scratch, out):
        (kq, vq), (h, s, d) = planes, planes[0][0].shape
        ml = K.scratch_layout(h, s, d)["part_ml"][0]
        args = [x.data_ptr() for x in (qf, *kq, *vq, out)]
        args += [scratch.data_ptr(), scratch.data_ptr() + 4 * ml, h, s, d, kq[1].shape[-1],
                 valid, sm, stream]

        def call():
            err = kv_fns[name](*args)
            check(err == 0, f"tpa_decode_attention_int8 ({name}): CUDA error {err}")
            return out
        return call

    def kv_scratch(s):
        return torch.zeros((2 * K.scratch_layout(KV_HEADS, s)["total"],), device=dev)

    out = {"decode_attention_int8": {}, "fused_log_mel": {}}
    firsts = {}
    for s, g, valid, biased in KV_CHECKS:
        planes = kv_planes(gen, dev, s, g, biased)
        scratch = kv_scratch(s)
        label = f"S {s} G {g} valid {valid}{' biased' if biased else ''}"
        res = {}
        for name in order:
            scratch.zero_()
            outs = iter([torch.empty((KV_HEADS, 1, KV_HD), device=dev)
                         for _ in range(KV_CALLS)])
            got, _, err = kv_check(f"{label} {name}", lambda: kv_call(
                name, planes, valid, scratch, next(outs))(), q, *planes, valid)
            same = torch.equal(got, firsts.setdefault(label, got))
            print(f"[kv_mel timing] decode_attention_int8 {label} {name}: bit-equal to "
                  f"{order[0]}: {same}")
            res[name] = dict(rel_err=err, bit_equal_to_first=same)
        out["decode_attention_int8"][label] = res
    for setting, n_layers in (("hot", 1), ("cold", KV_COLD_LAYERS)):
        layers = [kv_planes(gen, dev) for _ in range(n_layers)]
        o = torch.empty((KV_HEADS, 1, KV_HD), device=dev)
        calls, res = {}, {}
        for name in order:
            scratch = kv_scratch(KV_POSITIONS)
            calls[name] = cycling([kv_call(name, p, KV_POSITIONS, scratch, o) for p in layers])
            res[name] = dict(ms=[])
        b_ms, b_by = kv_bound(q, *layers[0], o)
        print(f"[kv_mel timing] decode_attention_int8 {setting} ({n_layers} layers' planes): "
              f"bound {b_ms:.4f} ms ({b_by})")
        time_in_turns(f"decode_attention_int8 {setting}", calls, order, res, 1,
                      kernels_of=KV_KERNELS, stages=KV_STAGES)
        out["decode_attention_int8"][setting] = dict(layers=n_layers, bound_ms=b_ms,
                                                     bound_by=b_by, versions=res)
        del layers

    def mel_call(name, re, im, fb, o):
        args = [x.data_ptr() for x in (re, im, fb, o)] + [*re.shape, fb.shape[1], stream]

        def call():
            err = mel_fns[name](*args)
            check(err == 0, f"tpa_fused_log_mel ({name}): CUDA error {err}")
            return o
        return call

    for i, (label, re, im, fb) in enumerate(mel_spectra(dev, speech_window())):
        res, first = {}, None
        for name in order:
            outs = iter([torch.empty((re.shape[0], fb.shape[1]), device=dev)
                         for _ in range(MEL_CALLS)])
            got, _, err = mel_check(f"{label} {name}", lambda: mel_call(
                name, re, im, fb, next(outs))(), re, im, fb)
            first = got if first is None else first
            same = torch.equal(got, first)
            print(f"[kv_mel timing] fused_log_mel {label} {name}: bit-equal to {order[0]}: "
                  f"{same}")
            res[name] = dict(max_abs_err=err, bit_equal_to_first=same, ms=[])
        entry = dict(versions=res)
        if i < 2:  # timed: the frontend's 128 mels and the smaller sizes' 80
            o = torch.empty_like(first)
            calls = {name: mel_call(name, re, im, fb, o) for name in order}
            entry["bound_ms"], entry["bound_by"] = mel_bound(re, im, fb, o)
            print(f"[kv_mel timing] fused_log_mel {label}: bound {entry['bound_ms']:.4f} ms "
                  f"({entry['bound_by']})")
            time_in_turns(f"fused_log_mel {label}", calls, order, res, 1,
                          kernels_of=("fused_log_mel",), stages={1: ("mel",)})
        out["fused_log_mel"][label] = entry
    print(json.dumps({"kv_mel_timing": out, "smi": smi}))
    return 0


def llama_lanes_bound(pack, cfg, x, out, offs) -> tuple[float, str]:
    """Kernel 6's bound on one call: the weights, scales and norms once; per
    lane the cache rows it attends (valid_from..offset), x in, y and the new
    k/v out; the int8 products and the attention's f32 operations."""
    L, d, dkv = cfg.num_hidden_layers, cfg.hidden_size, cfg.num_key_value_heads * 128
    n = x.shape[0]
    rows = sum(min(o, LLAMA_S_MAX - 1) - vf + 1 for o, vf in offs)
    return bound(nbytes(pack.w_in, pack.w_down, pack.scales, pack.norms, pack.inv_freq,
                        x, *out) + 2 * L * rows * dkv * 2,
                 int8_ops=2 * n * L * d * (pack.w_in.shape[1] + cfg.intermediate_size),
                 f32_ops=4 * L * rows * cfg.num_attention_heads * 128)


def llama_lanes_timing_main(smi: str, others: list) -> int:
    """``--llama-lanes-timing [CHECKOUT ...]``: kernel 6 at Orpheus-3B width
    on phase 11's random inputs (llama_lane_inputs) at each n of
    LLAMA_LANES_TIMING_COUNTS, built from the source as it stands and from
    each other checkout given (a parent commit's, or a copy with a variant
    of the kernel, named by its directory): each version bit for bit against
    the first and, per lane, against the plain version fed the first's int8
    codes (FORCED_RTOL), then per call (CUDA events around
    STACK_TIMING_REPS back-to-back calls, each with its copy of x and
    zeroing of the counters) in turns, device time (profiler, the union of
    intervals) and the stage breakdown of a layer by kernel. Every version
    gets the scratch of the source's layout; the 11-launch kernel's regions
    are its first ones (a checkout laid out otherwise needs its own size).
    Prints one JSON line (no "ok" line)."""
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_llama as FL

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stack_libs_") as tmp:
        fns = stack_libraries(others, Path(tmp), "fused_llama_lanes.cu",
                              "tpa_fused_llama_stack_lanes")
    print(f"[fused_llama_lanes timing] {len(fns)} versions built in "
          f"{time.perf_counter() - t0:.1f} s")
    model = build_orpheus(dev)
    cfg = model.config
    pack = model.fused_decoder_pack()
    L, d, ffn = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    H, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    dkv = n_kv * FL.HEAD_DIM
    order = [o.name for o in others] + [STACK_SOURCE]
    out = {}
    with torch.inference_mode():
        for n in LLAMA_LANES_TIMING_COUNTS:
            kc, vc, lanes, offs, x = llama_lane_inputs(model, dev, max(LANE_SLOTS, n), n, n)
            snap_k, snap_v = kc.clone(), vc.clone()
            lanes_t, offs_t, vfs_t = (torch.tensor(v, dtype=torch.int64, device=dev) for v in
                                      (lanes, [o for o, _ in offs], [vf for _, vf in offs]))
            layout = FL.lanes_scratch_layout(n, L, d, ffn, H, n_kv, kc.shape[2])
            y = torch.empty_like(x)
            qkv = torch.empty((L, n, d + 2 * dkv), device=dev)
            scratch = torch.empty((layout["total"],), device=dev)
            counts = scratch[layout["counts"][0]:layout["counts"][0] + layout["counts"][1]]
            xq = torch.empty((n * max(d, ffn),), dtype=torch.int8, device=dev)
            tap = llama_taps(cfg, dev, False, n)
            ptrs = [t.data_ptr() for t in (y, offs_t, vfs_t, lanes_t, *pack, kc, vc, qkv, scratch,
                                           xq)]
            tail = (n, L, d, ffn, H, n_kv, kc.shape[2], int(bool(cfg.qk_norm)),
                    float(cfg.rms_norm_eps), _lib.stream(x))

            def caller(name, fn, taps=(0, 0)):
                def call():
                    y.copy_(x)
                    counts.zero_()
                    err = fn(*ptrs, *taps, *tail)
                    check(err == 0, f"tpa_fused_llama_stack_lanes ({name}): CUDA error {err}")
                return call

            calls = {name: caller(name, fn) for name, fn in fns.items()}
            caller(order[0], fns[order[0]], (tap[0].data_ptr(), tap[1].data_ptr()))()
            forced = FL.fused_llama_stack_lanes_ref(pack, snap_k.clone(), snap_v.clone(), lanes_t,
                                                    x, offs_t, vfs_t, cfg=cfg, codes=tap)
            res, first = {}, None
            for name in order:
                calls[name]()
                torch.cuda.synchronize()
                got = (y.clone(), qkv.clone())
                first = first or got
                err = max(rel_err(a, b) for m in range(n) for a, b in zip(
                    (got[0][m], got[1][:, m, d:d + dkv], got[1][:, m, d + dkv:]),
                    (forced[0][m], forced[1][:, m], forced[2][:, m])))
                same = all(torch.equal(a, b) for a, b in zip(got, first))
                print(f"[fused_llama_lanes timing] n={n} {name}: vs plain fed {order[0]}'s codes "
                      f"{err:.3e} (rtol {FORCED_RTOL}); bit-equal to {order[0]}: {same}")
                check(err <= FORCED_RTOL,
                      f"{name} at n={n} disagrees with the plain version: {err}")
                res[name] = dict(rel_err=err, bit_equal_to_first=same, ms=[])
            b_ms, b_by = llama_lanes_bound(pack, cfg, x, (y, qkv[:, :, d:d + dkv],
                                                          qkv[:, :, d + dkv:]), offs)
            print(f"[fused_llama_lanes timing] n={n}: bound {b_ms:.4f} ms ({b_by})")
            time_in_turns(f"fused_llama_lanes n={n}", calls, order, res, L,
                          kernels_of=LLAMA_LANES_KERNELS, stages=LLAMA_LANES_STAGES)
            out[str(n)] = dict(bound_ms=b_ms, bound_by=b_by, offsets=offs, versions=res)
            del kc, vc, snap_k, snap_v, forced
    print(json.dumps({"fused_llama_lanes_timing": out, "smi": smi}))
    return 0


def fused_lanes_timing_main(smi: str, others: list) -> int:
    """``--fused-lanes-timing [CHECKOUT ...]``: kernel 4 at whisper-large-v3
    width on random inputs (random_stack_inputs' pack, random_lane_state over
    max(LANE_SLOTS, n) slots, lane_layout's slots and offsets) at each n of
    LANES_TIMING_COUNTS, built from the source as it stands and from each
    other checkout given (a parent commit's, or a copy with a variant of the
    kernel, named by its directory): each version bit for bit against the
    first and, per lane, against the plain version fed the first's int8
    codes (FORCED_RTOL), then per call (CUDA events around
    STACK_TIMING_REPS back-to-back calls, each with its copy of x and
    zeroing of the source's counters) in turns, device time (profiler, the
    union of intervals), the stage breakdown of a layer by kernel, and the
    bound as lanes_phase computes it. Every version gets a scratch buffer
    of the larger of the source's layout and the 16-launch kernel's size,
    and an int8 [n, max(d, ffn)] xq buffer. Prints one JSON line (no "ok"
    line)."""
    import torch

    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_decoder as F

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stack_libs_") as tmp:
        fns = stack_libraries(others, Path(tmp), "fused_decoder_lanes.cu",
                              "tpa_fused_stack_lanes")
    print(f"[fused_stack_lanes timing] {len(fns)} versions built in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = stack_config()
    L, d, ffn, H = (cfg.decoder_layers, cfg.d_model, cfg.decoder_ffn_dim,
                    cfg.decoder_attention_heads)
    kmax = max(d, ffn)
    pack, _ = random_stack_inputs(cfg, dev, seed=3)
    order = [o.name for o in others] + [STACK_SOURCE]
    out = {}
    for n in LANES_TIMING_COUNTS:
        slots = max(LANE_SLOTS, n)
        state = random_lane_state(cfg, dev, slots, seed=4)
        ck, ks, cv, vs, kc, vc = state
        s_src = s_ck = ck.shape[2]
        s_max = kc.shape[2]
        lanes, offs = lane_layout(n, slots, s_max, seed=n)
        clamped = [min(o, s_max - 1) for o in offs]
        x = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev) * 0.5
        lanes_t, offs_t = (torch.tensor(v, dtype=torch.int32, device=dev) for v in (lanes, offs))
        layout = F.lanes_scratch_layout(n, d, ffn, L, H, s_max, s_src)
        nc = -(-max(s_max, s_src) // _lib.ATTN_CHUNK)
        parent_words = n * (3 * d + ffn) + -(-n // 4) * 4 + n * H * nc * (d // H + 2)
        y = torch.empty_like(x)
        qkv = torch.empty((L, n, 3 * d), device=dev)
        scratch = torch.empty((max(layout["total"], parent_words),), device=dev)
        counts = scratch[layout["counts"][0]:layout["counts"][0] + layout["counts"][1]]
        xq = torch.empty((n * kmax,), dtype=torch.int8, device=dev)
        tap = (torch.zeros((L, 6, n, kmax), dtype=torch.int8, device=dev),
               torch.zeros((L, 6, n), device=dev))
        ptrs = [t.data_ptr() for t in (y, offs_t, lanes_t, *pack, *state, qkv, scratch, xq)]
        tail = (n, L, d, ffn, H, s_src, s_ck, s_max, _lib.stream(x))

        def caller(name, fn, taps=(0, 0)):
            def call():
                y.copy_(x)
                counts.zero_()
                err = fn(*ptrs, *taps, *tail)
                check(err == 0, f"tpa_fused_stack_lanes ({name}): CUDA error {err}")
            return call

        calls = {name: caller(name, fn) for name, fn in fns.items()}
        caller(order[0], fns[order[0]], (tap[0].data_ptr(), tap[1].data_ptr()))()
        forced = [F.fused_stack_ref(pack, ck[s], ks[s], cv[s], vs[s], kc[s].clone(),
                                    vc[s].clone(), x[m], o, cfg=cfg, s_src=s_src,
                                    codes=(tap[0][:, :, m], tap[1][:, :, m]))
                  for m, (s, o) in enumerate(zip(lanes, clamped))]
        res, first = {}, None
        for name in order:
            calls[name]()
            torch.cuda.synchronize()
            got = (y.clone(), qkv[:, :, d:2 * d].clone(), qkv[:, :, 2 * d:].clone())
            first = first or got
            err = max(rel_err(a, b) for m in range(n) for a, b in zip(
                (got[0][m], got[1][:, m], got[2][:, m]), forced[m]))
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            print(f"[fused_stack_lanes timing] n={n} {name}: vs plain fed {order[0]}'s codes "
                  f"{err:.3e} (rtol {FORCED_RTOL}); bit-equal to {order[0]}: {same}")
            check(err <= FORCED_RTOL, f"{name} at n={n} disagrees with the plain version: {err}")
            res[name] = dict(rel_err=err, bit_equal_to_first=same, ms=[])
        b_ms, b_by = lanes_bound(pack, cfg, state[:4], x, first, clamped, s_src)
        print(f"[fused_stack_lanes timing] n={n}: bound {b_ms:.4f} ms ({b_by})")
        time_in_turns(f"fused_stack_lanes n={n}", calls, order, res, L,
                      kernels_of=LANES_KERNELS, stages=LANES_STAGES)
        out[str(n)] = dict(bound_ms=b_ms, bound_by=b_by, slots=lanes, offsets=offs,
                           versions=res)
        del state, ck, cv, kc, vc, forced, scratch
        torch.cuda.empty_cache()
    print(json.dumps({"fused_stack_lanes_timing": out, "smi": smi}))
    return 0


def fused_llama_only() -> int:
    """Phase 8 alone, timing off (kernel 5's check under --mutations)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    fused_llama_phase(build_orpheus(dev), dev, timing=False)
    return 0


def fused_llama_lanes_only() -> int:
    """Kernel 6's checks alone, timing off (its check under --mutations)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    llama_lanes_phase(build_orpheus(dev), dev, timing=False)
    return 0


def qmm_only() -> int:
    """Phase 15 alone, timing off (kernel 7's check under --mutations)."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    qmm_phase(torch.device("cuda", 0), timing=False)
    return 0


def qmm_main(smi: str) -> int:
    """``--qmm``: phase 15 alone with its timing, then kernel 7's two
    records as one JSON line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    recs = qmm_phase(torch.device("cuda", 0))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"smi": smi, "kernels": [dict(name=k, **r) for k, r in recs.items()]}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "tpu_audio_torch" / "csrc").is_dir() or not AUDIO.exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mutations"]:
        return mutations_main(sys.argv[2:])
    timing = {"--fused-stack-timing": fused_stack_timing_main,
              "--fused-lanes-timing": fused_lanes_timing_main,
              "--fused-llama-timing": fused_llama_timing_main,
              "--llama-lanes-timing": llama_lanes_timing_main,
              "--kv-mel-timing": kv_mel_timing_main}.get(next(iter(sys.argv[1:]), ""))
    if sys.argv[1:] not in ([], ["--qmm"]) and not timing:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
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
    if sys.argv[1:] == ["--qmm"]:
        return qmm_main(smi.splitlines()[0])
    if timing:
        return timing(smi.splitlines()[0], [Path(a).resolve() for a in sys.argv[2:]])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_lib.build_seconds if _lib.build_seconds is not None else 0:.2f} s)")

    # phase 15 first: late in this process torch.profiler loses device
    # events, and kernel 7's short calls then read "not measured"
    records = qmm_phase(dev)

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

    kernel_records, enc = kernel_phases(models, cfg, audio, dev)
    records.update(kernel_records)
    w8 = models["w8_kv8d"]
    records["fused_stack_lanes"] = lanes_phase(w8, cfg, lane_encoders(w8, enc, clips, rng),
                                               dev)
    records["fused_stack_lanes"].update(fused_lanes_phase(dev))
    for k, r in records.items():
        if k.startswith("quantized_matvec"):
            continue
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

    # -- long-form: a 240 s file's batched windows (w8 w8e kv8d), bf16 routes --
    longform, long_launches = longform_phase(models, cfg, dev, smi.splitlines()[0])
    for k in ("fused_log_mel", "fused_stack_lanes", "decode_attention_int8"):
        check(long_launches[k] > 0, f"kernel {k} not launched on the long-form path")
        records[k]["longform_launches"] = long_launches[k]
    records["decode_attention_int8"]["longform"] = longform["kv_heads"]

    # -- the serving path: ContinuousSTT over the w8 model --------------------
    serve, serve_launches = serve_phase(w8, clips)
    records["fused_stack_lanes"]["launches"] = serve_launches["fused_stack_lanes"]
    throughput = throughput_phase(w8, (rng.standard_normal(W.CHUNK_LENGTH_SAMPLES)
                                       * 0.1).astype(np.float32))
    http = http_phase(w8, clips)

    for cfg_name, model in models.items():
        profile_window(cfg_name, model, audio, gp)
    whisper_q4 = build_whisper_q4(models["bf16_kv8d"].params, cfg, dev)  # for phase 17
    del models, model, w8, outputs, enc
    gc.collect()
    torch.cuda.empty_cache()

    # -- Orpheus-3B: kernel 5 and offline synthesis ---------------------------
    t0 = time.perf_counter()
    orpheus = build_orpheus(dev)
    orpheus.fused_decoder_pack()
    torch.cuda.synchronize()
    print(f"Orpheus-3B w8a8 (band head) and SNAC 24 kHz built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    records["fused_llama_stack"] = fused_llama_phase(orpheus, dev)
    tts_runs, tts_launches, tts_tokens = tts_generate_phase(orpheus)
    records["fused_llama_stack"]["launches"] = tts_launches["fused_llama_stack"]
    tts = dict(runs=tts_runs, teacher_forced=tts_teacher_forced(orpheus, tts_tokens),
               ttfb=tts_ttfb_phase(orpheus), checks=records["fused_llama_stack"]["checks"])

    # -- Orpheus serving: kernel 6 and ContinuousTTS over the same model ------
    records["fused_llama_stack_lanes"] = llama_lanes_phase(orpheus, dev)
    tts_serve, tts_serve_launches = tts_serve_phase(orpheus)
    records["fused_llama_stack_lanes"]["launches"] = tts_serve_launches["fused_llama_stack_lanes"]
    tts_serving = dict(serve=tts_serve, throughput=tts_throughput_phase(orpheus),
                       http=tts_http_phase(orpheus),
                       checks=records["fused_llama_stack_lanes"]["checks"])
    del orpheus
    gc.collect()
    torch.cuda.empty_cache()

    # -- MLX 4-bit: Orpheus-3B 4-bit offline and served, Whisper q4 ----------
    t0 = time.perf_counter()
    q4, q4_full = build_orpheus_q4(dev)
    torch.cuda.synchronize()
    print(f"Orpheus-3B MLX 4-bit (g 64, band and full heads) built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    q4_runs, q4_launches, q4_tokens = q4_generate_phase(q4, q4_full)
    # the first generate run's: the counter "quantized_matvec" counts every
    # kernel of kernel 7, "quantized_matvec_tile" and "quantized_matvec_decode"
    # the tile's and the decode kernel's (the record "quantized_matvec")
    records["quantized_matvec_tile"]["launches"] = q4_launches["quantized_matvec_tile"]
    records["quantized_matvec"]["launches"] = q4_launches["quantized_matvec_decode"]
    mlx = dict(runs=q4_runs, teacher_forced_rel_err=q4_teacher_forced(q4, q4_tokens),
               ttfb=q4_ttfb_phase(q4), serve=q4_serve_phase(q4),
               whisper=q4_whisper_phase(whisper_q4, audio))
    del q4, q4_full, whisper_q4

    kernels = [dict(name=k, **{f: r[f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "rel_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "dev_ms", "plain_dev_ms")},
        **{f: r[f] for f in ("kernel", "layer_launches", "offsets", "by_lanes", "lane_limit",
                             "longform_launches", "longform",
                             "lane_checks", "by_shape", "by_shape_8bit", "crossover",
                             "rel_err_bf16_x", "rel_err_f16_x", "library_dev_ms", "library_rel_err",
                             "library_error", "gemv_ms", "gemv_dev_ms", "gemv_checks",
                             "gemv_rel_err") if f in r})
        for k, r in records.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"generate": runs, "smi": smi.splitlines()[0]}))
    print(json.dumps({"longform": longform}))
    print(json.dumps({"serve": serve, "throughput": throughput, "http": http}))
    print(json.dumps({"tts": tts}))
    print(json.dumps({"tts_serving": tts_serving}))
    print(json.dumps({"mlx_4bit": mlx}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
