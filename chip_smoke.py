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
   through ``Whisper.generate`` in the w8 kv8d and bf16 kv8d (to 96
   tokens) configurations, twice each, with every launch counter reset just
   before and read just after, and fails unless each kernel of the path
   launched;
3. teacher-forces the generated tokens through the kernel path and the
   plain path and compares the logits of every step; then, in the
   ``[whisper longform]`` phase, transcribes a 240 s file of 8 windows
   (the speech clip, the two-speaker clip, seeded noise) with 112 tokens a
   window through the w8 w8e kv8d model (the int8 encoder quantized on the
   card) in batched windows, with every launch counter reset just before
   and read just after: kernel 1 once a window, one kernel 4 call a step
   for all 8 windows (14 launches a layer), no kernel 3 and no plain
   version; every window's tokens equal its per-window decode's (kernel
   3), batched and per-window timed in turns; the int8 encoder against the
   bf16 one; kernel 2 over all 8 windows' heads bit-equal to 8 calls of
   one window's; and the bf16 kv8d and dense routes on 2 windows with 32
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
runs first of all, right after the build, and the ``[qwen3 tts]`` phase
after it: late in the process ``torch.profiler`` loses device events, and
kernel 7's short calls then read "not measured".)

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
   synthesises 56 tokens through ``LlamaTTS.generate`` (greedy), then 42
   through ``generate`` and ``generate_stream`` (the first run's prefix),
   then 21 tokens with the full tied head: kernel 7's
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

18. ``[qwen3 tts]`` (run second, after phase 15, then phase 19): Qwen3-TTS at the JAX
   package's default widths (talker 20 x 1024, GQA 16/8 x 128; code
   predictor 4 x 1024; 16 code groups; the talker's head past codec_bos_id,
   4,198 rows) and the 12.5 Hz codec decoder at its default widths, random
   weights from seed 0 with seeded non-unit RMSNorm weights, in bf16 and as
   MLX 8-bit in groups of 64 quantized on the card (BASELINE.json:11):
   kernel 7 against its plain version at every product shape of the 8-bit
   path (the decode kernel at 1 row, the tile at 2, 3 and the prompt's
   rows); greedy ``generate`` twice and ``generate_stream`` on the 8-bit
   model, each with the counters reset just before and read just after:
   the decode kernel 319 times a frame (the talker step's 81 products and
   14 code-predictor passes of 17), the tile 17 times a frame (pass 0 at 2
   rows), 80 times for the prefill and twice for the text projection, no
   GEMV, no other kernel, no plain call; the codes and waveforms repeat
   bit for bit, and the codec's streamed chunks equal its offline decode
   within 1e-4 (TF32 off, both flags printed); the first frames'
   teacher-forced logits through kernel 7 and through its plain version;
   then, for bf16 and 8-bit, the time to first audio by
   ``bench_qwen3_tts_ttfb``'s protocol, a frame's host and device ms, busy
   share and device events, kernel 7's device ms a frame beside its bound,
   the codec's ms a chunk and the peak device memory.
19. ``[qwen3 serve]`` (right after ``[qwen3 tts]``, on its 8-bit tree):
   Qwen3-TTS served through ``ContinuousQwen3TTS`` (one lane-batched frame
   a tick, two where first frames in bf16 meet later ones in f32). Kernel
   7's tile at every product shape of the path and every row count of a
   tick (2-8 and 2n up to 16), each row bit-equal to itself beside a
   filler row and within QMM_RTOL of the plain version; six staggered
   greedy requests of their own lengths and voices (six distinct prompts)
   through 4 slots (lanes reused), the counters reset just before and read
   just after, every tick under ``torch.cuda.set_sync_debug_mode("error")``:
   the tile 336 times a lane frame (the frame's products over its rows, a
   lone lane run as two), no decode kernel, no GEMV, no other kernel, no
   plain call; finite audio of whole frames whose chunks equal one flush of
   the codes; each request's codes bit for bit the same alone in a fresh
   engine, and equal to solo ``generate``'s (the decode kernel at 1 row)
   or, where they differ, a printed near-tie witness: solo's top two within
   the routes' teacher-forced logit difference at that step, served and
   with the prompt unpadded;
   ``bench_qwen3_serving``'s protocol at 4 and 8 slots and one live lane
   (aggregate and single-stream frames/s, ms a tick, realtime x a lane, a
   profiled tick's busy share, device events and kernel 7's device ms
   against its bound); two concurrent streamed speech POSTs through
   ``cli.serve.build_server(model, "tts", slots=2)``; the peak device memory.
   ``python3 chip_smoke.py --qwen3`` runs phases 18 and 19 alone.
19a. ``[qwen3 clone]`` (right after ``[qwen3 serve]``, on the same 8-bit
   model, TF32 off): voice cloning with a speaker encoder at
   ``SpeakerEncoderConfig()`` and the speech tokenizer's encoder (Mimi's) at
   ``encoder_config_from_dict({})``, random from seed 0 in f32, on a 5 s
   reference at 24 kHz: kernel 1 at the speaker mel's shape (468 x 513 x
   128) against its plain version, timed, with its bound; the mel, the
   speaker embedding and the encoder's latent against the CPU, each limit
   under a TF32 control, the codes equal or parted at witnessed near ties;
   each encoder's device ms, events, operations and bound; greedy cloned
   ``generate`` twice (the reference cold, then cached) and
   ``generate_stream`` once with the counters reset just before and read
   just after: the prompt's rows (past 64: its prefill dequantizes), kernel
   7's launches, kernel 1 once on the cold reference only, the same codes
   in every run; TTFB with the reference cold and cached; the peak device
   memory.
19b. ``[mimi]`` (right after, TF32 off; no kernel of the port runs there):
   Mimi at ``mimi_202407(16)`` from seed 0 in f32: 10 s of speech encoded
   and decoded against the CPU (codes equal or witnessed, the waveform
   under its TF32 control), ``decode_step`` in uneven chunks against
   offline, ``encode_step``'s codes against offline, RTF, and a streamed
   frame's host and device ms and events. ``python3 chip_smoke.py --clone``
   runs phases 19a and 19b alone (on a freshly built 8-bit model).
20. ``[parakeet]`` (run third, after phase 19): Parakeet-TDT-0.6B at its
   published widths (a 24 x 1024 FastConformer behind dw_striding
   subsampling by 8, 1,024 pieces + blank, durations 0-4, a 640-wide LSTM
   prediction network and joint), random weights from seed 0 with seeded
   non-unit LayerNorm and BatchNorm parameters and running statistics, in
   bf16 and as MLX 8-bit in groups of 64 quantized on the card (the
   prediction embedding and the joint's three products included):
   ``bench_parakeet_batch``'s protocol on the bf16 model (8 x 30 s of
   seeded noise through ``generate_batch``, one warm run and three timed,
   every run's lattice bit for bit the same; RTFx, the frontend, encoder and
   decode-loop split, decode steps, host reads and device events a step,
   the loop's busy share and the peak device memory); a mixed batch (the
   speech and two-speaker clips, 12 s and 30 s of noise) whose steps between
   stop reads run under ``torch.cuda.set_sync_debug_mode("error")``, each
   row's decisions against that row decoded alone over the same features,
   and one row alone against the serial host reference of
   tests/test_parakeet.py, each equal or parted at a witnessed near tie (the
   reference route's top two within the routes' joint-logit difference at
   that step); on the 8-bit tree kernel 7 against its plain version at the
   joint's three shapes at 1 and 8 rows, a ``generate_batch`` with the
   counters reset just before and read just after (the tile exactly 3 times
   a decode step, no decode kernel, no GEMV, no plain call, no dequantized
   joint; the packed embedding's LSTM state in f32), the lattice against
   kernel 7's plain version on the same features, and its RTFx; then a 60 s
   clip through ``generate`` in 20 s chunks (one batch, merged; segment
   starts rise). ``python3 chip_smoke.py --parakeet`` runs it alone.
21. ``[vad]`` (run fourth, after phase 20; no kernel of the port runs
   there, and the counters must stay at 0): Silero v5 (both branches, the
   checkpoint's shapes, the STFT conv the Hann-windowed DFT basis) and
   Sortformer-4spk (an 18 x 512 FastConformer over 128 mels, an 18 x 192
   transformer, spkcache and FIFO of 188) from seeded random weights in
   f32, under PyTorch's default cuDNN flags so that the models' own guard
   keeps their convolutions in f32: ``bench_vad_silero``'s protocol (30 s
   of seeded noise through ``predict_proba``, a warm-up, the fastest of 3
   walls) at 16 kHz and decimated to 8 kHz, 4 rows against each alone,
   ``feed`` over all 938 chunks against ``predict_proba`` (1e-5), the card
   against the port's CPU run (SILERO_CARD_ATOL), timestamps and speech runs
   of the two media clips equal to the CPU's, device events, host ms and
   busy share a chunk; ``bench_vad_diarization``'s protocol (the same noise
   through ``generate_stream`` in 5 s chunks), the stream reaching the AOSC
   compression (spkcache and FIFO lengths a chunk), each chunk held against
   the port's CPU run from the card's state before it (speaker
   probabilities within SORTFORMER_CARD_ATOL, state lengths, AOSC picks
   equal or parted at a witnessed near tie), per-chunk host ms, device ms
   and events, the encoder's device ms against its bound, the peak device
   memory, and offline ``generate`` on the two-speaker clip against the CPU
   (segments and RTTM). A control runs each model with the guard bypassed
   (convolutions in TF32) and must land outside its card-against-CPU limit.
   ``python3 chip_smoke.py --vad`` runs it alone.
22. ``[vad turn lid]`` (run fifth, after phase 21): FSMN VAD at
   ``FSMNVADConfig()`` (FunASR fsmn-vad's topology) with a seeded CMVN,
   SmartTurn at ``SmartTurnConfig()`` (384 x 4 layers, 8 s) and ECAPA-TDNN
   LID at ``bench_lid``'s voxlingua107 geometry (1,024 channels, 107
   languages), from seeded random weights in f32 under PyTorch's default
   cuDNN flags, on a 30 s signal of the two media clips: FSMN's ``scores``
   and ``detect`` against the CPU (segments equal); SmartTurn's
   ``predict_endpoint`` on the last 8 s, on 3 s (left-padded) and at 8 kHz,
   each with kernel 1 launched exactly once (the counters reset just before
   and read just after, and one kernel-1 launch in a marked profiler
   window), against the CPU, batch against each alone, and kernel 1 at the
   path's 800 x 201 x 80 shape against its plain version and timed; ECAPA's
   ``predict`` by ``bench_lid``'s protocol (10 s, the fastest of 5) against
   the CPU, ``predict_batch`` over three length buckets and a 35 s clip
   against the CPU's and each solo ``predict``; the ``lid`` route alone and
   with six concurrent requests through the micro-batcher, the ``vad``
   route on FSMN; walls, device ms and events, bounds, peak memory. Each
   model's card-against-CPU limit must lie below its TF32 control
   (``tf32_leak``). ``python3 chip_smoke.py --turn-lid`` runs it alone.
23. ``[sts]`` (run sixth, after phase 22; no kernel of the port runs there,
   and the counters must stay at 0): DeepFilterNet3 at
   ``DeepFilterNetConfig()``'s widths (64 channels, 32 ERB bands, 96 deep-filter
   bins, hidden 256, fft 960 / hop 480 at 48 kHz, order 5, lookahead 2; GRU
   layers 1, 2 and 2; grouped linears in 4 groups) from seeded random weights
   in f32 under PyTorch's default cuDNN flags: ``bench_deepfilternet``'s
   protocol (10 s of seeded noise x 0.1 through ``enhance``, a warm-up, the
   fastest of 3 walls: the RTF) and the 2 s noisy clip, each against the
   port's CPU run (STS_CARD_ATOL, below the TF32 control), at most 1% of the
   samples at +-1 and the ERB gains not all within 1e-3 of 0 or 1; one call's
   device ms and events in a marked window, the bound; the streamer over the
   10 s in chunks of 16 hops, every chunk's hops under
   ``torch.cuda.set_sync_debug_mode("error")``, within 5e-4 of the card's
   offline output, the 2 s clip in the JAX test's chunk sizes, the length of
   ``enhance_streaming``'s output, host ms a hop against the 10 ms hop, one
   chunk's device ms, events and busy share; ``/v1/audio/enhance`` alone and
   with four concurrent requests and ``cli/sts.py`` in ``short`` and
   ``stream`` modes, each equal to ``enhance``'s PCM16 samples (the stream
   within 5e-4); the peak device memory. ``python3 chip_smoke.py --sts`` runs
   it alone.
24. ``[vyvo]`` (run seventh, after phase 23): VyvoTTS (Qwen3 + SNAC) on the
   backbone of Qwen's published Qwen3-0.6B config (1,024 x 28 layers, 16 / 8
   heads of 128, ffn 3,072, q/k norms, tied embeddings), its vocabulary
   widened by the 7 x 4,096 audio codes to 180,352 ids, random weights from
   seed 0 (the audio band's embedding rows scaled up, so that greedy decoding
   emits codes), with the SNAC 24 kHz codec. MLX 4-bit (g 64, quantized on
   the card): greedy ``generate`` twice and ``generate_stream`` once, each
   with the counters reset just before and read just after (kernel 7's tile
   4 x 28 + 1 times for the prefill, its decode kernel 113 times a step, no
   GEMV, no other kernel, no plain call; tokens and waveform repeat); the
   model cut to 4 layers, teacher-forced logits card against CPU under
   VYVO_CARD_RTOL and its TF32 control; TTFB, ms a token, device ms and
   events (``bench_tts_ttfb``'s protocol); ``core.generation.pcm_stream`` at
   16 kHz against one ``PCMStreamConverter`` pass over the same streamed
   audio, within one int16 step; ``ContinuousTTS`` at 4 slots on
   the plain tick, each request's tokens its solo run's. bf16: one greedy
   ``generate`` and its TTFB and ms a token. Then checkpoints written and
   loaded through ``VyvoTTS.from_pretrained(quantize_bits="w8a8")``: 2 layers
   at Qwen3-1.7B's widths decode through kernel 5 (held to its plain version
   at two offsets, 9 launches a layer, one launch a greedy token), kernel 6
   at 4 lanes bit-equal to kernel 5 lane by lane and two requests served on
   the fused tick with their solo tokens; 2 layers at Qwen3-0.6B's widths,
   which kernel 5 does not take, raise ``NotImplementedError``.
   ``python3 chip_smoke.py --vyvo`` runs it alone.
25. ``[whisper kvq]`` (after phase 6, on the whisper-large-v3 models): the
   quantized self caches through ``Whisper.generate`` (KVQ_ROUTES: int8,
   hybrid with the split 8 rows past the prompt, int4 on the bf16 tree, int8
   on the w8 tree), 16 tokens a window, on the 30 s window twice and on 4
   long-form windows batched, each run with the counters reset just before
   and read just after: kernel 2 32 times a step at 8 bits and none at 4,
   kernel 1 once a window, no fused stack, no plain call, tokens repeating;
   every self-cache row the card wrote equal to ``_quantize`` on the CPU of
   the rows it computed, bit for bit, on both sides of the hybrid split; the
   teacher-forced logits' largest gap from the dense route (the quantisation
   error, recorded); 4 decoder layers in f32 card against CPU under
   KVQ_CARD_RTOL, below a bf16 control (the TF32 control recorded: one-row
   products are GEMVs, which TF32 does not round; on the w8 tree the CPU is
   fed the card's int8 activation codes, each differing code a boundary
   flip); host and device ms, events, cache bytes and peak memory of a step
   over a 448-row cache beside the bf16 kv8d step's. ``python3 chip_smoke.py
   --kvq`` runs it alone.
26. ``[qwen3 asr]`` (run eighth, after phase 24): Qwen3-ASR with the JAX
   package's default audio tower (1,280 x 32 layers, 20 heads, ffn 5,120,
   128 mels, 800-frame windows) and a Qwen3-1.7B text decoder at full depth
   (2,048 x 28 layers, 16 / 8 heads of 128, ffn 6,144, vocabulary 151,936,
   tied, q/k norms), random weights from seed 0 packed to MLX 4-bit (g 64)
   on the card by ``quant.quantize_tree``'s predicate, a stub tokenizer with
   Qwen3's special ids. Kernel 1 at the frontend's 201 bins x 128 HTK mels
   and kernel 7 at the decoder's shapes (the decode kernel at 1 row, the
   tile at a one-second pass's prefill) against their plain versions;
   greedy ``generate`` on 20 s twice, the counters reset just before and
   read just after (kernel 1 once, the decode kernel 4 x 28 + 1 times a
   step, no tile: the 276-row prefill dequantizes; no GEMV, no plain call;
   tokens repeating), time to first token and RTF; a decode chunk's host
   and device ms, events and kernel 7's device ms a token against its
   bound; 4 audio and 4 text layers in f32 card against CPU (features,
   merged embeddings, 4 forced steps' logits) under ASR_CARD_RTOL and each
   one's TF32 control; ``StreamingInferenceSession`` over 10 s at 1 s
   feeds on a clock that moves 1 s a feed (kernel 1 once a ``process`` that
   yields frames, the tile on every pass whose prefill has 64 rows or
   fewer, the first pass among them, a window finalized); four requests
   through ``ContinuousQwen3ASR`` at 4 slots, each request's tokens its
   solo decode's or parted at a witnessed near tie; the peak device memory.
   ``python3 chip_smoke.py --qwen3-asr`` runs it alone.
27. ``[moss]`` (run after ``[cohere]``): MOSS-Transcribe-Diarize with the
   Whisper encoder that ``MossTranscribeDiarizeConfig.from_dict`` falls back
   to (1,024 x 24 layers, 16 heads, ffn 4,096, 80 mels) and ``[qwen3
   asr]``'s Qwen3 decoder (``LlamaConfig()``'s vocabulary cannot hold
   MOSS's token ids), random weights from seed 0 packed to MLX 4-bit (g 64)
   on the card, a stub tokenizer with the ChatML, audio and digit ids.
   Kernel 1 on a 30 s window and kernel 7's decode kernel at each packed
   decoder product against their plain versions; greedy ``generate`` on
   30 s and 65 s (three windows, 813 audio rows with digit markers every
   5 s) twice each with the counters reset just before and read just after
   (kernel 1 once a window, the decode kernel 113 times a step, no tile, no
   plain call; tokens repeating; where each loop stopped); a decode token's
   host and device ms and kernel 7's share against its bound, the
   encoder's and the prefill's device ms; 4 + 4 layers in f32 card against
   CPU (the adaptor's output, step logits) under MOSS_CARD_RTOL and its
   TF32 control, greedy tokens equal or parted at a witnessed near tie;
   the streaming session over 10 s at 1 s feeds (every pass capped here at
   MOSS_STREAM_TOKENS); one ``/v1/audio/transcriptions`` request through
   ``serve --slots 2`` (no engine); the peak device memory. ``python3
   chip_smoke.py --moss`` runs it alone.
28. ``[wav2vec2]`` (run after phase 27; no kernel of the port runs there):
   ``cli/stt.py`` under ``TPU_AUDIO_PROFILE`` on a 2-layer full-width
   checkpoint it writes (the trace holds its label and CUDA kernels); then
   wav2vec2 at ``Wav2Vec2Config()``'s widths (1,024 x 24 layers, the
   7-layer 512-channel frontend, stable LN, CTC vocabulary 32) with a
   126-label LID head on the same trunk, random weights from seed 0 in f32:
   ``generate`` on 30 s twice (1,499 frames, no kernel launched) and
   ``predict``'s top 5; 4 layers card against CPU (CTC and LID logits under
   W2V_CARD_RTOL and their TF32 controls, the text and top 5 equal);
   ``serve --task lid`` (no batcher: ``predict`` under the lock) and
   ``--task stt``, one request each; the peak device memory. ``python3
   chip_smoke.py --wav2vec2`` runs it alone.

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
The last twenty-one lines of output are JSON: the generate runs, the
long-form results, the serving results, the TTS results, the TTS serving
results, the MLX 4-bit results, the Qwen3-TTS results (its serving under
``serve``, cloning under ``clone``), the Parakeet results, the VAD results,
the FSMN / SmartTurn / LID results, the enhancement results, the Mimi
results, the quantized self caches' results, the VyvoTTS results, the
Qwen3-ASR results, the Cohere results, the MOSS results, the wav2vec2
results, each phase's seconds, the kernels' records (kernels 1 and 7's with
Qwen3-ASR's, ``qwen3_asr_launches`` and ``qwen3_asr``, Cohere's and MOSS's,
``cohere_launches``, ``cohere``, ``moss_launches`` and ``moss``; kernel 2's with its quantized-cache launches,
``kvq_launches`` and ``kvq_launches_per_step``; kernels 5, 6 and 7's with
VyvoTTS's, ``vyvo_launches``, ``vyvo_layer_launches`` and ``vyvo``; kernel 7's with its Qwen3 launches,
``qwen3_launches`` and ``qwen3``, and its serving ones,
``qwen3_serve_launches`` and ``qwen3_serve``; kernel 1's with SmartTurn's,
``smart_turn_launches`` and ``smart_turn``, and the speaker mel's,
``speaker_mel_launches`` and ``speaker_mel``), then ``{"ok": true,
"device": {...}}``. Without a CUDA device, or outside the repository, it
exits non-zero before printing any of them.
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
# LONG_BF16_TOKENS tokens each (cut: their step is host-bound, ~40 ms; 4
# windows before, 24.0 s of the phase). LONG_TOKENS cut to 112 (224 before)
# to keep the full run in its budget
LONG_WINDOWS, LONG_TOKENS = 8, 112
LONG_BF16_WINDOWS, LONG_BF16_TOKENS = 2, 32
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
TTFB_CHUNK, TTFB_BUCKET, TTFB_REPEATS = 28, 64, 2  # bench_tts_ttfb's protocol (3 repeats before)
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
# the 4-bit generate's budget (8 frames; 16 before, TTS_TOKENS before that:
# host bound at ~40-57 ms a token), its repeat and the stream, held to the
# first run's on the prefix
Q4_TOKENS = 56
Q4_REPEAT_TOKENS = 42  # 6 frames (70 before)
Q4_SERVE_SLOTS, Q4_SERVE_MAX_TOKENS = 4, 21  # 3 frames a request (35 before)
Q4_SERVE_TEXTS = TTS_SERVE_TEXTS[:4]
Q4_WHISPER_TOKENS = 24
Q4_PROFILE_TOKENS = 8  # ~1,600 device events a token: a short profiled chunk
# Qwen3-TTS (BASELINE.json:11: 0.6B, MLX 8-bit, streaming), the [qwen3 tts]
# phase: the talker's vocabulary reaches past codec_bos_id 4197, as a
# checkpoint's does (bench.py:536-540; the bare default of 4096 is the EOS id
# itself); greedy runs of QWEN3_FRAMES frames (0.96 s of audio; 40, then 20
# before)
QWEN3_VOCAB = 4198
QWEN3_TEXT = TTS_TEXT
QWEN3_FRAMES = 12
QWEN3_TEACHER_FRAMES = 6
# teacher-forced logits, kernel 7 against its plain version: the prompt and
# the first talker step run in bf16, where a product's bf16 rounding may
# flip between the two versions' f32 sums and move every later logit, as on
# Whisper's bf16 routes (LOGITS_RTOL); the code predictor runs in f32
QWEN3_LOGITS_RTOL = 3e-2
# the codec's streaming chunks against its offline decode: f32 convolutions
# (TF32 off) over other lengths, summed in another order
QWEN3_STREAM_ATOL = 1e-4
# bench_qwen3_tts_ttfb's protocol (bench.py:763-876): a 32-row random
# prefix, a first chunk of 12 frames (0.96 s of audio)
QWEN3_TTFB_PREFIX, QWEN3_TTFB_FRAMES = 32, 12
QWEN3_PROFILE_FRAMES = 4
# [qwen3 serve]: ContinuousQwen3TTS on the 8-bit tree. Six staggered greedy
# requests (each its own max_tokens, in frames) through 4 slots, a chunk of
# audio every QWEN3_SERVE_CHUNK seconds of frames; the tile's rows at every
# lane count up to 8 (n for the talker and passes 1..14, 2n for pass 0).
# Each request has its own voice, an instruction (the config is
# voice_design) that leads its prompt: no request runs far enough to reach
# its text (the trailing embeds start with the ChatML header's last bytes),
# so the voices make the prompts, their lengths and their left padding
# differ. Each prompt stays within the 64-row bucket (the prefill's tile).
QWEN3_SERVE_SLOTS = 4
QWEN3_SERVE_TEXTS = TTS_SERVE_TEXTS
QWEN3_SERVE_VOICES = ("Speak slowly.", "A calm, low voice.", "Bright and cheerful.",
                      "Whisper.", "An old man, tired, hoarse.", "Read it like the news.")
QWEN3_SERVE_FRAMES = (6, 9, 5, 8, 7, 6)
QWEN3_SERVE_CHUNK = 0.4  # 5 frames
QWEN3_LANE_ROWS = tuple(sorted(set(range(2, 9)) | {2 * n for n in range(2, 9)}))
# bench_qwen3_serving's protocol (bench.py:513-596): T 0.9, top-k 50,
# max_new = ticks + 4, audio at the flush only, prefill bucket 64, two warm
# ticks then 8 timed; at 4 and 8 slots every lane live, and one live lane in
# the 4-slot engine as the single stream
QWEN3_THROUGHPUT_SLOTS = (4, 8)
QWEN3_TIMED_TICKS = 8
QWEN3_BENCH_TEXT = "the quick brown fox jumps over the lazy dog " * 2
QWEN3_HTTP_FRAMES = 8
# [qwen3 clone]: voice cloning on the [qwen3 tts] 8-bit model (not built
# again), with a speaker encoder at SpeakerEncoderConfig() (128 mels,
# channels 512 x 4 and 1,536, embedding 1,024 = the talker's width) and the
# speech tokenizer's encoder at encoder_config_from_dict({}) (Mimi's encoder:
# SEANet 64 filters, ratios 8/6/5/4, 8 x 512 transformer with a 250-frame
# window, 32 quantizers of 2,048 x 256, 16 valid; 24 kHz to 12.5 Hz), both
# random from seed 0 in f32; a 5 s reference of the speech signal at 24 kHz
CLONE_REF_S = 5.0
CLONE_REF_TEXT = "A reference clip of speech, five seconds long."
# card against CPU, relative to the largest value: the speaker embedding, and
# the encoder's latent before the RVQ (f32 sums in another order; the mel
# through kernel 1 and cuFFT); each under its TF32 control's reading
CLONE_EMBED_RTOL = 1e-4
CLONE_LATENT_RTOL = 1e-4
# [mimi]: Mimi at mimi_202407(16), random from seed 0 in f32; 10 s of the
# speech signal at 24 kHz offline; decode_step over the offline codes in
# uneven chunks of these frame counts, cycled; encode_step over uneven
# chunks of these sample counts, cycled; a frame-by-frame stream of
# MIMI_STREAM_FRAMES frames timed
MIMI_SECONDS = 10.0
MIMI_DECODE_CHUNKS = (1, 3, 2, 7, 5, 11)
MIMI_ENCODE_CHUNKS = (1000, 4001, 777, 24000, 9600, 1919)
MIMI_STREAM_FRAMES = 25
# the waveform card against CPU and streamed against offline, relative to
# its largest sample (the JAX package's streaming test holds 1e-4 absolute
# on a fixture whose samples stay below 0.01)
MIMI_CARD_RTOL = 1e-4
MIMI_STREAM_RTOL = 1e-4
# the [parakeet] phase: Parakeet-TDT-0.6B at its published widths (24 x 1024
# FastConformer, subsampling 8, 1,024 pieces + blank, durations 0-4, a
# 640-wide LSTM prediction network and joint), bench_parakeet_batch's
# protocol: 8 clips of 30 s seeded noise, one warm batch and 3 timed
PARAKEET_CLIPS, PARAKEET_CLIP_S, PARAKEET_TIMED = 8, 30.0, 3
PARAKEET_MIXED_NOISE_S = (12.0, 30.0)  # beside the speech and two-speaker clips
PARAKEET_LONG_S, PARAKEET_CHUNK_S = 60.0, 20.0  # chunked generate: 4 chunks, 2 s overlap
# two routes' joint logits at a step where their lattices part, relative to
# the largest: bf16 products rounded by row count (cuBLAS) or by route
# (kernel 7 against its plain version), as LOGITS_RTOL
PARAKEET_LOGITS_RTOL = 3e-2
BF16_GENERATE_TOKENS = 96  # the bf16 kv8d Whisper generate's budget (448, 224, 192 before)
# the [vad] phase: bench_vad_silero's and bench_vad_diarization's protocol,
# 30 s of seeded noise x 0.1, a warm-up and the fastest of 3 walls; Silero
# also as 4 rows; Sortformer's stream in 5 s chunks
VAD_SECONDS, VAD_TIMED, VAD_ROWS = 30.0, 3, 4
SORTFORMER_CHUNK_S = 5.0
SILERO_FEED_ATOL = 1e-5    # feed against predict_proba, rows against alone (tests/test_vad.py)
# card against the port's CPU run, between the sound readings (Silero 1.2e-7,
# Sortformer <= 8.6e-7) and the TF32 control's (tf32_leak), which vad_phase
# checks lies above each limit
SILERO_CARD_ATOL = 2e-6      # Silero's probabilities
SORTFORMER_CARD_ATOL = 1e-5  # Sortformer's speaker probabilities
# the [vad turn lid] phase: FSMN VAD, SmartTurn and ECAPA-TDNN LID from seeded
# random weights in f32, FSMN and SmartTurn at the JAX package's defaults,
# ECAPA at bench_lid's voxlingua107 geometry (bench.py:1042); a 30 s signal of
# the two media clips with a second of zeros after each, repeated
TURN_LID_SECONDS = 30.0
FSMN_SIL_QUANTILE = 0.5  # the silence bias puts this quantile of frames at the speech threshold
FSMN_SIL_STEPS = 8
ECAPA_GEOMETRY = dict(channels=1024, embed_dim=256, classifier_hidden_dim=512, num_classes=107,
                      input_size=60, res2net_scale=8, se_channels=128, attention_channels=128)
ECAPA_SECONDS, ECAPA_TIMED = 10.0, 5  # bench_lid's clip; the fastest of 5 walls
ECAPA_BATCH_S = (3.0, 7.0, 10.0, 35.0)  # buckets of 4, 8 and 16 s, and predict past 30 s
LID_HTTP_S = (1.0, 2.0, 4.0, 8.0, 2.0, 4.0)  # concurrent requests, each filling its bucket
SMART_TURN_TIMED = 5
# card against the port's CPU run, between the sound readings and the TF32
# controls' (tf32_leak), which turn_lid_phase checks lie above each limit
# FSMN's scores: 1.0e-5 read against a TF32-matmul control of 2.8e-2; its
# depthwise memory convolutions take no TF32 path (the conv-only control read
# the sound 1.0e-5), so its control is the one with TF32 matmuls too
FSMN_CARD_ATOL = 1e-4
SMART_TURN_CARD_ATOL = 1e-6  # SmartTurn's probability: 6.0e-8 read, TF32 control 1.5e-5-2.2e-5
ECAPA_CARD_ATOL = 1e-5       # ECAPA's probabilities: <= 3.8e-6 read, TF32 control >= 6.7e-5
SMART_TURN_BATCH_ATOL = 1e-5  # batched rows against each alone (tests/test_smart_turn.py)
# a padded batched row against its solo predict: the same top-1, its
# confidence within ECAPA_SOLO_ATOL. The JAX package's predict_batch, which
# the port matches within 1e-5 on the CPU, masks the pooling but not the SE
# blocks' time means, so the padding moves a row further than the
# convolutions' edges do: 0.120 / 0.013 / 0.150 on this random model at 3 /
# 7 / 10 s (0.032 / 0.006 / 0.010 with masked SE means, on the CPU at 256
# channels); tests/test_ecapa.py's 0.05 holds on its narrow fixture only. A
# clip that fills its bucket: that test's 1e-4
ECAPA_SOLO_ATOL, ECAPA_FILLED_ATOL = 0.25, 1e-4
# the [sts] phase: DeepFilterNet3 at DeepFilterNetConfig()'s widths from seeded
# random weights (f32), bench_deepfilternet's protocol (bench.py:1101-1206): 10 s
# of seeded noise x 0.1, a warm-up and the fastest of 3 walls; the streamer in
# chunks of 16 hops (the JAX streamer's scan_block); the 2 s noisy clip
NOISY = ROOT / "tests" / "media" / "noisy_48k.wav"
STS_SECONDS, STS_TIMED, STS_BLOCK = 10.0, 3, 16
STS_HTTP_S = (2.0, 3.0, 2.5, 1.5)  # concurrent enhance requests (seconds of the noise)
STS_STREAM_ATOL = 5e-4  # the streamer against offline (tests/test_deepfilternet.py's)
# card against the port's CPU run (enhance's samples), between the sound readings
# and the TF32 control's (tf32_leak), which sts_phase checks lies above it
STS_CARD_ATOL = 1e-4
STS_SATURATED = 0.01  # at most this share of output samples at +-1
STS_HOP_BUDGET_MS = 10.0  # a 480-sample hop at 48 kHz
# the [whisper kvq] phase: the quantized self-cache routes of Whisper.generate
# (name, model, knobs): an int8 self cache beside kernel 2's int8 cross K/V, a
# hybrid one (dense below the prompt + 8 rows), int4 self cache and cross K/V
# (dequantized, no kernel 2), and int8 on the w8 decoder; KVQ_TOKENS greedy
# tokens a window, on the 30 s window and on KVQ_WINDOWS long-form windows
KVQ_TOKENS, KVQ_WINDOWS = 16, 4
KVQ_ROUTES = (("int8", "bf16_kv8d", dict(kv_bits=8, quantized_kv_start=0)),
              ("hybrid8", "bf16_kv8d", dict(kv_bits=8, quantized_kv_start=len(PROMPT) + 8)),
              ("int4", "bf16_kv8d", dict(kv_bits=4, quantized_kv_start=0)),
              ("w8 int8", "w8_kv8d", dict(kv_bits=8, quantized_kv_start=0)))
# card against CPU: the route cut to KVQ_CARD_LAYERS decoder layers in f32,
# teacher-forced logits relative to their max (on the w8 tree with the CPU fed
# the card's int8 activation codes). Card and CPU round a few K/V values to
# neighbouring codes (one int4 step is a fifteenth of its group's range), read
# at 3.0e-5 (hybrid) to 1.02e-3 (int4) on an NVIDIA H100 80GB HBM3 at 700 W;
# the bf16 control (the same card run in bf16, the deployed dtype) read 8.7e-3
# to 6.2e-2 and must lie above the limit. A step's products are one-row GEMVs,
# which TF32 does not round: its control reads within 3x of the sound run and
# is recorded, not held
KVQ_CARD_LAYERS = 4
KVQ_CARD_RTOL = 3e-3
# a step timed over a self cache of the decode's full capacity, after
# KVQ_TIMED_WARM steps (each layer dequantizes its whole capacity a step)
KVQ_TIMED_CAPACITY = 448
KVQ_TIMED_WARM, KVQ_TIMED_STEPS = 3, 5
# the [vyvo] phase: VyvoTTS on the backbone of Qwen's published Qwen3-0.6B
# config.json (hidden 1,024, 28 layers, 16 / 8 heads of 128, ffn 3,072, rope
# theta 1e6, RMSNorm eps 1e-6, tied embeddings, q/k norms), its vocabulary of
# 151,679 ids widened by the 7 x 4,096 audio codes of VYVO_TOKENS and padded
# to 180,352; no VyvoTTS config.json is in the repository
VYVO_06B = dict(vocab_size=180352, hidden_size=1024, num_hidden_layers=28,
                intermediate_size=3072, num_attention_heads=16, num_key_value_heads=8,
                head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=True,
                qk_norm=True, max_position_embeddings=40960)
# random weights: the audio band's embedding rows scaled up, so that greedy
# decoding emits audio codes (the band is 16% of the vocabulary)
VYVO_BAND_SCALE = 2.0
VYVO_GENERATE_TOKENS = 70  # 10 frames a greedy generate (14 before)
VYVO_REPEAT_TOKENS = 42  # its repeat and stream, held to it on the prefix
VYVO_SERVE_TOKENS = 14  # a served request's
VYVO_CARD_LAYERS, VYVO_TEACHER_STEPS = 4, 4  # 8 steps before
# teacher-forced logits of the 4-bit model, card against CPU, relative to
# their max; the TF32 control (kernel 7's plain version on the card, its f32
# products in TF32) must read above it
VYVO_CARD_RTOL = 1e-3
VYVO_SERVE_SLOTS = 4
# w8a8 trees written as checkpoints and loaded through VyvoTTS.from_pretrained:
# 2 layers at Qwen3-1.7B's published widths (hidden 2,048 = 16 x 128, 8 KV
# heads, ffn 6,144), the smallest Qwen3 kernel 5 takes, and 2 layers at
# Qwen3-0.6B's, which it does not (16 x 128 != 1,024); a small vocabulary
# with its token table in config.json
VYVO_SMALL_TABLE = dict(vocab_size=28704, start_of_human=1, end_of_human=2, end_of_text=3,
                        start_of_speech=4, end_of_speech=5, pad_token=0, audio_start=6,
                        audio_end=7, audio_token_offset=10, codebook_size=4096)
VYVO_17B_W8 = dict(hidden_size=2048, num_hidden_layers=2, intermediate_size=6144,
                   num_attention_heads=16, num_key_value_heads=8, head_dim=128,
                   rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=True)
VYVO_06B_W8 = dict(VYVO_17B_W8, hidden_size=1024, intermediate_size=3072)
VYVO_W8_TOKENS = 14
# [qwen3 asr]: Qwen3-ASR with the JAX package's AudioEncoderConfig() audio
# tower (tpu_audio/models/stt/qwen3_asr.py:99-111: 1,280 wide, 32 layers, 20
# heads, ffn 5,120, 128 mels, n_window 50, n_window_infer 800, output 2,048)
# and a text decoder at Qwen3-1.7B's widths and depth, whose hidden width is
# that output (VYVO_17B_W8's widths at 28 layers, vocabulary 151,936, tied,
# q/k norms): the JAX defaults plus Qwen3-1.7B, as no Qwen3-ASR config.json
# is in the repository; seed-0 random weights packed to MLX 4-bit (g 64)
ASR_TEXT = dict(VYVO_17B_W8, num_hidden_layers=28, vocab_size=151936, qk_norm=True,
                max_position_embeddings=40960)
ASR_SECONDS = 20.0  # the offline clip and the serving window
ASR_TOKENS = 24  # a greedy generate's (random weights emit no <|im_end|>)
ASR_TTFT_REPEATS = 3
ASR_PROFILE_TOKENS = 8
ASR_CARD_SECONDS = 8.0  # one whole window
ASR_CARD_LAYERS, ASR_TEACHER_STEPS = 4, 4
# encoder features, merged embeddings and step logits of the 4 + 4 layer f32
# model, card against CPU, relative to their max; each TF32 control (the
# plain versions, TF32 products and convolutions) must read above it. The
# controls read 9.6e-4 (features, embeddings) and 1.03e-3 (logits) on an
# H100, at VyvoTTS's 1e-3, which therefore would not tell a TF32 leak; the
# card reads 1.3e-6 and 1.1e-5
ASR_CARD_RTOL = 1e-4
ASR_STREAM_SECONDS, ASR_STREAM_TOKENS = 10.0, 6
ASR_SERVE_SLOTS, ASR_SERVE_TOKENS = 4, 8  # one 8-step tick a request (10 before)
ASR_SERVE_SECONDS = (20.0, 13.0, 6.5, 2.5)
# [qwen3 align] (inside [qwen3 asr], on its model): the forced aligner's
# timestamp head at the JAX default classify_num, seed 0, MLX 4-bit g 64; a
# 20 s clip of 12 words (a ~300-row prompt: its products dequantize) and a
# 2 s clip of 4 words (a 64-row bucket: kernel 7's tile)
ALIGN_CLASSES = 5000
ALIGN_LONG = (20.0, ("the", "quick", "brown", "fox", "jumps", "over", "the", "lazy", "dog",
                     "and", "runs", "away"))
ALIGN_SHORT = (2.0, ("hello", "world", "quick", "fox"))
# classifier logits of the 4 + 4 layer f32 aligner, card against CPU,
# relative to their max; the TF32 control must read above it
ALIGN_CARD_RTOL = 1e-4
# [cohere]: CohereConfig()'s widths (no Cohere config.json is in the
# repository), seed 0, bf16 and MLX 4-bit g 64 packed on the card
COHERE_SECONDS = 30.0  # one chunk (max_audio_clip_s): 400 encoder rows
COHERE_SHORT_SECONDS = 3.0  # one 400-frame bucket: 50 encoder rows, cross K/V on the tile
COHERE_TOKENS = 24  # a greedy generate's (random weights emit no eos)
COHERE_PROFILE_TOKENS = 8
COHERE_CARD_SECONDS = 8.0
COHERE_CARD_ENC_LAYERS, COHERE_CARD_DEC_LAYERS, COHERE_CARD_TOKENS = 4, 2, 6
# features, encoder output and step logits of the 4 + 2 layer f32 model,
# card against CPU, relative to their max; each TF32 control must read above.
# The features' control (TF32 in the filters' product alone) reads ~1.5e-4,
# so their limit sits lower, as far above their sound reading (~5e-6)
COHERE_CARD_RTOL = 1e-4
COHERE_FEATURES_RTOL = 5e-5
COHERE_STREAM_SECONDS, COHERE_STREAM_TOKENS = 10.0, 6
COHERE_HTTP_SECONDS, COHERE_HTTP_POSITIONS = 4.0, 64
# the stub tokenizer's special ids (the real table is in tokenizer_config.json)
COHERE_SPECIALS = {"<|endoftext|>": 3, "<|startofcontext|>": 7, "<|startoftranscript|>": 4,
                   "<|emo:undefined|>": 16, "<|en|>": 62, "<|pnc|>": 5, "<|nopnc|>": 6,
                   "<|noitn|>": 9, "<|notimestamp|>": 11, "<|timestamp|>": 10,
                   "<|nodiarize|>": 13}
# [moss]: MOSS-Transcribe-Diarize. No MOSS config.json is in the repository:
# the audio widths are those MossTranscribeDiarizeConfig.from_dict falls back
# to (24 x 1,024, 16 heads, ffn 4,096, 80 mels, 1,500 positions) and the text
# decoder is ASR_TEXT's Qwen3 (28 x 2,048, vocabulary 151,936, q/k norms), as
# LlamaConfig()'s 128,256 rows cannot hold MOSS's token ids; the adaptor maps
# 4 x 1,024 -> 2,048 -> 2,048. Seed 0, bf16, MLX 4-bit g 64 packed on the card
MOSS_AUDIO = dict(num_mel_bins=80, d_model=1024, encoder_layers=24, encoder_attention_heads=16,
                  encoder_ffn_dim=4096, max_source_positions=1500)
MOSS_SECONDS = (30.0, 65.0)  # one Whisper window; three (375 + 375 + 63 audio rows)
MOSS_TOKENS = 24  # a greedy generate's budget (random weights emit no EOS)
MOSS_PROFILE_TOKENS = 8
MOSS_CARD_SECONDS = 8.0
MOSS_CARD_LAYERS, MOSS_CARD_TOKENS = 4, 6
# adaptor output and step logits of the 4 + 4 layer f32 model, card against
# CPU, relative to their max; each TF32 control must read above it
MOSS_CARD_RTOL = 1e-4
# the session's passes are capped here (its final passes take no cap in the
# port, as in the JAX package, and random weights emit no EOS)
MOSS_STREAM_SECONDS, MOSS_STREAM_TOKENS = 10.0, 8
MOSS_HTTP_SECONDS = 6.0
# [wav2vec2]: Wav2Vec2Config()'s widths (24 x 1,024, 16 heads, ffn 4,096, the
# 7-layer 512-channel frontend, layer-norm frontend, stable LN, CTC vocabulary
# 32) with a LID head of MMS-LID-126's 126 labels on the same trunk; seed 0,
# f32, TF32 off
W2V_SECONDS = 30.0
W2V_LABELS = 126
W2V_CARD_SECONDS, W2V_CARD_LAYERS = 8.0, 4
# CTC and LID logits of the 4-layer f32 model, card against CPU, relative to
# their max; each TF32 control must read above it
W2V_CARD_RTOL = 1e-4
W2V_TRACE_LAYERS, W2V_TRACE_SECONDS = 2, 5.0  # the maybe_trace checkpoint
# [vyvo]'s pcm_stream: tokens of the streamed generation, the output rate
PCM_TOKENS, PCM_RATE = 42, 16000
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


def fmt_share(share):
    return "not measured" if share is None else f"{share:.4f}"


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def build_models(dev, host_params=None):
    """whisper-large-v3 widths, random weights from seed 0: the w8 kv8d and
    bf16 kv8d models (one encoder and one bf16 decoder between them).
    ``host_params``, when given, is that seed-0 tree already drawn on the
    host (``W.init_params`` on the CPU: the same values), moved to the card
    here."""
    import torch

    from tpu_audio_torch.core import loading, quant
    from tpu_audio_torch.models.stt import whisper as W

    cfg = stack_config()
    params = (W.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
              if host_params is None else loading.to_device(host_params, dev))
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
    """Whisper.generate in both configurations, GENERATE_RUNS times each
    (the bf16 kv8d one to BF16_GENERATE_TOKENS tokens), with every launch
    counter reset just before and read just after."""
    import torch

    from tpu_audio_torch.ops import _lib

    outputs, runs = {}, []
    _lib.reset_launches()
    for cfg_name, model in models.items():
        p = (dataclasses.replace(gp, max_tokens=BF16_GENERATE_TOKENS) if cfg_name == "bf16_kv8d"
             else gp)
        for run in range(GENERATE_RUNS):
            before = dict(_lib.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(audio, p)
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def llama_check(name, model, kc, vc, x, off, vf, ties: bool = False) -> dict:
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
        # with ``ties``, llama_lanes_check's rule: several codes may flip at
        # once where an embedded int8 row's products land on .5 exactly, each
        # one step at a boundary
        check((ties or flip["codes"] == 1) and flip["step"] == 1
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """Phase 16's offline runs: ``generate`` (greedy, Q4_TOKENS tokens),
    again at Q4_REPEAT_TOKENS (its tokens the first run's prefix, its
    waveform bit for bit the decode of that prefix) and ``generate_stream``
    at Q4_REPEAT_TOKENS (the same prefix, the repeat's number of samples),
    each with the launch counters reset just before and read just after: kernel
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
    runs, first, short, launches = [], None, None, {}
    for run, (m, n, stream) in enumerate([(model, Q4_TOKENS, False),
                                          (model, Q4_REPEAT_TOKENS, False),
                                          (model, Q4_REPEAT_TOKENS, True),
                                          (full, Q4_FULL_TOKENS, False)]):
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
            first = (toks, wav, launches, all_tokens[:plen])
        check(toks == first[0][:len(toks)], "greedy tokens differ between runs")
        if run == 1:
            short = m._decode_codes(m.parse_output(first[3] + first[0][:len(toks)]))
        check(np.array_equal(wav, first[1]) if run == 0 else np.array_equal(wav, short)
              if not stream else wav.shape == short.shape, "waveform differs between runs")
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
        cache, last = q4_prefill(model, prompt, Q4_TOKENS)
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


def q4_ttfb_phase(model, label: str = "tts q4", ttfb: bool = True) -> dict:
    """bench.py's bench_tts_ttfb(quantize_bits=4) protocol on the band-head
    model: a 64-token prompt bucket, a TTFB_CHUNK-token chunk sampled at T
    0.6 and top-p 0.9 through ``llama.forward`` (kernel 7 for every
    projection and the head), then the SNAC decode of its 4 frames; the
    best of TTFB_REPEATS after a warm-up. Then ms a token (host clock, and
    device time), the busy share and a per-kernel breakdown of one
    Q4_PROFILE_TOKENS-token chunk, and the prefill's time alone. Without
    ``ttfb``, only the decode chunk's readings."""
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

    out = {}
    with torch.inference_mode():
        if ttfb:
            wav = first_audio(0)
            times = []
            for r in range(TTFB_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first_audio(r + 1)
                times.append(time.perf_counter() - t0)
            check(wav.shape == (1, TTFB_CHUNK // 7 * 4 * model.codec.config.hop_length)
                  and bool(np.isfinite(wav).all()), f"q4 ttfb waveform {wav.shape}")
            audio_s = wav.size / model.sample_rate
            prefills = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                q4_prefill(model, prompt, TTFB_CHUNK + 1, valid_from=0)
                torch.cuda.synchronize()
                prefills.append(time.perf_counter() - t0)
            out = dict(ttfb_ms=min(times) * 1e3, ttfb_all_ms=[t * 1e3 for t in times],
                       prefill_ms=min(prefills) * 1e3, first_audio_s=audio_s,
                       realtime_x=audio_s / min(times))
            print(f"[{label} ttfb] bucket {TTFB_BUCKET}, {TTFB_CHUNK}-token chunk (T 0.6, top-p "
                  f"0.9) + SNAC decode of {TTFB_CHUNK // 7} frames: TTFB {out['ttfb_ms']:.3f} ms "
                  f"(best of {[f'{t * 1e3:.3f}' for t in times]}), {audio_s:.4f} s of audio: "
                  f"realtime x {out['realtime_x']:.3f}; the 63-row prefill alone "
                  f"{out['prefill_ms']:.3f} ms")
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dec(*a)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = by_kernel(prof)
    busy_ms = sum(c[1] for c in kernels.values()) / 1e3
    n_events = sum(c[0] for c in kernels.values())
    k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]  # decode kernel, tile
    k7_ms, k7_n = sum(c[1] for c in k7) / 1e3, sum(c[0] for c in k7)
    out.update(ms_per_token=min(walls) * 1e3 / n, device_ms_per_token=busy_ms / n,
               kernel7_device_ms_per_token=k7_ms / n, kernel7_launches_per_token=k7_n / n,
               busy_share=busy_ms / prof_ms, device_events_per_token=n_events / n)
    print(f"[{label} decode] {n}-token chunk: {min(walls) * 1e3 / n:.4f} ms a token (best of 3, "
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


def build_qwen3(dev):
    """Qwen3-TTS at ``Qwen3TTSConfig()``'s widths (talker 20 x 1024, GQA
    16/8 x 128, ffn 3072; code predictor 4 x 1024, 16/8 x 64; 16 groups;
    the talker's vocabulary QWEN3_VOCAB) from seed-0 random weights on the
    card, with seeded non-unit RMSNorm weights and q/k/v and gate/up fused:
    the bf16 model, and the MLX 8-bit one of BASELINE.json:11 (every
    projection, embedding and head quantized on the card in groups of 64).
    Both take the 12.5 Hz codec decoder at ``Qwen3CodecDecoderConfig()``'s
    widths (f32, seed 0) and the byte-level stub tokenizer."""
    import dataclasses

    import torch

    from tpu_audio_torch.codecs import qwen3_codec as QC
    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.tts import qwen3_tts as QT

    cfg = QT.Qwen3TTSConfig()
    cfg.talker = dataclasses.replace(cfg.talker, vocab_size=QWEN3_VOCAB)
    params = QT.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    randomize_norms(params, torch.Generator(device=dev).manual_seed(5))
    codec_cfg = QC.Qwen3CodecDecoderConfig()
    codec = QC.Qwen3CodecDecoder(codec_cfg, QC.init_random_params(codec_cfg, seed=0,
                                                                  device=dev))

    def fused(p):
        p = llama.fuse_projections(p)
        p["code_predictor"] = llama.fuse_projections(p["code_predictor"])
        return p

    q8 = fused(quant.quantize_tree(params, bits=8, group_size=64, scheme="mlx"))
    packed = [q8["model"]["layers"]["self_attn"]["qkv_proj"]["weight"],
              q8["model"]["text_embedding"]["weight"], q8["codec_head"]["weight"],
              q8["code_predictor"]["lm_head"]["14"]["weight"],
              q8["code_predictor"]["model"]["codec_embedding"]["0"]["weight"]]
    check(all(isinstance(w, quant.QuantizedTensor) and w.bits == 8 for w in packed),
          "Qwen3-TTS 8-bit: a projection, an embedding or a head is not packed")
    return {name: QT.Qwen3TTS(cfg, p, tokenizer=ByteTokenizer(), codec=codec,
                              dtype=torch.bfloat16)
            for name, p in (("bf16", fused(params)), ("8bit", q8))}


def qwen3_products(model) -> dict:
    """Kernel 7's products on a Qwen3 path, from the tree: ``talker`` a
    step (the packed linears of a layer times the layers, and the codec
    head), ``layers`` a prefill (the codec head's logits are not needed),
    ``cp`` a code-predictor pass (its layers and a group head), and their
    (rows, O, I) shapes a frame."""
    from tpu_audio_torch.core import quant

    def packed(layers):
        return [v["weight"] for part in ("self_attn", "mlp") for v in layers[part].values()
                if isinstance(v.get("weight"), quant.QuantizedTensor)]

    def oi(w):
        return w.weight.shape[-2], w.weight.shape[-1] * 32 // w.bits

    p = model.params
    tl, cl = packed(p["model"]["layers"]), packed(p["code_predictor"]["model"]["layers"])
    L = model.config.talker.num_hidden_layers
    Lc = model.config.code_predictor.num_hidden_layers
    G = model.config.talker.num_code_groups
    head, lm = p["codec_head"]["weight"], p["code_predictor"]["lm_head"]["0"]["weight"]
    talker = [oi(w) for w in tl] * L + [oi(head)]
    cp = [oi(w) for w in cl] * Lc + [oi(lm)]
    shapes = ([(1, o, i) for o, i in talker] + [(2, o, i) for o, i in cp]
              + [(1, o, i) for o, i in cp] * (G - 2))
    return dict(talker=len(talker), layers=len(tl) * L, cp=len(cp),
                decode=len(talker) + (G - 2) * len(cp), tile=len(cp), shapes=shapes)


def qwen3_qmm_checks(model) -> list:
    """Kernel 7 against its plain version at every product shape of the
    8-bit Qwen3 path (g 64, f32 scales, layer 0's weights): the decode
    kernel at 1 row (f32 x, a frame's talker and code-predictor steps; bf16
    x, the first frame's talker step), the tile at 2 rows (code-predictor
    pass 0, f32 x), at the prompt's rows (bf16 x, the prefill) and at the
    text projection's 3 rows (the tts ids, f32 x); QMM_RTOL with f32 x,
    QMM_BF16_RTOL with bf16 x."""
    import torch

    p = model.params
    tl, cp = p["model"]["layers"], p["code_predictor"]["model"]["layers"]
    prompt = model.prepare_generation_inputs(QWEN3_TEXT)[0].shape[1] - 1
    layer = [(f"{who} {n}", part[a][n]["weight"].map(lambda t: t[0]))
             for who, part in (("talker", tl), ("cp", cp))
             for a, names in (("self_attn", ("qkv_proj", "o_proj")),
                              ("mlp", ("gate_up_proj", "down_proj"))) for n in names]
    heads = [("codec head", p["codec_head"]["weight"]),
             ("cp head", p["code_predictor"]["lm_head"]["7"]["weight"])]
    text = [(f"text {n}", p["text_projection"][n]["weight"]) for n in ("linear_fc1",
                                                                      "linear_fc2")]
    cases = []
    for name, w in layer + heads:
        cases.append((name, w, 1, torch.float32, "decode"))
        if name.startswith("talker") or name == "codec head":
            cases.append((name, w, 1, torch.bfloat16, "decode"))
        if name.startswith("talker"):
            cases.append((name, w, prompt, torch.bfloat16, "tile"))
        elif name.startswith("cp"):
            cases.append((name, w, 2, torch.float32, "tile"))
    cases += [(name, w, 3, torch.float32, "tile") for name, w in text]
    gen = torch.Generator(device=model.device).manual_seed(11)
    out = []
    for name, w, rows, dt, want in cases:
        x = torch.randn((rows, w.weight.shape[-1] * 32 // w.bits), generator=gen,
                        device=model.device).to(dt)
        err, _, ran = qmm_check(f"qwen3 {name} [{rows}]", x, w.weight, w.scales, w.biases,
                                w.group_size, w.bits)
        check(ran == want, f"qwen3 {name} at {rows} rows ran the {ran}, not the {want}")
        out.append(dict(shape=name, rows=rows, x=str(dt).split(".")[-1], kernel=ran,
                        o=w.weight.shape[0], i=x.shape[1], rel_err=err))
    worst = {k: max((c["rel_err"] for c in out if c["x"] == k), default=0.0)
             for k in ("float32", "bfloat16")}
    print(f"[qwen3 qmm] kernel 7 at {len(out)} Qwen3 shapes (8-bit, g 64): the decode kernel "
          f"at 1 row, the tile at 2, 3 and {prompt} rows; rel err up to {worst['float32']:.3e} "
          f"with f32 x (rtol {QMM_RTOL}), {worst['bfloat16']:.3e} with bf16 x (rtol "
          f"{QMM_BF16_RTOL})")
    return out


def qwen3_generate_phase(model) -> tuple[list, dict, np.ndarray]:
    """Greedy ``generate`` twice on the 8-bit model (QWEN3_FRAMES frames,
    repetition penalty 1.05) and ``generate_stream`` once, each with the
    launch counters reset just before and read just after: kernel 7's
    decode kernel ``decode`` times a frame taken (talker step and
    code-predictor passes 1..14), its tile ``cp`` times a frame (pass 0 at
    2 rows), ``layers`` times for the prefill and twice a text projection
    of at most 64 rows (the tts ids; the byte-level prompt is longer and
    dequantizes), no GEMV, no other kernel of the port and no call of the
    plain version. The codes and waveforms repeat bit for bit; the streamed
    chunks, concatenated, equal ``generate``'s waveform within
    QWEN3_STREAM_ATOL."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind
    from tpu_audio_torch.ops import _lib, qmm

    n = qwen3_products(model)
    groups, hop = model.config.talker.num_code_groups, model.codec.config.total_upsample
    chat = f"<|im_start|>assistant\n{QWEN3_TEXT}<|im_end|>\n<|im_start|>assistant\n"
    n_chat = len(model.tokenizer.encode(chat).ids)
    prompt = model.prepare_generation_inputs(QWEN3_TEXT)[0].shape[1]
    check(2 <= prompt - 1 <= qmm.MAX_ROWS, f"a {prompt}-row prompt: the prefill skips the tile")
    text_tiles = 2 + (2 if 2 <= n_chat <= qmm.MAX_ROWS else 0)
    gp = AudioGenerateParameters(max_tokens=QWEN3_FRAMES, temperature=0.0,
                                 repetition_penalty=1.05, repetition_context_size=64)
    runs, first, first_launches = [], None, None
    torch.cuda.reset_peak_memory_stats()
    for run, stream in enumerate((False, False, True)):
        frames, plain, seen = [0], [0], {}
        run_iter = model._run_iter

        def spy(*a, **k):
            for item in run_iter(*a, **k):
                seen["item"] = item
                yield item

        model._run_iter = spy
        try:
            with counting(model, "_frame", frames), counting(qmm, "quantized_matvec_ref", plain):
                _lib.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if stream:
                    events = list(model.generate_stream(QWEN3_TEXT, generation_parameters=gp))
                    chunks = [e.audio for e in events if e.kind == AudioGenerationKind.AUDIO]
                    wav = np.concatenate(chunks)
                else:
                    wav = model.generate(QWEN3_TEXT, generation_parameters=gp)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(_lib.launches)
        finally:
            del model._run_iter
        codes, prefill_s, gen_s = seen["item"][1][:3]
        codes = np.stack(codes)
        n_tile = launches.get("quantized_matvec_tile", 0)
        n_decode = launches.get("quantized_matvec_decode", 0)
        n_gemv = launches.get("quantized_matvec", 0) - n_tile - n_decode
        want_decode = n["decode"] * frames[0]
        want_tile = text_tiles + n["layers"] + n["cp"] * frames[0]
        label = "generate_stream" if stream else "generate"
        print(f"[qwen3 8bit {label} run {run}] {codes.shape[0]} frames ({frames[0]} frame steps "
              f"taken) in {wall:.3f} s (prefill {prefill_s * 1e3:.3f} ms, {gen_s * 1e3 / frames[0]:.3f} "
              f"ms a frame); {wav.shape[0]} samples; launches {launches}: decode {n_decode} "
              f"({want_decode} expected, {n['decode']} a frame), tile {n_tile} ({want_tile} "
              f"expected), GEMV {n_gemv} (0 expected); plain version calls {plain[0]}")
        check(n_decode == want_decode and n_tile == want_tile and n_gemv == 0,
              f"qwen3 8-bit: kernel 7 launched the decode kernel {n_decode}, the tile {n_tile} "
              f"and the GEMV {n_gemv} times; {want_decode}, {want_tile} and 0 expected")
        check(set(k for k, v in launches.items() if v) <= {
            "quantized_matvec", "quantized_matvec_tile", "quantized_matvec_decode"},
            f"qwen3 8-bit: another kernel of the port ran: {launches}")
        check(plain[0] == 0, "qwen3 8-bit: the plain version ran")
        # a frame that samples EOS ends the loop and keeps no codes
        check(codes.shape[1:] == (groups,) and frames[0] - codes.shape[0] in (0, 1)
              and codes.shape[0] >= QWEN3_TEACHER_FRAMES,
              f"qwen3 8-bit: {codes.shape} codes in {frames[0]} frame steps")
        check(bool(np.isfinite(wav).all()) and wav.shape == (codes.shape[0] * hop,),
              f"qwen3 8-bit: waveform {wav.shape}")
        if first is None:
            first, first_launches = (codes, wav), launches
        check(np.array_equal(codes, first[0]), "qwen3 8-bit: greedy codes differ between runs")
        if stream:
            stream_err = float(np.abs(wav - first[1]).max())
            print(f"[qwen3 codec] {len(chunks)} streaming chunks of {[c.shape[0] for c in chunks]} "
                  f"samples against the offline decode: max abs diff {stream_err:.3e} (atol "
                  f"{QWEN3_STREAM_ATOL}); cudnn.allow_tf32 "
                  f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
                  f"{torch.backends.cuda.matmul.allow_tf32}")
            check(stream_err <= QWEN3_STREAM_ATOL,
                  "qwen3: the codec's streaming chunks differ from its offline decode")
        else:
            check(np.array_equal(wav, first[1]), "qwen3 8-bit: waveforms differ between runs")
        runs.append(dict(api=label, run=run, frames=int(codes.shape[0]), wall_s=wall,
                         prefill_ms=prefill_s * 1e3, host_ms_a_frame=gen_s * 1e3 / frames[0],
                         samples=int(wav.shape[0]), launches=launches,
                         realtime_x=wav.shape[0] / model.sample_rate / wall))
    runs[-1].update(stream_max_abs_diff=stream_err, chunks=len(chunks),
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"first frames' codes: {first[0][:2].tolist()}")
    return runs, first_launches, first[0]


def qwen3_teacher_forced(model, codes) -> dict:
    """The first QWEN3_TEACHER_FRAMES generated frames forced through
    ``generate``'s own frame steps (``_sample`` replaced by a reader of the
    codes), with kernel 7 and with its plain version: every talker and
    code-predictor logit vector within QWEN3_LOGITS_RTOL."""
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.models.tts import qwen3_tts as QT
    from tpu_audio_torch.ops import qmm

    gp = AudioGenerateParameters(max_tokens=QWEN3_TEACHER_FRAMES, temperature=0.0)
    sample, kernel = QT._sample, qmm.quantized_matvec

    def forced(plain):
        it, seen = iter(codes[:QWEN3_TEACHER_FRAMES].reshape(-1).tolist()), []

        def read(gen, logits, *a, **k):
            seen.append(logits.float())
            return torch.tensor([next(it)], device=logits.device)

        QT._sample = read
        if plain:
            qmm.quantized_matvec = qmm.quantized_matvec_ref
        try:
            list(model._run_iter(QWEN3_TEXT, None, None, None, gp))
        finally:
            QT._sample, qmm.quantized_matvec = sample, kernel
        return seen

    k, p = forced(False), forced(True)
    G = model.config.talker.num_code_groups
    check(len(k) == len(p) == QWEN3_TEACHER_FRAMES * G, f"qwen3 forced: {len(k)} logits")
    errs = [rel_err(a, b) for a, b in zip(k, p)]
    check(all(bool(torch.isfinite(a).all()) for a in k), "qwen3 forced: non-finite logits")
    talker, cp = max(errs[::G]), max(e for i, e in enumerate(errs) if i % G)
    print(f"[qwen3 teacher-forced] {QWEN3_TEACHER_FRAMES} frames: talker logits, kernel 7 vs "
          f"its plain version, rel err up to {talker:.3e}, code-predictor logits {cp:.3e} "
          f"(rtol {QWEN3_LOGITS_RTOL}); by frame "
          f"{[f'{max(errs[G * f:G * f + G]):.2e}' for f in range(QWEN3_TEACHER_FRAMES)]}")
    check(max(errs) <= QWEN3_LOGITS_RTOL, "qwen3: kernel path logits disagree with the plain route")
    return dict(talker_rel_err=talker, cp_rel_err=cp, frames=QWEN3_TEACHER_FRAMES)


def qwen3_timing(model, label: str) -> dict:
    """``bench_qwen3_tts_ttfb``'s protocol (bench.py:763-876): a prefill of
    QWEN3_TTFB_PREFIX random bf16 embeddings, QWEN3_TTFB_FRAMES frames
    sampled at T 0.9, top-k 50, then the codec's decode of the chunk; the
    best of TTFB_REPEATS after a warm-up, and its realtime x. Then a
    profiled window of QWEN3_PROFILE_FRAMES frames, each read back as
    ``generate`` reads it: device ms a frame (the union of the recorded
    intervals), the busy share, device events and kernel 7's device ms a
    frame; the codec's ms for a 25-frame streaming chunk (2 s, the default
    interval); and the peak device memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core import kv_cache
    from tpu_audio_torch.core.generation import AudioGenerateParameters

    dev = model.device
    tc = model.config.talker
    gp = AudioGenerateParameters(temperature=0.9, top_k=50, top_p=1.0, repetition_penalty=1.0)
    hist = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def prefilled(seed, frames):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((1, QWEN3_TTFB_PREFIX, tc.hidden_size), generator=gen, device=dev,
                        dtype=torch.bfloat16) * 0.1
        pad = torch.randn((1, 1, tc.hidden_size), generator=gen, device=dev,
                          dtype=torch.bfloat16) * 0.1
        cache = kv_cache.init_cache(tc.num_hidden_layers, 1, tc.num_key_value_heads,
                                    tc.head_dim, QWEN3_TTFB_PREFIX + frames + 2, model.dtype, dev)
        return gen, pad, model._prefill(x[:, :-1], cache), x[:, -1:]

    def first_audio(seed):
        gen, pad, cache, emb = prefilled(seed, QWEN3_TTFB_FRAMES)
        codes = []
        for _ in range(QWEN3_TTFB_FRAMES):
            c, s, cache = model._frame(emb, cache, gen, None, hist, 0, gp)
            codes.append(c)
            emb = pad + s
        codes = torch.cat(codes).T[None] % model.codec.config.codebook_size
        return model.codec.decode(codes).float().cpu().numpy()

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        wav = first_audio(0)
        times = []
        for r in range(TTFB_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first_audio(r + 1)
            times.append(time.perf_counter() - t0)
        check(wav.shape == (1, QWEN3_TTFB_FRAMES * model.codec.config.total_upsample)
              and bool(np.isfinite(wav).all()),
              f"qwen3 ttfb waveform {wav.shape}")
        ttfb, audio_s = min(times), wav.size / model.sample_rate
        k = QWEN3_PROFILE_FRAMES
        gen, pad, cache, emb = prefilled(9, k + 2)
        for _ in range(2):
            c, s, cache = model._frame(emb, cache, gen, None, hist, 0, gp)
            c.cpu()
            emb = pad + s
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            markers(STACK_READS[0][1])
            t0 = time.perf_counter()
            for _ in range(k):
                c, s, cache = model._frame(emb, cache, gen, None, hist, 0, gp)
                c.cpu()
                emb = pad + s
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        chunk = torch.randint(0, model.codec.config.codebook_size, (1, tc.num_code_groups, 25),
                              generator=torch.Generator(device=dev).manual_seed(4), device=dev)
        codec_ms = []
        for _ in range(3):
            model.codec.reset_streaming_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.codec.streaming_step(chunk)
            torch.cuda.synchronize()
            codec_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
    busy_us, n_events = device_busy(prof)
    kernels = by_kernel(prof)
    k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]
    k7_ms, k7_n = sum(c[1] for c in k7) / 1e3, sum(c[0] for c in k7)
    out = dict(ttfb_ms=ttfb * 1e3, ttfb_all_ms=[t * 1e3 for t in times], first_audio_s=audio_s,
               realtime_x=audio_s / ttfb, host_ms_a_frame_profiled=prof_ms / k,
               device_ms_a_frame=busy_us / 1e3 / k, busy_share=busy_us / 1e3 / prof_ms,
               device_events_a_frame=n_events / k, kernel7_device_ms_a_frame=k7_ms / k,
               kernel7_device_events_a_frame=k7_n / k, codec_ms_25_frames=min(codec_ms),
               peak_memory_gb=peak)
    print(f"[qwen3 {label} ttfb] {QWEN3_TTFB_PREFIX}-row prefix, {QWEN3_TTFB_FRAMES} frames "
          f"(T 0.9, top-k 50) + codec decode: TTFB {ttfb * 1e3:.3f} ms (best of "
          f"{[f'{t * 1e3:.3f}' for t in times]}), {audio_s:.3f} s of audio: realtime x "
          f"{audio_s / ttfb:.3f}")
    print(f"[qwen3 {label} frame] {k} frames under the profiler: wall {prof_ms / k:.3f} ms a "
          f"frame, device busy {busy_us / 1e3 / k:.3f} ms a frame (share "
          f"{busy_us / 1e3 / prof_ms:.4f}), {n_events / k:.1f} device events a frame; kernel 7 "
          f"{k7_ms / k:.4f} ms ({k7_n / k:.1f} device events: the tile's split and sum "
          f"kernels count) a frame; codec streaming chunk of 25 "
          f"frames {min(codec_ms):.3f} ms; peak device memory {peak:.2f} GB")
    print_kernels(kernels, k, top=10)
    return out


def qwen3_lane_tile_checks(model) -> dict:
    """The tile at every product shape of the 8-bit Qwen3 path (layer 0's
    weights, f32 x, the lanes' dtype) and every row count QWEN3_LANE_ROWS
    of a serving tick: each row of an n-row call bit-equal to the call over
    that row alone beside a filler row (the sums do not depend on the other
    rows), and the call within QMM_RTOL of the plain version."""
    import torch

    from tpu_audio_torch.ops import _lib, qmm

    p = model.params
    tl, cp = p["model"]["layers"], p["code_predictor"]["model"]["layers"]
    ws = [(f"{who} {n}", part[a][n]["weight"].map(lambda t: t[0]))
          for who, part in (("talker", tl), ("cp", cp))
          for a, names in (("self_attn", ("qkv_proj", "o_proj")),
                           ("mlp", ("gate_up_proj", "down_proj"))) for n in names]
    ws += [("codec head", p["codec_head"]["weight"]),
           ("cp head", p["code_predictor"]["lm_head"]["3"]["weight"])]
    gen = torch.Generator(device=model.device).manual_seed(17)
    worst, calls, tiles = 0.0, 0, _lib.launches["quantized_matvec_tile"]
    for name, w in ws:
        i = w.weight.shape[-1] * 32 // w.bits
        filler = torch.randn((1, i), generator=gen, device=model.device)
        for rows in QWEN3_LANE_ROWS:
            x = torch.randn((rows, i), generator=gen, device=model.device)
            err, _, ran = qmm_check(f"qwen3 lanes {name} [{rows}]", x, w.weight, w.scales,
                                    w.biases, w.group_size, w.bits)
            check(ran == "tile", f"qwen3 lanes {name} at {rows} rows ran the {ran}")
            worst = max(worst, err)
            y = qmm.tile(x, w.weight, w.scales, w.biases, w.group_size, w.bits)
            for j in range(rows):
                one = qmm.tile(torch.cat([x[j:j + 1], filler]), w.weight, w.scales, w.biases,
                               w.group_size, w.bits)
                check(torch.equal(one[0], y[j]),
                      f"qwen3 lanes {name}: the tile's row {j} of {rows} differs from the "
                      f"same row beside a filler (max {float((one[0] - y[j]).abs().max()):.3e})")
            calls += 2 + rows
    torch.cuda.synchronize()
    tiles = _lib.launches["quantized_matvec_tile"] - tiles
    check(tiles == calls, f"qwen3 lanes: {tiles} tile launches for {calls} calls")
    print(f"[qwen3 serve tile] {len(ws)} shapes x rows {list(QWEN3_LANE_ROWS)}: every row "
          f"bit-equal to itself beside a filler row ({calls} tile calls); rel err against the "
          f"plain version up to {worst:.3e} (rtol {QMM_RTOL})")
    return dict(shapes=len(ws), rows=list(QWEN3_LANE_ROWS), calls=calls, rel_err=worst)


def qwen3_serve_gp(frames: int):
    from tpu_audio_torch.core.generation import AudioGenerateParameters

    return AudioGenerateParameters(max_tokens=frames, temperature=0.0, repetition_penalty=1.05,
                                   repetition_context_size=64,
                                   streaming_interval=QWEN3_SERVE_CHUNK)


def qwen3_solo_run(model, text: str, voice: str, gp):
    """Solo ``generate``'s frames (``_run_iter``; the decode kernel at 1
    row) of ``text`` in ``voice``; returns ``_run_iter``'s payload."""
    speaker, instruct = model._parse_voice(voice)
    *_, (_, payload) = model._run_iter(text, None, instruct, speaker, gp)
    return payload


def qwen3_solo_codes(model, text: str, voice: str, frames: int) -> np.ndarray:
    """Solo ``generate``'s greedy codes."""
    import numpy as np

    return np.stack(qwen3_solo_run(model, text, voice, qwen3_serve_gp(frames))[0]).astype(
        np.int64)


def qwen3_served_alone(model, text: str, voice: str, frames: int) -> np.ndarray:
    """The request alone in a fresh QWEN3_SERVE_SLOTS-slot engine (run as
    two rows): its greedy codes."""
    import numpy as np

    from tpu_audio_torch.parallel.continuous_qwen3 import ContinuousQwen3TTS

    srv = ContinuousQwen3TTS(model, slots=QWEN3_SERVE_SLOTS,
                             generation_parameters=qwen3_serve_gp(frames))
    req = srv.submit(text, voice=voice, max_tokens=frames)
    for _ in srv.run():
        pass
    return np.stack(req.codes).astype(np.int64)


def qwen3_forced(model, text: str, voice: str, codes: np.ndarray, served: bool,
                 bucket: int | None = None) -> list:
    """The logits sampled from (f32, the talker's with the suppression and
    the repetition penalty) at every (frame, group) of ``len(codes)``
    frames whose codes are forced to ``codes``: through solo ``generate``'s
    frames, or through the engine's lane frame (the request alone in a
    QWEN3_SERVE_SLOTS-slot engine, row 0 of its two; its prompt padded to
    the engine's buckets, or to ``bucket``)."""
    import numpy as np
    import torch

    from tpu_audio_torch.models.tts import qwen3_tts as QT
    from tpu_audio_torch.parallel import continuous_qwen3 as CQ

    frames = len(codes)
    it, seen = iter(np.asarray(codes).reshape(-1).tolist()), []
    if served:
        def read(logits, seed, seeds, index, s):
            # every row is this request's (a lone lane runs as two rows):
            # each takes the forced code, as each would draw the same one
            seen.append(logits[0].float())
            return torch.full((logits.shape[0],), next(it), dtype=torch.int64,
                              device=logits.device)

        keyed, CQ.sample_keyed = CQ.sample_keyed, read
        try:
            kw = {} if bucket is None else {"prefill_buckets": (bucket,)}
            srv = CQ.ContinuousQwen3TTS(model, slots=QWEN3_SERVE_SLOTS, pipeline=False, **kw,
                                        generation_parameters=qwen3_serve_gp(frames))
            srv.submit(text, voice=voice, max_tokens=frames)
            for _ in srv.run():
                pass
        finally:
            CQ.sample_keyed = keyed
    else:
        def read(gen, logits, temperature, top_k, top_p, suppress=None, history=None,
                 hist_len=0, repetition_penalty=1.0):
            valid = None
            if history is not None:
                valid = (torch.arange(history.shape[1], device=logits.device)[None, :]
                         < min(hist_len, history.shape[1]))
            seen.append(QT._penalized(logits, suppress, history, valid, repetition_penalty)[0])
            return torch.tensor([next(it)], device=logits.device)

        sample, QT._sample = QT._sample, read
        try:
            qwen3_solo_run(model, text, voice, qwen3_serve_gp(frames))
        finally:
            QT._sample = sample
    G = model.config.talker.num_code_groups
    check(len(seen) == frames * G, f"qwen3 forced: {len(seen)} logits for {frames} frames")
    return seen


def qwen3_witness(model, text: str, voice: str, solo: np.ndarray,
                  served: np.ndarray) -> dict:
    """Where served and solo greedy codes first differ, at (frame f, group
    g): solo's codes (the longer run's, when one ended at EOS) forced
    through both routes up to frame f, and the logits each route samples
    from there; and the lane frames again over the prompt unpadded. Both
    routes run each frame in the same dtypes, so the served logits differ
    from solo's by what the tile against the decode kernel, the lanes'
    masked attention and the left padding give at that step, and the
    unpadded ones by the first two alone. The difference is a rounding
    flip only where solo's top two lie within both differences (the
    largest between the logits outside the suppressed band) of each other,
    and the served one is within QWEN3_LOGITS_RTOL."""
    import torch

    G = model.config.talker.num_code_groups
    n = min(len(solo), len(served))
    diff = [(f, g) for f in range(n) for g in range(G) if solo[f, g] != served[f, g]]
    f, g = diff[0] if diff else (n, 0)  # else one ran on past the other's EOS
    longer = solo if len(solo) > len(served) else served
    forced = longer[:f + 1]
    speaker, instruct = model._parse_voice(voice)
    rows = model.prepare_generation_inputs(text, "auto", instruct, speaker)[0].shape[1]
    s_all = qwen3_forced(model, text, voice, forced, served=False)
    e_all = qwen3_forced(model, text, voice, forced, served=True)
    # the same lane frames over the prompt unpadded: what the tile against
    # the decode kernel (and the lanes' masked attention) gives alone
    u_all = qwen3_forced(model, text, voice, forced, served=True, bucket=rows)
    s_log = s_all[f * G + g]
    live = s_log > -1e8  # outside the suppressed band
    top = torch.topk(s_log, 2).values
    margin = float(top[0] - top[1])

    def apart(a, b):
        return float((a - b)[b > -1e8].abs().max())

    max_diff = apart(e_all[f * G + g], s_log)
    rel = max_diff / float(s_log[live].abs().max())
    unpadded = apart(u_all[f * G + g], s_log)
    first = apart(e_all[0], s_all[0])  # frame 0's talker logits
    ok = margin <= min(max_diff, unpadded) and rel <= QWEN3_LOGITS_RTOL
    print(f"[qwen3 serve witness] {text!r} ({voice!r}): first differing code at frame {f}, "
          f"group {g}: solo's top two {margin:.4e} apart; the routes' forced logits differ by "
          f"up to {max_diff:.4e} (rel {rel:.3e}, rtol {QWEN3_LOGITS_RTOL}; {unpadded:.4e} with "
          f"the prompt unpadded; frame 0's talker logits {first:.4e} apart): "
          f"{'a rounding flip' if ok else 'NOT a rounding flip'}")
    check(ok, f"qwen3 serve: codes of {text!r} ({voice!r}) differ from solo generate's at "
          f"frame {f}, group {g}, and the forced logits do not show a near tie")
    return dict(frame=f, group=g, margin=margin, max_diff=max_diff, rel_diff=rel,
                unpadded_max_diff=unpadded, frame0_talker_max_diff=first)


def qwen3_serve_run(model) -> tuple[dict, list, dict]:
    """Six staggered greedy requests (QWEN3_SERVE_TEXTS in
    QWEN3_SERVE_VOICES, QWEN3_SERVE_FRAMES) through ``ContinuousQwen3TTS``
    at QWEN3_SERVE_SLOTS slots, the counters reset just before and read
    just after, every tick under ``no_host_sync``: per lane frame of a tick
    (one, or two where first frames in bf16 meet later ones in f32) kernel
    7's tile launched once a product of the tree's frame
    (``qwen3_products``) over the frame's lanes, no decode kernel, no GEMV;
    in all, besides those, the tile's launches of each prefill and text
    projection, no other kernel and no plain call. Each
    request ends with finite audio of whole frames whose chunks, joined,
    equal one flush of its codes through a fresh codec state within
    QWEN3_STREAM_ATOL."""
    import numpy as np
    import torch

    from tpu_audio_torch.codecs.qwen3_codec import decoder_forward, init_streaming_state
    from tpu_audio_torch.ops import _lib, qmm
    from tpu_audio_torch.parallel.continuous_qwen3 import ContinuousQwen3TTS

    n = qwen3_products(model)
    per_tick = n["decode"] + n["tile"]
    texts, voices, frames = QWEN3_SERVE_TEXTS, QWEN3_SERVE_VOICES, QWEN3_SERVE_FRAMES
    gp = qwen3_serve_gp(max(frames))
    srv = ContinuousQwen3TTS(model, slots=QWEN3_SERVE_SLOTS, generation_parameters=gp)
    ticks, admitted, plain = [], [0], [0]
    launch, admit = srv._launch, srv._admit

    def counted():
        fresh = [srv._fresh[s] for s, r in enumerate(srv._lane) if r is not None]
        frames_run = tuple(max(2, c) for c in (sum(fresh), len(fresh) - sum(fresh)) if c)
        before = dict(_lib.launches)
        out = launch()
        ticks.append((frames_run, {k: _lib.launches[k] - before.get(k, 0) for k in (
            "quantized_matvec", "quantized_matvec_tile", "quantized_matvec_decode")}))
        return out

    def counted_admit():
        free = sum(r is None for r in srv._lane)
        admit()
        admitted[0] += free - sum(r is None for r in srv._lane)

    srv._launch, srv._admit = counted, counted_admit
    text_rows = [len(model.tokenizer.encode(piece).ids) for t, v in zip(texts, voices)
                 for piece in (f"<|im_start|>assistant\n{t}<|im_end|>\n<|im_start|>assistant\n",
                               f"<|im_start|>user\n{v}<|im_end|>\n")]
    prompts = [model.prepare_generation_inputs(t, "auto", v)[0] for t, v in zip(texts, voices)]
    prompt_rows = [p.shape[1] for p in prompts]
    distinct = len({p.float().cpu().numpy().tobytes() for p in prompts})
    audio, reqs = {}, []
    with no_host_sync(srv), counting(qmm, "quantized_matvec_ref", plain):
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, (i, j) in enumerate(((0, 2), (2, 4), (4, 6))):
            reqs += [srv.submit(t, voice=v, max_tokens=f, seed=0)
                     for t, v, f in zip(texts[i:j], voices[i:j], frames[i:j])]
            for _ in range(2 if k < 2 else 0):
                for rid, wav in srv.step():
                    audio.setdefault(rid, []).append(wav)
        for rid, wav in srv.run():
            audio.setdefault(rid, []).append(wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
    check(all(r.done for r in reqs) and srv.idle and admitted[0] == len(texts),
          f"qwen3 serve: {admitted[0]} admitted, done {[r.done for r in reqs]}")
    bad = [(rows, d) for rows, d in ticks if d["quantized_matvec_tile"] != per_tick * len(rows)
           or d["quantized_matvec_decode"] or d["quantized_matvec"] != per_tick * len(rows)]
    lane_counts = sorted({c for rows, _ in ticks for c in rows})
    two = sum(len(rows) == 2 for rows, _ in ticks)
    # a projection a prompt piece: the tts ids' 3 rows, the chat text's and
    # the instruction's rows, where they take the tile
    text_tiles = 2 * len(texts) + sum(2 for c in text_rows if 2 <= c <= qmm.MAX_ROWS)
    want_tile = (sum(len(rows) for rows, _ in ticks) * per_tick + admitted[0] * n["layers"]
                 + text_tiles)
    short = min(len(r.codes) for r in reqs)
    first = len({tuple(r.codes[0]) for r in reqs})
    prefixes = len({np.stack(r.codes[:short]).tobytes() for r in reqs})
    print(f"[qwen3 serve] {len(texts)} staggered greedy requests through {QWEN3_SERVE_SLOTS} "
          f"slots in {wall:.3f} s: {distinct} distinct prompts of {prompt_rows} rows, "
          f"{first} distinct first frames, {prefixes} distinct first {short} frames; "
          f"{len(ticks)} ticks ({two} of two lane frames) over {lane_counts} rows, "
          f"{sum(len(r.codes) for r in reqs)} frames; kernel 7 a lane frame: {per_tick} tile "
          f"launches expected, every tick "
          f"{'so' if not bad else f'NOT so: {bad[:3]}'}; the run's "
          f"launches {launches} ({want_tile} tile: the ticks', {admitted[0]} prefills of "
          f"{n['layers']} and the text projections' {text_tiles}); plain version calls {plain[0]}")
    check(distinct == len(texts), f"qwen3 serve: {distinct} distinct prompts")
    check(not bad, f"qwen3 serve: kernel 7 launched otherwise than {per_tick} tiles a lane "
          f"frame: {bad[:3]}")
    check(launches.get("quantized_matvec_tile", 0) == launches.get("quantized_matvec", 0)
          == want_tile and not launches.get("quantized_matvec_decode", 0),
          f"qwen3 serve: launches {launches}, {want_tile} tiles and nothing else expected")
    check(set(k for k, v in launches.items() if v) <= {"quantized_matvec",
                                                      "quantized_matvec_tile"},
          f"qwen3 serve: another kernel of the port ran: {launches}")
    check(plain[0] == 0, "qwen3 serve: the plain version ran")
    codec, hop = model.codec, model.codec.config.total_upsample
    flush_err = 0.0
    for r, f in zip(reqs, frames):
        codes = np.stack(r.codes).astype(np.int64)
        wav = np.concatenate(audio.get(r.request_id, [np.zeros(0, np.float32)]))
        check(0 < len(codes) <= f and codes.shape[1] == model.config.talker.num_code_groups
              and wav.shape == (len(codes) * hop,) and bool(np.isfinite(wav).all()),
              f"qwen3 serve: request {r.request_id}: codes {codes.shape}, audio {wav.shape}")
        with torch.no_grad():
            state = init_streaming_state(codec.config, 1, dtype=codec.dtype, device=codec.device)
            one = decoder_forward(codec.params, torch.from_numpy(codes.T[None]).to(codec.device),
                                  codec.config, state)[0][0].float().cpu().numpy()
        flush_err = max(flush_err, float(np.abs(one - wav).max()))
    print(f"[qwen3 serve] audio: every request finite whole frames; chunks of "
          f"{srv.chunk_frames} frames joined against one flush of its codes: max abs diff "
          f"{flush_err:.3e} (atol {QWEN3_STREAM_ATOL})")
    check(flush_err <= QWEN3_STREAM_ATOL, "qwen3 serve: chunked audio differs from a flush")
    out = dict(requests=len(reqs), ticks=len(ticks), ticks_of_two_frames=two,
               lane_counts=lane_counts, wall_s=wall, distinct_prompts=distinct,
               prompt_rows=prompt_rows, distinct_first_frames=first,
               distinct_prefixes=prefixes, prefix_frames=short,
               frames=[len(r.codes) for r in reqs], tile_launches_a_tick=per_tick,
               launches=launches, flush_max_abs_diff=flush_err)
    return out, [np.stack(r.codes).astype(np.int64) for r in reqs], launches


def qwen3_serve_throughput(model, smi: str) -> list:
    """bench_qwen3_serving's protocol (QWEN3_TIMED_TICKS timed ticks after
    two warm ones, every lane live) at QWEN3_THROUGHPUT_SLOTS, and one live
    lane in the 4-slot engine as the single stream: aggregate frames/s
    (lanes / ms a tick, as the bench; and the frames the timed ticks
    emitted), ms a tick, per-lane realtime x; then one profiled tick: its
    device busy share and events, kernel 7's device ms against its bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.parallel.continuous_qwen3 import ContinuousQwen3TTS

    n = qwen3_products(model)
    gp = AudioGenerateParameters(temperature=0.9, top_k=50, max_tokens=QWEN3_TIMED_TICKS + 4,
                                 streaming_interval=30.0)
    rows, solo = [], None
    for slots, live in [(QWEN3_THROUGHPUT_SLOTS[0], 1)] + [(s, s) for s in QWEN3_THROUGHPUT_SLOTS]:
        srv = ContinuousQwen3TTS(model, slots=slots, generation_parameters=gp,
                                 prefill_buckets=(64,))
        reqs = [srv.submit(QWEN3_BENCH_TEXT, seed=i) for i in range(live)]
        srv.step()
        srv.step()
        torch.cuda.synchronize()
        before = sum(len(r.codes) for r in reqs)
        t0 = time.perf_counter()
        for _ in range(QWEN3_TIMED_TICKS):
            srv.step()
        torch.cuda.synchronize()
        tick = (time.perf_counter() - t0) / QWEN3_TIMED_TICKS
        emitted = sum(len(r.codes) for r in reqs) - before
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_us, n_ev = device_busy(prof)
        kernels = by_kernel(prof)
        k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]
        k7_n = sum(c[0] for c in k7)
        # a tile call is its split, tile and slice-sum kernels: fewer events
        # than calls means the profile dropped some
        k7_ms = sum(c[1] for c in k7) / 1e3 if k7_n >= n["decode"] + n["tile"] else None
        lanes = max(2, live)
        k7_bound = sum(qmm_bound(r * lanes, o, i, 8, 64)[0] for r, o, i in n["shapes"])
        frames_s = live / tick
        solo = frames_s if live == 1 else solo
        row = dict(slots=slots, live=live, ms_a_tick=tick * 1e3, frames_s=frames_s,
                   frames_emitted=emitted, frames_s_emitted=emitted / (tick * QWEN3_TIMED_TICKS),
                   single_stream_frames_s=solo, vs_single=frames_s / solo,
                   realtime_x_a_lane=frames_s / live / 12.5, profiled_tick_ms=wall_ms,
                   device_ms_a_tick=busy_us / 1e3, busy_share=busy_us / 1e3 / wall_ms,
                   device_events_a_tick=n_ev, kernel7_device_ms_a_tick=k7_ms,
                   kernel7_events_a_tick=k7_n, kernel7_bound_ms_a_tick=k7_bound, smi=smi)
        rows.append(row)
        print(f"[qwen3 serve throughput slots={slots} live={live}] {tick * 1e3:.3f} ms a tick: "
              f"{frames_s:.2f} frames/s ({emitted} frames emitted in the timed ticks), single "
              f"stream {solo:.2f}, x{frames_s / solo:.2f}; realtime x a lane "
              f"{frames_s / live / 12.5:.3f}; one profiled tick: device busy "
              f"{busy_us / 1e3:.3f} of {wall_ms:.3f} ms (share {busy_us / 1e3 / wall_ms:.4f}), "
              f"{n_ev} device events; kernel 7 {fmt(k7_ms)} ({k7_n} events) against its "
              f"bound {k7_bound:.4f} ms (bytes; {smi})")
        print_kernels(kernels, 1, top=8)
        del srv, reqs
    return rows


def qwen3_http_phase(model) -> dict:
    """Two concurrent /v1/audio/speech/stream POSTs of QWEN3_HTTP_FRAMES
    frames through ``cli.serve.build_server(model, "tts", slots=2)``, the
    model's default sampling: both answer 200 with whole frames."""
    import numpy as np

    from tpu_audio_torch.cli.serve import build_server
    from tpu_audio_torch.parallel.continuous_qwen3 import Qwen3TTSEngineWorker

    server = build_server(model, "tts", "qwen3-tts-random", port=0, slots=2)
    check(isinstance(server.tts_worker, Qwen3TTSEngineWorker),
          f"qwen3 http: the server built {type(server.tts_worker).__name__}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/audio/speech/stream"
    results: dict = {}
    try:
        def post(i):
            req = urllib.request.Request(url, data=json.dumps(
                {"input": QWEN3_SERVE_TEXTS[i], "voice": QWEN3_SERVE_VOICES[i],
                 "max_tokens": QWEN3_HTTP_FRAMES, "seed": i}).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, r.headers["Content-Type"], r.read())

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "qwen3 http: a request did not return")
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(sorted(results) == [0, 1], "qwen3 http: missing responses")
    hop = model.codec.config.total_upsample
    samples = []
    for i in range(2):
        status, ctype, data = results[i]
        pcm = np.frombuffer(data, "<i2")
        samples.append(int(pcm.shape[0]))
        check(status == 200 and ctype == f"audio/L16; rate={model.sample_rate}"
              and 0 < pcm.shape[0] <= QWEN3_HTTP_FRAMES * hop and pcm.shape[0] % hop == 0,
              f"qwen3 http {i}: status {status}, {ctype}, {pcm.shape[0]} samples")
    print(f"[qwen3 http] 2 concurrent /v1/audio/speech/stream POSTs through "
          f"Qwen3TTSEngineWorker (slots 2) in {wall:.3f} s: samples {samples} (whole "
          f"{hop}-sample frames)")
    return dict(requests=2, wall_s=wall, samples=samples)


def qwen3_serve_phase(model, smi: str) -> tuple[dict, dict]:
    """The ``[qwen3 serve]`` phase on the 8-bit model: the tile's rows
    (``qwen3_lane_tile_checks``), the counted staggered run
    (``qwen3_serve_run``), each request alone in a fresh engine (codes bit
    for bit the same) and through solo ``generate`` (the same codes, or a
    near tie, ``qwen3_witness``), the throughput (``qwen3_serve_throughput``)
    and HTTP (``qwen3_http_phase``). Returns its JSON and kernel 7's serving
    fields for the tile's record."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tile = qwen3_lane_tile_checks(model)
    run, served, launches = qwen3_serve_run(model)
    alone, solo_equal, witnesses = [], [], []
    for text, voice, f, codes in zip(QWEN3_SERVE_TEXTS, QWEN3_SERVE_VOICES, QWEN3_SERVE_FRAMES,
                                     served):
        alone.append(bool(np.array_equal(qwen3_served_alone(model, text, voice, f), codes)))
        solo = qwen3_solo_codes(model, text, voice, f)
        solo_equal.append(bool(solo.shape == codes.shape and np.array_equal(solo, codes)))
        if not solo_equal[-1]:
            witnesses.append(qwen3_witness(model, text, voice, solo, codes))
    print(f"[qwen3 serve] each request alone in a fresh {QWEN3_SERVE_SLOTS}-slot engine gives "
          f"the same codes: {alone}; solo generate's codes (the decode kernel at 1 row) equal: "
          f"{solo_equal}, {len(witnesses)} near-tie witness(es)")
    check(all(alone), "qwen3 serve: a request's codes depend on the other lanes")
    throughput = qwen3_serve_throughput(model, smi)
    http = qwen3_http_phase(model)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = dict(tile=tile, run=run, alone_equal=alone, solo_equal=solo_equal,
               witnesses=witnesses, throughput=throughput, http=http, peak_memory_gb=peak,
               phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[qwen3 serve] peak device memory {peak:.2f} GB; phase {out['phase_s']:.1f} s")
    k7 = dict(qwen3_serve_launches=launches["quantized_matvec_tile"],
              qwen3_serve=dict(launches_a_tick=run["tile_launches_a_tick"], by_slots=[
                  {k: r[k] for k in ("slots", "live", "kernel7_device_ms_a_tick",
                                     "kernel7_bound_ms_a_tick", "ms_a_tick")}
                  for r in throughput]))
    return out, k7


def speech_24k(seconds: float):
    """``speech_signal`` at 24 kHz (f32 numpy)."""
    from tpu_audio_torch.core.audio_io import resample_audio

    return resample_audio(speech_signal(seconds), 16000, 24000)[:int(24000 * seconds)]


@contextlib.contextmanager
def counted_flops(out: list):
    """Add to ``out[0]`` the operations (2 x multiply-adds) of every
    ``core.nn`` convolution, transposed convolution, linear and attention
    call inside the block, from their shapes."""
    from tpu_audio_torch.core import nn

    saved = {k: getattr(nn, k) for k in ("conv1d", "conv_transpose1d", "linear", "sdpa")}

    def conv1d(p, x, *a, **k):
        y = saved["conv1d"](p, x, *a, **k)
        out[0] += 2.0 * y.numel() * p["weight"].shape[1] * p["weight"].shape[2]
        return y

    def conv_transpose1d(p, x, *a, **k):
        w = p["weight"]
        out[0] += 2.0 * x.numel() * w.shape[1] * w.shape[2]
        return saved["conv_transpose1d"](p, x, *a, **k)

    def linear(p, x):
        y = saved["linear"](p, x)
        out[0] += 2.0 * y.numel() * x.shape[-1]
        return y

    def sdpa(q, k, v, *a, **kw):
        out[0] += 4.0 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] * q.shape[3]
        return saved["sdpa"](q, k, v, *a, **kw)

    for k, f in (("conv1d", conv1d), ("conv_transpose1d", conv_transpose1d),
                 ("linear", linear), ("sdpa", sdpa)):
        setattr(nn, k, f)
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(nn, k, f)


def mimi_hop(cfg) -> int:
    """Samples a Mimi frame (1,920 at 24 kHz and 12.5 Hz)."""
    return math.prod(cfg.seanet.ratios) * cfg.downsample_stride


def rvq_flops(cfg, frames: int) -> float:
    """The nearest-codebook search of every quantizer over ``frames``
    frames (2 x frames x bins x dim each)."""
    return 2.0 * frames * cfg.quantizer_bins * cfg.quantizer_dim * cfg.quantizer_nq


def mimi_latent(params: dict, cfg, audio):
    """Mimi's encoder up to the RVQ: ``audio [B, T]`` -> ``[B, frames,
    dimension]`` on its device."""
    from tpu_audio_torch.codecs import mimi as M
    from tpu_audio_torch.core import nn

    with nn.f32_convolutions():
        h = M.seanet_encode(params["encoder"], audio[..., None], cfg.seanet)
        h, _ = M.transformer_forward(params["encoder_transformer"], h, cfg.transformer)
        s = cfg.downsample_stride
        return M.s_conv1d(params["downsample"], h, 2 * s, stride=s, pad_mode="edge")


def rvq_witness(label: str, quantizer: dict, lat_ref, lat_got, codes_ref, codes_got) -> dict:
    """Codes ``codes_got`` [B, n, T] against ``codes_ref``: where a frame's
    codes part, at its first parted codebook both codes must be the two
    nearest rows from the reference's residual (``lat_ref`` through the
    reference's codes before it), and their distances must lie within twice
    the largest difference between the distances from ``lat_ref`` and from
    ``lat_got`` (float64 on the CPU): a near tie that f32 sums in another
    order decide. Returns the parted frames and the witnesses."""
    import numpy as np
    import torch

    from tpu_audio_torch.codecs import mimi as M

    codes_ref, codes_got = np.asarray(codes_ref), np.asarray(codes_got)
    n_first = len(quantizer["rvq_first"]["vq"]["layers"])
    frames = sorted({(b, t) for b, _, t in np.argwhere(codes_got != codes_ref)})
    seen = []
    for b, t in frames:
        k = int(np.flatnonzero(codes_got[b, :, t] != codes_ref[b, :, t])[0])
        part, i, base = ("rvq_first", k, 0) if k < n_first else ("rvq_rest", k - n_first, n_first)
        pp = quantizer[part]
        w = pp["input_proj"]["weight"][:, :, 0].double().cpu()
        layers = [M._codebook_embed(pp["vq"]["layers"][str(j)]["codebook"]).double().cpu()
                  for j in range(i + 1)]
        d = []
        for lat in (lat_ref, lat_got):
            r = torch.as_tensor(np.asarray(lat[b, t]), dtype=torch.float64) @ w.T
            for j in range(i):
                r = r - layers[j][int(codes_ref[b, base + j, t])]
            d.append((layers[i] * layers[i]).sum(-1) / 2 - layers[i] @ r)
        top = torch.argsort(d[0])[:2].tolist()
        gap = float(d[0][top[1]] - d[0][top[0]])
        diff = float((d[0] - d[1]).abs().max())
        seen.append(dict(batch=int(b), frame=int(t), codebook=k, gap=gap, diff=diff))
        check({int(codes_got[b, k, t]), int(codes_ref[b, k, t])} <= set(top) and gap <= 2 * diff,
              f"{label}: frame {t} parts at codebook {k} with no near tie (the two nearest "
              f"{top}, gap {gap:.3e}, the routes' distances differ by {diff:.3e})")
    print(f"[{label}] codes {codes_got.shape}: {len(frames)} frame(s) of {codes_ref.shape[2]} "
          f"part, each at a witnessed near tie {[(w['frame'], w['codebook']) for w in seen]}")
    return dict(parted_frames=len(frames), witnesses=seen)


def clone_encoders(model, dev):
    """The speaker encoder and the speech tokenizer's encoder of
    [qwen3 clone] on the card, and their CPU copies."""
    from tpu_audio_torch.codecs import qwen3_codec as QC
    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.tts import qwen3_speaker as QS

    spk_cfg = QS.SpeakerEncoderConfig()
    check(spk_cfg.enc_dim == model.config.talker.hidden_size,
          "the speaker embedding is not the talker's width")
    enc_cfg = QC.encoder_config_from_dict({})
    spk = QS.Qwen3SpeakerEncoder(spk_cfg, QS.init_random_params(spk_cfg, seed=0, device=dev))
    enc = QC.Qwen3CodecEncoder(enc_cfg, QC.init_random_encoder_params(enc_cfg, seed=0, device=dev),
                               valid_num_quantizers=16)
    return (spk, enc, QS.Qwen3SpeakerEncoder(spk_cfg, loading.to_device(spk.params, "cpu")),
            QC.Qwen3CodecEncoder(enc_cfg, loading.to_device(enc.params, "cpu"), 16))


def speaker_mel_kernel(ref, dev, smi: str) -> dict:
    """Kernel 1 at the speaker mel's shape (5 s at 24 kHz: 468 frames x 513
    bins x 128 mels) against its plain version, timed, with its bound."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.models.tts import qwen3_speaker as QS
    from tpu_audio_torch.ops import mel as M

    cfg = QS.SpeakerEncoderConfig()
    spec = dsp.stft(torch.from_numpy(ref).to(dev), dsp.hanning_window(QS.N_FFT, periodic=True),
                    QS.N_FFT, QS.HOP)[:-1]
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(cfg.sample_rate, QS.N_FFT, cfg.mel_dim, f_min=0.0,
                                          f_max=cfg.sample_rate / 2.0, norm="slaney",
                                          mel_scale="slaney")).to(dev)
    got, want, err = mel_check("speaker mel, 5 s, 128 mels", lambda: M.fused_log_mel(re, im, fb),
                               re, im, fb)
    check(got.shape == (ref.shape[0] // QS.HOP, cfg.mel_dim), f"speaker mel {got.shape}")
    b_ms, b_by = mel_bound(re, im, fb, got)
    k1 = dict(shape=[re.shape[0], re.shape[1], fb.shape[1]], max_abs_err=err,
              rel_err=rel_err(got, want), bound_ms=b_ms, bound_by=b_by,
              ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
              dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    print(f"[qwen3 clone mel] kernel 1 at [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},"
          f"{fb.shape[1]}]: max abs err {err:.3e} (atol {MEL_ATOL}); per call kernel "
          f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; device kernel {fmt(k1['dev_ms'])}, "
          f"plain {fmt(k1['plain_dev_ms'])}; bound {b_ms:.6f} ms ({b_by}) ({smi})")
    return k1


def clone_encoder_checks(spk, enc, spk_cpu, enc_cpu, ref, dev, smi: str) -> dict:
    """The speaker mel, the embedding and the codes on the card against the
    CPU (the codes equal, or parted at witnessed near ties, ``rvq_witness``),
    each limit under its TF32 control (convolutions and matrix products in
    TF32); kernel 1 once for the embedding and no kernel of the port for the
    codes; then each encoder's device ms, events and bound."""
    import torch

    from tpu_audio_torch.models.tts import qwen3_speaker as QS
    from tpu_audio_torch.ops import _lib

    cfg = spk.config
    _lib.reset_launches()
    emb = spk(ref)
    launches = dict(_lib.launches)
    check({k: v for k, v in launches.items() if v} == {"fused_log_mel": 1},
          f"speaker embedding: launches {launches} (kernel 1 once)")
    emb_cpu = spk_cpu(ref)
    mel = QS.speaker_mel(ref, cfg, device=dev)
    mel_err = float((mel.cpu() - QS.speaker_mel(ref, cfg)).abs().max())
    emb_err = rel_err(emb.cpu(), emb_cpu)
    _lib.reset_launches()
    codes = enc.encode(ref)
    no_launches("the speech tokenizer's encoder")
    codes_cpu = enc_cpu.encode(ref)
    x = torch.from_numpy(ref)[None]
    lat, lat_cpu = mimi_latent(enc.params, enc.config, x.to(dev)).cpu(), mimi_latent(
        enc_cpu.params, enc.config, x)
    lat_err = rel_err(lat, lat_cpu)
    witness = rvq_witness("qwen3 clone codes", enc_cpu.params["quantizer"], lat_cpu.numpy(),
                          lat.numpy(), codes_cpu.numpy(), codes.cpu().numpy())
    with tf32_everywhere():
        emb_leak = rel_err(spk(ref).cpu(), emb_cpu)
        lat_leak = rel_err(mimi_latent(enc.params, enc.config, x.to(dev)).cpu(), lat_cpu)
        codes_leak = int((enc.encode(ref).cpu() != codes_cpu).sum())
    print(f"[qwen3 clone encoders] mel card against CPU {mel_err:.3e} (atol {MEL_ATOL}); "
          f"embedding {tuple(emb.shape)} rel err {emb_err:.3e} (rtol {CLONE_EMBED_RTOL}; TF32 "
          f"control {emb_leak:.3e}); codes {tuple(codes.shape)}, latent rel err {lat_err:.3e} "
          f"(rtol {CLONE_LATENT_RTOL}; TF32 control {lat_leak:.3e}, {codes_leak} codes parted "
          f"there); launches for the embedding {launches}")
    check(mel_err <= MEL_ATOL, f"speaker mel card against CPU {mel_err:.3e}")
    check(emb_err <= CLONE_EMBED_RTOL < emb_leak,
          f"speaker embedding: {emb_err:.3e} against {CLONE_EMBED_RTOL} < control {emb_leak:.3e}")
    check(lat_err <= CLONE_LATENT_RTOL < lat_leak,
          f"codec encoder latent: {lat_err:.3e} against {CLONE_LATENT_RTOL} < control {lat_leak:.3e}")
    check(codes.shape == (1, enc.valid_num_quantizers, -(-ref.shape[0] // mimi_hop(enc.config))),
          f"codes {tuple(codes.shape)}")
    # each encoder alone: device ms and events, operations and bound
    timings = {}
    for name, fn, params, io_bytes, extra in (
            ("speaker", lambda: QS.speaker_encoder_forward(spk.params, mel, cfg), spk.params,
             nbytes(mel, emb), 0.0),
            ("codec", lambda: enc.encode(ref), enc.params, 4 * ref.size + 8 * codes.numel(),
             rvq_flops(enc.config, codes.shape[2]))):
        ops = [0.0]
        with counted_flops(ops):
            fn()
        ops = ops[0] + extra
        b_ms, b_by = bound(nbytes(*_tensors(params)) + io_bytes, f32_ops=ops)
        wall, busy, events = profiled(fn, dev, f"qwen3 clone {name} encoder")
        timings[name] = dict(wall_ms=wall, device_ms=busy, device_events=events,
                             gflop=ops / 1e9, bound_ms=b_ms, bound_by=b_by)
        print(f"[qwen3 clone {name} encoder] {ops / 1e9:.3f} GFLOP f32, bound {b_ms:.4f} ms "
              f"({b_by}); a call {wall:.3f} ms on the host clock, device busy {fmt(busy)}, "
              f"{events} device events ({smi})")
    return dict(mel_card_vs_cpu=mel_err, embedding_rel_err=emb_err, embedding_tf32_control=emb_leak,
                latent_rel_err=lat_err, latent_tf32_control=lat_leak,
                codes_parted_tf32_control=codes_leak, codes=witness, encoders=timings,
                launches=launches)


def clone_generate_runs(model, ref) -> tuple[list, int]:
    """Greedy cloned ``generate`` twice (the first with the reference cache
    cleared) and ``generate_stream`` once, each with the counters reset just
    before and read just after: the prompt's rows (past 64: its prefill
    takes the dequantize route, 4 products a talker layer), kernel 7's
    decode kernel ``decode`` times a frame taken and its tile ``cp`` times a
    frame plus the text projection's (3-row tts ids and role header, the
    texts' rows where 2..64), kernel 1 once on the cold reference and never
    on a cached one, no GEMV, no other kernel, no plain version. The codes
    repeat; the stream's chunks are the codec's decode of the codes alone
    within QWEN3_STREAM_ATOL. Returns the runs and kernel 1's launches."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind
    from tpu_audio_torch.ops import _lib, qmm

    n = qwen3_products(model)
    L = model.config.talker.num_hidden_layers
    model._ref_context_cache = None
    prompt = model.prepare_icl_generation_inputs(QWEN3_TEXT, ref, CLONE_REF_TEXT)[0].shape[1]
    tok = model.tokenizer
    ref_ids = len(tok.encode(f"<|im_start|>assistant\n{CLONE_REF_TEXT}<|im_end|>\n").ids) - 5
    tgt_ids = len(tok.encode(f"<|im_start|>assistant\n{QWEN3_TEXT}<|im_end|>\n"
                             "<|im_start|>assistant\n").ids) - 8
    text_rows = ref_ids + tgt_ids
    text_tiles = 4 + (2 if 2 <= text_rows <= qmm.MAX_ROWS else 0)
    big = 4 * L + (2 if text_rows > qmm.MAX_ROWS else 0)
    check(prompt - 1 > qmm.MAX_ROWS, f"a {prompt}-row cloned prompt: its prefill takes the tile")
    gp = AudioGenerateParameters(max_tokens=QWEN3_FRAMES, temperature=0.0,
                                 repetition_penalty=1.05, repetition_context_size=64)
    runs, first, k1_launches = [], None, 0
    matmul = quant.quantized_matmul
    for run, stream in enumerate((False, False, True)):
        if run == 0:
            model._ref_context_cache = None
        frames, plain, seen, rows = [0], [0], {}, []
        run_iter = model._run_iter

        def spy(*a, **k):
            for item in run_iter(*a, **k):
                seen["item"] = item
                yield item

        def matmul_spy(x, *a, **k):
            rows.append(int(np.prod(x.shape[:-1])))
            return matmul(x, *a, **k)

        model._run_iter, quant.quantized_matmul = spy, matmul_spy
        kw = dict(ref_audio=ref, ref_text=CLONE_REF_TEXT, generation_parameters=gp)
        try:
            with counting(model, "_frame", frames), counting(qmm, "quantized_matvec_ref", plain):
                _lib.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if stream:
                    chunks = [e.audio for e in model.generate_stream(QWEN3_TEXT, **kw)
                              if e.kind == AudioGenerationKind.AUDIO]
                    wav = np.concatenate(chunks)
                else:
                    wav = model.generate(QWEN3_TEXT, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(_lib.launches)
        finally:
            del model._run_iter
            quant.quantized_matmul = matmul
        codes, prefill_s, gen_s, prompt_rows, ref_codes = seen["item"][1]
        codes = np.stack(codes)
        n_tile = launches.get("quantized_matvec_tile", 0)
        n_decode = launches.get("quantized_matvec_decode", 0)
        n_gemv = launches.get("quantized_matvec", 0) - n_tile - n_decode
        n_mel = launches.get("fused_log_mel", 0)
        n_big = sum(r > qmm.MAX_ROWS for r in rows)
        want_decode, want_tile = n["decode"] * frames[0], text_tiles + n["cp"] * frames[0]
        label = "generate_stream" if stream else "generate"
        print(f"[qwen3 clone {label} run {run}] {prompt_rows}-row prompt ({ref_codes.shape[2]} "
              f"reference frames), {codes.shape[0]} frames in {wall:.3f} s (prefill "
              f"{prefill_s * 1e3:.3f} ms, {gen_s * 1e3 / frames[0]:.3f} ms a frame); launches "
              f"{launches}: decode {n_decode} ({want_decode} expected), tile {n_tile} "
              f"({want_tile} expected), GEMV {n_gemv}, kernel 1 {n_mel} ({int(run == 0)} "
              f"expected); {n_big} products dequantized past 64 rows ({big} expected); plain "
              f"version calls {plain[0]}")
        check(prompt_rows == prompt and n_decode == want_decode and n_tile == want_tile
              and n_gemv == 0 and n_mel == int(run == 0) and n_big == big and plain[0] == 0,
              f"qwen3 clone {label} run {run}: launches {launches}, {n_big} dequantized")
        check(set(k for k, v in launches.items() if v) <= {
            "quantized_matvec", "quantized_matvec_tile", "quantized_matvec_decode",
            "fused_log_mel"}, f"qwen3 clone: another kernel of the port ran: {launches}")
        check(codes.shape[1:] == (model.config.talker.num_code_groups,)
              and frames[0] - codes.shape[0] in (0, 1) and codes.shape[0] >= 2,
              f"qwen3 clone: {codes.shape} codes in {frames[0]} frame steps")
        check(bool(np.isfinite(wav).all()) and wav.shape[0] > 0, f"qwen3 clone: waveform {wav.shape}")
        if first is None:
            first, k1_launches = (codes, wav), n_mel
        check(np.array_equal(codes, first[0]), "qwen3 clone: greedy codes differ between runs")
        if stream:
            alone = model.codec.decode(codes.T[None])[0].float().cpu().numpy()
            stream_err = float(np.abs(wav - alone).max())
            print(f"[qwen3 clone stream] {len(chunks)} chunks against the codec's decode of the "
                  f"codes alone: max abs diff {stream_err:.3e} (atol {QWEN3_STREAM_ATOL})")
            check(stream_err <= QWEN3_STREAM_ATOL, "qwen3 clone: the stream departs from decode")
        else:
            check(np.array_equal(wav, first[1]), "qwen3 clone: waveforms differ between runs")
        runs.append(dict(api=label, run=run, prompt_rows=prompt_rows,
                         reference_frames=int(ref_codes.shape[2]), frames=int(codes.shape[0]),
                         wall_s=wall, prefill_ms=prefill_s * 1e3,
                         host_ms_a_frame=gen_s * 1e3 / frames[0], samples=int(wav.shape[0]),
                         launches=launches, dequantized_products=n_big))
    runs[-1].update(stream_max_abs_diff=stream_err)
    return runs, k1_launches


def clone_ttfb(model, ref) -> dict:
    """Time to the first audio of a cloned ``generate_stream`` (greedy, the
    first chunk at QWEN3_TTFB_FRAMES frames), the reference cold (the cache
    cleared: both encoders run) and cached, in turns: cold, cached, cold,
    cached; the best of each."""
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind

    gp = AudioGenerateParameters(max_tokens=QWEN3_TTFB_FRAMES, temperature=0.0,
                                 repetition_penalty=1.05,
                                 streaming_interval=QWEN3_TTFB_FRAMES / 12.5)
    times = {"cold": [], "cached": []}
    for which in ("cold", "cached", "cold", "cached"):
        if which == "cold":
            model._ref_context_cache = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = model.generate_stream(QWEN3_TEXT, ref_audio=ref, ref_text=CLONE_REF_TEXT,
                                       generation_parameters=gp)
        first = next(e for e in events if e.kind == AudioGenerationKind.AUDIO)
        times[which].append((time.perf_counter() - t0) * 1e3)
        events.close()
        check(first.audio.shape[0] > 0, "qwen3 clone: an empty first chunk")
    out = {f"ttfb_{k}_ms": min(v) for k, v in times.items()}
    out.update({f"ttfb_{k}_all_ms": v for k, v in times.items()})
    print(f"[qwen3 clone ttfb] first audio ({QWEN3_TTFB_FRAMES} frames) with the reference cold "
          f"{[round(t, 3) for t in times['cold']]} ms, cached "
          f"{[round(t, 3) for t in times['cached']]} ms")
    return out


@contextlib.contextmanager
def tf32_everywhere():
    """The TF32 control of [qwen3 clone] and [mimi], which run with TF32
    off: cuDNN's and the matrix products' TF32 allowed and the models'
    ``nn.f32_convolutions`` guard bypassed (``tf32_leak``)."""
    import torch

    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tf32_leak(matmul=True):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn


def qwen3_clone_phase(model, dev, smi: str) -> tuple[dict, dict]:
    """The ``[qwen3 clone]`` phase on the [qwen3 tts] 8-bit model, TF32 off:
    the encoders attached (``clone_encoders``), kernel 1 at the speaker
    mel's shape (``speaker_mel_kernel``), the encoders against the CPU and
    timed (``clone_encoder_checks``), the cloned runs (``clone_generate_runs``)
    and TTFB (``clone_ttfb``); the model is left without its encoders.
    Returns the phase's record and kernel 1's fields."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ref = speech_24k(CLONE_REF_S)
    spk, enc, spk_cpu, enc_cpu = clone_encoders(model, dev)
    model.speaker_encoder, model.codec_encoder = spk, enc
    try:
        k1 = speaker_mel_kernel(ref, dev, smi)
        encoders = clone_encoder_checks(spk, enc, spk_cpu, enc_cpu, ref, dev, smi)
        runs, k1_launches = clone_generate_runs(model, ref)
        ttfb = clone_ttfb(model, ref)
    finally:
        model.speaker_encoder = model.codec_encoder = model._ref_context_cache = None
    peak = peak_gb()
    out = dict(reference_s=CLONE_REF_S, kernel1=k1, encoders=encoders, runs=runs, ttfb=ttfb,
               peak_memory_gb=peak, phase_s=time.perf_counter() - t_phase,
               tf32=dict(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32), smi=smi)
    print(f"[qwen3 clone] peak device memory {peak:.2f} GB; phase {out['phase_s']:.1f} s")
    return out, dict(speaker_mel_launches=k1_launches, speaker_mel=k1)


def mimi_phase(dev, smi: str) -> dict:
    """The ``[mimi]`` phase, TF32 off: Mimi at ``mimi_202407(16)`` from seed
    0 on the card and a CPU copy; 10 s of speech ``encode`` and ``decode``,
    card against CPU (codes equal or witnessed, ``rvq_witness``; the
    waveform within MIMI_CARD_RTOL, under its TF32 control); ``decode_step``
    in uneven chunks against offline (MIMI_STREAM_RTOL); ``encode_step``'s
    codes against offline (witnessed from its own latents); RTF, device ms,
    events, operations and bounds of encode and decode; host and device ms
    and events a streamed frame. No kernel of the port runs."""
    import numpy as np
    import torch

    from tpu_audio_torch.codecs import mimi as M
    from tpu_audio_torch.ops import _lib

    t_phase = time.perf_counter()
    cfg = M.mimi_202407(16)
    card, cpu = card_and_cpu(dev, lambda d, p: M.Mimi(
        cfg, p if p is not None else M.init_random_params(cfg, seed=0, device=d), device=d))
    audio = speech_24k(MIMI_SECONDS)
    x = torch.from_numpy(audio)[None]
    _lib.reset_launches()
    codes = card.encode(audio)
    wav = card.decode(codes)
    no_launches("[mimi]")
    codes_cpu = cpu.encode(audio)
    lat, lat_cpu = mimi_latent(card.params, cfg, x.to(dev)).cpu(), mimi_latent(cpu.params, cfg, x)
    lat_err = rel_err(lat, lat_cpu)
    enc_witness = rvq_witness("mimi encode", cpu.params["quantizer"], lat_cpu.numpy(),
                              lat.numpy(), codes_cpu.numpy(), codes.cpu().numpy())
    wav = card.decode(codes_cpu)
    wav_cpu = cpu.decode(codes_cpu)
    wav_err = rel_err(wav.cpu(), wav_cpu)
    with tf32_everywhere():
        wav_leak = rel_err(card.decode(codes_cpu).cpu(), wav_cpu)
        lat_leak = rel_err(mimi_latent(card.params, cfg, x.to(dev)).cpu(), lat_cpu)
    frames = codes.shape[2]
    print(f"[mimi offline] {MIMI_SECONDS} s -> codes {tuple(codes.shape)} -> {tuple(wav.shape)} "
          f"samples (largest {float(wav_cpu.abs().max()):.4f}); latent rel err {lat_err:.3e} "
          f"(TF32 control {lat_leak:.3e}); waveform rel err {wav_err:.3e} (rtol "
          f"{MIMI_CARD_RTOL}; TF32 control {wav_leak:.3e})")
    hop = mimi_hop(cfg)
    check(codes.shape == (1, cfg.quantizer_nq, -(-audio.size // hop))
          and wav.shape == (1, frames * hop)
          and bool(torch.isfinite(wav).all()), f"mimi: codes {codes.shape}, waveform {wav.shape}")
    check(wav_err <= MIMI_CARD_RTOL < wav_leak,
          f"mimi decode: {wav_err:.3e} against {MIMI_CARD_RTOL} < control {wav_leak:.3e}")
    check(lat_err <= CLONE_LATENT_RTOL < lat_leak,
          f"mimi latent: {lat_err:.3e} against {CLONE_LATENT_RTOL} < control {lat_leak:.3e}")
    # decode_step in uneven chunks against offline
    card.reset_state()
    pieces, t = [], 0
    for i in range(frames):
        if t >= frames:
            break
        n = MIMI_DECODE_CHUNKS[i % len(MIMI_DECODE_CHUNKS)]
        pieces.append(card.decode_step(codes_cpu[:, :, t:t + n]))
        t += n
    streamed = torch.cat(pieces, dim=1)
    stream_err = rel_err(streamed, wav[:, :streamed.shape[1]])
    print(f"[mimi decode_step] {len(pieces)} chunks of {list(MIMI_DECODE_CHUNKS)} frames "
          f"(cycled): {streamed.shape[1]} samples against offline rel err {stream_err:.3e} "
          f"(rtol {MIMI_STREAM_RTOL})")
    check(streamed.shape[1] == wav.shape[1] and stream_err <= MIMI_STREAM_RTOL,
          f"mimi decode_step: {tuple(streamed.shape)}, {stream_err:.3e} from offline")
    # encode_step in uneven chunks: its codes against offline, its latents kept
    card.reset_state()
    quantize, lats = M.quantizer_encode, []

    def keep(p, h):
        lats.append(h)
        return quantize(p, h)

    M.quantizer_encode = keep
    try:
        pieces, s, i = [], 0, 0
        while s < audio.size:
            n = MIMI_ENCODE_CHUNKS[i % len(MIMI_ENCODE_CHUNKS)]
            pieces.append(card.encode_step(audio[None, s:s + n]))
            s, i = s + n, i + 1
    finally:
        M.quantizer_encode = quantize
    step_codes = torch.cat(pieces, dim=2).cpu().numpy()
    step_lat = torch.cat(lats, dim=1).cpu().numpy()
    k = step_codes.shape[2]
    check(0 < k <= frames, f"mimi encode_step: {k} frames")
    step_witness = rvq_witness("mimi encode_step", card.params["quantizer"],
                               lat[:, :k].numpy(), step_lat, codes.cpu().numpy()[:, :, :k],
                               step_codes)
    print(f"[mimi encode_step] {i} chunks of {list(MIMI_ENCODE_CHUNKS)} samples (cycled): {k} "
          f"frames, latent rel err against offline {rel_err(torch.from_numpy(step_lat), lat[:, :k]):.3e}")
    # RTF, and a streamed frame
    _, enc_walls = timed_walls(lambda: card.encode(audio), dev, 3)
    _, dec_walls = timed_walls(lambda: card.decode(codes_cpu), dev, 3)
    dec = M.MimiStreamingDecoder(card)
    frame_walls = []
    for t in range(MIMI_STREAM_FRAMES):
        t0 = time.perf_counter()
        dec.decode_frames(codes_cpu[:, :, t:t + 1])
        frame_walls.append((time.perf_counter() - t0) * 1e3)
    busy, events = marked_window(lambda: card.decode_step(
        codes_cpu[:, :, MIMI_STREAM_FRAMES:MIMI_STREAM_FRAMES + 1]), "mimi frame")
    enc_busy, enc_events = marked_window(lambda: card.encode(audio), "mimi encode")
    dec_busy, dec_events = marked_window(lambda: card.decode(codes_cpu), "mimi decode")
    bounds = {}
    for name, fn, parts, io_bytes, extra in (
            ("encode", lambda: card.encode(audio),
             ("encoder", "encoder_transformer", "downsample", "quantizer"),
             4 * audio.size + 8 * codes.numel(), rvq_flops(cfg, frames)),
            ("decode", lambda: card.decode(codes_cpu),
             ("quantizer", "upsample", "decoder_transformer", "decoder"),
             8 * codes.numel() + nbytes(wav), 0.0)):
        ops = [0.0]
        with counted_flops(ops):
            fn()
        b_ms, b_by = bound(sum(nbytes(*_tensors(card.params[k])) for k in parts) + io_bytes,
                           f32_ops=ops[0] + extra)
        bounds[name] = dict(gflop=(ops[0] + extra) / 1e9, bound_ms=b_ms, bound_by=b_by)
    print(f"[mimi bound] {MIMI_SECONDS} s: encode {bounds['encode']['gflop']:.3f} GFLOP f32, "
          f"bound {bounds['encode']['bound_ms']:.4f} ms ({bounds['encode']['bound_by']}); decode "
          f"{bounds['decode']['gflop']:.3f} GFLOP, bound {bounds['decode']['bound_ms']:.4f} ms "
          f"({bounds['decode']['bound_by']}) ({smi})")
    peak = peak_gb()
    steady = frame_walls[2:]
    out = dict(seconds=MIMI_SECONDS, codes_shape=list(codes.shape), latent_rel_err=lat_err,
               latent_tf32_control=lat_leak, encode=enc_witness, decode_rel_err=wav_err,
               decode_tf32_control=wav_leak, decode_step_rel_err=stream_err,
               encode_step=step_witness, encode_walls_s=enc_walls, decode_walls_s=dec_walls,
               rtf_encode=min(enc_walls) / MIMI_SECONDS, rtf_decode=min(dec_walls) / MIMI_SECONDS,
               encode_device_ms=None if enc_busy is None else enc_busy / 1e3,
               encode_device_events=enc_events,
               decode_device_ms=None if dec_busy is None else dec_busy / 1e3,
               decode_device_events=dec_events, bounds=bounds, frame_host_ms=frame_walls,
               frame_host_ms_median=statistics.median(steady),
               frame_device_ms=None if busy is None else busy / 1e3, frame_device_events=events,
               peak_memory_gb=peak, phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[mimi time] {MIMI_SECONDS} s: encode {min(enc_walls) * 1e3:.3f} ms (RTF "
          f"{out['rtf_encode']:.5f}; device {fmt(out['encode_device_ms'])}, {enc_events} events), "
          f"decode {min(dec_walls) * 1e3:.3f} ms (RTF {out['rtf_decode']:.5f}; device "
          f"{fmt(out['decode_device_ms'])}, {dec_events} events); a streamed frame (80 ms of "
          f"audio) {out['frame_host_ms_median']:.3f} host ms (median of frames 3-"
          f"{MIMI_STREAM_FRAMES}, readback included), device {fmt(out['frame_device_ms'])}, "
          f"{events} events; peak {peak:.3f} GB; phase {out['phase_s']:.1f} s ({smi})")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def clone_main(smi: str) -> int:
    """``--clone``: the [qwen3 clone] phase on a freshly built [qwen3 tts]
    8-bit model, then [mimi], then their JSON and kernel 1's speaker-mel
    fields as one line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    q8 = build_qwen3(dev)["8bit"]
    clone, k1 = qwen3_clone_phase(q8, dev, smi)
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    mimi = mimi_phase(dev, smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"qwen3_clone": clone, "mimi": mimi, "kernel1": k1}))
    return 0


def qwen3_phase(dev, smi: str, clone: bool = False) -> tuple[dict, dict, dict]:
    """The ``[qwen3 tts]`` phase: builds the bf16 and 8-bit models
    (``build_qwen3``), holds kernel 7 at every Qwen3 shape
    (``qwen3_qmm_checks``), runs the 8-bit greedy ``generate`` twice and
    ``generate_stream`` with the launch counts (``qwen3_generate_phase``),
    the teacher-forced logits (``qwen3_teacher_forced``), a greedy bf16
    ``generate``, and the timings of both (``qwen3_timing``); then the
    ``[qwen3 serve]`` phase on the 8-bit model (``qwen3_serve_phase``, its
    JSON under ``serve``) and, with ``clone``, the ``[qwen3 clone]`` phase on
    it (``qwen3_clone_phase``, under ``clone``). Returns the phases' JSON,
    kernel 7's Qwen3 fields for its two records and kernel 1's speaker-mel
    fields (empty without ``clone``)."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.ops import _lib

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[qwen3 tts] cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} (float32 codec "
          f"convolutions and products in full float32)")
    t0 = time.perf_counter()
    models = build_qwen3(dev)
    torch.cuda.synchronize()
    q8 = models["8bit"]
    n = qwen3_products(q8)
    bound_frame = sum(qmm_bound(r, o, i, 8, 64)[0] for r, o, i in n["shapes"])
    tc, cc = q8.config.talker, q8.config.code_predictor
    print(f"Qwen3-TTS (talker {tc.num_hidden_layers} x {tc.hidden_size}, code predictor "
          f"{cc.num_hidden_layers} x {cc.hidden_size}, {tc.num_code_groups} groups) bf16 and MLX "
          f"8-bit (g 64) and the 12.5 Hz codec decoder built on the card in "
          f"{time.perf_counter() - t0:.1f} s; kernel 7 a frame: {n['decode']} decode-kernel and "
          f"{n['tile']} tile launches, bound {bound_frame:.4f} ms (bytes; {smi})")
    checks = qwen3_qmm_checks(q8)
    runs, launches, codes = qwen3_generate_phase(q8)
    forced = qwen3_teacher_forced(q8, codes)
    gp = AudioGenerateParameters(max_tokens=QWEN3_FRAMES, temperature=0.0,
                                 repetition_penalty=1.05, repetition_context_size=64)
    bf16 = models["bf16"]
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = bf16.generate(QWEN3_TEXT, generation_parameters=gp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hop = bf16.codec.config.total_upsample
    check(bool(np.isfinite(wav).all()) and wav.shape[0] % hop == 0
          and not any(_lib.launches.values()),
          f"qwen3 bf16: waveform {wav.shape}, launches {dict(_lib.launches)}")
    print(f"[qwen3 bf16 generate] {wav.shape[0] // hop} frames in {wall:.3f} s "
          f"({wall * 1e3 * hop / wav.shape[0]:.3f} ms a frame with the prefill and the decode); "
          f"realtime x {wav.shape[0] / bf16.sample_rate / wall:.3f}")
    timing = {name: qwen3_timing(m, name) for name, m in models.items()}
    timing["8bit"].update(kernel7_bound_ms_a_frame=bound_frame)
    out = dict(runs=runs, bf16_generate=dict(frames=wav.shape[0] // hop, wall_s=wall,
                                             realtime_x=wav.shape[0] / bf16.sample_rate / wall),
               teacher_forced=forced, timing=timing, qmm_checks=checks,
               tf32=dict(cudnn=torch.backends.cudnn.allow_tf32,
                         matmul=torch.backends.cuda.matmul.allow_tf32),
               phase_s=time.perf_counter() - t_phase, smi=smi)
    k7 = {"quantized_matvec": dict(qwen3_launches=launches["quantized_matvec_decode"],
                                   qwen3=dict(launches_a_frame=n["decode"],
                                              device_ms_a_frame=timing["8bit"][
                                                  "kernel7_device_ms_a_frame"],
                                              bound_ms_a_frame=bound_frame)),
          "quantized_matvec_tile": dict(qwen3_launches=launches["quantized_matvec_tile"],
                                        qwen3=dict(launches_a_frame=n["tile"]))}
    print(f"[qwen3 tts] phase {out['phase_s']:.1f} s")
    out["serve"], serve_k7 = qwen3_serve_phase(q8, smi)
    k7["quantized_matvec_tile"].update(serve_k7)
    k7["quantized_matvec"]["qwen3_serve_launches"] = out["serve"]["run"]["launches"].get(
        "quantized_matvec_decode", 0)
    k1 = {}
    if clone:
        out["clone"], k1 = qwen3_clone_phase(q8, dev, smi)
    del models, q8, bf16
    gc.collect()
    torch.cuda.empty_cache()
    return out, k7, k1


def parakeet_config():
    """Parakeet-TDT-0.6B at its published widths (nvidia/parakeet-tdt-0.6b-v2):
    128 mel features, a 24-layer FastConformer of d_model 1024 (8 heads, ff
    x4, rel_pos attention, conv kernel 9) behind dw_striding subsampling by 8
    with 256 channels, 1,024 pieces and the blank, durations 0-4, at most 10
    symbols a frame, a 1-layer LSTM prediction network of 640 and a ReLU
    joint of 640. The pieces are stand-ins (letters, every 41st a period)."""
    from tpu_audio_torch.models.stt import parakeet as TP

    vocab = ["." if i % 41 == 40 else ("▁" if i % 3 == 0 else "") + chr(ord("a") + i % 26)
             for i in range(1024)]
    return TP.ParakeetConfig(
        variant="tdt", preprocess=TP.PreprocessConfig(features=128),
        encoder=TP.ConformerConfig(feat_in=128, n_layers=24, d_model=1024, n_heads=8,
                                   ff_expansion_factor=4, subsampling_factor=8,
                                   subsampling_conv_channels=256, conv_kernel_size=9),
        vocabulary=vocab, durations=[0, 1, 2, 3, 4], max_symbols=10, pred_hidden=640,
        pred_rnn_layers=1, joint_hidden=640)


def randomize_parakeet_norms(tree: dict, gen) -> None:
    """Give every LayerNorm and BatchNorm weight 1 + N(0, 0.1) and bias N(0,
    0.1), every BatchNorm running mean N(0, 0.1) and running variance 1 +
    |N(0, 0.2)|, in place (init makes them 1 and 0, which a wrong row would
    not show)."""
    import torch

    def randn(t, std, mean=0.0):
        return (mean + std * torch.randn(t.shape, generator=gen, device=t.device)).to(t.dtype)

    for k, v in tree.items():
        if isinstance(v, dict) and (k.startswith("norm_") or k == "batch_norm"):
            v["weight"] = randn(v["weight"], 0.1, 1.0)
            v["bias"] = randn(v["bias"], 0.1)
            if k == "batch_norm":
                v["running_mean"] = randn(v["running_mean"], 0.1)
                v["running_var"] = (1.0 + randn(v["running_var"], 0.2).float().abs()
                                    ).to(v["running_var"].dtype)
        elif isinstance(v, dict):
            randomize_parakeet_norms(v, gen)


def build_parakeet(dev) -> dict:
    """The bf16 model from seed-0 random weights (``init_random_params``)
    with seeded norms and BatchNorm statistics, and the same weights MLX
    8-bit in groups of 64 quantized on the card (every eligible linear, the
    prediction embedding and the joint's three products among them)."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt import parakeet as TP

    cfg = parakeet_config()
    params = TP.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    randomize_parakeet_norms(params, torch.Generator(device=dev).manual_seed(5))
    q8 = quant.quantize_tree(params, bits=8, group_size=64, scheme="mlx")
    packed = [q8["decoder"]["prediction"]["embed"]["weight"]] + [
        q8["joint"][n]["weight"] for n in ("enc", "pred", "joint_net")]
    check(all(isinstance(w, quant.QuantizedTensor) and w.bits == 8 for w in packed),
          "Parakeet 8-bit: the prediction embedding or a joint product is not packed")
    return {"bf16": TP.Parakeet(cfg, params, torch.bfloat16),
            "8bit": TP.Parakeet(cfg, q8, torch.bfloat16)}


def parakeet_encoder_flops(cfg, b: int, t: int, bucket: int) -> float:
    """The encoder's multiply-adds x 2 for ``b`` rows of ``bucket`` mel
    frames, ``t`` encoder frames: the subsampling convolutions and output
    projection, and in every layer the two FFNs, q/k/v/out, the position
    projection over 2t - 1 rows, the content and position scores, p @ v and
    the conv module."""
    e = cfg.encoder
    d, ch, k = e.d_model, e.subsampling_conv_channels, e.conv_kernel_size
    h, f, flops = bucket, e.feat_in, 0.0
    for i in range(int(math.log2(e.subsampling_factor))):
        h, f = (h + 1) // 2, (f + 1) // 2
        flops += 2 * b * h * f * ch * 9 * (1 if i == 0 else 1 + ch / 9)
    flops += 2 * b * t * (ch * f) * d
    layer = (2 * b * t * d * d * (2 * 2 * e.ff_expansion_factor + 4 + 3)
             + 2 * (2 * t - 1) * d * d + 2 * b * d * (2 * t * t + t * (2 * t - 1))
             + 2 * b * t * d * k)
    return flops + e.n_layers * layer


@contextlib.contextmanager
def parakeet_calls(out: list):
    """Record each ``TDTDecoder`` call's lattice (host arrays) and stats."""
    from tpu_audio_torch.models.stt import parakeet as TP

    call = TP.TDTDecoder.__call__

    def recorded(self, *a, **kw):
        lattice = call(self, *a, **kw)
        out.append((lattice, dict(self.stats)))
        return lattice

    TP.TDTDecoder.__call__ = recorded
    try:
        yield
    finally:
        TP.TDTDecoder.__call__ = call


@contextlib.contextmanager
def strict_steps(decoder):
    """Run the decoder's steps between stop reads under
    ``torch.cuda.set_sync_debug_mode("error")``: a step that waits for the
    device, or copies from it, raises."""
    import torch

    steps = decoder.steps

    def strict(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return steps(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    decoder.steps = strict
    try:
        yield
    finally:
        del decoder.steps


def same_lattices(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))


def parakeet_traced(model, feats, lens, strict: bool = False):
    """The decode loop over ``feats`` with every step traced: its lattice,
    stats, and the host arrays of each step's active mask, token, jump
    ``[S, B]`` and f32 joint logits ``[S, B, C]``."""
    import torch

    from tpu_audio_torch.models.stt import parakeet as TP

    dec = TP.TDTDecoder(model.config, model.max_emit(feats.shape[1], 8192))
    trace = []
    with strict_steps(dec) if strict else contextlib.nullcontext():
        lattice = dec(model.params, feats, lens, trace=trace)
    rows = tuple(torch.stack([t[i] for t in trace]).cpu().numpy() for i in (1, 2, 3, 4))
    return lattice, dict(dec.stats), rows


def parakeet_serial(model, feats, length: int):
    """The serial host reference of tests/test_parakeet.py (one row, a host
    read every step) on the card, traced as ``parakeet_traced`` traces."""
    import numpy as np
    import torch

    from tpu_audio_torch.models.stt import parakeet as TP

    cfg, blank, dev = model.config, model.config.blank_token, feats.device
    sdt = TP.prediction_dtype(model.params, model.dtype)
    h = torch.zeros((cfg.pred_rnn_layers, 1, cfg.pred_hidden), dtype=sdt, device=dev)
    c = torch.zeros_like(h)
    t, new_sym, last = 0, 0, blank
    toks, jumps, logits = [], [], []
    while t < length:
        pred, h_new, c_new = TP._predict_step(
            model.params, torch.tensor([last], dtype=torch.int32, device=dev), h, c, cfg)
        lg = TP._joint(model.params, feats[:1, t], pred.to(feats.dtype), cfg).float()
        lg = lg[0].cpu().numpy()
        tok = int(np.argmax(lg[: blank + 1]))
        jump = cfg.durations[int(np.argmax(lg[blank + 1:]))]
        next_t, next_new = t + jump, (0 if jump != 0 else new_sym + 1)
        if jump == 0 and next_new >= cfg.max_symbols:
            next_t, next_new = next_t + 1, 0
        if tok != blank:
            last, h, c = tok, h_new, c_new
        toks.append(tok)
        jumps.append(jump)
        logits.append(lg)
        t, new_sym = next_t, next_new
    n = len(toks)
    return (np.ones((n, 1), bool), np.asarray(toks)[:, None], np.asarray(jumps)[:, None],
            np.stack(logits)[:, None])


def parakeet_parting(label: str, blank: int, ref, got, r_ref: int, r_got: int) -> dict:
    """One row's decisions (token, jump at each of its active steps) on two
    routes: equal, or parting first at a step where the reference route's
    top two (of the tokens, or of the durations, whichever parted) lie
    within the routes' largest joint-logit difference at that step, and
    that within PARAKEET_LOGITS_RTOL of the largest logit: a near tie that
    the routes' rounding decides."""
    import numpy as np

    ia, ib = np.nonzero(ref[0][:, r_ref])[0], np.nonzero(got[0][:, r_got])[0]
    da = list(zip(ref[1][ia, r_ref].tolist(), ref[2][ia, r_ref].tolist()))
    db = list(zip(got[1][ib, r_got].tolist(), got[2][ib, r_got].tolist()))
    k = next((i for i, (x, y) in enumerate(zip(da, db)) if x != y), None)
    if k is None:
        check(len(da) == len(db), f"{label}: the same decisions over {min(len(da), len(db))} "
              f"steps, but {len(da)} against {len(db)} steps")
        return dict(equal=True, steps=len(da))
    la, lb = ref[3][ia[k], r_ref], got[3][ib[k], r_got]
    diff = float(np.abs(la - lb).max())
    rel = diff / float(np.abs(la).max())
    margins = {}
    for part, sl, differs in (("token", slice(0, blank + 1), da[k][0] != db[k][0]),
                              ("duration", slice(blank + 1, None), da[k][1] != db[k][1])):
        if differs and la[sl].size > 1:
            top = np.sort(la[sl])[::-1]
            margins[part] = float(top[0] - top[1])
    ok = all(m <= diff for m in margins.values()) and rel <= PARAKEET_LOGITS_RTOL
    print(f"[parakeet witness] {label}: decisions part at step {k} of {len(da)} ({da[k]} "
          f"against {db[k]}): top-two margins {margins}, joint logits {diff:.4e} apart (rel "
          f"{rel:.3e}, rtol {PARAKEET_LOGITS_RTOL}): "
          f"{'a near tie' if ok else 'NOT a near tie'}")
    check(ok, f"{label}: lattices part at step {k} without a witnessed near tie")
    return dict(equal=False, step=k, steps=len(da), margins=margins, max_diff=diff,
                rel_diff=rel)


def parakeet_batch_phase(model, clips) -> dict:
    """``bench_parakeet_batch``'s protocol on the bf16 model: one warm
    ``generate_batch`` of the clips, then PARAKEET_TIMED timed, every run's
    lattice bit for bit the same; RTFx over the fastest; the frontend,
    encoder and decode-loop split (CUDA events), decode steps, host reads
    and device events a step, the loop's busy share (``torch.profiler``,
    the union of its intervals over the loop's wall) and the peak device
    memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import parakeet as TP

    gp = STTGenerateParameters(max_tokens=8192)
    seconds = sum(len(c) for c in clips) / 16000
    calls, walls = [], []
    with parakeet_calls(calls):
        outs = model.generate_batch(clips, gp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PARAKEET_TIMED):
            t0 = time.perf_counter()
            again = model.generate_batch(clips, gp)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(all(same_lattices(calls[0][0], c[0]) for c in calls[1:])
          and [o.text for o in outs] == [o.text for o in again],
          "parakeet bf16: the lattices of two generate_batch runs differ")
    counts = calls[0][0][3]
    check(all(o.generation_token_count > 0 for o in outs) and bool((counts > 0).all()),
          f"parakeet bf16: a clip emitted nothing ({counts.tolist()})")
    stats = calls[0][1]
    # the split: each piece between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    batch, lengths = model.mel_batch(clips)
    ev[1].record()
    feats, lens = model._encode(model.params, batch, lengths)
    ev[2].record()
    dec = TP.TDTDecoder(model.config, model.max_emit(feats.shape[1], gp.max_tokens))
    t0 = time.perf_counter()
    lattice = dec(model.params, feats, lens)
    loop_wall = time.perf_counter() - t0
    ev[3].record()
    torch.cuda.synchronize()
    check(same_lattices(lattice, calls[0][0]), "parakeet bf16: the split run's lattice differs")
    split = dict(frontend_ms=ev[0].elapsed_time(ev[1]), encoder_ms=ev[1].elapsed_time(ev[2]),
                 decode_ms=ev[2].elapsed_time(ev[3]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        markers(STACK_READS[0][1])
        t0 = time.perf_counter()
        dec(model.params, feats, lens)
        prof_wall = time.perf_counter() - t0
    busy_us, n_events = device_busy(prof)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        markers(STACK_READS[0][1])
        model._encode(model.params, batch, lengths)
        torch.cuda.synchronize()
    enc_busy_us = device_busy(prof)[0]
    enc_kernels = sorted(((n, c, us / 1e3) for n, (c, us) in by_kernel(prof).items()
                          if "spin_kernel" not in n), key=lambda k: -k[2])[:8]
    steps = stats["steps"]
    t_enc = int(feats.shape[1])
    flops = parakeet_encoder_flops(model.config, len(clips), t_enc, int(batch.shape[1]))
    enc_bound = bound(nbytes(batch, feats) + sum(
        t.numel() * t.element_size() for t in _tensors(model.params["encoder"])),
        bf16_ops=flops)
    out = dict(clips=len(clips), audio_s=seconds, walls_s=walls, rtfx=seconds / min(walls),
               mel_frames=int(lengths.max()), bucket=int(batch.shape[1]), encoder_frames=t_enc,
               split_ms=split, decode_wall_ms=loop_wall * 1e3, steps=steps,
               host_reads=stats["reads"], emitted=counts.tolist(),
               device_events_a_step=n_events / steps,
               decode_busy_ms=busy_us / 1e3, decode_profiled_wall_ms=prof_wall * 1e3,
               decode_busy_share=busy_us / 1e3 / (prof_wall * 1e3),
               host_ms_a_step=loop_wall * 1e3 / steps,
               encoder_device_ms=enc_busy_us / 1e3,
               encoder_kernels=[dict(name=n[:80], count=c, ms=ms) for n, c, ms in enc_kernels],
               encoder_tflop=flops / 1e12, encoder_bound_ms=enc_bound[0],
               encoder_bound_by=enc_bound[1], peak_memory_gb=peak / 1e9)
    print(f"[parakeet bf16] {len(clips)} x {seconds / len(clips):.0f} s: walls "
          f"{[round(w, 4) for w in walls]} s, RTFx {out['rtfx']:.1f}; split (CUDA events) "
          f"frontend {split['frontend_ms']:.3f} ms, encoder {split['encoder_ms']:.3f} ms "
          f"(bound {enc_bound[0]:.3f} ms by {enc_bound[1]}: {flops / 1e12:.3f} TFLOP bf16), "
          f"decode loop {split['decode_ms']:.3f} ms; {lengths.max().item()} mel frames in a "
          f"{batch.shape[1]}-frame bucket, {t_enc} encoder frames; {steps} decode steps, "
          f"{stats['reads']} host reads, {loop_wall * 1e3 / steps:.4f} ms a step; emitted "
          f"{counts.tolist()}; profiled loop: {n_events / steps:.1f} device events a step, "
          f"busy {busy_us / 1e3:.3f} of {prof_wall * 1e3:.3f} ms (share "
          f"{out['decode_busy_share']:.4f}); peak memory {peak / 1e9:.3f} GB")
    print(f"[parakeet encoder] profiled: device busy {enc_busy_us / 1e3:.3f} ms; by kernel:")
    for n, c, ms in enc_kernels:
        print(f"  {ms:9.3f} ms {c:6d} x  {n[:90]}")
    return out


def _tensors(tree):
    from tpu_audio_torch.core import quant

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, quant.QuantizedTensor):
        yield from (tree.weight, tree.scales, tree.biases)
    else:
        yield tree


def parakeet_mixed_phase(model, clips) -> dict:
    """A mixed batch (the speech clip, the two-speaker clip, 12 s and 30 s
    of noise) on the bf16 model: the loop over the batch with every step
    between stop reads under ``set_sync_debug_mode("error")``; each row's
    decisions against the loop on that row alone over the same features,
    and row 0's against the serial host reference, each equal or parted at
    a witnessed near tie."""
    batch, lengths = model.mel_batch(clips)
    feats, lens = model._encode(model.params, batch, lengths)
    lattice, stats, rows = parakeet_traced(model, feats, lens, strict=True)
    blank = model.config.blank_token
    out = dict(seconds=[len(c) / 16000 for c in clips], encoder_frames=lens.tolist(),
               steps=stats["steps"], host_reads=stats["reads"], emitted=lattice[3].tolist(),
               rows=[])
    alone0 = None
    for r in range(len(clips)):
        alone, _, arows = parakeet_traced(model, feats[r : r + 1], lens[r : r + 1])
        alone0 = arows if r == 0 else alone0
        out["rows"].append(parakeet_parting(f"mixed row {r} in the batch against alone", blank,
                                            arows, rows, 0, r))
    serial = parakeet_serial(model, feats[:1], int(lens[0]))
    out["serial"] = parakeet_parting("row 0 alone against the serial host reference", blank,
                                     serial, alone0, 0, 0)
    print(f"[parakeet mixed] {len(clips)} clips ({[round(s, 1) for s in out['seconds']]} s): "
          f"{stats['steps']} steps, {stats['reads']} host reads, no host sync between reads; "
          f"emitted {lattice[3].tolist()}; rows equal alone: "
          f"{[r['equal'] for r in out['rows']]}; serial reference equal: "
          f"{out['serial']['equal']}")
    return out


def parakeet_q8_phase(model, clips) -> tuple[dict, dict]:
    """The MLX 8-bit tree: kernel 7 against its plain version at the joint's
    three shapes at 1 and 8 rows (bf16 x); a ``generate_batch`` of the clips
    with the launch counters reset just before and read just after: the
    tile 3 times a decode step, no decode kernel, no GEMV, no other kernel,
    no plain call and no dequantized joint, the packed embedding's f32
    LSTM state through bf16 features; the lattice against the same loop on
    kernel 7's plain version over the same features; RTFx."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import parakeet as TP
    from tpu_audio_torch.ops import _lib, qmm

    joint = {n: model.params["joint"][n]["weight"] for n in ("enc", "pred", "joint_net")}
    gen = torch.Generator(device=model.device).manual_seed(13)
    checks = []
    for n, w in joint.items():
        for rows, want in ((1, "decode"), (PARAKEET_CLIPS, "tile")):
            x = torch.randn((rows, w.weight.shape[1] * 32 // w.bits), generator=gen,
                            device=model.device).to(torch.bfloat16)
            err, _, ran = qmm_check(f"parakeet joint.{n} [{rows}]", x, w.weight, w.scales,
                                    w.biases, w.group_size, w.bits)
            check(ran == want, f"parakeet joint.{n} at {rows} rows ran the {ran}, not the {want}")
            checks.append(dict(shape=f"joint.{n}", rows=rows, kernel=ran, o=w.weight.shape[0],
                               i=x.shape[1], rel_err=err))
    print("[parakeet qmm] kernel 7 at the joint's 3 shapes (8-bit, g 64, bf16 x): "
          + ", ".join(f"{c['shape']} [{c['rows']}] {c['kernel']} rel err {c['rel_err']:.3e}"
                      for c in checks) + f" (rtol {QMM_BF16_RTOL})")
    check(TP.prediction_dtype(model.params, model.dtype) == torch.float32,
          "parakeet 8-bit: the packed embedding's LSTM state is not f32")
    gp = STTGenerateParameters(max_tokens=8192)
    words = {w.weight.data_ptr() for w in joint.values()}
    seen = {"ref": 0, "joint_dequantized": 0}
    ref, deq = qmm.quantized_matvec_ref, quant.dequantize

    def ref_spy(*a, **kw):
        seen["ref"] += 1
        return ref(*a, **kw)

    def deq_spy(w, *a, **kw):
        seen["joint_dequantized"] += w.data_ptr() in words
        return deq(w, *a, **kw)

    calls = []
    qmm.quantized_matvec_ref, quant.dequantize = ref_spy, deq_spy
    try:
        _lib.reset_launches()
        torch.cuda.synchronize()
        with parakeet_calls(calls):
            t0 = time.perf_counter()
            outs = model.generate_batch(clips, gp)
            torch.cuda.synchronize()
            first_wall = time.perf_counter() - t0
        launches = {k: v for k, v in _lib.launches.items() if v}
    finally:
        qmm.quantized_matvec_ref, quant.dequantize = ref, deq
    steps = calls[0][1]["steps"]
    want = {"quantized_matvec": 3 * steps, "quantized_matvec_tile": 3 * steps}
    print(f"[parakeet 8bit] generate_batch: {steps} decode steps, launches {launches} "
          f"(expected {want}), plain calls {seen['ref']}, joint dequantized "
          f"{seen['joint_dequantized']} times; emitted {calls[0][0][3].tolist()}")
    check(launches == want and seen["ref"] == 0 and seen["joint_dequantized"] == 0,
          f"parakeet 8-bit: launches {launches}, plain calls {seen['ref']}, joint dequantized "
          f"{seen['joint_dequantized']} (expected {want}, none and none)")
    check(all(o.generation_token_count > 0 for o in outs), "parakeet 8-bit: a clip emitted nothing")
    walls = []
    for _ in range(PARAKEET_TIMED):
        t0 = time.perf_counter()
        model.generate_batch(clips, gp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    seconds = sum(len(c) for c in clips) / 16000
    batch, lengths = model.mel_batch(clips)
    feats, lens = model._encode(model.params, batch, lengths)
    lattice, _, rows = parakeet_traced(model, feats, lens)
    with plain_kernels():
        plain_lattice, _, plain_rows = parakeet_traced(model, feats, lens)
    blank = model.config.blank_token
    vs_plain = [parakeet_parting(f"8-bit row {r}, kernel 7 against its plain version", blank,
                                 plain_rows, rows, r, r) for r in range(len(clips))]
    step_bound = sum(qmm_bound(len(clips), w.weight.shape[0], w.weight.shape[1] * 32 // w.bits,
                               w.bits, w.group_size, x_bytes=2)[0] for w in joint.values())
    # a decode step's three products at the batch's rows (bf16 x): the tile
    # and its plain version, per step (CUDA events) and on the device
    xs = [torch.randn((len(clips), w.weight.shape[1] * 32 // w.bits), generator=gen,
                      device=model.device).to(torch.bfloat16) for w in joint.values()]

    def step_products(fn):
        return lambda: [fn(x, w.weight, w.scales, w.biases, w.group_size, w.bits)
                        for x, w in zip(xs, joint.values())]

    timed = dict(ms_a_step=cuda_ms(step_products(qmm.quantized_matvec)),
                 plain_ms_a_step=cuda_ms(step_products(qmm.quantized_matvec_ref)),
                 dev_ms_a_step=device_ms(step_products(qmm.quantized_matvec), launches=9),
                 plain_dev_ms_a_step=device_ms(step_products(qmm.quantized_matvec_ref)))
    out = dict(steps=steps, launches=launches, plain_calls=seen["ref"],
               joint_dequantized=seen["joint_dequantized"], first_wall_s=first_wall,
               walls_s=walls, rtfx=seconds / min(walls), qmm_checks=checks,
               vs_plain=vs_plain, emitted=calls[0][0][3].tolist(),
               kernel7_bound_ms_a_step=step_bound, kernel7_a_step=timed)
    print(f"[parakeet 8bit] walls {[round(w, 4) for w in walls]} s, RTFx {out['rtfx']:.1f}; "
          f"rows equal to the plain route: {[v['equal'] for v in vs_plain]}; kernel 7 a step "
          f"(3 tiles at {len(clips)} rows): {timed['ms_a_step']:.4f} ms per step (CUDA events), "
          f"{fmt(timed['dev_ms_a_step'])} device, plain {timed['plain_ms_a_step']:.4f} / "
          f"{fmt(timed['plain_dev_ms_a_step'])}, bound {step_bound:.4f} ms (bytes)")
    k7 = {"quantized_matvec_tile": dict(parakeet_launches=launches["quantized_matvec_tile"],
                                        parakeet=dict(launches_a_step=3, rows=len(clips),
                                                      steps=steps, bound_ms_a_step=step_bound,
                                                      **timed)),
          "quantized_matvec": dict(parakeet_launches=launches.get("quantized_matvec_decode", 0))}
    return out, k7


def parakeet_long_phase(model, speech) -> dict:
    """A 60 s clip (the speech clip, then seeded noise) through ``generate``
    with ``chunk_duration`` 20 s: its chunks decoded in one batch and
    merged; the segment starts rise."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters

    n = int(PARAKEET_LONG_S * 16000)
    rng = np.random.default_rng(2)
    audio = np.concatenate([speech, (rng.standard_normal(n) * 0.1).astype(np.float32)])[:n]
    calls = []
    with parakeet_calls(calls):
        t0 = time.perf_counter()
        out = model.generate(audio, STTGenerateParameters(max_tokens=8192,
                                                          chunk_duration=PARAKEET_CHUNK_S))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    starts = [s.start for s in out.segments]
    check(len(calls) == 1 and len(calls[0][0][3]) == 4,
          f"parakeet 60 s: {len(calls)} decode calls of {[len(c[0][3]) for c in calls]} rows "
          "(expected one of 4 chunks)")
    check(starts == sorted(starts), f"parakeet 60 s: segment starts fall: {starts[:8]}")
    res = dict(seconds=PARAKEET_LONG_S, chunk_s=PARAKEET_CHUNK_S, chunks=len(calls[0][0][3]),
               tokens=out.generation_token_count, segments=len(out.segments),
               text_chars=len(out.text), wall_s=wall, last_start=starts[-1] if starts else None)
    print(f"[parakeet 60 s] generate (chunks of {PARAKEET_CHUNK_S:.0f} s): {res['chunks']} "
          f"chunks in one batch, {res['tokens']} merged tokens, {res['segments']} segments "
          f"(starts rise, last at {res['last_start']}), {len(out.text)} characters, "
          f"{wall:.3f} s")
    return res


def parakeet_phase(dev, smi: str) -> tuple[dict, dict]:
    """The ``[parakeet]`` phase: builds the bf16 and 8-bit models
    (``build_parakeet``), runs ``bench_parakeet_batch``'s protocol on the
    bf16 model (``parakeet_batch_phase``), the mixed batch
    (``parakeet_mixed_phase``), the 8-bit tree (``parakeet_q8_phase``) and
    the chunked 60 s ``generate`` (``parakeet_long_phase``). Returns the
    phase's JSON and kernel 7's Parakeet fields for its two records."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.audio_io import load_audio

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    models = build_parakeet(dev)
    torch.cuda.synchronize()
    e = models["bf16"].config.encoder
    print(f"Parakeet-TDT (FastConformer {e.n_layers} x {e.d_model}, subsampling "
          f"{e.subsampling_factor}, vocab {len(models['bf16'].config.vocabulary)} + blank) bf16 "
          f"and MLX 8-bit (g 64) built on the card in {time.perf_counter() - t0:.1f} s ({smi})")
    rng = np.random.default_rng(0)
    n = int(PARAKEET_CLIP_S * 16000)
    clips = [(rng.standard_normal(n).astype(np.float32) * 0.1) for _ in range(PARAKEET_CLIPS)]
    speech = load_audio(str(AUDIO), sample_rate=16000)[0]
    noise = np.random.default_rng(1)
    mixed = [speech, load_audio(str(AUDIO2), sample_rate=16000)[0]] + [
        (noise.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
        for s in PARAKEET_MIXED_NOISE_S]
    out = dict(batch=parakeet_batch_phase(models["bf16"], clips),
               mixed=parakeet_mixed_phase(models["bf16"], mixed))
    out["8bit"], k7 = parakeet_q8_phase(models["8bit"], clips)
    out["long"] = parakeet_long_phase(models["bf16"], speech)
    out.update(phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[parakeet] phase {out['phase_s']:.1f} s")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return out, k7


# -- [vad]: Silero VAD and Sortformer-4spk (BASELINE config 2) ------------------


def vad_sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def sortformer_config():
    """Sortformer-4spk at the widths of ``bench_vad_diarization``
    (``bench.py:903-905``): an 18 x 512 FastConformer (8 heads, ff 2,048, conv
    kernel 9) behind conv subsampling by 8 with 256 channels over 128 mels,
    an 18 x 192 transformer (8 heads, ffn 768) with ``TFEncoderConfig``'s
    1,500 learned positions, and ``ModulesConfig``'s defaults (spkcache and
    FIFO 188, update period 144, 3 silence frames a speaker)."""
    from tpu_audio_torch.models.vad import sortformer as TS

    return TS.SortformerConfig(
        fc_encoder=TS.FCEncoderConfig(hidden_size=512, num_hidden_layers=18,
                                      num_attention_heads=8, intermediate_size=2048,
                                      num_mel_bins=128, subsampling_conv_channels=256),
        tf_encoder=TS.TFEncoderConfig(d_model=192, encoder_layers=18, encoder_attention_heads=8,
                                      encoder_ffn_dim=768, max_source_positions=1500),
        modules=TS.ModulesConfig(),
        processor=TS.ProcessorConfig(feature_size=128))


def build_vad(dev, cfg=None) -> dict:
    """Silero v5 (both branches) and Sortformer-4spk (``cfg``, by default
    ``sortformer_config()``) from seeded random weights built on ``dev``
    (f32), and the same weights copied to the CPU for the port's CPU runs."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.vad import silero as TSil
    from tpu_audio_torch.models.vad import sortformer as TS

    cfg = cfg or sortformer_config()
    sil = TSil.init_random_params(seed=0, device=dev)
    srt = TS.init_random_params(cfg, seed=0, dtype=torch.float32, device=dev)
    return {"silero": TSil.SileroVAD(TSil.SileroVADConfig(), sil),
            "silero_cpu": TSil.SileroVAD(TSil.SileroVADConfig(), loading.to_device(sil, "cpu")),
            "sortformer": TS.Sortformer(cfg, srt, torch.float32),
            "sortformer_cpu": TS.Sortformer(cfg, loading.to_device(srt, "cpu"), torch.float32)}


def timed_walls(fn, dev, reps: int = VAD_TIMED):
    """One warm-up call of ``fn``, then ``reps`` walls (host clock, the
    device synchronized): (first result, walls)."""
    out = fn()
    vad_sync(dev)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        vad_sync(dev)
        walls.append(time.perf_counter() - t0)
    return out, walls


def marked_window(fn, label: str) -> tuple[float | None, int]:
    """(device busy microseconds, device events) of one call of ``fn`` from
    ``marked_spans``; (None, 0) where not measured."""
    spans = marked_spans(fn, label)
    return (None, 0) if spans is None else (interval_union(spans), len(spans))


def marked_spans(fn, label: str) -> list | None:
    """The device activities, (start, end, name), of one call of ``fn``
    under ``torch.profiler`` (device activity only: the host side of a few
    thousand eager launches would cost the profiler seconds to gather).
    As in ``stack_launches``, each window brackets the call with sleep
    kernels before and after it, each set behind a synchronize and a wait
    on the host (STACK_READS); the markers are not counted. A window that
    kept no leading or no trailing marker may have lost events of the call
    (late in the full run the profiler drops a window's first events), and
    is read again with a longer wait and more leading markers; after the
    last read the call is "not measured" (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for lead, leading in STACK_READS:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(lead)
            markers(leading)
            fn()
            torch.cuda.synchronize()
            markers(STACK_MARKERS)
            time.sleep(lead)
        spans = device_intervals(prof)
        call = [i for i, s in enumerate(spans) if "spin_kernel" not in s[2]]
        if call and call[0] > 0 and call[-1] < len(spans) - 1:
            return [spans[i] for i in call]
        print(f"[{label} profile] {len(call)} events, {call[0] if call else 0} of {leading} "
              f"leading and {len(spans) - 1 - call[-1] if call else 0} of {STACK_MARKERS} "
              f"trailing markers kept, {lead} s wait: reading again")
    print(f"[{label} profile] no window kept its markers: not measured")
    return None


def profiled(fn, dev, label: str) -> tuple[float, float, int]:
    """(wall ms, device busy ms, device events) of one call of ``fn``: the
    wall from its own call, the device's from a ``marked_window`` (the union
    of the device intervals; None and 0 on the CPU or where not measured)."""
    import torch

    t0 = time.perf_counter()
    fn()
    if dev.type != "cuda":
        return (time.perf_counter() - t0) * 1e3, None, 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_us, events = marked_window(fn, label)
    return wall * 1e3, None if busy_us is None else busy_us / 1e3, events


def profiled_feeds(model, records) -> list[tuple[float | None, int]]:
    """(device busy ms, device events) of ``model.feed`` on each recorded
    chunk from its recorded state, each in a ``marked_window`` of its own."""
    out = []
    for i, r in enumerate(records):
        busy_us, events = marked_window(
            lambda: model.feed(r["chunk"], copy_state(r["before"])), f"vad sortformer chunk {i}")
        out.append((None if busy_us is None else busy_us / 1e3, events))
    return out


@contextlib.contextmanager
def tf32_leak(matmul: bool = False):
    """The control of the card-against-CPU limits: the models'
    ``nn.f32_convolutions`` guard bypassed, so that their convolutions run
    in TF32 (cuDNN's default, left on around the models by ``vad_phase`` and
    ``turn_lid_phase``), and with ``matmul`` their matrix products too.
    Those phases check that each limit lies below the control's reading,
    so that a leak of TF32 into the convolutions fails the run."""
    import torch

    from tpu_audio_torch.core import nn

    guard, mm = nn.f32_convolutions, torch.backends.cuda.matmul.allow_tf32
    nn.f32_convolutions = contextlib.nullcontext
    torch.backends.cuda.matmul.allow_tf32 = matmul or mm
    try:
        yield
    finally:
        nn.f32_convolutions = guard
        torch.backends.cuda.matmul.allow_tf32 = mm


def silero_phase(models, dev, smi: str) -> dict:
    """``bench_vad_silero``'s protocol (30 s of seeded noise x 0.1 through
    ``predict_proba``, a warm-up, the fastest of 3 walls) at 16 kHz and on
    the same noise decimated to 8 kHz; B = 4 rows against each row alone;
    ``feed`` over every chunk against ``predict_proba``; the card against
    the port's CPU run, and its TF32 control (``tf32_leak``); timestamps
    and speech runs of the two media clips; device events, host ms and busy
    share a chunk."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.vad.segmenter import SpeechSegmentConfig, detect_speech_runs

    card, cpu = models["silero"], models["silero_cpu"]
    t_part, parts = time.perf_counter(), {}
    rng = np.random.default_rng(0)
    audio = rng.standard_normal(int(16000 * VAD_SECONDS)).astype(np.float32) * 0.1
    out = {}
    for sr in (16000, 8000):
        # 8 kHz: each pair of samples averaged (a 2:1 decimation behind a box filter)
        a = audio if sr == 16000 else audio.reshape(-1, 2).mean(axis=1)
        parts[f"{sr // 1000}k input"] = time.perf_counter() - t_part
        probs, walls = timed_walls(lambda: card.predict_proba(a, sr), dev)
        parts[f"{sr // 1000}k walls"] = time.perf_counter() - t_part
        ref = cpu.predict_proba(a, sr)
        err = float(np.abs(probs - ref).max())
        with tf32_leak():
            leak = float(np.abs(card.predict_proba(a, sr) - ref).max())
        n = probs.shape[0]
        parts[f"{sr // 1000}k CPU"] = time.perf_counter() - t_part
        # the 16 kHz call profiled (the 8 kHz one runs as many LSTM steps)
        wall_ms, busy_ms, events = (
            profiled(lambda: card.predict_proba(a, sr), dev, "vad silero")
            if sr == 16000 else (None, None, 0))
        check(probs.shape == ref.shape == (-(-a.shape[0] // (512 if sr == 16000 else 256)),)
              and bool(np.isfinite(probs).all()), f"silero {sr} Hz: probabilities {probs.shape}")
        check(err <= SILERO_CARD_ATOL, f"silero {sr} Hz: card against CPU {err:.3e} > "
              f"{SILERO_CARD_ATOL}")
        res = dict(chunks=n, walls_s=walls, rtf=min(walls) / VAD_SECONDS,
                   card_vs_cpu=err, tf32_control=leak, host_ms_a_chunk=min(walls) * 1e3 / n,
                   device_events_a_chunk=events / n, profiled_wall_ms=wall_ms,
                   busy_ms=busy_ms, busy_share=None if busy_ms is None else busy_ms / wall_ms,
                   probs_range=[float(probs.min()), float(probs.max())])
        out[f"{sr // 1000}k"] = res
        parts[f"{sr // 1000}k"] = time.perf_counter() - t_part
        print(f"[vad silero {sr // 1000}k] {VAD_SECONDS:.0f} s of noise, {n} chunks: walls "
              f"{[round(w, 4) for w in walls]} s, RTF {res['rtf']:.6f} "
              f"({res['host_ms_a_chunk']:.4f} host ms a chunk); card against CPU "
              f"{err:.3e} (atol {SILERO_CARD_ATOL}; TF32 control {leak:.3e}); "
              + (f"profiled: {events / n:.2f} device events a chunk, busy {fmt(busy_ms)} of "
                 f"{wall_ms:.3f} ms (share {fmt_share(res['busy_share'])}); "
                 if wall_ms is not None else "")
              + f"probabilities {res['probs_range']} ({smi})")
    full = out["16k"]
    probs = card.predict_proba(audio)
    rows = np.stack([audio] + [rng.standard_normal(audio.shape[0]).astype(np.float32) * 0.1
                               for _ in range(VAD_ROWS - 1)])
    batch = card.predict_proba(rows)
    rows_err = max(float(np.abs(batch[i] - card.predict_proba(rows[i])).max())
                   for i in range(VAD_ROWS))
    check(rows_err <= SILERO_FEED_ATOL, f"silero: {VAD_ROWS} rows against each alone "
          f"{rows_err:.3e} > {SILERO_FEED_ATOL}")
    state, fed = None, []
    vad_sync(dev)
    t0 = time.perf_counter()
    for i in range(probs.shape[0]):
        chunk = audio[i * 512:(i + 1) * 512]
        p, state = card.feed(np.pad(chunk, (0, 512 - chunk.shape[0])), state)
        fed.append(p[0])
    feed_wall = time.perf_counter() - t0
    feed_err = float(np.abs(np.asarray(fed) - probs).max())
    check(feed_err <= SILERO_FEED_ATOL, f"silero: feed against predict_proba {feed_err:.3e} > "
          f"{SILERO_FEED_ATOL}")
    check(state["h"].device.type == dev.type, "silero: the feed state left the device")
    _, feed_busy, feed_events = profiled(lambda: card.feed(audio[:512], None), dev,
                                           "vad silero feed")
    parts["rows and feed"] = time.perf_counter() - t_part
    full.update(rows=VAD_ROWS, rows_vs_alone=rows_err, feed_vs_predict=feed_err,
                feed_host_ms_a_chunk=feed_wall * 1e3 / len(fed),
                feed_device_events_a_chunk=feed_events, feed_busy_ms=feed_busy)
    print(f"[vad silero] {VAD_ROWS} rows against each alone {rows_err:.3e}; feed over "
          f"{len(fed)} chunks against predict_proba {feed_err:.3e} (atol {SILERO_FEED_ATOL}), "
          f"{feed_wall * 1e3 / len(fed):.4f} host ms and {feed_events} device events a chunk")
    media = {}
    for path in (AUDIO, AUDIO2):
        a = load_audio(str(path), sample_rate=16000)[0]
        ts = [(t.start, t.end) for t in card.get_speech_timestamps(a)]
        ts_cpu = [(t.start, t.end) for t in cpu.get_speech_timestamps(a)]
        runs = detect_speech_runs(a, 16000, card, SpeechSegmentConfig())
        runs_cpu = detect_speech_runs(a, 16000, cpu, SpeechSegmentConfig())
        check(ts == ts_cpu and runs == runs_cpu, f"silero {path.name}: card {ts} / {runs}, "
              f"CPU {ts_cpu} / {runs_cpu}")
        media[path.name] = dict(timestamps=ts, runs=runs)
        print(f"[vad silero] {path.name}: timestamps {ts}, speech runs {runs} (CPU the same)")
    out["media"] = media
    parts["media"] = time.perf_counter() - t_part
    out["parts_s"] = parts
    print(f"[vad silero] seconds from its start at the end of each part: {parts}")
    return out


def sortformer_flops(cfg, t: int) -> float:
    """Multiply-adds x 2 of ``encode_sequence`` over ``t`` frames: in each
    conformer layer the two FFNs, q/k/v/o, the position projection over
    2t - 1 rows, the content and position scores, p @ v and the conv module;
    the encoder projection; in each transformer layer q/k/v/o, scores, p @ v
    and the FFN; the speaker head."""
    fc, tf = cfg.fc_encoder, cfg.tf_encoder
    d, f, k = fc.hidden_size, fc.intermediate_size, fc.conv_kernel_size
    conformer = (8 * t * d * f + 8 * t * d * d + 2 * (2 * t - 1) * d * d + 4 * t * t * d
                 + 2 * t * (2 * t - 1) * d + 6 * t * d * d + 2 * t * d * k)
    D, F = tf.d_model, tf.encoder_ffn_dim
    transformer = 8 * t * D * D + 4 * t * t * D + 4 * t * D * F
    head = 2 * t * d * D + 2 * t * D * D + 2 * t * D * cfg.modules.num_speakers
    return fc.num_hidden_layers * conformer + tf.encoder_layers * transformer + head


def copy_state(state: dict) -> dict:
    import numpy as np

    return {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in state.items()}


@contextlib.contextmanager
def recorded_feeds(model, records: list):
    """Record each ``feed`` of ``model`` (its chunk, the state before and
    after, its output) and the ``preds`` of every AOSC compression it ran."""
    import numpy as np

    from tpu_audio_torch.models.vad import sortformer as TS

    feed, compress, calls = model.feed, TS._compress_aosc, []

    def spy_compress(embs, preds, mean_sil, mc):
        calls.append(np.array(preds))
        return compress(embs, preds, mean_sil, mc)

    def spy_feed(chunk, state, *a, **k):
        before, n = copy_state(state), len(calls)
        out, after = feed(chunk, state, *a, **k)
        records.append(dict(chunk=np.array(chunk), before=before, out=out,
                            after=copy_state(after), compress=calls[n:]))
        return out, after

    model.feed, TS._compress_aosc = spy_feed, spy_compress
    try:
        yield
    finally:
        del model.feed
        TS._compress_aosc = compress


def aosc_parting(label: str, mc, ref, got) -> dict:
    """The AOSC picks of ``got`` against ``ref`` (two routes' speaker
    probabilities over the same frames): equal, or parted at a witnessed
    near tie. The picks are a step function of the probabilities; where they
    part, bisection along the straight line from ``ref`` to ``got`` finds
    where they switch, so the tie lies within the routes' difference (at
    most SORTFORMER_CARD_ATOL, checked by the caller)."""
    import numpy as np

    from tpu_audio_torch.models.vad import sortformer as TS

    def picks(p):
        return TS.aosc_picks(p.astype(np.float32), mc)

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    a, b = picks(ref), picks(got)
    diff = float(np.abs(got - ref).max())
    if same(a, b):
        return dict(equal=True, preds_diff=diff)
    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if same(picks(ref + mid * (got - ref)), a):
            lo = mid
        else:
            hi = mid
    parted = int((a[0] != b[0]).sum() + (a[1] != b[1]).sum())
    print(f"[vad sortformer] {label}: AOSC picks part at {parted} of {a[0].shape[0]} positions; "
          f"witness: they switch at {hi:.6f} of the way from the CPU's probabilities to the "
          f"card's, which lie {diff:.3e} apart")
    return dict(equal=False, preds_diff=diff, parted=parted, switch_at=hi)


def sortformer_phase(models, dev, smi: str) -> dict:
    """``bench_vad_diarization``'s protocol (30 s of seeded noise x 0.1
    through ``generate_stream`` at 5 s chunks, a warm-up, the fastest of 3
    walls); the stream reaching the AOSC compression, with spkcache and FIFO
    lengths a chunk; each chunk held against the port's CPU run from the
    card's state before it (speaker probabilities, state lengths, AOSC
    picks); offline ``generate`` on the two-speaker clip against the CPU;
    host ms, device ms and events a chunk, the encoder's device ms and
    bound, the peak device memory; the TF32 control (``tf32_leak``) of the
    last chunk and of ``generate``."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import nn
    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.vad import sortformer as TS

    card, cpu = models["sortformer"], models["sortformer_cpu"]
    t_part, parts = time.perf_counter(), {}
    mc = card.config.modules
    rng = np.random.default_rng(0)
    audio = rng.standard_normal(int(16000 * VAD_SECONDS)).astype(np.float32) * 0.1
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outs, walls = timed_walls(
        lambda: list(card.generate_stream(audio, chunk_duration=SORTFORMER_CHUNK_S)), dev)
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    records = []
    with recorded_feeds(card, records):
        again = list(card.generate_stream(audio, chunk_duration=SORTFORMER_CHUNK_S))
    check(len(again) == len(outs) == len(records) and all(
        np.array_equal(x["speaker_probs"], y["speaker_probs"]) for x, y in zip(outs, again)),
        "sortformer: two streams differ")
    parts["protocol"] = time.perf_counter() - t_part
    spk = [r["after"]["spkcache"].shape[1] for r in records]
    fifo = [r["after"]["fifo"].shape[1] for r in records]
    n_compress = [len(r["compress"]) for r in records]
    first = next((i for i, n in enumerate(n_compress) if n), None)
    print(f"[vad sortformer] {VAD_SECONDS:.0f} s of noise in {len(outs)} chunks of "
          f"{SORTFORMER_CHUNK_S} s: walls {[round(w, 4) for w in walls]} s, RTF "
          f"{min(walls) / VAD_SECONDS:.6f}; spkcache {spk}, FIFO {fifo} after each chunk; "
          f"AOSC compressions a chunk {n_compress}; peak memory "
          f"{'not measured' if peak is None else f'{peak:.3f} GB'} ({smi})")
    check(first is not None and max(spk) == mc.spkcache_len and max(fifo) == mc.fifo_len,
          f"sortformer: the stream did not reach the AOSC compression (spkcache {spk})")
    chunks, compress = [], []
    for i, r in enumerate(records):
        want = r["out"]["speaker_probs"]
        check(bool(np.isfinite(want).all()) and want.shape[1] == mc.num_speakers,
              f"sortformer chunk {i}: probabilities {want.shape}")
        cpu_records = []
        with recorded_feeds(cpu, cpu_records):
            cpu.feed(r["chunk"], copy_state(r["before"]))
        c = cpu_records[0]
        err = float(np.abs(c["out"]["speaker_probs"] - want).max())
        lens = [(r["after"][k].shape, c["after"][k].shape) for k in ("spkcache", "fifo")]
        check(err <= SORTFORMER_CARD_ATOL, f"sortformer chunk {i}: card against CPU "
              f"{err:.3e} > {SORTFORMER_CARD_ATOL}")
        check(all(a == b for a, b in lens) and len(c["compress"]) == len(r["compress"]),
              f"sortformer chunk {i}: state lengths {lens}, compressions "
              f"{len(r['compress'])} / {len(c['compress'])}")
        for j, (got, ref) in enumerate(zip(r["compress"], c["compress"])):
            part = aosc_parting(f"chunk {i} compression {j}", mc, ref, got)
            check(part["preds_diff"] <= SORTFORMER_CARD_ATOL,
                  f"sortformer chunk {i}: compression inputs {part['preds_diff']:.3e} apart")
            compress.append(dict(chunk=i, **part))
        chunks.append(dict(chunk=i, frames=int(want.shape[0]), card_vs_cpu=err,
                           spkcache=spk[i], fifo=fifo[i]))
    with tf32_leak():  # the control: the last chunk with the guard bypassed
        leak, _ = card.feed(records[-1]["chunk"], copy_state(records[-1]["before"]))
    controls = dict(chunk=float(np.abs(leak["speaker_probs"]
                                       - c["out"]["speaker_probs"]).max()))
    parts["against the CPU"] = time.perf_counter() - t_part
    # one chunk at a time from its recorded state: host ms, then device ms
    # and events in one profiled pass, the chunks parted by marker kernels
    for i, r in enumerate(records):
        vad_sync(dev)
        t0 = time.perf_counter()
        card.feed(r["chunk"], copy_state(r["before"]))
        vad_sync(dev)
        st = r["before"]
        total = st["spkcache"].shape[1] + st["fifo"].shape[1] + min(
            1, st["fifo"].shape[1]) + chunks[i]["frames"]
        chunks[i].update(host_ms=(time.perf_counter() - t0) * 1e3, frames_in=total,
                         bucket=max(32, -(-total // 32) * 32), device_ms=None, events=0)
    if dev.type == "cuda":
        for c, (busy_ms, events) in zip(chunks, profiled_feeds(card, records)):
            c.update(device_ms=busy_ms, events=events)
    for c in chunks:
        print(f"[vad sortformer chunk {c['chunk']}] {c['frames']} frames, {c['frames_in']} in a "
              f"{c['bucket']}-frame bucket: card against CPU {c['card_vs_cpu']:.3e} (atol "
              f"{SORTFORMER_CARD_ATOL}); host {c['host_ms']:.3f} ms, device {fmt(c['device_ms'])} "
              f"in {c['events']} events; spkcache {c['spkcache']}, FIFO {c['fifo']}")
    parts["chunks profiled"] = time.perf_counter() - t_part
    # the encoder alone over the largest bucket
    big = max(chunks, key=lambda c: c["bucket"])
    x = torch.zeros((1, big["bucket"], card.config.fc_encoder.hidden_size), device=dev)
    x[:, :big["frames_in"]] = torch.randn((1, big["frames_in"], x.shape[2]), device=dev,
                                          generator=torch.Generator(device=dev).manual_seed(1))

    def encode():
        with torch.inference_mode(), nn.f32_convolutions():
            return TS.encode_sequence(card.params, x, big["frames_in"], card.config)

    encode()
    _, enc_ms, enc_events = profiled(encode, dev, "vad sortformer encoder")
    flops = sortformer_flops(card.config, big["bucket"])
    weights = sum(t.numel() * t.element_size() for t in _tensors(card.params))
    enc_bound = bound(weights + 2 * x.numel() * 4, f32_ops=flops)
    print(f"[vad sortformer encoder] {big['bucket']} frames: device {fmt(enc_ms)} in "
          f"{enc_events} events; {flops / 1e9:.1f} GFLOP f32, bound {enc_bound[0]:.4f} ms by "
          f"{enc_bound[1]} ({weights / 1e6:.1f} MB of weights)")
    parts["encoder"] = time.perf_counter() - t_part
    # offline generate on the two-speaker clip
    a = load_audio(str(AUDIO2), sample_rate=16000)[0]
    _, gen_walls = timed_walls(lambda: card.generate(a), dev, reps=1)
    res, ref = card.generate(a), cpu.generate(a)
    gen_err = float(np.abs(res["speaker_probs"] - ref["speaker_probs"]).max())
    with tf32_leak():
        controls["generate"] = float(np.abs(card.generate(a)["speaker_probs"]
                                            - ref["speaker_probs"]).max())
    segs = [(s.start, s.end, s.speaker) for s in res["segments"]]
    segs_cpu = [(s.start, s.end, s.speaker) for s in ref["segments"]]
    near = int((np.abs(ref["speaker_probs"] - 0.5) <= gen_err).sum())
    check(gen_err <= SORTFORMER_CARD_ATOL, f"sortformer generate: card against CPU "
          f"{gen_err:.3e} > {SORTFORMER_CARD_ATOL}")
    check(segs == segs_cpu or near > 0, f"sortformer generate: segments {segs} / {segs_cpu} "
          "part with no probability within the routes' difference of 0.5")
    parts["generate"] = time.perf_counter() - t_part
    print(f"[vad sortformer] seconds from its start at the end of each part: {parts}")
    print(f"[vad sortformer] TF32 control (convolutions in TF32), card against CPU: last chunk "
          f"{controls['chunk']:.3e}, generate {controls['generate']:.3e} (atol "
          f"{SORTFORMER_CARD_ATOL})")
    rttm = TS.segments_to_rttm(res["segments"], AUDIO2.stem)
    print(f"[vad sortformer generate] {AUDIO2.name} ({a.shape[0] / 16000:.2f} s): "
          f"{res['speaker_probs'].shape[0]} frames in {gen_walls[0]:.4f} s; card against CPU "
          f"{gen_err:.3e}; {len(segs)} segments, {res['num_speakers']} speakers, equal to the "
          f"CPU's: {segs == segs_cpu}; RTTM:\n" + "\n".join(rttm.splitlines()[:6]))
    return dict(chunks_n=len(outs), walls_s=walls, rtf=min(walls) / VAD_SECONDS, parts_s=parts,
                spkcache=spk, fifo=fifo, compressions=n_compress, first_compression=first,
                chunks=chunks, aosc=compress, peak_memory_gb=peak, tf32_control=controls,
                encoder=dict(frames=big["bucket"], device_ms=enc_ms, events=enc_events,
                             gflop=flops / 1e9, bound_ms=enc_bound[0], bound_by=enc_bound[1]),
                generate=dict(frames=int(res["speaker_probs"].shape[0]), wall_s=gen_walls[0],
                              card_vs_cpu=gen_err, segments=len(segs),
                              num_speakers=res["num_speakers"], equal=segs == segs_cpu))


def vad_phase(dev, smi: str, cfg=None) -> dict:
    """The ``[vad]`` phase: Silero v5 and Sortformer-4spk from seeded random
    weights on the card (``build_vad``), ``silero_phase`` and
    ``sortformer_phase``, under PyTorch's default cuDNN flags (TF32
    allowed), so that the models' own ``nn.f32_convolutions`` keeps their
    convolutions in f32. No kernel of the port runs here. ``cfg`` replaces
    ``sortformer_config()`` (a narrow one rehearses the phase on the CPU)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t_phase = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        models = build_vad(dev, cfg)
        vad_sync(dev)
        cfg = models["sortformer"].config
        print(f"[vad] Silero v5 (16 and 8 kHz) and Sortformer-4spk (FastConformer "
              f"{cfg.fc_encoder.num_hidden_layers} x {cfg.fc_encoder.hidden_size}, transformer "
              f"{cfg.tf_encoder.encoder_layers} x {cfg.tf_encoder.d_model}, "
              f"{cfg.processor.feature_size} mels) f32 built in "
              f"{time.perf_counter() - t_phase:.1f} s; cuDNN allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32} outside the models")
        _lib.reset_launches()
        out = dict(silero=silero_phase(models, dev, smi),
                   sortformer=sortformer_phase(models, dev, smi))
        for name, atol, leaks in (
                ("silero", SILERO_CARD_ATOL, [out["silero"][k]["tf32_control"]
                                              for k in ("16k", "8k")]),
                ("sortformer", SORTFORMER_CARD_ATOL,
                 list(out["sortformer"]["tf32_control"].values()))):
            check(dev.type != "cuda" or min(leaks) > atol, f"{name}: with its convolutions in "
                  f"TF32 the card stays within {atol} of the CPU ({leaks}): the limit would "
                  "not catch a TF32 leak")
        check(not any(_lib.launches.values()), f"a kernel of the port ran in [vad]: "
              f"{dict(_lib.launches)}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out.update(phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[vad] phase {out['phase_s']:.1f} s")
    del models
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def speech_signal(seconds: float):
    """The speech clip, a second of zeros, the two-speaker clip and a second
    of zeros, repeated to ``seconds`` (16 kHz, f32 numpy)."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio

    z = np.zeros(16000, np.float32)
    unit = np.concatenate([load_audio(str(AUDIO), sample_rate=16000)[0], z,
                           load_audio(str(AUDIO2), sample_rate=16000)[0], z])
    n = int(16000 * seconds)
    return np.tile(unit, -(-n // unit.shape[0]))[:n]


def wav_body(audio, rate: int = 16000) -> bytes:
    """WAV bytes (PCM16, ``rate``) of ``audio``, as a client posts them."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((audio * 32767).clip(-32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def posted(server, path: str, bodies: list, read=json.loads) -> tuple[list, float]:
    """POST each of ``bodies`` to ``path`` on ``server`` at once (a thread
    each, released together): (answers in order, each body read by ``read``,
    JSON by default; wall seconds)."""
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    out = [None] * len(bodies)
    start = threading.Barrier(len(bodies))

    def post(i):
        start.wait()
        req = urllib.request.Request(url, data=bodies[i], headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out[i] = read(r.read())

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        workers = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
            check(not w.is_alive(), f"a POST to {path} did not return")
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(all(o is not None for o in out), f"a POST to {path} failed")
    return out, wall


def card_and_cpu(dev, build) -> tuple:
    """``build(device, params)`` on the card (params None: seeded random
    ones built there) and on the CPU from a copy of the card's, with the
    card's peak memory counted from just before the build."""
    import torch

    from tpu_audio_torch.core import loading

    torch.cuda.reset_peak_memory_stats()
    card = build(dev, None)
    return card, build("cpu", loading.to_device(card.params, "cpu"))


def peak_gb() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def no_launches(label: str) -> None:
    """No kernel of the port ran since the counters' last reset."""
    from tpu_audio_torch.ops import _lib

    check(not any(_lib.launches.values()), f"a kernel of the port ran in {label}: "
          f"{dict(_lib.launches)}")


def fsmn_flops(cfg, t: int) -> float:
    """Multiply-adds x 2 of the FSMN encoder over ``t`` frames and of the
    fbank's mel projection (the rfft left out)."""
    c = cfg.encoder
    per_layer = 2 * c.linear_dim * c.proj_dim + c.proj_dim * c.lorder
    return 2.0 * t * (c.input_dim * c.input_affine_dim + c.input_affine_dim * c.linear_dim
                      + c.fsmn_layers * per_layer + c.linear_dim * c.output_affine_dim
                      + c.output_affine_dim * c.output_dim + 257 * cfg.n_mels)


def fsmn_turn_phase(dev, signal, smi: str) -> dict:
    """FSMN VAD at ``FSMNVADConfig()`` (FunASR fsmn-vad: 400 -> 140, 4 x (250 ->
    128, lorder 20), 140 -> 248) with a seeded CMVN: the silence state's
    output bias set so that FSMN_SIL_QUANTILE of the signal's frames sit at
    the speech threshold (on card and CPU alike); ``scores`` and ``detect``
    on the 30 s signal against the CPU (scores within FSMN_CARD_ATOL,
    segments equal) and the TF32 controls; walls, a profiled ``scores``
    (device ms, events), the bound, the peak memory."""
    import numpy as np

    from tpu_audio_torch.models.vad import fsmn_vad as TF
    from tpu_audio_torch.ops import _lib

    cfg = TF.FSMNVADConfig()
    rng = np.random.default_rng(0)
    cmvn = ((-12.0 - 2.0 * rng.standard_normal(cfg.encoder.input_dim)).astype(np.float32),
            (0.25 + 0.1 * rng.random(cfg.encoder.input_dim)).astype(np.float32))
    card, cpu = card_and_cpu(dev, lambda d, p: TF.FSMNVAD(
        cfg, p if p is not None else TF.init_random_params(cfg.encoder, seed=0, device=d), cmvn))
    # the random model's silence posteriors lie far below f32's reach: step
    # the bias by the log-odds of the clipped quantile until it settles
    delta = 0.0
    for _ in range(FSMN_SIL_STEPS):
        sil = np.clip(card.scores(signal)[:, 0], 1e-7, 1 - 1e-7)
        step = float(np.log(0.2 / 0.8) - np.quantile(np.log(sil / (1 - sil)), FSMN_SIL_QUANTILE))
        for m in (card, cpu):
            m.params["out_linear2"]["bias"][0] += step
        delta += step
        if abs(step) < 1e-3:
            break
    _lib.reset_launches()
    scores, walls = timed_walls(lambda: card.scores(signal), dev)
    segs, det_walls = timed_walls(lambda: card.detect(signal), dev)
    no_launches("FSMN VAD")
    ref = cpu.scores(signal)
    segs_cpu = cpu.detect(signal)
    err = float(np.abs(scores - ref).max())
    with tf32_leak():
        leak = float(np.abs(card.scores(signal) - ref).max())
    with tf32_leak(matmul=True):
        leak_mm = float(np.abs(card.scores(signal) - ref).max())
    wall_ms, busy_ms, events = profiled(lambda: card.scores(signal), dev, "turn fsmn")
    peak = peak_gb()
    frames = scores.shape[0]
    n_params = sum(t.numel() for t in _tensors(card.params))
    b_ms, b_by = bound(4 * (signal.shape[0] + n_params + scores.size),
                       f32_ops=fsmn_flops(cfg, frames))
    res = dict(frames=frames, states=int(scores.shape[1]), silence_bias_shift=delta,
               speech_frames=int((scores[:, 0] <= 0.2).sum()), segments=segs,
               segments_equal=segs == segs_cpu, card_vs_cpu=err,
               tf32_control=leak, tf32_matmul_control=leak_mm, scores_walls_s=walls,
               detect_walls_s=det_walls, rtf=min(det_walls) / TURN_LID_SECONDS,
               profiled_wall_ms=wall_ms, busy_ms=busy_ms, device_events=events,
               bound_ms=b_ms, bound_by=b_by, peak_memory_gb=peak)
    print(f"[turn fsmn] FSMNVADConfig() ({cfg.encoder.input_dim} -> {cfg.encoder.input_affine_dim}, "
          f"{cfg.encoder.fsmn_layers} x ({cfg.encoder.linear_dim} -> {cfg.encoder.proj_dim}, lorder "
          f"{cfg.encoder.lorder}), -> {cfg.encoder.output_dim}), {TURN_LID_SECONDS:.0f} s: {frames} "
          f"frames, {res['speech_frames']} at speech (silence bias {delta:+.4f}); segments "
          f"{segs} (CPU equal: {segs == segs_cpu}); scores card against CPU {err:.3e} (atol "
          f"{FSMN_CARD_ATOL}; TF32 control {leak:.3e}, with TF32 matmuls {leak_mm:.3e}); scores "
          f"walls {[round(w, 4) for w in walls]} s, detect walls "
          f"{[round(w, 4) for w in det_walls]} s (RTF {res['rtf']:.6f}); profiled scores: "
          f"{events} device events, busy {fmt(busy_ms)} of {wall_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); peak {peak:.3f} GB ({smi})")
    check(scores.shape == ref.shape and bool(np.isfinite(scores).all())
          and np.allclose(scores.sum(axis=1), 1.0, atol=1e-5), f"fsmn: scores {scores.shape}")
    check(segs == segs_cpu and len(segs) > 1, f"fsmn: segments {segs}, CPU {segs_cpu}")
    res["card_model"] = card
    return res


def smart_turn_flops(cfg, frames: int) -> float:
    """Multiply-adds x 2 of SmartTurn's forward over ``frames`` mel frames:
    the two convolutions, each layer's q/k/v/o, scores, p @ v and FFN, the
    pooling and the classifier."""
    d, f, m, t = cfg.d_model, cfg.encoder_ffn_dim, cfg.num_mel_bins, frames // 2
    conv = frames * m * d * 3 + t * d * d * 3
    layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * f
    return 2.0 * (conv + cfg.encoder_layers * layer + t * d * 256 + 256 + d * 256 + 256 * 64)


def smart_turn_phase(dev, signal, smi: str) -> tuple[dict, dict]:
    """SmartTurn at ``SmartTurnConfig()`` (384 x 4 layers, 6 heads, ffn
    1,536, 80 mels, 8 s): ``predict_endpoint`` on the signal's last 8 s, on
    3 s of the speech clip (left-padded) and on the speech clip at 8 kHz
    (resampled), each with the counters reset just before and read just
    after (kernel 1 exactly once, no other kernel) and profiled in a marked
    window (exactly one kernel-1 launch among its device events), against
    the CPU within SMART_TURN_CARD_ATOL and the TF32 controls; the features
    against the CPU's within MEL_ATOL; ``__call__`` on a batch of 2 against
    each alone; kernel 1 at the path's shape (800 frames x 201 bins x 80
    mels) against its plain version and timed. Returns the phase's record
    and kernel 1's fields."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.core.audio_io import load_audio, resample_audio
    from tpu_audio_torch.models.vad import smart_turn as TS
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import mel as M

    cfg = TS.SmartTurnConfig()
    card, cpu = card_and_cpu(dev, lambda d, p: TS.SmartTurn(
        cfg, p if p is not None else TS.init_random_params(cfg, seed=0, device=d)))
    speech = load_audio(str(AUDIO), sample_rate=16000)[0]
    window = cfg.max_audio_seconds * cfg.sampling_rate
    clips = {"last 8 s": (signal[-window:], None), "3 s": (speech[:48000], None),
             "8 kHz": (resample_audio(speech, 16000, 8000), 8000)}
    calls, launches = {}, 0
    for label, (a, sr) in clips.items():
        _lib.reset_launches()
        out = card.predict_endpoint(a, sr)
        got = dict(_lib.launches)
        check(got == {"fused_log_mel": 1}, f"smart turn {label}: launches {got} (kernel 1 once)")
        launches += got["fused_log_mel"]
        ref = cpu.predict_endpoint(a, sr)
        err = abs(out.probability - ref.probability)
        with tf32_leak():
            leak = abs(card.predict_endpoint(a, sr).probability - ref.probability)
        with tf32_leak(matmul=True):
            leak_mm = abs(card.predict_endpoint(a, sr).probability - ref.probability)
        _, walls = timed_walls(lambda: card.predict_endpoint(a, sr), dev, SMART_TURN_TIMED)
        spans = marked_spans(lambda: card.predict_endpoint(a, sr), f"turn smart {label}")
        k1 = None if spans is None else sum("fused_log_mel_kernel" in n for *_, n in spans)
        check(spans is None or k1 == 1, f"smart turn {label}: {k1} kernel-1 launches profiled")
        busy = None if spans is None else interval_union(spans) / 1e3
        feat_err = float((card.prepare_input_features(a, sr).cpu()
                          - cpu.prepare_input_features(a, sr)).abs().max())
        calls[label] = dict(probability=out.probability, prediction=out.prediction,
                            card_vs_cpu=err, tf32_control=leak, tf32_matmul_control=leak_mm,
                            features_card_vs_cpu=feat_err, walls_s=walls,
                            host_ms=min(walls) * 1e3, busy_ms=busy,
                            device_events=0 if spans is None else len(spans),
                            kernel1_profiled=k1)
        print(f"[turn smart {label}] probability {out.probability:.6f} (prediction "
              f"{out.prediction}); card against CPU {err:.3e} (atol {SMART_TURN_CARD_ATOL}; TF32 "
              f"control {leak:.3e}, with TF32 matmuls {leak_mm:.3e}); features {feat_err:.3e} "
              f"(atol {MEL_ATOL}); kernel 1 launched {got['fused_log_mel']} time(s), "
              f"{k1} in the profile; walls {[round(w * 1e3, 3) for w in walls]} ms, "
              f"{calls[label]['device_events']} device events, busy {fmt(busy)}")
        check(0.0 <= out.probability <= 1.0 and np.isfinite(out.probability),
              f"smart turn {label}: probability {out.probability}")
        check(feat_err <= MEL_ATOL, f"smart turn {label}: features {feat_err:.3e} from the CPU's")
    # kernel 1 at the path's shape: the STFT of the signal's prepared last 8 s
    x = torch.from_numpy(card.prepare_audio(clips["last 8 s"][0])).to(dev)
    spec = dsp.stft(x, dsp.hanning_window(cfg.n_fft, periodic=True), cfg.n_fft,
                    cfg.hop_length)[:-1]
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, f_min=0.0,
                                          f_max=cfg.sampling_rate / 2.0, norm="slaney",
                                          mel_scale="slaney")).to(dev)
    got, want, k1_err = mel_check("smart turn, 8 s, 80 mels", lambda: M.fused_log_mel(re, im, fb),
                                  re, im, fb)
    check(got.shape == (window // cfg.hop_length, cfg.n_mels), f"smart turn mel {got.shape}")
    b_ms, b_by = mel_bound(re, im, fb, got)
    k1 = dict(shape=[re.shape[0], re.shape[1], fb.shape[1]], max_abs_err=k1_err,
              rel_err=rel_err(got, want), bound_ms=b_ms, bound_by=b_by,
              ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
              dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    print(f"[turn smart mel] kernel 1 at [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},"
          f"{fb.shape[1]}]: max abs err {k1_err:.3e} (atol {MEL_ATOL}); per call kernel "
          f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; device kernel {fmt(k1['dev_ms'])}, "
          f"plain {fmt(k1['plain_dev_ms'])}; bound {b_ms:.6f} ms ({b_by}) ({smi})")
    # __call__ on a batch of 2 against each alone, and against the CPU
    _lib.reset_launches()
    feats = [card.prepare_input_features(a, sr) for a, sr in list(clips.values())[:2]]
    check(_lib.launches["fused_log_mel"] == 2, "smart turn: kernel 1 not once a clip")
    batched = card(torch.stack(feats)).cpu()
    alone = torch.cat([card(f).cpu() for f in feats])
    batch_err = float((batched - alone).abs().max())
    batch_cpu = float((batched - cpu(torch.stack([f.cpu() for f in feats]))).abs().max())
    fwd = smart_turn_flops(cfg, window // cfg.hop_length)
    n_params = sum(t.numel() for t in _tensors(card.params))
    f_ms, f_by = bound(4 * (n_params + feats[0].numel()), f32_ops=fwd)
    _, fwd_busy, fwd_events = profiled(lambda: card(feats[0]), dev, "turn smart forward")
    peak = peak_gb()
    print(f"[turn smart batch] 2 rows against each alone {batch_err:.3e} (atol "
          f"{SMART_TURN_BATCH_ATOL}), against the CPU {batch_cpu:.3e}; the forward alone: "
          f"{fwd_events} device events, busy {fmt(fwd_busy)}, bound {f_ms:.4f} ms ({f_by}, "
          f"{fwd / 1e9:.3f} GFLOP f32); peak {peak:.3f} GB")
    check(batch_err <= SMART_TURN_BATCH_ATOL, f"smart turn: batch against alone {batch_err:.3e}")
    check(batch_cpu <= SMART_TURN_CARD_ATOL, f"smart turn: batch against the CPU {batch_cpu:.3e}")
    res = dict(calls=calls, kernel1=k1, kernel1_launches=launches, batch_vs_alone=batch_err,
               batch_vs_cpu=batch_cpu, forward=dict(busy_ms=fwd_busy, device_events=fwd_events,
                                                    gflop=fwd / 1e9, bound_ms=f_ms,
                                                    bound_by=f_by), peak_memory_gb=peak)
    return res, dict(smart_turn_launches=launches, smart_turn=k1)


def ecapa_flops(cfg, frames: int) -> float:
    """Multiply-adds x 2 of ECAPA over ``frames`` mel frames: the mel
    projection, block 0, three SE-Res2Net blocks (two 1x1 convs, the
    Res2Net convs, SE), the aggregation, attentive pooling, the embedding
    and the classifier (the STFT left out)."""
    c, s, k = cfg.channels, cfg.res2net_scale, cfg.kernel_sizes
    res2 = sum((s - 1) * (c // s) ** 2 * k[i] for i in (1, 2, 3))
    per_frame = (201 * 60 + cfg.input_size * c * k[0] + 3 * 2 * c * c + res2
                 + 9 * c * c * k[4] + 2 * 3 * c * cfg.attention_channels)
    head = (6 * c * cfg.embed_dim + cfg.embed_dim * cfg.classifier_hidden_dim
            + cfg.classifier_hidden_dim * cfg.num_classes + 3 * 2 * c * cfg.se_channels)
    return 2.0 * (frames * per_frame + head)


def ecapa_phase(dev, signal, smi: str) -> tuple[dict, object]:
    """ECAPA-TDNN LID at ECAPA_GEOMETRY: ``predict`` on bench_lid's 10 s of
    seeded noise (x 0.1) and on 10 s of the signal against the CPU within
    ECAPA_CARD_ATOL, top-1 equal, and the TF32 controls; the per-clip ms as
    the fastest of ECAPA_TIMED walls (readback included), a profiled
    ``predict_device`` (device ms, events) and the bound; ``predict_batch``
    on ECAPA_BATCH_S seconds of the signal (three buckets and ``predict``
    past 30 s): each row against the CPU's ``predict_batch`` and against its
    solo ``predict`` (top-1 equal, its confidence within ECAPA_SOLO_ATOL;
    every probability's difference read); the peak memory.
    Returns the record and the card's model."""
    import numpy as np

    from tpu_audio_torch.models.lid import ecapa_lid as TE
    from tpu_audio_torch.ops import _lib

    cfg = TE.EcapaConfig(**ECAPA_GEOMETRY, id2label={str(i): f"lang{i}" for i in range(107)})
    card, cpu = card_and_cpu(dev, lambda d, p: TE.EcapaLID(
        cfg, p if p is not None else TE.init_random_params(cfg, seed=0, device=d)))
    n = int(16000 * ECAPA_SECONDS)
    noise = np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
    _lib.reset_launches()
    probs = {}
    for label, a in (("noise", noise), ("signal", signal[:n])):
        got = card.predict_device(a).cpu().numpy()
        ref = cpu.predict_device(a).numpy()
        with tf32_leak():
            leak = float(np.abs(card.predict_device(a).cpu().numpy() - ref).max())
        with tf32_leak(matmul=True):
            leak_mm = float(np.abs(card.predict_device(a).cpu().numpy() - ref).max())
        probs[label] = dict(card_vs_cpu=float(np.abs(got - ref).max()), tf32_control=leak,
                            tf32_matmul_control=leak_mm, top1=int(got.argmax()),
                            top1_cpu=int(ref.argmax()), max_prob=float(got.max()))
        print(f"[turn ecapa {label}] {ECAPA_SECONDS:.0f} s: top-1 lang{got.argmax()} "
              f"({got.max():.4f}; CPU lang{ref.argmax()}); card against CPU "
              f"{probs[label]['card_vs_cpu']:.3e} (atol {ECAPA_CARD_ATOL}; TF32 control "
              f"{leak:.3e}, with TF32 matmuls {leak_mm:.3e})")
        check(got.shape == (107,) and bool(np.isfinite(got).all())
              and abs(float(got.sum()) - 1.0) < 1e-4, f"ecapa {label}: probabilities")
        check(got.argmax() == ref.argmax(), f"ecapa {label}: top-1 differs from the CPU's")
    out, walls = timed_walls(lambda: card.predict(noise), dev, ECAPA_TIMED)
    wall_ms, busy_ms, events = profiled(lambda: card.predict_device(noise), dev, "turn ecapa")
    frames = 1 + n // 160
    flops = ecapa_flops(cfg, frames)
    n_params = sum(t.numel() for t in _tensors(card.params))
    b_ms, b_by = bound(4 * (n + n_params + 107), f32_ops=flops)
    print(f"[turn ecapa predict] bench_lid's {ECAPA_SECONDS:.0f} s clip: walls "
          f"{[round(w * 1e3, 3) for w in walls]} ms (fastest {min(walls) * 1e3:.3f} ms a clip, "
          f"readback and top-k included); profiled predict_device: {events} device events, busy "
          f"{fmt(busy_ms)} of {wall_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.2f} "
          f"GFLOP f32) ({smi})")
    # predict_batch over three buckets and the solo route past 30 s
    long = speech_signal(max(ECAPA_BATCH_S))
    clips = [long[: int(16000 * s)] for s in ECAPA_BATCH_S]
    batch = card.predict_batch(clips, top_k=107)
    batch_cpu = cpu.predict_batch(clips, top_k=107)
    rows = []
    for s, c, b, r in zip(ECAPA_BATCH_S, clips, batch, batch_cpu):
        pb = lid_probs(b)
        solo = card.predict_device(c).cpu().numpy()
        rows.append(dict(seconds=s, card_vs_cpu=float(np.abs(pb - lid_probs(r)).max()),
                         vs_solo=abs(b.confidence - float(solo.max())),
                         probs_vs_solo=float(np.abs(pb - solo).max()), top1=b.language,
                         top1_solo=f"lang{solo.argmax()}", top1_cpu=r.language))
    cpu_errs = ", ".join(f"{r['card_vs_cpu']:.3e}" for r in rows)
    solo_errs = ", ".join(f"{r['vs_solo']:.3e}" for r in rows)
    probs_errs = ", ".join(f"{r['probs_vs_solo']:.3e}" for r in rows)
    print(f"[turn ecapa batch] {list(ECAPA_BATCH_S)} s in one predict_batch: card against the "
          f"CPU's predict_batch [{cpu_errs}] (atol {ECAPA_CARD_ATOL}); against each solo "
          f"predict: top-1 confidence [{solo_errs}] (atol {ECAPA_SOLO_ATOL}), every "
          f"probability [{probs_errs}]; top-1 {[r['top1'] for r in rows]}, solo "
          f"{[r['top1_solo'] for r in rows]}")
    for r in rows:
        check(r["top1"] == r["top1_solo"] == r["top1_cpu"], f"ecapa batch {r['seconds']} s: top-1 "
              f"{r['top1']}, solo {r['top1_solo']}, CPU {r['top1_cpu']}")
        check(r["vs_solo"] <= ECAPA_SOLO_ATOL, f"ecapa batch {r['seconds']} s: against solo "
              f"{r['vs_solo']:.3e}")
    check(rows[-1]["probs_vs_solo"] <= ECAPA_CARD_ATOL, "ecapa: the clip past 30 s left predict")
    no_launches("ECAPA LID")
    peak = peak_gb()
    res = dict(predict=probs, language=out.language, walls_s=walls, ms_a_clip=min(walls) * 1e3,
               profiled_wall_ms=wall_ms, busy_ms=busy_ms, device_events=events, frames=frames,
               gflop=flops / 1e9, bound_ms=b_ms, bound_by=b_by, batch=rows, peak_memory_gb=peak)
    return res, card


def lid_probs(out) -> "np.ndarray":
    """An ``LIDOutput`` of every language as probabilities by class index."""
    import numpy as np

    p = np.zeros(len(out.top_languages), np.float32)
    for t in out.top_languages:
        p[int(t.language[4:])] = t.confidence
    return p


def turn_lid_serve(fsmn, ecapa, signal) -> dict:
    """The ``lid`` route: one request alone, then len(LID_HTTP_S) at once
    through the micro-batcher (fewer ``predict_batch`` calls than requests),
    each answer's top 5 equal to ``predict``'s on the clip as the server
    reads it back (each clip fills its bucket: confidences within
    ECAPA_FILLED_ATOL); the ``vad`` route with FSMN: ``detect``'s spans."""
    from tpu_audio_torch.cli.serve import _load_wav_body, build_server

    calls = []
    real = ecapa.predict_batch

    def counting(waveforms, top_k=5):
        calls.append(len(waveforms))
        return real(waveforms, top_k=top_k)

    def same(answer, audio) -> float:
        want = ecapa.predict(audio, top_k=5)
        check([p["language"] for p in answer["top"]] == [p.language for p in want.top_languages],
              f"lid route: {answer['top']} against predict's {want.top_languages}")
        return max(abs(p["confidence"] - w.confidence)
                   for p, w in zip(answer["top"], want.top_languages))

    ecapa.predict_batch = counting
    try:
        one = wav_body(signal[16000 * 5: 16000 * 9])
        alone, alone_wall = posted(build_server(ecapa, "lid", "ecapa", port=0),
                                   "/v1/audio/lid", [one])
        errs = [same(alone[0], _load_wav_body(one, 16000)[0])]
        bodies = [wav_body(signal[16000 * i: 16000 * i + int(16000 * s)])
                  for i, s in enumerate(LID_HTTP_S)]
        calls.clear()
        answers, wall = posted(build_server(ecapa, "lid", "ecapa", port=0), "/v1/audio/lid",
                               bodies)
        errs += [same(a, _load_wav_body(b, 16000)[0]) for a, b in zip(answers, bodies)]
    finally:
        del ecapa.predict_batch
    body = wav_body(signal)
    (vad,), vad_wall = posted(build_server(fsmn, "vad", "fsmn", port=0), "/v1/audio/vad", [body])
    want = [{"start": round(s / 1000.0, 3), "end": round(e / 1000.0, 3)}
            for s, e in fsmn.detect(_load_wav_body(body, 16000)[0], 16000)]
    print(f"[turn serve] lid: one request in {alone_wall * 1e3:.1f} ms, {len(bodies)} at once in "
          f"{wall * 1e3:.1f} ms through {len(calls)} predict_batch calls of {calls} rows; each "
          f"answer's top 5 equal to predict's, confidences within {max(errs):.3e} (atol "
          f"{ECAPA_FILLED_ATOL}); vad (FSMN): {len(vad['segments'])} segments in "
          f"{vad_wall * 1e3:.1f} ms, equal to detect's: {vad['segments'] == want}")
    check(max(errs) <= ECAPA_FILLED_ATOL, f"lid route: confidences {max(errs):.3e} from predict's")
    check(sum(calls) == len(bodies) and len(calls) < len(bodies),
          f"lid route: {len(bodies)} concurrent requests in predict_batch calls of {calls}")
    check(vad["segments"] == want and len(want) > 1, f"vad route: {vad} against detect's {want}")
    return dict(lid_alone_ms=alone_wall * 1e3, lid_concurrent=len(bodies),
                lid_concurrent_ms=wall * 1e3, lid_batches=calls, lid_confidence_err=max(errs),
                vad_segments=len(want), vad_ms=vad_wall * 1e3)


def turn_lid_phase(dev, smi: str) -> tuple[dict, dict]:
    """The ``[vad turn lid]`` phase: FSMN VAD, SmartTurn and ECAPA-TDNN LID
    (``fsmn_turn_phase``, ``smart_turn_phase``, ``ecapa_phase``,
    ``turn_lid_serve``) under PyTorch's default cuDNN flags (TF32 allowed),
    so that the models' own ``nn.f32_convolutions`` keeps their
    convolutions in f32; each card-against-CPU limit must lie below its TF32
    control's reading. Only SmartTurn's log-mel runs a kernel of the port
    (kernel 1). Returns the record and kernel 1's fields."""
    import torch

    t_phase = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        signal = speech_signal(TURN_LID_SECONDS)
        fsmn = fsmn_turn_phase(dev, signal, smi)
        t_fsmn = time.perf_counter() - t_phase
        smart, k1 = smart_turn_phase(dev, signal, smi)
        t_smart = time.perf_counter() - t_phase
        ecapa, ecapa_model = ecapa_phase(dev, signal, smi)
        t_ecapa = time.perf_counter() - t_phase
        serve = turn_lid_serve(fsmn.pop("card_model"), ecapa_model, signal)
        controls = {
            "fsmn": (FSMN_CARD_ATOL, [fsmn["tf32_matmul_control"]]),
            "smart_turn": (SMART_TURN_CARD_ATOL, [c["tf32_control"]
                                                  for c in smart["calls"].values()]),
            "ecapa": (ECAPA_CARD_ATOL, [p["tf32_control"] for p in ecapa["predict"].values()])}
        sound = {"fsmn": [fsmn["card_vs_cpu"]],
                 "smart_turn": [c["card_vs_cpu"] for c in smart["calls"].values()],
                 "ecapa": [p["card_vs_cpu"] for p in ecapa["predict"].values()]
                 + [r["card_vs_cpu"] for r in ecapa["batch"]]}
        for name, (atol, leaks) in controls.items():
            print(f"[vad turn lid] {name}: card against CPU {max(sound[name]):.3e} <= atol {atol} "
                  f"< TF32 control {min(leaks):.3e}")
        for name, (atol, leaks) in controls.items():
            check(max(sound[name]) <= atol, f"{name}: card against CPU {sound[name]} > {atol}")
            check(min(leaks) > atol, f"{name}: with its convolutions in TF32 the card stays "
                  f"within {atol} of the CPU ({leaks}): the limit would not catch a TF32 leak")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = dict(fsmn=fsmn, smart_turn=smart, ecapa=ecapa, serve=serve,
               parts_s=dict(fsmn=t_fsmn, smart_turn=t_smart, ecapa=t_ecapa),
               phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[vad turn lid] phase {out['phase_s']:.1f} s (seconds from its start at the end of "
          f"each part: {out['parts_s']})")
    gc.collect()
    torch.cuda.empty_cache()
    return out, k1


def turn_lid_main(smi: str) -> int:
    """``--turn-lid``: the [vad turn lid] phase alone, then its JSON and
    kernel 1's SmartTurn fields as one line (no "ok" line: not the full
    check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k1 = turn_lid_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"turn_lid": out, "kernel1": k1}))
    return 0


# -- [sts]: DeepFilterNet3 speech enhancement ------------------------------------


def dfn_flops(model, frames: int) -> tuple[float, float]:
    """Multiply-adds x 2 of DeepFilterNet's network a frame, times
    ``frames``, and a frame's alone: each convolution counted on a one-frame
    run of ``_net`` on ``model`` (output elements x its kernel's inputs), the
    transposed convolutions from their weights (each of the ``conv_ch``
    input channels at ``nb_erb / 4`` or ``nb_erb / 2`` bins feeds ``O/g x kT
    x kF`` outputs), grouped linears, GRU layers (input and hidden
    products), the mask's lift to every bin and the deep filter's complex
    taps; the FFTs and elementwise work left out."""
    import torch

    from tpu_audio_torch.models.sts import deepfilternet as TD

    cfg, p = model.config, model.params
    macs = [0]

    def conv(name, x, fs):
        w = p[f"{name}.weight"]
        y = TD._conv2d(w, x, fs)
        macs[0] += y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    with torch.inference_mode():
        x_erb = torch.zeros((1, 1, 1, cfg.nb_erb), device=model.device)
        x_df = torch.zeros((1, 2, 1, cfg.nb_df), device=model.device)
        model._net(x_erb, x_df, conv, {})
    macs[0] += (p["erb_dec.convt2.0.weight"].numel() * (cfg.nb_erb // 4)
                + p["erb_dec.convt1.0.weight"].numel() * (cfg.nb_erb // 2))
    macs[0] += sum(w.numel() for k, w in p.items()
                   if w.dim() == 3 or ".gru.weight_" in k)  # grouped linears, GRUs
    macs[0] += cfg.nb_erb * cfg.freq_bins + 4 * cfg.df_order * cfg.nb_df
    return 2.0 * macs[0] * frames, 2.0 * macs[0]


def write_safetensors(path: Path, flat: dict, bf16: bool = False) -> None:
    """A flat dict of tensors as one safetensors file of f32 (or, with
    ``bf16``, bf16) tensors (8-byte header length, the JSON header, the raw
    little-endian buffers)."""
    import numpy as np
    import torch

    header, blobs, off = {}, [], 0
    for k, v in flat.items():
        if bf16:
            a = v.detach().to(torch.bfloat16).contiguous().view(torch.int16).cpu().numpy()
        else:
            a = np.ascontiguousarray(v.detach().cpu().numpy().astype("<f4"))
        header[k] = {"dtype": "BF16" if bf16 else "F32", "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        blobs.append(a.tobytes())
        off += a.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def sts_streamed(streamer, audio, sizes) -> "np.ndarray":
    """``audio`` through ``streamer`` in chunks of ``sizes`` (the rest in one
    more), then its flush."""
    import numpy as np

    outs, pos = [], 0
    for size in sizes:
        outs.append(streamer.process_chunk(audio[pos: pos + size]))
        pos += size
    if pos < len(audio):
        outs.append(streamer.process_chunk(audio[pos:]))
    outs.append(streamer.flush())
    return np.concatenate([o for o in outs if len(o)])


def sts_offline(card, cpu, noise, wav, smi: str) -> dict:
    """``bench_deepfilternet``'s offline protocol on the card (a warm-up,
    the fastest of STS_TIMED walls over STS_SECONDS of noise: the RTF) and
    ``enhance`` on the 2 s noisy clip, each against the port's CPU run and
    the TF32 controls; the share of samples at +-1 and of ERB gains within
    1e-3 of 0 or 1 (a spy on ``_net``); one call's device ms and events in a
    marked window; the bound."""
    import numpy as np

    t0 = time.perf_counter()
    gains = []
    net = card._net

    def spy(*args, **kwargs):
        out = net(*args, **kwargs)
        gains.append(out[0])
        return out

    card._net = spy
    try:
        out, walls = timed_walls(lambda: card.enhance(noise), card.device, STS_TIMED)
        g = gains[0].float()
        near = float(((g < 1e-3) | (g > 1 - 1e-3)).float().mean())
        g_stats = dict(mean=float(g.mean()), std=float(g.std()), near_0_or_1=near)
    finally:
        del card._net
    runs = {}
    for label, a, got in (("noise", noise, out), ("noisy clip", wav, card.enhance(wav))):
        ref = cpu.enhance(a)
        with tf32_leak():
            leak = float(np.abs(card.enhance(a) - ref).max())
        with tf32_leak(matmul=True):
            leak_mm = float(np.abs(card.enhance(a) - ref).max())
        runs[label] = dict(card_vs_cpu=float(np.abs(got - ref).max()), tf32_control=leak,
                           tf32_matmul_control=leak_mm, saturated=float(np.mean(np.abs(got) >= 1.0)),
                           rms_in=float(np.sqrt(np.mean(a * a))),
                           rms_out=float(np.sqrt(np.mean(got * got))))
        check(got.shape == a.shape and bool(np.isfinite(got).all()), f"sts {label}: output "
              f"{got.shape} finite {np.isfinite(got).all()}")
        check(runs[label]["saturated"] <= STS_SATURATED, f"sts {label}: "
              f"{runs[label]['saturated']:.4f} of the samples at +-1")
    check(near < 1.0, "sts: every ERB gain within 1e-3 of 0 or 1")
    laps = {"walls, CPU runs and controls": time.perf_counter() - t0}
    wall_ms, busy_ms, events = profiled(lambda: card.enhance(noise), card.device, "sts enhance")
    laps["profiled call"] = time.perf_counter() - t0
    frames = 1 + -(-(noise.shape[0] + card.config.hop_size) // card.config.hop_size)
    flops, frame_flops = dfn_flops(card, frames)
    n_params = sum(t.numel() for t in card.params.values())
    b_ms, b_by = bound(4 * (2 * noise.shape[0] + n_params), f32_ops=flops)
    rtf = min(walls) / STS_SECONDS
    res = dict(walls_s=walls, rtf=rtf, realtime_x=1.0 / rtf, frames=frames, gains=g_stats,
               runs=runs, profiled_wall_ms=wall_ms, busy_ms=busy_ms, device_events=events,
               gflop=flops / 1e9, frame_mflop=frame_flops / 1e6, params=n_params,
               bound_ms=b_ms, bound_by=b_by, laps_s=laps)
    for label, r in runs.items():
        print(f"[sts {label}] card against CPU {r['card_vs_cpu']:.3e} (atol {STS_CARD_ATOL}; "
              f"TF32 control {r['tf32_control']:.3e}, with TF32 matmuls "
              f"{r['tf32_matmul_control']:.3e}); {r['saturated']:.5f} of samples at +-1; rms "
              f"{r['rms_in']:.4f} in, {r['rms_out']:.4f} out")
    print(f"[sts enhance] {STS_SECONDS:.0f} s ({frames} frames): walls "
          f"{[round(w * 1e3, 3) for w in walls]} ms, RTF {rtf:.6f} ({1 / rtf:.1f}x real time); "
          f"ERB gains mean {g_stats['mean']:.4f} std {g_stats['std']:.4f}, {near:.4f} within 1e-3 "
          f"of 0 or 1; profiled: {events} device events, busy {fmt(busy_ms)} of {wall_ms:.3f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.3f} GFLOP f32, {n_params} params); "
          f"seconds from the part's start: {laps} ({smi})")
    return res


def sync_guarded(streamer):
    """``streamer`` with every chunk's hops (its ``_run_frames``) under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read between hops
    raises."""
    import torch

    real = streamer._run_frames

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    streamer._run_frames = guarded
    return streamer


def sts_stream(card, noise, wav, off_noise, off_wav, smi: str) -> dict:
    """The streamer over the noise in chunks of STS_BLOCK hops (a warm-up on
    a chunk and a flush, then ``reset``), every chunk's hops under
    ``torch.cuda.set_sync_debug_mode("error")`` (only the upload and the one
    readback run outside), against the card's offline output within
    STS_STREAM_ATOL; the 2 s clip in the JAX test's chunk sizes; the length
    of ``enhance_streaming``'s output; host ms a hop against the hop's
    budget, and one chunk's device ms, events and busy share in a marked
    window, beside the bound a hop (the weights read once a hop)."""
    import numpy as np
    import torch

    from tpu_audio_torch.models.sts import deepfilternet as TD

    cfg = card.config
    hop, chunk = cfg.hop_size, cfg.hop_size * STS_BLOCK
    streamer = sync_guarded(TD.DeepFilterNetStreamer(card))
    streamer.process_chunk(noise[: chunk + cfg.fft_size])
    streamer.flush()
    streamer.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sts_streamed(streamer, noise, [chunk] * (len(noise) // chunk))
    stream_s = time.perf_counter() - t0
    hops = streamer._s
    err = float(np.abs(got - off_noise).max()) if got.shape == off_noise.shape else math.inf
    summary = streamer.profiling_summary()
    got_clip = sts_streamed(sync_guarded(TD.DeepFilterNetStreamer(card)), wav,
                            [hop, 173, 999, hop * 13])
    clip_err = (float(np.abs(got_clip - off_wav).max()) if got_clip.shape == off_wav.shape
                else math.inf)
    gen_len = sum(len(c) for c in card.enhance_streaming(wav))
    # one chunk in a marked window, mid-stream (the state after 8 chunks)
    streamer.reset()
    for i in range(8):
        streamer.process_chunk(noise[i * chunk: (i + 1) * chunk])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    streamer.process_chunk(noise[8 * chunk: 9 * chunk])
    chunk_wall = time.perf_counter() - t1
    spans = marked_spans(lambda: streamer.process_chunk(noise[9 * chunk: 10 * chunk]),
                         "sts stream chunk")
    busy = None if spans is None else interval_union(spans) / 1e3
    events = 0 if spans is None else len(spans)
    n_params = sum(t.numel() for t in card.params.values())
    _, frame_flops = dfn_flops(card, 1)
    hb_ms, hb_by = bound(4 * (n_params + cfg.fft_size + hop), f32_ops=frame_flops)
    host_ms = stream_s * 1e3 / hops
    res = dict(hops=hops, stream_s=stream_s, host_ms_a_hop=host_ms,
               hop_budget_ms=STS_HOP_BUDGET_MS, vs_offline=err, clip_vs_offline=clip_err,
               enhance_streaming_len=gen_len, clip_len=len(wav),
               chunk_wall_ms=chunk_wall * 1e3, chunk_busy_ms=busy, chunk_events=events,
               device_ms_a_hop=None if busy is None else busy / STS_BLOCK,
               events_a_hop=events / STS_BLOCK,
               busy_share=None if busy is None else busy / (chunk_wall * 1e3),
               bound_ms_a_hop=hb_ms, bound_by=hb_by, summary=summary)
    print(f"[sts stream] {hops} hops in chunks of {STS_BLOCK}, every hop under sync debug "
          f"'error': {stream_s:.3f} s, {host_ms:.4f} host ms a hop against the "
          f"{STS_HOP_BUDGET_MS:.0f} ms budget; against offline {err:.3e} (atol "
          f"{STS_STREAM_ATOL}); the 2 s clip in chunks of hop/173/999/13 hops {clip_err:.3e}; "
          f"enhance_streaming {gen_len} samples for {len(wav)}; one chunk: {events} device "
          f"events ({events / STS_BLOCK:.1f} a hop), busy {fmt(busy)} of {chunk_wall * 1e3:.3f} "
          f"ms (share {fmt_share(res['busy_share'])}); bound a hop {hb_ms:.6f} ms ({hb_by}) "
          f"({smi})")
    print(summary)
    check(err <= STS_STREAM_ATOL, f"sts stream: {err:.3e} from offline")
    check(clip_err <= STS_STREAM_ATOL, f"sts stream, the 2 s clip: {clip_err:.3e} from offline")
    check(gen_len == len(wav), f"sts enhance_streaming: {gen_len} samples for {len(wav)}")
    return res


def sts_serve_cli(card, noise, wav) -> dict:
    """``/v1/audio/enhance`` on the card, one request alone and
    len(STS_HTTP_S) at once, each answer's PCM16 equal to ``enhance`` on the
    audio as the server reads it; ``cli/sts.py`` in ``short`` (equal) and
    ``stream`` (within STS_STREAM_ATOL and one PCM16 step) modes on a
    checkpoint written from the card's weights."""
    import numpy as np

    from tpu_audio_torch.cli import sts as cli
    from tpu_audio_torch.cli.serve import _load_wav_body, build_server
    from tpu_audio_torch.core.audio_io import float_to_pcm16, load_audio

    sr = card.sample_rate

    def pcm(wav_bytes):
        with wave.open(io.BytesIO(wav_bytes)) as w:
            return np.frombuffer(w.readframes(w.getnframes()), "<i2")

    def diff(answer, body) -> int:
        want = float_to_pcm16(card.enhance(_load_wav_body(body, sr)[0]))
        check(answer.shape == want.shape, f"enhance route: {answer.shape} against {want.shape}")
        return int(np.abs(answer.astype(np.int32) - want.astype(np.int32)).max())

    one = wav_body(wav, sr)
    (alone,), alone_wall = posted(build_server(card, "sts", "dfn3", port=0), "/v1/audio/enhance",
                                  [one], read=pcm)
    bodies = [wav_body(noise[i * sr: i * sr + int(sr * s)], sr) for i, s in enumerate(STS_HTTP_S)]
    answers, wall = posted(build_server(card, "sts", "dfn3", port=0), "/v1/audio/enhance",
                           bodies, read=pcm)
    diffs = [diff(alone, one)] + [diff(a, b) for a, b in zip(answers, bodies)]
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cfg = dataclasses.asdict(card.config)
        cfg["model_type"] = "deepfilternet3"
        (d / "config.json").write_text(json.dumps(cfg))
        write_safetensors(d / "model.safetensors", card.params)
        outs = {}
        for mode in ("short", "stream"):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                check(cli.main([str(NOISY), "--model", str(d), "--mode", mode, "-o",
                                str(d / f"{mode}.wav")]) == 0, f"cli/sts.py --mode {mode}")
            outs[mode] = (load_audio(str(d / f"{mode}.wav"))[0], err.getvalue().strip())
    want = float_to_pcm16(card.enhance(load_audio(str(NOISY), sample_rate=sr)[0]))
    short = int(np.abs(np.round(outs["short"][0] * 32768).astype(np.int32)
                       - want.astype(np.int32)).max())
    stream = float(np.abs(outs["stream"][0] - want / 32768.0).max())
    res = dict(alone_ms=alone_wall * 1e3, concurrent=len(bodies), concurrent_ms=wall * 1e3,
               pcm_steps_from_enhance=diffs, cli_short_pcm_steps=short, cli_stream_err=stream,
               cli_stderr={m: o[1] for m, o in outs.items()})
    print(f"[sts serve] enhance route: one request in {alone_wall * 1e3:.1f} ms, {len(bodies)} at "
          f"once in {wall * 1e3:.1f} ms; PCM16 steps from enhance {diffs}; cli/sts.py short "
          f"{short} steps, stream {stream:.3e} (atol {STS_STREAM_ATOL} + one step); stderr "
          f"{[o[1] for o in outs.values()]}")
    check(max(diffs) == 0, f"enhance route: answers {diffs} PCM16 steps from enhance")
    check(short == 0, f"cli/sts.py short: {short} PCM16 steps from enhance")
    check(stream <= STS_STREAM_ATOL + 1 / 32768, f"cli/sts.py stream: {stream:.3e} from enhance")
    return res


def sts_phase(dev, smi: str) -> dict:
    """The ``[sts]`` phase: DeepFilterNet3 at ``DeepFilterNetConfig()``'s
    widths (conv_ch 64, 32 ERB bands, 96 DF bins, hidden 256, fft 960, hop
    480 at 48 kHz, order 5, lookahead 2; GRU layers 1, 2, 2; grouped linears
    in 4 groups) from seeded random weights in f32 under PyTorch's default
    cuDNN flags (TF32 allowed), so that the model's own
    ``nn.f32_convolutions`` keeps its convolutions in f32: ``sts_offline``,
    ``sts_stream``, ``sts_serve_cli``, with every launch counter of the port
    reset at its start and 0 at its end (no kernel of the port runs here),
    the card-against-CPU limit below its TF32 control, and the peak device
    memory."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.sts import deepfilternet as TD
    from tpu_audio_torch.ops import _lib

    t_phase = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = TD.DeepFilterNetConfig()
        _lib.reset_launches()
        card, cpu = card_and_cpu(dev, lambda d, p: TD.DeepFilterNet(
            cfg, p if p is not None else TD.init_random_params(cfg, seed=0, device=d)))
        n = int(cfg.sample_rate * STS_SECONDS)
        noise = np.random.default_rng(0).standard_normal(n).astype(np.float32) * 0.1
        wav = load_audio(str(NOISY), sample_rate=cfg.sample_rate)[0]
        offline = sts_offline(card, cpu, noise, wav, smi)
        t_off = time.perf_counter() - t_phase
        stream = sts_stream(card, noise, wav, card.enhance(noise), card.enhance(wav), smi)
        t_stream = time.perf_counter() - t_phase
        serve = sts_serve_cli(card, noise, wav)
        no_launches("the [sts] phase")
        peak = peak_gb()
        sound = max(r["card_vs_cpu"] for r in offline["runs"].values())
        leaks = [r["tf32_control"] for r in offline["runs"].values()]
        print(f"[sts] card against CPU {sound:.3e} <= atol {STS_CARD_ATOL} < TF32 control "
              f"{min(leaks):.3e}; launch counters {dict(_lib.launches)}; peak {peak:.3f} GB")
        check(sound <= STS_CARD_ATOL, f"sts: card against CPU {sound:.3e} > {STS_CARD_ATOL}")
        check(min(leaks) > STS_CARD_ATOL, f"sts: with its convolutions in TF32 the card stays "
              f"within {STS_CARD_ATOL} of the CPU ({leaks}): the limit would not catch a TF32 leak")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = dict(offline=offline, stream=stream, serve=serve, peak_memory_gb=peak,
               parts_s=dict(offline=t_off, stream=t_stream),
               phase_s=time.perf_counter() - t_phase, smi=smi)
    print(f"[sts] phase {out['phase_s']:.1f} s (seconds from its start at the end of each part: "
          f"{out['parts_s']})")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sts_main(smi: str) -> int:
    """``--sts``: the [sts] phase alone, then its JSON as one line (no "ok"
    line: not the full check). It builds no kernel: none runs there."""
    import torch

    t0 = time.perf_counter()
    out = sts_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"sts": out}))
    return 0


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


def qwen3_main(smi: str) -> int:
    """``--qwen3``: the [qwen3 tts] and [qwen3 serve] phases alone, then
    their JSON and kernel 7's Qwen3 fields as one line (no "ok" line: not
    the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k7, _ = qwen3_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"qwen3_tts": out, "kernel7": k7}))
    return 0


def parakeet_main(smi: str) -> int:
    """``--parakeet``: the [parakeet] phase alone, then its JSON and kernel
    7's Parakeet fields as one line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k7 = parakeet_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"parakeet": out, "kernel7": k7}))
    return 0


def vad_main(smi: str) -> int:
    """``--vad``: the [vad] phase alone, then its JSON as one line (no "ok"
    line: not the full check). It builds no kernel: none runs there."""
    import torch

    t0 = time.perf_counter()
    out = vad_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"vad": out}))
    return 0


def kvq_recorder():
    """A context that records what ``decode_step_fn`` builds: each self
    cache ``kv_cache.make_cache_for`` returns, and each write into one, in
    call order (a step's layers in turn): (kind, offset in its part, the new
    K and V rows as the card computed them)."""
    from tpu_audio_torch.core import kv_cache

    caches, writes = [], []
    make, quant, dense = (kv_cache.make_cache_for, kv_cache._write_quant_layer,
                          kv_cache._write_dense)

    def made(*a, **k):
        caches.append(make(*a, **k))
        return caches[-1]

    def wrote_quant(cache_l, offset, k_new, v_new, n_groups, bits):
        writes.append(("quant", offset, k_new.clone(), v_new.clone()))
        return quant(cache_l, offset, k_new, v_new, n_groups, bits)

    def wrote_dense(k_c, v_c, offset, k_new, v_new):
        writes.append(("dense", offset, k_new.clone(), v_new.clone()))
        return dense(k_c, v_c, offset, k_new, v_new)

    @contextlib.contextmanager
    def recording():
        kv_cache.make_cache_for, kv_cache._write_quant_layer, kv_cache._write_dense = (
            made, wrote_quant, wrote_dense)
        try:
            yield caches, writes
        finally:
            kv_cache.make_cache_for, kv_cache._write_quant_layer, kv_cache._write_dense = (
                make, quant, dense)

    return recording()


def kvq_codes_check(cache, writes, n_layers: int) -> dict:
    """Every row the card wrote into a quantized or hybrid self cache
    against the CPU: a quantized row's codes, scales and biases equal
    ``_quantize`` on the CPU of the K/V rows the card computed, bit for bit;
    a dense row (the hybrid's prefix) equals those rows as stored."""
    import torch

    from tpu_audio_torch.core import kv_cache

    quant_planes = [getattr(cache, f) for f in ("k_q", "k_scale", "k_bias", "v_q", "v_scale",
                                                "v_bias")]
    n = {"quant": 0, "dense": 0}
    bad = []
    for i, (kind, off, k, v) in enumerate(writes):
        li, t = i % n_layers, k.shape[2]
        if kind == "quant":
            want = (kv_cache._quantize(k.cpu(), cache.n_groups, cache.bits)
                    + kv_cache._quantize(v.cpu(), cache.n_groups, cache.bits))
            got = [p[li][:, :, off:off + t].cpu() for p in quant_planes]
            ok = all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want))
        else:
            ok = (torch.equal(cache.k[li][:, :, off:off + t].cpu(), k.cpu().to(cache.k.dtype))
                  and torch.equal(cache.v[li][:, :, off:off + t].cpu(), v.cpu().to(cache.v.dtype)))
        n[kind] += 1
        if not ok:
            bad.append((kind, li, off))
    check(not bad, f"self-cache rows the card wrote differ from the CPU's: {bad[:8]}")
    return n


def kvq_steps(step, seq, dev):
    """Teacher-forced logits [len(seq) - 1, V] of ``step`` along ``seq``."""
    import torch

    return torch.stack([step(torch.tensor([t], device=dev), i)[0]
                        for i, t in enumerate(seq[:-1])]).float()


def decoder_slice(model, n_layers: int, dtype=None):
    """The first ``n_layers`` decoder layers of ``model``'s tree in ``dtype``
    (f32 by default; int8 weights stay int8, their scales f32), and the
    config for them."""
    import torch

    from tpu_audio_torch.core import quant

    dtype = dtype or torch.float32

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, quant.Int8Tensor):
            return quant.Int8Tensor(t.weight, t.scale.float())
        return t.to(dtype) if t.is_floating_point() else t

    def first(t):
        if isinstance(t, dict):
            return {k: first(v) for k, v in t.items()}
        if isinstance(t, quant.Int8Tensor):
            return quant.Int8Tensor(t.weight[:n_layers], t.scale[:n_layers])
        return t[:n_layers]

    dec = model.params["model"]["decoder"]
    params = {"model": {"decoder": f32({**dec, "layers": first(dec["layers"])})}}
    return params, dataclasses.replace(model.config, decoder_layers=n_layers)


@contextlib.contextmanager
def act_codes(taps: list | None, feed: list | None = None):
    """While open, with ``taps`` a list: every dynamic int8 activation
    quantization (``quant.quantize_act_int8``, the w8 products') appends
    its codes, scales and unrounded values ``x / scale`` to ``taps``, on the
    CPU; with ``feed`` (another run's taps, in the same order) it returns
    those codes and scales instead of its own."""
    from tpu_audio_torch.core import quant

    fn = quant.quantize_act_int8

    def tapped(x):
        xq, xs = fn(x)
        taps.append((xq.cpu(), xs.cpu(), (x.float() / xs).cpu()))
        if feed is None:
            return xq, xs
        fq, fs, _ = feed[len(taps) - 1]
        return fq.to(x.device), fs.to(x.device)

    if taps is not None:
        quant.quantize_act_int8 = tapped
    try:
        yield
    finally:
        quant.quantize_act_int8 = fn


def kvq_card_vs_cpu(model, enc, seq, kw) -> dict:
    """The route at KVQ_CARD_LAYERS decoder layers in f32, card against
    CPU on the same weights and encoder output, teacher-forced along
    ``seq``: the logits' relative error, and two controls' (the same card
    run with TF32 matrix products, and in bf16, the route's deployed
    dtype). A decode step's products are one-row GEMVs, which TF32 does not
    round; the 1,500-row cross projections it does round feed int8 or int4
    codes. So the TF32 control reads about what the sound run reads, and
    the limit is held below the bf16 control. On the w8 tree every product
    quantizes its input to int8 codes (``act_codes``), and one code rounded
    the other way moves the random-weight stack by ~1e-2: the CPU is fed
    the card's codes and scales, as the kernels' plain versions are, and
    every code of the card's differs from the CPU's own rounding only at a
    boundary (FLIP_DIST), its scale within SCALE_RTOL."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.stt import whisper as W

    params, cfg = decoder_slice(model, KVQ_CARD_LAYERS)
    enc32 = enc.float()
    cpu_params = loading.to_device(params, "cpu")

    def run(p, e, taps=None, feed=None):
        with act_codes(taps, feed):
            step = W.decode_step_fn(p, e, max_total=len(seq), cfg=cfg,
                                    layers=W._split_layers(p["model"]["decoder"]["layers"]),
                                    **kw)
            return kvq_steps(step, seq, e.device).cpu()

    with torch.inference_mode():
        card_taps, cpu_taps = [], []
        card = run(params, enc32, card_taps)
        cpu = run(cpu_params, enc32.cpu(), cpu_taps, feed=card_taps)
        with tf32_leak(matmul=True):
            tf32 = run(params, enc32)
        bf16 = run(decoder_slice(model, KVQ_CARD_LAYERS, torch.bfloat16)[0], enc)
    check(len(card_taps) == len(cpu_taps), "card and CPU quantized a different number of "
                                           "activations")
    flips, worst_dist, scale_rel = 0, 0.0, 0.0
    for (kq, ks, _), (cq, cs, pre) in zip(card_taps, cpu_taps):
        diff = kq.int() - cq.int()
        check(int(diff.abs().max()) <= 1, "a card activation code is more than one step "
                                          "from the CPU's")
        if bool(diff.any()):
            off = pre[diff != 0]
            flips += int((diff != 0).sum())
            worst_dist = max(worst_dist, float((off - off.trunc()).abs().sub(0.5).abs().max()))
        scale_rel = max(scale_rel, float((ks / cs - 1).abs().max()))
    check(worst_dist <= FLIP_DIST and scale_rel <= SCALE_RTOL,
          f"card activation codes part from the CPU's away from a rounding boundary "
          f"({worst_dist:.2e}) or scales {scale_rel:.1e} apart")
    return dict(rel_err=rel_err(card, cpu), tf32_control=rel_err(tf32, cpu),
                bf16_control=rel_err(bf16, cpu), act_codes=len(card_taps), act_flips=flips,
                act_flip_dist=worst_dist, act_scale_rel=scale_rel)


def kvq_timing(model, enc, seq, kw, label: str) -> dict:
    """One window's decode step at a KVQ_TIMED_CAPACITY-row self cache
    (the layers dequantize their whole capacity each step): host ms a step
    (median of KVQ_TIMED_STEPS, each synchronized), device ms and events
    of one step (``marked_window``), the self cache's bytes and the peak
    device memory from the step function's build on."""
    import torch

    from tpu_audio_torch.models.stt import whisper as W

    dev = enc.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), kvq_recorder() as (caches, _):
        step = W.decode_step_fn(model.params, enc, max_total=KVQ_TIMED_CAPACITY,
                                cfg=model.config, layers=model.decoder.split_layers(), **kw)
        # a hybrid cache's timed steps write its quantized tail
        warm = max(KVQ_TIMED_WARM, kw.get("quantized_kv_start", 0) % KVQ_TIMED_CAPACITY)
        toks = (seq * KVQ_TIMED_CAPACITY)[:warm + KVQ_TIMED_STEPS + 2]
        for i in range(warm):
            step(torch.tensor([toks[i]], device=dev), i)
        walls = []
        for i in range(warm, warm + KVQ_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(torch.tensor([toks[i]], device=dev), i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        i = warm + KVQ_TIMED_STEPS
        busy_us, events = marked_window(lambda: step(torch.tensor([toks[i]], device=dev), i),
                                        f"whisper kvq {label}")
    cache = caches[-1]
    out = dict(host_ms=statistics.median(walls), host_ms_all=walls,
               device_ms=None if busy_us is None else busy_us / 1e3, events=events,
               cache=type(cache).__name__, cache_mb=nbytes(*(t for t in cache
                                                             if torch.is_tensor(t))) / 1e6,
               peak_gb=peak_gb())
    print(f"[whisper kvq {label} step] capacity {KVQ_TIMED_CAPACITY}: {out['host_ms']:.3f} host "
          f"ms a step (median of {[f'{w:.2f}' for w in walls]}), device "
          f"{fmt(out['device_ms'])}, {events} device events; {out['cache']} "
          f"{out['cache_mb']:.2f} MB; peak {out['peak_gb']:.3f} GB")
    return out


def whisper_kvq_phase(models, cfg, audio, dev, smi: str) -> tuple[dict, dict]:
    """``[whisper kvq]``: the quantized self-cache routes (KVQ_ROUTES) at
    whisper-large-v3 width, each on the 30 s window and on a KVQ_WINDOWS
    long-form batch, with the counters reset just before and read just
    after each run: greedy ``generate`` twice (equal tokens; kernel 2 32
    times a step at 8 bits, none at 4; kernel 1 once a window; no fused
    stack, no plain call); every self-cache row the first run wrote
    against the CPU bit for bit (``kvq_codes_check``); the teacher-forced
    logits' largest gap from the dense route (kv_bits None) at full depth,
    the quantisation error, recorded; the route at KVQ_CARD_LAYERS layers
    card against CPU under its limit and its TF32 control; and a step at a
    KVQ_TIMED_CAPACITY-row cache timed beside the bf16 kv8d step. Returns
    the phase's record and kernel 2's fields."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_decoder as F
    from tpu_audio_torch.ops import kv_attention as K

    t_phase = time.perf_counter()
    L = cfg.decoder_layers
    windows = long_file(KVQ_WINDOWS, np.random.default_rng(7))
    with torch.inference_mode():
        enc = models["bf16_kv8d"].encoder(models["bf16_kv8d"].encoder_features(audio))
    out, k2, forced = {}, {}, {}
    for name, tree, kw in KVQ_ROUTES:
        model = models[tree]
        gp = STTGenerateParameters(max_tokens=KVQ_TOKENS, **kw)
        rec, first = dict(tree=tree, **kw), None
        for run, (x, n_win) in enumerate(((audio, 1), (audio, 1), (windows, KVQ_WINDOWS))):
            steps, plain = [0], [0]
            ctx = kvq_recorder() if run == 0 else contextlib.nullcontext(([], []))
            with ctx as (caches, writes), counting(W, "decoder_step", steps), \
                    counting(K, "decode_attention_int8_ref", plain), \
                    counting(F, "fused_stack_ref", plain):
                _lib.reset_launches()
                o, wall = timed_generate(model, x, gp)
                launches = dict(_lib.launches)
            toks = window_tokens(o, n_win)
            k2_want = L * steps[0] if kw["kv_bits"] == 8 else 0
            label = f"[whisper kvq {name} {'batch' if n_win > 1 else 'window'} run {run}]"
            print(f"{label} {sum(map(len, toks))} tokens in {wall:.3f} s ({steps[0]} steps, "
                  f"{wall * 1e3 / steps[0]:.2f} ms a step); launches {launches}, plain calls "
                  f"{plain[0]}; first tokens {toks[0][:8]}")
            check(launches.get("decode_attention_int8", 0) == k2_want,
                  f"{label}: kernel 2 launched {launches.get('decode_attention_int8', 0)} "
                  f"times, {k2_want} expected")
            check(launches.get("fused_log_mel", 0) == n_win and plain[0] == 0 and not any(
                launches.get(k, 0) for k in ("fused_stack", "fused_stack_lanes")),
                f"{label}: kernel 1 not once a window, a fused stack, or a plain call")
            if run == 0:
                first = toks[0]
                check(len(caches) == 1 and type(caches[0]).__name__ == (
                    "HybridKVCache" if 0 < kw["quantized_kv_start"] < len(PROMPT) + KVQ_TOKENS
                    else "QuantKVCache"), f"{label}: self caches "
                                          f"{[type(c).__name__ for c in caches]}")
                rec["codes_checked"] = kvq_codes_check(caches[0], writes, L)
                print(f"{label} self-cache rows written on the card equal the CPU's bit for "
                      f"bit: {rec['codes_checked']}")
                rec.update(window_wall_s=wall, steps=steps[0], launches=launches,
                           kernel2_per_step=launches.get("decode_attention_int8", 0) / steps[0])
            elif n_win == 1:
                check(toks[0] == first, f"{label}: greedy tokens differ between runs")
                rec["window_wall_s_repeat"] = wall
            else:
                rec.update(batch_wall_s=wall, batch_steps=steps[0], batch_launches=launches,
                           batch_tokens=[len(t) for t in toks])
        # a tree's routes are forced along its first route's tokens, against
        # one dense run
        with torch.inference_mode():
            if tree not in forced:
                seq = PROMPT + first
                forced[tree] = (seq, kvq_steps(W.decode_step_fn(
                    model.params, enc, max_total=len(seq), cfg=cfg,
                    layers=model.decoder.split_layers()), seq, dev))
            seq, dense = forced[tree]
            got = kvq_steps(W.decode_step_fn(model.params, enc, max_total=len(seq), cfg=cfg,
                                             layers=model.decoder.split_layers(), **kw), seq, dev)
        rec["quantisation_rel_err"] = rel_err(got[len(PROMPT) - 1:], dense[len(PROMPT) - 1:])
        rec["card_vs_cpu"] = kvq_card_vs_cpu(model, enc, seq, kw)
        cc = rec["card_vs_cpu"]
        print(f"[whisper kvq {name}] teacher-forced logits against the dense route (the "
              f"quantisation error, no limit): {rec['quantisation_rel_err']:.3e}; at "
              f"{KVQ_CARD_LAYERS} layers in f32 card against CPU {cc['rel_err']:.3e} (limit "
              f"{KVQ_CARD_RTOL}), TF32 control {cc['tf32_control']:.3e}, bf16 control "
              f"{cc['bf16_control']:.3e}; {cc['act_codes']} int8 activations fed to the CPU, "
              f"{cc['act_flips']} code(s) rounded the other way, at most "
              f"{cc['act_flip_dist']:.2e} from a boundary, scales {cc['act_scale_rel']:.1e} apart")
        check(cc["rel_err"] <= KVQ_CARD_RTOL < cc["bf16_control"],
              f"[whisper kvq {name}] card against CPU {cc}: not within {KVQ_CARD_RTOL}, or "
              f"the bf16 control within it")
        rec["step"] = kvq_timing(model, enc, seq, kw, name)
        out[name] = rec
        k2[name] = rec["kernel2_per_step"]
    out["bf16_kv8d_step"] = kvq_timing(models["bf16_kv8d"], enc, forced["bf16_kv8d"][0],
                                       dict(kv_bits=8, quantized_kv_start=448), "bf16 kv8d")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[whisper kvq] {smi}: the phase {out['seconds']:.1f} s")
    return out, dict(kvq_launches_per_step=k2,
                     kvq_launches=sum(r["launches"].get("decode_attention_int8", 0)
                                      + r["batch_launches"].get("decode_attention_int8", 0)
                                      for r in out.values() if isinstance(r, dict)
                                      and "launches" in r))


def build_vyvo(dev):
    """VyvoTTS at Qwen3-0.6B's published widths (VYVO_06B) from seed-0
    random weights on the card, seeded non-unit RMSNorm weights (q/k norms
    included), the audio band's embedding rows scaled by VYVO_BAND_SCALE so
    that greedy decoding emits audio codes as a trained checkpoint does, and
    the SNAC 24 kHz codec: the bf16 model and the MLX 4-bit one (every
    projection and the tied embedding quantized on the card in groups of
    64), q/k/v and gate/up fused in both."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.tts import llama_tts as TT
    from tpu_audio_torch.models.tts import qwen3_vyvo as TV

    cfg = TT.LlamaTTSConfig(**VYVO_06B)
    params = llama.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                                      on_device=True)
    randomize_norms(params, torch.Generator(device=dev).manual_seed(3))
    T = TV.VYVO_TOKENS
    params["model"]["embed_tokens"]["weight"][
        T.audio_token_offset:T.audio_token_offset + 7 * T.codebook_size] *= VYVO_BAND_SCALE
    q4 = llama.fuse_projections(quant.quantize_tree(params, bits=4, group_size=64,
                                                    scheme="mlx"))
    check(isinstance(q4["model"]["layers"]["self_attn"]["qkv_proj"]["weight"],
                     quant.QuantizedTensor)
          and isinstance(q4["model"]["embed_tokens"]["weight"], quant.QuantizedTensor),
          "VyvoTTS 4-bit: the projections or the embedding are not packed")
    codec = build_snac(dev)
    models = {name: TV.VyvoTTS(cfg, tree, tokenizer=ByteTokenizer(), codec=codec,
                               tokens=T, dtype=torch.bfloat16)
              for name, tree in (("q4", q4), ("bf16", llama.fuse_projections(params)))}
    for m in models.values():
        check(m.config.qk_norm and not TT._fused_route(m.params, cfg, m.device),
              "VyvoTTS: no q/k norm, or a fused route")
    return models


def vyvo_generate(model, n: int, stream: bool = False):
    """One greedy ``generate`` (or ``generate_stream``) of ``n`` tokens with
    the counters reset just before and read just after: (all tokens of the
    run, the waveform, wall s, prefill s, decode steps, launches, plain
    calls)."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters, AudioGenerationKind
    from tpu_audio_torch.ops import _lib, qmm

    gp = AudioGenerateParameters(max_tokens=n, temperature=0.0, repetition_penalty=1.3,
                                 repetition_context_size=20)
    steps, plain, seen = [0], [0], {}
    run_generation = model._run_generation

    def spy(*a, **k):
        for item in run_generation(*a, **k):
            seen["item"] = item
            yield item

    model._run_generation = spy
    model._decoders.clear()
    try:
        with counting(model, "_step_fn", steps), counting(qmm, "quantized_matvec_ref", plain):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stream:
                wav = np.concatenate([e.audio for e in model.generate_stream(
                    TTS_TEXT, generation_parameters=gp) if e.kind == AudioGenerationKind.AUDIO])
            else:
                wav = model.generate(TTS_TEXT, generation_parameters=gp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.launches)
    finally:
        del model._run_generation
        model._decoders.clear()
    _, _, (pt, _, _, all_tokens) = seen["item"]
    return all_tokens, wav, wall, pt, steps[0], launches, plain[0]


def vyvo_pcm_stream(model) -> dict:
    """``core.generation.pcm_stream`` on the 4-bit model: PCM_TOKENS greedy
    tokens streamed, resampled from the model's 24 kHz to PCM_RATE and
    quantized to int16 chunk by chunk. The chunks joined equal one
    ``PCMStreamConverter`` push and finish over the model's own streamed
    audio of that call (recorded as ``pcm_stream`` consumed it), converted
    to int16, within one int16 step."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import float_to_pcm16
    from tpu_audio_torch.core.audio_stream import PCMStreamConverter
    from tpu_audio_torch.core.generation import (AudioGenerateParameters, AudioGenerationKind,
                                                 pcm_stream)

    gp = AudioGenerateParameters(max_tokens=PCM_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    heard, stream = [], model.generate_stream

    def spy(*a, **k):
        for ev in stream(*a, **k):
            if ev.kind == AudioGenerationKind.AUDIO:
                heard.append(np.asarray(ev.audio, np.float32))
            yield ev

    model.generate_stream = spy
    try:
        t0 = time.perf_counter()
        chunks = list(pcm_stream(model, TTS_TEXT, out_rate=PCM_RATE, generation_parameters=gp))
        wall = time.perf_counter() - t0
    finally:
        del model.generate_stream
    conv = PCMStreamConverter(PCM_RATE)
    audio = np.concatenate(heard)
    want = float_to_pcm16(np.concatenate([conv.push(audio, model.sample_rate), conv.finish()]))
    got = np.concatenate(chunks)
    diff = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) if got.size else -1
    print(f"[vyvo pcm_stream] {len(chunks)} int16 chunks at {PCM_RATE} Hz ({got.size} samples "
          f"from {audio.size} at {model.sample_rate} Hz, {len(heard)} audio events) in "
          f"{wall:.3f} s; against one converter push and finish over the joined audio: max "
          f"diff {diff} int16 step(s)")
    check(all(c.dtype == np.int16 for c in chunks) and got.shape == want.shape
          and got.size > 0 and 0 <= diff <= 1,
          f"vyvo pcm_stream: {got.shape} against {want.shape}, max diff {diff}")
    return dict(chunks=len(chunks), samples=int(got.size), audio_events=len(heard),
                max_diff=diff, wall_s=wall)


def vyvo_teacher_forced(model, tokens) -> dict:
    """The 4-bit model cut to VYVO_CARD_LAYERS layers, card against CPU on
    the same weights: the prompt's prefill and VYVO_TEACHER_STEPS forced
    steps along ``tokens``, the step logits (f32 activations from the packed
    embedding on; kernel 7 on the card, its plain version on the CPU) within
    VYVO_CARD_RTOL, which the TF32 control (the card on kernel 7's plain
    version, its f32 products in TF32) must exceed."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.tts import qwen3_vyvo as TV

    n = VYVO_CARD_LAYERS
    cfg = dataclasses.replace(model.config, num_hidden_layers=n)
    params = {**model.params, "model": {**model.params["model"], "layers": llama._map(
        lambda t: t[:n], model.params["model"]["layers"])}}
    prompt = model.prepare_input_ids(TTS_TEXT)

    def forced(params, dev):
        m = TV.VyvoTTS(cfg, params, tokenizer=ByteTokenizer(), tokens=model.tokens,
                       dtype=model.dtype)
        cache, last = q4_prefill(m, prompt, VYVO_TEACHER_STEPS)
        out = []
        for t in ([int(last[0])] + list(tokens))[:VYVO_TEACHER_STEPS]:
            logits, cache = m._step_fn(m.params, torch.tensor([[t]], device=dev), cache)
            out.append(logits[0].float().cpu())
        return torch.stack(out)

    with torch.inference_mode():
        card = forced(params, model.device)
        cpu = forced(loading.to_device(params, "cpu"), torch.device("cpu"))
        with plain_kernels(), tf32_leak(matmul=True):
            control = forced(params, model.device)
    out = dict(rel_err=rel_err(card, cpu), tf32_control=rel_err(control, cpu))
    print(f"[vyvo teacher-forced] {n} layers, {VYVO_TEACHER_STEPS} steps: logits card against "
          f"CPU {out['rel_err']:.3e} (limit {VYVO_CARD_RTOL}), TF32 control (kernel 7's plain "
          f"version, TF32 products) {out['tf32_control']:.3e}")
    check(out["rel_err"] <= VYVO_CARD_RTOL < out["tf32_control"],
          f"vyvo card against CPU {out}: not within {VYVO_CARD_RTOL}, or the control within it")
    return out


def vyvo_serve(model, solo: dict) -> dict:
    """Q4_SERVE_TEXTS staggered greedy requests of VYVO_SERVE_TOKENS tokens
    through ``ContinuousTTS`` (the plain tick) at VYVO_SERVE_SLOTS slots, the counters reset just
    before and read just after: kernel 7's tile 4 x 28 + 1 times a prefill
    (the full head's logits over the prompt) and its decode kernel 4 x 28 +
    1 times a lane step, nothing else; each request's tokens equal its solo
    ``_run_generation``'s (``solo``: text -> tokens), both on 1-row decode
    kernel steps from the same tile prefill."""
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.ops import _lib, qmm
    from tpu_audio_torch.parallel.continuous import ContinuousTTS

    L = model.config.num_hidden_layers
    gp = AudioGenerateParameters(max_tokens=VYVO_SERVE_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    prefills, steps, plain = [0], [0], [0]
    with counting(model, "_prefill", prefills), counting(model, "_step_fn", steps), \
            counting(qmm, "quantized_matvec_ref", plain):
        srv = ContinuousTTS(model, slots=VYVO_SERVE_SLOTS, generation_parameters=gp)
        check(not srv.fused, "a 4-bit VyvoTTS took the fused tick")
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [srv.submit(t) for t in Q4_SERVE_TEXTS[:2]]
        list(srv.step())
        reqs += [srv.submit(t) for t in Q4_SERVE_TEXTS[2:]]
        list(srv.run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
    served = [list(r.tokens) for r in reqs]
    want = {"quantized_matvec_tile": (4 * L + 1) * prefills[0],
            "quantized_matvec_decode": (4 * L + 1) * steps[0]}
    want["quantized_matvec"] = sum(want.values())
    equal = [s == solo[t] for s, t in zip(served, Q4_SERVE_TEXTS)]
    print(f"[vyvo serve] {len(reqs)} requests, {VYVO_SERVE_SLOTS} slots: "
          f"{sum(map(len, served))} tokens in {wall:.3f} s ({steps[0]} lane steps, "
          f"{prefills[0]} prefills); launches {launches} ({want} expected), plain calls "
          f"{plain[0]}; each request's tokens equal solo's: {equal}")
    check(launches == want and plain[0] == 0, "vyvo serving launches or plain calls")
    check(all(equal), "served VyvoTTS tokens differ from solo's")
    return dict(requests=len(reqs), wall_s=wall, lane_steps=steps[0], launches=launches,
                equal_to_solo=all(equal))


def write_vyvo_checkpoint(path: Path, geometry: dict, dev) -> Path:
    """A VyvoTTS checkpoint directory at ``geometry`` with a small
    vocabulary and its token table in config.json (VYVO_SMALL_TABLE), seed-0
    random bf16 weights drawn on the card, q/k norms 1 + N(0, 0.1)."""
    import torch

    cfg = {"model_type": "qwen3", **geometry, **VYVO_SMALL_TABLE}
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    gen = torch.Generator(device=dev).manual_seed(0)
    d, ffn, hd = cfg["hidden_size"], cfg["intermediate_size"], cfg["head_dim"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd

    def rand(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device=dev) * std

    def norm(n):
        return 1.0 + rand(n, std=0.1)

    flat = {"model.embed_tokens.weight": rand(cfg["vocab_size"], d), "model.norm.weight": norm(d)}
    for i in range(cfg["num_hidden_layers"]):
        b = f"model.layers.{i}"
        flat.update({f"{b}.input_layernorm.weight": norm(d),
                     f"{b}.post_attention_layernorm.weight": norm(d),
                     f"{b}.self_attn.q_proj.weight": rand(nq, d),
                     f"{b}.self_attn.k_proj.weight": rand(nkv, d),
                     f"{b}.self_attn.v_proj.weight": rand(nkv, d),
                     f"{b}.self_attn.o_proj.weight": rand(d, nq),
                     f"{b}.self_attn.q_norm.weight": norm(hd),
                     f"{b}.self_attn.k_norm.weight": norm(hd),
                     f"{b}.mlp.gate_proj.weight": rand(ffn, d),
                     f"{b}.mlp.up_proj.weight": rand(ffn, d),
                     f"{b}.mlp.down_proj.weight": rand(d, ffn)})
    write_safetensors(path / "model.safetensors", flat, bf16=True)
    return path


def vyvo_w8a8_phase(dev) -> dict:
    """The w8a8 VyvoTTS through ``VyvoTTS.from_pretrained``: a 2-layer
    checkpoint at Qwen3-1.7B's widths (VYVO_17B_W8), which kernel 5 takes,
    loads with its projections apart and decodes through kernel 5
    (``llama_check`` at QK_NORM_CHECKS, 9 launches a layer, one launch a
    greedy token with no plain call); kernel 6 at 4 lanes each bit-equal to
    kernel 5 (``llama_lanes_check``), and two requests served on the fused
    tick with the tokens of their solo runs; then a 2-layer checkpoint at
    Qwen3-0.6B's widths, which kernel 5 does not take (16 x 128 != 1,024):
    ``from_pretrained(quantize_bits="w8a8")`` raises NotImplementedError."""
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters
    from tpu_audio_torch.models.tts import qwen3_vyvo as TV
    from tpu_audio_torch.ops import _lib
    from tpu_audio_torch.ops import fused_llama as FL
    from tpu_audio_torch.parallel.continuous import ContinuousTTS

    out = {}
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        path = write_vyvo_checkpoint(Path(tmp) / "w8", VYVO_17B_W8, dev)
        model = TV.VyvoTTS.from_pretrained(str(path), codec=build_snac(dev),
                                           dtype=torch.bfloat16, quantize_bits="w8a8",
                                           device=dev)
        model.tokenizer = ByteTokenizer()
        cfg = model.config
        check(model._fused_supported() and cfg.qk_norm
              and "q_proj" in model.params["model"]["layers"]["self_attn"],
              "w8a8 VyvoTTS at 2,048 wide: not on kernel 5's route")
        checks = []
        for i, (off, vf) in enumerate(QK_NORM_CHECKS):
            kc, vc, x = llama_inputs(model, dev, 30 + i)
            checks.append(llama_check("vyvo w8a8 L=2", model, kc, vc, x, off, vf, ties=True))
        pack = model.fused_decoder_pack()
        kc, vc, x = llama_inputs(model, dev, 5)
        out["layer_launches"] = stack_launches(
            lambda: FL.fused_llama_stack(pack, kc, vc, x, LLAMA_TIME_OFFSET, cfg=cfg),
            cfg.num_hidden_layers, LLAMA_LAYER_LAUNCHES, LLAMA_K5_KERNELS,
            "vyvo fused_llama_stack")
        gp = AudioGenerateParameters(max_tokens=VYVO_W8_TOKENS, temperature=0.0,
                                     repetition_penalty=1.3, repetition_context_size=20)
        steps, plain = [0], [0]
        with counting(model, "_fused_step_fn", steps), \
                counting(FL, "fused_llama_stack_ref", plain):
            _lib.reset_launches()
            for *_, (_pt, _gt, plen, toks) in model._run_generation(
                    TTS_TEXT, None, None, None, gp, VYVO_W8_TOKENS):
                pass
            launches = dict(_lib.launches)
        solo = toks[plen:]
        print(f"[vyvo w8a8] {len(solo)} greedy tokens through kernel 5: {steps[0]} steps, "
              f"launches {launches}, plain calls {plain[0]}")
        check(launches.get("fused_llama_stack", 0) == steps[0] == len(solo) and plain[0] == 0
              and launches.get("fused_llama_stack", 0) == sum(launches.values()),
              "w8a8 VyvoTTS: not one kernel 5 launch a token, or another kernel or a plain call")
        out.update(checks=checks, tokens=len(solo), launches=launches)
        kc, vc, lanes, offs, x = llama_lane_inputs(model, dev, LANE_SLOTS, 4, 40)
        out["lanes"] = llama_lanes_check("vyvo w8a8 lanes L=2", model, kc, vc, lanes, offs, x)
        del kc, vc
        srv = ContinuousTTS(model, slots=2, generation_parameters=gp)
        check(srv.fused, "w8a8 VyvoTTS serving did not take the fused tick")
        lplain = [0]
        with counting(FL, "fused_llama_stack_lanes_ref", lplain):
            _lib.reset_launches()
            reqs = [srv.submit(TTS_TEXT), srv.submit(TTS_TEXT)]
            list(srv.run())
            served = dict(_lib.launches)
        equal = [list(r.tokens) == solo for r in reqs]
        print(f"[vyvo w8a8 serve] two requests on the fused tick: launches {served}, plain "
              f"calls {lplain[0]}; tokens equal the solo run's: {equal}")
        check(served.get("fused_llama_stack_lanes", 0) > 0 and lplain[0] == 0 and all(equal),
              "w8a8 VyvoTTS serving: kernel 6 not launched, a plain call, or tokens differ")
        out.update(serve_launches=served, served_equal_solo=all(equal))
        del model, srv, pack
        small = write_vyvo_checkpoint(Path(tmp) / "w8_06b", VYVO_06B_W8, dev)
        try:
            TV.VyvoTTS.from_pretrained(str(small), dtype=torch.bfloat16, quantize_bits="w8a8",
                                       device=dev)
            refused = None
        except NotImplementedError as e:
            refused = str(e)
        print(f"[vyvo w8a8] at Qwen3-0.6B's widths (16 x 128 heads, 1,024 hidden) "
              f"from_pretrained(quantize_bits='w8a8') on CUDA raises: {refused}")
        check(refused is not None and "fused_llama_stack" in refused,
              "w8a8 VyvoTTS at 0.6B widths did not raise on CUDA")
        out["refused_at_06b"] = True
    return out


def vyvo_phase(dev, smi: str) -> tuple[dict, dict]:
    """``[vyvo]``: VyvoTTS at Qwen3-0.6B widths (``build_vyvo``). On the
    MLX 4-bit model: greedy ``generate`` of VYVO_TOKENS twice and
    ``generate_stream`` once, the counters reset just before and read just
    after each (kernel 7's tile 4 x 28 + 1 times for the prefill, its
    decode kernel 113 times a step, no GEMV, no other kernel, no plain
    call; tokens and waveform repeat, the stream's tokens the same); the
    4-layer teacher-forced logits card against CPU; TTFB, realtime factor,
    host and device ms a token (``q4_ttfb_phase``); ``pcm_stream`` against
    one converter pass (``vyvo_pcm_stream``); ``ContinuousTTS`` at 4
    slots against solo. On the bf16 model one greedy ``generate`` of
    VYVO_REPEAT_TOKENS tokens and its ms a token. Then the w8a8 trees (``vyvo_w8a8_phase``). Returns the
    record and kernel 7's, 5's and 6's fields."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import AudioGenerateParameters

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    models = build_vyvo(dev)
    torch.cuda.synchronize()
    print(f"[vyvo] Qwen3-0.6B widths, vocabulary {VYVO_06B['vocab_size']}: bf16 and MLX 4-bit "
          f"(g 64) built on the card with the SNAC 24 kHz codec in "
          f"{time.perf_counter() - t0:.1f} s")
    q4 = models["q4"]
    L, sr = q4.config.num_hidden_layers, q4.sample_rate
    out, runs, first = {}, [], None
    for run, (n, stream) in enumerate(((VYVO_GENERATE_TOKENS, False),
                                       (VYVO_REPEAT_TOKENS, False), (VYVO_REPEAT_TOKENS, True))):
        toks, wav, wall, pt, steps, launches, plain = vyvo_generate(q4, n, stream)
        plen = len(q4.prepare_input_ids(TTS_TEXT))
        gen = toks[plen:]
        n_tile = launches.get("quantized_matvec_tile", 0)
        n_dec = launches.get("quantized_matvec_decode", 0)
        n_gemv = launches.get("quantized_matvec", 0) - n_tile - n_dec
        frames = len(q4.parse_output(toks)) // 7
        label = f"[vyvo q4 {'generate_stream' if stream else 'generate'} run {run}]"
        print(f"{label} {len(gen)} tokens, {frames} frames ({wav.shape[0]} samples) in "
              f"{wall:.3f} s (prefill {pt * 1e3:.2f} ms, {steps} decode steps at "
              f"{(wall - pt) * 1e3 / steps:.2f} ms with the codec); RTF "
              f"{wall / (wav.shape[0] / sr):.3f}; "
              f"launches {launches}: tile {n_tile} ({4 * L + 1} expected), decode {n_dec} "
              f"({(4 * L + 1) * steps} expected), GEMV {n_gemv}; plain calls {plain}")
        check(n_tile == 4 * L + 1 and n_dec == (4 * L + 1) * steps and n_gemv == 0
              and plain == 0 and set(launches) <= {"quantized_matvec", "quantized_matvec_tile",
                                                  "quantized_matvec_decode"},
              f"{label}: kernel 7's launches, another kernel or a plain call")
        check(frames > 0 and bool(np.isfinite(wav).all())
              and wav.shape[0] == frames * 4 * q4.codec.config.hop_length,
              f"{label}: {frames} frames, waveform {wav.shape}")
        if first is None:
            first = (gen, wav, launches)
        # a repeat's waveform is the decode of the first run's prefix
        want = wav if run == 0 else q4._decode_codes(q4.parse_output(toks[:plen] + first[0][:n]))
        check(gen == first[0][:n] and (np.array_equal(wav, want) if not stream
                                       else wav.shape == want.shape),
              f"{label}: tokens or waveform differ from the first run's prefix")
        runs.append(dict(api="generate_stream" if stream else "generate", run=run,
                         tokens=len(gen), steps=steps, frames=frames, wall_s=wall, prefill_s=pt,
                         ms_per_step_with_codec=(wall - pt) * 1e3 / steps,
                         rtf=wall / (wav.shape[0] / sr)))
    out["q4_runs"] = runs
    out["q4_bound"] = packed_step_bound(q4)
    print(f"[vyvo q4] a decode step's {out['q4_bound'][2]} kernel-7 products: bound "
          f"{out['q4_bound'][0]:.4f} ms ({out['q4_bound'][1]})")
    check(out["q4_bound"][2] == 4 * L + 1, f"{out['q4_bound'][2]} packed products a step")
    out["q4_teacher_forced"] = vyvo_teacher_forced(q4, first[0])
    out["q4_ttfb"] = q4_ttfb_phase(q4, label="vyvo q4")
    out["pcm_stream"] = vyvo_pcm_stream(q4)
    solo = {}
    gp = AudioGenerateParameters(max_tokens=VYVO_SERVE_TOKENS, temperature=0.0,
                                 repetition_penalty=1.3, repetition_context_size=20)
    with torch.inference_mode():
        for text in Q4_SERVE_TEXTS:
            for *_, (_pt, _gt, plen, toks) in q4._run_generation(text, None, None, None, gp,
                                                                 VYVO_SERVE_TOKENS):
                pass
            solo[text] = toks[plen:]
    out["q4_serve"] = vyvo_serve(q4, solo)
    bf16 = models["bf16"]
    toks, wav, wall, pt, steps, launches, _ = vyvo_generate(bf16, VYVO_REPEAT_TOKENS)
    check(not launches, f"the bf16 VyvoTTS launched a kernel of the port: {launches}")
    out["bf16_run"] = dict(tokens=len(toks) - len(bf16.prepare_input_ids(TTS_TEXT)),
                           wall_s=wall, prefill_s=pt,
                           ms_per_step_with_codec=(wall - pt) * 1e3 / steps,
                           rtf=wall / (wav.shape[0] / sr))
    out["bf16_decode"] = q4_ttfb_phase(bf16, label="vyvo bf16", ttfb=False)
    print(f"[vyvo bf16 generate] {out['bf16_run']}")
    del models, q4, bf16
    gc.collect()
    torch.cuda.empty_cache()
    out["w8a8"] = vyvo_w8a8_phase(dev)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[vyvo] {smi}: the phase {out['seconds']:.1f} s")
    k7 = dict(vyvo_launches=first[2], vyvo=dict(
        decode_per_step=first[2].get("quantized_matvec_decode", 0) / runs[0]["steps"],
        tile_per_prefill=first[2].get("quantized_matvec_tile", 0),
        device_ms_per_token=out["q4_ttfb"]["device_ms_per_token"],
        kernel7_device_ms_per_token=out["q4_ttfb"]["kernel7_device_ms_per_token"],
        bound_ms=out["q4_bound"][0], bound_by=out["q4_bound"][1], products=out["q4_bound"][2]))
    return out, dict(quantized_matvec=k7,
                     fused_llama_stack=dict(vyvo_launches=out["w8a8"]["launches"],
                                            vyvo_layer_launches=out["w8a8"]["layer_launches"]),
                     fused_llama_stack_lanes=dict(vyvo_launches=out["w8a8"]["serve_launches"]))


def packed_step_bound(model) -> tuple[float, str, int]:
    """The bound of one 1-row decode step's kernel-7 products on ``model``'s
    packed tree: every packed word, scale and bias read once, x in and y out
    in f32 per product, a multiply-add a weight in f32; and the count of
    products (a stacked leaf is one a layer)."""
    from tpu_audio_torch.core import quant

    def packed(tree):
        if isinstance(tree, dict):
            return [q for v in tree.values() for q in packed(v)]
        return [tree] if isinstance(tree, quant.QuantizedTensor) else []

    nb = ops = products = 0
    for q in packed(model.params["model"]):
        n = q.weight.shape[0] if q.weight.ndim == 3 else 1
        o, i = q.weight.shape[-2], q.weight.shape[-1] * 32 // q.bits
        nb += nbytes(q.weight, q.scales, q.biases) + 4 * n * (i + o)
        ops += 2 * n * o * i
        products += n
    return (*bound(nb, f32_ops=ops), products)


class Qwen3AsrTokenizer:
    """Stub tokenizer with Qwen3's ids where the prompt needs them: the
    specials (``<|im_start|>`` 151644, ``<|im_end|>`` 151645,
    ``<|audio_pad|>`` 151646, the config's ``audio_token_id``,
    ``<|audio_start|>`` 151669, ``<|audio_end|>`` 151670, ``<asr_text>``
    151704) and the template's words and newline, so that a prompt has the
    real tokenizer's 15 rows besides its audio tokens; any other byte is
    its own id. ``decode`` writes each id that is not special as
    ``w<id>``."""

    SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|audio_pad|>": 151646,
                "<|audio_start|>": 151669, "<|audio_end|>": 151670, "<asr_text>": 151704}
    WORDS = {"system": 8948, "user": 872, "assistant": 77091, "\n": 198}

    class _Ids:
        def __init__(self, ids):
            self.ids = ids

    def encode(self, text):
        import re

        ids = []
        for piece in re.split("(" + "|".join(map(re.escape, list(self.SPECIALS)
                                                 + list(self.WORDS))) + ")", text):
            if piece in self.SPECIALS or piece in self.WORDS:
                ids.append(self.SPECIALS.get(piece, self.WORDS.get(piece)))
            else:
                ids += list(piece.encode())
        return self._Ids(ids)

    def decode(self, ids, skip_special_tokens=True):
        special = set(self.SPECIALS.values()) | {151643}
        return " ".join(f"w{i}" for i in ids if not (skip_special_tokens and i in special))


class StepClock:
    """The session's clock: the seconds that ``advance`` added."""

    def __init__(self):
        self.t = 0.0

    def advance(self, dt: float) -> None:
        self.t += dt

    def __call__(self) -> float:
        return self.t


def asr_signal(seconds: float, seed: int) -> "np.ndarray":
    """The speech clip repeated to ``seconds`` at 16 kHz with seeded noise
    x 0.01 beside it (f32)."""
    import numpy as np

    from tpu_audio_torch.core.audio_io import load_audio

    speech = load_audio(str(AUDIO), sample_rate=16000)[0]
    n = int(seconds * 16000)
    x = np.resize(speech, n).astype(np.float32)
    return x + np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 0.01


def build_qwen3_asr(dev):
    """Qwen3-ASR at ASR_TEXT's widths (``build_qwen3_asr``'s audio tower at
    ``AudioEncoderConfig()``) from seed-0 random weights on the card
    (``qwen3_asr.init_random_params``), the text decoder's RMSNorm weights
    (q/k norms included) 1 + N(0, 0.1), quantized on the card to MLX 4-bit
    in groups of 64 by ``quant.quantize_tree``'s predicate, q/k/v and
    gate/up fused; the stub tokenizer. Returns the model and the packed
    leaves' paths."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.stt import qwen3_asr as QA

    cfg = QA.Qwen3ASRConfig(audio=QA.AudioEncoderConfig(), text=llama.LlamaConfig(**ASR_TEXT))
    params = QA.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    randomize_norms(params["model"], torch.Generator(device=dev).manual_seed(3))
    params = llama.fuse_projections(quant.quantize_tree(params, bits=4, group_size=64,
                                                        scheme="mlx"))

    def packed(tree, path=""):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in packed(v, f"{path}.{k}" if path else k)]
        return [path] if isinstance(tree, quant.QuantizedTensor) else []

    paths = packed(params)
    tower = params["audio_tower"]
    check(isinstance(params["model"]["layers"]["self_attn"]["qkv_proj"]["weight"],
                     quant.QuantizedTensor)
          and isinstance(params["model"]["embed_tokens"]["weight"], quant.QuantizedTensor)
          and isinstance(tower["layers"]["0"]["fc2"]["weight"], quant.QuantizedTensor)
          and not isinstance(tower["conv_out"]["weight"], quant.QuantizedTensor),
          "Qwen3-ASR 4-bit: the projections, the embedding or the tower are not packed as "
          "the predicate says")
    return QA.Qwen3ASR(cfg, params, Qwen3AsrTokenizer(), torch.bfloat16), paths


def asr_counted(model, fn):
    """``fn()`` with the counters reset just before and read just after:
    (result, wall s, launches, decode steps, plain calls of kernels 1 and 7,
    and each ``decode_features_tokens`` call's (tokens, prefill rows, tile
    launches))."""
    import torch

    from tpu_audio_torch.ops import _lib, mel, qmm

    steps, plain, calls = [0], [0], []
    decode = model.decode_features_tokens

    def spy(*a, **k):
        tile = _lib.launches["quantized_matvec_tile"]
        out = decode(*a, **k)
        rows = out[1] + len(k.get("forced_tokens") or []) - 1
        calls.append((out[0], rows, _lib.launches["quantized_matvec_tile"] - tile))
        return out

    model.decode_features_tokens = spy
    model._decoders.clear()
    try:
        with counting(model, "_step_fn", steps), counting(qmm, "quantized_matvec_ref", plain), \
                counting(mel, "fused_log_mel_ref", plain):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.launches)
    finally:
        del model.decode_features_tokens
        model._decoders.clear()
    return out, wall, launches, steps[0], plain[0], calls


def asr_kernel_checks(model, audio, smi: str) -> dict:
    """Kernel 1 at the frontend's shape (the clip's 201-bin STFT, symmetric
    Hann, 128 HTK mels) against its plain version, timed, with its bound;
    kernel 7 at the text decoder's shapes (layer 0's qkv, o, gate/up and
    down products and the tied head): the decode kernel at 1 row with f32 x
    (a decode step, the packed embedding's f32 activations) and the tile at
    a one-second pass's prompt rows with bf16 x."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.ops import mel as M

    dev = model.device
    spec = dsp.stft(torch.from_numpy(audio).to(dev), dsp.hanning_window(400), 400, 160)
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(16000, 400, 128, norm="slaney",
                                          mel_scale="htk")).to(dev)
    got, want, err = mel_check(f"qwen3 asr mel, {len(audio) / 16000:g} s, 128 HTK mels",
                               lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    b_ms, b_by = mel_bound(re, im, fb, got)
    k1 = dict(shape=[re.shape[0], re.shape[1], fb.shape[1]], max_abs_err=err,
              rel_err=rel_err(got, want), bound_ms=b_ms, bound_by=b_by,
              ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
              dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    print(f"[qwen3 asr mel] kernel 1 at [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},"
          f"{fb.shape[1]}]: max abs err {err:.3e} (atol {MEL_ATOL}); per call kernel "
          f"{k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; device kernel {fmt(k1['dev_ms'])}, "
          f"plain {fmt(k1['plain_dev_ms'])}; bound {b_ms:.6f} ms ({b_by}) ({smi})")
    p = model.params["model"]
    layer = [(n, p["layers"][a][n]["weight"].map(lambda t: t[0]))
             for a, names in (("self_attn", ("qkv_proj", "o_proj")),
                              ("mlp", ("gate_up_proj", "down_proj"))) for n in names]
    rows = len(model.build_prompt(13)) - 1  # a one-second pass's prefill
    gen = torch.Generator(device=dev).manual_seed(13)
    out = []
    for name, w in layer + [("head", p["embed_tokens"]["weight"])]:
        for r, dt, kernel in ((1, torch.float32, "decode"), (rows, torch.bfloat16, "tile")):
            x = torch.randn((r, w.weight.shape[-1] * 32 // w.bits), generator=gen,
                            device=dev).to(dt)
            e, _, ran = qmm_check(f"qwen3 asr {name} [{r}]", x, w.weight, w.scales, w.biases,
                                  w.group_size, w.bits)
            check(ran == kernel, f"qwen3 asr {name} at {r} rows ran the {ran}, not the {kernel}")
            out.append(dict(shape=name, rows=r, x=str(dt).split(".")[-1], kernel=ran,
                            o=w.weight.shape[0], i=x.shape[1], rel_err=e))
    worst = {k: max(c["rel_err"] for c in out if c["x"] == k) for k in ("float32", "bfloat16")}
    print(f"[qwen3 asr qmm] kernel 7 at the text decoder's {len(out) // 2} shapes (4-bit, g "
          f"64): the decode kernel at 1 row, rel err up to {worst['float32']:.3e} (rtol "
          f"{QMM_RTOL}); the tile at {rows} rows with bf16 x, {worst['bfloat16']:.3e} (rtol "
          f"{QMM_BF16_RTOL})")
    return dict(k1=k1, k7=out)


def asr_generate_runs(model, audio) -> tuple[list, dict]:
    """Greedy ``generate`` of ASR_TOKENS tokens on ``audio`` twice, the
    counters reset just before and read just after each: kernel 1 once,
    kernel 7's decode kernel 4 x 28 + 1 times a decode step, no tile (the
    prefill's rows are more than 64: the products dequantize), no GEMV, no
    plain call; the tokens repeat. Then time to first token (encoder,
    prefill and the first step: ``generate`` of one token, the best of
    ASR_TTFT_REPEATS)."""
    from tpu_audio_torch.core.generation import STTGenerateParameters

    L = model.config.text.num_hidden_layers
    seconds = len(audio) / 16000
    runs, first = [], None
    for run in range(2):
        out, wall, launches, steps, plain, calls = asr_counted(
            model, lambda: model.generate(audio, STTGenerateParameters(max_tokens=ASR_TOKENS)))
        (toks, rows, _), = calls
        n_dec = launches.get("quantized_matvec_decode", 0)
        label = f"[qwen3 asr generate run {run}]"
        print(f"{label} {seconds:g} s: {len(toks)} tokens in {wall:.3f} s ({steps} decode "
              f"steps, a {rows}-row prefill); RTF {wall / seconds:.4f}; launches {launches}: "
              f"decode kernel {n_dec} ({(4 * L + 1) * steps} expected); plain calls {plain}; "
              f"text {out.text[:60]!r}")
        check(launches.get("fused_log_mel") == 1 and n_dec == (4 * L + 1) * steps
              and launches.get("quantized_matvec") == n_dec
              and not launches.get("quantized_matvec_tile") and plain == 0
              and set(launches) <= {"fused_log_mel", "quantized_matvec", "quantized_matvec_tile",
                                    "quantized_matvec_decode"},
              f"{label}: kernel 1 or 7's launches, another kernel or a plain call")
        check(len(toks) == steps == ASR_TOKENS and rows > 64,
              f"{label}: {len(toks)} tokens, {steps} steps, {rows}-row prefill")
        if first is None:
            first = (toks, launches)
        check(toks == first[0], f"{label}: tokens differ from the first run's")
        runs.append(dict(run=run, tokens=len(toks), steps=steps, prefill_rows=rows,
                         wall_s=wall, rtf=wall / seconds, launches=launches))
    walls = []
    for _ in range(ASR_TTFT_REPEATS):
        out, wall, *_ = asr_counted(
            model, lambda: model.generate(audio, STTGenerateParameters(max_tokens=1)))
        walls.append(wall)
    ttft = dict(ttft_ms=min(walls) * 1e3, ttft_all_ms=[w * 1e3 for w in walls])
    print(f"[qwen3 asr ttft] {seconds:g} s: time to first token (mel, encoder, prefill, first "
          f"step) {ttft['ttft_ms']:.3f} ms (best of {[f'{w * 1e3:.3f}' for w in walls]})")
    return runs, dict(first_tokens=first[0], launches=first[1], **ttft)


def asr_decode_profile(model, audio, smi: str) -> dict:
    """A greedy decode chunk of ASR_PROFILE_TOKENS tokens after
    ``decode_features_tokens``'s prefill of ``audio``'s prompt: ms a token
    on the host clock (best of 3), then under the profiler the device busy
    ms, events and kernel 7's share a token, beside the bound of one step's
    113 packed products."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.core.ar_loop import make_decode_chunk
    from tpu_audio_torch.core.sampling import SamplingParams
    from tpu_audio_torch.models import llama

    n, dev, tcfg = ASR_PROFILE_TOKENS, model.device, model.config.text
    with torch.no_grad():
        feats = model.encode_audio(model.preprocess_audio(audio)[0])
        ids = np.asarray([model.build_prompt(feats.shape[0])], np.int32)
        emb = model._merge_audio_features(ids, feats)
        cache = llama.make_cache(tcfg, 1, ids.shape[1] + n + 1, model.dtype, device=dev)
        _, cache = llama.forward(model.params, None, cache, tcfg,
                                 inputs_embeds=emb[:, :-1].to(model.dtype))
        dec = make_decode_chunk(model._step_fn, SamplingParams(temperature=0.0,
                                                               repetition_penalty=1.0),
                                history_size=1)

        def args():
            return (model.params, cache._replace(k=cache.k.clone(), v=cache.v.clone()),
                    torch.tensor(ids[0, -1:], device=dev), torch.zeros((n,), dtype=torch.int64,
                                                                      device=dev),
                    torch.Generator(device=dev).manual_seed(0), -1,
                    torch.zeros((1, 1), dtype=torch.int64, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))

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
        # device activity only: the host side of ~15,000 eager launches
        # would cost the profiler seconds to gather
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dec(*a)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = by_kernel(prof)
    busy_ms = sum(c[1] for c in kernels.values()) / 1e3
    events = sum(c[0] for c in kernels.values())
    k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]
    k7_ms, k7_n = sum(c[1] for c in k7) / 1e3, sum(c[0] for c in k7)
    b_ms, b_by, products = packed_step_bound(model)
    out = dict(ms_per_token=min(walls) * 1e3 / n, device_ms_per_token=busy_ms / n,
               kernel7_device_ms_per_token=k7_ms / n, kernel7_launches_per_token=k7_n / n,
               busy_share=busy_ms / prof_ms, device_events_per_token=events / n,
               bound_ms=b_ms, bound_by=b_by, products=products)
    print(f"[qwen3 asr decode] {n}-token chunk after a {ids.shape[1] - 1}-row prefill: "
          f"{out['ms_per_token']:.4f} ms a token (best of 3, host clock); under the profiler "
          f"wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms (share {out['busy_share']:.4f}), "
          f"{busy_ms / n:.4f} device ms a token of which kernel 7 {k7_ms / n:.4f} "
          f"({k7_n / n:.1f} launches a token) against the bound of its {products} products "
          f"{b_ms:.4f} ms ({b_by}); {events / n:.1f} device events a token ({smi})")
    print_kernels(kernels, n, top=10)
    check(products == 4 * tcfg.num_hidden_layers + 1, f"{products} packed products a step")
    return out


def asr_cut(model, n: int):
    """``model``'s config and tree cut to its first ``n`` audio and text
    layers, in f32 (packed leaves stay packed; an ``lm_head`` is kept)."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models import llama

    cfg = dataclasses.replace(
        model.config, audio=dataclasses.replace(model.config.audio, encoder_layers=n),
        text=dataclasses.replace(model.config.text, num_hidden_layers=n))
    p = model.params
    tower = {**p["audio_tower"], "layers": {str(i): p["audio_tower"]["layers"][str(i)]
                                            for i in range(n)}}
    cut = {**p, "audio_tower": tower, "model": {
        **p["model"], "layers": llama._map(lambda t: t[:n], p["model"]["layers"])}}
    return cfg, loading.cast_floats(cut, torch.float32)


def asr_card_vs_cpu(model, audio, tokens) -> dict:
    """The model cut to ASR_CARD_LAYERS audio and text layers, in f32, card
    against CPU on the same weights and ``audio`` (one whole window): the
    encoder features, the merged prompt embeddings, and ASR_TEACHER_STEPS
    step logits along ``tokens`` after the prompt's prefill (kernels 1 and 7
    on the card, their plain versions on the CPU), each within
    ASR_CARD_RTOL of the CPU relative to its max, and each one's TF32
    control (the card on the plain versions, TF32 products and
    convolutions) above it."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.stt import qwen3_asr as QA

    n = ASR_CARD_LAYERS
    cfg, params = asr_cut(model, n)

    def run(params, dev):
        m = QA.Qwen3ASR(cfg, params, model.tokenizer, torch.float32)
        with torch.no_grad():
            feats = m.encode_audio(m.preprocess_audio(audio)[0])
            ids = np.asarray([m.build_prompt(feats.shape[0])], np.int32)
            emb = m._merge_audio_features(ids, feats)
            cache = llama.make_cache(cfg.text, 1, ids.shape[1] + ASR_TEACHER_STEPS + 1,
                                     torch.float32, device=dev)
            _, cache = llama.forward(m.params, None, cache, cfg.text, inputs_embeds=emb[:, :-1],
                                     return_hidden=True)
            steps = []
            for t in ([int(ids[0, -1])] + list(tokens))[:ASR_TEACHER_STEPS]:
                logits, cache = m._step_fn(m.params, torch.tensor([[t]], device=dev), cache)
                steps.append(logits[0].float().cpu())
        return dict(features=feats.float().cpu(), embeddings=emb.float().cpu()[0],
                    logits=torch.stack(steps))

    card = run(params, model.device)
    cpu = run(loading.to_device(params, "cpu"), torch.device("cpu"))
    with plain_kernels(), tf32_everywhere():
        control = run(params, model.device)
    out = {k: dict(rel_err=rel_err(card[k], cpu[k]), tf32_control=rel_err(control[k], cpu[k]))
           for k in card}
    print(f"[qwen3 asr card vs CPU] {n} audio and {n} text layers in f32, "
          f"{len(audio) / 16000:g} s ({card['features'].shape[0]} audio tokens), "
          f"{ASR_TEACHER_STEPS} forced steps: " + "; ".join(
              f"{k} {v['rel_err']:.3e} (TF32 control {v['tf32_control']:.3e})"
              for k, v in out.items()) + f" (limit {ASR_CARD_RTOL})")
    for k, v in out.items():
        check(bool(torch.isfinite(card[k]).all()) and card[k].shape == cpu[k].shape
              and v["rel_err"] <= ASR_CARD_RTOL < v["tf32_control"],
              f"qwen3 asr {k} card against CPU {v}: not within {ASR_CARD_RTOL}, or the TF32 "
              f"control within it")
    return out


def asr_stream(model, audio) -> dict:
    """``StreamingInferenceSession`` over ``audio`` at 1 s feeds (the
    default StreamingConfig but ASR_STREAM_TOKENS tokens a pass), on a clock
    that moves 1 s a feed, so that every feed may decode; the counters reset
    just before and read just after: kernel 1 once a ``process`` that yields
    frames and once for the flush, kernel 7's tile 4 x 28 + 1 times for
    each pass whose prompt has 64 rows or fewer (at least one), its decode
    kernel 113 times a decode step, no GEMV, no plain call. The event kinds
    are the session's; a window completes and is finalized; the ended
    event's text is the completed text and the rest."""
    import torch

    from tpu_audio_torch.models.stt.streaming import (EventKind, StreamingConfig,
                                                      StreamingInferenceSession, concat_text)

    L = model.config.text.num_hidden_layers
    clock = StepClock()
    session = StreamingInferenceSession(
        model, config=StreamingConfig(max_tokens_per_pass=ASR_STREAM_TOKENS), clock=clock)
    mel_calls = [0]

    def feed_all():
        events = []
        for s in range(0, len(audio), 16000):
            events += session.feed_audio(audio[s:s + 16000])
            clock.advance(1.0)
        return events + session.stop()

    with counting(session.core.mel, "_mel_frames", mel_calls):
        events, wall, launches, steps, plain, calls = asr_counted(model, feed_all)
    core = session.core
    kinds = [e.kind.value for e in events]
    stats = [e.stats for e in events if e.kind == EventKind.STATS][-1]
    n_tile = launches.get("quantized_matvec_tile", 0)
    n_dec = launches.get("quantized_matvec_decode", 0)
    tiles = [c[2] for c in calls]
    seconds = len(audio) / 16000
    print(f"[qwen3 asr stream] {seconds:g} s at 1 s feeds: {stats['decode_passes']} passes "
          f"({len(calls)} decodes, {steps} decode steps) in {wall:.3f} s: session RTF "
          f"{wall / seconds:.4f}, {stats['decode_time'] * 1e3 / max(1, len(calls)):.1f} ms a "
          f"pass; {core.encoder.encoded_window_count} window(s) encoded; prefill rows by pass "
          f"{[c[1] for c in calls]}; tile launches by pass {tiles}; launches {launches} "
          f"(kernel 1 {mel_calls[0]} expected, decode kernel {(4 * L + 1) * steps}); plain "
          f"calls {plain}; events {' '.join(k[:4] for k in kinds)}; ended "
          f"{events[-1].text[:60]!r}")
    check(set(kinds) <= {k.value for k in EventKind} and kinds[-1] == "ended"
          and "display_update" in kinds and "stats" in kinds,
          f"qwen3 asr stream: event kinds {kinds}")
    final = events[-1]
    check(final.text == final.confirmed_text
          == concat_text(concat_text(core.state.completed_text, core.state.confirmed_text),
                         core._decode_text(core.state.provisional_ids))
          and core.state.completed_text and core.encoder.encoded_window_count >= 1,
          "qwen3 asr stream: no window finalized, or the ended text is not the session's")
    check(launches.get("fused_log_mel") == mel_calls[0] > 0 and n_dec == (4 * L + 1) * steps
          and all(t == (4 * L + 1 if 2 <= r <= 64 else 0) for _, r, t in calls)
          and tiles[0] > 0 and plain == 0 and launches.get("quantized_matvec") == n_tile + n_dec,
          "qwen3 asr stream: launches, the first pass not on the tile, or a plain call")
    return dict(seconds=seconds, wall_s=wall, rtf=wall / seconds, passes=stats["decode_passes"],
                decodes=len(calls), steps=steps, prompt_rows=[c[1] for c in calls],
                tile_passes=sum(1 for t in tiles if t),
                ms_per_pass=stats["decode_time"] * 1e3 / max(1, len(calls)),
                windows=core.encoder.encoded_window_count, kinds=kinds, launches=launches)


def asr_serve(model) -> dict:
    """``ContinuousQwen3ASR`` at ASR_SERVE_SLOTS slots, 20 s windows:
    requests of ASR_SERVE_SECONDS (two, one tick, then the rest), the
    counters reset just before and read just after: kernel 1 once a
    request, kernel 7's decode kernel 113 times a lane step, no tile (the
    prefills dequantize), no plain call. Each request's greedy tokens equal
    its solo ``decode_features_tokens`` on the same window's features (both
    on the 1-row decode kernel from the same prefill: bit-equal expected);
    where they part, the solo step's two best logits must be the two tokens
    and lie within the two routes' largest logit difference at that step."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.parallel.continuous_stt import ContinuousQwen3ASR

    L = model.config.text.num_hidden_layers
    srv = ContinuousQwen3ASR(model, slots=ASR_SERVE_SLOTS, window_s=ASR_SECONDS,
                             max_tokens=ASR_SERVE_TOKENS)
    eng = srv.engine
    served_logits, lane_steps = {}, [0]
    step = eng._step_fn

    def recorded(params, cache, slot, tok, pos, ctx):
        out = step(params, cache, slot, tok, pos, ctx)
        served_logits.setdefault((eng._lane[slot].request_id, pos), out[0])
        lane_steps[0] += 1
        return out

    eng._step_fn = recorded
    clips = [asr_signal(s, 40 + i) for i, s in enumerate(ASR_SERVE_SECONDS)]

    def serve():
        reqs = [srv.submit(c) for c in clips[:2]]
        srv.step()
        reqs += [srv.submit(c) for c in clips[2:]]
        srv.drain()
        return reqs

    reqs, wall, launches, _, plain, _ = asr_counted(model, serve)
    served = [[t for t in r.tokens if t not in srv.EOS_IDS] for r in reqs]
    n_dec = launches.get("quantized_matvec_decode", 0)
    solo, parted = [], []
    prompt = len(model.build_prompt(srv._n_audio))
    for i, (clip, req) in enumerate(zip(clips, reqs)):
        win = np.pad(clip[:srv.window], (0, max(0, srv.window - len(clip))))
        mel, n_audio = model.preprocess_audio(win)
        feats = model.encode_audio(mel)[:n_audio]
        logits = []

        def rec(params, tok, cache, _f=model._step_fn):
            out = _f(params, tok, cache)
            logits.append(out[0][0])
            return out

        model._step_fn = rec
        model._decoders.clear()
        try:
            toks = model.decode_features_tokens(
                feats, STTGenerateParameters(max_tokens=ASR_SERVE_TOKENS))[0]
        finally:
            del model._step_fn
            model._decoders.clear()
        solo.append(toks)
        step0 = float((served_logits[(req.request_id, prompt - 1)].float()
                       - logits[0].float()).abs().max())
        if toks != served[i]:
            s = next(j for j in range(min(len(toks), len(served[i])))
                     if toks[j] != served[i][j])
            a, b = logits[s].float(), served_logits[(req.request_id, prompt - 1 + s)].float()
            top = torch.topk(a, 2)
            gap = float(top.values[0] - top.values[1])
            diff = float((a - b).abs().max())
            ok = {toks[s], served[i][s]} == set(top.indices.tolist()) and gap <= diff
            print(f"[qwen3 asr serve witness] request {i} parts from solo at token {s}: solo's "
                  f"top two {gap:.4e} apart, the routes' logits {diff:.4e} apart: "
                  f"{'a near tie' if ok else 'NOT a near tie'}")
            check(ok, f"qwen3 asr serve: request {i}'s tokens differ from solo's, not at a "
                      f"near tie")
            parted.append(dict(request=i, token=s, margin=gap, max_diff=diff))
        print(f"[qwen3 asr serve] request {i} ({ASR_SERVE_SECONDS[i]:g} s): served tokens "
              f"equal solo's: {toks == served[i]}; step 0's logits served against solo "
              f"{step0:.3e} apart")
    total = sum(map(len, served))
    print(f"[qwen3 asr serve] {len(reqs)} requests, {ASR_SERVE_SLOTS} slots, {ASR_SECONDS:g} s "
          f"windows ({prompt}-row prompts): {total} tokens in {wall:.3f} s (encodes included): "
          f"{total / wall:.2f} tok/s aggregate; {lane_steps[0]} lane steps; launches "
          f"{launches} (decode kernel {(4 * L + 1) * lane_steps[0]} expected); plain calls "
          f"{plain}")
    check(launches.get("fused_log_mel") == len(reqs) and n_dec == (4 * L + 1) * lane_steps[0]
          and not launches.get("quantized_matvec_tile")
          and launches.get("quantized_matvec") == n_dec and plain == 0,
          "qwen3 asr serving launches or plain calls")
    check(all(len(s) == ASR_SERVE_TOKENS for s in served), "qwen3 asr serve: token counts")
    return dict(requests=len(reqs), seconds=list(ASR_SERVE_SECONDS), wall_s=wall,
                tokens=total, tok_s=total / wall, lane_steps=lane_steps[0], launches=launches,
                equal_to_solo=[s == t for s, t in zip(served, solo)], parted=parted)


class Qwen3AlignTokenizer(Qwen3AsrTokenizer):
    """``Qwen3AsrTokenizer`` with ``<timestamp>`` (151705) and the aligned
    clips' words as ids of their own, so that a word is one prompt row."""

    SPECIALS = {**Qwen3AsrTokenizer.SPECIALS, "<timestamp>": 151705}
    WORDS = {**Qwen3AsrTokenizer.WORDS,
             **{w: 30000 + i for i, w in enumerate(sorted(set(ALIGN_LONG[1] + ALIGN_SHORT[1])))}}


def build_qwen3_aligner(model):
    """``model``'s tree (no second copy) with a seed-0 timestamp head of
    ALIGN_CLASSES x hidden, N(0, 1/hidden), MLX 4-bit in groups of 64, as a
    ``Qwen3ForcedAligner`` with ``Qwen3AlignTokenizer``."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt.qwen3_aligner import Qwen3ForcedAligner

    h = model.config.text.hidden_size
    gen = torch.Generator(device=model.device).manual_seed(0)
    head = torch.randn((ALIGN_CLASSES, h), generator=gen, device=model.device).mul_(h ** -0.5)
    w = quant.QuantizedTensor(*quant.quantize_mlx(head.to(torch.bfloat16), 64, 4), 64, 4)
    cfg = dataclasses.replace(model.config, classify_num=ALIGN_CLASSES)
    return Qwen3ForcedAligner(cfg, {**model.params, "lm_head": {"weight": w}},
                              Qwen3AlignTokenizer(), model.dtype)


def align_logits(aligner, audio, text: str, pad: bool = True):
    """The aligner's prompt for ``audio`` and ``text`` through the steps of
    ``generate`` (``Qwen3ForcedAligner.prompt``, its rows padded to the
    64-row bucket or not, then ``qwen3_aligner._logits``): (f32 logits of the
    valid rows ``[n, classes]``, the timestamp positions)."""
    import numpy as np
    import torch

    from tpu_audio_torch.models.stt import qwen3_aligner as QA

    with torch.no_grad():
        _, ids, emb = aligner.prompt(audio, text, pad=pad)
        logits = QA._logits(aligner.params, emb, aligner.config.text)[0, :ids.shape[1]].float()
    return logits, np.where(ids[0] == aligner.config.timestamp_token_id)[0]


def classes_or_witness(label: str, got, want) -> list:
    """The argmax classes of two logits ``[n, C]`` equal, or parted only
    where ``want``'s two best lie within the two logits' largest
    difference on that row; the parted rows."""
    import torch

    a, b = got.argmax(-1), want.argmax(-1)
    parted = []
    for r in torch.nonzero(a != b).flatten().tolist():
        top = torch.topk(want[r], 2)
        gap = float(top.values[0] - top.values[1])
        diff = float((got[r] - want[r]).abs().max())
        ok = {int(a[r]), int(b[r])} == set(top.indices.tolist()) and gap <= diff
        print(f"[qwen3 align witness] {label}: row {r} parts ({int(a[r])} against {int(b[r])}): "
              f"the top two {gap:.4e} apart, the logits {diff:.4e} apart: "
              f"{'a near tie' if ok else 'NOT a near tie'}")
        check(ok, f"qwen3 align {label}: row {r}'s classes differ, not at a near tie")
        parted.append(dict(row=r, margin=gap, max_diff=diff))
    return parted


def align_card_vs_cpu(aligner, audio, text: str) -> dict:
    """The aligner cut to ASR_CARD_LAYERS audio and text layers in f32,
    card against CPU on the same weights (the head packed), the prompt
    padded to its 64-row bucket (the card's products on kernel 7's tile
    with f32 x): the valid rows' classifier logits within ALIGN_CARD_RTOL
    of the CPU's relative to their max, under the TF32 control; the
    classes equal or parted at a witnessed near tie."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.stt.qwen3_aligner import Qwen3ForcedAligner

    n = ASR_CARD_LAYERS
    cfg, params = asr_cut(aligner, n)

    def run(params):
        return align_logits(Qwen3ForcedAligner(cfg, params, aligner.tokenizer, torch.float32),
                            audio, text)[0].cpu()

    card = run(params)
    cpu = run(loading.to_device(params, "cpu"))
    with plain_kernels(), tf32_everywhere():
        control = run(params)
    out = dict(rows=card.shape[0], rel_err=rel_err(card, cpu), tf32_control=rel_err(control, cpu),
               parted=classes_or_witness("card against CPU", card, cpu))
    print(f"[qwen3 align card vs CPU] {n} audio and {n} text layers in f32, "
          f"{len(audio) / 16000:g} s, {card.shape[0]} valid rows of a 64-row bucket: logits "
          f"{out['rel_err']:.3e} (TF32 control {out['tf32_control']:.3e}, limit "
          f"{ALIGN_CARD_RTOL}); classes parted at {len(out['parted'])} rows")
    check(bool(torch.isfinite(card).all()) and out["rel_err"] <= ALIGN_CARD_RTOL
          < out["tf32_control"], f"qwen3 align card against CPU {out}: not within "
          f"{ALIGN_CARD_RTOL}, or the TF32 control within it")
    return out


def qwen3_align(model, smi: str) -> dict:
    """``[qwen3 align]`` on ``model``'s tree (``build_qwen3_aligner``):
    kernel 1 at the 2 s clip's shape and kernel 7's tile at the 64-row
    bucket (bf16 x, as ``generate`` casts the prompt) against their plain
    versions; ``generate`` on ALIGN_LONG (its prompt past 64 rows: kernel 1
    once, no kernel 7) and ALIGN_SHORT (kernel 1 once, the tile 4 x L + 1
    times, no decode kernel), the counters reset just before and read just
    after, no plain call, the items in order; the short prompt's classes
    unpadded against padded; card against CPU (``align_card_vs_cpu``)."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.ops import mel as M

    aligner = build_qwen3_aligner(model)
    L = aligner.config.text.num_hidden_layers
    dev = aligner.device
    short = asr_signal(ALIGN_SHORT[0], 6)
    spec = dsp.stft(torch.from_numpy(short).to(dev), dsp.hanning_window(400), 400, 160)
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(16000, 400, 128, norm="slaney",
                                          mel_scale="htk")).to(dev)
    got, want, err = mel_check(f"qwen3 align mel, {ALIGN_SHORT[0]:g} s",
                               lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    b_ms, b_by = mel_bound(re, im, fb, got)
    k1 = dict(shape=[re.shape[0], re.shape[1], fb.shape[1]], max_abs_err=err, bound_ms=b_ms,
              bound_by=b_by, ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    p = aligner.params["model"]
    gen = torch.Generator(device=dev).manual_seed(17)
    k7 = []
    for name, w in [(n, p["layers"][a][n]["weight"].map(lambda t: t[0]))
                    for a, names in (("self_attn", ("qkv_proj", "o_proj")),
                                     ("mlp", ("gate_up_proj", "down_proj"))) for n in names] + [
            ("timestamp head", aligner.params["lm_head"]["weight"])]:
        x = torch.randn((64, w.weight.shape[-1] * 32 // w.bits), generator=gen,
                        device=dev).to(torch.bfloat16)
        e, _, ran = qmm_check(f"qwen3 align {name} [64]", x, w.weight, w.scales, w.biases,
                              w.group_size, w.bits)
        check(ran == "tile", f"qwen3 align {name} at 64 rows ran the {ran}, not the tile")
        k7.append(dict(shape=name, rows=64, o=w.weight.shape[0], i=x.shape[1], rel_err=e))
    print(f"[qwen3 align kernels] kernel 1 at {k1['shape']}: max abs err {err:.3e}, per call "
          f"kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, bound {b_ms:.6f} ms "
          f"({b_by}); kernel 7's tile at the 64-row bucket with bf16 x on {len(k7)} shapes, rel "
          f"err up to {max(c['rel_err'] for c in k7):.3e} (rtol {QMM_BF16_RTOL}) ({smi})")
    runs = {}
    for label, (seconds, words) in (("long", ALIGN_LONG), ("short", ALIGN_SHORT)):
        audio = short if label == "short" else asr_signal(seconds, 5)
        text = " ".join(words)
        aligner.generate(audio, text=text)  # warm
        res, wall, launches, _, plain, _ = asr_counted(
            aligner, lambda: aligner.generate(audio, text=text))
        seq = [t for i in res.items for t in (i.start_time, i.end_time)]
        n_tile = launches.get("quantized_matvec_tile", 0)
        print(f"[qwen3 align {label}] {seconds:g} s, {len(words)} words: a {res.prompt_tokens}-row "
              f"prompt in {wall * 1e3:.1f} ms (host clock, encode and classify); launches "
              f"{launches} (tile {4 * L + 1 if res.prompt_tokens <= 64 else 0} expected); plain "
              f"calls {plain}; items {[(i.text, i.start_time, i.end_time) for i in res.items]}")
        check(launches.get("fused_log_mel") == 1 and plain == 0
              and not launches.get("quantized_matvec_decode")
              and launches.get("quantized_matvec", 0) == n_tile
              and n_tile == (4 * L + 1 if res.prompt_tokens <= 64 else 0),
              f"qwen3 align {label}: kernel 1 or 7's launches, or a plain call")
        check((res.prompt_tokens <= 64) == (label == "short"),
              f"qwen3 align {label}: a {res.prompt_tokens}-row prompt")
        check([i.text for i in res.items] == list(words) and seq == sorted(seq),
              f"qwen3 align {label}: the items are not the words in order")
        runs[label] = dict(seconds=seconds, words=len(words), prompt_rows=res.prompt_tokens,
                           host_ms=wall * 1e3, launches=launches)
    text = " ".join(ALIGN_SHORT[1])
    padded, ts = align_logits(aligner, short, text)
    unpadded, _ = align_logits(aligner, short, text, pad=False)
    parted = classes_or_witness("unpadded against padded", unpadded, padded)
    print(f"[qwen3 align bucket] {padded.shape[0]} valid rows unpadded against the 64-row "
          f"bucket: classes parted at {len(parted)} rows ({len(ts)} timestamp rows)")
    card = align_card_vs_cpu(aligner, short, text)
    return dict(runs=runs, kernel1=k1, kernel7=k7, bucket_parted=parted, card_vs_cpu=card,
                classes=ALIGN_CLASSES)


def qwen3_asr_phase(dev, smi: str) -> tuple[dict, dict]:
    """``[qwen3 asr]``: Qwen3-ASR (``build_qwen3_asr``) on the MLX 4-bit
    tree. Kernels 1 and 7 against their plain versions at the path's shapes
    (``asr_kernel_checks``); greedy ``generate`` on ASR_SECONDS of the
    speech clip twice with its launches, time to first token and RTF
    (``asr_generate_runs``); a decode chunk's host and device ms a token,
    events and kernel 7's share against its bound (``asr_decode_profile``);
    4 + 4 layers in f32 card against CPU (``asr_card_vs_cpu``); the
    streaming session over ASR_STREAM_SECONDS (``asr_stream``);
    ``ContinuousQwen3ASR`` against solo (``asr_serve``); the peak device
    memory; ``[qwen3 align]`` (``qwen3_align``) on the same tree between
    the card-against-CPU check and the session. Returns the record and
    kernels 1 and 7's fields."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, packed = build_qwen3_asr(dev)
    torch.cuda.synchronize()
    tower = sum(p.startswith("audio_tower") for p in packed)
    print(f"[qwen3 asr] audio tower {model.config.audio.encoder_layers} x "
          f"{model.config.audio.d_model} ({model.config.audio.encoder_attention_heads} heads, "
          f"ffn {model.config.audio.encoder_ffn_dim}), text decoder "
          f"{model.config.text.num_hidden_layers} x {model.config.text.hidden_size} "
          f"(vocabulary {model.config.text.vocab_size}) MLX 4-bit (g 64) built on the card in "
          f"{time.perf_counter() - t0:.1f} s: {len(packed)} packed leaves ({tower} in the "
          f"audio tower; the convolutions, conv_out, norms and biases dense) ({smi})")
    audio = asr_signal(ASR_SECONDS, 0)
    out = dict(packed_leaves=len(packed), packed_in_tower=tower)
    parts = {"build": time.perf_counter() - t_phase}
    checks = asr_kernel_checks(model, audio, smi)
    parts["kernels"] = time.perf_counter() - t_phase
    out["runs"], gen = asr_generate_runs(model, audio)
    out["ttft_ms"] = gen["ttft_ms"]
    out["rtf"] = min(r["rtf"] for r in out["runs"])
    parts["generate"] = time.perf_counter() - t_phase
    out["decode"] = asr_decode_profile(model, audio, smi)
    parts["decode profile"] = time.perf_counter() - t_phase
    out["card_vs_cpu"] = asr_card_vs_cpu(model, asr_signal(ASR_CARD_SECONDS, 1),
                                         gen["first_tokens"])
    parts["card vs CPU"] = time.perf_counter() - t_phase
    out["align"] = qwen3_align(model, smi)
    parts["align"] = time.perf_counter() - t_phase
    out["stream"] = asr_stream(model, asr_signal(ASR_STREAM_SECONDS, 2))
    parts["stream"] = time.perf_counter() - t_phase
    out["serve"] = asr_serve(model)
    out["peak_gb"] = peak_gb()
    out["seconds"] = parts["serve"] = time.perf_counter() - t_phase
    print(f"[qwen3 asr] peak device memory {out['peak_gb']:.2f} GB; the phase "
          f"{out['seconds']:.1f} s (seconds from its start at the end of each part: "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}) ({smi})")
    L = model.config.text.num_hidden_layers
    k7 = dict(qwen3_asr_launches=gen["launches"], qwen3_asr=dict(
        decode_per_step=gen["launches"].get("quantized_matvec_decode", 0)
        / out["runs"][0]["steps"],
        device_ms_per_token=out["decode"]["device_ms_per_token"],
        kernel7_device_ms_per_token=out["decode"]["kernel7_device_ms_per_token"],
        bound_ms=out["decode"]["bound_ms"], bound_by=out["decode"]["bound_by"],
        products=out["decode"]["products"], checks=checks["k7"]))
    align = out["align"]
    tile = dict(qwen3_asr_launches=out["stream"]["launches"].get("quantized_matvec_tile", 0),
                qwen3_asr=dict(tile_passes=out["stream"]["tile_passes"],
                               per_pass=4 * L + 1),
                qwen3_align_launches={k: r["launches"].get("quantized_matvec_tile", 0)
                                      for k, r in align["runs"].items()},
                qwen3_align=dict(checks=align["kernel7"], rows=64))
    k1 = dict(qwen3_asr_launches=gen["launches"].get("fused_log_mel", 0),
              qwen3_asr=dict(checks["k1"], stream_launches=out["stream"]["launches"].get(
                  "fused_log_mel", 0)),
              qwen3_align_launches={k: r["launches"].get("fused_log_mel", 0)
                                    for k, r in align["runs"].items()},
              qwen3_align=align["kernel1"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, dict(quantized_matvec=k7, quantized_matvec_tile=tile, fused_log_mel=k1)


def qwen3_asr_main(smi: str) -> int:
    """``--qwen3-asr``: the [qwen3 asr] phase alone, then its JSON and
    kernels 1 and 7's Qwen3-ASR fields as one line (no "ok" line: not the
    full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k = qwen3_asr_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"qwen3_asr": out, "kernels": k}, default=str))
    return 0


class CohereStubPieces:
    """The SentencePiece stand-in of the stub Cohere tokenizer: an id
    decodes as ``w<id>``."""

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


def cohere_tokenizer():
    """A ``CohereTokenizer`` over COHERE_SPECIALS and ``CohereStubPieces``
    (no tokenizer.model is in the repository)."""
    from tpu_audio_torch.models.stt.cohere import CohereTokenizer

    tok = CohereTokenizer.__new__(CohereTokenizer)
    tok.sp = CohereStubPieces()
    tok.special = dict(COHERE_SPECIALS)
    tok.special_ids = set(tok.special.values())
    return tok


def build_cohere(dev):
    """Cohere Transcribe at ``CohereConfig()``'s widths from seed-0 random
    weights on the card (``cohere.init_random_params``, bf16), and the same
    tree quantized on the card to MLX 4-bit in groups of 64 by
    ``quant.quantize_tree``'s predicate: (bf16 model, 4-bit model, the
    packed leaves' paths)."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models.stt import cohere as CO

    cfg = CO.CohereConfig()
    params = CO.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    q4 = quant.quantize_tree(params, bits=4, group_size=64, scheme="mlx")

    def packed(tree, path=""):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in packed(v, f"{path}.{k}" if path else k)]
        return [path] if isinstance(tree, quant.QuantizedTensor) else []

    paths = packed(q4)
    dec = q4["decoder"]
    check(isinstance(dec["core"]["layers"]["0"]["first_sub_layer"]["q_proj"]["weight"],
                     quant.QuantizedTensor)
          and isinstance(dec["embedding"]["token_embedding"]["weight"], quant.QuantizedTensor)
          and isinstance(q4["lm_head"]["weight"], quant.QuantizedTensor)
          and not isinstance(q4["encoder"]["layers"]["0"]["conv"]["pointwise_conv1"]["weight"],
                             quant.QuantizedTensor),
          "Cohere 4-bit: the products, the embedding or the head not packed as the predicate says")
    tok = cohere_tokenizer()
    return (CO.CohereTranscribe(cfg, params, tok, torch.bfloat16),
            CO.CohereTranscribe(cfg, q4, tok, torch.bfloat16), paths)


def cohere_counted(model, fn):
    """``fn()`` with the counters reset just before and read just after:
    (result, wall s, launches, one-token decoder passes, plain calls of
    kernels 1 and 7, and each ``streaming_decode_token_ids`` call's (audio
    seconds, tile launches))."""
    import torch

    from tpu_audio_torch.models.stt import cohere as CO
    from tpu_audio_torch.ops import _lib, mel, qmm

    steps, plain, calls = [0], [0], []
    passes = CO._decoder_pass
    decode = model.streaming_decode_token_ids

    def step_spy(params, tokens, *a, **k):
        steps[0] += tokens.shape[1] == 1
        return passes(params, tokens, *a, **k)

    def call_spy(audio, *a, **k):
        tile = _lib.launches["quantized_matvec_tile"]
        out = decode(audio, *a, **k)
        calls.append((len(audio) / 16000, _lib.launches["quantized_matvec_tile"] - tile))
        return out

    CO._decoder_pass = step_spy
    model.streaming_decode_token_ids = call_spy
    try:
        with counting(qmm, "quantized_matvec_ref", plain), counting(mel, "fused_log_mel_ref",
                                                                    plain):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.launches)
    finally:
        CO._decoder_pass = passes
        del model.streaming_decode_token_ids
    return out, wall, launches, steps[0], plain[0], calls


def cohere_short_tiles(cfg) -> int:
    """Kernel 7's tile launches besides the prefill's on a chunk of 50
    encoder rows (one 400-frame bucket): the subsampling's output, each
    conformer layer's 8 products but the position projection (2 x 50 - 1
    rows: dequantized), and each decoder layer's cross K and V."""
    return 1 + 8 * cfg.encoder.n_layers + 2 * cfg.decoder.num_layers


def cohere_step_products(model) -> list:
    """The packed products of one decode step: each layer's self q/k/v/out,
    cross q/out and feed-forward pair, and the head."""
    layers = model.params["decoder"]["core"]["layers"]
    out = []
    for i in range(model.config.decoder.num_layers):
        lp = layers[str(i)]
        out += [lp["first_sub_layer"][n]["weight"] for n in ("q_proj", "k_proj", "v_proj",
                                                              "out_proj")]
        out += [lp["second_sub_layer"][n]["weight"] for n in ("q_proj", "out_proj")]
        out += [lp["third_sub_layer"][n]["weight"] for n in ("dense_in", "dense_out")]
    return out + [model.params["lm_head"]["weight"]]


def cohere_kernel_checks(q4) -> list:
    """Kernel 7 against its plain version at each packed product's shape of
    decoder layer 0 and the head: the decode kernel at 1 row and the tile at
    the prompt's 9 rows (f32 x: the packed embedding's residual stream);
    and the tile at a short chunk's 50 encoder rows (bf16 x) at each shape
    the encoder gives it there: the cross K and V (1,024 -> 1,024), encoder
    layer 0's feed-forward pair (1,024 -> 4,096 -> 1,024) and the
    subsampling's output (4,096 -> 1,024)."""
    import torch

    dev = q4.device
    lp = q4.params["decoder"]["core"]["layers"]["0"]
    shapes = [(f"{sub} {n}", lp[sub][n]["weight"]) for sub, names in (
        ("first_sub_layer", ("q_proj", "out_proj")), ("second_sub_layer", ("q_proj",)),
        ("third_sub_layer", ("dense_in", "dense_out"))) for n in names]
    shapes.append(("head", q4.params["lm_head"]["weight"]))
    rows = len(q4.tokenizer.build_prompt())
    gen = torch.Generator(device=dev).manual_seed(19)
    out = []
    cases = [(name, w, r, torch.float32, k) for name, w in shapes
             for r, k in ((1, "decode"), (rows, "tile"))]
    enc = q4.params["encoder"]
    ff1 = enc["layers"]["0"]["feed_forward1"]
    cases += [(name, w, 50, torch.bfloat16, "tile") for name, w in (
        ("second_sub_layer k_proj", lp["second_sub_layer"]["k_proj"]["weight"]),
        ("encoder feed_forward1 linear1", ff1["linear1"]["weight"]),
        ("encoder feed_forward1 linear2", ff1["linear2"]["weight"]),
        ("subsampling out", enc["subsampling"]["out"]["weight"]))]
    for name, w, r, dt, kernel in cases:
        x = torch.randn((r, w.weight.shape[-1] * 32 // w.bits), generator=gen,
                        device=dev).to(dt)
        e, _, ran = qmm_check(f"cohere {name} [{r}]", x, w.weight, w.scales, w.biases,
                              w.group_size, w.bits)
        check(ran == kernel, f"cohere {name} at {r} rows ran the {ran}, not the {kernel}")
        out.append(dict(shape=name, rows=r, x=str(dt).split(".")[-1], kernel=ran,
                        o=w.weight.shape[0], i=x.shape[1], rel_err=e))
    print(f"[cohere qmm] kernel 7 at the decoder's {len(shapes)} product shapes (4-bit, g 64): "
          f"the decode kernel at 1 row and the tile at {rows} rows with f32 x, rel err up to "
          f"{max(c['rel_err'] for c in out if c['x'] == 'float32'):.3e} (rtol {QMM_RTOL}); the "
          f"tile at 50 rows with bf16 x on the cross K/V's, the encoder's feed-forward and the "
          f"subsampling's shapes {[round(c['rel_err'], 6) for c in out if c['rows'] == 50]} "
          f"(rtol {QMM_BF16_RTOL})")
    return out


def cohere_generate_runs(model, audio, label: str, packed: bool) -> list:
    """Greedy ``generate`` of COHERE_TOKENS on ``audio`` twice, the counters
    reset just before and read just after each: on the bf16 tree no kernel
    of the port; on the 4-bit tree kernel 7's tile 8 x L + 1 times for the
    prompt's prefill (the cross K/V of 400 encoder rows dequantize), its
    decode kernel 8 x L + 1 times a decode step, no GEMV, no plain call; the
    tokens repeat."""
    from tpu_audio_torch.core.generation import STTGenerateParameters

    per = 8 * model.config.decoder.num_layers + 1
    seconds = len(audio) / 16000
    runs, first = [], None
    for run in range(2):
        out, wall, launches, steps, plain, _ = cohere_counted(
            model, lambda: model.generate(audio, STTGenerateParameters(max_tokens=COHERE_TOKENS)))
        n_dec = launches.get("quantized_matvec_decode", 0)
        n_tile = launches.get("quantized_matvec_tile", 0)
        print(f"[cohere {label} generate run {run}] {seconds:g} s: {out.generation_token_count} "
              f"tokens in {wall:.3f} s ({steps} decode steps); RTF {wall / seconds:.4f}; "
              f"launches {launches}" + (f": decode kernel {n_dec} ({per * steps} expected, "
                                        f"{n_dec / max(steps, 1):.1f} a token), tile {n_tile} "
                                        f"({per} expected)" if packed else "")
              + f"; plain calls {plain}; text {out.text[:60]!r}")
        if packed:
            check(n_dec == per * steps and n_tile == per
                  and launches.get("quantized_matvec") == n_dec + n_tile and plain == 0
                  and set(launches) <= {"quantized_matvec", "quantized_matvec_tile",
                                        "quantized_matvec_decode"},
                  f"cohere {label}: kernel 7's launches, another kernel or a plain call")
        else:
            check(not any(launches.values()) and plain == 0,
                  f"cohere {label}: a kernel of the port ran on the bf16 tree: {launches}")
        check(steps == COHERE_TOKENS and 0 < out.generation_token_count <= COHERE_TOKENS,
              f"cohere {label}: {steps} steps, {out.generation_token_count} tokens")
        if first is None:
            first = out.text
        check(out.text == first, f"cohere {label} run {run}: the text differs from run 0's")
        runs.append(dict(run=run, tokens=out.generation_token_count, steps=steps, wall_s=wall,
                         rtf=wall / seconds, launches=launches))
    return runs


def cohere_decode_profile(q4, audio, smi: str) -> dict:
    """A greedy decode of COHERE_PROFILE_TOKENS tokens after the 4-bit
    model's prefill of ``audio``'s chunk: ms a token on the host clock (best
    of 3), then under the profiler the device busy ms, events and kernel
    7's share a token against the bound of one step's packed products (each
    word, scale and bias read once, f32 x in and y out); the encoder's ms a
    call on the chunk (CUDA events) and its device ms (one marked profiler
    window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = COHERE_PROFILE_TOKENS
    with torch.no_grad():
        enc, enc_len = q4._encode_audio(audio)
        prompt = q4.tokenizer.build_prompt()

        def state():
            return q4._prefill(prompt, enc, enc_len, len(prompt) + n + 1)

        walls = []
        for _ in range(3):
            s = state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q4._decode(*s, n)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        s = state()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            q4._decode(*s, n)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = by_kernel(prof)
    busy_ms = sum(c[1] for c in kernels.values()) / 1e3
    events = sum(c[0] for c in kernels.values())
    k7 = [c for name, c in kernels.items() if "quantized_matvec" in name]
    k7_ms, k7_n = sum(c[1] for c in k7) / 1e3, sum(c[0] for c in k7)
    products = cohere_step_products(q4)
    nb = sum(nbytes(w.weight, w.scales, w.biases) + 4 * (w.weight.shape[1] * 32 // w.bits
                                                          + w.weight.shape[0])
             for w in products)
    ops = sum(2 * w.weight.shape[0] * w.weight.shape[1] * 32 // w.bits for w in products)
    b_ms, b_by = bound(nb, f32_ops=ops)
    enc_ms = cuda_ms(lambda: q4._encode_audio(audio), reps=3, warmup=1)
    enc_us, enc_events = marked_window(lambda: q4._encode_audio(audio), "cohere encoder")
    enc_dev = None if enc_us is None else enc_us / 1e3
    out = dict(ms_per_token=min(walls) * 1e3 / n, device_ms_per_token=busy_ms / n,
               kernel7_device_ms_per_token=k7_ms / n, kernel7_launches_per_token=k7_n / n,
               busy_share=busy_ms / prof_ms, device_events_per_token=events / n, bound_ms=b_ms,
               bound_by=b_by, products=len(products), encoder_device_ms=enc_dev,
               encoder_events=enc_events, encoder_ms=enc_ms, encoder_rows=enc.shape[1])
    print(f"[cohere decode] {n}-token decode after the {len(prompt)}-row prefill on "
          f"{len(audio) / 16000:g} s: {out['ms_per_token']:.4f} ms a token (best of 3, host "
          f"clock); under the profiler wall {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms (share "
          f"{out['busy_share']:.4f}), {busy_ms / n:.4f} device ms a token of which kernel 7 "
          f"{k7_ms / n:.4f} ({k7_n / n:.1f} launches a token) against the bound of its "
          f"{len(products)} products {b_ms:.4f} ms ({b_by}); {events / n:.1f} device events a "
          f"token; the encoder on {enc.shape[1]} rows {fmt(enc_dev)} device ({enc_events} "
          f"events), {enc_ms:.3f} ms a call (CUDA events) ({smi})")
    print_kernels(kernels, n, top=8)
    return out


def cohere_card_vs_cpu(model, audio) -> dict:
    """The 4-bit model cut to COHERE_CARD_ENC_LAYERS encoder and
    COHERE_CARD_DEC_LAYERS decoder layers in f32 (the products stay
    packed), card against CPU on the same weights and ``audio``: the
    features, the encoder output and COHERE_CARD_TOKENS step logits along
    the CPU's greedy tokens (kernel 7 on the card, its plain version on the
    CPU), each within its limit (COHERE_FEATURES_RTOL for the features,
    COHERE_CARD_RTOL else) of the CPU's relative to its max, each under its
    TF32 control; the greedy tokens equal, or parted where
    the CPU's two best logits lie within the two logits' difference."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.stt import cohere as CO

    ne, nd, steps = COHERE_CARD_ENC_LAYERS, COHERE_CARD_DEC_LAYERS, COHERE_CARD_TOKENS
    cfg = dataclasses.replace(
        model.config, encoder=dataclasses.replace(model.config.encoder, n_layers=ne),
        decoder=dataclasses.replace(model.config.decoder, num_layers=nd))
    p = model.params
    params = loading.cast_floats({
        "encoder": {"subsampling": p["encoder"]["subsampling"],
                    "layers": {str(i): p["encoder"]["layers"][str(i)] for i in range(ne)}},
        "decoder": {"embedding": p["decoder"]["embedding"], "core": {
            "layers": {str(i): p["decoder"]["core"]["layers"][str(i)] for i in range(nd)},
            "final_layer_norm": p["decoder"]["core"]["final_layer_norm"]}},
        "lm_head": p["lm_head"]}, torch.float32)

    def run(params, row=None):
        m = CO.CohereTranscribe(cfg, params, model.tokenizer, torch.float32)
        with torch.no_grad():
            feats = CO.cohere_features(torch.from_numpy(audio).to(m.device), 16000,
                                       cfg.encoder.feat_in)
            enc, n = m._encode_audio(audio)
            prompt = m.tokenizer.build_prompt()
            greedy = m._decode(*m._prefill(prompt, enc, n, len(prompt) + steps + 1), steps)[0]
            logits, cache, ck, cv, mask = m._prefill(prompt, enc, n, len(prompt) + steps + 1)
            out = [logits[0]]
            for t in (greedy if row is None else row)[:steps - 1]:
                lg, cache = CO._decoder_pass(m.params, torch.tensor([[t]], device=m.device),
                                             m._table, cache, ck, cv, mask, cfg)
                out.append(lg[0, -1])
        return dict(features=feats.cpu(), encoder=enc[0].cpu(),
                    logits=torch.stack(out).float().cpu()), greedy

    cpu, cpu_greedy = run(loading.to_device(params, "cpu"))
    card, card_greedy = run(params, cpu_greedy)
    with plain_kernels(), tf32_everywhere():
        control, _ = run(params, cpu_greedy)
    out = {k: dict(rel_err=rel_err(card[k], cpu[k]), tf32_control=rel_err(control[k], cpu[k]),
                   limit=COHERE_FEATURES_RTOL if k == "features" else COHERE_CARD_RTOL)
           for k in card}
    parted = None
    if card_greedy != cpu_greedy:
        s = next(i for i in range(steps) if card_greedy[i] != cpu_greedy[i])
        top = torch.topk(cpu["logits"][s], 2)
        gap = float(top.values[0] - top.values[1])
        diff = float((card["logits"][s] - cpu["logits"][s]).abs().max())
        parted = dict(token=s, margin=gap, max_diff=diff)
        check({card_greedy[s], cpu_greedy[s]} == set(top.indices.tolist()) and gap <= diff,
              f"cohere card against CPU: greedy tokens part at {s}, not at a near tie {parted}")
    out["greedy"] = dict(equal=card_greedy == cpu_greedy, tokens=len(cpu_greedy), parted=parted)
    print(f"[cohere card vs CPU] {ne} encoder and {nd} decoder layers in f32 (4-bit products), "
          f"{len(audio) / 16000:g} s ({card['encoder'].shape[0]} encoder rows), {steps} steps: "
          + "; ".join(f"{k} {out[k]['rel_err']:.3e} (TF32 control {out[k]['tf32_control']:.3e}, "
                      f"limit {out[k]['limit']})" for k in card)
          + f"; greedy tokens equal: {card_greedy == cpu_greedy}")
    for k in card:
        check(bool(torch.isfinite(card[k]).all()) and card[k].shape == cpu[k].shape
              and out[k]["rel_err"] <= out[k]["limit"] < out[k]["tf32_control"],
              f"cohere {k} card against CPU {out[k]}: not within its limit, or the TF32 "
              f"control within it")
    return out


def cohere_stream(q4, audio) -> dict:
    """``StreamingInferenceSession`` (the Cohere core) over ``audio`` at 1 s
    feeds, COHERE_STREAM_TOKENS tokens a pass, on a clock that moves 1 s a
    feed; the counters reset just before and read just after: kernel 7's
    decode kernel 8 x L + 1 times a decode step, its tile 8 x L + 1 times a
    pass's prefill and ``cohere_short_tiles`` more where the pass's audio
    fits one 400-frame bucket (the encoder and cross K/V on 50 rows), no
    plain call. The event kinds are
    the session's, a window and the rest are finalized, and the ended text
    is the completed text."""
    from tpu_audio_torch.models.stt.streaming import (EventKind, StreamingConfig,
                                                      StreamingInferenceSession, concat_text)

    L = q4.config.decoder.num_layers
    clock = StepClock()
    session = StreamingInferenceSession(
        q4, config=StreamingConfig(max_tokens_per_pass=COHERE_STREAM_TOKENS), clock=clock)

    def feed_all():
        events = []
        for s in range(0, len(audio), 16000):
            events += session.feed_audio(audio[s:s + 16000])
            clock.advance(1.0)
        return events + session.stop()

    events, wall, launches, steps, plain, calls = cohere_counted(q4, feed_all)
    core = session.core
    kinds = [e.kind.value for e in events]
    stats = [e.stats for e in events if e.kind == EventKind.STATS][-1]
    n_dec = launches.get("quantized_matvec_decode", 0)
    seconds = len(audio) / 16000
    print(f"[cohere stream] {seconds:g} s at 1 s feeds: {stats['decode_passes']} passes "
          f"({steps} decode steps) in {wall:.3f} s: session RTF {wall / seconds:.4f}, "
          f"{stats['decode_time'] * 1e3 / max(1, len(calls)):.1f} ms a pass; "
          f"{core._finalized_windows} windows finalized; pass audio s and tiles "
          f"{[(round(a, 2), t) for a, t in calls]}; launches {launches} (decode kernel "
          f"{(8 * L + 1) * steps} expected); plain calls {plain}; events "
          f"{' '.join(k[:4] for k in kinds)}; ended {events[-1].text[:60]!r}")
    check(type(core).__name__ == "_CohereStreamingCore" and kinds[-1] == "ended"
          and "display_update" in kinds and "stats" in kinds
          and set(kinds) <= {k.value for k in EventKind}, f"cohere stream: event kinds {kinds}")
    check(events[-1].text == events[-1].confirmed_text
          == concat_text(core.state.completed_text, core.state.confirmed_text)
          and core._finalized_windows >= 2 and core.state.completed_text,
          "cohere stream: windows not finalized, or the ended text is not the session's")
    # a pass's audio under 4 s is 400 mel frames or fewer: 50 encoder rows
    extra = cohere_short_tiles(q4.config)
    check(n_dec == (8 * L + 1) * steps and plain == 0
          and all(t == 8 * L + 1 + (extra if a < 4.0 else 0) for a, t in calls)
          and launches.get("quantized_matvec") == n_dec + sum(t for _, t in calls),
          "cohere stream: kernel 7's launches or a plain call")
    return dict(seconds=seconds, wall_s=wall, rtf=wall / seconds, passes=stats["decode_passes"],
                steps=steps, windows=core._finalized_windows,
                ms_per_pass=stats["decode_time"] * 1e3 / max(1, len(calls)), kinds=kinds,
                launches=launches)


def cohere_http(q4) -> dict:
    """One ``/v1/audio/transcriptions`` POST of COHERE_HTTP_SECONDS to the
    server on 127.0.0.1 (``--slots 2``: no engine for Cohere, the locked
    ``generate`` with its default budget, which max_sequence_length sets:
    the served model is the 4-bit tree with COHERE_HTTP_POSITIONS
    positions, so that random weights, which emit no eos, stop at 54
    tokens)."""
    import json as _json

    from tpu_audio_torch.cli.serve import build_server
    from tpu_audio_torch.models.stt.cohere import CohereTranscribe

    cfg = dataclasses.replace(q4.config, decoder=dataclasses.replace(
        q4.config.decoder, max_sequence_length=COHERE_HTTP_POSITIONS))
    served = CohereTranscribe(cfg, q4.params, q4.tokenizer, q4.dtype)
    server = build_server(served, "stt", "cohere-random", port=0, slots=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        check(server.stt_worker is None, "cohere serve: an engine was built")
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/audio/transcriptions",
            data=wav_body(asr_signal(COHERE_HTTP_SECONDS, 8)),
            headers={"Content-Type": "audio/wav"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body, code = _json.loads(r.read()), r.status
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    words = len(body.get("text", "").split())
    print(f"[cohere http] one {COHERE_HTTP_SECONDS:g} s POST: HTTP {code} in {wall:.3f} s, "
          f"{words} words, {len(body.get('segments', []))} segment(s)")
    check(code == 200 and 0 < words <= COHERE_HTTP_POSITIONS - 10
          and len(body["segments"]) == 1,
          f"cohere http: {code} {str(body)[:120]}")
    return dict(code=code, wall_s=wall, words=words)


def cohere_phase(dev, smi: str) -> tuple[dict, dict]:
    """``[cohere]``: Cohere Transcribe (``build_cohere``) in bf16 and MLX
    4-bit. Kernel 7 at the decoder's product shapes (``cohere_kernel_checks``);
    greedy ``generate`` on COHERE_SECONDS twice on each tree and once on a
    COHERE_SHORT_SECONDS chunk of the 4-bit tree, with their launches
    (``cohere_generate_runs``); a decode token's host and device ms, events
    and kernel 7's share against its bound, and the encoder's device ms
    (``cohere_decode_profile``); 4 + 2 layers in f32 card against CPU
    (``cohere_card_vs_cpu``); the streaming session (``cohere_stream``); one
    request through the server (``cohere_http``); the peak device memory.
    Returns the record and kernel 7's fields."""
    import torch

    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models import llama

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bf16, q4, packed = build_cohere(dev)
    torch.cuda.synchronize()
    e, d = q4.config.encoder, q4.config.decoder
    n_params = sum(t.numel() for t in llama._leaves(bf16.params))
    print(f"[cohere] encoder {e.n_layers} x {e.d_model} ({e.n_heads} heads, ffn "
          f"{e.d_model * e.ff_expansion_factor}, conv kernel {e.conv_kernel_size}, "
          f"{e.subsampling_conv_channels} subsampling channels), decoder {d.num_layers} x "
          f"{d.hidden_size} (inner {d.inner_size}), vocabulary {q4.config.vocab_size}: "
          f"{n_params / 1e9:.3f} B parameters, bf16 and MLX 4-bit (g 64, {len(packed)} packed "
          f"leaves) built on the card in {time.perf_counter() - t_phase:.1f} s ({smi})")
    out = dict(params=n_params, packed_leaves=len(packed))
    parts = {"build": time.perf_counter() - t_phase}
    checks = cohere_kernel_checks(q4)
    parts["kernels"] = time.perf_counter() - t_phase
    audio = asr_signal(COHERE_SECONDS, 3)
    out["bf16_runs"] = cohere_generate_runs(bf16, audio, "bf16", packed=False)
    out["q4_runs"] = cohere_generate_runs(q4, audio, "4-bit", packed=True)
    short, wall, launches, steps, plain, _ = cohere_counted(q4, lambda: q4.generate(
        asr_signal(COHERE_SHORT_SECONDS, 4), STTGenerateParameters(max_tokens=COHERE_TOKENS)))
    L = d.num_layers
    extra = cohere_short_tiles(q4.config)
    print(f"[cohere 4-bit short] {COHERE_SHORT_SECONDS:g} s: {short.generation_token_count} "
          f"tokens in {wall:.3f} s; launches {launches} (tile {8 * L + 1 + extra} expected: the "
          f"prefill's {8 * L + 1}, and on the 50 encoder rows the encoder's {extra - 2 * L} and "
          f"the cross K/V's {2 * L}); plain calls {plain}")
    check(launches.get("quantized_matvec_tile") == 8 * L + 1 + extra and plain == 0
          and launches.get("quantized_matvec_decode") == (8 * L + 1) * steps,
          "cohere 4-bit short chunk: kernel 7's launches or a plain call")
    out["short"] = dict(seconds=COHERE_SHORT_SECONDS, wall_s=wall, launches=launches)
    parts["generate"] = time.perf_counter() - t_phase
    out["decode"] = cohere_decode_profile(q4, audio, smi)
    parts["decode profile"] = time.perf_counter() - t_phase
    out["card_vs_cpu"] = cohere_card_vs_cpu(q4, asr_signal(COHERE_CARD_SECONDS, 1))
    parts["card vs CPU"] = time.perf_counter() - t_phase
    out["stream"] = cohere_stream(q4, asr_signal(COHERE_STREAM_SECONDS, 2))
    parts["stream"] = time.perf_counter() - t_phase
    out["http"] = cohere_http(q4)
    out["peak_gb"] = peak_gb()
    out["seconds"] = parts["http"] = time.perf_counter() - t_phase
    print(f"[cohere] peak device memory {out['peak_gb']:.2f} GB; the phase {out['seconds']:.1f} s "
          f"(seconds from its start at the end of each part: "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}) ({smi})")
    first = out["q4_runs"][0]
    k7 = dict(cohere_launches=first["launches"].get("quantized_matvec_decode", 0), cohere=dict(
        decode_per_step=first["launches"].get("quantized_matvec_decode", 0) / first["steps"],
        device_ms_per_token=out["decode"]["device_ms_per_token"],
        kernel7_device_ms_per_token=out["decode"]["kernel7_device_ms_per_token"],
        bound_ms=out["decode"]["bound_ms"], bound_by=out["decode"]["bound_by"],
        products=out["decode"]["products"], checks=[c for c in checks if c["rows"] == 1]))
    tile = dict(cohere_launches=dict(prefill=first["launches"].get("quantized_matvec_tile", 0),
                                     short_chunk=launches.get("quantized_matvec_tile", 0)),
                cohere=dict(checks=[c for c in checks if c["rows"] > 1]))
    del bf16, q4
    gc.collect()
    torch.cuda.empty_cache()
    return out, dict(quantized_matvec=k7, quantized_matvec_tile=tile)


def cohere_main(smi: str) -> int:
    """``--cohere``: the [cohere] phase alone, then its JSON and kernel 7's
    Cohere fields as one line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k = cohere_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"cohere": out, "kernels": k}, default=str))
    return 0


class MossTokenizer(Qwen3AsrTokenizer):
    """Stub tokenizer for MOSS's prompt: the ChatML specials and
    ``<|audio_pad|>`` (151671), ``<|audio_start|>`` / ``<|audio_end|>`` at
    Qwen3's ids, a word of letters with its leading space one id (1,000 +
    its CRC-32 mod 100,000), any other byte (the digits of the time markers
    among them) its own id, so that the default prompt has about the real
    tokenizer's 70 rows.
    ``decode`` writes bytes as themselves and other ids as ``w<id>``."""

    SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|audio_pad|>": 151671,
                "<|audio_start|>": 151669, "<|audio_end|>": 151670}

    def encode(self, text):
        import re
        import zlib

        ids = []
        for piece in re.findall("|".join(map(re.escape, self.SPECIALS)) + r"| ?[A-Za-z]+|.",
                                text, re.DOTALL):
            if piece in self.SPECIALS:
                ids.append(self.SPECIALS[piece])
            elif piece.strip().isalpha():
                ids.append(1000 + zlib.crc32(piece.encode()) % 100000)
            else:
                ids += list(piece.encode())
        return self._Ids(ids)

    def decode(self, ids, skip_special_tokens=True):
        special = set(self.SPECIALS.values()) | {151643}
        return "".join(chr(i) if i < 128 else f" w{i} " for i in ids
                       if not (skip_special_tokens and i in special))


def build_moss(dev):
    """MOSS-Transcribe-Diarize at MOSS_AUDIO's and ASR_TEXT's widths from
    seed-0 random weights on the card (``moss_diarize.init_random_params``,
    bf16), the text decoder's RMSNorm weights 1 + N(0, 0.1), quantized on
    the card to MLX 4-bit in groups of 64 by ``quant.quantize_tree``'s
    predicate (the encoder's and the adaptor's linears too; the convs,
    positions and norms dense), the text decoder's q/k/v and gate/up fused;
    the stub tokenizer. Returns the model and the packed leaves' paths."""
    import torch

    from tpu_audio_torch.core import quant
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.stt import moss_diarize as MD
    from tpu_audio_torch.models.stt import whisper as W

    cfg = MD.MossTranscribeDiarizeConfig(text=llama.LlamaConfig(**ASR_TEXT),
                                         audio=W.WhisperConfig(**MOSS_AUDIO))
    params = MD.init_random_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    randomize_norms(params["language_model"]["model"], torch.Generator(device=dev).manual_seed(3))
    q4 = quant.quantize_tree(params, bits=4, group_size=64, scheme="mlx")
    q4["language_model"] = llama.fuse_projections(q4["language_model"])

    def packed(tree, path=""):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in packed(v, f"{path}.{k}" if path else k)]
        return [path] if isinstance(tree, quant.QuantizedTensor) else []

    paths = packed(q4)
    lm, enc = q4["language_model"]["model"], q4["whisper"]["model"]["encoder"]
    check(isinstance(lm["layers"]["self_attn"]["qkv_proj"]["weight"], quant.QuantizedTensor)
          and isinstance(lm["embed_tokens"]["weight"], quant.QuantizedTensor)
          and isinstance(q4["vq_adaptor"]["fc1"]["weight"], quant.QuantizedTensor)
          and isinstance(enc["layers"]["fc1"]["weight"], quant.QuantizedTensor)
          and not isinstance(enc["conv1"]["weight"], quant.QuantizedTensor)
          and not isinstance(enc["embed_positions"]["weight"], quant.QuantizedTensor),
          "MOSS 4-bit: the products, the embedding or the convs not packed as the predicate "
          "says")
    return MD.MossTranscribeDiarize(cfg, q4, MossTokenizer(), torch.bfloat16), paths


def moss_stop(tokens: list, count: int, max_new: int) -> str:
    """Where a MOSS loop stopped: its budget, the degenerate-tail guard (3
    or fewer distinct tokens in the last 24) or an EOS id."""
    if count >= max_new:
        return "max_new"
    if count >= 24 and len(set(tokens[count - 24:count])) <= 3:
        return "guard"
    return "eos"


def moss_counted(model, fn):
    """``fn()`` with the counters reset just before and read just after:
    (result, wall s, launches, decode steps, plain calls of kernels 1 and 7,
    and each ``_decode`` call's (tokens, count, budget, prompt rows, tile
    launches))."""
    import torch

    from tpu_audio_torch.ops import _lib, mel, qmm

    steps, plain, calls = [0], [0], []
    decode = model._decode

    def spy(params, embeds, cache, max_new, *a, **k):
        tile = _lib.launches["quantized_matvec_tile"]
        toks, count = decode(params, embeds, cache, max_new, *a, **k)
        calls.append((toks[:count].tolist(), count, max_new, embeds.shape[1],
                      _lib.launches["quantized_matvec_tile"] - tile))
        return toks, count

    model._decode = spy
    try:
        with counting(model, "_step", steps), counting(qmm, "quantized_matvec_ref", plain), \
                counting(mel, "fused_log_mel_ref", plain):
            _lib.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_lib.launches)
    finally:
        del model._decode
    return out, wall, launches, steps[0], plain[0], calls


def moss_step_products(model) -> int:
    return 4 * model.config.text.num_hidden_layers + 1  # q/k/v, o, gate/up, down; the head


def moss_kernel_checks(model, smi: str) -> dict:
    """Kernel 1 on a 30 s window's STFT (periodic Hann, 201 bins, 80 slaney
    mels: ``dsp.log_mel_spectrogram``'s shapes) against its plain version,
    timed, with its bound; kernel 7's decode kernel at 1 row with f32 x (a
    decode step's residual stream on the packed embedding) at each packed
    product of decoder layer 0 and the tied head, and its tile with bf16 x
    at the adaptor's two products on a 2 s pass's 25 audio rows."""
    import torch

    from tpu_audio_torch.core import dsp
    from tpu_audio_torch.ops import mel as M

    dev = model.device
    audio = torch.from_numpy(asr_signal(30.0, 5)).to(dev)
    spec = dsp.stft(audio, dsp.hanning_window(400, periodic=True), 400, 160)[:-1]
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    fb = torch.from_numpy(dsp.mel_filters(16000, 400, model.config.audio.num_mel_bins,
                                          f_min=0.0, f_max=8000.0, norm="slaney",
                                          mel_scale="slaney")).to(dev)
    got, want, err = mel_check("moss 30 s window, 80 slaney mels",
                               lambda: M.fused_log_mel(re, im, fb), re, im, fb)
    b_ms, b_by = mel_bound(re, im, fb, got)
    k1 = dict(shape=[re.shape[0], re.shape[1], fb.shape[1]], max_abs_err=err,
              rel_err=rel_err(got, want), bound_ms=b_ms, bound_by=b_by,
              ms=cuda_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_ms=cuda_ms(lambda: M.fused_log_mel_ref(re, im, fb)),
              dev_ms=device_ms(lambda: M.fused_log_mel(re, im, fb)),
              plain_dev_ms=device_ms(lambda: M.fused_log_mel_ref(re, im, fb)))
    print(f"[moss mel] kernel 1 at [{re.shape[0]},{re.shape[1]}]x[{fb.shape[0]},{fb.shape[1]}]: "
          f"max abs err {err:.3e} (atol {MEL_ATOL}); per call kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms; device kernel {fmt(k1['dev_ms'])}, plain "
          f"{fmt(k1['plain_dev_ms'])}; bound {b_ms:.6f} ms ({b_by}) ({smi})")
    p = model.params["language_model"]["model"]
    layer = [(n, p["layers"][a][n]["weight"].map(lambda t: t[0]))
             for a, names in (("self_attn", ("qkv_proj", "o_proj")),
                              ("mlp", ("gate_up_proj", "down_proj"))) for n in names]
    gen = torch.Generator(device=dev).manual_seed(17)
    out = []
    for name, w in layer + [("head", p["embed_tokens"]["weight"])]:
        x = torch.randn((1, w.weight.shape[-1] * 32 // w.bits), generator=gen, device=dev)
        e, _, ran = qmm_check(f"moss {name} [1]", x, w.weight, w.scales, w.biases,
                              w.group_size, w.bits)
        check(ran == "decode", f"moss {name} at 1 row ran the {ran}, not the decode kernel")
        out.append(dict(shape=name, rows=1, x="float32", kernel=ran, o=w.weight.shape[0],
                        i=x.shape[1], rel_err=e))
    # a 2 s streaming pass: 25 audio rows through the adaptor's products
    rows = model._audio_token_length(32000)
    for name in ("fc1", "fc2"):
        w = model.params["vq_adaptor"][name]["weight"]
        x = torch.randn((rows, w.weight.shape[-1] * 32 // w.bits), generator=gen,
                        device=dev).to(torch.bfloat16)
        e, _, ran = qmm_check(f"moss adaptor {name} [{rows}]", x, w.weight, w.scales, w.biases,
                              w.group_size, w.bits)
        check(ran == "tile", f"moss adaptor {name} at {rows} rows ran the {ran}, not the tile")
        out.append(dict(shape=f"adaptor {name}", rows=rows, x="bfloat16", kernel=ran,
                        o=w.weight.shape[0], i=x.shape[1], rel_err=e))
    dec = [c for c in out if c["rows"] == 1]
    print(f"[moss qmm] kernel 7's decode kernel at the text decoder's {len(dec)} product "
          f"shapes (4-bit, g 64, 1 row, f32 x): rel err up to "
          f"{max(c['rel_err'] for c in dec):.3e} (rtol {QMM_RTOL}); the tile at the adaptor's "
          f"2 products at {rows} rows (a 2 s pass) with bf16 x: "
          f"{[round(c['rel_err'], 6) for c in out if c['rows'] > 1]} (rtol {QMM_BF16_RTOL})")
    return dict(k1=k1, k7=dec, k7b=[c for c in out if c["rows"] > 1])


def moss_generate_runs(model) -> tuple[list, dict]:
    """Greedy ``generate`` with a MOSS_TOKENS budget on each of MOSS_SECONDS
    twice, the counters reset just before and read just after each: kernel
    1 once a 30 s window, kernel 7's decode kernel 113 times a decode step,
    no tile (the prompts' prefills, the encoder's and the adaptor's rows
    are more than 64: they dequantize), no GEMV, no plain call; the tokens
    repeat. The prompt's rows, its audio rows and where each loop
    stopped."""
    from tpu_audio_torch.core.generation import STTGenerateParameters

    per = moss_step_products(model)
    runs, first = [], {}
    for seconds in MOSS_SECONDS:
        audio = asr_signal(seconds, 6)
        windows = -(-len(audio) // 480000)
        audio_rows = sum(model._audio_token_length(min(480000, len(audio) - s))
                         for s in range(0, len(audio), 480000))
        for run in range(2):
            out, wall, launches, steps, plain, calls = moss_counted(
                model, lambda: model.generate(audio, STTGenerateParameters(max_tokens=MOSS_TOKENS)))
            (toks, count, max_new, rows, _), = calls
            stop = moss_stop(toks, count, max_new)
            n_dec = launches.get("quantized_matvec_decode", 0)
            label = f"[moss generate {seconds:g} s run {run}]"
            print(f"{label} {count} tokens in {wall:.3f} s ({steps} decode steps, loop stopped "
                  f"at {stop}); a {rows}-row prompt ({audio_rows} audio rows over {windows} "
                  f"window(s)); RTF {wall / seconds:.4f}; launches {launches}: kernel 1 "
                  f"{launches.get('fused_log_mel', 0)} ({windows} expected), decode kernel "
                  f"{n_dec} ({per * steps} expected), tile "
                  f"{launches.get('quantized_matvec_tile', 0)}; plain calls {plain}; text "
                  f"{out.text[:60]!r}")
            check(launches.get("fused_log_mel") == windows and n_dec == per * steps
                  and not launches.get("quantized_matvec_tile")
                  and launches.get("quantized_matvec") == n_dec and plain == 0
                  and set(launches) <= {"fused_log_mel", "quantized_matvec",
                                        "quantized_matvec_tile", "quantized_matvec_decode"},
                  f"{label}: kernel 1 or 7's launches, another kernel or a plain call")
            check(rows > 64 and count <= steps <= max_new and out.prompt_token_count == rows
                  and (stop != "max_new" or steps == MOSS_TOKENS),
                  f"{label}: {count} tokens, {steps} steps, a {rows}-row prompt")
            key = seconds
            if key not in first:
                first[key] = (toks, launches, steps, rows, stop)
            check(toks == first[key][0], f"{label}: tokens differ from the first run's")
            runs.append(dict(seconds=seconds, run=run, tokens=count, steps=steps,
                             prompt_rows=rows, audio_rows=audio_rows, windows=windows, stop=stop,
                             wall_s=wall, rtf=wall / seconds, launches=launches,
                             text=out.text[:80], segments=len(out.segments)))
    return runs, dict(first_tokens=first[MOSS_SECONDS[0]][0],
                      launches=first[MOSS_SECONDS[0]][1], steps=first[MOSS_SECONDS[0]][2])


def moss_decode_profile(model, smi: str) -> dict:
    """On a 30 s clip's prompt: ``_decode`` with MOSS_PROFILE_TOKENS tokens
    and with none (the prefill and its first pick alone), each timed on
    the host clock (best of 3) and profiled once (device activity only):
    a decode token's host ms, device ms, events and kernel 7's share are
    their differences a token, beside the bound of one step's 113 packed
    products; the encoder's device ms a 30 s window (``encode_audio``: the
    mel, the encoder, the adaptor; one marked window) and the prefill's."""
    import types

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_audio_torch.models import llama

    n, dev, tcfg = MOSS_PROFILE_TOKENS, model.device, model.config.text
    lm = model.params["language_model"]
    audio = asr_signal(30.0, 7)
    with torch.no_grad():
        feats = model.encode_audio(audio)
        ids = np.asarray([model.build_prompt(feats.shape[0])], np.int32)
        emb = model._inject_audio(ids, feats).to(model.dtype)

        def cache():
            return llama.make_cache(tcfg, 1, ids.shape[1] + n + 1, model.dtype, device=dev)

        def timed(k):
            walls = []
            for _ in range(3):
                c = cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model._decode(lm, emb, c, k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            c = cache()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model._decode(lm, emb, c, k)
                torch.cuda.synchronize()
            kernels = by_kernel(prof)
            k7 = [v for name, v in kernels.items() if "quantized_matvec" in name]
            return (min(walls) * 1e3, sum(v[1] for v in kernels.values()) / 1e3,
                    sum(v[0] for v in kernels.values()), sum(v[1] for v in k7) / 1e3,
                    sum(v[0] for v in k7), kernels)

        full, none = timed(n), timed(0)
        enc_us, enc_events = marked_window(lambda: model.encode_audio(audio), "moss encoder")
        pre_us, pre_events = marked_window(
            lambda: llama.forward(lm, None, cache(), tcfg, inputs_embeds=emb), "moss prefill")
    b_ms, b_by, products = packed_step_bound(types.SimpleNamespace(params=lm))
    out = dict(ms_per_token=(full[0] - none[0]) / n, device_ms_per_token=(full[1] - none[1]) / n,
               device_events_per_token=(full[2] - none[2]) / n,
               kernel7_device_ms_per_token=(full[3] - none[3]) / n,
               kernel7_launches_per_token=(full[4] - none[4]) / n, bound_ms=b_ms, bound_by=b_by,
               products=products, prompt_rows=int(ids.shape[1]),
               encoder_device_ms=None if enc_us is None else enc_us / 1e3,
               encoder_events=enc_events,
               prefill_device_ms=None if pre_us is None else pre_us / 1e3,
               prefill_events=pre_events, prefill_host_ms=none[0], prefill_device_ms_sum=none[1])
    print(f"[moss decode] {n}-token decode after a {ids.shape[1]}-row prompt (the difference "
          f"of {n} and 0 tokens): {out['ms_per_token']:.4f} host ms a token (best of 3), "
          f"{out['device_ms_per_token']:.4f} device ms a token of which kernel 7 "
          f"{out['kernel7_device_ms_per_token']:.4f} ({out['kernel7_launches_per_token']:.1f} "
          f"launches a token) against the bound of its {products} products {b_ms:.4f} ms "
          f"({b_by}); {out['device_events_per_token']:.1f} device events a token; encode_audio "
          f"on a 30 s window {fmt(out['encoder_device_ms'])} device ({enc_events} events); the "
          f"prefill {fmt(out['prefill_device_ms'])} device ({pre_events} events), host "
          f"{none[0]:.3f} ms with its first pick ({smi})")
    print_kernels(full[5], n, top=8)
    check(products == moss_step_products(model), f"{products} packed products a step")
    return out


def moss_cut(model, n: int):
    """``model``'s config and tree cut to its first ``n`` encoder and text
    layers, in f32 (packed leaves stay packed)."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models import llama

    cfg = dataclasses.replace(
        model.config, audio=dataclasses.replace(model.config.audio, encoder_layers=n),
        text=dataclasses.replace(model.config.text, num_hidden_layers=n))
    p = model.params
    enc = p["whisper"]["model"]["encoder"]
    lm = p["language_model"]
    cut = {"whisper": {"model": {"encoder": {**enc, "layers": llama._map(
               lambda t: t[:n], enc["layers"])}}},
           "vq_adaptor": p["vq_adaptor"],
           "language_model": {**lm, "model": {**lm["model"], "layers": llama._map(
               lambda t: t[:n], lm["model"]["layers"])}}}
    return cfg, loading.cast_floats(cut, torch.float32)


def moss_card_vs_cpu(model) -> dict:
    """The 4-bit model cut to MOSS_CARD_LAYERS encoder and text layers in
    f32 (the products stay packed), card against CPU on the same weights
    and MOSS_CARD_SECONDS of audio: the adaptor's output (the audio rows)
    and MOSS_CARD_TOKENS step logits (the prefill's last, then along the
    CPU's greedy tokens; kernels 1 and 7 on the card, their plain versions
    on the CPU), each within MOSS_CARD_RTOL of the CPU's relative to its
    max and under its TF32 control; the greedy tokens equal, or parted
    where the CPU's two best logits lie within the two logits'
    difference."""
    import numpy as np
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models import llama
    from tpu_audio_torch.models.stt import moss_diarize as MD

    steps = MOSS_CARD_TOKENS
    cfg, params = moss_cut(model, MOSS_CARD_LAYERS)
    audio = asr_signal(MOSS_CARD_SECONDS, 1)

    def run(params, row=None):
        m = MD.MossTranscribeDiarize(cfg, params, model.tokenizer, torch.float32)
        lm = m.params["language_model"]
        with torch.no_grad():
            feats = m.encode_audio(audio)
            ids = np.asarray([m.build_prompt(feats.shape[0])], np.int32)
            emb = m._inject_audio(ids, feats)

            def cache():
                return llama.make_cache(cfg.text, 1, ids.shape[1] + steps + 1, torch.float32,
                                        device=m.device)

            toks, count = m._decode(lm, emb, cache(), steps)
            greedy = toks[:count].tolist()
            logits, c = llama.forward(lm, None, cache(), cfg.text, inputs_embeds=emb)
            out = [logits[0, -1]]
            for t in (greedy if row is None else row)[:steps - 1]:
                lg, c = m._step(lm, torch.tensor([[t]], device=m.device), c)
                out.append(lg[0])
        return dict(adaptor=feats.float().cpu(), logits=torch.stack(out).float().cpu()), greedy

    cpu, cpu_greedy = run(loading.to_device(params, "cpu"))
    card, card_greedy = run(params, cpu_greedy)
    with plain_kernels(), tf32_everywhere():
        control, _ = run(params, cpu_greedy)
    out = {k: dict(rel_err=rel_err(card[k], cpu[k]), tf32_control=rel_err(control[k], cpu[k]))
           for k in card}
    parted = None
    if card_greedy != cpu_greedy:
        s = next(i for i in range(min(len(card_greedy), len(cpu_greedy)))
                 if card_greedy[i] != cpu_greedy[i])
        top = torch.topk(cpu["logits"][s], 2)
        gap = float(top.values[0] - top.values[1])
        diff = float((card["logits"][s] - cpu["logits"][s]).abs().max())
        parted = dict(token=s, margin=gap, max_diff=diff)
        check({card_greedy[s], cpu_greedy[s]} == set(top.indices.tolist()) and gap <= diff,
              f"moss card against CPU: greedy tokens part at {s}, not at a near tie {parted}")
    out["greedy"] = dict(equal=card_greedy == cpu_greedy, tokens=len(cpu_greedy), parted=parted)
    print(f"[moss card vs CPU] {MOSS_CARD_LAYERS} encoder and {MOSS_CARD_LAYERS} text layers in "
          f"f32 (4-bit products), {MOSS_CARD_SECONDS:g} s ({card['adaptor'].shape[0]} audio "
          f"rows), {steps} steps: " + "; ".join(
              f"{k} {out[k]['rel_err']:.3e} (TF32 control {out[k]['tf32_control']:.3e})"
              for k in card) + f" (limit {MOSS_CARD_RTOL}); greedy tokens equal: "
          f"{card_greedy == cpu_greedy} {parted or ''}")
    for k in card:
        check(bool(torch.isfinite(card[k]).all()) and card[k].shape == cpu[k].shape
              and out[k]["rel_err"] <= MOSS_CARD_RTOL < out[k]["tf32_control"],
              f"moss {k} card against CPU {out[k]}: not within {MOSS_CARD_RTOL}, or the TF32 "
              f"control within it")
    return out


class MossCapped:
    """The MOSS model as the streaming session sees it, with every pass's
    tokens capped at MOSS_STREAM_TOKENS: the port's final passes take no
    cap (as the JAX package's), and random weights emit no EOS. Records
    each pass's (seconds, the session's cap)."""

    def __init__(self, model):
        self.model, self.sample_rate, self.passes = model, model.sample_rate, []

    def streaming_transcribe_window(self, samples, offset_seconds=0.0, language=None,
                                    max_tokens=None):
        self.passes.append((len(samples) / self.sample_rate, max_tokens))
        return self.model.streaming_transcribe_window(
            samples, offset_seconds=offset_seconds, language=language,
            max_tokens=min(max_tokens or MOSS_STREAM_TOKENS, MOSS_STREAM_TOKENS))


def moss_stream(model) -> dict:
    """``StreamingInferenceSession`` (the MOSS core: 4 s windows) over
    MOSS_STREAM_SECONDS at 1 s feeds, on a clock that moves 1 s a feed,
    through ``MossCapped``; the counters reset just before and read just
    after: kernel 1 once a pass, kernel 7's decode kernel 113 times a
    decode step, its tile twice a pass of 64 audio rows or fewer (the
    adaptor's products), no plain call. Partial and final passes run, at
    least two windows are finalized, and the ended text is the completed
    text."""
    from tpu_audio_torch.models.stt.streaming import (EventKind, StreamingConfig,
                                                      StreamingInferenceSession)

    per = moss_step_products(model)
    audio = asr_signal(MOSS_STREAM_SECONDS, 2)
    capped = MossCapped(model)
    clock = StepClock()
    session = StreamingInferenceSession(capped, config=StreamingConfig(), clock=clock)

    def feed_all():
        events = []
        for s in range(0, len(audio), 16000):
            events += session.feed_audio(audio[s:s + 16000])
            clock.advance(1.0)
        return events + session.stop()

    events, wall, launches, steps, plain, calls = moss_counted(model, feed_all)
    core = session.core
    kinds = [e.kind.value for e in events]
    stats = [e.stats for e in events if e.kind == EventKind.STATS][-1]
    n_dec = launches.get("quantized_matvec_decode", 0)
    partial = sum(1 for _, cap in capped.passes if cap is not None)
    # a pass of 64 audio rows or fewer (5.1 s) runs the adaptor's two
    # products on kernel 7's tile; its prompt is longer: it dequantizes
    tiles = sum(2 for a, _ in capped.passes
                if 2 <= model._audio_token_length(round(a * 16000)) <= 64)
    print(f"[moss stream] {MOSS_STREAM_SECONDS:g} s at 1 s feeds, core "
          f"{type(core).__name__}: {len(capped.passes)} passes ({partial} partial; seconds and "
          f"the session's caps {[(round(a, 2), c) for a, c in capped.passes]}, every pass capped "
          f"here at {MOSS_STREAM_TOKENS}), {steps} decode steps in {wall:.3f} s: session RTF "
          f"{wall / MOSS_STREAM_SECONDS:.4f}, {stats['decode_time'] * 1e3 / len(calls):.1f} ms "
          f"a pass; {core._finalized_windows} windows finalized; loops stopped at "
          f"{[moss_stop(t, c, m) for t, c, m, _, _ in calls]}; launches {launches} (decode "
          f"kernel {per * steps}, tile {tiles} expected); plain calls {plain}; events "
          f"{' '.join(k[:4] for k in kinds)}; ended {events[-1].text[:60]!r}")
    check(type(core).__name__ == "_MossStreamingCore" and kinds[-1] == "ended"
          and "display_update" in kinds and "stats" in kinds
          and set(kinds) <= {k.value for k in EventKind}, f"moss stream: event kinds {kinds}")
    check(events[-1].text == events[-1].confirmed_text == core.completed_text
          and core._finalized_windows >= 2 and partial >= 1 and len(calls) == len(capped.passes),
          "moss stream: no partial pass, windows not finalized, or the ended text is not the "
          "session's")
    check(launches.get("fused_log_mel") == len(calls) and n_dec == per * steps
          and launches.get("quantized_matvec_tile", 0) == tiles and plain == 0
          and launches.get("quantized_matvec") == n_dec + tiles,
          f"moss stream: kernel 1 or 7's launches ({tiles} tiles expected), or a plain call")
    return dict(seconds=MOSS_STREAM_SECONDS, wall_s=wall, rtf=wall / MOSS_STREAM_SECONDS,
                passes=len(capped.passes), partial_passes=partial, steps=steps,
                windows=core._finalized_windows,
                ms_per_pass=stats["decode_time"] * 1e3 / len(calls), kinds=kinds,
                launches=launches)


def moss_http(model) -> dict:
    """One ``/v1/audio/transcriptions`` POST of MOSS_HTTP_SECONDS to the
    server on 127.0.0.1 (``--slots 2``: no engine for MOSS, the locked
    ``generate``); the served model is the same tree whose ``generate``
    defaults to a MOSS_TOKENS budget (the port's default, 2,048, would run
    to its end on random weights). Segments carry a speaker where the text
    has tags."""
    import json as _json

    from tpu_audio_torch.cli.serve import build_server
    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import moss_diarize as MD

    class Served(MD.MossTranscribeDiarize):
        def generate(self, audio, generation_parameters=None, prompt=None):
            return super().generate(audio, generation_parameters
                                    or STTGenerateParameters(max_tokens=MOSS_TOKENS), prompt)

    served = Served.__new__(Served)
    served.__dict__.update(model.__dict__)
    server = build_server(served, "stt", "moss-random", port=0, slots=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        check(server.stt_worker is None, "moss serve: an engine was built")
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/audio/transcriptions",
            data=wav_body(asr_signal(MOSS_HTTP_SECONDS, 8)),
            headers={"Content-Type": "audio/wav"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body, code = _json.loads(r.read()), r.status
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    segs = body.get("segments", [])
    tagged = [s for s in segs if s["text"].startswith("[S")]
    print(f"[moss http] one {MOSS_HTTP_SECONDS:g} s POST: HTTP {code} in {wall:.3f} s, "
          f"{len(body.get('text', ''))} characters, {len(segs)} segment(s), {len(tagged)} with "
          f"a speaker (random weights write no tags unless by chance): "
          f"{body.get('text', '')[:60]!r}")
    check(code == 200 and body.get("text") and len(segs) >= 1
          and all(s["end"] >= s["start"] for s in segs), f"moss http: {code} {str(body)[:120]}")
    return dict(code=code, wall_s=wall, segments=len(segs), speaker_segments=len(tagged))


def moss_phase(dev, smi: str) -> tuple[dict, dict]:
    """``[moss]``: MOSS-Transcribe-Diarize (``build_moss``) on the MLX 4-bit
    tree. Kernels 1 and 7 against their plain versions at the path's shapes
    (``moss_kernel_checks``); greedy ``generate`` on 30 s and 65 s twice
    each with its launches (``moss_generate_runs``); a decode token's host
    and device ms, events and kernel 7's share against its bound, the
    encoder's and the prefill's device ms (``moss_decode_profile``); 4 + 4
    layers in f32 card against CPU (``moss_card_vs_cpu``); the streaming
    session (``moss_stream``); one request through the server
    (``moss_http``); the peak device memory. Returns the record and kernels
    1 and 7's fields."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, packed = build_moss(dev)
    torch.cuda.synchronize()
    a, t = model.config.audio, model.config.text
    enc = sum(p.startswith("whisper") for p in packed)
    print(f"[moss] Whisper encoder {a.encoder_layers} x {a.d_model} ({a.encoder_attention_heads} "
          f"heads, ffn {a.encoder_ffn_dim}, {a.num_mel_bins} mels), adaptor "
          f"{a.d_model * model.config.audio_merge_size} -> {t.hidden_size}, Qwen3 decoder "
          f"{t.num_hidden_layers} x {t.hidden_size} (vocabulary {t.vocab_size}) MLX 4-bit (g 64) "
          f"built on the card in {time.perf_counter() - t_phase:.1f} s: {len(packed)} packed "
          f"leaves ({enc} in the encoder) ({smi})")
    out = dict(packed_leaves=len(packed), packed_in_encoder=enc)
    parts = {"build": time.perf_counter() - t_phase}
    checks = moss_kernel_checks(model, smi)
    parts["kernels"] = time.perf_counter() - t_phase
    out["runs"], gen = moss_generate_runs(model)
    parts["generate"] = time.perf_counter() - t_phase
    out["decode"] = moss_decode_profile(model, smi)
    parts["decode profile"] = time.perf_counter() - t_phase
    out["card_vs_cpu"] = moss_card_vs_cpu(model)
    parts["card vs CPU"] = time.perf_counter() - t_phase
    out["stream"] = moss_stream(model)
    parts["stream"] = time.perf_counter() - t_phase
    out["http"] = moss_http(model)
    out["peak_gb"] = peak_gb()
    out["seconds"] = parts["http"] = time.perf_counter() - t_phase
    print(f"[moss] peak device memory {out['peak_gb']:.2f} GB; the phase {out['seconds']:.1f} s "
          f"(seconds from its start at the end of each part: "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}) ({smi})")
    k7 = dict(moss_launches=gen["launches"].get("quantized_matvec_decode", 0), moss=dict(
        decode_per_step=gen["launches"].get("quantized_matvec_decode", 0) / gen["steps"],
        device_ms_per_token=out["decode"]["device_ms_per_token"],
        kernel7_device_ms_per_token=out["decode"]["kernel7_device_ms_per_token"],
        bound_ms=out["decode"]["bound_ms"], bound_by=out["decode"]["bound_by"],
        products=out["decode"]["products"], checks=checks["k7"]))
    tile = dict(moss_launches=dict(generate=gen["launches"].get("quantized_matvec_tile", 0),
                                   stream=out["stream"]["launches"].get(
                                       "quantized_matvec_tile", 0)),
                moss=dict(checks=checks["k7b"], per_short_pass=2))
    k1 = dict(moss_launches=gen["launches"].get("fused_log_mel", 0), moss=dict(
        checks["k1"], windows_65s=[r["launches"].get("fused_log_mel", 0) for r in out["runs"]
                                   if r["seconds"] == MOSS_SECONDS[1]][0]))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, dict(quantized_matvec=k7, quantized_matvec_tile=tile, fused_log_mel=k1)


W2V_VOCAB = ["<pad>", "<s>", "</s>", "<unk>", "|"] + list("etaonihsrdlumwcfgypbvkjxqz'-")


def build_wav2vec2(dev, cfg=None):
    """wav2vec2 at ``cfg``'s widths (``Wav2Vec2Config()`` by default) from
    seed-0 random weights on the card in f32, with the CTC head and a LID
    head of W2V_LABELS on the same trunk: (``Wav2Vec2CTC``,
    ``Wav2Vec2LID``)."""
    import torch

    from tpu_audio_torch.models.lid.wav2vec2_lid import Wav2Vec2LID
    from tpu_audio_torch.models.stt import wav2vec2 as WV

    cfg = cfg or WV.Wav2Vec2Config()
    params = WV.init_random_params(cfg, seed=0, dtype=torch.float32, device=dev,
                                   num_labels=W2V_LABELS)
    vocab = dict(enumerate(W2V_VOCAB[:cfg.vocab_size]))
    return (WV.Wav2Vec2CTC(cfg, params, vocab, dtype=torch.float32),
            Wav2Vec2LID(cfg, params, {i: f"lang{i:03d}" for i in range(W2V_LABELS)},
                        torch.float32))


def w2v_counted(fn):
    """``fn()`` with the counters reset just before and read just after:
    (result, wall s, launches)."""
    import torch

    from tpu_audio_torch.ops import _lib

    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {k: v for k, v in _lib.launches.items() if v}


def w2v_runs(ctc, lid) -> dict:
    """``generate`` on W2V_SECONDS twice and ``predict`` (top 5) once, the
    counters reset just before and read just after each: no kernel of the
    port launches; the text repeats; the CTC frames; the logits' device ms
    and events (one marked window each)."""
    import torch

    audio = asr_signal(W2V_SECONDS, 9)
    runs, first = [], None
    for run in range(2):
        out, wall, launches = w2v_counted(lambda: ctc.generate(audio))
        print(f"[wav2vec2 generate run {run}] {W2V_SECONDS:g} s: {out.generation_token_count} "
              f"CTC tokens in {wall:.3f} s; RTF {wall / W2V_SECONDS:.4f}; launches {launches}; "
              f"text {out.text[:60]!r}")
        check(not launches, f"wav2vec2 generate launched a kernel of the port: {launches}")
        first = out.text if first is None else first
        check(out.text == first, "wav2vec2: the text differs from run 0's")
        runs.append(dict(run=run, tokens=out.generation_token_count, wall_s=wall,
                         rtf=wall / W2V_SECONDS))
    frames = int(ctc.logits(audio).shape[1])
    ctc_us, ctc_events = marked_window(lambda: ctc.logits(audio), "wav2vec2 ctc")
    pred, wall, launches = w2v_counted(lambda: lid.predict(audio, top_k=5))
    lid_us, lid_events = marked_window(lambda: lid.logits(audio), "wav2vec2 lid")
    top = [(p.language, round(p.confidence, 6)) for p in pred.top_languages]
    out = dict(runs=runs, frames=frames, ctc_device_ms=None if ctc_us is None else ctc_us / 1e3,
               ctc_events=ctc_events, predict_wall_s=wall, top5=top,
               lid_device_ms=None if lid_us is None else lid_us / 1e3, lid_events=lid_events)
    print(f"[wav2vec2] {W2V_SECONDS:g} s -> {frames} frames; CTC logits "
          f"{fmt(out['ctc_device_ms'])} device ({ctc_events} events); predict in {wall:.3f} s, "
          f"launches {launches}, LID logits {fmt(out['lid_device_ms'])} device ({lid_events} "
          f"events); top 5 {top}")
    check(frames == 1499 and not launches and len(top) == 5
          and bool(torch.isfinite(torch.tensor([c for _, c in top])).all()),
          f"wav2vec2: {frames} frames, predict launches {launches}, top {top}")
    return out


def w2v_card_vs_cpu(ctc) -> dict:
    """The trunk cut to W2V_CARD_LAYERS layers in f32, card against CPU on
    the same weights and W2V_CARD_SECONDS: the CTC and LID logits within
    W2V_CARD_RTOL of the CPU's relative to their max, each under its TF32
    control (TF32 products and convolutions); the CTC text equal; the top-5
    languages in the same order, or parted only where the CPU's two
    probabilities lie within the two routes' difference of the logits."""
    import torch

    from tpu_audio_torch.core import loading
    from tpu_audio_torch.models.lid.wav2vec2_lid import Wav2Vec2LID
    from tpu_audio_torch.models.stt import wav2vec2 as WV

    n = W2V_CARD_LAYERS
    cfg = dataclasses.replace(ctc.config, num_hidden_layers=n)
    p = ctc.params
    enc = p["wav2vec2"]["encoder"]
    cut = {**p, "wav2vec2": {**p["wav2vec2"], "encoder": {
        **enc, "layers": {str(i): enc["layers"][str(i)] for i in range(n)}}}}
    audio = asr_signal(W2V_CARD_SECONDS, 10)

    def run(params):
        c = WV.Wav2Vec2CTC(cfg, params, ctc.vocab)
        lid = Wav2Vec2LID(cfg, params, {i: f"lang{i:03d}" for i in range(W2V_LABELS)})
        return (dict(ctc=c.logits(audio)[0].cpu(), lid=lid.logits(audio)[0].cpu()),
                c.generate(audio).text, [q.language for q in lid.predict(audio).top_languages])

    cpu, cpu_text, cpu_top = run(loading.to_device(cut, "cpu"))
    card, card_text, card_top = run(cut)
    with tf32_everywhere():
        control, _, _ = run(cut)
    out = {k: dict(rel_err=rel_err(card[k], cpu[k]), tf32_control=rel_err(control[k], cpu[k]))
           for k in card}
    parted = None
    if card_top != cpu_top:
        s = next(i for i in range(5) if card_top[i] != cpu_top[i])
        probs = torch.softmax(cpu["lid"], -1)
        ids = [int(l[4:]) for l in (card_top[s], cpu_top[s])]
        gap = float((probs[ids[0]] - probs[ids[1]]).abs())
        diff = float((torch.softmax(card["lid"], -1) - probs).abs().max())
        parted = dict(rank=s, margin=gap, max_diff=diff)
        check(gap <= diff, f"wav2vec2 card against CPU: top 5 part at rank {s}, not at a near "
                           f"tie {parted}")
    out["text_equal"], out["top5_equal"], out["top5_parted"] = (card_text == cpu_text,
                                                               card_top == cpu_top, parted)
    print(f"[wav2vec2 card vs CPU] {n} layers in f32, {W2V_CARD_SECONDS:g} s: " + "; ".join(
        f"{k} logits {v['rel_err']:.3e} (TF32 control {v['tf32_control']:.3e})"
        for k, v in out.items() if isinstance(v, dict) and "rel_err" in v)
          + f" (limit {W2V_CARD_RTOL}); CTC text equal {card_text == cpu_text}; top 5 equal "
            f"{card_top == cpu_top} {parted or ''}")
    for k in card:
        check(bool(torch.isfinite(card[k]).all()) and card[k].shape == cpu[k].shape
              and out[k]["rel_err"] <= W2V_CARD_RTOL < out[k]["tf32_control"],
              f"wav2vec2 {k} card against CPU {out[k]}: not within {W2V_CARD_RTOL}, or the TF32 "
              f"control within it")
    check(card_text == cpu_text, "wav2vec2 card against CPU: the CTC text differs")
    return out


def w2v_http(ctc, lid) -> dict:
    """``serve --task lid`` on MMS-LID (no ``predict_batch``: no batcher,
    ``predict`` under the lock) answers one ``/v1/audio/lid?top_k=5`` POST
    as ``predict`` on the audio the server read; ``--task stt`` on the CTC
    model one ``/v1/audio/transcriptions`` POST as ``generate``."""
    import json as _json

    from tpu_audio_torch.cli.serve import _load_wav_body, build_server

    body = wav_body(asr_signal(6.0, 11))
    heard = _load_wav_body(body, 16000)[0]
    out = {}
    for task, model, path in (("lid", lid, "/v1/audio/lid?top_k=5"),
                              ("stt", ctc, "/v1/audio/transcriptions")):
        server = build_server(model, task, "wav2vec2-random", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            if task == "lid":
                check(server.lid_batcher is None, "wav2vec2 serve: a LID batcher was built")
            req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}{path}",
                                         data=body, headers={"Content-Type": "audio/wav"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                out[task] = (_json.loads(r.read()), r.status, time.perf_counter() - t0)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    (lid_body, lid_code, lid_wall), (stt_body, stt_code, stt_wall) = out["lid"], out["stt"]
    want = lid.predict(heard, top_k=5)
    text = ctc.generate(heard).text
    print(f"[wav2vec2 http] /v1/audio/lid: HTTP {lid_code} in {lid_wall:.3f} s, top "
          f"{[t['language'] for t in lid_body.get('top', [])]}; /v1/audio/transcriptions: HTTP "
          f"{stt_code} in {stt_wall:.3f} s, {len(stt_body.get('text', ''))} characters")
    check(lid_code == 200 and [t["language"] for t in lid_body["top"]]
          == [q.language for q in want.top_languages]
          and abs(lid_body["confidence"] - round(want.confidence, 6)) <= 1e-6,
          f"wav2vec2 http lid: {lid_code} {str(lid_body)[:120]}")
    check(stt_code == 200 and stt_body["text"] == text,
          f"wav2vec2 http stt: {stt_code} {str(stt_body)[:120]}")
    return dict(lid_code=lid_code, lid_wall_s=lid_wall, stt_code=stt_code, stt_wall_s=stt_wall)


def w2v_trace(dev) -> dict:
    """``cli/stt.py`` under ``TPU_AUDIO_PROFILE``: a W2V_TRACE_LAYERS-layer
    checkpoint at ``Wav2Vec2Config()``'s widths written to a temporary
    directory (seed 0, f32, the checkpoint's keys) and a W2V_TRACE_SECONDS
    WAV; the trace file ``stt_generate.<pid>.json`` holds the label and at
    least one CUDA kernel event."""
    import os

    from tpu_audio_torch.cli import stt
    from tpu_audio_torch.core import loading
    from tpu_audio_torch.core.audio_io import save_wav
    from tpu_audio_torch.models.stt import wav2vec2 as WV

    cfg = WV.Wav2Vec2Config(num_hidden_layers=W2V_TRACE_LAYERS)
    ctc, _ = build_wav2vec2(dev, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "w2v"
        d.mkdir()
        flat = {k: v for k, v in loading.flatten(ctc.params).items()
                if not k.startswith(("projector", "classifier"))}
        write_safetensors(d / "model.safetensors", flat)
        (d / "config.json").write_text(json.dumps({**dataclasses.asdict(cfg),
                                                   "model_type": "wav2vec2"}))
        (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(W2V_VOCAB)}))
        wav = Path(tmp) / "in.wav"
        save_wav(str(wav), asr_signal(W2V_TRACE_SECONDS, 12), 16000)
        trace = Path(tmp) / "trace"
        os.environ["TPU_AUDIO_PROFILE"] = str(trace)
        try:
            t0 = time.perf_counter()
            code = stt.main([str(wav), "--model", str(d)])
            wall = time.perf_counter() - t0
        finally:
            del os.environ["TPU_AUDIO_PROFILE"]
        files = list(trace.glob("stt_generate.*.json"))
        events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
    names = {e.get("name") for e in events}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[wav2vec2 trace] cli/stt.py on a {W2V_TRACE_LAYERS}-layer checkpoint under "
          f"TPU_AUDIO_PROFILE: exit {code} in {wall:.3f} s; {len(files)} trace file(s), "
          f"{len(events)} events, {kernels} CUDA kernel events, label present: "
          f"{'stt_generate' in names}")
    check(code == 0 and len(files) == 1 and "stt_generate" in names and kernels >= 1,
          "wav2vec2 trace: no trace file, no label or no CUDA kernel event")
    return dict(files=len(files), events=len(events), kernel_events=kernels, wall_s=wall)


def wav2vec2_phase(dev, smi: str) -> dict:
    """``[wav2vec2]``: wav2vec2 CTC and MMS-LID (``build_wav2vec2``) at
    ``Wav2Vec2Config()``'s widths in f32: ``maybe_trace`` through
    ``cli/stt.py`` (``w2v_trace``); ``generate`` twice and ``predict``
    (``w2v_runs``); 4 layers card against CPU (``w2v_card_vs_cpu``); the
    servers (``w2v_http``); the peak device memory. No kernel of the port
    runs on this path."""
    import torch

    from tpu_audio_torch.core import loading

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"trace": w2v_trace(dev)}
    parts = {"trace": time.perf_counter() - t_phase}
    ctc, lid = build_wav2vec2(dev)
    c = ctc.config
    n_params = sum(t.numel() for t in loading.flatten(ctc.params).values())
    print(f"[wav2vec2] {c.num_hidden_layers} x {c.hidden_size} ({c.num_attention_heads} heads, "
          f"ffn {c.intermediate_size}), frontend {len(c.conv_dim)} x {c.conv_dim[0]} "
          f"({c.feat_extract_norm} norm), stable LN {c.do_stable_layer_norm}, CTC vocabulary "
          f"{c.vocab_size}, LID {W2V_LABELS} labels: {n_params / 1e6:.1f} M parameters in f32 "
          f"built on the card ({smi})")
    out["params"] = n_params
    parts["build"] = time.perf_counter() - t_phase
    out.update(w2v_runs(ctc, lid))
    parts["runs"] = time.perf_counter() - t_phase
    out["card_vs_cpu"] = w2v_card_vs_cpu(ctc)
    parts["card vs CPU"] = time.perf_counter() - t_phase
    out["http"] = w2v_http(ctc, lid)
    out["peak_gb"] = peak_gb()
    out["seconds"] = parts["http"] = time.perf_counter() - t_phase
    print(f"[wav2vec2] peak device memory {out['peak_gb']:.2f} GB; the phase "
          f"{out['seconds']:.1f} s (seconds from its start at the end of each part: "
          f"{json.dumps({k: round(v, 1) for k, v in parts.items()})}) ({smi})")
    del ctc, lid
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moss_main(smi: str) -> int:
    """``--moss``: the [moss] phase alone, then its JSON and kernels 1 and
    7's MOSS fields as one line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k = moss_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"moss": out, "kernels": k}, default=str))
    return 0


def wav2vec2_main(smi: str) -> int:
    """``--wav2vec2``: the [wav2vec2] phase alone (no kernel build), then its
    JSON as one line (no "ok" line: not the full check)."""
    import torch

    t0 = time.perf_counter()
    out = wav2vec2_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"wav2vec2": out}, default=str))
    return 0


def kvq_main(smi: str) -> int:
    """``--kvq``: the [whisper kvq] phase alone on freshly built
    whisper-large-v3 models, then its JSON and kernel 2's fields as one
    line (no "ok" line: not the full check)."""
    import numpy as np
    import torch

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.stt import whisper as W
    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    cfg, models = build_models(dev)
    audio = load_audio(str(AUDIO), sample_rate=16000)[0]
    audio = np.pad(audio, (0, W.CHUNK_LENGTH_SAMPLES - audio.shape[0]))
    out, k2 = whisper_kvq_phase(models, cfg, audio, dev, smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"whisper_kvq": out, "kernel2": k2}))
    return 0


def vyvo_main(smi: str) -> int:
    """``--vyvo``: the [vyvo] phase alone, then its JSON and kernels 5, 6
    and 7's VyvoTTS fields as one line (no "ok" line: not the full check)."""
    import torch

    from tpu_audio_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    out, k = vyvo_phase(torch.device("cuda", 0), smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"vyvo": out, "kernels": k}))
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
    if sys.argv[1:] not in ([], ["--qmm"], ["--qwen3"], ["--clone"], ["--parakeet"], ["--vad"],
                            ["--turn-lid"], ["--sts"], ["--kvq"], ["--vyvo"],
                            ["--qwen3-asr"], ["--cohere"], ["--moss"], ["--wav2vec2"]) \
            and not timing:
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
    if sys.argv[1:] == ["--qwen3"]:
        return qwen3_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--clone"]:
        return clone_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--parakeet"]:
        return parakeet_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--vad"]:
        return vad_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--turn-lid"]:
        return turn_lid_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--sts"]:
        return sts_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--kvq"]:
        return kvq_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--vyvo"]:
        return vyvo_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--qwen3-asr"]:
        return qwen3_asr_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--cohere"]:
        return cohere_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--moss"]:
        return moss_main(smi.splitlines()[0])
    if sys.argv[1:] == ["--wav2vec2"]:
        return wav2vec2_main(smi.splitlines()[0])
    if timing:
        return timing(smi.splitlines()[0], [Path(a).resolve() for a in sys.argv[2:]])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # whisper-large-v3's seed-0 weights are drawn on the host (numpy, in the
    # JAX package's order: ~30 s) on a thread while nvcc builds the kernels;
    # build_models moves them to the card
    drawn = {}
    drawer = threading.Thread(target=lambda: drawn.update(params=W.init_params(
        stack_config(), seed=0, dtype=torch.bfloat16, device="cpu")), daemon=True)
    drawer.start()
    # seconds of each phase (its checks included), from the previous mark
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    t0 = time.perf_counter()
    _lib.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_lib.build_seconds if _lib.build_seconds is not None else 0:.2f} s)")
    drawer.join()
    print(f"whisper-large-v3's weights drawn on the host {time.perf_counter() - t0:.2f} s after "
          f"the build started")
    lap("build")

    # phase 15 first: late in this process torch.profiler loses device
    # events, and kernel 7's short calls then read "not measured"
    records = qmm_phase(dev)
    lap("qmm")
    # the [qwen3 tts] phase next, early for the same reason: it reads kernel
    # 7's device time a frame from the profiler; [qwen3 clone] on its 8-bit
    # model, then [mimi], read device time from the profiler too
    qwen3, qwen3_k7, clone_k1 = qwen3_phase(dev, smi.splitlines()[0], clone=True)
    for k, fields in qwen3_k7.items():
        records[k].update(fields)
    lap("qwen3 tts, serve, clone")
    mimi = mimi_phase(dev, smi.splitlines()[0])
    lap("mimi")
    # the [parakeet] phase next, early too: it reads the decode loop's busy
    # share from the profiler
    parakeet, parakeet_k7 = parakeet_phase(dev, smi.splitlines()[0])
    for k, fields in parakeet_k7.items():
        records[k].update(fields)
    lap("parakeet")
    # the [vad] phase next, early too: it reads device time a chunk from the
    # profiler (no kernel of the port runs there)
    vad = vad_phase(dev, smi.splitlines()[0])
    lap("vad")
    # the [vad turn lid] phase next, early for the same reason: SmartTurn's
    # kernel-1 launches and every model's device time come from the profiler
    turn_lid, turn_lid_k1 = turn_lid_phase(dev, smi.splitlines()[0])
    lap("vad turn lid")
    # the [sts] phase next, early for the same reason: its device ms a call
    # and a streamed chunk come from the profiler (no kernel of the port runs
    # there)
    sts = sts_phase(dev, smi.splitlines()[0])
    lap("sts")
    # the [vyvo] phase next, early too: its TTFB phase reads kernel 7's device
    # time a token from the profiler; kernels 5 and 6's fields wait for their
    # records
    vyvo, vyvo_k = vyvo_phase(dev, smi.splitlines()[0])
    records["quantized_matvec"].update(vyvo_k["quantized_matvec"])
    lap("vyvo")
    # the [qwen3 asr] phase next, early too: its decode profile reads kernel
    # 7's device time a token; kernel 1's fields wait for its record
    qwen3_asr, asr_k = qwen3_asr_phase(dev, smi.splitlines()[0])
    for k in ("quantized_matvec", "quantized_matvec_tile"):
        records[k].update(asr_k[k])
    lap("qwen3 asr, align")
    # the [cohere] phase next, early too: its decode profile reads kernel 7's
    # device time a token
    cohere, cohere_k = cohere_phase(dev, smi.splitlines()[0])
    for k in ("quantized_matvec", "quantized_matvec_tile"):
        records[k].update(cohere_k[k])
    lap("cohere")
    # the [moss] phase next, early too: its decode profile reads kernel 7's
    # device time a token; kernel 1's fields wait for its record
    moss, moss_k = moss_phase(dev, smi.splitlines()[0])
    for k in ("quantized_matvec", "quantized_matvec_tile"):
        records[k].update(moss_k[k])
    lap("moss")
    # the [wav2vec2] phase next, early too: its trace and device times come
    # from the profiler (no kernel of the port runs there)
    wav2vec2 = wav2vec2_phase(dev, smi.splitlines()[0])
    lap("wav2vec2")

    t0 = time.perf_counter()
    cfg, models = build_models(dev, drawn.pop("params"))
    torch.cuda.synchronize()
    print(f"whisper-large-v3 built on the card in {time.perf_counter() - t0:.1f} s")
    lap("whisper build")

    audio, sr = load_audio(str(AUDIO), sample_rate=16000)
    speech = audio
    audio = np.pad(audio, (0, W.CHUNK_LENGTH_SAMPLES - audio.shape[0]))
    seconds = audio.shape[0] / sr
    rng = np.random.default_rng(0)
    clips = serve_clips(speech, rng)

    kernel_records, enc = kernel_phases(models, cfg, audio, dev)
    records.update(kernel_records)
    records["fused_log_mel"].update(turn_lid_k1)
    records["fused_log_mel"].update(clone_k1)
    records["fused_log_mel"].update(asr_k["fused_log_mel"])
    records["fused_log_mel"].update(moss_k["fused_log_mel"])
    w8 = models["w8_kv8d"]
    records["fused_stack_lanes"] = lanes_phase(w8, cfg, lane_encoders(w8, enc, clips, rng),
                                               dev)
    records["fused_stack_lanes"].update(fused_lanes_phase(dev))
    lap("whisper kernels, lanes")
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
    lap("whisper generate")

    # -- long-form: a 240 s file's batched windows (w8 w8e kv8d), bf16 routes --
    longform, long_launches = longform_phase(models, cfg, dev, smi.splitlines()[0])
    for k in ("fused_log_mel", "fused_stack_lanes", "decode_attention_int8"):
        check(long_launches[k] > 0, f"kernel {k} not launched on the long-form path")
        records[k]["longform_launches"] = long_launches[k]
    records["decode_attention_int8"]["longform"] = longform["kv_heads"]
    lap("whisper longform")

    # -- the serving path: ContinuousSTT over the w8 model --------------------
    serve, serve_launches = serve_phase(w8, clips)
    records["fused_stack_lanes"]["launches"] = serve_launches["fused_stack_lanes"]
    throughput = throughput_phase(w8, (rng.standard_normal(W.CHUNK_LENGTH_SAMPLES)
                                       * 0.1).astype(np.float32))
    http = http_phase(w8, clips)
    lap("whisper serve")

    # -- the quantized self caches: [whisper kvq] on the same two models ------
    kvq, kvq_k2 = whisper_kvq_phase(models, cfg, audio, dev, smi.splitlines()[0])
    records["decode_attention_int8"].update(kvq_k2)
    lap("whisper kvq")

    for cfg_name, model in models.items():
        profile_window(cfg_name, model, audio, gp)
    whisper_q4 = build_whisper_q4(models["bf16_kv8d"].params, cfg, dev)  # for phase 17
    del models, model, w8, outputs, enc
    gc.collect()
    torch.cuda.empty_cache()
    lap("whisper profile")

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
    lap("orpheus")

    # -- Orpheus serving: kernel 6 and ContinuousTTS over the same model ------
    records["fused_llama_stack_lanes"] = llama_lanes_phase(orpheus, dev)
    tts_serve, tts_serve_launches = tts_serve_phase(orpheus)
    records["fused_llama_stack_lanes"]["launches"] = tts_serve_launches["fused_llama_stack_lanes"]
    for k in ("fused_llama_stack", "fused_llama_stack_lanes"):
        records[k].update(vyvo_k[k])
    tts_serving = dict(serve=tts_serve, throughput=tts_throughput_phase(orpheus),
                       http=tts_http_phase(orpheus),
                       checks=records["fused_llama_stack_lanes"]["checks"])
    del orpheus
    gc.collect()
    torch.cuda.empty_cache()
    lap("orpheus serve")

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
    lap("mlx 4-bit")

    kernels = [dict(name=k, **{f: r[f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "rel_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "dev_ms", "plain_dev_ms")},
        **{f: r[f] for f in ("kernel", "layer_launches", "offsets", "by_lanes", "lane_limit",
                             "longform_launches", "longform",
                             "lane_checks", "by_shape", "by_shape_8bit", "crossover",
                             "rel_err_bf16_x", "rel_err_f16_x", "library_dev_ms", "library_rel_err",
                             "library_error", "gemv_ms", "gemv_dev_ms", "gemv_checks",
                             "gemv_rel_err", "qwen3_launches", "qwen3", "qwen3_serve_launches",
                             "qwen3_serve", "parakeet_launches", "parakeet",
                             "smart_turn_launches", "smart_turn", "speaker_mel_launches",
                             "speaker_mel", "kvq_launches", "kvq_launches_per_step",
                             "vyvo_launches", "vyvo", "vyvo_layer_launches",
                             "qwen3_asr_launches", "qwen3_asr", "qwen3_align_launches",
                             "qwen3_align", "cohere_launches", "cohere", "moss_launches",
                             "moss") if f in r})
        for k, r in records.items()]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"generate": runs, "smi": smi.splitlines()[0]}))
    print(json.dumps({"longform": longform}))
    print(json.dumps({"serve": serve, "throughput": throughput, "http": http}))
    print(json.dumps({"tts": tts}))
    print(json.dumps({"tts_serving": tts_serving}))
    print(json.dumps({"mlx_4bit": mlx}))
    print(json.dumps({"qwen3_tts": qwen3}))
    print(json.dumps({"parakeet": parakeet}))
    print(json.dumps({"vad": vad}))
    print(json.dumps({"turn_lid": turn_lid}))
    print(json.dumps({"sts": sts}))
    print(json.dumps({"mimi": mimi}))
    print(json.dumps({"whisper_kvq": kvq}))
    print(json.dumps({"vyvo": vyvo}))
    print(json.dumps({"qwen3_asr": qwen3_asr}))
    print(json.dumps({"cohere": cohere}))
    print(json.dumps({"moss": moss}, default=str))
    print(json.dumps({"wav2vec2": wav2vec2}, default=str))
    print(json.dumps({"phase_seconds": phase_s,
                      "total_s": round(time.perf_counter() - t_start, 1)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
