"""TTS command line: text -> wav (port of tpu_audio.cli.tts).

Usage: ``python -m tpu_audio_torch.cli.tts "Hello" --model <dir> -o out.wav``
for an Orpheus or a Qwen3-TTS checkpoint. A Qwen3-TTS ``--voice`` is a
speaker ("vivian"), a speaker and an instruction ("vivian, speak slowly")
or, for a ``voice_design`` checkpoint, the design prompt; its codec is the
checkpoint's ``speech_tokenizer/``, and ``--max-tokens`` counts 12.5 Hz
frames.
(``--quantize w8a8 --band-head`` is the Orpheus deployment configuration:
int8 weights decoded through the fused kernel, the head cut to the audio
band; ``--quantize 4|8`` quantizes a full-precision checkpoint to MLX
grouped-affine 4/8-bit, the layout of the reference's own Orpheus
checkpoints, which load as they are). ``--stream`` writes the audio as it is generated; ``--benchmark``
reports the time to the first audio (TTFB) and the real-time multiple.
``--timestamps [ALIGNER]`` then aligns the text to the written audio with a
Qwen3 forced aligner checkpoint and prints each word's times. Runs on
``cuda`` unless ``--device`` says otherwise (the aligner too). With
``TPU_AUDIO_PROFILE=<dir>`` the generation runs under a ``torch.profiler``
trace labelled ``tts_generate`` (``core.profiling``).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu-audio-torch-tts", description=__doc__)
    parser.add_argument("text")
    parser.add_argument("--model", required=True)
    parser.add_argument("--voice", default=None)
    parser.add_argument("--language", default=None,
                        help="language hint forwarded to the model")
    parser.add_argument("--ref-audio", default=None, help="reference wav for cloning")
    parser.add_argument("--ref-text", default=None, help="transcript of --ref-audio")
    parser.add_argument("--codec", default=None, help="codec directory override")
    parser.add_argument("-o", "--output", default="output.wav")
    parser.add_argument("--max-tokens", type=int, default=1200)
    parser.add_argument("--temperature", type=float, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--stream", action="store_true",
                        help="write audio incrementally as it is generated")
    parser.add_argument("--benchmark", action="store_true",
                        help="report TTFB and RTFx from the stream")
    parser.add_argument("--timestamps", nargs="?", default=None,
                        const="mlx-community/Qwen3-ForcedAligner-0.6B-4bit",
                        metavar="ALIGNER",
                        help="word timestamps of the generated audio (a Qwen3 forced "
                             "aligner checkpoint)")
    parser.add_argument("--raw-ipa", action="store_true",
                        help="treat the input text as raw IPA phonemes")
    parser.add_argument("--quantize", choices=("4", "8", "w8a8"), default=None,
                        help="post-load quantization: 4/8 = MLX grouped-affine, "
                             "w8a8 = per-channel int8")
    parser.add_argument("--band-head", action="store_true",
                        help="decode with the head sliced to the audio token band "
                             "+ EOS (Orpheus-family)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    import numpy as np

    from tpu_audio_torch.core.audio_io import StreamingWAVWriter, load_audio, save_wav
    from tpu_audio_torch.core.generation import AudioGenerationKind
    from tpu_audio_torch.models.tts import load_model

    kwargs = {"device": args.device}
    if args.codec:
        kwargs["snac_repo"] = args.codec
    if args.band_head:
        kwargs["audio_band_head"] = True
    if args.quantize:
        kwargs["quantize_bits"] = (args.quantize if args.quantize == "w8a8"
                                   else int(args.quantize))
    try:
        model = load_model(args.model, **kwargs)
    except TypeError as e:
        for flag, kwarg in (("--band-head", "audio_band_head"), ("--codec", "snac_repo")):
            if "unexpected keyword argument" in str(e) and repr(kwarg) in str(e):
                raise SystemExit(f"{flag} is for the Orpheus-family models (llama_tts); "
                                 "this model does not take it") from e
        raise
    if args.raw_ipa and hasattr(model, "text_processor"):
        model.text_processor = None
    params = model.default_generation_parameters()
    params.max_tokens = args.max_tokens
    if args.temperature is not None:
        params.temperature = args.temperature
    if args.top_p is not None:
        params.top_p = args.top_p
    if args.seed is not None:
        params.seed = args.seed

    ref_audio = None
    if args.ref_audio:
        ref_audio, _ = load_audio(args.ref_audio, sample_rate=model.sample_rate)

    import contextlib

    from tpu_audio_torch.core.profiling import maybe_trace

    prof = contextlib.ExitStack()
    prof.enter_context(maybe_trace("tts_generate", device=args.device))
    if args.stream or args.benchmark:
        t0 = time.perf_counter()
        ttfb = None
        total_samples = 0
        info = None
        with StreamingWAVWriter(args.output, model.sample_rate) as writer:
            for ev in model.generate_stream(
                    args.text, voice=args.voice, ref_audio=ref_audio,
                    ref_text=args.ref_text, language=args.language,
                    generation_parameters=params):
                if ev.kind == AudioGenerationKind.AUDIO:
                    if ttfb is None:
                        ttfb = time.perf_counter() - t0
                    writer.append(ev.audio)
                    total_samples += len(ev.audio)
                elif ev.kind == AudioGenerationKind.INFO:
                    info = ev.info
        wall = time.perf_counter() - t0
        dur = total_samples / model.sample_rate
        rtfx = dur / wall if wall else 0.0
        print(f"[tts] {dur:.2f}s audio -> {args.output}", file=sys.stderr)
        if args.benchmark:
            ttfb_s = f"{ttfb:.3f}s" if ttfb is not None else "none (no audio)"
            print(f"[bench] TTFB {ttfb_s}  RTFx {rtfx:.2f}x  wall {wall:.2f}s"
                  + (f"  tok/s {info.tokens_per_second:.1f}" if info else ""),
                  file=sys.stderr)
    else:
        t0 = time.perf_counter()
        audio = model.generate(args.text, voice=args.voice, ref_audio=ref_audio,
                               ref_text=args.ref_text, language=args.language,
                               generation_parameters=params)
        wall = time.perf_counter() - t0
        save_wav(args.output, np.asarray(audio), model.sample_rate)
        dur = len(audio) / model.sample_rate
        print(f"[tts] {dur:.2f}s audio in {wall:.2f}s (RTFx {dur / wall:.2f}x) -> "
              f"{args.output}", file=sys.stderr)
    prof.close()

    if args.timestamps:
        from tpu_audio_torch.core.audio_io import resample_audio
        from tpu_audio_torch.models.stt import load_model as load_stt

        aligner = load_stt(args.timestamps, device=args.device)
        wav, sr = load_audio(args.output)
        aligned = aligner.generate(resample_audio(wav, sr, 16000), text=args.text,
                                   language="English")
        print("Timestamps:")
        for item in aligned.items:
            print(f"  [{item.start_time:.3f}s - {item.end_time:.3f}s] {item.text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
