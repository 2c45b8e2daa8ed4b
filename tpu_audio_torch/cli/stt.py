"""STT command line on the PyTorch port: wav -> text.

Usage: ``python -m tpu_audio_torch.cli.stt audio.wav --model <dir>`` (a
Whisper, Parakeet, Qwen3-ASR, Cohere Transcribe, MOSS-Transcribe-Diarize or
wav2vec2 CTC checkpoint), with the flags of
``tpu_audio.cli.stt`` (``--format txt|srt|json``, ``--stream``,
``--chunk-duration``, ``--kv-bits``, ``--quantized-kv-start``, ...) plus
``--device``. A model ignores the flags it has no use for (Parakeet: the
language, task, temperature and KV flags).

``--stream`` on a model with a streaming core (Qwen3-ASR's
``encode_single_window``, Cohere's ``streaming_decode_token_ids``, MOSS's
``streaming_transcribe_window``) runs the live ``StreamingInferenceSession``
on 1 s feeds: confirmed text as it comes (``--verbose`` also prints each
display update) and a ``[stream] RTF`` line; other models print
``generate_stream``'s text.

With ``TPU_AUDIO_PROFILE=<dir>`` the transcription runs under a
``torch.profiler`` trace labelled ``stt_generate`` (``core.profiling``).

A forced aligner (a directory named like ``Qwen3-ForcedAligner``) aligns
``--text`` to the audio and prints its words with their times as segments
(``--format srt|json``); it takes no ``--stream``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _format_srt_time(t: float) -> str:
    h = int(t // 3600)
    m = int(t % 3600 // 60)
    s = int(t % 60)
    ms = int((t - int(t)) * 1000)
    return f"{h:02}:{m:02}:{s:02},{ms:03}"


def _live_session(model, audio, args):
    """The live session over ``audio`` at 1 s feeds: confirmed text as it
    comes, then the session's RTF and decode passes on stderr."""
    from tpu_audio_torch.core.generation import STTOutput
    from tpu_audio_torch.models.stt.streaming import EventKind, StreamingInferenceSession

    session = StreamingInferenceSession(model, language=args.language)
    chunk = 16000  # 1 s
    confirmed, stats = "", {}

    def consume(events):
        nonlocal confirmed, stats
        for ev in events:
            if ev.kind == EventKind.DISPLAY_UPDATE and args.verbose:
                print(f"[display] {ev.confirmed_text} | {ev.text}", file=sys.stderr)
            elif ev.kind in (EventKind.CONFIRMED, EventKind.ENDED):
                if ev.confirmed_text:
                    print(ev.confirmed_text, flush=True)
                    confirmed = ev.confirmed_text
            elif ev.kind == EventKind.STATS:
                stats = ev.stats

    for s in range(0, len(audio), chunk):
        consume(session.feed_audio(audio[s:s + chunk]))
    consume(session.stop())
    print(f"[stream] RTF {stats.get('real_time_factor', 0):.3f} "
          f"({stats.get('decode_passes', 0)} passes)", file=sys.stderr)
    return STTOutput(text=confirmed, total_time=stats.get("wall_seconds", 0.0),
                     generation_time=stats.get("decode_time", 0.0))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu-audio-torch-stt", description=__doc__)
    parser.add_argument("audio", help="input audio file (wav)")
    parser.add_argument("--model", required=True, help="local model directory")
    parser.add_argument("--language", default=None)
    parser.add_argument("--task", default="transcribe", choices=["transcribe", "translate"])
    parser.add_argument("--max-tokens", type=int, default=448)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--format", default="txt", choices=["txt", "srt", "json"])
    parser.add_argument("--stream", action="store_true", help="stream per-chunk text")
    parser.add_argument("--text", default=None,
                        help="alignment text (required for forced aligner models)")
    parser.add_argument("--chunk-duration", type=float, default=None,
                        help="chunking window in seconds (Parakeet; default 1200)")
    parser.add_argument("--output", default=None, help="write result to file")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--kv-bits", type=int, default=None, choices=[4, 8],
                        help="quantize the decode KV (8 = int8 symmetric, 4 = "
                        "packed affine int4)")
    parser.add_argument("--kv-group-size", type=int, default=64)
    parser.add_argument("--quantized-kv-start", type=int, default=0,
                        help="keep self-cache positions below this index full "
                        "precision (0: quantized self cache; >= the decode "
                        "length: dense self cache)")
    parser.add_argument("--no-batch-windows", action="store_true",
                        help="decode 30 s windows one by one instead of up to 8 "
                        "in one batch; greedy output is the same")
    parser.add_argument("--device", default="cuda", help="torch device")
    args = parser.parse_args(argv)

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.core.generation import STTGenerateParameters
    from tpu_audio_torch.models.stt import load_model

    model = load_model(args.model, device=args.device)
    audio, _sr = load_audio(args.audio, sample_rate=16000)
    params = STTGenerateParameters(
        language=args.language, task=args.task, max_tokens=args.max_tokens,
        temperature=args.temperature, chunk_duration=args.chunk_duration,
        verbose=args.verbose,
        kv_bits=args.kv_bits, kv_group_size=args.kv_group_size,
        quantized_kv_start=args.quantized_kv_start,
        batch_windows=not args.no_batch_windows,
    )
    import contextlib

    from tpu_audio_torch.core.profiling import maybe_trace
    from tpu_audio_torch.models.stt.qwen3_aligner import Qwen3ForcedAligner

    prof = contextlib.ExitStack()
    prof.enter_context(maybe_trace("stt_generate", device=args.device))
    if isinstance(model, Qwen3ForcedAligner):
        if args.stream:
            parser.error("--stream is not supported for forced aligner models")
        if not args.text:
            parser.error("--text is required when using a forced aligner model")
        from tpu_audio_torch.core.generation import STTOutput, STTSegment

        aligned = model.generate(audio, text=args.text, language=args.language or "English")
        output = STTOutput(
            text=aligned.text,
            segments=[STTSegment(text=i.text, start=i.start_time, end=i.end_time)
                      for i in aligned.items],
            language=args.language, prompt_token_count=aligned.prompt_tokens,
            total_time=aligned.total_time, generation_time=aligned.total_time)
    elif args.stream and (hasattr(model, "encode_single_window")
                          or hasattr(model, "streaming_decode_token_ids")
                          or hasattr(model, "streaming_transcribe_window")):
        output = _live_session(model, audio, args)
    elif args.stream:
        output = None
        for event in model.generate_stream(audio, params):
            if event["type"] == "token":
                print(event["text"], end=" ", flush=True)
            elif event["type"] == "result":
                output = event["output"]
        print()
    else:
        output = model.generate(audio, params)
    prof.close()

    if args.format == "txt":
        text = output.text
    elif args.format == "srt":
        lines = []
        for i, seg in enumerate(output.segments, 1):
            lines += [str(i), f"{_format_srt_time(seg.start)} --> "
                      f"{_format_srt_time(seg.end)}", seg.text, ""]
        text = "\n".join(lines)
    else:
        text = json.dumps({
            "text": output.text,
            "language": output.language,
            "segments": [{"text": s.text, "start": s.start, "end": s.end}
                         for s in output.segments],
        }, indent=2)

    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    if not args.stream or args.format != "txt":
        print(text)
    print(
        f"[stt] {output.generation_token_count} tokens in {output.total_time:.2f}s "
        f"({output.generation_tps:.1f} tok/s, audio {len(audio)/16000:.1f}s, "
        f"RTF {output.total_time/(len(audio)/16000):.3f})",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
