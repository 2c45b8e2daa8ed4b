"""STT command line on the PyTorch port: wav -> text.

Usage: ``python -m tpu_audio_torch.cli.stt audio.wav --model <dir>``, with
the flags of ``tpu_audio.cli.stt`` (``--format txt|srt|json``, ``--stream``,
``--kv-bits``, ``--quantized-kv-start``, ...) plus ``--device``.
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
    parser.add_argument("--output", default=None, help="write result to file")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--kv-bits", type=int, default=None, choices=[4, 8],
                        help="quantize the decode KV (8 = int8 symmetric; 4 is "
                        "not ported yet)")
    parser.add_argument("--kv-group-size", type=int, default=64)
    parser.add_argument("--quantized-kv-start", type=int, default=0,
                        help="keep self-cache positions below this index full "
                        "precision (>= the decode length: dense self cache)")
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
        temperature=args.temperature, verbose=args.verbose,
        kv_bits=args.kv_bits, kv_group_size=args.kv_group_size,
        quantized_kv_start=args.quantized_kv_start,
        batch_windows=not args.no_batch_windows,
    )
    if args.stream:
        output = None
        for event in model.generate_stream(audio, params):
            if event["type"] == "token":
                print(event["text"], end=" ", flush=True)
            elif event["type"] == "result":
                output = event["output"]
        print()
    else:
        output = model.generate(audio, params)

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
