"""Speech-enhancement command line on the PyTorch port: wav -> enhanced wav.

Usage: ``python -m tpu_audio_torch.cli.sts in.wav --model <dir> -o out.wav``
(a DeepFilterNet checkpoint), with the flags of ``tpu_audio.cli.sts`` plus
``--device``. ``--mode short`` and ``long`` run ``enhance`` (for
DeepFilterNet ``long`` is ``enhance`` in the JAX package too), ``stream``
writes the hop-by-hop streamer's chunks to disk as they come. Separation
(``--prompt`` and its options: SAM-Audio) and chat (``--text``,
``--system`` and the sampling flags: LFM2-Audio) are not ported yet: any of
their flags stops with a message naming the model.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu-audio-torch-sts", description=__doc__)
    parser.add_argument("audio", nargs="?", default=None)
    parser.add_argument("--model", required=True, help="local model directory")
    parser.add_argument("--mode", default="short", choices=["short", "long", "stream"])
    parser.add_argument("-o", "--output", default="enhanced.wav")
    # SAM-Audio separation and LFM2-Audio chat (not ported yet): each flag
    # defaults to None so that giving any of them stops with a message.
    group = parser.add_argument_group("separation (SAM-Audio, not ported yet)")
    separation = [group.add_argument("--prompt"), group.add_argument("--residual-output"),
                  group.add_argument("--chunk-seconds", type=float),
                  group.add_argument("--overlap-seconds", type=float),
                  group.add_argument("--ode-steps", type=int)]
    group = parser.add_argument_group("chat (LFM2-Audio, not ported yet)")
    chat = [group.add_argument("--text"), group.add_argument("--system"),
            group.add_argument("--max-new-tokens", type=int),
            group.add_argument("--temperature", type=float),
            group.add_argument("--top-k", type=int),
            group.add_argument("--audio-temperature", type=float),
            group.add_argument("--audio-top-k", type=int),
            group.add_argument("--output-text"),
            group.add_argument("--text-only", action="store_true", default=None)]
    parser.add_argument("--device", default="cuda", help="torch device")
    args = parser.parse_args(argv)

    for actions, what in ((separation, "text-prompted separation runs on SAM-Audio "
                                       "(models/sts/sam_audio)"),
                          (chat, "chat runs on LFM2-Audio (models/sts/lfm_audio)")):
        given = [a.option_strings[0] for a in actions if getattr(args, a.dest) is not None]
        if given:
            raise SystemExit(f"{'/'.join(given)}: {what}, not ported yet")
    if args.audio is None:
        parser.error("an input wav is required for enhancement")

    from tpu_audio_torch.core.audio_io import StreamingWAVWriter, load_audio, save_wav
    from tpu_audio_torch.models.sts import load_model

    model = load_model(args.model, device=args.device)
    audio, _ = load_audio(args.audio, sample_rate=model.sample_rate)
    t0 = time.perf_counter()
    if args.mode == "stream":
        with StreamingWAVWriter(args.output, model.sample_rate) as w:
            total = 0
            for chunk in model.enhance_streaming(audio):
                w.append(chunk)
                total += len(chunk)
    else:
        out = model.enhance(audio)
        save_wav(args.output, out, model.sample_rate)
        total = len(out)
    dt = time.perf_counter() - t0
    dur = total / model.sample_rate
    print(f"[sts] {dur:.2f}s audio in {dt:.2f}s ({dur/dt:.1f}x realtime) "
          f"-> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
