"""Language-ID command line on the PyTorch port: wav -> top-k languages.

Usage: ``python -m tpu_audio_torch.cli.lid audio.wav --model <dir>`` (an
ECAPA-TDNN or MMS-LID wav2vec2 checkpoint), with the flags of ``tpu_audio.cli.lid``
(``--top-k``) plus ``--device``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tpu-audio-torch-lid", description=__doc__)
    parser.add_argument("audio")
    parser.add_argument("--model", required=True, help="local model directory")
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="torch device")
    args = parser.parse_args(argv)

    from tpu_audio_torch.core.audio_io import load_audio
    from tpu_audio_torch.models.lid import load_model

    model = load_model(args.model, device=args.device)
    audio, _ = load_audio(args.audio, sample_rate=16000)
    out = model.predict(audio, top_k=args.top_k)
    print(f"language: {out.language} ({out.confidence:.3f})")
    for p in out.top_languages:
        print(f"  {p.language:>16}  {p.confidence:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
