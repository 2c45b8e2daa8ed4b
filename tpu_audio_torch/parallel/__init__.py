"""Serving engines (port of tpu_audio.parallel: continuous batching)."""
