"""Chunked autoregressive decode loop (port of tpu_audio.core.ar_loop).

Each step (model step, repetition penalty, sampling, stop detection, token
buffering) is device work; the host only reads a device-side ``finished``
flag every ``SYNC_EVERY`` steps, and the count and tokens once at the end
of a chunk. Steps taken past the stop token before the host sees the flag
change nothing that is returned: the state they would move (tokens,
count, history, last token) is frozen on the device once ``finished`` is
set, and the cache's offset is set back to the last kept step.

Models supply ``step_fn(params, tokens [B, 1], cache) -> (logits [B, V],
cache)``, where ``cache`` is a NamedTuple with an integer ``offset`` that
the step advances by one.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_audio_torch.core.sampling import (SamplingParams, _mask_min_p, _mask_top_k,
                                           _mask_top_p, apply_repetition_penalty)

__all__ = ["make_decode_chunk", "SYNC_EVERY"]

SYNC_EVERY = 8  # steps between host reads of the finished flag


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` (Gumbel-max with uniforms
    from ``generator``); ``-inf`` logits are never drawn."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def _sample(logits: torch.Tensor, sampling: SamplingParams,
            generator: torch.Generator) -> torch.Tensor:
    """The JAX package's three sampling paths: greedy, top-k then nucleus
    in the k-candidate space, or masked sampling over the whole row."""
    if sampling.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if sampling.top_k and sampling.top_k > 0 and sampling.min_p == 0.0:
        vals, idx = torch.topk(logits, min(sampling.top_k, logits.shape[-1]), dim=-1)
        if sampling.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            exceeded = (torch.cumsum(probs, -1) - probs) > sampling.top_p
            vals = vals.masked_fill(exceeded, -torch.inf)
        choice = _categorical(vals / sampling.temperature, generator)
        return torch.gather(idx, 1, choice[:, None])[:, 0]
    masked = logits
    if sampling.top_k and sampling.top_k > 0:
        masked = _mask_top_k(masked, sampling.top_k)
    if sampling.top_p < 1.0:
        masked = _mask_top_p(masked, sampling.top_p)
    if sampling.min_p > 0.0:
        masked = _mask_min_p(masked, sampling.min_p)
    return _categorical(masked / sampling.temperature, generator)


def make_decode_chunk(step_fn: Callable, sampling: SamplingParams,
                      history_size: int = 64, token_map: Callable | None = None):
    """Build a chunked decoder.

    Returns ``decode_chunk(params, cache, last_token [B], tokens_out [N],
    generator, stop_token, history [B, H], hist_pos) -> (tokens [N],
    count, cache, last, finished, generator, history, hist_pos)``: up to
    N new tokens, stopping at the step that emits ``stop_token``.
    ``history`` is the repetition penalty's ring of recent tokens and
    ``hist_pos`` (a 0-d device tensor) its write count, both carried
    across chunks; ``count`` and ``finished`` are host values.

    ``token_map`` maps each sampled logits-space index to the model's
    token id before it is emitted, fed back and compared with the stop
    token (a head restricted to a token band); the history stays in
    logits space.
    """

    def decode_chunk(params, cache, last_token, tokens_out, generator, stop_token,
                     history, hist_pos):
        chunk = tokens_out.shape[0]
        dev = last_token.device
        offset0 = cache.offset
        tokens = tokens_out.clone()
        last = last_token.clone()
        hist = history.clone()
        hpos = hist_pos.clone()
        count = torch.zeros((), dtype=torch.int64, device=dev)
        finished = torch.zeros((), dtype=torch.bool, device=dev)
        slots = torch.arange(history_size, device=dev)
        for i in range(chunk):
            if i and i % SYNC_EVERY == 0 and bool(finished):
                break
            logits, cache = step_fn(params, last[:, None], cache)
            logits = logits.to(torch.float32)
            if sampling.repetition_penalty != 1.0:
                valid = (slots < hpos.clamp(max=history_size))[None, :].expand(
                    hist.shape)
                logits = apply_repetition_penalty(logits, hist, valid,
                                                  sampling.repetition_penalty)
            nxt = _sample(logits, sampling, generator)
            live = ~finished
            wrote = hist.scatter(1, (hpos % history_size).expand(hist.shape[0], 1),
                                 nxt[:, None].to(hist.dtype))
            hist = torch.where(live, wrote, hist)
            hpos = hpos + live
            if token_map is not None:
                nxt = token_map(nxt)
            tokens[i] = torch.where(live, nxt[0].to(tokens.dtype), tokens[i])
            last = torch.where(live, nxt.to(last.dtype), last)
            count = count + live
            finished = finished | (nxt == stop_token).all()
        count = int(count)
        return (tokens, count, cache._replace(offset=offset0 + count), last,
                bool(finished), generator, hist, hpos)

    return decode_chunk
