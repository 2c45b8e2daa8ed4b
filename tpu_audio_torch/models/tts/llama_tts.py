"""LlamaTTS (Orpheus): a Llama-3 decoder emitting 7-token SNAC frames
(port of tpu_audio.models.tts.llama_tts).

Special-token prompt framing, 7-token frame (un)grouping to the 3 SNAC
layers, voice prefixes, reference-audio cloning through ``SNAC.encode``,
and temperature / top-p / repetition-penalty sampling through the chunked
decode loop of ``core.ar_loop``. ``audio_band_head`` restricts the decode
head to the 7 x 4096 audio band plus ``end_of_speech``.

A w8a8 tree of a shape ``ops.fused_llama.supported`` takes decodes every
token through ``fused_llama_stack`` (the CUDA kernel on the card, its plain
version on the CPU); on the card any other w8a8 tree raises rather than
decode without the kernel. The prefill, a dense tree and an MLX 4/8-bit
tree (a checkpoint's ``quantization``, or ``quantize_bits=4|8``) run
``llama.forward``; on an MLX tree every projection and the head of a step
or of the prefill's 63 rows run the grouped-affine GEMV kernel
(``ops.qmm``), and the residual stream is f32 from the packed embedding
on, as in the JAX package. The fused cache holds the whole request
(``max_total`` rows), so the JAX package's mid-generation hand-off to its
XLA loop (a TPU VMEM cap) has no counterpart here. ``_fused_lane_hooks`` gives the serving
engine (``parallel.continuous.ContinuousTTS``) the same route for every
live lane at once, through ``fused_llama_stack_lanes``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tpu_audio_torch.core import hub, loading, nn, quant
from tpu_audio_torch.core.ar_loop import make_decode_chunk
from tpu_audio_torch.core.generation import (AudioGenerateParameters, AudioGeneration,
                                             AudioGenerationError, AudioGenerationInfo)
from tpu_audio_torch.core.kv_cache import FusedLaneRow, KVCache
from tpu_audio_torch.core.sampling import SamplingParams
from tpu_audio_torch.models import llama
from tpu_audio_torch.ops import fused_llama as FL

__all__ = ["LlamaTTS", "LlamaTTSConfig", "OrpheusTokens", "FusedDecodeKV",
           "group_codes", "ungroup_codes"]


class FusedDecodeKV(NamedTuple):
    """Decode state of the fused route: position-major ``[L, S, dkv]``
    caches (K after RoPE), the write offset and the left-pad bound."""

    k: torch.Tensor
    v: torch.Tensor
    offset: int
    valid_from: int


@dataclass(frozen=True)
class OrpheusTokens:
    """Orpheus special token ids."""

    start_of_human: int = 128259
    end_of_human: int = 128260
    end_of_text: int = 128009
    start_of_speech: int = 128257
    end_of_speech: int = 128258
    pad_token: int = 128263
    audio_start: int = 128261
    audio_end: int = 128262
    audio_token_offset: int = 128266
    codebook_size: int = 4096


@dataclass
class LlamaTTSConfig(llama.LlamaConfig):
    sample_rate: int = 24000
    snac_repo: str = "mlx-community/snac_24khz"
    quantization: dict | None = None


def ungroup_codes(code_list: list[int], codebook_size: int = 4096):
    """7-token frames -> the 3 SNAC layers."""
    l1, l2, l3 = [], [], []
    for g in range(len(code_list) // 7):
        b = 7 * g
        l1.append(code_list[b])
        l2.append(code_list[b + 1] - codebook_size)
        l3.append(code_list[b + 2] - 2 * codebook_size)
        l3.append(code_list[b + 3] - 3 * codebook_size)
        l2.append(code_list[b + 4] - 4 * codebook_size)
        l3.append(code_list[b + 5] - 5 * codebook_size)
        l3.append(code_list[b + 6] - 6 * codebook_size)
    return l1, l2, l3


def group_codes(l1, l2, l3, codebook_size: int = 4096) -> list[int]:
    """The 3 SNAC layers -> interleaved 7-token frames."""
    out = []
    for i in range(len(l1)):
        out += [int(l1[i]), int(l2[2 * i]) + codebook_size,
                int(l3[4 * i]) + 2 * codebook_size, int(l3[4 * i + 1]) + 3 * codebook_size,
                int(l2[2 * i + 1]) + 4 * codebook_size,
                int(l3[4 * i + 2]) + 5 * codebook_size,
                int(l3[4 * i + 3]) + 6 * codebook_size]
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class LlamaTTS:
    """Orpheus-style TTS with ``generate`` / ``generate_stream``."""

    def __init__(self, config: LlamaTTSConfig, params: dict, tokenizer=None,
                 codec=None, tokens: OrpheusTokens = OrpheusTokens(),
                 dtype=torch.bfloat16, audio_band_head: bool = False):
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.codec = codec
        self.tokens = tokens
        self.dtype = dtype
        self.audio_band_head = bool(audio_band_head)
        self._decoders: dict = {}
        self._fused_pack = None
        cfg = config
        self._token_map = None
        if self.audio_band_head:
            # the decode head restricted to the 7 x codebook audio band and
            # end_of_speech: past start_of_speech only those ids are kept
            # (parse_output), and the full head would stream the whole
            # vocabulary every token
            T = tokens
            rows = np.concatenate([T.audio_token_offset + np.arange(7 * T.codebook_size),
                                   [T.end_of_speech]])
            if cfg.vocab_size <= int(rows.max()):
                raise ValueError(
                    f"audio_band_head needs vocab_size > {int(rows.max())} "
                    f"(got {cfg.vocab_size}); the token table does not cover "
                    "the audio band")
            head = (params["lm_head"] if "lm_head" in params and not cfg.tie_word_embeddings
                    else params["model"]["embed_tokens"])
            self.params = dict(params)
            self.params["band_head"] = quant.slice_rows(head, rows)
            if "lm_head" in self.params and not cfg.tie_word_embeddings:
                del self.params["lm_head"]  # band-mode prefill returns hidden states
            band_size = 7 * T.codebook_size

            def token_map(idx):
                return torch.where(idx >= band_size,
                                   torch.full_like(idx, T.end_of_speech),
                                   idx + T.audio_token_offset)

            self._token_map = token_map

    # -- steps ----------------------------------------------------------------

    def _head(self, params, h):
        cfg = self.config
        if self.audio_band_head:
            logits = nn.linear(params["band_head"], h)
        elif "lm_head" in params and not cfg.tie_word_embeddings:
            logits = nn.linear(params["lm_head"], h)
        else:
            logits = nn.embedding_as_linear(params["model"]["embed_tokens"], h)
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
        return logits

    def _prefill(self, params, ids, cache):
        # band mode: hidden states only (the full-vocab logits over the
        # prompt would be discarded)
        return llama.forward(params, ids, cache, self.config,
                             return_hidden=self.audio_band_head)

    def _step_fn(self, params, tok, cache):
        """One token through ``llama.forward`` (the dense or plain route)."""
        if self.audio_band_head:
            hidden, cache = llama.forward(params, tok, cache, self.config,
                                          return_hidden=True)
            return self._head(params, hidden[:, -1]), cache
        logits, cache = llama.forward(params, tok, cache, self.config)
        return logits[:, -1], cache

    def _fused_step_fn(self, params, tok, fc: FusedDecodeKV):
        """One token through ``fused_llama_stack``, then the final norm and
        the head."""
        cfg = self.config
        x = nn.embedding(params["model"]["embed_tokens"], tok[:, 0])
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        y, _, _ = FL.fused_llama_stack(params["fused_pack"], fc.k, fc.v,
                                       x[0].to(torch.float32), fc.offset, cfg=cfg,
                                       valid_from=fc.valid_from)
        h = nn.rms_norm(params["model"]["norm"], y[None].to(self.dtype), cfg.rms_norm_eps)
        return (self._head(params, h).to(torch.float32),
                fc._replace(offset=fc.offset + 1))

    def _fused_cache(self, max_len: int, valid_from: int) -> tuple[KVCache, FusedDecodeKV]:
        """The fused route's one cache: the kernel's position-major ``[L,
        S, n_kv * hd]`` buffers, and the ``[L, 1, n_kv, S, hd]`` views of
        them that ``llama.forward``'s prefill writes (K after RoPE, as the
        kernel reads it). The decode state takes the prefill's offset."""
        cfg = self.config
        L, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
        k, v = (torch.zeros((L, max_len, n_kv * hd), dtype=self.dtype, device=self.device)
                for _ in range(2))

        def heads(t):
            return t.view(L, max_len, n_kv, hd).permute(0, 2, 1, 3).unsqueeze(1)

        return (KVCache(heads(k), heads(v), 0, valid_from),
                FusedDecodeKV(k, v, 0, valid_from))

    def _fused_lane_hooks(self, max_len: int) -> dict | None:
        """Engine pieces routing :class:`parallel.continuous.ContinuousTTS`
        ticks through ``fused_llama_stack_lanes`` (one sweep of the int8
        weights a decode step, shared by every live lane; one call per
        group past the kernel's lane limit), for ``ContinuousBatcher``.
        None for a tree the fused kernels do not take; raises where the
        lanes kernel does not take the shape (``FL.supported_lanes``) or a
        cache of ``max_len`` rows (``FL.LANES_S_MAX``).

        - ``cache_factory(slots)``: ``kv_cache.FusedLaneRow`` stacked
          ``[slots, L, max_len, dkv]`` position-major, with the lanes'
          offsets and ``valid_from`` on the device;
        - ``prefill_fn``: ``llama.forward(return_hidden=True)`` writing
          straight into the lane's slot through head-major strided views of
          its buffers (as :meth:`_fused_cache` does offline);
        - ``batch_step_fn``: embed the lanes' tokens, the kernel over the
          lane groups, the final RMSNorm and the band or full head."""
        if not self._fused_supported():
            return None
        cfg = self.config
        L, n_kv, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
        dev, dtype = self.device, self.dtype
        if not FL.supported_lanes(cfg, 1) or max_len > FL.LANES_S_MAX:
            raise NotImplementedError(
                f"fused_llama_stack_lanes takes no lane of this shape over a {max_len}-row "
                f"cache (at most {FL.LANES_S_MAX} rows; see ops.fused_llama.supported_lanes)")
        pack = self.fused_decoder_pack()
        group = max(g for g in range(1, FL.MAX_LANES + 1) if FL.supported_lanes(cfg, g))

        def batch_step_fn(params, cache, lanes, last, offsets, ctx):
            x = nn.embedding(params["model"]["embed_tokens"], last)
            if cfg.embedding_multiplier != 1.0:
                x = x * cfg.embedding_multiplier
            valid_from = cache.valid_from.index_select(0, lanes)
            y = torch.cat([FL.fused_llama_stack_lanes(
                pack, cache.k, cache.v, lanes[i:i + group], x[i:i + group],
                offsets[i:i + group], valid_from[i:i + group], cfg=cfg)[0]
                for i in range(0, last.shape[0], group)])
            h = nn.rms_norm(params["model"]["norm"], y.to(dtype), cfg.rms_norm_eps)
            return self._head(params, h).to(torch.float32)

        def prefill_fn(params, cache, slot, ids, valid_from, ctx):
            def heads(t):
                return t.view(L, max_len, n_kv, hd).permute(0, 2, 1, 3).unsqueeze(1)

            row = KVCache(heads(cache.k[slot]), heads(cache.v[slot]), 0, int(valid_from))
            ids = torch.from_numpy(ids.astype(np.int64)).to(dev)[None]
            _, row = llama.forward(params, ids, row, cfg, return_hidden=True)
            cache.valid_from[slot] = int(valid_from)
            return row.offset

        def cache_factory(slots):
            def zeros(dt, *shape):
                return torch.zeros(shape, dtype=dt, device=dev)

            return FusedLaneRow(k=zeros(dtype, slots, L, max_len, n_kv * hd),
                                v=zeros(dtype, slots, L, max_len, n_kv * hd),
                                offset=zeros(torch.int64, slots),
                                valid_from=zeros(torch.int64, slots))

        return dict(params=self.params, batch_step_fn=batch_step_fn, prefill_fn=prefill_fn,
                    cache_factory=cache_factory)

    # -- loading --------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        w = self.params["model"]["embed_tokens"]["weight"]
        return (w.weight.device if isinstance(w, (quant.Int8Tensor, quant.QuantizedTensor))
                else w.device)

    @classmethod
    def from_pretrained(cls, repo_or_path: str, codec=None, snac_repo: str | None = None,
                        dtype=torch.bfloat16, quantize_bits: int | str | None = None,
                        audio_band_head: bool = False, device="cuda") -> "LlamaTTS":
        """Load a local checkpoint directory onto ``device``. A checkpoint
        with ``quantization`` in its config is MLX grouped-affine 4/8-bit
        (its packed triples become ``quant.QuantizedTensor`` leaves, and
        ``quantize_bits`` is ignored, as in the JAX package); otherwise
        ``quantize_bits=4|8`` quantizes every eligible weight that way
        (group size 64), and ``quantize_bits="w8a8"`` stores them as
        per-channel int8, which routes decode through the fused kernel. Off
        the fused route, q/k/v and gate/up are fused into one product
        each."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir)
        config = LlamaTTSConfig.from_dict(cfg_dict)
        config.quantization = cfg_dict.get("quantization")
        params = load_tree(model_dir, config, dtype, quantize_bits, device)
        tokens = OrpheusTokens()
        if config.vocab_size < tokens.audio_token_offset:
            if cfg_dict.get("audio_token_offset") is None:
                raise ValueError("vocab smaller than the Orpheus token table; set "
                                 "audio_token_offset etc. in config.json")
            tokens = config_tokens(cfg_dict)
        if codec is None:
            codec = snac_beside(snac_repo or config.snac_repo, device)
        return cls(config, params, load_tokenizer(model_dir), codec, tokens, dtype,
                   audio_band_head=audio_band_head)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def default_generation_parameters(self) -> AudioGenerateParameters:
        return AudioGenerateParameters(max_tokens=1200, temperature=0.6, top_p=0.8,
                                       repetition_penalty=1.3, repetition_context_size=20)

    # -- prompt framing and parsing ---------------------------------------------

    def prepare_input_ids(self, text: str, voice: str | None = None,
                          ref_audio=None, ref_text: str | None = None) -> list[int]:
        T = self.tokens
        prompt = f"{voice}: {text}" if voice else text
        ids = list(self.tokenizer.encode(prompt).ids)
        parts = []
        if ref_audio is not None and ref_text is not None:
            if self.codec is None:
                raise AudioGenerationError("SNAC codec required for ref audio")
            codes = self.codec.encode(np.asarray(ref_audio, np.float32))
            l1, l2, l3 = (c[0].tolist() for c in codes[:3])
            audio_ids = [c + T.audio_token_offset
                         for c in group_codes(l1, l2, l3, T.codebook_size)]
            ref_ids = list(self.tokenizer.encode(ref_text).ids)
            parts += [T.start_of_human, *ref_ids, T.end_of_text, T.end_of_human,
                      T.audio_start, T.start_of_speech, *audio_ids, T.end_of_speech,
                      T.audio_end]
        parts += [T.start_of_human, *ids, T.end_of_text, T.end_of_human]
        return parts

    def parse_output(self, all_tokens: list[int]) -> list[int]:
        """The audio codes after the last ``start_of_speech``, offset
        removed, trimmed to whole 7-token frames."""
        T = self.tokens
        sos = [i for i, t in enumerate(all_tokens) if t == T.start_of_speech]
        cropped = all_tokens[sos[-1] + 1:] if sos else all_tokens
        kept = [t for t in cropped if t != T.end_of_speech and t >= T.audio_token_offset]
        kept = kept[: (len(kept) // 7) * 7]
        return [t - T.audio_token_offset for t in kept]

    # -- generation -------------------------------------------------------------

    def _fused_supported(self) -> bool:
        """A stacked, unfused w8a8 tree of a shape the fused kernel takes."""
        return _fused_tree(self.params, self.config)

    def fused_decoder_pack(self) -> FL.LlamaFusedPack:
        """The fused kernel's weight pack (built once; a second int8 copy
        of the layer weights)."""
        if self._fused_pack is None:
            self._fused_pack = FL.pack_llama_weights(self.params, self.config)
        return self._fused_pack

    def _get_decoder(self, params: AudioGenerateParameters, fused: bool = False):
        key = (params.temperature, params.top_p, params.top_k, params.repetition_penalty,
               params.repetition_context_size, fused)
        if key not in self._decoders:
            sp = SamplingParams(temperature=params.temperature, top_p=params.top_p,
                                top_k=params.top_k,
                                repetition_penalty=params.repetition_penalty,
                                repetition_context_size=params.repetition_context_size)
            self._decoders[key] = make_decode_chunk(
                self._fused_step_fn if fused else self._step_fn, sp,
                history_size=max(params.repetition_context_size, 1),
                token_map=self._token_map)
        return self._decoders[key]

    @torch.inference_mode()
    def _run_generation(self, text, voice, ref_audio, ref_text,
                        params: AudioGenerateParameters, chunk_tokens: int):
        """Core loop: yields ``(new_tokens, done, timing)`` per chunk."""
        if self.tokenizer is None:
            raise AudioGenerationError("tokenizer not loaded")
        prompt = self.prepare_input_ids(text, voice, ref_audio, ref_text)
        T = self.tokens
        dev = self.device
        bucket = max(64, 1 << math.ceil(math.log2(max(len(prompt), 2))))
        pad_len = bucket - len(prompt)
        padded = np.full((1, bucket), T.pad_token, np.int64)
        padded[0, pad_len:] = prompt
        max_total = bucket + params.max_tokens + 1
        use_fused = _fused_route(self.params, self.config, dev)
        if use_fused:
            cache, fused_cache = self._fused_cache(max_total, pad_len)
        else:
            cache = llama.make_cache(self.config, 1, max_total, self.dtype,
                                     valid_from=pad_len, device=dev)

        t0 = time.perf_counter()
        # prefill all but the last prompt token; the decode loop re-feeds it
        _, cache = self._prefill(self.params, torch.from_numpy(padded[:, :-1]).to(dev),
                                 cache)
        _sync(dev)
        prefill_time = time.perf_counter() - t0

        step_params = self.params
        if use_fused:
            cache = fused_cache._replace(offset=cache.offset)
            step_params = {**self.params, "fused_pack": self.fused_decoder_pack()}
        decoder = self._get_decoder(params, fused=use_fused)
        generator = torch.Generator(device=dev).manual_seed(
            params.seed if params.seed is not None else 0)
        last = torch.tensor([prompt[-1]], device=dev)
        history = torch.zeros((1, max(params.repetition_context_size, 1)),
                              dtype=torch.int64, device=dev)
        hist_pos = torch.zeros((), dtype=torch.int64, device=dev)
        emitted = 0
        t1 = time.perf_counter()
        all_tokens = list(prompt)
        while emitted < params.max_tokens:
            n = min(chunk_tokens, params.max_tokens - emitted)
            buf = torch.zeros((n,), dtype=torch.int64, device=dev)
            tokens, count, cache, last, done, generator, history, hist_pos = decoder(
                step_params, cache, last, buf, generator, T.end_of_speech, history,
                hist_pos)
            new = tokens[:count].tolist()
            if done and new and new[-1] == T.end_of_speech:
                new = new[:-1]
            all_tokens += new
            emitted += count
            yield new, done or emitted >= params.max_tokens, (
                prefill_time, time.perf_counter() - t1, len(prompt), all_tokens)
            if done:
                return

    def _decode_codes(self, code_list: list[int]) -> np.ndarray:
        l1, l2, l3 = ungroup_codes(code_list, self.tokens.codebook_size)
        wav = self.codec.decode([np.asarray([l1]), np.asarray([l2]), np.asarray([l3])])
        return wav[0].to(torch.float32).cpu().numpy()

    def generate(self, text: str, voice: str | None = None, ref_audio=None,
                 ref_text: str | None = None, language: str | None = None,
                 generation_parameters: AudioGenerateParameters | None = None
                 ) -> np.ndarray:
        params = generation_parameters or self.default_generation_parameters()
        all_tokens = None
        for _new, _done, (_pt, _gt, _pl, toks) in self._run_generation(
                text, voice, ref_audio, ref_text, params, chunk_tokens=params.max_tokens):
            all_tokens = toks
        code_list = self.parse_output(all_tokens)
        if not code_list:
            raise AudioGenerationError("no audio codes generated")
        if self.codec is None:
            raise AudioGenerationError("SNAC codec not loaded")
        return self._decode_codes(code_list)

    def generate_stream(self, text: str, voice: str | None = None, ref_audio=None,
                        ref_text: str | None = None, language: str | None = None,
                        generation_parameters: AudioGenerateParameters | None = None):
        """Yields :class:`AudioGeneration` events: a token event per
        generated token, waveform deltas as whole 7-token frames
        accumulate (``streaming_interval`` seconds of audio a chunk), then
        an info event."""
        params = generation_parameters or self.default_generation_parameters()
        hop = getattr(self.codec, "config", None)
        samples_per_group = 4 * (hop.hop_length if hop else 512)
        groups_per_chunk = max(
            1, int(params.streaming_interval * self.sample_rate / samples_per_group))
        decoded_samples = 0
        gen_count = 0
        info = None
        for new, done, (pt, gt, plen, all_tokens) in self._run_generation(
                text, voice, ref_audio, ref_text, params,
                chunk_tokens=7 * groups_per_chunk):
            for t in new:
                gen_count += 1
                yield AudioGeneration.from_token(t)
            code_list = self.parse_output(all_tokens)
            if self.codec is not None and len(code_list) >= 7:
                wav = self._decode_codes(code_list)
                if wav.shape[0] > decoded_samples:
                    yield AudioGeneration.from_audio(wav[decoded_samples:])
                    decoded_samples = wav.shape[0]
            if done:
                info = AudioGenerationInfo(
                    prompt_token_count=plen, generation_token_count=gen_count,
                    prompt_time=pt, generate_time=gt,
                    audio_duration=decoded_samples / self.sample_rate)
                break
        if info is not None:
            yield AudioGeneration.from_info(info)


def load_tree(model_dir, config: LlamaTTSConfig, dtype, quantize_bits, device,
              fuse: bool = True) -> dict:
    """A checkpoint's parameter tree on ``device``: MLX-tagged when the
    config has ``quantization``, else quantized by ``quantize_bits`` (4, 8
    or ``"w8a8"``). With ``fuse``, q/k/v and gate/up are fused into one
    product each, except on a tree the fused kernel decodes. On CUDA a
    w8a8 tree that kernel does not take raises (``_fused_route``)."""
    if quantize_bits not in (None, "w8a8", 4, 8):
        raise ValueError(f"quantize_bits={quantize_bits!r}: 4, 8 or 'w8a8'")
    params = loading.load_params(model_dir, sanitize=lambda w: llama.sanitize(w, config),
                                 dtype=dtype, expected_prefixes=("model",))
    params = loading.to_device(llama.maybe_stack(params), device)
    if config.quantization:
        q = config.quantization
        params = quant.tag_quantized(params, q.get("group_size", 64), q.get("bits", 4))
    elif quantize_bits == "w8a8":
        params = quant.quantize_tree(params, scheme="w8a8")
    elif quantize_bits:
        params = quant.quantize_tree(params, bits=quantize_bits, scheme="mlx")
    if not _fused_route(params, config, torch.device(device)) and fuse:
        params = llama.fuse_projections(params)
    return params


def load_tokenizer(model_dir):
    """The checkpoint's ``tokenizer.json``, or None."""
    path = Path(model_dir) / "tokenizer.json"
    if not path.exists():
        return None
    from tokenizers import Tokenizer

    return Tokenizer.from_file(str(path))


def snac_beside(snac_dir, device):
    """The SNAC codec in ``snac_dir`` when that directory is there, else
    None (token generation works without it)."""
    if not Path(snac_dir).is_dir():
        return None
    from tpu_audio_torch.codecs import load_codec

    return load_codec(str(snac_dir), codec_type="snac", device=device)


def config_tokens(cfg_dict: dict) -> OrpheusTokens:
    """The special-token table a small-vocabulary config.json states."""
    return OrpheusTokens(**{k: cfg_dict[k] for k in (
        "start_of_human", "end_of_human", "end_of_text", "start_of_speech",
        "end_of_speech", "pad_token", "audio_start", "audio_end",
        "audio_token_offset")}, codebook_size=cfg_dict.get("codebook_size", 4096))


def _fused_tree(params: dict, cfg) -> bool:
    """Stacked, unfused w8a8 layers of a shape the fused kernel takes."""
    layers = params["model"]["layers"]
    if not FL.supported(cfg) or "self_attn" not in layers:
        return False
    ap = layers["self_attn"]
    return "q_proj" in ap and isinstance(ap["q_proj"]["weight"], quant.Int8Tensor)


def _fused_route(params: dict, cfg, device: torch.device) -> bool:
    """Whether decode runs through ``fused_llama_stack``. On CUDA a tree
    with int8 layer weights that the kernel does not take raises: there
    w8a8 decodes through the kernel only. ``llama.forward`` decodes dense
    trees, and w8a8 ones on the CPU."""
    if _fused_tree(params, cfg):
        return True
    if device.type == "cuda" and any(t.dtype == torch.int8 for t in
                                     llama._leaves(params["model"]["layers"])):
        raise NotImplementedError(
            "w8a8 decode on CUDA runs only through the fused_llama_stack kernels (one "
            "token, serving lanes), which take stacked, unfused layer projections of a "
            "shape ops.fused_llama.supported accepts; this tree is not one of them")
    return False
