"""VyvoTTS: a Qwen3 decoder emitting 7-token SNAC frames (port of
tpu_audio.models.tts.qwen3_vyvo).

The Orpheus runtime (``llama_tts.LlamaTTS``: the decode loop, streaming,
the SNAC frame protocol, the serving hooks) on a Qwen3 backbone, with the
shared Llama-family backbone's per-head q/k RMSNorm (``qk_norm``), the
VyvoTTS special-token table and a START_OF_AI fallback in
:meth:`VyvoTTS.parse_output`.

Decode routes are ``LlamaTTS``'s: ``llama.forward`` for dense and MLX
4/8-bit trees (kernel 7 on every product of an MLX tree), and the fused
one-token kernel for a w8a8 tree of a shape ``ops.fused_llama.supported``
takes, which ``from_pretrained`` leaves unfused. The JAX package fuses
q/k/v whenever ``fuse`` is set, so its fused kernel never takes the tree
its loader builds by default; the tokens are the same function either
way.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.core import hub
from tpu_audio_torch.models.tts.llama_tts import (LlamaTTS, LlamaTTSConfig, OrpheusTokens,
                                                  config_tokens, load_tokenizer, load_tree,
                                                  snac_beside)

__all__ = ["VyvoTTS", "VYVO_TOKENS"]

_TOKENIZER_LENGTH = 151669
VYVO_TOKENS = OrpheusTokens(
    start_of_human=_TOKENIZER_LENGTH + 3,   # 151672
    end_of_human=_TOKENIZER_LENGTH + 4,     # 151673
    end_of_text=151645,
    start_of_speech=_TOKENIZER_LENGTH + 1,  # 151670
    end_of_speech=_TOKENIZER_LENGTH + 2,    # 151671
    pad_token=_TOKENIZER_LENGTH + 7,        # 151676
    audio_start=_TOKENIZER_LENGTH + 5,      # START_OF_AI 151674
    audio_end=_TOKENIZER_LENGTH + 6,        # END_OF_AI 151675
    audio_token_offset=_TOKENIZER_LENGTH + 10,  # 151679
    codebook_size=4096,
)


class VyvoTTS(LlamaTTS):
    """VyvoTTS with ``generate`` / ``generate_stream`` (``LlamaTTS``'s)."""

    @classmethod
    def from_pretrained(cls, repo_or_path: str, codec=None, snac_repo: str | None = None,
                        dtype=torch.bfloat16, quantize_bits: int | str | None = None,
                        fuse: bool = True, device="cuda") -> "VyvoTTS":
        """Load a local checkpoint directory onto ``device`` with Qwen3's
        q/k RMSNorm. ``quantization`` in the config and ``quantize_bits``
        act as in ``LlamaTTS.from_pretrained``. ``fuse`` fuses q/k/v and
        gate/up into one product each, except on a w8a8 tree the fused
        kernel decodes; ``fuse=False`` never fuses. A vocabulary below the
        VyvoTTS table needs the table in config.json."""
        model_dir = hub.resolve_model_dir(repo_or_path)
        cfg_dict = hub.load_config(model_dir)
        config = LlamaTTSConfig.from_dict(cfg_dict)
        config.qk_norm = True  # Qwen3 attention
        config.quantization = cfg_dict.get("quantization")
        params = load_tree(model_dir, config, dtype, quantize_bits, device, fuse=fuse)
        tokens = VYVO_TOKENS
        if config.vocab_size < tokens.audio_token_offset:
            if "audio_token_offset" not in cfg_dict:
                raise ValueError("tiny vocab requires token table in config.json")
            tokens = config_tokens(cfg_dict)
        if codec is None:
            codec = snac_beside(snac_repo or config.snac_repo, device)
        return cls(config, params, load_tokenizer(model_dir), codec, tokens, dtype)

    def parse_output(self, all_tokens: list[int]) -> list[int]:
        """The audio codes after the last START_OF_SPEECH; without one,
        from the first audio token after the last START_OF_AI. Offset
        removed, trimmed to whole 7-token frames."""
        T = self.tokens
        start_idx = None
        for i, t in enumerate(all_tokens):
            if t == T.start_of_speech:
                start_idx = i
        if start_idx is None:
            soa = [i for i, t in enumerate(all_tokens) if t == T.audio_start]
            if soa:
                start_idx = next((j - 1 for j in range(soa[-1] + 1, len(all_tokens))
                                  if all_tokens[j] >= T.audio_token_offset), None)
        seq = all_tokens[start_idx + 1:] if start_idx is not None else all_tokens
        kept = [t for t in seq if t != T.end_of_speech and t >= T.audio_token_offset]
        kept = kept[: (len(kept) // 7) * 7]
        return [t - T.audio_token_offset for t in kept]
