"""Qwen3 forced aligner: word-level timestamps from (audio, transcript)
(port of tpu_audio.models.stt.qwen3_aligner).

The model is the Qwen3-ASR audio tower and text decoder with a timestamp
classification head (``lm_head``: hidden -> ``classify_num`` classes, no
bias). The prompt is ``<|audio_start|>(<|audio_pad|> x N)<|audio_end|>``
followed by the transcript's words, each trailed by two ``<timestamp>``
tokens. One causal ``llama.forward`` (no cache) classifies every position;
at each ``<timestamp>`` position the argmax class times
``timestamp_segment_time`` (80 ms) is a word's start or end time. A
longest-non-decreasing-subsequence repair fixes times out of order, then
the words are paired with their (start, end).

The prompt is zero-padded to a multiple of 64 rows: trailing rows cannot
reach earlier positions under the causal mask, so the bucket changes no
class. On CUDA with an MLX tree it decides kernel 7's route: a bucket of 64
rows runs the tensor-core tile, a longer one dequantizes and multiplies.
The text processing (``ForceAlignProcessor``) is host Python, copied from
the JAX package.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_audio_torch.core import nn
from tpu_audio_torch.models import llama
from tpu_audio_torch.models.stt import qwen3_asr

__all__ = ["Qwen3ForcedAligner", "ForceAlignProcessor", "ForcedAlignItem",
           "ForcedAlignResult"]

_PAD_BUCKET = 64

# CJK unicode ranges (Qwen3ForcedAligner.swift:92-104)
_CJK_RANGES = (
    (0x4E00, 0x9FFF),      # CJK Unified Ideographs
    (0x3400, 0x4DBF),      # Extension A
    (0x20000, 0x2A6DF),    # Extension B
    (0x2A700, 0x2B73F),    # Extension C
    (0x2B740, 0x2B81F),    # Extension D
    (0x2B820, 0x2CEAF),    # Extension E
    (0xF900, 0xFAFF),      # Compatibility Ideographs
)


@dataclass
class ForcedAlignItem:
    """One aligned word with times in seconds (ForcedAlignResult types)."""

    text: str
    start_time: float
    end_time: float


@dataclass
class ForcedAlignResult:
    items: list[ForcedAlignItem] = field(default_factory=list)
    prompt_tokens: int = 0
    total_time: float = 0.0

    @property
    def text(self) -> str:
        return " ".join(item.text for item in self.items)


class ForceAlignProcessor:
    """Host-side text preparation + timestamp repair
    (ForceAlignProcessor, Qwen3ForcedAligner.swift:75-335)."""

    @staticmethod
    def is_kept_char(ch: str) -> bool:
        return ch == "'" or ch.isalpha() or ch.isnumeric()

    def clean_token(self, token: str) -> str:
        return "".join(ch for ch in token if self.is_kept_char(ch))

    @staticmethod
    def is_cjk_char(ch: str) -> bool:
        code = ord(ch)
        return any(lo <= code <= hi for lo, hi in _CJK_RANGES)

    def tokenize_chinese_mixed(self, text: str) -> list[str]:
        """Each CJK char is its own token; latin runs are cleaned words."""
        tokens: list[str] = []
        latin: list[str] = []

        def flush():
            if latin:
                cleaned = self.clean_token("".join(latin))
                if cleaned:
                    tokens.append(cleaned)
                latin.clear()

        for ch in text:
            if self.is_cjk_char(ch):
                flush()
                tokens.append(ch)
            elif self.is_kept_char(ch):
                latin.append(ch)
            else:
                flush()
        flush()
        return tokens

    def _split_segment_with_chinese(self, seg: str) -> list[str]:
        tokens: list[str] = []
        buf: list[str] = []
        for ch in seg:
            if self.is_cjk_char(ch):
                if buf:
                    tokens.append("".join(buf))
                    buf = []
                tokens.append(ch)
            else:
                buf.append(ch)
        if buf:
            tokens.append("".join(buf))
        return tokens

    def tokenize_space_lang(self, text: str) -> list[str]:
        """Space-separated languages; embedded CJK chars still split out."""
        tokens: list[str] = []
        for seg in text.split(" "):
            cleaned = self.clean_token(seg)
            if cleaned:
                tokens.extend(self._split_segment_with_chinese(cleaned))
        return tokens

    # -- timestamp repair (LIS, Qwen3ForcedAligner.swift:181-278) -----------

    def fix_timestamp(self, data: list[float]) -> list[int]:
        """Repair non-monotonic timestamps: keep the longest non-decreasing
        subsequence, patch <=2-long anomaly runs from the nearest valid
        neighbor, linearly interpolate longer runs."""
        n = len(data)
        if n == 0:
            return []
        vals = [int(x) for x in data]

        dp = [1] * n
        parent = [-1] * n
        for i in range(1, n):
            for j in range(i):
                if vals[j] <= vals[i] and dp[j] + 1 > dp[i]:
                    dp[i] = dp[j] + 1
                    parent[i] = j
        max_idx = dp.index(max(dp))
        is_normal = [False] * n
        idx = max_idx
        while idx != -1:
            is_normal[idx] = True
            idx = parent[idx]

        result = list(vals)
        i = 0
        while i < n:
            if is_normal[i]:
                i += 1
                continue
            j = i
            while j < n and not is_normal[j]:
                j += 1
            left_val = next((result[k] for k in range(i - 1, -1, -1)
                             if is_normal[k]), None)
            right_val = next((result[k] for k in range(j, n)
                              if is_normal[k]), None)
            count = j - i
            if count <= 2:
                for k in range(i, j):
                    if left_val is None:
                        result[k] = right_val if right_val is not None else 0
                    elif right_val is None:
                        result[k] = left_val
                    else:
                        result[k] = (left_val if (k - (i - 1)) <= (j - k)
                                     else right_val)
            else:
                if left_val is not None and right_val is not None:
                    step = (right_val - left_val) / (count + 1)
                    for k in range(i, j):
                        result[k] = left_val + int(step * (k - i + 1))
                elif left_val is not None:
                    for k in range(i, j):
                        result[k] = left_val
                elif right_val is not None:
                    for k in range(i, j):
                        result[k] = right_val
            i = j
        return result

    # -- prompt encode / parse (Qwen3ForcedAligner.swift:280-335) -----------

    def encode_timestamp(self, text: str, language: str) -> tuple[list[str], str]:
        if language.lower() == "chinese":
            word_list = self.tokenize_chinese_mixed(text)
        else:
            word_list = self.tokenize_space_lang(text)
        input_text = ("<|audio_start|><|audio_pad|><|audio_end|>"
                      + "<timestamp><timestamp>".join(word_list)
                      + "<timestamp><timestamp>")
        return word_list, input_text

    def parse_timestamp(self, word_list: list[str],
                        timestamp: list[float]) -> list[ForcedAlignItem]:
        fixed = self.fix_timestamp(timestamp)
        items = []
        for i, word in enumerate(word_list):
            if i * 2 + 1 >= len(fixed):
                break
            items.append(ForcedAlignItem(
                text=word,
                start_time=fixed[i * 2] / 1000.0,
                end_time=fixed[i * 2 + 1] / 1000.0,
            ))
        return items


class Qwen3ForcedAligner(qwen3_asr.Qwen3ASR):
    """Qwen3-ASR's tower, prompt splicing and text decoder with the
    timestamp head: ``generate(audio, text)`` runs one causal forward
    through ``lm_head`` instead of autoregressive decoding. Loads through
    ``Qwen3ASR.from_pretrained``, which keeps ``lm_head``."""

    def __init__(self, config, params, tokenizer=None, dtype=torch.bfloat16):
        super().__init__(config, params, tokenizer, dtype)
        self.processor = ForceAlignProcessor()

    @torch.no_grad()
    def prompt(self, audio, text: str, language: str = "English", pad: bool = True):
        """The prompt for ``audio`` (16 kHz) and ``text`` -> (the words, the
        token ids ``[1, n]``, the merged embeddings ``[1, T, D]`` in the
        model's dtype, T being n rounded up to the 64-row bucket, or n where
        ``pad`` is false)."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        mel, _ = self.preprocess_audio(audio)
        feats = self.encode_audio(mel)
        word_list, aligner_text = self.processor.encode_timestamp(text, language)
        expanded = aligner_text.replace("<|audio_pad|>", "<|audio_pad|>" * feats.shape[0])
        ids = np.asarray([self.tokenizer.encode(expanded).ids], np.int32)
        embeds = self._merge_audio_features(ids, feats)
        if pad:
            # trailing rows are invisible to earlier positions under the
            # causal mask, so the bucket changes no class
            n = ids.shape[1]
            embeds = torch.nn.functional.pad(
                embeds, (0, 0, 0, _PAD_BUCKET * math.ceil(n / _PAD_BUCKET) - n))
        return word_list, ids, embeds.to(self.dtype)

    @torch.no_grad()
    def generate(self, audio, text: str | None = None, language: str = "English",
                 **_kwargs) -> ForcedAlignResult:
        """Align ``text`` to ``audio`` (16 kHz) -> the words' items."""
        if not text:
            raise ValueError("forced alignment requires the transcript text")
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        t0 = time.perf_counter()
        word_list, ids, embeds = self.prompt(audio, text, language)
        classes = _classify(self.params, embeds, self.config.text)[0].cpu().numpy()
        seg_ms = self.config.timestamp_segment_time
        ts_positions = np.where(ids[0] == self.config.timestamp_token_id)[0]
        timestamps = [float(classes[p]) * seg_ms for p in ts_positions]
        items = self.processor.parse_timestamp(word_list, timestamps)
        return ForcedAlignResult(items=items, prompt_tokens=ids.shape[1],
                                 total_time=time.perf_counter() - t0)

    def generate_stream(self, audio, generation_parameters=None):
        raise NotImplementedError("streaming is not supported for forced aligner models")


def _logits(params, embeds: torch.Tensor, cfg) -> torch.Tensor:
    """One causal forward of ``embeds [B, T, D]`` -> each position's class
    logits ``[B, T, classify_num]``."""
    hidden, _ = llama.forward(params, None, None, cfg, inputs_embeds=embeds,
                              return_hidden=True)
    return nn.linear(params["lm_head"], hidden)


def _classify(params, embeds: torch.Tensor, cfg) -> torch.Tensor:
    """Each position's argmax class ``[B, T]`` (``_logits``)."""
    return torch.argmax(_logits(params, embeds, cfg), dim=-1)
