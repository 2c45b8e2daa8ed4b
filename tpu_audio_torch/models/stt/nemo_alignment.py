"""Token-level alignment for NeMo-family decoders (Parakeet TDT/RNNT/CTC);
the port's copy of tpu_audio.models.stt.nemo_alignment, code unchanged.

Host-side post-processing of the on-device decode lattice: each emitted token
carries the frame it was emitted at and its TDT jump (or CTC span), which map
to absolute seconds. This module groups aligned tokens into sentences and
merges overlapping long-audio chunks by aligning their shared tokens instead
of naive concatenation.

Reference semantics: NemoAlignment.swift:97-273 (tokensToSentences,
mergeLongestContiguous, mergeLongestCommonSubsequence) and the chunk loop in
ParakeetModel.swift:118-160.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "AlignedToken", "AlignedSentence", "AlignedResult", "NoStrongOverlap",
    "tokens_to_sentences", "sentences_to_result",
    "merge_longest_contiguous", "merge_longest_common_subsequence",
    "merge_token_sequences",
]


@dataclass
class AlignedToken:
    """One emitted token with its lattice timing (NemoAlignment.swift:3-19)."""

    id: int
    text: str
    start: float
    duration: float

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass
class AlignedSentence:
    """Sentence grouping of aligned tokens (NemoAlignment.swift:21-41)."""

    text: str
    tokens: list[AlignedToken] = field(default_factory=list)

    def __post_init__(self):
        self.tokens = sorted(self.tokens, key=lambda t: t.start)

    @property
    def start(self) -> float:
        return self.tokens[0].start if self.tokens else 0.0

    @property
    def end(self) -> float:
        return self.tokens[-1].end if self.tokens else 0.0

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class AlignedResult:
    """Full transcript + sentences (NemoAlignment.swift:43-61)."""

    text: str
    sentences: list[AlignedSentence]


class NoStrongOverlap(Exception):
    """Raised when the contiguous merge finds too few matching pairs
    (NemoAlignmentError.noStrongOverlap)."""


def _should_close_sentence(token: AlignedToken, index: int,
                           all_tokens: list[AlignedToken]) -> bool:
    """Sentence boundary rule (NemoAlignment.swift:276-288): hard on
    !/?/CJK terminators; '.' only when followed by a space (or final)."""
    t = token.text
    if any(ch in t for ch in "!?。？！"):
        return True
    if "." in t:
        if index == len(all_tokens) - 1:
            return True
        return " " in all_tokens[index + 1].text
    return False


def tokens_to_sentences(tokens: list[AlignedToken]) -> list[AlignedSentence]:
    """Group a token stream into sentences (NemoAlignment.swift:97-117)."""
    sentences: list[AlignedSentence] = []
    current: list[AlignedToken] = []
    for i, token in enumerate(tokens):
        current.append(token)
        if _should_close_sentence(token, i, tokens):
            sentences.append(AlignedSentence(
                text="".join(t.text for t in current), tokens=current))
            current = []
    if current:
        sentences.append(AlignedSentence(
            text="".join(t.text for t in current), tokens=current))
    return sentences


def sentences_to_result(sentences: list[AlignedSentence]) -> AlignedResult:
    return AlignedResult(
        text="".join(s.text for s in sentences).strip(), sentences=sentences)


def _matches(a: AlignedToken, b: AlignedToken, overlap_duration: float) -> bool:
    return a.id == b.id and abs(a.start - b.start) < overlap_duration


def _cutoff_merge(a, b, a_end, b_start):
    cutoff = (a_end + b_start) / 2
    return ([t for t in a if t.end <= cutoff]
            + [t for t in b if t.start >= cutoff])


def _stitch(a, b, indices_a, indices_b):
    """Join two chunks along matched anchor pairs, keeping the richer gap
    between consecutive anchors (shared tail of both reference merges)."""
    merged = list(a[: indices_a[0]])
    for idx in range(len(indices_a)):
        ia, ib = indices_a[idx], indices_b[idx]
        merged.append(a[ia])
        if idx < len(indices_a) - 1:
            gap_a = a[ia + 1 : indices_a[idx + 1]]
            gap_b = b[ib + 1 : indices_b[idx + 1]]
            merged.extend(gap_b if len(gap_b) > len(gap_a) else gap_a)
    merged.extend(b[indices_b[-1] + 1 :])
    return merged


def merge_longest_contiguous(a: list[AlignedToken], b: list[AlignedToken],
                             overlap_duration: float) -> list[AlignedToken]:
    """Merge two overlapping chunks on their longest contiguous run of
    matching tokens (NemoAlignment.swift:123-192). Raises
    :class:`NoStrongOverlap` when fewer than half the overlap tokens chain."""
    if not a:
        return list(b)
    if not b:
        return list(a)
    a_end = a[-1].end
    b_start = b[0].start
    if a_end <= b_start:
        return list(a) + list(b)

    overlap_a = [t for t in a if t.end > b_start - overlap_duration]
    overlap_b = [t for t in b if t.start < a_end + overlap_duration]
    enough_pairs = len(overlap_a) // 2
    if len(overlap_a) < 2 or len(overlap_b) < 2:
        return _cutoff_merge(a, b, a_end, b_start)

    best: list[tuple[int, int]] = []
    half = overlap_duration / 2
    for i in range(len(overlap_a)):
        for j in range(len(overlap_b)):
            if not _matches(overlap_a[i], overlap_b[j], half):
                continue
            chain = []
            k, l = i, j
            while (k < len(overlap_a) and l < len(overlap_b)
                   and _matches(overlap_a[k], overlap_b[l], half)):
                chain.append((k, l))
                k += 1
                l += 1
            if len(chain) > len(best):
                best = chain
    if len(best) < enough_pairs:
        raise NoStrongOverlap

    a_start = len(a) - len(overlap_a)
    return _stitch(a, b, [a_start + p[0] for p in best],
                   [p[1] for p in best])


def merge_longest_common_subsequence(a: list[AlignedToken],
                                     b: list[AlignedToken],
                                     overlap_duration: float
                                     ) -> list[AlignedToken]:
    """LCS fallback merge (NemoAlignment.swift:195-273): robust to decoder
    disagreements inside the overlap (e.g. repeated phrases at the
    boundary)."""
    if not a:
        return list(b)
    if not b:
        return list(a)
    a_end = a[-1].end
    b_start = b[0].start
    if a_end <= b_start:
        return list(a) + list(b)

    overlap_a = [t for t in a if t.end > b_start - overlap_duration]
    overlap_b = [t for t in b if t.start < a_end + overlap_duration]
    if len(overlap_a) < 2 or len(overlap_b) < 2:
        return _cutoff_merge(a, b, a_end, b_start)

    half = overlap_duration / 2
    rows, cols = len(overlap_a) + 1, len(overlap_b) + 1
    dp = [[0] * cols for _ in range(rows)]
    for i in range(1, rows):
        for j in range(1, cols):
            if _matches(overlap_a[i - 1], overlap_b[j - 1], half):
                dp[i][j] = dp[i - 1][j - 1] + 1
            else:
                dp[i][j] = max(dp[i - 1][j], dp[i][j - 1])

    pairs: list[tuple[int, int]] = []
    i, j = len(overlap_a), len(overlap_b)
    while i > 0 and j > 0:
        if _matches(overlap_a[i - 1], overlap_b[j - 1], half):
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif dp[i - 1][j] > dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    if not pairs:
        return _cutoff_merge(a, b, a_end, b_start)

    a_start = len(a) - len(overlap_a)
    return _stitch(a, b, [a_start + p[0] for p in pairs],
                   [p[1] for p in pairs])


def merge_token_sequences(existing: list[AlignedToken],
                          incoming: list[AlignedToken],
                          overlap_duration: float) -> list[AlignedToken]:
    """Contiguous merge with LCS fallback (ParakeetModel.swift:887-893)."""
    if not existing:
        return list(incoming)
    if not incoming:
        return list(existing)
    try:
        return merge_longest_contiguous(existing, incoming, overlap_duration)
    except NoStrongOverlap:
        return merge_longest_common_subsequence(existing, incoming,
                                                overlap_duration)
