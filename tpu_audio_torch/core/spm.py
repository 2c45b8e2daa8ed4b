"""Self-contained SentencePiece tokenizer (port of tpu_audio.core.spm; no
external dependency and no array code).

Parses the ``tokenizer.model`` protobuf directly (ModelProto: field 1 =
repeated SentencePiece{piece=1 string, score=2 float, type=3 enum};
field 2 = TrainerSpec{model_type=3 enum}) and implements unigram Viterbi
encoding and greedy BPE merging, both with byte fallback, plus
metaspace-aware decoding. The lattice is a flat DP over character
positions. The port keeps its own copy because the JAX package's
``core`` pulls in JAX on import.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

__all__ = ["SentencePieceTokenizer"]

# SentencePiece piece types (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


def _iter_fields(data: bytes, start: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value) from a protobuf buffer.
    value is int for varint, bytes for length-delimited, bytes4/8 for fixed."""
    i = start
    end = len(data) if end is None else end
    while i < end:
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, val
        elif wire == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, wire, data[i : i + ln]
            i += ln
        elif wire == 5:  # fixed32
            yield field, wire, data[i : i + 4]
            i += 4
        elif wire == 1:  # fixed64
            yield field, wire, data[i : i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def _parse_piece(data: bytes) -> tuple[str, float, int] | None:
    token, score, ptype = None, 0.0, _NORMAL
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:
            token = val.decode("utf-8", errors="replace")
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", val)[0]
        elif field == 3 and wire == 0:
            ptype = val
    if token is None:
        return None
    return token, score, ptype


def _parse_model(data: bytes):
    """-> (pieces [(token, score, type)], unk_id, model_type 1=unigram 2=bpe)."""
    pieces: list[tuple[str, float, int]] = []
    unk_id = None
    model_type = 1
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:
            piece = _parse_piece(val)
            if piece is not None:
                if piece[2] == _UNKNOWN and unk_id is None:
                    unk_id = len(pieces)
                pieces.append(piece)
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 3 and w2 == 0:
                    model_type = v2
    if not pieces:
        raise ValueError("SentencePiece model contains no vocabulary")
    if unk_id is None:
        unk_id = next((i for i, p in enumerate(pieces) if p[0] == "<unk>"), 0)
    return pieces, unk_id, model_type


class SentencePieceTokenizer:
    """Unigram/BPE SentencePiece with byte fallback.

    Construct via :meth:`from_model_file` (binary ``tokenizer.model``) or
    :meth:`from_tokenizer_json` (HF ``tokenizer.json`` with a Unigram model).
    """

    def __init__(self, pieces, unk_id: int, model_type: int = 1):
        self.pieces = pieces  # [(token, score, type)]
        self.unk_id = unk_id
        self.model_type = model_type
        self.token_to_id = {tok: i for i, (tok, _, _) in enumerate(pieces)}
        self.unk_score = min(s for _, s, _ in pieces) - 10.0
        self._byte_map = {}
        for i, (tok, _, _) in enumerate(pieces):
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                try:
                    self._byte_map[int(tok[3:5], 16)] = i
                except ValueError:
                    pass
        self._max_piece_len = max(len(t) for t, _, _ in pieces)
        # BPE atomic (user-defined) pieces, longest first
        self._atomic = sorted(
            (t for t, _, ty in pieces if ty == _USER_DEFINED),
            key=len, reverse=True)

    @classmethod
    def from_model_file(cls, path) -> "SentencePieceTokenizer":
        pieces, unk_id, model_type = _parse_model(Path(path).read_bytes())
        return cls(pieces, unk_id, model_type)

    @classmethod
    def from_tokenizer_json(cls, path) -> "SentencePieceTokenizer":
        model = json.loads(Path(path).read_text())["model"]
        pieces = [(tok, float(score), _NORMAL) for tok, score in model["vocab"]]
        model_type = 2 if str(model.get("type", "")).upper() == "BPE" else 1
        return cls(pieces, int(model.get("unk_id", 0)), model_type)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_for(self, token: str) -> int | None:
        return self.token_to_id.get(token)

    # -- encode --------------------------------------------------------------

    @staticmethod
    def _metaspace(text: str) -> str:
        return "▁" + text.replace(" ", "▁")

    def encode(self, text: str) -> list[int]:
        if self.model_type == 2:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def _byte_fallback(self, piece: str, out: list[int]) -> None:
        for b in piece.encode("utf-8"):
            out.append(self._byte_map.get(b, self.unk_id))

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi over the segmentation lattice: best[i] = max-score
        segmentation of the first i chars."""
        s = self._metaspace(text)
        n = len(s)
        best = [0.0] + [float("-inf")] * n
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, id)
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            matched_single = False
            # all vocab pieces starting at i (bounded by longest piece)
            for j in range(i + 1, min(n, i + self._max_piece_len) + 1):
                tid = self.token_to_id.get(s[i:j])
                if tid is None:
                    continue
                if j == i + 1:
                    matched_single = True
                score = best[i] + self.pieces[tid][1]
                if score > best[j]:
                    best[j] = score
                    back[j] = (i, tid)
            if not matched_single:
                score = best[i] + self.unk_score
                if score > best[i + 1]:
                    best[i + 1] = score
                    back[i + 1] = (i, self.unk_id)
        ids: list[int] = []
        j = n
        rev: list[tuple[int, int, int]] = []  # (start, end, id)
        while j > 0:
            i, tid = back[j]
            rev.append((i, j, tid))
            j = i
        for i, j, tid in reversed(rev):
            if tid == self.unk_id:
                self._byte_fallback(s[i:j], ids)
            else:
                ids.append(tid)
        return ids

    def _encode_bpe(self, text: str) -> list[int]:
        """Greedy highest-score merge (reference encodeBPEWithByteFallback)."""
        s = self._metaspace(text)
        symbols: list[str] = []
        i = 0
        while i < len(s):
            atom = next((a for a in self._atomic if s.startswith(a, i)), None)
            if atom is not None:
                symbols.append(atom)
                i += len(atom)
            else:
                symbols.append(s[i])
                i += 1
        while len(symbols) > 1:
            best_idx, best_score = None, float("-inf")
            for idx in range(len(symbols) - 1):
                tid = self.token_to_id.get(symbols[idx] + symbols[idx + 1])
                if tid is None:
                    continue
                tok, score, ty = self.pieces[tid]
                if ty not in (_NORMAL, _USER_DEFINED):
                    continue
                if best_idx is None or score > best_score:
                    best_idx, best_score = idx, score
            if best_idx is None:
                break
            symbols[best_idx : best_idx + 2] = [
                symbols[best_idx] + symbols[best_idx + 1]]
        ids: list[int] = []
        for sym in symbols:
            tid = self.token_to_id.get(sym)
            if tid is not None:
                ids.append(tid)
            else:
                self._byte_fallback(sym, ids)
        return ids

    # -- decode --------------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        byte_run: list[int] = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="ignore"))
                byte_run.clear()

        for tid in ids:
            if not 0 <= tid < len(self.pieces):
                continue
            tok, _, ty = self.pieces[tid]
            if ty in (_CONTROL, _UNUSED):
                continue
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                try:
                    byte_run.append(int(tok[3:5], 16))
                    continue
                except ValueError:
                    pass
            flush()
            out.append(tok)
        flush()
        return "".join(out).replace("▁", " ").strip()
