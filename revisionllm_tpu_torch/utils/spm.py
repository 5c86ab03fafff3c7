"""Minimal SentencePiece runtime (no `sentencepiece` dependency): the
port's own copy of revisionllm_tpu/utils/spm.py, which imports no JAX.

The ChatGLM2 path needs a loadable tokenizer at runtime
(reference revisionllm/model/chatglm/tokenization_chatglm.py:15 loads a
`tokenizer.model` via SentencePieceProcessor); the build image ships no
`sentencepiece`, so this module implements the part of it the pipeline
uses, from scratch:

- ModelProto wire-format parsing (and serialization, for building tiny
  models in tests): only the `pieces` field matters at inference
  (field 1: repeated SentencePiece {piece: 1 (string), score: 2 (float),
  type: 3 (enum)}).
- BPE encoding (ChatGLM2/Llama .model files are `model_type: BPE`):
  repeatedly merge the adjacent symbol pair whose concatenation is a known
  piece with the best (highest) score — SentencePiece's bpe_model.cc
  algorithm. Byte-fallback (<0xXX> pieces) covers out-of-vocab characters.
- Decoding: pieces joined, U+2581 (▁) to space, byte pieces re-assembled.

Normalization implements the ChatGLM2/Llama NormalizerSpec surface:
`remove_extra_whitespaces` (collapse space runs, strip ends) +
`add_dummy_prefix` + space-to-▁ replacement. The NFKC normalizer table is
NOT applied (identity): exotic Unicode (full-width forms, compatibility
ligatures) tokenizes differently from real sentencepiece — out of scope for
the ASCII grounding prompts; divergence also documented on
ChatGLMTokenizer.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

SPACE = "▁"  # ▁

# SentencePiece piece types (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_BYTE = 6


# ---------------------------------------------------------------- protobuf io


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """ModelProto bytes -> [(piece, score, type), ...] in id order."""
    pieces: List[Tuple[str, float, int]] = []
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            ln, i = _read_varint(data, i)
            sub = data[i : i + ln]
            i += ln
            piece, score, typ = "", 0.0, TYPE_NORMAL
            j = 0
            while j < ln:
                stag, j = _read_varint(sub, j)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    sln, j = _read_varint(sub, j)
                    piece = sub[j : j + sln].decode("utf-8")
                    j += sln
                elif sfield == 2 and swire == 5:
                    score = struct.unpack("<f", sub[j : j + 4])[0]
                    j += 4
                elif sfield == 3 and swire == 0:
                    typ, j = _read_varint(sub, j)
                else:  # skip unknown subfield
                    j = _skip(sub, j, swire)
            pieces.append((piece, score, typ))
        else:
            i = _skip(data, i, wire)
    return pieces


def _skip(data: bytes, i: int, wire: int) -> int:
    if wire == 0:
        _, i = _read_varint(data, i)
    elif wire == 1:
        i += 8
    elif wire == 2:
        ln, i = _read_varint(data, i)
        i += ln
    elif wire == 5:
        i += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return i


def serialize_model_proto(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """[(piece, score, type)] -> ModelProto bytes (for building test models)."""
    out = bytearray()
    for piece, score, typ in pieces:
        sub = bytearray()
        pb = piece.encode("utf-8")
        sub += _write_varint((1 << 3) | 2) + _write_varint(len(pb)) + pb
        sub += _write_varint((2 << 3) | 5) + struct.pack("<f", score)
        sub += _write_varint((3 << 3) | 0) + _write_varint(typ)
        out += _write_varint((1 << 3) | 2) + _write_varint(len(sub)) + bytes(sub)
    return bytes(out)


# ------------------------------------------------------------------- encoder


class SentencePieceModel:
    """BPE SentencePiece inference over a parsed ModelProto."""

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.unk_id_ = next(
            (i for i, t in enumerate(self.types) if t == TYPE_UNKNOWN), 0
        )
        self.byte_ids: Dict[int, int] = {}
        for i, (p, _, t) in enumerate(pieces):
            if t == TYPE_BYTE and p.startswith("<0x") and p.endswith(">"):
                self.byte_ids[int(p[3:-1], 16)] = i

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    # --- sentencepiece API surface the tokenizer wrapper uses
    def vocab_size(self) -> int:
        return len(self.pieces)

    get_piece_size = vocab_size

    def unk_id(self) -> int:
        return self.unk_id_

    def bos_id(self) -> int:
        return self.piece_to_id.get("<s>", -1)

    def eos_id(self) -> int:
        return self.piece_to_id.get("</s>", -1)

    def piece_to_id_fn(self, piece: str) -> int:
        return self.piece_to_id.get(piece, self.unk_id_)

    PieceToId = piece_to_id_fn

    def IdToPiece(self, i: int) -> str:
        return self.pieces[i][0]

    def _normalize(self, text: str) -> str:
        # remove_extra_whitespaces (NormalizerSpec default, ON for the
        # ChatGLM2/Llama models): strip leading/trailing spaces, collapse
        # internal runs — multi-space text then tokenizes like sentencepiece
        while "  " in text:
            text = text.replace("  ", " ")
        text = text.strip(" ")
        text = text.replace(" ", SPACE)
        if not text.startswith(SPACE):
            text = SPACE + text  # add_dummy_prefix
        return text

    def encode_as_pieces(self, text: str) -> List[str]:
        if not text:
            return []
        symbols = self._bpe(self._normalize(text))
        # byte-fallback for symbols not in vocab
        out: List[str] = []
        for s in symbols:
            if s in self.piece_to_id:
                out.append(s)
            elif self.byte_ids:
                out.extend(f"<0x{b:02X}>" for b in s.encode("utf-8"))
            else:
                out.append(s)  # maps to unk in encode()
        return out

    EncodeAsPieces = encode_as_pieces

    def encode(self, text: str) -> List[int]:
        return [self.piece_to_id.get(p, self.unk_id_) for p in self.encode_as_pieces(text)]

    def _bpe(self, text: str) -> List[str]:
        """Score-greedy adjacent merges (sentencepiece bpe_model.cc)."""
        symbols = list(text)
        if not symbols:
            return symbols
        while True:
            best_score: Optional[float] = None
            best_idx = -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                pid = self.piece_to_id.get(merged)
                if pid is None or self.types[pid] != TYPE_NORMAL:
                    continue
                sc = self.scores[pid]
                if best_score is None or sc > best_score:
                    best_score, best_idx = sc, i
            if best_idx < 0:
                return symbols
            symbols[best_idx : best_idx + 2] = [symbols[best_idx] + symbols[best_idx + 1]]

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for p in pieces:
            if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
                byte_buf.append(int(p[3:-1], 16))
                continue
            flush()
            pid = self.piece_to_id.get(p)
            if pid is not None and self.types[pid] in (TYPE_CONTROL, TYPE_UNKNOWN):
                continue
            out.append(p.replace(SPACE, " "))
        flush()
        text = "".join(out)
        return text[1:] if text.startswith(" ") else text

    DecodePieces = decode_pieces

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_pieces([self.pieces[i][0] for i in ids if 0 <= i < len(self.pieces)])


def build_test_model(
    words: Sequence[str], with_bytes: bool = True
) -> bytes:
    """A tiny but REAL BPE ModelProto for tests: control/unk pieces, all
    needed merge intermediates of `words`, and the byte table."""
    pieces: List[Tuple[str, float, int]] = [
        ("<unk>", 0.0, TYPE_UNKNOWN),
        ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL),
    ]
    seen = {p for p, _, _ in pieces}
    # single characters (lowest scores)
    chars = sorted({c for w in words for c in SPACE + w} | {SPACE})
    # merge intermediates: every prefix of every word, longer = better score
    inter: List[str] = []
    for w in words:
        full = SPACE + w
        for ln in range(2, len(full) + 1):
            inter.append(full[:ln])
    uniq = []
    for s in inter:
        if s not in seen:
            uniq.append(s)
            seen.add(s)
    for s in uniq:
        pieces.append((s, -10.0 + len(s), TYPE_NORMAL))  # longer merges win
    for c in chars:
        if c not in seen:
            pieces.append((c, -100.0, TYPE_NORMAL))
            seen.add(c)
    if with_bytes:
        for b in range(256):
            pieces.append((f"<0x{b:02X}>", -200.0, TYPE_BYTE))
    return serialize_model_proto(pieces)
