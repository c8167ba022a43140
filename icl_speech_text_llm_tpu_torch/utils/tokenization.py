"""Tokenizer abstraction.

The reference leans on HF tokenizers downloaded from the hub (Vicuna / Qwen).
This framework must run hermetically (no egress), so it defines a small
protocol, an HF adapter for when local tokenizer assets exist, and a
deterministic in-repo ``TinyTokenizer`` used by tests, smoke runs, and the
benchmark harness.

TinyTokenizer properties (relied on elsewhere):
- exact text round-trip (byte fallback);
- every 4-5 char lowercase word encodes to exactly 2 tokens → the symbol
  adapter's two-token symbol generation works unchanged
  (ref: models/symbolAdapter/symbol_manager.py:126-159);
- stable ids across processes (pure function of the string).
"""

from __future__ import annotations

import string
from typing import Iterable, List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    pad_token_id: int
    bos_token_id: int
    eos_token_id: int

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    def batch_decode(
        self, batch: Iterable[Sequence[int]], skip_special_tokens: bool = True
    ) -> List[str]: ...


_LOWER = string.ascii_lowercase


class TinyTokenizer:
    """Deterministic greedy longest-match tokenizer, LLaMA-scale vocab (~36.8k).

    Piece inventory (ids assigned in this order):
      0..3    specials: <pad>, <s>, </s>, <unk>
      4..259  raw bytes (latin-1)
      then all 2-char and 3-char lowercase strings, then the same with a
      leading space ("_ab"-style pieces make common prose ~2 tokens/word).
    """

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self):
        pieces: List[str] = []
        pieces.extend(chr(b) for b in range(256))
        two = [a + b for a in _LOWER for b in _LOWER]
        three = [a + b + c for a in _LOWER for b in _LOWER for c in _LOWER]
        pieces.extend(two)
        pieces.extend(three)
        pieces.extend(" " + p for p in two)
        pieces.extend(" " + p for p in three)

        self._pieces = pieces
        self._piece_to_id = {p: i + 4 for i, p in enumerate(pieces)}
        # longest candidate piece is " xyz" (4 chars)
        self._max_len = 4
        self.vocab_size = len(pieces) + 4
        self.pad_token_id = self.PAD
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self.unk_token_id = self.UNK

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.BOS)
        i, n = 0, len(text)
        while i < n:
            matched = False
            for ln in range(min(self._max_len, n - i), 1, -1):
                piece = text[i : i + ln]
                pid = self._piece_to_id.get(piece)
                if pid is not None:
                    ids.append(pid)
                    i += ln
                    matched = True
                    break
            if not matched:
                ch = text[i]
                if ord(ch) < 128:
                    ids.append(4 + ord(ch))
                else:
                    # any non-ASCII char goes through utf-8 byte fallback so
                    # decode can reassemble it exactly
                    for b in ch.encode("utf-8"):
                        ids.append(4 + b)
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for tid in ids:
            tid = int(tid)
            if tid < 4:
                if not skip_special_tokens:
                    out.extend(["<pad>", "<s>", "</s>", "<unk>"][tid].encode())
                continue
            if tid < 260:  # raw byte token
                out.append(tid - 4)
            elif tid - 4 < len(self._pieces):  # multi-char pieces are pure ASCII
                out.extend(self._pieces[tid - 4].encode("ascii"))
            # ids in the padded tail of the model's vocab (vocab_size is
            # rounded up for MXU-friendly lm_head shapes) decode to nothing,
            # matching HF's behavior for ids outside the tokenizer vocab
        return out.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    # transformers-style call for drop-in use by the symbol manager
    def __call__(self, text, add_special_tokens: bool = True, **_):
        if isinstance(text, str):
            return {"input_ids": self.encode(text, add_special_tokens)}
        return {"input_ids": [self.encode(t, add_special_tokens) for t in text]}


class HFTokenizerAdapter:
    """Adapter over a locally available ``transformers`` tokenizer
    (e.g. converted Vicuna/Qwen assets). No hub downloads are attempted."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.vocab_size = int(hf_tokenizer.vocab_size)
        self.pad_token_id = (
            hf_tokenizer.pad_token_id
            if hf_tokenizer.pad_token_id is not None
            else hf_tokenizer.eos_token_id
        )
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id

    @classmethod
    def from_path(cls, path: str) -> "HFTokenizerAdapter":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(path, local_files_only=True))

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return self._tok.batch_decode(batch, skip_special_tokens=skip_special_tokens)

    def __call__(self, *a, **kw):
        return self._tok(*a, **kw)


def get_tokenizer(spec: Optional[str] = None) -> Tokenizer:
    """Resolve a tokenizer spec: None/'tiny' → TinyTokenizer; else a local path."""
    if spec in (None, "tiny"):
        return TinyTokenizer()
    return HFTokenizerAdapter.from_path(spec)
