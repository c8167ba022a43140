"""The reference's tokenizer, written from the published format and frozen
here: the in-repository tokenizer (a greedy longest-match over bytes and
2-3 letter pieces, 36764 ids). Each family's prompt is a list of text
segments with one audio clip between each two, each segment tokenized on
its own, without special tokens.
"""

from __future__ import annotations

import string
from typing import List

_LOWER = string.ascii_lowercase


class Tokenizer:
    """Ids 0-3 are <pad>, <s>, </s>, <unk>; then the 256 bytes; then every
    2- and 3-letter lowercase string; then the same with a leading space."""

    PAD, BOS, EOS = 0, 1, 2

    def __init__(self):
        two = [a + b for a in _LOWER for b in _LOWER]
        three = [a + b + c for a in _LOWER for b in _LOWER for c in _LOWER]
        pieces = [chr(b) for b in range(256)] + two + three
        pieces += [" " + p for p in two] + [" " + p for p in three]
        self.ids = {p: i + 4 for i, p in enumerate(pieces)}
        self.vocab_size = len(pieces) + 4

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        while i < len(text):
            for n in range(min(4, len(text) - i), 1, -1):
                pid = self.ids.get(text[i:i + n])
                if pid is not None:
                    out.append(pid)
                    i += n
                    break
            else:
                out.extend(4 + b for b in text[i].encode("utf-8"))
                i += 1
        return out
