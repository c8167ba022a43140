"""The reference's text side, written from the published formats and frozen
here: the in-repository tokenizer (a greedy longest-match over bytes and
2-3 letter pieces, 36764 ids) and Qwen2-Audio's chat prompt for a
classification task with k labelled exemplars.

A prompt is a list of text segments with one audio clip between each two:
exemplar clips in order, then the query's clip. Each segment is tokenized
on its own, without special tokens.
"""

from __future__ import annotations

import string
from typing import Dict, List, Sequence

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


def qwen_segments(template: str, examples: Sequence[Dict], fewshot_mode: str) -> List[str]:
    """Qwen2-Audio's chat prompt for a classification query whose audio is
    the last clip: the system turn, the exemplars (each an audio clip or a
    transcript, then its label), the query's clip, the assistant turn.
    → the text segments around the clips."""
    segments: List[str] = []
    text = f"<|im_start|>system\n{template}<|im_end|>\n<|im_start|>user\n"
    n_audio = 0

    def clip():
        nonlocal text, n_audio
        n_audio += 1
        segments.append(text + f"Audio {n_audio}: <|audio_bos|>")
        text = "<|audio_eos|>\n"

    if examples:
        text += "Here are few examples to learn from:\n"
        for ex in examples:
            if fewshot_mode == "speech":
                clip()
                text += f"Label: {ex['label']}\n"
            else:
                text += f"Text: {ex['text']}\nLabel: {ex['label']}\n"
    text += "\nNow analyze this input:\n"
    clip()
    segments.append(text + "<|im_end|>\n<|im_start|>assistant\n")
    return segments
