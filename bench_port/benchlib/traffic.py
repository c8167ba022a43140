"""The one traffic generator: a traffic file's parameters and a seed → a
stream of batches of raw ICL requests (clips, transcripts, labels).

Every batch holds the same clip lengths and transcript sizes, quantiles of
the file's distributions, dealt out in another order for each batch; the
seed and the batch's index draw the order, the labels, the words and where
each clip lies in the audio. So every seed asks for the same work, and no
request repeats: batch ``i`` is drawn on first use, the file's
``prepared_batches`` of them in set-up. Audio is one stream of seeded
noise; a clip is a view of it at an offset drawn to the sample, so no two
clips carry the same samples. The warm-up batch is drawn apart from the
stream and is never timed.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

SAMPLE_RATE = 16_000
#: clip lengths are whole 10 ms hops
HOP = 160


@dataclass
class Example:
    label: str
    clip: Optional[Tuple[int, int]] = None  # (offset in the audio stream, samples)
    text: str = ""


@dataclass
class Request:
    examples: List[Example]
    main_clip: Tuple[int, int]
    label: str
    text: str = ""
    key: Tuple[int, int] = (0, 0)  # (batch, row); batch -1 is the warm-up


def _quantiles(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """n lognormal quantiles at (i + 0.5) / n, cut to [lo, hi]."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def _clip_samples(seconds: np.ndarray) -> np.ndarray:
    return (np.round(seconds * SAMPLE_RATE / HOP) * HOP).astype(np.int64)


def _word(rng: np.random.Generator) -> str:
    n = int(rng.integers(3, 9))
    return "".join(chr(ord("a") + int(c)) for c in rng.integers(0, 26, n))


@dataclass
class Traffic:
    """The batches one traffic file and one seed give."""

    spec: Dict
    seed: int
    pool: np.ndarray
    lengths: np.ndarray  # every batch's clip lengths, in samples
    words: Optional[np.ndarray]  # every batch's transcript sizes (text exemplars)
    drawn: Dict[int, List[Request]] = field(default_factory=dict)

    @property
    def task(self) -> Dict:
        return self.spec["task"]

    @property
    def batches(self) -> List[List[Request]]:
        """The batches drawn so far, in order (the warm-up left out)."""
        return [self.drawn[i] for i in sorted(self.drawn) if i >= 0]

    def batch(self, i: int) -> List[Request]:
        if i not in self.drawn:
            self.drawn[i] = self._draw(i)
        return self.drawn[i]

    def warmup(self) -> List[Request]:
        return self.batch(-1)

    def wav(self, clip: Tuple[int, int]) -> np.ndarray:
        offset, n = clip
        return self.pool[offset:offset + n]

    def _draw(self, b: int) -> List[Request]:
        task, spec = self.task, self.spec
        rng = np.random.Generator(np.random.PCG64([self.seed, 1, b + 1]))
        k, bs = int(task["k"]), int(spec["batch_size"])
        labels = task["labels"]
        speech = task["fewshot_mode"] == "speech"
        dealt = rng.permutation(self.lengths).reshape(bs, -1)
        sizes = rng.permutation(self.words).reshape(bs, k) if self.words is not None else None

        def clip(n):
            return (int(rng.integers(len(self.pool) - n + 1)), int(n))

        rows = []
        for r in range(bs):
            examples = []
            for i in range(k):
                label = labels[int(rng.integers(len(labels)))]
                if speech:
                    examples.append(Example(label=label, clip=clip(dealt[r, i])))
                else:
                    text = " ".join(_word(rng) for _ in range(int(sizes[r, i])))
                    examples.append(Example(label=label, text=text))
            rows.append(Request(examples=examples, main_clip=clip(dealt[r, -1]),
                                label=labels[int(rng.integers(len(labels)))], key=(b, r)))
        return rows


def generate(spec: Dict, seed: int) -> Traffic:
    task = spec["task"]
    k, bs = int(task["k"]), int(spec["batch_size"])
    cs = spec["clip_seconds"]
    clips_per_request = k + 1 if task["fewshot_mode"] == "speech" else 1
    lengths = _clip_samples(_quantiles(bs * clips_per_request, cs["median"], cs["sigma"],
                                       cs["min"], cs["max"]))
    words = None
    if clips_per_request == 1:
        tw = spec["transcript_words"]
        words = np.round(np.linspace(tw["min"], tw["max"], bs * k)).astype(np.int64)
    rng = np.random.Generator(np.random.PCG64([seed, 0]))
    n = int(spec["audio_stream_seconds"] * SAMPLE_RATE)
    pool = np.clip(rng.standard_normal(n, dtype=np.float32) * 0.1, -1.0, 1.0)
    traffic = Traffic(spec=spec, seed=seed, pool=pool, lengths=lengths, words=words)
    for b in range(-1, int(spec["prepared_batches"])):
        traffic.batch(b)
    return traffic
