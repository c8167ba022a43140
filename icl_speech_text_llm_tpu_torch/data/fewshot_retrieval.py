"""Few-shot exemplar retrieval: build *_embedding_topk{k} datasets.

Counterpart of ``icl_speech_text_llm_tpu/data/fewshot_retrieval.py``
(ref: archive/utils/generate_fewshots.py:69-112,218 — embedding cosine
top-k over the train split, attached to each eval item as
``few_shot_examples``):

- ``HashedNGramEmbedder`` — deterministic hashed char-ngram embedding,
  fully offline; numpy, the JAX package's code;
- ``topk_similar`` — one ``(Q, D) @ (D, N)`` product on the device and the
  top k of each row by a stable descending sort: equal scores keep the
  lower pool index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order among ties). Hashed embeddings of short or repeated
  texts tie often, and exactly: two pool rows with the same norm and the
  same overlap with the query score the same. An f32 product breaks such
  ties by its summation order, which differs between devices and
  libraries (XLA's and torch's CPU products order 16 of 2000 rows of a
  pool of short texts differently), so each score is formed in f64 and
  rounded once to f32: every device then gives the same f32 scores, the
  exact ties stay ties and the lower index wins;
- ``build_fewshot_dataset`` — the rows the ICL dataset reads.

The JAX package's ``HFEmbedder`` needs a downloaded transformers
checkpoint and has no counterpart here.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..registry import DatasetType, get_dataset_config

logger = logging.getLogger(__name__)


class HashedNGramEmbedder:
    """Character n-gram hashing embedder: deterministic, offline, no training.

    Embeds text as an L2-normalized bag of hashed 3-5-grams — a strong
    lexical-similarity retriever, standing in for BERT-CLS when no checkpoint
    is available.
    """

    def __init__(self, dim: int = 512, ngram_range=(3, 5)):
        self.dim = dim
        self.ngram_range = ngram_range

    def _ngrams(self, text: str):
        text = f" {text.lower().strip()} "
        lo, hi = self.ngram_range
        for n in range(lo, hi + 1):
            for i in range(max(0, len(text) - n + 1)):
                yield text[i : i + n]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for row, text in enumerate(texts):
            for gram in self._ngrams(text):
                h = int.from_bytes(
                    hashlib.blake2b(gram.encode(), digest_size=8).digest(), "little"
                )
                idx = h % self.dim
                sign = 1.0 if (h >> 63) & 1 else -1.0
                out[row, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-8)


def topk_similar(
    query_embeds: np.ndarray, pool_embeds: np.ndarray, k: int,
    exclude_self: Optional[np.ndarray] = None, device="cuda",
) -> np.ndarray:
    """Cosine top-k via one device matmul: (Q, D) @ (D, N) → indices (Q, k),
    each row's best first and ties by the lower pool index. The f32
    embeddings' scores are formed in f64 and rounded to f32 (module
    docstring). ``exclude_self`` (Q,) sets each query's own pool column to
    -inf."""
    q = torch.as_tensor(np.asarray(query_embeds, np.float32), device=device)
    p = torch.as_tensor(np.asarray(pool_embeds, np.float32), device=device)
    sims = (q.double() @ p.double().T).float()  # (Q, N)
    if exclude_self is not None:
        rows = torch.arange(sims.shape[0], device=sims.device)
        cols = torch.as_tensor(np.asarray(exclude_self), device=sims.device).long()
        sims[rows, cols] = float("-inf")
    order = torch.sort(sims, dim=1, descending=True, stable=True).indices
    return order[:, :k].cpu().numpy()


def build_fewshot_dataset(
    items: Sequence[Dict[str, Any]],
    pool: Sequence[Dict[str, Any]],
    dataset_type: DatasetType,
    k: int = 10,
    embedder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    pool_is_self: bool = False,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Attach retrieval-ranked ``few_shot_examples`` to each item.

    ``pool`` is the exemplar source (typically the train split);
    ``pool_is_self=True`` excludes each item's own index (train→train mode).
    Output rows carry {text, label, index} exemplars, the schema the ICL
    dataset consumes (ref datasets *_embedding_topk10). The similarity
    product runs on ``device``.
    """
    config = get_dataset_config(dataset_type)
    embedder = embedder or HashedNGramEmbedder()

    pool_texts = [p[config.text_key] for p in pool]
    item_texts = [it[config.text_key] for it in items]
    pool_embeds = embedder(pool_texts)
    query_embeds = embedder(item_texts) if not pool_is_self else pool_embeds

    exclude = np.arange(len(items)) if pool_is_self else None
    idx = topk_similar(query_embeds, pool_embeds, min(k, len(pool)), exclude, device=device)

    out = []
    for i, item in enumerate(items):
        few = []
        for j in idx[i]:
            p = pool[int(j)]
            few.append(
                {
                    "text": p[config.text_key],
                    "label": p[config.completion_key],
                    "index": str(p.get("index", j)),
                }
            )
        row = dict(item)
        row["few_shot_examples"] = few
        out.append(row)
    logger.info(f"Built fewshot dataset: {len(out)} items × top-{k} exemplars")
    return out
