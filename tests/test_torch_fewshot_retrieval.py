"""Few-shot retrieval of the port (``data/fewshot_retrieval.py``) against the
JAX package's.

- ``HashedNGramEmbedder`` bit for bit;
- ``topk_similar``: JAX's indices wherever the scores are exact in f32
  (embeddings of small multiples of 1/4: every product and sum is exact, so
  both packages see the same ties, lower index first; ``exclude_self``
  included) and wherever they are apart (continuous embeddings). Hashed
  embeddings of short texts tie exactly in real arithmetic, and an f32
  product breaks such ties by its summation order: there the port (f64
  scores rounded once to f32) keeps the exact ties, so it may order
  differently from JAX's f32 product only among scores JAX itself holds
  within a few ulps of each other;
- ``build_fewshot_dataset``: JAX's rows, train→train and eval→train.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.data import fewshot_retrieval as jfr
from icl_speech_text_llm_tpu.registry import DatasetType as JDatasetType
from icl_speech_text_llm_tpu_torch.data import fewshot_retrieval as tfr
from icl_speech_text_llm_tpu_torch.registry import DatasetType

torch.set_num_threads(1)

WORDS = ["positive", "negative", "neutral", "the", "speaker", "says", "that", "movie", "was",
         "great", "terrible", "fine", "really", "not", "quite", "good", "bad"]


def _texts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(1, 9))) for _ in range(n)]


@pytest.mark.parametrize("dim,ngrams", [(512, (3, 5)), (64, (2, 4)), (1000, (1, 1))])
def test_embedder_is_bit_equal_to_jax(dim, ngrams):
    texts = _texts(60) + ["", "  ", "ÜBER naïve café — 東京 🎉", "a", "the the the the"]
    want = jfr.HashedNGramEmbedder(dim, ngrams)(texts)
    got = tfr.HashedNGramEmbedder(dim, ngrams)(texts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _exact_embeds(rng, n, d=16):
    """Multiples of 1/4 in [-1, 1]: f32 products and sums of 16 are exact."""
    return (rng.randint(-4, 5, (n, d)) / 4).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 10, 40])
@pytest.mark.parametrize("self_pool", [False, True])
def test_topk_ties_order_as_jax(k, self_pool):
    rng = np.random.RandomState(k)
    pool = _exact_embeds(rng, 40)
    pool[[7, 19, 33]] = pool[3]  # duplicates: every score ties with row 3's
    pool[25] = 0.0  # a zero row scores 0 with every query
    query = pool[:40] if self_pool else _exact_embeds(rng, 12)
    query = np.concatenate([query, pool[3:4]])
    exclude = np.arange(len(query)) % len(pool) if self_pool else None
    want = np.asarray(jfr.topk_similar(query, pool, k, exclude))
    got = tfr.topk_similar(query, pool, k, exclude, device="cpu")
    assert got.shape == want.shape == (len(query), k)
    np.testing.assert_array_equal(got, want)
    sims = query @ pool.T
    ties = sum(len(np.unique(r)) < len(r) for r in np.sort(sims, axis=1)[:, -k - 1:])
    assert ties > 0  # the case holds ties inside or at the edge of the top k
    if self_pool:  # each query's own row comes last (-inf), past a k below the pool's size
        own = (got == np.arange(len(query))[:, None] % len(pool))
        assert own[:, -1].all() if k == len(pool) else not own.any()


def test_exclude_self_sets_minus_infinity_as_jax():
    """A query whose only positive score is itself: with exclude_self it
    comes last, after the zero scores, as JAX's -inf puts it."""
    pool = np.eye(6, dtype=np.float32)
    for k in (3, 6):
        want = np.asarray(jfr.topk_similar(pool, pool, k, np.arange(6)))
        got = tfr.topk_similar(pool, pool, k, np.arange(6), device="cpu")
        np.testing.assert_array_equal(got, want)
        assert (got[:, -1] == np.arange(6)).all() == (k == 6)


def test_topk_of_apart_scores_equals_jax():
    rng = np.random.RandomState(3)
    pool = rng.randn(300, 48).astype(np.float32)
    query = rng.randn(50, 48).astype(np.float32)
    for k in (1, 10, 300):
        np.testing.assert_array_equal(tfr.topk_similar(query, pool, k, device="cpu"),
                                      np.asarray(jfr.topk_similar(query, pool, k)))


def test_hashed_texts_order_as_jax_up_to_its_rounding_ties():
    texts = _texts(800, seed=4)
    emb = tfr.HashedNGramEmbedder()(texts)
    k, exclude = 10, np.arange(len(texts))
    want = np.asarray(jfr.topk_similar(emb, emb, k, exclude))
    got = tfr.topk_similar(emb, emb, k, exclude, device="cpu")
    # the port's order is the exact one: f64 scores rounded to f32, stable
    exact = (emb.astype(np.float64) @ emb.astype(np.float64).T).astype(np.float32)
    exact[exclude, exclude] = -np.inf
    np.testing.assert_array_equal(got, np.argsort(-exact, axis=1, kind="stable")[:, :k])
    # JAX's f32 scores: where the orders differ, JAX holds the scores tied
    jsims = np.array(jnp.asarray(emb) @ jnp.asarray(emb).T)
    jsims[exclude, exclude] = -np.inf
    rows = np.flatnonzero((got != want).any(axis=1))
    ulp = np.spacing(np.float32(1.0))
    for i in rows:
        np.testing.assert_allclose(jsims[i, got[i]], jsims[i, want[i]], rtol=0, atol=4 * ulp)
    assert len(rows) < len(texts) // 10


def _records(texts, labels, prefix):
    return [{"normalized_text": t, "sentiment": lab, "id": f"{prefix}{i}",
             **({"index": f"{prefix}-{i}"} if i % 3 else {})}
            for i, (t, lab) in enumerate(zip(texts, labels))]


class _ExactEmbedder:
    """A deterministic text → multiples-of-1/4 embedding (exact scores)."""

    def __call__(self, texts):
        out = np.zeros((len(texts), 12), np.float32)
        for r, t in enumerate(texts):
            for j, ch in enumerate(t.encode()):
                out[r, (ch + j) % 12] = ((ch * 7 + j) % 9 - 4) / 4
        return out


@pytest.mark.parametrize("embedder", [None, _ExactEmbedder()], ids=["hashed", "exact"])
@pytest.mark.parametrize("pool_is_self", [False, True])
def test_build_fewshot_dataset_rows_equal_jax(embedder, pool_is_self):
    rng = np.random.RandomState(6)
    labels = list(rng.choice(["positive", "negative", "neutral"], 30))
    pool = _records(_texts(30, seed=7), labels, "p")
    items = pool if pool_is_self else _records(_texts(9, seed=8), labels[:9], "q")
    want = jfr.build_fewshot_dataset(items, pool, JDatasetType.VOXCELEB, k=5,
                                     embedder=embedder, pool_is_self=pool_is_self)
    got = tfr.build_fewshot_dataset(items, pool, DatasetType.VOXCELEB, k=5,
                                    embedder=embedder, pool_is_self=pool_is_self,
                                    device="cpu")
    assert got == want
    assert all(len(r["few_shot_examples"]) == 5 for r in got)
    assert got[0]["few_shot_examples"][0].keys() == {"text", "label", "index"}


def test_build_fewshot_dataset_k_past_the_pool():
    pool = _records(_texts(4), ["a", "b", "c", "d"], "p")
    rows = tfr.build_fewshot_dataset(pool[:2], pool, DatasetType.VOXCELEB, k=10,
                                     device="cpu")
    assert [len(r["few_shot_examples"]) for r in rows] == [4, 4]
