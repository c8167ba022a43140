"""The port's task metrics against the JAX package's, task by task.

Every ``DatasetType`` of the port scores the same predictions to the same
dict as JAX's ``evaluate_predictions`` (floats to rel 1e-9 / abs 1e-12 as
``tests/test_evaluation.py`` compares them; ints, lists and keys exact):
the golden cases of ``tests/test_evaluation.py``, seeded random batches
drawn from each task's labels, and batches in which no ground-truth label
is a valid class (JAX returns sklearn's empty-input error there). The
hand-written multi-label F1/precision/recall and BLEU are held to sklearn
and nltk on seeded random inputs.
"""

import json
import math
import os

import numpy as np
import pandas as pd
import pytest
from nltk.translate.bleu_score import SmoothingFunction
from nltk.translate.bleu_score import sentence_bleu as nltk_sentence_bleu
from sklearn.metrics import f1_score, precision_score, recall_score

from icl_speech_text_llm_tpu import evaluation as jeval
from icl_speech_text_llm_tpu.registry import DatasetType as JDatasetType
from icl_speech_text_llm_tpu_torch.evaluation import metrics as tmetrics
from icl_speech_text_llm_tpu_torch.registry import (
    DatasetType,
    get_dataset_config,
    get_swap_config,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _approx_equal(a, b, path=""):
    """``tests/test_evaluation.py``'s comparison, with ints kept exact: a
    float on either side compares to rel 1e-9 / abs 1e-12 (NaN equals NaN),
    anything else must be equal and of the same type."""
    if isinstance(a, float) or isinstance(b, float):
        af, bf = float(a), float(b)
        if math.isnan(af) and math.isnan(bf):
            return
        assert af == pytest.approx(bf, rel=1e-9, abs=1e-12), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _approx_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _approx_equal(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _preds(pairs):
    return [{"text": f"t{i}", "true_label": g, "predicted_label": p}
            for i, (g, p) in enumerate(pairs)]


def _both(pairs, dt):
    """(port, JAX) dicts of one batch; the JAX side through json, as its
    runner writes them."""
    got = tmetrics.evaluate_predictions(_preds(pairs), dt)
    want = jeval.evaluate_predictions(_preds(pairs), JDatasetType(dt.value))
    return got, json.loads(json.dumps(jeval.to_json_compatible(want)))


def _valid_labels(dt):
    cfg = get_swap_config(dt) if dt in tmetrics._SWAP_TYPES else get_dataset_config(dt)
    return [label.lower() for label in cfg.valid_labels or []]


def _random_pairs(dt, seed, n=12):
    """A seeded batch of (true, predicted) strings in the task's own format:
    labels (single or comma-joined), timestamped entity spans, or answers;
    with junk, empty and case-changed predictions among them."""
    rng = np.random.default_rng(seed)
    labels = _valid_labels(dt) or ["alpha", "beta", "gamma"]
    words = ["the", "red", "house", "paris", "blue", "42", "a", "cat", "sat", "on"]

    def one_label():
        return str(rng.choice(labels))

    def multi():
        k = int(rng.integers(1, 4))
        sep = ", " if rng.random() < 0.5 else ","
        return sep.join(str(x) for x in rng.choice(labels, size=k, replace=False))

    def spans():
        parts = []
        for _ in range(int(rng.integers(0, 3))):
            s = float(np.round(rng.uniform(0, 5), 2))
            e = float(np.round(s + rng.uniform(0.1, 2), 2))
            parts.append(f"{rng.choice(['place', 'person', 'org', 'when'])}: {s:.2f} {e:.2f}")
        return "; ".join(parts)

    def answer():
        return " ".join(rng.choice(words, size=int(rng.integers(0, 7))))

    if dt in tmetrics._HVB_ROUTES or dt in tmetrics._VOXPOPULI_ROUTES:
        make = multi
    elif dt == DatasetType.VOXPOPULI_NEL:
        make = spans
    elif dt == DatasetType.SQA:
        make = answer
    else:
        make = one_label
    pairs = []
    for _ in range(n):
        gt = make() if rng.random() < 0.85 else "not_a_label"
        r = rng.random()
        pred = (gt if r < 0.35 else gt.upper() if r < 0.45 else make() if r < 0.8
                else "garbage out" if r < 0.9 else "")
        pairs.append((gt, pred))
    return pairs


# tests/test_evaluation.py's cases, by golden key
GOLDEN_CASES = {
    "voxceleb": (DatasetType.VOXCELEB, [
        ("positive", "positive"), ("negative", "Positive"), ("neutral", "garbage out"),
        ("positive", "I think positive"), ("negative", "negative"), ("neutral", "neutral"),
        ("positive", "negative"), ("invalid_gt", "positive"), ("neutral", ""),
        ("negative", "neg")]),
    "hvb": (DatasetType.HVB, [
        ("acknowledge, answer_agree", "acknowledge"), ("thanks", "thanks, other"),
        ("backchannel", "backchannel"), ("statement_open, thanks", "statement_open, thanks"),
        ("question_check", "nonsense"), ("other", ""),
        ("acknowledge", "acknowledge, acknowledge"), ("disfluency, self", "self")]),
    "voxpopuli": (DatasetType.VOXPOPULI, [
        ("place", "place"), ("none", "none"), ("person, place", "place, person"),
        ("org", "none"), ("when", "when, quant"), ("none", "place"), ("quant", "garbage")]),
    "voxpopuli_nel": (DatasetType.VOXPOPULI_NEL, [
        ("place: 1.00 2.00; person: 3.00 4.00", "PLACE: 1.10 1.90"), ("none", "none"),
        ("org: 0.50 1.50", "org: 0.60 1.40; org: 2.00 3.00"),
        ("person: 2.00 4.00", "person: 2.50 3.50"), ("place: 1.00 2.00", "when: 1.00 2.00")]),
    "sqa": (DatasetType.SQA, [
        ("the red house", "red house"), ("paris", "Paris"), ("42", "42!"), ("unknown", ""),
        ("a long answer about things", "another long answer"), ("", "")]),
    "meld_emotion": (DatasetType.MELD_EMOTION, [
        ("joy", "joy"), ("anger", "angry"), ("neutral", "neutral"), ("surprise", "surprise!"),
        ("fear", "I sense fear here"), ("disgust", "joy"), ("sadness", "sad")]),
}
SQQ_PAIRS = [("1.00 2.00", "1.10 1.90"), ("", ""), ("3.00 5.00", "4.90 6.00"),
             ("0.50 0.80", "0.50 0.80"), ("2.00 4.00", "junk"), ("1.00 3.00", "")]


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(GOLDEN, "metrics.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("key", sorted(GOLDEN_CASES))
def test_golden_case_matches_jax_and_golden(key, golden):
    dt, pairs = GOLDEN_CASES[key]
    got, want = _both(pairs, dt)
    _approx_equal(got, want)
    _approx_equal(got, golden[key])


def test_sqq_matches_jax_and_golden(golden):
    gt, pr = [g for g, _ in SQQ_PAIRS], [p for _, p in SQQ_PAIRS]
    got = tmetrics.evaluate_sqq(gt, pr)
    want = jeval.evaluate_sqq(pd.DataFrame({"text": ["t"] * len(gt), "gt": gt, "pd": pr}))
    _approx_equal(got, want)
    _approx_equal(got, golden["sqq"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dt", list(DatasetType), ids=lambda d: d.value)
def test_every_task_matches_jax_on_random_batches(dt, seed):
    got, want = _both(_random_pairs(dt, seed), dt)
    _approx_equal(got, want)


@pytest.mark.parametrize("dt", list(DatasetType), ids=lambda d: d.value)
def test_no_valid_ground_truth_matches_jax(dt):
    """No ground-truth label is a valid class of the task: the classification
    routes give JAX's dict with sklearn's empty-input error, and nothing
    raises."""
    pairs = [("not_a_label", "positive"), ("other thing", "thanks"), ("", "none")]
    got, want = _both(pairs, dt)
    _approx_equal(got, want)
    if dt in tmetrics._SINGLE_LABEL_ROUTES | tmetrics._HVB_ROUTES | tmetrics._VOXPOPULI_ROUTES:
        assert got == {"error": tmetrics.EMPTY_INPUT_MESSAGE, "accuracy": 0.0}


@pytest.mark.parametrize("dt", [DatasetType.VOXCELEB_GREEK, DatasetType.MELD_EMOTION,
                                DatasetType.MELD_GREEK], ids=lambda d: d.value)
def test_label_of_another_task_gives_the_empty_input_error(dt):
    got, want = _both([("positive", "positive")], dt)
    assert got == want == {"error": tmetrics.EMPTY_INPUT_MESSAGE, "accuracy": 0.0}


def test_empty_list_and_unrouted_types_match_jax():
    assert tmetrics.evaluate_predictions([], DatasetType.HVB) == jeval.evaluate_predictions(
        [], JDatasetType.HVB)
    for dt in (DatasetType.VP_NEL, DatasetType.MELD_EMOTION_SWAP):
        got, want = _both([("x", "y")], dt)
        assert got == want == {"accuracy": 0.0}


@pytest.mark.parametrize("average", [None, "macro", "micro", "weighted"])
@pytest.mark.parametrize("seed", range(4))
def test_multilabel_scores_match_sklearn(seed, average):
    rng = np.random.default_rng(seed)
    n, c = int(rng.integers(1, 30)), int(rng.integers(2, 9))
    y_true = (rng.random((n, c)) < rng.uniform(0.05, 0.6)).astype(np.float64)
    y_pred = (rng.random((n, c)) < rng.uniform(0.05, 0.6)).astype(np.float64)
    y_true[:, 0] = 0  # a class with no support
    y_pred[:, -1] = 0  # a class never predicted
    for ours, theirs in ((tmetrics.multilabel_f1, f1_score),
                         (tmetrics.multilabel_precision, precision_score),
                         (tmetrics.multilabel_recall, recall_score)):
        got = ours(y_true, y_pred, average)
        want = theirs(y_true, y_pred, average=average, zero_division=0)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_multilabel_scores_of_all_zero_matrices_match_sklearn():
    z = np.zeros((3, 4))
    for average in (None, "macro", "micro", "weighted"):
        np.testing.assert_array_equal(tmetrics.multilabel_f1(z, z, average),
                                      f1_score(z, z, average=average, zero_division=0))
    with pytest.raises(ValueError, match="minimum of 1 sample"):
        tmetrics.multilabel_f1(np.zeros((0, 4)), np.zeros((0, 4)))


@pytest.mark.parametrize("seed", range(6))
def test_sentence_bleu_matches_nltk(seed):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(int(rng.integers(2, 8)))]
    smoother = SmoothingFunction().method1
    for _ in range(40):
        ref = list(rng.choice(vocab, size=int(rng.integers(1, 9))))
        hyp = list(rng.choice(vocab, size=int(rng.integers(0, 9))))
        if rng.random() < 0.3:
            hyp = ref[: int(rng.integers(1, len(ref) + 1))]
        got = tmetrics.sentence_bleu(ref, hyp)
        want = nltk_sentence_bleu([ref], hyp, smoothing_function=smoother)
        assert type(got) is type(want), (ref, hyp, got, want)
        assert got == pytest.approx(want, rel=1e-12, abs=0), (ref, hyp)
