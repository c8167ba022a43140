"""MELD sentiment + emotion task variants
(ref: data/meld_config.py, data/meld_emotion_config.py)."""

from .base import DatasetConfig, DatasetSplit, DatasetType, make_swap_variants
from .voxceleb import _sentiment_template

MELD_CONFIG = DatasetConfig(
    name=DatasetType.MELD,
    paths={
        DatasetSplit.TRAIN: "meld/meld_train",
        DatasetSplit.VAL: "meld/meld_validation",
        DatasetSplit.TEST: "meld/meld_test",
    },
    # Same sentiment template as VoxCeleb (ref: data/meld_config.py:13-19).
    prompt_template=_sentiment_template(["positive", "negative", "neutral"], ""),
    valid_labels=["positive", "negative", "neutral"],
    completion_key="sentiment_label",
    text_key="text",
    # MELD audio lookups all point at the train split (ref: data/meld_config.py:22-27).
    audio_lookup_paths={
        DatasetSplit.TRAIN: "meld/meld_train",
        DatasetSplit.VAL: "meld/meld_train",
        DatasetSplit.TEST: "meld/meld_train",
    },
)

MELD_GREEK_CONFIG = MELD_CONFIG.with_overrides(
    name=DatasetType.MELD_GREEK,
    # NB: unlike voxceleb_greek, no doubled comma here (ref: data/meld_config.py:33-39).
    prompt_template=_sentiment_template(["alpha", "beta", "gamma"], ""),
    valid_labels=["alpha", "beta", "gamma"],
    label_mapping={"positive": "alpha", "negative": "beta", "neutral": "gamma"},
)

MELD_EMOTION_LABELS = ["neutral", "joy", "sadness", "anger", "fear", "disgust", "surprise"]

# Descriptions in MELD_EMOTION_LABELS order (ref: data/meld_emotion_config.py:113-121).
MELD_EMOTION_DESCRIPTIONS = [
    "no distinct emotional state",
    "happiness, excitement, delight, pleasure, or positive enthusiasm",
    "unhappiness, sorrow, grief, disappointment, or regret",
    "irritation, rage, fury, annoyance, or hostility",
    "terror, anxiety, worry, concern, or nervousness",
    "repulsion, distaste, revulsion, or strong dislike",
    "astonishment, shock, amazement, or unexpected reaction",
]

# The hand-written main template orders guidelines joy..surprise with neutral last
# and phrases neutral specially (ref: data/meld_emotion_config.py:24-34).
_MELD_EMOTION_TEMPLATE = """You are an emotion recognition expert. Based on the input, respond with EXACTLY ONE WORD from these options: neutral, joy, sadness, anger, fear, disgust, or surprise.

Guidelines:
- Choose joy if there is happiness, excitement, delight, pleasure, or positive enthusiasm
- Choose sadness if there is unhappiness, sorrow, grief, disappointment, or regret
- Choose anger if there is irritation, rage, fury, annoyance, or hostility
- Choose fear if there is terror, anxiety, worry, concern, or nervousness
- Choose disgust if there is repulsion, distaste, revulsion, or strong dislike
- Choose surprise if there is astonishment, shock, amazement, or unexpected reaction
- Choose neutral ONLY IF the statement expresses no distinct emotional state"""

MELD_EMOTION_CONFIG = DatasetConfig(
    name=DatasetType.MELD_EMOTION,
    paths={
        DatasetSplit.TRAIN: "meld/MELD_Text_Audio_train_embedding_topk10",
        DatasetSplit.VAL: "meld/MELD_Text_Audio_validation_embedding_topk10",
        DatasetSplit.TEST: "meld/MELD_Text_Audio_test_embedding_topk10",
    },
    prompt_template=_MELD_EMOTION_TEMPLATE,
    valid_labels=MELD_EMOTION_LABELS,
    completion_key="emotion_label",
    text_key="text",
    audio_lookup_paths={
        DatasetSplit.TRAIN: "meld/MELD_Text_Audio_train_audio_lookup",
        DatasetSplit.VAL: "meld/MELD_Text_Audio_validation_audio_lookup",
        DatasetSplit.TEST: "meld/MELD_Text_Audio_test_audio_lookup",
    },
)

_MELD_EMOTION_GREEK_TEMPLATE = """You are an emotion recognition expert. Based on the input, respond with EXACTLY ONE WORD from these options: alpha, beta, gamma, delta, epsilon, zeta, eta.

Guidelines:
- Choose alpha if there is no distinct emotional state (neutral)
- Choose beta if there is happiness, excitement, delight, pleasure, or positive enthusiasm
- Choose gamma if there is unhappiness, sorrow, grief, disappointment, or regret
- Choose delta if there is irritation, rage, fury, annoyance, or hostility
- Choose epsilon if there is terror, anxiety, worry, concern, or nervousness
- Choose zeta if there is repulsion, distaste, revulsion, or strong dislike
- Choose eta if there is astonishment, shock, amazement, or unexpected reaction"""

MELD_EMOTION_GREEK_CONFIG = MELD_EMOTION_CONFIG.with_overrides(
    name=DatasetType.MELD_EMOTION_GREEK,
    prompt_template=_MELD_EMOTION_GREEK_TEMPLATE,
    valid_labels=["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"],
    label_mapping={
        "neutral": "alpha",
        "joy": "beta",
        "sadness": "gamma",
        "anger": "delta",
        "fear": "epsilon",
        "disgust": "zeta",
        "surprise": "eta",
    },
)

# Swap permutations as index permutations over MELD_EMOTION_LABELS
# (ref: data/meld_emotion_config.py:124-154: original, valence, intensity,
# Ekman-first, alphabetical, reverse, social/survival, approach/avoidance,
# conversational frequency, complexity).
_ME_PERM_INDICES = [
    [0, 1, 2, 3, 4, 5, 6], [0, 1, 6, 2, 3, 4, 5], [0, 2, 1, 5, 6, 4, 3],
    [1, 2, 3, 4, 5, 6, 0], [3, 5, 4, 1, 0, 2, 6], [6, 5, 4, 3, 2, 1, 0],
    [1, 2, 0, 6, 3, 4, 5], [1, 3, 6, 2, 4, 5, 0], [0, 1, 3, 2, 6, 4, 5],
    [0, 1, 3, 4, 5, 2, 6],
]
MELD_EMOTION_PERMUTATIONS = [
    [MELD_EMOTION_LABELS[i] for i in p] for p in _ME_PERM_INDICES
]


def _meld_emotion_swap_template(perm) -> str:
    # ref: data/meld_emotion_config.py:192-198
    head = (
        "You are an emotion recognition expert. Based on the input, respond with "
        f"EXACTLY ONE WORD from these options: {', '.join(perm)}."
    )
    body = "\n".join(
        f"- Choose {label} if there is {desc}"
        for label, desc in zip(perm, MELD_EMOTION_DESCRIPTIONS)
    )
    return head + "\n\nGuidelines:\n" + body


MELD_EMOTION_SWAP_CONFIGS = make_swap_variants(
    MELD_EMOTION_CONFIG,
    DatasetType.MELD_EMOTION_SWAP,
    MELD_EMOTION_PERMUTATIONS,
    _meld_emotion_swap_template,
)


def get_meld_emotion_swap_config(randomize: bool = False, rng=None) -> DatasetConfig:
    """Pinned to index 1 when not randomizing (ref: data/meld_emotion_config.py:205-210)."""
    if randomize:
        import random

        return (rng or random).choice(MELD_EMOTION_SWAP_CONFIGS)
    return MELD_EMOTION_SWAP_CONFIGS[1]
