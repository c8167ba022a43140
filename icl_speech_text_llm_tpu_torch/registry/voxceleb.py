"""VoxCeleb sentiment task variants (ref: data/voxceleb_config.py)."""

from .base import DatasetConfig, DatasetSplit, DatasetType, make_swap_variants

_SENTIMENT_GUIDELINES = (
    "Guidelines:\n"
    "- Choose {pos} if there is ANY hint of: approval, optimism, happiness, success, "
    "laughter, enjoyment, pride, or satisfaction\n"
    "- Choose {neg} if there is ANY hint of: criticism, pessimism, sadness, failure, "
    "frustration, anger, disappointment, or concern\n"
    "- Choose {neu} ONLY IF the statement is purely factual with zero emotional content"
)


def _sentiment_template(labels, lead_in: str) -> str:
    pos, neg, neu = labels
    head = (
        "You are a sentiment analysis expert. Based on the input,"
        f"{lead_in} respond with EXACTLY ONE WORD from these options: "
        f"{pos}, {neg}, or {neu}."
    )
    return head + "\n\n" + _SENTIMENT_GUIDELINES.format(pos=pos, neg=neg, neu=neu)


VOXCELEB_CONFIG = DatasetConfig(
    name=DatasetType.VOXCELEB,
    paths={
        DatasetSplit.TRAIN: "voxceleb/slue_voxceleb_train_embedding_topk10",
        DatasetSplit.VAL: "voxceleb/slue_voxceleb_validation_embedding_topk10",
        DatasetSplit.TEST: "voxceleb/slue_voxceleb_test_embedding_topk10",
    },
    # Exact reference template (ref: data/voxceleb_config.py:44-50) — parity-critical.
    prompt_template=_sentiment_template(["positive", "negative", "neutral"], ""),
    valid_labels=["positive", "negative", "neutral"],
    completion_key="sentiment",
    text_key="normalized_text",
    audio_lookup_paths={
        DatasetSplit.TRAIN: "voxceleb/slue_voxceleb_train_audio_lookup",
        DatasetSplit.VAL: "voxceleb/slue_voxceleb_validation_audio_lookup",
        DatasetSplit.TEST: "voxceleb/slue_voxceleb_test_audio_lookup",
    },
)

# The reference's greek template contains a doubled comma after "input,"
# (ref: data/voxceleb_config.py:66) — reproduced for byte parity.
VOXCELEB_GREEK_CONFIG = VOXCELEB_CONFIG.with_overrides(
    name=DatasetType.VOXCELEB_GREEK,
    prompt_template=_sentiment_template(["alpha", "beta", "gamma"], ","),
    valid_labels=["alpha", "beta", "gamma"],
    label_mapping={"positive": "alpha", "negative": "beta", "neutral": "gamma"},
)

# Greek-label permutations for swap variants as index permutations
# (ref: data/voxceleb_config.py:140-149).
_GREEK = ["alpha", "beta", "gamma"]
_VOX_PERM_INDICES = [[1, 0, 2], [1, 2, 0], [0, 2, 1], [0, 1, 2], [2, 1, 0], [2, 0, 1]]
VOXCELEB_PERMUTATIONS_GREEKS = [[_GREEK[i] for i in p] for p in _VOX_PERM_INDICES]

VOXCELEB_SWAP_CONFIGS = make_swap_variants(
    VOXCELEB_CONFIG,
    DatasetType.VOXCELEB_SWAP,
    VOXCELEB_PERMUTATIONS_GREEKS,
    lambda perm: _sentiment_template(perm, ""),
)


def get_voxceleb_swap_config(randomize: bool = False, rng=None) -> DatasetConfig:
    """Pick a swap variant; pinned to index 1 when not randomizing
    (ref: data/voxceleb_config.py:168-173)."""
    if randomize:
        import random

        return (rng or random).choice(VOXCELEB_SWAP_CONFIGS)
    return VOXCELEB_SWAP_CONFIGS[1]
