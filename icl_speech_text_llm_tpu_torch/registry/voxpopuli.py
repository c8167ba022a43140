"""VoxPopuli entity-type classification task variants (ref: data/voxpopuli_config.py)."""

from .base import DatasetConfig, DatasetSplit, DatasetType, make_swap_variants

VOXPOPULI_LABELS = ["law", "norp", "org", "person", "place", "quant", "when"]

# Descriptions in VOXPOPULI_LABELS order (ref: data/voxpopuli_config.py:121-129).
VOXPOPULI_DESCRIPTIONS = [
    "Laws, regulations, directives, and legal frameworks",
    "Nationalities, religious, or political groups",
    "Companies, agencies, institutions",
    "People, including fictional characters",
    "Countries, cities, locations",
    "Numbers, quantities, percentages",
    "Dates, times, durations, periods",
]

_VP_HEAD = (
    "You are an Entity Type Classification system. For the given input, identify "
    "which of the following entity types are present:\n\n"
)


def _vp_template(labels, example_a, example_b, none_word) -> str:
    body = "\n".join(f"- {l}: {d}" for l, d in zip(labels, VOXPOPULI_DESCRIPTIONS))
    return (
        _VP_HEAD
        + body
        + "\n\nGuidelines:\n"
        + f"1. Return ONLY the entity type if present (e.g., '{example_a}', '{example_b}')\n"
        + f"2. Return '{none_word}' if no entity types are found\n"
        + "3. Be precise in identifying entity types"
    )


VOXPOPULI_CONFIG = DatasetConfig(
    name=DatasetType.VOXPOPULI,
    paths={
        DatasetSplit.TRAIN: "voxpopuli/slue_voxpopuli_train_embedding_topk10",
        DatasetSplit.VAL: "voxpopuli/slue_voxpopuli_validation_embedding_topk10",
        DatasetSplit.TEST: "voxpopuli/slue_voxpopuli_test_embedding_topk10",
    },
    # ref template (data/voxpopuli_config.py:22-36) uses lowercase examples 'place','person'.
    prompt_template=_vp_template(VOXPOPULI_LABELS, "place", "person", "none"),
    valid_labels=VOXPOPULI_LABELS,
    completion_key="normalized_combined_ner",
    text_key="normalized_text",
    audio_lookup_paths={
        DatasetSplit.TRAIN: "voxpopuli/slue_voxpopuli_train_audio_lookup",
        DatasetSplit.VAL: "voxpopuli/slue_voxpopuli_validation_audio_lookup",
        DatasetSplit.TEST: "voxpopuli/slue_voxpopuli_test_audio_lookup",
    },
)

ZETA_LABELS = ["zeta1", "zeta2", "zeta3", "zeta4", "zeta5", "zeta6", "zeta7"]

# Greek variant renders capitalised Zeta names in the body but lowercase
# valid_labels (ref: data/voxpopuli_config.py:54-82).
_ZETA_DISPLAY = ["Zeta1", "Zeta2", "Zeta3", "Zeta4", "Zeta5", "Zeta6", "Zeta7"]

VOXPOPULI_GREEK_CONFIG = VOXPOPULI_CONFIG.with_overrides(
    name=DatasetType.VOXPOPULI_GREEK,
    prompt_template=_vp_template(_ZETA_DISPLAY, "Zeta5", "Zeta4", "None"),
    valid_labels=ZETA_LABELS,
    label_mapping=dict(zip(VOXPOPULI_LABELS, ZETA_LABELS)),
)

# Greek permutations for swap variants: 7 rotations + people-group,
# abstract-first, reverse (ref: data/voxpopuli_config.py:163-194).
_VP_PERM_INDICES = (
    [[(r + i) % 7 for i in range(7)] for r in range(7)]
    + [[3, 1, 2, 4, 0, 5, 6], [0, 6, 5, 1, 2, 3, 4], [6, 5, 4, 3, 2, 1, 0]]
)
VOXPOPULI_GREEK_PERMUTATIONS = [[ZETA_LABELS[i] for i in p] for p in _VP_PERM_INDICES]

VOXPOPULI_SWAP_CONFIGS = make_swap_variants(
    VOXPOPULI_CONFIG,
    DatasetType.VOXPOPULI_SWAP,
    VOXPOPULI_GREEK_PERMUTATIONS,
    # ref: data/voxpopuli_config.py:197-210 — examples are perm[4], perm[3].
    lambda perm: _vp_template(perm, perm[4], perm[3], "None"),
)


def get_voxpopuli_swap_config(randomize: bool = False, rng=None) -> DatasetConfig:
    """Pinned to index 1 when not randomizing (ref: data/voxpopuli_config.py:217-222)."""
    if randomize:
        import random

        return (rng or random).choice(VOXPOPULI_SWAP_CONFIGS)
    return VOXPOPULI_SWAP_CONFIGS[1]
