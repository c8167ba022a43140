"""HVB (HarperValleyBank) dialog-act task variants (ref: data/hvb_config.py)."""

from .base import DatasetConfig, DatasetSplit, DatasetType, make_swap_variants

HVB_LABELS = [
    "acknowledge", "answer_agree", "answer_dis", "answer_general",
    "apology", "backchannel", "disfluency", "other",
    "question_check", "question_general", "question_repeat",
    "self", "statement_close", "statement_general",
    "statement_instruct", "statement_open", "statement_problem",
    "thanks",
]

# Per-label descriptions, in HVB_LABELS order (ref: data/hvb_config.py:361-380).
HVB_DESCRIPTIONS = [
    "Shows understanding or receipt of information",
    "Expresses agreement",
    "Expresses disagreement",
    "General response to a question",
    "Expression of regret or sorry",
    "Brief verbal/textual feedback (like 'uh-huh', 'mm-hmm')",
    "Speech repairs, repetitions, or corrections",
    "Actions that don't fit other categories",
    "Questions to verify understanding",
    "General information-seeking questions",
    "Requests for repetition",
    "Self-directed speech",
    "Concluding statements",
    "General statements or information",
    "Instructions or directions",
    "Opening statements or greetings",
    "Statements describing issues or problems",
    "Expressions of gratitude",
]

_HVB_GUIDELINES = """

Guidelines:
- Multiple actions can apply to a single statement
- List all applicable actions separated by commas
- Consider the banking context when analyzing
- Be precise in identifying the dialogue actions"""

_HVB_HEAD = (
    "You are a dialogue analysis expert for banking conversations. Based on the "
    "statement below, identify all applicable dialogue actions from the following options:"
    "\n\nAvailable dialogue actions:\n"
)


def _hvb_template(labels, descriptions) -> str:
    body = "\n".join(f"- {label}: {desc}" for label, desc in zip(labels, descriptions))
    return _HVB_HEAD + body + _HVB_GUIDELINES


# The main template uses a slightly different backchannel description wording
# with double quotes (ref: data/hvb_config.py:26-49) — reproduced exactly.
_HVB_MAIN_DESCRIPTIONS = list(HVB_DESCRIPTIONS)
_HVB_MAIN_DESCRIPTIONS[5] = 'Brief verbal/textual feedback (like "uh-huh", "mm-hmm")'

HVB_CONFIG = DatasetConfig(
    name=DatasetType.HVB,
    paths={
        DatasetSplit.TRAIN: "hvb/slue-phase-2_hvb_train_embedding_topk10",
        DatasetSplit.VAL: "hvb/slue-phase-2_hvb_validation_embedding_topk10",
        DatasetSplit.TEST: "hvb/slue-phase-2_hvb_test_embedding_topk10",
    },
    prompt_template=_hvb_template(HVB_LABELS, _HVB_MAIN_DESCRIPTIONS),
    valid_labels=HVB_LABELS,
    completion_key="dialog_acts",
    text_key="text",
    audio_lookup_paths={
        DatasetSplit.TRAIN: "hvb/slue-phase-2_hvb_train_audio_lookup",
        DatasetSplit.VAL: "hvb/slue-phase-2_hvb_validation_audio_lookup",
        DatasetSplit.TEST: "hvb/slue-phase-2_hvb_test_audio_lookup",
    },
)

GREEK_LABELS = [
    "foo", "bar", "baz", "qux", "quux",
    "corge", "grault", "garply", "waldo", "fred",
    "plugh", "xyzzy", "thud", "wibble", "wobble",
    "wubble", "flob", "zoop",
]

# The greek variant drops the parenthetical in the backchannel description and
# has no trailing Guidelines block (ref: data/hvb_config.py:75-105).
_HVB_GREEK_DESCRIPTIONS = list(HVB_DESCRIPTIONS)
_HVB_GREEK_DESCRIPTIONS[5] = "Brief verbal/textual feedback"

HVB_GREEK_CONFIG = HVB_CONFIG.with_overrides(
    name=DatasetType.HVB_GREEK,
    prompt_template=_HVB_HEAD
    + "\n".join(f"- {l}: {d}" for l, d in zip(GREEK_LABELS, _HVB_GREEK_DESCRIPTIONS)),
    valid_labels=GREEK_LABELS,
    label_mapping=dict(zip(HVB_LABELS, GREEK_LABELS)),
)

# Label permutations for swap variants, expressed as index permutations over
# HVB_LABELS (values identical to the reference's hand-written orderings,
# ref: data/hvb_config.py:252-322: question-first, statements-first,
# answers-first, similarity groups, reverse, conversation-flow, response-type,
# alternating, formality).
_HVB_PERM_INDICES = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
    [8, 9, 10, 0, 1, 2, 3, 4, 5, 6, 7, 11, 12, 13, 14, 15, 16, 17],
    [12, 13, 14, 15, 16, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 17],
    [1, 2, 3, 0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
    [0, 5, 6, 11, 1, 2, 3, 8, 9, 10, 12, 13, 14, 15, 16, 4, 17, 7],
    [17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0],
    [15, 9, 3, 8, 1, 2, 0, 5, 6, 10, 13, 16, 14, 4, 11, 7, 12, 17],
    [9, 8, 10, 3, 1, 2, 13, 15, 12, 16, 14, 0, 5, 6, 11, 4, 17, 7],
    [9, 3, 13, 8, 1, 15, 10, 2, 12, 0, 5, 16, 6, 11, 14, 4, 17, 7],
    [14, 13, 9, 3, 16, 8, 1, 2, 15, 12, 0, 10, 5, 6, 11, 4, 17, 7],
]
HVB_PERMUTATIONS = [[HVB_LABELS[i] for i in perm] for perm in _HVB_PERM_INDICES]

HVB_SWAP_CONFIGS = make_swap_variants(
    HVB_CONFIG,
    DatasetType.HVB_SWAP,
    HVB_PERMUTATIONS,
    lambda perm: _hvb_template(perm, HVB_DESCRIPTIONS),
)


def get_hvb_swap_config(randomize: bool = False, rng=None) -> DatasetConfig:
    """Pinned to index 1 when not randomizing (ref: data/hvb_config.py:407-412)."""
    if randomize:
        import random

        return (rng or random).choice(HVB_SWAP_CONFIGS)
    return HVB_SWAP_CONFIGS[1]
