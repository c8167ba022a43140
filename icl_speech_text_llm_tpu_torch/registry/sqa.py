"""SQA spoken question answering task (ref: data/sqa_config.py)."""

from .base import DatasetConfig, DatasetSplit, DatasetType

# Exact reference template, including its idiosyncratic indentation and the
# 4-space-only second line (ref: data/sqa_config.py:11-21) — parity-critical.
_SQA_TEMPLATE = """You are a spoken question answering expert. Your task is to identify the answer in a given document.
{pad4}
    Guidelines:
    - Provide a clear and concise answer to the question
    - Keep answers short (1-2 words whenever possible)
    - Base your answer solely on the information provided in the document
    - Keep the answer focused and relevant to the question
    - Use natural, conversational language
    - Avoid including unnecessary context or explanations
{pad4}
    Remember: Output should be just the answer text.""".format(pad4="    ")

SQA_CONFIG = DatasetConfig(
    name=DatasetType.SQA,
    paths={
        DatasetSplit.TRAIN: "sqa/slue-phase-2_sqa5_train",
        DatasetSplit.VAL: "sqa/slue-phase-2_sqa5_validation",
        DatasetSplit.TEST: "sqa/slue-phase-2_sqa5_test",
    },
    prompt_template=_SQA_TEMPLATE,
    valid_labels=None,
    completion_key="answer_text",
    text_key="normalized_document_text",
    additional_text_keys={"question": "normalized_question_text"},
    additional_audio_keys={
        "question_audio": "question_audio",
        "document_audio": "document_audio",
    },
    additional_metadata_keys={
        "unique_id": "unique_id",
        "question_id": "question_id",
        "document_id": "document_id",
        "speaker_ids": {
            "question": "question_speaker_id",
            "document": "document_speaker_id",
        },
    },
    audio_lookup_paths={
        DatasetSplit.TRAIN: "sqa/slue-phase-2_sqa5_train",
        DatasetSplit.VAL: "sqa/slue-phase-2_sqa5_validation",
        DatasetSplit.TEST: "sqa/slue-phase-2_sqa5_test",
    },
    output_format="timestamps_pair",
)
