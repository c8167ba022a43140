"""ICL prompt assembly.

String-level parity with the reference's SALMONN prompt builder
(ref: data/model_processors.py:616-776) and the marker conventions consumed by
``custom_prompt_wrap`` (ref: models/custom_salmon.py:115-299): ``<Example{i}>``,
``<SpeechHere>``, ``<Document{i}>/<Question{i}>``, wrapped in
``<Speech>...</Speech>`` tags.

Unlike the reference (which re-splits prompt strings on markers inside the
model's forward), this module ALSO emits the split structure directly —
``PromptPlan`` — so the device-side packer never parses strings.

A copy of ``icl_speech_text_llm_tpu/data/prompts.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from icl_speech_text_llm_tpu.registry import DatasetType

SPEECH_TAG_START = "<Speech>"
SPEECH_TAG_END = "</Speech>"
SPEECH_PLACEHOLDER = "<SpeechHere>"

#: Audio-slot roles, in the order their embeddings are spliced.
EXAMPLE_SLOT = "example"
MAIN_SLOT = "main"
DOC_SLOT = "document"
QUESTION_SLOT = "question"


@dataclass
class PromptPlan:
    """A prompt split into text segments interleaved with audio slots.

    ``segments`` has length ``len(slots) + 1``; the rendered prompt is
    ``segments[0] + <slot0> + segments[1] + <slot1> + ... + segments[-1]``.
    ``slots[i]`` names the audio that goes between segment i and i+1
    (e.g. ("example", 0) or ("main", 0) / ("document", 0), ("question", 0)).
    """

    segments: List[str]
    slots: List[tuple] = field(default_factory=list)
    prompt: str = ""

    @property
    def num_slots(self) -> int:
        return len(self.slots)


def _render_examples_block(examples, fewshot_mode: str) -> str:
    """Few-shot block (ref: data/model_processors.py:744-763)."""
    if not examples:
        return ""
    if fewshot_mode == "speech":
        body = "\n\n".join(
            f"<Speech><Example{i}></Speech>\nOutput: {ex.get('label', '')}"
            for i, ex in enumerate(examples)
        )
    else:
        body = "\n\n".join(
            f"Text: {ex.get('text', '')}\nOutput: {ex.get('label', '')}" for ex in examples
        )
    return f"\nHere are few examples to learn from:\n{body}\n\n"


def build_default_prompt(
    template: str,
    text: str,
    examples: Optional[List[Dict]] = None,
    input_mode: str = "speech_and_text",
    fewshot_mode: str = "text",
) -> PromptPlan:
    """Classification-style prompt (ref: data/model_processors.py:737-776)."""
    examples_text = _render_examples_block(examples, fewshot_mode)

    if input_mode == "speech_and_text":
        input_section = f"<Speech><SpeechHere></Speech>\nTranscript: {text}"
    elif input_mode == "text_only":
        input_section = f"Text: {text}"
    else:  # speech_only
        input_section = "<Speech><SpeechHere></Speech>"

    prompt = f"{template}\n{examples_text}Now analyze this input:\n{input_section}\nOutput:"
    return _split_default(prompt, len(examples or []) if fewshot_mode == "speech" else 0,
                          has_main="speech" in input_mode)


def build_sqa_prompt(
    template: str,
    text: str,
    question: str,
    examples: Optional[List[Dict]] = None,
    input_mode: str = "speech_only",
    fewshot_mode: str = "text",
) -> PromptPlan:
    """SQA dual-audio prompt (ref: data/model_processors.py:697-740).

    NB: the reference emits a stray '>' before the example question tag
    ("Question: ><Speech>...") — reproduced for parity.
    """
    examples_text = ""
    if examples:
        if fewshot_mode == "speech":
            body = "\n\n".join(
                f"Document: <Speech><Document{i}></Speech>\n"
                f"Question: ><Speech><Question{i}></Speech>\n"
                f"Output: {ex.get('completion', '')}"
                for i, ex in enumerate(examples)
            )
        else:
            body = "\n\n".join(
                f"Document: {ex.get('document', '')}\n"
                f"Question: {ex.get('question', '')}\n"
                f"Output: {ex.get('completion', '')}"
                for ex in examples
            )
        examples_text = f"\nHere are few examples to learn from:\n{body}\n\n"

    if input_mode == "speech_and_text":
        input_section = (
            f"Document: <Speech><Document></Speech>\n"
            f"Document text: {text}\n"
            f"Question: <Speech><Question></Speech>\n"
            f"Question text: {question}"
        )
    elif input_mode == "text_only":
        input_section = f"\nDocument: {text}\nQuestion: {question}"
    else:  # speech_only
        input_section = "\nDocument: <Speech><Document></Speech>\n Question: <Speech><Question></Speech>"

    prompt = f"{template}\n{examples_text} Now analyze this input:\n{input_section}\nOutput:"
    return _split_sqa(
        prompt,
        len(examples or []) if fewshot_mode == "speech" else 0,
        has_main="speech" in input_mode,
    )


def format_prompt(
    template: str,
    text: str,
    examples: Optional[List[Dict]] = None,
    input_mode: str = "speech_and_text",
    fewshot_mode: str = "text",
    dataset_type: Optional[DatasetType] = None,
    **kwargs,
) -> str:
    """Reference-compatible string API (ref: data/model_processors.py:683-695)."""
    if dataset_type == DatasetType.SQA:
        return build_sqa_prompt(
            template, text, kwargs.get("question", ""), examples, input_mode, fewshot_mode
        ).prompt
    return build_default_prompt(template, text, examples, input_mode, fewshot_mode).prompt


def build_qwen_prompt(
    template: str,
    text: str,
    examples: Optional[List[Dict]] = None,
    input_mode: str = "speech_and_text",
    fewshot_mode: str = "text",
    dataset_type: Optional[DatasetType] = None,
    question: str = "",
) -> PromptPlan:
    """Qwen2-Audio chat-format prompt.

    Renders the reference's conversation structure
    (ref: data/model_processors.py:226-383 — system template, examples with
    audio placeholders, 'Now analyze this input:') through the Qwen2-Audio
    chat template textually: each audio becomes
    ``Audio {n}: <|audio_bos|><|AUDIO|><|audio_eos|>`` and the plan records
    an audio slot at that position.
    """
    segments: List[str] = []
    slots: List[tuple] = []
    parts: List[str] = [
        f"<|im_start|>system\n{template}<|im_end|>\n<|im_start|>user\n"
    ]
    audio_count = 0

    def add_audio(slot):
        nonlocal audio_count
        audio_count += 1
        parts.append(f"Audio {audio_count}: <|audio_bos|>")
        segments.append("".join(parts))
        parts.clear()
        slots.append(slot)
        parts.append("<|audio_eos|>\n")

    is_sqa = dataset_type == DatasetType.SQA
    if examples:
        parts.append("Here are few examples to learn from:\n")
        for i, ex in enumerate(examples):
            if fewshot_mode == "speech":
                if is_sqa:
                    add_audio((QUESTION_SLOT, i))
                    add_audio((DOC_SLOT, i))
                    parts.append(f"Answer: {ex.get('completion', '')}\n")
                else:
                    add_audio((EXAMPLE_SLOT, i))
                    parts.append(f"Label: {ex.get('label', '')}\n")
            else:
                if is_sqa:
                    parts.append(
                        f"Question: {ex.get('question', '')}\n"
                        f"Document: {ex.get('document', '')}\n"
                        f"Answer: {ex.get('completion', '')}\n"
                    )
                else:
                    parts.append(
                        f"Text: {ex.get('text', '')}\nLabel: {ex.get('label', '')}\n"
                    )
    parts.append("\nNow analyze this input:\n")
    if is_sqa:
        if "speech" in input_mode:
            add_audio((QUESTION_SLOT, -1))
            if input_mode == "speech_and_text" and question:
                parts.append(f"Question text: {question}\n")
            add_audio((DOC_SLOT, -1))
            if input_mode == "speech_and_text" and text:
                parts.append(f"Document text: {text}")
        else:
            parts.append(f"Question: {question}\nDocument: {text}")
    else:
        if "speech" in input_mode:
            add_audio((MAIN_SLOT, 0))
        if input_mode == "speech_and_text" and text:
            parts.append(text)
        elif input_mode == "text_only":
            parts.append(text)
    parts.append("<|im_end|>\n<|im_start|>assistant\n")
    segments.append("".join(parts))

    prompt = ""
    for i, seg in enumerate(segments[:-1]):
        prompt += seg + "<|AUDIO|>"
    prompt += segments[-1]
    return PromptPlan(segments=segments, slots=slots, prompt=prompt)


def _split_default(prompt: str, num_speech_examples: int, has_main: bool) -> PromptPlan:
    """Split on <Example{i}> then <SpeechHere>, mirroring the reference's
    splice order (ref: models/custom_salmon.py:150-175,242-267)."""
    segments: List[str] = []
    slots: List[tuple] = []
    suffix = prompt
    for i in range(num_speech_examples):
        marker = f"<Example{i}>"
        if marker in suffix:
            before, suffix = suffix.split(marker, 1)
            segments.append(before)
            slots.append((EXAMPLE_SLOT, i))
        else:
            segments.append("")
            slots.append((EXAMPLE_SLOT, i))
    if has_main and SPEECH_PLACEHOLDER in suffix:
        before, suffix = suffix.split(SPEECH_PLACEHOLDER, 1)
        segments.append(before)
        slots.append((MAIN_SLOT, 0))
    segments.append(suffix)
    return PromptPlan(segments=segments, slots=slots, prompt=prompt)


#: the boundary between the reusable ICL header (instruction template +
#: few-shot exemplar block) and the per-request query section — every prompt
#: builder in this module renders it (ref: data/model_processors.py:737-776)
QUERY_MARKER = "Now analyze this input:"


def split_prompt_plan(plan: PromptPlan):
    """Split a rendered plan at ``QUERY_MARKER`` → (prefix, suffix) plans.

    The prefix (template + exemplar block, with its exemplar audio slots) is
    what a serving deployment pins per task and registers ONCE via
    ``ContinuousBatchingEngine.register_prefix``; the suffix (query section,
    carrying the main audio slot) is what each request prefills.

    Tokenization note: segments are tokenized part-wise already (the
    reference's convention, ref models/custom_salmon.py:178-181), so the only
    possible divergence from the unsplit prompt is one BPE merge at the seam
    inside the segment that contains the marker.
    """
    for i, seg in enumerate(plan.segments):
        pos = seg.find(QUERY_MARKER)
        if pos < 0:
            continue
        p = plan.prompt.find(QUERY_MARKER)
        prefix = PromptPlan(
            segments=plan.segments[:i] + [seg[:pos]], slots=plan.slots[:i],
            prompt=plan.prompt[:p] if p >= 0 else "")
        suffix = PromptPlan(
            segments=[seg[pos:]] + plan.segments[i + 1:], slots=plan.slots[i:],
            prompt=plan.prompt[p:] if p >= 0 else "")
        return prefix, suffix
    raise ValueError(
        f"plan has no {QUERY_MARKER!r} to split at (segments: "
        f"{[s[:30] for s in plan.segments]})")


def _split_sqa(prompt: str, num_speech_examples: int, has_main: bool) -> PromptPlan:
    """SQA split: per example <Document{i}> then <Question{i}>; then the final
    <Document>/<Question> pair (ref: models/custom_salmon.py:136-148,161-165)."""
    segments: List[str] = []
    slots: List[tuple] = []
    suffix = prompt
    for i in range(num_speech_examples):
        d_marker, q_marker = f"<Document{i}>", f"<Question{i}>"
        if d_marker in suffix and q_marker in suffix:
            before_d, rest = suffix.split(d_marker, 1)
            middle, suffix = rest.split(q_marker, 1)
            segments.extend([before_d, middle])
            slots.extend([(DOC_SLOT, i), (QUESTION_SLOT, i)])
    if has_main and "<Question>" in suffix:
        before_d, rest = suffix.split("<Document>", 1)
        middle, suffix = rest.split("<Question>", 1)
        segments.extend([before_d, middle])
        slots.extend([(DOC_SLOT, -1), (QUESTION_SLOT, -1)])
    segments.append(suffix)
    return PromptPlan(segments=segments, slots=slots, prompt=prompt)
