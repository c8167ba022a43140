"""Plain Qwen2-Audio in float32, written from the published model
(transformers' ``Qwen2AudioForConditionalGeneration``): its chat prompt,
Whisper's log-mel, a Whisper encoder over the configuration's mel bins
with each clip's keys masked past its frames, a stride-2 average pool,
the final layer norm, a linear projector, then Qwen2: RMSNorm, rotary
attention with grouped KV heads and q/k/v biases, SwiGLU. The tree is
the one ``benchlib/families/qwen2_audio.py`` draws.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from reference import model as M
from reference.text import Tokenizer


def qwen_segments(template: str, examples: Sequence[Dict], fewshot_mode: str) -> List[str]:
    """Qwen2-Audio's chat prompt for a classification query whose audio is
    the last clip: the system turn, the exemplars (each an audio clip or a
    transcript, then its label), the query's clip, the assistant turn.
    → the text segments around the clips."""
    segments: List[str] = []
    text = f"<|im_start|>system\n{template}<|im_end|>\n<|im_start|>user\n"
    n_audio = 0

    def clip():
        nonlocal text, n_audio
        n_audio += 1
        segments.append(text + f"Audio {n_audio}: <|audio_bos|>")
        text = "<|audio_eos|>\n"

    if examples:
        text += "Here are few examples to learn from:\n"
        for ex in examples:
            if fewshot_mode == "speech":
                clip()
                text += f"Label: {ex['label']}\n"
            else:
                text += f"Text: {ex['text']}\nLabel: {ex['label']}\n"
    text += "\nNow analyze this input:\n"
    clip()
    segments.append(text + "<|im_end|>\n<|im_start|>assistant\n")
    return segments


def audio_positions(n_samples: int) -> int:
    """Positions a clip takes in the prompt, after the stride-2 pool."""
    return (M.audio_frames(n_samples) - 2) // 2 + 1


def encode_clips(cfg: Dict, tree: Dict, wavs: Sequence[np.ndarray], device,
                 precision: M.Precision = M.Precision()) -> List[torch.Tensor]:
    """Raw clips → for each, its (audio_positions(n), D) prompt embeddings."""
    a = cfg["audio_config"]
    enc = tree["encoder"]
    lens = [len(w) for w in wavs]
    x = M.log_mel(M.clip_batch(wavs, device), a["num_mel_bins"]).transpose(1, 2)  # (N, 3000, mels)
    x = M.whisper_encoder(enc, x, a["encoder_attention_heads"], a["encoder_layers"], precision,
                          lens)
    N, T, d = x.shape
    s = cfg["audio_pool_stride"]
    x = x[:, :(T // s) * s].reshape(N, T // s, s, d).mean(dim=2)
    x = M.layer_norm(x, enc["ln_post"]["w"], enc["ln_post"]["b"])
    x = M.lin(x, tree["projector"]["w"], tree["projector"]["b"], precision.tower, precision.act)
    return [x[i, :audio_positions(m)] for i, m in enumerate(lens)]


def _segments(task: Dict, request) -> Tuple[List[str], list]:
    examples = [{"label": e.label, "text": e.text} for e in request.examples]
    segments = qwen_segments(task["template"], examples, task["fewshot_mode"])
    clips = [e.clip for e in request.examples if e.clip is not None] + [request.main_clip]
    return segments, clips


class Plain:
    """``reference/check.py``'s plain model over a Qwen2-Audio tree."""

    def __init__(self, cfg: Dict, tree: Dict):
        t, lora = cfg["text_config"], cfg.get("lora")
        self.cfg, self.tree, self.lora = cfg, tree, tree.get("lora")
        self.sizes = M.DecoderSizes(
            layers=t["num_hidden_layers"], heads=t["num_attention_heads"],
            kv_heads=t["num_key_value_heads"],
            head_dim=t["hidden_size"] // t["num_attention_heads"], rms_eps=t["rms_norm_eps"],
            rope_theta=t["rope_theta"], lora_scaling=lora["alpha"] / lora["rank"] if lora else 0.0)

    def prompt_embeds(self, task: Dict, request, wav: Callable, tok: Tokenizer, device,
                      precision: M.Precision = M.Precision()) -> torch.Tensor:
        """A request's prompt as (P, D) float32 embeddings: text segments and
        clips in turn, each clip ``audio_positions(n)`` rows."""
        segments, clips = _segments(task, request)
        audio = encode_clips(self.cfg, self.tree, [wav(c) for c in clips], device, precision)
        parts = []
        for i, seg in enumerate(segments):
            parts.append(self.embed(tok.encode(seg), device))
            if i < len(audio):
                parts.append(audio[i])
        return torch.cat(parts, dim=0)

    def embed(self, ids: Sequence[int], device) -> torch.Tensor:
        return M.embed(self.tree["llm"]["tok_embed"], ids, device)

    def decoder(self, x: torch.Tensor, lora, precision: M.Precision, cached_from=None,
                checkpointed: bool = False) -> torch.Tensor:
        llm = self.tree["llm"]
        return M.decoder(self.sizes, llm["layers"], llm["final_norm"], x, lora, precision,
                         cached_from, checkpointed)

    def logits(self, hidden: torch.Tensor, precision: M.Precision) -> torch.Tensor:
        return M.logits(self.tree["llm"]["lm_head"], hidden, precision)


def prompt_length(task: Dict, request, tok: Tokenizer) -> Tuple[int, int]:
    """(positions, text tokens) of a request's prompt."""
    segments, clips = _segments(task, request)
    text = sum(len(tok.encode(s)) for s in segments)
    return text + sum(audio_positions(n) for _, n in clips), text

