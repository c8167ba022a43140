"""Beam search with HF semantics, in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/inference/beam.py`` (the generation
options the reference forwards to HF ``generate``: ``num_beams``,
``repetition_penalty``, ``length_penalty``, ``min_length``):

- K beams per sample; the prompt is prefilled once on B rows and every cache
  leaf (the int8 cache's scale planes too) is then expanded to B·K rows,
  beam-major within each sample;
- HF ``BeamSearchScorer`` semantics: 2K candidates a step, EOS candidates
  among the top K ranks become finished hypotheses scored
  ``cum_logprob / len**length_penalty`` over the generated length, non-EOS
  candidates fill the K running beams in rank order; with
  ``early_stopping=False`` a sample finishes when its worst finished
  hypothesis outscores the best attainable running continuation;
- the cache rows follow the selected beams each step (``index_select`` on
  the batch axis, one copy of each leaf);
- processors in HF's beam order: log-softmax → repetition penalty →
  min-length EOS ban → add the beam scores;
- ``do_sample`` gives stochastic beam search: candidates ranked by
  Gumbel-perturbed temperature-warped scores (Gumbel top-2K, sampling without
  replacement), the true log-probs accumulated.

Every top-k is a stable descending sort, so ties keep the lower index first
as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.llama import decode_step, embed_tokens, lm_logits
from ..utils.perf import span
from .engine import _process_logits, prefill, sampling_generator

NEG = -1e9


def _norm(cum: torch.Tensor, length, length_penalty: float) -> torch.Tensor:
    """Length-normalized score cum / len**penalty. As in the JAX package, a
    hypothesis ended by EOS at the first step (length 0) divides by
    max(len, 1) == 1, where HF divides by 0**length_penalty; every
    hypothesis with a generated token matches HF."""
    length = torch.as_tensor(length, device=cum.device)
    return cum / (length.clamp(min=1).float() ** length_penalty)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, T) rows idx (B, M) → (B, M, T)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def beam_decode_from_sequence(llm_cfg, llm_params: Dict[str, Any], seq: torch.Tensor,
                              lengths: torch.Tensor, gen, lora=None,
                              lora_scaling: float = 1.0, dt=torch.float32,
                              events=None, generator=None) -> torch.Tensor:
    """Prefill once, then K-wide beam decode → (B, max_new_tokens) int32
    tokens of each sample's best hypothesis, EOS-filled past its end.
    ``events`` (CUDA) marks the prefill and each decode step. Stochastic
    beams draw from ``generator`` where given (the serving engine's), else
    from a new one seeded with ``gen.seed``."""
    mark = events.mark if events is not None else (lambda: None)
    B, L, _ = seq.shape
    K, Tmax, lp = gen.num_beams, gen.max_new_tokens, gen.length_penalty
    dev = seq.device
    V = llm_cfg.vocab_size
    sample = bool(gen.do_sample) and gen.temperature > 0
    rng = (generator or sampling_generator(gen, dev)) if sample else None
    temp = gen.temperature if sample else 1.0
    cache_len = -(-(L + Tmax) // 128) * 128

    def select(state, scores_bkv, t):
        """One HF BeamSearchScorer.process step; t = tokens generated so far."""
        run_scores, run_toks, hyp_scores, hyp_toks, hyp_lens, batch_done = state
        flat = scores_bkv.reshape(B, K * V)
        if rng is not None:
            gumbel = -torch.empty_like(flat).exponential_(generator=rng).log()
            _, top_idx = _top_k(flat / temp + gumbel, 2 * K)
            top_scores = torch.gather(flat, 1, top_idx)
        else:
            top_scores, top_idx = _top_k(flat, 2 * K)  # (B, 2K)
        tok2k = (top_idx % V).to(torch.int32)
        beam2k = top_idx // V
        is_eos = tok2k == gen.eos_token_id

        # finished hypotheses: EOS candidates at rank < K
        cand_hist = _take_rows(run_toks, beam2k)  # (B, 2K, Tmax)
        cand_valid = is_eos & (rank < K)[None] & ~batch_done[:, None]
        cand_norm = torch.where(cand_valid, _norm(top_scores, t, lp),
                                torch.full_like(top_scores, float("-inf")))
        all_scores = torch.cat([hyp_scores, cand_norm], dim=1)  # (B, 3K)
        all_toks = torch.cat([hyp_toks, cand_hist], dim=1)
        all_lens = torch.cat([hyp_lens, torch.full((B, 2 * K), t, dtype=torch.int32,
                                                   device=dev)], dim=1)
        hyp_scores, keep = _top_k(all_scores, K)
        hyp_toks = _take_rows(all_toks, keep)
        hyp_lens = torch.gather(all_lens, 1, keep)

        # running beams: non-EOS candidates in rank order, the first K
        perm = torch.argsort(is_eos.long() * (2 * K) + rank, dim=-1, stable=True)[:, :K]
        sel_scores = torch.gather(top_scores, 1, perm)
        sel_tok = torch.gather(tok2k, 1, perm)
        sel_beam = torch.gather(beam2k, 1, perm)

        # finished samples keep their state and append pad
        frozen = batch_done[:, None]
        new_scores = torch.where(frozen, run_scores, sel_scores)
        step_tok = torch.where(frozen, torch.full_like(sel_tok, gen.pad_token_id), sel_tok)
        src_beam = torch.where(frozen, ar_k[None].expand(B, K), sel_beam)
        new_toks = _take_rows(run_toks, src_beam)
        new_toks[:, :, t] = torch.where(frozen, new_toks[:, :, t], step_tok)

        # early_stopping=False: done when the worst finished ≥ the best attainable
        worst = hyp_scores.min(dim=1).values
        best_running = _norm(new_scores.max(dim=1).values, t + 1, lp)
        batch_done = batch_done | (worst >= best_running)
        return ((new_scores, new_toks, hyp_scores, hyp_toks, hyp_lens, batch_done),
                step_tok, src_beam)

    def processors(logprobs, run_toks, t):
        """HF beam-search processor order on (B, K, V) log-softmax scores."""
        return _process_logits(logprobs.reshape(B * K, V), run_toks.reshape(B * K, Tmax),
                               t, gen).reshape(B, K, V)

    with span("prefill"):
        mark()
        lengths = lengths.to(device=dev, dtype=torch.int32)
        first_logits, cache = prefill(llm_cfg, llm_params, seq, lengths, cache_len, lora,
                                      lora_scaling, dt, gen.kv_int8)
        # B rows → B·K rows, beam-major within each sample (scale planes too)
        cache = {name: c.repeat_interleave(K, dim=1) for name, c in cache.items()}

        ar_k = torch.arange(K, device=dev)
        run_scores = torch.where(ar_k == 0, 0.0, NEG).float()[None].repeat(B, 1)  # (B, K)
        run_toks = torch.full((B, K, Tmax), gen.pad_token_id, dtype=torch.int32, device=dev)
        hyp_scores = torch.full((B, K), float("-inf"), device=dev)
        hyp_toks = torch.full((B, K, Tmax), gen.pad_token_id, dtype=torch.int32, device=dev)
        hyp_lens = torch.zeros((B, K), dtype=torch.int32, device=dev)
        batch_done = torch.zeros((B,), dtype=torch.bool, device=dev)
        rank = torch.arange(2 * K, device=dev)

        # t = 0: every beam shares the prefill's logits; no cache reorder (the
        # beam rows are copies)
        state = (run_scores, run_toks, hyp_scores, hyp_toks, hyp_lens, batch_done)
        logprobs0 = torch.log_softmax(first_logits.float(), dim=-1)[:, None].expand(B, K, V)
        scores0 = processors(logprobs0, run_toks, 0) + run_scores[..., None]
        state, tok, _ = select(state, scores0, 0)
        mark()

    cur_len = lengths.repeat_interleave(K)  # (B·K,) append position of the next row
    base = (torch.arange(B, device=dev) * K)[:, None]
    with span("decode"):
        for t in range(1, Tmax):
            emb = embed_tokens(llm_params, tok.reshape(B * K, 1), dtype=dt)
            hidden, cache = decode_step(llm_cfg, llm_params, emb, cache, cur_len, lora,
                                        lora_scaling, gen.use_flash_decode)
            logits = lm_logits(llm_cfg, llm_params, hidden)[:, 0].float()
            logprobs = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
            scores = processors(logprobs, state[1], t) + state[0][..., None]
            state, tok, src_beam = select(state, scores, t)
            # the cache rows follow the selected beams, one leaf at a time (the
            # old leaf is freed as its copy replaces it)
            flat_src = (src_beam + base).reshape(B * K)
            for name in cache:
                cache[name] = cache[name].index_select(1, flat_src)
            cur_len = cur_len + 1
            mark()

    run_scores, run_toks, hyp_scores, hyp_toks, hyp_lens, batch_done = state
    # finalize: the surviving running beams become hypotheses (HF finalize)
    fin_norm = torch.where(~batch_done[:, None], _norm(run_scores, Tmax, lp),
                           torch.full_like(run_scores, float("-inf")))
    all_scores = torch.cat([hyp_scores, fin_norm], dim=1)
    all_toks = torch.cat([hyp_toks, run_toks], dim=1)
    all_lens = torch.cat([hyp_lens, torch.full((B, K), Tmax, dtype=torch.int32, device=dev)],
                         dim=1)
    best = _top_k(all_scores, 1)[1]  # (B, 1): the first of equal maxima, as argmax
    toks = _take_rows(all_toks, best)[:, 0]  # (B, Tmax)
    lens = torch.gather(all_lens, 1, best)  # (B, 1)
    # EOS-fill past each hypothesis end so host-side decoding stops there
    past = torch.arange(Tmax, device=dev)[None] >= lens
    return torch.where(past, torch.full_like(toks, gen.eos_token_id), toks)
