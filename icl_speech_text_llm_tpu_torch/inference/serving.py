"""Continuous-batching serving engine: a slot pool with static shapes.

Counterpart of ``icl_speech_text_llm_tpu/inference/serving.py``:

- a fixed number of decode slots, each owning a contiguous region of a
  pooled KV cache ``(n_layers, S + 1, n_kv, cache_len, hd)``; row S is a
  scratch row that never decodes as live;
- admission: waiting requests of one prompt bucket prefill together as a
  wave padded to ``admit_batch`` rows (``decoder_forward``, attention
  through K1), and each real row's KV block is copied into its slot;
- one decode block advances every slot ``sync_every`` steps
  (``decode_step``: the plain ``DecodeAttention.XLA`` math, as the JAX
  engine sets ``"xla"`` on one chip, and one K4 append a step, K4 q8 for
  the int8 pool); finished and empty slots ride along masked, their
  lengths frozen, so their append rewrites one in-bounds position;
- the schedule is host-deterministic: a slot's occupant is known to be
  finished once its ``max_new_tokens`` steps are scheduled (EOS only ends
  it earlier), so slots are reclaimed without reading a token back. Tokens
  stay on the device until ``_flush`` moves every pending block to the
  host in one transfer and replays the log of admissions and decode
  blocks into per-request results. The engine reads no device value
  anywhere else, and sends host values to the card by pinned,
  non-blocking copies;
- prefix caching (``register_prefix``): a shared prompt prefix prefilled
  once, its KV copied into each admitted slot, and requests prefill only
  their suffix over it; chunked admission (``chunk_len``): fixed-size
  chunk prefills with a decode block between chunks; a multi-LoRA bank
  (``stack_lora_bank``) with per-request ``adapter_id``; the beam lane
  (``num_beams > 1``): a whole beam search per wave through
  ``inference/beam.py``.

What differs from the JAX engine is its XLA workarounds: the jitted bodies
are plain functions, ``lax.scan`` over ``sync_every`` steps a loop, a
``dynamic_update_slice`` into a slot an in-place copy into
``cache[key][:, slot, ..., :T]``, and the PRNG one ``torch.Generator`` on
the engine's device seeded with ``seed`` (sampling is therefore not the
JAX engine's numbers). The admission prefill and the prefix registration
go through K1, where the JAX engine's ``_flash_prefill_ok`` keeps them off
flash on one chip: K1 attends the unquantized current k/v, as the static
engines do, so under ``kv_int8`` the port's admission does not equal JAX
serving's, which attends the int8 rows it just wrote. The suffix and chunk
prefills attend the (dequantized) cache in both. Prompt embeddings are cast
to the engine's ``dtype``.

``mesh`` (JAX's tp-sharded serving): the params are the rank's blocks
(``parallel/sharding.py:shard_params``) and every model call runs under
the mesh's shard context. The pool and the prefix store hold the rank's KV
heads, admission goes through K1 on them, decode blocks take K7 (K7 q8 for
the int8 pool) per rank on its KV heads (``DecodeAttention.FLASH``, as the
JAX engine sets ``(mesh, tp)``), and the beam lane runs the same sharded
decoder. Tokens come from logits gathered over tp, so every rank samples
the same ones; dp and fsdp ranks run the same schedule (JAX replicates the
pool over them), and ``pool_bytes`` are a rank's. A LoRA bank stays whole
on every rank, as JAX replicates it: each product gathers its samples'
factors and cuts them to the rank's part (``models/llama.py:_proj_tp``);
a prefix registered under one of its adapters prefills with that adapter
cut by the rule table. A tp that does not divide the KV heads raises
``ValueError`` in the constructor, as the JAX engine's placement of its
pool does.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.llama import (
    DecodeAttention,
    DecoderConfig,
    decode_step,
    decoder_forward,
    embed_tokens,
    init_kv_cache,
    lm_logits,
)
from ..parallel.sharding import context_of, is_sharded, shard_context, shard_params
from ..training.step import tree_leaves, tree_map


@dataclass(frozen=True)
class ServingConfig:
    num_slots: int = 8
    max_new_tokens: int = 10
    prompt_buckets: Tuple[int, ...] = (128, 256, 512)
    eos_token_id: int = 2
    pad_token_id: int = 0
    #: rows of every admission wave (padding rows go nowhere)
    admit_batch: int = 4
    #: decode steps a decode block runs
    sync_every: int = 4
    #: pending decode blocks and beam waves that force a flush
    max_pending_blocks: int = 16
    #: int8 KV pool with per-position f32 scales
    kv_int8: bool = False
    #: buckets of ``register_prefix``; empty: prefix caching off
    prefix_buckets: Tuple[int, ...] = ()
    #: chunked admission: chunks of this many positions (divides every
    #: prompt bucket), a decode block between chunks; 0: off
    chunk_len: int = 0

    @property
    def cache_len(self) -> int:
        pre = max(self.prefix_buckets) if self.prefix_buckets else 0
        return -(-(max(self.prompt_buckets) + pre + self.max_new_tokens) // 128) * 128


@dataclass
class _Slot:
    """Replay state of one slot's current occupant, rebuilt at flush time
    from the log (the schedule itself runs on ``_sched`` and ``_budget``)."""

    request_id: int = -1
    tokens: List[int] = field(default_factory=list)
    active: bool = False
    budget: int = 0


def _bucket_for(length: int, buckets: Tuple[int, ...]) -> int:
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket {max(buckets)}")


def _sample_next(logits, temps, generator):
    """Per row (int32): temperature 0 → argmax, else the argmax of
    logits / T plus Gumbel noise from ``generator`` (an exact softmax
    sample). Every row draws, so a greedy row's neighbours never change
    what a sampled row sees of the generator."""
    greedy = torch.argmax(logits, dim=-1)
    noise = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    gumbel = -torch.log(noise.exponential_(generator=generator))
    sampled = torch.argmax(logits.float() / temps.clamp(min=1e-6)[:, None] + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def _last_logits(llm_cfg, params, hidden, idx):
    """Logits (n, V) of hidden (n, T, D) at row positions idx (n,)."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return lm_logits(llm_cfg, params, hidden[rows, idx.long()])


def _scatter_slots_kernel(cache, local, slots):
    """Copy row j of each wave-local leaf (L, n, Hkv, T[, hd]) into pool
    slot ``slots[j]`` at positions [0, T), in place; rows past
    ``len(slots)`` (padding) are not copied."""
    for key, pool in cache.items():
        block = local[key]
        T = block.shape[3]
        for j, i in enumerate(slots):
            pool[:, i, :, :T].copy_(block[:, j])


def _prefill_kernel(llm_cfg, dtype, params, cache, seqs, lengths, slots, temps, generator,
                    lora, lora_scaling, lora_ids=None):
    """Wave prefill at bucket length L: seqs (n, L, D), lengths (n,); the
    KV blocks land in pool slots ``slots``. → first token of each row."""
    n, L, _ = seqs.shape
    local = init_kv_cache(llm_cfg, n, L, dtype=dtype, device=seqs.device, quant="k_s" in cache)
    hidden, local = decoder_forward(llm_cfg, params, seqs, lengths, cache=local, lora=lora,
                                    lora_scaling=lora_scaling, lora_ids=lora_ids)
    first = _sample_next(_last_logits(llm_cfg, params, hidden, lengths - 1), temps, generator)
    _scatter_slots_kernel(cache, local, slots)
    return first


def _prefix_register_kernel(llm_cfg, scfg, dtype, params, emb, lengths, lora, lora_scaling):
    """Prefill a shared prefix emb (1, Pb, D) once → its KV tree with the
    batch row stripped: leaves (n_layers, Hkv, Pb[, hd]). RoPE positions
    are absolute 0..Pb-1, so the block drops into the front of any slot."""
    Pb = emb.shape[1]
    local = init_kv_cache(llm_cfg, 1, Pb, dtype=dtype, device=emb.device, quant=scfg.kv_int8)
    decoder_forward(llm_cfg, params, emb, lengths, cache=local, lora=lora,
                    lora_scaling=lora_scaling)
    return {k: v[:, 0] for k, v in local.items()}


def _wave_local(prefix, n, length):
    """A wave-local cache of ``length`` positions whose front holds each
    row's prefix block: leaves (L, n or 1, Hkv, Pb[, hd]) → zeros (L, n,
    Hkv, length[, hd]) with the block copied in; a (L, 1, ...) block is
    broadcast over the rows by ``expand``, never copied n times first."""
    local = {}
    for key, block in prefix.items():
        Pb = block.shape[3]
        buf = block.new_zeros((block.shape[0], n, block.shape[2], length) + block.shape[4:])
        buf[:, :, :, :Pb].copy_(block.expand(block.shape[0], n, *block.shape[2:]))
        local[key] = buf
    return local


def _prefill_suffix_kernel(llm_cfg, params, cache, prefix, plens, seqs, lengths, slots, temps,
                           generator, lora, lora_scaling, lora_ids=None):
    """Suffix prefill over registered prefix KV: row j's suffix sits at
    absolute positions plens[j] + i, its KV lands at [plens[j], plens[j] +
    L) of a wave-local cache that starts as the prefix block, so the slot's
    cache stays contiguous; then the blocks are copied into the slots."""
    n, L, _ = seqs.shape
    local = _wave_local(prefix, n, prefix["k"].shape[3] + L)
    hidden, local = decoder_forward(llm_cfg, params, seqs, None, cache=local, lora=lora,
                                    lora_scaling=lora_scaling, lora_ids=lora_ids,
                                    cache_positions=plens)
    first = _sample_next(_last_logits(llm_cfg, params, hidden, lengths - 1), temps, generator)
    _scatter_slots_kernel(cache, local, slots)
    return first


def _chunk_step_kernel(llm_cfg, params, local, chunk, starts, abs_lengths, tok_state, temps,
                       generator, lora, lora_scaling, lora_ids=None):
    """One prefill chunk (n, C, D) into the wave-local cache at ``starts``.
    A row's last prompt position falls in exactly one chunk; every chunk
    samples a candidate there and keeps it only when that position lies in
    this chunk (``tok_state`` carries the winner). Rows past their length
    ride along, writing positions that are never attended."""
    C = chunk.shape[1]
    hidden, _ = decoder_forward(llm_cfg, params, chunk, None, cache=local, lora=lora,
                                lora_scaling=lora_scaling, lora_ids=lora_ids,
                                cache_positions=starts)
    idx = abs_lengths - 1 - starts
    in_chunk = (idx >= 0) & (idx < C)
    cand = _sample_next(_last_logits(llm_cfg, params, hidden, idx.clamp(0, C - 1)), temps,
                        generator)
    return torch.where(in_chunk, cand, tok_state)


def _decode_kernel(llm_cfg, scfg, n_inner, dtype, params, cache, tok, cur_len, done, temps,
                   generator, lora, lora_scaling, lora_ids=None,
                   attention=DecodeAttention.XLA):
    """``n_inner`` decode steps for every pool row, the cache in place.
    Done rows emit pad and keep their length. → (tok, cur_len, done, the
    emitted block (n_inner, S + 1))."""
    toks = []
    for _ in range(n_inner):
        emb = embed_tokens(params, tok[:, None], dtype=dtype)
        hidden, cache = decode_step(llm_cfg, params, emb, cache, cur_len, lora, lora_scaling,
                                    attention, lora_ids)
        nxt = _sample_next(lm_logits(llm_cfg, params, hidden)[:, 0], temps, generator)
        nxt = nxt.masked_fill(done, scfg.pad_token_id)
        done = done | (nxt == scfg.eos_token_id)
        cur_len = torch.where(done, cur_len, cur_len + 1)
        tok = nxt
        toks.append(nxt)
    return tok, cur_len, done, torch.stack(toks)


class ContinuousBatchingEngine:
    """Request scheduler over prompt embeddings: ``submit`` enqueues a
    request, ``step`` admits and decodes one block, ``run`` drains and
    returns ``{request_id: [token ids]}`` (EOS-truncated), ``completed``
    pops what has finished so far. Multimodal fronts encode the audio and
    assemble the prompt (``salmonn_prompt_embeddings``); decoding here is
    model-family agnostic."""

    def __init__(self, llm_cfg: DecoderConfig, params: Dict[str, Any],
                 cfg: ServingConfig = ServingConfig(), lora: Optional[Dict[str, Any]] = None,
                 lora_scaling: float = 1.0, dtype=torch.float32, seed: int = 0, mesh=None,
                 device="cuda"):
        if cfg.chunk_len:
            bad = [b for b in cfg.prompt_buckets if b % cfg.chunk_len]
            if bad:
                raise ValueError(f"chunk_len={cfg.chunk_len} must divide every prompt "
                                 f"bucket (offending: {bad})")
        self.llm_cfg, self.params, self.cfg = llm_cfg, params, cfg
        self.lora, self.lora_scaling = lora, lora_scaling
        self.device = torch.device(device)
        S = cfg.num_slots
        # a stack_lora_bank tree has leaves (n_layers, n_adapters, ·, ·)
        leaves = tree_leaves(lora) if lora is not None else []
        self._n_adapters = leaves[0].shape[1] if leaves and leaves[0].dim() == 4 else 0
        self._mesh = mesh
        self._shard = context_of(mesh) if is_sharded(mesh) else None
        if self._shard is not None and llm_cfg.n_kv_heads % self._shard.tp:
            raise ValueError(
                f"tp={self._shard.tp} does not divide the {llm_cfg.n_kv_heads} KV heads: the "
                "pool is cut over its KV heads, and the JAX engine's device_put of its pool "
                "refuses the same mesh (the split-head path is static generation and "
                "training only)")
        self._attention = DecodeAttention.FLASH if self._shard else DecodeAttention.XLA
        self._scratch = S
        self._dtype = dtype
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        dev = self.device
        with shard_context(self._shard):
            self._cache = init_kv_cache(llm_cfg, S + 1, cfg.cache_len, dtype=dtype, device=dev,
                                        quant=cfg.kv_int8)
        self._adapter_ids = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        self._temps = torch.zeros((S + 1,), dtype=torch.float32, device=dev)
        self._tok = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        self._cur_len = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
        self._done = torch.ones((S + 1,), dtype=torch.bool, device=dev)
        self._slots = [_Slot() for _ in range(S)]
        self._queue: deque = deque()
        self._results: Dict[int, List[int]] = {}
        self._next_id = 0
        # registered prefixes: (KV tree, true length, bucket, adapter id)
        self._prefix_store: List[Tuple[Dict[str, torch.Tensor], int, int, int]] = []
        self._beam_queue: deque = deque()
        # pending beam outputs: (device (n, Tmax) tokens, [(rid, budget)])
        self._pending_beams: List[Tuple[torch.Tensor, List[Tuple[int, int]]]] = []
        # pending token blocks (rows, S + 1) and their log entries:
        # ("admit", [(slot, rid, budget)]) or ("decode", (n_inner, riders))
        self._pending_rows: List[torch.Tensor] = []
        self._pending_meta: List[Tuple[str, Any]] = []
        # tokens scheduled for each slot's occupant (None: never occupied)
        # and its budget: the occupant is finished once sched >= budget
        self._sched: List[Optional[int]] = [None] * S
        self._budget: List[int] = [cfg.max_new_tokens] * S
        self.stats: Dict[str, Any] = {"decode_blocks": 0, "prefill_waves": {}, "flushes": 0}
        self._n_inner = max(1, cfg.sync_every)

    # -- host → device ------------------------------------------------------
    def _h2d(self, values, dtype=None) -> torch.Tensor:
        """A host array on the engine's device, by a pinned, non-blocking
        copy on the card (a pageable copy would wait for the stream)."""
        t = torch.as_tensor(np.ascontiguousarray(values), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _block(self, embs, L: int, n: int) -> torch.Tensor:
        """(n, L, D) prompts in the engine's dtype: row j is embs[j][:L]
        (a device tensor or a host array), zero-padded; rows past
        len(embs) are zeros."""
        out = torch.zeros((n, L, embs[0].shape[-1]), dtype=self._dtype, device=self.device)
        for j, e in enumerate(embs):
            e = e[:L]
            out[j, :e.shape[0]].copy_(e if isinstance(e, torch.Tensor) else self._h2d(e))
        return out

    def _adapter(self, adapter_id: int):
        """The LoRA one request decodes under: the bank sliced at
        ``adapter_id`` (cut to the rank's blocks under a sharded mesh, as a
        single adapter is), or the single adapter."""
        if not self._n_adapters:
            return self.lora
        lora = tree_map(lambda x: x[:, adapter_id], self.lora)
        return lora if self._shard is None else shard_params({"lora": lora}, self._mesh)["lora"]

    # -- public API ---------------------------------------------------------
    @torch.no_grad()
    def register_prefix(self, seq_emb, length: int, adapter_id: int = 0) -> int:
        """Prefill a shared prompt prefix once (K1); return its id for
        ``submit(prefix_id=)``, whose requests then prefill only their
        suffix. Needs ``cfg.prefix_buckets``. Under a bank the prefix is
        computed under ``adapter_id`` and serves only that adapter's
        requests."""
        if not self.cfg.prefix_buckets:
            raise ValueError("register_prefix needs ServingConfig.prefix_buckets")
        if adapter_id and not 0 <= adapter_id < self._n_adapters:
            raise ValueError(f"adapter_id {adapter_id} out of range ({self._n_adapters})")
        Pb = _bucket_for(int(length), self.cfg.prefix_buckets)
        with shard_context(self._shard):
            tree = _prefix_register_kernel(
                self.llm_cfg, self.cfg, self._dtype, self.params, self._block([seq_emb], Pb, 1),
                self._h2d([int(length)], torch.int32), self._adapter(adapter_id),
                self.lora_scaling)
        self._prefix_store.append((tree, int(length), Pb, int(adapter_id)))
        return len(self._prefix_store) - 1

    def submit(self, seq_emb, length: int, temperature: float = 0.0,
               max_new_tokens: Optional[int] = None, num_beams: int = 1,
               adapter_id: int = 0, prefix_id: Optional[int] = None) -> int:
        """Enqueue a request: (L, D) prompt embeddings (a device tensor or a
        host array) and its true length. Per request: ``temperature`` (0:
        greedy), ``max_new_tokens`` (≤ ``cfg.max_new_tokens``),
        ``num_beams`` (> 1: the beam lane), ``adapter_id`` (a bank's
        adapter) and ``prefix_id`` (``seq_emb`` is then the suffix of a
        registered prefix; slot pool only)."""
        _bucket_for(int(length), self.cfg.prompt_buckets)
        mnt = self.cfg.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= mnt <= self.cfg.max_new_tokens:
            raise ValueError(f"max_new_tokens must be in [1, {self.cfg.max_new_tokens}] "
                             f"(cache sizing), got {mnt}")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if adapter_id and not 0 <= adapter_id < self._n_adapters:
            raise ValueError(
                f"adapter_id {adapter_id} needs a stack_lora_bank engine with "
                f"> {adapter_id} adapters (have {self._n_adapters or 'a single adapter'})")
        if prefix_id is not None:
            if not 0 <= prefix_id < len(self._prefix_store):
                raise ValueError(f"unknown prefix_id {prefix_id} "
                                 f"(registered: {len(self._prefix_store)})")
            if num_beams > 1:
                raise ValueError("prefix caching is slot-pool only; the beam lane prefills "
                                 "its full prompt")
            if self._prefix_store[prefix_id][3] != adapter_id:
                raise ValueError(
                    f"prefix {prefix_id} was registered under adapter "
                    f"{self._prefix_store[prefix_id][3]}, request uses {adapter_id} "
                    f"(prefix KV depends on the adapter)")
        pid = -1 if prefix_id is None else int(prefix_id)
        rid = self._next_id
        self._next_id += 1
        if num_beams > 1:
            self._beam_queue.append((rid, seq_emb, int(length), float(temperature), mnt,
                                     int(num_beams), int(adapter_id)))
        else:
            self._queue.append((rid, seq_emb, int(length), float(temperature), mnt,
                                int(adapter_id), pid))
        return rid

    def _live(self) -> bool:
        return any(s is not None and s < self._budget[i] for i, s in enumerate(self._sched))

    @torch.no_grad()
    def run(self) -> Dict[int, List[int]]:
        """Drain the queues and every slot in flight; return the results."""
        while self._queue or self._beam_queue or self._live():
            self.step()
        return self.completed()

    @torch.no_grad()
    def completed(self) -> Dict[int, List[int]]:
        """Flush (one host transfer) and pop every finished request's
        result."""
        self._flush()
        out, self._results = self._results, {}
        return out

    @torch.no_grad()
    def step(self) -> None:
        """Admit waiting requests into free slots, dispatch waiting beam
        waves, and run one decode block; nothing here waits for the card.
        Flushes once ``max_pending_blocks`` blocks and waves are pending."""
        with shard_context(self._shard):
            self._admit()
            self._dispatch_beams()
            self._decode_once()
        if len(self._pending_meta) + len(self._pending_beams) >= self.cfg.max_pending_blocks:
            self._flush()

    def _decode_once(self) -> None:
        """One decode block for every occupied slot (none when no occupant
        is live); also run between the chunks of a chunked admission."""
        riders = [i for i in range(len(self._slots)) if self._sched[i] is not None]
        if not riders or not self._live():
            return
        # occupants whose budget is spent are done as far as the schedule
        # knows: they stop sampling and advancing while they ride
        spent = [s is not None and s >= self._budget[i] for i, s in enumerate(self._sched)]
        if any(spent):
            self._done = self._done | self._h2d(spent + [True])
        self._tok, self._cur_len, self._done, toks = _decode_kernel(
            self.llm_cfg, self.cfg, self._n_inner, self._dtype, self.params, self._cache,
            self._tok, self._cur_len, self._done, self._temps, self._gen, self.lora,
            self.lora_scaling, self._adapter_ids if self._n_adapters else None,
            self._attention)
        self._pending_rows.append(toks)
        self.stats["decode_blocks"] += 1
        self._pending_meta.append(("decode", (self._n_inner, riders)))
        for i in riders:
            self._sched[i] += self._n_inner

    def _flush(self) -> None:
        """Move every pending token block and beam output to the host in one
        transfer and replay the log: admissions create occupants, decode
        rows append to whichever occupant was live, with EOS and budget
        truncation; lanes whose occupant the replay finds finished early
        are marked free."""
        if not self._pending_meta and not self._pending_beams:
            return
        self.stats["flushes"] += 1
        beams, self._pending_beams = self._pending_beams, []
        blocks = self._pending_rows + [t for t, _ in beams]
        flat = torch.cat([b.reshape(-1) for b in blocks]).cpu().numpy()
        n_rows = sum(b.numel() for b in self._pending_rows)
        rows = flat[:n_rows].reshape(-1, len(self._slots) + 1)
        at = n_rows
        for toks_dev, entries in beams:
            toks = flat[at:at + toks_dev.numel()].reshape(toks_dev.shape)
            at += toks_dev.numel()
            for j, (rid, budget) in enumerate(entries):
                out: List[int] = []
                for t in toks[j]:
                    if int(t) == self.cfg.eos_token_id or len(out) >= budget:
                        break
                    out.append(int(t))
                self._results[rid] = out
        meta, self._pending_meta, self._pending_rows = self._pending_meta, [], []
        r = 0
        for kind, info in meta:
            if kind == "admit":
                for i, rid, budget in info:
                    self._slots[i] = _Slot(rid, [], True, budget)
                    self._record(i, int(rows[r, i]))
                r += 1
            else:
                n_inner, riders = info
                for row in rows[r:r + n_inner]:
                    for i in riders:
                        if self._slots[i].active:
                            self._record(i, int(row[i]))
                r += n_inner
        for i, slot in enumerate(self._slots):
            if not slot.active and self._sched[i] is not None:
                self._sched[i] = max(self._sched[i], self._budget[i])

    def _dispatch_beams(self) -> None:
        """Drain the beam queue as waves of FIFO-following requests sharing
        (prompt bucket, num_beams, temperature, adapter id), padded to
        ``admit_batch`` rows (padding rows: length 1, discarded); each wave
        is one ``beam_decode_from_sequence`` call under its adapter (the
        bank sliced), its tokens left on the device until the flush."""
        from .beam import beam_decode_from_sequence
        from .engine import GenerationConfig

        while self._beam_queue:
            head = self._beam_queue[0]
            L = _bucket_for(head[2], self.cfg.prompt_buckets)
            key = (L, head[5], head[3], head[6])
            wave, keep = [], deque()
            while self._beam_queue and len(wave) < self.cfg.admit_batch:
                req = self._beam_queue.popleft()
                if (_bucket_for(req[2], self.cfg.prompt_buckets), req[5], req[3], req[6]) == key:
                    wave.append(req)
                else:
                    keep.append(req)
            while keep:
                self._beam_queue.appendleft(keep.pop())
            nb = self.cfg.admit_batch
            seqs = self._block([r[1] for r in wave], L, nb)
            lengths = self._h2d([r[2] for r in wave] + [1] * (nb - len(wave)), torch.int32)
            temp = key[2]
            gen = GenerationConfig(
                max_new_tokens=self.cfg.max_new_tokens, num_beams=key[1], do_sample=temp > 0,
                temperature=temp if temp > 0 else 1.0, eos_token_id=self.cfg.eos_token_id,
                pad_token_id=self.cfg.pad_token_id, kv_int8=self.cfg.kv_int8,
                use_flash_decode="xla")
            toks = beam_decode_from_sequence(
                self.llm_cfg, self.params, seqs, lengths, gen, lora=self._adapter(key[3]),
                lora_scaling=self.lora_scaling, dt=self._dtype, generator=self._gen)
            self._pending_beams.append((toks, [(r[0], r[4]) for r in wave]))
            self.stats["beam_waves"] = self.stats.get("beam_waves", 0) + 1

    # -- scheduler internals ------------------------------------------------
    def _admit(self) -> None:
        while self._queue:
            free = [i for i, s in enumerate(self._sched) if s is None or s >= self._budget[i]]
            if not free:
                return

            # a wave: the queue head plus FIFO-following requests of the same
            # (prompt bucket, prefix bucket)
            def _key(req):
                pb = self._prefix_store[req[6]][2] if req[6] >= 0 else 0
                return (_bucket_for(req[2], self.cfg.prompt_buckets), pb)

            head_key = _key(self._queue[0])
            limit = min(len(free), self.cfg.admit_batch)
            wave, keep = [], deque()
            while self._queue and len(wave) < limit:
                req = self._queue.popleft()
                if _key(req) == head_key:
                    wave.append(req)
                else:
                    keep.append(req)
            while keep:
                self._queue.appendleft(keep.pop())
            self._admit_wave(wave, head_key[0], free, prefix_bucket=head_key[1])

    def _admit_wave(self, wave, L: int, free: List[int], prefix_bucket: int = 0) -> None:
        n, nb = len(wave), self.cfg.admit_batch
        pad = nb - n
        seqs = self._block([r[1] for r in wave], L, nb)
        lengths = np.array([r[2] for r in wave] + [1] * pad, np.int32)
        slot_ids = free[:n]
        temps = self._h2d([r[3] for r in wave] + [0.0] * pad, torch.float32)
        aids = self._h2d([r[5] for r in wave] + [0] * pad, torch.int32)
        key = (L, nb, prefix_bucket)
        self.stats["prefill_waves"][key] = self.stats["prefill_waves"].get(key, 0) + 1
        prefix, plens = None, np.zeros((nb,), np.int32)
        if prefix_bucket:
            plens = np.array([self._prefix_store[r[6]][1] for r in wave] + [0] * pad, np.int32)
            pids = {r[6] for r in wave}
            if len(pids) == 1:
                # one registered block for every row: passed as (L, 1, Hkv,
                # Pb, hd) and broadcast, never stacked n times
                prefix = {k: v[:, None] for k, v in self._prefix_store[pids.pop()][0].items()}
            else:
                # padding rows reuse row 0's block with prefix length 0
                trees = [self._prefix_store[r[6]][0] for r in wave]
                trees += [trees[0]] * pad
                prefix = {k: torch.stack([t[k] for t in trees], dim=1) for k in trees[0]}
        lora_ids = aids if self._n_adapters else None
        common = (self.lora, self.lora_scaling, lora_ids)
        if self.cfg.chunk_len:
            first = self._admit_chunked(seqs, lengths, slot_ids, temps, prefix, plens, L, nb,
                                        lora_ids)
        elif prefix_bucket:
            first = _prefill_suffix_kernel(
                self.llm_cfg, self.params, self._cache, prefix, self._h2d(plens), seqs,
                self._h2d(lengths), slot_ids, temps, self._gen, *common)
        else:
            first = _prefill_kernel(self.llm_cfg, self._dtype, self.params, self._cache, seqs,
                                    self._h2d(lengths), slot_ids, temps, self._gen, *common)
        cur_lens = lengths + plens
        idx = self._h2d(slot_ids, torch.int64)
        real = first[:n]
        if self._n_adapters:
            self._adapter_ids.index_copy_(0, idx, aids[:n])
        self._temps.index_copy_(0, idx, temps[:n])
        self._tok.index_copy_(0, idx, real)
        self._cur_len.index_copy_(0, idx, self._h2d(cur_lens[:n]))
        self._done.index_copy_(0, idx, real == self.cfg.eos_token_id)
        # the wave's first tokens in an (S + 1)-wide row, moved at the flush
        row = torch.zeros((len(self._slots) + 1,), dtype=torch.int32, device=self.device)
        self._pending_rows.append(row.index_copy_(0, idx, real)[None])
        entries = []
        for (rid, _e, _l, _t, mnt, _a, _p), i in zip(wave, slot_ids):
            entries.append((i, rid, mnt))
            self._sched[i] = 1  # the prefill's first token
            self._budget[i] = mnt
        self._pending_meta.append(("admit", entries))

    def _admit_chunked(self, seqs, lengths, slot_ids, temps, prefix, plens, L: int, nb: int,
                       lora_ids) -> torch.Tensor:
        """Chunked admission: L / chunk_len chunk prefills into a wave-local
        cache, a decode block for the slots in flight between chunks, then
        one copy into the slots. → the wave's first tokens."""
        C = self.cfg.chunk_len
        if prefix is not None:
            local = _wave_local(prefix, nb, prefix["k"].shape[3] + L)
        else:
            local = init_kv_cache(self.llm_cfg, nb, L, dtype=self._dtype, device=self.device,
                                  quant=self.cfg.kv_int8)
        tok_state = torch.zeros((nb,), dtype=torch.int32, device=self.device)
        abs_lengths = self._h2d(plens + lengths)
        starts = self._h2d(plens)
        n_chunks = L // C
        for i in range(n_chunks):
            tok_state = _chunk_step_kernel(
                self.llm_cfg, self.params, local, seqs[:, i * C:(i + 1) * C], starts + i * C,
                abs_lengths, tok_state, temps, self._gen, self.lora, self.lora_scaling, lora_ids)
            if i < n_chunks - 1:
                self._decode_once()
        self.stats["chunk_dispatches"] = self.stats.get("chunk_dispatches", 0) + n_chunks
        _scatter_slots_kernel(self._cache, local, slot_ids)
        return tok_state

    def _record(self, i: int, tok: int) -> None:
        """Append one emitted token to slot i's occupant; EOS (not kept) or
        the budget ends the request and frees the slot."""
        slot = self._slots[i]
        if tok != self.cfg.eos_token_id:
            slot.tokens.append(tok)
        if tok == self.cfg.eos_token_id or len(slot.tokens) >= slot.budget:
            self._results[slot.request_id] = slot.tokens
            self._slots[i] = _Slot()


def salmonn_prompt_embeddings(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """Packed SALMONN batch (tensors on the model's device) → (prompt
    embeddings (B, L, D), lengths (B,)): the encoder and assembly half of
    ``engine.salmonn_generate`` (K2 in Whisper, K3 in BEATs), so requests
    enter the slot pool as plain embeddings."""
    from .engine import speech_sequence

    return speech_sequence(cfg, params, batch), batch["seq_lengths"]


def qwen_prompt_embeddings(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """The Qwen2-Audio counterpart of ``salmonn_prompt_embeddings``: the
    audio tower (K2 with each clip's frame count as its key length), the
    pool, the final LN, the projector and the one-gather assembly
    (``models/qwen_audio.py:qwen_sequence``) → (prompt embeddings, lengths)."""
    from ..models.qwen_audio import qwen_sequence

    return qwen_sequence(cfg, params, batch), batch["seq_lengths"]
