"""Sharding rules for the model zoo, and the shard context the layers read.

Counterpart of ``icl_speech_text_llm_tpu/parallel/sharding.py``: the same
rule table over parameter-tree paths (column-parallel qkv/up projections,
row-parallel output/down projections, FSDP over the other matrix dim, a
vocab-sharded embedding and lm_head, LoRA factors cut to match their
targets), first match wins, no match replicates. A spec is a tuple of axis
names or None per dim (JAX's ``PartitionSpec``). The rules anchor at ``$``,
so a quantized leaf (``…/wq/q``, ``…/wq/q4``, ``…/wq/s``), the Q-Former,
Qwen2-Audio's tower (``encoder/…``), BEATs' ``rel_bias`` and ``grep_a``
match none and stay replicated, as under JAX.

GSPMD places the shards and inserts the collectives; here each rank holds
its local blocks (``shard_params``) and the layer code calls explicit
collectives (``parallel/collectives.py``) through the ``ShardContext`` of
the mesh, which the mesh-aware entry points install with
``shard_context(ctx)`` (``current_shard()`` is None on one process, and
every layer then takes its one-process path). A sharded dim that its axis
size does not divide raises ``ValueError``, as the JAX package's
``shard_params`` does (its ``jax.device_put`` refuses such a sharding).

A head count that tp does not divide, where the column widths it cuts do
divide (Whisper's 20 heads, BEATs' 12, Qwen2-7B's 28 and 4 KV heads at
tp = 8), is not such a dim: GSPMD computes on the logical arrays, so the
JAX package runs it. Each model (decoder, Whisper, BEATs) takes one of two
layouts, fixed by its config and the mesh before any call
(``ShardContext.split_heads``): head-sharded, each rank attending its own
heads, where tp divides every head count; else split-head, each rank
gathering its column blocks of q, k and v over tp into whole heads,
attending all of them (attention is then computed tp times over), and
cutting the output back to its column block for its wo row shard.

Pipeline stages (a mesh with pp > 1) are a separate cut after the rule
table (``stage_params``): a stage holds only its contiguous slice of the
decoder's stacked layers and of the LoRA along the layer dim, and
``gather_params`` gathers the slices back over pp. JAX keeps them
replicated over pp and slices them inside its ``shard_map``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import collectives as C
from .mesh import DP_AXIS, FSDP_AXIS, PP_AXIS, TP_AXIS, axis_group, axis_rank, axis_size

Spec = Tuple[Optional[str], ...]

# (regex over 'a/b/c' path, spec). First match wins. Layer-stacked params
# have a leading n_layers axis → specs lead with None.
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # --- LLM (stacked layers) ---
    (r"llm/layers/attn/wq$", (None, FSDP_AXIS, TP_AXIS)),
    (r"llm/layers/attn/wk$", (None, FSDP_AXIS, TP_AXIS)),
    (r"llm/layers/attn/wv$", (None, FSDP_AXIS, TP_AXIS)),
    (r"llm/layers/attn/wo$", (None, TP_AXIS, FSDP_AXIS)),
    (r"llm/layers/attn/b[qkv]$", (None, TP_AXIS)),
    (r"llm/layers/mlp/w_gate$", (None, FSDP_AXIS, TP_AXIS)),
    (r"llm/layers/mlp/w_up$", (None, FSDP_AXIS, TP_AXIS)),
    (r"llm/layers/mlp/w_down$", (None, TP_AXIS, FSDP_AXIS)),
    (r"llm/tok_embed$", (TP_AXIS, None)),  # vocab-sharded embedding
    (r"llm/lm_head$", (None, TP_AXIS)),
    # --- LoRA adapters: A column-parallel-in, B matches target's out sharding
    (r"lora/w[qkv]/a$", (None, FSDP_AXIS, None)),
    (r"lora/w[qkv]/b$", (None, None, TP_AXIS)),
    (r"lora/wo/a$", (None, TP_AXIS, None)),
    (r"lora/wo/b$", (None, None, FSDP_AXIS)),
    (r"lora/w_(gate|up)/a$", (None, FSDP_AXIS, None)),
    (r"lora/w_(gate|up)/b$", (None, None, TP_AXIS)),
    (r"lora/w_down/a$", (None, TP_AXIS, None)),
    (r"lora/w_down/b$", (None, None, FSDP_AXIS)),
    # --- Whisper encoder blocks (stacked) ---
    (r"whisper/blocks/attn/w[qkv]$", (None, FSDP_AXIS, TP_AXIS)),
    (r"whisper/blocks/attn/wo$", (None, TP_AXIS, FSDP_AXIS)),
    (r"whisper/blocks/mlp/w1$", (None, FSDP_AXIS, TP_AXIS)),
    (r"whisper/blocks/mlp/w2$", (None, TP_AXIS, FSDP_AXIS)),
    # --- BEATs layers (stacked) ---
    (r"beats/layers/attn/w[qkv]$", (None, FSDP_AXIS, TP_AXIS)),
    (r"beats/layers/attn/wo$", (None, TP_AXIS, FSDP_AXIS)),
    (r"beats/layers/mlp/w1$", (None, FSDP_AXIS, TP_AXIS)),
    (r"beats/layers/mlp/w2$", (None, TP_AXIS, FSDP_AXIS)),
    # --- Q-Former: small; replicate ---
)


def spec_for_path(path: str, ndim: int) -> Spec:
    """The first matching rule's spec, cut to ``ndim`` dims; () replicates."""
    for pattern, spec in _RULES:
        if re.search(pattern, path):
            return spec if len(spec) <= ndim else spec[:ndim]
    return ()


#: the layer-stacked subtrees whose dim 0 a pipeline stage holds its slice of
_STAGED = re.compile(r"^(llm/layers|lora)/")


def is_staged(path: str) -> bool:
    """True for a leaf whose layers are cut over the pipeline's stages."""
    return bool(_STAGED.match(path))


def tree_paths(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, 'a/b/c' paths, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    return fn(prefix, tree)


def _sharded_dims(path: str, leaf, sizes: Dict[str, int]):
    """[(dim, axis)] of ``leaf``'s dims cut over an axis of size > 1;
    ValueError where the axis size does not divide the dim."""
    if not isinstance(leaf, torch.Tensor):
        return []
    out = []
    for dim, axis in enumerate(spec_for_path(path, leaf.dim())):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n > 1:
            if leaf.shape[dim] % n:
                raise ValueError(f"{path}: dim {dim} of size {leaf.shape[dim]} does not split "
                                 f"over the {axis} axis of size {n} (the JAX package's "
                                 "device_put refuses it too)")
            out.append((dim, axis))
    return out


@dataclasses.dataclass
class ShardContext:
    """This rank's place in a (dp, pp, fsdp, tp) mesh: each axis's size,
    coordinate and process group, and the collectives the sharded layers
    call (no-ops over an axis of size 1). The layers never read pp: a
    stage runs its layers as a whole model would (``parallel/pipeline.py``)."""

    sizes: Dict[str, int]
    ranks: Dict[str, int]
    groups: Dict[str, Any]
    #: storage → (shard, dim, gathered) of the frozen leaves ``gather_fsdp``
    #: gathered inside ``keep_shards``; None outside it
    _kept: Optional[Dict[int, tuple]] = dataclasses.field(default=None, repr=False)

    @classmethod
    def of(cls, mesh) -> "ShardContext":
        axes = (DP_AXIS, PP_AXIS, FSDP_AXIS, TP_AXIS)
        return cls({a: axis_size(mesh, a) for a in axes},
                   {a: axis_rank(mesh, a) for a in axes},
                   {a: axis_group(mesh, a) for a in axes})

    @property
    def tp(self) -> int:
        return self.sizes[TP_AXIS]

    @property
    def fsdp(self) -> int:
        return self.sizes[FSDP_AXIS]

    @property
    def tp_rank(self) -> int:
        return self.ranks[TP_AXIS]

    @property
    def pp(self) -> int:
        return self.sizes[PP_AXIS]

    @property
    def pp_rank(self) -> int:
        return self.ranks[PP_AXIS]

    def split_heads(self, *counts: int) -> bool:
        """The layout rule for one model, from its head counts (the
        decoder's heads and KV heads; Whisper's or BEATs' heads): False
        (head-sharded) where tp divides every one of them, True
        (split-head) where it does not."""
        return any(n % self.tp for n in counts)

    def local_heads(self, n_heads: int, split: bool = False) -> int:
        """The heads this rank attends: all of them on the split-head path,
        else its block."""
        return n_heads if split else n_heads // self.tp

    def head_block(self, n_heads: int, split: bool = False) -> slice:
        """The heads of ``local_heads`` as a slice of all ``n_heads``."""
        return slice(0, n_heads) if split else self.cols(n_heads)

    def cols(self, n: int) -> slice:
        """This rank's block of ``n`` tp-sharded columns (or heads)."""
        k = n // self.tp
        return slice(self.tp_rank * k, (self.tp_rank + 1) * k)

    def row_bias(self, b: torch.Tensor) -> Optional[torch.Tensor]:
        """A row-parallel product's bias: whole on tp rank 0, None on the
        others, so that the sum over tp adds it once."""
        return b if self.tp_rank == 0 else None

    # -- tensor parallelism -------------------------------------------------
    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient summed over tp (only where one flows)."""
        if self.tp == 1 or not x.requires_grad:
            return x
        return C.CopyToGroup.apply(x, self.groups[TP_AXIS])

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The partial sums of a row-parallel product summed over tp (f32)."""
        if self.tp == 1:
            return x
        return C.ReduceFromGroup.apply(x, self.groups[TP_AXIS])

    def gather_tp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' blocks of ``x`` concatenated along ``dim``."""
        if self.tp == 1:
            return x
        return C.GatherDim.apply(x, dim, self.groups[TP_AXIS])

    def gather_cols(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each x (…, n/tp), this rank's column block of an (…, n) product,
        gathered whole over tp, all of them in one all-gather. Backward,
        each block's gradient is the whole gradient summed over tp (one
        reduce-scatter, ``GatherShards``): on the split-head path each rank
        uses only its own columns of the attention output, so a head that
        straddles two ranks' blocks takes gradient from both."""
        if self.tp == 1:
            return xs
        widths = [x.shape[-1] for x in xs]
        blocks = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
        whole = C.GatherShards.apply(blocks.unsqueeze(0), 0, self.groups[TP_AXIS])
        return tuple(p.movedim(0, -2).flatten(-2) for p in whole.split(widths, -1))

    def max_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        return C.all_reduce(x, self.groups[TP_AXIS], op=dist.ReduceOp.MAX)

    # -- FSDP ----------------------------------------------------------------
    def gather_fsdp(self, tree, prefix: str):
        """One layer's view (``layer_at``) of the stacked subtree at
        ``prefix`` with every FSDP-sharded leaf gathered over fsdp: frozen
        leaves without autograd, trainable leaves through ``GatherShards``
        (their gradient reduce-scattered back)."""
        if tree is None or self.fsdp == 1:
            return tree
        group = self.groups[FSDP_AXIS]

        def gather(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            spec = spec_for_path(path, leaf.dim() + 1)[1:]  # the layer dim is gone
            for dim, axis in enumerate(spec):
                if axis == FSDP_AXIS:
                    if leaf.requires_grad:
                        return C.GatherShards.apply(leaf, dim, group)
                    with torch.no_grad():
                        whole = C.all_gather(leaf, dim, group)
                    if self._kept is not None:
                        self._kept[whole.untyped_storage().data_ptr()] = (leaf, dim, whole)
                    return whole
            return leaf

        return _map_paths(gather, tree, prefix)

    @contextlib.contextmanager
    def keep_shards(self):
        """Inside the block, autograd saves each frozen leaf that
        ``gather_fsdp`` gathered as its shard, and gathers it again when the
        backward unpacks it: a rank then holds its shards and the layer in
        hand whole, not every gathered layer until the backward (a product
        with a frozen weight saves the weight for its input's gradient).
        Not for a checkpointed region, whose recompute gathers anew."""
        if self.fsdp == 1:
            yield
            return
        group = self.groups[FSDP_AXIS]

        def pack(t):
            hit = self._kept.get(t.untyped_storage().data_ptr()) if self._kept else None
            if hit is None:
                return t
            return hit[0], hit[1], t.size(), t.stride(), t.storage_offset()

        def unpack(saved):
            if isinstance(saved, torch.Tensor):
                return saved
            shard, dim, size, stride, offset = saved
            return C.all_gather(shard, dim, group).as_strided(size, stride, offset)

        self._kept = {}
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            self._kept = None


#: one process's context: every axis of size 1, so every slice is whole
#: and every collective the identity (the layers' ``current_shard() or ONE``)
ONE = ShardContext({DP_AXIS: 1, PP_AXIS: 1, FSDP_AXIS: 1, TP_AXIS: 1},
                   {DP_AXIS: 0, PP_AXIS: 0, FSDP_AXIS: 0, TP_AXIS: 0}, {})

_SHARD: contextvars.ContextVar = contextvars.ContextVar("shard", default=None)


def current_shard() -> Optional[ShardContext]:
    """The shard context the layers run under, or None (one process)."""
    return _SHARD.get()


@contextlib.contextmanager
def shard_context(ctx: Optional[ShardContext]):
    """Run the block under ``ctx`` (None: unsharded, e.g. a replicated
    tower inside a sharded model)."""
    token = _SHARD.set(ctx)
    try:
        yield ctx
    finally:
        _SHARD.reset(token)


def context_of(mesh) -> Optional[ShardContext]:
    """The mesh's shard context (cached on it), or None without a mesh."""
    if mesh is None:
        return None
    ctx = getattr(mesh, "_icl_shard_context", None)
    if ctx is None:
        ctx = ShardContext.of(mesh)
        mesh._icl_shard_context = ctx
    return ctx


def is_sharded(mesh) -> bool:
    """True where fsdp, tp or pp > 1 (a dp-only mesh keeps every leaf whole)."""
    ctx = context_of(mesh)
    return ctx is not None and (ctx.fsdp > 1 or ctx.tp > 1 or ctx.pp > 1)


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's block of every leaf by the rule table (copies, so the
    whole tree can be freed); replicated leaves are returned as they are."""
    ctx = context_of(mesh)

    def cut(path, leaf):
        out = leaf
        for dim, axis in _sharded_dims(path, leaf, ctx.sizes):
            n = leaf.shape[dim] // ctx.sizes[axis]
            out = out.narrow(dim, ctx.ranks[axis] * n, n)
        return out.clone() if out is not leaf else leaf

    return _map_paths(cut, params)


def stage_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This pipeline stage's contiguous slice of the layers (dim 0) of every
    ``llm/layers`` and ``lora`` leaf (copies); the rest as it is. Applied
    after ``shard_params``; the identity where pp is 1."""
    ctx = context_of(mesh)
    if ctx is None or ctx.pp == 1:
        return params

    def cut(path, leaf):
        if not (is_staged(path) and isinstance(leaf, torch.Tensor)):
            return leaf
        if leaf.shape[0] % ctx.pp:
            raise ValueError(f"{leaf.shape[0]} layers not divisible by pp={ctx.pp}")
        n = leaf.shape[0] // ctx.pp
        return leaf.narrow(0, ctx.pp_rank * n, n).clone()

    return _map_paths(cut, params)


def gather_stages(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``stage_params``' inverse: the stages' layer slices gathered over pp
    (a collective over the pipeline); the rest as it is."""
    ctx = context_of(mesh)
    if ctx is None or ctx.pp == 1:
        return params

    def gather(path, leaf):
        if not (is_staged(path) and isinstance(leaf, torch.Tensor)):
            return leaf
        return C.all_gather(leaf.detach(), 0, ctx.groups[PP_AXIS])

    return _map_paths(gather, params)


def gather_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``stage_params(shard_params(·))``' inverse: every sharded leaf
    gathered whole (a collective: every rank calls it); shapes give the
    rule's dims back."""
    ctx = context_of(mesh)

    def gather(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf.detach()
        for dim, axis in enumerate(spec_for_path(path, leaf.dim())):
            if axis is not None and ctx.sizes[axis] > 1:
                out = C.all_gather(out, dim, ctx.groups[axis])
        return out

    return gather_stages(_map_paths(gather, params), mesh)


def leaf_axes(path: str, leaf) -> Tuple[str, ...]:
    """The axes (fsdp, tp) a leaf at ``path`` is cut over by the rules."""
    return tuple(a for a in spec_for_path(path, leaf.dim()) if a is not None)


def cut_axes(path: str, leaf, ctx: ShardContext) -> Tuple[str, ...]:
    """``leaf_axes``, and pp for a staged leaf where pp > 1."""
    return leaf_axes(path, leaf) + ((PP_AXIS,) if ctx.pp > 1 and is_staged(path) else ())


def batch_shard(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's share of a global batch over (dp,
    fsdp), row-major as JAX's ``P((dp, fsdp))``; tp ranks share it."""
    ctx = context_of(mesh)
    if ctx is None:
        return 0, 1
    return (ctx.ranks[DP_AXIS] * ctx.sizes[FSDP_AXIS] + ctx.ranks[FSDP_AXIS],
            ctx.sizes[DP_AXIS] * ctx.sizes[FSDP_AXIS])


def batch_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of every array of a global batch over
    (dp, fsdp) (``batch_shardings`` of the JAX package)."""
    index, count = batch_shard(mesh)

    def rows(v):
        if len(v) % count:
            raise ValueError(f"a global batch of {len(v)} does not split over {count} "
                             "(dp × fsdp) ranks")
        n = len(v) // count
        return v[index * n:(index + 1) * n]

    return {k: rows(v) for k, v in batch.items()}
