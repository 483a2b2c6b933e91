"""Tensor parallelism over the mesh's ``tp`` axis (Megatron-style), for
the trainers' forward and backward.

Counterpart of the JAX package's ``tp`` specs (``polyrl_tpu/models/
decoder.py``'s ``param_specs``), which let GSPMD derive the collectives;
here the trainer issues them itself over ``mesh.group(TP)``:

- ``tp_dim(name, shape)``: the dimension of a whole leaf that ``tp``
  splits, after the reference's specs: ``wq``, ``wk``, ``wv``, ``w_gate``,
  ``w_up`` column-split (their output dim), ``wo``, ``w_down`` row-split
  (their input dim), ``bq``, ``bk``, ``bv`` split, ``embed`` split on the
  vocabulary (``P(TP, FSDP)``) and ``lm_head`` too (``P(FSDP, TP)``); a MoE
  layer's stacked experts split on each expert's width
  (``moe_intermediate_size``: ``we_gate``/``we_up`` on their columns,
  ``we_down`` on its rows); norms, ``q_norm``/``k_norm``, the MoE
  ``router`` and the critic's ``value_head`` replicated. A LoRA
  adapter follows its base (``a`` of a row-split weight and ``b`` of a
  column-split one are split, the other replicated), an int8 ``scale``
  follows its output dim.
- ``tp_slice`` / ``tp_unslice``: a whole leaf's tp block, and the whole
  leaf back from every rank's block.
- ``copy_to_tp`` (identity forward, all-reduce backward) before each
  column-parallel product, ``reduce_from_tp`` (all-reduce forward,
  identity backward) after each row-parallel one: the pair of autograd
  Functions of Megatron-LM.
- ``copy_shared``: a layer's replicated weights that meet this rank's
  split activations, passed through ``copy_to_tp`` (see below).
- ``local_config``: a shard's config: heads, dense MLP width, expert
  width and vocabulary divided by ``tp`` (a MoE config keeps all its
  experts and routes over all of them on every rank).
- ``TensorParallel``: the decoder's seam (``decoder.forward_hidden``'s
  ``tp``): the local config (``Hq/tp``, ``Hkv/tp`` heads, ``F/tp`` MLP
  width, ``V/tp`` vocabulary), the vocab-parallel embedding (a masked
  lookup of this rank's rows, summed over tp), and the vocab-parallel
  logprobs and entropy: a max and a log-sum-exp over the shards, the
  target logit picked on its owner. No ``[B, T, V]`` tensor is gathered.

Every rank of a tp group holds the same activations outside the split
products, so a replicated leaf that reads only those (the layer norms,
``final_norm``, the value head) has the same, whole gradient on every
rank. A replicated leaf that reads this rank's split activations has only
this rank's share: ``q_norm``/``k_norm`` (one ``[D]`` weight for every
head, the rank holding ``Hq/tp`` and ``Hkv/tp`` of them), the MoE
``router`` (its probabilities weight this rank's partial expert
outputs), a LoRA ``a`` of a
column-split weight (its cotangent comes through this rank's columns of
``b``) and a LoRA ``b`` of a row-split one (its input ``x @ a`` is a
partial sum). ``copy_shared`` passes these through ``copy_to_tp``, so
their backward sums the shares over tp and every rank holds the same
whole gradient. The split leaves' gradients are this rank's block.
"""

from __future__ import annotations

import dataclasses

import torch

from polyrl_tpu_torch.models.quant import LoraWeight
from polyrl_tpu_torch.parallel.mesh import TP, Mesh, all_reduce, block, unblock

# whole-leaf dimension split over tp, by the leaf's last path component
_COL = ("wq", "wk", "wv", "w_gate", "w_up")   # [L, in, out]: out split
_ROW = ("wo", "w_down")                       # [L, in, out]: in split
_BIAS = ("bq", "bk", "bv")                    # [L, out]: out split
_EXPERT_COL = ("we_gate", "we_up")            # [L, E, d, fe]: fe split
_EXPERT_ROW = ("we_down",)                    # [L, E, fe, d]: fe split


def tp_dim(name: str, shape) -> int | None:
    """The dimension of the whole leaf ``name`` (a dotted path of
    ``quant.named_leaves``) that tp splits, None when it is replicated."""
    parts = name.split(".")
    if parts[0] == "embed":
        return 0
    if parts[0] == "lm_head":
        return len(shape) - 1
    if parts[0] != "layers" or len(parts) < 2:
        return None
    key, field = parts[1], parts[2:]
    if key in _BIAS:
        return 1
    if key in _EXPERT_COL or key in _EXPERT_ROW:
        col = key in _EXPERT_COL
        if field and field[-1] == "scale":   # int8 scale [L, E, out]
            return 2 if col else None
        return 3 if col else 2
    if key not in _COL and key not in _ROW:
        return None
    col = key in _COL
    leaf = field[-1] if field else ""
    if leaf == "a":       # LoRA a [L, in, r]: the input dim
        return None if col else 1
    if leaf == "b":       # LoRA b [L, r, out]: the output dim
        return 2 if col else None
    if leaf == "scale":   # int8 scale [L, out]
        return 1 if col else None
    return 2 if col else 1


def tp_slice(mesh: Mesh, t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's tp block of a whole leaf (contiguous; ``t`` itself when
    replicated or tp is 1)."""
    return block(mesh, t, TP, dim)


def tp_unslice(mesh: Mesh, t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The whole leaf from every tp rank's block ``t`` (a collective over
    tp; ``t`` itself when replicated or tp is 1)."""
    return unblock(mesh, t, TP, dim)


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``axis``
    (each rank's block contributes to the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, (ctx.axis,), g.clone()), None, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over ``axis`` forward (each rank's block holds a partial sum);
    identity backward (every rank sees the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(mesh, (axis,), x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Megatron's pair over ``axis`` (tp here, ep in ``parallel/expert.py``):
    ``copy_to`` before a block's split products, ``reduce_from`` after
    them. Either is ``x`` itself on an axis of 1."""
    return _CopyTo.apply(x, mesh, axis) if mesh.shape[axis] > 1 else x


def reduce_from(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axis) if mesh.shape[axis] > 1 else x


def copy_to_tp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return copy_to(mesh, TP, x)


def reduce_from_tp(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return reduce_from(mesh, TP, x)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor,
                 first: int) -> torch.Tensor:
    """The rows of a vocabulary block ``table`` ``[V/tp, d]`` whose ids
    start at ``first``; an id the block does not own gives 0, so the sum
    over the blocks is the whole lookup (exact: each id has one owner)."""
    v = table.shape[0]
    local = ids.long() - first
    own = (local >= 0) & (local < v)
    return torch.where(own[..., None], table[local.clamp(0, v - 1)],
                       torch.zeros((), dtype=table.dtype, device=table.device))


def copy_shared(mesh: Mesh, lp: dict) -> dict:
    """One layer's weights ``lp`` on a tp shard with each replicated weight
    that meets this rank's split activations through ``copy_to_tp``:
    ``q_norm``, ``k_norm``, the MoE ``router``, a LoRA ``a`` of a
    column-split weight and ``b`` of a row-split one (the module's
    docstring)."""
    out = dict(lp)
    for key, w in lp.items():
        if key in ("q_norm", "k_norm", "router"):
            out[key] = copy_to_tp(mesh, w)
        elif isinstance(w, LoraWeight) and key in _COL:
            out[key] = LoraWeight(w.base, copy_to_tp(mesh, w.a), w.b, w.alpha)
        elif isinstance(w, LoraWeight) and key in _ROW:
            out[key] = LoraWeight(w.base, w.a, copy_to_tp(mesh, w.b), w.alpha)
    return out


class TensorParallel:
    """The tp seam of ``decoder.forward_hidden`` and of the trainers'
    logprob head on ``mesh``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.shape[TP]
        self.rank = mesh.coords[TP]

    def local_config(self, cfg):
        """``cfg`` with this rank's head counts, MLP widths and vocabulary
        (``num_heads``, ``num_kv_heads`` and ``intermediate_size`` are
        what ``_qkv_proj`` and ``_mlp_block`` reshape by)."""
        return local_config(cfg, self.size)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to_tp(self.mesh, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from_tp(self.mesh, x)

    def shared(self, lp: dict) -> dict:
        return copy_shared(self.mesh, lp)

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel lookup: ``table`` is this rank's ``[V/tp, d]``
        rows; ids it does not own give 0, and the sum over tp is the
        whole lookup (each id has one owner: exact)."""
        return self.reduce(vocab_lookup(table, ids, self.rank * table.shape[0]))

    def logprobs_entropy(self, logits: torch.Tensor, targets: torch.Tensor,
                         compute_entropy: bool):
        """``logits`` [N, V/tp] f32 (this rank's vocabulary block),
        ``targets`` [N] whole-vocabulary ids -> (logprobs [N], entropy
        [N] | None), as ``core_algos.logprobs_from_logits`` /
        ``entropy_from_logits`` give them on whole logits. The max is a
        constant of the log-sum-exp (no gradient), the shards' sums of
        exponentials and the owner's target logit are summed over tp."""
        v = logits.shape[-1]
        with torch.no_grad():
            m = logits.max(dim=-1, keepdim=True).values.clone()
            all_reduce(self.mesh, (TP,), m, op=torch.distributed.ReduceOp.MAX)
        shifted = logits - m
        sumexp = self.reduce(torch.exp(shifted).sum(dim=-1))
        lse = torch.log(sumexp)                               # [N], less m
        local = targets.long() - self.rank * v
        own = (local >= 0) & (local < v)
        picked = shifted.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        picked = self.reduce(torch.where(own, picked, 0.0))
        logprobs = picked - lse
        if not compute_entropy:
            return logprobs, None
        p = torch.exp(shifted - lse[..., None])
        entropy = lse - self.reduce((p * shifted).sum(dim=-1))
        return logprobs, entropy


def local_config(cfg, tp: int):
    """A ``ModelConfig`` of one tp shard: heads, MLP width (a MoE config's
    expert width) and vocabulary divided by ``tp``. ``tp`` must divide
    ``num_heads`` and ``num_kv_heads`` (the KV pools and the attention
    split on heads), the MLP width and the vocabulary. A MoE shard keeps
    every expert (and the whole router)."""
    if tp == 1:
        return cfg
    widths = ((("moe_intermediate_size", cfg.moe_intermediate_size),)
              if cfg.num_experts else
              (("intermediate_size", cfg.intermediate_size),))
    for what, n in (("num_heads", cfg.num_heads),
                    ("num_kv_heads", cfg.num_kv_heads), *widths,
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what} ({n})")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        moe_intermediate_size=cfg.moe_intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp, head_dim=cfg.head_dim_)
