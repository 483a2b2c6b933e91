"""Stream PPO/GRPO actor: per-micro forward/backward with gradient
accumulation, and the optimizer step at minibatch boundaries.

Counterpart of ``polyrl_tpu/trainer/actor.py``: ``ActorConfig``, the
optimizer of ``make_optimizer``, ``_model_logprobs_entropy`` and its
packed-row variant ``_packed_logprobs_entropy``, ``StreamActor``
(``update_stream``, ``flush_opt_step``, ``compute_log_prob``,
``compute_log_prob_packed``) and ``ReferencePolicy``. The attention of
every forward is ``flash.auto_train_attention()`` by default, and on
packed rows K4 with the rows' segment ids (``bind_packed_attention``):
K4 on the card, its plain version on the CPU.

Where the JAX actor donates its buffers to a jitted update, this one
updates in place: the actor takes the tensors it is given as its own
parameters (``requires_grad``), gradients accumulate in ``.grad``, and the
optimizer writes the new values into the same storage. Whoever needs the
initial weights afterwards must copy them first, as ``ReferencePolicy``
and the engine do.

LoRA (``lora_rank > 0``): the actor wraps its tree at construction
(``models/lora.wrap_lora``, adapters drawn from a generator seeded
``7919 + rank``); only the adapters' ``a``/``b`` get ``requires_grad``,
optimizer state, the clip norm and weight decay (the reference's
``multi_transform`` with ``set_to_zero`` elsewhere), and
``export_params`` hands the engine the merged plain tree. Optimizer
offload (``offload_optimizer``): ``offload_opt_state`` moves the moments
into pinned host buffers allocated once, ``load_opt_state`` brings them
back on the default stream before the next update.

Meshes (``mesh=``, ``parallel/mesh.py``): the trained leaves and their
AdamW moments shard over ``tp`` by their specs and then over ``fsdp``
(``parallel/fsdp.py``: each layer's shard gathered inside its layer body
and its gradient reduce-scattered by its backward; the other leaves
gathered whole for the forwards of an optimizer step; the gradients
summed over the replicas at the step, clipped by the global norm), on a
``tp`` axis each rank runs its tensor-parallel shard
(``parallel/tensor.py``: Megatron projections, a vocab-parallel embedding
and logprob head, the frozen leaves cut to their tp blocks too), and
each rank forwards
its slice of the batch (``_shard_feed``: rows over dp x fsdp, columns over
sp), through ``attn_fn`` (with sp > 1 a sequence-parallel attention) or,
on packed rows, ``packed_attn_fn`` with this rank's segment ids. The
per-token logprobs come back whole on every rank (``fsdp.gather_data``),
so the loss, its metrics and ``compute_log_prob`` see the whole micro, as
the JAX actor's GSPMD program does. Under LoRA the adapters shard and the
frozen base stays whole on every rank of a tp group. On an ``ep`` axis
each rank holds its ``E/ep`` experts of every MoE layer
(``parallel/expert.py``); on a ``pp`` axis its stage's ``L/pp`` layers, and
the forward's layer loop is the pipeline ``layers_fn``
(``parallel/pipeline.make_pipeline_layers_fn``), which a pp mesh needs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.quant import (flatten, lora_alphas, named_leaves,
                                           tree_map, unflatten)
from polyrl_tpu_torch.ops import core_algos, flash
from polyrl_tpu_torch.parallel import expert, fsdp
from polyrl_tpu_torch.parallel import mesh as meshlib
from polyrl_tpu_torch.parallel import tensor

# rows per unembed chunk in no-grad logprob passes: [rows, T_resp, V] f32
# logits for 4 rows of 448 tokens at vocab 151,936 are 1.1 GB
_NOGRAD_ROW_CHUNK = 4
# response tokens per unembed chunk in no-grad packed passes (1.2 GB of f32
# logits at vocab 151,936)
_NOGRAD_TOKEN_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    policy_loss: str = "vanilla"          # vanilla | gpg | clip_cov
    clip_ratio: float = 0.2
    clip_ratio_low: float | None = None
    clip_ratio_high: float | None = None
    clip_ratio_c: float = 3.0
    entropy_coeff: float = 0.0
    use_kl_loss: bool = False             # GRPO-style in-loss KL
    kl_loss_coef: float = 0.001
    kl_loss_type: str = "low_var_kl"
    loss_agg_mode: str = "token-mean"
    lr: float = 1e-6
    lr_warmup_steps: int = 0
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    offload_optimizer: bool = False       # moments to pinned host memory between steps
    lora_rank: int = 0                    # > 0: train LoRA adapters only
    lora_alpha: float = 16.0
    # skip (do not apply) optimizer updates holding non-finite values, up to
    # this many in a row; 0 disables the guard
    max_nonfinite_skips: int = 100
    ppo_epochs: int = 1
    remat: bool = True


# -- optimizer: optax.chain(clip_by_global_norm, adamw), apply_if_finite ------


def _f32(x) -> np.float32:
    return np.float32(x)


def make_schedule(cfg: ActorConfig, total_steps: int = 0) -> Callable[[int], np.float32]:
    """The learning rate at optimizer count ``c``, in f32 as optax computes
    it: warmup-cosine when ``total_steps > 0``, else linear warmup from 0
    (0 at count 0) when ``lr_warmup_steps > 0``, else constant."""
    lr = _f32(cfg.lr)

    def linear(c, steps):
        c = min(max(c, 0), steps)
        return (_f32(0.0) - lr) * (_f32(1) - _f32(c) / _f32(steps)) + lr

    if total_steps > 0:
        warm = max(cfg.lr_warmup_steps, 1)
        decay = total_steps - warm
        if decay <= 0:
            raise ValueError("warmup-cosine needs total_steps > warmup steps")

        def sched(c):
            if c < warm:
                return linear(c, warm)
            t = _f32(min(c - warm, decay))
            cos = _f32(0.5) * (_f32(1) + _f32(math.cos(math.pi * float(t) / decay)))
            return lr * cos
        return sched
    if cfg.lr_warmup_steps > 0:
        return lambda c: linear(c, cfg.lr_warmup_steps)
    return lambda c: lr


@dataclasses.dataclass
class OptState:
    count: int                   # AdamW (and schedule) step count
    mu: list[torch.Tensor]       # first moment, in each parameter's dtype
    nu: list[torch.Tensor]       # second moment, in each parameter's dtype
    notfinite_count: int = 0     # consecutive non-finite updates
    total_notfinite: int = 0     # all non-finite updates seen


class Optimizer:
    """The JAX actor's ``make_optimizer``, step for step:
    ``clip_by_global_norm(max_norm)`` (scale by ``max_norm / g_norm`` only
    when ``g_norm >= max_norm``, no epsilon), then AdamW (b1 0.9, b2 0.999,
    eps 1e-8, decoupled decay on every leaf, the learning rate from the
    schedule at the optimizer's count), the state in the parameters' dtype,
    and optionally ``apply_if_finite``: a non-finite gradient is skipped
    and counted, and applied anyway after ``max_consecutive_errors`` skips
    in a row. Parameters are updated in place."""

    def __init__(self, max_norm: float, schedule: Callable[[int], np.float32],
                 weight_decay: float, max_consecutive_errors: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.max_norm = float(max_norm)
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.max_consecutive_errors = int(max_consecutive_errors)
        self.b1, self.b2, self.eps = b1, b2, eps

    @property
    def guards_nonfinite(self) -> bool:
        return self.max_consecutive_errors > 0

    def init(self, params: list[torch.Tensor]) -> OptState:
        return OptState(0, [torch.zeros_like(p) for p in params],
                        [torch.zeros_like(p) for p in params])

    @staticmethod
    def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of every leaf, in f32."""
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor],
             state: OptState, g_norm: torch.Tensor | None = None,
             finite: bool | None = None) -> None:
        """``g_norm`` and ``finite``, when given, are the whole gradient's
        (a sharded one's, the same on every rank)."""
        if self.guards_nonfinite:
            if finite is None:
                finite = bool(torch.stack([torch.isfinite(g).all()
                                           for g in grads]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            if not finite:
                state.total_notfinite += 1
                if state.notfinite_count <= self.max_consecutive_errors:
                    return  # rejected: zero update, inner state unchanged
        if g_norm is None:
            g_norm = self.global_norm(grads)
        clip = not bool(g_norm < self.max_norm)
        count = state.count + 1
        bc1 = _f32(1) - _f32(self.b1) ** _f32(count)
        bc2 = _f32(1) - _f32(self.b2) ** _f32(count)
        neg_lr = float(-self.schedule(state.count))
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            dt = p.dtype
            if clip:
                g = (g / g_norm.to(dt)) * self.max_norm
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            # optax casts the bias correction to the moment's dtype first
            mu_hat = mu / float(torch.tensor(bc1).to(dt))
            nu_hat = nu / float(torch.tensor(bc2).to(dt))
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * neg_lr)
        state.count = count


def make_optimizer(cfg: ActorConfig, total_steps: int = 0) -> Optimizer:
    """AdamW with gradient clipping; warmup (+ cosine decay when
    ``total_steps > 0``); the non-finite guard unless
    ``max_nonfinite_skips == 0``."""
    return Optimizer(cfg.max_grad_norm, make_schedule(cfg, total_steps),
                     cfg.weight_decay, cfg.max_nonfinite_skips)


# -- forward passes ---------------------------------------------------------------


def default_train_attention():
    """K4 on the card, its plain version on the CPU."""
    return flash.auto_train_attention()


_leaves = named_leaves
_tree_map = tree_map


def _logprobs_entropy_of(h, head, responses, response_mask, compute_entropy):
    """Logits of the response predictors ``h`` [B, Tr, d] and their
    logprobs (and entropy), with the finiteness guard of the JAX actor:
    positions outside the mask are zeroed in the LOGITS before the
    log-softmax (double where), so a NaN there reaches neither the value
    nor, through the backward, the shared weight gradients."""
    keep = response_mask > 0
    logits = decoder.unembed(h, head)
    logits = torch.where(keep[..., None], logits, 0.0)
    logprobs = torch.where(
        keep, core_algos.logprobs_from_logits(logits, responses), 0.0)
    entropy = (torch.where(keep, core_algos.entropy_from_logits(logits), 0.0)
               if compute_entropy else None)
    return logprobs, entropy


def _model_logprobs_entropy(params, model_cfg, input_ids, positions, attn_mask,
                            responses, response_mask, remat, compute_entropy,
                            attn_fn=None, layers_fn=None):
    """Forward over [B, T_total]; logprobs of the response tokens
    [B, T_resp] (and their entropy). Logits at position i predict token
    i + 1, so the predictors of the responses (the last T_resp positions)
    are the T_resp positions before them. Only those hidden states are
    unembedded (the same values as slicing the full logits); without
    autograd, a few rows at a time. ``layers_fn``: a pipeline layer stack
    (``decoder.forward_hidden``'s hook)."""
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat, attn_fn=attn_fn,
                               layers_fn=layers_fn)
    t_resp = responses.shape[1]
    h = h[:, -t_resp - 1:-1]
    head = decoder.head_weight(params, model_cfg)
    if torch.is_grad_enabled():
        return _logprobs_entropy_of(h, head, responses, response_mask,
                                    compute_entropy)
    parts = [_logprobs_entropy_of(h[i:i + _NOGRAD_ROW_CHUNK], head,
                                  responses[i:i + _NOGRAD_ROW_CHUNK],
                                  response_mask[i:i + _NOGRAD_ROW_CHUNK],
                                  compute_entropy)
             for i in range(0, h.shape[0], _NOGRAD_ROW_CHUNK)]
    lp = torch.cat([p[0] for p in parts])
    ent = torch.cat([p[1] for p in parts]) if compute_entropy else None
    return lp, ent


def bind_packed_attention(attn_fn, layers_fn, segment_ids: torch.Tensor):
    """A packed batch's segment ids bound into the attention: ``(attn,
    layers_fn)`` for ``decoder.forward_hidden``, the JAX function's
    dispatch.

    - ``layers_fn`` (packed x pipeline): the stages' attention takes the
      segment ids; an ``attn_fn`` beside it raises, since the pipeline
      computes its own stage attention.
    - ``attn_fn`` (packed x sp): the segment-aware sequence-parallel
      attention ``attn_fn(q, k, v, mask, segment_ids)``.
    - neither: K4 (its plain version on the CPU), causal, with the
      segment ids, so no token attends another trajectory of its row."""
    if layers_fn is not None:
        if attn_fn is not None:
            raise ValueError(
                "packed pass got BOTH an SP attn_fn and a pipeline "
                "layers_fn; the pipeline computes its own stage attention")
        return None, functools.partial(layers_fn, segment_ids=segment_ids)
    if attn_fn is None:
        return functools.partial(flash.flash_attention_train, causal=True,
                                 segment_ids=segment_ids), None
    return (lambda q, k, v, m: attn_fn(q, k, v, m, segment_ids)), None


def _packed_logprobs_entropy(params, model_cfg, input_ids, positions,
                             attn_mask, segment_ids, remat, compute_entropy,
                             loss_mask=None, layers_fn=None):
    """Packed-row (remove-padding) variant: rows hold several trajectories
    separated by segment ids. Returns per-COLUMN logprobs [R, L] (and
    entropy): column t holds the logprob of ``input_ids[:, t]`` predicted
    from column t - 1, so column 0 is 0 and the caller's ``loss_mask``
    selects the response tokens (never at a segment's first column: a
    segment starts with at least one prompt token).

    With ``loss_mask`` only the predictors of masked columns are unembedded
    (every column's otherwise): the other columns are 0 in both outputs,
    the values the JAX version's double where gives them, and a NaN in an
    unselected hidden state reaches neither the outputs nor, through the
    backward, the weight gradients. Without autograd the selected tokens
    are unembedded a chunk at a time. ``layers_fn``: a pipeline layer
    stack, which takes the segment ids."""
    attn, lf = bind_packed_attention(None, layers_fn, segment_ids)
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat, attn_fn=attn,
                               layers_fn=lf)
    r, l = input_ids.shape
    keep = (torch.ones((r, l - 1), dtype=torch.bool, device=h.device)
            if loss_mask is None else loss_mask[:, 1:] > 0)
    hs = h[:, :-1][keep]                                   # [N, d]
    targets = input_ids[:, 1:][keep]
    head = decoder.head_weight(params, model_cfg)
    step = (max(hs.shape[0], 1) if torch.is_grad_enabled()
            else _NOGRAD_TOKEN_CHUNK)
    lps, ents = [], []
    for i in range(0, max(hs.shape[0], 1), step):
        logits = decoder.unembed(hs[i:i + step], head)
        lps.append(core_algos.logprobs_from_logits(logits, targets[i:i + step]))
        if compute_entropy:
            ents.append(core_algos.entropy_from_logits(logits))

    def to_columns(vals):
        flat = torch.zeros((r, l - 1), dtype=torch.float32, device=h.device)
        return F.pad(flat.masked_scatter(keep, torch.cat(vals)), (1, 0))

    return to_columns(lps), (to_columns(ents) if compute_entropy else None)


# -- the mesh path ------------------------------------------------------------


def _shard_feed(mesh, feed: dict) -> dict:
    """This rank's slice of a whole feed: rows over (dp, fsdp), columns
    over sp (``mesh.shard_batch``)."""
    return meshlib.shard_batch(mesh, feed)


def _predictor_columns(feed: dict, packed: bool,
                       mask_key: str | None = "response_mask") -> torch.Tensor:
    """[B, T] bool: the columns whose hidden state predicts a token the
    pass returns. Packed rows: those before a ``loss_mask`` column (every
    column but the last without one). Padded rows: the ``T_resp`` columns
    before the last, only those of ``feed[mask_key]`` unless ``mask_key``
    is None."""
    ids = feed["input_ids"]
    b, t = ids.shape
    pred = torch.zeros((b, t), dtype=torch.bool, device=ids.device)
    if packed:
        lm = feed.get("loss_mask")
        pred[:, :-1] = True if lm is None else lm[:, 1:] > 0
    else:
        tr = feed["responses"].shape[1]
        pred[:, t - tr - 1:t - 1] = True if mask_key is None else feed[mask_key] > 0
    return pred


def mesh_columns(mesh, params, model_cfg, feed: dict, packed: bool, remat: bool,
                 attn_fn, packed_attn_fn, head_fn,
                 mask_key: str | None = "response_mask",
                 layers_fn=None) -> list[torch.Tensor]:
    """A per-token pass on a mesh: this rank forwards its slice of the
    whole ``feed`` (``_shard_feed``), ``head_fn(h, next_ids)`` maps the
    hidden states of its predictor columns (``_predictor_columns``) to a
    list of per-token outputs, and each comes back as a whole ``[B, T]``
    f32 tensor on every rank (``fsdp.gather_data``, differentiable):
    column c holds the output for token c + 1, predicted from column c,
    and 0 off the predictor columns. Packed rows attend through
    ``packed_attn_fn(q, k, v, mask, segment_ids)`` with this rank's
    segment ids (K4 with them when it is None), padded ones through
    ``attn_fn``; a pipeline ``layers_fn`` runs the layer loop instead
    (``bind_packed_attention``). On a tp axis the forward runs this rank's
    tp shard (``params`` its blocks) and ``head_fn`` gets
    ``mesh_tp(mesh)``'s seam as a third argument; on an ep axis its
    expert blocks."""
    ids = feed["input_ids"]
    nxt = torch.zeros_like(ids)
    nxt[:, :-1] = ids[:, 1:]
    keys = ("input_ids", "positions", "attention_mask") + (
        ("segment_ids",) if packed else ())
    local = _shard_feed(mesh, {**{k: feed[k] for k in keys}, "next_ids": nxt,
                               "pred": _predictor_columns(feed, packed, mask_key)})
    if packed:
        attn, lf = bind_packed_attention(packed_attn_fn, layers_fn,
                                         local["segment_ids"])
    else:
        attn, lf = attn_fn, layers_fn
    tp = mesh_tp(mesh)
    h = decoder.forward_hidden(params, model_cfg, local["input_ids"],
                               local["positions"], local["attention_mask"],
                               remat=remat, attn_fn=attn, tp=tp,
                               ep=expert.mesh_ep(mesh), layers_fn=lf)
    keep = local["pred"]
    outs = (head_fn(h[keep], local["next_ids"][keep]) if tp is None
            else head_fn(h[keep], local["next_ids"][keep], tp))
    return [fsdp.gather_data(mesh, torch.zeros(keep.shape, dtype=torch.float32,
                                               device=h.device).masked_scatter(keep, o))
            for o in outs]


def mesh_tp(mesh):
    """The decoder's tp seam on a mesh with tp above 1 (else None)."""
    if mesh is None or mesh.shape[meshlib.TP] == 1:
        return None
    return tensor.TensorParallel(mesh)


def from_columns(cols: torch.Tensor, feed: dict, packed: bool) -> torch.Tensor:
    """``mesh_columns``' layout -> the one-device pass's: packed rows'
    per-column values (column t holds token t's, 0 at column 0), padded
    rows' ``[B, T_resp]`` response region."""
    if packed:
        return F.pad(cols[:, :-1], (1, 0))
    t, tr = cols.shape[1], feed["responses"].shape[1]
    return cols[:, t - tr - 1:t - 1]


def _logprob_head(params, model_cfg, compute_entropy: bool):
    """``mesh_columns``' head of the logprob pass: the logprobs (and
    entropy) of the targets, unembedded a chunk at a time without
    autograd; on a tp shard vocab-parallel (``TensorParallel.
    logprobs_entropy`` over this rank's vocabulary block)."""
    head = decoder.head_weight(params, model_cfg)

    def fn(hs, targets, tp=None):
        n = max(hs.shape[0], 1)
        step = n if torch.is_grad_enabled() else _NOGRAD_TOKEN_CHUNK
        lps, ents = [], []
        if tp is not None:
            hs = tp.copy(hs)
        for i in range(0, n, step):
            logits = decoder.unembed(hs[i:i + step], head)
            if tp is not None:
                lp, ent = tp.logprobs_entropy(logits, targets[i:i + step],
                                              compute_entropy)
                lps.append(lp)
                if compute_entropy:
                    ents.append(ent)
                continue
            lps.append(core_algos.logprobs_from_logits(logits, targets[i:i + step]))
            if compute_entropy:
                ents.append(core_algos.entropy_from_logits(logits))
        return [torch.cat(lps)] + ([torch.cat(ents)] if compute_entropy else [])
    return fn


_FEED_DTYPES = {"input_ids": torch.long, "responses": torch.long,
                "positions": torch.int32, "segment_ids": torch.int32}


def _to_device(batch: dict, device: torch.device) -> dict:
    """Host arrays (or tensors) -> tensors on ``device``; ids as int64,
    positions int32, everything else f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        out[k] = t.to(device=device, dtype=_FEED_DTYPES.get(k, torch.float32))
    return out


_OPT_COUNTS = ("count", "notfinite_count", "total_notfinite")


def train_state(named: list, opt_state: OptState, frozen: list = (),
                alphas: dict | None = None) -> dict[str, torch.Tensor]:
    """Parameters and optimizer state as one flat ``{name: tensor}`` dict
    (the tensors themselves, not copies): ``params.<leaf>`` of the trained
    (``named``) and ``frozen`` leaves, ``opt.mu.<leaf>`` and
    ``opt.nu.<leaf>`` of the trained ones, the counts (``opt.count`` is
    AdamW's step and the schedule's) and each LoRA ``alpha`` as a 0-d f64
    ``params.<path>.alpha`` (``quant.flatten``'s names)."""
    out = {f"params.{n}": p.detach() for n, p in list(named) + list(frozen)}
    for (n, _), mu, nu in zip(named, opt_state.mu, opt_state.nu):
        out[f"opt.mu.{n}"] = mu
        out[f"opt.nu.{n}"] = nu
    for key in _OPT_COUNTS:
        out[f"opt.{key}"] = torch.tensor(getattr(opt_state, key))
    for k, a in (alphas or {}).items():
        out[f"params.{k}"] = torch.tensor(a, dtype=torch.float64)
    return out


@torch.no_grad()
def load_train_state(named: list, opt_state: OptState,
                     flat: dict[str, torch.Tensor], frozen: list = (),
                     alphas: dict | None = None) -> None:
    """Copy a ``train_state`` dict into the live tensors, in place (their
    device and dtype stay; a tensor of another dtype or shape, a missing
    name or another LoRA ``alpha`` raises)."""
    want = train_state(named, opt_state, frozen, alphas)
    if set(flat) != set(want):
        raise KeyError(f"checkpoint state has other tensors: missing "
                       f"{sorted(set(want) - set(flat))[:4]}, extra "
                       f"{sorted(set(flat) - set(want))[:4]}")
    for key, dst in want.items():
        src = flat[key]
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(f"checkpoint {key}: {src.dtype} {tuple(src.shape)}"
                             f", live {dst.dtype} {tuple(dst.shape)}")
        if key[4:] in _OPT_COUNTS:
            setattr(opt_state, key[4:], int(src))
        elif key[7:] in (alphas or {}):
            if float(src) != float(dst):
                raise ValueError(f"checkpoint {key} is {float(src)}, the live "
                                 f"adapter's {float(dst)}")
        else:
            dst.copy_(src)


def check_mesh_args(mesh, attn_fn, layers_fn, model_cfg=None,
                    packed_attn_fn=None) -> None:
    """What the actor and critic refuse: a mesh with sp above 1 and
    neither a sequence-parallel ``attn_fn`` nor a pipeline (whose stages
    ring over sp), a pp axis above 1 without a pipeline ``layers_fn``, an
    SP ``packed_attn_fn`` beside a pipeline (the stages compute their own
    attention), and a ``tp`` or ``ep`` that does not divide the model."""
    if layers_fn is not None and packed_attn_fn is not None:
        raise ValueError("a pipeline layers_fn computes its own stage "
                         "attention: pass no packed_attn_fn beside it")
    if mesh is None:
        return
    if mesh.shape[meshlib.PP] > 1 and layers_fn is None:
        raise ValueError(f"pp={mesh.shape[meshlib.PP]} needs a pipeline "
                         "layers_fn (parallel/pipeline.make_pipeline_layers_fn)")
    if mesh.shape[meshlib.SP] > 1 and attn_fn is None and layers_fn is None:
        raise ValueError("sp > 1 needs a sequence-parallel attn_fn "
                         "(parallel/sequence.make_sp_attention)")
    if model_cfg is not None:
        tensor.local_config(model_cfg, mesh.shape[meshlib.TP])
        if mesh.shape[meshlib.EP] > 1:
            if not model_cfg.num_experts:
                raise ValueError(f"ep={mesh.shape[meshlib.EP]} needs a MoE "
                                 "config (num_experts > 0)")
            expert.ExpertParallel(mesh).experts(model_cfg.num_experts)


def whole_state(sharded, named: list, opt_state: OptState):
    """``(named, opt_state)`` with whole tensors: gathered from the shards
    on a mesh (``sharded``, a ``fsdp.ShardedLeaves``), as they are
    otherwise."""
    if sharded is None:
        return named, opt_state
    whole = dataclasses.replace(opt_state, mu=sharded.gather(opt_state.mu),
                                nu=sharded.gather(opt_state.nu))
    return list(zip(sharded.names, sharded.gather([p for _, p in named]))), whole


@torch.no_grad()
def load_whole_state(sharded, named: list, opt_state: OptState, flat: dict,
                     frozen: list = (), alphas: dict | None = None,
                     frozen_shapes: list | None = None) -> None:
    """``load_train_state`` of a whole dict; on a mesh into whole scratch
    tensors first, whose shards (and the frozen leaves' tp blocks, whole
    shapes ``frozen_shapes``) then go into the live ones."""
    if sharded is None:
        load_train_state(named, opt_state, flat, frozen, alphas)
        return
    dev = named[0][1].device
    full = [torch.empty(shape, dtype=dt, device=dev)
            for shape, dt in zip(sharded.shapes, sharded.dtypes)]
    moments = dict(mu=[torch.empty_like(f) for f in full],
                   nu=[torch.empty_like(f) for f in full])
    scratch = dataclasses.replace(opt_state, **moments)
    whole_frozen = [(n, torch.empty(shape, dtype=p.dtype, device=p.device))
                    for (n, p), shape in zip(frozen, frozen_shapes or
                                             [p.shape for _, p in frozen])]
    load_train_state(list(zip(sharded.names, full)), scratch, flat,
                     whole_frozen, alphas)
    for (n, p), (_, w) in zip(frozen, whole_frozen):
        p.copy_(sharded.frozen_block(n, w))
    sharded.load([p for _, p in named], full)
    sharded.load(opt_state.mu, moments["mu"])
    sharded.load(opt_state.nu, moments["nu"])
    for key in _OPT_COUNTS:
        setattr(opt_state, key, getattr(scratch, key))


def step_grads(sharded, named: list, inv_scale: float, optimizer: Optimizer):
    """(gradients, their global norm, whether all are finite) for the
    optimizer step: on a mesh this rank's shards of the whole gradient
    (``ShardedLeaves.shard_grads``), the norm and the flag over every
    shard (the same on every rank); the finite flag None off a mesh (the
    step computes it)."""
    finite = None
    if sharded is not None:
        grads = sharded.shard_grads()
    else:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
    if inv_scale != 1.0:
        grads = [g * inv_scale for g in grads]
    if sharded is not None:
        g_norm, finite = sharded.global_norm(grads)
    else:
        g_norm = optimizer.global_norm(grads)
    return grads, g_norm, finite


def shard_tree(mesh, model_cfg, named: list, frozen: list, params: dict):
    """A trainer's tree on a mesh: (the ``fsdp.ShardedLeaves`` of its
    trained leaves, the shards as its ``(name, tensor)`` list, the frozen
    leaves cut to their tp blocks, the tree with those frozen blocks in
    place and the trained leaves as empty placeholders: only the shards
    hold them)."""
    sharded = fsdp.ShardedLeaves(mesh, named, model_cfg.num_layers)
    sharded.frozen_whole = {n: tuple(p.shape) for n, p in frozen}
    frozen = [(n, sharded.frozen_block(n, p.detach())) for n, p in frozen]
    flat = flatten(params)
    flat.update(dict(frozen))
    flat.update({n: p.new_empty(0) for n, p in named})
    return (sharded, list(zip(sharded.shard_names, sharded.shards)), frozen,
            unflatten(flat))


def forward_tree(sharded, params: dict) -> dict:
    """The tree a forward on a mesh reads (``ShardedLeaves.forward_leaves``
    in place of the trained leaves)."""
    leaves = sharded.forward_leaves(params["layers"])
    layers = leaves.pop("layers", None)
    tree = unflatten({**flatten(params), **leaves})
    if layers is not None:
        tree["layers"] = layers
    return tree


def whole_frozen(sharded, frozen: list) -> list:
    """The frozen leaves whole (their blocks gathered: collectives)."""
    if sharded is None:
        return list(frozen)
    return [(n, sharded.frozen_whole_leaf(n, p)) for n, p in frozen]


def frozen_shapes(sharded, frozen: list) -> list | None:
    if sharded is None:
        return None
    return [sharded.whole_frozen_shape(n) for n, _ in frozen]


@torch.no_grad()
def whole_tree(sharded, params: dict, frozen: list) -> dict:
    """The whole parameter tree of a trainer on a mesh (collectives)."""
    whole = dict(zip(sharded.names, sharded.gather(sharded.shards)))
    whole.update(dict(whole_frozen(sharded, frozen)))
    return unflatten({**flatten(params), **whole})


class StreamActor:
    """Owns params, optimizer state and accumulated gradients; stream-update
    semantics: gradients accumulate over ``update_stream`` calls scaled by
    ``loss_scale``, and the optimizer steps only when ``is_opt_step``."""

    def __init__(self, model_cfg: decoder.ModelConfig, cfg: ActorConfig,
                 params: Any, mesh=None, attn_fn=None, layers_fn=None,
                 packed_attn_fn=None):
        check_mesh_args(mesh, attn_fn, layers_fn, model_cfg, packed_attn_fn)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.attn_fn = attn_fn if attn_fn is not None else default_train_attention()
        self.layers_fn = layers_fn  # a pipeline layer stack (pp > 1)
        self.packed_attn_fn = packed_attn_fn
        self._lora = cfg.lora_rank > 0
        labels = None
        if self._lora:
            from polyrl_tpu_torch.models import lora as lora_mod

            dev = next(named_leaves(params))[1].device
            gen = torch.Generator(device=dev).manual_seed(7919 + cfg.lora_rank)
            params = lora_mod.wrap_lora(params, gen, cfg.lora_rank, cfg.lora_alpha)
            labels = lora_mod.lora_labels(params)
        self.params = _tree_map(lambda t: t.detach(), params)
        # the trained leaves (all, or the adapters) carry requires_grad and
        # optimizer state; frozen leaves neither (no gradient, no decay)
        self._named, self._frozen = [], []
        for n, p in named_leaves(self.params):
            trained = labels is None or labels[n] == "train"
            p.requires_grad_(trained)
            (self._named if trained else self._frozen).append((n, p))
        self._fsdp = None
        if mesh is not None:
            self._fsdp, self._named, self._frozen, self.params = shard_tree(
                mesh, model_cfg, self._named, self._frozen, self.params)
        self.device = self._named[0][1].device
        self.optimizer = make_optimizer(cfg)
        self.opt_state = self.optimizer.init([p for _, p in self._named])
        # optimizer offload: pinned host buffers, allocated at the first
        # offload and reused; an event marks the end of the last copy out
        self._opt_host: list[torch.Tensor] | None = None
        self._opt_offloaded = False
        self._offload_done: torch.cuda.Event | None = None
        # sum of loss_scales accumulated since the last optimizer step: a
        # tail flush renormalizes by it (mean over the micros it holds)
        self._accum_scale = 0.0

    def _forward_params(self) -> dict:
        """The tree a forward reads: on a mesh this rank's tp blocks, the
        layers through their per-layer gather and the rest gathered whole
        (through autograd while it records)."""
        if self._fsdp is None:
            return self.params
        return forward_tree(self._fsdp, self.params)

    def gather_params(self) -> dict:
        """The whole parameter tree (on a mesh a collective: every rank
        calls it; the whole leaves are new tensors)."""
        if self._fsdp is None:
            return self.params
        return whole_tree(self._fsdp, self.params, self._frozen)

    def export_params(self) -> dict:
        """The parameters in the plain layout the rollout engine takes: the
        adapters merged into their bases (``lora.merge_lora``, a new tree)
        under LoRA, else the parameters themselves (whole: on a mesh a
        collective)."""
        params = self.gather_params()
        if not self._lora:
            return params
        from polyrl_tpu_torch.models import lora as lora_mod

        with torch.no_grad():
            return lora_mod.merge_lora(params)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Parameters and optimizer state (``train_state``), whole (on a
        mesh gathered: a collective)."""
        self._wait_offloaded()
        named, state = whole_state(self._fsdp, self._named, self.opt_state)
        return train_state(named, state, whole_frozen(self._fsdp, self._frozen),
                           lora_alphas(self.params))

    def load_state_dict(self, flat: dict[str, torch.Tensor]) -> None:
        """Load a whole ``train_state`` dict (on a mesh each rank keeps its
        shards of it)."""
        self._wait_offloaded()
        load_whole_state(self._fsdp, self._named, self.opt_state, flat,
                         self._frozen, lora_alphas(self.params),
                         frozen_shapes(self._fsdp, self._frozen))

    # -- optimizer offload (reference actor.py:275-298) ------------------------

    def offload_opt_state(self) -> None:
        """Move the AdamW moments into pinned host buffers (allocated once,
        reused), freeing their device memory for generation. The copies
        are queued on the current stream without blocking; a no-op unless
        ``offload_optimizer``."""
        if not self.cfg.offload_optimizer or self._opt_offloaded:
            return
        dev_state = self.opt_state.mu + self.opt_state.nu
        if self._opt_host is None:
            pin = self.device.type == "cuda"
            self._opt_host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                              for t in dev_state]
        for h, d in zip(self._opt_host, dev_state):
            h.copy_(d, non_blocking=True)
        if self.device.type == "cuda":
            self._offload_done = torch.cuda.Event()
            self._offload_done.record()
        n = len(self.opt_state.mu)
        self.opt_state.mu = self._opt_host[:n]
        self.opt_state.nu = self._opt_host[n:]
        self._opt_offloaded = True

    def load_opt_state(self) -> None:
        """Bring offloaded moments back to the device, queued without
        blocking on the current stream (the default one), so the copies
        run before the update's first kernel."""
        if not self._opt_offloaded:
            return
        self.opt_state.mu = [h.to(self.device, non_blocking=True)
                             for h in self.opt_state.mu]
        self.opt_state.nu = [h.to(self.device, non_blocking=True)
                             for h in self.opt_state.nu]
        self._opt_offloaded = False

    def _wait_offloaded(self) -> None:
        """The host reads the pinned buffers only after the copies out."""
        if self._opt_offloaded and self._offload_done is not None:
            self._offload_done.synchronize()

    def _forward(self, params, batch: dict, remat: bool, compute_entropy: bool):
        """(logprobs, entropy | None): ``[B, T_resp]`` on padded rows,
        per-column ``[R, L]`` on packed ones (``segment_ids`` in the
        batch), whole on every rank of a mesh."""
        packed = "segment_ids" in batch
        if self.mesh is not None:
            cols = mesh_columns(self.mesh, params, self.model_cfg, batch, packed,
                                remat, self.attn_fn, self.packed_attn_fn,
                                _logprob_head(params, self.model_cfg,
                                              compute_entropy),
                                layers_fn=self.layers_fn)
            out = [from_columns(c, batch, packed) for c in cols]
            return out[0], (out[1] if compute_entropy else None)
        if packed:
            return _packed_logprobs_entropy(
                params, self.model_cfg, batch["input_ids"], batch["positions"],
                batch["attention_mask"], batch["segment_ids"], remat,
                compute_entropy, loss_mask=batch.get("loss_mask"),
                layers_fn=self.layers_fn)
        return _model_logprobs_entropy(
            params, self.model_cfg, batch["input_ids"], batch["positions"],
            batch["attention_mask"], batch["responses"], batch["response_mask"],
            remat, compute_entropy, attn_fn=self.attn_fn,
            layers_fn=self.layers_fn)

    def _loss_fn(self, batch: dict, loss_scale: float):
        cfg = self.cfg
        logprobs, entropy = self._forward(self._forward_params(), batch,
                                          cfg.remat, cfg.entropy_coeff != 0.0)
        if "segment_ids" in batch:
            # packed rows: loss_mask plays response_mask; advantages and
            # old_log_probs already live in the packed [R, L] layout
            batch = dict(batch, response_mask=batch["loss_mask"])
        loss_fn = core_algos.get_policy_loss_fn(cfg.policy_loss)
        if cfg.policy_loss != "gpg":
            pg_loss, clipfrac, approx_kl, clipfrac_lower = loss_fn(
                batch["old_log_probs"], logprobs, batch["advantages"],
                batch["response_mask"], clip_ratio=cfg.clip_ratio,
                clip_ratio_low=cfg.clip_ratio_low,
                clip_ratio_high=cfg.clip_ratio_high,
                clip_ratio_c=cfg.clip_ratio_c, loss_agg_mode=cfg.loss_agg_mode)
        else:
            pg_loss, clipfrac, approx_kl, clipfrac_lower = loss_fn(
                batch["old_log_probs"], logprobs, batch["advantages"],
                batch["response_mask"], loss_agg_mode=cfg.loss_agg_mode)
        loss = pg_loss
        metrics = {"actor/pg_loss": pg_loss, "actor/clipfrac": clipfrac,
                   "actor/approx_kl": approx_kl,
                   "actor/clipfrac_lower": clipfrac_lower}
        if cfg.entropy_coeff != 0.0:
            ent = core_algos.agg_loss(entropy, batch["response_mask"],
                                      cfg.loss_agg_mode)
            loss = loss - cfg.entropy_coeff * ent
            metrics["actor/entropy"] = ent
        if cfg.use_kl_loss:
            kld = core_algos.kl_penalty(logprobs, batch["ref_log_probs"],
                                        cfg.kl_loss_type)
            kl_loss = core_algos.agg_loss(kld, batch["response_mask"],
                                          cfg.loss_agg_mode)
            loss = loss + cfg.kl_loss_coef * kl_loss
            metrics["actor/kl_loss"] = kl_loss
        return loss * loss_scale, metrics

    def _opt_step(self, inv_scale: float = 1.0) -> dict:
        grads, g_norm, finite = step_grads(self._fsdp, self._named, inv_scale,
                                           self.optimizer)
        metrics = {"actor/grad_norm": float(g_norm)}
        self.optimizer.step([p for _, p in self._named], grads, self.opt_state,
                            g_norm=g_norm, finite=finite)
        if self.optimizer.guards_nonfinite:
            metrics["actor/nonfinite_skips"] = float(
                self.opt_state.total_notfinite)
        for _, p in self._named:
            p.grad = None
        self.release_gathered()
        return metrics

    def release_gathered(self) -> None:
        """Drop the whole leaves a mesh gathered (only the shards stay):
        after each optimizer step, and after each push (the trainer)."""
        if self._fsdp is not None:
            self._fsdp.release()

    def update_stream(self, batch: dict, is_opt_step: bool,
                      loss_scale: float = 1.0) -> dict:
        """One sub-minibatch forward/backward (+ optimizer step at the
        boundary). ``batch`` holds input_ids, positions, attention_mask,
        responses, response_mask, advantages, old_log_probs [,
        ref_log_probs] as host arrays or tensors. Returns float metrics."""
        feed = _to_device(batch, self.device)
        self.load_opt_state()
        with torch.enable_grad():
            loss, metrics = self._loss_fn(feed, loss_scale)
            loss.backward()
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        if is_opt_step:
            metrics.update(self._opt_step())
        self._accum_scale = 0.0 if is_opt_step else self._accum_scale + loss_scale
        return metrics

    def flush_opt_step(self) -> dict:
        """Apply the accumulated gradients without new data (a short batch
        ending mid-minibatch), renormalized by the summed loss_scale so the
        partial minibatch's update has the scale of a full one."""
        self.load_opt_state()
        inv = 1.0 / self._accum_scale if self._accum_scale > 0 else 1.0
        metrics = self._opt_step(inv)
        self._accum_scale = 0.0
        return {"actor/grad_norm": metrics["actor/grad_norm"]}

    @torch.no_grad()
    def compute_log_prob(self, batch: dict, compute_entropy: bool = True):
        """Old-logprob pass (no grad, no remat). Returns (logprobs,
        entropy | None) as tensors on the actor's device (whole on every
        rank of a mesh)."""
        feed = _to_device(batch, self.device)
        return self._forward(self._forward_params(), feed, False, compute_entropy)

    @torch.no_grad()
    def compute_log_prob_packed(self, batch: dict, compute_entropy: bool = True):
        """Packed-row logprob pass: [R, L] per-column logprobs (and
        entropy) that ``loss_mask`` selects the response tokens of (see
        ``_packed_logprobs_entropy``)."""
        return self.compute_log_prob(batch, compute_entropy)


class ReferencePolicy:
    """Frozen reference policy for the KL terms. Owns a COPY of the params:
    the actor updates its tensors in place."""

    def __init__(self, model_cfg: decoder.ModelConfig, params: Any, attn_fn=None):
        self.model_cfg = model_cfg
        self.params = _tree_map(lambda t: t.detach().clone(), params)
        self.device = next(iter(_leaves(self.params)))[1].device
        self.attn_fn = attn_fn if attn_fn is not None else default_train_attention()

    @torch.no_grad()
    def compute_log_prob(self, batch: dict) -> torch.Tensor:
        feed = _to_device(batch, self.device)
        lp, _ = _model_logprobs_entropy(
            self.params, self.model_cfg, feed["input_ids"], feed["positions"],
            feed["attention_mask"], feed["responses"], feed["response_mask"],
            remat=False, compute_entropy=False, attn_fn=self.attn_fn)
        return lp

    @torch.no_grad()
    def compute_log_prob_packed(self, batch: dict) -> torch.Tensor:
        feed = _to_device(batch, self.device)
        lp, _ = _packed_logprobs_entropy(
            self.params, self.model_cfg, feed["input_ids"], feed["positions"],
            feed["attention_mask"], feed["segment_ids"], remat=False,
            compute_entropy=False, loss_mask=feed.get("loss_mask"))
        return lp
