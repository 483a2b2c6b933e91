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

Not ported yet (each raises ``NotImplementedError``): meshes (sharded
parameters), the sequence-parallel packed attention (``packed_attn_fn``)
and pipeline layer stacks.
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
from polyrl_tpu_torch.models.quant import lora_alphas, named_leaves, tree_map
from polyrl_tpu_torch.ops import core_algos, flash

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
             state: OptState) -> None:
        if self.guards_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in grads]).all())
            state.notfinite_count = 0 if finite else state.notfinite_count + 1
            if not finite:
                state.total_notfinite += 1
                if state.notfinite_count <= self.max_consecutive_errors:
                    return  # rejected: zero update, inner state unchanged
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
                            attn_fn=None):
    """Forward over [B, T_total]; logprobs of the response tokens
    [B, T_resp] (and their entropy). Logits at position i predict token
    i + 1, so the predictors of the responses (the last T_resp positions)
    are the T_resp positions before them. Only those hidden states are
    unembedded (the same values as slicing the full logits); without
    autograd, a few rows at a time."""
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat, attn_fn=attn_fn)
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


def bind_packed_attention(segment_ids: torch.Tensor):
    """The layer attention of a packed batch on one device: K4 (its plain
    version on the CPU), causal, with the rows' segment ids, so no token
    attends another trajectory of its row."""
    return functools.partial(flash.flash_attention_train, causal=True,
                             segment_ids=segment_ids)


def _packed_logprobs_entropy(params, model_cfg, input_ids, positions,
                             attn_mask, segment_ids, remat, compute_entropy,
                             loss_mask=None):
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
    are unembedded a chunk at a time."""
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat,
                               attn_fn=bind_packed_attention(segment_ids))
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


class StreamActor:
    """Owns params, optimizer state and accumulated gradients; stream-update
    semantics: gradients accumulate over ``update_stream`` calls scaled by
    ``loss_scale``, and the optimizer steps only when ``is_opt_step``."""

    def __init__(self, model_cfg: decoder.ModelConfig, cfg: ActorConfig,
                 params: Any, mesh=None, attn_fn=None, layers_fn=None,
                 packed_attn_fn=None):
        if mesh is not None or layers_fn is not None or packed_attn_fn is not None:
            raise NotImplementedError(
                "meshes, pipeline stacks and the sequence-parallel packed "
                "attention are not ported yet (ROADMAP A' 9)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = None
        self.attn_fn = attn_fn if attn_fn is not None else default_train_attention()
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

    def export_params(self) -> dict:
        """The parameters in the plain layout the rollout engine takes: the
        adapters merged into their bases (``lora.merge_lora``, a new tree)
        under LoRA, else the parameters themselves."""
        if not self._lora:
            return self.params
        from polyrl_tpu_torch.models import lora as lora_mod

        with torch.no_grad():
            return lora_mod.merge_lora(self.params)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Parameters and optimizer state (``train_state``)."""
        self._wait_offloaded()
        return train_state(self._named, self.opt_state, self._frozen,
                           lora_alphas(self.params))

    def load_state_dict(self, flat: dict[str, torch.Tensor]) -> None:
        self._wait_offloaded()
        load_train_state(self._named, self.opt_state, flat, self._frozen,
                         lora_alphas(self.params))

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

    def _loss_fn(self, batch: dict, loss_scale: float):
        cfg = self.cfg
        if "segment_ids" in batch:
            # packed rows: loss_mask plays response_mask; advantages and
            # old_log_probs already live in the packed [R, L] layout
            logprobs, entropy = _packed_logprobs_entropy(
                self.params, self.model_cfg, batch["input_ids"],
                batch["positions"], batch["attention_mask"],
                batch["segment_ids"], cfg.remat, cfg.entropy_coeff != 0.0,
                loss_mask=batch["loss_mask"])
            batch = dict(batch, response_mask=batch["loss_mask"])
        else:
            logprobs, entropy = _model_logprobs_entropy(
                self.params, self.model_cfg, batch["input_ids"],
                batch["positions"], batch["attention_mask"],
                batch["responses"], batch["response_mask"], cfg.remat,
                cfg.entropy_coeff != 0.0, attn_fn=self.attn_fn)
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

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for _, p in self._named]

    def _opt_step(self, inv_scale: float = 1.0) -> dict:
        grads = self._grads()
        if inv_scale != 1.0:
            grads = [g * inv_scale for g in grads]
        metrics = {"actor/grad_norm": float(self.optimizer.global_norm(grads))}
        self.optimizer.step([p for _, p in self._named], grads, self.opt_state)
        if self.optimizer.guards_nonfinite:
            metrics["actor/nonfinite_skips"] = float(
                self.opt_state.total_notfinite)
        for _, p in self._named:
            p.grad = None
        return metrics

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
        entropy | None) as tensors on the actor's device."""
        feed = _to_device(batch, self.device)
        return _model_logprobs_entropy(
            self.params, self.model_cfg, feed["input_ids"], feed["positions"],
            feed["attention_mask"], feed["responses"], feed["response_mask"],
            remat=False, compute_entropy=compute_entropy, attn_fn=self.attn_fn)

    @torch.no_grad()
    def compute_log_prob_packed(self, batch: dict, compute_entropy: bool = True):
        """Packed-row logprob pass: [R, L] per-column logprobs (and
        entropy) that ``loss_mask`` selects the response tokens of (see
        ``_packed_logprobs_entropy``)."""
        feed = _to_device(batch, self.device)
        return _packed_logprobs_entropy(
            self.params, self.model_cfg, feed["input_ids"], feed["positions"],
            feed["attention_mask"], feed["segment_ids"], remat=False,
            compute_entropy=compute_entropy, loss_mask=feed.get("loss_mask"))


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
