"""Stream PPO critic: a token-value model with stream-update semantics.

Counterpart of ``polyrl_tpu/trainer/critic.py``: ``CriticConfig``,
``init_critic_params``, ``forward_values`` and its packed-row variant
``forward_values_packed``, and ``StreamCritic`` (``update_stream``,
``flush_opt_step``, ``compute_values``, ``compute_values_packed``): the
clipped value loss, gradients accumulated over micros scaled by
``loss_scale``, the optimizer step on ``is_opt_step``.

The value model is the decoder trunk (``decoder.forward_hidden``) with a
``[hidden, 1]`` value head in place of the LM head. The head is never
tied to the embedding, whatever the model's ``tie_word_embeddings`` says
(the JAX critic switches the tie off): the trunk's hidden states go
through the ``[D, 1]`` head only, so no ``[B, T, vocab]`` logits are ever
built. The optimizer is the actor's optax-exact chain
(``clip_by_global_norm``, then AdamW at a constant learning rate), without
the non-finite guard, as in the JAX critic. Parameters are updated in
place, as the actor's are.

On a mesh the critic shards as the actor does (``parallel/fsdp.py``:
every leaf and its AdamW moments over ``fsdp``, gathered whole for the
forwards of an optimizer step, the global clip norm) and each rank forwards its slice of the
batch (``actor.mesh_columns``), the values coming back whole on every
rank. Pipeline layer stacks and ``tp``/``ep``/``pp`` above 1 raise
``NotImplementedError`` (ROADMAP A' 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.models.quant import unflatten
from polyrl_tpu_torch.ops import core_algos
from polyrl_tpu_torch.parallel import fsdp
from polyrl_tpu_torch.trainer.actor import (Optimizer, _leaves, _to_device,
                                            _tree_map, bind_packed_attention,
                                            check_mesh_args,
                                            default_train_attention,
                                            from_columns, load_whole_state,
                                            mesh_columns, step_grads,
                                            train_state, whole_state)


@dataclasses.dataclass(frozen=True)
class CriticConfig:
    cliprange_value: float = 0.5
    loss_agg_mode: str = "token-mean"
    lr: float = 1e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    remat: bool = True


def init_critic_params(generator: torch.Generator,
                       model_cfg: decoder.ModelConfig) -> dict:
    """The decoder's parameters without ``lm_head``, plus ``value_head``
    ``[hidden, 1]`` drawn Normal(0.01), on ``generator``'s device."""
    params = decoder.init_params(generator, model_cfg)
    params.pop("lm_head", None)
    head = torch.randn((model_cfg.hidden_size, 1), generator=generator,
                       device=generator.device, dtype=torch.float32) * 0.01
    params["value_head"] = head.to(model_cfg.dtype)
    return params


def _values_of(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h @ head`` in f32, the value axis dropped: [..., d] -> [...]."""
    return decoder.unembed(h, head)[..., 0]


def forward_values(params, model_cfg, input_ids, positions, attn_mask,
                   responses, remat, attn_fn=None):
    """Token values for the response region [B, T_resp] (f32): the value at
    a response token is predicted from the position before it, the same
    one-left shift as the actor's logprobs."""
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat, attn_fn=attn_fn)
    t_resp = responses.shape[1]
    return _values_of(h[:, -t_resp - 1:-1], params["value_head"])


def forward_values_packed(params, model_cfg, input_ids, positions, attn_mask,
                          segment_ids, remat, loss_mask=None):
    """Per-column values [R, L] on the packed layout: column t holds the
    value predicted from column t - 1 (column 0 is 0), the one-left shift
    of ``forward_values`` and the packed logprob pass, so the caller's
    ``loss_mask`` or ``PackSpec`` selects response-token values directly.
    ``loss_mask`` zeroes the columns outside it: a NaN there reaches
    neither the values nor, through the backward, the gradients."""
    h = decoder.forward_hidden(params, model_cfg, input_ids, positions,
                               attn_mask, remat=remat,
                               attn_fn=bind_packed_attention(segment_ids))
    v = F.pad(_values_of(h[:, :-1], params["value_head"]), (1, 0))
    if loss_mask is not None:
        v = torch.where(loss_mask > 0, v, 0.0)
    return v


class StreamCritic:
    """Owns the value model's parameters, optimizer state and accumulated
    gradients; the stream-update semantics of ``StreamActor``."""

    def __init__(self, model_cfg: decoder.ModelConfig, cfg: CriticConfig,
                 params: Any, mesh=None, attn_fn=None, layers_fn=None,
                 packed_attn_fn=None):
        check_mesh_args(mesh, attn_fn, layers_fn)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.attn_fn = attn_fn if attn_fn is not None else default_train_attention()
        self.packed_attn_fn = packed_attn_fn
        self.params = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        self._named = list(_leaves(self.params))
        self._fsdp = None
        if mesh is not None:
            # every leaf becomes this rank's fsdp shard (see StreamActor)
            self._fsdp = fsdp.ShardedLeaves(mesh, self._named)
            self._named = list(zip(self._fsdp.names, self._fsdp.shards))
            self.params = self._tree_with([p for _, p in self._named])
        self.device = self._named[0][1].device
        self.optimizer = Optimizer(cfg.max_grad_norm,
                                   lambda count: np.float32(cfg.lr),
                                   cfg.weight_decay)
        self.opt_state = self.optimizer.init([p for _, p in self._named])
        # sum of loss_scales since the last optimizer step (tail flush)
        self._accum_scale = 0.0

    def _tree_with(self, leaves: list[torch.Tensor]) -> dict:
        return unflatten(dict(zip((n for n, _ in self._named), leaves)))

    def _forward_params(self) -> dict:
        """The tree a forward reads (whole: gathered on a mesh)."""
        if self._fsdp is None:
            return self.params
        return self._tree_with(self._fsdp.full())

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Parameters and optimizer state (``actor.train_state``), whole
        (on a mesh gathered: a collective)."""
        return train_state(*whole_state(self._fsdp, self._named, self.opt_state))

    def load_state_dict(self, flat: dict[str, torch.Tensor]) -> None:
        load_whole_state(self._fsdp, self._named, self.opt_state, flat)

    def _values(self, params, batch: dict, remat: bool) -> torch.Tensor:
        """Values: ``[B, T_resp]`` on padded rows, per-column ``[R, L]`` on
        packed ones (``segment_ids`` in the batch), whole on every rank of
        a mesh."""
        packed = "segment_ids" in batch
        if self.mesh is not None:
            head = params["value_head"]
            vals = mesh_columns(self.mesh, params, self.model_cfg, batch, packed,
                                remat, self.attn_fn, self.packed_attn_fn,
                                lambda hs, _targets: [_values_of(hs, head)],
                                mask_key=None)[0]
            return from_columns(vals, batch, packed)
        if packed:
            return forward_values_packed(
                params, self.model_cfg, batch["input_ids"], batch["positions"],
                batch["attention_mask"], batch["segment_ids"], remat,
                loss_mask=batch.get("loss_mask"))
        return forward_values(params, self.model_cfg, batch["input_ids"],
                              batch["positions"], batch["attention_mask"],
                              batch["responses"], remat, attn_fn=self.attn_fn)

    def _loss(self, batch: dict, loss_scale: float):
        vpreds = self._values(self._forward_params(), batch, self.cfg.remat)
        mask = batch["loss_mask" if "segment_ids" in batch else "response_mask"]
        vf_loss, clipfrac = core_algos.compute_value_loss(
            vpreds, batch["returns"], batch["values"], mask,
            cliprange_value=self.cfg.cliprange_value,
            loss_agg_mode=self.cfg.loss_agg_mode)
        return vf_loss * loss_scale, {"critic/vf_loss": vf_loss,
                                      "critic/vf_clipfrac": clipfrac}

    def _opt_step(self, inv_scale: float = 1.0) -> dict:
        grads, g_norm, _ = step_grads(self._fsdp, self._named, inv_scale,
                                      self.optimizer)
        metrics = {"critic/grad_norm": float(g_norm)}
        self.optimizer.step([p for _, p in self._named], grads, self.opt_state,
                            g_norm=g_norm)
        for _, p in self._named:
            p.grad = None
        if self._fsdp is not None:
            self._fsdp.release()
        return metrics

    def update_stream(self, batch: dict, is_opt_step: bool,
                      loss_scale: float = 1.0) -> dict:
        """One sub-minibatch forward/backward (+ optimizer step at the
        boundary). ``batch`` holds the padded fields (input_ids, positions,
        attention_mask, responses, response_mask) or the packed ones
        (input_ids, positions, attention_mask, segment_ids, loss_mask),
        with returns and values in the same layout."""
        feed = _to_device(batch, self.device)
        with torch.enable_grad():
            loss, metrics = self._loss(feed, loss_scale)
            loss.backward()
        metrics = {k: float(v.detach()) for k, v in metrics.items()}
        if is_opt_step:
            metrics.update(self._opt_step())
        self._accum_scale = 0.0 if is_opt_step else self._accum_scale + loss_scale
        return metrics

    def flush_opt_step(self) -> dict:
        """Apply the accumulated gradients without new data, renormalized by
        the summed loss_scale (see ``StreamActor.flush_opt_step``)."""
        inv = 1.0 / self._accum_scale if self._accum_scale > 0 else 1.0
        metrics = self._opt_step(inv)
        self._accum_scale = 0.0
        return metrics

    @torch.no_grad()
    def compute_values(self, batch: dict) -> torch.Tensor:
        """[B, T_resp] values of the response region (no grad, no remat)."""
        feed = _to_device(batch, self.device)
        return self._values(self._forward_params(), feed, False)

    @torch.no_grad()
    def compute_values_packed(self, batch: dict) -> torch.Tensor:
        """[R, L] per-column values on a packed feed (no grad)."""
        return self.compute_values(batch)
