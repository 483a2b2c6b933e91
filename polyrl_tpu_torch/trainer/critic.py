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

Not ported yet (each raises ``NotImplementedError``): meshes, pipeline
layer stacks and the sequence-parallel packed attention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import core_algos
from polyrl_tpu_torch.trainer.actor import (Optimizer, _leaves, _to_device,
                                            _tree_map, bind_packed_attention,
                                            default_train_attention,
                                            load_train_state, train_state)


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
        if mesh is not None or layers_fn is not None or packed_attn_fn is not None:
            raise NotImplementedError(
                "meshes, pipeline stacks and the sequence-parallel packed "
                "attention are not ported yet (ROADMAP A' 9)")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.attn_fn = attn_fn if attn_fn is not None else default_train_attention()
        self.params = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        self._named = list(_leaves(self.params))
        self.device = self._named[0][1].device
        self.optimizer = Optimizer(cfg.max_grad_norm,
                                   lambda count: np.float32(cfg.lr),
                                   cfg.weight_decay)
        self.opt_state = self.optimizer.init([p for _, p in self._named])
        # sum of loss_scales since the last optimizer step (tail flush)
        self._accum_scale = 0.0

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Parameters and optimizer state (``actor.train_state``)."""
        return train_state(self._named, self.opt_state)

    def load_state_dict(self, flat: dict[str, torch.Tensor]) -> None:
        load_train_state(self._named, self.opt_state, flat)

    def _loss(self, batch: dict, loss_scale: float):
        if "segment_ids" in batch:  # packed (remove-padding) layout
            vpreds = forward_values_packed(
                self.params, self.model_cfg, batch["input_ids"],
                batch["positions"], batch["attention_mask"],
                batch["segment_ids"], self.cfg.remat,
                loss_mask=batch["loss_mask"])
            mask = batch["loss_mask"]
        else:
            vpreds = forward_values(
                self.params, self.model_cfg, batch["input_ids"],
                batch["positions"], batch["attention_mask"],
                batch["responses"], self.cfg.remat, attn_fn=self.attn_fn)
            mask = batch["response_mask"]
        vf_loss, clipfrac = core_algos.compute_value_loss(
            vpreds, batch["returns"], batch["values"], mask,
            cliprange_value=self.cfg.cliprange_value,
            loss_agg_mode=self.cfg.loss_agg_mode)
        return vf_loss * loss_scale, {"critic/vf_loss": vf_loss,
                                      "critic/vf_clipfrac": clipfrac}

    def _opt_step(self, inv_scale: float = 1.0) -> dict:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self._named]
        if inv_scale != 1.0:
            grads = [g * inv_scale for g in grads]
        metrics = {"critic/grad_norm": float(self.optimizer.global_norm(grads))}
        self.optimizer.step([p for _, p in self._named], grads, self.opt_state)
        for _, p in self._named:
            p.grad = None
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
        return forward_values(self.params, self.model_cfg, feed["input_ids"],
                              feed["positions"], feed["attention_mask"],
                              feed["responses"], False, attn_fn=self.attn_fn)

    @torch.no_grad()
    def compute_values_packed(self, batch: dict) -> torch.Tensor:
        """[R, L] per-column values on a packed feed (no grad)."""
        feed = _to_device(batch, self.device)
        return forward_values_packed(
            self.params, self.model_cfg, feed["input_ids"], feed["positions"],
            feed["attention_mask"], feed["segment_ids"], False,
            loss_mask=feed.get("loss_mask"))
