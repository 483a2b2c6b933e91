"""FSDP for the port's trainers: trained leaves sharded over the ``fsdp``
axis, gathered whole for the forwards of an optimizer step, their
gradients reduce-scattered at the step.

The actor and the critic hold a tree of tensors and their own AdamW, not
an ``nn.Module``, so the sharding is written here by hand on the mesh's
groups (no ``fully_shard``):

- each trained leaf is flattened, zero-padded to a multiple of fsdp and
  split; this rank keeps its 1/fsdp (``mesh.shard_tensor``), and the
  AdamW moments live on the shards (the padding stays 0: zero gradient,
  zero update);
- the first forward after an optimizer step gathers the WHOLE tree
  (``full``) and the step's later forwards reuse it (the parameters change
  only at the step): the decoder's layer loop indexes stacked ``[L, ...]``
  leaves, so there is no per-layer seam that would not change the
  decoder. Each micro's backward accumulates into the whole leaves'
  ``.grad``, as on one device. So the peak is one whole copy of the
  trained leaves and one of their gradients beside the shards and the
  moments' shards, and between steps only the shards stay
  (``release``, which the trainer calls after each push);
- at the optimizer step the whole gradients are reduce-scattered (summed
  in f32) over fsdp, then summed over the replicas (dp and sp,
  ``REPLICA_AXES``). Each rank's backward carries its rows' and columns'
  share of the GLOBAL micro's loss (the loss is computed on the gathered
  per-token values), so the sum is the one-process gradient;
- the clip norm is global: the squared shard norms (and a non-finite
  flag, so the guard's skip decision is the same on every rank) are
  summed over fsdp.

With fsdp 1 the shards are the leaves themselves and nothing is
gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polyrl_tpu_torch.parallel.mesh import (DATA_AXES, FSDP, REPLICA_AXES, Mesh,
                                            all_gather, all_reduce, batch_slices,
                                            gather_tensor, reduce_scatter,
                                            shard_tensor, unshard_batch)


class ShardedLeaves:
    """``named`` ``(name, tensor)`` leaves as this rank's fsdp shards
    (``shards``; on an fsdp axis of 1 the leaves themselves, with
    ``requires_grad``)."""

    def __init__(self, mesh: Mesh, named: list):
        self.mesh = mesh
        self.names = [n for n, _ in named]
        self.shapes = [tuple(t.shape) for _, t in named]
        self.shards = [shard_tensor(mesh, t.detach()).detach() for _, t in named]
        if not self.sharded:
            for s in self.shards:
                s.requires_grad_(True)
        self._full: list[torch.Tensor] | None = None

    @property
    def sharded(self) -> bool:
        return self.mesh.shape[FSDP] > 1

    def full(self) -> list[torch.Tensor]:
        """The whole leaves (with ``requires_grad``): gathered at the first
        call after a step or a ``release`` (a collective over fsdp), held
        until the next."""
        if not self.sharded:
            return self.shards
        if self._full is None:
            self._full = [t.requires_grad_(True) for t in self.gather(self.shards)]
        return self._full

    def release(self) -> None:
        """Drop the whole leaves (and their gradients): only the shards
        stay."""
        self._full = None

    @torch.no_grad()
    def gather(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole leaves of any per-shard state (parameters, moments)."""
        return [gather_tensor(self.mesh, s.detach(), shape)
                for s, shape in zip(shards, self.shapes)]

    @torch.no_grad()
    def load(self, dst: list[torch.Tensor], full: list[torch.Tensor]) -> None:
        """Copy this rank's shard of each whole tensor into ``dst``; the
        held whole leaves are dropped."""
        for d, f in zip(dst, full):
            d.copy_(shard_tensor(self.mesh, f.to(d.device)))
        self.release()

    @torch.no_grad()
    def shard_grads(self) -> list[torch.Tensor]:
        """This rank's shard of the step's gradient: the whole leaves'
        gradients reduce-scattered over fsdp (the leaves' own on an fsdp
        axis of 1), summed over the replicas (dp, sp)."""
        if not self.sharded:
            grads = [s.grad if s.grad is not None else torch.zeros_like(s)
                     for s in self.shards]
        else:
            n = self.mesh.shape[FSDP]
            grads = []
            for s, f in zip(self.shards, self._full or [None] * len(self.shards)):
                if f is None or f.grad is None:
                    grads.append(torch.zeros_like(s))
                    continue
                flat = f.grad.reshape(-1)
                flat = F.pad(flat, (0, s.numel() * n - flat.numel()))
                grads.append(reduce_scatter(self.mesh, (FSDP,), flat))
        if self.mesh.size(*REPLICA_AXES) > 1:
            grads = [all_reduce(self.mesh, REPLICA_AXES, g.clone()) for g in grads]
        return grads

    @torch.no_grad()
    def global_norm(self, grads: list[torch.Tensor]) -> tuple[torch.Tensor, bool]:
        """(the f32 norm of the whole gradient, whether all of it is
        finite), the same on every rank."""
        dev = grads[0].device
        acc = torch.zeros(2, dtype=torch.float32, device=dev)
        for g in grads:
            acc[0] += torch.sum(g.float() ** 2)
            acc[1] += (~torch.isfinite(g)).any().float()
        all_reduce(self.mesh, (FSDP,), acc)
        return torch.sqrt(acc[0]), bool(acc[1] == 0)


class _GatherData(torch.autograd.Function):
    """This rank's ``[b, t]`` block -> the whole ``[B, T]`` (rows over
    dp/fsdp, columns over sp) on every rank; the backward takes this
    rank's block of the gradient (every rank computes the same loss on the
    whole tensor)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return unshard_batch(mesh, all_gather(mesh, DATA_AXES, x.contiguous()))

    @staticmethod
    def backward(ctx, g):
        return g[batch_slices(ctx.mesh, g.shape)].contiguous(), None


def gather_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``_GatherData``; a no-op on a mesh of one."""
    if mesh.size(*DATA_AXES) == 1:
        return x
    return _GatherData.apply(x, mesh)
