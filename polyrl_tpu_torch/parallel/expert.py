"""Expert parallelism over the mesh's ``ep`` axis, for the trainers'
forward and backward.

The JAX package names ``ep`` in the stacked experts' specs (``we_gate``,
``we_up`` ``P(None, EP, FSDP, TP)``, ``we_down`` ``P(None, EP, TP,
FSDP)``, the router ``P(None, FSDP, None)``, ``polyrl_tpu/models/
decoder.py``) and lets GSPMD derive the rest. Here the trainer issues it
itself over ``mesh.group(EP)``, with the semantics of that program:

- tokens are replicated over ``ep`` (it is no batch axis); the router, the
  softmax over all ``E`` experts, the top-k and the capacity positions run
  whole on every ep rank, so capacity and drops are the one-rank ones;
- each rank holds ``E/ep`` experts (``ep_dim``: dimension 1 of a stacked
  ``[L, E, ...]`` leaf, cut by ``mesh.block``), and only the dispatch to
  them, their products and their combine run locally: the rank's output
  is a partial sum of the whole routed block's;
- the block sits between the Megatron pair over ``ep``
  (``tensor.copy_to``/``reduce_from``): ``copy`` on entry
  (identity forward, the backward sums the partial cotangents over ep) and
  ``reduce`` on exit (sum forward, identity backward), so the input's
  gradient is whole on every rank;
- the replicated router holds only this rank's experts' share of its
  gradient, so it passes through ``copy`` as well (``shared``): its
  backward sums the shares over ep. Under tp as well, the router meets
  this rank's split expert widths, and ``tensor.copy_shared`` sums it over
  tp too.

Every other leaf of a layer is replicated over ep and computed the same on
every ep rank (no sum); the expert blocks' gradients are this rank's.
"""

from __future__ import annotations

import torch

from polyrl_tpu_torch.parallel.mesh import EP, Mesh
from polyrl_tpu_torch.parallel.tensor import copy_to, reduce_from

EXPERT_KEYS = ("we_gate", "we_up", "we_down")


def ep_dim(name: str, shape) -> int | None:
    """The dimension of the whole leaf ``name`` that ep splits: 1 (the
    experts) of a stacked expert leaf ``layers.we_*`` (and of its int8
    ``q`` and ``scale``), None for every other leaf."""
    parts = name.split(".")
    if parts[0] == "layers" and len(parts) > 1 and parts[1] in EXPERT_KEYS:
        return 1
    return None


class ExpertParallel:
    """The ep seam of ``decoder._moe_mlp`` on ``mesh``: this rank's
    experts are ``[first, first + count)`` of the ``E``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.shape[EP]
        self.rank = mesh.coords[EP]

    def experts(self, num_experts: int) -> tuple[int, int]:
        """(first, count) of this rank's experts."""
        if num_experts % self.size:
            raise ValueError(f"ep={self.size} must divide num_experts "
                             f"({num_experts})")
        count = num_experts // self.size
        return self.rank * count, count

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(self.mesh, EP, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(self.mesh, EP, x)

    def shared(self, lp: dict) -> dict:
        """One layer's weights with the router through ``copy``."""
        if "router" not in lp:
            return lp
        return {**lp, "router": self.copy(lp["router"])}


def mesh_ep(mesh) -> ExpertParallel | None:
    """The decoder's ep seam on a mesh with ep above 1 (else None)."""
    if mesh is None or mesh.shape[EP] == 1:
        return None
    return ExpertParallel(mesh)
