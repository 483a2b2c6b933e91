"""Parallelism: process meshes, the FSDP glue, the rank-0 control plane
and sequence-parallel attention.

Counterpart of ``polyrl_tpu/parallel/``: ``mesh`` (axes, ``MeshConfig``,
the collectives, ``shard_batch``/``shard_params``), ``distributed``
(``initialize`` from the torch launcher, ``make_hybrid_mesh``),
``multihost`` (rank 0's broadcasts, ``NullRollout``), ``sequence``
(Ulysses and ring attention) and ``fsdp`` (sharded trained leaves with
the gather/reduce-scatter autograd and the global-norm optimizer step).
The JAX package's ``compat.py`` is a ``shard_map`` version shim and has
no counterpart here; its ``pipeline.py`` (pp) is not ported yet (ROADMAP
A' 9).
"""

from .mesh import AXES, BATCH_SPEC, DP, FSDP, SP, TP, MeshConfig, make_mesh
from .sequence import (
    make_ring_attention,
    make_sp_attention,
    make_ulysses_attention,
)

__all__ = [
    "AXES", "BATCH_SPEC", "DP", "FSDP", "SP", "TP", "MeshConfig", "make_mesh",
    "make_ring_attention", "make_sp_attention", "make_ulysses_attention",
]
