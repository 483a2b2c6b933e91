"""Parallelism: process meshes, the FSDP glue, the rank-0 control plane
and sequence-parallel attention.

Counterpart of ``polyrl_tpu/parallel/``: ``mesh`` (axes, ``MeshConfig``,
the collectives, ``shard_batch``/``shard_params``), ``distributed``
(``initialize`` from the torch launcher, ``make_hybrid_mesh``),
``multihost`` (rank 0's broadcasts, ``NullRollout``), ``sequence``
(Ulysses and ring attention), ``tensor`` (the ``tp`` axis: Megatron's
pair of autograd functions, vocab-parallel embedding and logprobs, the
leaves' tp blocks), ``expert`` (the ``ep`` axis: a MoE layer's expert
blocks and the pair of autograd functions over ep), ``pipeline`` (the
GPipe schedule over ``pp``) and ``fsdp`` (trained leaves sharded one
layer at a time, with the per-layer gather/reduce-scatter autograd and
the global-norm optimizer step). The JAX package's ``compat.py`` is a
``shard_map`` version shim and has no counterpart here.
"""

from .mesh import (AXES, BATCH_SPEC, DP, EP, FSDP, PP, SP, TP, MeshConfig,
                   make_mesh)
from .sequence import (
    make_ring_attention,
    make_sp_attention,
    make_ulysses_attention,
)

__all__ = [
    "AXES", "BATCH_SPEC", "DP", "EP", "FSDP", "PP", "SP", "TP", "MeshConfig",
    "make_mesh",
    "make_ring_attention", "make_sp_attention", "make_ulysses_attention",
]
