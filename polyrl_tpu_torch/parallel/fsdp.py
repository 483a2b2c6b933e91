"""FSDP (and the tp blocks under it) for the port's trainers: trained
leaves sharded over the ``fsdp`` axis one layer at a time, each layer
gathered where the decoder's layer loop reaches it and its gradient
reduce-scattered as its backward ends.

The actor and the critic hold a tree of tensors and their own AdamW, not
an ``nn.Module``, so the sharding is written here by hand on the mesh's
groups (no ``fully_shard``):

- on a ``tp`` axis above 1 each trained leaf is first cut to this rank's
  tp block (``tensor.tp_dim``/``tp_slice``); those blocks are what fsdp
  shards and gathers;
- the stacked ``[L, ...]`` leaves under ``layers`` are sharded a layer at
  a time: layer ``l``'s slices of every such leaf, flattened and
  concatenated, are zero-padded to a multiple of fsdp and split, and this
  rank keeps its 1/fsdp (one tensor a layer, with its AdamW moments; the
  padding stays 0: zero gradient, zero update). The forward reads them
  through a per-layer source (``params["layers"]``, see
  ``decoder.layer_params``): the layer body gathers its layer with one
  all-gather (``_GatherLayer``), inside the ``checkpoint`` that remat
  wraps it in, so the gathered weights are dropped after the layer and
  gathered again by its remat'd backward, whose end reduce-scatters the
  layer's gradient (summed in f32) into the shard's ``.grad``. No whole
  gradient of a layer outlives its backward, and none of the model ever
  exists. Without remat the products save their gathered weights for the
  backward, so every layer's stays alive through the pass: the peak of
  the whole-tree route below;
- the other trained leaves (the embedding, which is the tied head,
  ``final_norm``, ``lm_head``, the critic's ``value_head``) are small
  beside the layers and are held whole for an optimizer step, as the
  whole-tree route holds everything: each flattened and split over fsdp,
  gathered whole at the step's first forward (``full``) and kept until
  the step (or the trainer's ``release`` after a push), their whole
  gradients reduce-scattered at the step;
- at the optimizer step every shard's gradient is summed over the
  replicas (dp and sp, ``REPLICA_AXES``). Each rank's backward carries
  its rows' and columns' share of the GLOBAL micro's loss (the loss is
  computed on the gathered per-token values), so the sum is the
  one-process gradient;
- the clip norm is global: the squares are summed in f64, so that the f32
  norm does not depend on how the elements fall over the ranks, over
  fsdp, and over tp for the tp-split elements only (a replicated leaf is
  the same on every tp rank); a non-finite flag goes with them, so the
  guard's skip decision is the same on every rank.

``PER_LAYER = False`` gives the whole-tree route of the first port of
this module: every trained leaf flattened and split, the whole tree
gathered at the first forward of a step and its whole gradients held to
the step. It stays as the tests' oracle: at one micro a step the two
routes give the same parameters bit for bit (the same per-rank
gradients, reduce-scattered in the same f32 order).

With fsdp 1 the shards are this rank's (tp) leaves themselves and
nothing is gathered.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from polyrl_tpu_torch.models.quant import WRAPPERS
from polyrl_tpu_torch.parallel import tensor
from polyrl_tpu_torch.parallel.mesh import (DATA_AXES, FSDP, REPLICA_AXES, TP,
                                            Mesh, all_gather, all_reduce,
                                            batch_slices, gather_tensor,
                                            reduce_scatter, shard_numel,
                                            shard_tensor, unshard_batch)

PER_LAYER = True  # False: the whole-tree route (the tests' oracle)


class _GatherLayer(torch.autograd.Function):
    """One layer's flat shard -> the layer's whole flat buffer (an
    all-gather over fsdp, the padding cut); the backward reduce-scatters
    the buffer's gradient (summed in f32) into the shard's."""

    @staticmethod
    def forward(ctx, shard, mesh, numel):
        ctx.mesh, ctx.numel = mesh, numel
        return all_gather(mesh, (FSDP,), shard.detach()).reshape(-1)[:numel]

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.shape[FSDP]
        flat = F.pad(g.reshape(-1), (0, shard_numel(ctx.numel, n) * n - ctx.numel))
        return reduce_scatter(ctx.mesh, (FSDP,), flat), None, None


class _LayerRef:
    """``decoder.layer_params``' handle of layer ``i``: ``gather()`` is
    the layer's weight dict (its trained leaves gathered, the frozen ones
    sliced)."""

    def __init__(self, owner: "ShardedLeaves", template: dict, i: int):
        self.owner, self.template, self.i = owner, template, i

    def gather(self) -> dict:
        trained = self.owner.gather_layer(self.i)
        return _layer_tree(self.template, trained, self.i, "layers.")


class _LayerSource:
    """``params["layers"]`` of a forward on per-layer shards."""

    def __init__(self, owner: "ShardedLeaves", template: dict):
        self.owner, self.template = owner, template

    def layer(self, i: int) -> _LayerRef:
        return _LayerRef(self.owner, self.template, i)


def _layer_tree(node, trained: dict, i: int, prefix: str):
    """Layer ``i`` of the ``layers`` subtree ``node``: the leaves named in
    ``trained`` from it, every other leaf sliced (wrappers rebuilt)."""
    if isinstance(node, dict):
        return {k: _layer_tree(v, trained, i, f"{prefix}{k}.")
                for k, v in node.items()}
    if isinstance(node, WRAPPERS):
        return node.rebuild({k: _layer_tree(v, trained, i, f"{prefix}{k}.")
                             for k, v in node.fields().items()})
    name = prefix[:-1]
    return trained[name] if name in trained else node[i]


class ShardedLeaves:
    """``named`` ``(name, whole tensor)`` trained leaves as this rank's
    shards. ``shards`` (``shard_names``) is the list the optimizer steps:
    one flat shard per non-layer leaf, then one per layer (fsdp > 1 and
    ``PER_LAYER``); on an fsdp axis of 1 this rank's tp blocks of the
    leaves themselves, with ``requires_grad``. ``num_layers`` says which
    ``layers.*`` leaves are stacked."""

    def __init__(self, mesh: Mesh, named: list, num_layers: int = 0):
        self.mesh = mesh
        self.names = [n for n, _ in named]
        self.shapes = [tuple(t.shape) for _, t in named]
        self.dtypes = [t.dtype for _, t in named]
        self.frozen_whole: dict[str, tuple] = {}  # a trainer's frozen leaves
        tp = mesh.shape[TP]
        self.tp_dims = [tensor.tp_dim(n, s) if tp > 1 else None
                        for n, s in zip(self.names, self.shapes)]
        local = [tensor.tp_slice(mesh, t.detach(), d)
                 for (_, t), d in zip(named, self.tp_dims)]
        self.local_shapes = [tuple(t.shape) for t in local]
        fsdp_n = mesh.shape[FSDP]
        self.layered = [j for j, (n, s) in enumerate(zip(self.names, self.shapes))
                        if PER_LAYER and fsdp_n > 1 and num_layers
                        and n.startswith("layers.") and s[0] == num_layers]
        self.rest = [j for j in range(len(named)) if j not in self.layered]
        self.num_layers = num_layers if self.layered else 0
        self.layer_sizes = [math.prod(self.local_shapes[j][1:]) for j in self.layered]
        self.layer_numel = sum(self.layer_sizes)
        if len({local[j].dtype for j in self.layered}) > 1:
            raise ValueError("per-layer shards need one dtype a layer")
        self.shards = [shard_tensor(mesh, local[j]).detach() for j in self.rest]
        # a layer's shard is what its gather differentiates into
        self.shards += [shard_tensor(mesh, torch.cat(
            [local[j][l].reshape(-1) for j in self.layered])).requires_grad_(True)
            for l in range(self.num_layers)]
        self.shard_names = ([self.names[j] for j in self.rest]
                            + [f"layers#{l}" for l in range(self.num_layers)])
        if not self.sharded:
            self.shards = [s if s.requires_grad else s.requires_grad_(True)
                           for s in self.shards]
        # per shard: (lo, hi, tp_split) element ranges, for the clip norm
        self._segments = [self._rest_segments(j) for j in self.rest]
        self._segments += [self._layer_segments()] * self.num_layers
        self._full: list[torch.Tensor] | None = None

    @property
    def sharded(self) -> bool:
        return self.mesh.shape[FSDP] > 1

    def frozen_tp_dim(self, name: str, shape) -> int | None:
        """The tp dimension of a frozen (whole) leaf: frozen leaves are
        cut to their tp blocks too, and never sharded over fsdp."""
        return tensor.tp_dim(name, shape) if self.mesh.shape[TP] > 1 else None

    def whole_frozen_shape(self, name: str) -> tuple:
        return self.frozen_whole[name]

    def _rest_segments(self, j: int) -> list:
        return [(0, None, self.tp_dims[j] is not None)]

    def _layer_segments(self) -> list:
        """This rank's part of a layer buffer, as ranges of its shard."""
        n = self.mesh.shape[FSDP]
        per = shard_numel(self.layer_numel, n)
        base = self.mesh.coords[FSDP] * per
        segs, lo = [], 0
        for j, size in zip(self.layered, self.layer_sizes):
            a, b = max(lo, base), min(lo + size, base + per)
            if a < b:
                segs.append((a - base, b - base, self.tp_dims[j] is not None))
            lo += size
        return segs

    # -- the forward's tree ---------------------------------------------------

    def full(self) -> list[torch.Tensor]:
        """The non-layer leaves' whole tp blocks (with ``requires_grad``):
        gathered at the first call after a step or a ``release`` (a
        collective over fsdp), held until the next."""
        n_rest = len(self.rest)
        if not self.sharded:
            return self.shards[:n_rest]
        if self._full is None:
            self._full = [gather_tensor(self.mesh, s.detach(),
                                        self.local_shapes[j]).requires_grad_(True)
                          for s, j in zip(self.shards[:n_rest], self.rest)]
        return self._full

    def forward_leaves(self, template_layers) -> dict:
        """``{name: tensor}`` of the trained leaves a forward reads, and
        ``layers`` -> a per-layer source when the layers are sharded by
        layer (``template_layers`` is the tree's ``layers`` subtree, whose
        frozen leaves the source slices)."""
        out = dict(zip((self.names[j] for j in self.rest), self.full()))
        if self.num_layers:
            out["layers"] = _LayerSource(self, template_layers)
        return out

    def gather_layer(self, i: int) -> dict:
        """Layer ``i``'s trained leaves ``{name: [local shape[1:]]}``
        from one all-gather of its shard (differentiable)."""
        flat = _GatherLayer.apply(self.shards[len(self.rest) + i], self.mesh,
                                  self.layer_numel)
        out, lo = {}, 0
        for j, size in zip(self.layered, self.layer_sizes):
            out[self.names[j]] = flat[lo:lo + size].view(self.local_shapes[j][1:])
            lo += size
        return out

    def release(self) -> None:
        """Drop the whole non-layer leaves (and their gradients): only the
        shards stay."""
        self._full = None

    # -- whole state ------------------------------------------------------------

    @torch.no_grad()
    def gather(self, shards: list[torch.Tensor]) -> list[torch.Tensor]:
        """Whole leaves (in ``names`` order) of any per-shard state
        (parameters, moments): collectives over fsdp and tp."""
        n_rest = len(self.rest)
        local: dict[int, torch.Tensor] = {}
        for s, j in zip(shards[:n_rest], self.rest):
            local[j] = gather_tensor(self.mesh, s.detach(), self.local_shapes[j])
        if self.num_layers:
            flats = [gather_tensor(self.mesh, s.detach(), (self.layer_numel,))
                     for s in shards[n_rest:]]
            lo = 0
            for j, size in zip(self.layered, self.layer_sizes):
                local[j] = torch.stack([f[lo:lo + size] for f in flats]).view(
                    self.local_shapes[j])
                lo += size
        return [tensor.tp_unslice(self.mesh, local[j], self.tp_dims[j])
                for j in range(len(self.names))]

    @torch.no_grad()
    def load(self, dst: list[torch.Tensor], full: list[torch.Tensor]) -> None:
        """Copy this rank's shards of whole leaves (``names`` order) into
        ``dst`` (``shards`` order); the held whole leaves are dropped."""
        local = [tensor.tp_slice(self.mesh, f.to(dst[0].device), d)
                 for f, d in zip(full, self.tp_dims)]
        n_rest = len(self.rest)
        for d, j in zip(dst[:n_rest], self.rest):
            d.copy_(shard_tensor(self.mesh, local[j]))
        for l, d in enumerate(dst[n_rest:]):
            d.copy_(shard_tensor(self.mesh, torch.cat(
                [local[j][l].reshape(-1) for j in self.layered])))
        self.release()

    # -- the step ----------------------------------------------------------------

    @torch.no_grad()
    def shard_grads(self) -> list[torch.Tensor]:
        """This rank's shard of the step's gradient (``shards`` order):
        the whole non-layer leaves' gradients reduce-scattered over fsdp,
        the layer shards' own (reduce-scattered by their backwards), every
        one summed over the replicas (dp, sp)."""
        n_rest = len(self.rest)
        if not self.sharded:
            grads = [s.grad if s.grad is not None else torch.zeros_like(s)
                     for s in self.shards]
        else:
            n = self.mesh.shape[FSDP]
            grads = []
            for s, f in zip(self.shards[:n_rest], self._full or [None] * n_rest):
                if f is None or f.grad is None:
                    grads.append(torch.zeros_like(s))
                    continue
                flat = f.grad.reshape(-1)
                flat = F.pad(flat, (0, s.numel() * n - flat.numel()))
                grads.append(reduce_scatter(self.mesh, (FSDP,), flat))
            grads += [s.grad if s.grad is not None else torch.zeros_like(s)
                      for s in self.shards[n_rest:]]
        if self.mesh.size(*REPLICA_AXES) > 1:
            grads = [all_reduce(self.mesh, REPLICA_AXES, g.clone()) for g in grads]
        return grads

    @torch.no_grad()
    def global_norm(self, grads: list[torch.Tensor]) -> tuple[torch.Tensor, bool]:
        """(the f32 norm of the whole gradient, whether all of it is
        finite), the same on every rank."""
        dev = grads[0].device
        # [tp-split squares, replicated squares, non-finite count]
        acc = torch.zeros(3, dtype=torch.float64, device=dev)
        for g, segs in zip(grads, self._segments):
            flat = g.reshape(-1)
            for lo, hi, split in segs:
                acc[0 if split else 1] += torch.sum(flat[lo:hi].double() ** 2)
            acc[2] += (~torch.isfinite(g)).any().double()
        all_reduce(self.mesh, (FSDP,), acc, dtype=torch.float64)
        split = acc[0::2].clone()
        all_reduce(self.mesh, (TP,), split, dtype=torch.float64)
        total = split[0] + acc[1]
        return torch.sqrt(total).float(), bool(split[1] == 0)


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
