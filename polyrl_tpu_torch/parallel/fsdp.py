"""FSDP (and the pp, ep and tp blocks under it) for the port's trainers:
trained leaves sharded over the ``fsdp`` axis one layer at a time, each
layer gathered where the decoder's layer loop reaches it and its gradient
reduce-scattered as its backward ends.

The actor and the critic hold a tree of tensors and their own AdamW, not
an ``nn.Module``, so the sharding is written here by hand on the mesh's
groups (no ``fully_shard``):

- each trained leaf is first cut to this rank's block (``leaf_dims``,
  ``local_block``): on a ``pp`` axis above 1 a stacked ``[L, ...]`` layer
  leaf to its stage's ``L/pp`` layers, on an ``ep`` axis a stacked expert
  leaf to its ``E/ep`` experts (``expert.ep_dim``), on a ``tp`` axis to its
  tp block (``tensor.tp_dim``); those blocks are what fsdp shards and
  gathers;
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
  one-process gradient. pp and ep ranks see the same rows: a leaf they
  do not split has its whole gradient on each of them already (the
  pipeline's and the expert block's autograd pairs sum what needs it),
  so nothing is summed over them;
- the clip norm is global: the squares are summed in f64, so that the f32
  norm does not depend on how the elements fall over the ranks, over
  fsdp, and over each of tp, ep and pp for the elements that axis splits
  only (a leaf it does not split is the same on each of its ranks, and
  is counted once); a non-finite flag goes with them, so the guard's skip
  decision is the same on every rank.

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
from polyrl_tpu_torch.parallel import expert, tensor
from polyrl_tpu_torch.parallel.mesh import (DATA_AXES, EP, FSDP, PP,
                                            REPLICA_AXES, TP, Mesh, all_gather,
                                            all_reduce, batch_slices, block,
                                            gather_tensor, reduce_scatter,
                                            shard_numel, shard_tensor, unblock,
                                            unshard_batch)

PER_LAYER = True  # False: the whole-tree route (the tests' oracle)
# the axes a leaf's block is cut over, in cutting order
SPLIT_AXES = (PP, EP, TP)


def leaf_dims(mesh: Mesh, name: str, shape, num_layers: int) -> dict:
    """{axis: dimension} of the whole leaf ``name`` that each of pp, ep
    and tp (those above 1) splits: a stacked ``[num_layers, ...]`` layer
    leaf's stage on dim 0 over pp, a stacked expert leaf's experts over
    ep (``expert.ep_dim``), its tp block (``tensor.tp_dim``)."""
    dims = {}
    if (mesh.shape[PP] > 1 and num_layers and name.startswith("layers.")
            and len(shape) and shape[0] == num_layers):
        dims[PP] = 0
    if mesh.shape[EP] > 1 and expert.ep_dim(name, shape) is not None:
        dims[EP] = expert.ep_dim(name, shape)
    if mesh.shape[TP] > 1 and tensor.tp_dim(name, shape) is not None:
        dims[TP] = tensor.tp_dim(name, shape)
    return dims


def local_block(mesh: Mesh, t: torch.Tensor, dims: dict) -> torch.Tensor:
    """This rank's block of a whole leaf (``leaf_dims``' cuts in order)."""
    for axis in SPLIT_AXES:
        t = block(mesh, t, axis, dims.get(axis))
    return t


def whole_leaf(mesh: Mesh, t: torch.Tensor, dims: dict) -> torch.Tensor:
    """Inverse of ``local_block`` (collectives over tp, ep, pp)."""
    for axis in reversed(SPLIT_AXES):
        t = unblock(mesh, t, axis, dims.get(axis))
    return t


def _mask(dims: dict) -> int:
    """The bit set of the axes a leaf is split over (``SPLIT_AXES``
    order)."""
    return sum(1 << i for i, a in enumerate(SPLIT_AXES) if a in dims)


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
    ``PER_LAYER``); on an fsdp axis of 1 this rank's blocks of the
    leaves themselves, with ``requires_grad``. ``num_layers`` says which
    ``layers.*`` leaves are stacked; on a pp axis this rank holds its
    stage's ``num_layers/pp`` of them."""

    def __init__(self, mesh: Mesh, named: list, num_layers: int = 0):
        self.mesh = mesh
        self.names = [n for n, _ in named]
        self.shapes = [tuple(t.shape) for _, t in named]
        self.dtypes = [t.dtype for _, t in named]
        self.frozen_whole: dict[str, tuple] = {}  # a trainer's frozen leaves
        self.whole_layers = num_layers
        self.dims = [leaf_dims(mesh, n, s, num_layers)
                     for n, s in zip(self.names, self.shapes)]
        local = [local_block(mesh, t.detach(), d)
                 for (_, t), d in zip(named, self.dims)]
        self.local_shapes = [tuple(t.shape) for t in local]
        fsdp_n = mesh.shape[FSDP]
        self.layered = [j for j, (n, s) in enumerate(zip(self.names, self.shapes))
                        if PER_LAYER and fsdp_n > 1 and num_layers
                        and n.startswith("layers.") and s[0] == num_layers]
        self.rest = [j for j in range(len(named)) if j not in self.layered]
        self.num_layers = num_layers // mesh.shape[PP] if self.layered else 0
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

    def frozen_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a frozen (whole) leaf: frozen leaves are
        cut to their pp, ep and tp blocks too, and never sharded over
        fsdp."""
        return local_block(self.mesh, t, leaf_dims(self.mesh, name, t.shape,
                                                   self.whole_layers))

    def frozen_whole_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Inverse of ``frozen_block`` (collectives)."""
        return whole_leaf(self.mesh, t, leaf_dims(
            self.mesh, name, self.frozen_whole[name], self.whole_layers))

    def whole_frozen_shape(self, name: str) -> tuple:
        return self.frozen_whole[name]

    def _rest_segments(self, j: int) -> list:
        return [(0, None, _mask(self.dims[j]))]

    def _layer_segments(self) -> list:
        """This rank's part of a layer buffer, as ranges of its shard."""
        n = self.mesh.shape[FSDP]
        per = shard_numel(self.layer_numel, n)
        base = self.mesh.coords[FSDP] * per
        segs, lo = [], 0
        for j, size in zip(self.layered, self.layer_sizes):
            a, b = max(lo, base), min(lo + size, base + per)
            if a < b:
                segs.append((a - base, b - base, _mask(self.dims[j])))
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
        return [whole_leaf(self.mesh, local[j], self.dims[j])
                for j in range(len(self.names))]

    @torch.no_grad()
    def load(self, dst: list[torch.Tensor], full: list[torch.Tensor]) -> None:
        """Copy this rank's shards of whole leaves (``names`` order) into
        ``dst`` (``shards`` order); the held whole leaves are dropped."""
        local = [local_block(self.mesh, f.to(dst[0].device), d)
                 for f, d in zip(full, self.dims)]
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
        full = (1 << len(SPLIT_AXES)) - 1
        # squares by the bit set of the axes that split them (slot
        # ``mask``), then the non-finite count (summed over every axis)
        acc = torch.zeros(full + 2, dtype=torch.float64, device=dev)
        for g, segs in zip(grads, self._segments):
            flat = g.reshape(-1)
            for lo, hi, mask in segs:
                acc[mask] += torch.sum(flat[lo:hi].double() ** 2)
            acc[full + 1] += (~torch.isfinite(g)).any().double()
        all_reduce(self.mesh, (FSDP,), acc, dtype=torch.float64)
        for i, axis in enumerate(SPLIT_AXES):
            if self.mesh.shape[axis] == 1:
                continue
            slots = [m for m in range(full + 1) if m >> i & 1] + [full + 1]
            part = acc[slots].clone()
            all_reduce(self.mesh, (axis,), part, dtype=torch.float64)
            acc[slots] = part
        total = acc[:full + 1].sum()
        return torch.sqrt(total).float(), bool(acc[full + 1] == 0)


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
