"""Process meshes, named sharding axes and the collectives over them.

Counterpart of ``polyrl_tpu/parallel/mesh.py``. The JAX package lays its
devices out as one ``jax.sharding.Mesh`` with six named axes and lets
GSPMD insert the collectives; here every process owns one device, the
processes of a ``torch.distributed`` world are laid out row-major over the
same six axes, and the trainer issues the collectives itself over one
process group per axis (and per combination it reduces over):

- ``dp``    data parallel (batch rows; parameters replicated)
- ``fsdp``  ZeRO-style parameter sharding (combines with dp for the batch)
- ``tp``    tensor parallel (not ported yet: ROADMAP A' 9)
- ``sp``    sequence parallel (Ulysses all-to-all or ring attention,
            ``parallel/sequence.py``)
- ``ep``    expert parallel (not ported yet)
- ``pp``    pipeline parallel (not ported yet)

Batches split their rows over (dp, fsdp) and their columns over sp
(``shard_batch``); trained parameters and their AdamW moments split over
fsdp, each leaf flattened and padded to a multiple of the axis
(``shard_params``, ``gather_params``; the autograd glue is
``parallel/fsdp.py``).

Collectives move bytes: a tensor is viewed as ``uint8`` for the movement
collectives (gather, all-to-all, broadcast, ring exchange), so any dtype
rides any backend; a reduce-scatter is an all-to-all and a local f32 sum,
an all-reduce runs in f32. On the ``gloo`` backend a
CUDA tensor is staged through host memory around each collective (gloo's
own CUDA path copies to the host as well, and does not take every
collective); ``nccl`` takes device tensors as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

DP, FSDP, TP, SP, EP, PP = "dp", "fsdp", "tp", "sp", "ep", "pp"
AXES = (DP, FSDP, TP, SP, EP, PP)
# batch rows shard over these axes, columns over sp (the JAX BATCH_SPEC,
# P((dp, fsdp), sp))
BATCH_AXES = (DP, FSDP)
BATCH_SPEC = (BATCH_AXES, SP)
# the ranks of one batch row group's columns and of every row group: the
# axes a per-token quantity is gathered over
DATA_AXES = (DP, FSDP, SP)
# ranks that hold the same parameter shard: their gradients are summed
REPLICA_AXES = (DP, SP)
_GROUP_AXES = ((DP,), (FSDP,), (SP,), BATCH_AXES, REPLICA_AXES, DATA_AXES)
_NOT_PORTED = "is not ported yet (ROADMAP A' 9)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = -1  # -1: absorb remaining devices
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int, int]:
        dims = [self.dp, self.fsdp, self.tp, self.sp, self.ep, self.pp]
        fixed = 1
        for d in dims:
            if d != -1:
                fixed *= d
        if n_devices % fixed != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
        free = n_devices // fixed
        dims = [free if d == -1 else d for d in dims]
        if int(np.prod(dims)) != n_devices:
            raise ValueError(f"mesh {dims} != {n_devices} devices (use one -1 axis)")
        return tuple(dims)


def refuse_unported(shape: dict) -> None:
    """``tp``, ``ep`` and ``pp`` above 1 raise ``NotImplementedError``."""
    for axis in (TP, EP, PP):
        if shape.get(axis, 1) > 1:
            raise NotImplementedError(f"parallel.{axis}={shape[axis]} > 1 "
                                      f"{_NOT_PORTED}")


class Mesh:
    """This process's place in a world laid out row-major over ``AXES``.

    ``shape`` maps each axis to its size (``mesh.shape.get("sp", 1)``),
    ``coords`` each axis to this rank's coordinate; ``group(*axes)`` is
    the process group of the ranks that differ only along ``axes`` (None
    where that group is this rank alone), ``index(*axes)`` this rank's
    place in it. ``device`` is the device its tensors live on and
    ``backend`` the world's (``gloo`` stages CUDA tensors through the
    host). A mesh made without a world (``make_groups=False``) describes
    a rank's slices and issues no collective."""

    def __init__(self, dims: Sequence[int], rank: int = 0,
                 device: torch.device | str = "cpu",
                 backend: str | None = None, make_groups: bool = True):
        self.dims = tuple(int(d) for d in dims)
        if len(self.dims) != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes {AXES}, got {dims}")
        self.shape = dict(zip(AXES, self.dims))
        self.world = math.prod(self.dims)
        self.rank = int(rank)
        self.coords = dict(zip(AXES, (int(c) for c in
                                      np.unravel_index(self.rank, self.dims))))
        self.device = torch.device(device)
        self.backend = backend
        self._groups: dict[tuple, Any] = {}
        if make_groups and self.world > 1:
            self._make_groups()

    def _make_groups(self) -> None:
        """One ``new_group`` per partition of the world along each axis set
        of ``_GROUP_AXES``; every rank creates every group, in one order,
        as ``new_group`` requires."""
        ranks = np.arange(self.world).reshape(self.dims)
        for axes in _GROUP_AXES:
            if self.size(*axes) == 1 or axes in self._groups:
                continue
            keep = [AXES.index(a) for a in axes]
            rest = [i for i in range(len(AXES)) if i not in keep]
            # move the group's axes last: each row is one group, its ranks
            # in row-major order over ``axes``
            rows = ranks.transpose(rest + keep).reshape(-1, self.size(*axes))
            mine = None
            for row in rows:
                if self.size(*axes) == self.world:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    mine = g
            self._groups[axes] = mine

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (its rank in
        ``group(*axes)``)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, *axes: str):
        if self.size(*axes) == 1:
            return None
        if tuple(axes) not in self._groups:
            raise KeyError(f"no process group for axes {axes}")
        return self._groups[tuple(axes)]

    def group_ranks(self, *axes: str) -> list[int]:
        """The global ranks of ``group(*axes)``, in group order."""
        ranks = np.arange(self.world).reshape(self.dims)
        idx = tuple(slice(None) if a in axes else self.coords[a] for a in AXES)
        sub = ranks[idx]
        order = [a for a in AXES if a in axes]
        perm = [order.index(a) for a in axes]
        return [int(r) for r in np.transpose(sub, perm).reshape(-1)]

    @property
    def stages_on_host(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(config: MeshConfig | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over the initialized world (one process, without one).

    Axis order is (dp, fsdp, tp, sp, ep, pp), as in the JAX package: the
    innermost axes (the latency-critical ones) get neighbouring ranks,
    which one launcher places on one node. ``tp``, ``ep`` and ``pp`` above
    1 raise."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else None
    dims = (config or MeshConfig()).resolve(world)
    refuse_unported(dict(zip(AXES, dims)))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    return Mesh(dims, rank, device, backend)


def single_device_mesh(device: torch.device | str = "cpu") -> Mesh:
    return Mesh((1,) * len(AXES), 0, device)


# -- collectives -------------------------------------------------------------


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _staged(mesh: Mesh, out: torch.Tensor, inp: torch.Tensor, fn):
    """Run ``fn(out, inp)``, through host copies where the backend takes
    no device tensors."""
    if mesh.stages_on_host and (out.is_cuda or inp.is_cuda):
        o, i = out.cpu(), inp.cpu()
        fn(o, i)
        out.copy_(o)
    else:
        fn(out, inp)
    return out


_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(mesh: Mesh, axes: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` over ``group(*axes)`` in group
    order (``x`` itself, unsqueezed, on a group of one)."""
    n = mesh.size(*axes)
    if n == 1:
        return x.unsqueeze(0)
    src = _bytes(x)
    out = torch.empty(n * src.numel(), dtype=torch.uint8, device=x.device)
    g = mesh.group(*axes)
    _staged(mesh, out, src, lambda o, i: _all_gather_single(o, i, group=g))
    return out.view(x.dtype).view(n, *x.shape)


def reduce_scatter(mesh: Mesh, axes: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    """Sum of every rank's ``x`` (dim 0 a multiple of the group size),
    this rank's 1/n block of it: an all-to-all of the blocks in ``x``'s
    dtype, then their sum in f32 (in group order, the same rounding on
    every backend), cast back."""
    n = mesh.size(*axes)
    if n == 1:
        return x
    blocks = all_to_all(mesh, axes, x.reshape(n, x.shape[0] // n, *x.shape[1:]))
    return blocks.float().sum(0).to(x.dtype)


def all_reduce(mesh: Mesh, axes: Sequence[str], x: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the group, in f32, written back into ``x`` (returned)."""
    if mesh.size(*axes) == 1:
        return x
    buf = x.float().contiguous()
    g = mesh.group(*axes)
    _staged(mesh, buf, buf, lambda o, _i: dist.all_reduce(o, op=op, group=g))
    with torch.no_grad():
        x.copy_(buf)
    return x


def all_to_all(mesh: Mesh, axes: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    """Block i of dim 0 (``x.shape[0] == n``) goes to group rank i; block
    j of the result came from group rank j."""
    n = mesh.size(*axes)
    if n == 1:
        return x
    src = _bytes(x)
    out = torch.empty_like(src)
    g = mesh.group(*axes)
    _staged(mesh, out, src, lambda o, i: dist.all_to_all_single(o, i, group=g))
    return out.view(x.dtype).view(x.shape)


def rotate(mesh: Mesh, axis: str, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """The ring exchange: ``x`` goes to the rank ``shift`` places on along
    ``axis``; returns what the rank ``shift`` places back sent."""
    n = mesh.shape[axis]
    if n == 1 or shift % n == 0:
        return x
    ranks = mesh.group_ranks(axis)
    i = mesh.coords[axis]
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    send = _bytes(x)
    recv = torch.empty_like(send)

    def exchange(o, s):
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, s, dst),
                                           dist.P2POp(dist.irecv, o, src)]):
            req.wait()

    _staged(mesh, recv, send, exchange)
    return recv.view(x.dtype).view(x.shape)


def broadcast_(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """World broadcast from global rank ``src``, in place."""
    if mesh.world == 1:
        return x
    buf = _bytes(x)
    _staged(mesh, buf, buf, lambda o, _i: dist.broadcast(o, src))
    if buf.data_ptr() != x.data_ptr():
        with torch.no_grad():
            x.copy_(buf.view(x.dtype).view(x.shape))
    return x


# -- batches ---------------------------------------------------------------


def _block(n: int, parts: int, idx: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not split over {parts} ranks")
    step = n // parts
    return slice(idx * step, (idx + 1) * step)


def batch_slices(mesh: Mesh, shape: Sequence[int]) -> tuple:
    """This rank's index into a ``[B, T, ...]`` array: rows over (dp,
    fsdp), columns over sp (rank-1 arrays split their rows only)."""
    if len(shape) == 0:
        return ()
    rows = _block(shape[0], mesh.size(*BATCH_AXES), mesh.index(*BATCH_AXES),
                  "a batch")
    if len(shape) == 1:
        return (rows,)
    cols = _block(shape[1], mesh.shape[SP], mesh.coords[SP], "a sequence")
    return (rows, cols)


def shard_batch(mesh: Mesh, tree):
    """This rank's slice of a dict of ``[B, ...]`` tensors (the JAX
    ``shard_batch``: rows over (dp, fsdp), columns over sp, rank-1 leaves
    over the batch only, scalars whole), each made contiguous."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        tree = torch.as_tensor(np.asarray(tree))
    return tree[batch_slices(mesh, tree.shape)].contiguous()


def unshard_batch(mesh: Mesh, blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of ``shard_batch`` for ``all_gather`` over ``DATA_AXES`` of
    ``[b, t]`` blocks: ``[n, b, t]`` (group order: dp, fsdp, sp) ->
    ``[B, T]``."""
    rows, sp = mesh.size(*BATCH_AXES), mesh.shape[SP]
    b, t = blocks.shape[1:3]
    full = blocks.reshape(rows, sp, b, t, *blocks.shape[3:])
    return full.transpose(1, 2).reshape(rows * b, sp * t, *blocks.shape[3:])


# -- parameters --------------------------------------------------------------


def shard_numel(numel: int, parts: int) -> int:
    return -(-numel // parts)


def shard_tensor(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's 1/fsdp of ``t`` flattened and zero-padded to a multiple
    of fsdp (a new tensor; ``t`` itself on an fsdp axis of 1)."""
    n = mesh.shape[FSDP]
    if n == 1:
        return t
    per = shard_numel(t.numel(), n)
    i = mesh.coords[FSDP]
    flat = t.detach().reshape(-1)
    out = torch.zeros(per, dtype=t.dtype, device=t.device)
    lo, hi = min(i * per, flat.numel()), min((i + 1) * per, flat.numel())
    out[: hi - lo] = flat[lo:hi]
    return out


def gather_tensor(mesh: Mesh, shard: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of ``shard_tensor``: the whole leaf of ``shape`` (no
    autograd)."""
    if mesh.shape[FSDP] == 1:
        return shard
    return all_gather(mesh, (FSDP,), shard).reshape(-1)[: math.prod(shape)].view(
        tuple(shape))


def _check_specs(specs) -> None:
    """A spec names the axes of each dimension (a tuple per leaf, or a
    nested dict of them); only ``fsdp`` is ported."""
    if specs is None:
        return
    if isinstance(specs, dict):
        for v in specs.values():
            _check_specs(v)
        return
    for part in specs:
        names = part if isinstance(part, (tuple, list)) else (part,)
        for a in names:
            if a not in (None, FSDP):
                raise NotImplementedError(
                    f"a parameter spec over {a!r} {_NOT_PORTED}; only fsdp "
                    f"shards parameters")


def shard_params(mesh: Mesh, params, specs=None):
    """Every tensor of a (nested dict) tree as this rank's fsdp shard
    (``shard_tensor``). ``specs``, when given, may name only ``fsdp``:
    a ``tp`` (or other) spec raises."""
    _check_specs(specs)
    if isinstance(params, dict):
        return {k: shard_params(mesh, v) for k, v in params.items()}
    return shard_tensor(mesh, params)


def gather_params(mesh: Mesh, shards, template):
    """Inverse of ``shard_params``: the whole tree, each leaf shaped like
    ``template``'s (a tree of tensors or of shapes)."""
    if isinstance(shards, dict):
        return {k: gather_params(mesh, v, template[k]) for k, v in shards.items()}
    shape = template.shape if isinstance(template, torch.Tensor) else template
    return gather_tensor(mesh, shards, shape)

