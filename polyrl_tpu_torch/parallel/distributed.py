"""Multi-process bring-up and the node-aware mesh.

Counterpart of ``polyrl_tpu/parallel/distributed.py``: where the JAX
package starts ``jax.distributed`` from the ``JAX_*`` variables, this
starts a ``torch.distributed`` world from the torch launcher's
(``torchrun`` sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``) or from explicit arguments, so the same entry
point runs under any launcher. One process drives one device,
``cuda:LOCAL_RANK``.

The backend is ``nccl`` unless the caller names ``gloo``: the CPU tests
name it, and so does a world whose ranks share one card (NCCL refuses two
ranks on one device). There is no silent switch, and only an explicit
``device="cpu"`` (with ``gloo``) runs on the CPU.

Mesh layout (the scaling-book recipe): the outermost axis is the slowest
link, so ``make_hybrid_mesh`` puts ``dp`` across nodes and keeps fsdp/sp
inside a node, where neighbouring ranks share NVLink.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from polyrl_tpu_torch.device import resolve_device
from polyrl_tpu_torch.parallel import mesh as meshlib

log = logging.getLogger(__name__)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, local_rank: int | None = None,
               backend: str | None = None, device: str = "cuda",
               timeout_s: float = 600.0) -> torch.device:
    """Join the world and return this rank's device. A no-op (returning
    ``resolve_device(device)``) when single-process (world size 1 or
    nothing configured) or when the world is already up. Arguments
    default to the launcher's environment; ``init_method`` to
    ``tcp://MASTER_ADDR:MASTER_PORT``."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if rank is None:
        rank = int(os.environ.get("RANK", "0") or 0)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)) or 0)
    dev = torch.device(device)
    if dev.type == "cuda" and world_size > 1:
        dev = torch.device("cuda", local_rank)
        resolve_device(dev)  # raises without a card
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    if world_size <= 1 or dist.is_initialized():
        if world_size <= 1:
            log.info("single-process run; torch.distributed not initialized")
        return dev
    backend = backend or "nccl"
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"device='cpu' needs backend='gloo', not {backend!r}")
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT")
        if not port:
            raise ValueError("a multi-process world needs MASTER_PORT (or "
                             "init_method)")
        init_method = f"tcp://{addr}:{port}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    log.info("torch.distributed up: rank %d/%d (%s) on %s", rank, world_size,
             backend, dev)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_hybrid_mesh(nodes: int | None = None,
                     config: meshlib.MeshConfig | None = None,
                     device: torch.device | str | None = None) -> meshlib.Mesh:
    """The mesh with ``dp`` outermost across ``nodes`` (default: the world
    over ``LOCAL_WORLD_SIZE`` ranks a node): each node holds whole
    fsdp/sp groups, ``dp`` replicas span the nodes. The flat mesh on one
    node."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if nodes is None:
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)) or world)
        nodes = max(1, world // max(per_node, 1))
    cfg = config or meshlib.MeshConfig()
    if nodes <= 1:
        return meshlib.make_mesh(cfg, device)
    dims = cfg.resolve(world // nodes)
    if cfg.dp == -1:
        raise ValueError("make_hybrid_mesh: dp is the node axis, give it a size")
    # dp is the outermost axis: nodes x (dp within a node) replicas, each
    # node's ranks contiguous, so the inner axes never leave a node
    full = meshlib.MeshConfig(dp=dims[0] * nodes, fsdp=dims[1], tp=dims[2],
                              sp=dims[3], ep=dims[4], pp=dims[5])
    return meshlib.make_mesh(full, device)
