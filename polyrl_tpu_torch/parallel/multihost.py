"""Multi-process SPMD helpers for the stream trainer.

Counterpart of ``polyrl_tpu/parallel/multihost.py``. In place of the
reference's Ray single controller scattering work to N ranks, every rank
runs the SAME ``fit`` loop; the CONTROL plane (the rollout and its
manager, reward scoring, the weight fabric, logging) runs on rank 0 only,
and the assembled batches are broadcast from it to the other ranks.

The broadcasts ride ``torch.distributed.broadcast`` over the world group:
on ``gloo`` through host tensors, on ``nccl`` through a device buffer.
Payloads are pickled, except a batch's arrays, which ride one raw-bytes
round (``broadcast_batch``).
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from polyrl_tpu_torch.data.batch import TensorBatch


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return process_index() == 0


def _wire_device() -> torch.device:
    """Where a broadcast buffer lives: the host on gloo, this rank's card
    on nccl (which takes no host tensors)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_bytes(buf: np.ndarray | None, size: int) -> np.ndarray:
    """Rank 0's ``size`` bytes to every rank (``buf`` ignored elsewhere)."""
    dev = _wire_device()
    if is_main():
        t = torch.from_numpy(buf).to(dev) if size else torch.empty(0, dtype=torch.uint8)
    else:
        t = torch.empty(size, dtype=torch.uint8, device=dev)
    if size:
        dist.broadcast(t, 0)
    return buf if is_main() else t.cpu().numpy()


def broadcast_obj(obj: Any = None) -> Any:
    """Broadcast a picklable object from rank 0 to every rank (the others
    pass anything, ignored). Two rounds: the size, then the payload."""
    if process_count() == 1:
        return obj
    dev = _wire_device()
    if is_main():
        payload = np.frombuffer(bytearray(pickle.dumps(obj)), np.uint8)
        size = torch.tensor([payload.size], dtype=torch.int64, device=dev)
    else:
        payload = None
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, 0)
    raw = _broadcast_bytes(payload, int(size.item()))
    return obj if is_main() else pickle.loads(raw.tobytes())


def broadcast_batch(tagged: tuple[str, Any] | None = None) -> tuple[str, Any]:
    """The per-ibatch data plane: a ``("batch", TensorBatch)`` message
    ships as a small pickled header (tag, array specs, non-tensors and
    meta) plus ONE raw-bytes round carrying every array, which never
    passes through pickle; the receivers rebuild the arrays as views into
    the received buffer. Any other tag (``("end", None)``, ``("error",
    message)``) rides the header alone."""
    if process_count() == 1:
        return tagged
    specs = None
    arrays: list[np.ndarray] = []
    if is_main():
        kind, payload = tagged
        if kind == "batch" and isinstance(payload, TensorBatch):
            specs = []
            for k, v in payload.tensors.items():
                if isinstance(v, torch.Tensor):
                    v = v.detach().cpu().numpy()
                arr = np.ascontiguousarray(np.asarray(v))
                specs.append((k, arr.dtype, arr.shape, arr.nbytes))
                arrays.append(arr)
            total = sum(s[3] for s in specs)
            broadcast_obj((kind, None, (specs, total, payload.non_tensors,
                                        payload.meta_info)))
        else:
            broadcast_obj((kind, payload, None))
            return tagged
    else:
        kind, payload, extra = broadcast_obj(None)
        if extra is None:
            return kind, payload
        specs, total, non_tensors, meta_info = extra
    buf = None
    if is_main():
        # np.empty: every byte is written below
        buf = np.empty(total, np.uint8)
        off = 0
        for arr in arrays:
            buf[off: off + arr.nbytes] = arr.view(np.uint8).reshape(-1)
            off += arr.nbytes
    raw = _broadcast_bytes(buf, total)
    if is_main():
        return tagged
    tensors = {}
    off = 0
    for k, dtype, shape, nbytes in specs:
        tensors[k] = raw[off: off + nbytes].view(dtype).reshape(shape)
        off += nbytes
    return "batch", TensorBatch(tensors=tensors, non_tensors=non_tensors,
                                meta_info=meta_info)


def broadcast_state(flat: dict[str, torch.Tensor] | None,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """A flat ``{name: tensor}`` dict from rank 0 to every rank, tensor by
    tensor (a header of names, dtypes and shapes first), each landing on
    ``device``: how a checkpoint that rank 0 read reaches the others."""
    if process_count() == 1:
        return flat
    header = broadcast_obj([(k, v.dtype, tuple(v.shape)) for k, v in flat.items()]
                           if is_main() else None)
    dev = _wire_device()
    out = {}
    for name, dtype, shape in header:
        if is_main():
            t = flat[name].detach().to(dev).contiguous()
        else:
            t = torch.empty(shape, dtype=dtype, device=dev)
        if t.numel():
            dist.broadcast(t.reshape(-1).view(torch.uint8), 0)
        out[name] = t.to(device)
    return out


class NullRollout:
    """The rollout of every rank but 0: the control plane (manager
    streaming, weight pushes, balancer metrics) lives on rank 0, the
    others receive their batches through ``broadcast_batch`` and never
    open a manager or fabric connection of their own."""

    def __init__(self, pad_token_id: int = 0):
        self.pad_token_id = pad_token_id
        self.last_gen_throughput = 0.0
        self.dropped_groups = 0

    def update_weights(self, params: Any, version: int | None = None) -> int:
        return 0

    def update_metrics(self, **stats) -> dict:
        return {}
