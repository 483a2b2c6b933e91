"""TensorBatch: the batch container the trainer passes between phases.

Counterpart of ``polyrl_tpu/data/batch.py`` without the pytree
registration (PyTorch runs eagerly; nothing is traced):

- ``tensors``: dict of numpy arrays or torch tensors sharing batch dim 0
- ``non_tensors``: dict of ``np.ndarray(dtype=object)`` for ragged or
  Python data (prompt strings, ground truths, data sources)
- ``meta_info``: dict of scalars riding along with the batch

with the verbs the trainer uses: select / pop / union / concat / split /
chunk / index / repeat / rename / to_numpy.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch


def _batch_size_of(tensors: dict[str, Any], non_tensors: dict[str, Any]) -> int | None:
    for v in tensors.values():
        return int(v.shape[0])
    for v in non_tensors.values():
        return int(v.shape[0])
    return None


@dataclass
class TensorBatch:
    tensors: dict[str, Any] = field(default_factory=dict)
    non_tensors: dict[str, Any] = field(default_factory=dict)
    meta_info: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.check_consistency()

    def check_consistency(self) -> None:
        bs = _batch_size_of(self.tensors, self.non_tensors)
        if bs is None:
            return
        for k, v in self.tensors.items():
            if int(v.shape[0]) != bs:
                raise ValueError(f"tensor {k!r} batch dim {v.shape[0]} != {bs}")
        for k in list(self.non_tensors):
            v = self.non_tensors[k]
            if not isinstance(v, np.ndarray):
                v = np.array(v, dtype=object)
                self.non_tensors[k] = v
            if int(v.shape[0]) != bs:
                raise ValueError(f"non_tensor {k!r} batch dim {v.shape[0]} != {bs}")

    def __len__(self) -> int:
        bs = _batch_size_of(self.tensors, self.non_tensors)
        return 0 if bs is None else bs

    def __contains__(self, key: str) -> bool:
        return key in self.tensors or key in self.non_tensors

    def __getitem__(self, item):
        if isinstance(item, str):
            if item in self.tensors:
                return self.tensors[item]
            return self.non_tensors[item]
        if isinstance(item, (slice, list, np.ndarray)):
            idx = np.arange(len(self))[item] if isinstance(item, slice) else np.asarray(item)
            return self.index(idx)
        if isinstance(item, int):
            return self.index(np.array([item]))
        raise TypeError(f"bad index: {item!r}")

    def keys(self):
        return [*self.tensors.keys(), *self.non_tensors.keys()]

    @classmethod
    def from_dict(cls, tensors: dict[str, Any] | None = None,
                  non_tensors: dict[str, Any] | None = None,
                  meta_info: dict[str, Any] | None = None) -> "TensorBatch":
        non_tensors = {
            k: (v if isinstance(v, np.ndarray) and v.dtype == object
                else np.array(list(v), dtype=object))
            for k, v in (non_tensors or {}).items()
        }
        return cls(dict(tensors or {}), non_tensors, dict(meta_info or {}))

    def select(self, tensor_keys: Sequence[str] | None = None,
               non_tensor_keys: Sequence[str] | None = None,
               meta_info_keys: Sequence[str] | None = None,
               deepcopy_meta: bool = False) -> "TensorBatch":
        tensors = ({k: self.tensors[k] for k in tensor_keys}
                   if tensor_keys is not None else dict(self.tensors))
        non_tensors = ({k: self.non_tensors[k] for k in non_tensor_keys}
                       if non_tensor_keys is not None else dict(self.non_tensors))
        meta = ({k: self.meta_info[k] for k in meta_info_keys}
                if meta_info_keys is not None else dict(self.meta_info))
        if deepcopy_meta:
            meta = copy.deepcopy(meta)
        return TensorBatch(tensors, non_tensors, meta)

    def pop(self, tensor_keys: Sequence[str] = (),
            non_tensor_keys: Sequence[str] = ()) -> "TensorBatch":
        out_t = {k: self.tensors.pop(k) for k in tensor_keys}
        out_nt = {k: self.non_tensors.pop(k) for k in non_tensor_keys}
        return TensorBatch(out_t, out_nt, dict(self.meta_info))

    def union(self, other: "TensorBatch") -> "TensorBatch":
        """Merge another batch's keys into this one (same batch size)."""
        if len(self) and len(other) and len(self) != len(other):
            raise ValueError(f"union size mismatch {len(self)} vs {len(other)}")
        return TensorBatch({**self.tensors, **other.tensors},
                           {**self.non_tensors, **other.non_tensors},
                           {**self.meta_info, **other.meta_info})

    @staticmethod
    def concat(batches: Sequence["TensorBatch"]) -> "TensorBatch":
        batches = [b for b in batches if len(b) > 0]
        if not batches:
            return TensorBatch()
        tensors = {}
        for k in batches[0].tensors:
            vals = [b.tensors[k] for b in batches]
            if any(isinstance(v, torch.Tensor) for v in vals):
                tensors[k] = torch.cat([torch.as_tensor(v) for v in vals], dim=0)
            else:
                tensors[k] = np.concatenate(vals, axis=0)
        non_tensors = {k: np.concatenate([b.non_tensors[k] for b in batches], axis=0)
                       for k in batches[0].non_tensors}
        return TensorBatch(tensors, non_tensors, dict(batches[0].meta_info))

    def index(self, idx: np.ndarray) -> "TensorBatch":
        def take(v):
            if isinstance(v, torch.Tensor):
                return v[torch.as_tensor(idx, dtype=torch.long, device=v.device)]
            return v[idx]

        return TensorBatch({k: take(v) for k, v in self.tensors.items()},
                           {k: v[idx] for k, v in self.non_tensors.items()},
                           dict(self.meta_info))

    def split(self, split_size: int) -> list["TensorBatch"]:
        n = len(self)
        return [self.index(np.arange(i, min(i + split_size, n)))
                for i in range(0, n, split_size)]

    def chunk(self, chunks: int) -> list["TensorBatch"]:
        n = len(self)
        if n % chunks != 0:
            raise ValueError(f"batch size {n} not divisible into {chunks} chunks")
        return self.split(n // chunks)

    def repeat(self, repeat_times: int, interleave: bool = True) -> "TensorBatch":
        """Unroll each row ``repeat_times`` times."""
        n = len(self)
        idx = (np.repeat(np.arange(n), repeat_times) if interleave
               else np.tile(np.arange(n), repeat_times))
        return self.index(idx)

    def rename(self, old_keys: Sequence[str], new_keys: Sequence[str]) -> "TensorBatch":
        for o, nk in zip(old_keys, new_keys):
            if o in self.tensors:
                self.tensors[nk] = self.tensors.pop(o)
            elif o in self.non_tensors:
                self.non_tensors[nk] = self.non_tensors.pop(o)
        return self

    def to_numpy(self) -> "TensorBatch":
        tensors = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)) for k, v in self.tensors.items()}
        return TensorBatch(tensors, self.non_tensors, self.meta_info)
