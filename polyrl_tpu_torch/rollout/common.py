"""Helpers shared by the continuous-batching engine (``cb_engine.py``) and
the step backend (``engine.py``, ``stepper.py``): bucketing, left-padded
packing, and the engines' own copy of a weight tree with its structure
check."""

from __future__ import annotations

import numpy as np
import torch

from polyrl_tpu_torch.models.quant import named_leaves, tree_map


def next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def pack_left_padded(prompt_ids, pad_token_id: int, bb: int, pb: int):
    """Left-pad prompts into [bb, pb] (ids int32, mask f32), shared by the
    batch and the streaming decode so that padding cannot drift."""
    ids = np.full((bb, pb), pad_token_id, np.int32)
    mask = np.zeros((bb, pb), np.float32)
    for i, p in enumerate(prompt_ids):
        ids[i, pb - len(p):] = np.asarray(p, np.int32)
        mask[i, pb - len(p):] = 1.0
    return ids, mask


def params_copy(tree: dict, device: torch.device) -> dict:
    """An engine's own copy of a parameter tree on ``device`` (wrappers such
    as an int8 ``QuantWeight`` kept)."""
    return tree_map(lambda v: v.detach().to(device, copy=True), tree)


def check_same_structure(new: dict, cur: dict) -> None:
    """Refuse a weight tree whose leaf names, shapes or dtypes differ from
    the engine's (``copy_`` would cast silently; a quantized engine needs
    the push re-quantized first, ``models/quant.py``)."""
    new, cur = dict(named_leaves(new)), dict(named_leaves(cur))
    if new.keys() != cur.keys():
        raise ValueError(
            "update_weights: parameter names differ from the engine's "
            f"(missing {sorted(cur.keys() - new.keys())[:4]}, extra "
            f"{sorted(new.keys() - cur.keys())[:4]}; quantized engines "
            "need the push re-quantized first, models/quant.py)")
    bad = [k for k in cur if tuple(new[k].shape) != tuple(cur[k].shape)
           or new[k].dtype != cur[k].dtype]
    if bad:
        k = bad[0]
        raise ValueError(
            f"update_weights: {k} is {new[k].dtype} {tuple(new[k].shape)}, "
            f"the engine's {cur[k].dtype} {tuple(cur[k].shape)} "
            f"({len(bad)} leaves differ)")
