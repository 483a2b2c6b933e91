"""Parameter conversion from the JAX package's tree, through numpy.

The port keeps the reference's names and stacked shapes
(``models/decoder.py``), so conversion is a leaf-by-leaf copy. Callers
turn the JAX tree's leaves into numpy arrays first (``np.asarray`` on
each ``jax.Array``); this module never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (JAX exports ml_dtypes.bfloat16):
        # widen to f32, which holds every bf16 value exactly
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # own, writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict, device="cpu",
                      dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given)."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _leaf(v, device, dtype))
            for k, v in tree.items()}
