"""Parameter conversion from the JAX package's tree, through numpy.

The port keeps the reference's names and stacked shapes
(``models/decoder.py``), so conversion is a leaf-by-leaf copy, of the
decoder's tree and of the critic's alike (``trainer/critic.py``: the
decoder's leaves without ``lm_head``, plus a ``[hidden, 1]``
``value_head``). Callers turn the JAX tree's leaves into numpy arrays
first (``np.asarray`` on each ``jax.Array``); this module never imports
JAX. The reference's weight wrappers are recognised by their fields
(``q``/``scale``; ``base``/``a``/``b``/``alpha``) and become the port's
``models/quant.py`` classes: the int8 data stays int8, the scale f32 and
``alpha`` a float.
"""

from __future__ import annotations

import numpy as np
import torch

from polyrl_tpu_torch.device import resolve_device
from polyrl_tpu_torch.models.quant import LoraWeight, QuantWeight


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


def params_from_numpy(tree: dict, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given). The default
    is the card, as for every entry point of the port: it raises when CUDA
    is absent (``device.resolve_device``); pass ``"cpu"`` to convert for
    the CPU."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if all(hasattr(v, f) for f in ("base", "a", "b", "alpha")):
            return LoraWeight(conv(v.base), conv(v.a), conv(v.b), float(v.alpha))
        if hasattr(v, "q") and hasattr(v, "scale"):
            return QuantWeight(_leaf(v.q, dev, None), _leaf(v.scale, dev, None))
        return _leaf(v, dev, dtype)

    return conv(tree)
