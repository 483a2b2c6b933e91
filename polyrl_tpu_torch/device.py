"""Device resolution for the port's entry points: no silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    ``"cuda"`` (the default of every entry point) raises when CUDA is not
    available instead of carrying on on the CPU: a serving process that
    quietly ran its decode loop on the host would look alive and be
    hundreds of times slower. Only an explicit ``"cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
