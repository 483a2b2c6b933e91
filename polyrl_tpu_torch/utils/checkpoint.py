"""Checkpoint/resume in the port's own format.

Counterpart of ``polyrl_tpu/utils/checkpoint.py``. The JAX package saves
with Orbax; the port cannot read Orbax and needs no JAX checkpoint, so it
writes its own format with the same layout and the same interface:

- ``<root>/global_step_<N>/`` per saved step (``find_latest_ckpt_path``,
  ``latest_step``), each holding one ``<item>.pt`` per item, a
  ``torch.save`` of a flat ``{name: tensor}`` dict (the trainer saves
  ``actor`` and ``critic``: parameters, AdamW's mu and nu and its counts,
  ``trainer/actor.train_state``), and ``meta.json`` (global step,
  dataloader state). Items are separate files and restore independently:
  an actor-only checkpoint resumes into a trainer that has grown a critic.
- ``should_save_checkpoint``: the ``save_freq`` boundary, the last step,
  or an approaching spot-instance expiry (``POLYRL_ESI_EXPIRATION_TS``,
  ``esi_expiry_from_env``).
- ``CheckpointManager``: ``save``, ``wait``, ``latest_step``,
  ``saved_items``, ``restore``, ``close``, with ``max_to_keep``.

Saves are asynchronous, as the JAX default is: ``save`` takes a host copy
of every tensor before it returns (the trainer updates its parameters in
place, so a writer thread reading them during the next optimizer step
would save a torn state), then a thread writes the files into a temporary
directory and renames it to ``global_step_<N>``. ``wait`` joins that
thread and raises what it raised; ``save`` waits for the previous one
first. The host copies go into staging buffers allocated at the first
save and reused by the next ones (pinned for device tensors: a pageable
copy would stall on the stream; ``save`` waiting for the previous write
keeps the writer and the next snapshot apart).

Wrapped trees: an item may be a nested tree whose leaves are tensors or
the ``models/quant.py`` wrappers (``QuantWeight``, ``LoraWeight``); it is
saved flat (``quant.flatten``: dotted names, each LoRA ``alpha`` a 0-d
tensor) and ``unflatten_tree`` rebuilds it from what ``restore`` returns,
with the wrapper types, ``alpha`` and an int8 base intact.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
import time

import torch

from polyrl_tpu_torch.models.quant import flatten as flatten_tree
from polyrl_tpu_torch.models.quant import unflatten as unflatten_tree

__all__ = ["CheckpointManager", "find_latest_ckpt_path", "latest_step",
           "should_save_checkpoint", "esi_expiry_from_env", "flatten_tree",
           "unflatten_tree"]

_STEP_RE = re.compile(r"^global_step_(\d+)$")
_META = "meta.json"


def find_latest_ckpt_path(root: str) -> str | None:
    """The most recent ``global_step_<N>`` directory under ``root``."""
    step = latest_step(root)
    return None if step is None else os.path.join(root, f"global_step_{step}")


def latest_step(root: str) -> int | None:
    if not root or not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root) if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def should_save_checkpoint(
    step: int,
    total_steps: int,
    save_freq: int,
    *,
    esi_expiry_ts: float | None = None,
    esi_margin_s: float = 300.0,
    now: float | None = None,
) -> bool:
    """Save at a ``save_freq`` boundary, at the last step, or when a spot
    instance's expiry is within ``esi_margin_s``."""
    if step >= total_steps:
        return True
    if save_freq > 0 and step % save_freq == 0:
        return True
    if esi_expiry_ts is not None:
        t = time.time() if now is None else now
        if t >= esi_expiry_ts - esi_margin_s:
            return True
    return False


def esi_expiry_from_env() -> float | None:
    """The spot instance's expiry (epoch seconds), if the scheduler
    exported one in ``POLYRL_ESI_EXPIRATION_TS``."""
    v = os.environ.get("POLYRL_ESI_EXPIRATION_TS", "")
    try:
        return float(v) if v else None
    except ValueError:
        return None


class CheckpointManager:
    """Save and restore of the trainer's state, one file per item."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # seconds the last save spent writing its files (after its snapshot)
        self.last_write_s = 0.0
        # seconds the last save's host snapshot took (``save``'s own wall)
        self.last_snapshot_s = 0.0
        # (item, name) -> host staging buffer, reused across saves
        self._staging: dict[tuple[str, str], torch.Tensor] = {}

    # -- save ---------------------------------------------------------------

    def save(self, step: int, items: dict[str, dict[str, torch.Tensor]],
             meta: dict | None = None) -> None:
        """``items``: name -> a flat ``{name: tensor}`` dict or a (wrapped)
        tree. Returns once the host copies are taken; the files are written
        in the background."""
        self.wait()
        t0 = time.monotonic()
        snapshot = {name: self._host_copy(name, flatten_tree(tree))
                    for name, tree in items.items()}
        self.last_snapshot_s = time.monotonic() - t0
        meta = dict(meta or {})
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, snapshot, meta),
            name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _host_copy(self, item: str, flat: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
        """A host copy of each tensor, taken now, into this item's staging
        buffers (a CPU tensor is copied too: its owner may update it in
        place). Device tensors are copied without blocking into pinned
        buffers, then the device is synchronised once."""
        out, on_card = {}, False
        for k, v in flat.items():
            v = v.detach()
            buf = self._staging.get((item, k))
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
                self._staging[(item, k)] = buf
            buf.copy_(v, non_blocking=v.is_cuda)
            on_card |= v.is_cuda
            out[k] = buf
        if on_card:
            torch.cuda.synchronize()
        return out

    def _write_guarded(self, step, snapshot, meta) -> None:
        try:
            self._write(step, snapshot, meta)
        except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
            self._error = exc

    def _write(self, step: int, snapshot: dict, meta: dict) -> None:
        t0 = time.monotonic()
        final = os.path.join(self.root, f"global_step_{step}")
        tmp = tempfile.mkdtemp(prefix=f".tmp-global_step_{step}-", dir=self.root)
        try:
            for name, flat in snapshot.items():
                torch.save(flat, os.path.join(tmp, f"{name}.pt"))
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(meta, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        self.last_write_s = time.monotonic() - t0

    def _prune(self) -> None:
        if self.max_to_keep <= 0:
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.root)
                       if (m := _STEP_RE.match(d)))
        for old in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, f"global_step_{old}"),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> int | None:
        return latest_step(self.root)

    def saved_items(self, step: int | None = None) -> set[str]:
        step = self.latest_step() if step is None else step
        if step is None:
            return set()
        d = os.path.join(self.root, f"global_step_{step}")
        return {f[:-3] for f in os.listdir(d) if f.endswith(".pt")}

    def restore(self, step: int | None = None, targets=None):
        """``(items, meta)`` of ``step`` (the latest by default), or None if
        nothing was saved. ``targets``: the item names wanted; only those
        present both on disk and in ``targets`` are read (all saved items
        when it is None). Each item comes back as its flat dict of host
        tensors."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        d = os.path.join(self.root, f"global_step_{step}")
        names = self.saved_items(step)
        if targets is not None:
            names &= set(targets)
        items = {n: torch.load(os.path.join(d, f"{n}.pt"), map_location="cpu",
                               weights_only=True) for n in sorted(names)}
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
        return items, meta

    def close(self) -> None:
        self.wait()
