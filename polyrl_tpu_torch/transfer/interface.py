"""Trainer-side weight-transfer facade (a copy of
``polyrl_tpu/transfer/interface.py`` for torch trees).

Equivalent of the reference's FSDPInterface
(rlboost/weight_transfer/fsdp_interface.py:47-233): computes the flat
layout from the param pytree, owns the packed host buffer and the sender
agent, and per update (a) bumps the manager's weight version (which
atomically drains the active pool, fsdp_interface.py:80-95), (b) gathers
params to host into the buffer, (c) signals the sender agent.

Two paths:
- ``TransferInterface`` — push over the TCP fabric to rollout servers in
  other processes or on other hosts (disaggregated rollout). The trainer's
  tree stays on the card; the pack copies it device to host into a pinned
  buffer on a side stream (``layout.pack_params_streaming``).
- ``colocated_update`` — the in-process hand-off to an engine on the same
  card, which copies the tree into its own tensors.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

import numpy as np

import torch

from polyrl_tpu_torch import obs

from .agents import SenderAgent, SenderGroup, TransferConfig
from .layout import (ParamLayout, alloc_buffer, build_layout,
                     build_shard_spec, flatten_with_names, pack_params,
                     pack_params_streaming)
from .nic import pick_sender_ips
from .tcp_engine import Watermark

log = logging.getLogger(__name__)


class TransferInterface:
    def __init__(self, params_template: Any, manager_client=None,
                 num_streams: int = 4, poll_s: float = 1.0,
                 advertise_host: str | None = None,
                 sender_groups: int = 1, sender_nic_cidr: str = "",
                 groups_per_sender: int = 1,
                 cfg: TransferConfig | None = None, fault=None):
        self.layout: ParamLayout = build_layout(params_template)
        # trainer-side shard spec: the port's trainer holds whole tensors
        # on one card, so the sender's ReshardingMap has one trainer side
        self.trainer_spec = build_shard_spec(params_template)
        # a tree on the card packs through a pinned buffer (DMA, and the
        # side-stream copies stay asynchronous)
        self._pin = any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
                        for _, v in flatten_with_names(params_template))
        # (version, wall time of the version bump, pack seconds) of recent
        # pushes, newest last: the version-raise latency reads them
        self.push_log: list[dict] = []
        # supervision knobs (config ``transfer.*``) + optional transfer-
        # plane fault injector (rollout/faults.py TransferFaultInjector)
        self.cfg = cfg or TransferConfig()
        self.fault = fault
        # serial mode double-buffers: pack into _back while the sender
        # pushes from its front buffer (lazy — the default streamed mode
        # packs in place and never needs the second copy of the weights)
        self._back: np.ndarray | None = None
        front = alloc_buffer(self.layout, pin=self._pin)
        if sender_groups > 1:
            # multi-NIC fan-out: one sender agent per interface (CIDR-picked
            # like the reference's 4-groups×8-engines layout,
            # fsdp_interface.py:97-138); the manager partitions the pool
            # across the advertised endpoints. ``advertise_host`` does not
            # apply here — each group advertises ITS OWN NIC's IP (use
            # sender_nic_cidr to steer which interfaces are picked).
            ips = pick_sender_ips(sender_groups, sender_nic_cidr)
            self.sender: SenderAgent | SenderGroup = SenderGroup(
                front, ips, manager_client=manager_client,
                num_streams=num_streams, poll_s=poll_s,
                cfg=self.cfg, fault=fault, layout=self.layout,
                trainer_spec=self.trainer_spec)
            endpoints = self.sender.endpoints
        else:
            self.sender = SenderAgent(front, manager_client=manager_client,
                                      num_streams=num_streams, poll_s=poll_s,
                                      advertise_host=advertise_host,
                                      cfg=self.cfg, fault=fault,
                                      layout=self.layout,
                                      trainer_spec=self.trainer_spec)
            endpoints = [self.sender.endpoint]
        self.manager = manager_client
        # async push state: pending pack/wire rounds CHAIN on a FIFO of
        # "weight-push" threads — each joins its predecessor before arming
        # the sender, so rounds serialize on the one buffer while the
        # foreground never blocks. _push_issued/_push_landed back the
        # pipelined trainer's bounded-staleness admission gate
        # (push_lag()/wait_push_lag()): up to staleness_limit-1 rounds may be in
        # flight while generation streams against the last landed version.
        self._push_cv = threading.Condition()
        self._push_thread: threading.Thread | None = None
        self._push_err: BaseException | None = None
        self._push_issued = 0
        self._push_landed = 0
        self._last_async_version = -1
        self.sender.start()
        if manager_client is not None:
            manager_client.update_weight_senders(
                endpoints, groups_per_sender=groups_per_sender)

    def _log_push(self, version: int, t_wall: float, pack_s: float) -> None:
        self.push_log.append({"version": int(version), "t_wall": t_wall,
                              "pack_s": pack_s})
        del self.push_log[:-64]

    def update_weights_with_agent(self, params: Any,
                                  streaming: bool = True) -> int:
        """Push new weights. Two modes:

        - ``streaming`` (default): version bump FIRST, then pack in place
          while sender streams trail the pack watermark — pack, wire, and
          (with a receiver-side ``on_tensor`` installer) the device upload
          all overlap inside the one round. This is what the <5 s
          trainer->rollout sync latency KPI measures (reference in-round
          pipeline: sender_agent.py:567-647).
        - serial: pack into the back buffer (overlapping any in-flight
          PREVIOUS round), then swap. Kept for multi-NIC sender groups
          (each group streams a different NIC; one shared watermark would
          serialize them on the slowest pack reader).

        Either way the manager version bump drains the active pool
        (fsdp_interface.py:80-95) and only re-activates instances that
        reach the CURRENT version, so a racing old-version push can never
        leave an instance serving stale weights.
        """
        t0 = time.monotonic()
        with obs.span("transfer/update_weights",
                      mb=round(self.layout.total_bytes / 1e6, 1)):
            version = self._update_weights_impl(params, streaming)
        # trainer-side pack+signal time; the wire time per instance is
        # observed sender-side as transfer/push_s (agents._push_one)
        obs.observe("transfer/pack_s", time.monotonic() - t0)
        return version

    def _next_version(self) -> int:
        if self.manager is not None:
            return self.manager.update_weight_version()
        # managerless version issue must count QUEUED rounds too —
        # sender.version only advances when a round arms
        return max(self.sender.version, self._last_async_version) + 1

    def _pack_streamed(self, params: Any, version: int, t_wall: float,
                       ready=None) -> None:
        """Arm the sender for ``version`` (waiting out in-flight rounds) and
        pack in place behind the watermark; a failed pack fails the round
        and poisons the version."""
        wm = Watermark(self.layout.total_bytes)
        self.sender.signal_update_streaming(wm, version)
        t0 = time.monotonic()
        try:
            pack_params_streaming(params, self.layout, self.sender.buffer,
                                  wm.advance, ready=ready)
        except BaseException as exc:
            wm.fail(str(exc))  # unblock gated streams -> round fails
            # and stop the poll loop from re-pushing the garbage round
            self.sender.mark_push_failed(version)
            raise
        wm.finish()
        self._log_push(version, t_wall, time.monotonic() - t0)

    def _update_weights_impl(self, params: Any, streaming: bool) -> int:
        t0 = time.monotonic()
        if streaming and isinstance(self.sender, SenderAgent):
            t_wall = time.time()
            version = self._next_version()
            self._last_async_version = version
            self._pack_streamed(params, version, t_wall)
        else:
            if self._back is None:
                self._back = alloc_buffer(self.layout, pin=self._pin)
            pack_params(params, self.layout, self._back)
            t_wall = time.time()
            version = self._next_version()
            self._last_async_version = version
            self._back = self.sender.swap_buffer(self._back, version)
            self._log_push(version, t_wall, time.monotonic() - t0)
        log.info("packed weights v%d (%.0f MB) in %.2fs", version,
                 self.layout.total_bytes / 1e6, time.monotonic() - t0)
        return version

    def update_weights_async(self, params: Any) -> int:
        """Non-blocking streamed push (the pipelined trainer's path): the
        manager version bump happens INLINE — it must drain the active pool
        before any instance could observe mixed versions, exactly like the
        sync path — and the pack/wire round (signal + streaming pack behind
        the watermark) completes on a background ``weight-push`` thread.
        Rounds QUEUE: a push issued while a previous round is still in
        flight chains behind it (the new thread joins its predecessor, and
        ``signal_update_streaming`` itself waits out the predecessor's wire
        before re-arming the buffer) — the foreground never blocks, which
        is what lets ``staleness_limit > 1`` overlap pushes with
        generation mid-stream. ``wait_pushed()`` drains the whole chain;
        ``wait_push_lag()`` is the bounded admission gate.

        Callers MUST pass a tree that nothing writes afterwards (the
        trainer clones the actor's tensors on the card first, since its
        next optimizer step updates them in place). An event recorded here,
        on the caller's stream after that clone, gates the background
        pack's device-to-host copies; the pack waits on all of them before
        the thread drops the tree, so its memory outlives the copies.

        Multi-NIC ``SenderGroup`` keeps its serial double-buffer round and
        degrades to the synchronous call (its pack already overlaps any
        in-flight previous round via the back buffer)."""
        if not isinstance(self.sender, SenderAgent):
            return self.update_weights_with_agent(params)
        t_wall = time.time()
        version = self._next_version()
        self._last_async_version = version
        ready = None
        if self._pin and torch.cuda.is_available():
            ready = torch.cuda.Event()
            ready.record()
        ctx = obs.get_tracer().capture()
        t0 = time.monotonic()
        with self._push_cv:
            prev = self._push_thread
            self._push_issued += 1

        def _bg() -> None:
            if prev is not None:
                prev.join()
            try:
                with obs.get_tracer().adopt(ctx), \
                        obs.span("transfer/update_weights",
                                 mb=round(self.layout.total_bytes / 1e6, 1),
                                 mode="async"):
                    self._pack_streamed(params, version, t_wall, ready)
                obs.observe("transfer/pack_s", time.monotonic() - t0)
                log.info("async-packed weights v%d (%.0f MB) in %.2fs",
                         version, self.layout.total_bytes / 1e6,
                         time.monotonic() - t0)
            except BaseException as exc:  # noqa: BLE001 — re-raised by fence
                with self._push_cv:
                    if self._push_err is None:
                        self._push_err = exc
            finally:
                # a failed round still LANDS (it is over): the lag gate
                # must unblock — the failure surfaces on the next fence
                with self._push_cv:
                    self._push_landed += 1
                    self._push_cv.notify_all()

        t = threading.Thread(target=_bg, name="weight-push", daemon=True)
        with self._push_cv:
            # started before it is published: a fence on another thread
            # (the pipeline's producer) may join it at once
            t.start()
            self._push_thread = t
        return version

    def push_lag(self) -> int:
        """Async push rounds issued but not yet landed (pack complete or
        failed). The pipelined trainer's bounded-staleness gauge feed."""
        with self._push_cv:
            return self._push_issued - self._push_landed

    def wait_push_lag(self, max_lag: int, timeout: float = 600.0) -> None:
        """Bounded-staleness admission gate: block until at most
        ``max_lag`` async push rounds are still in flight (``max_lag=0``
        ≡ the full ``wait_pushed`` fence), re-raising any background push
        failure. The pipeline calls this with ``staleness_limit - 1``
        before each prefetched stream's first request."""
        deadline = time.monotonic() + timeout
        with self._push_cv:
            while (self._push_issued - self._push_landed > max_lag
                   and self._push_err is None):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"weight-push lag still > {max_lag} after "
                        f"{timeout:.0f}s")
                self._push_cv.wait(remaining)
            err, self._push_err = self._push_err, None
        if err is not None:
            raise RuntimeError("async weight push failed") from err

    def wait_pushed(self, timeout: float = 600.0) -> None:
        """Fence on the async push chain: returns once every queued round's
        pack has fully landed (the point the SYNC path returns at —
        receivers version-gate behind the manager, so instance
        re-activation needs no trainer-side wait), re-raising any
        background failure."""
        with self._push_cv:
            t = self._push_thread
        if t is not None:
            # the newest thread joins its whole predecessor chain first,
            # so joining it alone drains every queued round
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"async weight push still running after {timeout:.0f}s")
            with self._push_cv:
                if self._push_thread is t:
                    self._push_thread = None
        with self._push_cv:
            err, self._push_err = self._push_err, None
        if err is not None:
            raise RuntimeError("async weight push failed") from err

    def set_laggard_callback(self, cb) -> None:
        """Wire the retry-budget-exhaustion escalation: ``cb(instance,
        reason)`` — train.py passes ``PoolManager.escalate_laggard`` so a
        dead receiver is drained + deregistered instead of re-pushed
        every poll forever."""
        self.sender.laggard_cb = cb

    def counters(self) -> dict[str, float]:
        """Cumulative ``transfer/*`` supervision gauges + config echo for
        step records (RemoteRollout.fault_counters merges these, so they
        ride every step record and the FlightRecorder's
        ``transfer/push_failures`` watch)."""
        out = dict(self.sender.counters())
        out["transfer/min_bandwidth_mbps"] = float(
            self.cfg.min_bandwidth_mbps)
        out["transfer/retry_budget"] = float(self.cfg.retry_budget)
        if self.fault is not None:
            out.update(self.fault.counters())
        return out

    def sync_health(self) -> dict[str, dict]:
        """Per-instance push health (``PoolManager.transfer_health_fn``
        feeds the /statusz pool section's per-engine ``transfer`` block)."""
        return self.sender.sync_health()

    def close(self) -> None:
        try:
            # a push mid-flight holds the sender's buffer/round state;
            # give it a bounded window before tearing the agent down
            self.wait_pushed(timeout=30.0)
        except Exception:  # noqa: BLE001 — teardown must proceed
            log.exception("async weight push failed during close")
        # SenderAgent.stop shuts the push/notify executors down with
        # cancel_futures and joins the accept/event threads, so a teardown
        # mid-push cannot leak threads past the conftest guard
        self.sender.stop()


def colocated_update(engine, params: Any, version: int | None = None) -> None:
    """In-process hand-off to a colocated rollout engine (it copies the
    tree into its own tensors): the hybrid's local engine takes each push
    this way (``RemoteRollout._update_local_copy``)."""
    engine.update_weights(params, version=version)
