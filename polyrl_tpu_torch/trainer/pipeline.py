"""RolloutPipeline: rollout production running ``depth`` steps ahead.

Counterpart of ``polyrl_tpu/trainer/pipeline.py``. The serial ``fit``
loop leaves the engine idle through every update and the trainer idle
through every generation. This object splits the step into two lanes:

- **producer lane** (one background thread, ``rollout-pipeline``): pulls
  the next batch of records from the dataloader and drives the trainer's
  ``_ibatch_iter_local`` stream up to ``depth`` steps ahead of training,
  pushing the ibatches into a bounded queue. Before each step's first
  generation request it takes the autoscaler's admission gate (held
  while the pool has no active engine; none without a controller), then
  the bounded-staleness admission gate
  (``trainer.cfg.staleness_limit``): with the default limit 1 the hard
  ``_wait_pushed()`` fence, so a stream never starts against a push still
  in flight; with a limit k > 1 the stream may start while up to k - 1
  pushes are in flight (``_wait_push_headroom``), and the mixed-version
  truncated importance correction (``rollout_is_correction``) covers the
  tokens that span versions.
- **consumer lane** (the trainer's foreground thread): drains the queue
  through ``step_ibatches`` and runs reward -> logprob -> values ->
  advantage -> update as the serial loop does.

Flow control is a step-credit semaphore: the producer needs one credit per
step and the consumer grants one when it starts a step, so the producer
runs at most ``depth`` steps ahead of the step being trained; within a
step the bounded queue gives item-level backpressure. With ``depth = 1``
a stream launched while step N trains generates with the weights of step
N - 1 (and, on the colocated engine, with step N's from the push that
lands mid-stream): one version stale at most.

Errors on either lane propagate: a producer failure is queued and raised
again on the foreground; a consumer failure closes the pipeline, which
releases a producer parked on the queue or the credit semaphore, and
joins the thread.

Both lanes queue their device work on the current CUDA stream of their
thread, which is the device's default stream for both (neither sets
another), so the stream orders the engine's weight copy after the
optimizer step that wrote the weights, and the next in-place optimizer
step after the copy. A remote rollout's push is asynchronous instead
(``update_weights_async`` on a clone of the tree), and the producer takes
the finished steps' manager scrape and balancer round trip off the hot
path (``submit_step_stats``): their gauges land in the next consumed
step's record. The producer's ``trainer/prefetch`` spans adopt the trace
context of the ``fit`` that started the lane, so the critical path sees
the hidden generation (``obs/critical_path.py``).

On a multi-process run the lane runs on rank 0 alone and issues no
collective: the foreground drains ``step_ibatches`` through the trainer's
``_ibatch_fanout``, so every broadcast is issued from the foreground
thread, in one order on every rank, and the other ranks replay them.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from polyrl_tpu_torch import obs
from polyrl_tpu_torch.utils.metrics import MetricsTracker

log = logging.getLogger(__name__)


class PipelineClosed(RuntimeError):
    """The pipeline stopped without finishing the requested step."""


class RolloutPipeline:
    def __init__(self, trainer, depth: int):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.trainer = trainer
        self.depth = depth
        cfg = trainer.cfg
        per_step = max(1, -(-cfg.train_batch_size * cfg.rollout_n
                            // max(cfg.min_stream_batch_size, 1)))
        # depth + 1 steps may be in flight (the one being trained plus depth
        # prefetched); + depth + 2 covers the end sentinels without ever
        # blocking a producer that the credit gate already admitted
        self._q: queue.Queue = queue.Queue(
            maxsize=(self.depth + 1) * per_step + self.depth + 2)
        self._credits = threading.Semaphore(self.depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # finished steps' stats for the manager's balancer, and the gauges
        # its answers produce (folded into the next consumed step)
        self._stats_q: queue.Queue = queue.Queue()
        self._gauges: dict[str, float] = {}
        self._gauges_lock = threading.Lock()
        # the producer's spans adopt the fit's context: the lane shows in
        # the same trace, on its own thread's track
        self._trace_ctx = obs.get_tracer().capture()

    # -- lifecycle ----------------------------------------------------------

    def start(self, start_step: int, total_steps: int) -> "RolloutPipeline":
        self._thread = threading.Thread(
            target=self._run, args=(start_step, total_steps),
            name="rollout-pipeline", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer and join it. Safe on the foreground's error
        path: a producer blocked on the queue or the credit gate polls the
        stop flag and exits; one inside ``generate`` returns when that
        generation does."""
        self._stop.set()
        self._credits.release()  # unblock a producer parked on the gate
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                log.warning("rollout-pipeline thread did not stop in %.0fs",
                            timeout)

    # -- producer lane ------------------------------------------------------

    def _run(self, start_step: int, total_steps: int) -> None:
        with obs.get_tracer().adopt(self._trace_ctx):
            self._produce(start_step, total_steps)

    def _produce(self, start_step: int, total_steps: int) -> None:
        trainer = self.trainer
        for step in range(start_step, total_steps):
            if not self._acquire_credit():
                return
            # off-hot-path control-plane work between streams: the manager
            # scrape and balancer round trip of the steps finished since
            self._drain_stats()
            prod_metrics = MetricsTracker()
            try:
                # the autoscaler's admission gate: while the pool has no
                # active engine, hold the new stream (a no-op without a
                # controller)
                trainer._wait_pool_admission(prod_metrics)
                # admission gate: limit 1 is the hard fence (the previous
                # push fully landed before this stream's first request);
                # limit k > 1 blocks only while k - 1 pushes are in flight
                limit = max(int(trainer.cfg.staleness_limit), 1)
                t_fence = time.monotonic()
                if limit <= 1:
                    trainer._wait_pushed()
                else:
                    trainer._wait_push_headroom(limit - 1)
                gate_wait = time.monotonic() - t_fence
                # its interval: the trainer's goodput split counts the
                # part inside its own stream waits
                prod_metrics.add_timing("prefetch_fence", gate_wait,
                                        t0=t_fence)
                prod_metrics.update({"perf/staleness_gate_wait_s": gate_wait})
                prod_metrics.update_gauge({
                    "perf/staleness_lag": float(trainer._push_lag()),
                    "perf/staleness_limit": float(limit)})
                version = trainer._push_count
                gen_t0 = time.monotonic()
                with obs.span("trainer/prefetch", step=step + 1,
                              version=version):
                    records = next(trainer.dataloader)
                    loader_state = (trainer.dataloader.state_dict()
                                    if hasattr(trainer.dataloader,
                                               "state_dict") else None)
                    for ib in trainer._ibatch_iter_local(records, None,
                                                         prod_metrics):
                        if not self._put(("ibatch", step, ib)):
                            return
            except BaseException as exc:  # noqa: BLE001 — raised again on
                # the foreground by step_ibatches
                log.exception("rollout pipeline producer failed at step %d",
                              step + 1)
                self._put(("error", step, exc))
                return
            self._put(("end", step, {
                "gen_t0": gen_t0, "gen_t1": time.monotonic(),
                "weight_version": version, "loader_state": loader_state,
                "metrics": prod_metrics}))

    def _acquire_credit(self) -> bool:
        while not self._stop.is_set():
            if self._credits.acquire(timeout=0.2):
                return not self._stop.is_set()
        return False

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer lane ------------------------------------------------------

    def step_ibatches(self, step: int, metrics: MetricsTracker):
        """Yield the ibatches of ``step`` from the queue; on the step's end
        sentinel, fold the producer's metrics and the overlap, staleness
        and queue-depth gauges into ``metrics``, record the dataloader's
        position after this step's records (what a checkpoint of this step
        saves) and return. Granting the step credit here, at consume
        start, is what lets the producer run ahead while this step
        trains."""
        self._credits.release()
        consume_t0 = time.monotonic()
        while True:
            kind, item_step, payload = self._get()
            if kind == "error":
                raise payload
            if item_step != step:
                raise PipelineClosed(
                    f"pipeline out of sync: expected step {step + 1}, got "
                    f"{item_step + 1} (a previous step was abandoned "
                    f"mid-stream)")
            if kind == "end":
                # overlap: the part of this step's generation that happened
                # before the foreground began the step
                overlap = max(0.0, min(payload["gen_t1"], consume_t0)
                              - payload["gen_t0"])
                metrics.update({"perf/pipeline_overlap_s": overlap})
                metrics.update_gauge({
                    "perf/pipeline_queue_depth": float(self._q.qsize()),
                    "perf/weight_staleness": float(
                        self.trainer._push_count - payload["weight_version"]),
                })
                metrics.merge(payload["metrics"])
                self._fold_gauges(metrics)
                if payload["loader_state"] is not None:
                    self.trainer._loader_state = payload["loader_state"]
                return
            yield payload

    def _get(self):
        t = self._thread
        while True:
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set() or t is None or not t.is_alive():
                    raise PipelineClosed(
                        "rollout pipeline stopped mid-step") from None

    # -- off-hot-path control plane (remote rollout) -------------------------

    def submit_step_stats(self, **stats) -> None:
        """The foreground hands a finished step's stats over; the producer
        runs the manager scrape and balancer call before its next stream,
        and the resulting gauges land in the next consumed step's record
        (gauges, so one step of lag is benign)."""
        self._stats_q.put(stats)

    def _drain_stats(self) -> None:
        trainer = self.trainer
        while True:
            try:
                stats = self._stats_q.get_nowait()
            except queue.Empty:
                return
            gauges: dict[str, float] = {}
            try:
                gauges.update(trainer.rollout.scrape_manager_metrics())
                gauges.update(trainer._balancer_round(stats))
            except Exception:  # noqa: BLE001 — telemetry must not kill a lane
                log.exception("pipeline balancer round failed")
            if gauges:
                with self._gauges_lock:
                    self._gauges.update(gauges)

    def _fold_gauges(self, metrics: MetricsTracker) -> None:
        with self._gauges_lock:
            gauges, self._gauges = self._gauges, {}
        if gauges:
            metrics.update_gauge(gauges)
