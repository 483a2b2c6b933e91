"""Helpers shared by the port's CPU engine tests: deterministic waits and
aborts on a ``polyrl_tpu_torch`` ``CBEngine``, with no sleeps."""

import threading
import time

from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
from polyrl_tpu_torch.rollout.sampling import SamplingParams


def drain(q, timeout: float = 60.0) -> tuple[list, str]:
    """A stream's tokens and finish reason, up to its ``STREAM_END``."""
    toks, reason = [], ""
    while True:
        item = q.get(timeout=timeout)
        if item is STREAM_END:
            return toks, reason
        toks.extend(item["token_ids"])
        if item["finished"]:
            reason = item["finish_reason"]


def quiesce(eng, timeout: float = 60.0) -> None:
    """Wait until the engine is quiescent: no active slot, nothing pending,
    queued or in flight, and no chunk job, read under the dispatch lock (so
    never in the middle of an iteration)."""
    deadline = time.monotonic() + timeout
    while True:
        with eng._pool_lock:
            quiet = (not eng._active.any() and not eng._pending
                     and eng._queue.empty() and not eng._chunk_jobs
                     and eng._outstanding() == 0)
        if quiet:
            return
        assert time.monotonic() < deadline, "engine did not quiesce"
        eng._idle.wait(0.05)


def abort_driven(eng, prompt, rid: str = "abort-me",
                 n_dispatches: int = 3) -> tuple[list, str]:
    """Admit a long greedy request on an unstarted engine, queue
    ``n_dispatches`` decode dispatches, set its abort and run the next
    step, which takes the abort path (salvage or fast): deterministic,
    whatever the machine's load. Returns the drained stream."""
    ev = threading.Event()
    q = eng.submit(rid, prompt,
                   SamplingParams(temperature=0.0, max_new_tokens=400),
                   abort=ev)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        for _ in range(n_dispatches):
            eng._step_once()
        ev.set()
        eng._step_once()
    return drain(q)
