"""The port's disaggregated rollout on the CPU: ``RemoteRollout``'s group
streaming, resume and salvage against the JAX package's on the same
scripted manager, the balance estimator against the reference's, and one
GRPO step of the whole slice.

Mirrors ``tests/test_remote_rollout.py`` (the two stub-manager tests: the
group emission order, and a failed request dropping its whole group; and
``test_disaggregated_streaming_fit``), ``tests/test_control_plane_ft.py``
(a stream resumed with only its pending rids) and ``tests/test_pool.py``
(the balance estimator). The slice runs through ``train.build_trainer``
with ``rollout.mode=disaggregated``: the port's manager (built by ``g++``),
a ``tiny`` f32 rollout server on localhost registered with it, and the
weight fabric. Tolerances: the stub tests and the estimator compare
exactly; after the last push, greedy tokens served through the manager
must equal the JAX package's engine on the trainer's converted weights,
with logprobs within the reference's 5e-4. One module-scoped manager and
server; every wait has a deadline; every process is killed in teardown.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.manager import client as jclient
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout import pool as jpool
from polyrl_tpu.rollout import remote as jremote
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu_torch import train
from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.manager.client import (GenerateProgress, GenerateResult,
                                             ManagerClient,
                                             ManagerTransportError,
                                             spawn_rollout_manager)
from polyrl_tpu_torch.models import decoder, quant
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.pool import BalanceEstimator
from polyrl_tpu_torch.rollout.remote import RemoteRollout
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.serve import create_server, register_with_manager
from polyrl_tpu_torch.transfer.layout import flatten_with_names

LP_TOL = 5e-4
PACKAGES = {
    "port": (RemoteRollout, SamplingParams, GenerateResult, GenerateProgress,
             ManagerTransportError),
    "jax": (jremote.RemoteRollout, JSP, jclient.GenerateResult,
            jclient.GenerateProgress, jclient.ManagerTransportError),
}


class _StubManager:
    """Yields canned results in a given order (out-of-order completion
    across a pool), echoing the caller's rids as the real manager does."""

    def __init__(self, results):
        self.results = results

    def batch_generate_stream(self, requests, max_local_gen_s=None):
        rid_by_idx = {int(r["rid"].rsplit(":", 1)[-1]): r["rid"]
                      for r in requests}
        for res in self.results:
            yield dataclasses.replace(res, rid=rid_by_idx[int(res.rid)])


def _res(result_cls, i, ok=True, n_tok=3):
    return result_cls(rid=str(i), success=ok,
                      output_token_ids=list(range(100 + i, 100 + i + n_tok)),
                      output_token_logprobs=[-0.1] * n_tok,
                      finish_reason="stop" if ok else "",
                      error="" if ok else "boom")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_group_streaming_order_and_min_emit(pkg):
    # groups of 2; completion interleaves groups; min_emit=4 -> the first
    # yield only after two whole groups are done
    rr_cls, sp_cls, res_cls, _, _ = PACKAGES[pkg]
    order = [_res(res_cls, i) for i in (0, 2, 3, 1, 5, 4, 6, 7)]
    rr = rr_cls(_StubManager(order))
    chunks = list(rr.generate_stream([[1]] * 8, sp_cls(max_new_tokens=4),
                                     group_size=2, min_emit=4))
    assert [[i for i, _ in c] for c in chunks] == [[2, 3, 0, 1], [4, 5, 6, 7]]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failed_request_drops_whole_group(pkg):
    rr_cls, sp_cls, res_cls, _, _ = PACKAGES[pkg]
    order = [_res(res_cls, i, ok=i != 2) for i in range(6)]
    rr = rr_cls(_StubManager(order))
    chunks = list(rr.generate_stream([[1]] * 6, sp_cls(max_new_tokens=4),
                                     group_size=2, min_emit=2))
    assert [i for c in chunks for i, _ in c] == [0, 1, 4, 5]
    assert rr.dropped_groups == 1


class _SalvageStub:
    """First call: every rid streams two progress tokens, the first three
    rids finish, then the stream dies; later calls finish every rid they
    are given (its prompt length tells the salvage carried over)."""

    def __init__(self, classes):
        self.res_cls, self.prog_cls, self.err_cls = classes
        self.calls: list[list[dict]] = []

    def health(self):
        return True

    def batch_generate_stream(self, requests, max_local_gen_s=None):
        self.calls.append([dict(r, sampling_params=dict(r["sampling_params"]))
                           for r in requests])
        first = len(self.calls) == 1
        for r in requests:
            if first:
                yield self.prog_cls(rid=r["rid"], token_ids=[7, 8],
                                    logprobs=[-0.5, -0.25], weight_version=3)
        for k, r in enumerate(requests):
            if first and k >= 3:
                raise self.err_cls("injected stream failure")
            n = int(r["sampling_params"]["max_new_tokens"])
            toks = ([7, 8] if first else []) + [50 + len(r["input_ids"])] * (
                n - (2 if first else 0))
            yield self.res_cls(rid=r["rid"], success=True,
                               output_token_ids=toks,
                               output_token_logprobs=[-0.1] * len(toks),
                               finish_reason="length",
                               output_token_weight_versions=[4] * len(toks))


def test_stream_resume_salvages_like_the_reference():
    """A stream dying mid-batch: both packages re-issue only the pending
    rids, with the salvaged tokens folded into their prompts and budgets,
    and stitch the same results."""
    outs, calls, rrs = {}, {}, {}
    for pkg in ("port", "jax"):
        rr_cls, sp_cls, *_ = PACKAGES[pkg]
        stub = _SalvageStub(PACKAGES[pkg][2:])
        rr = rr_cls(stub, resume_budget=2, resume_wait_s=5.0)
        chunks = list(rr.generate_stream(
            [[1, 2, 3]] * 8, sp_cls(max_new_tokens=6), group_size=2,
            min_emit=2))
        outs[pkg] = sorted((i, r.output_token_ids, r.output_token_logprobs,
                            r.output_token_weight_versions)
                           for c in chunks for i, r in c)
        calls[pkg] = [[(r["rid"].rsplit(":", 1)[-1], r["input_ids"],
                        r["sampling_params"]["max_new_tokens"]) for r in c]
                      for c in stub.calls]
        rrs[pkg] = rr
    assert outs["port"] == outs["jax"]
    assert calls["port"] == calls["jax"]
    assert [i for i, *_ in outs["port"]] == list(range(8))
    assert len(calls["port"][1]) == 5  # only the pending rids
    assert calls["port"][1][0][1:] == ([1, 2, 3, 7, 8], 4)
    for a in ("stream_resumes", "tokens_salvaged", "suffix_resumes",
              "resume_prefill_tokens"):
        assert getattr(rrs["port"], a) == getattr(rrs["jax"], a), a
    assert rrs["port"].tokens_salvaged == 10


def test_balance_estimator_matches_the_references():
    rng = np.random.default_rng(0)
    ours, ref = BalanceEstimator(window=5), jpool.BalanceEstimator(window=5)
    for step in range(9):
        stats = dict(step_time_s=float(rng.uniform(1, 3)),
                     trainer_bubble_s=float(rng.uniform(0, 1)),
                     throughput=float(rng.uniform(100, 900)),
                     generate_s=float(rng.uniform(0.5, 2)),
                     update_s=float(rng.uniform(0.2, 1)),
                     occupancy=float(rng.uniform(0, 1)),
                     device_frac=float(rng.uniform(0, 1)), extra_key=1.0)
        ours.observe(**stats)
        ref.observe(**stats)
        assert ours.trends() == ref.trends()
        assert ours.stats() == ref.stats()
        assert ours.metrics() == ref.metrics()
    assert ours.trends()["balance_trends_valid"] == 1.0


# -- the slice: trainer, manager, server and fabric ---------------------------


@pytest.fixture(scope="module")
def stack():
    proc, port = spawn_rollout_manager(
        "127.0.0.1:0", extra_args=["--health-check-interval-s", "0.1",
                                   "--stats-poll-interval-s", "0.2"])
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=256, num_pages=128,
                        prompt_buckets=(16, 32))
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        yield mgr, srv
    finally:
        proc.kill()
        proc.wait(timeout=10)
        srv.stop()


def _wait(pred, deadline=30.0, msg="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.05)


@pytest.mark.parametrize("depth", [0, 1], ids=["serial", "pipelined"])
def test_disaggregated_streaming_fit(stack, depth):
    """GRPO through ``train.build_trainer`` with
    ``rollout.mode=disaggregated``: streamed ibatches, fabric pushes
    (bootstrap plus one a step; pipelined, ``update_weights_async`` on a
    clone and the balancer round trip on the producer lane), then greedy
    tokens served through the manager equal the JAX package's engine on
    the trainer's final weights."""
    mgr, srv = stack
    ep = mgr.endpoint.replace("http://", "")
    steps = 1 + 2 * depth
    cfg = load_config(None, [
        "device=cpu", "model.preset=tiny", "model.dtype=float32",
        "rollout.mode=disaggregated", f"rollout.manager_endpoint={ep}",
        "rollout.transfer_streams=2", "trainer.train_batch_size=4",
        "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=8",
        "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
        "trainer.max_prompt_length=16", "trainer.max_response_length=8",
        f"trainer.total_steps={steps}", f"trainer.pipeline_depth={depth}",
        f"trainer.rollout_is_correction={bool(depth)}", "trainer.seed=1",
        "actor.lr=1e-3", "actor.remat=false", "data.arithmetic_size=16"])
    cleanup: list = []
    try:
        # the response's byte length varies within a group at random
        # weights, so the advantages (and the update) are not all zero
        trainer = train.build_trainer(
            cfg, cleanup, compute_score=lambda src, text, gt, extra: float(
                len(text.encode("utf-8"))))
        before = {n: t.clone() for n, t in
                  flatten_with_names(trainer.actor.export_params())}
        v_start = mgr.get_instances_status()["weight_version"]
        # the server registers after the trainer's sender, so the manager
        # assigns it that sender and its receiver connects there
        register_with_manager(srv, ep, transfer_streams=2)
        assert srv.receiver is not None
        trainer.rollout.pool.wait_for_member(srv.endpoint, 30.0, active=False)
        history = trainer.fit()
        assert len(history) == steps
        for h in history:
            for key in ("actor/pg_loss", "actor/grad_norm",
                        "perf/trainer_bubble_s"):
                assert np.isfinite(h[key]), key
            assert h["actor/grad_norm"] > 0
            assert h["transfer/rounds_verified"] >= 1 and h["pool/engines"] == 1
        # the balancer's answer; pipelined, the producer lane's round trip
        # lands in a later step's record
        assert any(h.get("training/max_local_gen_s", 0) > 0 for h in history)
        assert "transfer/pack_s/count" in history[0]
        assert trainer.rollout.dropped_groups == 0
        final = trainer.rollout.weight_version
        assert final == v_start + 1 + steps  # bootstrap plus one a step
        _wait(lambda: srv.engine.weight_version >= final, msg="the last push")
        assert srv.engine.weight_version == final
        # the server holds the trainer's final weights, bitwise, and they
        # moved in the fit
        after = dict(flatten_with_names(trainer.actor.export_params()))
        served_params = dict(flatten_with_names(srv.engine.params))
        assert served_params.keys() == after.keys()
        for n, t in after.items():
            assert torch.equal(served_params[n], t), n
        assert any(not torch.equal(before[n], after[n]) for n in after)
        _wait(lambda: any(i["active"] for i in
                          mgr.get_instances_status()["instances"]),
              msg="the server back in the routing set")

        # greedy through the manager against the JAX engine on the
        # trainer's final weights
        rng = np.random.default_rng(4)
        prompts = [rng.integers(1, 256, n).tolist() for n in (5, 13, 21)]
        sp = {"temperature": 0.0, "max_new_tokens": 10}
        served = [mgr.generate(f"g{depth}-{i}", p, sp)
                  for i, p in enumerate(prompts)]
        tree = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.detach().numpy()),
            trainer.actor.export_params(),
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        jeng = JEngine(jdec.get_config("tiny", dtype=jnp.float32), tree,
                       kv_cache_dtype=jnp.float32, max_slots=8, page_size=8,
                       max_seq_len=96, prompt_buckets=(16, 32), num_pages=128)
        try:
            ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=10))
        finally:
            jeng.stop()
        for res, want in zip(served, ref):
            assert res.success, res.error
            assert res.output_token_ids == list(want["token_ids"])
            np.testing.assert_allclose(res.output_token_logprobs,
                                       want["logprobs"], rtol=0, atol=LP_TOL)
            assert res.output_token_weight_versions == [final] * 10
    finally:
        for fn in reversed(cleanup):
            fn()
        if srv.receiver is not None:
            srv.receiver.stop()
            srv.receiver = None
        # a later trainer's sender is assigned at the next registration
        mgr.deregister_rollout_instance(srv.endpoint)


def test_int8_server_installs_a_fabric_push(stack):
    """An int8 server registered with the manager takes the trainer's f32
    pushes over the fabric (its layout from the meta template of the
    model-dtype tree) and re-quantizes each on arrival: after the fit its
    ``q`` and ``scale`` equal ``quant.quantize_params`` of the trainer's
    final tree bitwise, and greedy tokens served through the manager equal
    an in-process int8 engine's on those weights (logprobs within 5e-4)."""
    mgr, _ = stack
    ep = mgr.endpoint.replace("http://", "")
    geom = dict(max_slots=8, page_size=8, max_seq_len=256, num_pages=128,
                prompt_buckets=(16, 32))
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", weight_quant="int8", **geom)
    cfg = load_config(None, [
        "device=cpu", "model.preset=tiny", "model.dtype=float32",
        "rollout.mode=disaggregated", f"rollout.manager_endpoint={ep}",
        "rollout.transfer_streams=2", "trainer.train_batch_size=4",
        "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=8",
        "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
        "trainer.max_prompt_length=16", "trainer.max_response_length=8",
        "trainer.total_steps=1", "trainer.seed=2", "actor.lr=1e-3",
        "actor.remat=false", "data.arithmetic_size=16"])
    cleanup: list = []
    try:
        trainer = train.build_trainer(
            cfg, cleanup, compute_score=lambda src, text, gt, extra: float(
                len(text.encode("utf-8"))))
        register_with_manager(srv, ep, transfer_streams=2)
        assert srv.receiver is not None
        trainer.rollout.pool.wait_for_member(srv.endpoint, 30.0, active=False)
        history = trainer.fit()
        assert len(history) == 1 and np.isfinite(history[0]["actor/pg_loss"])
        final = trainer.rollout.weight_version
        _wait(lambda: srv.engine.weight_version >= final, msg="the last push")
        assert srv.engine.weight_version == final
        want = quant.quantize_params(trainer.actor.export_params())
        got = dict(quant.named_leaves(srv.engine.params))
        want_flat = dict(quant.named_leaves(want))
        assert got.keys() == want_flat.keys()
        assert any(n.endswith(".q") for n in got)
        for n, t in want_flat.items():
            assert got[n].dtype == t.dtype and torch.equal(got[n], t), n
        _wait(lambda: any(i["active"] and i["endpoint"] == srv.endpoint
                          for i in mgr.get_instances_status()["instances"]),
              msg="the int8 server back in the routing set")

        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, 256, n).tolist() for n in (6, 19)]
        sp = {"temperature": 0.0, "max_new_tokens": 10}
        served = [mgr.generate(f"q8-{i}", p, sp) for i, p in enumerate(prompts)]
        eng = CBEngine(decoder.get_config("tiny", dtype=torch.float32), want,
                       pad_token_id=0, kv_cache_dtype=torch.float32,
                       device="cpu", **geom)
        try:
            ref = eng.generate(prompts, SamplingParams(temperature=0.0,
                                                       max_new_tokens=10))
        finally:
            eng.stop()
        for res, r in zip(served, ref):
            assert res.success, res.error
            assert res.output_token_ids == list(r["token_ids"])
            np.testing.assert_allclose(res.output_token_logprobs,
                                       r["logprobs"], rtol=0, atol=LP_TOL)
            assert res.output_token_weight_versions == [final] * 10
    finally:
        for fn in reversed(cleanup):
            fn()
        if srv.receiver is not None:
            srv.receiver.stop()
        mgr.deregister_rollout_instance(srv.endpoint)
        srv.stop()
