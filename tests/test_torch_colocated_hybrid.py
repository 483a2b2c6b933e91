"""The hybrid colocated + remote rollout on the port
(``tests/test_colocated_hybrid.py``'s two tests against the port's
manager, plus the hybrid as ``train.build_trainer`` assembles it with
``rollout.colocated_local=true``): the trainer's in-process engine
registers as a LOCAL instance, serves part of the batch in its time-slice
window, hands its KV pool back after each generation phase (the engine's
``_pools`` is None), takes each push in process, and a window that ends
mid-batch aborts it into token-level continuation on the remote instance.
"""

import time

import numpy as np
import pytest
import torch

from polyrl_tpu_torch import train
from polyrl_tpu_torch.config import load_config
from polyrl_tpu_torch.data.dataset import (PromptDataLoader,
                                           make_arithmetic_dataset)
from polyrl_tpu_torch.manager.client import (ManagerClient,
                                             spawn_rollout_manager)
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.rollout.cb_engine import CBEngine
from polyrl_tpu_torch.rollout.remote import RemoteRollout
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.rollout.serve import create_server, register_with_manager
from polyrl_tpu_torch.rollout.server import RolloutServer
from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
from polyrl_tpu_torch.trainer.stream_trainer import (StreamRLTrainer,
                                                     TrainerConfig)
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer
from tests.fake_engine import FakeEngine

MGR_ARGS = ["--health-check-interval-s", "0.1", "--stats-poll-interval-s",
            "0.2", "--initial-local-gen-s", "8"]


@pytest.fixture(scope="module")
def hybrid_stack():
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    params = decoder.init_params(torch.Generator().manual_seed(1), cfg)
    tok = ByteTokenizer()
    eng = CBEngine(cfg, params, pad_token_id=tok.pad_token_id,
                   kv_cache_dtype=torch.float32, max_slots=8, page_size=8,
                   max_seq_len=256, prompt_buckets=(16, 32), device="cpu")
    local_srv = RolloutServer(eng, host="127.0.0.1", port=0).start()
    # the remote stub emits ids inside the tiny vocabulary (512)
    remote = FakeEngine(token_delay_s=0.1, start_token=300).start()
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=MGR_ARGS)
    mgr = ManagerClient(f"127.0.0.1:{port}")
    try:
        mgr.wait_healthy()
        register_with_manager(local_srv, mgr.endpoint.replace("http://", ""),
                              is_local=True)
        assert local_srv.receiver is None  # a local instance takes no fabric
        mgr.register_rollout_instance(remote.endpoint)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10:
            st = mgr.get_instances_status()
            if sum(1 for i in st["instances"] if i["healthy"]) >= 2:
                break
            time.sleep(0.1)
        yield cfg, params, tok, eng, local_srv, remote, mgr
    finally:
        proc.kill()
        proc.wait(timeout=10)
        remote.stop()
        local_srv.stop()


def test_hybrid_fit_serves_locally_and_releases(hybrid_stack):
    cfg, params, tok, eng, local_srv, remote, mgr = hybrid_stack
    rollout = RemoteRollout(mgr, local_server=local_srv,
                            pad_token_id=tok.pad_token_id)
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="grpo", total_steps=2, temperature=1.0)
    actor = StreamActor(cfg, ActorConfig(lr=1e-4, remat=False), params)
    trainer = StreamRLTrainer(
        tcfg, actor, rollout, tok,
        load_reward_manager("naive", tok, num_workers=1),
        PromptDataLoader(make_arithmetic_dataset(16), 4))
    served0 = eng.total_tokens_served
    history = trainer.fit()

    assert len(history) == 2 and trainer.global_step == 2
    assert eng.total_tokens_served > served0  # the local engine served
    assert eng.weight_version >= 3  # bootstrap + a swap a step, in process
    for (_, a), (_, e) in zip(sorted(_named(actor.export_params())),
                              sorted(_named(eng.params))):
        assert torch.equal(a.detach(), e)
    assert eng._pools is None  # the KV pool went back to training
    assert trainer._max_local_gen_s is not None
    assert history[0]["training/max_local_gen_s"] > 0
    assert rollout.dropped_groups == 0
    for h in history:
        assert "goodput/attributed_frac" in h and "training/entropy" in h
    # a third generation phase after the release serves again
    rollout.update_weights(actor.export_params())
    chunks = list(rollout.generate_stream(
        [[5, 3, 9, 2]] * 2, SamplingParams(temperature=0.0, max_new_tokens=4),
        group_size=2, min_emit=2, max_local_gen_s=8.0))
    assert sum(len(c) for c in chunks) == 2
    assert eng._pools is None


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, prefix + k + ".")
        else:
            yield prefix + k, v


def test_window_abort_continues_on_remote(hybrid_stack):
    """A 0.05 s window makes the manager abort the local engine mid-batch;
    the aborted requests continue on the remote instance from their
    salvaged tokens and every group completes at full length."""
    cfg, params, tok, eng, local_srv, remote, mgr = hybrid_stack
    rollout = RemoteRollout(mgr, local_server=local_srv,
                            pad_token_id=tok.pad_token_id)
    prompts = [[7, 1, 4, 2]] * 8
    chunks = list(rollout.generate_stream(
        prompts, SamplingParams(temperature=0.0, max_new_tokens=16),
        group_size=2, min_emit=8, max_local_gen_s=0.05))
    got = sorted(i for c in chunks for i, _ in c)
    assert got == list(range(8))
    for c in chunks:
        for _, res in c:
            assert len(res.output_token_ids) == 16
    assert rollout.dropped_groups == 0
    assert eng._pools is None


def test_build_trainer_hybrid_with_a_remote_server():
    """``rollout.colocated_local=true`` through ``train.build_trainer``: the
    local engine behind a ``RolloutServer`` on 127.0.0.1, registered through
    the trainer's client, serves beside a remote port server that takes
    the fabric's pushes; after the fit the local engine holds the actor's
    weights bitwise at version 1 + steps, its KV released, and both
    engines served tokens."""
    proc, port = spawn_rollout_manager("127.0.0.1:0", extra_args=MGR_ARGS)
    srv = create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                        dtype="float32", max_slots=8, page_size=8,
                        max_seq_len=256, num_pages=128,
                        prompt_buckets=(16, 32))
    cleanup: list = []
    try:
        mgr = ManagerClient(f"127.0.0.1:{port}")
        mgr.wait_healthy()
        ep = mgr.endpoint.replace("http://", "")
        steps = 2
        cfg = load_config(None, [
            "device=cpu", "model.preset=tiny", "model.dtype=float32",
            "rollout.mode=disaggregated", "rollout.colocated_local=true",
            f"rollout.manager_endpoint={ep}", "rollout.transfer_streams=2",
            "rollout.max_slots=8", "rollout.page_size=8",
            "rollout.max_seq_len=256", "rollout.num_pages=128",
            "rollout.prompt_buckets=[16,32]", "trainer.train_batch_size=4",
            "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=8",
            "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
            "trainer.max_prompt_length=16", "trainer.max_response_length=8",
            f"trainer.total_steps={steps}", "trainer.seed=1",
            "actor.lr=1e-3", "actor.remat=false", "data.arithmetic_size=16"])
        trainer = train.build_trainer(
            cfg, cleanup, compute_score=lambda src, text, gt, extra: float(
                len(text.encode("utf-8"))))
        rollout = trainer.rollout
        local = rollout.local_server
        assert local is not None and local.endpoint.startswith("127.0.0.1:")
        assert local.endpoint in [i["endpoint"] for i in
                                  mgr.get_instances_status()["instances"]]
        register_with_manager(srv, ep, transfer_streams=2)
        rollout.pool.wait_for_member(srv.endpoint, 30.0, active=False)
        history = trainer.fit()
        assert len(history) == steps
        for h in history:
            assert np.isfinite(h["actor/pg_loss"]) and h["actor/grad_norm"] > 0
            assert h["training/max_local_gen_s"] > 0
            assert 0.0 < h["goodput/attributed_frac"] <= 1.05
        assert rollout.dropped_groups == 0
        eng = local.engine
        assert eng.weight_version == rollout.weight_version
        for (_, a), (_, e) in zip(sorted(_named(trainer.actor.export_params())),
                                  sorted(_named(eng.params))):
            assert torch.equal(a.detach(), e)
        assert eng._pools is None
        assert eng.total_tokens_served > 0
        assert srv.engine.total_tokens_served > 0
    finally:
        for fn in reversed(cleanup):
            fn()
        srv.stop()
        proc.kill()
        proc.wait(timeout=10)
