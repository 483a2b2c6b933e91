"""Checkpoint/resume in the port (``utils/checkpoint.py``) on the CPU: save
gating, latest-step discovery, the manager's round trip (dtypes kept,
items independent, ``max_to_keep``, the host snapshot taken before
``save`` returns), and the trainer's resume: bitwise equal to the
uninterrupted run, an actor-only checkpoint into a critic trainer, and
``resume=disable``. The trainers run on a deterministic fake rollout, as
the pipeline tests do, so the two runs see the same rollouts; the actor's
steps are f32 on the CPU, so equality is bitwise."""

import os

import numpy as np
import pytest
import torch

from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.rewards.manager import load_reward_manager
from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
from polyrl_tpu_torch.trainer.critic import CriticConfig, StreamCritic, init_critic_params
from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
from polyrl_tpu_torch.utils import checkpoint as ckpt_lib
from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer
from test_torch_pipeline import FakeRollout


def test_should_save_gating():
    f = ckpt_lib.should_save_checkpoint
    assert f(10, 10, 0)                       # last step
    assert f(4, 10, 2)                        # save_freq boundary
    assert not f(3, 10, 2)
    assert not f(3, 10, 0)
    # a spot instance's expiry within the margin forces a save
    assert f(3, 10, 0, esi_expiry_ts=1000.0, esi_margin_s=300.0, now=800.0)
    assert not f(3, 10, 0, esi_expiry_ts=1000.0, esi_margin_s=300.0, now=600.0)


def test_esi_expiry_from_env(monkeypatch):
    monkeypatch.delenv("POLYRL_ESI_EXPIRATION_TS", raising=False)
    assert ckpt_lib.esi_expiry_from_env() is None
    monkeypatch.setenv("POLYRL_ESI_EXPIRATION_TS", "1234.5")
    assert ckpt_lib.esi_expiry_from_env() == 1234.5
    monkeypatch.setenv("POLYRL_ESI_EXPIRATION_TS", "soon")
    assert ckpt_lib.esi_expiry_from_env() is None


def test_latest_step_discovery(tmp_path):
    assert ckpt_lib.latest_step(str(tmp_path)) is None
    (tmp_path / "global_step_3").mkdir()
    (tmp_path / "global_step_12").mkdir()
    (tmp_path / "junk").mkdir()
    assert ckpt_lib.latest_step(str(tmp_path)) == 12
    assert ckpt_lib.find_latest_ckpt_path(str(tmp_path)).endswith("global_step_12")


def test_manager_roundtrip(tmp_path):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    state = {"w": w, "b": torch.ones(3, dtype=torch.bfloat16),
             "count": torch.tensor(7)}
    mgr.save(2, {"state": state}, {"global_step": 2, "dataloader": {"consumed": 8}})
    # the host copy was taken before save returned: an in-place update now
    # (the next optimizer step) does not reach the file
    w.add_(100.0)
    mgr.wait()
    assert mgr.saved_items() == {"state"}
    items, meta = mgr.restore(targets={"state", "critic"})
    assert set(items) == {"state"}  # a target not on disk is skipped
    assert meta["global_step"] == 2 and meta["dataloader"]["consumed"] == 8
    out = items["state"]
    assert torch.equal(out["w"], torch.arange(16, dtype=torch.float32).reshape(4, 4))
    assert out["b"].dtype == torch.bfloat16 and int(out["count"]) == 7
    for step in (3, 4):
        mgr.save(step, {"state": state}, {"global_step": step})
    mgr.close()
    assert sorted(os.listdir(tmp_path / "ck")) == ["global_step_3", "global_step_4"]
    assert mgr.latest_step() == 4
    assert torch.equal(mgr.restore()[0]["state"]["w"], w)


def test_manager_write_error_raises_on_wait(tmp_path):
    """A failed background write surfaces on the next ``wait`` (and so on
    the next save or restore), and leaves no step directory behind."""
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ck"))
    # an item name with a path separator: the writer cannot create its file
    mgr.save(1, {"bad": {"x": torch.ones(2)}, "state/oops": {"y": torch.ones(1)}})
    with pytest.raises(RuntimeError, match="does not exist"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.save(2, {"state": {"x": torch.ones(2)}})
    mgr.close()
    assert mgr.latest_step() == 2


def test_manager_restore_without_checkpoint(tmp_path):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore() is None and mgr.saved_items() == set()


def _make_trainer(ckpt_dir, total_steps, save_freq=1, seed=7, critic=False,
                  depth=0):
    mcfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=512,
                              max_position_embeddings=128)
    params = decoder.init_params(torch.Generator().manual_seed(0), mcfg)
    tok = ByteTokenizer()
    tcfg = TrainerConfig(
        train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
        micro_batch_size=4, min_stream_batch_size=4,
        max_prompt_length=16, max_response_length=8,
        adv_estimator="gae" if critic else "grpo", total_steps=total_steps,
        seed=seed, ckpt_dir=str(ckpt_dir), save_freq=save_freq,
        pipeline_depth=depth, rollout_is_correction=depth > 0)
    actor = StreamActor(mcfg, ActorConfig(lr=1e-4, remat=False), params)
    crit = (StreamCritic(mcfg, CriticConfig(lr=1e-4, remat=False),
                         init_critic_params(torch.Generator().manual_seed(2), mcfg))
            if critic else None)
    loader = PromptDataLoader(make_arithmetic_dataset(64), tcfg.train_batch_size,
                              seed=seed)
    return StreamRLTrainer(
        tcfg, actor, FakeRollout(), tok,
        load_reward_manager("naive", tok,
                            compute_score=lambda ds, txt, gt, ex: float(len(txt) % 5),
                            num_workers=1),
        loader, critic=crit)


def _state_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("critic", [False, True])
def test_trainer_resume_matches_uninterrupted(tmp_path, critic):
    """3 steps straight through, against 2 steps then a fresh trainer that
    resumes from the checkpoint and runs step 3: the actor's (and the
    critic's) parameters and optimizer state agree bitwise, and so does
    the dataloader's position."""
    ta = _make_trainer(tmp_path / "a", total_steps=3, critic=critic)
    ta.fit()
    tb1 = _make_trainer(tmp_path / "b", total_steps=2, critic=critic)
    tb1.fit()
    tb2 = _make_trainer(tmp_path / "b", total_steps=3, critic=critic)
    history = tb2.fit()
    assert len(history) == 1  # only step 3 ran
    assert tb2.global_step == 3
    assert tb2.dataloader.consumed == ta.dataloader.consumed
    _state_equal(tb2.actor.state_dict(), ta.actor.state_dict())
    if critic:
        _state_equal(tb2.critic.state_dict(), ta.critic.state_dict())


def test_pipelined_checkpoint_saves_the_trained_steps_loader_position(tmp_path):
    """With the pipeline the producer draws the next step's records while
    a step trains; the checkpoint of a step records the loader's position
    after that step's own records, so a resume skips none."""
    t = _make_trainer(tmp_path / "p", total_steps=2, depth=1)
    t.fit()
    for step in (1, 2):
        _, meta = t._ckpt.restore(step=step)
        assert meta["dataloader"]["consumed"] == step * t.cfg.train_batch_size


def test_resume_actor_only_ckpt_into_critic_trainer(tmp_path):
    """An actor-only checkpoint resumes the actor of a trainer that now
    has a critic; the critic keeps its own initial state."""
    t1 = _make_trainer(tmp_path / "m", total_steps=1)
    t1.fit()
    t2 = _make_trainer(tmp_path / "m", total_steps=2, critic=True)
    critic0 = {k: v.clone() for k, v in t2.critic.state_dict().items()}
    assert t2._load_checkpoint()
    assert t2.global_step == 1
    _state_equal(t2.actor.state_dict(), t1.actor.state_dict())
    _state_equal(t2.critic.state_dict(), critic0)


def test_trainer_resume_disable(tmp_path):
    t1 = _make_trainer(tmp_path / "c", total_steps=1)
    t1.fit()
    t2 = _make_trainer(tmp_path / "c", total_steps=1)
    t2.cfg.resume = "disable"
    assert not t2._load_checkpoint()
    assert t2.global_step == 0
    assert np.isfinite(t2.fit()[0]["actor/pg_loss"])
