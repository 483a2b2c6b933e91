"""The port's multi-process trainer on the CPU: spawned gloo worlds
(``tests/torch_dist.py``), each started once for the module, every case
asserted in a test of its own.

- The rank-0 control plane (``parallel/multihost.py``): ``broadcast_obj``
  and ``broadcast_batch`` round trips bit for bit, the ``end``/``error``
  tags, and a reward error on rank 0 reaching rank 1 as an error, not a
  hang.
- ``shard_params`` of the converted JAX tree, gathered by the fsdp
  collective, is the tree bit for bit (2 and 4 ranks).
- One fit step of the tiny preset (a deterministic rollout on rank 0,
  the response-length reward, the KL loss against a mesh-free reference):
  GRPO at fsdp 2, GRPO at dp 2 x fsdp 2 (4 ranks), PPO with a critic at
  fsdp 2, LoRA (rank 4, the adapters sharded) at fsdp 2, and GRPO on
  packed rows at sp 2 (Ulysses). The gathered
  parameters are bitwise equal on every rank (a digest per rank, as
  ``tests/multihost_fit_worker.py`` compares sums) and within ``FIT_TOL``
  (rtol 2e-5, atol 1e-4) of the one-process port fit on the same seed,
  which the port's one-process tests hold against the JAX package. The
  atol is a tenth of the learning rate: one AdamW step moves an entry by
  about lr * g / (|g| + eps), and where |g| is near 0 the f32 summation
  order (rows and columns summed on other ranks) moves that ratio.
- The packed logprob pass at sp 2, Ulysses and ring, against one process
  on the same pack (the mirror of the JAX
  ``test_packed_logprobs_under_sp_match_single``), within 1e-5.
- A checkpoint written by 2 ranks restores into 1, and one written by 1
  into 2, bit for bit.
- ``python -m polyrl_tpu_torch.train`` under a 2-rank launch
  (``parallel.fsdp=2``, ``parallel.backend=gloo``, ``device=cpu``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from tests.torch_dist import (ROOT, _free_port, fit_trainer, load, packed_feed,
                              run_world, whole_params)

FIT_TOL = dict(rtol=2e-5, atol=1e-4)
LP_TOL = dict(rtol=1e-5, atol=1e-5)
FITS = {  # task: (world, one-process overrides)
    "fit_fsdp": (2, {}),
    "fit_dp_fsdp": (4, {}),
    "fit_ppo_fsdp": (2, dict(adv_estimator="gae")),
    "fit_lora_fsdp": (2, dict(lora_rank=4)),
    "fit_sp_packed": (2, dict(use_remove_padding=True, pack_len=32,
                              micro_token_budget=64)),
}


def _save_jax_tiny(path):
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    tree = jdec.init_params(jax.random.PRNGKey(0), cfg)
    flat = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One 2-rank and one 4-rank world, after the inputs they read: the
    JAX tiny tree and a one-process checkpoint."""
    root = tmp_path_factory.mktemp("worlds")
    for w in ("w2", "w4"):
        (root / w).mkdir()
        _save_jax_tiny(root / w / "jax_tiny.npz")
    one = fit_trainer(ckpt_dir=str(root / "w2" / "ckpt_one"), save_freq=1)
    one.fit()
    run_world(["broadcast", "shard_gather", "fit_fsdp", "fit_ppo_fsdp",
               "fit_lora_fsdp", "fit_sp_packed", "packed_logprobs", "ckpt_write", "ckpt_read"],
              2, root / "w2", timeout=240)
    run_world(["shard_gather", "fit_dp_fsdp"], 4, root / "w4", timeout=240)
    return {2: root / "w2", 4: root / "w4", "one_state": one.actor.state_dict()}


@pytest.fixture(scope="module")
def one_process_fits():
    """The one-process port fits the worlds are held to."""
    out = {}
    for task, (_, kw) in FITS.items():
        key = tuple(sorted(kw.items()))
        if key not in out:
            t = fit_trainer(**kw)
            hist = t.fit()
            out[key] = (whole_params(t), hist)
    return {task: out[tuple(sorted(kw.items()))] for task, (_, kw) in FITS.items()}


def test_broadcast_obj_round_trip(worlds):
    got = load(worlds[2], "broadcast", 1)["obj"]
    assert got["a"] == [1, 2.5, "x"]
    np.testing.assert_array_equal(got["b"], np.arange(5))


def test_broadcast_batch_round_trip_is_bitwise(worlds):
    """The header and the one raw-bytes round rebuild every array bit for
    bit, dtype and shape included, with the non-tensors and meta."""
    r0, r1 = load(worlds[2], "broadcast", 0), load(worlds[2], "broadcast", 1)
    assert r1["kind"] == "batch"
    for k, v in r0["tensors"].items():
        w = r1["tensors"][k]
        assert w.dtype == v.dtype and w.shape == v.shape
        assert w.tobytes() == v.tobytes(), k
    assert r1["non_tensors"] == r0["non_tensors"] and r1["meta"] == {"step": 4}


def test_broadcast_batch_end_and_error_tags(worlds):
    r1 = load(worlds[2], "broadcast", 1)
    assert r1["end"] == ("end", None) and r1["error"] == ("error", "boom")


def test_reward_error_reaches_every_rank(worlds):
    """Rank 0's reward raises; rank 1 leaves its collective with an error
    naming it (the world ended, so nobody hung)."""
    assert load(worlds[2], "broadcast", 0)["reward_error"].startswith(
        "ValueError: reward exploded")
    err = load(worlds[2], "broadcast", 1)["reward_error"]
    assert err.startswith("RuntimeError") and "reward exploded" in err


@pytest.mark.parametrize("world", [2, 4])
def test_shard_gather_of_converted_tree_is_bitwise(worlds, world):
    for r in range(world):
        res = load(worlds[world], "shard_gather", r)
        assert res["equal"]


@pytest.mark.parametrize("task", list(FITS))
def test_fit_params_bitwise_equal_on_every_rank(worlds, task):
    world = FITS[task][0]
    digests = {load(worlds[world], task, r)["digest"] for r in range(world)}
    assert len(digests) == 1


@pytest.mark.parametrize("task", list(FITS))
def test_fit_matches_one_process(worlds, one_process_fits, task):
    """The step's parameters (actor, and the critic under PPO) and its
    loss metrics against the one-process fit on the same seed."""
    world = FITS[task][0]
    got = load(worlds[world], task, 0)
    want, hist = one_process_fits[task]
    for item, tree in want.items():
        for k, v in tree.items():
            np.testing.assert_allclose(got["params"][item][k].numpy(), v.numpy(),
                                       err_msg=f"{item} {k}", **FIT_TOL)
    for k in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm",
              "critic/vf_loss"):
        if k in hist[-1]:
            np.testing.assert_allclose(got["history"][-1][k], hist[-1][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    init = whole_params(fit_trainer(**FITS[task][1]))["actor"]
    moved = max(float((got["params"]["actor"][k] - v).abs().max())
                for k, v in init.items())
    assert moved > 1e-4  # the step trained


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_packed_logprobs_under_sp_match_single(worlds, mode):
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=128)
    actor = StreamActor(cfg, ActorConfig(remat=False),
                        decoder.init_params(torch.Generator().manual_seed(0), cfg))
    lp, ent = actor.compute_log_prob_packed(packed_feed())
    for r in range(2):
        got_lp, got_ent = load(worlds[2], "packed_logprobs", r)[mode]
        np.testing.assert_allclose(got_lp, lp.numpy(), **LP_TOL)
        np.testing.assert_allclose(got_ent, ent.numpy(), **LP_TOL)


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_checkpoint_of_two_ranks_restores_into_one(worlds):
    written = load(worlds[2], "ckpt_write", 0)["state"]
    one = fit_trainer(ckpt_dir=str(worlds[2] / "ckpt_write" / "ckpt_world"))
    assert one._load_checkpoint() and one.global_step == 1
    _assert_state_equal(one.actor.state_dict(), written)


def test_checkpoint_of_one_process_restores_into_two(worlds):
    for r in range(2):
        res = load(worlds[2], "ckpt_read", r)
        assert res["step"] == 1
        _assert_state_equal(res["state"], worlds["one_state"])


def test_train_cli_under_a_two_rank_launch(tmp_path):
    """``python -m polyrl_tpu_torch.train`` as torchrun starts it (the
    launcher's environment) at fsdp 2 over gloo on the CPU, on the import
    tests' PPO path (critic, packed rows, the pipelined producer,
    validation, checkpoints): both ranks train two steps and exit 0; rank
    0 alone logs the steps and writes the checkpoint."""
    from tests.test_torch_imports import PPO_CLI

    port = _free_port()
    ck = tmp_path / "ck"
    cli = ["device=cpu", "parallel.fsdp=2", "parallel.backend=gloo",
           "trainer.total_steps=2", f"trainer.ckpt_dir={ck}",
           "logging.backends=[jsonl]", *PPO_CLI]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "polyrl_tpu_torch.train", *cli,
             f"logging.path={tmp_path / f'm{r}.jsonl'}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-3000:] for o in outs)
    log0 = (tmp_path / "m0.jsonl").read_text()
    assert log0.count('"training/global_step"') == 2 and "critic/vf_loss" in log0
    assert not (tmp_path / "m1.jsonl").exists() or \
        "training/global_step" not in (tmp_path / "m1.jsonl").read_text()
    assert sorted(p.name for p in ck.iterdir()) == ["global_step_2"]
