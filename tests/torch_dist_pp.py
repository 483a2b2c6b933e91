"""The pipeline (pp) and expert-parallel (ep) worker tasks of
``tests/torch_dist.py``'s gloo worlds, and the pieces their tests share.

A task named ``pp_<layout>`` or ``ep_<layout>`` runs every case of that
mesh layout (``PP_LAYOUTS``/``EP_LAYOUTS``) and writes one result dict
per rank. The workers import torch and the port only, never JAX; the
tests hold the results against the JAX package and against the port's
one-process run.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.torch_dist import (_mesh, digest, fit_trainer, packed_feed, tp_feed,
                              tp_micro_grads, whole_params)

# the JAX pipeline tests' mesh layouts, cut to four ranks (and the
# reference's own eight)
PP_LAYOUTS = {"fsdp_pp": dict(fsdp=2, pp=2), "tp_pp": dict(tp=2, pp=2),
              "sp_pp": dict(sp=2, pp=2),
              "fsdp_tp_pp": dict(fsdp=2, tp=2, pp=2)}
EP_LAYOUTS = {"ep_tp": dict(ep=2, tp=2), "fsdp_ep": dict(fsdp=2, ep=2),
              "ep_pp": dict(ep=2, pp=2)}
N_MICRO = 2


def pp_model(seed: int = 0):
    """tiny (2 layers, one a stage; 4 q / 2 kv heads) in f32 at
    vocabulary 128."""
    from polyrl_tpu_torch.models import decoder

    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=128)
    return cfg, decoder.init_params(torch.Generator().manual_seed(seed), cfg)


def moe_model(seed: int = 0):
    """moe-tiny (4 experts, top 2, width 96; qk-norm) in f32 at vocabulary
    128. Its capacity factor 2.0 is E/k: dropless, so token groups of any
    size route alike."""
    from polyrl_tpu_torch.models import decoder

    cfg = decoder.get_config("moe-tiny", dtype=torch.float32, vocab_size=128)
    return cfg, decoder.init_params(torch.Generator().manual_seed(seed), cfg)


def critic_params(cfg, seed: int = 1):
    from polyrl_tpu_torch.trainer.critic import init_critic_params

    return init_critic_params(torch.Generator().manual_seed(seed), cfg)


def hidden_feed(kind: str) -> dict:
    """The JAX pipeline tests' forward inputs: ``full`` ([4, 12], every
    token valid), ``pad`` (the last 4 columns masked), ``ragged`` (6 rows:
    3 a rank on an fsdp axis of 2, 6 otherwise, padded to the 4
    microbatches of ``ragged_n``)."""
    b = 6 if kind == "ragged" else 4
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 128, (b, 12)).astype(np.int64)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (b, 12)).copy()
    mask = np.ones((b, 12), np.float32)
    if kind == "pad":
        mask[:, 8:] = 0.0
    return {"input_ids": ids, "positions": pos, "attention_mask": mask}


def ragged_n() -> int:
    return 4


def response_loss(lp: torch.Tensor, feed: dict) -> torch.Tensor:
    """The gradient cases' loss: the mean response-token logprob (or
    value)."""
    mask = feed["response_mask"]
    return (lp * mask).sum() / mask.sum()


def mesh_hidden(trainer, feed: dict, layers_fn=None) -> torch.Tensor:
    """The final-norm hidden states [B, T, d] of a whole feed, whole on
    every rank: this rank's slice through its shards (tp, ep and the
    pipeline as the mesh has them), gathered over the data axes."""
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.parallel import expert
    from polyrl_tpu_torch.parallel import mesh as meshlib
    from polyrl_tpu_torch.trainer.actor import _to_device, mesh_tp

    mesh = trainer.mesh
    local = meshlib.shard_batch(mesh, _to_device(feed, trainer.device))
    with torch.no_grad():
        h = decoder.forward_hidden(
            trainer._forward_params(), trainer.model_cfg, local["input_ids"],
            local["positions"], local["attention_mask"], tp=mesh_tp(mesh),
            ep=expert.mesh_ep(mesh), layers_fn=layers_fn)
        return meshlib.unshard_batch(
            mesh, meshlib.all_gather(mesh, meshlib.DATA_AXES, h.contiguous()))


def whole_grads(trainer) -> dict:
    """Every trained leaf's whole gradient by name (a collective)."""
    sh = trainer._fsdp
    return {n: g.numpy() for n, g in zip(sh.names, sh.gather(sh.shard_grads()))}


def actor_grads(actor, feed: dict) -> dict:
    from polyrl_tpu_torch.trainer.actor import _to_device

    feed = _to_device(feed, actor.device)
    with torch.enable_grad():
        lp, _ = actor._forward(actor._forward_params(), feed, True, False)
        response_loss(lp, feed).backward()
    return whole_grads(actor)


def critic_grads(critic, feed: dict) -> dict:
    from polyrl_tpu_torch.trainer.actor import _to_device

    feed = _to_device(feed, critic.device)
    with torch.enable_grad():
        v = critic._values(critic._forward_params(), feed, True)
        response_loss(v, feed).backward()
    return whole_grads(critic)


def resume_round_trip(trainer, one) -> bool:
    """A one-process trainer's whole state loaded into a mesh trainer's
    shards and gathered back (a checkpoint written on one mesh, resumed on
    another): bitwise the same tensors."""
    state = one.state_dict()
    trainer.load_state_dict(state)
    back = trainer.state_dict()
    return set(back) == set(state) and all(torch.equal(back[k], state[k])
                                           for k in state)


def _pp_task(layout: str):
    def task(out, rank, world):
        from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn
        from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor
        from polyrl_tpu_torch.trainer.critic import CriticConfig, StreamCritic

        axes = PP_LAYOUTS[layout]
        mesh = _mesh(**axes)
        ring = axes.get("sp", 1) > 1
        cfg, params = pp_model()
        res = {}
        lf = make_pipeline_layers_fn(mesh, cfg, N_MICRO, sp_ring=ring)
        actor = StreamActor(cfg, ActorConfig(remat=False, use_kl_loss=False),
                            params, mesh=mesh, layers_fn=lf)
        for kind in ("full", "pad"):
            res[kind] = mesh_hidden(actor, hidden_feed(kind), lf).numpy()
        if not ring:
            res["ragged"] = mesh_hidden(
                actor, hidden_feed("ragged"),
                make_pipeline_layers_fn(mesh, cfg, ragged_n())).numpy()
        res["packed"] = [t.numpy() for t in actor.compute_log_prob_packed(packed_feed())]
        # the gradient cases, with remat (each layer recomputed in the
        # nested backward of its stage's steps)
        lf_r = make_pipeline_layers_fn(mesh, cfg, N_MICRO, remat=True,
                                       sp_ring=ring)
        actor = StreamActor(cfg, ActorConfig(remat=True, use_kl_loss=False),
                            pp_model()[1], mesh=mesh, layers_fn=lf_r)
        res["grads"] = actor_grads(actor, tp_feed())
        critic = StreamCritic(cfg, CriticConfig(remat=True), critic_params(cfg),
                              mesh=mesh, layers_fn=lf_r)
        res["critic_grads"] = critic_grads(critic, tp_feed())
        res["resume"] = resume_round_trip(actor, StreamActor(
            cfg, ActorConfig(use_kl_loss=False), pp_model(seed=3)[1]))
        if layout == "fsdp_pp":
            trainer = fit_trainer(mesh, pp_microbatches=N_MICRO)
            hist = trainer.fit()
            whole = whole_params(trainer)
            res["fit"] = {"digest": digest(whole), "history": hist,
                          "params": whole if rank == 0 else None}
        torch.save(res, out / f"pp_{layout}.r{rank}.pt")
    return task


def _ep_task(layout: str):
    def task(out, rank, world):
        from polyrl_tpu_torch.parallel import expert, tensor
        from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

        from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn

        mesh = _mesh(**EP_LAYOUTS[layout])
        cfg, params = moe_model()
        res = {}
        # on a pp axis the MoE layers run inside the pipeline's stages,
        # each stage's token groups one microbatch's tokens (dropless
        # here, so they route as one process does)
        lf = lf_r = None
        if mesh.shape["pp"] > 1:
            lf = make_pipeline_layers_fn(mesh, cfg, N_MICRO)
            lf_r = make_pipeline_layers_fn(mesh, cfg, N_MICRO, remat=True)
        actor = StreamActor(cfg, ActorConfig(remat=False, use_kl_loss=False),
                            params, mesh=mesh, layers_fn=lf)
        res["full"] = mesh_hidden(actor, hidden_feed("full"), lf).numpy()
        res["lp"] = [t.numpy() for t in actor.compute_log_prob(tp_feed())]
        res["packed"] = [t.numpy() for t in actor.compute_log_prob_packed(packed_feed())]

        def grads():
            a = StreamActor(cfg, ActorConfig(remat=True, use_kl_loss=False),
                            moe_model()[1], mesh=mesh, layers_fn=lf_r)
            g = tp_micro_grads(a, tp_feed())
            return {n: t.numpy() for n, t in g.items()}, a

        res["grads"], a = grads()
        res["expert_shapes"] = {n: tuple(p.shape) for n, p in a._named}
        res["resume"] = resume_round_trip(a, StreamActor(
            cfg, ActorConfig(use_kl_loss=False), moe_model(seed=3)[1]))
        # the same gradient with the router's share left unsummed over ep,
        # then over tp: the leaf-by-leaf test must see each
        real_ep = expert.ExpertParallel.shared
        expert.ExpertParallel.shared = lambda self, lp: lp
        try:
            res["router_no_ep_sum"] = grads()[0]["layers.router"]
        finally:
            expert.ExpertParallel.shared = real_ep
        if mesh.shape["tp"] > 1:
            real_tp = tensor.copy_shared

            def no_router(mesh_, lp):
                return {**real_tp(mesh_, lp), "router": lp["router"]}

            tensor.copy_shared = no_router
            try:
                res["router_no_tp_sum"] = grads()[0]["layers.router"]
            finally:
                tensor.copy_shared = real_tp
        torch.save(res, out / f"ep_{layout}.r{rank}.pt")
    return task


# the train CLI's configuration for ``build_trainer`` on 2 ranks (gloo,
# f32, the colocated engine on rank 0): one GRPO step
BUILD_OVERRIDES = [
    "device=cpu", "model.dtype=float32", "tokenizer.kind=byte",
    "data.train_path=arithmetic", "rollout.max_slots=16", "rollout.page_size=16",
    "rollout.num_pages=128", "rollout.max_seq_len=128",
    "rollout.prompt_buckets=32", "trainer.train_batch_size=2",
    "trainer.rollout_n=4", "trainer.ppo_mini_batch_size=8",
    "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=8",
    "trainer.max_prompt_length=32", "trainer.max_response_length=16",
    "trainer.adv_estimator=grpo", "trainer.total_steps=1",
    "actor.use_kl_loss=true", "actor.remat=true", "actor.lr=1e-3",
    "reward.num_workers=1", "parallel.backend=gloo", "parallel.fsdp=1"]
BUILD_AXES = {"pp": ["model.preset=tiny", "parallel.pp=2",
                     "parallel.pp_microbatches=4"],
              "ep": ["model.preset=moe-tiny", "parallel.ep=2"]}


def task_build(out, rank, world):
    """``train.build_trainer`` at pp 2 and at ep 2 (the mesh, the
    pipeline and the checks of ``train._pipeline_layers``), one fit step
    each: its record, the gathered tree's digest, the pushes rank 0's
    engine took."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    res = {}
    for name, axes in BUILD_AXES.items():
        cleanup: list = []
        trainer = build_trainer(load_config(None, BUILD_OVERRIDES + axes),
                                cleanup, compute_score=lambda *a: float(len(a[1])))
        try:
            hist = trainer.fit()
            res[name] = {"history": hist,
                         "digest": digest(trainer.actor.gather_params()),
                         "version": getattr(trainer.rollout, "weight_version",
                                            None)}
        finally:
            for fn in reversed(cleanup):
                fn()
    torch.save(res, out / f"build.r{rank}.pt")


TASKS = {**{f"pp_{k}": _pp_task(k) for k in PP_LAYOUTS},
         **{f"ep_{k}": _ep_task(k) for k in EP_LAYOUTS}, "build": task_build}
