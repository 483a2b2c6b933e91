"""Spawned ``torch.distributed`` worlds on the CPU for the port's parallel
tests: gloo ranks as separate processes, each running a list of tasks and
writing its results under a directory the test reads.

Parent side: ``run_world(tasks, world, outdir, timeout)`` starts ``world``
processes (``python -m tests.torch_dist``), waits for all of them within
``timeout`` and kills them all on a timeout or a failure. Worker side:
``main`` joins the world (``parallel.distributed.initialize`` with
``device="cpu"`` and ``backend="gloo"``) and runs each task of ``TASKS``
by name; a task writes ``<outdir>/<task>.r<rank>.pt``. The workers import
torch and the port only, never JAX.

The shared pieces (the tiny fit's parts, the deterministic rollout) are
imported by the tests too, so a one-process run builds exactly what each
rank builds.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


# -- parent ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tasks: list[str], world: int, outdir: Path, timeout: float = 240.0):
    """Run ``tasks`` in a ``world``-rank gloo world; returns {rank: log}.
    Raises with the logs on a timeout or a non-zero exit."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    env.pop("JAX_PLATFORMS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(outdir / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist", str(outdir), *tasks],
            cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout} s"
                break
            if any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    texts = {r: (outdir / f"rank{r}.log").read_text() for r in range(world)}
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        raise RuntimeError(f"{world}-rank world ({tasks}): {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{t[-4000:]}" for r, t in texts.items()))
    return texts


def load(outdir: Path, task: str, rank: int = 0):
    return torch.load(outdir / task / f"{task}.r{rank}.pt", weights_only=False)


def digest(tree) -> str:
    """sha256 over a tree's leaves' bytes, in name order."""
    from polyrl_tpu_torch.models.quant import named_leaves

    h = hashlib.sha256()
    for name, t in named_leaves(tree):
        h.update(name.encode())
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# -- the tiny fit, shared by the workers and the one-process references ------


class DetRollout:
    """A deterministic engine-shaped rollout: prompt i's response is a
    function of its length and its index, of a length varying with the
    index (so GRPO groups have distinct rewards)."""

    def __init__(self):
        self.pad_token_id = 0
        self.weight_version = 0
        self.last_gen_throughput = 0.0

    def generate(self, prompts, sampling, rng=None, **kw):
        n = sampling.max_new_tokens
        out = []
        for i, p in enumerate(prompts):
            m = n - (i % 3)
            out.append({"token_ids": [40 + (len(p) * 7 + i * 13 + j) % 80
                                      for j in range(m)],
                        "logprobs": [-0.5 - 0.01 * j for j in range(m)],
                        "weight_versions": []})
        return out

    def update_weights(self, params, version=None):
        self.weight_version += 1


def _score(data_source, text, ground_truth, extra_info=None):
    return float(len(text)) / 8.0


FIT_TRAINER = dict(train_batch_size=4, rollout_n=2, ppo_mini_batch_size=8,
                   micro_batch_size=4, min_stream_batch_size=8,
                   max_prompt_length=16, max_response_length=8,
                   adv_estimator="grpo", total_steps=1, temperature=1.0)


def fit_trainer(mesh=None, sp_mode="ulysses", ckpt_dir="", lora_rank=0,
                model=None, pp_microbatches=2, **overrides):
    """The tiny fit of every world (``mesh`` None: one process): f32,
    seed 0, the KL loss against a mesh-free reference policy, a
    deterministic rollout on rank 0 (a ``NullRollout`` elsewhere) and the
    response-length reward; LoRA adapters of ``lora_rank`` when given,
    ``model`` (a dict) overriding the tiny config's fields. On a pp axis
    the actor and critic run the pipeline of ``pp_microbatches``
    (its stages ring over sp). ``overrides`` go into ``TrainerConfig``."""
    from polyrl_tpu_torch.data.dataset import PromptDataLoader, make_arithmetic_dataset
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.parallel import multihost
    from polyrl_tpu_torch.parallel.sequence import make_sp_attention
    from polyrl_tpu_torch.rewards.manager import load_reward_manager
    from polyrl_tpu_torch.trainer.actor import (ActorConfig, ReferencePolicy,
                                                StreamActor)
    from polyrl_tpu_torch.trainer.critic import (CriticConfig, StreamCritic,
                                                 init_critic_params)
    from polyrl_tpu_torch.trainer.stream_trainer import StreamRLTrainer, TrainerConfig
    from polyrl_tpu_torch.utils.tokenizer import ByteTokenizer

    tcfg = TrainerConfig(**{**FIT_TRAINER, "ckpt_dir": ckpt_dir, **overrides})
    cfg = decoder.get_config("tiny", dtype=torch.float32, **(model or {}))
    params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
    tok = ByteTokenizer()
    attn = packed = layers_fn = None
    if mesh is not None and mesh.shape["pp"] > 1:
        from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn

        layers_fn = make_pipeline_layers_fn(mesh, cfg, pp_microbatches,
                                            sp_ring=mesh.shape["sp"] > 1)
    elif mesh is not None and mesh.shape["sp"] > 1:
        attn = make_sp_attention(mesh, sp_mode)
        packed = make_sp_attention(mesh, sp_mode, packed=True)
    ref = ReferencePolicy(cfg, params)
    acfg = ActorConfig(lr=1e-3, remat=False, use_kl_loss=True,
                       lora_rank=lora_rank, lora_alpha=16.0)
    actor = StreamActor(cfg, acfg, params, mesh=mesh, attn_fn=attn,
                        layers_fn=layers_fn, packed_attn_fn=packed)
    critic = None
    if tcfg.adv_estimator == "gae":
        critic = StreamCritic(cfg, CriticConfig(lr=1e-3, remat=False),
                              init_critic_params(torch.Generator().manual_seed(1), cfg),
                              mesh=mesh, attn_fn=attn, layers_fn=layers_fn,
                              packed_attn_fn=packed)
    rollout = (DetRollout() if multihost.is_main()
               else multihost.NullRollout(pad_token_id=tok.pad_token_id))
    reward = load_reward_manager("naive", tok, compute_score=_score, num_workers=1)
    loader = PromptDataLoader(make_arithmetic_dataset(8), tcfg.train_batch_size)
    return StreamRLTrainer(tcfg, actor, rollout, tok, reward, loader,
                           critic=critic, ref_policy=ref)


def whole_params(trainer) -> dict:
    """The actor's (and critic's) whole trees as host tensors (a
    collective on a mesh)."""
    out = {"actor": {k: v.detach().clone() for k, v in
                     _flat(trainer.actor.gather_params()).items()}}
    if trainer.critic is not None:
        out["critic"] = {k: v.detach().clone() for k, v in
                         _flat(trainer.critic.state_dict()).items()
                         if k.startswith("params.")}
    return out


def _flat(tree) -> dict:
    from polyrl_tpu_torch.models.quant import flatten

    return flatten(tree)


def packed_feed(seed: int = 0, b: int = 4, t: int = 32, vocab: int = 128) -> dict:
    """Packed rows (the JAX ``test_packed_logprobs_under_sp_match_single``
    layout): three segments a row, one spanning the sp boundary, the first
    two tokens of each a prompt."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, t)).astype(np.int64)
    seg = np.zeros((b, t), np.int32)
    pos = np.zeros((b, t), np.int32)
    lm = np.zeros((b, t), np.float32)
    for s, e, sid in [(0, 12, 1), (12, 26, 2), (26, 30, 3)]:
        seg[:, s:e] = sid
        pos[:, s:e] = np.arange(e - s)
        lm[:, s + 2:e] = 1.0
    return {"input_ids": ids, "positions": pos,
            "attention_mask": (seg > 0).astype(np.float32),
            "segment_ids": seg, "loss_mask": lm}


# -- worker tasks ---------------------------------------------------------------


def _mesh(**axes):
    from polyrl_tpu_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(meshlib.MeshConfig(**{"fsdp": 1, **axes}))


def task_broadcast(out, rank, world):
    """broadcast_obj and broadcast_batch round trips (bitwise), and rank
    0's reward error reaching every rank as an error."""
    from polyrl_tpu_torch.data.batch import TensorBatch
    from polyrl_tpu_torch.parallel import multihost

    obj = {"a": [1, 2.5, "x"], "b": np.arange(5)} if rank == 0 else None
    got_obj = multihost.broadcast_obj(obj)
    rng = np.random.default_rng(3)
    batch = TensorBatch.from_dict(
        tensors={"ids": rng.integers(0, 100, (6, 7)).astype(np.int32),
                 "x": rng.normal(size=(6, 3)).astype(np.float32),
                 "m": (rng.random((6,)) > 0.5)},
        non_tensors={"gt": [f"g{i}" for i in range(6)]},
        meta_info={"step": 4})
    kind, got = multihost.broadcast_batch(("batch", batch) if rank == 0 else None)
    end = multihost.broadcast_batch(("end", None) if rank == 0 else None)
    err = multihost.broadcast_batch(("error", "boom") if rank == 0 else None)
    # a reward error on rank 0 through the trainer's broadcast path
    trainer = fit_trainer(_mesh(fsdp=world))

    def bad_reward(ib):
        raise ValueError("reward exploded")

    trainer.reward_manager = bad_reward
    from polyrl_tpu_torch.utils.metrics import MetricsTracker

    out_view = SimpleNamespace(output_ids=[9, 10], output_token_logprobs=[-1.0, -1.0])
    ib = trainer._assemble_batch([[5, 6, 7]] * 2, ["", ""], ["", ""],
                                 [out_view] * 2, [0, 0])
    reward_err = None
    try:
        trainer._process_ibatch(ib, MetricsTracker())
    except Exception as exc:  # noqa: BLE001 — the error is the result
        reward_err = f"{type(exc).__name__}: {exc}"
    torch.save({"obj": got_obj, "kind": kind,
                "tensors": {k: np.asarray(v) for k, v in got.tensors.items()},
                "non_tensors": {k: list(v) for k, v in got.non_tensors.items()},
                "meta": got.meta_info, "end": end, "error": err,
                "reward_error": reward_err},
               out / f"broadcast.r{rank}.pt")


def task_shard_gather(out, rank, world):
    """``shard_params`` then ``gather_params`` of the converted tiny tree
    (``models/convert.py``) over fsdp = world: bitwise the tree."""
    from polyrl_tpu_torch.models.convert import params_from_numpy
    from polyrl_tpu_torch.models.quant import named_leaves
    from polyrl_tpu_torch.parallel import mesh as meshlib

    arrays = dict(np.load(out.parent / "jax_tiny.npz"))
    tree = {}
    for k, v in arrays.items():
        node = tree
        *path, last = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    params = params_from_numpy(tree, "cpu", torch.float32)
    mesh = _mesh(fsdp=world)
    shards = meshlib.shard_params(mesh, params)
    back = meshlib.gather_params(mesh, shards, params)
    torch.save({"equal": digest(back) == digest(params),
                "shard_numel": sum(s.numel() for _, s in named_leaves(shards))},
               out / f"shard_gather.r{rank}.pt")


def _fit_task(name, mesh, **kw):
    def task(out, rank, world):
        trainer = fit_trainer(mesh(world), **kw)
        hist = trainer.fit()
        whole = whole_params(trainer)
        torch.save({"digest": digest(whole), "params": whole if rank == 0 else None,
                    "history": hist}, out / f"{name}.r{rank}.pt")
    return task


def task_packed_logprobs(out, rank, world):
    """The packed logprob pass on an sp = world mesh, Ulysses and ring."""
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.parallel.sequence import make_sp_attention
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=128)
    res = {}
    for mode in ("ulysses", "ring"):
        mesh = _mesh(sp=world)
        params = decoder.init_params(torch.Generator().manual_seed(0), cfg)
        actor = StreamActor(cfg, ActorConfig(remat=False), params, mesh=mesh,
                            attn_fn=make_sp_attention(mesh, mode),
                            packed_attn_fn=make_sp_attention(mesh, mode, packed=True))
        lp, ent = actor.compute_log_prob_packed(packed_feed())
        res[mode] = (lp.numpy(), ent.numpy())
    torch.save(res, out / f"packed_logprobs.r{rank}.pt")


def task_ckpt_write(out, rank, world):
    """A fit step that checkpoints (fsdp = world), then the whole state."""
    trainer = fit_trainer(_mesh(fsdp=world), ckpt_dir=str(out / "ckpt_world"),
                          save_freq=1)
    trainer.fit()
    state = trainer.actor.state_dict()
    torch.save({"state": {k: v.clone() for k, v in state.items()} if rank == 0
                else None}, out / f"ckpt_write.r{rank}.pt")


def task_ckpt_read(out, rank, world):
    """Restore a one-process checkpoint into fsdp = world shards."""
    trainer = fit_trainer(_mesh(fsdp=world), ckpt_dir=str(out.parent / "ckpt_one"))
    assert trainer._load_checkpoint()
    state = trainer.actor.state_dict()
    torch.save({"state": {k: v.clone() for k, v in state.items()},
                "step": trainer.global_step}, out / f"ckpt_read.r{rank}.pt")


def task_sp_attention(out, rank, world):
    """Every case of ``sp_cases.pt``: this rank's slice through the port's
    SP attention, forward and the gradients of sum(valid * out^2), the
    whole results gathered (rank 0 writes them); the ring's K/V rotation
    shapes recorded."""
    from polyrl_tpu_torch.parallel import mesh as meshlib
    from polyrl_tpu_torch.parallel import sequence

    cases = torch.load(out.parent / "sp_cases.pt", weights_only=False)
    shapes = []
    real_rotate = sequence._Rotate.forward

    def spy(ctx, x, mesh, axis):
        shapes.append(tuple(x.shape))
        return real_rotate(ctx, x, mesh, axis)

    sequence._Rotate.forward = staticmethod(spy)
    meshes = {}
    res = {}
    for key, case in cases.items():
        dims = case["mesh"]
        if dims not in meshes:
            meshes[dims] = _mesh(dp=dims[0], sp=dims[1])
        mesh = meshes[dims]
        fn = sequence.make_sp_attention(mesh, case["mode"], packed=case["packed"])
        local = meshlib.shard_batch(mesh, {k: torch.as_tensor(case[k]) for k in
                                           ("q", "k", "v", "mask", "seg", "valid")})
        q, k, v = (local[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
        shapes.clear()
        o = (fn(q, k, v, local["mask"], local["seg"]) if case["packed"]
             else fn(q, k, v, local["mask"]))
        loss = (torch.where(local["valid"][..., None, None] > 0, o, 0.0) ** 2).sum()
        loss.backward()
        gathered = [meshlib.unshard_batch(mesh, meshlib.all_gather(
            mesh, meshlib.DATA_AXES, x.detach().contiguous()))
            for x in (o, q.grad, k.grad, v.grad)]
        res[key] = {"out": gathered[0].numpy(),
                    "grads": [g.numpy() for g in gathered[1:]],
                    "rotated": list(shapes)}
    if rank == 0:
        torch.save(res, out / f"sp_attention.r{rank}.pt")


def tp_feed(seed: int = 5, b: int = 4, tp: int = 12, tr: int = 6,
            vocab: int = 128) -> dict:
    """A padded logprob feed (left-padded prompts, masked responses) of
    the tensor-parallel tasks."""
    rng = np.random.default_rng(seed)
    t = tp + tr
    ids = rng.integers(1, vocab, (b, t)).astype(np.int64)
    mask = np.ones((b, t), np.float32)
    for i in range(b):
        mask[i, :i] = 0.0
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    resp_mask = np.ones((b, tr), np.float32)
    resp_mask[1, -2:] = 0.0
    return {"input_ids": ids, "positions": pos, "attention_mask": mask,
            "responses": ids[:, -tr:], "response_mask": resp_mask,
            "advantages": rng.normal(size=(b, tr)).astype(np.float32),
            "old_log_probs": (-rng.random((b, tr)) - 1.0).astype(np.float32)}


# the tensor-parallel tasks' variants: (model overrides, LoRA rank). Qwen3's
# qk-norm weights and the LoRA adapters are replicated leaves that meet a
# rank's tp-split activations: their gradients are summed over tp
TP_VARIANTS = {"tiny": ({}, 0), "qk_norm": ({"use_qk_norm": True}, 0),
               "lora": ({}, 4)}


def tp_model(seed: int = 0, variant: str = "tiny"):
    """The tensor-parallel tasks' model: tiny (4 q / 2 kv heads) in f32
    at vocabulary 128, with ``TP_VARIANTS[variant]``'s overrides."""
    from polyrl_tpu_torch.models import decoder

    cfg = decoder.get_config("tiny", dtype=torch.float32, vocab_size=128,
                             **TP_VARIANTS[variant][0])
    return cfg, decoder.init_params(torch.Generator().manual_seed(seed), cfg)


def tp_actor(variant: str, mesh=None, remat: bool = True):
    """The variant's actor without the KL loss. LoRA adapters get a
    nonzero ``b`` (0.1 N(0, 1) from the same generator as ``a``, the same
    on every rank), so both adapters carry a gradient at the first
    micro."""
    from polyrl_tpu_torch.models import lora
    from polyrl_tpu_torch.models.quant import LoraWeight
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    cfg, params = tp_model(variant=variant)
    rank = TP_VARIANTS[variant][1]
    real = lora.wrap_lora

    def wrap_live_b(*args, **kw):
        tree = real(*args, **kw)
        for w in tree["layers"].values():
            if isinstance(w, LoraWeight):
                w.b.normal_(generator=args[1]).mul_(0.1)
        return tree

    lora.wrap_lora = wrap_live_b
    try:
        return StreamActor(cfg, ActorConfig(remat=remat, use_kl_loss=False,
                                            lora_rank=rank), params, mesh=mesh)
    finally:
        lora.wrap_lora = real


def tp_micro_grads(actor, feed) -> dict:
    """One micro's loss backward and the whole gradient by leaf name (a
    collective on a mesh: every rank's shards gathered)."""
    from polyrl_tpu_torch.trainer.actor import _to_device

    with torch.enable_grad():
        loss, _ = actor._loss_fn(_to_device(feed, actor.device), 1.0)
        loss.backward()
    if actor._fsdp is None:
        return {n: p.grad.detach().clone() for n, p in actor._named}
    sh = actor._fsdp
    return dict(zip(sh.names, sh.gather(sh.shard_grads())))


def task_tp_logprobs(out, rank, world):
    """fsdp 2 x tp 2: the padded logprob pass and entropy of ``tp_feed``,
    on tiny and on tiny with qk-norm."""
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    res = {}
    for variant in ("tiny", "qk_norm"):
        cfg, params = tp_model(variant=variant)
        actor = StreamActor(cfg, ActorConfig(remat=False), params,
                            mesh=_mesh(fsdp=2, tp=2))
        lp, ent = actor.compute_log_prob(tp_feed())
        res[variant] = {"lp": lp.numpy(), "ent": ent.numpy()}
    torch.save(res, out / f"tp_logprobs.r{rank}.pt")


def task_sp_tp(out, rank, world):
    """sp 2 x tp 2: the packed logprob pass, Ulysses and ring."""
    from polyrl_tpu_torch.parallel.sequence import make_sp_attention
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    res = {}
    for mode in ("ulysses", "ring"):
        mesh = _mesh(sp=2, tp=2)
        cfg, params = tp_model()
        actor = StreamActor(cfg, ActorConfig(remat=False), params, mesh=mesh,
                            attn_fn=make_sp_attention(mesh, mode),
                            packed_attn_fn=make_sp_attention(mesh, mode, packed=True))
        lp, ent = actor.compute_log_prob_packed(packed_feed())
        res[mode] = (lp.numpy(), ent.numpy())
    torch.save(res, out / f"sp_tp.r{rank}.pt")


def task_tp_grad(out, rank, world):
    """fsdp 2 x tp 2 with remat (each layer gathered again in the
    backward): one micro's whole gradient of every ``TP_VARIANTS`` actor,
    on every rank."""
    res = {}
    for variant in TP_VARIANTS:
        grads = tp_micro_grads(tp_actor(variant, _mesh(fsdp=2, tp=2)), tp_feed())
        res[variant] = {n: g.numpy() for n, g in grads.items()}
    torch.save(res, out / f"tp_grad.r{rank}.pt")


def task_fit_tp(out, rank, world):
    """A fit step at fsdp 2 x tp 2 on tiny with qk-norm, and one with LoRA
    adapters."""
    res = {}
    for name, kw in (("qk_norm", dict(model=TP_VARIANTS["qk_norm"][0])),
                     ("lora", dict(lora_rank=4))):
        trainer = fit_trainer(_mesh(fsdp=2, tp=2), **kw)
        hist = trainer.fit()
        whole = whole_params(trainer)
        res[name] = {"digest": digest(whole), "history": hist,
                     "params": whole if rank == 0 else None}
    torch.save(res, out / f"fit_tp.r{rank}.pt")


def task_fit_layer(out, rank, world):
    """fsdp 2 x tp 2 fits on the per-layer route and on the whole-tree
    one, at one micro a step and at two."""
    from polyrl_tpu_torch.parallel import fsdp

    res = {}
    for per_layer in (True, False):
        for micro in (8, 4):
            fsdp.PER_LAYER = per_layer
            try:
                trainer = fit_trainer(_mesh(fsdp=2, tp=2), micro_batch_size=micro)
                trainer.fit()
                res[(per_layer, micro)] = whole_params(trainer)["actor"]
            finally:
                fsdp.PER_LAYER = True
    torch.save(res if rank == 0 else {}, out / f"fit_layer.r{rank}.pt")


TASKS = {
    "tp_logprobs": task_tp_logprobs,
    "sp_tp": task_sp_tp,
    "tp_grad": task_tp_grad,
    "fit_tp": task_fit_tp,
    "fit_layer": task_fit_layer,
    "broadcast": task_broadcast,
    "shard_gather": task_shard_gather,
    "fit_fsdp": _fit_task("fit_fsdp", lambda w: _mesh(fsdp=w)),
    "fit_dp_fsdp": _fit_task("fit_dp_fsdp", lambda w: _mesh(dp=2, fsdp=w // 2)),
    "fit_ppo_fsdp": _fit_task("fit_ppo_fsdp", lambda w: _mesh(fsdp=w),
                              adv_estimator="gae"),
    "fit_lora_fsdp": _fit_task("fit_lora_fsdp", lambda w: _mesh(fsdp=w),
                               lora_rank=4),
    "fit_sp_packed": _fit_task("fit_sp_packed", lambda w: _mesh(sp=w),
                               use_remove_padding=True, pack_len=32,
                               micro_token_budget=64),
    "packed_logprobs": task_packed_logprobs,
    "ckpt_write": task_ckpt_write,
    "ckpt_read": task_ckpt_read,
    "sp_attention": task_sp_attention,
}


def main(argv: list[str]) -> int:
    from polyrl_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    outdir, tasks = Path(argv[0]), argv[1:]
    from tests.torch_dist_pp import TASKS as PP_TASKS

    TASKS.update(PP_TASKS)
    distributed.initialize(device="cpu", backend="gloo", timeout_s=120)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    try:
        for name in tasks:
            d = outdir / name
            d.mkdir(exist_ok=True)
            t0 = time.monotonic()
            TASKS[name](d, rank, world)
            print(f"task {name} done in {time.monotonic() - t0:.1f} s", flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait in a collective: no teardown
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
