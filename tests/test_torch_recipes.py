"""The example recipes through the port, on the CPU.

- Each ``examples/configs/*.yaml`` loads through both packages'
  ``load_config`` to the same run config, field for field. Two kinds of
  difference are stated: ``trainer.profile_dir``'s default (the port's
  ``""`` means ``<tempdir>/polyrl_profile``, the reference's is
  ``/tmp/polyrl_profile``), and the port's own fields, at their defaults.
- The north-star llama3-8b recipe with the reference worker's overrides
  (``tests/llama8b_e2e_worker.py``: disaggregated with the manager spawned
  by ``train``, the colocated local engine, speculation, packing, optimizer
  offload, remat, chunked prefill, eight fabric streams) runs one GRPO step
  through ``train.build_trainer`` and ``fit`` at narrow widths: hidden 256,
  4 q / 1 kv heads (GQA rep 4, as llama3-8b's 32 / 8), 2 layers, vocab
  2048, f32. The rest of llama3-8b stays: llama3 RoPE scaling, no
  qk-norm, an untied head.
- At those widths the port's logprobs on converted weights equal the JAX
  package's within 5e-4 (its own logprob bound): the actor's padded and
  packed passes, and greedy decoding through both CB engines (the fused
  prologue's plain chain with no norm weights, the paged attention and
  the grouped decode at rep 4).
"""

import dataclasses
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu import config as jconfig
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
from polyrl_tpu.rollout.sampling import SamplingParams as JSP
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu_torch import config as tconfig
from polyrl_tpu_torch import train
from polyrl_tpu_torch.data import packing
from polyrl_tpu_torch.data.batch import TensorBatch
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.cb_engine import STREAM_END, CBEngine
from polyrl_tpu_torch.rollout.sampling import SamplingParams
from polyrl_tpu_torch.trainer import actor as tactor

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "examples" / "configs"
RECIPE = str(CONFIGS / "stream_grpo_llama3_8b.yaml")
LP_TOL = 5e-4
# llama3-8b cut to CPU widths; rep 32/8 = 4/1 = 4
NARROW = dict(hidden_size=256, num_heads=4, num_kv_heads=1,
              intermediate_size=512, num_layers=2, vocab_size=2048)
# the port's fields the reference's RunConfig lacks
PORT_ONLY = {"device": "cuda", "parallel.backend": "nccl",
             "rollout.num_pages": 0, "rollout.steps_per_dispatch": 8}
# tests/llama8b_e2e_worker.py's overrides, less its 8-device mesh
WORKER = [
    "rollout.colocated_local=true", "rollout.max_slots=8",
    "rollout.max_seq_len=256", "rollout.spec_tokens=2",
    "trainer.train_batch_size=4", "trainer.rollout_n=2",
    "trainer.ppo_mini_batch_size=8", "trainer.micro_batch_size=8",
    "trainer.min_stream_batch_size=8", "trainer.max_prompt_length=16",
    "trainer.max_response_length=16", "trainer.total_steps=1",
    "trainer.micro_token_budget=512", "trainer.save_freq=0",
    "trainer.test_freq=0", "reward.num_workers=2",
    "logging.backends=[console]", "data.arithmetic_size=8",
]


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIGS.glob("*.yaml")))
def test_recipe_loads_like_the_reference(name):
    path = str(CONFIGS / name)
    want = _flat(dataclasses.asdict(jconfig.load_config(path)))
    got = _flat(dataclasses.asdict(tconfig.load_config(path)))
    assert set(got) - set(want) == set(PORT_ONLY)
    assert set(want) <= set(got)
    for key, default in PORT_ONLY.items():
        assert got[key] == default, key
    differ = {k for k in want if got[k] != want[k]}
    assert differ == {"trainer.profile_dir"}
    assert (got["trainer.profile_dir"], want["trainer.profile_dir"]) == (
        "", "/tmp/polyrl_profile")


def _narrow_cfgs():
    return (jdec.get_config("llama3-8b", dtype=jnp.float32, **NARROW),
            tdec.get_config("llama3-8b", dtype=torch.float32, **NARROW))


def test_llama_recipe_runs_one_step_at_narrow_width():
    """The recipe's own assembly on the port: the narrow llama3 model
    (RoPE scaling, untied head, no qk-norm), a spawned manager, the local
    engine registered as a local instance, the fabric, packing, offload
    and remat; one step's loss is finite, its goodput split within the
    wall, and the bootstrap push and the step's push both land."""
    cfg = tconfig.load_config(RECIPE, [
        "device=cpu", "model.dtype=float32",
        "model.overrides=" + repr(NARROW).replace("'", '"')] + WORKER)
    r, t = cfg.rollout, cfg.trainer
    assert (r.mode, r.colocated_local, r.spec_tokens, r.prefill_chunk,
            r.transfer_streams) == ("disaggregated", True, 2, 512, 8)
    assert t.use_remove_padding and cfg.actor.offload_optimizer
    assert cfg.actor.remat and cfg.parallel.fsdp == -1
    cleanup: list = []
    try:
        trainer = train.build_trainer(cfg, cleanup)
        m = trainer.actor.model_cfg
        assert (m.hidden_size, m.num_heads, m.num_kv_heads,
                m.intermediate_size, m.vocab_size) == (256, 4, 1, 512, 2048)
        assert m.rope_scaling is not None and m.rope_scaling.factor == 8.0
        assert not m.use_qk_norm and not m.tie_word_embeddings
        assert "lm_head" in trainer.actor.params
        srv = trainer.rollout.local_server
        assert srv.engine.spec_tokens == 2
        assert srv.engine.prefill_chunk == 512
        history = trainer.fit()
        assert len(history) == 1
        rec = history[0]
        assert np.isfinite(rec["actor/pg_loss"])
        assert 0.0 < rec["goodput/attributed_frac"] <= 1.05
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and srv.engine.weight_version < 2:
            time.sleep(0.2)
        assert srv.engine.weight_version >= 2
    finally:
        for fn in reversed(cleanup):
            fn()


def _tree(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), jcfg))


def _padded(rng, lengths, vocab, tp=16, tr=8):
    b = len(lengths)
    ids = np.zeros((b, tp + tr), np.int32)
    mask = np.zeros((b, tp + tr), np.float32)
    resp_mask = np.zeros((b, tr), np.float32)
    for i, (pl, rl) in enumerate(lengths):
        ids[i, tp - pl:tp + rl] = rng.integers(1, vocab, pl + rl)
        mask[i, tp - pl:tp + rl] = 1.0
        resp_mask[i, :rl] = 1.0
    pos = np.maximum(mask.cumsum(-1) - 1, 0).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "positions": pos,
            "responses": ids[:, tp:].copy(), "response_mask": resp_mask}


def test_llama_recipe_logprobs_match_jax():
    """The old-logprob pass, padded and on packed rows (segment ids, as
    ``use_remove_padding`` feeds it), of both actors on the same weights."""
    jcfg, tcfg = _narrow_cfgs()
    tree = _tree(jcfg)
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(remat=True),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(remat=True),
                            params_from_numpy(tree, "cpu", torch.float32))
    tensors = _padded(np.random.default_rng(1),
                      [(5, 7), (3, 2), (16, 8), (1, 1), (8, 4), (2, 8)],
                      jcfg.vocab_size)
    jl, je = ja.compute_log_prob(tensors)
    tl, te = ta.compute_log_prob(tensors)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LP_TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=LP_TOL)
    packs = list(packing.iter_packed_micros(
        TensorBatch.from_dict(tensors=tensors), 16, pack_len=24, n_rows=2,
        pad_id=0))
    assert len(packs) >= 2
    for pack, _spec in packs:
        feed = {k: np.asarray(pack[k]) for k in (
            "input_ids", "positions", "attention_mask", "segment_ids",
            "loss_mask")}
        jl, _ = ja.compute_log_prob_packed(feed)
        tl, _ = ta.compute_log_prob_packed(feed)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LP_TOL)


def _drain(q):
    """Tokens and logprobs up to the stream's end (either package's
    sentinel)."""
    toks, lps = [], []
    while True:
        item = q.get(timeout=120)
        if item is STREAM_END or not isinstance(item, dict):
            return toks, lps
        toks += item["token_ids"]
        lps += item["logprobs"]


def test_llama_recipe_engine_greedy_matches_jax():
    """Greedy decoding at rep 4: two GRPO groups of 4 (a shared prefix
    decoded grouped) and a lone request, through both engines on the same
    weights: the same tokens, logprobs within 5e-4."""
    jcfg, tcfg = _narrow_cfgs()
    tree = _tree(jcfg, seed=1)
    geom = dict(max_slots=8, page_size=8, max_seq_len=96,
                prompt_buckets=(16, 32), num_pages=96)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for n in (13, 21, 6)]
    n_group = (4, 4, 1)
    outs = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            eng = CBEngine(tcfg, params_from_numpy(tree, "cpu", torch.float32),
                           kv_cache_dtype=torch.float32, device="cpu", **geom)
            sp = SamplingParams(temperature=0.0, max_new_tokens=10)
        else:
            eng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                          kv_cache_dtype=jnp.float32, **geom)
            sp = JSP(temperature=0.0, max_new_tokens=10)
        qs = [eng.submit(f"p{i}:{j}", p, sp, group_id=f"p{i}",
                         group_size=n)
              for i, (p, n) in enumerate(zip(prompts, n_group))
              for j in range(n)]
        eng.start()
        try:
            outs[pkg] = [_drain(q) for q in qs]
        finally:
            eng.stop()
        if pkg == "port":
            assert eng.grouped_decode_dispatches > 0
    for (tt, tl), (jt, jl) in zip(outs["port"], outs["jax"]):
        assert tt == list(jt)
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LP_TOL)
