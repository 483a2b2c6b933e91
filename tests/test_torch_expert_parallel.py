"""Expert parallelism over ``ep`` and MoE under ``tp``
(``polyrl_tpu_torch/parallel/expert.py``) on the CPU, against the JAX
package and the port's one-process run.

Mirrors ``tests/test_moe.py``'s ``test_moe_expert_parallel_mesh`` and
``test_moe_packed_logprobs_under_ep_match_single``. Training: one spawned
4-rank gloo world (``tests/torch_dist_pp.py``) runs ep 2 x tp 2, fsdp 2 x
ep 2 and ep 2 x pp 2 (the MoE layers inside the pipeline's stages) on
moe-tiny in f32 (capacity factor 2.0 = E/k: dropless, so a stage's token
groups of one microbatch route as one process's do):

- the logits and the padded and packed logprobs (and entropy) against the
  JAX forward on a (fsdp 2, tp 2, ep 2) mesh of host devices, whose GSPMD
  program shards the experts by ``param_specs``, within 2e-4, and against
  one process within 1e-5;
- one micro's whole gradient, leaf by leaf on every rank, against one
  process's within rtol 1e-5 / atol 1e-6: the expert blocks, and the
  router, whose share on a rank is its experts' (and, under tp, its
  width slices'), summed over ep and tp; the same gradient with the sum
  over ep, then over tp, left out must miss it.

Serving (one process): ``CBEngine(tp=2)`` on moe-tiny, each shard holding
a half of every expert's width and the whole router, against the one-shard
engine and the JAX tp=2 engine: greedy tokens equal, logprobs within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu.trainer import actor as jactor
from tests import torch_dist_pp as T
from tests.torch_dist import load, packed_feed, run_world, tp_feed, tp_micro_grads

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
ONE_TOL = dict(rtol=1e-5, atol=1e-5)
ONE_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LP_TOL = dict(rtol=5e-4, atol=5e-4)
LAYOUTS = list(T.EP_LAYOUTS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep_world")
    run_world([f"ep_{k}" for k in LAYOUTS], 4, root, timeout=240)
    return root


def _ranks(world, layout):
    return [load(world, f"ep_{layout}", r) for r in range(4)]


def _jax_tree(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                  params)


def _jcfg():
    return jdec.get_config("moe-tiny", dtype=jnp.float32, vocab_size=128)


@pytest.fixture(scope="module")
def jax_side(devices8):
    """The JAX GSPMD forward on fsdp 2 x tp 2 x ep 2, the experts placed
    by ``param_specs``: logits, padded logprobs/entropy, packed ones."""
    jcfg = _jcfg()
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=1, fsdp=2, tp=2, ep=2), devices8)
    specs = jdec.param_specs(jcfg)
    assert specs["layers"]["we_gate"] == jax.sharding.PartitionSpec(
        None, jmesh.EP, jmesh.FSDP, jmesh.TP)
    sharded = jmesh.shard_params(mesh, _jax_tree(T.moe_model()[1]), specs)
    out = {}
    with mesh:
        f = {k: jnp.asarray(v) for k, v in T.hidden_feed("full").items()}
        out["logits"] = np.asarray(jax.jit(lambda p: jdec.forward(
            p, jcfg, f["input_ids"], f["positions"], f["attention_mask"])[0])(
                sharded))
        tf = {k: jnp.asarray(v) for k, v in tp_feed().items()}
        lp, ent = jax.jit(lambda p: jactor._model_logprobs_entropy(
            p, jcfg, tf["input_ids"], tf["positions"], tf["attention_mask"],
            tf["responses"], tf["response_mask"], False, True))(sharded)
        out["lp"] = [np.asarray(lp), np.asarray(ent)]
        pf = {k: jnp.asarray(v) for k, v in packed_feed().items()}
        lp, ent = jax.jit(lambda p: jactor._packed_logprobs_entropy(
            p, jcfg, pf["input_ids"], pf["positions"], pf["attention_mask"],
            pf["segment_ids"], False, True, loss_mask=pf["loss_mask"]))(sharded)
        out["packed"] = [np.asarray(lp), np.asarray(ent)]
    return out


@pytest.fixture(scope="module")
def one_process():
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.trainer.actor import (ActorConfig, StreamActor,
                                                _to_device)

    cfg, params = T.moe_model()
    actor = StreamActor(cfg, ActorConfig(remat=False, use_kl_loss=False), params)
    f = _to_device(T.hidden_feed("full"), "cpu")
    with torch.no_grad():
        h = decoder.forward_hidden(actor.params, cfg, f["input_ids"],
                                   f["positions"], f["attention_mask"]).numpy()
    grads = tp_micro_grads(
        StreamActor(cfg, ActorConfig(remat=True, use_kl_loss=False),
                    T.moe_model()[1]), tp_feed())
    return {"full": h,
            "lp": [t.numpy() for t in actor.compute_log_prob(tp_feed())],
            "packed": [t.numpy() for t in
                       actor.compute_log_prob_packed(packed_feed())],
            "grads": {n: g.numpy() for n, g in grads.items()},
            "lm_head": params["lm_head"].numpy()}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_logits_under_ep_match(world, jax_side, one_process, layout):
    for got in _ranks(world, layout):
        np.testing.assert_allclose(got["full"], one_process["full"], **ONE_TOL)
        np.testing.assert_allclose(got["full"] @ one_process["lm_head"],
                                   jax_side["logits"], **FWD_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["lp", "packed"])
def test_moe_logprobs_under_ep_match(world, jax_side, one_process, layout, kind):
    """Padded and packed logprobs and entropy (the JAX
    ``test_moe_packed_logprobs_under_ep_match_single``)."""
    keep = (tp_feed()["response_mask"] if kind == "lp"
            else packed_feed()["loss_mask"]) > 0
    for got in _ranks(world, layout):
        for g, w, j in zip(got[kind], one_process[kind], jax_side[kind]):
            np.testing.assert_allclose(g, w, **ONE_TOL)
            np.testing.assert_allclose(np.where(keep, g, 0), np.where(keep, j, 0),
                                       **FWD_TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_gradient_under_ep_matches_one_process(world, one_process, layout):
    """Every leaf on every rank, the router and the expert blocks
    included; a rank holds ``E/ep`` experts (of ``F/tp`` width)."""
    want = one_process["grads"]
    assert {"layers.router", "layers.we_gate", "layers.we_down"} <= set(want)
    axes = T.EP_LAYOUTS[layout]
    for rank, got in enumerate(_ranks(world, layout)):
        assert set(got["grads"]) == set(want)
        for name, g in want.items():
            np.testing.assert_allclose(got["grads"][name], g,
                                       err_msg=f"rank {rank} {name}",
                                       **ONE_GRAD_TOL)
        if axes.get("fsdp", 1) == 1:
            n_l, e = 2 // axes.get("pp", 1), 4 // axes["ep"]
            f = 96 // axes.get("tp", 1)
            assert got["expert_shapes"]["layers.we_gate"] == (n_l, e, 64, f)
            assert got["expert_shapes"]["layers.we_down"] == (n_l, e, f, 64)


@pytest.mark.parametrize("case", ["ep", "tp"])
def test_router_gradient_needs_its_sums(world, one_process, case):
    """The leaf-by-leaf check sees a router gradient left unsummed over
    ep (every layout) or over tp (ep 2 x tp 2)."""
    want = one_process["grads"]["layers.router"]
    layouts = LAYOUTS if case == "ep" else ["ep_tp"]
    for layout in layouts:
        for got in _ranks(world, layout):
            bad = got[f"router_no_{case}_sum"]
            assert not np.allclose(bad, want, **ONE_GRAD_TOL), layout


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_checkpoint_resumes_across_meshes(world, layout):
    """A one-process MoE actor's whole state loaded into the ep mesh's
    expert blocks and gathered back over ep (and fsdp, tp) is bitwise the
    same."""
    assert all(got["resume"] for got in _ranks(world, layout))


# -- serving: CBEngine(tp=2) on a MoE config -------------------------------

GEOM = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=64,
            num_pages=64)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


@pytest.fixture(scope="module")
def moe_pair():
    from polyrl_tpu_torch.models.convert import params_from_numpy

    jcfg = jdec.get_config("moe-tiny", dtype=jnp.float32)
    jparams = jdec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu", torch.float32)
    return jcfg, jparams, tparams


def _port_engine(params, tp=1):
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    cfg = decoder.get_config("moe-tiny", dtype=torch.float32)
    return CBEngine(cfg, params, kv_cache_dtype=torch.float32, device="cpu",
                    tp=tp, prompt_buckets=(8, 16), **GEOM)


def _run(eng):
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    try:
        out = eng.generate(PROMPTS, SamplingParams(
            temperature=0.0, max_new_tokens=8, stop_token_ids=()), timeout=120.0)
    finally:
        eng.stop()
    return [o["token_ids"] for o in out], [o["logprobs"] for o in out]


def test_moe_tp_engine_matches_one_shard_and_the_jax_tp_engine(moe_pair,
                                                               devices8):
    """``serve --tp 2`` on a MoE model: two cpu shards, each with half of
    every expert's width and the whole router, give the one-shard
    engine's and the JAX tp=2 engine's greedy tokens, logprobs within
    5e-4."""
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP

    jcfg, jparams, tparams = moe_pair
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=1, tp=2), devices8[:2])
    jeng = JEngine(jcfg, jparams, mesh=mesh, pad_token_id=0,
                   kv_cache_dtype=jnp.float32, max_slots=4, page_size=8,
                   max_seq_len=64, prompt_buckets=(8, 16), num_pages=64)
    try:
        jout = jeng.generate(PROMPTS, JSP(temperature=0.0, max_new_tokens=8,
                                          stop_token_ids=()), timeout=120.0)
    finally:
        jeng.stop()
    eng = _port_engine(tparams, tp=2)
    assert eng.params[0]["layers"]["we_gate"].shape == (2, 4, 64, 48)
    assert eng.params[1]["layers"]["we_down"].shape == (2, 4, 48, 64)
    assert eng.params[0]["layers"]["router"].shape == (2, 64, 4)
    got_t, got_lp = _run(eng)
    want_t, want_lp = _run(_port_engine(tparams))
    assert got_t == want_t == [o["token_ids"] for o in jout]
    for lp, w, o in zip(got_lp, want_lp, jout):
        np.testing.assert_allclose(lp, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lp, o["logprobs"], **LP_TOL)


def test_moe_int8_tree_shards_like_its_base(moe_pair):
    """An int8 MoE tree (``quant.quantize_params``: every expert's ``q``
    and per-output ``scale``) on two shards: each shard holds its slice of
    ``q`` and of a column-split ``scale``, the row-split ``we_down``'s
    scale whole; greedy tokens and logprobs those of the one-shard int8
    engine."""
    from polyrl_tpu_torch.models import quant

    _j, _jp, tparams = moe_pair
    q8 = quant.quantize_params(tparams)
    eng = _port_engine(q8, tp=2)
    lp = eng.params[0]["layers"]
    assert lp["we_gate"].q.shape == (2, 4, 64, 48)
    assert lp["we_gate"].scale.shape == (2, 4, 48)
    assert lp["we_down"].q.shape == (2, 4, 48, 64)
    assert lp["we_down"].scale.shape == (2, 4, 64)
    got_t, got_lp = _run(eng)
    want_t, want_lp = _run(_port_engine(q8))
    assert got_t == want_t
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
