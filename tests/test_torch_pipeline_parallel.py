"""The pipeline over ``pp`` (``polyrl_tpu_torch/parallel/pipeline.py``) on
the CPU, against the JAX package's ``make_pipeline_layers_fn`` and the
port's one-process forward.

Mirrors ``tests/test_pipeline.py`` case by case. The port's ranks run in
spawned gloo worlds (``tests/torch_dist_pp.py``): one 4-rank world runs
fsdp 2 x pp 2, tp 2 x pp 2 and sp 2 x pp 2 (the ring inside the stages),
one 8-rank world the JAX tests' own fsdp 2 x tp 2 x pp 2. The JAX side runs
its pipeline on a mesh of the ``devices8`` host devices. Tolerances are
the JAX tests' own (forward 2e-4, gradients rtol 5e-4 / atol 5e-5); the
port's one-process run holds the forwards within 1e-5 and the gradients
within rtol 1e-5 / atol 1e-6 (f32; the pipeline adds no arithmetic, the
tp partial sums and the microbatches' gradient sums add in another
order).

A 2-rank world runs ``train.build_trainer`` itself at ``parallel.pp=2``
and at ``parallel.ep=2`` for one fit step each.

The gradient cases hold every leaf on every rank: ``embed`` (its
gradient reaches stage 0 only and is summed over pp), ``final_norm``,
``lm_head`` and the critic's ``value_head`` (whole on every rank already:
summed again they would be ``pp`` times too large), each stage's layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu.parallel.pipeline import make_pipeline_layers_fn as jpipeline
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu.trainer import critic as jcritic
from tests import torch_dist_pp as T
from tests.torch_dist import fit_trainer, load, packed_feed, run_world, tp_feed

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
ONE_TOL = dict(rtol=1e-5, atol=1e-5)
ONE_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=2e-5, atol=1e-4)
FOUR = ("fsdp_pp", "tp_pp", "sp_pp")
WORLD_OF = {**{k: 4 for k in FOUR}, "fsdp_tp_pp": 8}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_world")
    run_world([f"pp_{k}" for k in FOUR], 4, root, timeout=240)
    run_world(["pp_fsdp_tp_pp"], 8, root, timeout=240)
    return root


def _ranks(world, layout):
    return [load(world, f"pp_{layout}", r) for r in range(WORLD_OF[layout])]


def _jax_tree(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                                  params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jcfg():
    return jdec.get_config("tiny", dtype=jnp.float32, vocab_size=128)


@pytest.fixture(scope="module")
def jax_side(devices8):
    """The JAX pipeline's results on the JAX tests' meshes: fsdp 2 x tp 2
    x pp 2, and fsdp 2 x sp 2 x pp 2 with the ring in the stages."""
    cfg, params = T.pp_model()
    jp = _jax_tree(params)
    jc = _jax_tree(T.critic_params(cfg))
    jcfg = _jcfg()
    meshes = {False: jmesh.make_mesh(jmesh.MeshConfig(dp=1, fsdp=2, tp=2, pp=2),
                                     devices8),
              True: jmesh.make_mesh(jmesh.MeshConfig(dp=1, fsdp=2, tp=1, sp=2,
                                                     pp=2), devices8)}
    out = {}
    for ring, mesh in meshes.items():
        lf = jpipeline(mesh, jcfg, T.N_MICRO, sp_ring=ring)
        lf_r = jpipeline(mesh, jcfg, T.N_MICRO, remat=True, sp_ring=ring)
        res = out[ring] = {}
        with mesh:
            for kind in ("full", "pad"):
                f = T.hidden_feed(kind)
                res[kind] = np.asarray(jax.jit(lambda p, f=f: jdec.forward(
                    p, jcfg, jnp.asarray(f["input_ids"]),
                    jnp.asarray(f["positions"]),
                    jnp.asarray(f["attention_mask"]), layers_fn=lf)[0])(jp))
            if not ring:
                f = T.hidden_feed("ragged")
                lf4 = jpipeline(mesh, jcfg, T.ragged_n())
                res["ragged"] = np.asarray(jax.jit(lambda p: jdec.forward(
                    p, jcfg, jnp.asarray(f["input_ids"]),
                    jnp.asarray(f["positions"]),
                    jnp.asarray(f["attention_mask"]), layers_fn=lf4)[0])(jp))
            pf = {k: jnp.asarray(v) for k, v in packed_feed().items()}
            lp, ent = jax.jit(lambda p: jactor._packed_logprobs_entropy(
                p, jcfg, pf["input_ids"], pf["positions"], pf["attention_mask"],
                pf["segment_ids"], False, True, loss_mask=pf["loss_mask"],
                layers_fn=lf))(jp)
            res["packed"] = [np.asarray(lp), np.asarray(ent)]
            tf = {k: jnp.asarray(v) for k, v in tp_feed().items()}
            mask = tf["response_mask"]

            def actor_loss(p):
                lp, _ = jactor._model_logprobs_entropy(
                    p, jcfg, tf["input_ids"], tf["positions"],
                    tf["attention_mask"], tf["responses"], mask, True, False,
                    layers_fn=lf_r)
                return jnp.sum(lp * mask) / jnp.sum(mask)

            def critic_loss(p):
                v = jcritic.forward_values(
                    p, jcfg, tf["input_ids"], tf["positions"],
                    tf["attention_mask"], tf["responses"], True, layers_fn=lf_r)
                return jnp.sum(v * mask) / jnp.sum(mask)

            res["grads"] = _flat(jax.jit(jax.grad(actor_loss))(jp))
            res["critic_grads"] = _flat(jax.jit(jax.grad(critic_loss))(jc))
    return out


def _one_process_hidden(kind):
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.trainer.actor import _to_device

    cfg, params = T.pp_model()
    f = _to_device(T.hidden_feed(kind), "cpu")
    with torch.no_grad():
        return decoder.forward_hidden(params, cfg, f["input_ids"], f["positions"],
                                      f["attention_mask"]).numpy()


def _logits(h):
    return h @ T.pp_model()[1]["lm_head"].numpy()


@pytest.mark.parametrize("layout", list(WORLD_OF))
def test_pipeline_forward_matches_scan(world, jax_side, layout):
    """Every rank's outputs: the JAX pipeline's logits within 2e-4, the
    port's one-process hidden states within 1e-5."""
    want = _one_process_hidden("full")
    jwant = jax_side[layout == "sp_pp"]["full"]
    for got in _ranks(world, layout):
        np.testing.assert_allclose(got["full"], want, **ONE_TOL)
        np.testing.assert_allclose(_logits(got["full"]), jwant, **FWD_TOL)


@pytest.mark.parametrize("layout", list(WORLD_OF))
def test_pipeline_respects_padding_mask(world, jax_side, layout):
    """Right-padded rows: the valid positions match (with ``sp_pp`` the
    ring's stage attention, the JAX ``test_pipeline_sp_ring_forward_
    matches_scan``)."""
    want = _one_process_hidden("pad")[:, :8]
    jwant = jax_side[layout == "sp_pp"]["pad"][:, :8]
    for got in _ranks(world, layout):
        np.testing.assert_allclose(got["pad"][:, :8], want, **ONE_TOL)
        np.testing.assert_allclose(_logits(got["pad"])[:, :8], jwant, **FWD_TOL)


def _one_process_grads():
    from polyrl_tpu_torch.trainer.actor import (ActorConfig, StreamActor,
                                                _to_device)
    from polyrl_tpu_torch.trainer.critic import CriticConfig, StreamCritic

    cfg, params = T.pp_model()
    feed = _to_device(tp_feed(), "cpu")
    actor = StreamActor(cfg, ActorConfig(remat=True, use_kl_loss=False), params)
    critic = StreamCritic(cfg, CriticConfig(remat=True), T.critic_params(cfg))
    with torch.enable_grad():
        lp, _ = actor._forward(actor.params, feed, True, False)
        T.response_loss(lp, feed).backward()
        v = critic._values(critic.params, feed, True)
        T.response_loss(v, feed).backward()
    return ({n: p.grad.numpy() for n, p in actor._named},
            {n: p.grad.numpy() for n, p in critic._named})


@pytest.mark.parametrize("layout", list(WORLD_OF))
def test_pipeline_grads_match_scan(world, jax_side, layout):
    """Leaf by leaf on every rank, the actor's and the critic's: the JAX
    pipeline's gradient and the port's one-process one (with remat, so
    each layer is recomputed inside its stage's nested backward)."""
    want_a, want_c = _one_process_grads()
    jside = jax_side[layout == "sp_pp"]
    assert {"embed", "final_norm", "lm_head"} <= set(want_a)
    assert "value_head" in want_c
    for rank, got in enumerate(_ranks(world, layout)):
        for key, want, jwant in (("grads", want_a, jside["grads"]),
                                 ("critic_grads", want_c, jside["critic_grads"])):
            assert set(got[key]) == set(want)
            for name, g in want.items():
                msg = f"{layout} rank {rank} {key} {name}"
                np.testing.assert_allclose(got[key][name], g, err_msg=msg,
                                           **ONE_GRAD_TOL)
                np.testing.assert_allclose(got[key][name], jwant[name],
                                           err_msg=msg, **GRAD_TOL)


def test_pipeline_shape_validation():
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.parallel.mesh import AXES, Mesh
    from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn

    mesh = Mesh(tuple({"pp": 2}.get(a, 1) for a in AXES), make_groups=False)
    with pytest.raises(ValueError, match="not divisible"):
        make_pipeline_layers_fn(mesh, decoder.get_config("tiny", num_layers=3),
                                num_microbatches=2)
    cfg, params = T.pp_model()
    lf = make_pipeline_layers_fn(mesh, cfg, num_microbatches=2)
    x = torch.zeros(2, 4, cfg.hidden_size)
    with pytest.raises(ValueError, match="stage holds 1 layers"):
        lf(params["layers"], x, None, None, torch.ones(2, 4))


@pytest.mark.parametrize("layout", ["fsdp_pp", "tp_pp", "fsdp_tp_pp"])
def test_pipeline_ragged_batch_pads_and_matches(world, jax_side, layout):
    """Six rows through four microbatches (three a rank on an fsdp axis of
    2): padded with fully masked rows, sliced back, the real rows
    matching."""
    want = _one_process_hidden("ragged")
    for got in _ranks(world, layout):
        assert got["ragged"].shape == want.shape
        np.testing.assert_allclose(got["ragged"], want, **ONE_TOL)
        np.testing.assert_allclose(_logits(got["ragged"]),
                                   jax_side[False]["ragged"], **FWD_TOL)


def test_pipeline_train_step_e2e(world):
    """A GRPO fit step at fsdp 2 x pp 2 through the stream trainer: its
    history finite, the weights moved, the gathered tree the same on every
    rank and the one-process fit's within the multi-process fits' bound."""
    ranks = _ranks(world, "fsdp_pp")
    assert len({r["fit"]["digest"] for r in ranks}) == 1
    got = ranks[0]["fit"]
    assert all(np.isfinite(v) for h in got["history"] for k, v in h.items()
               if isinstance(v, float))
    trainer = fit_trainer()
    trainer.fit()
    want = {k: v.detach() for k, v in T.whole_params(trainer)["actor"].items()}
    start = T.pp_model()[1]
    assert not np.array_equal(got["params"]["actor"]["layers.wq"].numpy(),
                              start["layers"]["wq"].numpy())
    for name, w in want.items():
        np.testing.assert_allclose(got["params"]["actor"][name].numpy(),
                                   w.numpy(), err_msg=name, **FIT_TOL)


def _one_process_packed():
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    cfg, params = T.pp_model()
    actor = StreamActor(cfg, ActorConfig(remat=False), params)
    return [t.numpy() for t in actor.compute_log_prob_packed(packed_feed())]


@pytest.mark.parametrize("layout", list(WORLD_OF))
def test_pipeline_packed_segments_match_single_device(world, jax_side, layout):
    """Packed rows (segment ids into the stages' attention; with
    ``sp_pp`` the ring's, a segment spanning the sp boundary): logprobs and
    entropy against one process and against the JAX pipeline."""
    want = _one_process_packed()
    jwant = jax_side[layout == "sp_pp"]["packed"]
    keep = packed_feed()["loss_mask"] > 0
    for got in _ranks(world, layout):
        for g, w, j in zip(got["packed"], want, jwant):
            np.testing.assert_allclose(g, w, **ONE_TOL)
            np.testing.assert_allclose(np.where(keep, g, 0), np.where(keep, j, 0),
                                       **FWD_TOL)


@pytest.mark.parametrize("layout", list(WORLD_OF))
def test_pipeline_checkpoint_resumes_across_meshes(world, layout):
    """A one-process actor's whole state (``state_dict``) loaded into the
    pp mesh's shards and gathered back over pp (and fsdp, tp) is bitwise
    the same: a checkpoint resumes on a different mesh."""
    assert all(got["resume"] for got in _ranks(world, layout))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("build_world")
    run_world(["build"], 2, root, timeout=240)
    return [load(root, "build", r) for r in range(2)]


@pytest.mark.parametrize("axis", list(T.BUILD_AXES))
def test_build_trainer_fits_on_a_pp_or_ep_mesh(built, axis):
    """``train.build_trainer`` at ``parallel.pp=2`` (the pipeline of
    ``pp_microbatches`` 4) and at ``parallel.ep=2`` (moe-tiny), as
    ``torchrun ... -m polyrl_tpu_torch.train`` builds it: one finite GRPO
    step, the gathered weights the same on both ranks, rank 0's engine
    pushed at the build and after the step."""
    r0, r1 = built[0][axis], built[1][axis]
    assert len(r0["history"]) == 1
    rec = r0["history"][0]
    assert np.isfinite(rec["actor/grad_norm"]) and rec["actor/grad_norm"] > 0
    assert rec["actor/nonfinite_skips"] == 0
    assert r0["digest"] == r1["digest"]
    assert r0["version"] == 2
