"""Tensor parallelism in the port on the CPU.

Training (one spawned 4-rank gloo world for the module,
``tests/torch_dist.py``):

- the padded logprob pass and its entropy at fsdp 2 x tp 2 against the
  JAX package's sharded forward on a (fsdp 2, tp 2) mesh of host devices
  (``tests/test_model.py::test_sharded_forward_on_mesh``), within 5e-4,
  on tiny and on tiny with Qwen3's qk-norm;
- the packed pass at sp 2 x tp 2, Ulysses and ring
  (``tests/test_sequence_parallel.py``'s SP x TP cases), against one
  process within 1e-5;
- one micro's whole gradient at fsdp 2 x tp 2 with remat (each layer
  gathered again in its backward) against one process's, leaf by leaf on
  every rank, within rtol 1e-4 / atol 1e-6 (f32; the tp partial sums and
  the vocab-parallel log-sum-exp add in another order): on tiny, with
  qk-norm and with LoRA adapters (replicated leaves whose gradient is a
  rank's share, summed over tp);
- a fit step at fsdp 2 x tp 2 with qk-norm and with LoRA against the
  one-process fit within the multi-process fits' bound (rtol 2e-5, atol
  1e-4), its gathered tree bitwise equal on every rank;
- the per-layer FSDP route against the whole-tree route
  (``fsdp.PER_LAYER``) at fsdp 2 x tp 2: the fitted parameters bit for bit
  at one micro a step; at two micros a step within the multi-process
  fits' bound (rtol 2e-5, atol 1e-4, a tenth of the learning rate: the
  layer shards' gradients are reduce-scattered at each micro, the whole
  tree's summed over the micros first, and where a gradient is near 0
  AdamW's ``g / (|g| + eps)`` moves with that order).

Serving (one process, no world): the engine on two ``cpu`` shards, against
the JAX tp=2 engine and the one-shard engine (grouped decode, speculation,
int8 + LoRA trees, spill and restore), and a push through the fabric.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.parallel import mesh as jmesh
from tests.torch_dist import (TP_VARIANTS, fit_trainer, load,
                              packed_feed, run_world, tp_actor, tp_feed,
                              tp_micro_grads, tp_model, whole_params)

LP_TOL = dict(rtol=5e-4, atol=5e-4)
# the multi-process fits' bound (tests/test_torch_multihost.py's FIT_TOL)
FIT_TOL = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_world")
    run_world(["tp_logprobs", "sp_tp", "tp_grad", "fit_layer", "fit_tp"], 4,
              root, timeout=240)
    return root


def _jax_tree(params):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)


def _jax_logprobs_entropy(logits, targets):
    logp = jax.nn.log_softmax(logits, axis=-1)
    lp = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    ent = -jnp.sum(jnp.exp(logp) * logp, axis=-1)
    return np.asarray(lp), np.asarray(ent)


@pytest.mark.parametrize("variant", ["tiny", "qk_norm"])
def test_tp_logprobs_match_the_jax_sharded_forward(world, devices8, variant):
    cfg, params = tp_model(variant=variant)
    jcfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=128,
                           **TP_VARIANTS[variant][0])
    m = jmesh.make_mesh(jmesh.MeshConfig(dp=1, fsdp=2, tp=2, sp=1), devices8[:4])
    specs = jdec.param_specs(jcfg)
    sharded = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, jmesh.sharding(m, s)), _jax_tree(params),
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    feed = tp_feed()
    logits = jax.jit(lambda p, i, po, a: jdec.forward(p, jcfg, i, po, a)[0])(
        sharded, jnp.asarray(feed["input_ids"]), jnp.asarray(feed["positions"]),
        jnp.asarray(feed["attention_mask"]))
    tr = feed["responses"].shape[1]
    want_lp, want_ent = _jax_logprobs_entropy(logits[:, -tr - 1:-1],
                                              jnp.asarray(feed["responses"]))
    keep = feed["response_mask"] > 0
    for rank in range(4):
        got = load(world, "tp_logprobs", rank)[variant]
        np.testing.assert_allclose(np.where(keep, got["lp"], 0),
                                   np.where(keep, want_lp, 0), **LP_TOL)
        np.testing.assert_allclose(np.where(keep, got["ent"], 0),
                                   np.where(keep, want_ent, 0), **LP_TOL)


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_sp_tp_packed_logprobs_match_one_process(world, mode):
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    cfg, params = tp_model()
    actor = StreamActor(cfg, ActorConfig(remat=False), params)
    want_lp, want_ent = actor.compute_log_prob_packed(packed_feed())
    for rank in range(4):
        lp, ent = load(world, "sp_tp", rank)[mode]
        np.testing.assert_allclose(lp, want_lp.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ent, want_ent.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", list(TP_VARIANTS))
def test_tp_gradient_matches_one_process(world, variant):
    """Leaf by leaf on every rank, the replicated leaves that meet a
    rank's split activations (qk-norm, LoRA adapters) included: each
    rank's share summed over tp."""
    want = tp_micro_grads(tp_actor(variant), tp_feed())
    for rank in range(4):
        got = load(world, "tp_grad", rank)[variant]
        assert set(got) == set(want)
        for name, g in want.items():
            assert got[name].shape == tuple(g.shape), name
            np.testing.assert_allclose(got[name], g.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("variant", ["qk_norm", "lora"])
def test_tp_fit_matches_one_process(world, variant):
    """A fit step at fsdp 2 x tp 2 against the one-process fit, leaf by
    leaf within the multi-process fits' bound, and the gathered trees
    bitwise equal on every rank (no replicated copy drifts)."""
    kw = (dict(model=TP_VARIANTS["qk_norm"][0]) if variant == "qk_norm"
          else dict(lora_rank=4))
    one = fit_trainer(**kw)
    hist = one.fit()
    want = whole_params(one)["actor"]
    runs = [load(world, "fit_tp", r)[variant] for r in range(4)]
    assert len({r["digest"] for r in runs}) == 1
    got = runs[0]["params"]["actor"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **FIT_TOL)
    for k in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
        np.testing.assert_allclose(runs[0]["history"][-1][k], hist[-1][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_per_layer_fsdp_fit_is_the_whole_tree_fit(world):
    res = load(world, "fit_layer", 0)
    layer1, whole1 = res[(True, 8)], res[(False, 8)]
    assert set(layer1) == set(whole1)
    for name, w in whole1.items():
        assert torch.equal(layer1[name], w), name
    layer2, whole2 = res[(True, 4)], res[(False, 4)]
    for name, w in whole2.items():
        np.testing.assert_allclose(layer2[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=1e-4, err_msg=name)
    # the two fits differ: the second took two micros of its step
    assert any(not torch.equal(layer1[n], layer2[n]) for n in layer1)


# -- serving: one process, two cpu shards ----------------------------------------

GEOM = dict(pad_token_id=0, max_slots=4, page_size=8, max_seq_len=64,
            num_pages=64)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


def _port_engine(params, tp=1, dtype=torch.float32, **kw):
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    cfg = decoder.get_config("tiny", dtype=dtype)
    return CBEngine(cfg, params, kv_cache_dtype=dtype, device="cpu", tp=tp,
                    **{**GEOM, "prompt_buckets": (8, 16, 32), **kw})


def _greedy(n=8):
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    return SamplingParams(temperature=0.0, max_new_tokens=n, stop_token_ids=())


def _run(eng, prompts, sp):
    try:
        out = eng.generate(prompts, sp, timeout=120.0)
    finally:
        eng.stop()
    return [o["token_ids"] for o in out], [o["logprobs"] for o in out]


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny tree (f32, seed 0) and the port's copy of it through
    ``models/convert.py``."""
    from polyrl_tpu_torch.models.convert import params_from_numpy

    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    jparams = jdec.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu", torch.float32)
    return jcfg, jparams, tparams


def test_tp_engine_matches_the_jax_tp_engine(tiny_pair, devices8):
    """``tests/test_cb_engine.py``'s tp test against the port: the port's
    tp=2 engine (two cpu shards, each with its own ``[Hkv/2, N, ps, D]``
    pools) gives the JAX tp=2 engine's greedy tokens, logprobs within
    5e-4."""
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP

    jcfg, jparams, tparams = tiny_pair
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
    assert len(eng.params) == 2 and len(eng._pools) == 2
    assert eng.params[0]["layers"]["wq"].shape == (2, 64, 32)
    assert eng.params[1]["layers"]["wo"].shape == (2, 32, 64)
    assert eng.params[0]["embed"].shape == (256, 64)
    k0, k1 = eng._pools[0][0][0], eng._pools[1][0][0]
    assert k0.shape == (1, 64, 8, 16) and k0.data_ptr() != k1.data_ptr()
    got_t, got_lp = _run(eng, PROMPTS, _greedy())
    assert got_t == [o["token_ids"] for o in jout]
    for lp, o in zip(got_lp, jout):
        np.testing.assert_allclose(lp, o["logprobs"], **LP_TOL)


def _grouped(eng, prompt, g, sp):
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END

    qs = [eng.submit(f"r{i}", prompt, sp, group_id="g", group_size=g)
          for i in range(g)]
    eng.start()
    out = []
    for q in qs:
        toks, lps = [], []
        while (item := q.get(timeout=120)) is not STREAM_END:
            toks += item["token_ids"]
            lps += item["logprobs"]
        out.append((toks, lps))
    n = eng.grouped_decode_dispatches
    eng.stop()
    return out, n


def test_tp_grouped_decode_matches_tp1(tiny_pair):
    """A GRPO group (shared prompt pages, K3's route) on two shards gives
    the one-shard engine's greedy tokens and logprobs within 5e-4."""
    _j, _jp, tparams = tiny_pair
    prompt = list(range(3, 24))  # two full shared pages and a tail
    want, n1 = _grouped(_port_engine(tparams), prompt, 4, _greedy(10))
    got, n2 = _grouped(_port_engine(tparams, tp=2), prompt, 4, _greedy(10))
    assert n1 > 0 and n2 > 0
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, **LP_TOL)


def test_tp_speculation_matches_tp1(tiny_pair):
    """``tests/test_spec_decode.py``'s tp case: a tp=2 engine with
    prompt-lookup speculation gives the plain one-shard engine's greedy
    tokens."""
    _j, _jp, tparams = tiny_pair
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], [9, 8, 7, 9, 8, 7, 9]]
    want, _ = _run(_port_engine(tparams), prompts, _greedy(12))
    eng = _port_engine(tparams, tp=2, spec_tokens=3, spec_rounds=2)
    got, _ = _run(eng, prompts, _greedy(12))
    assert eng.spec_dispatches > 0
    assert got == want


def test_tp_lora_and_int8_trees_shard_like_their_base(tiny_pair):
    """``tests/test_lora.py``'s QLoRA tp case: an int8 base wrapped in
    adapters shards its ``q``, ``scale`` and adapters by the base's split
    (``wq``: q and b column-split, a whole; ``wo``: q and a row-split, b
    and the per-output scale whole), and serves the one-shard engine's
    greedy tokens."""
    from polyrl_tpu_torch.models.lora import wrap_lora
    from polyrl_tpu_torch.models.quant import LoraWeight, quantize_params

    _j, _jp, tparams = tiny_pair
    served = wrap_lora(quantize_params(tparams),
                       torch.Generator().manual_seed(9), 4, 16.0)
    want, _ = _run(_port_engine(served), PROMPTS, _greedy(4))
    eng = _port_engine(served, tp=2)
    wq, wo = eng.params[1]["layers"]["wq"], eng.params[1]["layers"]["wo"]
    assert isinstance(wq, LoraWeight)
    assert wq.base.q.shape == (2, 64, 32) and wq.base.scale.shape == (2, 32)
    assert wq.a.shape == (2, 64, 4) and wq.b.shape == (2, 4, 32)
    assert wo.base.q.shape == (2, 32, 64) and wo.base.scale.shape == (2, 64)
    assert wo.a.shape == (2, 32, 4) and wo.b.shape == (2, 4, 64)
    whole = served["layers"]["wq"].base.q
    assert torch.equal(wq.base.q, whole.chunk(2, 2)[1])
    got, _ = _run(eng, PROMPTS, _greedy(4))
    assert got == want


def test_resharding_trainer_replicated_to_engine_tp2(tiny_pair):
    """``tests/test_resharding_map.py``'s sharded cases: a replicated
    trainer's push through the fabric into a tp=2 server lands each
    shard's blocks, bitwise the trainer's slices; the receiver advertises
    ``transfer_shard_tp == 2``, whose resharding map routes the split
    entries' bytes by shard pair. The range-restricted pack equals the
    full pack."""
    from polyrl_tpu_torch.models.quant import named_leaves
    from polyrl_tpu_torch.rollout.serve import attach_receiver
    from polyrl_tpu_torch.rollout.server import RolloutServer
    from polyrl_tpu_torch.transfer import layout as L
    from polyrl_tpu_torch.transfer.interface import TransferInterface

    _j, _jp, tparams = tiny_pair
    trainer = {k: v for k, v in tparams.items()}
    pushed = jax.tree_util.tree_map(lambda t: t * 1.5 + 0.01, trainer)
    eng = _port_engine(tparams, tp=2)
    srv = RolloutServer(eng, host="127.0.0.1", port=0).start()
    iface = TransferInterface(pushed, manager_client=None, num_streams=2,
                              poll_s=0.05, advertise_host="127.0.0.1")
    try:
        assert attach_receiver(srv, iface.sender.endpoint, transfer_streams=2)
        deadline = time.monotonic() + 30
        while not iface.sync_health():  # the receiver's registration
            assert time.monotonic() < deadline
            time.sleep(0.05)
        v = iface.update_weights_async(pushed)
        iface.wait_pushed(timeout=30.0)
        ok, msg = srv.update_weights_from_agent(v)
        assert ok, msg
        assert srv.server_info()["transfer_shard_tp"] == 2
        # the map the sender plans a full (not streamed) round's streams by
        rmap = L.build_resharding_map(iface.layout, iface.trainer_spec,
                                      srv.receiver.shard_spec)
        assert 0 < rmap.reshard_bytes() <= iface.layout.total_bytes
        whole = dict(named_leaves(pushed))
        for s, shard in enumerate(eng.params):
            for name, t in named_leaves(shard):
                d = srv.receiver.shard_spec.axis_of(name)
                want = whole[name] if d is None else whole[name].chunk(2, d)[s]
                assert torch.equal(t, want), (s, name)
        lay = L.build_layout(pushed)
        full = L.alloc_buffer(lay)
        L.pack_params(pushed, lay, full)
        part = np.zeros_like(full)
        rng = [(0, 100), (lay.entries[2].offset + 3, 40), (full.size - 64, 64)]
        L.pack_params_ranges(pushed, lay, part, rng)
        for off, ln in rng:
            np.testing.assert_array_equal(part[off:off + ln], full[off:off + ln])
    finally:
        iface.close()
        srv.stop()


def test_tp_spill_restore_moves_every_shards_pages(tiny_pair):
    """The memory plane on two shards: the ledger's bytes a page are the
    one-shard engine's (every shard's part of the page), a spill copies
    every shard's rows of the spilled pages, a restore writes them back
    in place into fresh pages of each shard's pools, bitwise, and greedy
    decode goes on as before."""
    from tests.torch_engine_util import quiesce

    _j, _jp, tparams = tiny_pair
    one = _port_engine(tparams)
    eng = _port_engine(tparams, tp=2, num_pages=32)
    try:
        one._accounted_bytes()
        eng._accounted_bytes()
        assert eng.kvledger.page_bytes == one.kvledger.page_bytes
        prompt = list(range(3, 24))
        first = eng.generate([prompt], _greedy(10), timeout=120.0)[0]
        quiesce(eng)
        kp, vp = eng._pool_sides()
        assert len(kp) == 2 * eng.cfg.num_layers
        ptrs = [t.data_ptr() for t in kp + vp]
        entries = sorted(eng.prefix_cache.spill_candidates(), key=lambda e: e.page)
        orig = [e.page for e in entries]
        assert orig
        before = [torch.stack([t[:, pg].clone() for t in kp + vp]) for pg in orig]
        assert eng._spill_pages(len(orig), cold_only=False) == len(orig)
        held = eng.allocator.alloc(len(orig))
        with eng._pool_lock:
            assert eng._restore_entries(entries)
        assert [t.data_ptr() for t in kp + vp] == ptrs
        for e, want in zip(entries, before):
            assert torch.equal(torch.stack([t[:, e.page] for t in kp + vp]), want)
        resumed = eng.generate([prompt], _greedy(10), timeout=120.0)[0]
        quiesce(eng)
        eng.allocator.free(held)
        assert resumed["token_ids"] == first["token_ids"]
    finally:
        one.stop()
        eng.stop()


def test_tp_chunked_prefill_matches_tp1(tiny_pair):
    """A prompt longer than the chunk fills its KV on both shards one chunk
    a loop iteration: the one-shard chunked engine's greedy tokens,
    logprobs within 5e-4."""
    _j, _jp, tparams = tiny_pair
    prompt = list(range(5, 35))  # 30 tokens: 3 chunks of 8, then the tail
    want_t, want_lp = _run(_port_engine(tparams, prefill_chunk=8), [prompt],
                           _greedy(8))
    eng = _port_engine(tparams, tp=2, prefill_chunk=8)
    got_t, got_lp = _run(eng, [prompt], _greedy(8))
    assert eng.chunk_dispatches > 0
    assert got_t == want_t
    np.testing.assert_allclose(got_lp[0], want_lp[0], **LP_TOL)
