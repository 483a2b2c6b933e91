"""Actor parity on the CPU: the port's differentiable forward, loss,
gradient and optimizer step against the JAX ``StreamActor``.

The same numpy weights (``models/convert.py``) and numpy batches go
through both, in f32. The JAX actor trains with
``flash.auto_train_attention()``, which on the CPU is the dense masked
attention; the port's is K4's plain version. The two differ only on pad
query rows, which no loss term reads. Tolerances: logits, losses and
metrics rtol=atol=1e-4 (exact f32 on both sides, another reduction
order); the grad norm rtol 1e-4; parameters after one AdamW step atol
1e-6 (lr 1e-4: Adam's first update is lr * g / (|g| + eps), so a
parameter can move by at most lr, and the two sides agree far below it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.ops import flash as jflash
from polyrl_tpu.trainer import actor as jactor
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.trainer import actor as tactor

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)


def _models(seed=0):
    jcfg = jdec.get_config("qwen3-1.7b", dtype=jnp.float32, **SMALL)
    tcfg = tdec.get_config("qwen3-1.7b", dtype=torch.float32, **SMALL)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jdec.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k, v in tree["layers"].items():  # exercise the qk-norm weights
        if k.endswith("norm"):
            tree["layers"][k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return jcfg, tcfg, tree


def _batch(seed=0, b=4, tp=8, tr=6, vocab=256):
    """Left-padded prompts, right-padded responses, GRPO-style fields."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, tp + tr)).astype(np.int32)
    mask = np.ones((b, tp + tr), np.float32)
    resp_mask = np.ones((b, tr), np.float32)
    for i in range(b):
        p_pad, r_len = i % 3, tr - (i % 4)
        mask[i, :p_pad] = 0
        ids[i, :p_pad] = 0
        mask[i, tp + r_len:] = 0
        resp_mask[i, r_len:] = 0
        ids[i, tp + r_len:] = 0
    pos = np.maximum(mask.cumsum(-1) - 1, 0).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "attention_mask": mask,
            "responses": ids[:, tp:].copy(), "response_mask": resp_mask,
            "advantages": (rng.standard_normal((b, tr)) * resp_mask).astype(np.float32),
            "old_log_probs": (-5.6 + 0.1 * rng.standard_normal((b, tr))).astype(np.float32),
            "ref_log_probs": (-5.6 + 0.1 * rng.standard_normal((b, tr))).astype(np.float32)}


def _tparams(tree):
    return params_from_numpy(tree, "cpu", torch.float32)


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, prefix + k + "."))
        else:
            out[prefix + k] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)  # a copy
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_differentiable_forward_matches_jax(remat):
    """Logits on real positions, and the gradient of a loss over them with
    respect to every weight, against the JAX forward with its training
    attention."""
    jcfg, tcfg, tree = _models()
    bt = _batch(1)
    ids, pos, mask = bt["input_ids"], bt["positions"], bt["attention_mask"]
    w = np.random.default_rng(2).standard_normal((*ids.shape, jcfg.vocab_size)
                                                 ).astype(np.float32) * mask[..., None]

    def jloss(p):
        logits, _ = jdec.forward(p, jcfg, ids, pos, mask, remat=remat,
                                 attn_fn=jflash.auto_train_attention())
        return jnp.sum(logits * w), logits

    (jl, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    req = tactor._tree_map(lambda t: t.requires_grad_(True), _tparams(tree))
    logits, cache = tdec.forward(req, tcfg, torch.from_numpy(ids),
                                 torch.from_numpy(pos), torch.from_numpy(mask),
                                 remat=remat)
    assert cache is None
    real = mask > 0
    np.testing.assert_allclose(logits.detach().numpy()[real],
                               np.asarray(jlogits)[real], **TOL)
    (logits * torch.from_numpy(w)).sum().backward()
    got = {k: v.grad for k, v in tactor._leaves(req)}
    want = _flat_np(jgrad)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def _both_actors(acfg_kw, seed=0):
    jcfg, tcfg, tree = _models(seed)
    ja = jactor.StreamActor(jcfg, jactor.ActorConfig(**acfg_kw),
                            jax.tree_util.tree_map(jnp.asarray, tree))
    ta = tactor.StreamActor(tcfg, tactor.ActorConfig(**acfg_kw), _tparams(tree))
    return ja, ta, tree


def test_update_stream_matches_jax_actor():
    """Two accumulated micros (loss_scale 1/2 each) and one AdamW step
    with the KL loss and an entropy bonus: the metrics of each micro, the
    grad norm and every parameter after the step."""
    kw = dict(lr=1e-4, remat=False, use_kl_loss=True, kl_loss_coef=0.1,
              entropy_coeff=0.01, max_grad_norm=0.5)
    ja, ta, _ = _both_actors(kw)
    for i, is_opt in enumerate((False, True)):
        bt = _batch(10 + i)
        jm = ja.update_stream(bt, is_opt_step=is_opt, loss_scale=0.5)
        tm = ta.update_stream(bt, is_opt_step=is_opt, loss_scale=0.5)
        assert jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], float(jm[k]), err_msg=k, **TOL)
    assert tm["actor/grad_norm"] > 0.5  # the clip was exercised
    assert tm["actor/nonfinite_skips"] == 0
    want = _flat_np(ja.params)
    got = _flat_np(ta.params)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        moved += int(np.any(got[k] != _flat_np(_models()[2])[k]))
    assert moved == len(want)


def test_compute_log_prob_and_reference_match_jax():
    """The old-logprob pass (with entropy) and the reference policy, on
    the response tokens; padded response positions are exactly 0."""
    ja, ta, tree = _both_actors(dict(remat=False))
    bt = _batch(3, b=6)
    jl, je = ja.compute_log_prob(bt)
    tl, te = ta.compute_log_prob(bt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    assert (tl.numpy()[bt["response_mask"] == 0] == 0).all()
    jref = jactor.ReferencePolicy(ja.model_cfg, jax.tree_util.tree_map(jnp.asarray, tree))
    tref = tactor.ReferencePolicy(ta.model_cfg, _tparams(tree))
    np.testing.assert_allclose(tref.compute_log_prob(bt).numpy(),
                               np.asarray(jref.compute_log_prob(bt)), **TOL)


def test_tail_flush_loss_scale_renormalized():
    """A tail flush (partial minibatch) applies the MEAN of its micros'
    gradients: flushing one micro accumulated at loss_scale 1/4 gives the
    grad norm and parameters of one full-scale step on that micro."""
    _jcfg, tcfg, tree = _models()
    bt = _batch(4)
    a_full = tactor.StreamActor(tcfg, tactor.ActorConfig(lr=1e-3, remat=False),
                                _tparams(tree))
    m_full = a_full.update_stream(bt, is_opt_step=True, loss_scale=1.0)
    a_tail = tactor.StreamActor(tcfg, tactor.ActorConfig(lr=1e-3, remat=False),
                                _tparams(tree))
    a_tail.update_stream(bt, is_opt_step=False, loss_scale=0.25)
    m_tail = a_tail.flush_opt_step()
    np.testing.assert_allclose(m_tail["actor/grad_norm"], m_full["actor/grad_norm"],
                               rtol=1e-5)
    full, tail = _flat_np(a_full.params), _flat_np(a_tail.params)
    assert max(float(np.abs(full[k] - tail[k]).max()) for k in full) < 1e-5


def test_nonfinite_batch_is_skipped_and_counted():
    """A NaN advantage poisons the gradient: the update is skipped (params
    unchanged, counted in actor/nonfinite_skips) and the next finite one
    applies, as optax.apply_if_finite does."""
    _jcfg, tcfg, tree = _models()
    a = tactor.StreamActor(tcfg, tactor.ActorConfig(lr=1e-3, remat=False),
                           _tparams(tree))
    before = _flat_np(a.params)
    bad = _batch(5)
    bad["advantages"][0, 0] = np.nan
    m = a.update_stream(bad, is_opt_step=True)
    assert not np.isfinite(m["actor/grad_norm"])
    assert m["actor/nonfinite_skips"] == 1
    after = _flat_np(a.params)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    m = a.update_stream(_batch(6), is_opt_step=True)
    assert m["actor/nonfinite_skips"] == 1 and np.isfinite(m["actor/grad_norm"])
    assert any(not np.array_equal(before[k], v) for k, v in _flat_np(a.params).items())
    assert a.opt_state.count == 1


def test_warmup_lr_is_zero_at_the_first_step():
    """Linear warmup from 0 evaluates to lr 0 at count 0: the first step
    moves nothing (weight decay included), the second does."""
    _jcfg, tcfg, tree = _models()
    a = tactor.StreamActor(tcfg, tactor.ActorConfig(lr=1e-3, lr_warmup_steps=2,
                                                    remat=False), _tparams(tree))
    before = _flat_np(a.params)
    a.update_stream(_batch(7), is_opt_step=True)
    assert all(np.array_equal(before[k], v) for k, v in _flat_np(a.params).items())
    a.update_stream(_batch(8), is_opt_step=True)
    assert any(not np.array_equal(before[k], v) for k, v in _flat_np(a.params).items())


@pytest.mark.parametrize("kw,total", [(dict(lr=3e-4), 0),
                                      (dict(lr=3e-4, lr_warmup_steps=5), 0),
                                      (dict(lr=3e-4, lr_warmup_steps=3), 12)])
def test_schedules_match_optax(kw, total):
    cfg = tactor.ActorConfig(**kw)
    sched = tactor.make_schedule(cfg, total)
    if total:
        want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.lr_warmup_steps,
                                                  total)
    elif cfg.lr_warmup_steps:
        want = optax.linear_schedule(0.0, cfg.lr, cfg.lr_warmup_steps)
    else:
        want = lambda c: cfg.lr  # noqa: E731
    for c in range(0, 16):
        np.testing.assert_allclose(float(sched(c)), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))


def _mesh(**axes):
    """A one-rank description of a mesh (no world, no collective)."""
    from polyrl_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh(tuple(axes.get(a, 1) for a in AXES), make_groups=False)


def test_unported_actor_options_raise():
    """Every mesh axis is ported: tp meshes
    (``tests/test_torch_tensor_parallel.py``), pp with a pipeline
    ``layers_fn`` (``tests/test_torch_pipeline_parallel.py``), ep and a
    MoE config under tp (``tests/test_torch_expert_parallel.py``), and so
    are LoRA and optimizer offload (``tests/test_torch_lora.py``, the
    offload test below). What still refuses: a pp mesh without a pipeline
    ``layers_fn``, and an ep mesh on a dense config."""
    from polyrl_tpu_torch.parallel.pipeline import make_pipeline_layers_fn

    _jcfg, tcfg, tree = _models()
    for kw in (dict(lora_rank=4), dict(offload_optimizer=True)):
        tactor.StreamActor(tcfg, tactor.ActorConfig(**kw), _tparams(tree))
    tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree),
                       mesh=_mesh(tp=2))
    with pytest.raises(ValueError, match="pipeline layers_fn"):
        tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree),
                           mesh=_mesh(pp=2))
    pp = _mesh(pp=2)
    tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree), mesh=pp,
                       layers_fn=make_pipeline_layers_fn(pp, tcfg, 2))
    with pytest.raises(ValueError, match="MoE"):
        tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree),
                           mesh=_mesh(ep=2))
    moe = tdec.get_config("moe-tiny", dtype=torch.float32)
    for mesh in (_mesh(tp=2), _mesh(ep=2), _mesh(tp=2, ep=2)):
        tactor.StreamActor(moe, tactor.ActorConfig(),
                           tdec.init_params(torch.Generator().manual_seed(0), moe),
                           mesh=mesh)


@pytest.mark.parametrize("kw", [dict(packed_attn_fn=object(),
                                     mesh=_mesh(sp=2, pp=2),
                                     attn_fn=object()),
                                dict(layers_fn=object(), mesh=_mesh(sp=2))],
                         ids=["sp_packed_attention", "pipeline_layers"])
def test_unported_parallel_options_raise(kw):
    """Packed rows run through K4 with segment ids, on an sp mesh through
    the sequence-parallel packed attention
    (``tests/test_torch_sequence_parallel.py``) and under a pipeline
    through the stages' own attention
    (``tests/test_torch_pipeline_parallel.py``). What refuses: an SP
    packed attention beside a pipeline (the stages compute their own), and
    a pp mesh without a pipeline ``layers_fn``."""
    _jcfg, tcfg, tree = _models()
    if "layers_fn" in kw:
        kw = dict(kw, packed_attn_fn=object())
        with pytest.raises(ValueError, match="own stage attention"):
            tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree), **kw)
        return
    with pytest.raises(ValueError, match="pipeline layers_fn"):
        tactor.StreamActor(tcfg, tactor.ActorConfig(), _tparams(tree), **kw)


def test_packed_feed_trains():
    """A packed feed (segment ids, loss_mask) trains: the loss reads
    loss_mask as the response mask and the step moves the weights."""
    _jcfg, tcfg, tree = _models()
    bt = _batch(11)
    seg = (bt["attention_mask"] > 0).astype(np.int32)
    feed = {"input_ids": bt["input_ids"], "positions": bt["positions"],
            "attention_mask": bt["attention_mask"], "segment_ids": seg,
            "loss_mask": np.pad(bt["response_mask"], ((0, 0), (8, 0))),
            "advantages": np.pad(bt["advantages"], ((0, 0), (8, 0))),
            "old_log_probs": np.pad(bt["old_log_probs"], ((0, 0), (8, 0)))}
    a = tactor.StreamActor(tcfg, tactor.ActorConfig(lr=1e-3, remat=False),
                           _tparams(tree))
    before = _flat_np(a.params)
    m = a.update_stream(feed, is_opt_step=True)
    assert np.isfinite(m["actor/pg_loss"]) and m["actor/grad_norm"] > 0
    assert any(not np.array_equal(before[k], v) for k, v in _flat_np(a.params).items())


def test_double_where_keeps_masked_nans_out_of_the_gradient():
    """Logits that overflow at a masked response position (their
    log-softmax is NaN) reach neither the logprobs nor, through the
    backward, the head's gradient: the logits are zeroed before the
    log-softmax, not only the output."""
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    h[1, 3] = 3e38  # finite, but h @ head overflows to +-inf
    head = torch.from_numpy(rng.standard_normal((8, 11)).astype(np.float32))
    head.requires_grad_(True)
    mask = torch.ones((2, 5))
    mask[1, 3:] = 0
    labels = torch.from_numpy(rng.integers(0, 11, (2, 5)))
    raw = torch.log_softmax(h @ head, dim=-1)
    assert not torch.isfinite(raw[1, 3]).all()
    lp, ent = tactor._logprobs_entropy_of(h, head, labels, mask, True)
    assert torch.isfinite(lp).all() and torch.isfinite(ent).all()
    assert (lp[1, 3:] == 0).all() and (ent[1, 3:] == 0).all()
    (lp.sum() + ent.sum()).backward()
    assert torch.isfinite(head.grad).all()


@pytest.mark.parametrize("lora_rank", [0, 4], ids=["full", "lora"])
def test_optimizer_offload_is_bitwise_and_host_resident(lora_rank):
    """Two steps with the moments offloaded after each (the reference's
    ``test_optimizer_host_offload_roundtrip``): the parameters bitwise
    those of the same steps without offload; between steps every moment
    lives on the host in the buffers allocated at the first offload (the
    same tensors each time), and the state dict reads them there."""
    _jcfg, tcfg, tree = _models()

    def run(offload):
        a = tactor.StreamActor(tcfg, tactor.ActorConfig(
            lr=1e-3, remat=False, offload_optimizer=offload,
            lora_rank=lora_rank), _tparams(tree))
        bufs = None
        for i in range(2):
            a.update_stream(_batch(30 + i), is_opt_step=True)
            a.offload_opt_state()
            if offload:
                assert a._opt_offloaded
                host = a.opt_state.mu + a.opt_state.nu
                assert all(t.device.type == "cpu" for t in host)
                if bufs is not None:
                    assert all(x is y for x, y in zip(host, bufs))
                bufs = host
                assert a.state_dict()["opt.count"] == i + 1
            else:
                assert not a._opt_offloaded
        return _flat_np(quant_tree_plain(a.params)), a

    got, a_off = run(True)
    want, a_on = run(False)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a_off.load_opt_state()
    for x, y in zip(a_off.opt_state.mu + a_off.opt_state.nu,
                    a_on.opt_state.mu + a_on.opt_state.nu):
        assert torch.equal(x, y)


def quant_tree_plain(tree):
    """A (possibly LoRA-wrapped) tree as ``{name: tensor}``."""
    from polyrl_tpu_torch.models.quant import named_leaves

    return dict(named_leaves(tree))
