"""The port's critic on the CPU against the JAX ``StreamCritic``.

The same numpy weights (the JAX critic's own ``init_critic_params`` tree,
converted by ``models/convert.py``: a ``value_head`` leaf and no
``lm_head``) and numpy batches go through both, in f32 on the ``tiny``
preset. Tolerances: values 1e-5 (the head is 0.01-scale, so values are
about 1e-2 and f32 reduction order moves them by about 1e-9); parameters
after one accumulated update and one tail flush (AdamW, lr 1e-4, so a
parameter moves by at most about lr) 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.data.batch import TensorBatch as JBatch
from polyrl_tpu.data.packing import iter_packed_micros as j_iter_packed
from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.trainer import critic as jcritic
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.trainer import critic as tcritic

VAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _models(seed=1):
    jcfg = jdec.get_config("tiny", dtype=jnp.float32, vocab_size=256)
    tcfg = tdec.get_config("tiny", dtype=torch.float32, vocab_size=256)
    tree = jax.tree_util.tree_map(
        np.asarray, jcritic.init_critic_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree


def _padded(seed, lengths, tp=16, tr=8, vocab=200):
    """A padded batch (left-padded prompts, right-padded responses) with
    returns and old values on the response tokens."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    ids = np.zeros((b, tp + tr), np.int32)
    mask = np.zeros((b, tp + tr), np.float32)
    rmask = np.zeros((b, tr), np.float32)
    for i, (pl, rl) in enumerate(lengths):
        ids[i, tp - pl:tp + rl] = rng.integers(1, vocab, pl + rl)
        mask[i, tp - pl:tp + rl] = 1.0
        rmask[i, :rl] = 1.0
    pos = np.maximum(mask.cumsum(-1) - 1, 0).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "attention_mask": mask,
            "responses": ids[:, tp:].copy(), "response_mask": rmask,
            "returns": (rng.standard_normal((b, tr)) * rmask).astype(np.float32),
            "values": (0.01 * rng.standard_normal((b, tr)) * rmask).astype(np.float32)}


LENGTHS = [(5, 7), (3, 2), (12, 8), (1, 1)]


def test_critic_tree_converts():
    """The JAX critic's tree goes through ``params_from_numpy`` whole: a
    [hidden, 1] value head, no lm_head, the trunk's leaves as they are."""
    jcfg, _tcfg, tree = _models()
    tp = params_from_numpy(tree, "cpu", torch.float32)
    assert "lm_head" not in tp and tp["value_head"].shape == (jcfg.hidden_size, 1)
    np.testing.assert_array_equal(tp["value_head"].numpy(), tree["value_head"])
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(), tree["layers"]["wq"])


def test_init_critic_params_shapes():
    _jcfg, tcfg, _tree = _models()
    p = tcritic.init_critic_params(torch.Generator().manual_seed(0), tcfg)
    assert "lm_head" not in p
    assert p["value_head"].shape == (tcfg.hidden_size, 1)
    assert float(p["value_head"].abs().max()) < 0.1


def test_forward_values_matches_jax():
    jcfg, tcfg, tree = _models()
    bt = _padded(0, LENGTHS)
    jc = jcritic.StreamCritic(jcfg, jcritic.CriticConfig(remat=False),
                              jax.tree_util.tree_map(jnp.asarray, tree))
    tc = tcritic.StreamCritic(tcfg, tcritic.CriticConfig(remat=False),
                              params_from_numpy(tree, "cpu", torch.float32))
    want = np.asarray(jc.compute_values(bt))
    got = tc.compute_values(bt).numpy()
    rm = bt["response_mask"] > 0
    np.testing.assert_allclose(got[rm], want[rm], **VAL_TOL)


def test_forward_values_packed_matches_jax():
    """The packed value pass (one-left shift, loss-mask guard) on the JAX
    packer's grid, against the JAX packed pass; gathered back, it is the
    padded pass's values too."""
    jcfg, tcfg, tree = _models()
    bt = _padded(1, LENGTHS)
    jb = JBatch.from_dict(tensors=dict(bt))
    (pack, spec), = list(j_iter_packed(jb, 16, pack_len=24, n_rows=2, pad_id=0))
    feed = {k: np.asarray(pack[k]) for k in ("input_ids", "positions",
                                             "attention_mask", "segment_ids",
                                             "loss_mask")}
    jc = jcritic.StreamCritic(jcfg, jcritic.CriticConfig(remat=False),
                              jax.tree_util.tree_map(jnp.asarray, tree))
    tc = tcritic.StreamCritic(tcfg, tcritic.CriticConfig(remat=False),
                              params_from_numpy(tree, "cpu", torch.float32))
    want = np.asarray(jc.compute_values_packed(feed))
    got = tc.compute_values_packed(feed).numpy()
    np.testing.assert_allclose(got, want, **VAL_TOL)
    assert (got[feed["loss_mask"] == 0] == 0).all()
    padded = tc.compute_values(bt).numpy() * bt["response_mask"]
    np.testing.assert_allclose(spec.gather(got, 8), padded, **VAL_TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_update_stream_and_flush_match_jax(packed):
    """One update_stream at loss_scale 1/2 (no step) and a tail
    flush_opt_step, on the padded or the packed layout: the value loss and
    clip fraction, the grad norm and every parameter after the step."""
    jcfg, tcfg, tree = _models()
    bt = _padded(2, LENGTHS)
    if packed:
        jb = JBatch.from_dict(tensors=dict(bt))
        (pack, _spec), = list(j_iter_packed(
            jb, 16, pack_len=24, n_rows=2, pad_id=0,
            scatter_keys=("returns", "values")))
        bt = {k: np.asarray(v) for k, v in pack.tensors.items()}
    ccfg = dict(lr=1e-4, remat=False, cliprange_value=0.005)
    jc = jcritic.StreamCritic(jcfg, jcritic.CriticConfig(**ccfg),
                              jax.tree_util.tree_map(jnp.asarray, tree))
    tc = tcritic.StreamCritic(tcfg, tcritic.CriticConfig(**ccfg),
                              params_from_numpy(tree, "cpu", torch.float32))
    jm = jc.update_stream(bt, is_opt_step=False, loss_scale=0.5)
    tm = tc.update_stream(bt, is_opt_step=False, loss_scale=0.5)
    for k in ("critic/vf_loss", "critic/vf_clipfrac"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert 0 < tm["critic/vf_clipfrac"] < 1  # the clip was exercised
    jg = float(jc.flush_opt_step()["critic/grad_norm"])
    tg = tc.flush_opt_step()["critic/grad_norm"]
    np.testing.assert_allclose(tg, jg, rtol=1e-5)
    want = _flat(jc.params)
    got = _flat(tc.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
        assert not np.array_equal(got[k], _flat(tree)[k]), k
    assert tc.opt_state.count == 1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def test_state_dict_roundtrip_is_bitwise():
    """``state_dict`` / ``load_state_dict`` (what a checkpoint saves and
    restores) carry the parameters, both moments and the counts exactly;
    a tensor of another dtype is refused."""
    _jcfg, tcfg, tree = _models()
    bt = _padded(3, LENGTHS)
    a = tcritic.StreamCritic(tcfg, tcritic.CriticConfig(lr=1e-3, remat=False),
                             params_from_numpy(tree, "cpu", torch.float32))
    a.update_stream(bt, is_opt_step=True)
    saved = {k: v.clone() for k, v in a.state_dict().items()}
    b = tcritic.StreamCritic(tcfg, tcritic.CriticConfig(lr=1e-3, remat=False),
                             params_from_numpy(tree, "cpu", torch.float32))
    b.load_state_dict(saved)
    for k, v in b.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert b.opt_state.count == 1
    bad = dict(saved)
    bad["params.value_head"] = bad["params.value_head"].double()
    with pytest.raises(ValueError):
        b.load_state_dict(bad)
