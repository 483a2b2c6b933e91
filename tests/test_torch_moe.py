"""The MoE model family on the port, against the JAX package on the CPU.

``moe-tiny`` (Qwen3-MoE architecture: 4 experts, top-2, qk-norm) in f32,
weights drawn by ``jax.random`` and converted with
``models/convert.params_from_numpy``, the same numpy inputs through both
packages. Tolerances: the routed MLP within rtol = atol = 1e-5 and the
model's logits within 1e-4 (both sides exact f32, JAX at "highest" matmul
precision; they differ in reduction order only); routing itself
(experts, capacity slots, drops) bitwise, read from the tokens each
expert's buffer receives; engine logprobs within 5e-4 (the JAX package's
bound between its engines); gradients within a relative Frobenius error
of 1e-4 per leaf; ``transformers`` logits within rtol = atol = 2e-4 and
int8 within an NRMSE of 0.05 (the reference's ``tests/test_moe.py``
bounds).

The two ``devices8`` tests of ``tests/test_moe.py`` (expert parallelism
over an ``ep`` mesh axis) have their counterparts in
``tests/test_torch_expert_parallel.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.models import quant as jquant
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.models import hf_loader, lora, quant
from polyrl_tpu_torch.models.convert import params_from_numpy

MLP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
LP_TOL = 5e-4
GRAD_REL = 1e-4


def _cfgs(**over):
    return (jdec.get_config("moe-tiny", dtype=jnp.float32, **over),
            tdec.get_config("moe-tiny", dtype=torch.float32, **over))


def _tree(jcfg, seed=0):
    """Numpy weights; norms randomised so qk-norm is exercised."""
    tree = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for k, v in tree["layers"].items():
        if k.endswith("norm"):
            tree["layers"][k] = (1.0 + 0.1 * rng.standard_normal(v.shape)
                                 ).astype(np.float32)
    return tree


def _both(seed=0, **over):
    jcfg, tcfg = _cfgs(**over)
    tree = _tree(jcfg, seed)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu", torch.float32), tree)


def _layer0(jp, tp):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            tdec.layer_params(tp, 0))


class _Dispatched:
    """Records the first operand of the first expert product of each MoE
    call: the tokens each expert's buffer received, [G, E, C, d]. Equal
    buffers mean the same experts, the same capacity slots and the same
    drops; a dispatch is a 0/1 selection, so the buffers are exact."""

    def __init__(self, module, monkeypatch):
        self.seen = []
        inner = module.moe_mm

        def spy(eq, x, w):
            if eq.startswith("gecd,edf"):
                self.seen.append(np.asarray(x, np.float32) if not isinstance(
                    x, torch.Tensor) else x.detach().float().numpy())
            return inner(eq, x, w)

        monkeypatch.setattr(module, "moe_mm", spy)


def _ids(b, t, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (b, t)).astype(np.int32)


# -- the routed MLP -------------------------------------------------------------


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_moe_mlp_matches_jax_with_routing_bitwise(monkeypatch, factor):
    """``_moe_mlp`` on 24 random tokens (some invalid), in groups of 8:
    outputs within 1e-5; at factor 1.0 (capacity 4 of the 16 choices of a
    group: drops) the expert buffers are bitwise the reference's, so are
    the routed experts, slots and keep masks."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=factor, moe_group_size=8)
    jl, tl = _layer0(jp, tp)
    x = np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)
    valid = np.ones(24, bool)
    valid[[3, 17, 18]] = False
    jd, td = _Dispatched(jdec, monkeypatch), _Dispatched(tdec, monkeypatch)
    want = np.asarray(jdec._moe_mlp(jcfg, jnp.asarray(x), jl, jnp.asarray(valid)))
    got = tdec._moe_mlp(tcfg, torch.from_numpy(x), tl,
                        torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, **MLP_TOL)
    np.testing.assert_array_equal(td.seen[0], jd.seen[0])
    filled = (np.abs(td.seen[0]).sum(-1) > 0).sum()
    if factor == 1.0:  # 3 groups x 4 experts x capacity 4, with drops
        assert td.seen[0].shape[2] == 4 and filled < 2 * 21
    else:
        assert filled == 2 * 21  # dropless: every valid token's 2 choices


def test_moe_router_selects_forced_expert():
    """A router that sends every token to expert 0 with certainty: the
    output is expert 0's SwiGLU alone (k = 1, capacity E/k so that nothing
    drops), on both sides."""
    jcfg, tcfg, jp, tp, _ = _both()
    jl, tl = _layer0(jp, tp)
    d, e = tcfg.hidden_size, tcfg.num_experts
    router = np.full((d, e), -1.0, np.float32)
    router[:, 0] = 1.0
    jl = dict(jl, router=jnp.asarray(router))
    tl = dict(tl, router=torch.from_numpy(router))
    x = np.full((3, d), 0.1, np.float32)
    over = dict(num_experts_per_tok=1, moe_capacity_factor=float(e))
    got = tdec._moe_mlp(dataclasses.replace(tcfg, **over), torch.from_numpy(x),
                        tl).numpy()
    xt = torch.from_numpy(x)
    gate = torch.nn.functional.silu(xt @ tl["we_gate"][0])
    want = ((gate * (xt @ tl["we_up"][0])) @ tl["we_down"][0]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = jdec._moe_mlp(dataclasses.replace(jcfg, **over), jnp.asarray(x), jl)
    np.testing.assert_allclose(got, np.asarray(ref), **MLP_TOL)
    # capacity 1 (factor E/8 over 8 tokens): only the first token keeps it
    over = dict(num_experts_per_tok=1, moe_capacity_factor=e / 8.0)
    got = tdec._moe_mlp(dataclasses.replace(tcfg, **over),
                        torch.full((8, d), 0.1), tl).numpy()
    assert not np.allclose(got[0], 0.0)
    np.testing.assert_allclose(got[1:], 0.0, atol=1e-7)


@pytest.mark.parametrize("positive", [True, False])
def test_top_k_ties_break_as_jax(monkeypatch, positive):
    """Router logits with exact ties, in bf16: four experts (3, 5, 17, 40 of
    128, k = 2) share one router column and every other column is 0, so
    each token's logits tie among the four (x . v > 0) or among the 124
    zeros (x . v < 0). ``jax.lax.top_k`` takes the lower indices first;
    the port's stable sort must too, and so must the capacity order: the
    expert buffers (factor 0.5, 1 slot an expert a group) are bitwise the
    reference's."""
    over = dict(num_experts=128, num_experts_per_tok=2,
                moe_capacity_factor=0.5, moe_group_size=64)
    jcfg = jdec.get_config("moe-tiny", dtype=jnp.bfloat16, **over)
    tcfg = tdec.get_config("moe-tiny", dtype=torch.bfloat16, **over)
    d = tcfg.hidden_size
    rng = np.random.default_rng(7)
    v = rng.standard_normal(d).astype(np.float32)
    router = np.zeros((d, 128), np.float32)
    router[:, [3, 5, 17, 40]] = v[:, None]
    x = rng.standard_normal((64, d)).astype(np.float32)
    x *= np.sign(x @ v)[:, None] * (1 if positive else -1)
    fe = tcfg.moe_intermediate_size
    experts = {k: (0.02 * rng.standard_normal(s)).astype(np.float32) for k, s in (
        ("we_gate", (128, d, fe)), ("we_up", (128, d, fe)),
        ("we_down", (128, fe, d)))}
    jl = {k: jnp.asarray(a, jnp.bfloat16)
          for k, a in dict(experts, router=router).items()}
    tl = {k: torch.from_numpy(a).to(torch.bfloat16)
          for k, a in dict(experts, router=router).items()}
    jd, td = _Dispatched(jdec, monkeypatch), _Dispatched(tdec, monkeypatch)
    want = jdec._moe_mlp(jcfg, jnp.asarray(x, jnp.bfloat16), jl)
    tdec._moe_mlp(tcfg, torch.from_numpy(x).to(torch.bfloat16), tl)
    np.testing.assert_array_equal(td.seen[0], jd.seen[0])
    assert np.isfinite(np.asarray(want, np.float32)).all()
    taken = np.flatnonzero(np.abs(td.seen[0][0]).sum(axis=(1, 2)) > 0)
    assert list(taken) == ([3, 5] if positive else [0, 1])
    # torch.topk alone promises no such order: the sort is what holds it
    probs = torch.softmax(torch.from_numpy(x).to(torch.bfloat16)
                          @ tl["router"], dim=-1).float()
    top = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :2]
    assert (top == torch.tensor([3, 5] if positive else [0, 1])).all()


def test_padding_does_not_consume_capacity():
    """Pads are out of routing: real tokens' logits cannot depend on pad
    content at factor 1.0 (where capacity binds), and match JAX."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=1.0)
    real = _ids(2, 6, 5)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    mask = np.concatenate([np.ones((2, 6)), np.zeros((2, 10))], 1).astype(np.float32)
    outs = []
    for pad in (np.zeros((2, 10), np.int32), _ids(2, 10, 7)):
        ids = np.concatenate([real, pad], 1)
        tl, _ = tdec.forward(tp, tcfg, torch.from_numpy(ids),
                             torch.from_numpy(pos), torch.from_numpy(mask))
        outs.append(tl.detach().numpy()[:, :6])
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)
    jl, _ = jdec.forward(jp, jcfg, ids, pos, mask)
    np.testing.assert_allclose(outs[1], np.asarray(jl)[:, :6], **TOL)


def test_grouped_matches_ungrouped():
    """Groups of 4 tokens against one group of 512 where capacity never
    binds: the same logits, on the port and against JAX."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=2.0, moe_group_size=512)
    ids = _ids(2, 12, 6)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    mask = np.ones((2, 12), np.float32)
    args = [torch.from_numpy(a) for a in (ids, pos, mask)]
    a, _ = tdec.forward(tp, tcfg, *args)
    small = dataclasses.replace(tcfg, moe_group_size=4)
    b, _ = tdec.forward(tp, small, *args)
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    jb, _ = jdec.forward(jp, dataclasses.replace(jcfg, moe_group_size=4),
                         ids, pos, mask)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), **TOL)


# -- the model's paths ----------------------------------------------------------


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_forward_with_and_without_cache(factor):
    """The full-sequence forward (right padding on row 1) and the cache
    path (prefill of a chunk, then one token a row) against JAX; at
    factor 1.0 capacity binds, so each side must route the same tokens."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=factor)
    ids = _ids(2, 12, 1)
    mask = np.ones((2, 12), np.float32)
    mask[1, 9:] = 0
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jl, _ = jdec.forward(jp, jcfg, ids, pos, mask)
    tl, _ = tdec.forward(tp, tcfg, *map(torch.from_numpy, (ids, pos, mask)))
    np.testing.assert_allclose(tl.detach().numpy()[0], np.asarray(jl)[0], **TOL)
    np.testing.assert_allclose(tl.detach().numpy()[1, :9], np.asarray(jl)[1, :9],
                               **TOL)
    # cache path: a 10-slot chunk (row 1 with 3 pads), then one more token
    cmask = np.zeros((2, 16), np.float32)
    cmask[0, :10], cmask[1, :7] = 1, 1
    jc = jdec.make_cache(jcfg, 2, 16, dtype=jnp.float32)
    tc = tdec.make_cache(tcfg, 2, 16, dtype=torch.float32)
    jl, jc = jdec.forward(jp, jcfg, ids[:, :10], pos[:, :10], cmask, cache=jc,
                          write_idx=0)
    tl, tc = tdec.forward(tp, tcfg, torch.from_numpy(ids[:, :10]),
                          torch.from_numpy(pos[:, :10]), torch.from_numpy(cmask),
                          cache=tc, write_idx=0)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)
    np.testing.assert_allclose(tl.numpy()[1, :7], np.asarray(jl)[1, :7], **TOL)
    cmask[:, 10] = [1, 0]  # row 1 is done: its token takes no capacity
    step = np.array([[5], [9]], np.int32)
    spos = np.array([[10], [7]], np.int32)
    jl, _ = jdec.forward(jp, jcfg, step, spos, cmask, cache=jc, write_idx=10)
    tl, _ = tdec.forward(tp, tcfg, torch.from_numpy(step), torch.from_numpy(spos),
                         torch.from_numpy(cmask), cache=tc, write_idx=10)
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], **TOL)


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def test_paged_prefill_and_decode_with_active():
    """Batched prefill into pages, a suffix prefill over cached prefix
    pages, then three paged decode steps with one slot inactive (its token
    takes no capacity, at factor 1.0): logprobs within 5e-4 of JAX."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=1.0)
    rng = np.random.default_rng(2)
    lens = np.array([13, 7, 11], np.int32)
    ids = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, 512, n)
    pages = np.array([[3, 5], [9, 0], [12, 13]], np.int32)
    jpools = jdec.make_paged_pools(jcfg, 32, 8, dtype=jnp.float32)
    tpools = tdec.make_paged_pools(tcfg, 32, 8, dtype=torch.float32)
    jpools, jl = jdec.prefill_batch_into_pages(jp, jcfg, ids, lens, jpools, pages)
    tpools, tl = tdec.prefill_batch_into_pages(
        tp, tcfg, torch.from_numpy(ids), torch.from_numpy(lens), tpools,
        torch.from_numpy(pages))
    np.testing.assert_allclose(_log_softmax(tl.numpy()),
                               _log_softmax(jl), rtol=0, atol=LP_TOL)
    sfx = np.zeros((2, 8), np.int32)
    sfx_lens = np.array([5, 3], np.int32)
    for i, n in enumerate(sfx_lens):
        sfx[i, :n] = rng.integers(1, 512, n)
    pre, spg = np.array([[3], [3]], np.int32), np.array([[20], [21]], np.int32)
    jpools, jl = jdec.prefill_suffix_batch_into_pages(
        jp, jcfg, sfx, sfx_lens, 8, jpools, pre, spg)
    tpools, tl = tdec.prefill_suffix_batch_into_pages(
        tp, tcfg, *map(torch.from_numpy, (sfx, sfx_lens)), 8, tpools,
        torch.from_numpy(pre), torch.from_numpy(spg))
    np.testing.assert_allclose(_log_softmax(tl.numpy()),
                               _log_softmax(jl), rtol=0, atol=LP_TOL)
    table = np.array([[3, 5, 6, 0], [9, 10, 0, 0], [12, 13, 14, 0]], np.int32)
    active = np.array([True, False, True])
    seq = lens.copy()
    for _ in range(3):
        tok = rng.integers(1, 512, 3).astype(np.int32)
        jl, jpools = jdec.forward_paged_decode(jp, jcfg, tok, seq, jpools, table,
                                               seq, active=active)
        tl, tpools = tdec.forward_paged_decode(
            tp, tcfg, *map(torch.from_numpy, (tok, seq)), tpools,
            torch.from_numpy(table), torch.from_numpy(seq),
            active=torch.from_numpy(active))
        np.testing.assert_allclose(_log_softmax(tl.numpy())[active],
                                   _log_softmax(jl)[active], rtol=0, atol=LP_TOL)
        seq = seq + active


@pytest.mark.parametrize("remat", [False, True])
def test_router_and_expert_gradients_match_jax(remat):
    """``jax.grad`` of a mean log-probability through the full forward
    (padding on row 1) against autograd on the port: every leaf, router
    and experts included, within a relative Frobenius error of 1e-4; the
    router's gradient reaches it through the renormalised top-k
    probabilities."""
    jcfg, tcfg, jp, tp, _ = _both(moe_capacity_factor=1.0)
    ids = _ids(2, 8, 2)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8)).copy()
    mask = np.ones((2, 8), np.float32)
    mask[1, 6:] = 0

    def jloss(p):
        logits, _ = jdec.forward(p, jcfg, ids, pos, mask, remat=remat)
        return jnp.mean(jax.nn.log_softmax(logits)[..., 0] * mask)

    want = jax.grad(jloss)(jp)
    leaves = quant.tree_map(lambda t: t.requires_grad_(True), tp)
    logits, _ = tdec.forward(leaves, tcfg, *map(torch.from_numpy, (ids, pos, mask)),
                             remat=remat)
    loss = (torch.log_softmax(logits, -1)[..., 0] * torch.from_numpy(mask)).mean()
    loss.backward()
    for name, t in quant.named_leaves(leaves):
        w = want
        for k in name.split("."):
            w = w[k]
        w, g = np.asarray(w), t.grad.numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < GRAD_REL, (name, rel)
        if name.startswith("layers.") and name.split(".")[1] in (
                "router", "we_gate", "we_up", "we_down"):
            assert np.abs(g).max() > 0, name


# -- engines, trainers ----------------------------------------------------------

GEOM = dict(max_slots=8, page_size=8, max_seq_len=96, prompt_buckets=(16, 32),
            num_pages=128)


def _engines(tree, **kw):
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    jcfg, tcfg = _cfgs()
    return (JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                    kv_cache_dtype=jnp.float32, **{**GEOM, **kw}),
            CBEngine(tcfg, params_from_numpy(tree, "cpu", torch.float32),
                     kv_cache_dtype=torch.float32, device="cpu", **{**GEOM, **kw}))


@pytest.mark.parametrize("kw", [{}, {"spec_tokens": 2}, {"prefill_chunk": 16}],
                         ids=["plain", "spec", "chunked"])
def test_cb_engine_greedy_matches_jax(kw):
    """The port's ``CBEngine(device="cpu")`` serving moe-tiny: greedy tokens
    equal to the JAX engine's and logprobs within 5e-4, plain (after a
    ``warmup``), with speculation's verify rows (the ``ok`` rows route, the rest do not) and
    with chunked prefill of a 40-token prompt."""
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    tree = _tree(_cfgs()[0])
    rng = np.random.default_rng(0)
    lens = (5, 8, 13, 17, 24) if "prefill_chunk" not in kw else (40, 9)
    prompts = [rng.integers(1, 512, n).tolist() for n in lens]
    if "spec_tokens" in kw:  # a repetitive prompt, so drafts get accepted
        prompts.append([7, 8, 9] * 6)
    buckets = {"prompt_buckets": (16, 32, 48)} if "prefill_chunk" in kw else {}
    jeng, teng = _engines(tree, **kw, **buckets)
    if not kw:  # warm-up prefills and decodes on the null page first
        teng.warmup(batch_sizes=(2,))
    try:
        ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=12))
        out = teng.generate(prompts, SamplingParams(temperature=0.0,
                                                    max_new_tokens=12))
    finally:
        jeng.stop()
        teng.stop()
    for t, j in zip(out, ref):
        assert t["token_ids"] == list(j["token_ids"])
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=LP_TOL)
    if "spec_tokens" in kw:
        assert teng.spec_dispatches > 0
    if "prefill_chunk" in kw:
        assert teng.chunk_dispatches > 0


def test_cb_engine_grouped_decode_matches_jax():
    """A GRPO group of 4 on one 21-token prompt (shared prefix pages,
    sibling attach, grouped decode) on both engines: equal greedy tokens,
    logprobs within 5e-4."""
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    tree = _tree(_cfgs()[0])
    prompt = np.random.default_rng(3).integers(1, 512, 21).tolist()
    jeng, teng = _engines(tree)
    res = []
    try:
        for eng, sp in ((jeng, JSP(temperature=0.0, max_new_tokens=10)),
                        (teng, SamplingParams(temperature=0.0, max_new_tokens=10))):
            qs = [eng.submit(f"g-{i}", prompt, sp, group_id="g", group_size=4)
                  for i in range(4)]
            eng.start()
            rows = []
            for q in qs:
                toks, lps = [], []
                while True:
                    item = q.get(timeout=120)
                    if item is STREAM_END or not isinstance(item, dict):
                        break
                    toks += list(item["token_ids"])
                    lps += list(item["logprobs"])
                    if item["finished"]:
                        break
                rows.append((toks, lps))
            res.append(rows)
        assert teng.grouped_decode_dispatches > 0
    finally:
        jeng.stop()
        teng.stop()
    for (tj, lj), (tt, lt) in zip(*res):
        assert tt == tj and len(tt) == 10
        np.testing.assert_allclose(lt, lj, rtol=0, atol=LP_TOL)


def test_step_backend_greedy_matches_jax():
    """The step backend (``RolloutEngine``: the dense cache path, one token
    a step with its chunk's validity) against the JAX ``RolloutEngine``."""
    from polyrl_tpu.rollout.engine import RolloutEngine as JRE
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP
    from polyrl_tpu_torch.rollout.engine import RolloutEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    jcfg, tcfg = _cfgs(moe_capacity_factor=1.0)
    tree = _tree(jcfg)
    prompts = [np.random.default_rng(4).integers(1, 512, n).tolist()
               for n in (5, 11, 16)]
    jeng = JRE(jcfg, jax.tree_util.tree_map(jnp.asarray, tree), pad_token_id=0,
               batch_buckets=(4,), prompt_buckets=(16,), kv_cache_dtype=jnp.float32)
    teng = RolloutEngine(tcfg, params_from_numpy(tree, "cpu", torch.float32),
                         pad_token_id=0, batch_buckets=(4,), prompt_buckets=(16,),
                         kv_cache_dtype=torch.float32, device="cpu")
    ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=8))
    out = teng.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=8))
    for t, j in zip(out, ref):
        assert list(t.output_ids) == list(j.output_ids) and len(t.output_ids) == 8
        np.testing.assert_allclose(t.output_token_logprobs,
                                   j.output_token_logprobs, rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("estimator", ["grpo", "gae"])
def test_fit_moves_router_and_experts(estimator):
    """One colocated fit step on moe-tiny through ``build_trainer``: GRPO
    with a KL loss and remat, and PPO with a critic (GAE) on packed rows;
    the actor's router and every expert leaf moved, the engine holds the
    actor's weights, the critic (the same MoE trunk) trained."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    small = ["device=cpu", "model.preset=moe-tiny", "model.dtype=float32",
             "rollout.prompt_buckets=16", "rollout.page_size=8",
             "rollout.max_seq_len=64", "rollout.num_pages=64",
             "rollout.max_slots=8", "trainer.train_batch_size=2",
             "trainer.rollout_n=2", "trainer.ppo_mini_batch_size=4",
             "trainer.micro_batch_size=4", "trainer.min_stream_batch_size=4",
             "trainer.max_prompt_length=16", "trainer.max_response_length=8",
             "trainer.total_steps=1", "reward.num_workers=1",
             "actor.lr=1e-3", "trainer.temperature=1.0",
             f"trainer.adv_estimator={estimator}"]
    small += (["actor.use_kl_loss=true", "actor.remat=true"] if estimator == "grpo"
              else ["trainer.use_remove_padding=true"])
    cleanup = []
    trainer = build_trainer(load_config(None, small), cleanup)
    try:
        actor = trainer.actor
        before = {k: t.detach().clone() for k, t in quant.named_leaves(actor.params)}
        crit0 = (None if trainer.critic is None else
                 {k: t.detach().clone()
                  for k, t in quant.named_leaves(trainer.critic.params)})
        hist = trainer.fit()
    finally:
        trainer.rollout.stop()
        for fn in reversed(cleanup):
            fn()
    assert len(hist) == 1 and np.isfinite(hist[0]["actor/pg_loss"])
    after = dict(quant.named_leaves(actor.params))
    for key in ("router", "we_gate", "we_up", "we_down"):
        assert not torch.equal(after[f"layers.{key}"].detach(),
                               before[f"layers.{key}"]), key
    for name, e in quant.named_leaves(trainer.rollout.params):
        assert torch.equal(after[name].detach(), e), name
    if estimator == "gae":
        assert np.isfinite(hist[0]["critic/vf_loss"])
        got = dict(quant.named_leaves(trainer.critic.params))
        assert not torch.equal(got["layers.router"].detach(),
                               crit0["layers.router"])


def test_critic_values_match_jax():
    """The critic's value head over the MoE trunk (``forward_values``)
    against the JAX critic on the same weights."""
    from polyrl_tpu.trainer import critic as jcritic
    from polyrl_tpu_torch.trainer import critic as tcritic

    jcfg, tcfg, jp, tp, tree = _both(moe_capacity_factor=1.0)
    head = np.random.default_rng(3).standard_normal((64, 1)).astype(np.float32) * 0.1
    jp = dict(jp, value_head=jnp.asarray(head))
    jp.pop("lm_head", None)
    tp = dict(tp, value_head=torch.from_numpy(head))
    tp.pop("lm_head", None)
    ids = _ids(2, 12, 8)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    mask = np.ones((2, 12), np.float32)
    mask[1, :3] = 0
    pos[1] = np.maximum(np.arange(12) - 3, 0)
    resp = ids[:, -4:]
    want = jcritic.forward_values(jp, jcfg, ids, pos, mask, resp, False)
    got = tcritic.forward_values(tp, tcfg, *map(torch.from_numpy,
                                                (ids, pos, mask, resp)), False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# -- int8, LoRA, the fabric, checkpoints ------------------------------------------


def test_quantize_params_covers_experts_not_router():
    """Experts quantize per output channel ([L, E, out] scales, q bitwise the
    reference's, scales within an f32 ulp); the router stays in the model
    dtype; a rank-4 ``QuantWeight`` slices by layer; the int8 forward
    tracks f32 (NRMSE < 0.05) and the reference's int8 forward."""
    jcfg, tcfg, jp, tp, tree = _both()
    qp = quant.quantize_params(tp)
    jq = jquant.quantize_params(jp)
    for k in ("we_gate", "we_up", "we_down", "wq"):
        assert isinstance(qp["layers"][k], quant.QuantWeight)
        np.testing.assert_array_equal(qp["layers"][k].q.numpy(),
                                      np.asarray(jq["layers"][k].q))
        ulp = np.spacing(np.abs(np.asarray(jq["layers"][k].scale)))
        assert np.all(np.abs(qp["layers"][k].scale.numpy()
                             - np.asarray(jq["layers"][k].scale)) <= ulp), k
    assert qp["layers"]["we_gate"].scale.shape == (
        tcfg.num_layers, tcfg.num_experts, tcfg.moe_intermediate_size)
    assert not isinstance(qp["layers"]["router"], quant.QuantWeight)
    sliced = tdec.layer_params(qp, 1)["we_down"]
    assert sliced.q.shape == (4, 96, 64) and sliced.scale.shape == (4, 64)
    ids = _ids(2, 10, 9)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    mask = np.ones((2, 10), np.float32)
    args = [torch.from_numpy(a) for a in (ids, pos, mask)]
    ref, _ = tdec.forward(tp, tcfg, *args)
    got, _ = tdec.forward(qp, tcfg, *args)
    ref, got = ref.detach().numpy(), got.detach().numpy()
    assert np.sqrt(np.mean((ref - got) ** 2)) / (np.std(ref) + 1e-9) < 0.05
    jgot, _ = jdec.forward(jq, jcfg, ids, pos, mask)
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
    # the same int8 tree through the converter keeps its wrappers
    back = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    assert back["layers"]["we_up"].q.dtype == torch.int8


def test_int8_engine_and_server_serve_moe(tmp_path):
    """int8 serving: the port's engine on ``quantize_params`` of the tree
    greedy-equal to the JAX engine on the reference's; a server started
    from an HF checkpoint with ``weight_quant="int8"`` quantizes the
    experts as it loads and re-quantizes a push; a preset refuses to be
    made int8 (``init_quantized_params``, dense only, as the reference)."""
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.serve import create_server

    jcfg, tcfg, jp, tp, tree = _both()
    prompts = [[1, 2, 3, 4, 5], list(range(30, 43))]
    jeng = JEngine(jcfg, jquant.quantize_params(jp), kv_cache_dtype=jnp.float32,
                   **GEOM)
    ref = jeng.generate(prompts, JSP(temperature=0.0, max_new_tokens=8))
    jeng.stop()
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    teng = CBEngine(tcfg, quant.quantize_params(tp), kv_cache_dtype=torch.float32,
                    device="cpu", **GEOM)
    out = teng.generate(prompts, sp)
    teng.stop()
    for t, j in zip(out, ref):
        assert t["token_ids"] == list(j["token_ids"])
        np.testing.assert_allclose(t["logprobs"], j["logprobs"], rtol=0,
                                   atol=LP_TOL)

    ckpt = tmp_path / "moe"
    hf_loader.save_hf_checkpoint(str(ckpt), tp, tcfg, model_type="qwen3_moe")
    server = create_server(str(ckpt), device="cpu", dtype="float32", port=0,
                           host="127.0.0.1", weight_quant="int8", max_slots=8,
                           page_size=8, max_seq_len=96, num_pages=128,
                           prompt_buckets=(16, 32))
    try:
        eng = server.engine
        assert isinstance(eng.params["layers"]["we_gate"], quant.QuantWeight)
        assert not isinstance(eng.params["layers"]["router"], quant.QuantWeight)
        assert [o["token_ids"] for o in eng.generate(prompts, sp)] == [
            o["token_ids"] for o in out]
        server.update_weights(tp)  # an f32 push, re-quantized on arrival
        assert eng.weight_version == 1
        assert [o["token_ids"] for o in eng.generate(prompts, sp)] == [
            o["token_ids"] for o in out]
    finally:
        server.stop()
    with pytest.raises(NotImplementedError, match="dense models only"):
        create_server("moe-tiny", device="cpu", dtype="float32", port=0,
                      host="127.0.0.1", weight_quant="int8")


def test_lora_wraps_attention_only():
    """``wrap_lora`` on a MoE tree wraps the attention projections and
    nothing else, as the reference does (its expert stacks bypass ``mm``);
    the adapter template lists the same leaves, and a LoRA update moves
    only the adapters."""
    from polyrl_tpu.models import lora as jlora
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    jcfg, tcfg, jp, tp, _ = _both()
    wrapped = lora.wrap_lora(tp, torch.Generator().manual_seed(0), 4)
    jwrapped = jlora.wrap_lora(jp, jax.random.PRNGKey(0), 4)
    got = sorted(k for k, v in wrapped["layers"].items()
                 if isinstance(v, quant.LoraWeight))
    want = sorted(k for k, v in jwrapped["layers"].items()
                  if isinstance(v, jquant.LoraWeight))
    assert got == want == ["wk", "wo", "wq", "wv"]
    assert sorted(lora.adapter_template(tcfg, 4)["layers"]) == got
    assert sorted(lora.extract_adapters(wrapped)["layers"]) == got
    actor = StreamActor(tcfg, ActorConfig(lr=1e-2, remat=True, lora_rank=4), tp)
    before = {k: t.detach().clone() for k, t in quant.named_leaves(actor.params)}
    rng = np.random.default_rng(0)
    b, tpmt, tr = 4, 8, 6
    batch = {
        "input_ids": rng.integers(1, 512, (b, tpmt + tr)).astype(np.int32),
        "attention_mask": np.ones((b, tpmt + tr), np.float32),
        "positions": np.broadcast_to(np.arange(tpmt + tr, dtype=np.int32),
                                     (b, tpmt + tr)).copy(),
        "responses": rng.integers(1, 512, (b, tr)).astype(np.int32),
        "response_mask": np.ones((b, tr), np.float32),
        "advantages": rng.standard_normal((b, tr)).astype(np.float32),
        "old_log_probs": np.full((b, tr), -6.0, np.float32),
    }
    batch["responses"] = batch["input_ids"][:, tpmt:]
    actor.update_stream(batch, loss_scale=1.0, is_opt_step=True)
    after = dict(quant.named_leaves(actor.params))
    moved = {k for k in after if not torch.equal(after[k].detach(), before[k])}
    assert moved and all(k.endswith((".a", ".b")) for k in moved), moved
    assert any(k.startswith("layers.wq.") for k in moved)


def test_layout_pack_install_and_checkpoint_roundtrip(tmp_path):
    """A MoE tree (rank-4 expert leaves) through the fabric's layout: the
    same layout JSON and packed bytes as the reference, unpacked bitwise;
    an expert leaf split over its expert axis by two shards covers its
    bytes once, in 2 ranges a shard per layer; an int8 MoE tree through
    the checkpoint manager restores bitwise, wrappers and all."""
    from polyrl_tpu.transfer import layout as jlayout
    from polyrl_tpu_torch.transfer import layout as L
    from polyrl_tpu_torch.utils import checkpoint as ckpt_lib

    jcfg, tcfg, jp, tp, tree = _both()
    pl = L.build_layout(tp)
    jl = jlayout.build_layout(tree)
    assert pl.to_json() == jl.to_json()
    buf = L.alloc_buffer(pl)
    L.pack_params(tp, pl, buf)
    jbuf = jlayout.alloc_buffer(jl)
    jlayout.pack_params(tree, jl, jbuf)
    np.testing.assert_array_equal(buf, jbuf)
    back = L.unflatten_like(tp, L.unpack_params(buf, pl))
    for (n, a), (_, b) in zip(L.flatten_with_names(tp), L.flatten_with_names(back)):
        assert torch.equal(a, b), n
    entry = next(e for e in pl.entries if e.name == "layers.we_gate")
    assert len(entry.shape) == 4
    ranges = L._shard_ranges(entry, 1, 2)
    assert [len(r) for r in ranges] == [tcfg.num_layers] * 2
    spans = sorted(x for r in ranges for x in r)
    assert spans[0][0] == entry.offset and sum(n for _, n in spans) == entry.nbytes
    assert all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    qp = quant.quantize_params(tp)
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"actor": qp}, {"global_step": 1})
    mgr.wait()
    items, _ = mgr.restore()
    mgr.close()
    got = ckpt_lib.unflatten_tree(items["actor"])
    assert isinstance(got["layers"]["we_down"], quant.QuantWeight)
    want = dict(quant.named_leaves(qp))
    for name, t in quant.named_leaves(got):
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name


def test_moe_tree_pushes_over_the_fabric():
    """A MoE tree pushed by the fabric's sender over two TCP streams lands
    bitwise in the receiver's buffer, unpacks to the pushed tree and
    installs into a MoE engine (``update_weights``), which then serves
    what an engine built on that tree serves."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.transfer import (ReceiverAgent, SenderAgent,
                                           TransferConfig)
    from polyrl_tpu_torch.transfer import layout as L

    _, tcfg, _, tp, _ = _both()
    _, _, _, tp2, _ = _both(seed=1)
    layout = L.build_layout(tp)
    buf = L.alloc_buffer(layout)
    sender = SenderAgent(buf, manager_client=None, listen_host="127.0.0.1",
                         num_streams=2, poll_s=0.05, advertise_host="127.0.0.1",
                         cfg=TransferConfig(prepare_timeout_s=10.0))
    sender.start()
    rx = ReceiverAgent(layout, "inst-moe", sender.endpoint, num_streams=2,
                       listen_host="127.0.0.1", advertise_host="127.0.0.1")
    rx.start()
    try:
        with sender.buffer_write_lock():
            L.pack_params(tp2, layout, buf)
        v = sender.signal_update()
        assert rx.wait_for_version(v, timeout=30.0) == v
        np.testing.assert_array_equal(rx.buffer, buf)
        got = L.unflatten_like(tp2, L.unpack_params(rx.buffer, layout))
    finally:
        rx.stop()
        sender.stop()
    for (n, a), (_, b) in zip(L.flatten_with_names(tp2), L.flatten_with_names(got)):
        assert torch.equal(a, b), n
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6]]
    eng = CBEngine(tcfg, tp, kv_cache_dtype=torch.float32, device="cpu", **GEOM)
    eng.update_weights(got)
    pushed = eng.generate(prompts, sp)[0]["token_ids"]
    eng.stop()
    ref = CBEngine(tcfg, tp2, kv_cache_dtype=torch.float32, device="cpu", **GEOM)
    assert pushed == ref.generate(prompts, sp)[0]["token_ids"]
    ref.stop()


# -- Hugging Face checkpoints -----------------------------------------------------


def _save_hf_moe(tmp_path, arch):
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  num_experts_per_tok=2, max_position_embeddings=256,
                  rms_norm_eps=1e-6, rope_theta=10000.0,
                  tie_word_embeddings=False)
    if arch == "qwen3_moe":
        hf_cfg = transformers.Qwen3MoeConfig(
            intermediate_size=64, moe_intermediate_size=48, head_dim=8,
            num_experts=4, norm_topk_prob=True, decoder_sparse_step=1,
            mlp_only_layers=[], **common)
    else:
        hf_cfg = transformers.MixtralConfig(intermediate_size=48,
                                            num_local_experts=4, **common)
    torch.manual_seed(0)
    model = transformers.AutoModelForCausalLM.from_config(hf_cfg).eval()
    out = tmp_path / arch
    model.save_pretrained(out, safe_serialization=True)
    return model, str(out)


def _jax_named(params):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = ".".join(("q", "scale")[p.key]
                        if isinstance(p, jax.tree_util.FlattenedIndexKey)
                        else str(p.key) for p in path)
        arr = np.asarray(leaf)
        out[name] = arr if arr.dtype == np.int8 else arr.astype(np.float32)
    return out


@pytest.mark.parametrize("quantize", ["", "int8"])
@pytest.mark.parametrize("arch", ["qwen3_moe", "mixtral"])
def test_hf_logits_parity(tmp_path, arch, quantize):
    """Qwen3-MoE and Mixtral checkpoints written by ``transformers``: the
    config read as the reference reads it, the tree leaf for leaf the JAX
    loader's (q bitwise, scales within an f32 ulp), the logits at a dropless
    capacity (E/k) within 2e-4 of ``transformers``' (int8: NRMSE < 0.05)."""
    from polyrl_tpu.models import hf_loader as jhf

    model, ckpt = _save_hf_moe(tmp_path, arch)
    cfg = hf_loader.config_from_hf(ckpt, dtype=torch.float32)
    jcfg = jhf.config_from_hf(ckpt, dtype=jnp.float32)
    for f in ("num_experts", "num_experts_per_tok", "moe_intermediate_size",
              "norm_topk_prob", "use_qk_norm", "intermediate_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.num_experts == 4 and cfg.use_qk_norm == (arch == "qwen3_moe")
    cfg = dataclasses.replace(cfg, moe_capacity_factor=2.0 * 4 / 2)
    params = hf_loader.load_hf_params(ckpt, cfg, quantize=quantize, device="cpu")
    want = _jax_named(jhf.load_hf_params(ckpt, jcfg, quantize=quantize))
    got = {k: v.numpy() if v.dtype == torch.int8 else v.float().numpy()
           for k, v in quant.named_leaves(params)}
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith(".scale"):
            assert np.all(np.abs(got[k] - want[k])
                          <= np.spacing(np.abs(want[k]))), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12))).long()
    with torch.no_grad():
        ref = model(ids).logits.numpy()
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12)
    out, _ = tdec.forward(params, cfg, ids, pos, torch.ones(2, 12))
    out = out.detach().numpy()
    if quantize:
        assert np.sqrt(np.mean((out - ref) ** 2)) / (np.std(ref) + 1e-9) < 0.05
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("model_type", ["qwen3_moe", "mixtral"])
def test_hf_writer_round_trip(tmp_path, model_type):
    """``save_hf_checkpoint`` of a MoE tree (two shards) loads back
    bitwise with the same config; an int8 load is ``quantize_params`` of
    the plain load, the router left in the model dtype."""
    cfg = tdec.get_config("moe-tiny", dtype=torch.bfloat16, head_dim=16,
                          use_qk_norm=model_type == "qwen3_moe",
                          intermediate_size=96 if model_type == "mixtral" else 128)
    params = tdec.init_params(torch.Generator().manual_seed(2), cfg)
    d = tmp_path / model_type
    hf_loader.save_hf_checkpoint(str(d), params, cfg, model_type=model_type,
                                 n_shards=2)
    cfg2, back = hf_loader.build_from_hf(str(d), dtype=torch.bfloat16, device="cpu")
    assert cfg2 == cfg
    want = dict(quant.named_leaves(params))
    got = dict(quant.named_leaves(back))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, q = hf_loader.build_from_hf(str(d), dtype=torch.bfloat16, quantize="int8",
                                   device="cpu")
    ref = dict(quant.named_leaves(quant.quantize_params(back)))
    got = dict(quant.named_leaves(q))
    assert got.keys() == ref.keys() and got["layers.router"].dtype == torch.bfloat16
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_hf_refuses_mixed_dense_moe_stacks(tmp_path):
    """``mlp_only_layers`` or ``decoder_sparse_step`` other than 1 refuse,
    with the reference's message."""
    import json

    for i, extra in enumerate(({"mlp_only_layers": [1]},
                               {"decoder_sparse_step": 2})):
        d = tmp_path / f"mixed{i}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps({
            "vocab_size": 100, "hidden_size": 16, "intermediate_size": 32,
            "num_hidden_layers": 2, "num_attention_heads": 2,
            "num_key_value_heads": 1, "model_type": "qwen3_moe",
            "num_experts": 4, "moe_intermediate_size": 8, **extra}))
        with pytest.raises(NotImplementedError, match="mixed dense/MoE"):
            hf_loader.config_from_hf(str(d))
