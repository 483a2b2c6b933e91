"""The fused decode prologue (``paged_kv_write_fused``, K1 redesigned) on
the CPU: its plain version against the JAX chain it stands for, and the
decode step's default (fused) route against the unfused one.

The JAX side is ``polyrl_tpu.models.decoder``'s ``rms_norm`` and
``apply_rope`` feeding ``paged_kv_write_pallas`` in interpret mode, on the
same numpy inputs in f32. Tolerance rtol 1e-5 / atol 1e-6 on q and the
written k rows (the two frameworks' f32 sum of squares and rsqrt may
differ in the last bits); the v rows and every untouched pool row are
copies and are compared bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.ops import paged_attention as jpa
from polyrl_tpu_torch.models import decoder as tdec
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import paged_attention as tpa
from test_torch_cuda_kernels import fused_case, fused_operands
from test_torch_decoder import _both, _prefill_both

TOL = dict(rtol=1e-5, atol=1e-6)
EPS = 1e-6


def _jax_chain(c, hq, hkv, d):
    """rms_norm -> apply_rope -> paged_kv_write_pallas (interpret), as the
    JAX decode step runs them; returns (q [S, Hq, D], k_pool, v_pool)."""
    s = c["q"].shape[0]
    q = jnp.asarray(c["q"]).reshape(s, 1, hq, d)
    k = jnp.asarray(c["k"]).reshape(s, 1, hkv, d)
    if c["q_norm"] is not None:
        q = jdec.rms_norm(q, jnp.asarray(c["q_norm"]), EPS)
        k = jdec.rms_norm(k, jnp.asarray(c["k_norm"]), EPS)
    cos, sin = jnp.asarray(c["cos"])[:, None], jnp.asarray(c["sin"])[:, None]
    q, k = jdec.apply_rope(q, cos, sin), jdec.apply_rope(k, cos, sin)
    kp, vp = jpa.paged_kv_write_pallas(
        c["k_pool"], c["v_pool"], c["write_page"], c["write_off"],
        k[:, 0], jnp.asarray(c["v"]).reshape(s, hkv, d), interpret=True)
    return np.asarray(q[:, 0]), np.asarray(kp), np.asarray(vp)


@pytest.mark.parametrize("norm", [True, False], ids=["qk_norm", "no_qk_norm"])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_plain_matches_jax_chain(d, norm):
    """An inactive slot on page 0 and targets at offset 0 and page - 1
    (``fused_case``); the plain version writes the pools in place."""
    hq, hkv, page = 4, 2, 8
    c = fused_case(np.random.default_rng(d + norm), s=6, hq=hq, hkv=hkv, d=d,
                   n=16, page=page, norm=norm)
    jq, jk, jv = _jax_chain(c, hq, hkv, d)
    t = fused_operands(c, "cpu", torch.float32)
    q = tpa.paged_kv_write_fused(**t, eps=EPS)
    kp, vp = t["k_pool"].numpy(), t["v_pool"].numpy()
    assert q.shape == (6, hq, d)
    np.testing.assert_allclose(q.numpy(), jq, **TOL)
    page_ids, off = c["write_page"], c["write_off"]
    written = np.zeros(kp.shape[:3], bool)
    written[:, page_ids, off] = True
    np.testing.assert_allclose(kp[written], jk[written], **TOL)
    np.testing.assert_array_equal(kp[~written], jk[~written])
    np.testing.assert_array_equal(kp[~written], c["k_pool"][~written])
    np.testing.assert_array_equal(vp, jv)
    # the written v rows are the update itself, in slot order per head
    np.testing.assert_array_equal(
        vp[:, page_ids, off], c["v"].reshape(6, hkv, d).transpose(1, 0, 2))


@pytest.mark.parametrize("name", ["tiny", "qwen3", "qwen2.5"])
def test_decode_default_route_matches_unfused_route(name):
    """``forward_paged_decode`` without ``kv_write_fn`` (the fused route)
    against ``kv_write_fn=paged_kv_write`` (qk-norm and RoPE eager, then
    the write) over four steps from the same prefilled pools: logits and
    pools bitwise equal on the CPU, where both run the same plain chain."""
    (_jc, tcfg, _jp, tp, _jpools, pools, _jl, _tl, _ids,
     lens) = _prefill_both(name)
    other = ([p.clone() for p in pools[0]], [p.clone() for p in pools[1]])
    table = torch.tensor([[3, 5, 6, 0], [9, 10, 0, 0], [11, 0, 0, 0]],
                         dtype=torch.int32)
    seq = torch.tensor([*lens, 0], dtype=torch.int32)
    active = torch.tensor([True, True, False])  # slot 2 idle: null page
    rng = np.random.default_rng(8)
    cuda_build.reset_launch_counts()
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(1, tcfg.vocab_size, 3))
        fused, _ = tdec.forward_paged_decode(tp, tcfg, tok, seq, pools, table,
                                             seq, active=active)
        unfused, _ = tdec.forward_paged_decode(
            tp, tcfg, tok, seq, other, table, seq, active=active,
            kv_write_fn=tpa.paged_kv_write)
        assert torch.equal(fused, unfused)
        seq = seq + active.int()
    for a, b in zip(pools[0] + pools[1], other[0] + other[1]):
        assert torch.equal(a, b)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())


def test_decode_default_route_calls_the_fused_wrapper_once_a_layer(monkeypatch):
    """The default route hands each layer's projected rows, qk-norm weights
    and the step's cos/sin to ``paged_kv_write_fused`` once, and never
    calls the eager qk-norm/RoPE helpers."""
    _jc, tcfg, _jp, tp = _both("qwen3")
    pools = tdec.make_paged_pools(tcfg, 8, 8, dtype=torch.float32)
    calls = []
    real = tpa.paged_kv_write_fused

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    def forbidden(*_a, **_k):
        raise AssertionError("the eager qk-norm/RoPE ran on the fused route")

    monkeypatch.setattr(tdec, "paged_kv_write_fused", spy)
    monkeypatch.setattr(tdec, "_qk_norm_rope", forbidden)
    tok = torch.tensor([5, 9])
    seq = torch.tensor([3, 0], dtype=torch.int32)
    table = torch.tensor([[2, 0], [3, 0]], dtype=torch.int32)
    tdec.forward_paged_decode(tp, tcfg, tok, seq, pools, table, seq)
    assert len(calls) == tcfg.num_layers
    for layer, (args, _kw) in enumerate(calls):
        q_norm, k_norm = args[9], args[10]
        assert torch.equal(q_norm, tp["layers"]["q_norm"][layer])
        assert torch.equal(k_norm, tp["layers"]["k_norm"][layer])
        assert args[7].shape == (2, tcfg.head_dim_ // 2)  # cos [S, D/2]
