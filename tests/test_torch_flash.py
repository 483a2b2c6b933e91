"""K4 parity on the CPU: the port's plain training attention against the
TPU kernel's own oracle.

``flash_attention_train_ref`` (and the wrapper, which takes it for CPU
tensors) is held against JAX's ``mha_reference_no_custom_vjp`` -- the
exact semantics of the TPU kernel, plain JAX -- on every row, and its
autograd gradients against ``jax.vjp`` of that oracle through the JAX
wrapper's ``jnp.repeat`` of the KV heads. Real rows are also held against
``polyrl_tpu.ops.flash._dense``, the JAX package's CPU path (its pad rows
follow another mask). All f32; tolerance rtol=atol=2e-5: both sides do
exact f32 arithmetic (JAX at "highest" precision, see conftest) and
differ in reduction order only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds, mha_reference_no_custom_vjp)

from polyrl_tpu.ops import flash as jflash
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import flash as tflash

TOL = dict(rtol=2e-5, atol=2e-5)
B, T, D = 2, 48, 16  # T = 48 is a multiple of no TPU block (128..1024)


def _case(hq, hkv, seed=0, packed=False):
    """q/k/v/dout and a [B, T] mask: row 0 left-padded by 7, row 1
    right-padded by 5 (or, with ``packed``, 3 segments then 4 pads)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, T, hq, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, :7] = 0
    mask[1, T - 5:] = 0
    seg = None
    if packed:
        seg = mask.astype(np.int32)
        seg[1] = np.concatenate([np.full(10, 1), np.full(17, 2), np.full(17, 3),
                                 np.zeros(4)]).astype(np.int32)
    return q, k, v, do, mask, seg


def _jax_oracle(q, k, v, mask, seg, causal):
    """The TPU kernel's semantics, exactly as flash_attention_train calls
    it: KV repeated to Hq, [B, H, T, D], segment ids from the mask."""
    hq, hkv = q.shape[2], k.shape[2]
    ids = jnp.asarray(seg) if seg is not None else jnp.asarray(mask).astype(jnp.int32)

    def f(q, k, v):
        k = jnp.repeat(k, hq // hkv, axis=2)
        v = jnp.repeat(v, hq // hkv, axis=2)
        out = mha_reference_no_custom_vjp(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), segment_ids=SegmentIds(q=ids, kv=ids),
            causal=causal, sm_scale=q.shape[-1] ** -0.5)
        return out.transpose(0, 2, 1, 3)
    return f


def _torch_run(fn, q, k, v, do, mask, seg, causal):
    qq, kk, vv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qq, kk, vv, torch.from_numpy(mask), causal=causal,
             segment_ids=None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(do))
    return [x.detach().numpy() for x in (out, qq.grad, kk.grad, vv.grad)]


@pytest.mark.parametrize("hq,hkv,packed,causal", [
    (4, 2, False, True),
    (4, 2, True, True),
    (4, 4, False, True),
    (4, 1, True, False),
])
def test_plain_k4_and_grads_match_tpu_oracle(hq, hkv, packed, causal):
    q, k, v, do, mask, seg = _case(hq, hkv, seed=hq * 10 + hkv, packed=packed)
    out_j, vjp = jax.vjp(_jax_oracle(q, k, v, mask, seg, causal),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    got = _torch_run(tflash.flash_attention_train_ref, q, k, v, do, mask, seg,
                     causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          [out_j, *grads_j]):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name, **TOL)
        assert np.isfinite(a).all(), name


def test_plain_k4_real_rows_match_the_jax_cpu_path():
    """On real rows (attn_mask > 0) K4's semantics equal the JAX
    package's CPU path, ``flash._dense``; pad rows differ by design (K4's
    pads attend pads)."""
    q, k, v, _do, mask, _seg = _case(4, 2, seed=5)
    dense = np.asarray(jflash._dense(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask), True))
    ours = tflash.flash_attention_train_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask)).numpy()
    real = mask > 0
    np.testing.assert_allclose(ours[real], dense[real], **TOL)
    assert np.isfinite(ours).all()  # pad rows stay finite (never fully masked)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    """The wrapper (and auto_train_attention) on CPU tensors is the plain
    version, gradients included, and launches nothing; the autograd
    Function itself refuses CPU tensors."""
    q, k, v, do, mask, seg = _case(4, 2, seed=7, packed=True)
    cuda_build.reset_launch_counts()
    ref = _torch_run(tflash.flash_attention_train_ref, q, k, v, do, mask, seg,
                     True)
    auto = tflash.auto_train_attention()
    assert isinstance(auto, functools.partial) and auto.keywords == {"causal": True}
    got = _torch_run(tflash.flash_attention_train, q, k, v, do, mask, seg, True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert all(n == 0 for n in cuda_build.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        tflash.FlashAttentionTrain.apply(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask).int(), True)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        tflash.flash_attention_train(x, x, x, torch.ones((1, 4), device="meta"))
