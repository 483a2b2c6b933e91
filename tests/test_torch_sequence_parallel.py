"""The port's sequence-parallel attention (``parallel/sequence.py``)
against the JAX package's ``make_sp_attention``, mirroring
``tests/test_sequence_parallel.py``: Ulysses and ring, with GQA (``hkv``)
and left-padding cases, plain and packed (segments spanning the sp
boundary), on sp 4 (4 ranks) and sp 2 beside dp 2 (4 ranks: rows split
too). The port runs in one spawned 4-rank gloo world (``tests/
torch_dist.py``, task ``sp_attention``) on each rank's slice of the same
numpy inputs; the JAX side on the conftest's virtual devices. Forward and
the gradients of ``sum(valid * out^2)`` agree within rtol 1e-5 / atol
1e-5 in f32 at valid positions (pad rows' outputs are garbage in both and
masked out of the loss). Plus the minimal GQA expansion and "ring never
expands KV" (the shapes the ring rotates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu.parallel.sequence import _expand_kv_minimal as j_expand
from polyrl_tpu.parallel.sequence import make_sp_attention as j_make
from polyrl_tpu_torch.parallel.sequence import _expand_kv_minimal
from tests.torch_dist import load, run_world

SP_TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {(1, 4): "sp4", (2, 2): "dp2-sp2"}
VARIANTS = [("plain", 8, 0), ("plain", 2, 0), ("plain", 8, 5),
            ("packed", 8, 0), ("packed", 2, 0)]


def _case(rng, packed, hkv, left_pad, b=4, t=32, hq=8, d=16):
    q = rng.normal(size=(b, t, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, hkv, d)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    seg = np.zeros((b, t), np.int32)
    if packed:
        # segment 2 spans the sp boundaries (the JAX test's layout)
        u = t // 16
        for s, e, sid in [(0, 3 * u, 1), (3 * u, 10 * u, 2), (10 * u, 15 * u, 3)]:
            seg[:, s:e] = sid
        seg[0, 15 * u:] = 4
        mask = (seg > 0).astype(np.float32)
        valid = mask
    else:
        mask[:, :left_pad] = 0.0
        valid = mask
    return dict(q=q, k=k, v=v, mask=mask, seg=seg, valid=valid.astype(np.float32),
                packed=packed)


def _key(mode, mesh, variant):
    kind, hkv, lp = variant
    return f"{MESHES[mesh]}-{mode}-{kind}-hkv{hkv}-lp{lp}"


CASE_KEYS = [(_key(m, mesh, var), m, mesh, var) for mesh in MESHES
             for m in ("ulysses", "ring") for var in VARIANTS]


def _jax_case(devices8, case, mode, mesh_dims):
    dp, sp = mesh_dims
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, fsdp=1, tp=1, sp=sp),
                           devices8[: dp * sp])
    fn = j_make(mesh, mode, packed=case["packed"])
    spec = NamedSharding(mesh, P(("dp", "fsdp"), "sp", None, None))
    mspec = NamedSharding(mesh, P(("dp", "fsdp"), "sp"))
    valid = jnp.asarray(case["valid"])[:, :, None, None] > 0
    extra = ((jax.device_put(jnp.asarray(case["seg"]), mspec),)
             if case["packed"] else ())
    mask = jax.device_put(jnp.asarray(case["mask"]), mspec)

    def loss(q, k, v):
        out = fn(q, k, v, mask, *extra)
        return (jnp.where(valid, out, 0.0) ** 2).sum(), out

    args = [jax.device_put(jnp.asarray(case[n]), spec) for n in ("q", "k", "v")]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory):
    """The cases' inputs, the port's results from one 4-rank world."""
    root = tmp_path_factory.mktemp("sp_world")
    rng = np.random.default_rng(0)
    cases = {}
    for key, mode, mesh, (kind, hkv, lp) in CASE_KEYS:
        cases[key] = dict(_case(rng, kind == "packed", hkv, lp), mode=mode,
                          mesh=mesh)
    torch.save(cases, root / "sp_cases.pt")
    run_world(["sp_attention"], 4, root, timeout=240)
    got = load(root, "sp_attention")
    return cases, got


@pytest.mark.parametrize("key,mode,mesh,variant", CASE_KEYS,
                         ids=[c[0] for c in CASE_KEYS])
def test_sp_attention_matches_jax(sp_world, devices8, key, mode, mesh, variant):
    cases, got = sp_world
    case = cases[key]
    want_out, want_grads = _jax_case(devices8, case, mode, mesh)
    valid = case["valid"][:, :, None, None] > 0
    np.testing.assert_allclose(np.where(valid, got[key]["out"], 0),
                               np.where(valid, want_out, 0), **SP_TOL)
    for name, g, w in zip("qkv", got[key]["grads"], want_grads):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **SP_TOL)


def test_ring_never_expands_kv(sp_world):
    """The ring rotates K/V blocks at hkv heads: heads never leave their
    rank, so GQA needs no expansion (b/dp x T/sp x hkv x d on every
    rotation; 3 rotations a tensor at sp 4)."""
    _, got = sp_world
    for mesh, (b, t) in (((1, 4), (4, 8)), ((2, 2), (2, 16))):
        shapes = got[_key("ring", mesh, ("plain", 2, 0))]["rotated"]
        assert shapes and set(shapes) == {(b, t, 2, 16)}, shapes
        assert len(shapes) == 2 * (mesh[1] - 1)


@pytest.mark.parametrize("hkv,hq,sp", [(2, 8, 4), (8, 8, 4), (8, 32, 16),
                                       (4, 12, 8), (1, 4, 4)])
def test_ulysses_minimal_gqa_expansion_matches_jax(hkv, hq, sp):
    """hkv % sp != 0 expands KV by the SMALLEST valid factor (the JAX
    rule); divisible counts pass through untouched (the same tensor)."""
    k = torch.arange(2 * 3 * hkv * 4, dtype=torch.float32).reshape(2, 3, hkv, 4)
    k2, v2 = _expand_kv_minimal(k, k, hq, sp)
    jk, _ = j_expand(jnp.asarray(k.numpy()), jnp.asarray(k.numpy()), hq, sp)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk))
    assert v2.shape == k2.shape
    if hkv % sp == 0:
        assert k2 is k
