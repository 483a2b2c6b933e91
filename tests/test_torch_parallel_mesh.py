"""The port's mesh (``polyrl_tpu_torch/parallel/mesh.py``) against the JAX
package's on the conftest's 8 virtual CPU devices: ``MeshConfig.resolve``
on a grid of device counts and axes (errors included), this rank's batch
slice against the addressable shards of the JAX ``shard_batch`` (rank r is
the r-th device of the JAX mesh in row-major order), and ``shard_params``
of the converted JAX tree reassembling bit for bit. The collective gather
runs in the spawned worlds of ``tests/test_torch_multihost.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.models.quant import named_leaves
from polyrl_tpu_torch.parallel import mesh as meshlib

RESOLVE_GRID = [
    (8, dict()), (8, dict(dp=2)), (8, dict(dp=2, sp=2)), (8, dict(fsdp=2, sp=4)),
    (4, dict(dp=-1, fsdp=2)), (6, dict(dp=3, fsdp=-1)), (1, dict()),
    (8, dict(dp=3)), (8, dict(dp=2, fsdp=2, sp=1)), (8, dict(dp=-1, fsdp=-1)),
    (2, dict(dp=1, fsdp=1, tp=2)), (16, dict(fsdp=4, ep=2, pp=2)),
]


def _resolve(cls, n, kw):
    try:
        return ("ok", cls(**kw).resolve(n))
    except ValueError as exc:
        return ("error", type(exc).__name__)


@pytest.mark.parametrize("n,kw", RESOLVE_GRID,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in RESOLVE_GRID])
def test_resolve_matches_jax(n, kw):
    assert _resolve(meshlib.MeshConfig, n, kw) == _resolve(jmesh.MeshConfig, n, kw)


SPLIT_MESHES = [(2, 2, 2), (1, 2, 4), (4, 1, 2), (8, 1, 1)]


@pytest.mark.parametrize("dp,fsdp,sp", SPLIT_MESHES,
                         ids=[f"dp{a}-fsdp{b}-sp{c}" for a, b, c in SPLIT_MESHES])
def test_batch_split_matches_jax_shard_batch(devices8, dp, fsdp, sp):
    """Rows over (dp, fsdp), columns over sp, rank-1 leaves over the batch
    only, scalars whole: each rank's slice is the JAX shard on the device
    of the same mesh position."""
    rng = np.random.default_rng(0)
    tree = {"ids": rng.integers(0, 50, (8, 16)).astype(np.int32),
            "h": rng.normal(size=(8, 16, 3)).astype(np.float32),
            "adv": rng.normal(size=(8,)).astype(np.float32),
            "scale": np.float32(2.0)}
    mesh = jmesh.make_mesh(jmesh.MeshConfig(dp=dp, fsdp=fsdp, tp=1, sp=sp), devices8)
    sharded = jmesh.shard_batch(mesh, tree)
    devs = list(mesh.devices.reshape(-1))
    for rank, dev in enumerate(devs):
        tmesh = meshlib.Mesh((dp, fsdp, 1, sp, 1, 1), rank, make_groups=False)
        mine = meshlib.shard_batch(tmesh, tree)
        for k, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(shard.data),
                                          err_msg=f"rank {rank} {k}")


@pytest.fixture(scope="module")
def converted():
    cfg = jdec.get_config("tiny", dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jdec.init_params(jax.random.PRNGKey(0), cfg))
    return params_from_numpy(tree, "cpu", torch.float32)


@pytest.mark.parametrize("fsdp", [2, 3, 4])
def test_shard_params_reassemble_bitwise(converted, fsdp):
    """Every rank's ``shard_params`` of the converted tree, concatenated
    in rank order (what the fsdp all-gather returns) and trimmed, is each
    leaf bit for bit; the shards are equal-sized, padded with zeros."""
    shards = [meshlib.shard_params(
        meshlib.Mesh((1, fsdp, 1, 1, 1, 1), r, make_groups=False), converted)
        for r in range(fsdp)]
    per_rank = [dict(named_leaves(s)) for s in shards]
    for name, leaf in named_leaves(converted):
        parts = [p[name] for p in per_rank]
        assert len({p.numel() for p in parts}) == 1
        whole = torch.cat(parts)
        assert torch.equal(whole[: leaf.numel()].view(leaf.shape), leaf), name
        assert not whole[leaf.numel():].any()


def test_unported_axes_and_specs_raise(converted):
    """ep and pp are real axes now: a parameter spec over ep or pp cuts
    this rank's block before fsdp shards it, and the trainer checks a pp
    or ep mesh against the model and the batch before anything is
    spawned. What still raises: a spec over tp (tp blocks are cut by leaf
    name, ``tensor.tp_dim``) or over a name that is no parameter axis; pp
    that does not divide the layers or whose microbatches do not divide
    the micro; Ulysses inside pipeline stages; ep on a dense model."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.models import decoder
    from polyrl_tpu_torch.train import _pipeline_layers, _sp_attention

    def mesh(rank=0, **axes):
        return meshlib.Mesh(tuple(axes.get(a, 1) for a in meshlib.AXES), rank,
                            make_groups=False)

    embed = converted["embed"]
    for axis, rank in (("ep", 1), ("pp", 0)):
        m = mesh(rank, fsdp=2, **{axis: 2})
        got = meshlib.shard_params(m, converted, {"embed": (axis, "fsdp")})
        want = meshlib.shard_tensor(m, embed.chunk(2, 0)[rank].contiguous())
        assert torch.equal(got["embed"], want)
    m = mesh(fsdp=2)
    meshlib.shard_params(m, converted, {"embed": ("fsdp", None)})
    with pytest.raises(ValueError, match="tp_dim"):
        meshlib.shard_params(m, converted, {"embed": ("tp", "fsdp")})
    with pytest.raises(ValueError, match="'dp'"):
        meshlib.shard_params(m, converted, {"embed": ("dp", None)})

    tiny = decoder.get_config("tiny")
    cfg = load_config(None, ["device=cpu", "parallel.pp=2",
                             "trainer.micro_batch_size=8"])
    lf, clf = _pipeline_layers(cfg, tiny, mesh(pp=2))
    assert callable(lf) and callable(clf)
    with pytest.raises(ValueError, match="not divisible by pp"):
        _pipeline_layers(cfg, decoder.get_config("tiny", num_layers=3),
                         mesh(pp=2))
    cfg = load_config(None, ["device=cpu", "parallel.pp=2",
                             "trainer.micro_batch_size=8",
                             "parallel.pp_microbatches=3"])
    with pytest.raises(ValueError, match="pp_microbatches 3"):
        _pipeline_layers(cfg, tiny, mesh(pp=2))
    cfg = load_config(None, ["device=cpu", "parallel.ep=2"])
    with pytest.raises(ValueError, match="MoE"):
        _pipeline_layers(cfg, tiny, mesh(ep=2))
    _pipeline_layers(cfg, decoder.get_config("moe-tiny"), mesh(ep=2))
    cfg = load_config(None, ["device=cpu", "parallel.sp=2", "parallel.pp=2"])
    with pytest.raises(NotImplementedError, match="sp_mode=ring"):
        _sp_attention(cfg, tiny, mesh(sp=2, pp=2))


def test_one_process_builds_no_mesh_and_single_device_mesh():
    """One process with every axis 1: no mesh (the one-device path);
    ``single_device_mesh`` is all ones and slices nothing."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import _build_mesh

    assert _build_mesh(load_config(None, ["device=cpu"]), torch.device("cpu")) is None
    m = meshlib.single_device_mesh()
    assert m.shape == dict.fromkeys(meshlib.AXES, 1) and m.world == 1
    x = torch.arange(12).reshape(3, 4)
    assert torch.equal(meshlib.shard_batch(m, {"x": x})["x"], x)


def test_group_ranks_and_index_follow_row_major_axes():
    """Global rank = row-major over (dp, fsdp, tp, sp, ep, pp), as the JAX
    mesh's device array: the ranks of a group and a rank's index in it."""
    m = meshlib.Mesh((2, 2, 1, 2, 1, 1), 5, make_groups=False)  # dp1 fsdp0 sp1
    assert (m.coords["dp"], m.coords["fsdp"], m.coords["sp"]) == (1, 0, 1)
    assert m.group_ranks("sp") == [4, 5] and m.index("sp") == 1
    assert m.group_ranks("dp", "fsdp") == [1, 3, 5, 7] and m.index("dp", "fsdp") == 2
    assert m.group_ranks("dp", "sp") == [0, 1, 4, 5] and m.index("dp", "sp") == 3
    assert m.group_ranks(*meshlib.DATA_AXES) == list(range(8))
