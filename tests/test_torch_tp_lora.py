"""LoRA adapter-only pushes into tp shards (``models/lora.py`` on a list of
shard trees, ``serve.create_server(tp=, lora_rank=)``) on the CPU.

- The whole tree's fingerprint from its shards: ``lora.base_stats`` of the
  ``decoder.shard_tp`` shards equals that of the unsharded tree within
  1e-6 relative (f32 means summed in another order), on a plain and on an
  int8 base.
- ``lora.apply_adapters`` into shards: each shard's ``a``/``b`` is bitwise
  the pushed adapters' ``parallel/tensor.tp_dim`` block (whole pushes and
  per-shard blocks), bases bitwise untouched, every ``data_ptr()`` kept;
  each refusal (base off by more than 5%, another target set, another
  ``alpha``, another rank) raises before any shard changes.
- Against the JAX package: ``create_server(tp=2, lora_rank=4)`` after a
  push of seeded adapters, and the JAX ``CBEngine`` on a tp=2 mesh of host
  devices serving the same wrapped tree with the same adapters installed
  by ``polyrl_tpu.models.lora.apply_adapters``: greedy tokens equal,
  logprobs within 5e-4, and the push changes the output; plain and QLoRA
  bases (the reference's own case is ``tests/test_lora.py``'s
  ``test_qlora_tp_serving_shards_base``).
- The wire path: one push from a ``TransferInterface`` through the
  receiver and ``update_weights_from_agent`` into a tp=2 LoRA server: the
  wire carries only the adapter layout, the receiver advertises two
  shards, ``weight_version`` is raised and every shard holds bitwise the
  pushed blocks.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.models import lora as jlora
from polyrl_tpu.models import quant as jquant
from polyrl_tpu.parallel import mesh as jmesh
from polyrl_tpu_torch.models import decoder, lora, quant
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.parallel.tensor import tp_dim

LP_TOL = 5e-4
FINGERPRINT_RTOL = 1e-6
TP = 2
RANK = 4
GEOM = dict(max_slots=4, page_size=8, max_seq_len=64, num_pages=64,
            prompt_buckets=(8, 16))
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


def _wrapped(quantized: bool, rank: int = RANK, alpha: float = 16.0):
    """The port's wrapped tiny tree (f32; an int8 base with ``quantized``)
    from the JAX tree of seed 0, adapters drawn from a torch generator."""
    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    tree = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0), jcfg)), "cpu",
        torch.float32)
    if quantized:
        tree = quant.quantize_params(tree)
    return lora.wrap_lora(tree, torch.Generator().manual_seed(9), rank, alpha,
                          dtype=torch.float32)


def _adapters(cfg, rank: int = RANK, alpha: float = 16.0, seed: int = 3,
              base=None) -> dict:
    """A trainer's push: ``a``/``b`` drawn from a numpy seed at the
    template's shapes, ``alpha``, and the fingerprint of ``base``."""
    rng = np.random.default_rng(seed)
    tmpl = lora.adapter_template(cfg, rank, dtype=torch.float32)
    layers = {k: {f: torch.from_numpy((rng.standard_normal(t.shape)
                                       * (0.3 if f == "a" else 0.05))
                                      .astype(np.float32))
                  for f, t in ab.items()}
              for k, ab in tmpl["layers"].items()}
    return {"layers": layers, "alpha": torch.tensor(alpha),
            "base_stats": lora.base_stats(base)}


def _block(name: str, t: torch.Tensor, s: int) -> torch.Tensor:
    d = tp_dim(name, t.shape)
    return t if d is None else t.chunk(TP, d)[s]


def _whole(shards: list) -> dict:
    """The whole wrapped tree of a tp engine's shards (every split leaf's
    blocks concatenated on its ``tp_dim``)."""
    flats = [quant.flatten(t) for t in shards]
    out = {}
    for name, t in flats[0].items():
        d = None if t.dim() == 0 else tp_dim(name, t.shape)
        out[name] = t if d is None else torch.cat([f[name] for f in flats], d)
    return quant.unflatten(out)


def _snapshot(shards: list) -> list:
    return [{n: (t.data_ptr(), t.clone()) for n, t in quant.named_leaves(s)}
            for s in shards]


def _adapter_leaves_equal(shards: list, adapters: dict) -> None:
    for s, shard in enumerate(shards):
        for k, ab in adapters["layers"].items():
            for f in ("a", "b"):
                got = getattr(shard["layers"][k], f)
                want = _block(f"layers.{k}.{f}", ab[f], s).to(got.dtype)
                assert torch.equal(got, want), (s, k, f)


def _bases_kept(shards: list, snap: list) -> None:
    for shard, before in zip(shards, snap):
        for n, t in quant.named_leaves(shard):
            ptr, old = before[n]
            assert t.data_ptr() == ptr, n
            if not n.endswith((".a", ".b")):
                assert torch.equal(t, old), n


# -- the fingerprint ----------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["plain", "int8"])
def test_shard_fingerprint_is_the_whole_trees(quantized):
    """The mean |w| of each base's first and last layer slab over the
    shards' blocks (an int8 block dequantized with its own block of the
    scale, or the whole scale on a row split) equals the unsharded tree's
    within 1e-6 relative."""
    tree = _wrapped(quantized)
    shards = decoder.shard_tp(tree, TP, ["cpu"] * TP)
    got, want = lora.base_stats(shards), lora.base_stats(tree)
    assert got.shape == want.shape == (7, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               rtol=FINGERPRINT_RTOL, atol=0)


# -- apply into shards --------------------------------------------------------

APPLY_CASES = ["whole", "blocks", "base_off", "targets", "alpha", "rank"]


@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_adapters_into_shards(case):
    """A push lands each shard's ``tp_dim`` block of ``a``/``b`` in place
    (the whole tree cut here, or the per-shard blocks a sharded receiver
    lands), the int8 bases untouched and every address kept; a push that
    fails a whole-tree check leaves every shard as it was."""
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    tree = _wrapped(quantized=True)
    shards = decoder.shard_tp(tree, TP, ["cpu"] * TP)
    push = _adapters(cfg, base=tree)
    snap = _snapshot(shards)
    if case in ("whole", "blocks"):
        arg = push if case == "whole" else [
            {"layers": {k: {f: _block(f"layers.{k}.{f}", t, s)
                            for f, t in ab.items()}
                        for k, ab in push["layers"].items()},
             "alpha": push["alpha"], "base_stats": push["base_stats"]}
            for s in range(TP)]
        assert lora.apply_adapters(shards, arg) is shards
        _adapter_leaves_equal(shards, push)
        _bases_kept(shards, snap)
        return
    if case == "base_off":
        push["base_stats"] = push["base_stats"] * 1.06
        match = "frozen base"
    elif case == "targets":
        del push["layers"]["w_gate"]
        targets = [k for k in sorted(tree["layers"])
                   if isinstance(tree["layers"][k], quant.LoraWeight)]
        keep = [i for i, k in enumerate(targets) if k != "w_gate"]
        push["base_stats"] = push["base_stats"][keep]
        match = "target sets"
    elif case == "alpha":
        push["alpha"] = torch.tensor(8.0)
        match = "lora_alpha mismatch"
    else:
        push = _adapters(cfg, rank=2 * RANK, base=tree)
        match = "lora_rank mismatch"
    with pytest.raises(ValueError, match=match):
        lora.apply_adapters(shards, push)
    for shard, before in zip(shards, snap):
        for n, t in quant.named_leaves(shard):
            assert t.data_ptr() == before[n][0] and torch.equal(t, before[n][1]), n


# -- the tp LoRA server against the JAX tp engine -----------------------------


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, quant.LoraWeight):
        return jquant.LoraWeight(_to_jax(tree.base), _to_jax(tree.a),
                                 _to_jax(tree.b), tree.alpha)
    if isinstance(tree, quant.QuantWeight):
        return jquant.QuantWeight(_to_jax(tree.q), _to_jax(tree.scale))
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _tp_lora_server(weight_quant: str = ""):
    from polyrl_tpu_torch.rollout.serve import create_server

    return create_server("tiny", device="cpu", host="127.0.0.1", port=0,
                         dtype="float32", seed=0, weight_quant=weight_quant,
                         lora_rank=RANK, tp=TP, **GEOM)


def _greedy(n: int = 8):
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    return SamplingParams(temperature=0.0, max_new_tokens=n, stop_token_ids=())


@pytest.mark.parametrize("weight_quant", ["", "int8"], ids=["lora", "qlora"])
def test_tp_lora_server_matches_the_jax_tp_engine(devices8, weight_quant):
    """The port's tp=2 LoRA server after an adapter push and the JAX tp=2
    mesh engine on the same wrapped tree with the same adapters installed
    by the reference's ``apply_adapters``: greedy tokens equal, logprobs
    within 5e-4; the push changes the output."""
    from polyrl_tpu.rollout.cb_engine import CBEngine as JEngine
    from polyrl_tpu.rollout.sampling import SamplingParams as JSP

    srv = _tp_lora_server(weight_quant)
    try:
        eng = srv.engine
        assert eng.tp == TP and srv.weight_apply is lora.apply_adapters
        whole = _whole(eng.params)
        if weight_quant:
            assert isinstance(whole["layers"]["wq"].base, quant.QuantWeight)
        push = _adapters(eng.cfg, base=whole)
        before = eng.generate(PROMPTS, _greedy())
        v0 = eng.weight_version
        srv.update_weights(push)
        assert eng.weight_version == v0 + 1
        _adapter_leaves_equal(eng.params, push)
        after = eng.generate(PROMPTS, _greedy())
    finally:
        srv.stop()
    jcfg = jdec.get_config("tiny", dtype=jnp.float32)
    mesh = jmesh.make_mesh(jmesh.MeshConfig(fsdp=1, tp=TP), devices8[:TP])
    jeng = JEngine(jcfg, _to_jax(whole), mesh=mesh, pad_token_id=0,
                   kv_cache_dtype=jnp.float32, **GEOM)
    try:
        jeng.update_weights(jlora.apply_adapters(jeng.params, _to_jax(push)))
        ref = jeng.generate(PROMPTS, JSP(temperature=0.0, max_new_tokens=8,
                                         stop_token_ids=()), timeout=120.0)
    finally:
        jeng.stop()
    assert [o["token_ids"] for o in after] != [o["token_ids"] for o in before]
    for got, r in zip(after, ref):
        assert got["token_ids"] == list(r["token_ids"])
        np.testing.assert_allclose(got["logprobs"], r["logprobs"], rtol=0,
                                   atol=LP_TOL)


# -- the wire -----------------------------------------------------------------


def test_tp_lora_push_through_the_fabric():
    """One adapter push from a replicated sender through the receiver into
    a tp=2 LoRA server: the layout is the adapter template's (under a
    fifth of the full tree), ``transfer_shard_tp`` is 2, the version is
    raised, every shard holds bitwise the pushed blocks at its old
    addresses, the bases untouched."""
    from polyrl_tpu_torch.rollout.serve import attach_receiver
    from polyrl_tpu_torch.transfer import layout as L
    from polyrl_tpu_torch.transfer.interface import TransferInterface

    srv = _tp_lora_server()
    eng = srv.engine
    push = _adapters(eng.cfg, base=_whole(eng.params))
    snap = _snapshot(eng.params)
    iface = TransferInterface(push, manager_client=None, num_streams=2,
                              poll_s=0.05, advertise_host="127.0.0.1")
    try:
        assert attach_receiver(srv, iface.sender.endpoint, transfer_streams=2)
        deadline = time.monotonic() + 30
        while not iface.sync_health():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        v = iface.update_weights_async(push)
        iface.wait_pushed(timeout=30.0)
        ok, msg = srv.update_weights_from_agent(v)
        assert ok, msg
        assert eng.weight_version == v
        info = srv.server_info()
        assert info["transfer_shard_tp"] == TP
        tmpl = lora.adapter_template(eng.cfg, RANK)
        assert srv.receiver.layout.total_bytes == L.build_layout(tmpl).total_bytes
        assert srv.receiver.layout.total_bytes < L.build_layout(
            decoder.init_meta_params(eng.cfg)).total_bytes / 5
        assert srv.weight_syncs[-1]["bytes"] == srv.receiver.layout.total_bytes
        _adapter_leaves_equal(eng.params, push)
        _bases_kept(eng.params, snap)
    finally:
        iface.close()
        srv.stop()


def test_no_refusal_left():
    """``serve --tp 2 --lora-rank 4`` builds on a plain and on an int8
    base, and a tp=2 engine on two devices keeps its spill tier: one lane
    a shard, on the shard's device."""
    from polyrl_tpu_torch.rollout import serve
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    for extra in ([], ["--weight-quant", "int8"]):
        args = serve.parse_args(["--model", "tiny", "--device", "cpu",
                                 "--dtype", "float32", "--port", "0",
                                 "--lora-rank", "4", "--tp", "2",
                                 "--max-seq-len", "64", "--page-size", "8",
                                 "--num-pages", "16", "--prompt-buckets",
                                 "16"] + extra)
        srv = serve.server_from_args(args)
        try:
            wq = srv.engine.params[1]["layers"]["wq"]
            assert isinstance(wq, quant.LoraWeight)
            assert isinstance(wq.base, quant.QuantWeight) == bool(extra)
            assert srv.engine.kvspill is not None
        finally:
            srv.stop()
    devs = [torch.device("cpu"), torch.device("cpu", 0)]
    cfg = decoder.get_config("tiny", dtype=torch.float32)
    eng = CBEngine(cfg, decoder.init_params(torch.Generator().manual_seed(0),
                                            cfg),
                   kv_cache_dtype=torch.float32, device="cpu", tp=TP,
                   tp_devices=devs, kv_spill=True, **GEOM)
    try:
        assert [lane.device for lane in eng.kvspill.lanes] == devs
        out = eng.generate(PROMPTS, _greedy(4))
        assert all(len(o["token_ids"]) == 4 for o in out)
    finally:
        eng.stop()
