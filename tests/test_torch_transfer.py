"""The port's weight fabric on the CPU, held against the JAX package's.

Mirrors ``tests/test_transfer.py`` (layout round trip, a two-stream push,
the streamed pack), ``tests/test_transfer_ft.py`` (a corrupted frame
rejected and re-sent, a stalled stream timed out and retried) and
``tests/test_resharding_map.py`` (the map's atoms and stream plans). The
wire is shared, so the port's layout must be the reference's byte for
byte: the layout JSON equal, the packed bytes equal (f32 and bf16 trees
from the same seeded parameters, converted with ``models/convert.py``),
the resharding atoms equal for 1-4 synthetic shards, and the JAX
package's ``TransferInterface`` must land the converted parameters
bitwise in the port's ``ReceiverAgent`` (and the port's sender in the
reference's receiver). Every comparison is exact; waits have deadlines.
"""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyrl_tpu.models import decoder as jdec
from polyrl_tpu.transfer import TransferInterface as JTransferInterface
from polyrl_tpu.transfer import agents as jagents
from polyrl_tpu.transfer import layout as jlayout
from polyrl_tpu_torch.models.convert import params_from_numpy
from polyrl_tpu_torch.rollout.faults import (TransferFaultConfig,
                                             TransferFaultInjector)
from polyrl_tpu_torch.transfer import (ReceiverAgent, SenderAgent,
                                       TransferConfig, TransferInterface)
from polyrl_tpu_torch.transfer import layout as L
from polyrl_tpu_torch.transfer import tcp_engine as te


def _jax_tree(dtype, seed=0):
    cfg = jdec.get_config("tiny", dtype=dtype)
    return jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(seed), cfg))


def _port_tree(tree, dtype):
    return params_from_numpy(tree, "cpu", dtype)


def _bytes_of(params, layout_mod, layout):
    buf = layout_mod.alloc_buffer(layout)
    layout_mod.pack_params(params, layout, buf)
    return buf


def _tree_equal(a: dict, b: dict) -> None:
    fa, fb = L.flatten_with_names(a), L.flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (n, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def _wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.02)


def _fast_cfg(**kw):
    """Tight bandwidth-keyed deadlines and a short backoff, so that the
    fault drills resolve in well under a second."""
    base = dict(min_bandwidth_mbps=1000.0, deadline_slack_s=2.0,
                stream_slack_s=2.0, retry_budget=2, backoff_base_s=0.05,
                backoff_max_s=0.2, prepare_timeout_s=10.0)
    base.update(kw)
    return TransferConfig(**base)


def _pair(params, cfg=None, fault=None, streams=2):
    layout = L.build_layout(params)
    buf = L.alloc_buffer(layout)
    sender = SenderAgent(buf, manager_client=None, listen_host="127.0.0.1",
                         num_streams=streams, poll_s=0.05,
                         advertise_host="127.0.0.1", cfg=cfg or _fast_cfg(),
                         fault=fault)
    sender.start()
    rx = ReceiverAgent(layout, "inst-t", sender.endpoint, num_streams=streams,
                       listen_host="127.0.0.1", advertise_host="127.0.0.1")
    rx.start()
    return layout, buf, sender, rx


def _push(sender, layout, buf, params) -> int:
    with sender.buffer_write_lock():
        L.pack_params(params, layout, buf)
    return sender.signal_update()


# -- layout -------------------------------------------------------------------


def test_layout_json_equals_the_references():
    tree = _jax_tree(jnp.float32)
    want = jlayout.build_layout(tree).to_json()
    got = L.build_layout(_port_tree(tree, torch.float32)).to_json()
    assert got == want
    # a meta-tensor template (an int8 server's wire layout) gives the same
    assert L.build_layout(L.unflatten_names({
        n: torch.empty(t.shape, dtype=t.dtype, device="meta")
        for n, t in L.flatten_with_names(_port_tree(tree, torch.float32))
    })).to_json() == want
    assert L.ParamLayout.from_json(got) == L.build_layout(
        _port_tree(tree, torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_bytes_equal_the_references(dtype):
    tree = _jax_tree(getattr(jnp, dtype), seed=3)
    jl = jlayout.build_layout(tree)
    want = _bytes_of(tree, jlayout, jl)
    port = _port_tree(tree, getattr(torch, dtype))
    pl = L.build_layout(port)
    assert pl.to_json() == jl.to_json()
    got = _bytes_of(port, L, pl)
    np.testing.assert_array_equal(got, want)
    # the streamed pack reaches the same bytes, its watermark monotone
    marks = []
    buf = L.alloc_buffer(pl)
    L.pack_params_streaming(port, pl, buf, marks.append, group_bytes=4096)
    np.testing.assert_array_equal(buf, want)
    assert marks == sorted(marks) and marks[-1] == pl.total_bytes
    # and unpacks to the same tensors
    _tree_equal(L.unflatten_like(port, L.unpack_params(got, pl)), port)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_resharding_map_atoms_equal_the_references(shards):
    """Synthetic specs (every other entry sharded on its last axis on the
    engine side, on its first on the trainer side) over the tiny layout:
    the same atoms, reshard bytes and stream plans in both packages."""
    layout_json = L.build_layout(
        _port_tree(_jax_tree(jnp.float32), torch.float32)).to_json()
    pl, jl = L.ParamLayout.from_json(layout_json), \
        jlayout.ParamLayout.from_json(layout_json)
    names = [e.name for e in pl.entries]
    t_axes = {n: 0 for n in names[::2]}
    e_axes = {n: len(e.shape) - 1 for e in pl.entries[1::2] for n in [e.name]}
    pm = L.build_resharding_map(pl, L.ShardSpec(shards, t_axes),
                                L.ShardSpec(shards, e_axes))
    jm = jlayout.build_resharding_map(jl, jlayout.ShardSpec(shards, t_axes),
                                      jlayout.ShardSpec(shards, e_axes))
    assert pm.atoms == jm.atoms
    assert pm.reshard_bytes() == jm.reshard_bytes()
    for n in (1, 2, 4):
        assert pm.stream_assignments(n) == jm.stream_assignments(n)
    spec = L.ShardSpec(shards, e_axes)
    assert L.ShardSpec.from_jsonable(spec.to_jsonable()) == spec


def test_incremental_installer_fills_a_staging_tree():
    port = _port_tree(_jax_tree(jnp.float32, seed=5), torch.float32)
    layout = L.build_layout(port)
    buf = _bytes_of(port, L, layout)
    install, staging = L.make_incremental_installer(layout, "cpu")
    for e in layout.entries:
        install(e, buf[e.offset:e.offset + e.nbytes])
    _tree_equal(L.unflatten_names(staging), port)
    # a second install reuses the staging tensors
    before = {n: t.data_ptr() for n, t in staging.items()}
    install2, staging2 = L.make_incremental_installer(layout, "cpu", staging)
    for e in layout.entries:
        install2(e, buf[e.offset:e.offset + e.nbytes])
    assert {n: t.data_ptr() for n, t in staging2.items()} == before


# -- the fabric -----------------------------------------------------------------


def test_two_stream_push_lands_the_source_bytes():
    port = _port_tree(_jax_tree(jnp.float32, seed=1), torch.float32)
    layout, buf, sender, rx = _pair(port)
    try:
        v = _push(sender, layout, buf, port)
        assert rx.wait_for_version(v, timeout=30.0) == v
        np.testing.assert_array_equal(rx.buffer, buf)
        port2 = _port_tree(_jax_tree(jnp.float32, seed=2), torch.float32)
        v2 = _push(sender, layout, buf, port2)
        assert rx.wait_for_version(v2, timeout=30.0) == v2
        _tree_equal(L.unflatten_like(port2, L.unpack_params(rx.buffer, layout)),
                    port2)
        _wait_for(lambda: sender.rounds_verified >= 2, msg="bookkeeping")
        assert rx.health()["transfer_rounds_verified"] == 2
    finally:
        rx.stop()
        sender.stop()


def test_corrupted_frame_is_rejected_and_resent(monkeypatch):
    """A frame corrupted on the wire fails its CRC32 trailer, the round
    is not installed, and the retry re-sends only the failed range."""
    monkeypatch.setattr(te, "STREAM_STRIPE", 4096)
    port = _port_tree(_jax_tree(jnp.float32, seed=11), torch.float32)
    fault = TransferFaultInjector(TransferFaultConfig(enabled=True,
                                                      corrupt_frames=1))
    layout, buf, sender, rx = _pair(port, fault=fault)
    try:
        v = _push(sender, layout, buf, port)
        assert rx.wait_for_version(v, timeout=30.0) == v
        _wait_for(lambda: sender.rounds_verified >= 1, msg="bookkeeping")
        assert fault.corruptions == 1
        assert rx.sockets.crc_failures == 1 and rx.verify_failures == 1
        assert 0 < sender.resumed_bytes < layout.total_bytes
        np.testing.assert_array_equal(rx.buffer, buf)
    finally:
        rx.stop()
        sender.stop()


def test_stalled_stream_times_out_and_is_retried():
    """One stream stalls past its bandwidth-keyed deadline: the attempt
    times out, the stream's ranges are pushed again, and the version
    lands bitwise."""
    port = _port_tree(_jax_tree(jnp.float32, seed=12), torch.float32)
    fault = TransferFaultInjector(TransferFaultConfig(
        enabled=True, stall_s=1.5, stall_streams=1))
    cfg = _fast_cfg(deadline_slack_s=0.4, stream_slack_s=0.4)
    layout, buf, sender, rx = _pair(port, cfg=cfg, fault=fault)
    try:
        v = _push(sender, layout, buf, port)
        assert rx.wait_for_version(v, timeout=30.0) == v
        _wait_for(lambda: sender.rounds_verified >= 1, msg="bookkeeping")
        assert fault.stalls == 1
        assert sender.push_retries >= 1 and sender.laggard_escalations == 0
        np.testing.assert_array_equal(rx.buffer, buf)
    finally:
        rx.stop()
        sender.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_sender_lands_bitwise_in_the_port_receiver(dtype):
    """The JAX package's TransferInterface (managerless) pushes its tree;
    the port's receiver, with the layout built from the converted tree,
    lands it, and the installed staging tree equals the converted
    parameters bitwise: one wire and one layout."""
    tree = _jax_tree(getattr(jnp, dtype), seed=7)
    port = _port_tree(tree, getattr(torch, dtype))
    iface = JTransferInterface(tree, manager_client=None, num_streams=2,
                               poll_s=0.05, advertise_host="127.0.0.1")
    rx = ReceiverAgent(L.build_layout(port), "inst-x", iface.sender.endpoint,
                       num_streams=2, listen_host="127.0.0.1",
                       advertise_host="127.0.0.1")
    rx.start()
    try:
        _wait_for(lambda: "inst-x" in iface.sync_health(), msg="registration")
        v = iface.update_weights_with_agent(tree)
        install, staging = L.make_incremental_installer(rx.layout, "cpu")
        assert rx.wait_for_version(v, timeout=30.0, on_tensor=install) == v
        _tree_equal(L.unflatten_names(staging), port)
    finally:
        rx.stop()
        # wake the reference sender's accept loop so its stop joins at once
        iface.sender._server.shutdown(socket.SHUT_RDWR)
        iface.close()


def test_port_sender_lands_bitwise_in_the_reference_receiver():
    """And back: the port's TransferInterface, asynchronously, into the
    JAX package's ReceiverAgent."""
    tree = _jax_tree(jnp.float32, seed=8)
    port = _port_tree(tree, torch.float32)
    iface = TransferInterface(port, manager_client=None, num_streams=2,
                              poll_s=0.05, advertise_host="127.0.0.1")
    rx = jagents.ReceiverAgent(jlayout.build_layout(tree), "inst-j",
                               iface.sender.endpoint, num_streams=2,
                               listen_host="127.0.0.1",
                               advertise_host="127.0.0.1")
    rx.start()
    try:
        _wait_for(lambda: "inst-j" in iface.sync_health(), msg="registration")
        v = iface.update_weights_async({k: v for k, v in port.items()})
        iface.wait_pushed(timeout=30.0)
        assert rx.wait_for_version(v, timeout=30.0) == v
        np.testing.assert_array_equal(rx.buffer, _bytes_of(tree, jlayout,
                                                           rx.layout))
        assert iface.push_log[-1]["version"] == v
    finally:
        rx.stop()
        iface.close()


def test_async_pushes_queue_behind_each_other():
    """Two async pushes issued back to back land in order, the later one
    last, and the lag gate drains to zero."""
    port = _port_tree(_jax_tree(jnp.float32, seed=9), torch.float32)
    iface = TransferInterface(port, manager_client=None, num_streams=2,
                              poll_s=0.05, advertise_host="127.0.0.1")
    rx = ReceiverAgent(iface.layout, "inst-q", iface.sender.endpoint,
                       num_streams=2, listen_host="127.0.0.1",
                       advertise_host="127.0.0.1")
    rx.start()
    try:
        _wait_for(lambda: "inst-q" in iface.sync_health(), msg="registration")
        port2 = _port_tree(_jax_tree(jnp.float32, seed=10), torch.float32)
        v1 = iface.update_weights_async(port)
        v2 = iface.update_weights_async(port2)
        assert v2 == v1 + 1
        iface.wait_push_lag(0, timeout=30.0)
        assert iface.push_lag() == 0
        assert rx.wait_for_version(v2, timeout=30.0) == v2
        _tree_equal(L.unflatten_like(port2, L.unpack_params(rx.buffer,
                                                            rx.layout)), port2)
        assert not [t for t in threading.enumerate()
                    if t.name == "weight-push" and t.is_alive()]
    finally:
        rx.stop()
        iface.close()
