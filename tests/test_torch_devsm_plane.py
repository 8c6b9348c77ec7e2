"""The device state machine's host half in the port
(``dragonboat_tpu_torch.devsm``: codec, ``DeviceKVStateMachine``,
``DevKVPlane``) against the JAX package's ``dragonboat_tpu.devsm``, on
the CPU.

Each case runs the same calls on the port's plane (on a ``device="cpu"``
``QuorumCoordinator``) and the reference's (on a ``TpuQuorumCoordinator``)
and compares the binding state, the plane's tallies, the engine's KV rows
and what lookups return, in the same run; the codec and the machine are
compared byte for byte.  ``test_plane_overflow_unbinds_and_rearms`` is the
twin of ``tests/test_devsm.py:409``.
"""
from __future__ import annotations

import io
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dragonboat_tpu import devsm as jdevsm  # noqa: E402
from dragonboat_tpu_torch import devsm as pdevsm  # noqa: E402
from tests.test_torch_coordinator import _coord  # noqa: E402

torch.set_num_threads(1)

PACKAGES = {"port": pdevsm, "jax": jdevsm}


def _both(fn):
    out = {name: fn(name, mod) for name, mod in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def test_codec_matches_reference():
    rng = np.random.default_rng(0)
    assert pdevsm.OP_WIDTH == jdevsm.OP_WIDTH
    for key, val in rng.integers(-(2 ** 31), 2 ** 31, (64, 2)).tolist():
        b = pdevsm.encode_op(key, val)
        assert b == jdevsm.encode_op(key, val)
        assert pdevsm.decode_op(b) == jdevsm.decode_op(b) == (key, val)
    for bad in (b"", b"1234567", b"123456789", b"x" * 16):
        assert pdevsm.decode_op(bad) is None and jdevsm.decode_op(bad) is None


def test_machine_matches_reference():
    """Updates (valid, out of range, malformed), lookups and a snapshot
    round trip: the same results, and snapshot bytes either package can
    restore."""
    rng = np.random.default_rng(1)
    cmds = [pdevsm.encode_op(int(k), int(v))
            for k, v in zip(rng.integers(-2, 20, 80), rng.integers(-50, 50, 80))]
    cmds += [b"", b"bogus", b"\x00" * 9]

    def run(name, mod):
        sm = mod.DeviceKVStateMachine(5, 1)
        results = [(r.value, r.data) for r in (sm.update(c) for c in cmds)]
        buf = io.BytesIO()
        sm.save_snapshot(buf, None, None)
        other = PACKAGES["jax" if name == "port" else "port"].DeviceKVStateMachine(5, 1)
        other.recover_from_snapshot(io.BytesIO(buf.getvalue()), [], None)
        vals = [sm.lookup(k) for k in range(sm.kv_slots)]
        assert [other.lookup(k) for k in range(other.kv_slots)] == vals
        with pytest.raises(KeyError):
            sm.lookup(sm.kv_slots)
        for bad in (b"DKV0", b"DKV1" + np.int64(10 ** 9).tobytes(),
                    b"DKV1" + np.int64(4).tobytes() + b"\x00" * 8):
            with pytest.raises(ValueError):
                mod.DeviceKVStateMachine(5, 1).recover_from_snapshot(
                    io.BytesIO(bad), [], None)
        return results, vals, buf.getvalue(), sm.kv_slots, sm.device_kv

    _both(run)


class _SM:
    def __init__(self, applied=1):
        self.applied = applied

    def get_last_applied(self):
        return self.applied


class _Node:
    def __init__(self, applied=1):
        self.sm = _SM(applied)
        self.commits = []

    def offload_commit(self, q):
        self.commits.append(q)


def _plane(side, cid=5, n=8):
    coord = _coord(side, capacity=n, n_peers=4, drive_ticks=False)
    coord.stop()
    coord.eng.add_group(cid, node_ids=[1, 2, 3], self_id=1)
    coord.eng.set_leader(cid, term=1, term_start=1, last_index=1)
    coord._nodes[cid] = _Node()
    plane = coord.devsm_plane()
    mod = PACKAGES[side]
    sm = mod.DeviceKVStateMachine(cid, 1)
    plane.register(cid, sm)
    return coord, plane, sm, mod


@pytest.mark.parametrize("side", ["port", "jax"])
def test_plane_overflow_unbinds_and_rearms(side):
    """Twin of ``tests/test_devsm.py:409``: entry-buffer overflow on a
    bound group unbinds the plane (the host shadow serves) and re-arms the
    bind past the batch; an overflowing bind flush re-arms instead of
    binding."""
    coord, plane, sm, mod = _plane(side)
    cid = 5
    try:
        plane.on_leader(cid, 1)
        assert plane.bound(cid)
        e = coord.eng.n_kv_ents
        idxs = list(range(2, 2 + e + 1))
        with coord._mu:
            plane.handle_ops(cid, [(i, mod.encode_op(0, i)) for i in idxs])
        assert not plane.bound(cid)
        assert plane._pending_bind[cid] == idxs[-1]
        assert plane.lookup(cid, 0, sm) == int(sm.values[0])
        coord._nodes[cid].sm.applied = idxs[-1]
        with coord._mu:
            plane.poll()
        assert plane.bound(cid) and plane.binds == 2
        with coord._mu:
            plane.on_unbind(cid)
            plane.on_leader(cid, idxs[-1])
        flood = list(range(idxs[-1] + 1, idxs[-1] + 1 + 2 * e + 2))
        with coord._mu:
            plane.handle_ops(cid, [(i, mod.encode_op(0, i)) for i in flood])
        with coord._mu:
            plane.poll()
        assert not plane.bound(cid)
        assert plane._pending_bind[cid] == flood[-1]
        coord._nodes[cid].sm.applied = flood[-1]
        with coord._mu:
            plane.poll()
        assert plane.bound(cid)
    finally:
        coord.stop()


def test_plane_overflow_matches_between_packages():
    """The overflow script above on both packages, compared step by step:
    bindings, pending watermarks, tallies and the engine's staged KV
    buffers."""
    def run(side, mod):
        coord, plane, sm, _ = _plane(side)
        cid, seen = 5, []
        eng = coord.eng

        def snap():
            seen.append((plane.bound(cid), dict(plane._pending_bind),
                         plane.binds, plane.ops_staged,
                         eng.kv_values(cid).tolist(),
                         sorted(eng._kv_stage), {r: list(q) for r, q in eng._kv_queue.items()}))
        try:
            plane.on_leader(cid, 1)
            snap()
            e = eng.n_kv_ents
            idxs = list(range(2, 2 + e + 1))
            with coord._mu:
                plane.handle_ops(cid, [(i, mod.encode_op(i % 4, i)) for i in idxs])
            snap()
            coord._nodes[cid].sm.applied = idxs[-1]
            with coord._mu:
                plane.poll()
            snap()
            eng.ack(cid, 1, idxs[-1])
            eng.ack(cid, 2, idxs[-1])
            coord.flush()
            snap()
            with coord._mu:
                plane.handle_ops(cid, [(idxs[-1] + 1, mod.encode_op(3, 77)),
                                       (idxs[-1] + 2, b"not an op"),
                                       (idxs[-1] + 3, mod.encode_op(99, 1))])
            eng.ack(cid, 1, idxs[-1] + 3)
            eng.ack(cid, 2, idxs[-1] + 3)
            coord.flush()
            snap()
            seen.append(plane.devprof_snapshot())
            seen.append(plane.health_snapshot(cid))
        finally:
            coord.stop()
        return seen

    _both(run)


def test_device_lookup_served_by_the_round():
    """A lookup on a bound group stages a device KV read and parks; the
    next round's capture resolves it through the engine's egress hook."""
    def run(side, mod):
        coord, plane, sm, _ = _plane(side)
        cid = 5
        try:
            plane.on_leader(cid, 1)
            with coord._mu:
                plane.handle_ops(cid, [(2, mod.encode_op(1, 41)), (3, mod.encode_op(1, 42))])
            coord.eng.ack(cid, 1, 3)
            coord.eng.ack(cid, 2, 3)
            coord.flush()
            out = {}

            def reader():
                out["v"] = sm.lookup(1)

            t = threading.Thread(target=reader)
            t.start()
            for _ in range(2000):
                if coord.eng._kv_read_stage:
                    break
                t.join(timeout=0.005)
            coord.flush()
            t.join(timeout=10)
            assert not t.is_alive()
            return out["v"], plane.reads_served, plane.read_fallbacks
        finally:
            coord.stop()

    assert _both(run) == (42, 1, 0)


def test_unregister_and_force_release():
    def run(side, mod):
        coord, plane, sm, _ = _plane(side)
        cid = 5
        try:
            plane.on_leader(cid, 1)
            seen = [plane.bound(cid), coord.devsm_force_release(cid),
                    plane.bound(cid), coord.devsm_force_release(99)]
            sm.close()
            seen += [plane.tracks(cid), sm._plane is None,
                     coord.devsm_force_release(cid)]
            return seen
        finally:
            coord.stop()

    assert _both(run) == [True, True, False, False, False, True, False]
