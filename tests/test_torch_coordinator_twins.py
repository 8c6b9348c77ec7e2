"""Twins of the reference's coordinator-level cases on the port's
``QuorumCoordinator`` (``device="cpu"``) and the JAX package's
``TpuQuorumCoordinator``, each result compared with the other's in the
same run: the read-only round (``test_read_confirm.py:398``), the
rung-3 ack flood with churn (``test_device_ticks.py:237``, at G = 256)
and the four etcd scenarios of ``test_raft_etcd_tpu.py`` with the port's
engine in the offload seat."""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dragonboat_tpu.raft import InMemLogDB  # noqa: E402
from dragonboat_tpu.wire import Entry  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from tests.raft_harness import new_test_raft  # noqa: E402
from tests.test_torch_coordinator import FakeNode, _coord  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_read_only_round_dispatches_without_ticks(side):
    """Twin of ``test_read_confirm.py:398``: a staged ReadIndex ctx plus
    its echoes dispatch on their own with ticks off and nothing else
    queued."""
    coord = _coord(side, capacity=8, n_peers=4, drive_ticks=False)
    try:
        cid = 7
        r = new_test_raft(1, [1, 2, 3], 10, 1, InMemLogDB())
        r.cluster_id = cid
        r.become_candidate()
        r.become_leader()
        confirms = []

        class _Node:
            cluster_id = cid

            class peer:
                raft = r

            def offload_read_confirm(self, low, high, term):
                confirms.append((low, high, term))

        n = _Node()
        coord._nodes[cid] = n
        with coord._mu:
            coord._sync_row_locked(n)
        coord.flush()
        coord.read_stage(cid, r.log.committed, low=1, high=1, term=r.term)
        coord.read_ack_hint(cid, 2, low=1, high=1)
        coord.flush()
        assert confirms == [(1, 1, r.term)]
        assert coord.read_confirms == 1
    finally:
        coord.stop()


def _rung3(side, n_groups=256):
    """Twin of ``test_device_ticks.py:237`` at G = 256: commit parity with
    the scalar raft under ack floods larger than the event cap, then
    register/unregister churn into recycled rows."""
    coord = _coord(side, capacity=n_groups, n_peers=4, drive_ticks=False)
    coord.stop()
    out = {}
    try:
        nodes = {}

        def reg(cid):
            r = new_test_raft(1, [1, 2, 3], 10, 1, InMemLogDB())
            r.cluster_id = cid
            r.become_candidate()
            r.become_leader()
            n = FakeNode(cid, r)
            r.offload = coord
            coord._nodes[cid] = n
            with coord._mu:
                coord._sync_row_locked(n)
            return n

        for g in range(n_groups):
            nodes[1 + g] = reg(1 + g)
        for _ in range(8):
            for cid, n in nodes.items():
                r = n.peer.raft
                r.append_entries([Entry(cmd=b"x")])
                idx = r.log.last_index()
                coord.ack(cid, 2, idx)
                coord.ack(cid, 3, idx)
        assert len(coord._staged) > coord.eng.event_cap
        coord.flush()
        bad = [c for c, n in nodes.items()
               if n.peer.raft.log.committed != n.peer.raft.log.last_index()]
        assert not bad
        retired = list(nodes)[: n_groups // 4]
        for cid in retired:
            coord.unregister(cid)
            del nodes[cid]
        fresh = {100_000 + g: reg(100_000 + g) for g in range(n_groups // 4)}
        for cid, n in fresh.items():
            r = n.peer.raft
            r.append_entries([Entry(cmd=b"y")])
            coord.ack(cid, 2, r.log.last_index())
        coord.flush()
        bad = [c for c, n in fresh.items()
               if n.peer.raft.log.committed != n.peer.raft.log.last_index()]
        assert not bad
        nodes.update(fresh)
        out["effects"] = {c: n.effects for c, n in nodes.items()}
        out["committed"] = {c: n.peer.raft.log.committed for c, n in nodes.items()}
        dev = coord.eng.dev
        out["state"] = {k: np.asarray(getattr(dev, k)) for k in ts.FIELDS}
    finally:
        coord.stop()
    return out


def test_coordinator_rung3_scale_with_churn_and_event_overflow():
    port, jx = _rung3("port"), _rung3("jax")
    assert port["effects"] == jx["effects"]
    assert port["committed"] == jx["committed"]
    for k in ts.FIELDS:
        assert np.array_equal(port["state"][k], jx["state"][k]), k


# ----------------------------------------------------------------------
# the etcd scenarios with the port's engine in the offload seat
# ----------------------------------------------------------------------


def _etcd_module():
    from tests import test_raft_etcd_tpu as m

    return m


class _PortSyncOffload:
    """``tests/test_raft_etcd_tpu.py``'s ``SyncDeviceOffload`` with the
    port's engine (``device="cpu"``) in its seat."""

    def __new__(cls, raft, n_peers=8):
        from dragonboat_tpu_torch.ops.engine import BatchedQuorumEngine

        m = _etcd_module()
        off = m.SyncDeviceOffload.__new__(m.SyncDeviceOffload)
        off.r = raft
        off.eng = BatchedQuorumEngine(1, n_peers, event_cap=256, device="cpu")
        off._register()
        raft.offload = off
        return off


def _port_network(m):
    class PortDeviceNetwork(m.DeviceNetwork):
        def attach(self):
            from dragonboat_tpu.raft import Raft

            self.offloads = {nid: _PortSyncOffload(p)
                             for nid, p in self.peers.items() if isinstance(p, Raft)}
            return self

    return PortDeviceNetwork


@pytest.mark.parametrize("scenario", [
    "log_replication", "cannot_commit_without_new_term_entry",
    "dueling_candidates", "leader_cycle_and_commit",
])
def test_etcd_scenarios_with_the_port_engine(scenario):
    """The four etcd scenarios of ``tests/test_raft_etcd_tpu.py`` with the
    port's engine behind each raft: the cluster fingerprint equals the
    pure-scalar run and the run with the reference's engine."""
    from dragonboat_tpu.raft.raft import RaftState
    from dragonboat_tpu.wire import Message, MessageType as MT
    from tests.raft_harness import Network, campaign, propose

    m = _etcd_module()
    PortNet = _port_network(m)

    def build(n):
        if scenario == "dueling_candidates":
            return [new_test_raft(i, [1, 2, 3], 10, 1, InMemLogDB()) for i in (1, 2, 3)]
        return [None] * n

    def run(nt):
        if scenario == "log_replication":
            nt.send(campaign(nt.raft(1)))
            nt.send(propose(1))
            nt.send(Message(from_=2, to=2, type=MT.ELECTION))
            nt.send(propose(2))
        elif scenario == "cannot_commit_without_new_term_entry":
            nt.send(campaign(nt.raft(1)))
            for k in (3, 4, 5):
                nt.cut(1, k)
            nt.send(propose(1, b"some data"))
            nt.send(propose(1, b"some data"))
            assert nt.raft(1).log.committed == 1
            nt.recover()
            nt.ignore(MT.REPLICATE)
            nt.send(campaign(nt.raft(2)))
            assert nt.raft(2).log.committed == 1
            nt.recover()
            nt.send(Message(from_=2, to=2, type=MT.LEADER_HEARTBEAT))
            nt.send(propose(2, b"some data"))
            assert nt.raft(2).log.committed == 5
        elif scenario == "dueling_candidates":
            nt.cut(1, 3)
            nt.send(campaign(nt.raft(1)))
            nt.send(campaign(nt.raft(3)))
            assert nt.raft(1).state == RaftState.LEADER
            assert nt.raft(3).state == RaftState.CANDIDATE
            nt.recover()
            nt.send(campaign(nt.raft(3)))
        else:
            for c in (1, 2, 3):
                nt.send(Message(from_=c, to=c, type=MT.ELECTION))
            nt.send(propose(3, b"x"))
            nt.send(propose(3, b"y"))

    n = 5 if scenario == "cannot_commit_without_new_term_entry" else 3
    prints = []
    for net in (Network, m.DeviceNetwork, PortNet):
        nt = net(*build(n))
        if net is not Network:
            nt.attach()
            if net is PortNet:
                assert all(o.eng.device == torch.device("cpu")
                           for o in nt.offloads.values())
        run(nt)
        prints.append(m.cluster_fingerprint(nt))
    assert prints[0] == prints[1] == prints[2]
    if scenario == "log_replication":
        assert all(v["committed"] == 4 for v in prints[2].values())


def test_live_round_thread_with_concurrent_stagers():
    """The port's coordinator with its round thread and a warm-up live:
    eight staging threads (more than this box's cores) write to disjoint
    groups under each node's raftMu while a ticker requests ticks, with a
    short switch interval; every group ends committed to its last index."""
    import sys
    import threading
    import time

    coord = _coord("port", capacity=64, n_peers=4, drive_ticks=True,
                   interval_s=0.001)
    nodes = {}
    for cid in range(1, 49):
        r = new_test_raft(1, [1, 2, 3], 10, 1, InMemLogDB())
        r.cluster_id = cid
        r.become_candidate()
        r.become_leader()
        r.offload = coord
        n = FakeNode(cid, r)
        nodes[cid] = n
        with n.raft_mu:
            coord.register(n)
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        warm = coord.start_warmup()

        def stager(cids):
            for _ in range(20):
                for cid in cids:
                    n = nodes[cid]
                    with n.raft_mu:
                        n.peer.raft.append_entries([Entry(cmd=b"s")])
                        idx = n.peer.raft.log.last_index()
                    coord.ack(cid, 2, idx)

        def ticker():
            while not stop.wait(0.002):
                coord.request_tick()

        threads = [threading.Thread(target=stager, args=(list(range(1 + k, 49, 8)),))
                   for k in range(8)]
        tick = threading.Thread(target=ticker)
        tick.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if all(n.peer.raft.log.committed == n.peer.raft.log.last_index()
                   for n in nodes.values()):
                break
            time.sleep(0.01)
        stop.set()
        tick.join(timeout=10)
        assert not tick.is_alive()
        for n in nodes.values():
            r = n.peer.raft
            assert r.log.committed == r.log.last_index() == 21  # noop + 20
    finally:
        sys.setswitchinterval(old)
        stop.set()
        coord.stop()
        warm.join(timeout=60)
        assert not warm.is_alive()
