"""The port's copy of the lease module (``dragonboat_tpu_torch.lease``)
against the JAX package's ``dragonboat_tpu.lease``, on the CPU.

Every case runs the same calls on both modules' ``LeaderLease`` or
``LeaseTable`` and compares what each returns and holds, in the same run:
twins of ``tests/test_lease.py``'s unit cases (``:392``, ``:428``,
``:461``, ``:489``, ``:512``, ``:527``), seeded random call sequences,
and the coordinator's advisory lease table fed by its drain.
"""
from __future__ import annotations


import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dragonboat_tpu import lease as jlease  # noqa: E402
from dragonboat_tpu.raft import InMemLogDB  # noqa: E402
from dragonboat_tpu_torch import lease as please  # noqa: E402
from tests.raft_harness import new_test_raft  # noqa: E402

torch.set_num_threads(1)

MODULES = {"port": please, "jax": jlease}


def _lease_state(lease):
    return (dict(lease.bases), {k: [list(e) for e in v] for k, v in lease._pending.items()},
            dict(lease._unrecorded), lease.ceded, lease.duration, lease.epsilon)


def _both(fn):
    """``fn(module)`` on both modules; their results must be equal."""
    out = {name: fn(mod) for name, mod in MODULES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def test_lease_constants_match():
    assert please.LeaderLease.PENDING_CAP == jlease.LeaderLease.PENDING_CAP
    assert please.VALIDITY_BUCKETS_TICKS == jlease.VALIDITY_BUCKETS_TICKS
    assert please.LeaderLease.__slots__ == jlease.LeaderLease.__slots__
    assert please.LeaseTable.__slots__ == jlease.LeaseTable.__slots__


def test_lease_quorum_reduction_matches_kth_largest():
    """Twin of ``tests/test_lease.py:512``."""
    def run(m):
        lease = m.LeaderLease(10)
        lease.record_send(2, [3])
        lease.record_send(4, [2])
        lease.record_ack(3, 5)
        lease.record_ack(2, 6)
        voters = [1, 2, 3, 4, 5]
        out = (lease.remaining(6, 3, voters, 1), lease.remaining(10, 3, voters, 1),
               lease.remaining(6, 2, voters, 1))
        assert out == (2 + 8 - 6, 0, 4 + 8 - 6)
        return out

    _both(run)


def test_lease_table_round_tally():
    """Twin of ``tests/test_lease.py:527``."""
    def run(m):
        lt = m.LeaseTable()
        seen = []
        lt.configure(7, quorum=2, duration=8, self_id=1, voters=[1, 2, 3])
        seen.append((lt.tracks(7), lt.tracks(8), lt.valid(7, 0)))
        lt.note_round({7: {2}}, 10)
        seen.append((lt.valid(7, 11), lt.valid(7, 18), lt.held_count(11)))
        lt.drop(7)
        seen.append(lt.valid(7, 11))
        lt.configure(9, quorum=3, duration=8, self_id=1, voters=[1, 2, 3, 4, 5])
        lt.note_round({9: {2}}, 10)
        seen.append(lt.valid(9, 11))
        lt.configure(11, quorum=2, duration=8, self_id=1, voters=[1, 2, 3])
        lt.note_round({11: {8, 9}}, 10)
        seen.append(lt.valid(11, 11))
        lt.note_round({11: {8, 2}}, 12)
        seen.append(lt.valid(11, 13))
        assert seen == [(True, False, False), (True, False, 1), False, False,
                        False, True]
        return seen

    _both(run)


def test_lease_ack_attribution_is_conservative():
    """Twin of ``tests/test_lease.py:392``."""
    def run(m):
        lease = m.LeaderLease(10)
        trace = []
        lease.record_send(5, [2, 3])
        lease.record_send(6, [2, 3])
        lease.record_ack(2, 7)
        trace.append(lease.bases[2])
        lease.record_ack(2, 8)
        trace.append(lease.bases[2])
        for t in range(100):
            lease.record_send(t + 10, [2])
        cap = m.LeaderLease.PENDING_CAP
        trace.append((len(lease._pending[2]), list(lease._pending[2][0]),
                      lease._unrecorded[2]))
        for _ in range(cap):
            lease.record_ack(2, 200)
        trace.append(lease.bases[2])
        lease.record_send(300, [2])
        trace.append(len(lease._pending[2]))
        for _ in range(100 - cap + 1):
            lease.record_ack(2, 201)
        trace.append((lease.bases[2], lease._unrecorded[2]))
        lease.record_send(400, [2])
        lease.record_ack(2, 401)
        trace.append(lease.bases[2])
        assert trace == [5, 6, (cap, [10, 1], 100 - cap), 10 + cap - 1, 0,
                         (10 + cap - 1, 0), 400]
        return trace

    _both(run)


def test_lease_wall_guard_expires_starved_tick_clock():
    """Twin of ``tests/test_lease.py:428``."""
    def run(m):
        wall = [100.0]
        lease = m.LeaderLease(10, tick_interval_s=0.05)
        lease.wall_clock = lambda: wall[0]
        voters, quorum, self_id = [1, 2, 3], 2, 1
        seen = []
        lease.record_send(5, [2, 3])
        lease.record_ack(2, 6)
        seen.append(lease.valid(6, quorum, voters, self_id))
        wall[0] += 0.39
        seen.append(lease.valid(6, quorum, voters, self_id))
        wall[0] += 0.02
        seen.append(lease.valid(6, quorum, voters, self_id))
        lease.record_send(6, [2, 3])
        lease.record_ack(2, 7)
        seen.append(lease.valid(7, quorum, voters, self_id))
        bare = m.LeaderLease(10)
        bare.record_send(5, [2, 3])
        bare.record_ack(2, 6)
        seen.append(bare.valid(6, quorum, voters, self_id))
        assert seen == [True, True, False, True, True]
        return seen

    _both(run)


def test_lease_survives_sustained_hint_broadcast_load():
    """Twin of ``tests/test_lease.py:461``."""
    import collections

    def run(m):
        lease = m.LeaderLease(10)
        rtt, last = 5, 0
        in_flight = collections.deque()
        for tick in range(200):
            for _ in range(8):
                lease.record_send(tick, [2])
                in_flight.append(tick)
            while in_flight and in_flight[0] <= tick - rtt:
                in_flight.popleft()
                lease.record_ack(2, tick)
            last = tick
        assert not lease._unrecorded.get(2)
        assert len(lease._pending[2]) <= rtt + 1
        assert lease.bases[2] >= last - rtt - 1
        assert lease.remaining(last, 2, [1, 2], 1) > 0
        return _lease_state(lease), lease.remaining(last, 2, [1, 2], 1)

    _both(run)


def test_membership_reset_keeps_fifo_aligned_with_inflight_acks():
    """Twin of ``tests/test_lease.py:489``."""
    def run(m):
        lease = m.LeaderLease(10)
        seen = []
        lease.record_send(3, [2])
        lease.membership_changed()
        seen.append(dict(lease.bases))
        lease.record_send(7, [2])
        lease.record_ack(2, 8)
        seen.append(lease.bases[2])
        lease.record_ack(2, 9)
        seen.append(lease.bases[2])
        lease.reset()
        seen.append((dict(lease._pending), dict(lease.bases)))
        assert seen == [{}, 3, 7, ({}, {})]
        return seen

    _both(run)


@pytest.mark.parametrize("seed", range(6))
def test_leader_lease_random_sequences(seed):
    """A seeded random sequence of sends, acks, validity checks, clock
    jumps, cedes, membership changes and resets: every return value and
    the lease's state after every call are equal on both modules."""
    rng = np.random.default_rng(seed)
    voters = [1, 2, 3, 4, 5]
    calls = []
    tick = 0
    for _ in range(400):
        u = rng.random()
        tick += int(rng.integers(0, 2))
        if u < 0.35:
            calls.append(("record_send", tick, [int(p) for p in voters[1:]
                                                if rng.random() < 0.7]))
        elif u < 0.7:
            calls.append(("record_ack", int(rng.integers(2, 6)), tick))
        elif u < 0.8:
            calls.append(("remaining", tick, int(rng.integers(2, 4)), voters, 1))
        elif u < 0.9:
            calls.append(("valid", tick, int(rng.integers(2, 4)), voters, 1))
        elif u < 0.93:
            calls.append(("inject_clock_jump", int(rng.integers(-3, 4))))
        elif u < 0.95:
            calls.append(("cede",))
        elif u < 0.98:
            calls.append(("membership_changed",))
        else:
            calls.append(("reset",))

    def run(m):
        lease = m.LeaderLease(int(rng_election), drift_ticks=drift)
        out = []
        for name, *args in calls:
            out.append((getattr(lease, name)(*args), _lease_state(lease)))
        out.append(lease.stats())
        return out

    rng_election = 8 + seed
    drift = None if seed % 2 else 1
    _both(run)


@pytest.mark.parametrize("seed", range(4))
def test_lease_table_random_sequences(seed):
    rng = np.random.default_rng(100 + seed)
    calls = []
    for step in range(300):
        cid = int(rng.integers(1, 9))
        u = rng.random()
        if u < 0.15:
            n = int(rng.integers(1, 6))
            calls.append(("configure", cid, n // 2 + 1, int(rng.integers(2, 12)), 1,
                          list(range(1, n + 1))))
        elif u < 0.6:
            calls.append(("note_round", {c: {int(x) for x in rng.integers(1, 8, 3)}
                                         for c in rng.integers(1, 9, 3).tolist()}, step))
        elif u < 0.75:
            calls.append(("valid", cid, step + int(rng.integers(0, 10))))
        elif u < 0.85:
            calls.append(("held_count", step))
        elif u < 0.92:
            calls.append(("drop", cid))
        elif u < 0.96:
            calls.append(("remove", cid))
        else:
            calls.append(("tracks", cid))

    def run(m):
        lt = m.LeaseTable()
        return [getattr(lt, name)(*args) for name, *args in calls] + [
            dict(lt._deadline), dict(lt._quorum)]

    _both(run)


def test_coordinator_lease_table_from_the_drain():
    """A coordinator whose groups hold a scalar lease keeps the advisory
    table: configured at registration, fed by the drain's heartbeat-ack
    tally, dropped on a transition; both packages agree."""
    from tests.test_torch_coordinator import FakeNode, _coord

    def run(side):
        coord = _coord(side, capacity=16, n_peers=8, drive_ticks=True,
                       interval_s=60.0)
        coord.stop()
        nodes = {}
        for cid in range(1, 7):
            r = new_test_raft(1, [1, 2, 3, 4, 5], 10, 1, InMemLogDB())
            r.cluster_id = cid
            if cid % 3:
                r.lease = jlease.LeaderLease(r.election_timeout)
            r.become_candidate()
            r.become_leader()
            r.offload = coord
            n = FakeNode(cid, r)
            nodes[cid] = n
            coord.register(n)
        seen = [sorted(c for c in nodes if coord.lease_table.tracks(c))]
        for rnd in range(4):
            for cid in nodes:
                for nid in (2, 3, 4)[: 1 + (cid + rnd) % 3]:
                    coord.heartbeat_resp(cid, nid)
            if rnd == 2:
                r = nodes[2].peer.raft
                with nodes[2].raft_mu:
                    r.become_follower(r.term + 1, 3)
            coord.request_tick()
            coord.flush()
            lt = coord.lease_table
            seen.append(([lt.valid(c, coord._tick_seen) for c in sorted(nodes)],
                         coord.health_snapshot()["lease_groups_held"]))
        coord.unregister(4)
        seen.append(coord.lease_table.tracks(4))
        return seen

    port, jx = run("port"), run("jax")
    assert port == jx
    assert any(any(v) for v, _ in port[1:-1])
