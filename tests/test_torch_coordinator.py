"""The port's quorum coordinator against the JAX package's, on the CPU.

``dragonboat_tpu_torch.coordinator.QuorumCoordinator`` (at
``device="cpu"``, the engine's plain versions) and the reference's
``TpuQuorumCoordinator`` are driven by one seeded script.  Each side
drives its own scalar Rafts (``dragonboat_tpu.raft``,
``tests/raft_harness.py``) through duck-typed fake nodes that apply and
record every offload effect.  After every ``flush()`` the two sides must
agree with tolerance 0: every effect on every node, every engine state
tensor, the read-plane tallies and the fused dispatch count.  Both round
threads are parked with ``stop()`` right after construction (and after a
foreground warm-up), so ``flush()`` alone decides how ops group into
rounds.  The named twins re-run the reference's coordinator-level cases on
both packages and compare their results in the same run.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from dragonboat_tpu.raft import InMemLogDB  # noqa: E402
from dragonboat_tpu.raft.hier import HierPlane  # noqa: E402
from dragonboat_tpu.wire import Entry  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from tests.raft_harness import new_test_raft  # noqa: E402

torch.set_num_threads(1)

VOTERS = [1, 2, 3, 4, 5]
DOMAINS = {1: "a", 2: "a", 3: "a", 4: "b", 5: "b"}


def _coord(side, **kw):
    if side == "port":
        from dragonboat_tpu_torch.coordinator import QuorumCoordinator

        return QuorumCoordinator(device="cpu", **kw)
    from dragonboat_tpu.tpuquorum import TpuQuorumCoordinator

    return TpuQuorumCoordinator(**kw)


def _machine(side):
    if side == "port":
        from dragonboat_tpu_torch.devsm import DeviceKVStateMachine, encode_op
    else:
        from dragonboat_tpu.devsm import DeviceKVStateMachine, encode_op
    return DeviceKVStateMachine, encode_op


class _Applied:
    """The node's state machine as the devsm plane sees it: applied up to
    the raft's committed index."""

    def __init__(self, raft):
        self.raft = raft

    def get_last_applied(self):
        return self.raft.log.committed


class FakeNode:
    """Applies the coordinator's effects to its scalar raft under raftMu
    with the scalar guards, and records each one."""

    def __init__(self, cid, raft):
        self.cluster_id = cid
        self.raft_mu = threading.RLock()

        class _P:
            pass

        self.peer = _P()
        self.peer.raft = raft
        self.sm = _Applied(raft)
        self.effects = []

    def offload_commit(self, q, wake=True):
        self.effects.append(("commit", int(q)))
        r = self.peer.raft
        with self.raft_mu:
            if r.is_leader():
                r.log.try_commit(q, r.term)

    def offload_election(self, won, term, wake=True):
        self.effects.append(("won" if won else "lost", int(term)))
        r = self.peer.raft
        with self.raft_mu:
            if r.is_candidate() and r.term == term:
                if won:
                    r.become_leader()
                else:
                    r.become_follower(r.term, 0)

    def offload_read_confirm(self, low, high, term, wake=True):
        self.effects.append(("read", int(low), int(high), int(term)))

    def offload_read_echo(self, from_, low, high):
        self.effects.append(("echo", int(from_), int(low), int(high)))

    def offload_tick_elect(self, wake=True):
        self.effects.append(("elect",))

    def offload_tick_heartbeat(self, wake=True):
        self.effects.append(("heartbeat",))

    def offload_tick_demote(self, wake=True):
        self.effects.append(("demote",))


class Side:
    """One package's coordinator with its fake nodes and scalar rafts."""

    def __init__(self, name, capacity, warm=False, **kw):
        self.name = name
        self.coord = _coord(name, capacity=capacity, n_peers=8,
                            interval_s=60.0, **kw)
        if warm:
            stats = self.coord.eng.warmup_fused(background=False)
            assert stats["error"] is None and self.coord.eng.fused_ready
        self.coord.stop()  # park the round thread: flush() drives rounds
        self.nodes = {}
        self.machine, self.encode_op = _machine(name)

    def close(self):
        """Join the warm-up threads a devsm registration may have started
        (cancelled by ``stop()``), so none outlives the test."""
        eng = self.coord.eng
        for t in (eng._warmup_thread, eng._kv_warmup_thread):
            if t is not None:
                t.join(timeout=60)

    def raft(self, cid):
        return self.nodes[cid].peer.raft

    def add(self, cid, leader, hier=False, check_quorum=False, devsm=False):
        r = new_test_raft(1, VOTERS, 10, 1, InMemLogDB(),
                          check_quorum=check_quorum, seed=cid)
        r.cluster_id = cid
        if hier:
            r.hier = HierPlane(DOMAINS, 1)
        if leader:
            r.become_candidate()
            r.become_leader()
        r.offload = self.coord
        n = FakeNode(cid, r)
        self.nodes[cid] = n
        with n.raft_mu:
            self.coord.register(n)
        if devsm:
            plane = self.coord.devsm_plane()
            plane.register(cid, self.machine(cid, 1))
            with self.coord._mu:
                plane.on_leader(cid, r.log.last_index())
        return n

    def remove(self, cid):
        self.coord.unregister(cid)
        return self.nodes.pop(cid)

    def effects(self):
        return {cid: list(n.effects) for cid, n in self.nodes.items()}

    def state(self):
        dev = self.coord.eng.dev
        return {name: np.asarray(getattr(dev, name)) for name in ts.FIELDS}

    def tallies(self):
        c = self.coord
        return (c.read_confirms, c.read_fallbacks, c.fused_dispatches)

    def rafts(self):
        return {cid: (n.peer.raft.state, n.peer.raft.term,
                      n.peer.raft.log.committed, n.peer.raft.log.last_index())
                for cid, n in self.nodes.items()}


def _same(a: Side, b: Side, tag):
    assert a.effects() == b.effects(), tag
    sa, sb = a.state(), b.state()
    for name in ts.FIELDS:
        x, y = sa[name], sb[name]
        assert x.shape == y.shape and np.array_equal(x, y), (tag, name)
    assert a.tallies() == b.tallies(), (tag, a.tallies(), b.tallies())
    assert a.rafts() == b.rafts(), tag
    if a.coord.telem_enabled:
        ta, tb = a.coord.telem_snapshot(), b.coord.telem_snapshot()
        assert (ta is None) == (tb is None), tag
        if ta is not None:
            for key in ta:
                if key not in ("seq", "mono"):
                    assert ta[key] == tb[key], (tag, key)


def _both(sides, fn):
    for s in sides:
        fn(s)


# ----------------------------------------------------------------------
# the differential script
# ----------------------------------------------------------------------

G0 = 20
ROUNDS = 8


def _script(sides, seed, drive_ticks, drive_reads, hier):
    """One seeded sequence, decided on the port's state (the sides are
    held equal after every flush, so it is the same on both)."""
    port = sides[0]
    rng = np.random.default_rng(seed)
    for cid in range(1, G0 + 1):
        kind = cid % 3
        _both(sides, lambda s: s.add(
            cid, leader=kind != 2, hier=hier and cid % 3 == 0,
            check_quorum=cid % 5 == 0, devsm=cid in (3, 4)))
    _both(sides, lambda s: s.coord.flush())
    _same(*sides, ("registered",))
    next_cid = 1000
    ctx = [0]

    def new_ctx():
        ctx[0] += 1
        return 10_000 + ctx[0]

    for rnd in range(ROUNDS):
        cids = sorted(port.nodes)
        for cid in cids:
            r = port.raft(cid)
            u = rng.random()
            if r.is_leader():
                if u < 0.7:
                    k = int(rng.integers(1, 3))
                    acks = [(nid, int(rng.integers(0, 2)))
                            for nid in VOTERS[1:] if rng.random() < 0.6]
                    # devsm ops ride the campaign rounds and commit in
                    # them, so the other rounds may fuse
                    devsm_op = cid in (3, 4) and rnd % 2 == 0
                    if devsm_op:
                        acks += [(2, 0), (3, 0)]
                    vals = rng.integers(0, 1000, k).tolist()
                    keys = rng.integers(0, 4, k).tolist()

                    def write(s, cid=cid, k=k, acks=acks, devsm_op=devsm_op,
                              vals=vals, keys=keys):
                        rr = s.raft(cid)
                        with s.nodes[cid].raft_mu:
                            ents = [Entry(cmd=s.encode_op(keys[i], vals[i]))
                                    for i in range(k)]
                            rr.append_entries(ents)
                            last = rr.log.last_index()
                        if devsm_op:
                            s.coord.stage_sm_ops(
                                cid, [(e.index, e.cmd) for e in ents])
                        for nid, lag in acks:
                            s.coord.ack(cid, nid, last - lag)
                    _both(sides, write)
                if u > 0.5:
                    nids = [n for n in VOTERS[1:] if rng.random() < 0.5]
                    _both(sides, lambda s, cid=cid, nids=nids: [
                        s.coord.heartbeat_resp(cid, n) for n in nids])
                if drive_reads and rng.random() < 0.4:
                    lo = new_ctx()
                    echo = [n for n in (2, 3, 4) if rng.random() < 0.6]

                    def read(s, cid=cid, lo=lo, echo=echo):
                        rr = s.raft(cid)
                        s.coord.read_stage(cid, rr.log.committed, lo, cid, rr.term)
                        for n in echo:
                            s.coord.read_ack_hint(cid, n, lo, cid)
                    _both(sides, read)
                if drive_reads and rng.random() < 0.1:
                    # an echo of a ctx with no slot falls back to the scalar
                    # tally (offload_read_echo)
                    _both(sides, lambda s, cid=cid: s.coord.read_ack_hint(
                        cid, 2, 99_999, cid))
                if rng.random() < 0.06:
                    def demote(s, cid=cid):
                        rr = s.raft(cid)
                        with s.nodes[cid].raft_mu:
                            rr.become_follower(rr.term + 1, 2)
                    _both(sides, demote)
            elif r.is_candidate():
                pass  # the round's election outcome moves it on
            else:
                if u < 0.4 and rnd % 2 == 0:
                    win = (cid + rnd // 2) % 2 == 0

                    def campaign(s, cid=cid, win=win):
                        rr = s.raft(cid)
                        with s.nodes[cid].raft_mu:
                            rr.become_candidate()
                        s.coord.vote(cid, 1, True)
                        if win:
                            s.coord.vote(cid, 2, True)
                            s.coord.vote(cid, 3, True)
                        else:
                            for n in (2, 3, 4):
                                s.coord.vote(cid, n, False)
                    _both(sides, campaign)
                elif u < 0.5:
                    _both(sides, lambda s, cid=cid: s.coord.leader_contact(cid))
                elif u < 0.6:
                    t = int(rng.integers(10, 20))
                    _both(sides, lambda s, cid=cid, t=t:
                          s.coord.set_randomized_timeout(cid, t))
        if rnd % 4 == 2:
            cid = int(rng.choice(cids))
            _both(sides, lambda s, cid=cid: s.coord.membership_changed(cid))
        if rnd % 3 == 2:
            gone = [int(c) for c in rng.choice(
                [c for c in cids if c not in (3, 4)], 2, replace=False)]
            fresh = [next_cid, next_cid + 1]
            next_cid += 2

            def churn(s, gone=gone, fresh=fresh):
                for c in gone:
                    s.remove(c)
                for c in fresh:
                    s.add(c, leader=c % 2 == 0, hier=hier)
            _both(sides, churn)
        ticks = int(rng.integers(1, 7)) if drive_ticks else 0

        def tick(s, ticks=ticks):
            for _ in range(ticks):
                s.coord.request_tick()
            s.coord.flush()
        _both(sides, tick)
        _same(*sides, ("round", rnd))
    # drain what the last round's effects staged
    _both(sides, lambda s: s.coord.flush())
    _same(*sides, ("drain",))


def differential(drive_ticks, drive_reads, telem, hier):
    """The differential script on both packages for one combination of
    the coordinator's options; the hier rule goes on a third of the rows.
    ``tests/test_torch_coordinator_hier.py`` runs the hier half."""
    seed = 8 * drive_ticks + 4 * drive_reads + 2 * telem + hier
    kw = dict(drive_ticks=drive_ticks, drive_reads=drive_reads, telem=telem)
    sides = [Side(name, 64, warm=drive_ticks, **kw) for name in ("port", "jax")]
    try:
        _script(sides, seed, drive_ticks, drive_reads, hier)
    finally:
        for s in sides:
            s.close()
    port, jx = sides
    if drive_ticks:
        assert port.coord.fused_dispatches > 0
    if drive_reads:
        assert port.coord.read_confirms > 0 and port.coord.read_fallbacks > 0
    wins = sum(e[0] == "won" for n in port.nodes.values() for e in n.effects)
    losses = sum(e[0] == "lost" for n in port.nodes.values() for e in n.effects)
    assert wins and losses
    assert any(e[0] == "commit" for n in port.nodes.values() for e in n.effects)


@pytest.mark.parametrize("telem", [False, True], ids=["notelem", "telem"])
@pytest.mark.parametrize("drive_reads", [False, True], ids=["noreads", "reads"])
@pytest.mark.parametrize("drive_ticks", [False, True], ids=["noticks", "ticks"])
def test_coordinator_differential(drive_ticks, drive_reads, telem):
    differential(drive_ticks, drive_reads, telem, hier=False)


def test_fresh_coordinator_surface():
    """Construction: the port's options and what it refuses."""
    from dragonboat_tpu_torch.coordinator import QuorumCoordinator

    c = QuorumCoordinator(capacity=8, n_peers=4, device="cpu", interval_s=60.0)
    try:
        assert c.eng.device == torch.device("cpu")
        assert c.eng.event_cap == 4096 and c.fused_k_max == 16
        assert not c.eng.fused_ready and not c.eng.kv_fused_ready
        assert c.devsm is None
        assert c.hostplane is None and c.tracer is None
        assert c.replattr is None and c.devprof is None
        assert c.health_snapshot() == {
            "groups": 0, "staged": 0, "tick_deficit": 0, "fused_ready": False,
            "fused_dispatches": 0, "read_confirms": 0, "read_fallbacks": 0,
        }
        with pytest.raises(NotImplementedError, match="item 7"):
            c.enable_obs()
        with pytest.raises(NotImplementedError, match="item 7"):
            c.enable_devprof(object())
        t = c.start_warmup()
        t.join(timeout=60)
        assert c.eng.fused_ready and c.warmup_stats["error"] is None
        assert c.start_warmup() is t  # a repeat call is a no-op
        assert c.health_snapshot()["fused_ready"] is True
    finally:
        c.stop()
    with pytest.raises(NotImplementedError, match="item 6"):
        QuorumCoordinator(capacity=8, mesh_devices=2, device="cpu")
    with pytest.raises(ValueError, match="_build"):
        QuorumCoordinator(capacity=8, compilation_cache_dir="/nowhere",
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QuorumCoordinator(capacity=8)
