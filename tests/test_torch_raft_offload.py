"""The port's Raft groups through the port's quorum coordinator, against
the JAX package's rafts through the JAX package's coordinator, on the CPU.

Each side is a deployment of 3 hosts.  Each host holds one replica of
every group and its own coordinator (the reference's
``TpuQuorumCoordinator``, or the port's ``QuorumCoordinator`` at
``device="cpu"``), built and ``stop()``-ped at once and then driven by
``flush()``.  Each host applies its coordinator's effects through a stand-in
for the node (``OffloadNode`` below, the Raft-facing part of
``dragonboat_tpu/node.py:308-470``) and runs the node's update cycle on
each ``Peer``; messages cross hosts as bytes of their own package's codec.
The script elects leaders from followers only (by device ticks where the
coordinator drives them), writes 16-byte entries, reads through ReadIndex
(echoed by the followers' heartbeat responses), cuts one host off until
its groups elect again elsewhere, heals it, and changes a membership.
After every ``flush()`` the two deployments must agree with tolerance 0:
every raft's term, vote, state, leader, committed, applied, last index and
log signature, every effect each host's coordinator delivered, every engine
state tensor, and ``read_confirms``, ``read_fallbacks`` and
``fused_dispatches``.

The twins run ``tests/test_raft_etcd_tpu.py``'s four scenarios with the
port wholly on the port's side (its raft, harness and engine) and compare
the clusters they end with to the reference's.  No test here starts a
thread of its own or reads a clock.
"""
from __future__ import annotations

import functools
import os
import threading
import types

import numpy as np
import pytest
import torch

import dragonboat_tpu.config as ref_config
import dragonboat_tpu.raft as ref_raft
import dragonboat_tpu.wire as ref_wire
import dragonboat_tpu_torch.config as port_config
import dragonboat_tpu_torch.raft as port_raft
import dragonboat_tpu_torch.wire as port_wire
from dragonboat_tpu_torch.ops import state as ts

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CMD = 16
HOSTS = 3
G = 32


class Pkg:
    def __init__(self, name, config, raft, wire):
        self.name = name
        self.Config = config.Config
        self.Peer = raft.Peer
        self.PeerAddress = raft.PeerAddress
        self.InMemLogDB = raft.InMemLogDB
        self.wire = wire
        self.codec = wire.codec
        self.MT = wire.MessageType

    def coordinator(self, **kw):
        if self.name == "port":
            from dragonboat_tpu_torch.coordinator import QuorumCoordinator

            return QuorumCoordinator(device="cpu", **kw)
        from dragonboat_tpu.tpuquorum import TpuQuorumCoordinator

        return TpuQuorumCoordinator(**kw)


PKGS = {"ref": Pkg("ref", ref_config, ref_raft, ref_wire),
        "port": Pkg("port", port_config, port_raft, port_wire)}


class OffloadNode:
    """A host's stand-in for one replica's node: the coordinator's effect
    hooks and their application.

    Copies the Raft-facing part of ``dragonboat_tpu/node.py:308-470``: the
    ``offload_*`` methods only flag an effect; ``apply`` takes the flags and
    applies them with ``_apply_offload_effects``'s scalar guards, in its
    order (commit under the term rule, then the term-pinned read
    releases, the echo fallback, the election under ``hier_election_ok``,
    the tick flags).  The scalar clocks are ticked every host tick, so the
    node's catch-up tick is a no-op here."""

    def __init__(self, pkg, peer):
        self.pkg = pkg
        self.peer = peer
        self.cluster_id = peer.raft.cluster_id
        self.node_id = peer.raft.node_id
        self.raft_mu = threading.RLock()
        self.effects = []
        self._off_commit = 0
        self._off_election = None
        self._off_hb = self._off_elect = self._off_demote = False
        self._off_reads = []
        self._off_read_echoes = []

    def offload_commit(self, q, wake=True):
        self.effects.append(("commit", int(q)))
        if q > self._off_commit:
            self._off_commit = q

    def offload_election(self, won, term, wake=True):
        self.effects.append(("election", bool(won), int(term)))
        self._off_election = (won, term)

    def offload_read_confirm(self, low, high, term, wake=True):
        self.effects.append(("read", int(low), int(high), int(term)))
        self._off_reads.append((low, high, term))

    def offload_read_echo(self, from_, low, high, wake=True):
        self.effects.append(("echo", int(from_), int(low), int(high)))
        self._off_read_echoes.append((from_, low, high))

    def offload_tick_elect(self, wake=True):
        self.effects.append(("elect",))
        self._off_elect = True

    def offload_tick_heartbeat(self, wake=True):
        self.effects.append(("heartbeat",))
        self._off_hb = True

    def offload_tick_demote(self, wake=True):
        self.effects.append(("demote",))
        self._off_demote = True

    def apply(self):
        w, MT = self.pkg.wire, self.pkg.MT
        r = self.peer.raft
        with self.raft_mu:
            commit_q, self._off_commit = self._off_commit, 0
            election, self._off_election = self._off_election, None
            hb, self._off_hb = self._off_hb, False
            elect, self._off_elect = self._off_elect, False
            demote, self._off_demote = self._off_demote, False
            reads, self._off_reads = self._off_reads, []
            echoes, self._off_read_echoes = self._off_read_echoes, []
            if commit_q and r.is_leader() and r.log.try_commit(commit_q, r.term):
                r._note_commit()
                if r.hier is not None:
                    voters = r.voting_members()
                    match_of = {nid: rm.match for nid, rm in voters.items()}
                    m_sorted = sorted(match_of.values())
                    q_classic = m_sorted[len(m_sorted) - r.quorum()]
                    r.hier.note_close(via_sub=commit_q > q_classic)
                    r.hier.note_far_lag(match_of, voters.keys(), r.log.committed)
                r.broadcast_replicate_message()
            if reads and r.is_leader():
                for low, high, term in reads:
                    if r.term != term:
                        continue
                    ctx = w.SystemCtx(low=low, high=high)
                    r.apply_read_releases(r.read_index.release(ctx), ctx)
            if echoes and r.is_leader():
                for from_, low, high in echoes:
                    r.handle_read_index_leader_confirmation(
                        w.Message(from_=from_, hint=low, hint_high=high))
            if election is not None:
                won, term = election
                if r.is_candidate() and r.term == term:
                    if won and r.hier_election_ok():
                        r.become_leader()
                        r.broadcast_replicate_message()
                    elif won:
                        if r.hier is not None:
                            r.hier.note_election_hold()
                    else:
                        r.become_follower(r.term, 0)
            if (elect and r.device_ticks and not r.is_leader()
                    and not r.is_observer() and not r.is_witness()
                    and not r.self_removed() and r.time_for_election()):
                r.election_tick = 0
                r.handle(w.Message(from_=self.node_id, type=MT.ELECTION))
            if hb and r.device_ticks and r.is_leader():
                r.heartbeat_tick = 0
                r.handle(w.Message(from_=self.node_id, type=MT.LEADER_HEARTBEAT))
            if demote and r.device_ticks and r.is_leader() and r.check_quorum:
                r.election_tick = 0
                r.handle(w.Message(from_=self.node_id, type=MT.CHECK_QUORUM))


class Host:
    """One host: a replica of every group, its coordinator and log DBs."""

    def __init__(self, pkg, index, flags):
        self.pkg = pkg
        self.nid = index + 1
        self.coord = pkg.coordinator(
            capacity=G, n_peers=8, interval_s=60.0,
            drive_ticks=flags["ticks"], drive_reads=flags["reads"],
            telem=flags["telem"])
        self.coord.stop()  # park the round thread: flush() drives rounds
        self.nodes = {}
        self.logdbs = {}
        self.applied = {}


class Deployment:
    """One package's 3 hosts and the wire between them."""

    def __init__(self, pkg, flags, seed):
        self.pkg = pkg
        self.flags = flags
        self.hosts = [Host(pkg, h, flags) for h in range(HOSTS)]
        self.queue = []  # (from nid, to nid, bytes)
        self.cut = set()
        self.record = []
        addrs = [pkg.PeerAddress(h + 1, f"h{h + 1}") for h in range(HOSTS)]
        for cid in range(1, G + 1):
            for host in self.hosts:
                hier = flags["hier"] and cid % 3 == 0
                cfg = pkg.Config(
                    node_id=host.nid, cluster_id=cid, election_rtt=10,
                    heartbeat_rtt=1, check_quorum=cid % 4 == 0,
                    hier_commit=hier,
                    hier_domains={1: "a", 2: "a", 3: "b", 4: "b"} if hier else {})
                logdb = pkg.InMemLogDB()
                p = pkg.Peer.launch(cfg, logdb, None, addrs, initial=True,
                                    new_node=True, seed=seed * 4096 + cid * 8 + host.nid)
                node = OffloadNode(pkg, p)
                host.nodes[cid], host.logdbs[cid], host.applied[cid] = node, logdb, 0
                p.raft.offload = host.coord
                if host.coord.drive_ticks:
                    p.raft.device_ticks = True
                with node.raft_mu:
                    host.coord.register(node)
                self.process(host, cid)

    def rafts(self):
        for host in self.hosts:
            for cid, node in sorted(host.nodes.items()):
                yield host, cid, node.peer.raft

    # -- the node's update cycle ---------------------------------------

    def process(self, host, cid):
        pkg, w = self.pkg, self.pkg.wire
        node, logdb = host.nodes[cid], host.logdbs[cid]
        p = node.peer
        for _ in range(8):
            if not p.has_update(True):
                return
            ud = p.get_update(True, host.applied[cid])
            if not w.is_empty_snapshot(ud.snapshot):
                raise AssertionError("no snapshot is sent in this script")
            if ud.entries_to_save:
                logdb.append(ud.entries_to_save)
                logdb.max_index = ud.entries_to_save[-1].index
            if not w.is_empty_state(ud.state):
                logdb.set_state(ud.state)
            for m in ud.messages:
                data = pkg.codec.encode_message(m)
                self.record.append(("msg", host.nid, cid, data))
                self.queue.append((host.nid, m.to, data))
            for rtr in ud.ready_to_reads:
                self.record.append(("read", host.nid, cid, rtr.index,
                                    rtr.system_ctx.low, rtr.system_ctx.high))
            for e in ud.dropped_entries:
                self.record.append(("dropped", host.nid, cid, bytes(e.cmd)))
            for c in ud.dropped_read_indexes:
                self.record.append(("read_dropped", host.nid, cid, c.low))
            p.commit(ud)
            applied = host.applied[cid]
            for e in ud.committed_entries:
                if e.index <= applied:
                    continue
                if e.type == w.EntryType.CONFIG_CHANGE:
                    cc = pkg.codec.decode_config_change(e.cmd)
                    with node.raft_mu:
                        p.apply_config_change(cc)
                applied = e.index
            if applied != host.applied[cid]:
                host.applied[cid] = applied
                p.notify_raft_last_applied(applied)

    # -- inputs ----------------------------------------------------------

    def deliver_all(self):
        while self.queue:
            frm, to, data = self.queue.pop(0)
            if (frm, to) in self.cut or not 1 <= to <= HOSTS:
                self.record.append(("lost", frm, to))
                continue
            m = self.pkg.codec.decode_message(data)
            host = self.hosts[to - 1]
            node = host.nodes.get(m.cluster_id)
            if node is None:
                continue
            with node.raft_mu:
                node.peer.handle(m)
            self.process(host, m.cluster_id)

    def tick(self):
        for host in self.hosts:
            for cid in sorted(host.nodes):
                node = host.nodes[cid]
                with node.raft_mu:
                    node.peer.tick()
                self.process(host, cid)
            if host.coord.drive_ticks:
                host.coord.request_tick()

    def flush(self):
        for host in self.hosts:
            host.coord.flush()
            for cid in sorted(host.nodes):
                host.nodes[cid].apply()
                self.process(host, cid)

    def propose(self, h, cid, cmd):
        node = self.hosts[h].nodes[cid]
        with node.raft_mu:
            node.peer.propose_entries([self.pkg.wire.Entry(cmd=cmd)])
        self.process(self.hosts[h], cid)

    def read(self, h, cid, low):
        node = self.hosts[h].nodes[cid]
        with node.raft_mu:
            node.peer.read_index(self.pkg.wire.SystemCtx(low=low, high=cid))
        self.process(self.hosts[h], cid)

    def config_change(self, h, cid, kind, nid):
        w = self.pkg.wire
        node = self.hosts[h].nodes[cid]
        cc = w.ConfigChange(type=getattr(w.ConfigChangeType, kind), node_id=nid,
                            address=f"h{nid}")
        with node.raft_mu:
            node.peer.propose_config_change(cc, nid)
        self.process(self.hosts[h], cid)

    def isolate(self, h):
        nid = h + 1
        self.cut = {(a, b) for a in range(1, HOSTS + 1) for b in range(1, HOSTS + 1)
                    if a != b and nid in (a, b)}

    def heal(self):
        self.cut = set()

    def close(self):
        for host in self.hosts:
            eng = host.coord.eng
            for t in (getattr(eng, "_warmup_thread", None),
                      getattr(eng, "_kv_warmup_thread", None)):
                if t is not None:
                    t.join(timeout=60)

    # -- what is compared ------------------------------------------------

    def leaders(self):
        """cid -> host index of the leader at the highest term."""
        out = {}
        for host, cid, r in self.rafts():
            if r.is_leader() and (cid not in out or r.term > out[cid][1]):
                out[cid] = (host.nid - 1, r.term)
        return {cid: h for cid, (h, _) in out.items()}

    def view(self):
        from tests.test_torch_raft import raft_view

        rafts = tuple((host.nid, cid, raft_view(r), host.applied[cid])
                      for host, cid, r in self.rafts())
        effects = tuple((host.nid, cid, tuple(n.effects))
                        for host in self.hosts for cid, n in sorted(host.nodes.items()))
        tallies = tuple((h.coord.read_confirms, h.coord.read_fallbacks,
                         h.coord.fused_dispatches) for h in self.hosts)
        return rafts, effects, tallies

    def engine_state(self):
        """Each host's engine state as its next dispatch sees it: the
        device tensors, with the rows staged on the host since the last
        dispatch taken from the host mirror (the JAX engine's CPU arrays
        may alias the mirror; the port's never do)."""
        out = []
        for h in self.hosts:
            eng = h.coord.eng
            rows = np.array(sorted(eng._dirty), dtype=np.int64)
            st = {}
            for name in ts.FIELDS:
                x = np.array(getattr(eng.dev, name))
                if len(rows):
                    x[rows] = eng.mirror.arrays[name][rows]
                st[name] = x
            out.append(st)
        return out


class Pair:
    def __init__(self, flags, seed):
        self.sides = [Deployment(PKGS[s], flags, seed) for s in ("ref", "port")]
        self.flushes = 0
        self.seen = 0
        self.both("flush")  # the registered rows reach the engine state
        self.same("launch")

    @property
    def a(self):
        return self.sides[0]

    def both(self, fn, *args):
        for s in self.sides:
            getattr(s, fn)(*args)

    def same(self, tag):
        a, b = self.sides
        va, vb = a.view(), b.view()
        assert va[0] == vb[0], (tag, "rafts")
        assert va[1] == vb[1], (tag, "effects")
        assert va[2] == vb[2], (tag, "tallies", va[2], vb[2])
        assert a.record[self.seen:] == b.record[self.seen:], (tag, "record")
        assert len(a.record) == len(b.record)
        self.seen = len(a.record)
        for h, (x, y) in enumerate(zip(a.engine_state(), b.engine_state())):
            for name in ts.FIELDS:
                assert x[name].shape == y[name].shape and np.array_equal(
                    x[name], y[name]), (tag, h, name)

    def round(self, tag, ticks=1):
        self.both("deliver_all")
        for _ in range(ticks):
            self.both("tick")
        self.both("deliver_all")
        self.both("flush")
        self.flushes += 1
        self.same((tag, self.flushes))
        self.both("deliver_all")
        self.same((tag, self.flushes, "delivered"))


def run_deployment(flags, seed):
    pair = Pair(flags, seed)
    a = pair.a
    try:
        # elections from followers only
        for _ in range(30):
            pair.round("elect", ticks=2)
            if len(a.leaders()) == G:
                break
        assert len(a.leaders()) == G, a.leaders()
        # writes and reads
        ctx = 0
        for rnd in range(3):
            for cid, h in sorted(a.leaders().items()):
                pair.both("propose", h, cid, bytes([rnd, cid]) * (CMD // 2))
                if cid % 4 == rnd % 4:
                    ctx += 1
                    pair.both("read", h, cid, ctx)
            pair.round("write", ticks=1 + (rnd % 3 == 2) * 2)
        # one host cut off until its leaders' groups elect elsewhere
        lost = max(range(HOSTS), key=lambda h: sum(
            1 for x in a.leaders().values() if x == h))
        moved = [cid for cid, h in a.leaders().items() if h == lost]
        pair.both("isolate", lost)
        for _ in range(30):
            pair.round("partition", ticks=3)
            lead = a.leaders()
            if all(lead.get(cid) not in (None, lost) for cid in moved):
                break
        for cid, h in sorted(a.leaders().items()):
            if h != lost:
                pair.both("propose", h, cid, bytes([99, cid]) * (CMD // 2))
        pair.round("partition-write")
        pair.both("heal")
        for _ in range(30):
            pair.round("heal", ticks=3)
            if len(a.leaders()) == G and all(
                    a.hosts[h].nodes[cid].peer.raft.leader_id == h0 + 1
                    for cid, h0 in a.leaders().items() for h in range(HOSTS)):
                break
        # a membership change: an observer joins group 1's membership
        lead = a.leaders()
        pair.both("config_change", lead[1], 1, "ADD_OBSERVER", 4)
        for rnd in range(2):
            for cid, h in sorted(a.leaders().items()):
                pair.both("propose", h, cid, bytes([rnd + 50, cid]) * (CMD // 2))
                if cid % 3 == rnd % 3:
                    ctx += 1
                    pair.both("read", h, cid, ctx)
            pair.round("final", ticks=2)
        pair.round("drain")
    finally:
        for s in pair.sides:
            s.close()
    return pair, moved, ctx


CASES = {
    # drive_ticks, drive_reads, telem and hier on a third of the groups:
    # each on in one case and off in the other
    "ticks-reads-telem-hier": dict(ticks=True, reads=True, telem=True, hier=True),
    "scalar-ticks": dict(ticks=False, reads=False, telem=False, hier=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_raft_through_the_coordinator(case):
    flags = CASES[case]
    pair, moved, n_reads = run_deployment(flags, seed=len(case))
    a = pair.a
    assert moved
    # every group ends with one leader, every write on all 3 replicas
    lead = a.leaders()
    assert len(lead) == G
    from tests.test_torch_raft import log_sig

    for cid, h in lead.items():
        r = a.hosts[h].nodes[cid].peer.raft
        assert r.log.committed == r.log.last_index()
        sigs = {log_sig(host.nodes[cid].peer.raft) for host in a.hosts}
        assert len(sigs) == 1, cid
        assert {host.nodes[cid].peer.raft.log.committed for host in a.hosts} == {
            r.log.committed}
    # every read was released at its ctx, or dropped by a leader with no
    # commit in its term yet (the client retries those)
    released = {ev[4] for ev in a.record if ev[0] == "read"}
    dropped = {ev[3] for ev in a.record if ev[0] == "read_dropped"}
    assert released | dropped == set(range(1, n_reads + 1))
    assert len(released) > 2 * len(dropped)
    effects = [e[0] for host in a.hosts for n in host.nodes.values()
               for e in n.effects]
    assert "commit" in effects and "election" in effects
    if flags["ticks"]:
        assert "elect" in effects and "heartbeat" in effects
    if flags["reads"]:
        assert sum(h.coord.read_confirms for h in a.hosts) > 0


# ----------------------------------------------------------------------
# twins of tests/test_raft_etcd_tpu.py, wholly on the port
# ----------------------------------------------------------------------

def _etcd_tpu(side):
    """A fresh copy of the scenario module for one side, made from its
    source: as it is for the reference, with every import pointed at the
    port for the port (its raft, the port's copy of the harness, its engine
    on the CPU)."""
    from tests import raft_harness
    from tests.test_torch_raft import port_harness

    with open(os.path.join(HERE, "test_raft_etcd_tpu.py")) as f:
        src = f.read()
    harness = raft_harness
    if side == "port":
        src = src.replace("dragonboat_tpu.", "dragonboat_tpu_torch.")
        harness = port_harness
    src = src.replace("from tests.raft_harness import", "from _harness import")
    mod = types.ModuleType(f"{side}_test_raft_etcd_tpu")
    mod.__dict__["__builtins__"] = dict(
        vars(__import__("builtins")),
        __import__=lambda name, *a, **k: (
            harness if name == "_harness" else __import__(name, *a, **k)))
    exec(compile(src, f"<{side} copy of tests/test_raft_etcd_tpu.py>", "exec"),
         mod.__dict__)
    if side == "port":
        assert mod.BatchedQuorumEngine.__module__ == "dragonboat_tpu_torch.ops.engine"
        mod.BatchedQuorumEngine = functools.partial(mod.BatchedQuorumEngine,
                                                    device="cpu")
    return mod


@pytest.mark.parametrize("scenario", [
    "test_differential_log_replication",
    "test_differential_cannot_commit_without_new_term_entry",
    "test_differential_dueling_candidates",
    "test_differential_leader_cycle_and_commit",
])
def test_etcd_tpu_scenario_wholly_on_the_port(scenario):
    prints = {}
    for side in ("ref", "port"):
        m = _etcd_tpu(side)
        seen = prints[side] = []
        base = m.cluster_fingerprint

        def fingerprint(nt, base=base, seen=seen):
            fp = base(nt)
            seen.append({nid: dict(v, state=int(v["state"]))
                         for nid, v in fp.items()})
            return fp

        m.cluster_fingerprint = fingerprint
        getattr(m, scenario)()
        prefix = "dragonboat_tpu_torch." if side == "port" else "dragonboat_tpu."
        assert m.Raft.__module__.startswith(prefix)
        assert m.SyncDeviceOffload.__init__.__globals__["Raft"] is m.Raft
    assert prints["ref"] and prints["ref"] == prints["port"]
