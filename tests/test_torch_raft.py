"""The port's Raft core against the JAX package's, on the CPU.

``dragonboat_tpu_torch.raft`` is a copy of ``dragonboat_tpu.raft``.  One
seeded script drives a cluster of 3 or 5 replicas in each package: the
reference's over ``tests/raft_harness.py``'s ``Network`` (its router: the
cut, isolate and recover controls), the port's over a copy of that
harness made in this file from the harness's own source with the package
renamed.  Each replica runs the node's update cycle on its ``Peer``
(save, send, apply, commit) over an in-memory log DB; every message goes
through its own package's codec, one delivery at a time, and is decoded
by the receiver.  The script has ticks, campaigns, 16-byte proposals,
dropped messages, a partition, leader transfers, joining voters,
observers and witnesses, a removal, ReadIndex reads, log compaction with
a snapshot sent to a lagging replica, and is parametrised over
``check_quorum``, ``read_lease`` and ``hier_commit``.  After every
delivery the two clusters must agree with tolerance 0: every replica's
term, vote, state, leader, committed, applied, last index, the
``(index, term)`` signature of its log, and the ordered record of every
message's bytes, every read state and every applied entry.

The reference Raft has no pre-vote (dragonboat's has none either; the
check-quorum vote lease takes its part), so the election half is
parametrised over ``check_quorum`` instead.

The twins re-run named scenarios of ``tests/test_raft_paper.py`` and
``tests/test_raft_etcd.py`` with their module's names bound to the port
(parameters carried across as bytes), on both packages in one test, and
compare every message the two runs sent and the rafts they end with.
No test here starts a thread or reads a clock.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import itertools
import os
import sys
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
from tests import raft_harness as ref_harness

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _copy_harness():
    """The port's copy of ``tests/raft_harness.py``: the same source with
    every ``dragonboat_tpu.`` import pointed at ``dragonboat_tpu_torch.``."""
    with open(os.path.join(HERE, "raft_harness.py")) as f:
        src = f.read().replace("dragonboat_tpu.", "dragonboat_tpu_torch.")
    mod = types.ModuleType("port_raft_harness")
    mod.__file__ = "<port copy of tests/raft_harness.py>"
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


port_harness = _copy_harness()


class Pkg:
    """One package's Raft core, seen through the names the script uses."""

    def __init__(self, name, config, raft, wire, harness):
        self.name = name
        self.Config = config.Config
        self.Peer = raft.Peer
        self.PeerAddress = raft.PeerAddress
        self.InMemLogDB = raft.InMemLogDB
        self.RaftState = raft.RaftState
        self.wire = wire
        self.codec = wire.codec
        self.MT = wire.MessageType
        self.harness = harness


PKGS = {
    "ref": Pkg("ref", ref_config, ref_raft, ref_wire, ref_harness),
    "port": Pkg("port", port_config, port_raft, port_wire, port_harness),
}

CMD = 16  # proposal payload bytes (BASELINE rung 1's 16B proposals)


# ----------------------------------------------------------------------
# one package's cluster
# ----------------------------------------------------------------------

def log_sig(r):
    """``(index, term)`` of every entry the raft's log view holds."""
    lo, hi = r.log.first_index(), r.log.last_index()
    if hi < lo:
        return ()
    return tuple((e.index, e.term) for e in r.log.get_entries(lo, hi + 1, 1 << 62))


def raft_view(r):
    return (int(r.term), int(r.vote), int(r.state), int(r.leader_id),
            int(r.log.committed), int(r.applied), int(r.log.last_index()),
            log_sig(r))


class Cluster:
    """Replicas of one package joined by the harness's router."""

    def __init__(self, pkg: Pkg, n, flags, seed):
        self.pkg = pkg
        self.flags = flags
        self.seed = seed
        self.net = pkg.harness.Network()  # the router; peers added below
        self.peers = {}
        self.logdbs = {}
        self.applied = {}
        self.queue = []  # (from, to, bytes) in send order
        self.record = []  # every message, read state and apply, in order
        self.members = {nid: "voter" for nid in range(1, n + 1)}
        addrs = [pkg.PeerAddress(nid, f"a{nid}") for nid in self.members]
        for nid in self.members:
            self._launch(nid, addrs, initial=True)

    def _config(self, nid, role="voter"):
        f = self.flags
        return self.pkg.Config(
            node_id=nid, cluster_id=1, election_rtt=10, heartbeat_rtt=1,
            check_quorum=f["check_quorum"], read_lease=f["read_lease"],
            hier_commit=f["hier"], hier_domains=dict(f["domains"]),
            is_observer=role == "observer", is_witness=role == "witness")

    def _launch(self, nid, addrs, initial, role="voter"):
        pkg = self.pkg
        logdb = pkg.InMemLogDB()
        p = pkg.Peer.launch(self._config(nid, role), logdb, None, addrs,
                            initial=initial, new_node=True,
                            seed=self.seed * 64 + nid)
        self.peers[nid] = p
        self.logdbs[nid] = logdb
        self.applied[nid] = 0
        self.net.peers[nid] = p.raft
        self.net.storage[nid] = logdb
        self.process(nid)

    def join(self, nid, role):
        """Start a replica that joins an existing cluster (no bootstrap)."""
        self._launch(nid, [], initial=False, role=role)

    def raft(self, nid):
        return self.peers[nid].raft

    def leader(self):
        leaders = [nid for nid, p in self.peers.items() if p.raft.is_leader()]
        return max(leaders, key=lambda nid: self.raft(nid).term) if leaders else 0

    # -- the node's update cycle -------------------------------------

    def process(self, nid):
        pkg, w = self.pkg, self.pkg.wire
        p, logdb = self.peers[nid], self.logdbs[nid]
        for _ in range(8):
            if not p.has_update(True):
                return
            ud = p.get_update(True, self.applied[nid])
            snap = not w.is_empty_snapshot(ud.snapshot)
            if snap:
                logdb.apply_snapshot(ud.snapshot)
            if ud.entries_to_save:
                logdb.append(ud.entries_to_save)
                # a save ends the log where it ends (a conflicting tail is
                # gone), as the node's LogReader does; InMemLogDB keeps its
                # high mark otherwise
                logdb.max_index = ud.entries_to_save[-1].index
            if not w.is_empty_state(ud.state):
                logdb.set_state(ud.state)
            for m in ud.messages:
                data = pkg.codec.encode_message(m)
                self.record.append(("msg", nid, m.to, data))
                self.queue.append((nid, m.to, data))
            for rtr in ud.ready_to_reads:
                self.record.append(("read", nid, rtr.index, rtr.system_ctx.low,
                                    rtr.system_ctx.high, rtr.lease))
            for ctx in ud.dropped_read_indexes:
                self.record.append(("read_dropped", nid, ctx.low, ctx.high))
            for e in ud.dropped_entries:
                self.record.append(("dropped", nid, bytes(e.cmd)))
            p.commit(ud)
            applied = self.applied[nid]
            if snap:
                p.restore_remotes(ud.snapshot)
                applied = max(applied, ud.snapshot.index)
                self.record.append(("restored", nid, ud.snapshot.index))
            for e in ud.committed_entries:
                if e.index <= applied:
                    continue
                if e.type == w.EntryType.CONFIG_CHANGE:
                    cc = pkg.codec.decode_config_change(e.cmd)
                    p.apply_config_change(cc)
                    self.record.append(("cc", nid, e.index, int(cc.type),
                                        cc.node_id))
                applied = e.index
                self.record.append(("apply", nid, e.index, e.term))
            if applied != self.applied[nid]:
                self.applied[nid] = applied
                p.notify_raft_last_applied(applied)

    # -- inputs ---------------------------------------------------------

    def deliver(self, drop=False):
        """Hand the oldest message in flight to its receiver (or lose it)."""
        frm, to, data = self.queue.pop(0)
        if drop or self.net.dropm.get((frm, to), 0.0) >= 1.0 or to not in self.peers:
            self.record.append(("lost", frm, to))
            return
        m = self.pkg.codec.decode_message(data)
        self.peers[to].handle(m)
        self.process(to)
        if m.type == self.pkg.MT.INSTALL_SNAPSHOT and frm in self.peers:
            # the transport reports a streamed snapshot's outcome
            self.peers[frm].report_snapshot_status(to, False)
            self.process(frm)

    def tick(self, nid):
        self.peers[nid].tick()
        self.process(nid)

    def propose(self, nid, cmd):
        self.peers[nid].propose_entries([self.pkg.wire.Entry(cmd=cmd)])
        self.process(nid)

    def read(self, nid, low, high):
        self.peers[nid].read_index(self.pkg.wire.SystemCtx(low=low, high=high))
        self.process(nid)

    def campaign(self, nid):
        self.peers[nid].campaign()
        self.process(nid)

    def transfer(self, leader, target):
        self.peers[leader].request_leader_transfer(target)
        self.process(leader)

    def config_change(self, leader, kind, nid, key):
        w = self.pkg.wire
        cc = w.ConfigChange(type=getattr(w.ConfigChangeType, kind),
                            node_id=nid, address=f"a{nid}")
        self.peers[leader].propose_config_change(cc, key)
        self.process(leader)

    def compact(self, nid):
        """Snapshot the replica's log DB at its applied index and compact it
        there (what the state machine's snapshot and the log GC do)."""
        r, logdb = self.raft(nid), self.logdbs[nid]
        index = min(self.applied[nid], logdb.get_range()[1])
        if index <= logdb.get_range()[0]:
            return False
        w = self.pkg.wire
        ms = w.Membership(
            addresses={i: f"a{i}" for i in r.remotes},
            observers={i: f"a{i}" for i in r.observers},
            witnesses={i: f"a{i}" for i in r.witnesses})
        logdb.create_snapshot(w.Snapshot(index=index, term=logdb.term(index),
                                         membership=ms))
        logdb.compact(index)
        self.record.append(("compact", nid, index))
        return True

    def view(self):
        return tuple((nid, raft_view(p.raft), self.applied[nid])
                     for nid, p in sorted(self.peers.items()))


# ----------------------------------------------------------------------
# the script
# ----------------------------------------------------------------------

class Pair:
    """The two clusters in lockstep; compared after every input."""

    def __init__(self, n, flags, seed):
        self.sides = [Cluster(PKGS[s], n, flags, seed) for s in ("ref", "port")]
        self.rng = np.random.default_rng(seed)
        self.steps = 0
        self.seen = 0
        self.same("launch")

    @property
    def a(self):
        return self.sides[0]

    def both(self, fn, *args, **kw):
        out = [getattr(s, fn)(*args, **kw) for s in self.sides]
        self.same(fn)
        return out[0]

    def same(self, tag):
        self.steps += 1
        a, b = self.sides
        assert a.view() == b.view(), (tag, self.steps)
        assert a.record[self.seen:] == b.record[self.seen:], (tag, self.steps)
        assert len(a.record) == len(b.record) and a.queue == b.queue
        self.seen = len(a.record)

    def deliver_all(self, limit=4000):
        for _ in range(limit):
            if not self.a.queue:
                return
            self.both("deliver")
        raise AssertionError("messages kept flowing")

    def tick_all(self, n=1):
        for _ in range(n):
            for nid in sorted(self.a.peers):
                self.both("tick", nid)

    def settle(self, max_ticks=60):
        """Tick and deliver until one leader leads every live replica."""
        for _ in range(max_ticks):
            self.deliver_all()
            lead = self.a.leader()
            if lead and all(self.a.raft(n).leader_id == lead
                            for n in self.a.peers
                            if not self.a.net.dropm.get((lead, n))
                            and self.a.members.get(n) != "removed"):
                return lead
            self.tick_all()
        return self.a.leader()

    def random_steps(self, count, ctx):
        rng, a = self.rng, self.a
        voters = lambda: [n for n, k in a.members.items() if k == "voter"]  # noqa: E731
        for _ in range(count):
            u = rng.random()
            if u < 0.40 and a.queue:
                self.both("deliver")
            elif u < 0.46 and a.queue:
                self.both("deliver", drop=True)
            elif u < 0.62:
                self.both("tick", int(rng.choice(sorted(a.peers))))
            elif u < 0.76:
                lead = a.leader() or int(rng.choice(sorted(a.peers)))
                self.both("propose", lead, rng.bytes(CMD))
            elif u < 0.84:
                ctx[0] += 1
                nid = int(rng.choice(sorted(a.peers)))
                self.both("read", nid, ctx[0], nid)
            elif u < 0.88:
                self.both("campaign", int(rng.choice(voters())))
            elif u < 0.91:
                lead = a.leader()
                if lead:
                    others = [n for n in voters() if n != lead]
                    self.both("transfer", lead, int(rng.choice(others)))
            elif u < 0.93:
                nid = int(rng.choice(sorted(a.peers)))
                self.both("compact", nid)
            else:
                self.tick_all()


def run_script(n, flags, seed):
    pair = Pair(n, flags, seed)
    a = pair.a
    ctx = [0]
    # elections and the first writes
    lead = pair.settle()
    assert lead, "no leader"
    pair.random_steps(300, ctx)
    lead = pair.settle()
    # a leader transfer to an up-to-date follower
    target = min(nid for nid in a.members if nid != lead)
    pair.both("transfer", lead, target)
    pair.deliver_all()
    lead = pair.settle()
    # ReadIndex reads on the leader and on a follower, echoed back
    pair.tick_all(2)
    pair.deliver_all()
    for nid in (lead, min(n for n in a.members if n != lead)):
        ctx[0] += 1
        pair.both("read", nid, ctx[0], nid)
        pair.deliver_all()
        pair.tick_all()
        pair.deliver_all()
    # a partitioned follower misses writes; the leader compacts and the
    # follower catches up from a snapshot once it heals
    lag = max(nid for nid in a.members if nid != lead)
    for s in pair.sides:
        s.net.isolate(lag)
    for _ in range(6):
        pair.both("propose", lead, pair.rng.bytes(CMD))
        pair.deliver_all()
    pair.tick_all(2)
    pair.deliver_all()
    assert pair.both("compact", lead)
    for s in pair.sides:
        s.net.recover()
    lead = pair.settle()
    pair.tick_all(3)
    lead = pair.settle()
    # membership: an observer, a witness and a voter join, a voter leaves
    next_id = n + 1
    for kind, role in (("ADD_OBSERVER", "observer"), ("ADD_WITNESS", "witness"),
                       ("ADD_NODE", "voter")):
        lead = pair.settle()
        pair.both("config_change", lead, kind, next_id, next_id)
        pair.deliver_all()
        pair.tick_all(2)
        pair.both("join", next_id, role)
        for s in pair.sides:
            s.members[next_id] = role
        pair.settle()
        pair.tick_all(4)
        next_id += 1
    lead = pair.settle()
    gone = min(nid for nid, k in a.members.items() if k == "voter" and nid != lead)
    pair.both("config_change", lead, "REMOVE_NODE", gone, next_id)
    pair.deliver_all()
    pair.tick_all(2)
    for s in pair.sides:
        s.members[gone] = "removed"
    # more of everything, the new members included
    pair.random_steps(300, ctx)
    for s in pair.sides:
        s.net.recover()
    pair.tick_all(12)
    lead = pair.settle()
    assert lead
    return pair


FLAGS = {
    "plain": dict(check_quorum=False, read_lease=False, hier=False),
    "check_quorum": dict(check_quorum=True, read_lease=False, hier=False),
    "read_lease": dict(check_quorum=True, read_lease=True, hier=False),
    "hier": dict(check_quorum=False, read_lease=False, hier=True),
    "hier_lease": dict(check_quorum=True, read_lease=True, hier=True),
}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("n,flags", [
    (3, "plain"), (5, "check_quorum"), (3, "read_lease"), (5, "hier"),
    (3, "hier_lease"),
], ids=["3-plain", "5-check_quorum", "3-read_lease", "5-hier", "3-hier_lease"])
def test_raft_differential(n, flags, seed):
    f = dict(FLAGS[flags])
    # two latency domains; joiners land in the far one
    f["domains"] = ({1: "a", 2: "a", 3: "b", 4: "b", 5: "b", 6: "b", 7: "b"}
                    if n == 3 else
                    {1: "a", 2: "a", 3: "a", 4: "b", 5: "b", 6: "b", 7: "b",
                     8: "b"})
    pair = run_script(n, f, seed)
    kinds = {}
    MT = PKGS["ref"].MT
    for ev in pair.a.record:
        if ev[0] == "msg":
            t = MT(ref_wire.codec.decode_message(ev[3]).type).name
            kinds[t] = kinds.get(t, 0) + 1
        else:
            kinds[ev[0]] = kinds.get(ev[0], 0) + 1
    for want in ("REQUEST_VOTE", "REPLICATE", "HEARTBEAT", "HEARTBEAT_RESP",
                 "INSTALL_SNAPSHOT", "TIMEOUT_NOW", "read", "cc", "restored",
                 "lost"):
        assert kinds.get(want), (want, kinds)
    roles = {pair.a.raft(nid).state for nid in pair.a.peers}
    RS = PKGS["ref"].RaftState
    assert {RS.OBSERVER, RS.WITNESS, RS.LEADER} <= roles, roles


def test_log_carried_across_as_bytes():
    """A port raft rebuilt from a reference raft's log DB through the wire
    bytes has the same log, state and election outcome."""
    pair = Pair(3, dict(FLAGS["plain"], domains={}), 9)
    pair.settle()
    for i in range(5):
        pair.both("propose", pair.a.leader(), bytes([i]) * CMD)
        pair.deliver_all()
    ref_db = pair.a.logdbs[1]
    ref_db.membership = ref_wire.Membership(
        addresses={i: f"a{i}" for i in (1, 2, 3)})
    lo, hi = ref_db.get_range()
    ents = ref_db.entries(lo, hi + 1, 1 << 62)
    port_db = port_raft.InMemLogDB()
    port_db.append(port_wire.codec.decode_entry_batch(
        ref_wire.codec.encode_entry_batch(ents)))
    st, ms = ref_db.node_state()
    port_db.set_state(port_wire.codec.decode_state(ref_wire.codec.encode_state(st)))
    port_db.membership = port_wire.codec.decode_membership(
        ref_wire.codec.encode_membership(ms))
    assert port_wire.codec.encode_entry_batch(
        port_db.entries(lo, hi + 1, 1 << 62)) == ref_wire.codec.encode_entry_batch(ents)
    cfg = dict(node_id=1, cluster_id=1, election_rtt=10, heartbeat_rtt=1)
    rebuilt = {
        "ref": ref_raft.Raft(ref_config.Config(**cfg), ref_db, seed=3),
        "port": port_raft.Raft(port_config.Config(**cfg), port_db, seed=3),
    }
    views = {k: raft_view(r) for k, r in rebuilt.items()}
    assert views["ref"] == views["port"]
    for r in rebuilt.values():
        r.set_applied(r.log.committed)  # the state machine is caught up
        r.handle(_election(r))
    assert rebuilt["port"].is_candidate()
    assert [ref_wire.codec.encode_message(m) for m in rebuilt["ref"].msgs] == [
        port_wire.codec.encode_message(m) for m in rebuilt["port"].msgs]


def _election(r):
    mod = importlib.import_module(type(r).__module__.rsplit(".", 2)[0] + ".wire")
    return mod.Message(type=mod.MessageType.ELECTION, from_=r.node_id)


# ----------------------------------------------------------------------
# twins of named scenarios
# ----------------------------------------------------------------------

def _port_name(v):
    """The port's object of the same qualified name as a reference one."""
    mod = getattr(v, "__module__", None) or ""
    if isinstance(v, types.ModuleType):
        return importlib.import_module(
            v.__name__.replace("dragonboat_tpu", "dragonboat_tpu_torch", 1))
    if mod.startswith("dragonboat_tpu."):
        target = importlib.import_module(
            mod.replace("dragonboat_tpu", "dragonboat_tpu_torch", 1))
        return getattr(target, v.__qualname__)
    if mod in ("raft_harness", "tests.raft_harness"):
        return getattr(port_harness, v.__name__)
    return None


_CODEC = {"Entry": ("encode_entry", "decode_entry"),
          "Message": ("encode_message", "decode_message"),
          "State": ("encode_state", "decode_state"),
          "Snapshot": ("encode_snapshot", "decode_snapshot"),
          "Membership": ("encode_membership", "decode_membership")}


def to_port(v, g=None):
    """Carry a reference value to the port: wire values through their
    bytes, enums by value, functions of a test module rebound to ``g``."""
    if isinstance(v, enum.Enum):
        return _port_name(type(v))(v.value)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name in _CODEC and type(v).__module__.startswith("dragonboat_tpu."):
            enc, dec = _CODEC[name]
            return getattr(port_wire.codec, dec)(getattr(ref_wire.codec, enc)(v))
    if isinstance(v, list):
        return [to_port(x, g) for x in v]
    if isinstance(v, tuple):
        return tuple(to_port(x, g) for x in v)
    if isinstance(v, dict):
        return {to_port(k, g): to_port(x, g) for k, x in v.items()}
    if isinstance(v, types.FunctionType) and g is not None and (
            v.__module__ == g["__name__"]):
        return types.FunctionType(
            v.__code__, g, v.__name__,
            None if v.__defaults__ is None else to_port(v.__defaults__, g),
            v.__closure__)
    if isinstance(v, (types.ModuleType, type, types.FunctionType,
                      types.BuiltinFunctionType)):
        p = _port_name(v)
        return v if p is None else p
    return v


class _Recorder:
    """Every message a scenario's rafts sent, as bytes, and the rafts it
    built, for one package."""

    def __init__(self, codec):
        self.codec = codec
        self.sent = []
        self.nets = []

    def network(self, base):
        rec = self

        class RecordingNetwork(base):
            def __init__(self, *peers, **kw):
                super().__init__(*peers, **kw)
                rec.nets.append(self)

            def filter(self, msgs):
                rec.sent.extend(rec.codec.encode_message(m) for m in msgs)
                return super().filter(msgs)

        return RecordingNetwork

    def read_messages(self, base):
        def read_messages(r):
            msgs = base(r)
            self.sent.extend(self.codec.encode_message(m) for m in msgs)
            return msgs
        return read_messages

    def finals(self):
        return [tuple((nid, raft_view(p)) for nid, p in sorted(net.peers.items())
                      if hasattr(p, "log")) for net in self.nets]


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` for a scenario run on the port: imports inside the
    scenario's functions reach the port's modules and its harness."""
    if level == 0 and (name == "dragonboat_tpu"
                       or name.startswith("dragonboat_tpu.")):
        name = name.replace("dragonboat_tpu", "dragonboat_tpu_torch", 1)
    elif level == 0 and name in ("raft_harness", "tests.raft_harness"):
        return port_harness
    return __import__(name, globals, locals, fromlist, level)


_PORT_BUILTINS = dict(vars(__import__("builtins")), __import__=_port_import)

_MODULES = {}


def _scenario_module(name):
    if name not in _MODULES:
        _MODULES[name] = importlib.import_module(f"tests.{name}")
    return _MODULES[name]


def _twin(modname, fname, args):
    mod = _scenario_module(modname)
    fn = getattr(mod, fname)
    recs = {}
    for side in ("ref", "port"):
        rec = recs[side] = _Recorder(PKGS[side].codec)
        g = {"__name__": mod.__name__,
             "__builtins__": (vars(__import__("builtins")) if side == "ref"
                              else _PORT_BUILTINS)}
        for k, v in mod.__dict__.items():
            if k.startswith("__"):
                continue
            g[k] = v if side == "ref" else to_port(v, g)
        # the reference side keeps the harness instance its module imported
        harness = (sys.modules[mod.Network.__module__] if side == "ref"
                   else port_harness)
        g["Network"] = rec.network(harness.Network)
        g["read_messages"] = rec.read_messages(harness.read_messages)
        call_args = args if side == "ref" else to_port(args, g)
        types.FunctionType(fn.__code__, g, fn.__name__)(*call_args)
    assert recs["ref"].sent == recs["port"].sent
    assert recs["ref"].finals() == recs["port"].finals()
    return recs


def _cases(modname, names):
    mod = _scenario_module(modname)
    out = []
    for fname in names:
        fn = getattr(mod, fname)
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        grids = []
        for m in marks:
            argnames = m.args[0]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            vals = [v if len(argnames) > 1 else (v,) for v in m.args[1]]
            grids.append((argnames, vals))
        if not grids:
            out.append(pytest.param(modname, fname, (), id=fname))
            continue
        params = list(fn.__code__.co_varnames[:fn.__code__.co_argcount])
        for i, combo in enumerate(itertools.product(*(g[1] for g in grids))):
            bound = {}
            for (argnames, _), vals in zip(grids, combo):
                bound.update(zip(argnames, vals))
            out.append(pytest.param(modname, fname,
                                    tuple(bound[p] for p in params),
                                    id=f"{fname}-{i}"))
    return out


PAPER = [
    "test_update_term_from_message", "test_start_as_follower",
    "test_leader_bcast_beat", "test_nonleader_start_election",
    "test_leader_election_in_one_round_rpc", "test_follower_vote",
    "test_candidate_fallback", "test_nonleader_election_timeout_randomized",
    "test_nonleaders_election_timeout_nonconflict",
    "test_leader_start_replication", "test_leader_commit_entry",
    "test_leader_acknowledge_commit", "test_leader_commit_preceding_entries",
    "test_follower_commit_entry", "test_follower_check_replicate",
    "test_follower_append_entries", "test_leader_sync_follower_log",
    "test_vote_request", "test_voter",
    "test_leader_only_commits_log_from_current_term",
]
ETCD = [
    "test_leader_transfer_to_up_to_date_node",
    "test_leader_transfer_to_up_to_date_node_from_follower",
    "test_leader_transfer_with_check_quorum",
    "test_leader_transfer_to_slow_follower",
    "test_leader_transfer_after_snapshot", "test_leader_transfer_to_self",
    "test_leader_transfer_to_non_existing_node",
    "test_leader_transfer_timeout", "test_leader_transfer_ignore_proposal",
    "test_leader_transfer_receive_higher_term_vote",
    "test_leader_transfer_remove_node",
    "test_new_leader_transfer_cannot_override_ongoing_transfer",
    "test_leader_transfer_second_transfer_to_same_node",
    "test_read_only_option_safe",
]


@pytest.mark.parametrize(
    "modname,fname,args",
    _cases("test_raft_paper", PAPER) + _cases("test_raft_etcd", ETCD))
def test_scenario_twin(modname, fname, args):
    _twin(modname, fname, args)
