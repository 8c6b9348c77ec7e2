"""The scalar raft protocol state machine — the correctness oracle.

Counterpart: ``dragonboat_tpu/raft/raft.py``, copied.

Reference: ``internal/raft/raft.go`` — full Raft with leader election,
replication flow control, membership change, snapshot install, ReadIndex,
leader transfer, observers, witnesses, quiesce and in-memory-log rate
limiting, driven through one message-typed ``handle`` entry point dispatching
via a ``[state][message_type]`` handler table (reference ``raft.go:2034-2102``).

Design deltas from the reference (device-first build):

* **Determinism.** The reference draws randomized election timeouts from a
  global locked PRNG (``raft.go:633-636``) and iterates Go maps in random
  order inside ``tryCommit``/broadcasts.  Here every node owns a seeded
  ``random.Random`` and all peer iteration is in sorted-id order, so a run is
  a pure function of (seed, message sequence).  This is what makes the
  scalar-vs-batched differential tests (bit-identical commitIndex) meaningful.

* **Batched-engine contract.**  The dense per-tick work — vote tallying
  (``handleVoteResp`` reference :1062-1080), commit advancement over sorted
  match indexes (``tryCommit`` reference :861-909), CheckQuorum scans
  (``leaderHasQuorum`` :380-390) and tick counters — is factored so the
  :mod:`dragonboat_tpu_torch.ops` kernels can compute the same outputs for
  ``(nGroups, nPeers)`` tensors; see ``ops/state.py`` for the mapping.
"""
from __future__ import annotations

import collections as _collections
import enum
import random as _random
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

from .. import logger
from ..config import Config
from ..settings import Soft
from ..wire import (
    NO_LEADER,
    NO_NODE,
    ConfigChangeType,
    Entry,
    EntryType,
    Message,
    MessageType,
    ReadyToRead,
    Snapshot,
    State,
    SystemCtx,
    entries_size,
)
from ..lease import LeaderLease
from .hier import FarReadBatcher, HierPlane, sub_quorum_size
from .log import CompactedError, EntryLog, ILogDB, UnavailableError
from .rate import InMemRateLimiter
from .readindex import ReadIndex
from .remote import Remote

plog = logger.get_logger("raft")

MT = MessageType


class RaftState(enum.IntEnum):
    # reference raft.go:64-71
    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2
    OBSERVER = 3
    WITNESS = 4


NUM_STATES = 5

# an Election message with reject=True requests a quiesced tick
# (see node runtime); LocalTick reject=True likewise (reference node.go:933)


def is_request_message(t: MessageType) -> bool:
    return t in (MT.PROPOSE, MT.READ_INDEX)


def is_leader_message(t: MessageType) -> bool:
    return t in (
        MT.REPLICATE,
        MT.INSTALL_SNAPSHOT,
        MT.HEARTBEAT,
        MT.TIMEOUT_NOW,
        MT.READ_INDEX_RESP,
    )


def is_local_message(t: MessageType) -> bool:
    return t in (
        MT.LOCAL_TICK,
        MT.ELECTION,
        MT.LEADER_HEARTBEAT,
        MT.CHECK_QUORUM,
        MT.SNAPSHOT_STATUS,
        MT.UNREACHABLE,
        MT.RATE_LIMIT,
        MT.BATCHED_READ_INDEX,
    )


def count_config_change(entries: List[Entry]) -> int:
    return sum(1 for e in entries if e.type == EntryType.CONFIG_CHANGE)


def make_metadata_entries(entries: List[Entry]) -> List[Entry]:
    # witnesses replicate metadata-only entries (reference raft.go:744-758)
    out = []
    for ent in entries:
        if ent.type != EntryType.CONFIG_CHANGE:
            out.append(Entry(type=EntryType.METADATA, index=ent.index, term=ent.term))
        else:
            out.append(ent)
    return out


def make_witness_snapshot(ss: Snapshot) -> Snapshot:
    # reference raft.go:700-708
    from dataclasses import replace

    return replace(ss, filepath="", file_size=0, files=[], witness=True, dummy=False)


class Raft:
    """One raft replica's protocol state (reference ``raft.go:198-234``)."""

    def __init__(self, c: Config, logdb: ILogDB, seed: Optional[int] = None):
        c.validate()
        if logdb is None:
            raise ValueError("logdb is nil")
        self.cluster_id = c.cluster_id
        self.node_id = c.node_id
        self.leader_id = NO_LEADER
        self.term = 0
        self.vote = NO_NODE
        self.applied = 0
        self.rl = InMemRateLimiter(c.max_in_mem_log_size)
        self.log = EntryLog(logdb, self.rl)
        self.remotes: Dict[int, Remote] = {}
        self.observers: Dict[int, Remote] = {}
        self.witnesses: Dict[int, Remote] = {}
        self.state = RaftState.FOLLOWER
        self.votes: Dict[int, bool] = {}
        self.msgs: List[Message] = []
        self.leader_transfer_target = NO_NODE
        self.is_leader_transfer_target = False
        self.pending_config_change = False
        self.read_index = ReadIndex()
        # leader-lease read plane (Config.read_lease): None is
        # the structural latch — every hook below gates on `is not None`,
        # so lease-off request paths are bit-identical to the pre-lease
        # build (the _read_plane_used precedent).  Constructed before the
        # become_* calls at the bottom of __init__ (reset() touches it).
        self.lease = (
            LeaderLease(c.election_rtt) if c.read_lease else None
        )
        # replication attribution plane (obs/replattr.py): set
        # by the node when request tracing is on; None is the structural
        # latch — every hook below gates on `is not None`, so trace-off
        # request paths stay bit-identical (the lease/offload precedent)
        self.replattr = None
        # hierarchical commit plane (raft/hier.py,
        # Config.hier_commit): None is the structural latch — every hook
        # below gates on `is not None`, so hier-off request paths stay
        # bit-identical (the lease/replattr precedent).  The plane holds
        # the domain map plus the coupled sub-quorum commit / vote
        # intersection rules; the far-read batcher rides beside it and
        # activates only on followers whose domain differs from the
        # leader's.
        self.hier = (
            HierPlane(c.hier_domains, c.node_id) if c.hier_commit else None
        )
        self.far_reads = FarReadBatcher() if c.hier_commit else None
        # whether the most recent commit advancement closed via the
        # near-domain sub-quorum rather than the classic quorum — read
        # by _note_commit so replication attribution counts the closer
        # against the rule that actually closed the commit
        self._commit_via_sub = False
        self.ready_to_read: List[ReadyToRead] = []
        self.dropped_entries: List[Entry] = []
        self.dropped_read_indexes: List[SystemCtx] = []
        self.quiesce = False
        self.check_quorum = c.check_quorum
        self.tick_count = 0
        self.election_tick = 0
        self.heartbeat_tick = 0
        self.election_timeout = c.election_rtt
        self.heartbeat_timeout = c.heartbeat_rtt
        self.randomized_election_timeout = 0
        self.matched: List[int] = []
        self.events = None  # IRaftEventListener
        # quorum plugin (coordinator.QuorumCoordinator); None = pure
        # scalar path.  When set, ack/vote tallying and commit advancement
        # are staged to the batched device engine instead of computed here
        self.offload = None
        # True when the device quorum engine owns the per-tick FIRING
        # decisions (election due / heartbeat due / check-quorum window);
        # scalar clocks still advance (vote-lease checks, transfer abort)
        # but the local fire sites below are suppressed — the coordinator
        # applies the device flags through the same handlers instead
        self.device_ticks = False
        # True when the device engine's read plane batches ReadIndex
        # confirmations (kernels.read_confirm): pending-read bookkeeping
        # (queue, hint rebroadcast) stays HERE — the scalar path remains
        # the fallback and the releaser — but heartbeat-echo quorum
        # counting moves to the per-round fused dispatch; the coordinator
        # routes confirmed ctxs back through ``read_index.release`` with
        # leader/term guards intact (node._apply_offload_effects)
        self.device_reads = False
        # True when the group's state machine is device-resident
        # (devsm): the leader offloads every appended application
        # entry's (index, payload) to the coordinator's DevKVPlane at
        # append time, so the in-program apply fold has the op buffered
        # before its commit can land.  Set by NodeHost registration
        # (Config.device_kv on the device engine); False keeps
        # append_entries bit-identical.  The port's NodeHost and rsm/ come
        # with a later slice; until then append_entries refuses it.
        self.device_kv = False
        # first index of the current leadership term (set at promotion)
        self.term_start_index = 0
        # ring buffer of recent election-related events (campaigns, vote
        # grants/rejections, state transitions) — near-free and invaluable
        # when diagnosing wedged elections at 4k+ group scale
        self.vote_trace: _collections.deque = _collections.deque(maxlen=24)
        # elapsed election clock stashed across a REQUEST_VOTE step-down
        # (consumed by handle_node_request_vote's log-behind restore)
        self._stepdown_etick: Optional[int] = None
        self.has_not_applied_config_change: Optional[Callable[[], bool]] = None
        # deterministic, seedable randomness (design delta; see module docstring)
        self.prng = _random.Random(
            seed if seed is not None else (c.cluster_id << 32) ^ c.node_id
        )

        st, members = logdb.node_state()
        for p in members.addresses:
            self.remotes[p] = Remote(next=1)
        for p in members.observers:
            self.observers[p] = Remote(next=1)
        for p in members.witnesses:
            self.witnesses[p] = Remote(next=1)
        self.reset_match_value_array()
        if not st.is_empty():
            self.load_state(st)
        if c.is_observer:
            self.state = RaftState.OBSERVER
            self.become_observer(self.term, NO_LEADER)
        elif c.is_witness:
            self.state = RaftState.WITNESS
            self.become_witness(self.term, NO_LEADER)
        else:
            self.become_follower(self.term, NO_LEADER)

    # ------------------------------------------------------------------
    # introspection helpers
    # ------------------------------------------------------------------

    def describe(self) -> str:
        li = self.log.last_index()
        try:
            t = self.log.term(li)
        except CompactedError:
            t = 0
        return (
            f"[f:{self.log.first_index()},l:{li},t:{t},"
            f"c:{self.log.committed},a:{self.log.processed}] "
            f"[{self.cluster_id}:{self.node_id}] t{self.term}"
        )

    def is_leader(self) -> bool:
        return self.state == RaftState.LEADER

    def is_candidate(self) -> bool:
        return self.state == RaftState.CANDIDATE

    def is_follower(self) -> bool:
        return self.state == RaftState.FOLLOWER

    def is_observer(self) -> bool:
        return self.state == RaftState.OBSERVER

    def is_witness(self) -> bool:
        return self.state == RaftState.WITNESS

    def must_be_leader(self) -> None:
        if not self.is_leader():
            raise RuntimeError(f"{self.describe()} is not a leader")

    def set_leader_id(self, leader_id: int) -> None:
        self.leader_id = leader_id
        if self.events is not None:
            self.events.leader_updated(
                self.cluster_id, self.node_id, leader_id, self.term
            )

    def set_applied(self, applied: int) -> None:
        self.applied = applied

    def get_applied(self) -> int:
        return self.applied

    def leader_transfering(self) -> bool:
        return self.leader_transfer_target != NO_NODE and self.is_leader()

    def abort_leader_transfer(self) -> None:
        self.leader_transfer_target = NO_NODE

    def num_voting_members(self) -> int:
        return len(self.remotes) + len(self.witnesses)

    def quorum(self) -> int:
        return self.num_voting_members() // 2 + 1

    def is_single_node_quorum(self) -> bool:
        return self.quorum() == 1

    def leader_has_quorum(self) -> bool:
        # reference raft.go:380-390
        c = 0
        for nid, member in self.voting_members().items():
            if nid == self.node_id or member.is_active():
                c += 1
                member.set_not_active()
        return c >= self.quorum()

    def nodes(self) -> List[int]:
        return sorted(
            list(self.remotes) + list(self.observers) + list(self.witnesses)
        )

    def nodes_sorted(self) -> List[int]:
        return self.nodes()

    def voting_members(self) -> Dict[int, Remote]:
        out = dict(self.remotes)
        out.update(self.witnesses)
        return out

    def raft_state(self) -> State:
        return State(term=self.term, vote=self.vote, commit=self.log.committed)

    def load_state(self, st: State) -> None:
        if st.commit < self.log.committed or st.commit > self.log.last_index():
            raise RuntimeError(
                f"{self.describe()} out of range state, commit {st.commit}, "
                f"range [{self.log.committed},{self.log.last_index()}]"
            )
        self.log.committed = st.commit
        self.term = st.term
        self.vote = st.vote

    def reset_match_value_array(self) -> None:
        self.matched = [0] * self.num_voting_members()

    # ------------------------------------------------------------------
    # snapshot restore
    # ------------------------------------------------------------------

    def restore(self, ss: Snapshot) -> bool:
        # reference raft.go:441-480
        if ss.index <= self.log.committed:
            return False
        if not self.is_observer():
            for nid in ss.membership.observers:
                if nid == self.node_id:
                    raise RuntimeError(
                        f"{self.describe()} converting to observer, {ss.index}"
                    )
        if not self.is_witness():
            for nid in ss.membership.witnesses:
                if nid == self.node_id:
                    raise RuntimeError(
                        f"{self.describe()} converting to witness, {ss.index}"
                    )
        # p52 of the raft thesis
        if self.log.match_term(ss.index, ss.term):
            # a snapshot at index X implies X has been committed
            self.log.commit_to(ss.index)
            return False
        self.log.restore(ss)
        return True

    def restore_remotes(self, ss: Snapshot) -> None:
        # reference raft.go:482-530
        self.remotes = {}
        for nid in sorted(ss.membership.addresses):
            if nid == self.node_id and self.is_observer():
                self.become_follower(self.term, self.leader_id)
            if nid in self.witnesses:
                raise RuntimeError("witness could not promote to full member")
            match = 0
            next_ = self.log.last_index() + 1
            if nid == self.node_id:
                match = next_ - 1
            self.set_remote(nid, match, next_)
        if self.self_removed() and self.is_leader():
            self.become_follower(self.term, NO_LEADER)
        self.observers = {}
        for nid in sorted(ss.membership.observers):
            match = 0
            next_ = self.log.last_index() + 1
            if nid == self.node_id:
                match = next_ - 1
            self.set_observer(nid, match, next_)
        self.witnesses = {}
        for nid in sorted(ss.membership.witnesses):
            match = 0
            next_ = self.log.last_index() + 1
            if nid == self.node_id:
                match = next_ - 1
            self.set_witness(nid, match, next_)
        self.reset_match_value_array()
        self.lease_membership_changed()
        if self.offload is not None:
            self.offload.membership_changed(self.cluster_id)

    def lease_membership_changed(self) -> None:
        """Invalidation matrix: membership changed — the quorum the lease
        bases were tallied against no longer exists.  Re-arm from fresh
        acks against the new membership.  A PARTIAL reset: same-term
        acks still in flight must keep consuming the sends that elicited
        them (see ``LeaderLease.membership_changed``)."""
        if self.lease is not None:
            self.lease.membership_changed()

    # ------------------------------------------------------------------
    # tick
    # ------------------------------------------------------------------

    def time_for_election(self) -> bool:
        return self.election_tick >= self.randomized_election_timeout

    def time_for_heartbeat(self) -> bool:
        return self.heartbeat_tick >= self.heartbeat_timeout

    def time_for_check_quorum(self) -> bool:
        return self.election_tick >= self.election_timeout

    def time_to_abort_leader_transfer(self) -> bool:
        return self.leader_transfering() and self.election_tick >= self.election_timeout

    def time_for_rate_limit_check(self) -> bool:
        return self.tick_count % self.election_timeout == 0

    def tick(self) -> None:
        # reference raft.go:553-566
        self.quiesce = False
        self.tick_count += 1
        if self.is_leader():
            self.leader_tick()
        else:
            self.non_leader_tick()

    def non_leader_tick(self) -> None:
        # reference raft.go:568-592
        if self.is_leader():
            raise RuntimeError("non_leader_tick called on leader")
        self.election_tick += 1
        if self.time_for_rate_limit_check():
            if self.rl.enabled():
                self.rl.tick()
                self.send_rate_limit_message()
        # section 4.2.1 of the raft thesis: non-voting members and witnesses
        # do not participate in elections
        if self.is_observer() or self.is_witness():
            return
        # 6th paragraph section 5.2 of the raft paper
        if (
            not self.device_ticks
            and not self.self_removed()
            and self.time_for_election()
        ):
            self.election_tick = 0
            self.handle(Message(from_=self.node_id, type=MT.ELECTION))

    def leader_tick(self) -> None:
        # reference raft.go:594-623
        self.must_be_leader()
        self.election_tick += 1
        if self.time_for_rate_limit_check():
            if self.rl.enabled():
                self.rl.tick()
        time_to_abort = self.time_to_abort_leader_transfer()
        if self.time_for_check_quorum():
            self.election_tick = 0
            if self.check_quorum and not self.device_ticks:
                self.handle(Message(from_=self.node_id, type=MT.CHECK_QUORUM))
        if time_to_abort:
            self.abort_leader_transfer()
        self.heartbeat_tick += 1
        if not self.device_ticks and self.time_for_heartbeat():
            self.heartbeat_tick = 0
            self.handle(Message(from_=self.node_id, type=MT.LEADER_HEARTBEAT))

    def quiesced_tick(self) -> None:
        if not self.quiesce:
            self.quiesce = True
        self.election_tick += 1

    def set_randomized_election_timeout(self) -> None:
        # deterministic seeded PRNG (design delta; reference raft.go:633-636)
        self.randomized_election_timeout = (
            self.election_timeout + self.prng.randrange(self.election_timeout)
        )
        if self.offload is not None and self.device_ticks:
            # keep the device row's election period in step so split votes
            # get the randomized backoff the raft paper relies on
            self.offload.set_randomized_timeout(
                self.cluster_id, self.randomized_election_timeout
            )

    # ------------------------------------------------------------------
    # send and broadcast
    # ------------------------------------------------------------------

    def finalize_message_term(self, m: Message) -> Message:
        # reference raft.go:641-652
        if m.term == 0 and m.type == MT.REQUEST_VOTE:
            raise RuntimeError("sending RequestVote with 0 term")
        if m.term > 0 and m.type != MT.REQUEST_VOTE:
            raise RuntimeError(f"term unexpectedly set for message type {m.type}")
        if not is_request_message(m.type):
            m.term = self.term
        return m

    def send(self, m: Message) -> None:
        m.from_ = self.node_id
        # stamp the group id so the runtime can route between hosts
        # (reference raft.go send path sets ClusterId on every message)
        m.cluster_id = self.cluster_id
        m = self.finalize_message_term(m)
        self.msgs.append(m)

    def send_rate_limit_message(self) -> None:
        # reference raft.go:663-686
        if self.is_leader():
            raise RuntimeError("leader called send_rate_limit_message")
        if self.leader_id == NO_LEADER:
            return
        if not self.rl.enabled():
            return
        mv = 0
        if self.rl.rate_limited():
            inmem_sz = self.rl.get()
            not_committed = entries_size(self.log.get_uncommitted_entries())
            mv = max(inmem_sz - not_committed, 0)
        self.send(Message(type=MT.RATE_LIMIT, to=self.leader_id, hint=mv))

    def make_install_snapshot_message(self, to: int, m: Message) -> int:
        # reference raft.go:688-698
        m.to = to
        m.type = MT.INSTALL_SNAPSHOT
        snapshot = self.log.snapshot()
        if snapshot.is_empty():
            raise RuntimeError(f"{self.describe()} got an empty snapshot")
        if to in self.witnesses:
            snapshot = make_witness_snapshot(snapshot)
        m.snapshot = snapshot
        return snapshot.index

    def make_replicate_message(
        self, to: int, next_: int, max_size: int
    ) -> Message:
        # raises CompactedError when log is unavailable (then send snapshot)
        term = self.log.term(next_ - 1)
        entries = self.log.entries(next_, max_size)
        if entries:
            last_index = entries[-1].index
            expected = next_ - 1 + len(entries)
            if last_index != expected:
                raise RuntimeError(
                    f"expected last index {expected}, got {last_index}"
                )
        if to in self.witnesses:
            entries = make_metadata_entries(entries)
        return Message(
            to=to,
            type=MT.REPLICATE,
            log_index=next_ - 1,
            log_term=term,
            entries=entries,
            commit=self.log.committed,
        )

    def send_replicate_message(self, to: int) -> None:
        # reference raft.go:760-794
        rp = self.remotes.get(to) or self.observers.get(to) or self.witnesses.get(to)
        if rp is None:
            raise RuntimeError(f"{self.describe()} failed to get remote {to}")
        if rp.is_paused():
            return
        try:
            m = self.make_replicate_message(to, rp.next, Soft.max_entry_size)
        except (CompactedError, UnavailableError):
            # log not available due to compaction, send snapshot
            if not rp.is_active():
                return
            m = Message()
            self.make_install_snapshot_message(to, m)
            rp.become_snapshot(m.snapshot.index)
        else:
            if m.entries:
                rp.progress(m.entries[-1].index)
        self.send(m)

    def broadcast_replicate_message(self) -> None:
        if not self.is_leader():
            raise RuntimeError("non-leader broadcasting replication msg")
        for nid in self.nodes():
            if nid != self.node_id:
                self.send_replicate_message(nid)

    def send_heartbeat_message(self, to: int, hint: SystemCtx, match: int) -> None:
        commit = min(match, self.log.committed)
        self.send(
            Message(
                to=to,
                type=MT.HEARTBEAT,
                commit=commit,
                hint=hint.low,
                hint_high=hint.high,
            )
        )

    def broadcast_heartbeat_message(self) -> None:
        # p72 of the raft thesis: heartbeats carry ReadIndex confirmation hints
        self.must_be_leader()
        if self.read_index.has_pending_request():
            self.broadcast_heartbeat_message_with_hint(self.read_index.peep_ctx())
        else:
            self.broadcast_heartbeat_message_with_hint(SystemCtx())

    def broadcast_heartbeat_message_with_hint(self, ctx: SystemCtx) -> None:
        # sorted iteration for determinism (reference iterates Go maps)
        vm = self.voting_members()
        for nid in sorted(vm):
            if nid != self.node_id:
                self.send_heartbeat_message(nid, ctx, vm[nid].match)
        if self.lease is not None:
            # lease bookkeeping: a quorum of acks to heartbeats SENT at
            # this tick extends the lease to tick + duration (lease.py
            # validity rule; the send tick, not the ack tick, is the
            # conservative basis)
            self.lease.record_send(
                self.tick_count,
                (nid for nid in vm if nid != self.node_id),
            )
        if ctx.is_empty():
            for nid in sorted(self.observers):
                self.send_heartbeat_message(nid, SystemCtx(), self.observers[nid].match)

    def send_timeout_now_message(self, node_id: int) -> None:
        self.send(Message(type=MT.TIMEOUT_NOW, to=node_id))

    # ------------------------------------------------------------------
    # log append and commit — THE NORTH-STAR HOT PATH
    # ------------------------------------------------------------------

    def try_commit(self) -> bool:
        """Commit advancement by quorum match index (reference
        ``raft.go:888-909``).  The batched engine computes the identical
        ``q = kth_largest(match, quorum)`` reduction for all groups at once
        (see ``ops/kernels.py:commit_quorum``)."""
        self.must_be_leader()
        if self.num_voting_members() != len(self.matched):
            self.reset_match_value_array()
        idx = 0
        for nid in sorted(self.remotes):
            self.matched[idx] = self.remotes[nid].match
            idx += 1
        for nid in sorted(self.witnesses):
            self.matched[idx] = self.witnesses[nid].match
            idx += 1
        self.matched.sort()
        q = self.matched[self.num_voting_members() - self.quorum()]
        if self.hier is not None:
            return self._hier_try_commit(q)
        # raft paper p8: only entries from the leader's current term are
        # committed by counting replicas
        return self.log.try_commit(q, self.term)

    def _hier_try_commit(self, q_classic: int) -> bool:
        """Sub-quorum commit rule (hier.py module docstring): the
        effective commit candidate is ``max(classic, near-domain
        kth-largest)`` — the near-domain majority can close ahead of the
        far acks, and the classic quorum remains the fallback.  The
        current-term guard stays inside ``log.try_commit`` exactly as on
        the classic path."""
        hier = self.hier
        voters = self.voting_members()
        match_of = {nid: r.match for nid, r in voters.items()}
        q_near = hier.commit_quorum(match_of, voters.keys())
        advanced = self.log.try_commit(max(q_classic, q_near), self.term)
        if advanced:
            self._commit_via_sub = q_near > q_classic
            hier.note_close(via_sub=q_near > q_classic)
            hier.note_far_lag(match_of, voters.keys(), self.log.committed)
        return advanced

    def _note_commit(self) -> None:
        """Commit watermark advanced (replication attribution hook):
        close every covered record against the EXACT voter
        set and quorum the advancing ``try_commit`` counted.  Callers
        invoke this right after a successful commit advancement; the
        device path's twin lives in ``node._apply_offload_effects``.

        Hier: when the advancement closed via the near-domain
        sub-quorum, the attributed quorum position is the sub-quorum
        size — ``times[q-1]`` then lands on the near ack that actually
        closed the commit, so the closer table flips far→near while the
        far peers still fold in as laggards against the full voter set.
        The device path keeps classic attribution (the kernel does not
        report which rule advanced)."""
        ra = self.replattr
        if ra is not None:
            q = self.quorum()
            if self.hier is not None and self._commit_via_sub:
                near = self.hier.near_voters(self.voting_members().keys())
                if near:
                    q = sub_quorum_size(len(near))
            ra.on_commit(
                self.cluster_id, self.log.committed, self.term,
                self.voting_members(), q, self.node_id,
            )

    def append_entries(self, entries: List[Entry]) -> None:
        # reference raft.go:911-922
        last_index = self.log.last_index()
        for i, e in enumerate(entries):
            e.term = self.term
            e.index = last_index + 1 + i
            e._enc = None  # invalidate cached encoding (codec.py)
        self.log.append(entries)
        self.remotes[self.node_id].try_update(self.log.last_index())
        if self.offload is not None:
            self.offload.ack(
                self.cluster_id, self.node_id, self.log.last_index()
            )
            if self.device_kv and self.is_leader():
                # devsm: the reference hands application entries' decoded
                # payloads (its rsm/encoded.py) to the device apply plane
                # here; the port's rsm/ comes with a later slice
                raise NotImplementedError(
                    "device_kv needs the port's rsm/ (ROADMAP A item 4b)"
                )
        elif self.is_single_node_quorum():
            self.try_commit()

    # ------------------------------------------------------------------
    # state transitions
    # ------------------------------------------------------------------

    def become_observer(self, term: int, leader_id: int) -> None:
        if not self.is_observer():
            raise RuntimeError("transitioning to observer from non-observer")
        self.reset(term)
        self.set_leader_id(leader_id)
        if self.offload is not None:
            self.offload.set_follower(self.cluster_id, term)

    def become_witness(self, term: int, leader_id: int) -> None:
        if not self.is_witness():
            raise RuntimeError("transitioning to witness from non-witness")
        self.reset(term)
        self.set_leader_id(leader_id)
        if self.offload is not None:
            self.offload.set_follower(self.cluster_id, term)

    def become_follower(self, term: int, leader_id: int) -> None:
        if self.is_witness():
            raise RuntimeError("transitioning to follower from witness state")
        self.state = RaftState.FOLLOWER
        self.vote_trace.append(("fol", term, leader_id))
        self.reset(term)
        self.set_leader_id(leader_id)
        if self.offload is not None:
            self.offload.set_follower(self.cluster_id, term)

    def become_candidate(self) -> None:
        if self.is_leader():
            raise RuntimeError("transitioning to candidate from leader")
        if self.is_observer():
            raise RuntimeError("observer is becoming candidate")
        if self.is_witness():
            raise RuntimeError("witness is becoming candidate")
        self.state = RaftState.CANDIDATE
        # 2nd paragraph section 5.2 of the raft paper
        self.reset(self.term + 1)
        self.set_leader_id(NO_LEADER)
        self.vote = self.node_id
        if self.offload is not None:
            self.offload.set_candidate(self.cluster_id, self.term)

    def become_leader(self) -> None:
        if not self.is_leader() and not self.is_candidate():
            raise RuntimeError(f"transitioning to leader from {self.state}")
        self.state = RaftState.LEADER
        self.reset(self.term)
        self.set_leader_id(self.node_id)
        self.pre_leader_promotion_handle_config_change()
        # p72 of the raft thesis: commit a noop entry at the start of the term
        self.append_entries([Entry(type=EntryType.APPLICATION, cmd=b"")])
        # O(1) record of the noop's index — the floor below which
        # counting-based commit is forbidden (raft paper p8); consumed by
        # the device-engine row sync instead of a log scan
        self.term_start_index = self.log.last_index()
        if self.offload is not None:
            # term_start = the noop's index: the floor for counting commits
            self.offload.set_leader(
                self.cluster_id,
                self.term,
                self.log.last_index(),
                self.log.last_index(),
            )

    def reset(self, term: int) -> None:
        # reference raft.go:991-1010
        if self.term != term:
            self.term = term
            self.vote = NO_LEADER
        if self.rl.enabled():
            self.rl.reset()
        self.votes = {}
        self.election_tick = 0
        self.heartbeat_tick = 0
        self.set_randomized_election_timeout()
        self.read_index = ReadIndex()
        if self.lease is not None:
            # invalidation matrix: any state transition (term change,
            # promotion, demotion) drops the lease; it re-arms only from
            # post-transition heartbeat acks
            self.lease.reset()
        if self.replattr is not None:
            # same matrix for replication attribution: a transition
            # invalidates the quorum the open commit records were
            # tallied against — drop them, never cross-term attribute
            self.replattr.on_reset(self.cluster_id)
        if self.far_reads is not None:
            # same matrix for the far-read batcher: the leader the
            # in-flight fetch targeted (or the term it was valid in) is
            # gone — every held ctx reports dropped so clients retry
            self.dropped_read_indexes.extend(self.far_reads.invalidate())
        self.clear_pending_config_change()
        self.abort_leader_transfer()
        self.reset_remotes()
        self.reset_observers()
        self.reset_witnesses()
        self.reset_match_value_array()

    def pre_leader_promotion_handle_config_change(self) -> None:
        n = self.get_pending_config_change_count()
        if n > 1:
            raise RuntimeError("multiple uncommitted config change entries")
        elif n == 1:
            self.set_pending_config_change()

    def reset_remotes(self) -> None:
        # raft paper §5.3: leader initializes nextIndex to last+1
        for nid in self.remotes:
            self.remotes[nid] = Remote(next=self.log.last_index() + 1)
            if nid == self.node_id:
                self.remotes[nid].match = self.log.last_index()

    def reset_observers(self) -> None:
        for nid in self.observers:
            self.observers[nid] = Remote(next=self.log.last_index() + 1)
            if nid == self.node_id:
                self.observers[nid].match = self.log.last_index()

    def reset_witnesses(self) -> None:
        for nid in self.witnesses:
            self.witnesses[nid] = Remote(next=self.log.last_index() + 1)
            if nid == self.node_id:
                self.witnesses[nid].match = self.log.last_index()

    # ------------------------------------------------------------------
    # election
    # ------------------------------------------------------------------

    def handle_vote_resp(self, from_: int, rejected: bool) -> int:
        """Vote tally (reference ``raft.go:1062-1080``).  Batched twin:
        ``ops/kernels.py:vote_quorum``."""
        if from_ not in self.votes:
            self.votes[from_] = not rejected
        return sum(1 for v in self.votes.values() if v)

    def campaign(self) -> None:
        # reference raft.go:1082-1117
        self.become_candidate()
        self.vote_trace.append(("camp", self.term))
        term = self.term
        if self.events is not None:
            self.events.campaign_launched(self.cluster_id, self.node_id, term)
        self.handle_vote_resp(self.node_id, False)
        if self.is_single_node_quorum():
            self.become_leader()
            return
        if self.offload is not None:
            self.offload.vote(self.cluster_id, self.node_id, True)
        hint = 0
        if self.is_leader_transfer_target:
            hint = self.node_id
            self.is_leader_transfer_target = False
        for k in sorted(self.voting_members()):
            if k == self.node_id:
                continue
            self.send(
                Message(
                    term=term,
                    to=k,
                    type=MT.REQUEST_VOTE,
                    log_index=self.log.last_index(),
                    log_term=self.log.last_term(),
                    hint=hint,
                )
            )

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def self_removed(self) -> bool:
        if self.is_observer():
            return self.node_id not in self.observers
        if self.is_witness():
            return self.node_id not in self.witnesses
        return self.node_id not in self.remotes

    def add_node(self, node_id: int) -> None:
        # reference raft.go:1131-1153
        self.clear_pending_config_change()
        if node_id == self.node_id and self.is_witness():
            raise RuntimeError(f"{self.describe()} is a witness")
        if node_id in self.remotes:
            return
        if node_id in self.observers:
            # promoting to full member with inherited progress
            rp = self.observers.pop(node_id)
            self.remotes[node_id] = rp
            if node_id == self.node_id:
                self.become_follower(self.term, self.leader_id)
        elif node_id in self.witnesses:
            raise RuntimeError("could not promote witness to full member")
        else:
            self.set_remote(node_id, 0, self.log.last_index() + 1)
        self.lease_membership_changed()
        if self.offload is not None:
            self.offload.membership_changed(self.cluster_id)

    def add_observer(self, node_id: int) -> None:
        self.clear_pending_config_change()
        if node_id == self.node_id and not self.is_observer():
            raise RuntimeError(f"{self.describe()} is not an observer")
        if node_id in self.observers:
            return
        self.set_observer(node_id, 0, self.log.last_index() + 1)
        self.lease_membership_changed()
        if self.offload is not None:
            self.offload.membership_changed(self.cluster_id)

    def add_witness(self, node_id: int) -> None:
        self.clear_pending_config_change()
        if node_id == self.node_id and not self.is_witness():
            raise RuntimeError(f"{self.describe()} is not a witness")
        if node_id in self.witnesses:
            return
        self.set_witness(node_id, 0, self.log.last_index() + 1)
        self.lease_membership_changed()
        if self.offload is not None:
            self.offload.membership_changed(self.cluster_id)

    def remove_node(self, node_id: int) -> None:
        # reference raft.go:1189-1208
        self.remotes.pop(node_id, None)
        self.observers.pop(node_id, None)
        self.witnesses.pop(node_id, None)
        self.clear_pending_config_change()
        if self.node_id == node_id and self.is_leader():
            self.become_follower(self.term, NO_LEADER)
        if self.leader_transfering() and self.leader_transfer_target == node_id:
            self.abort_leader_transfer()
        self.lease_membership_changed()
        if self.offload is not None:
            # quorum may have shrunk: resync the row; the next round
            # recomputes the commit watermark over the new membership
            self.offload.membership_changed(self.cluster_id)
        elif self.is_leader() and self.num_voting_members() > 0:
            if self.try_commit():
                self._note_commit()
                self.broadcast_replicate_message()

    def set_remote(self, node_id: int, match: int, next_: int) -> None:
        self.remotes[node_id] = Remote(next=next_, match=match)

    def set_observer(self, node_id: int, match: int, next_: int) -> None:
        self.observers[node_id] = Remote(next=next_, match=match)

    def set_witness(self, node_id: int, match: int, next_: int) -> None:
        self.witnesses[node_id] = Remote(next=next_, match=match)

    def set_pending_config_change(self) -> None:
        self.pending_config_change = True

    def has_pending_config_change(self) -> bool:
        return self.pending_config_change

    def clear_pending_config_change(self) -> None:
        self.pending_config_change = False

    def get_pending_config_change_count(self) -> int:
        # reference raft.go:1373-1387
        idx = self.log.committed + 1
        count = 0
        while True:
            ents = self.log.entries(idx, Soft.max_entry_size)
            if not ents:
                return count
            count += count_config_change(ents)
            idx = ents[-1].index + 1

    def has_config_change_to_apply(self) -> bool:
        # test-only hook eases conformance test porting (reference :1463-1469)
        if self.has_not_applied_config_change is not None:
            return self.has_not_applied_config_change()
        return self.log.committed > self.get_applied()

    # ------------------------------------------------------------------
    # shared message handlers
    # ------------------------------------------------------------------

    def can_grant_vote(self, m: Message) -> bool:
        return self.vote in (NO_NODE, m.from_) or m.term > self.term

    def handle_heartbeat_message(self, m: Message) -> None:
        self.log.commit_to(m.commit)
        self.send(
            Message(
                to=m.from_,
                type=MT.HEARTBEAT_RESP,
                hint=m.hint,
                hint_high=m.hint_high,
            )
        )

    def handle_install_snapshot_message(self, m: Message) -> None:
        # reference raft.go:1396-1424
        resp = Message(to=m.from_, type=MT.REPLICATE_RESP)
        if self.restore(m.snapshot):
            resp.log_index = self.log.last_index()
        else:
            resp.log_index = self.log.committed
            if self.events is not None:
                self.events.snapshot_rejected(
                    self.cluster_id,
                    self.node_id,
                    m.snapshot.index,
                    m.snapshot.term,
                    m.from_,
                )
        self.send(resp)

    def handle_replicate_message(self, m: Message) -> None:
        # reference raft.go:1426-1450
        resp = Message(to=m.from_, type=MT.REPLICATE_RESP)
        # replication tracing: a sampled REPLICATE's context
        # flows onto the ack so the leader sees the follower's stamps;
        # the fsync/ack-send stamps land later on the runtime's
        # post-persist send path (node.process_raft_update)
        ctx = m.trace
        if ctx is not None:
            resp.trace = ctx
        if m.log_index < self.log.committed:
            resp.log_index = self.log.committed
            self.send(resp)
            return
        if self.log.match_term(m.log_index, m.log_term):
            self.log.try_append(m.log_index, m.entries)
            if ctx is not None:
                ctx.t_append = _time.time()
            last_idx = m.log_index + len(m.entries)
            self.log.commit_to(min(last_idx, m.commit))
            resp.log_index = last_idx
        else:
            resp.reject = True
            resp.log_index = m.log_index
            resp.hint = self.log.last_index()
            if self.events is not None:
                self.events.replication_rejected(
                    self.cluster_id, self.node_id, m.log_index, m.log_term, m.from_
                )
        self.send(resp)

    # ------------------------------------------------------------------
    # term filtering + dispatch
    # ------------------------------------------------------------------

    def drop_request_vote_from_high_term_node(self, m: Message) -> bool:
        # reference raft.go:1273-1295
        if m.type != MT.REQUEST_VOTE or not self.check_quorum or m.term <= self.term:
            return False
        # p42 of the raft thesis: leader-transfer RequestVote must not be dropped
        if m.hint == m.from_:
            return False
        if (
            self.is_leader()
            and not self.quiesce
            and self.election_tick >= self.election_timeout
        ):
            raise RuntimeError("election_tick >= election_timeout on leader")
        # last paragraph of section 6 of the raft paper: drop RequestVote from
        # partitioned nodes when we recently heard from a quorum-backed leader
        if self.leader_id != NO_LEADER and self.election_tick < self.election_timeout:
            return True
        return False

    def on_message_term_not_matched(self, m: Message) -> bool:
        # reference raft.go:1300-1339
        if m.term == 0 or m.term == self.term:
            return False
        if self.drop_request_vote_from_high_term_node(m):
            return True
        if m.term > self.term:
            leader_id = NO_LEADER
            if is_leader_message(m.type):
                leader_id = m.from_
            # Stash the elapsed election clock across the step-down: if
            # this REQUEST_VOTE turns out to come from a log-behind
            # candidate, handle_node_request_vote restores the clock (see
            # there).  Everything else keeps etcd's full reset+resample.
            self._stepdown_etick = (
                self.election_tick if m.type == MT.REQUEST_VOTE else None
            )
            if self.is_observer():
                self.become_observer(m.term, leader_id)
            elif self.is_witness():
                self.become_witness(m.term, leader_id)
            else:
                self.become_follower(m.term, leader_id)
        elif m.term < self.term:
            if is_leader_message(m.type) and self.check_quorum:
                # etcd TestFreeStuckCandidateWithCheckQuorum corner case
                self.send(Message(to=m.from_, type=MT.NOOP))
            return True
        return False

    def double_check_term_matched(self, msg_term: int) -> None:
        if msg_term != 0 and self.term != msg_term:
            raise RuntimeError(f"{self.describe()} mismatched term found")

    def handle(self, m: Message) -> None:
        """Main entry: term-filter then dispatch (reference ``Handle``
        ``raft.go:1454-1461``)."""
        self._stepdown_etick = None
        if not self.on_message_term_not_matched(m):
            self.double_check_term_matched(m.term)
            handler = _HANDLERS[self.state].get(m.type)
            if handler is not None:
                handler(self, m)

    Handle = handle  # reference-style alias

    # ------------------------------------------------------------------
    # handlers for nodes in any state
    # ------------------------------------------------------------------

    def handle_node_election(self, m: Message) -> None:
        # reference raft.go:1485-1515
        if not self.is_leader():
            # ignore Election when a config change is committed but not applied:
            # campaigning then could form a quorum that does not overlap with
            # the committed-config quorum (see reference comment)
            if self.has_config_change_to_apply():
                if self.events is not None:
                    self.events.campaign_skipped(
                        self.cluster_id, self.node_id, self.term
                    )
                return
            self.campaign()

    def handle_node_request_vote(self, m: Message) -> None:
        # reference raft.go:1517-1539
        resp = Message(to=m.from_, type=MT.REQUEST_VOTE_RESP)
        can_grant = self.can_grant_vote(m)
        is_up_to_date = self.log.up_to_date(m.log_index, m.log_term)
        self.vote_trace.append(
            ("rv", m.from_, m.term, can_grant, is_up_to_date)
        )
        if can_grant and is_up_to_date:
            self.election_tick = 0
            self.vote = m.from_
        else:
            resp.reject = True
            if not is_up_to_date and self._stepdown_etick is not None:
                # Liveness at scale: a log-behind candidate can never win
                # (§5.4.1) yet re-campaigns every timeout, and if each
                # doomed campaign zeroed its healthy peers' clocks (term
                # bump → become_follower → reset) the replica that COULD
                # win fires first only with p≈1/n per cycle — measured as
                # 11/4,096 groups wedged 200s+.  Restore the elapsed
                # clock for exactly this case; healthy collisions (vote
                # already spent) keep the full reset+resample, which is
                # what desynchronizes colliding candidates.  Safety never
                # depends on clock resets — this is PreVote's protection
                # folded into the clock instead of a new RPC round.
                self.election_tick = min(
                    self._stepdown_etick, self.randomized_election_timeout
                )
        self._stepdown_etick = None
        self.send(resp)

    def handle_node_config_change(self, m: Message) -> None:
        # reference raft.go:1541-1560
        if m.reject:
            self.clear_pending_config_change()
        else:
            cctype = ConfigChangeType(m.hint_high)
            node_id = m.hint
            if cctype == ConfigChangeType.ADD_NODE:
                self.add_node(node_id)
            elif cctype == ConfigChangeType.REMOVE_NODE:
                self.remove_node(node_id)
            elif cctype == ConfigChangeType.ADD_OBSERVER:
                self.add_observer(node_id)
            elif cctype == ConfigChangeType.ADD_WITNESS:
                self.add_witness(node_id)
            else:
                raise RuntimeError("unexpected config change type")

    def handle_local_tick(self, m: Message) -> None:
        if m.reject:
            self.quiesced_tick()
        else:
            self.tick()

    def handle_restore_remote(self, m: Message) -> None:
        self.restore_remotes(m.snapshot)

    # ------------------------------------------------------------------
    # leader handlers
    # ------------------------------------------------------------------

    def handle_leader_heartbeat(self, m: Message) -> None:
        self.broadcast_heartbeat_message()

    def handle_leader_check_quorum(self, m: Message) -> None:
        # p69 of the raft thesis
        self.must_be_leader()
        if not self.leader_has_quorum():
            self.become_follower(self.term, NO_LEADER)

    def handle_leader_propose(self, m: Message) -> None:
        # reference raft.go:1590-1611
        self.must_be_leader()
        if self.leader_transfering():
            self.report_dropped_proposal(m)
            return
        for i, e in enumerate(m.entries):
            if e.type == EntryType.CONFIG_CHANGE:
                if self.has_pending_config_change():
                    self.report_dropped_config_change(m.entries[i])
                    m.entries[i] = Entry(type=EntryType.APPLICATION)
                self.set_pending_config_change()
        self.append_entries(m.entries)
        self.broadcast_replicate_message()

    def has_committed_entry_at_current_term(self) -> bool:
        # p72 of the raft thesis
        if self.term == 0:
            raise RuntimeError("not supposed to reach here")
        try:
            last_committed_term = self.log.term(self.log.committed)
        except CompactedError:
            return False
        return last_committed_term == self.term

    def clear_ready_to_read(self) -> None:
        self.ready_to_read = []

    def add_ready_to_read(
        self, index: int, ctx: SystemCtx, lease: bool = False
    ) -> None:
        self.ready_to_read.append(
            ReadyToRead(index=index, system_ctx=ctx, lease=lease)
        )

    def try_lease_read(self, m: Message, ctx: SystemCtx) -> bool:
        """Serve a linearizable read locally under a valid leader lease
        (thesis §6.4.1) — ZERO confirmation rounds.

        Preconditions already held by the caller: leader, multi-node
        quorum, committed entry at the current term.  A valid lease means
        a quorum acked heartbeats within the last ``duration`` ticks, so
        no other leader can have been elected (CheckQuorum's §6 vote
        lease protects the bound even against forced campaigns; leader
        transfer — which bypasses it via TIMEOUT_NOW — ceded the lease
        first).  Serving at ``log.committed`` and routing exactly like a
        confirmed release keeps released indices identical to the
        ReadIndex path (differential: tests/test_lease.py)."""
        lease = self.lease
        remaining = lease.check(
            self.tick_count, self.quorum(),
            self.voting_members(), self.node_id,
        )
        if remaining <= 0:
            lease.note_read_fallback()
            return False
        lease.note_read_local(remaining)
        # same routing as apply_read_releases on a confirmed ctx
        if m.from_ == NO_NODE or m.from_ == self.node_id:
            self.add_ready_to_read(self.log.committed, ctx, lease=True)
        else:
            self.send(
                Message(
                    to=m.from_,
                    type=MT.READ_INDEX_RESP,
                    log_index=self.log.committed,
                    hint=ctx.low,
                    hint_high=ctx.high,
                )
            )
        return True

    def handle_leader_read_index(self, m: Message) -> None:
        # section 6.4 of the raft thesis (reference raft.go:1636-1669)
        self.must_be_leader()
        ctx = SystemCtx(low=m.hint, high=m.hint_high)
        if m.from_ in self.witnesses:
            pass  # witness cannot read
        elif not self.is_single_node_quorum():
            if not self.has_committed_entry_at_current_term():
                # thesis §6.4 step 1: leader must have committed in this term
                self.report_dropped_read_index(m)
                return
            if self.lease is not None and self.try_lease_read(m, ctx):
                # lease-served: no pending entry, no hint broadcast, no
                # device read-plane staging — the short path ends here
                return
            self.read_index.add_request(self.log.committed, ctx, m.from_)
            if self.offload is not None and self.device_reads:
                # device read plane: the echo-quorum counting for this ctx
                # runs in the engine's per-round fused dispatch; the local
                # pending entry above still drives hint rebroadcast and
                # the prefix release when the coordinator confirms
                self.offload.read_stage(
                    self.cluster_id, self.log.committed, ctx.low, ctx.high,
                    self.term,
                )
            self.broadcast_heartbeat_message_with_hint(ctx)
        else:
            self.add_ready_to_read(self.log.committed, ctx)
            if m.from_ != self.node_id and m.from_ in self.observers:
                self.send(
                    Message(
                        to=m.from_,
                        type=MT.READ_INDEX_RESP,
                        log_index=self.log.committed,
                        hint=m.hint,
                        hint_high=m.hint_high,
                        commit=m.commit,
                    )
                )

    def handle_leader_replicate_resp(self, m: Message, rp: Remote) -> None:
        # reference raft.go:1671-1700
        self.must_be_leader()
        rp.set_active()
        if not m.reject:
            paused = rp.is_paused()
            if rp.try_update(m.log_index):
                rp.responded_to()
                if self.replattr is not None:
                    # fold the ack (and its follower stage stamps) into
                    # the open commit records BEFORE the commit
                    # advancement below may close them
                    self.replattr.on_ack(
                        self.cluster_id, m.from_, rp.match, self.term,
                        m.trace,
                    )
                if self.offload is not None:
                    # north-star hot path: the quorum reduction runs on
                    # device over all groups; commit lands via
                    # node.offload_commit with the term guard re-applied
                    self.offload.ack(self.cluster_id, m.from_, rp.match)
                    if paused:
                        self.send_replicate_message(m.from_)
                elif self.try_commit():
                    self._note_commit()
                    self.broadcast_replicate_message()
                elif paused:
                    self.send_replicate_message(m.from_)
                # leadership transfer protocol, p29 of the raft thesis
                if (
                    self.leader_transfering()
                    and m.from_ == self.leader_transfer_target
                    and self.log.last_index() == rp.match
                ):
                    self.send_timeout_now_message(self.leader_transfer_target)
        else:
            # etcd-style conservative flow control: reset next to match+1
            if rp.decrease_to(m.log_index, m.hint):
                self.enter_retry_state(rp)
                self.send_replicate_message(m.from_)

    def handle_leader_heartbeat_resp(self, m: Message, rp: Remote) -> None:
        # reference raft.go:1702-1714
        self.must_be_leader()
        rp.set_active()
        if self.lease is not None and (
            m.from_ in self.remotes or m.from_ in self.witnesses
        ):
            # voting members only: an observer ack extends no quorum
            self.lease.record_ack(m.from_, self.tick_count)
        if self.offload is not None and self.device_ticks:
            # device check-quorum tallies activity bits per row (its only
            # consumer is the device-tick demote flag, so scalar-tick
            # groups must not pay a dispatch per heartbeat for it)
            self.offload.heartbeat_resp(self.cluster_id, m.from_)
        rp.wait_to_retry()
        if rp.match < self.log.last_index():
            self.send_replicate_message(m.from_)
        if m.hint != 0:
            if self.offload is not None and self.device_reads:
                # batched per coordinator round: the echo joins the
                # group's pending-read slot and the device's masked
                # row-sum decides the quorum (ctxs the coordinator is
                # not tracking — slot overflow, stale echoes — fall
                # back to the scalar tally below via the node)
                self.offload.read_ack_hint(
                    self.cluster_id, m.from_, m.hint, m.hint_high
                )
            else:
                self.handle_read_index_leader_confirmation(m)

    def handle_leader_transfer(self, m: Message, rp: Remote) -> None:
        # reference raft.go:1716-1738
        self.must_be_leader()
        target = m.hint
        if target == NO_NODE:
            raise RuntimeError("leader transfer target not set")
        if self.leader_transfering():
            return
        if self.node_id == target:
            return
        self.leader_transfer_target = target
        self.election_tick = 0
        if self.lease is not None:
            # the lease must be explicitly ceded BEFORE the transfer can
            # complete: TIMEOUT_NOW lets the target campaign without
            # waiting out the election timeout, voiding the clock bound.
            # Ceding here (at target-set time) strictly precedes every
            # send_timeout_now_message path.  Sticky until the next term:
            # even an aborted transfer may have delivered TIMEOUT_NOW.
            self.lease.cede()
        # fast path if the target is already caught up (p29, raft thesis)
        if rp.match == self.log.last_index():
            self.send_timeout_now_message(target)

    def handle_read_index_leader_confirmation(self, m: Message) -> None:
        # reference raft.go:1740-1760
        ctx = SystemCtx(low=m.hint, high=m.hint_high)
        ris = self.read_index.confirm(ctx, m.from_, self.quorum())
        self.apply_read_releases(ris, ctx)

    def apply_read_releases(self, ris, ctx: SystemCtx) -> None:
        """Route released ReadStatuses: local requesters land in
        ``ready_to_read``, remote ones get a READ_INDEX_RESP carrying the
        CONFIRMED ctx (reference raft.go:1740-1760 echoes ``m.Hint``, not
        the released request's own ctx).  Shared by the scalar confirm
        above and the device read plane's confirmed egress
        (``node._apply_offload_effects``) — both release through
        ``read_index``, so routing and indices are identical."""
        for s in ris:
            if s.from_ == NO_NODE or s.from_ == self.node_id:
                self.add_ready_to_read(s.index, s.ctx)
            else:
                self.send(
                    Message(
                        to=s.from_,
                        type=MT.READ_INDEX_RESP,
                        log_index=s.index,
                        hint=ctx.low,
                        hint_high=ctx.high,
                    )
                )

    def handle_leader_snapshot_status(self, m: Message, rp: Remote) -> None:
        # reference raft.go:1762-1775
        if rp.state != rp.state.SNAPSHOT:
            return
        if m.reject:
            rp.clear_pending_snapshot()
        rp.become_wait()

    def handle_leader_unreachable(self, m: Message, rp: Remote) -> None:
        self.enter_retry_state(rp)

    def handle_leader_rate_limit(self, m: Message) -> None:
        if self.rl.enabled():
            self.rl.set_follower_state(m.from_, m.hint)

    def enter_retry_state(self, rp: Remote) -> None:
        if rp.state == rp.state.REPLICATE:
            rp.become_retry()

    def _get_remote_for_leader_message(self, m: Message) -> Optional[Remote]:
        return (
            self.remotes.get(m.from_)
            or self.observers.get(m.from_)
            or self.witnesses.get(m.from_)
        )

    # ------------------------------------------------------------------
    # follower/observer/witness handlers
    # ------------------------------------------------------------------

    def handle_follower_propose(self, m: Message) -> None:
        if self.leader_id == NO_LEADER:
            self.report_dropped_proposal(m)
            return
        m.to = self.leader_id
        m.entries = [e.clone() for e in m.entries]
        self.send(m)

    def leader_is_available(self) -> None:
        self.election_tick = 0
        if self.offload is not None and self.device_ticks:
            # reset the device row's election clock too, or the tick
            # kernel would campaign against a healthy leader
            self.offload.leader_contact(self.cluster_id)

    def handle_follower_replicate(self, m: Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_replicate_message(m)

    def handle_follower_heartbeat(self, m: Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_heartbeat_message(m)

    def handle_follower_read_index(self, m: Message) -> None:
        if self.leader_id == NO_LEADER:
            self.report_dropped_read_index(m)
            return
        if (
            self.far_reads is not None
            and self.hier is not None
            and self.hier.is_far_follower(self.leader_id)
        ):
            # far-read batching (hier.py FarReadBatcher): at most one
            # cross-domain fetch in flight; a read arriving mid-flight
            # holds for the NEXT fetch (it may only ride a fetch
            # initiated after it arrived) and the whole batch releases
            # at that fetch's returned index
            ctx = SystemCtx(low=m.hint, high=m.hint_high)
            if not self.far_reads.admit(ctx):
                if self.hier.obs is not None:
                    self.hier.obs.read_coalesced()
                return
            if self.hier.obs is not None:
                self.hier.obs.read_batch()
        m.to = self.leader_id
        self.send(m)

    def handle_follower_leader_transfer(self, m: Message) -> None:
        if self.leader_id == NO_LEADER:
            return
        m.to = self.leader_id
        self.send(m)

    def handle_follower_read_index_resp(self, m: Message) -> None:
        ctx = SystemCtx(low=m.hint, high=m.hint_high)
        self.leader_is_available()
        self.set_leader_id(m.from_)
        if self.far_reads is not None and self.far_reads.pending:
            # release the whole fetch batch at the returned index (every
            # member arrived before the fetch was initiated, so the
            # leader's commit point at fetch time linearizes them all),
            # then forward the next batch's representative
            released, nxt = self.far_reads.on_resp(ctx)
            for c in released:
                self.add_ready_to_read(m.log_index, c)
            if nxt is not None:
                self.send(
                    Message(
                        type=MT.READ_INDEX,
                        to=self.leader_id,
                        hint=nxt.low,
                        hint_high=nxt.high,
                    )
                )
            return
        self.add_ready_to_read(m.log_index, ctx)

    def handle_follower_install_snapshot(self, m: Message) -> None:
        self.leader_is_available()
        self.set_leader_id(m.from_)
        self.handle_install_snapshot_message(m)

    def handle_follower_timeout_now(self, m: Message) -> None:
        # p29 of the raft thesis: equivalent to the clock jumping forward
        self.election_tick = self.randomized_election_timeout
        self.is_leader_transfer_target = True
        if self.device_ticks:
            # the tick fire site is device-owned; a leadership transfer is
            # an explicit request, so campaign immediately with the
            # transfer-target privileges intact
            self.election_tick = 0
            self.handle(Message(from_=self.node_id, type=MT.ELECTION))
        else:
            self.tick()
        if self.is_leader_transfer_target:
            self.is_leader_transfer_target = False

    # ------------------------------------------------------------------
    # candidate handlers
    # ------------------------------------------------------------------

    def handle_candidate_propose(self, m: Message) -> None:
        self.report_dropped_proposal(m)

    def handle_candidate_read_index(self, m: Message) -> None:
        self.report_dropped_read_index(m)

    # receiving Replicate/InstallSnapshot/Heartbeat at equal term implies a
    # leader exists for this term (raft paper §5.2 4th paragraph)
    def handle_candidate_replicate(self, m: Message) -> None:
        self.become_follower(self.term, m.from_)
        self.handle_replicate_message(m)

    def handle_candidate_install_snapshot(self, m: Message) -> None:
        self.become_follower(self.term, m.from_)
        self.handle_install_snapshot_message(m)

    def handle_candidate_heartbeat(self, m: Message) -> None:
        self.become_follower(self.term, m.from_)
        self.handle_heartbeat_message(m)

    def handle_candidate_request_vote_resp(self, m: Message) -> None:
        # reference raft.go:1965-1984
        if m.from_ in self.observers:
            return
        self.vote_trace.append(("rvr", m.from_, m.term, m.reject))
        count = self.handle_vote_resp(m.from_, m.reject)
        if self.offload is not None:
            # the device tallies; won/lost lands via node.offload_election
            self.offload.vote(self.cluster_id, m.from_, not m.reject)
            return
        if self.hier is not None:
            # hier vote rule (hier.py): quorum alone is not enough — the
            # granted set must also intersect every eligible domain's
            # possible sub-quorums.  `>=` instead of the classic `==`:
            # the tally can sit AT quorum while the intersection bound
            # waits on a later grant, so every resp must re-test.
            if count >= self.quorum() and self.hier_election_ok():
                self.become_leader()
                self.broadcast_replicate_message()
            elif count >= self.quorum():
                self.hier.note_election_hold()
            elif len(self.votes) - count == self.quorum():
                self.become_follower(self.term, NO_LEADER)
            return
        # 3rd paragraph section 5.2 of the raft paper
        if count == self.quorum():
            self.become_leader()
            self.broadcast_replicate_message()
        elif len(self.votes) - count == self.quorum():
            # etcd raft behavior, not in the raft paper
            self.become_follower(self.term, NO_LEADER)

    def hier_election_ok(self) -> bool:
        """True when the hier vote-intersection rule admits taking
        office with the current ``votes`` tally (trivially True with the
        plane off — the device offload path calls this before applying a
        `won` flag, hier-agnostic)."""
        if self.hier is None:
            return True
        return self.hier.election_ok(self.votes, self.voting_members())

    # ------------------------------------------------------------------
    # dropped request reporting
    # ------------------------------------------------------------------

    def report_dropped_config_change(self, e: Entry) -> None:
        self.dropped_entries.append(e)

    def report_dropped_proposal(self, m: Message) -> None:
        self.dropped_entries.extend(e.clone() for e in m.entries)
        if self.events is not None:
            self.events.proposal_dropped(
                self.cluster_id, self.node_id, m.entries
            )

    def report_dropped_read_index(self, m: Message) -> None:
        # record the ctx so the runtime can fail the pending read instead of
        # letting it sit until timeout (reference reportDroppedReadIndex)
        self.dropped_read_indexes.append(SystemCtx(low=m.hint, high=m.hint_high))
        if self.events is not None:
            self.events.read_index_dropped(self.cluster_id, self.node_id)


# ---------------------------------------------------------------------------
# handler table (reference initializeHandlerMap raft.go:2041-2102)
# ---------------------------------------------------------------------------

def _leader_msg_with_remote(f):
    def wrapper(r: Raft, m: Message) -> None:
        rp = r._get_remote_for_leader_message(m)
        if rp is None:
            return  # message from removed node
        f(r, m, rp)

    return wrapper


_COMMON = {
    MT.ELECTION: Raft.handle_node_election,
    MT.REQUEST_VOTE: Raft.handle_node_request_vote,
    MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
    MT.LOCAL_TICK: Raft.handle_local_tick,
    MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
}

_HANDLERS: List[Dict[MessageType, Callable[[Raft, Message], None]]] = [
    {} for _ in range(NUM_STATES)
]

_HANDLERS[RaftState.FOLLOWER] = {
    **_COMMON,
    MT.PROPOSE: Raft.handle_follower_propose,
    MT.REPLICATE: Raft.handle_follower_replicate,
    MT.HEARTBEAT: Raft.handle_follower_heartbeat,
    MT.READ_INDEX: Raft.handle_follower_read_index,
    MT.LEADER_TRANSFER: Raft.handle_follower_leader_transfer,
    MT.READ_INDEX_RESP: Raft.handle_follower_read_index_resp,
    MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
    MT.TIMEOUT_NOW: Raft.handle_follower_timeout_now,
}

_HANDLERS[RaftState.CANDIDATE] = {
    **_COMMON,
    MT.PROPOSE: Raft.handle_candidate_propose,
    MT.READ_INDEX: Raft.handle_candidate_read_index,
    MT.REPLICATE: Raft.handle_candidate_replicate,
    MT.INSTALL_SNAPSHOT: Raft.handle_candidate_install_snapshot,
    MT.HEARTBEAT: Raft.handle_candidate_heartbeat,
    MT.REQUEST_VOTE_RESP: Raft.handle_candidate_request_vote_resp,
}

_HANDLERS[RaftState.LEADER] = {
    **_COMMON,
    MT.LEADER_HEARTBEAT: Raft.handle_leader_heartbeat,
    MT.CHECK_QUORUM: Raft.handle_leader_check_quorum,
    MT.PROPOSE: Raft.handle_leader_propose,
    MT.READ_INDEX: Raft.handle_leader_read_index,
    MT.REPLICATE_RESP: _leader_msg_with_remote(Raft.handle_leader_replicate_resp),
    MT.HEARTBEAT_RESP: _leader_msg_with_remote(Raft.handle_leader_heartbeat_resp),
    MT.SNAPSHOT_STATUS: _leader_msg_with_remote(Raft.handle_leader_snapshot_status),
    MT.UNREACHABLE: _leader_msg_with_remote(Raft.handle_leader_unreachable),
    MT.LEADER_TRANSFER: _leader_msg_with_remote(Raft.handle_leader_transfer),
    MT.RATE_LIMIT: Raft.handle_leader_rate_limit,
}

_HANDLERS[RaftState.OBSERVER] = {
    MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
    MT.LOCAL_TICK: Raft.handle_local_tick,
    MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
    MT.PROPOSE: Raft.handle_follower_propose,
    MT.REPLICATE: Raft.handle_follower_replicate,
    MT.HEARTBEAT: Raft.handle_follower_heartbeat,
    MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
    MT.READ_INDEX: Raft.handle_follower_read_index,
    MT.READ_INDEX_RESP: Raft.handle_follower_read_index_resp,
}

_HANDLERS[RaftState.WITNESS] = {
    MT.CONFIG_CHANGE_EVENT: Raft.handle_node_config_change,
    MT.LOCAL_TICK: Raft.handle_local_tick,
    MT.SNAPSHOT_RECEIVED: Raft.handle_restore_remote,
    MT.REQUEST_VOTE: Raft.handle_node_request_vote,
    MT.REPLICATE: Raft.handle_follower_replicate,
    MT.HEARTBEAT: Raft.handle_follower_heartbeat,
    MT.INSTALL_SNAPSHOT: Raft.handle_follower_install_snapshot,
}
