"""Leader-lease read plane: clock-bound local reads.

Counterpart: ``dragonboat_tpu/lease.py``, copied (standard library only).

The ReadIndex protocol (thesis §6.4, ``raft/readindex.py``) makes every
linearizable read pay one heartbeat-echo confirmation round; on the device
read plane that round additionally rides the write-round gate.  A
**leader lease** removes the round entirely: a leader that heard
heartbeat acks from a quorum within the last ``election_timeout −
drift_epsilon`` ticks knows no other leader
can exist yet — §6.4.1 of the raft thesis, plus the §6 CheckQuorum vote
lease that makes the bound hold even against forced campaigns — so it may
serve reads at its committed watermark locally, with the ReadIndex plane as
the always-correct fallback.

Validity rule (tick-based — ticks are the protocol's native clock, shared
with the election/heartbeat timers the bound is measured against):

- every heartbeat broadcast records its send tick per voting peer (a
  bounded FIFO; a send it cannot record is *counted*, and that many
  later acks attribute nothing — never a newer send's tick, see
  ``PENDING_CAP`` — so attribution can only go conservative);
- every heartbeat ack pops the oldest recorded send tick for that peer
  and makes it the peer's **ack basis** (acks confirm the peer's election
  clock was reset no earlier than the send instant, never later);
- the lease basis is the quorum-th newest ack basis over the voting
  members (self counts at the current tick) — the same ``kth_largest``
  reduction ``try_commit``/``commit_quorum`` run over match indexes;
- the lease is valid while ``now < basis + election_timeout − epsilon``,
  where ``epsilon`` (default ``election_timeout // 5``, min 1) absorbs
  tick-delivery jitter and cross-host tick-cadence drift.

Invalidation matrix (all enforced in ``raft/raft.py``):

==================  =====================================================
event               effect
==================  =====================================================
expiry              ``valid()`` turns False; reads fall back to ReadIndex
term change         ``Raft.reset`` → :meth:`LeaderLease.reset`
leadership xfer     :meth:`cede` the moment the transfer target is set —
                    the target campaigns WITHOUT waiting out the election
                    timeout (TIMEOUT_NOW), so the clock bound is void;
                    sticky until the next term (an aborted transfer may
                    already have delivered TIMEOUT_NOW)
membership change   add/remove node/witness/observer, snapshot-restored
                    membership → :meth:`reset` (quorum size moved; re-arm
                    from fresh acks against the new membership)
==================  =====================================================

Interaction with ``device_ticks``: on
device-ticked groups the scalar clock advances lazily at step time
(``node._catch_up_ticks``), but every read reaches
``handle_leader_read_index`` through a step that catches the clock up
first, so ``valid()`` always compares a current tick count.  The catch-up
cap (``max(4 * election_rtt, 16)`` ticks) is ≥ 4 lease durations, so a
stall long enough for the cap to swallow ticks has long since expired the
lease it could otherwise overextend.  ``Config.validate`` rejects
``read_lease`` with ``quiesce`` (a quiesced leader's tick counter freezes
while its followers' election clocks keep running).

The :class:`LeaseTable` is the batched device-plane variant: the quorum
coordinator tallies the heartbeat-ack ops it is already draining into the
engine and keeps an advisory per-group validity deadline — obs/bench
introspection over thousands of groups without touching any raftMu.  The
*serving* authority is always the scalar :class:`LeaderLease` (its
send-tick attribution is strictly conservative; the table's drain-tick
attribution is not).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Iterable, Optional

_L = "dragonboat_lease_"

#: remaining-validity histogram buckets (ticks): a healthy lease sits in
#: the top buckets; reads served just before expiry land at the bottom
VALIDITY_BUCKETS_TICKS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

_HELP = {
    _L + "grants_total": "lease transitions invalid-to-valid",
    _L + "expiries_total": "lease transitions valid-to-invalid",
    _L + "ceded_total": "leases ceded for leadership transfer",
    _L + "reads_local_total": "linearizable reads served under the lease",
    _L + "reads_fallback_total": "reads routed to the ReadIndex fallback",
    _L + "remaining_validity_ticks": "lease ticks left when a read was served",
    _L + "groups_held": "groups the coordinator lease table sees as held",
}


def describe_families(registry) -> None:
    """Register the ``# HELP`` texts for every ``dragonboat_lease_*``
    family (test_events round-trip contract: one HELP per TYPE)."""
    for name, text in _HELP.items():
        registry.describe(name, text)


class LeaseObs:
    """Registry-backed lease instruments, shared by every lease-enabled
    group on one NodeHost.  Attached only when ``enable_metrics`` is on;
    the raft hooks gate on ``obs is not None`` (the PR-5 latch precedent),
    so metrics-off hosts never touch the registry."""

    __slots__ = ("registry",)

    def __init__(self, registry):
        self.registry = registry
        describe_families(registry)
        for name in ("grants_total", "expiries_total", "ceded_total",
                     "reads_local_total", "reads_fallback_total"):
            registry.counter_add(_L + name, 0)
        registry.histogram_declare(
            _L + "remaining_validity_ticks", buckets=VALIDITY_BUCKETS_TICKS
        )

    def grant(self) -> None:
        self.registry.counter_add(_L + "grants_total")

    def expire(self) -> None:
        self.registry.counter_add(_L + "expiries_total")

    def cede(self) -> None:
        self.registry.counter_add(_L + "ceded_total")

    def read_local(self, remaining_ticks: int) -> None:
        self.registry.counter_add(_L + "reads_local_total")
        self.registry.histogram_observe(
            _L + "remaining_validity_ticks", float(remaining_ticks)
        )

    def read_fallback(self) -> None:
        self.registry.counter_add(_L + "reads_fallback_total")


class LeaderLease:
    """One raft group's lease state (leader side).

    All methods run under the owning node's raftMu (they are called from
    raft handlers only), so there is no internal locking.  Plain int
    counters (``reads_local`` etc.) are always maintained — tests and the
    bench read them without the metrics plumbing; :class:`LeaseObs`
    mirrors them into the registry when attached.
    """

    #: per-peer bound on DISTINCT TICKS of recorded-but-unacked
    #: heartbeat sends.  Attribution is tick-granular, so all sends a
    #: peer gets within one tick share one FIFO entry carrying a count
    #: (ReadIndex fallback load broadcasts a hint heartbeat per ctx —
    #: per-SEND capacity would overflow under exactly that load and
    #: freeze the bases, review-caught); the in-flight window in ticks
    #: is bounded by the link RTT, so 16 covers any RTT the lease is
    #: usable at (RTT ≥ the election timeout makes it moot).  A send
    #: that still cannot be recorded is COUNTED (``_unrecorded``) and
    #: that many later acks attribute NOTHING instead of popping an
    #: entry recorded after the refused send (which would inflate the
    #: basis — the optimistic direction the whole scheme exists to
    #: exclude).  Requires per-peer in-order delivery of heartbeats and
    #: acks, which the per-remote FIFO send queues of both wire modules
    #: provide; with message LOSS the FIFO only over-holds old entries,
    #: so attribution can only age.
    PENDING_CAP = 16

    __slots__ = (
        "election_timeout", "epsilon", "duration",
        "_pending", "_unrecorded", "bases", "ceded", "skew", "_held",
        "obs", "grants", "expiries", "reads_local", "reads_fallback",
        "tick_interval_s", "wall_clock", "_ack_walls",
    )

    def __init__(self, election_timeout: int,
                 drift_ticks: Optional[int] = None,
                 tick_interval_s: Optional[float] = None):
        self.election_timeout = election_timeout
        self.epsilon = (
            drift_ticks if drift_ticks is not None
            else max(1, election_timeout // 5)
        )
        self.duration = max(1, election_timeout - self.epsilon)
        # wall-clock guard (caught by a churn soak): the tick clock
        # is the event loop's — a starved or descheduled leader ticks
        # SLOWER than wall time, so its tick-valid lease can outlive the
        # majority's wall-time election and serve a stale read.  With
        # ``tick_interval_s`` set (the host's tick period in seconds),
        # validity additionally requires the quorum-th newest ack to be
        # within ``duration * tick_interval_s`` WALL seconds — monotonic
        # time keeps running while the process is starved or SIGSTOPped,
        # so starvation can only expire the lease, never extend it.
        # Default off: purely tick-driven tests stay deterministic.
        self.tick_interval_s = tick_interval_s
        self.wall_clock = time.monotonic
        self._ack_walls: Dict[int, float] = {}
        self.obs: Optional[LeaseObs] = None
        self.grants = 0
        self.expiries = 0
        self.reads_local = 0
        self.reads_fallback = 0
        self._pending: Dict[int, collections.deque] = {}
        self._unrecorded: Dict[int, int] = {}
        self.bases: Dict[int, int] = {}
        self.ceded = False
        self.skew = 0
        self._held = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Full invalidation: any ``become_*`` transition (term change,
        promotion, demotion).  Clearing the send FIFOs is safe ONLY here:
        acks still in flight from the old term carry the old term and
        are dropped by raft's term filter before ever reaching
        ``record_ack``, so the fresh FIFO stays aligned with the wire."""
        if self._held:
            self._note_expired()
        self._pending = {}
        self._unrecorded = {}
        self.bases = {}
        self._ack_walls = {}
        self.ceded = False
        self.skew = 0

    def membership_changed(self) -> None:
        """Invalidate for a SAME-TERM membership change: drop the bases
        (the quorum they were tallied against no longer exists; the
        lease re-arms from post-change acks) but KEEP the send FIFOs —
        same-term acks still in flight pass raft's term filter, and a
        cleared FIFO would let such a stale ack pop a post-change send
        and inflate its basis (review-caught: the misalignment then
        persists for the rest of the leadership, the unsafe direction).
        ``ceded`` also survives: a transfer in progress stays ceded."""
        if self._held:
            self._note_expired()
        self.bases = {}
        self._ack_walls = {}

    def cede(self) -> None:
        """Leadership transfer: the target may campaign immediately
        (TIMEOUT_NOW skips its election timeout), so the clock bound the
        lease rests on is void.  Sticky until the next ``reset`` — an
        aborted transfer may already have delivered TIMEOUT_NOW."""
        if not self.ceded:
            if self._held:
                self._note_expired()
            self.ceded = True
            if self.obs is not None:
                self.obs.cede()

    def inject_clock_jump(self, delta_ticks: int) -> None:
        """Fault injection (linearizability soak): shift this replica's
        view of *now* by ``delta_ticks``.  A negative delta simulates the
        local clock jumping backward — the lease then overestimates its
        validity, which is exactly the stale-lease fault the checker must
        catch."""
        self.skew += delta_ticks

    # ------------------------------------------------------------------
    # heartbeat plumbing (called from raft under raftMu)
    # ------------------------------------------------------------------

    def record_send(self, tick: int, peer_ids: Iterable[int]) -> None:
        """A heartbeat broadcast left for ``peer_ids`` at ``tick``.

        FIFO entries are ``[tick, count]`` — every send within one tick
        folds into the tail entry's count (attribution is tick-granular,
        so all of a tick's sends share one basis), keeping the capacity
        a bound on in-flight TICKS rather than sends.  A send that still
        cannot be recorded (cap'd distinct-tick window, or earlier
        refused sends still in flight) is COUNTED instead: its ack must
        consume an ``_unrecorded`` slot, never a send recorded after it
        — refusing silently would let that later ack pop a newer tick
        and inflate the basis (the unsafe direction).  Once a refusal
        happens, recording stays suspended for the peer until every
        outstanding refused send's ack has drained, preserving the
        FIFO ↔ wire-order correspondence the attribution relies on."""
        for nid in peer_ids:
            dq = self._pending.get(nid)
            if dq is None:
                dq = self._pending[nid] = collections.deque()
            if self._unrecorded.get(nid):
                self._unrecorded[nid] += 1
            elif dq and dq[-1][0] == tick:
                dq[-1][1] += 1
            elif len(dq) < self.PENDING_CAP:
                dq.append([tick, 1])
            else:
                self._unrecorded[nid] = 1

    def record_ack(self, node_id: int, _now: int) -> None:
        """A heartbeat ack arrived from voting member ``node_id``: its
        ack basis becomes the OLDEST recorded send tick (conservative —
        with message loss the ack may actually answer a newer send).
        Acks answering refused-to-record sends (FIFO overflow) drain the
        refusal count and attribute nothing."""
        dq = self._pending.get(node_id)
        if dq:
            head = dq[0]
            self.bases[node_id] = head[0]
            if self.tick_interval_s is not None:
                self._ack_walls[node_id] = self.wall_clock()
            head[1] -= 1
            if head[1] <= 0:
                dq.popleft()
        elif self._unrecorded.get(node_id):
            self._unrecorded[node_id] -= 1

    # ------------------------------------------------------------------
    # validity
    # ------------------------------------------------------------------

    def remaining(self, now: int, quorum: int,
                  voter_ids: Iterable[int], self_id: int) -> int:
        """Ticks of validity left (<= 0: not held).  ``voter_ids`` is the
        current voting membership (remotes + witnesses)."""
        if self.ceded:
            return 0
        voters = list(voter_ids)
        now = now + self.skew
        bases = sorted(
            (now if nid == self_id else self.bases.get(nid, -1))
            for nid in voters
        )
        n = len(bases)
        if n < quorum:
            return 0
        basis = bases[n - quorum]  # quorum-th newest (kth_largest)
        if basis < 0:
            return 0
        rem = basis + self.duration - now
        if rem > 0 and self.tick_interval_s is not None:
            # wall-clock guard: a starved tick loop must not overextend
            # the lease (see __init__) — the quorum-th newest ack must
            # also be fresh in WALL time
            now_w = self.wall_clock()
            walls = sorted(
                (now_w if nid == self_id else self._ack_walls.get(nid, -1.0))
                for nid in voters
            )
            wall_basis = walls[n - quorum]
            if (wall_basis < 0
                    or now_w - wall_basis
                    > self.duration * self.tick_interval_s):
                return 0
        return rem

    def check(self, now: int, quorum: int,
              voter_ids: Iterable[int], self_id: int) -> int:
        """One reduction per read: the remaining validity (<= 0 = not
        held), with the grant/expiry transition accounting folded in."""
        rem = self.remaining(now, quorum, voter_ids, self_id)
        if rem > 0 and not self._held:
            self._held = True
            self.grants += 1
            if self.obs is not None:
                self.obs.grant()
        elif rem <= 0 and self._held:
            self._note_expired()
        return rem

    def valid(self, now: int, quorum: int,
              voter_ids: Iterable[int], self_id: int) -> bool:
        return self.check(now, quorum, voter_ids, self_id) > 0

    def _note_expired(self) -> None:
        self._held = False
        self.expiries += 1
        if self.obs is not None:
            self.obs.expire()

    # ------------------------------------------------------------------
    # read accounting (raft's serve/fallback decision points)
    # ------------------------------------------------------------------

    def note_read_local(self, remaining_ticks: int) -> None:
        self.reads_local += 1
        if self.obs is not None:
            self.obs.read_local(remaining_ticks)

    def note_read_fallback(self) -> None:
        self.reads_fallback += 1
        if self.obs is not None:
            self.obs.read_fallback()

    def stats(self) -> dict:
        """Plain-int snapshot (bench/tests; no registry required)."""
        total = self.reads_local + self.reads_fallback
        return {
            "grants": self.grants,
            "expiries": self.expiries,
            "reads_local": self.reads_local,
            "reads_fallback": self.reads_fallback,
            "hit_ratio": round(self.reads_local / total, 4) if total else None,
        }


class LeaseTable:
    """Advisory per-group lease deadlines for the quorum coordinator (the
    batched device-plane variant).

    The coordinator's drain loop already walks every staged heartbeat-ack
    op (``hbresp``) on its way into the engine; for lease-configured
    groups it additionally folds the acker id into a per-round tally —
    one dict update per op, no extra host pass, no raftMu.  A round whose
    tally reaches a group's quorum extends that group's deadline to
    ``round_tick + duration``.

    Attribution here is drain-tick (optimistic by up to one round), so
    the table is **introspection-grade**: lease-coverage gauges and the
    cross-domain bench read it; the serving decision stays with the
    scalar :class:`LeaderLease` and its conservative send-tick bases.
    """

    __slots__ = ("_quorum", "_duration", "_deadline", "_self_id", "_voters")

    def __init__(self) -> None:
        self._quorum: Dict[int, int] = {}
        self._duration: Dict[int, int] = {}
        self._self_id: Dict[int, int] = {}
        self._voters: Dict[int, frozenset] = {}
        self._deadline: Dict[int, int] = {}

    def configure(self, cluster_id: int, quorum: int, duration: int,
                  self_id: int, voters: Iterable[int] = ()) -> None:
        """``voters`` is the voting membership (remotes + witnesses):
        hbresp ops are staged for EVERY heartbeat responder, observers
        included, so the tally must filter to voters or an observer-ack
        round would extend a deadline no voting quorum backs."""
        self._quorum[cluster_id] = quorum
        self._duration[cluster_id] = duration
        self._self_id[cluster_id] = self_id
        self._voters[cluster_id] = frozenset(voters)
        self._deadline.pop(cluster_id, None)

    def drop(self, cluster_id: int) -> None:
        """Row transition / resync / unregister: the deadline is stale."""
        self._deadline.pop(cluster_id, None)

    def remove(self, cluster_id: int) -> None:
        self._quorum.pop(cluster_id, None)
        self._duration.pop(cluster_id, None)
        self._self_id.pop(cluster_id, None)
        self._voters.pop(cluster_id, None)
        self._deadline.pop(cluster_id, None)

    def tracks(self, cluster_id: int) -> bool:
        return cluster_id in self._quorum

    def note_round(self, acks_by_cid: Dict[int, set], round_tick: int) -> None:
        """Fold one round's heartbeat-ack tally in: ``acks_by_cid`` maps
        cluster id → set of acker node ids seen this round."""
        for cid, ackers in acks_by_cid.items():
            q = self._quorum.get(cid)
            if q is None:
                continue
            voting = ackers & self._voters.get(cid, frozenset())
            voting.add(self._self_id.get(cid, 0))
            if len(voting) >= q:
                self._deadline[cid] = round_tick + self._duration[cid]

    def valid(self, cluster_id: int, now_tick: int) -> bool:
        d = self._deadline.get(cluster_id)
        return d is not None and now_tick < d

    def held_count(self, now_tick: int) -> int:
        return sum(1 for d in self._deadline.values() if now_tick < d)

    def publish(self, registry, now_tick: int) -> None:
        """Once-per-round gauge refresh (only called with obs enabled)."""
        registry.describe(_L + "groups_held", _HELP[_L + "groups_held"])
        registry.gauge_set(_L + "groups_held", self.held_count(now_tick))
