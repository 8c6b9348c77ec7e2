"""Hierarchical commit plane: domain-local sub-quorums.

Counterpart: ``dragonboat_tpu/raft/hier.py``, copied.

Without it a commit across latency domains is priced at the far RTT even
when a near-domain majority acked long ago.  CD-Raft
(arxiv 2603.10555) and "Fast Raft for Hierarchical Consensus"
(arxiv 2506.17793) give the fix its shape, and this module holds the
host-side pieces:

:class:`HierPlane`
    The domain model plus the two coupled rules.

    **Commit rule** — the leader's own domain ``D_L``, when *eligible*
    (>= :data:`MIN_DOMAIN_VOTERS` voters), closes a commit once
    ``|D_L| // 2 + 1`` of its voters (a majority of the domain — the
    sub-quorum) have matched the index; far-domain voters catch up
    asynchronously through the ordinary replicate/resend machinery.
    Classic full-quorum closes remain valid throughout: the effective
    rule is ``max(classic kth-largest, near-domain kth-largest)``.

    **Vote rule** — a candidate may only take office once, *in addition
    to* the classic quorum, it holds at least ``(|D| + 1) // 2`` grants
    inside **every** eligible domain ``D``.  Why that bound: a
    sub-quorum in ``D`` has ``|D| // 2 + 1`` members, and
    ``(|D| + 1) // 2 + (|D| // 2 + 1) = |D| + 1 > |D|`` — the two sets
    must intersect, so the new leader's log carries every
    sub-quorum-committed entry (the same pigeonhole that makes classic
    Raft safe, applied per domain).  The bound is minimal: one grant
    fewer admits a disjoint counterexample.

    Liveness tradeoff (accepted, documented in docs/overview.md): while
    an eligible domain is *entirely* partitioned away, no candidate can
    satisfy its intersection bound and elections stall until the domain
    heals or membership drops it below eligibility.  Commits under an
    established leader are unaffected — the classic quorum still closes
    them.

:class:`FarReadBatcher`
    Far-follower read locality.  A follower whose domain differs from
    the leader's coalesces forwarded ReadIndex round trips: at most one
    cross-domain fetch is in flight; reads arriving meanwhile queue for
    the *next* fetch (never the current one — a read may only ride a
    fetch initiated after it arrived, otherwise the leader could answer
    with a commit point predating the read) and the whole batch
    releases at the single returned index.

:class:`HierObs` / :func:`describe_families`
    ``dragonboat_hier_*`` registry families (the LeaseObs pattern).

Everything here is constructed only when ``Config.hier_commit`` is on;
``raft.hier is None`` is the structural latch keeping the off path
bit-identical (the lease/_obs precedent).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: a domain forms sub-quorums only at this many voters or more; singleton
#: domains (and the unassigned "" class) always defer to the full quorum
MIN_DOMAIN_VOTERS = 2

_H = "dragonboat_hier_"

_HELP = {
    _H + "subquorum_commit_total":
        "commit advances closed by the near-domain sub-quorum",
    _H + "fallback_commit_total":
        "commit advances closed by the classic full quorum",
    _H + "far_lag_entries":
        "entries the slowest far-domain voter trails the commit point",
    _H + "read_batches_total":
        "far-follower ReadIndex fetches sent to the leader",
    _H + "reads_coalesced_total":
        "far-follower reads that joined a pending fetch batch",
    _H + "election_holds_total":
        "vote tallies held at quorum awaiting domain intersection",
}


def describe_families(registry) -> None:
    """Register the ``# HELP`` texts for every ``dragonboat_hier_*``
    family (test_events round-trip contract: one HELP per TYPE)."""
    for name, text in _HELP.items():
        registry.describe(name, text)


class HierObs:
    """Registry-backed hier instruments, shared by every hier-enabled
    group on one NodeHost; attached only when ``enable_metrics`` is on
    and gated on ``is not None`` at every call site."""

    __slots__ = ("registry",)

    def __init__(self, registry):
        self.registry = registry
        describe_families(registry)
        for name in ("subquorum_commit_total", "fallback_commit_total",
                     "read_batches_total", "reads_coalesced_total",
                     "election_holds_total"):
            registry.counter_add(_H + name, 0)
        registry.gauge_set(_H + "far_lag_entries", 0)

    def commit_close(self, via_sub: bool) -> None:
        self.registry.counter_add(
            _H + ("subquorum_commit_total" if via_sub
                  else "fallback_commit_total")
        )

    def far_lag(self, entries: int) -> None:
        self.registry.gauge_set(_H + "far_lag_entries", int(entries))

    def read_batch(self) -> None:
        self.registry.counter_add(_H + "read_batches_total")

    def read_coalesced(self) -> None:
        self.registry.counter_add(_H + "reads_coalesced_total")

    def election_hold(self) -> None:
        self.registry.counter_add(_H + "election_holds_total")


def sub_quorum_size(n: int) -> int:
    """Majority of an ``n``-voter domain — the sub-quorum cardinality."""
    return n // 2 + 1


def intersect_threshold(n: int) -> int:
    """Minimal grants inside an ``n``-voter domain that guarantee
    intersection with any ``sub_quorum_size(n)``-member sub-quorum:
    ``n - sub_quorum_size(n) + 1 == (n + 1) // 2``."""
    return (n + 1) // 2


class HierPlane:
    """One replica's view of the domain model (all methods run under the
    owning node's raftMu — no internal locking).  Membership is passed in
    per call (the voter set is the raft object's live truth and changes
    under config change), so there is nothing here to invalidate on
    add/remove — stale domain *assignments* for departed peers are
    simply never consulted."""

    __slots__ = (
        "domains", "node_id", "obs",
        "subquorum_closes", "fallback_closes", "election_holds",
    )

    def __init__(self, domains: Dict[int, str], node_id: int):
        self.domains = dict(domains)
        self.node_id = node_id
        self.obs: Optional[HierObs] = None
        # plain counters always maintained (tests/bench read them
        # without the metrics plumbing; HierObs mirrors when attached)
        self.subquorum_closes = 0
        self.fallback_closes = 0
        self.election_holds = 0

    def domain_of(self, node_id: int) -> str:
        return self.domains.get(node_id, "")

    def eligible_domains(
        self, voter_ids: Iterable[int]
    ) -> Dict[str, List[int]]:
        """Domain label -> member voter ids, for every domain holding at
        least :data:`MIN_DOMAIN_VOTERS` of the given voters.  The
        unassigned class ("") is never eligible."""
        by_dom: Dict[str, List[int]] = {}
        for nid in voter_ids:
            dom = self.domains.get(nid, "")
            if dom:
                by_dom.setdefault(dom, []).append(nid)
        return {
            d: m for d, m in by_dom.items() if len(m) >= MIN_DOMAIN_VOTERS
        }

    def near_voters(self, voter_ids: Iterable[int]) -> List[int]:
        """This replica's domain members among ``voter_ids`` — the
        sub-quorum candidate set — or ``[]`` when the domain is
        ineligible (unassigned, or fewer than MIN_DOMAIN_VOTERS
        voters)."""
        mine = self.domains.get(self.node_id, "")
        if not mine:
            return []
        members = [
            nid for nid in voter_ids if self.domains.get(nid, "") == mine
        ]
        return members if len(members) >= MIN_DOMAIN_VOTERS else []

    def commit_quorum(
        self, match_of: Dict[int, int], voter_ids: Iterable[int]
    ) -> int:
        """The sub-quorum commit candidate: the kth-largest matchIndex
        over the leader's domain members, k = the domain majority.
        Returns 0 (never advances anything) when the leader's domain is
        ineligible."""
        near = self.near_voters(voter_ids)
        if not near:
            return 0
        matched = sorted(match_of.get(nid, 0) for nid in near)
        return matched[len(near) - sub_quorum_size(len(near))]

    def election_ok(
        self, votes: Dict[int, bool], voter_ids: Iterable[int]
    ) -> bool:
        """The vote-side safety rule: True iff the granted set holds at
        least ``intersect_threshold(|D|)`` members of every eligible
        domain D (guaranteeing intersection with any sub-quorum that may
        have closed a commit there).  The classic quorum test is the
        caller's — this is the *additional* constraint."""
        granted = {nid for nid, ok in votes.items() if ok}
        for members in self.eligible_domains(voter_ids).values():
            need = intersect_threshold(len(members))
            if sum(1 for nid in members if nid in granted) < need:
                return False
        return True

    def note_close(self, via_sub: bool) -> None:
        if via_sub:
            self.subquorum_closes += 1
        else:
            self.fallback_closes += 1
        if self.obs is not None:
            self.obs.commit_close(via_sub)

    def note_election_hold(self) -> None:
        self.election_holds += 1
        if self.obs is not None:
            self.obs.election_hold()

    def note_far_lag(
        self, match_of: Dict[int, int], voter_ids: Iterable[int],
        committed: int,
    ) -> int:
        """Entries the slowest far-domain voter trails the commit point
        (0 when no far voters exist); mirrored to the gauge."""
        mine = self.domains.get(self.node_id, "")
        far = [
            nid for nid in voter_ids
            if self.domains.get(nid, "") != mine or not mine
        ] if mine else []
        if not far:
            lag = 0
        else:
            lag = max(0, committed - min(match_of.get(n, 0) for n in far))
        if self.obs is not None:
            self.obs.far_lag(lag)
        return lag

    def is_far_follower(self, leader_id: int) -> bool:
        """True when this replica and the leader sit in different
        *assigned* domains — the gate for far-read batching.  Unassigned
        on either side stays conservative (no batching)."""
        mine = self.domains.get(self.node_id, "")
        theirs = self.domains.get(leader_id, "")
        return bool(mine) and bool(theirs) and mine != theirs

    def snapshot(self) -> Dict[str, object]:
        return {
            "domains": dict(self.domains),
            "node_domain": self.domains.get(self.node_id, ""),
            "subquorum_closes": self.subquorum_closes,
            "fallback_closes": self.fallback_closes,
            "election_holds": self.election_holds,
        }


class FarReadBatcher:
    """Coalesces a far follower's forwarded ReadIndex round trips.

    At most one cross-domain fetch is in flight.  ``admit`` answers
    whether the caller should forward this ctx to the leader (it becomes
    the in-flight batch's representative) or hold it for the next fetch.
    ``on_resp`` hands back every ctx releasable at the returned index
    plus the representative of the next fetch to forward, if any.
    ``invalidate`` (leader/term change — raft.reset) drains everything
    for the dropped_read_indexes path.

    Safety: a read may only ride a fetch initiated AFTER the read
    arrived.  A fetch the leader is already answering may reflect a
    commit point older than a just-arrived read's linearization point,
    so mid-flight arrivals always queue for the next fetch.
    """

    __slots__ = ("_inflight", "_next", "batches", "coalesced")

    def __init__(self):
        self._inflight: List[object] = []  # [0] is the representative
        self._next: List[object] = []
        self.batches = 0
        self.coalesced = 0

    def admit(self, ctx) -> bool:
        """True -> forward ``ctx`` now (new fetch, ctx is the
        representative); False -> held for the next fetch."""
        if self._inflight:
            self._next.append(ctx)
            self.coalesced += 1
            return False
        self._inflight = [ctx]
        self.batches += 1
        return True

    def on_resp(self, ctx) -> Tuple[List[object], Optional[object]]:
        """Leader answered the fetch whose representative is ``ctx``:
        returns ``(members_to_release, next_representative)``.  A ctx
        that is not the current representative (stale resp after an
        invalidate) releases only itself."""
        if not self._inflight or self._inflight[0] != ctx:
            return [ctx], None
        released = self._inflight
        if self._next:
            self._inflight, self._next = self._next, []
            self.batches += 1
            return released, self._inflight[0]
        self._inflight = []
        return released, None

    def invalidate(self) -> List[object]:
        """Drop every held ctx (leader/term change); the caller routes
        them to ``dropped_read_indexes``."""
        dropped = self._inflight + self._next
        self._inflight = []
        self._next = []
        return dropped

    @property
    def pending(self) -> int:
        return len(self._inflight) + len(self._next)


def seed_domains_from_latency(
    injector, addresses: Dict[int, str]
) -> Dict[int, str]:
    """Build a ``hier_domains`` map from a
    ``LatencyInjector``'s static (the reference's
    ``transport/latency.py``; any object with ``domain_of``)
    domain assignment: ``addresses`` maps node_id -> raft address."""
    return {
        nid: injector.domain_of(addr) or ""
        for nid, addr in addresses.items()
    }


def seed_domains_from_rtt(
    self_id: int,
    rtt_s: Dict[int, float],
    near_ratio: float = 4.0,
) -> Dict[int, str]:
    """RTT-classifier fallback when no injector topology exists: peers
    within ``near_ratio`` x the fastest measured RTT classify into this
    replica's domain ("near"), the rest into "far".  ``rtt_s`` maps
    peer node_id -> RTT seconds (e.g. the per-peer EWMAs
    ``obs/replattr.py`` maintains); the caller ships the result through
    ``Config.hier_domains`` so every replica agrees on one map."""
    out = {self_id: "near"}
    finite = [r for r in rtt_s.values() if r > 0]
    if not finite:
        return out
    floor = min(finite)
    for nid, r in rtt_s.items():
        out[nid] = "near" if (r > 0 and r <= floor * near_ratio) else "far"
    return out
