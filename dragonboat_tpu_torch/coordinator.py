"""Quorum coordinator: routes the live runtime's hot path through the
batched quorum engine on the card.

Counterpart: ``dragonboat_tpu/tpuquorum.py`` (``TpuQuorumCoordinator``).
With it enabled, the per-group scalar work the reference does inside
``processSteps`` — ReplicateResp ack tallying, matchIndex quorum reduction
(``raft.go:888-909`` ``tryCommit``) and candidate vote tallying
(``raft.go:1062-1080``) — is staged as compact event batches and computed
for ALL groups in one device dispatch per coordinator round
(:mod:`dragonboat_tpu_torch.ops`).

Division of labor:
- dense paths on the device: ack ingest (scatter-max), per-group
  kth-largest commit reduction, vote tally vs quorum, the tick decisions,
  ReadIndex echo quorums and the device state machine's apply;
- rare paths stay scalar on the host and re-sync their row: leadership
  transitions, membership change, snapshot restore, index rebase;
- commit/election *effects* are applied back under each node's raftMu
  with the scalar guards intact (``log.try_commit(q, term)`` re-checks the
  term rule), so a stale device result is rejected, never applied.

The coordinator is duck-typed on its nodes (``offload_commit``,
``offload_election``, ``offload_tick_*``, ``offload_read_confirm``,
``offload_read_echo``, ``raft_mu``, ``peer.raft``).  ``device=None``
means CUDA and raises without one; ``device="cpu"`` runs the engine's
plain versions.  The mesh dispatch plane (``mesh_devices > 1``) and
observability (``enable_obs``, ``enable_devprof``) are ported in later
slices and raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from .logger import get_logger

plog = get_logger("coordinator")


class QuorumCoordinator:
    """Owns the device engine; one round = one device dispatch (or one
    K-round block).

    All staging methods are called from raft under the owning node's
    raftMu; the coordinator serializes engine access with its own lock.
    The round thread applies commit/election results back through
    ``Node.offload_commit`` / ``Node.offload_election``.
    """

    def __init__(
        self,
        capacity: int = 1024,
        n_peers: int = 8,
        interval_s: float = 0.002,
        drive_ticks: bool = True,
        mesh_devices: int = 0,
        drive_reads: bool = True,
        warm_fused: bool = False,
        compilation_cache_dir: Optional[str] = None,
        telem: bool = False,
        device=None,
    ):
        from .ops.engine import WARM_K_BUCKETS, BatchedQuorumEngine, k_bucket

        if mesh_devices > 1:
            raise NotImplementedError(
                "mesh_devices > 1: the mesh dispatch plane is ported in a "
                "later slice (ROADMAP.md queue A, item 6)"
            )
        if compilation_cache_dir is not None:
            raise ValueError(
                "compilation_cache_dir: the port has no compilation cache to "
                "point; it caches its kernel library by source hash under "
                "dragonboat_tpu_torch/_build/"
            )
        self.mesh_devices = 0
        self.eng = BatchedQuorumEngine(
            capacity, n_peers, event_cap=max(4 * capacity, 4096),
            device_ticks=drive_ticks, device=device,
        )
        self.capacity = capacity
        # adaptive K-round batching: once the warm-up has launched the
        # padded fused variants, the round thread replays tick backlogs as
        # ONE fused dispatch of up to fused_k_max rounds; until then (and
        # whenever a round carries votes) it stays on the single-round path
        self._k_bucket = k_bucket
        # the deficit cap IS the largest warmed block: a bigger cap would
        # silently drop the ticks past the pad clamp
        self.fused_k_max = max(WARM_K_BUCKETS)
        self.fused_dispatches = 0
        # auto-warm only ticking engines: the fused live path is
        # tick-deficit replay, meaningless without drive_ticks
        self._warm_requested = warm_fused and drive_ticks
        # device-tick mode: the per-tick firing decisions (election due,
        # heartbeat due, check-quorum window) come from the device tick
        # kernel; registered nodes set raft.device_ticks accordingly
        self.drive_ticks = drive_ticks
        # device read plane: ReadIndex heartbeat-echo quorum counting
        # batches into the same dispatch; the scalar ReadIndex stays the
        # pending bookkeeping and the releaser
        self.drive_reads = drive_reads
        # per-group FIFO of device-staged read ctxs: cid -> list of
        # (slot, low, high, term) in staging order.  Confirmation of a
        # slot releases its ctx through the scalar prefix release, which
        # also frees every EARLIER ctx — their engine slots are cancelled
        # here.  Guarded by _mu (round thread + drain).
        self._read_pending: Dict[int, list] = {}
        # batched device-plane lease tracking (lease.LeaseTable): created
        # by the first registered read_lease group; the drain loop folds
        # the heartbeat-ack ops it is ALREADY walking into a per-round
        # tally.  Advisory only: the serving authority is each group's
        # scalar LeaderLease.
        self.lease_table = None
        # ctxs confirmed BY THE DEVICE plane vs echoes that fell back to
        # the scalar tally (overflow/stale)
        self.read_confirms = 0
        self.read_fallbacks = 0
        # device state machine plane (DevKVPlane): created by the FIRST
        # DeviceKVStateMachine registration.  None keeps the round loop
        # bit-identical — every hook below gates on it.
        self.devsm = None
        # monotonically increasing tick sequence written ONLY by the tick
        # thread; the round compares against the last value it consumed, so
        # a tick arriving mid-round is never lost (no lock needed: single
        # writer, single reader)
        self._tick_seq = 0
        self._tick_seen = 0
        self._nodes: Dict[int, object] = {}
        self._mu = threading.RLock()
        # staging is decoupled from the engine lock: raft step workers only
        # append under this micro-lock and NEVER wait on an in-flight
        # device dispatch — a blocked step worker delays heartbeats and
        # provokes spurious elections
        self._stage_mu = threading.Lock()
        self._staged: list = []
        # per-round leader-contact dedup: one election-clock reset per
        # group per round is sufficient and idempotent
        self._contacted: set = set()
        self._pending = threading.Event()
        self._stopped = threading.Event()
        self._interval = interval_s
        # compartmentalized host plane (wired by NodeHost): the round
        # fan-out then flags offload effects with wake=False and coalesces
        # the step wakeups to ONE per touched group per round.  None keeps
        # the per-effect wakeups.
        self.hostplane = None
        # cross-plane request tracer (set by NodeHost): the round fan-out
        # stamps "device_round" on the in-flight traces of every group whose
        # commit/read-confirm this round released.  None keeps the round
        # loop bit-identical.
        self.tracer = None
        # replication attribution (set by NodeHost with the tracer).  None
        # keeps the round loop bit-identical.
        self.replattr = None
        # device capacity & profiling plane: attached by enable_devprof,
        # which comes with the profiling slice
        self.devprof = None
        # device telemetry fold (NodeHost wires health_aggregate here):
        # flipped BEFORE warm-up starts so the warmed variants carry it
        if telem:
            self.eng.enable_telem()
        if self._warm_requested:
            self.start_warmup()
        self._thread = threading.Thread(
            target=self._round_main, name="quorum-coordinator", daemon=True
        )
        self._thread.start()

    def start_warmup(self, force: bool = False):
        """Kick off the engine's background warm-up (idempotent; see
        ``BatchedQuorumEngine.warmup_fused``).  Until the readiness latch
        flips every round uses the single-round path; on the card the
        first of its launches waits for the kernel library like any other.

        No-op (returns None) on a tickless coordinator unless ``force``:
        the fused live path is tick-deficit replay."""
        if not force and not self.drive_ticks:
            return None
        return self.eng.warmup_fused()

    @property
    def warmup_stats(self) -> dict:
        """The engine's warm-up record (programs, wall seconds, library
        hits/misses, error)."""
        return self.eng.warmup_stats

    def enable_obs(self, recorder=None, registry=None, stall_ms=None):
        """Round-loop and engine instruments: ported with observability."""
        raise NotImplementedError(
            "enable_obs: observability is ported in a later slice "
            "(ROADMAP.md queue A, item 7)"
        )

    def enable_devprof(self, devprof):
        """The device capacity & profiling plane: ported with profiling."""
        raise NotImplementedError(
            "enable_devprof: the device profiling plane is ported in a later "
            "slice (ROADMAP.md queue A, item 7)"
        )

    def enable_telem(self, topk: Optional[int] = None) -> None:
        """Flip the engine's device telemetry fold: every subsequent
        dispatch egresses a fixed-size health aggregate.  One-way; prefer
        the ``telem=True`` constructor kwarg so the warm-up already runs
        the fold."""
        self.eng.enable_telem(topk)

    @property
    def telem_enabled(self) -> bool:
        return self.eng.telem_enabled

    def telem_snapshot(self) -> Optional[dict]:
        """Latest harvested device telemetry aggregate (None until the
        first telem-on dispatch lands).  Passive: the dict refreshes only
        when rounds dispatch, and carries ``seq``/``mono`` so the health
        sampler can tell a fresh fold from a stale one."""
        return self.eng.telem_snapshot()

    def registered_cids(self) -> set:
        """Cluster ids currently registered on the device engine (the
        aggregate health sampler's coverage set).  Snapshot under the
        coordinator lock."""
        with self._mu:
            return set(self._nodes)

    def health_snapshot(self) -> dict:
        """Round-loop health for the cluster health sampler: staged-op
        backlog, registered groups, warm-up readiness and the read-plane
        tallies — all lock-free or micro-locked reads, never the engine
        lock."""
        with self._stage_mu:
            staged = len(self._staged)
        d = {
            "groups": len(self._nodes),
            "staged": staged,
            "tick_deficit": self._tick_seq - self._tick_seen,
            "fused_ready": bool(self.eng.fused_ready),
            "fused_dispatches": self.fused_dispatches,
            "read_confirms": self.read_confirms,
            "read_fallbacks": self.read_fallbacks,
        }
        lt = self.lease_table
        if lt is not None:
            d["lease_groups_held"] = lt.held_count(self._tick_seen)
        return d

    # ------------------------------------------------------------------
    # node lifecycle
    # ------------------------------------------------------------------

    def register(self, node) -> None:
        """Add the node's group and sync its current raft state into the
        row.  Called after Peer.launch with the raft lock held."""
        with self._mu:
            self._nodes[node.cluster_id] = node
            self._sync_row_locked(node)
            if self.drive_reads:
                node.peer.raft.device_reads = True

    def unregister(self, cluster_id: int) -> None:
        if self.devsm is not None:
            self.devsm.unregister(cluster_id)
        with self._mu:
            self._nodes.pop(cluster_id, None)
            self._read_pending.pop(cluster_id, None)
            if self.lease_table is not None:
                self.lease_table.remove(cluster_id)
            if cluster_id in self.eng.groups:
                self.eng.remove_group(cluster_id)

    def devsm_plane(self):
        """The device state machine plane, created on first use."""
        if self.devsm is None:
            from .devsm.plane import DevKVPlane

            self.devsm = DevKVPlane(self)
            # the ENGINE egress hook is the single delivery channel for
            # KV read captures: it fires on every harvest that carried
            # one — including rare-path internal harvests (row syncs,
            # transitions) whose results the round loop never sees
            self.eng.kv_egress_hook = self.devsm.deliver
        return self.devsm

    def devsm_force_release(self, cluster_id: int) -> bool:
        """Actuation surface for the recovery plane: force-release the
        group's device binding — reads fall back to the gated host shadow
        and the bind re-arms only on the next leadership transition.
        Returns True when the group was tracked."""
        plane = self.devsm
        if plane is None or not plane.tracks(cluster_id):
            return False
        plane.on_unbind(cluster_id)
        return True

    def _sync_row_locked(self, node) -> None:
        """(Re)build the group's row from scalar raft state — the rare-path
        resync used at registration and after membership changes."""
        r = node.peer.raft
        cid = r.cluster_id
        self._read_pending.pop(cid, None)
        if r.lease is not None:
            # (re)configure the advisory lease row from scalar state
            if self.lease_table is None:
                from .lease import LeaseTable

                self.lease_table = LeaseTable()
            self.lease_table.configure(
                cid, r.quorum(), r.lease.duration, r.node_id,
                voters=list(r.remotes) + list(r.witnesses),
            )
        if cid in self.eng.groups:
            self.eng.remove_group(cid)
        voters = sorted(set(r.remotes))
        witnesses = tuple(sorted(r.witnesses))
        observers = tuple(sorted(r.observers))
        if r.node_id not in r.remotes and r.node_id not in r.witnesses and (
            r.node_id not in r.observers
        ):
            # a joining node knows no membership yet (it learns from the
            # log); register a self-only row until membership_changed
            # resyncs it
            voters = sorted(set(voters) | {r.node_id})
        self.eng.add_group(
            cid,
            node_ids=voters,
            self_id=r.node_id,
            election_timeout=r.election_timeout,
            heartbeat_timeout=r.heartbeat_timeout,
            # per-replica seeded randomized timeout (scalar raft's own)
            rand_timeout=r.randomized_election_timeout,
            check_quorum=r.check_quorum,
            witnesses=witnesses,
            observers=observers,
        )
        if r.hier is not None:
            # hier geometry is membership-like: the near mask and
            # sub-quorum cardinality follow the voter set and this
            # replica's static domain, so the registration/resync rebuild
            # is the only push site
            from .raft.hier import sub_quorum_size

            near = r.hier.near_voters(set(voters) | set(witnesses))
            self.eng.set_hier(
                cid, near, sub_quorum_size(len(near)) if near else 0
            )
        if r.is_leader():
            self.eng.set_leader(
                cid,
                term=r.term,
                term_start=self._term_start(r),
                last_index=r.log.last_index(),
            )
            # replay known match state so commit picks up where scalar was
            for nid, rp in list(r.remotes.items()) + list(r.witnesses.items()):
                if rp.match > 0:
                    self.eng.ack(cid, nid, rp.match)
            if self.devsm is not None and self.devsm.tracks(cid):
                # a resync on a standing leader re-arms the devsm bind at
                # the current log tail (the drain's resync op unbound it)
                self.devsm.on_leader(cid, r.log.last_index())
        elif r.is_candidate():
            self.eng.set_candidate(cid, term=r.term)
            for nid, granted in r.votes.items():
                self.eng.vote(cid, nid, granted)
        else:
            self.eng.set_follower(cid, term=r.term)

    @staticmethod
    def _term_start(r) -> int:
        """First index of the leader's current term — the floor below which
        counting-based commit is forbidden (raft paper p8).  O(1): the
        leader records the index of its promotion noop
        (``raft.term_start_index``); the scan covers rows synced from state
        predating the attribute."""
        if r.term_start_index > 0:
            return r.term_start_index
        idx = r.log.last_index()
        first = r.log.first_index()
        while idx >= first:
            try:
                if r.log.term(idx) != r.term:
                    return idx + 1
            except Exception:
                return idx + 1
            idx -= 1
        return idx + 1

    # ------------------------------------------------------------------
    # staging hooks (called from raft under the node's raftMu)
    # ------------------------------------------------------------------

    def _stage(self, op) -> None:
        with self._stage_mu:
            self._staged.append(op)
        self._pending.set()

    def ack(self, cluster_id: int, node_id: int, index: int) -> None:
        self._stage(("ack", cluster_id, node_id, index))

    def vote(self, cluster_id: int, node_id: int, granted: bool) -> None:
        self._stage(("vote", cluster_id, node_id, granted))

    def heartbeat_resp(self, cluster_id: int, node_id: int) -> None:
        self._stage(("hbresp", cluster_id, node_id))

    def leader_contact(self, cluster_id: int) -> None:
        if cluster_id in self._contacted:
            return
        with self._stage_mu:
            if cluster_id in self._contacted:
                return
            self._contacted.add(cluster_id)
            self._staged.append(("contact", cluster_id))
        self._pending.set()

    def set_randomized_timeout(self, cluster_id: int, timeout: int) -> None:
        self._stage(("randto", cluster_id, timeout))

    def read_stage(
        self, cluster_id: int, committed: int, low: int, high: int, term: int
    ) -> None:
        """A leader accepted a ReadIndex ctx (``handle_leader_read_index``
        under raftMu): stage it into the group's pending-read slot,
        captured at scalar raft's own committed watermark."""
        self._stage(("rstage", cluster_id, committed, low, high, term))

    def read_ack_hint(
        self, cluster_id: int, node_id: int, low: int, high: int
    ) -> None:
        """A heartbeat response echoed a ReadIndex hint: joins the ctx's
        pending-read slot; the device row-sum decides the quorum."""
        self._stage(("rack", cluster_id, node_id, low, high))

    def stage_sm_ops(self, cluster_id: int, ops) -> None:
        """A devsm leader appended application entries
        (``raft.append_entries`` under raftMu): hand their ``(index,
        payload)`` pairs to the device state machine plane — the apply
        consumes them the round their commit lands."""
        self._stage(("kvops", cluster_id, ops))

    def set_leader(
        self, cluster_id: int, term: int, term_start: int, last_index: int
    ) -> None:
        self._stage(("leader", cluster_id, term, term_start, last_index))

    def set_candidate(self, cluster_id: int, term: int) -> None:
        self._stage(("candidate", cluster_id, term))

    def set_follower(self, cluster_id: int, term: int) -> None:
        self._stage(("follower", cluster_id, term))

    def membership_changed(self, cluster_id: int) -> None:
        self._stage(("resync", cluster_id))

    def request_tick(self) -> None:
        """One RTT elapsed: the next round runs the device tick (called
        from the NodeHost tick worker, once per tick for ALL groups — the
        device ticks rows in lockstep)."""
        self._tick_seq += 1
        self._pending.set()

    def _drain_locked(self) -> list:
        """Apply staged ops to the engine in staging order (so a
        transition's queued-event purge still covers exactly the events
        staged before it).  Returns the cids needing a row recovery —
        recovery takes node.raft_mu, and the lock order everywhere else is
        raft_mu -> coord._mu (register's contract), so acquiring raft_mu
        HERE (under _mu) would deadlock against a register; the caller
        recovers after releasing _mu."""
        with self._stage_mu:
            ops, self._staged = self._staged, []
            self._contacted.clear()
        recover = []
        lt = self.lease_table
        lease_acks: Dict[int, set] = {}
        # bulk-pull every row a transition below will mutate: one device
        # gather per field for the whole set, instead of single-row reads
        # inside each set_* call
        sync_rows = []
        for op in ops:
            if op[0] in ("leader", "candidate", "follower", "randto"):
                gi = self.eng.groups.get(op[1])
                if gi is not None:
                    sync_rows.append(gi.row)
        if sync_rows:
            self.eng.sync_rows(sync_rows)
        for op in ops:
            kind, cid = op[0], op[1]
            if cid not in self.eng.groups:
                continue
            try:
                if kind == "ack":
                    self.eng.ack(cid, op[2], op[3])
                elif kind == "vote":
                    self.eng.vote(cid, op[2], op[3])
                elif kind == "hbresp":
                    self.eng.heartbeat_resp(cid, op[2])
                    if lt is not None and lt.tracks(cid):
                        # lease tally rides the op walk already in flight
                        lease_acks.setdefault(cid, set()).add(op[2])
                elif kind == "contact":
                    self.eng.leader_contact(cid)
                elif kind == "randto":
                    self.eng.set_randomized_timeout(cid, op[2])
                elif kind == "rstage":
                    try:
                        slot = self.eng.stage_read(cid, count=1, index=op[2])
                    except RuntimeError:
                        # every pending-read slot holds an unconfirmed
                        # batch: leave this ctx to the scalar fallback
                        # (its echoes arrive as unknown-ctx racks below)
                        pass
                    else:
                        self._read_pending.setdefault(cid, []).append(
                            (slot, op[3], op[4], op[5])
                        )
                elif kind == "rack":
                    node_id, low, high = op[2], op[3], op[4]
                    slot = None
                    for sl, lo, hi, _t in self._read_pending.get(cid, ()):
                        if lo == low and hi == high:
                            slot = sl
                            break
                    if slot is not None:
                        self.eng.read_ack(cid, node_id, slot)
                    else:
                        # ctx not device-tracked (slot overflow, stale or
                        # already-confirmed echo): scalar tally under
                        # raftMu — confirm() on an unknown ctx is a no-op
                        self.read_fallbacks += 1
                        node = self._nodes.get(cid)
                        if node is not None:
                            node.offload_read_echo(node_id, low, high)
                elif kind == "kvops":
                    if self.devsm is not None:
                        self.devsm.handle_ops(cid, op[2])
                elif kind == "leader":
                    self._read_pending.pop(cid, None)
                    if lt is not None:
                        lt.drop(cid)
                    self.eng.set_leader(
                        cid, term=op[2], term_start=op[3], last_index=op[4]
                    )
                    if self.devsm is not None:
                        self.devsm.on_leader(cid, op[4])
                elif kind == "candidate":
                    self._read_pending.pop(cid, None)
                    if lt is not None:
                        lt.drop(cid)
                    self.eng.set_candidate(cid, term=op[2])
                    if self.devsm is not None:
                        self.devsm.on_unbind(cid)
                elif kind == "follower":
                    self._read_pending.pop(cid, None)
                    if lt is not None:
                        lt.drop(cid)
                    self.eng.set_follower(cid, term=op[2])
                    if self.devsm is not None:
                        self.devsm.on_unbind(cid)
                else:  # resync
                    self._read_pending.pop(cid, None)
                    if lt is not None:
                        lt.drop(cid)
                    if self.devsm is not None:
                        self.devsm.on_unbind(cid)
                    recover.append(cid)
            except (ValueError, KeyError):
                # unknown peer slot / index past the rebase window: rebuild
                # the row from scalar state (rare)
                recover.append(cid)
        if lt is not None and lease_acks:
            lt.note_round(lease_acks, self._tick_seen)
        return recover

    def _recover_row(self, cluster_id: int) -> None:
        """Rebuild a row from scalar state.  Lock order: raft_mu FIRST,
        then _mu (matching register) — never call under _mu."""
        node = self._nodes.get(cluster_id)
        if node is None:
            return
        with node.raft_mu:
            if node.peer is None:
                return
            with self._mu:
                if cluster_id not in self.eng.groups:
                    return
                try:
                    self.eng.rebase(cluster_id)
                except Exception:
                    pass
                self._sync_row_locked(node)

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------

    def _round_main(self) -> None:
        # Deprioritize this thread (Linux per-thread niceness, default +5,
        # DBTPU_ENGINE_NICE overrides, 0 disables).  The round thread is a
        # batch amortizer — a delayed round just batches more events — but
        # its dispatches compete with the raft/transport threads for
        # cycles on a core-starved box.  On an idle machine niceness
        # changes nothing.
        try:
            nice = int(os.environ.get("DBTPU_ENGINE_NICE", "5"))
        except ValueError:
            plog.warning("malformed DBTPU_ENGINE_NICE; using default 5")
            nice = 5
        if nice:
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
            except (OSError, AttributeError) as e:
                plog.warning("engine round-thread nice failed: %r", e)
        while not self._stopped.is_set():
            fired = self._pending.wait(timeout=self._interval)
            if self._stopped.is_set():
                return
            if fired:
                self._pending.clear()
            try:
                self._round()
            except Exception:
                plog.exception("quorum coordinator round failed")

    def _round(self) -> None:
        recover: list = []
        try:
            self._round_inner(recover)
        finally:
            if recover:
                # rare-path row rebuilds, OUTSIDE _mu (lock order: raft_mu
                # then _mu); the recovered rows step next round
                for cid in dict.fromkeys(recover):
                    self._recover_row(cid)
                self._pending.set()

    def _round_inner(self, recover: list) -> None:
        with self._mu:
            seq = self._tick_seq
            # catch up missed ticks (a slow round can span several host
            # ticks; the scalar path replays every LOCAL_TICK the same
            # way).  Fused-ready rounds replay up to fused_k_max ticks in
            # ONE dispatch; before the warm-up completes the cap stays at 4
            # so the per-step replay can't turn a stall into a dispatch
            # storm.
            fused_ok = self.drive_ticks and self.eng.fused_ready
            cap = self.fused_k_max if fused_ok else 4
            deficit = min(seq - self._tick_seen, cap) if self.drive_ticks else 0
            do_tick = deficit > 0
            self._tick_seen = seq
            recover.extend(self._drain_locked())
            if self.devsm is not None:
                # advance pending devsm binds (host apply catching the
                # promotion watermark completes them)
                self.devsm.poll()
            has_acks = bool(
                self.eng._acks or self.eng._ack_blocks or self.eng._votes
            )
            # staged read ctxs / heartbeat echoes must dispatch even on an
            # otherwise-quiet round: nothing else would ever flush them
            has_reads = self.eng._reads_pending()
            # ... and so must staged devsm entry ops / KV read captures
            has_kv = self.eng._kv_pending()
            # dirty-only rounds (row registrations, transition replays
            # with no queued events) need no dispatch when ticks drive
            # regular rounds anyway: the upload piggybacks on the next
            # event/tick round
            dirty_gate = bool(self.eng._dirty and not self.drive_ticks)
            if not (do_tick or has_acks or has_reads or has_kv or dirty_gate):
                return
            # Adaptive K-round batching:
            #   - quiet rounds (deficit <= 1) keep the single-round step;
            #   - a tick backlog replays as ONE fused dispatch: the staged
            #     events ride round 0 and the remaining deficit ticks run
            #     as event-free padding rounds (tick_rounds), padded to the
            #     nearest warm K bucket;
            #   - rounds carrying VOTES take the single-round path
            #     (elections want the fastest round, not a batched one);
            #   - until the warm-up completes, the per-step replay below
            #     keeps the single-round path.
            # Semantics are unchanged either way: a deficit-K block is
            # precisely the old step + (K-1) tick replays in one launch.
            has_votes = bool(self.eng._votes)
            # the coordinator never stages in-program recycles itself, but
            # a hybrid caller could leave churn in the backlog — the warmed
            # set excludes the has_churn variant
            has_churn = bool(self.eng._churn or self.eng._round_blocks)
            # a kv-carrying block needs the has_kv fused variants warmed
            # (warmup_devsm, kicked at plane registration); buffered
            # device ents force the plane too (see _kv_ents_buffered)
            kv_unwarmed = (
                has_kv or self.eng._kv_ents_buffered()
            ) and not self.eng.kv_fused_ready
            read_confirms: list = []
            if (
                fused_ok and deficit > 1 and not has_votes
                and not has_churn and not kv_unwarmed
            ):
                # guarantee >= 1 round even on a pure tick-catch-up round
                # with nothing staged
                self.eng.begin_round()
                res = self.eng.step_rounds(
                    do_tick=True,
                    pad_rounds_to=self._k_bucket(deficit),
                    tick_rounds=deficit,
                )
                self.fused_dispatches += 1
                self._collect_read_confirms(res, read_confirms)
            else:
                # per-step replay keeps the 4-tick cap even when the fused
                # gate (votes, warm-up) bounced a deeper backlog here: one
                # skipped fuse must not become a 16-dispatch storm
                deficit = min(deficit, 4)
                res = self.eng.step(do_tick=do_tick)
                self._collect_read_confirms(res, read_confirms)
                for _ in range(deficit - 1):  # replay remaining ticks
                    extra = self.eng.step(do_tick=True)
                    res.commit.update(extra.commit)
                    self._collect_read_confirms(extra, read_confirms)
                    for field in (
                        "won", "lost", "elect", "heartbeat", "demote"
                    ):
                        merged = set(getattr(res, field))
                        merged.update(getattr(extra, field))
                        setattr(res, field, list(merged))
        # (devsm KV read captures were already delivered by the engine's
        # kv_egress_hook inside each harvest — see devsm_plane())
        # confirmed-read releases, OUTSIDE _mu like the commit callbacks:
        # the node re-checks leader/term under raftMu and releases through
        # the scalar ReadIndex prefix pop.  With the host plane attached,
        # effects are flagged with wake=False and the step wakeups coalesce
        # to one per touched group at the end of the round.
        tracer = self.tracer
        if tracer is not None and (res.commit or read_confirms):
            # stamp the device round BEFORE the offload fan-out, linking
            # the span seq of the dispatch that served this round
            seq = self.eng.last_span_seq
            if read_confirms:
                cids = set(res.commit)
                cids.update(c for c, _l, _h, _t in read_confirms)
            else:
                cids = res.commit
            tracer.mark_clusters(cids, seq if seq >= 0 else None)
        replattr = self.replattr
        if replattr is not None and res.commit:
            seq = self.eng.last_span_seq
            if seq >= 0:
                for cid in res.commit:
                    replattr.note_device_round(cid, seq)
        hp = self.hostplane
        touched: dict = {}
        # wake_kw stays EMPTY without the host plane so duck-typed nodes
        # without the wake kwarg keep working
        wake_kw: dict = {} if hp is None else {"wake": False}
        for cid, low, high, term in read_confirms:
            node = self._nodes.get(cid)
            if node is not None:
                node.offload_read_confirm(low, high, term, **wake_kw)
                if hp is not None:
                    touched[cid] = node
        for cid, q in res.commit.items():
            node = self._nodes.get(cid)
            if node is not None:
                node.offload_commit(q, **wake_kw)
                if hp is not None:
                    touched[cid] = node
        # device tick flags: election due / heartbeat due / check-quorum
        # demote — applied through the scalar handlers under raftMu with
        # all guards intact (stale flags are rejected there)
        if do_tick:
            for cid in res.elect:
                node = self._nodes.get(cid)
                if node is not None:
                    node.offload_tick_elect(**wake_kw)
                    if hp is not None:
                        touched[cid] = node
            for cid in res.heartbeat:
                node = self._nodes.get(cid)
                if node is not None:
                    node.offload_tick_heartbeat(**wake_kw)
                    if hp is not None:
                        touched[cid] = node
            for cid in res.demote:
                node = self._nodes.get(cid)
                if node is not None:
                    node.offload_tick_demote(**wake_kw)
                    if hp is not None:
                        touched[cid] = node
        if hp is not None and touched:
            hp.wake_nodes(touched.values())
        # tag election outcomes with the term the row held when the round
        # ran: the scalar side may have restarted the campaign at a higher
        # term meanwhile, and a stale won-flag must never promote a
        # later-term candidate that lacks a quorum at that term
        won_terms = {}
        lost_terms = {}
        with self._mu:
            for cid in res.won:
                gi = self.eng.groups.get(cid)
                if gi is not None:
                    won_terms[cid] = int(self.eng._read("term", gi.row))
            for cid in res.lost:
                gi = self.eng.groups.get(cid)
                if gi is not None:
                    lost_terms[cid] = int(self.eng._read("term", gi.row))
        for cid, term in won_terms.items():
            node = self._nodes.get(cid)
            if node is not None:
                node.offload_election(True, term)
        for cid, term in lost_terms.items():
            node = self._nodes.get(cid)
            if node is not None:
                node.offload_election(False, term)

    def _collect_read_confirms(self, res, out: list) -> None:
        """Map confirmed-read egress slots back to their ctxs (under _mu).

        A confirmed slot releases its ctx AND — through the scalar prefix
        release — every ctx staged before it; the earlier ctxs' engine
        slots are cancelled here so they don't leak until a transition
        purge.  Ctxs no longer tracked (a transition purged the group's
        FIFO after the dispatch was staged) drop silently: the node-side
        term guard would reject them anyway."""
        if res.read_cids is None or not len(res.read_cids):
            return
        for cid, slot, _index, _count in res.reads:
            fifo = self._read_pending.get(cid)
            if not fifo:
                continue
            pos = next(
                (i for i, e in enumerate(fifo) if e[0] == slot), None
            )
            if pos is None:
                continue
            _slot, low, high, term = fifo[pos]
            for e in fifo[:pos]:  # prefix-released scalar-side
                try:
                    self.eng.cancel_read(cid, e[0])
                except (ValueError, KeyError):
                    pass
            del fifo[: pos + 1]
            self.read_confirms += 1
            out.append((cid, low, high, term))

    def flush(self) -> None:
        """Run one round synchronously (tests)."""
        self._round()

    def stop(self) -> None:
        self._stopped.set()
        self.eng.cancel_warmup()
        self._pending.set()
        self._thread.join(timeout=5)
