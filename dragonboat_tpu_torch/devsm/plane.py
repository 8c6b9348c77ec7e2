"""Coordinator-side manager of device-bound KV groups.

Counterpart: ``dragonboat_tpu/devsm/plane.py``, copied.

One :class:`DevKVPlane` per :class:`~..coordinator.QuorumCoordinator`
(created lazily by the first registration).  It owns three protocols:

**Leadership-scoped binding.**  Device KV state is leader-row state: only
the leader stages entry ops (at ``append_entries``), so only a leading
host's row holds live values.  At promotion the plane records the bind
watermark B = the leader's ``last_index`` (every entry <= B predates op
staging; every entry > B WILL be staged).  Once host apply catches B,
the shadow — which then covers exactly the unstaged prefix — uploads as
the row's KV image and buffered ops flush.  Ops in (B, applied] may both
ride the shadow and restage: re-applying a contiguous suffix of SETs in
log order is idempotent, so the overlap is harmless (the torn-snapshot
argument lives in ``try_bind``).  Any transition away from leadership
unbinds; the shadow (warm on every replica) makes rebinding cheap and
device pulls unnecessary.

**Entry-op staging.**  ``raft.append_entries`` offloads application
entries under raftMu; the coordinator drain hands them here, where the
fixed-width codec filters real ops (session/config/noop entries fall
out) and the engine buffers them for the fused apply fold.

**The KV read service.**  A lookup on a bound group stages a device KV
read and parks on an event; the round that captures it resolves the
waiter from the harvest egress (``StepResult.kv_reads``).  Fallbacks
(unbound, slot backpressure, timeout) serve the host shadow — gated on
host apply reaching the group's device-release floor, so a read released
at the device watermark never reads a stale shadow.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..logger import get_logger
from .codec import decode_op

dlog = get_logger("devsm")

#: device-capture wait before the shadow fallback takes over (a capture
#: normally lands within one coordinator round, ~ms)
READ_TIMEOUT_S = 5.0


class DevKVPlane:
    """Per-coordinator devsm manager.  Engine access happens under the
    coordinator's ``_mu`` (drain context or explicitly taken); waiter
    bookkeeping under the plane's own lock."""

    def __init__(self, coord):
        self.coord = coord
        self._mu = threading.Lock()
        self._sms: Dict[int, object] = {}          # cid -> machine
        self._bound: set = set()
        self._pending_bind: Dict[int, int] = {}    # cid -> bind watermark B
        self._prebind_ops: Dict[int, List[Tuple[int, int, int]]] = {}
        # (cid, slot) -> [event, value, index]
        self._waiters: Dict[Tuple[int, int], list] = {}
        # observability (read by tests/bench; devsm metric families are
        # published by the ENGINE's apply_kernel/devsm_egress spans)
        self.ops_staged = 0
        self.reads_served = 0
        self.read_fallbacks = 0
        self.binds = 0
        # per-group bind counts (cluster health plane): the
        # devsm-rebind detector needs per-group increments, not the
        # plane-wide total
        self._bind_counts: Dict[int, int] = {}

    # ------------------------------------------------------------------
    # registration (NodeHost.start_cluster wiring)
    # ------------------------------------------------------------------

    def register(self, cluster_id: int, sm) -> None:
        """Bind a :class:`DeviceKVStateMachine` instance to its group.
        Kicks the devsm variants' warm-up so kv-carrying rounds fuse once
        it finishes (the warmup_fused contract)."""
        if sm.kv_slots > self.coord.eng.n_kv_slots:
            raise ValueError(
                f"kv_slots {sm.kv_slots} exceeds engine width "
                f"{self.coord.eng.n_kv_slots}"
            )
        with self._mu:
            self._sms[cluster_id] = sm
            sm._plane = self
        if self.coord.drive_ticks and self.coord.mesh_devices <= 1:
            self.coord.eng.warmup_devsm()

    def unregister(self, cluster_id: int) -> None:
        with self._mu:
            sm = self._sms.pop(cluster_id, None)
            if sm is not None:
                sm._plane = None
            self._bound.discard(cluster_id)
            self._pending_bind.pop(cluster_id, None)
            self._prebind_ops.pop(cluster_id, None)
            self._bind_counts.pop(cluster_id, None)
            self._flush_waiters_locked(cluster_id)

    def tracks(self, cluster_id: int) -> bool:
        return cluster_id in self._sms

    def bound(self, cluster_id: int) -> bool:
        """True while the group's reads/applies are device-served (the
        node's read-release gate checks this per commit offload)."""
        return cluster_id in self._bound

    def health_snapshot(self, cluster_id: int) -> Optional[dict]:
        """One group's devsm status for the cluster health sampler:
        binding state, pending bind watermark and the
        per-group bind count the rebind-loop detector differentiates."""
        with self._mu:
            if cluster_id not in self._sms:
                return None
            return {
                "bound": cluster_id in self._bound,
                "pending_bind": self._pending_bind.get(cluster_id),
                "binds": self._bind_counts.get(cluster_id, 0),
            }

    def devprof_snapshot(self) -> dict:
        """Plane-level residency for the device profiling plane: the
        device-side kv slabs are already priced by the engine's
        HBM ledger — what only this plane knows is the HOST-side shadow
        residency (one warm numpy image per registered SM on every
        replica) and how many groups are actually device-serving."""
        with self._mu:
            shadow = 0
            for sm in self._sms.values():
                vals = getattr(sm, "values", None)
                if vals is not None and hasattr(vals, "nbytes"):
                    shadow += int(vals.nbytes)
            return {
                "groups": len(self._sms),
                "bound": len(self._bound),
                "pending_binds": len(self._pending_bind),
                "shadow_bytes": shadow,
                "binds": self.binds,
                "reads_served": self.reads_served,
                "read_fallbacks": self.read_fallbacks,
            }

    # ------------------------------------------------------------------
    # leadership transitions (coordinator drain, under coord._mu)
    # ------------------------------------------------------------------

    def on_leader(self, cluster_id: int, last_index: int) -> None:
        """This host took the lease on the group's apply plane: arm the
        bind at watermark B = the promotion ``last_index`` (includes the
        term-start noop; every later append stages its ops)."""
        if cluster_id not in self._sms:
            return
        with self._mu:
            self._bound.discard(cluster_id)
            self._prebind_ops[cluster_id] = []
            self._pending_bind[cluster_id] = last_index
            self._flush_waiters_locked(cluster_id)
        self._try_bind(cluster_id)

    def on_unbind(self, cluster_id: int) -> None:
        """Leadership moved (follower/candidate/resync): device serving
        stops, parked readers fall back to the gated shadow."""
        if cluster_id not in self._sms:
            return
        with self._mu:
            self._bound.discard(cluster_id)
            self._pending_bind.pop(cluster_id, None)
            self._prebind_ops.pop(cluster_id, None)
            self._flush_waiters_locked(cluster_id)

    def on_restore(self, cluster_id: int) -> None:
        """Snapshot recover on a bound group (rare: a leader restoring):
        the shadow is the new truth — re-upload it."""
        coord = self.coord
        with coord._mu:
            if cluster_id in self._bound and cluster_id in coord.eng.groups:
                sm = self._sms.get(cluster_id)
                if sm is not None:
                    self._upload_shadow(cluster_id, sm)

    def _upload_shadow(self, cluster_id: int, sm) -> None:
        eng = self.coord.eng
        vals = np.zeros(eng.n_kv_slots, dtype=np.int64)
        vals[: sm.kv_slots] = sm.values
        eng.kv_restore(cluster_id, vals)

    def poll(self) -> None:
        """Advance pending binds (called per coordinator round, under
        coord._mu)."""
        if not self._pending_bind:
            return
        for cid in list(self._pending_bind):
            self._try_bind(cid)

    def _try_bind(self, cluster_id: int) -> None:
        """Complete a pending bind once host apply reaches the bind
        watermark.  The shadow copy may tear against the concurrent
        apply executor, but any op it could miss has index > B — and
        every such op is staged to the device, so the re-apply (a
        contiguous suffix of SETs in log order over a superset image)
        reconverges exactly.  Caller holds coord._mu."""
        b = self._pending_bind.get(cluster_id)
        if b is None:
            return
        node = self.coord._nodes.get(cluster_id)
        sm = self._sms.get(cluster_id)
        if node is None or sm is None:
            return
        try:
            applied = node.sm.get_last_applied()
        except Exception:
            return
        if applied < b:
            return
        eng = self.coord.eng
        if cluster_id not in eng.groups:
            return
        with self._mu:
            if self._pending_bind.pop(cluster_id, None) is None:
                return
            # ops at or below the watermark are already inside the shadow
            # image (and may be OLDER than later shadow writes for the
            # same key) — only the suffix above B restages
            buffered = [
                op for op in self._prebind_ops.pop(cluster_id, [])
                if op[0] > b
            ]
            try:
                self._upload_shadow(cluster_id, sm)
                staged_all = True
                if buffered:
                    idx, keys, vals = zip(*buffered)
                    staged_all = eng.stage_kv_ops(
                        cluster_id, list(idx), list(keys), list(vals)
                    )
                    self.ops_staged += len(buffered)
            except (ValueError, KeyError) as e:
                # out-of-window index / vanished group: stay unbound, the
                # shadow keeps serving; a later promotion re-arms cleanly
                # (raising here would abort the coordinator round)
                dlog.warning(
                    "devsm bind flush failed for %d: %r", cluster_id, e
                )
                return
            if not staged_all:
                # the flush itself overflowed the entry buffers: binding
                # now would reopen the stale-read window handle_ops
                # unbinds over (a queued op can commit before it applies)
                # — re-arm past the batch and keep host-serving instead
                self._prebind_ops[cluster_id] = []
                self._pending_bind[cluster_id] = buffered[-1][0]
                dlog.info(
                    "devsm bind flush overflowed on group %d: re-armed "
                    "at %d", cluster_id, buffered[-1][0],
                )
                return
            self._bound.add(cluster_id)
            self.binds += 1
            self._bind_counts[cluster_id] = (
                self._bind_counts.get(cluster_id, 0) + 1
            )
        dlog.info(
            "devsm bound group %d at watermark %d (%d buffered ops)",
            cluster_id, b, len(buffered),
        )

    # ------------------------------------------------------------------
    # entry-op staging (coordinator drain, under coord._mu)
    # ------------------------------------------------------------------

    def handle_ops(self, cluster_id: int, ops) -> None:
        """Application entries offloaded from ``append_entries``:
        ``ops`` is ``[(index, payload), ...]`` in log order.  Non-op
        payloads fall out here exactly as they no-op in the shadow's
        ``update`` — the two planes stay in lockstep by construction."""
        if cluster_id not in self._sms:
            return
        decoded = []
        for index, payload in ops:
            op = decode_op(payload)
            if op is None:
                continue
            key, value = op
            sm = self._sms.get(cluster_id)
            if sm is None or not (0 <= key < sm.kv_slots):
                continue
            decoded.append((index, key, value))
        if not decoded:
            return
        with self._mu:
            pre = self._prebind_ops.get(cluster_id)
            if pre is not None:
                pre.extend(decoded)
                return
            if cluster_id not in self._bound:
                return  # not leading here; followers never stage
        try:
            idx, keys, vals = zip(*decoded)
            staged_all = self.coord.eng.stage_kv_ops(
                cluster_id, list(idx), list(keys), list(vals)
            )
            self.ops_staged += len(decoded)
        except (ValueError, KeyError) as e:
            # out-of-window index (rebase race) or a vanished group:
            # unbind — the shadow keeps applying, a later promotion
            # rebinds cleanly
            dlog.warning("devsm staging failed for %d: %r", cluster_id, e)
            self.on_unbind(cluster_id)
            return
        if not staged_all:
            # entry-buffer overflow: a queued op may COMMIT before it
            # applies, so the device value plane would momentarily trail
            # the watermark the read-release gate uses — a stale-read
            # window.  Serve from the (always-current) host shadow until
            # host apply passes this batch, then rebind: same protocol
            # as a promotion, with the batch tail as the watermark.
            dlog.info(
                "devsm overflow on group %d: host-serving until apply "
                "reaches %d, then rebinding", cluster_id, decoded[-1][0],
            )
            with self._mu:
                self._bound.discard(cluster_id)
                self._prebind_ops[cluster_id] = []
                self._pending_bind[cluster_id] = decoded[-1][0]
                self._flush_waiters_locked(cluster_id)

    # ------------------------------------------------------------------
    # the KV read service
    # ------------------------------------------------------------------

    def lookup(self, cluster_id: int, key: int, sm) -> int:
        """Serve one read.  Bound groups stage a device KV read and park
        until the capturing round resolves it; everything else (and
        every fallback) reads the host shadow behind the release-floor
        gate."""
        coord = self.coord
        if cluster_id in self._bound:
            waiter = [threading.Event(), None, None]
            slot = None
            with coord._mu:
                if cluster_id in self._bound and (
                    cluster_id in coord.eng.groups
                ):
                    try:
                        slot = coord.eng.stage_kv_read(cluster_id, key)
                    except RuntimeError:
                        slot = None  # backpressure: all capture slots busy
                    if slot is not None:
                        with self._mu:
                            self._waiters[(cluster_id, slot)] = waiter
            if slot is not None:
                coord._pending.set()
                if waiter[0].wait(READ_TIMEOUT_S) and waiter[1] is not None:
                    self.reads_served += 1
                    return int(waiter[1])
                with self._mu:
                    self._waiters.pop((cluster_id, slot), None)
        # shadow fallback, gated: a read released at the DEVICE commit
        # watermark must not read a shadow that host apply hasn't caught
        # up to yet (the unbind-between-release-and-lookup race)
        self.read_fallbacks += 1
        node = coord._nodes.get(cluster_id)
        floor = getattr(node, "devsm_release_floor", 0) if node else 0
        if floor:
            deadline = time.monotonic() + READ_TIMEOUT_S
            while time.monotonic() < deadline:
                try:
                    if node.sm.get_last_applied() >= floor:
                        break
                except Exception:
                    break
                time.sleep(0.001)
        return int(sm.values[key])

    def deliver(self, res) -> None:
        """Resolve parked readers from a harvest's capture egress
        (round thread, outside coord._mu)."""
        if res is None or res.kv_cids is None:
            return
        for cid, slot, value, index in res.kv_reads:
            with self._mu:
                waiter = self._waiters.pop((cid, slot), None)
            if waiter is not None:
                waiter[1] = value
                waiter[2] = index
                waiter[0].set()

    def _flush_waiters_locked(self, cluster_id: int) -> None:
        """Wake a group's parked readers empty-handed (they take the
        gated shadow fallback).  Caller holds self._mu."""
        for key in [k for k in self._waiters if k[0] == cluster_id]:
            waiter = self._waiters.pop(key)
            waiter[0].set()
