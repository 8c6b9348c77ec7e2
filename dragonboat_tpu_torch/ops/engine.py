"""Host side of the batched quorum engine on PyTorch.

Counterpart: ``dragonboat_tpu/ops/engine.py``.  Host ingest (queues ->
compact event batches) -> ONE device launch per round, or one per K-round
block -> host egress (commit advances, election/heartbeat/step-down
flags).  Rare transitions (membership change, becoming leader/candidate,
snapshot restore, index rebase) mutate a numpy mirror row and are copied
onto the device tensors before the next launch.

The device boundary:

* uploads are pinned host tensors copied ``non_blocking`` on the current
  stream; dirty mirror rows land with ``index_copy_``;
* the kernels update the state tensors IN PLACE (the reference donated
  them), so ``StepOutputs.committed`` is the state's own ``committed``;
* egress: right after each launch, on the same stream, the commit
  watermark and the (5, G) flag block are copied into pinned host memory
  and a CUDA event is recorded; ``harvest`` (and every host read of
  device state) waits on that event.  The copy is enqueued BEFORE the
  next launch because the next block updates ``committed`` in place: a
  copy enqueued later would read the next block's watermarks;
* with the telemetry fold on, the fold's fixed-size aggregate block is
  copied the same way, under the same event; ``telem_snapshot`` turns
  the last harvested one into a dict;
* a dispatch that ran the read plane copies its (2, G, S) read egress
  (reads confirmed per slot, the index they were released at) the same
  way; ``StepResult.reads`` names them by cluster id, slot and absolute
  index;
* a dispatch that ran the device state machine copies its kv egress (per
  KV read slot the captured value and watermark, per row the entries
  applied) the same way; ``StepResult.kv_reads`` names the captures by
  cluster id, slot, value and absolute index;
* ``device=None`` means CUDA; the engine raises when there is none.  The
  CPU runs the plain versions only when ``device="cpu"`` is asked for.

The read, devsm, hier and telemetry planes sit behind one-way latches
(the first read ingress, the first kv ingress, ``set_hier``,
``enable_telem``), as in the reference: until a latch flips, every
dispatch runs without the plane and the row syncs skip its fields.
ReadIndex batches ride pending-read slots (``stage_read``, ``read_ack``):
staged reads force the dense step (K1) or ride the K-round block (K3),
which confirm them in the dispatch that advances commits.  Device state
machine ops (``stage_kv_ops``: SETs of a key slot at a log index) wait in
a per-row entry buffer and apply in the dispatch whose commit passes
them; KV reads (``stage_kv_read``) capture the post-apply value.  They
force the dense step or ride the block, and every dispatch carries the
plane while an entry sits buffered on the device.  Planes of later slices
(observability, device profiling, warm-up compilation, ``sharding=``)
raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..platform import pick_device
from . import _build
from .kernels import (
    TELEM_HEAD,
    TELEM_LAG_BUCKETS,
    TELEM_STATES,
    TELEM_TOPK,
    flag_block,
    kv_block,
    quorum_multiround,
    quorum_step,
    quorum_step_dense,
    read_block,
    telem_block,
)
from .state import (
    CANDIDATE,
    DEVSM_PLANE_FIELDS,
    FIELDS,
    FOLLOWER,
    HIER_PLANE_FIELDS,
    KV_ENT_SLOTS,
    KV_READ_SLOTS,
    KV_SLOTS,
    LEADER,
    READ_PLANE_FIELDS,
    READ_SLOTS,
    TELEM_PLANE_FIELDS,
    VOTE_GRANT,
    VOTE_NONE,
    VOTE_REJECT,
    HostMirror,
    QuorumState,
)

# Event batches are padded to fixed sizes (the reference's jit shape).
DEFAULT_EVENT_CAP = 4096

# Rebase a row when relative indexes pass this (well clear of int32 max).
REBASE_THRESHOLD = 1 << 30

_TORCH_OF = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
             np.dtype(np.int8): torch.int8, np.dtype(np.bool_): torch.bool}


def _later(name: str, what: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name}: {what} is ported in a later slice (ROADMAP.md queue A)"
        )

    method.__name__ = name
    method.__doc__ = f"Not in this slice: {what}."
    return method


@dataclass
class GroupInfo:
    """Counterpart: ``dragonboat_tpu/ops/engine.py`` ``GroupInfo``."""

    cluster_id: int
    row: int
    slots: Dict[int, int]            # node_id -> peer slot
    base: int = 0                    # uint64 absolute index of rel 0
    node_ids: List[int] = field(default_factory=list)


class StepResult:
    """Egress of one dispatch, in absolute-index / cluster-id terms
    (counterpart: ``dragonboat_tpu/ops/engine.py`` ``StepResult``).

    ``commit``, ``reads`` and ``kv_reads`` materialize lazily from the
    vectorized egress arrays."""

    __slots__ = (
        "won", "lost", "elect", "heartbeat", "demote",
        "_commit_cids", "_commit_abs", "_commit_dict",
        "read_cids", "read_slots", "read_index_abs", "read_counts",
        "_reads_list",
        "kv_cids", "kv_slots", "kv_vals", "kv_index_abs",
        "_kv_reads_list", "kv_applied_ops",
    )

    def __init__(self):
        self._commit_cids = None   # np (n,) int64 cluster ids, or None
        self._commit_abs = None    # np (n,) int64 absolute committed
        self._commit_dict: Optional[Dict[int, int]] = None
        self.won: List[int] = []
        self.lost: List[int] = []
        self.elect: List[int] = []
        self.heartbeat: List[int] = []
        self.demote: List[int] = []
        # confirmed-read egress (None when the dispatch ran read-free):
        # per confirmed pending-read slot, the cluster, the slot, the
        # ABSOLUTE release index and the reads the batch carried
        self.read_cids: Optional[np.ndarray] = None       # (n,) int64
        self.read_slots: Optional[np.ndarray] = None      # (n,) int64
        self.read_index_abs: Optional[np.ndarray] = None  # (n,) int64
        self.read_counts: Optional[np.ndarray] = None     # (n,) int64
        self._reads_list = None
        # devsm KV read egress (None when the dispatch ran kv-free): per
        # captured read slot, the cluster, the slot, the value and the
        # ABSOLUTE watermark it reflects; and the ops applied this dispatch
        self.kv_cids: Optional[np.ndarray] = None         # (n,) int64
        self.kv_slots: Optional[np.ndarray] = None        # (n,) int64
        self.kv_vals: Optional[np.ndarray] = None         # (n,) int64
        self.kv_index_abs: Optional[np.ndarray] = None    # (n,) int64
        self._kv_reads_list = None
        self.kv_applied_ops: int = 0

    @property
    def commit(self) -> Dict[int, int]:
        """cluster_id -> new committed (abs); built on first access."""
        if self._commit_dict is None:
            if self._commit_cids is None or not len(self._commit_cids):
                self._commit_dict = {}
            else:
                self._commit_dict = dict(
                    zip(self._commit_cids.tolist(), self._commit_abs.tolist())
                )
        return self._commit_dict

    @property
    def reads(self) -> List[Tuple[int, int, int, int]]:
        """Confirmed reads as ``(cluster_id, slot, abs_index, count)``
        tuples; built on first access."""
        if self._reads_list is None:
            if self.read_cids is None or not len(self.read_cids):
                self._reads_list = []
            else:
                self._reads_list = list(zip(
                    self.read_cids.tolist(), self.read_slots.tolist(),
                    self.read_index_abs.tolist(), self.read_counts.tolist(),
                ))
        return self._reads_list

    @property
    def kv_reads(self) -> List[Tuple[int, int, int, int]]:
        """Captured devsm KV reads as ``(cluster_id, slot, value,
        abs_index)`` tuples; built on first access."""
        if self._kv_reads_list is None:
            if self.kv_cids is None or not len(self.kv_cids):
                self._kv_reads_list = []
            else:
                self._kv_reads_list = list(zip(
                    self.kv_cids.tolist(), self.kv_slots.tolist(),
                    self.kv_vals.tolist(), self.kv_index_abs.tolist(),
                ))
        return self._kv_reads_list


class MultiRoundResult(StepResult):
    """Egress of one K-round fused dispatch (``step_rounds``); counterpart:
    ``dragonboat_tpu/ops/engine.py`` ``MultiRoundResult``.
    ``committed_rel`` is the final (G,) relative watermark vector and
    ``commit_rows`` the rows that advanced vs the pre-block host twin.
    Flags are OR-accumulated across the block's rounds."""

    __slots__ = ("rounds", "committed_rel", "commit_rows")

    def __init__(self, rounds: int):
        super().__init__()
        self.rounds = rounds
        self.committed_rel: Optional[np.ndarray] = None  # (G,) i32
        self.commit_rows: Optional[np.ndarray] = None    # (n,) changed rows


class _RoundBuf:
    """One closed ingest round awaiting the fused multi-round dispatch
    (counterpart: ``dragonboat_tpu/ops/engine.py`` ``_RoundBuf``):
    epoch-filtered ack arrays, first-wins-deduped votes, the round's
    leader-recycle records, optionally the precomputed flat (row·P + slot)
    cell vector, the round's staged ReadIndex batches and heartbeat echoes,
    and its devsm entry ops and KV reads, as flat arrays (None = none)."""

    __slots__ = ("rows", "slots", "rels", "votes", "churn", "cells", "reads",
                 "racks", "kvents", "kvreads")

    def __init__(self, rows, slots, rels, votes, churn, cells=None,
                 reads=None, racks=None, kvents=None, kvreads=None):
        self.rows = rows
        self.slots = slots
        self.rels = rels
        self.votes = votes   # list[(row, slot, grant)]
        self.churn = churn   # list[(row, term, term_start_rel, last_rel)]
        self.cells = cells   # np (n,) int64 row*P+slot, or None
        self.reads = reads   # (rows, slots, rels, counts) int32 arrays
        self.racks = racks   # (rows, rslots, peers) int32 arrays
        self.kvents = kvents    # (rows, slots, rels, keys, vals) int32 arrays
        self.kvreads = kvreads  # (rows, rslots, keys) int32 arrays


class _Egress:
    """One launch's watermark, flag block, read egress block, kv egress
    block and telemetry aggregate (the last three None without their
    plane) on their way to the host.  On CUDA: pinned host tensors filled
    by ``non_blocking`` copies enqueued on the launch's stream, plus the
    event :meth:`wait` blocks on."""

    __slots__ = ("committed", "flags", "reads", "kv", "kv_r", "telem", "event")

    def __init__(self, out, device: torch.device):
        telem = None if out.telem is None else telem_block(out.telem)
        reads = None if out.read_done_count is None else read_block(out)
        kv = None if out.kv_read_val is None else kv_block(out)
        self.kv_r = None if kv is None else out.kv_read_val.shape[1]
        if device.type == "cuda":
            g = out.committed.shape[0]
            self.committed = torch.empty((g,), dtype=torch.int32, pin_memory=True)
            self.flags = torch.empty((5, g), dtype=torch.bool, pin_memory=True)
            self.committed.copy_(out.committed, non_blocking=True)
            self.flags.copy_(flag_block(out), non_blocking=True)
            self.reads = self.kv = self.telem = None
            if reads is not None:
                self.reads = torch.empty(reads.shape, dtype=torch.int32, pin_memory=True)
                self.reads.copy_(reads, non_blocking=True)
            if kv is not None:
                self.kv = torch.empty(kv.shape, dtype=torch.int32, pin_memory=True)
                self.kv.copy_(kv, non_blocking=True)
            if telem is not None:
                self.telem = torch.empty(telem.shape, dtype=torch.int32, pin_memory=True)
                self.telem.copy_(telem, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))
        else:
            # the state's committed is updated in place by the next step
            self.committed = out.committed.clone()
            self.flags = flag_block(out)
            self.reads = reads
            self.kv = kv
            self.telem = telem
            self.event = None

    def wait(self):
        """(committed (G,) int32, flags (5, G) bool, the read egress
        (2, G, S) int32 or None, the kv egress (read values (G, R), their
        indexes (G, R), applied (G,)) int32 or None, the telemetry block
        (TELEM_HEAD + 2k,) int32 or None) as numpy arrays."""
        if self.event is not None:
            self.event.synchronize()
        reads = None if self.reads is None else self.reads.numpy()
        telem = None if self.telem is None else self.telem.numpy()
        kv = None
        if self.kv is not None:
            g = self.committed.shape[0]
            n = g * self.kv_r
            flat = self.kv.numpy()
            kv = (flat[:n].reshape(g, self.kv_r), flat[n:2 * n].reshape(g, self.kv_r),
                  flat[2 * n:])
        return self.committed.numpy(), self.flags.numpy(), reads, kv, telem


class BatchedQuorumEngine:
    """Device-resident quorum state for up to ``n_groups`` Raft groups.

    Usage::

        eng = BatchedQuorumEngine(n_groups=1024, n_peers=5)  # on CUDA
        eng.add_group(cid, node_ids=[1,2,3], self_id=1, election_timeout=10)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
        eng.ack(cid, node_id=2, index=5)      # ReplicateResp ingest
        out = eng.step()                       # one device dispatch
        out.commit[cid]                        # -> advanced commit index
    """

    def __init__(
        self,
        n_groups: int,
        n_peers: int,
        event_cap: int = DEFAULT_EVENT_CAP,
        sharding=None,
        device_ticks: bool = True,
        dense_ingest: str | bool = "auto",
        n_read_slots: int = READ_SLOTS,
        n_kv_slots: int = KV_SLOTS,
        n_kv_ents: int = KV_ENT_SLOTS,
        n_kv_reads: int = KV_READ_SLOTS,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError(
                "sharding=: the mesh dispatch plane is ported in a later "
                "slice (ROADMAP.md queue A)"
            )
        if not (
            dense_ingest is True or dense_ingest is False or dense_ingest == "auto"
        ):
            raise ValueError(
                f"dense_ingest must be True, False, or 'auto', got {dense_ingest!r}"
            )
        self.device = pick_device(device)
        self.n_groups = n_groups
        self.n_peers = n_peers
        self.n_read_slots = n_read_slots
        self.n_kv_slots = n_kv_slots
        self.n_kv_ents = n_kv_ents
        self.n_kv_reads = n_kv_reads
        self.event_cap = event_cap
        #: dense-ingestion policy: collapse a round's acks into a (G,P)
        #: max matrix and dispatch the dense kernel.  "auto" picks per
        #: dispatch by byte volume: dense uploads 6·G·P bytes vs ~13 per
        #: sparse event, so dense wins once the staged acks outnumber
        #: ~G·P/2.  True forces dense, False never.
        self.dense_ingest = dense_ingest
        self._dense_threshold = (n_groups * n_peers) // 2
        #: whether this engine EVER ticks on device: contact events are
        #: one-shot, so a ticking engine applies the election-clock reset
        #: on every round (track_contact), including do_tick=False rounds
        self.device_ticks = device_ticks
        self._pinned = self.device.type == "cuda"
        self.mirror = HostMirror(
            n_groups, n_peers, n_read_slots, n_kv_slots, n_kv_ents
        )
        self._dev: QuorumState = self.mirror.to_device(self.device)
        self._cache_stale = False
        self.groups: Dict[int, GroupInfo] = {}
        self.rows: Dict[int, GroupInfo] = {}
        # vectorized row -> (cluster_id, base) translation for egress
        self._row_cid = np.full((n_groups,), -1, np.int64)
        self._row_base = np.zeros((n_groups,), np.int64)
        #: host twin of dev.committed: refreshed by every egress and by
        #: _upload_dirty, so step() never reads the device just to learn
        #: the previous watermarks
        self._committed_cache = np.zeros((n_groups,), np.int32)
        self._free = list(range(n_groups - 1, -1, -1))
        self._dirty: set[int] = set()
        # rows bulk-pulled from the device since the last dispatch
        self._synced: set[int] = set()
        # per-row staging epoch: a state transition bumps it, and events
        # staged under an older epoch are filtered at dispatch
        self._row_epoch = np.zeros((n_groups,), np.int32)
        self._acks: List[Tuple[int, int, int, int]] = []  # row, slot, rel, ep
        self._votes: List[Tuple[int, int, int, int]] = []  # row, slot, g, ep
        self._voted_cells: dict = {}  # (row, slot) -> staging epoch
        self._ack_blocks: List[Tuple[np.ndarray, ...]] = []
        # closed ingest rounds awaiting ONE fused dispatch
        self._round_blocks: List[_RoundBuf] = []
        # leader-recycle records of the CURRENT open round (stage_recycle)
        self._churn: List[Tuple[int, int, int, int]] = []
        self._churn_rows: set = set()  # one recycle per row per round
        # rows with an UNDISPATCHED recycle anywhere in the backlog: their
        # mirror rows are authoritative until the block dispatches
        self._churn_pending: set = set()
        # in-flight pipelined dispatch: (_Egress, prev_committed, row_cid
        # snapshot, row_base snapshot, n_rounds)
        self._inflight = None
        # --- device read plane staging ---------------------------------
        # ReadIndex batches and heartbeat echoes of the CURRENT open
        # round; epoch columns filter events staged before a transition,
        # exactly like the ack/vote buffers
        self._read_stages: List[Tuple[int, int, int, int, int]] = []
        self._read_stage_blocks: List[Tuple[np.ndarray, ...]] = []
        self._read_echoes: List[Tuple[int, int, int, int]] = []
        self._read_echo_blocks: List[Tuple[np.ndarray, ...]] = []
        # host slot bookkeeping: a slot is BUSY from stage until its
        # staged echoes reach quorum (the device sees only echoes staged
        # here, so the host predicts the confirmation without a readback)
        # and is reusable only in a LATER round (_read_freed_round)
        self._read_busy = np.zeros((n_groups, n_read_slots), bool)
        self._read_echo_host = np.zeros((n_groups, n_read_slots, n_peers), bool)
        self._read_next_slot = np.zeros((n_groups,), np.int32)
        self._read_freed_round = np.full((n_groups, n_read_slots), -1, np.int64)
        self._round_seq = 0
        # LATCH: set on the first read-plane ingress (stage/echo/cancel),
        # never reset.  Until then the read arrays are all-zero on both
        # sides, the row syncs skip them and K3 skips their recycle reset.
        self._read_plane_used = False
        # LATCH: set on the first devsm ingress (stage_kv_ops,
        # stage_kv_read, kv_restore), never reset.  Until then the kv
        # arrays are at their reset values on both sides, every dispatch
        # runs has_kv=False, the row syncs skip the kv fields and K3 skips
        # their recycle reset (purge_kv).
        self._devsm_used = False
        # host record of the rel index staged in each device entry-buffer
        # slot (-1 = free): slot ``rel % E`` is reusable once the HARVESTED
        # watermark has passed its tenant.  Ops whose slot is occupied
        # queue per row in _kv_queue and drain, in log order, as harvests
        # free slots.
        self._kv_ent_rel = np.full((n_groups, n_kv_ents), -1, np.int64)
        self._kv_queue: Dict[int, deque] = {}
        # kv ops and reads of the CURRENT open round, epoch-tagged:
        # (row, slot, rel, key, val, epoch) / (row, rslot, key, epoch)
        self._kv_stage: List[Tuple[int, int, int, int, int, int]] = []
        self._kv_read_stage: List[Tuple[int, int, int, int]] = []
        # a KV read slot is busy from stage until the harvest that
        # reports its capture (or a row transition drops it)
        self._kv_read_busy = np.zeros((n_groups, n_kv_reads), bool)
        #: called with the StepResult of EVERY harvest that carried kv
        #: captures, internal harvests included
        self.kv_egress_hook = None
        # LATCH: set by the first enabling set_hier, never reset.  Until
        # then near/sub_quorum are all-zero on both sides, every dispatch
        # runs has_hier=False and the row syncs skip the hier fields.
        self._hier_used = False
        # LATCH: set by enable_telem, never reset; the same contract for
        # telem_prev_committed and has_telem.
        self._telem_used = False
        #: top-K width of the fold's drill-down egress
        self.n_telem_topk = TELEM_TOPK
        # last harvested aggregate: (block, dispatch-time row_cid, rounds,
        # mono, seq), turned into the snapshot dict by telem_snapshot
        self._last_telem = None
        self._telem_raw = None
        self._telem_seq = 0

    # ------------------------------------------------------------------
    # planes of later slices
    # ------------------------------------------------------------------

    enable_obs = _later("enable_obs", "device-plane observability")
    enable_devprof = _later("enable_devprof", "the device profiling plane")
    warmup_fused = _later("warmup_fused", "warm-up compilation")
    warmup_devsm = _later("warmup_devsm", "warm-up compilation")
    warm_plan = _later("warm_plan", "warm-up compilation")
    lower_variant = _later("lower_variant", "the device profiling plane")

    # ------------------------------------------------------------------
    # device telemetry fold
    # ------------------------------------------------------------------

    def enable_telem(self, topk: Optional[int] = None) -> None:
        """Flip the telemetry latch: every later dispatch runs the fold
        (``kernels.telem_fold``) after its step and ships the fixed-size
        aggregate with its egress.  One-way.  ``topk`` sets the fold's
        drill-down width (default ``kernels.TELEM_TOPK``)."""
        if topk is not None:
            self.n_telem_topk = int(topk)
        self._telem_used = True

    @property
    def telem_enabled(self) -> bool:
        return self._telem_used

    def telem_snapshot(self) -> Optional[dict]:
        """The last harvested telemetry aggregate as a dict, or None
        before the first fold (or while the plane is off).  Passive: it
        refreshes when a dispatch's egress is harvested; ``seq`` and
        ``mono`` say how fresh it is.  The dict is built here, at the
        consumer's cadence, not on the dispatch path."""
        raw = self._telem_raw
        if raw is not None:
            self._telem_raw = None
            self._ingest_telem(*raw)
        t = self._last_telem
        return dict(t) if t is not None else None

    def _stage_telem(self, block: np.ndarray, row_cid: np.ndarray,
                     rounds: int) -> None:
        """Record one harvested aggregate block.  ``row_cid`` is the
        DISPATCH-TIME row -> cluster id capture, so a re-registration
        between dispatch and snapshot cannot mislabel a drill-down row."""
        self._telem_seq += 1
        self._telem_raw = (
            block, row_cid, rounds, time.monotonic(), self._telem_seq
        )

    def _ingest_telem(self, block, row_cid, rounds, mono, seq) -> None:
        """Translate an aggregate block into the snapshot dict."""
        b, s = TELEM_LAG_BUCKETS, TELEM_LAG_BUCKETS + TELEM_STATES
        k = (block.shape[0] - TELEM_HEAD) // 2
        state_counts = block[b:s].astype(np.int64)
        rows = block[TELEM_HEAD:TELEM_HEAD + k]
        lags = block[TELEM_HEAD + k:]
        topk = [
            (int(row_cid[r]), int(lag))
            for r, lag in zip(rows, lags)
            if r >= 0 and row_cid[r] >= 0
        ]
        self._last_telem = {
            "seq": seq,
            "mono": mono,
            "rounds": int(rounds),
            "groups": int(state_counts.sum()),
            "lag_hist": [int(v) for v in block[:b]],
            "state_counts": [int(v) for v in state_counts],
            "stalled": int(block[s]),
            "read_slots": int(block[s + 1]),
            "kv_ents": int(block[s + 2]),
            "topk": topk,
        }

    @property
    def fused_ready(self) -> bool:
        """True once the kernels are built (always on the CPU, which runs
        the plain versions and builds nothing)."""
        return self.device.type == "cpu" or _build.loaded()

    @property
    def kv_fused_ready(self) -> bool:
        """True once the device state machine's kernel is built: it is
        part of the one library, so this is :attr:`fused_ready`."""
        return self.fused_ready

    @property
    def dev(self) -> QuorumState:
        return self._dev

    @dev.setter
    def dev(self, st: QuorumState) -> None:
        """External state assignment: the host committed twin can no
        longer be trusted, so the next step re-reads it once."""
        self._harvest_inflight()
        self._dev = st
        self._cache_stale = True
        self._synced.clear()

    # ------------------------------------------------------------------
    # group lifecycle (rare path, host scalar)
    # ------------------------------------------------------------------

    def add_group(
        self,
        cluster_id: int,
        node_ids: List[int],
        self_id: int,
        election_timeout: int = 10,
        heartbeat_timeout: int = 1,
        rand_timeout: Optional[int] = None,
        check_quorum: bool = False,
        witnesses: Tuple[int, ...] = (),
        observers: Tuple[int, ...] = (),
    ) -> GroupInfo:
        if cluster_id in self.groups:
            raise ValueError(f"group {cluster_id} already registered")
        if not self._free:
            raise RuntimeError("quorum engine full")
        row = self._free.pop()
        all_ids = sorted(set(node_ids) | set(witnesses) | set(observers))
        if len(all_ids) > self.n_peers:
            raise ValueError("too many peers for tensor width")
        slots = {nid: i for i, nid in enumerate(all_ids)}
        gi = GroupInfo(cluster_id, row, slots, node_ids=all_ids)
        self.groups[cluster_id] = gi
        self.rows[row] = gi
        self._row_cid[row] = cluster_id
        self._row_base[row] = 0

        a = self.mirror.arrays
        a["live"][row] = True
        a["node_state"][row] = FOLLOWER
        a["term"][row] = 0
        a["committed"][row] = 0
        a["last_index"][row] = 0
        a["term_start"][row] = 0
        n_voting = len(set(node_ids) | set(witnesses))
        a["quorum"][row] = n_voting // 2 + 1
        a["self_slot"][row] = slots[self_id]
        a["election_tick"][row] = 0
        a["heartbeat_tick"][row] = 0
        a["election_timeout"][row] = election_timeout
        a["heartbeat_timeout"][row] = heartbeat_timeout
        a["rand_timeout"][row] = (
            rand_timeout if rand_timeout is not None else election_timeout * 2
        )
        is_voter = self_id in node_ids or self_id in witnesses
        a["electable"][row] = is_voter and self_id not in witnesses
        a["check_quorum_on"][row] = check_quorum
        a["match"][row, :] = 0
        a["next"][row, :] = 1
        a["voting"][row, :] = False
        a["present"][row, :] = False
        a["active"][row, :] = False
        a["votes"][row, :] = VOTE_NONE
        for nid, slot in slots.items():
            a["present"][row, slot] = True
            a["voting"][row, slot] = nid not in observers
        if self._read_plane_used:  # else provably already clear
            self.mirror.clear_reads(row)
            self._reset_read_rows([row])
        if self._devsm_used:  # a fresh registration starts from an empty KV
            self.mirror.clear_kv(row)
            self._reset_kv_rows([row])
        if self._hier_used:  # else provably already clear
            self.mirror.clear_hier(row)
        self._dirty.add(row)
        return gi

    def _purge_row_events(self, row: int) -> None:
        """Invalidate queued acks/votes for a row on every state transition
        (and removal): events staged before the transition belong to the
        old term.  O(1): the row's staging epoch is bumped and stale-epoch
        events are filtered in one vectorized pass at dispatch.  Pending
        READS die with the transition too (the scalar twin builds a fresh
        ``ReadIndex``): the slot bookkeeping and the mirror's read fields
        reset here, and staged read/echo events fall to the epoch filter.
        Devsm: BUFFERED entry ops die (they sit above the watermark, a log
        suffix the next leadership may rewrite) while the applied values
        stay; queued ops, staged slots and pending captures drop."""
        self._row_epoch[row] += 1
        self._reset_read_rows([row])
        if self._read_plane_used:  # else provably already clear
            self.mirror.clear_reads(row)
        self._reset_kv_rows([row])
        if self._devsm_used:  # else provably already clear
            self.mirror.clear_kv_ents(row)

    def _drop_churn_records(self, row: int, drop_events: bool = False) -> None:
        """Strip every undispatched recycle record for ``row`` — from the
        open round AND from closed blocks awaiting dispatch.

        ``drop_events=True`` additionally strips the row's ack/vote events
        from CLOSED blocks: when the recycle collapses to pre-block
        ordering (a rare-path mutation, ``_sync_row``) the row's fresh
        state uploads before the block, so old-tenant events sealed into
        earlier rounds would otherwise reach the NEW tenant."""
        if row in self._churn_rows:
            self._churn = [c for c in self._churn if c[0] != row]
            self._churn_rows.discard(row)
        if row in self._churn_pending:
            for b in self._round_blocks:
                if b.churn:
                    b.churn = [c for c in b.churn if c[0] != row]
            self._churn_pending.discard(row)
        if drop_events:
            for b in self._round_blocks:
                if b.rows.size:
                    keep = b.rows != row
                    if not keep.all():
                        b.rows = b.rows[keep]
                        b.slots = b.slots[keep]
                        b.rels = b.rels[keep]
                        if b.cells is not None:
                            b.cells = b.cells[keep]
                if b.votes:
                    b.votes = [v for v in b.votes if v[0] != row]
                self._purge_block_reads(b, row)
                self._purge_block_kv(b, row)

    @staticmethod
    def _purge_block_reads(b, row: int) -> None:
        """Drop ``row``'s staged read batches and echoes from one sealed
        round block (reads are droppable by contract: the scalar path
        drops them on a leader change and clients retry)."""
        if b.reads is not None and b.reads[0].size:
            keep = b.reads[0] != row
            if not keep.all():
                b.reads = tuple(a[keep] for a in b.reads)
        if b.racks is not None and b.racks[0].size:
            keep = b.racks[0] != row
            if not keep.all():
                b.racks = tuple(a[keep] for a in b.racks)

    def remove_group(self, cluster_id: int) -> None:
        gi = self.groups.pop(cluster_id)
        # an undispatched recycle of this row is moot, and events sealed
        # into closed blocks die with the tenant
        self._drop_churn_records(gi.row, drop_events=True)
        del self.rows[gi.row]
        self.mirror.arrays["live"][gi.row] = False
        self._dirty.add(gi.row)
        self._purge_row_events(gi.row)
        self._row_cid[gi.row] = -1
        self._free.append(gi.row)

    # ------------------------------------------------------------------
    # rare-path row mutations (host scalar, mask-update tensors)
    # ------------------------------------------------------------------

    def _rel(self, gi: GroupInfo, index: int) -> int:
        rel = index - gi.base
        if rel < 0:
            raise ValueError(f"index {index} below base {gi.base}")
        if rel >= REBASE_THRESHOLD:
            raise ValueError("index needs rebase before ingest")
        return rel

    def set_leader(
        self, cluster_id: int, term: int, term_start: int, last_index: int
    ) -> None:
        """Promote to leader (twin: ``become_leader`` raft.go:1027-1045)."""
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        a["node_state"][row] = LEADER
        a["term"][row] = term
        a["term_start"][row] = self._rel(gi, term_start)
        a["last_index"][row] = self._rel(gi, last_index)
        a["election_tick"][row] = 0
        a["heartbeat_tick"][row] = 0
        a["votes"][row, :] = VOTE_NONE
        # reset_remotes: next = last+1 for all, self match = last,
        # activity cleared (raft.go:991-1010)
        a["match"][row, :] = 0
        a["next"][row, :] = self._rel(gi, last_index) + 1
        a["match"][row, a["self_slot"][row]] = self._rel(gi, last_index)
        a["active"][row, :] = False
        self._purge_row_events(row)
        self._dirty.add(row)

    def set_hier(self, cluster_id: int, near_ids, sub_quorum: int) -> None:
        """Install a row's hier sub-quorum geometry: the near-domain voter
        mask and the domain-majority size the commit rule runs
        (``kernels._finish_step`` ``has_hier``).  ``sub_quorum=0`` turns
        the rule off for the row; on an engine whose latch is down that
        is a no-op, so hier-off hosts never run the hier kernels."""
        if sub_quorum <= 0 and not self._hier_used:
            return
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        a["near"][row, :] = False
        for nid in near_ids:
            slot = gi.slots.get(nid)
            if slot is not None:
                a["near"][row, slot] = True
        a["sub_quorum"][row] = max(int(sub_quorum), 0)
        if sub_quorum > 0:
            self._hier_used = True
        self._dirty.add(row)

    def set_candidate(self, cluster_id: int, term: int) -> None:
        """Start campaigning (twin: ``become_candidate``); the self-vote is
        ingested like any other vote event."""
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        a["node_state"][row] = CANDIDATE
        a["term"][row] = term
        a["votes"][row, :] = VOTE_NONE
        a["election_tick"][row] = 0
        self._purge_row_events(row)
        self._dirty.add(row)

    def set_follower(self, cluster_id: int, term: int) -> None:
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        a["node_state"][row] = FOLLOWER
        a["term"][row] = term
        a["votes"][row, :] = VOTE_NONE
        a["election_tick"][row] = 0
        self._purge_row_events(row)
        self._dirty.add(row)

    def set_randomized_timeout(self, cluster_id: int, timeout: int) -> None:
        """Host-seeded randomized election timeout (the PRNG stays on the
        host and seeded)."""
        gi = self.groups[cluster_id]
        self._sync_row(gi.row)
        self.mirror.arrays["rand_timeout"][gi.row] = timeout
        self._dirty.add(gi.row)

    def restore_progress(
        self, cluster_id: int, committed: int, last_index: int
    ) -> None:
        """Snapshot-restore / log-truncation repair of the watermarks."""
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        a["committed"][row] = self._rel(gi, committed)
        a["last_index"][row] = self._rel(gi, last_index)
        self._dirty.add(row)

    def rebase(self, cluster_id: int) -> None:
        """Shift a row's base up to its committed watermark so relative
        int32 indexes stay far from overflow."""
        gi = self.groups[cluster_id]
        a = self.mirror.arrays
        row = gi.row
        self._sync_row(row)
        shift = int(a["committed"][row])
        if shift <= 0:
            return
        gi.base += shift
        self._row_base[row] = gi.base
        for f in ("committed", "last_index", "term_start"):
            a[f][row] = max(0, int(a[f][row]) - shift)
        a["match"][row, :] = np.maximum(a["match"][row, :] - shift, 0)
        a["next"][row, :] = np.maximum(a["next"][row, :] - shift, 1)
        if self._read_plane_used:
            # pending-read watermarks shift with the base; clamping to the
            # new floor only ever rewrites a release index UP, which
            # ReadIndex permits
            a["read_index"][row, :] = np.maximum(a["read_index"][row, :] - shift, 0)
        if self._devsm_used:
            # buffered entries shift with the base (they sit above the old
            # watermark, the shift, so they stay >= 1); host slot records
            # the shift proves applied free outright
            ents = a["kv_ent_index"][row, :]
            a["kv_ent_index"][row, :] = np.where(ents >= 0, ents - shift, -1)
            kv = self._kv_ent_rel[row]
            self._kv_ent_rel[row] = np.where((kv >= 0) & (kv - shift > 0), kv - shift, -1)
            q = self._kv_queue.get(row)
            if q:
                self._kv_queue[row] = deque((rel - shift, key, val) for rel, key, val in q)
        self._dirty.add(row)

    # ------------------------------------------------------------------
    # event ingest
    # ------------------------------------------------------------------

    def ack(self, cluster_id: int, node_id: int, index: int) -> None:
        """ReplicateResp success / local append (self ack).  Acks below the
        rebased floor clamp to rel 0: a max no-op that still marks the
        peer active."""
        gi = self.groups[cluster_id]
        rel = max(0, index - gi.base)
        if rel >= REBASE_THRESHOLD:
            raise ValueError(f"index {index} needs rebase (base {gi.base})")
        self._acks.append(
            (gi.row, gi.slots[node_id], rel, int(self._row_epoch[gi.row]))
        )

    def ack_block(self, rows, slots, rels) -> None:
        """Vectorized bulk ack ingest (numpy arrays in row/slot space).
        Caller contract: rows are live group rows, slots valid for their
        rows, ``rels`` already rebased; bounds are validated vectorized."""
        rows = np.asarray(rows)
        slots = np.asarray(slots)
        rels = np.asarray(rels)
        if not (rows.shape == slots.shape == rels.shape):
            raise ValueError("ack_block arrays must share a shape")
        if rels.size and rels.max() >= REBASE_THRESHOLD:
            raise ValueError("ack_block rel out of range (rebase needed)")
        if rows.size and (rows.min() < 0 or rows.max() >= self.n_groups):
            raise ValueError("ack_block row out of range")
        if slots.size and (slots.min() < 0 or slots.max() >= self.n_peers):
            raise ValueError("ack_block slot out of range")
        rels = np.maximum(rels, 0)
        rows32 = rows.astype(np.int32)
        self._ack_blocks.append(
            (rows32, slots.astype(np.int32), rels.astype(np.int32),
             self._row_epoch[rows32].copy())
        )

    def vote(self, cluster_id: int, node_id: int, granted: bool) -> None:
        """First vote per (group, peer) wins (twin: ``handle_vote_resp``).
        The kernels' first-wins guard reads pre-batch state, so duplicates
        within a batch are deduped here: the first event per cell stays."""
        gi = self.groups[cluster_id]
        cell = (gi.row, gi.slots[node_id])
        ep = int(self._row_epoch[gi.row])
        if self._voted_cells.get(cell) == ep:
            return
        self._voted_cells[cell] = ep
        self._votes.append(
            (cell[0], cell[1], VOTE_GRANT if granted else VOTE_REJECT, ep)
        )

    def heartbeat_resp(self, cluster_id: int, node_id: int) -> None:
        """Heartbeat response: an ack at rel 0 marks the peer active."""
        gi = self.groups[cluster_id]
        self._acks.append(
            (gi.row, gi.slots[node_id], 0, int(self._row_epoch[gi.row]))
        )

    def leader_contact(self, cluster_id: int) -> None:
        """A follower heard from its leader: reset the row's election clock
        (the kernels reset it on any event touching a non-leader row)."""
        gi = self.groups[cluster_id]
        self._acks.append(
            (gi.row, int(self.mirror.arrays["self_slot"][gi.row]), 0,
             int(self._row_epoch[gi.row]))
        )

    # ------------------------------------------------------------------
    # device read plane: ReadIndex staging
    # ------------------------------------------------------------------

    def _free_read_slot(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized per-row free-slot pick (cursor + S-step scan); -1
        where a row has no reusable slot.  A slot freed by a predicted
        confirmation is reusable only in a LATER round: the device applies
        a round's stage before its echoes, so a same-round restage would
        overwrite the confirming batch before its release."""
        s = self.n_read_slots
        slot = np.full(rows.shape, -1, np.int32)
        cur = self._read_next_slot[rows]
        for k in range(s):
            cand = (cur + k) % s
            ok = (
                (slot < 0)
                & ~self._read_busy[rows, cand]
                & (self._read_freed_round[rows, cand] < self._round_seq)
            )
            slot = np.where(ok, cand, slot)
        return slot

    def _predict_read_confirm(self, rows: np.ndarray, rslots: np.ndarray) -> None:
        """Free the slots whose staged echoes reach quorum (self counted
        through the one-hot column, observers masked out: the arithmetic
        of ``kernels.read_confirm`` on the mirror's membership): the batch
        provably confirms in its round."""
        a = self.mirror.arrays
        echo = self._read_echo_host[rows, rslots]
        selfc = (
            np.arange(self.n_peers, dtype=np.int32)[None, :]
            == a["self_slot"][rows][:, None]
        )
        cnt = ((echo | selfc) & a["voting"][rows]).sum(axis=1)
        conf = self._read_busy[rows, rslots] & (cnt >= a["quorum"][rows])
        if conf.any():
            self._read_busy[rows[conf], rslots[conf]] = False
            self._read_freed_round[rows[conf], rslots[conf]] = self._round_seq

    def _reset_read_rows(self, rows) -> None:
        """Drop the rows' pending-read bookkeeping (transition purge); a
        no-op until the read plane is used."""
        if not self._read_plane_used:
            return
        self._read_busy[rows] = False
        self._read_freed_round[rows] = -1
        self._read_echo_host[rows] = False

    def stage_read(
        self, cluster_id: int, count: int = 1, index: Optional[int] = None
    ) -> int:
        """Stage a batch of ``count`` ReadIndex requests for the group and
        return the pending-read SLOT it rides (the confirmed-read egress
        names the slot back).  Scalar twin: ``ReadIndex.add_request``.
        ``index`` (absolute) pins the captured watermark; by default it is
        the engine's host view of the row's committed watermark, which may
        trail an unharvested block and is still linearizable (commits
        reach clients only through harvested egress).  Raises
        ``RuntimeError`` when all S slots hold unconfirmed batches."""
        if count < 1:
            raise ValueError("stage_read count must be >= 1")
        gi = self.groups[cluster_id]
        row = gi.row
        slot = int(self._free_read_slot(np.array([row], np.int64))[0])
        if slot < 0:
            raise RuntimeError(f"no free pending-read slot for group {cluster_id}")
        if index is not None:
            rel = self._rel(gi, index)
        else:
            self._refresh_committed_cache()
            if row in self._dirty or row in self._churn_pending:
                rel = int(self.mirror.arrays["committed"][row])
            else:
                rel = int(self._committed_cache[row])
        self._read_plane_used = True
        self._read_busy[row, slot] = True
        self._read_next_slot[row] = (slot + 1) % self.n_read_slots
        self._read_echo_host[row, slot, :] = False
        self._read_stages.append((row, slot, rel, count, int(self._row_epoch[row])))
        return slot

    def stage_read_block(self, rows, rels, counts) -> np.ndarray:
        """Vectorized bulk read staging: one batch per row (rows unique),
        ``rels`` already rebased; returns the slot of each row.  Caller
        contract as ``ack_block``'s: live rows, bounds validated here."""
        rows = np.asarray(rows)
        rels = np.asarray(rels)
        counts = np.asarray(counts)
        if not (rows.shape == rels.shape == counts.shape) or rows.ndim != 1:
            raise ValueError("stage_read_block arrays must share a 1-D shape")
        if rows.size == 0:
            return np.zeros((0,), np.int32)
        if rows.min() < 0 or rows.max() >= self.n_groups:
            raise ValueError("stage_read_block row out of range")
        if rels.min() < 0 or rels.max() >= REBASE_THRESHOLD:
            raise ValueError("stage_read_block rel out of range")
        if counts.min() < 1:
            raise ValueError("stage_read_block counts must be >= 1")
        if np.unique(rows).size != rows.size:
            raise ValueError("stage_read_block rows must be unique")
        rows64 = rows.astype(np.int64)
        slot = self._free_read_slot(rows64)
        if (slot < 0).any():
            raise RuntimeError(
                f"no free pending-read slot for {int((slot < 0).sum())} rows"
            )
        self._read_plane_used = True
        self._read_busy[rows64, slot] = True
        self._read_next_slot[rows64] = (slot + 1) % self.n_read_slots
        self._read_echo_host[rows64, slot, :] = False
        rows32 = rows.astype(np.int32)
        self._read_stage_blocks.append(
            (rows32, slot.astype(np.int32), rels.astype(np.int32),
             counts.astype(np.int32), self._row_epoch[rows32].copy())
        )
        return slot

    def read_ack(self, cluster_id: int, node_id: int, slot: int) -> None:
        """Heartbeat echo of the group's pending-read ``slot`` from
        ``node_id`` (scalar twin: the ``m.hint != 0`` branch of
        ``handle_leader_heartbeat_resp`` feeding ``ReadIndex.confirm``)."""
        gi = self.groups[cluster_id]
        row = gi.row
        if not 0 <= slot < self.n_read_slots:
            raise ValueError(f"read slot {slot} out of range")
        peer = gi.slots[node_id]
        self._read_plane_used = True
        self._read_echoes.append((row, slot, peer, int(self._row_epoch[row])))
        self._read_echo_host[row, slot, peer] = True
        self._predict_read_confirm(np.array([row], np.int64), np.array([slot], np.int64))

    def read_ack_block(self, rows, rslots, peers) -> None:
        """Vectorized bulk echo ingest in (row, read slot, peer slot)
        space; duplicates are harmless (echo sets are idempotent)."""
        rows = np.asarray(rows)
        rslots = np.asarray(rslots)
        peers = np.asarray(peers)
        if not (rows.shape == rslots.shape == peers.shape) or rows.ndim != 1:
            raise ValueError("read_ack_block arrays must share a 1-D shape")
        if rows.size == 0:
            return
        if rows.min() < 0 or rows.max() >= self.n_groups:
            raise ValueError("read_ack_block row out of range")
        if rslots.min() < 0 or rslots.max() >= self.n_read_slots:
            raise ValueError("read_ack_block read slot out of range")
        if peers.min() < 0 or peers.max() >= self.n_peers:
            raise ValueError("read_ack_block peer slot out of range")
        rows32 = rows.astype(np.int32)
        self._read_plane_used = True
        self._read_echo_blocks.append(
            (rows32, rslots.astype(np.int32), peers.astype(np.int32),
             self._row_epoch[rows32].copy())
        )
        rows64 = rows.astype(np.int64)
        rslots64 = rslots.astype(np.int64)
        self._read_echo_host[rows64, rslots64, peers.astype(np.int64)] = True
        self._predict_read_confirm(rows64, rslots64)

    def cancel_read(self, cluster_id: int, slot: int) -> None:
        """Withdraw a pending-read slot whose reads were released by
        another path.  The slot frees on the host now and on the device at
        its round: a zero-count stage overwrites the batch (count 0 means
        free, and the confirm gates on it)."""
        gi = self.groups[cluster_id]
        row = gi.row
        if not 0 <= slot < self.n_read_slots:
            raise ValueError(f"read slot {slot} out of range")
        self._read_plane_used = True
        self._read_stages.append((row, slot, 0, 0, int(self._row_epoch[row])))
        self._read_busy[row, slot] = False
        self._read_freed_round[row, slot] = self._round_seq
        self._read_echo_host[row, slot, :] = False

    def read_slots_free(self, cluster_id: int) -> int:
        """Pending-read slots of the group reusable RIGHT NOW (counting
        the next-round rule): backpressure introspection."""
        row = self.groups[cluster_id].row
        free = ~self._read_busy[row] & (self._read_freed_round[row] < self._round_seq)
        return int(free.sum())

    def _gather_reads(self):
        """The open round's read buffers as flat arrays with stale-epoch
        events filtered; clears the buffers and advances the slot-reuse
        round seq (one call per round close).  Returns ``(reads, racks)``,
        each a tuple of int32 arrays or None."""
        self._round_seq += 1
        reads = racks = None
        parts = []
        if self._read_stages:
            cols = np.array(self._read_stages, dtype=np.int64)
            rows = cols[:, 0].astype(np.int32)
            keep = cols[:, 4].astype(np.int32) == self._row_epoch[rows]
            if keep.any():
                parts.append(tuple(cols[keep, i].astype(np.int32) for i in range(4)))
            self._read_stages = []
        if self._read_stage_blocks:
            for r, sl, v, c, ep in self._read_stage_blocks:
                keep = ep == self._row_epoch[r]
                if keep.all():
                    parts.append((r, sl, v, c))
                elif keep.any():
                    parts.append((r[keep], sl[keep], v[keep], c[keep]))
            self._read_stage_blocks = []
        if parts:
            reads = tuple(np.concatenate([q[i] for q in parts]) for i in range(4))
        parts = []
        if self._read_echoes:
            cols = np.array(self._read_echoes, dtype=np.int64)
            rows = cols[:, 0].astype(np.int32)
            keep = cols[:, 3].astype(np.int32) == self._row_epoch[rows]
            if keep.any():
                parts.append(tuple(cols[keep, i].astype(np.int32) for i in range(3)))
            self._read_echoes = []
        if self._read_echo_blocks:
            for r, sl, pe, ep in self._read_echo_blocks:
                keep = ep == self._row_epoch[r]
                if keep.all():
                    parts.append((r, sl, pe))
                elif keep.any():
                    parts.append((r[keep], sl[keep], pe[keep]))
            self._read_echo_blocks = []
        if parts:
            racks = tuple(np.concatenate([q[i] for q in parts]) for i in range(3))
        return reads, racks

    def _reads_pending(self) -> bool:
        return bool(
            self._read_stages or self._read_stage_blocks
            or self._read_echoes or self._read_echo_blocks
        )

    # ------------------------------------------------------------------
    # device state machine: entry ops and KV reads
    # ------------------------------------------------------------------

    def stage_kv_op(self, cluster_id: int, index: int, key: int, value: int) -> None:
        """Stage one committed-entry ``SET key := value`` op for log
        ``index`` (absolute): it applies on the device in the dispatch
        whose commit watermark passes the index."""
        self.stage_kv_ops(cluster_id, [index], [key], [value])

    def stage_kv_ops(self, cluster_id: int, indexes, keys, values) -> bool:
        """Vectorized entry-op staging for one group.  ``indexes`` must be
        strictly increasing (log order); an op whose buffer slot (``rel %
        E``) still holds an unapplied tenant queues on the host and drains,
        in order, as harvested watermarks free slots.  Returns True when
        everything staged at once (nothing queued for the row): a False
        means a queued op may commit before it applies, so ``kv_value``
        may trail the watermark until the queue drains."""
        gi = self.groups[cluster_id]
        row = gi.row
        indexes = np.asarray(indexes, dtype=np.int64)
        keys = np.asarray(keys, dtype=np.int64)
        values = np.asarray(values, dtype=np.int64)
        if not (indexes.shape == keys.shape == values.shape) or indexes.ndim != 1:
            raise ValueError("stage_kv_ops arrays must share a 1-D shape")
        if indexes.size == 0:
            return True
        rels = indexes - gi.base
        if rels.min() < 1:
            raise ValueError("stage_kv_ops index at or below the group base")
        if rels.max() >= REBASE_THRESHOLD:
            raise ValueError("stage_kv_ops index needs rebase")
        if indexes.size > 1 and (np.diff(indexes) <= 0).any():
            raise ValueError("stage_kv_ops indexes must be strictly increasing")
        if keys.min() < 0 or keys.max() >= self.n_kv_slots:
            raise ValueError("stage_kv_ops key slot out of range")
        imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        if values.min() < imin or values.max() > imax:
            raise ValueError("stage_kv_ops value outside int32")
        self._devsm_used = True
        q = self._kv_queue.setdefault(row, deque())
        q.extend(zip(rels.tolist(), keys.tolist(), values.tolist()))
        self._drain_kv_queue(row)
        return row not in self._kv_queue

    def _drain_kv_queue(self, row: int) -> None:
        """Move queued ops into the open round while their slots are free,
        in log order; stop at the first occupied slot (a later op must not
        apply before an earlier one of the same key)."""
        q = self._kv_queue.get(row)
        if not q:
            self._kv_queue.pop(row, None)
            return
        e = self.n_kv_ents
        ep = int(self._row_epoch[row])
        ent_rel = self._kv_ent_rel[row]
        while q:
            rel, key, val = q[0]
            slot = rel % e
            if ent_rel[slot] != -1:
                break
            ent_rel[slot] = rel
            self._kv_stage.append((row, slot, rel, key, val, ep))
            q.popleft()
        if not q:
            self._kv_queue.pop(row, None)

    def _kv_free_applied(self) -> None:
        """Free the entry slots whose tenants the HARVESTED watermark has
        passed (the device freed them in the round they applied), then
        drain queued ops into the open round.  Runs at every egress once
        the devsm latch is up."""
        mask = (self._kv_ent_rel >= 0) & (self._kv_ent_rel <= self._committed_cache[:, None])
        if mask.any():
            self._kv_ent_rel[mask] = -1
        for row in list(self._kv_queue):
            self._drain_kv_queue(row)

    def stage_kv_read(self, cluster_id: int, key: int) -> int:
        """Stage a device KV read of ``key`` for the group; returns the
        read SLOT its capture egresses under (``StepResult.kv_reads``).
        The value is captured in the read's round, after that round's
        apply, with the watermark it reflects.  Raises ``RuntimeError``
        when all R slots hold unharvested captures."""
        gi = self.groups[cluster_id]
        row = gi.row
        if not 0 <= key < self.n_kv_slots:
            raise ValueError(f"kv key slot {key} out of range")
        free = np.nonzero(~self._kv_read_busy[row])[0]
        if not free.size:
            raise RuntimeError(f"no free devsm read slot for group {cluster_id}")
        slot = int(free[0])
        self._devsm_used = True
        self._kv_read_busy[row, slot] = True
        self._kv_read_stage.append((row, slot, key, int(self._row_epoch[row])))
        return slot

    def kv_reads_free(self, cluster_id: int) -> int:
        """Free devsm read slots of the group right now."""
        row = self.groups[cluster_id].row
        return int((~self._kv_read_busy[row]).sum())

    def kv_values(self, cluster_id: int) -> np.ndarray:
        """The group's KV row (int64): pending mirror edits win over the
        device, like every rare-path read."""
        gi = self.groups[cluster_id]
        return np.array(self._read("kv_value", gi.row), dtype=np.int64)

    def kv_restore(self, cluster_id: int, values) -> None:
        """Install a group's KV image (snapshot recover): a mirror row
        write and a dirty upload, with the entry buffer cleared (the image
        IS the applied state)."""
        gi = self.groups[cluster_id]
        row = gi.row
        values = np.asarray(values, dtype=np.int64)
        if values.shape != (self.n_kv_slots,):
            raise ValueError(
                f"kv_restore expects shape ({self.n_kv_slots},), got {values.shape}"
            )
        self._devsm_used = True
        self._sync_row(row)
        self.mirror.arrays["kv_value"][row, :] = values.astype(np.int32)
        self.mirror.clear_kv_ents(row)
        self._reset_kv_rows([row])
        self._dirty.add(row)

    def _reset_kv_rows(self, rows) -> None:
        """Drop the rows' devsm host bookkeeping (transition purge): queued
        ops die, staged slots free, captures are abandoned; a no-op until
        the plane is used.  The device side is cleared by the caller's
        mirror write or by the in-program recycle."""
        if not self._devsm_used:
            return
        self._kv_ent_rel[rows] = -1
        self._kv_read_busy[rows] = False
        for r in np.atleast_1d(np.asarray(rows, dtype=np.int64)):
            self._kv_queue.pop(int(r), None)

    def _gather_kv(self):
        """The open round's devsm buffers as flat int32 arrays with
        stale-epoch events filtered; clears them.  Drains the queues first,
        so ops the last harvest unblocked ride this round.  Returns
        ``(kvents, kvreads)``, each a tuple of arrays or None."""
        if self._kv_queue:
            for row in list(self._kv_queue):
                self._drain_kv_queue(row)
        kvents = kvreads = None
        if self._kv_stage:
            cols = np.array(self._kv_stage, dtype=np.int64)
            rows = cols[:, 0].astype(np.int32)
            keep = cols[:, 5].astype(np.int32) == self._row_epoch[rows]
            if keep.any():
                kvents = tuple(cols[keep, i].astype(np.int32) for i in range(5))
            self._kv_stage = []
        if self._kv_read_stage:
            cols = np.array(self._kv_read_stage, dtype=np.int64)
            rows = cols[:, 0].astype(np.int32)
            keep = cols[:, 3].astype(np.int32) == self._row_epoch[rows]
            if keep.any():
                kvreads = tuple(cols[keep, i].astype(np.int32) for i in range(3))
            self._kv_read_stage = []
        return kvents, kvreads

    def _kv_pending(self) -> bool:
        return bool(self._kv_stage or self._kv_read_stage or self._kv_queue)

    def _kv_ents_buffered(self) -> bool:
        """Whether an entry slot holds an op the harvested watermark has
        not passed: then every dispatch carries the plane, or an entry
        whose commit lands in a kv-free dispatch would never apply."""
        return self._devsm_used and bool((self._kv_ent_rel >= 0).any())

    @staticmethod
    def _purge_block_kv(b, row: int) -> None:
        """Drop ``row``'s staged devsm ops and reads from one sealed round
        block (the ``_purge_block_reads`` rationale: an old tenant's
        capture would egress under the new one)."""
        if b.kvents is not None and b.kvents[0].size:
            keep = b.kvents[0] != row
            if not keep.all():
                b.kvents = tuple(a[keep] for a in b.kvents)
        if b.kvreads is not None and b.kvreads[0].size:
            keep = b.kvreads[0] != row
            if not keep.all():
                b.kvreads = tuple(a[keep] for a in b.kvreads)

    def _pending_events(self) -> bool:
        """Whether the open round holds anything to close."""
        return bool(
            self._acks or self._ack_blocks or self._votes or self._churn
            or self._reads_pending() or self._kv_pending()
        )

    # ------------------------------------------------------------------
    # multi-round fused staging
    # ------------------------------------------------------------------

    def begin_round(self) -> None:
        """Close the current ingest round: everything staged so far forms
        one scanned round of the next fused dispatch.  The round's
        stale-epoch filter resolves NOW."""
        if self._votes:
            votes = [
                (r, s, v) for r, s, v, ep in self._votes
                if ep == self._row_epoch[r]
            ]
            self._votes = []
            self._voted_cells.clear()
        else:
            votes = []
        rows, slots, rels = self._gather_acks()
        reads, racks = self._gather_reads()
        kvents, kvreads = self._gather_kv()
        self._round_blocks.append(
            _RoundBuf(rows, slots, rels, votes, self._churn, reads=reads,
                      racks=racks, kvents=kvents, kvreads=kvreads)
        )
        self._churn = []
        self._churn_rows = set()

    def pending_rounds(self) -> int:
        """Closed rounds awaiting the fused dispatch."""
        return len(self._round_blocks)

    def ack_block_rounds(self, rows, slots, rels_rounds) -> None:
        """K CLOSED rounds of bulk acks over ONE (row, slot) geometry;
        ``rels_rounds`` is (K, n) and row ``r`` forms scanned round ``r``.
        The round buffers alias the caller's arrays until dispatch.
        Events/churn already staged close into one preceding round."""
        rows = np.asarray(rows)
        slots = np.asarray(slots)
        rels_rounds = np.asarray(rels_rounds)
        if rels_rounds.ndim != 2 or rows.shape != slots.shape or (
            rels_rounds.shape[1:] != rows.shape
        ):
            raise ValueError("ack_block_rounds: shape mismatch")
        if rels_rounds.size and rels_rounds.max() >= REBASE_THRESHOLD:
            raise ValueError("ack_block_rounds rel out of range")
        if rows.size and (rows.min() < 0 or rows.max() >= self.n_groups):
            raise ValueError("ack_block_rounds row out of range")
        if slots.size and (slots.min() < 0 or slots.max() >= self.n_peers):
            raise ValueError("ack_block_rounds slot out of range")
        if self._pending_events():
            self.begin_round()
        rows32 = rows.astype(np.int32, copy=False)
        slots32 = slots.astype(np.int32, copy=False)
        cells = rows32.astype(np.int64) * self.n_peers + slots32
        if rels_rounds.size and rels_rounds.min() < 0:
            rels_rounds = np.maximum(rels_rounds, 0)
        for r in range(rels_rounds.shape[0]):
            self._round_blocks.append(
                _RoundBuf(
                    rows32, slots32, rels_rounds[r].astype(np.int32, copy=False),
                    [], [], cells=cells,
                )
            )

    def stage_recycle(
        self,
        old_cluster_id: int,
        new_cluster_id: int,
        term: int,
        term_start: int,
        last_index: int,
        rand_timeout: Optional[int] = None,
    ) -> GroupInfo:
        """Replace a group with a fresh SAME-GEOMETRY leader tenant as a
        masked row update INSIDE the next dispatched program (the device
        twin of ``remove_group`` + ``add_group`` + ``set_leader``).  The
        reset applies at the START of the recycle's ingest round, before
        that round's events.  Raises ValueError when the swap isn't a pure
        recycle."""
        gi = self.groups.get(old_cluster_id)
        if gi is None:
            raise ValueError(f"group {old_cluster_id} not registered")
        if new_cluster_id in self.groups:
            raise ValueError(f"group {new_cluster_id} already registered")
        row = gi.row
        if row in self._churn_rows:
            raise ValueError(
                f"row {row} already recycled this round (begin_round first)"
            )
        a = self.mirror.arrays
        if rand_timeout is not None and rand_timeout != int(a["rand_timeout"][row]):
            raise ValueError("rand_timeout differs: recycle must keep geometry")
        if term_start < 0 or last_index < 0 or term_start > last_index:
            raise ValueError("term_start/last_index out of range")
        if last_index >= REBASE_THRESHOLD:
            raise ValueError("index needs rebase before recycle")
        del self.groups[old_cluster_id]
        ngi = GroupInfo(new_cluster_id, row, gi.slots, base=0, node_ids=gi.node_ids)
        self.groups[new_cluster_id] = ngi
        self.rows[row] = ngi
        self._row_cid[row] = new_cluster_id
        self._row_base[row] = 0
        # old-tenant events staged this round must not reach the new tenant
        self._purge_row_events(row)
        # old-tenant READS die entirely, including batches sealed into
        # closed pre-recycle rounds: a read confirmed there would egress
        # after the recycle, attributed to the row's final tenant; its
        # devsm ops and reads die the same way
        for b in self._round_blocks:
            self._purge_block_reads(b, row)
            self._purge_block_kv(b, row)
        self._reset_kv_rows([row])
        # mirror coherence WITHOUT dirtying the row: the device applies the
        # identical reset in-program
        self.mirror.recycle_row(
            row, term, term_start, last_index,
            clear_reads=self._read_plane_used, clear_kv=self._devsm_used,
            clear_telem=self._telem_used,
        )
        self._committed_cache[row] = 0
        self._synced.discard(row)
        self._churn.append((row, term, term_start, last_index))
        self._churn_rows.add(row)
        self._churn_pending.add(row)
        return ngi

    def step_rounds(
        self,
        do_tick: bool = False,
        pipelined: bool = False,
        pad_rounds_to: int = 0,
        tick_rounds: Optional[int] = None,
    ) -> Optional[MultiRoundResult]:
        """ONE fused launch over every staged round (``begin_round``
        boundaries; a non-empty open round is closed implicitly).

        ``pipelined=True`` returns the PREVIOUS dispatch's egress (None on
        the first) and leaves this dispatch in flight, so the caller stages
        block i+1 while block i runs; every host read of device state
        harvests first.  ``pad_rounds_to`` pads the block with event-free,
        tick-masked-off rounds; ``tick_rounds`` sets how many rounds tick
        (default: every real round)."""
        if self._pending_events():
            self.begin_round()
        if not self._round_blocks:
            return self._harvest_inflight()
        blocks, self._round_blocks = self._round_blocks, []
        n_real = len(blocks)
        z = np.zeros((0,), np.int32)
        while len(blocks) < pad_rounds_to:
            blocks.append(_RoundBuf(z, z, z, [], []))
        if tick_rounds is None:
            tick_rounds = n_real
        tick_rounds = min(tick_rounds, len(blocks))
        tick_mask = np.zeros((len(blocks),), bool)
        tick_mask[:tick_rounds] = True
        prev = self._harvest_inflight()
        self._upload_dirty()
        self._refresh_committed_cache()
        egress = self._dispatch_multiround(blocks, do_tick, tick_mask)
        self._synced.clear()
        # every staged recycle is now inside the dispatched program
        self._churn_pending.clear()
        self._inflight = (
            egress,
            # snapshot: stage_recycle zeroes cache rows while this block is
            # in flight, which must not corrupt ITS commit-delta baseline
            self._committed_cache.copy(),
            self._row_cid.copy(),
            self._row_base.copy(),
            len(blocks),
        )
        if pipelined:
            return prev
        return self.harvest()

    def harvest(self) -> Optional[MultiRoundResult]:
        """Egress of the in-flight pipelined dispatch (None when idle)."""
        return self._harvest_inflight()

    def _harvest_inflight(self) -> Optional[MultiRoundResult]:
        if self._inflight is None:
            return None
        egress, prev_committed, row_cid, row_base, n_rounds = self._inflight
        self._inflight = None
        committed, flags, reads, kv, telem = egress.wait()
        if telem is not None:
            self._stage_telem(telem, row_cid, n_rounds)
        res = MultiRoundResult(n_rounds)
        if reads is not None:
            self._translate_reads(res, reads, row_cid, row_base)
        committed = np.array(committed, dtype=np.int32)
        res.committed_rel = committed
        self._committed_cache = committed.copy()
        if self._churn_pending:
            # recycles staged while this block was in flight keep their
            # mirror watermark until THEIR block lands
            rows = np.fromiter(self._churn_pending, dtype=np.int64)
            self._committed_cache[rows] = self.mirror.arrays["committed"][rows]
        self._kv_egress(res, kv, row_cid, row_base)
        res.commit_rows = self._translate_egress(
            res, committed, prev_committed, row_cid, row_base, flags
        )
        return res

    def _kv_egress(self, res, kv, row_cid, row_base) -> None:
        """The devsm part of an egress, after the committed cache is
        refreshed: translate the captures, call the hook, then free the
        applied entry slots."""
        if kv is not None:
            self._translate_kv(res, kv, row_cid, row_base)
            if self.kv_egress_hook is not None:
                self.kv_egress_hook(res)
        if self._devsm_used:
            self._kv_free_applied()

    _FLAG_NAMES = ("won", "lost", "elect", "heartbeat", "demote")

    @classmethod
    def _translate_egress(
        cls, res, committed, prev_committed, row_cid, row_base, flags
    ) -> np.ndarray:
        """Vectorized row -> cluster egress translation: watermark deltas
        become (cid, abs) arrays (dead rows dropped), the five flag rows
        become cid lists.  Returns the changed-row index vector."""
        changed = np.nonzero(committed != prev_committed)[0]
        if changed.size:
            cids = row_cid[changed]
            live = cids >= 0
            res._commit_cids = cids[live]
            res._commit_abs = (row_base[changed] + committed[changed])[live]
        for name, arr in zip(cls._FLAG_NAMES, flags):
            idx = np.nonzero(arr)[0]
            if idx.size:
                cids = row_cid[idx]
                getattr(res, name).extend(cids[cids >= 0].tolist())
        return changed

    def _translate_kv(self, res, kv, row_cid, row_base) -> None:
        """Vectorized devsm egress translation: the (G,R) capture block
        becomes flat (cid, slot, value, abs index) vectors (dead rows
        dropped; ``StepResult.kv_reads`` builds the tuples), captured read
        slots free, and the dispatch's applied total lands on the result."""
        kvv, kvi, kva = kv
        res.kv_applied_ops = int(kva.sum())
        rows, slots = np.nonzero(kvi >= 0)
        if not rows.size:
            return
        self._kv_read_busy[rows, slots] = False
        cids = row_cid[rows]
        live = cids >= 0
        rows, slots = rows[live], slots[live]
        res.kv_cids = cids[live]
        res.kv_slots = slots.astype(np.int64)
        res.kv_vals = kvv[rows, slots].astype(np.int64)
        res.kv_index_abs = row_base[rows] + kvi[rows, slots]

    @staticmethod
    def _translate_reads(res, reads, row_cid, row_base) -> None:
        """Vectorized confirmed-read egress translation: the (2, G, S)
        count / index block becomes flat (cid, slot, abs index, count)
        vectors (dead rows dropped; ``StepResult.reads`` builds the tuple
        list on first access)."""
        done_cnt, done_idx = reads[0], reads[1]
        rows, slots = np.nonzero(done_cnt)
        if not rows.size:
            return
        cids = row_cid[rows]
        live = cids >= 0
        rows, slots = rows[live], slots[live]
        res.read_cids = cids[live]
        res.read_slots = slots.astype(np.int64)
        res.read_index_abs = row_base[rows] + done_idx[rows, slots]
        res.read_counts = done_cnt[rows, slots].astype(np.int64)

    # ------------------------------------------------------------------
    # device boundary
    # ------------------------------------------------------------------

    def _host(self, shape, dtype, fill=None) -> Tuple[torch.Tensor, np.ndarray]:
        """A host staging tensor (pinned on CUDA engines) and its numpy
        view, so staging writes straight into the buffer that uploads."""
        t = torch.empty(shape, dtype=_TORCH_OF[np.dtype(dtype)], pin_memory=self._pinned)
        a = t.numpy()
        if fill is not None:
            a.fill(fill)
        return t, a

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self._pinned:
            return t.to(self.device, non_blocking=True)
        return t

    def _stage_multiround(self, blocks: List[_RoundBuf], tick_mask: np.ndarray):
        """Stack K closed rounds into host tensors: the (K,G,P) ack block
        with the ``-1`` sentinel, (K,G,P) votes, (K,C) churn records, the
        tick mask; where a round staged reads or echoes, the (K,G,S)
        stage index (``-1`` = none) and count and the (K,G,S,P) echoes;
        where a round staged kv ops or reads, or an entry sits buffered,
        the (K,G,E) entry index (``-1`` = none), key and value and the
        (K,G,R) read keys (``-1`` = none).  Returns (tensors, has_votes,
        has_churn, has_reads, has_kv)."""
        k = len(blocks)
        g, p = self.n_groups, self.n_peers
        ack_t, ack_max = self._host((k, g, p), np.int32, fill=-1)
        flat = ack_max.reshape(-1)
        stride = g * p
        for r, b in enumerate(blocks):
            if b.rows.size:
                if b.cells is not None:  # shared-geometry fast path
                    cell = r * stride + b.cells
                else:
                    cell = (r * g + b.rows.astype(np.int64)) * p + b.slots
                np.maximum.at(flat, cell, b.rels)
        has_votes = any(b.votes for b in blocks)
        if has_votes:
            vote_t, vote_new = self._host((k, g, p), np.int8, fill=VOTE_NONE)
            for r, b in enumerate(blocks):
                if b.votes:
                    cols = np.array(b.votes, dtype=np.int64).T
                    vote_new[r, cols[0], cols[1]] = cols[2].astype(np.int8)
        else:
            vote_t, _ = self._host((1, 1, 1), np.int8, fill=0)  # unread dummy
        has_churn = any(b.churn for b in blocks)
        cap = max((len(b.churn) for b in blocks), default=0) if has_churn else 1
        churn = [self._host((k, cap), np.int32, fill=0) for _ in range(4)]
        if has_churn:
            churn[0][1].fill(g)  # g = padding (dropped)
            for r, b in enumerate(blocks):
                if b.churn:
                    cols = np.array(b.churn, dtype=np.int64).T
                    n = cols.shape[1]
                    for i in range(4):
                        churn[i][1][r, :n] = cols[i]
        tick_t, tick_a = self._host((k,), np.bool_)
        tick_a[:] = tick_mask
        tensors = (ack_t, vote_t) + tuple(t for t, _ in churn) + (tick_t,)
        has_reads = any(b.reads is not None or b.racks is not None for b in blocks)
        if has_reads:
            s = self.n_read_slots
            idx_t, stage_idx = self._host((k, g, s), np.int32, fill=-1)
            cnt_t, stage_cnt = self._host((k, g, s), np.int32, fill=0)
            echo_t, echo = self._host((k, g, s, p), np.bool_, fill=False)
            for r, b in enumerate(blocks):
                if b.reads is not None and b.reads[0].size:
                    rr, sl, v, c = b.reads
                    stage_idx[r, rr, sl] = v
                    stage_cnt[r, rr, sl] = c
                if b.racks is not None and b.racks[0].size:
                    rr, sl, pe = b.racks
                    echo[r, rr, sl, pe] = True
            tensors += (idx_t, cnt_t, echo_t)
        has_kv = any(
            b.kvents is not None or b.kvreads is not None for b in blocks
        ) or self._kv_ents_buffered()  # the plane runs while ops sit buffered
        if has_kv:
            tensors += self._stage_kv((k,), [(b.kvents, b.kvreads) for b in blocks])
        return tensors, has_votes, has_churn, has_reads, has_kv

    def _stage_kv(self, lead, rounds) -> tuple:
        """The devsm inputs of a dispatch as host tensors: (…,G,E) entry
        index (``-1`` = none), key and value and (…,G,R) read keys (``-1``
        = none), ``lead`` = (K,) for a block or () for one round;
        ``rounds`` holds each round's ``(kvents, kvreads)``."""
        g, e, rk = self.n_groups, self.n_kv_ents, self.n_kv_reads
        ei_t, kv_ei = self._host(lead + (g, e), np.int32, fill=-1)
        ek_t, kv_ek = self._host(lead + (g, e), np.int32, fill=0)
        ev_t, kv_ev = self._host(lead + (g, e), np.int32, fill=0)
        rk_t, kv_rk = self._host(lead + (g, rk), np.int32, fill=-1)
        for r, (kvents, kvreads) in enumerate(rounds):
            at = (r,) if lead else ()
            if kvents is not None and kvents[0].size:
                rr, sl, rel, key, val = kvents
                kv_ei[at + (rr, sl)] = rel
                kv_ek[at + (rr, sl)] = key
                kv_ev[at + (rr, sl)] = val
            if kvreads is not None and kvreads[0].size:
                rr, sl, key = kvreads
                kv_rk[at + (rr, sl)] = key
        return ei_t, ek_t, ev_t, rk_t

    def _upload(self, tensors) -> tuple:
        return tuple(self._to_device(t) for t in tensors)

    def _launch_multiround(self, args, do_tick, has_votes, has_churn, has_reads,
                           has_kv):
        head = 7 + (3 if has_reads else 0)
        reads = args[7:head] if has_reads else (None, None, None)
        kv = args[head:head + 4] if has_kv else (None, None, None, None)
        return quorum_multiround(
            self._dev, *args[:7], *reads, *kv,
            do_tick=do_tick,
            track_contact=self.device_ticks or do_tick,
            has_votes=has_votes,
            has_churn=has_churn,
            has_reads=has_reads,
            # a never-used read plane is all-zero: its recycle reset is
            # skipped (the reference compiles it out)
            purge_reads=self._read_plane_used and has_churn,
            has_kv=has_kv,
            # the devsm twin of purge_reads
            purge_kv=self._devsm_used and has_churn,
            has_hier=self._hier_used,
            has_telem=self._telem_used,
            purge_telem=self._telem_used and has_churn,
            telem_k=self.n_telem_topk,
        )

    def _enqueue_egress(self, out) -> _Egress:
        return _Egress(out, self.device)

    def _dispatch_multiround(
        self, blocks: List[_RoundBuf], do_tick: bool, tick_mask: np.ndarray
    ) -> _Egress:
        """Stage, upload, launch ``kernels.quorum_multiround`` and enqueue
        the egress copy: one upload, one launch, one egress per block.
        The four parts are separate methods because ``chip_smoke.py``'s
        rung-5 drive overrides each of them to time it; keep their
        signatures when changing this path."""
        tensors, *planes = self._stage_multiround(blocks, tick_mask)
        args = self._upload(tensors)
        out = self._launch_multiround(args, do_tick, *planes)
        return self._enqueue_egress(out)

    def _refresh_committed_cache(self) -> None:
        """Re-read the host committed twin from the device when it was
        invalidated (external ``dev`` assignment)."""
        if not self._cache_stale:
            return
        self._committed_cache = self._dev.committed.cpu().numpy().astype(np.int32)
        if self._churn_pending:
            rows = np.fromiter(self._churn_pending, dtype=np.int64)
            self._committed_cache[rows] = self.mirror.arrays["committed"][rows]
        self._cache_stale = False

    def committed_view(self) -> np.ndarray:
        """Absolute committed watermark per ROW as one (G,) int64 vector
        (dead rows included; mask with ``row_cids() >= 0``)."""
        self._harvest_inflight()
        self._refresh_committed_cache()
        view = self._row_base + self._committed_cache.astype(np.int64)
        if self._dirty:
            rows = np.fromiter(self._dirty, dtype=np.int64)
            view[rows] = (
                self._row_base[rows]
                + self.mirror.arrays["committed"][rows].astype(np.int64)
            )
        return view

    def row_cids(self) -> np.ndarray:
        """(G,) int64 cluster id per row (-1 = dead)."""
        return self._row_cid.copy()

    def _sync_row(self, row: int) -> None:
        """Pull one device row into the mirror before mutating it.  A row
        with an undispatched in-program recycle keeps its (post-recycle)
        mirror: the recycle collapses to pre-block ordering instead."""
        self._harvest_inflight()
        if row in self._churn_pending:
            self._drop_churn_records(row, drop_events=True)
            self._dirty.add(row)
            return
        if row in self._dirty or row in self._synced:
            return
        self.sync_rows([row])

    def sync_rows(self, rows) -> None:
        """Bulk-pull many device rows into the mirror: one gather per field
        for the whole set."""
        self._harvest_inflight()
        if self._churn_pending:
            for r in rows:
                if r in self._churn_pending:
                    self._drop_churn_records(r, drop_events=True)
                    self._dirty.add(r)
        todo = [r for r in rows if r not in self._dirty and r not in self._synced]
        if not todo:
            return
        idx_np = np.asarray(todo, np.int64)
        idx = torch.from_numpy(idx_np).to(self.device)
        for k in self._sync_keys():
            self.mirror.arrays[k][idx_np] = getattr(self._dev, k).index_select(0, idx).cpu().numpy()
        self._synced.update(todo)

    _READ_KEYS = READ_PLANE_FIELDS
    _KV_KEYS = DEVSM_PLANE_FIELDS
    _HIER_KEYS = HIER_PLANE_FIELDS
    _TELEM_KEYS = TELEM_PLANE_FIELDS

    def _sync_keys(self) -> List[str]:
        """Mirror fields the rare-path row syncs move between host and
        device: the quorum plane, and the read, devsm, hier and telem
        fields once their latches are up (before that both sides are at
        their reset values by construction)."""
        skip = ()
        if not self._read_plane_used:
            skip += self._READ_KEYS
        if not self._devsm_used:
            skip += self._KV_KEYS
        if not self._hier_used:
            skip += self._HIER_KEYS
        if not self._telem_used:
            skip += self._TELEM_KEYS
        return [k for k in FIELDS if k not in skip]

    def _upload_dirty(self) -> None:
        """Copy exactly the dirty mirror rows onto the device state."""
        if not self._dirty:
            return
        self._harvest_inflight()
        rows = np.fromiter(self._dirty, dtype=np.int64)
        idx_t, idx_a = self._host((rows.size,), np.int64)
        idx_a[:] = rows
        idx = self._to_device(idx_t)
        for k in self._sync_keys():
            host = self.mirror.arrays[k][rows]
            src_t, src_a = self._host(host.shape, host.dtype)
            src_a[...] = host
            getattr(self._dev, k).index_copy_(0, idx, self._to_device(src_t))
        # keep the host committed twin coherent with the rows just written
        self._committed_cache[rows] = self.mirror.arrays["committed"][rows]
        self._dirty.clear()

    # ------------------------------------------------------------------
    # single-round dispatch
    # ------------------------------------------------------------------

    def step(self, do_tick: bool = True) -> StepResult:
        """Run one device dispatch over all pending events.

        Oversized event backlogs run extra (tickless) sparse dispatches
        first, so the event batch keeps its fixed size.  When rounds were
        staged (``begin_round`` / ``stage_recycle``) the whole backlog runs
        as ONE fused multi-round dispatch instead (``step_rounds``)."""
        if self._round_blocks or self._churn:
            return self.step_rounds(do_tick=do_tick)
        self._harvest_inflight()
        # stale-epoch votes (staged before a row transition) drop here
        if self._votes:
            self._votes = [
                (r, s, v) for r, s, v, ep in self._votes
                if ep == self._row_epoch[r]
            ]
        self._upload_dirty()
        self._refresh_committed_cache()
        prev_committed = self._committed_cache
        ack_g, ack_p, ack_v = self._gather_acks()
        reads, racks = self._gather_reads()
        kvents, kvreads = self._gather_kv()
        has_reads = reads is not None or racks is not None
        # the plane also runs while an entry sits buffered: its commit may
        # land in this otherwise kv-free dispatch
        has_kv = kvents is not None or kvreads is not None or self._kv_ents_buffered()
        # dense mode collapses ANY number of acks/votes into (G,P)
        # matrices — no cap, no chunk loop.  The read plane and the device
        # state machine exist only on the dense kernel, so they force it.
        if has_reads or has_kv or self.dense_ingest is True or (
            self.dense_ingest == "auto"
            and (
                ack_g.size >= self._dense_threshold
                or ack_g.size > self.event_cap
                or len(self._votes) > self.event_cap
            )
        ):
            out = self._dispatch_dense(
                ack_g, ack_p, ack_v, self._votes, do_tick, reads, racks,
                kvents, kvreads, has_kv,
            )
        else:
            pos = 0
            while (ack_g.size - pos) > self.event_cap or len(self._votes) > self.event_cap:
                take = min(self.event_cap, ack_g.size - pos)
                self._dispatch(
                    (ack_g[pos: pos + take], ack_p[pos: pos + take],
                     ack_v[pos: pos + take]),
                    self._votes[: self.event_cap],
                    False,
                )
                pos += take
                del self._votes[: self.event_cap]
            out = self._dispatch(
                (ack_g[pos:], ack_p[pos:], ack_v[pos:]), self._votes, do_tick
            )
        self._votes.clear()
        self._voted_cells.clear()
        self._synced.clear()
        res = StepResult()
        committed, flags, done, kv, telem = self._enqueue_egress(out).wait()
        if telem is not None:
            self._stage_telem(telem, self._row_cid.copy(), 1)
        if done is not None:
            self._translate_reads(res, done, self._row_cid, self._row_base)
        self._committed_cache = np.array(committed, dtype=np.int32)
        self._kv_egress(res, kv, self._row_cid, self._row_base)
        self._translate_egress(
            res, self._committed_cache, prev_committed, self._row_cid,
            self._row_base, flags,
        )
        return res

    def _gather_acks(self):
        """Tuple-staged + block-staged acks as three flat arrays, with
        stale-epoch events filtered out in one vectorized pass; clears
        both buffers."""
        parts = []
        if self._acks:
            cols = np.array(self._acks, dtype=np.int64)
            rows = cols[:, 0].astype(np.int32)
            keep = cols[:, 3].astype(np.int32) == self._row_epoch[rows]
            parts.append(
                (rows[keep], cols[keep, 1].astype(np.int32),
                 cols[keep, 2].astype(np.int32))
            )
            self._acks = []
        if self._ack_blocks:
            for r, s, v, ep in self._ack_blocks:
                keep = ep == self._row_epoch[r]
                if keep.all():
                    parts.append((r, s, v))
                elif keep.any():
                    parts.append((r[keep], s[keep], v[keep]))
            self._ack_blocks = []
        if not parts:
            z = np.zeros((0,), np.int32)
            return z, z, z
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
        )

    def _dispatch(self, acks, votes, do_tick: bool):
        """Pad one batch of sparse events to ``event_cap`` and launch the
        sparse step (vote arrays are (1,) dummies on a vote-free round)."""
        cap = self.event_cap
        ag, ap, av = acks
        n = ag.size
        ack_host = [self._host((cap,), dt, fill=0)
                    for dt in (np.int32, np.int32, np.int32, np.bool_)]
        for (_, a), src in zip(ack_host, (ag, ap, av)):
            a[:n] = src
        ack_host[3][1][:n] = True
        vcap = cap if votes else 1
        vote_host = [self._host((vcap,), dt, fill=0)
                     for dt in (np.int32, np.int32, np.int8, np.bool_)]
        if votes:
            cols = np.array(votes, dtype=np.int64).T
            m = cols.shape[1]
            for i in range(3):
                vote_host[i][1][:m] = cols[i]
            vote_host[3][1][:m] = True
        args = self._upload(t for t, _ in ack_host + vote_host)
        out = quorum_step(
            self._dev, *args,
            do_tick=do_tick,
            # ticking rounds track contact even on a device_ticks=False engine
            track_contact=self.device_ticks or do_tick,
            has_votes=bool(votes),
            has_hier=self._hier_used,
            has_telem=self._telem_used,
            telem_k=self.n_telem_topk,
            # occupancy hints for the fold only: this path carries no read
            # or kv events
            has_reads=self._read_plane_used,
            has_kv=self._devsm_used,
        )
        return out

    def _dispatch_dense(self, ag, ap, av, votes, do_tick: bool, reads=None,
                        racks=None, kvents=None, kvreads=None, has_kv=None):
        """Aggregate a round's events into (G,P) matrices and launch the
        dense step; ``reads`` / ``racks`` are the round's gathered read
        buffers (``_gather_reads``), which become the (G,S) stage index
        and count and the (G,S,P) echoes of the read plane, and
        ``kvents`` / ``kvreads`` its devsm buffers (``_gather_kv``), which
        become the (G,E) and (G,R) planes of the device state machine
        (``has_kv`` defaults to their presence)."""
        g, p = self.n_groups, self.n_peers
        max_t, ack_max = self._host((g, p), np.int32, fill=0)
        touch_t, touched = self._host((g, p), np.bool_, fill=False)
        if ag.size:
            # max-aggregation == scatter-max: order-independent, exact
            cell = ag.astype(np.int64) * p + ap
            np.maximum.at(ack_max.reshape(-1), cell, av)
            touched.reshape(-1)[cell] = True
        if votes:
            vote_t, vote_new = self._host((g, p), np.int8, fill=VOTE_NONE)
            cols = np.array(votes, dtype=np.int64).T
            vote_new[cols[0], cols[1]] = cols[2].astype(np.int8)
        else:
            vote_t, _ = self._host((1, 1), np.int8, fill=0)  # unread dummy
        host = [max_t, touch_t, vote_t]
        has_reads = reads is not None or racks is not None
        if has_reads:
            s = self.n_read_slots
            idx_t, stage_idx = self._host((g, s), np.int32, fill=-1)
            cnt_t, stage_cnt = self._host((g, s), np.int32, fill=0)
            echo_t, echo = self._host((g, s, p), np.bool_, fill=False)
            if reads is not None and reads[0].size:
                rr, sl, v, c = reads
                stage_idx[rr, sl] = v
                stage_cnt[rr, sl] = c
            if racks is not None and racks[0].size:
                rr, sl, pe = racks
                echo[rr, sl, pe] = True
            host += [idx_t, cnt_t, echo_t]
        if has_kv is None:
            has_kv = kvents is not None or kvreads is not None
        if has_kv:
            host += list(self._stage_kv((), [(kvents, kvreads)]))
        args = self._upload(host)
        reads_args = args[3:6] if has_reads else (None, None, None)
        kv_args = args[len(args) - 4:] if has_kv else (None, None, None, None)
        return quorum_step_dense(
            self._dev, *args[:3], *reads_args, *kv_args,
            do_tick=do_tick,
            track_contact=self.device_ticks or do_tick,
            has_votes=bool(votes),
            has_reads=has_reads,
            has_kv=has_kv,
            has_hier=self._hier_used,
            has_telem=self._telem_used,
            telem_k=self.n_telem_topk,
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def _read(self, field_name: str, row: int):
        """Field value at a row: pending mirror edits win over the device,
        including a staged in-program recycle."""
        self._harvest_inflight()
        if row in self._dirty or row in self._churn_pending:
            return self.mirror.arrays[field_name][row]
        return getattr(self._dev, field_name)[row].cpu().numpy()

    def committed_index(self, cluster_id: int) -> int:
        gi = self.groups[cluster_id]
        return int(gi.base) + int(self._read("committed", gi.row))

    def committed_snapshot(self, cids=None) -> Dict[int, int]:
        """Absolute committed indexes for ``cids`` (default: every
        registered group) from the host twin: no device transfer after a
        step or harvest."""
        self._harvest_inflight()
        self._refresh_committed_cache()
        committed = self._committed_cache
        mirror = self.mirror.arrays["committed"]
        dirty = self._dirty
        pend = self._churn_pending
        items = (
            self.groups.items()
            if cids is None
            else ((cid, self.groups[cid]) for cid in cids)
        )
        return {
            cid: int(gi.base)
            + int(
                mirror[gi.row]
                if gi.row in dirty or gi.row in pend
                else committed[gi.row]
            )
            for cid, gi in items
        }

    def peer_match(self, cluster_id: int, node_id: int) -> int:
        gi = self.groups[cluster_id]
        return int(gi.base) + int(self._read("match", gi.row)[gi.slots[node_id]])
