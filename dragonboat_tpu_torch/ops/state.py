"""Tensor state layout for the batched quorum engine.

Counterpart: ``dragonboat_tpu/ops/state.py``.  Per-group Raft bookkeeping
(reference ``internal/raft/raft.go:198`` ``raft`` struct,
``internal/raft/remote.go:62`` ``remote`` struct) is held as a
struct-of-arrays :class:`QuorumState` of ``(G,)`` and ``(G, P)`` tensors,
with the reference's fields, dtypes and order:

* indexes are int32 *relative to a per-group host-side base*; quorum math
  is translation-invariant, and the host rebases a row before its relative
  indexes approach 2^31 (``BatchedQuorumEngine.rebase``);
* on a leader ``q >= term_start`` stands in for ``log.match_term(q, term)``;
* variable membership is expressed by ``voting`` / ``present`` masks over a
  fixed peer axis.

Every field is listed once in :data:`FIELDS`; :func:`make_state`,
:func:`state_layout` and :class:`HostMirror` all walk that table, so a new
field cannot escape any of them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..platform import pick_device

INDEX_MIN = np.iinfo(np.int32).min

# Raft node states — must match raft.RaftState (reference raft.go:64-71).
FOLLOWER, CANDIDATE, LEADER, OBSERVER, WITNESS = 0, 1, 2, 3, 4

# Vote cell encoding: -1 = no response, 0 = rejected, 1 = granted.
VOTE_NONE, VOTE_REJECT, VOTE_GRANT = -1, 0, 1

# Pending ReadIndex ctx slots per group (the ``S`` axis).
READ_SLOTS = 4
# Device state machine value slots (``V``) and pending-entry depth (``E``).
KV_SLOTS = 16
KV_ENT_SLOTS = 16
# Per-round device KV read slots (the ``R`` axis).
KV_READ_SLOTS = 4

# Field sets of the optional planes; everything else is the core quorum
# plane.  An engine keeps a plane's fields at their reset values until the
# plane's latch flips (``BatchedQuorumEngine._sync_keys``).
READ_PLANE_FIELDS = ("read_index", "read_count", "read_acks")
DEVSM_PLANE_FIELDS = ("kv_value", "kv_ent_index", "kv_ent_key", "kv_ent_val")
HIER_PLANE_FIELDS = ("near", "sub_quorum")
TELEM_PLANE_FIELDS = ("telem_prev_committed",)


def field_plane(name: str) -> str:
    """The plane a :class:`QuorumState` field belongs to."""
    if name in READ_PLANE_FIELDS:
        return "read"
    if name in DEVSM_PLANE_FIELDS:
        return "devsm"
    if name in HIER_PLANE_FIELDS:
        return "hier"
    if name in TELEM_PLANE_FIELDS:
        return "telem"
    return "quorum"


class QuorumState(NamedTuple):
    """Struct-of-arrays state for G groups × P peer slots.

    Group-axis ``(G,)`` tensors mirror the per-``raft`` scalars; peer-axis
    ``(G, P)`` tensors mirror the per-``remote`` progress tracker columns.
    """

    # --- per-group scalars ---------------------------------------------
    node_state: torch.Tensor      # (G,) i8: FOLLOWER..WITNESS
    term: torch.Tensor            # (G,) i32
    committed: torch.Tensor       # (G,) i32 rel: log.committed
    last_index: torch.Tensor      # (G,) i32 rel: log.last_index()
    term_start: torch.Tensor      # (G,) i32 rel: first index of current leader term
    quorum: torch.Tensor          # (G,) i32: num_voting//2 + 1
    self_slot: torch.Tensor       # (G,) i32: peer-slot of this replica
    election_tick: torch.Tensor   # (G,) i32
    heartbeat_tick: torch.Tensor  # (G,) i32
    rand_timeout: torch.Tensor    # (G,) i32: randomized election timeout (host-seeded)
    election_timeout: torch.Tensor   # (G,) i32
    heartbeat_timeout: torch.Tensor  # (G,) i32
    electable: torch.Tensor       # (G,) bool: voter, not self-removed, not observer/witness
    check_quorum_on: torch.Tensor  # (G,) bool: config.check_quorum
    live: torch.Tensor            # (G,) bool: row holds a real group

    # --- per-peer columns ----------------------------------------------
    match: torch.Tensor           # (G,P) i32 rel: remote.match
    next: torch.Tensor            # (G,P) i32 rel: remote.next
    voting: torch.Tensor          # (G,P) bool: full member or witness
    present: torch.Tensor         # (G,P) bool: slot occupied (incl. observers)
    active: torch.Tensor          # (G,P) bool: remote.active (CheckQuorum recency)
    votes: torch.Tensor           # (G,P) i8: VOTE_NONE / VOTE_REJECT / VOTE_GRANT

    # --- pending ReadIndex ctx slots (read plane) ------------------------
    read_index: torch.Tensor      # (G,S) i32 rel
    read_count: torch.Tensor      # (G,S) i32
    read_acks: torch.Tensor       # (G,S,P) bool

    # --- device state machine (devsm plane) ------------------------------
    kv_value: torch.Tensor        # (G,V) i32
    kv_ent_index: torch.Tensor    # (G,E) i32 rel; -1 = free
    kv_ent_key: torch.Tensor      # (G,E) i32
    kv_ent_val: torch.Tensor      # (G,E) i32

    # --- hierarchical commit plane ---------------------------------------
    near: torch.Tensor            # (G,P) bool
    sub_quorum: torch.Tensor      # (G,) i32; 0 = hier off

    # --- device telemetry plane ------------------------------------------
    telem_prev_committed: torch.Tensor  # (G,) i32 rel


# name -> (axes after G, numpy dtype, fill).  Axis letters: p peer slots,
# s read slots, v kv value slots, e kv entry slots.  Order = QuorumState's.
FIELDS: Dict[str, tuple] = {
    "node_state": ("", np.int8, 0),
    "term": ("", np.int32, 0),
    "committed": ("", np.int32, 0),
    "last_index": ("", np.int32, 0),
    "term_start": ("", np.int32, 0),
    "quorum": ("", np.int32, 1),
    "self_slot": ("", np.int32, 0),
    "election_tick": ("", np.int32, 0),
    "heartbeat_tick": ("", np.int32, 0),
    "rand_timeout": ("", np.int32, 10),
    "election_timeout": ("", np.int32, 10),
    "heartbeat_timeout": ("", np.int32, 1),
    "electable": ("", np.bool_, False),
    "check_quorum_on": ("", np.bool_, False),
    "live": ("", np.bool_, False),
    "match": ("p", np.int32, 0),
    "next": ("p", np.int32, 1),
    "voting": ("p", np.bool_, False),
    "present": ("p", np.bool_, False),
    "active": ("p", np.bool_, False),
    "votes": ("p", np.int8, VOTE_NONE),
    "read_index": ("s", np.int32, 0),
    "read_count": ("s", np.int32, 0),
    "read_acks": ("sp", np.bool_, False),
    "kv_value": ("v", np.int32, 0),
    "kv_ent_index": ("e", np.int32, -1),
    "kv_ent_key": ("e", np.int32, 0),
    "kv_ent_val": ("e", np.int32, 0),
    "near": ("p", np.bool_, False),
    "sub_quorum": ("", np.int32, 0),
    "telem_prev_committed": ("", np.int32, 0),
}
assert tuple(FIELDS) == QuorumState._fields

_TORCH_DTYPE = {
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _shapes(
    n_groups: int,
    n_peers: int,
    n_read_slots: int = READ_SLOTS,
    n_kv_slots: int = KV_SLOTS,
    n_kv_ents: int = KV_ENT_SLOTS,
) -> Dict[str, tuple]:
    dims = {"p": n_peers, "s": n_read_slots, "v": n_kv_slots, "e": n_kv_ents}
    return {
        name: (n_groups,) + tuple(dims[a] for a in axes)
        for name, (axes, _, _) in FIELDS.items()
    }


def state_layout(
    n_groups: int,
    n_peers: int,
    n_read_slots: int = None,
    n_kv_slots: int = None,
    n_kv_ents: int = None,
) -> dict:
    """Shape/dtype/byte layout of the resident device state, computed from
    :data:`FIELDS` without allocating: the capacity model's source of
    truth (``sum(nbytes) / n_groups`` is the exact bytes per group)."""
    kw = {}
    if n_read_slots is not None:
        kw["n_read_slots"] = n_read_slots
    if n_kv_slots is not None:
        kw["n_kv_slots"] = n_kv_slots
    if n_kv_ents is not None:
        kw["n_kv_ents"] = n_kv_ents
    shapes = _shapes(n_groups, n_peers, **kw)
    out = {}
    for name, (_, dtype, _) in FIELDS.items():
        shape = shapes[name]
        dt = np.dtype(dtype)
        out[name] = {
            "shape": shape,
            "dtype": str(dt),
            "nbytes": int(np.prod(shape, dtype=np.int64)) * dt.itemsize,
            "plane": field_plane(name),
        }
    return out


def _numpy_state(n_groups, n_peers, n_read_slots, n_kv_slots, n_kv_ents):
    shapes = _shapes(n_groups, n_peers, n_read_slots, n_kv_slots, n_kv_ents)
    return {
        name: np.full(shapes[name], fill, dtype)
        for name, (_, dtype, fill) in FIELDS.items()
    }


def make_state(
    n_groups: int,
    n_peers: int,
    n_read_slots: int = READ_SLOTS,
    n_kv_slots: int = KV_SLOTS,
    n_kv_ents: int = KV_ENT_SLOTS,
    device=None,
) -> QuorumState:
    """All-dead state: rows are claimed by the host as groups start.
    ``device=None`` means CUDA (see :func:`..platform.pick_device`)."""
    dev = pick_device(device)
    shapes = _shapes(n_groups, n_peers, n_read_slots, n_kv_slots, n_kv_ents)
    return QuorumState(**{
        name: torch.full(
            shapes[name], fill, dtype=_TORCH_DTYPE[np.dtype(dtype)], device=dev
        )
        for name, (_, dtype, fill) in FIELDS.items()
    })


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor: a pinned staging copy and a
    ``non_blocking`` copy on the current stream for CUDA (the caching host
    allocator keeps the pinned buffer until the copy is done); a private
    copy on the CPU."""
    t = torch.from_numpy(np.array(arr, order="C", copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def state_from_numpy(fields: Dict[str, np.ndarray], device=None) -> QuorumState:
    """A :class:`QuorumState` on ``device`` from numpy arrays, one per
    field (the JAX package's ``QuorumState`` leaves through ``np.asarray``
    fit as they are).  Dtypes must match the layout exactly."""
    dev = pick_device(device)
    missing = set(FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    out = {}
    for name, (_, dtype, _) in FIELDS.items():
        a = np.asarray(fields[name])
        if a.dtype != np.dtype(dtype):
            raise ValueError(f"{name}: dtype {a.dtype}, expected {np.dtype(dtype)}")
        out[name] = _upload(a, dev)
    return QuorumState(**out)


def state_to_numpy(st: QuorumState) -> Dict[str, np.ndarray]:
    """Field name -> numpy array copy of a :class:`QuorumState`."""
    return {name: t.detach().cpu().numpy().copy() for name, t in st._asdict().items()}


class HostMirror:
    """Numpy twin of :class:`QuorumState` for cheap host-side mutation
    (counterpart: ``dragonboat_tpu/ops/state.py`` ``HostMirror``).

    The host mutates rows scalar-style for rare transitions (membership
    change, becoming leader, snapshot restore) and uploads only dirty rows
    between dispatches; per-round updates travel as event batches.
    """

    def __init__(
        self,
        n_groups: int,
        n_peers: int,
        n_read_slots: int = READ_SLOTS,
        n_kv_slots: int = KV_SLOTS,
        n_kv_ents: int = KV_ENT_SLOTS,
    ):
        self.n_groups = n_groups
        self.n_peers = n_peers
        self.n_read_slots = n_read_slots
        self.n_kv_slots = n_kv_slots
        self.n_kv_ents = n_kv_ents
        self.arrays = _numpy_state(
            n_groups, n_peers, n_read_slots, n_kv_slots, n_kv_ents
        )

    def to_device(self, device=None) -> QuorumState:
        """Upload every field: pinned host tensors copied ``non_blocking``
        on the current stream (CUDA), or private copies (CPU)."""
        dev = pick_device(device)
        return QuorumState(**{k: _upload(v, dev) for k, v in self.arrays.items()})

    def pull(self, st: QuorumState) -> None:
        for k, v in st._asdict().items():
            np.copyto(self.arrays[k], v.detach().cpu().numpy())

    def recycle_row(
        self,
        row: int,
        term: int,
        term_start: int,
        last_index: int,
        clear_reads: bool = True,
        clear_kv: bool = True,
        clear_telem: bool = True,
    ) -> None:
        """Numpy twin of the in-program recycle (``kernels._apply_recycle``):
        reset a row to a fresh same-geometry leader tenant WITHOUT touching
        membership columns.  The engine applies this when it stages a
        device-side recycle so host reads of the row see what the
        dispatched program will compute; the row is not marked dirty."""
        a = self.arrays
        a["live"][row] = True
        a["node_state"][row] = LEADER
        a["term"][row] = term
        a["term_start"][row] = term_start
        a["last_index"][row] = last_index
        a["committed"][row] = 0
        a["election_tick"][row] = 0
        a["heartbeat_tick"][row] = 0
        a["match"][row, :] = 0
        a["match"][row, a["self_slot"][row]] = last_index
        a["next"][row, :] = last_index + 1
        a["active"][row, :] = False
        a["votes"][row, :] = VOTE_NONE
        if clear_reads:
            self.clear_reads(row)
        if clear_kv:
            self.clear_kv(row)
        if clear_telem:
            self.clear_telem(row)

    def row_image(self, row: int, skip=frozenset()) -> dict:
        """Per-field copy of one row (``skip`` names fields left behind)."""
        return {
            k: np.copy(a[row]) for k, a in self.arrays.items() if k not in skip
        }

    def restore_row(self, row: int, image: dict) -> None:
        """Paste a captured ``row_image`` onto ``row`` verbatim; the caller
        owns dirty tracking (the row must be re-uploaded)."""
        a = self.arrays
        for k, v in image.items():
            a[k][row] = v

    def clear_kv(self, row: int) -> None:
        """Reset a row's device state machine: values and entry buffer."""
        self.arrays["kv_value"][row, :] = 0
        self.clear_kv_ents(row)

    def clear_kv_ents(self, row: int) -> None:
        """Free a row's pending-entry buffer, keeping the value slots."""
        a = self.arrays
        a["kv_ent_index"][row, :] = -1
        a["kv_ent_key"][row, :] = 0
        a["kv_ent_val"][row, :] = 0

    def clear_hier(self, row: int) -> None:
        """Reset a row's hier sub-quorum geometry (the rule off).  A
        recycle keeps it: a same-geometry tenant keeps its domains."""
        self.arrays["near"][row, :] = False
        self.arrays["sub_quorum"][row] = 0

    def clear_telem(self, row: int) -> None:
        """Reset a row's telemetry watermark."""
        self.arrays["telem_prev_committed"][row] = 0

    def clear_reads(self, row: int) -> None:
        """Drop a row's pending ReadIndex slots."""
        a = self.arrays
        a["read_index"][row, :] = 0
        a["read_count"][row, :] = 0
        a["read_acks"][row, :, :] = False
