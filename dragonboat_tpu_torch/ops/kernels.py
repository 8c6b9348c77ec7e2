"""Kernels of the batched quorum engine: plain PyTorch versions and the
wrappers that launch the hand-written CUDA kernels.

Counterpart: ``dragonboat_tpu/ops/kernels.py``.  Each ``*_impl`` function
and helper here follows its JAX twin line by line and is functional (it
returns new tensors).  The entry points :func:`quorum_step`,
:func:`quorum_step_dense`, :func:`quorum_multiround`,
:func:`quorum_multistep`, :func:`quorum_multistep_dense` and
:func:`telem_fold` keep the reference's names, argument order and static
flags, and :func:`staged_multistep` is ``bench.py``'s
``_staged_multistep_fn``.  All update the state tensors IN PLACE where
the reference donated them (``donate_argnums=(0,)``): the returned
``StepOutputs.state`` is the caller's state, and
``StepOutputs.committed`` is its ``committed`` tensor.  With ``has_telem`` a step's ``StepOutputs.telem`` is the
:class:`TelemAggregate` of the fold run after it, whose fields are views
of one fixed-size int32 block (:func:`telem_block`).  With ``has_reads``
the dense and K-round steps run the device read plane (:func:`_read_plane`)
and return its (G,S) ``read_done_count`` / ``read_done_index``; with
``has_kv`` they run the device state machine (:func:`_kv_plane`) and
return its (G,R) ``kv_read_val`` / ``kv_read_index`` and (G,)
``kv_applied``.  On the sparse step ``has_reads`` and ``has_kv`` only tell
the fold to count read and entry slots, as in the reference (the engine
forces the dense step whenever reads or kv events are staged).

Routing is by the device the state lies on, and by nothing else:

* CUDA tensors launch the kernel in ``csrc/`` (built at first use, see
  :mod:`._build`) on the current stream, or raise;
* CPU tensors run the plain version, whose result is copied into the
  state tensors.

Each wrapper counts its kernel launches (:func:`launch_counts`); a
launch of a step kernel's ``has_hier`` instance also counts under
``finish_hier``, the hier commit branch it carries, and a launch of a
``has_reads`` instance under ``read_plane``.  The device state machine is
a kernel of its own (``csrc/kv_plane.cu``, counter ``kv_plane``), launched
after K1 or K3 on the same stream; a K-round block passes it each
round's watermark through a (K, G) trace that K3 writes.  The R-round
scans share one row loop and the staged ladder dispatch has its own
(``csrc/quorum_multistep.cu``), counted under ``quorum_multistep``,
``quorum_multistep_dense`` and ``staged_multistep``.

Contract on event indexes: the sparse step (and the sparse scan, round by
round) drops events whose row or slot
lies outside ``[0, G) x [0, P)``.  The JAX step routes invalid events to
row G and drops them too, but wraps a NEGATIVE valid index the way numpy
indexing does; the engine never stages one.  A batch holds each (row,
slot) vote cell at most once (``BatchedQuorumEngine.vote`` dedups), and a
round recycles each row at most once (``stage_recycle`` enforces it): the
reference leaves duplicates unspecified, and so does the port.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .state import CANDIDATE, INDEX_MIN, LEADER, VOTE_NONE, QuorumState

I32 = torch.int32
I8 = torch.int8
BOOL = torch.bool

# Device telemetry fold (reference ``kernels.py:185-190``): the aggregate
# has a fixed size whatever G is.
TELEM_LAG_BUCKETS = 16
TELEM_STATES = 5   # FOLLOWER..WITNESS
TELEM_TOPK = 8
# The fold's flat int32 block: lag_hist, state_counts, stalled, read_slots,
# kv_ents, then topk_row (k) and topk_lag (k).
TELEM_HEAD = TELEM_LAG_BUCKETS + TELEM_STATES + 3
# Threads a block of the fold's row pass (TELEM_BLOCK in csrc/telem_fold.cu):
# each block leaves k top-K candidates in the scratch buffer.
_TELEM_BLOCK = 256

# The widest peer axis the CUDA kernels take (QS_MAX_GENERIC_P in
# csrc/quorum.cuh); the plain versions take any width.
MAX_KERNEL_PEERS = 32
# The most pending-read slots (S) the CUDA read plane takes
# (QS_MAX_READ_SLOTS in csrc/quorum.cuh): a row's slots live in registers.
MAX_KERNEL_READ_SLOTS = 8
# The widest entry buffer (E), read-slot axis (R) and value row (V) the
# CUDA device state machine takes (QS_MAX_KV_* in csrc/kv_plane.cu): a
# row's entries and read captures live in registers.
MAX_KERNEL_KV_ENTS = 32
MAX_KERNEL_KV_READS = 8
MAX_KERNEL_KV_SLOTS = 1024

# Launch-flag bits of csrc/quorum.cuh.
_F_DO_TICK, _F_TRACK_CONTACT, _F_HAS_VOTES, _F_HAS_CHURN = 1, 2, 4, 8
_F_HAS_HIER, _F_RESET_TELEM = 16, 32
_F_HAS_READS, _F_RESET_READS = 64, 128
# ... of csrc/telem_fold.cu ...
_F_COUNT_READS, _F_COUNT_KV = 1, 2
# ... and of csrc/kv_plane.cu.
_KV_PLANE, _KV_CARRY, _KV_RESET = 1, 2, 4

# Optimal compare-exchange networks (Knuth TAOCP v3 §5.3.4) per width;
# each pair (i, j) with i < j exchanges so the LARGER value lands at i —
# after the full network the columns are sorted descending.
_SORT_NETWORKS = {
    1: [],
    2: [(0, 1)],
    3: [(0, 1), (1, 2), (0, 1)],
    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)],
    5: [(0, 1), (3, 4), (2, 4), (2, 3), (1, 4), (0, 3), (0, 2), (1, 3),
        (1, 2)],
    6: [(1, 2), (4, 5), (0, 2), (3, 5), (0, 1), (3, 4), (2, 5), (0, 3),
        (1, 4), (2, 4), (1, 3), (2, 3)],
    7: [(1, 2), (3, 4), (5, 6), (0, 2), (3, 5), (4, 6), (0, 1), (4, 5),
        (2, 6), (0, 4), (1, 5), (0, 3), (2, 5), (1, 3), (2, 4), (2, 3)],
    8: [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
        (2, 4), (3, 5), (3, 4)],
}

_LAUNCHES = {"quorum_step": 0, "quorum_step_dense": 0, "quorum_multiround": 0,
             "telem_fold": 0, "finish_hier": 0, "read_plane": 0, "kv_plane": 0,
             "quorum_multistep": 0, "quorum_multistep_dense": 0,
             "staged_multistep": 0}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (a CPU call runs
    the plain version and counts nothing)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


class TickFlags(NamedTuple):
    elect_due: torch.Tensor      # (G,) bool — non-leader election timeout fired
    hb_due: torch.Tensor         # (G,) bool — leader heartbeat due
    checkq_demote: torch.Tensor  # (G,) bool — CheckQuorum window: leader re-checks


class TelemAggregate(NamedTuple):
    """Fixed-size health aggregate of :func:`telem_fold` (reference
    ``kernels.TelemAggregate``).  ``lag`` is the device commit lag
    ``last_index - committed`` of live groups."""

    lag_hist: torch.Tensor      # (B,) i32 — live groups per log2 lag bucket
    state_counts: torch.Tensor  # (TELEM_STATES,) i32 — live groups per raft state
    stalled: torch.Tensor       # () i32 — live, lag > 0, committed flat since last fold
    read_slots: torch.Tensor    # () i32 — occupied ReadIndex slots (read_count > 0)
    kv_ents: torch.Tensor       # () i32 — occupied devsm entry slots (index >= 0)
    topk_row: torch.Tensor      # (K,) i32 — worst rows by lag; -1 = fewer than K live
    topk_lag: torch.Tensor      # (K,) i32 — their lag values


class StepOutputs(NamedTuple):
    """Outputs of one step (reference ``kernels.StepOutputs``).  With
    ``has_reads`` the read egress: per pending-read slot, the reads
    confirmed this dispatch and the rel index they were released at (-1 =
    none); a K-round block sums the counts and takes the largest index
    over its rounds.  With ``has_kv`` the devsm egress: per KV read slot
    the captured value and the watermark it reflects (-1 = no capture; a
    K-round block keeps the round whose index is >= 0, the last such), and
    per row the entries applied (summed over a block's rounds)."""

    state: QuorumState
    committed: torch.Tensor    # (G,) i32 rel — post-step commit watermark
    won: torch.Tensor          # (G,) bool — candidate reached vote quorum
    lost: torch.Tensor         # (G,) bool — candidate rejected by quorum
    flags: TickFlags
    read_done_count: Optional[torch.Tensor] = None  # (G,S) i32
    read_done_index: Optional[torch.Tensor] = None  # (G,S) i32 rel, -1 = none
    kv_read_val: Optional[torch.Tensor] = None     # (G,R) i32
    kv_read_index: Optional[torch.Tensor] = None   # (G,R) i32 rel, -1 = none
    kv_applied: Optional[torch.Tensor] = None      # (G,) i32
    telem: Optional[TelemAggregate] = None


def _scalar(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------------
# plain versions (counterparts of the JAX functions, line by line)
# ----------------------------------------------------------------------


def _kth_largest(values: torch.Tensor, mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row-wise k-th largest of masked values; k is 1-based, (G,).

    P <= 8: an optimal compare-exchange network over the P columns, then
    column k-1 by a where-chain (column 0 when k is out of range).  Wider
    P: the rank form — each element's descending rank is the count of
    elements that beat it (value, then slot index as the tie-break), and
    the element of rank k-1 is taken by a masked sum.  Precondition
    ``1 <= k <= P``; out-of-range k is unspecified, and the two forms
    disagree on it (as in the reference)."""
    masked = torch.where(mask, values, _scalar(INDEX_MIN, values))
    p = masked.shape[1]
    ksel = k - 1
    if p in _SORT_NETWORKS:
        cols = [masked[:, i] for i in range(p)]
        for i, j in _SORT_NETWORKS[p]:
            hi = torch.maximum(cols[i], cols[j])
            cols[j] = torch.minimum(cols[i], cols[j])
            cols[i] = hi
        out = cols[0]
        for i in range(1, p):  # cols sorted descending; pick column k-1
            out = torch.where(ksel == i, cols[i], out)
        return out
    v_i = masked[:, :, None]  # candidate
    v_j = masked[:, None, :]  # competitor
    slot = torch.arange(p, dtype=I32, device=masked.device)
    beats = (v_j > v_i) | (
        (v_j == v_i) & (slot[None, None, :] < slot[None, :, None])
    )
    rank = beats.sum(2, dtype=I32)  # 0-based, descending, unique
    sel = rank == ksel[:, None]
    return torch.where(sel, masked, 0).sum(1, dtype=I32)


def _self_column(match: torch.Tensor, self_slot: torch.Tensor) -> torch.Tensor:
    """``match[g, self_slot[g]]`` for every group as a one-hot masked sum;
    an out-of-range ``self_slot`` selects nothing and gives 0."""
    p = match.shape[1]
    sel = self_slot[:, None] == torch.arange(p, dtype=I32, device=match.device)
    return torch.where(sel, match, 0).sum(1, dtype=I32)


def commit_quorum(match: torch.Tensor, voting: torch.Tensor, quorum: torch.Tensor) -> torch.Tensor:
    """Quorum match index per group (scalar twin: ``Raft.try_commit``)."""
    return _kth_largest(match, voting, quorum)


def vote_tally(votes: torch.Tensor, voting: torch.Tensor, quorum: torch.Tensor):
    """(granted, rejected) counts per group (twin: ``handle_vote_resp``)."""
    granted = ((votes == 1) & voting).sum(1, dtype=I32)
    rejected = ((votes == 0) & voting).sum(1, dtype=I32)
    return granted, rejected


def check_quorum(active, voting, self_slot, quorum):
    """(has_quorum, cleared_active) per group (twin: ``leader_has_quorum``):
    counts self plus recently-active voters; voters' activity is consumed."""
    p = active.shape[1]
    self_onehot = self_slot[:, None] == torch.arange(p, dtype=I32, device=active.device)
    count = ((active | self_onehot) & voting).sum(1, dtype=I32)
    cleared = active & ~voting
    return count >= quorum, cleared


def tick_step(st: QuorumState):
    """Advance per-group clocks one tick (twin: ``Raft.tick``); returns the
    new state and the :class:`TickFlags`."""
    live = st.live
    is_leader = (st.node_state == LEADER) & live
    election_tick = torch.where(live, st.election_tick + 1, st.election_tick)
    # non-leader: election timeout (raft.go:568-592)
    elect_due = live & ~is_leader & st.electable & (election_tick >= st.rand_timeout)
    # leader: CheckQuorum window (raft.go:594-623)
    checkq_due = is_leader & (election_tick >= st.election_timeout)
    election_tick = torch.where(elect_due | checkq_due, 0, election_tick)
    _, cleared_active = check_quorum(st.active, st.voting, st.self_slot, st.quorum)
    run_checkq = checkq_due & st.check_quorum_on
    # fires on every window expiry: the scalar CHECK_QUORUM handler decides
    checkq_demote = run_checkq
    active = torch.where(run_checkq[:, None], cleared_active, st.active)
    heartbeat_tick = torch.where(is_leader, st.heartbeat_tick + 1, st.heartbeat_tick)
    hb_due = is_leader & (heartbeat_tick >= st.heartbeat_timeout)
    heartbeat_tick = torch.where(hb_due, 0, heartbeat_tick)
    st = st._replace(
        election_tick=election_tick, heartbeat_tick=heartbeat_tick, active=active
    )
    return st, TickFlags(elect_due, hb_due, checkq_demote)


def telem_fold_impl(st: QuorumState, k: int = TELEM_TOPK,
                    count_reads: bool = True, count_kv: bool = True):
    """Reduce per-group health signals into one :class:`TelemAggregate`
    and advance ``telem_prev_committed`` to this fold's watermark
    (reference ``telem_fold``).  Functional: returns (state, aggregate)."""
    live = st.live
    lag = torch.where(live, torch.clamp_min(st.last_index - st.committed, 0), 0)
    # exact integer log2 bucket = #{i < B-1 : lag >= 2^i}
    thresholds = torch.tensor(
        [1 << i for i in range(TELEM_LAG_BUCKETS - 1)], dtype=I32,
        device=lag.device,
    )
    bucket = torch.searchsorted(thresholds, lag, right=True).to(I32)
    bucket_ids = torch.arange(TELEM_LAG_BUCKETS, dtype=I32, device=lag.device)
    lag_hist = (
        (bucket[:, None] == bucket_ids[None, :]) & live[:, None]
    ).sum(0, dtype=I32)
    state_ids = torch.arange(TELEM_STATES, dtype=I32, device=lag.device)
    state_counts = (
        (st.node_state.to(I32)[:, None] == state_ids[None, :]) & live[:, None]
    ).sum(0, dtype=I32)
    stalled = (
        live & (st.committed == st.telem_prev_committed) & (lag > 0)
    ).sum(dtype=I32)
    zero = torch.zeros((), dtype=I32, device=lag.device)
    read_slots = (st.read_count > 0).sum(dtype=I32) if count_reads else zero
    kv_ents = (st.kv_ent_index >= 0).sum(dtype=I32) if count_kv else zero
    # top-K worst rows by lag, dead rows at -1: K argmax passes, each
    # taking the FIRST maximal index, so ties go to the lower row
    masked = torch.where(live, lag, -1).to(I32)
    k = min(int(k), masked.shape[0])
    rows, lags = [], []
    for _ in range(k):
        i = torch.argmax(masked).to(I32)
        rows.append(i)
        lags.append(masked[i])
        masked = masked.clone()
        masked[i] = INDEX_MIN
    topk_row = torch.stack(rows)
    topk_lag = torch.stack(lags)
    topk_row = torch.where(topk_lag >= 0, topk_row, -1).to(I32)
    st = st._replace(telem_prev_committed=st.committed)
    return st, TelemAggregate(
        lag_hist, state_counts, stalled, read_slots, kv_ents,
        topk_row, topk_lag,
    )


def read_confirm(read_acks, read_count, voting, self_slot, quorum, node_state,
                 live) -> torch.Tensor:
    """(G,S) bool: the pending-read slots whose echo quorum is reached
    (twin: ``ReadIndex.confirm``): the leader counts itself through the
    self column's one-hot (none where ``self_slot`` is outside [0, P)),
    only voters' echoes count, and only live leaders confirm."""
    p = voting.shape[1]
    self_onehot = self_slot[:, None] == torch.arange(p, dtype=I32, device=voting.device)
    acked = (read_acks | self_onehot[:, None, :]) & voting[:, None, :]
    count = acked.sum(2, dtype=I32)
    is_leader = (node_state == LEADER) & live
    return (count >= quorum[:, None]) & (read_count > 0) & is_leader[:, None]


def _read_plane(st: QuorumState, stage_idx, stage_cnt, ack):
    """One round of the device read plane: stage, echo ingest, confirm,
    release.  ``stage_idx`` (G,S) i32 is the new batch's index per slot
    (-1 = no stage), ``stage_cnt`` its reads, ``ack`` (G,S,P) bool this
    round's echoes.  Staging a slot REPLACES its acks with this round's
    echoes; an unstaged slot ORs them in.  A confirmed slot frees (count
    0, acks cleared) and keeps its index.  Returns ``(state, done_count,
    done_index)``, the batches released this round (index -1 = none)."""
    staged = stage_idx >= 0
    read_index = torch.where(staged, stage_idx, st.read_index)
    read_count = torch.where(staged, stage_cnt, st.read_count)
    read_acks = torch.where(staged[:, :, None], ack, st.read_acks | ack)
    confirmed = read_confirm(
        read_acks, read_count, st.voting, st.self_slot, st.quorum,
        st.node_state, st.live,
    )
    done_count = torch.where(confirmed, read_count, 0)
    done_index = torch.where(confirmed, read_index, -1)
    read_count = torch.where(confirmed, 0, read_count)
    read_acks = read_acks & ~confirmed[:, :, None]
    st = st._replace(
        read_index=read_index, read_count=read_count, read_acks=read_acks
    )
    return st, done_count, done_index


def _one_hot(key: torch.Tensor, v: int) -> torch.Tensor:
    """``jax.nn.one_hot(key, v, dtype=bool)``: all-zero where ``key`` lies
    outside [0, v)."""
    return key[..., None] == torch.arange(v, dtype=I32, device=key.device)


def _kv_plane(st: QuorumState, ent_idx, ent_key, ent_val, read_key):
    """One round of the device state machine: stage, apply, read.
    ``ent_idx`` (G,E) i32 is each buffer slot's staged op log index (-1 =
    no stage), ``ent_key`` / ``ent_val`` its key slot and value,
    ``read_key`` (G,R) the staged KV read keys (-1 = no read).  Every
    buffered entry at or below the commit watermark applies and frees its
    slot: the value of a key becomes that of its highest-index ready entry
    (the sum of the values where ready entries share that index).  Reads
    capture the post-apply value and the watermark.  Returns ``(state,
    read_val, read_idx, applied)``."""
    staged = ent_idx >= 0
    b_idx = torch.where(staged, ent_idx, st.kv_ent_index)
    b_key = torch.where(staged, ent_key, st.kv_ent_key)
    b_val = torch.where(staged, ent_val, st.kv_ent_val)
    v = st.kv_value.shape[1]
    ready = (b_idx >= 0) & (b_idx <= st.committed[:, None])      # (G,E)
    key_oh = _one_hot(b_key, v)                                  # (G,E,V)
    sel = ready[:, :, None] & key_oh
    masked_idx = torch.where(sel, b_idx[:, :, None], -1)         # (G,E,V)
    win_idx = masked_idx.max(dim=1).values                       # (G,V)
    is_win = sel & (masked_idx == win_idx[:, None, :]) & (win_idx[:, None, :] >= 0)
    new_val = torch.where(is_win, b_val[:, :, None], 0).sum(1, dtype=I32)
    kv_value = torch.where(win_idx >= 0, new_val, st.kv_value)   # (G,V)
    applied = ready.sum(1, dtype=I32)                            # (G,)
    b_idx = torch.where(ready, -1, b_idx)                        # free applied slots
    st = st._replace(
        kv_value=kv_value, kv_ent_index=b_idx, kv_ent_key=b_key, kv_ent_val=b_val,
    )
    has_read = read_key >= 0                                     # (G,R)
    read_oh = _one_hot(read_key, v)                              # (G,R,V)
    read_val = torch.where(read_oh, kv_value[:, None, :], 0).sum(2, dtype=I32)
    read_val = torch.where(has_read, read_val, 0)
    read_idx = torch.where(has_read, st.committed[:, None], -1)
    return st, read_val, read_idx, applied


def _finish_step(st, match, next_, active, votes, election_tick, last_index,
                 do_tick: bool, has_hier: bool = False) -> StepOutputs:
    """Tally/commit/tick tail shared by the sparse and dense steps."""
    granted, rejected = vote_tally(votes, st.voting, st.quorum)
    is_cand = (st.node_state == CANDIDATE) & st.live
    won = is_cand & (granted >= st.quorum)
    lost = is_cand & (rejected >= st.quorum)
    q = commit_quorum(match, st.voting, st.quorum)
    if has_hier:
        # hier sub-quorum rule: the near-domain k-th largest can close
        # ahead of the far acks; the classic quorum stays the floor.  The
        # clamp only meets _kth_largest's 1 <= k; where sub_quorum == 0
        # the where() discards it.
        q_near = _kth_largest(
            match, st.voting & st.near, torch.clamp_min(st.sub_quorum, 1)
        )
        q = torch.where(st.sub_quorum > 0, torch.maximum(q, q_near), q)
    is_leader = (st.node_state == LEADER) & st.live
    # only current-term entries commit by counting: q >= term_start
    can_commit = is_leader & (q > st.committed) & (q >= st.term_start)
    committed = torch.where(can_commit, q, st.committed)
    st = st._replace(
        match=match, next=next_, active=active, votes=votes,
        committed=committed, last_index=last_index, election_tick=election_tick,
    )
    if do_tick:
        st, flags = tick_step(st)
    else:
        zeros = torch.zeros_like(won)
        flags = TickFlags(zeros, zeros, zeros)
    return StepOutputs(st, committed, won, lost, flags)


def quorum_step_impl(
    st: QuorumState,
    ack_g, ack_p, ack_val, ack_valid,
    vote_g, vote_p, vote_grant, vote_valid,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
    has_telem: bool = False,
    telem_k: int = TELEM_TOPK,
    has_reads: bool = False,
    has_kv: bool = False,
) -> StepOutputs:
    """One sparse round: scatter-max ack ingest, contact, first-wins votes,
    then the tail, then the telemetry fold where ``has_telem`` says so
    (``has_reads`` and ``has_kv`` only make it count read and entry
    slots).  Functional; see the module docstring on indexes."""
    g_total, p = st.match.shape
    ag, ap = ack_g.long(), ack_p.long()
    row_ok = ack_valid & (ag >= 0) & (ag < g_total)
    cell_ok = row_ok & (ap >= 0) & (ap < p)
    cells = (ag * p + ap)[cell_ok]
    # remote.try_update keeps only forward progress: max is exact
    match = st.match.reshape(-1).clone().scatter_reduce_(
        0, cells, ack_val[cell_ok], reduce="amax", include_self=True
    ).reshape(g_total, p)
    next_ = torch.maximum(st.next, match + 1)
    active = st.active.clone()
    active.view(-1)[cells] = True
    if track_contact:
        contacted = torch.zeros((g_total,), dtype=BOOL, device=match.device)
        contacted[ag[row_ok]] = True
        nonleader = (st.node_state != LEADER) & st.live
        election_tick = torch.where(contacted & nonleader, 0, st.election_tick)
    else:
        election_tick = st.election_tick
    last_index = torch.maximum(st.last_index, _self_column(match, st.self_slot))
    if has_votes:
        vg, vp = vote_g.long(), vote_p.long()
        v_ok = vote_valid & (vg >= 0) & (vg < g_total) & (vp >= 0) & (vp < p)
        vcells = (vg * p + vp)[v_ok]
        flat = st.votes.reshape(-1)
        cur = flat[vcells]
        newv = torch.where(cur == VOTE_NONE, vote_grant[v_ok], cur)
        votes = flat.clone()
        votes[vcells] = newv
        votes = votes.reshape(g_total, p)
    else:
        votes = st.votes
    out = _finish_step(
        st, match, next_, active, votes, election_tick, last_index, do_tick,
        has_hier=has_hier,
    )
    if has_telem:
        tst, agg = telem_fold_impl(
            out.state, telem_k, count_reads=has_reads, count_kv=has_kv,
        )
        out = out._replace(state=tst, telem=agg)
    return out


def quorum_step_dense_impl(
    st: QuorumState,
    ack_max, ack_touched, vote_new,
    read_stage_idx=None, read_stage_cnt=None, read_ack=None,
    kv_ent_idx=None, kv_ent_key=None, kv_ent_val=None, kv_read_key=None,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_reads: bool = False,
    has_kv: bool = False,
    has_hier: bool = False,
    has_telem: bool = False,
    telem_k: int = TELEM_TOPK,
) -> StepOutputs:
    """Dense-ingestion twin of :func:`quorum_step_impl`: ``ack_max`` holds
    0 in untouched cells, ``vote_new`` first-wins-deduped votes.  With
    ``has_reads`` the read plane runs after the tail (and the tick), on
    ``read_stage_idx`` (G,S), ``read_stage_cnt`` (G,S) and ``read_ack``
    (G,S,P); with ``has_kv`` the device state machine runs after it, on
    ``kv_ent_idx`` / ``kv_ent_key`` / ``kv_ent_val`` (G,E) and
    ``kv_read_key`` (G,R)."""
    match = torch.maximum(st.match, torch.where(ack_touched, ack_max, 0))
    next_ = torch.maximum(st.next, match + 1)
    active = st.active | ack_touched
    if track_contact:
        contacted = ack_touched.any(1)
        nonleader = (st.node_state != LEADER) & st.live
        election_tick = torch.where(contacted & nonleader, 0, st.election_tick)
    else:
        election_tick = st.election_tick
    last_index = torch.maximum(st.last_index, _self_column(match, st.self_slot))
    if has_votes:
        votes = torch.where(
            (st.votes == VOTE_NONE) & (vote_new != VOTE_NONE), vote_new, st.votes
        )
    else:
        votes = st.votes
    out = _finish_step(
        st, match, next_, active, votes, election_tick, last_index, do_tick,
        has_hier=has_hier,
    )
    if has_reads:
        rst, done_cnt, done_idx = _read_plane(
            out.state, read_stage_idx, read_stage_cnt, read_ack
        )
        out = out._replace(
            state=rst, read_done_count=done_cnt, read_done_index=done_idx
        )
    if has_kv:
        # after the commit (an entry committing this round applies this
        # round) and after the read plane
        kst, kv_rv, kv_ri, kv_ap = _kv_plane(
            out.state, kv_ent_idx, kv_ent_key, kv_ent_val, kv_read_key
        )
        out = out._replace(
            state=kst, kv_read_val=kv_rv, kv_read_index=kv_ri, kv_applied=kv_ap,
        )
    if has_telem:
        # the fold LAST: it describes the state this dispatch leaves
        tst, agg = telem_fold_impl(
            out.state, telem_k, count_reads=has_reads, count_kv=has_kv,
        )
        out = out._replace(state=tst, telem=agg)
    return out


def _apply_recycle(st: QuorumState, row, term, start, last,
                   reset_reads: bool = True,
                   reset_kv: bool = True,
                   reset_telem: bool = True) -> QuorumState:
    """Masked leader-recycle row reset (twin: ``remove_group`` +
    ``add_group`` + ``set_leader`` for a same-geometry tenant).  Rows
    outside [0, G) are padding and dropped.  Membership and the hier
    geometry stay.  ``reset_reads`` drops the old tenant's pending reads,
    ``reset_kv`` gives the fresh tenant an empty device state machine
    (values 0, entry buffer free) and ``reset_telem`` zeroes its stall
    horizon."""
    g, p = st.match.shape
    keep = (row >= 0) & (row < g)
    rows = row[keep].long()
    term, start, last = term[keep], start[keep], last[keep]
    sel = st.self_slot[rows]
    cols = torch.arange(p, dtype=I32, device=row.device)[None, :]
    match_rows = torch.where(cols == sel[:, None], last[:, None], 0)
    next_rows = (last[:, None] + 1).expand(match_rows.shape)

    def put(t, value):
        out = t.clone()
        out[rows] = value
        return out

    if reset_reads:
        st = st._replace(
            read_index=put(st.read_index, 0),
            read_count=put(st.read_count, 0),
            read_acks=put(st.read_acks, False),
        )
    if reset_kv:
        st = st._replace(
            kv_value=put(st.kv_value, 0),
            kv_ent_index=put(st.kv_ent_index, -1),
            kv_ent_key=put(st.kv_ent_key, 0),
            kv_ent_val=put(st.kv_ent_val, 0),
        )
    if reset_telem:
        st = st._replace(
            telem_prev_committed=put(st.telem_prev_committed, 0)
        )
    return st._replace(
        node_state=put(st.node_state, LEADER),
        live=put(st.live, True),
        term=put(st.term, term),
        term_start=put(st.term_start, start),
        last_index=put(st.last_index, last),
        committed=put(st.committed, 0),
        election_tick=put(st.election_tick, 0),
        heartbeat_tick=put(st.heartbeat_tick, 0),
        match=put(st.match, match_rows),
        next=put(st.next, next_rows),
        active=put(st.active, False),
        votes=put(st.votes, VOTE_NONE),
    )


def quorum_multiround_impl(
    st: QuorumState,
    ack_max,      # (K,G,P) i32 — per-round ack maxima; -1 = untouched
    vote_new,     # (K,G,P) i8, or a dummy when not has_votes
    churn_row,    # (K,C) i32 — rows recycled at round start; G = pad
    churn_term,   # (K,C) i32
    churn_start,  # (K,C) i32 rel
    churn_last,   # (K,C) i32 rel
    tick_mask,    # (K,) bool — which rounds tick
    read_stage_idx=None, read_stage_cnt=None, read_ack=None,
    kv_ent_idx=None, kv_ent_key=None, kv_ent_val=None, kv_read_key=None,
    do_tick: bool = False,
    track_contact: bool = True,
    has_votes: bool = False,
    has_churn: bool = False,
    has_reads: bool = False,
    purge_reads: bool = False,
    has_kv: bool = False,
    purge_kv: bool = False,
    has_hier: bool = False,
    has_telem: bool = False,
    purge_telem: bool = False,
    telem_k: int = TELEM_TOPK,
) -> StepOutputs:
    """K engine rounds, including in-program churn: per round (1) that
    round's row recycles, (2) the dense ingest of its ``-1``-sentinel ack
    block and votes, (3) tally/commit, (4) with ``has_reads`` the read
    plane on that round's (K,G,S) / (K,G,S,P) read inputs, (5) with
    ``has_kv`` the device state machine on its (K,G,E) / (K,G,R) inputs,
    then the tick where ``tick_mask`` says so.  Flags OR over the rounds;
    the final watermark is the egress; the read egress sums the counts
    and takes the largest index over the rounds; the kv egress keeps each
    read slot's capture from the rounds whose index is >= 0 and sums the
    applied entries.  With ``has_telem`` the fold runs ONCE, on the
    block's final state.

    The ``purge_*`` flags reset a plane on recycle; the port defaults
    them to False (the reference defaults them to True, a no-op on planes
    never used).  A recycle resets the read slots where ``has_reads`` or
    ``purge_reads`` is set, and the device state machine where ``has_kv``
    or ``purge_kv`` is."""
    g = st.match.shape[0]
    dev = st.match.device
    zeros = torch.zeros((g,), dtype=BOOL, device=dev)
    won = lost = elect = hb = demote = zeros
    done_cnt = done_idx = None
    if has_reads:
        s = st.read_index.shape[1]
        done_cnt = torch.zeros((g, s), dtype=I32, device=dev)
        done_idx = torch.full((g, s), -1, dtype=I32, device=dev)
    kval = kidx = kap = None
    if has_kv:
        r_slots = kv_read_key.shape[2]
        kval = torch.zeros((g, r_slots), dtype=I32, device=dev)
        kidx = torch.full((g, r_slots), -1, dtype=I32, device=dev)
        kap = torch.zeros((g,), dtype=I32, device=dev)
    for r in range(ack_max.shape[0]):
        if has_churn:
            st = _apply_recycle(
                st, churn_row[r], churn_term[r], churn_start[r], churn_last[r],
                reset_reads=has_reads or purge_reads,
                reset_kv=has_kv or purge_kv,
                reset_telem=has_telem or purge_telem,
            )
        am = ack_max[r]
        reads_r = ((read_stage_idx[r], read_stage_cnt[r], read_ack[r])
                   if has_reads else (None, None, None))
        kv_r = ((kv_ent_idx[r], kv_ent_key[r], kv_ent_val[r], kv_read_key[r])
                if has_kv else (None, None, None, None))
        out = quorum_step_dense_impl(
            st, am.clamp_min(0), am >= 0,
            vote_new[r] if has_votes else None, *reads_r, *kv_r,
            do_tick=False, track_contact=track_contact, has_votes=has_votes,
            has_reads=has_reads, has_kv=has_kv, has_hier=has_hier,
        )
        st = out.state
        won, lost = won | out.won, lost | out.lost
        if has_reads:
            done_cnt = done_cnt + out.read_done_count
            done_idx = torch.maximum(done_idx, out.read_done_index)
        if has_kv:
            # a KV read slot captures in one round of the block: overwrite
            # where this round captured
            kcap = out.kv_read_index >= 0
            kval = torch.where(kcap, out.kv_read_val, kval)
            kidx = torch.where(kcap, out.kv_read_index, kidx)
            kap = kap + out.kv_applied
        if do_tick:
            tm = tick_mask[r]
            ticked, tflags = tick_step(st)
            st = st._replace(
                election_tick=torch.where(tm, ticked.election_tick, st.election_tick),
                heartbeat_tick=torch.where(tm, ticked.heartbeat_tick, st.heartbeat_tick),
                active=torch.where(tm, ticked.active, st.active),
            )
            elect = elect | (tflags.elect_due & tm)
            hb = hb | (tflags.hb_due & tm)
            demote = demote | (tflags.checkq_demote & tm)
    telem = None
    if has_telem:
        st, telem = telem_fold_impl(
            st, telem_k, count_reads=has_reads, count_kv=has_kv,
        )
    return StepOutputs(
        st, st.committed, won, lost, TickFlags(elect, hb, demote),
        read_done_count=done_cnt, read_done_index=done_idx,
        kv_read_val=kval, kv_read_index=kidx, kv_applied=kap, telem=telem,
    )


def _or_rounds(st: QuorumState, outs) -> StepOutputs:
    """The multistep egress: the final state and watermark, and won,
    lost and the three tick flags OR-ed over the rounds' outputs."""
    zeros = torch.zeros((st.match.shape[0],), dtype=BOOL, device=st.match.device)
    acc = [zeros] * 5
    for out in outs:
        acc = [a | b for a, b in zip(acc, (out.won, out.lost) + tuple(out.flags))]
    return StepOutputs(st, st.committed, acc[0], acc[1], TickFlags(*acc[2:]))


def quorum_multistep_impl(
    st: QuorumState,
    ack_g, ack_p, ack_val, ack_valid,      # (R, cap) — R rounds of event batches
    vote_g, vote_p, vote_grant, vote_valid,  # (R, vcap), or dummies without has_votes
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
) -> StepOutputs:
    """R sparse rounds: :func:`quorum_step_impl` on each round's events in
    turn (the reference's ``lax.scan``).  Returns the final state and
    watermark with won, lost and the tick flags OR-ed over the rounds.
    With ``has_votes=False`` the vote arguments are not read."""
    outs = []
    for r in range(ack_g.shape[0]):
        votes_r = ((vote_g[r], vote_p[r], vote_grant[r], vote_valid[r])
                   if has_votes else (None, None, None, None))
        out = quorum_step_impl(
            st, ack_g[r], ack_p[r], ack_val[r], ack_valid[r], *votes_r,
            do_tick=do_tick, track_contact=track_contact, has_votes=has_votes,
            has_hier=has_hier,
        )
        st = out.state
        outs.append(out)
    return _or_rounds(st, outs)


def quorum_multistep_dense_impl(
    st: QuorumState,
    ack_max, ack_touched, vote_new,  # (R, G, P); vote_new a dummy without has_votes
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
) -> StepOutputs:
    """R dense rounds: :func:`quorum_step_dense_impl` on each round's
    planes in turn, with the outputs of :func:`quorum_multistep_impl`."""
    outs = []
    for r in range(ack_max.shape[0]):
        out = quorum_step_dense_impl(
            st, ack_max[r], ack_touched[r], vote_new[r] if has_votes else None,
            do_tick=do_tick, track_contact=track_contact, has_votes=has_votes,
            has_hier=has_hier,
        )
        st = out.state
        outs.append(out)
    return _or_rounds(st, outs)


def staged_multistep_impl(st: QuorumState, base_index: int, rounds: int) -> StepOutputs:
    """R dense rounds whose acks are made on the device (reference:
    ``bench.py`` ``_staged_multistep_fn``, with P = 3 there): in round r
    slots 0 and 1 of every row ack ``base_index + 1 + r`` (int32, wrapping)
    and the other slots are untouched; every round ticks, contact is not
    tracked and no vote is read.  The won, lost and tick flags returned are
    zeros, as the reference returns them."""
    g, p = st.match.shape
    dev = st.match.device
    first_two = torch.arange(p, dtype=I32, device=dev)[None, :] < 2
    touched = first_two.expand(g, p)
    base = torch.tensor(_int32(base_index), dtype=I32, device=dev)
    for r in range(rounds):
        vals = torch.where(first_two, base + 1 + r, 0).to(I32)
        out = quorum_step_dense_impl(
            st, vals.expand(g, p), touched, None,
            do_tick=True, track_contact=False, has_votes=False,
        )
        st = out.state
    return _or_rounds(st, ())


def _int32(value) -> int:
    value = int(value)
    if not -2**31 <= value < 2**31:
        raise ValueError(f"{value} is outside int32")
    return value


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------


def _device_of(st: QuorumState, *tensors) -> torch.device:
    """The one device of the state and the given tensors (None skipped)."""
    dev = st.match.device
    for t in tuple(st) + tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}: use one device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _flag_buffer(g: int, device) -> torch.Tensor:
    return torch.empty((5, g), dtype=BOOL, device=device)


def _outputs(st: QuorumState, buf: torch.Tensor, telem=None,
             done=None) -> StepOutputs:
    """``done`` is the (2, G, S) int32 read egress block, or None."""
    return StepOutputs(
        st, st.committed, buf[0], buf[1], TickFlags(buf[2], buf[3], buf[4]),
        read_done_count=None if done is None else done[0],
        read_done_index=None if done is None else done[1],
        telem=telem,
    )


def _kv_views(block: torch.Tensor, g: int, r: int):
    """``(kv_read_val (G,R), kv_read_index (G,R), kv_applied (G,))`` as
    views of one flat (2·G·R + G,) int32 block."""
    n = g * r
    return block[:n].view(g, r), block[n:2 * n].view(g, r), block[2 * n:]


def kv_block(out: StepOutputs) -> torch.Tensor:
    """The flat (2·G·R + G,) int32 tensor behind an entry point's
    ``kv_read_val``, ``kv_read_index`` and ``kv_applied``: the engine
    copies the three to the host as one block."""
    v = out.kv_read_val
    g, r = v.shape
    return v.new_empty((0,)).set_(
        v.untyped_storage(), v.storage_offset(), (2 * g * r + g,)
    )


def read_block(out: StepOutputs) -> torch.Tensor:
    """The (2, G, S) int32 tensor whose rows are an entry point's
    ``read_done_count`` and ``read_done_index``: the engine copies both to
    the host as one block."""
    c = out.read_done_count
    return c.new_empty((0,)).set_(
        c.untyped_storage(), c.storage_offset(), (2,) + tuple(c.shape)
    )


def flag_block(out: StepOutputs) -> torch.Tensor:
    """The (5, G) bool tensor whose rows are an entry point's ``won``,
    ``lost``, ``elect_due``, ``hb_due`` and ``checkq_demote``: the engine
    copies the five to the host as one block."""
    won = out.won
    return won.new_empty((0,)).set_(
        won.untyped_storage(), won.storage_offset(), (5, won.shape[0])
    )


def _telem_view(block: torch.Tensor, k: int) -> TelemAggregate:
    """The :class:`TelemAggregate` whose fields are views of ``block``."""
    b, s = TELEM_LAG_BUCKETS, TELEM_LAG_BUCKETS + TELEM_STATES
    return TelemAggregate(
        block[:b], block[b:s], block[s], block[s + 1], block[s + 2],
        block[TELEM_HEAD:TELEM_HEAD + k], block[TELEM_HEAD + k:TELEM_HEAD + 2 * k],
    )


def telem_block(agg: TelemAggregate) -> torch.Tensor:
    """The flat ``(TELEM_HEAD + 2k,)`` int32 block behind an aggregate an
    entry point returned: the engine copies it to the host in one go."""
    h = agg.lag_hist
    n = TELEM_HEAD + 2 * agg.topk_row.shape[0]
    return h.new_empty((0,)).set_(h.untyped_storage(), h.storage_offset(), (n,))


def _pack_telem(agg: TelemAggregate) -> TelemAggregate:
    """A plain version's aggregate copied into one flat block."""
    k = agg.topk_row.shape[0]
    block = torch.cat([
        agg.lag_hist, agg.state_counts, agg.stalled[None], agg.read_slots[None],
        agg.kv_ents[None], agg.topk_row, agg.topk_lag,
    ]).to(I32)
    return _telem_view(block, k)


def _write_back(st: QuorumState, out: StepOutputs) -> StepOutputs:
    """Copy a plain version's result into the caller's state tensors (the
    in-place contract of the entry points) and pack its flags, its read
    and kv egress and its telemetry aggregate."""
    for old, new in zip(st, out.state):
        if new is not old:
            old.copy_(new)
    buf = _flag_buffer(st.match.shape[0], st.match.device)
    for i, f in enumerate((out.won, out.lost) + tuple(out.flags)):
        buf[i].copy_(f)
    telem = None if out.telem is None else _pack_telem(out.telem)
    done = None
    if out.read_done_count is not None:
        done = torch.stack([out.read_done_count, out.read_done_index])
    res = _outputs(st, buf, telem, done)
    if out.kv_read_val is not None:
        g, r = out.kv_read_val.shape
        block = torch.cat([out.kv_read_val.reshape(-1),
                           out.kv_read_index.reshape(-1), out.kv_applied]).to(I32)
        res = _with_kv(res, block, g, r)
    return res


def _with_kv(out: StepOutputs, block: torch.Tensor, g: int, r: int) -> StepOutputs:
    rv, ri, ap = _kv_views(block, g, r)
    return out._replace(kv_read_val=rv, kv_read_index=ri, kv_applied=ap)


_PEER_FIELDS = ("match", "next", "voting", "active", "votes", "near")
_STATE_DTYPES = {
    "node_state": I8, "votes": I8,
    "electable": BOOL, "check_quorum_on": BOOL, "live": BOOL,
    "voting": BOOL, "present": BOOL, "active": BOOL, "near": BOOL,
}


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if t is None:
        raise ValueError(f"{name}: missing")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name}: {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _cstate(st: QuorumState) -> _build.CState:
    g, p = st.match.shape
    if not 1 <= p <= MAX_KERNEL_PEERS:
        raise ValueError(f"peer width {p}: the CUDA kernels take 1..{MAX_KERNEL_PEERS}")
    cs = _build.CState(G=g, P=p)
    for name, _ in _build.CState._fields_[:-2]:
        t = getattr(st, name)
        shape = (g, p) if name in _PEER_FIELDS else (g,)
        _check(t, name, shape, _STATE_DTYPES.get(name, I32))
        setattr(cs, name, t.data_ptr())
    return cs


def _cflags(buf: torch.Tensor) -> _build.CFlags:
    return _build.CFlags(*(buf[i].data_ptr() for i in range(5)))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _run(name: str, dev: torch.device, call, also=()) -> None:
    """Launch on the current stream and count it under ``name`` and under
    each of ``also`` (``finish_hier`` for a step kernel's HIER instance,
    ``read_plane`` for its READS instance)."""
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = call(lib, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.qs_error_string(rc).decode()}"
        )
    _LAUNCHES[name] += 1
    for other in also:
        _LAUNCHES[other] += 1


def _also(has_hier=False, has_reads=False) -> tuple:
    return (("finish_hier",) if has_hier else ()) + (
        ("read_plane",) if has_reads else ())


def _bits(do_tick, track_contact, has_votes, has_churn=False, has_hier=False,
          reset_telem=False, has_reads=False, reset_reads=False) -> int:
    return (
        (_F_DO_TICK if do_tick else 0)
        | (_F_TRACK_CONTACT if track_contact else 0)
        | (_F_HAS_VOTES if has_votes else 0)
        | (_F_HAS_CHURN if has_churn else 0)
        | (_F_HAS_HIER if has_hier else 0)
        | (_F_RESET_TELEM if reset_telem else 0)
        | (_F_HAS_READS if has_reads else 0)
        | (_F_RESET_READS if reset_reads else 0)
    )


def _creads(st: QuorumState, dev, inputs, k: Optional[int]):
    """The ``qs::Reads`` block of a read-plane launch: the state's read
    slots, and, when ``inputs`` (stage_idx, stage_cnt, echo) are given,
    those inputs ((G,S), (G,S), (G,S,P), with a leading K axis when ``k``
    is given) and a fresh (2, G, S) int32 egress block.  Returns the
    ctypes struct and the egress block (None without inputs)."""
    g, p = st.match.shape
    s = st.read_index.shape[1]
    if not 1 <= s <= MAX_KERNEL_READ_SLOTS:
        raise ValueError(
            f"{s} read slots: the CUDA read plane takes 1..{MAX_KERNEL_READ_SLOTS}"
        )
    _check(st.read_index, "read_index", (g, s), I32)
    _check(st.read_count, "read_count", (g, s), I32)
    _check(st.read_acks, "read_acks", (g, s, p), BOOL)
    cr = _build.CReads(
        read_index=_ptr(st.read_index), read_count=_ptr(st.read_count),
        read_acks=_ptr(st.read_acks), S=s,
    )
    if inputs is None:
        return cr, None
    lead = () if k is None else (k,)
    stage_idx, stage_cnt, echo = inputs
    _check(stage_idx, "read_stage_idx", lead + (g, s), I32)
    _check(stage_cnt, "read_stage_cnt", lead + (g, s), I32)
    _check(echo, "read_ack", lead + (g, s, p), BOOL)
    done = torch.empty((2, g, s), dtype=I32, device=dev)
    cr.stage_idx, cr.stage_cnt, cr.echo = _ptr(stage_idx), _ptr(stage_cnt), _ptr(echo)
    cr.done_count, cr.done_index = _ptr(done[0]), _ptr(done[1])
    return cr, done


def telem_fold(
    st: QuorumState, k: int = TELEM_TOPK,
    count_reads: bool = True, count_kv: bool = True,
) -> TelemAggregate:
    """The telemetry fold on its own, in place: advances
    ``st.telem_prev_committed`` and returns the aggregate (a CUDA
    reduction on CUDA: ``csrc/telem_fold.cu``)."""
    dev = _device_of(st)
    if dev.type == "cpu":
        nst, agg = telem_fold_impl(st, k, count_reads, count_kv)
        st.telem_prev_committed.copy_(nst.telem_prev_committed)
        return _pack_telem(agg)
    return _telem_launch(st, dev, k, count_reads, count_kv)


def _telem_launch(st, dev, k, count_reads, count_kv) -> TelemAggregate:
    """The fold's one launch on the current stream, after whatever step
    ran before: each block's counters and top-K candidates go to scratch,
    and the last block to finish (by the stream's ticket) writes the
    aggregate block."""
    cst = _cstate(st)
    g = st.match.shape[0]
    k = min(int(k), g)
    n_slots, n_ents = st.read_count.shape[1], st.kv_ent_index.shape[1]
    if count_reads:
        _check(st.read_count, "read_count", (g, n_slots), I32)
    if count_kv:
        _check(st.kv_ent_index, "kv_ent_index", (g, n_ents), I32)
    block = torch.empty((TELEM_HEAD + 2 * k,), dtype=I32, device=dev)
    n_blocks = max((g + _TELEM_BLOCK - 1) // _TELEM_BLOCK, 1)
    cand = torch.empty((max(n_blocks * k, 1),), dtype=torch.int64, device=dev)
    counts = torch.empty((n_blocks * TELEM_HEAD,), dtype=I32, device=dev)
    flags = (_F_COUNT_READS if count_reads else 0) | (_F_COUNT_KV if count_kv else 0)
    _run("telem_fold", dev, lambda lib, stream: lib.qs_telem(
        ctypes.byref(cst), _ptr(st.read_count), n_slots, _ptr(st.kv_ent_index),
        n_ents, k, _ptr(block), _ptr(cand), cand.numel(), _ptr(counts),
        counts.numel(), _ptr(_telem_ticket(dev, stream)), flags, stream,
    ))
    return _telem_view(block, k)


# one fold ticket per (device, stream): the fold's last block finds itself
# by it and puts it back to 0, so folds on one stream take turns on it and
# a fold on another stream never shares it
_TICKETS: dict = {}


def _telem_ticket(dev: torch.device, stream) -> torch.Tensor:
    key = (str(dev), stream)
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros((1,), dtype=I32, device=dev)
    return ticket


def _with_telem(st, dev, out, has_telem, telem_k, count_reads,
                count_kv) -> StepOutputs:
    if not has_telem:
        return out
    return out._replace(telem=_telem_launch(st, dev, telem_k, count_reads, count_kv))


def _ckv(st: QuorumState, dev, inputs, k: Optional[int], commits, churn_map):
    """The ``qs::Kv`` block of a device state machine launch
    (``csrc/kv_plane.cu``), checked before the step kernel launches:
    ``inputs`` are the (ent_idx, ent_key, ent_val, read_key) planes ((G,E)
    ×3 and (G,R), with a leading K axis when ``k`` is given), or None for
    the purge alone; ``commits`` the (K, G) watermark of each round (the
    state's ``committed`` for a single round); ``churn_map`` K3's (K, G)
    recycle map where recycles reset rows.  Returns the ctypes struct and
    a fresh flat egress block (None for the purge)."""
    g = st.match.shape[0]
    v, e = st.kv_value.shape[1], st.kv_ent_index.shape[1]
    if not 1 <= e <= MAX_KERNEL_KV_ENTS:
        raise ValueError(f"{e} kv entry slots: the CUDA kernel takes 1..{MAX_KERNEL_KV_ENTS}")
    if not 1 <= v <= MAX_KERNEL_KV_SLOTS:
        raise ValueError(f"{v} kv value slots: the CUDA kernel takes 1..{MAX_KERNEL_KV_SLOTS}")
    _check(st.kv_value, "kv_value", (g, v), I32)
    for name in ("kv_ent_index", "kv_ent_key", "kv_ent_val"):
        _check(getattr(st, name), name, (g, e), I32)
    rounds = 1 if k is None else k
    ck = _build.CKv(
        value=_ptr(st.kv_value), ent_index=_ptr(st.kv_ent_index),
        ent_key=_ptr(st.kv_ent_key), ent_val=_ptr(st.kv_ent_val),
        churn_map=_ptr(churn_map), G=g, V=v, E=e, K=rounds,
    )
    block = None
    if inputs is not None:
        ent_idx, ent_key, ent_val, read_key = inputs
        lead = () if k is None else (k,)
        r = read_key.shape[-1]
        if not 1 <= r <= MAX_KERNEL_KV_READS:
            raise ValueError(f"{r} kv read slots: the CUDA kernel takes 1..{MAX_KERNEL_KV_READS}")
        for t, name in ((ent_idx, "kv_ent_idx"), (ent_key, "kv_ent_key"),
                        (ent_val, "kv_ent_val")):
            _check(t, name, lead + (g, e), I32)
        _check(read_key, "kv_read_key", lead + (g, r), I32)
        _check(commits, "commits", (rounds, g) if k is not None else (g,), I32)
        block = torch.empty((2 * g * r + g,), dtype=I32, device=dev)
        rv, ri, ap = _kv_views(block, g, r)
        ck.in_idx, ck.in_key, ck.in_val = _ptr(ent_idx), _ptr(ent_key), _ptr(ent_val)
        ck.read_key, ck.commits, ck.R = _ptr(read_key), _ptr(commits), r
        ck.read_val, ck.read_idx, ck.applied = _ptr(rv), _ptr(ri), _ptr(ap)
    return ck, block


def _kv_run(dev, ck, flags: int) -> None:
    """Launch the device state machine after the step kernel, on the same
    stream (``flags``: the ``_KV_*`` bits)."""
    _run("kv_plane", dev, lambda lib, stream: lib.qs_kv_plane(
        ctypes.byref(ck), flags, stream))


def quorum_step(
    st: QuorumState,
    ack_g, ack_p, ack_val, ack_valid,
    vote_g, vote_p, vote_grant, vote_valid,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
    has_telem: bool = False,
    telem_k: int = TELEM_TOPK,
    has_reads: bool = False,
    has_kv: bool = False,
) -> StepOutputs:
    """ONE sparse round over K padded events, in place (K2 on CUDA:
    ``csrc/quorum_step.cu``, then the fold with ``has_telem``, counting
    read slots with ``has_reads`` and entry slots with ``has_kv``).
    ``has_votes=False`` leaves the vote arguments unread (they may be
    dummies)."""
    votes_in = (vote_g, vote_p, vote_grant, vote_valid) if has_votes else ()
    dev = _device_of(st, ack_g, ack_p, ack_val, ack_valid, *votes_in)
    if dev.type == "cpu":
        return _write_back(st, quorum_step_impl(
            st, ack_g, ack_p, ack_val, ack_valid,
            vote_g, vote_p, vote_grant, vote_valid,
            do_tick=do_tick, track_contact=track_contact, has_votes=has_votes,
            has_hier=has_hier, has_telem=has_telem, telem_k=telem_k,
            has_reads=has_reads, has_kv=has_kv,
        ))
    out = _sparse_launch(
        st, dev, (ack_g, ack_p, ack_val, ack_valid),
        (vote_g, vote_p, vote_grant, vote_valid), do_tick, track_contact,
        has_votes, has_hier,
    )
    return _with_telem(st, dev, out, has_telem, telem_k, has_reads, has_kv)


def _sparse_launch(st, dev, acks, votes, do_tick, track_contact, has_votes,
                   has_hier=False):
    ack_g, ack_p, ack_val, ack_valid = acks
    vote_g, vote_p, vote_grant, vote_valid = votes
    cst = _cstate(st)
    g = st.match.shape[0]
    n_acks = ack_g.shape[0]
    for t, name, dt in ((ack_g, "ack_g", I32), (ack_p, "ack_p", I32),
                        (ack_val, "ack_val", I32), (ack_valid, "ack_valid", BOOL)):
        _check(t, name, (n_acks,), dt)
    n_votes = 0
    if has_votes:
        n_votes = vote_g.shape[0]
        for t, name, dt in ((vote_g, "vote_g", I32), (vote_p, "vote_p", I32),
                            (vote_grant, "vote_grant", I8),
                            (vote_valid, "vote_valid", BOOL)):
            _check(t, name, (n_votes,), dt)
    else:
        vote_g = vote_p = vote_grant = vote_valid = None
    buf = _flag_buffer(g, dev)
    cfl = _cflags(buf)
    keys = []

    def call(lib, stream):
        contacted = None
        if track_contact:
            keys.append((str(dev), stream, g))
            contacted = _contact_scratch(*keys[-1])
        return lib.qs_sparse(
            ctypes.byref(cst), _ptr(ack_g), _ptr(ack_p), _ptr(ack_val),
            _ptr(ack_valid), n_acks, _ptr(vote_g), _ptr(vote_p), _ptr(vote_grant),
            _ptr(vote_valid), n_votes, _ptr(contacted), ctypes.byref(cfl),
            _bits(do_tick, track_contact, has_votes, has_hier=has_hier), stream)

    try:
        _run("quorum_step", dev, call, _also(has_hier))
    except RuntimeError:
        # the event launch may have set bytes that no row launch put back
        for key in keys:
            _CONTACTED.pop(key, None)
        raise
    return _outputs(st, buf)


# K2's (G,) contacted scratch, one per (device, stream, G), zeroed once:
# the event launch sets a row's byte and the row launch puts it back to 0,
# so every launch with track_contact leaves it all zero and none clears
# it first; a launch on another stream never shares it
_CONTACTED: dict = {}


def _contact_scratch(dev: str, stream, g: int) -> torch.Tensor:
    key = (dev, stream, g)
    scratch = _CONTACTED.get(key)
    if scratch is None:
        scratch = _CONTACTED[key] = torch.zeros((g,), dtype=BOOL, device=dev)
    return scratch


def quorum_step_dense(
    st: QuorumState,
    ack_max, ack_touched, vote_new,
    read_stage_idx=None, read_stage_cnt=None, read_ack=None,
    kv_ent_idx=None, kv_ent_key=None, kv_ent_val=None, kv_read_key=None,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_reads: bool = False,
    has_kv: bool = False,
    has_hier: bool = False,
    has_telem: bool = False,
    telem_k: int = TELEM_TOPK,
) -> StepOutputs:
    """ONE dense round, in place (K1 on CUDA: ``csrc/quorum_step_dense.cu``,
    its READS instances with ``has_reads``, then the device state machine
    (``csrc/kv_plane.cu``) with ``has_kv``, then the fold with
    ``has_telem``).  ``has_votes=False`` leaves ``vote_new`` unread,
    ``has_reads=False`` the read inputs and ``has_kv=False`` the kv
    inputs."""
    reads_in = (read_stage_idx, read_stage_cnt, read_ack) if has_reads else ()
    kv_in = (kv_ent_idx, kv_ent_key, kv_ent_val, kv_read_key) if has_kv else ()
    dev = _device_of(st, ack_max, ack_touched, vote_new if has_votes else None,
                     *reads_in, *kv_in)
    if dev.type == "cpu":
        return _write_back(st, quorum_step_dense_impl(
            st, ack_max, ack_touched, vote_new, read_stage_idx, read_stage_cnt,
            read_ack, kv_ent_idx, kv_ent_key, kv_ent_val, kv_read_key,
            do_tick=do_tick, track_contact=track_contact, has_votes=has_votes,
            has_reads=has_reads, has_kv=has_kv, has_hier=has_hier,
            has_telem=has_telem, telem_k=telem_k,
        ))
    out = _dense_launch(
        st, dev, ack_max, ack_touched, vote_new, do_tick, track_contact,
        has_votes, has_hier, reads=reads_in or None, kv=kv_in or None,
    )
    return _with_telem(st, dev, out, has_telem, telem_k, has_reads, has_kv)


def _dense_launch(st, dev, ack_max, ack_touched, vote_new, do_tick,
                  track_contact, has_votes, has_hier=False, reads=None, kv=None):
    """``reads``: the (stage_idx, stage_cnt, echo) inputs of the READS
    instance, or None; ``kv``: the (ent_idx, ent_key, ent_val, read_key)
    inputs of the device state machine, launched after K1 at the
    watermark K1 leaves, or None."""
    cst = _cstate(st)
    g, p = st.match.shape
    _check(ack_max, "ack_max", (g, p), I32)
    _check(ack_touched, "ack_touched", (g, p), BOOL)
    if has_votes:
        _check(vote_new, "vote_new", (g, p), I8)
    else:
        vote_new = None
    cr = done = None
    if reads is not None:
        cr, done = _creads(st, dev, reads, None)
    ckv = kv_out = None
    if kv is not None:
        ckv, kv_out = _ckv(st, dev, kv, None, st.committed, None)
    buf = _flag_buffer(g, dev)
    cfl = _cflags(buf)
    _run("quorum_step_dense", dev, lambda lib, stream: lib.qs_dense(
        ctypes.byref(cst), _ptr(ack_max), _ptr(ack_touched), _ptr(vote_new),
        None if cr is None else ctypes.byref(cr), ctypes.byref(cfl),
        _bits(do_tick, track_contact, has_votes, has_hier=has_hier,
              has_reads=cr is not None), stream,
    ), _also(has_hier, cr is not None))
    out = _outputs(st, buf, done=done)
    if ckv is not None:
        _kv_run(dev, ckv, _KV_PLANE)
        out = _with_kv(out, kv_out, g, ckv.R)
    return out


def quorum_multiround(
    st: QuorumState,
    ack_max, vote_new, churn_row, churn_term, churn_start, churn_last,
    tick_mask,
    read_stage_idx=None, read_stage_cnt=None, read_ack=None,
    kv_ent_idx=None, kv_ent_key=None, kv_ent_val=None, kv_read_key=None,
    do_tick: bool = False,
    track_contact: bool = True,
    has_votes: bool = False,
    has_churn: bool = False,
    has_reads: bool = False,
    purge_reads: bool = False,
    has_kv: bool = False,
    purge_kv: bool = False,
    has_hier: bool = False,
    has_telem: bool = False,
    purge_telem: bool = False,
    telem_k: int = TELEM_TOPK,
) -> StepOutputs:
    """K rounds with in-program churn in ONE launch, in place (K3 on CUDA:
    ``csrc/quorum_multiround.cu``, its READS instances with ``has_reads``
    from ``csrc/quorum_multiround_reads.cu``, then the device state
    machine's K rounds (``csrc/kv_plane.cu``) with ``has_kv`` or its
    recycle purge with ``purge_kv``, then the fold once with
    ``has_telem``).  Arguments of disabled features (votes without
    ``has_votes``, churn records without ``has_churn``, ``tick_mask``
    without ``do_tick``, read inputs without ``has_reads``, kv inputs
    without ``has_kv``) are unread."""
    churn_in = (churn_row, churn_term, churn_start, churn_last) if has_churn else ()
    reads_in = (read_stage_idx, read_stage_cnt, read_ack) if has_reads else ()
    kv_in = (kv_ent_idx, kv_ent_key, kv_ent_val, kv_read_key) if has_kv else ()
    dev = _device_of(
        st, ack_max, vote_new if has_votes else None, *churn_in,
        tick_mask if do_tick else None, *reads_in, *kv_in,
    )
    if dev.type == "cpu":
        return _write_back(st, quorum_multiround_impl(
            st, ack_max, vote_new, churn_row, churn_term, churn_start,
            churn_last, tick_mask, read_stage_idx, read_stage_cnt, read_ack,
            kv_ent_idx, kv_ent_key, kv_ent_val, kv_read_key, do_tick=do_tick,
            track_contact=track_contact, has_votes=has_votes,
            has_churn=has_churn, has_reads=has_reads, purge_reads=purge_reads,
            has_kv=has_kv, purge_kv=purge_kv, has_hier=has_hier,
            has_telem=has_telem, purge_telem=purge_telem, telem_k=telem_k,
        ))
    out = _multiround_launch(
        st, dev, ack_max, vote_new,
        (churn_row, churn_term, churn_start, churn_last), tick_mask,
        do_tick, track_contact, has_votes, has_churn, has_hier,
        reset_telem=has_telem or purge_telem, reads=reads_in or None,
        reset_reads=has_reads or purge_reads, kv=kv_in or None,
        reset_kv=has_kv or purge_kv,
    )
    return _with_telem(st, dev, out, has_telem, telem_k, has_reads, has_kv)


def _multiround_launch(st, dev, ack_max, vote_new, churn, tick_mask, do_tick,
                       track_contact, has_votes, has_churn, has_hier=False,
                       reset_telem=False, reads=None, reset_reads=False,
                       kv=None, reset_kv=False):
    """``reads``: the (K,G,S), (K,G,S), (K,G,S,P) inputs of the READS
    instance, or None.  ``reset_reads`` (with churn) zeroes a recycled
    row's read slots.  ``kv``: the (K,G,E) ×3 and (K,G,R) inputs of the
    device state machine, or None; K3 then writes each round's watermark
    into a (K, G) trace, and the kv kernel runs the block's rounds on it
    after K3, resetting the rows K3's churn map recycles.  Without ``kv``,
    ``reset_kv`` (with churn) launches the kv kernel's purge alone."""
    churn_row, churn_term, churn_start, churn_last = churn
    cst = _cstate(st)
    g, p = st.match.shape
    k = ack_max.shape[0]
    _check(ack_max, "ack_max", (k, g, p), I32)
    if has_votes:
        _check(vote_new, "vote_new", (k, g, p), I8)
    else:
        vote_new = None
    n_records = 0
    churn_map = None
    if has_churn:
        n_records = churn_row.shape[1]
        for t, name in ((churn_row, "churn_row"), (churn_term, "churn_term"),
                        (churn_start, "churn_start"), (churn_last, "churn_last")):
            _check(t, name, (k, n_records), I32)
        churn_map = torch.empty((k, g), dtype=I32, device=dev)
    else:
        churn_row = churn_term = churn_start = churn_last = None
    if do_tick:
        _check(tick_mask, "tick_mask", (k,), BOOL)
    else:
        tick_mask = None
    reset_reads = reset_reads and has_churn
    cr = done = None
    if reads is not None or reset_reads:
        cr, done = _creads(st, dev, reads, k)
    trace = ckv = kv_out = None
    if kv is not None:
        trace = torch.empty((k, g), dtype=I32, device=dev)
        ckv, kv_out = _ckv(st, dev, kv, k, trace, churn_map)
    elif reset_kv and has_churn:
        ckv, _ = _ckv(st, dev, None, k, None, churn_map)
    buf = _flag_buffer(g, dev)
    cfl = _cflags(buf)
    bits = _bits(do_tick, track_contact, has_votes, has_churn, has_hier,
                 reset_telem and has_churn, reads is not None, reset_reads)
    _run("quorum_multiround", dev, lambda lib, stream: lib.qs_multiround(
        ctypes.byref(cst), _ptr(ack_max), _ptr(vote_new), _ptr(churn_row),
        _ptr(churn_term), _ptr(churn_start), _ptr(churn_last), n_records,
        _ptr(tick_mask), k, _ptr(churn_map), _ptr(trace),
        None if cr is None else ctypes.byref(cr), ctypes.byref(cfl), bits,
        stream,
    ), _also(has_hier, reads is not None))
    out = _outputs(st, buf, done=done)
    reset = _KV_RESET if has_churn else 0
    if kv is not None:
        _kv_run(dev, ckv, _KV_PLANE | _KV_CARRY | reset)
        out = _with_kv(out, kv_out, g, ckv.R)
    elif ckv is not None:
        _kv_run(dev, ckv, _KV_RESET)
    return out


def quorum_multistep(
    st: QuorumState,
    ack_g, ack_p, ack_val, ack_valid,
    vote_g, vote_p, vote_grant, vote_valid,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
) -> StepOutputs:
    """R sparse rounds of (R, cap) padded events in ONE dispatch, in place
    (on CUDA ``csrc/quorum_multistep.cu``: the scatter pre-pass, then the
    row loop).  ``has_votes=False`` leaves the vote arguments unread
    (they may be dummies of any shape)."""
    votes_in = (vote_g, vote_p, vote_grant, vote_valid) if has_votes else ()
    dev = _device_of(st, ack_g, ack_p, ack_val, ack_valid, *votes_in)
    if dev.type == "cpu":
        return _write_back(st, quorum_multistep_impl(
            st, ack_g, ack_p, ack_val, ack_valid,
            vote_g, vote_p, vote_grant, vote_valid,
            do_tick=do_tick, track_contact=track_contact, has_votes=has_votes,
            has_hier=has_hier,
        ))
    return _multistep_launch(
        st, dev, (ack_g, ack_p, ack_val, ack_valid),
        (vote_g, vote_p, vote_grant, vote_valid), do_tick, track_contact,
        has_votes, has_hier,
    )


def _multistep_launch(st, dev, acks, votes, do_tick, track_contact, has_votes,
                      has_hier=False):
    """The pre-pass scatters the events into fresh scratch planes, the
    row loop ingests them a round at a time."""
    ack_g, ack_p, ack_val, ack_valid = acks
    vote_g, vote_p, vote_grant, vote_valid = votes
    cst = _cstate(st)
    g, p = st.match.shape
    rounds, n_acks = ack_g.shape[0], ack_g.shape[-1]
    for t, name, dt in ((ack_g, "ack_g", I32), (ack_p, "ack_p", I32),
                        (ack_val, "ack_val", I32), (ack_valid, "ack_valid", BOOL)):
        _check(t, name, (rounds, n_acks), dt)
    n_votes = 0
    if has_votes:
        n_votes = vote_g.shape[-1]
        for t, name, dt in ((vote_g, "vote_g", I32), (vote_p, "vote_p", I32),
                            (vote_grant, "vote_grant", I8),
                            (vote_valid, "vote_valid", BOOL)):
            _check(t, name, (rounds, n_votes), dt)
    else:
        vote_g = vote_p = vote_grant = vote_valid = None
    sc_max = torch.empty((rounds, g, p), dtype=I32, device=dev)
    sc_touched = torch.empty((rounds, g, p), dtype=BOOL, device=dev)
    sc_vote = torch.empty((rounds, g, p), dtype=I8, device=dev) if has_votes else None
    sc_contacted = torch.empty((rounds, g), dtype=BOOL, device=dev) if track_contact else None
    buf = _flag_buffer(g, dev)
    cfl = _cflags(buf)
    _run("quorum_multistep", dev, lambda lib, stream: lib.qs_multistep(
        ctypes.byref(cst), _ptr(ack_g), _ptr(ack_p), _ptr(ack_val),
        _ptr(ack_valid), n_acks, _ptr(vote_g), _ptr(vote_p), _ptr(vote_grant),
        _ptr(vote_valid), n_votes, rounds, _ptr(sc_max), _ptr(sc_touched),
        _ptr(sc_vote), _ptr(sc_contacted), ctypes.byref(cfl),
        _bits(do_tick, track_contact, has_votes, has_hier=has_hier), stream,
    ), _also(has_hier))
    return _outputs(st, buf)


def quorum_multistep_dense(
    st: QuorumState,
    ack_max, ack_touched, vote_new,
    do_tick: bool = True,
    track_contact: bool = True,
    has_votes: bool = True,
    has_hier: bool = False,
) -> StepOutputs:
    """R dense rounds of (R, G, P) planes in ONE launch, in place (on CUDA
    ``csrc/quorum_multistep.cu``).  ``has_votes=False`` leaves
    ``vote_new`` unread (it may be a dummy of any shape)."""
    dev = _device_of(st, ack_max, ack_touched, vote_new if has_votes else None)
    if dev.type == "cpu":
        return _write_back(st, quorum_multistep_dense_impl(
            st, ack_max, ack_touched, vote_new, do_tick=do_tick,
            track_contact=track_contact, has_votes=has_votes, has_hier=has_hier,
        ))
    return _multistep_dense_launch(st, dev, ack_max, ack_touched, vote_new,
                                   do_tick, track_contact, has_votes, has_hier)


def _multistep_dense_launch(st, dev, ack_max, ack_touched, vote_new, do_tick,
                            track_contact, has_votes, has_hier=False):
    cst = _cstate(st)
    g, p = st.match.shape
    rounds = ack_max.shape[0]
    _check(ack_max, "ack_max", (rounds, g, p), I32)
    _check(ack_touched, "ack_touched", (rounds, g, p), BOOL)
    if has_votes:
        _check(vote_new, "vote_new", (rounds, g, p), I8)
    else:
        vote_new = None
    buf = _flag_buffer(g, dev)
    cfl = _cflags(buf)
    _run("quorum_multistep_dense", dev, lambda lib, stream: lib.qs_multistep_dense(
        ctypes.byref(cst), _ptr(ack_max), _ptr(ack_touched), _ptr(vote_new),
        rounds, ctypes.byref(cfl),
        _bits(do_tick, track_contact, has_votes, has_hier=has_hier), stream,
    ), _also(has_hier))
    return _outputs(st, buf)


def staged_multistep(st: QuorumState, base_index: int, rounds: int) -> StepOutputs:
    """The headline ladder's dispatch (reference ``bench.py``
    ``_staged_multistep_fn``): ``rounds`` dense rounds whose acks are made
    on the device, in place (on CUDA ``csrc/quorum_multistep.cu``, whose
    ingest reads no input: ``base_index`` and ``rounds`` are launch
    arguments).  The flags returned are zeros."""
    dev = _device_of(st)
    base = _int32(base_index)
    if rounds < 0:
        raise ValueError(f"rounds {rounds} < 0")
    if dev.type == "cpu":
        return _write_back(st, staged_multistep_impl(st, base, rounds))
    return _staged_launch(st, dev, base, rounds)


def _staged_launch(st, dev, base_index: int, rounds: int):
    cst = _cstate(st)
    buf = _flag_buffer(st.match.shape[0], dev)
    cfl = _cflags(buf)
    _run("staged_multistep", dev, lambda lib, stream: lib.qs_staged_multistep(
        ctypes.byref(cst), base_index, rounds, ctypes.byref(cfl),
        _bits(True, False, False), stream,
    ))
    return _outputs(st, buf)
