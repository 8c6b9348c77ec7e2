#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dragonboat_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only raft   # the build and the Raft path
    python3 chip_smoke.py --only rung4,rung4_devsm
                                     # the build and the named main paths
                                     # alone (no result line); the name
                                     # ``kernels`` runs phase 2 (every
                                     # comparison and timing) alone

Phases, each of which ends the run with a non-zero exit when it fails:

1. build the CUDA kernels from ``dragonboat_tpu_torch/csrc/`` (nvcc);
2. hold every kernel against its plain PyTorch version on the card, with
   zero tolerance (integer and boolean work): the three step kernels at
   100,000 groups x 5 peer slots over the main path's flag combinations,
   with and without the hier commit rule (and the telemetry fold after
   them), and at 4,096 groups for every peer width in {1..8, 12}; the
   telemetry fold at 100,000 x 5 over its occupancy switches and top-K
   widths {1, 8, 16}, with injected ties, and at 5 groups; time each
   kernel and its plain version;
3. the rung-5 drive: 100,000 groups x 5 slots, K = 8 rounds per dispatch,
   2,048 rows recycled in the program every round, pipelined; every row's
   commit watermark must equal the numpy expectation;
4. an op script at 65,536 groups x 5 slots with device ticks (elections,
   votes, wins, partial acks, a rebase, row reuse) through the sparse step,
   the dense step and the fused K-round path, each on the card and on the
   CPU's plain path, equal after every step;
5. rung 5 with the hier commit rule on every row (near slots {0,1,2},
   sub-quorum 2) and the telemetry fold on: every watermark against a
   numpy expectation of max(classic, near), every fold against a numpy
   fold, the last against one of the final state; then plain rung 5
   once more, so that the hier drive's host figures stand between two
   plain ones;
6. the op script of phase 4 again with the hier rule on a third of the
   rows and the fold on, the card's telemetry snapshot equal to the CPU's
   after every step;
7. rung 4 (``bench.py:_run_rung4``): 65,536 groups x 5 slots, K = 16
   rounds per dispatch, 8 pipelined dispatches of pure writes, then 8 of
   the mixed 9:1 phase — every group writes, stages a batch of 9
   ReadIndex reads and has followers 2 and 3 echo it, every round, and
   the read plane of K3 confirms them in the same dispatch; every block's
   watermarks and read egress, and the final read state, against numpy,
   and exactly 65,536 x 9 x 16 x 8 reads confirmed;
8. a read op script at 65,536 groups x 5 slots (reads staged singly and
   in blocks, full and partial echo quorums, cancels, leader changes and
   a rebase with batches pending, in-program recycles with pending
   slots, the hier rule on a third of the rows and the fold on) through
   the sparse path (read rounds forced dense) and the fused path, the
   card equal to the CPU after every step in every state field, the
   read egress and the telemetry snapshot;
9. rung 4's write window with the device state machine on
   (``bench_e2e.py:run_devsm``'s engine half): 65,536 groups x 5 slots,
   K = 16, 8 pipelined dispatches after a warm-up block; every write is a
   SET on one of 16 key slots (8 a group a block, in one ``stage_kv_ops``
   call) and every group stages 2 KV reads a block; every block's
   captures, the final values and every watermark against a numpy oracle
   that applies the SETs in log order at the watermark, and exactly
   65,536 x 8 x 9 ops applied;
10. a devsm op script at 65,536 groups x 5 slots (SETs on a third of the
   groups, KV reads, an overfilled entry buffer, a transition, a rebase
   and a recycle with entries buffered, a KV image restored, a dispatch
   with no kv event while entries sit buffered, the recycle purge alone,
   the hier rule and the fold on) through the sparse path (kv rounds
   forced dense) and the fused path, the card equal to the CPU after
   every step in every state field, the kv egress and the telemetry
   snapshot;
11. the device ladder of ``bench.py`` (``dragonboat_tpu_torch/ladder.py``):
   the pipelined headline at 131,072 groups x 3 with R = 256 rounds a
   dispatch whose acks are made on the device (``staged_multistep``), 3
   warm-up and 5 measured dispatches; the latency-bounded mode at 1,024
   groups, R = 1, 5 + 50 dispatches; and the host loop at 65,536 groups,
   K = 16, 8 dispatches through the engine and K3; every dispatch's
   watermarks checked on every row;
12. an R = 16 host pipeline at 65,536 groups x 5 with ticks, elections
   and the hier rule on a third of the leaders, run three ways from one
   state: ``quorum_multistep`` on the sparse rounds,
   ``quorum_multistep_dense`` on their numpy collapse and 16 launches of
   the sparse step; the three bit-equal, and equal to the CPU's plain
   scan;
13. the quorum coordinator (``dragonboat_tpu_torch/coordinator.py``) at
   NodeHost's width: 100,000 groups x 8 slots, 5 voters a group, device
   ticks, the read plane and the fold on, the hier rule on a third of
   the groups and 4,096 groups bound to the devsm plane, registered
   through ``register`` with this script's duck-typed nodes and rafts;
   the warm-up timed to its latch, then 24 scripted rounds driven by
   ``flush()`` (writes acked by followers 2 and 3, ReadIndex reads
   echoed by them, elections won, membership changes, devsm SETs, a tick
   backlog of 6 every sixth round for the fused path, quiet rounds for
   the sparse step), a CPU coordinator fed the same script and equal
   after every flush in every effect, engine tensor and tally; then two
   65,536-group coordinators live at once on the default stream for
   10 s, each ending with every group committed to its last acked index
   and every staged read confirmed;
14. the port's own Raft groups (``dragonboat_tpu_torch.raft``) at
   BASELINE rung 1: 1,024 groups x 3 replicas on 3 hosts, each host's
   replicas staging into its own coordinator (1,024 rows x 8 slots,
   device ticks, the read plane and the fold on, the hier rule on a third
   of the groups), applied back through this script's stand-in for the
   node (``RaftNode``), every message encoded and decoded by the port's
   wire codec: the warm-up timed to its latch, elections from followers
   by device ticks, 24 rounds of 16-byte writes (a tick backlog of 6
   every sixth round, a quiet round of 16 writers every sixth) with 1
   group in 8 reading through ReadIndex, then host 1 cut off until its
   groups elect on hosts 2 and 3 and healed; a CPU deployment runs the
   same script and equals the card's after every round in every raft,
   effect, engine tensor and tally; every group ends with one leader,
   every acknowledged write committed on all 3 replicas and every read
   released.

Phase 2 also holds the READS instances of K1 and K3 (the read plane)
against the plain versions at 65,536 x 5 over the flag grids, and at
4,096 groups for every peer width and S in {4, 8}; and the device state
machine (``csrc/kv_plane.cu``) after K1 and K3 at 65,536 x 5, K = 16, with
(V, E, R) = (16, 16, 4), over their flag grids, with and without the read
plane, the hier rule and the fold, and its recycle purge alone, with the
reference's bit-exact traps injected, and at 4,096 groups for every peer
width and (V, E, R) in {(16, 16, 4), (1, 1, 1), the caps (1024, 32, 8)};
and the R-round scans (``csrc/quorum_multistep.cu``) at 65,536 x 5, R =
16, 4,096 events a round with the sparse traps, over do_tick x
track_contact x has_votes x has_hier, and at 4,096 groups for every peer
width, and the staged ladder dispatch at 131,072 x 3 from a
``ladder.build_state`` state for R in {1, 7, 256} and at 4,096 groups
for every width; and K3 and the staged dispatch at block edges
(``EDGE_SHAPES``: a partial last block, byte planes ending mid-word or
starting one byte off a word, P in {4, 8}); the device state machine
at its segment edges (``KV_EDGE_WIDTHS`` at G in {257, 65,536}, after
K1 and after K3 with the churn reset and the carry, and the purge
alone); and the fold at G in {1, 257, 100,000, 131,073} for k in {1, 8,
16, 33}, two folds back to back each time, and two on a side stream,
which must draw a ticket of its own; and K1 (everything on, the hier
rule, the read plane at S = 4 and 8) and K2 (with and without contact
tracking and votes, the hier rule) at their row slabs' edges, G in {1,
257, 300, 4,099} for every peer width, each with its planes aligned and
as views that start off a 16-byte boundary, and two K2 launches back to
back on the current stream and on a side stream, whose contacted scratch
must be all zero after each.  Operation bounds use the
card's INT32 issue rate, read from ``nvidia-smi`` (``int32_peak``).
Each of phases 3 to 14 drives a main path: the launch counters are
zeroed just before it and read just after, and every kernel that path
runs must have launched.  JSON lines report what was measured; the line
before the last is the card's name and power limit, the last line the
result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peak HBM3 bandwidth (NVIDIA data sheet).  The
# kernels' operations (compares, min/max, selects, logic, adds) issue on
# the SMs' INT32 lanes, 64 a clock on each SM (Hopper architecture white
# paper), so their peak is SMs x 64 x the SM clock: ``int32_peak`` sets
# PEAK_OPS_PER_S from the card before any bound is computed.
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
PEAK_OPS_PER_S = None

TPU_KERNELS = {  # the JAX function each CUDA kernel replaces
    "quorum_step_dense": ("dragonboat_tpu_torch/csrc/quorum_step_dense.cu",
                          "dragonboat_tpu/ops/kernels.py:686"),
    "quorum_step": ("dragonboat_tpu_torch/csrc/quorum_step.cu",
                    "dragonboat_tpu/ops/kernels.py:520"),
    "quorum_multiround": ("dragonboat_tpu_torch/csrc/quorum_multiround.cu",
                          "dragonboat_tpu/ops/kernels.py:1021"),
    # the HIER instances of the three step kernels (launch counter
    # "finish_hier"); timed as K3's, the hier main path's kernel
    "finish_hier": ("dragonboat_tpu_torch/csrc/quorum.cuh",
                    "dragonboat_tpu/ops/kernels.py:640"),
    "telem_fold": ("dragonboat_tpu_torch/csrc/telem_fold.cu",
                   "dragonboat_tpu/ops/kernels.py:213"),
    # the READS instances of K1 and K3 (launch counter "read_plane"):
    # read_confirm (:331) inside _read_plane; timed as K3's at rung 4
    "read_plane": ("dragonboat_tpu_torch/csrc/quorum.cuh",
                   "dragonboat_tpu/ops/kernels.py:362"),
    # the device state machine, a kernel of its own after K1 or K3 (K3
    # passes it each round's watermark through a (K, G) trace); timed
    # alone at rung 4's K = 16 shape
    "kv_plane": ("dragonboat_tpu_torch/csrc/kv_plane.cu",
                 "dragonboat_tpu/ops/kernels.py:402"),
    # the R-round scans (B13), timed at the multistep main path's shape
    "quorum_multistep": ("dragonboat_tpu_torch/csrc/quorum_multistep.cu",
                         "dragonboat_tpu/ops/kernels.py:802"),
    "quorum_multistep_dense": ("dragonboat_tpu_torch/csrc/quorum_multistep.cu",
                               "dragonboat_tpu/ops/kernels.py:872"),
    # the pipelined ladder's dispatch (B8), timed at the headline shape
    "staged_multistep": ("dragonboat_tpu_torch/csrc/quorum_multistep.cu",
                         "bench.py:131"),
}
STEP_KERNELS = ("quorum_step_dense", "quorum_step", "quorum_multiround")
# every kernel the coordinator's rounds launch (phase 13)
COORD_KERNELS = STEP_KERNELS + ("read_plane", "finish_hier", "telem_fold", "kv_plane")


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def int32_peak(torch) -> dict:
    """The card's INT32 issue rate: SMs x 64 lanes x the SM clock that
    ``nvidia-smi`` reports as its maximum."""
    global PEAK_OPS_PER_S
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PEAK_OPS_PER_S = sms * INT32_LANES_PER_SM * mhz * 1e6
    return {"phase": "peak", "int32_ops_per_s": PEAK_OPS_PER_S, "sms": sms,
            "int32_lanes_per_sm": INT32_LANES_PER_SM, "sm_clock_max_mhz": mhz,
            "bytes_per_s": PEAK_BYTES_PER_S}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs made with numpy from a seed
# ----------------------------------------------------------------------


def random_fields(ts, seed, g, p, s=None, kv=None):
    """A random state; with ``s`` read slots it also holds pending read
    batches and echo bits, and self slots out of range on both sides; with
    ``kv`` = (V, E) a device state machine of V value slots and E entry
    slots with random values and buffered entries (keys in and outside
    [0, V)) and a few rows whose watermark is negative."""
    rng = np.random.default_rng(seed)
    v, e = kv or (ts.KV_SLOTS, ts.KV_ENT_SLOTS)
    widths = {"p": p, "s": s or ts.READ_SLOTS, "v": v, "e": e}
    f = {name: np.full((g,) + tuple(widths[a] for a in axes), fill, dtype)
         for name, (axes, dtype, fill) in ts.FIELDS.items()}
    f["node_state"][:] = rng.choice([0, 1, 2, 2, 2, 3, 4], g)
    f["live"][:] = rng.random(g) < 0.9
    f["term"][:] = rng.integers(0, 6, g)
    f["voting"][:] = rng.random((g, p)) < 0.8
    f["present"][:] = f["voting"] | (rng.random((g, p)) < 0.5)
    f["quorum"][:] = f["voting"].sum(1) // 2 + 1
    f["self_slot"][:] = rng.integers(0, p, g)
    f["self_slot"][::17] = p
    f["match"][:] = rng.integers(0, 20, (g, p))
    f["next"][:] = f["match"] + rng.integers(1, 4, (g, p))
    f["last_index"][:] = f["match"].max(1) + rng.integers(0, 3, g)
    f["committed"][:] = rng.integers(0, 12, g)
    f["term_start"][:] = rng.integers(0, 14, g)
    f["election_tick"][:] = rng.integers(0, 12, g)
    f["heartbeat_tick"][:] = rng.integers(0, 3, g)
    f["rand_timeout"][:] = rng.integers(4, 14, g)
    f["election_timeout"][:] = rng.integers(3, 10, g)
    f["heartbeat_timeout"][:] = rng.integers(1, 3, g)
    f["electable"][:] = rng.random(g) < 0.8
    f["check_quorum_on"][:] = rng.random(g) < 0.5
    f["active"][:] = rng.random((g, p)) < 0.4
    f["votes"][:] = rng.choice([-1, -1, 0, 1], (g, p))
    # the hier geometry (some sub-quorums above the near count, a third
    # off) and the fold's watermark, from their own stream
    rng2 = np.random.default_rng(seed + 7)
    f["near"][:] = rng2.random((g, p)) < 0.5
    f["sub_quorum"][:] = rng2.integers(0, p + 2, g)
    f["sub_quorum"][::3] = 0
    f["telem_prev_committed"][:] = np.where(rng2.random(g) < 0.5, f["committed"], 0)
    if s is not None:
        rng3 = np.random.default_rng(seed + 13)
        f["read_index"][:] = rng3.integers(0, 12, (g, s))
        f["read_count"][:] = rng3.choice([0, 0, 1, 2, 5], (g, s))
        f["read_acks"][:] = rng3.random((g, s, p)) < 0.3
        f["self_slot"][5::17] = -1
    if kv is not None:
        rng4 = np.random.default_rng(seed + 19)
        f["kv_value"][:] = rng4.integers(-50, 50, (g, v))
        f["kv_ent_index"][:] = np.where(rng4.random((g, e)) < 0.4,
                                        rng4.integers(0, 16, (g, e)), -1)
        f["kv_ent_key"][:] = rng4.integers(-2, v + 3, (g, e))
        f["kv_ent_val"][:] = rng4.integers(-2**31, 2**31, (g, e))
        f["committed"][7::23] = -3
    return f


def kv_inputs(seed, g, v, e, r, k=None):
    """One dispatch's devsm inputs: stage index (-1 and below = none),
    keys in and outside [0, V), int32 values, read keys (-1, -4, >= V),
    with a leading K axis for K3."""
    rng = np.random.default_rng(seed + 23)
    lead = () if k is None else (k,)
    idx = np.where(rng.random(lead + (g, e)) < 0.35, rng.integers(0, 20, lead + (g, e)),
                   rng.choice([-1, -1, -2, -9], lead + (g, e))).astype(np.int32)
    key = rng.integers(-2, v + 3, lead + (g, e)).astype(np.int32)
    val = rng.integers(-2**31, 2**31, lead + (g, e)).astype(np.int32)
    rk = np.where(rng.random(lead + (g, r)) < 0.5, rng.integers(0, v + 3, lead + (g, r)),
                  rng.choice([-1, -1, -4], lead + (g, r))).astype(np.int32)
    return idx, key, val, rk


def kv_traps(fields, kv):
    """The reference's bit-exact traps, injected: row 0 holds two ready
    entries sharing key 0 and the largest index (their int32 values sum
    and wrap) beside an earlier one; row 1 reads keys V and -4; row 2 is
    a follower with a negative watermark reading every round (the K-round
    carry keeps no capture at a negative index); row 3 stages at index -5."""
    idx, key, val, rk = kv
    at = (0,) if idx.ndim == 3 else ()
    v = fields["kv_value"].shape[1]
    fields["committed"][0] = 30
    fields["kv_ent_index"][0] = -1
    idx[at + (0,)] = -1
    n = min(3, idx.shape[-1])
    idx[at + (0, slice(0, n))] = [9, 9, 4][:n]
    key[at + (0, slice(0, n))] = 0
    val[at + (0, slice(0, n))] = [2**31 - 1, 5, 77][:n]
    rk[at + (1, slice(0, min(2, rk.shape[-1])))] = [v, -4][:min(2, rk.shape[-1])]
    fields["committed"][2], fields["node_state"][2] = -5, 0
    rk[..., 2, :] = 0
    idx[at + (3, 0)] = -5


def read_inputs(seed, g, p, s, k=None):
    """One dispatch's read-plane inputs: stage index (-1 = none), counts
    (some 0: cancels) and echo bits, with a leading K axis for K3."""
    rng = np.random.default_rng(seed + 17)
    lead = () if k is None else (k,)
    idx = np.where(rng.random(lead + (g, s)) < 0.35,
                   rng.integers(0, 12, lead + (g, s)), -1).astype(np.int32)
    cnt = rng.choice([0, 1, 3, 9], lead + (g, s)).astype(np.int32)
    echo = rng.random(lead + (g, s, p)) < 0.35
    return idx, cnt, echo


def telem_fields(ts, seed, g, p):
    """A state for the fold: lags drawn from a few values (many ties),
    some at 2^i - 1, 2^i and 2^25 - 1, dead rows, occupied read and kv
    slots, and watermarks half equal to committed."""
    f = random_fields(ts, seed, g, p)
    rng = np.random.default_rng(seed + 11)
    lags = [0, 0, 1, 2, 3, 5, 8, 2**14 - 1, 2**14, 2**25 - 1]
    f["last_index"][:] = f["committed"] + rng.choice(lags, g)
    f["read_count"][:] = rng.integers(0, 3, f["read_count"].shape)
    f["kv_ent_index"][:] = rng.integers(-1, 3, f["kv_ent_index"].shape)
    return f


def dense_inputs(seed, g, p):
    rng = np.random.default_rng(seed)
    touched = rng.random((g, p)) < 0.35
    ack_max = np.where(touched, rng.integers(0, 25, (g, p)), 0).astype(np.int32)
    vote_new = rng.choice([-1, -1, -1, 0, 1], (g, p)).astype(np.int8)
    return ack_max, touched, vote_new


def sparse_inputs(seed, g, p, cap):
    rng = np.random.default_rng(seed)
    ag = rng.integers(0, g, cap).astype(np.int32)
    ap = rng.integers(0, p, cap).astype(np.int32)
    av = rng.integers(0, 25, cap).astype(np.int32)
    valid = np.ones(cap, bool)
    valid[-7:] = False
    ag[3], ap[5] = g + 2, p
    cells = rng.choice(g * p, size=min(cap // 2, g * p), replace=False)
    vg = (cells // p).astype(np.int32)
    vp = (cells % p).astype(np.int32)
    vv = rng.integers(0, 2, cells.size).astype(np.int8)
    vvalid = rng.random(cells.size) < 0.8
    return (ag, ap, av, valid), (vg, vp, vv, vvalid)


def multiround_inputs(seed, k, g, p, c):
    rng = np.random.default_rng(seed)
    ack = np.where(
        rng.random((k, g, p)) < 0.35, rng.integers(0, 25, (k, g, p)), -1
    ).astype(np.int32)
    votes = rng.choice([-1, -1, -1, 0, 1], (k, g, p)).astype(np.int8)
    churn_row = np.full((k, c), g, np.int32)
    for r in range(k):
        n = int(rng.integers(c // 2, c + 1))
        churn_row[r, :n] = rng.choice(g, size=n, replace=False)
    churn_term = rng.integers(1, 9, (k, c)).astype(np.int32)
    churn_start = rng.integers(0, 5, (k, c)).astype(np.int32)
    churn_last = (churn_start + rng.integers(0, 5, (k, c))).astype(np.int32)
    tick_mask = rng.random(k) < 0.6
    tick_mask[0], tick_mask[-1] = True, False  # partial
    return ack, votes, (churn_row, churn_term, churn_start, churn_last), tick_mask


# ----------------------------------------------------------------------
# bytes each kernel must move: each input read once, each output written
# once.  The state is updated in place, so its output is the cells that
# this run's data changes, counted against the plain version's result.
# ----------------------------------------------------------------------


def state_read_bytes(g, p, flags, s=0):
    """The state fields one step reads, once per row: node_state live
    committed last_index term_start quorum self_slot; match next voting
    active votes; the election clock where contact or ticks use it; the
    other clocks, timeouts and switches where it ticks; with the read
    plane, the row's ``s`` read slots (index, count, echo bits)."""
    read = 22 + 11 * p
    if flags["track_contact"] or flags["do_tick"]:
        read += 4
    if flags["do_tick"]:
        read += 18
    if flags.get("has_hier"):  # near and sub_quorum
        read += p + 4
    if flags.get("has_reads"):
        read += s * (8 + p)
    return g * read


def state_written_bytes(before, after):
    """The bytes of the state cells that differ between ``before`` and
    ``after`` (two QuorumStates on the card)."""
    return sum(int((a != b).sum()) * a.element_size()
               for a, b in zip(before, after))


def input_bytes(name, inputs, flags):
    """The step's inputs (numpy arrays) that its flags make it read."""
    if name == "quorum_step_dense":
        ack_max, touched, vote_new = inputs[0]
        return ack_max.nbytes + touched.nbytes + (vote_new.nbytes if flags["has_votes"] else 0)
    if name == "quorum_step":
        acks, votes = inputs
        return sum(a.nbytes for a in acks) + (
            sum(a.nbytes for a in votes) if flags["has_votes"] else 0)
    (ack, votes), (*churn, tick_mask) = inputs[:2]
    return (ack.nbytes + (votes.nbytes if flags["has_votes"] else 0)
            + (tick_mask.nbytes if flags["do_tick"] else 0)
            + (sum(a.nbytes for a in churn) if flags["has_churn"] else 0))


def kernel_bytes(name, inputs, flags, before, after):
    """Bytes one launch must move on this run's data: the state it reads
    (the read slots once a row with the read plane), its inputs (the
    stage and echo planes with it), the state cells it changes (read
    slots included) and its five (G,) flag outputs (and the (2, G, S)
    read egress)."""
    g, p = before.match.shape
    s = before.read_index.shape[1]
    n = (state_read_bytes(g, p, flags, s) + input_bytes(name, inputs, flags)
         + state_written_bytes(before, after) + 5 * g)
    if flags.get("has_reads"):
        n += sum(a.nbytes for a in inputs[-1]) + 2 * g * s * 4
    return n


def kv_bytes(before, after, inputs, k, churn):
    """Bytes the device state machine must move on this run's data: the kv
    state read once a row (V + 3E ints), its inputs, the (K, G) watermark
    trace it reads (K3's write of the trace is charged to K3), K3's (K, G)
    churn map where recycles reset rows, the kv cells that change and the
    (G, R) x 2 + (G,) egress."""
    g, v = before.kv_value.shape
    e = before.kv_ent_index.shape[1]
    r = inputs[3].shape[-1]
    changed = sum(int((a != b).sum()) * 4 for a, b in (
        (before.kv_value, after.kv_value), (before.kv_ent_index, after.kv_ent_index),
        (before.kv_ent_key, after.kv_ent_key), (before.kv_ent_val, after.kv_ent_val)))
    return (g * (v + 3 * e) * 4 + sum(a.nbytes for a in inputs) + k * g * 4
            + (k * g * 4 if churn else 0) + changed + (2 * g * r + g) * 4)


def kv_ops(g, e, r, k, applied):
    """Integer operations of the plane per launch on this run's data: per
    row and round the stage (3E), the ready test (2E), the reads (~4R)
    and control (~10); per applied entry the winner search (~3E)."""
    return g * k * (5 * e + 4 * r + 10) + 3 * e * applied


def telem_bytes(st_before, st_after, k, count_reads, count_kv):
    """Bytes the fold must move: live, node_state, last_index, committed
    and telem_prev_committed of every row (14 B), the occupancy arrays
    it is asked to sweep, the watermark cells it changes and its output
    block."""
    g = st_before.match.shape[0]
    n = 14 * g + 4 * (24 + 2 * min(k, g))
    if count_reads:
        n += st_before.read_count.numel() * 4
    if count_kv:
        n += st_before.kv_ent_index.numel() * 4
    changed = st_before.telem_prev_committed != st_after.telem_prev_committed
    return n + int(changed.sum()) * 4


def kernel_ops(g, p, k=1, s=0):
    """Integer operations per launch: ingest ~6P, the commit network ~3 per
    compare-exchange, tally ~4P, tick and control ~40, per row and round;
    the read plane ~2P + 12 per slot and round (``s`` slots, 0 = off)."""
    ce = {1: 0, 2: 1, 3: 3, 4: 5, 5: 9, 6: 12, 7: 16, 8: 19}.get(p, p * p)
    return g * k * (6 * p + 3 * ce + 4 * p + 40 + s * (2 * p + 12))


def staged_ops(g, p, r):
    """Integer operations of the staged dispatch's R rounds (bench.py
    ``_staged_multistep_fn``) per launch: per row and round the ingest (a
    max with the round's ack or 0, an add and a max into next: 3P), the
    activity bits (1), the self column (P selects, a max), the commit
    rule (P mask selects, 2 per compare-exchange, P - 1 picks of the
    k-th column, two compares, an and and a select: 2P + 2CE + 3) and the
    tick (the clock add, two compares and two ands, an or and a select,
    the check-quorum and and and-not, the heartbeat add, compare and
    select: 12).  The vote tally is left out: the dispatch discards the
    won/lost flags it feeds."""
    ce = {1: 0, 2: 1, 3: 3, 4: 5, 5: 9, 6: 12, 7: 16, 8: 19}.get(p, p * p)
    return g * r * (3 * p + 1 + (p + 1) + (2 * p + 2 * ce + 3) + 12)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------
# timing on the card
# ----------------------------------------------------------------------


def device_ms(torch, fn, reset, iters=30, warmup=3):
    """Median device time of ``fn``'s launches, each on the inputs that
    ``reset`` restores ahead of it (outside the timed span): a sleep kernel
    keeps the stream busy while the host enqueues start event, launch and
    end event, so the events bracket device work only."""
    for _ in range(warmup):
        reset()
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        reset()
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def wall_ms(torch, fn, iters=20, warmup=2):
    """Median host wall time of ``fn`` to completion on the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ----------------------------------------------------------------------


def _equal_outputs(torch, ts, tk, kout, pout, tag):
    """Checks that every state field and output of the kernel equals the
    plain version's (the telemetry aggregate too, where the step folded);
    returns the largest absolute difference seen."""
    pairs = [(f"state field {name}", getattr(kout.state, name), getattr(pout.state, name))
             for name in ts.FIELDS]
    pairs += [(name, getattr(kout, name), getattr(pout, name))
              for name in ("committed", "won", "lost")]
    pairs += list(zip(tk.TickFlags._fields, kout.flags, pout.flags))
    check((kout.telem is None) == (pout.telem is None), f"{tag}: telem presence differs")
    check((kout.read_done_count is None) == (pout.read_done_count is None),
          f"{tag}: read egress presence differs")
    if pout.read_done_count is not None:
        pairs += [(name, getattr(kout, name), getattr(pout, name))
                  for name in ("read_done_count", "read_done_index")]
    check((kout.kv_read_val is None) == (pout.kv_read_val is None),
          f"{tag}: kv egress presence differs")
    if pout.kv_read_val is not None:
        pairs += [(name, getattr(kout, name), getattr(pout, name))
                  for name in ("kv_read_val", "kv_read_index", "kv_applied")]
    if pout.telem is not None:
        pairs += [(f"telem {name}", a, b.to(torch.int32)) for name, a, b in
                  zip(tk.TelemAggregate._fields, kout.telem, pout.telem)]
    err = 0
    for name, a, b in pairs:
        check(a.shape == b.shape and a.dtype == b.dtype, f"{tag}: {name} shape or dtype differs")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
        check(torch.equal(a, b), f"{tag}: {name} differs")
    return err


def _entries(tk, name):
    return {
        "quorum_step_dense": (tk.quorum_step_dense, tk.quorum_step_dense_impl),
        "quorum_step": (tk.quorum_step, tk.quorum_step_impl),
        "quorum_multiround": (tk.quorum_multiround, tk.quorum_multiround_impl),
        "quorum_multistep": (tk.quorum_multistep, tk.quorum_multistep_impl),
        "quorum_multistep_dense": (tk.quorum_multistep_dense, tk.quorum_multistep_dense_impl),
    }[name]


def _run_pair(torch, ts, tk, name, fields, inputs, flags, dev):
    """The kernel and the plain version on the same card inputs (the
    groups of ``inputs`` are the entry's positional arguments in order)."""
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    args = _device_args(torch, inputs, dev)
    entry, plain = _entries(tk, name)
    kout = entry(st_k, *args, **flags)
    pout = plain(st_p, *args, **flags)
    torch.cuda.synchronize()
    return kout, pout


def _device_args(torch, inputs, dev):
    """The groups of ``inputs`` as one flat list of card tensors (None
    stays None: a plane's unread placeholders)."""
    return [None if a is None else torch.from_numpy(np.array(a)).to(dev)
            for grp in inputs for a in grp]


def _inputs(name, seed, g, p, k=8, c=2048, cap=4096, s=None, kv=None):
    """The entry's inputs; with ``s`` read slots the read-plane inputs
    follow as a group, and with ``kv`` = (V, E, R) the devsm inputs (the
    read group then holds placeholders when ``s`` is None)."""
    lead = k if name == "quorum_multiround" else None
    if name == "quorum_step_dense":
        out = (dense_inputs(seed, g, p),)
    elif name == "quorum_step":
        out = sparse_inputs(seed, g, p, cap)
    else:
        ack, votes, churn, tm = multiround_inputs(seed, k, g, p, c)
        out = (ack, votes), churn + (tm,)
    if s is not None:
        out += (read_inputs(seed, g, p, s, lead),)
    if kv is not None:
        if s is None:
            out += ((None, None, None),)
        out += (kv_inputs(seed, g, *kv, k=lead),)
    return out


def _flag_grid(name):
    out = []
    for do_tick in (False, True):
        for votes in (False, True):
            if name == "quorum_multiround":
                for churn in (False, True):
                    out.append(dict(do_tick=do_tick, track_contact=True,
                                    has_votes=votes, has_churn=churn))
            else:
                for track in (False, True):
                    out.append(dict(do_tick=do_tick, track_contact=track,
                                    has_votes=votes))
    if name == "quorum_multiround":  # the rung-5 variant: no ticks, no contact
        out.append(dict(do_tick=False, track_contact=False, has_votes=False,
                        has_churn=True))
    return out


def _hier_telem(flags, name, telem=True):
    """``flags`` with the hier rule and, if asked, the fold (K3: with its
    recycle reset of the fold's watermark)."""
    out = dict(flags, has_hier=True)
    if telem:
        out["has_telem"] = True
        if name == "quorum_multiround":
            out["purge_telem"] = True
    return out


# the variant each kernel runs on the main path, timed at its shape
MAIN_VARIANT = {
    "quorum_step_dense": dict(do_tick=True, track_contact=True, has_votes=False),
    "quorum_step": dict(do_tick=True, track_contact=True, has_votes=False),
    "quorum_multiround": dict(do_tick=False, track_contact=False, has_votes=False,
                              has_churn=True),
}
# the hier main path's K3 (rung 5 with hier and the fold on), without the
# fold, which is timed on its own
HIER_VARIANT = dict(MAIN_VARIANT["quorum_multiround"], has_hier=True,
                    purge_telem=True)
TELEM_VARIANT = dict(k=8, count_reads=False, count_kv=False)
# the READS instances on their main paths, timed at 65,536 x 5, S = 4: K1
# as the read op script's single-round read dispatch runs it, K3 as rung
# 4's mixed phase (K = 16, no churn, no ticks, no contact)
READS_G, READS_K = 65_536, 16
READS_VARIANT = {
    "quorum_step_dense": dict(MAIN_VARIANT["quorum_step_dense"], has_reads=True),
    "quorum_multiround": dict(do_tick=False, track_contact=False, has_votes=False,
                              has_churn=False, has_reads=True),
}


def _reads_grid(name):
    """The flag grid of ``name`` with the read plane on, with and without
    the hier rule; for K3 also the recycle purge alone (purge_reads with
    churn, the plane off) and the fold counting read slots."""
    base = [dict(f, has_reads=True) for f in _flag_grid(name)]
    grid = base + [dict(f, has_hier=True) for f in base]
    grid.append(_hier_telem(READS_VARIANT[name], name))
    if name == "quorum_multiround":
        grid += [dict(f, purge_reads=True) for f in _flag_grid(name) if f["has_churn"]]
        grid.append(dict(base[-1], has_telem=True, purge_telem=True))
    return grid


def _reads_small(name):
    """The READS cases run at every peer width: everything on, the hier
    rule with it, K1 with everything else off and K3 with its recycle
    purge alone (the plane off), and the fold after the plane."""
    all_on = dict(_flag_grid(name)[0], do_tick=True, has_votes=True,
                  track_contact=True, has_reads=True)
    if name == "quorum_multiround":
        all_on["has_churn"] = True
        off = dict(all_on, has_reads=False, purge_reads=True)
    else:
        off = dict(all_on, do_tick=False, has_votes=False, track_contact=False)
    return (all_on, dict(all_on, has_hier=True), off,
            _hier_telem(READS_VARIANT[name], name))


# the device state machine at rung 4's shape: 65,536 x 5, K = 16 for K3,
# (V, E, R) = (16, 16, 4); at 4,096 groups also (1, 1, 1) and the caps
KV_G, KV_K = 65_536, 16
KV_DIMS = (16, 16, 4)
KV_SMALL_DIMS = (KV_DIMS, (1, 1, 1), (1024, 32, 8))


def _kv_grid(name):
    """The flag grid of ``name`` with the device state machine on, with
    and without the read plane and the hier rule, and the fold counting
    entry slots after it; for K3 also the recycle purge alone (purge_kv
    with churn, the plane off), and with the fold."""
    base = [dict(f, has_kv=True) for f in _flag_grid(name)]
    grid = (base + [dict(f, has_reads=True) for f in base[::2]]
            + [dict(f, has_hier=True) for f in base[1::2]])
    grid.append(_hier_telem(dict(base[-1], has_reads=True), name))
    if name == "quorum_multiround":
        purge = [dict(f, purge_kv=True) for f in _flag_grid(name) if f["has_churn"]]
        grid += purge + [dict(purge[-1], has_telem=True, purge_telem=True)]
    return grid


def _kv_small(name):
    """The kv cases run at every peer width: everything on (K1 with the
    read plane and the hier rule too, K3 with churn), and K3's purge
    alone."""
    all_on = dict(_flag_grid(name)[0], do_tick=True, has_votes=True, track_contact=True,
                  has_kv=True)
    if name == "quorum_multiround":
        all_on["has_churn"] = True
        return all_on, dict(all_on, has_kv=False, purge_kv=True)
    return all_on, dict(all_on, has_reads=True, has_hier=True, has_telem=True)


def _kv_case(torch, ts, tk, dev, name, seed, g, p, flags, dims, k, c):
    """One kernel-vs-plain comparison with the devsm inputs and the
    injected traps (``kv_traps``) where the plane runs."""
    v, e, r = dims
    s = 4 if flags.get("has_reads") else None
    fields = random_fields(ts, seed, g, p, s, kv=(v, e))
    inputs = _inputs(name, seed, g, p, k=k, c=c, s=s,
                     kv=dims if flags.get("has_kv") else None)
    if flags.get("has_kv"):
        kv_traps(fields, inputs[-1])
    kout, pout = _run_pair(torch, ts, tk, name, fields, inputs, flags, dev)
    return _equal_outputs(torch, ts, tk, kout, pout, f"{name} G={g} P={p} {dims} {flags}")


def plain_kv_rounds(torch, tk, st, inputs, trace):
    """The plain version of one kv_plane launch after K3: the reference's
    ``_kv_plane`` at each round's watermark of ``trace``, with the
    K-round carry."""
    g, r = trace.shape[1], inputs[3].shape[-1]
    val = torch.zeros((g, r), dtype=torch.int32, device=trace.device)
    idx = torch.full((g, r), -1, dtype=torch.int32, device=trace.device)
    ap = torch.zeros((g,), dtype=torch.int32, device=trace.device)
    for k in range(trace.shape[0]):
        st, rv, ri, a = tk._kv_plane(st._replace(committed=trace[k]), *(x[k] for x in inputs))
        cap = ri >= 0
        val, idx, ap = torch.where(cap, rv, val), torch.where(cap, ri, idx), ap + a
    return st, val, idx, ap


def _time_kv(torch, ts, tk, dev, g=KV_G, p=5, k=KV_K, dims=KV_DIMS, seed=33_000):
    """Device time of one kv_plane launch at rung 4's shape (K rounds of
    a watermark rising one index a round, no churn) on a restored state,
    its bound, and the plain version's wall time; the launch is held
    against the plain version, bit for bit."""
    v, e, r = dims
    fields = random_fields(ts, seed, g, p, kv=(v, e))
    kv = kv_inputs(seed, g, v, e, r, k=k)
    trace = (np.maximum(fields["committed"], 0)[None, :]
             + np.arange(1, k + 1)[:, None]).astype(np.int32)
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    ins = [torch.from_numpy(a).to(dev) for a in kv]
    tr = torch.from_numpy(trace).to(dev)
    ck, block = tk._ckv(st_k, dev, ins, k, tr, None)
    kern = lambda: tk._kv_run(dev, ck, tk._KV_PLANE | tk._KV_CARRY)  # noqa: E731
    plain = lambda: plain_kv_rounds(torch, tk, st_p, ins, tr)  # noqa: E731
    saved = [t.clone() for t in st_k]

    def reset():
        for t, s in zip(st_k, saved):
            t.copy_(s)

    pst, pv, pi, pa = plain()
    nbytes = kv_bytes(st_p, pst, kv, k, False)
    b_ms, b_by = bound_ms(nbytes, kv_ops(g, e, r, k, int(pa.sum())))
    ms = device_ms(torch, kern, reset)
    reset()
    kern()
    torch.cuda.synchronize()
    rv, ri, ra = tk._kv_views(block, g, r)
    err = 0
    for name, a, b in [(n, getattr(st_k, n), getattr(pst, n)) for n in
                       ("kv_value", "kv_ent_index", "kv_ent_key", "kv_ent_val")] + [
                       ("kv_read_val", rv, pv), ("kv_read_index", ri, pi), ("kv_applied", ra, pa)]:
        err = max(err, int((a.long() - b.long()).abs().max()))
        check(torch.equal(a, b), f"kv_plane timed: {name} differs")
    return {
        "ms": ms, "plain_ms": wall_ms(torch, plain, iters=10),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "applied": int(pa.sum()), "captured": int((pi >= 0).sum()),
        "shape": {"G": g, "K": k, "V": v, "E": e, "R": r},
    }, err


def _time_trace(torch, ts, tk, dev, g=KV_G, p=5, k=KV_K, seed=34_000):
    """K3's device time at rung 4's write shape (K = 16, no churn, no
    ticks, no contact) on a restored state, without the device state
    machine and with K3's share of it, the (K, G) watermark trace that K3
    stores (the kv_plane launch after it is skipped for that span), each
    beside its bound: the trace's write is charged to K3."""
    fields = random_fields(ts, seed, g, p, kv=KV_DIMS[:2])
    inputs = _inputs("quorum_multiround", seed, g, p, k=k, kv=KV_DIMS)
    flags = dict(do_tick=False, track_contact=False, has_votes=False, has_churn=False)
    st = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    saved = [t.clone() for t in st]
    args = _device_args(torch, inputs, dev)

    def reset():
        for t, s0 in zip(st, saved):
            t.copy_(s0)

    pout = tk.quorum_multiround_impl(st_p, *args[:7], **flags)
    nbytes = kernel_bytes("quorum_multiround", inputs, flags, st_p, pout.state)
    ops = kernel_ops(g, p, k=k)
    trace_bytes = k * g * 4
    without = device_ms(torch, lambda: tk.quorum_multiround(st, *args[:7], **flags), reset)
    orig = tk._kv_run
    tk._kv_run = lambda *a, **kw: None
    try:
        with_trace = device_ms(
            torch, lambda: tk.quorum_multiround(st, *args, has_kv=True, **flags), reset)
    finally:
        tk._kv_run = orig
    return {"ms_without_kv": without, "ms_with_trace": with_trace,
            "bound_ms_without_kv": bound_ms(nbytes, ops)[0],
            "bound_ms_with_trace": bound_ms(nbytes + trace_bytes, ops)[0],
            "trace_bytes": trace_bytes, "shape": {"G": g, "P": p, "K": k}, "flags": flags}


def _compare_telem(torch, ts, tk, fields, dev, k, count_reads, count_kv, tag, folds=1,
                   stream=None):
    """``folds`` folds back to back on the kernel and on the plain
    version (on ``stream`` when given: the wrapper then draws that
    stream's own ticket), each compared, the second on the first's
    watermarks; returns the largest absolute difference seen."""
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    err = 0
    for n in range(folds):
        if stream is None:
            agg = tk.telem_fold(st_k, k, count_reads, count_kv)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                agg = tk.telem_fold(st_k, k, count_reads, count_kv)
        st_p, pagg = tk.telem_fold_impl(st_p, k, count_reads, count_kv)
        torch.cuda.synchronize()
        pairs = [(f"telem {name}", a, b.to(torch.int32))
                 for name, a, b in zip(tk.TelemAggregate._fields, agg, pagg)]
        pairs.append(("telem_prev_committed", st_k.telem_prev_committed,
                      st_p.telem_prev_committed))
        for name, a, b in pairs:
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{tag} fold {n}: {name} shape or dtype differs")
            if a.numel():
                err = max(err, int((a.long() - b.long()).abs().max()))
            check(torch.equal(a, b), f"{tag} fold {n}: {name} differs")
    return err


def _time_step(torch, ts, tk, dev, name, flags, g, p, seed=30_000, k=8, s=None):
    """Device time of one step kernel's launch on a restored state, its
    bound, and its plain version's wall time, at the main path's shape
    (``k`` rounds for K3; ``s`` read slots for the READS instances)."""
    fields = random_fields(ts, seed, g, p, s)
    inputs = _inputs(name, seed, g, p, k=k, s=s)
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    entry, plain_fn = _entries(tk, name)
    args = [torch.from_numpy(np.array(a)).to(dev) for grp in inputs for a in grp]
    kern = lambda: entry(st_k, *args, **flags)  # noqa: E731
    plain = lambda: plain_fn(st_p, *args, **flags)  # noqa: E731
    saved = [t.clone() for t in st_k]

    def reset():
        for t, s in zip(st_k, saved):
            t.copy_(s)

    pout = plain()  # functional: st_p stays the input state
    nbytes = kernel_bytes(name, inputs, flags, st_p, pout.state)
    ops = kernel_ops(g, p, k=k if name == "quorum_multiround" else 1, s=s or 0)
    b_ms, b_by = bound_ms(nbytes, ops)
    ms = device_ms(torch, kern, reset)
    reset()
    err = _equal_outputs(torch, ts, tk, kern(), pout, f"{name} timed {flags}")
    return {
        "ms": ms,
        "plain_ms": wall_ms(torch, plain, iters=10),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "bytes_state_written": state_written_bytes(st_p, pout.state),
        "shape": {"G": g, "P": p,
                  **({"K": k, "C": 2048} if name == "quorum_multiround"
                     else {"events": 4096} if name == "quorum_step" else {}),
                  **({"S": s} if s else {})},
        "flags": flags,
    }, err


def _time_telem(torch, ts, tk, dev, g, p, k, count_reads, count_kv, seed=31_000):
    fields = telem_fields(ts, seed, g, p)
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    saved = st_k.telem_prev_committed.clone()

    def reset():
        st_k.telem_prev_committed.copy_(saved)

    kern = lambda: tk.telem_fold(st_k, k, count_reads, count_kv)  # noqa: E731
    plain = lambda: tk.telem_fold_impl(st_p, k, count_reads, count_kv)  # noqa: E731
    pst, _ = plain()
    nbytes = telem_bytes(st_p, pst, k, count_reads, count_kv)
    b_ms, b_by = bound_ms(nbytes, 20 * g)
    ms = device_ms(torch, kern, reset)
    reset()
    err = _compare_telem(torch, ts, tk, fields, dev, k, count_reads, count_kv,
                         "telem_fold timed")
    return {
        "ms": ms, "plain_ms": wall_ms(torch, plain, iters=10),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "shape": {"G": g, "P": p, "k": k},
        "flags": {"count_reads": count_reads, "count_kv": count_kv},
    }, err


# the R-round scans (B13) at the multistep main path's shape, and the
# staged ladder dispatch (B8) at the headline's
MS_G, MS_R, MS_CAP = 65_536, 16, 4096
MS_FLAGS = [dict(do_tick=t, track_contact=c, has_votes=v, has_hier=h)
            for t in (False, True) for c in (False, True)
            for v in (False, True) for h in (False, True)]
# the variant the multistep main path runs, timed at its shape
MS_VARIANT = dict(do_tick=True, track_contact=True, has_votes=True, has_hier=True)
LADDER_G, LADDER_R = 131_072, 256
STAGED_ROUNDS = (1, 7, LADDER_R)
MULTISTEPS = ("quorum_multistep", "quorum_multistep_dense")


def multistep_traps(fields):
    """Match cells at INDEX_MIN and below zero: the sparse ingest keeps an
    untouched one, the dense ingest raises it to 0."""
    p = fields["match"].shape[1]
    fields["match"][::7, 0] = np.iinfo(np.int32).min
    fields["match"][3::11, p - 1] = -4


def multistep_inputs(name, seed, r, g, p, cap):
    """R rounds of the scan's inputs: for the sparse scan ``sparse_inputs``
    each round (its traps included: a valid ack on a row out of range and
    one on a slot out of range, invalid padding) with some negative acks;
    for the dense scan ``dense_inputs`` each round with negative acks on
    touched cells."""
    if name == "quorum_multistep":
        rounds = [sparse_inputs(seed + k, g, p, cap) for k in range(r)]
        acks = [np.stack([rd[0][i] for rd in rounds]) for i in range(4)]
        votes = [np.stack([rd[1][i] for rd in rounds]) for i in range(4)]
        acks[2][:, 8:16] = -3
        return tuple(acks), tuple(votes)
    rounds = [dense_inputs(seed + k, g, p) for k in range(r)]
    am, at, vn = (np.stack([rd[i] for rd in rounds]) for i in range(3))
    am[:, ::13, 0], at[:, ::13, 0] = -2, True
    return ((am, at, vn),)


def multistep_bytes(name, inputs, flags, before, after):
    """Bytes one scan must move on this run's data: the state it reads
    once, its inputs (the events, or the (R, G, P) planes), the state
    cells it changes and its five (G,) flag outputs.  The sparse scan's
    scratch planes are its own traffic and not counted."""
    g, p = before.match.shape
    if name == "staged_multistep":
        n_in = 0
    elif name == "quorum_multistep":
        acks, votes = inputs
        n_in = sum(a.nbytes for a in acks) + (
            sum(a.nbytes for a in votes) if flags["has_votes"] else 0)
    else:
        am, at, vn = inputs[0]
        n_in = am.nbytes + at.nbytes + (vn.nbytes if flags["has_votes"] else 0)
    return (state_read_bytes(g, p, flags) + n_in
            + state_written_bytes(before, after) + 5 * g)


def _staged_pair(torch, ts, tk, fields, dev, base, rounds):
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    kout = tk.staged_multistep(st_k, base, rounds)
    pout = tk.staged_multistep_impl(st_p, base, rounds)
    torch.cuda.synchronize()
    return kout, pout


def _time_multistep(torch, ts, tk, dev, name, flags, fields, inputs, rounds,
                    base=1):
    """Device time of one scan's launch (30, each from the restored
    state), its bound over this run's data (``kernel_ops`` with k = R) and
    the plain version's wall time; the launch is held against the plain
    version."""
    g, p = fields["match"].shape
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    if name == "staged_multistep":
        kern = lambda: tk.staged_multistep(st_k, base, rounds)  # noqa: E731
        plain = lambda: tk.staged_multistep_impl(st_p, base, rounds)  # noqa: E731
        flags = dict(do_tick=True, track_contact=False, has_votes=False)
    else:
        entry, plain_fn = _entries(tk, name)
        args = _device_args(torch, inputs, dev)
        kern = lambda: entry(st_k, *args, **flags)  # noqa: E731
        plain = lambda: plain_fn(st_p, *args, **flags)  # noqa: E731
    saved = [t.clone() for t in st_k]

    def reset():
        for t, s0 in zip(st_k, saved):
            t.copy_(s0)

    pout = plain()
    nbytes = multistep_bytes(name, inputs, flags, st_p, pout.state)
    ops = (staged_ops(g, p, rounds) if name == "staged_multistep"
           else kernel_ops(g, p, k=rounds))
    b_ms, b_by = bound_ms(nbytes, ops)
    ms = device_ms(torch, kern, reset)
    reset()
    err = _equal_outputs(torch, ts, tk, kern(), pout, f"{name} timed R={rounds}")
    return {
        "ms": ms, "plain_ms": wall_ms(torch, plain, iters=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops,
        "kernel_ops": kernel_ops(g, p, k=rounds),
        "shape": {"G": g, "P": p, "R": rounds,
                  **({"events": MS_CAP} if name == "quorum_multistep" else {})},
        "flags": flags,
    }, err


def phase_multistep_kernels(torch, ts, tk, dev, ladder_mod, record, p=5):
    """B13a and B13b against their plain versions at 65,536 x 5, R = 16
    (``cap`` = 4,096 events a round for the sparse scan) over the flag
    grid, and at 4,096 groups for every peer width; B8 at 131,072 x 3
    from a ``build_state``'d state for R in {1, 7, 256}, and at 4,096
    groups for every width from a random state; then each timed."""
    n = 0
    for name in MULTISTEPS:
        for i, flags in enumerate(MS_FLAGS):
            seed = 90_000 + 100 * MULTISTEPS.index(name) + i
            fields = random_fields(ts, seed, MS_G, p)
            multistep_traps(fields)
            inputs = multistep_inputs(name, seed, MS_R, MS_G, p, MS_CAP)
            kout, pout = _run_pair(torch, ts, tk, name, fields, inputs, flags, dev)
            record(name, flags, _equal_outputs(torch, ts, tk, kout, pout, f"{name} {flags}"))
            n += 1
        for width in (1, 2, 3, 4, 5, 6, 7, 8, 12):
            for j, flags in enumerate((MS_FLAGS[-1], MS_FLAGS[0], MS_FLAGS[9])):
                seed = 91_000 + 100 * width + 10 * MULTISTEPS.index(name) + j
                fields = random_fields(ts, seed, 4096, width)
                multistep_traps(fields)
                inputs = multistep_inputs(name, seed, 4, 4096, width, 1024)
                kout, pout = _run_pair(torch, ts, tk, name, fields, inputs, flags, dev)
                record(name, flags, _equal_outputs(
                    torch, ts, tk, kout, pout, f"{name} P={width} {flags}"))
                n += 1
    t0 = time.perf_counter()
    eng = ladder_mod.build_state(LADDER_G, 64, device=dev)
    built = ts.state_to_numpy(eng.dev)
    build_s = time.perf_counter() - t0
    del eng
    for rounds in STAGED_ROUNDS:
        kout, pout = _staged_pair(torch, ts, tk, built, dev, 1, rounds)
        check(bool((kout.committed == 1 + rounds).all()),
              f"staged_multistep R={rounds}: a watermark is not base + R")
        record("staged_multistep", {}, _equal_outputs(
            torch, ts, tk, kout, pout, f"staged_multistep R={rounds}"))
        n += 1
    for width in (1, 2, 3, 4, 5, 6, 7, 8, 12):
        for rounds, base in ((7, 5), (9, 2**31 - 4)):
            fields = random_fields(ts, 92_000 + width, 4096, width)
            kout, pout = _staged_pair(torch, ts, tk, fields, dev, base, rounds)
            record("staged_multistep", {}, _equal_outputs(
                torch, ts, tk, kout, pout, f"staged_multistep P={width} R={rounds}"))
            n += 1
    emit({"phase": "multistep_vs_plain", "compared": n, "build_state_s": build_s})
    timings = {}
    for name in MULTISTEPS:
        fields = random_fields(ts, 93_000, MS_G, p)
        multistep_traps(fields)
        inputs = multistep_inputs(name, 93_000, MS_R, MS_G, p, MS_CAP)
        timings[name], err = _time_multistep(torch, ts, tk, dev, name, MS_VARIANT,
                                             fields, inputs, MS_R)
        record(name, MS_VARIANT, err)
        emit({"phase": "kernel_time", "name": name, **timings[name]})
    for rounds in STAGED_ROUNDS:
        t, err = _time_multistep(torch, ts, tk, dev, "staged_multistep", None, built,
                                 None, rounds)
        record("staged_multistep", {}, err)
        emit({"phase": "kernel_time", "name": f"staged_multistep[R={rounds}]", **t})
        if rounds == LADDER_R:
            timings["staged_multistep"] = t
    return n, timings


# K3 and the staged row loop at block edges: several 128-row blocks and a
# partial last one (G = 300), G x P off word alignment (257 x 3: the vote
# and echo planes end mid-word), and P in {4, 8}, whose rows are an even
# number of words (the widths where a row-major tile would share banks)
EDGE_SHAPES = ((300, 5), (257, 3), (4_099, 4), (4_099, 8))
# K3's cases there: rung 5's instance with the fold's recycle reset, the
# HIER instance with votes and ticks, the READS instance at S = 3 with
# votes and churn, and the devsm trace
EDGE_K3_FLAGS = (
    dict(do_tick=False, track_contact=False, has_votes=False, has_churn=True,
         has_telem=True, purge_telem=True),
    dict(do_tick=True, track_contact=True, has_votes=True, has_churn=True, has_hier=True),
    dict(do_tick=True, track_contact=True, has_votes=True, has_churn=True, has_reads=True),
    dict(do_tick=False, track_contact=True, has_votes=False, has_churn=True, has_kv=True),
)


# the device state machine at its segment edges (a warp of 32 / L rows,
# L the power of two at or above max(E, R), ending part-way through the
# last warp at G = 257): (V, E, R) = rung 4's, the least, the caps, R > E,
# one row a warp with E not a power of two, a narrow buffer under 8 reads
KV_EDGE_G = (257, 65_536)
KV_EDGE_WIDTHS = ((16, 16, 4), (1, 1, 1), (1024, 32, 8), (16, 5, 8), (33, 17, 3),
                  (8, 2, 8))
# the fold at one block, a block and a row, rung 5's width and 512 blocks
# and a row, for k in {1, 8, 16, 33} (33 the kernel's general path)
TELEM_EDGE_G = (1, 257, 100_000, 131_073)


# K1 and K2 at their row slabs' edges: one row, a block and a row, a
# ragged last block, many blocks, at every peer width; K1 with everything
# on, with the hier rule, and with the read plane at S = 4 and (with the
# hier rule) S = 8; K2 with contact tracking and votes, with neither, and
# with the hier rule
STEP_EDGE_G = (1, 257, 300, 4_099)
STEP_EDGE_P = (1, 2, 3, 4, 5, 6, 7, 8, 12)
_ALL_ON = dict(do_tick=True, track_contact=True, has_votes=True)
STEP_EDGE_K1 = ((_ALL_ON, None), (dict(_ALL_ON, has_hier=True), None),
                (dict(_ALL_ON, has_reads=True), 4),
                (dict(_ALL_ON, has_reads=True, has_hier=True), 8))
STEP_EDGE_K2 = (_ALL_ON, dict(do_tick=False, track_contact=False, has_votes=False),
                dict(_ALL_ON, has_hier=True))
# the planes passed as views that start off a 16-byte boundary
STEP_EDGE_PLANES = ("match", "next", "voting", "active", "votes", "near", "read_index",
                    "read_count", "read_acks")


def _misaligned(torch, t):
    """``t`` copied into a contiguous view that starts one element past
    the start of its buffer: one byte past a word boundary for a byte
    plane, off a 16-byte boundary for any."""
    buf = torch.zeros((t.numel() + 1,), dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _step_edges(torch, ts, tk, dev, record):
    """K1 and K2 at STEP_EDGE_G x STEP_EDGE_P over STEP_EDGE_K1 and
    STEP_EDGE_K2, each with its planes aligned and as misaligned views;
    and two K2 launches back to back on one state, on the current stream
    and on a side stream, whose contacted scratch must be all zero after
    each.  Returns the comparisons made."""
    n, streams = 0, set()
    side = torch.cuda.Stream(dev)
    for g in STEP_EDGE_G:
        for p in STEP_EDGE_P:
            for i, (flags, s) in enumerate(STEP_EDGE_K1):
                seed = 110_000 + 10 * g + 100 * p + i
                fields = random_fields(ts, seed, g, p, s)
                inputs = _inputs("quorum_step_dense", seed, g, p, s=s)
                for mis in (False, True):
                    st_k = ts.state_from_numpy(fields, dev)
                    args = _device_args(torch, inputs, dev)
                    if mis:
                        st_k = st_k._replace(**{f: _misaligned(torch, getattr(st_k, f))
                                                for f in STEP_EDGE_PLANES})
                        args = [_misaligned(torch, a) for a in args]
                    kout = tk.quorum_step_dense(st_k, *args, **flags)
                    pout = tk.quorum_step_dense_impl(ts.state_from_numpy(fields, dev), *args,
                                                     **flags)
                    torch.cuda.synchronize()
                    record("quorum_step_dense", flags, _equal_outputs(
                        torch, ts, tk, kout, pout,
                        f"quorum_step_dense G={g} P={p} S={s} misaligned={mis} {flags}"))
                    n += 1
            for i, flags in enumerate(STEP_EDGE_K2):
                seed = 120_000 + 10 * g + 100 * p + i
                fields = random_fields(ts, seed, g, p)
                inputs = sparse_inputs(seed, g, p, max(8, 2 * g))
                for mis in (False, True):
                    st_k = ts.state_from_numpy(fields, dev)
                    if mis:
                        st_k = st_k._replace(**{f: _misaligned(torch, getattr(st_k, f))
                                                for f in STEP_EDGE_PLANES[:6]})
                    args = _device_args(torch, inputs, dev)
                    kout = tk.quorum_step(st_k, *args, **flags)
                    pout = tk.quorum_step_impl(ts.state_from_numpy(fields, dev), *args, **flags)
                    torch.cuda.synchronize()
                    record("quorum_step", flags, _equal_outputs(
                        torch, ts, tk, kout, pout,
                        f"quorum_step G={g} P={p} misaligned={mis} {flags}"))
                    n += 1
            for on_side in (False, True):
                seed = 130_000 + 10 * g + 100 * p + on_side
                fields = random_fields(ts, seed, g, p)
                st_k = ts.state_from_numpy(fields, dev)
                st_p = ts.state_from_numpy(fields, dev)
                for k in range(2):
                    args = _device_args(torch, sparse_inputs(seed + k, g, p, max(8, 2 * g)), dev)
                    if on_side:
                        side.wait_stream(torch.cuda.current_stream(dev))
                        with torch.cuda.stream(side):
                            kout = tk.quorum_step(st_k, *args, **_ALL_ON)
                            stream = side.cuda_stream
                    else:
                        kout = tk.quorum_step(st_k, *args, **_ALL_ON)
                        stream = torch.cuda.current_stream(dev).cuda_stream
                    pout = tk.quorum_step_impl(st_p, *args, **_ALL_ON)
                    st_p = pout.state
                    torch.cuda.synchronize()
                    record("quorum_step", _ALL_ON, _equal_outputs(
                        torch, ts, tk, kout, pout,
                        f"quorum_step G={g} P={p} launch {k} side={on_side}"))
                    key = tk._contact_key(st_k, dev, stream)
                    scratch = tk._CONTACTED.get(key)
                    check(scratch is not None and not bool(scratch.any()),
                          f"quorum_step G={g} P={p} launch {k} side={on_side}: the contacted "
                          "scratch is missing or left off zero")
                    streams.add(key[1])
                    n += 1
    check(side.cuda_stream in streams and len(streams) >= 2,
          "quorum_step: the side stream shares the contacted scratch")
    return n


def phase_edge_kernels(torch, ts, tk, dev, record):
    """K3 over EDGE_K3_FLAGS and the staged loop from random states (R = 9
    with a base wrapping past the int32 maximum, R = 256) at EDGE_SHAPES,
    K3 once more with its vote and echo planes starting mid-word; the
    device state machine and the fold at their edges; K1 and K2 at their
    row slabs' edges (``_step_edges``); each against its plain version."""
    name, n = "quorum_multiround", 0
    for g, p in EDGE_SHAPES:
        for i, flags in enumerate(EDGE_K3_FLAGS):
            seed = 95_000 + 10 * g + i
            s = 3 if flags.get("has_reads") else None
            if flags.get("has_kv"):
                err = _kv_case(torch, ts, tk, dev, name, seed, g, p, flags, KV_DIMS, 4, 64)
            else:
                fields = random_fields(ts, seed, g, p, s)
                inputs = _inputs(name, seed, g, p, k=4, c=64, s=s)
                for mis in (False, True):
                    st_k = ts.state_from_numpy(fields, dev)
                    st_p = ts.state_from_numpy(fields, dev)
                    args = _device_args(torch, inputs, dev)
                    if mis:  # the vote plane and the echo plane
                        args[1] = _misaligned(torch, args[1])
                        if s:
                            args[9] = _misaligned(torch, args[9])
                    kout = tk.quorum_multiround(st_k, *args, **flags)
                    pout = tk.quorum_multiround_impl(st_p, *args, **flags)
                    torch.cuda.synchronize()
                    err = _equal_outputs(torch, ts, tk, kout, pout,
                                         f"{name} G={g} P={p} misaligned={mis} {flags}")
                    record(name, flags, err)
                    n += 1
                continue
            record(name, flags, err)
            n += 1
        for rounds, base in ((9, 2**31 - 4), (LADDER_R, 1)):
            fields = random_fields(ts, 96_000 + g + p, g, p)
            kout, pout = _staged_pair(torch, ts, tk, fields, dev, base, rounds)
            record("staged_multistep", {}, _equal_outputs(
                torch, ts, tk, kout, pout, f"staged_multistep G={g} P={p} R={rounds}"))
            n += 1
    n_kv = 0
    for g in KV_EDGE_G:
        for d, dims in enumerate(KV_EDGE_WIDTHS):
            for name in ("quorum_step_dense", "quorum_multiround"):
                for j, flags in enumerate(_kv_small(name)):
                    seed = 97_000 + g % 1000 + 10 * d + j
                    record(name, flags, _kv_case(torch, ts, tk, dev, name, seed, g, 5, flags,
                                                 dims, 4, 64))
                    n_kv += 1
    n_fold = 0
    for g in TELEM_EDGE_G:
        for k in (1, 8, 16, 33):
            fields = telem_fields(ts, 98_000 + g % 1000 + k, g, 5)
            for reads in (False, True):
                record("telem_fold", {}, _compare_telem(
                    torch, ts, tk, fields, dev, k, reads, reads,
                    f"telem_fold G={g} k={k} sweeps={reads}", folds=2))
                n_fold += 2
    side = torch.cuda.Stream(dev)
    record("telem_fold", {}, _compare_telem(
        torch, ts, tk, telem_fields(ts, 99_000, 100_000, 5), dev, 8, False, False,
        "telem_fold on a side stream", folds=2, stream=side))
    n_fold += 2
    tickets = [t for (d, _), t in tk._TICKETS.items() if d == str(dev)]
    check(len(tickets) >= 2 and all(int(t.item()) == 0 for t in tickets),
          "telem_fold: the side stream shares a ticket, or a ticket is left off 0")
    n_steps = _step_edges(torch, ts, tk, dev, record)
    emit({"phase": "edges_vs_plain", "compared": n, "shapes": EDGE_SHAPES,
          "kv_compared": n_kv, "kv_shapes": {"G": KV_EDGE_G, "VER": KV_EDGE_WIDTHS},
          "folds_compared": n_fold, "fold_G": TELEM_EDGE_G, "tickets": len(tickets),
          "steps_compared": n_steps, "steps_shapes": {"G": STEP_EDGE_G, "P": STEP_EDGE_P}})
    return n + n_kv + n_fold + n_steps


def phase_kernels(torch, ts, tk, dev, ladder_mod, g=100_000, p=5):
    compared = 0
    max_err = dict.fromkeys(TPU_KERNELS, 0)

    def record(name, flags, err):
        nonlocal compared
        max_err[name] = max(max_err[name], err)
        if flags.get("has_hier"):
            max_err["finish_hier"] = max(max_err["finish_hier"], err)
        if flags.get("has_telem"):
            max_err["telem_fold"] = max(max_err["telem_fold"], err)
        if flags.get("has_reads") or flags.get("purge_reads"):
            max_err["read_plane"] = max(max_err["read_plane"], err)
        if flags.get("has_kv") or flags.get("purge_kv"):
            max_err["kv_plane"] = max(max_err["kv_plane"], err)
        compared += 1

    for name in STEP_KERNELS:
        grid = _flag_grid(name)
        grid += [_hier_telem(f, name, telem=False) for f in grid]
        grid.append(_hier_telem(MAIN_VARIANT[name], name))
        for i, flags in enumerate(grid):
            seed = 10_000 + 100 * STEP_KERNELS.index(name) + i
            fields = random_fields(ts, seed, g, p)
            kout, pout = _run_pair(torch, ts, tk, name, fields,
                                   _inputs(name, seed, g, p), flags, dev)
            record(name, flags, _equal_outputs(torch, ts, tk, kout, pout,
                                               f"{name} {flags}"))
    for width in (1, 2, 3, 4, 5, 6, 7, 8, 12):
        for name in STEP_KERNELS:
            all_on = dict(_flag_grid(name)[0], do_tick=True, has_votes=True,
                          track_contact=True)
            if name == "quorum_multiround":
                all_on["has_churn"] = True
            base = _flag_grid(name)[0]
            for flags in (all_on, base, _hier_telem(all_on, name),
                          _hier_telem(base, name, telem=False)):
                seed = 20_000 + width
                fields = random_fields(ts, seed, 4096, width)
                kout, pout = _run_pair(
                    torch, ts, tk, name, fields,
                    _inputs(name, seed, 4096, width, k=4, c=64, cap=1024),
                    flags, dev)
                record(name, flags, _equal_outputs(
                    torch, ts, tk, kout, pout, f"{name} P={width} {flags}"))
    # the READS instances of K1 and K3 at the rung-4 width, then at 4,096
    # groups for every peer width and S in {4, 8}
    n_reads = 0
    for name in ("quorum_step_dense", "quorum_multiround"):
        for i, flags in enumerate(_reads_grid(name)):
            seed = 50_000 + 100 * STEP_KERNELS.index(name) + i
            kout, pout = _run_pair(torch, ts, tk, name, random_fields(ts, seed, READS_G, p, 4),
                                   _inputs(name, seed, READS_G, p, s=4), flags, dev)
            record(name, flags, _equal_outputs(torch, ts, tk, kout, pout, f"{name} {flags}"))
            n_reads += 1
        for width in (1, 2, 3, 4, 5, 6, 7, 8, 12):
            for slots in (4, 8):
                for j, flags in enumerate(_reads_small(name)):
                    seed = 60_000 + 100 * width + 10 * slots + j
                    kout, pout = _run_pair(
                        torch, ts, tk, name, random_fields(ts, seed, 4096, width, slots),
                        _inputs(name, seed, 4096, width, k=4, c=64, s=slots), flags, dev)
                    record(name, flags, _equal_outputs(
                        torch, ts, tk, kout, pout, f"{name} P={width} S={slots} {flags}"))
                    n_reads += 1
    emit({"phase": "reads_vs_plain", "compared": n_reads,
          "max_abs_err": max_err["read_plane"]})
    # the device state machine after K1 and K3 at rung 4's width, then at
    # 4,096 groups for every peer width and (V, E, R) in KV_SMALL_DIMS
    n_kv = 0
    for name in ("quorum_step_dense", "quorum_multiround"):
        for i, flags in enumerate(_kv_grid(name)):
            seed = 70_000 + 100 * STEP_KERNELS.index(name) + i
            record(name, flags, _kv_case(torch, ts, tk, dev, name, seed, KV_G, p, flags,
                                         KV_DIMS, KV_K, 2048))
            n_kv += 1
        for width in (1, 2, 3, 4, 5, 6, 7, 8, 12):
            for d, dims in enumerate(KV_SMALL_DIMS):
                for j, flags in enumerate(_kv_small(name)):
                    seed = 80_000 + 100 * width + 10 * d + j
                    record(name, flags, _kv_case(torch, ts, tk, dev, name, seed, 4096, width,
                                                 flags, dims, 4, 64))
                    n_kv += 1
    emit({"phase": "kv_vs_plain", "compared": n_kv, "max_abs_err": max_err["kv_plane"]})
    telem_cases = [(g, k, reads, kv) for k in (1, 8, 16)
                   for reads in (False, True) for kv in (False, True)]
    telem_cases += [(5, 8, True, True), (5, 1, False, False), (1, 8, True, False)]
    for i, (tg, k, reads, kv) in enumerate(telem_cases):
        fields = telem_fields(ts, 40_000 + i, tg, p)
        record("telem_fold", {}, _compare_telem(
            torch, ts, tk, fields, dev, k, reads, kv,
            f"telem_fold G={tg} k={k} reads={reads} kv={kv}"))
    phase_edge_kernels(torch, ts, tk, dev, record)
    emit({"phase": "kernels_vs_plain", "compared": compared, "max_abs_err": max_err})

    timings = {}
    for name, flags in MAIN_VARIANT.items():
        timings[name], err = _time_step(torch, ts, tk, dev, name, flags, g, p)
        record(name, flags, err)
        timings[name]["max_abs_err"] = max_err[name]
        emit({"phase": "kernel_time", "name": name, **timings[name]})
    for name in ("quorum_step_dense", "quorum_step"):
        flags = dict(MAIN_VARIANT[name], has_hier=True)
        t, err = _time_step(torch, ts, tk, dev, name, flags, g, p)
        record(name, flags, err)
        emit({"phase": "kernel_time", "name": f"{name}[hier]", **t})
    timings["finish_hier"], err = _time_step(
        torch, ts, tk, dev, "quorum_multiround", HIER_VARIANT, g, p)
    record("quorum_multiround", HIER_VARIANT, err)
    timings["finish_hier"]["max_abs_err"] = max_err["finish_hier"]
    emit({"phase": "kernel_time", "name": "quorum_multiround[hier]",
          **timings["finish_hier"]})
    for name, flags in READS_VARIANT.items():
        t, err = _time_step(torch, ts, tk, dev, name, flags, READS_G, p,
                            seed=32_000, k=READS_K, s=4)
        record(name, flags, err)
        emit({"phase": "kernel_time", "name": f"{name}[reads]", **t})
        if name == "quorum_multiround":
            timings["read_plane"] = t
    timings["kv_plane"], err = _time_kv(torch, ts, tk, dev)
    record("kv_plane", {"has_kv": True}, err)
    emit({"phase": "kernel_time", "name": "kv_plane", **timings["kv_plane"]})
    emit({"phase": "kernel_time", "name": "quorum_multiround[trace]",
          **_time_trace(torch, ts, tk, dev)})
    for reads, kv in ((False, False), (True, True)):
        t, err = _time_telem(torch, ts, tk, dev, g, p, TELEM_VARIANT["k"], reads, kv)
        record("telem_fold", {}, err)
        emit({"phase": "kernel_time", "name": "telem_fold", **t})
        if not reads:
            timings["telem_fold"] = t
    n_ms, ms_timings = phase_multistep_kernels(torch, ts, tk, dev, ladder_mod, record)
    timings.update(ms_timings)
    for name in timings:
        timings[name]["max_abs_err"] = max_err[name]
    emit({"phase": "kernels_checked", "compared": compared, "multistep_compared": n_ms,
          "max_abs_err": max_err})
    return timings


# ----------------------------------------------------------------------
# phase 3: the rung-5 drive
# ----------------------------------------------------------------------


def timed_engine(torch, engine_mod, split):
    """The engine class of the rung-5 drives, timing each fused dispatch's
    parts into ``split``."""

    class TimedEngine(engine_mod.BatchedQuorumEngine):
        """Records the host staging time and the device time of the
        upload, the launch and the egress copy of every fused dispatch."""

        def _stage_multiround(self, blocks, tick_mask):
            t0 = time.perf_counter()
            out = super()._stage_multiround(blocks, tick_mask)
            split["stage_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        def _timed(self, key, fn):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn()
            e.record()
            self._events.append((key, s, e))
            return out

        def _upload(self, tensors):
            tensors = tuple(tensors)
            if "h2d_bytes" in split:
                split["h2d_bytes"].append(sum(t.nbytes for t in tensors))
            return self._timed("h2d_ms", lambda: super(TimedEngine, self)._upload(tensors))

        def _launch_multiround(self, args, *a):
            return self._timed(
                "kernel_ms", lambda: super(TimedEngine, self)._launch_multiround(args, *a))

        def _enqueue_egress(self, out):
            return self._timed(
                "d2h_ms", lambda: super(TimedEngine, self)._enqueue_egress(out))

    return TimedEngine


def phase_rung5(torch, engine_mod, tk, dev, n_groups=100_000, k=8,
                churn_block=2048, dispatches=8, label="rung5"):
    split = {"stage_ms": [], "h2d_ms": [], "kernel_ms": [], "d2h_ms": []}
    TimedEngine = timed_engine(torch, engine_mod, split)
    eng = TimedEngine(n_groups, 5, event_cap=4 * n_groups, device_ticks=False, device=dev)
    eng._events = []
    for cid in range(1, n_groups + 1):
        eng.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    eng._upload_dirty()
    rows = np.arange(n_groups, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), n_groups)
    rel = np.full(n_groups, 1, np.int64)
    live = np.arange(1, n_groups + 1, dtype=np.int64)
    st = {"next_cid": n_groups + 1, "churn_at": 0, "recycled": 0}

    def stage_block():
        for _ in range(k):
            lo = st["churn_at"] % n_groups
            for i in range(lo, min(lo + churn_block, n_groups)):
                eng.stage_recycle(int(live[i]), st["next_cid"], term=1,
                                  term_start=1, last_index=1)
                live[i] = st["next_cid"]
                st["next_cid"] += 1
                rel[i] = 1
                st["recycled"] += 1
            st["churn_at"] += churn_block
            rel[:] += 1
            eng.ack_block(rows3, slots, np.concatenate([rel, rel, rel]).astype(np.int32))
            eng.begin_round()

    stage_block()  # warm-up block
    first = eng.step_rounds(do_tick=False)
    check(np.array_equal(first.committed_rel, rel), "rung5 warm-up watermarks differ")
    for key in split:
        split[key].clear()
    eng._events.clear()
    st["recycled"] = 0
    launches0 = tk.launch_counts()
    stage_ms, disp_ms, checked = [], [], 0
    prev_rel = None
    t_start = time.perf_counter()
    for _ in range(dispatches):
        t0 = time.perf_counter()
        stage_block()
        t1 = time.perf_counter()
        res = eng.step_rounds(do_tick=False, pipelined=True)
        t2 = time.perf_counter()
        stage_ms.append((t1 - t0) * 1e3)
        disp_ms.append((t2 - t0) * 1e3)
        if res is not None:
            check(np.array_equal(res.committed_rel, prev_rel),
                  "rung5: a pipelined block's watermarks differ from the expectation")
            checked += 1
        prev_rel = rel.copy()
    final = eng.harvest()
    elapsed = time.perf_counter() - t_start
    check(np.array_equal(final.committed_rel, rel), "rung5: final watermarks differ")
    checked += 1
    torch.cuda.synchronize()
    for key, s, e in eng._events:
        split[key].append(s.elapsed_time(e))
    out = {
        "phase": label,
        "groups": n_groups, "peer_slots": 5, "rounds_per_dispatch": k,
        "dispatches": dispatches, "recycled_groups": st["recycled"],
        "blocks_checked_all_rows": checked,
        "writes_per_sec": n_groups * k * dispatches / elapsed,
        "dispatch_ms_p50": float(np.percentile(disp_ms, 50)),
        "dispatch_ms_p99": float(np.percentile(disp_ms, 99)),
        "stage_block_ms_p50": float(np.percentile(stage_ms, 50)),
        "host_staging_ms_p50": float(np.percentile(split["stage_ms"], 50)),
        "h2d_ms_p50": float(np.percentile(split["h2d_ms"], 50)),
        "kernel_ms_p50": float(np.percentile(split["kernel_ms"], 50)),
        "d2h_ms_p50": float(np.percentile(split["d2h_ms"], 50)),
        "h2d_bytes": int(k * n_groups * 5 * 4 + 4 * k * churn_block * 4 + k + 1),
        "launches_per_block": {
            name: (n - launches0[name]) / dispatches
            for name, n in tk.launch_counts().items()
        },
    }
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 5: rung 5 with the hier commit rule and the telemetry fold
# ----------------------------------------------------------------------


def numpy_fold(live, node_state, last_index, committed, prev, row_cid, k,
               read_count, kv_ent_index):
    """The telemetry aggregate of a state, in plain numpy (the snapshot's
    keys except seq, mono and rounds)."""
    last = last_index.astype(np.int64)
    comm = committed.astype(np.int64)
    lag = np.where(live, np.maximum(last - comm, 0), 0)
    bucket = np.searchsorted([1 << i for i in range(15)], lag, side="right")
    ns = node_state.astype(np.int64)
    masked = np.where(live, lag, -1)
    order = np.lexsort((np.arange(masked.size), -masked))[:k]
    return {
        "groups": int(live.sum()),
        "lag_hist": np.bincount(bucket[live], minlength=16).tolist(),
        "state_counts": [int(((ns == s) & live).sum()) for s in range(5)],
        "stalled": int((live & (comm == prev) & (lag > 0)).sum()),
        "read_slots": int((read_count > 0).sum()),
        "kv_ents": int((kv_ent_index >= 0).sum()),
        "topk": [(int(row_cid[r]), int(masked[r])) for r in order
                 if masked[r] >= 0 and row_cid[r] >= 0],
    }


def same_snapshot(a, b):
    """Two telemetry snapshots (or a snapshot and a numpy fold, which
    lacks seq, mono and rounds) agree on every key they share but seq
    and mono."""
    if a is None or b is None:
        return a is b
    keys = (set(a) - {"seq", "mono"}) & set(b)
    return all([tuple(x) for x in a[key]] == [tuple(x) for x in b[key]]
               if key == "topk" else a[key] == b[key] for key in keys)


class HierRung5Model:
    """Numpy expectation of the hier rung-5 drive: every row leads 5
    voters with near slots {0,1,2} and sub-quorum 2; the commit candidate
    is max(3rd largest match, 2nd largest near match).  Three of five
    slots ack each round, by row class: (0,1,2) all at the tenant's next
    index; (0,1,3) with slot 3 one behind, where the near rule closes
    ahead of the classic one; (0,3,4) with the leader's own slot up to 6
    ahead, where the near rule is behind.  Every 97th row's followers
    re-send index 1, so its watermark stalls while its lag grows."""

    def __init__(self, n):
        self.rows = np.arange(n, dtype=np.int64)
        self.cls = self.rows % 3
        self.frozen = self.rows % 97 == 5
        self.slots = np.array([[0, 1, 2], [0, 1, 3], [0, 3, 4]])[self.cls].T
        self.match = np.zeros((n, 5), np.int64)
        self.match[:, 0] = 1
        self.last = np.ones(n, np.int64)
        self.committed = np.zeros(n, np.int64)
        self._ahead = np.where(self.cls == 2, self.rows % 7, 0)
        self._behind = (self.cls == 1).astype(np.int64)
        self._frozen_rows = np.nonzero(self.frozen)[0]

    def values(self, rel, out=None):
        """The (3, G) ack values of a round, into ``out`` if given (the
        drive fills one int32 buffer per round, as plain rung 5 does)."""
        v = np.empty((3, rel.size), np.int64) if out is None else out
        np.add(rel, self._ahead, out=v[0], casting="unsafe")
        v[1] = rel
        np.subtract(rel, self._behind, out=v[2], casting="unsafe")
        v[1:, self._frozen_rows] = 1
        return v

    def round(self, recycled, v):
        self.match[recycled] = 0
        self.match[recycled, 0] = 1
        self.committed[recycled] = 0
        self.last[recycled] = 1
        for j in range(3):
            cell = (self.rows, self.slots[j])
            self.match[cell] = np.maximum(self.match[cell], v[j])
        self.last = np.maximum(self.last, self.match[:, 0])
        classic = -np.sort(-self.match, axis=1)[:, 2]
        near = -np.sort(-self.match[:, :3], axis=1)[:, 1]
        q = np.maximum(classic, near)
        adv = (q > self.committed) & (q >= 1)
        self.committed[adv] = q[adv]


def phase_rung5_hier_telem(torch, engine_mod, tk, ts, dev, plain, n_groups=100_000,
                           k=8, churn_block=2048, dispatches=8):
    split = {"stage_ms": [], "h2d_ms": [], "kernel_ms": [], "d2h_ms": []}
    TimedEngine = timed_engine(torch, engine_mod, split)
    eng = TimedEngine(n_groups, 5, event_cap=4 * n_groups, device_ticks=False, device=dev)
    eng._events = []
    eng.enable_telem()
    for cid in range(1, n_groups + 1):
        eng.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        eng.set_hier(cid, [1, 2, 3], 2)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    eng._upload_dirty()
    model = HierRung5Model(n_groups)
    rows3 = np.concatenate([model.rows] * 3).astype(np.int32)
    slots3 = model.slots.reshape(-1).astype(np.int32)
    rel = np.ones(n_groups, np.int64)
    live = np.arange(1, n_groups + 1, dtype=np.int64)
    st = {"next_cid": n_groups + 1, "churn_at": 0, "recycled": 0}
    blocks = []  # per block: [(recycled rows, rel)] and its row_cid
    vbuf = np.empty((3, n_groups), np.int32)

    def stage_block():
        rounds = []
        for _ in range(k):
            lo = st["churn_at"] % n_groups
            hi = min(lo + churn_block, n_groups)
            for i in range(lo, hi):
                eng.stage_recycle(int(live[i]), st["next_cid"], term=1,
                                  term_start=1, last_index=1)
                live[i] = st["next_cid"]
                st["next_cid"] += 1
                rel[i] = 1
                st["recycled"] += 1
            st["churn_at"] += churn_block
            rel[:] += 1
            eng.ack_block(rows3, slots3, model.values(rel, vbuf).reshape(-1))
            eng.begin_round()
            rounds.append((np.arange(lo, hi), rel.copy()))
        blocks.append((rounds, eng.row_cids()))

    fold_events = []
    orig_fold = tk._telem_launch

    def timed_fold(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig_fold(*a, **kw)
        e.record()
        fold_events.append((s, e))
        return out

    results, snaps, snap_ms = {}, {}, []

    def take(res, block):
        results[block] = res.committed_rel
        t0 = time.perf_counter()
        snaps[block] = eng.telem_snapshot()
        snap_ms.append((time.perf_counter() - t0) * 1e3)

    tk._telem_launch = timed_fold
    try:
        stage_block()  # warm-up block
        take(eng.step_rounds(do_tick=False), 0)
        for key in split:
            split[key].clear()
        eng._events.clear()
        fold_events.clear()
        snap_ms.clear()
        st["recycled"] = 0
        stage_ms, disp_ms = [], []
        t_start = time.perf_counter()
        for b in range(1, dispatches + 1):
            t0 = time.perf_counter()
            stage_block()
            t1 = time.perf_counter()
            res = eng.step_rounds(do_tick=False, pipelined=True)
            t2 = time.perf_counter()
            stage_ms.append((t1 - t0) * 1e3)
            disp_ms.append((t2 - t0) * 1e3)
            if res is not None:
                take(res, b - 1)
        take(eng.harvest(), dispatches)
        elapsed = time.perf_counter() - t_start
    finally:
        tk._telem_launch = orig_fold
    torch.cuda.synchronize()
    for key, s, e in eng._events:
        split[key].append(s.elapsed_time(e))
    fold_ms = [s.elapsed_time(e) for s, e in fold_events]

    # the expectation, block by block, against every harvested watermark
    # and every snapshot
    check(sorted(results) == list(range(dispatches + 1)), "rung5_hier: a block's egress is missing")
    checked = 0
    zeros = np.zeros(n_groups, bool)
    for b, (rounds, row_cid) in enumerate(blocks):
        prev = model.committed.copy()
        for recycled, rel_r in rounds:
            prev[recycled] = 0
            model.round(recycled, model.values(rel_r))
        check(np.array_equal(results[b], model.committed),
              f"rung5_hier: block {b}'s watermarks differ from the expectation")
        checked += 1
        expect = numpy_fold(~zeros, np.full(n_groups, 2, np.int8), model.last,
                            model.committed, prev, row_cid, eng.n_telem_topk,
                            np.zeros(1), np.full(1, -1))
        check(snaps[b] is not None and snaps[b]["rounds"] == k
              and same_snapshot(snaps[b], expect),
              f"rung5_hier: block {b}'s telemetry snapshot differs: {snaps[b]} vs {expect}")
    classic = -np.sort(-model.match, axis=1)[:, 2]
    near_ahead = int((model.committed > classic).sum())
    check(near_ahead > 0, "rung5_hier: the near rule never closed ahead of the classic one")
    # the last fold against a numpy fold of the state the card holds
    f = ts.state_to_numpy(eng.dev)
    check(np.array_equal(f["committed"], model.committed), "rung5_hier: final state differs")
    check(np.array_equal(f["telem_prev_committed"], f["committed"]),
          "rung5_hier: the fold did not advance its watermark")
    final = numpy_fold(f["live"], f["node_state"], f["last_index"], f["committed"],
                       prev, eng.row_cids(), eng.n_telem_topk, f["read_count"],
                       f["kv_ent_index"])
    check(same_snapshot(snaps[dispatches], final),
          "rung5_hier: the last snapshot differs from the numpy fold of the final state")
    check(len(fold_ms) == dispatches, f"rung5_hier: {len(fold_ms)} fold launches timed")
    out = {
        "phase": "rung5_hier_telem",
        "groups": n_groups, "peer_slots": 5, "rounds_per_dispatch": k,
        "dispatches": dispatches, "recycled_groups": st["recycled"],
        "blocks_checked_all_rows": checked, "snapshots_checked": checked,
        "rows_near_ahead_of_classic": near_ahead,
        "stalled_last_fold": final["stalled"], "topk_last_fold": final["topk"][:3],
        "writes_per_sec": n_groups * k * dispatches / elapsed,
        "dispatch_ms_p50": float(np.percentile(disp_ms, 50)),
        "dispatch_ms_p99": float(np.percentile(disp_ms, 99)),
        "stage_block_ms_p50": float(np.percentile(stage_ms, 50)),
        "host_staging_ms_p50": float(np.percentile(split["stage_ms"], 50)),
        "h2d_ms_p50": float(np.percentile(split["h2d_ms"], 50)),
        "kernel_and_fold_ms_p50": float(np.percentile(split["kernel_ms"], 50)),
        "fold_ms_p50": float(np.percentile(fold_ms, 50)),
        "d2h_ms_p50": float(np.percentile(split["d2h_ms"], 50)),
        "snapshot_host_ms_p50": float(np.percentile(snap_ms, 50)),
        "snapshot_host_ms_max": float(np.max(snap_ms)),
        "plain_rung5_same_run": plain and {key: plain[key] for key in (
            "writes_per_sec", "dispatch_ms_p50", "dispatch_ms_p99",
            "kernel_ms_p50", "d2h_ms_p50")},
    }
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 4: ticks, elections and both single-round paths, cuda == cpu
# ----------------------------------------------------------------------


class Lockstep:
    """An engine on the card and one on the CPU, fed the same calls."""

    def __init__(self, engine_mod, dev, n, **kw):
        Engine = engine_mod.BatchedQuorumEngine
        self.c = Engine(n, 5, device=dev, **kw)
        self.h = Engine(n, 5, device="cpu", **kw)

    def __getattr__(self, name):
        def both(*args, **kwargs):
            b = getattr(self.h, name)(*args, **kwargs)
            a = getattr(self.c, name)(*args, **kwargs)
            return a, b
        return both

    def compare(self, ra, rb, tag):
        check((ra is None) == (rb is None), f"{tag}: egress presence differs")
        if ra is not None:
            check(ra.commit == rb.commit, f"{tag}: commit egress differs")
            for name in ("won", "lost", "elect", "heartbeat", "demote"):
                check(sorted(getattr(ra, name)) == sorted(getattr(rb, name)),
                      f"{tag}: {name} differs")
        check(self.c.committed_snapshot() == self.h.committed_snapshot(),
              f"{tag}: committed_snapshot differs")


def _op_script(torch, engine_mod, dev, mode, n=65_536, rounds=8, hier_telem=False):
    """Returns the number of steps compared and how often each flag fired.
    ``hier_telem`` turns the hier rule on for every third group and the
    telemetry fold on, and compares the snapshots after every step."""
    dense = {"sparse": False, "dense": True, "fused": "auto"}[mode]
    pair = Lockstep(engine_mod, dev, n, dense_ingest=dense, device_ticks=True)
    if hier_telem:
        pair.enable_telem()
    rng = np.random.default_rng(41)
    leaders = set()
    term = {}
    last = {}
    for cid in range(1, n + 1):
        follower = cid % 8 == 0
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1,
                       election_timeout=5 if cid % 16 == 1 else 1000,
                       rand_timeout=int(4 + cid % 37) if follower else 2000,
                       check_quorum=cid % 16 == 1)
        if hier_telem and cid % 3 == 0:
            pair.set_hier(cid, [1, 2, 3], 2)
        term[cid] = 1
        last[cid] = 1
        if not follower:
            pair.set_leader(cid, term=1, term_start=1, last_index=1)
            leaders.add(cid)
    cids = np.arange(1, n + 1)
    rows_of = {cid: pair.h.groups[cid].row for cid in cids.tolist()}
    next_cid = n + 1
    steps = 0
    frac = 0.03 if mode == "sparse" else 1.0
    seen = dict.fromkeys(("won", "lost", "elect", "heartbeat", "demote"), 0)
    for rnd in range(rounds):
        # bulk acks: leaders append one entry; self + 1 or 2 followers ack
        lead = np.array(sorted(leaders), np.int64)
        lead = lead[rng.random(lead.size) < frac]
        for cid in lead.tolist():
            last[cid] += 1
        lrows = np.array([rows_of[c] for c in lead.tolist()], np.int64)
        lasts = np.array([last[c] for c in lead.tolist()], np.int64)
        nf = rng.integers(1, 3, lead.size)
        r_rows = [lrows, lrows, lrows[nf == 2]]
        r_slots = [np.zeros(lead.size, np.int64), np.ones(lead.size, np.int64),
                   np.full(int((nf == 2).sum()), 2, np.int64)]
        r_rels = [lasts, lasts - rng.integers(0, 2, lead.size), lasts[nf == 2]]
        pair.ack_block(np.concatenate(r_rows), np.concatenate(r_slots),
                       np.concatenate(r_rels))
        for cid in lead[:64].tolist():
            pair.heartbeat_resp(cid, 4)
        for cid in range(8, 8 * 40, 8):
            if cid not in leaders and cid in rows_of:
                pair.leader_contact(cid)
        if rnd == 2:  # rebase some leaders
            some = sorted(leaders)[:100]
            pair.sync_rows([rows_of[c] for c in some])
            for cid in some:
                pair.rebase(cid)
        if rnd == 4:  # row reuse
            gone = sorted(leaders)[100:164]
            for cid in gone:
                pair.remove_group(cid)
                leaders.discard(cid)
                del rows_of[cid]
            for _ in gone:
                pair.add_group(next_cid, node_ids=[1, 2, 3], self_id=1)
                pair.set_leader(next_cid, term=1, term_start=1, last_index=1)
                rows_of[next_cid] = pair.h.groups[next_cid].row
                term[next_cid] = last[next_cid] = 1
                leaders.add(next_cid)
                next_cid += 1
        if mode == "fused":
            if rnd % 2 == 1:  # an in-program recycle mid-block
                old = sorted(leaders)[200 + rnd]
                pair.stage_recycle(old, next_cid, term=3, term_start=1, last_index=1)
                rows_of[next_cid] = rows_of.pop(old)
                leaders.discard(old)
                leaders.add(next_cid)
                term[next_cid] = 3
                last[next_cid] = 1
                next_cid += 1
            pair.begin_round()
            pair.begin_round()  # an event-free ticking round
            ra, rb = pair.step_rounds(do_tick=True, pad_rounds_to=4)
        else:
            ra, rb = pair.step(do_tick=True)
        pair.compare(ra, rb, f"{mode} round {rnd}")
        if hier_telem:
            sc, sh = pair.c.telem_snapshot(), pair.h.telem_snapshot()
            check(sh is not None and same_snapshot(sc, sh),
                  f"{mode} round {rnd}: telemetry snapshots differ: {sc} vs {sh}")
        steps += 1
        for name in seen:
            seen[name] += len(getattr(rb, name))
        # host follow-ups: elections, wins, losses, demotions
        elect = [c for c in sorted(rb.elect) if c not in leaders][:400]
        pair.sync_rows([rows_of[c] for c in elect])
        for cid in elect:
            term[cid] += 1
            pair.set_candidate(cid, term=term[cid])
            for nid in (1, 2, 3, 4, 5):
                grant = nid == 1 or bool(rng.random() < 0.55)
                pair.vote(cid, nid, grant)
                if rng.random() < 0.2:
                    pair.vote(cid, nid, not grant)
        if rb.won or rb.lost:
            pair.sync_rows([rows_of[c] for c in rb.won + rb.lost])
        for cid in sorted(rb.won):
            pair.set_leader(cid, term=term[cid], term_start=last[cid] + 1,
                            last_index=last[cid] + 1)
            last[cid] += 1
            leaders.add(cid)
        for cid in sorted(rb.lost):
            pair.set_follower(cid, term=term[cid])
        for cid in sorted(rb.demote)[:50]:
            pair.set_follower(cid, term=term[cid])
            leaders.discard(cid)
    # the rare path and the device must agree on every state field
    for name in pair.c.dev._fields:
        a = getattr(pair.c.dev, name).cpu()
        b = getattr(pair.h.dev, name)
        check(torch.equal(a, b), f"{mode}: final state field {name} differs")
    check(seen["elect"] and seen["won"] and seen["demote"],
          f"{mode}: the script fired too few flags: {seen}")
    return steps, seen


def phase_ops(torch, engine_mod, dev, hier_telem=False):
    out = {"phase": "op_script_hier_telem" if hier_telem else "op_script",
           "groups": 65_536, "peer_slots": 5}
    for mode in ("sparse", "dense", "fused"):
        t0 = time.perf_counter()
        out[f"{mode}_steps_equal"], out[f"{mode}_flags"] = _op_script(
            torch, engine_mod, dev, mode, hier_telem=hier_telem)
        out[f"{mode}_seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 7: rung 4, a pure-write window and the mixed 9:1 read phase
# ----------------------------------------------------------------------


def _p(values, q):
    return float(np.percentile(values, q))


def phase_rung4(torch, engine_mod, tk, ts, dev, n_groups=65_536, k=16, dispatches=8):
    split = {"stage_ms": [], "h2d_ms": [], "kernel_ms": [], "d2h_ms": []}
    TimedEngine = timed_engine(torch, engine_mod, split)
    eng = TimedEngine(n_groups, 5, event_cap=4 * n_groups, device_ticks=False, device=dev)
    eng._events = []
    for cid in range(1, n_groups + 1):
        eng.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    eng._upload_dirty()
    rows = np.arange(n_groups, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), n_groups)
    row_cid = eng.row_cids()

    def stage_writes(start):
        eng.ack_block_rounds(rows3, slots, start + np.arange(k, dtype=np.int32)[:, None]
                             + np.zeros((1, rows3.size), np.int32))

    # the pure-write window, after a warm-up block
    stage_writes(2)
    check(np.all(eng.step_rounds(do_tick=False).committed_rel == k + 1),
          "rung4: warm-up watermarks differ")
    rel, expect_prev, checked, disp_ms = k + 1, None, 0, []
    t0 = time.perf_counter()
    for _ in range(dispatches):
        td = time.perf_counter()
        stage_writes(rel + 1)
        res = eng.step_rounds(do_tick=False, pipelined=True)
        disp_ms.append((time.perf_counter() - td) * 1e3)
        if res is not None:
            check(np.all(res.committed_rel == expect_prev), "rung4: a write block's watermarks differ")
            checked += 1
        expect_prev = rel + k
        rel += k
    final = eng.harvest()
    elapsed = time.perf_counter() - t0
    check(np.all(final.committed_rel == rel) and eng.committed_index(1) == rel,
          "rung4: the write window's final watermarks differ")
    write = {"writes_per_sec": n_groups * k * dispatches / elapsed,
             "dispatch_ms_p50": _p(disp_ms, 50), "dispatch_ms_p99": _p(disp_ms, 99),
             "blocks_checked_all_rows": checked + 1}

    # the mixed phase: per round one write, a batch of 9 reads and two
    # follower echoes a group; the slot each batch rode is kept to build
    # the expectation after the run
    rows2 = np.concatenate([rows, rows])
    peers2 = np.repeat(np.array([1, 2], np.int32), n_groups)
    counts9 = np.full(n_groups, 9, np.int32)
    blocks = []  # per block: [(rel, slots)], one entry a round
    calls = {name: [] for name in ("ack_block", "stage_read_block", "read_ack_block",
                                   "begin_round", "step_rounds")}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        calls[name][-1] += (time.perf_counter() - t) * 1e3
        return out

    def mixed_dispatch():
        nonlocal rel
        for name in calls:
            calls[name].append(0.0)
        rounds = []
        for _ in range(k):
            rel += 1
            timed("ack_block", eng.ack_block, rows3, slots, np.full(rows3.size, rel, np.int32))
            sl = timed("stage_read_block", eng.stage_read_block, rows,
                       np.full(n_groups, rel, np.int32), counts9)
            timed("read_ack_block", eng.read_ack_block, rows2, np.concatenate([sl, sl]), peers2)
            timed("begin_round", eng.begin_round)
            rounds.append((rel, sl))
        blocks.append(rounds)
        return timed("step_rounds", eng.step_rounds, do_tick=False, pipelined=True)

    results = {}
    mixed_dispatch()  # warm-up block
    results[0] = eng.harvest()
    for key in split:
        split[key].clear()
    for key in calls:
        calls[key].clear()
    eng._events.clear()
    launches0 = tk.launch_counts()
    mtimes = []
    t0 = time.perf_counter()
    for b in range(1, dispatches + 1):
        td = time.perf_counter()
        res = mixed_dispatch()
        mtimes.append((time.perf_counter() - td) * 1e3)
        if res is not None:
            results[b - 1] = res
    results[dispatches] = eng.harvest()
    melapsed = time.perf_counter() - t0
    launches = {name: (n - launches0[name]) / dispatches
                for name, n in tk.launch_counts().items()}
    torch.cuda.synchronize()
    for key, s0, e0 in eng._events:
        split[key].append(s0.elapsed_time(e0))

    # every block's watermarks and read egress, then the final read state
    s = eng.n_read_slots
    last_idx = np.zeros((n_groups, s), np.int64)
    confirmed = 0
    check(sorted(results) == list(range(dispatches + 1)), "rung4: a mixed block's egress is missing")
    for b, rounds in enumerate(blocks):
        cnt = np.zeros((n_groups, s), np.int64)
        idx = np.full((n_groups, s), -1, np.int64)
        for r_rel, sl in rounds:
            cnt[rows, sl] += 9
            idx[rows, sl] = r_rel
            last_idx[rows, sl] = r_rel
        res = results[b]
        check(np.all(res.committed_rel == rounds[-1][0]), f"rung4: mixed block {b}'s watermarks differ")
        er, es = np.nonzero(cnt)
        check(res.read_cids is not None
              and np.array_equal(res.read_cids, row_cid[er])
              and np.array_equal(res.read_slots, es)
              and np.array_equal(res.read_index_abs, idx[er, es])
              and np.array_equal(res.read_counts, cnt[er, es]),
              f"rung4: mixed block {b}'s read egress differs from the expectation")
        if b > 0:
            confirmed += int(res.read_counts.sum())
    expected = n_groups * 9 * k * dispatches
    check(confirmed == expected, f"rung4: {confirmed} reads confirmed, expected {expected}")
    check(eng.committed_index(1) == rel, "rung4: committed_index(1) is not the last staged index")
    f = ts.state_to_numpy(eng.dev)
    check(np.all(f["committed"] == rel), "rung4: final watermarks differ")
    check(not f["read_count"].any() and not f["read_acks"].any(),
          "rung4: read slots left pending")
    check(np.array_equal(f["read_index"], last_idx), "rung4: final read_index differs")
    out = {
        "phase": "rung4",
        "groups": n_groups, "peer_slots": 5, "read_slots": s,
        "rounds_per_dispatch": k, "dispatches": dispatches,
        "write_window": write,
        "mixed": {
            "read_ratio": 9,
            "reads_confirmed": confirmed,
            "reads_per_sec": confirmed / melapsed,
            "writes_per_sec": n_groups * k * dispatches / melapsed,
            "ops_per_sec": (confirmed + n_groups * k * dispatches) / melapsed,
            "read_dispatch_p50_ms": _p(mtimes, 50),
            "read_dispatch_p99_ms": _p(mtimes, 99),
            "blocks_checked_all_rows": len(blocks),
            "host_staging_ms_p50": _p(split["stage_ms"], 50),
            "h2d_ms_p50": _p(split["h2d_ms"], 50),
            "kernel_ms_p50": _p(split["kernel_ms"], 50),
            "d2h_ms_p50": _p(split["d2h_ms"], 50),
            # host ms a block in each engine call (the step_rounds figure
            # holds _stage_multiround's, the upload and the launch)
            "host_calls_ms_p50": {name: _p(v, 50) for name, v in calls.items()},
            "h2d_bytes": int(k * n_groups * (5 * 4 + s * 8 + s * 5) + k + 16 * k),
            "launches_per_block": launches,
        },
    }
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 8: the read plane through the engine, cuda == cpu
# ----------------------------------------------------------------------


def _read_op_script(torch, engine_mod, dev, mode, n=65_536, rounds=8):
    """Lockstep card/CPU engines under reads: bulk and single stages,
    echo quorums full and partial, cancels, a rebase and leader changes
    with batches pending, elections, and (fused) in-program recycles of
    rows with pending slots.  Returns what it counted."""
    pair = Lockstep(engine_mod, dev, n, dense_ingest={"sparse": False, "fused": "auto"}[mode],
                    device_ticks=True)
    pair.enable_telem()
    rng = np.random.default_rng(47)
    leaders, term, last = set(), {}, {}
    for cid in range(1, n + 1):
        follower = cid % 8 == 0
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1, election_timeout=1000,
                       rand_timeout=int(4 + cid % 37) if follower else 2000)
        if cid % 3 == 0:
            pair.set_hier(cid, [1, 2, 3], 2)
        term[cid] = last[cid] = 1
        if not follower:
            pair.set_leader(cid, term=1, term_start=1, last_index=1)
            leaders.add(cid)
    h = pair.h
    next_cid = n + 1
    seen = dict.fromkeys(("steps", "staged", "confirmed", "cancelled", "pending_max",
                          "purged_by_transition", "recycled_pending", "won"), 0)
    frac = 0.03 if mode == "sparse" else 1.0
    pending = []  # (cid, slot) staged with one echo, left pending
    for rnd in range(rounds):
        lead = np.array(sorted(leaders), np.int64)
        acking = lead[rng.random(lead.size) < frac]
        for cid in acking.tolist():
            last[cid] += 1
        arows = np.array([h.groups[c].row for c in acking.tolist()], np.int64)
        arels = np.array([last[c] - h.groups[c].base for c in acking.tolist()], np.int64)
        pair.ack_block(np.concatenate([arows] * 3), np.repeat(np.arange(3), arows.size),
                       np.concatenate([arels] * 3))
        reads_round = mode == "fused" or rnd % 2 == 1
        if reads_round:
            cand = lead[rng.random(lead.size) < 0.3]
            cand = cand[np.array([h.read_slots_free(c) for c in cand.tolist()]) > 0]
            crow = np.array([h.groups[c].row for c in cand.tolist()], np.int64)
            crel = np.array([max(0, last[c] - h.groups[c].base - 1) for c in cand.tolist()])
            sc, sh = pair.stage_read_block(crow, crel, rng.integers(1, 10, cand.size))
            check(np.array_equal(sc, sh), f"{mode} round {rnd}: read slots differ")
            seen["staged"] += int(cand.size)
            u = rng.random(cand.size)
            full, one = u < 0.7, (u >= 0.7) & (u < 0.9)
            erows = np.concatenate([crow[full], crow[full], crow[one]])
            eslots = np.concatenate([sh[full], sh[full], sh[one]])
            epeers = np.concatenate([np.full(int(full.sum()), 1), np.full(int(full.sum()), 3),
                                     np.full(int(one.sum()), 4)])
            pair.read_ack_block(erows, eslots, epeers)
            pending += list(zip(cand[one].tolist(), sh[one].tolist()))[:200]
            for cid in lead[:32].tolist():  # singles, echoed by one voter
                if h.read_slots_free(cid):
                    slot, slot_h = pair.stage_read(cid, count=2)
                    check(slot == slot_h, f"{mode} round {rnd}: read slots differ")
                    pair.read_ack(cid, 2, slot)
        if rnd >= 2 and pending:  # cancels and late echoes of pending batches
            for cid, slot in pending[:40]:
                if cid in leaders:
                    pair.cancel_read(cid, slot)
                    seen["cancelled"] += 1
            for cid, slot in pending[40:80]:
                if cid in leaders:
                    pair.read_ack(cid, 5, slot)
            pending = pending[80:]
        if rnd == 2:  # a rebase of leaders with batches pending
            some = [c for c, _ in pending[:60] if c in leaders]
            pair.sync_rows([h.groups[c].row for c in some])
            for cid in some:
                pair.rebase(cid)
        if rnd == 3:  # leader changes with batches pending: the reads die
            fallen = [c for c, _ in pending[:50] if c in leaders]
            pair.sync_rows([h.groups[c].row for c in fallen])
            seen["purged_by_transition"] += sum(
                int(h.mirror.arrays["read_count"][h.groups[c].row].sum() > 0) for c in fallen)
            for cid in fallen:
                term[cid] += 1
                pair.set_follower(cid, term=term[cid])
                leaders.discard(cid)
        if mode == "fused":
            pair.begin_round()
            old = sorted(leaders)[300 + rnd]
            seen["recycled_pending"] += int(h.read_slots_free(old) < h.n_read_slots)
            pair.stage_recycle(old, next_cid, term=3, term_start=1, last_index=1)
            leaders.discard(old)
            leaders.add(next_cid)
            term[next_cid], last[next_cid] = 3, 1
            next_cid += 1
            sl = pair.stage_read(next_cid - 1, count=4)[0]
            pair.read_ack(next_cid - 1, 2, sl)
            pair.read_ack(next_cid - 1, 3, sl)
            pair.begin_round()
            ra, rb = pair.step_rounds(do_tick=True, pad_rounds_to=4)
        else:
            ra, rb = pair.step(do_tick=True)
        tag = f"reads {mode} round {rnd}"
        pair.compare(ra, rb, tag)
        check(ra.reads == rb.reads, f"{tag}: read egress differs")
        seen["confirmed"] += sum(c for *_, c in rb.reads)
        sc_, sh_ = pair.c.telem_snapshot(), pair.h.telem_snapshot()
        check(sh_ is not None and same_snapshot(sc_, sh_), f"{tag}: telemetry snapshots differ")
        seen["pending_max"] = max(seen["pending_max"], sh_["read_slots"])
        for name in pair.c.dev._fields:
            check(torch.equal(getattr(pair.c.dev, name).cpu(), getattr(pair.h.dev, name)),
                  f"{tag}: state field {name} differs")
        seen["steps"] += 1
        # host follow-ups: elections and wins
        elect = [c for c in sorted(rb.elect) if c not in leaders][:300]
        pair.sync_rows([h.groups[c].row for c in elect])
        for cid in elect:
            term[cid] += 1
            pair.set_candidate(cid, term=term[cid])
            for nid in (1, 2, 3):
                pair.vote(cid, nid, True)
        if rb.won:
            pair.sync_rows([h.groups[c].row for c in rb.won])
        for cid in sorted(rb.won):
            pair.set_leader(cid, term=term[cid], term_start=last[cid] + 1,
                            last_index=last[cid] + 1)
            last[cid] += 1
            leaders.add(cid)
            seen["won"] += 1
    check(seen["confirmed"] > 0 and seen["pending_max"] > 0 and seen["cancelled"] > 0
          and seen["purged_by_transition"] > 0,
          f"reads {mode}: the script exercised too little: {seen}")
    if mode == "fused":
        check(seen["recycled_pending"] > 0, f"reads {mode}: no recycle met a pending slot")
    return seen


def phase_read_ops(torch, engine_mod, dev):
    out = {"phase": "read_op_script", "groups": 65_536, "peer_slots": 5}
    for mode in ("sparse", "fused"):
        t0 = time.perf_counter()
        out[mode] = _read_op_script(torch, engine_mod, dev, mode)
        out[f"{mode}_seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 9: rung 4's write window with the device state machine on
# ----------------------------------------------------------------------


def phase_rung4_devsm(torch, engine_mod, tk, ts, dev, n_groups=65_536, k=16, dispatches=8):
    """``bench_e2e.py:run_devsm``'s engine half at rung 4's width: every
    write is a SET on one of V key slots, and KV reads are served from the
    device image.  Per block each group acks one index a round on 3 slots
    (``ack_block_rounds``; the three rounds that carry other staging take
    their acks from ``ack_block``), stages 8 SETs at every other index of
    the block in one ``stage_kv_ops`` call (odd indexes in one block, even
    in the next, so with one block in flight 8 + 8 ops fill E = 16), and
    stages 2 KV reads, in rounds 4 and 12.  Every block's captures, the
    final values and every watermark are held against a numpy oracle that
    applies the SETs in log order at the watermark."""
    split = {"stage_ms": [], "h2d_ms": [], "kernel_ms": [], "d2h_ms": [], "h2d_bytes": []}
    TimedEngine = timed_engine(torch, engine_mod, split)
    eng = TimedEngine(n_groups, 5, event_cap=4 * n_groups, device_ticks=False, device=dev)
    eng._events = []
    for cid in range(1, n_groups + 1):
        eng.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    eng._upload_dirty()
    v, e, r = eng.n_kv_slots, eng.n_kv_ents, eng.n_kv_reads
    check((v, e, r) == KV_DIMS, f"rung4_devsm: (V, E, R) = {(v, e, r)}")
    rng = np.random.default_rng(97)
    rows = np.arange(n_groups, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), n_groups)
    cids = np.arange(1, n_groups + 1).tolist()
    row_cid = eng.row_cids()
    oracle = np.zeros((n_groups, v), np.int64)  # the values applied so far
    expect = []  # per block: (watermark, rows, slots, values, abs indexes)
    calls = {name: [] for name in ("stage_kv_ops", "stage_kv_read", "ack_block",
                                   "ack_block_rounds", "step_rounds")}
    st = {"rel": 1, "queued": 0}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        calls[name][-1] += (time.perf_counter() - t) * 1e3
        return out

    def acks(lo, hi):
        """Rounds lo..hi-1 of the block: one index a round."""
        base = st["rel"]
        if hi - lo == 1:
            timed("ack_block", eng.ack_block, rows3, slots,
                  np.full(rows3.size, base + 1 + lo, np.int32))
        else:
            rels = (base + 1 + np.arange(lo, hi, dtype=np.int32))[:, None]
            timed("ack_block_rounds", eng.ack_block_rounds, rows3, slots,
                  rels + np.zeros((1, rows3.size), np.int32))

    def reads(keys):
        t = time.perf_counter()
        out = np.array([eng.stage_kv_read(cid, key) for cid, key in zip(cids, keys.tolist())])
        calls["stage_kv_read"][-1] += (time.perf_counter() - t) * 1e3
        return out

    def block(b):
        for name in calls:
            calls[name].append(0.0)
        base = st["rel"]
        idxs = base + 1 + b % 2 + 2 * np.arange(8)
        keys = rng.integers(0, v, (n_groups, 8))
        values = rng.integers(-2**31, 2**31, (n_groups, 8))
        t = time.perf_counter()
        for i, cid in enumerate(cids):
            if not eng.stage_kv_ops(cid, idxs, keys[i], values[i]):
                st["queued"] += 1
        calls["stage_kv_ops"][-1] += (time.perf_counter() - t) * 1e3
        rkeys = rng.integers(0, v, (2, n_groups))
        acks(0, 1)                      # round 0: the SETs and its acks
        acks(1, 4)
        acks(4, 5)                      # round 4: a read
        s4 = reads(rkeys[0])
        acks(5, 12)
        acks(12, 13)                    # round 12: a read
        s12 = reads(rkeys[1])
        acks(13, k)
        st["rel"] = base + k
        # the oracle: the SETs in log order, each read at its round's watermark
        caps, done = [], base
        for w, sl, rk in ((base + 5, s4, rkeys[0]), (base + 13, s12, rkeys[1]),
                          (base + k, None, None)):
            for j in range(8):
                if done < idxs[j] <= w:
                    oracle[rows, keys[:, j]] = values[:, j]
            done = w
            if sl is not None:
                caps.append((np.full(n_groups, w, np.int64), sl, oracle[rows, rk]))
        er = np.concatenate([rows, rows]).astype(np.int64)
        ei, es, ev = (np.concatenate(parts).astype(np.int64) for parts in zip(*caps))
        order = np.lexsort((es, er))
        expect.append((base + k, er[order], es[order], ev[order], ei[order]))
        return timed("step_rounds", eng.step_rounds, do_tick=False, pipelined=True)

    kv_events = []
    orig_run = tk._kv_run

    def timed_kv(*a, **kw):
        s0 = torch.cuda.Event(enable_timing=True)
        e0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        out = orig_run(*a, **kw)
        e0.record()
        kv_events.append((s0, e0))
        return out

    results, applied = {}, 0
    tk._kv_run = timed_kv
    try:
        block(0)  # warm-up block
        results[0] = eng.harvest()
        for key in split:
            split[key].clear()
        for key in calls:
            calls[key].clear()
        eng._events.clear()
        kv_events.clear()
        launches0 = tk.launch_counts()
        disp_ms = []
        t0 = time.perf_counter()
        for b in range(1, dispatches + 1):
            td = time.perf_counter()
            res = block(b)
            disp_ms.append((time.perf_counter() - td) * 1e3)
            if res is not None:
                results[b - 1] = res
        results[dispatches] = eng.harvest()
        elapsed = time.perf_counter() - t0
    finally:
        tk._kv_run = orig_run
    launches = {name: (n - launches0[name]) / dispatches for name, n in tk.launch_counts().items()}
    torch.cuda.synchronize()
    for key, s0, e0 in eng._events:
        split[key].append(s0.elapsed_time(e0))
    kv_ms = [s0.elapsed_time(e0) for s0, e0 in kv_events]

    check(sorted(results) == list(range(dispatches + 1)), "rung4_devsm: a block's egress is missing")
    for b, (w, er, es, ev, ei) in enumerate(expect):
        res = results[b]
        check(np.all(res.committed_rel == w), f"rung4_devsm: block {b}'s watermarks differ")
        check(res.kv_cids is not None
              and np.array_equal(res.kv_cids, row_cid[er])
              and np.array_equal(res.kv_slots, es)
              and np.array_equal(res.kv_vals, ev)
              and np.array_equal(res.kv_index_abs, ei),
              f"rung4_devsm: block {b}'s captures differ from the oracle")
        check(res.kv_applied_ops == n_groups * 8,
              f"rung4_devsm: block {b} applied {res.kv_applied_ops} ops")
        applied += res.kv_applied_ops
    expected = n_groups * 8 * (dispatches + 1)
    check(applied == expected, f"rung4_devsm: {applied} ops applied, expected {expected}")
    check(st["queued"] == 0 and not eng._kv_queue,
          f"rung4_devsm: ops queued on the host: {st['queued']} calls, "
          f"{sum(len(q) for q in eng._kv_queue.values())} ops")
    f = ts.state_to_numpy(eng.dev)
    check(np.all(f["committed"] == st["rel"]), "rung4_devsm: final watermarks differ")
    check(np.array_equal(f["kv_value"], oracle.astype(np.int32)),
          "rung4_devsm: final kv_value differs from the oracle")
    check(np.all(f["kv_ent_index"] == -1), "rung4_devsm: entries left buffered")
    kernel_ms = np.array(split["kernel_ms"])
    out = {
        "phase": "rung4_devsm",
        "groups": n_groups, "peer_slots": 5, "rounds_per_dispatch": k,
        "kv_slots": v, "kv_ents": e, "kv_reads": r, "dispatches": dispatches,
        "blocks_checked_all_rows": len(expect),
        "ops_applied": applied, "reads_captured": 2 * n_groups * (dispatches + 1),
        "applied_ops_per_sec": n_groups * 8 * dispatches / elapsed,
        "kv_reads_per_sec": n_groups * 2 * dispatches / elapsed,
        "writes_per_sec": n_groups * k * dispatches / elapsed,
        "dispatch_ms_p50": _p(disp_ms, 50), "dispatch_ms_p99": _p(disp_ms, 99),
        "host_calls_ms_p50": {name: _p(vals, 50) for name, vals in calls.items()},
        "host_staging_ms_p50": _p(split["stage_ms"], 50),
        "h2d_bytes": int(np.median(split["h2d_bytes"])),
        "h2d_ms_p50": _p(split["h2d_ms"], 50),
        "k3_and_kv_ms_p50": _p(kernel_ms, 50),
        "kv_plane_ms_p50": _p(kv_ms, 50),
        "k3_ms_p50": _p(kernel_ms - np.array(kv_ms), 50),
        "d2h_ms_p50": _p(split["d2h_ms"], 50),
        "launches_per_block": launches,
    }
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 10: the device state machine through the engine, cuda == cpu
# ----------------------------------------------------------------------


def _devsm_op_script(torch, engine_mod, dev, mode, n=65_536):
    """Lockstep card/CPU engines under devsm traffic, with the hier rule
    on a third of the rows and the fold on.  Rounds 0 and 1 stage SETs on
    a third of the groups (partial acks leave some buffered) and KV
    reads, and round 1 overfills one row's E slots (ops queue, then
    drain).  Round 2 moves a leader with buffered entries through a
    transition, rebases rows with buffered entries and restores a KV
    image.  Round 3 stages no kv event while entries sit buffered and
    releases most stalled acks: the plane must still run and apply them.
    Round 4 recycles a row with buffered entries while another row's stay
    buffered (the reset inside the plane); round 5 releases that row;
    round 6 recycles a row on a block with nothing buffered (the purge
    alone), and on the sparse path one sparse step follows (the fold
    counting entry slots).  Round 7 stages SETs and reads again.  After
    every step the card equals the CPU in every state field, the kv
    egress, the host slot bookkeeping and the telemetry snapshot."""
    pair = Lockstep(engine_mod, dev, n, dense_ingest={"sparse": False, "fused": "auto"}[mode],
                    device_ticks=True)
    pair.enable_telem()
    h = pair.h
    for cid in range(1, n + 1):
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1, election_timeout=1000,
                       rand_timeout=2000)
        if cid % 3 == 0:
            pair.set_hier(cid, [1, 2, 3], 2)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    rng = np.random.default_rng(59)
    v, e = h.n_kv_slots, h.n_kv_ents
    last = {cid: 1 for cid in range(1, n + 1)}
    kv_cids = list(range(1, n + 1, 3))
    kv_set = set(kv_cids)
    stalled = set(kv_cids[7::50])           # their followers withhold acks
    x_cid, y_cid = sorted(stalled)[:2]      # kept stalled past round 3
    next_cid = n + 1
    seen = dict.fromkeys(("steps", "ops_staged", "applied", "captured", "queued_max",
                          "kvfree_applied", "transition_purged", "rebased_buffered",
                          "restored", "recycled_buffered", "purge_only_blocks"), 0)

    def buffered(cid):
        return int((h._kv_ent_rel[h.groups[cid].row] >= 0).sum())

    def stage_ops(cids):
        for cid in cids:
            m = 1 + (cid + seen["steps"]) % 2
            idxs = last[cid] + 1 + np.arange(m)
            a, b = pair.stage_kv_ops(cid, idxs, rng.integers(0, v, m),
                                     rng.integers(-2**31, 2**31, m))
            check(a == b, f"devsm {mode}: stage_kv_ops answers differ")
            last[cid] += m
            seen["ops_staged"] += m

    def stage_reads(cids):
        for cid in cids:
            if h.kv_reads_free(cid):
                sa, sb = pair.stage_kv_read(cid, int(rng.integers(0, v)))
                check(sa == sb, f"devsm {mode}: read slots differ")

    def ack_all(release, partial_share):
        live = sorted(h.groups)
        rows = np.array([h.groups[c].row for c in live], np.int64)
        rels = np.array([last[c] - h.groups[c].base for c in live], np.int64)
        held = np.array([c in stalled and c not in release for c in live])
        partial = rng.random(len(live)) < partial_share
        f_rel = np.where(partial, np.maximum(rels - 1, 0), rels)
        pair.ack_block(np.concatenate([rows, rows[~held], rows[~held]]),
                       np.concatenate([np.zeros(rows.size), np.ones((~held).sum()),
                                       np.full((~held).sum(), 2)]).astype(np.int64),
                       np.concatenate([rels, f_rel[~held], rels[~held]]))

    def settle(ra, rb, tag):
        pair.compare(ra, rb, tag)
        check(ra.kv_reads == rb.kv_reads and ra.kv_applied_ops == rb.kv_applied_ops,
              f"{tag}: kv egress differs")
        seen["applied"] += rb.kv_applied_ops
        seen["captured"] += len(rb.kv_reads)
        sc, sh = pair.c.telem_snapshot(), pair.h.telem_snapshot()
        check(sh is not None and same_snapshot(sc, sh), f"{tag}: telemetry snapshots differ")
        for name in pair.c.dev._fields:
            check(torch.equal(getattr(pair.c.dev, name).cpu(), getattr(pair.h.dev, name)),
                  f"{tag}: state field {name} differs")
        check(np.array_equal(pair.c._kv_ent_rel, h._kv_ent_rel)
              and pair.c._kv_queue.keys() == h._kv_queue.keys(),
              f"{tag}: host slot bookkeeping differs")
        seen["steps"] += 1

    for rnd in range(8):
        for cid in h.groups:
            if cid not in kv_set:
                last[cid] += 1  # writes without SETs
        if rnd in (0, 1, 7):
            stage_ops([c for c in kv_cids if c in h.groups])
            stage_reads([int(c) for c in rng.choice(kv_cids, min(2000, len(kv_cids)),
                                                     replace=False) if int(c) in h.groups])
        if rnd == 1:  # more than E ops at once: the rest queue, then drain
            idxs = last[1] + 1 + np.arange(e + 3)
            a, b = pair.stage_kv_ops(1, idxs, rng.integers(0, v, e + 3), np.arange(e + 3))
            check(a is False and b is False, f"devsm {mode}: overfill did not queue")
            last[1] += e + 3
            seen["queued_max"] = max(seen["queued_max"], len(h._kv_queue[h.groups[1].row]))
        if rnd == 2:
            t_cid = sorted(stalled)[2]
            pair.sync_rows([h.groups[t_cid].row])
            seen["transition_purged"] += buffered(t_cid) > 0
            pair.set_follower(t_cid, term=2)
            pair.set_leader(t_cid, term=3, term_start=last[t_cid] + 1,
                            last_index=last[t_cid] + 1)
            last[t_cid] += 1
            some = [c for c in kv_cids[1:400] if buffered(c) and c not in stalled][:40]
            pair.sync_rows([h.groups[c].row for c in some])
            for cid in some:
                pair.rebase(cid)
            seen["rebased_buffered"] += len(some)
            pair.kv_restore(4, np.arange(v) * 7 - 3)
            seen["restored"] += 1
        if rnd == 4:
            pair.begin_round()
            seen["recycled_buffered"] += buffered(x_cid) > 0
            pair.stage_recycle(x_cid, next_cid, term=3, term_start=1, last_index=1)
            last[next_cid] = 1
            next_cid += 1
        if rnd == 6:
            z = kv_cids[5]
            check(not h._kv_ents_buffered(), f"devsm {mode}: entries buffered before the purge")
            pair.stage_recycle(z, next_cid, term=3, term_start=1, last_index=1)
            last[next_cid] = 1
            next_cid += 1
            seen["purge_only_blocks"] += 1
        release = ()
        if rnd >= 3:
            release = stalled - ({x_cid, y_cid} if rnd < 5 else set())
        ack_all(release, 0.3 if rnd < 3 else 0.0)
        kv_free = not h._kv_pending()
        if mode == "fused":
            pair.begin_round()
            ra, rb = pair.step_rounds(do_tick=True, pad_rounds_to=4)
        else:
            ra, rb = pair.step(do_tick=True)
        settle(ra, rb, f"devsm {mode} round {rnd}")
        if rnd == 3:
            check(kv_free and rb.kv_applied_ops > 0,
                  f"devsm {mode} round 3: the kv-free dispatch applied nothing")
            seen["kvfree_applied"] += rb.kv_applied_ops
        if rnd == 6 and mode == "sparse":
            # nothing buffered, no kv event: the sparse step, with the fold
            # counting entry slots
            for cid in sorted(h.groups)[:64]:
                pair.heartbeat_resp(cid, 2)
            settle(*pair.step(do_tick=True), f"devsm {mode} round 6, sparse")
    check(not h._kv_queue, f"devsm {mode}: ops still queued")
    check(all(seen[key] > 0 for key in ("captured", "queued_max", "kvfree_applied",
                                        "transition_purged", "rebased_buffered",
                                        "recycled_buffered")),
          f"devsm {mode}: the script exercised too little: {seen}")
    return seen


def phase_devsm_ops(torch, engine_mod, dev):
    out = {"phase": "devsm_op_script", "groups": 65_536, "peer_slots": 5}
    for mode in ("sparse", "fused"):
        t0 = time.perf_counter()
        out[mode] = _devsm_op_script(torch, engine_mod, dev, mode)
        out[f"{mode}_seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 11: the device ladder (bench.py's pipelined, latency-bounded and
# host-loop modes)
# ----------------------------------------------------------------------


def _mode_line(out):
    ms = out.pop("dispatch_ms")
    return dict(out, dispatch_ms_p50=_p(ms, 50), dispatch_ms_p99=_p(ms, 99))


def phase_ladder(ladder_mod, dev):
    """``bench.py``'s ladder through the port: the pipelined headline
    (131,072 groups x 3, R = 256, acks made on the device by
    ``staged_multistep``, 3 warm-up and 5 measured dispatches), the
    latency-bounded mode (1,024 groups, R = 1, 5 + 50) and the host loop
    (65,536 groups, K = 16, 8 dispatches through the engine's
    ``ack_block_rounds`` and K3).  Every dispatch's watermarks are checked
    on every row; setup (the engine's add_group / set_leader loop) is
    timed apart from the measured window."""
    out = {"phase": "ladder"}
    t0 = time.perf_counter()
    out["pipelined"] = dict(_mode_line(ladder_mod.run_mode(
        LADDER_G, LADDER_R, 5, warmup=3, device=dev)), acks="device-synthesised")
    out["latency"] = dict(_mode_line(ladder_mod.run_mode(
        1024, 1, 50, warmup=5, device=dev)), acks="device-synthesised")
    out["host_loop"] = dict(_mode_line(ladder_mod.run_host_loop(
        65_536, 8, k=16, device=dev)), acks="host-staged")
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 12: an R-round host pipeline through both scans and K2
# ----------------------------------------------------------------------


def _multistep_pipeline(n, r, base):
    """R rounds of host-staged events for an engine of ``n`` groups x 5
    whose rows cycle leader, leader, hier leader, candidate, candidate,
    follower: every leader acks ``base + 1 + k`` on slots 0 and 1 in round
    k, and on slot 2 too, two behind on the hier leaders (near slots
    {0,1,2}, sub-quorum 2, so only the hier rule commits them to the
    top); stale duplicates; every other follower hears its leader (a zero
    ack); the first candidates win in round 1 (self and slots 1, 2 grant),
    the second lose in round 2 (slots 1, 2, 3 reject); invalid padding and
    a valid ack on a row out of range.  Returns the (R, cap) acks and
    (R, vcap) votes and the rows of each role."""
    rows = np.arange(n, dtype=np.int32)
    role = rows % 6
    lead, hier = rows[role <= 2], rows[role == 2]
    cand_w, cand_l, foll = rows[role == 3], rows[role == 4], rows[role == 5]
    ag, ap, av = [], [], []
    for k in range(r):
        v = base + 1 + k
        lag = np.where(role[lead] == 2, v - 2, v)
        g_k = np.concatenate([lead, lead, lead, lead[::5], foll[::2], [n + 3]])
        p_k = np.concatenate([np.zeros_like(lead), np.ones_like(lead), np.full_like(lead, 2),
                              np.ones_like(lead[::5]), np.zeros_like(foll[::2]), [0]])
        v_k = np.concatenate([np.full(lead.size, v), np.full(lead.size, v), lag,
                              np.full(lead[::5].size, v - 3), np.zeros(foll[::2].size), [v]])
        ag.append(g_k), ap.append(p_k), av.append(v_k)
    cap = ag[0].size + 64
    acks = [np.zeros((r, cap), np.int32) for _ in range(3)] + [np.zeros((r, cap), bool)]
    for k in range(r):
        m = ag[k].size
        acks[0][k, :m], acks[1][k, :m], acks[2][k, :m] = ag[k], ap[k], av[k]
        acks[3][k, :m] = True
        acks[0][k, m:] = k % n  # invalid padding pointing at real rows
    vg_w = np.repeat(cand_w, 3)
    vp_w = np.tile(np.array([0, 1, 2], np.int32), cand_w.size)
    vg_l = np.repeat(cand_l, 3)
    vp_l = np.tile(np.array([1, 2, 3], np.int32), cand_l.size)
    vcap = max(vg_w.size, vg_l.size)
    votes = [np.zeros((r, vcap), np.int32) for _ in range(2)] + [
        np.zeros((r, vcap), np.int8), np.zeros((r, vcap), bool)]
    for k, (vg, vp, grant) in ((1, (vg_w, vp_w, 1)), (2, (vg_l, vp_l, 0))):
        votes[0][k, :vg.size], votes[1][k, :vg.size] = vg, vp
        votes[2][k, :vg.size], votes[3][k, :vg.size] = grant, True
    return tuple(acks), tuple(votes), (lead, hier, cand_w, cand_l, foll)


def _collapse(acks, votes, n, p):
    """The sparse rounds as the dense scan's (R, G, P) planes: each cell's
    max ack (0 where untouched), its touched bit, and its vote."""
    ag, ap, av, valid = acks
    r = ag.shape[0]
    am = np.full((r, n, p), np.iinfo(np.int32).min, np.int64)
    at = np.zeros((r, n, p), bool)
    vn = np.full((r, n, p), -1, np.int8)
    for k in range(r):
        ok = valid[k] & (ag[k] >= 0) & (ag[k] < n) & (ap[k] >= 0) & (ap[k] < p)
        np.maximum.at(am[k], (ag[k][ok], ap[k][ok]), av[k][ok])
        at[k][ag[k][ok], ap[k][ok]] = True
        vok = votes[3][k]
        vn[k][votes[0][k][vok], votes[1][k][vok]] = votes[2][k][vok]
    return (np.where(at, am, 0).astype(np.int32), at, vn)


def phase_multistep(torch, engine_mod, tk, ts, dev, n=65_536, r=16):
    """An R = 16 host pipeline at 65,536 groups x 5 with ticks (heartbeats,
    check-quorum windows and election timeouts fire inside the block),
    votes and the hier rule on a third of the leaders, from an engine
    built on the card, run three ways from the same state: ``quorum_multistep`` on the
    sparse rounds, ``quorum_multistep_dense`` on their numpy collapse, and
    R launches of K2 (``quorum_step``) with the flags OR-ed; the three must
    give bit-equal states and flags, equal to the CPU's plain scan, and
    every leader must commit the last index."""
    t0 = time.perf_counter()
    eng = engine_mod.BatchedQuorumEngine(n, 5, device_ticks=True, device=dev)
    peers = [1, 2, 3, 4, 5]
    for cid in range(1, n + 1):
        role = (cid - 1) % 6
        # clocks that expire inside the block: the check-quorum window
        # every 5 ticks on the leaders, elections after 10
        eng.add_group(cid, node_ids=peers, self_id=1, election_timeout=5,
                      check_quorum=role <= 2)
        if role <= 2:
            eng.set_leader(cid, term=1, term_start=1, last_index=1)
        if role == 2:
            eng.set_hier(cid, near_ids=[1, 2, 3], sub_quorum=2)
        elif role in (3, 4):
            eng.set_candidate(cid, term=2)
    eng._upload_dirty()
    fields = ts.state_to_numpy(eng.dev)
    setup_s = time.perf_counter() - t0
    base = 1
    acks, votes, (lead, hier, cand_w, cand_l, foll) = _multistep_pipeline(n, r, base)
    dense = _collapse(acks, votes, n, 5)
    flags = MS_VARIANT
    sp_args = [torch.from_numpy(a).to(dev) for a in acks + votes]
    de_args = [torch.from_numpy(a).to(dev) for a in dense]
    routes, wall = {}, {}

    def run(label, fn):
        st = ts.state_from_numpy(fields, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(st)
        torch.cuda.synchronize()
        wall[label] = (time.perf_counter() - t) * 1e3
        routes[label] = out

    run("quorum_multistep", lambda st: tk.quorum_multistep(st, *sp_args, **flags))
    run("quorum_multistep_dense", lambda st: tk.quorum_multistep_dense(st, *de_args, **flags))

    def k2_rounds(st):
        acc = None
        for k in range(r):
            out = tk.quorum_step(st, *(a[k] for a in sp_args), **flags)
            got = [out.won, out.lost, *out.flags]
            acc = got if acc is None else [a | b for a, b in zip(acc, got)]
        return tk.StepOutputs(st, st.committed, acc[0], acc[1], tk.TickFlags(*acc[2:]))

    run("quorum_step_x16", k2_rounds)
    cpu_st = ts.state_from_numpy(fields, "cpu")
    t = time.perf_counter()
    cpu = tk.quorum_multistep(cpu_st, *(torch.from_numpy(a) for a in acks + votes), **flags)
    wall["cpu_plain"] = (time.perf_counter() - t) * 1e3
    ref = routes["quorum_multistep"]
    for label, out in routes.items():
        if label != "quorum_multistep":
            _equal_outputs(torch, ts, tk, out, ref, f"multistep path: {label} vs quorum_multistep")
    got = ts.state_to_numpy(ref.state)
    want = ts.state_to_numpy(cpu.state)
    for name in want:
        check(np.array_equal(got[name], want[name]),
              f"multistep path: state field {name} differs between the card and the CPU")
    fired = {}
    for name, a, b in zip(("won", "lost") + tk.TickFlags._fields,
                          (ref.won, ref.lost) + tuple(ref.flags),
                          (cpu.won, cpu.lost) + tuple(cpu.flags)):
        a = a.cpu().numpy()
        check(np.array_equal(a, b.numpy()), f"multistep path: {name} differs between the card and the CPU")
        fired[name] = int(a.sum())
    committed = got["committed"]
    check(np.all(committed[lead] == base + r), "multistep path: a leader's watermark is not the last index")
    check(np.array_equal(np.flatnonzero(ref.won.cpu().numpy()), cand_w),
          "multistep path: the winning candidates differ")
    check(np.array_equal(np.flatnonzero(ref.lost.cpu().numpy()), cand_l),
          "multistep path: the losing candidates differ")
    check(all(fired.values()), f"multistep path: a flag never fired: {fired}")
    out = {"phase": "multistep", "groups": n, "peer_slots": 5, "rounds": r,
           "events_per_round": int(acks[0].shape[1]), "hier_rows": int(hier.size),
           "routes_equal": sorted(routes), "flags_fired": fired,
           "wall_ms": wall, "setup_s": setup_s}
    emit(out)
    return out


# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# phase 13: the quorum coordinator (dragonboat_tpu_torch/coordinator.py)
# ----------------------------------------------------------------------

COORD_G = 100_000      # BASELINE rung 5's groups
COORD_P = 8            # NodeHost's n_peers
COORD_ROUNDS = 24
COORD_ELECT = 1_024    # groups through candidate and votes each round
COORD_RESYNC = 256     # groups through membership_changed each round
COORD_DEVSM = 4_096    # groups bound to the devsm plane
COORD_QUIET = 4_096    # writers of a quiet round (K2)
LIVE_G = 65_536
LIVE_S = 10.0
LEADER, CANDIDATE, FOLLOWER = "leader", "candidate", "follower"


class _Remote:
    __slots__ = ("match",)

    def __init__(self, match):
        self.match = match


class _Log:
    __slots__ = ("raft",)

    def __init__(self, raft):
        self.raft = raft

    def last_index(self):
        return self.raft.last


class _Near:
    """Hier geometry stand-in: replicas 1-3 share this replica's domain."""

    @staticmethod
    def near_voters(voters):
        return [v for v in voters if v in (1, 2, 3)]


class StubRaft:
    """The scalar raft as the coordinator reads it (duck-typed): five
    voters, this replica is node 1.  ``offload`` is the coordinator the
    transitions stage into, as a raft's offload hooks do."""

    __slots__ = ("cluster_id", "node_id", "term", "state", "last", "acked",
                 "committed", "term_start_index", "hier", "offload",
                 "randomized_election_timeout", "device_reads", "log", "votes")
    lease = None
    witnesses = {}
    observers = {}
    election_timeout = 10
    heartbeat_timeout = 1
    check_quorum = False

    def __init__(self, cid, hier, offload):
        self.cluster_id = cid
        self.node_id = 1
        self.term = 1
        self.state = LEADER
        self.last = self.acked = self.term_start_index = 1
        self.committed = 0
        self.hier = _Near if hier else None
        self.offload = offload
        self.randomized_election_timeout = 10 + cid % 10
        self.device_reads = False
        self.log = _Log(self)
        self.votes = {}

    @property
    def remotes(self):
        return {1: _Remote(self.last), 2: _Remote(self.acked), 3: _Remote(self.acked),
                4: _Remote(0), 5: _Remote(0)}

    def is_leader(self):
        return self.state == LEADER

    def is_candidate(self):
        return self.state == CANDIDATE

    def write(self):
        """One entry appended and acked by followers 2 and 3 (quorum 3 of
        5 with the self ack the append stages)."""
        self.last += 1
        self.acked = self.last
        off, cid, last = self.offload, self.cluster_id, self.last
        off.ack(cid, 1, last)
        off.ack(cid, 2, last)
        off.ack(cid, 3, last)

    def become_candidate(self):
        self.state = CANDIDATE
        self.term += 1
        self.offload.set_candidate(self.cluster_id, self.term)

    def become_leader(self):
        self.state = LEADER
        self.last += 1  # the term's noop
        self.term_start_index = self.last
        self.offload.ack(self.cluster_id, 1, self.last)
        self.offload.set_leader(self.cluster_id, self.term, self.last, self.last)


class _Peer:
    __slots__ = ("raft",)

    def __init__(self, raft):
        self.raft = raft


class StubNode:
    """A node as the coordinator drives it: every offload effect is
    applied with the scalar guards and logged as ``(cid, kind, ...)``;
    ``sm`` reports the raft's committed index as applied (the devsm
    plane's bind gate)."""

    __slots__ = ("cluster_id", "raft_mu", "peer", "sm", "log")

    def __init__(self, raft, log):
        self.cluster_id = raft.cluster_id
        self.raft_mu = contextlib.nullcontext()
        self.peer = _Peer(raft)
        self.sm = self
        self.log = log

    def get_last_applied(self):
        return self.peer.raft.committed

    def offload_commit(self, q):
        r = self.peer.raft
        self.log.append((self.cluster_id, "c", q))
        if r.state == LEADER and q > r.committed:
            r.committed = min(q, r.last)

    def offload_election(self, won, term):
        r = self.peer.raft
        self.log.append((self.cluster_id, "w" if won else "l", term))
        if r.state == CANDIDATE and r.term == term:
            if won:
                r.become_leader()
            else:
                r.state = FOLLOWER
                r.offload.set_follower(self.cluster_id, r.term)

    def offload_read_confirm(self, low, high, term):
        self.log.append((self.cluster_id, "r", low, high, term))

    def offload_read_echo(self, from_, low, high):
        self.log.append((self.cluster_id, "e", from_, low, high))

    def offload_tick_elect(self):
        self.log.append((self.cluster_id, "te"))

    def offload_tick_heartbeat(self):
        self.log.append((self.cluster_id, "th"))

    def offload_tick_demote(self):
        self.log.append((self.cluster_id, "td"))


class LiveNode(StubNode):
    """The live stretch's node: commits and read confirms are applied and
    counted, tick flags dropped (the stretch checks watermarks and reads)."""

    __slots__ = ()

    def offload_commit(self, q):
        r = self.peer.raft
        if r.state == LEADER and q > r.committed:
            r.committed = min(q, r.last)

    def offload_read_confirm(self, low, high, term):
        self.log.append(low)

    def offload_read_echo(self, from_, low, high):
        self.log.append(-low)  # a ctx the device did not track: a miss

    def offload_tick_elect(self):
        pass

    def offload_tick_heartbeat(self):
        pass

    def offload_tick_demote(self):
        pass


def _timed_calls(obj, names, acc):
    """Wrap ``obj``'s methods ``names`` so each call's wall seconds add to
    ``acc[name]`` and its count to ``acc[name + "_calls"]`` (a timing
    wrapper of this script, not of the package)."""
    for name in names:
        fn = getattr(obj, name)
        acc.setdefault(name, 0.0)
        acc.setdefault(name + "_calls", 0)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[_name] += time.perf_counter() - t0
                acc[_name + "_calls"] += 1
        setattr(obj, name, timed)


class CoordSide:
    """One coordinator of the scripted rounds with its stub rafts."""

    def __init__(self, coord_mod, devsm_mod, dev, n):
        self.coord = coord_mod.QuorumCoordinator(
            capacity=n, n_peers=COORD_P, drive_ticks=True, drive_reads=True,
            telem=True, interval_s=60.0, device=dev)
        self.devsm_mod = devsm_mod
        self.log = []
        self.rafts = {}

    def warm(self):
        """Warm-up timed to its latch, then the devsm variants; then park
        the round thread so that ``flush()`` alone groups ops into rounds."""
        c = self.coord
        t0 = time.perf_counter()
        c.start_warmup().join()
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.eng.warmup_devsm(background=False)
        kv_s = time.perf_counter() - t0
        check(c.eng.fused_ready and c.eng.kv_fused_ready and
              c.warmup_stats["error"] is None, f"warm-up failed: {c.warmup_stats}")
        c.stop()
        return fused_s, kv_s

    def register(self, n, devsm_cids):
        c = self.coord
        for cid in range(1, n + 1):
            r = StubRaft(cid, cid % 3 == 0, c)
            self.rafts[cid] = r
            c.register(StubNode(r, self.log))
        plane = c.devsm_plane()
        for cid in devsm_cids:
            plane.register(cid, self.devsm_mod.DeviceKVStateMachine(cid, 1))
            with c._mu:
                plane.on_leader(cid, self.rafts[cid].last)

    def stage_round(self, rnd, plan):
        c, rafts = self.coord, self.rafts
        for cid in plan["writers"]:
            rafts[cid].write()
        encode = self.devsm_mod.encode_op
        for cid in plan["devsm"]:
            c.stage_sm_ops(cid, [(rafts[cid].last, encode((cid + rnd) % 16, rnd * 1000 + cid % 1000))])
        for cid in plan["reads"]:
            r = rafts[cid]
            low = (rnd + 1) * 1_000_000 + cid
            c.read_stage(cid, r.committed, low, cid, r.term)
            c.read_ack_hint(cid, 2, low, cid)
            c.read_ack_hint(cid, 3, low, cid)
        for cid in plan["stray_echoes"]:
            c.read_ack_hint(cid, 2, 999, cid)  # no slot holds it: scalar fallback
        for cid in plan["elect"]:
            rafts[cid].become_candidate()
            c.vote(cid, 1, True)
            c.vote(cid, 2, True)
            c.vote(cid, 3, True)
        for cid in plan["resync"]:
            c.membership_changed(cid)
        for _ in range(plan["ticks"]):
            c.request_tick()

    def tallies(self):
        c = self.coord
        return c.read_confirms, c.read_fallbacks, c.fused_dispatches


def _coord_plan(rnd, n, devsm):
    """Round ``rnd``'s script: every sixth round (r % 6 == 5) a tick
    backlog of 6 with writes and reads and no votes (the fused K3 path);
    r % 6 == 2 a quiet round of COORD_QUIET writers and nothing else (K2);
    the others every group's write, 1 in 8 groups' ReadIndex read, the
    devsm SETs, COORD_ELECT elections and COORD_RESYNC membership
    changes (K1 with its READS instance and the devsm kernel)."""
    quiet, backlog = rnd % 6 == 2, rnd % 6 == 5
    cids = np.arange(1, n + 1)
    readers = cids[(cids % 8 == rnd % 8) & ~np.isin(cids, devsm)]
    others = cids[(cids % 8 != rnd % 8) & ~np.isin(cids, devsm)]
    plan = {"devsm": [], "reads": [], "stray_echoes": [], "elect": [], "resync": [],
            "ticks": 6 if backlog else 1}
    if quiet:
        plan["writers"] = others[:COORD_QUIET].tolist()
        return plan
    elect = resync = np.zeros((0,), np.int64)
    if not backlog:
        at = (rnd * (COORD_ELECT + COORD_RESYNC)) % (others.size - COORD_ELECT - COORD_RESYNC)
        elect = others[at:at + COORD_ELECT]
        resync = others[at + COORD_ELECT:at + COORD_ELECT + COORD_RESYNC]
    plan["writers"] = cids[~np.isin(cids, elect)].tolist()
    plan["devsm"] = list(devsm)
    plan["reads"] = readers.tolist()
    plan["stray_echoes"] = readers[:8].tolist()
    plan["elect"] = elect.tolist()
    plan["resync"] = resync.tolist()
    return plan


def _same_sides(torch, a, b, tag):
    check(a.log == b.log, f"{tag}: the coordinators' effects differ "
          f"({len(a.log)} against {len(b.log)})")
    da, db = a.coord.eng.dev, b.coord.eng.dev
    for name in da._fields:
        check(torch.equal(getattr(da, name).cpu(), getattr(db, name).cpu()),
              f"{tag}: engine state {name} differs")
    check(a.tallies() == b.tallies(), f"{tag}: tallies {a.tallies()} against {b.tallies()}")
    ta, tb = a.coord.telem_snapshot(), b.coord.telem_snapshot()
    check((ta is None) == (tb is None), f"{tag}: one telemetry snapshot is missing")
    if ta is not None:
        for key in ta:
            check(key in ("seq", "mono") or ta[key] == tb[key],
                  f"{tag}: telemetry {key} differs")


def _live_stretch(torch, coord_mod, tk, dev, n=LIVE_G, seconds=LIVE_S):
    """Two coordinators of ``n`` groups in one process on the default
    stream, their round threads and warm-ups live: a driver thread stages
    writes (three acks each) and ReadIndex reads (two echoes each), a
    ticker calls ``request_tick`` every 2 ms.  Every group must end
    committed to its last acked index and every staged read confirmed."""
    import threading

    sides = []
    for _ in range(2):
        c = coord_mod.QuorumCoordinator(
            capacity=n, n_peers=COORD_P, drive_ticks=True, drive_reads=True,
            telem=True, interval_s=0.002, device=dev)
        confirmed = []
        rafts = [StubRaft(cid, False, c) for cid in range(1, n + 1)]
        for r in rafts:
            c.register(LiveNode(r, confirmed))
        sides.append((c, rafts, confirmed, []))
    warmers = [c.start_warmup() for c, *_ in sides]
    round_acc = [{} for _ in sides]
    for (c, *_), acc in zip(sides, round_acc):
        _timed_calls(c, ("_round",), acc)
    stop = threading.Event()
    errors = []

    def ticker():
        while not stop.wait(0.002):
            for c, *_ in sides:
                c.request_tick()

    def driver():
        """Waves of one write per group and a read on 1 group in 8; the
        next wave waits until both round threads drained this one (the
        flow control a raft's inflight window gives), so no group ever
        holds more pending reads than it has slots."""
        try:
            wave = 0
            while not stop.is_set():
                wave += 1
                for c, rafts, _, staged in sides:
                    for r in rafts:
                        r.write()
                        if (r.cluster_id + wave) % 8 == 0:
                            low = wave * 1_000_000 + r.cluster_id
                            c.read_stage(r.cluster_id, r.committed, low, r.cluster_id, r.term)
                            c.read_ack_hint(r.cluster_id, 2, low, r.cluster_id)
                            c.read_ack_hint(r.cluster_id, 3, low, r.cluster_id)
                            staged.append(low)
                for c, *_ in sides:
                    while c._staged and not stop.is_set():
                        time.sleep(0.0005)
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    base = [sum(r.committed for r in rafts) for _, rafts, _, _ in sides]
    threads = [threading.Thread(target=ticker), threading.Thread(target=driver)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    committed = [sum(r.committed for r in rafts) - b for (_, rafts, _, _), b in zip(sides, base)]
    reads = [len(conf) for _, _, conf, _ in sides]
    check(not errors, f"live stretch driver failed: {errors}")
    t_end = time.perf_counter()
    deadline = t_end + 60
    while time.perf_counter() < deadline:
        done = all(
            all(r.committed == r.last for r in rafts) and len(conf) == len(staged)
            for _, rafts, conf, staged in sides)
        if done:
            break
        for c, *_ in sides:
            c.flush()
    drain_s = time.perf_counter() - t_end
    for c, *_ in sides:
        c.stop()
    for t in warmers:
        t.join()
    out = {"groups_each": n, "seconds": elapsed, "drain_s": drain_s}
    for i, (c, rafts, conf, staged) in enumerate(sides):
        last = np.fromiter((r.last for r in rafts), np.int64, n)
        got = np.fromiter((r.committed for r in rafts), np.int64, n)
        check(np.array_equal(got, last),
              f"live stretch coordinator {i}: {int((got != last).sum())} groups "
              "short of their last acked index")
        check(sorted(conf) == sorted(staged),
              f"live stretch coordinator {i}: {len(conf)} reads confirmed of "
              f"{len(staged)} staged ({c.read_fallbacks} fell back)")
        writes = int(last.sum() - n)
        acc = round_acc[i]
        out[f"coord{i}"] = {
            "writes": writes, "reads": len(staged),
            # landed inside the stretch, and over the stretch and its drain
            "commits_per_s": committed[i] / elapsed, "reads_per_s": reads[i] / elapsed,
            "sustained_commits_per_s": writes / (elapsed + drain_s),
            "sustained_reads_per_s": len(staged) / (elapsed + drain_s),
            "rounds": acc["_round_calls"], "round_ms_mean": 1e3 * acc["_round"] / max(acc["_round_calls"], 1),
            "fused_dispatches": c.fused_dispatches, "read_fallbacks": c.read_fallbacks,
            "warmup": dict(c.warmup_stats),
        }
    return out


def phase_coordinator(torch, tk, dev, n=COORD_G, rounds=COORD_ROUNDS, live_n=LIVE_G,
                      live_s=LIVE_S):
    """The quorum coordinator at NodeHost's width: ``n`` groups x P = 8
    slots, 5 voters a group, device ticks, the read plane and the fold on,
    a third of the groups with the hier rule and COORD_DEVSM bound to the
    devsm plane.  (1) the warm-up, timed to its latch; (2) ``rounds``
    scripted rounds (``_coord_plan``) driven by ``flush()`` with the round
    thread parked, the same script fed to a CPU coordinator: after every
    flush every effect, every engine state tensor, the tallies and the
    telemetry snapshot equal; (3) the live stretch (``_live_stretch``);
    (4) the report: warm-up, flush p50/p99 with the engine's share, the
    drain and the rest (the fan-out), launches after the warm-up."""
    from dragonboat_tpu_torch import coordinator as coord_mod
    from dragonboat_tpu_torch import devsm as devsm_mod

    t_phase = time.perf_counter()
    cuda = CoordSide(coord_mod, devsm_mod, dev, n)
    cpu = CoordSide(coord_mod, devsm_mod, "cpu", n)
    warm = {"cuda": cuda.warm(), "cpu": cpu.warm()}
    stats = dict(cuda.coord.warmup_stats)
    after_warm = tk.launch_counts()
    devsm = list(range(7, n + 1, 24))[:COORD_DEVSM]
    t0 = time.perf_counter()
    for side in (cuda, cpu):
        side.register(n, devsm)
    register_s = time.perf_counter() - t0
    for side in (cuda, cpu):
        side.coord.flush()
    _same_sides(torch, cuda, cpu, "registration")
    cuda.log.clear()
    cpu.log.clear()
    acc = {"step": 0.0, "step_rounds": 0.0, "_drain_locked": 0.0}
    _timed_calls(cuda.coord.eng, ("step", "step_rounds"), acc)
    _timed_calls(cuda.coord, ("_drain_locked",), acc)
    flush_ms, engine_ms, drain_ms, stage_ms, staged_reads = [], [], [], [], 0
    for rnd in range(rounds):
        plan = _coord_plan(rnd, n, devsm)
        staged_reads += len(plan["reads"])
        for side in (cuda, cpu):
            t0 = time.perf_counter()
            side.stage_round(rnd, plan)
            if side is cuda:
                stage_ms.append((time.perf_counter() - t0) * 1e3)
                before = dict(acc)
                t0 = time.perf_counter()
                side.coord.flush()
                flush_ms.append((time.perf_counter() - t0) * 1e3)
                engine_ms.append((acc["step"] + acc["step_rounds"] - before["step"]
                                  - before["step_rounds"]) * 1e3)
                drain_ms.append((acc["_drain_locked"] - before["_drain_locked"]) * 1e3)
            else:
                side.coord.flush()
        _same_sides(torch, cuda, cpu, f"round {rnd}")
        cuda.log.clear()
        cpu.log.clear()
    # what the last round's fan-out staged (won elections' promotions)
    for side in (cuda, cpu):
        side.coord.flush()
    _same_sides(torch, cuda, cpu, "drain")
    counts = tk.launch_counts()
    scripted = {k: counts[k] - after_warm[k] for k in counts}
    for name in COORD_KERNELS:
        check(scripted[name] > 0, f"{name} never launched by the coordinator's rounds")
    c = cuda.coord
    lag = [cid for cid, r in cuda.rafts.items() if r.committed != r.last or r.state != LEADER]
    check(not lag, f"{len(lag)} groups not committed to their last index (e.g. {lag[:5]})")
    check(c.read_confirms == staged_reads,
          f"{c.read_confirms} reads confirmed of {staged_reads} staged")
    check(c.fused_dispatches >= rounds // 6, f"only {c.fused_dispatches} fused dispatches")
    plane = c.devsm
    check(len(plane._bound) == len(devsm) and plane.ops_staged > 0,
          f"devsm: {len(plane._bound)} of {len(devsm)} groups bound, "
          f"{plane.ops_staged} ops staged")
    fanout_ms = [f - e - d for f, e, d in zip(flush_ms, engine_ms, drain_ms)]
    scripted_s = time.perf_counter() - t_phase
    live = _live_stretch(torch, coord_mod, tk, dev, live_n, live_s)
    return {
        "phase": "coordinator", "groups": n, "peers": COORD_P, "voters": 5,
        "rounds": rounds,
        "warmup": {"fused_s_cuda": warm["cuda"][0], "devsm_s_cuda": warm["cuda"][1],
                   "fused_s_cpu": warm["cpu"][0], "devsm_s_cpu": warm["cpu"][1], **stats},
        "register_s_both": register_s,
        "stage_ms_p50": _p(stage_ms, 50), "flush_ms_p50": _p(flush_ms, 50),
        "flush_ms_p99": _p(flush_ms, 99), "flush_ms_max": max(flush_ms),
        "engine_ms_p50": _p(engine_ms, 50), "engine_ms_p99": _p(engine_ms, 99),
        "drain_ms_p50": _p(drain_ms, 50), "drain_ms_p99": _p(drain_ms, 99),
        "fanout_and_rest_ms_p50": _p(fanout_ms, 50), "fanout_and_rest_ms_p99": _p(fanout_ms, 99),
        "engine_share": sum(engine_ms) / sum(flush_ms),
        "flush_ms": flush_ms, "engine_ms": engine_ms, "drain_ms": drain_ms,
        "fused_dispatches": c.fused_dispatches, "read_confirms": c.read_confirms,
        "read_fallbacks": c.read_fallbacks, "devsm_bound": len(plane._bound),
        "devsm_ops_staged": plane.ops_staged, "scripted_launches": scripted,
        "scripted_s": scripted_s, "live": live,
    }


# ----------------------------------------------------------------------
# phase 14: the port's own Raft groups through the coordinator
# ----------------------------------------------------------------------

RAFT_G = 1_024         # BASELINE rung 1: 1,024 groups x 3 replicas
RAFT_HOSTS = 3
RAFT_ROUNDS = 24
RAFT_CMD = 16          # BASELINE rung 1's 16-byte proposals
RAFT_QUIET = 16        # writers of a quiet round (K2)
RAFT_TICKS = 3         # host ticks a round while groups elect
RAFT_KERNELS = STEP_KERNELS + ("read_plane", "finish_hier", "telem_fold")


class RaftNode:
    """This script's stand-in for a replica's node over a port ``Peer``.

    Copies the Raft-facing part of ``dragonboat_tpu/node.py:308-470``: the
    coordinator's ``offload_*`` hooks only flag an effect, and ``apply``
    takes the flags and applies them with ``_apply_offload_effects``'s
    scalar guards in its order: ``log.try_commit(q, term)`` on a leader,
    then ``broadcast_replicate_message``; the term-pinned read releases;
    the echo fallback; the election under ``hier_election_ok``; the tick
    flags.  Every raft is ticked every host tick, so the node's catch-up
    tick has nothing to do here."""

    def __init__(self, wire, peer):
        self.wire = wire
        self.peer = peer
        self.cluster_id = peer.raft.cluster_id
        self.node_id = peer.raft.node_id
        self.raft_mu = contextlib.nullcontext()
        self.effects = []
        self._commit = 0
        self._election = None
        self._hb = self._elect = self._demote = False
        self._reads = []
        self._echoes = []

    def offload_commit(self, q, wake=True):
        self.effects.append(("commit", q))
        self._commit = max(self._commit, q)

    def offload_election(self, won, term, wake=True):
        self.effects.append(("election", won, term))
        self._election = (won, term)

    def offload_read_confirm(self, low, high, term, wake=True):
        self.effects.append(("read", low, high, term))
        self._reads.append((low, high, term))

    def offload_read_echo(self, from_, low, high, wake=True):
        self.effects.append(("echo", from_, low, high))
        self._echoes.append((from_, low, high))

    def offload_tick_elect(self, wake=True):
        self.effects.append(("elect",))
        self._elect = True

    def offload_tick_heartbeat(self, wake=True):
        self.effects.append(("heartbeat",))
        self._hb = True

    def offload_tick_demote(self, wake=True):
        self.effects.append(("demote",))
        self._demote = True

    def pending(self):
        return bool(self._commit or self._election or self._hb or self._elect
                    or self._demote or self._reads or self._echoes)

    def apply(self):
        w, r = self.wire, self.peer.raft
        MT = w.MessageType
        commit_q, self._commit = self._commit, 0
        election, self._election = self._election, None
        hb, self._hb = self._hb, False
        elect, self._elect = self._elect, False
        demote, self._demote = self._demote, False
        reads, self._reads = self._reads, []
        echoes, self._echoes = self._echoes, []
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
        if (elect and r.device_ticks and not r.is_leader() and not r.is_observer()
                and not r.is_witness() and not r.self_removed()
                and r.time_for_election()):
            r.election_tick = 0
            r.handle(w.Message(from_=self.node_id, type=MT.ELECTION))
        if hb and r.device_ticks and r.is_leader():
            r.heartbeat_tick = 0
            r.handle(w.Message(from_=self.node_id, type=MT.LEADER_HEARTBEAT))
        if demote and r.device_ticks and r.is_leader() and r.check_quorum:
            r.election_tick = 0
            r.handle(w.Message(from_=self.node_id, type=MT.CHECK_QUORUM))


class RaftDeployment:
    """``RAFT_HOSTS`` hosts, each with a replica of every group and its own
    coordinator on ``dev``; messages cross hosts as the port's wire bytes,
    encoded by the sender and decoded by the receiver.  ``acc`` gathers the
    host time of each layer (a timing wrapper of this script): ``raft`` the
    Raft step and the update cycle (deliveries, ticks, proposals, reads),
    ``codec`` every encode and decode, ``flush`` the coordinators'
    ``flush()`` (``engine_acc``: its engine calls), ``apply`` the effects'
    application and the update cycle it starts; the codec time inside the
    others is taken out of them."""

    def __init__(self, coord_mod, raft_mod, config_mod, wire, dev, n, seed):
        self.wire, self.codec = wire, wire.codec
        self.n = n
        self.acc = dict.fromkeys(("raft", "codec", "flush", "apply"), 0.0)
        self.engine_acc = {}
        self.coords = [coord_mod.QuorumCoordinator(
            capacity=n, n_peers=COORD_P, drive_ticks=True, drive_reads=True,
            telem=True, interval_s=60.0, device=dev) for _ in range(RAFT_HOSTS)]
        # the warm-up, timed to the latches; then the round threads are
        # parked before any raft stages, so flush() alone groups ops into
        # rounds and the card and the CPU see the same rounds
        t0 = time.perf_counter()
        for t in [c.start_warmup() for c in self.coords]:
            t.join()
        self.warmup_s = time.perf_counter() - t0
        for c in self.coords:
            check(c.eng.fused_ready and c.warmup_stats["error"] is None,
                  f"warm-up failed: {c.warmup_stats}")
            c.stop()
            _timed_calls(c.eng, ("step", "step_rounds"), self.engine_acc)
        self.nodes = [dict() for _ in range(RAFT_HOSTS)]
        self.logdbs = [dict() for _ in range(RAFT_HOSTS)]
        self.applied = [dict() for _ in range(RAFT_HOSTS)]
        self.queue = []   # (from host, to host, bytes)
        self.cut = set()  # (from host, to host) pairs that lose every message
        self.reads = {}   # ctx low -> cid; released reads leave it
        self.released = 0
        addrs = [raft_mod.PeerAddress(h + 1, f"host{h + 1}") for h in range(RAFT_HOSTS)]
        for cid in range(1, n + 1):
            hier = cid % 3 == 0
            for h in range(RAFT_HOSTS):
                cfg = config_mod.Config(
                    node_id=h + 1, cluster_id=cid, election_rtt=10, heartbeat_rtt=1,
                    check_quorum=cid % 4 == 0, hier_commit=hier,
                    hier_domains={1: "a", 2: "a", 3: "b"} if hier else {})
                logdb = raft_mod.InMemLogDB()
                p = raft_mod.Peer.launch(cfg, logdb, None, addrs, initial=True,
                                         new_node=True, seed=seed * 65_536 + cid * 8 + h)
                node = RaftNode(wire, p)
                self.nodes[h][cid], self.logdbs[h][cid] = node, logdb
                self.applied[h][cid] = 0
                p.raft.offload = self.coords[h]
                p.raft.device_ticks = True
                self.coords[h].register(node)
                self.process(h, cid)

    def engine_s(self):
        return self.engine_acc.get("step", 0.0) + self.engine_acc.get("step_rounds", 0.0)

    def rafts(self):
        for h in range(RAFT_HOSTS):
            for cid, node in self.nodes[h].items():
                yield h, cid, node.peer.raft

    def process(self, h, cid):
        """The node's update cycle on one replica: save, send, apply."""
        w, codec = self.wire, self.codec
        p, logdb = self.nodes[h][cid].peer, self.logdbs[h][cid]
        while p.has_update(True):
            ud = p.get_update(True, self.applied[h][cid])
            check(w.is_empty_snapshot(ud.snapshot), f"group {cid}: an unexpected snapshot")
            if ud.entries_to_save:
                logdb.append(ud.entries_to_save)
                logdb.max_index = ud.entries_to_save[-1].index
            if not w.is_empty_state(ud.state):
                logdb.set_state(ud.state)
            t0 = time.perf_counter()
            out = [(h, m.to - 1, codec.encode_message(m)) for m in ud.messages]
            self.acc["codec"] += time.perf_counter() - t0
            self.queue.extend(out)
            for rtr in ud.ready_to_reads:
                if self.reads.pop(rtr.system_ctx.low, None) == cid:
                    self.released += 1
            for ctx in ud.dropped_read_indexes:
                # a leader with no commit in its term yet drops a read; the
                # client asks again at the next round's leader
                self.reads[ctx.low] = -cid
            p.commit(ud)
            applied = self.applied[h][cid]
            for e in ud.committed_entries:
                if e.index > applied:
                    if e.type == w.EntryType.CONFIG_CHANGE:
                        p.apply_config_change(codec.decode_config_change(e.cmd))
                    applied = e.index
            if applied != self.applied[h][cid]:
                self.applied[h][cid] = applied
                p.notify_raft_last_applied(applied)

    def deliver_all(self):
        codec, acc = self.codec, self.acc
        while self.queue:
            batch, self.queue = self.queue, []
            for frm, to, data in batch:
                if (frm, to) in self.cut:
                    continue
                t0 = time.perf_counter()
                m = codec.decode_message(data)
                acc["codec"] += time.perf_counter() - t0
                with self.timed("raft"):
                    self.nodes[to][m.cluster_id].peer.handle(m)
                    self.process(to, m.cluster_id)

    @contextlib.contextmanager
    def timed(self, layer):
        """Add the block's host time to ``layer``, less the codec time
        spent inside it."""
        acc = self.acc
        c0, t0 = acc["codec"], time.perf_counter()
        try:
            yield
        finally:
            acc[layer] += time.perf_counter() - t0 - (acc["codec"] - c0)

    def tick(self, count):
        with self.timed("raft"):
            for h in range(RAFT_HOSTS):
                for _ in range(count):
                    for node in self.nodes[h].values():
                        node.peer.tick()
                    self.coords[h].request_tick()
                for cid in self.nodes[h]:
                    self.process(h, cid)

    def flush(self):
        for h in range(RAFT_HOSTS):
            with self.timed("flush"):
                self.coords[h].flush()
            with self.timed("apply"):
                for cid, node in self.nodes[h].items():
                    if node.pending():
                        node.apply()
                        self.process(h, cid)

    def propose(self, h, cid, cmd):
        with self.timed("raft"):
            self.nodes[h][cid].peer.propose_entries([self.wire.Entry(cmd=cmd)])
            self.process(h, cid)

    def read(self, h, cid, low):
        with self.timed("raft"):
            self.reads[low] = cid
            self.nodes[h][cid].peer.read_index(self.wire.SystemCtx(low=low, high=cid))
            self.process(h, cid)

    def isolate(self, h):
        self.cut = {(a, b) for a in range(RAFT_HOSTS) for b in range(RAFT_HOSTS)
                    if a != b and h in (a, b)}

    def leaders(self):
        """cid -> host of the leader at the highest term."""
        best = {}
        for h, cid, r in self.rafts():
            if r.is_leader() and (cid not in best or r.term > best[cid][1]):
                best[cid] = (h, r.term)
        return {cid: h for cid, (h, _) in best.items()}

    def settled(self):
        """Every group has one leader that every replica follows."""
        lead = self.leaders()
        return len(lead) == self.n and all(
            self.nodes[h][cid].peer.raft.leader_id == lead[cid] + 1
            for cid in lead for h in range(RAFT_HOSTS))

    def view(self):
        """What the card and the CPU must agree on after a round."""
        rafts = []
        for h, cid, r in self.rafts():
            rafts.append((h, cid, int(r.term), int(r.vote), int(r.state), int(r.leader_id),
                          int(r.log.committed), int(r.log.last_index()), log_sig(r)))
        effects = [(h, cid, tuple(n.effects)) for h in range(RAFT_HOSTS)
                   for cid, n in self.nodes[h].items()]
        tallies = [(c.read_confirms, c.read_fallbacks, c.fused_dispatches)
                   for c in self.coords]
        return rafts, effects, tallies

    def clear_effects(self):
        for h in range(RAFT_HOSTS):
            for node in self.nodes[h].values():
                node.effects.clear()


def log_sig(r):
    """``(index, term)`` of every entry in the raft's log view."""
    lo, hi = r.log.first_index(), r.log.last_index()
    if hi < lo:
        return ()
    return tuple((e.index, e.term) for e in r.log.get_entries(lo, hi + 1, 1 << 62))


def _same_deployments(torch, a, b, tag):
    va, vb = a.view(), b.view()
    check(va[0] == vb[0], f"{tag}: the rafts differ")
    check(va[1] == vb[1], f"{tag}: the coordinators' effects differ")
    check(va[2] == vb[2], f"{tag}: tallies {va[2]} against {vb[2]}")
    check(a.queue == b.queue and a.reads == b.reads, f"{tag}: the wires differ")
    for h, (ca, cb) in enumerate(zip(a.coords, b.coords)):
        ea, eb = ca.eng, cb.eng
        check(ea._dirty == eb._dirty, f"{tag}: host {h} engine rows staged differ")
        for name in ea.dev._fields:
            check(torch.equal(getattr(ea.dev, name).cpu(), getattr(eb.dev, name).cpu()),
                  f"{tag}: host {h} engine state {name} differs")
            check(np.array_equal(ea.mirror.arrays[name], eb.mirror.arrays[name]),
                  f"{tag}: host {h} engine mirror {name} differs")
        ta, tb = ca.telem_snapshot(), cb.telem_snapshot()
        check((ta is None) == (tb is None), f"{tag}: a telemetry snapshot is missing")
        if ta is not None:
            for key in ta:
                check(key in ("seq", "mono") or ta[key] == tb[key],
                      f"{tag}: host {h} telemetry {key} differs")
    a.clear_effects()
    b.clear_effects()


def phase_raft(torch, tk, dev, n=RAFT_G, rounds=RAFT_ROUNDS, seed=14):
    """The port's own Raft groups (``dragonboat_tpu_torch.raft``) at BASELINE
    rung 1: ``n`` groups x 3 replicas on 3 hosts, each host's replicas
    staging into its own coordinator (``n`` rows x P = 8, device ticks, the
    read plane and the fold on; the hier rule on a third of the groups),
    every message through the port's wire codec.  A CPU deployment runs the
    same script; after every round the two agree in every raft, effect,
    engine tensor, tally and telemetry snapshot.  (1) warm-up, timed to its
    latch; (2) election from followers only, by device ticks; (3)
    ``rounds`` rounds: every leader proposes one 16-byte entry (a quiet
    round: RAFT_QUIET leaders), 1 group in 8 reads through ReadIndex, a
    tick backlog of 6 every sixth round; (4) host 1 cut off until its
    leaders' groups elect on hosts 2 and 3, then healed until it follows.
    Every group must end with one leader, every acknowledged write
    committed on all 3 replicas with equal logs, every read released."""
    from dragonboat_tpu_torch import config as config_mod
    from dragonboat_tpu_torch import coordinator as coord_mod
    from dragonboat_tpu_torch import raft as raft_mod
    from dragonboat_tpu_torch import wire

    t_phase = time.perf_counter()
    sides = []
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        sides.append(RaftDeployment(coord_mod, raft_mod, config_mod, wire, d, n, seed))
        sides[-1].setup_s = time.perf_counter() - t0
    card, cpu = sides
    for side in sides:
        side.flush()
    _same_deployments(torch, card, cpu, "registration")
    round_ms, split = [], {k: [] for k in ("raft", "codec", "flush", "engine", "apply")}
    state = {"rounds": 0}
    after_warm = tk.launch_counts()

    def layer_marks():
        return dict(card.acc, engine=card.engine_s())

    def one_round(tag, ticks=1, staged_s=0.0, marks=None):
        """One round on both deployments; the card's wall time and its
        split by layer, from ``marks`` on (the staging before the round,
        ``staged_s`` seconds of it, counts in)."""
        marks = marks or layer_marks()
        for side in sides:
            t0 = time.perf_counter()
            side.deliver_all()
            side.tick(ticks)
            side.deliver_all()
            side.flush()
            side.deliver_all()
            if side is card:
                round_ms.append((time.perf_counter() - t0 + staged_s) * 1e3)
        for k in split:
            now = card.engine_s() if k == "engine" else card.acc[k]
            split[k].append((now - marks[k]) * 1e3)
        state["rounds"] += 1
        _same_deployments(torch, card, cpu, f"{tag} round {state['rounds']}")

    # election from followers only, by device ticks
    t0 = time.perf_counter()
    for _ in range(60):
        one_round("election", ticks=RAFT_TICKS)
        if card.settled():
            break
    check(card.settled(), f"{n - len(card.leaders())} groups without a leader")
    election = {"rounds": state["rounds"], "seconds": time.perf_counter() - t0,
                "terms": sorted({int(r.term) for _, _, r in card.rafts()})}
    # writes and reads
    n0 = state["rounds"]
    reads_before = card.released
    acked = 0
    for rnd in range(rounds):
        quiet, backlog = rnd % 6 == 2, rnd % 6 == 5
        lead = card.leaders()
        cids = sorted(lead)[:RAFT_QUIET] if quiet else sorted(lead)
        marks = layer_marks()
        for side in sides:
            t0 = time.perf_counter()
            for cid in cids:
                side.propose(lead[cid], cid, bytes([rnd]) * 8 + cid.to_bytes(8, "little"))
            if not quiet:
                for low, cid in sorted(side.reads.items()):
                    if cid < 0:  # dropped: ask the group's leader again
                        side.read(lead[-cid], -cid, low)
                for cid in cids:
                    if cid % 8 == rnd % 8:
                        side.read(lead[cid], cid, (rnd + 1) * 1_000_000 + cid)
            if side is card:
                staged_s = time.perf_counter() - t0
        acked += len(cids)
        one_round("writes", ticks=6 if backlog else 1, staged_s=staged_s, marks=marks)
    for _ in range(4):  # the last round's commits and reads land
        if not card.reads and all(r.log.committed == r.log.last_index()
                                  for _, _, r in card.rafts()):
            break
        one_round("writes-drain")
    write_rounds = state["rounds"] - n0
    writes_s = sum(round_ms[n0:]) / 1e3  # the card's deployment alone
    reads_released = card.released - reads_before
    check(not card.reads, f"{len(card.reads)} reads not released")
    after_writes = {cid: (h, card.nodes[h][cid].peer.raft.log.committed)
                    for cid, h in card.leaders().items()}
    # host 1 cut off, its leaders' groups elect again on hosts 2 and 3
    lost = 0
    moved = [cid for cid, h in card.leaders().items() if h == lost]
    check(moved, "host 1 leads no group")
    for side in sides:
        side.isolate(lost)
    n1 = state["rounds"]
    for _ in range(40):
        one_round("partition", ticks=RAFT_TICKS)
        lead = card.leaders()
        if all(lead.get(cid) not in (None, lost) for cid in moved):
            break
    lead = card.leaders()
    check(all(lead.get(cid) not in (None, lost) for cid in moved),
          f"{sum(lead.get(c) in (None, lost) for c in moved)} of {len(moved)} "
          "groups did not elect on hosts 2 and 3")
    for side in sides:
        for cid in moved:
            side.propose(lead[cid], cid, b"partition" + cid.to_bytes(7, "little"))
    acked += len(moved)
    one_round("partition")
    partition_rounds = state["rounds"] - n1
    for side in sides:
        side.cut = set()
    n2 = state["rounds"]
    for _ in range(60):
        one_round("heal", ticks=RAFT_TICKS)
        if card.settled() and all(r.log.committed == r.log.last_index()
                                  for _, _, r in card.rafts()):
            break
    heal_rounds = state["rounds"] - n2
    # every group: one leader, every acked write committed on all replicas
    check(card.settled(), "groups without a leader that all replicas follow after the heal")
    for cid in range(1, n + 1):
        sigs = {log_sig(card.nodes[h][cid].peer.raft) for h in range(RAFT_HOSTS)}
        commits = {card.nodes[h][cid].peer.raft.log.committed for h in range(RAFT_HOSTS)}
        check(len(sigs) == 1 and len(commits) == 1,
              f"group {cid}: replicas disagree after the heal")
        r = card.nodes[0][cid].peer.raft
        check(r.log.committed == r.log.last_index(), f"group {cid}: entries not committed")
        h, q = after_writes[cid]
        check(r.log.committed >= q, f"group {cid}: acknowledged writes lost")
    counts = tk.launch_counts()
    scripted = {k: counts[k] - after_warm[k] for k in counts}
    for name in RAFT_KERNELS:
        check(scripted[name] > 0, f"{name} never launched by the raft rounds")
    cmds = 0
    for cid in range(1, n + 1):
        r = card.nodes[0][cid].peer.raft
        cmds += sum(1 for e in r.log.get_entries(r.log.first_index(), r.log.last_index() + 1,
                                                  1 << 62) if len(e.cmd) == RAFT_CMD)
    check(cmds == acked, f"{cmds} 16-byte entries committed of {acked} proposed")
    acc = card.acc
    total = sum(round_ms) / 1e3
    return {
        "phase": "raft", "groups": n, "replicas": RAFT_HOSTS, "peers": COORD_P,
        "rounds": state["rounds"], "setup_s": card.setup_s, "setup_s_cpu": cpu.setup_s,
        "warmup_s": card.warmup_s, "warmup_s_cpu": cpu.warmup_s,
        "warmup": dict(card.coords[0].warmup_stats),
        "election": election, "write_rounds": write_rounds,
        "partition_rounds": partition_rounds, "heal_rounds": heal_rounds,
        "moved_groups": len(moved),
        "round_ms_p50": _p(round_ms, 50), "round_ms_p99": _p(round_ms, 99),
        **{f"{k}_ms_p50": _p(v, 50) for k, v in split.items()},
        **{f"{k}_ms_p99": _p(v, 99) for k, v in split.items()},
        "share": {k: sum(v) / 1e3 / total for k, v in split.items()},
        "host_s": {k: acc[k] for k in acc}, "round_ms": round_ms,
        "committed_writes": acked,
        "committed_writes_per_s": acked / writes_s if writes_s else None,
        "reads_released": reads_released,
        "confirmed_reads_per_s": reads_released / writes_s if writes_s else None,
        "writes_s": writes_s,
        "read_confirms": [c.read_confirms for c in card.coords],
        "read_fallbacks": [c.read_fallbacks for c in card.coords],
        "fused_dispatches": [c.fused_dispatches for c in card.coords],
        "scripted_launches": scripted,
        "seconds": time.perf_counter() - t_phase,
    }


def _registers(log):
    """The most registers any instance of each source uses (nvcc's
    ``-Xptxas -v`` report, kept by the build)."""
    out, src = {}, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "Used" in ln and "registers" in ln:
            n = int(ln.split("Used")[1].split("registers")[0])
            out[src] = max(out.get(src, 0), n)
    return out


def _frames(log):
    """Per source, the largest stack frame and the most spill bytes (stores
    plus loads) of any instance (``-Xptxas -v``)."""
    out, src = {}, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "stack frame" in ln and "spill" in ln:
            parts = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            stack, spill = parts[0], parts[1] + parts[2]
            cur = out.setdefault(src, {"stack_bytes": 0, "spill_bytes": 0})
            cur["stack_bytes"] = max(cur["stack_bytes"], stack)
            cur["spill_bytes"] = max(cur["spill_bytes"], spill)
    return out


def main(argv) -> int:
    import torch

    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only":
            print("usage: chip_smoke.py [--only NAME[,NAME...]]", file=sys.stderr)
            return 2
        only = set(argv[1].split(","))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dragonboat_tpu_torch.ops import _build
        from dragonboat_tpu_torch.ops import engine as engine_mod
        from dragonboat_tpu_torch.ops import kernels as tk
        from dragonboat_tpu_torch.ops import state as ts
        from dragonboat_tpu_torch import ladder as ladder_mod
    except ImportError as e:
        print(f"chip_smoke: the dragonboat_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        _build.library()
        info = dict(_build.build_info)
        log = info.pop("log", "")
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "compiled": info.get("compiled"),
              "source_seconds": info.get("source_seconds"),
              "registers_max": _registers(log), "frames": _frames(log)})
        emit(int32_peak(torch))
        ran = set()
        if only is None or "kernels" in only:
            t0 = time.perf_counter()
            timings = phase_kernels(torch, ts, tk, dev, ladder_mod)
            emit({"phase": "kernels_seconds", "seconds": time.perf_counter() - t0})
            ran.add("kernels")
        launches = dict.fromkeys(TPU_KERNELS, 0)

        def main_path(label, run, kernels):
            """One main path's run, its launch counts zeroed just before
            and read just after; each of ``kernels`` must have launched."""
            if only is not None and label not in only:
                return None
            ran.add(label)
            tk.reset_launch_counts()
            t_path = time.perf_counter()
            out = run()
            counts = tk.launch_counts()
            emit({"phase": "launches", "path": label, **counts,
                  "seconds": time.perf_counter() - t_path})
            for name in kernels:
                check(counts[name] > 0, f"{name} never launched on the {label} path")
            if only is None:
                for name in launches:
                    launches[name] += counts[name]
            return out

        rung5 = main_path("rung5", lambda: phase_rung5(torch, engine_mod, tk, dev),
                          ("quorum_multiround",))
        main_path("op_script", lambda: phase_ops(torch, engine_mod, dev),
                  STEP_KERNELS)
        main_path("rung5_hier_telem", lambda: phase_rung5_hier_telem(
            torch, engine_mod, tk, ts, dev, rung5),
            ("quorum_multiround", "finish_hier", "telem_fold"))
        main_path("rung5_again", lambda: phase_rung5(
            torch, engine_mod, tk, dev, label="rung5_again"),
            ("quorum_multiround",))
        main_path("op_script_hier_telem",
                  lambda: phase_ops(torch, engine_mod, dev, hier_telem=True),
                  STEP_KERNELS + ("finish_hier", "telem_fold"))
        main_path("rung4", lambda: phase_rung4(torch, engine_mod, tk, ts, dev),
                  ("quorum_multiround", "read_plane"))
        main_path("read_op_script", lambda: phase_read_ops(torch, engine_mod, dev),
                  STEP_KERNELS + ("finish_hier", "telem_fold", "read_plane"))
        main_path("rung4_devsm", lambda: phase_rung4_devsm(torch, engine_mod, tk, ts, dev),
                  ("quorum_multiround", "kv_plane"))
        main_path("devsm_op_script", lambda: phase_devsm_ops(torch, engine_mod, dev),
                  STEP_KERNELS + ("finish_hier", "telem_fold", "kv_plane"))
        main_path("ladder", lambda: phase_ladder(ladder_mod, dev),
                  ("staged_multistep", "quorum_multiround"))
        main_path("multistep", lambda: phase_multistep(torch, engine_mod, tk, ts, dev),
                  MULTISTEPS)
        main_path("coordinator", lambda: emit(phase_coordinator(torch, tk, dev)),
                  COORD_KERNELS)
        main_path("raft", lambda: emit(phase_raft(torch, tk, dev)), RAFT_KERNELS)
        if only is not None:
            check(only <= ran, f"no main path named {sorted(only - ran)}")
            emit({"phase": "done", "seconds": time.perf_counter() - t_start})
            return 0
        emit({"phase": "launches", "path": "all", **launches})
        for name, n in launches.items():
            check(n > 0, f"{name} never launched on the main path")
        kernels = [{
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": timings[name]["max_abs_err"],
            "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"],
            "bound_ms": timings[name]["bound_ms"], "bound_by": timings[name]["bound_by"],
            "library_ms": None,
        } for name, (src, replaces) in TPU_KERNELS.items()]
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
