"""The device ladder of the write path: writes/s of the batched quorum
engine at a group count, pipelined, latency-bounded and through the host
loop.

Counterparts in ``bench.py`` (which this module does not import):

* :func:`build_state` — ``build_state`` (:116): an engine whose groups
  all lead with three voters;
* :func:`run_mode` — ``_run_mode`` (:193): the **pipelined** mode (G
  groups each commit one write a round, R rounds in one dispatch whose
  acks are made on the device: :func:`~.ops.kernels.staged_multistep`, the
  port of ``_staged_multistep_fn`` :131) and, with R = 1, the
  **latency-bounded** mode;
* :func:`run_host_loop` — ``_run_host_loop`` (:274): the engine's own
  ingest path, ``ack_block_rounds`` and one fused K-round
  ``step_rounds(pipelined=True)`` a dispatch.

The pipelined figure counts device-synthesised acks: no ack crosses from
the host, so it measures the device round loop and one watermark readback
a dispatch, not the host's ingest; the host loop measures that.  The
reference's CPU fallback, TPU probes, watchdogs and end-to-end arms have
no counterpart: ``device=None`` means CUDA and raises without it, and
``device="cpu"`` runs the plain PyTorch versions.
"""
from __future__ import annotations

import time

import numpy as np

from .ops.engine import BatchedQuorumEngine
from .ops.kernels import staged_multistep

N_PEERS = 3


def build_state(n_groups: int, event_cap: int, n_peers: int = N_PEERS,
                device_ticks: bool = True, device=None) -> BatchedQuorumEngine:
    """An engine of ``n_groups`` groups, each led by node 1 of
    ``n_peers`` voters at term 1 with its log at index 1, uploaded to the
    device (one ``add_group`` and one ``set_leader`` a group)."""
    eng = BatchedQuorumEngine(n_groups, n_peers, event_cap=event_cap,
                              device_ticks=device_ticks, device=device)
    peers = list(range(1, n_peers + 1))
    for cid in range(1, n_groups + 1):
        eng.add_group(cid, node_ids=peers, self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    eng._upload_dirty()
    return eng


def _check_watermarks(committed: np.ndarray, base: int, what: str) -> None:
    bad = np.flatnonzero(committed != base)
    if bad.size:
        raise RuntimeError(
            f"{what}: {bad.size} rows' watermarks differ from {base} "
            f"(row {bad[0]}: {committed[bad[0]]})"
        )


def run_mode(n_groups: int, rounds: int, dispatches: int, warmup: int = 3,
             device=None) -> dict:
    """One operating point of the pipelined ladder: ``warmup`` then
    ``dispatches`` dispatches of ``rounds`` rounds each.  A dispatch
    launches :func:`staged_multistep` and reads the watermarks back to the
    host, which waits for it.  Every row's watermark must equal the write
    count so far after every dispatch (checked after the timed window).
    Returns writes/s over the measured dispatches, each dispatch's wall
    time in ms, and the seconds :func:`build_state` took, outside the
    timed window."""
    t0 = time.perf_counter()
    # event_cap matters only for the engine's own sparse staging, which
    # the staged dispatch does not use
    eng = build_state(n_groups, 64, device=device)
    setup_s = time.perf_counter() - t0
    st = eng.dev

    def dispatch(base):
        t = time.perf_counter()
        out = staged_multistep(st, base, rounds)
        committed = out.committed.to("cpu", copy=True).numpy()  # egress, blocks
        return committed, time.perf_counter() - t

    base = 1
    seen = []
    for _ in range(warmup):
        committed, _ = dispatch(base)
        base += rounds
        seen.append((committed, base))
    times = []
    t0 = time.perf_counter()
    for _ in range(dispatches):
        committed, dt = dispatch(base)
        times.append(dt)
        base += rounds
        seen.append((committed, base))
    elapsed = time.perf_counter() - t0
    for i, (committed, expect) in enumerate(seen):
        _check_watermarks(committed, expect, f"run_mode dispatch {i}")
    return {
        "groups": n_groups, "rounds_per_dispatch": rounds,
        "dispatches": dispatches, "warmup": warmup,
        "writes_per_sec": n_groups * rounds * dispatches / elapsed,
        "dispatch_ms": [t * 1e3 for t in times],
        "setup_s": setup_s,
    }


def run_host_loop(n_groups: int, rounds: int, k: int = 16, device=None) -> dict:
    """The engine's ingest path: per scanned round every group's leader
    self-ack and one follower ack are staged in one ``ack_block_rounds``
    call a block, and ONE ``step_rounds`` dispatch scans the ``k`` rounds
    (host clocks: no device ticks).  Staging of block i+1 overlaps block
    i in flight (``pipelined=True``).  ``rounds`` counts dispatches after
    one warm-up block; every row's final watermark must equal the write
    count.  Returns writes/s, each dispatch's host time (staging and
    launch) in ms, and the setup seconds."""
    if rounds < 1 or n_groups < 1 or k < 1:
        raise ValueError(f"invalid parameters: groups={n_groups} rounds={rounds} k={k}")
    t0 = time.perf_counter()
    eng = build_state(n_groups, 2 * n_groups, device_ticks=False, device=device)
    setup_s = time.perf_counter() - t0
    rows = np.tile(np.arange(n_groups, dtype=np.int32), 2)
    slots = np.concatenate([np.zeros(n_groups, np.int32), np.ones(n_groups, np.int32)])

    def stage_block(base):
        # K rounds in one validated staging call: the same (row, slot)
        # geometry every round, advancing rel indexes
        rels = (base + 1 + np.arange(k, dtype=np.int32)[:, None]
                + np.zeros((1, rows.size), np.int32))
        eng.ack_block_rounds(rows, slots, rels)

    base = 1
    stage_block(base)  # warm-up block
    eng.step_rounds(do_tick=False)
    base += k
    times = []
    t0 = time.perf_counter()
    for _ in range(rounds):
        t = time.perf_counter()
        stage_block(base)
        # returns the PREVIOUS block's egress; this block stays in flight
        eng.step_rounds(do_tick=False, pipelined=True)
        times.append((time.perf_counter() - t) * 1e3)
        base += k
    eng.harvest()
    view = eng.committed_view()
    elapsed = time.perf_counter() - t0
    _check_watermarks(view, base, "run_host_loop")
    return {
        "groups": n_groups, "rounds": rounds, "rounds_per_dispatch": k,
        "writes_per_sec": n_groups * rounds * k / elapsed,
        "dispatch_ms": times, "setup_s": setup_s,
    }
