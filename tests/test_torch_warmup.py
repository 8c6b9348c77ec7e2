"""The port engine's warm-up against the JAX package's, on the CPU.

``warm_plan``, ``k_bucket`` and ``variant_label`` must equal the
reference's; a warm-up launches every variant of the plan once on a
throwaway state (the plain versions on the CPU) and only then sets the
``fused_ready`` latch; a failing or cancelled warm-up leaves the latch
unset, records why, and the coordinator keeps committing on the
single-round path.  The twins of ``tests/test_warmup.py:83`` and ``:172``
(without its observability assertions) and ``tests/test_live_fused.py``
run on both packages and compare their results in the same run.
"""
from __future__ import annotations

import threading

import pytest
import torch

pytest.importorskip("jax")

from dragonboat_tpu.ops import engine as jeng  # noqa: E402
from dragonboat_tpu.raft import InMemLogDB  # noqa: E402
from dragonboat_tpu.wire import Entry  # noqa: E402
from dragonboat_tpu_torch.ops import engine as peng  # noqa: E402
from tests.raft_harness import new_test_raft  # noqa: E402
from tests.test_torch_coordinator import FakeNode, _coord  # noqa: E402

torch.set_num_threads(1)


def _engines(n=16, p=4, cap=64):
    return (peng.BatchedQuorumEngine(n, p, event_cap=cap, device="cpu"),
            jeng.BatchedQuorumEngine(n, p, event_cap=cap))


def test_k_bucket_matches_reference():
    assert peng.WARM_K_BUCKETS == jeng.WARM_K_BUCKETS
    for k in range(0, 40):
        assert peng.k_bucket(k) == jeng.k_bucket(k), k
    assert peng.k_bucket(5, (2, 8)) == jeng.k_bucket(5, (2, 8))


@pytest.mark.parametrize("include_kv", [False, True], ids=["nokv", "kv"])
@pytest.mark.parametrize("include_single", [False, True], ids=["fused", "single"])
@pytest.mark.parametrize("include_reads", [False, True], ids=["noreads", "reads"])
@pytest.mark.parametrize("k_buckets", [(4, 16), (4,), (16, 4, 4), (1, 2, 8)],
                         ids=["default", "k4", "dup", "k128"])
def test_warm_plan_matches_reference(k_buckets, include_reads, include_single,
                                     include_kv):
    pe, je = _engines()
    kw = dict(include_reads=include_reads, include_single=include_single,
              include_kv=include_kv)
    plan = pe.warm_plan(k_buckets, **kw)
    assert plan == je.warm_plan(k_buckets, **kw)
    assert [pe.variant_label(*v) for v in plan] == [je.variant_label(*v) for v in plan]


def test_fresh_engine_latches_unset():
    pe, je = _engines()
    assert not pe.fused_ready and not pe.kv_fused_ready
    assert pe.fused_ready == je.fused_ready and pe.kv_fused_ready == je.kv_fused_ready
    assert pe.warmup_stats == {"seconds": 0.0, "programs": 0, "cache_hits": 0,
                               "cache_misses": 0, "error": None}
    assert set(pe.warmup_stats) == set(je.warmup_stats)
    assert pe.last_span_seq == je.last_span_seq == -1
    pe.disable_obs()
    pe.disable_devprof()


@pytest.mark.parametrize("include_kv", [False, True], ids=["nokv", "kv"])
def test_warmup_launches_the_plan_then_sets_the_latch(include_kv):
    """A foreground warm-up runs every variant once, leaves the live
    state untouched and sets the latches; a second call is a no-op."""
    pe, _ = _engines()
    pe.add_group(1, node_ids=[1, 2, 3], self_id=1)
    pe.set_leader(1, term=1, term_start=1, last_index=1)
    pe._upload_dirty()
    before = {k: v.clone() for k, v in pe.dev._asdict().items()}
    calls = []
    warm_one = pe._warm_one

    def counted(scratch, kind, arg, hr, kv=False):
        assert scratch.match.data_ptr() != pe.dev.match.data_ptr()
        calls.append((kind, arg, hr, kv))
        return warm_one(scratch, kind, arg, hr, kv)

    pe._warm_one = counted
    stats = pe.warmup_fused(background=False, include_kv=include_kv)
    plan = pe.warm_plan(include_kv=include_kv)
    assert calls == plan
    assert stats["error"] is None and stats["programs"] == len(plan)
    assert stats["cache_hits"] == stats["cache_misses"] == 0  # nothing to build
    assert pe.fused_ready and pe.kv_fused_ready == include_kv
    for k, v in pe.dev._asdict().items():
        assert torch.equal(v, before[k]), k
    assert pe.warmup_fused(background=False) is None
    assert len(calls) == len(plan)
    if not include_kv:
        pe.warmup_devsm(background=False)
        assert pe.kv_fused_ready
        assert calls[len(plan):] == pe._kv_plan(peng.WARM_K_BUCKETS)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_warmup_failure_leaves_single_round_path(side, monkeypatch):
    """Twin of ``tests/test_warmup.py:83``: a warm-up that dies leaves the
    latch unset and records the error."""
    eng = (peng.BatchedQuorumEngine(8, 3, event_cap=32, device="cpu")
           if side == "port" else jeng.BatchedQuorumEngine(8, 3, event_cap=32))
    monkeypatch.setattr(
        eng, "_warm_one",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")),
    )
    stats = eng.warmup_fused(k_buckets=(4,), background=False)
    assert stats["error"] is not None and "boom" in stats["error"]
    assert not eng.fused_ready


def _committing_cluster(side, n_groups=4):
    coord = _coord(side, capacity=64, n_peers=4, drive_ticks=True,
                   interval_s=60.0)
    coord.stop()  # park the round thread: flush() drives rounds
    coord.eng._warmup_cancel.clear()  # stop() cancelled warm-ups; re-arm
    nodes = {}
    for g in range(n_groups):
        cid = 1 + g
        r = new_test_raft(1, [1, 2, 3], 10, 1, InMemLogDB())
        r.cluster_id = cid
        r.become_candidate()
        r.become_leader()
        n = FakeNode(cid, r)
        r.offload = coord
        nodes[cid] = n
        coord._nodes[cid] = n
        with coord._mu:
            coord._sync_row_locked(n)
    coord.flush()
    return coord, nodes


def _drive_round(coord, nodes, ticks=4):
    """One write per group + a tick burst, flushed synchronously."""
    for cid, n in nodes.items():
        r = n.peer.raft
        with n.raft_mu:
            r.append_entries([Entry(cmd=b"w")])
            idx = r.log.last_index()
        coord.ack(cid, 2, idx)
        coord.ack(cid, 3, idx)
    for _ in range(ticks):
        coord.request_tick()
    coord.flush()


def test_failed_warmup_keeps_committing_on_the_single_round_path(monkeypatch):
    coord, nodes = _committing_cluster("port")
    monkeypatch.setattr(
        coord.eng, "_warm_one",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")),
    )
    coord.eng.warmup_fused(background=False)
    assert "boom" in coord.warmup_stats["error"] and not coord.eng.fused_ready
    for _ in range(3):
        _drive_round(coord, nodes, ticks=6)
    assert coord.fused_dispatches == 0
    for n in nodes.values():
        r = n.peer.raft
        assert r.log.committed == r.log.last_index()


def test_cancel_warmup_records_cancelled():
    pe, _ = _engines()
    pe.cancel_warmup()
    stats = pe.warmup_fused(background=False)
    assert stats["error"] == "cancelled" and stats["programs"] == 0
    assert not pe.fused_ready
    # a coordinator's stop() cancels a background warm-up the same way
    coord = _coord("port", capacity=16, n_peers=4, drive_ticks=True,
                   interval_s=60.0)
    coord.stop()
    t = coord.start_warmup()
    t.join(timeout=60)
    assert coord.warmup_stats["error"] == "cancelled"
    assert not coord.eng.fused_ready


def _never_block(side):
    """Twin of ``tests/test_warmup.py:172`` without its observability
    assertions: while the warm-up thread runs, rounds keep completing on
    the single-round path; after the latch a tick backlog fuses."""
    coord, nodes = _committing_cluster(side)
    stats = {}
    try:
        gate = threading.Event()
        warm_one = coord.eng._warm_one

        def held(*a, **k):
            gate.wait(timeout=60)  # the warm-up is still running
            return warm_one(*a, **k)

        coord.eng._warm_one = held
        t = coord.eng.warmup_fused()
        assert t is not None
        rounds_during_warm = 0
        for _ in range(3):
            _drive_round(coord, nodes, ticks=4)
            rounds_during_warm += 1
            assert not coord.eng.fused_ready
            assert coord.fused_dispatches == 0
        gate.set()
        t.join(timeout=300)
        assert coord.eng.fused_ready, coord.warmup_stats
        assert coord.warmup_stats["error"] is None
        for n in nodes.values():
            r = n.peer.raft
            assert r.log.committed == r.log.last_index()
        before = coord.fused_dispatches
        _drive_round(coord, nodes, ticks=6)
        assert coord.fused_dispatches == before + 1
        for n in nodes.values():
            r = n.peer.raft
            assert r.log.committed == r.log.last_index()
        stats["effects"] = {c: list(n.effects) for c, n in nodes.items()}
        stats["programs"] = coord.warmup_stats["programs"]
        stats["fused"] = coord.fused_dispatches
    finally:
        coord.stop()
    return stats


def test_proposals_never_block_on_warmup():
    port, jx = _never_block("port"), _never_block("jax")
    assert port == jx


def _live_fused(side, warm):
    """Twin of ``test_live_fused.py:94``'s schedule (run by ``:202``)."""
    coord = _coord(side, capacity=32, n_peers=4, drive_ticks=True,
                   interval_s=60.0)
    if warm:
        coord.eng.warmup_fused(background=False)
        assert coord.eng.fused_ready
    coord.stop()
    nodes = {}

    def register(cid):
        r = new_test_raft(1, [1, 2, 3], 10, 1, InMemLogDB())
        r.cluster_id = cid
        r.become_candidate()
        r.become_leader()
        n = FakeNode(cid, r)
        n.offload_election = lambda won, term, wake=True: None
        r.offload = coord
        coord._nodes[cid] = n
        with coord._mu:
            coord._sync_row_locked(n)
        return n

    for g in range(6):
        nodes[1 + g] = register(1 + g)
    coord.flush()

    def append(pairs):
        for cid, k in pairs:
            n = nodes[cid]
            with n.raft_mu:
                n.peer.raft.append_entries([Entry(cmd=b"w") for _ in range(k)])

    def burst(acks=(), reads=(), echoes=(), ticks=3):
        for cid, nid, idx in acks:
            coord.ack(cid, nid, idx)
        for cid, low, high in reads:
            r = nodes[cid].peer.raft
            coord.read_stage(cid, r.log.committed, low, high, r.term)
        for cid, nid, low, high in echoes:
            coord.read_ack_hint(cid, nid, low, high)
        for _ in range(ticks):
            coord.request_tick()
        coord.flush()

    def last(cid):
        return nodes[cid].peer.raft.log.last_index()

    append([(c, 2) for c in nodes])
    burst(acks=[(c, 2, last(c)) for c in nodes] + [(c, 3, last(c) - 1) for c in nodes])
    burst(reads=[(c, 100 + c, c) for c in nodes],
          echoes=[(c, 2, 100 + c, c) for c in nodes])
    victim = nodes[2]
    append([(2, 1)])
    burst(acks=[(2, 2, last(2))])
    with victim.raft_mu:
        victim.peer.raft.become_follower(victim.peer.raft.term + 1, 3)
    coord.set_follower(2, victim.peer.raft.term)
    coord.ack(2, 3, last(2))
    append([(c, 1) for c in nodes if c != 2])
    burst(acks=[(c, 2, last(c)) for c in nodes if c != 2])
    coord.ack(3, 3, last(3))
    coord.unregister(3)
    dead = nodes.pop(3)
    nodes[103] = register(103)
    append([(103, 2)])
    burst(acks=[(103, 2, last(103))])
    with victim.raft_mu:
        victim.peer.raft.become_candidate()
        victim.peer.raft.become_leader()
    coord.membership_changed(2)
    append([(2, 2)])
    burst(acks=[(2, 2, last(2)), (2, 3, last(2))])
    coord.flush()
    commits = {c: tuple(e[1] for e in n.effects if e[0] == "commit")
               for c, n in nodes.items()}
    reads = {c: tuple(e[1:3] for e in n.effects if e[0] == "read")
             for c, n in nodes.items()}
    return {
        "effects": {c: tuple(n.effects) for c, n in nodes.items()},
        "commits": commits,
        "reads": reads,
        "dead": tuple(dead.effects),
        "committed": {c: n.peer.raft.log.committed for c, n in nodes.items()},
        "last": {c: n.peer.raft.log.last_index() for c, n in nodes.items()},
        "fused": coord.fused_dispatches,
    }


def test_live_fused_matches_single_round_and_oracle():
    """Twin of ``test_live_fused.py:202`` on both packages: the warmed
    coordinator's fused replay and the unwarmed single-round replay give
    the same commits and read releases, equal to the scalar oracle, and
    each package's run equals the other's."""
    runs = {(side, warm): _live_fused(side, warm)
            for side in ("port", "jax") for warm in (False, True)}
    for warm in (False, True):
        assert runs[("port", warm)] == runs[("jax", warm)], warm
    single, fused = runs[("port", False)], runs[("port", True)]
    assert single["fused"] == 0 and fused["fused"] >= 4
    for key in ("commits", "reads", "dead", "committed", "last"):
        assert single[key] == fused[key], key
    for cid, committed in fused["committed"].items():
        assert committed == fused["last"][cid]
    assert fused["reads"][2] == ((102, 2),)
    assert fused["commits"][103] == (3,)
    for cid in fused["reads"]:
        if cid not in (2, 103):
            assert fused["reads"][cid] == ((100 + cid, cid),)


