"""The port's BatchedQuorumEngine against the JAX package's, in lockstep.

One op script drives both engines (the port's on ``device="cpu"``, where
the plain kernels run): leaders and followers, election timeouts, vote
batches with duplicates, wins turned into leaders, partial and stale acks,
heartbeats, leader contact, a rebase, row reuse after remove/add, and
in-program recycles.  After every ``step`` / ``step_rounds`` / ``harvest``
the commit egress, the flags, ``committed_snapshot`` and every device
state field must be equal.  One case also holds the port engine against
the scalar ``Raft`` oracle.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dragonboat_tpu.ops.engine import BatchedQuorumEngine as JaxEngine  # noqa: E402
from dragonboat_tpu.wire import Entry, Message, MessageType  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from dragonboat_tpu_torch.ops.engine import BatchedQuorumEngine  # noqa: E402
from raft_harness import new_test_raft  # noqa: E402

torch.set_num_threads(1)

MT = MessageType
FLAG_NAMES = ("won", "lost", "elect", "heartbeat", "demote")


class Pair:
    """The JAX engine and the port's, fed the same calls."""

    def __init__(self, n_groups, n_peers, **kw):
        self.j = JaxEngine(n_groups, n_peers, **kw)
        self.t = BatchedQuorumEngine(n_groups, n_peers, device="cpu", **kw)

    def __getattr__(self, name):
        def both(*args, **kwargs):
            a = getattr(self.j, name)(*args, **kwargs)
            b = getattr(self.t, name)(*args, **kwargs)
            return a, b
        return both

    def check(self, ra, rb, tag):
        """Egress, flags, snapshot and full state equal after a dispatch."""
        self.check_result(ra, rb, tag)
        self.check_state(tag)
        return ra

    @staticmethod
    def check_result(ra, rb, tag):
        """Egress and flags equal (reads no engine state)."""
        assert (ra is None) == (rb is None), tag
        if ra is not None:
            assert ra.commit == rb.commit, tag
            for name in FLAG_NAMES:
                assert sorted(getattr(ra, name)) == sorted(getattr(rb, name)), (tag, name)
            if hasattr(ra, "committed_rel"):
                assert np.array_equal(ra.committed_rel, rb.committed_rel), tag
                assert np.array_equal(ra.commit_rows, rb.commit_rows), tag

    def check_state(self, tag):
        assert self.j.committed_snapshot() == self.t.committed_snapshot(), tag
        assert np.array_equal(self.j.committed_view(), self.t.committed_view()), tag
        jst = {k: np.asarray(v) for k, v in self.j.dev._asdict().items()}
        tst = ts.state_to_numpy(self.t.dev)
        for name in jst:
            assert np.array_equal(jst[name], tst[name]), (tag, name)


def _setup(pair, rng, n_groups):
    """Mixed membership: 5 voters, 3 voters, observers; some check-quorum."""
    info = {}
    for cid in range(1, n_groups + 1):
        kind = cid % 4
        if kind == 1:
            peers, obs = [1, 2, 3], ()
        elif kind == 2:
            peers, obs = [1, 2, 3, 4], (5,)
        else:
            peers, obs = [1, 2, 3, 4, 5], ()
        pair.add_group(
            cid, node_ids=peers, self_id=1, election_timeout=5,
            rand_timeout=rng.randrange(3, 9), check_quorum=(cid % 3 == 0),
            observers=obs,
        )
        info[cid] = {"peers": peers + list(obs), "term": 1, "last": 1}
        if cid % 2:
            pair.set_leader(cid, term=1, term_start=1, last_index=1)
    return info


def _stage_round_events(pair, rng, info, leaders):
    for cid in sorted(info):
        gi = info[cid]
        if cid in leaders:
            if rng.random() < 0.8:  # propose: self append
                gi["last"] += rng.randrange(1, 3)
                pair.ack(cid, 1, gi["last"])
            for nid in gi["peers"][1:]:
                r = rng.random()
                if r < 0.45:
                    pair.ack(cid, nid, gi["last"] - rng.randrange(0, 2))
                elif r < 0.6:
                    pair.heartbeat_resp(cid, nid)
                elif r < 0.65:
                    pair.ack(cid, nid, 0)  # stale retransmit below base
        elif cid % 5 == 0 and rng.random() < 0.5:
            pair.leader_contact(cid)


def _react(pair, rng, info, leaders, res, seen):
    """Host follow-ups of the flags, as a coordinator would run them."""
    if res is None:
        return
    for name in FLAG_NAMES:
        seen[name] += len(getattr(res, name))
    for cid in sorted(res.elect):
        if cid in info and cid not in leaders:
            info[cid]["term"] += 1
            pair.set_candidate(cid, term=info[cid]["term"])
            for nid in info[cid]["peers"]:
                grant = nid == 1 or rng.random() < 0.5
                pair.vote(cid, nid, grant)
                if rng.random() < 0.3:
                    pair.vote(cid, nid, not grant)  # duplicate: first wins
    for cid in sorted(res.won):
        gi = info[cid]
        pair.set_leader(cid, term=gi["term"], term_start=gi["last"] + 1,
                        last_index=gi["last"] + 1)
        gi["last"] += 1
        leaders.add(cid)
    for cid in sorted(res.lost):
        pair.set_follower(cid, term=info[cid]["term"])
    for cid in sorted(res.demote)[:2]:
        if cid in leaders:
            pair.set_follower(cid, term=info[cid]["term"])
            leaders.discard(cid)


def _rare_path(pair, rng, info, leaders, rnd, next_cid):
    if rnd == 3:
        cid = min(leaders)
        pair.rebase(cid)
        pair.restore_progress(max(leaders), committed=1, last_index=info[max(leaders)]["last"])
    if rnd == 5:
        victim = sorted(info)[2]
        pair.remove_group(victim)
        del info[victim]
        leaders.discard(victim)
        pair.add_group(next_cid, node_ids=[1, 2, 3], self_id=1, election_timeout=5)
        pair.set_leader(next_cid, term=1, term_start=1, last_index=1)
        info[next_cid] = {"peers": [1, 2, 3], "term": 1, "last": 1}
        leaders.add(next_cid)
        return next_cid + 1
    if rnd == 6:
        pair.set_randomized_timeout(sorted(info)[1], 7)
    return next_cid


@pytest.mark.parametrize("mode", ["sparse", "dense", "auto"])
def test_engine_single_round_script_matches_jax(mode):
    dense = {"sparse": False, "dense": True, "auto": "auto"}[mode]
    # event_cap=24 makes the sparse path chunk its larger backlogs
    pair = Pair(40, 5, event_cap=24, dense_ingest=dense)
    rng = random.Random(11)
    info = _setup(pair, rng, 36)
    leaders = {cid for cid in info if cid % 2}
    next_cid = 1000
    seen = dict.fromkeys(FLAG_NAMES, 0)
    for rnd in range(16):
        _stage_round_events(pair, rng, info, leaders)
        next_cid = _rare_path(pair, rng, info, leaders, rnd, next_cid)
        ra, rb = pair.step(do_tick=rnd % 3 != 2)
        pair.check(ra, rb, (mode, rnd))
        _react(pair, rng, info, leaders, ra, seen)
    assert any(pair.j.committed_snapshot().values())
    assert all(seen.values()), seen  # every flag fired at least once


def test_engine_fused_script_with_recycles_matches_jax():
    pair = Pair(40, 5, event_cap=64)
    rng = random.Random(23)
    info = _setup(pair, rng, 36)
    leaders = {cid for cid in info if cid % 2}
    next_cid = 2000
    seen = dict.fromkeys(FLAG_NAMES, 0)
    for blk in range(6):
        for r in range(3):
            if r == 1 and blk % 2 == 0:
                old = sorted(leaders)[blk]
                pair.stage_recycle(old, next_cid, term=2, term_start=1, last_index=1)
                info[next_cid] = {"peers": info.pop(old)["peers"], "term": 2, "last": 1}
                leaders.discard(old)
                leaders.add(next_cid)
                next_cid += 1
            _stage_round_events(pair, rng, info, leaders)
            pair.begin_round()
        next_cid = _rare_path(pair, rng, info, leaders, blk, next_cid)
        ra, rb = pair.step_rounds(do_tick=True, pad_rounds_to=4)
        pair.check(ra, rb, ("fused", blk))
        _react(pair, rng, info, leaders, ra, seen)
    # step() reroutes a staged backlog into one fused dispatch
    _stage_round_events(pair, rng, info, leaders)
    pair.begin_round()
    ra, rb = pair.step(do_tick=False)
    pair.check(ra, rb, "step-reroute")
    assert seen["elect"] and seen["heartbeat"] and seen["demote"], seen


def test_engine_pipelined_egress_read_after_next_launch_matches_jax():
    """The kernels update ``committed`` in place, so block i's egress must
    be copied before block i+1 launches: here block i's result is only
    read after the next block was dispatched, with recycles in flight."""
    g, k = 64, 4
    pair = Pair(g, 5, event_cap=4 * g, device_ticks=False)
    for cid in range(1, g + 1):
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    rows = np.arange(g, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), g)
    rel = np.ones(g, np.int64)
    live = np.arange(1, g + 1)
    state = {"next_cid": g + 1, "churn_at": 0}
    results, expected = [], []
    for blk in range(5):
        for _ in range(k):
            lo = state["churn_at"] % g
            for i in range(lo, min(lo + 8, g)):
                pair.stage_recycle(int(live[i]), state["next_cid"], term=1,
                                   term_start=1, last_index=1)
                live[i] = state["next_cid"]
                state["next_cid"] += 1
                rel[i] = 1
            state["churn_at"] += 8
            rel += 1
            pair.ack_block(rows3, slots, np.concatenate([rel, rel, rel]).astype(np.int32))
            pair.begin_round()
        ra, rb = pair.step_rounds(do_tick=False, pipelined=True)
        # ra/rb belong to the PREVIOUS block and are read only now, after
        # this block's launch
        assert (ra is None) == (blk == 0)
        if ra is not None:
            # check_state would harvest the block in flight: results only
            pair.check_result(ra, rb, ("pipelined", blk))
            results.append(rb)
        expected.append(rel.copy())
    ra, rb = pair.harvest()
    pair.check(ra, rb, "harvest")
    results.append(rb)
    assert pair.harvest() == (None, None)
    for res, want in zip(results, expected):
        assert np.array_equal(res.committed_rel, want)


@pytest.mark.parametrize("peers", [[1, 2, 3], [1, 2, 3, 4, 5]])
def test_engine_commit_matches_scalar_raft_oracle(peers):
    """Commit parity of the port engine with a scalar Raft leader fed the
    same REPLICATE_RESP stream (reference: test_ops_quorum.py:149)."""
    r = new_test_raft(1, peers)
    r.handle(Message(from_=1, to=1, type=MT.ELECTION))
    for p in peers[1:]:
        if not r.is_leader():
            r.handle(Message(from_=p, to=1, term=r.term, type=MT.REQUEST_VOTE_RESP))
    assert r.is_leader()
    eng = BatchedQuorumEngine(n_groups=4, n_peers=len(peers), device="cpu")
    eng.add_group(1, node_ids=peers, self_id=1)
    eng.set_leader(1, term=r.term, term_start=r.log.last_index(),
                   last_index=r.log.last_index())
    assert eng.committed_index(1) == r.log.committed == 0
    rng = random.Random(3)
    for _ in range(12):
        for _ in range(rng.randrange(1, 3)):
            r.handle(Message(from_=1, to=1, type=MT.PROPOSE, entries=[Entry(cmd=b"x")]))
        eng.ack(1, 1, r.log.last_index())
        followers = peers[1:]
        rng.shuffle(followers)
        for p in followers[: len(peers) // 2 + rng.randrange(-1, 2)]:
            idx = r.log.last_index() - rng.randrange(0, 2)
            r.handle(Message(from_=p, to=1, term=r.term, type=MT.REPLICATE_RESP,
                             log_index=idx))
            eng.ack(1, p, idx)
        out = eng.step(do_tick=False)
        assert eng.committed_index(1) == r.log.committed
        if 1 in out.commit:
            assert out.commit[1] == r.log.committed
    assert r.log.committed > 0


def test_engine_needs_a_device_and_refuses_later_planes():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedQuorumEngine(4, 3)
    with pytest.raises(NotImplementedError, match="later slice"):
        BatchedQuorumEngine(4, 3, sharding=object(), device="cpu")
    eng = BatchedQuorumEngine(4, 3, device="cpu")
    assert eng.fused_ready and eng.kv_fused_ready
    eng.add_group(1, node_ids=[1, 2, 3], self_id=1)
    for call in (lambda: eng.warmup_fused(), lambda: eng.warmup_devsm(),
                 lambda: eng.enable_obs(), lambda: eng.warm_plan()):
        with pytest.raises(NotImplementedError, match="later slice"):
            call()
    # the read, devsm, hier and telemetry planes are carried now
    assert eng.stage_read(1, count=2) == 0 and eng.read_slots_free(1) == 3
    assert eng.stage_kv_read(1, 0) == 0 and eng.kv_reads_free(1) == 3
    assert eng.stage_kv_ops(1, [1], [0], [0]) is True
    assert np.array_equal(eng.kv_values(1), np.zeros(eng.n_kv_slots, np.int64))
    eng.set_hier(1, [1, 2], 2)
    eng.enable_telem()
    assert eng.telem_enabled and eng.telem_snapshot() is None
