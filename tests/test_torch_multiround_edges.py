"""Named K-round edge cases of ``tests/test_multiround.py`` (``:376``-``:599``),
run through the port's ``BatchedQuorumEngine`` (``device="cpu"``) beside
the JAX engine.

They pin the recycle semantics that K3's handling of a block's rounds must
keep: recycle validation, ``remove_group`` dropping an open or a closed
round's recycle, a rare-path transition superseding a pending recycle, a
collapsed recycle purging the old tenant's closed-round events, a
pipelined recycle against the in-flight egress, pipelined against
synchronous blocks, ``ack_block_rounds`` against per-round staging, and
``committed_view``.  Each case is the reference test's script, fed to both
engines in lockstep: every dispatch's egress, every committed index and
every device state field must be equal, and each engine must meet the
reference test's own assertions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dragonboat_tpu.ops.engine import BatchedQuorumEngine as JaxEngine  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from dragonboat_tpu_torch.ops.engine import BatchedQuorumEngine  # noqa: E402

torch.set_num_threads(1)


class Pair:
    """The JAX engine and the port's, fed the same calls."""

    def __init__(self, n_groups, n_peers):
        self.j = JaxEngine(n_groups, n_peers, event_cap=256)
        self.t = BatchedQuorumEngine(n_groups, n_peers, event_cap=256, device="cpu")
        for eng in self.engines():
            for cid in range(1, n_groups + 1):
                eng.add_group(cid, node_ids=list(range(1, n_peers + 1)), self_id=1)
                eng.set_leader(cid, term=1, term_start=1, last_index=1)
            eng._upload_dirty()
        self.check_state()

    def engines(self):
        return self.j, self.t

    def __getattr__(self, name):
        def both(*args, **kwargs):
            return (getattr(self.j, name)(*args, **kwargs),
                    getattr(self.t, name)(*args, **kwargs))
        return both

    def raises(self, name, *args, **kwargs):
        for eng in self.engines():
            with pytest.raises(ValueError):
                getattr(eng, name)(*args, **kwargs)

    def same_result(self, ra, rb):
        assert (ra is None) == (rb is None)
        if ra is None:
            return
        assert ra.commit == rb.commit
        assert ra.rounds == rb.rounds
        assert np.array_equal(np.asarray(ra.committed_rel), np.asarray(rb.committed_rel))

    def step_rounds(self, **kw):
        ra, rb = self.j.step_rounds(**kw), self.t.step_rounds(**kw)
        self.same_result(ra, rb)
        return ra, rb

    def harvest(self):
        ra, rb = self.j.harvest(), self.t.harvest()
        self.same_result(ra, rb)
        return ra, rb

    def check_state(self):
        assert self.j.committed_snapshot() == self.t.committed_snapshot()
        jst = {k: np.asarray(v) for k, v in self.j.dev._asdict().items()}
        tst = ts.state_to_numpy(self.t.dev)
        for name in jst:
            assert np.array_equal(jst[name], tst[name]), name


def test_stage_recycle_validation():
    pair = Pair(4, 3)
    pair.raises("stage_recycle", 99, 100, term=1, term_start=1, last_index=1)
    pair.raises("stage_recycle", 1, 2, term=1, term_start=1, last_index=1)  # taken
    pair.raises("stage_recycle", 1, 100, term=1, term_start=1, last_index=1,
                rand_timeout=99)  # a geometry change
    pair.raises("stage_recycle", 1, 100, term=1, term_start=5, last_index=1)
    pair.stage_recycle(1, 100, term=1, term_start=1, last_index=1)
    pair.raises("stage_recycle", 100, 101, term=1, term_start=1,
                last_index=1)  # the same row twice in one round
    pair.begin_round()
    pair.stage_recycle(100, 101, term=1, term_start=1, last_index=1)
    pair.step_rounds(do_tick=False)
    pair.check_state()
    for eng in pair.engines():
        assert 101 in eng.groups and 100 not in eng.groups


def test_remove_group_drops_open_round_recycle():
    pair = Pair(4, 3)
    pair.stage_recycle(1, 100, term=1, term_start=1, last_index=1)
    pair.remove_group(100)
    pair.ack(2, 1, 2)
    pair.ack(2, 2, 2)
    pair.begin_round()
    pair.step_rounds(do_tick=False)
    pair.check_state()
    for eng in pair.engines():
        assert not bool(eng._read("live", 0))
        assert eng.committed_index(2) == 2


def test_remove_group_drops_closed_round_recycle():
    pair = Pair(4, 3)
    pair.stage_recycle(1, 100, term=7, term_start=1, last_index=1)
    pair.begin_round()  # the churn record now lives in a closed round
    pair.remove_group(100)
    pair.add_group(200, node_ids=[1, 2, 3], self_id=1)
    for eng in pair.engines():
        assert eng.groups[200].row == 0
    pair.set_leader(200, term=3, term_start=1, last_index=1)
    pair.ack(200, 1, 2)
    pair.ack(200, 2, 2)
    pair.begin_round()
    pair.step_rounds(do_tick=False)
    pair.check_state()
    for eng in pair.engines():
        assert int(eng._read("term", 0)) == 3
        assert eng.committed_index(200) == 2


def test_rare_path_transition_cancels_pending_recycle():
    pair = Pair(4, 3)
    pair.ack(1, 1, 5)
    pair.ack(1, 2, 5)
    ra, rb = pair.step(do_tick=False)
    assert ra.commit == rb.commit
    pair.check_state()
    pair.stage_recycle(1, 100, term=2, term_start=1, last_index=1)
    for eng in pair.engines():
        assert eng.committed_index(100) == 0
        assert int(eng._read("term", 0)) == 2
    pair.set_leader(100, term=9, term_start=3, last_index=3)
    pair.ack(100, 1, 3)
    pair.ack(100, 2, 3)
    pair.begin_round()
    pair.step_rounds(do_tick=False)
    pair.check_state()
    for eng in pair.engines():
        assert int(eng._read("term", 0)) == 9
        assert eng.committed_index(100) == 3


def test_collapsed_recycle_purges_closed_round_events():
    pair = Pair(4, 3)
    pair.ack(1, 1, 5)  # the old tenant's acks, sealed into closed round 0
    pair.ack(1, 2, 5)
    pair.ack(2, 1, 2)
    pair.ack(2, 2, 2)
    pair.begin_round()
    pair.stage_recycle(1, 100, term=2, term_start=1, last_index=1)
    pair.set_randomized_timeout(100, 20)  # collapses the recycle pre-block
    pair.begin_round()
    pair.step_rounds(do_tick=False)
    pair.check_state()
    for eng in pair.engines():
        assert eng.committed_index(100) == 0
        assert int(eng._read("match", 0).max()) <= 1
        assert eng.committed_index(2) == 2


def test_pipelined_recycle_does_not_pollute_inflight_egress():
    pair = Pair(4, 3)
    for cid in range(1, 5):
        pair.ack(cid, 1, 2)
        pair.ack(cid, 2, 2)
    pair.step(do_tick=False)
    pair.ack(2, 1, 3)  # block A: only group 2 advances
    pair.ack(2, 2, 3)
    pair.step_rounds(do_tick=False, pipelined=True)
    pair.stage_recycle(1, 100, term=1, term_start=1, last_index=1)
    ra, rb = pair.harvest()  # block A's egress
    for res in (ra, rb):
        assert set(res.commit) == {2} and res.commit[2] == 3
    for eng in pair.engines():
        assert eng.committed_index(100) == 0
    pair.ack(100, 1, 2)
    pair.ack(100, 2, 2)
    pair.begin_round()
    ra, rb = pair.step_rounds(do_tick=False)
    assert ra.commit[100] == rb.commit[100] == 2
    pair.check_state()


def test_pipelined_step_rounds_equivalent():
    """Pipelined blocks on the port give the synchronous blocks' egress one
    block late, as the JAX engine's do."""
    sync, piped = Pair(6, 3), Pair(6, 3)
    sync_results, piped_results = [], []
    for blk in range(4):
        for cid in range(1, 7):
            for pair in (sync, piped):
                pair.ack(cid, 1, 2 + blk)
                pair.ack(cid, 2, 2 + blk)
        sync_results.append(sync.step_rounds(do_tick=False))
        r = piped.step_rounds(do_tick=False, pipelined=True)
        if r[0] is not None:
            piped_results.append(r)
    piped_results.append(piped.harvest())
    piped.check_state()
    for name in sync.j.dev._fields:
        assert np.array_equal(np.asarray(getattr(sync.j.dev, name)),
                              ts.state_to_numpy(piped.t.dev)[name]), name
    assert len(sync_results) == len(piped_results)
    for (sa, _), (pa, pb) in zip(sync_results, piped_results):
        assert sa.commit == pa.commit == pb.commit
    for cid in range(1, 7):
        piped.ack(cid, 1, 9)
        piped.ack(cid, 2, 9)
    piped.step_rounds(do_tick=False, pipelined=True)
    for eng in piped.engines():
        assert eng.committed_index(1) == 9  # a host read harvests first
        assert eng.harvest() is None


def test_ack_block_rounds_matches_per_round_staging():
    bulk, rounds = Pair(8, 3), Pair(8, 3)
    rows = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0], np.int32)  # a duplicate cell
    slots = np.array([0, 0, 0, 0, 1, 1, 1, 1, 0], np.int32)
    k = 4
    rels = np.arange(2, 2 + k, dtype=np.int32)[:, None] + np.zeros((1, rows.size), np.int32)
    rels[1, -1] = -3  # below base: clamps to 0
    rels[2, 0] = 1    # a stale ack: the max keeps 4
    bulk.ack_block_rounds(rows, slots, rels)
    ra, _ = bulk.step_rounds(do_tick=False)
    for r in range(k):
        rounds.ack_block(rows, slots, np.maximum(rels[r], 0))
        rounds.begin_round()
    rb, _ = rounds.step_rounds(do_tick=False)
    bulk.check_state()
    rounds.check_state()
    assert ra.commit == rb.commit
    for name in bulk.j.dev._fields:
        assert np.array_equal(ts.state_to_numpy(bulk.t.dev)[name],
                              ts.state_to_numpy(rounds.t.dev)[name]), name
    bulk.raises("ack_block_rounds", rows, slots, rels[:, :3])  # shape mismatch
    bulk.raises("ack_block_rounds", np.array([99], np.int32), np.array([0], np.int32),
                np.array([[1]], np.int32))


def test_committed_view_matches_committed_index():
    pair = Pair(6, 3)
    for cid in range(1, 7):
        pair.ack(cid, 1, 1 + cid)
        pair.ack(cid, 2, 1 + cid)
    pair.step(do_tick=False)
    pair.check_state()
    (vj, vt), (cj, ct) = pair.committed_view(), pair.row_cids()
    assert np.array_equal(np.asarray(vj), np.asarray(vt))
    assert np.array_equal(np.asarray(cj), np.asarray(ct))
    for eng, view, cids in ((pair.j, vj, cj), (pair.t, vt, ct)):
        for row in range(6):
            assert cids[row] == row + 1
            assert view[row] == eng.committed_index(int(cids[row]))
    pair.remove_group(3)
    for eng in pair.engines():
        assert (eng.row_cids() >= 0).sum() == 5
