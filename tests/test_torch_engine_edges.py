"""Named engine edge cases of ``tests/test_ops_quorum.py``, run through the
port's ``BatchedQuorumEngine`` (``device="cpu"``) beside the JAX engine.

Each case is the reference test's script, fed to both engines in lockstep:
after every dispatch the commit egress, the flags, every committed index
and every device state field must be equal, and each engine must meet the
reference test's own assertions.  Twins of ``:352`` (rebase), ``:397``
(row reuse), ``:412`` and ``:434`` (stale votes and acks purged on a
transition), ``:451`` (``ack_block``) and ``:730`` (the ``dense_ingest``
validation).
"""
from __future__ import annotations

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
    """The JAX engine and the port's, fed the same calls; a call returns
    both results."""

    def __init__(self, n_groups, n_peers, **kw):
        self.j = JaxEngine(n_groups, n_peers, **kw)
        self.t = BatchedQuorumEngine(n_groups, n_peers, device="cpu", **kw)

    def __getattr__(self, name):
        def both(*args, **kwargs):
            return (getattr(self.j, name)(*args, **kwargs),
                    getattr(self.t, name)(*args, **kwargs))
        return both

    def step(self, do_tick=True):
        ra, rb = self.j.step(do_tick=do_tick), self.t.step(do_tick=do_tick)
        assert ra.commit == rb.commit
        for name in FLAG_NAMES:
            assert sorted(getattr(ra, name)) == sorted(getattr(rb, name)), name
        self.check_state()
        return ra, rb

    def check_state(self):
        assert self.j.committed_snapshot() == self.t.committed_snapshot()
        jst = {k: np.asarray(v) for k, v in self.j.dev._asdict().items()}
        tst = ts.state_to_numpy(self.t.dev)
        for name in jst:
            assert np.array_equal(jst[name], tst[name]), name

    def engines(self):
        return self.j, self.t


def make_scalar_leader(peers):
    """Elect node 1 leader of a fresh group and return the Raft."""
    r = new_test_raft(1, peers)
    r.handle(Message(from_=1, to=1, type=MT.ELECTION))
    for p in peers:
        if p != 1:
            r.handle(Message(from_=p, to=1, term=r.term, type=MT.REQUEST_VOTE_RESP))
        if r.is_leader():
            break
    assert r.is_leader()
    return r


def _replicate(pair, r, peers):
    """One proposal on the scalar leader, acked by the leader and by every
    follower on both engines."""
    r.handle(Message(from_=1, to=1, type=MT.PROPOSE, entries=[Entry(cmd=b"x")]))
    pair.ack(1, 1, r.log.last_index())
    for p in peers[1:]:
        r.handle(Message(from_=p, to=1, term=r.term, type=MT.REPLICATE_RESP,
                         log_index=r.log.last_index()))
        pair.ack(1, p, r.log.last_index())


def test_rebase_preserves_commit_semantics():
    """Twin of ``:352``: commits before a rebase, the rebase itself and
    the progress after it match the scalar Raft on both engines."""
    peers = [1, 2, 3]
    r = make_scalar_leader(peers)
    pair = Pair(1, 3)
    pair.add_group(1, node_ids=peers, self_id=1)
    pair.set_leader(1, term=r.term, term_start=r.log.last_index(),
                    last_index=r.log.last_index())
    for _ in range(5):
        _replicate(pair, r, peers)
    pair.step(do_tick=False)
    for eng in pair.engines():
        assert eng.committed_index(1) == r.log.committed == 6  # noop + 5
    pair.rebase(1)
    pair.check_state()
    for eng in pair.engines():
        assert eng.committed_index(1) == r.log.committed
        assert eng.groups[1].base == 6
    _replicate(pair, r, peers)
    pair.step(do_tick=False)
    for eng in pair.engines():
        assert eng.committed_index(1) == r.log.committed == 7


def test_group_lifecycle_row_reuse():
    """Twin of ``:397``: a full engine refuses a group; a removed group's
    row serves the next one, which commits."""
    pair = Pair(2, 3)
    pair.add_group(1, node_ids=[1, 2, 3], self_id=1)
    pair.add_group(2, node_ids=[1, 2, 3], self_id=1)
    for eng in pair.engines():
        with pytest.raises(RuntimeError):
            eng.add_group(3, node_ids=[1, 2, 3], self_id=1)
    pair.remove_group(1)
    pair.add_group(3, node_ids=[1, 2, 3], self_id=1)
    pair.set_leader(3, term=1, term_start=1, last_index=1)
    pair.ack(3, 1, 1)
    pair.ack(3, 2, 1)
    pair.step(do_tick=False)
    for eng in pair.engines():
        assert eng.committed_index(3) == 1
        assert eng.groups[3].row == 0  # group 1's row


def test_stale_queued_votes_purged_on_new_campaign():
    """Twin of ``:412``: a vote queued in term 1 does not count toward the
    term-2 tally; the peer's real term-2 vote still lands."""
    peers = [1, 2, 3, 4, 5]
    pair = Pair(1, 5)
    pair.add_group(1, node_ids=peers, self_id=1)
    pair.set_candidate(1, term=1)
    pair.vote(1, 2, granted=True)  # queued, never stepped: a term-1 vote
    pair.set_candidate(1, term=2)
    pair.vote(1, 1, granted=True)
    pair.vote(1, 3, granted=True)
    ra, rb = pair.step(do_tick=False)
    assert ra.won == rb.won == []
    pair.vote(1, 2, granted=True)
    ra, rb = pair.step(do_tick=False)
    assert ra.won == rb.won == [1]


def test_stale_queued_acks_purged_on_leader_transition():
    """Twin of ``:434``: an ack queued under an old term is purged by the
    transition, so nothing past the new term's start commits until a
    fresh ack."""
    pair = Pair(1, 3)
    pair.add_group(1, node_ids=[1, 2, 3], self_id=1)
    pair.set_leader(1, term=1, term_start=1, last_index=4)
    pair.ack(1, 2, 3)  # queued old-term ack, never stepped
    pair.set_follower(1, term=2)
    pair.set_leader(1, term=3, term_start=5, last_index=5)
    pair.ack(1, 1, 5)
    pair.step(do_tick=False)
    for eng in pair.engines():
        assert eng.committed_index(1) == 0
    pair.ack(1, 2, 5)
    pair.step(do_tick=False)
    for eng in pair.engines():
        assert eng.committed_index(1) == 5


def _block_pair():
    pair = Pair(8, 3, event_cap=64)
    for cid in range(1, 9):
        pair.add_group(cid, node_ids=[1, 2, 3], self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    return pair


def test_ack_block_equivalent_to_per_event_acks():
    """Twin of ``:451``: ``ack_block`` commits exactly as per-event
    ``ack`` staging; an oversized block chunks without loss; a row out of
    range is refused."""
    a, b = _block_pair(), _block_pair()
    for cid in range(1, 9):
        a.ack(cid, 1, 5)
        a.ack(cid, 2, 5)
    ra, _ = a.step(do_tick=False)
    rows = np.tile(np.arange(8, dtype=np.int32), 2)
    slots = np.concatenate([np.zeros(8, np.int32), np.ones(8, np.int32)])
    b.ack_block(rows, slots, np.full(16, 5, np.int32))  # base is 0 for fresh groups
    rb, _ = b.step(do_tick=False)
    assert ra.commit == rb.commit
    for pair in (a, b):
        for eng in pair.engines():
            for cid in range(1, 9):
                assert eng.committed_index(cid) == 5
    c = _block_pair()
    big_rows = np.tile(np.arange(8, dtype=np.int32), 40)  # 320 > cap 64
    big_rels = np.tile(np.arange(1, 41, dtype=np.int32).repeat(8), 1)[:320]
    c.ack_block(big_rows, np.resize(np.tile(slots, 20), 320), np.sort(big_rels))
    c.step(do_tick=False)
    for eng in a.engines():
        with pytest.raises(ValueError):
            eng.ack_block(np.array([99], np.int32), np.array([0], np.int32),
                          np.array([1], np.int32))


@pytest.mark.parametrize("bad", [1, "always"])
def test_engine_dense_ingest_validation(bad):
    """Twin of ``:730``: ``dense_ingest`` takes True, False or "auto"."""
    with pytest.raises(ValueError):
        JaxEngine(4, 3, dense_ingest=bad)
    with pytest.raises(ValueError):
        BatchedQuorumEngine(4, 3, dense_ingest=bad, device="cpu")
