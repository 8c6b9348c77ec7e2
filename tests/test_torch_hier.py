"""The port's hierarchical commit rule against the JAX package's.

Kernel level: random states with random near masks and sub-quorums
(0 = the rule off, some above the near count), leaders, candidates,
followers and dead rows go through the JAX steps with ``has_hier=True``
and through the port's entry points on CPU tensors (the plain
``_finish_step`` branch); every state field and output must be equal.

Engine level: the port's engine and the JAX engine are fed the same op
stream (``set_hier``, acks, steps, recycles) and must agree after every
dispatch, and with the scalar hier Raft oracle where one runs.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dragonboat_tpu.raft.hier import sub_quorum_size  # noqa: E402
from dragonboat_tpu_torch.ops import engine as tengine  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from test_hiercommit import DOMS_32, ack, elect, hier_raft, propose  # noqa: E402
from test_torch_engine import Pair  # noqa: E402
from test_torch_kernels import (  # noqa: E402
    assert_outputs_equal,
    dense_inputs,
    multiround_inputs,
    random_fields,
    run_dense,
    run_multiround,
    run_sparse,
    sparse_inputs,
)

torch.set_num_threads(1)

G = 96


def hier_fields(seed, g, p):
    """``random_fields`` plus random near masks and sub-quorums in
    {0, 1, ..., |near| + 1}."""
    f = random_fields(seed, g, p)
    rng = np.random.default_rng(seed + 1)
    f["near"][:] = rng.random((g, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, f["near"].sum(1) + 2)
    f["sub_quorum"][::5] = 0
    return f


def _assert_telem_equal(jout, tout, tag):
    assert (jout.telem is None) == (tout.telem is None), tag
    if jout.telem is not None:
        for name in tk.TelemAggregate._fields:
            a = np.asarray(getattr(jout.telem, name))
            b = getattr(tout.telem, name).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)


@pytest.mark.parametrize("p", [3, 5, 8, 12])
@pytest.mark.parametrize("entry", ["dense", "sparse", "multiround"])
def test_hier_step_matches_jax(entry, p):
    for i, (do_tick, has_telem) in enumerate(
        [(False, False), (True, False), (True, True)]
    ):
        seed = 9000 + 10 * p + i
        f = hier_fields(seed, G, p)
        flags = dict(do_tick=do_tick, has_hier=True, has_telem=has_telem)
        if entry == "dense":
            jout, tout = run_dense(f, dense_inputs(seed, G, p), **flags)
        elif entry == "sparse":
            acks, votes = sparse_inputs(seed, G, p, 128)
            jout, tout = run_sparse(f, acks, votes, **flags)
        else:
            ack, votes, churn, tick_mask = multiround_inputs(seed, 4, G, p, 16)
            jout, tout = run_multiround(
                f, ack, votes, churn, tick_mask, has_votes=True,
                has_churn=True, purge_telem=has_telem, **flags,
            )
        assert_outputs_equal(jout, tout, (entry, p, flags))
        _assert_telem_equal(jout, tout, (entry, p, flags))


def test_hier_rule_changes_the_watermark_only_where_sub_quorum_is_set():
    """The branch is live: it moves some leaders' watermarks past the
    classic quorum, and rows with sub_quorum 0 equal the classic step."""
    f = hier_fields(9100, 256, 5)
    f["node_state"][:] = 2
    f["live"][:] = True
    inputs = dense_inputs(9100, 256, 5)
    _, classic = run_dense(f, inputs, has_hier=False)
    _, hier = run_dense(f, inputs, has_hier=True)
    off = f["sub_quorum"] == 0
    a, b = classic.committed.numpy(), hier.committed.numpy()
    assert np.array_equal(a[off], b[off])
    assert (b >= a).all() and (b > a).any()


# ----------------------------------------------------------------------
# engine twins (tests/test_hiercommit.py)
# ----------------------------------------------------------------------


def _mk_pair(peers, domains, n_groups=2):
    r = elect(hier_raft(1, peers, domains), peers)
    pair = Pair(n_groups, len(peers))
    pair.add_group(1, node_ids=peers, self_id=1)
    near = r.hier.near_voters(peers)
    pair.set_hier(1, near, sub_quorum_size(len(near)) if near else 0)
    pair.set_leader(
        1, term=r.term, term_start=r.log.last_index(),
        last_index=r.log.last_index(),
    )
    return r, pair


def test_fused_commit_matches_scalar_hier_oracle():
    """The port's engine replays a hier leader's ack stream with the JAX
    engine's state after every step and the scalar oracle's watermark."""
    peers = [1, 2, 3, 4, 5]
    r, pair = _mk_pair(peers, DOMS_32)
    rng = random.Random(17)
    for step in range(40):
        for _ in range(rng.randrange(0, 3)):
            idx = propose(r)
            pair.ack(1, 1, idx)
        last = r.log.last_index()
        for _ in range(rng.randrange(0, 5)):
            p = rng.choice(peers[1:])
            idx = rng.randrange(0, last + 1)  # stale/dup included
            ack(r, p, idx)
            pair.ack(1, p, idx)
        ra, rb = pair.step(do_tick=False)
        pair.check(ra, rb, step)
        assert pair.t.committed_index(1) == r.log.committed
    assert r.log.committed > 0
    assert r.hier.subquorum_closes > 0  # the mask actually engaged


def test_fused_commit_matches_scalar_near_only_stream():
    """Near-domain-only acks: the port closes at the sub-quorum (the
    classic rule alone would stay at 0)."""
    peers = [1, 2, 3, 4, 5]
    r, pair = _mk_pair(peers, DOMS_32)
    for step in range(8):
        idx = propose(r)
        pair.ack(1, 1, idx)
        ack(r, 2, idx)
        pair.ack(1, 2, idx)
        ra, rb = pair.step(do_tick=False)
        pair.check(ra, rb, step)
        assert pair.t.committed_index(1) == r.log.committed == idx


def test_engine_ineligible_domain_stays_classic():
    """sub_quorum=0 keeps the classic rule on a hier-latched engine."""
    peers = [1, 2, 3, 4, 5]
    pair = Pair(2, 5)
    pair.add_group(1, node_ids=peers, self_id=1)
    pair.set_hier(1, [1, 2], 2)        # latch the plane on group 1
    pair.add_group(2, node_ids=peers, self_id=1)
    pair.set_hier(2, [], 0)            # group 2: ineligible
    for cid in (1, 2):
        pair.set_leader(cid, term=1, term_start=0, last_index=0)
    for cid in (1, 2):
        pair.ack(cid, 1, 5)
        pair.ack(cid, 2, 5)
    ra, rb = pair.step(do_tick=False)
    pair.check(ra, rb, "ineligible")
    assert pair.t.committed_index(1) == 5   # sub-quorum {1,2} closed
    assert pair.t.committed_index(2) == 0   # classic needs 3 of 5


class _Spy:
    """Records the has_hier / has_telem flags of every kernel entry call
    the engine makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("quorum_step", "quorum_step_dense", "quorum_multiround"):
            monkeypatch.setattr(tengine, name, self._wrap(getattr(tengine, name)))

    def _wrap(self, fn):
        def call(*args, **kwargs):
            self.calls.append(
                (kwargs.get("has_hier", False), kwargs.get("has_telem", False))
            )
            return fn(*args, **kwargs)
        return call


def test_hier_off_structural_identity(monkeypatch):
    """Until set_hier enables the rule, every dispatch runs
    has_hier=False, the row syncs skip near/sub_quorum and the device
    arrays stay all-zero; the first enabling set_hier flips all three."""
    spy = _Spy(monkeypatch)
    peers = [1, 2, 3]
    pair = Pair(2, 3, dense_ingest="auto")
    pair.add_group(1, node_ids=peers, self_id=1)
    pair.set_leader(1, term=1, term_start=0, last_index=0)
    pair.set_hier(1, (), 0)  # disable on a never-enabled engine: no-op
    eng = pair.t
    assert not eng._hier_used
    for k in eng._HIER_KEYS:
        assert k not in eng._sync_keys()
    pair.ack(1, 1, 3)
    pair.ack(1, 2, 3)
    ra, rb = pair.step(do_tick=False)
    pair.check(ra, rb, "off")
    pair.ack(1, 2, 4)
    pair.begin_round()
    ra, rb = pair.step_rounds(do_tick=False)
    pair.check(ra, rb, "off fused")
    assert eng.committed_index(1) == 3
    assert not eng._hier_used
    assert spy.calls and not any(h for h, _ in spy.calls)
    assert not eng.dev.near.any() and not eng.dev.sub_quorum.any()
    # the first enabling set_hier: the next dispatches carry the rule
    spy.calls.clear()
    pair.set_hier(1, [1, 2], 2)
    assert eng._hier_used
    for k in eng._HIER_KEYS:
        assert k in eng._sync_keys()
    pair.ack(1, 1, 6)
    ra, rb = pair.step(do_tick=False)
    pair.check(ra, rb, "on")
    assert spy.calls and all(h for h, _ in spy.calls)
    assert eng.committed_index(1) == 4


def test_hier_geometry_kept_across_in_program_recycle():
    """An in-program recycle keeps the row's near mask and sub-quorum on
    the device and in the mirror, and the new tenant commits by the hier
    rule in the block that recycled it; a fresh registration of a reused
    row clears the geometry."""
    peers = [1, 2, 3, 4, 5]
    pair = Pair(4, 5, device_ticks=False)
    for cid in (1, 2, 3):
        pair.add_group(cid, node_ids=peers, self_id=1)
        pair.set_hier(cid, [1, 2, 3], 2)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    pair.ack(2, 2, 1)
    pair.begin_round()
    pair.stage_recycle(1, 101, term=2, term_start=1, last_index=4)
    # the new tenant: self and one near follower at 4 close the near rule
    pair.ack(101, 2, 4)
    pair.begin_round()
    ra, rb = pair.step_rounds(do_tick=False)
    pair.check(ra, rb, "recycle")
    row = pair.t.groups[101].row
    for eng in (pair.t, pair.j):
        assert eng.committed_index(101) == 4
        assert eng.mirror.arrays["sub_quorum"][row] == 2
        assert list(eng.mirror.arrays["near"][row]) == [1, 1, 1, 0, 0]
    assert int(pair.t.dev.sub_quorum[row]) == 2
    assert pair.t.dev.near[row].tolist() == [True, True, True, False, False]
    # the numpy twin of the recycle keeps the geometry too
    m = ts.HostMirror(2, 5)
    m.arrays["near"][0] = [True, False, True, False, False]
    m.arrays["sub_quorum"][0] = 2
    m.recycle_row(0, term=3, term_start=1, last_index=2)
    assert m.arrays["sub_quorum"][0] == 2
    assert m.arrays["near"][0].tolist() == [True, False, True, False, False]
    # a reused row starts with the rule off
    pair.remove_group(3)
    pair.add_group(7, node_ids=peers, self_id=1)
    pair.set_leader(7, term=1, term_start=1, last_index=1)
    pair.ack(7, 2, 1)
    ra, rb = pair.step(do_tick=False)
    pair.check(ra, rb, "reuse")
    row7 = pair.t.groups[7].row
    assert int(pair.t.dev.sub_quorum[row7]) == 0
    assert not pair.t.dev.near[row7].any()
