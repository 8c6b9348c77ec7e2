"""The port's device read plane (ReadIndex confirmation) against the JAX
package's.

Kernel level: random states with pending read slots, out-of-range self
slots (P and -1), dead rows, non-leaders and non-voting peers go through
the JAX ``read_confirm`` / ``_read_plane`` and the ``has_reads`` steps,
and through the port's plain versions and entry points on CPU tensors;
every state field and both read outputs must be equal (zero tolerance:
integer and boolean work).

Engine level: twins of the engine cases of ``tests/test_read_confirm.py``.
Each case's script runs on the JAX engine and on the port's engine
(``device="cpu"``), with the reference test's own assertions on both;
their observations (the read egress, slot occupancy) and their final
states must be equal, and where the reference holds the engine against
the scalar ``ReadIndex`` oracle, so does the twin.  The live-coordinator
cases of that file need the coordinator and NodeHost, which are not
ported yet; the twin of the read-only round drives the engine alone.
Last, rung 4's mixed 9:1 phase at 256 groups, K = 4.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu.raft.readindex import ReadIndex  # noqa: E402
from dragonboat_tpu.wire import SystemCtx  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from test_read_confirm import _drive, _Oracle  # noqa: E402
from test_torch_engine import Pair  # noqa: E402
from test_torch_kernels import (  # noqa: E402
    assert_outputs_equal,
    dense_inputs,
    multiround_inputs,
    random_fields,
)

torch.set_num_threads(1)

G = 96


# ----------------------------------------------------------------------
# kernel level
# ----------------------------------------------------------------------


def read_fields(seed, g, p, s):
    """``random_fields`` with S read slots: pending batches, stale echo
    bits, self slots out of range on both sides."""
    rng = np.random.default_rng(seed + 3)
    f = random_fields(seed, g, p)
    f["read_index"] = rng.integers(0, 12, (g, s)).astype(np.int32)
    f["read_count"] = rng.choice([0, 0, 1, 2, 5], (g, s)).astype(np.int32)
    f["read_acks"] = rng.random((g, s, p)) < 0.3
    f["self_slot"][5::17] = -1  # one_hot of -1 is all zero too
    return f


def read_inputs(seed, g, p, s, k=None):
    """Stage index (-1 = none; a few cancels at count 0), counts and echo
    bits, with a leading K axis when ``k`` is given."""
    rng = np.random.default_rng(seed + 4)
    lead = () if k is None else (k,)
    idx = np.where(rng.random(lead + (g, s)) < 0.35,
                   rng.integers(0, 12, lead + (g, s)), -1).astype(np.int32)
    cnt = rng.choice([0, 1, 3, 9], lead + (g, s)).astype(np.int32)
    echo = rng.random(lead + (g, s, p)) < 0.35
    return idx, cnt, echo


def to_jax(fields):
    return jk.QuorumState(**{k: jnp.asarray(v.copy()) for k, v in fields.items()})


def to_torch(fields):
    return ts.state_from_numpy(fields, device="cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def assert_reads_equal(jout, tout, tag=""):
    for name in ("read_done_count", "read_done_index"):
        a, b = np.asarray(getattr(jout, name)), getattr(tout, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)


@pytest.mark.parametrize("p,s", [(1, 4), (3, 4), (5, 4), (5, 8), (8, 8), (12, 4), (12, 8)])
def test_read_confirm_and_read_plane_match_jax(p, s):
    f = read_fields(10 * p + s, G, p, s)
    idx, cnt, echo = read_inputs(10 * p + s, G, p, s)
    js, tst = to_jax(f), to_torch(f)
    got = tk.read_confirm(tst.read_acks, tst.read_count, tst.voting,
                          tst.self_slot, tst.quorum, tst.node_state, tst.live)
    want = jk.read_confirm(js.read_acks, js.read_count, js.voting, js.self_slot,
                           js.quorum, js.node_state, js.live)
    assert np.array_equal(np.asarray(want), got.numpy())
    jst, jc, ji = jk._read_plane(js, jnp.asarray(idx), jnp.asarray(cnt), jnp.asarray(echo))
    nst, tc, ti = tk._read_plane(tst, T(idx), T(cnt), T(echo))
    for name in ts.READ_PLANE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jst, name)), getattr(nst, name).numpy()), name
    assert np.array_equal(np.asarray(jc), tc.numpy()) and tc.dtype == torch.int32
    assert np.array_equal(np.asarray(ji), ti.numpy()) and ti.dtype == torch.int32
    # the corner cases are in the draw: something confirmed, something
    # held back by each of the gates
    conf = got.numpy()
    assert conf.any() and not conf.all()


def test_read_confirm_gates():
    """One row per gate: only a live leader with reads pending and a
    voter quorum (itself counted only where its slot is in range)
    confirms."""
    g, p, s = 6, 3, 1
    f = ts.state_to_numpy(ts.make_state(g, p, n_read_slots=s, device="cpu"))
    f["node_state"][:] = 2
    f["live"][:] = True
    f["voting"][:] = True
    f["quorum"][:] = 2
    f["self_slot"][:] = 0
    f["read_count"][:] = 1
    f["read_acks"][:, 0, 1] = True        # one follower echo: self + 1 = 2
    f["node_state"][1] = 0                # a follower
    f["live"][2] = False                  # a dead row
    f["read_count"][3] = 0                # nothing pending
    f["self_slot"][4] = p                 # the leader's own slot out of range
    f["voting"][5, 1] = False             # the echo came from an observer
    js, tst = to_jax(f), to_torch(f)
    got = tk.read_confirm(tst.read_acks, tst.read_count, tst.voting,
                          tst.self_slot, tst.quorum, tst.node_state, tst.live)
    want = jk.read_confirm(js.read_acks, js.read_count, js.voting, js.self_slot,
                           js.quorum, js.node_state, js.live)
    assert got[:, 0].tolist() == [True, False, False, False, False, False]
    assert np.array_equal(np.asarray(want), got.numpy())


DENSE_FLAGS = [dict(do_tick=t, has_votes=v, has_hier=h, has_telem=m)
               for t, v, h, m in itertools.product([False, True], repeat=4)]


@pytest.mark.parametrize("flags", DENSE_FLAGS, ids=str)
@pytest.mark.parametrize("p", [3, 5])
def test_dense_step_with_reads_matches_jax(flags, p):
    seed = 100 + p + 7 * DENSE_FLAGS.index(flags)
    s = 4
    f = read_fields(seed, G, p, s)
    rng = np.random.default_rng(seed)
    f["near"][:] = rng.random((G, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, p + 2, G)
    am, at, vn = dense_inputs(seed, G, p)
    reads = read_inputs(seed, G, p, s)
    jout = jk.quorum_step_dense(to_jax(f), *(jnp.asarray(a) for a in (am, at, vn) + reads),
                                has_reads=True, **flags)
    st = to_torch(f)
    tout = tk.quorum_step_dense(st, *(T(a) for a in (am, at, vn) + reads),
                                has_reads=True, **flags)
    assert tout.state is st
    assert_outputs_equal(jout, tout, flags)
    assert_reads_equal(jout, tout, flags)
    if flags["has_telem"]:  # the fold counts the slots left pending
        assert int(tout.telem.read_slots) == int(jout.telem.read_slots)
        assert int(tout.telem.read_slots) == int((st.read_count > 0).sum())


MULTI_FLAGS = [
    dict(do_tick=False, track_contact=False, has_churn=False),   # rung 4 mixed
    dict(do_tick=False, track_contact=True, has_churn=True),
    dict(do_tick=True, track_contact=True, has_churn=True, has_votes=True),
    dict(do_tick=True, track_contact=True, has_churn=True, has_hier=True,
         has_telem=True, purge_telem=True),
    dict(do_tick=False, track_contact=True, has_churn=True, purge_reads=True,
         has_hier=True),
]


@pytest.mark.parametrize("flags", MULTI_FLAGS, ids=str)
@pytest.mark.parametrize("p,s", [(3, 4), (5, 4), (5, 8), (12, 8)])
def test_multiround_with_reads_matches_jax(flags, p, s):
    seed = 300 + 11 * p + s + 13 * MULTI_FLAGS.index(flags)
    k = 6
    f = read_fields(seed, G, p, s)
    rng = np.random.default_rng(seed)
    f["near"][:] = rng.random((G, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, p + 2, G)
    ack, votes, churn, tick_mask = multiround_inputs(seed, k, G, p, 24)
    reads = read_inputs(seed, G, p, s, k=k)
    kw = {"has_votes": False, "has_reads": True, **flags}
    jout = jk.quorum_multiround(
        to_jax(f), *(jnp.asarray(a) for a in (ack, votes) + churn + (tick_mask,) + reads),
        **kw)
    st = to_torch(f)
    tout = tk.quorum_multiround(
        st, *(T(a) for a in (ack, votes) + churn + (tick_mask,) + reads), **kw)
    assert tout.state is st
    assert_outputs_equal(jout, tout, flags)
    assert_reads_equal(jout, tout, flags)
    assert tout.read_done_count.sum() > 0


@pytest.mark.parametrize("has_reads", [False, True])
def test_multiround_recycle_resets_read_slots(has_reads):
    """A recycle drops the row's pending reads where has_reads or
    purge_reads says so, before that round's stage; without either the
    slots stay (the engine passes purge_reads only once the plane is
    used)."""
    g, p, s, k = 16, 3, 4, 3
    f = read_fields(7, g, p, s)
    ack = np.full((k, g, p), -1, np.int32)
    churn_row = np.array([[2, 5], [g, g], [5, g]], np.int32)
    churn = (churn_row, np.full((k, 2), 3, np.int32), np.zeros((k, 2), np.int32),
             np.ones((k, 2), np.int32))
    tick_mask = np.zeros((k,), bool)
    reads = read_inputs(8, g, p, s, k=k)
    for purge in (False, True):
        kw = dict(has_churn=True, has_reads=has_reads, purge_reads=purge)
        args = (ack, np.zeros((1, 1, 1), np.int8)) + churn + (tick_mask,)
        if has_reads:
            args += reads
        jout = jk.quorum_multiround(to_jax(f), *(jnp.asarray(a) for a in args), **kw)
        tout = tk.quorum_multiround(to_torch(f), *(T(a) for a in args), **kw)
        assert_outputs_equal(jout, tout, kw)
        if has_reads:
            assert_reads_equal(jout, tout, kw)
        elif not purge:
            assert np.array_equal(tout.state.read_count.numpy(), f["read_count"])
        else:
            assert int(tout.state.read_count[[2, 5]].sum()) == 0


def test_read_multiround_kernel_matches_dense_rounds():
    """Twin of test_read_confirm.py's kernel case: one K-round block with
    reads equals K single dense read rounds, count-summed and
    index-maxed, and both equal the JAX kernels."""
    rng = np.random.default_rng(611)
    g, p, k, s = 12, 3, 6, ts.READ_SLOTS
    f = ts.state_to_numpy(ts.make_state(g, p, device="cpu"))
    f["live"][:] = True
    f["node_state"][:] = 2
    f["voting"][:] = True
    f["quorum"][:] = 2
    f["next"][:] = 2
    ack = np.full((k, g, p), -1, np.int32)
    stage_idx = np.full((k, g, s), -1, np.int32)
    stage_cnt = np.zeros((k, g, s), np.int32)
    echo = np.zeros((k, g, s, p), bool)
    for r in range(k):
        for _ in range(rng.integers(0, 12)):
            ack[r, rng.integers(g), rng.integers(p)] = rng.choice([1, 2, 5])
        for _ in range(rng.integers(0, 6)):
            gi, sl = rng.integers(g), rng.integers(s)
            stage_idx[r, gi, sl] = rng.integers(0, 6)
            stage_cnt[r, gi, sl] = rng.integers(1, 9)
        for _ in range(rng.integers(0, 10)):
            echo[r, rng.integers(g), rng.integers(s), rng.integers(p)] = True
    z = np.zeros((1, 1), np.int32)
    args = (ack, np.zeros((1, 1, 1), np.int8), z, z, z, z, np.zeros((k,), bool),
            stage_idx, stage_cnt, echo)
    kw = dict(do_tick=False, track_contact=True, has_votes=False, has_churn=False,
              has_reads=True)
    out_f = tk.quorum_multiround(to_torch(f), *(T(a) for a in args), **kw)
    jout = jk.quorum_multiround(to_jax(f), *(jnp.asarray(a) for a in args), **kw)
    assert_outputs_equal(jout, out_f)
    assert_reads_equal(jout, out_f)
    st = to_torch(f)
    cnt_acc = np.zeros((g, s), np.int64)
    idx_acc = np.full((g, s), -1, np.int64)
    for r in range(k):
        out = tk.quorum_step_dense(
            st, T(np.maximum(ack[r], 0)), T(ack[r] >= 0), None,
            T(stage_idx[r]), T(stage_cnt[r]), T(echo[r]),
            do_tick=False, track_contact=True, has_votes=False, has_reads=True,
        )
        cnt_acc += out.read_done_count.numpy()
        idx_acc = np.maximum(idx_acc, out.read_done_index.numpy())
    for name in ts.FIELDS:
        assert torch.equal(getattr(out_f.state, name), getattr(st, name)), name
    assert np.array_equal(out_f.read_done_count.numpy(), cnt_acc)
    assert np.array_equal(out_f.read_done_index.numpy(), idx_acc)
    assert cnt_acc.sum() > 0


# ----------------------------------------------------------------------
# engine level: the JAX engine and the port's, the same script
# ----------------------------------------------------------------------


def _build(n_groups=8, n_peers=3, cap=256, read_slots=None):
    """The reference test's ``_build`` for both engines."""
    kw = {} if read_slots is None else {"n_read_slots": read_slots}
    pair = Pair(n_groups, n_peers, event_cap=cap, **kw)
    for cid in range(1, n_groups + 1):
        pair.add_group(cid, node_ids=list(range(1, n_peers + 1)), self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    pair._upload_dirty()
    return pair


def _twin(script, *args, **kw):
    """Run ``script(eng)`` on a fresh JAX engine and a fresh port engine
    (``_build(*args, **kw)`` each); their observations and final states
    must be equal.  Returns the port's observations."""
    pair = _build(*args, **kw)
    obs_j = script(pair.j)
    obs_t = script(pair.t)
    assert obs_j == obs_t
    pair.check_state("final")
    return obs_t


def _row_reads(eng, cid):
    """Reads pending on the device in the group's slots."""
    return int(np.asarray(eng.dev.read_count)[eng.groups[cid].row].sum())


def test_read_engine_matches_scalar_oracle_and_per_round():
    seed, n = 77, 6
    pair_f, pair_s = _build(n, read_slots=8), _build(n, read_slots=8)
    rel = {}
    for name, pair in (("fused", pair_f), ("per_round", pair_s)):
        for side in ("j", "t"):
            orc = {cid: _Oracle(2) for cid in range(1, n + 1)}
            got = _drive(getattr(pair, side), orc, seed, fused=name == "fused")
            for cid in range(1, n + 1):
                assert sorted(got[cid]) == sorted(orc[cid].released), (name, side, cid)
            rel[name, side] = got
        pair.check_state(name)
    assert rel["fused", "t"] == rel["fused", "j"]
    assert rel["per_round", "t"] == rel["per_round", "j"]
    for cid in range(1, n + 1):
        assert sorted(rel["fused", "t"][cid]) == sorted(rel["per_round", "t"][cid])
    assert sum(len(v) for v in rel["fused", "t"].values()) > 0
    for side in ("j", "t"):
        a, b = getattr(pair_f, side).dev, getattr(pair_s, side).dev
        for field in a._fields:
            assert np.array_equal(np.asarray(getattr(a, field)),
                                  np.asarray(getattr(b, field))), (side, field)


def test_read_single_round_dense_matches_fused_single():
    def script(single):
        def run(eng):
            eng.ack(1, 2, 4)
            sl = eng.stage_read(1, count=5)
            eng.read_ack(1, 2, sl)
            eng.read_ack(1, 3, sl)
            if single:
                res = eng.step(do_tick=False)
            else:
                eng.begin_round()
                res = eng.step_rounds(do_tick=False)
            assert res.reads[0][3] == 5
            return res.reads
        return run

    assert _twin(script(True), 4) == _twin(script(False), 4)


def test_read_membership_recycle_mid_block_purges_pending():
    def script(eng):
        s_old = eng.stage_read(3, count=7)
        eng.read_ack(3, 2, s_old)
        eng.read_ack(3, 3, s_old)
        eng.begin_round()
        eng.stage_recycle(3, 103, term=2, term_start=1, last_index=1)
        s_new = eng.stage_read(103, count=2)
        eng.read_ack(103, 2, s_new)
        eng.begin_round()
        res = eng.step_rounds(do_tick=False)
        assert res.reads == [(103, s_new, 0, 2)]
        assert _row_reads(eng, 103) == 0
        assert eng.read_slots_free(103) == eng.n_read_slots
        return res.reads

    _twin(script, 6)


def test_read_pending_from_earlier_dispatch_dies_with_recycle():
    def script(eng):
        eng.stage_read(4, count=3)
        eng.step(do_tick=False)
        assert _row_reads(eng, 4) == 3
        eng.stage_recycle(4, 104, term=2, term_start=1, last_index=1)
        s_new = eng.stage_read(104, count=1)
        eng.read_ack(104, 2, s_new)
        eng.begin_round()
        res = eng.step_rounds(do_tick=False)
        assert res.reads == [(104, s_new, 0, 1)]
        assert _row_reads(eng, 104) == 0
        return res.reads

    _twin(script, 6)


def test_read_leader_change_with_pending_ctxs():
    def script(eng):
        obs = []
        ctx = SystemCtx(low=9, high=0)
        orc = ReadIndex()
        orc.add_request(5, ctx, 0)
        sl = eng.stage_read(2, count=3, index=5)
        eng.read_ack(2, 2, sl)
        eng.read_ack(2, 3, sl)
        eng.set_follower(2, term=3)
        orc2 = ReadIndex()  # scalar twin: become_follower resets
        eng.begin_round()
        res = eng.step_rounds(do_tick=False)
        assert res.reads == []
        assert orc2.confirm(ctx, 2, 2) == []
        assert _row_reads(eng, 2) == 0
        eng.set_leader(2, term=4, term_start=6, last_index=6)
        sl = eng.stage_read(2, count=1, index=6)
        eng.read_ack(2, 2, sl)
        res = eng.step(do_tick=False)
        assert res.reads == [(2, sl, 6, 1)]
        obs.append(res.reads)
        sl = eng.stage_read(3, count=4)
        eng.step(do_tick=False)
        assert _row_reads(eng, 3) == 4
        eng.set_follower(3, term=5)
        eng.read_ack(3, 2, sl)
        eng.read_ack(3, 3, sl)
        res = eng.step(do_tick=False)
        assert res.reads == []
        assert _row_reads(eng, 3) == 0
        return obs

    _twin(script, 6)


def test_read_slot_backpressure_and_cancel():
    def script(eng):
        slots = [eng.stage_read(1) for _ in range(eng.n_read_slots)]
        with pytest.raises(RuntimeError):
            eng.stage_read(1)
        assert eng.read_slots_free(1) == 0
        eng.cancel_read(1, slots[0])
        with pytest.raises(RuntimeError):
            eng.stage_read(1)
        eng.begin_round()
        s2 = eng.stage_read(1)
        assert s2 == slots[0]
        res = eng.step(do_tick=False)
        assert res.reads == []
        eng.read_ack(1, 2, slots[1])
        res = eng.step(do_tick=False)
        assert [(c, s, n) for c, s, _i, n in res.reads] == [(1, slots[1], 1)]
        return res.reads

    _twin(script, 4)


def test_read_pipelined_step_rounds_equivalent():
    def script(eng):
        got = []
        for blk in range(3):
            sl = eng.stage_read(1, count=blk + 1)
            eng.read_ack(1, 2, sl)
            eng.begin_round()
            res = eng.step_rounds(do_tick=False, pipelined=True)
            if res is not None:
                got.append(res.reads)
        got.append(eng.harvest().reads)
        return got

    piped = _twin(script, 4)

    def sync(eng):
        got = []
        for blk in range(3):
            sl = eng.stage_read(1, count=blk + 1)
            eng.read_ack(1, 2, sl)
            eng.begin_round()
            got.append(eng.step_rounds(do_tick=False).reads)
        return got

    assert _twin(sync, 4) == piped


def test_read_rebase_shifts_pending_watermark():
    def script(eng):
        eng.ack(1, 1, 9)
        eng.ack(1, 2, 9)
        eng.step(do_tick=False)
        assert eng.committed_index(1) == 9
        sl = eng.stage_read(1, count=1)
        eng.step(do_tick=False)
        eng.rebase(1)
        eng.read_ack(1, 2, sl)
        res = eng.step(do_tick=False)
        assert res.reads == [(1, sl, 9, 1)]
        return res.reads

    _twin(script, 4)


def test_read_only_round_dispatches_without_ticks():
    """Engine half of the reference's read-only round (its coordinator
    half waits for the coordinator slice): a staged batch and its echo,
    with no write or vote event and no tick, dispatch and confirm on their
    own, through the dense step; a sparse-only engine is forced dense."""
    def script(eng):
        obs = []
        for cid in (1, 2):
            sl = eng.stage_read(cid, count=1)
            eng.read_ack(cid, 2, sl)
            res = eng.step(do_tick=False)
            assert res.reads == [(cid, sl, 0, 1)] and res.commit == {}
            obs.append(res.reads)
        return obs

    _twin(script, 4, cap=256)
    pair = Pair(4, 3, dense_ingest=False)
    for side in (pair.j, pair.t):
        side.add_group(1, node_ids=[1, 2, 3], self_id=1)
        side.set_leader(1, term=1, term_start=1, last_index=1)
        sl = side.stage_read(1, count=2)
        side.read_ack(1, 3, sl)
        assert side.step(do_tick=False).reads == [(1, sl, 0, 2)]
    pair.check_state("sparse-only")


def test_read_plane_latch_keeps_read_free_engines_untouched(monkeypatch):
    """Until the first read ingress every dispatch runs without the
    plane (has_reads False, no purge) and the row syncs skip the read
    fields; the first stage flips the latch for good."""
    from dragonboat_tpu_torch.ops import engine as tengine

    seen = []
    real_multi, real_dense = tengine.quorum_multiround, tengine.quorum_step_dense

    def multi(*a, **kw):
        seen.append(("multi", kw["has_reads"], kw["purge_reads"]))
        return real_multi(*a, **kw)

    def dense(*a, **kw):
        seen.append(("dense", kw["has_reads"], None))
        return real_dense(*a, **kw)

    monkeypatch.setattr(tengine, "quorum_multiround", multi)
    monkeypatch.setattr(tengine, "quorum_step_dense", dense)
    eng = tengine.BatchedQuorumEngine(8, 3, device="cpu", dense_ingest=True)
    for cid in range(1, 5):
        eng.add_group(cid, node_ids=[1, 2, 3], self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    assert "read_count" not in eng._sync_keys()
    eng.ack(1, 2, 3)
    eng.step(do_tick=False)
    eng.stage_recycle(2, 12, term=2, term_start=1, last_index=1)
    eng.step_rounds()
    assert seen == [("dense", False, None), ("multi", False, False)]
    at = eng.committed_index(1)
    sl = eng.stage_read(1)
    assert eng._read_plane_used and "read_count" in eng._sync_keys()
    eng.read_ack(1, 2, sl)
    eng.stage_recycle(3, 13, term=2, term_start=1, last_index=1)
    eng.begin_round()
    eng.stage_recycle(4, 14, term=2, term_start=1, last_index=1)
    res = eng.step_rounds()
    assert seen[-1] == ("multi", True, True)
    assert res.reads == [(1, sl, at, 1)]
    eng.stage_recycle(12, 22, term=3, term_start=1, last_index=1)
    eng.step_rounds()
    assert seen[-1] == ("multi", False, True)


# ----------------------------------------------------------------------
# rung 4's mixed 9:1 phase, small
# ----------------------------------------------------------------------


def test_rung4_mixed_phase_matches_jax():
    """``bench.py:_run_rung4`` at 256 groups, K = 4: a pure-write window,
    then every group writes, stages a batch of 9 reads and has followers
    2 and 3 echo it, every round.  Each block's egress and the final
    state equal the JAX engine's; every staged read is confirmed."""
    n, k, blocks = 256, 4, 3
    pair = Pair(n, 5, event_cap=4 * n, device_ticks=False)
    for cid in range(1, n + 1):
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    pair._upload_dirty()
    rows = np.arange(n, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), n)
    rel = 1
    for _ in range(blocks):  # the write window
        rels = rel + 1 + np.arange(k, dtype=np.int32)[:, None] + np.zeros((1, rows3.size), np.int32)
        pair.ack_block_rounds(rows3, slots, rels)
        ra, rb = pair.step_rounds(do_tick=False, pipelined=True)
        pair.check_result(ra, rb, "write window")
        rel += k
    ra, rb = pair.harvest()
    pair.check_result(ra, rb, "write window end")
    assert pair.t.committed_index(1) == rel
    rows2 = np.concatenate([rows, rows])
    peers2 = np.repeat(np.array([1, 2], np.int32), n)
    counts9 = np.full(n, 9, np.int32)
    confirmed = 0
    expect_idx = np.full((n, ts.READ_SLOTS), -1, np.int64)

    def harvested(ra, rb, tag):
        nonlocal confirmed
        pair.check_result(ra, rb, tag)
        if rb is not None:
            assert ra.reads == rb.reads, tag
            confirmed += int(rb.read_counts.sum()) if rb.read_counts is not None else 0

    for b in range(blocks):
        for _ in range(k):
            rel += 1
            pair.ack_block(rows3, slots, np.full(rows3.size, rel, np.int32))
            sj, st = pair.stage_read_block(rows, np.full(n, rel, np.int32), counts9)
            assert np.array_equal(sj, st)
            expect_idx[rows, st] = rel
            pair.read_ack_block(rows2, np.concatenate([st, st]), peers2)
            pair.begin_round()
        ra, rb = pair.step_rounds(do_tick=False, pipelined=True)
        harvested(ra, rb, f"mixed block {b}")
    ra, rb = pair.harvest()
    harvested(ra, rb, "mixed end")
    assert confirmed == n * 9 * blocks * k
    assert pair.t.committed_index(1) == rel
    pair.check_state("mixed")
    f = ts.state_to_numpy(pair.t.dev)
    assert not f["read_count"].any() and not f["read_acks"].any()
    assert np.array_equal(f["read_index"], np.maximum(expect_idx, 0))
