"""The port's device state machine (devsm) against the JAX package's.

Kernel level: random states with buffered entries, keys outside the
value row (negative and >= V), read keys >= V and negative, stage indexes
below -1, ready entries sharing a key and an index (their values summed,
wrapping), negative watermarks (the K-round carry keeps a capture only
where its index is >= 0) and rows recycled with entries buffered go
through the JAX ``_kv_plane`` and the ``has_kv`` steps, and through the
port's plain versions and entry points on CPU tensors; every state field
and every output must be equal (zero tolerance: integer work).

Engine level: twins of the engine cases of ``tests/test_devsm.py``.  Each
case's script runs on the JAX engine and on the port's engine
(``device="cpu"``), with the reference test's own assertions on both;
their observations and final states must be equal, and where the
reference holds the engine against the scalar ``_KVOracle``, so does the
twin.  The coordinator and live cases of that file wait for the
coordinator slice.  Last, rung 4's write window with the device state
machine on, at 256 groups.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from test_devsm import _drive_kv, _KVOracle  # noqa: E402
from test_torch_engine import Pair  # noqa: E402
from test_torch_kernels import (  # noqa: E402
    assert_outputs_equal,
    dense_inputs,
    multiround_inputs,
)
from test_torch_read import read_fields, read_inputs  # noqa: E402

torch.set_num_threads(1)

G = 96
I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


# ----------------------------------------------------------------------
# kernel level
# ----------------------------------------------------------------------


def kv_fields(seed, g, p, s=ts.READ_SLOTS, v=ts.KV_SLOTS, e=ts.KV_ENT_SLOTS):
    """``read_fields`` with a device state machine: random values, entries
    buffered at random indexes (some keys outside [0, V)), and a few rows
    whose watermark is negative."""
    rng = np.random.default_rng(seed + 5)
    f = read_fields(seed, g, p, s)
    f["kv_value"] = rng.integers(-50, 50, (g, v)).astype(np.int32)
    f["kv_ent_index"] = np.where(rng.random((g, e)) < 0.4,
                                 rng.integers(0, 16, (g, e)), -1).astype(np.int32)
    f["kv_ent_key"] = rng.integers(-2, v + 3, (g, e)).astype(np.int32)
    f["kv_ent_val"] = rng.integers(I32_MIN, I32_MAX, (g, e), endpoint=True).astype(np.int32)
    f["committed"][7::23] = -3
    return f


def kv_inputs(seed, g, v=ts.KV_SLOTS, e=ts.KV_ENT_SLOTS, r=ts.KV_READ_SLOTS, k=None):
    """Stage planes (indexes -1 and below for no stage, keys outside
    [0, V), values at the int32 extremes) and read keys (-1, -4, >= V)."""
    rng = np.random.default_rng(seed + 6)
    lead = () if k is None else (k,)
    idx = np.where(rng.random(lead + (g, e)) < 0.35,
                   rng.integers(0, 20, lead + (g, e)),
                   rng.choice([-1, -1, -2, -9], lead + (g, e))).astype(np.int32)
    key = rng.integers(-2, v + 3, lead + (g, e)).astype(np.int32)
    val = rng.integers(I32_MIN, I32_MAX, lead + (g, e), endpoint=True).astype(np.int32)
    rk = np.where(rng.random(lead + (g, r)) < 0.5,
                  rng.integers(0, v + 3, lead + (g, r)),
                  rng.choice([-1, -1, -4], lead + (g, r))).astype(np.int32)
    return idx, key, val, rk


def _dup_winners(f, inputs):
    """Row 0: two ready entries sharing key 2 and the largest index, with
    values whose sum wraps; row 1 reads key V and key -4."""
    idx, key, val, rk = inputs
    at = (0,) if idx.ndim == 3 else ()
    f["committed"][0] = 30
    f["kv_ent_index"][0] = -1
    idx[at + (0,)] = -1
    idx[at + (0, slice(0, 3))] = [9, 9, 4]
    key[at + (0, slice(0, 3))] = 2
    val[at + (0, slice(0, 3))] = [I32_MAX, 5, 77]
    rk[at + (1, slice(0, 2))] = [f["kv_value"].shape[1], -4]
    return (I32_MIN + 4) & 0xFFFFFFFF  # the wrapped sum, as an unsigned pattern


def to_jax(fields):
    return jk.QuorumState(**{k: jnp.asarray(v.copy()) for k, v in fields.items()})


def to_torch(fields):
    return ts.state_from_numpy(fields, device="cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def assert_kv_equal(jout, tout, tag=""):
    for name in ("kv_read_val", "kv_read_index", "kv_applied"):
        a, b = np.asarray(getattr(jout, name)), getattr(tout, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)


@pytest.mark.parametrize("v,e,r", [(16, 16, 4), (1, 1, 1), (5, 7, 3), (40, 32, 8)])
def test_kv_plane_matches_jax(v, e, r):
    """The plain ``_kv_plane`` against the JAX function, every trap in."""
    f = kv_fields(10 * v + e, G, 3, v=v, e=e)
    inputs = kv_inputs(10 * v + e, G, v, e, r)
    expect = _dup_winners(f, inputs) if e >= 3 and r >= 2 else None
    jst, jrv, jri, jap = jk._kv_plane(to_jax(f), *(jnp.asarray(a) for a in inputs))
    tst, trv, tri, tap = tk._kv_plane(to_torch(f), *(T(a) for a in inputs))
    for name in ts.DEVSM_PLANE_FIELDS:
        assert np.array_equal(np.asarray(getattr(jst, name)), getattr(tst, name).numpy()), name
    for a, b in ((jrv, trv), (jri, tri), (jap, tap)):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tap.sum() > 0 and (tri >= 0).any()
    if expect is not None:
        assert int(tst.kv_value[0, 2]) & 0xFFFFFFFF == expect
        assert int(tap[0]) >= 3 and (tst.kv_ent_index[0] == -1).all()
        assert tri[1, 0] == f["committed"][1] and trv[1, 0] == 0  # key V reads 0
        assert tri[1, 1] == -1 and trv[1, 1] == 0                  # key -4: no read
    out_of_range = (tst.kv_ent_key < 0) | (tst.kv_ent_key >= v)
    assert out_of_range.any()


DENSE_FLAGS = [
    dict(do_tick=False, has_votes=False),
    dict(do_tick=True, has_votes=True),
    dict(do_tick=True, has_votes=False, has_reads=True),
    dict(do_tick=False, has_votes=True, has_hier=True),
    dict(do_tick=True, has_votes=True, has_reads=True, has_hier=True, has_telem=True),
    dict(do_tick=False, has_votes=False, has_telem=True),
]


@pytest.mark.parametrize("flags", DENSE_FLAGS)
@pytest.mark.parametrize("p", [3, 5])
def test_dense_step_with_kv_matches_jax(flags, p):
    seed = 100 * p + DENSE_FLAGS.index(flags)
    f = kv_fields(seed, G, p)
    am, at, vn = dense_inputs(seed, G, p)
    reads = read_inputs(seed, G, p, ts.READ_SLOTS) if flags.get("has_reads") else (None,) * 3
    kv = kv_inputs(seed, G)
    _dup_winners(f, kv)
    kw = dict(flags, has_kv=True)
    jout = jk.quorum_step_dense(
        to_jax(f), jnp.asarray(am), jnp.asarray(at), jnp.asarray(vn),
        *(None if a is None else jnp.asarray(a) for a in reads),
        *(jnp.asarray(a) for a in kv), **kw)
    tout = tk.quorum_step_dense(
        to_torch(f), T(am), T(at), T(vn), *(None if a is None else T(a) for a in reads),
        *(T(a) for a in kv), **kw)
    assert_outputs_equal(jout, tout, flags)
    assert_kv_equal(jout, tout, flags)
    if flags.get("has_telem"):
        for name, a, b in zip(jk.TelemAggregate._fields, jout.telem, tout.telem):
            assert np.array_equal(np.asarray(a), b.numpy()), name
        assert int(tout.telem.kv_ents) == int((tout.state.kv_ent_index >= 0).sum())


@pytest.mark.parametrize("p", [3, 5])
def test_sparse_step_kv_hint_matches_jax(p):
    """The sparse step carries no kv events: has_kv only makes the fold
    count entry slots."""
    f = kv_fields(900 + p, G, p)
    acks = tuple(np.asarray(a) for a in (
        np.arange(16, dtype=np.int32) % G, np.zeros(16, np.int32),
        np.full(16, 3, np.int32), np.ones(16, bool)))
    z = np.zeros((1,), np.int32)
    votes = (z, z, z.astype(np.int8), z.astype(bool))
    kw = dict(has_votes=False, has_telem=True, has_kv=True)
    jout = jk.quorum_step(to_jax(f), *(jnp.asarray(a) for a in acks + votes), **kw)
    tout = tk.quorum_step(to_torch(f), *(T(a) for a in acks + votes), **kw)
    assert_outputs_equal(jout, tout)
    assert tout.kv_read_val is None
    assert int(tout.telem.kv_ents) == int(np.asarray(jout.telem.kv_ents)) > 0


MULTI_FLAGS = [
    dict(has_churn=False, has_kv=True),
    dict(has_churn=True, has_kv=True),
    dict(has_churn=True, purge_kv=True),
    dict(has_churn=True, has_kv=True, has_reads=True, has_hier=True),
    dict(has_churn=True, has_kv=True, has_telem=True, purge_telem=True, do_tick=True,
         has_votes=True),
    dict(has_churn=True, purge_kv=True, has_reads=True, has_telem=True),
]


@pytest.mark.parametrize("flags", MULTI_FLAGS)
def test_multiround_with_kv_matches_jax(flags):
    """K-round blocks over churn (rows recycled with entries buffered),
    the purge alone, reads, the hier rule, ticks and the fold."""
    k, c, p = 4, 10, 3
    seed = 300 + MULTI_FLAGS.index(flags)
    f = kv_fields(seed, G, p)
    ack, votes, churn, tick_mask = multiround_inputs(seed, k, G, p, c)
    r1 = churn[0][1]
    r1[r1 == 0] = G
    r1[0] = 0  # row 0, entries buffered, recycled mid-block
    reads = read_inputs(seed, G, p, ts.READ_SLOTS, k) if flags.get("has_reads") else (None,) * 3
    kv = kv_inputs(seed, G, k=k) if flags.get("has_kv") else (None,) * 4
    kw = dict(dict(do_tick=False, has_votes=False, track_contact=True), **flags)
    kw.setdefault("purge_kv", False)
    kw.setdefault("purge_reads", False)
    kw.setdefault("purge_telem", False)
    args = (ack, votes, *churn, tick_mask) + reads + kv
    jout = jk.quorum_multiround(to_jax(f), *(None if a is None else jnp.asarray(a) for a in args),
                                **kw)
    tout = tk.quorum_multiround(to_torch(f), *(None if a is None else T(a) for a in args), **kw)
    assert_outputs_equal(jout, tout, flags)
    if flags.get("has_kv"):
        assert_kv_equal(jout, tout, flags)
        assert (tout.kv_read_index >= 0).any() and tout.kv_applied.sum() > 0
    else:
        assert tout.kv_read_val is None
    if flags.get("has_telem"):
        for name, a, b in zip(jk.TelemAggregate._fields, jout.telem, tout.telem):
            assert np.array_equal(np.asarray(a), b.numpy()), name
    if flags.get("has_kv") or flags.get("purge_kv"):
        row0 = ts.state_to_numpy(tout.state)
        if not flags.get("has_kv"):  # the purge alone: reset values, free buffer
            assert not row0["kv_value"][0].any() and (row0["kv_ent_index"][0] == -1).all()


def test_multiround_carry_keeps_a_capture_only_where_its_index_is_set():
    """A capture at a negative watermark (index < 0) does not overwrite the
    carry, taken literally: a row whose watermark is negative in every
    round egresses (0, -1) though its reads were staged."""
    k, p = 3, 3
    f = kv_fields(77, 8, p)
    f["committed"][2] = -5
    f["node_state"][2] = 0  # a follower: the watermark stays
    ack = np.full((k, 8, p), -1, np.int32)
    z = np.zeros((1, 1), np.int32)
    kv = kv_inputs(77, 8, k=k)
    kv[3][:, 2, :] = 1
    args = (ack, np.zeros((1, 1, 1), np.int8), z, z, z, z, np.zeros((k,), bool)) + (None,) * 3 + kv
    kw = dict(do_tick=False, has_votes=False, has_churn=False, has_kv=True)
    jout = jk.quorum_multiround(to_jax(f), *(None if a is None else jnp.asarray(a) for a in args),
                                **kw)
    tout = tk.quorum_multiround(to_torch(f), *(None if a is None else T(a) for a in args), **kw)
    assert_outputs_equal(jout, tout)
    assert_kv_equal(jout, tout)
    assert (tout.kv_read_index[2] == -1).all() and (tout.kv_read_val[2] == 0).all()


# ----------------------------------------------------------------------
# engine level: the JAX engine and the port's, the same script
# ----------------------------------------------------------------------


def _build(n_groups=6, n_peers=3, cap=256, **kw):
    """The reference test's ``_build`` for both engines."""
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


def _ents(eng, cid):
    return int((np.asarray(eng.dev.kv_ent_index)[eng.groups[cid].row] >= 0).sum())


def test_kv_multiround_kernel_matches_dense_rounds():
    """Twin of test_devsm.py's kernel case: one K-round kv block equals K
    dense kv rounds with the carry, and both equal the JAX kernels."""
    rng = np.random.default_rng(1107)
    g, p, k = 8, 3, 6
    e, r, v = ts.KV_ENT_SLOTS, ts.KV_READ_SLOTS, ts.KV_SLOTS
    pair = _build(g, p)
    f = ts.state_to_numpy(pair.t.dev)
    ack = np.full((k, g, p), -1, np.int32)
    kei = np.full((k, g, e), -1, np.int32)
    kek = np.zeros((k, g, e), np.int32)
    kev = np.zeros((k, g, e), np.int32)
    krk = np.full((k, g, r), -1, np.int32)
    next_idx = np.full((g,), 2, np.int64)
    for rr in range(k):
        for _ in range(rng.integers(0, 10)):
            gi = rng.integers(g)
            idx = int(next_idx[gi])
            next_idx[gi] += 1
            kei[rr, gi, idx % e] = idx
            kek[rr, gi, idx % e] = rng.integers(v)
            kev[rr, gi, idx % e] = rng.integers(-50, 50)
        for _ in range(rng.integers(0, 8)):
            gi = rng.integers(g)
            ack[rr, gi, rng.integers(p)] = rng.integers(1, int(next_idx[gi]))
        for _ in range(rng.integers(0, 4)):
            krk[rr, rng.integers(g), rng.integers(r)] = rng.integers(v)
    z = np.zeros((1, 1), np.int32)
    args = (ack, np.zeros((1, 1, 1), np.int8), z, z, z, z, np.zeros((k,), bool),
            None, None, None, kei, kek, kev, krk)
    kw = dict(do_tick=False, track_contact=True, has_votes=False, has_churn=False,
              has_reads=False, has_kv=True)
    out_f = tk.quorum_multiround(to_torch(f), *(None if a is None else T(a) for a in args), **kw)
    jout = jk.quorum_multiround(to_jax(f), *(None if a is None else jnp.asarray(a) for a in args),
                                **kw)
    assert_outputs_equal(jout, out_f)
    assert_kv_equal(jout, out_f)
    st = to_torch(f)
    val_acc = np.zeros((g, r), np.int64)
    idx_acc = np.full((g, r), -1, np.int64)
    ap_acc = np.zeros((g,), np.int64)
    for rr in range(k):
        out = tk.quorum_step_dense(
            st, T(np.maximum(ack[rr], 0)), T(ack[rr] >= 0), None, None, None, None,
            T(kei[rr]), T(kek[rr]), T(kev[rr]), T(krk[rr]),
            do_tick=False, track_contact=True, has_votes=False, has_kv=True,
        )
        cap = out.kv_read_index.numpy() >= 0
        val_acc = np.where(cap, out.kv_read_val.numpy(), val_acc)
        idx_acc = np.where(cap, out.kv_read_index.numpy(), idx_acc)
        ap_acc += out.kv_applied.numpy()
    for name in ts.FIELDS:
        assert torch.equal(getattr(out_f.state, name), getattr(st, name)), name
    assert np.array_equal(out_f.kv_read_val.numpy(), val_acc)
    assert np.array_equal(out_f.kv_read_index.numpy(), idx_acc)
    assert np.array_equal(out_f.kv_applied.numpy(), ap_acc)
    assert ap_acc.sum() > 0


def test_kv_engine_matches_scalar_oracle_and_per_round():
    seed, n = 23, 5
    pair_f, pair_s = _build(n), _build(n)
    got = {}
    for name, pair in (("fused", pair_f), ("per_round", pair_s)):
        for side in ("j", "t"):
            eng = getattr(pair, side)
            orc = {cid: _KVOracle(eng.n_kv_slots) for cid in range(1, n + 1)}
            got[name, side] = _drive_kv(eng, orc, seed, fused=name == "fused")
            for cid in range(1, n + 1):
                assert np.array_equal(eng.kv_values(cid), orc[cid].values), (name, side, cid)
                for key, value, index in got[name, side][cid]:
                    assert index <= orc[cid].applied_to
        pair.check_state(name)
    assert got["fused", "t"] == got["fused", "j"]
    assert got["per_round", "t"] == got["per_round", "j"]
    assert sum(len(v) for v in got["per_round", "t"].values()) > 0
    for side in ("j", "t"):
        a, b = getattr(pair_f, side).dev, getattr(pair_s, side).dev
        for field in a._fields:
            assert np.array_equal(np.asarray(getattr(a, field)),
                                  np.asarray(getattr(b, field))), (side, field)


def test_kv_capture_value_matches_oracle_at_watermark():
    def script(eng):
        orc = _KVOracle(eng.n_kv_slots)
        eng.stage_kv_ops(1, [2, 3], [3, 3], [11, 22])
        orc.stage(2, 3, 11)
        orc.stage(3, 3, 22)
        eng.ack(1, 1, 3)
        eng.ack(1, 2, 2)
        s1 = eng.stage_kv_read(1, 3)
        res = eng.step(do_tick=False)
        orc.commit(res.commit[1])
        assert res.commit[1] == 2
        assert res.kv_reads == [(1, s1, 11, 2)]
        assert orc.read(3) == 11
        eng.ack(1, 2, 3)
        s2 = eng.stage_kv_read(1, 3)
        res2 = eng.step(do_tick=False)
        orc.commit(res2.commit[1])
        assert res2.kv_reads == [(1, s2, 22, 3)]
        assert orc.read(3) == 22
        assert np.array_equal(eng.kv_values(1), orc.values)
        return res.kv_reads + res2.kv_reads, res.kv_applied_ops, res2.kv_applied_ops

    _twin(script, 4)


def test_kv_single_round_dense_matches_fused_single():
    def script(single):
        def run(eng):
            eng.stage_kv_ops(2, [2], [1], [42])
            eng.ack(2, 1, 2)
            eng.ack(2, 2, 2)
            eng.stage_kv_read(2, 1)
            if single:
                res = eng.step(do_tick=False)
            else:
                eng.begin_round()
                res = eng.step_rounds(do_tick=False)
            assert res.kv_reads[0][2] == 42 and res.kv_applied_ops == 1
            return res.kv_reads, res.kv_applied_ops
        return run

    assert _twin(script(True), 4) == _twin(script(False), 4)


def test_kv_recycle_mid_block_resets_rows():
    def script(eng):
        eng.stage_kv_ops(3, [2], [0], [55])
        eng.ack(3, 1, 2)
        eng.ack(3, 2, 2)
        eng.begin_round()
        eng.stage_recycle(3, 103, term=2, term_start=1, last_index=1)
        eng.stage_kv_ops(103, [2], [1], [77])
        eng.ack(103, 1, 2)
        eng.ack(103, 2, 2)
        s_new = eng.stage_kv_read(103, 0)
        s_new2 = eng.stage_kv_read(103, 1)
        eng.begin_round()
        res = eng.step_rounds(do_tick=False)
        assert sorted(res.kv_reads) == sorted([(103, s_new, 0, 2), (103, s_new2, 77, 2)])
        vals = eng.kv_values(103)
        assert vals[0] == 0 and vals[1] == 77
        assert _ents(eng, 103) == 0
        return sorted(res.kv_reads), vals.tolist()

    _twin(script, 6)


def test_kv_recycle_with_entries_buffered_by_an_earlier_dispatch():
    """The in-program reset (purge_kv) clears a row whose entries sit
    buffered on the device from an earlier dispatch: on a kv-carrying
    block (has_kv, as entries are buffered) and, once nothing is
    buffered, on a kv-free block (the purge alone)."""
    def script(eng):
        eng.stage_kv_ops(2, [3], [4], [8])  # never commits: stays buffered
        eng.stage_kv_ops(3, [3], [5], [6])  # commits later
        eng.step(do_tick=False)
        assert _ents(eng, 2) == 1 and _ents(eng, 3) == 1
        eng.stage_recycle(2, 202, term=2, term_start=1, last_index=1)
        res = eng.step_rounds(do_tick=False)  # has_kv: group 3 is buffered
        assert _ents(eng, 202) == 0 and not eng.kv_values(202).any()
        assert _ents(eng, 3) == 1
        eng.ack(3, 1, 3)
        eng.ack(3, 2, 3)
        eng.step(do_tick=False)
        assert eng.kv_values(3)[5] == 6 and _ents(eng, 3) == 0
        eng.kv_restore(1, np.arange(eng.n_kv_slots))
        eng.step(do_tick=False)
        eng.stage_recycle(1, 101, term=2, term_start=1, last_index=1)
        res2 = eng.step_rounds(do_tick=False)
        assert not eng.kv_values(101).any() and res2.kv_cids is None
        return res.kv_applied_ops, res2.kv_applied_ops

    _twin(script, 4)


def test_kv_transition_purges_ents_keeps_values():
    def script(eng):
        eng.stage_kv_ops(1, [2], [0], [9])
        eng.ack(1, 1, 2)
        eng.ack(1, 2, 2)
        eng.step(do_tick=False)
        assert eng.kv_values(1)[0] == 9
        eng.stage_kv_ops(1, [3], [0], [1000])
        eng.set_follower(1, term=2)
        eng.step(do_tick=False)
        assert eng.kv_values(1)[0] == 9
        assert _ents(eng, 1) == 0
        eng.set_leader(1, term=3, term_start=3, last_index=2)
        eng.stage_kv_ops(1, [3], [0], [12])
        eng.ack(1, 1, 3)
        eng.ack(1, 2, 3)
        res = eng.step(do_tick=False)
        assert res.commit[1] == 3
        assert eng.kv_values(1)[0] == 12
        return eng.kv_values(1).tolist()

    _twin(script, 4)


def test_kv_restore_and_snapshot_round_trip():
    def script(eng):
        img = np.arange(eng.n_kv_slots, dtype=np.int64) * 3
        eng.kv_restore(2, img)
        assert np.array_equal(eng.kv_values(2), img)
        eng.stage_kv_ops(2, [2], [0], [-5])
        eng.ack(2, 1, 2)
        eng.ack(2, 2, 2)
        eng.step(do_tick=False)
        out = eng.kv_values(2)
        assert out[0] == -5 and np.array_equal(out[1:], img[1:])
        return out.tolist()

    _twin(script, 4)


def test_kv_slot_backpressure_queues_and_drains():
    def script(eng):
        e = eng.n_kv_ents
        assert eng.stage_kv_ops(2, [2], [0], [1]) is True
        idxs = list(range(2, 2 + e + 2))
        assert eng.stage_kv_ops(1, idxs, [0] * len(idxs), list(range(len(idxs)))) is False
        assert len(eng._kv_queue.get(eng.groups[1].row, ())) == 2
        eng.ack(1, 1, idxs[-1])
        eng.ack(1, 2, idxs[-1])
        applied = [eng.step(do_tick=False).kv_applied_ops for _ in range(3)]
        assert not eng._kv_queue
        assert eng.kv_values(1)[0] == len(idxs) - 1
        return applied

    assert sum(_twin(script, 4, n_kv_ents=4)) == 4 + 2


def test_kv_read_backpressure():
    def script(eng):
        for _ in range(eng.n_kv_reads):
            eng.stage_kv_read(1, 0)
        with pytest.raises(RuntimeError):
            eng.stage_kv_read(1, 0)
        res = eng.step(do_tick=False)
        assert len(res.kv_reads) == eng.n_kv_reads
        assert eng.kv_reads_free(1) == eng.n_kv_reads
        return res.kv_reads

    _twin(script, 4)


def test_kv_rebase_shifts_buffered_ents():
    def script(eng):
        eng.stage_kv_ops(1, [2], [0], [7])
        eng.ack(1, 1, 5)
        eng.ack(1, 2, 2)
        eng.step(do_tick=False)
        assert eng.committed_index(1) == 2
        eng.stage_kv_ops(1, [4], [1], [8])
        eng.step(do_tick=False)
        eng.rebase(1)
        eng.ack(1, 2, 4)
        res = eng.step(do_tick=False)
        assert res.commit[1] == 4
        vals = eng.kv_values(1)
        assert vals[0] == 7 and vals[1] == 8
        return vals.tolist(), eng._kv_ent_rel.tolist()

    _twin(script, 4)


def test_kv_pipelined_block_and_hook_match_jax():
    """Pipelined K-round blocks with kv ops staged while the previous
    block is in flight; the egress hook fires at every harvest that
    carried captures, internal ones included."""
    def script(eng):
        seen = []
        eng.kv_egress_hook = lambda res: seen.append(res.kv_reads)
        out = []
        for b in range(3):
            for r in range(2):
                idx = 2 + 2 * b + r
                eng.stage_kv_ops(1, [idx], [r], [100 * b + r])
                eng.ack(1, 1, idx)
                eng.ack(1, 2, idx - 1)
                eng.stage_kv_read(1, r)
                eng.begin_round()
            res = eng.step_rounds(do_tick=False, pipelined=True)
            out.append(None if res is None else (res.kv_reads, res.kv_applied_ops))
        eng.set_randomized_timeout(2, 7)  # a rare-path sync harvests internally
        assert eng.harvest() is None
        return out, seen, eng.kv_values(1).tolist()

    out, seen, _ = _twin(script, 4)
    assert len(seen) == 3 and out[0] is None


def test_devsm_off_structural_identity(monkeypatch):
    """A kv-free port engine keeps the latch down: the kv fields stay out
    of the row syncs and at their reset values, no entry point is asked
    for the plane or its purge (so no kv_plane launches), and the kv
    egress stays absent."""
    from dragonboat_tpu_torch.ops import engine as tengine

    seen = []
    real_multi, real_dense = tengine.quorum_multiround, tengine.quorum_step_dense

    def multi(*a, **kw):
        seen.append((kw["has_kv"], kw["purge_kv"]))
        return real_multi(*a, **kw)

    def dense(*a, **kw):
        seen.append((kw["has_kv"], False))
        return real_dense(*a, **kw)

    monkeypatch.setattr(tengine, "quorum_multiround", multi)
    monkeypatch.setattr(tengine, "quorum_step_dense", dense)
    tk.reset_launch_counts()
    eng = tengine.BatchedQuorumEngine(6, 3, event_cap=256, device="cpu", dense_ingest=True)
    for cid in range(1, 7):
        eng.add_group(cid, node_ids=[1, 2, 3], self_id=1)
        eng.set_leader(cid, term=1, term_start=1, last_index=1)
    assert eng._devsm_used is False
    for key in ts.DEVSM_PLANE_FIELDS:
        assert key not in eng._sync_keys()
    eng.ack(1, 2, 2)
    sl = eng.stage_read(2, count=1)
    eng.read_ack(2, 2, sl)
    eng.begin_round()
    eng.stage_recycle(3, 103, term=2, term_start=1, last_index=1)
    eng.set_follower(4, term=2)
    eng.begin_round()
    eng.step_rounds(do_tick=True)
    eng.step(do_tick=True)
    res = eng.step(do_tick=False)
    assert eng._devsm_used is False and "kv_value" not in eng._sync_keys()
    assert seen and all(s == (False, False) for s in seen)
    assert tk.launch_counts()["kv_plane"] == 0
    assert not eng.dev.kv_value.any() and (eng.dev.kv_ent_index == -1).all()
    assert res.kv_cids is None and res.kv_applied_ops == 0


# ----------------------------------------------------------------------
# rung 4's write window with the device state machine on, small
# ----------------------------------------------------------------------


def test_rung4_devsm_matches_jax_and_the_oracle():
    """256 groups, K = 4: every group acks one index a round, stages its
    SETs at every other index of the block in one call and two KV reads;
    each block's captures equal the oracle at the watermark, the final
    values too, and every staged op applies."""
    n, k, blocks, v = 256, 4, 3, ts.KV_SLOTS
    pair = Pair(n, 5, event_cap=4 * n, device_ticks=False)
    for cid in range(1, n + 1):
        pair.add_group(cid, node_ids=[1, 2, 3, 4, 5], self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=1)
    pair._upload_dirty()
    rng = np.random.default_rng(2025)
    rows = np.arange(n, dtype=np.int32)
    rows3 = np.concatenate([rows, rows, rows])
    slots = np.repeat(np.arange(3, dtype=np.int32), n)
    orc = {cid: _KVOracle(v) for cid in range(1, n + 1)}
    log = {cid: {} for cid in range(1, n + 1)}  # key -> [(index, value)]
    pending = {}  # (cid, slot) -> (key, the round's watermark)
    captures, applied, rel = 0, 0, 1

    def value_at(cid, key, w):
        ops = [(i, val) for i, val in log[cid].get(key, []) if i <= w]
        return max(ops)[1] if ops else 0

    def harvested(ra, rb, tag):
        nonlocal captures, applied
        pair.check_result(ra, rb, tag)
        if rb is None:
            return
        assert ra.kv_reads == rb.kv_reads and ra.kv_applied_ops == rb.kv_applied_ops, tag
        applied += rb.kv_applied_ops
        for cid, q in rb.commit.items():
            orc[cid].commit(q)
        for cid, slot, value, index in rb.kv_reads:
            key, at = pending.pop((cid, slot))
            assert index == at and value == value_at(cid, key, index), tag
            captures += 1

    for b in range(blocks):
        keys = rng.integers(0, v, (n, k // 2))
        vals = rng.integers(I32_MIN, I32_MAX, (n, k // 2), endpoint=True)
        idxs = rel + 1 + 2 * np.arange(k // 2)
        for cid in range(1, n + 1):
            assert pair.j.stage_kv_ops(cid, idxs, keys[cid - 1], vals[cid - 1])
            assert pair.t.stage_kv_ops(cid, idxs, keys[cid - 1], vals[cid - 1])
            for i, key, val in zip(idxs.tolist(), keys[cid - 1].tolist(),
                                   vals[cid - 1].tolist()):
                orc[cid].stage(i, key, val)
                log[cid].setdefault(key, []).append((i, val))
        for r in range(k):
            rel += 1
            pair.ack_block(rows3, slots, np.full(rows3.size, rel, np.int32))
            if r in (1, k - 1):
                for cid in range(1, n + 1):
                    key = int(rng.integers(v))
                    sj, st = pair.stage_kv_read(cid, key)
                    assert sj == st
                    pending[(cid, st)] = (key, rel)
            pair.begin_round()
        ra, rb = pair.step_rounds(do_tick=False, pipelined=True)
        harvested(ra, rb, f"block {b}")
    ra, rb = pair.harvest()
    harvested(ra, rb, "end")
    assert captures == n * 2 * blocks and not pending
    assert applied == n * (k // 2) * blocks
    assert not pair.t._kv_queue
    pair.check_state("rung4_devsm")
    for cid in range(1, n + 1):
        assert np.array_equal(pair.t.kv_values(cid), orc[cid].values), cid
