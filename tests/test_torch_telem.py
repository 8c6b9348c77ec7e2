"""The port's device telemetry fold against the JAX package's.

Kernel level: the plain ``telem_fold`` (and its entry point on CPU
tensors) against the JAX ``telem_fold`` on random states with many tied
lags, dead rows, lags at 2^i - 1, 2^i and 2^25 - 1, and occupied read
and kv slots, for G in {1, 5, 8, 256}, k in {1, 8, 16} and the occupancy
sweeps on and off.  Zero tolerance: integer work.

Engine level: the twins of the engine cases of ``tests/test_telem.py``.
The port's engine and the JAX engine get the same op stream; after every
dispatch their ``telem_snapshot`` agree on every field but ``seq`` and
``mono``, and the port's matches the suite's numpy oracle.
"""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from test_telem import _assert_matches, _prev, _shard_oracle  # noqa: E402
from test_torch_engine import (  # noqa: E402
    FLAG_NAMES,
    Pair,
    _rare_path,
    _react,
    _setup,
    _stage_round_events,
)
from test_torch_hier import _Spy  # noqa: E402
from test_torch_kernels import random_fields, to_jax_state  # noqa: E402

torch.set_num_threads(1)

EDGES = [0, 0, 0, 1, 2, 3, 4, 7, 8, 2**14 - 1, 2**14, 2**15, 2**25 - 1, 2**25]


def telem_fields(seed, g, p=3):
    f = random_fields(seed, g, p)
    rng = np.random.default_rng(seed + 1)
    f["last_index"][:] = f["committed"] + rng.choice(EDGES, g)
    f["telem_prev_committed"][:] = np.where(rng.random(g) < 0.5, f["committed"], 0)
    f["read_count"][:] = rng.integers(0, 3, f["read_count"].shape)
    f["kv_ent_index"][:] = rng.integers(-1, 3, f["kv_ent_index"].shape)
    return f


@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("g", [1, 5, 8, 256])
def test_telem_fold_matches_jax(g, k):
    for i, (reads, kv) in enumerate(
        [(False, False), (True, False), (False, True), (True, True)]
    ):
        f = telem_fields(8000 + 10 * g + k + i, g)
        jst, jagg = jk.telem_fold(to_jax_state(f), k, count_reads=reads, count_kv=kv)
        pst, pagg = tk.telem_fold_impl(
            ts.state_from_numpy(f, device="cpu"), k, reads, kv
        )
        st = ts.state_from_numpy(f, device="cpu")
        eagg = tk.telem_fold(st, k, reads, kv)  # the entry point, in place
        for name in jk.TelemAggregate._fields:
            want = np.asarray(getattr(jagg, name))
            for got in (getattr(pagg, name).numpy(), getattr(eagg, name).numpy()):
                assert got.dtype == want.dtype and np.array_equal(got, want), (
                    g, k, reads, kv, name)
        want = np.asarray(jst.telem_prev_committed)
        assert np.array_equal(pst.telem_prev_committed.numpy(), want)
        assert np.array_equal(st.telem_prev_committed.numpy(), want)
        assert tk.telem_block(eagg).shape == (tk.TELEM_HEAD + 2 * min(k, g),)


# ----------------------------------------------------------------------
# engine twins (tests/test_telem.py)
# ----------------------------------------------------------------------


def _build(n_groups=12, n_peers=3, last_index=1, cap=256, telem=True):
    pair = Pair(n_groups, n_peers, event_cap=cap)
    if telem:
        pair.enable_telem()
    for cid in range(1, n_groups + 1):
        pair.add_group(cid, node_ids=list(range(1, n_peers + 1)), self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=last_index)
    pair._upload_dirty()
    return pair


def _same(pair, tag):
    """Both engines' snapshots agree on every field but seq and mono."""
    sj, st = pair.j.telem_snapshot(), pair.t.telem_snapshot()
    assert (sj is None) == (st is None), tag
    if sj is not None:
        assert set(sj) == set(st), tag
        for key in set(sj) - {"seq", "mono"}:
            a, b = sj[key], st[key]
            if key == "topk":
                a, b = [tuple(x) for x in a], [tuple(x) for x in b]
            assert a == b, (tag, key, a, b)
    return st


def _step(pair, tag, **kw):
    ra, rb = pair.step(**kw)
    pair.check(ra, rb, tag)
    return rb


def test_telem_sparse_steps_match_oracle():
    rng = random.Random(2001)
    g = 12
    pair = _build(g, last_index=20)
    for step in range(5):
        for _ in range(rng.randrange(1, 10)):
            cid = rng.randrange(1, g + 1)
            pair.ack(cid, 2, rng.choice([1, 2, 5, 9, 17, 20]))
        prev = _prev(pair.t)
        _step(pair, step, do_tick=False)
        snap = _same(pair, step)
        _assert_matches(snap, _shard_oracle(pair.t, prev), f"step{step}")
        assert snap["seq"] == step + 1
        assert np.array_equal(_prev(pair.t), pair.t.dev.committed.numpy())


def test_telem_stalled_semantics():
    pair = _build(4, last_index=10)
    for cid in (1, 2, 3):
        pair.ack(cid, 2, 5)
    _step(pair, "first", do_tick=False)
    assert _same(pair, "first")["stalled"] == 1
    pair.ack(3, 2, 9)
    prev = _prev(pair.t)
    _step(pair, "second", do_tick=False)
    snap = _same(pair, "second")
    _assert_matches(snap, _shard_oracle(pair.t, prev), "stalled")
    assert snap["stalled"] == 3
    assert (4, 10) in [tuple(p) for p in snap["topk"]]


def test_telem_topk_ties_break_toward_lower_row():
    pair = _build(6, last_index=8)
    for cid in (2, 4, 5):
        pair.ack(cid, 2, 8)
    prev = _prev(pair.t)
    _step(pair, "ties", do_tick=False)
    snap = _same(pair, "ties")
    _assert_matches(snap, _shard_oracle(pair.t, prev), "ties")
    assert [tuple(p) for p in snap["topk"]][:3] == [(1, 8), (3, 8), (6, 8)]


def test_telem_topk_k_override():
    pair = Pair(8, 3, event_cap=128)
    pair.enable_telem(topk=2)
    assert pair.t.n_telem_topk == 2
    for cid in range(1, 9):
        pair.add_group(cid, node_ids=[1, 2, 3], self_id=1)
        pair.set_leader(cid, term=1, term_start=1, last_index=4)
    pair._upload_dirty()
    pair.ack(1, 2, 1)
    prev = _prev(pair.t)
    _step(pair, "k=2", do_tick=False)
    snap = _same(pair, "k=2")
    assert len(snap["topk"]) == 2
    _assert_matches(snap, _shard_oracle(pair.t, prev), "k=2")


def test_telem_fused_multiround_matches_fresh_fold():
    rng = random.Random(2002)
    g = 10
    pair = _build(g, last_index=30)
    for blk in range(3):
        n_rounds = rng.randrange(2, 5)
        for _ in range(n_rounds):
            for _ in range(rng.randrange(1, 8)):
                cid = rng.randrange(1, g + 1)
                pair.ack(cid, 2, rng.choice([2, 7, 13, 28, 30]))
            pair.begin_round()
        prev = _prev(pair.t)
        ra, rb = pair.step_rounds(do_tick=False)
        pair.check(ra, rb, blk)
        snap = _same(pair, blk)
        _assert_matches(snap, _shard_oracle(pair.t, prev), "fused")
        assert snap["rounds"] == n_rounds


def test_telem_recycle_mid_block_resets_watermark():
    pair = _build(6, last_index=4)
    for cid in range(1, 7):
        pair.ack(cid, 2, 4)
    pair.begin_round()
    ra, rb = pair.step_rounds(do_tick=False)
    pair.check(ra, rb, "first")
    assert _same(pair, "first")["stalled"] == 0
    pair.stage_recycle(3, 103, term=2, term_start=0, last_index=9)
    pair.ack(1, 2, 2)
    pair.begin_round()
    prev = _prev(pair.t)
    prev[pair.t.groups[103].row] = 0  # in-program reset at round start
    ra, rb = pair.step_rounds(do_tick=False)
    pair.check(ra, rb, "recycle")
    snap = _same(pair, "recycle")
    _assert_matches(snap, _shard_oracle(pair.t, prev), "recycle")
    assert snap["stalled"] == 1
    assert tuple(snap["topk"][0]) == (103, 9)
    assert 3 not in [p[0] for p in snap["topk"]]


def test_telem_off_structural_identity(monkeypatch):
    """Until enable_telem, every dispatch runs has_telem=False, the
    snapshot is None, the watermark never joins the row syncs and stays
    all-zero on the device; after the flip the next dispatch folds."""
    spy = _Spy(monkeypatch)
    pair = _build(8, last_index=6, telem=False)
    eng = pair.t
    assert not eng._telem_used and not eng.telem_enabled
    for cid in range(1, 9):
        pair.ack(cid, 2, 5)
    _step(pair, "off", do_tick=False)
    pair.ack(1, 2, 6)
    pair.begin_round()
    ra, rb = pair.step_rounds(do_tick=False)
    pair.check(ra, rb, "off fused")
    assert eng.telem_snapshot() is None
    for k in eng._TELEM_KEYS:
        assert k not in eng._sync_keys()
    assert not eng.dev.telem_prev_committed.any()
    assert spy.calls and not any(t for _, t in spy.calls)
    pair.enable_telem()
    spy.calls.clear()
    pair.ack(2, 2, 6)
    prev = _prev(eng)
    _step(pair, "post-flip", do_tick=False)
    _assert_matches(_same(pair, "post-flip"), _shard_oracle(eng, prev), "post-flip")
    for k in eng._TELEM_KEYS:
        assert k in eng._sync_keys()
    assert spy.calls and all(t for _, t in spy.calls)


@pytest.mark.parametrize("mode", ["sparse", "dense", "fused"])
def test_telem_and_hier_engine_script_matches_jax(mode):
    """The engine op script of ``test_torch_engine.py`` (elections, votes,
    rebases, row reuse, recycles, chunked sparse backlogs) with the fold
    on and the hier rule on every third group: state, egress and
    snapshots equal after every dispatch."""
    dense = {"sparse": False, "dense": True, "fused": "auto"}[mode]
    pair = Pair(40, 5, event_cap=24, dense_ingest=dense)
    pair.enable_telem(topk=4)
    rng = random.Random(31)
    info = _setup(pair, rng, 36)
    for cid in info:
        if cid % 3 == 0 and len(info[cid]["peers"]) == 5:
            pair.set_hier(cid, [1, 2, 3], 2)
    leaders = {cid for cid in info if cid % 2}
    next_cid = 3000
    seen = dict.fromkeys(FLAG_NAMES, 0)
    for rnd in range(10):
        if mode == "fused":
            for r in range(2):
                if r == 1 and rnd % 2 == 0:
                    old = sorted(leaders)[rnd]
                    pair.stage_recycle(old, next_cid, term=2, term_start=1, last_index=1)
                    info[next_cid] = {"peers": info.pop(old)["peers"], "term": 2, "last": 1}
                    leaders.discard(old)
                    leaders.add(next_cid)
                    next_cid += 1
                _stage_round_events(pair, rng, info, leaders)
                pair.begin_round()
            next_cid = _rare_path(pair, rng, info, leaders, rnd, next_cid)
            ra, rb = pair.step_rounds(do_tick=True, pad_rounds_to=4)
        else:
            _stage_round_events(pair, rng, info, leaders)
            next_cid = _rare_path(pair, rng, info, leaders, rnd, next_cid)
            ra, rb = pair.step(do_tick=rnd % 3 != 2)
        pair.check(ra, rb, (mode, rnd))
        snap = _same(pair, (mode, rnd))
        assert snap is not None and snap["groups"] == len(info)
        _react(pair, rng, info, leaders, ra, seen)
    assert pair.t._hier_used and seen["elect"] and seen["won"], seen
