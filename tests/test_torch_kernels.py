"""The port's plain kernels against the JAX package's, bit for bit.

The same states and event batches, made with numpy from a seed, go through
``dragonboat_tpu.ops.kernels`` (jitted, on the CPU) and through the port's
entry points on CPU tensors, which run the plain PyTorch versions.  Every
state field and every output must be equal: all of this is integer and
boolean work, so the tolerance is zero.  The CUDA kernels are held against
these same plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu.ops import state as js  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402

torch.set_num_threads(1)

G = 96
WIDTHS = [1, 2, 3, 4, 6, 7, 8, 12]  # with P = 5 in the flag grids: 1..8, 12
FLAGS3 = list(itertools.product([False, True], repeat=3))
# the engine passes track_contact = device_ticks or do_tick, so a ticking
# block always tracks contact
FLAGS4 = [
    f for f in itertools.product([False, True], repeat=4) if f[1] or not f[0]
]


# ----------------------------------------------------------------------
# inputs, made with numpy from a seed
# ----------------------------------------------------------------------


def random_fields(seed: int, g: int, p: int) -> dict:
    """A state of mixed leaders, candidates, followers, observers and dead
    rows with random progress, votes, clocks and membership."""
    rng = np.random.default_rng(seed)
    f = ts.state_to_numpy(ts.make_state(g, p, device="cpu"))
    f["node_state"][:] = rng.choice([0, 1, 2, 2, 2, 3, 4], g)
    f["live"][:] = rng.random(g) < 0.9
    f["term"][:] = rng.integers(0, 6, g)
    f["voting"][:] = rng.random((g, p)) < 0.8
    f["present"][:] = f["voting"] | (rng.random((g, p)) < 0.5)
    f["quorum"][:] = f["voting"].sum(1) // 2 + 1
    f["self_slot"][:] = rng.integers(0, p, g)
    f["self_slot"][::17] = p  # out of range: _self_column gives 0
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
    return f


def dense_inputs(seed, g, p):
    rng = np.random.default_rng(seed)
    touched = rng.random((g, p)) < 0.35
    ack_max = np.where(touched, rng.integers(0, 25, (g, p)), 0).astype(np.int32)
    vote_new = rng.choice([-1, -1, -1, 0, 1], (g, p)).astype(np.int8)
    return ack_max, touched, vote_new


def sparse_inputs(seed, g, p, cap):
    """Padded ack events with duplicates, stale values, out-of-range rows
    and slots and invalid padding; vote events on distinct cells."""
    rng = np.random.default_rng(seed)
    n = cap - 7
    ag = rng.integers(0, g, cap).astype(np.int32)
    ap = rng.integers(0, p, cap).astype(np.int32)
    av = rng.integers(0, 25, cap).astype(np.int32)
    valid = np.zeros(cap, bool)
    valid[:n] = True
    ag[3], ap[5] = g + 2, p  # valid but out of range: dropped
    ag[n:] = rng.integers(0, g, cap - n)  # invalid padding: dropped
    cells = rng.choice(g * p, size=min(cap // 2, g * p), replace=False)
    vg = (cells // p).astype(np.int32)
    vp = (cells % p).astype(np.int32)
    vv = rng.integers(0, 2, cells.size).astype(np.int8)
    vvalid = rng.random(cells.size) < 0.8
    return (ag, ap, av, valid), (vg, vp, vv, vvalid)


def multiround_inputs(seed, k, g, p, c):
    """K rounds: sentinel ack blocks, votes, churn records (each row at most
    once per round, ``g`` = padding) and a partial tick mask."""
    rng = np.random.default_rng(seed)
    ack = np.where(
        rng.random((k, g, p)) < 0.35, rng.integers(0, 25, (k, g, p)), -1
    ).astype(np.int32)
    votes = rng.choice([-1, -1, -1, 0, 1], (k, g, p)).astype(np.int8)
    churn_row = np.full((k, c), g, np.int32)
    for r in range(k):
        n = rng.integers(0, c + 1)
        churn_row[r, :n] = rng.choice(g, size=n, replace=False)
    churn_term = rng.integers(1, 9, (k, c)).astype(np.int32)
    churn_start = rng.integers(0, 5, (k, c)).astype(np.int32)
    churn_last = (churn_start + rng.integers(0, 5, (k, c))).astype(np.int32)
    tick_mask = rng.random(k) < 0.6
    return ack, votes, (churn_row, churn_term, churn_start, churn_last), tick_mask


# ----------------------------------------------------------------------
# comparison
# ----------------------------------------------------------------------


def to_jax_state(fields):
    return js.QuorumState(**{k: jnp.asarray(v.copy()) for k, v in fields.items()})


def to_torch_state(fields):
    return ts.state_from_numpy(fields, device="cpu")


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_outputs_equal(jout, tout, tag=""):
    jstate = {k: np.asarray(v) for k, v in jout.state._asdict().items()}
    tstate = ts.state_to_numpy(tout.state)
    assert list(jstate) == list(tstate)
    for name in jstate:
        assert jstate[name].dtype == tstate[name].dtype, (tag, name)
        assert np.array_equal(jstate[name], tstate[name]), (tag, name)
    for name in ("committed", "won", "lost"):
        a, b = np.asarray(getattr(jout, name)), getattr(tout, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)
    for name in jk.TickFlags._fields:
        a = np.asarray(getattr(jout.flags, name))
        b = getattr(tout.flags, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)


def run_dense(fields, inputs, **flags):
    am, at, vn = inputs
    jout = jk.quorum_step_dense(to_jax_state(fields), J(am), J(at), J(vn), **flags)
    st = to_torch_state(fields)
    tout = tk.quorum_step_dense(st, T(am), T(at), T(vn), **flags)
    assert tout.state is st and tout.committed is st.committed  # in place
    return jout, tout


def run_sparse(fields, acks, votes, **flags):
    jout = jk.quorum_step(
        to_jax_state(fields), *(J(a) for a in acks), *(J(v) for v in votes),
        **flags,
    )
    st = to_torch_state(fields)
    tout = tk.quorum_step(st, *(T(a) for a in acks), *(T(v) for v in votes), **flags)
    assert tout.state is st
    return jout, tout


def run_multiround(fields, ack, votes, churn, tick_mask, **flags):
    jout = jk.quorum_multiround(
        to_jax_state(fields), J(ack), J(votes), *(J(c) for c in churn),
        J(tick_mask), **flags,
    )
    st = to_torch_state(fields)
    tout = tk.quorum_multiround(
        st, T(ack), T(votes), *(T(c) for c in churn), T(tick_mask), **flags
    )
    assert tout.state is st
    return jout, tout


# ----------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8, 12])
def test_kth_largest_matches_jax(p):
    rng = np.random.default_rng(100 + p)
    g = 512
    values = rng.integers(-3, 6, (g, p)).astype(np.int32)  # many ties
    values[::7, 0] = np.iinfo(np.int32).min
    mask = rng.random((g, p)) < 0.7
    k = rng.integers(1, p + 1, g).astype(np.int32)  # 1 <= k <= P
    want = np.asarray(jk._kth_largest(J(values), J(mask), J(k)))
    got = tk._kth_largest(T(values), T(mask), T(k)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    want = np.asarray(jk.commit_quorum(J(values), J(mask), J(k)))
    assert np.array_equal(tk.commit_quorum(T(values), T(mask), T(k)).numpy(), want)


@pytest.mark.parametrize("p", [3, 5, 12])
def test_tally_check_quorum_and_self_column_match_jax(p):
    f = random_fields(7 + p, 200, p)
    votes, voting, quorum = f["votes"], f["voting"], f["quorum"]
    for a, b in zip(jk.vote_tally(J(votes), J(voting), J(quorum)),
                    tk.vote_tally(T(votes), T(voting), T(quorum))):
        assert np.array_equal(np.asarray(a), b.numpy())
    args = (f["active"], voting, f["self_slot"], quorum)
    for a, b in zip(jk.check_quorum(*(J(x) for x in args)),
                    tk.check_quorum(*(T(x) for x in args))):
        assert np.array_equal(np.asarray(a), b.numpy())
    want = np.asarray(jk._self_column(J(f["match"]), J(f["self_slot"])))
    got = tk._self_column(T(f["match"]), T(f["self_slot"])).numpy()
    assert np.array_equal(want, got)


@pytest.mark.parametrize("p", [3, 5, 12])
def test_tick_step_matches_jax(p):
    f = random_fields(31 + p, 200, p)
    jst, jflags = jk.tick_step(to_jax_state(f))
    tst, tflags = tk.tick_step(to_torch_state(f))
    for name, v in jst._asdict().items():
        assert np.array_equal(np.asarray(v), getattr(tst, name).numpy()), name
    for a, b in zip(jflags, tflags):
        assert np.array_equal(np.asarray(a), b.numpy())


# ----------------------------------------------------------------------
# K1: quorum_step_dense
# ----------------------------------------------------------------------


@pytest.mark.parametrize("do_tick,track_contact,has_votes", FLAGS3)
def test_quorum_step_dense_flag_grid(do_tick, track_contact, has_votes):
    seed = 1000 + 4 * do_tick + 2 * track_contact + has_votes
    f = random_fields(seed, G, 5)
    jout, tout = run_dense(
        f, dense_inputs(seed, G, 5), do_tick=do_tick,
        track_contact=track_contact, has_votes=has_votes,
    )
    assert_outputs_equal(jout, tout)


@pytest.mark.parametrize("p", WIDTHS)
def test_quorum_step_dense_peer_widths(p):
    f = random_fields(2000 + p, G, p)
    jout, tout = run_dense(f, dense_inputs(2000 + p, G, p))
    assert_outputs_equal(jout, tout)


# ----------------------------------------------------------------------
# K2: the sparse quorum_step
# ----------------------------------------------------------------------


@pytest.mark.parametrize("do_tick,track_contact,has_votes", FLAGS3)
def test_quorum_step_flag_grid(do_tick, track_contact, has_votes):
    seed = 3000 + 4 * do_tick + 2 * track_contact + has_votes
    f = random_fields(seed, G, 5)
    acks, votes = sparse_inputs(seed, G, 5, cap=256)
    jout, tout = run_sparse(
        f, acks, votes, do_tick=do_tick, track_contact=track_contact,
        has_votes=has_votes,
    )
    assert_outputs_equal(jout, tout)


@pytest.mark.parametrize("p", WIDTHS)
def test_quorum_step_peer_widths(p):
    f = random_fields(4000 + p, G, p)
    acks, votes = sparse_inputs(4000 + p, G, p, cap=256)
    jout, tout = run_sparse(f, acks, votes)
    assert_outputs_equal(jout, tout)


def test_quorum_step_vote_free_round_takes_dummies():
    f = random_fields(4100, G, 5)
    acks, _ = sparse_inputs(4100, G, 5, cap=128)
    dummies = (np.zeros(1, np.int32), np.zeros(1, np.int32),
               np.zeros(1, np.int8), np.zeros(1, bool))
    jout, tout = run_sparse(f, acks, dummies, has_votes=False)
    assert_outputs_equal(jout, tout)


# ----------------------------------------------------------------------
# K3: quorum_multiround
# ----------------------------------------------------------------------


@pytest.mark.parametrize("do_tick,track_contact,has_votes,has_churn", FLAGS4)
def test_quorum_multiround_flag_grid(do_tick, track_contact, has_votes, has_churn):
    seed = 5000 + 8 * do_tick + 4 * track_contact + 2 * has_votes + has_churn
    f = random_fields(seed, G, 5)
    ack, votes, churn, tick_mask = multiround_inputs(seed, 5, G, 5, c=6)
    jout, tout = run_multiround(
        f, ack, votes, churn, tick_mask, do_tick=do_tick,
        track_contact=track_contact, has_votes=has_votes, has_churn=has_churn,
    )
    assert_outputs_equal(jout, tout)


@pytest.mark.parametrize("p", WIDTHS)
def test_quorum_multiround_peer_widths(p):
    f = random_fields(6000 + p, G, p)
    ack, votes, churn, tick_mask = multiround_inputs(6000 + p, 4, G, p, c=5)
    jout, tout = run_multiround(
        f, ack, votes, churn, tick_mask, do_tick=True, has_votes=True,
        has_churn=True,
    )
    assert_outputs_equal(jout, tout)


def test_quorum_multiround_padded_block_matches_jax():
    """The coordinator's fixed-K shape: real rounds, then event-free,
    tick-masked-off padding rounds with padding churn records."""
    f = random_fields(6100, G, 3)
    ack, votes, churn, _ = multiround_inputs(6100, 6, G, 3, c=4)
    ack[3:] = -1
    votes[3:] = -1
    churn[0][3:] = G
    tick_mask = np.array([True, True, True, False, False, False])
    jout, tout = run_multiround(
        f, ack, votes, churn, tick_mask, do_tick=True, has_votes=True,
        has_churn=True,
    )
    assert_outputs_equal(jout, tout)


# ----------------------------------------------------------------------
# the optional planes on every entry point
# ----------------------------------------------------------------------

OFF_SLICE = ["has_hier", "has_telem", "has_reads", "has_kv"]


def _read_inputs(entry, g=4, p=3, s=ts.READ_SLOTS):
    """Empty read-plane inputs (no stage, no echo) for the entry's shape."""
    lead = (1,) if entry == "quorum_multiround" else ()
    return {
        "read_stage_idx": torch.full(lead + (g, s), -1, dtype=torch.int32),
        "read_stage_cnt": torch.zeros(lead + (g, s), dtype=torch.int32),
        "read_ack": torch.zeros(lead + (g, s, p), dtype=torch.bool),
    }


def _kv_inputs(entry, g=4, e=ts.KV_ENT_SLOTS, r=ts.KV_READ_SLOTS):
    """Empty devsm inputs (no stage, no read) for the entry's shape."""
    lead = (1,) if entry == "quorum_multiround" else ()
    return {
        "kv_ent_idx": torch.full(lead + (g, e), -1, dtype=torch.int32),
        "kv_ent_key": torch.zeros(lead + (g, e), dtype=torch.int32),
        "kv_ent_val": torch.zeros(lead + (g, e), dtype=torch.int32),
        "kv_read_key": torch.full(lead + (g, r), -1, dtype=torch.int32),
    }


def _entry_args(entry):
    z = torch.zeros((4,), dtype=torch.int32)
    if entry == "quorum_step":
        return (z, z, z, z.bool(), z, z, z.to(torch.int8), z.bool())
    if entry == "quorum_step_dense":
        m = torch.zeros((4, 3), dtype=torch.int32)
        return (m, m.bool(), m.to(torch.int8))
    c = torch.zeros((1, 1), dtype=torch.int32)
    return (torch.full((1, 4, 3), -1, dtype=torch.int32),
            torch.zeros((1, 1, 1), dtype=torch.int8), c, c, c, c,
            torch.ones((1,), dtype=torch.bool))


@pytest.mark.parametrize("flag", OFF_SLICE)
@pytest.mark.parametrize("entry", ["quorum_step", "quorum_step_dense", "quorum_multiround"])
def test_off_slice_flags_raise(entry, flag):
    """Every plane the JAX entry points take runs in the port: each flag
    alone, then all four together (the sparse step takes has_reads and
    has_kv as the fold's hints alone, with no event planes)."""
    st = ts.make_state(4, 3, device="cpu")
    args = _entry_args(entry)
    kw = {flag: True}
    planes = entry != "quorum_step"
    if flag == "has_reads" and planes:
        kw.update(_read_inputs(entry))
    if flag == "has_kv" and planes:
        kw.update(_kv_inputs(entry))
    out = getattr(tk, entry)(st, *args, **kw)
    assert (out.telem is not None) == (flag == "has_telem")
    assert (out.read_done_count is not None) == (flag == "has_reads" and planes)
    assert (out.kv_read_val is not None) == (flag == "has_kv" and planes)
    if flag == "has_kv" and planes:
        assert out.kv_read_index.eq(-1).all() and not out.kv_applied.any()
    kw = dict.fromkeys(OFF_SLICE, True)
    if planes:
        kw.update(_read_inputs(entry), **_kv_inputs(entry))
    out = getattr(tk, entry)(st, *args, **kw)
    assert out.telem is not None
    assert (out.kv_applied is not None) == planes


@pytest.mark.parametrize("flag", ["purge_reads", "purge_kv", "purge_telem"])
def test_plane_purge_on_recycle_raises(flag):
    """Each plane's recycle purge runs on a block with churn and resets
    the recycled row's plane (and no other row's); without churn no
    recycle runs, so the flag has nothing to reset."""
    f = ts.state_to_numpy(ts.make_state(4, 3, device="cpu"))
    f["read_index"][:] = 3
    f["read_count"][:] = 2
    f["read_acks"][:] = True
    f["kv_value"][:] = 7
    f["kv_ent_index"][:] = 5
    f["kv_ent_key"][:] = 1
    f["kv_ent_val"][:] = 9
    f["telem_prev_committed"][:] = 4
    fields = {"purge_reads": ts.READ_PLANE_FIELDS, "purge_kv": ts.DEVSM_PLANE_FIELDS,
              "purge_telem": ts.TELEM_PLANE_FIELDS}[flag]
    c = torch.zeros((1, 1), dtype=torch.int32)
    args = (torch.full((1, 4, 3), -1, dtype=torch.int32),
            torch.zeros((1, 1, 1), dtype=torch.int8), c + 2, c + 1, c, c,
            torch.ones((1,), dtype=torch.bool))
    st = ts.state_from_numpy(f, device="cpu")
    tk.quorum_multiround(st, *args, has_churn=True, **{flag: True})
    fresh = ts.state_to_numpy(ts.make_state(4, 3, device="cpu"))
    for name in fields:
        after = getattr(st, name).numpy()
        assert np.array_equal(after[2], fresh[name][2]), name
        assert np.array_equal(after[[0, 1, 3]], f[name][[0, 1, 3]]), name
    for other in {"purge_reads", "purge_kv", "purge_telem"} - {flag}:
        for name in {"purge_reads": ts.READ_PLANE_FIELDS,
                     "purge_kv": ts.DEVSM_PLANE_FIELDS,
                     "purge_telem": ts.TELEM_PLANE_FIELDS}[other]:
            assert np.array_equal(getattr(st, name).numpy(), f[name]), name
    st = ts.state_from_numpy(f, device="cpu")
    tk.quorum_multiround(st, *args, has_churn=False, **{flag: True})
    for name in fields:
        assert np.array_equal(getattr(st, name).numpy(), f[name]), name


def test_wrappers_count_no_launch_on_the_cpu():
    tk.reset_launch_counts()
    f = random_fields(7000, 16, 3)
    run_dense(f, dense_inputs(7000, 16, 3))
    assert tk.launch_counts() == {
        "quorum_step": 0, "quorum_step_dense": 0, "quorum_multiround": 0,
        "telem_fold": 0, "finish_hier": 0, "read_plane": 0, "kv_plane": 0,
        "quorum_multistep": 0, "quorum_multistep_dense": 0, "staged_multistep": 0,
    }
