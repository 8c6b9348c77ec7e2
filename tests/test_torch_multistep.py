"""The port's R-round scans and the headline ladder against the JAX
package and ``bench.py``, bit for bit.

``quorum_multistep`` and ``quorum_multistep_dense`` on CPU tensors run the
plain versions (R steps in turn); they are held against the JAX jit
programs over the flag grid and peer widths, on sparse batches with
duplicate, stale and negative acks, a valid ack on a row out of range,
one on a slot out of range, and invalid padding.  ``staged_multistep``
is held against ``bench._staged_multistep_fn``, and the ladder's modes run
on the CPU with every watermark checked.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import itertools
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu.ops import state as js  # noqa: E402
from dragonboat_tpu.ops.engine import BatchedQuorumEngine as JaxEngine  # noqa: E402
from dragonboat_tpu_torch import ladder  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402
from dragonboat_tpu_torch.ops.engine import BatchedQuorumEngine  # noqa: E402

torch.set_num_threads(1)

G, R, CAP = 96, 6, 120
PEERS = [1, 3, 5, 8, 9]
FLAGS = list(itertools.product([False, True], repeat=4))
FLAG_NAMES = "do_tick,track_contact,has_votes,has_hier"


def random_fields(seed: int, g: int, p: int) -> dict:
    """Leaders, candidates, followers, observers and dead rows with random
    progress, votes, clocks, membership and hier geometry; some match
    cells at INDEX_MIN and below zero."""
    rng = np.random.default_rng(seed)
    f = ts.state_to_numpy(ts.make_state(g, p, device="cpu"))
    f["node_state"][:] = rng.choice([0, 1, 1, 2, 2, 2, 3, 4], g)
    f["live"][:] = rng.random(g) < 0.9
    f["term"][:] = rng.integers(0, 6, g)
    f["voting"][:] = rng.random((g, p)) < 0.8
    f["present"][:] = f["voting"] | (rng.random((g, p)) < 0.5)
    f["quorum"][:] = f["voting"].sum(1) // 2 + 1
    f["self_slot"][:] = rng.integers(0, p, g)
    f["self_slot"][::17] = p  # out of range: _self_column gives 0
    f["match"][:] = rng.integers(0, 20, (g, p))
    f["match"][::7, 0] = ts.INDEX_MIN
    f["match"][3::11, p - 1] = -4
    f["next"][:] = np.maximum(f["match"], 0) + rng.integers(1, 4, (g, p))
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
    f["votes"][:] = rng.choice([-1, -1, -1, 0, 1], (g, p))
    f["near"][:] = rng.random((g, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, p + 2, g)
    f["sub_quorum"][::3] = 0
    return f


def sparse_rounds(seed, r, g, p, cap):
    """R rounds of padded events: duplicate, stale and negative acks, a
    valid ack whose row is out of range and one whose slot is out of range
    (its row is still contacted), invalid padding that points at real
    cells; votes on distinct cells a round."""
    rng = np.random.default_rng(seed)
    n = cap - 7
    ag = rng.integers(0, g, (r, cap)).astype(np.int32)
    ap = rng.integers(0, p, (r, cap)).astype(np.int32)
    av = rng.integers(-5, 25, (r, cap)).astype(np.int32)
    ag[:, 10:20], ap[:, 10:20] = ag[:, :10], ap[:, :10]  # duplicates
    valid = np.zeros((r, cap), bool)
    valid[:, :n] = True
    ag[:, 3], ap[:, 5] = g + 2, p  # valid but out of range
    vcap = min(cap // 2, g * p)
    vg = np.zeros((r, vcap), np.int32)
    vp = np.zeros((r, vcap), np.int32)
    for k in range(r):
        cells = rng.choice(g * p, size=vcap, replace=False)
        vg[k], vp[k] = cells // p, cells % p
    vv = rng.integers(0, 2, (r, vcap)).astype(np.int8)
    vvalid = rng.random((r, vcap)) < 0.8
    return (ag, ap, av, valid), (vg, vp, vv, vvalid)


def dense_rounds(seed, r, g, p):
    """R rounds of (G, P) planes: negative acks where touched and garbage
    where untouched (both sides read an ack only where it is touched)."""
    rng = np.random.default_rng(seed)
    touched = rng.random((r, g, p)) < 0.35
    ack_max = rng.integers(-5, 25, (r, g, p)).astype(np.int32)
    vote_new = rng.choice([-1, -1, -1, 0, 1], (r, g, p)).astype(np.int8)
    return ack_max, touched, vote_new


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


def _jax_state(fields):
    return js.QuorumState(**{k: jnp.asarray(v.copy()) for k, v in fields.items()})


# ----------------------------------------------------------------------
# B13: the R-round scans
# ----------------------------------------------------------------------


@pytest.mark.parametrize(FLAG_NAMES, FLAGS)
@pytest.mark.parametrize("p", PEERS)
def test_quorum_multistep_matches_jax(p, do_tick, track_contact, has_votes, has_hier):
    flags = dict(do_tick=do_tick, track_contact=track_contact,
                 has_votes=has_votes, has_hier=has_hier)
    seed = 100 * p + FLAGS.index((do_tick, track_contact, has_votes, has_hier))
    fields = random_fields(seed, G, p)
    acks, votes = sparse_rounds(seed, R, G, p, CAP)
    jout = jk.quorum_multistep(_jax_state(fields), *(J(a) for a in acks),
                               *(J(v) for v in votes), **flags)
    st = ts.state_from_numpy(fields, device="cpu")
    tout = tk.quorum_multistep(st, *(T(a) for a in acks), *(T(v) for v in votes), **flags)
    assert tout.state is st and tout.committed is st.committed  # in place
    assert_outputs_equal(jout, tout, (p, flags))


@pytest.mark.parametrize(FLAG_NAMES, FLAGS)
@pytest.mark.parametrize("p", PEERS)
def test_quorum_multistep_dense_matches_jax(p, do_tick, track_contact, has_votes,
                                            has_hier):
    flags = dict(do_tick=do_tick, track_contact=track_contact,
                 has_votes=has_votes, has_hier=has_hier)
    seed = 200 * p + FLAGS.index((do_tick, track_contact, has_votes, has_hier))
    fields = random_fields(seed, G, p)
    am, at, vn = dense_rounds(seed, R, G, p)
    jout = jk.quorum_multistep_dense(_jax_state(fields), J(am), J(at), J(vn), **flags)
    st = ts.state_from_numpy(fields, device="cpu")
    tout = tk.quorum_multistep_dense(st, T(am), T(at), T(vn), **flags)
    assert tout.state is st and tout.committed is st.committed
    assert_outputs_equal(jout, tout, (p, flags))


def test_zero_rounds_leave_the_state_and_raise_no_flag():
    """R = 0: the reference's scan over nothing returns the state as it
    was and all-false flags."""
    fields = random_fields(5, 16, 3)
    acks, votes = sparse_rounds(5, 0, 16, 3, 32)
    jout = jk.quorum_multistep(_jax_state(fields), *(J(a) for a in acks),
                               *(J(v) for v in votes))
    tout = tk.quorum_multistep(ts.state_from_numpy(fields, device="cpu"),
                               *(T(a) for a in acks), *(T(v) for v in votes))
    assert_outputs_equal(jout, tout)
    am, at, vn = dense_rounds(5, 0, 16, 3)
    jout = jk.quorum_multistep_dense(_jax_state(fields), J(am), J(at), J(vn))
    tout = tk.quorum_multistep_dense(ts.state_from_numpy(fields, device="cpu"),
                                     T(am), T(at), T(vn))
    assert_outputs_equal(jout, tout)


def _engines(seed, g, p, cap):
    """The reference test's ``_random_engine`` (``tests/test_ops_quorum.py``)
    built on the JAX engine and on the port's, from the same random
    stream: leaders, candidates and followers."""
    out = []
    for cls, kw in ((JaxEngine, {}), (BatchedQuorumEngine, {"device": "cpu"})):
        rng = random.Random(seed)
        eng = cls(g, p, event_cap=cap, **kw)
        for cid in range(1, g + 1):
            eng.add_group(cid, node_ids=list(range(1, p + 1)), self_id=1)
            role = rng.random()
            if role < 0.6:
                eng.set_leader(cid, term=2, term_start=3, last_index=3 + rng.randrange(4))
            elif role < 0.8:
                eng.set_candidate(cid, term=2)
        eng._upload_dirty()
        out.append(eng)
    return out


def test_multistep_has_votes_false_accepts_dummies():
    """Twin of ``tests/test_ops_quorum.py:668``: both multisteps take vote
    dummies of any shape with ``has_votes=False`` and match the
    ``has_votes=True`` result on empty votes, and the sparse and dense end
    states agree — on the port's engine state, and equal to the JAX
    package's."""
    g, p, cap, r = 8, 3, 16, 4
    rows = np.arange(g, dtype=np.int32)
    ag = np.broadcast_to(np.concatenate([rows, rows]), (r, cap)).copy()
    ap = np.broadcast_to(
        np.concatenate([np.zeros(g, np.int32), np.ones(g, np.int32)]), (r, cap)).copy()
    av = np.broadcast_to(4 + np.arange(r, dtype=np.int32)[:, None], (r, cap)).copy()
    avalid = np.ones((r, cap), bool)
    zi, z8, zb = (np.zeros((r, cap), np.int32), np.zeros((r, cap), np.int8),
                  np.zeros((r, cap), bool))
    ack_max = np.zeros((r, g, p), np.int32)
    touched = np.zeros((r, g, p), bool)
    for rr in range(r):
        ack_max[rr, :, :2] = 4 + rr
        touched[rr, :, :2] = True
    vt = np.full((r, g, p), -1, np.int8)

    outs = {}
    for name, lib, arr in (("jax", jk, J), ("port", tk, T)):
        engs = [_engines(3, g, p, cap)[0 if name == "jax" else 1] for _ in range(4)]
        out_t = lib.quorum_multistep(
            engs[0].dev, *(arr(x) for x in (ag, ap, av, avalid, zi, zi, z8, zb)),
            do_tick=True, has_votes=True)
        dummy = (arr(np.zeros((1,), np.int32)), arr(np.zeros((1,), np.int32)),
                 arr(np.zeros((1,), np.int8)), arr(np.zeros((1,), bool)))
        out_f = lib.quorum_multistep(
            engs[1].dev, arr(ag), arr(ap), arr(av), arr(avalid), *dummy,
            do_tick=True, has_votes=False)
        out_dt = lib.quorum_multistep_dense(
            engs[2].dev, arr(ack_max), arr(touched), arr(vt), do_tick=True,
            has_votes=True)
        out_df = lib.quorum_multistep_dense(
            engs[3].dev, arr(ack_max), arr(touched), arr(np.zeros((1, 1), np.int8)),
            do_tick=True, has_votes=False)
        outs[name] = (out_t, out_f, out_dt, out_df)
    for out in outs["port"][1:]:
        assert_outputs_equal(outs["jax"][0], out)  # sparse ≡ dense end state
    for jout, tout in zip(outs["jax"], outs["port"]):
        assert_outputs_equal(jout, tout)


def test_multistep_wrappers_count_no_launch_on_the_cpu():
    tk.reset_launch_counts()
    fields = random_fields(9, 16, 3)
    acks, votes = sparse_rounds(9, 2, 16, 3, 32)
    tk.quorum_multistep(ts.state_from_numpy(fields, device="cpu"),
                        *(T(a) for a in acks), *(T(v) for v in votes))
    tk.staged_multistep(ts.state_from_numpy(fields, device="cpu"), 4, 3)
    assert not any(tk.launch_counts().values())


# ----------------------------------------------------------------------
# B8: the staged dispatch of bench.py's pipelined ladder
# ----------------------------------------------------------------------


@pytest.mark.parametrize("source,rounds,base", [
    ("build_state", 1, 1), ("build_state", 5, 1), ("build_state", 5, 37),
    ("random", 1, 6), ("random", 5, 6), ("random", 5, 2**31 - 3),
])
def test_staged_multistep_matches_bench(source, rounds, base):
    """``staged_multistep`` (the plain version on the CPU) against
    ``bench._staged_multistep_fn`` at G = 64, from ``bench.build_state``'s
    engine state carried across with ``state_from_numpy``, or from a
    random state (elections, dead rows, clocks near their timeouts); one
    base wraps past the int32 maximum.  Every round ticks, so the clocks
    and the check-quorum activity bits must match bit for bit; the flags
    returned are zeros on both sides."""
    g = 64
    if source == "build_state":
        eng = bench.build_state(g, 64)
        fields = {k: np.asarray(v).copy() for k, v in eng.dev._asdict().items()}
    else:
        fields = random_fields(700 + rounds, g, 3)
    staged = bench._staged_multistep_fn(g, rounds)
    jout = staged(_jax_state(fields), jnp.int32(base))
    st = ts.state_from_numpy(fields, device="cpu")
    tout = tk.staged_multistep(st, base, rounds)
    assert tout.state is st
    assert_outputs_equal(jout, tout, (source, rounds, base))
    if source == "build_state":
        assert (st.committed == base + rounds).all()


def test_staged_multistep_refuses_a_base_outside_int32():
    st = ts.make_state(4, 3, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        tk.staged_multistep(st, 2**31, 1)
    with pytest.raises(ValueError, match="rounds"):
        tk.staged_multistep(st, 1, -1)


def test_ladder_run_mode_on_the_cpu():
    """The pipelined and the latency-bounded operating points at G = 128:
    every dispatch's watermarks equal the write count (``run_mode`` checks
    every row and raises otherwise)."""
    for rounds, dispatches, warmup in ((5, 3, 3), (1, 6, 5)):
        out = ladder.run_mode(128, rounds, dispatches, warmup=warmup, device="cpu")
        assert out["groups"] == 128 and len(out["dispatch_ms"]) == dispatches
        assert out["writes_per_sec"] > 0 and out["setup_s"] >= 0


def test_ladder_run_mode_checks_every_row(monkeypatch):
    """A dispatch that leaves one row behind is refused, whichever row."""
    real = tk.staged_multistep

    def lagging(st, base, rounds):
        out = real(st, base, rounds)
        st.committed[77] -= 1
        return out

    monkeypatch.setattr(ladder, "staged_multistep", lagging)
    with pytest.raises(RuntimeError, match="row 77"):
        ladder.run_mode(128, 2, 1, warmup=1, device="cpu")


def test_ladder_host_loop_on_the_cpu():
    """The host loop at G = 128 through the port's engine: every row's
    final watermark equals the write count, and the engine's committed
    state equals the JAX engine's after the same staging."""
    out = ladder.run_host_loop(128, 3, k=4, device="cpu")
    assert out["rounds"] == 3 and len(out["dispatch_ms"]) == 3
    assert out["writes_per_sec"] > 0
    eng = bench.build_state(128, 256, device_ticks=False)
    port = ladder.build_state(128, 256, device_ticks=False, device="cpu")
    rows = np.tile(np.arange(128, dtype=np.int32), 2)
    slots = np.repeat(np.arange(2, dtype=np.int32), 128)
    rels = 2 + np.arange(4, dtype=np.int32)[:, None] + np.zeros((1, 256), np.int32)
    for e in (eng, port):
        e.ack_block_rounds(rows, slots, rels)
        e.step_rounds(do_tick=False)
    assert np.array_equal(eng.committed_view(), port.committed_view())
    assert (port.committed_view() == 5).all()
    jst = {k: np.asarray(v) for k, v in eng.dev._asdict().items()}
    tst = ts.state_to_numpy(port.dev)
    for name in jst:
        assert np.array_equal(jst[name], tst[name]), name
