"""K1 and K2 (the single-round step kernels) at block and alignment
edges, emulated on the CPU, against the port's plain versions and the
JAX package.

K1 (``quorum_step_dense``) and K2's row pass (``quorum_step``) stage a
block's rows through shared memory: every plane's slab moves as 16-byte
vectors where the plane is 16-byte aligned and element by element where
it is not or where the last, ragged block's slab ends mid-vector.  These
tests run the CUDA sources built as host C++ (``QS_EMULATE``, as
``tests/test_torch_csrc.py`` does: a block's threads run as fibers that
meet at its barriers) at G in {1, 257, 300, 4,099} (one row, a block and
a row, a ragged last block, many blocks) for every peer width, on the
same numpy inputs as the plain versions and the JAX package's step
functions (run op by op, without ``jit``: many shapes, no compiles).
The tolerance is zero: all of this is integer and boolean work.  Planes
passed as views that start off a 16-byte boundary take the element path
everywhere.  K2's ``contacted`` scratch, which no launch clears, must be
all zero after every launch that tracks contact, and is dropped after a
launch that fails.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dragonboat_tpu.ops import kernels as jk  # noqa: E402
from dragonboat_tpu.ops import state as js  # noqa: E402
from dragonboat_tpu_torch.ops import _build  # noqa: E402
from dragonboat_tpu_torch.ops import kernels as tk  # noqa: E402
from dragonboat_tpu_torch.ops import state as ts  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
G_EDGES = [1, 257, 300, 4_099]
WIDTHS = [1, 2, 3, 4, 5, 6, 7, 8, 12]
ALL_ON = dict(do_tick=True, track_contact=True, has_votes=True)
# K1's cases: everything on, everything off, the hier rule, the read
# plane at S = 4 and S = 8
DENSE = {
    "all": (ALL_ON, None),
    "bare": (dict(do_tick=False, track_contact=False, has_votes=False), None),
    "hier": (dict(ALL_ON, has_hier=True), None),
    "reads4": (dict(ALL_ON, has_reads=True), 4),
    "reads8": (dict(ALL_ON, has_reads=True, has_hier=True), 8),
}
# K2's cases: with and without contact tracking and votes, and the hier
# rule with both
SPARSE = {
    "track_votes": dict(ALL_ON),
    "track": dict(ALL_ON, has_votes=False),
    "votes": dict(ALL_ON, track_contact=False),
    "neither": dict(do_tick=False, track_contact=False, has_votes=False),
    "hier": dict(ALL_ON, has_hier=True),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("qs_step_edges")
    objs, procs = [], []
    for src in _build.SOURCES:
        obj = str(out / src.replace(".cu", ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cxx, "-std=c++17", "-O1", "-DQS_EMULATE", "-fPIC", "-w", "-pthread",
             "-x", "c++", "-c", os.path.join(_build.SRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for proc in procs:
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
    lib = str(out / "libqs_step_edges.so")
    subprocess.run([cxx, "-shared", "-pthread", "-o", lib, *objs], check=True,
                   timeout=120)
    return _build.bind(lib)


@pytest.fixture
def launch(emulated, monkeypatch):
    def run(name, dev, call, also=()):
        assert call(emulated, None) == 0
        for counter in (name,) + tuple(also):
            tk._LAUNCHES[counter] += 1
    monkeypatch.setattr(tk, "_run", run)
    tk.reset_launch_counts()


# ----------------------------------------------------------------------
# inputs, made with numpy from a seed
# ----------------------------------------------------------------------


def _fields(seed, g, p, s=4):
    """Mixed leaders, candidates, followers, observers and dead rows, the
    hier geometry (some sub-quorums off or above the near count) and
    pending read batches with echo bits."""
    rng = np.random.default_rng(seed)
    f = ts.state_to_numpy(ts.make_state(g, p, n_read_slots=s, device="cpu"))
    f["node_state"][:] = rng.choice([0, 1, 2, 2, 2, 3, 4], g)
    f["live"][:] = rng.random(g) < 0.9
    f["term"][:] = rng.integers(0, 6, g)
    f["voting"][:] = rng.random((g, p)) < 0.8
    f["present"][:] = f["voting"] | (rng.random((g, p)) < 0.5)
    f["quorum"][:] = f["voting"].sum(1) // 2 + 1
    f["self_slot"][:] = rng.integers(-1, p + 1, g)  # -1 and p: out of range
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
    f["near"][:] = rng.random((g, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, p + 2, g)
    f["sub_quorum"][::3] = 0
    f["read_index"][:] = rng.integers(0, 12, (g, s))
    f["read_count"][:] = rng.choice([0, 0, 1, 2, 5], (g, s))
    f["read_acks"][:] = rng.random((g, s, p)) < 0.3
    return f


def _dense_inputs(seed, g, p, s):
    rng = np.random.default_rng(seed + 1)
    touched = rng.random((g, p)) < 0.35
    ack_max = np.where(touched, rng.integers(0, 25, (g, p)), 0).astype(np.int32)
    vote_new = rng.choice([-1, -1, -1, 0, 1], (g, p)).astype(np.int8)
    idx = np.where(rng.random((g, s)) < 0.35, rng.integers(0, 12, (g, s)), -1).astype(np.int32)
    cnt = rng.choice([0, 1, 3, 9], (g, s)).astype(np.int32)
    echo = rng.random((g, s, p)) < 0.35
    return (ack_max, touched, vote_new), (idx, cnt, echo)


def _sparse_inputs(seed, g, p):
    """Padded ack events with duplicates, out-of-range rows and slots and
    invalid padding; vote events on distinct cells."""
    rng = np.random.default_rng(seed + 2)
    cap = max(8, 2 * g)
    ag = rng.integers(0, g, cap).astype(np.int32)
    ap = rng.integers(0, p, cap).astype(np.int32)
    av = rng.integers(0, 25, cap).astype(np.int32)
    valid = rng.random(cap) < 0.9
    valid[0] = True
    ag[1], ap[2] = g + 2, p  # valid but out of range
    cells = rng.choice(g * p, size=max(1, min(cap // 2, g * p)), replace=False)
    vg = (cells // p).astype(np.int32)
    vp = (cells % p).astype(np.int32)
    vv = rng.integers(0, 2, cells.size).astype(np.int8)
    vvalid = rng.random(cells.size) < 0.8
    return (ag, ap, av, valid), (vg, vp, vv, vvalid)


def _offset(t):
    """``t`` copied into a contiguous view one element past the start of
    its buffer, so that it starts off a 16-byte boundary."""
    buf = torch.zeros((t.numel() + 1,), dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _offset_state(st, names):
    return st._replace(**{n: _offset(getattr(st, n)) for n in names})


# ----------------------------------------------------------------------
# comparison
# ----------------------------------------------------------------------


def _jax_state(f):
    return js.QuorumState(**{k: jnp.asarray(v.copy()) for k, v in f.items()})


def _same(kout, want, tag):
    """``want``: the plain version's or the JAX package's outputs."""
    for name in ts.FIELDS:
        a = getattr(kout.state, name).numpy()
        b = np.asarray(getattr(want.state, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)
    pairs = [(n, getattr(kout, n), getattr(want, n)) for n in ("committed", "won", "lost")]
    pairs += list(zip(tk.TickFlags._fields, kout.flags, want.flags))
    if want.read_done_count is not None:
        pairs += [(n, getattr(kout, n), getattr(want, n))
                  for n in ("read_done_count", "read_done_index")]
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, name)


def _dense_all(f, inputs, reads, flags, offsets=()):
    """The emulated K1, the plain version and the JAX package's step on
    the same inputs; ``offsets`` names state planes passed as offset
    views (then the inputs are too)."""
    (am, at, vn), rd = inputs
    if not flags.get("has_reads"):
        rd = (None, None, None)
    args = [None if a is None else torch.from_numpy(np.array(a)) for a in (am, at, vn, *rd)]
    if offsets:
        args = [None if a is None else _offset(a) for a in args]
    st = _offset_state(ts.state_from_numpy(f, CPU), offsets)
    kout = tk._dense_launch(
        st, CPU, *args[:3], flags["do_tick"], flags["track_contact"], flags["has_votes"],
        flags.get("has_hier", False), reads=tuple(args[3:]) if flags.get("has_reads") else None)
    plain = tk.quorum_step_dense_impl(ts.state_from_numpy(f, CPU), *args, **flags)
    jx = jk.quorum_step_dense_impl(
        _jax_state(f), *(None if a is None else jnp.asarray(a) for a in (am, at, vn, *rd)),
        **flags)
    return kout, plain, jx


def _sparse_all(f, acks, votes, flags, offsets=()):
    st = _offset_state(ts.state_from_numpy(f, CPU), offsets)
    args = [torch.from_numpy(np.array(a)) for a in acks + votes]
    kout = tk._sparse_launch(st, CPU, args[:4], args[4:], flags["do_tick"],
                             flags["track_contact"], flags["has_votes"],
                             flags.get("has_hier", False))
    plain = tk.quorum_step_impl(ts.state_from_numpy(f, CPU), *args, **flags)
    jx = jk.quorum_step_impl(_jax_state(f), *(jnp.asarray(a) for a in acks + votes), **flags)
    return kout, plain, jx


def _scratch_clear(st):
    scratch = tk._CONTACTED.get(tk._contact_key(st, CPU, None))
    return scratch is None or not bool(scratch.any())


# ----------------------------------------------------------------------
# K1
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", list(DENSE))
@pytest.mark.parametrize("p", WIDTHS)
@pytest.mark.parametrize("g", G_EDGES)
def test_dense_step_block_edges(launch, g, p, case):
    flags, s = DENSE[case]
    seed = 1_000 * g + 10 * p + list(DENSE).index(case)
    f = _fields(seed, g, p, s or 4)
    kout, plain, jx = _dense_all(f, _dense_inputs(seed, g, p, s or 4), s, flags)
    _same(kout, plain, ("plain", g, p, case))
    _same(kout, jx, ("jax", g, p, case))
    assert tk.launch_counts()["quorum_step_dense"] == 1
    assert tk.launch_counts()["read_plane"] == (1 if s else 0)


# ----------------------------------------------------------------------
# K2
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", list(SPARSE))
@pytest.mark.parametrize("p", WIDTHS)
@pytest.mark.parametrize("g", G_EDGES)
def test_sparse_step_block_edges(launch, g, p, case):
    flags = SPARSE[case]
    seed = 2_000 * g + 10 * p + list(SPARSE).index(case)
    f = _fields(seed, g, p)
    acks, votes = _sparse_inputs(seed, g, p)
    kout, plain, jx = _sparse_all(f, acks, votes, flags)
    _same(kout, plain, ("plain", g, p, case))
    _same(kout, jx, ("jax", g, p, case))
    assert _scratch_clear(kout.state), "the contacted scratch is left off zero"


@pytest.mark.parametrize("p", WIDTHS)
@pytest.mark.parametrize("g", G_EDGES)
def test_sparse_step_back_to_back(launch, g, p):
    """Two K2 launches on one state and one contacted scratch: the second
    starts from the first's result, and the scratch is all zero after
    each."""
    seed = 3_000 * g + p
    f = _fields(seed, g, p)
    st = ts.state_from_numpy(f, CPU)
    want = ts.state_from_numpy(f, CPU)
    jst = _jax_state(f)
    for k in range(2):
        acks, votes = _sparse_inputs(seed + 100 * k, g, p)
        args = [torch.from_numpy(np.array(a)) for a in acks + votes]
        kout = tk._sparse_launch(st, CPU, args[:4], args[4:], True, True, True)
        assert _scratch_clear(st), ("the contacted scratch is left off zero", k)
        plain = tk.quorum_step_impl(want, *args)
        want = plain.state
        jx = jk.quorum_step_impl(jst, *(jnp.asarray(a) for a in acks + votes))
        jst = jx.state
        _same(kout, plain, ("plain", g, p, k))
        _same(kout, jx, ("jax", g, p, k))
    assert tk.launch_counts()["quorum_step"] == 2


# ----------------------------------------------------------------------
# planes that start off a 16-byte boundary
# ----------------------------------------------------------------------

DENSE_PLANES = ("match", "next", "voting", "active", "votes", "near", "read_index",
                "read_count", "read_acks")
SPARSE_PLANES = ("match", "next", "voting", "active", "votes", "near")


@pytest.mark.parametrize("kernel", ["dense", "dense_reads", "sparse"])
@pytest.mark.parametrize("p", WIDTHS)
@pytest.mark.parametrize("g", [257, 4_099])
def test_steps_on_offset_views(launch, g, p, kernel):
    seed = 4_000 * g + 10 * p + len(kernel)
    f = _fields(seed, g, p)
    if kernel == "sparse":
        acks, votes = _sparse_inputs(seed, g, p)
        flags = dict(SPARSE["hier"])
        kout, plain, jx = _sparse_all(f, acks, votes, flags, SPARSE_PLANES)
    else:
        flags, s = DENSE["reads4" if kernel == "dense_reads" else "hier"]
        kout, plain, jx = _dense_all(f, _dense_inputs(seed, g, p, 4), s, flags,
                                     DENSE_PLANES)
    assert kout.state.match.data_ptr() % 16 != 0
    _same(kout, plain, ("plain", g, p, kernel))
    _same(kout, jx, ("jax", g, p, kernel))


# ----------------------------------------------------------------------
# K2's scratch after a failed launch, and the slabs' barrier
# ----------------------------------------------------------------------


@pytest.mark.parametrize("g", G_EDGES)
def test_sparse_step_failed_launch_drops_scratch(emulated, monkeypatch, g):
    """A K2 launch that fails after its event launch may leave bytes of
    the contacted scratch set: the wrapper drops that scratch, and the
    next launch starts from a zeroed one."""
    p, seed = 5, 5_000 * g
    f = _fields(seed, g, p)
    acks, votes = _sparse_inputs(seed, g, p)
    args = [torch.from_numpy(np.array(a)) for a in acks + votes]
    st = ts.state_from_numpy(f, CPU)
    key = tk._contact_key(st, CPU, None)

    def failing(name, dev, call, also=()):
        assert call(emulated, None) == 0
        tk._CONTACTED[key].fill_(True)  # as an event launch leaves it
        raise RuntimeError(f"{name} kernel launch failed")

    monkeypatch.setattr(tk, "_run", failing)
    with pytest.raises(RuntimeError):
        tk._sparse_launch(st, CPU, args[:4], args[4:], True, True, True)
    assert key not in tk._CONTACTED

    def run(name, dev, call, also=()):
        assert call(emulated, None) == 0

    monkeypatch.setattr(tk, "_run", run)
    kout, plain, jx = _sparse_all(f, acks, votes, ALL_ON)
    _same(kout, plain, ("plain", g))
    _same(kout, jx, ("jax", g))
    assert _scratch_clear(kout.state)


@pytest.mark.parametrize("g", [257, 4_099])
def test_sparse_step_states_never_share_scratch(launch, g):
    """Two states of the same G keep contacted scratches of their own: a
    byte left set in one state's scratch (as its event launch leaves it
    when another thread's launch runs between its two) neither reaches the
    other state's row pass nor is cleared by it, and a state's scratch
    goes with the state."""
    p, seed = 5, 6_000 * g
    fa, fb = _fields(seed, g, p), _fields(seed + 1, g, p)
    st_a, st_b = ts.state_from_numpy(fa, CPU), ts.state_from_numpy(fb, CPU)
    acks, votes = _sparse_inputs(seed, g, p)
    args = [torch.from_numpy(np.array(a)) for a in acks + votes]
    tk._sparse_launch(st_a, CPU, args[:4], args[4:], True, True, True)
    key_a = tk._contact_key(st_a, CPU, None)
    key_b = tk._contact_key(st_b, CPU, None)
    assert key_a != key_b
    scratch_a = tk._CONTACTED[key_a]
    scratch_a[::3] = True  # A's event launch ran; its row launch has not yet
    left = scratch_a.clone()
    _, plain, jx = _sparse_all(fb, acks, votes, ALL_ON)
    kout = tk._sparse_launch(st_b, CPU, args[:4], args[4:], True, True, True)
    _same(kout, plain, ("plain", g))
    _same(kout, jx, ("jax", g))
    scratch_b = tk._CONTACTED[key_b]
    assert scratch_b.data_ptr() != scratch_a.data_ptr()
    assert not bool(scratch_b.any())
    assert torch.equal(tk._CONTACTED[key_a], left)
    del st_a
    assert key_a not in tk._CONTACTED
    assert key_b in tk._CONTACTED


SLAB_CASES = {
    "dense": (1, dict(do_tick=True, track_contact=True, has_votes=True), 0),
    "dense_hier": (1, dict(ALL_ON, has_hier=True), 0),
    "dense_reads4": (1, dict(ALL_ON, has_reads=True), 4),
    "dense_reads8": (1, dict(ALL_ON, has_reads=True, has_hier=True), 8),
    "sparse": (0, dict(ALL_ON), 0),
    "sparse_hier": (0, dict(ALL_ON, has_hier=True), 0),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
@pytest.mark.parametrize("p", WIDTHS)
def test_slab_barrier_out_of_row_reads(emulated, p, case):
    """A row read of a region's byte cells may reach up to 7 bytes past
    its last row; the bulk copies' barrier lies beyond that reach of the
    last region, 8-byte aligned, inside the shared memory a block asks
    for."""
    dense, flags, s = SLAB_CASES[case]
    out = (ctypes.c_int * 3)()
    bits = tk._bits(flags["do_tick"], flags["track_contact"], flags["has_votes"],
                    has_hier=flags.get("has_hier", False),
                    has_reads=flags.get("has_reads", False))
    rows = emulated.qs_slab_layout(dense, p, s, bits, out)
    end, bar, nbytes = out
    assert rows in (32, 64, 128, 256)
    assert bar >= end + 8 and bar % 8 == 0 and nbytes >= bar + 8
