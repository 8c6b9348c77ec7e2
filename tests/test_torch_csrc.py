"""The arithmetic of the CUDA sources, run on the CPU against the plain
versions.

``csrc/quorum.cuh`` compiles as host C++ when ``QS_EMULATE`` is defined:
every launch becomes a loop over blocks and threads, and the telemetry
fold's launches, whose threads share memory and meet at barriers, run
each block's threads as real host threads with a barrier.  The test
builds the sources that way with the host C++ compiler, binds the library
with the same ctypes declarations the CUDA build uses, and drives it
through the port's own launch functions on CPU tensors, so the struct
layouts, pointer passing, flag bits and template dispatch (the HIER
and READS instances included) are exercised along with the row functions.  The
CUDA build itself is held against the plain versions on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.ops import _build
from dragonboat_tpu_torch.ops import kernels as tk
from dragonboat_tpu_torch.ops import state as ts

torch.set_num_threads(1)

CPU = torch.device("cpu")
WIDTHS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 32]
G = 64


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("qs_emulate")
    objs, procs = [], []
    for src in _build.SOURCES:
        obj = str(out / src.replace(".cu", ".o"))
        objs.append(obj)
        procs.append(subprocess.Popen(
            [cxx, "-std=c++17", "-O0", "-DQS_EMULATE", "-fPIC", "-w", "-pthread",
             "-x", "c++", "-c", os.path.join(_build.SRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    for proc in procs:
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
    lib = str(out / "libqs_emulate.so")
    subprocess.run([cxx, "-shared", "-pthread", "-o", lib, *objs], check=True,
                   timeout=120)
    return _build.bind(lib)


@pytest.fixture
def launch(emulated, monkeypatch):
    def run(name, dev, call, also=()):
        rc = call(emulated, None)
        assert rc == 0
        for counter in (name,) + tuple(also):
            tk._LAUNCHES[counter] += 1
    monkeypatch.setattr(tk, "_run", run)
    tk.reset_launch_counts()


def _fields(seed, g, p):
    rng = np.random.default_rng(seed)
    f = ts.state_to_numpy(ts.make_state(g, p, device="cpu"))
    f["node_state"][:] = rng.choice([0, 1, 2, 2, 2, 3, 4], g)
    f["live"][:] = rng.random(g) < 0.9
    f["term"][:] = rng.integers(0, 6, g)
    f["voting"][:] = rng.random((g, p)) < 0.8
    f["quorum"][:] = f["voting"].sum(1) // 2 + 1
    f["self_slot"][:] = rng.integers(0, p + 1, g)  # p: out of range
    f["match"][:] = rng.integers(0, 20, (g, p))
    f["next"][:] = f["match"] + rng.integers(1, 4, (g, p))
    f["last_index"][:] = rng.integers(0, 22, g)
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


def _hier_telem(f, rng):
    """Random near masks, sub-quorums (0 = off, some above the near
    count) and fold watermarks on a state from :func:`_fields`."""
    g, p = f["match"].shape
    f["near"][:] = rng.random((g, p)) < 0.5
    f["sub_quorum"][:] = rng.integers(0, p + 2, g)
    f["sub_quorum"][::3] = 0
    f["telem_prev_committed"][:] = np.where(rng.random(g) < 0.5, f["committed"], 0)
    return f


def _state(f):
    return ts.state_from_numpy(f, device="cpu")


def _assert_same(kout, pout, tag):
    for name in ts.FIELDS:
        a, b = getattr(kout.state, name), getattr(pout.state, name)
        assert torch.equal(a, b), (tag, name)
    if pout.telem is not None:
        for name, a, b in zip(tk.TelemAggregate._fields, kout.telem, pout.telem):
            assert torch.equal(a, b.to(torch.int32)), (tag, name)
    for name in ("committed", "won", "lost"):
        assert torch.equal(getattr(kout, name), getattr(pout, name)), (tag, name)
    for name, a, b in zip(tk.TickFlags._fields, kout.flags, pout.flags):
        assert torch.equal(a, b), (tag, name)


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_dense_kernel_matches_plain(launch, p):
    for i, (tick, track, votes) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 100 * p + i
        f = _fields(seed, G, p)
        rng = np.random.default_rng(seed)
        touched = torch.from_numpy(rng.random((G, p)) < 0.35)
        ack = torch.from_numpy(rng.integers(0, 25, (G, p)).astype(np.int32))
        ack = torch.where(touched, ack, 0)
        vote_new = torch.from_numpy(rng.choice([-1, -1, 0, 1], (G, p)).astype(np.int8))
        kout = tk._dense_launch(_state(f), CPU, ack, touched, vote_new, tick, track, votes)
        pout = tk.quorum_step_dense_impl(
            _state(f), ack, touched, vote_new, do_tick=tick,
            track_contact=track, has_votes=votes,
        )
        _assert_same(kout, pout, (p, tick, track, votes))
    assert tk.launch_counts()["quorum_step_dense"] == 8


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_sparse_kernel_matches_plain(launch, p):
    for i, (tick, track, votes) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 200 * p + i
        f = _fields(seed, G, p)
        rng = np.random.default_rng(seed)
        cap = 160
        ag = rng.integers(0, G + 2, cap).astype(np.int32)  # some rows out of range
        ap = rng.integers(0, p + 1, cap).astype(np.int32)  # some slots out of range
        av = rng.integers(0, 25, cap).astype(np.int32)
        valid = rng.random(cap) < 0.9
        cells = rng.choice(G * p, size=min(64, G * p), replace=False)
        vg = (cells // p).astype(np.int32)
        vp = (cells % p).astype(np.int32)
        vv = rng.integers(0, 2, cells.size).astype(np.int8)
        vvalid = rng.random(cells.size) < 0.8
        acks = tuple(torch.from_numpy(a) for a in (ag, ap, av, valid))
        vts = tuple(torch.from_numpy(a) for a in (vg, vp, vv, vvalid))
        kout = tk._sparse_launch(_state(f), CPU, acks, vts, tick, track, votes)
        pout = tk.quorum_step_impl(
            _state(f), *acks, *vts, do_tick=tick, track_contact=track,
            has_votes=votes,
        )
        _assert_same(kout, pout, (p, tick, track, votes))
    assert tk.launch_counts()["quorum_step"] == 8


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_multiround_kernel_matches_plain(launch, p):
    k, c = 4, 12
    for i, (tick, track, votes, churn) in enumerate(
        itertools.product([False, True], repeat=4)
    ):
        seed = 300 * p + i
        f = _fields(seed, G, p)
        rng = np.random.default_rng(seed)
        ack = np.where(rng.random((k, G, p)) < 0.35,
                       rng.integers(0, 25, (k, G, p)), -1).astype(np.int32)
        vote_new = rng.choice([-1, -1, 0, 1], (k, G, p)).astype(np.int8)
        rows = np.full((k, c), G, np.int32)
        for r in range(k):
            n = rng.integers(0, c + 1)
            rows[r, :n] = rng.choice(G, size=n, replace=False)
        start = rng.integers(0, 5, (k, c)).astype(np.int32)
        churn_t = tuple(torch.from_numpy(a) for a in (
            rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
            (start + rng.integers(0, 5, (k, c))).astype(np.int32),
        ))
        tick_mask = torch.from_numpy(rng.random(k) < 0.6)
        ack_t, vote_t = torch.from_numpy(ack), torch.from_numpy(vote_new)
        kout = tk._multiround_launch(
            _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, tick, track,
            votes, churn,
        )
        pout = tk.quorum_multiround_impl(
            _state(f), ack_t, vote_t, *churn_t, tick_mask, do_tick=tick,
            track_contact=track, has_votes=votes, has_churn=churn,
        )
        _assert_same(kout, pout, (p, tick, track, votes, churn))
    assert tk.launch_counts()["quorum_multiround"] == 16


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_hier_step_kernels_match_plain(launch, p):
    """The HIER instances of K1 and K2 against the plain has_hier tail."""
    for i, (tick, votes) in enumerate(itertools.product([False, True], repeat=2)):
        seed = 400 * p + i
        rng = np.random.default_rng(seed)
        f = _hier_telem(_fields(seed, G, p), rng)
        touched = torch.from_numpy(rng.random((G, p)) < 0.5)
        ack = torch.from_numpy(rng.integers(0, 25, (G, p)).astype(np.int32))
        ack = torch.where(touched, ack, 0)
        vote_new = torch.from_numpy(rng.choice([-1, -1, 0, 1], (G, p)).astype(np.int8))
        kout = tk._dense_launch(_state(f), CPU, ack, touched, vote_new, tick,
                                True, votes, True)
        pout = tk.quorum_step_dense_impl(
            _state(f), ack, touched, vote_new, do_tick=tick, has_votes=votes,
            has_hier=True,
        )
        _assert_same(kout, pout, ("dense", p, tick, votes))
        cap = 160
        acks = tuple(torch.from_numpy(a) for a in (
            rng.integers(0, G, cap).astype(np.int32),
            rng.integers(0, p, cap).astype(np.int32),
            rng.integers(0, 25, cap).astype(np.int32),
            rng.random(cap) < 0.9,
        ))
        z = torch.zeros((1,), dtype=torch.int32)
        vts = (z, z, z.to(torch.int8), z.bool())
        kout = tk._sparse_launch(_state(f), CPU, acks, vts, tick, True, False, True)
        pout = tk.quorum_step_impl(
            _state(f), *acks, *vts, do_tick=tick, has_votes=False, has_hier=True,
        )
        _assert_same(kout, pout, ("sparse", p, tick))
    counts = tk.launch_counts()
    assert counts["finish_hier"] == 8 == counts["quorum_step_dense"] + counts["quorum_step"]


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_hier_multiround_kernel_with_fold_matches_plain(launch, p):
    """K3's HIER instances with in-program recycles, its telem reset on
    recycle, and the fold launched after it, against the plain block."""
    k, c = 4, 12
    for i, (hier, telem, purge) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 500 * p + i
        rng = np.random.default_rng(seed)
        f = _hier_telem(_fields(seed, G, p), rng)
        ack = np.where(rng.random((k, G, p)) < 0.5,
                       rng.integers(0, 25, (k, G, p)), -1).astype(np.int32)
        rows = np.full((k, c), G, np.int32)
        for r in range(k):
            n = rng.integers(0, c + 1)
            rows[r, :n] = rng.choice(G, size=n, replace=False)
        start = rng.integers(0, 5, (k, c)).astype(np.int32)
        churn_t = tuple(torch.from_numpy(a) for a in (
            rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
            (start + rng.integers(0, 9, (k, c))).astype(np.int32),
        ))
        tick_mask = torch.ones((k,), dtype=torch.bool)
        ack_t = torch.from_numpy(ack)
        vote_t = torch.zeros((1, 1, 1), dtype=torch.int8)
        st = _state(f)
        kout = tk._multiround_launch(
            st, CPU, ack_t, vote_t, churn_t, tick_mask, False, True, False,
            True, hier, reset_telem=telem or purge,
        )
        if telem:
            kout = kout._replace(telem=tk._telem_launch(st, CPU, 8, False, False))
        pout = tk.quorum_multiround_impl(
            _state(f), ack_t, vote_t, *churn_t, tick_mask, has_churn=True,
            has_hier=hier, has_telem=telem, purge_telem=purge,
        )
        _assert_same(kout, pout, (p, hier, telem, purge))


@pytest.mark.parametrize("g,k", [(1, 1), (1, 8), (5, 8), (8, 8), (8, 16),
                                 (256, 1), (256, 8), (256, 16), (700, 16)])
def test_emulated_telem_fold_matches_plain(launch, g, k):
    """The two-pass fold (shared-memory counters, per-block top-K, the
    single-block merge) against the plain fold: many tied lags, dead rows,
    lags at 2^i - 1 and 2^i and 2^25 - 1, occupancy both ways."""
    for i, (reads, kv) in enumerate(itertools.product([False, True], repeat=2)):
        seed = 600 + 10 * g + k + i
        rng = np.random.default_rng(seed)
        f = _hier_telem(_fields(seed, g, 5), rng)
        edges = [0, 0, 0, 1, 2, 3, 4, 7, 8, 2**14 - 1, 2**14, 2**15,
                 2**25 - 1, 2**25]
        f["last_index"][:] = f["committed"] + rng.choice(edges, g)
        f["read_count"][:] = rng.integers(0, 3, f["read_count"].shape)
        f["kv_ent_index"][:] = rng.integers(-1, 3, f["kv_ent_index"].shape)
        st = _state(f)
        agg = tk._telem_launch(st, CPU, k, reads, kv)
        pst, pagg = tk.telem_fold_impl(_state(f), k, reads, kv)
        for name, a, b in zip(tk.TelemAggregate._fields, agg, pagg):
            assert torch.equal(a, b.to(torch.int32)), (g, k, reads, kv, name)
        assert torch.equal(st.telem_prev_committed, pst.telem_prev_committed)
    assert tk.launch_counts()["telem_fold"] == 4


def test_kernel_build_needs_nvcc_and_never_falls_back(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing substitutes the plain path."""
    if _build.loaded():
        pytest.skip("the kernel library is already loaded in this process")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not _build.loaded()


def test_source_hash_keys_the_library_on_every_source(monkeypatch, tmp_path):
    for name in _build.SOURCES + _build.HEADERS:
        shutil.copy(os.path.join(_build.SRC_DIR, name), tmp_path / name)
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    base = _build.source_hash()
    for name in _build.SOURCES + _build.HEADERS:
        with open(tmp_path / name, "a") as f:
            f.write("\n// edited\n")
        edited = _build.source_hash()
        assert edited != base, name
        base = edited


def _read_block(seed, g, p, s, k):
    """A state with pending read slots (some rows out of range on the
    self slot, dead, or not leaders) and K rounds of stage and echo
    input; round 0 stages every slot of row 0 and echoes it to quorum in
    rounds 0 and 2, with a restage in round 2, so that slot confirms
    twice in the block."""
    rng = np.random.default_rng(seed)
    f = _fields(seed, g, p)
    f["read_index"] = rng.integers(0, 12, (g, s)).astype(np.int32)
    f["read_count"] = rng.choice([0, 0, 1, 2, 5], (g, s)).astype(np.int32)
    f["read_acks"] = rng.random((g, s, p)) < 0.3
    f["self_slot"][1::9] = -1
    idx = np.where(rng.random((k, g, s)) < 0.35,
                   rng.integers(0, 12, (k, g, s)), -1).astype(np.int32)
    cnt = rng.choice([0, 1, 3, 9], (k, g, s)).astype(np.int32)
    echo = rng.random((k, g, s, p)) < 0.35
    f["node_state"][0], f["live"][0], f["self_slot"][0] = 2, True, 0
    f["voting"][0] = True
    f["quorum"][0] = p // 2 + 1
    idx[:, 0, 0], cnt[:, 0, 0], echo[:, 0, 0] = -1, 0, False
    for r, at in ((0, 4), (2, 7))[:k // 2 + 1]:
        idx[r, 0, 0], cnt[r, 0, 0] = at, 9
        echo[r, 0, 0] = True
    return f, tuple(torch.from_numpy(a) for a in (idx, cnt, echo))


@pytest.mark.parametrize("s", [4, 8])
@pytest.mark.parametrize("p", [3, 5, 12])
def test_emulated_reads_dense_kernel_matches_plain(launch, p, s):
    """K1's READS instances (with ticks, votes and the hier rule both
    ways) against the plain dense step with has_reads."""
    for i, (tick, votes, hier) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 700 * p + 10 * s + i
        f, (idx, cnt, echo) = _read_block(seed, G, p, s, 1)
        f = _hier_telem(f, np.random.default_rng(seed))
        rng = np.random.default_rng(seed + 1)
        touched = torch.from_numpy(rng.random((G, p)) < 0.4)
        ack = torch.where(touched, torch.from_numpy(rng.integers(0, 25, (G, p)).astype(np.int32)), 0)
        vote_new = torch.from_numpy(rng.choice([-1, -1, 0, 1], (G, p)).astype(np.int8))
        reads = (idx[0], cnt[0], echo[0])
        kout = tk._dense_launch(_state(f), CPU, ack, touched, vote_new, tick, True,
                                votes, hier, reads=reads)
        pout = tk.quorum_step_dense_impl(
            _state(f), ack, touched, vote_new, *reads, do_tick=tick,
            has_votes=votes, has_hier=hier, has_reads=True,
        )
        _assert_same(kout, pout, (p, s, tick, votes, hier))
        for name in ("read_done_count", "read_done_index"):
            assert torch.equal(getattr(kout, name), getattr(pout, name)), name
        assert pout.read_done_count.sum() > 0
    counts = tk.launch_counts()
    assert counts["read_plane"] == counts["quorum_step_dense"] == 8


@pytest.mark.parametrize("s", [4, 8])
@pytest.mark.parametrize("p", [3, 5, 12, 32])
def test_emulated_reads_multiround_kernel_matches_plain(launch, p, s):
    """K3's READS instances against the plain block: recycles mid-block
    of rows with pending slots (row 0 among them, between its two
    confirmations), ticks, votes, the hier rule, and a slot confirming
    twice in one block (count summed, index the larger); then the
    purge-only launch, which runs no plane but clears recycled rows."""
    k, c = 4, 12
    for i, (tick, votes, hier, churn) in enumerate(
        itertools.product([False, True], repeat=4)
    ):
        seed = 800 * p + 10 * s + i
        f, reads = _read_block(seed, G, p, s, k)
        f = _hier_telem(f, np.random.default_rng(seed))
        rng = np.random.default_rng(seed + 1)
        ack = np.where(rng.random((k, G, p)) < 0.4,
                       rng.integers(0, 25, (k, G, p)), -1).astype(np.int32)
        vote_new = rng.choice([-1, -1, 0, 1], (k, G, p)).astype(np.int8)
        rows = np.full((k, c), G, np.int32)
        for r in range(k):
            n = rng.integers(1, c + 1)
            rows[r, :n] = rng.choice(np.arange(1, G), size=n, replace=False)
        rows[1, 0] = 5  # a row with pending slots, recycled mid-block
        start = rng.integers(0, 5, (k, c)).astype(np.int32)
        churn_t = tuple(torch.from_numpy(a) for a in (
            rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
            (start + rng.integers(0, 5, (k, c))).astype(np.int32),
        ))
        tick_mask = torch.from_numpy(rng.random(k) < 0.6)
        ack_t, vote_t = torch.from_numpy(ack), torch.from_numpy(vote_new)
        kout = tk._multiround_launch(
            _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, tick, True,
            votes, churn, hier, reads=reads, reset_reads=True,
        )
        pout = tk.quorum_multiround_impl(
            _state(f), ack_t, vote_t, *churn_t, tick_mask, *reads, do_tick=tick,
            has_votes=votes, has_churn=churn, has_hier=hier, has_reads=True,
        )
        tag = (p, s, tick, votes, hier, churn)
        _assert_same(kout, pout, tag)
        for name in ("read_done_count", "read_done_index"):
            assert torch.equal(getattr(kout, name), getattr(pout, name)), (tag, name)
        assert int(pout.read_done_count[0, 0]) == 18  # two batches of 9
        assert int(pout.read_done_index[0, 0]) == 7
        if churn:
            purge = tk._multiround_launch(
                _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, tick, True,
                votes, True, hier, reset_reads=True,
            )
            plain = tk.quorum_multiround_impl(
                _state(f), ack_t, vote_t, *churn_t, tick_mask, do_tick=tick,
                has_votes=votes, has_churn=True, has_hier=hier, purge_reads=True,
            )
            _assert_same(purge, plain, tag + ("purge",))
            assert int(plain.state.read_count[5].sum()) == 0
    counts = tk.launch_counts()
    assert counts["read_plane"] == 16 and counts["quorum_multiround"] == 24


def test_emulated_read_slot_cap_is_enforced(launch):
    f = ts.state_to_numpy(ts.make_state(4, 3, n_read_slots=9, device="cpu"))
    st = _state(f)
    z = torch.zeros((4, 3), dtype=torch.int32)
    reads = (torch.full((4, 9), -1, dtype=torch.int32),
             torch.zeros((4, 9), dtype=torch.int32),
             torch.zeros((4, 9, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="read slots"):
        tk._dense_launch(st, CPU, z, z.bool(), None, False, True, False, reads=reads)
    with pytest.raises(ValueError, match="read_stage_cnt"):
        tk._dense_launch(_state(ts.state_to_numpy(ts.make_state(4, 3, device="cpu"))),
                         CPU, z, z.bool(), None, False, True, False,
                         reads=(reads[0][:, :4].contiguous(), reads[1], reads[2][:, :4].contiguous()))


def _kv_state(f, rng, v, e):
    """Buffered entries (keys in and outside [0, V)), random values, and
    the state from :func:`_fields` resized to V value slots and E entry
    slots."""
    g = f["match"].shape[0]
    f["kv_value"] = rng.integers(-40, 40, (g, v)).astype(np.int32)
    f["kv_ent_index"] = np.where(rng.random((g, e)) < 0.4,
                                 rng.integers(0, 16, (g, e)), -1).astype(np.int32)
    f["kv_ent_key"] = rng.integers(-2, v + 2, (g, e)).astype(np.int32)
    f["kv_ent_val"] = rng.integers(-2**31, 2**31, (g, e)).astype(np.int32)
    f["committed"][3::11] = -2
    return f


def _kv_inputs(rng, g, v, e, r, lead=()):
    idx = np.where(rng.random(lead + (g, e)) < 0.35, rng.integers(0, 20, lead + (g, e)),
                   rng.choice([-1, -1, -3], lead + (g, e))).astype(np.int32)
    key = rng.integers(-2, v + 2, lead + (g, e)).astype(np.int32)
    val = rng.integers(-2**31, 2**31, lead + (g, e)).astype(np.int32)
    rk = np.where(rng.random(lead + (g, r)) < 0.5, rng.integers(0, v + 2, lead + (g, r)),
                  rng.choice([-1, -5], lead + (g, r))).astype(np.int32)
    # row 0: ready entries sharing a key at the largest index (summed)
    f_idx = idx[(0,) * len(lead)] if lead else idx
    f_idx[0, :] = -1
    f_idx[0, :2] = 3
    (key[(0,) * len(lead)] if lead else key)[0, :2] = 0
    return tuple(torch.from_numpy(a) for a in (idx, key, val, rk))


def _assert_kv_same(kout, pout, tag):
    _assert_same(kout, pout, tag)
    for name in ("kv_read_val", "kv_read_index", "kv_applied"):
        assert torch.equal(getattr(kout, name), getattr(pout, name)), (tag, name)


KV_WIDTHS = [(16, 16, 4), (1, 1, 1), (1024, 32, 8)]  # (V, E, R); the last: the caps


@pytest.mark.parametrize("v,e,r", KV_WIDTHS)
def test_emulated_kv_plane_after_dense_kernel_matches_plain(launch, v, e, r):
    """K = 1: kv_plane.cu after K1 (its READS and HIER instances too) at
    the watermark K1 leaves, against the plain dense step with has_kv."""
    p = 5
    for i, (tick, reads, hier) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 900 + 10 * e + i
        rng = np.random.default_rng(seed)
        f, rd = _read_block(seed, G, p, 4, 1)
        f = _kv_state(_hier_telem(f, rng), rng, v, e)
        kv = _kv_inputs(rng, G, v, e, r)
        touched = torch.from_numpy(rng.random((G, p)) < 0.5)
        ack = torch.where(touched, torch.from_numpy(rng.integers(0, 25, (G, p)).astype(np.int32)), 0)
        rd1 = (rd[0][0], rd[1][0], rd[2][0]) if reads else None
        kout = tk._dense_launch(_state(f), CPU, ack, touched, None, tick, True, False,
                                hier, reads=rd1, kv=kv)
        pout = tk.quorum_step_dense_impl(
            _state(f), ack, touched, None, *(rd1 or (None,) * 3), *kv, do_tick=tick,
            has_votes=False, has_hier=hier, has_reads=reads, has_kv=True,
        )
        _assert_kv_same(kout, pout, (v, e, r, tick, reads, hier))
        assert pout.kv_applied.sum() > 0
    assert tk.launch_counts()["kv_plane"] == 8


@pytest.mark.parametrize("v,e,r", KV_WIDTHS)
def test_emulated_kv_plane_after_multiround_kernel_matches_plain(launch, v, e, r):
    """K = 16: K3 writes each round's watermark into the trace and
    kv_plane.cu runs the rounds on it, resetting the rows K3's churn map
    recycles (row 0, entries buffered, at round 5) before that round's
    stage; then the purge alone (purge_kv, the plane off)."""
    k, c, p = 16, 6, 3
    for i, (churn, reads, tick) in enumerate(itertools.product([False, True], repeat=3)):
        seed = 950 + 10 * e + i
        rng = np.random.default_rng(seed)
        f, rd = _read_block(seed, G, p, 4, k)
        f = _kv_state(f, rng, v, e)
        ack = np.where(rng.random((k, G, p)) < 0.4, rng.integers(0, 25, (k, G, p)), -1).astype(np.int32)
        rows = np.full((k, c), G, np.int32)
        for rr in range(k):
            rows[rr, :c - 1] = rng.choice(np.arange(1, G), size=c - 1, replace=False)
        rows[5, c - 1] = 0
        start = rng.integers(0, 5, (k, c)).astype(np.int32)
        churn_t = tuple(torch.from_numpy(a) for a in (
            rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
            (start + rng.integers(0, 5, (k, c))).astype(np.int32)))
        tick_mask = torch.from_numpy(rng.random(k) < 0.5)
        kv = _kv_inputs(rng, G, v, e, r, lead=(k,))
        ack_t, vote_t = torch.from_numpy(ack), torch.zeros((1, 1, 1), dtype=torch.int8)
        kout = tk._multiround_launch(
            _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, tick, True, False, churn,
            reads=rd if reads else None, reset_reads=reads, kv=kv, reset_kv=True,
        )
        pout = tk.quorum_multiround_impl(
            _state(f), ack_t, vote_t, *churn_t, tick_mask, *(rd if reads else (None,) * 3),
            *kv, do_tick=tick, has_churn=churn, has_reads=reads, has_kv=True,
        )
        tag = (v, e, r, churn, reads, tick)
        _assert_kv_same(kout, pout, tag)
        assert pout.kv_applied.sum() > 0 and (pout.kv_read_index >= 0).any()
        if churn:
            purge = tk._multiround_launch(
                _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, tick, True, False,
                True, reset_kv=True,
            )
            plain = tk.quorum_multiround_impl(
                _state(f), ack_t, vote_t, *churn_t, tick_mask, do_tick=tick,
                has_churn=True, purge_kv=True,
            )
            _assert_same(purge, plain, tag + ("purge",))
            assert not plain.state.kv_value[0].any() and purge.kv_read_val is None
    counts = tk.launch_counts()
    assert counts["kv_plane"] == 8 + 4 and counts["quorum_multiround"] == 12


def test_emulated_kv_caps_are_enforced(launch):
    """E, V and R are launch arguments with caps: the wrapper refuses a
    width past them, as it does S past the read plane's."""
    for v, e, r, what in ((16, 33, 4, "entry slots"), (1025, 16, 4, "value slots"),
                          (16, 16, 9, "read slots")):
        f = ts.state_to_numpy(ts.make_state(4, 3, n_kv_slots=v, n_kv_ents=e, device="cpu"))
        z = torch.zeros((4, 3), dtype=torch.int32)
        kv = (torch.full((4, e), -1, dtype=torch.int32), torch.zeros((4, e), dtype=torch.int32),
              torch.zeros((4, e), dtype=torch.int32), torch.full((4, r), -1, dtype=torch.int32))
        with pytest.raises(ValueError, match=what):
            tk._dense_launch(_state(f), CPU, z, z.bool(), None, False, True, False, kv=kv)


# ----------------------------------------------------------------------
# csrc/quorum_multistep.cu: the R-round scans (B13) and the staged ladder
# dispatch (B8)
# ----------------------------------------------------------------------

FLAGS_MULTISTEP = list(itertools.product([False, True], repeat=4))  # tick, track, votes, hier


def _multistep_fields(seed, p):
    """A state from :func:`_fields` with the hier geometry and a few match
    cells at INDEX_MIN and below zero (the sparse and dense ingests differ
    on untouched negative cells)."""
    rng = np.random.default_rng(seed + 1)
    f = _hier_telem(_fields(seed, G, p), rng)
    f["match"][::7, 0] = ts.INDEX_MIN
    f["match"][3::11, p - 1] = -4
    return f


def _multistep_events(seed, r, p, cap=40, vcap=24):
    """R rounds of padded sparse events: duplicates, stale and negative
    values, a valid ack whose row is out of range, one whose slot is out
    of range (its row still counts as contacted), invalid padding; vote
    events on distinct cells a round."""
    rng = np.random.default_rng(seed + 2)
    ag = rng.integers(0, G, (r, cap)).astype(np.int32)
    ap = rng.integers(0, p, (r, cap)).astype(np.int32)
    av = rng.integers(-6, 25, (r, cap)).astype(np.int32)
    valid = rng.random((r, cap)) < 0.9
    valid[:, 3:6] = True
    ag[:, 3], ap[:, 5] = G + 2, p
    ag[:, 4], ap[:, 4], av[:, 4] = 7, 0, -3  # a negative ack onto row 7's INDEX_MIN cell
    vg = np.zeros((r, vcap), np.int32)
    vp = np.zeros((r, vcap), np.int32)
    for k in range(r):
        cells = rng.choice(G * p, size=min(vcap, G * p), replace=False)
        vg[k, :cells.size], vp[k, :cells.size] = cells // p, cells % p
    vv = rng.integers(0, 2, (r, vcap)).astype(np.int8)
    vvalid = rng.random((r, vcap)) < 0.8
    return (tuple(torch.from_numpy(a) for a in (ag, ap, av, valid)),
            tuple(torch.from_numpy(a) for a in (vg, vp, vv, vvalid)))


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_multistep_dense_kernel_matches_plain(launch, p):
    """The dense row loop over R = 4 rounds of (R, G, P) planes — negative
    acks where touched, garbage where untouched — against the plain scan,
    for every flag combination."""
    r = 4
    for i, (tick, track, votes, hier) in enumerate(FLAGS_MULTISTEP):
        seed = 1100 * p + i
        f = _multistep_fields(seed, p)
        rng = np.random.default_rng(seed + 3)
        touched = torch.from_numpy(rng.random((r, G, p)) < 0.35)
        ack = torch.from_numpy(rng.integers(-6, 25, (r, G, p)).astype(np.int32))
        vote_new = torch.from_numpy(rng.choice([-1, -1, 0, 1], (r, G, p)).astype(np.int8))
        kout = tk._multistep_dense_launch(_state(f), CPU, ack, touched, vote_new,
                                          tick, track, votes, hier)
        pout = tk.quorum_multistep_dense_impl(
            _state(f), ack, touched, vote_new, do_tick=tick, track_contact=track,
            has_votes=votes, has_hier=hier,
        )
        _assert_same(kout, pout, (p, tick, track, votes, hier))
    counts = tk.launch_counts()
    assert counts["quorum_multistep_dense"] == 16 and counts["finish_hier"] == 8


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_multistep_sparse_kernel_matches_plain(launch, p):
    """The scatter pre-pass and the row loop over R = 4 rounds of padded
    events with the sparse step's traps, against the plain scan of the
    sparse step, for every flag combination."""
    r = 4
    for i, (tick, track, votes, hier) in enumerate(FLAGS_MULTISTEP):
        seed = 1200 * p + i
        f = _multistep_fields(seed, p)
        acks, vts = _multistep_events(seed, r, p)
        kout = tk._multistep_launch(_state(f), CPU, acks, vts, tick, track, votes, hier)
        pout = tk.quorum_multistep_impl(
            _state(f), *acks, *vts, do_tick=tick, track_contact=track,
            has_votes=votes, has_hier=hier,
        )
        _assert_same(kout, pout, (p, tick, track, votes, hier))
    counts = tk.launch_counts()
    assert counts["quorum_multistep"] == 16 and counts["finish_hier"] == 8


@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_staged_multistep_matches_plain(launch, p):
    """The synthesised ingest (slots 0 and 1 ack base + 1 + r) over R in
    {1, 5, 9} rounds from a random state, one base wrapping past the
    int32 maximum, against the plain version; the flags are zeros."""
    for i, (rounds, base) in enumerate(((1, 3), (5, 17), (9, 2**31 - 4))):
        f = _multistep_fields(1300 * p + i, p)
        kout = tk._staged_launch(_state(f), CPU, base, rounds)
        pout = tk.staged_multistep_impl(_state(f), base, rounds)
        _assert_same(kout, pout, (p, rounds, base))
        assert not any(t.any() for t in (kout.won, kout.lost) + tuple(kout.flags))
    assert tk.launch_counts()["staged_multistep"] == 3


def test_emulated_multistep_shape_checks(launch):
    """Without has_votes both scans take vote dummies of any shape and
    match the has_votes result on empty votes; a plane or event batch of
    the wrong shape is refused before any launch."""
    r, p = 3, 3
    f = _multistep_fields(1400, p)
    acks, _ = _multistep_events(1400, r, p)
    empty = (torch.zeros((r, 8), dtype=torch.int32),) * 2 + (
        torch.zeros((r, 8), dtype=torch.int8), torch.zeros((r, 8), dtype=torch.bool))
    dummy = (torch.zeros((1,), dtype=torch.int32),) * 2 + (
        torch.zeros((1,), dtype=torch.int8), torch.zeros((1,), dtype=torch.bool))
    with_votes = tk._multistep_launch(_state(f), CPU, acks, empty, True, True, True)
    without = tk._multistep_launch(_state(f), CPU, acks, dummy, True, True, False)
    _assert_same(without, with_votes, "sparse dummies")
    touched = torch.zeros((r, G, p), dtype=torch.bool)
    ack = torch.zeros((r, G, p), dtype=torch.int32)
    with_votes = tk._multistep_dense_launch(
        _state(f), CPU, ack, touched, torch.full((r, G, p), -1, dtype=torch.int8),
        True, True, True)
    without = tk._multistep_dense_launch(
        _state(f), CPU, ack, touched, torch.zeros((1, 1), dtype=torch.int8),
        True, True, False)
    _assert_same(without, with_votes, "dense dummies")
    launched = dict(tk.launch_counts())
    with pytest.raises(ValueError, match="ack_p"):
        tk._multistep_launch(_state(f), CPU, (acks[0], acks[1][:, :-1].contiguous(),
                                              acks[2], acks[3]), dummy, True, True, False)
    with pytest.raises(ValueError, match="vote_g"):
        tk._multistep_launch(_state(f), CPU, acks, dummy, True, True, True)
    with pytest.raises(ValueError, match="ack_touched"):
        tk._multistep_dense_launch(_state(f), CPU, ack, touched[:2], None, True, True, False)
    with pytest.raises(ValueError, match="vote_new"):
        tk._multistep_dense_launch(_state(f), CPU, ack, touched,
                                   torch.zeros((1, 1), dtype=torch.int8), True, True, True)
    assert tk.launch_counts() == launched


# ----------------------------------------------------------------------
# the row loops at block edges: G = 300 spans three 128-row blocks with a
# partial last one; G = 257 at odd widths leaves the byte planes (votes,
# echo) and their rows off word alignment, down to the planes' last word
# ----------------------------------------------------------------------

EDGE_G = [300, 257]


def _misaligned(a: np.ndarray) -> torch.Tensor:
    """``a`` as a contiguous tensor whose data starts one byte past a
    word boundary (a view one element into a larger buffer)."""
    flat = torch.zeros((a.size + 1,), dtype=torch.from_numpy(a[:0]).dtype)
    t = flat[1:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _churn(rng, k, c, g, must=()):
    """(K, C) recycle records over rows [1, g), padding rows at g, and the
    rows ``must`` recycled in round 1."""
    rows = np.full((k, c), g, np.int32)
    for r in range(k):
        n = rng.integers(1, c + 1)
        rows[r, :n] = rng.choice(np.arange(1, g), size=n, replace=False)
    for i, row in enumerate(must):
        rows[1][rows[1] == row] = g
        rows[1, c - 1 - i] = row
    start = rng.integers(0, 5, (k, c)).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (
        rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
        (start + rng.integers(0, 5, (k, c))).astype(np.int32)))


@pytest.mark.parametrize("g", EDGE_G)
@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_multiround_ring_edges_match_plain(launch, p, g):
    """K3's ring of round inputs at block edges: the plain instance with
    churn and the fold's recycle reset, the HIER instance with votes and
    ticks, the READS instance (S = 3) with churn, votes and the recycle
    of a row with pending slots, and the devsm trace with kv_plane after
    it; the vote and echo planes also from a misaligned base."""
    k, c = 3, 9
    rng = np.random.default_rng(7_000 + 10 * p + g)
    f, reads = _read_block(7_000 + p + g, g, p, 3, k)
    f = _hier_telem(f, rng)
    ack = np.where(rng.random((k, g, p)) < 0.4, rng.integers(0, 25, (k, g, p)),
                   -1).astype(np.int32)
    vote_np = rng.choice([-1, -1, 0, 1], (k, g, p)).astype(np.int8)
    churn_t = _churn(rng, k, c, g, must=(5, g - 1))
    tick_mask = torch.from_numpy(np.array([True, False, True]))
    ack_t = torch.from_numpy(ack)
    cases = [
        dict(do_tick=False, track_contact=False, has_votes=False, has_churn=True,
             has_telem=True, purge_telem=True),
        dict(do_tick=True, track_contact=True, has_votes=True, has_churn=True,
             has_hier=True),
        dict(do_tick=True, track_contact=True, has_votes=True, has_churn=True,
             has_reads=True),
        dict(do_tick=False, track_contact=True, has_votes=False, has_churn=True,
             has_kv=True),
    ]
    for misaligned in (False, True):
        vote_t = _misaligned(vote_np) if misaligned else torch.from_numpy(vote_np)
        rd = (reads[0], reads[1], _misaligned(reads[2].numpy())) if misaligned else reads
        for i, flags in enumerate(cases):
            tag = (p, g, misaligned, i)
            fk = f
            kv = None
            if flags.get("has_kv"):
                krng = np.random.default_rng(7_500 + p + g)
                fk = _kv_state(dict(f), krng, 16, 16)
                kv = _kv_inputs(krng, g, 16, 16, 4, lead=(k,))
            st = _state(fk)
            kout = tk._multiround_launch(
                st, CPU, ack_t, vote_t, churn_t, tick_mask, flags["do_tick"],
                flags["track_contact"], flags["has_votes"], True,
                flags.get("has_hier", False), reset_telem=flags.get("has_telem", False),
                reads=rd if flags.get("has_reads") else None,
                reset_reads=flags.get("has_reads", False), kv=kv, reset_kv=kv is not None)
            if flags.get("has_telem"):
                kout = kout._replace(telem=tk._telem_launch(st, CPU, 8, False, False))
            pout = tk.quorum_multiround_impl(
                _state(fk), ack_t, vote_t, *churn_t, tick_mask,
                *(rd if flags.get("has_reads") else (None,) * 3),
                *(kv if kv is not None else ()), **flags)
            _assert_same(kout, pout, tag)
            if flags.get("has_reads"):
                for name in ("read_done_count", "read_done_index"):
                    assert torch.equal(getattr(kout, name), getattr(pout, name)), (tag, name)
            if kv is not None:
                _assert_kv_same(kout, pout, tag)


@pytest.mark.parametrize("g", EDGE_G)
@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_staged_edges_match_plain(launch, p, g):
    """The staged row loop at block edges, from a random state (leaders,
    candidates and followers, dead rows, self slots out of range) and from
    every row a leader with check-quorum on, with bases that wrap past the
    int32 maximum."""
    for i, (rounds, base) in enumerate(((1, 3), (9, 2**31 - 4), (12, -7))):
        rng = np.random.default_rng(7_700 + 10 * p + g + i)
        f = _hier_telem(_fields(7_700 + p + g + i, g, p), rng)
        if i == 2:
            f["node_state"][:], f["live"][:] = 2, True
            f["check_quorum_on"][:] = True
        kout = tk._staged_launch(_state(f), CPU, base, rounds)
        pout = tk.staged_multistep_impl(_state(f), base, rounds)
        _assert_same(kout, pout, (p, g, rounds, base))


@pytest.mark.parametrize("g", EDGE_G)
@pytest.mark.parametrize("p", WIDTHS)
def test_emulated_multistep_edges_match_plain(launch, p, g):
    """The dense and sparse R-round scans at block edges, everything on."""
    r = 3
    rng = np.random.default_rng(7_900 + 10 * p + g)
    f = _hier_telem(_fields(7_900 + p + g, g, p), rng)
    touched = torch.from_numpy(rng.random((r, g, p)) < 0.35)
    ack = torch.from_numpy(rng.integers(-6, 25, (r, g, p)).astype(np.int32))
    vote_new = torch.from_numpy(rng.choice([-1, -1, 0, 1], (r, g, p)).astype(np.int8))
    kout = tk._multistep_dense_launch(_state(f), CPU, ack, touched, vote_new,
                                      True, True, True, True)
    pout = tk.quorum_multistep_dense_impl(_state(f), ack, touched, vote_new,
                                          has_hier=True)
    _assert_same(kout, pout, ("dense", p, g))
    cap = 64
    acks = tuple(torch.from_numpy(a) for a in (
        rng.integers(0, g + 2, (r, cap)).astype(np.int32),
        rng.integers(0, p + 1, (r, cap)).astype(np.int32),
        rng.integers(-6, 25, (r, cap)).astype(np.int32), rng.random((r, cap)) < 0.9))
    vts = []
    for _ in range(r):
        cells = rng.choice(g * p, size=32, replace=False)
        vts.append((cells // p, cells % p))
    vts = (torch.from_numpy(np.stack([v[0] for v in vts]).astype(np.int32)),
           torch.from_numpy(np.stack([v[1] for v in vts]).astype(np.int32)),
           torch.from_numpy(rng.integers(0, 2, (r, 32)).astype(np.int8)),
           torch.from_numpy(rng.random((r, 32)) < 0.8))
    kout = tk._multistep_launch(_state(f), CPU, acks, vts, True, True, True, True)
    pout = tk.quorum_multistep_impl(_state(f), *acks, *vts, has_hier=True)
    _assert_same(kout, pout, ("sparse", p, g))
