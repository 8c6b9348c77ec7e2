"""The device state machine's kernel (``csrc/kv_plane.cu``) and the
telemetry fold (``csrc/telem_fold.cu``) at their edges, in the emulated
build, against the plain versions.

``kv_plane.cu`` gives each row a segment of L lanes (L the power of two at
or above max(E, R)), so a warp holds 32 / L rows: at G in {61, 64} the
last warp ends part-way through its rows or on a row boundary, and the
widths cover one row a warp (E = 17, not a power of two), R > E, and the
caps.  The fold runs as one launch whose last block (by a ticket the
wrapper keeps a stream) writes the output: every case folds twice, back
to back, so a ticket left unreset fails the second; k = 33 takes the
kernel's general path wherever G allows it.  The emulation itself
(``QS_LAUNCH_COOP``: fibers, and the warp intrinsics as exchanges at a
warp's barrier) is checked on its own at the end.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dragonboat_tpu_torch.ops import _build
from dragonboat_tpu_torch.ops import kernels as tk
from tests.test_torch_csrc import (  # noqa: F401  (emulated, launch: fixtures)
    CPU, _assert_kv_same, _assert_same, _fields, _hier_telem, _kv_inputs,
    _kv_state, _read_block, _state, emulated, launch,
)

torch.set_num_threads(1)

KV_EDGE_G = [61, 64]
# (V, E, R): rung 4's, the least, the caps, R > E, one row a warp with E
# not a power of two, and a narrow entry buffer under eight read slots
KV_EDGE_WIDTHS = [(16, 16, 4), (1, 1, 1), (1024, 32, 8), (16, 5, 8), (33, 17, 3),
                  (8, 2, 8)]


def _churn(rng, g, k, c):
    """K3's recycle records: c - 1 random rows a round past row 0 (a row
    of ``g`` means none) and row 0, entries buffered, at round 5."""
    rows = np.full((k, c), g, np.int32)
    for rr in range(k):
        rows[rr, :c - 1] = rng.choice(np.arange(1, g), size=c - 1, replace=False)
    rows[5, c - 1] = 0
    start = rng.integers(0, 5, (k, c)).astype(np.int32)
    return tuple(torch.from_numpy(a) for a in (
        rows, rng.integers(1, 9, (k, c)).astype(np.int32), start,
        (start + rng.integers(0, 5, (k, c))).astype(np.int32)))


@pytest.mark.parametrize("v,e,r", KV_EDGE_WIDTHS)
@pytest.mark.parametrize("g", KV_EDGE_G)
def test_emulated_kv_plane_edges_after_dense_kernel(launch, g, v, e, r):
    """One round after K1, with and without its READS instance and ticks."""
    p = 5
    for i, (tick, reads) in enumerate(((False, False), (True, True))):
        seed = 7_000 + 100 * g + 10 * e + i
        rng = np.random.default_rng(seed)
        f, rd = _read_block(seed, g, p, 4, 1)
        f = _kv_state(_hier_telem(f, rng), rng, v, e)
        kv = _kv_inputs(rng, g, v, e, r)
        touched = torch.from_numpy(rng.random((g, p)) < 0.5)
        ack = torch.where(
            touched, torch.from_numpy(rng.integers(0, 25, (g, p)).astype(np.int32)), 0)
        rd1 = (rd[0][0], rd[1][0], rd[2][0]) if reads else None
        kout = tk._dense_launch(_state(f), CPU, ack, touched, None, tick, True, False,
                                False, reads=rd1, kv=kv)
        pout = tk.quorum_step_dense_impl(
            _state(f), ack, touched, None, *(rd1 or (None,) * 3), *kv, do_tick=tick,
            has_votes=False, has_reads=reads, has_kv=True,
        )
        _assert_kv_same(kout, pout, (g, v, e, r, tick, reads))
        assert pout.kv_applied.sum() > 0 and (pout.kv_read_index >= 0).any()
    assert tk.launch_counts()["kv_plane"] == 2


@pytest.mark.parametrize("v,e,r", KV_EDGE_WIDTHS)
@pytest.mark.parametrize("g", KV_EDGE_G)
def test_emulated_kv_plane_edges_after_multiround_kernel(launch, g, v, e, r):
    """K = 16 rounds on K3's trace with the churn reset (row 0, entries
    buffered, at round 5) and the carry of the captures."""
    k, c, p = 16, 6, 3
    for i, reads in enumerate((False, True)):
        seed = 8_000 + 100 * g + 10 * e + i
        rng = np.random.default_rng(seed)
        f, rd = _read_block(seed, g, p, 4, k)
        f = _kv_state(f, rng, v, e)
        ack = np.where(rng.random((k, g, p)) < 0.4, rng.integers(0, 25, (k, g, p)),
                       -1).astype(np.int32)
        churn_t = _churn(rng, g, k, c)
        tick_mask = torch.from_numpy(rng.random(k) < 0.5)
        kv = _kv_inputs(rng, g, v, e, r, lead=(k,))
        ack_t, vote_t = torch.from_numpy(ack), torch.zeros((1, 1, 1), dtype=torch.int8)
        kout = tk._multiround_launch(
            _state(f), CPU, ack_t, vote_t, churn_t, tick_mask, True, True, False, True,
            reads=rd if reads else None, reset_reads=reads, kv=kv, reset_kv=True,
        )
        pout = tk.quorum_multiround_impl(
            _state(f), ack_t, vote_t, *churn_t, tick_mask, *(rd if reads else (None,) * 3),
            *kv, do_tick=True, has_churn=True, has_reads=reads, has_kv=True,
        )
        _assert_kv_same(kout, pout, (g, v, e, r, reads))
        assert pout.kv_applied.sum() > 0 and (pout.kv_read_index >= 0).any()
    assert tk.launch_counts()["kv_plane"] == 2


@pytest.mark.parametrize("v,e,r", KV_EDGE_WIDTHS)
@pytest.mark.parametrize("g", KV_EDGE_G)
def test_emulated_kv_purge_alone_edges(launch, g, v, e, r):
    """The purge alone (purge_kv on a kv-free K3 block): every row the
    churn map names in any round is reset, the others untouched."""
    k, c, p = 16, 6, 3
    seed = 9_000 + 100 * g + 10 * e
    rng = np.random.default_rng(seed)
    f = _kv_state(_fields(seed, g, p), rng, v, e)
    ack_t = torch.from_numpy(np.where(rng.random((k, g, p)) < 0.4,
                                      rng.integers(0, 25, (k, g, p)), -1).astype(np.int32))
    vote_t = torch.zeros((1, 1, 1), dtype=torch.int8)
    churn_t = _churn(rng, g, k, c)
    tick_mask = torch.from_numpy(rng.random(k) < 0.5)
    kout = tk._multiround_launch(_state(f), CPU, ack_t, vote_t, churn_t, tick_mask, True,
                                 True, False, True, reset_kv=True)
    pout = tk.quorum_multiround_impl(_state(f), ack_t, vote_t, *churn_t, tick_mask,
                                     do_tick=True, has_churn=True, purge_kv=True)
    _assert_same(kout, pout, (g, v, e, r, "purge"))
    reset = (pout.state.kv_ent_index == -1).all(1) & (pout.state.kv_value == 0).all(1)
    assert reset[0] and not reset.all()
    assert tk.launch_counts()["kv_plane"] == 1


def _fold_fields(seed, g, edges=(0, 0, 0, 1, 2, 3, 4, 7, 8, 2**14, 2**25 - 1)):
    rng = np.random.default_rng(seed)
    f = _hier_telem(_fields(seed, g, 5), rng)
    f["last_index"][:] = f["committed"] + rng.choice(edges, g)
    f["read_count"][:] = rng.integers(0, 3, f["read_count"].shape)
    f["kv_ent_index"][:] = rng.integers(-1, 3, f["kv_ent_index"].shape)
    return f


def _fold_twice(f, k, reads, kv, tag):
    """Two folds back to back on the kernel and on the plain version, each
    compared: the second sees the first's watermarks (every lagging live
    row stalls), and fails if the first left the ticket unreset."""
    st, pst = _state(f), _state(f)
    held = []
    for n in range(2):
        agg = tk._telem_launch(st, CPU, k, reads, kv)
        pst, pagg = tk.telem_fold_impl(pst, k, reads, kv)
        for name, a, b in zip(tk.TelemAggregate._fields, agg, pagg):
            assert torch.equal(a, b.to(torch.int32)), (tag, n, name)
        assert torch.equal(st.telem_prev_committed, pst.telem_prev_committed), (tag, n)
        held.append(agg)  # keeps the first block from being reused by the second
    assert int(tk._telem_ticket(CPU, None)[0]) == 0
    return held


@pytest.mark.parametrize("k", [1, 8, 16, 33])
@pytest.mark.parametrize("g", [1, 5, 255, 257, 700])
def test_emulated_telem_fold_edges(launch, g, k):
    """G around the 256-row block (one block, a block and a row, three
    blocks), k on the warp path and past it (33, clamped to G), the
    occupancy sweeps off and on, two folds back to back."""
    for i, (reads, kv) in enumerate(((False, False), (True, True))):
        f = _fold_fields(10_000 + 10 * g + k + i, g)
        _fold_twice(f, k, reads, kv, (g, k, reads, kv))
    assert tk.launch_counts()["telem_fold"] == 4


@pytest.mark.parametrize("g,k", [(5, 8), (257, 8), (700, 33)])
def test_emulated_telem_fold_all_rows_dead(launch, g, k):
    """No live row: empty counters, and every top-K slot at row -1, lag -1."""
    f = _fold_fields(11_000 + g, g)
    f["live"][:] = False
    first, _ = _fold_twice(f, k, True, True, (g, k, "dead"))
    assert not first.lag_hist.any() and (first.topk_row == -1).all()
    assert (first.topk_lag == -1).all()


@pytest.mark.parametrize("g,k", [(5, 8), (257, 16), (700, 8), (700, 33)])
def test_emulated_telem_fold_every_lag_tied(launch, g, k):
    """Every row live with the same lag: the top K are the K lowest rows."""
    f = _fold_fields(12_000 + g, g, edges=(9,))
    f["live"][:] = True
    first, _ = _fold_twice(f, k, False, False, (g, k, "tied"))
    kk = min(k, g)
    assert torch.equal(first.topk_row, torch.arange(kk, dtype=torch.int32))
    assert (first.topk_lag == 9).all()


def test_telem_ticket_is_one_a_stream():
    """The wrapper keeps one zeroed ticket per (device, stream)."""
    a, b = tk._telem_ticket(CPU, 1001), tk._telem_ticket(CPU, 1002)
    assert a is not b and a is tk._telem_ticket(CPU, 1001)
    assert int(a[0]) == 0 and int(b[0]) == 0


@pytest.mark.parametrize("g", [300, 700])
def test_emulated_telem_fold_needs_its_ticket_at_zero(launch, g):
    """The protocol the back-to-back folds rely on: with the ticket off 0
    no block finds itself last and the output is never written, so a
    ticket left unreset cannot go unnoticed."""
    f = _fold_fields(13_000 + g, g)
    ticket = tk._telem_ticket(CPU, None)
    ticket[0] = 1
    try:
        agg = tk._telem_launch(_state(f), CPU, 8, False, False)
    finally:
        ticket[0] = 0
    plain = tk.telem_fold_impl(_state(f), 8, False, False)[1]
    assert not all(torch.equal(a, b.to(torch.int32)) for a, b in zip(agg, plain))


# ----------------------------------------------------------------------
# the emulator's warp intrinsics, on kernels of their own
# ----------------------------------------------------------------------

_PROBE = r"""
#include "quorum.cuh"
// out[t]: lane t's result; mode picks the intrinsic under test
__global__ void probe(int mode, long long* out) {
  const int lane = threadIdx.x & 31;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (mode == 0) {  // labeled partitions: lanes by lane % 3
    const unsigned peers = __match_any_sync(qs::WARP_ALL, lane % 3);
    out[t] = (long long)__reduce_add_sync(peers, (unsigned)lane) << 32 |
             (unsigned)__reduce_max_sync(peers, lane);
  } else if (mode == 1) {  // a 64-bit butterfly and a ballot
    long long v = (long long)lane << 40;
    for (int m = 16; m; m >>= 1) {
      const long long o = __shfl_xor_sync(qs::WARP_ALL, v, m);
      v = o > v ? o : v;
    }
    out[t] = v + __popc(__ballot_sync(qs::WARP_ALL, lane & 1)) +
             __shfl_sync(qs::WARP_ALL, lane, 5, 8);
  } else if (mode == 2) {  // a lane leaves before its warp's __syncwarp
    if (lane == 7) return;
    __syncwarp();
    out[t] = 1;
  } else {  // lanes that name each other with different masks
    out[t] = __reduce_add_sync(lane < 16 ? 0xffffu : qs::WARP_ALL, 1u);
  }
}
extern "C" int run_probe(int mode, int grid, long long* out) {
  QS_LAUNCH_COOP(probe, grid, 64, nullptr, mode, out);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The probe kernel, built as host C++ under QS_EMULATE; ``run(mode)``
    launches two 64-thread blocks and returns the launch's error code and
    each thread's result."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("qs_probe")
    (out / "probe.cu").write_text(_PROBE)
    lib = str(out / "libprobe.so")
    subprocess.run([cxx, "-std=c++17", "-O0", "-DQS_EMULATE", "-fPIC", "-w", "-shared",
                    "-I", _build.SRC_DIR, "-x", "c++", str(out / "probe.cu"), "-o", lib],
                   check=True, timeout=300)
    so = ctypes.CDLL(lib)
    so.run_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def run(mode, grid=2):
        buf = torch.zeros((grid * 64,), dtype=torch.int64)
        return so.run_probe(mode, grid, buf.data_ptr()), buf.numpy()
    return run


def test_emulator_reduces_over_each_lanes_own_mask(probe):
    rc, out = probe(0)
    assert rc == 0
    lanes = np.arange(128) % 32
    want_sum = np.array([lanes[:32][lanes[:32] % 3 == ln % 3].sum() for ln in lanes])
    want_max = np.array([lanes[:32][lanes[:32] % 3 == ln % 3].max() for ln in lanes])
    assert np.array_equal(out >> 32, want_sum)
    assert np.array_equal(out & 0xFFFFFFFF, want_max)


def test_emulator_shuffles_and_ballots(probe):
    rc, out = probe(1)
    assert rc == 0
    lanes = np.arange(128) % 32
    assert np.array_equal(out, (31 << 40) + 16 + (lanes // 8 * 8 + 5))


@pytest.mark.parametrize("mode", [2, 3])
def test_emulator_fails_a_launch_the_card_leaves_undefined(probe, mode):
    """A lane that skips its warp's __syncwarp, and masks that disagree,
    fail the launch instead of giving a result."""
    rc, _ = probe(mode)
    assert rc != 0
    assert probe(0)[0] == 0  # the next launch is clean


@pytest.mark.parametrize("g,k", [(32_769, 32)])
def test_emulated_telem_fold_merge_past_the_registers(launch, g, k):
    """More candidates than the last block holds in registers (129 blocks
    x 32 > 256 x 16): the merge reads the rest from memory every round.
    The last row, whose candidate lies past them, has the largest lag."""
    f = _fold_fields(15_000 + g, g)
    f["live"][-1] = True
    f["last_index"][-1] = f["committed"][-1] + 2**26
    first, _ = _fold_twice(f, k, True, False, (g, k, "past the registers"))
    assert int(first.topk_row[0]) == g - 1
