"""The port's state layout against the JAX package's, field by field.

``dragonboat_tpu_torch.ops.state`` (make_state, HostMirror, state_layout,
the numpy carry-across) must reproduce ``dragonboat_tpu.ops.state`` exactly:
same fields in the same order, same shapes, dtypes and fill values.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dragonboat_tpu.ops import state as jstate  # noqa: E402
from dragonboat_tpu_torch.ops import state as tstate  # noqa: E402

torch.set_num_threads(1)

GRID = [(1, 1), (4, 3), (16, 5), (33, 8), (8, 12)]


def _jax_fields(g, p, **kw):
    st = jstate.make_state(g, p, **kw)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_fields_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert a[name].shape == b[name].shape, name
        assert np.array_equal(a[name], b[name]), name


@pytest.mark.parametrize("g,p", GRID)
def test_make_state_matches_reference(g, p):
    ours = tstate.state_to_numpy(tstate.make_state(g, p, device="cpu"))
    _assert_fields_equal(_jax_fields(g, p), ours)


@pytest.mark.parametrize("g,p", GRID)
def test_make_state_matches_reference_plane_widths(g, p):
    kw = dict(n_read_slots=2, n_kv_slots=3, n_kv_ents=5)
    ours = tstate.state_to_numpy(tstate.make_state(g, p, device="cpu", **kw))
    _assert_fields_equal(_jax_fields(g, p, **kw), ours)


@pytest.mark.parametrize("g,p", GRID)
def test_state_layout_matches_reference(g, p):
    assert tstate.state_layout(g, p) == jstate.state_layout(g, p)
    kw = dict(n_read_slots=3, n_kv_slots=2, n_kv_ents=7)
    assert tstate.state_layout(g, p, **kw) == jstate.state_layout(g, p, **kw)


def test_field_plane_and_constants_match_reference():
    for name in jstate.QuorumState._fields:
        assert tstate.field_plane(name) == jstate.field_plane(name)
    assert tstate.QuorumState._fields == jstate.QuorumState._fields
    for const in ("INDEX_MIN", "FOLLOWER", "CANDIDATE", "LEADER", "OBSERVER",
                  "WITNESS", "VOTE_NONE", "VOTE_REJECT", "VOTE_GRANT",
                  "READ_SLOTS", "KV_SLOTS", "KV_ENT_SLOTS", "KV_READ_SLOTS"):
        assert getattr(tstate, const) == getattr(jstate, const), const


def _scribble(mirror, rng):
    """Random values in every field of a mirror (same seed -> same values)."""
    for name, a in mirror.arrays.items():
        if name == "self_slot":  # recycle_row indexes the peer axis with it
            a[...] = rng.integers(0, mirror.n_peers, a.shape)
        elif a.dtype == np.bool_:
            a[...] = rng.random(a.shape) < 0.5
        else:
            a[...] = rng.integers(-3, 50, a.shape).astype(a.dtype)


@pytest.mark.parametrize("g,p", GRID)
def test_host_mirror_matches_reference(g, p):
    jm, tm = jstate.HostMirror(g, p), tstate.HostMirror(g, p)
    _assert_fields_equal(jm.arrays, tm.arrays)
    _scribble(jm, np.random.default_rng(5))
    _scribble(tm, np.random.default_rng(5))
    for row in range(min(g, 3)):
        jm.recycle_row(row, term=7, term_start=3, last_index=9)
        tm.recycle_row(row, term=7, term_start=3, last_index=9)
    row = g - 1
    kw = dict(clear_reads=False, clear_kv=False, clear_telem=False)
    jm.recycle_row(row, term=2, term_start=1, last_index=4, **kw)
    tm.recycle_row(row, term=2, term_start=1, last_index=4, **kw)
    _assert_fields_equal(jm.arrays, tm.arrays)

    img_j, img_t = jm.row_image(0), tm.row_image(0)
    _assert_fields_equal(img_j, img_t)
    jm.restore_row(g - 1, img_j)
    tm.restore_row(g - 1, img_t)
    skip = frozenset(jstate.READ_PLANE_FIELDS)
    assert set(tm.row_image(0, skip)) == set(jm.row_image(0, skip))
    _assert_fields_equal(jm.arrays, tm.arrays)


@pytest.mark.parametrize("g,p", GRID)
def test_host_mirror_pull_and_to_device(g, p):
    jm, tm = jstate.HostMirror(g, p), tstate.HostMirror(g, p)
    _scribble(jm, np.random.default_rng(9))
    _scribble(tm, np.random.default_rng(9))
    dev = tm.to_device("cpu")
    _assert_fields_equal(
        {k: np.asarray(v) for k, v in jm.to_device()._asdict().items()},
        tstate.state_to_numpy(dev),
    )
    # pull copies device values back over host edits
    fresh_t = tstate.HostMirror(g, p)
    fresh_t.pull(dev)
    _assert_fields_equal(tm.arrays, fresh_t.arrays)
    fresh_j = jstate.HostMirror(g, p)
    fresh_j.pull(jm.to_device())
    _assert_fields_equal(fresh_j.arrays, fresh_t.arrays)


@pytest.mark.parametrize("g,p", GRID)
def test_state_numpy_round_trip_of_jax_state_is_exact(g, p):
    jm = jstate.HostMirror(g, p)
    _scribble(jm, np.random.default_rng(g * 100 + p))
    jfields = {k: np.asarray(v) for k, v in jm.to_device()._asdict().items()}
    st = tstate.state_from_numpy(jfields, device="cpu")
    for name, t in st._asdict().items():
        assert t.dtype == tstate._TORCH_DTYPE[jfields[name].dtype], name
    _assert_fields_equal(jfields, tstate.state_to_numpy(st))


def test_state_from_numpy_rejects_wrong_dtype_and_missing_fields():
    fields = tstate.state_to_numpy(tstate.make_state(2, 3, device="cpu"))
    bad = dict(fields, term=fields["term"].astype(np.int64))
    with pytest.raises(ValueError, match="term"):
        tstate.state_from_numpy(bad, device="cpu")
    del fields["votes"]
    with pytest.raises(ValueError, match="votes"):
        tstate.state_from_numpy(fields, device="cpu")
