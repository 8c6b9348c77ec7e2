"""Builds the hand-written CUDA kernels of ``csrc/`` and binds them.

At first use the ``.cu`` sources are compiled for ``sm_90a`` with one
``nvcc`` process each, all started together, and linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The library
goes to ``dragonboat_tpu_torch/_build/`` under a name keyed on a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from ..logger import get_logger

blog = get_logger("ops.build")

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("quorum_step_dense.cu", "quorum_step_dense_reads.cu",
           "quorum_step.cu", "quorum_multiround.cu",
           "quorum_multiround_reads.cu", "quorum_multiround_reads_hier.cu",
           "telem_fold.cu", "kv_plane.cu", "quorum_multistep.cu")
HEADERS = ("quorum.cuh", "launch.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_mu = threading.Lock()
_lib = None
#: what the last build or load did: library path, seconds, whether it
#: compiled, and nvcc's output (``-Xptxas -v`` register/spill report)
build_info: dict = {}


class CState(ctypes.Structure):
    """``qs::State`` in ``csrc/quorum.cuh``: the quorum-, hier- and
    telem-plane pointers, in the same order."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "node_state", "term", "committed", "last_index", "term_start",
            "quorum", "self_slot", "election_tick", "heartbeat_tick",
            "rand_timeout", "election_timeout", "heartbeat_timeout",
            "electable", "check_quorum_on", "live", "match", "next",
            "voting", "active", "votes", "near", "sub_quorum",
            "telem_prev_committed",
        )
    ] + [("G", ctypes.c_int32), ("P", ctypes.c_int32)]


class CReads(ctypes.Structure):
    """``qs::Reads`` in ``csrc/quorum.cuh``: the read plane's state slots,
    its inputs, its (G, S) outputs and S."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "read_index", "read_count", "read_acks", "stage_idx", "stage_cnt",
            "echo", "done_count", "done_index",
        )
    ] + [("S", ctypes.c_int32)]


class CKv(ctypes.Structure):
    """``qs::Kv`` in ``csrc/kv_plane.cu``: the device state machine's
    state fields, one launch's inputs, the per-round watermarks, K3's
    churn map, the egress, and the widths."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "value", "ent_index", "ent_key", "ent_val", "in_idx", "in_key",
            "in_val", "read_key", "commits", "churn_map", "read_val",
            "read_idx", "applied",
        )
    ] + [(name, ctypes.c_int32) for name in ("G", "V", "E", "R", "K")]


class CFlags(ctypes.Structure):
    """``qs::Flags`` in ``csrc/quorum.cuh``: the (G,) bool outputs."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("won", "lost", "elect_due", "hb_due", "checkq_demote")
    ]


_VP = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # qs_dense(state, ack_max, touched, vote_new, reads, flags_out, flags,
    #          stream)
    "qs_dense": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP],
    # qs_sparse(state, ack_g, ack_p, ack_val, ack_valid, n_acks, vote_g,
    #           vote_p, vote_grant, vote_valid, n_votes, contacted,
    #           flags_out, flags, stream)
    "qs_sparse": [_VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP, _VP, _VP, _INT,
                  _VP, _VP, _INT, _VP],
    # qs_multiround(state, ack, vote_new, churn_row, churn_term,
    #               churn_start, churn_last, n_records, tick_mask,
    #               n_rounds, churn_map, commit_trace, reads, flags_out,
    #               flags, stream)
    "qs_multiround": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _INT,
                      _VP, _VP, _VP, _VP, _INT, _VP],
    # qs_telem(state, read_count, n_read_slots, kv_ent_index, n_kv_ents, k,
    #          out, cand, n_cand, counts, n_counts, ticket, flags, stream)
    "qs_telem": [_VP, _VP, _INT, _VP, _INT, _INT, _VP, _VP, _INT, _VP, _INT,
                 _VP, _INT, _VP],
    # qs_kv_plane(kv, flags, stream)
    "qs_kv_plane": [_VP, _INT, _VP],
    # qs_multistep_dense(state, ack_max, touched, vote_new, n_rounds,
    #                    flags_out, flags, stream)
    "qs_multistep_dense": [_VP, _VP, _VP, _VP, _INT, _VP, _INT, _VP],
    # qs_multistep(state, ack_g, ack_p, ack_val, ack_valid, n_acks, vote_g,
    #              vote_p, vote_grant, vote_valid, n_votes, n_rounds,
    #              sc_max, sc_touched, sc_vote, sc_contacted, flags_out,
    #              flags, stream)
    "qs_multistep": [_VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP, _VP, _VP, _INT,
                     _INT, _VP, _VP, _VP, _VP, _VP, _INT, _VP],
    # qs_staged_multistep(state, base_index, n_rounds, flags_out, flags,
    #                     stream)
    "qs_staged_multistep": [_VP, _INT, _INT, _VP, _INT, _VP],
    # qs_slab_layout(dense, p, S, flags, out[3]) -> rows a block
    "qs_slab_layout": [_INT, _INT, _INT, _INT, _VP],
}


def source_hash() -> str:
    """SHA-256 over the kernel sources, headers and compiler flags."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(COMPILE_FLAGS).encode())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with the CUDA "
            "toolkit's nvcc (on PATH or under /usr/local/cuda/bin)"
        )
    return found


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libquorum-{source_hash()[:16]}.so")


def build() -> str:
    """Compile and link the library unless it exists; returns its path."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", os.path.join(SRC_DIR, src),
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs, ends = _wait_all(procs, t0)
        logs, failed = [], []
        for src, proc, out in zip(SOURCES, procs, outs):
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log[-8000:]}")
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
        os.replace(tmp_lib, lib)
    with open(lib + ".log", "w") as f:
        f.write(log)
    build_info.update(
        path=lib, compiled=True, seconds=time.perf_counter() - t0, log=log,
        source_seconds=dict(zip(SOURCES, ends)),
    )
    blog.info("built %s in %.1f s", lib, build_info["seconds"])
    return lib


def _wait_all(procs, t0):
    """Wait for every compiler process; returns their outputs and the
    seconds since ``t0`` at which each was seen to end.  One reader
    thread a process drains its pipe, so none blocks on a full one."""
    outs = [None] * len(procs)
    ends = [None] * len(procs)

    def drain(i):
        outs[i], _ = procs[i].communicate()
        ends[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, ends


def bind(path: str) -> ctypes.CDLL:
    """Load a library with the ``csrc/`` C interface and declare it."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qs_error_string.argtypes = [ctypes.c_int]
    lib.qs_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The bound kernel library, built at the first call."""
    global _lib
    with _mu:
        if _lib is None:
            t0 = time.perf_counter()
            path = build()
            _lib = bind(path)
            build_info.setdefault("compiled", False)
            build_info.setdefault("path", path)
            build_info["load_seconds"] = time.perf_counter() - t0
        return _lib


def loaded() -> bool:
    """True once :func:`library` has built (or found) and loaded it."""
    return _lib is not None
