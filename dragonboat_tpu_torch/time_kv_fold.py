"""Device times of the device state machine's kernel, the telemetry fold
and the single-round step kernels K1 and K2 at their main paths' shapes,
for timing edited trees in turns.

    python3 -m dragonboat_tpu_torch.time_kv_fold [--tag NAME]
        [--kernels-only | --steps-only]

Run from the root of a checkout (it uses ``chip_smoke.py``'s input and
timing helpers); needs one CUDA card.  It prints one JSON line:
``kv_plane`` on random buffers (``chip_smoke.py``'s ``_time_kv`` inputs:
65,536 rows, K = 16, V = E = 16, R = 4) and on drive-like buffers (8 SETs
a row staged in round 0 at the next 8 indexes, 2 reads in the last
round), and the fold at 100,000 x 5, k = 8, with the occupancy sweeps off
and on; each with whether it equals the plain version.  Equality is
reported, not required, so that a tree edited to leave a part out can be
timed.  ``--kernels-only`` compiles only ``kv_plane.cu`` and
``telem_fold.cu`` (with a one-line source for ``qs_error_string``), in
seconds instead of a minute, so that many trees build in one call.

``--steps-only`` compiles only K1's and K2's sources
(``quorum_step_dense.cu``, ``quorum_step_dense_reads.cu``,
``quorum_step.cu``) and an empty kernel, and times K1 and K2 with ticks
and contact on and votes off (the main paths' variant) at 100,000 x 5,
K2 with 4,096 ack events, each with and without the hier rule; K1's
READS instance at 65,536 x 5, S = 4; and an empty launch of the grid
each of them launches, the floor of a single-round kernel.  Each step is
timed twice: on a state restored just before the launch (it then sits in
the 50 MB L2 cache, as on the engine's paths) and with a 256 MB write
between the restore and the launch, which evicts it from L2.  Without
either switch the whole library is built and everything is timed.
A variant is timed as an edited tree of its own, each run with its
``--tag``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

_ERRORS = ('#include "quorum.cuh"\n'
           'extern "C" const char* qs_error_string(int c) {\n'
           '  return cudaGetErrorString((cudaError_t)c);\n}\n')


def _kernels_only(build) -> None:
    """Point the build at the two sources and an error-string source."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    errors = os.path.join(build.BUILD_DIR, "qs_errors.cu")
    with open(errors, "w") as f:
        f.write(_ERRORS)
    build.SOURCES = ("kv_plane.cu", "telem_fold.cu", errors)
    build.COMPILE_FLAGS = build.COMPILE_FLAGS + ["-I", build.SRC_DIR]
    build._SIGNATURES = {name: sig for name, sig in build._SIGNATURES.items()
                         if name in ("qs_kv_plane", "qs_telem")}


_EMPTY = ('#include <cuda_runtime.h>\n'
          'static __global__ void qs_empty_kernel() {}\n'
          'extern "C" int qs_empty(int grid, int block, void* stream) {\n'
          '  qs_empty_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();\n'
          '  return (int)cudaGetLastError();\n}\n')


def _steps_only(build) -> None:
    """Point the build at K1's and K2's sources and the empty kernel."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    empty = os.path.join(build.BUILD_DIR, "qs_empty.cu")
    with open(empty, "w") as f:
        f.write(_EMPTY)
    build.SOURCES = ("quorum_step_dense.cu", "quorum_step_dense_reads.cu",
                     "quorum_step.cu", empty)
    build.COMPILE_FLAGS = build.COMPILE_FLAGS + ["-I", build.SRC_DIR]
    build._SIGNATURES = {name: sig for name, sig in build._SIGNATURES.items()
                         if name in ("qs_dense", "qs_sparse", "qs_slab_layout")}


def _rows_a_block(lib) -> int:
    """Rows a block of K1 at 100,000 x 5 as its launcher lays it out
    (``qs_slab_layout``); in a tree without it, 256 (one row a thread in
    blocks of ``BLOCK``)."""
    if not hasattr(lib, "qs_slab_layout"):
        return 256
    return lib.qs_slab_layout(1, 5, 0, 0, (ctypes.c_int * 3)())


# K1 and K2 as the main paths run them, and K1's READS instance as the
# read op script's single-round read dispatch runs it
_MAIN = dict(do_tick=True, track_contact=True, has_votes=False)
STEP_CASES = (
    ("quorum_step_dense", _MAIN, 100_000, None),
    ("quorum_step_dense", dict(_MAIN, has_hier=True), 100_000, None),
    ("quorum_step", _MAIN, 100_000, None),
    ("quorum_step", dict(_MAIN, has_hier=True), 100_000, None),
    ("quorum_step_dense", dict(_MAIN, has_reads=True), 65_536, 4),
)


def time_step(torch, cs, tk, ts, dev, name, flags, g, s, flush) -> dict:
    """One step kernel at ``g`` x 5 (``s`` read slots), timed warm (its
    state restored just before each launch) and cold (``flush`` written
    between the restore and the launch), with its bound and whether it
    equals the plain version."""
    import numpy as np

    p, seed = 5, 30_000 if s is None else 32_000
    fields = cs.random_fields(ts, seed, g, p, s)
    inputs = cs._inputs(name, seed, g, p, s=s)
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    entry, plain_fn = cs._entries(tk, name)
    args = [torch.from_numpy(np.array(a)).to(dev) for grp in inputs for a in grp]
    saved = [t.clone() for t in st_k]

    def kern():
        return entry(st_k, *args, **flags)

    def reset():
        for t, s0 in zip(st_k, saved):
            t.copy_(s0)

    def cold():
        reset()
        flush.fill_(1)

    pout = plain_fn(st_p, *args, **flags)
    nbytes = cs.kernel_bytes(name, inputs, flags, st_p, pout.state)
    b_ms, b_by = cs.bound_ms(nbytes, cs.kernel_ops(g, p, s=s or 0))
    warm = cs.device_ms(torch, kern, reset)
    cold_ms = cs.device_ms(torch, kern, cold)
    reset()
    kout = kern()
    torch.cuda.synchronize()
    try:
        cs._equal_outputs(torch, ts, tk, kout, pout, name)
        equal = True
    except cs.PhaseError:
        equal = False
    return {"name": name, "flags": flags, "G": g, "P": p, "S": s, "ms": warm,
            "ms_cold_l2": cold_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "equal": equal}


def time_empty(torch, cs, lib, dev, grid, block) -> float:
    """An empty kernel's device time on ``grid`` blocks of ``block``
    threads."""
    lib.qs_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.qs_empty.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.qs_empty(grid, block, stream)
        if rc != 0:
            raise RuntimeError(f"the empty launch failed: {rc}")

    return cs.device_ms(torch, launch, lambda: None)


def time_steps(torch, cs, tk, ts, build, dev, empty: bool) -> dict:
    flush = torch.empty((256 << 20,), dtype=torch.uint8, device=dev)
    out = {"steps": [time_step(torch, cs, tk, ts, dev, name, flags, g, s, flush)
                     for name, flags, g, s in STEP_CASES]}
    if empty:
        lib = build.library()
        rows = _rows_a_block(lib)
        out["rows_a_block"] = rows
        out["empty_ms"] = {str(g): time_empty(torch, cs, lib, dev, -(-g // rows), rows)
                           for g in (100_000, 65_536)}
    return out


def time_kv(torch, cs, tk, ts, dev, drive: bool) -> dict:
    import numpy as np

    g, k, v, e, r = 65_536, 16, 16, 16, 4
    fields = cs.random_fields(ts, 33_000, g, 5, kv=(v, e))
    kv = list(cs.kv_inputs(33_000, g, v, e, r, k=k))
    trace = (np.maximum(fields["committed"], 0)[None, :]
             + np.arange(1, k + 1)[:, None]).astype(np.int32)
    if drive:
        fields["kv_ent_index"][:] = -1
        kv[0][:] = -1
        kv[0][0, :, :8] = trace[0][:, None] + np.arange(1, 9)[None, :]
        kv[1][0, :, :8] = np.arange(8)[None, :]
        kv[3][:] = -1
        kv[3][k - 1, :, :2] = np.array([1, 5])[None, :]
    st_k = ts.state_from_numpy(fields, dev)
    st_p = ts.state_from_numpy(fields, dev)
    ins = [torch.from_numpy(a).to(dev) for a in kv]
    tr = torch.from_numpy(trace).to(dev)
    ck, block = tk._ckv(st_k, dev, ins, k, tr, None)
    saved = [t.clone() for t in st_k]

    def kern():
        tk._kv_run(dev, ck, tk._KV_PLANE | tk._KV_CARRY)

    def reset():
        for t, s in zip(st_k, saved):
            t.copy_(s)

    ms = cs.device_ms(torch, kern, reset)
    reset()
    kern()
    pst, pv, pi, pa = cs.plain_kv_rounds(torch, tk, st_p, ins, tr)
    torch.cuda.synchronize()
    rv, ri, ra = tk._kv_views(block, g, r)
    pairs = [(st_k.kv_value, pst.kv_value), (st_k.kv_ent_index, pst.kv_ent_index),
             (rv, pv), (ri, pi), (ra, pa)]
    return {"ms": ms, "equal": all(torch.equal(a, b) for a, b in pairs),
            "applied": int(pa.sum())}


def time_fold(torch, cs, tk, ts, dev, sweeps: bool) -> dict:
    fields = cs.telem_fields(ts, 31_000, 100_000, 5)
    st = ts.state_from_numpy(fields, dev)
    saved = st.telem_prev_committed.clone()
    ms = cs.device_ms(torch, lambda: tk.telem_fold(st, 8, sweeps, sweeps),
                      lambda: st.telem_prev_committed.copy_(saved))
    st.telem_prev_committed.copy_(saved)
    agg = tk.telem_fold(st, 8, sweeps, sweeps)
    plain = tk.telem_fold_impl(ts.state_from_numpy(fields, dev), 8, sweeps, sweeps)[1]
    torch.cuda.synchronize()
    return {"ms": ms, "equal": all(torch.equal(a, b.to(torch.int32))
                                   for a, b in zip(agg, plain))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--kernels-only", action="store_true")
    only.add_argument("--steps-only", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_kv_fold: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from .ops import _build
    from .ops import kernels as tk
    from .ops import state as ts

    if args.kernels_only:
        _kernels_only(_build)
    elif args.steps_only:
        _steps_only(_build)
    dev = torch.device("cuda", 0)
    _build.library()
    cs.int32_peak(torch)
    out = {"tag": args.tag,
           "build_s": _build.build_info.get("seconds"),
           "source_s": {os.path.basename(k): v for k, v in
                        (_build.build_info.get("source_seconds") or {}).items()}}
    if not args.steps_only:
        out.update(kv_random=time_kv(torch, cs, tk, ts, dev, drive=False),
                   kv_drive=time_kv(torch, cs, tk, ts, dev, drive=True),
                   fold_sweeps_off=time_fold(torch, cs, tk, ts, dev, sweeps=False),
                   fold_sweeps_on=time_fold(torch, cs, tk, ts, dev, sweeps=True))
    if not args.kernels_only:
        out.update(time_steps(torch, cs, tk, ts, _build, dev, empty=args.steps_only))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
