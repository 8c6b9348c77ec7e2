"""Device times of the device state machine's kernel and the telemetry
fold at their main paths' shapes, for timing edited trees in turns.

    python3 -m dragonboat_tpu_torch.time_kv_fold [--tag NAME] [--kernels-only]

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
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--kernels-only", action="store_true")
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
    dev = torch.device("cuda", 0)
    _build.library()
    cs.int32_peak(torch)
    out = {"tag": args.tag,
           "kv_random": time_kv(torch, cs, tk, ts, dev, drive=False),
           "kv_drive": time_kv(torch, cs, tk, ts, dev, drive=True),
           "fold_sweeps_off": time_fold(torch, cs, tk, ts, dev, sweeps=False),
           "fold_sweeps_on": time_fold(torch, cs, tk, ts, dev, sweeps=True)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
