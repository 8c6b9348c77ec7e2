"""What the compiler made of the row loops: registers, stack frames, spills,
blocks an SM, and the instructions of each loop in the SASS.

    python3 -m dragonboat_tpu_torch.sass_report [--out DIR] [--match TEXT ...]

Needs ``nvcc`` (it builds the kernel library as ``ops/_build.py`` does, or
loads the one already built) and reads ``cuobjdump -sass`` of the library
where the toolkit has it; a card is not needed.  For every kernel instance
whose demangled name contains one of the ``--match`` texts (default: the
staged row loop at every width and K3's instances on the engine's paths)
it prints one JSON line: ``-Xptxas -v``'s registers, stack frame and
spill bytes, the blocks an SM and the waves at the main path's shape
(from the registers, the block size and the shared memory, K3's ring
included, by the occupancy rules of compute capability 9.0), and per
backward branch of
the SASS (a loop) its instruction count and its global (``LDG``), local
(``LDL``/``STL``) and shared (``LDS``) loads and stores.  The SASS of
each chosen instance goes to ``DIR/<instance>.sass`` (default: ``sass/``
in the build directory).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

from .ops import _build
from .ops import kernels as tk

# the instances the main paths run: the staged row loop at every width
# (``staged_kernel``; in trees before it, the STAGED instance of
# ``multistep_kernel``), K3 as rung 5 runs it, with hier as rung 5 with
# hier, its READS instance as rung 4's mixed phase, its plain one as rung
# 4's write window and the host loop, and with ticks; the device state
# machine and its purge; the telemetry fold (``telem_kernel``; in trees
# before it, ``telem_rows_kernel`` and ``telem_topk_kernel``); K1 with
# ticks and contact, plain, HIER and READS, and K2's two kernels as the
# engine's single-round dispatches run them
DEFAULT_MATCH = (
    "qs::multistep_kernel<3, true, false, false, true>",
    "qs::staged_kernel<",
    "qs::multiround_kernel<5, false, false, true, false, false>",
    "qs::multiround_kernel<5, false, false, true, true, false>",
    "qs::multiround_kernel<5, false, false, false, false, false>",
    "qs::multiround_kernel<5, false, false, false, false, true>",
    "qs::multiround_kernel<5, true, false, false, false, false>",
    "qs::kv_plane_kernel",
    "qs::kv_purge_kernel",
    "qs::telem_kernel",
    "qs::telem_rows_kernel",
    "qs::telem_topk_kernel",
    "qs::dense_kernel<5, true, false, false, false>",
    "qs::dense_kernel<5, true, false, true, false>",
    "qs::dense_kernel<5, true, false, false, true>",
    "qs::sparse_rows_kernel<5, true, true, false>",
    "qs::sparse_events_kernel<",
)
# the rows each kernel family runs at on its main path (rung 4 devsm's
# 65,536 for the device state machine, rung 5's 100,000 for the fold)
SHAPES = {"multistep_kernel": (131_072,), "staged_kernel": (131_072,),
          "multiround_kernel": (100_000,), "kv_plane_kernel": (65_536,),
          "kv_purge_kernel": (65_536,), "telem_kernel": (100_000,),
          "telem_rows_kernel": (100_000,), "telem_topk_kernel": (256,),
          "dense_kernel": (100_000,), "sparse_rows_kernel": (100_000,),
          "sparse_events_kernel": (4_096,)}
# the memory instructions counted over a whole kernel (K1 and K2 have no
# round loop)
MEMORY_OPS = ("LDG", "STG", "LDS", "STS", "LDGSTS", "UBLKCP", "SYNCS", "LDL", "STL")

# compute capability 9.0: registers, warps and blocks an SM, and the
# register file's allocation unit (registers a warp, rounded up to 256)
SM_REGS, SM_WARPS, SM_BLOCKS, SM_SMEM, SMS = 65_536, 64, 32, 233_472, 132


def blocks_per_sm(regs: int, threads: int, smem: int = 0) -> int:
    """Resident blocks an SM by registers, warps, blocks and shared memory
    (1 KB of shared memory is reserved a block)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (SM_REGS // per_warp) // warps if per_warp else SM_BLOCKS
    by_smem = SM_SMEM // (smem + 1024)
    return max(0, min(SM_BLOCKS, SM_WARPS // warps, by_regs, by_smem))


def demangle(names):
    """Demangled names, with template arguments written as C++ source
    writes them (``cu++filt`` prints ``(bool)1`` for ``true``)."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not os.path.exists(tool):
        return dict(zip(names, names))
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=120).stdout.splitlines()
    if len(out) != len(names):
        return dict(zip(names, names))
    out = [re.sub(r"\(int\)", "", o).replace("(bool)1", "true").replace("(bool)0", "false")
           for o in out]
    return dict(zip(names, out))


def ptxas_entries(log: str) -> dict:
    """Per mangled entry: registers, stack frame, spill bytes, static
    shared memory (``-Xptxas -v``)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_functions(text: str) -> dict:
    """Per mangled function: its instructions as (address, text)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(insn: str) -> str:
    toks = insn.split()
    if toks and toks[0].startswith("@"):
        toks = toks[1:]
    return toks[0] if toks else ""


def loops(insns) -> list:
    """Each backward branch as a loop: its span, instruction count and
    memory instructions, largest first."""
    addr_index = {a: i for i, (a, _) in enumerate(insns)}
    found = []
    for i, (a, text) in enumerate(insns):
        if opcode(text).split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        if not m:
            continue
        target = int(m.group(1), 16)
        if target > a or target not in addr_index:
            continue
        body = [opcode(t) for _, t in insns[addr_index[target]:i + 1]]
        count = lambda pre: sum(1 for o in body if o.startswith(pre))  # noqa: E731
        found.append({
            "from": hex(target), "to": hex(a), "instructions": len(body),
            "LDG": count("LDG"), "LDL": count("LDL"), "STL": count("STL"),
            "LDS": count("LDS"), "STS": count("STS"), "STG": count("STG"),
            "LDGSTS": count("LDGSTS"), "UBLKCP": count("UBLKCP"),
            "SYNCS": count("SYNCS"), "BAR": count("BAR"),
            "IMNMX": count("IMNMX") + count("VIMNMX"), "ISETP": count("ISETP"),
            "SEL": count("SEL"), "LOP3": count("LOP3"), "IADD3": count("IADD3"),
            "IMAD": count("IMAD"), "BRA": count("BRA"), "PLOP3": count("PLOP3"),
        })
    return sorted(found, key=lambda d: -d["instructions"])


def _const(name: str, default: int) -> int:
    """A ``constexpr int`` of ``csrc/quorum.cuh`` (``default`` in a tree
    that lacks it)."""
    with open(os.path.join(_build.SRC_DIR, "quorum.cuh")) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1)) if m else default


def block_of(name: str) -> int:
    """The block size a family launches with (``csrc``'s constants)."""
    m = re.search(r"qs::(\w+)<", name)
    fam = m.group(1) if m else ""
    if fam == "staged_kernel":
        return _const("STAGED_BLOCK", 256)
    if fam == "multiround_kernel":
        return _const("K3_BLOCK", 256)
    return _const("BLOCK", 256)


def lanes_a_row(fam: str) -> int:
    """Threads a row: the device state machine's segment at the main
    path's widths (E = 16, R = 4: 16 lanes) in a tree whose kernel runs
    one (``kv_lane`` in ``csrc/kv_plane.cu``); 1 elsewhere."""
    if fam not in ("kv_plane_kernel", "kv_purge_kernel"):
        return 1
    with open(os.path.join(_build.SRC_DIR, "kv_plane.cu")) as f:
        return 16 if "kv_lane(" in f.read() else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(_build.BUILD_DIR, "sass"))
    ap.add_argument("--match", nargs="*", default=list(DEFAULT_MATCH))
    args = ap.parse_args(argv)
    path = _build.build()
    log = _build.build_info.get("log")
    if log is None:
        with open(path + ".log") as f:
            log = f.read()
    entries = ptxas_entries(log)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = {}
    if os.path.exists(tool):
        res = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=600)
        sass = sass_functions(res.stdout)
    else:
        print(json.dumps({"cuobjdump": "not found"}), flush=True)
    names = demangle(sorted(set(entries) | set(sass)))
    lib = _build.bind(path)
    os.makedirs(args.out, exist_ok=True)
    for mangled, pretty in sorted(names.items(), key=lambda kv: kv[1]):
        if not any(m in pretty for m in args.match):
            continue
        info = entries.get(mangled, {})
        short = pretty.split("(")[0]
        slab = _slab(lib, short)
        block = slab[0] if slab else block_of(short)
        fam = re.search(r"qs::(\w+)[<(]", short + "(")
        fam = fam.group(1) if fam else ""
        rows = SHAPES.get(fam, (100_000,))[0] * lanes_a_row(fam)
        if (short.startswith("void qs::multiround_kernel")
                or short.startswith("void qs::dense_kernel")) and short.endswith("true>"):
            rows = 65_536  # the READS instances run at rung 4's width
        dyn = slab[1] if slab else _dyn_smem(short)
        line = {"instance": short, "block": block, **info, "dyn_smem": dyn}
        if "registers" in info:
            bps = blocks_per_sm(info["registers"], block, info.get("smem", 0) + dyn)
            grid = -(-rows // block)
            line.update(rows=rows, blocks_per_sm=bps,
                        waves=round(grid / (bps * SMS), 3) if bps else None)
        insns = sass.get(mangled)
        if insns:
            ops = [opcode(t).split(".")[0] for _, t in insns]
            line.update(sass_instructions=len(insns), loops=loops(insns)[:4],
                        memory_ops={o: ops.count(o) for o in MEMORY_OPS})
            fname = re.sub(r"[^\w]+", "_", short)[:120] + ".sass"
            with open(os.path.join(args.out, fname), "w") as f:
                f.write("\n".join(f"/*{a:04x}*/ {t}" for a, t in insns) + "\n")
        print(json.dumps(line), flush=True)
    return 0


def _dyn_smem(short: str) -> int:
    """Dynamic shared memory a block of ``short`` asks for at the main
    path's shape (S = 4 read slots): K3's ring of round inputs, by the
    layout of ``csrc/quorum.cuh`` (``k3_layout``), in a tree that has it;
    0 elsewhere."""
    m = re.search(r"qs::multiround_kernel<(\d+), (\w+), (\w+), (\w+), (\w+), (\w+)>", short)
    with open(os.path.join(_build.SRC_DIR, "quorum.cuh")) as f:
        slots = re.search(r"constexpr int K3_SLOTS = K3_AHEAD \+ (\d+);", f.read())
    ahead = _const("K3_AHEAD", 0)
    if not (m and slots and ahead):
        return 0
    p, votes, churn, reads = int(m.group(1)), m.group(3) == "true", m.group(4) == "true", \
        m.group(6) == "true"
    s = 4 if reads else 0
    cover = lambda n: (n + 6) // 4  # noqa: E731
    words = p + churn + (cover(p) if votes else 0) + (2 * s + cover(s * p) if reads else 0)
    return (ahead + int(slots.group(1))) * words * _const("K3_BLOCK", 256) * 4


def _slab(lib, short: str):
    """K1's or K2's row pass at P = 5, S = 4: the rows a block stages and
    the shared memory its slabs take, as the launcher lays them out
    (``qs_slab_layout``); None for another kernel or a tree without it."""
    dense = re.search(r"qs::dense_kernel<\d+, \w+, (\w+), (\w+), (\w+)>", short)
    sparse = re.search(r"qs::sparse_rows_kernel<\d+, \w+, \w+, (\w+)>", short)
    if not (dense or sparse) or not hasattr(lib, "qs_slab_layout"):
        return None
    on = [g == "true" for g in (dense or sparse).groups()]
    if dense:
        flags = tk._bits(False, False, on[0], has_hier=on[1], has_reads=on[2])
    else:
        flags = tk._bits(False, False, False, has_hier=on[0])
    out = (ctypes.c_int * 3)()
    rows = lib.qs_slab_layout(1 if dense else 0, 5, 4, flags, out)
    return rows, out[2]


if __name__ == "__main__":
    sys.exit(main())
