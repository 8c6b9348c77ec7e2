"""The port stands alone: it imports neither JAX nor the JAX package, and
it never falls back to the CPU on its own."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dragonboat_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dragonboat_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import dragonboat_tpu_torch, dragonboat_tpu_torch.ops.engine\n"
        "import dragonboat_tpu_torch.ops.kernels, dragonboat_tpu_torch.ops._build\n"
        "import dragonboat_tpu_torch.coordinator, dragonboat_tpu_torch.lease\n"
        "import dragonboat_tpu_torch.statemachine, dragonboat_tpu_torch.raft.hier\n"
        "import dragonboat_tpu_torch.devsm\n"
        "import dragonboat_tpu_torch.settings, dragonboat_tpu_torch.config\n"
        "import dragonboat_tpu_torch.wire, dragonboat_tpu_torch.wire.codec\n"
        "import dragonboat_tpu_torch.raft, dragonboat_tpu_torch.raft.raft\n"
        "import dragonboat_tpu_torch.raft.peer\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dragonboat_tpu'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize(
    "path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_source_imports_jax_or_the_reference_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port
                continue
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        for name in names:
            assert not _forbidden(name), (path, node.lineno, name)


def test_no_device_means_cuda_and_raises_without_it():
    from dragonboat_tpu_torch import pick_device
    from dragonboat_tpu_torch.ops import make_state
    from dragonboat_tpu_torch.ops.engine import BatchedQuorumEngine

    assert pick_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        pick_device("meta")
    if torch.cuda.is_available():
        pytest.skip("CUDA is available, so the default device exists")
    for call in (lambda: pick_device(None), lambda: make_state(4, 3),
                 lambda: BatchedQuorumEngine(4, 3),
                 lambda: BatchedQuorumEngine(4, 3, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
