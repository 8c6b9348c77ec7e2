"""Batched quorum engine on PyTorch (counterpart: ``dragonboat_tpu.ops``).

Modules:

* :mod:`.state`   — the ``QuorumState`` layout, ``HostMirror`` and the
  numpy carry-across (``state_from_numpy`` / ``state_to_numpy``)
* :mod:`.kernels` — plain PyTorch versions and the CUDA kernel wrappers
  (``quorum_step``, ``quorum_step_dense``, ``quorum_multiround``,
  ``quorum_multistep``, ``quorum_multistep_dense``, ``staged_multistep``)
* :mod:`.engine`  — ``BatchedQuorumEngine``, the host side of the engine
* :mod:`._build`  — builds and binds ``csrc/`` at first use
"""

from .state import (  # noqa: F401
    INDEX_MIN,
    HostMirror,
    QuorumState,
    make_state,
    state_from_numpy,
    state_layout,
    state_to_numpy,
)
from .kernels import (  # noqa: F401
    check_quorum,
    commit_quorum,
    launch_counts,
    quorum_multiround,
    quorum_multistep,
    quorum_multistep_dense,
    quorum_step,
    quorum_step_dense,
    reset_launch_counts,
    tick_step,
    vote_tally,
)
from .engine import BatchedQuorumEngine  # noqa: F401
