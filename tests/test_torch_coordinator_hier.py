"""The coordinator differential of ``tests/test_torch_coordinator.py``
with the hier commit rule on a third of the rows: the port's
``QuorumCoordinator`` and the reference's ``TpuQuorumCoordinator`` driven
by one seeded script, equal after every ``flush()`` with tolerance 0.
The hier half runs in a file of its own so that each file's reference
compiles stay inside its time budget."""
from __future__ import annotations

import pytest
import torch

pytest.importorskip("jax")

from tests.test_torch_coordinator import differential  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("telem", [False, True], ids=["notelem", "telem"])
@pytest.mark.parametrize("drive_reads", [False, True], ids=["noreads", "reads"])
@pytest.mark.parametrize("drive_ticks", [False, True], ids=["noticks", "ticks"])
def test_coordinator_differential_hier(drive_ticks, drive_reads, telem):
    differential(drive_ticks, drive_reads, telem, hier=True)
