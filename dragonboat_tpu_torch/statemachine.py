"""User state machine interfaces the device KV state machine implements.

Counterpart: ``dragonboat_tpu/statemachine.py``; only ``IStateMachine``,
``Result`` and ``SnapshotFile``, which ``devsm/machine.py`` imports, are
copied so far (reference ``statemachine/rsm.go``).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import BinaryIO, List


@dataclass(slots=True)
class Result:
    """Outcome of an update (reference ``statemachine/rsm.go`` ``Result``)."""

    value: int = 0
    data: bytes = b""

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Result)
            and self.value == other.value
            and self.data == other.data
        )


@dataclass(slots=True)
class SnapshotFile:
    """An external file restored with a snapshot (reference
    ``statemachine/rsm.go`` ``SnapshotFile``)."""

    file_id: int = 0
    filepath: str = ""
    metadata: bytes = b""


class IStateMachine(abc.ABC):
    """The regular (in-memory, serialized-access) SM
    (reference ``statemachine/rsm.go:184``)."""

    @abc.abstractmethod
    def update(self, cmd: bytes) -> Result: ...

    @abc.abstractmethod
    def lookup(self, query: object) -> object: ...

    @abc.abstractmethod
    def save_snapshot(
        self,
        w: BinaryIO,
        files: "SnapshotFileCollection",
        done: "StopChecker",
    ) -> None: ...

    @abc.abstractmethod
    def recover_from_snapshot(
        self,
        r: BinaryIO,
        files: List[SnapshotFile],
        done: "StopChecker",
    ) -> None: ...

    def close(self) -> None:
        pass
