"""In-memory ILogDB used by conformance tests and single-process benches.

Counterpart: ``dragonboat_tpu/raft/memlogdb.py``, copied.

Plays the role of the reference's etcd-test ``TestLogDB`` helper
(``internal/raft/logdb_etcd_test.go``): a plain list-backed log with state,
snapshot and compaction — the minimal persistent-view contract the raft core
needs (reference ``internal/raft/logentry.go:45-75``).  The backing layout
mirrors etcd's MemoryStorage: ``_ents[0]`` is a dummy marker entry carrying
the term of the compacted prefix boundary.
"""
from __future__ import annotations

from typing import List, Tuple

from ..wire import Entry, Membership, Snapshot, State
from .log import CompactedError, UnavailableError


class InMemLogDB:
    """Array-backed ILogDB implementation."""

    __slots__ = (
        "_ents",
        "marker",
        "state",
        "membership",
        "snapshot_record",
        "max_index",
    )

    def __init__(self) -> None:
        self._ents: List[Entry] = [Entry(index=0, term=0)]
        self.marker = 0
        self.state = State()
        self.membership = Membership()
        self.snapshot_record = Snapshot()
        self.max_index = 0

    def get_range(self) -> Tuple[int, int]:
        return self.marker + 1, self.max_index

    def set_range(self, index: int, length: int) -> None:
        if length == 0:
            return
        end = index + length - 1
        if end > self.max_index:
            self.max_index = end

    def node_state(self) -> Tuple[State, Membership]:
        return self.state, self.membership

    def set_state(self, ps: State) -> None:
        self.state = ps

    def create_snapshot(self, ss: Snapshot) -> None:
        self.snapshot_record = ss

    def apply_snapshot(self, ss: Snapshot) -> None:
        self.snapshot_record = ss
        self.membership = ss.membership
        self.marker = ss.index
        self._ents = [Entry(index=ss.index, term=ss.term)]
        self.max_index = ss.index

    def term(self, index: int) -> int:
        if index < self.marker:
            raise CompactedError()
        if index > self.max_index:
            raise UnavailableError()
        return self._ents[index - self.marker].term

    def entries(self, low: int, high: int, max_size: int) -> List[Entry]:
        if low <= self.marker:
            raise CompactedError()
        if high > self.max_index + 1:
            raise UnavailableError()
        ents = self._ents[low - self.marker : high - self.marker]
        out: List[Entry] = []
        size = 0
        for e in ents:
            size += e.size()
            if out and size > max_size:
                break
            out.append(e)
        return out

    def snapshot(self) -> Snapshot:
        return self.snapshot_record

    def compact(self, index: int) -> None:
        if index <= self.marker:
            raise CompactedError()
        if index > self.max_index:
            raise UnavailableError()
        self._ents = self._ents[index - self.marker :]
        self.marker = index

    def append(self, entries: List[Entry]) -> None:
        if not entries:
            return
        ents = [e for e in entries if e.index > self.marker]
        if not ents:
            return
        first = ents[0].index
        if first > self.marker + len(self._ents):
            raise RuntimeError(
                f"hole in log: marker {self.marker}, have {len(self._ents)}, "
                f"appending {first}"
            )
        self._ents = self._ents[: first - self.marker] + list(ents)
        self.max_index = max(self.max_index, self._ents[-1].index)


TestLogDB = InMemLogDB
