"""Two-tier raft entry log: in-memory tail over a persistent body.

Counterpart: ``dragonboat_tpu/raft/log.py``, copied.

Reference: ``internal/raft/logentry.go`` — ``entryLog`` with ``committed`` /
``processed`` watermarks, conflict detection, the ``upToDate`` election check
and the term-guarded ``tryCommit``.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Tuple

from ..settings import Soft
from ..wire import Entry, Membership, Snapshot, State, UpdateCommit
from .inmemory import InMemory, check_entries_to_append
from .rate import InMemRateLimiter


class CompactedError(Exception):
    """Requested entries no longer in the LogDB due to compaction
    (reference ``logentry.go`` ``ErrCompacted``)."""


class UnavailableError(Exception):
    """Requested entries not available in LogDB
    (reference ``logentry.go`` ``ErrUnavailable``)."""


class SnapshotOutOfDateError(Exception):
    """Reference ``ErrSnapshotOutOfDate``."""


class ILogDB(Protocol):
    """Read view of persistent storage used by the raft core
    (reference ``logentry.go:45-75``)."""

    def get_range(self) -> Tuple[int, int]: ...

    def set_range(self, index: int, length: int) -> None: ...

    def node_state(self) -> Tuple[State, Membership]: ...

    def set_state(self, ps: State) -> None: ...

    def create_snapshot(self, ss: Snapshot) -> None: ...

    def apply_snapshot(self, ss: Snapshot) -> None: ...

    def term(self, index: int) -> int: ...  # raises Compacted/Unavailable

    def entries(self, low: int, high: int, max_size: int) -> List[Entry]: ...

    def snapshot(self) -> Snapshot: ...

    def compact(self, index: int) -> None: ...

    def append(self, entries: List[Entry]) -> None: ...


def limit_entry_size(entries: List[Entry], max_size: int) -> List[Entry]:
    if not entries:
        return entries
    size = entries[0].size()
    limit = 1
    while limit < len(entries):
        size += entries[limit].size()
        if size > max_size:
            break
        limit += 1
    return entries[:limit]


class EntryLog:
    """Reference ``logentry.go:78-399``."""

    __slots__ = ("logdb", "inmem", "committed", "processed")

    def __init__(self, logdb: ILogDB, rl: Optional[InMemRateLimiter] = None):
        first_index, last_index = logdb.get_range()
        self.logdb = logdb
        self.inmem = InMemory(last_index, rl)
        self.committed = first_index - 1
        self.processed = first_index - 1

    def first_index(self) -> int:
        index, ok = self.inmem.get_snapshot_index()
        if ok:
            return index + 1
        index, _ = self.logdb.get_range()
        return index

    def last_index(self) -> int:
        index, ok = self.inmem.get_last_index()
        if ok:
            return index
        _, index = self.logdb.get_range()
        return index

    def _term_entry_range(self) -> Tuple[int, int]:
        return self.first_index() - 1, self.last_index()

    def _entry_range(self) -> Tuple[int, int, bool]:
        if self.inmem.snapshot is not None and not self.inmem.entries:
            return 0, 0, False
        return self.first_index(), self.last_index(), True

    def last_term(self) -> int:
        return self.term(self.last_index())

    def term(self, index: int) -> int:
        """Raises CompactedError/UnavailableError like the reference's
        ``(uint64, error)`` return."""
        first, last = self._term_entry_range()
        if index < first or index > last:
            return 0
        t, ok = self.inmem.get_term(index)
        if ok:
            return t
        return self.logdb.term(index)

    def _check_bound(self, low: int, high: int) -> None:
        if low > high:
            raise RuntimeError(f"input low {low} > high {high}")
        first, last, ok = self._entry_range()
        if not ok or low < first:
            raise CompactedError()
        if high > last + 1:
            raise RuntimeError(
                f"range [{low},{high}) out of bound [{first},{last}]"
            )

    def get_uncommitted_entries(self) -> List[Entry]:
        last = self.inmem.marker_index + len(self.inmem.entries)
        return self._get_entries_from_inmem([], self.committed + 1, last)

    def _get_entries_from_logdb(
        self, low: int, high: int, max_size: int
    ) -> Tuple[List[Entry], bool]:
        if low >= self.inmem.marker_index:
            return [], True
        upper = min(high, self.inmem.marker_index)
        ents = self.logdb.entries(low, upper, max_size)
        if len(ents) > upper - low:
            raise RuntimeError("len(ents) > upper-low")
        return ents, len(ents) == upper - low

    def _get_entries_from_inmem(
        self, ents: List[Entry], low: int, high: int
    ) -> List[Entry]:
        if high <= self.inmem.marker_index:
            return ents
        lower = max(low, self.inmem.marker_index)
        inmem = self.inmem.get_entries(lower, high)
        if inmem:
            if ents:
                check_entries_to_append(ents, inmem)
                return list(ents) + list(inmem)
            return list(inmem)
        return ents

    def get_entries(self, low: int, high: int, max_size: int) -> List[Entry]:
        self._check_bound(low, high)
        if low == high:
            return []
        ents, check_inmem = self._get_entries_from_logdb(low, high, max_size)
        if not check_inmem:
            return ents
        return limit_entry_size(
            self._get_entries_from_inmem(ents, low, high), max_size
        )

    def entries(self, start: int, max_size: int) -> List[Entry]:
        if start > self.last_index():
            return []
        return self.get_entries(start, self.last_index() + 1, max_size)

    def snapshot(self) -> Snapshot:
        if self.inmem.snapshot is not None:
            return self.inmem.snapshot
        return self.logdb.snapshot()

    def first_not_applied_index(self) -> int:
        return max(self.processed + 1, self.first_index())

    def to_apply_index_limit(self) -> int:
        return self.committed + 1

    def has_entries_to_apply(self) -> bool:
        return self.to_apply_index_limit() > self.first_not_applied_index()

    def has_more_entries_to_apply(self, applied_to: int) -> bool:
        return self.committed > applied_to

    def entries_to_apply(self) -> List[Entry]:
        return self.get_entries_to_apply(Soft.max_entry_size)

    def get_entries_to_apply(self, limit: int) -> List[Entry]:
        if self.has_entries_to_apply():
            return self.get_entries(
                self.first_not_applied_index(), self.to_apply_index_limit(), limit
            )
        return []

    def entries_to_save(self) -> List[Entry]:
        return self.inmem.entries_to_save()

    def try_append(self, index: int, ents: List[Entry]) -> bool:
        # reference logentry.go:290-302
        conflict = self.get_conflict_index(ents)
        if conflict != 0:
            if conflict <= self.committed:
                raise RuntimeError(
                    f"entry {conflict} conflicts with committed entry "
                    f"{self.committed}"
                )
            self.append(ents[conflict - index - 1 :])
            return True
        return False

    def append(self, entries: List[Entry]) -> None:
        if not entries:
            return
        if entries[0].index <= self.committed:
            raise RuntimeError(
                f"committed entries being changed, committed {self.committed}, "
                f"first {entries[0].index}"
            )
        self.inmem.merge(entries)

    def get_conflict_index(self, entries: List[Entry]) -> int:
        for e in entries:
            if not self.match_term(e.index, e.term):
                return e.index
        return 0

    def commit_to(self, index: int) -> None:
        if index <= self.committed:
            return
        if index > self.last_index():
            raise RuntimeError(
                f"invalid commit_to index {index}, last_index {self.last_index()}"
            )
        self.committed = index

    def commit_update(self, cu: UpdateCommit) -> None:
        # reference logentry.go:334-360
        self.inmem.commit_update(cu)
        if cu.processed > 0:
            if cu.processed < self.processed or cu.processed > self.committed:
                raise RuntimeError(
                    f"invalid processed {cu.processed}, "
                    f"current {self.processed}, committed {self.committed}"
                )
            self.processed = cu.processed
        if cu.last_applied > 0:
            if cu.last_applied > self.committed or cu.last_applied > self.processed:
                raise RuntimeError(
                    f"invalid last_applied {cu.last_applied}, "
                    f"committed {self.committed}, processed {self.processed}"
                )
            self.inmem.applied_log_to(cu.last_applied)

    def match_term(self, index: int, term: int) -> bool:
        try:
            lt = self.term(index)
        except (CompactedError, UnavailableError):
            return False
        return lt == term

    def up_to_date(self, index: int, term: int) -> bool:
        # reference logentry.go:364-376 (raft paper §5.4.1)
        last_term = self.term(self.last_index())
        if term >= last_term:
            if term > last_term:
                return True
            return index >= self.last_index()
        return False

    def try_commit(self, index: int, term: int) -> bool:
        # reference logentry.go:378-392
        if index <= self.committed:
            return False
        try:
            lterm = self.term(index)
        except CompactedError:
            lterm = 0
        if index > self.committed and lterm == term:
            self.commit_to(index)
            return True
        return False

    def restore(self, ss: Snapshot) -> None:
        self.inmem.restore(ss)
        self.committed = ss.index
        self.processed = ss.index
