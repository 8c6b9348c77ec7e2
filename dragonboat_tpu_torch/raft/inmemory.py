"""In-memory log cache holding not-yet-saved / not-yet-applied entries.

Counterpart: ``dragonboat_tpu/raft/inmemory.py``, copied.

Reference: ``internal/raft/inmemory.go`` — a two-stage in-memory store with a
``marker_index`` separating the LogDB-backed body from the in-memory tail,
``saved_to`` tracking persistence progress, GC on apply, and snapshot staging.
Python lists make the slice bookkeeping simpler than Go's capacity management;
the resize/shrunk machinery of the reference exists to fight Go allocator
behavior and is intentionally not replicated.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..wire import Entry, Snapshot, UpdateCommit
from .rate import InMemRateLimiter


def check_entries_to_append(ents: List[Entry], to_append: List[Entry]) -> None:
    if len(ents) == 0 or len(to_append) == 0:
        return
    last = ents[-1]
    first = to_append[0]
    if last.index + 1 != first.index:
        raise RuntimeError(
            f"found a hole in entries, last {last.index}, first new {first.index}"
        )
    if last.term > first.term:
        raise RuntimeError(
            f"term regression, last {last.term}, first new {first.term}"
        )


def entries_mem_size(entries: List[Entry]) -> int:
    return sum(e.size() for e in entries)


class InMemory:
    """Reference ``inmemory.go:30-47``."""

    __slots__ = (
        "snapshot",
        "entries",
        "marker_index",
        "applied_to_index",
        "applied_to_term",
        "saved_to",
        "rl",
    )

    def __init__(self, last_index: int, rl: Optional[InMemRateLimiter] = None):
        self.snapshot: Optional[Snapshot] = None
        self.entries: List[Entry] = []
        self.marker_index = last_index + 1
        self.applied_to_index = 0
        self.applied_to_term = 0
        self.saved_to = last_index
        self.rl = rl

    def _check_marker(self) -> None:
        if self.entries and self.entries[0].index != self.marker_index:
            raise RuntimeError(
                f"marker index {self.marker_index}, "
                f"first index {self.entries[0].index}"
            )

    def get_entries(self, low: int, high: int) -> List[Entry]:
        upper = self.marker_index + len(self.entries)
        if low > high or low < self.marker_index:
            raise RuntimeError(
                f"invalid low {low}, high {high}, marker {self.marker_index}"
            )
        if high > upper:
            raise RuntimeError(f"invalid high {high}, upperBound {upper}")
        return self.entries[low - self.marker_index : high - self.marker_index]

    def get_snapshot_index(self) -> Tuple[int, bool]:
        if self.snapshot is not None:
            return self.snapshot.index, True
        return 0, False

    def get_last_index(self) -> Tuple[int, bool]:
        if self.entries:
            return self.entries[-1].index, True
        return self.get_snapshot_index()

    def get_term(self, index: int) -> Tuple[int, bool]:
        # reference inmemory.go:86-105
        if index > 0 and index == self.applied_to_index:
            if self.applied_to_term == 0:
                raise RuntimeError(f"applied_to_term == 0, index {index}")
            return self.applied_to_term, True
        if index < self.marker_index:
            idx, ok = self.get_snapshot_index()
            if ok and idx == index:
                return self.snapshot.term, True
            return 0, False
        last, ok = self.get_last_index()
        if ok and index <= last:
            return self.entries[index - self.marker_index].term, True
        return 0, False

    def commit_update(self, cu: UpdateCommit) -> None:
        if cu.stable_log_to > 0:
            self.saved_log_to(cu.stable_log_to, cu.stable_log_term)
        if cu.stable_snapshot_to > 0:
            self.saved_snapshot_to(cu.stable_snapshot_to)

    def entries_to_save(self) -> List[Entry]:
        idx = self.saved_to + 1
        if idx - self.marker_index > len(self.entries):
            return []
        return self.entries[idx - self.marker_index :]

    def saved_log_to(self, index: int, term: int) -> None:
        # reference inmemory.go:125-138
        if index < self.marker_index:
            return
        if not self.entries:
            return
        if (
            index > self.entries[-1].index
            or term != self.entries[index - self.marker_index].term
        ):
            return
        self.saved_to = index

    def applied_log_to(self, index: int) -> None:
        # reference inmemory.go:140-166: GC applied prefix
        if index < self.marker_index:
            return
        if not self.entries:
            return
        if index > self.entries[-1].index:
            return
        last_applied = self.entries[index - self.marker_index]
        if last_applied.index != index:
            raise RuntimeError("last_applied.index != index")
        self.applied_to_index = last_applied.index
        self.applied_to_term = last_applied.term
        new_marker = index + 1
        applied = self.entries[: new_marker - self.marker_index]
        self.entries = self.entries[new_marker - self.marker_index :]
        self.marker_index = new_marker
        self._check_marker()
        if self._rate_limited():
            self.rl.decrease(entries_mem_size(applied))

    def saved_snapshot_to(self, index: int) -> None:
        idx, ok = self.get_snapshot_index()
        if ok and idx == index:
            self.snapshot = None

    def merge(self, ents: List[Entry]) -> None:
        # reference inmemory.go:197-227
        if not ents:
            return
        first_new = ents[0].index
        tail_index = self.marker_index + len(self.entries)
        if first_new == tail_index:
            check_entries_to_append(self.entries, ents)
            self.entries.extend(ents)
            if self._rate_limited():
                self.rl.increase(entries_mem_size(ents))
        elif first_new <= self.marker_index:
            self.marker_index = first_new
            self.entries = list(ents)
            self.saved_to = first_new - 1
            if self._rate_limited():
                self.rl.set(entries_mem_size(ents))
        else:
            existing = self.get_entries(self.marker_index, first_new)
            check_entries_to_append(existing, ents)
            self.entries = list(existing) + list(ents)
            self.saved_to = min(self.saved_to, first_new - 1)
            if self._rate_limited():
                self.rl.set(
                    entries_mem_size(ents) + entries_mem_size(existing)
                )
        self._check_marker()

    def restore(self, ss: Snapshot) -> None:
        self.snapshot = ss
        self.marker_index = ss.index + 1
        self.applied_to_index = ss.index
        self.applied_to_term = ss.term
        self.entries = []
        self.saved_to = ss.index
        if self._rate_limited():
            self.rl.set(0)

    def _rate_limited(self) -> bool:
        return self.rl is not None and self.rl.enabled()
