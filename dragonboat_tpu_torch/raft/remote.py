"""Per-peer replication progress tracker.

Counterpart: ``dragonboat_tpu/raft/remote.py``, copied.

Reference: ``internal/raft/remote.go`` — the etcd-derived flow-control state
machine with states Retry/Wait/Replicate/Snapshot tracking ``match``/``next``
indexes per remote peer.  The batched quorum engine mirrors exactly this state
as columns of its ``(nGroups, nPeers)`` tensors (state code, match, next),
so the semantics here are the single source of truth for both paths.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class RemoteState(enum.IntEnum):
    # reference remote.go:44-49
    RETRY = 0
    WAIT = 1
    REPLICATE = 2
    SNAPSHOT = 3


@dataclass(slots=True)
class Remote:
    """Progress of one remote peer (reference ``remote.go:62-68``)."""

    match: int = 0
    next: int = 0
    snapshot_index: int = 0
    state: RemoteState = RemoteState.RETRY
    active: bool = False

    def reset_snapshot(self) -> None:
        self.snapshot_index = 0

    def become_retry(self) -> None:
        # reference remote.go:80-88
        if self.state == RemoteState.SNAPSHOT:
            self.next = max(self.match + 1, self.snapshot_index + 1)
        else:
            self.next = self.match + 1
        self.reset_snapshot()
        self.state = RemoteState.RETRY

    def retry_to_wait(self) -> None:
        if self.state == RemoteState.RETRY:
            self.state = RemoteState.WAIT

    def wait_to_retry(self) -> None:
        if self.state == RemoteState.WAIT:
            self.state = RemoteState.RETRY

    def become_wait(self) -> None:
        self.become_retry()
        self.retry_to_wait()

    def become_replicate(self) -> None:
        self.next = self.match + 1
        self.reset_snapshot()
        self.state = RemoteState.REPLICATE

    def become_snapshot(self, index: int) -> None:
        self.reset_snapshot()
        self.snapshot_index = index
        self.state = RemoteState.SNAPSHOT

    def clear_pending_snapshot(self) -> None:
        self.snapshot_index = 0

    def try_update(self, index: int) -> bool:
        # reference remote.go:123-133
        if self.next < index + 1:
            self.next = index + 1
        if self.match < index:
            self.wait_to_retry()
            self.match = index
            return True
        return False

    def progress(self, last_index: int) -> None:
        # reference remote.go:135-143: called when entries were sent out
        if self.state == RemoteState.REPLICATE:
            self.next = last_index + 1
        elif self.state == RemoteState.RETRY:
            self.retry_to_wait()
        else:
            raise RuntimeError("unexpected remote state")

    def responded_to(self) -> None:
        # reference remote.go:145-153
        if self.state == RemoteState.RETRY:
            self.become_replicate()
        elif self.state == RemoteState.SNAPSHOT:
            if self.match >= self.snapshot_index:
                self.become_retry()

    def decrease_to(self, rejected: int, last: int) -> bool:
        # reference remote.go:155-171
        if self.state == RemoteState.REPLICATE:
            if rejected <= self.match:
                return False  # stale
            self.next = self.match + 1
            return True
        if self.next - 1 != rejected:
            return False  # stale
        self.wait_to_retry()
        self.next = max(1, min(rejected, last + 1))
        return True

    def is_paused(self) -> bool:
        return self.state in (RemoteState.WAIT, RemoteState.SNAPSHOT)

    def is_active(self) -> bool:
        return self.active

    def set_active(self) -> None:
        self.active = True

    def set_not_active(self) -> None:
        self.active = False

    def __str__(self) -> str:
        return (
            f"match:{self.match},next:{self.next},"
            f"state:{self.state.name},si:{self.snapshot_index}"
        )
