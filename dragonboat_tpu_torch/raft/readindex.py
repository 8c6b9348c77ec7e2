"""ReadIndex protocol state (raft thesis §6.4, batched).

Counterpart: ``dragonboat_tpu/raft/readindex.py``, copied.

Reference: ``internal/raft/readindex.go`` — pending reads keyed by a 128-bit
``SystemCtx``, confirmed by quorum counting of heartbeat responses carrying
the ctx as a hint.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set

from ..wire import SystemCtx


@dataclass(slots=True)
class ReadStatus:
    index: int = 0
    from_: int = 0
    ctx: SystemCtx = field(default_factory=SystemCtx)
    confirmed: Set[int] = field(default_factory=set)


class ReadIndex:
    __slots__ = ("pending", "queue")

    def __init__(self) -> None:
        self.pending: Dict[SystemCtx, ReadStatus] = {}
        self.queue: List[SystemCtx] = []

    def add_request(self, index: int, ctx: SystemCtx, from_: int) -> None:
        # reference readindex.go:43-68
        if ctx in self.pending:
            return
        if self.queue:
            p = self.pending.get(self.peep_ctx())
            if p is None:
                raise RuntimeError("inconsistent pending and queue")
            if index < p.index:
                raise RuntimeError(
                    f"index moved backward in readIndex, {index}:{p.index}"
                )
        self.queue.append(ctx)
        self.pending[ctx] = ReadStatus(index=index, from_=from_, ctx=ctx)

    def has_pending_request(self) -> bool:
        return len(self.queue) > 0

    def peep_ctx(self) -> SystemCtx:
        return self.queue[-1]

    def confirm(
        self, ctx: SystemCtx, from_: int, quorum: int
    ) -> List[ReadStatus]:
        # reference readindex.go:77-116: a confirmation of ctx releases it and
        # every request queued before it, all rewritten to ctx's index.
        p = self.pending.get(ctx)
        if p is None:
            return []
        p.confirmed.add(from_)
        if len(p.confirmed) + 1 < quorum:
            return []
        return self.release(ctx)

    def release(self, ctx: SystemCtx) -> List[ReadStatus]:
        """The queue-pop half of :meth:`confirm`: release ``ctx`` and every
        request queued before it, all rewritten to ``ctx``'s index.  The
        quorum counting is the caller's — the scalar echo tally above, or
        the device ``read_confirm`` kernel whose confirmed-slot egress the
        coordinator routes back here (``coordinator.py``); either way the
        released statuses and their indices are identical."""
        if ctx not in self.pending:
            return []
        done = 0
        cs: List[ReadStatus] = []
        for pctx in self.queue:
            done += 1
            s = self.pending.get(pctx)
            if s is None:
                raise RuntimeError("inconsistent pending and queue content")
            cs.append(s)
            if pctx == ctx:
                for v in cs:
                    if v.index > s.index:
                        raise RuntimeError("v.index > s.index is unexpected")
                    v.index = s.index
                self.queue = self.queue[done:]
                for v in cs:
                    del self.pending[v.ctx]
                if len(self.queue) != len(self.pending):
                    raise RuntimeError("inconsistent length")
                return cs
        return []
