"""Rate limiters bounding in-memory log growth.

Counterpart: ``dragonboat_tpu/raft/rate.py``, copied.

Reference: ``internal/server/rate.go`` — a byte-count ``RateLimiter`` plus a
follower-aware ``InMemRateLimiter`` that rate-limits proposals based on the
max of the local and any follower's in-memory log size.
"""
from __future__ import annotations

from typing import Dict


class RateLimiter:
    """Byte-count limiter (reference ``rate.go:33-78``)."""

    __slots__ = ("size", "max_size")

    def __init__(self, max_size: int):
        self.size = 0
        self.max_size = max_size

    def enabled(self) -> bool:
        return self.max_size > 0

    def increase(self, sz: int) -> None:
        self.size += sz

    def decrease(self, sz: int) -> None:
        self.size = max(0, self.size - sz)

    def set(self, sz: int) -> None:
        self.size = sz

    def get(self) -> int:
        return self.size

    def rate_limited(self) -> bool:
        return self.enabled() and self.size > self.max_size


class InMemRateLimiter:
    """Follower-aware limiter (reference ``rate.go:81-198``)."""

    __slots__ = ("rl", "follower_sizes", "tick_count", "peers")

    # a follower report is considered stale after this many ticks
    FOLLOWER_GC_TICK = 3

    def __init__(self, max_size: int):
        self.rl = RateLimiter(max_size)
        self.follower_sizes: Dict[int, tuple] = {}
        self.tick_count = 0

    def enabled(self) -> bool:
        return self.rl.enabled()

    def tick(self) -> None:
        self.tick_count += 1

    def get_tick(self) -> int:
        return self.tick_count

    def increase(self, sz: int) -> None:
        self.rl.increase(sz)

    def decrease(self, sz: int) -> None:
        self.rl.decrease(sz)

    def set(self, sz: int) -> None:
        self.rl.set(sz)

    def get(self) -> int:
        return self.rl.get()

    def set_follower_state(self, node_id: int, sz: int) -> None:
        self.follower_sizes[node_id] = (sz, self.tick_count)

    def reset_follower_state(self) -> None:
        self.follower_sizes = {}

    def reset(self) -> None:
        self.rl.set(0)
        self.reset_follower_state()

    def rate_limited(self) -> bool:
        if not self.enabled():
            return False
        if self.rl.rate_limited():
            return True
        for sz, tick in self.follower_sizes.values():
            if self.tick_count - tick <= self.FOLLOWER_GC_TICK:
                if sz > self.rl.max_size:
                    return True
        return False
