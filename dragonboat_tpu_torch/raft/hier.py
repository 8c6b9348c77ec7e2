"""Hierarchical commit geometry: the domain sub-quorum size.

Counterpart: ``dragonboat_tpu/raft/hier.py``; only ``sub_quorum_size``,
which the quorum coordinator calls when it installs a row's hier rule,
is copied so far.
"""
from __future__ import annotations


def sub_quorum_size(n: int) -> int:
    """Majority of an ``n``-voter domain — the sub-quorum cardinality."""
    return n // 2 + 1
