"""Internal tunables, split Hard/Soft like the reference.

Counterpart: ``dragonboat_tpu/settings.py``, copied.

Reference: ``internal/settings/hard.go`` and ``internal/settings/soft.go``.
Hard settings affect on-disk data formats — changing them on an existing
deployment corrupts data, so a hash over them is persisted and re-checked on
open (reference ``hard.go:124-137``).  Soft settings are runtime tunables
overridable via a JSON file in the CWD (reference ``overwrite.go``).
"""
from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, fields


@dataclass
class HardSettings:
    """Data-format-affecting constants (reference ``hard.go:35-152``)."""

    step_engine_worker_count: int = 16
    logdb_pool_size: int = 16  # LogDB shard count
    lru_max_session_count: int = 4096
    logdb_entry_batch_size: int = 48
    # snapshot file header size in bytes (reference hard.go:99)
    snapshot_header_size: int = 1024

    def hash(self) -> int:
        """Stable hash persisted alongside data dirs to detect incompatible
        setting changes (reference ``hard.go:124-137``)."""
        payload = "|".join(
            f"{f.name}={getattr(self, f.name)}" for f in fields(self)
        ).encode()
        return zlib.crc32(payload)


@dataclass
class SoftSettings:
    """Runtime tunables (reference ``soft.go:17-217``)."""

    # engine
    step_engine_commit_worker_count: int = 16
    step_engine_apply_worker_count: int = 16
    step_engine_snapshot_worker_count: int = 64
    task_queue_target_length: int = 1024
    node_reload_millisecond: int = 200
    # raft
    max_entry_size: int = 2 * 1024 * 1024  # per Replicate msg / apply batch
    in_mem_entry_slice_size: int = 512
    min_entry_slice_free_size: int = 96
    in_mem_gc_timeout: int = 100
    unknown_region_size: int = 10
    # queues
    incoming_proposal_queue_length: int = 2048
    incoming_read_index_queue_length: int = 4096
    received_message_queue_length: int = 1024
    snapshot_status_push_delay_ms: int = 1000
    # transport
    send_queue_length: int = 2048
    max_message_batch_size: int = 64 * 1024 * 1024
    max_snapshot_connections: int = 64
    max_concurrent_streaming_snapshots: int = 128
    snapshot_chunk_size: int = 2 * 1024 * 1024
    snapshot_gc_tick: int = 30
    snapshot_chunk_timeout_tick: int = 900
    get_connected_timeout_second: int = 5
    # logdb
    logdb_compaction_interval_seconds: int = 60
    # nodehost
    sync_op_default_timeout_ms: int = 5000
    pending_proposal_shards: int = 16
    # tick-lite staleness bound: a node with native/device-owned raft
    # clocks and pending requests is woken at least once per this many
    # ticks so pending-request timeout GC runs (lazy tick delivery)
    lazy_tick_sweep_ticks: int = 4
    # batched quorum engine (new, device-specific)
    quorum_engine_max_peers: int = 8
    quorum_engine_block_groups: int = 1024

    # ReadIndex / quiesce
    quiesce_threshold_factor: int = 10


def _load_overrides(path: str, obj) -> None:
    if not os.path.exists(path):
        return
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return
    for k, v in data.items():
        if hasattr(obj, k) and isinstance(v, int):
            setattr(obj, k, v)


Hard = HardSettings()
Soft = SoftSettings()

# JSON override files, same mechanism as the reference's
# dragonboat-{hard,soft}-settings.json (reference overwrite.go, hard.go:50-57)
_load_overrides("dragonboat-tpu-hard-settings.json", Hard)
_load_overrides("dragonboat-tpu-soft-settings.json", Soft)
