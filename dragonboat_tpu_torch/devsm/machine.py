"""The user-facing device KV state machine.

Counterpart: ``dragonboat_tpu/devsm/machine.py``, copied.

:class:`DeviceKVStateMachine` is a complete ``IStateMachine``: without
the device plane (``Config.device_kv`` off, scalar engine, follower
replicas) it is just a small fixed-width KV store over a numpy shadow —
that shadow is also the differential ORACLE ``tests/test_devsm.py`` pins
the device fold against.  With the plane bound (the device engine +
device_kv + this host leading the group), ``lookup`` serves from the HBM-resident
device state via the fused dispatch's capture egress, and the host
shadow stays warm in the background (single numpy cell writes) so
snapshots, failover and rebinding never need a device pull.
"""
from __future__ import annotations

from typing import BinaryIO, List

import numpy as np

from ..ops.state import KV_SLOTS
from ..statemachine import IStateMachine, Result, SnapshotFile
from .codec import decode_op

_MAGIC = b"DKV1"


class DeviceKVStateMachine(IStateMachine):
    """Fixed-width replicated KV: ``kv_slots`` int32 value cells,
    commands are :func:`devsm.codec.encode_op` SETs, lookups take an int
    key slot and return the int value.

    Registration: pass the class (or a factory returning instances) to
    ``NodeHost.start_cluster`` with ``Config.device_kv=True`` on the
    device engine — the NodeHost registers the group with the
    coordinator's :class:`~.plane.DevKVPlane` and the apply stage
    moves into the fused program.  Without the flag the same class runs
    as an ordinary host SM (the default-OFF contract).
    """

    #: registration marker the NodeHost checks (duck-typed so wrappers
    #: and factories can carry it without subclassing)
    device_kv = True
    #: the numpy-shadow half is process-spawnable: when the
    #: group runs WITHOUT ``Config.device_kv`` (plain host SM) and
    #: ``host_workers > 0``, the hostproc apply tier may host it — the
    #: NodeHost never proxies a device-BOUND machine (the devsm plane IS
    #: its apply offload)
    __hostproc_spawnable__ = True
    #: value slots; must fit the engine's ``n_kv_slots`` width
    kv_slots = KV_SLOTS

    def __init__(self, cluster_id: int, node_id: int):
        self.cluster_id = cluster_id
        self.node_id = node_id
        self.values = np.zeros(self.kv_slots, dtype=np.int64)
        # wired by DevKVPlane.register (NodeHost start_cluster); None =
        # pure host SM, every path below short-circuits on it
        self._plane = None

    # ------------------------------------------------------------------
    # IStateMachine
    # ------------------------------------------------------------------

    def update(self, cmd: bytes) -> Result:
        """Apply one SET to the host shadow.  Runs on EVERY replica —
        including a device-bound leader, where it is a single numpy cell
        write off the read path: the shadow is what makes leadership
        transitions, snapshots and the devsm-off oracle trivially
        correct.  Commands that don't parse (or point outside the slot
        range) are no-ops on both planes, so shadow and device state can
        never diverge over one."""
        op = decode_op(cmd)
        if op is None:
            return Result(value=0)
        key, value = op
        if not (0 <= key < self.kv_slots):
            return Result(value=0)
        self.values[key] = value
        return Result(value=value & 0xFFFFFFFF)

    def lookup(self, query: object) -> object:
        """Value of key slot ``query``.  Device-bound groups serve from
        device state (a staged KV read captured by the next fused
        dispatch — zero host apply on the path); otherwise the host
        shadow answers, gated by the plane so a device-released read
        never outruns the shadow."""
        key = int(query)
        if not (0 <= key < self.kv_slots):
            raise KeyError(f"kv key slot {key} out of range")
        plane = self._plane
        if plane is not None:
            return plane.lookup(self.cluster_id, key, self)
        return int(self.values[key])

    def save_snapshot(self, w: BinaryIO, files, done) -> None:
        w.write(_MAGIC)
        w.write(np.int64(self.kv_slots).tobytes())
        w.write(self.values.astype("<i8").tobytes())

    def recover_from_snapshot(
        self, r: BinaryIO, files: List[SnapshotFile], done
    ) -> None:
        magic = r.read(4)
        if magic != _MAGIC:
            raise ValueError(f"bad devsm snapshot magic {magic!r}")
        hdr = r.read(8)
        if len(hdr) != 8:
            raise ValueError("truncated devsm snapshot header")
        n = int(np.frombuffer(hdr, dtype="<i8")[0])
        # validate the width BEFORE the body read (a corrupt header must
        # not drive a giant allocation) and the body length BEFORE any
        # mutation (a truncated body must not leave a half-wiped SM)
        if not (0 <= n <= self.kv_slots):
            raise ValueError(
                f"devsm snapshot width {n} outside [0, {self.kv_slots}]"
            )
        body = r.read(8 * n)
        if len(body) != 8 * n:
            raise ValueError("truncated devsm snapshot body")
        vals = np.frombuffer(body, dtype="<i8").astype(np.int64)
        self.values[:] = 0
        self.values[:n] = vals
        plane = self._plane
        if plane is not None:
            plane.on_restore(self.cluster_id)

    def close(self) -> None:
        plane, self._plane = self._plane, None
        if plane is not None:
            plane.unregister(self.cluster_id)
