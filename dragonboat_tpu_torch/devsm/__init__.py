"""Device-resident replicated KV state machine: the host half.

Counterpart: ``dragonboat_tpu/devsm/``.  Committed entries carry
``(key_slot, value)`` SET ops, staged into the engine's per-group entry
buffers at append time; the device state machine kernel
(``csrc/kv_plane.cu``) writes them into the ``(G, slots)`` value tensors
the moment the commit watermark passes their index.

Pieces:

- :mod:`codec` — the fixed-width op wire format (8 bytes: int32 key
  slot + int32 value, little-endian);
- :mod:`machine` — :class:`DeviceKVStateMachine`, the user-facing SM:
  a normal ``IStateMachine`` whose host shadow stays warm on every
  replica, and whose ``lookup`` routes through the device plane when its
  group is device-bound;
- :mod:`plane` — :class:`DevKVPlane`, the coordinator-side manager:
  leadership-scoped binding, entry-op staging from
  ``raft.append_entries``, and the KV read service that resolves lookups
  from the dispatch's capture egress.
"""
from .codec import OP_WIDTH, decode_op, encode_op  # noqa: F401
from .machine import DeviceKVStateMachine  # noqa: F401
from .plane import DevKVPlane  # noqa: F401
