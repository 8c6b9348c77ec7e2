"""Fixed-width devsm op codec.

Counterpart: ``dragonboat_tpu/devsm/codec.py``, copied.

One op = 8 bytes, little-endian: ``int32 key_slot`` + ``int32 value``.
The width is the contract that lets committed entries ride the fused
program as dense ``(G, E)`` int32 tensors — anything that doesn't parse
is a no-op on BOTH the device plane and the host shadow, so the two can
never diverge over a malformed command.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

OP_WIDTH = 8
_OP = struct.Struct("<ii")


def encode_op(key_slot: int, value: int) -> bytes:
    """The proposal payload for ``SET key_slot := value``."""
    return _OP.pack(key_slot, value)


def decode_op(cmd: bytes) -> Optional[Tuple[int, int]]:
    """``(key_slot, value)``, or None when ``cmd`` is not a devsm op
    (wrong width).  Key-slot range is validated by the consumer against
    its configured width — the codec only owns the wire shape."""
    if len(cmd) != OP_WIDTH:
        return None
    return _OP.unpack(cmd)
