"""Deterministic binary codec for the wire/state types.

Counterpart: ``dragonboat_tpu/wire/codec.py``, copied.

The reference serializes with gogo-protobuf plus hand-optimized marshal paths
(reference ``raftpb/raft_optimized.go``).  Protobuf is not a requirement of the
system — what matters is (a) determinism (same object → same bytes, required
for cross-replica hashes and for the differential scalar-vs-device tests), (b)
self-describing framing with integrity checks, and (c) speed for the hot
Entry/Message paths.  We use a compact little-endian format with varint field
packing for the hot types and explicit length prefixes; CRC32 integrity lives
one layer up in the transport framing and the snapshot block format, mirroring
the reference's layering (``internal/transport/tcp.go:57-114``,
``internal/rsm/rw.go``).

The reference speeds the hot Entry/Message fields with a CPython
extension that it builds at import; the port keeps the pure-Python path,
which writes and reads the same bytes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

from .types import (
    Bootstrap,
    Chunk,
    ConfigChange,
    ConfigChangeType,
    Entry,
    EntryType,
    Membership,
    Message,
    MessageBatch,
    MessageType,
    Snapshot,
    SnapshotFile,
    State,
    StateMachineType,
)

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")


class CodecError(ValueError):
    pass


def _write_uvarint(buf: bytearray, v: int) -> None:
    if v < 0 or v >= 1 << 64:
        raise CodecError(f"varint out of uint64 range: {v}")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise CodecError("truncated varint")
        b = data[pos]
        pos += 1
        # values are uint64 exactly: a 10th byte may only contribute one
        # bit, and an 11th byte is always invalid (kept identical to the
        # native decoder so the same wire bytes can never decode
        # differently across implementations)
        if shift == 63 and (b & 0x7F) > 1:
            raise CodecError("varint overflows uint64")
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise CodecError("varint too long")


def _write_bytes(buf: bytearray, b: bytes) -> None:
    _write_uvarint(buf, len(b))
    buf += b


def _read_bytes(data: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = _read_uvarint(data, pos)
    if pos + n > len(data):
        raise CodecError("truncated bytes field")
    return data[pos : pos + n], pos + n


def _write_str(buf: bytearray, s: str) -> None:
    _write_bytes(buf, s.encode("utf-8"))


def _read_str(data: bytes, pos: int) -> Tuple[str, int]:
    b, pos = _read_bytes(data, pos)
    return b.decode("utf-8"), pos


# ---------------------------------------------------------------------------
# Entry
# ---------------------------------------------------------------------------

def encode_entry_into(buf: bytearray, e: Entry) -> None:
    # entries are immutable once term/index are assigned (raft
    # append_entries clears the cache when it assigns them), so the wire
    # bytes are computed once and reused across Replicate fan-out + WAL
    enc = e._enc
    if enc is None:
        tmp = bytearray()
        _write_uvarint(tmp, e.term)
        _write_uvarint(tmp, e.index)
        _write_uvarint(tmp, int(e.type))
        _write_uvarint(tmp, e.key)
        _write_uvarint(tmp, e.client_id)
        _write_uvarint(tmp, e.series_id)
        _write_uvarint(tmp, e.responded_to)
        _write_bytes(tmp, e.cmd)
        enc = bytes(tmp)
        e._enc = enc
    buf += enc


def decode_entry_from(data: bytes, pos: int) -> Tuple[Entry, int]:
    start = pos
    term, pos = _read_uvarint(data, pos)
    index, pos = _read_uvarint(data, pos)
    etype, pos = _read_uvarint(data, pos)
    key, pos = _read_uvarint(data, pos)
    client_id, pos = _read_uvarint(data, pos)
    series_id, pos = _read_uvarint(data, pos)
    responded_to, pos = _read_uvarint(data, pos)
    cmd, pos = _read_bytes(data, pos)
    e = Entry(
        term=term,
        index=index,
        type=EntryType(etype),
        key=key,
        client_id=client_id,
        series_id=series_id,
        responded_to=responded_to,
        cmd=cmd,
    )
    # the wire slice IS the canonical encoding — seed the cache so the
    # follower's WAL write doesn't re-encode
    e._enc = data[start:pos]
    return e, pos


def encode_entry(e: Entry) -> bytes:
    buf = bytearray()
    encode_entry_into(buf, e)
    return bytes(buf)


def decode_entry(data: bytes) -> Entry:
    e, pos = decode_entry_from(data, 0)
    if pos != len(data):
        raise CodecError("trailing garbage after Entry")
    return e


def encode_entry_batch(entries: List[Entry]) -> bytes:
    """Encode an entry batch record (reference ``EntryBatch``,
    ``raftpb/raft.proto:118``)."""
    buf = bytearray()
    _write_uvarint(buf, len(entries))
    for e in entries:
        encode_entry_into(buf, e)
    return bytes(buf)


def decode_entry_batch(data: bytes) -> List[Entry]:
    n, pos = _read_uvarint(data, 0)
    out = []
    for _ in range(n):
        e, pos = decode_entry_from(data, pos)
        out.append(e)
    if pos != len(data):
        raise CodecError("trailing garbage after EntryBatch")
    return out


# ---------------------------------------------------------------------------
# State / Membership / Bootstrap / ConfigChange
# ---------------------------------------------------------------------------

def encode_state(st: State) -> bytes:
    return _U64.pack(st.term) + _U64.pack(st.vote) + _U64.pack(st.commit)


def decode_state(data: bytes) -> State:
    if len(data) != 24:
        raise CodecError("bad State record size")
    return State(
        term=_U64.unpack_from(data, 0)[0],
        vote=_U64.unpack_from(data, 8)[0],
        commit=_U64.unpack_from(data, 16)[0],
    )


def _write_addr_map(buf: bytearray, m: Dict[int, str]) -> None:
    _write_uvarint(buf, len(m))
    for k in sorted(m):  # sorted => deterministic bytes
        _write_uvarint(buf, k)
        _write_str(buf, m[k])


def _read_addr_map(data: bytes, pos: int) -> Tuple[Dict[int, str], int]:
    n, pos = _read_uvarint(data, pos)
    out: Dict[int, str] = {}
    for _ in range(n):
        k, pos = _read_uvarint(data, pos)
        v, pos = _read_str(data, pos)
        out[k] = v
    return out, pos


def encode_membership_into(buf: bytearray, m: Membership) -> None:
    _write_uvarint(buf, m.config_change_id)
    _write_addr_map(buf, m.addresses)
    _write_uvarint(buf, len(m.removed))
    for k in sorted(m.removed):
        _write_uvarint(buf, k)
    _write_addr_map(buf, m.observers)
    _write_addr_map(buf, m.witnesses)


def decode_membership_from(data: bytes, pos: int) -> Tuple[Membership, int]:
    ccid, pos = _read_uvarint(data, pos)
    addresses, pos = _read_addr_map(data, pos)
    nremoved, pos = _read_uvarint(data, pos)
    removed: Dict[int, bool] = {}
    for _ in range(nremoved):
        k, pos = _read_uvarint(data, pos)
        removed[k] = True
    observers, pos = _read_addr_map(data, pos)
    witnesses, pos = _read_addr_map(data, pos)
    return (
        Membership(
            config_change_id=ccid,
            addresses=addresses,
            removed=removed,
            observers=observers,
            witnesses=witnesses,
        ),
        pos,
    )


def encode_membership(m: Membership) -> bytes:
    buf = bytearray()
    encode_membership_into(buf, m)
    return bytes(buf)


def decode_membership(data: bytes) -> Membership:
    m, pos = decode_membership_from(data, 0)
    if pos != len(data):
        raise CodecError("trailing garbage after Membership")
    return m


def encode_bootstrap(b: Bootstrap) -> bytes:
    buf = bytearray()
    _write_addr_map(buf, b.addresses)
    buf.append(1 if b.join else 0)
    _write_uvarint(buf, int(b.type))
    return bytes(buf)


def decode_bootstrap(data: bytes) -> Bootstrap:
    addresses, pos = _read_addr_map(data, 0)
    if pos >= len(data):
        raise CodecError("truncated Bootstrap")
    join = data[pos] == 1
    pos += 1
    smtype, pos = _read_uvarint(data, pos)
    if pos != len(data):
        raise CodecError("trailing garbage after Bootstrap")
    return Bootstrap(addresses=addresses, join=join, type=StateMachineType(smtype))


def encode_config_change(cc: ConfigChange) -> bytes:
    buf = bytearray()
    _write_uvarint(buf, cc.config_change_id)
    _write_uvarint(buf, int(cc.type))
    _write_uvarint(buf, cc.node_id)
    _write_str(buf, cc.address)
    buf.append(1 if cc.initialize else 0)
    return bytes(buf)


def decode_config_change(data: bytes) -> ConfigChange:
    ccid, pos = _read_uvarint(data, 0)
    cctype, pos = _read_uvarint(data, pos)
    node_id, pos = _read_uvarint(data, pos)
    address, pos = _read_str(data, pos)
    if pos >= len(data):
        raise CodecError("truncated ConfigChange")
    initialize = data[pos] == 1
    pos += 1
    if pos != len(data):
        raise CodecError("trailing garbage after ConfigChange")
    return ConfigChange(
        config_change_id=ccid,
        type=ConfigChangeType(cctype),
        node_id=node_id,
        address=address,
        initialize=initialize,
    )


# ---------------------------------------------------------------------------
# Snapshot
# ---------------------------------------------------------------------------

def encode_snapshot_file_into(buf: bytearray, f: SnapshotFile) -> None:
    _write_str(buf, f.filepath)
    _write_uvarint(buf, f.file_size)
    _write_uvarint(buf, f.file_id)
    _write_bytes(buf, f.metadata)


def decode_snapshot_file_from(data: bytes, pos: int) -> Tuple[SnapshotFile, int]:
    filepath, pos = _read_str(data, pos)
    file_size, pos = _read_uvarint(data, pos)
    file_id, pos = _read_uvarint(data, pos)
    metadata, pos = _read_bytes(data, pos)
    return (
        SnapshotFile(
            filepath=filepath, file_size=file_size, file_id=file_id, metadata=metadata
        ),
        pos,
    )


def encode_snapshot_into(buf: bytearray, s: Snapshot) -> None:
    _write_str(buf, s.filepath)
    _write_uvarint(buf, s.file_size)
    _write_uvarint(buf, s.index)
    _write_uvarint(buf, s.term)
    encode_membership_into(buf, s.membership)
    _write_uvarint(buf, len(s.files))
    for f in s.files:
        encode_snapshot_file_into(buf, f)
    _write_bytes(buf, s.checksum)
    flags = (1 if s.dummy else 0) | (2 if s.imported else 0) | (4 if s.witness else 0)
    buf.append(flags)
    _write_uvarint(buf, s.cluster_id)
    _write_uvarint(buf, int(s.type))
    _write_uvarint(buf, s.on_disk_index)


def decode_snapshot_from(data: bytes, pos: int) -> Tuple[Snapshot, int]:
    filepath, pos = _read_str(data, pos)
    file_size, pos = _read_uvarint(data, pos)
    index, pos = _read_uvarint(data, pos)
    term, pos = _read_uvarint(data, pos)
    membership, pos = decode_membership_from(data, pos)
    nfiles, pos = _read_uvarint(data, pos)
    files = []
    for _ in range(nfiles):
        f, pos = decode_snapshot_file_from(data, pos)
        files.append(f)
    checksum, pos = _read_bytes(data, pos)
    if pos >= len(data):
        raise CodecError("truncated Snapshot")
    flags = data[pos]
    pos += 1
    cluster_id, pos = _read_uvarint(data, pos)
    smtype, pos = _read_uvarint(data, pos)
    on_disk_index, pos = _read_uvarint(data, pos)
    return (
        Snapshot(
            filepath=filepath,
            file_size=file_size,
            index=index,
            term=term,
            membership=membership,
            files=files,
            checksum=checksum,
            dummy=bool(flags & 1),
            imported=bool(flags & 2),
            witness=bool(flags & 4),
            cluster_id=cluster_id,
            type=StateMachineType(smtype),
            on_disk_index=on_disk_index,
        ),
        pos,
    )


def encode_snapshot(s: Snapshot) -> bytes:
    buf = bytearray()
    encode_snapshot_into(buf, s)
    return bytes(buf)


def decode_snapshot(data: bytes) -> Snapshot:
    s, pos = decode_snapshot_from(data, 0)
    if pos != len(data):
        raise CodecError("trailing garbage after Snapshot")
    return s


# ---------------------------------------------------------------------------
# Message / MessageBatch
# ---------------------------------------------------------------------------

_MSG_HAS_SNAPSHOT = 1
_MSG_REJECT = 2
_MSG_HAS_TRACE = 4  # replication-trace context appended

# the six ReplTrace wall-clock stamps, in dataclass field order
_TRACE_TS = struct.Struct("<6d")


def _encode_repl_trace_into(buf: bytearray, t) -> None:
    _write_uvarint(buf, t.tid)
    _write_str(buf, t.origin)
    _write_uvarint(buf, t.index)
    buf += _TRACE_TS.pack(
        t.t_send, t.t_recv, t.t_append, t.t_fsync, t.t_ack, t.t_ack_recv
    )


def _decode_repl_trace_from(data: bytes, pos: int):
    from .types import ReplTrace

    tid, pos = _read_uvarint(data, pos)
    origin, pos = _read_str(data, pos)
    index, pos = _read_uvarint(data, pos)
    if pos + _TRACE_TS.size > len(data):
        raise CodecError("truncated ReplTrace")
    ts = _TRACE_TS.unpack_from(data, pos)
    return (
        ReplTrace(
            tid=tid,
            origin=origin,
            index=index,
            t_send=ts[0],
            t_recv=ts[1],
            t_append=ts[2],
            t_fsync=ts[3],
            t_ack=ts[4],
            t_ack_recv=ts[5],
        ),
        pos + _TRACE_TS.size,
    )


def encode_message_into(buf: bytearray, m: Message) -> None:
    flags = 0
    if m.snapshot is not None:
        flags |= _MSG_HAS_SNAPSHOT
    if m.reject:
        flags |= _MSG_REJECT
    if m.trace is not None:
        flags |= _MSG_HAS_TRACE
    _write_uvarint(buf, int(m.type))
    buf.append(flags)
    _write_uvarint(buf, m.to)
    _write_uvarint(buf, m.from_)
    _write_uvarint(buf, m.cluster_id)
    _write_uvarint(buf, m.term)
    _write_uvarint(buf, m.log_term)
    _write_uvarint(buf, m.log_index)
    _write_uvarint(buf, m.commit)
    _write_uvarint(buf, m.hint)
    _write_uvarint(buf, m.hint_high)
    _write_uvarint(buf, len(m.entries))
    for e in m.entries:
        encode_entry_into(buf, e)
    if m.snapshot is not None:
        encode_snapshot_into(buf, m.snapshot)
    if m.trace is not None:
        _encode_repl_trace_into(buf, m.trace)


def decode_message_from(data: bytes, pos: int) -> Tuple[Message, int]:
    mtype, pos = _read_uvarint(data, pos)
    if pos >= len(data):
        raise CodecError("truncated Message")
    flags = data[pos]
    pos += 1
    to, pos = _read_uvarint(data, pos)
    from_, pos = _read_uvarint(data, pos)
    cluster_id, pos = _read_uvarint(data, pos)
    term, pos = _read_uvarint(data, pos)
    log_term, pos = _read_uvarint(data, pos)
    log_index, pos = _read_uvarint(data, pos)
    commit, pos = _read_uvarint(data, pos)
    hint, pos = _read_uvarint(data, pos)
    hint_high, pos = _read_uvarint(data, pos)
    nentries, pos = _read_uvarint(data, pos)
    entries = []
    for _ in range(nentries):
        e, pos = decode_entry_from(data, pos)
        entries.append(e)
    snapshot = None
    if flags & _MSG_HAS_SNAPSHOT:
        snapshot, pos = decode_snapshot_from(data, pos)
    trace = None
    if flags & _MSG_HAS_TRACE:
        trace, pos = _decode_repl_trace_from(data, pos)
    return (
        Message(
            type=MessageType(mtype),
            to=to,
            from_=from_,
            cluster_id=cluster_id,
            term=term,
            log_term=log_term,
            log_index=log_index,
            commit=commit,
            reject=bool(flags & _MSG_REJECT),
            hint=hint,
            entries=entries,
            snapshot=snapshot,
            hint_high=hint_high,
            trace=trace,
        ),
        pos,
    )


def encode_message(m: Message) -> bytes:
    buf = bytearray()
    encode_message_into(buf, m)
    return bytes(buf)


def decode_message(data: bytes) -> Message:
    m, pos = decode_message_from(data, 0)
    if pos != len(data):
        raise CodecError("trailing garbage after Message")
    return m


def encode_message_batch(b: MessageBatch) -> bytes:
    buf = bytearray()
    _write_uvarint(buf, b.deployment_id)
    _write_str(buf, b.source_address)
    _write_uvarint(buf, b.bin_ver)
    _write_uvarint(buf, len(b.requests))
    for m in b.requests:
        encode_message_into(buf, m)
    return bytes(buf)


def decode_message_batch(data: bytes) -> MessageBatch:
    deployment_id, pos = _read_uvarint(data, 0)
    source_address, pos = _read_str(data, pos)
    bin_ver, pos = _read_uvarint(data, pos)
    n, pos = _read_uvarint(data, pos)
    requests = []
    for _ in range(n):
        m, pos = decode_message_from(data, pos)
        requests.append(m)
    if pos != len(data):
        raise CodecError("trailing garbage after MessageBatch")
    return MessageBatch(
        requests=requests,
        deployment_id=deployment_id,
        source_address=source_address,
        bin_ver=bin_ver,
    )


# ---------------------------------------------------------------------------
# Chunk
# ---------------------------------------------------------------------------

def encode_chunk(c: Chunk) -> bytes:
    buf = bytearray()
    _write_uvarint(buf, c.cluster_id)
    _write_uvarint(buf, c.node_id)
    _write_uvarint(buf, c.from_)
    _write_uvarint(buf, c.chunk_id)
    _write_uvarint(buf, c.chunk_size)
    _write_uvarint(buf, c.chunk_count)
    _write_bytes(buf, c.data)
    _write_uvarint(buf, c.index)
    _write_uvarint(buf, c.term)
    encode_membership_into(buf, c.membership)
    _write_str(buf, c.filepath)
    _write_uvarint(buf, c.file_size)
    _write_uvarint(buf, c.deployment_id)
    _write_uvarint(buf, c.file_chunk_id)
    _write_uvarint(buf, c.file_chunk_count)
    flags = (1 if c.has_file_info else 0) | (2 if c.witness else 0)
    buf.append(flags)
    encode_snapshot_file_into(buf, c.file_info)
    _write_uvarint(buf, c.bin_ver)
    _write_uvarint(buf, c.on_disk_index)
    return bytes(buf)


def decode_chunk(data: bytes) -> Chunk:
    cluster_id, pos = _read_uvarint(data, 0)
    node_id, pos = _read_uvarint(data, pos)
    from_, pos = _read_uvarint(data, pos)
    chunk_id, pos = _read_uvarint(data, pos)
    chunk_size, pos = _read_uvarint(data, pos)
    chunk_count, pos = _read_uvarint(data, pos)
    chunk_data, pos = _read_bytes(data, pos)
    index, pos = _read_uvarint(data, pos)
    term, pos = _read_uvarint(data, pos)
    membership, pos = decode_membership_from(data, pos)
    filepath, pos = _read_str(data, pos)
    file_size, pos = _read_uvarint(data, pos)
    deployment_id, pos = _read_uvarint(data, pos)
    file_chunk_id, pos = _read_uvarint(data, pos)
    file_chunk_count, pos = _read_uvarint(data, pos)
    if pos >= len(data):
        raise CodecError("truncated Chunk")
    flags = data[pos]
    pos += 1
    file_info, pos = decode_snapshot_file_from(data, pos)
    bin_ver, pos = _read_uvarint(data, pos)
    on_disk_index, pos = _read_uvarint(data, pos)
    if pos != len(data):
        raise CodecError("trailing garbage after Chunk")
    return Chunk(
        cluster_id=cluster_id,
        node_id=node_id,
        from_=from_,
        chunk_id=chunk_id,
        chunk_size=chunk_size,
        chunk_count=chunk_count,
        data=chunk_data,
        index=index,
        term=term,
        membership=membership,
        filepath=filepath,
        file_size=file_size,
        deployment_id=deployment_id,
        file_chunk_id=file_chunk_id,
        file_chunk_count=file_chunk_count,
        has_file_info=bool(flags & 1),
        file_info=file_info,
        bin_ver=bin_ver,
        witness=bool(flags & 2),
        on_disk_index=on_disk_index,
    )
