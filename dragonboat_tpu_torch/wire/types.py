"""Wire and state types for dragonboat_tpu_torch.

Counterpart: ``dragonboat_tpu/wire/types.py``, copied.

A re-design of the reference raftpb package (reference:
``raftpb/raft.proto``).  The reference uses gogo-protobuf generated Go structs;
here the wire/state model is a small set of slotted Python dataclasses with a
deterministic hand-rolled binary codec (:mod:`dragonboat_tpu_torch.wire.codec`).
Numeric enum values intentionally match ``raftpb/raft.proto:26-77`` so that the
conformance fixtures and the batched device kernels (which bucket messages by
integer type) agree on one vocabulary.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

NO_NODE = 0
NO_LEADER = 0


class MessageType(enum.IntEnum):
    """Message vocabulary (reference ``raftpb/raft.proto:26-53``)."""

    LOCAL_TICK = 0
    ELECTION = 1
    LEADER_HEARTBEAT = 2
    CONFIG_CHANGE_EVENT = 3
    NOOP = 4
    PING = 5
    PONG = 6
    PROPOSE = 7
    SNAPSHOT_STATUS = 8
    UNREACHABLE = 9
    CHECK_QUORUM = 10
    BATCHED_READ_INDEX = 11
    REPLICATE = 12
    REPLICATE_RESP = 13
    REQUEST_VOTE = 14
    REQUEST_VOTE_RESP = 15
    INSTALL_SNAPSHOT = 16
    HEARTBEAT = 17
    HEARTBEAT_RESP = 18
    READ_INDEX = 19
    READ_INDEX_RESP = 20
    QUIESCE = 21
    SNAPSHOT_RECEIVED = 22
    LEADER_TRANSFER = 23
    TIMEOUT_NOW = 24
    RATE_LIMIT = 25


NUM_MESSAGE_TYPES = 26


class EntryType(enum.IntEnum):
    """Entry payload kinds (reference ``raftpb/raft.proto:55-60``)."""

    APPLICATION = 0
    CONFIG_CHANGE = 1
    ENCODED = 2
    METADATA = 3


class ConfigChangeType(enum.IntEnum):
    """Membership change kinds (reference ``raftpb/raft.proto:62-67``)."""

    ADD_NODE = 0
    REMOVE_NODE = 1
    ADD_OBSERVER = 2
    ADD_WITNESS = 3


class StateMachineType(enum.IntEnum):
    """User state machine kinds (reference ``raftpb/raft.proto:69-74``)."""

    UNKNOWN = 0
    REGULAR = 1
    CONCURRENT = 2
    ON_DISK = 3


class CompressionType(enum.IntEnum):
    NO_COMPRESSION = 0
    SNAPPY = 1


class ChecksumType(enum.IntEnum):
    CRC32IEEE = 0
    HIGHWAY = 1


@dataclass(slots=True)
class Entry:
    """A raft log entry (reference ``raftpb/raft.proto:106-116``)."""

    term: int = 0
    index: int = 0
    type: EntryType = EntryType.APPLICATION
    key: int = 0
    client_id: int = 0
    series_id: int = 0
    responded_to: int = 0
    cmd: bytes = b""
    # cached wire encoding (codec.encode_entry_into).  An entry is encoded
    # up to 3× on the leader (one Replicate per follower + the WAL record)
    # and once more on each follower; the bytes are identical every time.
    # Populated lazily by the codec, pre-populated from the wire slice on
    # decode, and cleared by raft.append_entries when term/index are
    # assigned.  Excluded from init/compare/repr — it is not part of the
    # value.
    _enc: Optional[bytes] = field(default=None, init=False, repr=False, compare=False)

    def is_config_change(self) -> bool:
        return self.type == EntryType.CONFIG_CHANGE

    def is_noop_session(self) -> bool:
        return self.client_id == NOOP_CLIENT_ID

    def is_new_session_request(self) -> bool:
        return self.series_id == SERIES_ID_FOR_REGISTER

    def is_end_of_session_request(self) -> bool:
        return self.series_id == SERIES_ID_FOR_UNREGISTER

    def is_session_managed(self) -> bool:
        return not self.is_noop_session()

    def is_empty(self) -> bool:
        return (
            not self.is_config_change()
            and len(self.cmd) == 0
            and self.client_id == NOOP_CLIENT_ID
            and self.series_id == NOOP_SERIES_ID
        )

    def is_update(self) -> bool:
        return not self.is_config_change() and len(self.cmd) > 0

    def size(self) -> int:
        """Approximate in-memory footprint, used by rate limiting."""
        return len(self.cmd) + 64

    def clone(self) -> "Entry":
        return replace(self)


# client/session sentinels (reference client/session.go:23-41)
NOOP_CLIENT_ID = 0
NOOP_SERIES_ID = 0
SERIES_ID_FOR_REGISTER = 0
SERIES_ID_FOR_UNREGISTER = 2**64 - 1
SERIES_ID_FIRST_PROPOSAL = 1


@dataclass(slots=True)
class State:
    """Persistent raft state (reference ``raftpb/raft.proto:100-104``)."""

    term: int = 0
    vote: int = 0
    commit: int = 0

    def is_empty(self) -> bool:
        return self.term == 0 and self.vote == 0 and self.commit == 0


@dataclass(slots=True)
class Membership:
    """Applied membership view (reference ``raftpb/raft.proto:120-126``)."""

    config_change_id: int = 0
    addresses: Dict[int, str] = field(default_factory=dict)
    removed: Dict[int, bool] = field(default_factory=dict)
    observers: Dict[int, str] = field(default_factory=dict)
    witnesses: Dict[int, str] = field(default_factory=dict)

    def clone(self) -> "Membership":
        return Membership(
            config_change_id=self.config_change_id,
            addresses=dict(self.addresses),
            removed=dict(self.removed),
            observers=dict(self.observers),
            witnesses=dict(self.witnesses),
        )


@dataclass(slots=True)
class SnapshotFile:
    """External file attached to a snapshot (``raftpb/raft.proto:129-134``)."""

    filepath: str = ""
    file_size: int = 0
    file_id: int = 0
    metadata: bytes = b""


@dataclass(slots=True)
class Snapshot:
    """Snapshot metadata record (reference ``raftpb/raft.proto:137-152``)."""

    filepath: str = ""
    file_size: int = 0
    index: int = 0
    term: int = 0
    membership: Membership = field(default_factory=Membership)
    files: List[SnapshotFile] = field(default_factory=list)
    checksum: bytes = b""
    dummy: bool = False
    cluster_id: int = 0
    type: StateMachineType = StateMachineType.UNKNOWN
    imported: bool = False
    on_disk_index: int = 0
    witness: bool = False

    def is_empty(self) -> bool:
        return self.index == 0 and self.term == 0


@dataclass(slots=True)
class SystemCtx:
    """128-bit ReadIndex correlation id (reference ``raftpb/raft.go``)."""

    low: int = 0
    high: int = 0

    def __hash__(self) -> int:  # usable as a dict key like the Go struct
        return hash((self.low, self.high))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, SystemCtx)
            and self.low == other.low
            and self.high == other.high
        )

    def is_empty(self) -> bool:
        return self.low == 0 and self.high == 0


@dataclass(slots=True)
class ReadyToRead:
    """A confirmed ReadIndex result handed back to the runtime."""

    index: int = 0
    system_ctx: SystemCtx = field(default_factory=SystemCtx)
    # True when served locally under a leader lease with no
    # confirmation round — in-process only (never wire-encoded); the
    # request tracer uses it to stamp "lease_read" vs "read_confirm"
    lease: bool = False


@dataclass(slots=True)
class ReplTrace:
    """Compact replication-trace context riding a sampled REPLICATE and
    its REPLICATE_RESP across the transport boundary.

    Carried only when the leader's request tracer sampled the proposal
    the message replicates — every other message keeps ``Message.trace``
    at ``None`` and its wire encoding bit-identical to the pre-trace
    build (the ``trace=None`` latch, asserted structurally in
    tests/test_repltrace.py).

    Timestamps are ``time.time()`` wall-clock **in the stamping host's
    own clock**: ``t_send``/``t_ack_recv`` tick on the leader,
    ``t_recv``/``t_append``/``t_fsync``/``t_ack`` on the follower.  The
    leader's attribution plane (obs/replattr.py) reconciles the two
    clocks with the NTP-style ack-pair estimate
    ``offset = ((t_recv - t_send) + (t_ack - t_ack_recv)) / 2``, which
    makes the five stage deltas sum to the measured RTT exactly.
    """

    tid: int = 0          # leader trace id (the sampled proposal's)
    origin: str = ""      # leader host raft address (multi-host merge key)
    index: int = 0        # traced entry index this context attributes
    t_send: float = 0.0   # leader: REPLICATE handed to the transport
    t_recv: float = 0.0   # follower: message reached the inbound router
    t_append: float = 0.0  # follower: raft step appended the entries
    t_fsync: float = 0.0  # follower: WAL made the entries durable
    t_ack: float = 0.0    # follower: RESP handed to the transport
    t_ack_recv: float = 0.0  # leader: RESP reached the inbound router

    def clone(self) -> "ReplTrace":
        return replace(self)


@dataclass(slots=True)
class Message:
    """Raft protocol message (reference ``raftpb/raft.proto:155-169``)."""

    type: MessageType = MessageType.NOOP
    to: int = 0
    from_: int = 0
    cluster_id: int = 0
    term: int = 0
    log_term: int = 0
    log_index: int = 0
    commit: int = 0
    reject: bool = False
    hint: int = 0
    entries: List[Entry] = field(default_factory=list)
    snapshot: Optional[Snapshot] = None
    hint_high: int = 0
    # replication-trace context: None for every non-sampled
    # message — the wire codec emits NOTHING for None (no flag bit, no
    # payload), so the trace-off encoding stays bit-identical
    trace: Optional[ReplTrace] = None


@dataclass(slots=True)
class ConfigChange:
    """Proposed membership change (reference ``raftpb/raft.proto:171-177``)."""

    config_change_id: int = 0
    type: ConfigChangeType = ConfigChangeType.ADD_NODE
    node_id: int = 0
    address: str = ""
    initialize: bool = False


@dataclass(slots=True)
class Bootstrap:
    """Initial membership record (reference ``raftpb/raft.proto:79-84``)."""

    addresses: Dict[int, str] = field(default_factory=dict)
    join: bool = False
    type: StateMachineType = StateMachineType.UNKNOWN

    def validate(self) -> bool:
        # reference raftpb/raft.go Bootstrap.Validate: either joining an
        # existing group or carrying a non-empty initial membership.
        return self.join or len(self.addresses) > 0


@dataclass(slots=True)
class MessageBatch:
    """A batch of messages moving between two hosts (``raft.proto:199-204``)."""

    requests: List[Message] = field(default_factory=list)
    deployment_id: int = 0
    source_address: str = ""
    bin_ver: int = 0


@dataclass(slots=True)
class Chunk:
    """One chunk of a streamed snapshot (reference ``raft.proto:207-228``)."""

    cluster_id: int = 0
    node_id: int = 0
    from_: int = 0
    chunk_id: int = 0
    chunk_size: int = 0
    chunk_count: int = 0
    data: bytes = b""
    index: int = 0
    term: int = 0
    membership: Membership = field(default_factory=Membership)
    filepath: str = ""
    file_size: int = 0
    deployment_id: int = 0
    file_chunk_id: int = 0
    file_chunk_count: int = 0
    has_file_info: bool = False
    file_info: SnapshotFile = field(default_factory=SnapshotFile)
    bin_ver: int = 0
    on_disk_index: int = 0
    witness: bool = False

    def is_last_chunk(self) -> bool:
        # streamed transfers don't know the total count upfront: the final
        # chunk carries the LAST_CHUNK_COUNT sentinel instead (reference
        # raftpb/raft.go LastChunkCount)
        return (
            self.chunk_id + 1 == self.chunk_count
            or self.chunk_count == LAST_CHUNK_COUNT
        )

    def is_last_file_chunk(self) -> bool:
        return self.file_chunk_id + 1 == self.file_chunk_count

    def is_poison(self) -> bool:
        return self.chunk_count == POISON_CHUNK_COUNT


# chunk_count sentinel values (reference raftpb/raft.go LastChunkCount etc.)
LAST_CHUNK_COUNT = 2**64 - 1
POISON_CHUNK_COUNT = 2**64 - 2


@dataclass(slots=True)
class UpdateCommit:
    """Progress acknowledgement applied back into the raft log after the
    runtime has processed an :class:`Update` (reference ``raftpb/raft.go``
    ``UpdateCommit``)."""

    processed: int = 0
    last_applied: int = 0
    stable_log_to: int = 0
    stable_log_term: int = 0
    stable_snapshot_to: int = 0
    ready_to_read: int = 0


@dataclass(slots=True)
class Update:
    """Everything a raft step produced that the runtime must act on
    (reference ``raftpb/raft.go`` ``Update``)."""

    cluster_id: int = 0
    node_id: int = 0
    state: State = field(default_factory=State)
    entries_to_save: List[Entry] = field(default_factory=list)
    committed_entries: List[Entry] = field(default_factory=list)
    snapshot: Optional[Snapshot] = None
    ready_to_reads: List[ReadyToRead] = field(default_factory=list)
    messages: List[Message] = field(default_factory=list)
    last_applied: int = 0
    more_committed_entries: bool = False
    fast_apply: bool = False
    update_commit: UpdateCommit = field(default_factory=UpdateCommit)
    dropped_entries: List[Entry] = field(default_factory=list)
    dropped_read_indexes: List[SystemCtx] = field(default_factory=list)

    def has_update(self) -> bool:
        return (
            not self.state.is_empty()
            or len(self.entries_to_save) > 0
            or len(self.committed_entries) > 0
            or len(self.messages) > 0
            or len(self.ready_to_reads) > 0
            or (self.snapshot is not None and not self.snapshot.is_empty())
            or len(self.dropped_entries) > 0
            or len(self.dropped_read_indexes) > 0
        )


def is_empty_state(st: State) -> bool:
    return st.is_empty()


def is_empty_snapshot(ss: Optional[Snapshot]) -> bool:
    return ss is None or ss.is_empty()


def is_state_equal(a: State, b: State) -> bool:
    return a.term == b.term and a.vote == b.vote and a.commit == b.commit


def entries_size(entries: List[Entry]) -> int:
    return sum(e.size() for e in entries)


def config_change_from_entry(e: Entry) -> "ConfigChange":
    from .codec import decode_config_change

    return decode_config_change(e.cmd)
