"""The scalar Raft core: log, replication progress, ReadIndex, the protocol
state machine and its ``Peer`` API.

Counterpart: ``dragonboat_tpu/raft/``, copied; the exports are the
reference's.
"""
from .log import (  # noqa: F401
    CompactedError,
    EntryLog,
    ILogDB,
    SnapshotOutOfDateError,
    UnavailableError,
)
from .inmemory import InMemory  # noqa: F401
from .memlogdb import InMemLogDB, TestLogDB  # noqa: F401
from .peer import Peer, PeerAddress  # noqa: F401
from .raft import Raft, RaftState  # noqa: F401
from .rate import InMemRateLimiter, RateLimiter  # noqa: F401
from .readindex import ReadIndex  # noqa: F401
from .remote import Remote, RemoteState  # noqa: F401
