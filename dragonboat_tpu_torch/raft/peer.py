"""Peer — the iterative etcd-style API shim over the raft core.

Counterpart: ``dragonboat_tpu/raft/peer.py``, copied.

Reference: ``internal/raft/peer.go`` — inputs become messages, output is an
``Update`` (entries to save, committed entries to apply, messages to send,
snapshot, ready-to-reads); ``commit(ud)`` acknowledges processing.  The node
runtime and the batched quorum engine both drive replicas exclusively through
this interface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..config import Config
from ..wire import (
    NO_LEADER,
    ConfigChange,
    Entry,
    EntryType,
    Message,
    MessageType,
    Snapshot,
    State,
    SystemCtx,
    Update,
    UpdateCommit,
    is_empty_snapshot,
    is_empty_state,
    is_state_equal,
)
from ..wire.codec import encode_config_change
from .log import ILogDB
from .raft import Raft, is_local_message

MT = MessageType


@dataclass(slots=True)
class PeerAddress:
    node_id: int
    address: str


def is_response_message_type(t: MessageType) -> bool:
    return t in (
        MT.REPLICATE_RESP,
        MT.REQUEST_VOTE_RESP,
        MT.HEARTBEAT_RESP,
        MT.READ_INDEX_RESP,
        MT.UNREACHABLE,
        MT.SNAPSHOT_STATUS,
        MT.LEADER_TRANSFER,
        MT.RATE_LIMIT,
    )


def check_launch_request(
    config: Config, addresses: List[PeerAddress], initial: bool, new_node: bool
) -> None:
    if config.node_id == 0:
        raise ValueError("config.node_id must not be zero")
    if initial and new_node and len(addresses) == 0:
        raise ValueError("addresses must be specified")
    unique = {a.address for a in addresses}
    if len(unique) != len(addresses):
        raise ValueError(f"duplicated address found {addresses}")


def _bootstrap(r: Raft, addresses: List[PeerAddress]) -> None:
    # reference peer.go:378-408: synthesize term-1 AddNode entries
    addresses = sorted(addresses, key=lambda a: a.node_id)
    ents = []
    for i, peer in enumerate(addresses):
        cc = ConfigChange(
            type=cc_add_node_type(), node_id=peer.node_id,
            initialize=True, address=peer.address,
        )
        ents.append(
            Entry(
                type=EntryType.CONFIG_CHANGE,
                term=1,
                index=i + 1,
                cmd=encode_config_change(cc),
            )
        )
    r.log.append(ents)
    r.log.committed = len(ents)
    for peer in addresses:
        r.add_node(peer.node_id)


def cc_add_node_type():
    from ..wire import ConfigChangeType

    return ConfigChangeType.ADD_NODE


def validate_update(ud: Update) -> None:
    if ud.state.commit > 0 and ud.committed_entries:
        last_index = ud.committed_entries[-1].index
        if last_index > ud.state.commit:
            raise RuntimeError(
                f"applying not committed entry: {ud.state.commit}, {last_index}"
            )
    if ud.committed_entries and ud.entries_to_save:
        last_apply = ud.committed_entries[-1].index
        last_save = ud.entries_to_save[-1].index
        if last_apply > last_save:
            raise RuntimeError(
                f"applying not saved entry: {last_apply}, {last_save}"
            )


def set_fast_apply(ud: Update) -> Update:
    # reference peer.go setFastApply: apply can overlap save unless the
    # committed entries include entries not yet persisted
    ud.fast_apply = True
    if not is_empty_snapshot(ud.snapshot):
        ud.fast_apply = False
    if ud.fast_apply:
        if ud.committed_entries and ud.entries_to_save:
            last_apply = ud.committed_entries[-1].index
            last_save = ud.entries_to_save[-1].index
            first_save = ud.entries_to_save[0].index
            if first_save <= last_apply <= last_save:
                ud.fast_apply = False
    return ud


def get_update_commit(ud: Update) -> UpdateCommit:
    uc = UpdateCommit(
        ready_to_read=len(ud.ready_to_reads), last_applied=ud.last_applied
    )
    if ud.committed_entries:
        uc.processed = ud.committed_entries[-1].index
    if ud.entries_to_save:
        last = ud.entries_to_save[-1]
        uc.stable_log_to, uc.stable_log_term = last.index, last.term
    if not is_empty_snapshot(ud.snapshot):
        uc.stable_snapshot_to = ud.snapshot.index
        uc.processed = max(uc.processed, uc.stable_snapshot_to)
    return uc


class Peer:
    """Reference ``peer.go:55-60``."""

    __slots__ = ("raft", "prev_state")

    def __init__(self, raft: Raft):
        self.raft = raft
        self.prev_state = State()

    @staticmethod
    def launch(
        config: Config,
        logdb: ILogDB,
        events,
        addresses: List[PeerAddress],
        initial: bool,
        new_node: bool,
        seed: Optional[int] = None,
    ) -> "Peer":
        # reference peer.go:62-85
        check_launch_request(config, addresses, initial, new_node)
        r = Raft(config, logdb, seed=seed)
        p = Peer(r)
        r.events = events
        _, last_index = logdb.get_range()
        if new_node and not config.is_observer and not config.is_witness:
            r.become_follower(1, NO_LEADER)
        if initial and new_node:
            _bootstrap(r, addresses)
        if last_index == 0:
            p.prev_state = State()
        else:
            p.prev_state = r.raft_state()
        return p

    def tick(self) -> None:
        self.raft.handle(Message(type=MT.LOCAL_TICK, reject=False))

    def campaign(self) -> None:
        """Start an election immediately (etcd ``raft.Campaign`` — the
        same local ELECTION message ``raft.go:395`` injects when the
        randomized election timeout fires)."""
        self.raft.handle(Message(type=MT.ELECTION, from_=self.raft.node_id))

    def quiesced_tick(self) -> None:
        self.raft.handle(Message(type=MT.LOCAL_TICK, reject=True))

    def request_leader_transfer(self, target: int) -> None:
        self.raft.handle(
            Message(
                type=MT.LEADER_TRANSFER,
                to=self.raft.node_id,
                from_=target,
                hint=target,
            )
        )

    def propose_entries(self, ents: List[Entry]) -> None:
        self.raft.handle(
            Message(type=MT.PROPOSE, from_=self.raft.node_id, entries=ents)
        )

    def propose_config_change(self, cc: ConfigChange, key: int) -> None:
        data = encode_config_change(cc)
        self.raft.handle(
            Message(
                type=MT.PROPOSE,
                entries=[Entry(type=EntryType.CONFIG_CHANGE, cmd=data, key=key)],
            )
        )

    def apply_config_change(self, cc: ConfigChange) -> None:
        if cc.node_id == NO_LEADER:
            self.raft.clear_pending_config_change()
            return
        self.raft.handle(
            Message(
                type=MT.CONFIG_CHANGE_EVENT,
                reject=False,
                hint=cc.node_id,
                hint_high=int(cc.type),
            )
        )

    def reject_config_change(self) -> None:
        self.raft.handle(Message(type=MT.CONFIG_CHANGE_EVENT, reject=True))

    def restore_remotes(self, ss: Snapshot) -> None:
        self.raft.handle(Message(type=MT.SNAPSHOT_RECEIVED, snapshot=ss))

    def report_unreachable_node(self, node_id: int) -> None:
        self.raft.handle(Message(type=MT.UNREACHABLE, from_=node_id))

    def report_snapshot_status(self, node_id: int, reject: bool) -> None:
        self.raft.handle(
            Message(type=MT.SNAPSHOT_STATUS, from_=node_id, reject=reject)
        )

    def handle(self, m: Message) -> None:
        # reference peer.go:186-199: drop responses from unknown nodes
        if is_local_message(m.type):
            raise RuntimeError("local message sent to Step")
        known = (
            m.from_ in self.raft.remotes
            or m.from_ in self.raft.observers
            or m.from_ in self.raft.witnesses
        )
        if known or not is_response_message_type(m.type):
            self.raft.handle(m)

    def read_index(self, ctx: SystemCtx) -> None:
        self.raft.handle(
            Message(type=MT.READ_INDEX, hint=ctx.low, hint_high=ctx.high)
        )

    def notify_raft_last_applied(self, last_applied: int) -> None:
        self.raft.set_applied(last_applied)

    def has_entry_to_apply(self) -> bool:
        return self.raft.log.has_entries_to_apply()

    def rate_limited(self) -> bool:
        return self.raft.rl.rate_limited()

    def has_update(self, more_entries_to_apply: bool) -> bool:
        # reference peer.go:253-280
        r = self.raft
        pst = r.raft_state()
        if not is_empty_state(pst) and not is_state_equal(pst, self.prev_state):
            return True
        if r.log.inmem.snapshot is not None and not r.log.inmem.snapshot.is_empty():
            return True
        if r.msgs:
            return True
        if r.log.entries_to_save():
            return True
        if more_entries_to_apply and r.log.has_entries_to_apply():
            return True
        if r.ready_to_read:
            return True
        if r.dropped_entries or r.dropped_read_indexes:
            return True
        return False

    def get_update(self, more_to_apply: bool, last_applied: int) -> Update:
        ud = self._get_update(more_to_apply, last_applied)
        validate_update(ud)
        ud = set_fast_apply(ud)
        ud.update_commit = get_update_commit(ud)
        return ud

    def _get_update(self, more_entries_to_apply: bool, last_applied: int) -> Update:
        r = self.raft
        ud = Update(
            cluster_id=r.cluster_id,
            node_id=r.node_id,
            entries_to_save=r.log.entries_to_save(),
            messages=r.msgs,
            last_applied=last_applied,
            fast_apply=True,
        )
        if more_entries_to_apply:
            ud.committed_entries = r.log.entries_to_apply()
        if ud.committed_entries:
            last_index = ud.committed_entries[-1].index
            ud.more_committed_entries = r.log.has_more_entries_to_apply(last_index)
        pst = r.raft_state()
        if not is_state_equal(pst, self.prev_state):
            ud.state = pst
        if r.log.inmem.snapshot is not None:
            ud.snapshot = r.log.inmem.snapshot
        if r.ready_to_read:
            ud.ready_to_reads = r.ready_to_read
        if r.dropped_entries:
            ud.dropped_entries = r.dropped_entries
        if r.dropped_read_indexes:
            ud.dropped_read_indexes = r.dropped_read_indexes
        return ud

    def commit(self, ud: Update) -> None:
        # reference peer.go:282-295
        r = self.raft
        r.msgs = []
        r.dropped_entries = []
        r.dropped_read_indexes = []
        if not is_empty_state(ud.state):
            self.prev_state = ud.state
        if ud.update_commit.ready_to_read > 0:
            r.clear_ready_to_read()
        r.log.commit_update(ud.update_commit)

    def local_status(self):
        from dataclasses import dataclass as _dc

        r = self.raft
        return {
            "cluster_id": r.cluster_id,
            "node_id": r.node_id,
            "leader_id": r.leader_id,
            "state": r.state,
            "is_leader": r.is_leader(),
        }
