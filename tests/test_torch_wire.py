"""The port's wire codec against the JAX package's, byte for byte.

``dragonboat_tpu_torch.wire`` is a copy of ``dragonboat_tpu.wire``; its
encoding is the bridge that carries Raft state across the two packages.
Seeded random values of every wire type are built in both packages from
the same plain fields.  Each side's encoding must give the same bytes;
each side decodes the other's bytes to equal fields, and re-encodes them
to the same bytes.  Malformed inputs (truncations, flipped bytes, appended
garbage) must be rejected by both codecs with the same exception type, or
accepted by both with the same fields.  Objects never cross packages:
only bytes and plain fields do.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import pytest
import torch

from dragonboat_tpu import wire as ref_wire
from dragonboat_tpu_torch import wire as port_wire

torch.set_num_threads(1)

SIDES = {"ref": ref_wire, "port": port_wire}


def plain(v):
    """A wire object as plain Python: dataclasses become (name, fields)
    tuples, enums ints; cached encodings are left out."""
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, tuple(
            (f.name, plain(getattr(v, f.name)))
            for f in dataclasses.fields(v) if f.compare))
    if isinstance(v, enum.Enum):
        return int(v)
    if isinstance(v, dict):
        return tuple(sorted((k, plain(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(plain(x) for x in v)
    return v


# ----------------------------------------------------------------------
# seeded field generators (plain Python; each side builds its own objects)
# ----------------------------------------------------------------------

def _u64(rng):
    kind = rng.integers(0, 4)
    if kind == 0:
        return 0
    if kind == 1:
        return int(rng.integers(1, 128))
    if kind == 2:
        return int(rng.integers(128, 1 << 40))
    return int(rng.integers(0, 1 << 62)) * 4 + int(rng.integers(0, 4))


def _bytes(rng, n=24):
    return bytes(rng.integers(0, 256, int(rng.integers(0, n))).tolist())


def _text(rng):
    return "".join(chr(int(c)) for c in rng.integers(97, 123, int(rng.integers(0, 9))))


def entry_fields(rng):
    return dict(term=_u64(rng), index=_u64(rng), type=int(rng.integers(0, 4)),
                key=_u64(rng), client_id=_u64(rng), series_id=_u64(rng),
                responded_to=_u64(rng), cmd=_bytes(rng))


def membership_fields(rng):
    ids = lambda: [int(x) for x in rng.integers(1, 1 << 20, int(rng.integers(0, 4)))]
    return dict(config_change_id=_u64(rng),
                addresses={i: _text(rng) for i in ids()},
                removed={i: True for i in ids()},
                observers={i: _text(rng) for i in ids()},
                witnesses={i: _text(rng) for i in ids()})


def snapshot_file_fields(rng):
    return dict(filepath=_text(rng), file_size=_u64(rng), file_id=_u64(rng),
                metadata=_bytes(rng, 8))


def snapshot_fields(rng):
    return dict(filepath=_text(rng), file_size=_u64(rng), index=_u64(rng),
                term=_u64(rng), membership=membership_fields(rng),
                files=[snapshot_file_fields(rng)
                       for _ in range(int(rng.integers(0, 3)))],
                checksum=_bytes(rng, 8), dummy=bool(rng.integers(0, 2)),
                cluster_id=_u64(rng), type=int(rng.integers(0, 4)),
                imported=bool(rng.integers(0, 2)), on_disk_index=_u64(rng),
                witness=bool(rng.integers(0, 2)))


def trace_fields(rng):
    return dict(tid=_u64(rng), origin=_text(rng), index=_u64(rng),
                **{k: float(rng.random() * 1e9) for k in (
                    "t_send", "t_recv", "t_append", "t_fsync", "t_ack",
                    "t_ack_recv")})


def message_fields(rng, mtype):
    return dict(type=mtype, to=_u64(rng), from_=_u64(rng),
                cluster_id=_u64(rng), term=_u64(rng), log_term=_u64(rng),
                log_index=_u64(rng), commit=_u64(rng),
                reject=bool(rng.integers(0, 2)), hint=_u64(rng),
                hint_high=_u64(rng),
                entries=[entry_fields(rng)
                         for _ in range(int(rng.integers(0, 4)))],
                snapshot=(snapshot_fields(rng) if rng.random() < 0.3 else None),
                trace=(trace_fields(rng) if rng.random() < 0.2 else None))


def cc_fields(rng):
    return dict(config_change_id=_u64(rng), type=int(rng.integers(0, 4)),
                node_id=_u64(rng), address=_text(rng),
                initialize=bool(rng.integers(0, 2)))


def chunk_fields(rng):
    return dict(cluster_id=_u64(rng), node_id=_u64(rng), from_=_u64(rng),
                chunk_id=_u64(rng), chunk_size=_u64(rng),
                chunk_count=_u64(rng), data=_bytes(rng), index=_u64(rng),
                term=_u64(rng), membership=membership_fields(rng),
                filepath=_text(rng), file_size=_u64(rng),
                deployment_id=_u64(rng), file_chunk_id=_u64(rng),
                file_chunk_count=_u64(rng),
                has_file_info=bool(rng.integers(0, 2)),
                file_info=snapshot_file_fields(rng), bin_ver=_u64(rng),
                on_disk_index=_u64(rng), witness=bool(rng.integers(0, 2)))


# ----------------------------------------------------------------------
# building one side's objects from the plain fields
# ----------------------------------------------------------------------

def build_entry(w, f):
    return w.Entry(**dict(f, type=w.EntryType(f["type"])))


def build_membership(w, f):
    return w.Membership(**{k: dict(v) if isinstance(v, dict) else v
                           for k, v in f.items()})


def build_snapshot(w, f):
    return w.Snapshot(**dict(
        f, membership=build_membership(w, f["membership"]),
        files=[w.SnapshotFile(**x) for x in f["files"]],
        type=w.StateMachineType(f["type"])))


def build_message(w, f):
    return w.Message(**dict(
        f, type=w.MessageType(f["type"]),
        entries=[build_entry(w, e) for e in f["entries"]],
        snapshot=(None if f["snapshot"] is None
                  else build_snapshot(w, f["snapshot"])),
        trace=None if f["trace"] is None else w.ReplTrace(**f["trace"])))


def build_chunk(w, f):
    return w.Chunk(**dict(
        f, membership=build_membership(w, f["membership"]),
        file_info=w.SnapshotFile(**f["file_info"])))


# kind -> (field generator, object maker, encoder name, decoder name)
KINDS = {
    "entry": (entry_fields, build_entry, "encode_entry", "decode_entry"),
    "entry_batch": (
        lambda rng: [entry_fields(rng) for _ in range(int(rng.integers(0, 5)))],
        lambda w, f: [build_entry(w, e) for e in f],
        "encode_entry_batch", "decode_entry_batch"),
    "state": (lambda rng: dict(term=_u64(rng), vote=_u64(rng), commit=_u64(rng)),
              lambda w, f: w.State(**f), "encode_state", "decode_state"),
    "membership": (membership_fields, build_membership,
                   "encode_membership", "decode_membership"),
    "snapshot": (snapshot_fields, build_snapshot,
                 "encode_snapshot", "decode_snapshot"),
    "config_change": (
        cc_fields,
        lambda w, f: w.ConfigChange(**dict(f, type=w.ConfigChangeType(f["type"]))),
        "encode_config_change", "decode_config_change"),
    "bootstrap": (
        lambda rng: dict(addresses=membership_fields(rng)["addresses"],
                         join=bool(rng.integers(0, 2)),
                         type=int(rng.integers(0, 4))),
        lambda w, f: w.Bootstrap(**dict(f, type=w.StateMachineType(f["type"]))),
        "encode_bootstrap", "decode_bootstrap"),
    "message_batch": (
        lambda rng: dict(requests=[message_fields(rng, int(rng.integers(0, 26)))
                                   for _ in range(int(rng.integers(0, 4)))],
                         deployment_id=_u64(rng), source_address=_text(rng),
                         bin_ver=_u64(rng)),
        lambda w, f: w.MessageBatch(**dict(
            f, requests=[build_message(w, m) for m in f["requests"]])),
        "encode_message_batch", "decode_message_batch"),
    "chunk": (chunk_fields, build_chunk, "encode_chunk", "decode_chunk"),
}


SPECS = dict(KINDS, message=(
    lambda rng: message_fields(rng, int(rng.integers(0, 26))),
    build_message, "encode_message", "decode_message"))


def _codec(w, name):
    return getattr(w.codec, name)


def _outcome(w, dec, enc, data):
    """What one side's decoder makes of ``data``: ("ok", plain fields,
    re-encoding) or ("err", exception type name)."""
    try:
        obj = _codec(w, dec)(data)
    except Exception as exc:  # the type is what is compared
        return ("err", type(exc).__name__)
    return ("ok", plain(obj), _codec(w, enc)(obj))


def _trip(kind, fields):
    """Both directions of the bridge for one value."""
    _, build, enc, dec = SPECS[kind]
    objs = {s: build(w, fields) for s, w in SIDES.items()}
    data = {s: _codec(SIDES[s], enc)(objs[s]) for s in SIDES}
    assert data["ref"] == data["port"], kind
    assert plain(objs["ref"]) == plain(objs["port"])
    for src, dst in (("ref", "port"), ("port", "ref")):
        back = _codec(SIDES[dst], dec)(data[src])
        assert plain(back) == plain(objs[src]), (kind, src, dst)
        assert _codec(SIDES[dst], enc)(back) == data[src], (kind, src, dst)
    return data["ref"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_round_trip_both_ways(kind, seed):
    rng = np.random.default_rng(1000 * seed + sorted(KINDS).index(kind))
    gen = KINDS[kind][0]
    for _ in range(40):
        _trip(kind, gen(rng))


@pytest.mark.parametrize("mtype", [int(t) for t in ref_wire.MessageType])
def test_every_message_type_round_trips(mtype):
    rng = np.random.default_rng(7919 + mtype)
    for _ in range(20):
        _trip("message", message_fields(rng, mtype))


def _malformed(rng, data):
    """Truncations, flipped bytes and appended garbage of ``data``."""
    out = [b"", data + b"\x00", data + bytes(rng.integers(0, 256, 3).tolist())]
    for _ in range(12):
        cut = int(rng.integers(0, max(1, len(data))))
        out.append(data[:cut])
    for _ in range(12):
        b = bytearray(data)
        if b:
            i = int(rng.integers(0, len(b)))
            b[i] = int(rng.integers(0, 256))
        out.append(bytes(b))
    out.append(b"\xff" * 11)  # a varint past uint64
    out.append(b"\x80" * 10 + b"\x02")  # a 10th byte worth more than one bit
    return out


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_malformed_inputs_fail_alike(kind):
    rng = np.random.default_rng(31337 + sorted(SPECS).index(kind))
    gen, build, enc, dec = SPECS[kind]
    rejected = 0
    for _ in range(15):
        data = _codec(ref_wire, enc)(build(ref_wire, gen(rng)))
        for bad in _malformed(rng, data):
            a = _outcome(ref_wire, dec, enc, bad)
            b = _outcome(port_wire, dec, enc, bad)
            assert a == b, (kind, bad.hex())
            rejected += a[0] == "err"
    assert rejected > 0


def test_config_change_entry_and_constants_agree():
    """The helpers beside the codec: a config-change entry decodes alike,
    and the exported constants and enums are the reference's."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        f = cc_fields(rng)
        ents = {}
        for s, w in SIDES.items():
            cc = w.ConfigChange(**dict(f, type=w.ConfigChangeType(f["type"])))
            ents[s] = w.Entry(type=w.EntryType.CONFIG_CHANGE,
                              cmd=w.codec.encode_config_change(cc))
        for s, w in SIDES.items():
            other = ents["port" if s == "ref" else "ref"]
            e = w.Entry(type=w.EntryType(int(other.type)), cmd=other.cmd)
            assert plain(w.config_change_from_entry(e)) == plain(
                SIDES["port" if s == "ref" else "ref"].config_change_from_entry(
                    other))
    for name in ("NO_LEADER", "NO_NODE", "NOOP_CLIENT_ID", "NOOP_SERIES_ID",
                 "SERIES_ID_FIRST_PROPOSAL", "SERIES_ID_FOR_REGISTER",
                 "SERIES_ID_FOR_UNREGISTER", "LAST_CHUNK_COUNT",
                 "POISON_CHUNK_COUNT"):
        assert getattr(port_wire, name) == getattr(ref_wire, name), name
    for name in ("MessageType", "EntryType", "ConfigChangeType",
                 "StateMachineType", "CompressionType", "ChecksumType"):
        a, b = getattr(ref_wire, name), getattr(port_wire, name)
        assert [(m.name, int(m)) for m in a] == [(m.name, int(m)) for m in b]
    assert sorted(n for n in dir(ref_wire) if not n.startswith("_")) == sorted(
        n for n in dir(port_wire) if not n.startswith("_"))
