"""The port's configuration and settings against the JAX package's.

``dragonboat_tpu_torch.config`` and ``.settings`` are copies of the
reference's.  Every ``ConfigError`` case of the reference's ``validate``
methods must be raised by the port's for the same input (and every input
the reference accepts, the port accepts), with one planned difference:
the device engine is ``"cuda"`` in the port and ``"tpu"`` in the
reference.  The settings keep the reference's defaults, hard-settings
hash and JSON override files, read from the working directory at import;
the override test imports the port's settings afresh in a subprocess run
in ``tmp_path``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import pytest
import torch

from dragonboat_tpu import config as ref_config
from dragonboat_tpu import settings as ref_settings
from dragonboat_tpu_torch import config as port_config
from dragonboat_tpu_torch import settings as port_settings

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Config inputs: each is a dict of fields over a valid base
CONFIG_CASES = {
    "valid": {},
    "node_id_zero": dict(node_id=0),
    "heartbeat_zero": dict(heartbeat_rtt=0),
    "election_zero": dict(election_rtt=0),
    "election_not_above_2x_heartbeat": dict(election_rtt=4, heartbeat_rtt=2),
    "election_below_10x_heartbeat": dict(election_rtt=5, heartbeat_rtt=1),
    "negative_log_size": dict(max_in_mem_log_size=-1),
    "small_log_size": dict(max_in_mem_log_size=1024),
    "log_size_64k": dict(max_in_mem_log_size=64 * 1024),
    "snapshot_compression": dict(snapshot_compression=2),
    "entry_compression": dict(entry_compression=3),
    "snappy": dict(snapshot_compression=1, entry_compression=1),
    "witness_snapshots": dict(is_witness=True, snapshot_entries=10),
    "witness_observer": dict(is_witness=True, is_observer=True),
    "witness": dict(is_witness=True),
    "observer": dict(is_observer=True),
    "lease_no_check_quorum": dict(read_lease=True),
    "lease_quiesce": dict(read_lease=True, check_quorum=True, quiesce=True),
    "lease": dict(read_lease=True, check_quorum=True),
    "hier_domains_not_dict": dict(hier_domains=[(1, "a")]),
    "hier_bad_id": dict(hier_commit=True, hier_domains={0: "a"}),
    "hier_str_id": dict(hier_commit=True, hier_domains={"1": "a"}),
    "hier_bad_label": dict(hier_commit=True, hier_domains={1: 7}),
    "hier": dict(hier_commit=True, hier_domains={1: "a", 2: "a", 3: "b"}),
    "hier_off_bad_label": dict(hier_domains={1: 7}),
}

EXPERT_CASES = {
    "scalar": dict(quorum_engine="scalar"),
    "auto": dict(quorum_engine="auto"),
    "bogus_engine": dict(quorum_engine="gpu"),
    "negative_workers": dict(host_workers=-1),
    "journal_force": dict(host_wal_journal="force"),
    "journal_off": dict(host_wal_journal="off"),
    "bogus_journal": dict(host_wal_journal="sometimes"),
}

NODEHOST_CASES = {
    "valid": {},
    "rtt_zero": dict(rtt_millisecond=0),
    "no_dir": dict(node_host_dir=""),
    "no_address": dict(raft_address=""),
    "address_no_port": dict(raft_address="localhost"),
    "address_no_host": dict(raft_address=":9000"),
    "address_bad_port": dict(raft_address="localhost:http"),
    "address_port_zero": dict(raft_address="localhost:0"),
    "address_port_big": dict(raft_address="localhost:70000"),
    "bad_listen": dict(listen_address="nohost"),
    "listen": dict(listen_address="0.0.0.0:9001"),
    "tls_no_files": dict(mutual_tls=True, ca_file="ca"),
    "tls": dict(mutual_tls=True, ca_file="ca", cert_file="c", key_file="k"),
    "expert_bad": dict(expert=("quorum_engine", "gpu")),
}


def _outcome(fn):
    """("ok", warnings) or ("err", exception type, message)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            fn()
        except Exception as exc:  # the type and text are what is compared
            return ("err", type(exc).__name__, str(exc))
    return ("ok", [str(w.message) for w in seen])


def _config(mod, fields):
    return mod.Config(**dict(dict(node_id=1, cluster_id=7), **fields))


def _nodehost(mod, fields):
    fields = dict(fields)
    expert = fields.pop("expert", None)
    nh = mod.NodeHostConfig(**dict(
        dict(node_host_dir="/nh", raft_address="localhost:9000"), **fields))
    if expert is not None:
        setattr(nh.expert, *expert)
    return nh


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_validate_matches(case):
    a = _outcome(_config(ref_config, CONFIG_CASES[case]).validate)
    b = _outcome(_config(port_config, CONFIG_CASES[case]).validate)
    assert a == b
    if a[0] == "err":
        assert a[1] == "ConfigError"


@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_expert_validate_matches(case):
    a = _outcome(ref_config.ExpertConfig(**EXPERT_CASES[case]).validate)
    b = _outcome(port_config.ExpertConfig(**EXPERT_CASES[case]).validate)
    assert a == b


@pytest.mark.parametrize("case", sorted(NODEHOST_CASES))
def test_nodehost_validate_matches(case):
    a = _outcome(_nodehost(ref_config, NODEHOST_CASES[case]).validate)
    b = _outcome(_nodehost(port_config, NODEHOST_CASES[case]).validate)
    assert a == b


def test_device_engine_is_cuda_in_the_port():
    """The one planned difference: the port's device engine is "cuda"."""
    port_config.ExpertConfig(quorum_engine="cuda").validate()
    with pytest.raises(port_config.ConfigError, match="'tpu'"):
        port_config.ExpertConfig(quorum_engine="tpu").validate()
    ref_config.ExpertConfig(quorum_engine="tpu").validate()
    with pytest.raises(ref_config.ConfigError):
        ref_config.ExpertConfig(quorum_engine="cuda").validate()


@pytest.mark.parametrize("name", ["Config", "ExpertConfig", "LogDBConfig",
                                  "NodeHostConfig"])
def test_fields_and_defaults_match(name):
    """Same fields, in the same order, with the same defaults."""
    def shape(mod):
        obj = getattr(mod, name)()
        return [(f.name, repr(getattr(obj, f.name)) if f.name != "expert"
                 else "ExpertConfig") for f in dataclasses.fields(obj)]
    assert shape(ref_config) == shape(port_config)
    nh = (ref_config.NodeHostConfig(raft_address="a:1"),
          port_config.NodeHostConfig(raft_address="a:1"))
    for c in nh:
        c.prepare()
    assert [(c.listen_address, c.deployment_id, c.get_deployment_id(),
             c.get_listen_address()) for c in nh][0] == [
        (c.listen_address, c.deployment_id, c.get_deployment_id(),
         c.get_listen_address()) for c in nh][1]
    assert (dataclasses.asdict(ref_config.LogDBConfig.tiny())
            == dataclasses.asdict(port_config.LogDBConfig.tiny()))


def test_settings_defaults_and_hash_match():
    for cls in ("HardSettings", "SoftSettings"):
        a = dataclasses.asdict(getattr(ref_settings, cls)())
        b = dataclasses.asdict(getattr(port_settings, cls)())
        assert a == b, cls
    assert ref_settings.HardSettings().hash() == port_settings.HardSettings().hash()
    h = port_settings.HardSettings(logdb_pool_size=4)
    assert h.hash() == ref_settings.HardSettings(logdb_pool_size=4).hash()
    assert h.hash() != port_settings.HardSettings().hash()


def test_settings_override_files_read_from_the_working_directory(
        tmp_path, monkeypatch):
    """The deployment's JSON files override integer fields of Hard and
    Soft at import; unknown keys and non-integers are ignored."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "dragonboat-tpu-soft-settings.json").write_text(json.dumps(
        {"max_entry_size": 4096, "lazy_tick_sweep_ticks": 9,
         "no_such_field": 3, "in_mem_gc_timeout": "fast"}))
    (tmp_path / "dragonboat-tpu-hard-settings.json").write_text(json.dumps(
        {"logdb_pool_size": 4}))
    code = (
        "import json, dataclasses\n"
        "from dragonboat_tpu_torch import settings as s\n"
        "print(json.dumps([dataclasses.asdict(s.Soft), "
        "dataclasses.asdict(s.Hard), s.Hard.hash()]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    soft, hard, digest = json.loads(out.stdout.strip().splitlines()[-1])
    want_soft = dataclasses.asdict(ref_settings.SoftSettings(
        max_entry_size=4096, lazy_tick_sweep_ticks=9))
    assert soft == want_soft
    want_hard = ref_settings.HardSettings(logdb_pool_size=4)
    assert hard == dataclasses.asdict(want_hard)
    assert digest == want_hard.hash()
    # the running process kept its own, untouched settings
    assert port_settings.Soft == port_settings.SoftSettings()
