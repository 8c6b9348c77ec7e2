"""Public configuration types.

Counterpart: ``dragonboat_tpu/config.py``, copied.  The one change:
``ExpertConfig.quorum_engine`` names the device engine ``"cuda"`` where the
reference says ``"tpu"``.  The fields are the reference's; most of what
reads them (NodeHost, the host planes, tracing, health, the mesh) comes
with later slices of the port.

Reference: ``config/config.go`` — per-group ``Config`` (:68-223), per-host
``NodeHostConfig`` (:226-576) and ``LogDBConfig``.  This build adds the
``ExpertConfig`` plugin boundary called for by the north star (the reference
v3.3.0-dev has no ``Expert`` field; its pluggability precedent is
``LogDBFactory``/``RaftRPCFactory``, ``config/config.go:298-305``): the
batched quorum engine is selected through ``ExpertConfig.quorum_engine``
so the pure-host scalar path stays available for differential testing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    """Per-raft-group configuration (reference ``config/config.go:68-223``)."""

    node_id: int = 0
    cluster_id: int = 0
    check_quorum: bool = False
    election_rtt: int = 10
    heartbeat_rtt: int = 1
    snapshot_entries: int = 0
    compaction_overhead: int = 5000
    ordered_config_change: bool = False
    max_in_mem_log_size: int = 0
    snapshot_compression: int = 0  # CompressionType
    entry_compression: int = 0  # CompressionType
    disable_auto_compactions: bool = False
    is_observer: bool = False
    is_witness: bool = False
    quiesce: bool = False
    # leader-lease read plane (dragonboat_tpu_torch/lease.py): a
    # CheckQuorum-backed, clock-bound lease lets a leader serve
    # linearizable reads locally with ZERO confirmation rounds — valid
    # for election_rtt − drift_epsilon ticks after the last quorum of
    # heartbeat acks; expiry/leadership-transfer/membership-change/term
    # change all fall back to the ReadIndex path.  OFF (default) keeps
    # the request paths structurally bit-identical (raft.lease is None,
    # the _read_plane_used precedent).  Requires check_quorum (the §6
    # vote lease is what makes the clock bound hold against forced
    # campaigns) and is rejected with quiesce (a quiesced leader's tick
    # clock freezes while follower election clocks keep running).
    read_lease: bool = False
    # device-resident state machine (devsm,
    # dragonboat_tpu_torch/devsm): with the cuda quorum engine and a
    # DeviceKVStateMachine factory, committed fixed-width (key_slot,
    # value) ops apply as (G, slots) tensor updates INSIDE the fused
    # quorum dispatch — apply == commit on the device — and
    # lease/ReadIndex reads serve straight from device state with zero
    # host apply on the read path.  OFF (default) keeps the SM a plain
    # host IStateMachine and every request path structurally
    # bit-identical (the _devsm_used latch precedent).  On the scalar
    # engine the flag is inert — the same SM just runs host-side.
    device_kv: bool = False
    # hierarchical commit plane (dragonboat_tpu_torch/raft/hier.py):
    # partition the voter set into latency domains (``hier_domains``:
    # node_id -> domain label) and let a leader whose own domain holds a
    # durable sub-quorum (majority of that domain, CD-Raft / Fast
    # Hierarchical Raft rule) close commits at the near RTT — far-domain
    # voters catch up asynchronously through the ordinary
    # replicate/resend machinery.  Safety comes from the paired vote
    # rule: winning an election additionally requires enough grants
    # inside every eligible (>= 2 voters) domain to guarantee
    # intersection with any sub-quorum that may have committed there,
    # so a new leader always carries every sub-quorum-committed entry.
    # Classic-quorum commits remain valid throughout (the rule is
    # max(classic, sub-quorum)).  Liveness tradeoff (documented in
    # docs/overview.md): while an eligible domain is entirely
    # unreachable, elections stall until it heals or membership drops
    # it.  OFF (default) keeps every request path structurally
    # bit-identical (raft.hier is None, the lease/_obs latch precedent).
    # Peers absent from ``hier_domains`` classify as domain "" and never
    # form sub-quorums.
    hier_commit: bool = False
    hier_domains: Dict[int, str] = field(default_factory=dict)

    def validate(self) -> None:
        # mirrors reference config.Config.Validate (config/config.go:168-223)
        if self.node_id == 0:
            raise ConfigError("invalid NodeID, it must be >= 1")
        if self.heartbeat_rtt == 0:
            raise ConfigError("HeartbeatRTT must be > 0")
        if self.election_rtt == 0:
            raise ConfigError("ElectionRTT must be > 0")
        if self.election_rtt <= 2 * self.heartbeat_rtt:
            raise ConfigError("invalid ElectionRTT, must be > 2 * HeartbeatRTT")
        if self.election_rtt < 10 * self.heartbeat_rtt:
            import warnings

            warnings.warn(
                "ElectionRTT is not a magnitude larger than HeartbeatRTT",
                stacklevel=2,
            )
        if self.max_in_mem_log_size < 0:
            raise ConfigError("MaxInMemLogSize must be >= 0")
        if 0 < self.max_in_mem_log_size < 64 * 1024:
            raise ConfigError("MaxInMemLogSize must be >= 64KB when set")
        if self.snapshot_compression not in (0, 1):
            raise ConfigError("unknown compression type")
        if self.entry_compression not in (0, 1):
            raise ConfigError("unknown compression type")
        if self.is_witness and self.snapshot_entries > 0:
            raise ConfigError("witness node cannot take snapshot")
        if self.is_witness and self.is_observer:
            raise ConfigError("witness node can not be an observer")
        if self.read_lease and not self.check_quorum:
            raise ConfigError("read_lease requires check_quorum")
        if self.read_lease and self.quiesce:
            raise ConfigError("read_lease can not be used with quiesce")
        if self.hier_domains and not isinstance(self.hier_domains, dict):
            raise ConfigError("hier_domains must map node_id -> domain label")
        if self.hier_commit:
            for nid, dom in self.hier_domains.items():
                if not isinstance(nid, int) or nid < 1:
                    raise ConfigError(
                        f"hier_domains key {nid!r} is not a node id"
                    )
                if not isinstance(dom, str):
                    raise ConfigError(
                        f"hier_domains[{nid}] must be a str domain label"
                    )


@dataclass
class ExpertConfig:
    """Expert-only knobs; the plugin boundary for the batched quorum engine.

    ``quorum_engine``:
      - ``"scalar"``: per-group host stepping only (the reference's model).
      - ``"cuda"``: route hot-path group stepping through the batched
        ``(nGroups, nPeers)`` device engine
        (:mod:`dragonboat_tpu_torch.ops`, hand-written CUDA kernels); the
        reference calls this engine ``"tpu"``.
      - ``"auto"``: resolved at NodeHost construction: ``scalar`` when the
        native fast lane is active, else ``cuda`` iff a probe dispatch
        fits the commit-latency budget.
    """

    quorum_engine: str = "scalar"
    engine_block_groups: int = 0  # 0 = use Soft.quorum_engine_block_groups
    # AOT warm-compile the engine's fused (K,G,P) program set on a
    # background thread at NodeHost construction: until the
    # readiness latch flips, the coordinator's round thread stays on the
    # already-compiled single-round programs, so proposals never block
    # behind a first-use kernel load or build; once ready, tick backlogs replay as
    # ONE adaptive-K fused dispatch.  Off = the live path stays
    # single-round forever (the pre-warmup behavior).
    engine_warm_fused: bool = True
    # shard the quorum engine's group axis over this many devices
    # (the reference's ops/sharding.py; ROADMAP A item 6 in the port):
    # state tensors split on the
    # group axis, event batches replicated, zero collectives in steady
    # state — the multi-chip twin of the reference's clusterID%workers
    # partitioning (execengine.go:654-706).  0 = single device; capped at
    # the available device count; capacity rounds up to a multiple.
    engine_mesh_devices: int = 0
    step_worker_count: int = 0  # 0 = use Hard.step_engine_worker_count
    logdb_shards: int = 0  # 0 = use Hard.logdb_pool_size
    # native replication fast lane (fastlane.py + native/natraft.cpp): the
    # steady-state data plane of enrolled groups runs in C++.  Requires the
    # TCP transport and the native LogDB backend; silently unavailable
    # otherwise.
    fast_lane: bool = False
    # group-commit accumulation window per WAL shard (ms): pacing fsyncs
    # multiplies batch depth when the flush device is the bottleneck, at
    # the cost of up to this much added commit latency per durability hop
    fast_lane_commit_window_ms: float = 0.0
    # ---- compartmentalized host plane (hostplane.py) ----
    # master switch: build the proposal ingress batcher, the cross-shard
    # group-commit WAL flusher and the decoupled apply/egress executor
    # pools.  OFF (default) constructs none of it — the scalar host path
    # stays bit-identical to the pre-compartment build.
    host_compartments: bool = False
    # striped ingress staging shards (0 = 2).  One group always maps to
    # one shard, so a client's back-to-back proposals stay ordered.
    host_ingress_shards: int = 0
    # per-shard staging-ring capacity (0 = 4x incoming_proposal_queue_length);
    # a full ring raises SystemBusyError like a full entry_q
    host_ingress_ring: int = 0
    # shared-flusher accumulation window (ms): 0 flushes whatever is
    # queued when the flusher wakes (concurrency alone provides the
    # cross-committer merge); >0 trades up to that much commit latency
    # for deeper fsync amortization
    host_wal_window_ms: float = 0.0
    # dedicated apply / client-completion egress executors (0 = 2 / 1)
    host_apply_workers: int = 0
    host_egress_workers: int = 0
    # ---- multi-process host plane (hostproc/) ----
    # promote the host-plane stages to WORKER PROCESSES connected by
    # shared-memory staging rings: ingress payload encode, the
    # group-commit redo-journal append+fsync, and an apply tier for
    # state machines with process-spawnable factories (see
    # the reference's hostproc.spawnable).  0 (default) = today's
    # in-process path, structurally bit-identical; N > 0 spawns N
    # workers and implies the compartmentalized host plane (the worker
    # tiers are its stages' execution resources).  Worker crash/exit
    # falls back in-process mid-flight with nothing acked-before-fsync
    # violated; cap N at os.cpu_count() — extra workers only add
    # handoffs.
    host_workers: int = 0
    # group-commit journal strategy for the host plane's WAL tier:
    #   "auto"  — a startup fsync probe picks journaled vs classic
    #             per-shard saves (min-of-samples, robust to a
    #             GIL-polluted probe);
    #   "force" — always journal; the probe still runs (re-probed with
    #             extra samples) but only paces the accumulation window;
    #   "off"   — never journal (classic merged per-shard saves).
    # The chosen strategy is introspectable via NodeHost.wal_status().
    host_wal_journal: str = "auto"
    # filesystem the snapshot paths go through; None = the real OS fs.
    # Setting a vfs.MemFS runs the whole stack diskless (reference memfs
    # builds); a vfs.ErrorFS enables fault-injection testing and is
    # auto-detected like the reference's nodehost.go:321-327
    fs: object = None

    def validate(self) -> None:
        if self.quorum_engine not in ("scalar", "cuda", "auto"):
            raise ConfigError(f"unknown quorum engine {self.quorum_engine!r}")
        if self.host_workers < 0:
            raise ConfigError("host_workers must be >= 0")
        if self.host_wal_journal not in ("auto", "force", "off"):
            raise ConfigError(
                f"unknown host_wal_journal {self.host_wal_journal!r}"
            )


@dataclass
class LogDBConfig:
    """LogDB tuning (reference ``config/config.go`` LogDBConfig).

    The reference exposes RocksDB-style block/cache/WAL knobs; the native
    engine is a segmented WAL+index (the reference's ``native/``), so
    the surface is the subset that translates.
    """

    kv_write_buffer_size: int = 128 * 1024 * 1024
    kv_max_write_buffer_number: int = 4
    kv_block_size: int = 32 * 1024
    kv_max_background_compactions: int = 2
    segment_file_size: int = 1024 * 1024 * 1024
    shards: int = 16
    # fsync every committed write batch (the reference always does; turning
    # this off trades durability of the last instants for throughput and is
    # only for benchmarks/tests — results must report it)
    fsync: bool = True

    @staticmethod
    def default() -> "LogDBConfig":
        return LogDBConfig()

    @staticmethod
    def tiny() -> "LogDBConfig":
        # reference GetTinyMemLogDBConfig: fit small-memory hosts
        return LogDBConfig(kv_write_buffer_size=4 * 1024 * 1024)


@dataclass
class NodeHostConfig:
    """Per-host configuration (reference ``config/config.go:226-576``)."""

    deployment_id: int = 0
    wal_dir: str = ""
    node_host_dir: str = ""
    rtt_millisecond: int = 200
    raft_address: str = ""
    listen_address: str = ""
    mutual_tls: bool = False
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    max_send_queue_size: int = 0
    max_receive_queue_size: int = 0
    enable_metrics: bool = False
    max_snapshot_send_bytes_per_second: int = 0
    max_snapshot_recv_bytes_per_second: int = 0
    notify_commit: bool = False
    # persistent compilation cache directory for the batched quorum
    # engine: restarts deserialize the warmed device programs
    # instead of recompiling (the directory is versioned internally by a
    # kernel-source hash, so kernel changes never mix stale executables;
    # point several hosts at one shared directory to amortize the first
    # compile across the fleet).  Empty = no persistent cache.  The
    # port's kernels build once into a library keyed on a source hash
    # (ops/_build.py), so its coordinator takes no cache directory.
    compilation_cache_dir: str = ""
    # cross-plane request tracing (obs/trace.py): sample 1 in N
    # requests into a full per-stage trace context (ingress → raft step →
    # WAL → device round → apply → egress), publish
    # dragonboat_trace_stage_seconds{stage} / dragonboat_trace_e2e_seconds
    # into this host's registry, and enable NodeHost.dump_trace (Chrome
    # trace / Perfetto export).  0 (default) = tracing off, request paths
    # bit-identical.
    trace_sample_every: int = 0
    # opt-in SIGUSR2 live-debug dump: on signal, write the flight
    # recorder ring + any in-flight/completed sampled traces to a
    # timestamped JSON file next to the node host dir (soak/chaos
    # debugging without attaching a debugger)
    dump_signal: bool = False
    # cluster health plane (obs/health.py): sample every
    # group's raft/host-plane health on this cadence (driven off the
    # tick worker) into a rolling ring, run the anomaly detectors
    # (commit-stall, apply-lag, quorum-at-risk, leader-flap,
    # worker-flap, lease-thrash, devsm-rebind) and publish the
    # dragonboat_health_* families + NodeHost.health_report().  0
    # (default) = health plane off, nothing constructed, request paths
    # bit-identical.
    health_sample_ms: int = 0
    # aggregate health sampling (kernels.telem_fold): flip the
    # quorum engine's device telemetry fold and teach the health sampler
    # to cover device-backed groups from the fixed-size per-dispatch
    # aggregate (commit-lag histogram, per-state counts, stalled count,
    # slot occupancy, on-device top-K worst groups) at O(shards) host
    # cost — only the top-K flagged groups plus non-device groups take
    # the per-group raft_mu walk.  Requires the health plane
    # (health_sample_ms > 0) and the device quorum engine; without
    # either it logs a warning and changes nothing.  False (default) =
    # fold off, engine programs byte-identical, sampler walks every
    # group.
    health_aggregate: bool = False
    # live scrape endpoint (obs/health.py MetricsServer): "host:port"
    # serves /metrics (Prometheus text exposition), /healthz
    # (aggregated detector verdict, 503 while degraded) and
    # /debug/health + /debug/trace dumps.  Empty (default) = no
    # listener; bind loopback ("127.0.0.1:9090") unless you front it
    # with auth — the exposition names clusters and addresses.  Port 0
    # binds ephemeral (NodeHost.metrics_server.port).
    metrics_addr: str = ""
    # closed-loop recovery plane (obs/recovery.py): let the
    # health detectors ACTUATE — quorum_at_risk evicts the unreachable
    # voter and promotes a standing observer (or adds a standby
    # witness, the BlackWater move), leader_flap transfers leadership
    # away from the flapping hosts, devsm_rebind force-releases the
    # device binding, commit_stall re-drives the fast-lane
    # eject/re-enroll path; worker_flap stays observe-only (the
    # hostproc monitor owns respawn).  Every action is rate-limited per
    # group, cooldown-gated and flap-damped (RecoveryController
    # guardrails).  Requires the health plane (health_sample_ms > 0) —
    # auto_recover without it logs a warning and constructs nothing.
    # False (default) = recovery off, nothing constructed, no sampler
    # subscription, request paths bit-identical.
    auto_recover: bool = False
    # dry-run for the recovery plane: decisions run end to end and are
    # logged/counted (dragonboat_recovery_dryrun_total) but no
    # remediation executes.
    auto_recover_dry_run: bool = False
    # guardrail/behavior overrides for the RecoveryController
    # (rate_limit_s, cooldown_s, max_reopens, reopen_window_s,
    # action_timeout_s, workers, max_attempts, retry_delay_s,
    # standby_witness_addrs) — merged over the controller defaults;
    # unknown keys raise at construction.
    auto_recover_knobs: Dict[str, object] = field(default_factory=dict)
    # wall-clock lease guard (lease.py, caught by a churn soak): the
    # leader lease's validity clock is the event loop's tick counter — a
    # CPU-starved or descheduled leader ticks slower than wall time, so
    # its tick-valid lease can outlive the majority's wall-time election
    # and serve a stale read.  True additionally bounds validity by
    # monotonic wall time (quorum-th newest ack within
    # duration * rtt_millisecond wall seconds) — strictly conservative:
    # starvation can only expire the lease early, never extend it.
    # Default off: tick-driven virtual-clock tests stay deterministic.
    lease_wall_guard: bool = False
    # device capacity & profiling plane (obs/devprof.py):
    # N > 0 attaches a DevProf to the batched quorum engine — the HBM
    # memory ledger + capacity model (dragonboat_devprof_hbm_bytes /
    # max-groups extrapolation), fused padding-waste accounting, and a
    # device-time estimator that samples every N-th dispatch with a
    # blocking block_until_ready delta (N is this value; 16 is the
    # measured-overhead default).  Enables NodeHost.profile_device
    # (on-demand profiler capture windows) and the read-only
    # /debug/devprof endpoint on the MetricsServer.  0 (default) =
    # nothing constructed, the engine keeps its bit-identical
    # _devprof=None path.  Inert without the cuda quorum engine (the plane profiles
    # the device engine).
    device_profile: int = 0
    logdb_config: LogDBConfig = field(default_factory=LogDBConfig.default)
    expert: ExpertConfig = field(default_factory=ExpertConfig)
    # factories (reference config/config.go:298-305)
    logdb_factory: Optional[Callable] = None
    raft_rpc_factory: Optional[Callable] = None
    # user event listeners (reference raftio/listener.go:33,59)
    raft_event_listener: Optional[object] = None
    system_event_listener: Optional[object] = None
    fs: Optional[object] = None  # vfs override for tests

    def validate(self) -> None:
        if self.rtt_millisecond == 0:
            raise ConfigError("invalid RTTMillisecond")
        if not self.node_host_dir:
            raise ConfigError("NodeHostDir not specified")
        if not self.raft_address:
            raise ConfigError("RaftAddress not specified")
        if not _valid_address(self.raft_address):
            raise ConfigError(f"invalid RaftAddress {self.raft_address!r}")
        if self.listen_address and not _valid_address(self.listen_address):
            raise ConfigError(f"invalid ListenAddress {self.listen_address!r}")
        if self.mutual_tls and (
            not self.ca_file or not self.cert_file or not self.key_file
        ):
            raise ConfigError("CAFile/CertFile/KeyFile must be set for mutual TLS")
        self.expert.validate()

    def prepare(self) -> None:
        if not self.listen_address:
            self.listen_address = self.raft_address
        if self.deployment_id == 0:
            self.deployment_id = 1

    def get_deployment_id(self) -> int:
        return self.deployment_id if self.deployment_id else 1

    def get_listen_address(self) -> str:
        return self.listen_address or self.raft_address


def _valid_address(addr: str) -> bool:
    # host:port validation (reference utils/stringutil IsValidAddress)
    if ":" not in addr:
        return False
    host, _, port = addr.rpartition(":")
    if not host:
        return False
    try:
        p = int(port)
    except ValueError:
        return False
    return 0 < p < 65536
