"""Device-layout registry — the port's copy of the JAX package's tables.

The packed state layout, the reduction-lane order the round kernels
emit their partial sums in, and every other tuple that the JAX package's
``sim/registry.py`` folds into ``layout_digest()``. The port keeps its own
copy (it imports nothing of ``consul_tpu``); the tests pin
``layout_digest()`` equal to the reference's, so a layout change on
either side fails loudly.

Pure data: no torch import.
"""

from __future__ import annotations

import hashlib

# ------------------------------------------------- telemetry layouts
FLIGHT_GAUGE_COLUMNS = ("t", "live_frac", "mean_informed", "suspect_frac",
                        "wrong_frac", "mean_local_health",
                        "max_local_health", "inc_bumps", "fault_phase")
FLIGHT_COORD_COLUMNS = ("rtt_err_med", "rtt_err_p99", "coord_drift")
BLACKBOX_RECORD_FIELDS = ("round", "event", "peer", "detail")
BLACKBOX_EVENTS = ("phase_enter", "crash", "leave", "rejoin", "probe_ack",
                   "probe_timeout", "indirect_fanout", "coord_late",
                   "suspect_start", "suspect_confirm", "refute", "inc_bump",
                   "declare_dead", "attack_suspect_start",
                   "attack_false_positive")
BLACKBOX_PROBE_EVENTS = ("probe_ack", "probe_timeout", "indirect_fanout",
                         "coord_late")

# ------------------------------------------------- bit-packed state
#: per-node field -> (packed dtype, bytes), in SimState field order.
#: Liveness packs into down_age's sentinel range (-1 live, -2 live+slow,
#: >= 0 dead for that many ticks): 15 B/node in all.
STATE_PACKED_FIELDS = (
    ("status", "int8", 1),
    ("incarnation", "int16", 2),
    ("informed", "float32", 4),
    ("down_age", "int16", 2),
    ("susp_len", "int16", 2),
    ("susp_ttl", "int16", 2),
    ("susp_conf", "int8", 1),
    ("local_health", "int8", 1),
)

#: every per-node time field counts protocol periods
TICK_QUANTUM = "probe_interval"

#: saturation caps of the narrowing stores: int16 tick/count lanes and
#: the int8 confirmation counter
TICK_MAX = 32767
CONF_MAX = 127

LIVENESS_ENCODING = ("-1=live", "-2=live+slow", ">=0=dead_age_ticks")

#: SimStats counter lanes, in the order the kernels emit their sums
STATS_FIELDS = ("suspicions", "refutes", "false_positives",
                "true_deaths_declared", "detect_latency_sum",
                "crashes", "rejoins", "leaves",
                "attack_suspicions", "attack_false_positives")

FAULT_KINDS = ("Partition", "NodeLoss", "SlowNodes", "Flap", "Duplicate",
               "ChurnBurst")
BYZANTINE_FAULT_KINDS = ("ForgedAcks", "SpuriousSuspicion", "Eclipse",
                         "StaleReplay")

# ------------------------------------------------------ reduction lanes
#: stale-scalar population lanes (raw sums; the clamps n_elig >= 1,
#: n_up_elig / lfail_den >= 1e-9 are applied after the reduction)
LANE_SCALARS = ("n_live", "n_elig", "n_up_elig", "n_slow_up_elig",
                "pf_fast_sum", "pf_slow_sum", "lfail_num", "lfail_den")
LANE_GAUGES = ("up_sum", "informed_sum", "suspect_sum", "wrong_sum",
               "lh_sum", "inc_sum")
LANE_LH_HIST = tuple(f"lh_ge_{k}" for k in range(1, 9))

#: the first len(LANE_SCALARS) + len(STATS_FIELDS) lanes are the partial
#: sums each round kernel block writes, in this order
REDUCE_LANES = LANE_SCALARS + STATS_FIELDS + LANE_GAUGES + LANE_LH_HIST
N_REDUCE_LANES = len(REDUCE_LANES)
LANE = {name: i for i, name in enumerate(REDUCE_LANES)}
LANE_BLOCKS = 64

STALE_EMISSION_RULE = "record_every % stale_k == 0"
STALE_KS = (1, 2, 4, 8)

# ---------------------------------------------------------- sweep axes
SWEEP_AXES = ("probe_interval", "probe_timeout", "gossip_interval",
              "gossip_nodes", "suspicion_mult",
              "suspicion_max_timeout_mult", "awareness_max", "loss",
              "tcp_fail", "slow_per_round", "slow_recover_per_round",
              "slow_factor", "coord_timeout_mult", "fail_per_round",
              "rejoin_per_round", "leave_per_round", "fault_gain",
              "corroboration_k")
SWEEP_DERIVED = (
    ("gossip_ticks_per_round", ("probe_interval", "gossip_interval")),
    ("suspicion_min_s", ("probe_interval", "suspicion_mult")),
    ("suspicion_max_s", ("probe_interval", "suspicion_mult",
                         "suspicion_max_timeout_mult")),
    ("confirmation_k", ("suspicion_mult",)),
    ("shrink_r", ("probe_interval", "suspicion_mult",
                  "suspicion_max_timeout_mult")),
    ("shrink_omr", ("probe_interval", "suspicion_mult",
                    "suspicion_max_timeout_mult")),
    ("fanout_ticks", ("probe_interval", "gossip_interval",
                      "gossip_nodes")),
    ("one_minus_loss", ("loss",)),
    ("p_direct", ("loss",)),
    ("p_relay", ("loss",)),
    ("p_tcp", ("tcp_fail",)),
)
SWEEP_INT_LEAVES = ("awareness_max", "confirmation_k", "corroboration_k")

# ----------------------------------------------------- checkpoint format
CHECKPOINT_VERSION = 1
CHECKPOINT_HEADER_FIELDS = ("version", "engine", "round_cursor",
                            "total_rounds", "base_key", "layout_digest",
                            "params_digest", "params", "plan_digest",
                            "arrays", "payload_sha256")
CHECKPOINT_CARRIES = ("lanes", "scalars", "table", "flight", "blackbox",
                      "coords", "topo")
MESH_LADDER_ROW = ("devices", "n", "stale_k", "loadavg_1m",
                   "rounds_per_sec", "ms_per_round", "dev_ms_min",
                   "dev_ms_max", "dev_skew", "weak_scaling_efficiency")

# ----------------------------------------------- kernel-plane cost model
PROFILE_SCHEMA_VERSION = 4
COSTMODEL_ENGINES = ("xla", "fast", "lanes", "overlap", "pallas")
COSTMODEL_BYTE_TERMS = ("state_rw", "uniform_draws", "intermediates",
                        "lane_reduce", "flight", "blackbox")
COSTMODEL_INTERMEDIATE_VECS = (
    ("xla", 104), ("fast", 103), ("lanes", 70), ("overlap", 75),
    ("pallas", 3),
)
COSTMODEL_WINDOW_VECS = 30
COSTMODEL_FLOPS = (
    ("xla", 1940), ("fast", 1820), ("lanes", 1360), ("overlap", 1460),
    ("pallas", 1360),
)
COSTMODEL_FLOP_WINDOW = 750
COSTMODEL_BOUND = 2.0
PROFILE_ROOFLINE_ROW = (
    "config", "engine", "stale_k", "rounds_per_call", "lane_blocks",
    "ms_per_round", "rounds_per_sec",
    "bytes_model", "bytes_measured", "model_vs_measured", "flagged",
    "flops_model", "flops_measured", "temp_bytes_measured",
    "arithmetic_intensity",
    "achieved_gbps", "util", "collectives_per_round",
)
LEDGER_FAMILIES = ("BENCH", "MULTICHIP", "SWEEP", "SERVE", "PROFILE",
                   "BYZ", "CHAOS", "COORDS", "TUNE", "TWIN", "USERS",
                   "RAFT")
TWIN_RUNG_KEYS = ("n", "rounds", "join_s", "member_view_err_post_heal",
                  "converge_rounds", "agent_p50_ms", "agent_p99_ms",
                  "jain_fairness", "rumors_sent", "rumors_shed",
                  "resume_digest_equal")
TWIN_CONVERGE_TOL = 0.005
USERS_SURFACES = ("dns", "kv_get", "kv_get_stale", "kv_put", "catalog",
                  "health", "watch")
USERS_RUNG_KEYS = ("target_rps", "duration_s", "offered", "completed",
                   "rejected", "errors", "achieved_rps", "p50_ms",
                   "p99_ms", "window_rps", "surfaces", "gauges")
USERS_SURFACE_KEYS = ("offered", "completed", "rejected", "errors",
                      "p50_ms", "p99_ms", "jain_users")
RAFT_STAGES = ("raft.append", "raft.replicate.rtt", "raft.quorum_wait",
               "raft.apply_batch")
RAFT_RUNG_KEYS = ("target_rps", "duration_s", "offered", "completed",
                  "errors", "achieved_rps", "p50_ms", "p99_ms",
                  "commit_p50_ms", "commit_p99_ms", "stage_p50_ms",
                  "stage_share_p50", "coverage_p50", "commit_batch",
                  "apply_batch", "follower_lag", "window_rps")
RAFT_COVERAGE_MIN = 0.90
RAFT_SHARD_STAGE_PREFIX = "raft.shard."
RAFT_SHARD_KEYS = ("commit_p50_ms", "commit_p99_ms", "commit_batches",
                   "stage_p50_ms", "stage_share_p50", "coverage_p50",
                   "commit_batch", "apply_batch")


def raft_shard_stages(shard_id: int) -> tuple:
    """The commit-pipeline stage names of one consensus group: every
    RAFT_STAGES entry re-rooted under ``raft.shard.<id>.``."""
    p = f"{RAFT_SHARD_STAGE_PREFIX}{int(shard_id)}."
    return tuple(p + s.split("raft.", 1)[1] for s in RAFT_STAGES)


AUTOTUNE_WINNER_KEYS = ("config", "engine", "stale_k",
                        "rounds_per_call", "lane_blocks",
                        "rounds_per_sec")
AUTOTUNE_LANE_BLOCKS = (32, 64, 128)


def layout_digest() -> str:
    """Fingerprint over every layout tuple (order-sensitive) — the same
    groups, in the same order, as the JAX package's digest."""
    h = hashlib.sha256()
    for group in (FLIGHT_GAUGE_COLUMNS, STATS_FIELDS,
                  FLIGHT_COORD_COLUMNS, BLACKBOX_RECORD_FIELDS,
                  BLACKBOX_EVENTS, BLACKBOX_PROBE_EVENTS,
                  tuple(f"{n}:{d}:{b}"
                        for n, d, b in STATE_PACKED_FIELDS),
                  (TICK_QUANTUM, str(TICK_MAX), str(CONF_MAX)),
                  LIVENESS_ENCODING,
                  AUTOTUNE_WINNER_KEYS,
                  tuple(str(b) for b in AUTOTUNE_LANE_BLOCKS),
                  REDUCE_LANES, (str(LANE_BLOCKS),),
                  (STALE_EMISSION_RULE,),
                  tuple(str(k) for k in STALE_KS),
                  SWEEP_AXES,
                  tuple(f"{d}<-{','.join(deps)}"
                        for d, deps in SWEEP_DERIVED),
                  SWEEP_INT_LEAVES,
                  FAULT_KINDS, BYZANTINE_FAULT_KINDS,
                  (str(CHECKPOINT_VERSION),),
                  CHECKPOINT_HEADER_FIELDS, CHECKPOINT_CARRIES,
                  MESH_LADDER_ROW,
                  (str(PROFILE_SCHEMA_VERSION),),
                  COSTMODEL_ENGINES, COSTMODEL_BYTE_TERMS,
                  tuple(f"{e}={v}"
                        for e, v in COSTMODEL_INTERMEDIATE_VECS),
                  (str(COSTMODEL_WINDOW_VECS),),
                  tuple(f"{e}={v}" for e, v in COSTMODEL_FLOPS),
                  (str(COSTMODEL_FLOP_WINDOW), str(COSTMODEL_BOUND)),
                  PROFILE_ROOFLINE_ROW, LEDGER_FAMILIES,
                  TWIN_RUNG_KEYS, (str(TWIN_CONVERGE_TOL),),
                  USERS_SURFACES, USERS_RUNG_KEYS,
                  USERS_SURFACE_KEYS,
                  RAFT_STAGES, RAFT_RUNG_KEYS,
                  (str(RAFT_COVERAGE_MIN),),
                  (RAFT_SHARD_STAGE_PREFIX,), RAFT_SHARD_KEYS):
        h.update("|".join(group).encode())
        h.update(b";")
    return h.hexdigest()[:16]
