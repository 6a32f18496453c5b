"""Black-box event tracer: per-agent event rings, as tensors.

The port of the JAX package's ``consul_tpu/sim/blackbox.py``. K tracked
agents each get a ``[R, 4]`` int32 ring of ``(round, event, peer,
detail)`` records and a count of events emitted (the write slot is
``count % R``, so a ring keeps the most recent R records):

* codes are ``registry.BLACKBOX_EVENTS`` (the tuple index is the code);
* rings are written only on rounds the flight recorder records, so the
  tracer rides the recorder's decimation;
* state-machine events (churn, suspect start and confirm, refute,
  incarnation bump, declare) come from the tracked agents' state diff
  between recorded rounds, the same derivation on every engine; the
  prober-side probe events (ack, timeout, indirect fan-out, coordinate
  deadline) ride the live engine's round body (``ProbeEvents``);
* everything is fetched once, after the run.

``record`` writes one round's events in one pass where the reference
emits each code with its own gather and scatter: the masks stack into
an [events, K] tensor in code order, a cumulative count gives each
event its position in its agent's stream, and one scatter-add writes
the records that stay in the ring (the last R of the agent's stream). The
rings and counts are the reference's, order within a round included.

Host side: ``decode_timeline`` unwraps the rings, ``event_totals``
sums them (cross-checked against the flight counters in
``metrics.blackbox_report``), ``suspicion_episodes`` folds a timeline
into suspicion windows and ``to_perfetto`` exports Chrome-trace JSON.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from consul_tpu_torch.sim.registry import (BLACKBOX_EVENTS,
                                           BLACKBOX_PROBE_EVENTS,
                                           BLACKBOX_RECORD_FIELDS)
from consul_tpu_torch.sim.state import ALIVE, DEAD, LEFT, SUSPECT
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: decoder tables — the index is the event code
EVENT_NAMES = BLACKBOX_EVENTS
EV = {name: i for i, name in enumerate(EVENT_NAMES)}
RECORD_FIELDS = BLACKBOX_RECORD_FIELDS
N_REC = len(RECORD_FIELDS)

#: defaults mirrored by SimParams.blackbox_k / blackbox_ring
DEFAULT_TRACKED_K = 64
DEFAULT_RING_LEN = 256

_I32 = torch.int32


class BlackboxState(NamedTuple):
    """Ring state of one run. ``prev_*`` hold the tracked agents' state
    at the last recorded round (K-sized)."""

    tracked: torch.Tensor      # [K] int32 — tracked node ids
    ring: torch.Tensor         # [K, R, 4] int32 — event records
    count: torch.Tensor        # [K] int32 — events emitted
    prev_status: torch.Tensor  # [K] int32
    prev_inc: torch.Tensor     # [K] int32
    prev_conf: torch.Tensor    # [K] int32
    prev_up: torch.Tensor      # [K] bool
    last_phase: torch.Tensor   # 0-d int32 — for phase_enter edges


class ProbeEvents(NamedTuple):
    """One round's prober-side probe lifecycle as [N] tensors from the
    live engine's round body; ``late``/``pair_j``/``rtt_us`` are None
    outside coordinate mode."""

    ack: torch.Tensor
    failed: torch.Tensor
    late: Optional[torch.Tensor]
    pair_j: Optional[torch.Tensor]
    rtt_us: Optional[torch.Tensor]


def default_tracked(n: int, k: int = DEFAULT_TRACKED_K,
                    device: DeviceLike = None) -> torch.Tensor:
    """K evenly spaced node ids (they meet every contiguous fault
    range)."""
    k = min(k, n)
    return torch.from_numpy((np.arange(k) * (n // k)).astype(np.int32)) \
        .to(default_device(device))


def _gather(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1)[t].to(_I32)


def init_blackbox(state, tracked: torch.Tensor,
                  ring_len: int = DEFAULT_RING_LEN) -> BlackboxState:
    """Fresh rings for ``tracked``, diffed against the run's initial
    state (so round-0 transitions are real)."""
    dev = state.status.device
    tracked = tracked.to(device=dev, dtype=_I32)
    k = tracked.shape[0]
    t = tracked.to(torch.int64)
    return BlackboxState(
        tracked=tracked,
        ring=torch.zeros((k, ring_len, N_REC), dtype=_I32, device=dev),
        count=torch.zeros((k,), dtype=_I32, device=dev),
        prev_status=_gather(state.status, t),
        prev_inc=_gather(state.incarnation, t),
        prev_conf=_gather(state.susp_conf, t),
        prev_up=_gather(state.up, t) != 0,
        last_phase=torch.full((), -1, dtype=_I32, device=dev))


def _i32_scalar(v, dev) -> torch.Tensor:
    """A 0-d int32 tensor of a host int (a fill) or a copy of a device
    scalar (``faults.phase_at``'s ``[1]`` phase, a state's round)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(_I32, copy=True)
    return torch.full((), v, dtype=_I32, device=dev)


def record(bb: BlackboxState, *, round_idx, phase, status,
           incarnation, susp_conf, up,
           probe: Optional[ProbeEvents] = None, indirect_checks: int = 0,
           attacked: Optional[torch.Tensor] = None) -> BlackboxState:
    """Write one recorded round's events into the rings.

    ``status``/``incarnation``/``susp_conf``/``up`` are the post-round
    [N] tensors (gathered at ``bb.tracked`` here). ``round_idx`` is the
    ABSOLUTE round and ``phase`` the active FaultPlan phase (-1 without
    a plan), host ints or device scalars (a runner a CUDA graph replays
    passes the state's round and ``faults.phase_at``). ``probe`` adds
    the live engine's probe events; ``attacked`` (the round's FaultFrame
    mask, None on honest runs) arms the attack-attribution twins of
    suspect starts and false-positive declarations. Events keep the reference's emit
    order (code order) within a round. The ring is written IN PLACE,
    as the runners update their state: the returned state shares it.

    Every code has a row of the [15, K] event table, all-false where
    its feed is off, so the table's constant columns are a few fills
    whatever the options: a recorded round costs about fifty launches
    (the host's cost per recorded round)."""
    dev = bb.ring.device
    t = bb.tracked.to(torch.int64)
    k, r_len = bb.ring.shape[0], bb.ring.shape[1]
    cur = torch.stack([status.reshape(-1)[t], incarnation.reshape(-1)[t],
                       susp_conf.reshape(-1)[t],
                       up.reshape(-1)[t]]).to(_I32)
    cur_status, cur_inc, cur_conf = cur[0], cur[1], cur[2]
    cur_up = cur[3] != 0

    def fill(v):
        if isinstance(v, torch.Tensor):
            return v.expand(k)
        return torch.full((k,), v, dtype=_I32, device=dev)

    if isinstance(phase, torch.Tensor):
        phase = _i32_scalar(phase, dev)
    if isinstance(round_idx, torch.Tensor):
        round_idx = _i32_scalar(round_idx, dev)

    went_down = bb.prev_up & ~cur_up
    suspect_start = (bb.prev_status != SUSPECT) & (cur_status == SUSPECT)
    declare = (bb.prev_status == SUSPECT) & (cur_status == DEAD)
    bumped = cur_inc > bb.prev_inc
    masks = {
        "phase_enter": (bb.last_phase != phase).expand(k),
        "crash": went_down & (cur_status != LEFT),
        "leave": went_down & (cur_status == LEFT),
        "rejoin": ~bb.prev_up & cur_up,
        "suspect_start": suspect_start,
        "suspect_confirm": (bb.prev_status == SUSPECT)
        & (cur_status == SUSPECT) & (cur_conf > bb.prev_conf),
        "refute": bb.prev_up & cur_up
        & ((bb.prev_status == SUSPECT) | (bb.prev_status == DEAD))
        & (cur_status == ALIVE) & bumped,
        "inc_bump": bumped,
        "declare_dead": declare,
    }
    # 1 on a false-positive declaration
    details = {"suspect_confirm": cur_conf, "refute": cur_inc,
               "inc_bump": cur_inc, "declare_dead": cur[3]}
    if attacked is not None:
        atk = attacked.reshape(-1)[t]
        masks["attack_suspect_start"] = suspect_start & atk
        masks["attack_false_positive"] = declare & cur_up & atk
    peers: dict = {}
    if probe is not None:
        masks["probe_ack"] = probe.ack.reshape(-1)[t]
        masks["probe_timeout"] = probe.failed.reshape(-1)[t]
        masks["indirect_fanout"] = masks["probe_timeout"]
        details["indirect_fanout"] = fill(indirect_checks)
        if probe.late is not None:
            masks["coord_late"] = probe.late.reshape(-1)[t]
        if probe.pair_j is not None:
            pj = probe.pair_j.reshape(-1)[t].to(_I32)
            for name in ("probe_ack", "probe_timeout", "indirect_fanout",
                         "coord_late"):
                peers[name] = pj
        if probe.rtt_us is not None:
            ru = probe.rtt_us.reshape(-1)[t].to(_I32)
            details["probe_ack"] = ru
            details["coord_late"] = ru
    details["phase_enter"] = fill(phase)
    off = torch.zeros((k,), dtype=torch.bool, device=dev)
    zero, none = fill(0), fill(-1)
    n_ev = len(EVENT_NAMES)
    emit = torch.stack([masks.get(nm, off) for nm in EVENT_NAMES])  # [15, K]
    rec = torch.stack([
        fill(round_idx).expand(n_ev, k),
        torch.arange(n_ev, dtype=_I32, device=dev)[:, None].expand(n_ev, k),
        torch.stack([peers.get(nm, none) for nm in EVENT_NAMES]),
        torch.stack([details.get(nm, zero) for nm in EVENT_NAMES]),
    ], dim=-1)                                                   # [15, K, 4]
    # each event's position in its agent's stream; only the last r_len
    # of the stream stay in the ring, so no two written records share a
    # slot and the one scatter-add below is the reference's sequence of
    # writes
    emit_i = emit.to(_I32)
    pos = bb.count + torch.cumsum(emit_i, 0) - 1
    count = pos[-1] + 1
    keep = emit & (pos >= count - r_len)
    flat = (torch.arange(k, device=dev) * r_len
            + (pos % r_len)).reshape(-1, 1)                       # [15*K, 1]
    idx = flat * N_REC + torch.arange(N_REC, device=dev)         # [15*K, 4]
    ring = bb.ring.view(-1)
    # dropped events add zero to whatever slot they name: an integer
    # scatter-add, so the order of the adds does not matter
    ring.scatter_add_(0, idx.reshape(-1), torch.where(
        keep.reshape(-1, 1), rec.reshape(-1, N_REC) - ring[idx], 0)
        .reshape(-1))
    return BlackboxState(
        tracked=bb.tracked, ring=bb.ring, count=count,
        prev_status=cur_status, prev_inc=cur_inc, prev_conf=cur_conf,
        prev_up=cur_up,
        last_phase=_i32_scalar(phase, dev))


# ---------------------------------------------------------- host side


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_timeline(bb: BlackboxState, probe_interval: float = 1.0
                    ) -> dict:
    """One fetch -> ``{node_id: {"events": [...], "dropped": n}}``, each
    event ``{"round", "t", "event", "peer", "detail"}`` in order (``t``
    is the recorded round's end, as in the flight trace's t column);
    ``dropped`` counts the oldest records the ring wrapped away."""
    tracked, ring, count = _np(bb.tracked), _np(bb.ring), _np(bb.count)
    r_len = ring.shape[1]
    out: dict = {}
    for k, node in enumerate(tracked):
        c = int(count[k])
        if c <= r_len:
            recs, dropped = ring[k, :c], 0
        else:
            start = c % r_len
            recs = np.concatenate([ring[k, start:], ring[k, :start]])
            dropped = c - r_len
        events = [{"round": int(rd), "t": float((rd + 1) * probe_interval),
                   "event": EVENT_NAMES[int(ev)], "peer": int(peer),
                   "detail": int(det)} for rd, ev, peer, det in recs]
        out[int(node)] = {"events": events, "dropped": dropped}
    return out


def event_totals(timelines: dict) -> dict:
    """Events per code across all tracked agents."""
    totals = {name: 0 for name in EVENT_NAMES}
    for tl in timelines.values():
        for ev in tl["events"]:
            totals[ev["event"]] += 1
    return totals


def suspicion_episodes(timeline: dict) -> list:
    """One agent's events folded into suspicion episodes: each opens at
    a suspect_start and closes at the next refute or declare_dead (open
    if the run ended mid-suspicion)."""
    episodes: list = []
    open_ep: Optional[dict] = None
    for ev in timeline["events"]:
        name = ev["event"]
        if name == "suspect_start":
            open_ep = {"start_round": ev["round"], "start_t": ev["t"],
                       "confirms": 0, "outcome": None,
                       "end_round": None, "end_t": None}
            episodes.append(open_ep)
        elif open_ep is not None and name == "suspect_confirm":
            open_ep["confirms"] = ev["detail"]
        elif open_ep is not None and name in ("refute", "declare_dead"):
            open_ep["outcome"] = name
            open_ep["end_round"] = ev["round"]
            open_ep["end_t"] = ev["t"]
            if name == "declare_dead":
                open_ep["false_positive"] = bool(ev["detail"])
            open_ep = None
    return episodes


def to_perfetto(timelines: dict, pid: int = 1,
                process_name: str = "consul-tpu-sim",
                time_scale: float = 1e6) -> dict:
    """Chrome-trace JSON from decoded timelines: a thread per tracked
    agent, closed suspicion episodes as "X" spans, every event as an
    instant; ``time_scale`` maps sim seconds to trace µs."""
    events: list = [{"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": process_name}}]
    for node in sorted(timelines):
        tl = timelines[node]
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": node, "args": {"name": f"agent-{node}"}})
        for ep in suspicion_episodes(tl):
            end_t = ep["end_t"]
            if end_t is None:
                continue
            events.append({
                "name": "suspected", "ph": "X", "pid": pid, "tid": node,
                "ts": ep["start_t"] * time_scale,
                "dur": max((end_t - ep["start_t"]) * time_scale, 1.0),
                "args": {"outcome": ep["outcome"],
                         "confirms": ep["confirms"],
                         **({"false_positive": ep["false_positive"]}
                            if "false_positive" in ep else {})}})
        for ev in tl["events"]:
            events.append({
                "name": ev["event"], "ph": "i", "s": "t", "pid": pid,
                "tid": node, "ts": ev["t"] * time_scale,
                "args": {"round": ev["round"], "peer": ev["peer"],
                         "detail": ev["detail"]}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: the codes a kernel runner can record (its probe draws stay in the
#: kernel)
TRANSITION_EVENTS = tuple(n for n in EVENT_NAMES
                          if n not in BLACKBOX_PROBE_EVENTS)
