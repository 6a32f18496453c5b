"""Digital-twin soak: the simulation half, driving a caller's agent.

The port of the JAX package's ``consul_tpu/sim/twin.py``. A twin is one
real Consul agent whose every other cluster member is synthesized from
the batched simulation: the sim runs a FaultPlan (churn, a partition, a
heal) in chunks, and after each chunk a virtual-peer provider turns the
state's changes into wire-level gossip that the agent hears::

    sim rounds (SimHalf: chunked,        agent half (the caller's)
      checkpointed, round_kernel<fault>)   ▲ member view
      │ host copy of 3 lanes  ──────────▶  │ provider.ingest_arrays
      │ clock.advance(chunk·round_s)       │ RPC load clients
      └ checkpoint.save / guard poll       └ /v1/agent/perf

The agent, its in-memory network and the provider are the control
plane (``consul_tpu.agent``, ``consul_tpu.gossip``), which has no JAX
and is not part of this package. The caller passes them in as two
callables, and the soak uses only their duck-typed surface:

* ``build(n, seed, serve_http) -> handle`` with ``handle.provider``
  (``ingest_arrays(status, incarnation, down_age, horizon_s)``, ``n``,
  ``alive``, ``stats``, ``addr_of(i)``), ``handle.clock.advance(s)``,
  ``handle.agent_alive()``, ``handle.view_error()``,
  ``handle.shutdown()``, ``handle.agent.join(addrs)``,
  ``handle.agent.server.rpc.addr`` and ``handle.agent.http`` —
  ``TwinHandle`` below is that shape;
* ``load(handle, clients) -> generator`` with ``start()`` and
  ``finish() -> LoadReport``.

The build must use ``twin_gossip_config()``'s timing: the sim's
``SimParams`` come from it.

The sim half (``SimHalf``) runs the plan on the kernel runner
(``cuda_round.make_run_rounds_cuda(p, step, carry=True, plan=cp)``, one
``round_kernel<fault>`` launch a round) and carries the stale scalars
across chunks as ``checkpoint.run_resumable(engine="cuda")`` does, so
the chunked run is bit for bit the straight one. Each chunk copies the
``status``, ``incarnation`` and ``down_age`` lanes to host memory once
for the provider, saves a checkpoint when asked, and keeps a mid-soak
cut; ``resume_digest_proof`` restores that cut, runs the rounds after
it and compares digests.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.faults import (ChurnBurst, FaultPlan, Partition, Phase,
                                     compile_plan, plan_digest)
from consul_tpu_torch.sim import checkpoint, prng, registry
from consul_tpu_torch.sim.cuda_round import make_run_rounds_cuda
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.state import SimState, _leaves, init_state
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: the full soak's virtual-member ladder
TWIN_LADDER = (65_536, 262_144, 1_048_576)
TWIN_SMOKE_N = 4096

#: post-heal member-view tolerance: the agent's alive count must come
#: within this fraction of the sim's to count as converged
CONVERGE_TOL = registry.TWIN_CONVERGE_TOL


def twin_gossip_config() -> GossipConfig:
    """LAN SWIM timing with push/pull effectively off after the join (a
    periodic full sync would have the agent serialize N members every
    30 s)."""
    return GossipConfig(push_pull_interval=3600.0)


def twin_params(n: int) -> SimParams:
    """The sim's SimParams for an n-member twin."""
    return SimParams.from_gossip_config(twin_gossip_config(), n=n,
                                        tcp_fallback=False)


def twin_plan(n: int, warmup: int = 8, churn: int = 24,
              partition: int = 24, heal: int = 32) -> FaultPlan:
    """The soak's FaultPlan: quiet, a ChurnBurst over the low eighth, a
    hard partition of the low quarter, then heal and recovery."""
    lo8 = (0, max(n // 8, 1))
    lo4 = (0, max(n // 4, 1))
    return FaultPlan(phases=(
        Phase(rounds=warmup, name="warmup"),
        Phase(rounds=churn, name="churn", faults=(
            ChurnBurst(nodes=lo8, crash=0.02, rejoin=0.01),)),
        Phase(rounds=partition, name="partition", faults=(
            Partition(a=lo4, b=(lo4[1], n), drop=1.0, symmetric=True),)),
        Phase(rounds=heal, name="heal"),
    ))


@dataclass
class TwinHandle:
    """A built twin: the network, the provider and the real agent (the
    shape ``build`` returns)."""

    net: Any
    provider: Any
    agent: Any
    gossip: Any
    seed: int

    @property
    def clock(self):
        return self.net.clock

    @property
    def n(self) -> int:
        return self.provider.n

    def agent_alive(self) -> int:
        """The agent's alive virtual-member count (itself excluded)."""
        return self.agent.serf.memberlist.num_alive() - 1

    def sim_alive(self) -> int:
        return int(self.provider.alive.sum())

    def view_error(self) -> float:
        """|agent view − sim ground truth| / n."""
        return abs(self.agent_alive() - self.sim_alive()) / max(self.n, 1)

    def shutdown(self) -> None:
        self.agent.shutdown()


def _sim_alive(handle) -> int:
    return int(handle.provider.alive.sum())


def join_twin(handle, max_virtual_s: float = 300.0,
              step_s: float = 2.0) -> float:
    """Join the agent to the virtual cluster (one push/pull learns the
    whole digest) and advance virtual time until its member view is
    complete. Returns the wall seconds spent."""
    t0 = time.monotonic()
    got = handle.agent.join([handle.provider.addr_of(0)])
    if not got:
        raise RuntimeError("twin join failed: push/pull with vp://0 "
                           "did not complete")
    advanced = 0.0
    while handle.agent_alive() < _sim_alive(handle) \
            and advanced < max_virtual_s:
        handle.clock.advance(step_s)
        advanced += step_s
    return time.monotonic() - t0


# ------------------------------------------------------------ load gen


@dataclass
class LoadReport:
    p50_ms: float
    p99_ms: float
    jain: float
    per_client: list = field(default_factory=list)
    errors: int = 0


def jain_fairness(xs: list) -> float:
    """Jain's index (Σx)²/(k·Σx²): 1.0 when every client got equal
    service, 1/k when one got everything. A starved client counts (a
    zero pulls the index down)."""
    xs = [float(x) for x in xs]
    if not xs:
        return 0.0
    s, s2 = sum(xs), sum(x * x for x in xs)
    return (s * s) / (len(xs) * s2) if s2 else 0.0


# ------------------------------------------------------------ sim half


def _state_digest(state: SimState) -> str:
    """16 hex chars of sha256 over the state's tensors in the
    reference's leaf order (the node lanes, t, round_idx, then the
    counters), on host copies."""
    h = hashlib.sha256()
    for leaf in _leaves(state):
        h.update(np.ascontiguousarray(leaf.detach().cpu().numpy())
                 .tobytes())
    return h.hexdigest()[:16]


def host_lanes(state: SimState) -> tuple:
    """(status, incarnation, down_age) as host numpy arrays: what the
    provider's ``ingest_arrays`` reads, copied once per chunk (copies
    also on the CPU, where the runner goes on updating the state's
    tensors in place)."""
    return tuple(x.to("cpu", copy=True).numpy() for x in
                 (state.status, state.incarnation, state.down_age))


class SimHalf:
    """The soak's simulation: ``plan`` on the kernel runner in chunks of
    ``chunk`` rounds from ``prng.key(seed)``, on ``device`` (the card
    unless ``"cpu"``).

    ``chunks(guard)`` yields ``(cursor, state)`` after each chunk; the
    state's tensors are updated in place, so copy what must outlive the
    next chunk. The stale scalars carry from chunk to chunk. After each
    chunk a ``checkpoint.snapshot(engine="cuda", scalars=...)`` is saved
    to ``ckpt_dir`` when one is given, and the cut at ``mid_cursor`` is
    kept in memory and saved under ``ckpt_dir/mid``, outside the
    rotating window. ``resume=True`` restarts from the newest loadable
    file in ``ckpt_dir``. A tripped ``guard`` stops the chunks before
    the next one and sets ``preempted``."""

    def __init__(self, n: int, plan: FaultPlan, seed: int = 0,
                 chunk: int = 8, ckpt_dir: Optional[str] = None,
                 resume: bool = False, device: DeviceLike = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1: {chunk}")
        self.dev = default_device(device)
        self.p = twin_params(n)
        self.cp = compile_plan(plan, n, self.dev)
        self.plan_digest = plan_digest(self.cp)   # once: it hashes the plan
        self.rounds = plan.total_rounds
        self.chunk = chunk
        self.ckpt_dir = ckpt_dir
        self.key = prng.key(seed, device=self.dev)
        self.state = init_state(n, device=self.dev)
        self.scalars: Optional[torch.Tensor] = None
        self.cursor = 0
        self.resumed_from: Optional[int] = None
        self.mid_cursor = (self.rounds // (2 * chunk)) * chunk
        self.mid_snap: Optional[checkpoint.Snapshot] = None
        self.preempted = False
        self._runners: dict = {}
        if resume and ckpt_dir:
            snap = checkpoint.latest(ckpt_dir, self.p, plan=self.cp)
            if snap is not None:
                if snap.engine != "cuda":
                    raise checkpoint.CheckpointError(
                        f"checkpoint engine {snap.engine!r} != 'cuda'")
                self.state = snap.state(self.dev)
                self.key = snap.key(self.dev)
                self.scalars = snap.scalars(self.dev)
                self.cursor = self.resumed_from = snap.round_cursor

    def _runner(self, step: int):
        if step not in self._runners:
            self._runners[step] = make_run_rounds_cuda(
                self.p, step, carry=True, plan=self.cp)
        return self._runners[step]

    def chunks(self, guard=None) -> Iterator[tuple]:
        while self.cursor < self.rounds:
            if guard is not None and guard.preempted:
                self.preempted = True
                return
            step = min(self.chunk, self.rounds - self.cursor)
            self.state, self.scalars = self._runner(step)(
                self.state, self.key, scalars0=self.scalars)
            self.cursor += step
            self._cut()
            yield self.cursor, self.state

    def _cut(self) -> None:
        at_mid = self.cursor == self.mid_cursor
        if not (self.ckpt_dir or at_mid):
            return
        snap = checkpoint.snapshot(
            self.p, self.key, self.state, engine="cuda",
            total_rounds=self.rounds, scalars=self.scalars, plan=self.cp,
            plan_digest=self.plan_digest)
        if self.ckpt_dir:
            checkpoint.save(self.ckpt_dir, snap)
        if at_mid:
            self.mid_snap = snap
            if self.ckpt_dir:
                checkpoint.save(os.path.join(self.ckpt_dir, "mid"), snap)

    def mid_cut(self) -> Optional[checkpoint.Snapshot]:
        """The mid-soak cut: this run's, or — for a run resumed past the
        midpoint — the one the interrupted run saved under ``mid``."""
        if self.mid_snap is None and self.ckpt_dir:
            return checkpoint.latest(os.path.join(self.ckpt_dir, "mid"),
                                     self.p, plan=self.cp)
        return self.mid_snap


def resume_digest_proof(mid_snap: checkpoint.Snapshot, p: SimParams, cp,
                        want_digest: str,
                        device: DeviceLike = None) -> bool:
    """Restore ``mid_snap`` (a ``SimHalf`` cut), run the rounds after it
    on the kernel runner from its carried scalars, and compare the final
    state's digest with ``want_digest``."""
    dev = default_device(device)
    state = mid_snap.state(dev)
    left = mid_snap.total_rounds - mid_snap.round_cursor
    if left > 0:
        state, _ = make_run_rounds_cuda(p, left, carry=True, plan=cp)(
            state, mid_snap.key(dev), scalars0=mid_snap.scalars(dev))
    return _state_digest(state) == want_digest


# ------------------------------------------------------------ the soak


def fetch_perf(http_addr: str) -> dict[str, Any]:
    """``/v1/agent/perf`` over the agent's HTTP surface; {} when the
    fetch fails."""
    try:
        with urllib.request.urlopen(
                f"http://{http_addr}/v1/agent/perf?min_count=1",
                timeout=10.0) as resp:
            return json.loads(resp.read())
    except Exception:  # noqa: BLE001
        return {}


def _perf_excerpt(snap: dict[str, Any]) -> dict[str, Any]:
    """The stage lines a record quotes: every rpc.* and http.* stage's
    count/p50/p99 and the worker-pool gauges."""
    stages = {}
    for name, st in (snap.get("Stages") or {}).items():
        if name.startswith(("rpc.", "http.")):
            stages[name] = {"Count": st.get("Count"),
                            "P50Ms": st.get("P50Ms"),
                            "P99Ms": st.get("P99Ms")}
    gauges = {k: v for k, v in (snap.get("Gauges") or {}).items()
              if k.startswith(("rpc.workers.", "rpc.blocking.",
                               "catalog.near_sort."))}
    return {"stages": stages, "gauges": gauges}


def run_twin_soak(n: int, build: Callable, load: Callable, seed: int = 0,
                  plan: Optional[FaultPlan] = None, chunk: int = 8,
                  load_clients: int = 8, guard=None,
                  ckpt_dir: Optional[str] = None, resume: bool = False,
                  serve_http: bool = True,
                  progress: Optional[Callable[[str], None]] = None,
                  device: DeviceLike = None) -> dict[str, Any]:
    """One rung: build the caller's agent half, join it, run the plan
    through ``SimHalf`` with the provider fed after every chunk and the
    load running throughout, settle, and prove the resume digest.
    Returns the TWIN rung (``registry.TWIN_RUNG_KEYS``, plus
    ``sim_stats``, ``sim_digest``, ``plan_digest`` and ``perf``), or a
    ``{"preempted": True, ...}`` stub when ``guard`` trips mid-soak."""
    say = progress or (lambda msg: None)
    plan = plan or twin_plan(n)
    rounds = plan.total_rounds
    heal_start = plan.starts[-1]
    sim = SimHalf(n, plan, seed=seed, chunk=chunk, ckpt_dir=ckpt_dir,
                  resume=resume, device=device)
    round_s = sim.p.probe_interval
    handle = build(n, seed, serve_http)
    try:
        say(f"n={n}: joining the virtual cluster")
        join_s = join_twin(handle)
        join_err = handle.view_error()
        say(f"n={n}: joined in {join_s:.1f}s wall "
            f"(view err {join_err:.4f}); soaking {rounds} rounds")
        if sim.resumed_from is not None:
            say(f"n={n}: resumed @ round {sim.resumed_from}")
        # the provider's view starts from the (possibly resumed) state
        handle.provider.ingest_arrays(*host_lanes(sim.state),
                                      horizon_s=0.001)
        handle.clock.advance(0.01)

        gen = load(handle, load_clients)
        gen.start()
        converge_rounds = None
        t_soak = time.monotonic()
        prev = sim.cursor
        for cursor, state in sim.chunks(guard):
            step, prev = cursor - prev, cursor
            handle.provider.ingest_arrays(*host_lanes(state),
                                          horizon_s=step * round_s * 0.8)
            handle.clock.advance(step * round_s)
            if cursor >= heal_start and converge_rounds is None \
                    and handle.view_error() <= CONVERGE_TOL:
                converge_rounds = cursor - heal_start
        if sim.preempted:
            gen.finish()
            return {"preempted": True, "n": n, "rounds_done": sim.cursor,
                    "rounds": rounds}
        # post-heal settling: suspicion timers and rumors drain
        extra = 0
        while handle.view_error() > CONVERGE_TOL and extra < 120:
            handle.clock.advance(round_s * 4)
            extra += 4
        if converge_rounds is None:
            converge_rounds = (rounds - heal_start) + extra
        report = gen.finish()
        soak_wall = time.monotonic() - t_soak
        say(f"n={n}: soak done in {soak_wall:.1f}s wall, view err "
            f"{handle.view_error():.4f}")

        perf_snap = {}
        if serve_http and handle.agent.http is not None:
            perf_snap = fetch_perf(handle.agent.http.addr)

        final_digest = _state_digest(sim.state)
        mid = sim.mid_cut()
        resume_equal = None if mid is None else resume_digest_proof(
            mid, sim.p, sim.cp, final_digest, device=sim.dev)
        stats = sim.state.stats
        pstats = handle.provider.stats
        return {
            "n": n, "rounds": rounds, "seed": seed,
            "join_s": round(join_s, 2),
            "join_view_err": round(join_err, 5),
            "soak_wall_s": round(soak_wall, 2),
            "member_view_err_post_heal": round(handle.view_error(), 5),
            "converge_rounds": int(converge_rounds),
            "agent_p50_ms": report.p50_ms,
            "agent_p99_ms": report.p99_ms,
            "jain_fairness": report.jain,
            "load_requests": int(sum(report.per_client)),
            "load_errors": int(report.errors),
            "rumors_sent": int(pstats["rumors_sent"]),
            "rumors_shed": int(pstats["rumors_shed"]),
            "refutes": int(pstats["refutes"]),
            "sim_stats": {
                "crashes": int(stats.crashes),
                "rejoins": int(stats.rejoins),
                "false_positives": int(stats.false_positives),
                "refutes": int(stats.refutes)},
            "sim_digest": final_digest,
            "plan_digest": sim.plan_digest,
            "resume_digest_equal": bool(resume_equal),
            "perf": _perf_excerpt(perf_snap),
        }
    finally:
        handle.shutdown()


def smoke_guard_plan(n: int) -> FaultPlan:
    """The shorter plan the smoke guard (and ``--family TWIN``) runs."""
    return twin_plan(n, warmup=4, churn=12, partition=12, heal=24)


def smoke_guard_samples(build: Callable, load: Callable, samples: int = 3,
                        n: int = TWIN_SMOKE_N, seed: int = 0,
                        device: DeviceLike = None) -> dict[str, Any]:
    """The envelope the TWIN regression guard re-measures: ``samples``
    short smoke twins and their convergence rounds. A sample that never
    converged is refused (its capped converge_rounds must not become a
    baseline)."""
    plan = smoke_guard_plan(n)
    rows = []
    for i in range(samples):
        rung = run_twin_soak(n, build, load, seed=seed + i, plan=plan,
                             load_clients=2, serve_http=False,
                             ckpt_dir=None, device=device)
        if rung["member_view_err_post_heal"] > CONVERGE_TOL:
            raise RuntimeError(
                "smoke-guard sample never converged (view err "
                f"{rung['member_view_err_post_heal']}) — the bridge is "
                "broken; refusing to bake the capped converge_rounds "
                "into a baseline")
        rows.append(int(rung["converge_rounds"]))
    return {"n": n, "rounds": plan.total_rounds,
            "converge_rounds": int(statistics.median(rows)),
            "samples": rows}
