"""FaultPlan: time-phased fault injection for the batched simulation.

The port's counterpart of the JAX package's ``consul_tpu/faults.py``.
The plan types and the compile-time fold are numpy and are kept here as
a copy of that module's jax-free part (the port imports nothing of the
JAX package): ``node_mask``, the ten primitives (six honest, four
byzantine), ``Phase``, ``FaultPlan`` and ``_phase_arrays``, which folds
a phase into per-node mean-field tensors in float64 numpy so that every
array equals the reference's bit for bit. The module docstring there
derives the fold (psend, precv, suspw, hear_w, mid).

The tensor half replaces the reference's jnp half:

* ``compile_plan(plan, n, device)`` — per-phase tensors on a device, in
  the reference's dtypes (f32 lanes, bool masks, int32 ``flap_half`` and
  ``starts``; byzantine leaves only for a byzantine plan);
* ``plan_digest`` — the same 16-hex fingerprint as the reference's for
  the same plan (checkpoints key on it);
* ``shard_plan`` — a mesh rank's columns of a plan;
* ``active_phase``, ``fault_frame`` and ``scale_frame`` — one round's
  view. The round index is a Python int here: the phase lookup runs on
  the host from a ``PlanSchedule`` read once per run, and the lanes a
  round does not rewrite are views of the plan's phase rows;
  ``scale_plan`` blends a whole plan once for a runner with a fixed gain;
* ``phase_at`` and ``frame_at`` — the same lookup and view with the
  round a device tensor, for the runners a CUDA graph replays: the phase
  is a ``searchsorted`` on the device, and the lanes are materialized by
  one dynamic index on each of the plan's packed tensors (a view would
  bake one phase's pointer into the graph); the flap and release rewrites run
  whenever the plan has them (``any_flap`` / ``any_release``, settled by
  ``compile_plan`` on the host), which leaves a phase that has none as
  it is, so every frame is ``fault_frame``'s bit for bit;
* ``frames_in_place`` — the kernel runner's frames on the card: no lane
  is materialized; each names its phase-0 row of the plan, its stride
  between phases and the device phase, and the ``fault`` / ``byz``
  round kernel reads the phase's row in place (only the flap and
  release rewrites stay fresh lanes);
* ``detection_gate`` (and ``_binom_tail_ge``) for a static
  ``corroboration_k`` and for a swept one (a ``[G, 1]`` leaf of a
  ``params.TracedParams``, where a grid may put k = 0 beside k >= 1).

``FaultInjector``, which drives the discrete host engine
(``consul_tpu/gossip/transport.py``, no JAX), is not part of the port.
"""

from __future__ import annotations

import bisect
import hashlib
import math
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from consul_tpu_torch.utils.platform import DeviceLike, default_device

NodeSpec = Union[None, float, tuple, Sequence[int]]


def node_mask(spec: NodeSpec, n: int) -> np.ndarray:
    """Resolve a node selector to a boolean mask of shape [n].

    Accepted selectors:
      None          — every node
      float f       — the first ceil(f*n) node ids (0 < f <= 1)
      (lo, hi)      — the id range [lo, hi)
      sequence/ids  — explicit node ids
    """
    m = np.zeros((n,), bool)
    if spec is None:
        m[:] = True
    elif isinstance(spec, float):
        if not 0.0 < spec <= 1.0:
            raise ValueError(f"fractional node spec must be in (0,1]: {spec}")
        m[: max(1, math.ceil(spec * n))] = True
    elif isinstance(spec, tuple) and len(spec) == 2 \
            and all(isinstance(x, int) for x in spec):
        lo, hi = spec
        if not 0 <= lo < hi <= n:
            raise ValueError(f"node range {spec} out of [0, {n})")
        m[lo:hi] = True
    else:
        ids = np.asarray(list(spec), np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(f"node ids out of [0, {n})")
        m[ids] = True
    return m


# ------------------------------------------------------------ primitives


@dataclass(frozen=True)
class Partition:
    """Drop traffic from group `a` to group `b` with probability `drop`
    (and the reverse direction too unless symmetric=False)."""

    a: NodeSpec
    b: NodeSpec
    drop: float = 1.0
    symmetric: bool = True


@dataclass(frozen=True)
class NodeLoss:
    """Per-node ingress/egress packet loss on the selected nodes."""

    nodes: NodeSpec
    ingress: float = 0.0
    egress: float = 0.0


@dataclass(frozen=True)
class SlowNodes:
    """Force the selected nodes into the degraded (slow) state for the
    phase: they ack late (params.slow_factor timeliness), the failure
    mode Lifeguard's local-health machinery exists for."""

    nodes: NodeSpec


@dataclass(frozen=True)
class Flap:
    """Selected nodes alternate up/down: up for `half_period` rounds,
    then crashed for `half_period` rounds, repeating for the phase."""

    nodes: NodeSpec
    half_period: int = 5


@dataclass(frozen=True)
class Duplicate:
    """Selected nodes send `copies` independent copies of each message
    (duplication raises delivery odds; each copy faces loss alone)."""

    nodes: NodeSpec = None
    copies: int = 2


@dataclass(frozen=True)
class ChurnBurst:
    """Per-round crash/rejoin/leave probability burst on the group."""

    nodes: NodeSpec = None
    crash: float = 0.0
    rejoin: float = 0.0
    leave: float = 0.0


# ------------------------------------------- byzantine primitives
#
# The adversarial tier (ROADMAP item 3): every fault above is HONEST —
# processes crash, links drop — while these model LYING members, the
# failure mode SWIM's quorumless epidemic design is actually weakest
# against at scale (*Scalable Byzantine Reliable Broadcast*, PAPERS.md,
# supplies the sample-based-quorum defense evaluated through
# SimParams.corroboration_k; *Fair and Efficient Gossip in Hyperledger
# Fabric* frames the eclipse/starvation fairness metrics). Each
# primitive names an `adversaries` selector (the lying members) and a
# `victims` selector (the nodes whose detection/refutation the lie
# targets); the two may never overlap — an adversary lying about
# itself is a different machine (refutation handles it already).


@dataclass(frozen=True)
class ForgedAcks:
    """Adversaries vouch for dead victims: when a probe of a dead
    victim goes indirect, an adversary-captured relay forges an ack,
    suppressing the suspicion that would have started.

    ``coverage`` is the probability that any given indirect-probe relay
    slot for a victim is adversary-controlled (defaults to the
    adversaries' population fraction — uniform relay sampling; set it
    explicitly to model targeted relay-position capture). ``rate``
    scales how often a captured relay actually forges. The defense is
    ``SimParams.corroboration_k``: k-of-m failure-report corroboration
    before a failed probe starts a suspicion."""

    adversaries: NodeSpec
    victims: NodeSpec = None
    coverage: Optional[float] = None
    rate: float = 1.0


@dataclass(frozen=True)
class SpuriousSuspicion:
    """Adversaries broadcast forged suspect/inc-bump rumors about live
    victims: each adversary injects ``rate`` forged suspicion messages
    per round, spread over the victim set — driving false positives
    unless the victims' refutation (incarnation bump) wins the race."""

    adversaries: NodeSpec
    victims: NodeSpec = None
    rate: float = 1.0


@dataclass(frozen=True)
class Eclipse:
    """Adversary-controlled relays selectively drop a victim set's
    traffic (both directions): the victims starve — their probes go
    unanswered, their refutations never escape — while the rest of the
    cluster stays healthy. ``coverage`` is the fraction of a victim's
    traffic routed through adversary relays (defaults to the
    adversaries' population fraction); ``drop`` the per-message drop
    probability on that captured fraction."""

    adversaries: NodeSpec
    victims: NodeSpec
    drop: float = 1.0
    coverage: Optional[float] = None


@dataclass(frozen=True)
class StaleReplay:
    """Adversaries replay recorded old-incarnation alive rumors about
    the victims. Incarnation ordering makes the replays unable to
    resurrect anyone (the defense this attack quantifies), but they
    still (a) compete with the victims' CURRENT rumors for piggyback
    budget — death/suspicion rumors about victims disseminate slower —
    and (b) force live victims into refutation-style incarnation bumps
    as stale claims about them keep resurfacing. ``rate`` is the
    per-victim per-round replay pressure in [0, 1)."""

    adversaries: NodeSpec
    victims: NodeSpec = None
    rate: float = 0.5


BYZANTINE = (ForgedAcks, SpuriousSuspicion, Eclipse, StaleReplay)

Primitive = Union[Partition, NodeLoss, SlowNodes, Flap, Duplicate,
                  ChurnBurst, ForgedAcks, SpuriousSuspicion, Eclipse,
                  StaleReplay]


def _byz_masks(f, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Resolve a byzantine primitive's (adversaries, victims) masks,
    refusing overlap — the structured error tests assert by name."""
    adv = node_mask(f.adversaries, n)
    vic = node_mask(f.victims, n) if f.victims is not None else ~adv
    overlap = adv & vic
    if overlap.any():
        ids = np.nonzero(overlap)[0]
        raise ValueError(
            f"{type(f).__name__}: adversary and victim selectors "
            f"overlap on {overlap.sum()} node(s) "
            f"(first ids {ids[:8].tolist()}) — a byzantine primitive's "
            "adversaries may not be their own victims")
    if not adv.any():
        raise ValueError(
            f"{type(f).__name__}: empty adversary selector")
    if not vic.any():
        # a no-op "attack" would read as "the defense worked" in every
        # report — refuse loudly instead
        raise ValueError(
            f"{type(f).__name__}: empty victim selector (a mis-sized "
            "range? the armed primitive would attack nobody)")
    return adv, vic


def _byz_coverage(f, adv: np.ndarray, n: int) -> float:
    cov = getattr(f, "coverage", None)
    if cov is None:
        return float(adv.sum()) / n
    if not 0.0 <= cov <= 1.0:
        raise ValueError(
            f"{type(f).__name__}: coverage must be in [0, 1]: {cov}")
    return float(cov)


@dataclass(frozen=True)
class Phase:
    rounds: int
    faults: tuple = ()
    name: str = ""

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError(f"phase rounds must be positive: {self.rounds}")
        object.__setattr__(self, "faults", tuple(self.faults))


@dataclass(frozen=True)
class FaultPlan:
    """A time-phased program of fault primitives.

    Phases run back to back; each phase's primitives are active for
    exactly its round window. An empty `faults` tuple is a quiescent
    phase (warm-up / recovery observation)."""

    phases: tuple

    def __post_init__(self):
        phases = tuple(self.phases)
        if not phases:
            raise ValueError("a FaultPlan needs at least one phase")
        object.__setattr__(self, "phases", phases)

    @property
    def total_rounds(self) -> int:
        return sum(ph.rounds for ph in self.phases)

    @property
    def starts(self) -> list[int]:
        """Start round of each phase."""
        out, acc = [], 0
        for ph in self.phases:
            out.append(acc)
            acc += ph.rounds
        return out

    def phase_names(self) -> list[str]:
        return [ph.name or f"phase{i}" for i, ph in enumerate(self.phases)]


def _compose(p: np.ndarray, q) -> np.ndarray:
    """Combine independent drop/event probabilities: 1-(1-p)(1-q)."""
    return 1.0 - (1.0 - p) * (1.0 - q)


def _phase_arrays(phase: Phase, n: int) -> dict[str, np.ndarray]:
    """Numpy fault tensors for ONE phase (the compile-time fold)."""
    e = np.zeros((n,))            # egress loss
    g = np.zeros((n,))            # ingress loss
    dup = np.ones((n,))
    slow_f = np.zeros((n,), bool)
    crash = np.zeros((n,))
    rejoin = np.zeros((n,))
    leave = np.zeros((n,))
    flap = np.zeros((n,), np.int32)
    # byzantine channels (zero/False when the phase carries no
    # byzantine primitive; compile_plan ships them only for plans that
    # have one somewhere)
    forge = np.zeros((n,))
    spur = np.zeros((n,))
    replay = np.zeros((n,))
    attacked = np.zeros((n,), bool)
    links: list[tuple[np.ndarray, np.ndarray, float]] = []

    for f in phase.faults:
        if isinstance(f, Partition):
            a, b = node_mask(f.a, n), node_mask(f.b, n)
            links.append((a, b, float(f.drop)))
            if f.symmetric:
                links.append((b, a, float(f.drop)))
        elif isinstance(f, NodeLoss):
            m = node_mask(f.nodes, n)
            e[m] = _compose(e[m], f.egress)
            g[m] = _compose(g[m], f.ingress)
        elif isinstance(f, SlowNodes):
            slow_f |= node_mask(f.nodes, n)
        elif isinstance(f, Flap):
            if f.half_period <= 0:
                raise ValueError("Flap half_period must be positive")
            flap[node_mask(f.nodes, n)] = f.half_period
        elif isinstance(f, Duplicate):
            dup[node_mask(f.nodes, n)] = max(1, int(f.copies))
        elif isinstance(f, ChurnBurst):
            m = node_mask(f.nodes, n)
            crash[m] = _compose(crash[m], f.crash)
            rejoin[m] = _compose(rejoin[m], f.rejoin)
            leave[m] = _compose(leave[m], f.leave)
        elif isinstance(f, ForgedAcks):
            adv, vic = _byz_masks(f, n)
            af = _byz_coverage(f, adv, n) * float(f.rate)
            if not 0.0 <= f.rate <= 1.0:
                raise ValueError(
                    f"ForgedAcks: rate must be in [0, 1]: {f.rate}")
            forge[vic] = _compose(forge[vic], af)
            attacked |= vic
        elif isinstance(f, SpuriousSuspicion):
            adv, vic = _byz_masks(f, n)
            if f.rate < 0:
                raise ValueError(
                    f"SpuriousSuspicion: rate must be >= 0: {f.rate}")
            # each adversary forges `rate` suspicions per round, spread
            # uniformly over the victim set: per-victim Poisson rate
            spur[vic] += adv.sum() * float(f.rate) / max(vic.sum(), 1)
            attacked |= vic
        elif isinstance(f, Eclipse):
            adv, vic = _byz_masks(f, n)
            cut = _byz_coverage(f, adv, n) * float(f.drop)
            if not 0.0 <= f.drop <= 1.0:
                raise ValueError(
                    f"Eclipse: drop must be in [0, 1]: {f.drop}")
            # selective drop by adversary relays = per-victim loss on
            # the captured traffic fraction, BOTH directions — the
            # existing loss fold then produces the starvation dynamics
            # (suspw collapses: probes of victims fail; hear_w
            # collapses: refutations cannot escape)
            e[vic] = _compose(e[vic], cut)
            g[vic] = _compose(g[vic], cut)
            attacked |= vic
        elif isinstance(f, StaleReplay):
            adv, vic = _byz_masks(f, n)
            if not 0.0 <= f.rate < 1.0:
                raise ValueError(
                    f"StaleReplay: rate must be in [0, 1): {f.rate}")
            replay[vic] = _compose(replay[vic], float(f.rate))
            attacked |= vic
        else:
            raise TypeError(f"unknown fault primitive: {f!r}")

    def open_frac(loss_other: np.ndarray, weights: np.ndarray,
                  incoming: bool) -> np.ndarray:
        """E over a random (weighted) peer j of w_j(1-loss_j)(1-block),
        normalized — the 'how open is my horizon' fold. `incoming`
        selects which end of the directed links this node sits on."""
        wq = weights * (1.0 - loss_other)
        total_w = weights.sum() - weights        # exclude self
        num = wq.sum() - wq                      # exclude self
        for a, b, drop in links:
            src, dst = (a, b) if not incoming else (b, a)
            # this node in src: peers in dst are dropped with `drop`
            blocked = (wq * dst).sum() - np.where(src & dst, wq, 0.0)
            num = num - np.where(src, drop * blocked, 0.0)
        return np.clip(num, 0.0, None) / np.maximum(total_w, 1e-12)

    ones = np.ones((n,))
    psend = (1.0 - e) * open_frac(g, ones, incoming=False)
    precv = (1.0 - g) * open_frac(e, ones, incoming=True)
    # duplication: each copy is an independent delivery attempt.
    # Ingress from a random sender uses the population-mean factor.
    psend = 1.0 - (1.0 - psend) ** dup
    precv = 1.0 - (1.0 - precv) ** float(dup.mean())
    # suspicion weighting: probers weighted by their own rumor reach —
    # a prober stuck behind a partition cannot spread its suspicion.
    # The carrier weights are mutually recursive (a peer only carries
    # what IT could hear/say), so iterate each fold to its fixed point:
    # under a total cut the minority's weight must go to 0 exactly, not
    # to the one-step residual (which, times the ~40/round gossip rate,
    # would let cut-off nodes keep "refuting" through same-side peers
    # that never held the rumor).
    reach = np.maximum(psend * precv, 1e-9)

    def fixed_point(loss_other, w0, incoming):
        w = w0
        base = (1.0 - (g if incoming else e))
        for _ in range(12):
            w_next = base * open_frac(loss_other, np.maximum(w, 1e-12),
                                      incoming=incoming)
            if np.allclose(w_next, w, atol=1e-7):
                w = w_next
                break
            w = w_next
        return w

    in_w = fixed_point(e, reach, incoming=True)
    out_w = fixed_point(g, reach, incoming=False)
    suspw = in_w * out_w
    # refutation race: hear_w multiplies the per-round refute rate, so
    # it must capture BOTH legs of a refutation —
    #   hear: the suspicion rumor reaches me. One more fixed-point
    #         iteration: a peer can only forward the quorum-side rumor
    #         if it could hear that rumor itself, so carrier weight is
    #         in_w, not raw reach (otherwise a cut-off node "refutes"
    #         through same-side peers that never held the suspicion);
    #   answer: my higher-incarnation alive rumor escapes back to the
    #         suspecting population. The mirror fold: egress weighted
    #         by the receivers' own spreading power out_w — peers stuck
    #         on my side of a cut accept the refutation but cannot
    #         relay it anywhere that matters.
    # A one-way cut (ingress open, egress dropped) keeps hear≈1 but
    # answer≈0: the node knows it is suspected and still gets declared,
    # which is exactly agent-level SWIM.
    hear_in = (1.0 - g) * open_frac(e, np.maximum(in_w, 1e-9),
                                    incoming=True)
    speak_out = (1.0 - e) * open_frac(g, np.maximum(out_w, 1e-9),
                                      incoming=False)
    hear_w = hear_in * speak_out
    return dict(psend=psend, precv=precv, suspw=suspw, hear_w=hear_w,
                mid=np.array(float((psend * precv).mean())),
                slow_f=slow_f, crash_p=crash, rejoin_p=rejoin,
                leave_p=leave, flap_half=flap,
                forge_ack=forge, spur_susp=spur, replay=replay,
                attacked=attacked)


def plan_is_byzantine(plan: FaultPlan) -> bool:
    """Does any phase carry a byzantine primitive? Decides whether the
    compiled plan ships the byzantine tensors (an honest plan keeps the
    exact pre-byzantine pytree structure — the bitwise pin)."""
    return any(isinstance(f, BYZANTINE)
               for ph in plan.phases for f in ph.faults)



# ------------------------------------------------------- tensor half


class CompiledFaultPlan(NamedTuple):
    """Per-phase fault tensors on one device (leading axis: phase).

    Field order and dtypes are the reference's, which ``plan_digest``
    hashes. The byzantine leaves are None for an honest plan. The fields
    after them are the port's own: whether any phase flaps and whether
    any releases former flappers, the rewrites ``frame_at`` runs (set by
    ``compile_plan`` from its host arrays), and the packed tensors
    ``rows`` (``[P, L, N]`` f32, the ``ROW_LANES`` a plan has) and
    ``masks`` (``[P, M, N]`` bool, ``MASK_LANES``), of which those lane
    fields are views: ``frame_at`` gathers a phase with one index on
    each (``_packed``)."""

    starts: torch.Tensor        # [P] int32 — phase start rounds
    psend: torch.Tensor         # [P,N] f32 — egress one-leg delivery
    precv: torch.Tensor         # [P,N] f32 — ingress one-leg delivery
    suspw: torch.Tensor         # [P,N] f32 — suspicion-weighted round trip
    hear_w: torch.Tensor        # [P,N] f32 — rumor-weighted ingress
    mid: torch.Tensor           # [P]   f32 — mean(psend*precv)
    slow_f: torch.Tensor        # [P,N] bool — forced-slow mask
    crash_p: torch.Tensor       # [P,N] f32 — extra crash probability
    rejoin_p: torch.Tensor      # [P,N] f32
    leave_p: torch.Tensor       # [P,N] f32
    flap_half: torch.Tensor     # [P,N] int32 — flap half-period (0 = none)
    flap_release: torch.Tensor  # [P,N] bool — revive on the phase's round 0
    forge_ack: Optional[torch.Tensor] = None   # [P,N] f32
    spur_susp: Optional[torch.Tensor] = None   # [P,N] f32
    replay: Optional[torch.Tensor] = None      # [P,N] f32
    attacked: Optional[torch.Tensor] = None    # [P,N] bool
    any_flap: bool = True
    any_release: bool = True
    rows: Optional[torch.Tensor] = None
    masks: Optional[torch.Tensor] = None


#: the reference's fields: the per-phase tensors
PLAN_LEAVES = CompiledFaultPlan._fields[:-4]
#: the lanes packed in ``rows`` and ``masks``, the byzantine ones last
#: (an honest plan has the first 7 and the first 2)
ROW_LANES = ("psend", "precv", "suspw", "hear_w", "crash_p", "rejoin_p",
             "leave_p", "forge_ack", "spur_susp", "replay")
MASK_LANES = ("slow_f", "flap_release", "attacked")


def _packed(cp: CompiledFaultPlan,
            rows: Optional[torch.Tensor] = None,
            masks: Optional[torch.Tensor] = None) -> CompiledFaultPlan:
    """``cp`` with its lane fields views of ``rows`` and ``masks``
    (stacked from the fields when not given): the same values, so a
    frame is one gather a dtype."""
    byz = cp.attacked is not None
    rn = ROW_LANES if byz else ROW_LANES[:7]
    mn = MASK_LANES if byz else MASK_LANES[:2]
    if rows is None:
        rows = torch.stack([getattr(cp, f) for f in rn], 1)
        masks = torch.stack([getattr(cp, f) for f in mn], 1)
    return cp._replace(rows=rows, masks=masks,
                       **{f: rows[:, i] for i, f in enumerate(rn)},
                       **{f: masks[:, i] for i, f in enumerate(mn)})


class FaultFrame(NamedTuple):
    """One round's fault view: [N] lanes and the 0-d ``mid``."""

    psend: torch.Tensor
    precv: torch.Tensor
    suspw: torch.Tensor
    hear_w: torch.Tensor
    mid: torch.Tensor
    slow_f: torch.Tensor
    crash_p: torch.Tensor
    rejoin_p: torch.Tensor
    leave_p: torch.Tensor
    forge_ack: Optional[torch.Tensor] = None
    spur_susp: Optional[torch.Tensor] = None
    replay: Optional[torch.Tensor] = None
    attacked: Optional[torch.Tensor] = None


#: the frame's lanes as the kernels take them (``FaultArrays`` in
#: round_kernels.cu, ``FrameArrays`` in lane_kernels.cu): the honest
#: lanes, then ``mid``, then the byzantine lanes; the masks are bool,
#: every other lane f32
FRAME_LANES = ("psend", "precv", "suspw", "hear_w", "slow_f", "crash_p",
               "rejoin_p", "leave_p")
BYZ_LANES = ("forge_ack", "spur_susp", "replay", "attacked")
FRAME_MASKS = ("slow_f", "attacked")
FRAME_ABI = FRAME_LANES + ("mid",) + BYZ_LANES


def frame_lanes(fx: FaultFrame) -> tuple:
    """The names of the lanes a kernel reads of ``fx``, in
    ``FRAME_ABI`` order: the byzantine ones on a byzantine frame only."""
    return FRAME_LANES + ("mid",) + (BYZ_LANES if fx.attacked is not None
                                     else ())


def frame_pointers(fx: FaultFrame) -> dict:
    """The device pointers of ``frame_lanes(fx)``, by name: a kernel's
    frame struct."""
    return {f: getattr(fx, f).data_ptr() for f in frame_lanes(fx)}


def check_frame(fx: FaultFrame, dev: torch.device, shapes: tuple) -> None:
    """Refuse, by lane name, a frame a kernel cannot take: every lane a
    contiguous tensor on ``dev`` of one of ``shapes`` (``((N,),)``, or
    ``((N,), (G, N))`` where a grid may give a row a point), f32 and the
    masks bool; ``mid`` contiguous f32, one a row of the lanes."""
    rows = tuple(fx.psend.shape)
    if rows not in shapes:
        raise ValueError(f"fault lanes must be of shape "
                         f"{' or '.join(map(str, shapes))}, not {rows}")
    for f in frame_lanes(fx):
        if f == "mid":
            continue
        a = getattr(fx, f)
        if a is None:
            raise ValueError(f"fault frame lacks {f}: a byzantine frame "
                             "carries all four byzantine lanes")
        dt = torch.bool if f in FRAME_MASKS else torch.float32
        if a.device != dev or a.dtype != dt or tuple(a.shape) != rows \
                or not a.is_contiguous():
            raise ValueError(
                f"fault lane {f} must be a contiguous {dt} {rows} tensor "
                f"on {dev}; it is {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    mids = math.prod(rows[:-1])
    if fx.mid.device != dev or fx.mid.dtype != torch.float32 \
            or fx.mid.numel() != mids or not fx.mid.is_contiguous():
        raise ValueError(f"fault frame mid must be {mids} contiguous f32 "
                         f"on {dev}")


class PlanSchedule(NamedTuple):
    """What a frame's host-side phase lookup needs, read once per run:
    the phase starts, and which phases flap or release former
    flappers (the only phases whose churn lanes a frame rewrites)."""

    starts: list
    flaps: list
    releases: list


_NP_DTYPES = {torch.float32: np.float32, torch.bool: np.bool_,
              torch.int32: np.int32}


def compile_plan(plan: FaultPlan, n: int,
                 device: DeviceLike = None) -> CompiledFaultPlan:
    """Fold a FaultPlan into per-phase tensors for an n-node cluster on
    ``device`` (the card unless the caller passes ``"cpu"``). The fold
    is numpy on the host (``_phase_arrays``); each stacked f64 array is
    rounded to f32 once, as the reference's ``jnp.asarray`` does."""
    dev = default_device(device)
    per_phase = [_phase_arrays(ph, n) for ph in plan.phases]
    # restore-on-phase-flip for flapping nodes
    for i, pa in enumerate(per_phase):
        pa["flap_release"] = np.zeros((n,), bool) if i == 0 else (
            (per_phase[i - 1]["flap_half"] > 0) & (pa["flap_half"] == 0))

    def stack(key, dtype):
        a = np.stack([pa[key] for pa in per_phase]).astype(
            _NP_DTYPES[dtype])
        return torch.from_numpy(a).to(dev)

    byz = plan_is_byzantine(plan)
    f32, b8 = torch.float32, torch.bool
    return _packed(CompiledFaultPlan(
        starts=torch.tensor(plan.starts, dtype=torch.int32, device=dev),
        psend=stack("psend", f32), precv=stack("precv", f32),
        suspw=stack("suspw", f32), hear_w=stack("hear_w", f32),
        mid=stack("mid", f32), slow_f=stack("slow_f", b8),
        crash_p=stack("crash_p", f32), rejoin_p=stack("rejoin_p", f32),
        leave_p=stack("leave_p", f32),
        flap_half=stack("flap_half", torch.int32),
        flap_release=stack("flap_release", b8),
        forge_ack=stack("forge_ack", f32) if byz else None,
        spur_susp=stack("spur_susp", f32) if byz else None,
        replay=stack("replay", f32) if byz else None,
        attacked=stack("attacked", b8) if byz else None,
        any_flap=any(bool((pa["flap_half"] > 0).any()) for pa in per_phase),
        any_release=any(bool(pa["flap_release"].any())
                        for pa in per_phase)))


def plan_digest(cp: Optional[CompiledFaultPlan]) -> Optional[str]:
    """Content fingerprint of a compiled plan: 16 hex chars over every
    tensor's name, dtype, shape and bytes (None leaves hashed by name)
    — equal to the reference's digest of the same plan."""
    if cp is None:
        return None
    h = hashlib.sha256()
    for name, leaf in zip(PLAN_LEAVES, cp):
        h.update(name.encode() + b"=")
        if leaf is None:
            h.update(b"none;")
            continue
        a = np.ascontiguousarray(leaf.detach().cpu().numpy())
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
        h.update(b";")
    return h.hexdigest()[:16]


def plan_schedule(cp: CompiledFaultPlan) -> PlanSchedule:
    """The host-side schedule of ``cp`` (one small device read)."""
    return PlanSchedule(starts=cp.starts.tolist(),
                        flaps=(cp.flap_half > 0).any(1).tolist(),
                        releases=cp.flap_release.any(1).tolist())


def active_phase(cp: CompiledFaultPlan, round_idx: int,
                 sched: Optional[PlanSchedule] = None) -> int:
    """Index of the phase whose faults shape round ``round_idx``,
    clipped: rounds past the plan's end report the LAST phase."""
    starts = (plan_schedule(cp) if sched is None else sched).starts
    i = bisect.bisect_right(starts, int(round_idx)) - 1
    return min(max(i, 0), len(starts) - 1)


def phase_at(cp: CompiledFaultPlan, round_idx: torch.Tensor) -> torch.Tensor:
    """``active_phase`` of the device round ``round_idx`` (0-d, or a
    grid's ``[G]`` rounds, which share one) as a ``[1]`` int64 tensor on
    the plan's device: no host read."""
    r = round_idx.reshape(-1)[:1].to(cp.starts.dtype)
    ph = torch.searchsorted(cp.starts, r, right=True) - 1
    return ph.clamp_(0, cp.starts.shape[0] - 1)


def frame_at(cp: CompiledFaultPlan, round_idx: torch.Tensor,
             gain: float = 1.0) -> FaultFrame:
    """``fault_frame`` with the round a device tensor (0-d, or a grid's
    ``[G]`` rounds, which share one): the lanes are fresh tensors,
    filled by one dynamic index on each of the plan's packed ``rows``
    and ``masks``, and the flap / release rewrites of a plan that has
    them (``any_flap``, ``any_release``) run on every round — on a phase
    without them they change nothing. Bit for bit ``fault_frame(cp,
    round_idx, gain=gain)``."""
    return next(frames_at(cp, round_idx, 1, gain))


def plan_phases(cp: CompiledFaultPlan, round0: torch.Tensor,
                rounds: int) -> tuple:
    """The ``rounds`` absolute rounds from the device round ``round0``
    (``[rounds]``, the dtype of ``starts``) and the phase of each
    (``[rounds]`` int64, clipped as ``active_phase`` clips): one
    ``searchsorted`` for all of them, no host read."""
    r = round0.reshape(-1)[:1].to(cp.starts.dtype) + torch.arange(
        rounds, dtype=cp.starts.dtype, device=cp.starts.device)
    phs = (torch.searchsorted(cp.starts, r, right=True) - 1).clamp_(
        0, cp.starts.shape[0] - 1)
    return r, phs


def frames_at(cp: CompiledFaultPlan, round0: torch.Tensor, rounds: int,
              gain: float = 1.0,
              phases: Optional[tuple] = None) -> Iterator[FaultFrame]:
    """``frame_at`` of the ``rounds`` rounds from the device round
    ``round0``, each frame built as it is taken. The phases (``phases``,
    ``plan_phases``' lookup when the caller has made it), the rounds'
    offsets in them and ``mid`` are looked up for all the rounds at
    once: a few launches a call, none a round."""
    r, phs = plan_phases(cp, round0, rounds) if phases is None else phases
    rels = r - cp.starts.index_select(0, phs)
    mids = cp.mid.index_select(0, phs)
    for i in range(rounds):
        yield _frame(cp, phs[i:i + 1], rels[i:i + 1], mids[i], gain)


def _take(x: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Phase ``ph``'s row of the per-phase tensor ``x``, a fresh tensor:
    moved as int64 words where it splits into them (a gather's cost is
    per element, so wider elements move it faster)."""
    k = 8 // x.element_size()
    if all(d % k == 0 for d in (
            x.shape[-1], x.storage_offset(), *x.stride()[:-1])):
        return x.view(torch.int64).index_select(0, ph)[0].view(x.dtype)
    return x.index_select(0, ph)[0]


def _churn_rewrites(cp: CompiledFaultPlan, ph: torch.Tensor,
                    rel: torch.Tensor, crash_p: torch.Tensor,
                    rejoin_p: torch.Tensor,
                    flap_release: Optional[torch.Tensor],
                    gain: float) -> tuple:
    """The phase's ``crash_p`` and ``rejoin_p`` after the flap and release
    rewrites the plan has (``any_flap``, ``any_release``; the phase's
    ``flap_release`` row is needed only for the second): on a phase
    without them they come out as they went in."""
    level = float(gain)
    if cp.any_flap:
        half = _take(cp.flap_half, ph)
        cycle = (rel // torch.clamp_min(half, 1)) % 2
        flap_on = half > 0
        down = flap_on & (cycle == 1)
        crash_p = torch.where(down, level, crash_p)
        rejoin_p = torch.where(flap_on & ~down, level, rejoin_p)
    if cp.any_release:
        rejoin_p = torch.where(flap_release & (rel == 0), level, rejoin_p)
    return crash_p, rejoin_p


def _frame(cp: CompiledFaultPlan, ph: torch.Tensor, rel: torch.Tensor,
           mid: torch.Tensor, gain: float) -> FaultFrame:
    f = dict(zip(ROW_LANES, _take(cp.rows, ph)))
    m = dict(zip(MASK_LANES, _take(cp.masks, ph)))
    crash_p, rejoin_p = _churn_rewrites(cp, ph, rel, f["crash_p"],
                                        f["rejoin_p"], m["flap_release"],
                                        gain)
    return FaultFrame(
        psend=f["psend"], precv=f["precv"], suspw=f["suspw"],
        hear_w=f["hear_w"], mid=mid, slow_f=m["slow_f"],
        crash_p=crash_p, rejoin_p=rejoin_p, leave_p=f["leave_p"],
        forge_ack=f.get("forge_ack"), spur_susp=f.get("spur_susp"),
        replay=f.get("replay"), attacked=m.get("attacked"))


class InPlaceFrame(NamedTuple):
    """A round's fault frame read in place from its plan, as the kernel
    runner hands it to ``round_kernel`` on the card. ``lanes`` holds, for
    each lane a kernel reads (``frame_lanes``, ``mid`` among them), the
    plan's phase-0 row (a view) or a fresh lane the round rewrote;
    ``strides`` the elements of the lane's dtype from one phase's row to
    the next (0 for a fresh lane); ``phase`` the round's device phase
    (``[1]`` int64); ``phases`` the plan's number of phases. The round's
    lane f starts ``phase * strides[f]`` elements past ``lanes.f``."""

    lanes: FaultFrame
    strides: dict
    phase: torch.Tensor
    phases: int

    def lane(self, f: str) -> Optional[torch.Tensor]:
        """The round's lane ``f``: a stride-0 lane as it is, else the
        phase's row picked by the device phase from the phase rows
        ``as_strided`` lays over the lane's storage (a fresh tensor; no
        host read)."""
        b, s = getattr(self.lanes, f), self.strides.get(f, 0)
        if b is None or s == 0:
            return b
        rows = b.as_strided((self.phases, *b.shape), (s, *b.stride()),
                            b.storage_offset())
        return rows.index_select(0, self.phase)[0]

    def resolve(self) -> FaultFrame:
        """The frame the kernel reads, every lane the round's (``lane``)."""
        return FaultFrame(**{f: self.lane(f) for f in FaultFrame._fields})


def frames_in_place(cp: CompiledFaultPlan, round0: torch.Tensor,
                    rounds: int, gain: float = 1.0,
                    phases: Optional[tuple] = None
                    ) -> Iterator[InPlaceFrame]:
    """``frames_at``'s rounds as ``InPlaceFrame``s on ``cp``'s phase rows
    and each round's device phase (``phases``, ``plan_phases``' lookup,
    made here when None): no lane is gathered, except that on a plan
    with flap or release rewrites ``crash_p`` and ``rejoin_p`` are the
    fresh lanes ``frames_at`` makes (stride 0). Each frame's
    ``resolve()`` is ``frames_at``'s frame bit for bit."""
    r, phs = plan_phases(cp, round0, rounds) if phases is None else phases
    fresh = ("crash_p", "rejoin_p") if cp.any_flap or cp.any_release \
        else ()
    base = FaultFrame(**{f: None if getattr(cp, f) is None
                         else getattr(cp, f)[0]
                         for f in FaultFrame._fields})
    strides = {f: 0 if f in fresh else getattr(cp, f).stride(0)
               for f in frame_lanes(base)}
    if fresh:
        rels = r - cp.starts.index_select(0, phs)
    for i in range(rounds):
        ph, lanes = phs[i:i + 1], base
        if fresh:
            crash_p, rejoin_p = _churn_rewrites(
                cp, ph, rels[i:i + 1], _take(cp.crash_p, ph),
                _take(cp.rejoin_p, ph),
                _take(cp.flap_release, ph) if cp.any_release else None,
                gain)
            lanes = base._replace(crash_p=crash_p, rejoin_p=rejoin_p)
        yield InPlaceFrame(lanes, strides, ph, cp.starts.shape[0])


def check_in_place(fx: InPlaceFrame, dev: torch.device, rows: int) -> None:
    """Refuse, by name, an in-place frame a kernel cannot take: lanes as
    ``check_frame`` takes them (each one phase's row), one contiguous
    int64 phase on ``dev``, and each lane's stride 0 or at least a row,
    with the last phase's row inside the lane's storage. The phase's
    value is the device's (``plan_phases`` clips it to the plan)."""
    check_frame(fx.lanes, dev, ((rows,),))
    ph = fx.phase
    if ph.device != dev or ph.dtype != torch.int64 or ph.numel() != 1 \
            or not ph.is_contiguous():
        raise ValueError(f"fault frame phase must be one contiguous int64 "
                         f"on {dev}; it is {ph.dtype} "
                         f"{tuple(ph.shape)} on {ph.device}")
    if fx.phases < 1:
        raise ValueError(f"fault frame of {fx.phases} phases")
    for f in frame_lanes(fx.lanes):
        a, s = getattr(fx.lanes, f), fx.strides.get(f)
        if not isinstance(s, int) or s < 0 or 0 < s < a.numel():
            raise ValueError(f"fault lane {f}: phase stride {s} is neither "
                             f"0 (a fresh lane) nor a row of "
                             f"{a.numel()} elements or more")
        end = a.storage_offset() + (fx.phases - 1) * s + a.numel()
        if end * a.element_size() > a.untyped_storage().nbytes():
            raise ValueError(f"fault lane {f}: phase {fx.phases - 1} at "
                             f"stride {s} lies past the lane's storage")


def scale_frame(fx: FaultFrame, gain) -> FaultFrame:
    """Blend a round's fault view toward the no-fault identity:
    ``1 - gain*(1 - mult)`` for the delivery multipliers, ``gain*rate``
    for the churn and byzantine rates; the masks stay armed for any
    positive gain and disarm at 0 (reference ``scale_frame``). ``gain``
    is a float, or a swept ``[G, 1]`` f32 leaf: the frame's lanes then
    come out ``[G, N]``, one row per grid point."""
    if isinstance(gain, torch.Tensor):
        g = gain.to(torch.float32)
        on_t = g > 0.0

        def mask(m):
            return m & on_t
    else:
        # a Python float operand is rounded to f32 once, as the
        # reference's jnp.float32 gain is, and keeps PyTorch on its
        # vectorized kernels
        g = float(gain)
        on = g > 0.0

        def mask(m):
            return m if on else torch.zeros_like(m)

    def blend(m):
        return 1.0 - g * (1.0 - m)

    def rate(x):
        return None if x is None else g * x

    return FaultFrame(
        psend=blend(fx.psend), precv=blend(fx.precv),
        suspw=blend(fx.suspw), hear_w=blend(fx.hear_w),
        mid=blend(fx.mid), slow_f=mask(fx.slow_f),
        crash_p=g * fx.crash_p, rejoin_p=g * fx.rejoin_p,
        leave_p=g * fx.leave_p, forge_ack=rate(fx.forge_ack),
        spur_susp=rate(fx.spur_susp), replay=rate(fx.replay),
        attacked=None if fx.attacked is None else mask(fx.attacked))


def scale_plan(cp: CompiledFaultPlan, gain: float) -> CompiledFaultPlan:
    """``cp`` with every phase row blended as ``scale_frame`` blends a
    frame, so that ``fault_frame(scale_plan(cp, g), r, gain=g)`` is
    ``scale_frame(fault_frame(cp, r), g)`` bit for bit. A runner whose
    gain is fixed blends its plan once instead of every round's frame."""
    rows = FaultFrame(*(getattr(cp, f) for f in FaultFrame._fields))
    return _packed(cp._replace(**scale_frame(rows, gain)._asdict()))


def fault_frame(cp: CompiledFaultPlan, round_idx: int,
                sched: Optional[PlanSchedule] = None,
                gain: float = 1.0) -> FaultFrame:
    """Round ``round_idx``'s fault view. Rounds past the plan's end hold
    the LAST phase's faults. Lanes the round does not rewrite are views
    of the plan's phase rows; a flapping phase rewrites ``crash_p`` and
    ``rejoin_p`` from its level schedule (down: crash with p=1; up:
    rejoin with p=1), and round 0 of a phase that follows a flap
    revives the former flappers. On a plan blended by ``scale_plan``,
    pass its ``gain``: the schedule then writes ``gain`` for 1, which is
    the blend of 1."""
    sched = plan_schedule(cp) if sched is None else sched
    ph = active_phase(cp, round_idx, sched)
    rel = int(round_idx) - sched.starts[ph]
    crash_p, rejoin_p = cp.crash_p[ph], cp.rejoin_p[ph]
    level = float(gain)
    if sched.flaps[ph]:
        half = cp.flap_half[ph]
        cycle = (rel // torch.clamp_min(half, 1)) % 2
        flap_on = half > 0
        down = flap_on & (cycle == 1)
        crash_p = torch.where(down, level, crash_p)
        rejoin_p = torch.where(flap_on & ~down, level, rejoin_p)
    if rel == 0 and sched.releases[ph]:
        rejoin_p = torch.where(cp.flap_release[ph], level, rejoin_p)

    def take(x):
        return None if x is None else x[ph]

    return FaultFrame(
        psend=cp.psend[ph], precv=cp.precv[ph], suspw=cp.suspw[ph],
        hear_w=cp.hear_w[ph], mid=cp.mid[ph], slow_f=cp.slow_f[ph],
        crash_p=crash_p, rejoin_p=rejoin_p, leave_p=cp.leave_p[ph],
        forge_ack=take(cp.forge_ack), spur_susp=take(cp.spur_susp),
        replay=take(cp.replay), attacked=take(cp.attacked))


def shard_plan(cp: CompiledFaultPlan, lo: int,
               hi: int) -> CompiledFaultPlan:
    """A mesh rank's view of a plan: the ``[P, N]`` phase tensors sliced
    to nodes ``[lo, hi)`` along the node axis (views, no copy), ``starts``
    and ``mid`` whole (the reference's ``mesh._plan_specs``). The
    byzantine leaves stay None on an honest plan. ``fault_frame`` of the
    shard reads the rank's columns."""
    return _packed(cp._replace(flap_half=cp.flap_half[:, lo:hi]),
                   cp.rows[..., lo:hi], cp.masks[..., lo:hi])


# ------------------------------------------------ detection gate


def ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y for a static int y >= 0 by binary exponentiation, multiplied
    in the order XLA's integer_pow uses (so the f32 rounding matches)."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _binom_tail_ge(m: int, q: torch.Tensor, k) -> torch.Tensor:
    """P(Binomial(m, q) >= k) elementwise, for a static int m. For an
    int k the terms j < k never enter, and k <= 0 yields 1; for a swept
    int32 tensor k every term enters, masked to 0.0 where j < k (adding
    an exact zero leaves each point's sum what the static k gives)."""
    if isinstance(k, torch.Tensor):
        total = torch.zeros_like(q)
        for j in range(m + 1):
            pmf = math.comb(m, j) * ipow(q, j) * ipow(1.0 - q, m - j)
            total = total + torch.where(k <= j, pmf, 0.0)
        return torch.clamp(total, 0.0, 1.0)
    total = torch.zeros_like(q)
    for j in range(max(k, 0), m + 1):
        total = total + math.comb(m, j) * ipow(q, j) * ipow(1.0 - q, m - j)
    return torch.clamp(total, 0.0, 1.0)


def detection_gate(up: torch.Tensor, fx: Optional[FaultFrame],
                   p) -> torch.Tensor:
    """Multiplier on the failed-probe (suspicion-start) rate: the
    ForgedAcks channel and the corroboration_k defense (reference
    ``faults.detection_gate``). k == 0: (1-af)^m on down nodes, 1 on
    live ones; k >= 1: P(Binom(m, q) >= k) for every node,
    q = p_direct·mid·(1-af). A swept k (``p.sweeps("corroboration_k")``)
    selects the rule per grid point."""
    m = int(p.indirect_checks)
    dev = up.device
    one = torch.ones((), dtype=torch.float32, device=dev)
    af = fx.forge_ack if (fx is not None and fx.forge_ack is not None) \
        else torch.zeros((), dtype=torch.float32, device=dev)
    swept = p.sweeps("corroboration_k")
    if not swept and p.corroboration_k <= 0:
        return torch.where(up, one, ipow(one - af, m))
    mid = fx.mid if fx is not None else one
    q = p.p_direct * mid * (one - af)
    if not swept:
        return _binom_tail_ge(m, q, int(p.corroboration_k))
    ck = p.corroboration_k
    tail = _binom_tail_ge(m, q, torch.clamp_min(ck, 1))
    return torch.where(ck >= 1, tail, torch.where(up, one,
                                                  ipow(one - af, m)))
