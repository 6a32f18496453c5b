"""A traffic's fault plan folded into per-node frame lanes, in plain
PyTorch.

A plan is data (a traffic file's ``"plan"``): phases run back to back,
each ``{"name", "rounds", "faults"}``, a fault one primitive with its
node ranges given as fractions of the pool (``[lo, hi)`` names agents
``int(lo * n)`` to ``int(hi * n)``). Supported: the quiet phase and
``Eclipse`` (Singh et al., "Eclipse Attacks on Overlay Networks",
INFOCOM 2006): adversary relays carry a ``coverage`` share of each
victim's traffic and drop it with probability ``drop``, both ways. Any
other primitive is refused by name.

The fold, in float64 on the host, rounded to float32 once, gives each
phase the mean-field frame a period of it reads:

* ``psend`` / ``precv``: a node's one-leg delivery out / in, its own
  loss times how open its horizon is (``open_frac``: the loss-weighted
  share of the other nodes' traffic that reaches it);
* ``suspw``: the suspicion weight, in-reach times out-reach, each the
  fixed point of the open-horizon fold weighted by the peers' own reach
  (a peer only carries what it could hear or say itself: under a total
  cut the cut side's weight goes to 0, not to a one-step residual);
* ``hear_w``: both legs of a refutation, hearing the suspicion (ingress
  weighted by the peers' in-reach) and answering it (egress weighted by
  their out-reach);
* ``mid``: the mean round trip ``psend * precv`` over the pool, which
  scales relay legs and epidemic growth;
* ``slow_f``, ``crash_p``, ``rejoin_p``, ``leave_p``: the forced-slow
  mask and the churn rates a phase adds (none here);
* the byzantine lanes ``forge_ack``, ``spur_susp``, ``replay`` (zero
  for an eclipse) and ``attacked``, the victims, which the attack
  counters count.

A period takes its phase's lanes: the last phase whose start is at or
before its round (rounds past the end hold the last phase).
"""

from __future__ import annotations

import torch

_F64 = torch.float64
#: the frame's lanes, f32 first, then the masks
ROW_LANES = ("psend", "precv", "suspw", "hear_w", "crash_p", "rejoin_p",
             "leave_p", "forge_ack", "spur_susp", "replay")
MASK_LANES = ("slow_f", "attacked")
#: the primitives folded: all of them lie, so every frame of a plan that
#: holds one is a byzantine frame, its quiet phases' too
SUPPORTED = ("Eclipse",)
#: the open-horizon fixed point: at most this many steps, stopping when
#: a step moves every weight by no more than 1e-7 + 1e-5 of it
FIXED_POINT_STEPS = 12


def node_range(spec, n: int) -> tuple:
    """Fractions ``[lo, hi)`` of the pool -> agent ids ``[lo, hi)``."""
    lo, hi = int(spec[0] * n), int(spec[1] * n)
    if not 0 <= lo < hi <= n:
        raise ValueError(f"node range {spec} names no agent of {n}")
    return lo, hi


def _mask(spec, n: int) -> torch.Tensor:
    lo, hi = node_range(spec, n)
    m = torch.zeros(n, dtype=torch.bool)
    m[lo:hi] = True
    return m


def _open_frac(loss_other, weights) -> torch.Tensor:
    """E over a random peer j (weighted by ``weights``, this node left
    out) of w_j (1 - loss_j), over the peers' total weight."""
    wq = weights * (1.0 - loss_other)
    total_w = weights.sum() - weights
    num = wq.sum() - wq
    return torch.clamp_min(num, 0.0) / torch.clamp_min(total_w, 1e-12)


def _fixed_point(base, loss_other, w0) -> torch.Tensor:
    w = w0
    for _ in range(FIXED_POINT_STEPS):
        w_next = base * _open_frac(loss_other, torch.clamp_min(w, 1e-12))
        done = torch.allclose(w_next, w, rtol=1e-5, atol=1e-7)
        w = w_next
        if done:
            break
    return w


def phase_lanes(phase: dict, n: int) -> dict:
    """One phase's frame lanes over ``n`` agents (f64, bool masks) and
    its 0-d ``mid``."""
    e = torch.zeros(n, dtype=_F64)          # egress loss
    g = torch.zeros(n, dtype=_F64)          # ingress loss
    attacked = torch.zeros(n, dtype=torch.bool)
    for f in phase["faults"]:
        kind = f.get("primitive")
        if kind not in SUPPORTED:
            raise ValueError(f"the reference folds {', '.join(SUPPORTED)} "
                             f"only, not {kind!r}")
        adv, vic = _mask(f["adversaries"], n), _mask(f["victims"], n)
        if (adv & vic).any():
            raise ValueError("Eclipse: adversaries and victims overlap")
        cut = float(f["coverage"]) * float(f["drop"])
        # the captured share of a victim's traffic is lost both ways
        e[vic] = 1.0 - (1.0 - e[vic]) * (1.0 - cut)
        g[vic] = 1.0 - (1.0 - g[vic]) * (1.0 - cut)
        attacked |= vic
    ones = torch.ones(n, dtype=_F64)
    psend = (1.0 - e) * _open_frac(g, ones)
    precv = (1.0 - g) * _open_frac(e, ones)
    # one copy of each message: a copy is one delivery attempt
    psend = 1.0 - (1.0 - psend) ** 1.0
    precv = 1.0 - (1.0 - precv) ** 1.0
    reach = torch.clamp_min(psend * precv, 1e-9)
    in_w = _fixed_point(1.0 - g, e, reach)
    out_w = _fixed_point(1.0 - e, g, reach)
    hear_in = (1.0 - g) * _open_frac(e, torch.clamp_min(in_w, 1e-9))
    speak_out = (1.0 - e) * _open_frac(g, torch.clamp_min(out_w, 1e-9))
    zeros = torch.zeros(n, dtype=_F64)
    return {"psend": psend, "precv": precv, "suspw": in_w * out_w,
            "hear_w": hear_in * speak_out, "mid": (psend * precv).mean(),
            "crash_p": zeros, "rejoin_p": zeros, "leave_p": zeros,
            "forge_ack": zeros, "spur_susp": zeros, "replay": zeros,
            "slow_f": torch.zeros(n, dtype=torch.bool),
            "attacked": attacked}


class Plan:
    """A plan folded for ``n`` agents on ``device``: ``starts`` (host
    ints), whether it is ``byzantine``, and per phase its lanes in
    float32 (``lanes[i]``, a dict; ``mid`` 0-d)."""

    def __init__(self, spec: dict, n: int, device=None):
        self.byzantine = any(ph["faults"] for ph in spec["phases"])
        self.starts, acc = [], 0
        for ph in spec["phases"]:
            if ph["rounds"] <= 0:
                raise ValueError(f"phase {ph['name']!r} has no rounds")
            self.starts.append(acc)
            acc += ph["rounds"]
        self.lanes = []
        for ph in spec["phases"]:
            f = phase_lanes(ph, n)
            self.lanes.append({
                k: v.to(device=device,
                        dtype=torch.bool if k in MASK_LANES
                        else torch.float32) for k, v in f.items()})

    def phase(self, round_idx: int) -> int:
        """The phase of absolute round ``round_idx``."""
        return max(sum(s <= int(round_idx) for s in self.starts) - 1, 0)

    def frame(self, round_idx: int) -> dict:
        return self.lanes[self.phase(round_idx)]
