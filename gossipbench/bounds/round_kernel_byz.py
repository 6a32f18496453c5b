"""The least time one ``round_kernel`` launch on a byzantine fault frame
(``round_kernel<true, true, ...>``, one period of every node) needs, from
the configuration and the shapes alone.

Bytes: the 15 B/node packed state read once and written once (a frame
always writes down_age), the frame's 42 B/node (ten f32 lanes: psend,
precv, suspw, hear_w, the three churn rates, forge_ack, spur_susp,
replay; two bool masks: slow_f, attacked) and its 4 B ``mid``, the 8
stale scalars, the period's seed, and the [min(528, tiles of 512), 18]
f32 partial-sum table. Operations, a lower count of what every node
does: one Philox4x32-10 call (40 integer operations), a shift and a
conversion per uniform drawn (every node's churn and Poisson draws, its
slow draw where that model is on, the ack draw of every live node), and
77 f32 operations (the per-node no-ack and Poisson terms, 60; the
frame's churn sums, round trip, relay factor and suspicion-weighted
miss, 15; the forged-suspicion arrivals, 2). The replay draws of live
victims under stale replay are not counted: the cell's plan replays
nothing. Neither are the detection gate, refutation and growth terms,
which depend on the data.

A frozen copy of the program's ``costmodel.kernel_bound`` for one
byzantine-frame launch. Without churn every node stays live, and all
draw for the ack. Churn moves liveness inside the launch, so there the
ack draws are not counted (the count stays a lower one), as in
``mega_kernel.py``."""

from gossipbench import peaks
from gossipbench.bounds import mega_kernel

#: the frame's lanes: ten f32, two bool
FRAME_BYTES = 10 * 4 + 2 * 1
BODY_F32_OPS = 2 * 13 + 6 + 20 + 8
FAULT_F32_OPS = 4 + 2 + 6 + 3
BYZ_F32_OPS = 2


def launch(cfg: dict, n: int) -> dict:
    churn = bool(cfg["fail_per_round"] or cfg["rejoin_per_round"]
                 or cfg["leave_per_round"])
    blocks = max(1, min(mega_kernel.GRID_BLOCKS, -(-n // mega_kernel.TILE)))
    nbytes = n * (2 * mega_kernel.NODE_BYTES + FRAME_BYTES) \
        + 4 * mega_kernel.N_SCALARS + 4 + 4 * mega_kernel.N_LANES * blocks \
        + 4
    draws = n * (2 + int(bool(cfg["slow_per_round"]))) + (0 if churn else n)
    int_ops = n * mega_kernel.PHILOX_INT_OPS \
        + draws * mega_kernel.DRAW_INT_OPS
    f32_ops = n * (BODY_F32_OPS + FAULT_F32_OPS + BYZ_F32_OPS)
    return peaks.bound(nbytes, int_ops, f32_ops)


def bound_s(cfg: dict, traffic: dict, n: int) -> float:
    if traffic["R"] != 1:
        raise ValueError("a fault frame shapes one period a launch (R = 1)")
    return launch(cfg, n)["bound_s"]
