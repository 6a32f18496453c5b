"""The least time one ``mega_kernel`` launch (R periods of every node on
frozen scalars) needs, from the configuration and the shapes alone.

Bytes: the 15 B/node packed state read once and written once (13 when
down_age cannot change), the 8 stale scalars, R seeds, and the
[min(528, tiles of 512), 18] f32 partial-sum table. Operations, a lower
count of what every node does in every period: one Philox4x32-10 call
(10 rounds of two widening multiplies and two three-input xors: 40
integer operations), a shift and a conversion per uniform drawn (the
Poisson draw of every node, its churn and slow draws where those models
are on, the ack draw of every live node), and 14 f32 operations (the
ack test, four threshold compares, the miss weight, 8 scalar lanes).
The suspicion, refutation and growth terms depend on the data and are
not counted, so the bound is low where they weigh.

A frozen copy of the program's ``costmodel.kernel_bound`` for a frame-
less configuration. Without churn every node of the initial state stays
live, and all draw for the ack. Churn moves liveness inside a launch,
so there the ack draws are not counted (the count stays a lower one):
the program's count for a churn-free launch on a state with no live
node, plus every node's churn draw."""

from gossipbench import peaks

NODE_BYTES = 15
PHILOX_INT_OPS = 10 * (2 + 2)
DRAW_INT_OPS = 2
TABLE_BODY_F32_OPS = 1 + 4 + 1 + 8
N_SCALARS, N_LANES, TILE, GRID_BLOCKS = 8, 18, 512, 528


def launch(cfg: dict, n: int, R: int) -> dict:
    churn = bool(cfg["fail_per_round"] or cfg["rejoin_per_round"]
                 or cfg["leave_per_round"])
    age_mutable = bool(churn or cfg["collect_stats"]
                       or cfg["slow_per_round"])
    written = NODE_BYTES - (0 if age_mutable else 2)
    blocks = max(1, min(GRID_BLOCKS, -(-n // TILE)))
    nbytes = n * (NODE_BYTES + written) + 4 * N_SCALARS + 4 * R \
        + 4 * N_LANES * blocks
    draws = n * (1 + int(churn) + int(bool(cfg["slow_per_round"]))) \
        + (0 if churn else n)
    int_ops = R * (n * PHILOX_INT_OPS + draws * DRAW_INT_OPS)
    return peaks.bound(nbytes, int_ops, R * n * TABLE_BODY_F32_OPS)


def bound_s(cfg: dict, traffic: dict, n: int) -> float:
    """Mean least seconds of one launch in a call of the traffic."""
    return launch(cfg, n, traffic["R"])["bound_s"]
