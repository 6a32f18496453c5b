"""The least time one ``lane_round`` launch over a grid needs: G pools
of ``n / G`` agents (the configuration's ``points``) in one launch at
stale_k 1, as ``bounds/lane_round.py`` counts a pool, but with the
period's slot rows read once for the pool and shared by every point
(the grid's key stream is one), and one 20-column constant row and 8
scalars a point. A frozen copy of the program's ``costmodel.lane_bound``
on ``[G, pool]`` lanes and ``[slots, pool]`` slot rows.

``bounds/lane_round.py`` at the grid's ``n`` counts slot rows for every
agent-row: 16 (n - pool) bytes more, less the 63 table rows and scalar
sets it leaves out, ~10% of the launch's bytes at 64 x 65,536."""

from gossipbench import peaks
from gossipbench.bounds import lane_round


def launch(cfg: dict, n: int) -> dict:
    g = cfg["points"]
    pool = n // g
    churn = bool(cfg["fail_per_round"] or cfg["rejoin_per_round"]
                 or cfg["leave_per_round"])
    slots = 3 + int(churn) + int(bool(cfg["slow_per_round"]))
    rows = lane_round.N_STACK if cfg["collect_stats"] \
        else lane_round.N_STACK - lane_round.N_COUNTERS
    read = n * lane_round.NODE_BYTES + 4 * slots * pool \
        + 4 * (lane_round.N_SCALARS + lane_round.N_COLUMNS) * g
    written = n * lane_round.NODE_BYTES + 4 * rows * n
    return peaks.bound(read + written, 0, n * lane_round.BODY_F32_OPS)


def bound_s(cfg: dict, traffic: dict, n: int) -> float:
    if traffic.get("stale_k", 1) != 1:
        raise ValueError("the grid's count is of stale_k 1 launches")
    return launch(cfg, n)["bound_s"]
