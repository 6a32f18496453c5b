"""The least time one ``lane_round`` launch (one lane-mode period of
every node) needs, averaged over the launches of a staleness-k window.

Read once: the 15 B/node packed state, the period's slot rows (4 B a
node a slot: ack, Poisson, hearing always, churn and slow where those
models are on), the 8 scalars and the 20-column constant row, and the
stack's 10 counter rows again on a window's later periods (they add
onto the first's). Written once: the state, the 10 counter rows, and on
a window's last period the 22 other stack rows (scalars, gauges, the
local-health histogram). Operations: 60 f32 operations a node (two
no-ack evaluations of 13, the ack mix and test 6, the truncated
Poisson 20, 8 scalar lanes); no integer work. A frozen copy of the
program's ``costmodel.lane_bound`` for a frame-less period."""

from gossipbench import peaks

NODE_BYTES = 15
N_STACK, N_COUNTERS, N_SCALARS, N_COLUMNS = 32, 10, 8, 20
BODY_F32_OPS = 2 * 13 + 6 + 20 + 8


def launch(cfg: dict, n: int, slots: int, stats: str, inst: bool) -> dict:
    rows = (N_STACK - N_COUNTERS if inst else 0) \
        + (N_COUNTERS if stats != "skip" else 0)
    read = n * NODE_BYTES + 4 * slots * n + 4 * (N_SCALARS + N_COLUMNS) \
        + (4 * N_COUNTERS * n if stats == "add" else 0)
    written = n * NODE_BYTES + 4 * rows * n
    return peaks.bound(read + written, 0, n * BODY_F32_OPS)


def window(cfg: dict, n: int, k: int) -> list:
    churn = bool(cfg["fail_per_round"] or cfg["rejoin_per_round"]
                 or cfg["leave_per_round"])
    slots = 3 + int(churn) + int(bool(cfg["slow_per_round"]))
    out = []
    for j in range(k):
        if cfg["collect_stats"]:
            stats = "add" if j else "write"
        else:
            stats = "write" if j == k - 1 else "skip"
        out.append(launch(cfg, n, slots, stats, j == k - 1))
    return out


def bound_s(cfg: dict, traffic: dict, n: int) -> float:
    k = traffic.get("stale_k", 1)
    if traffic["rounds"] % k:
        raise ValueError("the count covers whole windows")
    launches = window(cfg, n, k)
    return sum(b["bound_s"] for b in launches) / len(launches)
