"""A grid of pools in the form the check reads one pool in.

A grid cell runs G points of ``pool`` agents each (``[G, pool]`` lanes,
``[G]`` clocks, round indices and counters). The check (``check.py``)
compares one state: ``fold`` flattens the lanes point-major to
``[G * pool]``, so that ``nodes_off`` and ``informed_gap`` cover every
agent of every point, and adds the clocks, round indices and counters
over the points in f64, in point order; the per-point counters, clock
and live fraction, the inputs of the sweep's report, ride as the
check's ``scalars`` (``report_inputs``). The driver and the reference
both fold with this module, so the two sides add in the same order.

Plain PyTorch: nothing of the program.
"""

from __future__ import annotations

import torch

#: rows of ``report_inputs``: the ten counters (in the reference's
#: order, ``model.STATS_FIELDS``), the clock, the live fraction
N_REPORT = 12


def point_sum(x: torch.Tensor) -> torch.Tensor:
    """A ``[G]`` tensor's sum in f64, added in point order, as a 0-d f64
    tensor on the host."""
    total = 0.0
    for v in x.double().cpu().tolist():
        total += v
    return torch.tensor(total, dtype=torch.float64)


def fold(lanes, t, round_idx, stats) -> dict:
    """The check's form of a grid state: ``lanes`` 8 ``[G, pool]``
    tensors, ``t`` / ``round_idx`` ``[G]``, ``stats`` 10 ``[G]``
    tensors in the reference's order."""
    return {"lanes": tuple(a.reshape(-1).clone() for a in lanes),
            "t": point_sum(t), "round_idx": point_sum(round_idx),
            "stats": tuple(point_sum(x) for x in stats)}


def report_inputs(lanes, t, stats) -> torch.Tensor:
    """``[12, G]`` f64: each point's counters, its clock and its live
    fraction (the share of its agents with ``down_age < 0``), what the
    sweep's report ranks the points by."""
    return torch.stack([x.double() for x in stats]
                       + [t.double(), (lanes[3] < 0).double().mean(-1)])
