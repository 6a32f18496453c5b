"""The check catches a broken timed path: a run on the CPU (the
harness's look for a chip skipped) with the program broken underneath
comes out not correct, once for each fault a cell can have. A cell runs
on one chip, so there is no exchange between chips to leave out.

* a call that returns its state unchanged;
* half of the nodes left out of a call (the second half keeps its
  state);
* an answer altered where it is produced (one node's status, or one
  counter, off by one after the call).
"""

import pytest

from consul_tpu_torch.sim.state import SimState, SimStats, STATS_FIELDS
from gossipbench import harness

N = 1024
CELLS = ("lan-1m.long", "lan-1m.chunked", "wan-1m-churn5.live",
         "wan-1m-churn5.lanes")


def _state(snap) -> SimState:
    return SimState(*[a.clone() for a in snap["lanes"]], t=snap["t"],
                    round_idx=snap["round_idx"],
                    stats=SimStats(**dict(zip(STATS_FIELDS,
                                              snap["stats"]))))


def unchanged(driver):
    call = driver.call

    def broken():
        before = driver.snapshot()
        out = call()
        driver.state = _state(before)
        return out

    driver.call = broken
    return driver


def half(driver):
    call = driver.call

    def broken():
        before = driver.snapshot()
        out = call()
        for a, b in zip(driver.state.node_arrays(), before["lanes"]):
            a[N // 2:] = b[N // 2:]
        return out

    driver.call = broken
    return driver


def altered_status(driver):
    call = driver.call

    def broken():
        out = call()
        driver.state.status[N // 3] += 1
        return out

    driver.call = broken
    return driver


def altered_counter(driver):
    call = driver.call

    def broken():
        out = call()
        st = driver.state.stats
        driver.state = driver.state._replace(
            stats=st._replace(suspicions=st.suspicions + 1))
        return out

    driver.call = broken
    return driver


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half, altered_status,
                                   altered_counter],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(cell, fault):
    res, _ = harness.run_cell(cell, 11, 0.05, False, device="cpu", n=N,
                              driver_hook=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The control, the reference in bfloat16 in the program's place,
    fails the cell's limits at a size a test run holds."""
    from gossipbench import check

    res, info = harness.run_cell(cell, 12, 0.05, False, device="cpu", n=N,
                                 control=True)
    assert res["correct"]
    limits = harness.load_json("workloads", cell)["limits"]
    ok, checks = check.judge(info["control"], limits)
    assert not ok, checks
