"""On the card: one short run of every cell is correct, prints its
result as the last line, and holds no JAX module."""

import json
import subprocess
import sys

import pytest

CELLS = ("lan-1m.long", "lan-1m.chunked", "wan-1m-churn5.live",
         "wan-1m-churn5.lanes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "gossipbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 404), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
