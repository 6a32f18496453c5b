"""A later change adds a configuration, a cell, a traffic mix, a driver,
a metric reader and a frozen bound as files of their own: here, in a
temporary copy of the benchmark, with no file that is there edited, and
one run of the new cell on the CPU reports the new metric."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from gossipbench import harness

ROOT = pathlib.Path(harness.__file__).resolve().parent
REPO = ROOT.parent

DRIVER = '''"""The live engine under another name."""
from consul_tpu_torch.sim import round as round_mod
from gossipbench import program


class Driver(program.Driver):
    def build(self):
        self.run = round_mod.make_run_rounds(self.p, self.rounds)

    def call(self):
        self.state = self.run(self.state, self.key)
        self.calls += 1
        return self.counters()
'''
BOUND = '''def bound_s(cfg, traffic, n):
    return 4.0 * 15 * n / 3.35e12
'''
READER = '''import importlib


def read(ctx):
    b = importlib.import_module("gossipbench.bounds.copy_kernel")
    return b.bound_s(ctx.cfg, ctx.traffic, ctx.n) * 1e6
'''


def test_a_cell_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT, root / "gossipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "gossipbench").rglob("*")
              if p.is_file()}
    g = root / "gossipbench"
    cfg = json.loads((g / "configs" / "wan-1m-churn5.json").read_text())
    cfg["name"] = "wan-64k-churn5"
    cfg["n"] = 65536
    (g / "configs" / "wan-64k-churn5.json").write_text(json.dumps(cfg))
    traffic = json.loads((g / "traffic" / "live.json").read_text())
    traffic.update(driver="live_again", rounds=4, trace_calls=1)
    (g / "traffic" / "short_live.json").write_text(json.dumps(traffic))
    (g / "drivers" / "live_again.py").write_text(DRIVER)
    (g / "bounds" / "copy_kernel.py").write_text(BOUND)
    (g / "metrics" / "copy_kernel_us.py").write_text(READER)
    spec = json.loads((g / "workloads" / "wan-1m-churn5.live.json")
                      .read_text())
    spec.update(config="wan-64k-churn5", traffic="short_live")
    (g / "workloads" / "wan-64k-churn5.short_live.json").write_text(
        json.dumps(spec))
    cell = "wan-64k-churn5.short_live"
    bench["workloads"].append({"name": cell, "config": "wan-64k-churn5",
                               "traffic": "short_live", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "node_rounds_per_s":
            m.setdefault("workloads", []).append(cell)
    bench["per_layer"].append({
        "name": "copy_kernel_us", "unit": "us", "better": "lower",
        "source": "device_trace", "layer": "kernels",
        "moves": "node_rounds_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from gossipbench import harness; "
            "assert harness.__file__.startswith(%r); "
            "r, i = harness.run_cell(%r, 9, 0.01, True, device='cpu', "
            "n=1024); print(json.dumps(r))" % (str(root), cell))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["copy_kernel_us"]["value"] == \
        4.0 * 15 * 1024 / 3.35e12 * 1e6
    assert res["correct"], res["checks"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
