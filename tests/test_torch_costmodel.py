"""consul_tpu_torch's cost model and record ledger (sim/costmodel.py)
against the JAX reference's, on the CPU.

* ``analytic_cost`` equals the reference's key for key for every engine
  (``cuda`` against ``pallas``) over stale_k, flight decimation, the
  black box and rounds_per_call; ``STATE_FIELD_BYTES`` is the port's
  ``init_state`` leaves.
* ``OpCounter`` on hand-counted programs (``a + b`` on f32 [1024] is
  12,288 bytes and 1,024 operations; views count nothing), and
  ``measured_cost``'s marginal protocol: the init work of a run cancels,
  leaving one round's count.
* ``measure_config``: the ``PROFILE_ROOFLINE_ROW`` schema, ``util ==
  achieved_gbps / peak``, every rep observed by the reference's
  ``PerfRegistry`` as ``sim.round.<config>``, the cadence refusal, and
  the kernel runner refused off the card; ``roofline_table`` at 1,024
  nodes measures the six eager rows and skips the three ``cuda`` rows by
  name.
* The ledger: ``validate_record`` of both packages agrees on every root
  ``*_r*.json`` record and on mutated records (same refusal, same key
  named); ``history_rows``, ``latest_metric``, ``latest_profile_util``
  and ``check_regression`` equal the reference's.
* The bench's record modes: exit codes of the mode combinations,
  ``--history`` and ``--check-regression`` over a ``tmp_path`` record
  root, and ``_record_next``'s one validated, atomic writer.
* On the card (``cuda`` marker): ``measure_config`` of the kernel runner
  at R=1 and R=4, 65,536 nodes — its counted bytes are ``kernel_bound``'s
  per round and its launches are exact.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil

import pytest
import torch

from consul_tpu_torch import bench
from consul_tpu_torch.config import GossipConfig
from consul_tpu_torch.sim import costmodel as cm
from consul_tpu_torch.sim import cuda_round, graphs, registry
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.params import SimParams
from test_torch_harness import ROOT, cuda, ref  # noqa: F401  (fixtures)

CPU = "cpu"
RECORDS = sorted(f for f in os.listdir(ROOT) if cm._RECORD_RE.match(f))


def _lan(n, **kw):
    return SimParams.from_gossip_config(GossipConfig.lan(), n=n, loss=0.01,
                                        tcp_fallback=False, **kw)


def _ref_params(p):
    from consul_tpu.sim.params import SimParams as RefParams

    return RefParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})


# ------------------------------------------------------ analytic model


@pytest.mark.parametrize("engine", cm.ENGINES)
def test_analytic_cost_equals_reference(ref, engine):
    from consul_tpu.sim import costmodel as rcm

    r_engine = "pallas" if engine == "cuda" else engine
    for kw in ({}, {"slow_per_round": 0.001},
               {"fail_per_round": 0.002, "rejoin_per_round": 0.02}):
        for k in (1, 2, 4):
            p = _lan(4096, stale_k=k, **kw)
            rp = _ref_params(p)
            for rounds, every, bb, rpc in ((24, None, False, 1),
                                           (100, 10, False, 1),
                                           (100, 10, True, 4),
                                           (96, 50, True, 8)):
                got = cm.analytic_cost(p, rounds, engine, record_every=every,
                                       blackbox=bb, rounds_per_call=rpc)
                want = rcm.analytic_cost(rp, rounds, r_engine,
                                         record_every=every, blackbox=bb,
                                         rounds_per_call=rpc)
                want["engine"] = engine
                assert got == want, (kw, k, rounds, every, bb, rpc)
    with pytest.raises(ValueError, match="unknown cost-model engine"):
        cm.analytic_cost(_lan(64), 24, "pallas")


def test_state_field_bytes_match_init_state(ref):
    from consul_tpu.sim import costmodel as rcm

    s = tstate.init_state(64, device=CPU)
    per_node = {f: getattr(s, f).element_size() for f in tstate.NODE_FIELDS}
    assert dict(cm.STATE_FIELD_BYTES) == per_node
    assert cm.STATE_FIELD_BYTES == rcm.STATE_FIELD_BYTES
    assert cm.state_bytes_per_node() == 15 == sum(per_node.values())
    assert [cm.reductions_per_run(r, k, o) for r, k, o in
            ((24, 4, False), (25, 4, False), (24, 4, True))] == \
        [rcm.reductions_per_run(r, k, o) for r, k, o in
         ((24, 4, False), (25, 4, False), (24, 4, True))] == [8, 9, 9]
    # the registry keeps the reference's engine slot for its digest
    assert "pallas" in registry.COSTMODEL_ENGINES
    assert [cm.config_label(*a) for a in (("cuda", 1, 4), ("cuda",),
                                          ("lanes", 2, 1, 128),
                                          ("overlap", 4))] == \
        ["cuda-x4", "cuda", "lanes-k2-b128", "overlap-k4"]


# ------------------------------------------------------- the counter


def test_op_counter_on_hand_counted_programs():
    a, b = torch.ones(1024), torch.full((1024,), 2.0)
    with cm.OpCounter() as c:
        a + b
    assert (c.bytes, c.ops, c.calls) == (12_288, 1024, 1)
    with cm.OpCounter() as c:
        a.add_(b)          # reads a and b, writes a: counted as such
    assert (c.bytes, c.ops) == (12_288, 1024)
    with cm.OpCounter() as c:
        a.view(32, 32)
        a[::2]
        a.reshape(4, 256).t()
    assert (c.bytes, c.ops, c.calls) == (0, 0, 0)
    x, y = torch.ones(8, 16), torch.ones(16, 4)
    with cm.OpCounter() as c:
        x @ y
        torch.zeros(10, dtype=torch.int64).sum()
    # the matmul reads both operands and writes the product; zeros
    # writes its output; the sum reads it and writes one int64
    assert c.bytes == (128 + 64 + 32) * 4 + 80 + (80 + 8)
    assert (c.ops, c.calls) == (32 + 10 + 1, 3)


def test_marginal_protocol_cancels_init_work():
    p = _lan(1024, collect_stats=False)
    marginal, ops = cm.measured_cost(p, "fast", device=CPU)
    s = tstate.init_state(1024, device=CPU)
    sc = tround.init_scalars(s, p)
    from consul_tpu_torch.sim import prng

    key = prng.round_keys(prng.key(0), 0, 1)[0]
    c = tround.FastCarry(tround.own_scalars(s), sc)
    with cm.OpCounter() as one:
        # the runner writes each round into the carry (a CUDA graph of
        # one round replays on it)
        graphs.assign(c, tround.FastCarry(*tround.gossip_round_fast(
            c.state, c.scalars, key, p)))
    with cm.OpCounter() as run1:
        tround.make_run_rounds_fast(p, 1)(
            tstate.init_state(1024, device=CPU), prng.key(0))
    # what a round adds is one round's ops (and one more round key);
    # a whole one-round run also pays init_scalars and the key set-up
    assert abs(marginal - one.bytes) <= 1e-3 * one.bytes
    assert abs(ops - one.ops) <= 1e-3 * one.ops
    assert run1.bytes - marginal > 0.05 * marginal
    # the lane engine differences a window of k rounds
    b4, _ = cm.measured_cost(p.with_(stale_k=4), "lanes", device=CPU)
    b1, _ = cm.measured_cost(p, "lanes", device=CPU)
    assert 0.5 * b1 < b4 < 1.5 * b1


# ------------------------------------------------- timed attribution


def test_measure_config_row_schema_and_perf_registry(ref):
    from consul_tpu.utils import perf

    p = _lan(1024)
    reg = perf.PerfRegistry()
    was_armed = perf.armed()
    perf.arm()
    try:
        row = cm.measure_config(p, rounds=4, engine="fast", reps=2,
                                peak_gbps=10.0, measure_bytes=False,
                                perf_registry=reg, device=CPU)
    finally:
        if not was_armed:
            perf.disarm()
    assert tuple(sorted(row)) == tuple(sorted(registry.PROFILE_ROOFLINE_ROW))
    assert row["ms_per_round"] > 0 and row["bytes_measured"] is None
    assert row["temp_bytes_measured"] is None
    assert row["util"] == pytest.approx(row["achieved_gbps"] / 10.0,
                                        rel=1e-3)
    assert reg.snapshot()["Stages"]["sim.round.fast"]["Count"] == 2
    # counted bytes, the ratio to the model, and the spread on request
    row = cm.measure_config(p.with_(stale_k=2), rounds=4, engine="lanes",
                            reps=3, peak_gbps=10.0, return_samples=True,
                            device=CPU)
    assert row["config"] == "lanes-k2" and row["lane_blocks"] == 64
    assert row["model_vs_measured"] == pytest.approx(
        row["bytes_measured"] / row["bytes_model"], rel=1e-3)
    assert row["flagged"] == (not 0.5 <= row["model_vs_measured"] <= 2.0)
    assert len(row.pop("samples_ms_per_round")) == 3
    assert tuple(sorted(row)) == tuple(sorted(registry.PROFILE_ROOFLINE_ROW))
    with pytest.raises(ValueError, match="multiple of the reduction"):
        cm.measure_config(p.with_(stale_k=3), rounds=4, engine="lanes",
                          device=CPU)
    with pytest.raises(cm.EngineUnavailable, match="only on a card"):
        cm.measure_config(p, rounds=8, engine="cuda", rounds_per_call=4,
                          device=CPU)
    with pytest.raises(ValueError, match="block-shape knob"):
        cm.measure_config(p, rounds=4, engine="fast", lane_blocks=32,
                          device=CPU)


def test_roofline_table_skips_only_the_kernel_rows_off_the_card():
    p = bench.diag_params(1024)
    bw = cm.measure_bandwidth(mbytes=4, reps=1, device=CPU)
    tab = cm.roofline_table(p, rounds=8, reps=1, bandwidth=bw, device=CPU)
    rows = {r["config"]: r for r in tab["rows"]}
    assert list(rows) == ["xla", "fast", "lanes", "lanes-k2", "lanes-k4",
                          "overlap-k4", "cuda", "cuda-x4", "cuda-x8"]
    measured = [r for r in tab["rows"] if "skipped" not in r]
    assert len(measured) == 6
    for name in ("cuda", "cuda-x4", "cuda-x8"):
        assert rows[name]["skipped"].startswith("EngineUnavailable")
        assert set(rows[name]) == {"config", "engine", "stale_k",
                                   "rounds_per_call", "skipped"}
    for r in measured:
        assert r["bytes_model"] == round(cm.analytic_cost(
            p.with_(stale_k=r["stale_k"]), 8, r["engine"])[
                "bytes_per_round"], 1)
        assert r["bytes_measured"] > 0 and r["util"] > 0
    assert tab["flags"] == [r["config"] for r in measured if r["flagged"]]
    cm.validate_record("PROFILE_r01.json", {
        "metric": "m", "value": 1.0, "unit": "rounds/s", "platform": "cpu",
        "schema": registry.PROFILE_SCHEMA_VERSION,
        "profile": {"roofline": tab}})


def test_measure_bandwidth_on_the_cpu():
    bw = cm.measure_bandwidth(mbytes=4, reps=2, device=CPU)
    assert bw["copy_gbps"] > 0 and bw["triad_gbps"] > 0
    assert bw["peak_gbps"] == max(bw["copy_gbps"], bw["triad_gbps"])
    assert bw["platform"] == "cpu" and bw["device"] == "cpu"


# ----------------------------------------------------------- the ledger


def _refusal(validate, name, data):
    try:
        validate(name, data)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("fn", RECORDS)
def test_validate_record_agrees_on_every_root_record(ref, fn):
    from consul_tpu.sim import costmodel as rcm

    with open(os.path.join(ROOT, fn)) as f:
        data = json.load(f)
    assert _refusal(cm.validate_record, fn, data) is None
    assert _refusal(rcm.validate_record, fn, data) is None


def _mutations():
    """(name, record file, mutation) — each breaks one schema rule."""
    def drop(*path):
        def f(d):
            for k in path[:-1]:
                d = d[k]
            del d[path[-1]]
        return f

    def put(value, *path):
        def f(d):
            for k in path[:-1]:
                d = d[k]
            d[path[-1]] = value
        return f

    return [
        ("bench_envelope_key", "BENCH_r03.json", drop("parsed", "vs_baseline")),
        ("bench_parsed_type", "BENCH_r03.json", put([1], "parsed")),
        ("bench_value_type", "BENCH_r03.json", put("fast", "parsed", "value")),
        ("profile_roofline", "PROFILE_r04.json", drop("profile", "roofline")),
        ("profile_row_key", "PROFILE_r04.json",
         drop("profile", "roofline", "rows", 0, "util")),
        ("profile_too_few_rows", "PROFILE_r04.json",
         put([], "profile", "roofline", "rows")),
        ("tune_rows_empty", "TUNE_r01.json", put([], "rows")),
        ("tune_winner_key", "TUNE_r01.json", drop("winner", "lane_blocks")),
        ("tune_rate_type", "TUNE_r01.json",
         put("fast", "winner", "rounds_per_sec")),
        ("multichip_ladder", "MULTICHIP_r07.json", drop("ladder")),
        ("sweep_class_key", "SWEEP_r01.json",
         drop("classes", "lan", "pareto")),
        ("serve_headline", "SERVE_r01.json", drop("headline_rps")),
        ("chaos_wall_type", "CHAOS_r01.json", put("slow", "wall_s")),
        ("twin_resume", "TWIN_r01.json",
         put(False, "ladder", 0, "resume_digest_equal")),
        ("users_saturation", "USERS_r01.json", put(0, "saturation",
                                                   "rejected")),
        ("raft_coverage", "RAFT_r01.json",
         put(0.5, "ladder", -1, "coverage_p50")),
        ("raft_shards", "RAFT_r02.json", put(3, "cluster", "raft_shards")),
        ("byz_key", "BYZ_r01.json", drop("corroboration_sweep")),
    ]


@pytest.mark.parametrize("name,fn,mutate", _mutations(),
                         ids=[m[0] for m in _mutations()])
def test_validate_record_refuses_as_the_reference_does(ref, name, fn,
                                                       mutate):
    from consul_tpu.sim import costmodel as rcm

    with open(os.path.join(ROOT, fn)) as f:
        data = json.load(f)
    mutate(data)
    got = _refusal(cm.validate_record, fn, data)
    assert got is not None, name
    assert got == _refusal(rcm.validate_record, fn, data)
    assert got[0] == "LedgerError" and got[1].startswith(fn.split(".")[0])


def test_validate_record_refuses_names_as_the_reference_does(ref):
    from consul_tpu.sim import costmodel as rcm

    for name, data in (("VIBES_r01.json", {}), ("BENCH_r09.json", [1]),
                       ("notes.json", {})):
        got = _refusal(cm.validate_record, name, data)
        assert got is not None and got == _refusal(rcm.validate_record,
                                                   name, data)


def test_ledger_history_and_baselines_equal_the_reference(ref, tmp_path):
    from consul_tpu.sim import costmodel as rcm

    records = cm.load_ledger(str(ROOT))
    assert len(records) == len(RECORDS) >= 30
    assert records == rcm.load_ledger(str(ROOT))
    rows = cm.history_rows(records)
    # the one wording the port's notes change: the early MULTICHIP
    # probe records are a "harness probe" in its table

    def tail(rs):
        return [{**r, "note": r["note"].split(" probe ")[-1]} for r in rs]

    assert tail(rows) == tail(rcm.history_rows(records))
    assert sum(r["note"].startswith("harness probe (") for r in rows) == 5
    assert cm.format_history(rows) == rcm.format_history(rows)
    for metric in ("gossip_rounds_per_sec_1M_nodes",
                   "gossip_rounds_per_sec_smoke",
                   "autotune_rounds_per_sec_smoke", "no_such_metric"):
        assert cm.latest_metric(records, metric) == \
            rcm.latest_metric(records, metric)
    assert cm.latest_profile_util(records) == \
        rcm.latest_profile_util(records)
    # a torn record on disk is refused by file name
    (tmp_path / "TUNE_r01.json").write_text("{not json")
    with pytest.raises(cm.LedgerError, match="TUNE_r01.json"):
        cm.load_ledger(str(tmp_path))


@pytest.mark.parametrize("case", ["slowdown_20pct", "noisy_host",
                                  "too_few", "pass", "faster"])
def test_check_regression_equals_the_reference(ref, case):
    from consul_tpu.sim import costmodel as rcm

    base = 1000.0
    samples = {"slowdown_20pct": [800.0, 801.0, 799.0, 800.5, 800.2],
               "noisy_host": [500.0, 1400.0, 800.0, 1100.0, 600.0],
               "too_few": [500.0, 510.0],
               "pass": [990.0, 1001.0, 995.0, 1003.0, 998.0],
               "faster": [1500.0, 1490.0, 1510.0]}[case]
    got = cm.check_regression(samples, base)
    assert got == rcm.check_regression(samples, base)
    assert got["verdict"] == {"slowdown_20pct": "regression",
                              "noisy_host": "unstable",
                              "too_few": "unstable", "pass": "pass",
                              "faster": "pass"}[case]
    with pytest.raises(ValueError, match="positive recorded baseline"):
        cm.check_regression(samples, 0.0)


# ------------------------------------------------------ bench's modes


def _main(argv, env_root=None, monkeypatch=None):
    if env_root is not None:
        monkeypatch.setenv(bench.RECORD_ROOT_ENV, str(env_root))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = bench.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["--history", "--check-regression"], ["--autotune", "--history"],
    ["--autotune", "--chaos"], ["--sweep", "--check-regression"],
    ["--history", "--ckpt-dir", "x"], ["--autotune", "--ckpt-dir", "x"],
    ["--history", "--resume"], ["--check-regression", "--profile"],
    ["--autotune", "--profile"], ["--history", "--profile"],
    ["--family", "BENCH"], ["--autotune", "--metric", "m"],
    ["--check-regression", "--family", "SERVE"],
], ids=lambda a: "_".join(x.strip("-") for x in a))
def test_bench_mode_combinations_exit_2(argv, tmp_path, monkeypatch):
    rc, out, err = _main(argv, tmp_path, monkeypatch)
    assert rc == 2 and "usage:" in err and not out
    assert os.listdir(tmp_path) == []


def test_bench_history_over_a_record_root(tmp_path, monkeypatch):
    rc, _, err = _main(["--history"], tmp_path / "none", monkeypatch)
    assert rc == 2 and "no recorded" in err
    for fn in ("BENCH_r03.json", "TUNE_r01.json", "PROFILE_r04.json"):
        shutil.copy(ROOT / fn, tmp_path / fn)
    rc, out, _ = _main(["--history"], tmp_path, monkeypatch)
    assert rc == 0 and "3 records, 3 families" in out
    assert all(fn in out for fn in ("BENCH_r03.json", "TUNE_r01.json"))
    (tmp_path / "BENCH_r04.json").write_text(json.dumps({"n": 1}))
    rc, _, err = _main(["--history"], tmp_path, monkeypatch)
    assert rc == 1 and "BENCH_r04.json" in err


def test_bench_check_regression_over_a_record_root(tmp_path, monkeypatch):
    rc, _, err = _main(["--check-regression", "--smoke"], tmp_path,
                       monkeypatch)
    assert rc == 2 and "never fabricated" in err
    rc, _, err = _main(["--check-regression", "--family", "PROFILE"],
                       tmp_path, monkeypatch)
    assert rc == 2 and "never fabricated" in err
    rc, _, err = _main(["--check-regression", "--smoke", "--metric",
                        "gossip_rounds_per_sec_1M_nodes"], tmp_path,
                       monkeypatch)
    assert rc == 2 and "cannot compare" in err
    # a recorded smoke headline, then fresh samples stubbed
    rec = json.loads((ROOT / "BENCH_r03.json").read_text())
    rec["parsed"] = {"metric": "gossip_rounds_per_sec_smoke",
                     "value": 1000.0, "unit": "rounds/s",
                     "vs_baseline": None}
    assert bench._record_next("BENCH", rec, str(tmp_path))
    for samples, want_rc, verdict in (
            ([990.0, 1001.0, 995.0, 1003.0, 998.0], 0, "pass"),
            ([800.0, 801.0, 799.0, 800.5, 800.2], 1, "regression"),
            ([500.0, 1400.0, 800.0, 1100.0, 600.0], 0, "unstable")):
        monkeypatch.setattr(bench, "headline_samples",
                            lambda smoke, s=samples: s)
        rc, out, _ = _main(["--check-regression", "--smoke"], tmp_path,
                           monkeypatch)
        res = json.loads(out)
        assert rc == want_rc and res["verdict"] == verdict
        assert res["baseline_file"] == "BENCH_r01.json"
    # a PROFILE baseline measured on the card refuses a --smoke run
    shutil.copy(ROOT / "PROFILE_r04.json", tmp_path / "PROFILE_r01.json")
    prof = json.loads((tmp_path / "PROFILE_r01.json").read_text())
    prof.pop("smoke")
    (tmp_path / "PROFILE_r01.json").write_text(json.dumps(prof))
    rc, _, err = _main(["--check-regression", "--smoke", "--family",
                        "PROFILE"], tmp_path, monkeypatch)
    assert rc == 2 and "without --smoke" in err


def test_record_next_validates_then_writes_atomically(tmp_path):
    root = str(tmp_path / "records")
    tune = json.loads((ROOT / "TUNE_r01.json").read_text())
    assert bench._record_next("TUNE", tune, root).endswith("TUNE_r01.json")
    assert bench._record_next("TUNE", tune, root).endswith("TUNE_r02.json")
    broken = copy.deepcopy(tune)
    del broken["winner"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert bench._record_next("TUNE", broken, root) is None
    assert "NOT recorded" in err.getvalue() and "winner" in err.getvalue()
    assert sorted(os.listdir(root)) == ["TUNE_r01.json", "TUNE_r02.json"]
    assert [r["round"] for r in cm.load_ledger(root)] == [1, 2]
    # the default root is the package's records directory, not the repo's
    assert bench._record_root() == os.path.join(
        os.path.dirname(bench.__file__), "records")


# --------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("rpc", [1, 4])
def test_measure_config_counts_the_kernel_runner(cuda, rpc):
    n, rounds, reps = 65_536, 8, 2
    p = bench.diag_params(n)
    cuda_round.reset_launches()
    row = cm.measure_config(p, rounds=rounds, engine="cuda",
                            rounds_per_call=rpc, reps=reps,
                            peak_gbps=3350.0, device=cuda)
    name = "round_kernel/full" if rpc == 1 else "mega_kernel/full"
    assert dict(cuda_round.LAUNCHES) == {name: (2 + reps) * rounds // rpc}
    arrays = tstate.init_state(n, device=cuda).node_arrays()
    kb = cm.kernel_bound(p, arrays, rpc)
    assert row["bytes_measured"] == round(kb["bytes"] / rpc, 1)
    assert row["config"] == ("cuda" if rpc == 1 else f"cuda-x{rpc}")
    assert row["temp_bytes_measured"] is not None
    assert 0 < row["util"] < 1
