"""The round kernels' plain versions, wrappers and runner.

On the CPU the wrappers take the plain versions, which must equal
``round_core`` fed the kernels' Philox uniforms (except down_age of dead
rows in the stable variant, pinned frozen as the TPU kernel's is; and,
with a fault frame, the n_slow scalar lane, which the kernels count
without the forced-slow nodes as the TPU kernel does); the R-round
version must equal R per-round calls on frozen scalars; a run resumed
from the scalars carry must be bitwise the straight run, with or
without a fault plan. The ``cuda``-marked tests repeat the
kernel-vs-plain checks on the card, the fault and byz variants
included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from consul_tpu_torch import bench
from consul_tpu_torch import faults as tfaults
from consul_tpu_torch.sim import costmodel
from consul_tpu_torch.sim import cuda_round as cr
from consul_tpu_torch.sim import flight
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.params import SimParams
from test_torch_harness import cuda  # noqa: F401  (fixture)

N = 8192

STABLE = SimParams(n=N, loss=0.05, tcp_fallback=False, collect_stats=False)
FULL = SimParams(n=N, loss=0.05, tcp_fallback=False, slow_per_round=0.002,
                 collect_stats=True)
CHURN = FULL.with_(fail_per_round=0.002, rejoin_per_round=0.02,
                   leave_per_round=0.001)
VARIANTS = {"stable": STABLE, "full": FULL, "churn": CHURN}


def _warm(p=CHURN, n=N, rounds=6, device="cpu"):
    """Packed arrays with dead, left, slow and suspect rows + scalars."""
    s = tstate.init_state(n, device=device)
    s = tstate.with_crashed(s, torch.arange(0, n, 61, device=device), 4)
    s = tstate.with_slow(s, torch.arange(1, n, 83, device=device))
    arrays, scal = s.node_arrays(), tround.init_scalars(s, p)
    seeds = prng.round_seeds(prng.key(3, device=device), 0, rounds)
    for r in range(rounds):
        arrays, part = cr.block_round_ref(arrays, scal, seeds[r], p)
        scal = tround.clamp_scalars(part.sum(0)[:8])
    return arrays, scal


def _state_of(arrays):
    z = tstate.init_state(arrays[0].shape[0], device=arrays[0].device)
    return tstate.SimState(*arrays, t=z.t, round_idx=z.round_idx,
                           stats=z.stats)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_plain_round_equals_round_core_on_philox_draws(name):
    p = VARIANTS[name]
    arrays, scal = _warm()
    seed = torch.tensor(424242, dtype=torch.int32)
    outs, part = cr.block_round_ref(arrays, scal, seed, p)
    s2, sc2 = tround.round_core(_state_of(arrays), scal, p,
                                prng.philox_u01(seed, N))
    for f, o in zip(tstate.NODE_FIELDS, outs):
        want = getattr(s2, f)
        assert o.dtype == want.dtype, f
        if f == "down_age" and name == "stable":
            # the stable variant never stores down_age: dead rows keep
            # their entry age where round_core ticks it up
            assert torch.equal(o, arrays[3])
            live = want < 0
            assert torch.equal(o[live], want[live])
            assert bool((want[~live] == arrays[3][~live] + 1).all())
        else:
            assert torch.equal(o, want), f
    assert part.shape == (cr.partials_rows(N), cr.N_LANES)
    np.testing.assert_allclose(
        tround.clamp_scalars(part.sum(0)[:8]).numpy(), sc2.numpy(),
        rtol=1e-5)
    if p.collect_stats:
        delta = {f: int(getattr(s2.stats, f)) for f in tstate.STATS_FIELDS
                 if f != "detect_latency_sum"}
        for i, f in enumerate(tstate.STATS_FIELDS):
            if f in delta:
                assert int(part[:, 8 + i].sum()) == delta[f], f
    else:
        assert float(part[:, 8:].abs().sum()) == 0.0


@pytest.mark.parametrize("name", ["stable", "full"])
def test_mega_plain_equals_per_round_calls_on_frozen_scalars(name):
    p = VARIANTS[name]
    arrays, scal = _warm()
    seeds = prng.round_seeds(prng.key(6), 40, 4)
    m_out, m_part = cr.mega_round_ref(arrays, scal, seeds, p)
    vals, counters = arrays, torch.zeros(cr.N_LANES - 8)
    for r in range(4):
        vals, part = cr.block_round_ref(vals, scal, seeds[r], p)
        counters += part[:, 8:].sum(0)
    for a, b in zip(m_out, vals):
        assert torch.equal(a, b)
    assert torch.equal(m_part[:, :8], part[:, :8])
    assert torch.equal(m_part[:, 8:].sum(0), counters)


@pytest.mark.parametrize("rows", [1, 8192, 8199,
                                  2 * cr.GRID_BLOCKS * cr.TILE + 37])
def test_partials_map_covers_every_node_once(rows):
    """The kernels' node -> row map: row sums over it equal a direct
    sum, every node is in exactly one row, the ragged edge adds
    nothing; past GRID_BLOCKS tiles the blocks walk on."""
    gen = torch.Generator().manual_seed(rows)
    lanes = [torch.rand(rows, generator=gen) if i % 3 else None
             for i in range(cr.N_LANES)]
    lanes[0] = torch.ones(rows)
    got = cr._block_sums(lanes, rows)
    row_of = cr.partials_row_of(rows)
    n_rows = cr.partials_rows(rows)
    assert got.shape == (n_rows, cr.N_LANES)
    assert n_rows == min(cr.GRID_BLOCKS, -(-rows // cr.TILE))
    assert int(row_of.min()) == 0 and int(row_of.max()) == n_rows - 1
    # every node counted once, in its own row
    assert torch.equal(got[:, 0], torch.bincount(
        row_of, minlength=n_rows).to(torch.float32))
    for i, lane in enumerate(lanes):
        want = torch.zeros(n_rows)
        if lane is not None:
            want.index_add_(0, row_of, lane)
        torch.testing.assert_close(got[:, i], want, rtol=1e-5, atol=1e-5)
    if rows > cr.GRID_BLOCKS * cr.TILE:
        assert int(row_of[cr.GRID_BLOCKS * cr.TILE]) == 0


@pytest.mark.parametrize("name", list(VARIANTS))
def test_kernel_tables_equal_the_elementwise_terms(name):
    """The premise of the kernels' shared-memory tables: each entry,
    computed by the body's own functions on its index and gathered per
    node, equals the value the body computes node by node."""
    p = VARIANTS[name]
    arrays, scal = _warm()
    t = cr.kernel_tables(scal, p)
    status, _, _, age, _, _, conf, lh = [a.to(torch.int32) if
                                         a.dtype != torch.float32 else a
                                         for a in arrays]
    up, slow = age < 0, age == tstate.SLOW_AGE
    elig = (status == tstate.ALIVE) | (status == tstate.SUSPECT)
    assert torch.equal(t["shrink"][conf.long()], tround._shrink(conf, p))
    n_live, n_elig, n_up_elig = scal[0], scal[1], scal[2]
    sbar = scal[3] / n_up_elig
    _, pf_fast, pf_slow = tround.pf_arrays(slow, lh, sbar, n_live / p.n, p)
    patience = p.lifeguard and p.enabled("slow_per_round")
    assert t["p_ack"].shape[1] == (p.awareness_max + 1 if patience else 1)
    idx = (slow.long(), lh.long() if patience else torch.zeros_like(
        lh, dtype=torch.long))
    mix = (1.0 - sbar) * pf_fast + sbar * pf_slow
    assert torch.equal(t["pf_fast"][idx], pf_fast)
    assert torch.equal(t["pf_slow"][idx], pf_slow)
    assert torch.equal(t["p_ack"][idx], (n_up_elig / n_elig) * (1.0 - mix))
    nl = torch.clamp_min(n_live, 1e-9)
    p_fail = torch.where(up, torch.where(slow, scal[5] / nl, scal[4] / nl),
                         1.0)
    if p.corroboration_k > 0:
        p_fail = p_fail * tfaults.detection_gate(up, None, p)
    lam = n_live / torch.clamp_min(n_elig - 1.0, 1.0) * p_fail \
        * elig.to(torch.float32)
    cdf = []
    u = prng.philox_u01(torch.tensor(31, dtype=torch.int32), N)(3)
    n_fail = tround._trunc_poisson(u, lam, cdf=cdf)
    cls = torch.where(elig, torch.where(up, torch.where(slow, 3, 2), 1), 0)
    for k in range(4):
        assert torch.equal(t["cdf"][cls, k], cdf[k]), k
    assert int((cls == 0).sum()) and int((cls == 1).sum()) \
        and int((cls == 3).sum()) == (int((slow & elig).sum()))
    scale = scal[6] / scal[7] if p.lifeguard else 1.0
    c0 = torch.clamp_min(n_fail - 1, 0)
    len0 = torch.clamp_max(torch.ceil(
        scale * p.suspicion_max_s * tround._shrink(c0, p)
        / p.probe_interval), float(tstate.TICK_MAX)).to(torch.int32)
    assert torch.equal(t["len0"][c0.long()], len0)
    assert int((n_fail > 0).sum()) > 0


def test_mega_runner_clock_keeps_the_reference_f32_schedule():
    """After k R=8 calls the runner's t is k f32 additions of
    f32(8) * f32(probe_interval), bit for bit: the JAX megakernel
    runner's schedule (pallas_round.py:706), not 8k additions of
    probe_interval."""
    p = STABLE.with_(probe_interval=0.7)
    run = cr.make_run_rounds_cuda(p, 16, rounds_per_call=8)
    s = tstate.init_state(N, device="cpu")
    step = np.float32(np.float32(8.0) * np.float32(0.7))
    want = np.float32(0.0)
    for _ in range(3):
        s = run(s, prng.key(1))
        want = np.float32(want + step)
        want = np.float32(want + step)
        assert s.t.dtype == torch.float32
        assert s.t.numpy().tobytes() == want.tobytes()
    per_round = np.float32(0.0)
    for _ in range(48):
        per_round = np.float32(per_round + np.float32(0.7))
    assert per_round != want      # the two schedules differ in the bits


def test_stable_variant_holds_residual_rows_frozen():
    p = SimParams(n=N, loss=0.01, collect_stats=False)
    s = tstate.with_slow(tstate.with_crashed(
        tstate.init_state(N, device="cpu"), 5, age=7), 3)
    out = cr.make_run_rounds_cuda(p, 30)(s, prng.key(0))
    assert int(out.down_age[5]) == 7
    assert int(out.down_age[3]) == tstate.SLOW_AGE
    assert not bool(out.up[5]) and bool(out.slow[3])


@pytest.mark.parametrize("rpc", [1, 8])
def test_resume_from_scalars_carry_bitwise(rpc):
    p = FULL
    key = prng.key(5)
    full = cr.make_run_rounds_cuda(p, 16, rounds_per_call=rpc)(
        tstate.init_state(N, device="cpu"), key)
    half = cr.make_run_rounds_cuda(p, 8, rounds_per_call=rpc, carry=True)
    s, sc = half(tstate.init_state(N, device="cpu"), key)
    s2, _ = half(s, key, scalars0=sc)
    for a, b in zip(full[:-1], s2[:-1]):
        assert torch.equal(a, b)
    for a, b in zip(full.stats, s2.stats):
        assert torch.equal(a, b)
    assert int(s2.round_idx) == 16


def test_runner_updates_state_in_place_and_accumulates_stats():
    p = CHURN
    s = tstate.init_state(N, device="cpu")
    status = s.status
    out = cr.make_run_rounds_cuda(p, 16, rounds_per_call=8)(s, prng.key(1))
    assert out.status is status          # the donation stand-in
    assert float(out.t) == 16 * p.probe_interval
    assert int(out.stats.crashes) > 0 and int(out.stats.suspicions) > 0
    assert out.stats.crashes.dtype == torch.int32
    assert out.stats.detect_latency_sum.dtype == torch.float32


def test_maker_refusals():
    cp = _plan("fault")
    for kw, match in ((dict(rounds_per_call=0), ">= 1"),
                      (dict(rounds_per_call=8), "multiple of"),
                      (dict(plan=cp, rounds_per_call=4), "megakernel"),
                      (dict(coords=True, rounds_per_call=4),
                       "coords updates run between kernel launches"),
                      (dict(flight_every=8), "stats lanes"),
                      (dict(blackbox=True), "pass flight_every")):
        with pytest.raises(ValueError, match=match):
            cr.make_run_rounds_cuda(STABLE, 60, **kw)
    run = cr.make_run_rounds_cuda(STABLE, 8)
    with pytest.raises(ValueError, match="carry=True"):
        run(tstate.init_state(N, device="cpu"), prng.key(0),
            scalars0=torch.ones(8))
    # the options the runner takes now need their inputs at the call
    with pytest.raises(ValueError, match="coo="):
        cr.make_run_rounds_cuda(STABLE, 8, coords=True)(
            tstate.init_state(N, device="cpu"), prng.key(0))


def test_crash_detection_has_no_false_positives():
    n = 65_536
    p = SimParams(n=n, loss=0.01, collect_stats=False)
    s = tstate.with_crashed(tstate.init_state(n, device="cpu"), 7)
    out = cr.make_run_rounds_cuda(p, 60)(s, prng.key(2))
    assert int(out.status[7]) == tstate.DEAD
    assert int((out.status == tstate.DEAD).sum()) == 1
    assert float(out.informed[7]) > 0.99


def test_wrapper_checks_and_cpu_path_counts_no_launch():
    arrays, scal = _warm(rounds=1)
    seeds = prng.round_seeds(prng.key(0), 0, 2)
    cr.reset_launches()
    work = tuple(a.clone() for a in arrays)
    part = cr.round_kernel(work, scal, seeds, 1, FULL)
    want, want_part = cr.block_round_ref(arrays, scal, seeds[1], FULL)
    assert all(torch.equal(a, b) for a, b in zip(work, want))
    assert torch.equal(part, want_part)
    assert sum(cr.LAUNCHES.values()) == 0
    wide = list(arrays)
    wide[1] = wide[1].to(torch.int32)
    with pytest.raises(ValueError, match="incarnation"):
        cr.round_kernel(tuple(wide), scal, seeds, 0, FULL)
    with pytest.raises(ValueError, match="scalars"):
        cr.round_kernel(arrays, scal.double(), seeds, 0, FULL)
    with pytest.raises(IndexError):
        cr.round_kernel(arrays, scal, seeds, 2, FULL)


def test_kernel_params_are_the_f32_host_folds():
    kp = cr.kernel_params(FULL, N)
    f32 = np.float32
    assert kp.rows == N and kp.write_age == 1 and kp.stats_on == 1
    assert kp.susp_max_s == f32(FULL.suspicion_max_s)
    assert kp.inv_n == f32(1.0 / N)
    assert kp.p_relay == f32(FULL.p_relay)
    assert cr.kernel_params(STABLE, N).write_age == 0
    assert cr.variant(STABLE) == "stable" and cr.variant(FULL) == "full"


def test_kernel_bound_counts_the_fault_frame():
    n = 65_536
    arrays, scal = _warm(rounds=1, n=n)
    seed = torch.tensor(5, dtype=torch.int32)
    for name, frame_b in (("fault", 29), ("byz", 42)):
        fx = _frame(name, n)
        out, _ = cr.block_round_ref(arrays, scal, seed, FULL, fx=fx)
        c = costmodel.kernel_bound(FULL, arrays, fx=fx, out=out)
        # state read 15 B and written 15 B (a fault round stores
        # down_age), the frame read once, plus mid, scalars, seed,
        # partials: 61,865,984 / 75,497,472 B of node lanes at 1M
        assert c["frame_bytes"] == frame_b * n
        assert c["state_bytes"] == 30 * n
        assert c["bytes"] == (30 + frame_b) * n + 4 + 4 * 8 + 4 \
            + 4 * 18 * cr.partials_rows(n)
        up = out[3] < 0
        draws = 3 * n + int(up.sum())      # churn, slow, Poisson, ack
        calls = n                          # one Philox call serves them
        if name == "byz":
            replays = int((up & (fx.replay > 0)).sum())
            draws += replays
            calls += replays
        assert c["philox_calls"] == calls and c["draws"] == draws
        assert c["int32_ops"] == calls * costmodel.PHILOX_INT_OPS \
            + draws * costmodel.DRAW_INT_OPS
        assert c["bound_by"] == "bytes"
    with pytest.raises(ValueError, match="out="):
        costmodel.kernel_bound(FULL, arrays, fx=fx)


def test_kernel_cost_counts_the_bytes_of_one_call():
    n = 1_048_576
    s = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                            torch.arange(0, n, 4))
    arrays = s.node_arrays()
    c = costmodel.kernel_bound(bench.headline_params(n), arrays)
    assert c["state_bytes"] == 29_360_128
    assert c["bytes"] == 29_360_128 + 4 * 8 + 4 + 4 * 18 * 528
    # one Philox call per node; every node's Poisson draw and the 3/4
    # live nodes' ack draws
    assert c["int32_ops"] == n * costmodel.PHILOX_INT_OPS \
        + (n + 3 * n // 4) * costmodel.DRAW_INT_OPS
    assert c["bound_by"] == "bytes"
    c = costmodel.kernel_bound(bench.diag_params(n), arrays, 8)
    assert c["state_bytes"] == 31_457_280
    assert c["int32_ops"] == 8 * (n * 40 + (2 * n + 3 * n // 4) * 2)
    assert c["f32_ops"] == 8 * n * costmodel.TABLE_BODY_F32_OPS
    # 8 rounds of draws on the INT32 lanes outlast the call's bytes
    assert c["ops_ms"] == pytest.approx(
        c["int32_ops"] / costmodel.INT32_OPS_PER_S * 1e3)
    assert c["bound_by"] == "operations"
    with pytest.raises(ValueError, match="churn"):
        costmodel.kernel_bound(CHURN, arrays)


def test_kernel_report_parsers():
    """chip_smoke's readers of ptxas -v and cuobjdump -sass: every
    instantiation maps to its variant; registers, stack frame, spills
    and the static instruction count (NOPs left out) per kernel."""
    sym = "_ZN12_GLOBAL__N_112round_kernelILb{}ELb{}ELb{}ELi4ELi4EEEv11Round"
    names = {sym.format(1, 1, 0): "round_kernel/byz",
             sym.format(1, 0, 0): "round_kernel/fault",
             sym.format(0, 0, 0): "round_kernel/full",
             sym.format(0, 0, 1): "round_kernel/stable",
             "_ZN12_GLOBAL__N_111mega_kernelILb1ELi2ELi2EEEv11R":
                 "mega_kernel/stable",
             "_ZN12_GLOBAL__N_111mega_kernelILb0ELi2ELi2EEEv11R":
                 "mega_kernel/full",
             "_ZN12_GLOBAL__N_110sum_kernelILi4ELi4EEEvPKf7SumPlanPfS4_Pi":
                 "tree_sum/t4v4",
             "_ZN12_GLOBAL__N_110sum_kernelILi2ELi1EEEvPKf7SumPlanPfS4_Pi":
                 "tree_sum/t2v1",
             "_ZN12_GLOBAL__N_16philoxEjjj": None,
             "_ZN12_GLOBAL__N_110flight_rowE10FlightArgsfi": "flight_row",
             "_ZN12_GLOBAL__N_119flight_block_reduceE10FlightSums": None}
    for symbol, label in names.items():
        assert chip_smoke.kernel_label(symbol) == label
    ptxas = "\n".join(
        f"ptxas info    : Compiling entry function '{s}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {s}\n"
        f"    {16 * (i == 7)} bytes stack frame, {8 * i} bytes spill "
        f"stores, {4 * i} bytes spill loads\n"
        f"ptxas info    : Used {90 + i} registers, used 1 barriers"
        for i, s in enumerate(names))
    got = chip_smoke.ptxas_report(ptxas)
    assert set(got) == {v for v in names.values() if v}
    assert got["round_kernel/fault"] == {"stack_bytes": 0,
                                         "spill_bytes": 12, "registers": 91}
    assert got["round_kernel/byz"] == {"stack_bytes": 0, "spill_bytes": 0,
                                       "registers": 90}
    assert got["tree_sum/t2v1"] == {"stack_bytes": 16, "spill_bytes": 84,
                                    "registers": 97}


def test_bench_smoke_runs_the_plain_path():
    res = bench.run_headline(smoke=True)
    assert res["device"] == "cpu" and res["n"] == bench.SMOKE_N
    for k in ("per_round", "mega", "full_per_round", "full_mega"):
        assert res[k]["rounds_per_sec"] > 0, k
    assert res["fd"]["suspicions_per_node_round"] > 0


def test_bench_profile_needs_the_card():
    with pytest.raises(SystemExit):
        bench.main(["--smoke", "--profile"])
    with pytest.raises(SystemExit):
        bench.main(["--chaos", "--smoke", "--profile"])


def test_device_breakdown_unions_overlapping_intervals():
    spans = [(0.0, 4.0, "a"), (1.0, 3.0, "b"), (2.0, 6.0, "a"),
             (10.0, 12.0, "b")]
    got = bench.device_breakdown(spans, rounds=2)
    assert got["device_span_us"] == 12.0
    assert got["device_busy_us"] == 8.0       # [0, 6] and [10, 12]
    assert got["busy_share"] == 8.0 / 12.0
    assert got["device_us_per_round_by_kernel"] == {"a": 4.0, "b": 2.0}
    assert "not measured" in bench.device_breakdown([], 1)["device"]


def test_profile_call_on_the_cpu_traces_the_host_only():
    x = torch.arange(8.0)
    out, rep = bench.profile_call(lambda: x.sum(), 4, torch.device("cpu"))
    assert float(out) == 28.0
    assert rep["rounds"] == 4 and rep["wall_us_per_round"] > 0
    assert rep["kernels_per_round"] == 0
    assert "not measured" in rep["device"]


# ----------------------------------------------------- fault variants


def _plan(name, n=N, device="cpu"):
    return tfaults.compile_plan(chip_smoke.check_plans(n)[name], n, device)


def _frame(name, n=N, device="cpu"):
    return tfaults.fault_frame(_plan(name, n, device),
                               chip_smoke.CHECK_ROUNDS[name])


@pytest.mark.parametrize("name", ["fault", "byz"])
def test_plain_fault_round_equals_round_core_on_philox_draws(name):
    p = FULL.with_(corroboration_k=2 if name == "byz" else 0)
    arrays, scal = _warm()
    seed = torch.tensor(777, dtype=torch.int32)
    fx = _frame(name)
    outs, part = cr.block_round_ref(arrays, scal, seed, p, fx=fx)
    s2, sc2 = tround.round_core(_state_of(arrays), scal, p,
                                prng.philox_u01(seed, N), fx=fx)
    for f, o in zip(tstate.NODE_FIELDS, outs):
        assert torch.equal(o, getattr(s2, f)), f
    sums = part.sum(0)
    # the kernels' n_slow lane leaves the forced-slow nodes out
    want = sc2.clone()
    want[3] = float((s2.slow & s2.up & ((s2.status == tstate.ALIVE) |
                                        (s2.status == tstate.SUSPECT))
                     ).sum())
    np.testing.assert_allclose(tround.clamp_scalars(sums[:8]).numpy(),
                               want.numpy(), rtol=1e-5)
    if name == "fault":
        assert float(want[3]) < float(sc2[3])  # forced-slow rows exist
    for i, f in enumerate(tstate.STATS_FIELDS):
        if f != "detect_latency_sum":
            assert int(part[:, 8 + i].sum()) == int(getattr(s2.stats, f)), f
    if name == "byz":
        assert int(s2.stats.attack_suspicions) > 0
        assert int((s2.incarnation != arrays[1]).sum()) > 0


def test_runner_with_plan_cut_at_phase_starts_is_the_uncut_run():
    plan = chip_smoke.check_plans(N)["byz"]
    cp = tfaults.compile_plan(plan, N, "cpu")
    key = prng.key(4)
    whole = cr.make_run_rounds_cuda(FULL, plan.total_rounds, plan=cp)(
        tstate.init_state(N, device="cpu"), key)
    s, sc = tstate.init_state(N, device="cpu"), None
    for ph in plan.phases:
        run = cr.make_run_rounds_cuda(FULL, ph.rounds, carry=True, plan=cp)
        s, sc = run(s, key, scalars0=sc)
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(whole, f), getattr(s, f)), f
    for f in tstate.STATS_FIELDS:
        a, b = getattr(whole.stats, f), getattr(s.stats, f)
        if f == "detect_latency_sum":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a, b), f
    assert int(whole.stats.attack_suspicions) > 0
    assert int(s.round_idx) == plan.total_rounds


def test_runner_applies_fault_gain_and_gain_zero_is_no_plan():
    cp = _plan("fault")
    key = prng.key(6)
    plain = cr.make_run_rounds_cuda(FULL, 12)(
        tstate.init_state(N, device="cpu"), key)
    off = cr.make_run_rounds_cuda(FULL.with_(fault_gain=0.0), 12,
                                  plan=cp)(
        tstate.init_state(N, device="cpu"), key)
    half = cr.make_run_rounds_cuda(FULL.with_(fault_gain=0.5), 12,
                                   plan=cp)(
        tstate.init_state(N, device="cpu"), key)
    full = cr.make_run_rounds_cuda(FULL, 12, plan=cp)(
        tstate.init_state(N, device="cpu"), key)
    # at gain 0 the frame is the identity: only the churn draw, which a
    # frame always makes, is extra — and at rate 0 it changes nothing
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(plain, f), getattr(off, f)), f
    crashes = [int(s.stats.crashes) for s in (off, half, full)]
    assert crashes[0] == 0 < crashes[1] < crashes[2]


def test_wrapper_checks_the_fault_frame():
    arrays, scal = _warm(rounds=1)
    seeds = prng.round_seeds(prng.key(0), 0, 1)
    fx = _frame("byz")
    cr.reset_launches()
    work = tuple(a.clone() for a in arrays)
    part = cr.round_kernel(work, scal, seeds, 0, FULL, fx=fx)
    want, want_part = cr.block_round_ref(arrays, scal, seeds[0], FULL,
                                         fx=fx)
    assert all(torch.equal(a, b) for a, b in zip(work, want))
    assert torch.equal(part, want_part)
    assert sum(cr.LAUNCHES.values()) == 0
    assert cr.variant(FULL, fx) == "byz"
    assert cr.variant(FULL, fx._replace(forge_ack=None, spur_susp=None,
                                        replay=None, attacked=None)) \
        == "fault"
    for bad, match in ((fx._replace(psend=fx.psend.double()), "psend"),
                       (fx._replace(slow_f=fx.slow_f.to(torch.int8)),
                        "slow_f"),
                       (fx._replace(hear_w=fx.hear_w[:-1]), "hear_w"),
                       (fx._replace(replay=None), "replay"),
                       (fx._replace(crash_p=torch.stack(
                           [fx.crash_p, fx.crash_p], 1)[:, 0]),
                        "crash_p"),
                       (fx._replace(mid=fx.mid.double()), "mid")):
        with pytest.raises(ValueError, match=match):
            cr.round_kernel(arrays, scal, seeds, 0, FULL, fx=bad)


def test_megakernel_refuses_a_plan():
    with pytest.raises(ValueError, match="megakernel"):
        cr.make_run_rounds_cuda(FULL, 16, rounds_per_call=8,
                                plan=_plan("byz"))


# ------------------------------------------------------------ flight row


def _flight_inputs(n, device, big_inc=False, offset=0, seed=5):
    """Packed post-round lanes for a flight row — alive, suspect, dead
    and left agents, up (down_age -1 or -2) and down, local health over
    0..awareness_max, informed in [0, 1] with exact 0s and 1s,
    incarnations up to 39 (up to 32,767 with ``big_inc``: the sum then
    passes 2^24) — each lane ``offset`` elements into its buffer (not
    16-byte aligned when odd); and the run's counters and their
    snapshot."""
    g = torch.Generator().manual_seed(seed)
    status = torch.tensor([tstate.ALIVE, tstate.SUSPECT, tstate.DEAD,
                           tstate.LEFT])[torch.randint(0, 4, (n,),
                                                       generator=g)]
    age = torch.randint(-2, 40, (n,), generator=g)
    age = torch.where(age < 10, torch.where(age < 4, -1, -2), age)
    informed = torch.rand(n, generator=g)
    informed[torch.randint(0, n, (n // 8,), generator=g)] = 1.0
    informed[torch.randint(0, n, (n // 8,), generator=g)] = 0.0
    lh = torch.randint(0, FULL.awareness_max + 1, (n,), generator=g)
    inc = torch.randint(0, 32768 if big_inc else 40, (n,), generator=g)

    def lane(vals, dt):
        buf = torch.zeros(n + offset, dtype=dt, device=device)
        buf[offset:].copy_(vals.to(dt))
        return buf[offset:]

    arrays = list(tstate.init_state(n, device=device).node_arrays())
    for i, v in ((0, status), (1, inc), (2, informed), (3, age), (7, lh)):
        arrays[i] = lane(v, arrays[i].dtype)
    acc = torch.randint(1_000, 2**30, (tround.N_STATS,), generator=g,
                        dtype=torch.int32)
    acc[tround.LAT] = 0
    prev = acc - torch.randint(0, 1_000, (tround.N_STATS,), generator=g,
                               dtype=torch.int32)
    lat = torch.rand(2, generator=g) * 1e4
    t = torch.tensor(1234.5)
    return (tuple(arrays), *(x.to(device) for x in (
        t, acc, lat.max().reshape(()), prev, lat.min().reshape(()))))


def _flight_phase(kind, device):
    return {"none": -1, "host": 3,
            "device": torch.tensor([2], dtype=torch.int64,
                                   device=device)}[kind]


def _plain_flight_row(arrays, t, acc, acc_lat, prev, prev_lat, phase,
                      coord_row):
    delta = (acc - prev).to(torch.float32)
    delta[tround.LAT] = acc_lat - prev_lat
    return flight.flight_row(up=arrays[3] < 0, status=arrays[0],
                             informed=arrays[2], local_health=arrays[7],
                             incarnation=arrays[1], t=t, stats_delta=delta,
                             phase=phase, coord_row=coord_row)


@pytest.mark.parametrize("phase", ["none", "host", "device"])
@pytest.mark.parametrize("coord", [False, True])
def test_flight_row_cpu_route_is_flight_row(phase, coord):
    """On the CPU ``record_flight_row`` writes ``flight.flight_row``'s
    row into the window's slot, moves the snapshot to the counters in
    place, and launches nothing."""
    arrays, t, acc, acc_lat, prev, prev_lat = _flight_inputs(1000, "cpu")
    ph = _flight_phase(phase, "cpu")
    crow = torch.tensor([0.25, 0.5, 0.125]) if coord else None
    want = _plain_flight_row(arrays, t, acc, acc_lat, prev, prev_lat, ph,
                             crow)
    trace = torch.zeros((3, flight.N_COLS))
    cr.reset_launches()
    cr.record_flight_row(trace, 13, 10, arrays, t, acc, acc_lat, prev,
                         prev_lat, phase=ph, coord_row=crow)
    assert dict(cr.LAUNCHES) == {}
    assert torch.equal(trace[1], want)
    assert not trace[0].any() and not trace[2].any()
    assert torch.equal(prev, acc) and torch.equal(prev_lat, acc_lat)
    assert float(trace[1, flight.COL["fault_phase"]]) == \
        {"none": -1.0, "host": 3.0, "device": 2.0}[phase]


FLIGHT_REFUSALS = {
    "wide_incarnation": ("arrays", lambda a: (a[0], a[1].to(torch.int32))
                         + a[2:], "incarnation"),
    "strided_status": ("arrays", lambda a: (torch.stack([a[0], a[0]], 1)
                                            [:, 0],) + a[1:], "status"),
    "int64_counters": ("acc", lambda x: x.to(torch.int64), "acc"),
    "short_snapshot": ("prev", lambda x: x[:-1], "prev"),
    "f64_clock": ("t", lambda x: x.double(), "t"),
    "int32_phase": ("phase", lambda x: torch.tensor([1], dtype=torch.int32),
                    "phase"),
    "wide_coords": ("coord_row", lambda x: torch.zeros(4), "coord_row"),
    "short_partials": ("scratch", lambda x: (x[0][:-1], x[1]), "partials"),
}


@pytest.mark.parametrize("case", list(FLIGHT_REFUSALS))
def test_flight_row_launch_checks_refuse_what_the_kernel_does_not_take(
        case):
    """``record_flight_row``'s checks before a launch, on CPU tensors:
    the packed lanes, int32 counters of N_STATS, f32 0-d clock and
    latency lanes, an int64 device phase, a [3] f32 coordinate row and
    a whole partials scratch; anything else is refused by name."""
    arrays, t, acc, acc_lat, prev, prev_lat = _flight_inputs(64, "cpu")
    args = dict(arrays=arrays, trace=torch.zeros((2, flight.N_COLS)), t=t,
                acc=acc, acc_lat=acc_lat, prev=prev, prev_lat=prev_lat,
                phase=torch.tensor([0]), coord_row=torch.zeros(3),
                scratch=cr.flight_scratch("cpu"))
    cr._check_flight(**args)
    name, bad, match = FLIGHT_REFUSALS[case]
    args[name] = bad(args[name])
    with pytest.raises(ValueError, match=match):
        cr._check_flight(**args)


def test_flight_bound_counts_the_rows_lanes_and_the_row():
    arrays = tstate.init_state(1000, device="cpu").node_arrays()
    b = costmodel.flight_bound(arrays)
    assert b["read_bytes"] == 10 * 1000
    assert b["written_bytes"] == 4 * flight.N_COLS
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(
        (10_000 + 88) / costmodel.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("rpc,stride,plan", [(1, 1, "byz"), (1, 3, "fault"),
                                             (4, 8, None)])
def test_kernel_runner_cpu_route_records_plain_rows(rpc, stride, plan):
    """The kernel runner on the CPU builds each row with
    ``flight.flight_row`` — the rows of the run cut at every window end,
    the plan's phase among them — and launches no ``flight_row``."""
    n, rounds = 2048, 24 if plan is None else 14
    cp = None if plan is None else _plan(plan, n)
    p = CHURN.with_(n=n)
    key = prng.key(8)
    s0 = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                             torch.arange(0, n, 89))
    cr.reset_launches()
    fin, trace = cr.make_run_rounds_cuda(
        p, rounds, rounds_per_call=rpc, plan=cp, flight_every=stride)(
        bench.clone_state(s0), key)
    assert sum(cr.LAUNCHES.values()) == 0
    rows, s, sc, done = [], bench.clone_state(s0), None, 0
    while done < rounds:
        step = min(stride, rounds - done)
        prev = s.stats
        s, sc = cr.make_run_rounds_cuda(p, step, rounds_per_call=rpc,
                                        carry=True, plan=cp)(
            s, key, scalars0=sc)
        ph = -1 if cp is None else tfaults.phase_at(cp, s.round_idx - 1)
        rows.append(flight.flight_row(
            up=s.up, status=s.status, informed=s.informed,
            local_health=s.local_health, incarnation=s.incarnation, t=s.t,
            stats_delta=flight.stats_delta(s.stats, prev), phase=ph))
        done += step
    assert torch.equal(trace, torch.stack(rows))
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(fin, f), getattr(s, f)), f
    if cp is not None:
        phases = trace[:, flight.COL["fault_phase"]]
        assert phases.min() < phases.max() == len(
            chip_smoke.check_plans(n)[plan].phases) - 1


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("mega", [False, True])
def test_kernel_matches_plain_on_the_card(cuda, name, mega):
    p = VARIANTS[name]
    arrays, scal = _warm(device=cuda)
    seeds = prng.round_seeds(prng.key(9, device=cuda), 0, 8)
    work = tuple(a.clone() for a in arrays)
    cr.reset_launches()
    if mega:
        want, want_part = cr.mega_round_ref(arrays, scal, seeds, p)
        part = cr.mega_kernel(work, scal, seeds, p)
    else:
        want, want_part = cr.block_round_ref(arrays, scal, seeds[0], p)
        part = cr.round_kernel(work, scal, seeds, 0, p)
    torch.cuda.synchronize()
    assert sum(cr.LAUNCHES.values()) == 1
    for f, a, b in zip(tstate.NODE_FIELDS, work, want):
        if f == "informed":
            torch.testing.assert_close(a, b, rtol=4 * 2**-23, atol=0)
        else:
            assert torch.equal(a, b), f
    torch.testing.assert_close(part, want_part, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_runner_on_the_card_detects_a_crash(cuda):
    n = 65_536
    p = SimParams(n=n, loss=0.01, collect_stats=False)
    s = tstate.with_crashed(tstate.init_state(n, device=cuda), 7)
    cr.reset_launches()
    out = cr.make_run_rounds_cuda(p, 60)(s, prng.key(2, device=cuda))
    assert cr.LAUNCHES["round_kernel/stable"] == 60
    assert int(out.status[7]) == tstate.DEAD
    assert int((out.status == tstate.DEAD).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fault", "byz"])
def test_fault_kernels_match_plain_on_the_card(cuda, name):
    p = FULL.with_(corroboration_k=2 if name == "byz" else 0)
    arrays, scal = _warm(device=cuda)
    seeds = prng.round_seeds(prng.key(9, device=cuda), 0, 1)
    fx = _frame(name, device=cuda)
    work = tuple(a.clone() for a in arrays)
    cr.reset_launches()
    want, want_part = cr.block_round_ref(arrays, scal, seeds[0], p, fx=fx)
    part = cr.round_kernel(work, scal, seeds, 0, p, fx=fx)
    torch.cuda.synchronize()
    assert dict(cr.LAUNCHES) == {f"round_kernel/{name}": 1,
                                 "frame/gathered": 1}
    for f, a, b in zip(tstate.NODE_FIELDS, work, want):
        if f == "informed":
            torch.testing.assert_close(a, b, rtol=4 * 2**-23, atol=0)
        else:
            assert torch.equal(a, b), f
    torch.testing.assert_close(part, want_part, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_corroboration_gate_matches_plain_on_the_card(cuda):
    p = FULL.with_(corroboration_k=1)
    arrays, scal = _warm(device=cuda)
    seeds = prng.round_seeds(prng.key(10, device=cuda), 0, 8)
    work = tuple(a.clone() for a in arrays)
    want, want_part = cr.block_round_ref(arrays, scal, seeds[0], p)
    part = cr.round_kernel(work, scal, seeds, 0, p)
    torch.cuda.synchronize()
    for f, a, b in zip(tstate.NODE_FIELDS, work, want):
        if f == "informed":
            torch.testing.assert_close(a, b, rtol=4 * 2**-23, atol=0)
        else:
            assert torch.equal(a, b), f
    torch.testing.assert_close(part, want_part, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_runner_with_a_byzantine_plan_on_the_card(cuda):
    n = 65_536
    plan = chip_smoke.check_plans(n)["byz"]
    cp = tfaults.compile_plan(plan, n, cuda)
    cr.reset_launches()
    out = cr.make_run_rounds_cuda(SimParams(n=n, loss=0.05),
                                  plan.total_rounds, plan=cp)(
        tstate.init_state(n, device=cuda), prng.key(3, device=cuda))
    assert dict(cr.LAUNCHES) == {"round_kernel/byz": plan.total_rounds,
                                 "frame/in_place": plan.total_rounds}
    assert int(out.stats.attack_suspicions) > 0
    assert int(out.stats.crashes) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rpc", [1, 8])
def test_cuda_sweep_engine_is_the_per_point_runner_on_the_card(cuda, rpc):
    """The sweep's cuda engine launches exactly one kernel per point and
    call, and each grid row is bit for bit ``make_run_rounds_cuda`` on
    the point's concrete SimParams and the same key."""
    from consul_tpu_torch.sim import params as tparams
    from consul_tpu_torch.sim import sweep
    from consul_tpu_torch.sim.scenarios import autotune_params

    n, rounds = 65_536, 32
    p = autotune_params("lan", n)
    axes = tparams.SweepAxes.of(gossip_nodes=[2, 3, 4, 5])
    key = prng.key(9, device=cuda)
    cr.reset_launches()
    res = sweep.run_sweep(p, axes, rounds, key=key, engine="cuda",
                          rounds_per_call=rpc, device=cuda)
    torch.cuda.synchronize()
    kind = "mega_kernel/full" if rpc > 1 else "round_kernel/full"
    assert dict(cr.LAUNCHES) == {kind: 4 * rounds // rpc}
    for i, pp in enumerate(res.points):
        st = cr.make_run_rounds_cuda(pp, rounds, rounds_per_call=rpc)(
            tstate.init_state(n, device=cuda), key)
        row = sweep.take_point(res.states, i)
        for f in tstate.NODE_FIELDS:
            assert torch.equal(getattr(row, f), getattr(st, f)), (i, f)
        for a, b in zip(row.stats, st.stats):
            assert torch.equal(a, b)


#: (n, big incarnations, lane offset) of the flight row's card cases: one
#: agent, both sides of a tile and of the card's block count, a ragged
#: edge, the flagship size, an incarnation sum past 2^24, lanes that are
#: not 16-byte aligned
FLIGHT_SHAPES = [(1, False, 0), (511, False, 0), (512, False, 0),
                 (1000, False, 0), (65_539, False, 0), (2**20, False, 0),
                 (2**20, True, 0), (1000, False, 1), (65_539, False, 3)]


def _exact_inc_sum(arrays) -> int:
    return int(arrays[1].to(torch.int64).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLIGHT_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("phase", ["none", "host", "device"])
@pytest.mark.parametrize("coord", [False, True])
def test_flight_row_kernel_matches_flight_row_on_the_card(cuda, shape,
                                                          phase, coord):
    """One ``flight_row`` launch against ``flight.flight_row`` on the same
    card tensors: clock, shares, local-health mean and max, phase,
    counters and coordinates bit for bit; the informed mean within 1e-6
    relative; the incarnation sum the exact sum rounded to f32 (the
    plain f32 sum's bits where that sum is exact); the snapshot moved
    in place; the same bits on a second launch; nothing written past
    the partials scratch, and the ticket left at zero."""
    n, big, offset = shape
    arrays, t, acc, acc_lat, prev, prev_lat = _flight_inputs(
        n, cuda, big_inc=big, offset=offset)
    ph = _flight_phase(phase, cuda)
    crow = torch.tensor([0.25, 0.5, 0.125], device=cuda) if coord else None
    want = _plain_flight_row(arrays, t, acc, acc_lat, prev, prev_lat, ph,
                             crow)
    rows = cr.FLIGHT_BLOCKS * cr.FLIGHT_SUMS_BYTES // 8
    guarded = torch.full((rows + 64,), -7, dtype=torch.int64, device=cuda)
    ticket = torch.zeros((1,), dtype=torch.int32, device=cuda)
    traces = []
    for _ in range(2):
        trace = torch.zeros((3, flight.N_COLS), device=cuda)
        snap, snap_lat = prev.clone(), prev_lat.clone()
        cr.reset_launches()
        cr.record_flight_row(trace, 13, 10, arrays, t, acc, acc_lat, snap,
                             snap_lat, phase=ph, coord_row=crow,
                             scratch=(guarded[:rows], ticket))
        torch.cuda.synchronize()
        assert dict(cr.LAUNCHES) == {"flight_row": 1}
        assert bool((guarded[rows:] == -7).all()) and int(ticket) == 0
        assert torch.equal(snap, acc) and torch.equal(snap_lat, acc_lat)
        assert not trace[0].any() and not trace[2].any()
        traces.append(trace)
    assert torch.equal(traces[0].view(torch.int32),
                       traces[1].view(torch.int32))
    got = traces[0][1]
    exact = _exact_inc_sum(arrays)
    for name, i in flight.COL.items():
        if name == "mean_informed":
            torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0)
        elif name == "inc_bumps":
            assert float(got[i]) == float(torch.tensor(float(exact)))
            if exact < 2**24:
                assert torch.equal(got[i], want[i])
        else:
            assert torch.equal(got[i], want[i]), name
    if big:
        assert exact > 2**24


@pytest.mark.cuda
@pytest.mark.parametrize("rpc,stride,plan", [(1, 1, None), (4, 8, None),
                                             (1, 1, "byz")])
def test_kernel_runner_flight_rows_on_the_card(cuda, rpc, stride, plan):
    """The kernel runner's trace on the card — its rows ``flight_row``
    launches inside the captured graph — equals ``flight.flight_row`` of
    the same run cut at every window end: every column but the informed
    mean bit for bit, that one within 1e-6 relative; one launch a row,
    replays counted."""
    n = 65_536
    rounds = 24 if plan is None else chip_smoke.check_plans(n)[
        plan].total_rounds
    cp = None if plan is None else _plan(plan, n, cuda)
    p = (FULL if plan else CHURN).with_(n=n)
    key = prng.key(12, device=cuda)
    s0 = tstate.with_crashed(tstate.init_state(n, device=cuda),
                             torch.arange(0, n, 89, device=cuda))
    run = cr.make_run_rounds_cuda(p, rounds, rounds_per_call=rpc, plan=cp,
                                  flight_every=stride)
    for _ in range(2):   # the key's eager call, then its capture
        run(bench.clone_state(s0), key)
    cr.reset_launches()
    fin, trace = run(bench.clone_state(s0), key)   # a replay
    torch.cuda.synchronize()
    assert cr.LAUNCHES["flight_row"] == flight.n_trace_rows(rounds, stride)
    rows, s, sc, done = [], bench.clone_state(s0), None, 0
    while done < rounds:
        step = min(stride, rounds - done)
        prev = s.stats
        s, sc = cr.make_run_rounds_cuda(p, step, rounds_per_call=rpc,
                                        carry=True, plan=cp)(
            s, key, scalars0=sc)
        ph = -1 if cp is None else tfaults.phase_at(cp, s.round_idx - 1)
        rows.append(flight.flight_row(
            up=s.up, status=s.status, informed=s.informed,
            local_health=s.local_health, incarnation=s.incarnation, t=s.t,
            stats_delta=flight.stats_delta(s.stats, prev), phase=ph))
        done += step
    want = torch.stack(rows)
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(fin, f), getattr(s, f)), f
    inf = flight.COL["mean_informed"]
    torch.testing.assert_close(trace[:, inf], want[:, inf], rtol=1e-6,
                               atol=0)
    keep = [i for i in range(flight.N_COLS) if i != inf]
    assert torch.equal(trace[:, keep], want[:, keep])
    assert float(trace[:, flight.COL["suspicions"]].sum()) > 0


def _in_place_plans(n):
    """Three-phase plans: an honest one without a flap (every lane read
    in place), a byzantine one, and the honest check plan, whose flap
    the phase flip releases (``crash_p`` / ``rejoin_p`` fresh lanes)."""
    plans = chip_smoke.check_plans(n)
    honest, byz = plans["fault"], plans["byz"]
    return {"honest": tfaults.FaultPlan(phases=tuple(
                tfaults.Phase(rounds=ph.rounds, name=ph.name,
                              faults=tuple(f for f in ph.faults
                                           if not isinstance(f,
                                                             tfaults.Flap)))
                for ph in honest.phases)),
            "byz": tfaults.FaultPlan(phases=byz.phases + (
                tfaults.Phase(rounds=3, name="recover"),)),
            "flap": honest}


def _guarded(cp):
    """``cp`` with its packed rows, masks and ``mid`` at the head of
    storage twice their phases long, and the guard behind them: NaN
    rows and ``mid``s, all-true masks (each read would show)."""
    P = cp.starts.shape[0]
    rows = torch.full((2 * P, *cp.rows.shape[1:]), float("nan"),
                      device=cp.rows.device)
    masks = torch.ones((2 * P, *cp.masks.shape[1:]), dtype=torch.bool,
                       device=cp.masks.device)
    mid = torch.full((2 * P,), float("nan"), device=cp.mid.device)
    rows[:P], masks[:P], mid[:P] = cp.rows, cp.masks, cp.mid
    guarded = tfaults._packed(cp._replace(mid=mid[:P]), rows[:P],
                              masks[:P])
    return guarded, (rows[P:].clone(), masks[P:].clone(), mid[P:].clone()), \
        (rows[P:], masks[P:], mid[P:])


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["honest", "byz", "flap"])
@pytest.mark.parametrize("n", [1024, 2**20])
def test_in_place_frame_kernels_match_the_gathered_frame_on_the_card(
        cuda, n, plan):
    """The ``fault`` / ``byz`` round kernel on an in-place frame against
    the same launch on ``frames_at``'s gathered frame of the same round:
    arrays and partials bit for bit on every round of a three-phase plan
    and two past its end, from state both launches carry; one count of
    each route a launch; the guard behind the plan's last phase neither
    read nor written."""
    fp = _in_place_plans(n)[plan]
    cp, before, guard = _guarded(tfaults.compile_plan(fp, n, cuda))
    p = FULL.with_(n=n, corroboration_k=2 if plan == "byz" else 0)
    arrays, scal = _warm(p=CHURN.with_(n=n), n=n, device=cuda)
    rounds = fp.total_rounds + 2
    start = torch.zeros((), dtype=torch.int32, device=cuda)
    seeds = prng.round_seeds(prng.key(9, device=cuda), 0, rounds)
    a, b = (tuple(x.clone() for x in arrays) for _ in range(2))
    sa, sb = scal.clone(), scal.clone()
    kind = "byz" if plan == "byz" else "fault"
    cr.reset_launches()
    for r, (gx, ix) in enumerate(zip(
            tfaults.frames_at(cp, start, rounds),
            tfaults.frames_in_place(cp, start, rounds))):
        assert cr.variant(p, ix) == kind
        pa = cr.round_kernel(a, sa, seeds, r, p, fx=gx)
        pb = cr.round_kernel(b, sb, seeds, r, p, fx=ix)
        for f, x, y in zip(tstate.NODE_FIELDS, a, b):
            assert torch.equal(x, y), (r, f)
        assert torch.equal(pa.view(torch.int32), pb.view(torch.int32)), r
        sa = tround.clamp_scalars(pa.sum(0)[:8])
        sb = tround.clamp_scalars(pb.sum(0)[:8])
    torch.cuda.synchronize()
    assert dict(cr.LAUNCHES) == {f"round_kernel/{kind}": 2 * rounds,
                                 "frame/gathered": rounds,
                                 "frame/in_place": rounds}
    for want, got in zip(before, guard):
        assert torch.equal(want.view(torch.uint8), got.view(torch.uint8))


@pytest.mark.cuda
def test_kernel_runner_reads_the_chaos_plan_in_place_on_the_card(cuda):
    """The kernel runner under the chaos class ``eclipse`` at 2^20 agents
    (the ``lan-1m.chaos`` cell's plan), replayed, against its
    ``graphs.eager()`` run: state, counters and flight trace bit for
    bit; every period one ``byz`` launch whose frame is read in place
    and one flight row; the trace's phase column each period's
    phase."""
    from consul_tpu_torch.sim import graphs, scenarios

    n = 2**20
    fp = scenarios.chaos_plans(n)["eclipse"]
    cp = tfaults.compile_plan(fp, n, cuda)
    p = scenarios.chaos_params(n)
    rounds = fp.total_rounds
    run = cr.make_run_rounds_cuda(p, rounds, plan=cp, flight_every=1)
    key = prng.key(17, device=cuda)
    s0 = tstate.init_state(n, device=cuda)
    with graphs.eager():
        want, want_trace = run(bench.clone_state(s0), key)
    for _ in range(2):   # the key's eager call, then its capture
        run(bench.clone_state(s0), key)
    cr.reset_launches()
    got, trace = run(bench.clone_state(s0), key)   # a replay
    torch.cuda.synchronize()
    assert dict(cr.LAUNCHES) == {"round_kernel/byz": rounds,
                                 "frame/in_place": rounds,
                                 "flight_row": rounds}
    for f in tstate.NODE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f, x, y in zip(tstate.STATS_FIELDS, got.stats, want.stats):
        assert torch.equal(x, y), f
    assert torch.equal(trace.view(torch.int32), want_trace.view(torch.int32))
    phases = [float(tfaults.active_phase(cp, r)) for r in range(rounds)]
    assert trace[:, flight.COL["fault_phase"]].tolist() == phases
    assert int(got.stats.attack_suspicions) > 0
