"""The round kernels' plain versions, wrappers and runner.

On the CPU the wrappers take the plain versions, which must equal
``round_core`` fed the kernels' Philox uniforms (except down_age of dead
rows in the stable variant, pinned frozen as the TPU kernel's is); the
R-round version must equal R per-round calls on frozen scalars; a run
resumed from the scalars carry must be bitwise the straight run. The
``cuda``-marked tests repeat the kernel-vs-plain checks on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from consul_tpu_torch import bench
from consul_tpu_torch.sim import cuda_round as cr
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
    assert part.shape == (cr.n_blocks(N), cr.N_LANES)
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
    for kw, match in ((dict(rounds_per_call=0), ">= 1"),
                      (dict(rounds_per_call=8), "multiple of"),
                      (dict(plan=object()), "plan="),
                      (dict(coords=True), "coords="),
                      (dict(flight_every=8), "flight_every="),
                      (dict(blackbox=True), "blackbox=")):
        with pytest.raises(ValueError, match=match):
            cr.make_run_rounds_cuda(STABLE, 60, **kw)
    run = cr.make_run_rounds_cuda(STABLE, 8)
    with pytest.raises(ValueError, match="carry=True"):
        run(tstate.init_state(N, device="cpu"), prng.key(0),
            scalars0=torch.ones(8))


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


def test_kernel_cost_counts_the_bytes_of_one_call():
    import chip_smoke

    n = 1_048_576
    s = tstate.with_crashed(tstate.init_state(n, device="cpu"),
                            torch.arange(0, n, 4))
    arrays = s.node_arrays()
    c = chip_smoke.kernel_bound(bench.headline_params(n), arrays)
    assert c["state_bytes"] == 29_360_128
    assert c["bytes"] == 29_360_128 + 4 * 8 + 4 + 4 * 18 * (n // 256)
    # every node's Poisson draw and the 3/4 live nodes' ack draws
    assert c["int32_ops"] == (n + 3 * n // 4) * chip_smoke.PHILOX_INT_OPS
    assert c["bound_by"] == "bytes"
    c = chip_smoke.kernel_bound(bench.diag_params(n), arrays, 8)
    assert c["state_bytes"] == 31_457_280
    assert c["int32_ops"] == 8 * (2 * n + 3 * n // 4) * 42
    assert c["f32_ops"] == 8 * n * chip_smoke.BODY_F32_OPS
    assert c["bound_by"] == "operations"
    with pytest.raises(ValueError, match="churn"):
        chip_smoke.kernel_bound(CHURN, arrays)


def test_bench_smoke_runs_the_plain_path():
    res = bench.run_headline(smoke=True)
    assert res["device"] == "cpu" and res["n"] == bench.SMOKE_N
    for k in ("per_round", "mega", "full_per_round", "full_mega"):
        assert res[k]["rounds_per_sec"] > 0, k
    assert res["fd"]["suspicions_per_node_round"] > 0


def test_bench_profile_needs_the_card():
    with pytest.raises(SystemExit):
        bench.main(["--smoke", "--profile"])
    with pytest.raises(ValueError, match="no CPU mode"):
        bench.profile_runners("cpu")


def test_device_breakdown_unions_overlapping_intervals():
    spans = [(0.0, 4.0, "a"), (1.0, 3.0, "b"), (2.0, 6.0, "a"),
             (10.0, 12.0, "b")]
    got = bench.device_breakdown(spans, rounds=2)
    assert got["device_span_us"] == 12.0
    assert got["device_busy_us"] == 8.0       # [0, 6] and [10, 12]
    assert got["busy_share"] == 8.0 / 12.0
    assert got["device_us_per_round_by_kernel"] == {"a": 4.0, "b": 2.0}
    assert "not measured" in bench.device_breakdown([], 1)["device"]


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
