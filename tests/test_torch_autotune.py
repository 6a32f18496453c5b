"""consul_tpu_torch's autotuner (sim/autotune.py) against the JAX
reference's, on the CPU.

* ``sweep_space`` is the reference's 15 points with the kernel runner
  (``cuda``) in the place of its Pallas kernel.
* ``autotune`` with an injected ``measure``: the winner by rounds/s,
  honest skips of the points that cannot run here, the same payload as
  the reference's, never a fabricated winner, and a failure that is not
  a missing device raised rather than skipped.
* The winner cache: the round trip, its refusals by name, and a cache
  written by one package read by the other's ``load_cache``.
* ``tuned_runner`` for every engine is bit for bit the runner built
  directly from its factory (``chip_smoke.direct_runner``), from the
  same state and key.
* The bench: ``--autotune`` (at a small n) records TUNE and caches the
  winner, which the headline then times and names; a corrupt cache is an
  error.
* A rehearsal of ``chip_smoke.py``'s ``tune`` phase at 1,024 nodes: the
  roofline, the autotuner, the records and the cache.
"""

from __future__ import annotations

import json
import os

import pytest

import chip_smoke
from consul_tpu_torch import bench
from consul_tpu_torch.sim import autotune as at
from consul_tpu_torch.sim import costmodel as cm
from consul_tpu_torch.sim import prng, registry
from consul_tpu_torch.sim import state as tstate
from consul_tpu_torch.sim.autotune import AutotuneCacheError
from consul_tpu_torch.sim.params import SimParams
from test_torch_harness import ref  # noqa: F401  (fixture)

CPU = "cpu"
WINNER = {"config": "lanes-k2-b128", "engine": "lanes", "stale_k": 2,
          "rounds_per_call": 1, "lane_blocks": 128,
          "rounds_per_sec": 1234.5}


def _as_reference(cfg: dict) -> dict:
    return {**cfg, "engine": "pallas" if cfg["engine"] == "cuda"
            else cfg["engine"]}


def test_sweep_space_equals_the_reference(ref):
    from consul_tpu.sim import autotune as rat

    space = at.sweep_space("cuda")
    assert len(space) == 15 and space == at.sweep_space("cpu")
    assert [_as_reference(c) for c in space] == list(rat.sweep_space("tpu"))
    assert (at.SWEEP_STALE_KS, at.SWEEP_ROUNDS_PER_CALL) == \
        (rat.SWEEP_STALE_KS, rat.SWEEP_ROUNDS_PER_CALL)
    assert at.CACHE_FILE == rat.CACHE_FILE
    assert {c["lane_blocks"] for c in space if c["engine"] == "lanes"} == \
        set(registry.AUTOTUNE_LANE_BLOCKS)


def _fake_measure(unavailable):
    speed = {"fast": 100.0, "lanes": 300.0, "overlap": 200.0}

    def measure(p, rounds, engine, rounds_per_call, lane_blocks, reps,
                measure_bytes):
        if engine in ("cuda", "pallas"):
            raise unavailable("no kernel runner in this stub")
        rps = speed[engine] + (lane_blocks or 0)
        label = cm.config_label(engine, p.stale_k if engine != "fast"
                                else 1, rounds_per_call, lane_blocks)
        return {"config": label, "engine": engine, "stale_k": p.stale_k,
                "rounds_per_call": rounds_per_call,
                "lane_blocks": lane_blocks, "rounds_per_sec": rps,
                "ms_per_round": 1e3 / rps, "rounds": rounds}

    return measure


def test_autotune_picks_the_reference_winner_and_skips_honestly(ref):
    from consul_tpu.sim import autotune as rat
    from consul_tpu.sim import costmodel as rcm
    from consul_tpu.sim.params import SimParams as RefParams

    rec = at.autotune(SimParams(n=512, loss=0.05), rounds=8, reps=1,
                      platform="cpu",
                      measure=_fake_measure(cm.EngineUnavailable))
    want = rat.autotune(RefParams(n=512, loss=0.05), rounds=8, reps=1,
                        platform="cpu", measure=_fake_measure(RuntimeError))
    assert rec["winner"] == want["winner"]
    assert rec["winner"]["engine"] == "lanes"
    assert rec["winner"]["lane_blocks"] == max(registry.AUTOTUNE_LANE_BLOCKS)
    got_rows = [r for r in rec["rows"] if "skipped" not in r]
    assert got_rows == [r for r in want["rows"] if "skipped" not in r]
    skipped = [r for r in rec["rows"] if "skipped" in r]
    assert [r["config"] for r in skipped] == ["cuda", "cuda-x4", "cuda-x8"]
    assert all(r["skipped"].startswith("EngineUnavailable") for r in skipped)
    # every point ran at whole cadences of the requested depth
    assert {r["rounds"] for r in got_rows} == {8}
    cm.validate_record("TUNE_r01.json", rec)
    rcm.validate_record("TUNE_r01.json", rec)


def test_autotune_never_fabricates_a_winner():
    def none_here(*a, **k):
        raise cm.EngineUnavailable("nothing runs here")

    with pytest.raises(ValueError, match="never fabricated"):
        at.autotune(SimParams(n=512), rounds=8, platform="cpu",
                    measure=none_here)


def test_autotune_raises_a_failure_that_is_not_a_missing_device():
    with pytest.raises(RuntimeError, match="no kernel runner"):
        at.autotune(SimParams(n=512), rounds=8, platform="cpu",
                    measure=_fake_measure(RuntimeError))


def test_cache_round_trip_and_missing(tmp_path):
    root = str(tmp_path)
    assert at.load_cache(root) == {}
    assert at.cached_winner(root, "cuda", 1_048_576) is None
    path = at.save_winner(root, "cuda", 1_048_576, WINNER)
    assert path == os.path.join(root, "AUTOTUNE_CACHE.json")
    at.save_winner(root, "cpu", 65_536, {**WINNER, "rounds_per_sec": 9.0})
    assert at.cached_winner(root, "cuda", 1_048_576) == WINNER
    assert set(at.load_cache(root)) == {"cuda/n1048576", "cpu/n65536"}
    assert os.listdir(root) == ["AUTOTUNE_CACHE.json"]


@pytest.mark.parametrize("content,match", [
    ("{not json", "unreadable winner cache"),
    ("[1, 2]", "must be an object"),
    (json.dumps({"cuda/n8": {**WINNER, "rounds_per_sec": "fast"}}),
     r"\[cuda/n8\]: rounds_per_sec must be numeric"),
    (json.dumps({"cuda/n8": {k: v for k, v in WINNER.items()
                             if k != "stale_k"}}),
     r"\[cuda/n8\]: missing winner keys \['stale_k'\]"),
    (json.dumps({"cuda/n8": [1]}), "winner must be an object"),
], ids=["torn", "not_object", "rate_type", "missing_key", "entry_type"])
def test_cache_refuses_corruption_by_name(tmp_path, content, match):
    (tmp_path / "AUTOTUNE_CACHE.json").write_text(content)
    with pytest.raises(AutotuneCacheError, match=match):
        at.load_cache(str(tmp_path))
    with pytest.raises(AutotuneCacheError):
        at.save_winner(str(tmp_path), "cuda", 8, WINNER)
    assert (tmp_path / "AUTOTUNE_CACHE.json").read_text() == content


def test_cache_is_read_by_either_package(ref, tmp_path):
    from consul_tpu.sim import autotune as rat

    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    at.save_winner(str(a), "cuda", 1_048_576, WINNER)
    assert rat.load_cache(str(a)) == at.load_cache(str(a))
    assert rat.cached_winner(str(a), "cuda", 1_048_576) == WINNER
    rat.save_winner(str(b), "tpu", 1_048_576, {**WINNER, "config": "x"})
    assert at.load_cache(str(b)) == rat.load_cache(str(b))
    (b / "AUTOTUNE_CACHE.json").write_text("{}{")
    with pytest.raises(AutotuneCacheError, match="unreadable"):
        at.load_cache(str(b))


POINTS = at.sweep_space("cpu") + ({"engine": "xla", "stale_k": 1,
                                   "rounds_per_call": 1,
                                   "lane_blocks": None},)


@pytest.mark.parametrize("cfg", POINTS, ids=lambda c: cm.config_label(
    c["engine"], c["stale_k"], c["rounds_per_call"], c["lane_blocks"]))
def test_tuned_runner_is_the_direct_runner(cfg):
    p = bench.diag_params(1024)
    rounds = 8
    label = cm.config_label(cfg["engine"], cfg["stale_k"],
                            cfg["rounds_per_call"], cfg["lane_blocks"])
    winner = {**cfg, "config": label, "rounds_per_sec": 1.0}
    key = prng.key(3)
    got = at.tuned_runner(p, winner, rounds)(
        tstate.init_state(1024, device=CPU), key)
    want = chip_smoke.direct_runner(chip_smoke.modules(), p, winner,
                                    rounds)(
        tstate.init_state(1024, device=CPU), key)
    assert int(got.round_idx) == rounds
    for f, x, y in zip(got._fields, got, want):
        if f == "stats":
            for g, u, v in zip(x._fields, x, y):
                assert bool((u == v).all()), (label, g)
        else:
            assert x.dtype == y.dtype and bool((x == y).all()), (label, f)


def test_tuned_runner_refuses_by_name():
    p = bench.headline_params(1024)
    with pytest.raises(ValueError, match="multiple of the tuned"):
        at.tuned_runner(p, {**WINNER, "stale_k": 4}, 6)
    with pytest.raises(AutotuneCacheError, match="missing winner keys"):
        at.tuned_runner(p, {"engine": "fast"}, 8)
    with pytest.raises(ValueError, match="block-shape knob"):
        cm._runner(p, "overlap", 8, 1, lane_blocks=128)


# ------------------------------------------------------------ the bench


def test_bench_autotune_records_and_the_headline_times_the_winner(
        tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "SMOKE_N", 1024)
    monkeypatch.setattr(bench, "AUTOTUNE_SMOKE_DEPTH", (8, 1))
    root = str(tmp_path / "records")
    rec = bench.run_autotune(True, root=root)
    assert rec["metric"] == "autotune_rounds_per_sec_smoke"
    assert rec["platform"] == "cpu" and rec["n"] == 1024
    assert len(rec["rows"]) == 15
    assert sum("skipped" in r for r in rec["rows"]) == 3
    assert sorted(os.listdir(root)) == ["AUTOTUNE_CACHE.json",
                                        "TUNE_r01.json"]
    assert at.cached_winner(root, "cpu", 1024) == rec["winner"]
    (hist,) = cm.history_rows(cm.load_ledger(root))
    assert hist["value"] == rec["winner"]["rounds_per_sec"]
    # the headline times the cached winner beside its fixed runners
    res = bench.run_headline(smoke=True, root=root)
    assert res["tuned"]["config"] == rec["winner"]["config"]
    assert res["tuned"]["source"] == "cpu/n1024"
    assert res["rounds_per_sec"] == max(
        res["per_round"]["rounds_per_sec"], res["mega"]["rounds_per_sec"],
        res["tuned"]["rounds_per_sec"])
    assert res["value"] == res["rounds_per_sec"]
    cm.validate_record("BENCH_r01.json", {
        "n": 1024, "cmd": "bench", "rc": 0, "tail": "", "parsed": res})
    (tmp_path / "records" / "AUTOTUNE_CACHE.json").write_text("{")
    with pytest.raises(AutotuneCacheError, match="unreadable"):
        bench.run_headline(smoke=True, root=root)


def test_tune_phase_rehearsal(tmp_path):
    """chip_smoke's tune phase at 1,024 nodes on the CPU: the kernel
    runner's rows skip by name (and launch nothing), every other row
    measures; the records and the cache land under the phase's root."""
    import torch

    m = chip_smoke.modules()
    n = 1024
    roof, bad, launches, table = chip_smoke.tune_roofline(
        torch, m, CPU, n=n, rounds=8, reps=1)
    assert bad == [] and launches == {}
    assert [r["config"] for r in roof["rows"] if "skipped" in r] == \
        list(chip_smoke.CUDA_CONFIGS)
    assert roof["bandwidth"]["platform"] == "cpu"
    root = str(tmp_path / "records")
    os.makedirs(root)
    rec, tune, bad, launches = chip_smoke.tune_autotune(
        torch, m, CPU, root, n=n, rounds=8, reps=1)
    assert bad == [] and launches == {} and tune["tuned_bitwise"]
    assert len(tune["rows"]) == 15
    headline = {"metric": "gossip_rounds_per_sec_smoke", "value": 1.0,
                "unit": "rounds/s", "vs_baseline": None,
                "kernel": "round_kernel/stable", "platform": "cpu",
                "device": "cpu", "n": n,
                "full_per_round": {"rounds_per_sec": 1.0}}
    env = bench.profile_record(headline, table)
    assert env["schema"] == registry.PROFILE_SCHEMA_VERSION
    rows, bad = chip_smoke.tune_records(m, root, rec, env)
    assert bad == [] and [r["file"] for r in rows] == ["PROFILE_r01.json",
                                                       "TUNE_r01.json"]
    assert sorted(os.listdir(root)) == ["AUTOTUNE_CACHE.json",
                                        "PROFILE_r01.json", "TUNE_r01.json"]
    assert at.cached_winner(root, "cpu", n) == rec["winner"]
    # the launch bookkeeping the card run asserts
    rows = [{"engine": "cuda", "rounds_per_call": r} for r in (1, 4, 8)]
    assert chip_smoke.tune_launches(rows, 48, 3, "stable") == {
        "round_kernel/stable": 240, "mega_kernel/stable": 60 + 30}
    assert chip_smoke.tune_launches(rows, 24, 3, "full") == {
        "round_kernel/full": 120, "mega_kernel/full": 30 + 15}
