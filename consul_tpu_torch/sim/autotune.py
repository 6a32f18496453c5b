"""Runner autotuner — sweep the ``measure_config`` seam, persist winners.

Counterpart of the JAX package's ``consul_tpu/sim/autotune.py``. The
levers left once the state is packed are schedule-shaped: how many rounds
one kernel launch runs (``rounds_per_call``), how wide the lane engine's
reduction block table sums (``lane_blocks``), and how many rounds share
one frozen-scalar window (``stale_k``). None has a portable best: the
winner depends on the device's launch cost against its bandwidth, and on
n. So this module measures:

* ``sweep_space(platform)`` — the grid, every point an (engine, stale_k,
  rounds_per_call, lane_blocks) config ``costmodel.measure_config`` can
  time: the reference's 15 points with the kernel runner (``cuda``) in
  the place of its Pallas kernel. The space is the same on every
  platform; off the card the ``cuda`` points record their skip.
* ``autotune(p, ...)`` — times every point on the real runners and picks
  the winner by rounds/s. The payload is the ``TUNE`` ledger family.
* the winner cache — ``AUTOTUNE_CACHE.json`` in a record root, keyed
  ``{platform}/n{n}`` (the platform is the device type: ``cuda/n1048576``),
  each entry exactly ``registry.AUTOTUNE_WINNER_KEYS``. The headline
  bench times the cached winner next to its fixed runners and names it;
  a corrupt or schema-drifted cache refuses by file and key
  (``AutotuneCacheError``). The format is the reference's: a cache
  either package writes, the other's ``load_cache`` reads.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any, Optional

from consul_tpu_torch.sim import registry
from consul_tpu_torch.sim.costmodel import (EngineUnavailable, _runner,
                                            config_label, measure_config)
from consul_tpu_torch.utils.platform import default_device

#: the persisted winner cache, beside the recorded *_r*.json artifacts
CACHE_FILE = "AUTOTUNE_CACHE.json"

#: stale_k points the lanes/overlap axes sweep (within registry.STALE_KS)
SWEEP_STALE_KS = (1, 2, 4)

#: rounds_per_call points the kernel runner's axis sweeps
SWEEP_ROUNDS_PER_CALL = (1, 4, 8)


class AutotuneCacheError(ValueError):
    """AUTOTUNE_CACHE.json failed to load or validate (named file+key).

    The cache feeds the headline bench's tuned tier: a corrupt entry
    would make a number measure something other than what its envelope
    says, so the loader refuses instead."""


def sweep_space(platform: str) -> tuple[dict[str, Any], ...]:
    """The autotune grid as measure_config kwargs: the fast engine, the
    lanes engine over stale_k x ``AUTOTUNE_LANE_BLOCKS``, the overlap
    schedule over stale_k > 1 (at the pinned block width), and the
    kernel runner over ``SWEEP_ROUNDS_PER_CALL``. The same 15 points on
    every platform, so TUNE records compare across them."""
    space: list[dict[str, Any]] = [
        {"engine": "fast", "stale_k": 1, "rounds_per_call": 1,
         "lane_blocks": None},
    ]
    for k in SWEEP_STALE_KS:
        for blocks in registry.AUTOTUNE_LANE_BLOCKS:
            space.append({"engine": "lanes", "stale_k": k,
                          "rounds_per_call": 1, "lane_blocks": blocks})
    for k in SWEEP_STALE_KS:
        if k > 1:
            space.append({"engine": "overlap", "stale_k": k,
                          "rounds_per_call": 1, "lane_blocks": None})
    for rpc in SWEEP_ROUNDS_PER_CALL:
        space.append({"engine": "cuda", "stale_k": 1,
                      "rounds_per_call": rpc, "lane_blocks": None})
    return tuple(space)


def _config_params(p, cfg: dict[str, Any]):
    """The point's SimParams and lane cadence."""
    k = cfg["stale_k"]
    pk = p.with_(stale_k=k) if cfg["engine"] in ("lanes", "overlap") \
        else p
    return pk, k


def _aligned_rounds(rounds: int, cadence: int) -> int:
    if rounds % cadence:
        return cadence * max(1, rounds // cadence)
    return rounds


def autotune(p, rounds: int = 24, reps: int = 3,
             platform: Optional[str] = None,
             space: Optional[tuple] = None,
             metric: str = "autotune_rounds_per_sec",
             measure=None, device=None) -> dict[str, Any]:
    """Time every sweep-space point and pick the rounds/s winner.

    Returns the TUNE payload {metric, platform, n, rounds, rows, winner}.
    Rows are ``measure_config`` rows without the byte count (the tuner
    ranks wall clock); a point whose engine cannot run on this device
    (``EngineUnavailable``) records ``{"config", "engine", "skipped"}``,
    and any other failure raises. ``measure`` is injectable (called as
    the reference calls it); by default ``measure_config`` on
    ``device``, whose type is the platform.

    Raises ValueError when NO point measures: a winner is never
    fabricated."""
    if measure is None:
        dev = default_device(device)
        measure = functools.partial(measure_config, device=dev)
        platform = platform or dev.type
    if platform is None:
        platform = default_device(device).type
    if space is None:
        space = sweep_space(platform)
    rows = []
    for cfg in space:
        pk, k = _config_params(p, cfg)
        r = _aligned_rounds(rounds, max(k, cfg["rounds_per_call"]))
        try:
            rows.append(measure(
                pk, rounds=r, engine=cfg["engine"],
                rounds_per_call=cfg["rounds_per_call"],
                lane_blocks=cfg["lane_blocks"],
                reps=reps, measure_bytes=False))
        except EngineUnavailable as e:
            rows.append({
                "config": config_label(cfg["engine"], k,
                                       cfg["rounds_per_call"],
                                       cfg["lane_blocks"]),
                "engine": cfg["engine"],
                "skipped": f"{type(e).__name__}: {e}"})
    measured = [r for r in rows if "skipped" not in r]
    if not measured:
        raise ValueError(
            f"autotune measured 0 of {len(rows)} configs on "
            f"{platform} — every point skipped; a winner is never "
            "fabricated")
    best = max(measured, key=lambda r: r["rounds_per_sec"])
    winner = {key: best[key] for key in registry.AUTOTUNE_WINNER_KEYS}
    return {"metric": metric, "platform": platform, "n": p.n,
            "rounds": rounds, "rows": rows, "winner": winner}


# ------------------------------------------------------- winner cache


def cache_key(platform: str, n: int) -> str:
    return f"{platform}/n{n}"


def _cache_path(root: str) -> str:
    return os.path.join(root, CACHE_FILE)


def validate_winner(where: str, winner: Any) -> None:
    """The AUTOTUNE_WINNER_KEYS schema check of one winner."""
    if not isinstance(winner, dict):
        raise AutotuneCacheError(
            f"{where}: winner must be an object, got "
            f"{type(winner).__name__}")
    missing = [k for k in registry.AUTOTUNE_WINNER_KEYS
               if k not in winner]
    if missing:
        raise AutotuneCacheError(
            f"{where}: missing winner keys {sorted(missing)} "
            f"(schema: {list(registry.AUTOTUNE_WINNER_KEYS)})")
    if not isinstance(winner.get("rounds_per_sec"), (int, float)):
        raise AutotuneCacheError(
            f"{where}: rounds_per_sec must be numeric, got "
            f"{winner.get('rounds_per_sec')!r}")


def load_cache(root: str) -> dict[str, dict[str, Any]]:
    """Load + validate the winner cache. A missing file is {} (an
    untuned host is normal); an unreadable or schema-drifted cache
    raises AutotuneCacheError by file and key."""
    path = _cache_path(root)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise AutotuneCacheError(
            f"{CACHE_FILE}: unreadable winner cache: {e} — delete the "
            "file and re-run python -m consul_tpu_torch.bench "
            "--autotune") from e
    if not isinstance(data, dict):
        raise AutotuneCacheError(
            f"{CACHE_FILE}: cache must be an object keyed by "
            f"'{{platform}}/n{{N}}', got {type(data).__name__}")
    for key, winner in data.items():
        validate_winner(f"{CACHE_FILE}[{key}]", winner)
    return data


def save_winner(root: str, platform: str, n: int,
                winner: dict[str, Any]) -> str:
    """Merge one (platform, n) winner into the cache, atomically (tmp +
    rename: a preempted write cannot tear the cache). Returns the cache
    path. The existing cache must validate first."""
    validate_winner(f"{cache_key(platform, n)} winner", winner)
    cache = load_cache(root)
    cache[cache_key(platform, n)] = winner
    fd, tmp = tempfile.mkstemp(dir=root, prefix=CACHE_FILE + ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, _cache_path(root))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return _cache_path(root)


def cached_winner(root: str, platform: str, n: int
                  ) -> Optional[dict[str, Any]]:
    """The persisted winner for (platform, n), or None when that pair
    was never tuned. Validation errors propagate: the caller (the
    headline bench) must not fall back silently."""
    return load_cache(root).get(cache_key(platform, n))


def tuned_runner(p, winner: dict[str, Any], rounds: int):
    """The real runner of a winner config, ``run(state, key) -> state``
    — the headline bench's tuned path. ``rounds`` must cover whole
    cadences (the ``measure_config`` contract)."""
    validate_winner("tuned_runner winner", winner)
    engine = winner["engine"]
    k = int(winner["stale_k"])
    rpc = int(winner["rounds_per_call"])
    pk = p.with_(stale_k=k) if engine in ("lanes", "overlap") else p
    blocks = winner["lane_blocks"] if engine == "lanes" else None
    if rounds % max(k, rpc):
        raise ValueError(
            f"rounds={rounds} must be a multiple of the tuned "
            f"config's cadence (stale_k={k}, rounds_per_call={rpc})")
    return _runner(pk, engine, rounds, rpc, blocks)
