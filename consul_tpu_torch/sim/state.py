"""Per-node simulation state — the bit-packed tick layout, as tensors.

One row per virtual agent; the cluster is a NamedTuple of tensors in
the packed dtypes of ``registry.STATE_PACKED_FIELDS`` (15 B/node):
int8 status / susp_conf / local_health, int16 incarnation / down_age /
susp_len / susp_ttl, f32 informed. Liveness and the degraded flag are
not stored: they live in down_age's sentinel range (-1 live, -2 live and
slow, >= 0 dead for that many ticks) and surface as the ``up`` / ``slow``
properties.

Engines widen every narrow lane to int32 on load and narrow on store,
saturating at ``TICK_MAX`` / ``CONF_MAX``; ``check_saturation`` refuses a
state whose int16 lanes hit the cap, by field name. ``init_state(...,
packed=False)`` builds the same state with int32 storage (the
conformance twin); ``pack`` / ``unpack`` convert between the two.

``from_numpy`` / ``to_numpy`` carry a state across from (and back to)
any object with the same field names holding numpy arrays — e.g. the JAX
package's state after ``jax.device_get``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from consul_tpu_torch.sim import registry
from consul_tpu_torch.utils.platform import DeviceLike, default_device

# Rumor/member status encodings
ALIVE = 1
SUSPECT = 2
DEAD = 3
LEFT = 5

#: down_age sentinels
ALIVE_AGE = -1   # live, full-speed
SLOW_AGE = -2    # live, degraded

TICK_MAX = registry.TICK_MAX    # int16 tick/count lanes (inc, ages, len)
TTL_NEVER = registry.TICK_MAX   # susp_ttl value when no timer is armed
CONF_MAX = registry.CONF_MAX    # int8 confirmation counter

STATS_FIELDS = registry.STATS_FIELDS

_TORCH_DTYPE = {"int8": torch.int8, "int16": torch.int16,
                "float32": torch.float32}
_PACKED = {name: _TORCH_DTYPE[d] for name, d, _ in
           registry.STATE_PACKED_FIELDS}
#: per-node fields, in kernel array order
NODE_FIELDS = tuple(name for name, _, _ in registry.STATE_PACKED_FIELDS)
#: their packed dtypes, in the same order: the layout the kernels take
PACKED_DTYPES = tuple(_PACKED[f] for f in NODE_FIELDS)
#: fields whose unpacked twin widens to int32
_WIDENED = ("incarnation", "down_age", "susp_len", "susp_ttl",
            "susp_conf")


class SimStats(NamedTuple):
    """Cumulative scalar counters (0-d int32 tensors; latency f32)."""

    false_positives: torch.Tensor
    refutes: torch.Tensor
    suspicions: torch.Tensor
    true_deaths_declared: torch.Tensor
    detect_latency_sum: torch.Tensor
    crashes: torch.Tensor
    rejoins: torch.Tensor
    leaves: torch.Tensor
    attack_suspicions: torch.Tensor
    attack_false_positives: torch.Tensor

    @staticmethod
    def zeros(device: DeviceLike = None) -> "SimStats":
        dev = default_device(device)
        return SimStats(**{
            f: torch.zeros((), dtype=torch.float32 if
                           f == "detect_latency_sum" else torch.int32,
                           device=dev)
            for f in SimStats._fields})


def stats_vector(st: SimStats) -> torch.Tensor:
    """SimStats as a [len(STATS_FIELDS)] f32 vector in STATS_FIELDS
    order."""
    return torch.stack([getattr(st, f).to(torch.float32)
                        for f in STATS_FIELDS])


class SimState(NamedTuple):
    """Struct-of-arrays cluster state; all [N] unless noted."""

    status: torch.Tensor       # int8 — ALIVE/SUSPECT/DEAD/LEFT
    incarnation: torch.Tensor  # int16
    informed: torch.Tensor     # f32 — fraction of cluster with the rumor
    down_age: torch.Tensor     # int16 — -1 live, -2 slow, >= 0 dead age
    susp_len: torch.Tensor     # int16 — suspicion timer length (ticks)
    susp_ttl: torch.Tensor     # int16 — ticks to declare (TTL_NEVER idle)
    susp_conf: torch.Tensor    # int8 — independent confirmations
    local_health: torch.Tensor  # int8 — Lifeguard awareness
    t: torch.Tensor            # f32 0-d — sim time, seconds
    round_idx: torch.Tensor    # int32 0-d
    stats: SimStats

    @property
    def up(self) -> torch.Tensor:
        """[N] bool — process liveness (down_age < 0)."""
        return self.down_age < 0

    @property
    def slow(self) -> torch.Tensor:
        """[N] bool — live-and-degraded (down_age == SLOW_AGE)."""
        return self.down_age == SLOW_AGE

    def node_arrays(self) -> tuple:
        """The 8 per-node tensors in kernel array order."""
        return tuple(getattr(self, f) for f in NODE_FIELDS)


def check_packed(vals, what: str, dims: tuple = (1,)) -> tuple:
    """Refuse, by field name, lanes that ``what`` (a kernel) cannot take:
    the 8 per-node tensors in ``NODE_FIELDS`` order and the packed
    dtypes, contiguous, of one shape of ``dims`` dimensions, on one
    device. Returns that shape."""
    if len(vals) != len(NODE_FIELDS):
        raise ValueError(f"{what} takes {len(NODE_FIELDS)} node lanes "
                         f"({', '.join(NODE_FIELDS)}), got {len(vals)}")
    dev, shape = vals[0].device, tuple(vals[0].shape)
    if len(shape) not in dims:
        raise ValueError(f"{what} takes lanes of {dims} dimensions; got "
                         f"{shape}")
    for f, a, dt in zip(NODE_FIELDS, vals, PACKED_DTYPES):
        if a.device != dev or a.dtype != dt or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(
                f"{what} takes the packed layout as contiguous {shape} "
                f"lanes on {dev}: {f} is {a.dtype} {tuple(a.shape)} on "
                f"{a.device} (want {dt})")
    return shape


def _dtype(field: str, packed: bool) -> torch.dtype:
    if packed or field not in _WIDENED:
        return _PACKED[field]
    return torch.int32


def init_state(n: int, packed: bool = True,
               device: DeviceLike = None) -> SimState:
    """Everyone alive, fully converged, health perfect."""
    dev = default_device(device)

    def full(field, value):
        return torch.full((n,), value, dtype=_dtype(field, packed),
                          device=dev)

    return SimState(
        status=full("status", ALIVE),
        incarnation=full("incarnation", 0),
        informed=full("informed", 1.0),
        down_age=full("down_age", ALIVE_AGE),
        susp_len=full("susp_len", 0),
        susp_ttl=full("susp_ttl", TTL_NEVER),
        susp_conf=full("susp_conf", 0),
        local_health=full("local_health", 0),
        t=torch.zeros((), dtype=torch.float32, device=dev),
        round_idx=torch.zeros((), dtype=torch.int32, device=dev),
        stats=SimStats.zeros(dev),
    )


def pack(state: SimState) -> SimState:
    """Narrow a wide-storage state to the packed dtypes."""
    return state._replace(**{f: getattr(state, f).to(_PACKED[f])
                             for f in _WIDENED})


def unpack(state: SimState) -> SimState:
    """Widen a packed state to int32 storage (the conformance twin)."""
    return state._replace(**{f: getattr(state, f).to(torch.int32)
                             for f in _WIDENED})


def with_crashed(state: SimState, idx, age: int = 0) -> SimState:
    """Mark node(s) ``idx`` crashed ``age`` ticks ago (returns a copy)."""
    down_age = state.down_age.clone()
    down_age[idx] = age
    return state._replace(down_age=down_age)


def with_slow(state: SimState, idx) -> SimState:
    """Mark LIVE node(s) ``idx`` degraded (returns a copy)."""
    down_age = state.down_age.clone()
    down_age[idx] = SLOW_AGE
    return state._replace(down_age=down_age)


class SaturationError(ValueError):
    """A narrowing store hit its saturation cap: the clamped lane no
    longer carries the true value. Names the field(s)."""


SATURATING_FIELDS = (("incarnation", TICK_MAX),
                     ("down_age", TICK_MAX),
                     ("susp_len", TICK_MAX))


def saturated_fields(get_max) -> list:
    """Names of the saturated lanes; ``get_max(field)`` returns the
    lane's max as a host int (``checkpoint.snapshot`` reads its arrays
    already fetched to the host)."""
    return [f for f, cap in SATURATING_FIELDS if get_max(f) >= cap]


def check_saturation(state: SimState) -> None:
    """Refuse-by-name guard over the saturating narrow stores (one small
    device fetch per checked field)."""
    saturated = saturated_fields(lambda f: int(getattr(state, f).max()))
    if saturated:
        raise SaturationError(
            f"packed state saturated: {', '.join(saturated)} hit the "
            f"int16 cap ({TICK_MAX}) — the narrowed lane no longer "
            "carries the true value. Shorten the run, or use "
            "init_state(packed=False) (wide int32 storage).")


def _leaves(state: SimState):
    for f in SimState._fields:
        v = getattr(state, f)
        if f == "stats":
            yield from v
        else:
            yield v


def state_bytes(state: SimState) -> int:
    """Bytes of every tensor in the state (15 B/node + 48 B of scalars)."""
    return sum(x.numel() * x.element_size() for x in _leaves(state))


def from_numpy(arrays: Any, device: DeviceLike = None) -> SimState:
    """A port state from any object carrying SimState's field names as
    numpy arrays (``arrays.stats`` carrying SimStats' names)."""
    dev = default_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    st = arrays.stats
    return SimState(
        **{f: t(getattr(arrays, f)) for f in NODE_FIELDS},
        t=t(np.asarray(arrays.t, np.float32)),
        round_idx=t(np.asarray(arrays.round_idx, np.int32)),
        stats=SimStats(**{f: t(getattr(st, f)) for f in SimStats._fields}))


def to_numpy(state: SimState) -> SimState:
    """The same state with every tensor fetched as a numpy array."""
    def a(x):
        return x.detach().cpu().numpy()

    return SimState(
        **{f: a(getattr(state, f)) for f in NODE_FIELDS},
        t=a(state.t), round_idx=a(state.round_idx),
        stats=SimStats(*[a(x) for x in state.stats]))
