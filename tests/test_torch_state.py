"""consul_tpu_torch layout, params and state against the JAX reference.

Exact parity: the layout digest and tables, every derived SimParams
field, init_state values and dtypes, state_bytes, pack/unpack and the
scenario helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from consul_tpu_torch import config as tconfig
from consul_tpu_torch.sim import params as tparams
from consul_tpu_torch.sim import registry as treg
from consul_tpu_torch.sim import state as tstate
from test_torch_harness import ref  # noqa: F401  (fixture)

DERIVED = ("gossip_ticks_per_round", "suspicion_min_s", "suspicion_max_s",
           "confirmation_k", "shrink_r", "shrink_omr", "fanout_ticks",
           "one_minus_loss", "retransmit_limit", "p_direct", "p_relay",
           "p_tcp")


def test_layout_digest_equals_reference(ref):
    from consul_tpu.sim import registry as rreg

    assert treg.layout_digest() == rreg.layout_digest()
    for name in ("STATE_PACKED_FIELDS", "STATS_FIELDS", "REDUCE_LANES",
                 "LANE_SCALARS", "TICK_MAX", "CONF_MAX"):
        assert getattr(treg, name) == getattr(rreg, name), name


@pytest.mark.parametrize("preset", ["lan", "wan", "local"])
def test_gossip_config_equals_reference(preset):
    from consul_tpu import config as rconfig

    a = getattr(tconfig.GossipConfig, preset)()
    b = getattr(rconfig.GossipConfig, preset)()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for n in (1, 1000, 65_536, 1_048_576):
        assert a.suspicion_min_timeout(n) == b.suspicion_min_timeout(n)
        assert a.suspicion_max_timeout(n, 2) == b.suspicion_max_timeout(n, 2)
        assert a.retransmit_limit(n) == b.retransmit_limit(n)


def _param_cases(mod, cfg_mod):
    lan = cfg_mod.GossipConfig.lan()
    head = mod.SimParams.from_gossip_config(lan, n=1_048_576, loss=0.01,
                                            tcp_fallback=False,
                                            collect_stats=False)
    cases = dict(mod.baseline_configs())
    cases["headline"] = head
    cases["diag"] = head.with_(collect_stats=True, slow_per_round=0.001)
    cases["nolifeguard"] = head.with_(lifeguard=False, n=4096)
    return cases


def test_sim_params_derived_fields_equal_reference(ref):
    from consul_tpu import config as rconfig
    from consul_tpu.sim import params as rparams

    tc, rc = (_param_cases(tparams, tconfig),
              _param_cases(rparams, rconfig))
    assert tc.keys() == rc.keys()
    for name in tc:
        a, b = tc[name], rc[name]
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        for prop in DERIVED:
            assert getattr(a, prop) == getattr(b, prop), (name, prop)


def test_corroboration_is_refused_by_name():
    # out of [0, indirect_checks] is refused by name; inside it, k-of-m
    # corroboration runs (faults.detection_gate)
    with pytest.raises(ValueError, match="corroboration_k=9 out of range"):
        tparams.SimParams(corroboration_k=9)
    with pytest.raises(ValueError, match="corroboration_k=-1 out of range"):
        tparams.SimParams(corroboration_k=-1)
    assert tparams.SimParams(corroboration_k=3).corroboration_k == 3


@pytest.mark.parametrize("packed", [True, False])
def test_init_state_values_and_dtypes_exact(ref, packed):
    import jax

    from consul_tpu.sim import state as rstate

    n = 4096
    a = tstate.to_numpy(tstate.init_state(n, packed=packed, device="cpu"))
    b = jax.device_get(rstate.init_state(n, packed=packed))
    for f in tstate.NODE_FIELDS + ("t", "round_idx"):
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in tstate.SimStats._fields:
        x, y = getattr(a.stats, f), np.asarray(getattr(b.stats, f))
        assert x.dtype == y.dtype and x == y, f


def test_state_bytes_is_15_bytes_per_node(ref):
    from consul_tpu.sim import state as rstate

    n = 65_536
    s = tstate.init_state(n, device="cpu")
    assert tstate.state_bytes(s) == rstate.state_bytes(rstate.init_state(n))
    scalars = 4 + 4 + 4 * len(tstate.SimStats._fields)
    assert (tstate.state_bytes(s) - scalars) / n == 15


def test_pack_unpack_round_trip():
    s = tstate.with_crashed(tstate.init_state(512, device="cpu"), 3, age=9)
    wide = tstate.unpack(s)
    for f in ("incarnation", "down_age", "susp_len", "susp_ttl",
              "susp_conf"):
        assert getattr(wide, f).dtype == torch.int32
    assert wide.status.dtype == torch.int8
    back = tstate.pack(wide)
    for f in tstate.NODE_FIELDS:
        assert getattr(back, f).dtype == getattr(s, f).dtype
        assert torch.equal(getattr(back, f), getattr(s, f)), f


def test_scenario_helpers_equal_reference(ref):
    import jax

    from consul_tpu.sim import state as rstate

    n = 1024
    a = tstate.with_slow(tstate.with_crashed(
        tstate.init_state(n, device="cpu"), torch.tensor([5, 9]), age=7), 3)
    b = rstate.with_slow(rstate.with_crashed(
        rstate.init_state(n), np.array([5, 9]), age=7), 3)
    np.testing.assert_array_equal(a.down_age.numpy(),
                                  np.asarray(jax.device_get(b.down_age)))
    assert torch.equal(a.up, torch.from_numpy(np.asarray(b.up)))
    assert torch.equal(a.slow, torch.from_numpy(np.asarray(b.slow)))


def test_check_saturation_refuses_by_name():
    s = tstate.init_state(64, device="cpu")
    tstate.check_saturation(s)
    inc = s.incarnation.clone()
    inc[4] = tstate.TICK_MAX
    with pytest.raises(tstate.SaturationError, match="incarnation"):
        tstate.check_saturation(s._replace(incarnation=inc))


def test_numpy_round_trip_through_reference_state(ref):
    import jax

    from consul_tpu.sim import state as rstate

    r = jax.device_get(rstate.with_crashed(rstate.init_state(256), 4, 2))
    t = tstate.from_numpy(r, "cpu")
    assert t.down_age.dtype == torch.int16 and int(t.down_age[4]) == 2
    back = tstate.to_numpy(t)
    for f in tstate.NODE_FIELDS:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(r, f)))
