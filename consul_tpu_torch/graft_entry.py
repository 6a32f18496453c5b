"""The port's twins of the JAX package's entry points in __graft_entry__.py.

    python -m consul_tpu_torch.graft_entry [N_DEVICES] [--device cpu]

``entry()`` is the counterpart of ``__graft_entry__.entry``: ``(fn,
args)`` with ``fn(state, key)`` one ``round.gossip_round`` over 65,536
nodes at ``SimParams(n=65_536, loss=0.01)`` and ``args`` the initial
state and ``prng.key(0)`` on the card (or the ``device`` given).

``dryrun_multichip(n_devices)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: ``n_devices`` ranks (gloo, on the
device the caller names — the card unless ``device="cpu"``), laid out
with dc=2 where ``n_devices`` is even. Each rank runs the sharded lane
engine (``mesh.make_sharded_run``) and the per-DC pools
(``mesh.make_multidc_run``) for 2 rounds at 64·n_devices nodes with the
reference's SimParams, then the viewer-sharded dense tier
(``views.make_sharded_views_round``) for 2 rounds at 16·n_devices
viewers, and asserts the round counts. gloo is the backend because it
puts several ranks on one card; NCCL takes one card per rank.
"""

from __future__ import annotations

import argparse
import sys

from consul_tpu_torch.sim import mesh as mesh_mod
from consul_tpu_torch.sim import prng
from consul_tpu_torch.sim.params import SimParams
from consul_tpu_torch.sim.round import gossip_round
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.sim.views import make_sharded_views_round
from consul_tpu_torch.utils.platform import DeviceLike, default_device

#: entry()'s population
ENTRY_N = 65_536


def entry(device: DeviceLike = None):
    """(fn, example_args): one SWIM gossip round over ``ENTRY_N`` virtual
    members, the flagship workload's inner loop."""
    dev = default_device(device)
    p = SimParams(n=ENTRY_N, loss=0.01)

    def fn(state, key):
        return gossip_round(state, key, p)

    return fn, (init_state(p.n, device=dev), prng.key(0, device=dev))


def _dryrun_rank(mesh: mesh_mod.Mesh, n_devices: int) -> dict:
    dev = mesh.device
    n = 64 * n_devices
    p = SimParams(n=n, loss=0.05, fail_per_round=0.01, rejoin_per_round=0.05,
                  slow_per_round=0.01)
    run = mesh_mod.make_sharded_run(p, rounds=2, mesh=mesh)
    out = run(mesh_mod.init_sharded_state(n, mesh), prng.key(0, dev))
    assert int(out.round_idx) == 2, int(out.round_idx)

    # the per-DC-isolated pools on the same mesh
    p2 = SimParams(n=n // mesh.dc, loss=0.05, collect_stats=False)
    run2 = mesh_mod.make_multidc_run(p2, rounds=2, mesh=mesh)
    out2 = run2(mesh_mod.init_sharded_state(n, mesh), prng.key(1, dev))
    assert int(out2.round_idx) == 2, int(out2.round_idx)

    # the dense per-viewer tier, sharded over the same ranks
    pv = SimParams(n=16 * n_devices, loss=0.02)
    vround, vinit = make_sharded_views_round(pv, mesh)
    vst = vinit()
    for i in range(2):
        vst = vround(vst, prng.key(10 + i, dev))
    assert int(vst.round) == 2, int(vst.round)
    return {"rank": mesh.rank, "rounds": int(out.round_idx),
            "multidc_rounds": int(out2.round_idx),
            "views_rounds": int(vst.round),
            "suspicions": int(out.stats.suspicions)}


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> list:
    """Run the sharded step on ``n_devices`` gloo ranks (see the module
    docstring); returns each rank's summary, in rank order."""
    default_device(device)  # no card and no "cpu": refuse before spawning
    dc = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    return mesh_mod.launch(n_devices, _dryrun_rank, backend="gloo",
                           device=device, dc=dc, args=(n_devices,),
                           timeout=300.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu for the host; the card by default")
    args = ap.parse_args(argv)
    for row in dryrun_multichip(args.n_devices, args.device):
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
