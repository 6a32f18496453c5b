"""The coordinates path (``scenarios.run_coords``, the CLI's
``-gossip-sim-coords``): the live engine's flight runner
(``round.run_rounds_flight``) with Vivaldi coordinates, RTT-aware probe
deadlines and the partition plan, a flight row every period with its
three coordinate columns. Each call is one whole cold-start trial: the
set-up's all-live state is restored in place and every coordinate reset
to ``coords.init_coords`` first; the call returns the flight trace.

The parameters, plan and topology come from the scenario's own set-up
(``scenarios.coords_setup``), given the configuration's constants and
its topology."""

from dataclasses import replace

from consul_tpu_torch import faults
from consul_tpu_torch.sim import coords as coords_mod
from consul_tpu_torch.sim import prng, scenarios
from consul_tpu_torch.sim import round as round_mod
from consul_tpu_torch.sim.state import init_state
from consul_tpu_torch.sim.topology import TopologyParams

from gossipbench import program
from gossipbench.drivers.chaos import _tensors

#: the configuration's keys that are SimParams fields besides
#: ``program.SIM_FIELDS``
COORD_FIELDS = ("coords_timeout", "coord_timeout_mult")


def fault_plan(spec: dict, n: int) -> faults.FaultPlan:
    """The traffic's plan as the program's ``FaultPlan`` for ``n``
    agents: a ``Partition`` of the ranges ``a`` and ``b``, each
    ``[lo, hi)`` fractions of n naming agents ``int(lo * n)`` to
    ``int(hi * n)``."""
    def prim(f):
        if f["primitive"] != "Partition":
            raise ValueError(f"the coordinates traffic cuts with "
                             f"Partition only, not {f['primitive']!r}")
        a, b = ((int(f[k][0] * n), int(f[k][1] * n)) for k in ("a", "b"))
        return faults.Partition(a=a, b=b, drop=f["drop"],
                                symmetric=f["symmetric"])

    return faults.FaultPlan(phases=tuple(
        faults.Phase(rounds=ph["rounds"], name=ph["name"],
                     faults=tuple(prim(f) for f in ph["faults"]))
        for ph in spec["phases"]))


def topology_params(spec: dict, n: int) -> TopologyParams:
    return TopologyParams(n=n, **spec)


class Driver(program.Driver):
    def __init__(self, cfg, traffic, dev, seed, n):
        self.cfg = cfg
        super().__init__(cfg, traffic, dev, seed, n)

    def build(self):
        self.p = replace(self.p, **{f: self.cfg[f] for f in COORD_FIELDS})
        self.setup = scenarios.coords_setup(
            self.n, p=self.p,
            topo_params=topology_params(self.cfg["topology"], self.n),
            device=self.dev)
        if fault_plan(self.traffic["plan"], self.n) != self.setup.plan:
            raise ValueError("the traffic's plan is not the scenario's "
                             "(scenarios.coords_plan)")
        if self.setup.plan.total_rounds != self.rounds:
            raise ValueError(f"a call runs the whole plan: {self.rounds} "
                             f"periods, the plan has "
                             f"{self.setup.plan.total_rounds}")
        self.init = init_state(self.n, device=self.dev)
        self.coords0 = coords_mod.init_coords(self.n, device=self.dev)
        self.coords = coords_mod.init_coords(self.n, device=self.dev)

    def call(self):
        # the trial starts from the set-up's state and a cold start of
        # every coordinate, copied into the live tensors
        for dst, src in zip(_tensors(self.state), _tensors(self.init)):
            dst.copy_(src)
        for dst, src in zip(self.coords, self.coords0):
            dst.copy_(src)
        key = prng.fold_in(self.key, self.calls)
        self.state, _, self.trace = round_mod.run_rounds_flight(
            self.state, key, self.p, self.rounds, plan=self.setup.cp,
            coords=self.coords, topo=self.setup.topo)
        self.calls += 1
        return self.trace

    def snapshot(self):
        """The state every call starts from."""
        live, self.state = self.state, self.init
        try:
            return super().snapshot()
        finally:
            self.state = live

    def outputs(self):
        out = program.Driver.snapshot(self)
        if self.trace is not None:
            out["trace"] = self.trace.clone()
        return out

    def close(self):
        super().close()
        self.setup = self.init = self.coords = self.coords0 = None
