"""The chaos path (``scenarios.run_chaos``): the per-period kernel
runner under a byzantine fault plan, a flight row every period. Each
call is one whole trial of the traffic's plan from the set-up's all-live
state, restored in place first: its frames take the ``byz`` variant of
``round_kernel``, and the call returns the flight trace."""

from consul_tpu_torch import faults
from consul_tpu_torch.sim import cuda_round, prng
from consul_tpu_torch.sim.state import STATS_FIELDS, init_state

from gossipbench import program

#: the traffic's primitives by name, their node ranges fractions of n
PRIMITIVES = {"Eclipse": faults.Eclipse}


def fault_plan(spec: dict, n: int) -> faults.FaultPlan:
    """The traffic's plan as the program's ``FaultPlan`` for ``n``
    agents: a range ``[lo, hi)`` of fractions names agents ``int(lo *
    n)`` to ``int(hi * n)``."""
    def prim(f):
        kw = {k: v for k, v in f.items() if k != "primitive"}
        for k in ("adversaries", "victims"):
            kw[k] = (int(kw[k][0] * n), int(kw[k][1] * n))
        return PRIMITIVES[f["primitive"]](**kw)

    return faults.FaultPlan(phases=tuple(
        faults.Phase(rounds=ph["rounds"], name=ph["name"],
                     faults=tuple(prim(f) for f in ph["faults"]))
        for ph in spec["phases"]))


def _tensors(s):
    return list(s.node_arrays()) + [s.t, s.round_idx] + \
        [getattr(s.stats, f) for f in STATS_FIELDS]


class Driver(program.Driver):
    def build(self):
        plan = fault_plan(self.traffic["plan"], self.n)
        if plan.total_rounds != self.rounds:
            raise ValueError(f"a call runs the whole plan: {self.rounds} "
                             f"periods, the plan has {plan.total_rounds}")
        self.plan = faults.compile_plan(plan, self.n, self.dev)
        self.init = init_state(self.n, device=self.dev)
        self.run = cuda_round.make_run_rounds_cuda(
            self.p, self.rounds, rounds_per_call=self.traffic["R"],
            plan=self.plan, flight_every=self.traffic["flight_every"])

    def call(self):
        # the trial starts from the set-up's state: lanes, clock, round 0
        # and zero counters copied into the live tensors
        for dst, src in zip(_tensors(self.state), _tensors(self.init)):
            dst.copy_(src)
        key = prng.fold_in(self.key, self.calls)
        self.state, self.trace = self.run(self.state, key)
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
        self.plan = self.init = None
