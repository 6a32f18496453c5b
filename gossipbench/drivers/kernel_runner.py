"""The CUDA kernel runner (``cuda_round.make_run_rounds_cuda``): R=1
launches ``round_kernel`` a period, R > 1 ``mega_kernel`` every R
periods; optionally the flight recorder and the carried stale scalars,
as the CLI's default mode runs it."""

from consul_tpu_torch.sim import cuda_round, prng
from consul_tpu_torch.sim.round import init_scalars
from consul_tpu_torch.sim.state import SimState

from gossipbench import program


class Driver(program.Driver):
    def build(self):
        tr = self.traffic
        self.carry = bool(tr.get("carry"))
        self.record = tr.get("flight_every") is not None
        self.run = cuda_round.make_run_rounds_cuda(
            self.p, self.rounds, rounds_per_call=tr["R"], carry=self.carry,
            flight_every=tr.get("flight_every"))

    def start(self):
        super().start()
        if self.carry:
            # the CLI makes the first chunk's scalars once, up front
            self.scalars = init_scalars(self.state, self.p)

    def call(self):
        key = prng.fold_in(self.key, self.calls) \
            if self.traffic["key"] == "fold_in" else self.key
        if self.carry:
            res = self.run(self.state, key, scalars0=self.scalars)
        else:
            res = self.run(self.state, key)
        res = (res,) if isinstance(res, SimState) else res
        self.state = res[0]
        if self.record:
            self.trace = res[1]
        if self.carry:
            self.scalars = res[-1]
        self.calls += 1
        return self.trace if self.traffic["read"] == "trace" \
            else self.counters()
