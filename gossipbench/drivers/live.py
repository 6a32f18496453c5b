"""The live engine (``round.make_run_rounds``): every period on its own
population sums, one captured period replayed a period."""

from consul_tpu_torch.sim import round as round_mod

from gossipbench import program


class Driver(program.Driver):
    def build(self):
        self.run = round_mod.make_run_rounds(self.p, self.rounds)

    def call(self):
        self.state = self.run(self.state, self.key)
        self.calls += 1
        return self.counters()
