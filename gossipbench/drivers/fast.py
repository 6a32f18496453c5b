"""The stale-scalar fast runner (``round.make_run_rounds_fast``): each
period on the last period's population scalars, one captured period
replayed a period on the card; a call starts from the state's exact
scalars (``round.init_scalars``)."""

from consul_tpu_torch.sim import round as round_mod

from gossipbench import program


class Driver(program.Driver):
    def build(self):
        self.run = round_mod.make_run_rounds_fast(self.p, self.rounds)

    def call(self):
        self.state = self.run(self.state, self.key)
        self.calls += 1
        return self.counters()
