"""The exact lane engine (``round.make_run_rounds_lanes``) at the
traffic's ``stale_k``: on the card a period is one draw launch and one
``lane_round`` launch, a window one reduction."""

from consul_tpu_torch.sim import round as round_mod

from gossipbench import program


class Driver(program.Driver):
    def build(self):
        self.run = round_mod.make_run_rounds_lanes(self.p, self.rounds)

    def call(self):
        self.state = self.run(self.state, self.key)
        self.calls += 1
        return self.counters()
