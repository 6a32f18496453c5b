"""The autotuner's sweep (``scenarios.run_autotune``, the CLI's
``-gossip-sim-sweep``) on the lane engine: ``sweep.make_run_sweep(p,
rounds, engine="lanes")`` over the grid ``params.grid_params`` lifts
from the traffic's axes, both built once, as ``bench.run_sweep_class``
builds them. A pool is ``n / points`` agents (the configuration's
``pool_n`` at its ``n``).

Each call is one whole sweep: every point from the all-live state
(the runner builds it anew and runs on a copy), on the key
``fold_in(seed key, call)``, then ``metrics.sweep_report`` ranks the
points on the host; the caller reads the winner.

The check reads the grid in the form of one pool (``gossipbench/
grid.py``): the lanes flattened point-major, the clocks and counters
added over the points, and the report's ``[12, G]`` inputs as the
check's ``scalars``."""

from consul_tpu_torch.sim import metrics, prng, sweep
from consul_tpu_torch.sim.params import SweepAxes, grid_params
from consul_tpu_torch.sim.state import STATS_FIELDS

from gossipbench import grid, program


class Driver(program.Driver):
    def __init__(self, cfg, traffic, dev, seed, n):
        self.points = cfg["points"]
        if n % self.points:
            raise ValueError(f"{n} agent-rows do not split into "
                             f"{self.points} pools")
        self.pool = n // self.points
        super().__init__(cfg, traffic, dev, seed, n)

    def build(self):
        self.p = self.p.with_(n=self.pool)
        self.tp, self.grid_points = grid_params(
            self.p, SweepAxes.of(**self.traffic["grid"]), self.dev)
        if len(self.grid_points) != self.points:
            raise ValueError(f"the traffic's grid has "
                             f"{len(self.grid_points)} points, the "
                             f"configuration {self.points}")
        self.run = sweep.make_run_sweep(self.p, self.rounds,
                                        engine="lanes", device=self.dev)
        self.result = None

    def start(self):
        self.result = None
        self.calls = 0

    def call(self):
        key = prng.fold_in(self.key, self.calls)
        states, _ = self.run(self.tp, key)
        self.result = sweep.SweepResult(
            states=states, trace=None, tp=self.tp, points=self.grid_points,
            rounds=self.rounds, flight_every=None)
        report = metrics.sweep_report(self.result,
                                      fp_budget=self.traffic["fp_budget"])
        self.calls += 1
        return report

    @staticmethod
    def fetch(out):
        return out["winner"]

    @staticmethod
    def _stats(s) -> tuple:
        return tuple(getattr(s.stats, f) for f in STATS_FIELDS)

    def _form(self, s) -> dict:
        out = grid.fold(s.node_arrays(), s.t, s.round_idx, self._stats(s))
        out["call"] = self.calls
        return out

    def snapshot(self):
        """The all-live state every call starts from."""
        return self._form(sweep._broadcast_state(self.p, self.points,
                                                 self.dev))

    def outputs(self):
        s = self.result.states
        out = self._form(s)
        out["scalars"] = grid.report_inputs(s.node_arrays(), s.t,
                                            self._stats(s))
        return out

    def close(self):
        super().close()
        self.result = self.tp = None
