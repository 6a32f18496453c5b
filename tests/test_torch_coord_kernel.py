"""consul_tpu_torch's coordinate kernels: ``sim/coord_kernel.py`` and
``csrc/coord_kernels.cu`` (``coord_probe``, ``vivaldi_relax``,
``coord_quality``: the Vivaldi coordinate round as three launches).

CPU half:

* The ctypes argument structs against the structs in the source, field
  for field; each launch's arguments point at every tensor it reads and
  writes.
* The wrappers refuse CPU tensors; the routing takes the plain versions
  for CPU tensors, and the kernels for card tensors in every per-period
  caller (the live engine's coordinate branch, ``run_rounds_coords``,
  ``gossip_round(coords=)``, the kernel runner's ``coord_round``, a
  grid's round, ``vivaldi_step``'s full form, ``coord_metrics``), one
  launch each a period.
* ``costmodel.coord_bound``.

Card half (``cuda``): each launch against its plain version on the card
at 4,096 and 2^20 agents, for ``[N]`` and ``[G, N]`` coordinates, with
deadlines on and off, from a cold start (every point coincident) and a
warm one, with ``upd`` false and ``rtt <= 0`` rows: ``timely``, the ring
cursors and the gates exact, the f32 outputs within ``ULPS`` (the
kernels' note); the probe and the quality row on latency maps of 1 to
``MAX_TOPO_DIMS`` dimensions; a 140-period flight run of the coordinates
scenario at 4,096 whose coordinate columns agree with the plain route
within 1e-6; the kernel runner with coordinates captured against eager;
and the sweep's coordinate grid with swept deadline leaves, bit for bit
its plain route, with one launch of each kernel a grid round.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import re

import pytest
import torch

from consul_tpu_torch.sim import coord_kernel as CK
from consul_tpu_torch.sim import coords as C
from consul_tpu_torch.sim import costmodel, cuda_round, flight, graphs, prng
from consul_tpu_torch.sim import round as tround
from consul_tpu_torch.sim import scenarios, sweep
from consul_tpu_torch.sim import topology as T
from consul_tpu_torch.sim.params import SimParams, SweepAxes, grid_params
from consul_tpu_torch.sim.state import init_state
from test_torch_harness import cuda  # noqa: F401  (fixture)

CPU = torch.device("cpu")
SOURCE = pathlib.Path(CK.__file__).resolve().parent.parent / "csrc" \
    / "coord_kernels.cu"
#: the f32 outputs' largest distance from the plain version, in ulps
ULPS = 0
#: the coordinate columns of a 140-period run, against the plain route
TRACE_ATOL = 1e-6


# ------------------------------------------------------------- the data


def _case(n: int, dev, points: int = 0, cold: bool = False, seed: int = 0,
          timeout: float = 0.01, topo_dims: int = 4):
    """A coordinate round's inputs: the latency map, the coordinates
    (``[points, N, ...]`` for a grid; cold: every agent at the origin),
    the pairs, the jitter normal, the local health, the gates and the
    deadline constants (a tight timeout, so some deadlines bind; a
    grid's as ``[G, 1]`` leaves, one timeout a point)."""
    g = torch.Generator().manual_seed(seed)
    lead = (points,) if points else ()

    def rand(*shape):
        return torch.rand(lead + shape, generator=g)

    topo = T.make_topology(T.TopologyParams(n=n, seed=seed,
                                            dims=topo_dims), dev)
    if cold:
        c = C.init_coords(n, device=CPU)
        c = C.CoordState(*(x.repeat(lead + (1,) * x.dim()) for x in c))
    else:
        c = C.CoordState(
            vec=0.05 * (rand(n, C.DIMENSION) - 0.5),
            error=0.05 + 1.45 * rand(n),
            height=1e-5 + 5e-3 * rand(n),
            adjustment=2e-3 * (rand(n) - 0.5),
            adj_samples=4e-3 * (rand(n, C.ADJUSTMENT_WINDOW) - 0.5),
            adj_idx=torch.randint(0, C.ADJUSTMENT_WINDOW, lead + (n,),
                                  generator=g, dtype=torch.int32))
        # a few coincident pairs and agents at the origin
        c.vec[..., : n // 64, :] = 0.0
    c = C.CoordState(*(x.to(dev) for x in c))
    key = prng.key(seed + 1, device=dev)
    k_pair, k_jit, k_dir, k_q = prng.split(key, 4)
    pair_j = T.sample_pairs(n, k_pair)
    q_in = T.sample_pairs(n, k_q)
    lh = torch.randint(0, 4, lead + (n,), generator=g,
                       dtype=torch.int32).to(dev)
    ack = (torch.rand(lead + (n,), generator=g) < 0.9).to(dev)
    up = (torch.rand(lead + (n,), generator=g) < 0.95).to(dev)
    if points:
        leaf = torch.linspace(timeout, 4 * timeout, points).view(-1, 1)
        deadline = (torch.full((points, 1), 3.0).to(dev),
                    torch.full((points, 1), 1.0).to(dev), leaf.to(dev))
    else:
        deadline = (3.0, 1.0, timeout)
    return dict(topo=topo, coords=c, pair_j=pair_j, q_in=q_in, lh=lh,
                ack=ack, up=up, deadline=deadline, k_jit=k_jit,
                k_dir=k_dir)


def _rtt_with_dead_rows(rtt: torch.Tensor) -> torch.Tensor:
    """Round trips with zero and negative rows (they keep their
    coordinate)."""
    rtt = rtt.clone()
    rtt[1::97] = 0.0
    rtt[2::89] = -1e-3
    return rtt


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two f32 tensors in units in the last
    place (0 where both are equal, signed zeros equal)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if a.numel() == 0:
        return 0
    d = (ordered(a) - ordered(b)).abs()
    d = torch.where(a == b, torch.zeros_like(d), d)
    return int(d.max())


# -------------------------------------------------------------- the CPU


def _cu_struct(name: str) -> list:
    """(field, ctypes type) of ``struct <name>`` in the kernels' source."""
    text = SOURCE.read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, text, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"(const\s+)?(long long|[A-Za-z_0-9]+)\s*(\*?)\s*"
                     r"([A-Za-z_0-9, *]+)$", decl)
        base, star = m.group(2), m.group(3)
        for f in m.group(4).split(","):
            f = f.strip()
            ptr = bool(star) or f.startswith("*")
            f = f.lstrip("*").strip()
            kind = ctypes.c_void_p if ptr else {
                "long long": ctypes.c_longlong, "int": ctypes.c_int,
                "float": ctypes.c_float}[base.strip()]
            fields.append((f, kind))
    return fields


@pytest.mark.parametrize("struct", CK.STRUCTS, ids=lambda s: s.__name__)
def test_the_structs_mirror_the_source(struct):
    assert [(f, t) for f, t in struct._fields_] == _cu_struct(
        struct.__name__)


def test_the_layout_constants_mirror_the_source():
    text = SOURCE.read_text()
    for name, want in (("DIMS", CK.DIMS), ("WINDOW", CK.WINDOW),
                       ("MAX_TOPO_DIMS", CK.MAX_TOPO_DIMS),
                       ("THREADS", CK.THREADS)):
        assert re.search(r"constexpr int %s = (\d+);" % name,
                         text).group(1) == str(want), name
    assert (CK.DIMS, CK.WINDOW) == (C.DIMENSION, C.ADJUSTMENT_WINDOW)


def test_chip_smoke_names_the_coordinate_kernels():
    import chip_smoke

    pre = "_ZN49_GLOBAL__N__6a66586c_16_coord_kernels_cu_dafff9bf1"
    names = {pre + "1coord_probeE9ProbeArgs": "coord_probe",
             pre + "3coord_qualityE11QualityArgs": "coord_quality",
             pre + "3vivaldi_relaxE9RelaxArgs": "vivaldi_relax"}
    for symbol, label in names.items():
        assert chip_smoke.kernel_label(symbol) == label


@pytest.mark.parametrize("points", [0, 3])
def test_the_arguments_point_at_every_tensor(points):
    n = 256
    k = _case(n, CPU, points)
    c, topo = k["coords"], k["topo"]
    z = prng.normal(k["k_jit"], (n,))
    out = (torch.empty(n), torch.empty(c.error.shape, dtype=torch.bool),
           torch.empty(c.error.shape))
    a, ins = CK.probe_args(c, topo, k["pair_j"], z, out, k["q_in"],
                           k["lh"], k["deadline"])
    assert (a.pos, a.theight, a.sigma, a.pair_j, a.z, a.q_in, a.vec,
            a.height, a.adjustment, a.lh, a.rtt_obs, a.timely,
            a.late_in) == tuple(x.data_ptr() for x in (
                topo.pos, topo.height, topo.jitter_sigma, k["pair_j"], z,
                k["q_in"], c.vec, c.height, c.adjustment, k["lh"], *out))
    assert (a.n, a.points, a.topo_dims) == (n, max(points, 1), 4)
    if points:
        assert (a.mult_g, a.interval_g, a.timeout_g) == tuple(
            x.data_ptr() for x in k["deadline"])
        assert (a.mult, a.interval, a.timeout) == (0.0, 0.0, 0.0)
    else:
        assert (a.mult_g, a.interval_g, a.timeout_g) == (None,) * 3
        assert (a.mult, a.interval) == (3.0, 1.0)
        assert a.timeout == pytest.approx(0.01)
    assert len(ins) == 10 + (3 if points else 0)
    # without deadlines: the latency map, the pairs and the draw alone
    a, ins = CK.probe_args(None, topo, k["pair_j"], z, (out[0], None, None))
    assert (a.q_in, a.vec, a.lh, a.timely, a.late_in, a.points) == \
        (None, None, None, None, None, 1)
    assert len(ins) == 5
    u = prng.uniform(k["k_dir"], n * C.DIMENSION)
    rtt = torch.rand(n)
    new = C.CoordState(*(torch.empty_like(x) for x in c))
    relaxed = torch.empty(c.error.shape, dtype=torch.bool)
    moved = torch.empty(c.error.shape)
    a, ins = CK.relax_args(c, k["pair_j"], rtt, u, k["ack"], None, new,
                           relaxed, moved)
    assert (a.vec, a.error, a.height, a.samples, a.adj_idx) == tuple(
        x.data_ptr() for x in (c.vec, c.error, c.height, c.adj_samples,
                               c.adj_idx))
    assert (a.pair_j, a.rtt, a.u_dir, a.ack, a.up) == (
        k["pair_j"].data_ptr(), rtt.data_ptr(), u.data_ptr(),
        k["ack"].data_ptr(), None)
    assert (a.o_vec, a.o_error, a.o_height, a.o_adjustment, a.o_samples,
            a.o_adj_idx) == tuple(x.data_ptr() for x in new)
    assert (a.relaxed, a.moved, a.n, a.points) == (
        relaxed.data_ptr(), moved.data_ptr(), n, max(points, 1))
    rel = torch.empty(c.error.shape)
    a, ins = CK.quality_args(c, topo, k["pair_j"], rel)
    assert (a.pos, a.theight, a.pair_j, a.vec, a.height, a.adjustment,
            a.rel, a.n, a.points, a.topo_dims) == (
        topo.pos.data_ptr(), topo.height.data_ptr(), k["pair_j"].data_ptr(),
        c.vec.data_ptr(), c.height.data_ptr(), c.adjustment.data_ptr(),
        rel.data_ptr(), n, max(points, 1), 4)


def test_the_wrappers_refuse_cpu_tensors():
    k = _case(64, CPU)
    c, topo, j = k["coords"], k["topo"], k["pair_j"]
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        CK.probe(c, topo, j, torch.zeros(64))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        CK.relax(c, j, torch.ones(64), torch.zeros(64 * C.DIMENSION))
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        CK.quality(c, topo, j)
    assert not CK.LAUNCHES


class _Card:
    """The routing under a pretended card: ``coords`` takes every tensor
    for a card tensor, and each kernel wrapper records its call and
    answers with its plain version's results (the relaxation leaves the
    coordinates as they were)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(C, "_on_card", lambda x: True)
        monkeypatch.setattr(CK, "probe", self.probe)
        monkeypatch.setattr(CK, "relax", self.relax)
        monkeypatch.setattr(CK, "quality", self.quality)

    def probe(self, coords, topo, pair_j, z, q_in=None, lh=None,
              deadline=None):
        self.calls.append("coord_probe")
        assert pair_j.dtype == torch.int32 and z.shape == pair_j.shape
        return C.probe_plain(coords, topo, pair_j, z, q_in, lh, deadline)

    def relax(self, coords, pair_j, rtt, u_dir, ack=None, up=None):
        self.calls.append("vivaldi_relax")
        assert u_dir.shape == (pair_j.shape[-1] * C.DIMENSION,)
        relaxed = ack if up is None else ack & up[..., pair_j]
        return coords, relaxed, torch.zeros(coords.error.shape)

    def quality(self, coords, topo, pair_j):
        self.calls.append("coord_quality")
        return C.quality_plain(coords, topo, pair_j)


def _plain_calls(monkeypatch) -> list:
    """Wrap the plain versions so a test sees which of them ran."""
    calls = []
    for name in ("probe_plain", "relax_plain", "vivaldi_step_plain",
                 "quality_plain"):
        fn = getattr(C, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(C, name, wrapped)
    return calls


def _coords_run(rounds: int = 3, n: int = 256):
    su = scenarios.coords_setup(n, device=CPU)
    return tround.run_rounds_flight(
        init_state(n, device=CPU), prng.key(4), su.p, rounds, plan=su.cp,
        coords=C.init_coords(n, device=CPU), topo=su.topo)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = _plain_calls(monkeypatch)
    _coords_run(2)
    assert calls == ["probe_plain", "relax_plain", "vivaldi_step_plain",
                     "quality_plain"] * 2
    assert not CK.LAUNCHES


def test_card_tensors_take_the_kernels_in_every_per_period_caller(
        monkeypatch):
    card = _Card(monkeypatch)
    calls = _plain_calls(monkeypatch)
    n = 256
    # the live engine's coordinate branch with deadlines, recorded
    _coords_run(3, n)
    assert card.calls == ["coord_probe", "vivaldi_relax",
                          "coord_quality"] * 3
    # run_rounds_coords and gossip_round(coords=) without deadlines
    card.calls.clear()
    su = scenarios.coords_setup(n, device=CPU)
    p = dataclasses.replace(su.p, coords_timeout=False)
    c0 = C.init_coords(n, device=CPU)
    tround.run_rounds_coords(init_state(n, device=CPU), c0, su.topo, prng.key(5), p, 2)
    tround.gossip_round(init_state(n, device=CPU), prng.key(6), p, coords=c0,
                        topo=su.topo)
    assert card.calls == ["coord_probe", "vivaldi_relax",
                          "coord_quality"] * 2 + ["coord_probe",
                                                  "vivaldi_relax"]
    # the kernel runner's coordinate round
    card.calls.clear()
    up = torch.ones(n, dtype=torch.bool)
    sc = torch.tensor([float(n)] * 3 + [0.0, 1.0, 1.0, 0.0, 1e-9])
    cuda_round.coord_round(c0, su.topo, prng.key(7), up, sc)
    assert card.calls == ["coord_probe", "vivaldi_relax"]
    # a grid's round and vivaldi_step's full form
    card.calls.clear()
    tp, _ = grid_params(p, SweepAxes.of(gossip_nodes=(2.0, 3.0)), "cpu")
    run = sweep.make_run_sweep(p, 2, flight_every=1, coords=True,
                               topo=su.topo, device="cpu")
    run(tp, prng.key(8))
    assert card.calls == ["coord_probe", "vivaldi_relax",
                          "coord_quality"] * 2
    card.calls.clear()
    C.vivaldi_step(c0, None, torch.arange(n).roll(1), torch.ones(n),
                   prng.key(9))
    assert card.calls == ["vivaldi_relax"]
    # the scatter form stays plain wherever it runs
    card.calls.clear()
    C.vivaldi_step(c0, torch.tensor([0, 1]), torch.tensor([2, 3]),
                   torch.ones(2), prng.key(9))
    assert card.calls == []
    # no relaxation ran plain but the scatter form (the pretended
    # kernels answer with the plain probe and quality)
    assert [c for c in calls if c in ("relax_plain", "vivaldi_step_plain")
            ] == ["vivaldi_step_plain"]


@pytest.mark.parametrize("points", [0, 4])
def test_coord_bound_counts_each_launch_bytes(points):
    """Each input read once and each output written once: the probe's
    map row (4 dims) and height, pair, draw and round trip (32 B an
    agent), with deadlines the random prober and a point's estimate
    rows, local health, ``timely`` and ``late_in`` (4 + 49 B); the
    relaxation's pair and round trip (8 B) and a point's 124-byte rows
    both ways, its two gates, the adjustment, the gate out and the moved
    distance (259 B); the quality row's map row and pair (24 B) and a
    point's 40-byte estimate rows and error (44 B)."""
    n, g = 1 << 20, max(points, 1)
    b = costmodel.coord_bound(n, points=points, topo_dims=4,
                              deadlines=False)
    assert costmodel.COORD_ROW_BYTES == 124
    assert b["coord_probe"]["bytes"] == 32 * n
    assert b["vivaldi_relax"]["bytes"] == 8 * n + 259 * g * n
    assert b["coord_quality"]["bytes"] == 24 * n + 44 * g * n
    d = costmodel.coord_bound(n, points=points, topo_dims=4)
    assert d["coord_probe"]["bytes"] == 36 * n + 49 * g * n
    for k in CK.NAMES:
        assert d[k]["bound_by"] == "bytes"
        assert d[k]["bound_ms"] == pytest.approx(
            d[k]["bytes"] / costmodel.HBM_BYTES_PER_S * 1e3)


# ------------------------------------------------------------- the card


def _z(k, n):
    return prng.normal(k["k_jit"], (n,))


def probe_gaps(k, n: int, deadlines: bool) -> dict:
    """One ``coord_probe`` launch against ``probe_plain`` on the same
    inputs: ulps of the round trips and ``late_in``, whether ``timely``
    is equal, and how many deadlines bind."""
    z = _z(k, n)
    extra = (k["q_in"], k["lh"], k["deadline"]) if deadlines else ()
    got = CK.probe(k["coords"], k["topo"], k["pair_j"], z, *extra)
    want = C.probe_plain(k["coords"], k["topo"], k["pair_j"], z, *extra)
    out = {"rtt_obs": ulps(got[0], want[0])}
    if deadlines:
        out.update(late_in=ulps(got[2], want[2]),
                   timely_equal=bool(torch.equal(got[1], want[1])),
                   missed=int((~want[1]).sum()))
    return out


def relax_gaps(k, n: int, gate: bool) -> dict:
    """One ``vivaldi_relax`` launch against ``relax_plain`` on round
    trips with dead rows: ulps of each f32 field, of the moved distances
    and of the drift; whether the cursors and gates are equal; how many
    rows relaxed."""
    rtt = _rtt_with_dead_rows(C.probe_plain(None, k["topo"], k["pair_j"],
                                            _z(k, n))[0])
    c, up = k["coords"], k["up"] if gate else None
    u = prng.uniform(k["k_dir"], n * C.DIMENSION)
    got, relaxed, moved = CK.relax(c, k["pair_j"], rtt, u, k["ack"], up)
    want, w_relaxed, w_drift = C.relax_plain(c, k["pair_j"], rtt,
                                             k["k_dir"], k["ack"], up)
    d = want.vec - c.vec
    w_moved = torch.sqrt(torch.sum(d * d, dim=-1))
    out = {f: ulps(getattr(got, f), getattr(want, f))
           for f in ("vec", "error", "height", "adjustment", "adj_samples")}
    out.update(moved=ulps(moved, w_moved),
               drift=ulps(C._mean_moved(moved), w_drift),
               adj_idx_equal=bool(torch.equal(got.adj_idx, want.adj_idx)),
               relaxed_equal=bool(torch.equal(relaxed, w_relaxed)),
               updated=int((got.adj_idx != c.adj_idx).sum()))
    return out


def quality_gaps(k) -> dict:
    got = CK.quality(k["coords"], k["topo"], k["pair_j"])
    want = C.quality_plain(k["coords"], k["topo"], k["pair_j"])
    return {"rel": ulps(got, want)}


SIZES = [4096, 1 << 20]
#: the relaxation's f32 outputs
RELAX_F32 = ("vec", "error", "height", "adjustment", "adj_samples",
             "moved", "drift")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("points", [0, 3])
@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
@pytest.mark.parametrize("deadlines", [False, True],
                         ids=["no_deadlines", "deadlines"])
def test_the_probe_is_its_plain_version_on_the_card(cuda, n, points, cold,
                                                    deadlines):
    k = _case(n, cuda, points, cold)
    gaps = probe_gaps(k, n, deadlines)
    assert max(v for f, v in gaps.items() if f in ("rtt_obs", "late_in")) \
        <= ULPS, gaps
    if deadlines:
        # both sides of the deadline occur, and every decision agrees
        assert gaps["timely_equal"] and 0 < gaps["missed"] \
            < n * max(points, 1), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("points", [0, 3])
@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
@pytest.mark.parametrize("gate", [False, True], ids=["ack", "ack_up"])
def test_the_relaxation_is_its_plain_version_on_the_card(cuda, n, points,
                                                         cold, gate):
    k = _case(n, cuda, points, cold)
    gaps = relax_gaps(k, n, gate)
    assert gaps["adj_idx_equal"] and gaps["relaxed_equal"], gaps
    # some rows relax, some (upd false, dead round trips) keep theirs
    assert 0 < gaps["updated"] < n * max(points, 1), gaps
    assert max(gaps[f] for f in RELAX_F32) <= ULPS, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("points", [0, 3])
@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_the_quality_row_is_its_plain_version_on_the_card(cuda, n, points,
                                                          cold):
    gaps = quality_gaps(_case(n, cuda, points, cold))
    assert gaps["rel"] <= ULPS, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("topo_dims", [1, 2, 3, 5, 8])
def test_the_latency_map_takes_each_dimension_count(cuda, topo_dims):
    """The map's dimensions are a launch argument: at 1 to
    ``MAX_TOPO_DIMS`` the probe (with deadlines) and the quality row
    are their plain versions on the card."""
    n = 4096
    k = _case(n, cuda, topo_dims=topo_dims)
    gaps = {**probe_gaps(k, n, True), **quality_gaps(k)}
    assert gaps["timely_equal"], gaps
    assert max(gaps[f] for f in ("rtt_obs", "late_in", "rel")) <= ULPS, \
        gaps


def _coords_trial(dev, n: int, rounds: int):
    su = scenarios.coords_setup(n, device=dev)
    return tround.run_rounds_flight(
        init_state(n, device=dev), prng.key(4, device=dev), su.p, rounds,
        plan=su.cp, coords=C.init_coords(n, device=dev), topo=su.topo)


@pytest.mark.cuda
def test_a_coordinates_trial_on_the_kernels_is_the_plain_route(
        cuda, monkeypatch):
    """140 periods of the coordinates scenario at 4,096 agents, a flight
    row a period: one launch of each kernel a period, the coordinate
    columns within ``TRACE_ATOL`` of the plain route's on the card, the
    other columns and the final state equal."""
    n, rounds = 4096, 140
    CK.reset_launches()
    s1, c1, tr1 = _coords_trial(cuda, n, rounds)
    assert dict(CK.LAUNCHES) == {k: rounds for k in CK.NAMES}
    monkeypatch.setattr(C, "_on_card", lambda x: False)
    s2, c2, tr2 = _coords_trial(cuda, n, rounds)
    assert dict(CK.LAUNCHES) == {k: rounds for k in CK.NAMES}
    cols = [flight.COL[f] for f in flight.COORD_COLUMNS]
    rest = [i for i in range(flight.N_COLS) if i not in cols]
    assert float((tr1[:, cols] - tr2[:, cols]).abs().max()) <= TRACE_ATOL
    assert torch.equal(tr1[:, rest], tr2[:, rest])
    assert all(torch.equal(a, b)
               for a, b in zip(s1.node_arrays(), s2.node_arrays()))
    # the coordinates converge on the kernels (the scenario's bar)
    med = tr1[:, flight.COL["rtt_err_med"]]
    assert float(med[-1]) < float(med[0])


@pytest.mark.cuda
def test_the_kernel_runner_with_coordinates_captures(cuda):
    """``make_run_rounds_cuda(coords=True)``: a key's eager first call,
    its capture and a replay, each bit for bit the ``graphs.eager()``
    run, with a probe and a relaxation a round and a quality row a
    recorded round on every call."""
    from consul_tpu_torch.config import GossipConfig

    n, rounds, every = 4096, 24, 4
    p = SimParams.from_gossip_config(GossipConfig.lan(), n=n, loss=0.01,
                                     tcp_fallback=False)
    topo = T.make_topology(T.TopologyParams(n=n), cuda)
    run = cuda_round.make_run_rounds_cuda(p, rounds, coords=True,
                                          flight_every=every)

    def call():
        s, c, tr = run(init_state(n, device=cuda), prng.key(0, device=cuda),
                       coo=C.init_coords(n, device=cuda), topo=topo)
        torch.cuda.synchronize()
        return [*s.node_arrays(), *c, tr]

    with graphs.eager():
        want = call()
    want_launches = {"coord_probe": rounds, "vivaldi_relax": rounds,
                     "coord_quality": rounds // every}
    for _ in range(3):
        CK.reset_launches()
        got = call()
        assert dict(CK.LAUNCHES) == want_launches
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(run.graphs.stats()) == 1


#: a coordinate grid's points: deadline multipliers and probe timeouts
#: from binding on most probes to the LAN constants' (PERF.md section 7)
COORD_GRID = [{"coord_timeout_mult": 0.5, "probe_timeout": 1e-4},
              {"coord_timeout_mult": 1.0, "probe_timeout": 5e-4},
              {"coord_timeout_mult": 3.0, "probe_timeout": 0.5}]


def _coordinate_sweep(dev, n: int, rounds: int, every: int):
    """``make_run_sweep(coords=True)`` over ``COORD_GRID`` on the
    coordinates scenario's set-up (deadlines and the partition plan on):
    the runner and one call's (states, trace)."""
    su = scenarios.coords_setup(n, device=dev)
    tp, _ = grid_params(su.p, COORD_GRID, dev)
    run = sweep.make_run_sweep(su.p, rounds, flight_every=every,
                               plan=su.cp, coords=True, topo=su.topo,
                               device=dev)
    return run, lambda: run(tp, prng.key(11, device=dev))


@pytest.mark.cuda
def test_a_coordinate_sweep_on_the_kernels_is_its_plain_route(
        cuda, monkeypatch):
    """The sweep's ``[G, N]`` coordinate grid on the card's wrappers,
    with RTT-aware deadlines and the deadline multiplier and the probe
    timeout swept (``[G, 1]`` leaves read by pointer): one
    ``coord_probe`` and one ``vivaldi_relax`` a grid round and one
    ``coord_quality`` a recorded one, whatever the points, on the eager
    first call and on a replayed one; states and trace bit for bit the
    same grid on the plain route, whose points run apart."""
    n, rounds, every = 4096, 12, 4
    _, call = _coordinate_sweep(cuda, n, rounds, every)
    want_launches = {"coord_probe": rounds, "vivaldi_relax": rounds,
                     "coord_quality": rounds // every}
    got = []
    for _ in range(2):
        CK.reset_launches()
        got.append(call())
        torch.cuda.synchronize()
        assert dict(CK.LAUNCHES) == want_launches
    monkeypatch.setattr(C, "_on_card", lambda x: False)
    CK.reset_launches()
    _, plain = _coordinate_sweep(cuda, n, rounds, every)
    want = plain()
    assert not CK.LAUNCHES
    for states, trace in got:
        assert all(torch.equal(a, b) for a, b in zip(
            states.node_arrays(), want[0].node_arrays()))
        assert torch.equal(trace, want[1])
    assert not torch.equal(want[1][0], want[1][1])

