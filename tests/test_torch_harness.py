"""Shared harness for the consul_tpu_torch tests, plus the port's rules.

``load_reference()`` imports the JAX package's simulation, which does
not import as shipped on jax 0.9: ``consul_tpu/sim/lanes.py`` tests
``prim in batching.primitive_batchers``, and on jax 0.9 that object is a
proxy without ``__contains__``. The shim below gives the proxy a
``__contains__`` that answers False (lanes.py then registers its batching
rule as it did on older jax). It is applied only when a test asks for
the reference — inside a fixture, never at import — so collecting the
JAX package's own test files is unchanged. The fixture is per test
module and takes the shim away at the module's end, with every
``consul_tpu`` module it let import, so the JAX tests that run later in
the same worker meet the package exactly as shipped.

The ``cuda`` fixture decides whether a card is present inside the test,
so every pytest-xdist worker collects the same tests; ``cuda``-marked
tests skip on a host without one.

Every port test module imports this one, which pins PyTorch's CPU ops
to one thread: under pytest-xdist several workers share the host's
cores, and OpenMP thread pools that each spin on every core slow the
port's tests by orders of magnitude.

``run_world`` starts a gloo world of CPU ranks through the port's
launcher (``consul_tpu_torch.sim.mesh.launch``) with a per-test join
timeout, so a hung rank fails its test instead of eating the suite's
time limit. Each rank runs with one CPU thread.
"""

from __future__ import annotations

import ast
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

#: seconds a test's gloo world may take, rank start-up included
WORLD_TIMEOUT_S = 240.0


def run_world(world: int, fn, *args, dc: int = 1,
              timeout: float = WORLD_TIMEOUT_S) -> list:
    """``fn(mesh, *args)`` on ``world`` gloo ranks on the CPU (``fn`` a
    module-level function); the ranks' results in rank order, tensors as
    numpy arrays. A rank that fails or hangs fails the test."""
    from consul_tpu_torch.sim.mesh import launch

    return launch(world, fn, backend="gloo", device="cpu", dc=dc,
                  args=args, timeout=timeout)


def load_reference():
    """The JAX package's ``consul_tpu.sim`` (with the jax-0.9 shim).

    Returns ``(sim, restore)``: ``restore()`` takes the shim away and
    forgets every ``consul_tpu`` module imported since, so the JAX
    package's own tests that run later in the same process import it
    exactly as they would have without this harness."""
    from jax.interpreters import batching

    before = set(sys.modules)
    proxy = type(batching.primitive_batchers)
    shimmed = not hasattr(proxy, "__contains__")
    if shimmed:
        proxy.__contains__ = lambda self, prim: False
    import consul_tpu.sim as ref_sim

    def restore():
        if shimmed:
            del proxy.__contains__
        new = [m for m in set(sys.modules) - before
               if m == "consul_tpu" or m.startswith("consul_tpu.")]
        for name in new:
            mod = sys.modules.pop(name)
            parent, _, child = name.rpartition(".")
            if getattr(sys.modules.get(parent), child, None) is mod:
                delattr(sys.modules[parent], child)

    return ref_sim, restore


@pytest.fixture(scope="module")
def ref():
    sim, restore = load_reference()
    yield sim
    restore()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def _reference_modules():
    return {m for m in sys.modules if m.startswith("consul_tpu.")}


def test_load_reference_imports_reference_sim():
    before = _reference_modules()
    sim, restore = load_reference()
    from consul_tpu.sim import round as ref_round

    assert hasattr(sim, "init_state")
    assert hasattr(ref_round, "_round_core")
    restore()
    assert _reference_modules() == before
    # a second load and restore leaves the same state again
    sim, restore = load_reference()
    restore()
    assert _reference_modules() == before


# ------------------------------------------------------- import rule

def _port_sources():
    files = sorted((ROOT / "consul_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    assert {"lanes.py", "sweep.py", "costmodel.py", "autotune.py",
            "mesh.py", "views.py", "graft_entry.py", "twin.py", "cli.py",
            "telemetry.py"} <= \
        {f.name for f in files}
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "consul_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_default_device_refuses_cpu_fallback(monkeypatch):
    from consul_tpu_torch.sim import state as st
    from consul_tpu_torch.utils import platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(platform.NoCudaDeviceError):
        platform.default_device()
    with pytest.raises(platform.NoCudaDeviceError):
        st.init_state(16)
    assert platform.default_device("cpu").type == "cpu"
    assert st.init_state(16, device="cpu").status.device.type == "cpu"
