"""Test harness setup.

Tests run on the CPU in float64 (jax_enable_x64) on 8 virtual CPU devices,
so sharded paths are testable without accelerators. Tests marked `gpu`
need a GPU: `python -m pytest tests -m gpu` runs them there (chip_smoke.py
does), and JAX then keeps its default platform and float32.
"""

import contextlib
import functools
import os

import pytest

# 8 virtual devices time-share the host's few physical cores, so device
# threads reach a collective minutes apart on big programs (e.g. the
# 50k-tet spmd test). XLA CPU's rendezvous ABORTS the process after a
# hard 40 s termination timeout (rendezvous.cc) — raise both the warn
# and terminate timeouts well past worst-case stagger.
_COLLECTIVE_TIMEOUT_FLAGS = (
    " --xla_cpu_collective_timeout_seconds=1200"
    " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
)


def _use_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if "xla_cpu_collective" not in flags:
        flags += _COLLECTIVE_TIMEOUT_FLAGS
    os.environ["XLA_FLAGS"] = flags.strip()

    import jax

    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # test tiering (timings on a 4-core host with 8 virtual devices):
    #   make test          everything incl. slow           (~45 min)
    #   make test-default  -m "not slow"                   (~30 min)
    #   make test-smoke    core solver/parity/scene/live   (~5 min)
    # 'slow' marks the interpret-mode-at-scale runs (50k-tet SPMD
    # parity, >60 s singles).
    config.addinivalue_line(
        "markers",
        "slow: interpret-mode-at-scale tests; deselect with -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skipped elsewhere, run with -m gpu on the card",
    )
    if config.getoption("markexpr", "") != "gpu":
        _use_cpu()


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (python -m pytest tests -m gpu on the card)")


@pytest.fixture
def nh_kernel(monkeypatch):
    """Context manager routing HyperElasticTet through its Pallas kernel,
    in interpret mode (the route a GPU takes, executable on the CPU)."""
    from admm_elastic_tpu.models.tet import HyperElasticTet
    from admm_elastic_tpu.ops.pallas import nh_local

    @contextlib.contextmanager
    def use():
        with monkeypatch.context() as m:
            m.setattr(HyperElasticTet, "uses_kernel",
                      staticmethod(lambda: True))
            for name in ("nh_local_step", "nh_local_step_fused"):
                m.setattr(nh_local, name, functools.partial(
                    getattr(nh_local, name), interpret=True))
            yield

    return use


@pytest.fixture
def tri_lanes(monkeypatch):
    """Callable routing LimitedTriangleStrain.project through
    ops/lanes.tri_body, the grid-cloth layout's own projection, for the
    rest of the test: general-path references then share the layout's
    arithmetic and agree with it to round-off."""
    import jax.numpy as jnp

    from admm_elastic_tpu.models.triangle import LimitedTriangleStrain
    from admm_elastic_tpu.ops.lanes import tri_body

    def project(self, Dx, u, params, state):
        F = jnp.swapaxes(Dx + u, 1, 2)  # (E, 3, 2)
        z = tri_body([F[:, a, b] for a in range(3) for b in range(2)],
                     params["weight"] ** 2, params["k"],
                     params["limit_min"], params["limit_max"],
                     self.strain_limiting)
        zF = jnp.stack(z, axis=1).reshape(-1, 3, 2)
        return jnp.swapaxes(zF, 1, 2), state

    def use():
        monkeypatch.setattr(LimitedTriangleStrain, "project", project)

    return use
