"""Checkpoint round-trip and rollout equivalence."""

import jax.numpy as jnp
import numpy as np

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.models import ExplicitForce, LinearTetStrain, StaticAnchor
from admm_elastic_tpu.utils import load_state, save_state


def _build():
    sys = System(
        Settings(timestep_s=0.04, admm_iters=8, verbose=0, dtype=jnp.float64)
    )
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=120.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    return sys


def test_checkpoint_roundtrip_resumes_exactly(tmp_path):
    a = _build()
    for _ in range(5):
        a.step()
    ckpt = str(tmp_path / "state.npz")
    save_state(ckpt, a.state)
    for _ in range(5):
        a.step()

    b = _build()
    b.state = load_state(ckpt, dtype=jnp.float64, like=b.state)
    for _ in range(5):
        b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=1e-13, atol=1e-14)
    # duals must round-trip too (warm start affects convergence)
    for k in a.state["u"]:
        np.testing.assert_allclose(
            np.asarray(b.state["u"][k]), np.asarray(a.state["u"][k]), atol=1e-14
        )


def _build_banded(fast):
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import HyperElasticTet

    rng = np.random.RandomState(2)
    mesh = make_beam_tets(4, 3, 3, size=0.25)
    mesh.vertices = mesh.vertices + 0.02 * rng.randn(*mesh.vertices.shape)
    n = mesh.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                        dtype=jnp.float64, lattice_fast_path=fast,
                        global_solver="dia", dense_max_nodes=0))
    s.add_nodes(mesh.vertices, np.full(n, 2.0 / n))
    s.add_force(HyperElasticTet(mesh.tets, mu=1e4, lam=2.5e4,
                                max_iters=4))
    s.add_force(StaticAnchor([0, 1]))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def test_checkpoint_fast_path_resumes_exactly(tmp_path):
    """System.save/load_checkpoint round-trips the whole-timestep fast
    path's LIVE state (packed planes incl. duals and warm starts — the
    general `system.state` is stale when a stepper is engaged)."""
    a = _build_banded(True)
    assert a._lattice is not None
    for _ in range(4):
        a.step()
    ckpt = str(tmp_path / "fast.npz")
    a.save_checkpoint(ckpt)
    for _ in range(4):
        a.step()

    b = _build_banded(True)
    b.load_checkpoint(ckpt)
    assert b.elapsed_s == 4 * 0.04
    for _ in range(4):
        b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=0)  # bitwise

    # mixed-path loads are refused, not silently wrong
    import pytest

    gen = _build_banded(False)
    with pytest.raises(ValueError):
        gen.load_checkpoint(ckpt)
    gck = str(tmp_path / "gen.npz")
    gen.save_checkpoint(gck)
    with pytest.raises(ValueError):
        b.load_checkpoint(gck)


def test_checkpoint_general_path_via_system_api(tmp_path):
    a = _build()
    for _ in range(3):
        a.step()
    ckpt = str(tmp_path / "g.npz")
    a.save_checkpoint(ckpt)
    b = _build()
    b.load_checkpoint(ckpt)
    assert abs(b.elapsed_s - 3 * 0.04) < 1e-12
    for _ in range(3):
        a.step()
        b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=1e-13, atol=1e-14)


def test_rollout_matches_stepping():
    a = _build()
    for _ in range(6):
        a.step()
    b = _build()
    b.run(6)
    np.testing.assert_allclose(b.x, a.x, rtol=1e-13, atol=1e-14)
