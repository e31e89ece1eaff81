"""Trajectory parity: the JAX framework vs a direct numpy transcription of
the reference algorithm (tests/reference_impl.py) in float64.

These tests pin down exact algorithmic equivalence for the analytic-prox
constraint types (spring, anchor, linear tet, triangle strain, bend): same
D/W assembly, same local projections, same global solve, same dual
warm-starting — so trajectories must match to solver tolerance.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import extract_hinges, make_sym_plane
from admm_elastic_tpu.models import (
    Bend,
    ExplicitForce,
    LimitedTriangleStrain,
    LinearTetStrain,
    Spring,
    StaticAnchor,
)

from reference_impl import (
    RefAnchor,
    RefBend,
    RefLinearTetStrain,
    RefSpring,
    RefSystem,
    RefTriangleStrain,
    RefWind,
)


def _sys(dt, iters, mode="dense"):
    return System(
        Settings(
            timestep_s=dt,
            admm_iters=iters,
            verbose=0,
            dtype=jnp.float64,
            global_solver=mode,
            cg_tol=1e-13,
            cg_max_iters=2000,
        )
    )


def test_singletet_parity():
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    stretched = x.copy()
    stretched[3, 0] = 200.0

    ref = RefSystem(dt=1.0, iters=20)
    ref.setup(x, np.ones(4))
    ref.forces += [RefAnchor(0), RefAnchor(1), RefAnchor(2),
                   RefLinearTetStrain([0, 1, 2, 3], 1.0)]
    ref.initialize()
    ref.x = stretched.reshape(-1).copy()

    sys = _sys(1.0, 20)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=1.0))
    assert sys.initialize()
    sys.x = stretched

    for _ in range(4):
        ref.step()
        sys.step()
        np.testing.assert_allclose(sys.x.reshape(-1), ref.x, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("mode", ["dense", "cg"])
def test_spring_chain_parity(mode):
    n = 5
    x = np.stack([np.linspace(0, 1, n), np.zeros(n), np.zeros(n)], axis=1)
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)

    ref = RefSystem(dt=0.02, iters=12)
    ref.setup(x, np.full(n, 0.1))
    ref.forces.append(RefAnchor(0))
    for e in edges:
        ref.forces.append(RefSpring(int(e[0]), int(e[1]), 500.0))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])

    sys = _sys(0.02, 12, mode)
    sys.add_nodes(x, np.full(n, 0.1))
    sys.add_force(StaticAnchor([0]))
    sys.add_force(Spring(edges, stiffness=500.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()

    for _ in range(8):
        ref.step()
        sys.step()
        np.testing.assert_allclose(sys.x.reshape(-1), ref.x, rtol=1e-8, atol=1e-9)


def test_cloth_parity():
    """Plane cloth with triangle strain + bend + anchors + gravity: full
    windyflag physics minus wind, vs the numpy oracle."""
    mesh = make_sym_plane(3, 2)
    n = mesh.n_vertices
    masses = np.full(n, 0.5 / n)
    hinges = extract_hinges(mesh.faces)

    ref = RefSystem(dt=0.04, iters=15)
    ref.setup(mesh.vertices, masses)
    ref.forces.append(RefAnchor(0))
    ref.forces.append(RefAnchor(2))
    for f in mesh.faces:
        ref.forces.append(
            RefTriangleStrain([int(f[0]), int(f[1]), int(f[2])], 100.0, 0.95, 1.05)
        )
    for h in hinges:
        ref.forces.append(RefBend([int(v) for v in h], 20.0))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])

    sys = _sys(0.04, 15)
    sys.add_nodes(mesh.vertices, masses)
    sys.add_force(StaticAnchor([0, 2]))
    sys.add_force(
        LimitedTriangleStrain(mesh.faces, stiffness=100.0, limit_min=0.95,
                              limit_max=1.05)
    )
    sys.add_force(Bend(hinges, stiffness=20.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()

    for step in range(6):
        ref.step()
        sys.step()
        np.testing.assert_allclose(
            sys.x.reshape(-1), ref.x, rtol=1e-7, atol=1e-8,
            err_msg=f"divergence at step {step}",
        )


def test_windyflag_full_parity():
    """The complete windyflag physics (strain+limit, bend, pins, gravity,
    Wejchert-Haumann wind) vs the numpy oracle."""
    from admm_elastic_tpu.models import WindForce

    mesh = make_sym_plane(3, 3)
    n = mesh.n_vertices
    masses = np.full(n, 0.5 / n)
    hinges = extract_hinges(mesh.faces)
    wind_dir = np.array([2.0, 0.0, 0.5])

    ref = RefSystem(dt=0.04, iters=10)
    ref.setup(mesh.vertices, masses)
    ref.forces.append(RefAnchor(0))
    ref.forces.append(RefAnchor(3))
    for f in mesh.faces:
        ref.forces.append(
            RefTriangleStrain([int(v) for v in f], 100.0, 0.95, 1.05)
        )
    for h in hinges:
        ref.forces.append(RefBend([int(v) for v in h], 20.0))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])
    ref.wind = RefWind(mesh.faces, wind_dir)

    sys = _sys(0.04, 10)
    sys.add_nodes(mesh.vertices, masses)
    sys.add_force(StaticAnchor([0, 3]))
    sys.add_force(
        LimitedTriangleStrain(mesh.faces, stiffness=100.0, limit_min=0.95,
                              limit_max=1.05)
    )
    sys.add_force(Bend(hinges, stiffness=20.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    sys.add_explicit_force(WindForce(mesh.faces, direction=wind_dir))
    assert sys.initialize()

    for step in range(6):
        ref.step()
        sys.step()
        np.testing.assert_allclose(
            sys.x.reshape(-1), ref.x, rtol=1e-7, atol=1e-8,
            err_msg=f"divergence at step {step}",
        )


def test_collision_parity():
    """Tet body dropping onto a floor + cylinder (plinkopony physics) vs the
    numpy oracle: identity-selector collision force inside ADMM."""
    from admm_elastic_tpu.models import Collision, Cylinder, Floor, Sphere
    from reference_impl import RefCollision

    x = np.array(
        [[0, 1.2, 0], [0.4, 1.2, 0], [0, 1.6, 0], [0, 1.2, 0.4], [0.6, 1.7, 0.2]],
        dtype=float,
    )
    tets = np.array([[0, 1, 2, 3], [4, 1, 2, 3]], dtype=np.int32)
    n = len(x)
    shapes_ours = [Floor(center=(0, 0.0, 0)), Cylinder(center=(0.2, 0.6, 0), radius=0.3),
                   Sphere(center=(-0.3, 0.5, 0.1), radius=0.25)]
    shapes_ref = [("floor", 0.0), ("cylinder", (0.2, 0.6), 0.3),
                  ("sphere", (-0.3, 0.5, 0.1), 0.25)]

    ref = RefSystem(dt=0.04, iters=13)
    ref.setup(x, np.ones(n))
    for t in tets:
        ref.forces.append(RefLinearTetStrain([int(v) for v in t], 1e4))
    ref.forces.append(RefCollision(n, shapes_ref))
    ref.initialize()
    ref.gravity = np.array([0.0, -9.8, 0.0])

    sys = _sys(0.04, 13)
    sys.add_nodes(x, np.ones(n))
    sys.add_force(LinearTetStrain(tets, stiffness=1e4))
    sys.add_force(Collision(shapes_ours, n_nodes=n))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()

    for step in range(12):
        ref.step()
        sys.step()
        np.testing.assert_allclose(
            sys.x.reshape(-1), ref.x, rtol=1e-6, atol=1e-7,
            err_msg=f"divergence at step {step}",
        )
