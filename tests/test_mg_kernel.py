"""Multigrid-preconditioned global solves on structured beams.

The reference solves the global step exactly (prefactored LDLT,
System.cpp:140). Jacobi-PCG needs ~100 iterations to match that at
100k-tet scale. The geometric hierarchy of core/mg.py (used by the sharded
steppers' solver='mg') is checked against its numpy V-cycle, and
preconditioner='amg' — the general path's aggregation AMG (core/amg.py),
on every mesh and in every sparse mode — matches the exact solve at 8
PCG iterations.
"""

import numpy as np

import jax
import jax.numpy as jnp

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import (
    ExplicitForce,
    HyperElasticTet,
    StaticAnchor,
)


def _beam_system(nx=10, ny=8, nz=7, **kw):
    beam = make_beam_tets(nx, ny, nz, size=0.05)
    n = beam.n_vertices
    kw.setdefault("collect_residuals", False)
    s = System(Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                        dtype=jnp.float64, **kw))
    s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def test_mg_planes_match_numpy_vcycle():
    """The host-built MG package is a symmetric SPD preconditioner whose
    numpy reference solves the real A_hat (the kernel runs this exact op
    sequence)."""
    from admm_elastic_tpu.core.mg import build_grid_mg, vcycle_np
    from admm_elastic_tpu.core.solver import _assemble_A_hat_csr

    s = _beam_system(global_solver="ell", cg_fixed_iters=1)
    n = s.n_nodes
    cparams = {
        k: {kk: np.asarray(jax.device_get(vv))
            for kk, vv in s.params[k].items()}
        for k in s._constraint_names
    }
    A = _assemble_A_hat_csr(n, np.asarray(s._masses_dev), 0.04,
                            cparams).tocsr()
    n_pad = -(-n // 1024) * 1024
    planes, meta = build_grid_mg(A, np.asarray(s._x), n_pad, min_nodes=0)

    Ac = A.tocoo()
    offs = np.unique(Ac.col - Ac.row)
    vals = np.zeros((len(offs), n_pad))
    didx = np.searchsorted(offs, Ac.col - Ac.row)
    np.add.at(vals, (didx, Ac.row), Ac.data)
    fine_offs = tuple(int(o) for o in offs)

    rng = np.random.default_rng(0)
    r1 = np.zeros(n_pad)
    r1[:n] = rng.standard_normal(n)
    r2 = np.zeros(n_pad)
    r2[:n] = rng.standard_normal(n)
    m1 = vcycle_np(planes, meta, fine_offs, vals, r1)
    m2 = vcycle_np(planes, meta, fine_offs, vals, r2)
    a, b = m1 @ r2, r1 @ m2
    assert abs(a - b) < 1e-9 * max(abs(a), 1.0)   # symmetric
    assert m1 @ r1 > 0                            # SPD

    # PCG with it reaches 1e-9 of spsolve in 25 iterations
    import scipy.sparse.linalg as spl

    from admm_elastic_tpu.core.mg import _shift_np

    x = np.zeros(n_pad)
    r = r1.copy()
    z = vcycle_np(planes, meta, fine_offs, vals, r)
    p = z
    rz = r @ z
    for _ in range(25):
        Ap = np.zeros(n_pad)
        for d, o in enumerate(fine_offs):
            Ap += vals[d] * _shift_np(p, o)
        al = rz / (p @ Ap)
        x += al * p
        r -= al * Ap
        z = vcycle_np(planes, meta, fine_offs, vals, r)
        rzn = r @ z
        p = z + (rzn / rz) * p
        rz = rzn
    xs = spl.spsolve(A.tocsc(), r1[:n])
    assert np.abs(x[:n] - xs).max() <= 1e-8 * np.abs(xs).max()


def _assert_general_amg(s):
    """'amg' always takes the general path, whatever the layout request."""
    assert s._lattice is None
    assert s._amg_meta is not None


def test_mg_kernel_matches_exact_solve():
    """dia + the AMG V-cycle at 8 fixed iterations tracks the
    exact-global-solve trajectory AND its per-iteration primal
    residuals; plain Jacobi at the same budget (banded layout) does
    not."""
    mg = _beam_system(global_solver="dia", lattice_fast_path=True,
                      preconditioner="amg", cg_fixed_iters=8,
                      collect_residuals="primal")
    _assert_general_amg(mg)
    assert mg._solver_mode == "dia"
    jac = _beam_system(global_solver="dia", lattice_fast_path=True,
                       cg_fixed_iters=8, collect_residuals="primal")
    assert jac._lattice is not None
    exact = _beam_system(global_solver="ell", cg_tol=1e-13,
                         cg_max_iters=4000, collect_residuals=True)
    worst_mg = worst_jac = 0.0
    for _ in range(4):
        mg.step()
        jac.step()
        exact.step()
        re = float(np.asarray(exact.last_aux["primal_residual"])[-1])
        rm = float(np.asarray(mg.last_aux["primal_residual"])[-1])
        rj = float(np.asarray(jac.last_aux["primal_residual"])[-1])
        worst_mg = max(worst_mg, rm / re)
        worst_jac = max(worst_jac, rj / re)
        dx = np.abs(np.asarray(mg.x) - np.asarray(exact.x)).max()
        assert dx < 1e-5, dx
    assert worst_mg < 1.05, worst_mg
    assert worst_jac > 1.5, worst_jac


def test_mg_kernel_rollout_matches_stepping():
    a = _beam_system(global_solver="dia", preconditioner="amg",
                     cg_fixed_iters=8)
    b = _beam_system(global_solver="dia", preconditioner="amg",
                     cg_fixed_iters=8)
    _assert_general_amg(a)
    a.run(12)
    for _ in range(12):
        b.step()
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x),
                               rtol=0, atol=1e-12)


def _delaunay_scene(**kw):
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (300, 3))
    tets = Delaunay(pts).simplices
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    s = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                        dtype=jnp.float64,
                        lattice_fast_path=True, preconditioner="amg",
                        reorder="none", cg_fixed_iters=8, **kw))
    s.add_nodes(pts, np.full(len(pts), 1.0 / len(pts)))
    s.add_force(StaticAnchor([0, 1]))
    s.add_force(HyperElasticTet(tets, mu=1e4, lam=1e4, max_iters=3,
                                model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def test_mg_non_grid_routes_to_in_kernel_algebraic_mg():
    """A non-grid scene with dia+amg never runs silently unmatched: the
    dia solver rejects the unstructured numbering, the mode falls back
    to ell, and the general AMG engages."""
    s = _delaunay_scene(global_solver="dia")
    assert s._solver_mode == "ell"
    _assert_general_amg(s)
    s.step()
    assert np.isfinite(np.asarray(s.x)).all()


def test_mg_dia_amg_survives_weight_release():
    """dia + AMG: a runtime anchor release (weight -> 0 +
    recompute_weights) re-assembles the diagonals and refreshes the
    hierarchy values with unchanged shapes; the body then falls."""
    s = _beam_system(nx=6, ny=4, nz=4, global_solver="dia",
                     preconditioner="amg", cg_fixed_iters=8)
    _assert_general_amg(s)
    s.step()
    shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                    s.params["_solver"]["amg"])
    anchor = s.forces[0]
    s.set_force_param(anchor, "weight",
                      np.zeros_like(np.asarray(s.params[anchor.name]
                                               ["weight"])))
    s.recompute_weights()
    assert jax.tree_util.tree_map(lambda a: a.shape,
                                  s.params["_solver"]["amg"]) == shapes
    y0 = s.x[:, 1].min()
    for _ in range(3):
        s.step()
    assert np.isfinite(s.x).all()
    assert s.x[:, 1].min() < y0 - 1e-4


def test_mg_grid_mesh_ell_routes_to_uamg():
    """A grid mesh forced into ell mode with lattice_fast_path + amg
    takes the general AMG (never the Jacobi-only layout budget)."""
    s = _beam_system(global_solver="ell", lattice_fast_path=True,
                     preconditioner="amg", cg_fixed_iters=8)
    assert s._solver_mode == "ell"
    _assert_general_amg(s)


def test_mg_kernel_with_floor_collision():
    """The V-cycle composes with the collision projection (plinko-class
    scenes stay matched)."""
    from admm_elastic_tpu.models import Collision, Floor

    def build(**kw):
        beam = make_beam_tets(8, 6, 5, size=0.05)
        n = beam.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                            dtype=jnp.float64, **kw))
        # drop the beam onto a floor (no anchors)
        s.add_nodes(beam.vertices + np.array([0, 0.08, 0]),
                    np.full(n, 50.0 / n))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                    max_iters=5, model="nh"))
        s.add_force(Collision([Floor(center=(0.0, 0.0, 0.0))], n))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    mg = build(global_solver="dia", lattice_fast_path=True,
               preconditioner="amg", cg_fixed_iters=8)
    _assert_general_amg(mg)
    exact = build(global_solver="ell", cg_tol=1e-13, cg_max_iters=4000)
    for _ in range(6):
        mg.step()
        exact.step()
    dx = np.abs(np.asarray(mg.x) - np.asarray(exact.x)).max()
    assert dx < 5e-5, dx
    # the floor held
    assert np.asarray(mg.x)[:, 1].min() > -1e-6
