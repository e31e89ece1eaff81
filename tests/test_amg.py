"""AMG-preconditioned global step (core/amg.py).

The reference's global step is an EXACT prefactored LDLT solve
(/root/reference/deps/admm-elastic-sca/src/system/System.cpp:140,62).
Jacobi-PCG at a fixed budget drifts from that exact solve on unstructured
meshes (the residual floor scales with mesh diameter); the aggregation-AMG
V-cycle restores the match at the same matvec budget. These tests pin:
symmetry (valid CG preconditioner), convergence advantage, exact-solve
trajectory match at a small fixed budget, and weight-edit rebuilds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.core.amg import (
    build_amg,
    make_vcycle,
    pcg_solve_precond,
    rebuild_amg_values,
)
from admm_elastic_tpu.core.solver import (
    _assemble_A_hat_csr,
    assemble_A_hat_ell,
    ell_apply,
    pcg_solve,
)
from admm_elastic_tpu.models import (
    ExplicitForce,
    HyperElasticTet,
    StaticAnchor,
)


def _delaunay_scene(nx=12, ny=8, nz=7, **kw):
    """Jittered-grid Delaunay tets — genuinely unstructured topology."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    gx, gy, gz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    pts *= 0.05
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(
        pp[:, :, None, :] - pp[:, None, :, :], axis=-1
    ).max(axis=(1, 2))
    tets = tets[emax < 0.11]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    n = len(pts)

    s = System(Settings(
        timestep_s=0.04, admm_iters=8, verbose=0, dtype=jnp.float64,
        global_solver="ell", collect_residuals=True, **kw,
    ))
    s.add_nodes(pts, np.full(n, 50.0 / n))
    s.add_force(StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 0.025)
    ))
    s.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s, pts


def _a_hat_of(sys_):
    cparams = {
        k: {kk: np.asarray(jax.device_get(vv))
            for kk, vv in sys_.params[k].items()}
        for k in sys_._constraint_names
    }
    n = sys_.n_nodes
    A = _assemble_A_hat_csr(n, np.asarray(sys_._masses_dev),
                            sys_.settings.timestep_s, cparams)
    ei, ev, diag = assemble_A_hat_ell(
        n, np.asarray(sys_._masses_dev), sys_.settings.timestep_s, cparams
    )
    return A, jnp.asarray(ei), jnp.asarray(ev), jnp.asarray(diag)


def test_vcycle_symmetric_and_faster_than_jacobi():
    sys_, _ = _delaunay_scene(cg_fixed_iters=1)
    A, ei, ev, diag = _a_hat_of(sys_)
    arrays, meta = build_amg(A, coarse_max=256)
    levels = jax.tree_util.tree_map(jnp.asarray, list(arrays))
    vc = make_vcycle(meta)

    rng = np.random.default_rng(1)
    n = A.shape[0]
    r1 = jnp.asarray(rng.standard_normal((n, 3)))
    r2 = jnp.asarray(rng.standard_normal((n, 3)))
    m1, m2 = vc(levels, r1), vc(levels, r2)
    # <M r1, r2> == <r1, M r2>: the V-cycle is self-adjoint (valid CG
    # preconditioner) — symmetric smoothing + exact coarse solve
    a, b = float(jnp.vdot(m1, r2)), float(jnp.vdot(r1, m2))
    assert abs(a - b) <= 1e-9 * max(abs(a), 1.0)
    # SPD: <M r, r> > 0
    assert float(jnp.vdot(m1, r1)) > 0

    A_op = lambda y: ell_apply(y, ei, ev)
    b_rhs = jnp.asarray(rng.standard_normal((n, 3)))
    x0 = jnp.zeros((n, 3))
    xj, itj = pcg_solve(A_op, b_rhs, x0, diag, 1e-10, 4000)
    xa, ita = pcg_solve_precond(
        A_op, lambda r: vc(levels, r), b_rhs, x0, 1e-10, 4000
    )
    assert int(ita) < int(itj) / 2, (int(ita), int(itj))
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xj),
                               rtol=1e-6, atol=1e-9)


def test_amg_matches_exact_solve_trajectory():
    """cg_fixed_iters=8 with the AMG preconditioner tracks the
    exact-global-solve ADMM trajectory; Jacobi at the same budget does
    not (its residual drifts by mesh-diameter-scaled factors)."""
    exact, _ = _delaunay_scene(cg_tol=1e-13, cg_max_iters=4000)
    amg, _ = _delaunay_scene(cg_fixed_iters=8, preconditioner="amg")
    jac, _ = _delaunay_scene(cg_fixed_iters=8)
    worst_amg = 0.0
    worst_jac = 0.0
    for _ in range(4):
        exact.step()
        amg.step()
        jac.step()
        re = float(np.asarray(exact.last_aux["primal_residual"])[-1])
        ra = float(np.asarray(amg.last_aux["primal_residual"])[-1])
        rj = float(np.asarray(jac.last_aux["primal_residual"])[-1])
        worst_amg = max(worst_amg, ra / re)
        worst_jac = max(worst_jac, rj / re)
    assert worst_amg < 1.25, worst_amg
    assert worst_jac > 2.0, worst_jac  # same budget, unmatched
    np.testing.assert_allclose(
        np.asarray(amg.x), np.asarray(exact.x), rtol=0, atol=5e-5
    )


def test_amg_survives_weight_release():
    """poordillo-style release (weight -> 0 + recompute_weights) refreshes
    the hierarchy values over the frozen aggregation: same shapes (no
    retrace), finite stepping, and parity with a freshly-built system."""
    s, pts = _delaunay_scene(cg_fixed_iters=8, preconditioner="amg")
    anchor = s.forces[0]
    s.step()
    shapes_before = jax.tree_util.tree_map(
        lambda a: a.shape, s.params["_solver"]["amg"]
    )
    anchor.weight = 0.0
    s.params[anchor.name]["weight"] = jnp.zeros_like(
        s.params[anchor.name]["weight"]
    )
    s.recompute_weights()
    shapes_after = jax.tree_util.tree_map(
        lambda a: a.shape, s.params["_solver"]["amg"]
    )
    assert shapes_before == shapes_after
    for _ in range(3):
        s.step()
    x = np.asarray(s.x)
    assert np.isfinite(x).all()
    # released: the anchored face must start falling with the body
    assert x[:, 1].min() < pts[:, 1].min() - 1e-4


def test_amg_rebuild_values_matches_fresh_build():
    sys_, _ = _delaunay_scene(cg_fixed_iters=1)
    A, *_ = _a_hat_of(sys_)
    arrays, meta = build_amg(A, coarse_max=256)
    rebuilt = rebuild_amg_values(A, arrays, meta)
    for a, b in zip(arrays, rebuilt):
        for k in a:
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), rtol=1e-12, atol=0,
                err_msg=k,
            )


def test_amg_rejects_unsupported_modes():
    """The dense global step has no PCG to precondition."""
    s = System(Settings(global_solver="dense", preconditioner="amg",
                        verbose=0))
    s.add_nodes(np.zeros((9, 3)), np.ones(9))
    s.add_force(StaticAnchor([0]))
    with pytest.raises(ValueError, match="amg"):
        s.initialize()
