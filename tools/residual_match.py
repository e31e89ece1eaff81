"""Matched-residual evidence for the fixed-iteration CG global step.

Runs the same NH beam twice in float64 — once with an effectively exact
global solve (tolerance CG, 1e-13) and once with the benchmark's fixed
iteration count — and prints the per-step final ADMM primal residual ratio.
A ratio ~1.0 shows the fixed-CG benchmark configuration converges the ADMM
iteration to the same residual as an exact LDLT-style solve.

Usage: PYTHONPATH=. JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \
       python tools/residual_match.py [fixed_iters] [steps]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax.numpy as jnp

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor


def build(**kw):
    beam = make_beam_tets(14, 10, 9, size=0.05)
    kw.setdefault("collect_residuals", True)
    s = System(
        Settings(timestep_s=0.04, admm_iters=10, verbose=0, dtype=jnp.float64,
                 **kw)
    )
    n = beam.n_vertices
    s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5, model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def build_delaunay(nx=16, ny=11, nz=10, **kw):
    """Unstructured variant: jittered-grid Delaunay tets (the workload
    class where Jacobi-PCG's fixed budget drifts — its residual floor
    scales with mesh diameter; run with --amg to see the AMG-PCG
    preconditioner restore the match at cg_fixed_iters=8)."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    pts *= 0.05
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(pp[:, :, None, :] - pp[:, None, :, :],
                          axis=-1).max(axis=(1, 2))
    tets = tets[emax < 0.11]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    n = len(pts)
    kw.setdefault("collect_residuals", True)
    s = System(
        Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                 dtype=jnp.float64, **kw)
    )
    s.add_nodes(pts, np.full(n, 50.0 / n))
    s.add_force(StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 0.025)))
    s.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    return s


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    delaunay = "--delaunay" in sys.argv
    amg = "--amg" in sys.argv
    fixed_iters = int(args[0]) if args else (8 if amg else 25)
    steps = int(args[1]) if len(args) > 1 else 5
    mk = build_delaunay if delaunay else build
    exact = mk(global_solver="ell", cg_tol=1e-13, cg_max_iters=3000)
    fixed = mk(global_solver="ell", cg_fixed_iters=fixed_iters,
               preconditioner="amg" if amg else "jacobi")
    worst = 0.0
    for step in range(steps):
        exact.step()
        fixed.step()
        re = float(np.asarray(exact.last_aux["primal_residual"])[-1])
        rf = float(np.asarray(fixed.last_aux["primal_residual"])[-1])
        ratio = rf / re
        worst = max(worst, ratio)
        print(f"step {step}: exact={re:.4e} fixed{fixed_iters}={rf:.4e} "
              f"ratio={ratio:.3f}")
    print(f"worst ratio: {worst:.3f}")
    assert worst < 1.25, "fixed-CG residuals drifted from the exact solve"


if __name__ == "__main__":
    main()
