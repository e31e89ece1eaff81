"""Chebyshev budget study: which cheb_iters is exact-solve-MATCHED?

Method (same as the round-4 CG budget study, docs/PERFORMANCE.md
"Matched-residual solves"): run the 100k-tet NH workload in f64 on the
sharded banded stepper (D=1 — the decomposition whose budget we are
calibrating), collecting per-iteration primal residuals; compare each
candidate's per-step FINAL primal residual against a near-exact
reference solve (deep CG). Matched = worst per-step ratio <= ~1.05.

    env PYTHONPATH=... JAX_PLATFORMS=cpu \
        JAX_ENABLE_X64=1 python -u tools/cheb_budget.py \
        [--steps 6] [--cand 90,120,150] [--scale 100k|small]
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def build(scale, cg_iters, solver="cg", cheb_iters=None, mg_cycles=10):
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.parallel.banded_spmd import ShardedBandedStepper

    if scale == "cloth":
        # the 225x225 cloth100k workload — calibrates the cloth-cheb
        # budget against its diameter-bound matched CG (~300)
        from admm_elastic_tpu.parallel.cloth_spmd import (
            ShardedClothStepper)
        from bench import build_cloth100k

        sys_, _ = build_cloth100k(jnp.float64, cg_iters=cg_iters,
                                  residuals="primal", fast_path=True)
        return ShardedClothStepper(
            sys_._lattice.base, jax.make_mesh((1,), ("elem",)),
            solver=solver, cheb_iters=cheb_iters,
            mg_cycles=mg_cycles, system=sys_)
    if scale == "delaunay":
        # arbitrary topology (uell matvec) — calibrates the round-5
        # uell-cheb budget on the full 101k-tet Delaunay workload
        from bench import build_delaunay100k

        sys_, _ = build_delaunay100k(jnp.float64, cg_iters=cg_iters,
                                     residuals="primal", fast_path=True)
    elif scale == "100k":
        from bench import build_tet100k

        sys_, _ = build_tet100k(jnp.float64, lattice=True,
                                cg_iters=cg_iters, residuals="primal")
    else:
        from admm_elastic_tpu import Settings, System
        from admm_elastic_tpu.geometry import make_beam_tets
        from admm_elastic_tpu.models import (
            ExplicitForce, HyperElasticTet, StaticAnchor)

        beam = make_beam_tets(12, 9, 8)
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=jnp.float64, global_solver="dia",
                            cg_fixed_iters=cg_iters,
                            collect_residuals="primal",
                            lattice_fast_path=True))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(
            np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                    max_iters=5, model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        sys_ = s
    return ShardedBandedStepper(
        sys_._lattice.base, jax.make_mesh((1,), ("elem",)),
        solver=solver, cheb_iters=cheb_iters, mg_cycles=mg_cycles,
        system=sys_)


def residual_trajectory(stepper, steps):
    out = []
    for _ in range(steps):
        stepper.step()
        out.append(float(np.asarray(stepper.last_primal)[-1]))
    return np.array(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--cand", default="90,120,150")
    ap.add_argument("--scale", default="100k",
                    choices=["100k", "small", "delaunay", "cloth"])
    ap.add_argument("--exact-cg", type=int, default=300)
    ap.add_argument("--solver", default="cheb", choices=["cheb", "mg"])
    args = ap.parse_args()

    exact = build(args.scale, args.exact_cg)
    r_exact = residual_trajectory(exact, args.steps)
    print(f"# exact (cg{args.exact_cg}): {r_exact}", flush=True)

    rows = []
    for k in [int(x) for x in args.cand.split(",")]:
        if args.solver == "mg":
            st = build(args.scale, 25, solver="mg", mg_cycles=k)
            extra = {"mg_rho": st.mg_rho, "levels": st.mg_levels}
            key = "mg_cycles"
        else:
            st = build(args.scale, 25, solver="cheb", cheb_iters=k)
            extra = {"bounds": [float(b) for b in st.cheb_bounds]}
            key = "cheb_iters"
        r = residual_trajectory(st, args.steps)
        ratio = r / r_exact
        rows.append({key: k, "worst_ratio": float(ratio.max()),
                     "ratios": [round(float(q), 4) for q in ratio],
                     **extra})
        print(json.dumps(rows[-1]), flush=True)


if __name__ == "__main__":
    main()
