"""Wall-clock of the SHARDED steppers on one device (D=1).

The per-device cost of the distributable program IS the D=1 number
(collectives at D=1 compile away; on several devices the adds are the
measured O(band) halo bytes). Run on a GPU:
    python -u tools/bench_sharded_chip.py \
        [--family banded|cloth|delaunay|both] [--steps 10] \
        [--scale 100k|small]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402

dev = jax.devices()[0]


def _time_stepper(stepper, steps, windows=4, scan_steps=None):
    """(median, min, max) ms/step over timing windows of `steps` steps."""
    import jax

    run = stepper.run
    if scan_steps:
        run = lambda n: stepper.run_scan(n)  # noqa: E731

    def sync():
        x = stepper.state["x"]
        jax.block_until_ready(x)
        np.asarray(jax.tree_util.tree_leaves(x)[0]).ravel()[:1]

    run(2)
    sync()
    reps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        run(steps)
        sync()
        reps.append((time.perf_counter() - t0) / steps * 1e3)
    assert np.isfinite(np.asarray(stepper.x)).all(), "diverged"
    return float(np.median(reps)), float(min(reps)), float(max(reps))


def bench_banded(steps, scale, cg_iters=None, window=0, solver="cg",
                 cheb_iters=None):
    import jax
    import jax.numpy as jnp

    from bench import build_tet100k
    from admm_elastic_tpu.parallel.banded_spmd import ShardedBandedStepper

    if scale == "100k":
        sys_, n_tets = build_tet100k(jnp.float32, lattice=True,
                                     cg_iters=cg_iters or 25)
    else:
        from admm_elastic_tpu import Settings, System
        from admm_elastic_tpu.geometry import make_beam_tets
        from admm_elastic_tpu.models import (
            ExplicitForce, HyperElasticTet, StaticAnchor)

        beam = make_beam_tets(12, 9, 8)
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=jnp.float32, global_solver="dia",
                            cg_fixed_iters=cg_iters or 25,
                            lattice_fast_path=True))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(
            np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                    max_iters=5, model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        sys_, n_tets = s, beam.n_tets

    spmd = ShardedBandedStepper(
        sys_._lattice.base, jax.make_mesh((1,), ("elem",)),
        solver=solver, cheb_iters=cheb_iters,
        mg_cycles=cheb_iters or 10,
        system=(sys_ if solver == "mg" else None))
    if window:
        spmd.rollout_window = window
    med, lo, hi = _time_stepper(spmd, steps)
    row = {"metric": f"sharded_banded_d1_ms_per_step_{scale}",
           "value": round(med, 3), "unit": "ms",
           "spread": [round(lo, 3), round(hi, 3)],
           "n_tets": n_tets, "device": dev.device_kind,
           "solver": solver,
           "cg_iters": (spmd.cheb_iters if solver == "cheb"
                        else spmd.mg_cycles if solver == "mg"
                        else spmd.cg_iters)}
    if solver == "cheb":
        row["cheb_bounds"] = [round(b, 5) for b in spmd.cheb_bounds]
    if solver == "mg":
        row["mg_rho"] = round(spmd.mg_rho, 4)
        row["mg_levels"] = list(spmd.mg_levels)
    return row


def bench_cloth(steps, scale, cg_iters=None, window=0, solver="cg",
                mg_cycles=10):
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.parallel.cloth_spmd import ShardedClothStepper

    if scale == "100k":
        from bench import build_cloth100k

        sys_, n_tris = build_cloth100k(jnp.float32,
                                       cg_iters=cg_iters or 25)
    else:
        from admm_elastic_tpu import Settings, System
        from admm_elastic_tpu.geometry import extract_hinges, make_sym_plane
        from admm_elastic_tpu.models import (
            Bend, ExplicitForce, LimitedTriangleStrain, StaticAnchor,
            WindForce)

        mesh = make_sym_plane(40, 30)
        n = mesh.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=jnp.float32, global_solver="dia",
                            cg_fixed_iters=cg_iters or 25,
                            lattice_fast_path=True))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        s.add_force(StaticAnchor([0, 30]))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, .4)))
        assert s.initialize()
        sys_, n_tris = s, mesh.n_faces

    spmd = ShardedClothStepper(
        sys_._lattice.base, jax.make_mesh((1,), ("elem",)),
        solver=solver, mg_cycles=mg_cycles,
        system=(sys_ if solver == "mg" else None))
    if window:
        spmd.rollout_window = window
    med, lo, hi = _time_stepper(spmd, steps)
    row = {"metric": f"sharded_cloth_d1_ms_per_step_{scale}",
           "value": round(med, 3), "unit": "ms",
           "spread": [round(lo, 3), round(hi, 3)],
           "n_tris": n_tris, "solver": solver,
           "cg_iters": (spmd.mg_cycles if solver == "mg"
                        else spmd.cg_iters)}
    if solver == "mg":
        row["mg_rho"] = round(spmd.mg_rho, 4)
        row["mg_levels"] = list(spmd.mg_levels)
    return row


def bench_delaunay(steps, scale, cg_iters=None, solver="cg",
                   cheb_iters=None):
    """Sharded ARBITRARY topology (uell matvec) on the chip at D=1 —
    the sharded uell path. Matched CG budget for the delaunay100k
    operator is cg150 (f64 CPU study: worst ratio <=0.98 vs the AMG-8
    oracle); solver='cheb' runs the dot-free recurrence over the ELL
    matvec."""
    import jax
    import jax.numpy as jnp

    from bench import build_delaunay100k
    from admm_elastic_tpu.parallel.banded_spmd import (
        sharded_banded_from_system)

    if scale != "100k":
        raise SystemExit("--family delaunay: 100k scale only")
    sys_, n_tets = build_delaunay100k(jnp.float32,
                                      cg_iters=cg_iters or 25)
    out = sharded_banded_from_system(
        sys_, jax.make_mesh((1,), ("elem",)),
        solver=solver, cheb_iters=cheb_iters)
    assert out is not None, "delaunay scene did not qualify (uell)"
    spmd, _ = out
    assert spmd.base._uell is not None
    med, lo, hi = _time_stepper(spmd, steps)
    row = {"metric": f"sharded_delaunay_d1_ms_per_step_{scale}",
           "value": round(med, 3), "unit": "ms",
           "spread": [round(lo, 3), round(hi, 3)],
           "n_tets": n_tets, "device": dev.device_kind,
           "solver": solver,
           "cg_iters": (spmd.cheb_iters if solver == "cheb"
                        else spmd.cg_iters)}
    if solver == "cheb":
        row["cheb_bounds"] = [round(b, 5) for b in spmd.cheb_bounds]
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="both",
                    choices=["banded", "cloth", "delaunay", "both"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--scale", default="100k", choices=["100k", "small"])
    ap.add_argument("--cg-iters", type=int, default=None)
    ap.add_argument("--window", type=int, default=0,
                    help="rollout window override (0 = stepper default)")
    ap.add_argument("--solver", default="cg",
                    choices=["cg", "cheb", "mg"],
                    help="global solve: cheb = dot-product-free "
                         "Chebyshev; mg = "
                         "sharded V-cycles + dot-free Chebyshev outer")
    ap.add_argument("--cheb-iters", type=int, default=None,
                    help="cheb iterations / mg cycles")
    args = ap.parse_args()

    print(f"# device: {dev.platform} ({dev.device_kind})", file=sys.stderr)

    if args.family in ("banded", "both"):
        row = bench_banded(args.steps, args.scale, args.cg_iters,
                           args.window, solver=args.solver,
                           cheb_iters=args.cheb_iters)
        print(json.dumps(row), flush=True)
    if args.family in ("cloth", "both"):
        row = bench_cloth(args.steps, args.scale, args.cg_iters,
                          args.window,
                          solver=("mg" if args.solver == "mg" else "cg"),
                          mg_cycles=args.cheb_iters or 10)
        print(json.dumps(row), flush=True)
    if args.family == "delaunay":
        row = bench_delaunay(args.steps, args.scale, args.cg_iters,
                             solver=args.solver,
                             cheb_iters=args.cheb_iters)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
