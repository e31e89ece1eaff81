"""Convergence study: ADMM over-relaxation and Anderson acceleration.

Measures the per-step primal residual trajectory on a bundled-scene-sized
workload (beam of LinearTetStrain tets + anchors + gravity, the singletet/
plinko force family) for a grid of `Settings.relaxation` values and
Anderson(m) depths, and prints iterations-to-tolerance. Cited from the
Settings docstring (core/system.py) — run it to pick α/m per scene; the
useful range observed here is α∈[1.5,1.7], m∈[2,5].

Usage:  env JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \
            python tools/accel_study.py [--nx 8 --ny 6 --nz 6] [--tol 1e-8]
"""

import argparse
import sys

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from admm_elastic_tpu import Settings, System  # noqa: E402
from admm_elastic_tpu.geometry import make_beam_tets  # noqa: E402
from admm_elastic_tpu.models import (  # noqa: E402
    ExplicitForce,
    LinearTetStrain,
    StaticAnchor,
)


def run(beam, iters, **kw):
    n = beam.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=iters, verbose=0,
                        dtype=jnp.float64, collect_residuals=True, **kw))
    s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-12)))
    s.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize()
    # a couple of warm-up steps so duals are warm (steady-state regime)
    for _ in range(3):
        s.step()
    s.step()
    return np.asarray(s.last_aux["primal_residual"])


def iters_to(rp, tol):
    hit = np.flatnonzero(rp <= tol)
    return int(hit[0]) + 1 if hit.size else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--ny", type=int, default=6)
    ap.add_argument("--nz", type=int, default=6)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()
    beam = make_beam_tets(args.nx, args.ny, args.nz)
    print(f"# beam {args.nx}x{args.ny}x{args.nz}: {beam.n_vertices} nodes, "
          f"{len(beam.tets)} tets; tol={args.tol:g}, max {args.iters} iters")

    rows = [("plain", dict())]
    rows += [(f"relax {a}", dict(relaxation=a))
             for a in (1.3, 1.5, 1.6, 1.7, 1.8)]
    rows += [(f"anderson m={m}", dict(acceleration="anderson", anderson_m=m))
             for m in (2, 3, 5, 8)]
    for name, kw in rows:
        rp = run(beam, args.iters, **kw)
        k = iters_to(rp, args.tol)
        print(f"{name:16s} iters-to-tol: {k if k else '>'+str(args.iters):>4} "
              f" final residual: {rp[-1]:.3e}")


if __name__ == "__main__":
    main()
