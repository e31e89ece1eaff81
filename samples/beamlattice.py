"""Whole-mesh layout demo: a clamped NeoHookean beam sagging under
gravity, stepped through the banded layout (Settings.lattice_fast_path:
one XLA program per step on a one-device mesh). Compare with the same
System on the general path (lattice_fast_path=False).

Run: python samples/beamlattice.py [--steps N] [--render out.png]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dims", type=int, nargs=3, default=(16, 8, 6))
    ap.add_argument("--render", default=None)
    args = ap.parse_args()

    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import (
        ExplicitForce, HyperElasticTet, StaticAnchor)

    nx, ny, nz = args.dims
    beam = make_beam_tets(nx, ny, nz, size=0.05)
    n = beam.n_vertices
    anchored = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
    sys_ = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                           dtype=jnp.float32, global_solver="dia",
                           cg_fixed_iters=25, lattice_fast_path=True))
    sys_.add_nodes(beam.vertices, np.full(n, 50.0 / n))
    sys_.add_force(StaticAnchor(anchored))
    sys_.add_force(HyperElasticTet(beam.tets, 1e5, 1e5, max_iters=5))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize() and sys_._lattice is not None
    sys_.run(args.steps)
    x = sys_.x
    tip = x[np.argmax(beam.vertices[:, 0])]
    print(f"{nx}x{ny}x{nz} cells ({beam.n_tets} tets), {args.steps} steps: "
          f"tip at {tip}, min y {x[:, 1].min():.4f} "
          f"(rest {beam.vertices[:, 1].min():.4f})")
    assert np.isfinite(x).all()

    if args.render:
        from admm_elastic_tpu.geometry.tetmesh import surface_faces
        from admm_elastic_tpu.viz import render_frame

        render_frame([(x, surface_faces(beam.tets))], args.render)
        print("wrote", args.render)


if __name__ == "__main__":
    main()
