"""admm_elastic_tpu — ADMM elastodynamics framework in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of the
"ADMM (superset of) Projective Dynamics" solver (SCA 2016 reference at
mattoverby/admm-elastic-sca): implicit time integration of elastic bodies
(cloth, tet volumes, springs, bending hinges, pins, collisions) via ADMM
with batched per-element local proximal steps and a matrix-free or
dense global step, designed for single-device speed and multi-device
sharding (jax.sharding / shard_map) from the start.

Layout:
  core/      System (builder + jitted ADMM timestep), global solvers
  models/    constraint batches (springs, anchors, tets, triangles, bend,
             collision) and explicit forces (gravity, wind)
  ops/       batched small-SVD, Newton prox solver, gather/scatter, Pallas
  geometry/  mesh IO (.node/.ele, obj/ply), procedural meshes, connectivity
  scene/     XML scene dialect reader + scene-to-system builder
  parallel/  device-mesh sharding of elements and scenario batches
  utils/     checkpointing, profiling
"""

from .core.system import System, Settings
from . import models, geometry, ops

__version__ = "0.1.0"

__all__ = ["System", "Settings", "models", "geometry", "ops"]
