"""Multi-chip parallelism.

The reference's only parallelism is shared-memory OpenMP over constraints
(System.cpp:57). Here parallelism is designed in at the data layout level:

  * element parallelism — constraint batches are sharded along their element
    axis over a `jax.sharding.Mesh` axis; vertex state (n,3) is replicated
    (1M verts = 12 MB fp32, cheap to replicate). The local step is then
    embarrassingly parallel, and the only cross-device traffic is the
    D^T W^2 segment-sum reduction (one psum of (n,3) per CG matvec /
    right-hand side), which rides the ICI.
  * scenario parallelism — vmapped simulations sharded over a 'data' axis
    (the 64-armadillo-sweep workload).

Both compose in a 2D ('data','elem') mesh. GSPMD inserts the collectives
from sharding constraints; no hand-written communication.
"""

from .sharding import shard_params_and_state, make_sim_mesh, pad_batches
from .scenarios import batch_state, vmap_step

__all__ = [
    "shard_params_and_state",
    "make_sim_mesh",
    "pad_batches",
    "batch_state",
    "vmap_step",
    # lazily importable (pull in jax.shard_map machinery):
    #   .spmd.SpmdSystem            replicated-vertex element sharding
    #   .halo_spmd.HaloSpmdSystem   boundary-halo O(cut) sharding
    #   .banded_spmd.ShardedBandedStepper  sharded banded whole-mesh layout
    #   .cloth_spmd.ShardedClothStepper    sharded cloth whole-mesh layout
    #   .comm                        measured-HLO collective accounting
]
