"""ForceBatch: one *batch* of constraints of a single type.

The reference treats each constraint as an object with virtual
`get_selector` / `project` methods dispatched per-force inside an OpenMP loop
(System.cpp:57-58). Here every constraint type instead becomes a
struct-of-arrays batch with

  * ``params``: arrays that may change at runtime without recompiling —
    selector data (`indices` (E,K) int32, `coeff` (E,R,K)), per-element
    `weight` (E,), and material constants. Passing them as traced arguments
    (rather than baking them into the jaxpr) is what makes the reference's
    "recompute_weights + re-factorize" path (System.cpp:159-179) free here,
    and what lets scenario sweeps vmap over material parameters.
  * ``state``: per-element values carried across steps (dual variables are
    handled by the System; this holds extras like the hyperelastic
    warm-start sigma, TetForce.hpp:145).
  * ``project``: the batched local step z-update. The System performs the
    generic dual update u += Dx - z afterwards (Force.cpp:67 pattern).

Selector structure: rows act component-wise (see ops/segment.py), so
Dx has shape (E, R, 3): row-group r of element e applied to each of xyz.
"""

from __future__ import annotations

import abc

import numpy as np


class ForceBatch(abc.ABC):
    """Abstract constraint batch. Subclasses define R (row-groups per element)
    and K (stencil vertices per element)."""

    R: int = 1
    K: int = 1
    #: set by System.initialize(); key into the params/state/z/u dicts
    name: str = ""

    @property
    @abc.abstractmethod
    def n_elements(self) -> int:
        ...

    @abc.abstractmethod
    def build(self, x: np.ndarray, masses: np.ndarray, dt: float):
        """Host-side init (reference Force::initialize + get_selector).

        x: (n,3) rest/current positions. Returns (params, state) dicts of
        numpy arrays. params must contain 'indices' (E,K) int32,
        'coeff' (E,R,K) float, 'weight' (E,) float.
        """

    @abc.abstractmethod
    def project(self, Dx, u, params, state):
        """Batched local step: returns (z, new_state).

        Dx, u: (E,R,3) device arrays; params/state: device dicts.
        """

    def project_with_dual(self, Dx, u, params, state):
        """Local step + dual update: returns (z, u_new, new_state).

        Default composes project() with the generic u += Dx - z
        (Force.cpp:67 pattern). Fused-kernel backends override this so the
        dual update happens inside the kernel.
        """
        z, st = self.project(Dx, u, params, state)
        return z, u + Dx - z, st

    # ---- layout-owning hooks ---------------------------------------------
    # The System treats Dx/u/z as opaque per-force arrays produced and
    # consumed ONLY through these methods, so a fused backend can keep its
    # own memory layout (e.g. (9, E) planes) across the whole iteration with
    # zero relayout traffic. Defaults use the canonical (E, R, 3) layout.

    def dual_init(self, np_module=np):
        """Initial dual variable u (zeros) in this force's native layout."""
        return np_module.zeros((self.n_elements, self.R, 3))

    def compute_Dx(self, params, x):
        """D x in the native layout."""
        from ..ops.segment import coeff_apply

        return coeff_apply(params["coeff"], params["indices"], x)

    def rhs_contribution(self, params, z, u):
        """Per-(element,vertex-slot) rows of D^T W^2 (z-u): (E*K, 3), in the
        flattened order assemble_transpose_incidence expects."""
        import jax.numpy as jnp

        w2 = params["weight"] ** 2
        c = jnp.einsum("erk,e,erj->ekj", params["coeff"], w2, z - u)
        return c.reshape(-1, 3)

    def scatter_rhs(self, params, z, u, n_vertices):
        """D^T W^2 (z-u) scattered to vertices (segment-sum path)."""
        from ..ops.segment import coeff_apply_T

        w2 = params["weight"] ** 2
        return coeff_apply_T(params["coeff"], params["indices"], w2, z - u,
                             n_vertices)

    def primal_piece(self, params, u_new, u_old):
        """||W (Dx - z)||^2 for this batch via the dual-update identity
        Dx - z = u_new - u_old (u' = u + Dx - z holds for every force,
        fused or not) — the primal residual with no Dx/z materialization."""
        import jax.numpy as jnp

        w = params["weight"][:, None, None]
        return jnp.sum((w * (u_new - u_old)) ** 2)

    def rhs_contribution6(self, params, z, u):
        """(E*K, 6): columns 0:3 the D^T W^2 (z-u) RHS rows (as
        rhs_contribution), columns 3:6 the D^T W^2 z rows used for the dual
        residual s_i = dt^2 ||T z_i - T z_{i-1}|| (one shared incidence
        gather recovers both)."""
        import jax.numpy as jnp

        w2 = params["weight"] ** 2
        czu = jnp.einsum("erk,e,erj->ekj", params["coeff"], w2, z - u)
        cz = jnp.einsum("erk,e,erj->ekj", params["coeff"], w2, z)
        return jnp.concatenate(
            [czu.reshape(-1, 3), cz.reshape(-1, 3)], axis=1
        )

    def residual_pieces(self, params, Dx, z, z_prev, n_vertices, dt2):
        """(||W(Dx-z)||^2, dt^2 D^T W^2 (z - z_prev)) for the ADMM residuals."""
        import jax.numpy as jnp

        w = params["weight"][:, None, None]
        r2 = jnp.sum((w * (Dx - z)) ** 2)
        s = dt2 * self.scatter_rhs(params, z, z_prev, n_vertices)
        return r2, s

    # ---- helpers ----------------------------------------------------------

    def __repr__(self) -> str:
        return f"{type(self).__name__}(E={self.n_elements})"
