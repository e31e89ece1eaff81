"""Scenario-batch data parallelism: many simulations of the same topology,
vmapped and sharded over the mesh's 'data' axis (the BASELINE "64 parallel
armadillo drops with varied stiffness" workload).

Because material parameters and weights are traced params, a scenario sweep
vmaps over them too — no recompilation per variant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.precision import highest


def batch_state(state, n_scenarios: int, jitter=None, mesh: Mesh | None = None,
                data_axis: str = "data"):
    """Stack a state pytree to a leading scenario axis. `jitter(x, i)` can
    perturb initial positions per scenario. Sharded over `data_axis` if a
    mesh is given."""

    def stack(a):
        return jnp.broadcast_to(a[None], (n_scenarios,) + a.shape)

    batched = jax.tree_util.tree_map(stack, state)
    if jitter is not None:
        xs = np.stack(
            [jitter(np.asarray(state["x"]), i) for i in range(n_scenarios)]
        )
        batched["x"] = jnp.asarray(xs, state["x"].dtype)
    if mesh is not None:
        def shard(a):
            return jax.device_put(
                a, NamedSharding(mesh, P(data_axis, *([None] * (a.ndim - 1))))
            )
        batched = jax.tree_util.tree_map(shard, batched)
    return batched


def batch_params(params, sweep: dict, n_scenarios: int, system=None):
    """Broadcast params with per-scenario overrides.

    sweep: {(force_name, param_key): array (n_scenarios, ...)} e.g. varied
    stiffness. Non-swept entries stay unbatched (broadcast inside vmap via
    in_axes=None is handled by passing them stacked too for simplicity).

    Weight-affecting sweeps change the global matrix. With
    global_solver='cg' (matrix-free) nothing extra is needed; with
    'ell'/'dia', pass the initialized `system` and the per-scenario global
    matrices are re-assembled on the host (same sparsity, batched values) so
    the precomputed-matrix CG paths stay usable under vmap. 'dense' would
    need 64 host inversions — use 'cg' there.
    """
    weightish = {"weight", "k", "mu", "lam", "stiffness"}
    needs_solver = False
    if sweep and "_solver" in params:
        swept_keys = {k for (_, k) in sweep}
        if swept_keys & weightish and (
            "ell_vals" in params["_solver"] or "A_inv" in params["_solver"]
            or "dia_vals" in params["_solver"]
        ):
            if system is None or "A_inv" in params["_solver"]:
                raise ValueError(
                    "sweeping weights/material stiffness with a precomputed "
                    "global matrix: pass the initialized system to "
                    "batch_params(..., system=) for 'ell'/'dia' (per-scenario "
                    "re-assembly), or use global_solver='cg' (matrix-free)"
                )
            needs_solver = True

    def stack(a):
        return jnp.broadcast_to(a[None], (n_scenarios,) + a.shape)

    batched = jax.tree_util.tree_map(stack, params)
    for (fname, key), values in sweep.items():
        v = jnp.asarray(values)
        base = params[fname][key]
        if v.shape[1:] != base.shape:
            v = jnp.broadcast_to(
                v.reshape(v.shape + (1,) * (base.ndim - (v.ndim - 1))),
                (n_scenarios,) + base.shape,
            )
        batched[fname][key] = v.astype(base.dtype)

    if needs_solver:
        _rebatch_solver(batched, sweep, n_scenarios, system)
    return batched


def batched_A_values(system, w2_b):
    """Per-scenario A_hat values over the shared topological sparsity —
    VECTORIZED over scenarios.

    The sparsity pattern is topological (structural zeros retained), so
    only the VALUES change: A_s = diag(m) + dt^2 sum_e w2[s,e] * Me with
    Me = C_e^T C_e constant. One pass precomputes every COO entry's slot
    in the shared CSR pattern; the batched fill is then a single bincount
    over (scenario, slot) — 1024-scenario setup in well under a second
    where a per-scenario scipy loop took minutes.

    w2_b: (S, total elements) squared weights, concatenated in
    `system._constraint_names` order. Returns (A, vals, diag_b): the
    shared-pattern CSR matrix A (values = scenario of w2_b[0] — callers
    use only its structure), vals (S, nnz) in A.data (CSR = COO) order,
    and diag_b (S, n).
    """
    import scipy.sparse as sp

    from ..core.solver import _assemble_A_hat_csr

    n = system.n_nodes
    dt = system.settings.timestep_s
    dt2 = dt * dt
    S = len(w2_b)
    masses = np.asarray(getattr(system, "_mi", system._m), np.float64)
    names = list(system._constraint_names)

    base_params = {
        name: {k: np.asarray(v) for k, v in system.params[name].items()}
        for name in names
    }
    A = _assemble_A_hat_csr(n, masses, dt, base_params)
    indptr, indices, nnz = A.indptr, A.indices, A.nnz
    slot_lut = sp.csr_matrix(
        (np.arange(1, nnz + 1, dtype=np.int64), indices, indptr), shape=(n, n)
    )

    slot_all, base_all, wcol_all = [], [], []
    col_off = 0
    for name in names:
        p = base_params[name]
        C = p["coeff"].astype(np.float64)
        idx = p["indices"].astype(np.int64)
        E, K = idx.shape
        Me = np.einsum("erk,erl->ekl", C, C) * dt2
        rows = np.repeat(idx[:, :, None], K, axis=2).ravel()
        cols = np.repeat(idx[:, None, :], K, axis=1).ravel()
        slots = np.asarray(slot_lut[rows, cols]).ravel() - 1
        assert (slots >= 0).all(), "entry outside the shared pattern"
        slot_all.append(slots)
        base_all.append(Me.ravel())
        wcol_all.append(col_off + np.repeat(np.arange(E), K * K))
        col_off += E

    slots = np.concatenate(slot_all)
    base = np.concatenate(base_all)
    wcol = np.concatenate(wcol_all)
    w2_b = np.asarray(w2_b, np.float64)
    contrib = base[None, :] * w2_b[:, wcol]  # (S, total entries)
    comb = (np.arange(S, dtype=np.int64)[:, None] * nnz + slots[None, :])
    vals = np.bincount(
        comb.ravel(), weights=contrib.ravel(), minlength=S * nnz
    ).reshape(S, nnz)
    dslots = np.asarray(slot_lut[np.arange(n), np.arange(n)]).ravel() - 1
    vals[:, dslots] += masses[None, :]
    diag_b = vals[:, dslots]
    return A, vals, diag_b


def sweep_w2_b(system, sweep_or_batched, n_scenarios):
    """(S, total elements) squared weights in `system._constraint_names`
    order, from either a raw sweep dict ({(name, 'weight'): (S[,E])}) or
    batch_params output ({name: {'weight': (S, E)}})."""
    S = n_scenarios
    cols = []
    for name in system._constraint_names:
        base = np.asarray(system.params[name]["weight"], np.float64)
        E = len(np.asarray(system.params[name]["indices"]))
        w = None
        if (name, "weight") in sweep_or_batched:
            w = np.asarray(sweep_or_batched[(name, "weight")], np.float64)
        elif (name in sweep_or_batched
              and "weight" in sweep_or_batched[name]):
            w = np.asarray(sweep_or_batched[name]["weight"], np.float64)
        if w is None:
            w = np.broadcast_to(np.broadcast_to(base, (E,)), (S, E))
        else:
            if w.ndim == 1:
                w = w[:, None]
            w = np.broadcast_to(w, (S, E))
        cols.append(w**2)
    return np.concatenate(cols, axis=1)


def _rebatch_solver(batched, sweep, n_scenarios, system):
    """Re-assemble the precomputed ell/dia global matrix per scenario with
    the swept weights applied (see batched_A_values)."""
    mode = system._solver_mode
    n = system.n_nodes
    S = n_scenarios
    dtype = batched["_solver"]["diag"].dtype
    w2_b = sweep_w2_b(system, batched, n_scenarios)
    A, vals, diag_b = batched_A_values(system, w2_b)
    indptr, nnz = A.indptr, A.nnz

    coo = A.tocoo()
    if mode == "dia":
        offs = np.asarray(system._dia_offsets)
        d_idx = np.searchsorted(offs, coo.col - coo.row)
        dia_b = np.zeros((S, len(offs), n))
        dia_b[:, d_idx, coo.row] = vals
        batched["_solver"]["dia_vals"] = jnp.asarray(dia_b, dtype)
    else:  # ell
        base_idx = np.asarray(batched["_solver"]["ell_idx"][0])
        Kell = base_idx.shape[1]
        deg = np.diff(indptr)
        row_of = np.repeat(np.arange(n), deg)
        pos = np.arange(nnz) - np.repeat(indptr[:-1], deg)
        ell_b = np.zeros((S, n, Kell))
        ell_b[:, row_of, pos] = vals
        batched["_solver"]["ell_vals"] = jnp.asarray(ell_b, dtype)
    batched["_solver"]["diag"] = jnp.asarray(diag_b, dtype)


def vmap_step(system):
    """Jitted vmapped step over a leading scenario axis of (state, params)."""
    step = system._make_step()
    return jax.jit(highest(jax.vmap(step)), donate_argnums=(0,))
