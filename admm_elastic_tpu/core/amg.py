"""Aggregation-AMG preconditioner for the global-step PCG.

The reference solves the global step EXACTLY with a prefactored sequential
SimplicialLDLT (System.cpp:140,62). The iterative replacement is Jacobi-PCG
— but A_hat = M + dt² Dᵀ W² D
is stiffness-dominated (dt²·k·vol·‖B‖² ≫ m on production materials), i.e. a
graph-Laplacian-like operator whose low-frequency error modes need
O(mesh diameter) Jacobi-PCG iterations: a matched-residual solve on a
100k-node unstructured mesh costs hundreds of CG iterations where a small
beam needs 25 (measured in tools/residual_match.py --delaunay). An
algebraic-multigrid V-cycle removes the diameter dependence — every cycle
contracts ALL error frequencies — and, built on aggregates, it uses only
gathers, segment sums and small dense products:

  * smoothing        — damped Jacobi: one ELL matvec (gather + fma)
  * restriction      — segment-sum of residuals over aggregate ids
  * prolongation     — a gather of the coarse correction
  * coarsest solve   — one dense (nc,nc)@(nc,3) matmul (precomputed
                       inverse, nc ≤ coarse_max)

The cycle (symmetric: one pre- and one post-smoothing sweep with the same
self-adjoint smoother) is an SPD operator, so it is a valid CG
preconditioner. Setup is host-side scipy (like the ELL/DIA assembly) and is
re-run by System.recompute_weights — the same cost profile as the
reference's re-factorization path (System.cpp:159-179), still cheaper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .solver import ell_apply


# --------------------------------------------------------------- host setup

def _strength_graph(A, theta):
    """Strong-connection mask on the off-diagonal entries of CSR A:
    |a_ij| >= theta * sqrt(a_ii * a_jj)."""
    import scipy.sparse as sp

    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    Ac = A.tocoo()
    off = Ac.row != Ac.col
    strong = off & (
        np.abs(Ac.data) >= theta * np.sqrt(d[Ac.row] * d[Ac.col])
    )
    return sp.csr_matrix(
        (np.ones(int(strong.sum())), (Ac.row[strong], Ac.col[strong])),
        shape=A.shape,
    )


def _aggregate(S):
    """Greedy aggregation on the strength graph (Vaněk-style): pass 1 seeds
    an aggregate from each node whose strong neighborhood is untouched;
    pass 2 attaches remaining nodes to an adjacent aggregate; pass 3 makes
    singletons of true isolates. Returns (agg (n,) int64, n_agg)."""
    n = S.shape[0]
    agg = np.full(n, -1, np.int64)
    indptr, indices = S.indptr, S.indices
    n_agg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]: indptr[i + 1]]
        if (agg[nb] == -1).all():
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = indices[indptr[i]: indptr[i + 1]]
        owned = nb[agg[nb] != -1]
        if len(owned):
            agg[i] = agg[owned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _csr_to_ell(A, pad_to=8, K_fixed=None):
    deg = np.diff(A.indptr)
    n = A.shape[0]
    K = max(int(deg.max()) if n else 1, 1)
    K = -(-K // pad_to) * pad_to
    if K_fixed is not None:
        if K > K_fixed:
            raise ValueError(
                f"amg: sparsity widened ({K} > stored {K_fixed})"
            )
        K = K_fixed
    idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    vals = np.zeros((n, K), np.float64)
    row_of = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    idx[row_of, pos] = A.indices
    vals[row_of, pos] = A.data
    return idx.astype(np.int32), vals


def _rho_dinv_a(A, iters=10, seed=0):
    """Power-iteration estimate of rho(D^{-1} A) (host, cheap)."""
    d = A.diagonal()
    d = np.where(d > 0, d, 1.0)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    lam = 1.0
    for _ in range(iters):
        y = (A @ x) / d
        lam = float(np.linalg.norm(y))
        if lam == 0:
            return 1.0
        x = y / lam
    return lam


def build_amg(A, coarse_max=1024, theta=0.08, max_levels=12):
    """Host-side AMG hierarchy for CSR A (SPD). Returns (arrays, meta):
    arrays — a tuple of dicts of numpy arrays (device-traceable params, one
    per level; the last holds the dense coarse inverse); meta — a tuple of
    static per-level descriptors {'n', 'nc'} used for segment counts.
    Aggregation is plain (0/1 tentative prolongation): restriction is a
    segment-sum and prolongation a gather — no P matvec needed."""
    import scipy.sparse as sp

    arrays, meta = [], []
    lvl = A.tocsr()
    for _ in range(max_levels):
        n = lvl.shape[0]
        if n <= coarse_max:
            break
        S = _strength_graph(lvl, theta)
        agg, nc = _aggregate(S)
        if nc >= n:  # no coarsening progress — stop
            break
        idx, vals = _csr_to_ell(lvl)
        diag = lvl.diagonal()
        diag = np.where(diag > 0, diag, 1.0)
        rho = max(_rho_dinv_a(lvl), 1e-12)
        arrays.append({
            "ell_idx": idx,
            "ell_vals": vals,
            "inv_diag": 1.0 / diag,
            "agg": agg.astype(np.int32),
            # traced (not static) so recompute_weights can refresh values
            # without retracing the jitted step
            "lmax": np.float64(1.05 * rho),
        })
        meta.append({"n": int(n), "nc": int(nc)})
        P = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, nc)
        )
        lvl = (P.T @ lvl @ P).tocsr()
        lvl.sum_duplicates()
    dense = lvl.toarray()
    arrays.append({"A_inv": np.linalg.inv(dense)})
    meta.append({"n": int(lvl.shape[0]), "nc": 0})
    return tuple(arrays), tuple(meta)


def rebuild_amg_values(A, arrays, meta):
    """Refresh hierarchy VALUES over the FROZEN aggregation of `arrays`
    (runtime weight edits keep the sparsity pattern — solver assembly
    retains structural zeros — so aggregates, level sizes and ELL widths
    stay put and the jitted step never retraces). Returns a new arrays
    tuple with identical shapes."""
    import scipy.sparse as sp

    out = []
    lvl = A.tocsr()
    for l, arr in enumerate(arrays[:-1]):
        idx, vals = _csr_to_ell(lvl, K_fixed=arr["ell_vals"].shape[1])
        diag = lvl.diagonal()
        diag = np.where(diag > 0, diag, 1.0)
        rho = max(_rho_dinv_a(lvl), 1e-12)
        agg = np.asarray(arr["agg"], np.int64)
        out.append({
            "ell_idx": idx,
            "ell_vals": vals,
            "inv_diag": 1.0 / diag,
            "agg": arr["agg"],
            "lmax": np.float64(1.05 * rho),
        })
        n, nc = meta[l]["n"], meta[l]["nc"]
        P = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
        lvl = (P.T @ lvl @ P).tocsr()
        lvl.sum_duplicates()
    out.append({"A_inv": np.linalg.inv(lvl.toarray())})
    return tuple(out)


# -------------------------------------------------------------- device apply

def make_vcycle(meta, degree=1, alpha=4.0):
    """V-cycle preconditioner apply: z = M^{-1} r for r (n, m). `meta` is
    static (segment counts + spectral bounds); the level arrays are traced
    arguments so the hierarchy lives in params and recompute_weights can
    refresh values without retracing.

    Smoother: degree-`degree` Chebyshev on the Jacobi-preconditioned
    operator over [lmax/alpha, lmax] — the standard polynomial smoother for
    aggregation AMG (matvec-only, no triangular solves, self-adjoint, so
    the symmetric cycle stays a valid SPD CG preconditioner)."""

    def cheb(lv, l, r):
        """z ≈ A^{-1} r from a zero initial guess (fixed polynomial)."""
        lmax = lv["lmax"].astype(r.dtype)
        lmin = lmax / alpha
        th = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = th / delta
        inv_d = lv["inv_diag"].astype(r.dtype)[:, None]
        vals = lv["ell_vals"].astype(r.dtype)
        rho = 1.0 / sigma
        d = (1.0 / th) * (inv_d * r)
        z = d
        rk = r
        for _ in range(degree - 1):
            rk = rk - ell_apply(d, lv["ell_idx"], vals)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (inv_d * rk)
            z = z + d
            rho = rho_new
        return z

    def apply_M(levels, r):
        def vc(l, r):
            lv = levels[l]
            if "A_inv" in lv:
                return lv["A_inv"].astype(r.dtype) @ r
            vals = lv["ell_vals"].astype(r.dtype)
            z = cheb(lv, l, r)
            res = r - ell_apply(z, lv["ell_idx"], vals)
            rc = jax.ops.segment_sum(
                res, lv["agg"], num_segments=meta[l]["nc"]
            )
            z = z + vc(l + 1, rc)[lv["agg"]]
            z = z + cheb(lv, l, r - ell_apply(z, lv["ell_idx"], vals))
            return z

        return vc(0, r)

    return apply_M


def pcg_solve_fixed_precond(A_apply, M_apply, b, x0, n_iters: int):
    """Fixed-iteration PCG with a general SPD preconditioner (the AMG
    V-cycle). Mirrors solver.pcg_solve_fixed's static control flow."""

    def dot(a, c):
        return jnp.vdot(a, c)

    r = b - A_apply(x0)
    z = M_apply(r)
    p = z
    rz = dot(r, z)

    def body(_, carry):
        x, r, p, rz = carry
        Ap = A_apply(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_apply(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        p = z + beta * p
        return (x, r, p, rz_new)

    x, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (x0, r, p, rz))
    return x


def pcg_solve_precond(A_apply, M_apply, b, x0, tol, max_iters):
    """Tolerance-based PCG with a general preconditioner (validation /
    'exact' mode)."""

    def dot(a, c):
        return jnp.vdot(a, c)

    r = b - A_apply(x0)
    z = M_apply(r)
    p = z
    rz = dot(r, z)
    b_norm2 = dot(b, b)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.finfo(b.dtype).tiny)

    def cond(carry):
        x, r, p, rz, it = carry
        return jnp.logical_and(it < max_iters, dot(r, r) > tol2)

    def body(carry):
        x, r, p, rz, it = carry
        Ap = A_apply(p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_apply(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz > 0, rz, 1.0)
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    x, r, p, rz, it = jax.lax.while_loop(
        cond, body, (x0, r, p, rz, jnp.int32(0))
    )
    return x, it
