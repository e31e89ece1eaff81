"""Dot-product-free Chebyshev global solve for the sharded steppers.

Why: the sharded whole-timestep steppers run a global Jacobi-PCG whose
every iteration needs TWO globally-reduced scalars (alpha, beta), which
puts two latency-bound psums on the critical path of every iteration on
a device mesh. Chebyshev semi-iteration replaces CG with a fixed 3-term
recurrence whose coefficients depend only on eigenvalue bounds of the
preconditioned operator — NO inner products, NO psums: the entire
k-iteration solve is element-wise + matvec work, and its only
cross-device traffic is the halo refresh of the direction vector.

The reference's global step is a prefactored direct solve
(System.cpp:62,140); this is a distributed replacement for it, chosen
over CG specifically for the collective-latency profile of a device mesh
(SURVEY §2.7: CG dots were "the only cross-device scalars" — Chebyshev
deletes them).

Algorithm: preconditioned Chebyshev (Saad, *Iterative Methods for
Sparse Linear Systems*, Alg. 12.1) on the Jacobi-preconditioned system
D^{-1}A with spectral bounds [lmin, lmax]:

    theta = (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma1 = theta/delta
    z0 = D^{-1}(b - A x0);  d0 = z0/theta;  rho0 = 1/sigma1
    x_{i+1} = x_i + d_i
    z_{i+1} = z_i - D^{-1} A d_i
    rho_{i+1} = 1/(2 sigma1 - rho_i)
    d_{i+1} = (rho_{i+1} rho_i) d_i + (2 rho_{i+1}/delta) z_{i+1}

The per-iteration scalars (c1_i = rho_{i+1} rho_i, c2_i = 2 rho_{i+1}/
delta) are precomputed host-side into (k,) arrays — the device loop is
branch- and reduction-free.

Spectral bounds come from a one-time host Lanczos (scipy eigsh) on the
symmetrically-scaled operator D^{-1/2} A D^{-1/2} (same spectrum as
D^{-1}A), restricted to the non-pad lanes. Safety margins widen the
interval; an OVER-estimated lmax and UNDER-estimated lmin only slow
convergence, never diverge (Chebyshev is convergent for any interval
containing the spectrum).
"""

from __future__ import annotations

import numpy as np


def _flat_shift(x: np.ndarray, off: int) -> np.ndarray:
    """out[i] = x[i+off], zero fill — the host twin of
    core/banded.shifted on a flattened plane."""
    out = np.zeros_like(x)
    if off == 0:
        out[:] = x
    elif off > 0:
        out[:-off] = x[off:]
    else:
        out[-off:] = x[:off]
    return out


def dia_operator_bounds(dia_planes: np.ndarray, offs, margin=0.05):
    """Spectral bounds of the Jacobi-preconditioned sparse-diagonal
    operator.

    dia_planes: (n_dia, R, 128) float — vals[d, i] = A[i, i+off_d] in
    the banded plane layout (flat index). offs: matching flat offsets
    (must contain 0 — the diagonal). Pad lanes (diag == 0) are excluded
    exactly: the zero rows/cols decouple.

    Returns (lmin, lmax) with the safety margin applied.
    """
    dia = np.asarray(dia_planes, np.float64)
    n_dia, R, L = dia.shape
    N = R * L
    flat = dia.reshape(n_dia, N)
    offs = [int(o) for o in offs]
    d0 = flat[offs.index(0)]
    valid = np.flatnonzero(d0 > 0)
    nv = len(valid)
    if nv == 0:
        raise ValueError("empty operator (all-zero diagonal)")
    # assemble the valid-restricted scipy matrix: A[i, i+off] = flat[d, i]
    pos = -np.ones(N, np.int64)
    pos[valid] = np.arange(nv)
    rows, cols, vals = [], [], []
    for di, off in enumerate(offs):
        i = np.arange(max(0, -off), min(N, N - off))
        j = i + off
        v = flat[di, i]
        keep = (pos[i] >= 0) & (pos[j] >= 0) & (v != 0.0)
        rows.append(pos[i[keep]])
        cols.append(pos[j[keep]])
        vals.append(v[keep])
    from scipy.sparse import csr_matrix

    A = csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows),
                                np.concatenate(cols))),
        shape=(nv, nv),
    )
    return _scaled_bounds(A, d0[valid], margin)


def _scaled_bounds(A, d0, margin):
    """Eigenvalue bounds of diag(d0)^{-1} A via the symmetrically-scaled
    twin D^{-1/2} A D^{-1/2} (same spectrum). A: valid-restricted csr;
    d0: (nv,) positive Jacobi diagonal. Margins widen the interval."""
    from scipy.sparse import diags
    from scipy.sparse.linalg import eigsh

    dinv_sqrt = 1.0 / np.sqrt(d0)
    B = diags(dinv_sqrt) @ A @ diags(dinv_sqrt)
    B = (B + B.T) * 0.5  # symmetrize round-off
    # deterministic Lanczos start: eigsh's default v0 is RANDOM, which
    # made the cheb schedule (a compiled-in constant) differ between
    # otherwise-identical builds — e.g. D=2 vs D=4 steppers of the same
    # system diverging by bound noise rather than arithmetic
    v0 = np.random.default_rng(0).standard_normal(B.shape[0])
    lmax = float(eigsh(B, k=1, which="LA", return_eigenvectors=False,
                       tol=1e-3, v0=v0)[0])
    lmin = float(eigsh(B, k=1, which="SA", return_eigenvectors=False,
                       tol=1e-3, v0=v0)[0])
    if lmin <= 0:
        # numerically touching zero: fall back to a tiny positive bound
        lmin = 1e-6 * lmax
    return lmin * (1.0 - margin), lmax * (1.0 + margin)


def uell_operator_bounds(vals, ccs, slot_qs, fold_qs, vmask, invd,
                         margin=0.05):
    """Spectral bounds of the Jacobi-preconditioned ARBITRARY-TOPOLOGY
    operator in core/uell.py's slot/fold plane layout — the uell twin of
    `dia_operator_bounds`, enabling solver='cheb' on the sharded uell
    path.

    The plane semantics ARE the matvec (core/uell.py uell_matvec_np):

        slot k:   out[r,l] += vals[k,r,l] * x[r+q_k, ccs[k,r,l]]
        fold op:  acc[r,l] += vals[kf,r,l] * acc[r+q, ccs[kf,r,l]]
                  (sequential, on the RESULT plane)
        final:    out *= vmask

    so the assembled matrix is A = (I+F_m)...(I+F_1) @ S with S from the
    slot entries and one F per fold op in application order; restricting
    rows AND columns to valid primary positions (vmask>0, invd>0) drops
    nothing (slot columns only reference primary positions; copy rows
    are folded into their parents before the mask).

    vals: (S_total, Nr, L) value planes (slots then fold ops, layer
    order); ccs: matching (S_total, Nr, L) int lane indices; slot_qs:
    per-slot row shifts; fold_qs: list of layers, each a list of row
    shifts; vmask/invd: (Nr, L) planes (PVM / PINVD).

    Returns (lmin, lmax) of D^{-1}A with D = 1/invd — the EXACT
    preconditioner the cheb recurrence applies — margins included.
    """
    from scipy.sparse import csr_matrix, identity

    vals = np.asarray(vals, np.float64)
    ccs = np.asarray(ccs, np.int64)
    S_total, Nr, L = vals.shape
    N = Nr * L

    def plane_coo(k, q):
        """COO of out[r,l] += vals[k,r,l] * x[r+q, ccs[k,r,l]]."""
        r, l = np.nonzero(vals[k])
        src = r + q
        keep = (src >= 0) & (src < Nr)  # _rshift zero-fills outside
        r, l, src = r[keep], l[keep], src[keep]
        return (r * L + l, src * L + ccs[k, r, l],
                vals[k, r, l])

    rows, cols, ents = [], [], []
    for k, q in enumerate(slot_qs):
        rr, cc, vv = plane_coo(k, int(q))
        rows.append(rr)
        cols.append(cc)
        ents.append(vv)
    S = csr_matrix(
        (np.concatenate(ents), (np.concatenate(rows),
                                np.concatenate(cols))),
        shape=(N, N),
    )
    A = S
    kf = len(slot_qs)
    for layer in fold_qs:
        for q in layer:
            rr, cc, vv = plane_coo(kf, int(q))
            F = csr_matrix((vv, (rr, cc)), shape=(N, N))
            A = A + F @ A  # acc <- (I + F) acc, in application order
            kf += 1
    assert kf == S_total, "plane count mismatch vs slot/fold shifts"

    vm = np.asarray(vmask, np.float64).ravel()
    dv = np.asarray(invd, np.float64).ravel()
    valid = np.flatnonzero((vm > 0) & (dv > 0))
    if len(valid) == 0:
        raise ValueError("empty operator (no valid positions)")
    A = A[valid][:, valid]
    return _scaled_bounds(A, 1.0 / dv[valid], margin)


def cheb_coefficients(k: int, lmin: float, lmax: float):
    """Host-precomputed per-iteration scalars for the recurrence.

    Returns (inv_theta, c1, c2): d0 = inv_theta * z0;
    d_{i+1} = c1[i]*d_i + c2[i]*z_{i+1} for i in range(k-1). A solve of
    k iterations applies k position updates.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    if delta <= 0:  # single-point spectrum: plain Richardson
        return 1.0 / theta, np.zeros(max(k - 1, 0)), np.full(
            max(k - 1, 0), 1.0 / theta)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    c1 = np.empty(max(k - 1, 0))
    c2 = np.empty(max(k - 1, 0))
    for i in range(k - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        c1[i] = rho_new * rho
        c2[i] = 2.0 * rho_new / delta
        rho = rho_new
    return 1.0 / theta, c1, c2


def cheb_solve_reference(A_mul, invd_mul, b, x0, k, lmin, lmax):
    """Numpy reference of the k-iteration solve (tests/oracles).
    A_mul(x) applies A; invd_mul(r) applies the Jacobi preconditioner."""
    inv_theta, c1, c2 = cheb_coefficients(k, lmin, lmax)
    x = x0.copy()
    z = invd_mul(b - A_mul(x))
    d = inv_theta * z
    for i in range(k):
        x = x + d
        if i == k - 1:
            break
        z = z - invd_mul(A_mul(d))
        d = c1[i] * d + c2[i] * z
    return x
