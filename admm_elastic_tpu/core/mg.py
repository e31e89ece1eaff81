"""Host-side builder for the geometric multigrid preconditioner of the
sharded whole-mesh steppers (solver='mg': dia mode, grid meshes).

The reference's global step is an exact prefactored LDLT
(System.cpp:140). A fixed-budget Jacobi-PCG needs ~100 iterations to
match that exact solve at 100k-tet scale (f64 CPU budget study, PERF.md).
This module builds a two-coarse-level geometric multigrid whose EVERY
device operation is one the banded layout already performs:

  level matvec   — masked sparse-diagonal planes (static flat-index shifts)
  restriction    — R = sum_c M_c . shift(+c) over the 8 block corners
                   (per-corner 0/1 masks handle grid boundaries)
  prolongation   — P = R^T = sum_c shift(M_c . , -c)  (same masks: SPD)
  coarsest solve — L2 dofs packed to a (4,128) plane by per-q lane gathers
                   (static row slices; ~tiny ops), then an exact dense
                   inverse applied as 16 (1,128)@(128,128) matmuls

Coarse operators are Galerkin (P^T A P over 2x2x2 vertex blocks): for a
grid NUMBERING the coarse stencil offsets are 2x / 4x the fine strides, so
each coarse matvec is the same masked static-shift form as the fine dia
matvec. V(1,1) damped-Jacobi smoothing keeps the cycle symmetric (a valid
SPD CG preconditioner). Convergence on the 100k-tet beam A_hat: 1e-8 in
~25 PCG iterations vs ~300 Jacobi (prototyped host-side); the matched
ADMM budget drops from cg100 to ~mg8.
"""

from __future__ import annotations

import numpy as np

LANES = 128
NP2_ROWS = 4          # packed coarsest vector: (4, 128) = up to 512 dofs


def _grid_coords_and_strides(vertices, flat_tol=1e-6):
    """ijk integer grid coords per INTERNAL vertex id, plus the numbering
    strides (s_i, s_j, s_k) such that id == ijk @ s (a nested axis order —
    any of the 6). Returns (ijk (n,3), strides (3,), dims (3,)) or None."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    if n < 27:
        return None
    mins = v.min(axis=0)
    span = v.max(axis=0) - mins
    tol = flat_tol * max(span.max(), 1.0)
    axes = []
    for a in range(3):
        vals = np.sort(np.unique(np.round(v[:, a] / max(tol, 1e-300))))
        vals = vals * tol
        keep = [vals[0]]
        for q in vals[1:]:
            if q - keep[-1] > tol * 4:
                keep.append(q)
        axes.append(np.asarray(keep))
    dims = np.array([len(a) for a in axes])
    if dims.prod() != n or (dims < 2).sum() > 1:
        return None
    sizes = []
    for a in range(3):
        d = np.diff(axes[a])
        if d.size == 0:
            sizes.append(1.0)
            continue
        if np.abs(d - d[0]).max() > tol * 8:
            return None
        sizes.append(d[0])
    ijk = np.round((v - mins) / np.asarray(sizes)).astype(np.int64)
    if (ijk < 0).any() or (ijk >= dims).any():
        return None
    # solve id = ijk @ s + off: pick unit steps from the (0,0,0) corner
    strides = np.zeros(3, np.int64)
    ids = np.arange(n)
    lut = {t: i for i, t in enumerate(map(tuple, ijk))}
    base_ijk = ijk[int(np.argmin(ijk.sum(1)))]
    base = lut[tuple(base_ijk)]
    for a in range(3):
        if dims[a] == 1:
            strides[a] = 0
            continue
        t = base_ijk.copy()
        t[a] += 1
        nb = lut.get(tuple(t))
        if nb is None:
            return None
        strides[a] = nb - base
    off = ids - ijk @ strides
    if not (off == off[0]).all():
        return None
    return ijk, strides, dims


def _level_reps(ijk, dims, st):
    """Mask of representative vertices for stride `st` blocks."""
    return ((ijk[:, 0] % st == 0) & (ijk[:, 1] % st == 0)
            & (ijk[:, 2] % st == 0))


def _galerkin(A, ijk, dims, st):
    """A_coarse = P^T A P over st-blocks (0/1 P); also the coarse block
    grid dims and, per fine vertex, its coarse block id."""
    import scipy.sparse as sp

    cd = (dims + st - 1) // st
    blk = (ijk[:, 0] // st) + cd[0] * (ijk[:, 1] // st) \
        + cd[0] * cd[1] * (ijk[:, 2] // st)
    n = A.shape[0]
    P = sp.csr_matrix((np.ones(n), (np.arange(n), blk)),
                      shape=(n, int(cd.prod())))
    Ac = (P.T @ A @ P).tocsr()
    Ac.sum_duplicates()
    return Ac, cd, blk


def _masked_dia(Ac, pos_of_dof, n_pad):
    """Coarse matrix as masked dia planes in the FINE flat layout:
    entry (i,j) lives at fine position pos_of_dof[i], offset
    pos_of_dof[j]-pos_of_dof[i]. Returns (offsets tuple, values (D,n_pad))."""
    Acoo = Ac.tocoo()
    pi = pos_of_dof[Acoo.row]
    pj = pos_of_dof[Acoo.col]
    offs = pj - pi
    uoffs = np.unique(offs)
    vals = np.zeros((len(uoffs), n_pad))
    for d, o in enumerate(uoffs):
        m = offs == o
        vals[d, pi[m]] = Acoo.data[m]
    return tuple(int(o) for o in uoffs), vals


def _corner_masks(ijk, strides, dims, st_f, st_c, n_pad, rep_c):
    """Corner masks M_c for R = sum_c M_c . shift(+c) from the stride-st_f
    level onto the stride-st_c level: M_c[p] = 1 iff p is a stride-st_c
    rep and p + c is a stride-st_f rep inside p's block. Corner offsets c
    are in FINE FLAT INDEX units. The block ratio st_c//st_f may differ
    from 2 (aggressive coarsening for large 2D grids); flat axes
    (dims == 1) contribute no corners."""
    n = len(ijk)
    pos = np.arange(n)
    ratio = st_c // st_f
    assert st_c % st_f == 0
    out = []
    rng = [range(ratio) if dims[a] > 1 else range(1) for a in range(3)]
    for dz in rng[2]:
        for dy in rng[1]:
            for dx in rng[0]:
                d = np.array([dx, dy, dz]) * st_f
                c = int(d @ strides)
                child = ijk + d
                ok = rep_c & (child < dims).all(1)
                m = np.zeros(n_pad)
                m[pos[ok]] = 1.0
                # the child must itself be a fine-level rep (it is, by
                # construction: rep coords are multiples of st_f)
                out.append((c, m))
    return out


def _pack_plan(rep_pos, n_pad, np2_rows=NP2_ROWS):
    """Pack plan for the coarsest level: dofs ordered by position (rank),
    so the coarse row c_row = c//128 is NON-DECREASING across fine rows —
    at most TWO distinct c_rows touch any fine row. Pack/unpack therefore
    need only two full-plane lane-gathers each (assignment A = the lower
    c_row per fine row, B = the upper), plus 4 static row-range reductions
    (pack) / 4 static row-range broadcasts (unpack).

    Returns dict with (Nr,128) planes pack_idx/pack_mask/unpack_idx/
    unpack_mask for A and B, and static meta: per-assignment, for each
    coarse row cr, the fine-row range [start, stop) it owns."""
    Nr = n_pad // LANES
    c_ids = np.arange(len(rep_pos))
    p_row, p_lane = rep_pos // LANES, rep_pos % LANES
    c_row, c_lane = c_ids // LANES, c_ids % LANES

    crow_lo = np.zeros(Nr, np.int64)
    crow_hi = np.zeros(Nr, np.int64)
    prev = 0
    for r in range(Nr):
        m = p_row == r
        if m.any():
            crow_lo[r] = int(c_row[m].min())
            crow_hi[r] = int(c_row[m].max())
            prev = crow_hi[r]
        else:
            crow_lo[r] = crow_hi[r] = prev

    def assignment(which):
        own = crow_lo if which == "A" else crow_hi
        sel = c_row == own[p_row]
        if which == "B":
            sel &= crow_hi[p_row] != crow_lo[p_row]
        pidx = np.zeros((Nr, LANES), np.int32)
        pmask = np.zeros((Nr, LANES))
        pidx[p_row[sel], c_lane[sel]] = p_lane[sel]
        pmask[p_row[sel], c_lane[sel]] = 1.0
        uidx = np.zeros((Nr, LANES), np.int32)
        umask = np.zeros((Nr, LANES))
        uidx[p_row[sel], p_lane[sel]] = c_lane[sel]
        umask[p_row[sel], p_lane[sel]] = 1.0
        # contiguous fine-row range owned by each coarse row (only rows
        # that actually carry entries for B — the boundary rows)
        ranges = []
        for cr in range(np2_rows):
            rows = np.flatnonzero((own == cr) & pmask.any(1)) \
                if which == "B" else np.flatnonzero(own == cr)
            if len(rows):
                assert (np.diff(rows) == 1).all() or which == "B"
                ranges.append((int(rows.min()), int(rows.max()) + 1))
            else:
                ranges.append((0, 0))
        return pidx, pmask, uidx, umask, tuple(ranges)

    pA = assignment("A")
    pB = assignment("B")
    return {
        "pack_idx": np.stack([pA[0], pB[0]]),
        "pack_mask": np.stack([pA[1], pB[1]]),
        "unpack_idx": np.stack([pA[2], pB[2]]),
        "unpack_mask": np.stack([pA[3], pB[3]]),
        "rangesA": pA[4],
        "rangesB": pB[4],
    }


def _rho_dinv_a(A, iters=10, seed=0):
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


def build_grid_mg(A, vertices, n_pad, min_nodes=4096, level_strides=(2, 4),
                  np2_rows=NP2_ROWS):
    """Build the in-kernel MG package for CSR A_hat on a grid mesh whose
    INTERNAL numbering is a nested grid order. Returns (planes, meta) or
    None when the mesh does not qualify (not a full grid / nested order /
    coarsest too large).

    level_strides = (st1, st2): block strides of the two coarse levels
    (st2 % st1 == 0). The default (2, 4) is the 3D banded-kernel
    hierarchy; large 2D grids (cloth) use aggressive ladders like (2, 8)
    so the coarsest level still fits the packed dense solve
    (np2_rows * 128 dofs).

    planes (numpy, all (rows, 128)-reshapeable to n_pad flat):
      l1_vals (d1, n_pad), om_invd0/om_invd1 (n_pad,),
      t0/t1 corner masks (c0/c1, n_pad), pack planes (2, Nr, 128) x4,
      a2inv_blocks (np2^2, 128, 128)
    meta (static): offsets/corners/range lists + sizes."""
    got = _grid_coords_and_strides(vertices)
    if got is None:
        return None
    ijk, strides, dims = got
    n = A.shape[0]
    if n < min_nodes:
        return None  # Jacobi-CG is already exact-matched this small

    st1, st2 = level_strides
    A1, cd1, _ = _galerkin(A, ijk, dims, st1)
    A2, cd2, _ = _galerkin(A, ijk, dims, st2)
    if A2.shape[0] > np2_rows * LANES:
        return None  # coarsest exceeds the packed (np2_rows,128) plane

    rep1 = _level_reps(ijk, dims, st1)
    rep2 = _level_reps(ijk, dims, st2)
    pos = np.arange(n)

    # level-dof -> fine position (nested-order coarse dof numbering)
    def pos_of(rep, st, cd):
        rp = pos[rep]
        li = ijk[rp] // st
        dof = li[:, 0] + cd[0] * li[:, 1] + cd[0] * cd[1] * li[:, 2]
        out = np.zeros(int(cd.prod()), np.int64)
        out[dof] = rp
        return out

    pod1 = pos_of(rep1, st1, cd1)
    pod2 = pos_of(rep2, st2, cd2)

    l1_offs, l1_vals = _masked_dia(A1, pod1, n_pad)
    # no L2 matvec planes: the coarsest level is solved EXACTLY (packed
    # dense inverse), never smoothed

    om0 = 4.0 / (3.0 * _rho_dinv_a(A))
    om1 = 4.0 / (3.0 * _rho_dinv_a(A1))
    d0 = A.diagonal()
    om_invd0 = np.zeros(n_pad)
    om_invd0[:n] = om0 / np.where(d0 > 0, d0, 1.0)
    d1full = np.zeros(n_pad)
    d1v = A1.diagonal()
    d1full[pod1] = np.where(d1v > 0, d1v, 1.0)
    om_invd1 = np.where(d1full > 0, om1 / np.where(d1full > 0, d1full, 1), 0.0)

    t0 = _corner_masks(ijk, strides, dims, 1, st1, n_pad, rep1)
    t1 = _corner_masks(ijk, strides, dims, st1, st2, n_pad, rep2)

    # coarsest: rank-ordered dofs (ascending fine position) for the pack
    rp2 = np.sort(pos[rep2])
    # A2 is numbered in nested coarse order; permute to rank order
    perm = np.argsort(pod2)          # dofs sorted by fine position
    import scipy.sparse as sp
    Pp = sp.csr_matrix(
        (np.ones(len(perm)), (perm, np.arange(len(perm)))),
        shape=(len(perm), len(perm)),
    )
    A2r = (Pp.T @ A2 @ Pp).toarray()
    a2inv = np.linalg.inv(A2r)
    nc2 = A2.shape[0]
    npad2 = np2_rows * LANES
    a2inv_pad = np.zeros((npad2, npad2))
    a2inv_pad[:nc2, :nc2] = a2inv
    # np2^2 (128,128) blocks: z[tr] = sum_sr r[sr] @ B[sr*np2+tr]
    # with B[sr*np2+tr][sl, tl] = a2inv[tr*128+tl, sr*128+sl]
    blocks = np.zeros((np2_rows * np2_rows, LANES, LANES))
    for sr in range(np2_rows):
        for tr in range(np2_rows):
            blocks[sr * np2_rows + tr] = a2inv_pad[
                tr * LANES:(tr + 1) * LANES, sr * LANES:(sr + 1) * LANES
            ].T
    plan = _pack_plan(rp2, n_pad, np2_rows)

    planes = {
        "l1_vals": l1_vals,
        "om_invd0": om_invd0,
        "om_invd1": om_invd1,
        "t0_masks": np.stack([m for _, m in t0]),
        "t1_masks": np.stack([m for _, m in t1]),
        "pack_idx": plan["pack_idx"],
        "pack_mask": plan["pack_mask"],
        "unpack_idx": plan["unpack_idx"],
        "unpack_mask": plan["unpack_mask"],
        "a2inv_blocks": blocks,
    }
    meta = {
        "l1_offs": l1_offs,
        "t0_offs": tuple(c for c, _ in t0),
        "t1_offs": tuple(c for c, _ in t1),
        "rangesA": plan["rangesA"],
        "rangesB": plan["rangesB"],
        "nc2": int(nc2),
        "np2_rows": int(np2_rows),
        "level_strides": (int(st1), int(st2)),
        "levels": (int(n), int(A1.shape[0]), int(nc2)),
    }
    return planes, meta


# ----------------------------------------------------------------- numpy ref

def _shift_np(a, off):
    out = np.zeros_like(a)
    if off >= 0:
        out[: len(a) - off or None] = a[off:]
    else:
        out[-off:] = a[: len(a) + off]
    return out


def vcycle_np(planes, meta, fine_offs, fine_vals, r):
    """Numpy reference of the EXACT op sequence the kernel runs (for
    tests): r (n_pad,) -> z (n_pad,). fine_offs/fine_vals are the kernel's
    own dia planes (values padded to n_pad)."""
    def matvec(offs, vals, x):
        out = np.zeros_like(x)
        for d, o in enumerate(offs):
            out += vals[d] * _shift_np(x, o)
        return out

    def restrict(offs, masks, x):
        out = np.zeros_like(x)
        for c, m in zip(offs, masks):
            out += m * _shift_np(x, c)
        return out

    def prolong(offs, masks, x):
        out = np.zeros_like(x)
        for c, m in zip(offs, masks):
            out += _shift_np(m * x, -c)
        return out

    np2 = meta.get("np2_rows", NP2_ROWS)

    def pack(x):
        """Two full-plane lane-gathers + static row-range sums."""
        x2 = x.reshape(-1, LANES)
        out = np.zeros((np2, LANES))
        for w, ranges in ((0, meta["rangesA"]), (1, meta["rangesB"])):
            g = planes["pack_mask"][w] * np.take_along_axis(
                x2, planes["pack_idx"][w].astype(np.int64), axis=1
            )
            for cr, (lo, hi) in enumerate(ranges):
                if hi > lo:
                    out[cr] += g[lo:hi].sum(0)
        return out

    def unpack(zp, npad):
        """Two static row-range broadcasts + full-plane lane-gathers."""
        Nrl = npad // LANES
        out = np.zeros((Nrl, LANES))
        for w, ranges in ((0, meta["rangesA"]), (1, meta["rangesB"])):
            exp = np.zeros((Nrl, LANES))
            for cr, (lo, hi) in enumerate(ranges):
                if hi > lo:
                    exp[lo:hi] = zp[cr]
            out += planes["unpack_mask"][w] * np.take_along_axis(
                exp, planes["unpack_idx"][w].astype(np.int64), axis=1
            )
        return out.ravel()

    def coarse_solve(rp):
        z = np.zeros_like(rp)
        B = planes["a2inv_blocks"]
        for sr in range(np2):
            for tr in range(np2):
                z[tr] += rp[sr] @ B[sr * np2 + tr]
        return z

    t0o, t1o = meta["t0_offs"], meta["t1_offs"]
    t0m, t1m = planes["t0_masks"], planes["t1_masks"]
    l1o, l1v = meta["l1_offs"], planes["l1_vals"]

    z = planes["om_invd0"] * r
    res = r - matvec(fine_offs, fine_vals, z)
    r1 = restrict(t0o, t0m, res)
    z1 = planes["om_invd1"] * r1
    res1 = r1 - matvec(l1o, l1v, z1)
    r2 = restrict(t1o, t1m, res1)
    z2 = unpack(coarse_solve(pack(r2)), len(r))
    z1 = z1 + prolong(t1o, t1m, z2)
    z1 = z1 + planes["om_invd1"] * (r1 - matvec(l1o, l1v, z1))
    z = z + prolong(t0o, t0m, z1)
    z = z + planes["om_invd0"] * (r - matvec(fine_offs, fine_vals, z))
    return z
