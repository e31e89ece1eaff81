"""Windowed per-row-offset ELL ("uell") packing for ARBITRARY tet meshes.

The banded whole-timestep layout's global CG needs a matvec whose every
op is a full-plane vector op. For meshes whose numbering puts
A_hat on a bounded set of flat diagonals the sparse-DIAgonal form is ideal
(static shifts, 100% fill) — but a genuinely unstructured mesh (e.g. a
Delaunay tetrahedralization) admits NO numbering with a small shared offset
set: every vertex has its own stencil. This module provides the general
fallback format:

  A is stored as per-ROW-OFFSET ELL slots. A slot (q, k) holds at most one
  entry per LANDING position t: column lane plane cc and value plane val,
  both (Nr, 128). The matvec op is

      out += val * take_along_axis(row_shift(x, q), cc, axis=1)

  — a static row shift (q rows), one per-row lane gather and one
  multiply-add. Only the ROW distance
  q = row(col) - row(t) must match per slot; lanes are free per entry,
  which is exactly what an irregular stencil needs.

The slot count sum_q K_q is bounded by max_t (#neighbors of t at row
distance q), so a handful of high-degree "hub" rows would inflate every
plane. Hubs are SPLIT instead: the vertex ordering (x-slab spatial sort,
robust for any geometry) is diluted with spare slots, overflow entries land
on a nearby spare COPY position, and FOLD ops (same op shape, applied to
the matvec RESULT plane, deepest copies first) add each copy into its
parent. Copies are never read as sources, so no spread pass is needed; a
final multiply by the valid-mask plane zeroes the copy/spare positions so
the CG never sees phantom dofs.

Capacity per (t, q) is capped at a high quantile of the count distribution
(not the max): the distribution is flat, so capping at ~p99 trims the
planes that only exist for a few outlier rows at the cost of a few hundred
fold entries.

This keeps the banded whole-timestep layout available for ANY tet mesh —
the reference's topology-agnostic LDLT global step (System.cpp:140) has no
structure requirement either.
"""

from __future__ import annotations

import numpy as np

LANES = 128


def slab_order(vertices, slab_target=512):
    """Spatial ordering for arbitrary geometry: sort by x-slabs of
    ~slab_target vertices, then (y, z) within each slab. Keeps each
    vertex's neighbors within a bounded index band (~2 slabs) for any
    quasi-uniform mesh. Returns the permutation `order` (position k holds
    vertex order[k])."""
    v = np.asarray(vertices, np.float64)
    n = len(v)
    ox = np.argsort(v[:, 0], kind="stable")
    slab = np.empty(n, np.int64)
    slab[ox] = np.arange(n) // max(int(slab_target), 1)
    return np.lexsort((v[:, 2], v[:, 1], slab))


def _group_ranks(t, q):
    """Rank of each entry within its (t, q) group (stable order)."""
    key = t.astype(np.int64) * 4096 + (q + 2048)
    o = np.argsort(key, kind="stable")
    ks = key[o]
    starts = np.r_[0, np.flatnonzero(np.diff(ks)) + 1]
    lens = np.diff(np.r_[starts, len(ks)])
    r = np.arange(len(ks)) - np.repeat(starts, lens)
    out = np.empty(len(t), np.int64)
    out[o] = r
    return out


def pack_uell(rows, cols, vals, positions, n_pos, cap_quantile=0.99,
              dilute=8, max_slots=160, max_fold_layers=4,
              spare_pool=4096):
    """Pack a symmetric sparse matrix (COO over vertex ids) into per-q ELL
    slots + fold layers.

    rows/cols/vals: COO entries (both (i,j) and (j,i) present; diagonal
      included — the diagonal is NOT special-cased here, callers keep the
      Jacobi diag separately).
    positions: (n,) landing position of each vertex in the diluted
      numbering (spares interleaved); n_pos: total positions.
    Returns dict with:
      n_pad: padded position count (multiple of 8*LANES)
      slots: list of (q, cc (Nr,128) int32, val (Nr,128) f64)
      folds: list of layers, each a list of (q, cc, val) applied to the
        RESULT plane (deepest layer first)
      vmask-relevant: copies occupy spare positions; caller's valid mask
        must cover ONLY primary positions (copies excluded).
    Raises ValueError when the structure exceeds max_slots (caller falls
    back to the general path).
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    positions = np.asarray(positions, np.int64)

    t = positions[rows]
    s = positions[cols]
    v = vals.copy()

    # spare positions appended past the diluted numbering for hub-copy
    # overflow; small levels (core/uamg.py coarse operators) pass a small
    # pool so the plane row count tracks the level size
    cap_total = n_pos + int(spare_pool)
    free_mask = np.ones(cap_total, bool)
    free_mask[t] = False
    free_mask[s] = False
    free_mask[positions] = False

    fold_layers = []  # each: (t_arr, s_arr) parent <- copy
    caps = None
    for _layer in range(max_fold_layers + 1):
        q = s // LANES - t // LANES
        rk = _group_ranks(t, q)
        if caps is None:
            # per-q cap frozen from the INITIAL count distribution (a
            # recomputed quantile shrinks as entries move, which never
            # converges); q values first seen in later layers (copy
            # displacement) get a small default
            caps = {}
            for qq in np.unique(q):
                m = q == qq
                cnt = np.bincount(t[m])
                cnt = cnt[cnt > 0]
                caps[int(qq)] = max(int(np.quantile(cnt, cap_quantile)), 1)
        cap_arr = np.array([caps.get(int(qq), 2) for qq in q])
        over = rk >= cap_arr
        if not over.any():
            break
        if _layer == max_fold_layers:
            raise ValueError("uell: fold layers exceeded")
        # one copy per (t, q, chunk) of cap entries
        chunk = rk[over] // cap_arr[over]
        key = (t[over] * 4096 + (q[over] + 2048)) * 64 + chunk
        uk, grp = np.unique(key, return_inverse=True)
        ut = uk // (4096 * 64)
        free = np.flatnonzero(free_mask)
        used = np.zeros(len(free), bool)
        if len(free) < len(uk):
            raise ValueError("uell: out of spare positions")
        slots_alloc = np.empty(len(uk), np.int64)
        for m_i in np.argsort(ut, kind="stable"):
            tt = int(ut[m_i])
            f = np.searchsorted(free, tt)
            lo, hi = f - 1, f
            while lo >= 0 and used[lo]:
                lo -= 1
            while hi < len(free) and used[hi]:
                hi += 1
            cands = []
            if lo >= 0:
                cands.append((abs(int(free[lo]) - tt), lo))
            if hi < len(free):
                cands.append((abs(int(free[hi]) - tt), hi))
            if not cands:
                raise ValueError("uell: out of spare positions")
            ci = min(cands)[1]
            slots_alloc[m_i] = free[ci]
            used[ci] = True
            free_mask[free[ci]] = False
        # move overflow entries to their copy; record fold ops (parent <-
        # copy). Fold entries do NOT join the ELL entry set — they run in
        # the fold phase on the matvec result and have no per-slot cap.
        idx_over = np.flatnonzero(over)
        t[idx_over] = slots_alloc[grp]
        fold_layers.append((ut.copy(), slots_alloc.copy()))

    n_pad = -(-cap_total // (8 * LANES)) * (8 * LANES)
    Nr = n_pad // LANES

    def build(tt, ss, vv, fill=None):
        qv = ss // LANES - tt // LANES
        rkv = _group_ranks(tt, qv)
        out = []
        for qq in np.unique(qv):
            for k in range(int(rkv[qv == qq].max()) + 1):
                m = (qv == qq) & (rkv == k)
                if not m.any():
                    continue
                cc = np.zeros((Nr, LANES), np.int32)
                vp = np.zeros((Nr, LANES), np.float64)
                tm, sm, vm = tt[m], ss[m], vv[m]
                cc[tm // LANES, tm % LANES] = (sm % LANES).astype(np.int32)
                vp[tm // LANES, tm % LANES] = vm
                if fill is not None:
                    fill[0][m] = len(out)
                    fill[1][m] = tm // LANES
                    fill[2][m] = tm % LANES
                out.append((int(qq), cc, vp))
        return out

    # per-entry placement (plane, row, lane) in the ORIGINAL entry order —
    # lets callers refill the value planes for new values over the same
    # sparsity (e.g. per-scenario stiffness sweeps); the slot STRUCTURE
    # depends only on the pattern, never on the values
    n_entries = len(t)
    fill = (np.zeros(n_entries, np.int32), np.zeros(n_entries, np.int32),
            np.zeros(n_entries, np.int32))
    slots = build(t, s, v, fill)
    if len(slots) > max_slots:
        raise ValueError(
            f"uell: {len(slots)} slots exceed budget {max_slots}"
        )

    # fold ops layered: deepest copies fold first (layer L's copies may
    # have been split further by layer L+1, whose folds must land before
    # layer L's are read) -> apply layers in REVERSE creation order.
    folds = [
        build(ft, fs_, np.ones(len(ft)))
        for ft, fs_ in reversed(fold_layers)
    ]

    return {
        "n_pad": int(n_pad),
        "slots": slots,
        "folds": folds,
        "n_slots": len(slots),
        "n_fold_ops": sum(len(f) for f in folds),
        "fill": fill,
    }


def refill_uell_values(packed, vals):
    """Value planes for new entry values over packed's sparsity. `vals` is
    (..., n_entries) in the SAME entry order given to pack_uell. Returns
    (..., n_slots, Nr, 128) f64 — slot planes only (fold planes are
    value-independent weight-1 adds)."""
    plane, row, lane = packed["fill"]
    n_slots = packed["n_slots"]
    Nr = packed["n_pad"] // LANES
    vals = np.asarray(vals, np.float64)
    lead = vals.shape[:-1]
    out = np.zeros(lead + (n_slots, Nr, LANES), np.float64)
    out[..., plane, row, lane] = vals
    return out


def pack_uell_auto(rows, cols, vals, vertices, max_slots=160,
                   candidates=((128, 0.97), (128, 0.99), (64, 0.99),
                               (512, 0.99), (512, 0.97))):
    """Pack with the cheapest of several (slab_target, cap_quantile)
    candidates, measured by total plane count (slots + fold ops) — the
    per-CG-iteration matvec cost is linear in it. Packing is host-side
    and ~0.3 s per candidate at 100k tets, so trying a handful at init
    is cheap relative to compilation. On the delaunay100k mesh this picks
    68 planes where a fixed (512, 0.99) choice produces 89.

    Returns (packed, positions) for the best candidate, or raises
    ValueError when none fits max_slots."""
    best = None
    for slab_target, cq in candidates:
        order = slab_order(vertices, slab_target)
        positions, n_pos = dilute_positions(order)
        try:
            p = pack_uell(rows, cols, vals, positions, n_pos,
                          cap_quantile=cq, max_slots=max_slots)
        except ValueError:
            continue
        cost = p["n_slots"] + p["n_fold_ops"]
        if best is None or cost < best[0]:
            best = (cost, p, positions)
    if best is None:
        raise ValueError("uell: no candidate packing fits")
    return best[1], best[2]


def uell_matvec_np(packed, x):
    """Numpy reference of the kernel matvec (for tests): x is (n_pad,)
    over diluted positions; returns A@x over positions (copies already
    folded; spare/copy positions NOT masked — caller applies the valid
    mask)."""
    n_pad = packed["n_pad"]
    Nr = n_pad // LANES
    x2 = np.asarray(x, np.float64).reshape(Nr, LANES)

    def shift(q):
        out = np.zeros_like(x2)
        if q >= 0:
            out[: Nr - q or None] = x2[q:]
        else:
            out[-q:] = x2[: Nr + q]
        return out

    acc = np.zeros_like(x2)
    for qq, cc, vp in packed["slots"]:
        acc += vp * np.take_along_axis(shift(qq), cc, axis=1)
    for layer in packed["folds"]:
        for qq, cc, vp in layer:
            sh = np.zeros_like(acc)
            if qq >= 0:
                sh[: Nr - qq or None] = acc[qq:]
            else:
                sh[-qq:] = acc[: Nr + qq]
            acc = acc + vp * np.take_along_axis(sh, cc, axis=1)
    return acc.ravel()


def dilute_positions(order, dilute=8):
    """Positions for vertices in `order` with one spare slot interleaved
    per `dilute` real slots. Returns (positions (n,), n_pos)."""
    n = len(order)
    seq = np.empty(n, np.int64)
    seq[np.asarray(order, np.int64)] = np.arange(n)
    pos = seq + seq // max(int(dilute), 1)
    return pos, int(pos.max()) + 1
