"""Banded whole-timestep ADMM as one XLA program, element-sharded over a
device mesh with boundary-halo exchange (one device is the mesh of one).

The banded tet layout (core/banded.py) is split at the natural seam:

  * vertex rows are partitioned into CONTIGUOUS SLABS of Rloc rows per
    device (the banded numbering makes row locality = mesh locality);
  * each device owns the element chunks whose windows start in its slab
    (chunk windows span <= Wr rows, so they reach at most H halo rows
    into the next slab — core/banded.place_elements bounds this);
  * per ADMM iteration each device runs the local phase
    (`banded_local_rhs`: gather -> prox -> dual update -> conflict-free
    scatter -> anchors/collisions) over its chunks, then a single
    `ppermute` pushes the boundary RHS rows to their owner;
  * the global solve is row-local given Hb halo rows of the search
    direction (one neighbor `ppermute` exchange per iteration); the two
    CG scalars are `psum`s.

Per-device traffic per CG iteration is O(halo) = O(band width), NOT O(n):
the boundary-only halo-exchange design of SURVEY §2.7 (the reference's
reduction structure is the sparse D/D^T pair, System.cpp:54-62; its
OpenMP runtime has no distributed analog).

Scope: banded scenes (HyperElasticTet nh/stvk or LinearTetStrain,
StaticAnchors, analytic collisions, gravity kicks) in BOTH matvec
forms — sparse-diagonal (dia) AND the per-row-offset ELL fallback for
ARBITRARY topology (core/uell.py; slots/folds are row-distance-bounded,
so the same slab+halo seam applies with Hb = slot reach + fold reach).
Global solves: Jacobi-PCG (solver='cg'), dot-free Chebyshev
(solver='cheb', parallel/cheb.py) or sharded geometric multigrid
(solver='mg') — the latter two put no scalar collective on the
per-iteration critical path. Optional primal-residual collection.

Trajectory parity vs the general System path and across device counts:
tests/test_banded_spmd.py, tests/test_banded.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.banded import (
    CCP0, CP0, DB_PLANES, FB_PLANES, KP, LAMP, LANES, MUP, P2D_PLANES,
    PANCZ, PAW2, PINVD, PMASS, PP0, PVM, RRP0, RRPP0, SUB, W2P,
    BandedStepper, shifted,
)
from ..ops.lanes import newton_hyper, svd_columns
from ..utils.precision import highest


def _roundup(x, m):
    return -(-int(x) // m) * m


def _same_coll(a, b):
    """Collision config equality (shape geometry is baked into the
    compiled program as constants, so an edit needs a re-jit; the tuples
    are already canonical (str, floats...) pairs)."""
    return a.coll_shapes == b.coll_shapes and a.coll_w2 == b.coll_w2


def _band_reach(dia_offs):
    """Max row reach of the sparse-diagonal matvec (see core/banded
    shifted: offset 128q + s reads rows r±q and r±(q+1) when s != 0)."""
    reach = 1
    for off in dia_offs:
        q, s = divmod(abs(int(off)), LANES)
        reach = max(reach, q + (1 if s else 0))
    return reach


def _chunk_half_body(fbp, dbp, mats, xw, model, newton_iters, Wr,
                     collect, bw_acc):
    """One row-half of the chunk phase (element-parallel local step).

    fbp(plane) -> (HS,128) static element plane; dbp: 12 dual planes
    (HS,128); mats: (w2, mu, lam, k) material planes; xw: [3] (Wr,128)
    vertex-window rows of live x. Calls bw_acc(a, vr, (1,128) add) for
    every scatter contribution and returns (db_new 12 planes, r2) with
    r2 the primal-residual piece (None unless collect).

    Reference local step TetForce.cpp:303-364 + dual update
    System.cpp:57-58."""
    HS = dbp[0].shape[0]
    cc = [fbp(CCP0 + k).astype(jnp.int32) for k in range(4)]
    rr = [fbp(RRP0 + k) for k in range(4)]
    xg = [[jnp.zeros((HS, LANES), xw[0].dtype) for _ in range(3)]
          for _ in range(4)]
    for k in range(4):
        for r in range(Wr):
            m = rr[k] == float(r)
            for a in range(3):
                t = jnp.take_along_axis(
                    jnp.broadcast_to(xw[a][r:r + 1, :], (HS, LANES)),
                    cc[k], axis=1,
                )
                xg[k][a] = xg[k][a] + jnp.where(m, t, 0.0)

    cp = [fbp(CP0 + p) for p in range(12)]
    u = dbp[:9]
    f = []
    for a in range(3):
        for b in range(3):
            acc = u[3 * a + b]
            for k in range(4):
                acc = acc + cp[4 * b + k] * xg[k][a]
            f.append(acc)

    eps = jnp.asarray(jnp.finfo(f[0].dtype).eps, f[0].dtype)
    U, V, s = svd_columns(f, eps)

    db_new = list(dbp)
    up = [None] * 9
    if model in ("nh", "stvk"):
        # warm-start guards (TetForce.cpp:339-347)
        w1 = dbp[9]
        w2_ = dbp[10]
        neg3 = dbp[11] < 0.0
        w3 = jnp.abs(dbp[11])
        collapsed = (~neg3) & (
            (jnp.abs(w1) < 1e-3) & (jnp.abs(w2_) < 1e-3)
            & (jnp.abs(w3) < 1e-3)
        )
        w1 = jnp.where(collapsed, 1e-3, w1)
        w2_ = jnp.where(collapsed, 1e-3, w2_)
        w3 = jnp.where(collapsed, 1e-3, w3)
        mu, lam, kp = mats[1], mats[2], mats[3]
        x1, x2, x3 = newton_hyper(
            s, (w1, w2_, w3), mu, lam, kp, newton_iters, model)
        db_new[9], db_new[10], db_new[11] = x1, x2, x3
        sig = (x1, x2, x3)
        for r in range(3):
            for c2 in range(3):
                z = (
                    U[0][r] * sig[0] * V[0][c2]
                    + U[1][r] * sig[1] * V[1][c2]
                    + U[2][r] * sig[2] * V[2][c2]
                )
                up[3 * r + c2] = f[3 * r + c2] - z
    else:  # arap
        one = jnp.ones_like(s[0])
        s3 = jnp.where(s[2] < 0, -one, one)
        sig = (one, one, s3)
        w2e, kp = mats[0], mats[3]
        mix = 1.0 / (w2e + jnp.where(w2e + kp > 0, kp, 1.0))
        for r in range(3):
            for c2 in range(3):
                proj = (
                    U[0][r] * sig[0] * V[0][c2]
                    + U[1][r] * sig[1] * V[1][c2]
                    + U[2][r] * sig[2] * V[2][c2]
                )
                z = (kp * proj + w2e * f[3 * r + c2]) * mix
                up[3 * r + c2] = f[3 * r + c2] - z

    r2 = None
    if collect:
        w2r = mats[0]
        r2 = sum(
            jnp.sum(w2r * (up[p] - u[p]) * (up[p] - u[p]))
            for p in range(9)
        )
    db_new[:9] = up

    # scatter b += w2 D^T (z - u'); (z - u') = F - 2 u'
    w2e = mats[0]
    zu = [w2e * (f[p] - 2.0 * up[p]) for p in range(9)]
    for k in range(4):
        Pk = fbp(PP0 + k).astype(jnp.int32)
        rrp = fbp(RRPP0 + k)
        for a in range(3):
            acc = cp[4 * 0 + k] * zu[3 * a + 0]
            for b in range(1, 3):
                acc = acc + cp[4 * b + k] * zu[3 * a + b]
            sp = jnp.take_along_axis(acc, Pk, axis=1)
            for vr in range(Wr):
                m = rrp == float(vr)
                bw_acc(a, vr, jnp.sum(jnp.where(m, sp, 0.0),
                                      axis=0, keepdims=True))
    return db_new, r2


def _anchor_coll_body(x3, au3, cu3, aw2, ancz3, vmask, coll_shapes,
                      coll_w2, collect):
    """Row-local anchor + collision projections and dual updates.

    x3/au3/cu3: [3] (R,128) planes; aw2/vmask: (R,128); ancz3: [3].
    Returns (b_add [3], au_new [3], cu_new [3], r2)
    (AnchorForce.cpp:46-55, CollisionForce.cpp:53-70)."""
    r2 = jnp.asarray(0.0, x3[0].dtype) if collect else None
    b_add = []
    au_new = []
    for a in range(3):
        dlt = x3[a] - ancz3[a]
        # gated: non-anchor rows otherwise accumulate x - ancz forever
        au = jnp.where(aw2 > 0, au3[a] + dlt, 0.0)
        au_new.append(au)
        b_add.append(aw2 * (ancz3[a] - au))
        if collect:
            r2 = r2 + jnp.sum(aw2 * dlt * dlt)

    cu_new = list(cu3)
    if len(coll_shapes):
        zc = [x3[a] + cu3[a] for a in range(3)]
        for kind, prm in coll_shapes:
            if kind == "floor":
                zc[1] = jnp.maximum(zc[1], prm[0])
            elif kind == "sphere":
                cx, cy, cz, r = prm
                dx, dy, dz = zc[0] - cx, zc[1] - cy, zc[2] - cz
                d2 = dx * dx + dy * dy + dz * dz
                inside = d2 < r * r
                s_ = r * jax.lax.rsqrt(jnp.maximum(d2, 1e-30))
                zc[0] = jnp.where(inside, cx + dx * s_, zc[0])
                zc[1] = jnp.where(inside, cy + dy * s_, zc[1])
                zc[2] = jnp.where(inside, cz + dz * s_, zc[2])
            elif kind == "cylinder":
                cx, cy, r = prm
                dx, dy = zc[0] - cx, zc[1] - cy
                d2 = dx * dx + dy * dy
                inside = d2 < r * r
                s_ = r * jax.lax.rsqrt(jnp.maximum(d2, 1e-30))
                zc[0] = jnp.where(inside, cx + dx * s_, zc[0])
                zc[1] = jnp.where(inside, cy + dy * s_, zc[1])
        for a in range(3):
            dlt = x3[a] - zc[a]
            un = cu3[a] + dlt
            cu_new[a] = un
            b_add[a] = b_add[a] + coll_w2 * vmask * (zc[a] - un)
            if collect:
                r2 = r2 + jnp.sum(coll_w2 * vmask * dlt * dlt)
    return b_add, au_new, cu_new, r2


@functools.partial(
    jax.jit,
    static_argnames=("Wr", "model", "newton_iters", "coll_shapes",
                     "coll_w2", "collect"),
)
def banded_local_rhs(p2d, rbase, fblk, x, au, cu, d, *, Wr, model,
                     newton_iters, coll_shapes=(), coll_w2=0.0,
                     collect=False):
    """One ADMM iteration's element pipeline (gather -> hyperelastic prox
    -> dual update -> conflict-free scatter) plus the row-local anchor and
    collision projections, without the global solve: vmap over chunks and
    a sequential window accumulation.

    p2d: (P2D_PLANES*Lr,128); rbase: (n_chunks,) int32 LOCAL window base
    rows; fblk: (n_chunks, FB_PLANES*SUB, 128); x/au/cu: (3*Lr,128);
    d: (n_chunks, DB_PLANES*SUB, 128).
    Returns (b, au', cu', d', r2) where b = D^T W^2 (z - u') summed over
    every constraint (3*Lr,128) and r2 the primal-residual square
    (zero unless collect)."""
    Lr = x.shape[0] // 3
    n_chunks = fblk.shape[0]
    Wr = int(Wr)

    def one_chunk(fb, db, rb):
        rb = rb.astype(jnp.int32)
        xw3 = [jax.lax.dynamic_slice(
                   x, (jnp.int32(a * Lr) + rb, jnp.int32(0)), (Wr, LANES))
               for a in range(3)]
        fbp = lambda p: fb[p * SUB:(p + 1) * SUB]
        dbp = [db[p * SUB:(p + 1) * SUB] for p in range(DB_PLANES)]
        mats = tuple(fbp(p) for p in (W2P, MUP, LAMP, KP))
        rows = [jnp.zeros((1, LANES), x.dtype) for _ in range(3 * Wr)]

        def bw_acc(a, vr, row):
            rows[a * Wr + vr] = rows[a * Wr + vr] + row

        db_new, r2 = _chunk_half_body(
            fbp, dbp, mats, xw3, str(model), int(newton_iters), Wr,
            bool(collect), bw_acc,
        )
        bw = jnp.concatenate(rows, 0)
        return bw, jnp.concatenate(db_new, 0), (
            r2 if collect else jnp.asarray(0.0, x.dtype))

    bws, d_new, r2s = jax.vmap(one_chunk)(fblk, d, rbase)

    def add_chunk(i, b):
        rb = rbase[i].astype(jnp.int32)
        for a in range(3):
            r0 = jnp.int32(a * Lr) + rb
            cur = jax.lax.dynamic_slice(b, (r0, jnp.int32(0)),
                                        (Wr, LANES))
            b = jax.lax.dynamic_update_slice(
                b, cur + bws[i, a * Wr:(a + 1) * Wr], (r0, jnp.int32(0))
            )
        return b

    b = jax.lax.fori_loop(0, n_chunks, add_chunk,
                          jnp.zeros((3 * Lr, LANES), x.dtype))

    sr = lambda a: slice(a * Lr, (a + 1) * Lr)
    b_add, au_new, cu_new, r2a = _anchor_coll_body(
        [x[sr(a)] for a in range(3)],
        [au[sr(a)] for a in range(3)],
        [cu[sr(a)] for a in range(3)],
        p2d[PAW2 * Lr:(PAW2 + 1) * Lr],
        [p2d[(PANCZ + a) * Lr:(PANCZ + a + 1) * Lr] for a in range(3)],
        p2d[PVM * Lr:(PVM + 1) * Lr],
        tuple(coll_shapes), float(coll_w2), bool(collect),
    )
    b = jnp.concatenate([b[sr(a)] + b_add[a] for a in range(3)], 0)
    au_n = jnp.concatenate(au_new, 0)
    cu_n = jnp.concatenate(cu_new, 0)
    r2 = (jnp.sum(r2s) + r2a) if collect else jnp.asarray(0.0, x.dtype)
    return b, au_n, cu_n, d_new, r2


def _pad_chunk_template(dtype):
    """An all-pad element chunk: w2 = 0 (no scatter/RHS weight), benign
    materials mu = lam = k = 1 (keeps the Newton prox finite on the
    zero deformation the pad elements see), rrp = -1 (no scatter
    targets). Mirrors the pad-lane convention of core/banded."""
    fb = np.zeros((FB_PLANES * SUB, LANES), np.float64)
    for p in (MUP, LAMP, KP):
        fb[p * SUB:(p + 1) * SUB] = 1.0
    for k in range(4):
        fb[(RRPP0 + k) * SUB:(RRPP0 + k + 1) * SUB] = -1.0
    return fb.astype(dtype)


class ShardedBandedStepper:
    """Distribute an initialized single-device BandedStepper over a mesh
    axis. Build via `sharded_banded_from_system` (or directly from a
    qualifying BandedStepper).

    Usage:
        mesh = jax.make_mesh((8,), ("elem",))
        out = sharded_banded_from_system(system, mesh)  # or None
        spmd, to_canonical = out
        spmd.run(10)
        x = spmd.x   # (n, 3) in the stepper's internal numbering
    """

    model_name = "banded_spmd"
    #: steps fused into one lax.scan program by run() (one dispatch per
    #: window instead of one per step)
    ROLLOUT_WINDOW = 10

    def __init__(self, base: BandedStepper, mesh, axis: str = "elem",
                 solver: str = "cg",
                 cheb_iters: int | None = None, mg_cycles: int = 10,
                 system=None):
        if base._uell is not None and solver == "mg":
            raise ValueError(
                "sharded uell path: geometric multigrid needs a grid "
                "mesh; use solver='cheb' (dot-free, spectral bounds "
                "from the slot/fold planes) or 'cg' on arbitrary "
                "topology"
            )
        if base.collect_residuals is True:
            raise ValueError(
                "sharded banded path collects 'primal' residuals only"
            )
        self.base = base
        self.mesh = mesh
        #: a single mesh-axis name, or a TUPLE of names for a two-level
        #: ('host','chip') hierarchy: slabs partition over the flattened
        #: product axis host-major, so intra-host neighbor exchanges ride
        #: the fast 'chip' (ICI) links and only the D/hosts slab
        #: boundaries that fall between hosts cross the slow ('host',
        #: DCN) level — comm_stats reports the per-level split
        #: (SURVEY §2.7's ICI/DCN prescription)
        self.axis = axis
        if isinstance(axis, (tuple, list)):
            self.axis = tuple(axis)
            self.D = int(np.prod([mesh.shape[a] for a in self.axis]))
        else:
            self.D = int(mesh.shape[axis])
        if solver not in ("cg", "cheb", "mg"):
            raise ValueError(
                f"solver must be 'cg', 'cheb' or 'mg', got {solver}")
        if solver == "mg" and system is None:
            raise ValueError(
                "solver='mg' needs the originating System (pass system= "
                "or build via sharded_banded_from_system) — the sharded "
                "V-cycle planes are built from its assembled operator"
            )
        self._system = system
        self.mg_cycles = int(mg_cycles)
        #: 'cg' = Jacobi-PCG (two psum scalars per iteration);
        #: 'cheb' = dot-product-free Chebyshev (parallel/cheb.py): NO
        #: cross-device scalars in the whole solve (psum latency off the
        #: critical path; the recurrence is pure fused elementwise work)
        self.solver = solver
        self.cheb_iters = int(cheb_iters or base.cg_iters)
        self.model = base.model
        self.dt = base.dt
        self.admm_iters = base.admm_iters
        self.cg_iters = base.cg_iters
        self.collect_residuals = bool(base.collect_residuals)
        #: (admm_iters,) primal residuals of the last step (collect mode)
        self.last_primal = None
        self._build()
        self._stepf = None
        self._runf = {}

    # ------------------------------------------------------------- build

    def _build(self):
        base = self.base
        D = self.D
        Nr = base.Nr
        Wr = base.Wr
        dtype = base.dtype

        Rloc = _roundup(-(-Nr // D), 8)
        Ng = D * Rloc
        if base._uell is not None:
            # per-row-offset ELL matvec reach: slot row shifts, plus the
            # SEQUENTIAL fold layers each consuming their own reach of
            # result-plane validity (core/uell.py layout)
            slot_qs = base._uell_slot_qs
            fold_qs = base._uell_fold_qs
            Hb = max(1, max((abs(q) for q in slot_qs), default=0)
                     + sum(max((abs(q) for q in layer), default=0)
                           for layer in fold_qs))
        else:
            Hb = _band_reach(base.dia_offs)
        mg_host = None
        mg_reach_max = 0
        if self.solver == "mg":
            mg_host = self._mg_host_build()
            mg_reach_max = max(self._mg_reach.values())
        H = _roundup(max(Wr, Hb, mg_reach_max), 8)
        if Hb > Rloc:
            # the per-CG-iteration exchange must stay single-hop (its
            # cost sets the scaling efficiency); element windows may
            # span several slabs (multi-hop x refresh / RHS combine,
            # amortized once per ADMM iteration)
            raise ValueError(
                f"sharded banded path: band reach {Hb} rows exceeds "
                f"the {Rloc}-row slab — too many devices for this mesh "
                f"({Nr} vertex rows over {D} devices)"
            )
        Lr = Rloc + 2 * H
        self.Rloc, self.H, self.Hb, self.Lr = Rloc, H, Hb, Lr

        def slab_planes(arr, n_planes, fills=0.0):
            """(n_planes*Nr, 128) -> (D, n_planes*Lr, 128) slabs with
            halo; rows outside [0, Ng) padded with the per-plane fill."""
            a = np.asarray(arr, np.float64).reshape(n_planes, Nr, LANES)
            fills = np.broadcast_to(np.asarray(fills, np.float64),
                                    (n_planes,))
            full = np.empty((n_planes, Ng + 2 * H, LANES))
            for p in range(n_planes):
                full[p] = fills[p]
                full[p, H:H + Nr] = a[p]
            out = np.empty((D, n_planes, Lr, LANES))
            for d in range(D):
                # global rows [d*Rloc - H, (d+1)*Rloc + H) = full rows
                # [d*Rloc, d*Rloc + Lr)
                out[d] = full[:, d * Rloc:d * Rloc + Lr]
            return out.reshape(D, n_planes * Lr, LANES)

        # p2d: zero anchor weights + collision mask OUTSIDE owned rows so
        # halo rows contribute nothing (their owner computes them)
        p2d = slab_planes(
            np.asarray(base._p2d, np.float64), P2D_PLANES,
            fills=[0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        ).reshape(D, P2D_PLANES, Lr, LANES)
        for pp in (PAW2, PVM):
            p2d[:, pp, :H] = 0.0
            p2d[:, pp, H + Rloc:] = 0.0
        self._p2d = jnp.asarray(
            p2d.reshape(D, P2D_PLANES * Lr, LANES), dtype
        )

        if base._uell is not None:
            slot_qs = base._uell_slot_qs
            fold_qs = base._uell_fold_qs
            S_total = len(slot_qs) + sum(len(l) for l in fold_qs)
            self._dia = jnp.asarray(
                slab_planes(np.asarray(base._dia2d, np.float64),
                            S_total), dtype)
            if base._uell_packed:
                n_words = -(-S_total // 4)
                words = np.asarray(base._ucc2d, np.int64).reshape(
                    n_words, Nr, LANES)
                ccs = np.empty((S_total, Nr, LANES), np.int64)
                for k in range(S_total):
                    w, b = divmod(k, 4)
                    ccs[k] = (words[w] >> (8 * b)) & 0xFF
            else:
                ccs = np.asarray(base._ucc2d, np.int64).reshape(
                    S_total, Nr, LANES)
            self._ucc = jnp.asarray(
                slab_planes(ccs.reshape(S_total * Nr, LANES),
                            S_total).astype(np.int32))
        else:
            n_dia = len(base.dia_offs)
            self._dia = jnp.asarray(
                slab_planes(np.asarray(base._dia2d, np.float64), n_dia),
                dtype,
            )
            self._ucc = None
        self.dia_offs = base.dia_offs

        # ---- chunk ownership: device of the window base row
        rbase_g = np.asarray(base._rbase, np.int64)
        n_chunks = base.n_chunks
        owner = np.clip(rbase_g // Rloc, 0, D - 1)
        fblk_np = np.asarray(base._fblk, np.float64)
        d_np = np.asarray(base.state["d"], np.float64)
        per_dev = [np.flatnonzero(owner == d) for d in range(D)]
        C = max(1, max(len(ix) for ix in per_dev))
        fb_pad = _pad_chunk_template(np.float64)
        db_pad = np.concatenate([
            np.zeros((9 * SUB, LANES)), np.ones((3 * SUB, LANES))
        ], 0)
        fblk_l = np.empty((D, C, FB_PLANES * SUB, LANES))
        d_l = np.empty((D, C, DB_PLANES * SUB, LANES))
        rbase_l = np.zeros((D, C), np.int32)
        self._chunk_of = per_dev  # device -> global chunk ids (for x prop)
        for d in range(D):
            ix = per_dev[d]
            for j in range(C):
                if j < len(ix):
                    fblk_l[d, j] = fblk_np[ix[j]]
                    d_l[d, j] = d_np[ix[j]]
                    rbase_l[d, j] = rbase_g[ix[j]] - (d * Rloc - H)
                else:
                    fblk_l[d, j] = fb_pad
                    d_l[d, j] = db_pad
                    rbase_l[d, j] = 0
        self.n_chunks_local = C
        self._fblk = jnp.asarray(fblk_l, dtype)
        self._rbase = jnp.asarray(rbase_l)

        own = np.zeros((Lr, LANES))
        own[H:H + Rloc] = 1.0
        self._own = jnp.asarray(own, dtype)

        def state3(planes):
            return jnp.asarray(
                slab_planes(np.asarray(planes, np.float64), 3), dtype
            )

        if self.solver == "mg":
            self._build_mg(slab_planes, mg_host)

        if self.solver == "cheb":
            from .cheb import (cheb_coefficients, dia_operator_bounds,
                               uell_operator_bounds)

            if base._uell is not None:
                # arbitrary topology: bounds from the slot/fold planes
                # themselves (the planes ARE the operator); invd is the
                # exact Jacobi D the recurrence applies
                p2d_host = np.asarray(base._p2d, np.float64).reshape(
                    P2D_PLANES, Nr, LANES)
                lmin, lmax = uell_operator_bounds(
                    np.asarray(base._dia2d, np.float64).reshape(
                        S_total, Nr, LANES),
                    ccs, slot_qs, fold_qs,
                    p2d_host[PVM], p2d_host[PINVD])
            else:
                dia_np = np.asarray(base._dia2d, np.float64).reshape(
                    len(base.dia_offs), Nr, LANES)
                lmin, lmax = dia_operator_bounds(dia_np, base.dia_offs)
            #: measured spectral interval of D^{-1}A (margins applied)
            self.cheb_bounds = (lmin, lmax)
            inv_theta, c1, c2 = cheb_coefficients(
                self.cheb_iters, lmin, lmax)
            self._cheb_c = (float(inv_theta),
                            jnp.asarray(c1, dtype), jnp.asarray(c2, dtype))

        self.state = {
            "x": state3(base.state["x"]),
            "v": state3(base.state["v"]),
            "ancu": state3(base.state["ancu"]),
            "colu": state3(base.state["colu"]),
            "d": jnp.asarray(d_l, dtype),
            "t": jnp.asarray(0.0, dtype),
        }
        shd = NamedSharding(self.mesh, P(self.axis))
        self._slab3 = lambda planes: jax.device_put(  # noqa: E731
            state3(planes), shd)
        self.state = {
            # "t" rides replicated: leaving it UN-placed makes the
            # post-step sharding differ from the input's and forces a
            # silent second compile of the whole step
            k: jax.device_put(
                v, shd if k != "t" else NamedSharding(self.mesh, P()))
            for k, v in self.state.items()
        }
        for nm in ("_p2d", "_dia", "_fblk", "_rbase"):
            setattr(self, nm, jax.device_put(getattr(self, nm), shd))
        if self._ucc is not None:
            self._ucc = jax.device_put(self._ucc, shd)

    def _mg_host_build(self):
        """Host phase of the sharded geometric-multigrid build
        assemble the operator from the
        originating System, build the core/mg.py package, and record
        static offsets/reaches (the slab layout sizes its halo from
        these — hence this runs BEFORE the slab phase).

        Every V-cycle operation in core/mg.py is a masked static
        flat-index shift in the FINE layout (coarse dofs live at their
        representative fine positions), so each one shards with the
        same slab+halo machinery as the dia matvec — the only
        cross-device data the cycle itself needs is ONE psum of the
        packed coarsest residual, (3, np2, 128) ≈ KBs, after which the
        dense coarsest inverse is applied REPLICATED on every device
        (the coarse level is tiny). The Richardson outer loop
        (x += Vcycle(b - A x)) has no inner products, so like the
        Chebyshev solver the step compiles with no scalar all-reduce —
        the KB-sized pack psum is the only non-ppermute collective."""
        import jax as _jax

        from ..core.mg import build_grid_mg
        from ..core.solver import _assemble_A_hat_csr

        base = self.base
        sysm = self._system
        n_pad = base.Nr * LANES

        cparams = {
            k: {kk: np.asarray(_jax.device_get(vv))
                for kk, vv in sysm.params[k].items()}
            for k in sysm._constraint_names
        }
        A = _assemble_A_hat_csr(
            sysm.n_nodes, sysm._mi, sysm.settings.timestep_s, cparams
        ).tocsr()
        got = build_grid_mg(A, np.asarray(sysm._xi), n_pad, min_nodes=0)
        if got is None:
            raise ValueError(
                "solver='mg': the mesh is not a full grid in nested "
                "numbering (build_grid_mg rejected it)"
            )
        mgp, mgm = got
        self.mg_levels = mgm["levels"]

        def reach(offs):
            nz = [o for o in offs if o]
            return _band_reach(nz) if nz else 0

        self._mg_offs = {
            "l1": tuple(mgm["l1_offs"]),
            "t0": tuple(mgm["t0_offs"]),
            "t1": tuple(mgm["t1_offs"]),
        }
        self._mg_reach = {
            "fine": _band_reach(base.dia_offs),
            "l1": reach(mgm["l1_offs"]),
            "t0": reach(mgm["t0_offs"]),
            "t1": reach(mgm["t1_offs"]),
        }

        # Chebyshev acceleration of the V-cycle (still dot-free): plain
        # Richardson stalls on the slow tail mode (measured rho(I-BA)
        # ~0.85 on the anchored beam — anchor-weight modes the coarse
        # correction under-resolves); Chebyshev over the measured
        # preconditioned interval recovers ~0.5/cycle. One-time host
        # power iteration on I - B A estimates the tail.
        from ..core.mg import vcycle_np
        from .cheb import cheb_coefficients

        fv = np.asarray(base._dia2d, np.float64).reshape(
            len(base.dia_offs), n_pad)

        def _sh(x, o):
            out = np.zeros_like(x)
            if o > 0:
                out[:-o] = x[o:]
            elif o < 0:
                out[-o:] = x[:o]
            else:
                out[:] = x
            return out

        def matv(x):
            return sum(fv[d] * _sh(x, o)
                       for d, o in enumerate(base.dia_offs))

        n = sysm.n_nodes
        rng = np.random.default_rng(0)
        x = np.zeros(n_pad)
        x[:n] = rng.standard_normal(n)
        rho = 0.0
        for _ in range(40):
            y = x - vcycle_np(mgp, mgm, base.dia_offs, fv, matv(x))
            y[n:] = 0.0
            ny = np.linalg.norm(y)
            if ny == 0:
                break
            rho = ny / np.linalg.norm(x)
            x = y / ny
        lmin = max(1.0 - rho, 1e-3) * 0.9
        lmax = 1.02
        inv_theta, c1, c2 = cheb_coefficients(self.mg_cycles, lmin, lmax)
        #: measured V-cycle convergence factor + the cheb schedule
        self.mg_rho = float(rho)
        self._mg_cheb = (float(inv_theta),
                         tuple(float(q) for q in c1),
                         tuple(float(q) for q in c2))
        return mgp, mgm

    def _build_mg(self, slab_planes, mg_host):
        """Slab phase: distribute the host-built MG planes over the
        device mesh (value/mask planes with real halo copies, pack/
        unpack index planes, per-device pack one-hots, replicated
        coarsest inverse)."""
        base = self.base
        D = self.D
        Nr, Rloc = base.Nr, self.Rloc
        dtype = base.dtype
        n_pad = Nr * LANES
        mgp, mgm = mg_host
        np2 = int(mgm["np2_rows"])
        # value planes, slabbed with real halo values (masks/vals are
        # static data — the halo copy is exact, no exchange needed)
        n_l1 = len(mgm["l1_offs"])
        n_t0 = len(mgm["t0_offs"])
        n_t1 = len(mgm["t1_offs"])
        stack = np.concatenate([
            np.asarray(mgp["l1_vals"], np.float64).reshape(n_l1, n_pad),
            np.asarray(mgp["om_invd0"], np.float64)[None],
            np.asarray(mgp["om_invd1"], np.float64)[None],
            np.asarray(mgp["t0_masks"], np.float64).reshape(n_t0, n_pad),
            np.asarray(mgp["t1_masks"], np.float64).reshape(n_t1, n_pad),
            np.asarray(mgp["pack_mask"], np.float64).reshape(2, n_pad),
            np.asarray(mgp["unpack_mask"], np.float64).reshape(2, n_pad),
        ], 0).reshape(-1, LANES)
        n_mgf = stack.shape[0] // Nr
        self._mg_nplanes = (n_l1, n_t0, n_t1)
        self._mgf_s = jnp.asarray(slab_planes(stack, n_mgf), dtype)
        idx = np.concatenate([
            np.asarray(mgp["pack_idx"], np.int64).reshape(2, n_pad),
            np.asarray(mgp["unpack_idx"], np.int64).reshape(2, n_pad),
        ], 0).reshape(-1, LANES)
        self._mgi_s = jnp.asarray(
            slab_planes(idx, 4).astype(np.int32))
        # replicated coarsest inverse blocks
        self._a2b_r = jnp.asarray(
            np.asarray(mgp["a2inv_blocks"], np.float64), dtype)
        # per-device pack/unpack row->coarse-row assignment one-hots:
        # E[w, cr, local_row] = 1 iff global row owns coarse row cr under
        # assignment w (core/mg._pack_plan rangesA/B)
        E = np.zeros((D, 2, np2, Rloc))
        for w, ranges in enumerate((mgm["rangesA"], mgm["rangesB"])):
            for cr, (lo, hi) in enumerate(ranges):
                for g in range(lo, hi):
                    d, r = divmod(g, Rloc)
                    if d < D:
                        E[d, w, cr, r] = 1.0
        self._mgE = jnp.asarray(E, dtype)
        shd = NamedSharding(self.mesh, P(self.axis))
        for nm in ("_mgf_s", "_mgi_s", "_mgE"):
            setattr(self, nm, jax.device_put(getattr(self, nm), shd))
        self._a2b_r = jax.device_put(
            self._a2b_r, NamedSharding(self.mesh, P()))

    # ------------------------------------------------------------ access

    @property
    def x(self):
        return self._gather_planes(self.state["x"])

    @property
    def v(self):
        return self._gather_planes(self.state["v"])

    def set_positions(self, value):
        """Overwrite positions ((n, 3), internal numbering)."""
        self.base.set_positions(value)
        self.state["x"] = self._slab3(self.base.state["x"])

    def set_velocities(self, value):
        """Overwrite velocities ((n, 3), internal numbering)."""
        self.base.set_velocities(value)
        self.state["v"] = self._slab3(self.base.state["v"])

    def _gather_planes(self, planes):
        """(D, 3*Lr, 128) slabs -> (n, 3) in internal numbering."""
        base = self.base
        a = np.asarray(planes).reshape(self.D, 3, self.Lr, LANES)
        owned = a[:, :, self.H:self.H + self.Rloc]  # (D, 3, Rloc, 128)
        g = owned.transpose(1, 0, 2, 3).reshape(3, self.D * self.Rloc
                                                * LANES)
        return g[:, base._positions].T

    # --------------------------------------------------------- stepping

    def _make_step(self):
        base = self.base
        D, H, Hb, Lr, Rloc = self.D, self.H, self.Hb, self.Lr, self.Rloc
        Wr = base.Wr
        dt = self.dt
        dt2 = dt * dt
        iters = self.admm_iters
        cg_iters = self.cg_iters
        axis = self.axis
        offs = self.dia_offs
        is_uell = base._uell is not None
        if is_uell:
            slot_qs = base._uell_slot_qs
            fold_qs = base._uell_fold_qs
            n_dia = len(slot_qs) + sum(len(l) for l in fold_qs)
            # group slots by q so one shifted copy of x is live at a time
            q_groups = []
            for k, qq in enumerate(slot_qs):
                if q_groups and q_groups[-1][0] == qq:
                    q_groups[-1][1].append(k)
                else:
                    q_groups.append((qq, [k]))
        else:
            n_dia = len(offs)
        model = self.model
        newton_iters = base.newton_iters
        coll_shapes = base.coll_shapes
        coll_w2 = base.coll_w2
        collect = self.collect_residuals
        solver = self.solver
        cheb_k = self.cheb_iters
        cheb_c = self._cheb_c if solver == "cheb" else None
        mg_np = None
        if solver == "mg":
            n_l1, n_t0, n_t1 = self._mg_nplanes
            np2 = int(round(np.asarray(self._a2b_r).shape[0] ** 0.5))
            mg_np = {
                "split": (n_l1, n_t0, n_t1),
                "nplanes": n_l1 + n_t0 + n_t1 + 6,
                "np2": np2,
                "l1o": self._mg_offs["l1"],
                "t0o": self._mg_offs["t0"],
                "t1o": self._mg_offs["t1"],
                "reach": dict(self._mg_reach),
                "cycles": self.mg_cycles,
                "cheb": self._mg_cheb,
            }
        gvec = base.gravity
        own = self._own
        fwd = [(d, d + 1) for d in range(D - 1)]
        bwd = [(d + 1, d) for d in range(D - 1)]

        def refresh(a3, h):
            """Refresh h halo rows each side of (3, Lr, 128) from the
            neighbors' owned rows. h <= Rloc (the CG band halo) is one
            boundary-rows exchange per direction; wider halos (element
            windows spanning slabs) take ceil(h/Rloc) hops of the full
            owned slab."""
            if D == 1:
                return a3
            if h <= Rloc:
                top = a3[:, H + Rloc - h:H + Rloc]
                bot = a3[:, H:H + h]
                from_left = jax.lax.ppermute(top, axis, fwd)
                from_right = jax.lax.ppermute(bot, axis, bwd)
                a3 = jax.lax.dynamic_update_slice(a3, from_left,
                                                  (0, H - h, 0))
                a3 = jax.lax.dynamic_update_slice(a3, from_right,
                                                  (0, H + Rloc, 0))
                return a3
            own_slab = a3[:, H:H + Rloc]
            K = -(-h // Rloc)
            for k in range(1, K + 1):
                fwd_k = [(dd, dd + k) for dd in range(D - k)]
                bwd_k = [(dd, dd - k) for dd in range(k, D)]
                # bottom halo rows [H-kR, H-(k-1)R) come from device d-k
                lo = max(H - k * Rloc, H - h, 0)
                hi = H - (k - 1) * Rloc
                if hi > lo:
                    from_left = jax.lax.ppermute(own_slab, axis, fwd_k)
                    src = lo - (H - k * Rloc)
                    a3 = a3.at[:, lo:hi].set(
                        from_left[:, src:src + hi - lo]
                    )
                # top halo rows [H+kR, H+(k+1)R) come from device d+k
                lo2 = H + k * Rloc
                hi2 = min(H + (k + 1) * Rloc, H + Rloc + h, Lr)
                if hi2 > lo2:
                    from_right = jax.lax.ppermute(own_slab, axis, bwd_k)
                    a3 = a3.at[:, lo2:hi2].set(
                        from_right[:, :hi2 - lo2]
                    )
            return a3

        def combine_b(b3):
            """Add each device's above-slab RHS halo rows into their
            owners (chunk windows only reach UP; rows [H+kR, H+(k+1)R)
            belong to device d+k)."""
            if D == 1:
                return b3
            K = -(-H // Rloc)
            for k in range(1, K + 1):
                lo = H + k * Rloc
                hi = min(lo + Rloc, Lr)
                if hi <= lo:
                    break
                fwd_k = [(dd, dd + k) for dd in range(D - k)]
                sent = jax.lax.ppermute(b3[:, lo:hi], axis, fwd_k)
                b3 = b3.at[:, H:H + hi - lo].add(sent)
            return b3

        def _rshift(xv, q):
            """out[r] = x[r+q] on (Lr, 128), zero fill (the uell row
            shift — lanes are handled by the cc gather)."""
            if q == 0:
                return xv
            z = jnp.zeros_like(xv)
            if q > 0:
                return jnp.concatenate([xv[q:], z[:q]], 0)
            return jnp.concatenate([z[:(-q)], xv[:q]], 0)

        def matvec_dia(p3):
            out = []
            for a in range(3):
                acc = None
                for di, off in enumerate(offs):
                    t = dia_l[di] * shifted(p3[a], off)
                    acc = t if acc is None else acc + t
                out.append(acc)
            return jnp.stack(out)

        def matvec_uell(p3):
            """Per-row-offset ELL + layered folds (core/uell.py) on the
            slab: slot gathers read the Hb-refreshed halo; folds run on
            the result plane (their reach is part of Hb); the valid mask
            zeroes copy/spare positions so CG never sees phantom dofs."""
            vm, ucc = uell_l
            out = []
            for a in range(3):
                xv = p3[a]
                acc = None
                for qq, ks in q_groups:
                    sh = _rshift(xv, qq)
                    for k in ks:
                        t = dia_l[k] * jnp.take_along_axis(
                            sh, ucc[k], axis=1)
                        acc = t if acc is None else acc + t
                kf = len(slot_qs)
                for layer in fold_qs:
                    for qq in layer:
                        acc = acc + dia_l[kf] * jnp.take_along_axis(
                            _rshift(acc, qq), ucc[kf], axis=1)
                        kf += 1
                out.append(acc * vm)
            return jnp.stack(out)

        matvec = matvec_uell if is_uell else matvec_dia

        dia_l = None   # bound per call below
        uell_l = None  # (vmask, cc planes) bound per call below

        def sstep(p2d, dia, rbase, fblk, x, v, au, cu, d, *extra):
            nonlocal dia_l, uell_l
            p2d, dia, rbase, fblk = p2d[0], dia[0], rbase[0], fblk[0]
            x, v, au, cu, d = x[0], v[0], au[0], cu[0], d[0]
            mg_args = None
            if solver == "mg":
                mg_args = (extra[0][0], extra[1][0], extra[2][0],
                           extra[3])
            elif is_uell:
                uell_l = (
                    p2d[PVM * Lr:(PVM + 1) * Lr],
                    extra[0][0].reshape(n_dia, Lr, LANES),
                )
            dia_l = dia.reshape(n_dia, Lr, LANES)
            invd = p2d[PINVD * Lr:(PINVD + 1) * Lr]
            mass = p2d[PMASS * Lr:(PMASS + 1) * Lr]

            # prologue: gravity kick, park pre-step x, xbar, M xbar
            x3 = x.reshape(3, Lr, LANES)
            v3 = v.reshape(3, Lr, LANES)
            g3 = jnp.asarray(gvec, x.dtype)[:, None, None]
            # Gate the kick with the mass plane (banded_step.py does the same):
            # mass-0 pad lanes must not free-fall forever — unbounded phantom
            # state feeds phantom element stencils and NaN-poisons residual
            # collection (0*inf) on long f32 runs.
            v3 = v3 + jnp.where(mass[None] > 0, dt * g3, 0.0)
            xt3 = x3
            x3 = refresh(x3 + dt * v3, H)
            Mxb3 = mass[None] * x3

            local = lambda xx, aau, ccu, dd: banded_local_rhs(  # noqa: E731
                p2d, rbase, fblk, xx, aau, ccu, dd, Wr=Wr,
                model=model, newton_iters=newton_iters,
                coll_shapes=coll_shapes, coll_w2=coll_w2,
                collect=collect,
            )

            def dot(a3, b3):
                return jax.lax.psum(
                    jnp.sum(own[None] * a3 * b3), axis
                )

            def cg(x3, rhs3):
                r3 = rhs3 - matvec(refresh(x3, Hb))
                z3 = invd[None] * r3
                p3 = z3
                rz = dot(r3, z3)

                def body(_, carry):
                    x3, r3, p3, rz = carry
                    Ap = matvec(refresh(p3, Hb))
                    pAp = dot(p3, Ap)
                    alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
                    x3 = x3 + alpha * p3
                    r3 = r3 - alpha * Ap
                    z3 = invd[None] * r3
                    rz_new = dot(r3, z3)
                    beta = rz_new / jnp.where(rz > 0, rz, 1.0)
                    return (x3, r3, z3 + beta * p3, rz_new)

                x3, _, _, _ = jax.lax.fori_loop(
                    0, cg_iters, body, (x3, r3, p3, rz)
                )
                return refresh(x3, H)

            def cheb_xla(x3, rhs3):
                """Dot-product-free Chebyshev solve (parallel/cheb.py):
                no psums anywhere — the only cross-device traffic is
                the per-iteration Hb-row halo refresh of d."""
                inv_theta, c1, c2 = cheb_c
                z3 = invd[None] * (rhs3 - matvec(refresh(x3, Hb)))
                d3 = inv_theta * z3

                def body(i, carry):
                    x3, z3, d3 = carry
                    x3 = x3 + d3
                    z3 = z3 - invd[None] * matvec(refresh(d3, Hb))
                    d3 = c1[i] * d3 + c2[i] * z3
                    return (x3, z3, d3)

                x3, _, d3 = jax.lax.fori_loop(
                    0, cheb_k - 1, body, (x3, z3, d3)
                )
                x3 = x3 + d3
                return refresh(x3, H)

            def mg_solve(x3, rhs3):
                """Sharded geometric V-cycle Richardson iteration (see
                _build_mg): scale-robust matched solves at a fixed small
                cycle budget. Every level op is a masked flat shift on
                the slab (halo-refreshed to the op's reach); the only
                collective beyond ppermutes is the KB-sized coarsest
                pack psum."""
                mgf = mg_args[0].reshape(mg_np["nplanes"], Lr, LANES)
                mgi = mg_args[1].reshape(4, Lr, LANES)
                E = mg_args[2]
                a2b = mg_args[3]
                n_l1, n_t0, n_t1 = mg_np["split"]
                np2 = mg_np["np2"]
                l1v = mgf[:n_l1]
                om0 = mgf[n_l1]
                om1 = mgf[n_l1 + 1]
                t0m = mgf[n_l1 + 2:n_l1 + 2 + n_t0]
                t1m = mgf[n_l1 + 2 + n_t0:n_l1 + 2 + n_t0 + n_t1]
                pmask = mgf[n_l1 + 2 + n_t0 + n_t1:
                            n_l1 + 4 + n_t0 + n_t1]
                umask = mgf[n_l1 + 4 + n_t0 + n_t1:]
                pidx, uidx = mgi[:2], mgi[2:]

                def shift3(x3h, off):
                    return jnp.stack([
                        shifted(x3h[a], off) for a in range(3)
                    ])

                def apply_shift(x3_, offs_, vals_, h):
                    x3h = refresh(x3_, h)
                    acc = None
                    for di, o in enumerate(offs_):
                        t = vals_[di][None] * shift3(x3h, o)
                        acc = t if acc is None else acc + t
                    return acc

                def prolong(x3_, offs_, masks_, h):
                    x3h = refresh(x3_, h)
                    acc = None
                    for di, o in enumerate(offs_):
                        t = shift3(masks_[di][None] * x3h, -o)
                        acc = t if acc is None else acc + t
                    return acc

                fine_mv = lambda v3: matvec(refresh(v3, Hb))  # noqa: E731

                def pack(r3_):
                    acc = None
                    for w in range(2):
                        idxw = jnp.broadcast_to(
                            pidx[w][None], r3_.shape).astype(jnp.int32)
                        g = pmask[w][None] * jnp.take_along_axis(
                            r3_, idxw, axis=2)
                        t = jnp.einsum("cr,arl->acl", E[w],
                                       g[:, H:H + Rloc])
                        acc = t if acc is None else acc + t
                    return jax.lax.psum(acc, axis)

                def coarse_solve(rp):
                    z = jnp.zeros_like(rp)
                    for sr in range(np2):
                        for tr in range(np2):
                            z = z.at[:, tr].add(
                                rp[:, sr] @ a2b[sr * np2 + tr])
                    return z

                def unpack(zp):
                    acc = None
                    for w in range(2):
                        exp_own = jnp.einsum("cr,acl->arl", E[w], zp)
                        exp = jnp.zeros((3, Lr, LANES), zp.dtype)
                        exp = jax.lax.dynamic_update_slice(
                            exp, exp_own, (0, H, 0))
                        idxw = jnp.broadcast_to(
                            uidx[w][None], exp.shape).astype(jnp.int32)
                        t = umask[w][None] * jnp.take_along_axis(
                            exp, idxw, axis=2)
                        acc = t if acc is None else acc + t
                    return acc

                l1o = mg_np["l1o"]
                t0o = mg_np["t0o"]
                t1o = mg_np["t1o"]
                h_l1, h_t0, h_t1 = (mg_np["reach"][k]
                                    for k in ("l1", "t0", "t1"))

                def vcycle(r3_):
                    z = om0[None] * r3_
                    res = r3_ - fine_mv(z)
                    r1 = apply_shift(res, t0o, t0m, h_t0)
                    z1 = om1[None] * r1
                    res1 = r1 - apply_shift(z1, l1o, l1v, h_l1)
                    r2 = apply_shift(res1, t1o, t1m, h_t1)
                    z2 = unpack(coarse_solve(pack(r2)))
                    z1 = z1 + prolong(z2, t1o, t1m, h_t1)
                    z1 = z1 + om1[None] * (
                        r1 - apply_shift(z1, l1o, l1v, h_l1))
                    z = z + prolong(z1, t0o, t0m, h_t0)
                    z = z + om0[None] * (r3_ - fine_mv(z))
                    return z

                # Chebyshev-accelerated outer (still zero dot products —
                # plain Richardson stalls on the V-cycle's tail mode);
                # fori_loop keeps the compiled graph one-cycle-sized
                inv_theta, c1h, c2h = mg_np["cheb"]
                k = mg_np["cycles"]
                c1a = jnp.asarray(c1h, x.dtype)
                c2a = jnp.asarray(c2h, x.dtype)
                z = vcycle(rhs3 - fine_mv(x3))
                dvec = inv_theta * z

                def mg_body(i, carry):
                    x3, z, dvec = carry
                    x3 = x3 + dvec
                    z = z - vcycle(fine_mv(dvec))
                    dvec = c1a[i] * dvec + c2a[i] * z
                    return (x3, z, dvec)

                x3, _, dvec = jax.lax.fori_loop(
                    0, k - 1, mg_body, (x3, z, dvec))
                x3 = x3 + dvec
                return refresh(x3, H)

            if solver == "cheb":
                solve = cheb_xla
            elif solver == "mg":
                solve = mg_solve
            else:
                solve = cg

            rp = jnp.zeros((iters,), x.dtype)

            def admm_it(i, carry):
                x3, au, cu, d, rp = carry
                b, au, cu, d, r2 = local(
                    x3.reshape(3 * Lr, LANES), au, cu, d
                )
                if collect:
                    rp = rp.at[i].set(
                        jnp.sqrt(jax.lax.psum(r2, axis))
                    )
                b3 = combine_b(b.reshape(3, Lr, LANES))
                x3 = solve(x3, Mxb3 + dt2 * b3)
                return (x3, au, cu, d, rp)

            x3, au, cu, d, rp = jax.lax.fori_loop(
                0, iters, admm_it, (x3, au, cu, d, rp)
            )
            v3 = (x3 - xt3) * (1.0 / dt)
            return (x3.reshape(3 * Lr, LANES)[None],
                    v3.reshape(3 * Lr, LANES)[None],
                    au[None], cu[None], d[None], rp)

        pd = P(axis)
        extra_specs = ()
        if solver == "mg":
            extra_specs = (pd, pd, pd, P())
        elif is_uell:
            extra_specs = (pd,)
        smapped = jax.shard_map(
            sstep, mesh=self.mesh,
            in_specs=(pd, pd, pd, pd, pd, pd, pd, pd, pd) + extra_specs,
            out_specs=(pd, pd, pd, pd, pd, P()),
            check_vma=False,
        )

        def step(params, state):
            p2d, dia, rbase, fblk, *mg = params
            x, v, au, cu, d, rp = smapped(
                p2d, dia, rbase, fblk,
                state["x"], state["v"], state["ancu"], state["colu"],
                state["d"], *mg,
            )
            return {
                "x": x, "v": v, "ancu": au, "colu": cu, "d": d,
                "t": state["t"] + dt,
            }, rp

        return step

    @property
    def _params(self):
        out = (self._p2d, self._dia, self._rbase, self._fblk)
        if self.solver == "mg":
            out = out + (self._mgf_s, self._mgi_s, self._mgE,
                         self._a2b_r)
        if self._ucc is not None:
            out = out + (self._ucc,)
        return out

    def step(self):
        if self._stepf is None:
            self._stepf = jax.jit(highest(self._make_step()),
                                  donate_argnums=(1,))
        self.state, rp = self._stepf(self._params, self.state)
        if self.collect_residuals:
            self.last_primal = rp
        return True

    def run(self, n_steps: int):
        """Step n times. Full ROLLOUT_WINDOW chunks run as ONE jitted
        lax.scan program per chunk (one dispatch per W steps instead of
        W); the remainder (and residual-collecting runs, whose per-step
        last_primal contract a scan would change) steps individually."""
        W = self.ROLLOUT_WINDOW
        while not self.collect_residuals and n_steps >= W:
            if W not in self._runf:
                core = self._make_step()

                def runW(params, state):
                    def body(s, _):
                        s2, _rp = core(params, s)
                        return s2, None

                    out, _ = jax.lax.scan(body, state, None, length=W)
                    return out

                self._runf[W] = jax.jit(highest(runW), donate_argnums=(1,))
            self.state = self._runf[W](self._params, self.state)
            n_steps -= W
        for _ in range(n_steps):
            self.step()
        return True

    def refresh_params(self):
        """After runtime force edits on the originating System
        (`set_force_param` + `recompute_weights()` — the poordillo
        release pattern, /root/reference/samples/poordillo/
        poordillo.cpp:190-215): re-pack the parameter planes from the
        System WITHOUT re-partitioning, keeping the live sharded state.
        Weight/material/anchor edits flow through the plane arguments
        (no recompile); edits that are baked into the compiled program
        (gravity vector, collision shape geometry, iteration counts)
        trigger a re-jit. Requires construction via
        `sharded_banded_from_system` (which records the System)."""
        sysm = getattr(self, "_system", None)
        if sysm is None:
            raise ValueError(
                "refresh_params needs a System reference — build via "
                "sharded_banded_from_system"
            )
        from ..core.banded import banded_from_system

        out = banded_from_system(sysm)
        assert out is not None, "scene no longer qualifies for the layout"
        new_base, _ = out
        old = self.base
        # structural invariants: same partition, same chunk placement
        assert new_base.Nr == old.Nr and new_base.Wr == old.Wr
        assert tuple(new_base.dia_offs) == tuple(old.dia_offs)
        assert np.array_equal(np.asarray(new_base._rbase),
                              np.asarray(old._rbase))
        assert np.array_equal(np.asarray(new_base._positions),
                              np.asarray(old._positions))
        if old._uell is not None:
            # a weight edit that changes the nz pattern would repack the
            # slot structure — that needs a rebuild, not a refresh
            assert new_base._uell_slot_qs == old._uell_slot_qs
            assert new_base._uell_fold_qs == old._uell_fold_qs
        recompile = (
            not np.array_equal(new_base.gravity, old.gravity)
            or new_base.newton_iters != old.newton_iters
            or not _same_coll(new_base, old)
            # cheb/mg schedules are spectrum-derived closure constants:
            # a weight edit moves the spectrum, so rebuild them
            or self.solver in ("cheb", "mg")
        )
        # carry live state; adopt the re-packed parameter planes
        state = self.state
        self.base = new_base
        self._build()
        self.state = state
        if recompile:
            self._stepf = None
            self._runf = {}

    # ------------------------------------------------------------- stats

    def detach(self):
        """Write the sharded slab/chunk state back into the wrapped
        single-device BandedStepper (x, v, anchor/collision duals,
        per-chunk element duals, t) so its plane-checkpointing and
        single-device stepping continue exactly from here. Returns the
        base stepper."""
        base = self.base
        D, H, Rloc, Lr = self.D, self.H, self.Rloc, self.Lr

        def unslab(planes, n_planes):
            a = np.asarray(planes).reshape(D, n_planes, Lr, LANES)
            owned = a[:, :, H:H + Rloc]          # (D, P, Rloc, 128)
            full = owned.transpose(1, 0, 2, 3).reshape(
                n_planes, D * Rloc, LANES
            )
            return full[:, :base.Nr].reshape(n_planes * base.Nr, LANES)

        d_l = np.asarray(self.state["d"])        # (D, C, planes, 128)
        d_g = np.array(np.asarray(base.state["d"]))
        for dev, ids in enumerate(self._chunk_of):
            for j, cid in enumerate(ids):
                d_g[cid] = d_l[dev, j]
        dt_ = base.dtype
        base.state = {
            "x": jnp.asarray(unslab(self.state["x"], 3), dt_),
            "v": jnp.asarray(unslab(self.state["v"], 3), dt_),
            "ancu": jnp.asarray(unslab(self.state["ancu"], 3), dt_),
            "colu": jnp.asarray(unslab(self.state["colu"], 3), dt_),
            "d": jnp.asarray(d_g, dt_),
            "t": jnp.asarray(np.asarray(self.state["t"]), dt_),
        }
        return base

    def measured_comm(self):
        """Collective inventory of the COMPILED step program (post-GSPMD
        HLO), via parallel.comm. Static per-op byte sizes: ops inside the
        CG/ADMM fori_loops appear once; `bytes_per_step_measured`
        multiplies the loop-body ops by the known trip counts. The
        invariant worth pinning: `max_op_bytes` is O(band halo), never
        O(n) — a silent re-replication would show up here."""
        from .comm import compiled_hlo_text, hlo_collective_report

        if self._stepf is None:
            self._stepf = jax.jit(highest(self._make_step()),
                                  donate_argnums=(1,))
        rep = hlo_collective_report(
            compiled_hlo_text(self._stepf, self._params, self.state)
        )
        rep["admm_iters"] = self.admm_iters
        rep["cg_iters"] = self.cg_iters
        return rep

    def comm_stats(self):
        """Analytic cross-device traffic per step (bytes). Each CG
        iteration moves 2 x 3 x Hb boundary rows + two psum scalars;
        each ADMM iteration one H-row RHS combine and one full-H x
        refresh (multi-hop when element windows span slabs); all
        O(band width), independent of n.

        On a two-level ('host','chip') axis the same schedule splits by
        link class: of the D-1 slab boundaries, hosts-1 fall between
        hosts (DCN); the rest are intra-host (ICI) — the per-level rows
        report each class's share of every exchange."""
        bpr = LANES * np.dtype(np.float32).itemsize
        hops = -(-self.H // self.Rloc)
        h_rows = (self.H if self.H <= self.Rloc
                  else hops * self.Rloc * 2)  # slab sent per direction
        per_cg = 2 * 3 * self.Hb * bpr + 2 * 4
        per_admm = (3 * self.H * bpr          # combine_b
                    + 2 * 3 * h_rows * bpr    # post-CG x refresh
                    + self.cg_iters * per_cg)
        per_step = self.admm_iters * per_admm + 2 * 3 * h_rows * bpr
        out = {
            "n_devices": self.D,
            "halo_rows": self.H,
            "band_halo_rows": self.Hb,
            "bytes_per_cg_iter": per_cg,
            "bytes_per_admm_iter": per_admm,
            "bytes_per_step": per_step,
        }
        if isinstance(self.axis, tuple) and len(self.axis) == 2:
            hosts = int(self.mesh.shape[self.axis[0]])
            edges = max(self.D - 1, 1)
            inter = hosts - 1          # slab boundaries between hosts
            out["hosts"] = hosts
            out["interhost_edges"] = inter
            out["bytes_per_step_interhost"] = per_step * inter // edges
            out["bytes_per_step_intrahost"] = (
                per_step * (edges - inter) // edges)
        return out


def sharded_banded_from_system(system, mesh, axis: str = "elem",
                               solver: str = "cg",
                               cheb_iters: int | None = None,
                               mg_cycles: int = 10):
    """Build a ShardedBandedStepper for an initialized dia-mode System
    whose scene qualifies for the banded layout. Returns
    (stepper, to_canonical) or None (same contract as
    core.banded.banded_from_system). The System reference is recorded,
    enabling refresh_params (runtime force edits) and solver='mg'."""
    from ..core.banded import banded_from_system

    out = banded_from_system(system)
    if out is None:
        return None
    base, cid = out
    try:
        spmd = ShardedBandedStepper(base, mesh, axis=axis,
                                    solver=solver,
                                    cheb_iters=cheb_iters,
                                    mg_cycles=mg_cycles, system=system)
    except ValueError:
        return None
    return spmd, cid
