"""Banded tet layout: host-side packing of a tet mesh whose vertex
numbering keeps the global matrix on a bounded set of diagonals (or, for
arbitrary topology, on per-row-offset ELL slots — core/uell.py), for the
whole-timestep XLA program of parallel/banded_spmd.ShardedBandedStepper.

Elements are packed so that the per-iteration gather and scatter of every
element's four vertices are window scans plus lane permutations with no
conflicting writes:

1. `place_elements` sorts tets by min vertex index and packs them into
   sub-blocks of 128 with DISTINCT target lanes per corner slot — the
   property that turns the scatter into a conflict-free lane permutation.
   Packing is a sequential first-fit greedy with a 4x4 corner->slot
   matching per element (corner order within a tet is a dummy index, so
   relabeling is free); a bounded lookback keeps elements near their
   sorted position, bounding the vertex window.
2. Sub-blocks are grouped 64 per chunk; per-chunk vertex windows (base row
   + static width Wr) cover every referenced vertex.
3. Per-chunk planes: selector coefficients, w2/mu/lam/k, window row/lane
   decompositions of the corner indices, the scatter lane permutation and
   its permuted target rows (the FB plane map below).

Vertex planes are (Nr, 128) blocks: vertex i at row i // 128, lane i % 128.
Trajectories match the general System dia path to round-off
(tests/test_banded.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

LANES = 128
SUB = 64            # sub-blocks per chunk (chunk = 8192 elements)
MAX_WR = 40         # max vertex-window rows (gather scan length bound)
MAX_DIAGONALS = 48  # same budget as the dia solver

# FB (static per-chunk block) plane layout — each plane is SUB rows.
# float planes: 0-11 cp[4b+k], 12 w2, 13 mu, 14 lam, 15 k(prox);
# index planes (stored as exact small float values): 16-19 rr[k] (window
# row of corner k), 20-23 cc[k] (lane of corner k), 24-27 P[k] (scatter
# lane permutation: out-lane -> element lane), 28-31 rrp[k] (window row of
# the PERMUTED targets; -1 marks a pad lane that receives nothing).
FB_PLANES = 32
CP0, W2P, MUP, LAMP, KP = 0, 12, 13, 14, 15
RRP0, CCP0, PP0, RRPP0 = 16, 20, 24, 28

# DB (dual block) planes: 0-8 u (row-major F planes), 9-11 warm sigma.
DB_PLANES = 12

# P2D (packed vertex-plane input) planes: aw2, invd, mass, vmask, ancz xyz.
PAW2, PINVD, PMASS, PVM, PANCZ = 0, 1, 2, 3, 4
P2D_PLANES = 7


def shifted(xp, off):
    """out[i] = x[i + off] (flat index i = 128 r + l, zero fill) on an
    (R, 128) plane: a lane roll by off % 128 combined with two row shifts
    (lanes that wrap the 128 boundary read the next row)."""
    if off == 0:
        return xp
    R = xp.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (R, LANES), 1)
    z = lambda q: jnp.zeros((min(q, R), LANES), xp.dtype)  # noqa: E731

    def up(x, q):  # out[r] = x[r + q]
        return x if q == 0 else jnp.concatenate([x[q:], z(q)], 0)[:R]

    def down(x, q):  # out[r] = x[r - q]
        return x if q == 0 else jnp.concatenate([z(q), x[:R - q]], 0)[:R]

    if off > 0:
        q, s = divmod(off, LANES)
        t = jnp.roll(xp, LANES - s, axis=1) if s else xp
        if s == 0:
            return up(t, q)
        return jnp.where(lane < LANES - s, up(t, q), up(t, q + 1))
    q, s = divmod(-off, LANES)
    t = jnp.roll(xp, s, axis=1) if s else xp
    if s == 0:
        return down(t, q)
    return jnp.where(lane >= s, down(t, q), down(t, q + 1))


MAX_OPEN = 16  # greedy lookback in blocks (bounds window skew)


def _match_slots(bits, o):
    """Assign each of 4 corner lane bitmasks `bits` an exclusive slot of
    occupancy `o` (slot s usable for corner k iff o[s] & bits[k] == 0).
    Returns a 4-tuple slot assignment or None. Tiny DFS (4x4 matching);
    corner order within a tet is a dummy summation index, so any
    assignment is physically equivalent (F = sum_k cp[:,k] x[idx[k]])."""
    assign = [-1, -1, -1, -1]
    used = 0

    def dfs(k):
        nonlocal used
        if k == 4:
            return True
        for s in range(4):
            if not (used >> s) & 1 and not (o[s] & bits[k]):
                assign[k] = s
                used |= 1 << s
                if dfs(k + 1):
                    return True
                used &= ~(1 << s)
        return False

    return tuple(assign) if dfs(0) else None


def place_elements(idx):
    """Pack elements (sorted by min vertex index) into sub-blocks of 128
    such that within each sub-block every corner slot's 128 target lanes
    (vertex % 128) are distinct. Returns (subs, perm):
    subs (n_sub, 128) int64 element ids (-1 pads); perm (E, 4) int8 the
    corner->slot relabeling chosen per element (apply as idx[e, perm[e]]
    / coeff[e, :, perm[e]] — exactly the freedom that makes the packing
    tight: a cell's tets share vertices at the SAME canonical corner, but
    any corner can serve any slot).

    Sequential first-fit greedy over the sorted order with a 4x4 slot
    matching per candidate block; a lookback bound keeps every element
    near its sorted position, bounding the per-chunk vertex window. When
    the WHOLE mesh fits in the MAX_WR-row gather window there is
    no skew cost, so the lookback is unlimited (this is what keeps
    small/medium meshes tightly packed: their padding is driven by
    lane-class capacity, not ordering)."""
    idx = np.asarray(idx, np.int64)
    E = len(idx)
    order = np.argsort(idx.min(axis=1), kind="stable")
    lanes = (idx % LANES).astype(np.int64)
    n_rows = int(idx.max()) // LANES + 1
    lookback = E if n_rows <= MAX_WR else MAX_OPEN
    perm = np.zeros((E, 4), np.int8)
    blocks = []  # element-id lists
    occ = []     # per-block [slot0..slot3] lane bitmasks
    counts = []
    for e in order:
        bits = [1 << int(l) for l in lanes[e]]
        placed = False
        for bi in range(max(0, len(blocks) - lookback), len(blocks)):
            if counts[bi] == LANES:
                continue
            o = occ[bi]
            a = _match_slots(bits, o)
            if a is not None:
                blocks[bi].append(e)
                counts[bi] += 1
                for k in range(4):
                    o[a[k]] |= bits[k]
                # slot s takes corner inv(a)[s]: idx[e, perm[e]] is in
                # slot order
                pe = perm[e]
                for k in range(4):
                    pe[a[k]] = k
                placed = True
                break
        if not placed:
            blocks.append([e])
            counts.append(1)
            occ.append(list(bits))
            perm[e] = (0, 1, 2, 3)
    subs = np.asarray(
        [blk + [-1] * (LANES - len(blk)) for blk in blocks], np.int64
    )
    return subs, perm


class BandedStepper:
    """Packed banded layout of one tet scene (the single-device input of
    parallel/banded_spmd.ShardedBandedStepper, which steps it).

    Matches System dia-path semantics for: one tet force — NeoHookean/StVK
    `HyperElasticTet` (per-element mu/lam, `newton_iters` warm-started
    local Newton iterations) or `LinearTetStrain` (model='arap') —
    StaticAnchors with per-node weights, an optional CollisionForce of
    analytic shapes (floor/sphere/cylinder, declaration-order projection),
    gravity velocity kicks, and the dia global solve with `cg_iters` fixed
    Jacobi-PCG iterations.

    All array arguments are in the INTERNAL vertex numbering (the caller
    applies any renumbering; see banded_from_system).
    """

    model_name = "banded"

    def __init__(self, vertices, masses, tet_idx, tet_coeff, tet_w2,
                 tet_mu, tet_lam, tet_k, model, newton_iters,
                 anchor_idx, anchor_w2, anchor_pos,
                 dia_offs, dia_vals, diag,
                 gravity=(0.0, -9.8, 0.0), dt=0.04, admm_iters=10,
                 cg_iters=25, dtype=jnp.float32,
                 floor_y=None, floor_w2=0.0,
                 coll_shapes=None, coll_w2=None,
                 positions=None, uell=None, collect_residuals=False):
        v = np.asarray(vertices, np.float64)
        n = len(v)
        E = len(tet_idx)
        self.n_nodes = n
        self.dt = float(dt)
        self.admm_iters = int(admm_iters)
        self.cg_iters = int(cg_iters)
        self.newton_iters = int(newton_iters)
        self.dtype = dtype
        self.model = str(model)
        #: per-iteration residual collection: "primal" (the dual-update
        #: identity over planes already computed) or True (primal + dual)
        self.collect_residuals = (
            collect_residuals if collect_residuals in (True, "primal")
            else bool(collect_residuals)
        )
        self.gravity = tuple(float(q) for q in gravity)
        # static analytic collision shapes, declaration-order projected
        # (floor/sphere/cylinder); floor_y/floor_w2 are the
        # single-floor sugar form
        if coll_shapes is None:
            coll_shapes = ((("floor", (float(floor_y),)),)
                           if floor_y is not None else ())
            coll_w2 = float(floor_w2)
        self.coll_shapes = tuple(
            (str(k), tuple(float(q) for q in prm)) for k, prm in coll_shapes
        )
        self.coll_w2 = float(coll_w2 if coll_w2 is not None else floor_w2)
        if self.model not in ("nh", "stvk", "arap"):
            raise ValueError(f"unknown banded model {self.model!r}")
        if len(dia_offs) > MAX_DIAGONALS:
            raise ValueError("too many diagonals for the banded layout")

        idx = np.asarray(tet_idx, np.int64).reshape(E, 4)
        coeff = np.asarray(tet_coeff, np.float64).reshape(E, 3, 4)
        w2 = np.broadcast_to(np.asarray(tet_w2, np.float64), (E,))
        mu = np.broadcast_to(np.asarray(tet_mu, np.float64), (E,))
        lam = np.broadcast_to(np.asarray(tet_lam, np.float64), (E,))
        kp = np.broadcast_to(np.asarray(tet_k, np.float64), (E,))

        # diluted vertex layout (unstructured / uell mode): every vertex
        # plane is indexed by positions[v]; copy/spare slots are padding
        if positions is None:
            self._positions = np.arange(n, dtype=np.int64)
            N = -(-n // (8 * LANES)) * (8 * LANES)
        else:
            self._positions = np.asarray(positions, np.int64)
            assert uell is not None, "positions requires uell planes"
            N = int(uell["n_pad"])
        self._uell = uell
        idx = self._positions[idx]
        self.N = N
        Nr = N // LANES
        self.Nr = Nr

        # ---- element placement + chunking (with per-element corner->slot
        # relabeling; physically equivalent, see place_elements)
        subs, perm = place_elements(idx)  # (n_sub, 128), (E, 4)
        idx = np.take_along_axis(idx, perm.astype(np.int64), axis=1)
        coeff = np.take_along_axis(coeff, perm[:, None, :].astype(np.int64),
                                   axis=2)
        n_sub = len(subs)
        n_chunks = -(-n_sub // SUB)
        subs = np.pad(subs, ((0, n_chunks * SUB - n_sub), (0, 0)),
                      constant_values=-1)
        self.n_chunks = n_chunks
        # chunk -> element-id map (pads -1)
        self._subs = subs.reshape(n_chunks, SUB, LANES)

        rbase = np.zeros(n_chunks, np.int32)
        wr_need = 1
        for c in range(n_chunks):
            block = subs[c * SUB : (c + 1) * SUB]
            es = block[block >= 0]
            if not len(es):
                continue
            vs = idx[es]
            rb = (int(vs.min()) // LANES) // 8 * 8
            rbase[c] = rb
            wr_need = max(wr_need, int(vs.max()) // LANES - rb + 1)
        Wr = -(-wr_need // 8) * 8
        if Wr > MAX_WR:
            raise ValueError(
                f"vertex window {Wr} rows exceeds MAX_WR={MAX_WR} — "
                "numbering bandwidth too large for the banded layout"
            )
        self.Wr = Wr

        # ---- per-chunk static planes (FB layout)
        fblk = np.zeros((n_chunks, FB_PLANES * SUB, LANES), np.float64)
        for c in range(n_chunks):
            block = subs[c * SUB : (c + 1) * SUB]  # (SUB, 128)
            real = block >= 0
            e = np.where(real, block, 0)
            rowof = lambda p: slice(p * SUB, (p + 1) * SUB)

            def setp(p, vals):
                fblk[c, rowof(p)] = np.where(real, vals, 0.0)

            for b in range(3):
                for k in range(4):
                    setp(CP0 + 4 * b + k, coeff[e, b, k])
            setp(W2P, w2[e])
            # pad material lanes get benign values (their w2 is 0)
            fblk[c, rowof(MUP)] = np.where(real, mu[e], 1.0)
            fblk[c, rowof(LAMP)] = np.where(real, lam[e], 1.0)
            fblk[c, rowof(KP)] = np.where(real, kp[e], 1.0)
            for k in range(4):
                rr = idx[e, k] // LANES - rbase[c]
                cc = idx[e, k] % LANES
                fblk[c, rowof(RRP0 + k)] = np.where(real, rr, 0)
                fblk[c, rowof(CCP0 + k)] = np.where(real, cc, 0)
                # scatter permutation: out-lane cc[j,l] <- element lane l
                P = np.zeros((SUB, LANES), np.int64)
                rrp = np.full((SUB, LANES), -1.0)
                jj, ll = np.nonzero(real)
                P[jj, cc[jj, ll]] = ll
                rrp[jj, cc[jj, ll]] = rr[jj, ll]
                fblk[c, rowof(PP0 + k)] = P
                fblk[c, rowof(RRPP0 + k)] = rrp

        self._fblk = jnp.asarray(fblk, dtype)
        self._rbase = jnp.asarray(rbase, jnp.int32)

        # ---- packed vertex planes + diagonals (2D row-major layout);
        # per-vertex values land at their (possibly diluted) positions
        def to2d(plane, fill=0.0):
            full = np.full(N, fill, np.float64)
            full[self._positions] = np.broadcast_to(
                np.asarray(plane, np.float64), (n,)
            )
            return full.reshape(Nr, LANES)

        aw2 = np.zeros(n)
        np.add.at(aw2, np.asarray(anchor_idx, np.int64),
                  np.asarray(anchor_w2, np.float64))
        ancz = v.copy()
        if len(anchor_idx):
            ancz[np.asarray(anchor_idx, np.int64)] = np.asarray(
                anchor_pos, np.float64
            )
        p2d = np.concatenate(
            [to2d(aw2), to2d(1.0 / diag, fill=1.0),
             to2d(np.broadcast_to(np.asarray(masses, np.float64), (n,))),
             to2d(np.ones(n)),  # valid-vertex mask
             to2d(ancz[:, 0]), to2d(ancz[:, 1]), to2d(ancz[:, 2])],
            axis=0,
        )
        self._p2d = jnp.asarray(p2d, dtype)
        if uell is None:
            self.dia_offs = tuple(int(o) for o in dia_offs)
            dv = np.asarray(dia_vals, np.float64)
            dia2d = np.concatenate(
                [to2d(dv[d]) for d in range(len(dv))], 0
            )
            self._dia2d = jnp.asarray(dia2d, dtype)
            self._ucc2d = None
            self._uell_slot_qs = None
            self._uell_fold_qs = None
        else:
            # per-row-offset ELL + fold planes (core/uell.py): val planes
            # (full precision — the CG solution error scales with
            # cond(A_hat) times any value quantization, so lossy storage
            # is NOT acceptable) stacked into the dia slot of the layout;
            # 7-bit lane indices packed four per int32 word (lossless)
            self.dia_offs = ()
            all_planes = list(uell["slots"]) + [
                op for layer in uell["folds"] for op in layer
            ]
            self._uell_slot_qs = tuple(q for q, _, _ in uell["slots"])
            self._uell_fold_qs = tuple(
                tuple(q for q, _, _ in layer) for layer in uell["folds"]
            )
            self._uell_packed = bool(
                np.dtype(jnp.dtype(dtype)) == np.dtype(np.float32)
            )
            vals = np.concatenate([vp for _, _, vp in all_planes], 0)
            ccs = [cc for _, cc, _ in all_planes]
            self._dia2d = jnp.asarray(vals, dtype)
            if self._uell_packed:
                words = []
                for w in range(-(-len(ccs) // 4)):
                    word = np.zeros_like(ccs[0], np.int64)
                    for b in range(4):
                        k = 4 * w + b
                        if k < len(ccs):
                            word |= ccs[k].astype(np.int64) << (8 * b)
                    words.append(word.astype(np.int32))
                self._ucc2d = jnp.asarray(np.concatenate(words, 0))
            else:
                self._ucc2d = jnp.asarray(
                    np.concatenate(ccs, 0), jnp.int32
                )

        def state3(arr):
            arr = np.asarray(arr, np.float64)
            return jnp.asarray(
                np.concatenate([to2d(arr[:, a]) for a in range(3)], 0),
                dtype,
            )

        self.state = {
            "x": state3(v),
            "v": jnp.zeros((3 * Nr, LANES), dtype),
            "d": jnp.concatenate(
                [jnp.zeros((n_chunks, 9 * SUB, LANES), dtype),
                 jnp.ones((n_chunks, 3 * SUB, LANES), dtype)], axis=1,
            ),
            "ancu": jnp.zeros((3 * Nr, LANES), dtype),
            "colu": jnp.zeros((3 * Nr, LANES), dtype),
            "t": jnp.asarray(0.0, dtype),
        }

    # ------------------------------------------------------------ access

    def _planes_to_xyz(self, planes):
        a = np.asarray(planes).reshape(3, self.N)[:, self._positions]
        return a.T

    @property
    def x(self):
        return self._planes_to_xyz(self.state["x"])

    @property
    def v(self):
        return self._planes_to_xyz(self.state["v"])

    def set_positions(self, value):
        """Overwrite positions (internal numbering, (n,3))."""
        v = np.zeros((3, self.N))
        v[:, self._positions] = np.asarray(value, np.float64).T
        self.state["x"] = jnp.asarray(
            v.reshape(3 * self.Nr, LANES), self.dtype
        )

    def set_velocities(self, value):
        v = np.zeros((3, self.N))
        v[:, self._positions] = np.asarray(value, np.float64).T
        self.state["v"] = jnp.asarray(
            v.reshape(3 * self.Nr, LANES), self.dtype
        )


def banded_from_system(system):
    """Build a BandedStepper equivalent to an initialized dia/ell-mode
    System when its force set qualifies. Returns (stepper, to_canonical)
    or None.

    Qualifying configuration: one tet force (HyperElasticTet nh/stvk or
    LinearTetStrain — per-element materials allowed), StaticAnchors (any
    weights), at most one Collision holding any mix of Floor/Sphere/
    Cylinder shapes, all-node
    ExplicitForce kicks only, no residual collection, dia global solve
    (possibly via System's internal grid renumbering), bounded window.

    Uses the System's POST-reorder internals (params/_xi/_mi/_dia_offsets)
    so any renumbering System performed is inherited for free.
    """
    from ..models.anchor import StaticAnchor
    from ..models.collision import Collision, Cylinder, Floor, Sphere
    from ..models.explicit import ExplicitForce, WindForce
    from ..models.tet import HyperElasticTet, LinearTetStrain

    s = system.settings
    # residual-driven early exit, over-relaxation, Anderson, the AMG
    # preconditioner and per-iteration CG schedules need the general path
    if s.collect_residuals not in (False, None, True, "primal") or (
            s.residual_tol is not None):
        return None
    if (s.relaxation != 1.0 or s.acceleration is not None
            or s.preconditioner != "jacobi"
            or isinstance(s.cg_fixed_iters, (tuple, list))):
        return None
    if getattr(system, "_solver_mode", None) not in ("dia", "ell"):
        return None

    tet = None
    anchors = []
    floor = None
    for f in system.forces:
        if isinstance(f, HyperElasticTet):
            if tet is not None or f.model not in ("nh", "stvk"):
                return None
            tet = (f.model, f)
        elif isinstance(f, LinearTetStrain):
            if tet is not None:
                return None
            tet = ("arap", f)
        elif type(f) is StaticAnchor:
            anchors.append(f)
        elif isinstance(f, Collision):
            if (floor is not None or f.n_nodes != system.n_nodes
                    or not all(isinstance(s_, (Floor, Sphere, Cylinder))
                               for s_ in f.shapes)):
                return None
            floor = f
        else:
            return None
    if tet is None:
        return None

    gravity = np.zeros(3)
    for e in system.explicit_forces:
        if isinstance(e, WindForce) or not isinstance(e, ExplicitForce):
            return None
        if getattr(e, "indices", None) is not None:
            return None
        gravity = gravity + np.asarray(e.direction, np.float64)

    model, tf = tet
    p = {k: np.asarray(jax.device_get(v_), np.float64)
         if not isinstance(v_, np.ndarray) else np.asarray(v_, np.float64)
         for k, v_ in system.params[tf.name].items()
         if k in ("indices", "coeff", "weight", "k", "mu", "lam")}
    E = len(p["indices"])
    w2 = p["weight"] ** 2
    if model == "arap":
        mu = lam = np.ones(E)
        newton_iters = 1
    else:
        mu = np.broadcast_to(p["mu"], (E,))
        lam = np.broadcast_to(p["lam"], (E,))
        newton_iters = tf.max_iters
    kp = np.broadcast_to(p["k"], (E,))

    anchor_idx = []
    anchor_w2 = []
    anchor_pos = []
    for a in anchors:
        ap = system.params[a.name]
        anchor_idx.append(np.asarray(ap["indices"], np.int64).ravel())
        anchor_w2.append(np.asarray(ap["weight"], np.float64) ** 2)
        anchor_pos.append(np.asarray(ap["pos"], np.float64))
    anchor_idx = (np.concatenate(anchor_idx)
                  if anchors else np.zeros(0, np.int64))
    anchor_w2 = (np.concatenate(anchor_w2) if anchors else np.zeros(0))
    anchor_pos = (np.concatenate(anchor_pos)
                  if anchors else np.zeros((0, 3)))

    sv = system.params["_solver"]
    if system._solver_mode == "dia":
        dia_offs = system._dia_offsets
        dia_vals = np.asarray(sv["dia_vals"], np.float64)
        diag = np.asarray(sv["diag"], np.float64)
        positions = None
        packed = None
    else:
        # unstructured numbering: no diagonal structure exists — pack
        # A_hat into per-row-offset ELL slots over a spatially-ordered,
        # diluted vertex layout (core/uell.py)
        from .solver import _assemble_A_hat_csr
        from .uell import pack_uell_auto

        n = system.n_nodes
        cparams = {
            k: {kk: np.asarray(jax.device_get(vv))
                for kk, vv in system.params[k].items()}
            for k in system._constraint_names
        }
        A = _assemble_A_hat_csr(n, system._mi, s.timestep_s, cparams)
        diag = A.diagonal().copy()
        Ac = A.tocoo()
        nz = Ac.data != 0.0  # structural zeros would waste slot planes
        try:
            packed, positions = pack_uell_auto(
                Ac.row[nz], Ac.col[nz], Ac.data[nz], system._xi)
        except ValueError:
            return None
        dia_offs = ()
        dia_vals = np.zeros((0, n))
    try:
        stepper = BandedStepper(
            system._xi, system._mi,
            p["indices"], p["coeff"], w2, mu, lam, kp,
            model, newton_iters,
            anchor_idx, anchor_w2, anchor_pos,
            dia_offs, dia_vals, diag,
            gravity=tuple(gravity), dt=s.timestep_s,
            admm_iters=s.admm_iters,
            cg_iters=(s.cg_fixed_iters
                      if s.cg_fixed_iters is not None else 25),
            dtype=s.dtype,
            coll_shapes=tuple(
                ("floor", (float(s_.center[1]),)) if isinstance(s_, Floor)
                else ("sphere", (*[float(q) for q in s_.center],
                                 float(s_.radius)))
                if isinstance(s_, Sphere)
                else ("cylinder", (float(s_.center[0]),
                                   float(s_.center[1]), float(s_.radius)))
                for s_ in (floor.shapes if floor is not None else ())
            ),
            coll_w2=(float(floor.weight_value) ** 2
                     if floor is not None else 0.0),
            positions=positions, uell=packed,
            collect_residuals=(s.collect_residuals
                               if s.collect_residuals in (True, "primal")
                               else False),
        )
    except ValueError:
        return None
    cid = (system._o2i if system._o2i is not None
           else np.arange(system.n_nodes))
    return stepper, np.asarray(cid)
