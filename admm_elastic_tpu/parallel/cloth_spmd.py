"""Grid-cloth whole-timestep ADMM as one XLA program, element-sharded over
a device mesh with boundary-halo exchange (one device is the mesh of one).

The grid-cloth layout (core/cloth.py) is split at the slab boundary of its
flat-lane index space:

  * the flat vertex index space [0, N) — which IS mesh-local under the
    interleaved-column cloth numbering — is cut into contiguous slabs
    of `nbf` lanes per device;
  * every constant-offset group element is owned by the slab of its
    BASE lane (group offsets are non-negative: stencils and scatters
    reach only UP, at most max-offset lanes into the next slab);
  * per ADMM iteration each device evaluates its groups on its slab
    with a +/-Hf-lane halo of x (one neighbor `ppermute` pair), using
    the lane-parallel triangle projection of ops/lanes.py and the bend,
    wind and anchor formulas below, then one reverse exchange returns
    top-halo RHS partials to their owner;
  * the Jacobi-PCG dia solve runs at the JAX level: the symmetric-dia
    matvec is row-local given the halo, the two CG scalars are psums.

Per-device traffic per CG iteration is O(halo) = O(grid row length),
independent of N — the same boundary-halo design as the sharded banded
tet layout (parallel/banded_spmd.py; SURVEY §2.7).

Trajectory parity vs the general System path and across device counts:
tests/test_cloth_spmd.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.lanes import tri_body
from ..utils.precision import highest


def _roundup(x, m):
    return -(-int(x) // m) * m


class ShardedClothStepper:
    """Distribute an initialized single-device ClothStepper over a mesh
    axis. Build via `sharded_cloth_from_system` or directly.

        mesh = jax.make_mesh((8,), ("elem",))
        spmd = ShardedClothStepper(cloth_stepper, mesh)
        spmd.run(10); x = spmd.x
    """

    model_name = "cloth_spmd"
    model = "cloth"
    #: steps fused into one lax.scan program by run() (one dispatch per
    #: window instead of one per step)
    ROLLOUT_WINDOW = 10

    def __init__(self, base, mesh, axis: str = "elem",
                 solver: str = "cg", mg_cycles: int = 10, system=None,
                 cheb_iters: int | None = None):
        if solver not in ("cg", "cheb", "mg"):
            raise ValueError(
                f"solver must be 'cg', 'cheb' or 'mg', got {solver}")
        if solver == "mg" and system is None:
            raise ValueError(
                "solver='mg' needs the originating System (pass system= "
                "or build via sharded_cloth_from_system)"
            )
        #: 'mg' = sharded geometric V-cycles with a Chebyshev-accelerated
        #: dot-free outer (same design as banded_spmd; the cloth matched
        #: budget is otherwise cg~300, growing with grid diameter);
        #: 'cheb' = dot-free Chebyshev on the fine operator
        #: (parallel/cheb.py) — no scalar collective anywhere in the
        #: solve (CG pays 2 psums/iteration on a real mesh)
        self.solver = solver
        self.mg_cycles = int(mg_cycles)
        self.cheb_iters = int(cheb_iters or base.cg_iters)
        self._system = system
        self.base = base
        self.mesh = mesh
        self.axis = axis
        self.D = int(mesh.shape[axis])
        self.dt = base.dt
        self.admm_iters = base.admm_iters
        self.cg_iters = base.cg_iters
        self.collect_residuals = base.collect_residuals
        #: (admm_iters,) residuals of the last step (collect modes)
        self.last_primal = None
        self.last_dual = None
        self._build()
        self._stepf = None
        self._runf = {}

    # ------------------------------------------------------------- build

    def _build(self):
        base = self.base
        D = self.D
        N = base.N
        dtype = base.dtype

        offs_all = [1]
        for spec in base.groups:
            offs_all += list(spec[1])
        for offs, _ in base.wind_groups:
            offs_all += list(offs)
        offs_all += list(base.dia_offs)
        Hf = _roundup(max(offs_all), 8)
        nbf = _roundup(-(-N // D), 128)
        if Hf > nbf:
            raise ValueError(
                f"sharded cloth path: halo {Hf} lanes exceeds the "
                f"{nbf}-lane slab — too many devices for this mesh"
            )
        mg_host = None
        if self.solver == "mg":
            mg_host = self._mg_host_build()
            if max(self._mg_reach.values()) > nbf:
                raise ValueError(
                    f"sharded cloth mg: level reach "
                    f"{max(self._mg_reach.values())} lanes exceeds the "
                    f"{nbf}-lane slab — too many devices for this mesh"
                )
        Nf = D * nbf
        L = nbf + 2 * Hf
        self.Hf, self.nbf, self.L = Hf, nbf, L

        def slab(arr, fills=0.0, halo=True):
            """(P, N) -> (D, P, nbf[+2Hf]) slabs; out-of-range lanes get
            the per-plane fill."""
            a = np.asarray(arr, np.float64)
            if a.ndim == 1:
                a = a[None]
            Pn = a.shape[0]
            fills = np.broadcast_to(np.asarray(fills, np.float64), (Pn,))
            full = np.empty((Pn, Nf + 2 * Hf))
            for p in range(Pn):
                full[p] = fills[p]
                full[p, Hf:Hf + N] = a[p]
            w = L if halo else nbf
            off0 = 0 if halo else Hf
            out = np.empty((D, Pn, w))
            for d in range(D):
                lo = d * nbf + off0
                out[d] = full[:, lo:lo + w]
            return out

        # masks: row 0 aw2 (own-gated), 1 masses (own), 2 invd (own,
        # pad 1), 3+ group validity (own-gated). Gating outside own rows
        # makes each element/anchor computed exactly once fleet-wide.
        masks = np.asarray(base._masks, np.float64)
        m_own = slab(masks, fills=[0.0, 0.0, 1.0] + [0.0] * (
            masks.shape[0] - 3), halo=False)
        self._masks = jnp.asarray(m_own, dtype)
        self._ancz = jnp.asarray(
            slab(np.asarray(base._ancz, np.float64), halo=False), dtype
        )
        self._dia = jnp.asarray(
            slab(np.asarray(base._dia, np.float64)), dtype
        )

        st = base.state
        self.state = {
            "x": jnp.asarray(
                slab(np.asarray(st["x"], np.float64), halo=False), dtype),
            "v": jnp.asarray(
                slab(np.asarray(st["v"], np.float64), halo=False), dtype),
            "ancu": jnp.asarray(
                slab(np.asarray(st["ancu"], np.float64), halo=False),
                dtype),
            "u": jnp.asarray(
                np.stack([
                    slab(np.asarray(st["u"], np.float64)[g], halo=False)
                    for g in range(base.n_groups)
                ], axis=1), dtype) if base.n_groups else
                jnp.zeros((D, 0, 16, nbf), dtype),
            "t": jnp.asarray(np.asarray(st["t"]), dtype),
        }
        shd = NamedSharding(self.mesh, P(self.axis))
        self._slab_own = lambda planes: jax.device_put(  # noqa: E731
            jnp.asarray(slab(np.asarray(planes, np.float64), halo=False),
                        dtype), shd)
        self.state = {
            # "t" rides replicated: leaving it UN-placed makes the
            # post-step sharding differ from the input's and forces a
            # silent second compile of the whole step
            k: jax.device_put(
                v, shd if k != "t" else NamedSharding(self.mesh, P()))
            for k, v in self.state.items()
        }
        for nm in ("_masks", "_ancz", "_dia"):
            setattr(self, nm, jax.device_put(getattr(self, nm), shd))
        if self.solver == "mg":
            self._build_mg(slab, mg_host, shd)
        if self.solver == "cheb":
            from .cheb import (_flat_shift, cheb_coefficients,
                               dia_operator_bounds)

            # expand the SYMMETRIC storage (offsets >= 0, vals[d,i] =
            # A[i,i+off]) to full planes: A[i,i-off] = vals[d,i-off].
            # The operator diagonal IS the stepper's Jacobi D (invd =
            # 1/diag, masks row 2), so dia_operator_bounds' d0 matches
            # the preconditioner the recurrence applies; pad lanes
            # (diag 0) are excluded exactly.
            fv_sym = np.asarray(base._dia, np.float64)
            full_offs, full_planes = [], []
            for d, o in enumerate(base.dia_offs):
                full_offs.append(int(o))
                full_planes.append(fv_sym[d])
                if o != 0:
                    full_offs.append(-int(o))
                    full_planes.append(_flat_shift(fv_sym[d], -int(o)))
            lmin, lmax = dia_operator_bounds(
                np.stack(full_planes)[:, None, :], full_offs)
            #: measured spectral interval of D^{-1}A (margins applied)
            self.cheb_bounds = (lmin, lmax)
            inv_theta, c1, c2 = cheb_coefficients(
                self.cheb_iters, lmin, lmax)
            self._cheb_c = (float(inv_theta),
                            jnp.asarray(c1, dtype), jnp.asarray(c2, dtype))

    def _mg_host_build(self):
        """Host phase of the sharded 2D multigrid: the core/mg.py package
        on the cloth's flat-lane layout (ladders from core/cloth.py), plus the
        Chebyshev schedule for the dot-free outer from a one-time power
        iteration on I - B A (plain Richardson stalls on the V-cycle's
        tail mode — see parallel/banded_spmd._mg_host_build)."""
        import jax as _jax

        from ..core.cloth import MG_LADDERS, MG_MAX_NP2
        from ..core.mg import LANES, build_grid_mg, vcycle_np
        from ..core.solver import _assemble_A_hat_csr
        from .cheb import cheb_coefficients

        base = self.base
        sysm = self._system
        n_pad = base.N

        cparams = {
            k: {kk: np.asarray(_jax.device_get(vv))
                for kk, vv in sysm.params[k].items()}
            for k in sysm._constraint_names
        }
        A = _assemble_A_hat_csr(
            sysm.n_nodes, sysm._mi, sysm.settings.timestep_s, cparams
        ).tocsr()
        xi = np.asarray(sysm._xi)
        got = None
        for ladder in MG_LADDERS:
            got = build_grid_mg(A, xi, n_pad, min_nodes=0,
                                level_strides=ladder,
                                np2_rows=MG_MAX_NP2)
            if got is not None:
                planes, meta = got
                np2 = -(-meta["nc2"] // LANES)
                if np2 < MG_MAX_NP2:
                    got = build_grid_mg(A, xi, n_pad, min_nodes=0,
                                        level_strides=ladder,
                                        np2_rows=max(1, np2))
                break
        if got is None:
            raise ValueError(
                "sharded cloth mg: no stride ladder fits this grid "
                "(not a full grid in nested numbering?)"
            )
        mgp, mgm = got
        self.mg_levels = mgm["levels"]

        def reach(offs):
            return max((abs(int(o)) for o in offs), default=0)

        self._mg_offs = {
            "l1": tuple(mgm["l1_offs"]),
            "t0": tuple(mgm["t0_offs"]),
            "t1": tuple(mgm["t1_offs"]),
        }
        self._mg_reach = {
            "fine": reach(base.dia_offs),
            "l1": reach(mgm["l1_offs"]),
            "t0": reach(mgm["t0_offs"]),
            "t1": reach(mgm["t1_offs"]),
        }

        # expand the cloth's SYMMETRIC dia storage (offsets >= 0,
        # vals[d,i] = A[i,i+off]) into the signed form vcycle_np's fine
        # matvec expects: A[i,i-off] = vals[d,i-off]
        def _sh(x, o):
            out = np.zeros_like(x)
            if o > 0:
                out[:-o] = x[o:]
            elif o < 0:
                out[-o:] = x[:o]
            else:
                out[:] = x
            return out

        fv_sym = np.asarray(base._dia, np.float64)
        fo_signed, fv_signed = [], []
        for d, o in enumerate(base.dia_offs):
            fo_signed.append(int(o))
            fv_signed.append(fv_sym[d])
            if o != 0:
                fo_signed.append(-int(o))
                fv_signed.append(_sh(fv_sym[d], -int(o)))
        fo_signed = tuple(fo_signed)
        fv_signed = np.stack(fv_signed)

        def matv(x):
            return sum(fv_signed[d] * _sh(x, o)
                       for d, o in enumerate(fo_signed))

        n = sysm.n_nodes
        rng = np.random.default_rng(0)
        x = np.zeros(n_pad)
        x[:n] = rng.standard_normal(n)
        rho = 0.0
        for _ in range(40):
            y = x - vcycle_np(mgp, mgm, fo_signed, fv_signed, matv(x))
            y[n:] = 0.0
            ny = np.linalg.norm(y)
            if ny == 0:
                break
            rho = ny / np.linalg.norm(x)
            x = y / ny
        lmin = max(1.0 - rho, 1e-3) * 0.9
        inv_theta, c1, c2 = cheb_coefficients(self.mg_cycles, lmin, 1.02)
        self.mg_rho = float(rho)
        self._mg_cheb = (float(inv_theta),
                         tuple(float(q) for q in c1),
                         tuple(float(q) for q in c2))
        return mgp, mgm

    def _build_mg(self, slab, mg_host, shd):
        """Slab phase: distribute the MG planes. Everything slabs
        OWNED-ONLY — the V-cycle exchanges masked PRODUCTS at runtime
        (shift(m·x) reads the neighbor's m·x, which equals the product
        of the neighbor's owned values), so no static halo copies are
        needed. Plus per-device pack one-hots and the replicated
        coarsest inverse."""
        from ..core.mg import LANES

        base = self.base
        D = self.D
        nbf = self.nbf
        n_pad = base.N
        dtype = base.dtype
        mgp, mgm = mg_host
        np2 = int(mgm["np2_rows"])
        n_l1 = len(mgm["l1_offs"])
        n_t0 = len(mgm["t0_offs"])
        n_t1 = len(mgm["t1_offs"])
        self._mg_nplanes = (n_l1, n_t0, n_t1)

        own = np.concatenate([
            np.asarray(mgp["l1_vals"], np.float64).reshape(n_l1, n_pad),
            np.asarray(mgp["om_invd0"], np.float64)[None],
            np.asarray(mgp["om_invd1"], np.float64)[None],
            np.asarray(mgp["t0_masks"], np.float64).reshape(n_t0, n_pad),
            np.asarray(mgp["t1_masks"], np.float64).reshape(n_t1, n_pad),
            np.asarray(mgp["pack_mask"], np.float64).reshape(2, n_pad),
            np.asarray(mgp["unpack_mask"], np.float64).reshape(2, n_pad),
        ], 0)
        self._mgf_own = jnp.asarray(slab(own, halo=False), dtype)
        idx = np.concatenate([
            np.asarray(mgp["pack_idx"], np.int64).reshape(2, n_pad),
            np.asarray(mgp["unpack_idx"], np.int64).reshape(2, n_pad),
        ], 0)
        self._mgi_own = jnp.asarray(
            slab(idx, halo=False).astype(np.int32))
        self._a2b_r = jnp.asarray(
            np.asarray(mgp["a2inv_blocks"], np.float64), dtype)
        rows_own = nbf // LANES
        E = np.zeros((D, 2, np2, rows_own))
        for w, ranges in enumerate((mgm["rangesA"], mgm["rangesB"])):
            for cr, (lo, hi) in enumerate(ranges):
                for g in range(lo, hi):
                    d, r = divmod(g, rows_own)
                    if d < D:
                        E[d, w, cr, r] = 1.0
        self._mgE = jnp.asarray(E, dtype)
        for nm in ("_mgf_own", "_mgi_own", "_mgE"):
            setattr(self, nm, jax.device_put(getattr(self, nm), shd))
        self._a2b_r = jax.device_put(
            self._a2b_r, NamedSharding(self.mesh, P()))

    # ------------------------------------------------------------ access

    @property
    def x(self):
        return self._gather(self.state["x"])

    @property
    def v(self):
        return self._gather(self.state["v"])

    def set_positions(self, value):
        """Overwrite positions ((n, 3), layout numbering)."""
        x = np.zeros((3, self.base.N))
        x[:, :self.base.n_nodes] = np.asarray(value, np.float64).T
        self.state["x"] = self._slab_own(x)

    def set_velocities(self, value):
        """Overwrite velocities ((n, 3), layout numbering)."""
        v = np.zeros((3, self.base.N))
        v[:, :self.base.n_nodes] = np.asarray(value, np.float64).T
        self.state["v"] = self._slab_own(v)

    def _gather(self, planes):
        a = np.asarray(planes)                      # (D, 3, nbf)
        flat = a.transpose(1, 0, 2).reshape(3, self.D * self.nbf)
        return flat[:, :self.base.n_nodes].T

    def detach(self):
        """Write the slab state back into the single-device ClothStepper
        (bitwise relayout) so a stepper on another mesh can continue
        exactly from here. Returns the base stepper."""
        base = self.base
        N, nbf = base.N, self.nbf

        def unslab(a):
            a = np.asarray(a)
            flat = np.moveaxis(a, 0, -2).reshape(
                a.shape[1:-1] + (self.D * nbf,)
            )
            return flat[..., :N]

        u = np.asarray(self.state["u"])              # (D, G, 16, nbf)
        u_g = u.transpose(1, 2, 0, 3).reshape(
            base.n_groups, 16, self.D * nbf)[..., :N]
        base.state = {
            "x": jnp.asarray(unslab(self.state["x"]), base.dtype),
            "v": jnp.asarray(unslab(self.state["v"]), base.dtype),
            "u": jnp.asarray(u_g, base.dtype),
            "ancu": jnp.asarray(unslab(self.state["ancu"]),
                                base.dtype),
            "t": jnp.asarray(np.asarray(self.state["t"]), base.dtype),
        }
        return base

    # --------------------------------------------------------- stepping

    def _make_step(self):
        base = self.base
        D, Hf, nbf, L = self.D, self.Hf, self.nbf, self.L
        dt = self.dt
        dt2 = dt * dt
        iters = self.admm_iters
        cg_iters = self.cg_iters
        axis = self.axis
        groups = base.groups
        wind_groups = base.wind_groups
        wind_dir = base.wind_dir
        gvec = base.gravity
        dia_offs = base.dia_offs
        collect = bool(self.collect_residuals)
        collect_dual = self.collect_residuals is True
        fwd = [(d, d + 1) for d in range(D - 1)]
        bwd = [(d + 1, d) for d in range(D - 1)]
        solver = self.solver
        cheb_k = self.cheb_iters
        cheb_c = self._cheb_c if solver == "cheb" else None
        mg_np = None
        if solver == "mg":
            n_l1_, n_t0_, n_t1_ = self._mg_nplanes
            mg_np = {
                "split": (n_l1_, n_t0_, n_t1_),
                "np2": int(round(
                    np.asarray(self._a2b_r).shape[0] ** 0.5)),
                "l1o": self._mg_offs["l1"],
                "t0o": self._mg_offs["t0"],
                "t1o": self._mg_offs["t1"],
                "reach": dict(self._mg_reach),
                "cycles": self.mg_cycles,
                "cheb": self._mg_cheb,
            }

        def refresh(a3):
            """(3, nbf) own rows -> (3, L) with both halos."""
            if D == 1:
                z = jnp.zeros((3, Hf), a3.dtype)
                return jnp.concatenate([z, a3, z], 1)
            from_left = jax.lax.ppermute(a3[:, nbf - Hf:], axis, fwd)
            from_right = jax.lax.ppermute(a3[:, :Hf], axis, bwd)
            return jnp.concatenate([from_left, a3, from_right], 1)

        def combine(b3):
            """(3, L) scatter accumulator -> (3, nbf): own rows + the
            top-halo partials pushed down... sent UP to device d+1 (the
            owner of rows above this slab)."""
            own = b3[:, Hf:Hf + nbf]
            if D == 1:
                return own
            sent = jax.lax.ppermute(b3[:, Hf + nbf:], axis, fwd)
            return own.at[:, :Hf].add(sent)

        def sstep(masks, ancz, dia, x, v, ancu, u, *mg_in):
            masks, ancz, dia = masks[0], ancz[0], dia[0]
            x, v, ancu, u = x[0], v[0], ancu[0], u[0]
            mg_args = ((mg_in[0][0], mg_in[1][0], mg_in[2][0], mg_in[3])
                       if mg_in else None)
            dtp = x.dtype
            aw2 = masks[0]
            mvec = masks[1]
            invd = masks[2]

            def pdot(a, b):
                return jax.lax.psum(jnp.sum(a * b), axis)

            def halo_h(a, h):
                """(..., nbf) -> (..., nbf+2h): h-lane halos from the
                neighbors' owned lanes (h <= nbf)."""
                if D == 1:
                    z = jnp.zeros(a.shape[:-1] + (h,), a.dtype)
                    return jnp.concatenate([z, a, z], -1)
                fl = jax.lax.ppermute(a[..., nbf - h:], axis, fwd)
                fr = jax.lax.ppermute(a[..., :h], axis, bwd)
                return jnp.concatenate([fl, a, fr], -1)

            def mg_solve(x3, rhs3):
                """Sharded 2D geometric V-cycle with the dot-free
                Chebyshev outer (see _mg_host_build/_build_mg). Every
                level op is an owned-lane product + halo shift; the
                only non-ppermute collective is the KB-sized coarsest
                pack psum (one per cycle)."""
                mgf, mgi, E, a2b = mg_args
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
                rows_own = nbf // 128

                def apply_shift(x3_, offs_, vals_, h):
                    """out_own = sum_d vals[d] * x[. + off_d] (restrict
                    and signed-offset level matvec)."""
                    xh = halo_h(x3_, h)
                    acc = None
                    for di, o in enumerate(offs_):
                        t = vals_[di][None] * xh[:, h + o:h + o + nbf]
                        acc = t if acc is None else acc + t
                    return acc

                def prolong(x3_, offs_, masks_, h):
                    """out_own = sum_c shift(m_c * x, -c): exchange the
                    masked PRODUCTS (the neighbor's m*x equals the
                    product of its owned values)."""
                    prods = masks_[:, None, :] * x3_[None]  # (C,3,nbf)
                    ph = halo_h(prods, h)
                    acc = None
                    for di, o in enumerate(offs_):
                        t = ph[di][:, h - o:h - o + nbf]
                        acc = t if acc is None else acc + t
                    return acc

                def fine_mv(v3):
                    return matvec(refresh(v3))

                def pack(r3_):
                    acc = None
                    for w in range(2):
                        idxw = jnp.broadcast_to(
                            pidx[w].reshape(rows_own, 128)[None],
                            (3, rows_own, 128)).astype(jnp.int32)
                        g = (pmask[w].reshape(rows_own, 128)[None]
                             * jnp.take_along_axis(
                                 r3_.reshape(3, rows_own, 128),
                                 idxw, axis=2))
                        t = jnp.einsum("cr,arl->acl", E[w], g)
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
                        exp = jnp.einsum("cr,acl->arl", E[w], zp)
                        idxw = jnp.broadcast_to(
                            uidx[w].reshape(rows_own, 128)[None],
                            (3, rows_own, 128)).astype(jnp.int32)
                        t = (umask[w].reshape(rows_own, 128)[None]
                             * jnp.take_along_axis(exp, idxw, axis=2))
                        acc = t if acc is None else acc + t
                    return acc.reshape(3, nbf)

                l1o = mg_np["l1o"]
                t0o = mg_np["t0o"]
                t1o = mg_np["t1o"]
                h_l1 = mg_np["reach"]["l1"]
                h_t0 = mg_np["reach"]["t0"]
                h_t1 = mg_np["reach"]["t1"]

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

                inv_theta, c1h, c2h = mg_np["cheb"]
                k = mg_np["cycles"]
                c1a = jnp.asarray(c1h, x3.dtype)
                c2a = jnp.asarray(c2h, x3.dtype)
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
                return x3 + dvec

            def matvec(xbuf):
                """A @ xbuf own rows: (3, L) -> (3, nbf). Symmetric-dia
                storage (vals[d, i] = A[i, i+off]); vals carried WITH
                halo so the transpose term reads vals at i-off."""
                acc = jnp.zeros((3, nbf), dtp)
                for dd, off in enumerate(dia_offs):
                    w = dia[dd]
                    if off == 0:
                        acc = acc + w[Hf:Hf + nbf] * xbuf[:, Hf:Hf + nbf]
                    else:
                        acc = acc + (w[Hf:Hf + nbf]
                                     * xbuf[:, Hf + off:Hf + off + nbf])
                        acc = acc + (w[Hf - off:Hf - off + nbf]
                                     * xbuf[:, Hf - off:Hf - off + nbf])
                return acc

            # ---- prologue: park x_pre, gravity, wind, xbar
            x_pre = x
            g3 = jnp.asarray(gvec, dtp)[:, None]
            v = v + jnp.where(mvec[None] > 0, dt * g3, 0.0)
            if wind_groups:
                xbuf = refresh(x)
                vbuf = refresh(v)
                staged = []
                for offs, mrow in wind_groups:
                    px = [[xbuf[a, Hf + o:Hf + o + nbf] for a in range(3)]
                          for o in offs]
                    vm = [
                        (vbuf[a, Hf + offs[0]:Hf + offs[0] + nbf]
                         + vbuf[a, Hf + offs[1]:Hf + offs[1] + nbf]
                         + vbuf[a, Hf + offs[2]:Hf + offs[2] + nbf])
                        * (1.0 / 3.0)
                        for a in range(3)
                    ]
                    e1 = [px[1][a] - px[0][a] for a in range(3)]
                    e2 = [px[2][a] - px[0][a] for a in range(3)]
                    nx = e1[1] * e2[2] - e1[2] * e2[1]
                    ny = e1[2] * e2[0] - e1[0] * e2[2]
                    nz = e1[0] * e2[1] - e1[1] * e2[0]
                    nlen = jnp.sqrt(nx * nx + ny * ny + nz * nz)
                    inv = 1.0 / jnp.where(nlen > 0, nlen, 1.0)
                    nhat = [nx * inv, ny * inv, nz * inv]
                    area = 0.5 * nlen
                    v_n = (nhat[0] * (vm[0] - wind_dir[0])
                           + nhat[1] * (vm[1] - wind_dir[1])
                           + nhat[2] * (vm[2] - wind_dir[2]))
                    scale = ((-1000.0 * 0.33 * dt) * masks[mrow]
                             * area * v_n * jnp.abs(v_n))
                    staged.append([scale * nhat[a] for a in range(3)])
                dv = jnp.zeros((3, L), dtp)
                for (offs, _), f3 in zip(wind_groups, staged):
                    for o in offs:
                        dv = dv.at[:, Hf + o:Hf + o + nbf].add(
                            jnp.stack(f3)
                        )
                v = v + combine(dv)
            xbar = x + dt * v
            Mxbar = mvec[None] * xbar

            rp = jnp.zeros((iters,), dtp)
            rd = jnp.zeros((iters,), dtp)
            zp3 = jnp.zeros((3, nbf), dtp)
            if collect_dual:
                # z_prev seed: D^T W^2 D x_pre = (A - M) x_pre / dt^2
                zp3 = (matvec(refresh(x_pre))
                       - mvec[None] * x_pre) * (1.0 / dt2)

            def admm_it(i, carry):
                x, u, ancu, zp3, rp, rd = carry
                xbuf = refresh(x)
                b = jnp.zeros((3, L), dtp)
                zc = jnp.zeros((3, L), dtp)
                racc = jnp.asarray(0.0, dtp)
                u_new = []
                for g, spec in enumerate(groups):
                    ug = u[g]
                    if spec[0] == "tri":
                        _, offs, cp6, w2, k, lmin, lmax, mrow, lim = spec
                        f = [ug[p] for p in range(6)]
                        for kk, o in enumerate(offs):
                            for a in range(3):
                                for bb in range(2):
                                    w = float(cp6[3 * bb + kk])
                                    if w == 0.0:
                                        continue
                                    f[2 * a + bb] = f[2 * a + bb] + (
                                        w * xbuf[a, Hf + o:Hf + o + nbf]
                                    )
                        z = tri_body(f, w2, k, lmin, lmax, lim)
                        # dual update gated by validity: pad/phantom
                        # bases must not accumulate duals
                        m01 = masks[mrow]
                        un = [m01 * (f[p] - z[p]) for p in range(6)]
                        if collect:
                            m = masks[mrow]
                            racc = racc + w2 * sum(
                                jnp.sum(m * (un[p] - ug[p]) ** 2)
                                for p in range(6)
                            )
                        mm = w2 * masks[mrow]
                        zu = [mm * (f[p] - 2.0 * un[p]) for p in range(6)]
                        zz = ([mm * (f[p] - un[p]) for p in range(6)]
                              if collect_dual else None)
                        for kk, o in enumerate(offs):
                            for j in range(3):
                                acc = acc2 = None
                                for bb in range(2):
                                    w = float(cp6[3 * bb + kk])
                                    if w == 0.0:
                                        continue
                                    t = w * zu[2 * j + bb]
                                    acc = t if acc is None else acc + t
                                    if collect_dual:
                                        t2 = w * zz[2 * j + bb]
                                        acc2 = (t2 if acc2 is None
                                                else acc2 + t2)
                                if acc is None:
                                    continue
                                b = b.at[j, Hf + o:Hf + o + nbf].add(acc)
                                if collect_dual:
                                    zc = zc.at[
                                        j, Hf + o:Hf + o + nbf
                                    ].add(acc2)
                        pad16 = jnp.zeros((10, nbf), dtp)
                        u_new.append(jnp.concatenate(
                            [jnp.stack(un), pad16], 0))
                    else:  # bend
                        _, offs, arow, w2, k, mrow = spec
                        rows = ((offs[0], offs[2]), (offs[3], offs[2]),
                                (offs[1], offs[2]))
                        denom = (arow[0] ** 2 + arow[1] ** 2
                                 + arow[2] ** 2)
                        inv_denom = (2.0 / denom) if denom > 0 else 0.0
                        mix = 1.0 / (w2 + k)
                        f = [ug[p] for p in range(9)]
                        for r, (oa, ob) in enumerate(rows):
                            for j in range(3):
                                f[3 * r + j] = (
                                    f[3 * r + j]
                                    + xbuf[j, Hf + oa:Hf + oa + nbf]
                                    - xbuf[j, Hf + ob:Hf + ob + nbf]
                                )
                        un = [None] * 9
                        r2b = None
                        for j in range(3):
                            lam = inv_denom * (
                                arow[0] * f[j] + arow[1] * f[3 + j]
                                + arow[2] * f[6 + j]
                            )
                            for r in range(3):
                                fp = f[3 * r + j]
                                pr = fp - 0.5 * arow[r] * lam
                                z = (k * pr + w2 * fp) * mix
                                if collect:
                                    m = masks[mrow]
                                    t = jnp.sum(
                                        m * (fp - z - ug[3 * r + j]) ** 2
                                    )
                                    r2b = t if r2b is None else r2b + t
                                un[3 * r + j] = masks[mrow] * (fp - z)
                        if collect:
                            racc = racc + w2 * r2b
                        mm = w2 * masks[mrow]
                        zu = [mm * (f[p] - 2.0 * un[p]) for p in range(9)]
                        zz = ([mm * (f[p] - un[p]) for p in range(9)]
                              if collect_dual else None)
                        per_corner = (
                            (offs[0], (0,), 1.0),
                            (offs[1], (2,), 1.0),
                            (offs[2], (0, 1, 2), -1.0),
                            (offs[3], (1,), 1.0),
                        )
                        for o, rws, sgn in per_corner:
                            for j in range(3):
                                acc = acc2 = None
                                for r in rws:
                                    t = zu[3 * r + j]
                                    acc = t if acc is None else acc + t
                                    if collect_dual:
                                        t2 = zz[3 * r + j]
                                        acc2 = (t2 if acc2 is None
                                                else acc2 + t2)
                                b = b.at[j, Hf + o:Hf + o + nbf].add(
                                    sgn * acc)
                                if collect_dual:
                                    zc = zc.at[
                                        j, Hf + o:Hf + o + nbf
                                    ].add(sgn * acc2)
                        pad16 = jnp.zeros((7, nbf), dtp)
                        u_new.append(jnp.concatenate(
                            [jnp.stack(un), pad16], 0))
                u = (jnp.stack(u_new) if u_new
                     else jnp.zeros((0, 16, nbf), dtp))

                b3 = combine(b)
                # anchors (row-local)
                dlt = x - ancz
                ancu = jnp.where(aw2[None] > 0, ancu + dlt, 0.0)
                b3 = b3 + aw2[None] * (ancz - ancu)
                if collect:
                    racc = racc + jnp.sum(aw2[None] * dlt * dlt)
                    rp = rp.at[i].set(
                        jnp.sqrt(jax.lax.psum(racc, axis))
                    )
                if collect_dual:
                    zc3 = combine(zc) + aw2[None] * ancz
                    sd = jax.lax.psum(jnp.sum((zc3 - zp3) ** 2), axis)
                    rd = rd.at[i].set(dt2 * jnp.sqrt(sd))
                    zp3 = zc3

                if solver == "mg":
                    x = mg_solve(x, Mxbar + dt2 * b3)
                    return (x, u, ancu, zp3, rp, rd)

                if solver == "cheb":
                    # dot-free Chebyshev (parallel/cheb.py): the solve
                    # has NO psums — the only cross-device traffic is
                    # the per-iteration halo refresh of d
                    inv_theta, c1a, c2a = cheb_c
                    z = invd[None] * (Mxbar + dt2 * b3 - matvec(xbuf))
                    d3 = inv_theta * z

                    def cheb_body(j, carry):
                        x, z, d3 = carry
                        x = x + d3
                        z = z - invd[None] * matvec(refresh(d3))
                        d3 = c1a[j] * d3 + c2a[j] * z
                        return (x, z, d3)

                    x, _, d3 = jax.lax.fori_loop(
                        0, cheb_k - 1, cheb_body, (x, z, d3)
                    )
                    x = x + d3
                    return (x, u, ancu, zp3, rp, rd)

                # Jacobi-PCG from the current x
                r = Mxbar + dt2 * b3 - matvec(xbuf)
                z = invd[None] * r
                p = z
                rz = pdot(r, z)

                def body(_, carry):
                    x, r, p, rz = carry
                    Ap = matvec(refresh(p))
                    pAp = pdot(p, Ap)
                    alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
                    x = x + alpha * p
                    r = r - alpha * Ap
                    z = invd[None] * r
                    rz_new = pdot(r, z)
                    beta = rz_new / jnp.where(rz > 0, rz, 1.0)
                    return (x, r, z + beta * p, rz_new)

                x, _, _, _ = jax.lax.fori_loop(
                    0, cg_iters, body, (x, r, p, rz)
                )
                return (x, u, ancu, zp3, rp, rd)

            x, u, ancu, _, rp, rd = jax.lax.fori_loop(
                0, iters, admm_it, (xbar, u, ancu, zp3, rp, rd)
            )
            v = (x - x_pre) * (1.0 / dt)
            return x[None], v[None], ancu[None], u[None], rp, rd

        pd = P(self.axis)
        mg_specs = (pd, pd, pd, P()) if solver == "mg" else ()
        smapped = jax.shard_map(
            sstep, mesh=self.mesh,
            in_specs=(pd, pd, pd, pd, pd, pd, pd) + mg_specs,
            out_specs=(pd, pd, pd, pd, P(), P()),
            check_vma=False,
        )

        def step(params, state):
            masks, ancz, dia, *mg = params
            x, v, ancu, u, rp, rd = smapped(
                masks, ancz, dia,
                state["x"], state["v"], state["ancu"], state["u"], *mg,
            )
            return {
                "x": x, "v": v, "ancu": ancu, "u": u,
                "t": state["t"] + dt,
            }, rp, rd

        return step

    @property
    def _params(self):
        out = (self._masks, self._ancz, self._dia)
        if self.solver == "mg":
            out = out + (self._mgf_own, self._mgi_own, self._mgE,
                         self._a2b_r)
        return out

    def step(self):
        if self._stepf is None:
            self._stepf = jax.jit(highest(self._make_step()),
                                  donate_argnums=(1,))
        self.state, rp, rd = self._stepf(self._params, self.state)
        if self.collect_residuals:
            self.last_primal = rp
        if self.collect_residuals is True:
            self.last_dual = rd
        return True

    def run(self, n_steps: int):
        """Step n times; full ROLLOUT_WINDOW chunks run as ONE jitted
        lax.scan program each (one dispatch per W steps).
        Residual-collecting runs keep per-step dispatch (their
        last_primal/last_dual contract is per-step)."""
        W = self.ROLLOUT_WINDOW
        while not self.collect_residuals and n_steps >= W:
            if W not in self._runf:
                core = self._make_step()

                def runW(params, state):
                    def body(s, _):
                        s2, _rp, _rd = core(params, s)
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
        (`set_force_param` + `recompute_weights()`): re-pack the
        parameter slabs (anchor weights/targets, masks, dia matvec)
        from the System WITHOUT re-partitioning, keeping the live
        sharded state. Edits to compiled-in constants (per-group
        materials, wind direction, gravity) trigger a re-jit. Requires
        construction via `sharded_cloth_from_system`."""
        sysm = getattr(self, "_system", None)
        if sysm is None:
            raise ValueError(
                "refresh_params needs a System reference — build via "
                "sharded_cloth_from_system"
            )
        from ..core.cloth import cloth_from_system

        out = cloth_from_system(sysm)
        assert out is not None, "scene no longer qualifies for the layout"
        new_base, _ = out
        old = self.base
        assert new_base.N == old.N and new_base.n_groups == old.n_groups
        assert tuple(new_base.dia_offs) == tuple(old.dia_offs)
        recompile = (
            new_base.groups != old.groups
            or not np.array_equal(np.asarray(new_base.wind_dir),
                                  np.asarray(old.wind_dir))
            or not np.array_equal(np.asarray(new_base.gravity),
                                  np.asarray(old.gravity))
            or new_base.wind_groups != old.wind_groups
            # the mg/cheb schedules are spectrum-derived and compiled in
            or self.solver in ("cheb", "mg")
        )
        state = self.state
        self.base = new_base
        self._build()
        self.state = state
        if recompile:
            self._stepf = None
            self._runf = {}

    # ------------------------------------------------------------- stats

    def comm_stats(self):
        """Analytic per-device traffic per step: every refresh/combine
        moves 3 x Hf lanes per direction — O(grid row length),
        independent of N."""
        itemsize = jnp.dtype(self.base.dtype).itemsize
        per_exchange = 2 * 3 * self.Hf * itemsize
        # cheb iterations move the same halo but NO scalars (CG pays
        # two psum-reduced scalars per iteration)
        per_cg = per_exchange + (0 if self.solver == "cheb"
                                 else 2 * itemsize)
        n_solve = (self.cheb_iters if self.solver == "cheb"
                   else self.cg_iters)
        n_wind = 2 if self.base.wind_groups else 0
        per_admm = (per_exchange          # x refresh
                    + per_exchange // 2   # RHS combine (one direction)
                    + n_solve * per_cg)
        per_step = (self.admm_iters * per_admm
                    + n_wind * per_exchange)
        return {
            "n_devices": self.D,
            "halo_lanes": self.Hf,
            "bytes_per_cg_iter": per_cg,
            "bytes_per_admm_iter": per_admm,
            "bytes_per_step": per_step,
        }

    def measured_comm(self):
        """Collective inventory of the compiled step (parallel/comm.py):
        max_op_bytes is O(halo lanes), never O(N)."""
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


def sharded_cloth_from_system(system, mesh, axis: str = "elem",
                              solver: str = "cg", mg_cycles: int = 10,
                              cheb_iters: int | None = None):
    """Build a ShardedClothStepper from an initialized System whose
    scene qualifies for the grid-cloth layout. Returns (stepper,
    to_canonical) or None. Records the System, enabling refresh_params
    (runtime force edits) and solver='mg'."""
    from ..core.cloth import cloth_from_system

    out = cloth_from_system(system)
    if out is None:
        return None
    base, cid = out
    try:
        spmd = ShardedClothStepper(base, mesh, axis=axis, solver=solver,
                                   mg_cycles=mg_cycles, system=system,
                                   cheb_iters=cheb_iters)
    except ValueError:
        return None
    return spmd, cid
