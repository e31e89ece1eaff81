"""Boundary-halo element-sharded ADMM: O(cut) traffic per CG iteration.

`SpmdSystem` (spmd.py) keeps vertex state replicated and re-gathers the
full (n,3) CG search direction every iteration — per-device traffic is
O(n) regardless of device count. This module implements the SURVEY §2.7
design it approximates: partition vertices into contiguous slabs that
minimize the cut, give each device ONLY its slab plus the boundary rows
it references, and exchange those boundary rows point-to-point.

  * **Partition** — vertices are sorted along the mesh's longest
    bounding-box axis and cut into S equal slabs (coordinate bisection:
    for mesh graphs the cut is one cross-section, O(n^(2/3)) for
    volumes, O(n^(1/2)) for shells). Elements are owned by the slab
    holding the majority of their vertices.
  * **Ghost sets** — per device, the sorted union of off-slab vertex
    rows referenced by its elements' stencils and by its A_hat ELL rows.
    All index arrays (force selectors, ELL columns, incidence tables)
    are remapped host-side into the local address space
    [own slab | ghosts | trash-row].
  * **Exchange schedule** — for each distinct slab distance k, one
    `ppermute` moves exactly the rows device d-k lists as ghosts owned
    by d (padded, static). The same schedule runs three ways:
    refresh (owner -> ghoster: x and the CG search direction) and
    reverse-combine (ghoster -> owner: RHS partials accumulated on
    ghost rows flow back and add into their owner's rows).
  * **Per CG iteration** the cross-device traffic is one ghost refresh
    (O(cut) rows) + two psum scalars — verified against the compiled
    HLO by `measured_comm` (parallel/comm.py), not just the analytic
    formula.

The distributed reduction structure mirrors the reference's D/D^T
matvec pair (/root/reference/deps/admm-elastic-sca/src/system/
System.cpp:54-62), which its OpenMP backend evaluates in shared memory;
this is the message-passing formulation of the same operator.

Trajectory parity vs the single-device general path:
tests/test_halo_spmd.py (full depth, f64, multiple steps).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.solver import assemble_A_hat_ell, assemble_transpose_incidence
from ..utils.precision import highest
from .spmd import _round_up


class HaloSpmdSystem:
    """Boundary-halo element+vertex-sharded wrapper around an initialized
    `System` in 'ell' or 'dia' mode.

        spmd = HaloSpmdSystem(sys, mesh)      # mesh with an 'elem' axis
        spmd.step(); x = spmd.x

    Same restrictions as SpmdSystem (no residual early-exit, no
    relaxation/acceleration). All explicit forces are supported:
    uniform/indexed acceleration kicks are row-local, and WindForce
    rides the same ghost machinery (face gather + reverse-combined
    vertex scatter).
    """

    def __init__(self, system, mesh: Mesh, elem_axis: str = "elem"):
        if not system.initialized:
            raise RuntimeError("initialize() the system first")
        if system._solver_mode not in ("ell", "dia"):
            raise ValueError(
                "HaloSpmdSystem requires global_solver='ell' or 'dia'"
            )
        if system.settings.residual_tol is not None:
            raise ValueError("sharded residual early-exit not supported")
        if (system.settings.relaxation != 1.0
                or system.settings.acceleration is not None):
            raise ValueError(
                "HaloSpmdSystem runs the plain alpha=1 iteration; "
                "relaxation/acceleration need the single-device path"
            )
        self.system = system
        self.mesh = mesh
        self.axis = elem_axis
        self.S = int(mesh.shape[elem_axis])
        self._build()

    # ------------------------------------------------------------- build

    def _build(self):
        sysm = self.system
        S = self.S
        dtype = sysm.settings.dtype
        n = sysm.n_nodes
        forces = list(sysm._force_list)
        self._force_list = forces

        # ---- slab partition: sort along the longest bbox axis
        x_now = np.asarray(sysm.state["x"], np.float64)
        ext = x_now.max(0) - x_now.min(0)
        ax = int(np.argmax(ext))
        perm = np.argsort(x_now[:, ax], kind="stable")  # new -> old
        new_of_old = np.empty(n, np.int64)
        new_of_old[perm] = np.arange(n)
        self._perm, self._new_of_old = perm, new_of_old

        nb = _round_up(-(-n // S), 8)
        n_pad = S * nb
        self._nb, self._n_pad = nb, n_pad
        slab_of = lambda ids: np.minimum(ids // nb, S - 1)

        # ---- A_hat in NEW numbering (assembled from remapped selectors)
        cparams = {}
        for name in sysm._constraint_names:
            p = {k: np.asarray(v) for k, v in sysm.params[name].items()}
            p["indices"] = new_of_old[p["indices"]].astype(np.int32)
            cparams[name] = p
        # _mi: the f64 internal-order masses the System itself assembles
        # from (system.py:425); _masses_dev is its dtype-cast copy
        masses_new = np.asarray(sysm._mi, np.float64)[perm]
        ell_idx, ell_vals, diag = assemble_A_hat_ell(
            n, masses_new, sysm.settings.timestep_s, cparams
        )
        K = ell_idx.shape[1]

        # ---- element ownership (majority slab) + ghost candidates
        ghost_sets = [set() for _ in range(S)]
        own_elems = {}
        for f in forces:
            nidx = cparams[f.name]["indices"]  # (E,Kf) new ids
            sl = slab_of(nidx.astype(np.int64))
            # majority vote over the stencil
            owner = np.array([
                np.bincount(row, minlength=S).argmax() for row in sl
            ])
            own_elems[f.name] = [np.flatnonzero(owner == d)
                                 for d in range(S)]
            for d in range(S):
                ix = own_elems[f.name][d]
                # devices owning no elements of this force pad with
                # element 0 (weight 0) — valid geometry keeps every
                # projection finite (0*NaN = NaN would poison the psum)
                ids = nidx[ix if len(ix) else [0]].ravel()
                off = ids[(ids < d * nb) | (ids >= (d + 1) * nb)]
                ghost_sets[d].update(int(g) for g in off)
        for d in range(S):
            rows = ell_idx[d * nb:min((d + 1) * nb, n)]
            off = rows[(rows < d * nb) | (rows >= (d + 1) * nb)]
            ghost_sets[d].update(int(g) for g in off.ravel())

        # wind faces: owned by majority slab; their vertices join the
        # ghost sets (the kick gathers x/v rows and scatters dv rows
        # through the same exchange machinery as the constraints)
        from ..models.explicit import WindForce

        wind_meta = []
        for e in sysm._explicit_list:
            if not isinstance(e, WindForce):
                continue
            tris = new_of_old[
                np.asarray(sysm.params[e.name]["tris"], np.int64)
            ]
            sl = slab_of(tris)
            owner = np.array([
                np.bincount(row, minlength=S).argmax() for row in sl
            ])
            per_dev = [np.flatnonzero(owner == d) for d in range(S)]
            for d in range(S):
                ix = per_dev[d]
                ids = tris[ix if len(ix) else [0]].ravel()
                off = ids[(ids < d * nb) | (ids >= (d + 1) * nb)]
                ghost_sets[d].update(int(g) for g in off)
            wind_meta.append((e, tris, per_dev))

        self._own_elems = own_elems  # force name -> [ids per device]
        ghosts = [np.array(sorted(g), np.int64) for g in ghost_sets]
        G = max((len(g) for g in ghosts), default=0)
        G = max(_round_up(G, 8), 8)
        self._G = G
        self._ghosts = ghosts
        trash = nb + G  # local buffer: [0,nb) own, [nb,nb+G) ghost, trash

        def to_local(ids, d):
            """Map NEW global ids -> device-d local buffer ids."""
            ids = np.asarray(ids, np.int64)
            out = np.full(ids.shape, trash, np.int64)
            in_slab = (ids >= d * nb) & (ids < (d + 1) * nb)
            out[in_slab] = ids[in_slab] - d * nb
            gl = ghosts[d]
            if len(gl):
                pos = np.searchsorted(gl, ids)
                pos = np.clip(pos, 0, len(gl) - 1)
                is_g = (~in_slab) & (gl[pos] == ids)
                out[is_g] = nb + pos[is_g]
            assert (in_slab | (out != trash) | (ids >= n)).all(), \
                "vertex reference outside slab+ghost set"
            return out

        # ---- exchange schedule: per slab-distance k, (send_idx, recv_pos)
        hops = sorted({
            int(slab_of(np.int64(g))) - d
            for d in range(S) for g in ghosts[d]
        })
        sched = []
        for k in hops:
            per_recv = []  # device d receives from d+k
            for d in range(S):
                src = d + k
                if 0 <= src < S:
                    ids = ghosts[d][slab_of(ghosts[d]) == src]
                else:
                    ids = np.array([], np.int64)
                per_recv.append(ids)
            Lk = _round_up(max((len(i) for i in per_recv), default=1), 8)
            send = np.full((S, Lk), nb, np.int32)   # pad -> own trash row
            recv = np.full((S, Lk), G, np.int32)    # pad -> ghost trash
            for d in range(S):
                ids = per_recv[d]
                src = d + k
                if len(ids) == 0:
                    continue
                send[src, :len(ids)] = ids - src * nb
                recv[d, :len(ids)] = np.searchsorted(ghosts[d], ids)
            fwd = [(m, m - k) for m in range(S) if 0 <= m - k < S]
            rev = [(m - k, m) for m in range(S) if 0 <= m - k < S]
            sched.append((k, Lk, send, recv, fwd, rev))
        self._sched_meta = [(k, Lk) for k, Lk, *_ in sched]
        self._sched = sched

        # ---- wind faces in LOCAL numbering (+ scatter incidence)
        wind_shd = {}
        self._wind_names = set()
        for e, tris, per_dev in wind_meta:
            self._wind_names.add(e.name)
            Ft = _round_up(max(1, max(len(ix) for ix in per_dev)), 8)
            tl = np.zeros((S, Ft, 3), np.int64)
            scale = np.zeros((S, Ft), np.float64)
            incs_w = []
            tot_w = None
            for d in range(S):
                ix = per_dev[d]
                fill = ix[-1] if len(ix) else 0
                src = np.concatenate(
                    [ix, np.full(Ft - len(ix), fill, np.int64)]
                )
                tl[d] = to_local(tris[src], d)
                scale[d, :len(ix)] = 1.0
                inc_w, tot_w = assemble_transpose_incidence(
                    nb + G + 1, {"w": {"indices": tl[d]}}, ["w"]
                )
                incs_w.append(inc_w)
            Dw = max(i.shape[1] for i in incs_w)
            incs_w = [np.pad(i, ((0, 0), (0, Dw - i.shape[1])),
                             constant_values=tot_w) for i in incs_w]
            wind_shd[e.name] = {
                "tris": tl.astype(np.int32),
                "scale": scale,
                "inc": np.stack(incs_w, 0),
                "direction": np.broadcast_to(
                    np.asarray(sysm.params[e.name]["direction"],
                               np.float64), (S, 3)).copy(),
            }

        # ---- per-device force data in LOCAL numbering
        shd_params = {}
        shd_u = {}
        shd_state = {}
        for f in forces:
            p = {k: np.asarray(v) for k, v in sysm.params[f.name].items()}
            E = f.n_elements
            per_dev = own_elems[f.name]
            El = _round_up(max(1, max(len(ix) for ix in per_dev)), 8)

            u_g = np.asarray(sysm.state["u"][f.name])
            st_g = {k: np.asarray(v)
                    for k, v in sysm.state["forces"][f.name].items()}

            loc_p = {k: [] for k in p}
            loc_u = []
            loc_st = {k: [] for k in st_g}
            for d in range(S):
                ix = per_dev[d]
                # pad source rows: replicate the device's last element
                # (or global element 0 for empty devices) — always valid
                # geometry, weight 0 below
                fill = ix[-1] if len(ix) else 0
                src = np.concatenate(
                    [ix, np.full(El - len(ix), fill, np.int64)]
                )
                for k, v in p.items():
                    if v.ndim >= 1 and v.shape[0] == E:
                        loc_p[k].append(v[src])
                    else:
                        loc_p[k].append(v)
                w = loc_p["weight"][-1].copy()
                w[len(ix):] = 0.0
                loc_p["weight"][-1] = w
                # selector indices -> local buffer space
                loc_p["indices"][-1] = to_local(
                    cparams[f.name]["indices"][src], d
                ).astype(np.int32)
                u_d = np.zeros((El,) + u_g.shape[1:], u_g.dtype)
                u_d[:len(ix)] = u_g[ix]
                loc_u.append(u_d)
                for k, v in st_g.items():
                    if v.ndim >= 1 and v.shape[0] == E:
                        loc_st[k].append(v[src])
                    else:
                        loc_st[k].append(v)
            stacked = {k: np.stack(vs, 0) for k, vs in loc_p.items()}
            shd_params[f.name] = stacked
            shd_u[f.name] = np.stack(loc_u, 0)
            shd_state[f.name] = {k: np.stack(vs, 0)
                                 for k, vs in loc_st.items()}

        # ---- local incidence over [own|ghost|trash] rows
        order = [f.name for f in forces]
        incs = []
        total = None
        for d in range(S):
            fp = {nm: {"indices": shd_params[nm]["indices"][d]}
                  for nm in order}
            inc, tot = assemble_transpose_incidence(trash + 1, fp, order)
            incs.append(inc)
            total = tot
        Dmax = max(i.shape[1] for i in incs)
        incs = [np.pad(i, ((0, 0), (0, Dmax - i.shape[1])),
                       constant_values=total) for i in incs]
        self._local_total = total
        shd_solver = {"inc": np.stack(incs, 0)}

        # ---- row-sharded ELL in local column space
        idx_l = np.zeros((S, nb, K), np.int32)
        vals_l = np.zeros((S, nb, K), ell_vals.dtype)
        diag_l = np.ones((S, nb), diag.dtype)
        for d in range(S):
            lo, hi = d * nb, min((d + 1) * nb, n)
            if hi > lo:
                idx_l[d, :hi - lo] = to_local(ell_idx[lo:hi], d)
                vals_l[d, :hi - lo] = ell_vals[lo:hi]
                diag_l[d, :hi - lo] = diag[lo:hi]
            idx_l[d, hi - lo:] = trash
        shd_solver["ell_idx"] = idx_l
        shd_solver["ell_vals"] = vals_l
        shd_solver["diag"] = diag_l

        # masses / valid mask / explicit index lists per slab
        m_l = np.zeros((S, nb), np.float64)
        valid = np.zeros((S, nb), np.float64)
        for d in range(S):
            lo, hi = d * nb, min((d + 1) * nb, n)
            m_l[d, :hi - lo] = masses_new[lo:hi]
            valid[d, :hi - lo] = 1.0
        shd_solver["masses"] = m_l
        shd_solver["valid"] = valid

        exp_params = {}
        for e in sysm._explicit_list:
            if e.name in self._wind_names:
                continue  # handled via wind_shd
            p = {k: np.asarray(v) for k, v in sysm.params[e.name].items()}
            if "indices" in p:
                nid = new_of_old[p["indices"]]
                per = [nid[slab_of(nid) == d] - d * nb for d in range(S)]
                L = _round_up(max(1, max(len(i) for i in per)), 8)
                il = np.full((S, L), nb, np.int32)  # pad -> trash row
                for d in range(S):
                    il[d, :len(per[d])] = per[d]
                p["indices"] = il
            else:
                p = {k: np.broadcast_to(v, (S,) + v.shape).copy()
                     for k, v in p.items()}
                exp_params[e.name] = p
                continue
            p = {
                k: (v if k == "indices"
                    else np.broadcast_to(v, (S,) + v.shape).copy())
                for k, v in p.items()
            }
            exp_params[e.name] = p

        x_new = x_now[perm]
        v_new = np.asarray(sysm.state["v"], np.float64)[perm]
        x_l = np.zeros((S, nb, 3))
        v_l = np.zeros((S, nb, 3))
        for d in range(S):
            lo, hi = d * nb, min((d + 1) * nb, n)
            x_l[d, :hi - lo] = x_new[lo:hi]
            v_l[d, :hi - lo] = v_new[lo:hi]

        def cast(a):
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                return jnp.asarray(a, dtype)
            return jnp.asarray(a)

        shd_all = jax.tree_util.tree_map(cast, {
            "params": shd_params, "solver": shd_solver, "u": shd_u,
            "fstate": shd_state, "explicit": exp_params,
            "windf": wind_shd,
            "sched": {
                f"s{i}": {"send": s[2], "recv": s[3]}
                for i, s in enumerate(sched)
            },
        })
        state = jax.tree_util.tree_map(cast, {
            "x": x_l, "v": v_l,
        })
        state["t"] = jnp.asarray(sysm.state["t"], dtype)

        elem_shd = NamedSharding(self.mesh, P(self.axis))
        rep_shd = NamedSharding(self.mesh, P())
        put = lambda t, s: jax.tree_util.tree_map(
            lambda a: jax.device_put(a, s), t
        )
        self.shd = put(shd_all, elem_shd)
        self.state = {
            "x": jax.device_put(state["x"], elem_shd),
            "v": jax.device_put(state["v"], elem_shd),
            "t": jax.device_put(state["t"], rep_shd),
        }
        self._core_fn = self._make_step()
        self._step_fn = jax.jit(highest(self._core_fn),
                                donate_argnums=(0, 1))
        self._run_fn = {}
        self.last_aux = {}

    # ------------------------------------------------------------- step

    def _make_step(self):
        sysm = self.system
        forces = list(self._force_list)
        explicit = list(sysm._explicit_list)
        dt = sysm.settings.timestep_s
        dt2 = dt * dt
        iters = sysm.settings.admm_iters
        cg_fixed = sysm.settings.cg_fixed_iters or 25
        collect = bool(sysm.settings.collect_residuals)
        collect_dual = sysm.settings.collect_residuals is True
        nb, G = self._nb, self._G
        S, axis = self.S, self.axis
        sched_meta = list(self._sched_meta)
        scheds = list(self._sched)
        wind_names = set(self._wind_names)

        def shard_step(state, shd):
            loc = jax.tree_util.tree_map(lambda a: a[0], shd)
            x_loc, v_loc = state["x"][0], state["v"][0]
            masses = loc["solver"]["masses"]
            valid = loc["solver"]["valid"][:, None]
            inc = loc["solver"]["inc"]
            ell_idx = loc["solver"]["ell_idx"]
            ell_vals = loc["solver"]["ell_vals"]
            inv_diag = 1.0 / loc["solver"]["diag"]
            dtp = x_loc.dtype

            def refresh(a_loc):
                """own rows (nb,3) -> local buffer (nb+G+1, 3): slab +
                ghosts exchanged from their owners + zero trash row."""
                ghost = jnp.zeros((G + 1, 3), dtp)
                a_ext = jnp.concatenate(
                    [a_loc, jnp.zeros((1, 3), dtp)], 0
                )
                for i, (k, Lk, *_rest) in enumerate(sched_meta):
                    sc = loc["sched"][f"s{i}"]
                    sent = a_ext[sc["send"]]
                    got = jax.lax.ppermute(sent, axis, scheds[i][4])
                    ghost = ghost.at[sc["recv"]].set(got)
                return jnp.concatenate(
                    [a_loc, ghost[:G], jnp.zeros((1, 3), dtp)], 0
                )

            def combine(partial):
                """(nb+G+1, w) scatter partials: ghost rows flow back to
                their owners and add into own rows. Returns (nb, w)."""
                w = partial.shape[1]
                own = jnp.concatenate(
                    [partial[:nb], jnp.zeros((1, w), dtp)], 0
                )
                gpart = partial[nb:]  # (G+1, w), trash included
                for i, (k, Lk, *_rest) in enumerate(sched_meta):
                    sc = loc["sched"][f"s{i}"]
                    sent = gpart[sc["recv"]]
                    got = jax.lax.ppermute(sent, axis, scheds[i][5])
                    own = own.at[sc["send"]].add(got)
                return own[:nb]

            def matvec(xbuf):
                return jnp.einsum("nk,nkj->nj", ell_vals, xbuf[ell_idx])

            def pdot(a, b):
                return jax.lax.psum(jnp.vdot(a, b), axis)

            # explicit kicks (in declaration order, like System.step)
            for e in explicit:
                if e.name in wind_names:
                    # Wejchert-Haumann face drag (ExplicitForce.cpp:
                    # 42-98): gather x/v through the halo, compute the
                    # per-face force on OWNED faces, scatter 3 equal
                    # vertex rows through the incidence, reverse-combine
                    # ghost partials into their owners
                    wf = loc["windf"][e.name]
                    xbuf = refresh(x_loc)
                    vbuf = refresh(valid * v_loc)
                    tri = wf["tris"]
                    p3 = xbuf[tri]            # (Ft,3,3)
                    tv = vbuf[tri]
                    curr_v = jnp.mean(tv, axis=1)
                    v_r = curr_v - wf["direction"]
                    nrm = jnp.cross(p3[:, 1] - p3[:, 0],
                                    p3[:, 2] - p3[:, 0])
                    n_len = jnp.linalg.norm(nrm, axis=1, keepdims=True)
                    normal = nrm / jnp.where(n_len > 0, n_len, 1.0)
                    area = 0.5 * n_len[:, 0]
                    v_n = jnp.einsum("fj,fj->f", normal, v_r)
                    force = (
                        -e.ALPHA_N * (area * v_n * jnp.abs(v_n)
                                      * wf["scale"])[:, None] * normal
                    ) * (0.33 * dt)
                    contrib = jnp.broadcast_to(
                        force[:, None, :], tri.shape[:2] + (3,)
                    ).reshape(-1, 3)
                    flat = jnp.concatenate(
                        [contrib, jnp.zeros((1, 3), dtp)], 0
                    )
                    dv = combine(jnp.sum(flat[wf["inc"]], axis=1))
                    v_loc = v_loc + dv
                    continue
                p = loc["explicit"][e.name]
                d = p["direction"]
                if "indices" in p:
                    v_ext = jnp.concatenate(
                        [v_loc, jnp.zeros((1, 3), dtp)], 0
                    )
                    v_loc = v_ext.at[p["indices"]].add(dt * d)[:nb]
                else:
                    v_loc = v_loc + dt * d
            v_loc = valid * v_loc

            x0 = x_loc
            xbar = x_loc + dt * v_loc
            Mxbar = masses[:, None] * xbar

            def cg_solve(b, x_l):
                r = b - matvec(refresh(x_l))
                z = inv_diag[:, None] * r
                p = z
                rz = pdot(r, z)

                def body(_, carry):
                    x_l, r, p, rz = carry
                    Ap = matvec(refresh(p))
                    pAp = pdot(p, Ap)
                    alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
                    x_l = x_l + alpha * p
                    r = r - alpha * Ap
                    z = inv_diag[:, None] * r
                    rz_new = pdot(r, z)
                    beta = rz_new / jnp.where(rz > 0, rz, 1.0)
                    return (x_l, r, z + beta * p, rz_new)

                x_l, *_ = jax.lax.fori_loop(
                    0, cg_fixed, body, (x_l, r, p, rz)
                )
                return x_l

            width = 6 if collect_dual else 3

            def iteration(i, carry):
                curr_x, u, fstate, rc, rp, rd = carry
                xbuf = refresh(curr_x)
                new_u = {}
                new_fstate = {}
                contribs = []
                for f in forces:
                    lp = loc["params"][f.name]
                    if getattr(f, "supports_fused_local_rhs", False):
                        zf, uf, sf, cf = f.fused_local_rhs(
                            lp, xbuf, u[f.name], fstate[f.name],
                            with_z=collect_dual,
                        )
                    else:
                        Dx = f.compute_Dx(lp, xbuf)
                        zf, uf, sf = f.project_with_dual(
                            Dx, u[f.name], lp, fstate[f.name]
                        )
                        cf = (f.rhs_contribution6(lp, zf, uf)
                              if collect_dual
                              else f.rhs_contribution(lp, zf, uf))
                    new_u[f.name] = uf
                    new_fstate[f.name] = sf
                    contribs.append(cf)
                contribs.append(jnp.zeros((1, width), dtp))  # sentinel
                flat = jnp.concatenate(contribs, 0)
                partial = jnp.sum(flat[inc], axis=1)  # (nb+G+1, width)
                out = combine(partial)
                b = Mxbar + dt2 * out[:, :3]
                new_x = valid * cg_solve(b, curr_x)

                new_rc = rc
                if collect:
                    r2 = 0.0
                    for f in forces:
                        r2 = r2 + f.primal_piece(
                            loc["params"][f.name], new_u[f.name], u[f.name]
                        )
                    rp = rp.at[i].set(jnp.sqrt(jax.lax.psum(r2, axis)))
                if collect_dual:
                    Tz = out[:, 3:]
                    rd = rd.at[i].set(jnp.sqrt(jax.lax.psum(
                        jnp.sum((Tz - rc) ** 2), axis
                    )) * dt2)
                    new_rc = Tz
                return (new_x, new_u, new_fstate, new_rc, rp, rd)

            res_shape = (iters,) if collect else (0,)
            rp0 = jnp.zeros(res_shape, dtp)
            rd0 = jnp.zeros(res_shape, dtp)
            if collect_dual:
                xbuf0 = refresh(x0)
                c0 = []
                for f in forces:
                    lp = loc["params"][f.name]
                    z0f = f.compute_Dx(lp, xbuf0)
                    c0.append(f.rhs_contribution6(
                        lp, z0f, jnp.zeros_like(z0f)
                    ))
                c0.append(jnp.zeros((1, 6), dtp))
                rc0 = combine(
                    jnp.sum(jnp.concatenate(c0, 0)[inc], axis=1)
                )[:, 3:]
            else:
                rc0 = jnp.zeros((1, 3), dtp)

            curr_x, u, fstate, _, rp, rd = jax.lax.fori_loop(
                0, iters, iteration,
                (xbar, loc["u"], loc["fstate"], rc0, rp0, rd0),
            )
            aux = {}
            if collect:
                aux["primal_residual"] = rp
            if collect_dual:
                aux["dual_residual"] = rd

            new_state = {
                "x": curr_x[None],
                "v": (valid * (curr_x - x0) / dt)[None],
                "t": state["t"] + dt,
            }
            expand = lambda t: jax.tree_util.tree_map(lambda a: a[None], t)
            new_shd = dict(shd)
            new_shd["u"] = expand(u)
            new_shd["fstate"] = expand(fstate)
            return new_state, new_shd, aux

        aux_spec = {}
        if collect:
            aux_spec["primal_residual"] = P()
        if collect_dual:
            aux_spec["dual_residual"] = P()
        pd = P(self.axis)
        state_spec = {"x": pd, "v": pd, "t": P()}
        return jax.shard_map(
            shard_step, mesh=self.mesh,
            in_specs=(state_spec, pd),
            out_specs=(state_spec, pd, aux_spec),
            check_vma=False,
        )

    # ------------------------------------------------------------ driving

    def step(self):
        self.state, self.shd, self.last_aux = self._step_fn(
            self.state, self.shd
        )
        return True

    #: steps fused into one lax.scan program by run() (one dispatch per
    #: window instead of one per step)
    ROLLOUT_WINDOW = 10

    def run(self, n_steps: int):
        """Step n times; full ROLLOUT_WINDOW chunks run as one jitted
        lax.scan program each. The per-step last_aux contract keeps
        residual-collecting runs on per-step dispatch."""
        W = self.ROLLOUT_WINDOW
        collecting = bool(self.system.settings.collect_residuals)
        while not collecting and n_steps >= W:
            if W not in self._run_fn:
                core = self._core_fn

                def runW(state, shd):
                    def body(carry, _):
                        st, sh, _aux = core(*carry)
                        return (st, sh), None

                    (st, sh), _ = jax.lax.scan(
                        body, (state, shd), None, length=W)
                    return st, sh

                self._run_fn[W] = jax.jit(highest(runW),
                                          donate_argnums=(0, 1))
            self.state, self.shd = self._run_fn[W](self.state, self.shd)
            n_steps -= W
        for _ in range(n_steps):
            self.step()
        return True

    @property
    def x(self) -> np.ndarray:
        return self._gather(self.state["x"])

    @property
    def v(self) -> np.ndarray:
        return self._gather(self.state["v"])

    def _gather(self, a) -> np.ndarray:
        n = self.system.n_nodes
        flat = np.asarray(a).reshape(self.S * self._nb, 3)[:n]
        return flat[self._new_of_old]

    def refresh_params(self):
        """After runtime force edits on the wrapped System
        (`set_force_param` / `set_force_state` — the poordillo
        grab/release pattern, System.cpp:159-179): re-slice parameter
        values, re-assemble the sharded operator (A_hat ELL, weights,
        exchange schedules), and rebuild the step, carrying the live
        x/v/t/duals over from the sharded state. The System's `params`
        and `state['forces']` are authoritative (user-edited); duals and
        kinematic state come from the wrapper. Host-side rebuild, like
        the reference's re-factorization."""
        self.detach(sync_fstate=False)
        self._build()

    def detach(self, sync_fstate: bool = True):
        """Write the sharded state back into the wrapped System's state
        (positions, velocities, time, duals, per-force warm starts), so
        the System's checkpoint/save machinery (utils/checkpoint.py) and
        single-device stepping continue EXACTLY from here — multi-chip
        checkpoint/resume rides the existing path. Returns the System.

        sync_fstate=False leaves `state['forces']` untouched (used by
        refresh_params, where user edits there are authoritative)."""
        import jax

        sysm = self.system
        dtype = sysm.settings.dtype
        state = dict(sysm.state)
        state["x"] = jnp.asarray(self.x, dtype)
        state["v"] = jnp.asarray(self.v, dtype)
        state["t"] = jnp.asarray(np.asarray(self.state["t"]), dtype)
        u_all = {}
        f_all = {}
        for f in self._force_list:
            per_dev = self._own_elems[f.name]
            u_shd = np.asarray(self.shd["u"][f.name])
            u_g = np.array(np.asarray(sysm.state["u"][f.name]))
            st_g = {k: np.array(np.asarray(v))
                    for k, v in sysm.state["forces"][f.name].items()}
            st_shd = {k: np.asarray(v)
                      for k, v in self.shd["fstate"][f.name].items()}
            for d, ix in enumerate(per_dev):
                if not len(ix):
                    continue
                u_g[ix] = u_shd[d][:len(ix)]
                if not sync_fstate:
                    continue
                for k, v in st_g.items():
                    if v.ndim >= 1 and v.shape[0] == f.n_elements:
                        v[ix] = st_shd[k][d][:len(ix)]
            u_all[f.name] = jnp.asarray(u_g, dtype)
            if sync_fstate:
                f_all[f.name] = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a), st_g
                )
        state["u"] = u_all
        if sync_fstate:
            state["forces"] = f_all
        sysm.state = state
        return sysm

    # -------------------------------------------------------------- stats

    def comm_stats(self) -> dict:
        """Analytic per-device traffic: every refresh/combine moves the
        padded exchange-schedule rows (O(cut)); psums are scalars."""
        itemsize = jnp.dtype(self.system.settings.dtype).itemsize
        iters = self.system.settings.admm_iters
        cg = self.system.settings.cg_fixed_iters or 25
        rows = sum(Lk for _, Lk in self._sched_meta)
        per_exchange = rows * 3 * itemsize
        per_cg = per_exchange + 2 * itemsize
        per_admm = (per_exchange          # x refresh for the local step
                    + 2 * per_exchange    # RHS combine (width<=6)
                    + (cg + 1) * per_cg)  # +1: initial residual refresh
        return {
            "n_devices": self.S,
            "ghost_rows_max": self._G,
            "exchange_rows": rows,
            "hops": [k for k, _ in self._sched_meta],
            "bytes_per_cg_iter": per_cg,
            "bytes_per_admm_iter": per_admm,
            "bytes_per_step": iters * per_admm,
        }

    def measured_comm(self) -> dict:
        """Collective inventory of the compiled step (parallel/comm.py).
        The pin: `max_op_bytes` is O(cut) — the exchange-schedule rows —
        never O(n)."""
        from .comm import compiled_hlo_text, hlo_collective_report

        rep = hlo_collective_report(
            compiled_hlo_text(self._step_fn, self.state, self.shd)
        )
        rep["admm_iters"] = self.system.settings.admm_iters
        rep["cg_iters"] = self.system.settings.cg_fixed_iters or 25
        return rep
