"""SPMD element-sharded ADMM step (per-shard local steps + precomputed-ELL
global CG) under `jax.shard_map`.

This is the multi-chip design SURVEY §2.6-2.7 calls for, distributing the
reduction structure of the reference's sparse matvecs (System.cpp:54-62):

  * **Local step** — each shard owns a contiguous block of every constraint
    batch (elements padded per-shard, pad weight 0) and runs the SAME local
    step as the single-device path on its local block: selector apply ->
    SVD -> prox -> dual update -> D^T W^2 (z-u) contribution.
  * **RHS combine (the halo exchange)** — each shard reduces its local
    contribution rows through a per-shard vertex incidence table (gather +
    sum, scatter-free), then a single `psum` over the element axis combines
    shard-partial vertex sums: b = M x̄ + dt² Σ_shards T_s(contribs_s).
    Interior vertices of a shard receive zero from every other shard, so the
    psum IS the boundary-vertex halo combine, with deterministic ordering.
  * **Global CG** — A_hat rows (vertices) are block-sharded. Each CG
    iteration: local ELL matvec rows against the replicated search
    direction, `psum`'d scalar dots, block-local vector updates, and one
    `all_gather` to re-replicate the search direction. Per-iteration
    cross-device traffic: one (n,3) all_gather + 2 scalar psums — the
    CG-dots + vertex-halo traffic pattern of SURVEY §2.7.

Vertex positions stay replicated (every shard needs arbitrary x rows for
its element gathers); element data, duals, warm starts, incidence tables
and matrix rows are sharded. Trajectories match the single-device path to
reduction-reorder round-off (exactly testable in f64).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.solver import assemble_transpose_incidence
from ..utils.precision import highest


def _round_up(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def _pad_rows(a: np.ndarray, target: int) -> np.ndarray:
    """Pad leading dim by replicating the last row (valid-geometry no-op)."""
    if a.shape[0] == target:
        return a
    tail = np.broadcast_to(a[-1:], (target - a.shape[0],) + a.shape[1:])
    return np.concatenate([a, tail], axis=0)


class SpmdSystem:
    """Element-sharded SPMD wrapper around an initialized `System` in
    'ell' mode. Usage:

        sys.initialize()                      # global_solver='ell'
        spmd = SpmdSystem(sys, mesh)          # mesh with an 'elem' axis
        spmd.step()                           # or spmd.run(n)
        x = spmd.x                            # gathered positions

    Restrictions: no per-step host callbacks inside run();
    residual-driven early exit needs the single-device path; dia mode
    routes through ell row-sharding. With collect_residuals, per-step
    aux lands in `last_aux` ("primal" = primal only; True adds the dual
    via 6-wide contribution rows — each shard reduces its local pieces
    and one psum replicates the scalars).
    """

    def __init__(self, system, mesh: Mesh, elem_axis: str = "elem"):
        if not system.initialized:
            raise RuntimeError("initialize() the system first")
        if system._solver_mode not in ("ell", "dia"):
            raise ValueError(
                "SpmdSystem requires global_solver='ell' or 'dia'; got "
                f"{system._solver_mode!r}"
            )
        if system.settings.residual_tol is not None:
            raise ValueError("sharded residual early-exit not supported")
        if (system.settings.relaxation != 1.0
                or system.settings.acceleration is not None):
            raise ValueError(
                "SpmdSystem runs the plain alpha=1 reference iteration; "
                "relaxation/acceleration need the single-device general path"
            )
        self.system = system
        self.mesh = mesh
        self.axis = elem_axis
        self.S = mesh.shape[elem_axis]
        self._build()

    # ------------------------------------------------------------- build

    def _build(self):
        sysm = self.system
        S = self.S
        dtype = sysm.settings.dtype
        n = sysm.n_nodes
        forces = list(sysm._force_list)

        shd_params = {}
        shd_u = {}
        shd_state = {}
        self._force_list = forces

        for f in forces:
            p = {k: np.asarray(v) for k, v in sysm.params[f.name].items()}
            E = f.n_elements
            El = _round_up(_round_up(E, S) // S, 8)
            target = S * El

            # element-leading params: pad by replicating the last element,
            # then zero the pad weights so padded elements vanish from every
            # reduction and from the (already assembled) global matrix
            padded = {}
            for k, v in p.items():
                if v.ndim >= 1 and v.shape[0] == E:
                    padded[k] = _pad_rows(v, target)
                else:
                    padded[k] = v
            padded["weight"] = padded["weight"].copy()
            padded["weight"][E:] = 0.0

            local = {}
            for k, v in padded.items():
                if v.ndim >= 1 and v.shape[0] == target:
                    local[k] = v.reshape((S, El) + v.shape[1:])
                else:
                    # broadcast scalars/small arrays per shard
                    local[k] = np.broadcast_to(v, (S,) + v.shape).copy()
            shd_params[f.name] = local

            # duals + per-element state, re-partitioned from the live state
            u = np.asarray(sysm.state["u"][f.name])
            up = np.zeros((target,) + u.shape[1:], u.dtype)
            up[:E] = u[:E]
            shd_u[f.name] = up.reshape((S, El) + u.shape[1:])

            st = {}
            for k, v in sysm.state["forces"][f.name].items():
                v = np.asarray(v)
                if v.ndim >= 1 and v.shape[0] == E:
                    st[k] = _pad_rows(v, target).reshape(
                        (S, El) + v.shape[1:]
                    )
                else:
                    st[k] = np.broadcast_to(v, (S,) + v.shape).copy()
            shd_state[f.name] = st

        # per-shard vertex incidence over the concatenated LOCAL flat rows
        order = [f.name for f in forces]
        incs = []
        total = None
        for s in range(S):
            fp = {
                name: {"indices": shd_params[name]["indices"][s]}
                for name in order
            }
            inc, tot = assemble_transpose_incidence(n, fp, order)
            incs.append(inc)
            total = tot
        D = max(i.shape[1] for i in incs)
        incs = [
            np.pad(i, ((0, 0), (0, D - i.shape[1])), constant_values=total)
            for i in incs
        ]
        self._local_total = total
        shd_solver = {"inc": np.stack(incs, axis=0)}

        # row-sharded ELL operator (pad rows to S*nb with identity rows).
        # dia-mode systems (sparse-diagonal CG on one device) re-assemble the
        # same matrix in ELL form here: the row-sharded matvec is the
        # distributed formulation of the same solve.
        if sysm._solver_mode == "dia":
            from ..core.solver import assemble_A_hat_ell

            cparams = {
                k: jax.tree_util.tree_map(np.asarray, sysm.params[k])
                for k in sysm._constraint_names
            }
            masses_np = np.asarray(getattr(sysm, "_mi", sysm._m))
            ell_idx, ell_vals, diag = assemble_A_hat_ell(
                n, masses_np, sysm.settings.timestep_s, cparams
            )
        else:
            ell_idx = np.asarray(sysm.params["_solver"]["ell_idx"])
            ell_vals = np.asarray(sysm.params["_solver"]["ell_vals"])
            diag = np.asarray(sysm.params["_solver"]["diag"])
        nb = _round_up(_round_up(n, S) // S, 8)
        n_pad = S * nb
        K = ell_idx.shape[1]
        idx_p = np.zeros((n_pad, K), np.int32)
        vals_p = np.zeros((n_pad, K), ell_vals.dtype)
        diag_p = np.ones((n_pad,), diag.dtype)
        idx_p[:n] = ell_idx
        vals_p[:n] = ell_vals
        diag_p[:n] = diag
        shd_solver["ell_idx"] = idx_p.reshape(S, nb, K)
        shd_solver["ell_vals"] = vals_p.reshape(S, nb, K)
        shd_solver["diag"] = diag_p.reshape(S, nb)
        self._nb, self._n_pad = nb, n_pad

        def cast(a):
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                return jnp.asarray(a, dtype)
            return jnp.asarray(a)

        tree_cast = lambda t: jax.tree_util.tree_map(cast, t)

        elem_sharding = NamedSharding(
            self.mesh, P(self.axis)
        )
        rep_sharding = NamedSharding(self.mesh, P())

        def place_shd(t):
            return jax.tree_util.tree_map(
                lambda a: jax.device_put(a, elem_sharding), tree_cast(t)
            )

        def place_rep(t):
            return jax.tree_util.tree_map(
                lambda a: jax.device_put(a, rep_sharding), tree_cast(t)
            )

        self.shd = place_shd(
            {"params": shd_params, "solver": shd_solver, "u": shd_u,
             "fstate": shd_state}
        )
        rep_params = {
            e.name: sysm.params[e.name] for e in sysm._explicit_list
        }
        self.rep = place_rep(
            {
                "x": sysm.state["x"],
                "v": sysm.state["v"],
                "t": sysm.state["t"],
                "masses": sysm._masses_dev,
                "explicit": rep_params,
            }
        )
        self._step_fn = jax.jit(highest(self._make_step()),
                                donate_argnums=(0, 1))
        self._rollouts = {}
        #: per-step residual aux of the last step()/run() (empty dict
        #: unless collect_residuals)
        self.last_aux = {}

    # ------------------------------------------------------------- step fn

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
        n = sysm.n_nodes
        nb, n_pad = self._nb, self._n_pad
        S, axis = self.S, self.axis

        def shard_step(rep, shd):
            # local views (shard_map leading block dim of 1)
            loc = jax.tree_util.tree_map(lambda a: a[0], shd)
            x0, v = rep["x"], rep["v"]
            masses = rep["masses"]
            for e in explicit:
                v = e.apply(dt, x0, v, masses, rep["explicit"][e.name])

            xbar = x0 + dt * v
            Mxbar = masses[:, None] * xbar
            b_dtype = Mxbar.dtype

            inc = loc["solver"]["inc"]
            ell_idx = loc["solver"]["ell_idx"]
            ell_vals = loc["solver"]["ell_vals"]
            diag_loc = loc["solver"]["diag"]
            sid = jax.lax.axis_index(axis)
            row0 = sid * nb

            def cg_solve(b_full, x_full):
                """Row-sharded Jacobi-PCG, fixed iterations. b_full/x_full
                replicated (n,3); returns replicated (n,3)."""
                bp = jnp.pad(b_full, ((0, n_pad - n), (0, 0)))
                xp = jnp.pad(x_full, ((0, n_pad - n), (0, 0)))
                b_loc = jax.lax.dynamic_slice_in_dim(bp, row0, nb)
                x_loc = jax.lax.dynamic_slice_in_dim(xp, row0, nb)
                inv_diag = 1.0 / diag_loc

                def matvec_rows(p_full):
                    return jnp.einsum(
                        "nk,nkj->nj", ell_vals, p_full[ell_idx]
                    )

                r_loc = b_loc - matvec_rows(xp)
                z_loc = inv_diag[:, None] * r_loc
                p_loc = z_loc
                p_full = jax.lax.all_gather(
                    p_loc, axis, axis=0, tiled=True
                )
                rz = jax.lax.psum(jnp.vdot(r_loc, z_loc), axis)

                def body(_, carry):
                    x_loc, r_loc, p_loc, p_full, rz = carry
                    Ap_loc = matvec_rows(p_full)
                    pAp = jax.lax.psum(jnp.vdot(p_loc, Ap_loc), axis)
                    alpha = rz / jnp.where(pAp > 0, pAp, 1.0)
                    x_loc = x_loc + alpha * p_loc
                    r_loc = r_loc - alpha * Ap_loc
                    z_loc = inv_diag[:, None] * r_loc
                    rz_new = jax.lax.psum(jnp.vdot(r_loc, z_loc), axis)
                    beta = rz_new / jnp.where(rz > 0, rz, 1.0)
                    p_loc = z_loc + beta * p_loc
                    p_full = jax.lax.all_gather(
                        p_loc, axis, axis=0, tiled=True
                    )
                    return (x_loc, r_loc, p_loc, p_full, rz_new)

                x_loc, *_ = jax.lax.fori_loop(
                    0, cg_fixed, body,
                    (x_loc, r_loc, p_loc, p_full, rz),
                )
                x_new = jax.lax.all_gather(x_loc, axis, axis=0, tiled=True)
                return x_new[:n]

            width = 6 if collect_dual else 3

            def iteration(i, carry):
                curr_x, u, fstate, rc, rp, rd = carry
                z = {}
                new_u = {}
                new_fstate = {}
                contribs = []
                for f in forces:
                    lp = loc["params"][f.name]
                    if getattr(f, "supports_fused_local_rhs", False):
                        # with_z: 6-wide rows carry D^T W^2 z alongside
                        # the RHS for the dual residual (same source as
                        # the general path, so trajectories stay in
                        # bit-level lockstep)
                        zf, uf, sf, cf = f.fused_local_rhs(
                            lp, curr_x, u[f.name], fstate[f.name],
                            with_z=collect_dual,
                        )
                    else:
                        Dx = f.compute_Dx(lp, curr_x)
                        zf, uf, sf = f.project_with_dual(
                            Dx, u[f.name], lp, fstate[f.name]
                        )
                        cf = (f.rhs_contribution6(lp, zf, uf)
                              if collect_dual
                              else f.rhs_contribution(lp, zf, uf))
                    z[f.name] = zf
                    new_u[f.name] = uf
                    new_fstate[f.name] = sf
                    contribs.append(cf)

                contribs.append(jnp.zeros((1, width), b_dtype))  # sentinel
                flat = jnp.concatenate(contribs, axis=0)
                partial = jnp.sum(flat[inc], axis=1)  # (n,width) shard part
                out = jax.lax.psum(partial, axis)
                b = Mxbar + dt2 * out[:, :3]
                new_x = cg_solve(b, curr_x)

                new_rc = rc
                if collect:
                    # local primal pieces + one psum: shard-padded
                    # elements carry weight 0 and contribute nothing
                    r2 = 0.0
                    for f in forces:
                        r2 = r2 + f.primal_piece(
                            loc["params"][f.name], new_u[f.name], u[f.name]
                        )
                    rp = rp.at[i].set(jnp.sqrt(jax.lax.psum(r2, axis)))
                if collect_dual:
                    Tz = out[:, 3:]
                    rd = rd.at[i].set(dt2 * jnp.linalg.norm(Tz - rc))
                    new_rc = Tz
                return (new_x, new_u, new_fstate, new_rc, rp, rd)

            res_shape = (iters,) if collect else (0,)
            rp0 = jnp.zeros(res_shape, b_dtype)
            rd0 = jnp.zeros(res_shape, b_dtype)
            if collect_dual:
                # z_prev init = D x0 (System.cpp:43): T z0 via the same
                # 6-wide contribution rows with u = 0
                c0 = []
                for f in forces:
                    lp = loc["params"][f.name]
                    z0f = f.compute_Dx(lp, x0)
                    c0.append(f.rhs_contribution6(
                        lp, z0f, jnp.zeros_like(z0f)
                    ))
                c0.append(jnp.zeros((1, 6), b_dtype))
                rc0 = jax.lax.psum(
                    jnp.sum(jnp.concatenate(c0, 0)[inc], axis=1), axis
                )[:, 3:]
            else:
                rc0 = jnp.zeros((1, 3), b_dtype)

            curr_x, u, fstate, _, rp, rd = jax.lax.fori_loop(
                0, iters, iteration,
                (xbar, loc["u"], loc["fstate"], rc0, rp0, rd0),
            )
            aux = {}
            if collect:
                aux["primal_residual"] = rp
            if collect_dual:
                aux["dual_residual"] = rd

            new_rep = {
                "x": curr_x,
                "v": (curr_x - x0) / dt,
                "t": rep["t"] + dt,
                "masses": masses,
                "explicit": rep["explicit"],
            }
            # re-wrap local blocks with the leading shard axis of size 1
            expand = lambda t: jax.tree_util.tree_map(
                lambda a: a[None], t
            )
            new_shd = {
                "params": shd["params"],
                "solver": shd["solver"],
                "u": expand(u),
                "fstate": expand(fstate),
            }
            return new_rep, new_shd, aux

        aux_spec = {}
        if collect:
            aux_spec["primal_residual"] = P()
        if collect_dual:
            aux_spec["dual_residual"] = P()
        smapped = jax.shard_map(
            shard_step,
            mesh=self.mesh,
            in_specs=(P(), P(self.axis)),
            out_specs=(P(), P(self.axis), aux_spec),
            check_vma=False,
        )
        return smapped

    # ------------------------------------------------------------- driving

    def step(self):
        self.rep, self.shd, self.last_aux = self._step_fn(
            self.rep, self.shd
        )
        return True

    def make_rollout(self, n_steps: int):
        step = self._make_step()

        def rollout(rep, shd):
            def body(c, _):
                rep, shd, aux = step(*c)
                return (rep, shd), aux

            (rep, shd), aux = jax.lax.scan(
                body, (rep, shd), None, length=n_steps
            )
            return rep, shd, aux

        return jax.jit(highest(rollout), donate_argnums=(0, 1))

    def run(self, n_steps: int):
        if n_steps not in self._rollouts:
            self._rollouts[n_steps] = self.make_rollout(n_steps)
        self.rep, self.shd, self.last_aux = self._rollouts[n_steps](
            self.rep, self.shd
        )
        return True

    @property
    def x(self) -> np.ndarray:
        return np.asarray(self.rep["x"])

    @property
    def v(self) -> np.ndarray:
        return np.asarray(self.rep["v"])

    def measured_comm(self) -> dict:
        """Collective inventory of the COMPILED step (post-GSPMD HLO).
        For THIS class the report honestly documents the O(n) traffic of
        the replicated-vertex design: the (n_pad/S,3)-per-device
        all_gather of the CG search direction is its biggest op. The
        boundary-halo formulation that avoids it is
        parallel.halo_spmd.HaloSpmdSystem."""
        from .comm import compiled_hlo_text, hlo_collective_report

        rep = hlo_collective_report(
            compiled_hlo_text(self._step_fn, self.rep, self.shd)
        )
        rep["admm_iters"] = self.system.settings.admm_iters
        rep["cg_iters"] = self.system.settings.cg_fixed_iters or 25
        return rep

    def comm_stats(self) -> dict:
        """Analytic cross-device traffic per timestep (SURVEY §2.7: CG dots
        + vertex halo are the only cross-device data)."""
        itemsize = jnp.dtype(self.system.settings.dtype).itemsize
        iters = self.system.settings.admm_iters
        cg = self.system.settings.cg_fixed_iters or 25
        n, n_pad = self.system.n_nodes, self._n_pad
        psum_b = n * 3 * itemsize  # RHS combine per ADMM iteration
        gathers = (cg + 2) * n_pad * 3 * itemsize  # p re-replication + x
        scalars = (2 * cg + 1) * itemsize
        per_iter = psum_b + gathers + scalars
        return {
            "n_devices": self.S,
            "admm_iters": iters,
            "cg_iters": cg,
            "bytes_per_step": iters * per_iter,
            "bytes_per_admm_iter": per_iter,
        }
