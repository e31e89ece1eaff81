"""The ADMM elastodynamics system: host-side builder + jitted timestep.

Mirrors the reference's `admm::System` API surface (System.hpp:29-99):
`add_nodes`, `forces`, `explicit_forces`, `initialize`, `step`,
`recompute_weights`, `pre_step_callbacks` — but the timestep is a single
jitted function over struct-of-array constraint batches:

    step (System.cpp:26-75):
      pre-step callbacks (host)                      System.cpp:29
      explicit forces kick velocities                System.cpp:37-39
      x_bar = x + dt v;   M x_bar                    System.cpp:46-47
      admm_iters times (lax.fori_loop):              System.cpp:51-67
        Dx   = gather/einsum per constraint batch    (was sparse matvec)
        z,u  = batched local projections + dual upd  (was omp parallel for)
        b    = M x_bar + dt^2 D^T W^2 (z - u)        (segment-sum)
        x    = global solve                          (was LDLT backsolve)
      v = (x' - x)/dt                                System.cpp:70-71

All runtime-variable data (weights, material params, control points, wind
direction, the dense inverse) are traced arguments, so weight changes and
scenario sweeps never recompile. The dual u is warm-started across steps
(System.cpp:42).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import ForceBatch
from ..utils.precision import highest
from .solver import (
    A_hat_apply,
    A_hat_diag,
    assemble_A_hat,
    assemble_A_hat_dia,
    assemble_A_hat_ell,
    assemble_transpose_incidence,
    dia_apply,
    ell_apply,
    pcg_solve,
    pcg_solve_fixed,
    transpose_gather_apply,
)


@dataclasses.dataclass
class Settings:
    """Solver settings (reference System::Settings, System.hpp:35-42)."""

    timestep_s: float = 0.04
    admm_iters: int = 10
    verbose: int = 1
    #: float32 by default; use float64 (with jax_enable_x64) for
    #: trajectory parity against the all-double reference
    dtype: Any = jnp.float32
    #: 'auto' picks 'dense' for small meshes, 'dia' (else 'ell') for large
    global_solver: str = "auto"
    dense_max_nodes: int = 4096
    cg_tol: float = 1e-10
    cg_max_iters: int = 250
    #: when set, CG runs exactly this many iterations with no residual test
    #: (static control flow; pairs with warm starts). A tuple
    #: (first, rest) gives ADMM iteration 0 — whose warm start is stale by
    #: the whole explicit kick x̄ = x + dt·v — a deeper solve than the
    #: remaining iterations, whose warm starts drift only by the local
    #: step's z−u updates; matched-residual evidence on unstructured
    #: meshes needs the uneven schedule (tools/residual_match.py)
    cg_fixed_iters: int | tuple | None = None
    #: dense mode: iterative-refinement steps per global solve
    #: (x += A^{-1}(b - A x) via the sparse ELL matvec) — recovers accuracy
    #: lost to the f32 stored inverse at ~5 ms/step cost
    dense_refine_steps: int = 0
    #: global-step PCG preconditioner: 'jacobi' (diagonal) or 'amg'
    #: (aggregation-AMG V-cycle, core/amg.py; any sparse global mode).
    #: A_hat is stiffness-dominated, so Jacobi-PCG needs O(mesh diameter)
    #: iterations for a matched-residual solve on large unstructured
    #: meshes; the V-cycle removes the diameter dependence — use it when
    #: residual-exact trajectories matter more than per-iteration cost
    preconditioner: str = "jacobi"
    #: compute per-iteration residuals (Eq. 22-23 noted at
    #: System.cpp:64-65 but never computed by the reference): True =
    #: primal + dual, "primal" = primal only
    collect_residuals: bool | str = False
    #: when set, stop ADMM iterations early once the primal residual
    #: ||W(Dx-z)|| drops below this absolute tolerance (max admm_iters still
    #: bounds the loop). The reference never implemented its noted early exit.
    residual_tol: float | None = None
    #: opt-in: step the whole timestep through a whole-mesh layout — the
    #: banded tet layout (parallel/banded_spmd.ShardedBandedStepper) or
    #: the grid-cloth layout (parallel/cloth_spmd.ShardedClothStepper) on
    #: a one-device mesh — when the force set qualifies (one nh/stvk/arap
    #: tet force with StaticAnchors, analytic Collisions and gravity; or
    #: grid cloth with strain, bend, anchors, gravity and wind). Falls
    #: back to the general path when the scene, the preconditioner
    #: ('amg') or the residual collection (dual residuals on tets) is
    #: not covered.
    lattice_fast_path: bool = False
    #: 'auto': when the dia solver rejects the vertex NUMBERING but the
    #: vertex POSITIONS form a regular grid, renumber internally (canonical
    #: grid order) so the dia matvec re-qualifies; the public x/v API
    #: stays in the caller's numbering. 'none' disables.
    reorder: str = "auto"
    #: ADMM over-relaxation factor α (Boyd et al. 2011 §3.4.3): the local
    #: prox input and dual update see α·Dx + (1−α)·z_prev instead of Dx.
    #: 1.0 reproduces the reference exactly (System.cpp:54-58 has no
    #: relaxation). Values in [1.5, 1.9] typically cut iterations-to-
    #: residual (measure per scene: tools/accel_study.py). General path
    #: only — α≠1 disables the fused local+RHS kernel and the
    #: whole-mesh layouts for the step.
    relaxation: float = 1.0
    #: fixed-point acceleration of the ADMM iteration map on (x, u):
    #: None (reference behavior) or "anderson" — safeguarded Anderson(m)
    #: extrapolation (Peng et al. 2018, "Anderson Acceleration for Geometry
    #: Optimization and Physics Simulation"; type-II AA with residual-growth
    #: restart, final iteration always a plain ADMM update). Composes with
    #: `relaxation`. Incompatible with `residual_tol`.
    acceleration: str | None = None
    #: Anderson history depth m (number of stored residual differences)
    anderson_m: int = 5

    def parse_args(self, argv):
        """CLI parity with the reference: -dt, -v, -it, -help
        (System.cpp:182-208)."""
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "-help":
                print(
                    "Args:\n\t-dt: time step (s)\n\t-v: verbosity"
                    "\n\t-it: # admm iters"
                )
            elif a == "-dt" and i + 1 < len(argv):
                self.timestep_s = float(argv[i + 1])
                i += 1
            elif a == "-v" and i + 1 < len(argv):
                self.verbose = int(argv[i + 1])
                i += 1
            elif a == "-it" and i + 1 < len(argv):
                self.admm_iters = int(argv[i + 1])
                i += 1
            i += 1
        return self


def _cast_tree(tree, dtype):
    def cast(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(a, dtype)
        return jnp.asarray(a)

    return jax.tree_util.tree_map(cast, tree)


def _anderson_loop(iteration, carry, iters, m):
    """Safeguarded type-II Anderson(m) acceleration of the ADMM iteration
    map on the (x, u) block of the carry (Peng et al. 2018, "Anderson
    Acceleration for Geometry Optimization and Physics Simulation").

    One plain ADMM update G is evaluated per iteration (same cost as the
    unaccelerated loop); the accepted iterate is the AA extrapolation
    q_{k+1} = G(q_k) - ΔG γ with γ = argmin ||f_k - ΔF γ|| over the last
    `m` residual differences, solved via regularized normal equations
    (static shapes). Safeguard: when the fixed-point
    residual ||G(q)-q|| grows, the history is restarted and the plain
    update is taken instead (residual-growth restart). The final
    iteration always takes the plain update so the returned state is a
    true ADMM iterate (x and u consistent with the last local step).
    m=0 reproduces plain ADMM exactly.

    The non-accelerated carry entries (warm-start force state, residual
    traces, z_prev) ride along with the plain evaluation.
    """
    x0, u0 = carry[0], carry[1]
    u_leaves, u_tree = jax.tree_util.tree_flatten(u0)
    sizes = [int(np.prod(x0.shape))] + [int(np.prod(l.shape))
                                        for l in u_leaves]
    shapes = [x0.shape] + [l.shape for l in u_leaves]
    total = sum(sizes)
    dtype = x0.dtype
    m = max(int(m), 0)

    def pack(x, u):
        ls = jax.tree_util.tree_leaves(u)
        return jnp.concatenate(
            [jnp.ravel(x)] + [jnp.ravel(l) for l in ls]
        ).astype(dtype)

    def unpack(q):
        parts, off = [], 0
        for sz, shp in zip(sizes, shapes):
            parts.append(q[off:off + sz].reshape(shp))
            off += sz
        return parts[0], jax.tree_util.tree_unflatten(u_tree, parts[1:])

    dF = jnp.zeros((max(m, 1), total), dtype)  # residual differences
    dG = jnp.zeros((max(m, 1), total), dtype)  # map-value differences
    f_prev = jnp.zeros((total,), dtype)
    g_prev = jnp.zeros((total,), dtype)
    r_prev = jnp.asarray(jnp.inf, dtype)
    count0 = jnp.asarray(0, jnp.int32)  # valid history columns

    def body(k, aa_carry):
        c, dF, dG, f_prev, g_prev, r_prev, count = aa_carry
        c_new = iteration(k, c)
        q_old = pack(c[0], c[1])
        g = pack(c_new[0], c_new[1])
        f = g - q_old
        r = jnp.linalg.norm(f)

        grew = r > r_prev
        # restart clears history; otherwise append the new (Δf, Δg) pair
        # (only meaningful once a previous f/g exists, i.e. count>=0 after
        # at least one plain step — slot k%m is overwritten ring-buffer
        # style so shapes stay static)
        have_prev = count > 0
        slot = jnp.mod(count - 1, max(m, 1))
        dF_new = dF.at[slot].set(jnp.where(have_prev, f - f_prev, 0.0))
        dG_new = dG.at[slot].set(jnp.where(have_prev, g - g_prev, 0.0))
        dF = jnp.where(grew, jnp.zeros_like(dF), dF_new)
        dG = jnp.where(grew, jnp.zeros_like(dG), dG_new)
        # pairs appended since restart: iterations 1..count each add one
        n_hist = jnp.where(grew | ~have_prev, 0, jnp.minimum(count, m))

        if m > 0:
            valid = jnp.arange(m) < n_hist
            Fv = jnp.where(valid[:, None], dF, 0.0)
            Gv = jnp.where(valid[:, None], dG, 0.0)
            # γ from regularized normal equations over valid columns
            A = Fv @ Fv.T
            lam = 1e-10 * (jnp.trace(A) + 1.0)
            A = A + lam * jnp.eye(m, dtype=dtype)
            A = jnp.where(
                valid[:, None] & valid[None, :], A,
                jnp.eye(m, dtype=dtype),
            )
            rhs = jnp.where(valid, Fv @ f, 0.0)
            gamma = jnp.linalg.solve(A, rhs)
            q_acc = g - gamma @ Gv
        else:
            q_acc = g

        last = k == iters - 1
        take_plain = grew | last | (n_hist == 0)
        q_next = jnp.where(take_plain, g, q_acc)
        x_next, u_next = unpack(q_next)
        c_out = (x_next, u_next) + tuple(c_new[2:])
        count = jnp.where(grew, 1, count + 1)
        return (c_out, dF, dG, f, g, r, count)

    final = jax.lax.fori_loop(
        0, iters, body, (carry, dF, dG, f_prev, g_prev, r_prev, count0)
    )
    c = final[0]
    return c[0], c[1], c[2], c[4], c[5]


class System:
    def __init__(self, settings: Settings | None = None):
        self.settings = settings or Settings()
        self.forces: list[ForceBatch] = []
        self.explicit_forces: list = []
        self.pre_step_callbacks: list[Callable[["System"], None]] = []
        self._x = np.zeros((0, 3), dtype=np.float64)
        self._m = np.zeros((0,), dtype=np.float64)
        self.initialized = False
        self.elapsed_s = 0.0

    # ------------------------------------------------------------- building

    @property
    def n_nodes(self) -> int:
        return len(self._x)

    def add_nodes(self, x, masses) -> int:
        """Append nodes; accepts (n,3) or flat (3n,) like the reference
        (System.cpp:78-95). Masses: (n,) or flat (3n,) with per-node
        replication. Returns total node count."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x.reshape(-1, 3)
        m = np.asarray(masses, dtype=np.float64)
        if m.ndim == 1 and m.shape[0] == 3 * x.shape[0]:
            m = m.reshape(-1, 3)[:, 0]
        if m.shape[0] != x.shape[0]:
            raise ValueError("masses/positions node count mismatch")
        self._x = np.concatenate([self._x, x], axis=0)
        self._m = np.concatenate([self._m, m], axis=0)
        return self.n_nodes

    def add_force(self, f: ForceBatch) -> ForceBatch:
        self.forces.append(f)
        return f

    def add_explicit_force(self, f) -> Any:
        self.explicit_forces.append(f)
        return f

    # --------------------------------------------------------- initialize

    def initialize(self) -> bool:
        s = self.settings
        if s.timestep_s <= 0.0:
            print(f"**Solver Error: timestep {s.timestep_s}s, changing to 0.04s")
            s.timestep_s = 0.04
        if self.n_nodes < 1:
            print("**Solver Error: Problem with node data!")
            return False
        dt = s.timestep_s
        dtype = s.dtype

        self._force_list = []
        params: dict[str, Any] = {}
        state_forces: dict[str, Any] = {}
        u0: dict[str, Any] = {}
        for i, f in enumerate(self.forces):
            f.name = f"c{i}_{type(f).__name__}"
            p, st = f.build(self._x, self._m, dt)
            params[f.name] = p
            state_forces[f.name] = st
            u0[f.name] = f.dual_init()
            self._force_list.append(f)

        self._explicit_list = []
        for i, e in enumerate(self.explicit_forces):
            e.name = f"e{i}_{type(e).__name__}"
            params[e.name] = e.build()
            self._explicit_list.append(e)

        n = self.n_nodes
        #: internal vertex order (may be a grid renumbering; see reorder)
        self._xi, self._mi = self._x, self._m
        self._o2i = None
        self._i2o = None
        mode = s.global_solver
        if mode == "auto":
            # dense-inverse matmul for small meshes; for large meshes the
            # sparse-DIAgonal CG when the numbering permits, else padded-ELL
            # gather CG. Pick 'cg' explicitly for element-sharded
            # multi-device runs or frequent weight edits.
            mode = "dense" if n <= s.dense_max_nodes else "dia"
        self._solver_mode = mode
        self._constraint_names = [f.name for f in self._force_list]

        if mode == "dense":
            cparams = {k: params[k] for k in self._constraint_names}
            A = assemble_A_hat(n, self._mi, dt, cparams)
            params["_solver"] = {"A_inv": np.linalg.inv(A)}
            if s.dense_refine_steps > 0:
                ell_idx, ell_vals, _ = assemble_A_hat_ell(n, self._mi, dt, cparams)
                params["_solver"]["ell_idx"] = ell_idx
                params["_solver"]["ell_vals"] = ell_vals
        elif mode in ("ell", "dia"):
            cparams = {k: params[k] for k in self._constraint_names}
            if mode == "dia":
                dia = assemble_A_hat_dia(n, self._mi, dt, cparams)
                if dia is None and s.reorder == "auto":
                    from .lattice import detect_grid_numbering

                    cid = detect_grid_numbering(self._x)
                    if cid is not None:
                        # renumber internally: index arrays through o2i,
                        # vertex arrays gathered by i2o
                        self._o2i = cid
                        i2o = np.empty_like(cid)
                        i2o[cid] = np.arange(n)
                        self._i2o = i2o
                        for nm, p in params.items():
                            for key in ("indices", "tris"):
                                if isinstance(p, dict) and key in p:
                                    p[key] = cid[
                                        np.asarray(p[key], np.int64)
                                    ].astype(np.int32)
                        self._xi = self._x[i2o]
                        self._mi = self._m[i2o]
                        cparams = {
                            k: params[k] for k in self._constraint_names
                        }
                        dia = assemble_A_hat_dia(n, self._mi, dt, cparams)
                        if s.verbose and dia is not None:
                            print(
                                "Solver: grid renumbering engaged — dia "
                                "restored for scrambled input"
                            )
                if dia is None and s.verbose:
                    print("Solver: unstructured numbering, dia -> ell")
                if dia is None:
                    mode = self._solver_mode = "ell"
                else:
                    self._dia_offsets, dia_vals, diag = dia
                    inc_idx, _ = assemble_transpose_incidence(
                        n, cparams, self._constraint_names
                    )
                    params["_solver"] = {
                        "dia_vals": dia_vals,
                        "diag": diag,
                        "inc_idx": inc_idx,
                    }
            if mode == "ell":
                ell_idx, ell_vals, diag = assemble_A_hat_ell(n, self._mi, dt, cparams)
                inc_idx, _ = assemble_transpose_incidence(
                    n, cparams, self._constraint_names
                )
                params["_solver"] = {
                    "ell_idx": ell_idx,
                    "ell_vals": ell_vals,
                    "diag": diag,
                    "inc_idx": inc_idx,
                }
        elif mode != "cg":
            raise ValueError(f"unknown global_solver {mode!r}")

        self._amg_meta = None
        if s.preconditioner == "amg":
            if mode == "dense":
                raise ValueError(
                    "preconditioner='amg' needs a sparse global_solver "
                    "('cg', 'ell' or 'dia')"
                )
            cparams = {k: params[k] for k in self._constraint_names}
            params["_solver"] = dict(params.get("_solver", {}))
            params["_solver"]["amg"] = self._build_general_amg(cparams)

        self.params = _cast_tree(params, dtype)
        self.state = {
            "x": jnp.asarray(self._xi, dtype),
            "v": jnp.zeros((n, 3), dtype),
            "t": jnp.asarray(0.0, dtype),
            "u": _cast_tree(u0, dtype),
            "forces": _cast_tree(state_forces, dtype),
        }
        self._masses_dev = jnp.asarray(self._mi, dtype)

        self._lattice = None
        # the whole-mesh layouts run the plain α=1 reference iteration with
        # a Jacobi budget: over-relaxation, Anderson and the AMG
        # preconditioner stay on the general path, which honours them
        general_only = (s.relaxation != 1.0 or s.acceleration is not None
                        or s.preconditioner == "amg")
        if s.lattice_fast_path and general_only and s.verbose >= 1:
            print("Solver: relaxation/acceleration/amg active — whole-mesh "
                  "layouts disabled (general path honours them)")
        if s.lattice_fast_path and not general_only:
            self._route_fast_path()

        self._step_fn = jax.jit(highest(self._make_step()),
                                donate_argnums=(0,))

        if s.verbose >= 1:
            print(
                f"Solver::initialize: {n} nodes, {len(self.forces)} constraint "
                f"batches ({sum(f.n_elements for f in self.forces)} elements), "
                f"global solver = {mode}"
            )
        self.initialized = True
        return True

    # ----------------------------------------------------------- step fn

    def _build_general_amg(self, cparams, label="hierarchy"):
        """Assemble A_hat and build the general-path aggregation-AMG
        hierarchy (core/amg.py); records _amg_meta so recompute_weights
        can refresh values over the frozen aggregation."""
        from .amg import build_amg
        from .solver import _assemble_A_hat_csr

        A = _assemble_A_hat_csr(self.n_nodes, self._mi,
                                self.settings.timestep_s, cparams)
        amg_arrays, self._amg_meta = build_amg(A)
        if self.settings.verbose:
            sizes = " -> ".join(str(m["n"]) for m in self._amg_meta)
            print(f"Solver: AMG {label} {sizes}")
        return amg_arrays

    def _make_step(self):
        forces = list(self._force_list)
        explicit = list(self._explicit_list)
        masses = self._masses_dev
        dt = self.settings.timestep_s
        dt2 = dt * dt
        iters = self.settings.admm_iters
        mode = self._solver_mode
        cg_tol = self.settings.cg_tol
        cg_iters = self.settings.cg_max_iters
        early_tol = self.settings.residual_tol
        cg_fixed = self.settings.cg_fixed_iters
        cg_sched = None
        if isinstance(cg_fixed, (tuple, list)):
            cg_sched = (int(cg_fixed[0]), int(cg_fixed[1]))
            cg_fixed = cg_sched[0]
        amg_vcycle = None
        if getattr(self, "_amg_meta", None) is not None:
            from .amg import make_vcycle

            amg_vcycle = make_vcycle(self._amg_meta)

        def sched_solve(i, solve_k):
            """solve_k(static_iter_count) -> x; per-ADMM-iteration budget.
            Both cond branches are cheap retraces of the same fori_loop
            solve — only ONE executes per iteration."""
            if cg_sched is None:
                return solve_k(cg_fixed)
            return jax.lax.cond(
                i == 0,
                lambda: solve_k(cg_sched[0]),
                lambda: solve_k(cg_sched[1]),
            )
        relax = float(self.settings.relaxation)
        accel = self.settings.acceleration
        aa_m = int(self.settings.anderson_m)
        if accel not in (None, "anderson"):
            raise ValueError(f"unknown acceleration {accel!r}")
        if accel is not None and early_tol is not None:
            raise ValueError(
                "acceleration and residual_tol cannot be combined"
            )
        dense_refine = self.settings.dense_refine_steps
        dia_offsets = getattr(self, "_dia_offsets", None)
        #: dual residual (needs the z-contribution columns) only when
        #: explicitly requested; the primal residual (cheap, via the
        #: dual-update identity Dx - z = u' - u) also drives residual_tol.
        #: collect_residuals="primal" skips the dual
        collect_dual = self.settings.collect_residuals is True
        collect = (bool(self.settings.collect_residuals)
                   or early_tol is not None)
        n = self.n_nodes
        cnames = [f.name for f in forces]

        def Dx_all(params, x):
            return {f.name: f.compute_Dx(params[f.name], x) for f in forces}

        def step(state, params):
            x0, v = state["x"], state["v"]
            for e in explicit:
                v = e.apply(dt, x0, v, masses, params[e.name])

            xbar = x0 + dt * v
            Mxbar = masses[:, None] * xbar
            b_dtype = Mxbar.dtype
            u = state["u"]
            fstate = state["forces"]
            cparams = {k: params[k] for k in cnames}

            if mode == "cg":
                diag = A_hat_diag(masses, dt2, cparams)
            elif mode in ("ell", "dia"):
                diag = params["_solver"]["diag"]

            # residual carry: ell/dia track T z = sum_f D^T W^2 z as an (n,3)
            # vertex vector (s_i = dt^2 ||T z_i - T z_{i-1}||, recovered from
            # the SAME incidence gather as the RHS via 6-wide contribution
            # rows — residual collection no longer disables kernel fusion);
            # dense/cg carry the per-force z dicts and use the scatter path.
            if collect_dual and mode in ("ell", "dia"):
                z0 = Dx_all(params, x0)  # z init (System.cpp:43)
                rc0 = jnp.zeros((n, 3), b_dtype)
                for f in forces:
                    rc0 = rc0 + f.scatter_rhs(
                        params[f.name], z0[f.name],
                        jnp.zeros_like(z0[f.name]), n,
                    )
            elif collect_dual:
                rc0 = Dx_all(params, x0)
            else:
                rc0 = jnp.zeros((1, 3), b_dtype)  # unused dummy carry

            res_shape = (iters,) if collect else (0,)
            res_primal = jnp.zeros(res_shape, x0.dtype)
            res_dual = jnp.zeros(res_shape, x0.dtype)

            # forces whose whole per-iteration element pipeline (Dx, prox,
            # dual, RHS contribution) runs inside one fused kernel
            fused_names = {
                f.name
                for f in forces
                if mode in ("ell", "dia")
                and getattr(f, "supports_fused_local_rhs", False)
                # the fused kernels consume x directly; relaxation needs the
                # blended α·Dx + (1−α)·z_prev prox input, so it routes
                # through the unfused per-force pipeline
                and relax == 1.0
            }

            # z_prev carry for over-relaxation, initialized to D·x0 like the
            # reference's z init (System.cpp:43)
            zprev0 = Dx_all(params, x0) if relax != 1.0 else {}

            def iteration(i, carry):
                curr_x, u, fstate, rc, rp, rd, zprev = carry
                Dx = {
                    f.name: f.compute_Dx(params[f.name], curr_x)
                    for f in forces
                    if f.name not in fused_names
                }
                z = {}
                new_u = {}
                new_fstate = {}
                fused_contrib = {}
                for f in forces:
                    if f.name in fused_names:
                        zf, uf, sf, cf = f.fused_local_rhs(
                            params[f.name], curr_x, u[f.name], fstate[f.name],
                            with_z=collect_dual,
                        )
                        fused_contrib[f.name] = cf
                    else:
                        h = Dx[f.name]
                        if relax != 1.0:
                            # over-relaxation: blend toward the previous z
                            # (prox input AND dual update both see h)
                            h = relax * h + (1.0 - relax) * zprev[f.name]
                        zf, uf, sf = f.project_with_dual(
                            h, u[f.name], params[f.name],
                            fstate[f.name]
                        )
                    z[f.name] = zf
                    new_u[f.name] = uf
                    new_fstate[f.name] = sf
                new_zprev = z if relax != 1.0 else zprev

                Tz = None
                if mode in ("ell", "dia"):
                    # scatter-free RHS: per-element contributions gathered
                    # through the precomputed vertex incidence (a gather +
                    # sum: deterministic, no scatter-add)
                    width = 6 if collect_dual else 3
                    contribs = []
                    for f in forces:
                        if f.name in fused_names:
                            contribs.append(fused_contrib[f.name])
                        elif collect_dual:
                            contribs.append(f.rhs_contribution6(
                                params[f.name], z[f.name], new_u[f.name]
                            ))
                        else:
                            contribs.append(f.rhs_contribution(
                                params[f.name], z[f.name], new_u[f.name]
                            ))
                    contribs.append(jnp.zeros((1, width), b_dtype))  # sentinel
                    flat = jnp.concatenate(contribs, axis=0)
                    out = transpose_gather_apply(
                        flat, params["_solver"]["inc_idx"]
                    )
                    b = Mxbar + dt2 * out[:, :3]
                    if collect_dual:
                        Tz = out[:, 3:]
                else:
                    b = Mxbar
                    for f in forces:
                        b = b + dt2 * f.scatter_rhs(
                            params[f.name], z[f.name], new_u[f.name], n
                        )

                if mode == "dense":
                    sv = params["_solver"]
                    new_x = sv["A_inv"] @ b
                    for _ in range(dense_refine):
                        r = b - ell_apply(new_x, sv["ell_idx"], sv["ell_vals"])
                        new_x = new_x + sv["A_inv"] @ r
                else:
                    sv = params.get("_solver")
                    if mode == "ell":
                        A_op = lambda y: ell_apply(y, sv["ell_idx"], sv["ell_vals"])
                    elif mode == "dia":
                        A_op = lambda y: dia_apply(y, dia_offsets, sv["dia_vals"])
                    else:
                        A_op = lambda y: A_hat_apply(y, masses, dt2, cparams)
                    if amg_vcycle is not None:
                        from .amg import (
                            pcg_solve_fixed_precond,
                            pcg_solve_precond,
                        )

                        levels = params["_solver"]["amg"]
                        M_op = lambda r: amg_vcycle(levels, r)
                        if cg_fixed is not None:
                            new_x = sched_solve(
                                i,
                                lambda k: pcg_solve_fixed_precond(
                                    A_op, M_op, b, curr_x, k
                                ),
                            )
                        else:
                            new_x, _ = pcg_solve_precond(
                                A_op, M_op, b, curr_x, cg_tol, cg_iters
                            )
                    elif cg_fixed is not None:
                        new_x = sched_solve(i, lambda k: pcg_solve_fixed(
                            A_op, b, curr_x, diag, k)[0])
                    elif mode == "dia":
                        new_x = pcg_solve_fixed(A_op, b, curr_x, diag, 25)[0]
                    else:
                        new_x, _ = pcg_solve(
                            A_op, b, curr_x, diag, cg_tol, cg_iters
                        )

                new_rc = rc
                if collect:
                    # r = ||W(Dx - z)|| = ||W(u' - u)|| (System.cpp:64;
                    # the dual-update identity keeps this fusion-friendly)
                    r2 = 0.0
                    for f in forces:
                        r2 = r2 + f.primal_piece(
                            params[f.name], new_u[f.name], u[f.name]
                        )
                    rp = rp.at[i].set(jnp.sqrt(r2))
                if collect_dual:
                    # s = ||dt^2 D^T W^2 (z - z_prev)|| (System.cpp:65)
                    if mode in ("ell", "dia"):
                        rd = rd.at[i].set(dt2 * jnp.linalg.norm(Tz - rc))
                        new_rc = Tz
                    else:
                        sresid = jnp.zeros((n, 3), b.dtype)
                        for f in forces:
                            sresid = sresid + dt2 * f.scatter_rhs(
                                params[f.name], z[f.name], rc[f.name], n
                            )
                        rd = rd.at[i].set(jnp.linalg.norm(sresid))
                        new_rc = z

                return (new_x, new_u, new_fstate, new_rc, rp, rd, new_zprev)

            carry = (xbar, u, fstate, rc0, res_primal, res_dual, zprev0)
            if accel == "anderson":
                curr_x, u, fstate, rp, rd = _anderson_loop(
                    iteration, carry, iters, aa_m
                )
            elif early_tol is None:
                curr_x, u, fstate, _, rp, rd, _ = jax.lax.fori_loop(
                    0, iters, iteration, carry
                )
            else:
                # masked early exit with STATIC control flow: the fori_loop
                # always runs `iters` times, but once the primal residual
                # beats the tolerance every later iteration is frozen to a
                # no-op (static control flow: no host-visible loop
                # condition per iteration)
                def masked(i, cd):
                    c, done = cd
                    new_c = iteration(i, c)
                    frozen = jax.tree_util.tree_map(
                        lambda old, new: jnp.where(done, old, new), c, new_c
                    )
                    done = jnp.logical_or(done, frozen[4][i] <= early_tol)
                    return (frozen, done)

                (curr_x, u, fstate, _, rp, rd, _), _ = jax.lax.fori_loop(
                    0, iters, masked, (carry, jnp.asarray(False))
                )

            new_state = {
                "x": curr_x,
                "v": (curr_x - x0) / dt,
                "t": state["t"] + dt,
                "u": u,
                "forces": fstate,
            }
            aux = {"primal_residual": rp, "dual_residual": rd}
            return new_state, aux

        return step

    # ----------------------------------------------------------- stepping

    def step(self):
        """One timestep; runs host callbacks first (System.cpp:29)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        for cb in self.pre_step_callbacks:
            cb(self)
        if self._lattice is not None:
            self._lattice.step()
            self._lattice_aux()
            self.elapsed_s += self.settings.timestep_s
            return True
        self.state, self.last_aux = self._step_fn(self.state, self.params)
        self.elapsed_s += self.settings.timestep_s
        return True

    def make_rollout(self, n_steps: int):
        """On-device multi-step rollout via lax.scan: one dispatch for
        n_steps timesteps (no host round-trips — use for benchmarking and
        callback-free stretches). Returns jitted (state, params) ->
        (state, aux_stacked)."""
        step = self._make_step()

        def rollout(state, params):
            def body(s, _):
                s2, aux = step(s, params)
                return s2, aux

            return jax.lax.scan(body, state, None, length=n_steps)

        return jax.jit(highest(rollout), donate_argnums=(0,))

    def _lattice_aux(self):
        """last_aux of a whole-mesh layout step: (admm_iters,) residuals
        when the layout collects them."""
        lat = self._lattice
        if lat.last_primal is not None:
            self.last_aux = {"primal_residual": lat.last_primal}
            if getattr(lat, "last_dual", None) is not None:
                self.last_aux["dual_residual"] = lat.last_dual

    def run(self, n_steps: int):
        """Advance n_steps entirely on device (no per-step callbacks)."""
        if self._lattice is not None:
            if not self._lattice.collect_residuals:
                self._lattice.run(n_steps)
            else:
                # stacked (n_steps, admm_iters) residuals, as the rollout
                auxs = []
                for _ in range(n_steps):
                    self._lattice.step()
                    self._lattice_aux()
                    auxs.append(self.last_aux)
                if auxs:
                    self.last_aux = jax.tree_util.tree_map(
                        lambda *a: jnp.stack(a), *auxs)
            self.elapsed_s += n_steps * self.settings.timestep_s
            return True
        key = ("_rollout", n_steps)
        if not hasattr(self, "_rollouts"):
            self._rollouts = {}
        if key not in self._rollouts:
            self._rollouts[key] = self.make_rollout(n_steps)
        self.state, aux = self._rollouts[key](self.state, self.params)
        self.elapsed_s += n_steps * self.settings.timestep_s
        self.last_aux = aux
        return True

    def _route_fast_path(self):
        """Engage a whole-mesh layout for the current scene: the banded tet
        layout, else the grid-cloth layout, each stepped by the XLA program
        of its sharded stepper on a one-device mesh. Leaves _lattice None
        (general path) when neither qualifies."""
        from jax.sharding import Mesh

        from ..parallel.banded_spmd import sharded_banded_from_system
        from ..parallel.cloth_spmd import sharded_cloth_from_system

        mesh = Mesh(np.array(jax.devices()[:1]), ("elem",))
        out = sharded_banded_from_system(self, mesh)
        if out is None:
            out = sharded_cloth_from_system(self, mesh)
        if out is not None:
            self._lattice, self._to_canon = out
            if self.settings.verbose >= 1:
                print("Solver: whole-mesh layout engaged "
                      f"(model={self._lattice.model})")
        elif self.settings.verbose >= 1:
            print("Solver: scene does not qualify for a whole-mesh "
                  "layout; using the general solver")

    def recompute_weights(self):
        """After runtime weight edits (poordillo release path,
        System.cpp:159-179). CG mode needs nothing; dense re-inverts and
        ELL/DIA re-assemble (both host-side, like the reference's
        re-factorization but cheaper), refreshing the AMG values. When a
        whole-mesh layout is engaged, its packed parameter planes (anchor
        weights, materials, matvec diagonals) are REBUILT from the edited
        params with the live state carried over — without this the layout
        would keep stepping stale weights silently."""
        if self._solver_mode == "dense":
            cparams = {
                k: jax.tree_util.tree_map(np.asarray, self.params[k])
                for k in self._constraint_names
            }
            A = assemble_A_hat(self.n_nodes, self._mi, self.settings.timestep_s, cparams)
            self.params["_solver"] = {
                "A_inv": jnp.asarray(np.linalg.inv(A), self.settings.dtype)
            }
            if self.settings.dense_refine_steps > 0:
                # keep the iterative-refinement operands initialize() installed
                ell_idx, ell_vals, _ = assemble_A_hat_ell(
                    self.n_nodes, self._mi, self.settings.timestep_s, cparams
                )
                self.params["_solver"]["ell_idx"] = jnp.asarray(ell_idx)
                self.params["_solver"]["ell_vals"] = jnp.asarray(
                    ell_vals, self.settings.dtype
                )
        elif self._solver_mode in ("ell", "dia"):
            cparams = {
                k: jax.tree_util.tree_map(np.asarray, self.params[k])
                for k in self._constraint_names
            }
            dt_ = self.settings.dtype
            inc = self.params["_solver"]["inc_idx"]
            amg_old = self.params["_solver"].get("amg")
            if self._solver_mode == "dia":
                offs, dia_vals, diag = assemble_A_hat_dia(
                    self.n_nodes, self._mi, self.settings.timestep_s, cparams
                )
                assert offs == self._dia_offsets, "sparsity pattern changed"
                self.params["_solver"] = {
                    "dia_vals": jnp.asarray(dia_vals, dt_),
                    "diag": jnp.asarray(diag, dt_),
                    "inc_idx": inc,
                }
            else:
                ell_idx, ell_vals, diag = assemble_A_hat_ell(
                    self.n_nodes, self._mi, self.settings.timestep_s, cparams
                )
                self.params["_solver"] = {
                    "ell_idx": jnp.asarray(ell_idx),
                    "ell_vals": jnp.asarray(ell_vals, dt_),
                    "diag": jnp.asarray(diag, dt_),
                    "inc_idx": inc,
                }
            if amg_old is not None:
                from .amg import rebuild_amg_values
                from .solver import _assemble_A_hat_csr

                A = _assemble_A_hat_csr(
                    self.n_nodes, self._mi, self.settings.timestep_s,
                    cparams,
                )
                host = jax.tree_util.tree_map(np.asarray, amg_old)
                self.params["_solver"]["amg"] = _cast_tree(
                    rebuild_amg_values(A, host, self._amg_meta), dt_
                )
        if self._lattice is not None:
            # re-pack the layout's parameter planes from the edited params,
            # keeping its live state (the packing is deterministic given
            # the unchanged topology)
            self._lattice.refresh_params()

    # -------------------------------------------------------- checkpoints

    def save_checkpoint(self, path: str) -> None:
        """Checkpoint the live simulation state — CORRECT on both the
        general path (state pytree) and the whole-mesh layouts
        (whose live state lives in the stepper's packed planes; the
        general `self.state` is stale there). Restore into an
        identically-constructed System with `load_checkpoint` (packing
        is deterministic, so plane layouts match)."""
        from ..utils.checkpoint import save_state

        if self._lattice is not None:
            save_state(path, {
                "_fast_path": dict(self._lattice.state),
                "_elapsed_s": np.float64(self.elapsed_s),
            })
        else:
            save_state(path, dict(self.state,
                                  _elapsed_s=np.float64(self.elapsed_s)))

    def load_checkpoint(self, path: str) -> None:
        from ..utils.checkpoint import load_state

        dtype = self.settings.dtype
        if self._lattice is not None:
            tree = load_state(path, dtype=dtype)
            if "_fast_path" not in tree:
                raise ValueError(
                    "checkpoint was saved from the general path but this "
                    "System runs a whole-mesh layout — rebuild "
                    "with the same configuration it was saved from"
                )
            self.elapsed_s = float(np.asarray(tree["_elapsed_s"]))
            st = tree["_fast_path"]
            cur = self._lattice.state
            if set(st) != set(cur):
                raise ValueError(
                    f"fast-path checkpoint keys {sorted(st)} do not match "
                    f"this stepper's state {sorted(cur)}"
                )
            for k, v in st.items():
                if hasattr(cur[k], "shape") and cur[k].shape != v.shape:
                    raise ValueError(
                        f"checkpoint plane {k!r} shape {v.shape} != "
                        f"{cur[k].shape} — mesh/settings differ"
                    )
            self._lattice.state = st
        else:
            with np.load(path) as data:
                if any(k.startswith("_fast_path") for k in data.files):
                    raise ValueError(
                        "checkpoint was saved from a whole-timestep fast "
                        "path but this System runs the general path"
                    )
            tree = load_state(path, dtype=dtype, like=dict(
                self.state, _elapsed_s=np.float64(0.0)))
            self.elapsed_s = float(np.asarray(tree.pop("_elapsed_s")))
            self.state = tree

    # ------------------------------------------------------------- access

    @property
    def x(self) -> np.ndarray:
        if getattr(self, "_lattice", None) is not None:
            # canonical lattice numbering -> the caller's numbering
            return np.asarray(self._lattice.x)[self._to_canon]
        if self.initialized and self._o2i is not None:
            return np.asarray(self.state["x"])[self._o2i]
        return np.asarray(self.state["x"] if self.initialized else self._x)

    @x.setter
    def x(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if getattr(self, "_lattice", None) is not None:
            lat = self._lattice
            xc = np.empty_like(value)
            xc[np.asarray(self._to_canon)] = value
            lat.set_positions(xc)
        elif self.initialized:
            vi = value if self._i2o is None else value[self._i2o]
            self.state["x"] = jnp.asarray(vi, self.settings.dtype)
        self._x = value

    @property
    def v(self) -> np.ndarray:
        if getattr(self, "_lattice", None) is not None:
            return np.asarray(self._lattice.v)[self._to_canon]
        if self.initialized and self._o2i is not None:
            return np.asarray(self.state["v"])[self._o2i]
        return np.asarray(self.state["v"]) if self.initialized else np.zeros_like(self._x)

    @v.setter
    def v(self, value):
        if not self.initialized:
            raise RuntimeError("set velocities after initialize()")
        vv = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if getattr(self, "_lattice", None) is not None:
            lat = self._lattice
            vc = np.empty_like(vv)
            vc[np.asarray(self._to_canon)] = vv
            lat.set_velocities(vc)
            return
        if self._i2o is not None:
            vv = vv[self._i2o]
        self.state["v"] = jnp.asarray(vv, self.settings.dtype)

    @property
    def masses(self) -> np.ndarray:
        return self._m

    def set_force_param(self, force, key, value):
        """Host-side runtime edit of a traced parameter (e.g. weights,
        wind direction, control points)."""
        name = force if isinstance(force, str) else force.name
        self.params[name][key] = jnp.asarray(
            np.asarray(value), self.params[name][key].dtype
        )

    def set_force_state(self, force, key, value):
        name = force if isinstance(force, str) else force.name
        self.state["forces"][name][key] = jnp.asarray(
            np.asarray(value), self.state["forces"][name][key].dtype
        )
