"""Core solver: the reference's smoke scenarios as numeric regression tests
plus convergence/conservation checks (reference has only stdout smoke tests,
deps/admm-elastic-sca/samples/singlenode.cpp, singletet.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.models import (
    Bend,
    Collision,
    ExplicitForce,
    Floor,
    HyperElasticTet,
    LimitedTriangleStrain,
    LinearTetStrain,
    MovingAnchor,
    Spring,
    StaticAnchor,
    TetVolume,
    WindForce,
)


def _settings(**kw):
    kw.setdefault("dtype", jnp.float64)
    kw.setdefault("verbose", 0)
    return Settings(**kw)


def test_singlenode_free_fall():
    """1 node + gravity, dt=1, 4 steps (singlenode.cpp:25-73). With no
    constraints the ADMM solve reduces to x' = xbar: symplectic-Euler free
    fall x_k = -9.8 * k(k+1)/2."""
    sys = System(_settings(timestep_s=1.0, admm_iters=20))
    sys.add_nodes(np.zeros(3), np.ones(3))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    # no constraint forces at all -> pure explicit integration, but System
    # needs at least the machinery to run; add a zero-weight anchor? No:
    # the solver handles the no-constraint case (A = M).
    assert sys.initialize()
    expected_y = 0.0
    vel = 0.0
    for k in range(4):
        sys.step()
        vel += -9.8
        expected_y += vel
        assert sys.x[0, 1] == pytest.approx(expected_y, rel=1e-12)
        assert sys.x[0, 0] == 0.0 and sys.x[0, 2] == 0.0


def test_singletet_recovery():
    """1 tet, 3 anchors, 4th node stretched to x=200, one step with 20 ADMM
    iters pulls it far back toward rest (singletet.cpp:27-111)."""
    sys = System(_settings(timestep_s=1.0, admm_iters=20))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=1.0))
    assert sys.initialize()
    sys.x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [200, 0, 0]], dtype=float)
    sys.step()
    new_x = sys.x[3, 0]
    # oracle (tests/reference_impl.py) gives 171.571... after one step with
    # these settings; parity is asserted exactly in test_parity.py
    assert new_x == pytest.approx(171.5714285714, rel=1e-6)
    # anchored nodes barely move (weight 1000)
    assert np.abs(sys.x[:3] - x[:3]).max() < 0.2
    # further steps converge to rest
    for _ in range(100):
        sys.step()
    assert sys.x[3, 0] == pytest.approx(1.0, abs=0.1)


def test_spring_rest_convergence():
    """Two nodes + spring, one anchored: free node returns to rest length
    (dt=0.1 for implicit damping; small dt keeps oscillating, correctly)."""
    sys = System(_settings(timestep_s=0.1, admm_iters=10))
    sys.add_nodes(np.array([[0, 0, 0], [2, 0, 0]], dtype=float), np.ones(2))
    sys.add_force(StaticAnchor([0]))
    sys.add_force(Spring(np.array([[0, 1]]), stiffness=100.0))
    assert sys.initialize()
    # stretch to 3, let it spring back (no gravity)
    sys.x = np.array([[0, 0, 0], [3, 0, 0]], dtype=float)
    for _ in range(400):
        sys.step()
    assert sys.x[1, 0] == pytest.approx(2.0, abs=1e-2)


def test_dense_and_cg_agree():
    """Global solve modes must produce the same trajectory."""
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    results = []
    for mode in ("dense", "cg"):
        sys = System(
            _settings(timestep_s=0.04, admm_iters=10, global_solver=mode,
                      cg_tol=1e-12, cg_max_iters=500)
        )
        sys.add_nodes(x, np.ones(4))
        sys.add_force(StaticAnchor([0]))
        sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=50.0))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(10):
            sys.step()
        results.append(sys.x.copy())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5, atol=1e-8)


def test_residuals_decrease():
    """Primal residual decreases over ADMM iterations within a step."""
    sys = System(
        _settings(timestep_s=0.04, admm_iters=30, collect_residuals=True)
    )
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
    assert sys.initialize()
    sys.x = x + np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.5, 0.3, -0.2]])
    sys.step()
    rp = np.asarray(sys.last_aux["primal_residual"])
    assert rp.shape == (30,)
    assert rp[-1] < rp[0]
    assert rp[-1] < 1e-2 * rp[0] + 1e-12


def test_hyperelastic_inversion_recovery():
    """Scrambled tet (bunnyexpand-style, inverted elements) recovers positive
    volume under StVK."""
    rng = np.random.default_rng(0)
    x = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=float
    )
    tets = np.array([[0, 1, 2, 3], [4, 1, 2, 3]], dtype=np.int32)
    for model in ("stvk", "nh"):
        sys = System(_settings(timestep_s=0.04, admm_iters=10))
        sys.add_nodes(x, np.ones(5))
        sys.add_force(HyperElasticTet(tets, mu=100.0, lam=100.0, max_iters=5,
                                      model=model))
        assert sys.initialize()
        scramble = rng.uniform(-0.75, 0.75, size=(5, 3))
        sys.x = scramble
        for _ in range(100):
            sys.step()
        # signed volumes of both tets back to positive and near rest
        def vol(xx, t):
            v = xx[t]
            return np.dot(v[1] - v[0], np.cross(v[2] - v[0], v[3] - v[0])) / 6.0
        rest0 = vol(x, tets[0])
        got0 = vol(sys.x, tets[0])
        assert got0 > 0.25 * rest0
        assert np.all(np.isfinite(sys.x))


def test_tet_volume_preservation():
    sys = System(_settings(timestep_s=0.04, admm_iters=15))
    x = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0]))
    sys.add_force(TetVolume(np.array([[0, 1, 2, 3]]), stiffness=1000.0,
                            limit_min=1.0, limit_max=1.0))
    assert sys.initialize()
    # squash the tet: volume preservation should push back toward rest volume
    squash = x.copy()
    squash[1:] *= 0.5
    sys.x = squash
    for _ in range(200):
        sys.step()
    v = sys.x
    vol = abs(np.dot(v[1] - v[0], np.cross(v[2] - v[0], v[3] - v[0]))) / 6.0
    assert vol == pytest.approx(1 / 6, rel=0.05)


def test_cloth_with_bend_wind_anchors_runs():
    """Miniature windyflag: plane + strain + bend + anchors + gravity + wind."""
    from admm_elastic_tpu.geometry import extract_hinges, make_sym_plane

    mesh = make_sym_plane(4, 3)
    n = mesh.n_vertices
    sys = System(_settings(timestep_s=0.04, admm_iters=10))
    sys.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    sys.add_force(
        LimitedTriangleStrain(mesh.faces, stiffness=100.0, limit_min=0.95,
                              limit_max=1.05)
    )
    sys.add_force(Bend(extract_hinges(mesh.faces), stiffness=20.0))
    sys.add_force(StaticAnchor([0, 3]))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    # wind scaled to the coarse tessellation: the reference's alpha_n=1000
    # with per-node mass ~0.04 kg needs small per-triangle areas or gentle
    # wind to stay stable (the real flag's triangles are ~100x smaller)
    wind = WindForce(mesh.faces, direction=(1.0, 0, 0.2))
    sys.add_explicit_force(wind)
    assert sys.initialize()
    for _ in range(20):
        sys.step()
    assert np.all(np.isfinite(sys.x))
    # pinned corners stay put
    np.testing.assert_allclose(sys.x[0], mesh.vertices[0], atol=1e-3)
    # free cloth has moved
    assert np.abs(sys.x - mesh.vertices).max() > 0.05


def test_collision_floor():
    """Node falling under gravity stops at the floor."""
    sys = System(_settings(timestep_s=0.04, admm_iters=10))
    sys.add_nodes(np.array([[0.0, 1.0, 0.0]]), np.ones(1))
    sys.add_force(Collision([Floor(center=(0, 0, 0))], n_nodes=1))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    for _ in range(100):
        sys.step()
    assert sys.x[0, 1] == pytest.approx(0.0, abs=2e-2)


def test_moving_anchor_grab_release():
    """poordillo-style grab: anchor drags a node; releasing (weight->0 +
    recompute_weights) frees it; inactive control point follows the node."""
    sys = System(_settings(timestep_s=0.04, admm_iters=10))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))  # hold the body so release has a rest pose
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
    anchor = sys.add_force(MovingAnchor([3], weight=1000.0))
    assert sys.initialize()
    # drag the control point
    sys.set_force_state(anchor, "pos", np.array([[2.0, 0.0, 0.0]]))
    for _ in range(30):
        sys.step()
    assert sys.x[3, 0] == pytest.approx(2.0, abs=0.05)
    # release: weight 0 + deactivate (poordillo.cpp:196-215)
    sys.set_force_param(anchor, "weight", np.array([0.0]))
    sys.set_force_state(anchor, "active", np.array([False]))
    sys.recompute_weights()
    for _ in range(200):
        sys.step()
    # tet elasticity pulls node back toward rest (x approx 1)
    assert sys.x[3, 0] < 1.5
    # inactive control point tracked the node
    pos = np.asarray(sys.state["forces"][anchor.name]["pos"])
    np.testing.assert_allclose(pos[0], sys.x[3], atol=1e-6)


def test_warm_started_duals_persist():
    sys = System(_settings(timestep_s=0.04, admm_iters=5))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    sys.step()
    u = sys.state["u"]
    total = sum(float(jnp.abs(u[k]).sum()) for k in u)
    assert total > 0.0  # duals carry information across steps (System.cpp:42)


def test_residual_early_exit():
    """residual_tol stops ADMM iterations once converged; trajectory stays
    close to the full-iteration run."""
    def build(tol):
        sys = System(_settings(timestep_s=0.04, admm_iters=50,
                               collect_residuals=True, residual_tol=tol))
        x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
        sys.add_nodes(x, np.ones(4))
        sys.add_force(StaticAnchor([0, 1, 2]))
        sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
        assert sys.initialize()
        sys.x = x + np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.4, 0.2, -0.1]])
        return sys

    full = build(None if False else 0.0)  # tol=0 -> never early-exits
    full.step()
    rp_full = np.asarray(full.last_aux["primal_residual"])
    assert np.count_nonzero(rp_full) == 50

    early = build(1e-6)
    early.step()
    rp_early = np.asarray(early.last_aux["primal_residual"])
    n_used = int(np.count_nonzero(rp_early))
    assert 0 < n_used < 50
    assert rp_early[n_used - 1] <= 1e-6
    np.testing.assert_allclose(early.x, full.x, atol=1e-5)


def test_ell_mode_matches_dense():
    """ELL gather-matvec CG reproduces the dense trajectory."""
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    results = []
    for mode in ("dense", "ell"):
        sys = System(
            _settings(timestep_s=0.04, admm_iters=10, global_solver=mode,
                      cg_tol=1e-12, cg_max_iters=500)
        )
        sys.add_nodes(x, np.ones(4))
        sys.add_force(StaticAnchor([0]))
        sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=50.0))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(10):
            sys.step()
        results.append(sys.x.copy())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-5, atol=1e-8)


def test_ell_beam_larger():
    """ELL vs matrix-free CG on a beam with shared vertices (duplicate
    coalescing in assembly)."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 3)
    res = []
    for mode in ("cg", "ell"):
        sys = System(_settings(timestep_s=0.04, admm_iters=8,
                               global_solver=mode, cg_tol=1e-12,
                               cg_max_iters=600))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(LinearTetStrain(beam.tets, stiffness=300.0))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(5):
            sys.step()
        res.append(sys.x.copy())
    np.testing.assert_allclose(res[0], res[1], rtol=1e-6, atol=1e-8)


def test_determinism_bitwise():
    """Two identical runs are bitwise identical (the reference's omp
    scatter ordering is nondeterministic; ours must not be)."""
    def run():
        from admm_elastic_tpu.geometry import make_beam_tets

        beam = make_beam_tets(3, 2, 2)
        sys = System(_settings(timestep_s=0.04, admm_iters=8))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=1e4, max_iters=5))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(5):
            sys.step()
        return sys.x

    a, b = run(), run()
    assert np.array_equal(a, b), "nondeterministic trajectory"


def test_dense_refine_improves_f32_solve():
    """dense_refine_steps tightens the f32 global solve toward the f64 one."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 3)

    def build(dtype, refine=0):
        sys = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                              dtype=dtype, global_solver="dense",
                              dense_max_nodes=1 << 20,
                              dense_refine_steps=refine))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(LinearTetStrain(beam.tets, stiffness=1e5))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(4):
            sys.step()
        return sys.x

    # per-solve accuracy: refinement tightens A x = b beyond the raw f32
    # inverse (trajectory-level error after several chaotic steps is not
    # monotone, so we check the solve itself)
    from admm_elastic_tpu.core.solver import (
        assemble_A_hat,
        assemble_A_hat_ell,
        ell_apply,
    )

    # stiff configuration (large kappa) so the f32 inverse error is visible
    sys = System(Settings(timestep_s=0.04, admm_iters=2, verbose=0,
                          dtype=jnp.float32, global_solver="dense",
                          dense_max_nodes=1 << 20, dense_refine_steps=1))
    n = beam.n_vertices
    sys.add_nodes(beam.vertices, np.full(n, 1e-3 / n))
    sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9),
                               weight=1e5))
    sys.add_force(LinearTetStrain(beam.tets, stiffness=1e8))
    assert sys.initialize()

    # refinement reduces the residual of the actual (f32) operator:
    # ||b - A x1|| < ||b - A x0|| — the guarantee the step provides
    rng = np.random.default_rng(0)
    b = rng.normal(size=(n, 3))
    Ainv32 = np.asarray(sys.params["_solver"]["A_inv"])  # f32
    ell_idx = sys.params["_solver"]["ell_idx"]
    ell_vals = sys.params["_solver"]["ell_vals"]
    b32 = jnp.asarray(b, jnp.float32)
    x0 = np.asarray(Ainv32 @ np.asarray(b32))
    r0 = np.asarray(b32 - ell_apply(jnp.asarray(x0), ell_idx, ell_vals))
    x1 = x0 + np.asarray(Ainv32 @ jnp.asarray(r0))
    r1 = np.asarray(b32 - ell_apply(jnp.asarray(x1), ell_idx, ell_vals))
    assert np.linalg.norm(r1) < np.linalg.norm(r0)
    assert np.isfinite(x1).all()



    # and the refined stepping path runs
    sys.step()
    assert np.isfinite(sys.x).all()


def test_dia_pcg_solve_matches_spsolve():
    """The XLA dia global solve (fixed-iteration Jacobi-PCG over the
    diagonal matvec) converges to scipy's direct sparse solve of A_hat."""
    import scipy.sparse.linalg as spla

    from admm_elastic_tpu.core.solver import (
        _assemble_A_hat_csr,
        assemble_A_hat_dia,
        dia_apply,
        pcg_solve_fixed,
    )
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(5, 4, 3)
    n = beam.n_vertices
    masses = np.full(n, 1.0 / n)
    p, _ = HyperElasticTet(beam.tets, mu=1e4, lam=1e4).build(
        beam.vertices, masses, 0.04)
    cparams = {"t": p}
    offs, dia, diag = assemble_A_hat_dia(n, masses, 0.04, cparams)
    A = _assemble_A_hat_csr(n, masses, 0.04, cparams).tocsc()
    b = np.random.default_rng(0).normal(size=(n, 3))
    ref = np.stack([spla.spsolve(A, b[:, a]) for a in range(3)], 1)
    x, _ = pcg_solve_fixed(
        lambda y: dia_apply(y, offs, jnp.asarray(dia)), jnp.asarray(b),
        jnp.zeros((n, 3)), jnp.asarray(diag), 400)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-8, atol=1e-10)


def test_dia_solver_matches_ell():
    """Sparse-DIAgonal single-kernel CG (structured meshes) matches ELL."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(5, 4, 3)

    def run(mode):
        sys = System(Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                              dtype=jnp.float32, global_solver=mode,
                              cg_fixed_iters=25))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=1e4, max_iters=5))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(5):
            sys.step()
        return sys.x

    a = run("ell")
    b = run("dia")
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=5e-5)


def test_dia_falls_back_for_unstructured():
    """Randomly permuted numbering with reorder='none' -> too many
    diagonals -> ell fallback (reorder='auto' would instead renumber and
    restore dia; see test_grid_renumbering_restores_dia)."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(5, 4, 3)
    rng = np.random.default_rng(0)
    perm = rng.permutation(beam.n_vertices)
    inv = np.argsort(perm)
    verts = beam.vertices[perm]
    tets = inv[beam.tets]

    sys = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                          dtype=jnp.float32, global_solver="dia",
                          cg_fixed_iters=20, reorder="none"))
    n = len(verts)
    sys.add_nodes(verts, np.full(n, 1.0 / n))
    sys.add_force(LinearTetStrain(tets, stiffness=1e4))
    assert sys.initialize()
    assert sys._solver_mode == "ell"
    sys.step()
    assert np.isfinite(sys.x).all()


def test_amg_preconditioner_dia_matches_ell():
    """preconditioner='amg' is the general AMG on every sparse mode: the
    dia and ell matvecs give the same AMG-PCG trajectory."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 3)

    def build(mode):
        sys = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                              dtype=jnp.float64, global_solver=mode,
                              cg_fixed_iters=8, preconditioner="amg"))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        assert sys._solver_mode == mode and sys._amg_meta is not None
        for _ in range(4):
            sys.step()
        return sys.x

    np.testing.assert_allclose(build("dia"), build("ell"), rtol=1e-9,
                               atol=1e-11)


def test_dia_assembly_matches_matrix():
    """assemble_A_hat_dia + dia_apply reproduce the dense operator."""
    from admm_elastic_tpu.core.solver import (
        assemble_A_hat,
        assemble_A_hat_dia,
        dia_apply,
    )
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 2)
    n = beam.n_vertices
    lt = LinearTetStrain(beam.tets, stiffness=123.0)
    p, _ = lt.build(beam.vertices, np.full(n, 0.5), 0.04)
    cparams = {"t": p}
    masses = np.full(n, 0.5)
    A = assemble_A_hat(n, masses, 0.04, cparams)
    offs, dia, diag = assemble_A_hat_dia(n, masses, 0.04, cparams)
    assert len(offs) <= 40
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3))
    want = A @ x
    got = np.asarray(dia_apply(jnp.asarray(x), offs, jnp.asarray(dia)))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(diag, np.diag(A), rtol=1e-12)


def test_recompute_weights_dense_with_refine():
    """Regression: recompute_weights() in dense mode must repopulate the
    iterative-refinement ELL operands (dense_refine_steps>0) or the next
    step() retraces and dies with KeyError 'ell_idx'."""
    sys = System(Settings(timestep_s=0.04, admm_iters=5, verbose=0,
                          global_solver="dense", dense_refine_steps=1))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
    anchor = sys.add_force(MovingAnchor([3], weight=1000.0))
    assert sys.initialize()
    sys.step()
    sys.set_force_param(anchor, "weight", np.array([0.0]))
    sys.set_force_state(anchor, "active", np.array([False]))
    sys.recompute_weights()
    sys.step()  # must not raise
    assert np.all(np.isfinite(sys.x))


@pytest.mark.parametrize("mode", ["ell", "dia"])
def test_release_weight_zero_precomputed_modes(mode):
    """poordillo release (weight -> 0 + recompute_weights,
    System.cpp:159-179) in the precomputed-matrix modes on a mesh larger
    than the dense-auto threshold: the sparsity pattern is topological, so
    the release must neither assert ('sparsity pattern changed') nor
    retrace with new shapes."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(16, 16, 16)  # 4913 nodes > dense_max_nodes
    assert beam.n_vertices > 4096
    sys = System(Settings(timestep_s=0.04, admm_iters=3, verbose=0,
                          global_solver=mode, cg_fixed_iters=8))
    n = beam.n_vertices
    sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    sys.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
    tip = int(np.argmax(beam.vertices[:, 0]))
    anchor = sys.add_force(MovingAnchor([tip], weight=1000.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    shapes_before = {
        k: np.asarray(v).shape for k, v in sys.params["_solver"].items()
    }
    sys.step()
    sys.set_force_param(anchor, "weight", np.array([0.0]))
    sys.set_force_state(anchor, "active", np.array([False]))
    sys.recompute_weights()  # must not assert
    shapes_after = {
        k: np.asarray(v).shape for k, v in sys.params["_solver"].items()
    }
    assert shapes_before == shapes_after, "pattern reshape would retrace"
    sys.step()
    assert np.all(np.isfinite(sys.x))


def test_recompute_weights_refreshes_fast_path_kernel():
    """Runtime weight edits must flow into an ENGAGED whole-mesh layout:
    recompute_weights() re-packs the layout's parameter planes from the
    edited params, carrying the live state. Without this the layout would
    keep stepping the stale anchor weights silently."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(8, 4, 4)
    n = beam.n_vertices
    sys = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                          global_solver="dia", cg_fixed_iters=10,
                          lattice_fast_path=True))
    sys.add_nodes(beam.vertices, np.full(n, 5.0 / n))
    anchor = sys.add_force(
        StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    sys.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    lat0 = sys._lattice
    assert lat0 is not None
    for _ in range(3):
        sys.step()
    x_held = np.asarray(sys.x).copy()
    n_anc = len(np.asarray(sys.params[anchor.name]["indices"]))
    sys.set_force_param(anchor, "weight", np.zeros(n_anc))
    x_state = np.asarray(sys._lattice.state["x"]).copy()
    base0 = sys._lattice.base
    sys.recompute_weights()
    # re-packed planes (a new packed base) carrying the live state
    assert sys._lattice is lat0 and sys._lattice.base is not base0
    np.testing.assert_array_equal(np.asarray(sys._lattice.state["x"]),
                                  x_state)
    for _ in range(10):
        sys.step()
    # the released beam fell — stale planes would have held it
    assert np.asarray(sys.x)[:, 1].min() < x_held[:, 1].min() - 1e-3


def test_residuals_with_fused_kernels_match_unfused(nh_kernel):
    """collect_residuals keeps the fused local+RHS kernel: the ell mode
    with the Pallas NH kernel (interpret mode; 6-wide contribution
    gather) gives the primal/dual residual trajectories of the XLA
    local step."""
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import HyperElasticTet

    beam = make_beam_tets(4, 3, 3)

    def run(mode):
        sys = System(Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                              global_solver=mode, cg_fixed_iters=40,
                              dtype=jnp.float64, collect_residuals=True))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=4e4, max_iters=5,
                                      model="nh"))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        rps, rds = [], []
        for _ in range(3):
            sys.step()
            rps.append(np.asarray(sys.last_aux["primal_residual"]))
            rds.append(np.asarray(sys.last_aux["dual_residual"]))
        return np.stack(rps), np.stack(rds), sys.x

    with nh_kernel():
        rp_f, rd_f, x_f = run("ell")
    rp_u, rd_u, x_u = run("ell")
    assert rp_f.shape == (3, 8) and np.all(rp_f > 0)
    # same global solve, f64: differences are only the local-step kernels'
    # SVD algorithm (Jacobi sweeps vs one-sided) round-off
    np.testing.assert_allclose(rp_f, rp_u, rtol=1e-3, atol=1e-6 * rp_u.max())
    np.testing.assert_allclose(rd_f, rd_u, rtol=1e-2, atol=1e-4 * rd_u.max())
    np.testing.assert_allclose(x_f, x_u, atol=1e-6)


def test_residual_early_exit_masked_ell_pallas(nh_kernel):
    """The masked (static-control-flow) early exit works in the fused
    ell + Pallas NH kernel configuration (interpret mode): iterations
    freeze once converged and the trajectory matches the full run."""
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import HyperElasticTet

    beam = make_beam_tets(3, 2, 2)

    def build(tol):
        sys = System(Settings(timestep_s=0.04, admm_iters=40, verbose=0,
                              global_solver="ell", cg_fixed_iters=30,
                              dtype=jnp.float64, residual_tol=tol))
        n = beam.n_vertices
        sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        sys.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=1e4, max_iters=5,
                                      model="nh"))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        return sys

    with nh_kernel():
        full = build(0.0)
        full.step()
        early = build(1e-3)
        early.step()
    rp = np.asarray(early.last_aux["primal_residual"])
    n_used = int(np.count_nonzero(rp))
    assert 0 < n_used < 40
    assert rp[n_used - 1] <= 1e-3
    # stopping at tol=1e-3 legitimately leaves ~tol-scale difference vs the
    # 40-iteration run
    np.testing.assert_allclose(early.x, full.x, atol=1e-4)


def test_grid_renumbering_restores_dia():
    """A scrambled-numbering grid mesh re-qualifies for the dia solver via
    the internal position-based renumbering; the public x/v API stays in
    the caller's numbering and matches the ordered-mesh trajectory."""
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import HyperElasticTet

    beam = make_beam_tets(4, 3, 3)
    rng = np.random.default_rng(5)
    perm = rng.permutation(beam.n_vertices)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    sverts, stets = beam.vertices[perm], inv[beam.tets]

    def build(verts, tets, anchors):
        sys = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                              dtype=jnp.float64, global_solver="dia",
                              cg_fixed_iters=25))
        n = len(verts)
        sys.add_nodes(verts, np.full(n, 1.0 / n))
        sys.add_force(StaticAnchor(anchors))
        sys.add_force(HyperElasticTet(tets, mu=1e4, lam=1e4, max_iters=5,
                                      model="nh"))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        return sys

    anchors_o = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
    anchors_s = np.flatnonzero(sverts[:, 0] < 1e-9)
    ordered = build(beam.vertices, beam.tets, anchors_o)
    scrambled = build(sverts, stets, anchors_s)
    assert ordered._solver_mode == "dia" and ordered._o2i is None
    assert scrambled._solver_mode == "dia", "renumbering did not restore dia"
    assert scrambled._o2i is not None
    for _ in range(3):
        ordered.step()
        scrambled.step()
    # caller's-numbering positions match the ordered run's (row-permuted)
    np.testing.assert_allclose(scrambled.x, ordered.x[perm], atol=1e-9)
    # v accessor round-trips through the renumbering
    scrambled.v = scrambled.v
    scrambled.step()
    assert np.isfinite(scrambled.x).all()



def test_cloth_layout_matches_general_path():
    """windyflag-shaped scene stepped by the grid-cloth layout
    (lattice_fast_path: ShardedClothStepper on one device) vs the general
    ell path: same trajectory and primal residuals."""
    from admm_elastic_tpu.geometry import extract_hinges, make_sym_plane
    from admm_elastic_tpu.models import Bend, LimitedTriangleStrain, WindForce

    mesh = make_sym_plane(8, 6)
    n = mesh.n_vertices

    def run(layout, mode):
        sys = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                              dtype=jnp.float64, global_solver=mode,
                              cg_fixed_iters=400, collect_residuals="primal",
                              lattice_fast_path=layout))
        sys.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        sys.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        sys.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        sys.add_force(StaticAnchor([0, 8]))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        sys.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, 0.4)))
        assert sys.initialize()
        assert (sys._lattice is not None) == layout
        rps = []
        for _ in range(5):
            sys.step()
            rps.append(np.asarray(sys.last_aux["primal_residual"]))
        return sys.x, np.stack(rps)

    x_p, rp_p = run(True, "dia")
    x_x, rp_x = run(False, "ell")
    # both solves converged (cg400): the layouts differ only in sum order
    np.testing.assert_allclose(x_p, x_x, atol=1e-8)
    np.testing.assert_allclose(rp_p, rp_x, rtol=1e-5, atol=1e-10)


def test_grid_cloth_dia_matches_ell():
    """Regular-grid cloth (make_plane_grid) qualifies for the dia solver
    (~7 constant diagonals incl. bend coupling) and matches the ell path."""
    from admm_elastic_tpu.geometry import extract_hinges, make_plane_grid
    from admm_elastic_tpu.models import Bend, LimitedTriangleStrain

    mesh = make_plane_grid(10, 8)
    n = mesh.n_vertices

    def run(mode):
        sys = System(Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                              dtype=jnp.float64, global_solver=mode,
                              cg_fixed_iters=30))
        sys.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        sys.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        sys.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        sys.add_force(StaticAnchor([0, 8]))
        sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert sys.initialize()
        for _ in range(4):
            sys.step()
        return sys

    d = run("dia")
    assert d._solver_mode == "dia"
    e = run("ell")
    np.testing.assert_allclose(d.x, e.x, atol=1e-8)


def test_cg_schedule_tuple_runs_all_fixed_paths():
    """cg_fixed_iters=(first, rest): ADMM iteration 0 gets a deeper CG
    solve (its warm start is stale by the whole explicit kick). The
    schedule must produce the same trajectory as a flat budget when both
    are converged, in every fixed-CG solver branch."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(5, 4, 3)
    n = beam.n_vertices

    def build(solver, cg):
        s = System(_settings(timestep_s=0.04, admm_iters=6,
                             global_solver=solver, cg_fixed_iters=cg))
        s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-12)))
        s.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        for _ in range(3):
            s.step()
        return np.asarray(s.x)

    for solver in ("ell", "dia", "cg"):
        flat = build(solver, 120)
        sched = build(solver, (120, 110))
        np.testing.assert_allclose(sched, flat, rtol=0, atol=1e-9,
                                   err_msg=solver)
        # an actually-uneven schedule stays close to converged
        uneven = build(solver, (120, 40))
        np.testing.assert_allclose(uneven, flat, rtol=0, atol=1e-6,
                                   err_msg=f"{solver} uneven")


# ---------------------------------------------------------------- iteration
# variants: over-relaxation and Anderson acceleration (neither exists in the
# reference — System.cpp:54-58 is the plain alpha=1 iteration; these are
# opt-in convergence accelerators on the general path only)


def _accel_scene(**kw):
    """Single stretched tet + 3 anchors; returns the stepped system."""
    sys = System(_settings(timestep_s=0.04, admm_iters=30,
                           collect_residuals=True, **kw))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(StaticAnchor([0, 1, 2]))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=100.0))
    assert sys.initialize()
    sys.x = x + np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.5, 0.3, -0.2]])
    sys.step()
    return sys


def test_relaxation_identity_and_speedup():
    """relaxation=1.0 IS the default path; 1.5 converges measurably faster
    at equal iterations; both reach the same fixed point."""
    plain = _accel_scene()
    one = _accel_scene(relaxation=1.0)
    np.testing.assert_array_equal(np.asarray(one.x), np.asarray(plain.x))
    relaxed = _accel_scene(relaxation=1.5)
    rp = np.asarray(plain.last_aux["primal_residual"])[-1]
    rr = np.asarray(relaxed.last_aux["primal_residual"])[-1]
    assert rr < 0.1 * rp  # measured: 5.2e-11 vs 2.1e-9
    np.testing.assert_allclose(np.asarray(relaxed.x), np.asarray(plain.x),
                               rtol=0, atol=1e-7)


def test_anderson_m0_matches_plain():
    """Anderson with zero history depth degenerates to plain ADMM exactly
    (the safeguarded loop takes the plain update every iteration)."""
    plain = _accel_scene()
    aa = _accel_scene(acceleration="anderson", anderson_m=0)
    np.testing.assert_array_equal(np.asarray(aa.x), np.asarray(plain.x))
    np.testing.assert_array_equal(
        np.asarray(aa.last_aux["primal_residual"]),
        np.asarray(plain.last_aux["primal_residual"]))


def test_anderson_accelerates():
    """Anderson(m) cuts the residual at equal iteration count and lands on
    the same fixed point (measured: 2e-13 vs 2e-9 at 30 iters)."""
    plain = _accel_scene()
    rp = np.asarray(plain.last_aux["primal_residual"])[-1]
    for m in (2, 5):
        aa = _accel_scene(acceleration="anderson", anderson_m=m)
        ra = np.asarray(aa.last_aux["primal_residual"])[-1]
        assert np.isfinite(np.asarray(aa.x)).all()
        assert ra < 0.1 * rp, f"m={m}: {ra} vs plain {rp}"
        np.testing.assert_allclose(np.asarray(aa.x), np.asarray(plain.x),
                                   rtol=0, atol=1e-7)


def test_anderson_multi_step_stable():
    """Warm-started duals + Anderson across many steps stay finite and
    track the plain-ADMM trajectory (both converge per step, so the
    dynamics must agree; the undamped tet keeps oscillating — that is
    correct physics, not drift)."""
    def run(**kw):
        sys = System(_settings(timestep_s=0.04, admm_iters=10, **kw))
        x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]],
                     dtype=float)
        sys.add_nodes(x, np.ones(4))
        sys.add_force(StaticAnchor([0, 1, 2]))
        sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]),
                                      stiffness=100.0))
        assert sys.initialize()
        sys.x = x + np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0],
                              [0.5, 0.3, -0.2]])
        for _ in range(50):
            sys.step()
        return np.asarray(sys.x)

    plain = run()
    aa = run(acceleration="anderson", anderson_m=4)
    assert np.isfinite(aa).all()
    np.testing.assert_allclose(aa, plain, rtol=0, atol=1e-5)


def test_nonreference_iteration_disables_fast_paths():
    """relaxation!=1 / acceleration / the AMG preconditioner must NOT
    engage a whole-mesh layout (the layouts run the plain reference
    iteration with a Jacobi budget)."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 3)
    n = beam.n_vertices

    def build(**kw):
        s = System(_settings(timestep_s=0.04, admm_iters=30,
                             global_solver="dia", lattice_fast_path=True,
                             **kw))
        s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-12)))
        s.add_force(LinearTetStrain(beam.tets, stiffness=1e4))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    assert build()._lattice is not None  # sanity: the scene DOES qualify
    assert build(relaxation=1.5)._lattice is None
    assert build(acceleration="anderson")._lattice is None
    assert build(preconditioner="amg", cg_fixed_iters=8)._lattice is None

    # and the general path honors the relaxation: same fixed point as the
    # layout trajectory at converged iteration counts
    fast = build()
    slow = build(relaxation=1.5)
    for _ in range(3):
        fast.step()
        slow.step()
    np.testing.assert_allclose(np.asarray(slow.x), np.asarray(fast.x),
                               rtol=0, atol=2e-4)


def test_spmd_rejects_nonreference_iteration():
    from admm_elastic_tpu.parallel.spmd import SpmdSystem

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device virtual mesh")
    from jax.sharding import Mesh

    sys = System(_settings(admm_iters=2, global_solver="ell",
                           relaxation=1.5))
    x = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 1], [1, 0, 0]], dtype=float)
    sys.add_nodes(x, np.ones(4))
    sys.add_force(LinearTetStrain(np.array([[0, 1, 2, 3]]), stiffness=50.0))
    assert sys.initialize()
    mesh = Mesh(np.array(jax.devices()[:2]), ("elem",))
    with pytest.raises(ValueError, match="relaxation"):
        SpmdSystem(sys, mesh)
