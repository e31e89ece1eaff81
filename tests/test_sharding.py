"""Sharded execution on the 8-device virtual CPU mesh: element sharding must
reproduce single-device trajectories exactly, and scenario batching must
match per-scenario sequential runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_elastic_tpu import Settings, System
from admm_elastic_tpu.geometry import make_beam_tets
from admm_elastic_tpu.models import ExplicitForce, LinearTetStrain, StaticAnchor
from admm_elastic_tpu.parallel import (
    batch_state,
    make_sim_mesh,
    pad_batches,
    shard_params_and_state,
    vmap_step,
)
from admm_elastic_tpu.parallel.scenarios import batch_params


def _build(mode="cg"):
    beam = make_beam_tets(4, 2, 2)
    sys = System(
        Settings(
            timestep_s=0.04,
            admm_iters=8,
            verbose=0,
            dtype=jnp.float64,
            global_solver=mode,
            cg_tol=1e-12,
            cg_max_iters=400,
        )
    )
    n = beam.n_vertices
    sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    # anchor one end face
    anchored = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
    sys.add_force(StaticAnchor(anchored))
    sys.add_force(LinearTetStrain(beam.tets, stiffness=200.0))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    return sys


def test_padding_is_noop():
    a = _build()
    b = _build()
    pad_batches(b, 8)
    for _ in range(5):
        a.step()
        b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=1e-12, atol=1e-12)


def test_element_sharding_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest must set 8 virtual devices"
    a = _build()
    for _ in range(5):
        a.step()

    b = _build()
    mesh = make_sim_mesh(data=1)  # (1, 8)
    shard_params_and_state(b, mesh)
    for _ in range(5):
        b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=1e-9, atol=1e-10)
    # confirm the element arrays really are sharded
    name = b._force_list[1].name
    sh = b.params[name]["coeff"].sharding
    assert sh.spec[0] == "elem"


def test_scenario_batching_matches_sequential():
    sys = _build()
    state0 = sys.state
    params = sys.params
    step = vmap_step(sys)

    n_sc = 4
    stiffness = np.linspace(100.0, 400.0, n_sc)
    E = sys._force_list[1].n_elements
    sweep = {
        (sys._force_list[1].name, "weight"): np.stack(
            [np.full(E, np.sqrt(s)) for s in stiffness]
        )
    }
    # weight = sqrt(k * vol); rebuild exactly as scenario-specific systems do
    import copy

    vols = np.asarray(params[sys._force_list[1].name]["k"]) / 200.0
    sweep[(sys._force_list[1].name, "weight")] = np.stack(
        [np.sqrt(s * vols) for s in stiffness]
    )
    sweep[(sys._force_list[1].name, "k")] = np.stack(
        [s * vols for s in stiffness]
    )

    bstate = batch_state(state0, n_sc)
    bparams = batch_params(params, sweep, n_sc)
    for _ in range(3):
        bstate, _ = step(bstate, bparams)
    batched_x = np.asarray(bstate["x"])

    # sequential runs with per-scenario stiffness
    for i, s in enumerate(stiffness):
        beam = make_beam_tets(4, 2, 2)
        ss = System(
            Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                     dtype=jnp.float64, global_solver="cg", cg_tol=1e-12,
                     cg_max_iters=400)
        )
        n = beam.n_vertices
        ss.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        anchored = np.flatnonzero(beam.vertices[:, 0] < 1e-9)
        ss.add_force(StaticAnchor(anchored))
        ss.add_force(LinearTetStrain(beam.tets, stiffness=float(s)))
        ss.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        ss.initialize()
        for _ in range(3):
            ss.step()
        np.testing.assert_allclose(batched_x[i], ss.x, rtol=1e-8, atol=1e-9,
                                   err_msg=f"scenario {i} stiffness {s}")


def test_scenario_and_element_sharding_compose():
    """2D mesh: 2 scenario shards x 4 element shards."""
    sys = _build()
    mesh = make_sim_mesh(data=2)  # (2,4)
    shard_params_and_state(sys, mesh, elem_axis="elem")
    step = vmap_step(sys)
    bstate = batch_state(sys.state, 2, mesh=mesh)
    bparams = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (2,) + a.shape), sys.params
    )
    bstate, _ = step(bstate, bparams)
    x = np.asarray(bstate["x"])
    assert x.shape[0] == 2
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x[0], x[1], rtol=1e-12, atol=1e-12)


def test_sweep_guard_rejects_precomputed_matrix_modes():
    """Weight sweeps must be rejected when the global matrix is precomputed."""
    sys = _build(mode="ell")
    name = sys._force_list[1].name
    E = sys._force_list[1].n_elements
    sweep = {(name, "weight"): np.ones((2, E))}
    with pytest.raises(ValueError, match="matrix-free"):
        batch_params(sys.params, sweep, 2)


def test_scenario_sweep_with_precomputed_solver():
    """Passing the system to batch_params re-assembles the ell/dia global
    matrix per scenario, so stiffness sweeps work with the precomputed-matrix
    (single-kernel CG) modes and match sequential per-scenario runs."""

    def build_seq(stiffness, mode):
        beam = make_beam_tets(4, 2, 2)
        ss = System(
            Settings(timestep_s=0.04, admm_iters=8, verbose=0,
                     dtype=jnp.float64, global_solver=mode,
                     cg_fixed_iters=80)
        )
        n = beam.n_vertices
        ss.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        ss.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        ss.add_force(LinearTetStrain(beam.tets, stiffness=stiffness))
        ss.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        ss.initialize()
        return ss

    stiffness = np.array([150.0, 420.0])
    for mode in ("dia", "ell"):
        sys = build_seq(200.0, mode)
        assert sys._solver_mode == mode
        name = sys._force_list[1].name
        vols = np.asarray(sys.params[name]["k"]) / 200.0
        sweep = {
            (name, "weight"): np.stack([np.sqrt(s * vols) for s in stiffness]),
            (name, "k"): np.stack([s * vols for s in stiffness]),
        }
        bstate = batch_state(sys.state, 2)
        bparams = batch_params(sys.params, sweep, 2, system=sys)
        step = vmap_step(sys)
        for _ in range(3):
            bstate, _ = step(bstate, bparams)
        for i, s in enumerate(stiffness):
            ss = build_seq(float(s), mode)
            for _ in range(3):
                ss.step()
            np.testing.assert_allclose(
                np.asarray(bstate["x"])[i], ss.x, rtol=1e-8, atol=1e-9,
                err_msg=f"{mode} scenario {i}",
            )


def test_scenario_sweep_pallas_backend(nh_kernel):
    """Scenario vmap over the fused Pallas local+RHS kernel (interpret
    mode; ell mode with per-scenario re-assembled matrices) matches the
    XLA local step on the cg path."""
    from admm_elastic_tpu.models import HyperElasticTet

    def build(mode):
        beam = make_beam_tets(4, 2, 2)
        ss = System(
            Settings(timestep_s=0.04, admm_iters=6, verbose=0,
                     dtype=jnp.float64, global_solver=mode,
                     cg_fixed_iters=60)
        )
        n = beam.n_vertices
        ss.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        ss.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        ss.add_force(HyperElasticTet(beam.tets, 2e4, 2e4, max_iters=5,
                                     model="nh"))
        ss.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        ss.initialize()
        return ss

    mus = np.array([1e4, 5e4])

    def run(mode):
        ss = build(mode)
        name = ss._force_list[1].name
        E = ss._force_list[1].n_elements
        vols = (np.asarray(ss.params[name]["weight"]) ** 2) / 2e4
        sweep = {
            (name, "mu"): np.repeat(mus[:, None], E, axis=1),
            (name, "lam"): np.repeat(mus[:, None], E, axis=1),
            (name, "k"): np.repeat(mus[:, None], E, axis=1),
            (name, "weight"): np.sqrt(mus[:, None] * vols[None, :]),
        }
        bstate = batch_state(ss.state, 2)
        bparams = batch_params(ss.params, sweep, 2, system=ss)
        step = vmap_step(ss)
        for _ in range(3):
            bstate, _ = step(bstate, bparams)
        return np.asarray(bstate["x"])

    a = run("cg")
    with nh_kernel():
        b = run("ell")
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_ell_sharding_rejected():
    """The GSPMD helper rejects ell mode and points at SpmdSystem."""
    sys = _build(mode="ell")
    mesh = make_sim_mesh(data=1)
    with pytest.raises(ValueError, match="SpmdSystem"):
        shard_params_and_state(sys, mesh)


# ---------------------------------------------------------------- SPMD fast path


def _spmd_pair(beam, admm_iters=4, cg=20, forces="nh", n_dev=8):
    """Build (single-device System, SpmdSystem) with identical config."""
    import jax

    from admm_elastic_tpu.parallel.sharding import make_sim_mesh
    from admm_elastic_tpu.parallel.spmd import SpmdSystem
    from admm_elastic_tpu.models import (
        Collision,
        ExplicitForce,
        Floor,
        HyperElasticTet,
        LinearTetStrain,
        MovingAnchor,
        StaticAnchor,
    )

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=admm_iters, verbose=0,
                            dtype=jnp.float64, global_solver="ell",
                            cg_fixed_iters=cg))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        if forces == "nh":
            s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                        max_iters=5, model="nh"))
        else:  # mixed: ARAP + moving anchor + floor collision
            s.add_force(LinearTetStrain(beam.tets, stiffness=1e5))
            tip = int(np.argmax(beam.vertices[:, 0]))
            s.add_force(MovingAnchor([tip], weight=500.0))
            s.add_force(Collision([Floor(center=(0, -0.5, 0))],
                                  n_nodes=n))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    ref = build()
    spmd = SpmdSystem(build(), make_sim_mesh(elem=n_dev))
    return ref, spmd


def test_spmd_fast_path_mixed_forces():
    """SPMD (fused pallas ARAP + canonical anchors/collision, row-sharded
    ELL CG) matches the single-device trajectory; run() rollout works."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(4, 3, 3)
    ref, spmd = _spmd_pair(beam, forces="mixed")
    for _ in range(2):
        ref.step()
        spmd.step()
    np.testing.assert_allclose(spmd.x, ref.x, atol=1e-10)
    # on-device rollout continues the trajectory
    ref.run(2)
    spmd.run(2)
    np.testing.assert_allclose(spmd.x, ref.x, atol=1e-9)
    stats = spmd.comm_stats()
    assert stats["bytes_per_step"] > 0 and stats["n_devices"] == 8


@pytest.mark.slow
def test_spmd_fast_path_50k_tets():
    """VERDICT round-1 item 1 done-criterion: the pallas+ell fast path,
    element-sharded on the 8-device virtual mesh, matches the single-device
    trajectory on a >=50k-tet mesh."""
    from admm_elastic_tpu.geometry import make_beam_tets

    beam = make_beam_tets(28, 20, 18)  # 50,400 tets / 11,571 nodes
    assert beam.n_tets >= 50_000
    # interpret-mode pallas on 50k f64 tets across 8 virtual devices is
    # minutes per ADMM iteration on a 4-core host — keep the mesh size
    # (the round-1 VERDICT criterion) but run the minimum iteration count
    # that still exercises every phase boundary twice
    ref, spmd = _spmd_pair(beam, admm_iters=2, cg=15, forces="nh")
    for _ in range(1):
        ref.step()
        spmd.step()
    assert np.isfinite(spmd.x).all()
    np.testing.assert_allclose(spmd.x, ref.x, atol=1e-6)


def test_sweep_reassembly_1024_scenarios_fast():
    """The vectorized per-scenario matrix fill sets up a 1024-scenario
    sweep in seconds (was a host-side scipy loop), and matches a direct
    per-scenario assembly."""
    import time

    from admm_elastic_tpu.core.solver import assemble_A_hat_ell
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import (
        ExplicitForce,
        HyperElasticTet,
        StaticAnchor,
    )
    from admm_elastic_tpu.parallel.scenarios import batch_params

    beam = make_beam_tets(6, 4, 4)
    sys = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                          global_solver="ell", cg_fixed_iters=10))
    n = beam.n_vertices
    sys.add_nodes(beam.vertices, np.full(n, 1.0 / n))
    sys.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    het = sys.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                        max_iters=3))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()

    S = 1024
    E = het.n_elements
    mus = np.geomspace(3e4, 3e5, S)
    vols = (np.asarray(sys.params[het.name]["weight"]) ** 2) / 1e5
    sweep = {
        (het.name, "weight"): np.sqrt(mus[:, None] * vols[None, :]),
    }
    t0 = time.perf_counter()
    bp = batch_params(sys.params, sweep, S, system=sys)
    dt_setup = time.perf_counter() - t0
    assert dt_setup < 20.0, f"1024-scenario setup took {dt_setup:.1f}s"

    # spot-check two scenarios against direct assembly
    for i in (0, S - 1):
        cp = {
            name: {k: np.asarray(v) for k, v in sys.params[name].items()}
            for name in sys._constraint_names
        }
        # compare against the post-cast (dtype-rounded) batched weights
        cp[het.name]["weight"] = np.asarray(bp[het.name]["weight"][i])
        _, ell_vals, diag = assemble_A_hat_ell(n, sys._m, 0.04, cp)
        # batched matrices are stored at the settings dtype (f32 here)
        np.testing.assert_allclose(
            np.asarray(bp["_solver"]["ell_vals"][i]), ell_vals,
            rtol=1e-5, atol=1e-7 * np.abs(diag).max(),
        )
        np.testing.assert_allclose(
            np.asarray(bp["_solver"]["diag"][i]), diag, rtol=1e-5
        )


def test_spmd_accepts_dia_mode():
    """A dia-mode (single-kernel CG) system shards through SpmdSystem by
    row-sharded ELL re-assembly of the same matrix — trajectories match."""
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import (
        ExplicitForce,
        HyperElasticTet,
        StaticAnchor,
    )
    from admm_elastic_tpu.parallel.sharding import make_sim_mesh
    from admm_elastic_tpu.parallel.spmd import SpmdSystem

    beam = make_beam_tets(4, 3, 3)

    def build(mode):
        s = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                            dtype=jnp.float64, global_solver=mode,
                            cg_fixed_iters=25))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 1.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e4, lam=1e4, max_iters=5,
                                    model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    ref = build("dia")
    assert ref._solver_mode == "dia"
    spmd = SpmdSystem(build("dia"), make_sim_mesh(elem=8))
    for _ in range(3):
        ref.step()
        spmd.step()
    np.testing.assert_allclose(spmd.x, ref.x, atol=1e-9)


def test_spmd_residual_collection():
    """Sharded runs are instrumentable since round 3: SpmdSystem with
    collect_residuals=True reports the same per-iteration primal/dual
    residuals as the instrumented single-device general path (local
    pieces + one psum; 6-wide contribution rows for the dual)."""
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import (
        ExplicitForce, HyperElasticTet, StaticAnchor,
    )
    from admm_elastic_tpu.parallel.sharding import make_sim_mesh
    from admm_elastic_tpu.parallel.spmd import SpmdSystem

    beam = make_beam_tets(4, 3, 3)

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=4, verbose=0,
                            dtype=jnp.float64, global_solver="ell",
                            cg_fixed_iters=20, collect_residuals=True))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5,
                                    max_iters=5, model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    ref = build()
    spmd = SpmdSystem(build(), make_sim_mesh(elem=8))
    for _ in range(3):
        ref.step()
        spmd.step()
        for key in ("primal_residual", "dual_residual"):
            np.testing.assert_allclose(
                np.asarray(spmd.last_aux[key]),
                np.asarray(ref.last_aux[key]),
                rtol=1e-5, atol=1e-9, err_msg=key)
    # 6-wide contribution sums reorder vs the single-device path; the
    # Newton ladder's discrete branches amplify the 1-ulp differences
    # to ~1e-10 over steps (same caveat as test_banded_single_iteration)
    np.testing.assert_allclose(spmd.x, ref.x, atol=1e-8)
    # rollout stacks per-step aux
    spmd.run(2)
    assert np.asarray(spmd.last_aux["primal_residual"]).shape == (2, 4)
