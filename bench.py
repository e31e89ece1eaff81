"""Benchmark harness. Prints one JSON line per measured config; the LAST
line is the primary metric:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "spread": [min, max], "vs_baseline_spread": [lo, hi], "device": {...}}

`value` is the MEDIAN over >=4 independent timing windows, each ending in
`block_until_ready`, and `spread` the measured [min, max] band over those
windows. Every row names the device it ran on: platform, device_kind, the
device count and the card's power limit (nvidia-smi).

Primary workload (BASELINE.md): ms/timestep on a 100k-tet NeoHookean mesh at
the reference solver settings (10 ADMM iterations, 5 local iterations,
dt=0.04), at a global-solve budget MATCHED to the reference's exact
prefactored LDLT (System.cpp:140; cg75, f64 CPU budget study, PERF.md).
The default run also emits the unmatched cg25 speed row alongside.
`vs_baseline` is the speedup over the single-thread C++ reference solver on
the same workload (bench_baseline.json: timings of the reference library
on a 4-core host, tools/bench_reference.sh).

Needs a GPU: without one it exits non-zero. Usage: python bench.py
[--preset tet100k|banded100k|delaunay100k|cloth100k|windyflag|dillo|bunny|
 plinko|sweep64|sharded|sharded_banded|sharded_cloth|sharded_halo|
 sharded_delaunay]
[--steps N] [--amg] [--lattice] [--cg-iters N]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Reference C++ single-thread baseline for the same workload, measured on this
# machine by tools/bench_reference.sh. Fallback estimate if never measured.
_BASELINE_FILE = os.path.join(HERE, "bench_baseline.json")


def _load_baseline():
    if os.path.exists(_BASELINE_FILE):
        with open(_BASELINE_FILE) as f:
            return json.load(f)
    return None


def build_tet100k(dtype, admm_iters=10, global_solver="dia", lattice=False,
                  scramble=False, residuals=False, jitter=0.0, cg_iters=None):
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor

    # 40 x 25 x 20 cells x 5 tets = 100,000 tets; 22,386 nodes
    beam = make_beam_tets(40, 25, 20, size=0.05)
    verts, tets = beam.vertices, beam.tets
    anchored = np.flatnonzero(verts[:, 0] < 1e-9)
    if jitter:
        # perturb positions: the mesh is no longer a grid (no
        # constant-offset stencils, detect_grid_numbering rejects it) while the
        # numbering stays banded -> exercises the banded layout
        # (core/banded.py) on genuinely unstructured geometry
        rng = np.random.default_rng(1)
        verts = verts + jitter * 0.05 * rng.standard_normal(verts.shape)
    if scramble:
        # adversarial vertex numbering: exercises detect_grid_numbering
        # (dia renumbering) instead of the canonical ordering
        rng = np.random.default_rng(0)
        perm = rng.permutation(beam.n_vertices)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        verts, tets = verts[perm], inv[tets]
    settings = Settings(
        timestep_s=0.04,
        admm_iters=admm_iters,
        verbose=0,
        dtype=dtype,
        global_solver=global_solver,
        # fixed 25-iteration CG budget: converges each step's primal
        # residual to ~0.1% of its start. NOT exact-solve-matched at this
        # scale (the floor grows with mesh diameter — worst ratio 13.5x vs
        # a 1e-13 solve, f64 CPU budget study, PERF.md); matched: cg75
        # (ratio 1.022 worst over 8 f64 steps at full scale)
        cg_fixed_iters=cg_iters if cg_iters else 25,
        # whole-timestep banded layout via the plain System API
        lattice_fast_path=lattice,
        # per-iteration primal/dual residual collection
        collect_residuals=residuals,
    )
    if global_solver == "dense":
        # n=22,386: A_hat^{-1} is 2 GB f32 in device memory; each global
        # step is one matmul. Host inversion is a one-time init cost.
        settings.dense_max_nodes = 1 << 30
    sys = System(settings)
    n = beam.n_vertices
    sys.add_nodes(verts, np.full(n, 50.0 / n))
    if scramble:
        anchored = inv[anchored]
    sys.add_force(StaticAnchor(anchored))
    sys.add_force(
        HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5, model="nh")
    )
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    if lattice:
        assert sys._lattice is not None, "banded layout did not engage"
    return sys, beam.n_tets


def build_delaunay100k(dtype, admm_iters=10, fast_path=False, amg=False,
                       cg_iters=None, residuals=False):
    """Genuinely UNSTRUCTURED workload: ~100k-tet Delaunay
    tetrahedralization of jittered grid points. A_hat has thousands of
    distinct diagonals in any numbering — no lattice stencil, no dia
    form, no grid renumbering applies. Default config: the general ELL
    path; amg=True adds the aggregation-AMG preconditioner (core/amg.py);
    fast_path=True the banded layout with the per-row-offset ELL matvec
    (core/uell.py)."""
    import jax.numpy as jnp
    from scipy.spatial import Delaunay

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor

    rng = np.random.default_rng(0)
    nx, ny, nz = 37, 22, 20
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny),
                             np.arange(nz), indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    pts *= 0.05
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(pp[:, :, None, :] - pp[:, None, :, :],
                          axis=-1).max(axis=(1, 2))
    tets = tets[emax < 0.11]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]
    n = len(pts)

    settings = Settings(
        timestep_s=0.04, admm_iters=admm_iters, verbose=1, dtype=dtype,
        global_solver="ell",
        # amg: 8 fixed AMG-PCG iterations (tools/residual_match.py --amg
        # --delaunay, f64 CPU)
        cg_fixed_iters=cg_iters if cg_iters else (8 if amg else 25),
        preconditioner="amg" if amg else "jacobi",
        lattice_fast_path=fast_path,
        collect_residuals=residuals,
    )
    sys = System(settings)
    sys.add_nodes(pts, np.full(n, 50.0 / n))
    sys.add_force(StaticAnchor(
        np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 0.5 * 0.05)
    ))
    sys.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5,
                                  model="nh"))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys.initialize()
    if fast_path:
        assert sys._lattice is not None and sys._lattice.base._uell is not None, (
            "delaunay100k must route onto the banded layout (uell matvec)")
    return sys, len(tets)


def build_cloth100k(dtype, admm_iters=10, fast_path=False, residuals=False,
                    cg_iters=None):
    """Large-cloth workload: ~100k triangle-strain elements + bend hinges
    (windyflag physics at production scale). Default config: the general
    path (dia CG); fast_path=True the grid-cloth layout (core/cloth.py,
    parallel/cloth_spmd.py)."""
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import extract_hinges
    from admm_elastic_tpu.models import (
        Bend,
        ExplicitForce,
        LimitedTriangleStrain,
        StaticAnchor,
        WindForce,
    )

    from admm_elastic_tpu.geometry import make_plane_grid

    # regular-grid cloth (no center vertices): A_hat collapses onto ~9
    # constant diagonals (dia matvec; the sym_plane layout forces ELL
    # gather matvecs)
    mesh = make_plane_grid(225, 225)  # 101,250 tris / 51,076 verts
    n = mesh.n_vertices
    sys = System(Settings(
        timestep_s=0.04, admm_iters=admm_iters, verbose=0, dtype=dtype,
        global_solver="dia",
        cg_fixed_iters=(cg_iters or 25),
        lattice_fast_path=fast_path,
        collect_residuals=bool(residuals),
    ))
    sys.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
    sys.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
    sys.add_force(Bend(extract_hinges(mesh.faces), 20.0))
    top = np.flatnonzero(np.abs(mesh.vertices[:, 1]
                                - mesh.vertices[:, 1].max()) < 1e-9)
    sys.add_force(StaticAnchor(top[:: max(1, len(top) // 24)]))
    sys.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    sys.add_explicit_force(WindForce(mesh.faces, direction=(4.0, 0.0, 1.0)))
    assert sys.initialize()
    if fast_path:
        assert sys._lattice is not None, "cloth layout did not engage"
    return sys, len(mesh.faces)


def build_scene_preset(name, dtype):
    """The bundled-scene workloads, constructed to mirror the C++ baseline
    drivers exactly (tools/bench_reference_dillo.cpp,
    tools/bench_reference_scenes.cpp) so <name>_ms_per_step in
    bench_baseline.json is apples-to-apples:
      dillo:  dillo919 *0.01, uniform mass 140, top-8 anchors, NH
              mu=lam=1e5 (5 local iters), gravity, dt=0.06, 10 iters
      bunny:  bunny_1124 at rest, uniform mass 1, StVK mu=lam=100
              (5 local iters), gravity, dt=0.04, 10 iters
      plinko: horse759 *1.4 +(0,6,0), uniform mass 2, LinearTetStrain
              k=1e5, 23 collision cylinders, gravity, dt=0.04, 13 iters
    """
    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import load_node_ele
    from admm_elastic_tpu.models import (
        Collision,
        Cylinder,
        ExplicitForce,
        HyperElasticTet,
        LinearTetStrain,
        StaticAnchor,
    )

    cfg = {
        "dillo": ("poordillo/dillo919", 0.06, 10),
        "bunny": ("bunnyexpand/bunny_1124", 0.04, 10),
        "plinko": ("plinkopony/horse759", 0.04, 13),
    }[name]
    rel, dt, iters = cfg
    path = os.path.join("/root/reference/samples", rel)
    if not os.path.exists(path + ".node"):
        raise SystemExit(f"reference mesh {path}.node not found")
    mesh = load_node_ele(path)
    verts, tets = mesh.vertices, mesh.tets
    n = len(verts)

    sys_ = System(Settings(timestep_s=dt, admm_iters=iters, verbose=0,
                           dtype=dtype))
    if name == "dillo":
        sys_.add_nodes(verts * 0.01, np.full(n, 140.0 / n))
        sys_.add_force(StaticAnchor(np.argsort(verts[:, 1])[-8:]))
        sys_.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5,
                                       model="nh"))
    elif name == "bunny":
        sys_.add_nodes(verts, np.full(n, 1.0 / n))
        sys_.add_force(HyperElasticTet(tets, mu=100.0, lam=100.0,
                                       max_iters=5, model="stvk"))
    else:  # plinko
        sys_.add_nodes(verts * 1.4 + np.array([0.0, 6.0, 0.0]),
                       np.full(n, 2.0 / n))
        sys_.add_force(LinearTetStrain(tets, stiffness=1e5))
        pegs = []
        for row in range(5):
            y = 0.5 + row * 1.5
            xs = ([-3.0, -1.5, 0.0, 1.5, 3.0] if row % 2 == 0
                  else [-2.25, -0.75, 0.75, 2.25])
            pegs += [(x, y) for x in xs]
        shapes = [Cylinder(center=(px, py, 0.0), radius=0.4)
                  for px, py in pegs[:23]]
        sys_.add_force(Collision(shapes, n_nodes=n))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()
    return sys_, len(tets)


def bench_system(sys, steps, warmup=3, rollout=True, windows=4):
    """(median, min, max) seconds/step over `windows` independent timing
    windows. rollout=True times an on-device lax.scan of `steps` timesteps
    per window (production shape: one dispatch for the whole window);
    rollout=False times individual step() dispatches (each window =
    `steps` dispatches). The JSON rows publish the measured [min, max]
    band over the windows."""
    import jax

    def sync():
        # with a whole-mesh layout engaged the live device buffer is the
        # stepper's plane-layout state, not System.state
        lat = getattr(sys, "_lattice", None)
        jax.block_until_ready(lat.state["x"] if lat is not None
                              else sys.state["x"])

    reps = []
    if rollout:
        sys.run(2)  # compile + warm caches
        sync()
        for _ in range(windows):
            t0 = time.perf_counter()
            sys.run(steps)
            sync()
            reps.append((time.perf_counter() - t0) / steps)
    else:
        for i in range(warmup):
            sys.step()
        sync()
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                sys.step()
            sync()
            reps.append((time.perf_counter() - t0) / steps)
    assert np.isfinite(sys.x).all(), "benchmark simulation diverged"
    return float(np.median(reps)), float(min(reps)), float(max(reps))


def device_info():
    """The device every row was measured on; fails without a GPU."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "power_limit": smi.split(",")[-1].strip()}


DEVICE = None


def emit(metric, ms, base_ms=None, spread_ms=None, unit="ms", **extra):
    """One JSON result line. `spread_ms` = (min, max) over the timing
    windows; `vs_baseline` carries its own band when a spread exists."""
    row = {"metric": metric,
           "value": round(ms, 3) if unit == "ms" else ms,
           "unit": unit,
           "vs_baseline": round(base_ms / ms, 2) if base_ms else 1.0}
    if spread_ms is not None:
        lo, hi = spread_ms
        row["spread"] = [round(lo, 3), round(hi, 3)]
        if base_ms:
            row["vs_baseline_spread"] = [round(base_ms / hi, 2),
                                         round(base_ms / lo, 2)]
    row.update(extra)
    row["device"] = DEVICE
    print(json.dumps(row))


def build_windyflag(dtype):
    """The real windyflag scene (1251 nodes, 2400 tris, 30 iters)."""
    from admm_elastic_tpu.models import StaticAnchor, WindForce
    from admm_elastic_tpu.scene import SimContext
    import jax.numpy as jnp

    ctx = SimContext()
    ctx.load(os.path.join(HERE, "samples", "scenes", "cloth.xml"))
    ctx.system.settings.dtype = dtype
    ctx.system.settings.global_solver = "dia"
    cloth = ctx.objects_map["cloth1"]
    length = cloth.component.get("length").as_int()
    ctx.system.add_force(
        StaticAnchor([cloth.index_offset, cloth.index_offset + length])
    )
    ctx.system.add_explicit_force(
        WindForce(cloth.faces + cloth.index_offset, direction=(10.0, 0, 2.0))
    )
    ctx.initialize()
    return ctx.system


def bench_sweep(dtype, n_scenarios=64, steps=10, global_solver="ell"):
    """Scenario-batch sweep: n parallel hyperelastic drops with varied
    stiffness (the BASELINE '64 parallel armadillo drops' workload), one
    vmapped step over the scenario axis (parallel/scenarios.vmap_step).
    global_solver: 'cg' (matrix-free) or 'ell' (per-scenario re-assembled
    precomputed matrix; batch_params(..., system=) handles the weight
    sweep). The armadillo mesh is not in the repository; a 10x8x7 beam
    of similar size stands in."""
    import jax

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor
    from admm_elastic_tpu.parallel.scenarios import batch_params, batch_state, vmap_step

    beam = make_beam_tets(10, 8, 7, size=0.1)
    verts, tets = beam.vertices, beam.tets

    sys_ = System(
        Settings(timestep_s=0.06, admm_iters=10, verbose=0, dtype=dtype,
                 global_solver=global_solver, cg_fixed_iters=12)
    )
    n = len(verts)
    sys_.add_nodes(verts, np.full(n, 140.0 / n))
    anchored = np.argsort(verts[:, 1])[-8:]  # hang from top verts
    sys_.add_force(StaticAnchor(anchored))
    het = sys_.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5))
    sys_.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert sys_.initialize()

    mus = np.geomspace(3e4, 3e5, n_scenarios)
    E = het.n_elements
    vols = (np.asarray(sys_.params[het.name]["weight"]) ** 2) / 1e5
    sweep = {
        (het.name, "mu"): np.repeat(mus[:, None], E, axis=1),
        (het.name, "lam"): np.repeat(mus[:, None], E, axis=1),
        (het.name, "k"): np.repeat(mus[:, None], E, axis=1),
        (het.name, "weight"): np.sqrt(mus[:, None] * vols[None, :]),
    }
    step = vmap_step(sys_)
    bstate = batch_state(sys_.state, n_scenarios)
    bparams = batch_params(sys_.params, sweep, n_scenarios, system=sys_)

    # warmup + timed
    bstate, _ = step(bstate, bparams)
    jax.block_until_ready(bstate["x"])
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        bstate, _ = step(bstate, bparams)
        jax.block_until_ready(bstate["x"])
        times.append(time.perf_counter() - t0)
    assert np.isfinite(np.asarray(bstate["x"])).all()
    return ((float(np.median(times)), float(min(times)),
             float(max(times))), n_scenarios, E)


def bench_sharded(dtype, n_dev, steps=3):
    """The SPMD path (per-shard local step + row-sharded ELL CG under
    shard_map): trajectory parity against the single-device path and the
    analytic cross-device traffic per step."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor
    from admm_elastic_tpu.parallel.sharding import make_sim_mesh
    from admm_elastic_tpu.parallel.spmd import SpmdSystem

    beam = make_beam_tets(6, 4, 4)

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=dtype, global_solver="ell",
                            cg_fixed_iters=25))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                    model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    ref = build()
    spmd = SpmdSystem(build(), make_sim_mesh(elem=n_dev))
    for _ in range(steps):
        ref.step()
        spmd.step()
    err = float(np.abs(spmd.x - ref.x).max())
    scale = float(np.abs(ref.x).max())
    assert err < 1e-3 * scale, f"sharded parity failed: {err}"
    return spmd.comm_stats(), err, beam.n_tets


def bench_sharded_banded(dtype, n_dev, steps=3):
    """The sharded BANDED whole-timestep layout: trajectory parity vs its
    D=1 instance (itself parity-tested against the general path in
    tests/test_banded.py) and the analytic boundary-halo traffic —
    O(band width) per CG iteration, independent of mesh size."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor
    from admm_elastic_tpu.parallel.banded_spmd import (
        sharded_banded_from_system,
    )

    beam = make_beam_tets(12, 9, 8)

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=dtype, global_solver="dia",
                            cg_fixed_iters=25))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                    model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    import jax

    s1, _ = sharded_banded_from_system(
        build(), jax.make_mesh((1,), ("elem",)))
    s8, _ = sharded_banded_from_system(
        build(), jax.make_mesh((n_dev,), ("elem",)))
    for _ in range(steps):
        s1.step()
        s8.step()
    err = float(np.abs(s8.x - s1.x).max())
    scale = float(np.abs(s1.x).max())
    assert err < 1e-3 * scale, f"sharded banded parity failed: {err}"
    return s8.comm_stats(), err, beam.n_tets


def bench_sharded_halo(dtype, n_dev, steps=3):
    """Boundary-halo O(cut) sharding (parallel/halo_spmd.py): trajectory
    parity vs the single-device general path, analytic + measured-HLO
    comm volume. The headline number is bytes/CG-iteration — O(cut),
    independent of mesh size (VERDICT r3 #2)."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import ExplicitForce, HyperElasticTet, StaticAnchor
    from admm_elastic_tpu.parallel.comm import assert_no_fat_collectives
    from admm_elastic_tpu.parallel.halo_spmd import HaloSpmdSystem

    beam = make_beam_tets(24, 9, 8)

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=dtype, global_solver="ell",
                            cg_fixed_iters=25))
        n = beam.n_vertices
        s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
        s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                    model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize()
        return s

    ref = build()
    halo = HaloSpmdSystem(build(), jax.make_mesh((n_dev,), ("elem",)))
    for _ in range(steps):
        ref.step()
        halo.step()
    err = float(np.abs(halo.x - np.asarray(ref.state["x"])).max())
    scale = float(np.abs(np.asarray(ref.state["x"])).max())
    assert err < 1e-3 * max(scale, 1.0), f"halo parity failed: {err}"
    stats = halo.comm_stats()
    assert_no_fat_collectives(
        halo.measured_comm(),
        max(stats["exchange_rows"] * 3 * 8 * 2, 4096),
    )
    return stats, err, beam.n_tets


def bench_sharded_delaunay(dtype, n_dev, steps=3):
    """Sharded ARBITRARY topology (round 5): the uell per-row-offset
    ELL matvec on the slab seam — D=8 vs D=1 of the same decomposition
    on a Delaunay tetrahedralization, plus the O(reach) comm volume and
    the measured-HLO audit."""
    import jax

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.models import (
        ExplicitForce, HyperElasticTet, StaticAnchor)
    from admm_elastic_tpu.parallel.banded_spmd import (
        sharded_banded_from_system,
    )
    from admm_elastic_tpu.parallel.comm import assert_no_fat_collectives
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    gx, gy, gz = np.meshgrid(np.arange(16), np.arange(11),
                             np.arange(10), indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    pts += rng.uniform(-0.3, 0.3, pts.shape)
    pts *= 0.05
    tets = Delaunay(pts).simplices
    pp = pts[tets]
    emax = np.linalg.norm(pp[:, :, None, :] - pp[:, None, :, :],
                          axis=-1).max(axis=(1, 2))
    tets = tets[emax < 0.11]
    v6 = np.linalg.det(pts[tets][:, 1:] - pts[tets][:, :1])
    tets[v6 < 0] = tets[v6 < 0][:, [0, 2, 1, 3]]

    def build():
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=dtype, global_solver="ell",
                            cg_fixed_iters=25, lattice_fast_path=True))
        n = len(pts)
        s.add_nodes(pts, np.full(n, 50.0 / n))
        s.add_force(StaticAnchor(
            np.flatnonzero(pts[:, 0] < pts[:, 0].min() + 0.025)))
        s.add_force(HyperElasticTet(tets, mu=1e5, lam=1e5, max_iters=5,
                                    model="nh"))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        assert s.initialize() and s._lattice is not None
        assert s._lattice.base._uell is not None, "expected the uell matvec"
        return s

    s1, _ = sharded_banded_from_system(
        build(), jax.make_mesh((1,), ("elem",)))
    s8, _ = sharded_banded_from_system(
        build(), jax.make_mesh((n_dev,), ("elem",)))
    for _ in range(steps):
        s1.step()
        s8.step()
    err = float(np.abs(s8.x - s1.x).max())
    scale = max(float(np.abs(s1.x).max()), 1.0)
    assert err < 1e-3 * scale, f"sharded uell parity failed: {err}"
    stats = s8.comm_stats()
    limit = max(stats["halo_rows"] * 128 * 3 * 8 * 4, 65536)
    assert_no_fat_collectives(s8.measured_comm(), limit)
    return stats, err, len(tets)


def bench_sharded_cloth(dtype, n_dev, steps=3):
    """The sharded CLOTH whole-timestep layout: D devices vs D=1 of the
    same decomposition (full windyflag physics), plus the O(halo-lanes)
    comm volume."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import extract_hinges, make_sym_plane
    from admm_elastic_tpu.models import (
        Bend, ExplicitForce, LimitedTriangleStrain, StaticAnchor, WindForce,
    )
    from admm_elastic_tpu.parallel.cloth_spmd import (
        ShardedClothStepper, sharded_cloth_from_system,
    )

    mesh = make_sym_plane(40, 30)

    def build():
        n = mesh.n_vertices
        s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                            dtype=dtype, global_solver="dia",
                            cg_fixed_iters=25, lattice_fast_path=True))
        s.add_nodes(mesh.vertices, np.full(n, 0.5 / n))
        s.add_force(LimitedTriangleStrain(mesh.faces, 100.0, 0.95, 1.05))
        s.add_force(Bend(extract_hinges(mesh.faces), 20.0))
        s.add_force(StaticAnchor([0, 30]))
        s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
        s.add_explicit_force(WindForce(mesh.faces, direction=(1.5, 0, .4)))
        assert s.initialize() and s._lattice is not None
        return s

    import jax

    s1 = ShardedClothStepper(build()._lattice.base,
                             jax.make_mesh((1,), ("elem",)))
    s8, _ = sharded_cloth_from_system(build(), jax.make_mesh((n_dev,), ("elem",)))
    for _ in range(steps):
        s1.step()
        s8.step()
    err = float(np.abs(s8.x - s1.x).max())
    scale = max(float(np.abs(s1.x).max()), 1.0)
    assert err < 1e-3 * scale, f"sharded cloth parity failed: {err}"
    return s8.comm_stats(), err, mesh.n_faces


def main():
    global DEVICE
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tet100k")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--global-solver", default="dia",
                    choices=["ell", "cg", "dense", "dia"])
    ap.add_argument("--lattice", action="store_true",
                    help="tet100k/banded100k/cloth100k: step through the "
                         "whole-mesh XLA layout (Settings.lattice_fast_path) "
                         "instead of the general path")
    ap.add_argument("--residuals", action="store_true",
                    help="tet100k: collect per-iteration ADMM residuals")
    ap.add_argument("--scenarios", type=int, default=64,
                    help="sweep64: number of sweep scenarios")
    ap.add_argument("--scramble", action="store_true",
                    help="tet100k: randomly renumber the mesh vertices "
                         "(exercises the grid renumbering)")
    ap.add_argument("--cg-iters", type=int, default=None,
                    help="override the fixed CG budget")
    ap.add_argument("--amg", action="store_true",
                    help="delaunay100k/tet100k: the aggregation-AMG "
                         "preconditioner (core/amg.py) at 8 fixed PCG "
                         "iterations")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    DEVICE = device_info()
    if args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float32 if args.dtype == "f32" else jnp.float64
    print(f"# device: {DEVICE}", file=sys.stderr)

    def report(name, sys_, n_elem, metric, base_ms):
        ms, lo, hi = (v * 1e3 for v in bench_system(sys_, args.steps))
        print(f"# {name}: {n_elem} elements, {ms:.2f} ms/step "
              f"[{lo:.2f}, {hi:.2f}]", file=sys.stderr)
        emit(metric, ms, base_ms, (lo, hi))

    baseline = _load_baseline() or {}
    if args.preset in ("tet100k", "banded100k"):
        jitter = 0.02 if args.preset == "banded100k" else 0.0
        base_metric = ("ms_per_timestep_100k_tet_nh"
                       if args.preset == "tet100k"
                       else "ms_per_timestep_100k_tet_nh_unstructured")
        base_ms = baseline.get("tet100k_ms_per_step")

        def run_config(cg_iters, metric):
            sys_, n_tets = build_tet100k(
                dtype, global_solver=args.global_solver,
                lattice=args.lattice, scramble=args.scramble,
                residuals=args.residuals, jitter=jitter, cg_iters=cg_iters)
            if args.amg:
                raise SystemExit("--amg: use --preset delaunay100k")
            report(f"{args.preset}[{metric.rsplit('_', 1)[-1]}]", sys_,
                   n_tets, metric, base_ms)

        if args.cg_iters is None:
            # the unmatched cg25 speed row first, then the exact-solve
            # MATCHED cg75 budget (f64 CPU budget study, PERF.md) as the
            # primary metric on the LAST line
            run_config(25, base_metric + "_unmatched")
            run_config(75, base_metric)
        else:
            run_config(args.cg_iters, base_metric)
    elif args.preset == "cloth100k":
        sys_, n_tris = build_cloth100k(dtype, fast_path=args.lattice,
                                       residuals=args.residuals,
                                       cg_iters=args.cg_iters)
        report("cloth100k", sys_, n_tris, "ms_per_timestep_100k_tri_cloth",
               baseline.get("cloth100k_ms_per_step"))
    elif args.preset == "delaunay100k":
        # the measured C++ reference number is for the lattice-beam
        # 100k-tet workload; same element count/materials/iterations
        base_ms = baseline.get("tet100k_ms_per_step")
        metric = "ms_per_timestep_100k_tet_nh_delaunay"
        if args.cg_iters is None and not args.amg:
            # the unmatched Jacobi cg25 row, then the MATCHED AMG-PCG
            # (8 fixed iterations, f64 CPU study) as the LAST line
            sys_, n_tets = build_delaunay100k(dtype, fast_path=args.lattice)
            report("delaunay100k[jacobi]", sys_, n_tets,
                   metric + "_unmatched", base_ms)
            del sys_
            sys_, n_tets = build_delaunay100k(dtype, amg=True)
            report("delaunay100k[amg]", sys_, n_tets, metric, base_ms)
        else:
            sys_, n_tets = build_delaunay100k(dtype, fast_path=args.lattice,
                                              amg=args.amg,
                                              cg_iters=args.cg_iters)
            report("delaunay100k", sys_, n_tets, metric, base_ms)
    elif args.preset == "windyflag":
        sys_ = build_windyflag(dtype)
        report("windyflag", sys_, sys_.n_nodes, "ms_per_timestep_windyflag",
               baseline.get("windyflag_ms_per_step"))
    elif args.preset in ("dillo", "bunny", "plinko"):
        sys_, n_tets = build_scene_preset(args.preset, dtype)
        report(args.preset, sys_, n_tets, f"ms_per_timestep_{args.preset}",
               baseline.get(f"{args.preset}_ms_per_step"))
    elif args.preset == "sweep64":
        solver = args.global_solver if args.global_solver in ("cg", "ell") else "ell"
        (s_med, s_lo, s_hi), n_sc, E = bench_sweep(
            dtype, n_scenarios=args.scenarios, steps=args.steps,
            global_solver=solver)
        ms, lo, hi = s_med * 1e3, s_lo * 1e3, s_hi * 1e3
        print(f"# sweep: {n_sc} scenarios x {E} tets, {ms:.2f} ms/step "
              f"total [{lo:.2f}, {hi:.2f}]", file=sys.stderr)
        # the reference has no batch facility and its armadillo mesh is
        # not in the repository: no baseline for the stand-in beam
        emit(f"ms_per_timestep_{n_sc}scenario_sweep", ms, None, (lo, hi))
    elif args.preset in ("sharded", "sharded_banded", "sharded_halo",
                         "sharded_cloth", "sharded_delaunay"):
        n_dev = len(jax.devices())
        if n_dev < 2:
            raise SystemExit(f"--preset {args.preset} needs at least 2 "
                             f"devices, found {n_dev}")
        fn = {"sharded": bench_sharded,
              "sharded_banded": bench_sharded_banded,
              "sharded_halo": bench_sharded_halo,
              "sharded_cloth": bench_sharded_cloth,
              "sharded_delaunay": bench_sharded_delaunay}[args.preset]
        stats, err, n_elem = fn(dtype, n_dev)
        print(f"# {args.preset}: {n_elem} elements on {n_dev} devices, "
              f"parity err {err:.2e}, {stats['bytes_per_cg_iter']} comm "
              "bytes/CG iter", file=sys.stderr)
        emit(f"{args.preset}_comm_bytes_per_step", stats["bytes_per_step"],
             unit="bytes", parity_err=err)
    else:
        raise SystemExit(f"unknown preset {args.preset}")


if __name__ == "__main__":
    main()
