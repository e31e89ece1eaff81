"""Smoke test of the simulator on NVIDIA GPUs.

Drives the main paths once through the entry points a user calls, at the
sizes the repository treats as real, compares every translated path with
its reference, and prints one JSON object as the last line of stdout:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

    python chip_smoke.py           # one GPU: phases 1-7 below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

Phases on one GPU, all in this process (f32 phases first, then float64):
  1. tet100k (100,000 NeoHookean tets) through plain System defaults at
     cg25 and cg75, run() and step(); f32 against f64 after 10 steps
  2. the Pallas (Triton) NH/StVK local-step kernel against its XLA form
     at 100,000 elements in f64, and both forms in f32 against f64;
     the dense global solve in f32 against f64 (the TF32 guard)
  3. delaunay100k: ell + the aggregation-AMG preconditioner
  4. cloth100k (225x225 grid, strain + bend + wind) and the windyflag
     scene through the command-line entry point
  5. the whole-mesh layouts (banded tet, grid cloth) against the general
     path on tet100k and its jittered twin (positions after 10 f32
     steps), and on cloth100k (extent over 10 f32 and f64 steps against
     the f64 general path, positions after one f64 step)
  6. f64 trajectory parity against tests/reference_impl.py (windyflag)
  7. the tests marked `gpu`

Any failed check raises, and the script exits non-zero. It exits non-zero
without a result when JAX finds no GPU. The JAX compile cache lives where
JAX_COMPILATION_CACHE_DIR says, else in .jax_cache/ beside this file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

T0 = time.perf_counter()
CARD = None
#: elements of the local-step comparison (phase 2)
LOCAL_E = 100_000


def row(phase, **fields):
    """One JSON result row, tagged with the card it was measured on."""
    print(json.dumps({"phase": phase, "card": CARD, **fields},
                     default=float), flush=True)


def windows_ms(fn, sync, n, windows=4):
    """Median and spread of ms per step over `windows` timed windows of
    n steps each; fn() advances n steps, sync() blocks on the result."""
    ts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) / n * 1e3)
    return float(np.median(ts)), [float(min(ts)), float(max(ts))]


def live_x(s):
    lat = getattr(s, "_lattice", None)
    return lat.state["x"] if lat is not None else s.state["x"]


def peak_bytes():
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def timed_system(s, n=10):
    """Compile + time a System: run() windows, then step() windows.
    Returns a dict of timings (compile counted as set-up)."""
    import jax

    sync = lambda: jax.block_until_ready(live_x(s))  # noqa: E731
    t0 = time.perf_counter()
    s.run(n)
    sync()
    run_setup = time.perf_counter() - t0
    x_run10 = np.asarray(s.x)
    run_ms, run_spread = windows_ms(lambda: s.run(n), sync, n)
    t0 = time.perf_counter()
    s.step()
    sync()
    step_setup = time.perf_counter() - t0

    def steps():
        for _ in range(n):
            s.step()

    step_ms, step_spread = windows_ms(steps, sync, n)
    x = np.asarray(s.x)
    if not np.isfinite(x).all():
        raise AssertionError("non-finite positions")
    return dict(run_compile_s=run_setup, run_ms=run_ms,
                run_spread_ms=run_spread, step_compile_s=step_setup,
                step_ms=step_ms, step_spread_ms=step_spread,
                finite=True), x_run10


def displacement_err(x, ref, x0):
    """max |x - ref| relative to the largest displacement of ref."""
    scale = float(np.abs(ref - x0).max())
    return float(np.abs(x - ref).max()) / max(scale, 1e-30), scale


# ----------------------------------------------------------------- phases

def phase_tet100k(store):
    import jax.numpy as jnp

    import bench

    for cg in (25, 75):
        t0 = time.perf_counter()
        s, n_tets = bench.build_tet100k(jnp.float32, cg_iters=cg)
        build_s = time.perf_counter() - t0
        assert s._solver_mode == "dia", s._solver_mode
        x0 = np.asarray(s.x)
        t, x10 = timed_system(s)
        if cg == 25:
            store["tet100k_x0"] = x0
            store["tet100k_x10_f32"] = x10
        row("tet100k", cg=cg, tets=n_tets, mode=s._solver_mode,
            build_s=build_s, peak_bytes_in_use=peak_bytes(), **t)
        del s


def phase_tet100k_f64(store):
    """f32 (phase 1) against f64 after the same 10 steps from rest."""
    import jax
    import jax.numpy as jnp

    import bench

    s, _ = bench.build_tet100k(jnp.float64, cg_iters=25)
    t0 = time.perf_counter()
    s.run(10)
    jax.block_until_ready(s.state["x"])
    secs = time.perf_counter() - t0
    x64 = np.asarray(s.x)
    assert np.isfinite(x64).all()
    err, scale = displacement_err(store["tet100k_x10_f32"], x64,
                                  store["tet100k_x0"])
    # the f32 round-off of this stiff (mu = lam = 1e5) body's formulation:
    # 2.17% of the displacement on an H100, 2.14% on a CPU with the XLA
    # local step, 1.1% after the first step. The step holds no matrix
    # product that TF32 would change (the local step is the kernel, the
    # dia solve is elementwise); phase_dense_precision guards TF32
    tol = 3e-2
    row("tet100k_f32_vs_f64", steps=10, cg=25, max_err_over_disp=err,
        max_disp=scale, max_err_over_x=float(
            np.abs(store["tet100k_x10_f32"] - x64).max()
            / np.abs(x64).max()), tol=tol, f64_run10_s=secs)
    if not err < tol:
        raise AssertionError(f"f32 vs f64 after 10 steps: {err} >= {tol}")


def _separated(F, gap=1e-2):
    svs = np.linalg.svd(F, compute_uv=False)
    return np.minimum(svs[:, 0] - svs[:, 1], svs[:, 1] - svs[:, 2]) > gap


def phase_local_step(store, dtype_name):
    """The Pallas NH/StVK kernel as compiled for the card against the XLA
    form of the same step (HyperElasticTet.project) at 100,000 elements.
    f64: kernel against XLA. f32 (checked in the f64 pass): both forms
    against the f64 XLA result; the kernel's error may be at most twice
    the XLA form's. In f32 the stvk case is round-off bound (~6e-3 from
    f64 for both forms), so a fixed f32-vs-f32 tolerance would measure
    the conditioning of the inputs, not the kernel."""
    import jax
    import jax.numpy as jnp

    from admm_elastic_tpu.models.tet import HyperElasticTet
    from admm_elastic_tpu.ops.pallas import nh_local
    from admm_elastic_tpu.utils.precision import highest

    dt = jnp.float32 if dtype_name == "f32" else jnp.float64
    # f64: two SVD algorithms + unconverged Newton
    # (tests/test_pallas.py test_nh_kernel_matches_model)
    rtol = atol = 1e-6
    f32_ratio_tol = 2.0

    def excess(a, b, mask=Ellipsis):
        """max |a - b| / (atol + rtol |b|): below 1 passes."""
        a, b = np.asarray(a)[mask], np.asarray(b)[mask]
        return float((np.abs(a - b) / (atol + rtol * np.abs(b))).max())

    def max_err(outs, ref):
        """max |a - b| of (z, u, sigma); z and u on separated elements."""
        return [float(np.abs(np.asarray(a, np.float64)[m] - np.asarray(b)[m])
                      .max()) for a, b, m in zip(outs, ref, (sep, sep, ...))]

    E = LOCAL_E
    rng = np.random.default_rng(0)
    F = rng.normal(size=(E, 3, 3))
    F[: E // 3] = F[: E // 3] @ np.diag([1.0, 1.0, -1.0])
    sep = _separated(F)
    for model, mu_v, lam_v in (("nh", 1e5, 1e5), ("stvk", 100.0, 400.0)):
        Dx = jnp.asarray(np.swapaxes(F, 1, 2), dt)
        u = jnp.asarray(rng.normal(size=(E, 3, 3)) * 0.05, dt)
        sig = jnp.ones((E, 3), dt)
        mu = jnp.full(E, mu_v, dt)
        lam = jnp.full(E, lam_v, dt)
        k = jnp.minimum(mu, lam)
        het = HyperElasticTet(np.zeros((E, 4), np.int32), mu_v, lam_v, 5,
                              model)
        params = {"mu": mu, "lam": lam, "k": k, "weight": jnp.ones(E, dt)}

        def xla(Dx, u, sig):
            z, st = het.project(Dx, u, params, {"sigma": sig})
            return z, u + Dx - z, st["sigma"]

        xla = jax.jit(highest(xla))
        kern = jax.jit(lambda Dx, u, sig: nh_local.nh_local_step(
            Dx, u, sig, mu, lam, k, iters=5, model=model))
        t0 = time.perf_counter()
        zx, ux, sx = jax.block_until_ready(xla(Dx, u, sig))
        xla_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        zk, uk, sk = jax.block_until_ready(kern(Dx, u, sig))
        kern_compile = time.perf_counter() - t0
        sync = jax.block_until_ready
        # 10 calls per window, one sync: dispatch overlaps execution
        xla_ms, _ = windows_ms(lambda: [xla(Dx, u, sig) for _ in range(10)],
                               lambda: sync(xla(Dx, u, sig)), 11)
        kern_ms, _ = windows_ms(lambda: [kern(Dx, u, sig) for _ in range(10)],
                                lambda: sync(kern(Dx, u, sig)), 11)
        timing = dict(kernel_ms=kern_ms, xla_ms=xla_ms,
                      kernel_compile_s=kern_compile,
                      xla_compile_s=xla_compile)
        if dtype_name == "f32":
            store[("local_f32", model)] = (
                [np.asarray(a) for a in (zk, uk, sk)],
                [np.asarray(a) for a in (zx, ux, sx)])
            row("local_step", dtype="f32", model=model, elements=E,
                checked_in="local_step f64", **timing)
            continue
        worst = max(excess(sk, sx), excess(zk, zx, sep), excess(uk, ux, sep))
        k32, x32 = store[("local_f32", model)]
        kerr, xerr = max_err(k32, (zx, ux, sx)), max_err(x32, (zx, ux, sx))
        ratio = max(a / max(b, 1e-30) for a, b in zip(kerr, xerr))
        row("local_step", dtype="f64", model=model, elements=E,
            rtol=rtol, atol=atol, worst_err_over_tol=worst,
            f32_kernel_err_zus=kerr, f32_xla_err_zus=xerr,
            f32_err_ratio=ratio, f32_ratio_tol=f32_ratio_tol, **timing)
        if not worst < 1.0:
            raise AssertionError(
                f"local step {model} f64: error {worst} x tolerance")
        if not ratio < f32_ratio_tol:
            raise AssertionError(
                f"local step {model} f32: kernel error {ratio} x XLA's")


def dense_beam(dtype):
    """A 20x12x10-cell NH beam (3,003 nodes) on the dense global solve,
    the auto choice up to 4,096 nodes: one matrix product per solve."""
    from admm_elastic_tpu import Settings, System
    from admm_elastic_tpu.geometry import make_beam_tets
    from admm_elastic_tpu.models import (
        ExplicitForce,
        HyperElasticTet,
        StaticAnchor,
    )

    beam = make_beam_tets(20, 12, 10, size=0.05)
    n = beam.n_vertices
    s = System(Settings(timestep_s=0.04, admm_iters=10, verbose=0,
                        dtype=dtype))
    s.add_nodes(beam.vertices, np.full(n, 50.0 / n))
    s.add_force(StaticAnchor(np.flatnonzero(beam.vertices[:, 0] < 1e-9)))
    s.add_force(HyperElasticTet(beam.tets, mu=1e5, lam=1e5, max_iters=5,
                                model="nh"))
    s.add_explicit_force(ExplicitForce(direction=(0, -9.8, 0)))
    assert s.initialize() and s._solver_mode == "dense", s._solver_mode
    return s


def phase_dense_precision(store, dtype_name):
    """The guard against TF32: one step of the dense global solve, f32
    against f64. With the products pinned to HIGHEST the f32 step reads
    3.0e-3 of the displacement on an H100; traced at default precision
    (TF32) it reads 2.1e-2, above the bound."""
    s = dense_beam(np.float32 if dtype_name == "f32" else np.float64)
    x0 = np.asarray(s.x)
    s.step()
    x1 = np.asarray(s.x)
    if not np.isfinite(x1).all():
        raise AssertionError("dense beam: non-finite positions")
    if dtype_name == "f32":
        store["dense_f32"] = x1
        return
    tol = 1e-2
    err, scale = displacement_err(store["dense_f32"], x1, x0)
    row("dense_f32_vs_f64", nodes=len(x0), steps=1, max_err_over_disp=err,
        max_disp=scale, tol=tol)
    if not err < tol:
        raise AssertionError(f"dense solve f32 vs f64: {err} >= {tol}")


def phase_delaunay100k():
    import jax.numpy as jnp

    import bench

    t0 = time.perf_counter()
    s, n_tets = bench.build_delaunay100k(jnp.float32, amg=True)
    build_s = time.perf_counter() - t0
    assert s._lattice is None and s._amg_meta is not None
    t, _ = timed_system(s)
    row("delaunay100k", tets=n_tets, mode=s._solver_mode,
        preconditioner="amg", cg=s.settings.cg_fixed_iters, build_s=build_s,
        peak_bytes_in_use=peak_bytes(), **t)


def phase_cloth100k(store):
    import jax.numpy as jnp

    import bench
    from admm_elastic_tpu.__main__ import main as cli_main

    t0 = time.perf_counter()
    s, n_tris = bench.build_cloth100k(jnp.float32)
    build_s = time.perf_counter() - t0
    store["cloth100k_x0"] = np.asarray(s.x)
    t, x10 = timed_system(s)
    store["cloth100k_x10"] = x10
    row("cloth100k", tris=n_tris, mode=s._solver_mode, build_s=build_s,
        peak_bytes_in_use=peak_bytes(), **t)
    t0 = time.perf_counter()
    rc = cli_main([os.path.join(HERE, "samples", "scenes", "cloth.xml"),
                   "--steps", "50"])
    if rc not in (0, None):
        raise AssertionError(f"windyflag CLI returned {rc}")
    row("windyflag_cli", steps=50, seconds=time.perf_counter() - t0)


def phase_layouts(store):
    """Whole-mesh layouts (one-device XLA programs of the sharded
    steppers) timed against the general path. The tet layouts are
    compared pointwise after 10 f32 steps from rest; the cloth layout is
    checked in phase_cloth_layout."""
    import jax.numpy as jnp

    import bench

    # f32 round-off and two implementations of the local step (Triton
    # kernel / lanes arithmetic): compare 10-step displacements
    tol = 2e-2
    cases = [
        ("tet100k", lambda fast: bench.build_tet100k(
            jnp.float32, cg_iters=25, lattice=fast)[0]),
        ("banded100k", lambda fast: bench.build_tet100k(
            jnp.float32, cg_iters=25, lattice=fast, jitter=0.02)[0]),
        ("cloth100k", lambda fast: bench.build_cloth100k(
            jnp.float32, fast_path=fast)[0]),
    ]
    for name, build in cases:
        ref = store.get(f"{name}_x10")
        if name == "tet100k":
            ref = store["tet100k_x10_f32"]
        gen_t = None
        if ref is None:
            g = build(False)
            x0 = np.asarray(g.x)
            gen_t, ref = timed_system(g)
            del g
        else:
            x0 = store[f"{name}_x0"]
        s = build(True)
        assert s._lattice is not None, f"{name}: layout did not engage"
        t, x10 = timed_system(s)
        err, scale = displacement_err(x10, ref, x0)
        checked = name != "cloth100k"
        row("layout", scene=name, layout=type(s._lattice).__name__,
            max_err_over_disp=err, max_disp=scale,
            tol=tol if checked else "see cloth_layout", general=gen_t, **t)
        if checked and not err < tol:
            raise AssertionError(f"{name} layout vs general: {err} >= {tol}")
        del s


def cloth_track(dtype, fast, steps=10):
    """cloth100k from rest, `steps` step() calls: positions after the
    first and the last step, and the bounding-box extent per step."""
    import bench

    s, _ = bench.build_cloth100k(dtype, fast_path=fast)
    assert (s._lattice is not None) == fast
    tr = {"x0": np.asarray(s.x), "ext": []}
    for i in range(steps):
        s.step()
        x = np.asarray(s.x)
        if i == 0:
            tr["x1"] = x
        tr["ext"].append(x.max(0) - x.min(0))
    if not np.isfinite(x).all():
        raise AssertionError("cloth100k: non-finite positions")
    tr["x"] = x
    tr["ext"] = np.array(tr["ext"])
    return tr


def extent_err(a, b):
    """Largest extent difference over all steps and axes, over the
    largest extent."""
    return float(np.abs(a["ext"] - b["ext"]).max() / b["ext"].max())


def phase_cloth_layout(store, dtype_name):
    """cloth100k: the grid-cloth layout against the general path over 10
    steps from rest. Pointwise positions are chaotic here: the
    strain-limit clamps amplify round-off (tests/test_cloth_spmd.py), and
    the general path run twice in f32 on one GPU does not repeat itself,
    while the layout does. So
    the check is the extent per step, against the general path's f64
    trajectory (checked in the f64 pass): the f32 layout within 2e-2 of
    the largest extent, the f64 layout within 2e-3, and the f64 layout's
    first step pointwise. Witness rows set the layout's f32 divergence
    beside the general path's divergence from itself and from f64."""
    import jax.numpy as jnp

    dt = jnp.float32 if dtype_name == "f32" else jnp.float64
    gen, lay = cloth_track(dt, False), cloth_track(dt, True)
    if dtype_name == "f32":
        again = cloth_track(dt, False)
        store["cloth_f32"] = (gen, lay)
        row("cloth_layout", dtype="f32", steps=10,
            checked_in="cloth_layout f64", witness={
                "layout_vs_general": displacement_err(
                    lay["x"], gen["x"], gen["x0"])[0],
                "layout_vs_general_extent": extent_err(lay, gen),
                "general_vs_general_again": displacement_err(
                    again["x"], gen["x"], gen["x0"])[0],
                "general_vs_general_again_extent": extent_err(again, gen),
            })
        return
    g32, l32 = store["cloth_f32"]
    tol32, tol64, step1_tol = 2e-2, 2e-3, 1e-9
    ext32, ext64 = extent_err(l32, gen), extent_err(lay, gen)
    step1, _ = displacement_err(lay["x1"], gen["x1"], gen["x0"])
    row("cloth_layout", dtype="f64", steps=10,
        layout_f32_extent_err=ext32, f32_tol=tol32,
        layout_f64_extent_err=ext64, f64_tol=tol64,
        step1_err_over_disp=step1, step1_tol=step1_tol, witness={
            "layout_vs_general": displacement_err(
                lay["x"], gen["x"], gen["x0"])[0],
            "general_f32_vs_f64": displacement_err(
                g32["x"], gen["x"], gen["x0"])[0],
            "general_f32_vs_f64_extent": extent_err(g32, gen),
        })
    if not (ext32 < tol32 and ext64 < tol64):
        raise AssertionError(f"cloth100k layout extent vs the f64 general "
                             f"path: f32 {ext32}, f64 {ext64}")
    if not step1 < step1_tol:
        raise AssertionError(f"cloth100k layout vs general, one f64 step: "
                             f"{step1} >= {step1_tol}")


def phase_parity_f64():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_parity

    t0 = time.perf_counter()
    test_parity.test_windyflag_full_parity()
    row("parity_f64", scene="windyflag", reference="tests/reference_impl.py",
        rtol=1e-7, atol=1e-8, seconds=time.perf_counter() - t0)


def phase_gpu_tests():
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main([os.path.join(HERE, "tests"), "-q", "-m", "gpu",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    row("gpu_tests", rc=int(rc), seconds=time.perf_counter() - t0)
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {int(rc)}")


# ------------------------------------------------------------- four GPUs

def phase_four():
    """The multi-device paths on four cards, each against one card at the
    1e-3 x scale parity bound of the sharded bench rows."""
    import jax
    import jax.numpy as jnp

    import bench
    from admm_elastic_tpu.__main__ import main as cli_main
    from admm_elastic_tpu.parallel import (
        batch_state, make_sim_mesh, shard_params_and_state, vmap_step)
    from admm_elastic_tpu.parallel.banded_spmd import (
        sharded_banded_from_system,
    )
    from admm_elastic_tpu.parallel.cloth_spmd import (
        sharded_cloth_from_system,
    )
    from admm_elastic_tpu.parallel.halo_spmd import HaloSpmdSystem

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    mesh1 = jax.make_mesh((1,), ("elem",), devices=devs[:1])
    mesh4 = jax.make_mesh((4,), ("elem",), devices=devs[:4])

    def check(name, x1, x4, **fields):
        scale = max(float(np.abs(x1).max()), 1.0)
        err = float(np.abs(x4 - x1).max())
        row("four", path=name, parity_err=err, tol=1e-3 * scale, **fields)
        if not (np.isfinite(x4).all() and err < 1e-3 * scale):
            raise AssertionError(f"{name}: 4-card parity {err}")

    def compare(one, four, n=10):
        """Parity after 3 steps, then ms/step over windows of n step()
        dispatches. Three steps is the sharded bench rows' protocol. It
        is also short enough for the cloth: the sharded sums add in
        another order, and the strain-limit clamps amplify that round-off
        by orders of magnitude per step once a clamp branch flips
        (tests/test_cloth_spmd.py), so over ten f32 steps the two runs
        become different trajectories of the same physics. A fault in the
        halo exchange shows at the first step."""
        for _ in range(3):
            one.step()
            four.step()
        x1, x4 = np.asarray(one.x), np.asarray(four.x)

        def timed(st):
            def go():
                for _ in range(n):
                    st.step()
            return windows_ms(go, lambda: jax.block_until_ready(
                st.state["x"]), n)

        ms1, _ = timed(one)
        ms4, sp4 = timed(four)
        return x1, x4, dict(parity_steps=3, ms_per_step_1=ms1,
                            ms_per_step_4=ms4, spread_ms_4=sp4,
                            comm=four.comm_stats())

    def tet(solver="dia"):
        return bench.build_tet100k(jnp.float32, cg_iters=25,
                                   global_solver=solver)[0]

    def halo():
        ref, sh = tet("ell"), HaloSpmdSystem(tet("ell"), mesh4)
        x1, x4, fields = compare(ref, sh)
        check("halo_tet100k_ell_cg25", x1, x4, **fields)

    def cli():
        rc = cli_main([os.path.join(HERE, "samples", "scenes", "cloth.xml"),
                       "--steps", "20", "--sharded", "4"])
        if rc not in (0, None):
            raise AssertionError(f"CLI --sharded 4 returned {rc}")

    def gspmd():
        """2 scenarios x 2 element shards of the matrix-free cg step."""
        one = tet("cg")
        one.run(5)
        g = tet("cg")
        mesh = make_sim_mesh(devs[:4], data=2)
        shard_params_and_state(g, mesh, elem_axis="elem")
        step = vmap_step(g)
        bstate = batch_state(g.state, 2, mesh=mesh)
        bparams = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a[None], (2,) + a.shape), g.params)
        for _ in range(5):
            bstate, _ = step(bstate, bparams)
        x1 = np.asarray(one.state["x"])
        check("gspmd_data2_elem2_tet100k_cg25", x1[None],
              np.asarray(bstate["x"]), steps=5)

    def banded(solver, it):
        def mk(mesh):
            kw = {"cheb_iters": it} if solver == "cheb" else {}
            return sharded_banded_from_system(tet(), mesh, solver=solver,
                                              **kw)[0]

        x1, x4, fields = compare(mk(mesh1), mk(mesh4))
        check(f"banded_tet100k_{solver}{it}", x1, x4, **fields)

    def cloth():
        def mk(mesh):
            s, _ = bench.build_cloth100k(jnp.float32, fast_path=True)
            return sharded_cloth_from_system(s, mesh)[0]

        x1, x4, fields = compare(mk(mesh1), mk(mesh4))
        check("cloth_cloth100k_cg25", x1, x4, **fields)

    halo()
    cli()
    gspmd()
    cloth()
    banded("cg", 25)
    banded("cheb", 180)


# ------------------------------------------------------------------- main

def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded paths only")
    args = ap.parse_args()

    # before JAX is imported: it reads the cache directory at import
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
            HERE, ".jax_cache")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import admm_elastic_tpu  # noqa: F401  (fails outside a checkout)
    import bench  # noqa: F401

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    CARD = smi.splitlines()[0]
    row("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__)

    phases = []
    if args.four:
        phases = [("four", phase_four)]
    else:
        store = {}
        phases = [
            ("tet100k", lambda: phase_tet100k(store)),
            ("local_step_f32", lambda: phase_local_step(store, "f32")),
            ("dense_f32", lambda: phase_dense_precision(store, "f32")),
            ("delaunay100k", phase_delaunay100k),
            ("cloth100k", lambda: phase_cloth100k(store)),
            ("layouts", lambda: phase_layouts(store)),
            ("cloth_layout_f32", lambda: phase_cloth_layout(store, "f32")),
            ("gpu_tests", phase_gpu_tests),
            ("x64", lambda: jax.config.update("jax_enable_x64", True)),
            ("tet100k_f64", lambda: phase_tet100k_f64(store)),
            ("local_step_f64", lambda: phase_local_step(store, "f64")),
            ("dense_f64", lambda: phase_dense_precision(store, "f64")),
            ("cloth_layout_f64", lambda: phase_cloth_layout(store, "f64")),
            ("parity_f64", phase_parity_f64),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        row("done", name=name, seconds=time.perf_counter() - t0,
            elapsed_s=time.perf_counter() - T0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
