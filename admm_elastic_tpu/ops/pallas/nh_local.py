"""NeoHookean / StVK tet local step as one Pallas kernel (Triton route).

One program handles BLOCK elements and keeps every intermediate of the
element pipeline in registers (TetForce.cpp:320-364 semantics):

    F      = Dx + u
    U,s,V  = oriented SVD(F)        (signed s2; proper rotations)
    sigma* = argmin  psi(sigma) + k/2 ||sigma - s||^2   (damped Newton,
             fixed iterations, closed-form gradient/Hessian)
    z      = U diag(sigma*) V^T
    u'     = u + Dx - z

The XLA form of the same step (models/tet.py HyperElasticTet.project)
runs each Newton iteration as its own fused kernels with the per-element
temporaries in device memory; here the whole step is one launch. The math
bodies are shared with the XLA banded stepper (ops/lanes.py).

Operands use the force's canonical layouts: Dx/u/z (E, 3, 3) with
Dx[e, b, a] = F[a][b], the warm start (E, 3), materials (E,). The fused
variant takes the gathered vertices xg[e, k, a] = x[tet[e, k], a] and the
selector coeff (E, 3, 4), applies the selector in-kernel and also returns
the RHS rows w^2 D^T (z - u') as (E, 4, 3) (and w^2 D^T z for the dual
residual when emit_z). Element counts need not be a multiple of BLOCK:
the last program masks its loads and stores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..lanes import hyper_prox

#: elements per program; the body holds ~100 live values per element
BLOCK = 128
NUM_WARPS = 4


def _make_kernel(E, iters, model, fused, emit_z):
    def kernel(*refs):
        i = pl.program_id(0)
        sl = pl.ds(i * BLOCK, BLOCK)
        mask = i * BLOCK + jax.lax.iota(jnp.int32, BLOCK) < E

        # constant indices as int32 like program_id (x64 mode would make
        # Python ints int64, which the interpreter's slices refuse to mix)
        def ld(ref, *idx, other=0.0):
            idx = (sl,) + tuple(np.int32(q) for q in idx)
            return plgpu.load(ref.at[idx], mask=mask, other=other)

        def st(ref, val, *idx):
            idx = (sl,) + tuple(np.int32(q) for q in idx)
            plgpu.store(ref.at[idx], val, mask=mask)

        if fused:
            (xg_ref, u_ref, w_ref, cp_ref, mu_ref, lam_ref, k_ref, w2_ref,
             z_ref, un_ref, wo_ref, c_ref, *cz_ref) = refs
            xg = [[ld(xg_ref, kk, a) for a in range(3)] for kk in range(4)]
            cp = [[ld(cp_ref, b, kk) for kk in range(4)] for b in range(3)]
            dx = []
            for a in range(3):
                for b in range(3):
                    acc = cp[b][0] * xg[0][a]
                    for kk in range(1, 4):
                        acc = acc + cp[b][kk] * xg[kk][a]
                    dx.append(acc)
        else:
            (dx_ref, u_ref, w_ref, mu_ref, lam_ref, k_ref,
             z_ref, un_ref, wo_ref) = refs
            dx = [ld(dx_ref, b, a) for a in range(3) for b in range(3)]
        uu = [ld(u_ref, b, a) for a in range(3) for b in range(3)]
        f = [dx[p] + uu[p] for p in range(9)]
        warm = [ld(w_ref, c, other=1.0) for c in range(3)]
        mats = [ld(r, other=1.0) for r in (mu_ref, lam_ref, k_ref)]

        z, sig = hyper_prox(f, warm, *mats, iters, model)
        for c in range(3):
            st(wo_ref, sig[c], c)
        zu = [None] * 9
        for a in range(3):
            for b in range(3):
                p = 3 * a + b
                un = uu[p] + dx[p] - z[p]
                st(z_ref, z[p], b, a)
                st(un_ref, un, b, a)
                zu[p] = z[p] - un

        if fused:
            w2 = ld(w2_ref)
            blocks = [(c_ref, zu)] + ([(cz_ref[0], z)] if emit_z else [])
            for out_ref, y in blocks:
                # rows w^2 sum_r coeff[r, k] y[r, j]; y plane 3j+r
                for kk in range(4):
                    for j in range(3):
                        acc = cp[0][kk] * y[3 * j]
                        for r in range(1, 3):
                            acc = acc + cp[r][kk] * y[3 * j + r]
                        st(out_ref, w2 * acc, kk, j)

    return kernel


def _call(kernel, E, out_shape, args, interpret, name):
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(E, BLOCK),),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


@functools.partial(jax.jit, static_argnames=("iters", "model", "interpret"))
def nh_local_step(Dx, u, sigma, mu, lam, k, iters=5, model="nh",
                  interpret=False):
    """Local step + dual update. Dx/u: (E,3,3); sigma: (E,3) warm start;
    mu/lam/k: (E,). Returns (z, u_new, sigma_new)."""
    E = Dx.shape[0]
    out_shape = [
        jax.ShapeDtypeStruct(Dx.shape, Dx.dtype),
        jax.ShapeDtypeStruct(Dx.shape, Dx.dtype),
        jax.ShapeDtypeStruct(sigma.shape, sigma.dtype),
    ]
    return tuple(_call(
        _make_kernel(E, iters, model, False, False), E, out_shape,
        (Dx, u, sigma, mu, lam, k), interpret, "nh_local_step",
    ))


@functools.partial(
    jax.jit, static_argnames=("iters", "model", "emit_z", "interpret"))
def nh_local_step_fused(xg, u, sigma, coeff, mu, lam, k, w2, iters=5,
                        model="nh", emit_z=False, interpret=False):
    """Selector apply + local step + dual update + RHS rows.
    xg: (E,4,3) gathered vertices; u: (E,3,3); sigma: (E,3);
    coeff: (E,3,4); mu/lam/k/w2: (E,). Returns (z, u_new, sigma_new,
    contrib (E,4,3)[, contrib_z (E,4,3)])."""
    E = xg.shape[0]
    rows = jax.ShapeDtypeStruct((E, 4, 3), xg.dtype)
    out_shape = [
        jax.ShapeDtypeStruct(u.shape, u.dtype),
        jax.ShapeDtypeStruct(u.shape, u.dtype),
        jax.ShapeDtypeStruct(sigma.shape, sigma.dtype),
        rows,
    ] + ([rows] if emit_z else [])
    return tuple(_call(
        _make_kernel(E, iters, model, True, emit_z), E, out_shape,
        (xg, u, sigma, coeff, mu, lam, k, w2), interpret,
        "nh_local_step_fused",
    ))
