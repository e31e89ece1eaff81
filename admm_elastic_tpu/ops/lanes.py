"""Element-parallel local-step math on structure-of-arrays operands.

Every function here takes lists of equally shaped arrays, one array per
matrix entry ("planes": plane 3r+c holds F[r][c] for every element), and
uses only elementwise arithmetic, comparisons and selects. That keeps the
bodies valid in three places at once: XLA programs (the banded and cloth
steppers in parallel/), and the Pallas kernel of ops/pallas/nh_local.py,
where each array is one block of elements held in registers.

The math is the branch-free form of ops/svd.py (Jacobi eigensolver on
F^T F plus safe orthonormalisation of F V) and of the safeguarded Newton
of ops/newton.py with the closed-form NeoHookean / StVK derivatives of
models/tet.py (reference TetForce.cpp:216-364, TriangleForce.cpp:79-113).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SWEEPS = 6
SIGMA_FLOOR = 1e-8
# Newton backtracking with a DEEP tail + always-on scaled gradient-step
# candidates (see ops/newton.py _ALPHAS: a schedule stopping at 1/16 can
# leave the iterate permanently stuck when the Hessian is ill-conditioned)
_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 1.0 / 64.0, 1.0 / 256.0)
_GRAD_ALPHAS = (1.0, 0.0625)


def jacobi_cs(app, aqq, apq, eps):
    """Cosine and sine of the Jacobi rotation zeroing apq."""
    tau = (aqq - app) / (2.0 * jnp.where(jnp.abs(apq) < eps, 1.0, apq))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(apq) < eps, 0.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    return c, t * c


def _repeat(body, n, carry):
    """carry = body(carry) n times, as one loop whose body is traced once:
    the unrolled body is several times larger and slow to compile."""
    return jax.lax.fori_loop(np.int32(0), np.int32(n),
                             lambda _, c: body(c), carry)


def svd_columns(f, eps):
    """f: 9 planes of F (row-major). Returns (U cols, V cols, s) where
    U/V are 3 lists of 3 arrays (columns) and s = (s0,s1,s2) signed."""

    def col(c):
        return (f[c], f[3 + c], f[6 + c])

    def dotc(ca, cb):
        a, b = col(ca), col(cb)
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    a00, a11, a22 = dotc(0, 0), dotc(1, 1), dotc(2, 2)
    a01, a02, a12 = dotc(0, 1), dotc(0, 2), dotc(1, 2)
    scale = jnp.maximum(
        jnp.maximum(jnp.maximum(jnp.abs(a00), jnp.abs(a11)), jnp.abs(a22)), 1.0
    )
    a00, a11, a22 = a00 / scale, a11 / scale, a22 / scale
    a01, a02, a12 = a01 / scale, a02 / scale, a12 / scale

    one = jnp.ones_like(a00)
    zero = jnp.zeros_like(a00)

    def sweep(carry):
        a00, a11, a22, a01, a02, a12, vflat = carry
        v = [list(vflat[3 * r:3 * r + 3]) for r in range(3)]

        def rot_cols(p, q, c, s):
            for r in range(3):
                vp, vq = v[r][p], v[r][q]
                v[r][p] = c * vp - s * vq
                v[r][q] = s * vp + c * vq

        c, s = jacobi_cs(a00, a11, a01, eps)
        n00 = c * c * a00 - 2 * s * c * a01 + s * s * a11
        n11 = s * s * a00 + 2 * s * c * a01 + c * c * a11
        n02 = c * a02 - s * a12
        n12 = s * a02 + c * a12
        a00, a11, a01, a02, a12 = n00, n11, zero, n02, n12
        rot_cols(0, 1, c, s)
        c, s = jacobi_cs(a00, a22, a02, eps)
        n00 = c * c * a00 - 2 * s * c * a02 + s * s * a22
        n22 = s * s * a00 + 2 * s * c * a02 + c * c * a22
        n01 = c * a01 - s * a12
        n12 = s * a01 + c * a12
        a00, a22, a02, a01, a12 = n00, n22, zero, n01, n12
        rot_cols(0, 2, c, s)
        c, s = jacobi_cs(a11, a22, a12, eps)
        n11 = c * c * a11 - 2 * s * c * a12 + s * s * a22
        n22 = s * s * a11 + 2 * s * c * a12 + c * c * a22
        n01 = c * a01 - s * a02
        n02 = s * a01 + c * a02
        a11, a22, a12, a01, a02 = n11, n22, zero, n01, n02
        rot_cols(1, 2, c, s)
        return (a00, a11, a22, a01, a02, a12,
                tuple(v[r][c] for r in range(3) for c in range(3)))

    a00, a11, a22, a01, a02, a12, vflat = _repeat(
        sweep, _SWEEPS,
        (a00, a11, a22, a01, a02, a12,
         (one, zero, zero, zero, one, zero, zero, zero, one)))
    v = [list(vflat[3 * r:3 * r + 3]) for r in range(3)]

    w = [a00, a11, a22]
    cols = [[v[0][c], v[1][c], v[2][c]] for c in range(3)]

    def cswap(i, j):
        swap = w[i] < w[j]
        w[i], w[j] = jnp.where(swap, w[j], w[i]), jnp.where(swap, w[i], w[j])
        for r in range(3):
            ci, cj = cols[i][r], cols[j][r]
            cols[i][r] = jnp.where(swap, cj, ci)
            cols[j][r] = jnp.where(swap, ci, cj)

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    det = (
        cols[0][0] * (cols[1][1] * cols[2][2] - cols[1][2] * cols[2][1])
        - cols[1][0] * (cols[0][1] * cols[2][2] - cols[0][2] * cols[2][1])
        + cols[2][0] * (cols[0][1] * cols[1][2] - cols[0][2] * cols[1][1])
    )
    sflip = jnp.where(det < 0, -1.0, 1.0)
    for r in range(3):
        cols[2][r] = cols[2][r] * sflip

    def matvec(ci):
        vc = cols[ci]
        return [
            f[0] * vc[0] + f[1] * vc[1] + f[2] * vc[2],
            f[3] * vc[0] + f[4] * vc[1] + f[5] * vc[2],
            f[6] * vc[0] + f[7] * vc[1] + f[8] * vc[2],
        ]

    b0, b1, b2 = matvec(0), matvec(1), matvec(2)

    def norm3(x):
        return jnp.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])

    n0 = norm3(b0)
    tol = eps * 16.0 * (jnp.sqrt(jnp.maximum(w[0] * scale, 0.0)) + eps)
    ok0 = n0 > tol
    inv0 = 1.0 / jnp.where(ok0, n0, 1.0)
    u0 = [jnp.where(ok0, b0[kk] * inv0, 1.0 if kk == 0 else 0.0) for kk in range(3)]

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    p1 = [b1[kk] - d01 * u0[kk] for kk in range(3)]
    n1 = norm3(p1)
    ok1 = n1 > tol
    inv1 = 1.0 / jnp.where(ok1, n1, 1.0)
    au = [jnp.abs(u0[0]), jnp.abs(u0[1]), jnp.abs(u0[2])]
    use_x = (au[0] <= au[1]) & (au[0] <= au[2])
    use_y = (~use_x) & (au[1] <= au[2])
    ax = [
        jnp.where(use_x, 1.0, 0.0),
        jnp.where(use_y, 1.0, 0.0),
        jnp.where(use_x | use_y, 0.0, 1.0),
    ]
    dax = ax[0] * u0[0] + ax[1] * u0[1] + ax[2] * u0[2]
    fb = [ax[kk] - dax * u0[kk] for kk in range(3)]
    fbn = norm3(fb)
    fb = [fb[kk] / jnp.where(fbn > 0, fbn, 1.0) for kk in range(3)]
    u1 = [jnp.where(ok1, p1[kk] * inv1, fb[kk]) for kk in range(3)]

    u2 = [
        u0[1] * u1[2] - u0[2] * u1[1],
        u0[2] * u1[0] - u0[0] * u1[2],
        u0[0] * u1[1] - u0[1] * u1[0],
    ]
    U = [u0, u1, u2]
    s = (
        u0[0] * b0[0] + u0[1] * b0[1] + u0[2] * b0[2],
        u1[0] * b1[0] + u1[1] * b1[1] + u1[2] * b1[2],
        u2[0] * b2[0] + u2[1] * b2[1] + u2[2] * b2[2],
    )
    return U, cols, s


def _stvk_value(s1, s2, s3, mu, lam, k, c1, c2, c3):
    """StVK prox objective (TetForce.cpp:269-278)."""
    e1 = 0.5 * (s1 * s1 - 1.0)
    e2 = 0.5 * (s2 * s2 - 1.0)
    e3 = 0.5 * (s3 * s3 - 1.0)
    tr = e1 + e2 + e3
    psi = mu * (e1 * e1 + e2 * e2 + e3 * e3) + 0.5 * lam * tr * tr
    prox = 0.5 * k * ((s1 - c1) ** 2 + (s2 - c2) ** 2 + (s3 - c3) ** 2)
    val = psi + prox
    big = jnp.asarray(3.4e38, val.dtype)
    return jnp.where((s1 > 0) & (s2 > 0) & (s3 > 0), val, big)


def _nh_value(s1, s2, s3, mu, lam, k, c1, c2, c3):
    """NH prox objective; +inf via big-where for non-positive sigma."""
    det = s1 * s2 * s3
    pos = det > 0
    safe_det = jnp.where(pos, det, 1.0)
    logdet = jnp.log(safe_det)
    I1 = s1 * s1 + s2 * s2 + s3 * s3
    psi = 0.5 * mu * (I1 - 2.0 * logdet - 3.0) + 0.5 * lam * logdet * logdet
    prox = 0.5 * k * ((s1 - c1) ** 2 + (s2 - c2) ** 2 + (s3 - c3) ** 2)
    val = psi + prox
    big = jnp.asarray(3.4e38, val.dtype)
    return jnp.where(pos & (s1 > 0) & (s2 > 0) & (s3 > 0), val, big)


def newton_hyper(s0, warm, mu, lam, k, iters, model):
    """Damped Newton on 3 singular values; model: 'nh'|'stvk'."""
    c1, c2, c3 = s0  # prox centers (signed SVD values)
    x1, x2, x3 = warm
    value_fn = _nh_value if model == "nh" else _stvk_value

    floor = SIGMA_FLOOR
    x1 = jnp.maximum(x1, floor)
    x2 = jnp.maximum(x2, floor)
    x3 = jnp.maximum(x3, floor)

    def newton_step(xs):
        x1, x2, x3 = xs
        if model == "nh":
            inv1, inv2, inv3 = 1.0 / x1, 1.0 / x2, 1.0 / x3
            logdet = jnp.log(x1 * x2 * x3)
            g1 = mu * (x1 - inv1) + lam * logdet * inv1 + k * (x1 - c1)
            g2 = mu * (x2 - inv2) + lam * logdet * inv2 + k * (x2 - c2)
            g3 = mu * (x3 - inv3) + lam * logdet * inv3 + k * (x3 - c3)
            # diag of lam*outer(inv,inv) contributes +lam*inv_i^2, matching
            # the validated closed form models/tet.py:nh_grad_hess.
            h11 = mu * (1.0 + inv1 * inv1) + (lam - lam * logdet) * inv1 * inv1 + k
            h22 = mu * (1.0 + inv2 * inv2) + (lam - lam * logdet) * inv2 * inv2 + k
            h33 = mu * (1.0 + inv3 * inv3) + (lam - lam * logdet) * inv3 * inv3 + k
            h12 = lam * inv1 * inv2
            h13 = lam * inv1 * inv3
            h23 = lam * inv2 * inv3
        else:  # stvk (closed forms match models/tet.py stvk_grad_hess)
            ss = x1 * x1 + x2 * x2 + x3 * x3
            g1 = mu * x1 * (x1 * x1 - 1.0) + 0.5 * lam * (ss - 3.0) * x1 + k * (x1 - c1)
            g2 = mu * x2 * (x2 * x2 - 1.0) + 0.5 * lam * (ss - 3.0) * x2 + k * (x2 - c2)
            g3 = mu * x3 * (x3 * x3 - 1.0) + 0.5 * lam * (ss - 3.0) * x3 + k * (x3 - c3)
            base = 0.5 * lam * (ss - 3.0) + k
            h11 = mu * (3.0 * x1 * x1 - 1.0) + base + lam * x1 * x1
            h22 = mu * (3.0 * x2 * x2 - 1.0) + base + lam * x2 * x2
            h33 = mu * (3.0 * x3 * x3 - 1.0) + base + lam * x3 * x3
            h12 = lam * x1 * x2
            h13 = lam * x1 * x3
            h23 = lam * x2 * x3
        hmax = jnp.maximum(
            jnp.maximum(jnp.abs(h11), jnp.abs(h22)),
            jnp.maximum(jnp.abs(h33), jnp.maximum(jnp.abs(h12), jnp.maximum(jnp.abs(h13), jnp.abs(h23)))),
        )
        damp = 1e-6 * (hmax + 1.0)
        h11 = h11 + damp
        h22 = h22 + damp
        h33 = h33 + damp
        # symmetric 3x3 solve via adjugate
        cof11 = h22 * h33 - h23 * h23
        cof12 = h13 * h23 - h12 * h33
        cof13 = h12 * h23 - h13 * h22
        det = h11 * cof11 + h12 * cof12 + h13 * cof13
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        cof22 = h11 * h33 - h13 * h13
        cof23 = h12 * h13 - h11 * h23
        cof33 = h11 * h22 - h12 * h12
        d1 = -(cof11 * g1 + cof12 * g2 + cof13 * g3) / det
        d2 = -(cof12 * g1 + cof22 * g2 + cof23 * g3) / det
        d3 = -(cof13 * g1 + cof23 * g2 + cof33 * g3) / det
        # steepest-descent fallback if not a descent direction
        descent = d1 * g1 + d2 * g2 + d3 * g3 < 0.0
        gscale = 1.0 / (hmax + 1.0)
        d1 = jnp.where(descent, d1, -g1 * gscale)
        d2 = jnp.where(descent, d2, -g2 * gscale)
        d3 = jnp.where(descent, d3, -g3 * gscale)

        f_best = value_fn(x1, x2, x3, mu, lam, k, c1, c2, c3)
        b1, b2, b3 = x1, x2, x3

        def try_step(s1, s2, s3, f_best, b1, b2, b3):
            t1 = jnp.maximum(s1, floor)
            t2 = jnp.maximum(s2, floor)
            t3 = jnp.maximum(s3, floor)
            fv = value_fn(t1, t2, t3, mu, lam, k, c1, c2, c3)
            better = fv < f_best
            return (
                jnp.where(better, fv, f_best),
                jnp.where(better, t1, b1),
                jnp.where(better, t2, b2),
                jnp.where(better, t3, b3),
            )

        for a in _ALPHAS:
            f_best, b1, b2, b3 = try_step(
                x1 + a * d1, x2 + a * d2, x3 + a * d3, f_best, b1, b2, b3
            )
        for a in _GRAD_ALPHAS:
            f_best, b1, b2, b3 = try_step(
                x1 - a * g1 * gscale, x2 - a * g2 * gscale,
                x3 - a * g3 * gscale, f_best, b1, b2, b3,
            )
        return b1, b2, b3

    return _repeat(newton_step, iters, (x1, x2, x3))


def hyper_prox(f, warm, mu, lam, k, iters, model):
    """The NH/StVK local step on planes: F (9 planes) and the warm start
    (3 planes) in, z = U diag(sigma*) V^T (9 planes) and sigma* out.

    Warm-start guards follow TetForce.cpp:339-347: a negative third
    component is flipped, else a collapsed (all ~0) start is bumped."""
    eps = jnp.asarray(jnp.finfo(f[0].dtype).eps, f[0].dtype)
    U, V, s = svd_columns(f, eps)
    w1, w2, w3 = warm
    neg3 = w3 < 0.0
    w3 = jnp.abs(w3)
    collapsed = (~neg3) & (
        (jnp.abs(w1) < 1e-3) & (jnp.abs(w2) < 1e-3) & (jnp.abs(w3) < 1e-3)
    )
    w1 = jnp.where(collapsed, 1e-3, w1)
    w2 = jnp.where(collapsed, 1e-3, w2)
    w3 = jnp.where(collapsed, 1e-3, w3)
    sig = newton_hyper(s, (w1, w2, w3), mu, lam, k, iters, model)
    z = [
        U[0][r] * sig[0] * V[0][c] + U[1][r] * sig[1] * V[1][c]
        + U[2][r] * sig[2] * V[2][c]
        for r in range(3) for c in range(3)
    ]
    return z, sig


def _svd32(f, eps):
    """f: 6 planes of F (3x2, plane 2a+b). Returns (U cols, V cols, s):
    U = [u0,u1] lists of 3 arrays, V = [v0,v1] lists of 2, s=(s0,s1)
    with s0 >= s1 >= 0 (plain SVD — no orientation handling needed for a
    3x2 factor; T = U V^T is the closest in-plane rotation)."""

    def col(b):
        return (f[b], f[2 + b], f[4 + b])

    def dotc(ba, bb):
        a, b = col(ba), col(bb)
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    a00, a11, a01 = dotc(0, 0), dotc(1, 1), dotc(0, 1)
    # closed-form symmetric 2x2 eigendecomposition
    tr = a00 + a11
    diff = a00 - a11
    rad = jnp.sqrt(diff * diff + 4.0 * a01 * a01)
    w0 = 0.5 * (tr + rad)
    w1 = 0.5 * (tr - rad)
    # eigenvector for w0: (A - w0 I) v = 0 gives two candidate forms
    # v = (w0 - a11, a01) (row 2) or (a01, w0 - a00) (row 1); take the
    # better-conditioned one, fall back to (1,0) for isotropic A
    c1x, c1y = w0 - a11, a01
    c2x, c2y = a01, w0 - a00
    n1 = c1x * c1x + c1y * c1y
    n2 = c2x * c2x + c2y * c2y
    use1 = n1 >= n2
    vx = jnp.where(use1, c1x, c2x)
    vy = jnp.where(use1, c1y, c2y)
    nn = jnp.sqrt(jnp.maximum(n1, n2))
    ok = nn > eps * jnp.maximum(tr, 1.0)
    inv = 1.0 / jnp.where(ok, nn, 1.0)
    c = jnp.where(ok, vx * inv, 1.0)
    s_ = jnp.where(ok, vy * inv, 0.0)
    v0 = [c, s_]
    v1 = [-s_, c]

    s0 = jnp.sqrt(jnp.maximum(w0, 0.0))
    s1 = jnp.sqrt(jnp.maximum(w1, 0.0))

    def matvec(v):
        return [
            f[0] * v[0] + f[1] * v[1],
            f[2] * v[0] + f[3] * v[1],
            f[4] * v[0] + f[5] * v[1],
        ]

    b0 = matvec(v0)
    b1 = matvec(v1)

    def norm3(x):
        return jnp.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])

    tol = eps * 16.0 * (s0 + eps)
    n0 = norm3(b0)
    ok0 = n0 > tol
    inv0 = 1.0 / jnp.where(ok0, n0, 1.0)
    u0 = [jnp.where(ok0, b0[a] * inv0, 1.0 if a == 0 else 0.0)
          for a in range(3)]

    d01 = u0[0] * b1[0] + u0[1] * b1[1] + u0[2] * b1[2]
    p1 = [b1[a] - d01 * u0[a] for a in range(3)]
    n1 = norm3(p1)
    ok1 = n1 > tol
    inv1 = 1.0 / jnp.where(ok1, n1, 1.0)
    # fallback axis least aligned with u0
    au = [jnp.abs(u0[0]), jnp.abs(u0[1]), jnp.abs(u0[2])]
    use_x = (au[0] <= au[1]) & (au[0] <= au[2])
    use_y = (~use_x) & (au[1] <= au[2])
    ax = [
        jnp.where(use_x, 1.0, 0.0),
        jnp.where(use_y, 1.0, 0.0),
        jnp.where(use_x | use_y, 0.0, 1.0),
    ]
    dax = ax[0] * u0[0] + ax[1] * u0[1] + ax[2] * u0[2]
    fb = [ax[a] - dax * u0[a] for a in range(3)]
    fbn = norm3(fb)
    fb = [fb[a] / jnp.where(fbn > 0, fbn, 1.0) for a in range(3)]
    u1 = [jnp.where(ok1, p1[a] * inv1, fb[a]) for a in range(3)]

    return [u0, u1], [v0, v1], (s0, s1)


def tri_body(f, w2, k, lmin, lmax, limiting):
    """Triangle strain projection: F planes (3x2, plane 2a+b) -> z planes
    (strain-limited mix of the in-plane rotation and F)."""
    eps = jnp.asarray(jnp.finfo(f[0].dtype).eps, f[0].dtype)
    U, V, _ = _svd32(f, eps)
    denom = 1.0 / (w2 + k)
    z = [None] * 6
    for a in range(3):
        for b in range(2):
            t = U[0][a] * V[0][b] + U[1][a] * V[1][b]
            z[2 * a + b] = (k * t + w2 * f[2 * a + b]) * denom
    if limiting:
        # clamp column norms into [lmin, lmax] (TriangleForce.cpp:100-107)
        for b in range(2):
            l = jnp.sqrt(
                z[b] * z[b] + z[2 + b] * z[2 + b] + z[4 + b] * z[4 + b]
            )
            safe = jnp.maximum(l, 1e-6)
            scale = jnp.where(
                l < lmin, lmin / safe, jnp.where(l > lmax, lmax / safe, 1.0)
            )
            for a in range(3):
                z[2 * a + b] = z[2 * a + b] * scale
    return z
