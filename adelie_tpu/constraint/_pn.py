"""Jittable proximal-Newton constrained block solver.

Faithful JAX re-derivation of the reference's dual proximal-(quasi-)Newton
method for per-group linear inequality constraints
(``constraint/utils.hpp solve_proximal_newton`` + the linear-constraint
inner pieces, ``constraint_linear.ipp:240-470``):

* dual residual  ``mu_resid = v_t - P' mu``  with ``P = A V`` (the
  constraint matrix rotated into the group eigenbasis — the orthogonality
  of V collapses every original-basis quantity in the reference onto P),
* primal recovery by the unconstrained eigenbasis Newton solver,
* zero-primal certificates via a box-constrained least-squares in mu
  (the reference's NNLS with feasible-at-zero sign boxes),
* dual backtracking along ``mu - mu_prev`` when the Newton step overshoots
  the ellipse ``||mu_resid|| <= l1`` (utils.hpp:170-184),
* the proximal-Newton step itself: a pinball-penalized QP in mu with
  curvature ``C = A H A'`` from the Woodbury-form primal Hessian
  (utils.hpp:205-240), solved by the same coordinate-descent
  ``pinball_full`` the reference uses.

Everything is ``lax.while_loop``/``lax.cond`` so the solver runs inside
the fused constrained CD sweep (solver/pin_constrained.py) exactly like
the ADMM variant.  The ``nnls_*`` / ``pinball_*`` / ``slack`` knobs map
one-to-one onto the reference's (constraint.py:137-144).
"""

import jax
import jax.numpy as jnp

from ..bcd import newton_solver
from ..optimization import _cd_full, pinball_full

_PRECISION = jax.lax.Precision.HIGHEST


def _min_mu_resid(P, v_t, mu0, lo, hi, big, nnls_tol, nnls_max_iters):
    """min_mu ||v_t - P'mu||^2 over the feasible-at-zero sign box
    (reference compute_min_mu_resid, constraint_linear.ipp:280-355).

    Complementary slackness at beta = 0 allows mu_i > 0 only when
    hi_i <= 0 and mu_i < 0 only when lo_i >= 0.  Returns (mu, resid_sq).
    """
    mu_hi = jnp.where(hi <= 0, big, 0.0)
    mu_lo = jnp.where(lo >= 0, -big, 0.0)
    Q = jnp.matmul(P, P.T, precision=_PRECISION)
    lin = jnp.matmul(P, v_t, precision=_PRECISION)
    x0 = jnp.clip(mu0, mu_lo, mu_hi)
    grad0 = lin - Q @ x0

    def rule(i, qii, gi, xi):
        step = jnp.where(qii <= 0, 0.0, gi / jnp.where(qii <= 0, 1.0, qii))
        return jnp.clip(xi + step, mu_lo[i], mu_hi[i])

    mu, _, _ = _cd_full(Q, x0, grad0, rule, nnls_max_iters, nnls_tol,
                        jnp.asarray(1.0, v_t.dtype))
    r = v_t - P.T @ mu
    return mu, jnp.sum(r * r)


def pn_block_solve(
    P,          # (m, d) = A @ V (eigenbasis constraint matrix)
    lam,        # (d,) eigenvalues (quad)
    V,          # (d, d) eigenvectors (only for the PN variance scale)
    v_t,        # (d,) eigenbasis linear term
    l1, l2,     # scalars
    lo, hi,     # (m,) interval bounds on z = P x
    x0,         # (d,) eigenbasis warm start
    mu0,        # (m,) dual warm start
    big,        # dtype-safe unbounded sentinel
    tol=1e-9,
    slack=1e-4,
    max_iters: int = 100,
    nnls_tol=1e-9,
    nnls_max_iters: int = 10000,
    pinball_tol=1e-7,
    pinball_max_iters: int = 10000,
    newton_tol=1e-12,
    newton_max_iters: int = 1000,
):
    """Returns (x, mu).  See module docstring."""
    m, d = P.shape
    dtype = v_t.dtype
    df = jnp.asarray(float(d), dtype)
    buf1 = lam + l2

    def primal(mu_resid):
        x, _ = newton_solver(lam, mu_resid, l1, l2, newton_tol,
                             newton_max_iters)
        return x

    # ---- trivial: x = 0, mu = 0 optimal ----
    v_norm = jnp.sqrt(jnp.sum(v_t * v_t))

    def trivial():
        return jnp.zeros_like(x0), jnp.zeros_like(mu0)

    def solve():
        init_zero = jnp.all(x0 == 0)

        # x == 0 warm start: check the zero-primal dual certificate first
        # (utils.hpp:77-84)
        def init_check():
            mu_min, rsq = _min_mu_resid(P, v_t, mu0, lo, hi, big,
                                        nnls_tol, nnls_max_iters)
            ok = rsq <= l1 * l1
            return ok, jnp.where(ok, mu_min, mu0)

        init_done, mu_init = jax.lax.cond(
            init_zero, init_check,
            lambda: (jnp.zeros((), bool), mu0),
        )

        # carry: mu, mu_prev, x, px_prev, mrn_prev, is_prev_valid,
        #        zero_checked, it, done
        def cond(c):
            return (~c[-1]) & (c[-2] < max_iters)

        def body(c):
            (mu, mu_prev, x, px_prev, mrn_prev, prev_ok, zero_checked,
             it, done) = c
            mu_resid = v_t - jnp.matmul(P.T, mu, precision=_PRECISION)
            mrn = jnp.sqrt(jnp.sum(mu_resid * mu_resid))
            x_new = primal(mu_resid)
            x_norm = jnp.sqrt(jnp.sum(x_new * x_new))
            in_ellipse = (mrn <= l1) | (x_norm <= 0)

            dmu = mu - mu_prev
            Pt_dmu = jnp.matmul(P.T, dmu, precision=_PRECISION)

            def ellipse_branch(_):
                # x*(mu) = 0 — certify, converge, or backtrack
                first_zero = (it == 0) & init_zero
                conv0 = jnp.abs(jnp.dot(dmu, px_prev,
                                        precision=_PRECISION)) / df
                converged = prev_ok & (conv0 <= tol)

                def try_zero(_):
                    mu_min, rsq = _min_mu_resid(
                        P, v_t, mu, lo, hi, big, nnls_tol, nnls_max_iters
                    )
                    ok = rsq <= l1 * l1
                    # reference adopts the certificate mu when it succeeds
                    # or when no valid prev exists (ipp:336-352)
                    adopt = ok | (~prev_ok)
                    mu_z = jnp.where(adopt, mu_min, mu)
                    return ok, mu_z

                def backtrack(mu):
                    # utils.hpp:170-184: step toward mu_prev landing the
                    # residual norm at (1-slack) l1 + slack * prev
                    target = (1 - slack) * l1 + slack * mrn_prev
                    a = jnp.sum(Pt_dmu * Pt_dmu)
                    b = jnp.dot(mu_resid, Pt_dmu, precision=_PRECISION)
                    cq = mrn * mrn - target * target
                    disc = jnp.maximum(b * b - a * cq, 0.0)
                    t_star = (-b + jnp.sqrt(disc)) / jnp.maximum(a, 1e-300)
                    step = jnp.clip(1.0 - t_star, 0.0, 1.0)
                    return step * mu + (1 - step) * mu_prev

                def not_converged(_):
                    def do_zero_check(_):
                        ok, mu_z = try_zero(None)
                        # on failure with no valid prev: save prev and retry
                        return (
                            mu_z, mu, jnp.zeros_like(x_new), px_prev,
                            jnp.where(prev_ok, mrn_prev, mrn),
                            jnp.asarray(True), jnp.asarray(True),
                            it + 1, ok,
                        )

                    def do_backtrack(_):
                        mu_b = backtrack(mu)
                        return (
                            mu_b, mu_prev, jnp.zeros_like(x_new), px_prev,
                            mrn_prev, prev_ok, zero_checked, it + 1,
                            jnp.zeros((), bool),
                        )

                    return jax.lax.cond(~zero_checked, do_zero_check,
                                        do_backtrack, None)

                def finish(_):
                    return (mu, mu_prev, jnp.zeros_like(x_new), px_prev,
                            mrn_prev, prev_ok, zero_checked, it + 1,
                            jnp.asarray(True))

                return jax.lax.cond(first_zero | converged, finish,
                                    not_converged, None)

            def newton_branch(_):
                px = jnp.matmul(P, x_new, precision=_PRECISION)
                conv = jnp.abs(jnp.dot(dmu, px_prev - px,
                                       precision=_PRECISION)) / df
                converged = prev_ok & (conv <= tol)

                def finish(_):
                    return (mu, mu_prev, x_new, px, mrn_prev, prev_ok,
                            zero_checked, it + 1, jnp.asarray(True))

                def pn_step(_):
                    # primal Hessian in mu-space (utils.hpp:205-240):
                    # C = x_norm P diag(buf2) P' + l1 kappa x_norm pa pa'
                    buf2 = 1.0 / (buf1 * x_norm + l1)
                    alpha_t = (x_new * buf2) / x_norm
                    kappa = 1.0 / jnp.sum(x_new * buf1 * alpha_t)
                    Pb = P * buf2[None, :]
                    C = x_norm * jnp.matmul(Pb, P.T, precision=_PRECISION)
                    pa = jnp.matmul(P, alpha_t, precision=_PRECISION)
                    C = C + (l1 * kappa * x_norm) * jnp.outer(pa, pa)

                    # variance scale for the pinball tolerance
                    # (utils.hpp:228-239, Woodbury x'S^{-1}x)
                    a2 = jnp.matmul(V.T, x_new, precision=_PRECISION)
                    xy = jnp.sum(x_new * a2)
                    denom = (x_norm * x_norm) / (l1 * kappa) + jnp.sum(
                        x_new * x_new * buf2
                    )
                    var = (jnp.sum(a2 * a2 / buf2) - xy * xy / denom) / x_norm
                    var = jnp.maximum(var, 0.0)

                    grad_pin = px  # pinball invariant: v_p - C mu at entry
                    # penalties are the support function of [lo, hi]:
                    # h(mu) = hi'mu+ + (-lo)'mu-  (both >= 0; the reference
                    # stores _l = -lower, constraint.py:264)
                    mu_n, _, _ = pinball_full(
                        C, -lo, hi, var, mu, grad_pin,
                        pinball_max_iters, pinball_tol,
                    )
                    return (mu_n, mu, x_new, px, mrn, jnp.asarray(True),
                            zero_checked, it + 1, jnp.zeros((), bool))

                return jax.lax.cond(converged, finish, pn_step, None)

            return jax.lax.cond(in_ellipse, ellipse_branch, newton_branch,
                                None)

        init = (
            mu_init, mu_init, x0,
            jnp.zeros((m,), dtype),           # px_prev
            jnp.asarray(jnp.inf, dtype),      # mrn_prev
            jnp.zeros((), bool),              # is_prev_valid
            init_zero,                        # zero_checked (init path ran)
            jnp.zeros((), jnp.int32),
            init_done,
        )
        mu, _, x, _, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)
        x = jnp.where(init_done, jnp.zeros_like(x), x)
        return x, mu

    return jax.lax.cond(v_norm <= l1, trivial, solve)
