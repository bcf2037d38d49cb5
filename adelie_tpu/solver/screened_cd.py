"""Shared screened coordinate-descent engine for the standalone solvers
(BVLS, pinball).

Device re-design of the reference's ``solver_bvls.hpp`` / ``solver_pinball.hpp``
fit loops: instead of O(n) residual touches per coordinate, the screened
columns are gathered once and the CD runs in **covariance form** against a
device-resident Gram (same design as the pin solver, see pin.py).  The whole
fit — screen sweeps, active-set refinement, pruning, loss tracking — is one
jitted device call over fixed-capacity masked buffers; the host only drives
KKT screening rounds (one big matmul each).

``mode``:
* ``"box"``     — BVLS update: ``b <- clip(b + g/d, lower, upper)``; active
  coords are pruned when they sit at a bound (solver_bvls.hpp prune).
* ``"pinball"`` — asymmetric soft-threshold update (solver_pinball.hpp
  coordinate_descent); active coords are pruned at zero.
"""

import functools

import jax
import jax.numpy as jnp

__all__ = ["screened_cd_fit"]


def _update(mode, d, g, b, lo, hi):
    if mode == "box":
        step = jnp.where(d <= 0, 0.0, g / jnp.where(d <= 0, 1.0, d))
        return jnp.clip(b + step, lo, hi)
    # pinball: lo = penalty_neg, hi = penalty_pos
    g0 = g + d * b
    mag = jnp.maximum(jnp.maximum(-lo - g0, g0 - hi), 0.0)
    sgn = jnp.where(g0 + lo >= 0, 1.0, -1.0)
    return jnp.where(d <= 0, b, sgn * mag / jnp.where(d <= 0, 1.0, d))


def _prune(mode, b, lo, hi, active):
    if mode == "box":
        return active & (b > lo) & (b < hi)
    return active & (b != 0)


@functools.partial(jax.jit, static_argnames=("mode",))
def screened_cd_fit(
    Q,            # (S, S) Gram of screened atoms (padded)
    diag,         # (S,) quadratic diagonal (X_vars / ASAT diag), 0 on padding
    beta,         # (S,) current coefficients (relative values allowed)
    grad,         # (S,) current gradients at ``beta``
    lo,           # (S,) lower bounds / penalty_neg
    hi,           # (S,) upper bounds / penalty_pos
    valid,        # (S,) bool slot-validity mask
    is_active,    # (S,) bool
    loss,         # scalar running loss
    tol_scale,    # scalar: convergence when max d*db^2 <= tol_scale
    max_iters,    # int32 cap on total sweeps
    iters0,       # int32 sweeps already consumed (carries across fits)
    mode: str,
):
    """Returns (beta, grad, is_active, loss, iters, converged)."""
    S = beta.shape[0]

    def sweep(carry, active_only):
        beta, grad, act, loss, convg = carry

        def body(i, c):
            beta, grad, act, loss, convg = c
            process = valid[i] & (act[i] if active_only else True)

            def do(args):
                beta, grad, act, loss, convg = args
                d = diag[i]
                g = grad[i]
                b_old = beta[i]
                b_new = _update(mode, d, g, b_old, lo[i], hi[i])
                delta = b_new - b_old

                def apply(a):
                    beta, grad, act, loss, convg = a
                    sd2 = d * delta * delta
                    convg = jnp.maximum(convg, sd2)
                    loss_n = loss - (delta * g - 0.5 * sd2)
                    grad_n = grad - delta * Q[:, i]
                    return (beta.at[i].set(b_new), grad_n,
                            act.at[i].set(True), loss_n, convg)

                return jax.lax.cond(delta != 0.0, apply, lambda a: a,
                                    (beta, grad, act, loss, convg))

            return jax.lax.cond(process, do, lambda a: a,
                                (beta, grad, act, loss, convg))

        return jax.lax.fori_loop(
            0, S, body, (beta, grad, act, loss, jnp.zeros((), beta.dtype))
        )

    def active_loop(beta, grad, act, loss, iters):
        def cond(c):
            _, _, _, _, convg, it = c
            return (convg > tol_scale) & (it < max_iters)

        def body(c):
            beta, grad, act, loss, _, it = c
            beta, grad, act, loss, convg = sweep(
                (beta, grad, act, loss, 0.0), True
            )
            return beta, grad, act, loss, convg, it + 1

        beta, grad, act, loss, convg = sweep((beta, grad, act, loss, 0.0), True)
        beta, grad, act, loss, convg, iters = jax.lax.while_loop(
            cond, body, (beta, grad, act, loss, convg, iters + 1)
        )
        return beta, grad, act, loss, iters

    # fit loop (reference solver_bvls.hpp fit / solver_pinball.hpp fit):
    # screen sweep; if converged: prune+stop; else active loop; prune; repeat
    def outer_cond(c):
        _, _, _, _, it, done = c
        return (~done) & (it < max_iters)

    def outer_body(c):
        beta, grad, act, loss, it, _ = c
        beta, grad, act, loss, convg = sweep((beta, grad, act, loss, 0.0), False)
        it = it + 1
        done = convg <= tol_scale

        def refine(args):
            beta, grad, act, loss, it = args
            return active_loop(beta, grad, act, loss, it)

        beta, grad, act, loss, it = jax.lax.cond(
            done, lambda a: a, refine, (beta, grad, act, loss, it)
        )
        act = _prune(mode, beta, lo, hi, act)
        return beta, grad, act, loss, it, done

    init = (beta, grad, is_active, loss, iters0, jnp.zeros((), bool))
    beta, grad, act, loss, iters, done = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    return beta, grad, act, loss, iters, done
