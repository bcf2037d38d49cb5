"""Small dense QP solvers and scalar optimization utilities.

Device re-implementation of the reference's ``optimization/`` layer
(``adelie/src/include/adelie_core/optimization/``):

* :func:`pinball_full`  — asymmetric-penalty LS CD
  (reference ``pinball_full.hpp`` ``StatePinballFull::solve``),
* :func:`nnqp_full`     — non-negative QP CD (reference ``nnqp_full.hpp``),
* :func:`lasso_full`    — L1-penalized QP CD (reference ``lasso_full.hpp``),
* :func:`nnls`          — non-negative least squares via the same CD rule
  (reference ``nnls.hpp`` ``StateNNLS``; the full screening/violation
  machinery is unnecessary here because the operands are small dense
  blocks that stay on chip),
* :func:`search_pivot`  — piecewise-linear pivot search
  (reference ``search_pivot.hpp:6-63``),
* :func:`symmetric_penalty` — exact minimizer of the symmetric
  quadratic+abs penalty over sorted knots
  (reference ``symmetric_penalty.hpp:15-100``).

The CD solvers are pure-JAX and jittable (``lax.while_loop`` over sweeps,
``lax.fori_loop`` over coordinates) — they are invoked per-group inside
constraint solves where ``d`` is a group size (small), so everything stays
on chip.  They take and return functional ``(x, grad)`` pairs, where
``grad`` is the *residualized* gradient ``v - Q x`` maintained incrementally
exactly like the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pinball_full",
    "nnqp_full",
    "lasso_full",
    "nnls",
    "linqp_full",
    "search_pivot",
    "symmetric_penalty",
    "brent",
    "bisect",
]


def brent(f, a, b, *, x_tol=1e-12, y_tol=1e-12, max_iters=1000):
    """Brent's-method scalar root find on ``[a, b]``.

    Host-side mirror of the reference's ``optimization/bisect.hpp brent``
    (:12-103) — inverse-quadratic/secant steps with bisection-fallback
    guards — for arbitrary Python scalar functions.  (The jittable variant
    used inside solvers is ``adelie_tpu.bcd.brent_root_scalar``.)
    Returns (sol, iters).
    """
    a, b = float(a), float(b)
    fa, fb = float(f(a)), float(f(b))
    if abs(fa) < abs(fb):
        a, b, fa, fb = b, a, fb, fa
    c, fc = a, fa
    d = c
    do_bisect = True
    for it in range(int(max_iters)):
        if abs(b - a) <= x_tol or abs(fb) <= 2 * y_tol:
            return b, it
        if abs(fa - fc) > y_tol and abs(fb - fc) > y_tol:
            s = (
                a * fb * fc / ((fa - fb) * (fa - fc))
                + b * fa * fc / ((fb - fa) * (fb - fc))
                + c * fa * fb / ((fc - fa) * (fc - fb))
            )
        else:
            s = b - fb * (b - a) / (fb - fa)
        delta = abs(2 * x_tol * abs(b))
        min1, min2, min3 = abs(s - b), abs(b - c), abs(c - d)
        if (
            (s < 0.25 * (3 * a + b) and s > b)
            or (do_bisect and min1 >= min2 * 0.5)
            or (not do_bisect and min1 >= min3 * 0.5)
            or (do_bisect and min2 < delta)
            or (not do_bisect and min3 < delta)
        ):
            s = 0.5 * (a + b)
            do_bisect = True
        else:
            do_bisect = False
        fs = float(f(s))
        if abs(fs) < y_tol:
            return s, it + 1
        d = c
        c, fc = b, fb
        if fs * fa < 0:
            b, fb = s, fs
        else:
            a, fa = s, fs
        if abs(fa) < abs(fb):
            a, b, fa, fb = b, a, fb, fa
    return b, int(max_iters)


# the reference names the file bisect.hpp; keep both spellings callable
bisect = brent


def _cd_full(quad, x, grad, update_rule, max_iters, tol, scale):
    """Cyclic CD over all coordinates of a small dense QP.

    ``update_rule(i, qii, gi, xi) -> xi_new``; convergence when
    ``max_i qii (dx_i)^2 < scale * tol`` (reference convention).
    """
    d = x.shape[0]

    def coord(i, carry):
        x, grad, convg = carry
        qii = quad[i, i]
        gi = grad[i]
        xi_old = x[i]
        xi_new = update_rule(i, qii, gi, xi_old)
        delta = xi_new - xi_old

        def apply(args):
            x, grad, convg = args
            x = x.at[i].set(xi_new)
            grad = grad - delta * quad[i]
            convg = jnp.maximum(convg, qii * delta * delta)
            return x, grad, convg

        return jax.lax.cond(delta != 0.0, apply, lambda a: a, (x, grad, convg))

    def sweep_cond(carry):
        _, _, convg, it = carry
        return (convg >= scale * tol) & (it < max_iters)

    def sweep_body(carry):
        x, grad, _, it = carry
        x, grad, convg = jax.lax.fori_loop(
            0, d, coord, (x, grad, jnp.zeros((), x.dtype))
        )
        return x, grad, convg, it + 1

    x, grad, convg = jax.lax.fori_loop(0, d, coord, (x, grad, jnp.zeros((), x.dtype)))
    x, grad, convg, iters = jax.lax.while_loop(
        sweep_cond, sweep_body, (x, grad, convg, jnp.ones((), jnp.int32))
    )
    return x, grad, iters


@functools.partial(jax.jit, static_argnames=("max_iters",))
def pinball_full(quad, penalty_neg, penalty_pos, y_var, x, grad,
                 max_iters: int = 100000, tol=1e-7):
    """Asymmetric-penalty LS: min_x 1/2 x'Qx - v'x + l'x_- + u'x_+.

    ``grad`` must be initialized to ``v - Q x``.  Reference
    ``pinball_full.hpp`` coordinate update: with ``g0 = g_i + Q_ii x_i``,

        x_i <- copysign(max(max(-pn_i - g0, g0 - pp_i), 0), g0 + pn_i) / Q_ii
    """
    quad = jnp.asarray(quad)
    pn = jnp.asarray(penalty_neg)
    pp = jnp.asarray(penalty_pos)

    def rule(i, qii, gi, xi):
        g0 = gi + qii * xi
        mag = jnp.maximum(jnp.maximum(-pn[i] - g0, g0 - pp[i]), 0.0)
        val = jnp.sign(g0 + pn[i]) * mag + (g0 + pn[i] == 0) * mag
        return jnp.where(qii <= 0, xi, val / jnp.where(qii <= 0, 1.0, qii))

    return _cd_full(quad, x, grad, rule, max_iters, tol, y_var)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def nnqp_full(quad, x, grad, max_iters: int = 100000, tol=1e-7):
    """Non-negative QP: min_x 1/2 x'Qx - v'x  s.t. x >= 0.

    ``grad = v - Q x``.  Reference ``nnqp_full.hpp``: projected exact
    coordinate minimization; convergence scaled by d (:93).
    """
    quad = jnp.asarray(quad)
    d = x.shape[0]

    def rule(i, qii, gi, xi):
        step = jnp.where(qii <= 0, 0.0, gi / jnp.where(qii <= 0, 1.0, qii))
        return jnp.maximum(xi + step, 0.0)

    return _cd_full(quad, x, grad, rule, max_iters, tol, jnp.asarray(float(d), x.dtype))


@functools.partial(jax.jit, static_argnames=("max_iters",))
def lasso_full(quad, penalty, x, grad, max_iters: int = 100000, tol=1e-7):
    """L1 QP: min_x 1/2 x'Qx - v'x + sum_i p_i |x_i| (reference lasso_full.hpp).

    ``grad = v - Q x``; convergence scaled by d.
    """
    quad = jnp.asarray(quad)
    pen = jnp.asarray(penalty)
    d = x.shape[0]

    def rule(i, qii, gi, xi):
        g0 = gi + qii * xi
        val = jnp.sign(g0) * jnp.maximum(jnp.abs(g0) - pen[i], 0.0)
        return jnp.where(qii <= 0, xi, val / jnp.where(qii <= 0, 1.0, qii))

    return _cd_full(quad, x, grad, rule, max_iters, tol, jnp.asarray(float(d), x.dtype))


@functools.partial(jax.jit, static_argnames=("max_iters",))
def nnls(AtA, Atb, x, max_iters: int = 100000, tol=1e-9):
    """Dense NNLS in covariance form: min_x 1/2 x'(A'A)x - (A'b)'x, x >= 0.

    device-native replacement for the reference's screened ``StateNNLS``
    (optimization/nnls.hpp) — operands here are small per-group blocks, so a
    plain device CD loop beats screening bookkeeping.  Returns (x, grad,
    iters) with ``grad = Atb - AtA x``.
    """
    grad = jnp.asarray(Atb) - jnp.asarray(AtA) @ x
    return nnqp_full(AtA, x, grad, max_iters=max_iters, tol=tol)


def search_pivot(x, y):
    """Least-squares pivot search (reference search_pivot.hpp:6-63).

    Host-side numpy (used by the BASIL screen rule on G-sized arrays).
    Returns (argmin index, mses).
    """
    from .solver.basil import search_pivot as _impl

    return _impl(x, y)


def symmetric_penalty(knots, alpha):
    """argmin_t mean((t - knots)^2)/2 * (1-alpha) + alpha * mean|t - knots|.

    Exact minimizer over the knot intervals (reference
    symmetric_penalty.hpp:15-100).  ``knots`` must be sorted ascending.
    Host-side numpy — this is a scalar utility used for tie-breaking.
    """
    knots = np.asarray(knots, np.float64)
    if knots.ndim != 1:
        raise ValueError(
            f"knots must be a 1-D sorted array; got shape {knots.shape}."
        )
    K = knots.size
    if K <= 0:
        return 0.0
    med = 0.5 * (knots[K // 2 - 1] + knots[K // 2]) if K % 2 == 0 else knots[K // 2]
    if alpha >= 1:
        return float(med)
    mean = knots.mean()
    if alpha <= 0:
        return float(mean)
    a_left = min(med, mean)
    a_right = max(med, mean)
    if a_right <= a_left:
        return float(a_left)

    a_begin = int(np.searchsorted(knots, a_left, side="left"))
    a_end = int(np.searchsorted(knots, a_right, side="left"))

    sq_mean = float((knots**2).mean())
    alpha_ratio = alpha / (1 - alpha)

    def quad_min(i, lower, upper, partial_mean):
        t_star = mean + alpha_ratio * (1 - 2 * i / K)
        argmin = lower if t_star <= lower else (t_star if t_star <= upper else upper)
        f_min = argmin * (argmin - 2 * t_star) + sq_mean + 2 * alpha_ratio * partial_mean
        return argmin, f_min

    partial_mean = mean - 2 * knots[:a_begin].sum() / K
    argmin, f_min = quad_min(a_begin, a_left, knots[a_begin], partial_mean)

    for i in range(a_begin + 1, a_end):
        partial_mean -= 2 * knots[i - 1] / K
        curr_argmin, curr_f_min = quad_min(i, knots[i - 1], knots[i], partial_mean)
        if curr_f_min > f_min:
            return float(argmin)
        argmin, f_min = curr_argmin, curr_f_min

    partial_mean -= 2 * knots[a_end - 1] / K
    curr_argmin, curr_f_min = quad_min(a_end, knots[a_end - 1], a_right, partial_mean)
    if curr_f_min <= f_min:
        argmin = curr_argmin
    return float(argmin)


def linqp_full(quad, linear, A, lower, upper, *, x0=None,
               lmda_max=1e-1, lmda_min=1e-7, lmda_path_size=20,
               max_iters: int = 10000, tol=1e-9, relaxed_tol=1e-6,
               slack=1e-4):
    """Linear-inequality QP via a log-barrier Newton path (reference
    optimization/linqp_full.hpp):

        min_x 1/2 x'Qx - v'x   s.t.  -lower <= A x <= upper

    with the barrier weight annealed from ``lmda_max`` to ``lmda_min``.
    Host-side numpy (a small dense QP utility, as in the reference, where
    it backs ConstraintLinear experiments).  Returns (x, iters).
    """
    Q = np.asarray(quad, np.float64)
    v = np.asarray(linear, np.float64)
    A = np.asarray(A, np.float64)
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    m, d = A.shape

    if x0 is None:
        x = np.zeros(d)
    else:
        x = np.asarray(x0, np.float64).copy()
    Ax = A @ x
    assert np.all(Ax < upper) and np.all(Ax > -lower), \
        "x0 must be strictly feasible"

    min_ratio = lmda_min / lmda_max
    lmda_factor = min_ratio ** (1.0 / max(lmda_path_size - 1, 1))
    lmda = lmda_max
    iters = 0

    for i in range(lmda_path_size):
        _tol = relaxed_tol if i + 1 < lmda_path_size else tol
        prev = None
        while iters < max_iters:
            g_bar = (1.0 / (upper - Ax) - 1.0 / (Ax + lower)) @ A
            grad = Q @ x - v + (lmda / m) * g_bar
            if prev is not None:
                x_prev, grad_prev = prev
                if abs(np.mean((x - x_prev) * (grad - grad_prev))) <= _tol:
                    break
            x_prev, Ax_prev, grad_prev = x.copy(), Ax.copy(), grad.copy()
            prev = (x_prev, grad_prev)

            D = (lmda / m) * (1.0 / (upper - Ax) ** 2 + 1.0 / (Ax + lower) ** 2)
            hess = A.T @ (D[:, None] * A) + Q
            x = x - np.linalg.solve(hess, grad)
            Ax = A @ x
            # backtrack to strict feasibility (reference :133-147)
            while np.any(Ax >= upper) or np.any(Ax <= -lower):
                step = (1 - slack) * max(min(np.min(
                    np.minimum(upper - Ax_prev, lower + Ax_prev)
                    / np.maximum(np.abs(Ax - Ax_prev), _tol)
                ), 1.0), 0.0)
                x = x_prev + step * (x - x_prev)
                Ax = Ax_prev + step * (Ax - Ax_prev)
            iters += 1
        lmda *= lmda_factor
    return x, iters
