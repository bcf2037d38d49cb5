"""Block-coordinate-descent group-update solvers.

Solves the (eigenbasis-rotated) group elastic-net block update

    minimize_x  1/2 x' diag(L) x - v' x + l1 ||x||_2 + l2/2 ||x||_2^2

with ``L >= 0`` diagonal.  This is a device-native (pure-JAX, jittable,
mask-safe) re-implementation of the math in the reference's
``adelie/src/include/adelie_core/bcd/unconstrained/newton.hpp`` (solution
structure at :44-111) and ``bcd/utils.hpp`` (root function and bounds):

* ``x = 0`` iff ``||v||_2 <= l1``.
* If ``l1 == 0``: closed form ``x = v / (L + l2)``.
* Otherwise ``x_i = h * v_i / ((L_i + l2) h + l1)`` where ``h = ||x||_2``
  is the root of ``phi(h) = sum_i v_i^2 / ((L_i + l2) h + l1)^2 - 1``.

The root is found by adaptive bisection to land at ``phi(h) >= 0`` followed
by guarded Newton (the reference's default "newton_abs" strategy,
newton.hpp:213-260).  ``phi`` is convex and decreasing on ``h >= 0`` so
Newton from the left converges monotonically.

All functions are shape-polymorphic over a trailing group dimension and are
safe on masked/padded lanes (entries with ``v_i == 0`` and ``L_i == 0``
contribute nothing and produce ``x_i == 0``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "root_function",
    "root_lower_bound",
    "root_upper_bound",
    "objective",
    "root",
    "solve",
    "newton_solver",
]


def _root_function(h, quad, linear, l1):
    return jnp.sum(linear**2 / (quad * h + l1) ** 2) - 1.0


def _root_lower_bound(buf1, v, l1):
    """Largest h with phi(h) >= 0 guaranteed, from the quadratic minorant.

    Reference: bcd/utils.hpp root_lower_bound — solves
    a h^2 + 2 b h + c <= 0 with a = ||b1||^2, b = l1 * sum(b1),
    c = l1^2 p - ||v||_1^2.
    """
    b = l1 * jnp.sum(buf1)
    a = jnp.sum(buf1 * buf1)
    v_l1 = jnp.sum(jnp.abs(v))
    c = l1 * l1 * _masked_size(v) - v_l1 * v_l1
    discr = b * b - a * c
    h_min = jnp.where(
        discr > -1e-12,
        (-b + jnp.sqrt(jnp.maximum(discr, 0.0))) / jnp.maximum(a, _tiny(a.dtype)),
        0.0,
    )
    return jnp.maximum(h_min, 0.0)


def _masked_size(v):
    # Number of "real" lanes.  For padded lanes both v and L are zero; the
    # reference uses the vector length p in the lower bound, which is only a
    # bound, so counting nonzero-v lanes keeps it a valid (tighter) bound.
    return jnp.maximum(jnp.sum((v != 0).astype(v.dtype)), 1.0)


def _tiny(dtype):
    return jnp.asarray(np.finfo(np.dtype(dtype)).tiny * 1e8, dtype)


def _root_upper_bound(buf1, v, l1, zero_tol=1e-14):
    """h_max with phi(h_max) <= 0 (approximately, when zero eigenvalues).

    Reference: bcd/utils.hpp root_upper_bound.  Returns (h_max, min nonzero
    entry of buf1).
    """
    is_nonzero = buf1 > zero_tol
    safe = jnp.where(is_nonzero, buf1, 1.0)
    vi2 = v * v
    h_max_zero_path = jnp.sum(jnp.where(is_nonzero, vi2 / (safe * safe), 0.0))
    v_S = jnp.sum(jnp.where(buf1 <= 0, vi2, 0.0))
    denom = 1.0 - v_S / (l1 * l1)
    h_max_zero_path = jnp.sqrt(
        jnp.maximum(h_max_zero_path / jnp.where(denom > 0, denom, 1.0), 0.0)
    )
    min_nnz = jnp.min(jnp.where(is_nonzero, buf1, jnp.inf))
    min_nnz = jnp.where(jnp.isfinite(min_nnz), min_nnz, 1.0)
    return h_max_zero_path, min_nnz


def _newton_phase(buf1, v, l1, h0, tol, max_iters):
    """Guarded Newton on phi from initial ``h0`` (newton.hpp
    newton_solver_base step_f).  phi is convex decreasing on h >= 0, so
    Newton from the left converges monotonically."""
    dtype = v.dtype

    def step(h):
        inv = 1.0 / (buf1 * h + l1)
        sq = (v * inv) ** 2
        t = jnp.sum(sq)
        sqrt_t = jnp.sqrt(t)
        fh = t - 1.0
        dfh = -jnp.sum(sq * buf1 * inv) * (1 + sqrt_t) / jnp.maximum(t, _tiny(dtype))
        return fh, dfh

    def newton_cond(carry):
        h, fh, dfh, it = carry
        return (jnp.abs(fh) > tol) & (it < max_iters)

    def newton_body(carry):
        h, fh, dfh, it = carry
        h = jnp.maximum(h - fh / dfh, 0.0)
        fh, dfh = step(h)
        return h, fh, dfh, it + 1

    fh0, dfh0 = step(h0)
    h, fh, dfh, iters = jax.lax.while_loop(
        newton_cond, newton_body, (h0, fh0, dfh0, jnp.int32(0))
    )
    return h, iters


def _newton_abs_init(buf1, v, l1, tol):
    """Adaptive-bisection initializer (newton.hpp:213-260): walk from h_max
    toward h_min until phi(h) >= 0 so Newton starts left of the root."""
    h_min = _root_lower_bound(buf1, v, l1)
    h_max, min_nnz = _root_upper_bound(buf1, v, l1)

    def ada_cond(carry):
        h_cand, fh, it = carry
        return (fh < 0) & (jnp.abs(fh) > tol) & (it < 100)

    def ada_body(carry):
        h_cand, _, it = carry
        w = jnp.maximum(l1 / (min_nnz * h_cand + l1), 0.05)
        h_new = w * h_min + (1 - w) * h_cand
        return h_new, _root_function(h_new, buf1, v, l1), it + 1

    small_range = (h_max - h_min) <= 1e-1

    def init_small():
        return h_min

    def init_ada():
        h0 = jnp.maximum(h_max, h_min)
        w = jnp.maximum(l1 / (min_nnz * h0 + l1), 0.05)
        h1 = w * h_min + (1 - w) * h0
        f1 = _root_function(h1, buf1, v, l1)
        h, _, _ = jax.lax.while_loop(ada_cond, ada_body, (h1, f1, jnp.int32(1)))
        return h

    return jax.lax.cond(small_range, init_small, init_ada)


def _newton_abs_root(buf1, v, l1, tol, max_iters):
    """Adaptive-bisection + Newton root find for phi (newton.hpp:213-260).

    Returns (h, iters).  Assumes ||v|| > l1 > 0.  Jittable; scalar h.
    """
    h = _newton_abs_init(buf1, v, l1, tol)
    return _newton_phase(buf1, v, l1, h, tol, max_iters)


def brent_root_scalar(f, a, b, x_tol, y_tol, max_iters):
    """Jittable Brent's method on a scalar function over bracket [a, b].

    Faithful re-implementation of the reference's
    ``optimization/bisect.hpp brent`` (:12-103): inverse-quadratic /
    secant steps with the bisection fallback guards; the loop carries the
    reference's (a, b, c, d, do_bisect) state and freezes once the
    x-interval or |f(b)| tolerance is met.  Returns (sol, iters).
    """
    dtype = jnp.result_type(a, b)
    a = jnp.asarray(a, dtype)
    b = jnp.asarray(b, dtype)
    fa = f(a)
    fb = f(b)
    swap = jnp.abs(fa) < jnp.abs(fb)
    a, b = jnp.where(swap, b, a), jnp.where(swap, a, b)
    fa, fb = jnp.where(swap, fb, fa), jnp.where(swap, fa, fb)
    c, fc = a, fa
    d = c

    def cond(carry):
        a, fa, b, fb, c, fc, d, do_bisect, it, done = carry
        return (~done) & (it < max_iters)

    def body(carry):
        a, fa, b, fb, c, fc, d, do_bisect, it, done = carry
        stop = (jnp.abs(b - a) <= x_tol) | (jnp.abs(fb) <= 2 * y_tol)

        # inverse quadratic interpolation when all three f-values distinct,
        # else secant (reference :53-61)
        use_iqi = (jnp.abs(fa - fc) > y_tol) & (jnp.abs(fb - fc) > y_tol)
        s_iqi = (
            a * fb * fc / ((fa - fb) * (fa - fc))
            + b * fa * fc / ((fb - fa) * (fb - fc))
            + c * fa * fb / ((fc - fa) * (fc - fb))
        )
        s_sec = b - fb * (b - a) / (fb - fa)
        s = jnp.where(use_iqi, s_iqi, s_sec)

        delta = jnp.abs(2 * x_tol * jnp.abs(b))
        min1 = jnp.abs(s - b)
        min2 = jnp.abs(b - c)
        min3 = jnp.abs(c - d)
        bad = (
            ((s < 0.25 * (3 * a + b)) & (s > b))
            | (do_bisect & (min1 >= min2 * 0.5))
            | ((~do_bisect) & (min1 >= min3 * 0.5))
            | (do_bisect & (min2 < delta))
            | ((~do_bisect) & (min3 < delta))
        )
        s = jnp.where(bad, 0.5 * (a + b), s)
        do_bisect_n = bad

        fs = f(s)
        found = jnp.abs(fs) < y_tol

        d_n = c
        c_n, fc_n = b, fb
        opp = fs * fa < 0
        b_n = jnp.where(opp, s, b)
        fb_n = jnp.where(opp, fs, fb)
        a_n = jnp.where(opp, a, s)
        fa_n = jnp.where(opp, fa, fs)
        swap = jnp.abs(fa_n) < jnp.abs(fb_n)
        a_n, b_n = jnp.where(swap, b_n, a_n), jnp.where(swap, a_n, b_n)
        fa_n, fb_n = jnp.where(swap, fb_n, fa_n), jnp.where(swap, fa_n, fb_n)

        # when found, expose s as the solution via b
        b_n = jnp.where(found, s, b_n)

        def frozen():
            return a, fa, b, fb, c, fc, d, do_bisect, it, jnp.asarray(True)

        def stepped():
            return (a_n, fa_n, b_n, fb_n, c_n, fc_n, d_n, do_bisect_n,
                    it + 1, found)

        return jax.lax.cond(stop, frozen, stepped)

    init = (a, fa, b, fb, c, fc, d, jnp.asarray(True), jnp.int32(0),
            jnp.asarray(False))
    a, fa, b, fb, c, fc, d, _, iters, _ = jax.lax.while_loop(cond, body, init)
    return b, iters


def _brent_root(buf1, v, l1, tol, max_iters):
    """Brent bracketing root find for phi (reference brent.hpp:11-36):
    bracket [root_lower_bound, root_upper_bound(zero_tol=0)]."""
    h_min = _root_lower_bound(buf1, v, l1)
    h_max, _ = _root_upper_bound(buf1, v, l1, zero_tol=0.0)
    h_max = jnp.maximum(h_max, h_min)
    return brent_root_scalar(
        lambda h: _root_function(h, buf1, v, l1),
        h_min, h_max, tol, tol, max_iters,
    )


def newton_solver(L, v, l1, l2, tol=1e-12, max_iters=1000, method="newton_abs"):
    """Solve the block update; returns (x, iters).

    Jittable.  ``L``/``v`` are (q,) arrays; padded lanes must have
    ``L == 0`` and ``v == 0`` and then get ``x == 0``.

    ``method`` selects the 1-D root strategy (reference
    bcd/unconstrained/{newton.hpp, brent.hpp}):
      - ``newton``: vanilla guarded Newton from h=0 (newton.hpp:124)
      - ``newton_abs``: adaptive bisection init + Newton (newton.hpp:213)
      - ``newton_brent``: Brent init to tolerance, Newton polish
        (newton.hpp:155)
      - ``brent``: pure Brent bracketing (brent.hpp:11)
    """
    from .utils import types

    method = types.newton_method(method, param="method")
    L = jnp.asarray(L)
    v = jnp.asarray(v)
    dtype = v.dtype
    l1 = jnp.asarray(l1, dtype)
    l2 = jnp.asarray(l2, dtype)
    buf1 = L + l2
    v_norm = jnp.sqrt(jnp.sum(v * v))

    def zero_case():
        return jnp.zeros_like(v), jnp.int32(0)

    def ridge_case():
        # l1 == 0 closed form; guard 0/0 on padded or degenerate lanes.
        x = jnp.where(v != 0, v / jnp.where(buf1 != 0, buf1, 1.0), 0.0)
        return x, jnp.int32(0)

    def general_case():
        if method == "newton_abs":
            h, iters = _newton_abs_root(buf1, v, l1, tol, max_iters)
        elif method == "newton":
            h, iters = _newton_phase(
                buf1, v, l1, jnp.zeros((), dtype), tol, max_iters
            )
        elif method == "newton_brent":
            h0, it0 = _brent_root(buf1, v, l1, tol, max_iters)
            h, it1 = _newton_phase(buf1, v, l1, h0, tol, max_iters)
            iters = it0 + it1
        elif method == "brent":
            h, iters = _brent_root(buf1, v, l1, tol, max_iters)
        else:
            raise ValueError(f"Unknown newton method: {method}")
        x = h * v / (buf1 * h + l1)
        return x, iters

    return jax.lax.cond(
        v_norm <= l1,
        zero_case,
        lambda: jax.lax.cond(l1 <= 0, ridge_case, general_case),
    )


# ----------------------------------------------------------------------------
# Public API mirroring adelie.bcd (reference adelie/bcd.py)
# ----------------------------------------------------------------------------


def root_function(h, *, quad, linear, l1):
    """phi(h) = sum v_i^2 / (Sigma_ii h + l1)^2 - 1 (reference bcd.py:81)."""
    quad = jnp.asarray(quad)
    return float(
        _root_function(
            jnp.asarray(h, quad.dtype), quad, jnp.asarray(linear), jnp.asarray(l1)
        )
    )


def root_lower_bound(*, quad, linear, l1):
    """Lower bound on the root of phi (reference bcd.py:5)."""
    quad = jnp.asarray(quad)
    return float(_root_lower_bound(quad, jnp.asarray(linear), jnp.asarray(l1)))


def root_upper_bound(*, quad, linear, l1, zero_tol=1e-14):
    """Upper bound on the root of phi (reference bcd.py:40)."""
    h, _ = _root_upper_bound(
        jnp.asarray(quad), jnp.asarray(linear), jnp.asarray(l1), zero_tol
    )
    return float(h)


def objective(beta, *, quad, linear, l1, l2):
    """1/2 b'Sb - v'b + l1||b|| + l2/2||b||^2 (reference bcd.py:123)."""
    beta = jnp.asarray(beta)
    quad = jnp.asarray(quad)
    linear = jnp.asarray(linear)
    norm = jnp.sqrt(jnp.sum(beta * beta))
    return float(
        0.5 * jnp.sum(quad * beta * beta)
        - jnp.sum(linear * beta)
        + l1 * norm
        + 0.5 * l2 * jnp.sum(beta * beta)
    )


@functools.partial(jax.jit, static_argnames=("max_iters", "method"))
def _solve_jit(quad, linear, l1, l2, tol, max_iters, method="newton_abs"):
    return newton_solver(quad, linear, l1, l2, tol, max_iters, method)


def root(*, quad, linear, l1, l2=0.0, tol=1e-12, max_iters=1000):
    """Root ||x||_2 of the solved block update (reference bcd.py:264)."""
    x, _ = _solve_jit(
        jnp.asarray(quad), jnp.asarray(linear), l1, l2, tol, int(max_iters)
    )
    return float(jnp.sqrt(jnp.sum(x * x)))


@functools.partial(jax.jit, static_argnames=("max_iters", "accel", "adares"))
def _ista_jit(quad, linear, l1, l2, tol, max_iters, accel, adares):
    """(F)ISTA on the block update (reference bcd/unconstrained/ista.hpp:
    10-94): proximal gradient with step 1/L, L = max(quad) + l2; the prox of
    l1||.||_2 is the group soft-threshold.  ``accel`` adds Nesterov
    momentum; ``adares`` adds adaptive restart (momentum reset when the
    update opposes the velocity)."""
    q = quad + l2
    L = jnp.maximum(jnp.max(q), 1e-30)
    t = 1.0 / L

    def prox(u):
        nrm = jnp.sqrt(jnp.sum(u * u))
        scale = jnp.maximum(1.0 - t * l1 / jnp.maximum(nrm, 1e-300), 0.0)
        return scale * u

    def body(carry):
        x, z, s, it, _ = carry
        g = q * z - linear
        x_new = prox(z - t * g)
        s_new = 0.5 * (1 + jnp.sqrt(1 + 4 * s * s)) if accel else s
        mom = ((s - 1) / s_new) if accel else 0.0
        if adares:
            restart = jnp.sum((z - x_new) * (x_new - x)) > 0
            mom = jnp.where(restart, 0.0, mom)
            s_new = jnp.where(restart, 1.0, s_new)
        z_new = x_new + mom * (x_new - x) if accel else x_new
        diff = jnp.max(jnp.abs(x_new - x))
        return x_new, z_new, s_new, it + 1, diff

    def cond(carry):
        _, _, _, it, diff = carry
        return (diff > tol) & (it < max_iters)

    x0 = jnp.zeros_like(linear)
    init = (x0, x0, jnp.asarray(1.0, linear.dtype), jnp.int32(0),
            jnp.asarray(jnp.inf, linear.dtype))
    x, _, _, iters, _ = jax.lax.while_loop(cond, body, init)
    return x, iters


def solve(
    *,
    quad,
    linear,
    l1,
    l2,
    tol: float = 1e-12,
    max_iters: int = 1000,
    solver: str = "newton_abs",
):
    """Solve the BCD update (reference bcd.py:182, solver list :40-49).

    Strategies: the Newton family (``newton`` vanilla, ``newton_abs``
    adaptive-bisection+Newton, ``newton_brent`` Brent-init+Newton,
    ``brent`` pure bracketing — distinct root strategies matching
    reference newton.hpp:124,213,155 and brent.hpp:11) and the
    proximal-gradient family (``ista``, ``fista``, ``fista_adares``).

    Returns a dict with ``beta``, ``iters``.
    """
    from .utils import types

    solver = types.bcd_solver(solver, param="solver")
    quad = jnp.asarray(quad)
    linear = jnp.asarray(linear)
    if solver in ("ista", "fista", "fista_adares"):
        x, iters = _ista_jit(
            quad, linear,
            jnp.asarray(l1, linear.dtype), jnp.asarray(l2, linear.dtype),
            jnp.asarray(tol, linear.dtype), int(max_iters),
            solver != "ista", solver == "fista_adares",
        )
    elif solver in ("newton", "newton_abs", "newton_brent", "brent"):
        x, iters = _solve_jit(
            quad, linear, l1, l2, tol, int(max_iters), solver
        )
    else:
        raise ValueError(f"Unknown solver: {solver}")
    return {"beta": np.asarray(x), "iters": int(iters)}
