"""Per-group convex constraints (reference adelie/constraint.py,
adelie/src/include/adelie_core/constraint/).

The reference solves the constrained BCD block update with a proximal
Newton method on the dual (constraint/utils.hpp solve_proximal_newton) with
pinball/NNLS inner solvers.  The device-native design here uses **ADMM** on
the primal instead (the reference itself ships an ADMM variant for
one-sided constraints, constraint_one_sided.ipp:300-460): every constraint
is expressed as an interval constraint  ``lo <= A Q x <= hi``  on the
eigenbasis coefficients ``x``, and the ADMM x-update is the *unconstrained*
group-elastic-net update — our existing jittable Newton solver — in the
eigenbasis of ``H = diag(quad) + rho (AQ)'(AQ)``.  Everything is pure JAX
with ``lax.while_loop``: the same code runs standalone and inside the
jitted constrained CD sweep (solver/pin.py).

Interface (mirrors ConstraintBase, constraint_base.hpp:19-83):

* ``solve(x, quad, linear, l1, l2, Q) -> (x, mu)`` — constrained block
  update; ``quad`` = eigenvalues, ``linear`` = eigenbasis gradient
  ``g + quad * x``, ``Q`` = eigenvector matrix (primal is ``Q x``).
* ``solve_zero(v) -> (norm, mu)`` — min over feasible duals of
  ``||v - A' mu||_2`` (used by KKT screening on non-screen groups).
* ``gradient(x, mu) -> A' mu``; ``project(x)``; ``duals()``/``primals()``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..bcd import newton_solver
from ..configs import configs

__all__ = [
    "ConstraintBase",
    "ConstraintBox",
    "ConstraintOneSided",
    "ConstraintLinear",
    "box",
    "lower",
    "upper",
    "one_sided",
    "linear",
    "admm_block_solve",
]


# --------------------------------------------------------------------------- #
# the ADMM block solver (jittable)                                             #
# --------------------------------------------------------------------------- #


@functools.partial(jax.jit, static_argnames=("max_iters", "newton_max_iters"))
def admm_block_solve(
    P,          # (m, d) = A @ Q
    D,          # (d,) eigenvalues of H = diag(quad) + rho P'P
    U,          # (d, d) eigenvectors of H
    v,          # (d,) linear term (eigenbasis)
    l1, l2,     # scalars
    lo, hi,     # (m,) interval bounds on z = P x
    x0,         # (d,) warm start (eigenbasis)
    mu0,        # (m,) dual warm start
    rho,
    tol_abs=1e-9,
    tol_rel=1e-9,
    max_iters: int = 10000,
    newton_tol=1e-12,
    newton_max_iters: int = 1000,
):
    """ADMM for  min 1/2 x'diag(quad)x - v'x + l1||x|| + l2/2||x||^2
    s.t. lo <= P x <= hi.   Returns (x, mu, iters, converged).

    The x-update quadratic ``H + l2 I`` is diagonalized by the
    precomputed ``(D, U)`` (rho-scaled constraint curvature folded in), so
    each x-update is one rotation + 1-D Newton root find + rotation.
    """
    m = P.shape[0]
    d = P.shape[1]
    dtype = v.dtype
    sqm = jnp.sqrt(jnp.asarray(float(m), dtype))
    sqd = jnp.sqrt(jnp.asarray(float(d), dtype))

    def xupdate(z, u):
        c = v + rho * (P.T @ (z - u))
        ct = U.T @ c
        xt, _ = newton_solver(D, ct, l1, l2, newton_tol, newton_max_iters)
        return U @ xt

    Px0 = P @ x0
    z0 = jnp.clip(Px0, lo, hi)
    u0 = mu0 / rho

    def cond(carry):
        _, _, _, it, done = carry
        return (~done) & (it < max_iters)

    def body(carry):
        x, z, u, it, _ = carry
        x = xupdate(z, u)
        Px = P @ x
        z_new = jnp.clip(Px + u, lo, hi)
        u = u + Px - z_new
        r_norm = jnp.linalg.norm(Px - z_new)
        s_norm = rho * jnp.linalg.norm(P.T @ (z_new - z))
        eps_pri = sqm * tol_abs + tol_rel * jnp.maximum(
            jnp.linalg.norm(Px), jnp.linalg.norm(z_new)
        )
        eps_dual = sqd * tol_abs + tol_rel * rho * jnp.linalg.norm(P.T @ u)
        done = (r_norm <= eps_pri) & (s_norm <= eps_dual)
        return x, z_new, u, it + 1, done

    x, z, u, iters, done = jax.lax.while_loop(
        cond, body, (x0, z0, u0, jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    )
    return x, rho * u, iters, done


# --------------------------------------------------------------------------- #
# constraint classes                                                           #
# --------------------------------------------------------------------------- #


class ConstraintBase:
    """Abstract per-group constraint ``lo <= A beta <= hi`` where ``beta``
    is the group's coefficient block in the ORIGINAL basis."""

    def __init__(self, m, d, dtype, rho=1.0, max_iters=None,
                 tol=1e-9, newton_tol=1e-12, newton_max_iters=1000,
                 method="proximal_newton", slack=1e-4,
                 nnls_max_iters=100000, nnls_tol=1e-7,
                 pinball_max_iters=100000, pinball_tol=1e-7):
        from ..utils import types

        method = types.constraint_method(method, param="method")
        self._m = int(m)
        self._d = int(d)
        self.dtype = np.dtype(dtype)
        self.method = method
        self.rho = float(rho)
        if max_iters is None:
            # reference PN default is 100 outer iterations
            # (constraint.py:186-188); ADMM needs many cheap iterations
            max_iters = 100 if method == "proximal_newton" else 10000
        self.max_iters = int(max_iters)
        self.tol = float(tol)
        self.newton_tol = float(newton_tol)
        self.newton_max_iters = int(newton_max_iters)
        self.slack = float(slack)
        self.nnls_max_iters = int(nnls_max_iters)
        self.nnls_tol = float(nnls_tol)
        self.pinball_max_iters = int(pinball_max_iters)
        self.pinball_tol = float(pinball_tol)
        self.mu = np.zeros(self._m, self.dtype)

    # --- structure --- #

    def duals(self) -> int:
        return self._m

    def primals(self) -> int:
        return self._d

    def duals_nnz(self) -> int:
        return int((self.mu != 0).sum())

    def dual(self):
        """Sparse dual export (reference `dual(indices, values)`)."""
        idx = np.nonzero(self.mu)[0]
        return idx, self.mu[idx]

    def clear(self):
        self.mu = np.zeros(self._m, self.dtype)

    def A_dense(self):
        """(m, d) constraint matrix."""
        raise NotImplementedError

    def zbounds(self):
        """(lo, hi) interval for z = A beta, each (m,)."""
        raise NotImplementedError

    # --- math --- #

    def project(self, x):
        """Euclidean-feasible point (only exact for box/one-sided)."""
        raise NotImplementedError

    def gradient(self, x, mu=None):
        """A' mu (reference `gradient`)."""
        mu = self.mu if mu is None else np.asarray(mu)
        return self.A_dense().T @ mu

    def solve_zero(self, v):
        """min_{mu feasible-at-zero} ||v - A'mu||; stores + returns mu.

        Feasible-at-zero duals (complementary slackness at beta = 0):
        mu_i >= 0 allowed iff hi_i <= 0, mu_i <= 0 allowed iff lo_i >= 0
        (reference constraint_box.ipp solve_zero / constraint_linear.ipp).
        """
        v = np.asarray(v, self.dtype)
        A = np.asarray(self.A_dense(), self.dtype)
        lo, hi = self.zbounds()
        big = configs.max_solver_value
        mu_hi = np.where(hi <= 0, big, 0.0)
        mu_lo = np.where(lo >= 0, -big, 0.0)
        if self._is_orthogonal_rows():
            # rows of A orthonormal-ish (box: identity, one-sided: +-1 diag):
            # closed form clip of A v (reference constraint_box.ipp:272-283)
            Av = A @ v
            mu = np.clip(Av, mu_lo, mu_hi)
        else:
            mu = self._solve_zero_qp(A, v, mu_lo, mu_hi)
        self.mu = np.asarray(mu, self.dtype)
        return float(np.linalg.norm(v - A.T @ mu))

    def _is_orthogonal_rows(self):
        return False

    def _solve_zero_qp(self, A, v, mu_lo, mu_hi):
        """Box-constrained LS  min ||v - A'mu||  via dense CD."""
        from ..optimization import _cd_full

        Q = jnp.asarray(A @ A.T, self.dtype)
        lin = jnp.asarray(A @ v, self.dtype)
        x0 = jnp.asarray(np.clip(self.mu, mu_lo, mu_hi), self.dtype)
        grad0 = lin - Q @ x0
        lo_d = jnp.asarray(mu_lo, self.dtype)
        hi_d = jnp.asarray(mu_hi, self.dtype)

        def rule(i, qii, gi, xi):
            step = jnp.where(qii <= 0, 0.0, gi / jnp.where(qii <= 0, 1.0, qii))
            return jnp.clip(xi + step, lo_d[i], hi_d[i])

        x, _, _ = _cd_full(Q, x0, grad0, rule, 100000,
                           jnp.asarray(self.tol, self.dtype),
                           jnp.asarray(1.0, self.dtype))
        return np.asarray(x)

    def solve(self, x, quad, linear, l1, l2, Q):
        """Constrained block update (reference ConstraintBase::solve).

        Args are the eigenbasis quantities the pin solver passes
        (solver_gaussian_pin_naive.hpp:420-459).  Returns (x_new, mu_new)
        and stores mu for subsequent gradient()/dual() calls.  Dispatches
        on ``method``: the reference's dual proximal Newton
        (constraint/utils.hpp + NNLS/pinball inner solvers) or ADMM.
        """
        dtype = self.dtype
        quad = np.asarray(quad, dtype)
        Q = np.asarray(Q, dtype)
        A = np.asarray(self.A_dense(), dtype)
        P = A @ Q
        lo, hi = self.zbounds()
        big = min(configs.max_solver_value,
                  float(np.finfo(dtype).max) * 0.5)
        lo = np.clip(np.asarray(lo, np.float64), -big, big)
        hi = np.clip(np.asarray(hi, np.float64), -big, big)

        if self.method == "proximal_newton":
            # build + jit once per constraint object (knobs are fixed);
            # a fresh jax.jit per call would defeat the dispatch cache and
            # re-trace the PN program on every block solve
            pn_jit = getattr(self, "_pn_jit", None)
            if pn_jit is None:
                import functools

                from ._pn import pn_block_solve

                pn_jit = self._pn_jit = jax.jit(functools.partial(
                    pn_block_solve,
                    tol=self.tol if self.tol > 0 else 1e-9,
                    slack=self.slack,
                    max_iters=self.max_iters,
                    nnls_tol=self.nnls_tol,
                    nnls_max_iters=self.nnls_max_iters,
                    pinball_tol=self.pinball_tol,
                    pinball_max_iters=self.pinball_max_iters,
                    newton_tol=self.newton_tol,
                    newton_max_iters=self.newton_max_iters,
                ))
            x_new, mu = pn_jit(
                jnp.asarray(P), jnp.asarray(quad), jnp.asarray(Q),
                jnp.asarray(linear, dtype),
                jnp.asarray(l1, dtype), jnp.asarray(l2, dtype),
                jnp.asarray(lo, dtype), jnp.asarray(hi, dtype),
                jnp.asarray(x, dtype), jnp.asarray(self.mu, dtype),
                jnp.asarray(big, dtype),
            )
            self.mu = np.asarray(mu, dtype)
            return np.asarray(x_new), self.mu

        rho = self.rho
        H = np.diag(quad) + rho * (P.T @ P)
        D, U = np.linalg.eigh(H)
        D = np.maximum(D, 0.0)

        x_new, mu, iters, done = admm_block_solve(
            jnp.asarray(P), jnp.asarray(D, dtype), jnp.asarray(U, dtype),
            jnp.asarray(linear, dtype),
            jnp.asarray(l1, dtype), jnp.asarray(l2, dtype),
            jnp.asarray(lo, dtype), jnp.asarray(hi, dtype),
            jnp.asarray(x, dtype), jnp.asarray(self.mu, dtype),
            jnp.asarray(rho, dtype),
            tol_abs=self.tol, tol_rel=self.tol,
            max_iters=self.max_iters,
            newton_tol=self.newton_tol,
            newton_max_iters=self.newton_max_iters,
        )
        self.mu = np.asarray(mu, dtype)
        return np.asarray(x_new), self.mu


class ConstraintBox(ConstraintBase):
    """lower <= beta <= upper with lower <= 0 <= upper
    (reference constraint_box.{hpp,ipp}; factory constraint.py:18)."""

    def __init__(self, lower, upper, **kwargs):
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        if np.any(upper < 0):
            raise ValueError("upper must be >= 0.")
        if np.any(lower > 0):
            raise ValueError("lower must be <= 0.")
        d = lower.size
        dtype = kwargs.pop("dtype", None) or np.float64
        super().__init__(d, d, dtype, **kwargs)
        big = configs.max_solver_value
        self.lower = np.maximum(lower, -big)
        self.upper = np.minimum(upper, big)

    def A_dense(self):
        return np.eye(self._d, dtype=self.dtype)

    def zbounds(self):
        return self.lower, self.upper

    def project(self, x):
        return np.clip(np.asarray(x), self.lower, self.upper)

    def _is_orthogonal_rows(self):
        return True


class ConstraintOneSided(ConstraintBase):
    """sgn * beta <= b elementwise, b >= 0
    (reference constraint_one_sided.{hpp,ipp}; factory constraint.py:341)."""

    def __init__(self, sgn, b, **kwargs):
        sgn = np.asarray(sgn, np.float64)
        b = np.asarray(b, np.float64)
        if np.any(np.abs(sgn) != 1):
            raise ValueError("sgn must be -1 or 1.")
        if np.any(b < 0):
            raise ValueError("b must be >= 0.")
        d = b.size
        dtype = kwargs.pop("dtype", None) or np.float64
        super().__init__(d, d, dtype, **kwargs)
        self.sgn = sgn
        self.b = np.minimum(b, configs.max_solver_value)

    def A_dense(self):
        return np.diag(self.sgn).astype(self.dtype)

    def zbounds(self):
        return np.full(self._m, -configs.max_solver_value), self.b

    def project(self, x):
        x = np.asarray(x)
        z = np.clip(self.sgn * x, None, self.b)
        return self.sgn * z

    def _is_orthogonal_rows(self):
        return True

    def solve_zero(self, v):
        # mu = clip(sgn*v, 0, big * (b<=0))   (constraint_one_sided.ipp:269)
        v = np.asarray(v, self.dtype)
        big = configs.max_solver_value
        mu = np.clip(self.sgn * v, 0.0, np.where(self.b <= 0, big, 0.0))
        self.mu = np.asarray(mu, self.dtype)
        return float(np.linalg.norm(v - self.sgn * mu))


class ConstraintLinear(ConstraintBase):
    """lower <= A beta <= upper for general A
    (reference constraint_linear.{hpp,ipp}; factory constraint.py:137)."""

    def __init__(self, A, lower, upper, **kwargs):
        from ..matrix import MatrixConstraintBase

        if isinstance(A, MatrixConstraintBase):
            A = np.asarray(A.dense())
        A = np.asarray(A, np.float64)
        m, d = A.shape
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        if np.any(upper < 0):
            raise ValueError("upper must be >= 0.")
        if np.any(lower > 0):
            raise ValueError("lower must be <= 0.")
        dtype = kwargs.pop("dtype", None) or np.float64
        super().__init__(m, d, dtype, **kwargs)
        self.A = A
        big = configs.max_solver_value
        self.lower = np.maximum(lower, -big)
        self.upper = np.minimum(upper, big)

    def A_dense(self):
        return self.A.astype(self.dtype)

    def zbounds(self):
        return self.lower, self.upper

    def project(self, x):
        """Approximate projection via ADMM (exact feasibility at fixpoint)."""
        x = np.asarray(x, self.dtype)
        z = self.A @ x
        if np.all(z >= self.lower - 1e-12) and np.all(z <= self.upper + 1e-12):
            return x
        # solve min ||y - x||^2 s.t. lo <= A y <= hi with ADMM pieces
        quad = np.ones(self._d)
        P = self.A
        H = np.diag(quad) + self.rho * P.T @ P
        D, U = np.linalg.eigh(H)
        y, mu, _, _ = admm_block_solve(
            jnp.asarray(P, self.dtype), jnp.asarray(D, self.dtype),
            jnp.asarray(U, self.dtype), jnp.asarray(x, self.dtype),
            jnp.asarray(0.0, self.dtype), jnp.asarray(0.0, self.dtype),
            jnp.asarray(self.lower, self.dtype),
            jnp.asarray(self.upper, self.dtype),
            jnp.asarray(x, self.dtype), jnp.zeros(self._m, self.dtype),
            jnp.asarray(self.rho, self.dtype),
            tol_abs=self.tol, tol_rel=self.tol, max_iters=self.max_iters,
        )
        return np.asarray(y)


# --------------------------------------------------------------------------- #
# factories (reference adelie/constraint.py)                                   #
# --------------------------------------------------------------------------- #


def _pn_configs(configs_dict, dtype, method="proximal_newton"):
    """Map the reference's proximal-newton/ADMM config keys onto ours
    (reference constraint.py:48-75,137-144: max_iters, tol, nnls_*,
    pinball_*, slack; ADMM variant: rho, tol_abs, tol_rel)."""
    out = {"method": method}
    if configs_dict:
        key_map = {
            "max_iters": "max_iters", "tol": "tol",
            "nnls_max_iters": "nnls_max_iters", "nnls_tol": "nnls_tol",
            "pinball_max_iters": "pinball_max_iters",
            "pinball_tol": "pinball_tol",
            "slack": "slack", "rho": "rho",
            "tol_abs": "tol", "tol_rel": None,
        }
        for k, val in configs_dict.items():
            mapped = key_map.get(k, k)
            if mapped:
                out[mapped] = val
    if dtype is not None:
        out["dtype"] = dtype
    return out


def box(lower, upper, *, method: str = "proximal_newton", configs=None,
        dtype=None):
    """Box constraint lower <= beta <= upper (reference constraint.py:18).

    ``method``: ``"proximal_newton"`` (reference default; dual PN with
    pinball inner QPs) or ``"admm"``.
    """
    return ConstraintBox(lower, upper, **_pn_configs(configs, dtype, method))


def lower(b, *, method: str = "proximal_newton", configs=None, dtype=None):
    """beta >= b (b <= 0) (reference constraint.py:309)."""
    b = np.asarray(b, np.float64)
    return ConstraintOneSided(-np.ones_like(b), -b,
                              **_pn_configs(configs, dtype, method))


def upper(b, *, method: str = "proximal_newton", configs=None, dtype=None):
    """beta <= b (b >= 0) (reference constraint.py:483)."""
    b = np.asarray(b, np.float64)
    return ConstraintOneSided(np.ones_like(b), b,
                              **_pn_configs(configs, dtype, method))


def one_sided(D, b, *, method: str = "proximal_newton", configs=None,
              dtype=None):
    """sgn (=D) * beta <= b (reference constraint.py:341)."""
    return ConstraintOneSided(D, b, **_pn_configs(configs, dtype, method))


def linear(A, lower, upper, *, vars=None, method: str = "proximal_newton",
           configs=None, dtype=None, copy: bool = False):
    """lower <= A beta <= upper (reference constraint.py:137).  ``vars`` is
    accepted for API parity (the reference uses it to scale its proximal
    Newton NNLS; this implementation derives the scale internally)."""
    return ConstraintLinear(A, lower, upper,
                            **_pn_configs(configs, dtype, method))
