"""Bounded-variable least squares (reference solver.py:961-1117,
solver_bvls.hpp).

    minimize_b  1/2 ||y - X b||_W^2   s.t.  lower <= b <= upper

Device design: the violation-batched screening loop stays on host (small
index bookkeeping); each fit gathers the screened columns once, forms their
weighted Gram as one matmul, and runs the entire screen/active CD refinement
as ONE jitted device call in covariance form (screened_cd.py).  KKT rounds
cost one ``X^T W r`` matmul each.
"""

from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import matrix as matrix_mod
from ..configs import configs
from ..exceptions import SolverError
from ..utils import Stopwatch, bucket
from .screened_cd import screened_cd_fit

_PRECISION = jax.lax.Precision.HIGHEST


@dataclass
class StateBVLS:
    """Result state (reference state/state_bvls.hpp fields)."""

    X: Any = None
    y_var: float = 0.0
    X_vars: np.ndarray = None
    lower: np.ndarray = None
    upper: np.ndarray = None
    weights: np.ndarray = None
    kappa: int = 0
    max_iters: int = 0
    tol: float = 0.0
    screen_set: np.ndarray = None
    is_screen: np.ndarray = None
    active_set: np.ndarray = None
    is_active: np.ndarray = None
    beta: np.ndarray = None
    resid: np.ndarray = None
    grad: np.ndarray = None
    loss: float = 0.0
    iters: int = 0
    n_kkt: int = 0
    benchmark_fit: list = field(default_factory=list)
    benchmark_kkt: list = field(default_factory=list)
    total_time: float = 0.0

    @property
    def screen_set_size(self):
        return len(self.screen_set)

    @property
    def active_set_size(self):
        return len(self.active_set)


@jax.jit
def _gram(Xs, w):
    Xw = Xs * w[:, None]
    return jnp.einsum("ns,nt->st", Xs, Xw, precision=_PRECISION)


@jax.jit
def _screen_grad(Xs, w, resid):
    return jnp.einsum("ns,n->s", Xs, w * resid, precision=_PRECISION)


@jax.jit
def _resid_update(resid, Xs, dbeta):
    return resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)


def bvls(
    X,
    y,
    lower,
    upper,
    *,
    weights=None,
    kappa: int = None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    n_threads: int = 1,
    warm_start=None,
    dtype=None,
):
    """Solve BVLS (reference solver.py:961).  Returns :class:`StateBVLS`."""
    sw = Stopwatch().start()
    if not isinstance(X, matrix_mod.MatrixNaiveBase):
        X = matrix_mod.dense(np.asarray(X), dtype=dtype)
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()

    y = np.asarray(y, dtype)
    if weights is None:
        weights = np.full(n, 1.0 / n, dtype)
    else:
        weights = np.asarray(weights, dtype)
    if kappa is None:
        kappa = min(n, p)
    kappa = int(kappa)

    lower = np.maximum(np.asarray(lower, dtype), -configs.max_solver_value)
    upper = np.minimum(np.asarray(upper, dtype), configs.max_solver_value)

    w_dev = jnp.asarray(weights)
    y_var = float(np.sum(y * y * weights))

    if warm_start is None:
        beta = np.where(np.abs(lower) < np.abs(upper), lower, upper).astype(dtype)
        screen_idx = []
        is_screen = np.zeros(p, bool)
        is_active_full = np.zeros(p, bool)
    else:
        beta = np.asarray(warm_start.beta, dtype).copy()
        screen_idx = list(np.asarray(warm_start.active_set, int))
        is_screen = np.zeros(p, bool)
        is_screen[screen_idx] = True
        is_active_full = np.asarray(warm_start.is_active, bool).copy()

    X_vars = np.asarray(X.sq_mul(w_dev))

    resid = jnp.asarray(y) - X.tmul(jnp.asarray(beta))
    loss = float(jnp.vdot(w_dev, jnp.asarray(resid) ** 2) * 0.5)

    iters = 0
    n_kkt = 0
    tol_scale = tol * y_var

    state = StateBVLS(
        X=X, y_var=y_var, X_vars=X_vars, lower=lower, upper=upper,
        weights=weights, kappa=kappa, max_iters=max_iters, tol=tol,
    )

    while True:
        loss_prev = loss

        # ---- fit over the current screen set (one device call) ---- #
        if screen_idx:
            sw_fit = Stopwatch().start()
            cols = np.asarray(screen_idx, np.int32)
            S_val = len(cols)
            S_cap = bucket(S_val, configs.screen_cap_min)

            Xs = jnp.zeros((n, S_cap), dtype)
            Xs = Xs.at[:, :S_val].set(X.gather(cols))
            Q = _gram(Xs, w_dev)
            diag = np.zeros(S_cap, dtype)
            diag[:S_val] = X_vars[cols]
            lo = np.zeros(S_cap, dtype)
            hi = np.zeros(S_cap, dtype)
            lo[:S_val] = lower[cols]
            hi[:S_val] = upper[cols]
            b0 = np.zeros(S_cap, dtype)
            b0[:S_val] = beta[cols]
            valid = np.zeros(S_cap, bool)
            valid[:S_val] = True
            act0 = np.zeros(S_cap, bool)
            act0[:S_val] = is_active_full[cols]

            grad_s = _screen_grad(Xs, w_dev, resid)

            beta_s, grad_s, act_s, loss_d, it_d, done = screened_cd_fit(
                Q, jnp.asarray(diag), jnp.asarray(b0), grad_s,
                jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid),
                jnp.asarray(act0), jnp.asarray(loss, dtype),
                jnp.asarray(tol_scale, dtype),
                jnp.asarray(max_iters, jnp.int32),
                jnp.asarray(iters, jnp.int32),
                mode="box",
            )
            beta_s_h, act_s_h, loss_h, it_h, done_h = jax.device_get(
                (beta_s, act_s, loss_d, it_d, done)
            )
            if not bool(done_h):
                raise SolverError("bvls: max iterations reached!")
            iters = int(it_h)
            loss = float(loss_h)
            dbeta = jnp.asarray(beta_s) - jnp.asarray(b0)
            resid = _resid_update(resid, Xs, dbeta)
            beta[cols] = np.asarray(beta_s_h)[:S_val]
            is_active_full[cols] = np.asarray(act_s_h)[:S_val]
            state.benchmark_fit.append(sw_fit.elapsed())

        # ---- convergence on loss plateau (solver_bvls.hpp solve) ---- #
        if n_kkt > 0 and abs(loss - loss_prev) < 1e-6 * abs(y_var):
            break

        # ---- KKT screening round ---- #
        sw_kkt = Stopwatch().start()
        grad_full = np.asarray(X.mul(resid, w_dev))
        n_kkt += 1
        viols = (
            np.maximum(grad_full, 0) * (beta < upper)
            - np.minimum(grad_full, 0) * (beta > lower)
        )
        viols[is_screen] = 0.0
        order = np.argsort(-viols, kind="stable")
        new = [int(k) for k in order[:kappa] if viols[k] > 0]
        state.benchmark_kkt.append(sw_kkt.elapsed())
        if not new:
            break
        for k in new:
            is_screen[k] = True
        screen_idx.extend(new)

    grad_full = np.asarray(X.mul(resid, w_dev))
    state.screen_set = np.asarray(screen_idx, int)
    state.is_screen = is_screen
    state.active_set = np.nonzero(is_active_full)[0]
    state.is_active = is_active_full
    state.beta = beta
    state.resid = np.asarray(resid)
    state.grad = grad_full
    state.loss = loss
    state.iters = iters
    state.n_kkt = n_kkt
    state.total_time = sw.elapsed()
    return state
