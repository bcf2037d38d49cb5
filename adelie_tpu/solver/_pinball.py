"""Pinball (asymmetric-penalty) least squares (reference solver.py:1119-1273,
solver_pinball.hpp).

    minimize_b  1/2 || S^{-1/2} v - S^{1/2} A^T b ||_2^2
                + penalty_neg' b_-  +  penalty_pos' b_+

Used standalone and as the inner solver of box/one-sided constraints.
Same device structure as BVLS: host drives violation-batched KKT rounds; each
fit is one jitted covariance-form CD call over the screened rows of A with
Gram ``A_s S A_s^T`` formed as one matmul.
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
class StatePinball:
    """Result state (reference state/state_pinball.hpp fields)."""

    A: Any = None
    y_var: float = 0.0
    S: np.ndarray = None
    penalty_neg: np.ndarray = None
    penalty_pos: np.ndarray = None
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


def pinball(
    A,
    S,
    v,
    penalty_neg,
    penalty_pos,
    *,
    kappa: int = None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    n_threads: int = 1,
    warm_start=None,
    dtype=None,
):
    """Solve pinball LS (reference solver.py:1119).  Returns
    :class:`StatePinball`."""
    sw = Stopwatch().start()
    if isinstance(A, matrix_mod.MatrixConstraintBase):
        A_dense = np.asarray(A.dense())
    else:
        A_dense = np.asarray(A)
    if dtype is None:
        dtype = A_dense.dtype if A_dense.dtype in (np.float32, np.float64) else np.float64
    dtype = np.dtype(dtype)
    A_dense = A_dense.astype(dtype)
    m, d = A_dense.shape

    S = np.asarray(S, dtype)
    v = np.asarray(v, dtype)
    if kappa is None:
        kappa = min(m, d)
    kappa = int(kappa)
    y_var = float(v @ np.linalg.lstsq(S, v, rcond=None)[0])

    pn = np.minimum(np.asarray(penalty_neg, dtype), configs.max_solver_value)
    pp = np.minimum(np.asarray(penalty_pos, dtype), configs.max_solver_value)

    if warm_start is None:
        beta = np.zeros(m, dtype)
        screen_idx = []
        is_screen = np.zeros(m, bool)
        is_active_full = np.zeros(m, bool)
        resid = v.copy()
        loss = 0.5 * y_var
    else:
        beta = np.asarray(warm_start.beta, dtype).copy()
        screen_idx = list(np.asarray(warm_start.active_set, int))
        is_screen = np.zeros(m, bool)
        is_screen[screen_idx] = True
        is_active_full = np.asarray(warm_start.is_active, bool).copy()
        resid = v - S @ (A_dense.T @ beta)
        loss = 0.5 * float(resid @ np.linalg.lstsq(S, resid, rcond=None)[0])

    A_dev = jnp.asarray(A_dense)
    S_dev = jnp.asarray(S)
    resid_dev = jnp.asarray(resid)

    iters = 0
    n_kkt = 0
    tol_scale = tol * y_var

    state = StatePinball(
        A=A, y_var=y_var, S=S, penalty_neg=pn, penalty_pos=pp, kappa=kappa,
        max_iters=max_iters, tol=tol,
    )

    while True:
        loss_prev = loss

        if screen_idx:
            sw_fit = Stopwatch().start()
            rows = np.asarray(screen_idx, np.int32)
            S_val = len(rows)
            S_cap = bucket(S_val, configs.screen_cap_min)

            As = jnp.zeros((S_cap, d), dtype)
            As = As.at[:S_val].set(A_dev[jnp.asarray(rows)])
            AsS = jnp.matmul(As, S_dev, precision=_PRECISION)      # (cap, d)
            Q = jnp.matmul(AsS, As.T, precision=_PRECISION)        # (cap, cap)
            diag = jnp.maximum(jnp.diagonal(Q), 0.0)
            lo = np.zeros(S_cap, dtype)
            hi = np.zeros(S_cap, dtype)
            lo[:S_val] = pn[rows]
            hi[:S_val] = pp[rows]
            b0 = np.zeros(S_cap, dtype)
            b0[:S_val] = beta[rows]
            valid = np.zeros(S_cap, bool)
            valid[:S_val] = True
            act0 = np.zeros(S_cap, bool)
            act0[:S_val] = is_active_full[rows]

            # g_k = A_k . resid  (reference rvmul against the d-space resid)
            grad_s = jnp.matmul(As, resid_dev, precision=_PRECISION)
            grad_s = jnp.where(jnp.asarray(valid), grad_s, 0.0)

            beta_s, grad_s, act_s, loss_d, it_d, done = screened_cd_fit(
                Q, diag, jnp.asarray(b0), grad_s,
                jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid),
                jnp.asarray(act0), jnp.asarray(loss, dtype),
                jnp.asarray(tol_scale, dtype),
                jnp.asarray(max_iters, jnp.int32),
                jnp.asarray(iters, jnp.int32),
                mode="pinball",
            )
            beta_s_h, act_s_h, loss_h, it_h, done_h = jax.device_get(
                (beta_s, act_s, loss_d, it_d, done)
            )
            if not bool(done_h):
                raise SolverError("pinball: max iterations reached!")
            iters = int(it_h)
            loss = float(loss_h)
            dbeta = jnp.asarray(beta_s) - jnp.asarray(b0)
            # resid -= del_k * (S A^T)_k  summed: resid -= AsS^T @ dbeta
            resid_dev = resid_dev - jnp.matmul(AsS.T, dbeta, precision=_PRECISION)
            beta[rows] = np.asarray(beta_s_h)[:S_val]
            is_active_full[rows] = np.asarray(act_s_h)[:S_val]
            state.benchmark_fit.append(sw_fit.elapsed())

        if n_kkt > 0 and abs(loss - loss_prev) < 1e-6 * abs(y_var):
            break

        # ---- KKT: grad = A resid; viols = max(g - pp, -pn - g) ---- #
        sw_kkt = Stopwatch().start()
        grad_full = np.asarray(jnp.matmul(A_dev, resid_dev, precision=_PRECISION))
        n_kkt += 1
        viols = np.maximum(grad_full - pp, -pn - grad_full)
        viols[is_screen] = -np.inf
        order = np.argsort(-viols, kind="stable")
        new = [int(k) for k in order[:kappa] if viols[k] > 0]
        state.benchmark_kkt.append(sw_kkt.elapsed())
        if not new:
            break
        for k in new:
            is_screen[k] = True
        screen_idx.extend(new)

    grad_full = np.asarray(jnp.matmul(A_dev, resid_dev, precision=_PRECISION))
    state.screen_set = np.asarray(screen_idx, int)
    state.is_screen = is_screen
    state.active_set = np.nonzero(is_active_full)[0]
    state.is_active = is_active_full
    state.beta = beta
    state.resid = np.asarray(resid_dev)
    state.grad = grad_full
    state.loss = loss
    state.iters = iters
    state.n_kkt = n_kkt
    state.total_time = sw.elapsed()
    return state
