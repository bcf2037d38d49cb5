"""Covariance-method gaussian path solver (reference solver.py:39-351,
solver_gaussian_cov.hpp:372, solver_gaussian_pin_cov.hpp).

Solves  min_b  1/2 b'Ab - v'b + lmda sum_g w_g (alpha ||b_g|| +
(1-alpha)/2 ||b_g||^2)  over a lambda path with BASIL screening.

The device pin solver already runs in covariance form (pin.py), so this
method IS the pin solver fed with gathered blocks of ``A``: per screen-set
change we materialize ``A[screen, screen]`` (the lazy-cov analog,
matrix_cov_lazy_cov.hpp:31-33 — here one gather per change instead of
per-group caching) and batch-eigendecompose the group diagonal blocks; the
full-gradient invariance is one ``A[:, screen] @ beta`` product per lambda.
"""

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from .. import matrix as matrix_mod
from ..configs import configs
from ..exceptions import MaxCDsError
from ..utils import Stopwatch, bucket, bucket_pow2, large_lmda
from .basil import solve_core
from .pin import pin_cov_solve, screen_eigh
from .state_core import NaiveStateBase, abs_grad_kernel


class CovScreenCache:
    """Device-resident A[screen, screen] block + eigendecompositions."""

    def __init__(self):
        self.version = -1
        self.cols = None
        self.S_val = 0
        self.S_cap = 0
        self.G_cap = 0
        self.qmax = 1
        self.A_s = None
        self.slot_begin = None
        self.slot_size = None
        self.penalty_slots = None
        self.eigvals = None
        self.eigvecs = None

    def rebuild(self, state):
        ss = state.screen_set
        gs = state.group_sizes[ss]
        begins = np.concatenate([[0], np.cumsum(gs)])[:-1]
        S_val = int(begins[-1] + gs[-1]) if len(ss) else 0
        cols = np.concatenate(
            [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
             for g in ss]
        ).astype(np.int64) if len(ss) else np.zeros(0, np.int64)

        qmax = bucket_pow2(int(gs.max())) if len(ss) else 1
        S_cap = bucket(S_val + qmax, configs.screen_cap_min)
        G_cap = bucket(max(len(ss), 1), configs.group_cap_min)

        dtype = state.dtype
        A_s = jnp.zeros((S_cap, S_cap), dtype)
        if S_val:
            blk = state.A.block(cols, cols)
            A_s = A_s.at[:S_val, :S_val].set(jnp.asarray(blk, dtype))

        slot_begin = np.zeros(G_cap, np.int32)
        slot_size = np.zeros(G_cap, np.int32)
        penalty_slots = np.ones(G_cap, dtype)
        slot_begin[: len(ss)] = begins
        slot_size[: len(ss)] = gs
        penalty_slots[: len(ss)] = state.penalty[ss]

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap, self.qmax = S_val, S_cap, G_cap, qmax
        self.A_s = A_s
        self.slot_begin = jnp.asarray(slot_begin)
        self.slot_size = jnp.asarray(slot_size)
        self.penalty_slots = jnp.asarray(penalty_slots)
        self.eigvals, self.eigvecs = screen_eigh(
            A_s, self.slot_begin, self.slot_size, qmax
        )

    def pad_screen_values(self, values, dtype):
        out = np.zeros(self.S_cap, dtype)
        out[: self.S_val] = values
        return jnp.asarray(out)

    def pad_group_bools(self, flags):
        out = np.zeros(self.G_cap, bool)
        out[: len(flags)] = flags
        return jnp.asarray(out)


@dataclass
class GaussianCovState(NaiveStateBase):
    """State for the covariance method (reference state.py:1128)."""

    A: Any = None
    v: np.ndarray = None
    rdev_tol: float = 1e-3
    rsq: float = 0.0
    rsqs: list = None

    def __post_init__(self):
        super().__post_init__()
        if self.rsqs is None:
            self.rsqs = []
        self._cov_cache = CovScreenCache()

    def ensure_screen_cache(self):
        if self._cov_cache.version != self._screen_version:
            self._cov_cache.rebuild(self)
            self._cov_cache.version = self._screen_version
        return self._cov_cache

    def update_abs_grad(self, lmda):
        cache = self.ensure_screen_cache()
        cols_padded = np.full(cache.S_cap, -1, np.int32)
        cols_padded[: cache.S_val] = cache.cols
        beta_padded = cache.pad_screen_values(self.screen_beta, self.dtype)
        ag = abs_grad_kernel(
            self.grad, jnp.asarray(cols_padded), beta_padded,
            self._penalty_cols, self._group_ids,
            jnp.asarray((1.0 - self.alpha) * min(lmda, 1e30), self.dtype),
            len(self.groups),
        )
        self.abs_grad = np.asarray(ag)


def early_exit_cov(state) -> bool:
    """rdev rule (reference solver_gaussian_cov.hpp:186-200)."""
    if not state.early_exit or len(state.devs) < 2:
        return False
    dev_u = state.devs[-1]
    dev_m = state.devs[-2]
    return bool(dev_u - dev_m <= state.rdev_tol * dev_u)


class GaussianCovDriver:
    def __init__(self, state: GaussianCovState):
        self.s = state
        self._is_screen_dev = None
        self._is_screen_version = -1
        self._penalty_groups_dev = jnp.asarray(
            state.penalty.astype(state.dtype)
        )
        self._prev_dev = 0.0
        self._have_prev_dev = False

    def large_lmda(self):
        return large_lmda(self.s.dtype)

    def _screen_mask(self):
        s = self.s
        if self._is_screen_version != s._screen_version:
            m = np.zeros(len(s.groups), bool)
            m[s.screen_set] = True
            self._is_screen_dev = jnp.asarray(m)
            self._is_screen_version = s._screen_version
        return self._is_screen_dev

    # ---- chunked path (dense A only; see _build_cov_chunk_step) ---- #

    def _run_chunk(self, lmdas, record):
        from .basil import compute_lmda_max

        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        dtype = s.dtype
        step = _get_cov_chunk_step(len(s.groups), cache.qmax)

        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        cols_padded = np.full(cache.S_cap, -1, np.int32)
        cols_padded[: cache.S_val] = cache.cols

        carry, emits = step(
            s.A._mat, jnp.asarray(s.v, dtype),
            cache.A_s, jnp.asarray(cols_padded),
            cache.slot_begin, cache.slot_size, cache.eigvals, cache.eigvecs,
            cache.penalty_slots,
            cache.pad_screen_values(s.screen_beta, dtype),
            cache.pad_group_bools(s.screen_is_active),
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            jnp.asarray(lm_pad, dtype), jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype), jnp.asarray(s.rdev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
        )
        (beta_f, active_f, rsq_f, abs_grad_f, stopped_f, prev_dev_f,
         have_prev_f) = carry
        (betas_e, rsqs_e, accepts_e, kkts_e, dones_e, processed_e) = emits

        (beta_h, active_h, rsq_h, ag_h, stopped_h, prevdev_h, haveprev_h,
         betas_np, rsqs_np, accepts_np, dones_np, processed_np) = (
            jax.device_get((beta_f, active_f, rsq_f, abs_grad_f, stopped_f,
                            prev_dev_f, have_prev_f, betas_e, rsqs_e,
                            accepts_e, dones_e, processed_e))
        )
        if np.any(processed_np & ~dones_np):
            raise MaxCDsError()

        n_proc = int(processed_np.sum())
        n_acc = int(accepts_np[:n_proc].sum())

        if n_proc:
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = np.asarray(active_h)[: len(s.screen_set)].copy()
            s.rsq = float(rsq_h)
            s.abs_grad = np.asarray(ag_h)
            s.lmda = float(lm_pad[n_proc - 1])
            if record:
                # dry fits (lmda_max positioning) must not seed the
                # early-exit deviance comparison (reference compares
                # RECORDED solutions only, solver_gaussian_cov.hpp:193)
                self._prev_dev = float(prevdev_h)
                self._have_prev_dev = bool(haveprev_h)

        if record:
            for i in range(n_proc):
                if accepts_np[i]:
                    sb = np.asarray(betas_np[i][: cache.S_val])
                    nz = np.abs(sb) > 0
                    s.betas.append(sp.csr_matrix(
                        (sb[nz], (np.zeros(int(nz.sum()), int),
                                  cache.cols[nz])),
                        shape=(1, s.p),
                    ))
                    s.intercepts.append(0.0)
                    s.lmdas.append(float(lm_pad[i]))
                    s.rsqs.append(float(rsqs_np[i]))
                    s.devs.append(float(rsqs_np[i]))
                    s.n_valid_solutions.append(True)
                    s.active_sizes.append(int(np.asarray(active_h).sum()))
                    s.screen_sizes.append(len(s.screen_set))
                else:
                    s.n_valid_solutions.append(False)

        early_stopped = bool(
            n_proc and bool(stopped_h) and bool(accepts_np[n_proc - 1])
        )
        s.benchmark["fit_screen"].append(sw.elapsed())
        return n_acc, early_stopped

    def solve_path(self, progress_bar=False, exit_cond=None):
        """Chunked BASIL loop for the covariance method (dense A)."""
        from .basil import compute_lmda_max, compute_lmda_path, screen

        s = self.s
        sw = Stopwatch().start()
        if exit_cond is not None:
            # user exit conditions are evaluated per lambda in the
            # reference (solver.py:590-603); drop to per-lambda chunks
            s.lmda_chunk = 1
        exit_cond = exit_cond or (lambda *a: False)
        pbar = None
        if progress_bar:
            try:
                from tqdm import tqdm

                pbar = tqdm(total=int(s.lmda_path_size or 0) or None)
            except Exception:
                pbar = None

        if s.setup_lmda_max and s.lmda_max is None:
            self._run_chunk([self.large_lmda()], record=False)
            s.lmda_max = compute_lmda_max(s.abs_grad, s.alpha, s.penalty)

        if s.setup_lmda_path and s.lmda_path is None:
            if s.lmda_path_size <= 0:
                s.total_time = sw.elapsed()
                return s
            s.lmda_path = compute_lmda_path(
                s.lmda_max, s.min_ratio, s.lmda_path_size
            )
        path = np.asarray(s.lmda_path, float)

        large_count = int(np.searchsorted(-path, -s.lmda_max))
        if large_count or s.setup_lmda_max:
            seg = list(path[:large_count])
            Cc = int(s.lmda_chunk)
            for i in range(0, len(seg), Cc):
                n_acc, early = self._run_chunk(seg[i:i + Cc], record=True)
                if early or exit_cond(s):
                    s.total_time = sw.elapsed()
                    return s
            self._run_chunk([s.lmda_max], record=False)

        idx = large_count
        kkt_passed = True
        n_new_active = 0
        current_active = s.active_set_size

        while idx < len(path):
            C = min(int(s.lmda_chunk), len(path) - idx)
            chunk = path[idx:idx + C]
            lmda_prev = path[idx + C - 2] if C > 1 else s.lmda
            sw_p = Stopwatch().start()
            screen(s, chunk[-1], kkt_passed, n_new_active,
                   lmda_prev=lmda_prev, lmda_fallback=chunk[0],
                   chunk_size=C)
            s.benchmark["screen"].append(sw_p.elapsed())

            n_acc, early = self._run_chunk(chunk, record=True)
            idx += n_acc
            if pbar is not None and n_acc:
                pbar.update(n_acc)
                if len(s.devs):
                    pbar.set_postfix_str(f"dev:{100 * s.devs[-1]:.1f}%")
            kkt_passed = n_acc == C
            if n_acc:
                n_new_active = s.active_set_size - current_active
                current_active = s.active_set_size
            if early or exit_cond(s):
                break

        if pbar is not None:
            pbar.close()
        s.total_time = sw.elapsed()
        return s

    def update_loss_null(self):
        pass

    def fit(self, lmda):
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        dtype = s.dtype

        beta0 = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        # screen gradient at current beta: g_s = v_s - A_s beta_s
        v_s = np.zeros(cache.S_cap, dtype)
        v_s[: cache.S_val] = s.v[cache.cols]
        grad_s = jnp.asarray(v_s) - cache.A_s @ beta0

        beta, grad, active, rsq, iters, done = pin_cov_solve(
            cache.A_s, grad_s, beta0,
            cache.slot_begin, cache.slot_size,
            cache.eigvals, cache.eigvecs, cache.penalty_slots,
            active0,
            jnp.asarray(lmda, dtype), jnp.asarray(s.alpha, dtype),
            jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype),
        )
        if not bool(done):
            raise MaxCDsError()
        s.screen_beta = np.asarray(beta)[: cache.S_val].copy()
        s.screen_is_active = np.asarray(active)[: len(s.screen_set)].copy()
        s.rsq = float(rsq)
        return sw.elapsed()

    def update_invariance(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        s.lmda = lmda
        if cache.S_val:
            Ab = s.A.mul(cache.cols, s.screen_beta)
            s.grad = jnp.asarray(s.v, s.dtype) - jnp.asarray(Ab, s.dtype)
        else:
            s.grad = jnp.asarray(s.v, s.dtype)
        s.update_abs_grad(lmda)

    def update_solutions(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        nz = np.abs(s.screen_beta) > 0
        cols = cache.cols
        beta_row = sp.csr_matrix(
            (s.screen_beta[nz], (np.zeros(int(nz.sum()), int), cols[nz])),
            shape=(1, s.p),
        )
        s.betas.append(beta_row)
        s.intercepts.append(0.0)
        s.lmdas.append(float(lmda))
        s.rsqs.append(float(s.rsq))
        s.devs.append(float(s.rsq))


def gaussian_cov(
    A,
    v,
    *,
    constraints=None,
    groups=None,
    alpha: float = 1.0,
    penalty=None,
    lmda_path=None,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    rdev_tol: float = 1e-3,
    newton_tol: float = 1e-12,
    newton_max_iters: int = 1000,
    n_threads: int = 1,
    early_exit: bool = True,
    screen_rule: str = "pivot",
    min_ratio: float = 1e-2,
    lmda_path_size: int = 100,
    max_screen_size: int = None,
    max_active_size: int = None,
    pivot_subset_ratio: float = 0.1,
    pivot_subset_min: int = 1,
    pivot_slack_ratio: float = 1.25,
    check_state: bool = False,
    progress_bar: bool = False,
    warm_start=None,
    exit_cond=None,
):
    """Covariance-method group elastic net (reference solver.py:39)."""
    from ..logger import logger
    from ..utils import types

    screen_rule = types.screen_rule(screen_rule)

    if constraints is not None and any(c is not None for c in constraints):
        from .constrained import check_constraints_supported

        check_constraints_supported(constraints)

    if not isinstance(A, matrix_mod.MatrixCovBase):
        if isinstance(A, matrix_mod.MatrixNaiveBase):
            raise TypeError(
                "gaussian_cov expects a covariance matrix; got a naive "
                f"(n x p) matrix {type(A).__name__}. Construct it with "
                "method='cov' (e.g. matrix.block_diag(mats, method='cov'))."
            )
        A = matrix_mod.dense(np.asarray(A), method="cov")
    dtype = np.dtype(A.dtype)
    p = A.cols()
    v = np.asarray(v, dtype)

    if lmda_path is not None:
        lmda_path = np.array(np.flip(np.sort(lmda_path)), dtype=float)

    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    else:
        penalty = np.asarray(penalty, float)

    if warm_start is None:
        if p + int(group_sizes.max()) <= configs.screen_all_max:
            # small-problem fast path (see grpnet): screen everything,
            # zero KKT retries
            screen_set = np.arange(G)
        else:
            screen_set = np.arange(G)[(penalty <= 0) | (alpha <= 0)]
        gs = group_sizes[screen_set]
        screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        screen_beta = np.zeros(int(gs.sum()), dtype)
        screen_is_active = (penalty[screen_set] <= 0) | (alpha <= 0)
        lmda = np.inf
        lmda_max = None
        rsq = 0.0
    else:
        screen_set = np.asarray(warm_start.screen_set)
        screen_begins = np.asarray(warm_start.screen_begins)
        screen_beta = np.asarray(warm_start.screen_beta)
        screen_is_active = np.asarray(warm_start.screen_is_active)
        lmda = warm_start.lmda
        lmda_max = warm_start.lmda_max
        rsq = warm_start.rsq

    state = GaussianCovState(
        A=A, v=v, X=None, groups=groups, group_sizes=group_sizes,
        alpha=float(alpha), penalty=penalty, intercept=False, dtype=dtype,
        n=0, p=p,
        max_iters=int(max_iters), tol=float(tol), rdev_tol=float(rdev_tol),
        newton_tol=float(newton_tol), newton_max_iters=int(newton_max_iters),
        early_exit=bool(early_exit), min_ratio=float(min_ratio),
        lmda_path_size=int(lmda_path_size), max_screen_size=max_screen_size,
        max_active_size=max_active_size,
        pivot_subset_ratio=float(pivot_subset_ratio),
        pivot_subset_min=int(pivot_subset_min),
        pivot_slack_ratio=float(pivot_slack_ratio),
        screen_rule=screen_rule, lmda_path=lmda_path,
        setup_lmda_path=lmda_path is None,
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=lmda, lmda_max=lmda_max, setup_lmda_max=lmda_max is None,
        rsq=rsq,
    )

    driver = GaussianCovDriver(state)
    driver.update_invariance(min(state.lmda, 1e30) if np.isfinite(state.lmda) else 1e30)

    try:
        if isinstance(A, matrix_mod.MatrixCovDense):
            # dense device-resident A: chunked lambda batching
            driver.solve_path(progress_bar=progress_bar, exit_cond=exit_cond)
        else:
            solve_core(state, driver, progress_bar=progress_bar,
                       exit_cond=exit_cond, early_exit_fn=early_exit_cov)
    except Exception as exc:
        import traceback

        state.error = str(exc)
        logger.error(f"gaussian_cov: {exc}\n{traceback.format_exc()}")

    from . import finalize_state

    return finalize_state(state)


# --------------------------------------------------------------------------- #
# chunked path (dense-A fast path)                                             #
# --------------------------------------------------------------------------- #


def _build_cov_chunk_step(num_groups: int, qmax: int):
    """lax.scan over a batch of lambdas for the covariance method with a
    device-resident dense A (one host round trip per chunk; the per-lambda
    loop costs ~3 host round trips otherwise)."""
    import jax

    @jax.jit
    def chunk_step(
        A_full,                          # (p, p) device
        v_full,                          # (p,)
        A_s, cols_padded,                # screen cache
        slot_begin, slot_size, eigvals, eigvecs, penalty_slots,
        beta0, active0,
        group_ids, penalty_cols, penalty_groups, is_screen_mask,
        lmdas, valid,
        alpha, tol, dbeta_tol, newton_tol, newton_max_iters, max_iters,
        rsq0, rdev_tol, early_exit_on, prev_dev, have_prev_dev,
    ):
        dtype = beta0.dtype
        ok = cols_padded >= 0
        safe = jnp.where(ok, cols_padded, 0)
        v_s = jnp.where(ok, v_full[safe], 0.0)

        def per_lambda(carry, inp):
            beta, active, rsq, abs_grad_c, stopped, prev_dev, have_prev = carry
            lmda, is_valid = inp
            run_it = is_valid & (~stopped)

            def run(args):
                beta, active, rsq, abs_grad_c, stopped, prev_dev, have_prev = args
                grad_s = v_s - A_s @ beta
                beta_n, _, active_n, rsq_n, _, done = pin_cov_solve(
                    A_s, grad_s, beta, slot_begin, slot_size, eigvals,
                    eigvecs, penalty_slots, active, lmda, alpha, tol,
                    dbeta_tol, newton_tol, newton_max_iters, max_iters, rsq,
                )
                # invariance: grad = v - A[:, cols] beta (solver_gaussian_cov)
                A_cols = A_full[:, safe] * ok[None, :]
                grad = v_full - A_cols @ beta_n
                # OOB sentinel for the scatter only (safe stays clamped
                # for the gather above): drop padded slots instead of
                # racing them against a real slot mapping to column 0
                safe_set = jnp.where(ok, cols_padded, grad.shape[0])
                beta_cols = jnp.zeros_like(grad).at[safe_set].set(
                    beta_n, mode="drop"
                )
                l2s = (1.0 - alpha) * jnp.minimum(lmda, 1e30)
                gadj = grad - l2s * (penalty_cols * beta_cols)
                sq = jax.ops.segment_sum(gadj * gadj, group_ids,
                                         num_segments=num_groups)
                abs_grad = jnp.sqrt(jnp.maximum(sq, 0.0))
                viol = abs_grad > lmda * alpha * penalty_groups
                kkt = ~jnp.any(viol & ~is_screen_mask)
                accept = done & kkt
                dev = rsq_n
                early = early_exit_on & accept & have_prev & (
                    dev - prev_dev <= rdev_tol * dev
                )
                stopped_n = (~accept) | early
                carry_n = (beta_n, active_n, rsq_n, abs_grad, stopped_n,
                           jnp.where(accept, dev, prev_dev),
                           have_prev | accept)
                emit = (beta_n, rsq_n, accept, kkt, done,
                        jnp.ones((), bool))
                return carry_n, emit

            def skip(args):
                beta = args[0]
                emit = (beta, jnp.zeros((), dtype), jnp.zeros((), bool),
                        jnp.zeros((), bool), jnp.zeros((), bool),
                        jnp.zeros((), bool))
                return args, emit

            return jax.lax.cond(run_it, run, skip, carry)

        init = (beta0, active0, rsq0,
                jnp.zeros((num_groups,), dtype), jnp.zeros((), bool),
                prev_dev, have_prev_dev)
        return jax.lax.scan(per_lambda, init, (lmdas, valid))

    return chunk_step


_COV_STEP_CACHE = {}


def _get_cov_chunk_step(num_groups, qmax):
    key = (int(num_groups), int(qmax))
    hit = _COV_STEP_CACHE.get(key)
    if hit is None:
        hit = _COV_STEP_CACHE[key] = _build_cov_chunk_step(num_groups, qmax)
    return hit
