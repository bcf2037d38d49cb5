"""Gaussian naive path solver (fast path, no IRLS).

Device re-design of ``solver_gaussian_naive.hpp`` (fit :215-356, invariance
:377-392) on top of the covariance-form pin solver (see pin.py).  Per lambda
the ENTIRE iteration — screen gradient, pin solve, residual reconstruction,
invariance gradient, abs_grad, KKT verdict — is one fused jitted device call
(fused.py) with a single host pull, because the host<->device round trip is
a dominant warm-path cost.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..configs import configs
from ..exceptions import MaxCDsError
from ..utils import Stopwatch, large_lmda
from .basil import compute_lmda_max, compute_lmda_path, screen
from .fused import get_gaussian_chunk_step, get_gaussian_step
from .state_core import NaiveStateBase


@dataclass
class GaussianNaiveState(NaiveStateBase):
    weights: object = None       # device (n,), sum to 1
    X_means: object = None       # device (p,)
    y_mean: float = 0.0
    y_var: float = 1.0
    rsq: float = 0.0
    resid: object = None         # device (n,)
    resid_sum: float = 0.0
    rsqs: list = None

    def __post_init__(self):
        super().__post_init__()
        if self.rsqs is None:
            self.rsqs = []


class GaussianNaiveDriver:
    def __init__(self, state: GaussianNaiveState):
        self.s = state
        self._step = get_gaussian_step(
            state.X, state.intercept, len(state.groups)
        )
        self._chunk_step = get_gaussian_chunk_step(
            state.X, state.intercept, len(state.groups)
        )
        self._X_data = state.X.mul_spec()[1]
        self._prev_dev = 0.0
        self._have_prev_dev = False
        self._is_screen_dev = None
        self._is_screen_version = -1
        self._penalty_groups_dev = jnp.asarray(
            state.penalty.astype(state.dtype)
        )

    def large_lmda(self):
        return large_lmda(self.s.dtype)

    def update_loss_null(self):
        pass  # gaussian loss_null is free (reference update_loss_null_f no-op)

    # pin mode: the screen set is FIXED (reference StateGaussianPinNaive)
    # — mask every group as screened so the KKT verdict is vacuous and the
    # chunk scan accepts every lambda
    pin_mode = False

    def _screen_mask(self):
        s = self.s
        if self.pin_mode:
            if self._is_screen_dev is None or not bool(self._is_screen_dev.all()):
                self._is_screen_dev = jnp.ones(len(s.groups), bool)
            return self._is_screen_dev
        return s.screen_mask_dev()

    def fit(self, lmda):
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        if cache.A is None:
            cache.rebuild_weighted(s.weights, s.intercept)

        dtype = s.dtype
        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)

        out = self._step(
            self._X_data,
            cache.A, cache.Xs, cache.means_s, cache.cols_padded,
            cache.slot_begin, cache.slot_size, cache.eigvals, cache.eigvecs,
            cache.penalty_slots,
            beta0_dev, active0,
            s.resid, s.weights, s.X_means,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            jnp.asarray(lmda, dtype), jnp.asarray(s.alpha, dtype),
            jnp.asarray(s.tol, dtype), jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype),
        )
        (beta, active, rsq, resid_new, resid_sum, grad, abs_grad,
         kkt_passed, iters, done) = out

        # ONE host pull for the small outputs; resid/grad stay on device
        beta_h, active_h, rsq_h, rs_h, ag_h, kkt_h, done_h = jax.device_get(
            (beta, active, rsq, resid_sum, abs_grad, kkt_passed, done)
        )
        if not bool(done_h):
            raise MaxCDsError()

        s.resid = resid_new
        s.grad = grad
        s.resid_sum = float(rs_h)
        s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
        s.screen_is_active = np.asarray(active_h)[: len(s.screen_set)].copy()
        s.prune_inactive_zeros()
        s.rsq = float(rsq_h)
        s.abs_grad = np.asarray(ag_h)
        self._last_kkt = bool(kkt_h)
        return sw.elapsed()

    def update_invariance(self, lmda):
        # folded into the fused fit step; only record lambda
        self.s.lmda = lmda

    def kkt(self, lmda):
        return self._last_kkt

    def update_solutions(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        self._record(lmda, s.screen_beta, s.rsq, s.resid_sum, cache)

    def _record(self, lmda, screen_beta, rsq, resid_sum, cache):
        s = self.s
        nz = np.abs(screen_beta) > 0
        beta_row = sp.csr_matrix(
            (screen_beta[nz], (np.zeros(int(nz.sum()), int), cache.cols[nz])),
            shape=(1, s.p),
        )
        s.betas.append(beta_row)
        s.intercepts.append(
            float(s.intercept) * (s.y_mean + resid_sum) if s.intercept else 0.0
        )
        s.lmdas.append(float(lmda))
        s.rsqs.append(float(rsq))
        s.devs.append(float(rsq) / s.y_var if s.y_var > 0 else 0.0)

    # ------------------------------------------------------------------ #
    # chunked path driver (round-trip-minimizing outer loop)           #
    # ------------------------------------------------------------------ #

    def _run_chunk(self, lmdas, record):
        """Run a chunk of lambdas in one device call.

        Returns (n_accepted, early_stopped, kkt_clean).  ``kkt_clean`` is
        True when no processed lambda failed KKT — a chunk frozen by the
        sweep budget (or deviance early exit) with every processed lambda
        accepted must NOT be treated as a KKT failure by the next screen()
        call (which would needlessly union in the strong set).  State is
        advanced through the last processed lambda (KKT-failed fits keep
        their iterate, as in the reference retry loop,
        solver_base.hpp:605-686).
        """
        s = self.s
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        if cache.A is None:
            cache.rebuild_weighted(s.weights, s.intercept)

        dtype = s.dtype
        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)

        carry, emits = self._chunk_step(
            self._X_data,
            cache.A, cache.Xs, cache.means_s, cache.cols_padded,
            cache.slot_begin, cache.slot_size, cache.eigvals, cache.eigvecs,
            cache.penalty_slots,
            beta0_dev, active0,
            s.resid, s.weights, s.X_means,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            jnp.asarray(lm_pad, dtype), jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(s.tol, dtype),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.rsq, dtype),
            jnp.asarray(s.y_var, dtype), jnp.asarray(s.adev_tol, dtype),
            jnp.asarray(s.ddev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
            jnp.asarray(configs.chunk_sweep_budget, jnp.int32),
        )
        (beta_f, active_f, resid_f, rsq_f, abs_grad_f, stopped_f,
         prev_dev_f, have_prev_f, early_seen_f) = carry
        (betas_e, rsqs_e, rsums_e, accepts_e, kkts_e, dones_e, devs_e,
         processed_e, iters_e) = emits

        # single host pull of everything small
        (beta_h, active_h, rsq_h, abs_grad_h, prev_dev_h, have_prev_h,
         betas_np, rsqs_np, rsums_np, accepts_np, kkts_np, dones_np,
         devs_np, processed_np) = jax.device_get((
            beta_f, active_f, rsq_f, abs_grad_f, prev_dev_f, have_prev_f,
            betas_e, rsqs_e, rsums_e, accepts_e, kkts_e, dones_e, devs_e,
            processed_e,
        ))

        # a pin non-convergence raises AFTER the accepted prefix is
        # recorded and the state advanced (valid-partial-state contract,
        # reference py_state.cpp:83-89 — the GLM and streamed drivers
        # already honor it)
        pin_fail = np.flatnonzero(processed_np & ~dones_np)

        n_proc = int(processed_np.sum())
        n_acc = int(accepts_np[:n_proc].sum())  # accepts are a prefix
        # stop was a deviance early-exit (not a KKT failure or a sweep-
        # budget freeze) iff the early flag was raised on device
        early_stopped = bool(jax.device_get(early_seen_f))
        kkt_clean = n_acc == n_proc

        # record accepted solutions
        if record:
            S_val = cache.S_val
            iters_np = np.asarray(jax.device_get(iters_e))
            G_s = len(s.screen_set)
            for i in range(n_proc):
                if accepts_np[i]:
                    self._record(
                        lm_pad[i], np.asarray(betas_np[i][:S_val]),
                        rsqs_np[i], rsums_np[i], cache,
                    )
                    s.n_valid_solutions.append(True)
                    s.active_sizes.append(int(np.asarray(active_h).sum()))
                    s.screen_sizes.append(len(s.screen_set))
                else:
                    s.n_valid_solutions.append(False)
                s.benchmark["cd_iters"].append(int(iters_np[i]))
                s.benchmark["cd_updates"].append(int(iters_np[i]) * G_s)

        # advance state through the last processed lambda
        if n_proc:
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = np.asarray(active_h)[: len(s.screen_set)].copy()
            s.prune_inactive_zeros()
            s.resid = resid_f
            s.rsq = float(rsq_h)
            s.resid_sum = float(rsums_np[n_proc - 1]) if n_proc else s.resid_sum
            s.abs_grad = np.asarray(abs_grad_h)
            s.lmda = float(lm_pad[n_proc - 1])
            if record:
                # dry fits must not seed the ddev early-exit comparison
                self._prev_dev = float(prev_dev_h)
                self._have_prev_dev = bool(have_prev_h)
        s.benchmark["fit_screen"].append(sw.elapsed())
        if len(pin_fail):
            raise MaxCDsError(int(pin_fail[0]))
        return n_acc, early_stopped, kkt_clean

    def solve_path(self, progress_bar=False, exit_cond=None):
        """Chunked BASIL loop (replaces basil.solve_core for gaussian)."""
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

        # --- lmda_max setup ---
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

        # --- lambdas above lmda_max (all-accept fits; record them) ---
        large_count = int(np.searchsorted(-path, -s.lmda_max))
        if large_count or s.setup_lmda_max:
            # record the path entries above lmda_max, then position the
            # state at lmda_max without recording (solver_base.hpp:540-595)
            seg = list(path[:large_count])
            Cc = int(s.lmda_chunk)
            for i in range(0, len(seg), Cc):
                n_acc, early, _ = self._run_chunk(seg[i:i + Cc], record=True)
                if early or exit_cond(s):
                    s.total_time = sw.elapsed()
                    return s
            self._run_chunk([s.lmda_max], record=False)

        idx = large_count
        kkt_passed = True
        n_new_active = 0
        current_active = s.active_set_size

        # --- chunked BASIL iterations ---
        while idx < len(path):
            C = min(int(s.lmda_chunk), len(path) - idx)
            chunk = path[idx:idx + C]
            lmda_prev = path[idx + C - 2] if C > 1 else s.lmda
            sw_p = Stopwatch().start()
            screen(s, chunk[-1], kkt_passed, n_new_active,
                   lmda_prev=lmda_prev, lmda_fallback=chunk[0],
                   chunk_size=C)
            s.benchmark["screen"].append(sw_p.elapsed())

            n_acc, early, kkt_clean = self._run_chunk(chunk, record=True)
            idx += n_acc
            if pbar is not None and n_acc:
                pbar.update(n_acc)
                if len(s.devs):
                    pbar.set_postfix_str(f"dev:{100 * s.devs[-1]:.1f}%")
            # budget-frozen chunks with all processed lambdas accepted are
            # NOT KKT failures (ADVICE r2): screening must not union in the
            # strong set for them
            kkt_passed = kkt_clean
            if n_acc:
                n_new_active = s.active_set_size - current_active
                current_active = s.active_set_size
            if early or exit_cond(s):
                break

        if pbar is not None:
            pbar.close()
        s.total_time = sw.elapsed()
        return s
