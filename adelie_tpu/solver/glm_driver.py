"""GLM naive path solver — proximal Newton (IRLS) outer loop.

Device re-design of ``solver_glm_naive.hpp`` (fit :241-459, update_loss_null
:166-232): per IRLS iteration the working weights change, so the screen
Gram + batched eigendecompositions are recomputed from the *cached gathered
block* (one matmul — the analog of the reference recomputing per-group
``X.cov`` + eigh under new weights, :361-385), then one jitted covariance-
form pin solve advances the screen coefficients.  Exception-safe rollback
(save/load_prev_valid, :315-322) is preserved.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..configs import configs
from ..exceptions import MaxCDsError, SolverError
from ..utils import Stopwatch, large_lmda
from .pin import pin_cov_solve, screen_eigh, screen_gram
from .state_core import NaiveStateBase, resid_update_kernel, screen_grad_kernel

_PRECISION = jax.lax.Precision.HIGHEST


@dataclass
class GlmNaiveState(NaiveStateBase):
    glm: object = None
    offsets: object = None       # device (n_flat,)
    beta0: float = 0.0
    eta: object = None           # device (n_flat,)
    resid: object = None         # device (n_flat,) = glm.gradient(eta)
    loss_null: float = None
    loss_full: float = None
    irls_max_iters: int = int(1e4)
    irls_tol: float = 1e-7
    setup_loss_null: bool = True


def _hessian_floor(hess, dtype):
    hmin = (
        configs.hessian_min
        if np.dtype(dtype) == np.float64
        else configs.hessian_min_f32
    )
    return jnp.maximum(hess, 0.0) + hmin * (hess <= 0)


class GlmNaiveDriver:
    def __init__(self, state: GlmNaiveState):
        self.s = state
        self._is_screen_dev = None
        self._is_screen_version = -1
        self._penalty_groups_dev = jnp.asarray(
            state.penalty.astype(state.dtype)
        )
        self._last_kkt = None
        self._last_loss = None
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

    # -- intercept-only IRLS for loss_null (reference :166-232) ------------ #
    def update_loss_null(self):
        """One fused device call (lax.while) instead of a python IRLS loop
        with ~4 host syncs per iteration."""
        s = self.s
        if not s.setup_loss_null or s.loss_null is not None:
            return
        glm = s.glm
        if not s.intercept:
            s.loss_null = float(glm.loss(s.offsets))
            return
        dtype = s.dtype

        def body(carry):
            beta0, eta, resid, _, it, _ = carry
            hess = _hessian_floor(glm.hessian(eta, resid), dtype)
            irls_y_work = glm.inv_hessian_gradient(eta, resid, hess)
            beta0_n = jnp.sum(hess * (irls_y_work + eta - s.offsets)) / jnp.sum(hess)
            eta_n = beta0_n + s.offsets
            resid_n = glm.gradient(eta_n)
            crit = jnp.abs(jnp.sum((resid_n - resid) * (eta_n - eta)))
            return (beta0_n, eta_n, resid_n, crit, it + 1,
                    crit <= s.irls_tol)

        def cond(carry):
            _, _, _, _, it, done = carry
            return (~done) & (it < s.irls_max_iters)

        init = (jnp.asarray(s.beta0, dtype), s.eta, s.resid,
                jnp.asarray(jnp.inf, dtype), jnp.zeros((), jnp.int32),
                jnp.zeros((), bool))
        beta0, eta, resid, crit, iters, done = jax.lax.while_loop(
            cond, body, init
        )
        loss_null, done_h = jax.device_get((glm.loss(eta), done))
        if not bool(done_h):
            raise SolverError("Maximum IRLS iterations reached (loss_null).")
        s.loss_null = float(loss_null)

    # -- proximal-Newton fit at one lambda (reference :241-459) ------------ #
    def fit(self, lmda):
        """Fused path: the whole IRLS fit + invariance + KKT is ONE device
        call (glm_fused.py); a single host pull of small outputs."""
        from .glm_fused import get_glm_step

        s = self.s
        glm = s.glm
        dtype = s.dtype
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()

        saved_beta = s.screen_beta.copy()
        saved_active = s.screen_is_active.copy()

        step = get_glm_step(
            glm, s.X, s.intercept, len(s.groups), cache.qmax, dtype
        )
        X_data = s.X.mul_spec()[1]
        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        tol_base = s.tol * (s.loss_null - s.loss_full)

        out = step(
            X_data,
            cache.Xs, cache.cols_padded, cache.slot_begin, cache.slot_size,
            cache.penalty_slots,
            beta0_dev, active0,
            s.eta, s.resid, jnp.asarray(s.beta0, dtype), s.offsets,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            jnp.asarray(lmda, dtype), jnp.asarray(s.alpha, dtype),
            jnp.asarray(tol_base, dtype),
            jnp.asarray(s.irls_tol, dtype),
            jnp.asarray(s.irls_max_iters, jnp.int32),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
        )
        (beta, active, eta, resid, b0, grad, abs_grad, kkt_passed,
         loss, irls_iters, converged, pin_ok) = out

        beta_h, active_h, b0_h, ag_h, kkt_h, loss_h, conv_h, ok_h = (
            jax.device_get((beta, active, b0, abs_grad, kkt_passed, loss,
                            converged, pin_ok))
        )
        if not bool(ok_h):
            s.screen_beta = saved_beta
            s.screen_is_active = saved_active
            raise MaxCDsError()
        if not bool(conv_h):
            s.screen_beta = saved_beta
            s.screen_is_active = saved_active
            raise SolverError("Maximum IRLS iterations reached.")

        s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
        s.screen_is_active = np.asarray(active_h)[: len(s.screen_set)].copy()
        s.eta = eta
        s.resid = resid
        s.beta0 = float(b0_h)
        s.grad = grad
        s.abs_grad = np.asarray(ag_h)
        self._last_kkt = bool(kkt_h)
        self._last_loss = float(loss_h)
        return sw.elapsed()

    def update_invariance(self, lmda):
        # grad/abs_grad are folded into the fused fit step; record lambda
        s = self.s
        s.lmda = lmda
        if self._last_kkt is None:  # unfused path (constrained driver)
            ones = jnp.ones((s.resid.shape[0],), s.dtype)
            s.grad = s.X.mul(s.resid, ones)
            s.update_abs_grad(lmda)

    def kkt(self, lmda):
        if self._last_kkt is not None:
            return self._last_kkt
        return self.s.kkt(lmda)

    def update_solutions(self, lmda):
        s = self.s
        cache = s.ensure_screen_cache()
        nz = np.abs(s.screen_beta) > 0
        beta_row = sp.csr_matrix(
            (s.screen_beta[nz], (np.zeros(nz.sum(), int), cache.cols[nz])),
            shape=(1, s.p),
        )
        s.betas.append(beta_row)
        s.intercepts.append(s.beta0 if s.intercept else 0.0)
        s.lmdas.append(lmda)
        loss = (
            self._last_loss if self._last_loss is not None
            else float(s.glm.loss(s.eta))
        )
        s.devs.append((s.loss_null - loss) / (s.loss_null - s.loss_full))

    # ------------------------------------------------------------------ #
    # chunked path driver (one device call per lambda batch)              #
    # ------------------------------------------------------------------ #

    def _run_chunk(self, lmdas, record):
        """Fit a batch of lambdas in one device call (glm_fused.py chunk).

        Returns (n_accepted, early_stopped); state advances through the
        last ACCEPTED lambda (failed IRLS fits keep their pre-fit iterate,
        reference solver_glm_naive.hpp:315-322).
        """
        from .glm_fused import get_glm_chunk_step

        s = self.s
        glm = s.glm
        dtype = s.dtype
        sw = Stopwatch().start()
        cache = s.ensure_screen_cache()
        step = get_glm_chunk_step(
            glm, s.X, s.intercept, len(s.groups), cache.qmax, dtype
        )
        X_data = s.X.mul_spec()[1]

        C = int(s.lmda_chunk)
        lmdas = np.asarray(lmdas, float)
        nval = len(lmdas)
        lm_pad = np.full(C, lmdas[-1] if nval else 1.0)
        lm_pad[:nval] = lmdas
        valid = np.zeros(C, bool)
        valid[:nval] = True

        beta0_dev = cache.pad_screen_values(s.screen_beta, dtype)
        active0 = cache.pad_group_bools(s.screen_is_active)
        tol_base = s.tol * (s.loss_null - s.loss_full)

        carry, emits = step(
            X_data,
            cache.Xs, cache.cols_padded, cache.slot_begin, cache.slot_size,
            cache.penalty_slots,
            beta0_dev, active0,
            s.eta, s.resid, jnp.asarray(s.beta0, dtype), s.offsets,
            s._group_ids, s._penalty_cols, self._penalty_groups_dev,
            self._screen_mask(),
            jnp.asarray(lm_pad, dtype), jnp.asarray(valid),
            jnp.asarray(s.alpha, dtype), jnp.asarray(tol_base, dtype),
            jnp.asarray(s.irls_tol, dtype),
            jnp.asarray(s.irls_max_iters, jnp.int32),
            jnp.asarray(configs.dbeta_tol, dtype),
            jnp.asarray(s.newton_tol, dtype),
            jnp.asarray(s.newton_max_iters, jnp.int32),
            jnp.asarray(s.max_iters, jnp.int32),
            jnp.asarray(s.loss_null, dtype), jnp.asarray(s.loss_full, dtype),
            jnp.asarray(s.adev_tol, dtype), jnp.asarray(s.ddev_tol, dtype),
            jnp.asarray(bool(s.early_exit)),
            jnp.asarray(self._prev_dev, dtype),
            jnp.asarray(self._have_prev_dev),
            jnp.asarray(configs.chunk_sweep_budget, jnp.int32),
        )
        (beta_f, active_f, eta_f, resid_f, b0_f, abs_grad_f, stopped_f,
         prev_dev_f, have_prev_f, early_seen_f) = carry
        (betas_e, b0s_e, accepts_e, kkts_e, fitok_e, pinok_e, devs_e,
         losses_e, processed_e, irls_e) = emits

        (beta_h, active_h, b0_h, ag_h, stopped_h, prevdev_h, haveprev_h,
         betas_np, b0s_np, accepts_np, kkts_np, fitok_np, pinok_np, devs_np,
         processed_np) = jax.device_get((
            beta_f, active_f, b0_f, abs_grad_f, stopped_f, prev_dev_f,
            have_prev_f, betas_e, b0s_e, accepts_e, kkts_e, fitok_e,
            pinok_e, devs_e, processed_e,
        ))

        n_proc = int(processed_np.sum())
        n_acc = int(accepts_np[:n_proc].sum())
        # all processed lambdas accepted => freeze was budget/early-driven,
        # not a KKT failure (see gaussian.py _run_chunk docstring)
        kkt_clean = n_acc == n_proc

        # advance state through the last successful fit BEFORE raising, so
        # a failure still leaves a valid partial state (py_state.cpp:83-89)
        if n_acc or n_proc:
            s.screen_beta = np.asarray(beta_h)[: cache.S_val].copy()
            s.screen_is_active = np.asarray(active_h)[: len(s.screen_set)].copy()
            s.eta = eta_f
            s.resid = resid_f
            s.beta0 = float(b0_h)
            s.abs_grad = np.asarray(ag_h)
            if record:
                # dry fits must not seed the ddev early-exit comparison
                self._prev_dev = float(prevdev_h)
                self._have_prev_dev = bool(haveprev_h)
            if n_proc:
                s.lmda = float(lm_pad[n_proc - 1])

        if record:
            for i in range(n_proc):
                if accepts_np[i]:
                    sb = np.asarray(betas_np[i][: cache.S_val])
                    nz = np.abs(sb) > 0
                    beta_row = sp.csr_matrix(
                        (sb[nz], (np.zeros(int(nz.sum()), int),
                                  cache.cols[nz])),
                        shape=(1, s.p),
                    )
                    s.betas.append(beta_row)
                    s.intercepts.append(
                        float(b0s_np[i]) if s.intercept else 0.0
                    )
                    s.lmdas.append(float(lm_pad[i]))
                    s.devs.append(float(devs_np[i]))
                    s.n_valid_solutions.append(True)
                    s.active_sizes.append(int(np.asarray(active_h).sum()))
                    s.screen_sizes.append(len(s.screen_set))
                else:
                    s.n_valid_solutions.append(False)

        # IRLS failures raise AFTER the state advance (valid partial state)
        bad = processed_np & ~fitok_np
        if np.any(bad):
            i = int(np.argmax(bad))
            if not pinok_np[i]:
                raise MaxCDsError()
            raise SolverError("Maximum IRLS iterations reached.")

        early_stopped = bool(jax.device_get(early_seen_f))
        s.benchmark["fit_screen"].append(sw.elapsed())
        return n_acc, early_stopped, kkt_clean

    def solve_path(self, progress_bar=False, exit_cond=None):
        """Chunked BASIL loop for GLMs (mirrors gaussian solve_path)."""
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

        self.update_loss_null()

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
                n_acc, early, _ = self._run_chunk(seg[i:i + Cc], record=True)
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
