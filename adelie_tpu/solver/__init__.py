"""Solver entry points mirroring ``adelie.solver`` (reference adelie/solver.py).

``grpnet`` is the flagship: group elastic net over a lambda path for any GLM,
dispatching to the gaussian fast path (no IRLS) when possible
(reference solver.py:682-695) and reformulating multi-response problems onto
``X (x) I_K`` (reference solver.py:700-763).
"""

import jax
import numpy as np
import jax.numpy as jnp

from .. import glm as glm_mod
from .. import matrix as matrix_mod
from ..configs import f32_contractions
from ..utils import types
from ..logger import logger
from . import basil
from .basil import compute_lmda_max, compute_lmda_path, solve_core
from .gaussian import GaussianNaiveDriver, GaussianNaiveState
from .glm_driver import GlmNaiveDriver, GlmNaiveState

__all__ = ["grpnet", "gaussian_cov", "bvls", "pinball", "css_cov"]


def _as_matrix(X):
    if isinstance(X, matrix_mod.MatrixNaiveBase):
        return X
    return matrix_mod.dense(np.asarray(X))


def _common_state_kwargs(**kw):
    return kw


@f32_contractions
def grpnet(
    X,
    glm,
    *,
    constraints=None,
    groups=None,
    alpha: float = 1.0,
    penalty=None,
    offsets=None,
    lmda_path=None,
    irls_max_iters: int = int(1e4),
    irls_tol: float = 1e-7,
    max_iters: int = int(1e5),
    tol: float = 1e-7,
    adev_tol: float = 0.9,
    ddev_tol: float = 0.0,
    newton_tol: float = 1e-12,
    newton_max_iters: int = 1000,
    n_threads: int = 1,
    early_exit: bool = True,
    intercept: bool = True,
    screen_rule: str = "pivot",
    min_ratio: float = 1e-2,
    lmda_path_size: int = 100,
    max_screen_size: int = None,
    max_active_size: int = None,
    pivot_subset_ratio: float = 0.1,
    pivot_subset_min: int = 1,
    pivot_slack_ratio: float = 1.25,
    screen_cap_active_mult: float = None,
    check_state: bool = False,
    progress_bar: bool = False,
    warm_start=None,
    exit_cond=None,
):
    """Group elastic net solver (reference solver.py:354-958).

    Minimizes  ell(eta) + lmda * sum_g w_g (alpha ||b_g||_2 +
    (1-alpha)/2 ||b_g||_2^2)  with  eta = X b + b0 1 + offsets,
    over a decreasing lambda path with BASIL screening.

    ``screen_cap_active_mult`` (extension, default None = reference
    pivot-rule behavior): cap each screen call's SPECULATIVE admissions
    at this multiple of the active-ish count.  On LD/correlated designs
    the pivot rule can admit thousands of near-duplicate groups (EUR
    surrogate: 10,268 screened for 278 actives) and fit cost is O(S^2);
    with the cap the same path fits a ~3x smaller screen set, still
    KKT-certified (true violators are always force-admitted on retry).
    ``3.0`` is the measured sweet spot for GWAS-like LD designs.
    """
    screen_rule = types.screen_rule(screen_rule)
    X = _as_matrix(X)
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()

    has_constraints = constraints is not None and any(
        c is not None for c in constraints
    )
    if has_constraints:
        from .constrained import check_constraints_supported

        check_constraints_supported(constraints)

    y_arr = np.asarray(glm.y)
    if offsets is None:
        offsets_np = np.zeros(y_arr.shape, dtype)
    else:
        offsets_np = np.asarray(offsets, dtype)
        if offsets_np.shape != y_arr.shape:
            raise RuntimeError("offsets must be same shape as y if not None.")

    if lmda_path is not None:
        lmda_path = np.array(np.flip(np.sort(lmda_path)), dtype=float)

    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)

    if dtype == np.float64 and not jax.config.jax_enable_x64:
        logger.warning(
            "float64 inputs but jax x64 is disabled: computation runs in "
            "float32, so tolerances below ~1e-7 may never be met (slow "
            "convergence). Enable jax_enable_x64 or pass float32 data."
        )

    is_gaussian_opt = glm.name in ("gaussian", "multigaussian") and glm.opt

    # ---- multi-response reformulation (reference solver.py:700-763) ---- #
    if glm.is_multi:
        from .multi import build_multi_problem

        return build_multi_problem(
            X=X, glm=glm, groups=groups, alpha=alpha, penalty=penalty,
            constraints=list(constraints) if has_constraints else None,
            offsets=offsets_np, lmda_path=lmda_path, intercept=intercept,
            is_gaussian_opt=is_gaussian_opt, warm_start=warm_start,
            solver_kwargs=dict(
                irls_max_iters=irls_max_iters, irls_tol=irls_tol,
                max_iters=max_iters, tol=tol, adev_tol=adev_tol,
                ddev_tol=ddev_tol, newton_tol=newton_tol,
                newton_max_iters=newton_max_iters, early_exit=early_exit,
                screen_rule=screen_rule, min_ratio=min_ratio,
                lmda_path_size=lmda_path_size, max_screen_size=max_screen_size,
                max_active_size=max_active_size,
                pivot_subset_ratio=pivot_subset_ratio,
                pivot_subset_min=pivot_subset_min,
                pivot_slack_ratio=pivot_slack_ratio,
                screen_cap_active_mult=screen_cap_active_mult,
            ),
            progress_bar=progress_bar, exit_cond=exit_cond,
        )

    # ---- single-response ---- #
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    else:
        penalty = np.asarray(penalty, float)

    common = dict(
        X=X, groups=groups, group_sizes=group_sizes, alpha=float(alpha),
        penalty=penalty, intercept=bool(intercept), dtype=dtype, n=n, p=p,
        max_iters=int(max_iters), tol=float(tol), adev_tol=float(adev_tol),
        ddev_tol=float(ddev_tol), newton_tol=float(newton_tol),
        newton_max_iters=int(newton_max_iters), early_exit=bool(early_exit),
        min_ratio=float(min_ratio), lmda_path_size=int(lmda_path_size),
        max_screen_size=max_screen_size, max_active_size=max_active_size,
        pivot_subset_ratio=float(pivot_subset_ratio),
        pivot_subset_min=int(pivot_subset_min),
        pivot_slack_ratio=float(pivot_slack_ratio),
        screen_cap_active_mult=(None if screen_cap_active_mult is None
                                else float(screen_cap_active_mult)),
        screen_rule=screen_rule, lmda_path=lmda_path,
        setup_lmda_path=lmda_path is None,
    )

    if warm_start is None:
        from ..configs import configs as _cfg

        if p + int(group_sizes.max()) <= _cfg.screen_all_max:
            # small-problem fast path: the whole Gram is small, so skip
            # BASIL screening entirely (zero KKT retries)
            screen_set = np.arange(G)
        else:
            screen_set = np.arange(G)[(penalty <= 0) | (alpha <= 0)]
        gs = group_sizes[screen_set]
        screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        screen_beta = np.zeros(int(gs.sum()), dtype)
        # unpenalized groups start active (reference solver.py:856-862)
        screen_is_active = ((penalty[screen_set] <= 0) | (alpha <= 0))
        lmda = np.inf
        lmda_max = None
    else:
        screen_set = np.asarray(warm_start.screen_set)
        screen_begins = np.asarray(warm_start.screen_begins)
        screen_beta = np.asarray(warm_start.screen_beta)
        screen_is_active = np.asarray(warm_start.screen_is_active)
        lmda = warm_start.lmda
        lmda_max = warm_start.lmda_max
        # guard against a warm start fitted under different grouping
        if (
            (len(screen_set) and screen_set.max() >= G)
            or len(screen_beta) != int(group_sizes[screen_set].sum())
        ):
            raise ValueError(
                "warm_start is inconsistent with the requested groups: "
                f"it was fitted with a different grouping (G={G}, "
                f"screen value size {len(screen_beta)})."
            )

    common.update(
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=lmda, lmda_max=lmda_max,
        setup_lmda_max=lmda_max is None,
    )

    if is_gaussian_opt:
        y = jnp.asarray(y_arr, dtype)
        weights = jnp.asarray(np.asarray(glm.weights), dtype)
        offs = jnp.asarray(offsets_np, dtype)
        if warm_start is None:
            ones = jnp.ones((n,), dtype)
            y_off = y - offs
            y_mean = float(jnp.vdot(weights, y_off))
            yc = y_off - y_mean if intercept else y_off
            y_var = float(jnp.vdot(weights, yc * yc))
            resid = yc
            resid_sum = float(jnp.vdot(weights, resid))
            if getattr(X, "is_streaming", False):
                # one pass over the host-streamed bytes for both full-p
                # setup products (each pass re-streams the whole panel)
                both = X.mul_many(jnp.stack([weights * ones,
                                             weights * resid]))
                X_means, grad = both[:, 0], both[:, 1]
            else:
                X_means = X.mul(ones, weights)
                grad = X.mul(resid, weights)
            rsq = 0.0
        else:
            X_means = warm_start.X_means
            y_mean = warm_start.y_mean
            y_var = warm_start.y_var
            rsq = warm_start.rsq
            resid = warm_start.resid
            resid_sum = warm_start.resid_sum
            grad = warm_start.grad

        state = GaussianNaiveState(
            weights=weights, X_means=X_means, y_mean=y_mean, y_var=y_var,
            rsq=rsq, resid=resid, resid_sum=resid_sum, **common,
        )
        state.grad = grad
        # attach glm/offsets for diagnostics + CV (reference keeps the glm
        # inside the state wrapper, state.py create_from_core)
        state.glm = glm
        state.offsets = offs
        if has_constraints:
            if getattr(X, "is_streaming", False):
                from .streamed import StreamedConstrainedGaussianDriver

                driver = StreamedConstrainedGaussianDriver(
                    state, list(constraints)
                )
            else:
                from .constrained import ConstrainedGaussianDriver

                driver = ConstrainedGaussianDriver(state, list(constraints))
        elif getattr(X, "is_streaming", False):
            from .streamed import StreamedGaussianDriver

            driver = StreamedGaussianDriver(state)
        else:
            driver = GaussianNaiveDriver(state)
    else:
        offs = jnp.asarray(offsets_np.ravel(), dtype)
        if warm_start is None:
            eta = offs
            resid = glm.gradient(eta)
            ones = jnp.ones((n,), dtype)
            grad = X.mul(resid, ones)
            loss_null = None
            loss_full = float(glm.loss_full())
            beta0 = 0.0
        else:
            eta = warm_start.eta
            resid = warm_start.resid
            grad = warm_start.grad
            loss_null = warm_start.loss_null
            loss_full = warm_start.loss_full
            beta0 = warm_start.beta0

        state = GlmNaiveState(
            glm=glm, offsets=offs, beta0=beta0, eta=eta, resid=resid,
            loss_null=loss_null, loss_full=loss_full,
            irls_max_iters=int(irls_max_iters), irls_tol=float(irls_tol),
            **common,
        )
        state.grad = grad
        if has_constraints:
            from .constrained import ConstrainedGlmDriver

            driver = ConstrainedGlmDriver(state, list(constraints))
        elif getattr(X, "is_streaming", False):
            from .streamed import StreamedGlmDriver

            driver = StreamedGlmDriver(state)
        else:
            driver = GlmNaiveDriver(state)

    if warm_start is not None:
        # restore the KKT invariance quantities (reference carries abs_grad
        # inside the state object across warm starts)
        state.abs_grad = getattr(warm_start, "abs_grad", None)
        if state.abs_grad is None and np.isfinite(state.lmda):
            state.update_abs_grad(state.lmda)

    try:
        if hasattr(driver, "solve_path"):
            driver.solve_path(progress_bar=progress_bar, exit_cond=exit_cond)
        else:
            solve_core(state, driver, progress_bar=progress_bar,
                       exit_cond=exit_cond)
    except Exception as exc:  # return valid partial state (reference py_state.cpp:83-89)
        import traceback

        state.error = str(exc)
        logger.error(f"solver: {exc}\n{traceback.format_exc()}")

    return finalize_state(state)


def finalize_state(state):
    """Convert output lists to arrays (reference state.py create_from_core)."""
    import scipy.sparse as sp

    if len(state.betas):
        state.betas = sp.vstack(state.betas).tocsr()
    else:
        state.betas = sp.csr_matrix((0, state.p))
    state.intercepts = np.asarray(state.intercepts)
    state.lmdas = np.asarray(state.lmdas)
    state.devs = np.asarray(state.devs)
    return state


@f32_contractions
def gaussian_cov(A, v, **kwargs):
    """Covariance-method group elastic net (reference solver.py:39-351)."""
    from ._cov import gaussian_cov as _impl

    return _impl(A, v, **kwargs)


@f32_contractions
def bvls(X, y, lower, upper, **kwargs):
    """Bounded-variable least squares (reference solver.py:961)."""
    from ._bvls import bvls as _impl

    return _impl(X, y, lower, upper, **kwargs)


@f32_contractions
def pinball(A, S, v, penalty_neg, penalty_pos, **kwargs):
    """Pinball least squares (reference solver.py:1119)."""
    from ._pinball import pinball as _impl

    return _impl(A, S, v, penalty_neg, penalty_pos, **kwargs)


@f32_contractions
def css_cov(S, subset_size=None, **kwargs):
    """Column subset selection (reference solver.py:1274)."""
    from ._css import css_cov as _impl

    return _impl(S, subset_size, **kwargs)
