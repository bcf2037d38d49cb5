"""Public state factories (reference adelie/state.py).

The reference exposes one state class per solver, holding all inputs,
configs, and dynamic invariants; states are the unit of warm-start and the
object ``solve()`` runs on.  Here the internal states already live as
host+device dataclasses (solver/state_core.py etc.); these factories mirror
the reference's constructors and return a state bound to its driver with
``.solve()`` and ``.check()`` (invariant audit, reference state.py:92-117).
"""

import numpy as np

from . import glm as glm_mod
from . import matrix as matrix_mod
from .logger import logger

__all__ = [
    "gaussian_naive",
    "glm_naive",
    "gaussian_cov",
    "gaussian_pin_naive",
    "gaussian_pin_cov",
    "multigaussian_naive",
    "multiglm_naive",
    "bvls",
    "pinball",
    "css_cov",
    "check_state",
    "base",
    "render_constraints",
    "render_dual_groups",
    "deduce_states",
]


def check_state(state, method: str = "assert"):
    """Audit solver-state invariants (reference state.py check(), e.g. the
    gaussian_pin validator at state.py:180-400).

    Validates, when the corresponding fields are present:

    * problem structure: groups strictly increasing from 0 with positive
      sizes tiling [0, p); penalty nonnegative of length G; alpha in
      [0, 1]; weights nonnegative summing to ~1;
    * screen bookkeeping: screen_set unique, in-range; screen_begins the
      cumulative sizes; screen_beta sized to the screened value count and
      finite; screen_is_active one flag per screen group;
    * invariance quantities: abs_grad (G,) finite and nonnegative; grad
      (p,) finite;
    * outputs: betas/lmdas/intercepts/devs lengths agree; lmdas strictly
      decreasing; devs in [-eps, 1+eps] and nondecreasing (tolerance for
      degenerate paths); off-screen beta columns are exactly zero;
    * screen/active consistency: any screened group carrying a nonzero
      coefficient must be flagged active; per-solution bookkeeping
      (screen_sizes / active_sizes / n_valid_solutions) sized to the
      solution count, active <= screen, screen_sizes nondecreasing
      (BASIL only grows the screen set within a path);
    * duals (constrained paths): one record per solution; every dual
      belongs to a constrained group and matches its dual dimension;
    * benchmark fields: finite nonnegative timings/counters, and
      ``cd_iters`` one entry per solution when the driver records it;
    * residual state: resid/rsq/resid_sum finite when present;
    * configuration sanity: tol/newton_tol positive, max sizes >= current.

    Set ``configs.debug_check_state = True`` to run this audit inside the
    streamed drivers after every certified chunk (reference-style
    always-on ``check()``; costs host time at each chunk boundary).
    """
    failures = []

    def ensure(cond, msg):
        if not cond:
            failures.append(msg)

    if not hasattr(state, "groups"):
        # aux solver states (BVLS / pinball / CSS) have their own shape
        return _check_aux_state(state, method)

    # --- problem structure ---
    groups = np.asarray(state.groups)
    gsizes = np.asarray(state.group_sizes)
    G = len(groups)
    p = int(getattr(state, "p", groups[-1] + gsizes[-1] if G else 0))
    ensure(np.all(gsizes > 0), "group_sizes must be positive")
    ensure(np.array_equal(groups, np.concatenate([[0], np.cumsum(gsizes)])[:-1]),
           "groups must tile [0, p) contiguously")
    ensure(G == 0 or int(groups[-1] + gsizes[-1]) == p,
           "groups/group_sizes must cover exactly p columns")
    penalty = np.asarray(getattr(state, "penalty", np.zeros(0)))
    if penalty.size:
        ensure(len(penalty) == G, "penalty must be (G,)")
        ensure(np.all(penalty >= 0), "penalty must be >= 0")
    alpha = getattr(state, "alpha", 1.0)
    ensure(0.0 <= float(alpha) <= 1.0, "alpha must be in [0, 1]")
    w = getattr(state, "weights", None)
    if w is not None:
        w = np.asarray(w)
        ensure(np.all(w >= 0), "weights must be >= 0")
        ensure(abs(float(w.sum()) - 1.0) < 1e-6, "weights must sum to 1")

    # --- configs ---
    ensure(float(getattr(state, "tol", 1.0)) > 0, "tol must be > 0")
    ensure(float(getattr(state, "newton_tol", 1.0)) >= 0,
           "newton_tol must be >= 0")
    mss = getattr(state, "max_screen_size", None)
    if mss is not None:
        ensure(len(state.screen_set) <= mss,
               "screen_set exceeds max_screen_size")

    # --- screen bookkeeping ---
    ss = np.asarray(state.screen_set)
    ensure(len(np.unique(ss)) == len(ss), "screen_set must be unique")
    ensure(np.all((ss >= 0) & (ss < G)), "screen_set out of range")
    gs = gsizes[ss] if len(ss) else np.zeros(0, int)
    begins = np.concatenate([[0], np.cumsum(gs)])[:-1] if len(ss) else np.zeros(0, int)
    ensure(np.array_equal(np.asarray(state.screen_begins), begins),
           "screen_begins inconsistent with screen_set")
    sbeta = np.asarray(state.screen_beta)
    ensure(len(sbeta) == int(gs.sum()), "screen_beta size inconsistent")
    ensure(np.all(np.isfinite(sbeta)), "screen_beta must be finite")
    ensure(len(state.screen_is_active) == len(ss),
           "screen_is_active size inconsistent")

    # --- invariance quantities ---
    if getattr(state, "abs_grad", None) is not None:
        ag = np.asarray(state.abs_grad)
        ensure(len(ag) == G, "abs_grad must be (G,)")
        ensure(np.all(np.isfinite(ag)), "abs_grad must be finite")
        ensure(np.all(ag >= 0), "abs_grad must be >= 0")
    grad = getattr(state, "grad", None)
    if grad is not None:
        ga = np.asarray(grad)
        ensure(ga.shape == (p,), "grad must be (p,)")
        ensure(np.all(np.isfinite(ga)), "grad must be finite")

    # --- outputs ---
    n_sols = (
        len(state.betas) if isinstance(state.betas, list)
        else state.betas.shape[0]
    )
    lmdas = np.asarray(state.lmdas, float)
    ensure(n_sols == len(lmdas), "betas/lmdas length mismatch")
    intercepts = np.asarray(getattr(state, "intercepts", np.zeros(n_sols)))
    ensure(len(intercepts) == n_sols, "intercepts/betas length mismatch")
    if len(lmdas) > 1:
        ensure(np.all(np.diff(lmdas) < 0), "lmdas must be strictly decreasing")
    devs = np.asarray(getattr(state, "devs", np.zeros(0)), float)
    if devs.size:
        ensure(len(devs) == n_sols, "devs/betas length mismatch")
        # cov-method states (identified by the A member) normalize devs
        # by v-scale proxies, not a true y-variance — the ratio can
        # legitimately exceed 1 (reference rdev semantics)
        if not hasattr(state, "A"):
            ensure(np.all(devs <= 1.0 + 1e-6), "devs must be <= 1")
        ensure(np.all(np.diff(devs) >= -1e-6), "devs must be nondecreasing")
    if (not isinstance(state.betas, list) and n_sols and len(ss) < G
            and state.betas.shape[1] == p):
        # off-screen columns must be exactly zero.  (Multi-response
        # states exclude the per-class intercept columns from betas, so
        # betas.shape[1] < p there; the kron-eye reformulation's own
        # tests cover that layout.)
        in_screen = np.zeros(p, bool)
        for g in ss:
            in_screen[groups[g]:groups[g] + gsizes[g]] = True
        off = state.betas[:, ~in_screen]
        ensure(off.nnz == 0, "nonzero coefficients outside the screen set")

    # --- screen/active consistency ---
    if len(ss) and len(sbeta) == int(gs.sum()):
        act = np.asarray(state.screen_is_active, bool)
        if len(act) == len(ss):
            for k in range(len(ss)):
                seg = sbeta[begins[k]:begins[k] + gs[k]]
                if np.any(seg != 0) and not bool(act[k]):
                    ensure(False, (
                        f"screened group {int(ss[k])} carries nonzero "
                        "coefficients but is not flagged active"))
                    break

    # --- per-solution bookkeeping ---
    for name in ("screen_sizes", "active_sizes", "n_valid_solutions"):
        vals = getattr(state, name, None)
        if vals is not None and len(vals):
            ensure(len(vals) == n_sols, f"{name}/betas length mismatch")
    ssz_raw = getattr(state, "screen_sizes", None)
    ssz = np.asarray(ssz_raw if ssz_raw is not None else [], int)
    if ssz.size:
        ensure(np.all((ssz >= 0) & (ssz <= G)), "screen_sizes out of range")
        ensure(np.all(np.diff(ssz) >= 0),
               "screen_sizes must be nondecreasing within a path")
    asz_raw = getattr(state, "active_sizes", None)
    asz = np.asarray(asz_raw if asz_raw is not None else [], int)
    if asz.size and asz.size == ssz.size:
        ensure(np.all(asz <= ssz), "active_sizes must be <= screen_sizes")

    # --- duals (constrained paths) ---
    duals = getattr(state, "duals", None)
    cons = getattr(state, "constraints", None)
    if duals is not None:
        ensure(len(duals) == n_sols, "duals/betas length mismatch")
        for dd in duals:
            for g, mu in dd.items():
                g = int(g)
                has_c = (cons is not None and 0 <= g < len(cons)
                         and cons[g] is not None)
                ensure(has_c, f"dual recorded for unconstrained group {g}")
                mu = np.asarray(mu)
                ensure(np.all(np.isfinite(mu)),
                       f"dual for group {g} must be finite")
                if has_c:
                    m = cons[g].duals
                    m = int(m() if callable(m) else m)
                    ensure(mu.size == m, (
                        f"dual for group {g} has size {mu.size}, "
                        f"constraint expects {m}"))

    # --- benchmark fields ---
    bm = getattr(state, "benchmark", None)
    if isinstance(bm, dict):
        for kf, vals in bm.items():
            flat = []
            for v in vals:
                flat.extend(np.ravel(v).tolist())
            arr = np.asarray(flat, float)
            ensure(np.all(np.isfinite(arr)) and np.all(arr >= 0),
                   f"benchmark[{kf!r}] entries must be finite and >= 0")
        ci = bm.get("cd_iters")
        if ci:
            ensure(len(ci) == n_sols,
                   "benchmark['cd_iters'] must have one entry per solution")

    # --- residual state ---
    for name in ("rsq", "resid_sum"):
        v = getattr(state, name, None)
        if v is not None and np.ndim(v) == 0:
            ensure(np.isfinite(float(v)), f"{name} must be finite")
    lmda = getattr(state, "lmda", None)
    if lmda is not None and np.ndim(lmda) == 0:
        # +inf is the legal pre-fit sentinel (reference large_lmda)
        ensure(not np.isnan(float(lmda)), "lmda must not be NaN")
    resid = getattr(state, "resid", None)
    if resid is not None:
        ensure(bool(np.all(np.isfinite(np.asarray(resid)))),
               "resid must be finite")

    if failures:
        msg = "state check failed: " + "; ".join(failures)
        if method == "assert":
            raise AssertionError(msg)
        logger.warning(msg)
    return failures


def _check_aux_state(state, method: str = "assert"):
    """Invariant audit for the aux solver states (StateBVLS,
    StatePinball, StateCSSCov) whose fields differ from the path states:
    finite iterates, screen/active bookkeeping consistency, bound
    feasibility (BVLS), and subset validity (CSS)."""
    failures = []

    def ensure(cond, msg):
        if not cond:
            failures.append(msg)

    for name in ("beta", "resid", "grad"):
        v = getattr(state, name, None)
        if v is not None:
            ensure(bool(np.all(np.isfinite(np.asarray(v, float)))),
                   f"{name} must be finite")
    loss = getattr(state, "loss", None)
    if loss is not None and not isinstance(loss, str):
        ensure(np.isfinite(float(loss)), "loss must be finite")

    is_screen = getattr(state, "is_screen", None)
    ss = getattr(state, "screen_set", None)
    if is_screen is not None and ss is not None:
        is_screen = np.asarray(is_screen, bool)
        p = len(is_screen)
        ss = np.asarray(ss, int)
        ensure(len(np.unique(ss)) == len(ss), "screen_set must be unique")
        ensure(bool(np.all((ss >= 0) & (ss < p))), "screen_set out of range")
        ensure(bool(np.all(is_screen[ss])) and int(is_screen.sum()) == len(ss),
               "is_screen inconsistent with screen_set")
        act = getattr(state, "active_set", None)
        is_act = getattr(state, "is_active", None)
        if act is not None and is_act is not None:
            act = np.asarray(act, int)
            is_act = np.asarray(is_act, bool)
            ensure(bool(np.all((act >= 0) & (act < p))),
                   "active_set out of range")
            ensure(bool(np.all(is_screen[act])),
                   "active_set must be a subset of the screen set")
            ensure(bool(np.all(is_act[act]))
                   and int(is_act.sum()) == len(act),
                   "is_active inconsistent with active_set")

    lower = getattr(state, "lower", None)
    upper = getattr(state, "upper", None)
    beta = getattr(state, "beta", None)
    if lower is not None and upper is not None:
        lower, upper = np.asarray(lower, float), np.asarray(upper, float)
        ensure(bool(np.all(lower <= upper)), "lower must be <= upper")
        if beta is not None:
            b = np.asarray(beta, float)
            ensure(bool(np.all((b >= lower - 1e-9) & (b <= upper + 1e-9))),
                   "beta violates the [lower, upper] bounds")

    subset = getattr(state, "subset", None)
    if subset is not None:
        S = np.asarray(state.S)
        ensure(S.ndim == 2 and S.shape[0] == S.shape[1],
               "S must be square")
        subset = np.asarray(subset, int)
        ensure(len(np.unique(subset)) == len(subset),
               "subset must be unique")
        ensure(bool(np.all((subset >= 0) & (subset < S.shape[0]))),
               "subset out of range")
        n_sub = getattr(state, "subset_size", None)
        if n_sub:
            ensure(len(subset) == int(n_sub),
                   "subset length must equal subset_size")

    if failures:
        msg = "state check failed: " + "; ".join(failures)
        if method == "assert":
            raise AssertionError(msg)
        logger.warning(msg)
    return failures


class _BoundState:
    """A state + driver pair exposing the reference's ``solve()``."""

    def __init__(self, state, run):
        self._state = state
        self._run = run

    def __getattr__(self, name):
        return getattr(self._state, name)

    def check(self, method: str = "assert"):
        return check_state(self._state, method)

    def solve(self, progress_bar: bool = False, exit_cond=None):
        return self._run(progress_bar, exit_cond)


# Reference-name aliases (reference state.py:79,179,401,723,1421): the
# reference splits its invariant audits across an inheritance hierarchy of
# per-solver base classes; here they all live centrally in check_state, so
# the hierarchy collapses to one wrapper class.
base = _BoundState
gaussian_pin_base = _BoundState
gaussian_pin_naive_base = _BoundState
gaussian_pin_cov_base = _BoundState
gaussian_naive_base = _BoundState


def render_constraints(n_groups, constraints, dtype=None):
    """Normalize a user constraints list to length ``n_groups`` (reference
    state.py:28-45).  ``None`` entries mean unconstrained; a short list is
    left-padded with ``None`` (the multi-response case, where the missing
    entries are the unpenalized intercept columns)."""
    if constraints is None:
        constraints = [None] * n_groups
    constraints = list(constraints)
    if len(constraints) > n_groups:
        raise ValueError(
            "constraints is larger than the number of groups "
            f"({len(constraints)} > {n_groups})"
        )
    if len(constraints) < n_groups:
        constraints = [None] * (n_groups - len(constraints)) + constraints
    return constraints


def _dual_size(c):
    d = getattr(c, "duals", None)
    return int(d() if callable(d) else d)


def render_dual_groups(constraints):
    """Starting offset of each group's dual block (reference
    state.py:48-54): exclusive cumsum of per-group dual sizes (0 for
    unconstrained groups)."""
    sizes = [0 if c is None else _dual_size(c) for c in constraints]
    return np.cumsum(np.concatenate([[0], sizes]), dtype=int)[:-1]


def deduce_states(*, constraints, group_sizes, screen_set, dtype=None):
    """Derive the members every solver state shares (reference
    state.py:57-76): the normalized constraints list and the screen-set
    coefficient offsets ``screen_begins``."""
    group_sizes = np.asarray(group_sizes)
    screen_set = np.asarray(screen_set)
    constraints = render_constraints(group_sizes.shape[0], constraints, dtype)
    screen_begins = np.cumsum(
        np.concatenate([[0], group_sizes[screen_set]]), dtype=int
    )[:-1]
    return constraints, screen_begins


def _factory(X, glm, kwargs):
    from .solver import grpnet

    def run(progress_bar=False, exit_cond=None):
        return grpnet(X, glm, progress_bar=progress_bar,
                      exit_cond=exit_cond, **kwargs)

    return run


def gaussian_naive(*, X, y=None, glm=None, weights=None, **kwargs):
    """Gaussian naive solver state (reference state.py:1677)."""
    if glm is None:
        glm = glm_mod.gaussian(np.asarray(y), weights)
    run = _factory(X, glm, kwargs)

    class _S:
        def solve(self, progress_bar=False, exit_cond=None):
            return run(progress_bar, exit_cond)

        @staticmethod
        def check(state, method="assert"):
            return check_state(state, method)

    return _S()


def glm_naive(*, X, glm, **kwargs):
    """GLM naive (IRLS) solver state (reference state.py:2407)."""
    run = _factory(X, glm, kwargs)

    class _S:
        def solve(self, progress_bar=False, exit_cond=None):
            return run(progress_bar, exit_cond)

        @staticmethod
        def check(state, method="assert"):
            return check_state(state, method)

    return _S()


def gaussian_cov(*, A, v, **kwargs):
    """Covariance-method solver state (reference state.py:1128)."""
    from .solver import gaussian_cov as _solve

    class _S:
        def solve(self, progress_bar=False, exit_cond=None):
            return _solve(A, v, progress_bar=progress_bar,
                          exit_cond=exit_cond, **kwargs)

        @staticmethod
        def check(state, method="assert"):
            return check_state(state, method)

    return _S()


def multigaussian_naive(*, X, y, weights=None, **kwargs):
    """Multi-response gaussian state (reference state.py multigaussian)."""
    glm = glm_mod.multigaussian(np.asarray(y), weights)
    run = _factory(X, glm, kwargs)

    class _S:
        def solve(self, progress_bar=False, exit_cond=None):
            return run(progress_bar, exit_cond)

    return _S()


def multiglm_naive(*, X, glm, **kwargs):
    """Multi-response GLM state (reference state.py multiglm)."""
    run = _factory(X, glm, kwargs)

    class _S:
        def solve(self, progress_bar=False, exit_cond=None):
            return run(progress_bar, exit_cond)

    return _S()


def bvls(*, X, y, lower, upper, **kwargs):
    """BVLS solver state (reference state.py bvls)."""
    from .solver._bvls import bvls as _impl

    class _S:
        def solve(self):
            return _impl(X, y, lower, upper, **kwargs)

    return _S()


def pinball(*, A, S, v, penalty_neg, penalty_pos, **kwargs):
    """Pinball solver state (reference state.py pinball)."""
    from .solver._pinball import pinball as _impl

    class _S:
        def solve(self):
            return _impl(A, S, v, penalty_neg, penalty_pos, **kwargs)

    return _S()


def css_cov(*, S, subset_size=None, **kwargs):
    """CSS solver state (reference state.py css_cov)."""
    from .solver._css import css_cov as _impl

    class _S:
        def solve(self):
            return _impl(S, subset_size, **kwargs)

    return _S()


def gaussian_pin_naive(
    *, X, y=None, groups=None, alpha: float = 1.0, penalty=None,
    weights=None, screen_set=None, lmda_path=None,
    resid=None, screen_beta=None, screen_is_active=None, rsq: float = 0.0,
    intercept: bool = True, max_iters: int = int(1e5), tol: float = 1e-7,
    newton_tol: float = 1e-12, newton_max_iters: int = 1000,
    y_or_resid=None, **kwargs,
):
    """Pin solver over a FIXED screen set (reference state.py:1677
    ``gaussian_pin_naive`` / StateGaussianPinNaive).

    Unlike the path solver, the screen set never grows and no KKT check
    runs: every lambda in ``lmda_path`` is fitted on exactly the groups in
    ``screen_set`` (default: all groups).  ``resid``/``screen_beta``/
    ``screen_is_active``/``rsq`` accept an arbitrary warm iterate whose
    invariants the caller maintains (the reference's copy-construction /
    warm-start contract, py_state.cpp:481).
    """
    import jax.numpy as jnp

    from .solver import _as_matrix, finalize_state
    from .solver.basil import compute_lmda_max
    from .solver.gaussian import GaussianNaiveDriver, GaussianNaiveState

    if y is None:
        y = y_or_resid
    X = _as_matrix(X)
    dtype = np.dtype(X.dtype)
    n, p = X.rows(), X.cols()
    y = np.asarray(y, dtype)
    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    penalty = np.asarray(penalty, float)
    if weights is None:
        weights = np.full(n, 1.0 / n)
    weights = np.asarray(weights, float)
    weights = weights / weights.sum()
    if screen_set is None:
        screen_set = np.arange(G)
    screen_set = np.asarray(screen_set, int)
    gs = group_sizes[screen_set]
    screen_begins = (
        np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        if len(screen_set) else np.zeros(0, int)
    )
    S_val = int(gs.sum())
    if screen_beta is None:
        screen_beta = np.zeros(S_val, dtype)
    screen_beta = np.asarray(screen_beta, dtype)
    if screen_is_active is None:
        screen_is_active = np.ones(len(screen_set), bool)
    screen_is_active = np.asarray(screen_is_active, bool)

    if lmda_path is None:
        raise ValueError("gaussian_pin_naive requires lmda_path")
    lmda_path = np.array(np.flip(np.sort(np.asarray(lmda_path, float))))

    w_dev = jnp.asarray(weights, dtype)
    y_dev = jnp.asarray(y, dtype)
    ones = jnp.ones((n,), dtype)
    X_means = X.mul(ones, w_dev)
    y_mean = float(jnp.vdot(w_dev, y_dev)) if intercept else 0.0
    yc = y_dev - y_mean
    y_var = float(jnp.vdot(w_dev, yc * yc))
    if resid is None:
        if S_val:
            cols = np.concatenate([
                np.arange(groups[g], groups[g] + group_sizes[g])
                for g in screen_set
            ]).astype(np.int32)
            resid = yc - X.gather(cols) @ jnp.asarray(screen_beta, dtype)
        else:
            resid = yc
    resid = jnp.asarray(resid, dtype)
    resid_sum = float(jnp.vdot(w_dev, resid))

    state = GaussianNaiveState(
        X=X, groups=groups, group_sizes=group_sizes, alpha=float(alpha),
        penalty=penalty, intercept=bool(intercept), dtype=dtype, n=n, p=p,
        max_iters=int(max_iters), tol=float(tol),
        newton_tol=float(newton_tol), newton_max_iters=int(newton_max_iters),
        early_exit=False, setup_lmda_max=False, setup_lmda_path=False,
        lmda_path=lmda_path, lmda_max=float(lmda_path[0]),
        screen_set=screen_set, screen_begins=screen_begins,
        screen_beta=screen_beta, screen_is_active=screen_is_active,
        lmda=np.inf,
        weights=w_dev, X_means=X_means, y_mean=y_mean, y_var=y_var,
        rsq=float(rsq), resid=resid, resid_sum=resid_sum,
    )
    state.grad = X.mul(resid, w_dev)

    class _PinState(_BoundState):
        def __init__(self, state):
            driver = GaussianNaiveDriver(state)
            driver.pin_mode = True

            def run(progress_bar=False, exit_cond=None):
                path = np.asarray(state.lmda_path, float)
                C = int(state.lmda_chunk)
                i = 0
                while i < len(path):
                    n_acc, early, _ = driver._run_chunk(
                        path[i:i + C], record=True
                    )
                    # pin mode accepts every processed lambda
                    i += max(n_acc, 1)
                    if early or (exit_cond and exit_cond(state)):
                        break
                return finalize_state(state)

            super().__init__(state, run)

    return _PinState(state)


def gaussian_pin_cov(*, A, v, groups=None, alpha: float = 1.0, penalty=None,
                     screen_set=None, lmda_path=None, screen_beta=None,
                     screen_is_active=None, max_iters: int = int(1e5),
                     tol: float = 1e-7, newton_tol: float = 1e-12,
                     newton_max_iters: int = 1000, **kwargs):
    """Covariance-form pin solver over a FIXED screen set (reference
    state.py gaussian_pin_cov / StateGaussianPinCov): fit each lambda on
    exactly ``screen_set`` against the PSD matrix ``A`` and linear term
    ``v``, tracking the screen gradient (no n-vector residual)."""
    import jax.numpy as jnp

    from . import matrix as mx
    from .solver.pin import pin_cov_solve, screen_eigh
    from .utils import bucket_pow2

    if not isinstance(A, matrix_mod.MatrixCovBase):
        A = mx.dense(np.asarray(A), method="cov")
    p = A.cols()
    v = np.asarray(v, np.float64)
    if groups is None:
        groups = np.arange(p, dtype=int)
    groups = np.asarray(groups, int)
    group_sizes = np.diff(np.concatenate([groups, [p]])).astype(int)
    G = len(groups)
    if penalty is None:
        penalty = np.sqrt(group_sizes).astype(float)
    penalty = np.asarray(penalty, float)
    if screen_set is None:
        screen_set = np.arange(G)
    screen_set = np.asarray(screen_set, int)
    if lmda_path is None:
        raise ValueError("gaussian_pin_cov requires lmda_path")
    lmda_path = np.array(np.flip(np.sort(np.asarray(lmda_path, float))))

    dtype = np.dtype(A.dtype)
    gs = group_sizes[screen_set]
    begins = (np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
              if len(screen_set) else np.zeros(0, int))
    S_val = int(gs.sum())
    cols = np.concatenate([
        np.arange(groups[g], groups[g] + group_sizes[g]) for g in screen_set
    ]).astype(np.int32) if S_val else np.zeros(0, np.int32)
    qmax = bucket_pow2(int(gs.max())) if len(screen_set) else 1

    A_ss = jnp.asarray(A.block(cols, cols), dtype)
    v_s = jnp.asarray(v[cols], dtype)
    slot_begin = jnp.asarray(begins.astype(np.int32))
    slot_size = jnp.asarray(gs.astype(np.int32))
    penalty_slots = jnp.asarray(penalty[screen_set].astype(dtype))
    eigvals, eigvecs = screen_eigh(A_ss, slot_begin, slot_size, qmax)

    if screen_beta is None:
        screen_beta = np.zeros(S_val, dtype)
    beta = jnp.asarray(screen_beta, dtype)
    if screen_is_active is None:
        screen_is_active = np.ones(len(screen_set), bool)
    active = jnp.asarray(screen_is_active)

    class _S:
        def __init__(self):
            self.screen_set = screen_set
            self.screen_begins = begins
            self.groups = groups
            self.group_sizes = group_sizes
            self.lmdas = []
            self.betas = []
            self.intercepts = []
            self.error = ""

        def solve(self, progress_bar=False, exit_cond=None):
            import scipy.sparse as sp

            nonlocal beta, active
            rsq = jnp.zeros((), dtype)
            from .configs import configs as _cfg

            for lm in lmda_path:
                grad_s = v_s - jnp.matmul(A_ss, beta,
                                          precision="highest")
                beta, _, active, rsq, _, done = pin_cov_solve(
                    A_ss, grad_s,
                    beta, slot_begin, slot_size, eigvals, eigvecs,
                    penalty_slots, active,
                    jnp.asarray(lm, dtype), jnp.asarray(alpha, dtype),
                    jnp.asarray(tol, dtype),
                    jnp.asarray(_cfg.dbeta_tol, dtype),
                    jnp.asarray(newton_tol, dtype),
                    jnp.asarray(newton_max_iters, np.int32),
                    jnp.asarray(max_iters, np.int32), rsq,
                )
                b = np.asarray(beta)
                nz = np.abs(b) > 0
                self.betas.append(sp.csr_matrix(
                    (b[nz], (np.zeros(int(nz.sum()), int), cols[nz])),
                    shape=(1, p),
                ))
                self.intercepts.append(0.0)
                self.lmdas.append(float(lm))
            import scipy.sparse as sp

            self.betas = sp.vstack(self.betas).tocsr()
            self.lmdas = np.asarray(self.lmdas)
            self.intercepts = np.asarray(self.intercepts)
            # final iterate, reference StateGaussianPinCov members
            self.screen_beta = np.asarray(beta)
            self.screen_is_active = np.asarray(active)
            self.rsq = float(np.asarray(rsq))
            return self

    return _S()


# --------------------------------------------------------------------------- #
# checkpointing (beyond the reference: it keeps states in-memory only,        #
# SURVEY.md section 5 'Checkpoint / resume')                                   #
# --------------------------------------------------------------------------- #

_WS_FIELDS = [
    "screen_set", "screen_begins", "screen_beta", "screen_is_active",
    "lmda", "lmda_max", "abs_grad",
]
_WS_GAUSSIAN = ["y_mean", "y_var", "rsq", "resid_sum"]
_WS_ARRAYS = ["resid", "grad", "X_means", "weights", "eta"]


def save_state(state, path):
    """Serialize the warm-start-relevant fields of a solved state to .npz.

    ``grpnet(..., warm_start=load_warm_start(path))`` resumes the path
    (the state object itself is the checkpoint, reference
    solver.py:856-884; this adds the missing disk round trip).
    """
    out = {}
    for f in _WS_FIELDS + _WS_GAUSSIAN + _WS_ARRAYS + [
        "beta0", "loss_null", "loss_full",
    ]:
        v = getattr(state, f, None)
        if v is None:
            continue
        out[f] = np.asarray(v)
    np.savez(path, **out)
    return path


class _WarmStart:
    pass


def load_warm_start(path):
    """Load a saved state as a warm-start object for grpnet/gaussian_cov."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz",
                   allow_pickle=False)
    ws = _WarmStart()
    for k in data.files:
        v = data[k]
        setattr(ws, k, float(v) if v.ndim == 0 else v)
    import jax.numpy as jnp

    for f in _WS_ARRAYS:
        if hasattr(ws, f):
            setattr(ws, f, jnp.asarray(getattr(ws, f)))
    return ws
