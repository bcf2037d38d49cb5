"""Host-side solver state + device screen-cache.

Device-native replacement for the reference's C++ state classes
(``state/state_base.hpp:58-100``, ``state_gaussian_naive``, ``state_glm_naive``)
and their Python factories (``adelie/state.py``):

* Host (numpy) side: dynamic screen/active bookkeeping, configs, per-lambda
  outputs.  The state object doubles as the warm-start / checkpoint carrier,
  exactly like the reference (solver.py:856-884).
* Device (jax) side: the residual, full gradient, and a *screen cache* —
  the gathered screened column block, its weighted Gram, and the batched
  per-group eigendecompositions, in fixed-capacity buffers whose sizes are
  bucketed to bound recompiles.
"""

import functools
from dataclasses import dataclass, field
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import configs
from ..utils import bucket, bucket_pow2
from .pin import insert_cols, screen_eigh, screen_gram, screen_gram_extend

_PRECISION = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------- #
# jitted helpers                                                               #
# --------------------------------------------------------------------------- #


@jax.jit
def _pad_gather(vec, cols_padded):
    """vec[cols] with out-of-range padding indices producing 0."""
    ok = cols_padded >= 0
    safe = jnp.where(ok, cols_padded, 0)
    return jnp.where(ok, vec[safe], 0.0)


@functools.partial(jax.jit, static_argnames=("num_groups",))
def abs_grad_kernel(grad, cols_padded, beta_padded, penalty_cols, group_ids,
                    l2_scale, num_groups):
    """Per-group norms ||grad_g - (1-alpha) lmda pen_g beta_g||_2.

    Reference: update_abs_grad (solver_base.hpp:21-110); the screen/non-screen
    split disappears because beta is densified (zero off-screen).
    """
    ok = cols_padded >= 0
    # out-of-bounds sentinel: mode="drop" then discards padded slots (a
    # clamp to index 0 would make padded slots race with a real slot
    # mapping to column 0 — scatter order with duplicates is undefined)
    safe = jnp.where(ok, cols_padded, grad.shape[0])
    beta_cols = jnp.zeros_like(grad).at[safe].set(beta_padded, mode="drop")
    # multiply (penalty * beta) first: at the huge-lambda dry fit beta is
    # nonzero only where penalty == 0, so the product is exactly 0 and the
    # large l2_scale never meets a nonzero operand (safe in f32 range).
    gadj = grad - l2_scale * (penalty_cols * beta_cols)
    sq = jax.ops.segment_sum(gadj * gadj, group_ids, num_segments=num_groups)
    return jnp.sqrt(jnp.maximum(sq, 0.0))


@jax.jit
def resid_update_kernel(resid, Xs, dbeta, w):
    """resid -= Xs @ dbeta;  resid_sum = sum(w * resid)."""
    resid = resid - jnp.matmul(Xs, dbeta, precision=_PRECISION)
    return resid, jnp.vdot(w, resid, precision=_PRECISION)


@jax.jit
def screen_grad_kernel(Xs, wv, means_s, vw_sum):
    """Centered screen gradient  Xs^T wv - means_s * sum(wv).

    Used by the IRLS inner fits where the full (p,) gradient is not needed.
    """
    g = jnp.einsum("ns,n->s", Xs, wv, precision=_PRECISION)
    return g - means_s * vw_sum


# --------------------------------------------------------------------------- #
# screen cache                                                                 #
# --------------------------------------------------------------------------- #


class ScreenCache:
    """Device-resident derived quantities of the current screen set."""

    def __init__(self):
        self.version = -1          # host screen-set version this reflects
        self.cols = None           # np (S_val,) actual column indices
        self.S_val = 0
        self.S_cap = 0
        self.G_cap = 0
        self.qmax = 1
        self.Xs = None             # (n, S_cap) uncentered gathered block
        self.cols_padded = None    # device (S_cap,) int32, -1 padding
        self.slot_begin = None     # device (G_cap,)
        self.slot_size = None
        self.penalty_slots = None
        # weighted quantities (recomputed when weights change; gaussian: once)
        self.A = None
        self.means_s = None
        self.eigvals = None
        self.eigvecs = None
        # incremental-extension bookkeeping
        self._weights_ref = None   # weights array A/means were built with
        self._pending_ext = None   # (s_old, Xnew_buf) awaiting rebuild_weighted
        self._prev_ss = None       # screen_set snapshot of last rebuild
        self._A_prev = None        # incremental base for screen_gram_extend
        self._means_prev = None

    def rebuild_structure(self, state):
        """Re-gather columns after a screen-set change.

        The screen set only grows by appending groups, so when the previous
        gather is a prefix of the new one we gather ONLY the new columns and
        (in rebuild_weighted, if the weights are unchanged) extend the Gram
        with one S x dS cross matmul instead of recomputing S^2
        (screen_gram_extend; the full recompute is the dominant non-CD
        cost late in the path).
        """
        if self._try_extend_structure(state):
            return
        self._full_rebuild_structure(state)

    def _full_rebuild_structure(self, state):
        ss = state.screen_set
        gs = state.group_sizes[ss]
        begins = np.concatenate([[0], np.cumsum(gs)])[:-1]
        S_val = int(begins[-1] + gs[-1]) if len(ss) else 0
        cols = np.concatenate(
            [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
             for g in ss]
        ).astype(np.int64) if len(ss) else np.zeros(0, np.int64)

        qmax = bucket_pow2(int(gs.max())) if len(ss) else 1
        # capacity: leave a qmax margin so dynamic slices never run off the end
        S_cap = bucket(S_val + qmax, configs.screen_cap_min)
        G_cap = bucket(len(ss), configs.group_cap_min)

        dtype = state.dtype
        Xs_raw = state.X.gather(cols.astype(np.int32)) if S_val else None
        Xs = jnp.zeros((state.n, S_cap), dtype)
        if S_val:
            Xs = Xs.at[:, :S_val].set(jnp.asarray(Xs_raw, dtype))
        mesh = getattr(state.X, "_mesh", None)
        if mesh is not None:
            from ..parallel import shard_rows

            Xs = shard_rows(Xs, mesh)

        cols_padded = np.full(S_cap, -1, np.int32)
        cols_padded[:S_val] = cols
        slot_begin = np.zeros(G_cap, np.int32)
        slot_size = np.zeros(G_cap, np.int32)
        penalty_slots = np.ones(G_cap, dtype)
        slot_begin[: len(ss)] = begins
        slot_size[: len(ss)] = gs
        penalty_slots[: len(ss)] = state.penalty[ss]

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap, self.qmax = S_val, S_cap, G_cap, qmax
        self.Xs = Xs
        self.cols_padded = jnp.asarray(cols_padded)
        self.slot_begin = jnp.asarray(slot_begin)
        self.slot_size = jnp.asarray(slot_size)
        self.penalty_slots = jnp.asarray(penalty_slots)
        self.begins_host = begins
        self.sizes_host = gs
        self.A = None  # force weight-dependent rebuild
        self._pending_ext = None
        self._A_prev = None
        self._means_prev = None
        self._prev_ss = np.asarray(ss).copy()

    def _try_extend_structure(self, state):
        """Append-only fast path: gather just the new columns; stash the
        extension so rebuild_weighted can extend the Gram incrementally."""
        ss = state.screen_set
        prev = self._prev_ss
        if (
            prev is None
            or self.Xs is None
            or self._pending_ext is not None   # don't stack unapplied exts
            or len(ss) < len(prev)
            or len(ss) == len(prev)
            or not np.array_equal(ss[: len(prev)], prev)
        ):
            return False
        new_groups = np.asarray(ss[len(prev):], int)
        gs_new = state.group_sizes[new_groups]
        qmax_new = bucket_pow2(int(max(int(gs_new.max()), 1)))
        if qmax_new > self.qmax:
            return False                       # eigh block shape changes
        s_old = self.S_val
        dS = int(gs_new.sum())
        S_val = s_old + dS
        S_cap = bucket(S_val + self.qmax, configs.screen_cap_min)
        G_cap = bucket(len(ss), configs.group_cap_min)
        dS_pad = bucket_pow2(dS)
        if s_old + dS_pad > S_cap:
            return False                       # buffer layout won't fit
        mesh = getattr(state.X, "_mesh", None)

        dtype = state.dtype
        new_cols = np.concatenate(
            [np.arange(state.groups[g], state.groups[g] + state.group_sizes[g])
             for g in new_groups]
        ).astype(np.int64)
        Xnew = jnp.zeros((state.n, dS_pad), dtype)
        Xnew = Xnew.at[:, :dS].set(
            jnp.asarray(state.X.gather(new_cols.astype(np.int32)), dtype)
        )

        # grow the structural buffers (static-shape pads keyed on the
        # bounded (old_cap, new_cap) bucket pairs)
        Xs = self.Xs
        if S_cap != self.S_cap:
            Xs = jnp.zeros((state.n, S_cap), dtype).at[:, : self.S_cap].set(Xs)
        if mesh is not None:
            from ..parallel import shard_rows

            Xnew = shard_rows(Xnew, mesh)
            Xs = shard_rows(Xs, mesh)
        # splice the new columns in eagerly: consumers that never call
        # rebuild_weighted (the IRLS fused step computes its Gram on device
        # from cache.Xs directly) must see a current block
        Xs = insert_cols(Xs, Xnew, jnp.asarray(s_old, jnp.int32))
        if mesh is not None:
            from ..parallel import shard_rows

            Xs = shard_rows(Xs, mesh)

        cols = np.concatenate([self.cols, new_cols])
        begins = np.concatenate(
            [self.begins_host,
             s_old + np.concatenate([[0], np.cumsum(gs_new)])[:-1]]
        ).astype(self.begins_host.dtype)
        sizes = np.concatenate([self.sizes_host, gs_new])
        cols_padded = np.full(S_cap, -1, np.int32)
        cols_padded[:S_val] = cols
        slot_begin = np.zeros(G_cap, np.int32)
        slot_size = np.zeros(G_cap, np.int32)
        penalty_slots = np.ones(G_cap, dtype)
        slot_begin[: len(ss)] = begins
        slot_size[: len(ss)] = sizes
        penalty_slots[: len(ss)] = state.penalty[ss]

        self.cols = cols
        self.S_val, self.S_cap, self.G_cap = S_val, S_cap, G_cap
        self.Xs = Xs
        self.cols_padded = jnp.asarray(cols_padded)
        self.slot_begin = jnp.asarray(slot_begin)
        self.slot_size = jnp.asarray(slot_size)
        self.penalty_slots = jnp.asarray(penalty_slots)
        self.begins_host = begins
        self.sizes_host = sizes
        self._prev_ss = np.asarray(ss).copy()
        self._pending_ext = (s_old, Xnew)
        # stash the old weighted quantities as the incremental base (may be
        # None if rebuild_weighted never ran for the previous structure, in
        # which case rebuild_weighted falls back to a full recompute)
        self._A_prev = self.A
        self._means_prev = self.means_s
        self.A = None
        return True

    def rebuild_weighted(self, weights, intercept):
        """(Re)compute Gram + eigendecompositions for given weights.

        If an append-only screen extension is pending and the weights are
        the SAME array the previous Gram was built with (gaussian drivers:
        always; IRLS: never — weights change each iteration), extend the
        Gram incrementally; otherwise recompute in full.
        """
        ext = self._pending_ext
        if (
            ext is not None
            and self._A_prev is not None
            and weights is self._weights_ref
        ):
            s_old, Xnew = ext
            A_pad = self._A_prev
            means_pad = self._means_prev
            if A_pad.shape[0] != self.S_cap:
                A_pad = (
                    jnp.zeros((self.S_cap, self.S_cap), A_pad.dtype)
                    .at[: A_pad.shape[0], : A_pad.shape[1]].set(A_pad)
                )
                means_pad = (
                    jnp.zeros((self.S_cap,), means_pad.dtype)
                    .at[: means_pad.shape[0]].set(means_pad)
                )
            self.A, self.means_s = screen_gram_extend(
                A_pad, self.Xs, Xnew, weights, means_pad,
                jnp.asarray(s_old, jnp.int32), intercept,
            )
        else:
            self.A, self.means_s = screen_gram(self.Xs, weights, intercept)
        self._pending_ext = None
        self._weights_ref = weights
        self._A_prev = self.A
        self._means_prev = self.means_s
        self.eigvals, self.eigvecs = screen_eigh(
            self.A, self.slot_begin, self.slot_size, self.qmax
        )

    def pad_screen_values(self, values, dtype):
        out = np.zeros(self.S_cap, dtype)
        out[: self.S_val] = values
        return jnp.asarray(out)

    def pad_group_bools(self, flags):
        out = np.zeros(self.G_cap, bool)
        out[: len(flags)] = flags
        return jnp.asarray(out)


# --------------------------------------------------------------------------- #
# state                                                                        #
# --------------------------------------------------------------------------- #


@dataclass
class NaiveStateBase:
    """Shared solver state (reference state_base.hpp:58-100)."""

    # problem definition
    X: Any = None
    groups: np.ndarray = None
    group_sizes: np.ndarray = None
    alpha: float = 1.0
    penalty: np.ndarray = None
    intercept: bool = True
    dtype: Any = np.float64
    n: int = 0
    p: int = 0

    # configs
    max_iters: int = int(1e5)
    tol: float = 1e-7
    adev_tol: float = 0.9
    ddev_tol: float = 0.0
    newton_tol: float = 1e-12
    newton_max_iters: int = 1000
    early_exit: bool = True
    min_ratio: float = 1e-2
    lmda_path_size: int = 100
    max_screen_size: int = None
    max_active_size: int = None
    pivot_subset_ratio: float = 0.1
    pivot_subset_min: int = 1
    pivot_slack_ratio: float = 1.25
    # cap per-call SPECULATIVE pivot admissions at this multiple of the
    # active-ish count (None = uncapped reference behavior); see
    # solver/basil.py screen() correlated-design guard
    screen_cap_active_mult: float = None
    screen_rule: str = "pivot"
    setup_lmda_max: bool = True
    setup_lmda_path: bool = True
    n_threads: int = 1  # accepted for API parity; unused
    # lambdas fitted per device call (BASIL batching; device knob).
    # Frozen (post-early-exit / post-KKT-failure) scan iterations cost
    # almost nothing, so large chunks only reduce dispatch+RTT overhead
    # (measured: 100 beats 25 by ~11% on the n=40k x p=2000 headline)
    lmda_chunk: int = 100

    # dynamic invariants
    screen_set: np.ndarray = None          # (S_G,) group indices
    screen_begins: np.ndarray = None
    screen_beta: np.ndarray = None         # (S_val,)
    screen_is_active: np.ndarray = None    # (S_G,) bool
    lmda: float = np.inf
    lmda_max: Optional[float] = None
    lmda_path: Optional[np.ndarray] = None
    grad: Any = None                       # device (p,)
    abs_grad: np.ndarray = None            # host (G,)

    # outputs
    betas: list = field(default_factory=list)      # scipy sparse rows
    intercepts: list = field(default_factory=list)
    lmdas: list = field(default_factory=list)
    devs: list = field(default_factory=list)
    active_sizes: list = field(default_factory=list)
    screen_sizes: list = field(default_factory=list)
    n_valid_solutions: list = field(default_factory=list)
    benchmark: dict = field(default_factory=lambda: {
        "screen": [], "fit_screen": [], "fit_active": [],
        "kkt": [], "invariance": [],
        # per accepted lambda: CD sweeps and block-coordinate updates
        # (sweeps x screened groups) — feeds the bench's iters/s metric
        "cd_iters": [], "cd_updates": [],
    })
    total_time: float = 0.0
    error: str = ""

    # internals
    _cache: ScreenCache = field(default_factory=ScreenCache)
    _screen_version: int = 0
    _group_ids: Any = None       # device (p,) int32
    _penalty_cols: Any = None    # device (p,)

    def __post_init__(self):
        if self.groups is None:
            return
        G = len(self.groups)
        if self.max_screen_size is None:
            self.max_screen_size = G
        if self.max_active_size is None:
            self.max_active_size = G
        gid = np.repeat(np.arange(G, dtype=np.int32), self.group_sizes)
        self._group_ids = jnp.asarray(gid)
        self._penalty_cols = jnp.asarray(
            np.repeat(self.penalty, self.group_sizes).astype(self.dtype)
        )

    # ---- screen-set management (reference update_screen_derived_base) ---- #

    @property
    def screen_hash(self):
        return set(int(i) for i in self.screen_set)

    def prune_inactive_zeros(self):
        """Drop all-zero groups from the sticky active set (r5).

        ``screen_is_active`` only ever grows during fits: a group that
        moved once stays active forever, and on LD designs the active
        sweeps end up iterating thousands of slots whose coefficients
        have long returned to zero.  The active set is a performance
        hint, not correctness state — the pin solve's full sweeps and
        the BASIL KKT pass re-admit any group that should move — so
        zero groups are pruned at (host-side) chunk boundaries.
        """
        if self.screen_is_active is None or not len(self.screen_set):
            return
        act = self.screen_is_active
        for i in np.flatnonzero(act):
            b = self.screen_begins[i]
            q = self.group_sizes[self.screen_set[i]]
            if not np.any(self.screen_beta[b:b + q]):
                act[i] = False

    def extend_screen_set(self, new_groups):
        if len(new_groups) == 0:
            return
        old_G = len(self.screen_set)
        self.screen_set = np.concatenate(
            [self.screen_set, np.asarray(new_groups, self.screen_set.dtype)]
        )
        gs = self.group_sizes[self.screen_set]
        self.screen_begins = np.concatenate([[0], np.cumsum(gs)])[:-1].astype(int)
        add_val = int(self.group_sizes[np.asarray(new_groups, int)].sum())
        self.screen_beta = np.concatenate(
            [self.screen_beta, np.zeros(add_val, self.screen_beta.dtype)]
        )
        self.screen_is_active = np.concatenate(
            [self.screen_is_active, np.zeros(len(new_groups), bool)]
        )
        self._screen_version += 1

    @property
    def active_set_size(self):
        return int(self.screen_is_active.sum())

    def ensure_screen_cache(self):
        if self._cache.version != self._screen_version:
            self._cache.rebuild_structure(self)
            self._cache.version = self._screen_version
        return self._cache

    def update_abs_grad(self, lmda):
        cache = self.ensure_screen_cache()
        beta_padded = cache.pad_screen_values(self.screen_beta, self.dtype)
        ag = abs_grad_kernel(
            self.grad,
            cache.cols_padded,
            beta_padded,
            self._penalty_cols,
            self._group_ids,
            jnp.asarray((1.0 - self.alpha) * min(lmda, 1e30), self.dtype),
            len(self.groups),
        )
        self.abs_grad = np.asarray(ag)

    def screen_mask_dev(self):
        """Device (G,) bool mask of screened groups, cached per screen
        version (shared by the gaussian/constrained/CV drivers)."""
        if getattr(self, "_screen_mask_ver", None) != self._screen_version:
            m = np.zeros(len(self.groups), bool)
            m[self.screen_set] = True
            self._screen_mask_cache = jnp.asarray(m)
            self._screen_mask_ver = self._screen_version
        return self._screen_mask_cache

    def kkt(self, lmda) -> bool:
        """Reference solver_base.hpp:410-433."""
        is_screen = np.zeros(len(self.groups), bool)
        is_screen[self.screen_set] = True
        viol = self.abs_grad > lmda * self.alpha * self.penalty
        return not bool(np.any(viol & ~is_screen))
