"""Cox proportional hazards GLM (stratified start-stop, Efron/Breslow ties).

Device re-design of the reference ``GlmCox`` (glm/glm_cox.ipp:1-752,
math documented in adelie/glm.py:199-330).  The reference computes at-risk
sums with per-stratum sequential two-pointer prefix sums
(``_partial_sum_fwd:19``, ``_partial_sum_bwd:65``, ``_at_risk_sum:119``,
``_nnz_event_ties_sum:151``, ``_scale:194``).  Here all the *index
machinery* (sort orders, searchsorted cut points, tie-group ids, stratum
offsets) is precomputed on host at construction — it depends only on the
static (start, stop, status, strata, weights) data — so ``gradient``/
``hessian``/``loss`` are each ONE fused jittable XLA computation:
``exp`` + gathers + ``cumsum`` + ``segment_sum`` + scatters.  No
data-dependent control flow touches the device.

Per-stratum partial sums use the identity

    sum_{k in stratum} v_k 1{s_k <= t}  =  cs[b + cut] - cs[b]

where ``cs`` is the global cumulative sum of stratum-ordered values with a
zero prepended, ``b`` the stratum's begin offset, and ``cut`` the
(host-precomputed) ``searchsorted`` count — sums never leak across strata.
"""

import numpy as np
import jax
import jax.numpy as jnp

from . import GlmBase


class GlmCox(GlmBase):
    """Cox partial-likelihood GLM (reference glm/glm_cox.{hpp,ipp})."""

    def __init__(self, start, stop, status, strata=None, weights=None,
                 tie_method="efron", dtype=None):
        status = np.asarray(status)
        if dtype is None:
            dtype = (
                status.dtype
                if status.dtype in (np.float32, np.float64)
                else np.float64
            )
        super().__init__("cox", status, weights, dtype)
        n = status.size
        from ..utils import types

        self.tie_method = types.tie_method(tie_method)
        self.start = np.asarray(start, np.float64)
        self.stop = np.asarray(stop, np.float64)
        self.status = np.asarray(status, np.float64)
        if self.start.size != n or self.stop.size != n:
            raise ValueError("start/stop must be (n,) where status is (n,).")
        # a subject is at risk at u iff start < u <= stop; an "event" on a
        # row with stop <= start is outside its own risk set — an improper
        # partial likelihood whose score w.r.t. a constant shift never
        # vanishes (the intercept drifts unboundedly).  Treat as censored.
        bad = (self.stop <= self.start) & (self.status != 0)
        if np.any(bad):
            from ..logger import logger

            logger.warning(
                f"cox: {int(bad.sum())} row(s) have stop <= start with "
                "status=1; such rows are never at risk and their events "
                "are treated as censored."
            )
            self.status = np.where(bad, 0.0, self.status)
        if strata is None:
            strata = np.zeros(n, int)
        self.strata = np.asarray(strata, int)
        if self.strata.size != n:
            raise ValueError("strata must be (n,) where status is (n,).")

        self._build_index_machinery()

    # ------------------------------------------------------------------ #
    # host-side static index machinery                                    #
    # ------------------------------------------------------------------ #

    def _build_index_machinery(self):
        n = self.status.size
        w = np.asarray(self.weights, np.float64)
        strata = self.strata
        n_strata = int(strata.max()) + 1 if n else 1

        stop_order = np.empty(n, np.int64)
        start_order = np.empty(n, np.int64)
        begin_to = np.empty(n, np.int64)   # stratum begin at stop-order pos
        end_to = np.empty(n, np.int64)     # stratum end
        asum_t_idx = np.empty(n, np.int64)
        asum_s_idx = np.empty(n, np.int64)
        fwd_tt_idx = np.empty(n, np.int64)
        fwd_ts_idx = np.empty(n, np.int64)
        begin_so = np.empty(n, np.int64)
        tie_id = np.empty(n, np.int64)

        pos = 0
        tie_count = 0
        for m in range(n_strata):
            idx_m = np.nonzero(strata == m)[0]
            sz = len(idx_m)
            if sz == 0:
                continue
            b, e = pos, pos + sz
            so_stop = idx_m[np.argsort(self.stop[idx_m], kind="stable")]
            so_start = idx_m[np.argsort(self.start[idx_m], kind="stable")]
            stop_m = self.stop[so_stop]
            start_m = self.start[so_start]
            stop_order[b:e] = so_stop
            start_order[b:e] = so_start
            begin_to[b:e] = b
            end_to[b:e] = e
            begin_so[b:e] = b
            # at-risk: sum over {stop >= u} and {start >= u}, u = stop_m
            asum_t_idx[b:e] = b + np.searchsorted(stop_m, stop_m, side="left")
            asum_s_idx[b:e] = b + np.searchsorted(start_m, stop_m, side="left")
            # fwd partial sums of stop-ordered values at thresholds
            fwd_tt_idx[b:e] = b + np.searchsorted(stop_m, stop_m, side="right")
            fwd_ts_idx[b:e] = b + np.searchsorted(stop_m, start_m, side="right")
            # tie groups: runs of equal stop within the stratum
            new_grp = np.ones(sz, bool)
            new_grp[1:] = stop_m[1:] != stop_m[:-1]
            tie_id[b:e] = tie_count + np.cumsum(new_grp) - 1
            tie_count += int(new_grp.sum())
            pos = e

        # first position of each tie group (static — depends on tie_id only;
        # used by the device-side Efron rank computation in weight_bundle)
        first_pos = (np.nonzero(np.r_[True, tie_id[1:] != tie_id[:-1]])[0]
                     if n else np.zeros(0, np.int64))
        self._first_pos_gather = jnp.asarray(first_pos[tie_id]
                                             if n else tie_id, jnp.int32)

        status_to = self.status[stop_order]
        weights_to = w[stop_order]
        indic_to = status_to * (weights_to != 0)

        # weights_size_to / weights_mean_to (reference init_weights_*_to)
        seg_cnt = np.zeros(tie_count)
        np.add.at(seg_cnt, tie_id, indic_to)
        weights_size_to = indic_to * seg_cnt[tie_id]
        seg_w = np.zeros(tie_count)
        np.add.at(seg_w, tie_id, weights_to * indic_to)
        weights_mean_to = indic_to * seg_w[tie_id]
        nz = (status_to != 0) & (weights_to != 0)
        weights_mean_to[nz] = weights_mean_to[nz] / weights_size_to[nz]

        # scale (reference cox::_scale): Efron k_i / |H(t_i)| among nnz ties
        scale_to = np.zeros(n)
        if self.tie_method == "efron":
            # rank among nnz-event ties within each tie group
            cum_indic = np.cumsum(indic_to) - indic_to  # exclusive prefix
            # first position of each tie group (tie_id is nondecreasing)
            first_pos = np.nonzero(np.r_[True, tie_id[1:] != tie_id[:-1]])[0] \
                if n else np.zeros(0, np.int64)
            rank = cum_indic - cum_indic[first_pos[tie_id]]
            size = seg_cnt[tie_id]
            with np.errstate(divide="ignore", invalid="ignore"):
                scale_to = np.where(size > 0, indic_to * rank / np.maximum(size, 1), 0.0)

        dt = self.dtype
        self._n_ties = tie_count
        self._stop_order = jnp.asarray(stop_order, jnp.int32)
        self._start_order = jnp.asarray(start_order, jnp.int32)
        self._begin_to = jnp.asarray(begin_to, jnp.int32)
        self._end_to = jnp.asarray(end_to, jnp.int32)
        self._begin_so = jnp.asarray(begin_so, jnp.int32)
        self._asum_t_idx = jnp.asarray(asum_t_idx, jnp.int32)
        self._asum_s_idx = jnp.asarray(asum_s_idx, jnp.int32)
        self._fwd_tt_idx = jnp.asarray(fwd_tt_idx, jnp.int32)
        self._fwd_ts_idx = jnp.asarray(fwd_ts_idx, jnp.int32)
        self._tie_id = jnp.asarray(tie_id, jnp.int32)
        self._status_to = jnp.asarray(status_to, dt)
        self._weights_to = jnp.asarray(weights_to, dt)
        self._indic_to = jnp.asarray(indic_to, dt)
        self._weights_size_to = jnp.asarray(weights_size_to, dt)
        self._weights_mean_to = jnp.asarray(weights_mean_to, dt)
        self._scale_to = jnp.asarray(scale_to, dt)
        self._status_dev = jnp.asarray(self.status, dt)

    # ------------------------------------------------------------------ #
    # shared jittable pieces                                               #
    # ------------------------------------------------------------------ #

    def _csum0(self, v):
        """Cumulative sum with zero prepended (for partial-sum gathers)."""
        return jnp.concatenate([jnp.zeros((1,), v.dtype), jnp.cumsum(v)])

    def _sfx0(self, v):
        """Suffix sums: sfx[k] = sum_{j >= k} v[j], with sfx[n] = 0.

        Any prefix-sum difference cs[i2] - cs[i1] equals sfx[i1] - sfx[i2];
        the suffix form is used for the at-risk sums because late risk
        sets are SMALL tails of the ordering — computing them as
        differences of large prefix sums cancels catastrophically in f32
        (observed: negative/zero risk sums deep in a cox path poisoning
        the gradient with inf), while differences of the small suffix
        sums stay accurate.
        """
        rev = jnp.cumsum(v[::-1])[::-1]
        return jnp.concatenate([rev, jnp.zeros((1,), v.dtype)])

    def weight_bundle(self, w):
        """Weight-derived arrays computed ON DEVICE from a (possibly
        traced) weight vector — the index machinery is weight-independent,
        so this is jittable and vmappable over fold weights (the basis of
        fold-batched cox CV; the host path in ``_build_index_machinery``
        computes the same arrays in f64 numpy for the default weights)."""
        w = jnp.asarray(w, self.dtype)
        weights_to = w[self._stop_order]
        indic_to = self._status_to * (weights_to != 0)
        seg_cnt = jax.ops.segment_sum(
            indic_to, self._tie_id, num_segments=self._n_ties
        )
        weights_size_to = indic_to * seg_cnt[self._tie_id]
        seg_w = jax.ops.segment_sum(
            weights_to * indic_to, self._tie_id, num_segments=self._n_ties
        )
        wm = indic_to * seg_w[self._tie_id]
        nz = (self._status_to != 0) & (weights_to != 0)
        weights_mean_to = jnp.where(
            nz, wm / jnp.maximum(weights_size_to, 1.0), 0.0
        )
        if self.tie_method == "efron":
            cum_indic = jnp.cumsum(indic_to) - indic_to   # exclusive prefix
            rank = cum_indic - cum_indic[self._first_pos_gather]
            size = seg_cnt[self._tie_id]
            scale_to = jnp.where(
                size > 0, indic_to * rank / jnp.maximum(size, 1.0), 0.0
            )
        else:
            scale_to = jnp.zeros_like(indic_to)
        return {
            "w": w, "weights_to": weights_to, "indic_to": indic_to,
            "weights_size_to": weights_size_to,
            "weights_mean_to": weights_mean_to, "scale_to": scale_to,
        }

    def _wb_parts(self, wb):
        if wb is None:
            return (self.weights, self._indic_to, self._weights_mean_to,
                    self._scale_to)
        return (wb["w"], wb["indic_to"], wb["weights_mean_to"],
                wb["scale_to"])

    def _risk_total(self, z, indic_to=None, scale_to=None):
        """risk_total_to = at-risk sum - scale * ties sum (stop order)."""
        indic_to = self._indic_to if indic_to is None else indic_to
        scale_to = self._scale_to if scale_to is None else scale_to
        z_to = z[self._stop_order]
        z_so = z[self._start_order]
        sfx_t = self._sfx0(z_to)
        sfx_s = self._sfx0(z_so)
        risk1 = sfx_t[self._asum_t_idx] - sfx_t[self._end_to]
        risk2 = sfx_s[self._asum_s_idx] - sfx_s[self._end_to]
        risk_sum = risk1 - risk2
        seg = jax.ops.segment_sum(
            z_to * indic_to, self._tie_id, num_segments=self._n_ties
        )
        ties_risk = indic_to * seg[self._tie_id]
        # f32 rounding can still leave a tiny negative where the true sum
        # is ~0; clamp so downstream 1/risk stays finite
        return z_to, jnp.maximum(risk_sum - scale_to * ties_risk, 0.0)

    def _accumulate(self, v_to, scale_factor, indic_to=None):
        """gs1 - gs3 scatter to stop positions minus gs2 at start positions.

        Mirrors the reference gradient/hessian epilogue
        (glm_cox.ipp:395-405): returns the n-vector ``acc`` (original order)
        with acc[stop_order[i]] = fwd_tt[i] - ties[i], acc[start_order[i]]
        -= fwd_ts[i].
        """
        indic_to = self._indic_to if indic_to is None else indic_to
        cs_v = self._csum0(v_to)
        gs1 = cs_v[self._fwd_tt_idx] - cs_v[self._begin_to]
        gs2 = cs_v[self._fwd_ts_idx] - cs_v[self._begin_so]
        seg = jax.ops.segment_sum(
            scale_factor * v_to * indic_to, self._tie_id,
            num_segments=self._n_ties,
        )
        gs3 = indic_to * seg[self._tie_id]
        acc = jnp.zeros_like(v_to)
        acc = acc.at[self._stop_order].set(gs1 - gs3)
        acc = acc.at[self._start_order].add(-gs2)
        return acc

    # ------------------------------------------------------------------ #
    # GLM interface                                                        #
    # ------------------------------------------------------------------ #

    def gradient(self, eta, wb=None):
        # exp(eta - max) stabilization: the gradient depends on z only
        # through ratios z / risk-sums, which are shift-invariant, so the
        # f32 overflow at eta ~ 88 (saturating fits deep in the path)
        # disappears for free (the loss was already stabilized this way)
        w, indic, wmean, scale = self._wb_parts(wb)
        z = w * jnp.exp(eta - jnp.max(eta))
        _, risk_total = self._risk_total(z, indic, scale)
        guard = ((self._status_to == 0) | (wmean == 0)).astype(z.dtype)
        v_to = self._status_to * wmean / (risk_total + guard)
        # z underflow can zero a risk set whose event weight is nonzero;
        # those positions contribute 0 to acc*z anyway — keep acc finite
        v_to = jnp.where(jnp.isfinite(v_to), v_to, 0.0)
        acc = self._accumulate(v_to, scale, indic)
        return w * self._status_dev - acc * z

    def hessian(self, eta, grad, wb=None):
        # shift-invariant like the gradient: acc ~ 1/c^2 against z*z ~ c^2
        w, indic, wmean, scale = self._wb_parts(wb)
        z = w * jnp.exp(eta - jnp.max(eta))
        _, risk_total = self._risk_total(z, indic, scale)
        guard = ((self._status_to == 0) | (wmean == 0)).astype(z.dtype)
        v_to = self._status_to * wmean / (risk_total**2 + guard)
        v_to = jnp.where(jnp.isfinite(v_to), v_to, 0.0)
        acc = self._accumulate(v_to, scale * (2.0 - scale), indic)
        return w * self._status_dev - grad - acc * z * z

    def loss(self, eta, wb=None):
        w, indic, wmean, scale = self._wb_parts(wb)
        eta_max = jnp.max(eta)
        z = w * jnp.exp(eta - eta_max)
        _, risk_total = self._risk_total(z, indic, scale)
        # branch-free log with an f32-range-safe floor: positions with
        # risk_total <= 0 only occur where the status*wm coefficient is 0,
        # so the sentinel never contributes (0 * finite == 0; the reference
        # clips at -double max, glm_cox.ipp:500, which 0-multiplies the same
        # way in f64 but is out of f32 range).
        ok = risk_total > 0
        log_term = jnp.where(
            ok, jnp.log(jnp.where(ok, risk_total, 1.0)), -1e30
        )
        return (
            -jnp.sum(self._status_dev * w * (eta - eta_max))
            + jnp.sum(self._status_to * wmean * log_term)
        )

    def loss_full(self):
        wm = np.asarray(self._weights_mean_to, np.float64)
        ws = np.asarray(self._weights_size_to, np.float64)
        st = np.asarray(self._status_to, np.float64)
        sc = np.asarray(self._scale_to, np.float64)
        inner_arg = ws * wm * (1 - sc)
        ok = inner_arg > 0
        inner = np.where(ok, np.log(np.where(ok, inner_arg, 1.0)), -1e30)
        return jnp.asarray((wm * st * inner).sum(), self.dtype)

    def loss_full_w(self, wb):
        """Device/jittable saturated loss under a traced weight bundle."""
        wm = wb["weights_mean_to"]
        ws = wb["weights_size_to"]
        sc = wb["scale_to"]
        inner_arg = ws * wm * (1 - sc)
        ok = inner_arg > 0
        inner = jnp.where(ok, jnp.log(jnp.where(ok, inner_arg, 1.0)), -1e30)
        return jnp.sum(wm * self._status_to * inner)

    def inv_link(self, eta):
        return jnp.exp(eta)

    def with_weights(self, weights):
        """A jittable/vmappable view with swapped weights (fold-batched
        CV); unlike ``reweight`` this never touches the host."""
        return CoxWeightView(self, weights)

    def reweight(self, weights):
        return GlmCox(
            start=self.start, stop=self.stop, status=np.asarray(self.status),
            strata=self.strata, weights=np.asarray(weights),
            tie_method=self.tie_method, dtype=self.dtype,
        )


class CoxWeightView:
    """GlmCox with swapped (possibly traced) weights.

    The index machinery of the base GLM is weight-independent; every
    weight-derived array is recomputed on device by ``weight_bundle``, so
    this view's methods trace under jit/vmap over the weight axis — the
    device-side analog of the reference's ``reweight`` (glm.py:360-371)
    that fold-batched cox CV needs.
    """

    is_multi = False
    name = "cox"
    opt = False

    def __init__(self, base, weights):
        self._base = base
        self.dtype = base.dtype
        self.weights = jnp.asarray(weights, base.dtype)
        self.y = base.y

    def _wb(self):
        # recomputed per call: XLA CSE dedupes within a trace, and no
        # tracer is ever cached on the (long-lived) view object
        return self._base.weight_bundle(self.weights)

    def gradient(self, eta):
        return self._base.gradient(eta, wb=self._wb())

    def hessian(self, eta, grad):
        return self._base.hessian(eta, grad, wb=self._wb())

    def inv_hessian_gradient(self, eta, grad, hess):
        return self._base.inv_hessian_gradient(eta, grad, hess)

    def loss(self, eta):
        return self._base.loss(eta, wb=self._wb())

    def loss_full(self):
        return self._base.loss_full_w(self._wb())

    def inv_link(self, eta):
        return self._base.inv_link(eta)
