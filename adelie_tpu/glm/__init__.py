"""GLM loss classes.

Device re-implementation of the reference GLM interface
(``glm_base.hpp:19-93``): each class provides pure-JAX, jittable

* ``gradient(eta) -> (n,)``  — NEGATIVE loss gradient wrt eta (the weighted
  "residual"); observation weights are folded in (as in the reference).
* ``hessian(eta, grad) -> (n,)`` — diagonal Hessian (upper bound).
* ``inv_hessian_gradient(eta, grad, hess)`` — default ``grad / max(hess,
  hessian_min)`` (reference glm_base.ipp:25-37).
* ``loss(eta) -> scalar``, ``loss_full() -> scalar`` (saturated loss),
  ``inv_link(eta)``.

Weights are normalized to sum to one at construction (reference glm.py
factories).  Users can define custom GLMs by subclassing :class:`GlmBase`
and overriding these with jittable functions — the analog of the
reference's ``py_glm.cpp`` trampolines.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..configs import configs

__all__ = [
    "GlmBase",
    "GlmMultiBase",
    "glm_base",
    "multiglm_base",
    "gaussian",
    "binomial",
    "poisson",
    "cox",
    "multigaussian",
    "multinomial",
]


def _normalize_weights(n, weights, dtype):
    if weights is None:
        w = np.full(n, 1.0 / n)
    else:
        w = np.asarray(weights, dtype=np.float64)
        s = w.sum()
        if s <= 0:
            raise ValueError("weights must have positive sum")
        w = w / s
    return jnp.asarray(w, dtype)


def _hessian_min(dtype):
    return (
        configs.hessian_min
        if np.dtype(dtype) == np.float64
        else configs.hessian_min_f32
    )


class GlmBase:
    """Single-response GLM base (reference glm_base.hpp:19-93)."""

    is_multi = False
    opt = False

    def __init__(self, name, y, weights=None, dtype=None):
        self.name = name
        y = np.asarray(y)
        if dtype is None:
            dtype = y.dtype if y.dtype in (np.float32, np.float64) else np.float64
        self.dtype = np.dtype(dtype)
        self.y = jnp.asarray(y, self.dtype)
        self.weights = _normalize_weights(self.y.shape[0], weights, self.dtype)

    # -- overridables ------------------------------------------------------
    def gradient(self, eta):
        raise NotImplementedError

    def hessian(self, eta, grad):
        raise NotImplementedError

    def inv_hessian_gradient(self, eta, grad, hess):
        hmin = _hessian_min(self.dtype)
        return grad / (jnp.maximum(hess, 0.0) + hmin * (hess <= 0))

    def loss(self, eta):
        raise NotImplementedError

    def loss_full(self):
        raise NotImplementedError

    def inv_link(self, eta):
        raise NotImplementedError

    # -- CV support (reference glm.py reweight) ----------------------------
    def reweight(self, weights):
        return type(self)(np.asarray(self.y), np.asarray(weights))


class GlmMultiBase(GlmBase):
    """Multi-response GLM base (reference glm_multibase.hpp).

    ``y`` is (n, K); eta/grad/hess are (n, K).  Loss sums over classes with
    the per-observation weight divided by K (reference convention).
    """

    is_multi = True

    def __init__(self, name, y, weights=None, dtype=None):
        y = np.asarray(y)
        assert y.ndim == 2
        super().__init__(name, y, weights, dtype)


# Reference-name aliases (reference glm.py:33,58): the reference's
# user-extension bases are called glm_base / multiglm_base; subclass these
# to define a custom GLM (see docs/extending.md for the tracing rules).
glm_base = GlmBase
multiglm_base = GlmMultiBase


class GlmGaussian(GlmBase):
    """Weighted least squares (reference glm/glm_gaussian.{hpp,ipp}).

    loss(eta) = sum_i w_i (-y_i eta_i + eta_i^2 / 2).
    """

    opt = True

    def __init__(self, y, weights=None, dtype=None, opt: bool = True):
        super().__init__("gaussian", y, weights, dtype)
        self.opt = opt

    def gradient(self, eta):
        return self.weights * (self.y - eta)

    def hessian(self, eta, grad):
        return self.weights

    def loss(self, eta):
        return jnp.sum(self.weights * (-self.y * eta + 0.5 * eta**2))

    def loss_full(self):
        return -0.5 * jnp.sum(self.weights * self.y**2)

    def inv_link(self, eta):
        return eta


class GlmBinomialLogit(GlmBase):
    """Bernoulli NLL, logit link (reference glm/glm_binomial.ipp)."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("binomial_logit", y, weights, dtype)

    def gradient(self, eta):
        return self.weights * (self.y - jax.nn.sigmoid(eta))

    def hessian(self, eta, grad):
        wp = self.weights * self.y - grad  # W * mu
        denom = self.weights + (self.weights <= 0)
        return wp * (self.weights - wp) / denom

    def loss(self, eta):
        # numerically-stable logistic loss (reference glm_binomial.ipp loss)
        return jnp.sum(
            self.weights
            * (((eta > 0) - self.y) * eta + jnp.log1p(jnp.exp(-jnp.abs(eta))))
        )

    def loss_full(self):
        y = self.y
        term = jnp.where(y > 0, y * jnp.log(jnp.where(y > 0, y, 1.0)), 0.0)
        term = term + jnp.where(
            y < 1, (1 - y) * jnp.log(jnp.where(y < 1, 1 - y, 1.0)), 0.0
        )
        return -jnp.sum(self.weights * term)

    def inv_link(self, eta):
        return jax.nn.sigmoid(eta)


class GlmBinomialProbit(GlmBase):
    """Bernoulli NLL, probit link (reference glm/glm_binomial.ipp)."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("binomial_probit", y, weights, dtype)

    @staticmethod
    def _cdf(x):
        return 0.5 * (1 + jax.scipy.special.erf(x / np.sqrt(2.0)))

    @staticmethod
    def _pdf(x):
        return jnp.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)

    def gradient(self, eta):
        big = np.finfo(self.dtype).max
        Phi = self._cdf(eta)
        return (
            self.weights
            * self._pdf(eta)
            * (
                self.y * jnp.minimum(1.0 / Phi, big)
                - (1 - self.y) * jnp.minimum(1.0 / (1 - Phi), big)
            )
        )

    def hessian(self, eta, grad):
        big = np.finfo(self.dtype).max
        Phi = self._cdf(eta)
        pdf2 = self._pdf(eta) ** 2
        return (
            self.weights
            * (
                self.y * jnp.minimum(1.0 / Phi**2, big)
                + (1 - self.y) * jnp.minimum(1.0 / (1 - Phi) ** 2, big)
            )
            * pdf2
            + eta * grad
        )

    def loss(self, eta):
        big = np.finfo(self.dtype).max
        Phi = self._cdf(eta)
        return -jnp.sum(
            self.weights
            * (
                self.y * jnp.maximum(jnp.log(Phi), -big)
                + (1 - self.y) * jnp.maximum(jnp.log1p(-Phi), -big)
            )
        )

    def loss_full(self):
        return GlmBinomialLogit.loss_full(self)

    def inv_link(self, eta):
        return self._cdf(eta)


class GlmPoisson(GlmBase):
    """Poisson NLL (reference glm/glm_poisson.{hpp,ipp})."""

    def __init__(self, y, weights=None, dtype=None):
        super().__init__("poisson", y, weights, dtype)

    def gradient(self, eta):
        return self.weights * (self.y - jnp.exp(eta))

    def hessian(self, eta, grad):
        return self.weights * self.y - grad  # w * exp(eta)

    def loss(self, eta):
        return jnp.sum(self.weights * (jnp.exp(eta) - self.y * eta))

    def loss_full(self):
        y = self.y
        ylogy = jnp.where(y > 0, y * jnp.log(jnp.where(y > 0, y, 1.0)), 0.0)
        return jnp.sum(self.weights * (y - ylogy))

    def inv_link(self, eta):
        return jnp.exp(eta)


# --------------------------------------------------------------------------- #
# factories mirroring adelie.glm (reference adelie/glm.py)                     #
# --------------------------------------------------------------------------- #


def gaussian(y, weights=None, *, dtype=None, opt: bool = True, **kwargs):
    """Gaussian GLM (reference glm.py:379)."""
    return GlmGaussian(y, weights, dtype, opt=opt)


def binomial(y, weights=None, *, link: str = "logit", dtype=None, **kwargs):
    """Binomial GLM with logit/probit link (reference glm.py:83-199)."""
    from ..utils import types

    link = types.binomial_link(link)
    if link == "logit":
        return GlmBinomialLogit(y, weights, dtype)
    return GlmBinomialProbit(y, weights, dtype)


def poisson(y, weights=None, *, dtype=None, **kwargs):
    """Poisson GLM (reference glm.py:631)."""
    return GlmPoisson(y, weights, dtype)


def cox(
    start=None,
    stop=None,
    status=None,
    strata=None,
    weights=None,
    *,
    tie_method: str = "efron",
    dtype=None,
    **kwargs,
):
    """Cox partial likelihood GLM (reference glm.py:199-330).

    ``start=None`` means no left truncation: every subject enters the risk
    set at -inf (plain right-censored survival data)."""
    from ._cox import GlmCox
    import numpy as _np

    if start is None and stop is not None:
        start = _np.full(_np.asarray(stop).shape, -_np.inf)
    return GlmCox(
        start=start,
        stop=stop,
        status=status,
        strata=strata,
        weights=weights,
        tie_method=tie_method,
        dtype=dtype,
    )


def multigaussian(y, weights=None, *, dtype=None, opt: bool = True, **kwargs):
    """Multi-response gaussian (reference glm.py:456)."""
    from .multi import GlmMultiGaussian

    return GlmMultiGaussian(y, weights, dtype, opt=opt)


def multinomial(y, weights=None, *, dtype=None, **kwargs):
    """Multinomial (softmax) GLM (reference glm.py:541)."""
    from .multi import GlmMultinomial

    return GlmMultinomial(y, weights, dtype)
