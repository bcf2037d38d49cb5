"""configs.matmul_precision: the Gram contraction precision knob.

Each value's error against f64 and its time on the card are printed by
chip_smoke.py phase 1.  These tests pin the plumbing (mapping,
validation, solver equivalence at the x3 tolerance), not the device
timings.
"""

import numpy as np
import jax
import pytest

import adelie_tpu as ad
from adelie_tpu.configs import matmul_precision_value, set_configs


def _fresh():
    # precision is read at trace time; drop traced programs between flips
    jax.clear_caches()


def test_mapping():
    assert matmul_precision_value() == jax.lax.Precision.HIGHEST
    try:
        set_configs("matmul_precision", "x3")
        assert matmul_precision_value() == "BF16_BF16_F32_X3"
        set_configs("matmul_precision", "default")
        assert matmul_precision_value() == jax.lax.Precision.DEFAULT
        set_configs("matmul_precision", "float32")
        assert matmul_precision_value() == jax.lax.Precision.HIGHEST
        set_configs("matmul_precision", "nope")
        with pytest.raises(ValueError, match="matmul_precision"):
            matmul_precision_value()
    finally:
        set_configs("matmul_precision", None)


def test_x3_grpnet_close_to_highest():
    rng = np.random.default_rng(3)
    n, p = 400, 60
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = (X[:, :4] @ rng.standard_normal(4) + 0.1 * rng.standard_normal(n)
         ).astype(np.float32)

    def fit():
        st = ad.grpnet(ad.matrix.dense(X), ad.glm.gaussian(y),
                       progress_bar=False)
        return np.asarray(st.betas.todense()), np.asarray(st.lmdas)

    _fresh()
    b_hi, lm_hi = fit()
    try:
        set_configs("matmul_precision", "x3")
        _fresh()
        b_x3, lm_x3 = fit()
    finally:
        set_configs("matmul_precision", None)
        _fresh()

    np.testing.assert_allclose(lm_x3, lm_hi, rtol=1e-6)
    # x3 Grams carry ~1e-5 relative error; solutions stay close at that scale
    scale = np.max(np.abs(b_hi)) + 1e-12
    assert np.max(np.abs(b_x3 - b_hi)) / scale < 5e-3
