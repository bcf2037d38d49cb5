"""The hand kernels compiled for the card against their plain XLA paths.

Marked ``gpu``: they skip on the CPU and run on a machine with a card via
``ADELIE_TEST_PLATFORM=gpu python -m pytest tests/test_gpu_kernels.py -m gpu``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from adelie_tpu.configs import set_configs

pytestmark = pytest.mark.gpu


def _both_modes(fn):
    outs = {}
    try:
        for mode in ("xla", "auto"):
            set_configs("kernels", mode)
            jax.clear_caches()
            outs[mode] = fn()
    finally:
        set_configs("kernels", None)
        jax.clear_caches()
    return outs["xla"], outs["auto"]


def test_pin_kernel_on_card(gpu):
    from adelie_tpu.solver.pin import pin_cov_solve, screen_eigh

    f = jnp.float32
    S, n = 512, 2000
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, S))
    A = jnp.asarray(X.T @ X / n, f)
    grad = jnp.asarray(X.T @ (X[:, :8].sum(1) + rng.standard_normal(n)) / n, f)
    sb = jnp.arange(S, dtype=jnp.int32)
    ss = jnp.ones(S, jnp.int32).at[-7:].set(0)
    ev, evec = screen_eigh(A, sb, ss, 1)
    pen = jnp.ones(S, f)

    def run():
        return pin_cov_solve(
            A, grad, jnp.zeros(S, f), sb, ss, ev, evec, pen,
            jnp.zeros(S, bool), f(0.02), f(1.0), f(1e-9), f(1e-12),
            f(1e-12), jnp.int32(1000), jnp.int32(100000), f(0.0))

    ox, ok = _both_modes(run)
    assert bool(ok[5])
    np.testing.assert_allclose(np.asarray(ok[0]), np.asarray(ox[0]),
                               atol=1e-5)


@pytest.mark.parametrize("na", [True, False])
def test_snp_kernel_on_card(gpu, na):
    from adelie_tpu.matrix._snp import unpack_2bit_np
    from adelie_tpu.matrix._snp_triton import snp_mul

    rng = np.random.default_rng(1)
    p, n = 1000, 3001
    nb = (n + 3) // 4
    packed = rng.integers(0, 256, size=(p, nb), dtype=np.int64).astype(np.uint8)
    packed[:, -1] &= (1 << (2 * (n % 4))) - 1
    imp = rng.uniform(0, 2, p).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)
    codes = unpack_2bit_np(packed, n).astype(np.float64)
    dense = np.where(codes == 3, imp[:, None], codes) if na else codes
    got = np.asarray(snp_mul(jnp.asarray(packed), jnp.asarray(u),
                             jnp.asarray(imp) if na else None))
    np.testing.assert_allclose(got, dense @ u, rtol=1e-4, atol=1e-3)
