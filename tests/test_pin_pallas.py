"""Pallas lasso pin kernel (solver/pin_triton.py) vs the XLA reference path
and a numpy Gauss-Seidel pass, in interpret mode on the CPU; its lowering
to Triton IR; and the per-backend kernel table (adelie_tpu/kernels.py).
The compiled kernel on the card is covered by tests/test_gpu_kernels.py
and chip_smoke.py."""

import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

# pallas interpret mode traces deeply-nested loop bodies; the default
# recursion limit is too small under pytest's already-deep call stack
sys.setrecursionlimit(100000)

from adelie_tpu import kernels
from adelie_tpu.configs import set_configs
from adelie_tpu.solver.pin import FILTERED_SWEEP_MIN_S, pin_cov_solve, screen_eigh
from adelie_tpu.solver.pin_triton import pin_lasso_solve

f = jnp.float32


def _problem(n, S, n_invalid, seed, lmda, alpha=1.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, S))
    A = jnp.asarray(X.T @ X / n, jnp.float32)
    y = X[:, 0] - X[:, min(5, S - 1)] + 0.1 * rng.standard_normal(n)
    grad = jnp.asarray(X.T @ y / n, jnp.float32)
    slot_begin = jnp.arange(S, dtype=jnp.int32)
    slot_size = jnp.ones(S, jnp.int32)
    if n_invalid:
        slot_size = slot_size.at[-n_invalid:].set(0)
    eigvals, eigvecs = screen_eigh(A, slot_begin, slot_size, 1)
    pen = jnp.asarray(rng.uniform(0.5, 1.5, S), jnp.float32)
    return A, grad, slot_begin, slot_size, eigvals, eigvecs, pen


def _floors(eigvals, tol):
    # the f32 tolerance floor and stall floor pin_cov_solve hands the kernel
    eps = float(np.finfo(np.float32).eps)
    lam_max = max(float(jnp.max(jnp.abs(eigvals))), 1.0)
    return (f(max(tol, 100.0 * lam_max * (10.0 * eps) ** 2)),
            f(1e8 * lam_max * eps * eps))


def _kernel(A, grad, beta, eigvals, valid, act, pen, lmda, alpha, tol,
            max_iters, rsq):
    tol_f, stall = _floors(eigvals, tol)
    return pin_lasso_solve(
        A, grad, beta, eigvals[:, 0], valid, act, pen,
        f(lmda * alpha), f(lmda * (1 - alpha)), tol_f, stall,
        f(max_iters), rsq, interpret=True)


def _xla(A, grad, beta, slot_begin, slot_size, eigvals, eigvecs, pen, act,
         lmda, alpha, rsq):
    return pin_cov_solve(
        A, grad, beta, slot_begin, slot_size, eigvals, eigvecs, pen, act,
        f(lmda), f(alpha), f(1e-9), f(1e-12), f(1e-12), jnp.int32(1000),
        jnp.int32(100000), rsq)


@pytest.mark.parametrize("S,n_invalid,lmda,alpha", [
    (32, 0, 0.05, 1.0),
    (64, 5, 0.02, 1.0),
    (48, 3, 0.05, 0.7),
])
def test_pallas_matches_xla(S, n_invalid, lmda, alpha):
    A, grad, slot_begin, slot_size, eigvals, eigvecs, pen = _problem(
        300, S, n_invalid, S, lmda, alpha)
    beta0 = jnp.zeros(S, jnp.float32)
    act = jnp.zeros(S, bool)
    out_x = _xla(A, grad, beta0, slot_begin, slot_size, eigvals, eigvecs,
                 pen, act, lmda, alpha, f(0.0))
    out_p = _kernel(A, grad, beta0, eigvals, slot_size > 0, act, pen, lmda,
                    alpha, 1e-9, 100000, f(0.0))
    np.testing.assert_allclose(np.asarray(out_x[0]), np.asarray(out_p[0]),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out_x[1]), np.asarray(out_p[1]),
                               atol=2e-5)
    assert np.isclose(float(out_x[3]), float(out_p[3]), atol=1e-4)
    assert bool(out_p[5])
    # invalid slots never activate or move
    if n_invalid:
        assert np.all(np.asarray(out_p[0])[-n_invalid:] == 0)
        assert not np.any(np.asarray(out_p[2])[-n_invalid:])


def test_pallas_warm_start():
    """Warm-started solve from a previous lambda matches XLA."""
    S = 32
    A, grad, slot_begin, slot_size, eigvals, eigvecs, pen = _problem(
        200, S, 0, 3, 0.05)
    b1, g1, a1, r1, _, _ = _xla(A, grad, jnp.zeros(S, jnp.float32),
                                slot_begin, slot_size, eigvals, eigvecs,
                                pen, jnp.zeros(S, bool), 0.05, 1.0, f(0.0))
    out_x = _xla(A, g1, b1, slot_begin, slot_size, eigvals, eigvecs, pen,
                 a1, 0.01, 1.0, r1)
    out_p = _kernel(A, g1, b1, eigvals, slot_size > 0, a1, pen, 0.01, 1.0,
                    1e-9, 100000, r1)
    np.testing.assert_allclose(np.asarray(out_x[0]), np.asarray(out_p[0]),
                               atol=2e-5)
    assert np.isclose(float(out_x[3]), float(out_p[3]), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(out_x[2]), np.asarray(out_p[2]))


def test_cd_sweep_rows_matches_numpy_gs():
    """With nothing active and max_iters=1 the kernel runs exactly one
    Gauss-Seidel pass over the valid coordinates; it must reproduce a
    numpy pass, including the active flags and the rsq bookkeeping."""
    rng = np.random.default_rng(0)
    S, n_valid = 128, 100
    B = rng.standard_normal((100, S)).astype(np.float32) / 10
    A = (B.T @ B + np.eye(S, dtype=np.float32)).astype(np.float32)
    grad = rng.standard_normal(S).astype(np.float32)
    diag = np.diag(A).copy()
    pen = rng.uniform(0.5, 1.5, S).astype(np.float32)
    valid = np.arange(S) < n_valid
    l1, l2, rsq0 = np.float32(0.3), np.float32(0.1), np.float32(0.25)

    b2, g2, act, rsq, iters, _ = pin_lasso_solve(
        jnp.asarray(A), jnp.asarray(grad), jnp.zeros(S, jnp.float32),
        jnp.asarray(diag), jnp.asarray(valid), jnp.zeros(S, bool),
        jnp.asarray(pen), f(l1), f(l2), f(1e-9), f(0.0), f(1.0),
        f(rsq0), interpret=True)

    bn, gn, rq = np.zeros(S, np.float32), grad.copy(), float(rsq0)
    moved = np.zeros(S, bool)
    for p in range(n_valid):
        u = gn[p] + diag[p] * bn[p]
        mag = max(abs(u) - l1 * pen[p], 0.0)
        bnew = np.sign(u) * mag / (diag[p] + l2 * pen[p])
        d = bnew - bn[p]
        if d == 0:
            continue
        rq += d * (2 * gn[p] - d * diag[p])
        gn = gn - d * A[p]
        bn[p] = bnew
        moved[p] = True

    assert moved.any() and not moved.all()
    np.testing.assert_allclose(np.asarray(b2), bn, atol=2e-5)
    np.testing.assert_allclose(np.asarray(g2), gn, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(act), moved)
    assert np.isclose(float(rsq), rq, rtol=1e-4)
    assert int(iters) == 2   # one (empty) active phase + one full sweep


def test_big_s_filtered_full_sweep_solution():
    """S past FILTERED_SWEEP_MIN_S switches the XLA loop's full screen
    sweeps to the filtered (vectorized-selection) formulation; the
    solution must still match the small-S exact-Gauss-Seidel solve at
    solver tol."""
    rng = np.random.default_rng(5)
    p = 96
    B = rng.standard_normal((200, p)).astype(np.float32) / 14
    A_small = (B.T @ B + 0.5 * np.eye(p, dtype=np.float32))
    grad = rng.standard_normal(p).astype(np.float32)

    def solve(S_cap):
        A = np.zeros((S_cap, S_cap), np.float32)
        A[:p, :p] = A_small
        g = np.zeros(S_cap, np.float32)
        g[:p] = grad
        sb = jnp.arange(S_cap, dtype=jnp.int32)
        ssz = jnp.asarray((np.arange(S_cap) < p).astype(np.int32))
        ev = jnp.asarray(
            np.where(np.arange(S_cap) < p, np.diag(A), 1.0)
            [:, None].astype(np.float32))
        evec = jnp.ones((S_cap, 1, 1), jnp.float32)
        pen = jnp.ones((S_cap,), jnp.float32)
        out = pin_cov_solve(
            jnp.asarray(A), jnp.asarray(g), jnp.zeros(S_cap, jnp.float32),
            sb, ssz, ev, evec, pen, jnp.zeros(S_cap, bool),
            f(0.2), f(1.0), f(1e-10), f(1e-14), f(1e-12),
            jnp.int32(1000), jnp.int32(100000), f(0.0))
        assert bool(out[5]), "pin solve must converge"
        return np.asarray(out[0])[:p]

    b_small = solve(128)                            # exact GS full sweeps
    b_big = solve(FILTERED_SWEEP_MIN_S + 1024)      # filtered full sweeps
    np.testing.assert_allclose(b_small, b_big, atol=5e-5)


@pytest.mark.parametrize("S,n_invalid", [(40, 4), (64, 0)])
def test_pin_cov_solve_dispatches_kernel(S, n_invalid):
    """pin_cov_solve under configs.kernels="interpret" hands the lasso
    solve to the kernel through the slot adapter (non-power-of-two S is
    padded, invalid slots are dropped) and agrees with the XLA loop."""
    A, grad, slot_begin, slot_size, eigvals, eigvecs, pen = _problem(
        250, S, n_invalid, 11, 0.03)
    args = (A, grad, jnp.zeros(S, jnp.float32), slot_begin, slot_size,
            eigvals, eigvecs, pen, jnp.zeros(S, bool), 0.03, 1.0, f(0.0))
    outs = {}
    try:
        for mode in ("xla", "interpret"):
            set_configs("kernels", mode)
            jax.clear_caches()
            outs[mode] = _xla(*args)
    finally:
        set_configs("kernels", None)
        jax.clear_caches()
    ox, op = outs["xla"], outs["interpret"]
    np.testing.assert_allclose(np.asarray(ox[0]), np.asarray(op[0]),
                               atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ox[2]), np.asarray(op[2]))
    assert int(ox[4]) == int(op[4]) and bool(op[5])


def test_pin_kernel_vmaps():
    """The kernel batches under vmap (the fold-batched CV path)."""
    S = 32
    probs = [_problem(150, S, 2, s, 0.04) for s in (1, 2)]
    stack = [jnp.stack(x) for x in zip(*probs)]
    A, grad, _, slot_size, eigvals, _, pen = stack
    tol_f, stall = _floors(eigvals, 1e-9)

    def one(A, grad, ev, valid, pen):
        return pin_lasso_solve(
            A, grad, jnp.zeros(S, jnp.float32), ev[:, 0], valid,
            jnp.zeros(S, bool), pen, f(0.04), f(0.0), tol_f, stall,
            f(1e5), f(0.0), interpret=True)

    batched = jax.vmap(one)(A, grad, eigvals, slot_size > 0, pen)
    for k in range(2):
        single = one(A[k], grad[k], eigvals[k], slot_size[k] > 0, pen[k])
        np.testing.assert_allclose(np.asarray(batched[0][k]),
                                   np.asarray(single[0]), atol=1e-6)


def test_pin_kernel_lowers_to_triton():
    """The kernel lowers for CUDA through the Triton route (Triton IR is
    generated here; only its compilation to PTX needs the card)."""
    from jax import export

    S = 256
    args = (jnp.zeros((S, S), f),) + (jnp.zeros(S, f),) * 2 + (
        jnp.ones(S, f), jnp.ones(S, bool), jnp.zeros(S, bool),
        jnp.ones(S, f)) + (f(0.1),) * 6
    exp = export.export(
        jax.jit(lambda *a: pin_lasso_solve(*a)), platforms=("cuda",),
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(*args)
    assert "xla.gpu.triton" in exp.mlir_module()


@pytest.mark.parametrize("mode,platform,dtype,expect", [
    ("auto", "gpu", np.float32, "triton"),
    ("auto", "gpu", np.float64, None),
    ("auto", "cpu", np.float32, None),
    ("auto", "cpu", np.float64, None),
    ("xla", "gpu", np.float32, None),
    ("interpret", "cpu", np.float32, "interpret"),
    ("interpret", "gpu", np.float64, None),
])
def test_kernel_choice_table(mode, platform, dtype, expect):
    try:
        set_configs("kernels", mode)
        assert kernels.choose(dtype, platform) == expect
    finally:
        set_configs("kernels", None)


def test_kernel_choice_default_never_interprets():
    """Left at "auto", this CPU backend runs the plain XLA path: no silent
    interpret-mode fallback; an unknown mode is an error."""
    assert kernels.choose(np.float32) is None
    try:
        set_configs("kernels", "mosaic")
        with pytest.raises(ValueError, match="kernels"):
            kernels.choose(np.float32)
    finally:
        set_configs("kernels", None)
