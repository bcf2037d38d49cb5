"""Kernel microbenchmarks (the reference's benchmark/bench_matrix.py /
bench_omp.cpp analog): sweeps the hot device kernels and prints a table.

Run on whatever jax.devices() offers:  python benchmark/bench_kernels.py
"""

import time

import numpy as np
import jax
import jax.numpy as jnp


def timeit(fn, *args, reps=30):
    """Median per-call time after a warm-up; each call ends in
    block_until_ready."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_mul():
    """Full gradient X^T (w*v): the per-lambda invariance op."""
    from adelie_tpu import matrix as mx

    print("\n== dense mul: X^T (w v) ==")
    rng = np.random.default_rng(0)
    for n, p in [(2000, 500), (20000, 1000), (50000, 2000)]:
        X = mx.dense(rng.standard_normal((n, p)).astype(np.float32))
        v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        w = jnp.full(n, 1.0 / n, jnp.float32)
        t = timeit(X.mul, v, w)
        gb = (n * p * 4) / 1e9
        print(f"  n={n:6d} p={p:5d}: {t*1e3:7.2f} ms  ({gb/t:6.1f} GB/s)")


def bench_snp_mul():
    """2-bit packed SNP gradient (decode fused into the matmul)."""
    from adelie_tpu import matrix as mx

    print("\n== snp 2-bit mul: X^T (w v) ==")
    rng = np.random.default_rng(0)
    for n, p in [(10000, 20000), (50000, 100000)]:
        nb = (n + 3) // 4

        class IO:
            packed = rng.integers(0, 256, size=(p, nb), dtype=np.uint64).astype(np.uint8)
            impute = np.ones(p)

            def _ensure(self):
                pass

            def rows(self):
                return n

            def snps(self):
                return p

        m = mx.snp_unphased(IO(), dtype=np.float32)
        f, data = m.mul_spec()
        v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        w = jnp.full(n, 1.0 / n, jnp.float32)
        jf = jax.jit(f)
        t = timeit(jf, data, v, w)
        gb_packed = (p * nb) / 1e9
        print(f"  n={n:6d} p={p:6d}: {t*1e3:7.2f} ms  "
              f"({gb_packed/t:6.1f} GB/s packed; x16 effective f32)")


def bench_pin():
    """Pin solve (lasso): the hand kernel vs the XLA loop it replaces."""
    from adelie_tpu.configs import set_configs
    from adelie_tpu.solver.pin import pin_cov_solve

    print("\n== pin solve (lasso, lmda=0.01): kernel vs xla ==")
    rng = np.random.default_rng(0)
    f32 = jnp.float32
    for S in [128, 512, 1024, 4096]:
        n = 4 * S
        X = rng.standard_normal((n, S)).astype(np.float32)
        A = jnp.asarray(X.T @ X / n)
        y = X[:, 0] + 0.1 * rng.standard_normal(n)
        grad = jnp.asarray((X.T @ y / n).astype(np.float32))
        args = (A, grad, jnp.zeros(S, f32), jnp.arange(S, dtype=jnp.int32),
                jnp.ones(S, jnp.int32), jnp.diagonal(A)[:, None],
                jnp.ones((S, 1, 1), f32), jnp.ones(S, f32),
                jnp.zeros(S, bool), f32(0.01), f32(1.0), f32(1e-7),
                f32(1e-12), f32(1e-12), jnp.int32(1000), jnp.int32(100000),
                f32(0.0))
        row = []
        for mode in ("auto", "xla"):
            set_configs("kernels", mode)
            jax.clear_caches()
            row.append(f"{mode} {timeit(pin_cov_solve, *args, reps=5) * 1e3:8.3f} ms")
        set_configs("kernels", None)
        print(f"  S={S:5d}: " + "   ".join(row))


def bench_gram():
    """Screen Gram Xs^T W Xs (the per-screen-change matmul)."""
    from adelie_tpu.solver.pin import screen_gram

    print("\n== screen gram ==")
    rng = np.random.default_rng(0)
    for n, S in [(20000, 512), (50000, 1024)]:
        Xs = jnp.asarray(rng.standard_normal((n, S)).astype(np.float32))
        w = jnp.full(n, 1.0 / n, jnp.float32)
        t = timeit(screen_gram, Xs, w, True)
        fl = 2 * n * S * S / 1e12
        print(f"  n={n:6d} S={S:5d}: {t*1e3:7.2f} ms  ({fl/t:6.2f} TFLOP/s)")


def bench_sparse():
    """Sparse gradient/product: padded gather planes vs the dense
    roofline (BCOO removed in r5 — see matrix/_sparse.py; reference
    sparse kernels matrix/utils.hpp:362-1015)."""
    import scipy.sparse as sp
    from adelie_tpu import matrix as mx

    print("\n== sparse mul: X^T (w v)  (padded gather vs dense) ==")
    rng = np.random.default_rng(0)
    for n, p_, density in [(20000, 2000, 0.05), (50000, 5000, 0.01)]:
        Z = (rng.standard_normal((n, p_)) *
             (rng.uniform(size=(n, p_)) < density)).astype(np.float32)
        Zs = sp.csc_matrix(Z)
        v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        w = jnp.full(n, 1.0 / n, jnp.float32)
        beta = jnp.asarray(rng.standard_normal(p_).astype(np.float32))
        nnz_gb = Zs.nnz * 8 / 1e9  # value + index
        rows = []
        for layout in ("padded",):
            m = mx.sparse(Zs, layout=layout)
            tm = timeit(m.mul, v, w)
            tt = timeit(m.tmul, beta)
            rows.append((layout, tm, tt))
        md = mx.dense(Z)
        tdm = timeit(md.mul, v, w)
        tdt = timeit(md.tmul, beta)
        rows.append(("dense", tdm, tdt))
        print(f"  n={n} p={p_} density={density} nnz={Zs.nnz}")
        for name, tm, tt in rows:
            eff = nnz_gb / tm
            print(f"    {name:7s}: mul {tm*1e3:8.3f} ms ({eff:6.1f} GB/s nnz)"
                  f"   tmul {tt*1e3:8.3f} ms")


if __name__ == "__main__":
    print(f"backend: {jax.default_backend()}  devices: {len(jax.devices())}")
    bench_mul()
    bench_gram()
    bench_snp_mul()
    bench_sparse()
    bench_pin()
