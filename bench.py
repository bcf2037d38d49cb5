"""Benchmark blocks for the grpnet path on one GPU.

    python bench.py

Each block runs in its own child process, one after another, so only one
process ever holds the card (a JAX process reserves most of the card's
memory when it starts).  The parent never imports JAX.  After every
block the parent prints the cumulative result as one JSON line, so a run
cut short still leaves its freshest line last.  Total wall budget comes
from ``ADELIE_TPU_BENCH_BUDGET_S`` (default 2100 s); a block whose
estimate exceeds the remaining budget is skipped with the reason.

Every timed fit passes a correctness gate first: an f64 numpy KKT
certificate (``benchmark/bench_baseline.py``).  Roofline shares divide by
the device's published peaks (``DEVICE_PEAKS``); a device missing from
that table is an error.  Blocks:

- ``headline``: dense gaussian lasso path, n=40,000 p=2,000, 100 lambdas;
- ``eur_subset``: the EUR-shaped SNP group lasso (bench_baseline config 4);
- ``gwas_snp_path``: in-memory GWAS path, 50k samples x 200k SNPs packed;
- ``gwas_first_fit``: that fit in a fresh process against the compile
  cache the previous block filled;
- ``north_star``: the 1M-SNP x 100k-sample panel (synthesized once by
  ``benchmark/north_star_data.py``);
- ``kernels``: dense gradient, screen Gram, residual update and the SNP
  decode-matvec against the device peaks;
- ``constrained``: constrained logistic path vs the same-shape
  unconstrained one;
- ``sparse``: the sparse product layouts.
"""

import json
import os
import time

import numpy as np

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("ADELIE_TPU_BENCH_BUDGET_S", "2100"))
RESULT = {}
HERE = os.path.dirname(os.path.abspath(__file__))

# Published per-device peaks, dense rates without sparsity (NVIDIA H100
# data sheet; SXM and PCIe parts).  Keyed by jax's device_kind.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_gbps=3350.0, fp32_tflops=67.0,
                                  tf32_tflops=495.0, bf16_tflops=989.0),
    "NVIDIA H100 PCIe": dict(hbm_gbps=2000.0, fp32_tflops=51.0,
                             tf32_tflops=378.0, bf16_tflops=756.0),
}


def device_peaks(kind):
    """Peaks of a device kind; an unknown device is an error."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {kind!r}; add it to "
                       "bench.DEVICE_PEAKS with its source") from None


def _remaining():
    return BUDGET_S - (time.monotonic() - T0)


def _emit():
    """Print the cumulative result line (the last one is the most complete)."""
    RESULT["elapsed_s"] = round(time.monotonic() - T0, 1)
    RESULT["budget_s"] = BUDGET_S
    print(json.dumps(RESULT), flush=True)


def _device():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _timeit(fn, reps=20):
    """Median per-call time after a warm-up; each call ends in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _kernel_rooflines():
    """The hot device kernels, achieved rate vs the device's peak."""
    import jax
    import jax.numpy as jnp

    from adelie_tpu.matrix._snp_triton import snp_mul
    from adelie_tpu.solver.pin import screen_gram

    dev = _device()
    peaks = device_peaks(dev["kind"])
    hi = jax.lax.Precision.HIGHEST
    rng = np.random.default_rng(1)
    out = {"device": dev}

    # dense gradient X^T (w r): n=50000 p=2000 f32 (bandwidth-bound)
    n, p = 50000, 2000
    X = jnp.asarray(rng.standard_normal((n, p)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    grad = jax.jit(lambda X, v, w: jnp.einsum("n,np->p", v * w, X,
                                              precision=hi))
    t = _timeit(lambda: grad(X, v, w))
    gbps = n * p * 4 / t / 1e9
    out["dense_grad"] = {"ms": t * 1e3, "gbps": gbps,
                         "pct_hbm_peak": 100 * gbps / peaks["hbm_gbps"]}

    # screen Gram Xs^T W Xs: n=50000 S=1024 at configs.matmul_precision
    S = 1024
    Xs = jnp.asarray(rng.standard_normal((n, S)).astype(np.float32))
    t = _timeit(lambda: screen_gram(Xs, w, True)[0])
    tflops = 2.0 * n * S * S / t / 1e12
    out["screen_gram"] = {"ms": t * 1e3, "tflops": tflops,
                          "pct_fp32_peak": 100 * tflops / peaks["fp32_tflops"]}

    # residual update resid - Xs @ dbeta (bandwidth-bound)
    dbeta = jnp.asarray(rng.standard_normal(S).astype(np.float32))
    rupd = jax.jit(lambda r, Xs, d: r - jnp.matmul(Xs, d, precision=hi))
    t = _timeit(lambda: rupd(v, Xs, dbeta))
    gbps = n * S * 4 / t / 1e9
    out["resid_update"] = {"ms": t * 1e3, "gbps": gbps,
                           "pct_hbm_peak": 100 * gbps / peaks["hbm_gbps"]}

    # SNP fused 2-bit decode-matvec: p=200k, n=50k
    ps, ns = 200_000, 50_000
    nb = (ns + 3) // 4
    packed = jax.random.bits(jax.random.PRNGKey(0), (ps, nb), jnp.uint8)
    u = jnp.asarray(rng.standard_normal(ns).astype(np.float32))
    imp = jnp.ones((ps,), jnp.float32)
    t = _timeit(lambda: snp_mul(packed, u, imp))
    gbps = ps * nb / t / 1e9
    out["snp_grad"] = {"ms": t * 1e3, "packed_gbps": gbps,
                       "pct_hbm_peak": 100 * gbps / peaks["hbm_gbps"]}
    return out


def _sparse_bench():
    """Sparse matrix products: the padded-CSC gather layout against the
    densified layout, at 1% density.  Useful traffic for a sparse
    gradient is ~nnz * (4 B value + 4 B index)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import adelie_tpu as ad

    rng = np.random.default_rng(5)
    n, p, density = 50_000, 8_000, 0.01
    M = sp.random(n, p, density=density, format="csc", dtype=np.float32,
                  random_state=np.random.RandomState(5))
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    out = {"device": _device(), "n": n, "p": p, "density": density,
           "nnz": int(M.nnz)}
    for layout in ("padded", "dense"):
        Xm = ad.matrix.sparse(M, layout=layout)
        f, data = Xm.mul_spec()
        fj = jax.jit(f)
        t = _timeit(lambda: fj(data, v, w))
        out[layout] = {"ms": t * 1e3, "useful_gbps": M.nnz * 8 / t / 1e9}
    out["auto_pick"] = ad.matrix.sparse(M).layout
    return out


def _north_star_bench():
    """The 1M-SNP x 100K-sample panel (25 GB packed): full lambda path.
    The panel is synthesized once (``benchmark/north_star_data.py``); on a
    device whose memory budget holds it the matrix is device-resident,
    else it streams from host memory."""
    import sys

    sys.path.insert(0, os.path.join(HERE, "benchmark"))
    import north_star_data as nsd

    import adelie_tpu as ad

    budget_s = float(os.environ.get("ADELIE_TPU_NORTH_STAR_BUDGET_S", 3000))
    cached = os.path.exists(nsd.PACKED_PATH) and os.path.exists(nsd.Y_PATH)
    if not cached and budget_s < 2400:
        # synthesizing the 25 GB panel takes many minutes: not inside a
        # budget that could not then also run the fits
        return {"skipped": f"north-star cache absent at {nsd.CACHE_DIR} and "
                           f"budget {budget_s:.0f}s < 2400s; run "
                           "benchmark/north_star_data.py first"}
    nsd.ensure(verbose=False)
    io = nsd.NorthStarIO()
    Xm = ad.matrix.snp_unphased(io, dtype=np.float32)
    glm = ad.glm.gaussian(io.y, dtype=np.float32)
    kw = dict(lmda_path_size=50, min_ratio=5e-2, progress_bar=False)
    t0 = time.perf_counter()
    st = ad.grpnet(Xm, glm, **kw)
    cold = time.perf_counter() - t0
    assert st.error == "", st.error
    t0 = time.perf_counter()
    st = ad.grpnet(Xm, glm, **kw)
    warm = time.perf_counter() - t0
    assert st.error == "", st.error
    nz = set(np.asarray(st.betas[-1].tocoo().col).tolist())
    return {"device": _device(), "n": nsd.N, "p": nsd.P,
            "streamed": bool(getattr(Xm, "is_streaming", False)),
            "lambdas": len(st.lmdas), "cold_s": cold, "warm_s": warm,
            "causal_hits": [len(nz & set(io.causal.tolist())),
                            len(io.causal)],
            "dev_final": float(st.devs[-1])}


def _eur_bench():
    """The EUR_subset-shaped SNP group lasso (bench_baseline config 4)."""
    import sys

    sys.path.insert(0, os.path.join(HERE, "benchmark"))
    from bench_baseline import config4_eur_snp_group_lasso

    res, _ = config4_eur_snp_group_lasso()
    res["device"] = _device()
    return res


def _gwas_fit():
    import adelie_tpu as ad
    from benchmark.workloads import gwas

    io, y, _ = gwas()
    Xm = ad.matrix.snp_unphased(io, dtype=np.float32)
    glm = ad.glm.gaussian(y, dtype=np.float32)
    kw = dict(lmda_path_size=50, min_ratio=5e-2, progress_bar=False)
    return io, lambda: ad.grpnet(Xm, glm, **kw)


def _gwas_first_fit_probe():
    """Fresh-process first fit of the GWAS path against the compile cache
    the ``gwas_snp_path`` block filled, with its breakdown."""
    t0 = time.perf_counter()
    import jax

    jax.block_until_ready(jax.device_put(np.zeros(2, np.float32)))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, fit = _gwas_fit()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = fit()
    first = time.perf_counter() - t0
    assert st.error == "", st.error
    return {"device": _device(), "first_fit_s": first,
            "backend_init_s": init_s, "setup_synth_upload_s": setup_s}


def _gwas_bench():
    """The in-memory GWAS path: 200k SNPs x 50k samples, 2.5 GB packed."""
    io, fit = _gwas_fit()
    t0 = time.perf_counter()
    st = fit()
    cold = time.perf_counter() - t0
    assert st.error == "", st.error
    t0 = time.perf_counter()
    st = fit()
    warm = time.perf_counter() - t0
    assert st.error == "", st.error
    devs = np.asarray(st.devs)
    assert np.isfinite(devs).all() and devs[-1] > 0.1
    updates = int(np.sum(st.benchmark.get("cd_updates", [])))
    return {"device": _device(), "n": io.rows(), "p": io.snps(),
            "packed_gb": io.packed.size / 1e9, "lambdas": len(st.lmdas),
            "max_screen": int(max(st.screen_sizes)),
            "nnz_final": int(st.betas[-1].nnz), "dev_final": float(devs[-1]),
            "cold_s": cold, "warm_s": warm, "cd_updates_per_s": updates / warm}


def _headline_block():
    """Dense gaussian lasso path, gated by the f64 KKT certificate."""
    import adelie_tpu as ad
    from benchmark.bench_baseline import kkt_certificate
    from benchmark.workloads import dense_lasso

    n, p, n_lmdas = 40000, 2000, 100
    X, y = dense_lasso(n, p)
    glm = ad.glm.gaussian(y)
    Xm = ad.matrix.dense(X)
    kw = dict(lmda_path_size=n_lmdas, min_ratio=1e-2, intercept=False,
              progress_bar=False, early_exit=False)
    t0 = time.perf_counter()
    ad.grpnet(Xm, glm, **kw)
    cold = time.perf_counter() - t0
    warms = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = ad.grpnet(Xm, glm, **kw)
        warms.append(time.perf_counter() - t0)
    assert state.error == "", state.error
    kkt = kkt_certificate(
        X.astype(np.float64), y.astype(np.float64), np.full(n, 1.0 / n),
        [state.betas[i] for i in range(state.betas.shape[0])],
        state.intercepts, state.lmdas, np.arange(p), np.ones(p, int),
        np.ones(p))
    assert kkt < 1e-3, f"KKT certificate {kkt:.2e}"
    warm = float(np.median(warms))
    updates = int(np.sum(state.benchmark.get("cd_updates", [])))
    return {
        "device": _device(),
        "metric": (f"gaussian lasso full-path fit n={n} p={p} "
                   f"({len(state.lmdas)} lambdas), f64 KKT {kkt:.1e}"),
        "value": warm, "unit": "s", "cold_s": cold, "warm_s_all": warms,
        "cd_updates_per_s": updates / warm, "cd_updates": updates,
    }


def _constrained_block():
    """Constrained logistic path with the same-shape unconstrained one."""
    import adelie_tpu as ad
    import adelie_tpu.constraint as ct

    rng = np.random.default_rng(3)
    nc, pc, qc = 1024, 60, 3
    Xc = rng.standard_normal((nc, pc)).astype(np.float32)
    yc = (Xc[:, :6] @ rng.standard_normal(6) > 0).astype(np.float32)
    groupsc = np.arange(0, pc, qc)

    def fit(constraints):
        return ad.grpnet(
            Xc, ad.glm.binomial(yc, dtype=np.float32), groups=groupsc,
            constraints=constraints, lmda_path_size=20, min_ratio=0.05,
            progress_bar=False)

    boxes = [ct.box(np.full(qc, -0.2), np.full(qc, 0.2)) for _ in groupsc]
    out = {"device": _device()}
    for key, cons in (("constrained_logistic_s", boxes),
                      ("unconstrained_logistic_s", None)):
        fit(cons)
        t0 = time.perf_counter()
        st = fit(cons)
        out[key] = time.perf_counter() - t0
        assert st.error == "", st.error
        if cons is not None:
            assert np.all(np.abs(np.asarray(st.betas.todense())) <= 0.2 + 1e-3)
    return out


def _selftest_bench():
    """No-device block used to exercise the _run_isolated harness."""
    return {"ok": True}


def _sleep_bench():
    """No-device block that outlives any test timeout."""
    time.sleep(60)
    return {"ok": True}


def _run_isolated(block_fn, timeout_s, env=None):
    """Run one bench block in a fresh child process with a hard timeout.

    The block's JSON result is read from a marker line on its stdout; a
    child that fails or times out returns a structured error, so one
    block cannot take down the run.  Children run one at a time and share
    the persistent compile cache."""
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        f"from bench import {block_fn}\n"
        f"res = {block_fn}()\n"
        "print('@@BENCH@@' + json.dumps(res), flush=True)\n"
    )
    child_env = dict(os.environ, **(env or {}))
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=HERE, timeout=timeout_s,
            capture_output=True, text=True, env=child_env,
        )
    except subprocess.TimeoutExpired:
        return {"error": f"{block_fn} timed out after {timeout_s}s"}
    for line in proc.stdout.splitlines():
        if line.startswith("@@BENCH@@"):
            return json.loads(line[len("@@BENCH@@"):])
    tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-3:]
    return {"error": f"{block_fn} rc={proc.returncode}: "
                     + " | ".join(tail)[:300]}


# (result key, block function, estimated seconds, hard timeout seconds)
BLOCKS = (
    ("headline", "_headline_block", 120, 600),
    ("gwas_snp_path", "_gwas_bench", 180, 900),
    ("gwas_first_fit", "_gwas_first_fit_probe", 90, 600),
    ("eur_subset", "_eur_bench", 180, 900),
    ("north_star", "_north_star_bench", 300, 1800),
    ("kernels", "_kernel_rooflines", 60, 600),
    ("constrained", "_constrained_block", 60, 600),
    ("sparse", "_sparse_bench", 60, 600),
)


def main():
    RESULT["metric"] = "incomplete: killed before the headline block"
    RESULT["value"] = None
    RESULT["unit"] = "s"
    _emit()
    for key, fn, est_s, cap_s in BLOCKS:
        rem = _remaining()
        if rem < est_s:
            RESULT[key] = {"skipped": f"budget: {rem:.0f}s remaining < "
                                      f"~{est_s}s estimate"}
        else:
            RESULT[key] = _run_isolated(fn, int(min(cap_s, rem)))
        if key == "headline" and "error" not in RESULT[key]:
            for k in ("metric", "value", "unit", "device"):
                RESULT[k] = RESULT[key].pop(k)
        _emit()


if __name__ == "__main__":
    main()
