"""Smoke test of the grpnet main path on one GPU, at real sizes.

    python chip_smoke.py              # one card; fails without a GPU
    python chip_smoke.py --small      # rehearsal: toy sizes on the CPU,
                                      # kernels in Pallas interpret mode
    python chip_smoke.py --four-gpus  # only the two 4-card mesh fits,
                                      # each against the same fit on 1 card

Phases (each prints what it ran, its times and its errors against the
reference; any failure raises and exits non-zero without the result line):

0. device report: JAX devices, the card's name and power limit, the JAX
   version, the compile cache in use and XLA_FLAGS;
1. the hand kernels against plain references on the card: the q = 1 pin
   solve kernel vs the XLA ``pin_cov_solve`` loop, the SNP decode-matvec
   kernel (NA and NA-free) vs a plain XLA decode + HIGHEST contraction and
   vs numpy f64 on a slice, the screen Gram under every
   ``configs.matmul_precision`` vs numpy f64; each kernel also timed
   against the XLA version it replaces;
2. dense gaussian lasso path (n=40,000, p=2,000, 100 lambdas) through
   ``ad.grpnet``, gated by an f64 KKT certificate over the whole path;
3. in-memory GWAS SNP path (n=50,000, p=200,000 packed, 50 lambdas),
   gated by an f64 KKT check at every lambda on all active SNPs plus a
   seeded sample of inactive ones;
4. grouped binomial path (n=20,000, p=1,000, groups of 5, 30 lambdas),
   gated by an f64 GLM KKT certificate.

Phases 2 and 3 also time the fit with ``configs.kernels="xla"``: the
in-fit A/B of the hand kernels.  Data are made from ``--seed``.  The last
line of standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = dict(pin_S=(1024, 4096), snp=(200_000, 50_000), slice=4096,
            gram=(50_000, 1024), dense=(40_000, 2_000, 100),
            gwas=(50_000, 200_000, 50), binom=(20_000, 1_000, 5, 30),
            inactive_sample=4096)
SMALL = dict(pin_S=(64, 128), snp=(3_000, 1_001), slice=512,
             gram=(2_000, 128), dense=(800, 64, 10),
             gwas=(1_000, 3_000, 10), binom=(600, 50, 5, 8),
             inactive_sample=512)

# f64 KKT gates (relative to lambda * penalty), no looser than the 1e-3
# relative objective gate the benchmark has always used
KKT_GATE = 1e-3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def median_time(fn, reps=5):
    """Median wall time of ``fn`` after one warm-up call; each call ends in
    ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def set_kernels(mode):
    """Flip configs.kernels; it is read at trace time, so drop traces."""
    import jax

    from adelie_tpu.configs import set_configs

    set_configs("kernels", mode)
    jax.clear_caches()


def device_event_times(fn, top=6):
    """Run ``fn`` once under the JAX profiler and return the ``top`` device
    events of the window by total time: [(name, count, total_us)].  The
    trace goes to ``<checkout>/.bench_data/trace``."""
    import collections
    import glob
    import shutil

    import jax

    d = os.path.join(HERE, ".bench_data", "trace")
    shutil.rmtree(d, ignore_errors=True)
    jax.block_until_ready(fn())
    with jax.profiler.trace(d):
        jax.block_until_ready(fn())
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    tot = collections.defaultdict(lambda: [0, 0.0])
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name and "stream" not in line.name:
                continue
            for ev in line.events:
                tot[ev.name][0] += 1
                tot[ev.name][1] += ev.duration_ns / 1e3
    return sorted(((k, c, us) for k, (c, us) in tot.items()),
                  key=lambda r: -r[2])[:top]


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"


def group_kkt(G, B, lmdas, groups, sizes, pen, alpha=1.0, scale=None):
    """Worst KKT violation over a path, f64.  ``G`` (L, p) holds the
    negative loss gradients, ``B`` (L, p) the coefficients.  Active groups
    must satisfy g_g - (1-a) l pen b_g = l a pen b_g/||b_g||, inactive
    ones ||g_g|| <= l a pen.  Each violation is divided by
    ``scale * a * pen`` (default: by ``l * a * pen``, i.e. relative to the
    lambda at which it is measured)."""
    worst = 0.0
    for i, lm in enumerate(lmdas):
        for st, sz, pg in zip(groups, sizes, pen):
            b = B[i, st:st + sz]
            g = G[i, st:st + sz] - (1 - alpha) * lm * pg * b
            bound = lm * alpha * pg
            nb = np.linalg.norm(b)
            if nb > 0:
                viol = np.linalg.norm(g - bound * b / nb)
            else:
                viol = max(np.linalg.norm(g) - bound, 0.0)
            worst = max(worst, viol / ((scale or lm) * alpha * pg))
    return float(worst)


# --------------------------------------------------------------------------- #
# phase 0                                                                      #
# --------------------------------------------------------------------------- #


def phase0(args, want):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(0, f"jax {jax.__version__}: {len(devs)} x {d0.platform} "
           f"'{d0.device_kind}'")
    log(0, f"card (name, power.limit): {card_line()}")
    log(0, f"compile cache: {jax.config.jax_compilation_cache_dir}")
    log(0, f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    if not args.small and d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {d0.platform} devices")
    if len(devs) < want:
        raise SystemExit(f"need {want} devices, JAX found {len(devs)}")
    return d0


# --------------------------------------------------------------------------- #
# phase 1: kernels against plain references                                    #
# --------------------------------------------------------------------------- #


def pin_problem(S, seed):
    import jax
    import jax.numpy as jnp

    from adelie_tpu.solver.pin import screen_eigh

    hi = jax.lax.Precision.HIGHEST
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    n = 2 * S
    X = jax.random.normal(k1, (n, S), jnp.float32)
    y = X[:, :16].sum(axis=1) + jax.random.normal(k2, (n,), jnp.float32)
    A = jnp.matmul(X.T, X, precision=hi) / n
    grad = jnp.matmul(X.T, y, precision=hi) / n
    sb = jnp.arange(S, dtype=jnp.int32)
    ss = jnp.ones(S, jnp.int32).at[-3:].set(0)    # trailing invalid slots
    ev, evec = screen_eigh(A, sb, ss, 1)
    lmda = 0.05 * jnp.max(jnp.abs(grad))
    return A, grad, sb, ss, ev, evec, lmda


def phase1_pin(sz, kmode, seed):
    import jax.numpy as jnp

    from adelie_tpu.solver.pin import pin_cov_solve

    f = jnp.float32
    out = {}
    for S in sz["pin_S"]:
        A, grad, sb, ss, ev, evec, lmda = pin_problem(S, seed + S)
        # arguments built once: the timings are of the solve, not of
        # eager argument construction
        args = (A, grad, jnp.zeros(S, f), sb, ss, ev, evec, jnp.ones(S, f),
                jnp.zeros(S, bool), lmda, f(1.0), f(1e-7), f(1e-12),
                f(1e-12), jnp.int32(1000), jnp.int32(100000), f(0.0))

        def solve():
            return pin_cov_solve(*args)

        res = {}
        for mode in (kmode, "xla"):
            set_kernels(mode)
            t, _ = median_time(solve)
            res[mode] = (solve(), t)
        set_kernels(kmode)
        (bk, gk, ak, rk, ik, dk), tk = res[kmode]
        (bx, gx, ax, rx, ix, dx), tx = res["xla"]
        scale = max(1.0, float(jnp.max(jnp.abs(bx))))
        err = float(jnp.max(jnp.abs(bk - bx)))
        tol = 1e-3 * scale
        log(1, f"pin S={S}: kernel[{kmode}] {tk * 1e3:.3f} ms "
               f"(iters {int(ik)}, done {bool(dk)}) vs XLA loop "
               f"{tx * 1e3:.3f} ms (iters {int(ix)}, done {bool(dx)}); "
               f"speedup {tx / tk:.1f}x; nnz {int(jnp.sum(bk != 0))}")
        log(1, f"pin S={S}: max|beta_k - beta_xla| = {err:.3e} "
               f"(tol {tol:.1e}: both stop at max a_kk d^2 < tol=1e-7, "
               f"i.e. moves below ~3e-4; f32, no matmuls)")
        assert bool(dk) and bool(dx), "pin solve did not converge"
        assert err <= tol, f"pin kernel off the XLA loop: {err}"
        if kmode != "interpret":
            for name, cnt, us in device_event_times(solve):
                log(1, f"pin S={S} device trace: {name[:60]} x{cnt} "
                       f"{us:.1f} us")
        out[S] = (tk, tx)
    return out


def plain_snp_mul(packed, u, impute, n, na, CH=2048):
    """Plain XLA reference: decode CH-SNP blocks, HIGHEST contraction."""
    import jax
    import jax.numpy as jnp

    p, nb = packed.shape
    nc = -(-p // CH)
    pk = jnp.pad(packed, ((0, nc * CH - p), (0, 0))).reshape(nc, CH, nb)
    im = jnp.pad(impute, (0, nc * CH - p)).reshape(nc, CH)
    shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)

    def one(args):
        rows, imp = args
        c = ((rows[:, :, None] >> shifts) & 3).reshape(CH, 4 * nb)[:, :n]
        c = c.astype(jnp.float32)
        if na:
            c = jnp.where(c == 3.0, imp[:, None], c)
        return jnp.einsum("kn,n->k", c, u,
                          precision=jax.lax.Precision.HIGHEST)

    return jax.lax.map(one, (pk, im)).reshape(-1)[:p]


def phase1_snp(sz, kmode, seed, peaks):
    import jax
    import jax.numpy as jnp

    from adelie_tpu.matrix._snp import unpack_2bit_np
    from adelie_tpu.matrix._snp_triton import snp_mul

    p, n = sz["snp"]
    nb = (n + 3) // 4
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    packed = jax.random.bits(k1, (p, nb), jnp.uint8)
    if n % 4:
        packed = packed.at[:, -1].set(packed[:, -1] & ((1 << 2 * (n % 4)) - 1))
    impute = jax.random.uniform(k2, (p,), jnp.float32, 0.0, 2.0)
    u = jax.random.normal(k3, (n,), jnp.float32)
    interpret = kmode == "interpret"
    sl = sz["slice"]
    host_codes = unpack_2bit_np(np.asarray(packed[:sl]), n).astype(np.float64)
    out = {}
    for na in (True, False):
        imp = impute if na else None
        kern = jax.jit(lambda pk, uu, im: snp_mul(pk, uu, im,
                                                  interpret=interpret))
        ref = jax.jit(lambda pk, uu, im: plain_snp_mul(
            pk, uu, im if na else jnp.zeros((p,), jnp.float32), n, na))
        tk, _ = median_time(lambda: kern(packed, u, imp))
        tx, _ = median_time(lambda: ref(packed, u, impute))
        gk = np.asarray(kern(packed, u, imp), np.float64)
        gx = np.asarray(ref(packed, u, impute), np.float64)
        scale = np.max(np.abs(gx))
        err_x = np.max(np.abs(gk - gx)) / scale
        dense = host_codes
        if na:
            dense = np.where(host_codes == 3, np.asarray(impute[:sl],
                                                         np.float64)[:, None],
                             host_codes)
        g64 = dense @ np.asarray(u, np.float64)
        err_64 = np.max(np.abs(gk[:sl] - g64)) / np.max(np.abs(g64))
        err_x64 = np.max(np.abs(gx[:sl] - g64)) / np.max(np.abs(g64))
        name = "NA" if na else "no-NA"
        gbps = p * nb / tk / 1e9
        roof = (f", {100 * gbps / peaks['hbm_gbps']:.1f}% of the "
                f"{peaks['hbm_gbps']:.0f} GB/s peak" if peaks else "")
        log(1, f"snp {name} p={p} n={n}: kernel[{kmode}] {tk * 1e3:.3f} ms "
               f"({gbps:.1f} packed GB/s{roof}) vs plain XLA "
               f"{tx * 1e3:.3f} ms; speedup {tx / tk:.1f}x")
        log(1, f"snp {name}: max rel err vs plain XLA {err_x:.2e}, "
               f"vs numpy f64 on {sl} SNPs {err_64:.2e} (XLA: {err_x64:.2e}); "
               f"tol 1e-5 of max|g|: f32 sums over n={n} samples in "
               f"another order, ~sqrt(n)*eps relative")
        assert err_x <= 1e-5 and err_64 <= 1e-5, "SNP kernel error"
        if kmode != "interpret":
            for ev, cnt, us in device_event_times(
                    lambda: kern(packed, u, imp), top=3):
                log(1, f"snp {name} device trace: {ev[:60]} x{cnt} "
                       f"{us:.1f} us")
        out[name] = (tk, tx)
    return out


GRAM_TOL = {"highest": 1e-5, "float32": 1e-5, "x3": 5e-4, "default": 1e-2}
GRAM_WHY = {"highest": "f32 products, f32 sums over n",
            "float32": "same as highest",
            "x3": "three bf16 passes (hi*hi + hi*lo + lo*hi): ~2^-13 "
                  "relative per entry",
            "default": "TF32 products (10-bit mantissa) allowed"}


def phase1_gram(sz, seed):
    import jax
    import jax.numpy as jnp

    from adelie_tpu.configs import set_configs
    from adelie_tpu.solver.pin import screen_gram

    n, S = sz["gram"]
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, S)).astype(np.float32)
    w64 = np.full(n, 1.0 / n)
    X64 = X.astype(np.float64)
    m64 = X64.T @ w64
    A64 = X64.T @ (X64 * w64[:, None]) - np.outer(m64, m64)
    Xd = jnp.asarray(X)
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    scale = np.max(np.abs(A64))
    out = {}
    try:
        for prec in GRAM_TOL:
            set_configs("matmul_precision", prec)
            jax.clear_caches()
            t, _ = median_time(lambda: screen_gram(Xd, w, True)[0])
            A = np.asarray(screen_gram(Xd, w, True)[0], np.float64)
            err = np.max(np.abs(A - A64))
            rel = err / scale
            tf = 2.0 * n * S * S / t / 1e12
            log(1, f"gram n={n} S={S} precision={prec}: {t * 1e3:.3f} ms "
                   f"({tf:.2f} TF/s); max abs err {err:.2e}, rel to "
                   f"max|A| {rel:.2e} (tol {GRAM_TOL[prec]:.0e}: "
                   f"{GRAM_WHY[prec]})")
            assert rel <= GRAM_TOL[prec], f"gram {prec}: {rel}"
            out[prec] = (t, rel)
    finally:
        set_configs("matmul_precision", None)
        jax.clear_caches()
    return out


def phase1_vmap(kmode, seed):
    """The pin kernel under vmap (the fold-batched CV path) vs per-fold."""
    import jax
    import jax.numpy as jnp

    from adelie_tpu.solver.pin_triton import pin_lasso_solve

    f = jnp.float32
    S = 256
    probs = [pin_problem(S, seed + 7 + k) for k in range(2)]
    A, grad, _, ss, ev, _, lmda = [jnp.stack(x) for x in zip(*probs)]

    def one(A, grad, ev, valid, lm):
        return pin_lasso_solve(
            A, grad, jnp.zeros(S, f), ev[:, 0], valid, jnp.zeros(S, bool),
            jnp.ones(S, f), lm, f(0.0), f(1e-7), f(1e-6), f(1e5), f(0.0),
            interpret=kmode == "interpret")

    batched = jax.jit(jax.vmap(one))(A, grad, ev, ss > 0, lmda)
    err = max(float(jnp.max(jnp.abs(
        batched[0][k] - jax.jit(one)(A[k], grad[k], ev[k], ss[k] > 0,
                                     lmda[k])[0]))) for k in range(2))
    log(1, f"pin kernel under vmap (2 folds, S={S}): max|diff| vs "
           f"per-fold {err:.2e} (tol 1e-6: same program per fold)")
    assert err <= 1e-6


# --------------------------------------------------------------------------- #
# phases 2-4: grpnet paths                                                     #
# --------------------------------------------------------------------------- #


def timed_fits(fit, label, phase, warm_reps=2):
    t0 = time.perf_counter()
    st = fit()
    cold = time.perf_counter() - t0
    warms = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        st = fit()
        warms.append(time.perf_counter() - t0)
    log(phase, f"{label}: cold {cold:.3f} s, warm "
               f"{', '.join(f'{w:.3f}' for w in warms)} s")
    assert st.error == "", st.error
    return st, cold, min(warms)


def xla_ab(fit, st_k, warm_k, phase, kmode):
    """The same fit with configs.kernels="xla": compile, then one warm."""
    set_kernels("xla")
    try:
        st_x, _, warm_x = timed_fits(fit, "same fit, kernels=xla", phase, 1)
    finally:
        set_kernels(kmode)
    Bk = np.asarray(st_k.betas.todense())
    Bx = np.asarray(st_x.betas.todense())
    L = min(len(Bk), len(Bx))
    diff = float(np.max(np.abs(Bk[:L] - Bx[:L])))
    log(phase, f"in-fit A/B: kernels warm {warm_k:.3f} s vs xla warm "
               f"{warm_x:.3f} s ({warm_x / warm_k:.2f}x); max|B_k - B_xla| "
               f"{diff:.2e} over {L} lambdas")
    return warm_x


def phase2(sz, kmode, seed):
    import adelie_tpu as ad
    from benchmark.bench_baseline import kkt_certificate
    from benchmark.workloads import dense_lasso

    n, p, L = sz["dense"]
    X, y = dense_lasso(n, p, seed=seed)
    Xm = ad.matrix.dense(X)
    glm = ad.glm.gaussian(y)
    kw = dict(lmda_path_size=L, min_ratio=1e-2, intercept=False,
              progress_bar=False, early_exit=False)

    def fit():
        return ad.grpnet(Xm, glm, **kw)

    st, cold, warm = timed_fits(fit, f"dense lasso n={n} p={p} {L} lambdas",
                                2)
    kkt = kkt_certificate(
        X.astype(np.float64), y.astype(np.float64), np.full(n, 1.0 / n),
        [st.betas[i] for i in range(st.betas.shape[0])], st.intercepts,
        st.lmdas, np.arange(p), np.ones(p, int), np.ones(p))
    upd = int(np.sum(st.benchmark.get("cd_updates", [])))
    log(2, f"{len(st.lmdas)} lambdas, {upd} CD updates; f64 KKT "
           f"certificate {kkt:.3e} (gate {KKT_GATE:.0e})")
    assert len(st.lmdas) == L and kkt <= KKT_GATE
    warm_x = xla_ab(fit, st, warm, 2, kmode)
    return dict(cold=cold, warm=warm, warm_xla=warm_x, kkt=kkt)


def gwas_kkt(io, y, st, n_sample, seed):
    """f64 KKT at every lambda over every SNP active anywhere on the path
    plus a seeded sample of the others, decoded on the host in chunks."""
    from adelie_tpu.matrix._snp import unpack_2bit_np

    B = st.betas.tocsc()
    n = io.rows()
    p = io.snps()
    act = np.unique(B.nonzero()[1])
    rng = np.random.default_rng(seed)
    rest = np.setdiff1d(np.arange(p), act)
    cols = np.concatenate([act, rng.choice(rest, min(n_sample, len(rest)),
                                           replace=False)])
    w = 1.0 / n
    Xa = unpack_2bit_np(io.packed[act], n).astype(np.float64)    # (k, n)
    R = (np.asarray(y, np.float64)[:, None]
         - Xa.T @ B[:, act].toarray().T - np.asarray(st.intercepts)[None, :])
    G = np.empty((len(cols), R.shape[1]))
    for s in range(0, len(cols), 512):
        C = unpack_2bit_np(io.packed[cols[s:s + 512]], n).astype(np.float64)
        G[s:s + 512] = C @ (w * R)
    Bc = B[:, cols].toarray()
    k = len(cols)
    kkt = group_kkt(G.T, Bc, np.asarray(st.lmdas), np.arange(k),
                    np.ones(k, int), np.ones(k))
    return kkt, len(act), k


def phase3(sz, kmode, seed, n_sample):
    import adelie_tpu as ad
    from benchmark.workloads import gwas

    n, p, L = sz["gwas"]
    t0 = time.perf_counter()
    io, y, causal = gwas(n, p, seed=seed + 7)
    Xm = ad.matrix.snp_unphased(io, dtype=np.float32)
    assert not getattr(Xm, "is_streaming", False), "expected in-memory"
    glm = ad.glm.gaussian(y, dtype=np.float32)
    log(3, f"GWAS panel n={n} p={p} ({p * io.packed.shape[1] / 1e9:.2f} GB "
           f"packed) made and placed in {time.perf_counter() - t0:.1f} s")
    kw = dict(lmda_path_size=L, min_ratio=5e-2, progress_bar=False)

    def fit():
        return ad.grpnet(Xm, glm, **kw)

    st, cold, warm = timed_fits(fit, f"GWAS path {L} lambdas", 3)
    t0 = time.perf_counter()
    kkt, n_act, k = gwas_kkt(io, y, st, n_sample, seed)
    hits = len(set(np.unique(st.betas.nonzero()[1])) & set(causal.tolist()))
    log(3, f"{len(st.lmdas)} lambdas, {n_act} SNPs ever active "
           f"({hits}/{len(causal)} causal), dev {float(st.devs[-1]):.3f}; "
           f"f64 KKT on {k} SNPs at every lambda {kkt:.3e} "
           f"(gate {KKT_GATE:.0e}; check took "
           f"{time.perf_counter() - t0:.1f} s)")
    assert kkt <= KKT_GATE
    warm_x = xla_ab(fit, st, warm, 3, kmode)
    return dict(cold=cold, warm=warm, warm_xla=warm_x, kkt=kkt)


def phase4(sz, seed):
    import adelie_tpu as ad
    from benchmark.workloads import grouped_binomial

    n, p, q, L = sz["binom"]
    X, y, groups = grouped_binomial(n, p, q, seed=seed + 3)
    Xm = ad.matrix.dense(X)

    def fit():
        return ad.grpnet(Xm, ad.glm.binomial(y), groups=groups,
                         lmda_path_size=L, progress_bar=False)

    # one warm fit: the grouped (q > 1) sweep is an XLA loop, minutes a fit
    st, cold, warm = timed_fits(
        fit, f"grouped binomial n={n} p={p} groups of {q}, {L} lambdas", 4,
        warm_reps=1)
    X64 = X.astype(np.float64)
    B = np.asarray(st.betas.todense(), np.float64)
    eta = X64 @ B.T + np.asarray(st.intercepts)[None, :]
    mu = 1.0 / (1.0 + np.exp(-eta))
    G = ((y[:, None] - mu) / n).T @ X64                  # (L, p)
    sizes = np.full(len(groups), q)
    lmdas = np.asarray(st.lmdas)
    kkt_rel = group_kkt(G, B, lmdas, groups, sizes, np.sqrt(sizes))
    kkt = group_kkt(G, B, lmdas, groups, sizes, np.sqrt(sizes),
                    scale=lmdas[0])
    log(4, f"{len(st.lmdas)} lambdas, dev {float(st.devs[-1]):.3f}; f64 GLM "
           f"KKT certificate {kkt:.3e} relative to lambda_max * pen "
           f"(gate {KKT_GATE:.0e}); {kkt_rel:.3e} relative to each lambda. "
           f"The IRLS/CD stopping rules (tol 1e-7 on coordinate moves) "
           f"bound stationarity absolutely, so near lambda_min the "
           f"lambda-relative value is the solver's, in f64 as well")
    assert kkt <= KKT_GATE
    return dict(cold=cold, warm=warm, kkt=kkt)


# --------------------------------------------------------------------------- #
# --four-gpus: the two mesh fits                                               #
# --------------------------------------------------------------------------- #


def four_gpus(sz, seed):
    import jax
    from jax.sharding import Mesh

    import adelie_tpu as ad
    from adelie_tpu import parallel
    from benchmark.bench_baseline import kkt_certificate
    from benchmark.workloads import dense_lasso, gwas

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("n",))

    def compare(label, st1, st4, t1, t4):
        B1 = np.asarray(st1.betas.todense())
        B4 = np.asarray(st4.betas.todense())
        assert B1.shape == B4.shape, (B1.shape, B4.shape)
        diff = float(np.max(np.abs(B1 - B4)))
        tol = 1e-3 * max(1.0, float(np.max(np.abs(B1))))
        log("4", f"{label}: 1 card warm {t1:.3f} s, 4 cards warm {t4:.3f} s;"
                 f" max|B_1 - B_4| {diff:.2e} (tol {tol:.1e}: f32 sums in "
                 f"another order, solver tol 1e-7)")
        assert diff <= tol

    n, p, L = sz["dense"]
    X, y = dense_lasso(n, p, seed=seed)
    kw = dict(lmda_path_size=L, min_ratio=1e-2, intercept=False,
              progress_bar=False, early_exit=False)
    st1, _, t1 = timed_fits(lambda: ad.grpnet(ad.matrix.dense(X),
                                              ad.glm.gaussian(y), **kw),
                            "dense lasso, 1 card", "4", 1)
    with parallel.use_mesh(mesh):
        Xm4 = ad.matrix.dense(X)
    st4, _, t4 = timed_fits(lambda: ad.grpnet(Xm4, ad.glm.gaussian(y), **kw),
                            "dense lasso, n sharded over 4 cards", "4", 1)
    kkt = kkt_certificate(
        X.astype(np.float64), y.astype(np.float64), np.full(n, 1.0 / n),
        [st4.betas[i] for i in range(st4.betas.shape[0])], st4.intercepts,
        st4.lmdas, np.arange(p), np.ones(p, int), np.ones(p))
    log("4", f"dense 4-card f64 KKT certificate {kkt:.3e} "
             f"(gate {KKT_GATE:.0e})")
    assert kkt <= KKT_GATE
    compare("dense lasso", st1, st4, t1, t4)

    n, p, L = sz["gwas"]
    io, yg, _ = gwas(n, p, seed=seed + 7)
    glm = ad.glm.gaussian(yg, dtype=np.float32)
    kw = dict(lmda_path_size=L, min_ratio=5e-2, progress_bar=False)
    Xs1 = ad.matrix.snp_unphased(io, dtype=np.float32)
    st1, _, t1 = timed_fits(lambda: ad.grpnet(Xs1, glm, **kw),
                            "GWAS path, 1 card", "4", 1)
    Xs4 = ad.matrix.snp_unphased(io, dtype=np.float32, mesh=mesh)
    st4, _, t4 = timed_fits(lambda: ad.grpnet(Xs4, glm, **kw),
                            "GWAS path, bytes sharded over 4 cards", "4", 1)
    kkt, _, k = gwas_kkt(io, yg, st4, sz["inactive_sample"], seed)
    log("4", f"GWAS 4-card f64 KKT on {k} SNPs {kkt:.3e} "
             f"(gate {KKT_GATE:.0e})")
    assert kkt <= KKT_GATE
    compare("GWAS path", st1, st4, t1, t4)


# --------------------------------------------------------------------------- #


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="toy sizes on the CPU, kernels in interpret mode")
    ap.add_argument("--four-gpus", action="store_true",
                    help="only the two 4-card mesh fits vs 1 card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    want = 4 if args.four_gpus else 1
    if args.small:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_gpus:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, HERE)
    sys.setrecursionlimit(100000)   # Pallas interpret mode traces deeply

    import jax

    import adelie_tpu  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    d0 = phase0(args, want)
    sz = SMALL if args.small else FULL
    kmode = "interpret" if args.small else "auto"
    set_kernels(kmode)
    from adelie_tpu.configs import configs

    log(0, f"kernels={configs.kernels}, matmul_precision="
           f"{configs.matmul_precision}, x64={jax.config.jax_enable_x64}")

    if args.four_gpus:
        four_gpus(sz, args.seed)
    else:
        from bench import device_peaks

        peaks = None if args.small else device_peaks(d0.device_kind)
        t = time.perf_counter()
        phase1_pin(sz, kmode, args.seed)
        phase1_snp(sz, kmode, args.seed, peaks)
        phase1_gram(sz, args.seed)
        phase1_vmap(kmode, args.seed)
        log(1, f"phase done in {time.perf_counter() - t:.1f} s")
        for ph, fn in ((2, lambda: phase2(sz, kmode, args.seed)),
                       (3, lambda: phase3(sz, kmode, args.seed,
                                          sz["inactive_sample"])),
                       (4, lambda: phase4(sz, args.seed))):
            t = time.perf_counter()
            fn()
            log(ph, f"phase done in {time.perf_counter() - t:.1f} s")

    log("end", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}", flush=True)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
