"""Generate the worked walkthroughs with CAPTURED output.

Each walkthrough is a list of (markdown, code) cells; the code cells run
in one shared namespace per walkthrough and their stdout is captured
into the rendered document — so every number in docs/walkthroughs/*.md
is a real executed result, reference-user-guide style (VERDICT r3 #10).

Run from the repo root (CPU is fine; the GWAS walkthrough notes which
figures come from the GPU runs in PERF.md):

    JAX_PLATFORMS=cpu python docs/walkthroughs/generate.py
"""

import contextlib
import io
import os
import sys
import textwrap
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def run_walkthrough(title, intro, cells, out_name):
    ns = {}
    parts = [f"# {title}\n", intro.strip() + "\n"]
    t0 = time.time()
    for md, code in cells:
        if md:
            parts.append(textwrap.dedent(md).strip() + "\n")
        if code:
            code = textwrap.dedent(code).strip()
            parts.append("```python\n" + code + "\n```\n")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                exec(compile(code, out_name, "exec"), ns)
            out = buf.getvalue().rstrip()
            if out:
                parts.append("```\n" + out + "\n```\n")
    parts.append(
        f"\n*Generated by `docs/walkthroughs/generate.py` "
        f"(all outputs captured from a real run; {time.time()-t0:.0f}s "
        f"on this host).*\n")
    path = os.path.join(HERE, out_name)
    with open(path, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {path}")


# ======================================================================= #
# 1. Dense cross-validated group elastic net                              #
# ======================================================================= #

W1 = [
    ("""
     ## Simulate grouped data

     40 groups of 5 features; 6 groups carry signal.  This mirrors the
     reference user guide's `grpnet` quickstart (reference
     docs/sphinx/user_guide) on the device-native API.
     """,
     """
     import numpy as np
     import adelie_tpu as ad

     rng = np.random.default_rng(0)
     n, G, q = 800, 40, 5
     p = G * q
     X = rng.standard_normal((n, p)).astype(np.float32)
     beta = np.zeros(p, np.float32)
     sig = rng.choice(G, 6, replace=False)
     for g in sig:
         beta[g*q:(g+1)*q] = rng.standard_normal(q)
     y = X @ beta + rng.standard_normal(n).astype(np.float32)
     groups = np.arange(0, p, q)
     print("signal groups:", sorted(sig.tolist()))
     """),
    ("""
     ## Fit the full path

     One call; the solver picks a 100-lambda log path and exits early
     once deviance saturates.
     """,
     """
     state = ad.grpnet(X, ad.glm.gaussian(y), groups=groups,
                       progress_bar=False)
     print("lambdas fitted:", len(state.lmdas))
     print("final deviance explained:", round(float(state.devs[-1]), 4))
     B = np.asarray(state.betas.todense())
     nz_groups = sorted(set(np.nonzero(B[-1])[0] // q))
     print("active groups at the path end:", nz_groups[:12], "...")
     """),
    ("""
     ## Cross-validate

     `cv_grpnet` fits every fold on a common lambda grid; on gaussian
     losses the folds run fold-BATCHED — one fused device program fits
     all K folds at once (see docs/parallelism.md).
     """,
     """
     cv = ad.cv_grpnet(X, ad.glm.gaussian(y), groups=groups, n_folds=5,
                       seed=1, progress_bar=False)
     print("best lambda index:", int(cv.best_idx),
           "of", len(cv.lmdas))
     print("cv loss at best:", round(float(cv.avg_losses[cv.best_idx]), 4))
     refit = cv.fit(X, ad.glm.gaussian(y), groups=groups,
                    progress_bar=False)
     Bb = np.asarray(refit.betas.todense())[-1]
     got = sorted(set(np.nonzero(Bb)[0] // q))
     print("recovered signal groups:", got)
     print("true signal groups:     ", sorted(sig.tolist()))
     """),
    ("""
     ## Diagnostics

     The diagnostic surface mirrors the reference: coefficient paths,
     deviance curves, CV loss bands (`ad.diagnostic.plot_*`); each
     returns a matplotlib figure.
     """,
     """
     dg = ad.diagnostic.diagnostic(refit)
     print(type(dg).__name__, "with residuals/gradients per lambda")
     """),
]


# ======================================================================= #
# 2. GWAS: PLINK .bed -> streamed SNP group lasso                          #
# ======================================================================= #

W2 = [
    ("""
     ## Write a PLINK-shaped dataset and convert to `.snpdat`

     The reference workflow (examples.ipynb): read `.bed`, convert per
     chromosome to the packed `.snpdat` codec, concatenate
     `[covariates | SNPs]` with zero penalty on covariates.  Here we
     synthesize a small cohort; the full-scale numbers are in PERF.md
     (`chip_smoke.py` phase 3).
     """,
     """
     import os
     import tempfile

     import numpy as np
     import adelie_tpu as ad

     rng = np.random.default_rng(7)
     n, p = 500, 4000
     maf = rng.uniform(0.05, 0.5, p)
     dosages = (rng.uniform(size=(n, p)) < maf).astype(np.int8) + \\
               (rng.uniform(size=(n, p)) < maf).astype(np.int8)
     dosages[rng.uniform(size=(n, p)) < 0.002] = -9   # missing

     work = tempfile.mkdtemp()
     f = os.path.join(work, "chr1.snpdat")
     ad.io.snp_unphased(f).write(dosages)
     io1 = ad.io.snp_unphased(f).read()
     print("snpdat:", io1.snps(), "SNPs x", io1.rows(), "samples,",
           round(os.path.getsize(f) / 1e6, 2), "MB packed")
     """),
    ("""
     ## Build the matrix and fit

     `snp_unphased` keeps the 2-bit packing on device and decodes inside
     a fused decode-matvec kernel on the GPU.  Above
     `configs.snp_hbm_budget` (half the device memory JAX may use) the
     factory automatically switches to the HOST-STREAMING matrix: packed
     bytes stay in host RAM and full-p products sweep 64K-SNP tiles through
     the device (`streaming="auto"`).
     """,
     """
     covars = rng.standard_normal((n, 3)).astype(np.float32)
     X = ad.matrix.concatenate(
         [ad.matrix.dense(covars),
          ad.matrix.snp_unphased(io1, dtype=np.float32)], axis=1)
     sig = rng.choice(p, 15, replace=False)
     yg = (np.where(dosages[:, sig] < 0, 0, dosages[:, sig])
           @ rng.standard_normal(15) + rng.standard_normal(n)) \\
         .astype(np.float32)
     penalty = np.r_[np.zeros(3), np.ones(p)]
     st = ad.grpnet(X, ad.glm.gaussian(yg), penalty=penalty,
                    progress_bar=False)
     print("lambdas:", len(st.lmdas),
           "| final dev:", round(float(st.devs[-1]), 3),
           "| nnz:", int(st.betas[-1].nnz))
     hits = len(set(np.asarray(st.betas[-1].tocoo().col - 3)) &
                set(sig.tolist()))
     print("causal SNPs recovered in final active set:",
           hits, "/", len(sig))
     """),
    ("""
     ## Forcing the streamed path

     `streaming=True` forces the host-streaming matrix at any size —
     used here to show the API; the fit matches the in-HBM path at
     solver tolerance (pinned to 1e-9 in tests/test_snp_stream.py).

     At full GWAS scale (p=200k x n=50k, 2.5 GB packed) the path runs
     device-resident on one H100; its cold and warm times are in PERF.md.
     """,
     """
     Xs = ad.matrix.snp_unphased(io1, streaming=True, dtype=np.float32)
     st2 = ad.grpnet(Xs, ad.glm.gaussian(yg), progress_bar=False)
     B1 = np.asarray(st.betas.todense())[:, 3:]
     B2 = np.asarray(st2.betas.todense())
     k = min(len(B1), len(B2))
     print("streamed vs in-HBM max |diff|:",
           float(np.abs(B1[:k] - B2[:k]).max()))
     print("streamed full passes over packed bytes:", Xs.sweeps)
     """),
]


# ======================================================================= #
# 3. Constrained GLMs                                                      #
# ======================================================================= #

W3 = [
    ("""
     ## Box-constrained logistic group elastic net

     Constraints attach per GROUP; each solve runs the dual proximal
     Newton method inside the fused IRLS chunk program (reference
     parity: `constraint_box`, method="proximal_newton").
     """,
     """
     import numpy as np
     import adelie_tpu as ad
     from adelie_tpu import constraint as ct

     rng = np.random.default_rng(3)
     n, G, q = 600, 20, 3
     p = G * q
     X = rng.standard_normal((n, p)).astype(np.float32)
     eta = X[:, :6] @ rng.standard_normal(6)
     y = (eta + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
     groups = np.arange(0, p, q)
     cons = [ct.box(np.full(q, -0.2), np.full(q, 0.2)) for _ in groups]
     st = ad.grpnet(X, ad.glm.binomial(y), groups=groups,
                    constraints=cons, lmda_path_size=20, min_ratio=0.05,
                    progress_bar=False)
     B = np.asarray(st.betas.todense())
     print("lambdas:", len(st.lmdas),
           "| max |beta| =", round(float(np.abs(B).max()), 4),
           "(box at 0.2)")
     print("binding at path end:",
           int((np.abs(B[-1]) > 0.2 - 1e-4).sum()), "coordinates")
     """),
    ("""
     ## Duals and constraint types

     Every solution records the active dual variables per constrained
     group (`state.duals`).  `lower/upper/one_sided/linear` cover the
     reference's constraint classes; `linear` takes a general matrix
     with two-sided bounds.
     """,
     """
     d_last = st.duals[-1]
     nz_duals = {g: np.round(mu, 3).tolist()
                 for g, mu in list(d_last.items())[:3]}
     print("sample of active duals at the last lambda:", nz_duals)

     A = np.array([[1.0, 1.0, 1.0]])       # sum of the group's betas
     lin = [ct.linear(A, np.array([-0.1]), np.array([0.1]))
            for _ in groups]
     st_lin = ad.grpnet(X, ad.glm.binomial(y), groups=groups,
                        constraints=lin, lmda_path_size=10,
                        min_ratio=0.1, progress_bar=False)
     Bl = np.asarray(st_lin.betas.todense())[-1].reshape(G, q)
     print("max |group sum| =", round(float(np.abs(Bl.sum(1)).max()), 4),
           "(linear bound at 0.1)")
     """),
    ("""
     ## Certifying against an independent solver

     `tests/oracle_constrained.py` re-solves the same problems with
     scipy's trust-constr interior-point method (no shared code) — the
     test suite checks every constraint type x {gaussian, logistic}
     against it (tests/test_constrained_oracle.py).
     """,
     """
     import sys, os
     sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
     from oracle_constrained import solve_constrained_oracle

     w = np.full(n, 1.0 / n)
     lmda = float(st.lmdas[-1])
     specs = [("box", np.full(q, -0.2), np.full(q, 0.2))
              for _ in range(G)]
     beta_o, b0_o = solve_constrained_oracle(
         X.astype(np.float64), y.astype(np.float64), w, lmda, 1.0,
         np.sqrt(np.full(G, q, float)), groups, np.full(G, q, int),
         specs, loss="logistic")
     print("max |ours - trust-constr oracle| =",
           float(np.abs(B[-1] - beta_o).max()))
     """),
]


# ======================================================================= #
# 4. Multi-host scenario parallelism                                       #
# ======================================================================= #

W4 = [
    ("""
     ## The model

     Within one host, a `Mesh` shards the observation axis over local
     chips (`parallel.use_mesh`).  ACROSS hosts, independent scenarios —
     CV folds, phenotypes, bootstrap replicates — stripe round-robin via
     `scenario_map`, and results exchange in ONE packed DCN all-gather
     at the end.  This walkthrough simulates the striping single-process
     (the two-OS-process path runs in tests/test_distributed.py).
     """,
     """
     import numpy as np
     import adelie_tpu as ad
     from adelie_tpu import parallel

     rng = np.random.default_rng(5)
     n, p = 400, 60
     X = rng.standard_normal((n, p)).astype(np.float32)
     Ys = [(X[:, k] + 0.5 * rng.standard_normal(n)).astype(np.float32)
           for k in range(6)]           # 6 phenotypes = 6 scenarios

     def fit_phenotype(y):
         st = ad.grpnet(X, ad.glm.gaussian(y), lmda_path_size=15,
                        min_ratio=0.05, progress_bar=False)
         B = np.asarray(st.betas.todense())[-1]
         return {"nnz": np.int64((B != 0).sum()),
                 "dev": np.float64(st.devs[-1])}

     # simulate host 0 of a 2-host grid: it computes scenarios 0,2,4
     mine = parallel.scenario_map(fit_phenotype, Ys, n_shards=2,
                                  shard_index=0, gather=False)
     print("host 0 computed:",
           [i for i, r in enumerate(mine) if r is not None])
     print("results:", [(int(r["nnz"]), round(float(r["dev"]), 3))
                        for r in mine if r is not None])
     """),
    ("""
     ## Real two-process run

     With two OS processes joined through `parallel.distributed_init`
     (jax.distributed over DCN), the same `scenario_map(...)` call with
     `gather=True` (default) returns EVERY scenario's result on EVERY
     host after one packed all-gather.  The repository test spawns two
     processes through a gloo coordinator and asserts exactly that:
     """,
     """
     print(open("tests/_distributed_worker.py").read()
           .split('# -- scenario_map')[1].split('# -- global-mesh')[0])
     """),
    ("""
     ## Sharding within a host

     `use_mesh` makes every subsequent fit shard its observation axis
     over the mesh; on real hardware the mesh spans the slice's chips
     and XLA inserts the psum collectives.
     """,
     """
     import jax

     if len(jax.devices()) > 1:
         with parallel.use_mesh(parallel.make_mesh()):
             st = ad.grpnet(X, ad.glm.gaussian(Ys[0]),
                            lmda_path_size=10, progress_bar=False)
         print("sharded fit ok:", st.error == "", len(st.lmdas),
               "lambdas on", len(jax.devices()), "devices")
     else:
         print("single device here; see tests/test_mesh.py for the "
               "8-device CPU-mesh equality suite")
     """),
]


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.dirname(HERE)))
    run_walkthrough(
        "Walkthrough: cross-validated group elastic net (dense)",
        "End-to-end dense workflow: simulate -> fit path -> CV -> refit "
        "-> diagnostics.  Mirrors the reference quickstart notebook.",
        W1, "dense_cv.md")
    run_walkthrough(
        "Walkthrough: GWAS — PLINK to streamed SNP group lasso",
        "The flagship workload: PLINK-shaped data through the `.snpdat` "
        "codec into the packed SNP matrix, with the host-streaming path "
        "that runs panels larger than device memory.",
        W2, "gwas_streamed.md")
    run_walkthrough(
        "Walkthrough: constrained GLMs",
        "Per-group box / linear constraints inside the IRLS path, dual "
        "export, and certification against an independent interior-point "
        "oracle.",
        W3, "constrained_glm.md")
    run_walkthrough(
        "Walkthrough: multi-host scenario parallelism",
        "Striping independent fits across hosts with one packed DCN "
        "gather, plus within-host mesh sharding.",
        W4, "multihost_scenarios.md")
