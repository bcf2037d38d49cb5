"""Multi-device mesh tests on the 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — keeps the driver's
dryrun_multichip contract green."""

import sys

import numpy as np
import pytest
import jax


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache():
    """Disable the persistent compile cache for this module.

    Full-suite runs segfaulted (3x, deterministically) inside the
    compilation cache's executable (de)serialization — zstd compress in
    ``put_executable_and_time`` / the matching read — on exactly the
    8-device SPMD grpnet chunk program, once enough process state had
    accumulated.  The same test passes in isolation, and the whole
    module passes with the cache off; skipping the cache for these few
    (largest) executables costs a few minutes of recompile on re-runs
    and removes the crash.
    """
    from jax._src import compilation_cache as _cc

    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    # jax memoizes the is-cache-used decision per process; without the
    # reset the config flip is a no-op and executable.serialize() (the
    # crashing call, compilation_cache.py:265) still runs
    _cc.reset_cache()
    # drop every executable the earlier modules compiled: with hundreds
    # of live CPU executables in the process, compiling this module's
    # 8-partition SPMD programs segfaults inside XLA codegen (the crash
    # point floats between backend_compile and executable.serialize,
    # MALLOC_CHECK_ finds nothing — consistent with JIT code-arena
    # exhaustion, not python-level heap corruption)
    jax.clear_caches()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    _cc.reset_cache()


def test_devices_available():
    assert len(jax.devices()) >= 8


def test_dryrun_multichip():
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles():
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    beta = np.asarray(out[0])
    assert np.isfinite(beta).all()


def test_sharded_fit_matches_single_device():
    """The mesh-sharded fit step returns the same solution as unsharded."""
    from jax.sharding import Mesh

    from adelie_tpu.solver.sharded import fit_lambda_step, shard_step_inputs
    import __graft_entry__ as g

    kw = g._example_problem(n=256, p=32, S=16, G=16)
    args = (
        kw["X"], kw["Xs"], kw["resid"], kw["w"], kw["beta_s"],
        kw["is_active"], kw["slot_begin"], kw["slot_size"],
        kw["penalty_slots"], kw["lmda"], kw["alpha"], kw["tol"],
        kw["dbeta_tol"], kw["newton_tol"], kw["newton_max_iters"],
        kw["max_iters"], kw["rsq"], True, 1,
    )
    out_single = fit_lambda_step(*args)
    beta_single = np.asarray(out_single[0])

    devices = jax.devices()[:8]
    mesh = Mesh(np.asarray(devices), ("n",))
    with mesh:
        X, Xs, resid, w = shard_step_inputs(
            mesh, kw["X"], kw["Xs"], kw["resid"], kw["w"]
        )
        out_mesh = fit_lambda_step(
            X, Xs, resid, w, *args[4:]
        )
        jax.block_until_ready(out_mesh)
    beta_mesh = np.asarray(out_mesh[0])
    np.testing.assert_allclose(beta_mesh, beta_single, atol=1e-5)  # f32 reduction-order noise


def test_grpnet_spmd_matches_single_device():
    """grpnet with the matrix row-sharded over the mesh returns identical
    solutions (XLA propagates shardings through the fused chunk steps and
    inserts the collectives)."""
    from jax.sharding import Mesh
    from adelie_tpu import parallel
    import adelie_tpu as ad

    rng = np.random.default_rng(0)
    n, p = 512, 40
    X = rng.standard_normal((n, p))
    y = X[:, :3] @ [1.0, -1.0, 0.5] + 0.1 * rng.standard_normal(n)
    glm = ad.glm.gaussian(y)

    st_ref = ad.grpnet(X, glm, lmda_path_size=8, min_ratio=0.1,
                       progress_bar=False)

    mesh = parallel.make_mesh(8)
    Xm = ad.matrix.dense(X, mesh=mesh)
    st_sh = ad.grpnet(Xm, glm, lmda_path_size=8, min_ratio=0.1,
                      progress_bar=False)
    assert st_sh.error == ""
    B1 = np.asarray(st_ref.betas.todense())
    B2 = np.asarray(st_sh.betas.todense())
    np.testing.assert_allclose(B1, B2, atol=1e-9)

    # GLM (IRLS) path under the mesh
    glmb = ad.glm.binomial((y > 0).astype(float))
    s1 = ad.grpnet(X, glmb, lmda_path_size=5, min_ratio=0.2,
                   progress_bar=False)
    s2 = ad.grpnet(Xm, glmb, lmda_path_size=5, min_ratio=0.2,
                   progress_bar=False)
    np.testing.assert_allclose(
        np.asarray(s1.betas.todense()), np.asarray(s2.betas.todense()),
        atol=1e-8,
    )


def test_snp_grpnet_spmd_matches_single_device(tmp_path):
    """SNP grpnet with the packed byte (observation) axis sharded over the
    mesh returns identical solutions — the device replacement for the
    reference's row-blocked kernels on its flagship GWAS workload
    (VERDICT r1 item #1)."""
    from adelie_tpu import parallel
    import adelie_tpu as ad

    data = ad.data.snp_unphased(300, 64, seed=7)
    f = str(tmp_path / "mesh.snpdat")
    ad.io.snp_unphased(f).write(data["X"])
    io1 = ad.io.snp_unphased(f).read()
    io2 = ad.io.snp_unphased(f).read()

    m1 = ad.matrix.snp_unphased(io1)
    st1 = ad.grpnet(m1, data["glm"], lmda_path_size=8, min_ratio=0.1,
                    progress_bar=False)

    mesh = parallel.make_mesh(8)
    m2 = ad.matrix.snp_unphased(io2, mesh=mesh)
    assert len(m2._packed.sharding.device_set) == 8
    st2 = ad.grpnet(m2, data["glm"], lmda_path_size=8, min_ratio=0.1,
                    progress_bar=False)
    assert st2.error == ""
    B1 = np.asarray(st1.betas.todense())
    B2 = np.asarray(st2.betas.todense())
    assert (B1 != 0).sum() > 0
    np.testing.assert_allclose(B1, B2, atol=1e-9)


def test_snp_phased_grpnet_spmd_matches_single_device(tmp_path):
    from adelie_tpu import parallel
    import adelie_tpu as ad

    data = ad.data.snp_phased_ancestry(240, 20, 3, seed=11)
    f = str(tmp_path / "mesh_phased.snpdat")
    ad.io.snp_phased_ancestry(f).write(data["X"], data["ancestries"], 3)
    io1 = ad.io.snp_phased_ancestry(f).read()
    io2 = ad.io.snp_phased_ancestry(f).read()

    m1 = ad.matrix.snp_phased_ancestry(io1)
    st1 = ad.grpnet(m1, data["glm"], lmda_path_size=6, min_ratio=0.1,
                    progress_bar=False)
    mesh = parallel.make_mesh(8)
    m2 = ad.matrix.snp_phased_ancestry(io2, mesh=mesh)
    st2 = ad.grpnet(m2, data["glm"], lmda_path_size=6, min_ratio=0.1,
                    progress_bar=False)
    assert st2.error == ""
    np.testing.assert_allclose(
        np.asarray(st1.betas.todense()), np.asarray(st2.betas.todense()),
        atol=1e-9,
    )


def test_use_mesh_context():
    from adelie_tpu import parallel
    import adelie_tpu as ad

    rng = np.random.default_rng(1)
    X = rng.standard_normal((256, 10))
    y = X[:, 0] + 0.1 * rng.standard_normal(256)
    mesh = parallel.make_mesh(8)
    with parallel.use_mesh(mesh):
        Xm = ad.matrix.dense(X)
    # the device array is sharded over 8 devices
    assert len(Xm._mat.sharding.device_set) == 8
    st = ad.grpnet(Xm, ad.glm.gaussian(y), lmda_path_size=4,
                   progress_bar=False)
    assert st.error == ""


def test_cv_fold_batch_composes_with_mesh():
    """Fold-batched CV over an n-sharded design returns identical losses
    (fold axis = vmap, observation axis = mesh collectives)."""
    from adelie_tpu import parallel
    import adelie_tpu as ad

    rng = np.random.default_rng(2)
    n, p = 512, 40
    X = rng.standard_normal((n, p))
    y = X[:, :3] @ [1.0, -1.0, 0.5] + 0.2 * rng.standard_normal(n)

    res1 = ad.cv_grpnet(X, ad.glm.gaussian(y), n_folds=4, seed=1,
                        lmda_path_size=15, tol=1e-11)
    mesh = parallel.make_mesh(8)
    Xm = ad.matrix.dense(X, mesh=mesh)
    res2 = ad.cv_grpnet(Xm, ad.glm.gaussian(y), n_folds=4, seed=1,
                        lmda_path_size=15, tol=1e-11)
    np.testing.assert_allclose(res1.losses, res2.losses, rtol=1e-6, atol=1e-9)


def test_scenario_shard_and_map():
    """Scenario batching across hosts (SURVEY §2.12 path/fold batching):
    round-robin striping + single-process map semantics."""
    from adelie_tpu import parallel

    # simulated 3-process grid
    idx0 = parallel.scenario_shard(8, n_shards=3, shard_index=0)
    idx1 = parallel.scenario_shard(8, n_shards=3, shard_index=1)
    idx2 = parallel.scenario_shard(8, n_shards=3, shard_index=2)
    assert idx0 == [0, 3, 6] and idx1 == [1, 4, 7] and idx2 == [2, 5]
    assert sorted(idx0 + idx1 + idx2) == list(range(8))

    # single-process map runs everything
    out = parallel.scenario_map(lambda s: s * s, [1, 2, 3, 4])
    assert out == [1, 4, 9, 16]

    # a simulated shard only computes its stripe
    out1 = parallel.scenario_map(lambda s: s * s, [1, 2, 3, 4],
                                 n_shards=2, shard_index=1, gather=False)
    assert out1 == [None, 4, None, 16]

    # distributed_init is a no-op single-process and reports the grid
    pid, nproc = parallel.distributed_init()
    assert pid == 0 and nproc == 1


def test_scenario_map_cv_folds():
    """Striping cv folds across simulated hosts reproduces the full CV."""
    import adelie_tpu as ad
    from adelie_tpu import parallel

    rng = np.random.default_rng(4)
    n, p = 200, 20
    X = rng.standard_normal((n, p))
    y = X[:, 0] - X[:, 1] + 0.2 * rng.standard_normal(n)

    res = ad.cv_grpnet(X, ad.glm.gaussian(y), n_folds=4, seed=0,
                       lmda_path_size=10, fold_batch=False)

    # each "host" computes a stripe of folds via the same zero-weight rule
    from adelie_tpu.cv import _common_path, _cv_serial, _fold_assignments

    val_sets = _fold_assignments(n, 4, 0)
    lmdas = res.lmdas
    losses = np.zeros((4, len(lmdas)))
    for shard in range(2):
        for k in parallel.scenario_shard(4, n_shards=2, shard_index=shard):
            losses[k] = _cv_serial(
                X, ad.glm.gaussian(y), np.asarray(ad.glm.gaussian(y).weights),
                [val_sets[k]], lmdas, False, 1, {},
            )[0]
    np.testing.assert_allclose(losses, res.losses, atol=1e-9)
