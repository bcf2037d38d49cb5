"""Host-streamed SNP matrix + streamed-KKT gaussian driver.

The streamed path (matrix/_snp_stream.py + solver/streamed.py) is the
out-of-HBM architecture for the 1M-SNP north star; these tests pin it to
the in-HBM path exactly (same decode, same solver math, different
orchestration) on the CPU backend with small tiles forcing multi-tile
sweeps.
"""

import numpy as np
import pytest

import adelie_tpu as ad
from adelie_tpu.configs import configs, set_configs
from adelie_tpu.matrix._snp import unpack_2bit_np


@pytest.fixture(autouse=True)
def _exact_stream_parity():
    """These tests pin streamed == in-HBM bit-for-bit, which requires the
    two drivers to take identical screening decisions — disable the
    speculative violator union (it changes the screen trajectory; its own
    test below re-enables it)."""
    set_configs("stream_speculative_union", False)
    yield
    set_configs("stream_speculative_union", None)


def _make_io(tmp_path, n, p, seed=0, name="s.snpdat"):
    data = ad.data.snp_unphased(n, p, seed=seed)
    f = str(tmp_path / name)
    ad.io.snp_unphased(f).write(data["X"])
    return ad.io.snp_unphased(f).read(), data


def _dense_of(io):
    codes = unpack_2bit_np(np.asarray(io.packed), io.rows()).astype(float)
    return np.where(codes == 3, np.asarray(io.impute)[:, None], codes).T


def test_streamed_matrix_ops(tmp_path):
    io, _ = _make_io(tmp_path, 70, 40)
    m = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16, dtype=np.float64)
    assert m._ntiles == 3
    dense = _dense_of(io)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(70)
    w = rng.uniform(0.1, 1, 70)
    w /= w.sum()
    np.testing.assert_allclose(
        np.asarray(m.mul(v, w)), dense.T @ (w * v), atol=1e-10
    )
    U = rng.standard_normal((5, 70))
    np.testing.assert_allclose(
        np.asarray(m.mul_many(U)), dense.T @ U.T, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(m.sq_mul(w)), (dense ** 2).T @ w, atol=1e-10
    )
    beta = np.zeros(40)
    beta[[1, 17, 39]] = [1.5, -2.0, 0.5]
    np.testing.assert_allclose(
        np.asarray(m.tmul(beta)), dense @ beta, atol=1e-10
    )
    idx = np.asarray([0, 13, 25, 39])
    np.testing.assert_allclose(
        np.asarray(m.gather(idx)), dense[:, idx], atol=1e-12
    )
    with pytest.raises(NotImplementedError):
        m.mul_spec()


def test_streamed_grpnet_matches_inhbm_lasso(tmp_path):
    """Full BASIL (screening forced) streamed vs in-HBM: identical paths."""
    io1, data = _make_io(tmp_path, 300, 96, seed=7)
    io2 = ad.io.snp_unphased(io1.filename).read() if hasattr(io1, "filename") \
        else io1
    try:
        set_configs("screen_all_max", 0)   # force real BASIL screening/KKT
        m_h = ad.matrix.snp_unphased(io1, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, data["glm"], lmda_path_size=12, min_ratio=0.05,
                         progress_bar=False)
        m_s = ad.matrix.snp_unphased(io1, streaming=True, tile_snps=32,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, data["glm"], lmda_path_size=12, min_ratio=0.05,
                         progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    B_h = np.asarray(st_h.betas.todense())
    B_s = np.asarray(st_s.betas.todense())
    assert (B_h != 0).sum() > 0
    assert B_h.shape == B_s.shape
    np.testing.assert_allclose(B_h, B_s, atol=1e-9)
    np.testing.assert_allclose(st_h.intercepts, st_s.intercepts, atol=1e-9)
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-9)


def test_streamed_grpnet_groups_elastic_net(tmp_path):
    """Group elastic net (alpha<1 exercises the l2-adjusted KKT scatter),
    no intercept."""
    io, data = _make_io(tmp_path, 250, 80, seed=13, name="g.snpdat")
    groups = np.arange(0, 80, 4)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, data["glm"], groups=groups, alpha=0.7,
                         intercept=False, lmda_path_size=10, min_ratio=0.05,
                         progress_bar=False)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, data["glm"], groups=groups, alpha=0.7,
                         intercept=False, lmda_path_size=10, min_ratio=0.05,
                         progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    np.testing.assert_allclose(
        np.asarray(st_h.betas.todense()), np.asarray(st_s.betas.todense()),
        atol=1e-9,
    )


def test_streamed_auto_factory(tmp_path):
    from adelie_tpu.matrix._snp import MatrixNaiveSNPUnphased
    from adelie_tpu.matrix._snp_stream import MatrixNaiveSNPUnphasedStreamed

    io, _ = _make_io(tmp_path, 60, 30, seed=1, name="a.snpdat")
    m = ad.matrix.snp_unphased(io)           # auto: tiny -> in-HBM
    assert isinstance(m, MatrixNaiveSNPUnphased)
    try:
        set_configs("snp_hbm_budget", 4)     # 4 bytes -> force streaming
        m2 = ad.matrix.snp_unphased(io)
        assert isinstance(m2, MatrixNaiveSNPUnphasedStreamed)
    finally:
        set_configs("snp_hbm_budget", None)


def test_streamed_multi_matches_inhbm(tmp_path):
    """Every fit family streams: multigaussian + multinomial over the
    kron-eye + concat wrappers (the child's single pass over the packed
    bytes amortizes across classes AND lambdas) == in-HBM."""
    io, _ = _make_io(tmp_path, 150, 40, seed=2, name="b.snpdat")
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((150, 3))
    Ym = np.eye(3)[rng.integers(0, 3, 150)]
    kw = dict(lmda_path_size=8, min_ratio=0.1, progress_bar=False)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=8,
                                     dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.multigaussian(Y), **kw)
        st_s = ad.grpnet(m_s, ad.glm.multigaussian(Y), **kw)
        sm_h = ad.grpnet(m_h, ad.glm.multinomial(Ym), **kw)
        sm_s = ad.grpnet(m_s, ad.glm.multinomial(Ym), **kw)
    finally:
        set_configs("screen_all_max", None)
    for a, b, tol in ((st_h, st_s, 2e-8), (sm_h, sm_s, 5e-7)):
        assert a.error == "" and b.error == ""
        B_a = np.asarray(a.betas.todense())
        B_b = np.asarray(b.betas.todense())
        assert (B_a != 0).sum() > 0
        np.testing.assert_allclose(B_a, B_b, atol=tol)
        np.testing.assert_allclose(
            np.asarray(a.intercepts), np.asarray(b.intercepts), atol=tol
        )


def test_streamed_glm_binomial_matches_inhbm(tmp_path):
    """Streamed IRLS (optimistic chunk + streamed KKT) == fused in-HBM
    logistic path, with intercept and real BASIL screening."""
    io, data = _make_io(tmp_path, 260, 72, seed=21, name="gl.snpdat")
    y = np.asarray(data["glm"].y)
    y01 = (y > np.median(y)).astype(np.float64)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.binomial(y01), lmda_path_size=10,
                         min_ratio=0.05, progress_bar=False)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, ad.glm.binomial(y01), lmda_path_size=10,
                         min_ratio=0.05, progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    B_h = np.asarray(st_h.betas.todense())
    B_s = np.asarray(st_s.betas.todense())
    assert (B_h != 0).sum() > 0
    assert B_h.shape == B_s.shape
    np.testing.assert_allclose(B_h, B_s, atol=1e-8)
    np.testing.assert_allclose(st_h.intercepts, st_s.intercepts, atol=1e-8)
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-8)


def test_streamed_glm_poisson_groups_no_intercept(tmp_path):
    """Streamed poisson group elastic net (alpha<1, no intercept) == in-HBM."""
    io, data = _make_io(tmp_path, 220, 60, seed=23, name="po.snpdat")
    rng = np.random.default_rng(4)
    yp = rng.poisson(2.0, 220).astype(np.float64)
    groups = np.arange(0, 60, 3)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.poisson(yp), groups=groups, alpha=0.8,
                         intercept=False, lmda_path_size=8, min_ratio=0.05,
                         progress_bar=False)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, ad.glm.poisson(yp), groups=groups, alpha=0.8,
                         intercept=False, lmda_path_size=8, min_ratio=0.05,
                         progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    np.testing.assert_allclose(
        np.asarray(st_h.betas.todense()), np.asarray(st_s.betas.todense()),
        atol=1e-8,
    )
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-8)


def test_streamed_grpnet_mesh(tmp_path):
    """Streamed + mesh-sharded tiles (GSPMD over the byte axis) equals the
    unsharded streamed fit."""
    from adelie_tpu import parallel

    io, data = _make_io(tmp_path, 320, 64, seed=5, name="m.snpdat")
    try:
        set_configs("screen_all_max", 0)
        m1 = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                    dtype=np.float64)
        st1 = ad.grpnet(m1, data["glm"], lmda_path_size=8, min_ratio=0.1,
                        progress_bar=False)
        mesh = parallel.make_mesh(8)
        m2 = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                    dtype=np.float64, mesh=mesh)
        st2 = ad.grpnet(m2, data["glm"], lmda_path_size=8, min_ratio=0.1,
                        progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st1.error == "" and st2.error == ""
    np.testing.assert_allclose(
        np.asarray(st1.betas.todense()), np.asarray(st2.betas.todense()),
        atol=1e-9,
    )


def test_streamed_glm_cox_matches_inhbm(tmp_path):
    """Streamed Cox IRLS == fused in-HBM cox path (the survival GLM has
    extra index machinery inside the IRLS core; nothing in the streamed
    driver may depend on separability)."""
    io, _ = _make_io(tmp_path, 180, 48, seed=29, name="cx.snpdat")
    rng = np.random.default_rng(9)
    n = 180
    stop = rng.exponential(1.0, n) + 0.05
    status = (rng.uniform(size=n) < 0.7).astype(np.float64)
    glm_kw = dict(stop=stop, status=status)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.cox(**glm_kw), lmda_path_size=8,
                         min_ratio=0.1, progress_bar=False)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, ad.glm.cox(**glm_kw), lmda_path_size=8,
                         min_ratio=0.1, progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    B_h = np.asarray(st_h.betas.todense())
    B_s = np.asarray(st_s.betas.todense())
    assert (B_h != 0).sum() > 0
    np.testing.assert_allclose(B_h, B_s, atol=1e-8)
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-8)


def test_streamed_constrained_matches_inhbm(tmp_path):
    """Streamed constrained gaussian (optimistic constrained scan +
    dual-corrected streamed KKT) == in-HBM constrained path, with a
    None-mixed constraint list, elastic net, and real BASIL screening."""
    import adelie_tpu.constraint as ct

    io, data = _make_io(tmp_path, 200, 60, seed=5, name="cn.snpdat")
    y = np.asarray(data["glm"].y)
    groups = np.arange(0, 60, 3)

    def make_cons():
        # constrain every other group; the rest unconstrained (None)
        return [ct.box(np.full(3, -0.15), np.full(3, 0.15))
                if gi % 2 == 0 else None for gi in range(len(groups))]

    kw = dict(groups=groups, alpha=0.7, lmda_path_size=12, min_ratio=0.05,
              progress_bar=False)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.gaussian(y), constraints=make_cons(),
                         **kw)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, ad.glm.gaussian(y), constraints=make_cons(),
                         **kw)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    B_h = np.asarray(st_h.betas.todense())
    B_s = np.asarray(st_s.betas.todense())
    assert (B_h != 0).sum() > 0
    np.testing.assert_allclose(B_h, B_s, atol=2e-7)
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-7)
    # constrained coordinates respect the box (solver tolerance slack)
    for gi, g in enumerate(groups):
        if gi % 2 == 0:
            assert np.all(np.abs(B_s[:, g:g + 3]) <= 0.15 + 1e-3)
    # per-lambda duals recorded identically
    d_h = [{k: v for k, v in d.items()} for d in st_h.duals]
    d_s = [{k: v for k, v in d.items()} for d in st_s.duals]
    assert len(d_h) == len(d_s)
    for a, b in zip(d_h, d_s):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-7)


def test_streamed_constrained_glm_matches_inhbm(tmp_path):
    """Streamed constrained logistic fit (per-lambda BASIL route; the
    full gradient is one streamed X.mul pass per lambda) == in-HBM."""
    import adelie_tpu.constraint as ct

    io, data = _make_io(tmp_path, 180, 36, seed=7, name="cg.snpdat")
    y = np.asarray(data["glm"].y)
    y01 = (y > np.median(y)).astype(np.float64)
    groups = np.arange(0, 36, 3)

    def mk():
        return [ct.box(np.full(3, -0.1), np.full(3, 0.1)) for _ in groups]

    kw = dict(groups=groups, lmda_path_size=8, min_ratio=0.1,
              progress_bar=False)
    try:
        set_configs("screen_all_max", 0)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
        st_h = ad.grpnet(m_h, ad.glm.binomial(y01), constraints=mk(), **kw)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=8,
                                     dtype=np.float64)
        st_s = ad.grpnet(m_s, ad.glm.binomial(y01), constraints=mk(), **kw)
    finally:
        set_configs("screen_all_max", None)
    assert st_h.error == "" and st_s.error == ""
    B_h = np.asarray(st_h.betas.todense())
    B_s = np.asarray(st_s.betas.todense())
    assert (B_h != 0).sum() > 0
    np.testing.assert_allclose(B_h, B_s, atol=5e-6)
    np.testing.assert_allclose(st_h.devs, st_s.devs, atol=1e-6)
    assert np.all(np.abs(B_s) <= 0.1 + 1e-3)


def test_streamed_cv_serial_fallback(tmp_path):
    """CV over a streamed matrix auto-falls back to the serial fold loop
    (the fold-batched program embeds the matrix payload) and matches the
    in-HBM fold-BATCHED CV — a cross-validation of both code paths."""
    io, data = _make_io(tmp_path, 120, 24, seed=4, name="cv.snpdat")
    y = np.asarray(data["glm"].y)
    m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=8,
                                 dtype=np.float64)
    res_s = ad.cv_grpnet(m_s, ad.glm.gaussian(y), n_folds=3, seed=0,
                         lmda_path_size=10)
    m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float64)
    res_h = ad.cv_grpnet(m_h, ad.glm.gaussian(y), n_folds=3, seed=0,
                         lmda_path_size=10)
    np.testing.assert_allclose(res_s.losses, res_h.losses, atol=1e-8)
    with pytest.raises(ValueError, match="fold_batch"):
        ad.cv_grpnet(m_s, ad.glm.gaussian(y), n_folds=3, seed=0,
                     fold_batch=True)


def test_streamed_f32_matches_inhbm(tmp_path):
    """f32 (the device dtype) streamed == in-HBM f32 — de-risks the
    hardware north-star run, which streams in f32."""
    io, data = _make_io(tmp_path, 300, 96, seed=7, name="f32.snpdat")
    y = np.asarray(data["glm"].y).astype(np.float32)
    try:
        set_configs("screen_all_max", 0)
        m_s = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                     dtype=np.float32)
        st_s = ad.grpnet(m_s, ad.glm.gaussian(y, dtype=np.float32),
                         lmda_path_size=12, min_ratio=0.05,
                         progress_bar=False)
        m_h = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float32)
        st_h = ad.grpnet(m_h, ad.glm.gaussian(y, dtype=np.float32),
                         lmda_path_size=12, min_ratio=0.05,
                         progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    assert st_s.error == "" and st_h.error == ""
    np.testing.assert_allclose(
        np.asarray(st_s.betas.todense()), np.asarray(st_h.betas.todense()),
        atol=5e-6,
    )


def test_streamed_constrained_and_multi_mesh(tmp_path):
    """Streamed constrained + streamed multi compose with mesh-sharded
    tiles (GSPMD over the byte axis) == unsharded streamed."""
    import adelie_tpu.constraint as ct
    from adelie_tpu import parallel

    io, data = _make_io(tmp_path, 320, 48, seed=5, name="cm.snpdat")
    y = np.asarray(data["glm"].y)
    groups = np.arange(0, 48, 3)

    def mk():
        return [ct.box(np.full(3, -0.15), np.full(3, 0.15)) for _ in groups]

    mesh = parallel.make_mesh(8)
    kw = dict(groups=groups, lmda_path_size=8, min_ratio=0.1,
              progress_bar=False)
    Y = np.random.default_rng(1).standard_normal((320, 2))
    try:
        set_configs("screen_all_max", 0)
        m1 = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16,
                                    dtype=np.float64)
        s1 = ad.grpnet(m1, ad.glm.gaussian(y), constraints=mk(), **kw)
        sm1 = ad.grpnet(m1, ad.glm.multigaussian(Y), lmda_path_size=6,
                        min_ratio=0.1, progress_bar=False)
        m2 = ad.matrix.snp_unphased(io, streaming=True, tile_snps=16,
                                    dtype=np.float64, mesh=mesh)
        s2 = ad.grpnet(m2, ad.glm.gaussian(y), constraints=mk(), **kw)
        sm2 = ad.grpnet(m2, ad.glm.multigaussian(Y), lmda_path_size=6,
                        min_ratio=0.1, progress_bar=False)
    finally:
        set_configs("screen_all_max", None)
    for a, b in ((s1, s2), (sm1, sm2)):
        assert a.error == "" and b.error == ""
        np.testing.assert_allclose(
            np.asarray(a.betas.todense()), np.asarray(b.betas.todense()),
            atol=1e-9,
        )


def test_speculative_union_cuts_kkt_passes(tmp_path):
    """The speculative violator union (configs.stream_speculative_union)
    must (a) never increase the number of streamed full-p KKT passes,
    (b) cut them on a screening-pressured path, and (c) keep the
    solution equal to the exact-parity one at solver tolerance (the
    screen trajectory differs; the optimum does not)."""
    io, data = _make_io(tmp_path, 300, 120, seed=13)
    kw = dict(lmda_path_size=20, min_ratio=0.02, progress_bar=False)
    try:
        set_configs("screen_all_max", 0)
        m = ad.matrix.snp_unphased(io, streaming=True, tile_snps=32,
                                   dtype=np.float64)
        set_configs("stream_speculative_union", False)
        st_off = ad.grpnet(m, data["glm"], **kw)
        set_configs("stream_speculative_union", True)
        st_on = ad.grpnet(m, data["glm"], **kw)
    finally:
        set_configs("screen_all_max", None)
        set_configs("stream_speculative_union", None)
    assert st_off.error == "" and st_on.error == ""
    # every _run_chunk attempt does exactly one streamed KKT pass
    passes_off = len(st_off.benchmark["kkt"])
    passes_on = len(st_on.benchmark["kkt"])
    assert passes_on <= passes_off
    # the union fires ON the retry-triggering pass, so it can only
    # prevent SUBSEQUENT retries: a path whose failures each resolve in
    # a single retry legitimately yields passes_on == passes_off.  Only
    # a multi-retry path (strictly more passes than chunks + one retry)
    # must see a strict saving (ADVICE r3 #2).
    n_chunks = -(-len(st_off.lmdas) // int(st_off.lmda_chunk))
    if passes_off > n_chunks + 1:
        assert passes_on < passes_off
    B_off = np.asarray(st_off.betas.todense())
    B_on = np.asarray(st_on.betas.todense())
    assert B_off.shape == B_on.shape
    scale = max(np.abs(B_off).max(), 1e-12)
    assert np.abs(B_off - B_on).max() / scale < 5e-4
    np.testing.assert_allclose(st_off.devs, st_on.devs, atol=5e-4)
