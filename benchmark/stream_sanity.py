"""Moderate-scale streamed sanity on the device.

Forces streaming at a size that also fits HBM, so the streamed result can
be pinned against the in-HBM fit on the same chip, and reports achieved
H2D stream bandwidth.
"""

import sys
import time

import numpy as np


def main(p=100_000, n=20_000):
    import jax
    import jax.numpy as jnp

    import adelie_tpu as ad

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from north_star_data import _byte_lut

    rng = np.random.default_rng(11)
    nb = (n + 3) // 4
    lut = _byte_lut()
    packed = lut[rng.integers(0, 256, size=(p, nb),
                              dtype=np.uint64).astype(np.uint8)]

    class IO:
        impute = np.zeros(p)

        def _ensure(self):
            pass

        def rows(self):
            return n

        def snps(self):
            return p

    IO.packed = packed
    io = IO()
    from adelie_tpu.matrix._snp import unpack_2bit_np

    sig = rng.choice(p, 30, replace=False)
    cols = unpack_2bit_np(packed[sig], n).astype(np.float32)
    y = (cols.T @ rng.standard_normal(30) +
         0.5 * rng.standard_normal(n)).astype(np.float32)

    kw = dict(lmda_path_size=30, min_ratio=5e-2, progress_bar=False)

    Xs = ad.matrix.snp_unphased(io, streaming=True, dtype=np.float32)
    w = jnp.full((n,), 1.0 / n, jnp.float32)
    U = (jnp.asarray(y) * w)[None, :]
    out = Xs.mul_many(U)
    np.asarray(jax.device_get(out[:1]))          # force
    t0 = time.perf_counter()
    out = Xs.mul_many(U)
    np.asarray(jax.device_get(out[:1]))
    sweep = time.perf_counter() - t0
    gb = p * nb / 1e9
    print(f"stream sweep: {sweep:.2f}s for {gb:.2f} GB packed "
          f"-> {gb / sweep:.2f} GB/s H2D", flush=True)

    t0 = time.perf_counter()
    st_s = ad.grpnet(Xs, ad.glm.gaussian(y, dtype=np.float32), **kw)
    cold_s = time.perf_counter() - t0
    assert st_s.error == "", st_s.error
    t0 = time.perf_counter()
    st_s = ad.grpnet(Xs, ad.glm.gaussian(y, dtype=np.float32), **kw)
    warm_s = time.perf_counter() - t0

    Xh = ad.matrix.snp_unphased(io, streaming=False, dtype=np.float32)
    st_h = ad.grpnet(Xh, ad.glm.gaussian(y, dtype=np.float32), **kw)
    t0 = time.perf_counter()
    st_h = ad.grpnet(Xh, ad.glm.gaussian(y, dtype=np.float32), **kw)
    warm_h = time.perf_counter() - t0

    B_s = np.asarray(st_s.betas.todense())
    B_h = np.asarray(st_h.betas.todense())
    # relative gap: streamed tiles sum in a different order than the
    # in-HBM kernel, so f32 paths agree to a few ulps of the beta scale
    gap = float(np.abs(B_s - B_h).max() / max(np.abs(B_h).max(), 1e-12))
    print(f"streamed path: cold {cold_s:.1f}s warm {warm_s:.2f}s | "
          f"in-HBM warm {warm_h:.2f}s | rel max |beta_s - beta_h| = "
          f"{gap:.2e} ({len(st_s.lmdas)} vs {len(st_h.lmdas)} lambdas)",
          flush=True)
    assert gap < 5e-4, gap
    print("OK", flush=True)


if __name__ == "__main__":
    main()
