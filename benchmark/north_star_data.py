"""Synthesize + memory-map the BASELINE.json north-star workload.

The north star is a full lambda-path group lasso on a **1M-SNP x
100K-sample** PLINK-scale matrix (``BASELINE.json`` north_star;
``BASELINE.md:20``).  Packed 2-bit that is p x ceil(n/4) = 25 GB: device
resident where the device-memory budget holds it, else streamed from host
memory (``matrix/_snp_stream.py``, mirroring the reference's mmap
streaming design, ``io_snp_base.hpp:25-87``).

Synthesis avoids
generating 25 GB of fresh randomness: a 256 MB **pool** of LUT-mapped
bytes (the byte-LUT maps uniform bytes onto the 4-lane {0,1,2} dosage
product distribution, ~86/10/4%) is generated once, and each SNP row is
a random-offset window into the pool — distinct offsets give distinct
rows with the right marginal distribution, at memcpy speed instead of
RNG speed.  Rows stream into a ``np.memmap`` cached at ``PACKED_PATH``
and reused across bench runs.  The response ``y`` is built from 60
decoded causal columns + noise and cached alongside.
"""

import os

import numpy as np

# env overrides let the bench block be rehearsed end-to-end at small
# scale (set both + ADELIE_TPU_NORTH_STAR_DIR before importing)
N = int(os.environ.get("ADELIE_TPU_NORTH_STAR_N", 100_000))
P = int(os.environ.get("ADELIE_TPU_NORTH_STAR_P", 1_000_000))
NB = (N + 3) // 4                    # bytes per SNP row (25_000 at scale)
CACHE_DIR = os.environ.get(
    "ADELIE_TPU_NORTH_STAR_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".bench_data", "north_star"))
PACKED_PATH = os.path.join(CACHE_DIR, f"packed_p{P}_n{N}.u8")
Y_PATH = os.path.join(CACHE_DIR, f"y_p{P}_n{N}.npz")


def _byte_lut(probs=(0.86, 0.10, 0.04)):
    probs = np.asarray(probs)
    codes = np.arange(256)
    lane = np.stack([(codes >> (2 * k)) & 3 for k in range(4)], axis=1)
    valid = np.all(lane <= 2, axis=1)
    byte_p = np.where(valid, np.prod(probs[np.minimum(lane, 2)], axis=1), 0.0)
    byte_p /= byte_p.sum()
    cdf = np.cumsum(byte_p)
    return np.searchsorted(cdf, (np.arange(256) + 0.5) / 256).astype(np.uint8)


POOL_BYTES = 1 << 28                 # 256 MB LUT-mapped byte pool


def ensure(seed=11, chunk_rows=20_000, verbose=True):
    """Create (or reuse) the packed memmap + response; returns
    (packed_memmap (P, NB) uint8, y (N,) f32, causal_idx, beta)."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    packed_done = os.path.exists(PACKED_PATH) and \
        os.path.getsize(PACKED_PATH) == P * NB
    # the packed matrix (the expensive artifact) and the response are
    # resumable independently: a crash between the two must not force a
    # 25 GB rebuild
    if not packed_done:
        import time

        t0 = time.time()
        lut = _byte_lut()
        rng = np.random.default_rng(seed)
        # 256 MB pool, generated in 32 MB slabs (single-core friendly)
        pool_bytes = POOL_BYTES
        pool = np.empty(pool_bytes, np.uint8)
        slab = min(1 << 25, pool_bytes)
        for s0 in range(0, pool_bytes, slab):
            pool[s0:s0 + slab] = lut[
                rng.integers(0, 256, size=slab, dtype=np.uint8)
            ]
        offsets = rng.integers(0, POOL_BYTES - NB, size=P, dtype=np.int64)
        mm = np.memmap(PACKED_PATH + ".tmp", np.uint8, "w+", shape=(P, NB))
        buf = np.empty((chunk_rows, NB), np.uint8)
        for r0 in range(0, P, chunk_rows):
            r1 = min(r0 + chunk_rows, P)
            for i in range(r0, r1):
                o = offsets[i]
                buf[i - r0] = pool[o:o + NB]
            mm[r0:r1] = buf[: r1 - r0]
            if verbose and (r0 // chunk_rows) % 10 == 0:
                print(f"  synth rows {r1}/{P}  {time.time()-t0:.0f}s",
                      flush=True)
        mm.flush()
        del mm
        os.replace(PACKED_PATH + ".tmp", PACKED_PATH)
        if verbose:
            print(f"  packed memmap built in {time.time()-t0:.0f}s",
                  flush=True)

    if not os.path.exists(Y_PATH):
        import time

        t0 = time.time()
        # response from 60 causal SNPs; the causal draw must be
        # reproducible WITHOUT replaying the packed synthesis RNG, so it
        # uses its own fixed stream
        from adelie_tpu.matrix._snp import unpack_2bit_np

        rng = np.random.default_rng(seed + 1)
        packed = np.memmap(PACKED_PATH, np.uint8, "r", shape=(P, NB))
        causal = np.sort(rng.choice(P, 60, replace=False))
        cols = unpack_2bit_np(np.ascontiguousarray(packed[causal]), N)
        cols = cols.astype(np.float32)                       # (60, n)
        beta = rng.standard_normal(60).astype(np.float32)
        g = cols.T @ beta
        y = g + np.float32(0.5 * g.std()) * \
            rng.standard_normal(N).astype(np.float32)
        np.savez(Y_PATH, y=y, causal=causal, beta=beta)
        if verbose:
            print(f"  north-star cache built in {time.time()-t0:.0f}s",
                  flush=True)

    packed = np.memmap(PACKED_PATH, np.uint8, "r", shape=(P, NB))
    d = np.load(Y_PATH)
    return packed, d["y"], d["causal"], d["beta"]


class NorthStarIO:
    """io.snp_unphased-shaped view over the cached memmap."""

    def __init__(self):
        self.packed, self.y, self.causal, self.beta = ensure()
        self.impute = np.zeros(P, np.float32)

    def _ensure(self):
        pass

    def rows(self):
        return N

    def snps(self):
        return P


if __name__ == "__main__":
    ensure()
    print("ok:", PACKED_PATH)
