"""Global configuration for adelie_tpu.

Re-design of the reference's process-wide ``Configs`` statics
(reference: adelie/src/include/adelie_core/configs.hpp:6-21 and
adelie/configs.py:4-27).  Unlike the reference (mutable C++ statics), this is a
plain Python dataclass singleton; solver entry points read it once at call
time, so values are baked into each jitted fit as compile-time constants.
"""

import functools
from dataclasses import dataclass, fields


@dataclass
class Configs:
    # Proximal-Newton hessian floor (reference configs.hpp: hessian_min=1e-24).
    # Kept dtype-aware at use sites: f32 paths floor at ``hessian_min_f32``.
    hessian_min: float = 1e-24
    hessian_min_f32: float = 1e-12
    # Skip coordinate updates with ||dbeta|| <= dbeta_tol * sqrt(q)
    # (reference configs.hpp: dbeta_tol=1e-12).
    dbeta_tol: float = 1e-12
    # Below this many bytes the reference disables threading; here it gates
    # whether device ops are worth dispatching vs. running on host numpy.
    min_bytes: int = 1 << 17
    # Progress-bar symbol (reference: penguin).
    pb_symbol: str = "\U0001F427"
    # Cap on solver values to detect divergence (reference: 1e100).
    max_solver_value: float = 1e100
    # --- device knobs (no reference equivalent) ---
    # Capacity buckets for screen-set buffers: round capacities up to the next
    # bucket to bound XLA recompilations.
    screen_cap_min: int = 64
    group_cap_min: int = 64
    # When the FULL problem is this small (total value size), screen every
    # group up front: screening exists to bound the working set, and below
    # this size the whole Gram is cheaper than a BASIL retry round trip
    # (value kept from earlier hardware; not measured on the H100).
    screen_all_max: int = 1024
    # Matmul precision of the screen Gram contraction: "default" |
    # "float32" | "highest" | "x3".  Every other f32 contraction on the
    # solver path (gradients, CD inner loops) runs at f32 grade: either it
    # states HIGHEST itself or the solver entry points trace it under
    # ``f32_contractions``.  On the GPU "highest" and "float32" run f32 on the CUDA
    # cores, "default" lets XLA use TF32 tensor cores, and "x3" is the
    # three-pass bf16 split (2.4x faster than "highest" on the H100's
    # screen Gram at ~1e-4 relative error); chip_smoke.py phase 1 prints
    # each value's time and error against f64 on the card.  The default
    # stays "highest": the solver's KKT certificates and stall-honesty
    # tolerances are calibrated for f32-grade Grams.
    # Read at trace time: flips after a path has compiled do not retrace.
    matmul_precision: str = "highest"
    # Cooperative interrupt/watchdog guard: total CD sweeps a single fused
    # lambda-chunk device program may spend before freezing and returning
    # control to the host (which resumes at the next un-accepted lambda).
    # Bounds every device call's duration so user interrupts land between
    # chunks and a pathological fit exits with a valid partial state
    # instead of tripping the platform watchdog (the reference polls
    # PyErr_CheckSignals every CD iteration, py_state.cpp:70-74).
    chunk_sweep_budget: int = 1_000_000
    # Compensated f32 reductions (utils/compensated.py): chunked-Kahan
    # accumulation for the gradient / screen-Gram contractions, cutting the
    # O(n) accumulation error to ~O(compensated_chunk) so f32 device paths
    # approach the reference's f64-calibrated tolerances.  Off by default
    # (costs one extra scan + partial buffers on the hot contractions).
    compensated_reductions: bool = False
    compensated_chunk: int = 4096
    # Device-memory byte budget for device-resident packed SNP matrices;
    # above it the snp factories pick the host-streaming matrix (tiles
    # swept through the device per full-p product, matrix/_snp_stream.py).
    # None derives it from the device: half of what JAX may allocate
    # (``memory_stats()["bytes_limit"]``), leaving the rest for solver
    # state and gradient stacks.  A backend that reports no limit (the
    # CPU) streams nothing unless a budget is set.
    snp_hbm_budget: int = None
    # On a streamed-KKT chunk failure, union ALL groups violating at any
    # converged lambda of the chunk into the screen set (not just the
    # first failure's violators): the speculative gradient stack is
    # already paid for by the chunk's single full-p pass, and each
    # avoided retry saves a whole host->HBM sweep (25 GB at north-star
    # scale).  Solutions remain KKT-certified but can differ from the
    # in-HBM driver's within solver tolerance (the screen trajectory
    # changes); set False to reproduce the in-HBM path bit-for-bit.
    stream_speculative_union: bool = True
    # Run state.check_state after every certified chunk of the streamed
    # drivers (reference-style always-on state audits; costs host time
    # at each chunk boundary).  Debug aid for north-star-scale runs.
    debug_check_state: bool = False
    # Hand-kernel selection (adelie_tpu/kernels.py): "auto" follows the
    # per-(platform, dtype) table, "xla" forces the plain XLA paths,
    # "interpret" runs the kernels in the Pallas interpreter (tests and
    # CPU rehearsals).  Read at trace time.
    kernels: str = "auto"


_default = Configs()
configs = Configs()

# jax.lax precision objects are only importable with jax; map lazily.
_PRECISION_STRINGS = {
    "default": "DEFAULT",
    "float32": "HIGHEST",
    "highest": "HIGHEST",
    # 3-pass bf16 split: jax accepts the DotAlgorithmPreset name directly.
    "x3": "BF16_BF16_F32_X3",
}


def matmul_precision_value():
    """The ``precision=`` argument encoding ``configs.matmul_precision``."""
    name = configs.matmul_precision
    try:
        key = _PRECISION_STRINGS[name]
    except KeyError:
        raise ValueError(
            f"Unknown matmul_precision: {name!r}. "
            f"Valid: {sorted(_PRECISION_STRINGS)}"
        ) from None
    if key.startswith("BF16"):
        return key
    import jax

    return getattr(jax.lax.Precision, key)


def f32_contractions(fn):
    """Trace ``fn`` (a solver entry point) with f32-grade matmuls as the
    default, so a contraction that states no ``precision=`` cannot run
    in TF32 on the GPU; those that state one (the screen Gram reads
    ``configs.matmul_precision``) keep theirs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        import jax

        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def snp_hbm_budget():
    """``configs.snp_hbm_budget`` in bytes per device (None: unlimited)."""
    if configs.snp_hbm_budget is not None:
        return int(configs.snp_hbm_budget)
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return None if limit is None else int(limit) // 2


def set_configs(name: str, value=None):
    """Set a global configuration value.

    Mirrors ``adelie.configs.set_configs`` (reference adelie/configs.py:4-27):
    ``value=None`` resets the field to its default.
    """
    names = {f.name for f in fields(Configs)}
    if name not in names:
        raise ValueError(f"Unknown config: {name!r}. Valid: {sorted(names)}")
    if value is None:
        value = getattr(_default, name)
    setattr(configs, name, value)
    return value
