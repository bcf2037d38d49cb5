"""Which hand-written kernel, if any, serves an operation.

One table decides for every kernel site (the q = 1 pin solve in
``solver/pin.py`` and the SNP decode-matvec in ``matrix/_snp.py``), keyed
on the JAX platform and the operand dtype.  Sites ask :func:`choose` at
trace time and get one of

* ``"triton"``    — the Pallas kernel compiled for the GPU through Triton;
* ``"interpret"`` — the same kernel run by the Pallas interpreter (only
  when ``configs.kernels == "interpret"``: tests and rehearsal runs);
* ``None``        — the plain XLA formulation.

``configs.kernels`` overrides the table: ``"auto"`` (the table),
``"xla"`` (never a hand kernel: the A/B baseline) or ``"interpret"``.
The choice is read at trace time, like every configs value: call
``jax.clear_caches()`` after flipping it.
"""

import jax
import numpy as np

from .configs import configs

# (platform, dtype) -> kernel route; anything absent takes plain XLA.
# f64 and the CPU have no hand kernel.
KERNEL_TABLE = {
    ("gpu", "float32"): "triton",
}

_MODES = ("auto", "xla", "interpret")


def choose(dtype, platform=None):
    """The kernel route for an operand of ``dtype`` on ``platform``
    (default: ``jax.default_backend()``)."""
    mode = configs.kernels
    if mode not in _MODES:
        raise ValueError(
            f"Unknown kernels mode: {mode!r}. Valid: {list(_MODES)}")
    if mode == "xla":
        return None
    dt = np.dtype(dtype).name
    if mode == "interpret":
        return "interpret" if dt == "float32" else None
    platform = platform or jax.default_backend()
    return KERNEL_TABLE.get((platform, dt))
