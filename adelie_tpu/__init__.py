"""adelie_tpu — a group elastic net framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design with the capability surface of the
reference ``adelie`` package (group lasso / elastic net path solver with
BASIL screening, GLM proximal Newton, structured matrices, constraints,
CV, diagnostics), built for the device:

* the screen-set inner solver runs in covariance form against a
  device-computed Gram (see ``adelie_tpu/solver/pin.py``),
* all O(n)/O(p) work is a handful of large sharded matmuls per lambda,
* dynamic screen/active sets are fixed-capacity masked device buffers,
* hand-written kernels are chosen per backend in one table
  (``adelie_tpu/kernels.py``),
* scaling is via ``jax.sharding`` meshes (see ``adelie_tpu/parallel``),
  not threads.
"""

__version__ = "0.1.0"

import os as _os


def _configure_compile_cache():
    """Persistent compile cache, so warm starts are cheap across processes
    (the analog of the reference setting OpenMP env defaults at import,
    adelie/__init__.py:11-19).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    used as it is.  Otherwise a package running from a source checkout
    caches in ``<checkout>/.jax_cache``; an installed package sets none.
    """
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
        if not _os.path.exists(_os.path.join(root, "pyproject.toml")):
            return
        jax.config.update("jax_compilation_cache_dir",
                          _os.path.join(root, ".jax_cache"))
    # 0.1 not the default 1.0: the pin/BASIL drivers compile ~19
    # executables per fit signature and the sub-second ones (scatter,
    # convert, broadcast glue) otherwise re-compile in every process
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    # keep XLA's own caches (XLA:CPU results that pin host CPU features,
    # the GPU autotune cache) out of it: on the H100 a second process
    # started no slower without them (PERF.md), and on the CPU reloading
    # them on another host logs spurious SIGILL warnings
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")


if not _os.environ.get("ADELIE_TPU_NO_CACHE"):
    _configure_compile_cache()

from . import bcd
from . import configs as _configs_mod
from . import glm
from . import matrix
from .configs import set_configs
from .logger import logger, logger_level

# imported lazily by users that need them; kept as namespaces here
from . import data  # noqa: E402
from . import solver  # noqa: E402
from .solver import grpnet, gaussian_cov  # noqa: E402


def __getattr__(name):
    # lazy subpackages to keep import light
    if name == "prewarm":
        from ._prewarm import prewarm

        globals()["prewarm"] = prewarm
        return prewarm
    if name in ("constraint", "cv", "diagnostic", "io", "optimization",
                "sklearn", "state", "parallel"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name == "cv_grpnet":
        from .cv import cv_grpnet

        return cv_grpnet
    if name in ("bvls", "pinball", "css_cov"):
        from . import solver as _s

        return getattr(_s, name)
    if name in ("GroupElasticNet", "CSSModelSelection"):
        from . import sklearn as _sk

        return getattr(_sk, name)
    raise AttributeError(f"module 'adelie_tpu' has no attribute {name!r}")
