"""Device-mesh scaling utilities.

The reference's parallel substrate is OpenMP threads over row/column blocks
(matrix/utils.hpp, SURVEY.md section 2.2/2.12).  The device-native replacement:

* **n-sharding** (data-parallel reductions): the observation dimension of
  ``X``, ``resid``, ``weights`` is sharded over the mesh axis ``"n"``; the
  three large per-lambda contractions (full gradient ``X^T(w r)``, screen
  Gram, residual reconstruction) then run as local matmuls + XLA
  ``psum``-style reductions inserted automatically from sharding
  annotations, over the device interconnect.
* The small covariance-form CD state (A, screen beta/grad) is replicated —
  it is O(S^2) and latency-bound, so replication is the right layout.

``shard_rows(x, mesh)`` places an (n, ...) array row-sharded;
``replicate(x, mesh)`` fully replicates.  With no mesh (single chip),
everything is a no-op, so solvers are mesh-agnostic.
"""

import os
from contextlib import contextmanager

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_active_mesh = None


def make_mesh(n_devices=None, axis_name="n", devices=None):
    """Create a 1-D device mesh over the observation axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


@contextmanager
def use_mesh(mesh):
    """Context manager: solvers constructed inside shard over ``mesh``."""
    global _active_mesh
    old = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = old


def active_mesh():
    return _active_mesh


def shard_rows(x, mesh=None):
    """Shard the leading (observation) axis of ``x`` over the mesh.

    If the leading dim does not divide the mesh size (explicit device_put
    requires divisibility), the array is left as-is — inside jit, GSPMD
    still partitions it to match the sharded operands it meets.
    """
    mesh = mesh or _active_mesh
    if mesh is None:
        return x
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if x.shape[0] % n_dev != 0:
        return x
    spec = P(mesh.axis_names[0], *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(x, mesh=None):
    mesh = mesh or _active_mesh
    if mesh is None:
        return x
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_rows_to_multiple(arr, multiple, fill=0.0):
    """Pad the leading axis so it divides evenly across devices."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), n


# --------------------------------------------------------------------------- #
# multi-host (DCN) scale-out                                                   #
# --------------------------------------------------------------------------- #


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs):
    """Initialize multi-host JAX over DCN (SURVEY §2.12: the reference has
    no distributed backend; the replacement is ``jax.distributed`` with
    collectives over the device interconnect within a host and the network
    across hosts).

    A no-op when already initialized or when the arguments/environment
    (``JAX_COORDINATOR_ADDRESS`` etc.) identify a single process.  After
    this, ``jax.devices()`` spans every host; build meshes with
    :func:`make_mesh` as usual and shard the observation axis across the
    global device list.  Returns (process_index, process_count).
    """
    import jax

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    # NB: must not touch jax.process_count()/jax.devices() before
    # initialize() — any backend-initializing call makes joining the
    # coordinator impossible (jax raises "must be called before any JAX
    # calls").  jax.distributed.is_initialized() is safe.
    if coordinator_address is not None and \
            not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id, **kwargs,
        )
    return jax.process_index(), jax.process_count()


def scenario_shard(n_scenarios, *, n_shards=None, shard_index=None):
    """Indices of the scenarios THIS process runs (round-robin).

    The net-new device parallelism axis (SURVEY §2.12 path/fold batching):
    independent scenarios — CV folds, lambda sub-paths, phenotypes,
    bootstrap replicates — are striped across hosts; each host fits its
    stripe with its local chips and results are exchanged once at the
    end.  Overrides ``n_shards``/``shard_index`` exist for testing and
    for schedulers that manage their own process grid.
    """
    import jax

    if n_shards is None:
        n_shards = jax.process_count()
    if shard_index is None:
        shard_index = jax.process_index()
    return list(range(shard_index, int(n_scenarios), int(n_shards)))


def scenario_map(fn, scenarios, *, n_shards=None, shard_index=None,
                 gather=True):
    """Run ``fn`` over independent scenarios, striped across processes.

    Returns a list aligned with ``scenarios``; entries this process did
    not compute are ``None`` unless ``gather=True`` (default) and the
    results are numeric pytrees with matching shapes across scenarios, in
    which case every process receives all results via ONE stacked DCN
    all-gather (``multihost_utils.process_allgather``).  Single-process
    (or when ``n_shards``/``shard_index`` simulate a grid): a plain map
    of the local stripe.
    """
    import jax

    n = len(scenarios)
    simulated = n_shards is not None or shard_index is not None
    idxs = scenario_shard(n, n_shards=n_shards, shard_index=shard_index)
    local = {i: fn(scenarios[i]) for i in idxs}
    n_proc = jax.process_count() if n_shards is None else int(n_shards)
    if n_proc == 1:
        return [local[i] for i in range(n)]
    out = [local.get(i) for i in range(n)]
    if not gather or simulated or jax.process_count() == 1:
        # a simulated grid has no peers to exchange with
        return out

    from jax.experimental import multihost_utils

    # ONE collective: every process stacks its stripe padded to the
    # common stripe length, all-gather once, then scatter by owner.
    # A process with an empty stripe still needs the result SHAPE to
    # participate in the collective: it evaluates scenario 0 redundantly
    # (cheaper than a second shape-exchange round; only happens when
    # process_count > n_scenarios).
    template = local[idxs[0]] if idxs else fn(scenarios[0])
    max_stripe = -(-n // n_proc)  # ceil

    def stack(leaf_of):
        rows = []
        for k in range(max_stripe):
            i = jax.process_index() + k * n_proc
            if i < n and i in local:
                rows.append(np.asarray(leaf_of(local[i])))
            else:
                rows.append(np.zeros_like(np.asarray(leaf_of(template))))
        return np.stack(rows)

    leaves, treedef = jax.tree_util.tree_flatten(template)
    stacked = [
        stack(lambda r, j=j: jax.tree_util.tree_leaves(r)[j])
        for j in range(len(leaves))
    ]
    # ONE DCN collective for the whole map call (a tuple arg would do one
    # all-gather per pytree LEAF): every stacked leaf's bytes concatenate
    # into a single uint8 buffer — identical length on every process
    # since all stripes pad to max_stripe over the common template —
    # gathered once and unpacked by offset.
    metas = [(s.shape, s.dtype, s.nbytes) for s in stacked]
    packed = (np.concatenate([np.ascontiguousarray(s).reshape(-1)
                              .view(np.uint8) for s in stacked])
              if stacked else np.zeros(0, np.uint8))
    gathered = multihost_utils.process_allgather(packed)
    gathered = np.asarray(gathered).reshape(n_proc, -1)

    def unpack(owner):
        arrs, off = [], 0
        row = gathered[owner]
        for shape, dtype, nbytes in metas:
            arrs.append(row[off:off + nbytes].view(dtype).reshape(shape))
            off += nbytes
        return arrs

    rows = {owner: unpack(owner) for owner in set(
        i % n_proc for i in range(n))}
    # rows[owner][j] has shape (max_stripe, ...)
    for i in range(n):
        owner, k = i % n_proc, i // n_proc
        out[i] = jax.tree_util.tree_unflatten(
            treedef, [g[k] for g in rows[owner]]
        )
    return out
