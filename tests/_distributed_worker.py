"""Two-process jax.distributed worker — run by test_distributed.py.

Each process forces the CPU backend (see tests/conftest.py), exposes 4
virtual devices,
joins the coordinator, and exercises the two multi-host primitives the
package ships (SURVEY §2.12 "distributed backend" row):

1. ``parallel.distributed_init`` — jax.distributed over DCN; asserts the
   global device view spans both processes.
2. ``parallel.scenario_map`` — round-robin scenario striping with the
   end-of-run DCN all-gather; every process must see every scenario's
   result, including scenarios it did not run.
3. a global-mesh reduction — an 8-device mesh spanning both processes;
   a jitted global sum over a row-sharded array must equal the f64 host
   truth on both processes.

Prints one "DIST_OK <process_id>" line on success (the test greps it).
"""

import os
import sys


def main():
    port, pid_s = sys.argv[1], sys.argv[2]
    proc_id = int(pid_s)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from adelie_tpu import parallel

    idx, cnt = parallel.distributed_init(
        coordinator_address=f"localhost:{port}",
        num_processes=2, process_id=proc_id,
    )
    assert (idx, cnt) == (proc_id, 2), (idx, cnt)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8, jax.devices()
    assert len(jax.local_devices()) == 4

    # -- scenario_map: 5 scenarios striped over 2 processes ------------- #
    def fit_scenario(k):
        # a tiny deterministic device computation per scenario
        import jax.numpy as jnp

        return float(jnp.sum(jnp.arange(k + 3, dtype=jnp.float64) ** 2))

    res = parallel.scenario_map(fit_scenario, list(range(5)))
    expect = [float(sum(i * i for i in range(k + 3))) for k in range(5)]
    assert res == expect, (res, expect)

    # -- multi-leaf mixed-dtype results: the whole map call must ride
    # ONE packed DCN all-gather (leaves would otherwise gather one by
    # one) and reconstruct exactly ------------------------------------- #
    def fit_pytree(k):
        import numpy as np

        return {"v": np.arange(3, dtype=np.float64) * k,
                "n": np.int32(k * 7),
                "odd": np.bool_(k % 2 == 1)}

    res2 = parallel.scenario_map(fit_pytree, list(range(5)))
    for k, r in enumerate(res2):
        assert np.allclose(r["v"], np.arange(3, dtype=np.float64) * k), r
        assert int(r["n"]) == k * 7, r
        assert bool(r["odd"]) == (k % 2 == 1), r

    # -- global-mesh reduction over both processes ---------------------- #
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(8), ("obs",))
    n = 64
    rows = np.arange(n, dtype=np.float64) * 0.5
    sharding = NamedSharding(mesh, P("obs"))
    local_sl = sharding.addressable_devices_indices_map((n,))
    arrs = [jax.device_put(rows[i], d) for d, i in local_sl.items()]
    garr = jax.make_array_from_single_device_arrays((n,), sharding, arrs)
    total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(garr)
    assert total.sharding.is_fully_replicated
    got = float(np.asarray(total.addressable_data(0)))
    assert abs(got - rows.sum()) < 1e-9, (got, rows.sum())

    print(f"DIST_OK {proc_id}", flush=True)


if __name__ == "__main__":
    main()
