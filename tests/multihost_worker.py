"""Subprocess worker for the real multi-process multi-host test.

Each process joins a 2-process jax.distributed runtime over localhost with 2
virtual CPU devices (4 global devices), builds the DCN-aware
``multihost_grid_mesh``, runs one tiny ``simulate_sharded_wide`` pass on
global arrays, and prints fingerprints of the sharded result next to a
locally computed single-device reference. The parent test asserts they match
— proving the multi-host bring-up path (init_distributed +
layout_by_process + global-array solve) end to end, not just with fake
device objects.

Usage: python multihost_worker.py <port> <process_id> <num_processes>
"""

import dataclasses
import os
import sys


def main() -> int:
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from planeverb.parallel import init_distributed

    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 2 * nproc, jax.devices()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import oracle
    from planeverb.config import PlaneverbConfig, compute_grid_params
    from planeverb.ops import fdtd, voxelize
    from planeverb.parallel import (multihost_grid_mesh, pad_to_mesh,
                                    simulate_sharded_wide)
    from planeverb.scene import demo_scene

    cfg = PlaneverbConfig(grid_size_x=6.0, grid_size_y=6.0,
                          grid_resolution=275)
    params = dataclasses.replace(compute_grid_params(cfg), response_length=48)
    beta, refl = voxelize.voxelize_np(params, demo_scene("SmallRoom").boxes)
    pulse = oracle.gaussian_pulse(params)[:params.response_length]
    lix, liy = params.world_to_cell(3.0, 3.0)

    mesh = multihost_grid_mesh()
    nx_pad, ny_pad = pad_to_mesh(params.nx, params.ny, mesh)

    def pad(a):
        out = np.zeros((nx_pad, ny_pad), np.float32)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    sharding = NamedSharding(mesh, P("x", "y"))
    bpad = jax.device_put(pad(beta), sharding)
    rpad = jax.device_put(pad(refl), sharding)

    res = simulate_sharded_wide(params, bpad, rpad, jnp.asarray(pulse),
                                jnp.int32(lix), jnp.int32(liy), mesh,
                                nx_pad, ny_pad, halo=2)

    def fingerprint(pr):
        t, nx, ny = pr.shape
        wt = jnp.cos(jnp.arange(t, dtype=jnp.float32) * 0.37)[:, None, None]
        wx = jnp.sin(1.0 + jnp.arange(nx, dtype=jnp.float32) * 0.11)[None, :,
                                                                     None]
        wy = jnp.cos(jnp.arange(ny, dtype=jnp.float32) * 0.23)[None, None, :]
        return (jnp.sum(pr * wt * wx * wy), jnp.sum(jnp.abs(pr)),
                jnp.max(jnp.abs(pr)))

    crop = jax.jit(lambda pr: fingerprint(
        pr[:, :params.nx, :params.ny]))
    got = [float(v) for v in crop(res.pressure)]

    ref = fdtd.simulate(params, jnp.asarray(beta), jnp.asarray(refl),
                        jnp.asarray(pulse), jnp.int32(lix), jnp.int32(liy))
    want = [float(v) for v in jax.jit(fingerprint)(ref.pressure)]

    # the engine's sharded pass (wide-halo solver + per-shard moments)
    # across the same 2-process mesh: the ppermute halo exchange crosses
    # the real process boundary
    from planeverb.parallel import simulate_moments_sharded

    res_p, _ = simulate_moments_sharded(
        params, bpad, rpad, jnp.asarray(pulse), jnp.int32(lix),
        jnp.int32(liy), mesh, nx_pad, ny_pad, halo=2)
    got_p = [float(v) for v in crop(res_p.pressure)]

    print(f"RESULT pid={pid} mesh={dict(mesh.shape)} "
          f"got={got} got_moments={got_p} want={want}", flush=True)
    ok = all(abs(g - w) <= 1e-5 * max(1.0, abs(w)) for g, w in
             zip(got + got_p, want + want))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
