"""Halo-exchange scaling harness for the sharded solver.

Measures wall-clock per simulation pass of ``parallel.simulate_sharded_wide``
on growing device counts, in two modes:

  strong: the global grid is fixed, shards shrink —
          efficiency(n) = t(1) / (n * t(n));
  weak:   the per-device block is fixed, the world grows with the mesh
          (the deployment shape for "bigger worlds") —
          efficiency(n) = t(1) / t(n), ideal = a flat wall.

On an 8-device virtual CPU mesh it runs the identical program (collectives
included) and validates the harness itself — virtual-device timings share
one physical socket, so treat those numbers as plumbing checks, not
performance.

Usage:  python -m planeverb scale [--grid-size 50] [--weak] ...
"""

from __future__ import annotations

from planeverb.utils.profiling import time_block

__all__ = ["measure_scaling"]


def measure_scaling(params, beta, refl, pulse, lix, liy,
                    device_counts=None, halo: int = 8, reps: int = 3,
                    mode: str = "strong"):
    """Scaling sweep of the sharded solver over sub-meshes.

    ``mode="strong"`` (default): the GLOBAL grid is fixed and shards
    shrink with the device count; efficiency(n) = t(1) / (n * t(n)).
    ``mode="weak"``: the PER-DEVICE block is fixed at the given params'
    grid and the world grows with the mesh (the deployment shape for
    "bigger worlds"); efficiency(n) = t(1) / t(n) — ideal
    weak scaling is a flat wall. Weak rows run an empty world at the
    base response length (geometry never changes the solver's per-cell
    cost, and a fixed T keeps per-chip work identical across sizes).

    Each row times ``reps`` passes of ``parallel.simulate_sharded_wide``
    (median, every pass ended by ``block_until_ready``) after one
    compiling pass.

    Returns a list of row dicts: {devices, mesh, wall_s, cell_updates_per_s,
    efficiency_vs_1}.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from planeverb.config import PlaneverbConfig, compute_grid_params
    from planeverb.ops import voxelize
    from planeverb.parallel.mesh import factor_mesh, grid_mesh, pad_to_mesh
    from planeverb.parallel.solver import simulate_sharded_wide

    if mode not in ("strong", "weak"):
        raise ValueError(f"unknown mode {mode!r}")

    all_devices = jax.devices()
    if device_counts is None:
        device_counts = []
        n = 1
        while n <= len(all_devices):
            device_counts.append(n)
            n *= 2

    rows = []
    t1 = None
    for n in device_counts:
        mesh = grid_mesh(all_devices[:n], factor_mesh(n))
        if mode == "weak":
            # grow the world with the mesh: per-device block ~= the base grid
            mx_, my_ = mesh.shape["x"], mesh.shape["y"]
            cfg_n = PlaneverbConfig(
                grid_size_x=params.grid_size_x * mx_,
                grid_size_y=params.grid_size_y * my_,
                grid_resolution=params.resolution,
                grid_boundary_type=params.boundary_type,
                constants=params.constants)
            p_n = dataclasses.replace(compute_grid_params(cfg_n),
                                      response_length=params.response_length)
            b_n, r_n = voxelize.base_fields(p_n)
            cix, ciy = p_n.nx // 2, p_n.ny // 2
        else:
            p_n, b_n, r_n = params, beta, refl
            cix, ciy = int(lix), int(liy)
        nx_pad, ny_pad = pad_to_mesh(p_n.nx, p_n.ny, mesh)
        bp = jnp.zeros((nx_pad, ny_pad), jnp.float32).at[
            :p_n.nx, :p_n.ny].set(jnp.asarray(b_n))
        rp = jnp.zeros((nx_pad, ny_pad), jnp.float32).at[
            :p_n.nx, :p_n.ny].set(jnp.asarray(r_n))
        pu = jnp.asarray(pulse)
        k = min(halo, nx_pad // mesh.shape["x"], ny_pad // mesh.shape["y"])
        updates = p_n.nx * p_n.ny * p_n.response_length

        def one_pass(p_n=p_n, mesh=mesh, bp=bp, rp=rp, pu=pu, k=k,
                     nx_pad=nx_pad, ny_pad=ny_pad, cix=cix, ciy=ciy):
            return simulate_sharded_wide(
                p_n, bp, rp, pu, jnp.int32(cix), jnp.int32(ciy), mesh,
                nx_pad, ny_pad, halo=k).pressure

        t = time_block(one_pass, n=reps)["median_s"]
        if t1 is None:
            # normalize in case the sweep starts above 1 device
            t1 = t * (n if mode == "strong" else 1)
        eff = (t1 / (n * t)) if mode == "strong" else (t1 / t)
        rows.append({
            "devices": n,
            "mode": mode,
            "mesh": [mesh.shape["x"], mesh.shape["y"]],
            "grid": [p_n.nx, p_n.ny],
            "halo": k,
            "wall_s": round(t, 5),
            "cell_updates_per_s": round(updates / t),
            "efficiency_vs_1": round(eff, 4),
        })
    return rows
