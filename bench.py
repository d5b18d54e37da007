"""Benchmark: FDTD cell-updates/s on the headline workload, on one GPU.

Prints the card's name and power limit (as ``nvidia-smi`` reports them),
then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Workload: 25x25 m grid at 750 Hz max frequency (pv_ExtremeResolution) ->
192x192 solver cells x 1187 timesteps ~= 44M cell-updates + a full
[T, nx, ny] f32 pressure recording per pass, then the vectorized analyzer.
The reference claims "real time on a single CPU core" only for the *low*
resolution sandbox config (README.md:24-25); the baseline here is the NumPy
oracle (tests/oracle.py) — a faithful vectorized CPU implementation of the
reference solver — timed on this host.

Every device time is a median over 10 passes, each ended by
``block_until_ready`` (utils/profiling.py::time_block). Without a GPU the
script exits non-zero: a CPU time is no measurement of the device.

Run from the repository root:  python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main() -> int:
    from planeverb.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, "tests")
    import oracle

    from planeverb.config import (PlaneverbConfig, compute_grid_params,
                                  gaussian_pulse)
    from planeverb.ops import voxelize
    from planeverb.ops.pipeline import pipeline_auto, simulate_auto
    from planeverb.scene import demo_scene
    from planeverb.utils.profiling import time_block

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)

    cfg = PlaneverbConfig(grid_size_x=25.0, grid_size_y=25.0,
                          grid_resolution=750)
    params = compute_grid_params(cfg)
    scene = demo_scene("HugeRoom")
    beta_np, refl_np = voxelize.voxelize_np(params, scene.boxes)
    beta, refl = jnp.asarray(beta_np), jnp.asarray(refl_np)
    pulse = jnp.asarray(gaussian_pulse(params))
    lix, liy = params.world_to_cell(12.5, 13.5)
    cell_updates = params.nx * params.ny * params.response_length

    pipe = time_block(lambda: pipeline_auto(
        params, beta, refl, pulse, lix, liy, jnp.float32(1.0),
        jnp.float32(12.5), jnp.float32(13.5)))
    sim = time_block(lambda: simulate_auto(params, beta, refl, pulse,
                                           lix, liy))

    # baseline: NumPy oracle solver, per-step cost extrapolated from a
    # reduced-step run (the oracle's analyzer is a test-only per-cell
    # Python loop, so the solver is the comparable piece)
    import dataclasses

    grid = oracle.build_scene(cfg, scene)
    steps_probe = 40
    grid_small = dataclasses.replace(grid, params=dataclasses.replace(
        grid.params, response_length=steps_probe))
    t0 = time.perf_counter()
    oracle.generate_response(grid_small, 12.5, 13.5)
    t_oracle = ((time.perf_counter() - t0)
                * (params.response_length / steps_probe))

    rate = cell_updates / sim["median_s"]
    print(json.dumps({
        "metric": "fdtd_cell_updates_per_s",
        "value": rate,
        "unit": "cell-updates/s",
        "vs_baseline": rate / (cell_updates / t_oracle),
        "card": card,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "grid": [params.nx, params.ny],
        "timesteps": params.response_length,
        "sim_median_s": sim["median_s"],
        "sim_spread_s": [sim["min_s"], sim["max_s"]],
        "pipeline_median_s": pipe["median_s"],
        "pipeline_spread_s": [pipe["min_s"], pipe["max_s"]],
        "oracle_wall_s_est": t_oracle,
        "workload": "25m@750Hz HugeRoom (sim+analyze; baseline=numpy "
                    "oracle solver)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
