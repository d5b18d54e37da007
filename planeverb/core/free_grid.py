"""Free-field calibration (FreeGrid analog).

At engine init the reference runs one full FDTD pass on an *empty* grid,
measures the energy of the response 1 m from the listener over the dry
window, and normalizes it to exactly 1 m via the 2D 1/r energy falloff
(/root/reference ProjectPlaneverb/src/FDTD/FreeGrid.cpp:71-110). The result
``EFree`` is the denominator for the analyzer's obstruction and wet-gain
normalization.

Scale note: the reference calibrates on a full-size empty grid every init
(FreeGrid.cpp:84) — at 100x-grid scale that is an init-time full-field sim
(and recording) per grid size for a quantity that does not depend on grid
extent at all: EFree is the energy at a 1 m probe over the first
``0.01 s + 1 m/c`` of travel, and that window closes before ANY outer-
boundary echo can return to the probe once the boundary is farther than
~2.7 m from the listener (echo path 2D-1 m > c*(0.01 + 1/c) m = 4.43 m).
So grids larger than :data:`CAL_SIZE_M` calibrate on a fixed
CAL_SIZE_M-square empty domain instead — the value is identical up to
sub-f32 numerical-dispersion precursors (pinned by
tests/test_analyzer.py::test_free_field_fixed_domain_matches_full_grid),
the cache key collapses across grid sizes, and a mesh/tiled Context inits
without a full-grid single-device sim. Grids at or below CAL_SIZE_M keep
the reference's exact full-grid behavior (bit-compatible with r01-r03;
since CAL_SIZE_M = 25 m that covers every world size the reference's own
sandbox/demos use — only larger-than-reference worlds see the fixed
domain, whose value sits within the per-size listener-rounding scatter
the full-grid scheme already has, see _cal_params).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from planeverb.config import (GridParams, PlaneverbConfig,
                              compute_grid_params, gaussian_pulse)
from planeverb.ops import voxelize
from planeverb.ops.pipeline import simulate_auto

__all__ = ["calibrate_free_field", "clear_cache", "CAL_SIZE_M"]

# Fixed calibration-domain side for large grids. Physics needs the boundary
# > 2.7 m from the centered listener (see module docstring); any value
# >= ~6 m works. 25.0 is chosen so every grid the REFERENCE can express
# (its sandbox/demo worlds are <= 25 m, PlaneverbSandbox/src/main.cpp:17)
# calibrates full-grid, bit-identical to FreeGrid.cpp:84 — r4's 14 m value
# silently shifted EFree ~2-3% for 14-25 m worlds when the clamped domain
# landed in the other listener-rounding class (ADVICE r4; see _cal_params).
# The init sim this costs at the 750 Hz extreme is one 192x192 pass, cached
# across grid sizes.
CAL_SIZE_M = 25.0

_CACHE: dict[tuple, float] = {}


def _key(params: GridParams) -> tuple:
    return (params.resolution, params.grid_x, params.grid_y,
            params.response_length, params.boundary_type,
            params.grid_offset_x, params.grid_offset_y)


def _cal_params(params: GridParams) -> GridParams:
    """Calibration domain: each dimension clamps to CAL_SIZE_M (same
    resolution/boundary/constants, zero offset) — EFree, and its cache
    key, become independent of any grid extent beyond the echo horizon.
    Dimensions at or under CAL_SIZE_M stay exact, so near boundaries keep
    the legacy physics (an elongated 10x200 m grid calibrates on 10x14 m:
    same short-dim wall distances, the long-dim walls are beyond reach in
    both domains), and a grid small in both dimensions is bit-compatible
    with the reference's full-grid calibration.

    Known normalization (measured r4): per-grid-size EFree values scatter
    in two classes ~2% apart because the reference's float round-trip of
    the centered listener (FreeGrid.cpp:84; reproduced in _efree_on)
    sometimes floors the listener cell one row short, putting the 1 m
    probe diagonally off-axis while the 1/r normalization still assumes
    on-axis distance. The fixed domain deterministically picks ONE class
    per resolution instead of inheriting the grid-size-dependent scatter —
    acoustic-parameter parity is unaffected (engine and oracle share the
    same EFree; tests/test_analyzer.py pins the classes)."""
    if (params.grid_size_x <= CAL_SIZE_M
            and params.grid_size_y <= CAL_SIZE_M):
        return params
    cfg = PlaneverbConfig(
        grid_size_x=min(params.grid_size_x, CAL_SIZE_M),
        grid_size_y=min(params.grid_size_y, CAL_SIZE_M),
        grid_resolution=params.resolution,
        grid_boundary_type=params.boundary_type,
        constants=params.constants)
    return compute_grid_params(cfg)


def _efree_on(params: GridParams) -> float:
    """One empty-grid sim on ``params`` -> EFree (FreeGrid.cpp:71-110)."""
    beta, refl = voxelize.base_fields(params)
    pulse = gaussian_pulse(params)

    lx = params.grid_x // 2
    ly = params.grid_y // 2
    emitter_x = lx + int(np.float32(1.0) / np.float32(params.dx))
    emitter_y = ly

    # listener world position is round-tripped through world_to_cell exactly
    # as the reference re-derives the cell from a world pos (FreeGrid.cpp:84)
    wx = float(np.float32(lx) * np.float32(params.dx))
    wy = float(np.float32(ly) * np.float32(params.dx))
    cix, ciy = params.world_to_cell(wx, wy)

    res = simulate_auto(params, jnp.asarray(beta), jnp.asarray(refl),
                        jnp.asarray(pulse), cix, ciy)
    sig = np.asarray(res.pressure[:, emitter_x, emitter_y])

    k = params.constants
    num_samples = (int(np.float32(k.dry_gain_analysis_length) * np.float32(params.fs))
                   + int(np.float32(1.0) / np.float32(k.c) * np.float32(params.fs)))
    efree = float(np.sum(sig[:num_samples].astype(np.float32) ** 2,
                         dtype=np.float32))

    r = np.float32(emitter_x - lx) * np.float32(params.dx)
    return float(np.float32(efree) * r)


def calibrate_free_field(params: GridParams) -> float:
    """Compute (or fetch cached) EFree for this grid configuration."""
    cal = _cal_params(params)
    key = _key(cal)
    if key in _CACHE:
        return _CACHE[key]
    efree = _efree_on(cal)
    _CACHE[key] = efree
    return efree


def clear_cache() -> None:
    _CACHE.clear()
