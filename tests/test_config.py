"""Grid parameter law and config validation vs reference-derived values."""

import numpy as np
import pytest

from planeverb.config import (CONSTANTS, PlaneverbConfig, Resolution,
                              compute_grid_params, gaussian_pulse)


def test_grid_law_low_res_25m():
    """Derived workload @275 Hz from BASELINE.md: dx~0.357, fs~1443, T~435."""
    cfg = PlaneverbConfig(grid_size_x=25.0, grid_size_y=25.0,
                          grid_resolution=int(Resolution.LOW))
    p = compute_grid_params(cfg)
    assert abs(p.dx - 0.356583) < 1e-4
    assert p.fs == 1443
    assert p.response_length == 435
    assert p.grid_x == 70 and p.grid_y == 70
    assert p.nx == 71 and p.ny == 71


def test_grid_law_extreme_res_25m():
    cfg = PlaneverbConfig(grid_size_x=25.0, grid_size_y=25.0,
                          grid_resolution=int(Resolution.EXTREME))
    p = compute_grid_params(cfg)
    assert abs(p.dx - 0.130747) < 1e-4
    assert p.fs == 3937
    assert p.grid_x == 191  # 25/0.130747 = 191.2
    assert p.response_length == int(np.float32(3937) * np.float32(CONSTANTS.impulse_response_s))


def test_courant_stability():
    for res in (275, 375, 500, 750):
        p = compute_grid_params(PlaneverbConfig(grid_resolution=res))
        # courant = c*dt/dx = 1/1.5 by construction; stable for 2D (< 1/sqrt(2))
        assert abs(p.courant - 1.0 / 1.5) < 1e-6


def test_pulse_shape():
    p = compute_grid_params(PlaneverbConfig(grid_size_x=10, grid_size_y=10,
                                            grid_resolution=275))
    pulse = gaussian_pulse(p)
    assert pulse.shape == (p.response_length,)
    assert pulse.dtype == np.float32
    # peak at t = 2*sigma
    sigma = 1.0 / (0.5 * np.pi * 275.0)
    peak_idx = int(round(2 * sigma * p.fs))
    assert abs(int(np.argmax(pulse)) - peak_idx) <= 1
    assert pulse.max() <= 1.0 + 1e-6


def test_invalid_config_rejected():
    with pytest.raises(ValueError):
        compute_grid_params(PlaneverbConfig(grid_resolution=100))
    with pytest.raises(ValueError):
        compute_grid_params(PlaneverbConfig(grid_size_x=0.0))


def test_analysis_windows():
    p = compute_grid_params(PlaneverbConfig(grid_size_x=25, grid_size_y=25,
                                            grid_resolution=275))
    assert p.dry_gain_samples == int(0.01 * 1443)
    assert p.source_dir_samples == int(0.005 * 1443)
    assert p.wet_gain_samples == int(0.080 * 1443)
    assert p.schroeder_offset_samples == int(0.01 * 1443)


def test_material_r_lookup():
    """Name->R plumbing (the reference's material enum -> coefficient
    mapping, PlaneverbObject.cs:203-244)."""
    from planeverb.config import MATERIALS, material_r

    assert material_r("CONCRETE_ROUGH") == MATERIALS.CONCRETE_ROUGH
    assert material_r("grass") == MATERIALS.GRASS          # case-insensitive
    assert material_r(" Snow_Fresh ") == MATERIALS.SNOW_FRESH
    assert material_r(0.5) == 0.5                          # float passthrough
    assert material_r("0.25") == 0.25                      # numeric string
    with pytest.raises(ValueError, match="unknown material"):
        material_r("UNOBTAINIUM")
    # non-finite numeric strings parse via float() but would poison the
    # stencil coefficients — rejected like any unknown name
    for bad in ("nan", "NaN", "inf", "-inf", "Infinity"):
        with pytest.raises(ValueError, match="unknown material"):
            material_r(bad)
    # same contract for plain (non-string) numerics
    for bad in (float("nan"), float("inf"), float("-inf")):
        with pytest.raises(ValueError, match="finite"):
            material_r(bad)


def test_ir_length_scales_with_grid_diagonal():
    """The IR law extends the reference constant (sqrt(2)*12.5/c + 0.25,
    PvTypes.h:101 — derived from its 25 m world) by the extra half-diagonal
    travel of larger grids, so far cells can still record their onset +
    analysis windows. Grids <= 25 m stay bit-identical to the reference."""
    import math

    # reference parity: the 25 m workloads keep their exact step counts
    # (BASELINE.md workload table: 435 @ 275 Hz, 1187 @ 750 Hz)
    for res, steps in ((275, 435), (750, 1187)):
        p = compute_grid_params(PlaneverbConfig(
            grid_size_x=25.0, grid_size_y=25.0, grid_resolution=res))
        assert p.response_length == steps
    # smaller grids do NOT shrink below the reference constant
    p10 = compute_grid_params(PlaneverbConfig(
        grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275))
    assert p10.response_length == 435

    # larger grids cover their own half-diagonal: a centered listener's
    # farthest corner is within covered_travel_m (onset + full windows)
    for size in (60.0, 133.3):
        p = compute_grid_params(PlaneverbConfig(
            grid_size_x=size, grid_size_y=size, grid_resolution=750))
        assert p.response_length > 1187
        half_diag = 0.5 * math.hypot(p.grid_x * p.dx, p.grid_y * p.dx)
        assert p.covered_travel_m >= half_diag * 0.999
