"""Configuration, physical constants, and the grid parameter law.

Re-design of the reference configuration surface:
  - ``PlaneverbConfig``    mirrors the reference's ProjectPlaneverb/include/PvTypes.h:38-60
  - ``PlaneverbDSPConfig`` mirrors the reference's PlaneverbDSP/include/PvDSPTypes.h:33-53
  - constants table        mirrors PvTypes.h:83-102 (exposed as one frozen dataclass so
                           parity tolerances are tunable, per SURVEY.md §5)
  - ``GridParams``         reproduces Grid::CalculateGridParameters (Grid.cpp:390-396)
                           and the derived grid/response sizing (Grid.cpp:46-116).

All derived quantities are computed in float32 to match the reference's ``Real``
arithmetic so that grid dimensions and sample counts truncate identically.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

__all__ = [
    "Resolution",
    "BoundaryType",
    "ExecutionType",
    "PhysicalConstants",
    "CONSTANTS",
    "PlaneverbConfig",
    "PlaneverbDSPConfig",
    "GridParams",
    "compute_grid_params",
    "gaussian_pulse",
    "MATERIALS",
    "AbsorptionCoefficients",
    "material_r",
]


class Resolution(enum.IntEnum):
    """Max simulated frequency in Hz (reference PvTypes.h:22-30)."""

    LOW = 275
    MID = 375
    HIGH = 500
    EXTREME = 750
    DEFAULT = 375


class BoundaryType(enum.IntEnum):
    """Outer boundary behavior (reference PvTypes.h:33-36)."""

    ABSORBING = 0
    REFLECTING = 1  # declared but unsupported in the reference; we support it


class ExecutionType(enum.IntEnum):
    """Kept for API parity with PvTypes.h:14-17 (whose commented-out
    ``pv_GPU`` this names); the device backend is the only real one."""

    GPU = 0
    CPU_ORACLE = 1  # NumPy oracle, test-only


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """Physical / behavioral constants (reference PvTypes.h:83-102).

    Exposed as a frozen dataclass (not module-level macros) so experiments can
    override individual constants without forking the engine.
    """

    pi: float = 3.141593
    rho: float = 1.2041                 # air density
    c: float = 343.21                   # speed of sound (m/s)
    audible_threshold_gain: float = 0.00000316   # -110 dB linear
    dry_direction_analysis_length: float = 0.005  # s of flux for source dir
    dry_gain_analysis_length: float = 0.01        # s of initial pulse window
    wet_gain_analysis_length: float = 0.080       # s of early reflections
    max_audible_freq: float = 20000.0
    min_audible_freq: float = 20.0
    points_per_wavelength: float = 3.5
    schroeder_offset_s: float = 0.01    # tail cut for RT60 regression
    distance_gain_threshold: float = 0.891251     # -1 dB linear
    delay_close_threshold: float = 5.0  # samples, DOA walk "close enough"

    @property
    def z_air(self) -> float:
        return self.rho * self.c

    @property
    def impulse_response_s(self) -> float:
        """IR seconds to record: sqrt(2)*12.5/c + 0.25 (PvTypes.h:101).

        sqrt(2)*12.5 is the half-diagonal of the reference's 25x25 m world:
        wave travel from a centered listener to the farthest cell, plus a
        0.25 s analysis tail (dry+wet windows + RT60 regression).
        :func:`compute_grid_params` extends this for larger grids (the
        constant would silently truncate their far cells — cells beyond
        ~c*T of travel can never cross the onset threshold)."""
        return float(np.float32(math.sqrt(2.0)) * np.float32(12.5) / np.float32(self.c)
                     + np.float32(0.25))


CONSTANTS = PhysicalConstants()


@dataclasses.dataclass(frozen=True)
class PlaneverbConfig:
    """Acoustics module configuration (reference PvTypes.h:38-60).

    ``grid_size_x/y`` are in meters. ``grid_resolution`` is the max simulated
    frequency (one of :class:`Resolution`, or any positive Hz value >= LOW).
    """

    grid_size_x: float = 10.0
    grid_size_y: float = 10.0
    grid_resolution: int = int(Resolution.DEFAULT)
    grid_boundary_type: BoundaryType = BoundaryType.ABSORBING
    grid_offset_x: float = 0.0
    grid_offset_y: float = 0.0
    constants: PhysicalConstants = CONSTANTS

    def validate(self) -> None:
        """Config validation (reference PvContext.cpp:100-107)."""
        if self.grid_resolution < int(Resolution.LOW):
            raise ValueError(
                f"grid_resolution must be >= {int(Resolution.LOW)} Hz, "
                f"got {self.grid_resolution}")
        if self.grid_size_x <= 0 or self.grid_size_y <= 0:
            raise ValueError("grid size must be positive")


@dataclasses.dataclass(frozen=True)
class PlaneverbDSPConfig:
    """DSP module configuration (reference PvDSPTypes.h:33-53)."""

    max_callback_length: int = 4096
    dsp_smoothing_factor: int = 2
    sampling_rate: int = 44100
    use_spatialization: bool = True
    wet_gain_ratio: float = 0.9

    def validate(self) -> None:
        if self.max_callback_length > 4096 or self.max_callback_length <= 0:
            raise ValueError("max_callback_length must be in (0, 4096]")
        if self.dsp_smoothing_factor <= 0:
            raise ValueError("dsp_smoothing_factor must be > 0")


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Every static quantity derived from a :class:`PlaneverbConfig`.

    The reference spreads these across Grid::Grid (Grid.cpp:30-120) and
    CalculateGridParameters (Grid.cpp:390-396); here they live in one immutable
    record that fully determines the shapes of the jitted computation.

    Attributes:
      dx: cell size in meters
      dt: timestep in seconds
      fs: sampling rate of the simulation (Hz, truncated int)
      grid_x, grid_y: analysis-grid dimensions (cells)
      nx, ny: solver field dimensions = grid_x+1, grid_y+1 (staggered extension)
      response_length: IR samples recorded per sim pass
      listener-independent pulse is computed by :func:`gaussian_pulse`.
    """

    dx: float
    dt: float
    fs: int
    grid_x: int
    grid_y: int
    response_length: int
    resolution: int
    grid_size_x: float
    grid_size_y: float
    grid_offset_x: float
    grid_offset_y: float
    boundary_type: BoundaryType
    constants: PhysicalConstants

    @property
    def nx(self) -> int:
        return self.grid_x + 1

    @property
    def ny(self) -> int:
        return self.grid_y + 1

    @property
    def courant(self) -> float:
        """c*dt/dx, the update constant (FDTD.cpp:90)."""
        return float(np.float32(self.constants.c) * np.float32(self.dt)
                     / np.float32(self.dx))

    def world_to_cell(self, x: float, z: float) -> tuple[int, int]:
        """World position -> solver cell index (FDTD.cpp:96-97)."""
        cx = int(np.float32(x + self.grid_offset_x) / np.float32(self.dx))
        cy = int(np.float32(z + self.grid_offset_y) / np.float32(self.dx))
        return cx, cy

    # -- analysis window lengths in samples (Analyzer.cpp:171-173,237,293) --
    @property
    def dry_gain_samples(self) -> int:
        return int(np.float32(self.constants.dry_gain_analysis_length)
                   * np.float32(self.fs))

    @property
    def source_dir_samples(self) -> int:
        return int(np.float32(self.constants.dry_direction_analysis_length)
                   * np.float32(self.fs))

    @property
    def wet_gain_samples(self) -> int:
        return int(np.float32(self.constants.wet_gain_analysis_length)
                   * np.float32(self.fs))

    @property
    def schroeder_offset_samples(self) -> int:
        return int(np.float32(self.constants.schroeder_offset_s)
                   * np.float32(self.fs))

    @property
    def covered_travel_m(self) -> float:
        """Maximum listener-to-cell distance whose onset + full analysis
        windows fit the recording: c * (T/fs - 0.25). The 0.25 s is the
        analysis tail the IR law reserves (PvTypes.h:101); cells farther
        than this from the listener can never cross the onset threshold
        in time and publish the never-found sentinel values."""
        return float(self.constants.c) * (self.response_length / self.fs
                                          - 0.25)


def compute_grid_params(config: PlaneverbConfig) -> GridParams:
    """Reproduces CalculateGridParameters + grid sizing in f32 arithmetic.

    Reference: Grid.cpp:390-396 (dx/dt/fs law), Grid.cpp:46-58 (grid size),
    Grid.cpp:55 (response length).
    """
    config.validate()
    k = config.constants
    c = np.float32(k.c)
    min_wavelength = c / np.float32(config.grid_resolution)
    dx = min_wavelength / np.float32(k.points_per_wavelength)
    dt = dx / (c * np.float32(1.5))
    fs = int(np.float32(1.0) / dt)

    grid_size_fx = (np.float32(1.0) / dx) * np.float32(config.grid_size_x)
    grid_size_fy = (np.float32(1.0) / dx) * np.float32(config.grid_size_y)
    grid_x = int(grid_size_fx)
    grid_y = int(grid_size_fy)

    # IR length: the reference's constant sqrt(2)*12.5/c + 0.25 s
    # (PvTypes.h:101) assumes its 25 m world — sqrt(2)*12.5 is that grid's
    # half-diagonal (centered-listener worst-case travel). Larger grids
    # extend the law by the extra half-diagonal travel so far cells still
    # record their onset + full analysis windows; for grids <= 25 m the
    # extra term is exactly 0 and the sample count stays bit-identical to
    # the reference.
    half_diag = np.float32(0.5) * np.hypot(np.float32(config.grid_size_x),
                                           np.float32(config.grid_size_y))
    ref_half_diag = np.float32(math.sqrt(2.0)) * np.float32(12.5)
    extra_s = np.maximum(np.float32(0.0), half_diag - ref_half_diag) / c
    response_length = int(np.float32(fs)
                          * (np.float32(k.impulse_response_s) + extra_s))

    return GridParams(
        dx=float(dx),
        dt=float(dt),
        fs=fs,
        grid_x=grid_x,
        grid_y=grid_y,
        response_length=response_length,
        resolution=int(config.grid_resolution),
        grid_size_x=float(config.grid_size_x),
        grid_size_y=float(config.grid_size_y),
        grid_offset_x=float(config.grid_offset_x),
        grid_offset_y=float(config.grid_offset_y),
        boundary_type=config.grid_boundary_type,
        constants=k,
    )


def gaussian_pulse(params: GridParams) -> np.ndarray:
    """Precomputed Gaussian source pulse (reference Grid.cpp:12-27).

    sigma = 1/(0.5*pi*fmax); val(t) = exp(-(t - 2*sigma)^2 / sigma^2).
    Returned as float32 [response_length].
    """
    fmax = np.float32(params.resolution)
    pi = np.float32(math.acos(-1.0))
    sigma = np.float32(1.0) / (np.float32(0.5) * pi * fmax)
    delay = np.float32(2.0) * sigma
    dt = np.float32(1.0) / np.float32(params.fs)
    t = np.arange(params.response_length, dtype=np.float32) * dt
    return np.exp(-(t - delay) * (t - delay) / (sigma * sigma)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AbsorptionCoefficients:
    """Material table: reflection coefficient R = sqrt(1 - absorption).

    Reference: PvMathTypes.h:51-90. Values are R, not absorption.
    """

    FREE_SPACE: float = 0.000000000
    DEFAULT: float = 0.989949494
    BRICK_UNGLAZED: float = 0.979795897
    BRICK_PAINTED: float = 0.989949494
    CONCRETE_ROUGH: float = 0.969535971
    CONCRETE_BLOCK_PAINTED: float = 0.964365076
    GLASS_HEAVY: float = 0.984885780
    GLASS_WINDOW: float = 0.938083152
    TILE_GLAZED: float = 0.994987437
    PLASTER_BRICK: float = 0.984885780
    PLASTER_CONCRETE_BLOCK: float = 0.974679434
    WOOD_PLYWOOD_PANEL: float = 0.948683298
    STEEL: float = 0.948683298
    WOOD_PANEL: float = 0.953939201
    CONCRETE_BLOCK_COARSE: float = 0.806225775
    DRAPERY_LIGHT: float = 0.921954446
    DRAPERY_MEDIUM: float = 0.670820393
    DRAPERY_HEAVY: float = 0.632455532
    FIBERBOARD_SHREDDED_WOOD: float = 0.632455532
    CONCRETE_PAINTED: float = 0.989949494
    WOOD: float = 0.964365076
    WOOD_VARNISHED: float = 0.984885780
    CARPET_HEAVY: float = 0.806225775
    GRAVEL: float = 0.547722558
    GRASS: float = 0.547722558
    SNOW_FRESH: float = 0.316227766
    SOIL_ROUGH: float = 0.741619849
    WOOD_TREE: float = 0.911043358
    WATER_SURFACE: float = 0.994987437
    CONCRETE: float = 0.979795897
    GLASS: float = 0.969535971
    MARBLE: float = 0.994987437
    DRAPERY: float = 0.921954446
    CLOTH: float = 0.921954446
    AWNING: float = 0.921954446
    FOLIAGE: float = 0.911043358
    METAL: float = 0.948683298
    ICE: float = 0.994987437
    SNOW_PACKED: float = 0.994987437


MATERIALS = AbsorptionCoefficients()


def material_r(material) -> float:
    """Material name or numeric value -> reflection coefficient R.

    The reference maps a material enum to an absorption coefficient per
    object (PlaneverbObject.cs:203-244); this is the equivalent lookup for
    every place the framework accepts an absorption/R value: floats (and
    numeric strings) pass through, names resolve case-insensitively against
    the 38-entry :data:`MATERIALS` table.

        material_r(0.95)              -> 0.95
        material_r("CONCRETE_ROUGH")  -> 0.969535971
        material_r("grass")           -> 0.547722558
    """
    if isinstance(material, str):
        key = material.strip().upper()
        if hasattr(MATERIALS, key):
            return float(getattr(MATERIALS, key))
        try:
            value = float(material)
        except ValueError:
            value = None
        # a numeric string must also be finite: float("nan")/float("inf")
        # parse fine but would silently poison the stencil coefficients
        if value is None or not math.isfinite(value):
            names = [f.name for f in dataclasses.fields(MATERIALS)]
            raise ValueError(
                f"unknown material {material!r}; known names: "
                f"{', '.join(names)}") from None
        return value
    value = float(material)
    # same finiteness contract for plain numerics: NaN/inf would silently
    # poison the stencil coefficients downstream
    if not math.isfinite(value):
        raise ValueError(f"material value must be finite, got {material!r}")
    return value
