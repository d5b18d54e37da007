"""NumPy oracle: faithful re-implementation of the reference solver semantics.

This module is TEST-ONLY ground truth. It reproduces, with literal flat-index
semantics (including the in-bounds row-wrap reads of the C++ loops), the
behavior of:

  - Grid voxelization          /root/reference ProjectPlaneverb/src/FDTD/Grid.cpp:136-296
  - GenerateResponseCPU        /root/reference ProjectPlaneverb/src/FDTD/FDTD.cpp:87-236
  - FreeGrid calibration       /root/reference ProjectPlaneverb/src/FDTD/FreeGrid.cpp:71-110
  - Analyzer::EncodeResponse   /root/reference ProjectPlaneverb/src/DSP/Analyzer.cpp:139-328
  - EncodeListenerDirection    /root/reference ProjectPlaneverb/src/DSP/Analyzer.cpp:340-431

Everything runs in float32 to match the reference's ``Real``.

The production JAX/Pallas engine in planeverb/ is a from-scratch device-first
design; this oracle exists so golden tests can prove the two agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from planeverb.config import (CONSTANTS, GridParams, PlaneverbConfig,
                              compute_grid_params, gaussian_pulse)
from planeverb.scene import Scene

f32 = np.float32


def _seq_sum(arr: np.ndarray) -> np.float32:
    """Strict sequential f32 sum (np.sum uses pairwise; accumulate does not)."""
    if arr.size == 0:
        return f32(0.0)
    return np.add.accumulate(arr.astype(f32))[-1]


@dataclasses.dataclass
class OracleGrid:
    """Flat-array state mirroring the reference's Cell grid."""

    params: GridParams
    b: np.ndarray        # int32 [N] beta flags (1 air, 0 wall/edge)
    by: np.ndarray       # int32 [N] (written, never read by the solver)
    absorption: np.ndarray  # f32 [N] reflection coefficient R per cell
    pulse: np.ndarray    # f32 [T]

    @property
    def N(self) -> int:
        return self.params.nx * self.params.ny


def make_grid(config: PlaneverbConfig) -> OracleGrid:
    """Initial edge-flag pattern (Grid.cpp:88-113)."""
    p = compute_grid_params(config)
    nx, ny = p.nx, p.ny
    n = nx * ny
    b = np.ones(n, dtype=np.int32)
    by = np.ones(n, dtype=np.int32)
    for i in range(n):
        row = i // ny
        col = i % ny
        if row == p.grid_x or col == p.grid_y:
            b[i] = 0
            by[i] = 0
        elif col == 0:
            b[i] = 1
            by[i] = 0
    absorption = np.zeros(n, dtype=f32)  # PV_ABSORPTION_FREE_SPACE
    return OracleGrid(params=p, b=b, by=by, absorption=absorption,
                      pulse=gaussian_pulse(p))


def add_aabb(grid: OracleGrid, x, y, width, height, absorption) -> None:
    """Solid-fill voxelization (Grid.cpp:229-246, the active path)."""
    p = grid.params
    inv_dx = f32(1.0) / f32(p.dx)
    start_y = int(f32(f32(y) - f32(height) / f32(2.0) + f32(p.grid_offset_x)) * inv_dx)
    start_x = int(f32(f32(x) - f32(width) / f32(2.0) + f32(p.grid_offset_y)) * inv_dx)
    end_y = int(f32(f32(y) + f32(height) / f32(2.0) + f32(p.grid_offset_x)) * inv_dx)
    end_x = int(f32(f32(x) + f32(width) / f32(2.0) + f32(p.grid_offset_y)) * inv_dx)
    ny = p.ny
    for i in range(start_y, end_y):
        if 0 <= i <= p.grid_y:
            for j in range(start_x, end_x):
                if 0 <= j <= p.grid_x:
                    idx = j * ny + i
                    grid.absorption[idx] = f32(absorption)
                    grid.b[idx] = 0
                    grid.by[idx] = 0


def build_scene(config: PlaneverbConfig, scene: Scene | None) -> OracleGrid:
    grid = make_grid(config)
    if scene is not None:
        for box in scene:
            add_aabb(grid, box.x, box.y, box.width, box.height, box.absorption)
    return grid


def generate_response(grid: OracleGrid, listener_x: float, listener_z: float):
    """FDTD sim (FDTD.cpp:87-236). Returns (pr, vx, vy) each [T, N] f32.

    Flat-index semantics are preserved exactly: the vy update wraps across row
    ends, the pressure update's out-of-range tail rows are forced to zero by
    beta=0, and the edge ABC overwrites happen after the velocity updates.
    """
    p = grid.params
    nx, ny = p.nx, p.ny
    n = nx * ny
    T = p.response_length
    courant = f32(p.courant)

    lx = int(f32(f32(listener_x) + f32(p.grid_offset_x)) / f32(p.dx))
    ly = int(f32(f32(listener_z) + f32(p.grid_offset_y)) / f32(p.dx))
    listener_pos = lx * (p.grid_y + 1) + ly

    beta = grid.b.astype(f32)
    R = grid.absorption
    Y = (f32(1.0) - R) / (f32(1.0) + R)

    pr = np.zeros(n, dtype=f32)
    vx = np.zeros(n, dtype=f32)
    vy = np.zeros(n, dtype=f32)

    rec_pr = np.zeros((T, n), dtype=f32)
    rec_vx = np.zeros((T, n), dtype=f32)
    rec_vy = np.zeros((T, n), dtype=f32)

    gx, gy = p.grid_x, p.grid_y

    for t in range(T):
        # pressure update: pr = beta * (pr - C * div v). The C++ loop runs the
        # full flat range and reads [i+ny] / [i+1] neighbors; rows/cols where
        # those wrap all have beta == 0, so we compute the in-range prefix and
        # zero the rest.
        div = np.zeros(n, dtype=f32)
        div[:n - ny] = (vx[ny:] - vx[:n - ny]) + (vy[1:n - ny + 1] - vy[:n - ny])
        pr = beta * (pr - courant * div)

        # vx update for i in [ny, n): neighbor is previous row, same col.
        i0 = ny
        b_n = beta[:n - ny]
        y_n = Y[:n - ny]
        b_c = beta[i0:]
        y_c = Y[i0:]
        grad = pr[i0:] - pr[:n - ny]
        air = vx[i0:] - courant * grad
        y_bound = b_c * y_n + b_n * y_c
        wall = y_bound * (pr[:n - ny] * b_n + pr[i0:] * b_c)
        vx_new = vx.copy()
        vx_new[i0:] = b_c * b_n * air + (b_n - b_c) * wall
        vx = vx_new

        # vy update for i in [1, n): neighbor is i-1 (wraps across row ends,
        # exactly as the C++ flat loop does).
        b_n = beta[:n - 1]
        y_n = Y[:n - 1]
        b_c = beta[1:]
        y_c = Y[1:]
        grad = pr[1:] - pr[:n - 1]
        air = vy[1:] - courant * grad
        y_bound = b_c * y_n + b_n * y_c
        wall = y_bound * (pr[:n - 1] * b_n + pr[1:] * b_c)
        vy_new = vy.copy()
        vy_new[1:] = b_c * b_n * air + (b_n - b_c) * wall
        vy = vy_new

        # edge ABC: top/bottom rows (FDTD.cpp:203-212)
        idx = np.arange(gy)
        vx[idx] = -pr[idx]
        idx2 = gx * (gy + 1) + idx
        vx[idx2] = pr[idx2 - gy - 1]

        # edge ABC: left/right columns (FDTD.cpp:215-223)
        idx = np.arange(gx) * (gy + 1)
        vy[idx] = -pr[idx]
        idx2 = idx + gy
        vy[idx2] = pr[idx2 - 1]

        rec_pr[t] = pr
        rec_vx[t] = vx
        rec_vy[t] = vy

        pr[listener_pos] += grid.pulse[t]

    return rec_pr, rec_vx, rec_vy


def free_field_energy(config: PlaneverbConfig) -> float:
    """FreeGrid calibration (FreeGrid.cpp:71-110)."""
    grid = make_grid(config)
    p = grid.params
    gx, gy = p.grid_x, p.grid_y
    listener_x = gx // 2
    listener_y = gy // 2
    emitter_x = listener_x + int(f32(1.0) / f32(p.dx))
    emitter_y = listener_y

    rec_pr, _, _ = generate_response(
        grid, listener_x * f32(p.dx), listener_y * f32(p.dx))

    # response at emitter cell on the (nx, ny) grid
    idx = emitter_x * (gy + 1) + emitter_y
    sig = rec_pr[:, idx]

    num_samples = (int(f32(CONSTANTS.dry_gain_analysis_length) * f32(p.fs))
                   + int(f32(1.0) / f32(CONSTANTS.c) * f32(p.fs)))
    efree = float(_seq_sum(sig[:num_samples].astype(f32) ** 2))

    r = f32(emitter_x - listener_x) * f32(p.dx)
    return float(f32(efree) * r)


def efree_per_r(efree: float, dx: float,
                listener_ix: int, listener_iy: int,
                emitter_ix: int, emitter_iy: int) -> float:
    """FreeGrid::GetEFreePerR (FreeGrid.cpp:41-59)."""
    lx = f32(listener_ix) * f32(dx)
    ly = f32(listener_iy) * f32(dx)
    ex = f32(emitter_ix) * f32(dx)
    ey = f32(emitter_iy) * f32(dx)
    r = np.sqrt((ex - lx) ** 2 + (ey - ly) ** 2, dtype=f32)
    if r == 0.0:
        return float(efree)
    return float(f32(efree) / r)


def analyze(grid: OracleGrid, rec_pr, rec_vx, rec_vy,
            listener_x: float, listener_z: float, efree: float):
    """Analyzer pass 1+2 (Analyzer.cpp:48-104, 139-328, 340-431).

    Returns dict of [grid_x*grid_y] arrays: occlusion, wet_gain, rt60, lowpass,
    direction (x,y), source_directivity (x,y), delay_samples.
    """
    p = grid.params
    gx, gy = p.grid_x, p.grid_y
    fs = p.fs
    T = p.response_length
    n_cells = gx * gy

    lwx = f32(listener_x) + f32(p.grid_offset_x)
    lwz = f32(listener_z) + f32(p.grid_offset_y)

    occlusion = np.zeros(n_cells, dtype=f32)
    wet_gain = np.zeros(n_cells, dtype=f32)
    rt60 = np.zeros(n_cells, dtype=f32)
    lowpass = np.zeros(n_cells, dtype=f32)
    sdir = np.zeros((n_cells, 2), dtype=f32)
    delay_samples = np.full(n_cells, np.finfo(f32).max, dtype=f32)

    direct_gain_samples = int(f32(CONSTANTS.dry_gain_analysis_length) * f32(fs))
    source_dir_samples = int(f32(CONSTANTS.dry_direction_analysis_length) * f32(fs))
    wet_gain_samples = int(f32(CONSTANTS.wet_gain_analysis_length) * f32(fs))
    schro_off = int(f32(CONSTANTS.schroeder_offset_s) * f32(fs))

    if gx != gy:
        # The reference indexes its result grid as [x*H + y] while its own
        # INDEX macro uses dim.x (Analyzer.cpp:114 vs PvDefinitions.h:23) —
        # coincident for square grids, out-of-bounds (UB) for rectangular
        # ones. The reference never runs non-square grids; there is no
        # faithful behavior to transliterate (SURVEY.md §7 reference quirks).
        raise NotImplementedError(
            "oracle analyzer: the reference's analyzer indexing is undefined "
            "for non-square grids; compare solver fields instead")
    for serial in range(n_cells):
        # INDEX_TO_POS with dim.x = gx: r = i // gx, c = i % gx
        r = serial // gx
        c = serial % gx
        # response fetched at solver grid (nx, ny): idx = r*(gy+1) + c
        idx = r * (gy + 1) + c
        prs = rec_pr[:, idx]

        # onset
        above = np.abs(prs) > f32(CONSTANTS.audible_threshold_gain)
        nz = np.nonzero(above)[0]
        if len(nz) == 0:
            delay_samples[serial] = np.finfo(f32).max
            continue
        onset = int(nz[0])
        delay_samples[serial] = f32(onset)

        source_dir_end = onset + source_dir_samples
        direct_end = onset + direct_gain_samples

        # sequential f32 accumulation via np.add.accumulate (order-faithful)
        sq = prs * prs
        e_dry = _seq_sum(sq[:min(direct_end, T)])
        rad = np.array([
            _seq_sum(prs[:min(source_dir_end, T)] * rec_vx[:min(source_dir_end, T), idx]),
            _seq_sum(prs[:min(source_dir_end, T)] * rec_vy[:min(source_dir_end, T), idx]),
        ], dtype=f32)

        efree_pr = efree_per_r(
            efree, p.dx,
            int(lwx / f32(p.dx)), int(lwz / f32(p.dx)), r, c)

        e = f32(e_dry) / f32(efree_pr)
        obstruction = np.sqrt(e, dtype=f32)

        norm = np.sqrt(rad[0] * rad[0] + rad[1] * rad[1], dtype=f32)
        norm = f32(-1.0) / (norm if norm > 0.0 else f32(1.0))
        sdir[serial] = norm * rad

        occlusion[serial] = obstruction

        rr = f32(1.0) / max(f32(0.001), obstruction)
        lowpass[serial] = (f32(-147.0) + f32(18390.0)
                           / (f32(1.0) + np.power(rr / f32(12.0), f32(0.8), dtype=f32)))

        # wet gain
        wet_end = min(direct_end + 1 + wet_gain_samples, T)
        wet_e = _seq_sum(sq[direct_end + 1:wet_end]) if wet_end > direct_end + 1 else f32(0.0)
        wet_gain[serial] = np.sqrt(f32(wet_e) / f32(efree), dtype=f32)

        # RT60 via backward Schroeder integration + closed-form regression
        starting_point = direct_end + 1
        end_point = T - schro_off
        regress_n = end_point - starting_point
        rn = f32(regress_n)
        xmean = (rn - f32(1.0)) * f32(0.5)
        xsum = rn * xmean
        denominator = f32(1.0 / 12.0) * rn * (rn * rn - f32(1.0))

        # edc walks backward from T-1; at descending index i,
        # edc(i) = sequential sum of sq[T-1], sq[T-2], ..., sq[i]
        back_acc = np.add.accumulate(sq[::-1])  # back_acc[k] = edc(T-1-k)
        i_desc = np.arange(end_point - 1, starting_point - 1, -1)
        edc_desc = back_acc[T - 1 - i_desc]
        y_desc = f32(10.0) * np.log10(edc_desc, dtype=f32)
        x_desc = (i_desc - starting_point).astype(f32)
        xysum = _seq_sum(y_desc * x_desc)
        ysum = _seq_sum(y_desc)
        ymean = ysum / rn
        numerator = xysum - ymean * xsum - xmean * ysum + rn * xmean * ymean
        slope_db_per_sample = numerator / denominator
        slope_db_per_sec = slope_db_per_sample * f32(fs)
        rt60[serial] = f32(-60.0) / slope_db_per_sec

    direction = _encode_directions(
        p, occlusion, delay_samples, lwx, lwz)

    return {
        "occlusion": occlusion,
        "wet_gain": wet_gain,
        "rt60": rt60,
        "lowpass": lowpass,
        "direction": direction,
        "source_directivity": sdir,
        "delay_samples": delay_samples,
    }


_NEIGHBORS = [(-1, -1), (-1, 0), (-1, 1),
              (0, -1), (0, 1),
              (1, -1), (1, 0), (1, 1)]


def _encode_directions(p: GridParams, occlusion, delay_samples, lwx, lwz):
    """EncodeListenerDirection greedy walk per cell (Analyzer.cpp:340-431)."""
    gx, gy = p.grid_x, p.grid_y
    n_cells = gx * gy
    T = p.response_length
    fs = f32(p.fs)
    wavelength = f32(CONSTANTS.c) / f32(p.resolution)
    threshold_dist = f32(0.3) * wavelength
    max_delay = np.finfo(f32).max

    out = np.zeros((n_cells, 2), dtype=f32)

    for index in range(n_cells):
        loudness = occlusion[index]
        next_index = index
        delay = max_delay

        while (delay > f32(CONSTANTS.delay_close_threshold)
               and loudness < f32(CONSTANTS.distance_gain_threshold)):
            r = next_index // gx
            c = next_index % gx
            next_loudness = f32(0.0)
            next_delay = max_delay
            for dr, dc in _NEIGHBORS:
                nr, nc = r + dr, c + dc
                if nr < 0 or nc < 0 or nr >= gx or nc >= gy:
                    continue
                npos = nr * gx + nc
                d = delay_samples[npos]
                # C++: (unsigned)delay == numSamples || occlusion == 0 -> skip;
                # delay==FLT_MAX neighbors also never win the d < next_delay
                # comparison below, so the max-delay case needs no special path.
                if occlusion[npos] == 0.0:
                    continue
                if d < next_delay and occlusion[npos] > 0.0:
                    next_loudness = occlusion[npos]
                    # literal C++: nextIndex is committed HERE, inside the
                    # scan — so the non-improving break below still leaves
                    # the walk at the best neighbor (Analyzer.cpp:375-385)
                    next_index = npos
                    next_delay = d
            if next_delay == max_delay or next_delay >= delay:
                break
            delay = next_delay
            loudness = next_loudness

            geodesic = f32(CONSTANTS.c) * next_delay / fs
            r2 = next_index // gx
            c2 = next_index % gx
            ex = f32(r2) * f32(p.dx)
            ey = f32(c2) * f32(p.dx)
            dxv = ex - lwx
            dyv = ey - lwz
            euclid = np.sqrt(dxv * dxv + dyv * dyv, dtype=f32)
            if abs(geodesic - euclid) < threshold_dist:
                break

        r = next_index // gx
        c = next_index % gx
        ex = f32(r) * f32(p.dx)
        ey = f32(c) * f32(p.dx)
        ox = ex - lwx
        oy = ey - lwz
        length = ox * ox + oy * oy
        if length != 0.0:
            length = np.sqrt(length, dtype=f32)
            ox = ox / length
            oy = oy / length
        out[index] = (ox, oy)

    return out
