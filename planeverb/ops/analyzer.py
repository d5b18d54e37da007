"""Acoustic parameter encoder — vectorized analysis post-pass.

Vectorized re-design of the reference's per-cell scan loops
(/root/reference ProjectPlaneverb/src/DSP/Analyzer.cpp:139-328): every stage
becomes a masked reduction over the recorded [T, nx, ny] pressure tensor,
vmapped/vectorized across all cells at once:

  - onset delay:        streaming min from the solver (Analyzer.cpp:146-165)
  - obstruction:        sqrt(Edry / (EFree/r)) with Edry a masked windowed
                        energy sum (Analyzer.cpp:170-219)
  - source directivity: -normalized flux, accumulated in-scan by the solver
                        (Analyzer.cpp:178-220)
  - lowpass cutoff:     -147 + 18390/(1+(r/12)^0.8) (Analyzer.cpp:226-230)
  - wet gain:           sqrt(Ewet/E1m) over 80 ms post-dry (Analyzer.cpp:234-247)
  - RT60:               backward Schroeder integral via reverse cumsum + the
                        closed-form regression (Analyzer.cpp:250-327)

Direction-of-arrival (pass 2) lives in ops/doa.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from planeverb.config import GridParams
from planeverb.ops.doa import encode_directions

__all__ = ["AnalyzerResults", "Moments", "analyze", "analyze_moments",
           "moments_from_pressure", "free_field_normalizer"]


class AnalyzerResults(NamedTuple):
    """Per-cell acoustic parameters over the [grid_x, grid_y] analysis grid.

    Mirrors AnalyzerResult (Analyzer.h:13-21) as SoA device arrays.
    """

    occlusion: jax.Array           # [gx, gy] obstruction gain
    wet_gain: jax.Array            # [gx, gy]
    rt60: jax.Array                # [gx, gy] seconds
    lowpass: jax.Array             # [gx, gy] cutoff Hz
    direction: jax.Array           # [gx, gy, 2] listener-relative DOA
    source_directivity: jax.Array  # [gx, gy, 2] radiated unit vector
    delay_samples: jax.Array       # [gx, gy] onset (f32; +inf if none)


def free_field_normalizer(params: GridParams, listener_ix, listener_iy):
    """Per-cell EFree/r denominators (FreeGrid::GetEFreePerR, FreeGrid.cpp:41-59).

    Returns [gx, gy] of 1/r falloff factors (r in meters between cell and the
    listener *cell* indices); the caller multiplies by the calibrated EFree.
    r == 0 cells use falloff 1 (the reference returns EFree unchanged).
    """
    gx, gy = params.grid_x, params.grid_y
    dx = jnp.float32(params.dx)
    rr = jax.lax.broadcasted_iota(jnp.int32, (gx, gy), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (gx, gy), 1)
    # Distance in integer index space: ``i*dx - lix*dx`` in floats invites an
    # XLA FMA fusion that leaves a tiny nonzero residue at the listener cell,
    # blowing up 1/r — the integer difference keeps the r==0 test exact.
    di = (rr - listener_ix).astype(jnp.float32)
    dj = (cc - listener_iy).astype(jnp.float32)
    r = jnp.sqrt(di * di + dj * dj) * dx
    at_listener = (rr == listener_ix) & (cc == listener_iy)
    return jnp.where(at_listener, 1.0, 1.0 / jnp.where(at_listener, 1.0, r))


class Moments(NamedTuple):
    """Sufficient statistics of one recording for parameter assembly.

    All [*, *] per-cell grids (possibly tile-padded; assembly crops):
      e_dry:   energy over [0, onset + dry_n)
      e_wet:   energy over [onset + dry_n + 1, + wet_n)
      e_total: total recorded energy (EDC[0])
      s0:      sum of y_db over the RT60 regression window
      s1:      sum of (t - start) * y_db over the window, start the per-cell
               window origin (onset + dry_n + 1; final by the time the
               window opens, so streaming accumulation is exact and avoids
               the catastrophic cancellation of absolute-t moments)
    where y_db[t] = 10 log10(max(EDC[t], 1e-37)).

    These are exactly the reductions the reference's per-cell scans compute
    (Analyzer.cpp:181-196, 234-247, 250-327); computing them *streaming*
    (during the sim, or in one pass over the recording) is exact because
    every window condition at time t depends only on whether onset <= t —
    and when it doesn't hold yet, the condition's truth value already equals
    its final value (onset >= t implies t < onset + dry_n, etc.).
    """

    e_dry: jax.Array
    e_wet: jax.Array
    e_total: jax.Array
    s0: jax.Array
    s1: jax.Array


def moments_from_pressure(params: GridParams, pressure, onset) -> Moments:
    """jnp reference computation of :class:`Moments` from a full recording.

    ``pressure`` is [>=T, ...] and ``onset`` [...] over any block of cells
    (the whole grid, or one shard's block inside ``shard_map``); the
    moments come back over the same cells. The blocked GPU kernel computes
    the same moments in one backward pass (ops/fdtd_blocked.py).
    """
    T = params.response_length
    dry_n = params.dry_gain_samples
    wet_n = params.wet_gain_samples
    schro_off = params.schroeder_offset_samples

    p = pressure[:T]

    sq = p * p
    t_idx = jax.lax.broadcasted_iota(
        jnp.int32, (T, 1, 1), 0).astype(jnp.float32)
    # inf onset (never crossed) keeps the dry window open and the wet/
    # regression windows closed — matching the in-kernel streaming form;
    # all moments of never-found cells are don't-care (masked by ``found``
    # in assembly).
    direct_end = onset + jnp.float32(dry_n)

    e_dry = jnp.sum(sq * (t_idx < direct_end), axis=0)
    wet_start = direct_end + 1.0
    wet_mask = (t_idx >= wet_start) & (t_idx < wet_start + jnp.float32(wet_n))
    e_wet = jnp.sum(sq * wet_mask, axis=0)
    e_total = jnp.sum(sq, axis=0)

    # EDC[t] = sum_{j>=t} sq[j] via *backward* accumulation. The forward
    # alternative (e_total - prefix[t]) catastrophically cancels in the
    # decay tail where EDC is hundreds of dB below e_total; the suffix sum
    # keeps full relative precision there (and matches the reference's
    # backward Schroeder integration order, Analyzer.cpp:250-327).
    edc = jnp.cumsum(sq[::-1], axis=0)[::-1]
    y_db = 10.0 * jnp.log10(jnp.maximum(edc, jnp.float32(1e-37)))
    start = direct_end + 1.0
    end = jnp.float32(T - schro_off)
    reg_mask = (t_idx >= start) & (t_idx < end)
    s0 = jnp.sum(jnp.where(reg_mask, y_db, 0.0), axis=0)
    s1 = jnp.sum(jnp.where(reg_mask, y_db * (t_idx - start), 0.0), axis=0)
    return Moments(e_dry=e_dry, e_wet=e_wet, e_total=e_total, s0=s0, s1=s1)


@functools.partial(jax.jit,
                   static_argnames=("params", "compute_directions"))
def analyze_moments(params: GridParams, moments: Moments, onset,
                    flux_x, flux_y, efree,
                    listener_x, listener_y,
                    compute_directions: bool = True) -> AnalyzerResults:
    """Assemble per-cell acoustic parameters from precomputed moments.

    Pure elementwise math on [gx, gy] grids plus the DOA pass — no [T, ...]
    traffic. Semantics per Analyzer.cpp:139-328 (see :func:`analyze`).
    """
    gx, gy = params.grid_x, params.grid_y
    T = params.response_length
    fs = jnp.float32(params.fs)
    dry_n = params.dry_gain_samples
    schro_off = params.schroeder_offset_samples

    lwx = listener_x + jnp.float32(params.grid_offset_x)
    lwy = listener_y + jnp.float32(params.grid_offset_y)

    onset = onset[:gx, :gy]
    fx = flux_x[:gx, :gy]
    fy = flux_y[:gx, :gy]
    e_dry = moments.e_dry[:gx, :gy]
    e_wet = moments.e_wet[:gx, :gy]
    s0 = moments.s0[:gx, :gy]
    s1 = moments.s1[:gx, :gy]

    found = jnp.isfinite(onset)
    onset_c = jnp.where(found, onset, 0.0)
    direct_end = onset_c + jnp.float32(dry_n)

    # -- obstruction = sqrt(Edry / (EFree/r))  (Analyzer.cpp:199-219)
    inv_dx = jnp.float32(1.0) / jnp.float32(params.dx)
    lix = (lwx * inv_dx).astype(jnp.int32)
    liy = (lwy * inv_dx).astype(jnp.int32)
    inv_r = free_field_normalizer(params, lix, liy)
    occlusion = jnp.sqrt(e_dry / (efree * inv_r))
    occlusion = jnp.where(found, occlusion, 0.0)

    # -- source directivity = -flux/|flux|  (Analyzer.cpp:222-228)
    norm = jnp.sqrt(fx * fx + fy * fy)
    inv_norm = -1.0 / jnp.where(norm > 0.0, norm, 1.0)
    sdir = jnp.stack([fx * inv_norm, fy * inv_norm], axis=-1)
    sdir = jnp.where(found[..., None], sdir, 0.0)

    # -- lowpass cutoff  (Analyzer.cpp:226-230)
    r_occ = 1.0 / jnp.maximum(0.001, occlusion)
    lowpass = -147.0 + 18390.0 / (1.0 + jnp.power(r_occ / 12.0, 0.8))
    lowpass = jnp.where(found, lowpass, 0.0)

    # -- wet gain  (Analyzer.cpp:234-247)
    wet_gain = jnp.where(found, jnp.sqrt(e_wet / efree), 0.0)

    # -- RT60 closed-form regression from the y_db moments
    #    (Analyzer.cpp:250-327); s1 is already accumulated against
    #    x_val = t - start.
    start = direct_end + 1.0
    end = jnp.float32(T - schro_off)
    rn = end - start
    # degenerate regression window (onset too close to the end of the
    # recording): fewer than two samples -> no defined slope. The reference
    # divides by zero here (UB garbage into the output grid); emit the
    # no-reverb value 0 instead, like never-found cells.
    window_ok = rn > 1.0
    rn_s = jnp.where(window_ok, rn, 2.0)
    xmean = (rn_s - 1.0) * 0.5
    xsum = rn_s * xmean
    denom = (1.0 / 12.0) * rn_s * (rn_s * rn_s - 1.0)
    ysum = s0
    xysum = s1
    ymean = ysum / rn_s
    numerator = xysum - ymean * xsum - xmean * ysum + rn_s * xmean * ymean
    slope_db_per_sec = numerator / denom * fs
    rt60 = -60.0 / slope_db_per_sec
    rt60 = jnp.where(found & window_ok, rt60, 0.0)

    delay = jnp.where(found, onset, jnp.float32(jnp.finfo(jnp.float32).max))

    # -- pass 2: direction via parallel delay-field descent (ops/doa.py,
    # gather-free shift-select label propagation). For very large grids
    # Context can still defer this to lazy per-query host walks
    # (doa.walk_direction).
    if compute_directions:
        direction = encode_directions(params, occlusion, delay, lwx, lwy)
    else:
        direction = jnp.zeros((gx, gy, 2), jnp.float32)

    return AnalyzerResults(
        occlusion=occlusion, wet_gain=wet_gain, rt60=rt60, lowpass=lowpass,
        direction=direction, source_directivity=sdir, delay_samples=delay)


@functools.partial(jax.jit, static_argnames=("params",))
def analyze(params: GridParams, pressure, onset, flux_x, flux_y,
            efree, listener_x, listener_y) -> AnalyzerResults:
    """Encode per-cell acoustic parameters from one simulation pass.

    Args:
      params: static grid parameters.
      pressure: [T, nx, ny] recorded pressure (solver output).
      onset: [nx, ny] onset sample per cell (f32, +inf when none).
      flux_x, flux_y: [nx, ny] in-scan directivity flux sums.
      efree: scalar free-field energy at 1 m (calibration).
      listener_x, listener_y: listener world position (traced f32 scalars,
        grid offset NOT yet applied — applied here as in Analyzer.cpp:60-62).
    """
    moments = moments_from_pressure(params, pressure, onset)
    return analyze_moments(params, moments, onset, flux_x, flux_y,
                           efree, listener_x, listener_y)
