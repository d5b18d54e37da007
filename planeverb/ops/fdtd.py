"""2D FDTD acoustic wave solver — JAX reference implementation.

Vectorized re-design of the reference solver (semantics per
/root/reference ProjectPlaneverb/src/FDTD/FDTD.cpp:87-236):

  - SoA fields ``p/vx/vy`` as [nx, ny] float32 device arrays (the reference
    uses a 16-byte AoS ``Cell`` grid, PvTypes.h:106-121).
  - One fused update per timestep under ``lax.scan``: pressure, both velocity
    components with wall-admittance terms, first-order impedance absorbing
    edges, recording, and source injection at the *listener* cell (acoustic
    reciprocity: one sim yields the IR from every source cell to the listener).
  - Only the pressure field is recorded to HBM ([T, nx, ny] — 4 B/cell/step vs
    the reference's 16 B Cell record, FDTD.cpp:225-231). The analyzer
    quantities that need velocity (source-directivity flux, Analyzer.cpp:
    178-220) are accumulated *inside* the scan so vx/vy never touch HBM.
  - Onset delay (first |p| > -110 dB threshold, Analyzer.cpp:146-165) is also
    tracked in-scan as a streaming min.

The reference's flat-index loops wrap across row ends and read out of range;
all of those accesses are provably masked by ``beta == 0`` cells or
overwritten by the edge ABC before use, so this clean 2D formulation is
exactly equivalent (verified against the literal-semantics oracle in
tests/oracle.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from planeverb.config import BoundaryType, GridParams

__all__ = ["FdtdResult", "fdtd_step", "simulate", "admittance",
           "stencil_coefficients", "coefficients_from_fields", "fdtd_step_folded",
           "SCAN_UNROLL"]

# timesteps per iteration of the scan's loop: on an H100 the best of 4, 8
# and 16 at the 459^2 x 1470 grid and within 8 % of the best at 192^2 x 1187
# (PERF.md); fewer loop trips are where the scan's time goes there
SCAN_UNROLL = 8


class FdtdResult(NamedTuple):
    """Output of one simulation pass.

    pressure: [T, nx, ny] recorded pressure field (the impulse responses)
    onset:    [nx, ny] first sample where |p| crossed the audible threshold
              (float32; +inf where never crossed)
    flux_x:   [nx, ny] sum of p*vx over the source-directivity window
    flux_y:   [nx, ny] sum of p*vy over the source-directivity window
    """

    pressure: jax.Array
    onset: jax.Array
    flux_x: jax.Array
    flux_y: jax.Array


def admittance(reflection: jax.Array) -> jax.Array:
    """Wall admittance Y = (1-R)/(1+R) from reflection coefficient R
    (FDTD.cpp:158-159)."""
    return (1.0 - reflection) / (1.0 + reflection)


def stencil_coefficients(beta, Y, b_xm, y_xm, b_ym, y_ym, gi, gj,
                         gx: int, gy: int, absorbing: bool = True):
    """Fold wall admittance AND the outer-edge impedance ABC into six static
    per-cell coefficients, so each velocity update is three multiply-adds:

        air = v - C * (p - p_m)
        v'  = A * air + B * p + D * p_m

    At every cell at most one of the reference's update paths is active
    (interior / wall-left / wall-right / edge ABC, FDTD.cpp:143-223), and the
    gating masks are exact 0/1 floats, so this factoring is bit-identical to
    evaluating the branchy form (products with 0/±1 are exact; adding a
    signed zero to the single live term is exact).

    Args:
      beta, Y: [.., ..] air flags and admittance (possibly tile-padded).
      b_xm/y_xm/b_ym/y_ym: beta/Y shifted one cell back along x/y (zeros
        shifted in at the global edge) — built by the caller because the
        shift differs per backend (pad, concatenate, or ppermute halo).
      gi, gj: *global* integer cell coordinates per array slot.
      gx, gy: analysis-grid dims (edge rows/cols of the update, static).
    """
    w_x = (b_xm - beta) * (beta * y_xm + b_xm * Y)
    a_x = beta * b_xm
    bc_x = w_x * beta
    d_x = w_x * b_xm
    w_y = (b_ym - beta) * (beta * y_ym + b_ym * Y)
    a_y = beta * b_ym
    bc_y = w_y * beta
    d_y = w_y * b_ym

    row0 = gi == 0
    rowg = gi == gx
    col0 = gj == 0
    colg = gj == gy
    if absorbing:
        # first-order impedance ABC: v = -p on the leading edge, v = +p_m on
        # the trailing edge, masked to the in-grid span (FDTD.cpp:201-223)
        in_gy = (gj < gy).astype(jnp.float32)
        in_gx = (gi < gx).astype(jnp.float32)
        eb_x, ed_x = -in_gy, in_gy
        eb_y, ed_y = -in_gx, in_gx
    else:
        # rigid (fully reflecting) outer walls: v = 0. The reference declares
        # pv_ReflectingBoundary but never implements it (PvTypes.h:33-36).
        zero = jnp.zeros_like(beta)
        eb_x = ed_x = eb_y = ed_y = zero
    a_x = jnp.where(row0 | rowg, 0.0, a_x)
    b_x = jnp.where(row0, eb_x, jnp.where(rowg, 0.0, bc_x))
    d_x = jnp.where(rowg, ed_x, jnp.where(row0, 0.0, d_x))
    a_y = jnp.where(col0 | colg, 0.0, a_y)
    b_y = jnp.where(col0, eb_y, jnp.where(colg, 0.0, bc_y))
    d_y = jnp.where(colg, ed_y, jnp.where(col0, 0.0, d_y))
    return a_x, b_x, d_x, a_y, b_y, d_y


def coefficients_from_fields(beta, Y, gx: int, gy: int, absorbing: bool):
    """stencil_coefficients for the single-array layout (array coordinates
    are global coordinates; backward shifts are zero-padded slices)."""
    b_xm = jnp.pad(beta[:-1], ((1, 0), (0, 0)))
    y_xm = jnp.pad(Y[:-1], ((1, 0), (0, 0)))
    b_ym = jnp.pad(beta[:, :-1], ((0, 0), (1, 0)))
    y_ym = jnp.pad(Y[:, :-1], ((0, 0), (1, 0)))
    gi = jax.lax.broadcasted_iota(jnp.int32, beta.shape, 0)
    gj = jax.lax.broadcasted_iota(jnp.int32, beta.shape, 1)
    return stencil_coefficients(beta, Y, b_xm, y_xm, b_ym, y_ym, gi, gj,
                                gx, gy, absorbing)


def fdtd_step_folded(p, vx, vy, beta, coefs, courant: float):
    """One fused FDTD timestep with prefolded coefficients. Returns
    (p, vx, vy) post-update, post-edge-ABC (the ABC lives in ``coefs``)."""
    a_x, b_x, d_x, a_y, b_y, d_y = coefs

    # -- pressure update: p = beta * (p - C * div v)   (FDTD.cpp:124-141)
    vx_xp = jnp.pad(vx[1:], ((0, 1), (0, 0)))
    vy_yp = jnp.pad(vy[:, 1:], ((0, 0), (0, 1)))
    div = (vx_xp - vx) + (vy_yp - vy)
    p = beta * (p - courant * div)

    # -- velocity updates incl. walls and edge ABC     (FDTD.cpp:143-223)
    p_xm = jnp.pad(p[:-1], ((1, 0), (0, 0)))
    air = vx - courant * (p - p_xm)
    vx = a_x * air + b_x * p + d_x * p_xm

    p_ym = jnp.pad(p[:, :-1], ((0, 0), (1, 0)))
    air = vy - courant * (p - p_ym)
    vy = a_y * air + b_y * p + d_y * p_ym
    return p, vx, vy


def fdtd_step(p, vx, vy, beta, Y, courant: float, gx: int, gy: int,
              absorbing: bool = True):
    """One fused FDTD timestep. Returns (p, vx, vy) post-update, post-edge-ABC.

    beta is the air flag (1 air / 0 wall) as float32; Y the admittance field.
    gx, gy are the analysis-grid dims (nx-1, ny-1), static. Convenience
    wrapper: refolds the static coefficients every call — inside a timestep
    loop, fold once with ``stencil_coefficients`` and use
    :func:`fdtd_step_folded`.
    """
    coefs = coefficients_from_fields(beta, Y, gx, gy, absorbing)
    return fdtd_step_folded(p, vx, vy, beta, coefs, courant)


@functools.partial(jax.jit, static_argnames=("params",))
def simulate(params: GridParams, beta, reflection, pulse,
             listener_ix, listener_iy) -> FdtdResult:
    """Run one full simulation pass (GenerateResponse analog).

    Args:
      params: static grid parameters.
      beta: [nx, ny] float32 air flags.
      reflection: [nx, ny] float32 reflection coefficients R.
      pulse: [T] float32 source pulse.
      listener_ix, listener_iy: listener cell indices (traced int32 scalars).
    """
    nx, ny = params.nx, params.ny
    gx, gy = params.grid_x, params.grid_y
    courant = params.courant
    thr = jnp.float32(params.constants.audible_threshold_gain)
    src_dir_n = jnp.float32(params.source_dir_samples)
    absorbing = params.boundary_type == BoundaryType.ABSORBING

    Y = admittance(reflection)
    coefs = coefficients_from_fields(beta, Y, gx, gy, absorbing)

    p0 = jnp.zeros((nx, ny), jnp.float32)
    v0 = jnp.zeros((nx, ny), jnp.float32)
    onset0 = jnp.full((nx, ny), jnp.inf, jnp.float32)
    flux0 = jnp.zeros((nx, ny), jnp.float32)

    def step(carry, xt):
        p, vx, vy, onset, fx, fy = carry
        t, pulse_t = xt
        p, vx, vy = fdtd_step_folded(p, vx, vy, beta, coefs, courant)

        # streaming onset: first threshold crossing of the *recorded* pressure
        tf = t.astype(jnp.float32)
        onset = jnp.minimum(onset, jnp.where(jnp.abs(p) > thr, tf, jnp.inf))

        # streaming source-directivity flux over [0, onset + src_dir_n)
        # (Analyzer.cpp:178-193; inf onset => window still open)
        m = (tf < onset + src_dir_n).astype(jnp.float32)
        fx = fx + m * p * vx
        fy = fy + m * p * vy

        rec = p  # record after edge ABC, before source injection
        p = p.at[listener_ix, listener_iy].add(pulse_t)
        return (p, vx, vy, onset, fx, fy), rec

    ts = jnp.arange(params.response_length, dtype=jnp.int32)
    (_, _, _, onset, fx, fy), pressure = jax.lax.scan(
        step, (p0, v0, v0, onset0, flux0, flux0), (ts, pulse),
        unroll=SCAN_UNROLL)

    return FdtdResult(pressure=pressure, onset=onset, flux_x=fx, flux_y=fy)
