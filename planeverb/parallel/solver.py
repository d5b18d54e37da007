"""Spatially sharded FDTD solver — shard_map + ppermute halo exchange.

Scaling design with no reference analog (the C++ engine is single process —
SURVEY.md §2). The [nx, ny] pressure/velocity fields are split into
per-device blocks over a 2D ("x", "y") mesh. Neighboring shards exchange
halo slabs with ``lax.ppermute`` (XLA hands them to the collective library
of the platform — NCCL over NVLink on GPUs), fused by XLA around the local
stencil:

  - pressure update needs vx at i+1 / vy at j+1  → forward halos
  - velocity update needs p (and beta/Y) at i-1 / j-1 → backward halos

beta/Y are static per simulation, so their backward halos are exchanged once
before the timestep loop. The outer-edge impedance ABC and the reciprocal
source injection are expressed as global-index masks, making every shard's
program identical (SPMD), with semantics matching ops/fdtd.py exactly
(reference: ProjectPlaneverb/src/FDTD/FDTD.cpp:87-236).

Fields are zero-padded up to mesh-divisible shapes; padding carries beta = 0
(solid), which provably stays silent under the update rules, so the padded
solve restricted to the real region equals the unpadded solve.

:func:`pipeline_sharded` is the engine's multi-device pass: the k-step
wide-halo solver (:func:`simulate_sharded_wide`), the analyzer moments of
each shard's own recording (no cross-device traffic), and the parameter
assembly on the cropped global grids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from planeverb.config import BoundaryType, GridParams
from planeverb.ops import analyzer
from planeverb.ops.fdtd import (FdtdResult, admittance,
                                stencil_coefficients)

__all__ = ["simulate_sharded", "simulate_sharded_wide", "shard_fields",
           "simulate_moments_sharded", "pipeline_sharded"]


def _shift_from_prev(x, axis_name, axis):
    """Roll +1 along ``axis``: out[i] = x[i-1], first slot from the previous
    shard's last slice (zeros at the global edge)."""
    n = jax.lax.axis_size(axis_name)
    last = jax.lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)
    if n > 1:
        last = jax.lax.ppermute(last, axis_name,
                                [(i, i + 1) for i in range(n - 1)])
    else:
        last = jnp.zeros_like(last)
    body = jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)
    return jnp.concatenate([last, body], axis=axis)


def _shift_from_next(x, axis_name, axis):
    """Roll -1 along ``axis``: out[i] = x[i+1], last slot from the next
    shard's first slice (zeros at the global edge)."""
    n = jax.lax.axis_size(axis_name)
    first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    if n > 1:
        first = jax.lax.ppermute(first, axis_name,
                                 [(i + 1, i) for i in range(n - 1)])
    else:
        first = jnp.zeros_like(first)
    body = jax.lax.slice_in_dim(x, 1, x.shape[axis], axis=axis)
    return jnp.concatenate([body, first], axis=axis)


def shard_fields(mesh: Mesh, *arrays):
    """Place [nx, ny] arrays with ("x", "y") PartitionSpec on the mesh."""
    sharding = NamedSharding(mesh, P("x", "y"))
    return tuple(jax.device_put(a, sharding) for a in arrays)


@functools.partial(jax.jit, static_argnames=("params", "mesh", "nx_pad",
                                             "ny_pad"))
def simulate_sharded(params: GridParams, beta, refl, pulse,
                     listener_ix, listener_iy, mesh: Mesh,
                     nx_pad: int, ny_pad: int) -> FdtdResult:
    """Run one simulation pass sharded over ``mesh``.

    Args:
      params: static grid parameters (unpadded semantics).
      beta, refl: [nx_pad, ny_pad] fields, padded with beta=0 outside
        [0:nx, 0:ny] (see parallel.mesh.pad_to_mesh).
      pulse: [T] source pulse.
      listener_ix, listener_iy: listener cell (traced int32).
      nx_pad, ny_pad: static padded dims, divisible by the mesh shape.

    Returns FdtdResult with padded [T, nx_pad, ny_pad] pressure and
    [nx_pad, ny_pad] onset/flux grids (crop to params.nx/ny for analysis).
    """
    gx, gy = params.grid_x, params.grid_y
    courant = jnp.float32(params.courant)
    thr = jnp.float32(params.constants.audible_threshold_gain)
    src_dir_n = jnp.float32(params.source_dir_samples)
    absorbing = params.boundary_type == BoundaryType.ABSORBING
    T = params.response_length
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    bx = nx_pad // mx
    by = ny_pad // my

    def local_sim(beta, Y, pulse, lix, liy):
        px = jax.lax.axis_index("x")
        py = jax.lax.axis_index("y")
        gi = (px * bx + jax.lax.broadcasted_iota(jnp.int32, (bx, by), 0))
        gj = (py * by + jax.lax.broadcasted_iota(jnp.int32, (bx, by), 1))

        # static backward halos for the wall admittance cross terms, folded
        # (with the edge ABC) into per-cell stencil coefficients once
        b_xm = _shift_from_prev(beta, "x", 0)
        y_xm = _shift_from_prev(Y, "x", 0)
        b_ym = _shift_from_prev(beta, "y", 1)
        y_ym = _shift_from_prev(Y, "y", 1)
        a_x, b_x, d_x, a_y, b_y, d_y = stencil_coefficients(
            beta, Y, b_xm, y_xm, b_ym, y_ym, gi, gj, gx, gy, absorbing)

        src_mask = ((gi == lix) & (gj == liy)).astype(jnp.float32)

        p0 = jnp.zeros((bx, by), jnp.float32)
        onset0 = jnp.full((bx, by), jnp.inf, jnp.float32)

        def step(carry, xt):
            p, vx, vy, onset, fx, fy = carry
            t, pulse_t = xt

            # -- pressure: p = beta * (p - C * div v)    (FDTD.cpp:124-141)
            vx_xp = _shift_from_next(vx, "x", 0)
            vy_yp = _shift_from_next(vy, "y", 1)
            div = (vx_xp - vx) + (vy_yp - vy)
            p = beta * (p - courant * div)

            # -- velocities: walls + edge ABC prefolded  (FDTD.cpp:143-223)
            p_xm = _shift_from_prev(p, "x", 0)
            air = vx - courant * (p - p_xm)
            vx = a_x * air + b_x * p + d_x * p_xm

            p_ym = _shift_from_prev(p, "y", 1)
            air = vy - courant * (p - p_ym)
            vy = a_y * air + b_y * p + d_y * p_ym

            # -- streaming onset + directivity flux (ops/fdtd.py semantics)
            tf = t.astype(jnp.float32)
            onset = jnp.minimum(onset, jnp.where(jnp.abs(p) > thr, tf, jnp.inf))
            m = (tf < onset + src_dir_n).astype(jnp.float32)
            fx = fx + m * p * vx
            fy = fy + m * p * vy

            rec = p  # record pre-injection (reciprocity source at listener)
            p = p + src_mask * pulse_t
            return (p, vx, vy, onset, fx, fy), rec

        ts = jnp.arange(T, dtype=jnp.int32)
        (_, _, _, onset, fx, fy), pressure = jax.lax.scan(
            step, (p0, p0, p0, onset0, p0, p0), (ts, pulse))
        return pressure, onset, fx, fy

    shard = functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("x", "y"), P("x", "y"), P(), P(), P()),
        out_specs=(P(None, "x", "y"), P("x", "y"), P("x", "y"), P("x", "y")),
        check_vma=False,
    )
    Y = admittance(refl)
    pressure, onset, fx, fy = shard(local_sim)(
        beta, Y, pulse, listener_ix, listener_iy)
    return FdtdResult(pressure=pressure, onset=onset, flux_x=fx, flux_y=fy)


def _from_prev(slab, axis_name):
    """Neighbor slab from the previous shard along ``axis_name`` (zeros at
    the global edge / on a size-1 axis)."""
    n = jax.lax.axis_size(axis_name)
    if n > 1:
        return jax.lax.ppermute(slab, axis_name,
                                [(i, i + 1) for i in range(n - 1)])
    return jnp.zeros_like(slab)


def _from_next(slab, axis_name):
    n = jax.lax.axis_size(axis_name)
    if n > 1:
        return jax.lax.ppermute(slab, axis_name,
                                [(i + 1, i) for i in range(n - 1)])
    return jnp.zeros_like(slab)


def _exchange_axes(x, kx, ky, axis_name_x="x", axis_name_y="y"):
    """Per-axis ghost exchange: extend a [bx, by] block by ``kx``/``ky``
    neighbor ghost cells per side (width 0 skips the axis entirely). The y
    phase runs second so it carries the corners when both widths are
    nonzero — which the k-step diamond dependency cone needs. Missing
    neighbors (global edges) fill with zeros, matching the zero padding of
    the single-device solver."""
    if kx:
        top = _from_prev(x[-kx:], axis_name_x)        # prev's last rows
        bot = _from_next(x[:kx], axis_name_x)         # next's first rows
        x = jnp.concatenate([top, x, bot], axis=0)
    if ky:
        left = _from_prev(x[:, -ky:], axis_name_y)    # incl. corners
        right = _from_next(x[:, :ky], axis_name_y)
        x = jnp.concatenate([left, x, right], axis=1)
    return x


def _exchange_halo(x, halo, axis_name_x="x", axis_name_y="y"):
    """Symmetric form of :func:`_exchange_axes`: [bx, by] -> [bx+2h, by+2h]."""
    return _exchange_axes(x, halo, halo, axis_name_x, axis_name_y)


@functools.partial(jax.jit, static_argnames=("params", "mesh", "nx_pad",
                                             "ny_pad", "halo"))
def simulate_sharded_wide(params: GridParams, beta, refl, pulse,
                          listener_ix, listener_iy, mesh: Mesh,
                          nx_pad: int, ny_pad: int,
                          halo: int = 8) -> FdtdResult:
    """Sharded solver with multi-step halo widening.

    Instead of four one-cell ppermutes per timestep (simulate_sharded),
    each shard extends its block with ``halo``-cell ghost regions (corners
    included), runs ``halo`` timesteps purely locally, then re-exchanges:
    the per-step stencil radius is one cell, so a k-wide ghost stays exact
    for k steps. Collective count drops k-fold at the cost of
    O(k * perimeter) redundant compute — the standard latency/compute
    trade for small per-step grids. Results are bit-identical per shape to
    simulate_sharded up to f32 reduction order (golden-tested).

    Global-index masks make ghost cells evolve exactly like their owning
    shard's real cells (same ABC rows, same source injection), which is
    what keeps the ghost region valid between exchanges.
    """
    gx, gy = params.grid_x, params.grid_y
    courant = jnp.float32(params.courant)
    thr = jnp.float32(params.constants.audible_threshold_gain)
    src_dir_n = jnp.float32(params.source_dir_samples)
    absorbing = params.boundary_type == BoundaryType.ABSORBING
    T = params.response_length
    k = halo
    rounds = -(-T // k)
    T_pad = rounds * k
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    bx = nx_pad // mx
    by = ny_pad // my
    if k > bx or k > by:
        raise ValueError(f"halo {k} exceeds shard block ({bx}, {by})")

    def local_sim(beta, Y, pulse, lix, liy):
        px = jax.lax.axis_index("x")
        py = jax.lax.axis_index("y")
        # global coordinates of the *extended* block
        gi = (px * bx - k
              + jax.lax.broadcasted_iota(jnp.int32, (bx + 2 * k, by + 2 * k), 0))
        gj = (py * by - k
              + jax.lax.broadcasted_iota(jnp.int32, (bx + 2 * k, by + 2 * k), 1))

        beta_e = _exchange_halo(beta, k)
        y_e = _exchange_halo(Y, k)
        zrow = jnp.zeros((1, by + 2 * k), jnp.float32)
        zcol = jnp.zeros((bx + 2 * k, 1), jnp.float32)
        b_xm = jnp.concatenate([zrow, beta_e[:-1]], axis=0)
        y_xm = jnp.concatenate([zrow, y_e[:-1]], axis=0)
        b_ym = jnp.concatenate([zcol, beta_e[:, :-1]], axis=1)
        y_ym = jnp.concatenate([zcol, y_e[:, :-1]], axis=1)
        # walls + edge ABC folded once on the k-extended block; the in-block
        # shift artifacts on the ghost fringe rows are discarded by the
        # k-step halo argument, same as the unfolded form was
        a_x, b_x, d_x, a_y, b_y, d_y = stencil_coefficients(
            beta_e, y_e, b_xm, y_xm, b_ym, y_ym, gi, gj, gx, gy, absorbing)

        src_mask = ((gi == lix) & (gj == liy)).astype(jnp.float32)
        interior = (slice(k, k + bx), slice(k, k + by))

        z_int = jnp.zeros((bx, by), jnp.float32)

        def one_round(carry, xt):
            p_i, vx_i, vy_i, onset, fx, fy = carry
            t0, pulse_k = xt            # t0 scalar, pulse_k [k]

            p = _exchange_halo(p_i, k)
            vx = _exchange_halo(vx_i, k)
            vy = _exchange_halo(vy_i, k)

            def one_step(s, st):
                p, vx, vy, onset, fx, fy, recs = st
                t = t0 + s

                vx_xp = jnp.concatenate([vx[1:], zrow], axis=0)
                vy_yp = jnp.concatenate([vy[:, 1:], zcol], axis=1)
                div = (vx_xp - vx) + (vy_yp - vy)
                p = beta_e * (p - courant * div)

                p_xm = jnp.concatenate([zrow, p[:-1]], axis=0)
                air = vx - courant * (p - p_xm)
                vx = a_x * air + b_x * p + d_x * p_xm

                p_ym = jnp.concatenate([zcol, p[:, :-1]], axis=1)
                air = vy - courant * (p - p_ym)
                vy = a_y * air + b_y * p + d_y * p_ym

                tf = t.astype(jnp.float32)
                live = tf < float(T)
                p_int = p[interior]
                onset = jnp.minimum(
                    onset,
                    jnp.where(live & (jnp.abs(p_int) > thr), tf, jnp.inf))
                m = ((tf < onset + src_dir_n) & live).astype(jnp.float32)
                fx = fx + m * p_int * vx[interior]
                fy = fy + m * p_int * vy[interior]

                recs = recs.at[s].set(p_int)
                p = p + src_mask * pulse_k[s]
                return p, vx, vy, onset, fx, fy, recs

            recs0 = jnp.zeros((k, bx, by), jnp.float32)
            p, vx, vy, onset, fx, fy, recs = jax.lax.fori_loop(
                0, k, one_step, (p, vx, vy, onset, fx, fy, recs0))
            new_carry = (p[interior], vx[interior], vy[interior],
                         onset, fx, fy)
            return new_carry, recs

        onset0 = jnp.full((bx, by), jnp.inf, jnp.float32)
        t0s = jnp.arange(rounds, dtype=jnp.int32) * k
        pulse_pad = jnp.zeros(T_pad, jnp.float32).at[:T].set(pulse)
        pulse_rounds = pulse_pad.reshape(rounds, k)
        (_, _, _, onset, fx, fy), recs = jax.lax.scan(
            one_round, (z_int, z_int, z_int, onset0, z_int, z_int),
            (t0s, pulse_rounds))
        pressure = recs.reshape(T_pad, bx, by)[:T]
        return pressure, onset, fx, fy

    shard = functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("x", "y"), P("x", "y"), P(), P(), P()),
        out_specs=(P(None, "x", "y"), P("x", "y"), P("x", "y"), P("x", "y")),
        check_vma=False,
    )
    Y = admittance(refl)
    pressure, onset, fx, fy = shard(local_sim)(
        beta, Y, pulse, listener_ix, listener_iy)
    return FdtdResult(pressure=pressure, onset=onset, flux_x=fx, flux_y=fy)


@functools.partial(jax.jit, static_argnames=("params", "mesh", "nx_pad",
                                             "ny_pad", "halo"))
def simulate_moments_sharded(params: GridParams, beta, refl, pulse,
                             listener_ix, listener_iy, mesh: Mesh,
                             nx_pad: int, ny_pad: int, halo: int = 8):
    """Sharded sim + analyzer moments.

    Returns (FdtdResult, analyzer.Moments) with every grid padded to
    [nx_pad, ny_pad]: :func:`simulate_sharded_wide`, then
    ``analyzer.moments_from_pressure`` on each shard's own [T, bx, by]
    recording under ``shard_map`` (the moments are per cell, so no
    cross-device traffic).
    """
    res = simulate_sharded_wide(params, beta, refl, pulse, listener_ix,
                                listener_iy, mesh, nx_pad, ny_pad, halo=halo)
    moments = jax.shard_map(
        lambda pr, on: analyzer.moments_from_pressure(params, pr, on),
        mesh=mesh, in_specs=(P(None, "x", "y"), P("x", "y")),
        out_specs=P("x", "y"), check_vma=False)(res.pressure, res.onset)
    return res, moments


def pipeline_sharded(params: GridParams, beta, refl, pulse,
                     listener_ix, listener_iy, mesh: Mesh,
                     nx_pad: int, ny_pad: int, efree,
                     listener_x, listener_z, halo: int = 8,
                     compute_directions: bool = True):
    """Full multi-device pass: sharded sim + per-shard moments + parameter
    assembly. Returns (FdtdResult, AnalyzerResults) cropped to the grid —
    the multi-device analog of ops/pipeline.py::pipeline_auto."""
    res, moments = simulate_moments_sharded(
        params, beta, refl, pulse, listener_ix, listener_iy, mesh,
        nx_pad, ny_pad, halo=halo)
    nx, ny = params.nx, params.ny
    res = FdtdResult(pressure=res.pressure[:, :nx, :ny],
                     onset=res.onset[:nx, :ny], flux_x=res.flux_x[:nx, :ny],
                     flux_y=res.flux_y[:nx, :ny])
    moments = jax.tree.map(lambda a: a[:nx, :ny], moments)
    out = analyzer.analyze_moments(
        params, moments, res.onset, res.flux_x, res.flux_y, efree,
        listener_x, listener_z, compute_directions=compute_directions)
    return res, out
