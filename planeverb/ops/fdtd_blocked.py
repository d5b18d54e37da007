"""Temporally blocked FDTD kernels for NVIDIA Hopper (Pallas, Triton route).

The ``lax.scan`` solver (ops/fdtd.py) runs about ten small XLA operations
per timestep, 435-2006 times a pass. At the headline grid one step's working
set is ~3 MB and sits in L2, so the pass is paid in launches and loop
overhead, not bandwidth. These kernels cut that:

  - :func:`simulate_blocked` advances ``STEPS`` timesteps per launch. Each
    program owns a tile of cells plus a ``STEPS``-cell ghost ring
    (``BLOCK = tile + 2 * STEPS``, a power of two as Triton requires), loads
    its block of p/vx/vy and the folded stencil coefficients once, and steps
    it ``STEPS`` times in registers. The stencil radius is one cell per
    step, so the ghost ring absorbs every value that is wrong for want of a
    neighbour; only the tile is written back. The neighbour shifts go
    through a small per-program workspace in global memory (L1-resident),
    fenced by block barriers. A pass is T/STEPS launches instead of ~3T
    fused XLA operations. Onset and the directivity flux accumulate in
    registers; the recording is written once.
  - :func:`moments_blocked` is the backward RT60 pass: each program owns a
    block of cells and walks t from T-1 down to 0 with the Schroeder EDC and
    the regression sums in registers (the backward order of
    Analyzer.cpp:250-327, see ops/analyzer.py), plus the three windowed
    energies. One read of the recording, no [T, nx, ny] temporaries.

Semantics equal ops/fdtd.py::simulate and analyzer.moments_from_pressure
(reference ProjectPlaneverb/src/FDTD/FDTD.cpp:87-236): same update order,
folded wall/edge coefficients, record-then-inject reciprocity source.

Layout: every field lives on a padded grid ``[nxp, nyp]`` with the real grid
at offset ``(origin, origin)``. The ring and the tail past the last real
cell carry beta = 0 and zero coefficients, so they stay exactly zero and
act as the reference's zero padding. Recordings are ``[rounds, B, STEPS,
nxp, nyp]`` (one slab per launch); Pallas switches to 64-bit offsets for
arrays over 4 GiB, which covers recordings past 2^31 elements.

The ``interpret`` flag runs the kernels in the Pallas interpreter (CPU tests);
the block barrier has no CPU lowering and programs run one at a time
there, so it is emitted only when compiling for the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from planeverb.config import BoundaryType, GridParams
from planeverb.ops import fdtd
from planeverb.ops.analyzer import Moments

__all__ = ["BlockedLayout", "blocked_layout", "simulate_blocked",
           "moments_blocked", "BLOCK", "STEPS", "TILE"]

# 32/8 measured fastest of the blocks and step counts tried on an H100
# (PERF.md); BLOCK must be a power of two larger than 2 * STEPS
BLOCK = 32         # rows and columns of one program's block
STEPS = 8          # timesteps per launch = ghost ring width
TILE = BLOCK - 2 * STEPS   # cells each program writes back per axis
UNROLL = 8         # launches per iteration of the launch loop
MOMENT_CELLS = 256  # cells per program of the backward moments pass


class BlockedLayout(NamedTuple):
    """Padded-grid geometry of one grid."""

    ntx: int       # programs along x
    nty: int       # programs along y
    nxp: int       # padded rows: ntx * TILE + 2 * STEPS
    nyp: int       # padded columns
    origin: int    # offset of the real grid inside the padded one
    rounds: int    # launches per pass
    t_pad: int     # rounds * STEPS


def blocked_layout(params: GridParams) -> BlockedLayout:
    ntx = -(-params.nx // TILE)
    nty = -(-params.ny // TILE)
    rounds = -(-params.response_length // STEPS)
    return BlockedLayout(ntx=ntx, nty=nty, nxp=ntx * TILE + 2 * STEPS,
                         nyp=nty * TILE + 2 * STEPS, origin=STEPS,
                         rounds=rounds, t_pad=rounds * STEPS)


def _pad_field(a, lay: BlockedLayout):
    o = lay.origin
    return jnp.pad(a, ((o, lay.nxp - o - a.shape[0]),
                       (o, lay.nyp - o - a.shape[1])))


def _sim_kernel(t0_ref, lc_ref, pulse_ref, beta_ref, ax_ref, bx_ref, dx_ref,
                ay_ref, by_ref, dy_ref, p_ref, vx_ref, vy_ref, on_ref,
                fx_ref, fy_ref,
                rec_ref, po_ref, vxo_ref, vyo_ref, ono_ref, fxo_ref, fyo_ref,
                wsp_ref, wsx_ref, wsy_ref,
                *, courant, thr, src_dir_n, t_real, ntx, nty, origin,
                interpret):
    b = pl.program_id(0)
    i = pl.program_id(1)
    j = pl.program_id(2)
    w = (b * ntx + i) * nty + j          # this program's workspace slot
    rows = pl.ds(i * TILE, BLOCK)
    cols = pl.ds(j * TILE, BLOCK)

    ii = jax.lax.broadcasted_iota(jnp.int32, (BLOCK, BLOCK), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (BLOCK, BLOCK), 1)
    # cells this program writes back: its tile, plus the outer ring on
    # the edge programs (ring cells are silent, so every cell of the
    # padded grid is written by exactly one program)
    keep = (((ii >= STEPS) | (i == 0))
            & ((ii < STEPS + TILE) | (i == ntx - 1))
            & ((jj >= STEPS) | (j == 0))
            & ((jj < STEPS + TILE) | (j == nty - 1)))
    src = (((i * TILE + ii - origin) == lc_ref[b, 0])
           & ((j * TILE + jj - origin) == lc_ref[b, 1])).astype(jnp.float32)

    beta = beta_ref[rows, cols]
    a_x, b_x, d_x = ax_ref[rows, cols], bx_ref[rows, cols], dx_ref[rows, cols]
    a_y, b_y, d_y = ay_ref[rows, cols], by_ref[rows, cols], dy_ref[rows, cols]
    t0 = t0_ref[0]

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    inner = (w, pl.ds(1, BLOCK), pl.ds(1, BLOCK))

    def shifted(ref, di, dj, mask):
        return plgpu.load(ref.at[w, pl.ds(1 + di, BLOCK), pl.ds(1 + dj, BLOCK)],
                          mask=mask, other=0.0)

    def one_step(s, carry):
        p, vx, vy, onset, fx, fy = carry
        t = t0 + s

        # -- pressure: p = beta * (p - C * div v)       (FDTD.cpp:124-141)
        wsx_ref[inner] = vx
        wsy_ref[inner] = vy
        barrier()
        vx_xp = shifted(wsx_ref, 1, 0, ii < BLOCK - 1)
        vy_yp = shifted(wsy_ref, 0, 1, jj < BLOCK - 1)
        div = (vx_xp - vx) + (vy_yp - vy)
        p = beta * (p - courant * div)

        # -- velocities: walls + edge ABC prefolded     (FDTD.cpp:143-223)
        wsp_ref[inner] = p
        barrier()
        p_xm = shifted(wsp_ref, -1, 0, ii >= 1)
        air = vx - courant * (p - p_xm)
        vx = a_x * air + b_x * p + d_x * p_xm
        p_ym = shifted(wsp_ref, 0, -1, jj >= 1)
        air = vy - courant * (p - p_ym)
        vy = a_y * air + b_y * p + d_y * p_ym

        # -- streaming onset + directivity flux (ops/fdtd.py semantics);
        # steps past the response length (the last launch's tail) count
        # for nothing
        tf = t.astype(jnp.float32)
        live = tf < float(t_real)
        onset = jnp.minimum(
            onset, jnp.where(live & (jnp.abs(p) > thr), tf, jnp.inf))
        m = ((tf < onset + src_dir_n) & live).astype(jnp.float32)
        fx = fx + m * p * vx
        fy = fy + m * p * vy

        # -- record (pre-injection), then inject at the listener cell
        plgpu.store(rec_ref.at[b, s, rows, cols], p, mask=keep)
        p = p + src * pulse_ref[t]
        return p, vx, vy, onset, fx, fy

    carry = (p_ref[b, rows, cols], vx_ref[b, rows, cols],
             vy_ref[b, rows, cols], on_ref[b, rows, cols],
             fx_ref[b, rows, cols], fy_ref[b, rows, cols])
    carry = jax.lax.fori_loop(0, STEPS, one_step, carry)
    for ref, val in zip((po_ref, vxo_ref, vyo_ref, ono_ref, fxo_ref, fyo_ref),
                        carry):
        plgpu.store(ref.at[b, rows, cols], val, mask=keep)


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def simulate_blocked(params: GridParams, beta, refl, pulse, lcells,
                     interpret: bool = False):
    """One simulation pass per listener cell of ``lcells`` ([B, 2] int32).

    Returns ``(rec, onset, flux_x, flux_y)`` on the padded layout of
    :func:`blocked_layout`: ``rec`` is ``[rounds, B, STEPS, nxp, nyp]``
    (flatten the first three axes of one listener for ``[t_pad, ...]``;
    rows past ``response_length`` hold harmless continued simulation), the
    rest ``[B, nxp, nyp]``.
    """
    lay = blocked_layout(params)
    B = lcells.shape[0]
    T = params.response_length

    Y = fdtd.admittance(refl)
    coefs = fdtd.coefficients_from_fields(
        beta, Y, params.grid_x, params.grid_y,
        params.boundary_type == BoundaryType.ABSORBING)
    fields = [_pad_field(jnp.asarray(a, jnp.float32), lay)
              for a in (beta, *coefs)]
    pulse_p = jnp.zeros(lay.t_pad, jnp.float32).at[:T].set(
        jnp.asarray(pulse, jnp.float32))
    lc = jnp.asarray(lcells, jnp.int32)

    kernel = functools.partial(
        _sim_kernel, courant=float(params.courant),
        thr=float(params.constants.audible_threshold_gain),
        src_dir_n=float(params.source_dir_samples), t_real=T, ntx=lay.ntx,
        nty=lay.nty, origin=lay.origin, interpret=interpret)
    state = jax.ShapeDtypeStruct((B, lay.nxp, lay.nyp), jnp.float32)
    ws = jax.ShapeDtypeStruct((B * lay.ntx * lay.nty, BLOCK + 2, BLOCK + 2),
                              jnp.float32)
    launch = pl.pallas_call(
        kernel,
        grid=(B, lay.ntx, lay.nty),
        out_shape=[jax.ShapeDtypeStruct((B, STEPS, lay.nxp, lay.nyp),
                                        jnp.float32),
                   state, state, state, state, state, state, ws, ws, ws],
        compiler_params=plgpu.CompilerParams(
            num_warps=4, num_stages=1),
        interpret=interpret,
        name="fdtd_blocked",
    )

    def one_round(carry, t0):
        rec, *new, _, _, _ = launch(t0.reshape(1), lc, pulse_p, *fields,
                                    *carry)
        return tuple(new), rec

    zeros = jnp.zeros(state.shape, jnp.float32)
    init = (zeros, zeros, zeros, jnp.full(state.shape, jnp.inf, jnp.float32),
            zeros, zeros)
    t0s = jnp.arange(lay.rounds, dtype=jnp.int32) * STEPS
    (_, _, _, onset, fx, fy), rec = jax.lax.scan(one_round, init, t0s,
                                                 unroll=UNROLL)
    return rec, onset, fx, fy


def _moments_kernel(on_ref, rec_ref, edry_ref, ewet_ref, etot_ref, s0_ref,
                    s1_ref, *, t_real, rounds, steps, dry_n, wet_n, schro_off,
                    cells, width):
    b = pl.program_id(0)
    c = pl.program_id(1)
    idx = c * width + jnp.arange(width, dtype=jnp.int32)
    ok = idx < cells
    # clamped indices keep every address in bounds (masked lanes re-read
    # the last cell), which the interpreter needs as much as the card
    src = jnp.minimum(idx, cells - 1)
    onset = plgpu.load(on_ref.at[b, src], mask=ok, other=jnp.inf)
    direct_end = onset + float(dry_n)
    start = direct_end + 1.0
    wet_end = start + float(wet_n)
    end = float(t_real - schro_off)
    db = float(10.0 / np.log(10.0))
    zero = jnp.zeros((width,), jnp.float32)

    def body(u, carry):
        # one recording slab per iteration, newest to oldest; the slab's
        # steps unroll (independent loads in flight), and steps past the
        # response length (the last slab's tail) count for nothing
        edc, e_dry, e_wet, s0, s1 = carry
        r = rounds - 1 - u
        for s in reversed(range(steps)):
            t = r * steps + s
            tf = t.astype(jnp.float32)
            p = plgpu.load(rec_ref.at[r, b, s, src])
            sq = jnp.where(t < t_real, p * p, 0.0)
            edc = edc + sq                   # suffix sum incl. t
            e_dry = e_dry + jnp.where(tf < direct_end, sq, 0.0)
            e_wet = e_wet + jnp.where((tf >= start) & (tf < wet_end), sq,
                                      0.0)
            y = jnp.log(jnp.maximum(edc, 1e-37)) * db
            m = (tf >= start) & (tf < end)
            s0 = s0 + jnp.where(m, y, 0.0)
            s1 = s1 + jnp.where(m, y * (tf - start), 0.0)
        return edc, e_dry, e_wet, s0, s1

    edc, e_dry, e_wet, s0, s1 = jax.lax.fori_loop(
        0, rounds, body, (zero, zero, zero, zero, zero))
    for ref, val in ((edry_ref, e_dry), (ewet_ref, e_wet), (etot_ref, edc),
                     (s0_ref, s0), (s1_ref, s1)):
        ref[b, pl.ds(c * width, width)] = val


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def moments_blocked(params: GridParams, rec, onset,
                    interpret: bool = False) -> Moments:
    """Analyzer moments of every listener's recording in one backward pass.

    ``rec`` is ``[rounds, B, steps, nxp, nyp]`` and ``onset`` ``[B, nxp,
    nyp]`` as :func:`simulate_blocked` returns them; the moments come back
    ``[B, nxp, nyp]``.
    """
    rounds, B, steps, nxp, nyp = rec.shape
    cells = nxp * nyp
    width = MOMENT_CELLS
    n_prog = -(-cells // width)
    kernel = functools.partial(
        _moments_kernel, t_real=params.response_length, rounds=rounds,
        steps=steps,
        dry_n=params.dry_gain_samples, wet_n=params.wet_gain_samples,
        schro_off=params.schroeder_offset_samples, cells=cells, width=width)
    grid = jax.ShapeDtypeStruct((B, n_prog * width), jnp.float32)
    outs = pl.pallas_call(
        kernel,
        grid=(B, n_prog),
        out_shape=[grid] * 5,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="moments_blocked",
    )(onset.reshape(B, cells), rec.reshape(rounds, B, steps, cells))
    e_dry, e_wet, e_total, s0, s1 = (
        o[:, :cells].reshape(B, nxp, nyp) for o in outs)
    return Moments(e_dry=e_dry, e_wet=e_wet, e_total=e_total, s0=s0, s1=s1)
