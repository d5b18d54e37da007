"""Direction-of-arrival via parallel delay-field descent.

The reference encodes listener direction with a per-cell greedy walk across
the onset-delay field (/root/reference ProjectPlaneverb/src/DSP/Analyzer.cpp:
340-431): from each source cell, repeatedly hop to the 8-neighbor with the
smallest onset delay until reaching line-of-sight with the listener (or a
loudness/delay threshold), then emit the unit vector from the final cell to
the listener. That walk is data-dependent and sequential per cell — the one
algorithm in the pipeline that does not vectorize directly.

Data-parallel reformulation: the hop choice from a cell depends only on that
cell (argmin over its neighbors), so the walk is iteration of a *fixed*
per-cell successor function ``g``:

    g(c) = c               if terminal(c)
         = best_neighbor(c) otherwise

with terminal(c) = line-of-sight(c) ∨ delay(c) <= close-threshold ∨
loudness(c) >= -1 dB ∨ no strictly-delay-improving neighbor. The walk's
fixpoint from every cell simultaneously is computed by **gather-free label
propagation**: since g(c) is always one of c's 8 NEIGHBORS (or c itself),
"pull the label from g(c)" decomposes into 8 cheap lane/sublane shifts +
masked selects — no gather at all. Each iteration advances every cell one
hop; iteration stops at the fixpoint (paths are short: delay strictly
decreases per hop, and e.g. HugeRoom@750 Hz converges in 88 hops).

A shift-select hop is a few elementwise passes over the grid, where the
earlier pointer-jumping design (map squaring ``g = g[g]``, O(log path)
iterations) paid a full [n]-element gather per iteration. The walk's
terminal cell index is decoded arithmetically (div/mod), so the whole pass
is elementwise + shifts — it also vmaps cleanly over the multi-listener
batch axis. The start cell is special (the reference enters the loop with
delay = +inf and skips the line-of-sight check until after the first hop),
handled by a separate shift-select step after convergence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from planeverb.config import GridParams

__all__ = ["encode_directions", "walk_direction"]

# neighbor order matters for tie-breaking: strict < keeps the earliest
# minimal neighbor, matching the reference's iteration order
_NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1),
                     (0, -1), (0, 1),
                     (1, -1), (1, 0), (1, 1))


@functools.partial(jax.jit, static_argnames=("params",))
def encode_directions(params: GridParams, occlusion, delay,
                      listener_wx, listener_wy) -> jax.Array:
    """Compute [gx, gy, 2] DOA unit vectors (EncodeListenerDirection analog).

    Args:
      occlusion: [gx, gy] obstruction gains (pass-1 output).
      delay: [gx, gy] onset delays in samples (f32; FLT_MAX where none).
      listener_wx, listener_wy: listener world position incl. grid offset.
    """
    gx, gy = params.grid_x, params.grid_y
    n = gx * gy
    k = params.constants
    dx = jnp.float32(params.dx)
    fs = jnp.float32(params.fs)
    c_sound = jnp.float32(k.c)
    wavelength = c_sound / jnp.float32(params.resolution)
    thr_dist = jnp.float32(0.3) * wavelength
    f32max = jnp.float32(jnp.finfo(jnp.float32).max)

    occ = occlusion.reshape(n)
    dly = delay.reshape(n)

    rr = jax.lax.broadcasted_iota(jnp.int32, (gx, gy), 0)
    cc = jax.lax.broadcasted_iota(jnp.int32, (gx, gy), 1)

    def _shift(arr, dr, dc, fill):
        """arr value at (i+dr, j+dc), out-of-bounds filled — a padded slice,
        not a gather (gathers are the slow op on accelerators)."""
        pr = ((max(-dr, 0), max(dr, 0)), (max(-dc, 0), max(dc, 0)))
        padded = jnp.pad(arr, pr, constant_values=fill)
        r0 = max(dr, 0)
        c0 = max(dc, 0)
        return padded[r0:r0 + gx, c0:c0 + gy]

    # best (strictly smallest-delay, occlusion>0) neighbor per cell
    best_delay = jnp.full((gx, gy), f32max)
    best_idx = (rr * gy + cc)  # self as placeholder
    for dr, dc in _NEIGHBOR_OFFSETS:
        n_delay = _shift(delay, dr, dc, f32max)
        n_occ = _shift(occlusion, dr, dc, 0.0)
        cand_ok = (n_occ > 0.0) & (n_delay < best_delay)
        best_delay = jnp.where(cand_ok, n_delay, best_delay)
        best_idx = jnp.where(
            cand_ok, (rr + dr) * gy + (cc + dc), best_idx)

    nxt = best_idx.reshape(n)
    nxt_delay = best_delay.reshape(n)
    has_next = nxt_delay < f32max

    # per-cell geometry for the line-of-sight test
    ex = rr.astype(jnp.float32).reshape(n) * dx
    ey = cc.astype(jnp.float32).reshape(n) * dx
    dxv = ex - listener_wx
    dyv = ey - listener_wy
    euclid = jnp.sqrt(dxv * dxv + dyv * dyv)
    geodesic = c_sound * dly / fs
    los = jnp.abs(geodesic - euclid) < thr_dist

    # stop-at-this-cell predicate (arrival LOS + loop-top checks, which the
    # reference evaluates BEFORE the neighbor scan — Analyzer.cpp:354,406)
    stop_here = (los
                 | (dly <= jnp.float32(k.delay_close_threshold))
                 | (occ >= jnp.float32(k.distance_gain_threshold))
                 | (~has_next))
    # the reference commits nextIndex inside the scan, so a non-improving
    # best neighbor means one final hop TO that neighbor, then stop
    # (Analyzer.cpp:375-385) — folded into the walk-end label below:
    # end(c) = nxt[c] for such cells, c otherwise
    hop_stop = (~stop_here) & has_next & (nxt_delay >= dly)
    advance = (~stop_here) & (nxt_delay < dly)

    # hop selector: which of the 8 neighbors the advancing hop takes
    # (8 = hold). g(c) is always a NEIGHBOR of c, so "pull the label from
    # g(c)" is 8 shifted selects — no gather (see module docstring).
    nxt2 = nxt.reshape(gx, gy)

    def _selector(active2):
        """Neighbor index (0-7) of nxt where ``active2``, else 8 (hold)."""
        sel = jnp.full((gx, gy), 8, jnp.int32)
        for idx, (dr, dc) in enumerate(_NEIGHBOR_OFFSETS):
            n_idx = (rr + dr) * gy + (cc + dc)
            sel = jnp.where(active2 & (nxt2 == n_idx), idx, sel)
        return sel

    def _pull(lab, sel):
        """lab at each cell's hop target per ``sel``: 8 shifts + selects."""
        out = lab
        for idx, (dr, dc) in enumerate(_NEIGHBOR_OFFSETS):
            out = jnp.where(sel == idx, _shift(lab, dr, dc, 0), out)
        return out

    sel = _selector(advance.reshape(gx, gy))

    # walk-end label: where the walk rests once it stops at this cell
    label0 = jnp.where(hop_stop, nxt, jnp.arange(n)).reshape(gx, gy)

    # propagate labels down the delay gradient to the fixpoint. Delay
    # strictly decreases >= 1 sample per hop (integer-valued onsets), so
    # path length <= response_length; typical scenes converge in tens of
    # hops (HugeRoom@750: 88). 4 hops per check amortizes the early-exit
    # reduce; overshoot past the fixpoint is idempotent.
    path_bound = min(max(n, 2), params.response_length + 2)
    iters = -(-path_bound // 4)

    def cond(state):
        i, _, changed = state
        return (i < iters) & changed

    def body(state):
        i, lab, _ = state
        nl = _pull(_pull(_pull(_pull(lab, sel), sel), sel), sel)
        return i + 1, nl, jnp.any(nl != lab)

    _, lab, _ = jax.lax.while_loop(cond, body, (0, label0, jnp.bool_(True)))

    # first step from the start cell: delay register is +inf, LOS unchecked
    # — resolve each start through its first-hop neighbor's converged label
    start_terminal = (occ >= jnp.float32(k.distance_gain_threshold)) | (~has_next)
    final = _pull(lab, _selector((~start_terminal).reshape(gx, gy)))
    final = final.reshape(n)

    # unit vector from final cell to listener (Analyzer.cpp:409-430);
    # the final cell's coordinates decode arithmetically from its index
    fex = (final // gy).astype(jnp.float32) * dx
    fey = (final % gy).astype(jnp.float32) * dx
    ox = fex - listener_wx
    oy = fey - listener_wy
    length_sq = ox * ox + oy * oy
    inv_len = jnp.where(length_sq != 0.0, 1.0 / jnp.sqrt(length_sq), 1.0)
    out = jnp.stack([ox * inv_len, oy * inv_len], axis=-1)
    return out.reshape(gx, gy, 2)


def walk_direction(params: GridParams, occlusion, delay, sx: int, sy: int,
                   listener_wx: float, listener_wy: float):
    """Single-cell DOA by the greedy walk, on the host (numpy).

    Semantics identical to :func:`encode_directions` (same neighbor order,
    tie-breaking, and terminal predicate), evaluated lazily for one source
    cell. The full-grid device pass is cheap since the gather-free rewrite
    (~0.2 ms on the 192x192 headline grid), but its shift cost scales with
    grid area x path length, while a game queries only a handful of emitter
    cells — so Context still switches to per-query host walks on very large
    grids (microseconds each on the small [gx, gy] parameter grids).

    Args:
      occlusion, delay: [gx, gy] numpy arrays (pass-1 outputs).
      sx, sy: source cell indices.
      listener_wx, listener_wy: listener world position incl. grid offset.
    Returns (dir_x, dir_y).
    """
    import numpy as np

    gx, gy = params.grid_x, params.grid_y
    k = params.constants
    dx = np.float32(params.dx)
    fs = np.float32(params.fs)
    c_sound = np.float32(k.c)
    wavelength = c_sound / np.float32(params.resolution)
    thr_dist = np.float32(0.3) * wavelength
    f32max = np.float32(np.finfo(np.float32).max)

    def best_neighbor(i, j):
        best_d = f32max
        best = (i, j)
        for dr, dc in _NEIGHBOR_OFFSETS:
            ni, nj = i + dr, j + dc
            if not (0 <= ni < gx and 0 <= nj < gy):
                continue
            if occlusion[ni, nj] > 0.0 and delay[ni, nj] < best_d:
                best_d = delay[ni, nj]
                best = (ni, nj)
        return best, best_d

    def los(i, j):
        ex = np.float32(i) * dx
        ey = np.float32(j) * dx
        euclid = np.sqrt((ex - listener_wx) ** 2 + (ey - listener_wy) ** 2)
        geodesic = c_sound * delay[i, j] / fs
        return abs(geodesic - euclid) < thr_dist

    def terminal(i, j, nxt_d):
        return (los(i, j)
                or delay[i, j] <= np.float32(k.delay_close_threshold)
                or occlusion[i, j] >= np.float32(k.distance_gain_threshold)
                or nxt_d >= delay[i, j])

    # first step from the start cell: delay register is +inf, LOS unchecked
    cur = (sx, sy)
    nxt, nxt_d = best_neighbor(*cur)
    if not (occlusion[sx, sy] >= np.float32(k.distance_gain_threshold)
            or nxt_d == f32max):
        cur = nxt
        for _ in range(params.response_length + 2):
            nxt, nxt_d = best_neighbor(*cur)
            if nxt_d == f32max or terminal(*cur, nxt_d):
                # literal reference semantics: the C++ commits nextIndex to
                # the best neighbor inside the scan, so the non-improving
                # break (nxt_d >= delay[cur], no LOS/close/loud stop first)
                # still leaves the walk at that neighbor (Analyzer.cpp:
                # 375-385)
                if (nxt_d != f32max and nxt_d >= delay[cur]
                        and not los(*cur)
                        and delay[cur] > np.float32(k.delay_close_threshold)
                        and occlusion[cur] < np.float32(
                            k.distance_gain_threshold)):
                    cur = nxt
                break
            cur = nxt

    ex = np.float32(cur[0]) * dx
    ey = np.float32(cur[1]) * dx
    ox = np.float32(ex - listener_wx)
    oy = np.float32(ey - listener_wy)
    length_sq = ox * ox + oy * oy
    if length_sq != 0.0:
        inv = np.float32(1.0) / np.sqrt(length_sq, dtype=np.float32)
        ox, oy = ox * inv, oy * inv
    return float(ox), float(oy)
