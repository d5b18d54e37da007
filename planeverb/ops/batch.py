"""Batched simulation: many listeners / scenes in one device call.

The reference is strictly one listener, one scene, one background thread
(PvContext.cpp:63-94). Acoustic reciprocity already makes *sources* free
(one sim yields every source cell's IR — FDTD.cpp:233-234); this module adds
the remaining data-parallel axes an accelerator makes cheap:

  - **listeners**: split-screen / multiplayer — one sim per listener,
    vmapped so XLA batches the stencil across the leading axis.
  - **scenes**: level precomputation / dataset generation — batched
    (beta, reflection) field sets.

Memory scales as B x [T, nx, ny] f32 for the recordings; size batches
accordingly (e.g. 25m@275Hz ~= 9 MB per listener).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from planeverb.config import GridParams
from planeverb.ops import analyzer, fdtd

__all__ = ["simulate_listeners", "simulate_listeners_auto",
           "analyze_listeners", "simulate_scenes", "simulate_slices"]


@functools.partial(jax.jit, static_argnames=("params",))
def simulate_listeners(params: GridParams, beta, refl, pulse,
                       listener_ix, listener_iy) -> fdtd.FdtdResult:
    """One sim per listener cell, batched.

    Args:
      beta, refl: [nx, ny] shared fields.
      listener_ix, listener_iy: [B] int32 listener cells.
    Returns FdtdResult with a leading [B] axis on every field.
    """
    sim = lambda ix, iy: fdtd.simulate(params, beta, refl, pulse, ix, iy)
    return jax.vmap(sim)(listener_ix, listener_iy)


def simulate_listeners_auto(params: GridParams, beta, refl, pulse,
                            listener_ix, listener_iy) -> fdtd.FdtdResult:
    """Batched listeners on the path ops/pipeline.py::solver_path picks:
    one launch sequence of the blocked kernel for all B listeners on a GPU,
    vmap-of-scan elsewhere. Same contract as :func:`simulate_listeners`."""
    from planeverb.ops.pipeline import simulate_kernel, solver_path

    if solver_path() == "kernel":
        return simulate_kernel(params, beta, refl, pulse,
                               jnp.stack([listener_ix, listener_iy], axis=1))
    return simulate_listeners(params, beta, refl, pulse,
                              listener_ix, listener_iy)


@functools.partial(jax.jit, static_argnames=("params",))
def analyze_listeners(params: GridParams, batched_result: fdtd.FdtdResult,
                      efree, listener_x, listener_y) -> analyzer.AnalyzerResults:
    """Batched analysis of :func:`simulate_listeners` output.

    listener_x, listener_y: [B] world positions (offset not yet applied).
    Returns AnalyzerResults with a leading [B] axis.
    """
    def one(pr, onset, fx, fy, lx, ly):
        return analyzer.analyze(params, pr, onset, fx, fy, efree, lx, ly)

    return jax.vmap(one)(batched_result.pressure, batched_result.onset,
                         batched_result.flux_x, batched_result.flux_y,
                         listener_x, listener_y)


@functools.partial(jax.jit, static_argnames=("params",))
def simulate_scenes(params: GridParams, beta, refl, pulse,
                    listener_ix, listener_iy) -> fdtd.FdtdResult:
    """One sim per scene, batched: beta/refl have a leading [S] axis and a
    single shared listener cell (broadcast scalars)."""
    sim = lambda b, r: fdtd.simulate(params, b, r, pulse,
                                     listener_ix, listener_iy)
    return jax.vmap(sim)(beta, refl)


def simulate_slices(params: GridParams, boxes3d, heights, pulse,
                    listener_ix, listener_iy,
                    head_slice: float = 0.5) -> fdtd.FdtdResult:
    """2.5D slice stack: one 2D sim per horizontal slice of a 3D scene.

    The reference simulates a single slice at the listener's head height
    (head-slice culling, PlaneverbObject.cs:194-200); here a whole stack
    of slices is one batched call — e.g. per-floor acoustics of a building,
    or height-interpolated parameters for flying sources (the "3D-slice
    stacks" scaling axis of BASELINE.json's north star).

    Args:
      boxes3d: iterable of scene.AABB3D.
      heights: [H] listener ear heights (one slice each).
    Returns FdtdResult with a leading [H] axis.
    """
    import numpy as np

    from planeverb.ops import voxelize
    from planeverb.scene import project_to_slice

    betas, refls = [], []
    for h in heights:
        scene = project_to_slice(boxes3d, float(h), head_slice)
        b, r = voxelize.voxelize_np(params, scene.boxes)
        betas.append(b)
        refls.append(r)
    return simulate_scenes(params, jnp.asarray(np.stack(betas)),
                           jnp.asarray(np.stack(refls)), pulse,
                           listener_ix, listener_iy)
