"""The full pass — simulation + analysis — and the one place that picks its path.

:func:`solver_path` decides, from the device and the mesh, which solver a
pass runs on:

  - ``"sharded"``: a device mesh was given — the plain ``shard_map`` +
    ``ppermute`` solver (parallel/solver.py::pipeline_sharded);
  - ``"kernel"``: a GPU — the temporally blocked Hopper kernels
    (ops/fdtd_blocked.py);
  - ``"scan"``: anything else — the ``lax.scan`` reference solver
    (ops/fdtd.py) and the jnp moments (ops/analyzer.py).

Every entry point below asks it, and so does ``Context`` (core/context.py)
when it binds its step to the one-device or the sharded pipelines; none
passes the interpreter flag, catches a kernel failure, or falls back to
another device. All paths return
results on the unpadded grid: pressure ``[T, nx, ny]``, analyzer grids
``[gx, gy]``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from planeverb.config import GridParams
from planeverb.ops import analyzer, fdtd, fdtd_blocked
from planeverb.ops.fdtd import FdtdResult

__all__ = ["solver_path", "simulate_auto", "simulate_kernel",
           "pipeline_auto", "pipeline_auto_batch", "pipeline_kernel",
           "pipeline_plain"]


def solver_path(mesh=None) -> str:
    """``"sharded"`` with a mesh, else ``"kernel"`` when computations go to
    a GPU (the device ``jax.default_device`` names, else
    ``jax.devices()[0]``), else ``"scan"``."""
    if mesh is not None:
        return "sharded"
    dev = jax.config.jax_default_device or jax.devices()[0]
    platform = dev if isinstance(dev, str) else dev.platform
    return "kernel" if platform == "gpu" else "scan"


def _crop(params: GridParams, lay, a):
    o = lay.origin
    return a[..., o:o + params.nx, o:o + params.ny]


def _kernel_pass(params: GridParams, beta, refl, pulse, lcells, interpret):
    """Blocked sim for B listeners: (layout, padded recording slabs,
    FdtdResult cropped to the grid with a leading [B] axis)."""
    lay = fdtd_blocked.blocked_layout(params)
    rec, onset, fx, fy = fdtd_blocked.simulate_blocked(
        params, beta, refl, pulse, lcells, interpret=interpret)
    B = rec.shape[1]
    pressure = jnp.moveaxis(rec, 1, 0).reshape(B, lay.t_pad, lay.nxp,
                                               lay.nyp)
    res = FdtdResult(
        pressure=_crop(params, lay, pressure[:, :params.response_length]),
        onset=_crop(params, lay, onset), flux_x=_crop(params, lay, fx),
        flux_y=_crop(params, lay, fy))
    return lay, rec, onset, res


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def simulate_kernel(params: GridParams, beta, refl, pulse, lcells,
                    interpret: bool = False) -> FdtdResult:
    """B passes on the blocked kernel (``lcells`` [B, 2]), cropped to the
    grid: every field gets a leading [B] axis, pressure is [B, T, nx, ny]."""
    return _kernel_pass(params, beta, refl, pulse, lcells, interpret)[3]


def simulate_auto(params: GridParams, beta, refl, pulse,
                  listener_ix, listener_iy) -> FdtdResult:
    """One simulation pass on the path :func:`solver_path` picks."""
    if solver_path() == "kernel":
        res = simulate_kernel(params, beta, refl, pulse,
                              jnp.array([[listener_ix, listener_iy]],
                                        jnp.int32))
        return jax.tree.map(lambda a: a[0], res)
    return fdtd.simulate(params, beta, refl, pulse, listener_ix, listener_iy)


def _assemble(params, moments, res, efree, lpos, compute_directions):
    def one(mom, onset, fx, fy, lx, lz):
        return analyzer.analyze_moments(
            params, mom, onset, fx, fy, efree, lx, lz,
            compute_directions=compute_directions)

    return jax.vmap(one)(moments, res.onset, res.flux_x, res.flux_y,
                         lpos[:, 0], lpos[:, 1])


@functools.partial(jax.jit, static_argnames=("params", "compute_directions",
                                             "interpret"))
def pipeline_kernel(params: GridParams, beta, refl, pulse, lcells, efree,
                    lpos, compute_directions: bool = True,
                    interpret: bool = False):
    """B full passes on the blocked kernels: one sim launch sequence and one
    backward moments launch for all listeners, then the per-cell assembly
    (vmapped jnp). ``lcells`` [B, 2] int32 cells, ``lpos`` [B, 2] world
    positions. Returns (FdtdResult, AnalyzerResults), each with a leading
    [B] axis."""
    lay, rec, onset, res = _kernel_pass(params, beta, refl, pulse, lcells,
                                        interpret)
    moments = fdtd_blocked.moments_blocked(params, rec, onset,
                                           interpret=interpret)
    moments = jax.tree.map(lambda a: _crop(params, lay, a), moments)
    return res, _assemble(params, moments, res, efree, lpos,
                          compute_directions)


@functools.partial(jax.jit, static_argnames=("params", "compute_directions"))
def pipeline_plain(params: GridParams, beta, refl, pulse, lcells, efree,
                   lpos, compute_directions: bool = True):
    """B full passes on the ``lax.scan`` solver and jnp moments, vmapped
    over the listener axis. Same contract as :func:`pipeline_kernel`."""
    def sim(ix, iy):
        return fdtd.simulate(params, beta, refl, pulse, ix, iy)

    res = jax.vmap(sim)(lcells[:, 0], lcells[:, 1])
    moments = jax.vmap(lambda pr, on: analyzer.moments_from_pressure(
        params, pr, on))(res.pressure, res.onset)
    return res, _assemble(params, moments, res, efree, lpos,
                          compute_directions)


def pipeline_auto_batch(params: GridParams, beta, refl, pulse, lcells,
                        efree, lpos, compute_directions: bool = True):
    """B full passes (split-screen) on the path :func:`solver_path` picks.
    Returns (FdtdResult, AnalyzerResults) with a leading [B] axis."""
    fn = pipeline_kernel if solver_path() == "kernel" else pipeline_plain
    return fn(params, beta, refl, pulse, lcells, efree, lpos,
              compute_directions=compute_directions)


@functools.partial(jax.jit, static_argnames=("params", "compute_directions"))
def pipeline_auto(params: GridParams, beta, refl, pulse,
                  listener_ix, listener_iy, efree, listener_x, listener_z,
                  compute_directions: bool = True):
    """One full pass — sim + analysis — compiled as one program on the path
    :func:`solver_path` picks. Returns (FdtdResult, AnalyzerResults)."""
    lcells = jnp.stack([jnp.asarray(listener_ix, jnp.int32),
                        jnp.asarray(listener_iy, jnp.int32)])[None]
    lpos = jnp.stack([jnp.asarray(listener_x, jnp.float32),
                      jnp.asarray(listener_z, jnp.float32)])[None]
    res, out = pipeline_auto_batch(params, beta, refl, pulse, lcells, efree,
                                   lpos, compute_directions=compute_directions)
    return jax.tree.map(lambda a: a[0], (res, out))
