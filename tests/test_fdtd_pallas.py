"""Temporally blocked Pallas kernels (ops/fdtd_blocked.py), interpret mode.

The kernels are compiled for the GPU through Pallas's Triton route; here
the Pallas interpreter runs the same kernel bodies on the CPU, and the
results must equal the lax.scan solver bit for bit (same operations in the
same order) — and the jnp moments to float32 summation-order tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from planeverb.config import (BoundaryType, PlaneverbConfig,
                              compute_grid_params)
from planeverb.ops import analyzer, fdtd, fdtd_blocked, pipeline, voxelize
from planeverb.scene import AABB, demo_scene

CFG = PlaneverbConfig(grid_size_x=10.0, grid_size_y=10.0, grid_resolution=275)


def _params(T, boundary=None, grid=None):
    cfg = CFG if boundary is None else dataclasses.replace(
        CFG, grid_boundary_type=boundary)
    p = dataclasses.replace(compute_grid_params(cfg), response_length=T)
    if grid is not None:   # nx, ny = grid_x + 1, grid_y + 1
        p = dataclasses.replace(p, grid_x=grid[0] - 1, grid_y=grid[1] - 1)
    return p


def _kernel_vs_scan(p, boxes, cells):
    """Blocked kernel (interpret) for the listener ``cells`` vs one scan
    pass each; every field must match exactly."""
    beta, refl = voxelize.voxelize_np(p, boxes)
    pulse = oracle.gaussian_pulse(p)[:p.response_length]
    rec, onset, fx, fy = fdtd_blocked.simulate_blocked(
        p, jnp.asarray(beta), jnp.asarray(refl), jnp.asarray(pulse),
        jnp.asarray(np.array(cells, np.int32)), interpret=True)
    lay = fdtd_blocked.blocked_layout(p)
    o = lay.origin
    rec = np.asarray(rec)
    for b, (cx, cy) in enumerate(cells):
        ref = fdtd.simulate(p, beta, refl, jnp.asarray(pulse), cx, cy)
        pr = rec[:, b].reshape(lay.t_pad, lay.nxp, lay.nyp)
        np.testing.assert_array_equal(
            pr[:p.response_length, o:o + p.nx, o:o + p.ny],
            np.asarray(ref.pressure))
        for got, want in ((onset, ref.onset), (fx, ref.flux_x),
                          (fy, ref.flux_y)):
            np.testing.assert_array_equal(
                np.asarray(got)[b, o:o + p.nx, o:o + p.ny],
                np.asarray(want))


@pytest.mark.parametrize("T", [64, 70, 30])
def test_parity_vs_scan(T):
    """T a multiple of the launch's steps, and two that are not."""
    p = _params(T)
    _kernel_vs_scan(p, demo_scene("SmallRoom").boxes,
                    [p.world_to_cell(5.0, 5.0)])


def test_padding_silent_and_cropped():
    """The ring and the tail past the last real cell stay exactly zero,
    and the cropped result has the scan's shape."""
    p = _params(64)
    beta, refl = voxelize.voxelize_np(p, [])
    pulse = jnp.asarray(oracle.gaussian_pulse(p)[:64])
    lc = jnp.asarray([list(p.world_to_cell(5.0, 5.0))], jnp.int32)
    rec, onset, _, _ = fdtd_blocked.simulate_blocked(
        p, jnp.asarray(beta), jnp.asarray(refl), pulse, lc, interpret=True)
    lay = fdtd_blocked.blocked_layout(p)
    o = lay.origin
    pr = np.asarray(rec)[:, 0].reshape(lay.t_pad, lay.nxp, lay.nyp)
    assert (lay.nxp, lay.nyp) != (p.nx, p.ny)   # padding exercised
    assert np.abs(pr[:, :o]).max() == 0.0
    assert np.abs(pr[:, o + p.nx:]).max() == 0.0
    assert np.abs(pr[:, :, :o]).max() == 0.0
    assert np.abs(pr[:, :, o + p.ny:]).max() == 0.0
    assert np.isinf(np.asarray(onset)[0, :o]).all()
    res = pipeline.simulate_kernel(p, jnp.asarray(beta), jnp.asarray(refl),
                                   pulse, lc, interpret=True)
    assert res.pressure.shape == (1, 64, p.nx, p.ny)
    assert res.onset.shape == (1, p.nx, p.ny)


def test_reflecting_boundary():
    p = _params(48, boundary=BoundaryType.REFLECTING)
    _kernel_vs_scan(p, demo_scene("SmallRoom").boxes,
                    [p.world_to_cell(5.0, 5.0)])


def test_moments_parity_vs_jnp():
    """Backward moments kernel vs analyzer.moments_from_pressure, on the
    kernel's own recording and on the scan's ([T, 1, 1, nx, ny] layout);
    the assembled parameters must match the full analyze()."""
    p = _params(70)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = jnp.asarray(oracle.gaussian_pulse(p)[:70])
    lix, liy = p.world_to_cell(5.0, 5.0)
    ref = fdtd.simulate(p, beta, refl, pulse, lix, liy)
    mref = analyzer.moments_from_pressure(p, ref.pressure, ref.onset)

    rec, onset, fx, fy = fdtd_blocked.simulate_blocked(
        p, jnp.asarray(beta), jnp.asarray(refl), pulse,
        jnp.asarray([[lix, liy]], jnp.int32), interpret=True)
    lay = fdtd_blocked.blocked_layout(p)
    o = lay.origin
    m = fdtd_blocked.moments_blocked(p, rec, onset, interpret=True)
    m_scan = fdtd_blocked.moments_blocked(
        p, ref.pressure.reshape(70, 1, 1, p.nx, p.ny), ref.onset[None],
        interpret=True)
    for name in ("e_dry", "e_wet", "e_total", "s0", "s1"):
        b = np.asarray(getattr(mref, name))
        scale = np.abs(b).max() + 1e-30
        for a in (np.asarray(getattr(m, name))[0, o:o + p.nx, o:o + p.ny],
                  np.asarray(getattr(m_scan, name))[0]):
            assert np.abs(a - b).max() / scale < 1e-5, name

    crop = jax.tree.map(lambda a: a[0, o:o + p.nx, o:o + p.ny], m)
    out_full = analyzer.analyze(p, ref.pressure, ref.onset, ref.flux_x,
                                ref.flux_y, np.float32(0.01),
                                np.float32(5.0), np.float32(5.0))
    out_m = analyzer.analyze_moments(
        p, crop, onset[0, o:o + p.nx, o:o + p.ny],
        fx[0, o:o + p.nx, o:o + p.ny], fy[0, o:o + p.nx, o:o + p.ny],
        np.float32(0.01), np.float32(5.0), np.float32(5.0))
    np.testing.assert_allclose(np.asarray(out_m.rt60),
                               np.asarray(out_full.rt60), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out_m.occlusion),
                               np.asarray(out_full.occlusion), rtol=1e-4)


def test_simulate_auto_dispatches_scan_on_cpu():
    """The routing function picks the scan on the CPU, and simulate_auto
    takes that path (the scan's exact [T, nx, ny] result)."""
    assert jax.devices()[0].platform == "cpu"
    assert pipeline.solver_path() == "scan"
    p = _params(16)
    beta, refl = voxelize.voxelize_np(p, [])
    pulse = oracle.gaussian_pulse(p)[:16]
    res = pipeline.simulate_auto(p, jnp.asarray(beta), jnp.asarray(refl),
                                 jnp.asarray(pulse), 5, 5)
    ref = fdtd.simulate(p, beta, refl, jnp.asarray(pulse), 5, 5)
    assert res.pressure.shape == (16, p.nx, p.ny)
    np.testing.assert_array_equal(np.asarray(res.pressure),
                                  np.asarray(ref.pressure))


def test_batched_kernel_parity():
    """B listeners in one launch sequence: onset/flux/moments of every
    listener must be BIT-identical to its own single-listener launch."""
    p = _params(70)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = jnp.asarray(oracle.gaussian_pulse(p)[:70])
    listeners = [(5.0, 5.0), (3.0, 7.0), (8.0, 2.0)]
    cells = np.array([p.world_to_cell(*lst) for lst in listeners], np.int32)
    args = (p, jnp.asarray(beta), jnp.asarray(refl), pulse)

    rec, onset, fx, fy = fdtd_blocked.simulate_blocked(
        *args, jnp.asarray(cells), interpret=True)
    m = fdtd_blocked.moments_blocked(p, rec, onset, interpret=True)
    for i in range(len(listeners)):
        rec1, on1, fx1, fy1 = fdtd_blocked.simulate_blocked(
            *args, jnp.asarray(cells[i:i + 1]), interpret=True)
        m1 = fdtd_blocked.moments_blocked(p, rec1, on1, interpret=True)
        np.testing.assert_array_equal(np.asarray(rec)[:, i],
                                      np.asarray(rec1)[:, 0])
        for got, want in ((onset, on1), (fx, fx1), (fy, fy1)):
            np.testing.assert_array_equal(np.asarray(got)[i],
                                          np.asarray(want)[0])
        for name in ("e_dry", "e_wet", "e_total", "s0", "s1"):
            np.testing.assert_array_equal(
                np.asarray(getattr(m, name))[i],
                np.asarray(getattr(m1, name))[0], err_msg=name)


def test_pipeline_auto_batch_matches_sequential():
    """pipeline_kernel (blocked kernels + vmapped assembly) must match
    per-listener scan + analyze() results — the parity the engine's
    split-screen mode rides on a GPU (core/context.py::_pipeline_packed_multi)."""
    p = _params(70)
    beta, refl = voxelize.voxelize_np(p, demo_scene("SmallRoom").boxes)
    pulse = jnp.asarray(oracle.gaussian_pulse(p)[:70])
    listeners = [(5.0, 5.0), (3.0, 7.0)]
    lcells = jnp.asarray(np.array([p.world_to_cell(*lst)
                                   for lst in listeners], np.int32))
    lpos = jnp.asarray(np.array(listeners, np.float32))

    _, out_b = pipeline.pipeline_kernel(
        p, jnp.asarray(beta), jnp.asarray(refl), pulse, lcells,
        jnp.float32(0.0288), lpos, interpret=True)
    for i, (lx, lz) in enumerate(listeners):
        cix, ciy = p.world_to_cell(lx, lz)
        ref = fdtd.simulate(p, beta, refl, pulse, cix, ciy)
        out_s = analyzer.analyze(p, ref.pressure, ref.onset, ref.flux_x,
                                 ref.flux_y, np.float32(0.0288),
                                 np.float32(lx), np.float32(lz))
        for name in ("occlusion", "wet_gain", "rt60", "lowpass",
                     "direction", "source_directivity", "delay_samples"):
            a = np.asarray(getattr(out_b, name)[i])
            b = np.asarray(getattr(out_s, name))
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_random_scene_fuzz_parity():
    """Seeded fuzz: arbitrary geometry (overlapping boxes, boxes clipped by
    the grid edge, mixed materials, off-center listeners) must keep the
    blocked kernel bit-identical to the lax.scan solver — the demo scenes
    only cover curated layouts."""
    rng = np.random.default_rng(7)
    p = _params(48)
    for _ in range(3):
        boxes = [AABB(x=float(rng.uniform(-1, 11)),
                      y=float(rng.uniform(-1, 11)),
                      width=float(rng.uniform(0.3, 6.0)),
                      height=float(rng.uniform(0.3, 6.0)),
                      absorption=float(rng.uniform(0.3, 0.999)))
                 for _ in range(int(rng.integers(1, 7)))]
        lx, lz = (float(rng.uniform(0.5, 9.5)) for _ in range(2))
        _kernel_vs_scan(p, boxes, [p.world_to_cell(lx, lz)])


_TILE = fdtd_blocked.TILE

# (grid nx x ny, T, listener cells): odd grids that are no multiple of the
# tile, a T that is no multiple of the launch's steps, listeners in a
# neighbour tile's ghost ring and at the grid corner, and batches
_KERNEL_CASES = {
    "grid71x71": ((71, 71), 24, [(35, 35)]),
    "grid96x71": ((96, 71), 24, [(40, 30)]),
    "grid130x67": ((130, 67), 16, [(64, 33)]),
    "T_not_multiple_of_steps": ((40, 40), 21, [(20, 20)]),
    "listener_in_ghost_ring": ((48, 48), 24, [(_TILE + 1, _TILE - 2)]),
    "listener_at_corner": ((40, 40), 24, [(0, 0)]),
    "batch_1": ((40, 40), 24, [(12, 30)]),
    "batch_3": ((40, 40), 24, [(12, 30), (_TILE, _TILE), (39, 0)]),
}


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_kernel_matches_scan(case):
    grid, T, cells = _KERNEL_CASES[case]
    p = _params(T, grid=grid)
    boxes = [AABB(x=2.0, y=3.0, width=1.5, height=4.0, absorption=0.6),
             AABB(x=6.0, y=1.0, width=3.0, height=0.8, absorption=0.95)]
    _kernel_vs_scan(p, boxes, cells)
